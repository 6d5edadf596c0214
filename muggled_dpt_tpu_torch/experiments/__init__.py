"""The analysis experiments, run as ``python -m muggled_dpt_tpu_torch.experiments.<name>``:
attention_visualization, block_norm_visualization (both ``--headless``),
fusion_scaling and depth_masking. Each runs on the CUDA card unless given
``-d cpu``, and has its body in ``main(argv=None)``."""
