"""Examples, run as ``python -m muggled_dpt_tpu_torch.simple_examples.<name>``."""
