"""The PyTorch port must run where jax is not installed: importing every
module of ``muggled_dpt_tpu_torch`` (the attention sweep's
``tools/flash_tune.py`` and ``tools/attn_variants.py``, the apps, run_batch,
``parallel``, ``utils``, the fine-tune and int8 tools, the kernels'
operators and the export modules included), and
``chip_smoke.py``, with jax blocked must succeed, and must
not import jax, the JAX package, ``experiments`` or the root ``tools``.
The kernel layer, ``ops/kernels/``, imports nothing of the package above it."""

import ast
import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import muggled_dpt_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "muggled_dpt_tpu", "experiments", "tools") and sys.modules[m] is not None)
assert not leaked, leaked
assert len(names) >= 40, names
ported = ("checkpoints.beit", "models.beit", "models.beit_family", "make_beit_dpt", "ops.kernels.flash_attention",
          "checkpoints.swinv2", "models.swinv2", "models.swinv2_family", "make_swinv2_dpt", "ops.kernels.window_attention",
          "make_depthanythingv1_dpt", "ops.kernels.fused_mlp", "ops.kernels.head_tail", "ops.quant",
          "ops.kernels.flash_attention_int8", "ops.collectives", "ops.kernels.flash_attention_xl", "ops.kernels.flash_attention_staged",
          "ops.kernels.flash_variants", "tools.attn_variants", "tools.flash_tune", "tools.flash_sm90_variants",
          "tools.sweep_sm90_variants", "tools.shootout_head_variants", "tools.variant_build", "tools.mlp_sm90_variants",
          "demo_helpers.model_capture", "demo_helpers.postprocess", "demo_helpers.saving", "demo_helpers.plane_fit",
          "experiments.fusion_scaling", "experiments.depth_masking", "experiments.attention_visualization",
          "experiments.block_norm_visualization", "simple_examples.internal_features", "checkpoints.cache",
          "demo_helpers.ui", "demo_helpers.misc", "demo_helpers.loading", "demo_helpers.video", "demo_helpers.crop_ui",
          "demo_helpers.history_keeper", "demo_helpers.mesh_export", "simple_examples.depth_prediction", "run_image",
          "run_video", "run_3dviewer", "run_batch", "parallel.mesh", "parallel.inference", "parallel.train", "parallel.tensor",
          "parallel.checkpoint", "utils.metrics", "utils.observability", "tools.finetune_demo",
          "tools.int8_trained_weights", "ops.kernels.library", "onnx_export", "onnx_export.proto",
          "onnx_export.builder", "onnx_export.evaluate", "onnx_export.emit_dpt", "experiments.export_model",
          "experiments.export_onnx")
missing = [m for m in ported if pkg.__name__ + "." + m not in names]
assert not missing, missing
print("OK", len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True, cwd=REPO_ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def _package_imports(path: str, package: str) -> list[str]:
    """Every module of the package that the source at ``path`` (a module of
    ``package``) imports, at any depth of its code, relative imports resolved."""
    found = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            found += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")[: len(package.split(".")) - node.level + 1] if node.level else []
            found.append(".".join(base + ([node.module] if node.module else [])))
    return [name for name in found if name.split(".")[0] == "muggled_dpt_tpu_torch"]


def test_kernel_layer_imports_nothing_above_it():
    """No module under ``ops/kernels/`` imports from the tools, the models,
    the facade, the apps or any other part of the package outside the layer."""
    layer = "muggled_dpt_tpu_torch.ops.kernels"
    root = os.path.join(REPO_ROOT, *layer.split("."))
    sources = sorted(f for f in os.listdir(root) if f.endswith(".py"))
    assert "flash_attention.py" in sources and "_build.py" in sources
    above = {f: [m for m in _package_imports(os.path.join(root, f), layer) if not (m + ".").startswith(layer + ".")]
             for f in sources}
    assert {f: names for f, names in above.items() if names} == {}
