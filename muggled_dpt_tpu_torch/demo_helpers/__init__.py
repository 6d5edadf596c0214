"""Helpers of the apps, the analysis experiments and the examples: capture,
depth post-processing, plane fitting, saving, the device and dtype policy
with run_video's dispatch-ahead gate (``misc``), the cv2 widgets (``ui``),
crop, history, path prompts, video input, mesh export and the 3D viewer's
static files (``viewer3d/``). The port's own copies of the JAX package's
``demo_helpers`` modules, which import jax through that package."""
