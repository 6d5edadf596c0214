"""Helpers of the analysis experiments and examples: capture, depth
post-processing, plane fitting and saving. The port's own copies of the JAX
package's ``demo_helpers`` modules, which import jax through that package."""
