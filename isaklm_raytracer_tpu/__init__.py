"""Differentiable path tracer in JAX.

A JAX/XLA/Pallas framework with the capabilities of the CUDA path tracer
``INDA23PlusPlus/isaklm-raytracer``: unbiased Monte-Carlo path tracing with
dielectric / metallic / transparent microfacet materials, OBJ + custom
``.mat`` loading, K-D tree acceleration, Next Event Estimation, per-pixel
adaptive sampling and ACES tone mapping -- designed as a wavefront renderer
(lax.scan over bounces with active-ray masking instead of the reference's
divergent megakernel, path_tracing.cuh:279-319), with reparameterized
sampling so pixel gradients flow to material and camera parameters, and
shard_map scaling over device meshes.
"""

__version__ = "0.1.0"

import jax as _jax

# Rendering is cancellation-sensitive (plane-offset minus origin dots,
# barycentric denominators) and every matmul in this framework is tiny
# (K = 3 ray/vertex contractions, the 3x3 colour matrices of
# math/color.py), so a GPU's default TF32 matmul precision (about three
# decimal digits) would corrupt hit distances and colours for no speedup.
# Force full-f32 contractions framework-wide.
_jax.config.update("jax_default_matmul_precision", "highest")

from isaklm_raytracer_tpu.config import RenderConfig

__all__ = ["RenderConfig", "__version__"]
