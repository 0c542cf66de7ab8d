"""Vectorized microfacet BSDF sampling (wavefront form).

Re-derivation of the reference's divergent `get_scattered_light`
(path_tracing.cuh:151-219) as branch-free masked arithmetic: all four lobes
(metallic / specular / transmission / diffuse) are evaluated for every lane
and combined with `jnp.where` selects -- the wavefront equivalent of SIMT
divergence. Semantics preserved exactly:

  - metallic when extinction > 0: conductor Fresnel x albedo x
    specular_weight (path_tracing.cuh:161-171)
  - else dielectric with (n1, n2) swapped inside the medium
    (path_tracing.cuh:174-181)
  - stochastic lobe choice: u < fresnel -> specular; the specular weight is
    forced to 1 when inside the medium (the reference's energy hack,
    path_tracing.cuh:187-200)
  - transparent -> refraction, toggling inside_medium
    (path_tracing.cuh:201-211)
  - else cosine-weighted diffuse with weight = albedo (cosine pdf cancels,
    path_tracing.cuh:212-217)

Sampling is reparameterized: uniforms come in as arguments, so gradients
flow through directions and weights to material parameters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from isaklm_raytracer_tpu import pytree
from isaklm_raytracer_tpu.accel.traverse import HitAttributes
from isaklm_raytracer_tpu.math import sampling


@pytree.dataclass
class ScatterSample:
    """Vectorized Scattering_Event (path_tracing.cuh:27-32)."""

    direction: jnp.ndarray  # (R, 3) new ray direction
    weight: jnp.ndarray  # (R, 3) throughput multiplier
    is_diffuse: jnp.ndarray  # (R,) bool -- drives NEE + emittance bookkeeping
    inside_medium: jnp.ndarray  # (R,) bool, post-event


def scatter(
    hit: HitAttributes,
    ray_direction: jnp.ndarray,
    inside_medium: jnp.ndarray,
    u_half1: jnp.ndarray,
    u_half2: jnp.ndarray,
    u_lobe: jnp.ndarray,
    u_diff1: jnp.ndarray,
    u_diff2: jnp.ndarray,
    lobe_ratio_grad: bool = True,
) -> ScatterSample:
    """Sample the next scattering event for every lane.

    ray_direction: (R, 3) direction of travel (the BSDF maths flips it to
    point away from the surface, path_tracing.cuh:155).
    """
    wi = -ray_direction
    normal, tangent, bitangent = hit.normal, hit.tangent, hit.bitangent
    rough = hit.roughness

    half = sampling.ggx_half_vector(
        u_half1, u_half2, rough, normal, tangent, bitangent
    )

    is_metal = hit.extinction > 0.0

    # Lane sanitization: the reference evaluates each lobe's maths only on
    # the SIMT branch that selected it; the wavefront form evaluates every
    # lobe on every lane, so lanes that will never select a lobe must still
    # feed it benign inputs -- otherwise their NaN/Inf intermediates poison
    # gradients through jnp.where (0 * NaN = NaN in the VJP).

    # --- metallic lobe (path_tracing.cuh:161-171)
    n_metal = jnp.where(is_metal, hit.ior, 1.0)
    k_metal = jnp.where(is_metal, hit.extinction, 1.0)
    f_cond = sampling.fresnel_conductor(wi, half, n_metal, k_metal)
    refl = sampling.reflect(wi, half)
    sw_refl = sampling.specular_weight(wi, refl, half, normal, rough)
    w_metal = hit.albedo * (sw_refl * f_cond)[..., None]

    # --- dielectric stack (path_tracing.cuh:174-217)
    # ior 0 (an unset .mat "n") inside a medium would divide by zero; the
    # floor keeps it finite while preserving F -> 1 (always-specular), which
    # is the reference's outside-medium behavior for ior 0.
    ior = jnp.maximum(hit.ior, 1e-6)
    n1 = jnp.where(inside_medium, ior, 1.0)
    n2 = jnp.where(inside_medium, 1.0, ior)
    f_diel = sampling.fresnel_dielectric(wi, half, n1, n2)
    # Detached-sampling ratio estimator: the lobe is CHOSEN with the
    # detached Fresnel (a discrete reparameterized decision autodiff cannot
    # see), and each lobe's weight carries the ratio of the live Fresnel to
    # the detached one. Forward values are exactly 1 (bit-identical images);
    # under jax.grad the ratio contributes d(selection probability)/d(theta)
    # -- the score-like term that makes IOR and roughness gradients unbiased
    # (E[weight * lobe] = F * spec + (1 - F) * rest with F differentiable).
    # The reference has no gradient story at all (path_tracing.cuh:187-200);
    # this is the differentiable-rendering extension of its estimator.
    # `lobe_ratio_grad=False` drops the ratio terms (pure reparameterized
    # gradient): CRN finite differences can then verify autodiff pointwise,
    # because FD cannot see through stop_gradient (F/detach(F) is
    # identically 1 under FD) -- the ratio term is only correct against the
    # EXPECTED radiance (tests/test_estimator.py unit-checks that).
    f_det = jax.lax.stop_gradient(f_diel)
    choose_specular = u_lobe < f_det
    if lobe_ratio_grad:
        ratio_spec = f_diel / jnp.maximum(f_det, 1e-12)
        ratio_rest = (1.0 - f_diel) / jnp.maximum(1.0 - f_det, 1e-12)
    else:
        ratio_spec = jnp.ones_like(f_det)
        ratio_rest = jnp.ones_like(f_det)

    w_spec = (jnp.where(inside_medium, 1.0, sw_refl) * ratio_spec)[
        ..., None
    ] * jnp.ones((1, 3), jnp.float32)

    is_transparent = hit.transparent > 0.5
    n1_t = jnp.where(is_transparent, n1, 1.0)
    n2_t = jnp.where(is_transparent, n2, 1.5)
    refr = sampling.refract(wi, half, n1_t, n2_t)
    sw_refr = sampling.specular_weight(wi, refr, half, normal, rough)
    w_trans = hit.albedo * (sw_refr * ratio_rest)[..., None]

    diff = sampling.cosine_hemisphere(u_diff1, u_diff2, normal, tangent, bitangent)
    w_diff = hit.albedo * ratio_rest[..., None]

    is_spec = (~is_metal) & choose_specular
    is_trans = (~is_metal) & (~choose_specular) & is_transparent
    is_diff = (~is_metal) & (~choose_specular) & (~is_transparent)

    sel = lambda mask, a, b: jnp.where(mask[..., None], a, b)
    direction = sel(is_metal, refl, sel(is_spec, refl, sel(is_trans, refr, diff)))
    weight = sel(is_metal, w_metal, sel(is_spec, w_spec, sel(is_trans, w_trans, w_diff)))

    new_inside = jnp.where(is_trans, ~inside_medium, inside_medium)

    return ScatterSample(
        direction=direction,
        weight=weight,
        is_diffuse=is_diff,
        inside_medium=new_inside,
    )
