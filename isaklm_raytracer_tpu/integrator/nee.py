"""Next Event Estimation: direct light sampling with shadow rays.

Matches `sample_direct_light` (path_tracing.cuh:235-265): pick a light
triangle uniformly, pick a uniform point on it (sqrt warp), shoot a shadow
ray through the full intersector, accept only if the exact light triangle is
the nearest hit, and weight by
  emittance * area * light_count * cos1 * cos2 / max(d^2 * pi, 1e-3)
where cos1 is against the light's interpolated (back-face-flipped) shading
normal at the shadow hit and cos2 against the surface normal, both clamped
at 0, and emittance is texture-modulated at the shadow hit point
(trace_ray.cuh:151).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from isaklm_raytracer_tpu.accel.traverse import hit_attributes
from isaklm_raytracer_tpu.math import sampling, transforms
from isaklm_raytracer_tpu.scene.types import Scene


def sample_direct_light(
    scene: Scene,
    position: jnp.ndarray,
    surface_normal: jnp.ndarray,
    u_pick: jnp.ndarray,
    u_tri1: jnp.ndarray,
    u_tri2: jnp.ndarray,
    trace_fn,
    active=None,
) -> jnp.ndarray:
    """Direct light estimate at `position` (R, 3). Returns radiance (R, 3).

    trace_fn(o, d) -> (t, idx, hit) is the pluggable intersector (brute
    force oracle or KD traversal kernel).
    """
    num_lights = scene.num_lights
    pick = jnp.clip(
        (u_pick * num_lights).astype(jnp.int32), 0, num_lights - 1
    )  # int(u * light_count), path_tracing.cuh:237
    # asarray: leaves may be host numpy on an unprepared scene (build_scene)
    light_idx = jnp.asarray(scene.light_indices)[pick]  # (R,)

    tri = jnp.asarray(scene.vertices)[light_idx]  # (R, 3, 3)
    p1, p2, p3 = tri[:, 0], tri[:, 1], tri[:, 2]
    point = sampling.uniform_triangle(u_tri1, u_tri2, p1, p2, p3)

    to_light = point - position
    shadow_dir = transforms.normalize(to_light)

    # Search-window hint: visibility only cares whether the light triangle
    # (sitting at |to_light|) is the nearest hit, so hits beyond the light
    # can never change the verdict -- if the true nearest lies beyond the
    # window the intersector may report a miss, and `idx == light_idx` is
    # false either way. An intersector may use the bound to skip everything
    # behind the light; the KD intersectors ignore the hint today. The 0.1%
    # slack covers f32 plane-hit error so the light itself is never culled.
    t_light = jnp.sqrt(jnp.sum(to_light * to_light, axis=-1))
    window = t_light * 1.001 + 1e-3

    t, idx, hit = trace_fn(position, shadow_dir, active=active, t_max=window)
    visible = hit & (idx == light_idx)

    attrs = hit_attributes(scene, position, shadow_dir, idx, hit)

    light_area = 0.5 * jnp.linalg.norm(jnp.cross(p2 - p1, p3 - p1), axis=-1)
    dist_sq = jnp.sum(to_light * to_light, axis=-1)

    cos1 = jnp.maximum(-jnp.sum(shadow_dir * attrs.normal, axis=-1), 0.0)
    cos2 = jnp.maximum(jnp.sum(shadow_dir * surface_normal, axis=-1), 0.0)

    scale = (
        light_area
        * float(num_lights)
        * cos1
        * cos2
        / jnp.maximum(dist_sq * math.pi, 0.001)
    )
    contribution = attrs.emittance * scale[..., None]
    return jnp.where(visible[..., None], contribution, 0.0)
