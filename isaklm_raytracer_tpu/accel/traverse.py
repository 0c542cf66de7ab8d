"""Ray-scene intersection: brute-force oracle + differentiable hit shading.

The discrete part (which triangle is hit) is computed with detached values
and returned as int32 indices; `hit_attributes` then rebuilds the hit point,
shading frame, and material sample differentiably from the index, so
gradients flow through ray origin/direction and material parameters while
hit topology is (correctly) treated as a constant -- the standard
detached-sampler treatment from the differentiable-rendering literature.

Intersection math matches the reference:
  - plane hit + barycentric inside test, t >= 1e-5: trace_ray.cuh:73-113
  - Cramer barycentrics: trace_ray.cuh:48-71
  - nearest-hit shading sample: trace_ray.cuh:115-172

The KD-tree accelerated path lives in accel/kdtree.py + kernels/; this
module's `nearest_hit_brute` is the exact oracle (O(R*N), scanned in
triangle chunks to bound memory) used for tests and small scenes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from isaklm_raytracer_tpu import pytree
from isaklm_raytracer_tpu.math import transforms
from isaklm_raytracer_tpu.scene.types import Scene, sample_texture

_INF = jnp.float32(jnp.inf)


def _ray_triangle(o, d, p1, p2, p3, t_eps):
    """Batched ray-triangle test (trace_ray.cuh:73-113).

    o, d: (R, 3); p1/p2/p3: (N, 3). Returns (t (R, N), valid (R, N)).
    Parallel rays (dot == 0) and t < t_eps are invalid, matching the
    reference's rejections.
    """
    geo_n = transforms.normalize(jnp.cross(p2 - p1, p3 - p1))  # (N, 3)
    ddn = d @ geo_n.T  # (R, N)
    d_plane = jnp.sum(geo_n * p1, axis=-1)  # (N,)
    s = (d_plane[None, :] - o @ geo_n.T) / ddn  # (R, N)

    point = o[:, None, :] + s[..., None] * d[:, None, :]  # (R, N, 3)
    bary = barycentric(point, p1, p2, p3)  # (R, N, 3)
    inside = jnp.all((bary >= 0.0) & (bary <= 1.0), axis=-1)

    valid = (ddn != 0.0) & (s >= t_eps) & inside
    return s, valid


def barycentric(point, p1, p2, p3):
    """Cramer's-rule barycentrics (trace_ray.cuh:48-71).

    point: (..., N, 3) or (N, 3); p1/p2/p3: (N, 3). Returns (..., N, 3) as
    (alpha, beta, gamma) weights for (p1, p2, p3).
    """
    v0 = p2 - p1
    v1 = p3 - p1
    v2 = point - p1
    d00 = jnp.sum(v0 * v0, axis=-1)
    d01 = jnp.sum(v0 * v1, axis=-1)
    d11 = jnp.sum(v1 * v1, axis=-1)
    d20 = jnp.sum(v2 * v0, axis=-1)
    d21 = jnp.sum(v2 * v1, axis=-1)
    inv_den = 1.0 / (d00 * d11 - d01 * d01)
    b = (d11 * d20 - d01 * d21) * inv_den
    c = (d00 * d21 - d01 * d20) * inv_den
    a = 1.0 - b - c
    return jnp.stack([a, b, c], axis=-1)


def nearest_hit_brute(
    o: jnp.ndarray,
    d: jnp.ndarray,
    vertices: jnp.ndarray,
    t_eps: float = 1e-5,
    chunk: int = 2048,
    active=None,
    t_max=None,
):
    """Nearest hit over all triangles; exact oracle for the KD traversal.

    o, d: (R, 3); vertices: (N, 3, 3). Returns (t (R,), idx (R,) int32,
    hit (R,) bool). Ties resolve to the lowest triangle index, matching the
    reference's strictly-closer leaf scan (trace_ray.cuh:133).
    All outputs are detached (stop_gradient) -- use `hit_attributes` for the
    differentiable reconstruction.
    """
    n = vertices.shape[0]
    num_chunks = -(-n // chunk)
    pad = num_chunks * chunk - n
    padded = jnp.pad(vertices, ((0, pad), (0, 0), (0, 0)))
    chunks = padded.reshape(num_chunks, chunk, 3, 3)

    def body(carry, tri_chunk):
        best_t, best_idx, chunk_idx = carry
        p1, p2, p3 = tri_chunk[:, 0], tri_chunk[:, 1], tri_chunk[:, 2]
        t, valid = _ray_triangle(o, d, p1, p2, p3, t_eps)
        base = chunk_idx * chunk
        global_idx = base + jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
        in_range = global_idx < n
        t = jnp.where(valid & in_range, t, _INF)
        local_best = jnp.argmin(t, axis=-1)
        local_t = jnp.take_along_axis(t, local_best[:, None], axis=-1)[:, 0]
        better = local_t < best_t
        best_idx = jnp.where(better, base + local_best.astype(jnp.int32), best_idx)
        best_t = jnp.where(better, local_t, best_t)
        return (best_t, best_idx, chunk_idx + 1), None

    init = (
        jnp.full(o.shape[:1], _INF),
        jnp.full(o.shape[:1], -1, jnp.int32),
        jnp.int32(0),
    )
    (best_t, best_idx, _), _ = jax.lax.scan(body, init, chunks)
    hit = jnp.isfinite(best_t)
    if active is not None:
        hit = hit & active
        best_idx = jnp.where(active, best_idx, -1)
        best_t = jnp.where(active, best_t, _INF)
    return (
        jax.lax.stop_gradient(best_t),
        jax.lax.stop_gradient(best_idx),
        jax.lax.stop_gradient(hit),
    )


@pytree.dataclass
class HitAttributes:
    """Differentiable hit record (reference Sample, trace_ray.cuh:17-29)."""

    albedo: jnp.ndarray  # (R, 3) texture-modulated
    emittance: jnp.ndarray  # (R, 3) texture-modulated
    roughness: jnp.ndarray  # (R,)
    ior: jnp.ndarray  # (R,)
    extinction: jnp.ndarray  # (R,)
    transparent: jnp.ndarray  # (R,) in {0., 1.}
    triangle_index: jnp.ndarray  # (R,) int32 (detached)
    position: jnp.ndarray  # (R, 3)
    normal: jnp.ndarray  # (R, 3) shading normal (back-face flipped)
    tangent: jnp.ndarray  # (R, 3)
    bitangent: jnp.ndarray  # (R, 3)
    t: jnp.ndarray  # (R,) hit distance


def hit_attributes(
    scene: Scene, o: jnp.ndarray, d: jnp.ndarray, idx: jnp.ndarray, hit: jnp.ndarray
) -> HitAttributes:
    """Rebuild the reference's `Sample` (trace_ray.cuh:144-168) differentiably.

    Given a detached nearest-hit triangle index, recompute the hit distance
    from the plane equation, barycentrics via Cramer, the interpolated
    shading normal / reference tangent frame, and the texture-modulated
    material sample. Non-hit lanes get safe dummy values (index 0, t = 1).
    """
    safe_idx = jnp.maximum(idx, 0)
    # jnp.asarray: scene leaves may be HOST numpy arrays on an unprepared
    # scene (build_scene defers the device transfer); indexing numpy with a
    # tracer is an error, and asarray is a no-op on device arrays/tracers.
    if scene.shade_table is not None:
        # One contiguous row gather for all per-triangle data instead of
        # five strided ones.
        row = jnp.asarray(scene.shade_table)[safe_idx]  # (R, 32)
        p1, p2, p3 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        nrm1, nrm2, nrm3 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
        uv1, uv2, uv3 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
        mat = row[:, 24].astype(jnp.int32)
    else:
        tri = jnp.asarray(scene.vertices)[safe_idx]  # (R, 3, 3)
        p1, p2, p3 = tri[:, 0], tri[:, 1], tri[:, 2]
        nrm = jnp.asarray(scene.normals)[safe_idx]  # (R, 3, 3)
        nrm1, nrm2, nrm3 = nrm[:, 0], nrm[:, 1], nrm[:, 2]
        uvs = jnp.asarray(scene.uvs)[safe_idx]  # (R, 3, 2)
        uv1, uv2, uv3 = uvs[:, 0], uvs[:, 1], uvs[:, 2]
        mat = jnp.asarray(scene.mat_id)[safe_idx]

    geo_n = transforms.normalize(jnp.cross(p2 - p1, p3 - p1))
    ddn = jnp.sum(d * geo_n, axis=-1)
    # Guard divide for miss lanes / degenerate triangles.
    ddn = jnp.where(jnp.abs(ddn) < 1e-20, 1e-20, ddn)
    t = (jnp.sum(geo_n * p1, axis=-1) - jnp.sum(o * geo_n, axis=-1)) / ddn
    t = jnp.where(hit, t, 1.0)

    point = o + t[:, None] * d
    bary = barycentric(point, p1, p2, p3)  # (R, 3)
    position = (
        bary[:, 0:1] * p1 + bary[:, 1:2] * p2 + bary[:, 2:3] * p3
    )  # trace_ray.cuh:158

    normal = transforms.normalize(
        bary[:, 0:1] * nrm1 + bary[:, 1:2] * nrm2 + bary[:, 2:3] * nrm3
    )
    # Frame from the UNflipped normal, then back-face flip of the normal only
    # (trace_ray.cuh:160-168).
    tangent = transforms.normalize(jnp.cross(p2 - p1, normal))
    bitangent = transforms.normalize(jnp.cross(normal, tangent))
    normal = jnp.where(
        (jnp.sum(d * normal, axis=-1) > 0.0)[:, None], -normal, normal
    )

    uv = bary[:, 0:1] * uv1 + bary[:, 1:2] * uv2 + bary[:, 2:3] * uv3

    # Pack the scalar material fields into one row so the per-material
    # fetch is a single gather; built from the LIVE MaterialTable inside
    # the trace, so gradients to albedo/emittance/roughness/ior still flow
    # (the pack is just a concat in the autodiff graph).
    m = scene.materials
    mat_pack = jnp.concatenate(
        [
            m.albedo,
            m.emittance,
            m.roughness[:, None],
            m.ior[:, None],
            m.extinction[:, None],
            m.transparent[:, None],
        ],
        axis=1,
    )  # (M, 10)
    mrow = mat_pack[mat]  # (R, 10)
    tex_id = jnp.asarray(m.tex_id)[mat]
    albedo = sample_texture(scene.textures, tex_id, mrow[:, 0:3], uv)
    emittance = sample_texture(scene.textures, tex_id, mrow[:, 3:6], uv)

    return HitAttributes(
        albedo=albedo,
        emittance=emittance,
        roughness=mrow[:, 6],
        ior=mrow[:, 7],
        extinction=mrow[:, 8],
        transparent=mrow[:, 9],
        triangle_index=idx,
        position=position,
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        t=t,
    )
