"""Batched lockstep KD traversal in plain XLA -- the intersector off the GPU.

The reference's per-thread stackful walk (trace_ray.cuh:244-318) maps badly
onto array programs if transliterated per ray (scalar gathers inside a
vmapped while_loop are latency-bound). This module re-architects it for
whole-array execution while preserving the exact hit semantics (the GPU
runs the same walk per ray in one kernel, accel/kd_kernel.py):

  - leaf triangle lists are re-laid out as FIXED-SIZE chunks
    (chunk_tri_data: (n_chunks, L, 9) with p1|e1|e2 per slot, -1-padded
    ids), so a leaf visit is ONE contiguous-row gather plus an (R, L)
    vectorized intersection -- no ragged loops;
  - oversized depth-capped leaves become chunk CHAINS via chunk_next;
  - all rays advance in lockstep through a single masked state machine
    (descend / scan / pop fused into one lax.while_loop iteration), so
    control flow is uniform -- the wavefront analog of SIMT divergence;
  - per-ray short stacks live in (R, depth) arrays updated by masked
    scatters.

Semantics match trace_ray.cuh: near/far by ray origin vs plane (origin-on-
plane disambiguated by direction), near-first classification, exit-distance
clamped leaf hits, first-leaf-hit return, duplicated straddlers handled by
the exit clamp.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from isaklm_raytracer_tpu import pytree
from isaklm_raytracer_tpu.scene.types import KDTreeArrays

_INF = jnp.float32(jnp.inf)


@pytree.dataclass
class WavefrontKD:
    """KD tree re-laid out for batched traversal."""

    # node arrays (K,)
    child_a: jnp.ndarray
    child_b: jnp.ndarray
    axis: jnp.ndarray
    plane: jnp.ndarray
    is_leaf: jnp.ndarray
    leaf_first: jnp.ndarray  # (K,) first chunk row, -1 = empty leaf / inner
    # chunk arrays
    chunk_next: jnp.ndarray  # (C,) next row in chain, -1 = end
    chunk_tri: jnp.ndarray  # (C, L) triangle ids, -1 pad
    chunk_data: jnp.ndarray  # (C, L, 9) p1 | e1 | e2
    bbox_min: jnp.ndarray
    bbox_max: jnp.ndarray
    max_depth: int = pytree.field(pytree_node=False, default=19)
    leaf_width: int = pytree.field(pytree_node=False, default=8)


def build_wavefront_kd(
    kd: KDTreeArrays, vertices: np.ndarray, leaf_width: int = 8
) -> WavefrontKD:
    """Host-side re-layout of a built KDTreeArrays (numpy)."""
    child_a = np.asarray(kd.child_a)
    child_b = np.asarray(kd.child_b)
    is_leaf = np.asarray(kd.is_leaf)
    tri_indices = np.asarray(kd.tri_indices)
    vertices = np.asarray(vertices, np.float32)

    n_nodes = len(child_a)
    leaf_first = np.full(n_nodes, -1, np.int32)

    chunk_tri_rows: list[np.ndarray] = []
    chunk_next: list[int] = []

    leaf_nodes = np.nonzero(is_leaf)[0]
    for node in leaf_nodes:
        count = child_b[node]
        if count == 0:
            continue
        offset = child_a[node]
        ids = tri_indices[offset : offset + count]
        n_chunks = -(-count // leaf_width)
        first_row = len(chunk_tri_rows)
        leaf_first[node] = first_row
        padded = np.full(n_chunks * leaf_width, -1, np.int32)
        padded[:count] = ids
        for c in range(n_chunks):
            chunk_tri_rows.append(padded[c * leaf_width : (c + 1) * leaf_width])
            chunk_next.append(first_row + c + 1 if c + 1 < n_chunks else -1)

    if chunk_tri_rows:
        chunk_tri = np.stack(chunk_tri_rows)
    else:
        chunk_tri = np.full((1, leaf_width), -1, np.int32)
        chunk_next = [-1]

    safe = np.maximum(chunk_tri, 0)
    tri = vertices[safe]  # (C, L, 3, 3)
    p1 = tri[:, :, 0]
    e1 = tri[:, :, 1] - p1
    e2 = tri[:, :, 2] - p1
    chunk_data = np.concatenate([p1, e1, e2], axis=-1)  # (C, L, 9)

    return WavefrontKD(
        child_a=jnp.asarray(child_a),
        child_b=jnp.asarray(child_b),
        axis=jnp.asarray(np.asarray(kd.axis)),
        plane=jnp.asarray(np.asarray(kd.plane)),
        is_leaf=jnp.asarray(is_leaf),
        leaf_first=jnp.asarray(leaf_first),
        chunk_next=jnp.asarray(np.asarray(chunk_next, np.int32)),
        chunk_tri=jnp.asarray(chunk_tri),
        chunk_data=jnp.asarray(chunk_data),
        bbox_min=jnp.asarray(np.asarray(kd.bbox_min)),
        bbox_max=jnp.asarray(np.asarray(kd.bbox_max)),
        max_depth=kd.max_depth,
        leaf_width=leaf_width,
    )


def _intersect_chunk(o, d, data, tri_ids, max_t, best_t, t_eps):
    """(R, L) vectorized ray-triangle tests (trace_ray.cuh:73-113 maths).

    o, d: (R, 3); data: (R, L, 9); returns (t (R,), idx (R,)) of the nearest
    accepted hit in this chunk row (or (+inf, -1)).
    """
    p1 = data[..., 0:3]
    e1 = data[..., 3:6]
    e2 = data[..., 6:9]
    geo_n = jnp.cross(e1, e2)
    geo_n = geo_n * jax.lax.rsqrt(
        jnp.maximum(jnp.sum(geo_n * geo_n, axis=-1, keepdims=True), 1e-30)
    )
    ddn = jnp.sum(d[:, None, :] * geo_n, axis=-1)  # (R, L)
    s = (
        jnp.sum(geo_n * p1, axis=-1) - jnp.sum(o[:, None, :] * geo_n, axis=-1)
    ) / ddn

    point = o[:, None, :] + s[..., None] * d[:, None, :]
    v2 = point - p1
    d00 = jnp.sum(e1 * e1, axis=-1)
    d01 = jnp.sum(e1 * e2, axis=-1)
    d11 = jnp.sum(e2 * e2, axis=-1)
    d20 = jnp.sum(v2 * e1, axis=-1)
    d21 = jnp.sum(v2 * e2, axis=-1)
    inv_den = 1.0 / (d00 * d11 - d01 * d01)
    b = (d11 * d20 - d01 * d21) * inv_den
    c = (d00 * d21 - d01 * d20) * inv_den
    a = 1.0 - b - c
    inside = (
        (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0) & (c >= 0.0) & (c <= 1.0)
    )
    limit = jnp.minimum(max_t, best_t)[:, None]
    valid = (
        (tri_ids >= 0) & (ddn != 0.0) & (s >= t_eps) & inside & (s < limit)
    )
    s = jnp.where(valid, s, _INF)
    slot = jnp.argmin(s, axis=-1)
    t = jnp.take_along_axis(s, slot[:, None], axis=-1)[:, 0]
    idx = jnp.take_along_axis(tri_ids, slot[:, None], axis=-1)[:, 0]
    idx = jnp.where(jnp.isfinite(t), idx, -1)
    return t, idx


def nearest_hit_wavefront(
    wkd: WavefrontKD,
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_eps: float = 1e-5,
    active=None,
    t_max=None,
):
    """Batched nearest hit. o, d: (R, 3) -> (t, idx, hit), detached.

    `active` (R,) bool masks lanes out of the lockstep loop entirely --
    inactive lanes report a miss and cost no iterations (the wavefront
    integrator passes its live-path mask so late bounces converge fast).
    
    `t_max` is accepted for interface parity with the other intersectors
    (a search-window performance hint, integrator/nee.py) and ignored
    here; visibility results are identical either way.
    """
    num_rays = o.shape[0]
    depth = wkd.max_depth + 2

    t_lo = (wkd.bbox_min - o) / d
    t_hi = (wkd.bbox_max - o) / d
    t_near = jnp.max(jnp.minimum(t_lo, t_hi), axis=-1)
    t_far = jnp.min(jnp.maximum(t_lo, t_hi), axis=-1)
    hit_box = t_near <= t_far
    if active is not None:
        hit_box = hit_box & active

    state = dict(
        node=jnp.zeros((num_rays,), jnp.int32),
        entry=t_near,
        exit=t_far,
        sp=jnp.zeros((num_rays,), jnp.int32),
        stack_node=jnp.zeros((num_rays, depth), jnp.int32),
        stack_entry=jnp.zeros((num_rays, depth), jnp.float32),
        stack_exit=jnp.zeros((num_rays, depth), jnp.float32),
        chunk=jnp.full((num_rays,), -1, jnp.int32),
        best_t=jnp.full((num_rays,), _INF),
        best_i=jnp.full((num_rays,), -1, jnp.int32),
        done=~hit_box,
    )

    rows = jnp.arange(num_rays)

    def cond(s):
        return jnp.any(~s["done"])

    def step(s):
        active = ~s["done"]
        scanning = s["chunk"] >= 0
        node = s["node"]
        leaf = wkd.is_leaf[node]

        # ---------- descend one inner-node level (masked)
        descend = active & (~scanning) & (~leaf)
        axis = wkd.axis[node]
        plane = wkd.plane[node]
        c1 = wkd.child_a[node]
        c2 = wkd.child_b[node]
        o_ax = jnp.take_along_axis(o, axis[:, None], axis=-1)[:, 0]
        d_ax = jnp.take_along_axis(d, axis[:, None], axis=-1)[:, 0]
        behind = (o_ax > plane) | ((o_ax == plane) & (d_ax < 0.0))
        near = jnp.where(behind, c2, c1)
        far = jnp.where(behind, c1, c2)
        t_plane = (plane - o_ax) / d_ax
        near_only = (t_plane >= s["exit"]) | (t_plane < 0.0) | jnp.isnan(t_plane)
        far_only = (~near_only) & (t_plane <= s["entry"])
        push = (~near_only) & (~far_only)

        do_push = descend & push
        sp = s["sp"]
        stack_node = s["stack_node"].at[rows, sp].set(
            jnp.where(do_push, far, s["stack_node"][rows, sp])
        )
        stack_entry = s["stack_entry"].at[rows, sp].set(
            jnp.where(do_push, t_plane, s["stack_entry"][rows, sp])
        )
        stack_exit = s["stack_exit"].at[rows, sp].set(
            jnp.where(do_push, s["exit"], s["stack_exit"][rows, sp])
        )
        sp_after = jnp.where(do_push, jnp.minimum(sp + 1, depth - 1), sp)
        node_desc = jnp.where(far_only, far, near)
        exit_desc = jnp.where(push, t_plane, s["exit"])

        # ---------- enter leaf (masked): arm the chunk scan
        entering = active & (~scanning) & leaf
        first = wkd.leaf_first[node]

        # ---------- scan one chunk row (masked)
        chunk = jnp.maximum(s["chunk"], 0)
        data = wkd.chunk_data[chunk]  # (R, L, 9) contiguous rows
        tri_ids = wkd.chunk_tri[chunk]  # (R, L)
        ct, ci = _intersect_chunk(
            o, d, data, tri_ids, s["exit"], s["best_t"], t_eps
        )
        scan_hit = active & scanning & (ci >= 0)
        best_t = jnp.where(scan_hit, ct, s["best_t"])
        best_i = jnp.where(scan_hit, ci, s["best_i"])
        next_chunk = wkd.chunk_next[chunk]

        # ---------- finish-leaf: scan chain exhausted, or empty leaf
        finish = (active & scanning & (next_chunk < 0)) | (entering & (first < 0))
        found = finish & (best_i >= 0)
        # pop (trace_ray.cuh:264-267) for finished-but-not-found lanes
        popping = finish & (~found)
        stack_empty = s["sp"] == 0
        pop_sp = jnp.maximum(s["sp"] - 1, 0)
        popped_node = s["stack_node"][rows, pop_sp]
        popped_entry = s["stack_entry"][rows, pop_sp]
        popped_exit = s["stack_exit"][rows, pop_sp]

        new_chunk = jnp.where(
            entering & (first >= 0),
            first,
            jnp.where(
                active & scanning,
                jnp.where(finish, jnp.int32(-1), next_chunk),
                s["chunk"],
            ),
        )
        new_node = jnp.where(
            descend, node_desc, jnp.where(popping & ~stack_empty, popped_node, node)
        )
        new_entry = jnp.where(popping & ~stack_empty, popped_entry, s["entry"])
        new_exit = jnp.where(
            descend, exit_desc, jnp.where(popping & ~stack_empty, popped_exit, s["exit"])
        )
        new_sp = jnp.where(descend, sp_after, jnp.where(popping, pop_sp, s["sp"]))
        new_done = s["done"] | found | (popping & stack_empty)

        return dict(
            node=new_node,
            entry=new_entry,
            exit=new_exit,
            sp=new_sp,
            stack_node=stack_node,
            stack_entry=stack_entry,
            stack_exit=stack_exit,
            chunk=new_chunk,
            best_t=best_t,
            best_i=best_i,
            done=new_done,
        )

    final = jax.lax.while_loop(cond, step, state)
    hit = final["best_i"] >= 0
    t = jnp.where(hit, final["best_t"], _INF)
    return (
        jax.lax.stop_gradient(t),
        jax.lax.stop_gradient(final["best_i"]),
        jax.lax.stop_gradient(hit),
    )
