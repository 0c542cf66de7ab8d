"""Fused per-ray KD walk: the GPU nearest-hit kernel (Pallas, Triton route).

One program traces a block of rays through the `WavefrontKD` layout
(accel.wavefront) the way the reference does on the card
(trace_ray.cuh:244-318): every ray keeps its node, its short stack and its
best hit on chip, walks near child first, scans its leaf's chunk rows
against the exit distance and stops at the first leaf with a hit. A block
ends when its own slowest ray does, and a trace call is one launch. The
XLA walk (nearest_hit_wavefront) instead steps all rays of a call in
lockstep, with several launches and a host read of the loop predicate per
step, and keeps the stacks in device memory.

Within a block the walk is "while-while" (Aila & Laine 2009): descend until
every live ray stands on a leaf, scan those leaves' chunk chains, then pop.
Hit semantics and ray-triangle arithmetic are nearest_hit_wavefront's, so
both intersectors return the same hits; tests/test_intersector.py runs this
kernel in interpret mode against it and against the brute-force oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from isaklm_raytracer_tpu.accel.wavefront import WavefrontKD

# Rays per program and warps per program. One ray per thread: a (BLOCK,)
# vector is spread over BLOCK threads with no replication.
BLOCK = 64
NUM_WARPS = BLOCK // 32

_INF = float("inf")


def _any(mask):
    # The Triton route has no boolean reduction.
    return jnp.max(mask.astype(jnp.int32)) > 0


def _pick(axis, v):
    return jnp.where(axis == 0, v[0], jnp.where(axis == 1, v[1], v[2]))


def _load(ref, idx, mask, other):
    return plgpu.load(ref.at[idx], mask=mask, other=other)


def _intersect_row(o, d, comp, tri, max_t, best_t, t_eps):
    """Nearest accepted hit in one chunk row: accel.wavefront._intersect_chunk
    written per component. comp: 9 (B, L) arrays p1 | e1 | e2; tri: (B, L)
    ids, -1 pad. Returns (t (B,), idx (B,)), (+inf, -1) for no hit."""
    p1, e1, e2 = comp[0:3], comp[3:6], comp[6:9]
    n = [
        e1[1] * e2[2] - e1[2] * e2[1],
        e1[2] * e2[0] - e1[0] * e2[2],
        e1[0] * e2[1] - e1[1] * e2[0],
    ]
    scale = jax.lax.rsqrt(jnp.maximum(n[0] * n[0] + n[1] * n[1] + n[2] * n[2], 1e-30))
    n = [c * scale for c in n]
    oc = [c[:, None] for c in o]
    dc = [c[:, None] for c in d]
    ddn = dc[0] * n[0] + dc[1] * n[1] + dc[2] * n[2]
    s = (
        (n[0] * p1[0] + n[1] * p1[1] + n[2] * p1[2])
        - (oc[0] * n[0] + oc[1] * n[1] + oc[2] * n[2])
    ) / ddn
    v2 = [oc[k] + s * dc[k] - p1[k] for k in range(3)]
    d00 = e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2]
    d01 = e1[0] * e2[0] + e1[1] * e2[1] + e1[2] * e2[2]
    d11 = e2[0] * e2[0] + e2[1] * e2[1] + e2[2] * e2[2]
    d20 = v2[0] * e1[0] + v2[1] * e1[1] + v2[2] * e1[2]
    d21 = v2[0] * e2[0] + v2[1] * e2[1] + v2[2] * e2[2]
    inv_den = 1.0 / (d00 * d11 - d01 * d01)
    b = (d11 * d20 - d01 * d21) * inv_den
    c = (d00 * d21 - d01 * d20) * inv_den
    a = 1.0 - b - c
    inside = (
        (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0) & (c >= 0.0) & (c <= 1.0)
    )
    limit = jnp.minimum(max_t, best_t)[:, None]
    valid = (tri >= 0) & (ddn != 0.0) & (s >= t_eps) & inside & (s < limit)
    s = jnp.where(valid, s, _INF)
    t = jnp.min(s, axis=1)
    # first slot holding the minimum, as argmin would pick
    slot = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    first = jnp.min(jnp.where(s == t[:, None], slot, s.shape[1]), axis=1)
    idx = jnp.sum(jnp.where(slot == first[:, None], tri, 0), axis=1)
    return t, jnp.where(t < _INF, idx, -1)


def _walk_kernel(
    rays_ref, child_a_ref, child_b_ref, axis_ref, plane_ref, is_leaf_ref,
    leaf_first_ref, chunk_next_ref, chunk_tri_ref, chunk_data_ref, box_ref,
    t_ref, i_ref, *, depth, stack_size, leaf_width, t_eps,
):
    o = [rays_ref[k] for k in range(3)]
    d = [rays_ref[3 + k] for k in range(3)]
    active = rays_ref[6] > 0.0
    block = o[0].shape[0]

    # root box slab test, as nearest_hit_wavefront
    lo = [(box_ref[k] - o[k]) / d[k] for k in range(3)]
    hi = [(box_ref[3 + k] - o[k]) / d[k] for k in range(3)]
    near = [jnp.minimum(a, b) for a, b in zip(lo, hi)]
    far = [jnp.maximum(a, b) for a, b in zip(lo, hi)]
    t_near = jnp.maximum(jnp.maximum(near[0], near[1]), near[2])
    t_far = jnp.minimum(jnp.minimum(far[0], far[1]), far[2])

    level = jax.lax.broadcasted_iota(jnp.int32, (block, stack_size), 1)
    slot = jax.lax.broadcasted_iota(jnp.int32, (block, leaf_width), 1)
    zeros_i = jnp.zeros((block,), jnp.int32)
    everywhere = jnp.ones((block,), jnp.bool_)

    state = dict(
        node=zeros_i,
        leaf=_load(is_leaf_ref, zeros_i, everywhere, 0) != 0,
        entry=t_near,
        exit=t_far,
        sp=zeros_i,
        stack_node=jnp.zeros((block, stack_size), jnp.int32),
        stack_entry=jnp.zeros((block, stack_size), jnp.float32),
        stack_exit=jnp.zeros((block, stack_size), jnp.float32),
        best_t=jnp.full((block,), _INF, jnp.float32),
        best_i=jnp.full((block,), -1, jnp.int32),
        done=~((t_near <= t_far) & active),
    )

    def descending(s):
        return ~s["done"] & ~s["leaf"]

    def descend(s):
        m = descending(s)
        node = s["node"]
        axis = _load(axis_ref, node, m, 0)
        plane = _load(plane_ref, node, m, 0.0)
        c1 = _load(child_a_ref, node, m, 0)
        c2 = _load(child_b_ref, node, m, 0)
        o_ax, d_ax = _pick(axis, o), _pick(axis, d)
        behind = (o_ax > plane) | ((o_ax == plane) & (d_ax < 0.0))
        near_child = jnp.where(behind, c2, c1)
        far_child = jnp.where(behind, c1, c2)
        t_plane = (plane - o_ax) / d_ax
        near_only = (t_plane >= s["exit"]) | (t_plane < 0.0) | jnp.isnan(t_plane)
        far_only = (~near_only) & (t_plane <= s["entry"])
        push = m & (~near_only) & (~far_only)
        at_sp = (level == s["sp"][:, None]) & push[:, None]
        node = jnp.where(m, jnp.where(far_only, far_child, near_child), node)
        return dict(
            s,
            node=node,
            leaf=jnp.where(m, _load(is_leaf_ref, node, m, 0) != 0, s["leaf"]),
            exit=jnp.where(push, t_plane, s["exit"]),
            sp=jnp.where(push, jnp.minimum(s["sp"] + 1, depth - 1), s["sp"]),
            stack_node=jnp.where(at_sp, far_child[:, None], s["stack_node"]),
            stack_entry=jnp.where(at_sp, t_plane[:, None], s["stack_entry"]),
            stack_exit=jnp.where(at_sp, s["exit"][:, None], s["stack_exit"]),
        )

    def scan_row(c):
        s, chunk = c
        m = chunk >= 0
        row = jnp.maximum(chunk, 0)
        flat = row[:, None] * leaf_width + slot
        m2 = jnp.broadcast_to(m[:, None], flat.shape)
        tri = _load(chunk_tri_ref, flat, m2, -1)
        comp = [_load(chunk_data_ref, flat * 9 + k, m2, 0.0) for k in range(9)]
        ct, ci = _intersect_row(o, d, comp, tri, s["exit"], s["best_t"], t_eps)
        hit = m & (ci >= 0)
        s = dict(
            s,
            best_t=jnp.where(hit, ct, s["best_t"]),
            best_i=jnp.where(hit, ci, s["best_i"]),
        )
        return s, jnp.where(m, _load(chunk_next_ref, row, m, -1), chunk)

    def step(s):
        s = jax.lax.while_loop(lambda s: _any(descending(s)), descend, s)
        live = ~s["done"]
        chunk = jnp.where(live, _load(leaf_first_ref, s["node"], live, -1), -1)
        s, _ = jax.lax.while_loop(
            lambda c: _any(c[1] >= 0), scan_row, (s, chunk)
        )
        # leaf finished: a hit ends the walk, otherwise pop (trace_ray.cuh:264-267)
        found = live & (s["best_i"] >= 0)
        popping = live & ~found
        empty = s["sp"] == 0
        pop = popping & ~empty
        top = jnp.maximum(s["sp"] - 1, 0)
        at_top = level == top[:, None]
        node = jnp.where(
            pop, jnp.sum(jnp.where(at_top, s["stack_node"], 0), axis=1), s["node"]
        )
        return dict(
            s,
            node=node,
            leaf=jnp.where(pop, _load(is_leaf_ref, node, pop, 0) != 0, s["leaf"]),
            entry=jnp.where(
                pop, jnp.sum(jnp.where(at_top, s["stack_entry"], 0.0), axis=1),
                s["entry"],
            ),
            exit=jnp.where(
                pop, jnp.sum(jnp.where(at_top, s["stack_exit"], 0.0), axis=1),
                s["exit"],
            ),
            sp=jnp.where(popping, top, s["sp"]),
            done=s["done"] | found | (popping & empty),
        )

    final = jax.lax.while_loop(lambda s: _any(~s["done"]), step, state)
    hit = final["best_i"] >= 0
    t_ref[...] = jnp.where(hit, final["best_t"], _INF)
    i_ref[...] = final["best_i"]


def nearest_hit_kd_kernel(
    wkd: WavefrontKD,
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_eps: float = 1e-5,
    active=None,
    t_max=None,
    interpret: bool = False,
):
    """Batched nearest hit through the fused KD-walk kernel.

    o, d: (R, 3) -> (t, idx, hit), detached; the same contract and results
    as nearest_hit_wavefront. Rays are padded to a multiple of BLOCK with
    inactive lanes. `t_max` is accepted for interface parity and ignored,
    as nearest_hit_wavefront does. `interpret=True` runs the kernel through
    the Pallas interpreter (CPU tests); compiled, it needs a GPU.
    """
    del t_max
    # pallas_call has no differentiation rule; hit topology is detached anyway
    o, d = jax.lax.stop_gradient(o), jax.lax.stop_gradient(d)
    num_rays = o.shape[0]
    padded = -(-num_rays // BLOCK) * BLOCK
    act = jnp.ones((num_rays,), jnp.float32)
    if active is not None:
        act = jnp.asarray(active).astype(jnp.float32)
    rays = jnp.concatenate(
        [o.T, d.T, act[None], jnp.zeros((1, num_rays), jnp.float32)], axis=0
    )
    rays = jnp.pad(rays, ((0, 0), (0, padded - num_rays)), constant_values=0.0)
    box = jnp.concatenate(
        [wkd.bbox_min, wkd.bbox_max, jnp.zeros((2,), jnp.float32)]
    ).astype(jnp.float32)
    tables = (
        wkd.child_a,
        wkd.child_b,
        wkd.axis,
        wkd.plane,
        wkd.is_leaf.astype(jnp.int32),
        wkd.leaf_first,
        wkd.chunk_next,
        wkd.chunk_tri.reshape(-1),
        wkd.chunk_data.reshape(-1),
        box,
    )
    tables = tuple(jax.lax.stop_gradient(x) for x in tables)
    if wkd.chunk_data.size >= 2**31:
        raise ValueError("chunk_data too large for int32 offsets")

    depth = wkd.max_depth + 2
    kernel = functools.partial(
        _walk_kernel,
        depth=depth,
        stack_size=pl.next_power_of_2(depth),
        leaf_width=wkd.leaf_width,
        t_eps=t_eps,
    )
    whole = [pl.BlockSpec(x.shape, lambda i: (0,)) for x in tables]
    t, idx = pl.pallas_call(
        kernel,
        grid=(padded // BLOCK,),
        in_specs=[pl.BlockSpec((8, BLOCK), lambda i: (0, i)), *whole],
        out_specs=[
            pl.BlockSpec((BLOCK,), lambda i: (i,)),
            pl.BlockSpec((BLOCK,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((padded,), jnp.float32),
            jax.ShapeDtypeStruct((padded,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="kd_walk",
    )(rays, *tables)
    t, idx = t[:num_rays], idx[:num_rays]
    return t, idx, idx >= 0
