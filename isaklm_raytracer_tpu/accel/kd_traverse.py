"""KD-tree traversal in pure JAX (XLA), vmapped over rays.

Re-derivation of the reference's iterative short-stack walk
(trace_ray.cuh:244-318) as a single flattened state machine under
`lax.while_loop` -- one loop interleaving inner-node descent, leaf testing
and stack pops, so vmapped rays stay in lock-step (XLA runs the combined
loop until every lane finishes; masked lanes idle).

Semantics preserved:
  - root bbox slab test, IEEE inf-safe divides (trace_ray.cuh:212-242);
  - near/far child chosen by ray ORIGIN vs plane (ray_behind_plane,
    trace_ray.cuh:174-188: position >= plane -> child2 is near);
  - plane-hit classification: t >= exit or t < 0 -> near only; t <= entry
    -> far only; else push far, descend near with exit = t
    (trace_ray.cuh:273-306);
  - leaf scan against exit_distance so the first accepted leaf hit is
    globally nearest despite duplicated straddlers (trace_ray.cuh:121,133);
    traversal RETURNS at the first leaf with a hit (trace_ray.cuh:308-314);
  - fixed stack of `max_depth` entries (trace_ray.cuh:246-248).

Outputs are detached (int topology); differentiable shading reconstruction
happens in `hit_attributes`. The GPU kernel (accel/kd_kernel.py) and the
batched XLA walk (accel/wavefront.py) are the performance paths; this is
the per-ray reference walk they are tested against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from isaklm_raytracer_tpu.scene.types import KDTreeArrays

_INF = jnp.float32(jnp.inf)


def _leaf_scan(vertices, tri_indices, o, d, index_offset, count, max_t, t_eps):
    """Nearest hit among one leaf's triangles, scalar ray
    (trace_leaf_node, trace_ray.cuh:115-141). Returns (t, idx)."""

    def body(i, carry):
        best_t, best_i = carry
        tri_idx = tri_indices[index_offset + i]
        tri = vertices[tri_idx]
        p1, p2, p3 = tri[0], tri[1], tri[2]

        geo_n = jnp.cross(p2 - p1, p3 - p1)
        geo_n = geo_n * jax.lax.rsqrt(jnp.maximum(jnp.dot(geo_n, geo_n), 1e-30))
        ddn = jnp.dot(d, geo_n)
        s = (jnp.dot(geo_n, p1) - jnp.dot(o, geo_n)) / ddn

        point = o + s * d
        v0 = p2 - p1
        v1 = p3 - p1
        v2 = point - p1
        d00 = jnp.dot(v0, v0)
        d01 = jnp.dot(v0, v1)
        d11 = jnp.dot(v1, v1)
        d20 = jnp.dot(v2, v0)
        d21 = jnp.dot(v2, v1)
        inv_den = 1.0 / (d00 * d11 - d01 * d01)
        b = (d11 * d20 - d01 * d21) * inv_den
        c = (d00 * d21 - d01 * d20) * inv_den
        a = 1.0 - b - c
        inside = (
            (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0) & (c >= 0.0) & (c <= 1.0)
        )

        valid = (ddn != 0.0) & (s >= t_eps) & inside & (s < best_t)
        best_i = jnp.where(valid, tri_idx, best_i)
        best_t = jnp.where(valid, s, best_t)
        return best_t, best_i

    return jax.lax.fori_loop(0, count, body, (max_t, jnp.int32(-1)))


def _traverse_one(kd: KDTreeArrays, vertices, t_eps, o, d):
    """Scalar-ray traversal; vmapped by nearest_hit_kd."""
    # Root bbox slab test (trace_ray.cuh:212-242); IEEE infs handle
    # zero-direction components exactly like CUDA.
    t_lo = (kd.bbox_min - o) / d
    t_hi = (kd.bbox_max - o) / d
    t_near = jnp.max(jnp.minimum(t_lo, t_hi))
    t_far = jnp.min(jnp.maximum(t_lo, t_hi))
    hit_box = t_near <= t_far

    # The reference allocates KD_TREE_DEPTH stack slots (trace_ray.cuh:246);
    # a worst-case root-to-leaf descent can push one far-cell per inner level
    # (up to max_depth + 1 of them), so allocate +2 to stay in bounds where
    # the CUDA version would silently overrun.
    depth = kd.max_depth + 2
    stack_node = jnp.zeros((depth,), jnp.int32)
    stack_entry = jnp.zeros((depth,), jnp.float32)
    stack_exit = jnp.zeros((depth,), jnp.float32)

    # state: (phase-free machine)
    #   node: current node index; entry/exit: current cell interval
    #   sp: stack pointer; done: terminal flag; best_t/best_i: result
    state = dict(
        node=jnp.int32(0),
        entry=t_near,
        exit=t_far,
        sp=jnp.int32(0),
        stack_node=stack_node,
        stack_entry=stack_entry,
        stack_exit=stack_exit,
        done=~hit_box,
        best_t=_INF,
        best_i=jnp.int32(-1),
    )

    def cond(s):
        return ~s["done"]

    def step(s):
        node = s["node"]
        leaf = kd.is_leaf[node]

        # ---- inner-node descent step (trace_ray.cuh:273-306)
        axis = kd.axis[node]
        plane = kd.plane[node]
        c1 = kd.child_a[node]
        c2 = kd.child_b[node]
        # ray_behind_plane (trace_ray.cuh:174-188) uses o >= plane; for an
        # origin EXACTLY on the plane that misassigns the near child when the
        # ray departs toward the other side (interval [entry, t=0] goes to
        # the wrong child and real hits get culled by the exit clamp).
        # Disambiguate by direction on the boundary -- identical off it.
        behind = (o[axis] > plane) | ((o[axis] == plane) & (d[axis] < 0.0))
        near = jnp.where(behind, c2, c1)
        far = jnp.where(behind, c1, c2)
        t_plane = (plane - o[axis]) / d[axis]

        # NaN t_plane (ray lying exactly IN the splitting plane: 0/0 in
        # intersect_plane, trace_ray.cuh:190-210) poisons the reference's
        # comparisons; we resolve it as near-only, which is exact because
        # plane-straddling triangles are duplicated into both children.
        near_only = (t_plane >= s["exit"]) | (t_plane < 0.0) | jnp.isnan(t_plane)
        # The reference checks the near-only case FIRST (trace_ray.cuh:288):
        # a negative t that is also <= entry must take the near child.
        far_only = (~near_only) & (t_plane <= s["entry"])
        push = (~near_only) & (~far_only)

        # push far cell when straddling
        sp = s["sp"]
        stack_node = jnp.where(
            push, s["stack_node"].at[sp].set(far), s["stack_node"]
        )
        stack_entry = jnp.where(
            push, s["stack_entry"].at[sp].set(t_plane), s["stack_entry"]
        )
        stack_exit = jnp.where(
            push, s["stack_exit"].at[sp].set(s["exit"]), s["stack_exit"]
        )
        inner_sp = jnp.where(push, sp + 1, sp)
        inner_node = jnp.where(far_only, far, near)
        inner_exit = jnp.where(push, t_plane, s["exit"])

        # ---- leaf step (trace_ray.cuh:308-314): scan, then return-or-pop.
        # No lax.cond here: under vmap a batched-predicate cond would
        # broadcast the closed-over vertex array per ray; instead the scan
        # runs unconditionally with a zero trip count on inner nodes.
        count = jnp.where(leaf, kd.child_b[node], 0)
        offset = kd.child_a[node]
        leaf_t, leaf_i = _leaf_scan(
            vertices, kd.tri_indices, o, d, offset, count, s["exit"], t_eps
        )
        leaf_hit = leaf_i >= 0

        stack_empty = s["sp"] == 0
        pop_sp = jnp.maximum(s["sp"] - 1, 0)
        popped_node = s["stack_node"][pop_sp]
        popped_entry = s["stack_entry"][pop_sp]
        popped_exit = s["stack_exit"][pop_sp]

        # ---- merge the two phases
        new = dict(s)
        new["node"] = jnp.where(leaf, jnp.where(leaf_hit, node, popped_node), inner_node)
        new["entry"] = jnp.where(leaf, popped_entry, s["entry"])
        new["exit"] = jnp.where(leaf, jnp.where(leaf_hit, s["exit"], popped_exit), inner_exit)
        new["sp"] = jnp.where(leaf, pop_sp, inner_sp)
        new["stack_node"] = jnp.where(leaf, s["stack_node"], stack_node)
        new["stack_entry"] = jnp.where(leaf, s["stack_entry"], stack_entry)
        new["stack_exit"] = jnp.where(leaf, s["stack_exit"], stack_exit)
        new["best_t"] = jnp.where(leaf & leaf_hit, leaf_t, s["best_t"])
        new["best_i"] = jnp.where(leaf & leaf_hit, leaf_i, s["best_i"])
        new["done"] = s["done"] | (leaf & (leaf_hit | stack_empty))
        return new

    final = jax.lax.while_loop(cond, step, state)
    hit = final["best_i"] >= 0
    t = jnp.where(hit, final["best_t"], _INF)
    return t, final["best_i"], hit


def nearest_hit_kd(
    kd: KDTreeArrays,
    vertices: jnp.ndarray,
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_eps: float = 1e-5,
    active=None,
    t_max=None,
):
    """Batched nearest-hit via KD traversal.

    o, d: (R, 3). Returns (t (R,), idx (R,) int32, hit (R,) bool), detached.
    `active` masks lanes to an immediate miss.
    
    `t_max` is accepted for interface parity with the other intersectors
    (a search-window performance hint, integrator/nee.py) and ignored here;
    visibility results are identical either way.
    """
    # asarray: vertices may be host numpy on an unprepared scene
    # (scene.types.build_scene defers the device transfer).
    t, idx, hit = jax.vmap(
        functools.partial(_traverse_one, kd, jnp.asarray(vertices), t_eps)
    )(o, d)
    if active is not None:
        hit = hit & active
        idx = jnp.where(active, idx, -1)
        t = jnp.where(active, t, jnp.inf)
    return (
        jax.lax.stop_gradient(t),
        jax.lax.stop_gradient(idx),
        jax.lax.stop_gradient(hit),
    )
