"""Measure the gradient-allreduce cost on the training step's critical path.

The north star claims the material/camera gradient all-reduce overlaps the
backward wavefront (dist/sharding.py psum placement). This probe measures
it directly: wall-clock of the full sharded train step (fwd wavefront +
bwd + psum over the mesh) vs the SAME computation with the cross-device
reduction removed (grads left per-device partial). The difference is the
collective time that XLA could NOT hide behind compute; ~0 means the
all-reduce is fully overlapped / off the critical path.

Runs on the 8-device virtual CPU mesh by default (the same harness the
sharding tests use); on a multi-GPU host the same script measures the
real collectives.

Usage: [XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu]
       python scripts/overlap_probe.py [--width 128] [--steps 10]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Default to the virtual CPU mesh; JAX_PLATFORMS=cuda runs on the GPUs.
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from isaklm_raytracer_tpu.camera import Camera
from isaklm_raytracer_tpu.config import RenderConfig
from isaklm_raytracer_tpu.dist import sharding as dsh
from isaklm_raytracer_tpu.integrator.render import render_sample
from isaklm_raytracer_tpu.scene.procedural import cornell_box


def build_vg(scene, config, mesh, with_psum: bool):
    """sharded_value_and_grad_fn with the cross-device psum optionally
    replaced by the identity (per-device partial grads)."""
    num_tile = mesh.shape["tile"]
    per_tile = -(-config.num_pixels // num_tile)
    total = per_tile * num_tile
    fields = ("albedo", "emittance", "roughness", "ior", "extinction",
              "transparent")

    def per_device(pixel_ids, valid, params, camera, target, key):
        pixel_ids, valid, target = pixel_ids[0], valid[0], target[0]

        def local_loss(floats):
            p = params.replace(**dict(zip(fields, floats)))
            s = scene.replace(materials=p)
            s_idx = jax.lax.axis_index("sample")
            radiance = render_sample(
                s, camera, jax.random.fold_in(key, s_idx), config,
                pixel_ids=pixel_ids,
            )
            err = jnp.where(valid[:, None], radiance - target, 0.0)
            return jnp.sum(err * err) / (3.0 * config.num_pixels)

        floats = tuple(getattr(params, f) for f in fields)
        loss, grads = jax.value_and_grad(local_loss)(floats)
        if with_psum:
            loss = jax.lax.psum(loss, ("tile", "sample"))
            grads = jax.tree.map(
                lambda g: jax.lax.psum(g, ("tile", "sample")), grads
            )
        return loss, grads

    shard = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("tile", None), P("tile", None), P(), P(),
                  P("tile", None, None), P()),
        out_specs=(P(), P()) if with_psum
        else (P(), tuple(P() for _ in fields)),
        check_vma=False,
    )

    ids = np.arange(total, dtype=np.int32)
    valid_np = ids < config.num_pixels
    ids = np.minimum(ids, config.num_pixels - 1)
    pixel_ids = jnp.asarray(ids.reshape(num_tile, per_tile))
    valid = jnp.asarray(valid_np.reshape(num_tile, per_tile))

    @jax.jit
    def vg(params, camera, target, key):
        pad = total - config.num_pixels
        t = jnp.pad(target, ((0, pad), (0, 0))).reshape(num_tile, per_tile, 3)
        return shard(pixel_ids, valid, params, camera, t, key)

    return vg


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()

    config = RenderConfig(width=args.width, height=args.width,
                          max_bounces=args.bounces, ray_chunk=0)
    scene = cornell_box(glossy=True)
    camera = Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2)
    mesh = dsh.make_render_mesh(num_tile=4, num_sample=2)
    key = jax.random.PRNGKey(0)
    target = render_sample(scene, camera, key, config)

    results = {}
    for label, with_psum in (("with_psum", True), ("no_psum", False)):
        vg = build_vg(scene, config, mesh, with_psum)
        out = vg(scene.materials, camera, target, key)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for i in range(args.steps):
            out = vg(scene.materials, camera, target,
                     jax.random.fold_in(key, i))
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.steps
        results[label] = dt
        print(f"{label}: {dt * 1e3:.2f} ms/step", flush=True)

    overhead = results["with_psum"] - results["no_psum"]
    frac = overhead / results["with_psum"]
    print(f"allreduce critical-path overhead: {overhead * 1e3:.2f} ms "
          f"({frac:+.1%} of the step) -- ~0 means fully overlapped")


if __name__ == "__main__":
    main()
