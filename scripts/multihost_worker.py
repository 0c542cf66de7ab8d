"""Multi-host worker: one process of a 2-process CPU 'pod'.

Exercises the REAL multi-host path (SURVEY.md section 4 'distributed tests
without a cluster'): jax.distributed.initialize over a localhost
coordinator, a global ("tile", "sample") mesh spanning both processes'
virtual CPU devices, cross-process collectives (the sample-axis pmean and
the train step's full-mesh gradient psum ride the gloo CPU transport that
stands in for the interconnect), and a process_allgather of the sharded image.

Launched by tests/test_multihost.py as:
  python scripts/multihost_worker.py <process_id> <num_processes> <port> <out.json>

Writes {"ok": bool, "max_abs_err": float, ...} to out.json (process 0).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    pid, nprocs, port, out_path = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=pid,
    )

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    from isaklm_raytracer_tpu.camera import Camera
    from isaklm_raytracer_tpu.config import RenderConfig
    from isaklm_raytracer_tpu.dist.sharding import (
        make_render_mesh,
        sharded_render_fn,
        sharded_train_step_fn,
    )
    from isaklm_raytracer_tpu.integrator.render import render_sample
    from isaklm_raytracer_tpu.scene.procedural import cornell_box

    assert jax.process_count() == nprocs
    assert len(jax.devices()) == 4 * nprocs  # global devices
    assert len(jax.local_devices()) == 4

    config = RenderConfig(width=16, height=16, max_bounces=4)
    scene = cornell_box(include_blockers=False)
    camera = Camera.create((0.0, 0.0, -0.9), fov=jnp.pi / 2)
    key = jax.random.PRNGKey(3)

    # tile axis spans PROCESSES (tile-major device order), so the pixel
    # shards and their psum cross the host boundary.
    num_sample = 2
    mesh = make_render_mesh(num_tile=4, num_sample=num_sample)
    run, _ = sharded_render_fn(scene, config, mesh)
    radiance = run(camera, key)
    img = np.asarray(multihost_utils.process_allgather(radiance, tiled=True))

    # single-process oracle: same keys, same sample-stream average
    want = np.mean(
        [
            np.asarray(
                render_sample(scene, camera, jax.random.fold_in(key, s), config)
            )
            for s in range(num_sample)
        ],
        axis=0,
    )
    err = float(np.abs(img - want).max())

    # one cross-process train step: full-mesh gradient psum + SGD update
    target = render_sample(scene, camera, jax.random.fold_in(key, 9), config)
    step = sharded_train_step_fn(scene, config, mesh, learning_rate=0.1)
    params, loss = step(scene.materials, camera, target, jax.random.fold_in(key, 1))
    loss = float(loss)
    albedo_finite = bool(np.isfinite(np.asarray(params.albedo)).all())

    # PRODUCT multi-chip path across the host boundary: the sharded
    # progressive loop (adaptive, per-device compaction) on a pure tile
    # mesh must equal the single-process render() bit-for-bit.
    from isaklm_raytracer_tpu.dist.sharding import (
        render_sharded,
        unshard_gbuffer,
    )
    from isaklm_raytracer_tpu.integrator.render import render

    pconfig = RenderConfig(
        width=16, height=16, max_bounces=3, min_samples=1, max_samples=8,
        max_tolerance=0.5, min_wavefront=8,
    )
    tile_mesh = make_render_mesh(num_tile=4 * nprocs, num_sample=1)
    gb = render_sharded(
        scene, camera, pconfig, num_samples=4, mesh=tile_mesh, seed=2,
        adaptive=True,
    )
    gb = unshard_gbuffer(gb, pconfig)
    gb_ref = render(scene, camera, pconfig, num_samples=4, seed=2,
                    adaptive=True)
    prog_err = float(
        np.abs(np.asarray(gb.frame) - np.asarray(gb_ref.frame)).max()
    )
    prog_counts_equal = bool(
        (np.asarray(gb.count) == np.asarray(gb_ref.count)).all()
    )

    ok = (err < 2e-5 and np.isfinite(loss) and albedo_finite
          and prog_err == 0.0 and prog_counts_equal)
    if pid == 0:
        with open(out_path, "w") as f:
            json.dump(
                {
                    "ok": ok,
                    "max_abs_err": err,
                    "loss": loss,
                    "albedo_finite": albedo_finite,
                    "progressive_max_abs_err": prog_err,
                    "progressive_counts_equal": prog_counts_equal,
                    "process_count": jax.process_count(),
                    "global_devices": len(jax.devices()),
                },
                f,
            )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
