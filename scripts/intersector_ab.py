#!/usr/bin/env python
"""Time render_sample with the fused KD-walk kernel against the XLA KD walk.

    python scripts/intersector_ab.py [--cells demo,hero] [--chunks 16384,0]
        [--intersectors kernel,xla] [--steps 3] [--no-bwd] [--budget 120]

For every cell x intersector x ray_chunk: compile time, then the median of
`--steps` timed steps of the forward sample and of forward+backward (the
gradient of the mean radiance w.r.t. albedo, as bench.py's fwd_bwd). A
configuration whose first forward step takes longer than `--budget`
seconds is recorded and not timed further, and the chunks after it (in
the order given) are skipped for that intersector. Cells:
  demo: 660-triangle material demo, 512x512, 8 bounces
  hero: 2M-triangle hero scene, 1920x1080, 6 bounces
Each result is one JSON line on stdout and in chiprun_out/intersector_ab.jsonl,
with the card's name and power limit. Needs a GPU for the kernel.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CELLS = {
    "demo": dict(width=512, height=512, max_bounces=8),
    "hero": dict(width=1920, height=1080, max_bounces=6),
}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default="demo,hero")
    p.add_argument("--chunks", default="16384,65536,262144,0")
    p.add_argument("--intersectors", default="kernel,xla")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--no-bwd", action="store_true")
    p.add_argument("--budget", type=float, default=120.0)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from isaklm_raytracer_tpu import compile_cache
    from isaklm_raytracer_tpu.accel import nearest_hit_wavefront, prepare_scene
    from isaklm_raytracer_tpu.accel.kd_kernel import nearest_hit_kd_kernel
    from isaklm_raytracer_tpu.camera import Camera
    from isaklm_raytracer_tpu.config import RenderConfig
    from isaklm_raytracer_tpu.integrator.render import render_sample
    from isaklm_raytracer_tpu.scene import procedural

    compile_cache.enable()
    dev = jax.devices()[0]
    where = card()
    os.makedirs("chiprun_out", exist_ok=True)
    out = open(os.path.join("chiprun_out", "intersector_ab.jsonl"), "a")
    fns = {"kernel": nearest_hit_kd_kernel, "xla": nearest_hit_wavefront}
    camera = Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=3.14159 / 2)

    for cell in args.cells.split(","):
        t0 = time.perf_counter()
        scene = prepare_scene(
            procedural.hero_scene(2_000_000) if cell == "hero"
            else procedural.material_demo_scene()
        )
        print(f"{cell}: {scene.num_triangles} tris, prepared in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
        for name in args.intersectors.split(","):
            fn = fns[name]
            too_slow = False
            for chunk in [int(c) for c in args.chunks.split(",")]:
                if too_slow:
                    continue
                config = RenderConfig(**CELLS[cell], ray_chunk=chunk)

                def trace(scene_, config=config):
                    return functools.partial(fn, scene_.wkd,
                                             t_eps=config.t_epsilon)

                @jax.jit
                def fwd(scene_, key, config=config, trace=trace):
                    return render_sample(scene_, camera, key, config,
                                         trace_fn=trace(scene_))

                @jax.jit
                def fwd_bwd(scene_, albedo, key, config=config, trace=trace):
                    def loss(a):
                        s = scene_.replace(
                            materials=scene_.materials.replace(albedo=a))
                        return jnp.mean(render_sample(
                            s, camera, key, config, trace_fn=trace(s)))
                    return jax.grad(loss)(albedo)

                rec = dict(cell=cell, intersector=name, ray_chunk=chunk,
                           card=where, device=dev.device_kind,
                           platform=dev.platform, **CELLS[cell])
                key = jax.random.PRNGKey(0)
                t0 = time.perf_counter()
                fwd(scene, key).block_until_ready()
                first = time.perf_counter() - t0
                rec["fwd_compile_plus_first_s"] = first
                if first > args.budget:
                    rec["skipped"] = "first step over budget"
                    too_slow = True
                else:
                    keys = [jax.random.fold_in(key, i + 1) for i in range(args.steps)]
                    times = []
                    for k in keys:
                        t0 = time.perf_counter()
                        fwd(scene, k).block_until_ready()
                        times.append(time.perf_counter() - t0)
                    rec["fwd_ms"] = [t * 1e3 for t in times]
                    rec["fwd_ms_median"] = statistics.median(times) * 1e3
                    if not args.no_bwd:
                        alb = scene.materials.albedo
                        t0 = time.perf_counter()
                        fwd_bwd(scene, alb, key).block_until_ready()
                        rec["bwd_compile_plus_first_s"] = time.perf_counter() - t0
                        times = []
                        for k in keys:
                            t0 = time.perf_counter()
                            fwd_bwd(scene, alb, k).block_until_ready()
                            times.append(time.perf_counter() - t0)
                        rec["fwd_bwd_ms"] = [t * 1e3 for t in times]
                        rec["fwd_bwd_ms_median"] = statistics.median(times) * 1e3
                line = json.dumps(rec)
                print(line, flush=True)
                out.write(line + "\n")
                out.flush()
                jax.clear_caches()
    out.close()


if __name__ == "__main__":
    main()
