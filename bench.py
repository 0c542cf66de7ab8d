#!/usr/bin/env python
"""Benchmark: rays/sec/chip for the wavefront path tracer (BASELINE.md).

Prints ONE JSON line. The top-level fields are the DEFAULT preset (512x512,
660-tri textured scene -- BASELINE.json configs[2]); `--preset all` (the
plain invocation's default) additionally embeds a "hero" object (2M-tri
scene, configs[3]) and an "adaptive_1080p" object (the reference's native
resolution, macros.h:3-4, at a 95%-converged adaptive operating point) in
the SAME line, so every headline number lives in one artifact. Every
preset is gated by the compiled-kernel-vs-oracle check and carries
intersector and device provenance.

Definition: the wavefront integrator executes `max_bounces` bounce steps
per sample, each tracing one extension ray and one NEE shadow ray for every
pixel lane (masked lanes still traverse -- that IS the work the chip does),
so rays = pixels * spp * max_bounces * 2. The reference publishes no
numbers (SURVEY.md section 6). The JSON line names the device it ran on
(platform, device_kind, device count).

Usage: python bench.py [--preset all|quick|default|hero] [--json-only]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_bench(preset: str):
    import numpy as np

    from isaklm_raytracer_tpu.accel import prepare_scene
    from isaklm_raytracer_tpu.camera import Camera
    from isaklm_raytracer_tpu.config import RenderConfig
    from isaklm_raytracer_tpu.scene import procedural

    if preset == "quick":
        config = RenderConfig(width=256, height=256, max_bounces=6)
        scene = procedural.material_demo_scene()
        steps, warmup = 4, 1
    elif preset == "hero":
        # 2M-triangle scene (the reference hero size, README.md:12) at a
        # 640x360 window; the hero_1080p block measures the SAME scene at
        # configs[3]'s native 1920x1080. >= 4 timed steps with the per-step
        # spread recorded.
        config = RenderConfig(width=640, height=360, max_bounces=6)
        scene = procedural.hero_scene(2_000_000)
        steps, warmup = 4, 1
    else:
        config = RenderConfig(width=512, height=512, max_bounces=8)
        scene = procedural.material_demo_scene()
        steps, warmup = 8, 2

    scene = prepare_scene(scene)
    camera = Camera.create(position=(0.0, 1.2, -1.8), pitch=0.15, fov=3.14159 / 2)
    return scene, camera, config, steps, warmup


def verify_kernel(scene, config, num_rays: int, log) -> dict:
    """Compiled-path correctness gate: the EXACT intersector the bench
    times (make_trace_fn: the compiled KD-walk kernel on a GPU, never
    interpret mode) must agree with the brute-force oracle on random rays
    before any timing is recorded. Hard-fails the bench on mismatch.

    Tolerances: hit masks must match exactly; hit distances to 1e-3
    relative (f32 operation order and FMA contraction). Hit IDs may differ
    only where two triangles tie in t (coplanar duplicates)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from isaklm_raytracer_tpu.accel.traverse import nearest_hit_brute
    from isaklm_raytracer_tpu.integrator.render import make_trace_fn

    trace = jax.jit(make_trace_fn(scene, config))
    lo = np.asarray(scene.vertices).reshape(-1, 3).min(axis=0)
    hi = np.asarray(scene.vertices).reshape(-1, 3).max(axis=0)
    rng = np.random.default_rng(42)
    o = jnp.asarray(
        (rng.random((num_rays, 3)) * (hi - lo) + lo).astype(np.float32)
    )
    d_raw = rng.standard_normal((num_rays, 3)).astype(np.float32)
    d = jnp.asarray(d_raw / np.linalg.norm(d_raw, axis=1, keepdims=True))

    t_k, i_k, h_k = jax.block_until_ready(trace(o, d))
    t_b, i_b, h_b = jax.block_until_ready(
        jax.jit(nearest_hit_brute)(o, d, scene.vertices)
    )
    h_k, h_b = np.asarray(h_k), np.asarray(h_b)
    t_k, t_b = np.asarray(t_k), np.asarray(t_b)
    hit_mism = int((h_k != h_b).sum())
    both = h_k & h_b  # filter before subtracting: misses carry t=inf
    rel_dt = (
        float((np.abs(t_k[both] - t_b[both]) / np.maximum(t_b[both], 1e-3)).max())
        if both.any()
        else 0.0
    )
    id_mism = int((np.asarray(i_k)[both] != np.asarray(i_b)[both]).sum())
    log(f"kernel check: {num_rays} rays, hit mismatches={hit_mism}, "
        f"max rel dt={rel_dt:.2e}, id mismatches={id_mism} "
        f"(hit rate {h_b.mean():.2f})")
    if hit_mism or rel_dt > 1e-3:
        print(json.dumps({
            "metric": "kernel_check_failed", "value": 0, "unit": "bool",
            "hit_mismatches": hit_mism, "max_rel_dt": rel_dt,
        }))
        raise SystemExit(1)
    return {
        "kernel_check_rays": num_rays,
        "kernel_check_max_rel_dt": round(rel_dt, 8),
    }


def trace_provenance(scene, config) -> dict:
    """Which intersector/ordering and device the bench actually times."""
    import jax

    from isaklm_raytracer_tpu.integrator.render import make_trace_fn

    return {
        "intersector": make_trace_fn(scene, config).func.__name__,
        "ordering": "cluster_order",
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
    }


def run_preset(preset: str, log, no_check=False, no_bwd=False,
               stash: dict | None = None) -> dict:
    import jax
    import jax.numpy as jnp

    from isaklm_raytracer_tpu.integrator.render import render_sample

    scene, camera, config, steps, warmup = build_bench(preset)
    if stash is not None:
        # hand the prepared scene to follow-up blocks (hero_1080p reuses
        # the 2M-tri build instead of paying another ~90s host build)
        stash["scene"], stash["camera"] = scene, camera
    device = jax.devices()[0]
    log(f"bench: preset={preset} device={device.device_kind} "
        f"tris={scene.num_triangles} res={config.width}x{config.height} "
        f"bounces={config.max_bounces}")

    check_fields = {}
    if not no_check:
        # fewer check rays at hero scale: brute force is O(rays x tris)
        n_check = 256 if preset == "hero" else 2048
        check_fields = verify_kernel(scene, config, n_check, log)
    check_fields.update(trace_provenance(scene, config))

    # The scene is a jit ARGUMENT (not a closure constant): closed-over
    # arrays would be baked into the program as constants (~400MB of
    # geometry at hero scale).
    @jax.jit
    def fwd(scene_, key):
        return render_sample(scene_, camera, key, config)

    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    fwd(scene, key).block_until_ready()
    log(f"fwd compile: {time.perf_counter() - t0:.1f}s")

    for i in range(warmup):
        fwd(scene, jax.random.fold_in(key, i)).block_until_ready()
    step_times = []
    for i in range(steps):
        t0 = time.perf_counter()
        fwd(scene, jax.random.fold_in(key, 100 + i)).block_until_ready()
        step_times.append(time.perf_counter() - t0)
    fwd_time = sum(step_times) / steps

    rays_per_sample = config.num_pixels * config.max_bounces * 2
    fwd_rays = rays_per_sample / fwd_time

    result = {
        "metric": "rays/sec/chip (fwd)",
        "value": round(fwd_rays),
        "unit": "rays/s",
        "preset": preset,
        "triangles": scene.num_triangles,
        "resolution": f"{config.width}x{config.height}",
        "max_bounces": config.max_bounces,
        "fwd_ms_per_sample": round(fwd_time * 1e3, 2),
        # per-step wall clocks: makes chip drift visible in the artifact
        "fwd_step_times_ms": [round(t * 1e3, 1) for t in step_times],
        **check_fields,
    }

    if preset != "hero":
        # Adaptive compute-skipping (path_tracing.cuh:347-379 parity): step
        # wall-clock on a frame whose pixels are 90% converged, vs the full
        # uniform step. The compacted wavefront should approach the 10%-active
        # ideal rather than the round-1 behavior (zeroed but fully computed).
        import numpy as np

        from isaklm_raytracer_tpu.integrator.render import (
            compact_bucket,
            make_compact_step_fn,
        )
        from isaklm_raytracer_tpu.scene.types import GBuffer

        rng_np = np.random.default_rng(0)
        conv = rng_np.random(config.num_pixels) < 0.90
        counts = np.where(conv, config.max_samples, 0).astype(np.int32)
        gb = GBuffer(
            frame=jnp.zeros((config.num_pixels, 3), jnp.float32),
            sq_luminance=jnp.zeros((config.num_pixels,), jnp.float32),
            count=jnp.asarray(counts),
        )
        n_active = int((~conv).sum())
        bucket = compact_bucket(n_active, config.num_pixels, config.min_wavefront)
        cstep = make_compact_step_fn(config, bucket)
        gb = cstep(scene, camera, gb, key)  # compile + warmup (donates gb)
        jax.block_until_ready(gb)
        t0 = time.perf_counter()
        for i in range(steps):
            gb = cstep(scene, camera, gb, jax.random.fold_in(key, 300 + i))
        jax.block_until_ready(gb)
        adaptive_time = (time.perf_counter() - t0) / steps
        result["adaptive_90pct_ms_per_step"] = round(adaptive_time * 1e3, 2)
        result["adaptive_90pct_speedup"] = round(fwd_time / adaptive_time, 2)
        log(f"adaptive 90%-converged: {adaptive_time*1e3:.1f} ms/step "
            f"({fwd_time/adaptive_time:.1f}x vs full, ideal 10x; "
            f"bucket {bucket}/{config.num_pixels})")

    if not no_bwd:
        @jax.jit
        def fwd_bwd(scene_, albedo, key):
            def loss(a):
                s = scene_.replace(materials=scene_.materials.replace(albedo=a))
                return jnp.mean(render_sample(s, camera, key, config))
            return jax.grad(loss)(albedo)

        t0 = time.perf_counter()
        fwd_bwd(scene, scene.materials.albedo, key).block_until_ready()
        log(f"fwd+bwd compile: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        for i in range(max(steps // 2, 1)):
            fwd_bwd(scene, scene.materials.albedo, jax.random.fold_in(key, 200 + i)).block_until_ready()
        bwd_time = (time.perf_counter() - t0) / max(steps // 2, 1)
        result["fwd_bwd_ms_per_sample"] = round(bwd_time * 1e3, 2)
        result["rays_per_sec_fwd_bwd"] = round(rays_per_sample / bwd_time)

    return result


def run_adaptive_1080p(log) -> dict:
    """The reference's native operating point (1920x1080, macros.h:3-4) in
    its dominant tail phase: 95% of pixels converged, compacted adaptive
    wavefront vs the full uniform step (path_tracing.cuh:347-379 analog)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from isaklm_raytracer_tpu.accel import prepare_scene
    from isaklm_raytracer_tpu.camera import Camera
    from isaklm_raytracer_tpu.config import RenderConfig
    from isaklm_raytracer_tpu.integrator.render import (
        compact_bucket,
        make_step_fn,
    )
    from isaklm_raytracer_tpu.scene import procedural
    from isaklm_raytracer_tpu.scene.types import GBuffer

    config = RenderConfig(width=1920, height=1080, max_bounces=6)
    scene = prepare_scene(procedural.material_demo_scene())
    camera = Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=3.14159 / 2)
    key = jax.random.PRNGKey(0)

    from isaklm_raytracer_tpu.integrator.render import (
        make_candidates_fn,
        make_tail_step_fn,
    )

    rng_np = np.random.default_rng(0)
    conv = rng_np.random(config.num_pixels) < 0.95
    counts = np.where(conv, config.max_samples, 0).astype(np.int32)
    gb = GBuffer(
        frame=jnp.zeros((config.num_pixels, 3), jnp.float32),
        sq_luminance=jnp.zeros((config.num_pixels,), jnp.float32),
        count=jnp.asarray(counts),
    )
    n_active = int((~conv).sum())
    bucket = compact_bucket(n_active, config.num_pixels, config.min_wavefront)
    # production tail-mode step (candidates gathered once, O(bucket) steps)
    cand, _n = make_candidates_fn(config, bucket)(gb)
    tstep = make_tail_step_fn(config, bucket)
    gb, cand, _n = tstep(scene, camera, gb, cand, key)
    jax.block_until_ready(gb)
    steps = 3
    t0 = time.perf_counter()
    for i in range(steps):
        gb, cand, _n = tstep(scene, camera, gb, cand,
                             jax.random.fold_in(key, 300 + i))
    jax.block_until_ready(gb)
    adaptive_time = (time.perf_counter() - t0) / steps

    # full uniform step for the speedup denominator
    step = make_step_fn(config)
    gb2 = step(scene, camera, GBuffer.create(config.num_pixels), key, False)
    jax.block_until_ready(gb2)
    t0 = time.perf_counter()
    gb2 = step(scene, camera, gb2, jax.random.fold_in(key, 1), False)
    jax.block_until_ready(gb2)
    full_time = time.perf_counter() - t0

    out = {
        "resolution": "1920x1080",
        "converged_fraction": 0.95,
        "adaptive_ms_per_step": round(adaptive_time * 1e3, 2),
        "full_ms_per_step": round(full_time * 1e3, 2),
        "speedup": round(full_time / adaptive_time, 2),
        "ideal_speedup": round(config.num_pixels / bucket, 2),
        "bucket": bucket,
    }
    log(f"adaptive 1080p @95%: {adaptive_time*1e3:.1f} ms/step vs full "
        f"{full_time*1e3:.0f} ms ({out['speedup']}x, ideal {out['ideal_speedup']}x)")
    return out


def run_hero_1080p(log, scene, camera) -> dict:
    """configs[3] at its STATED operating point (BASELINE.json: '2M-triangle
    README hero scene ... 1080p @ 1000 spp'; macros.h:3-4): the 2M-tri
    scene at 1920x1080 -- uniform step ms/sample plus the 95%-converged
    adaptive tail step that dominates a 1000-spp render (the
    adaptive_1080p block uses the 660-tri demo scene). Reuses the hero
    preset's prepared scene, which the oracle gate already checked this
    run."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from isaklm_raytracer_tpu.config import RenderConfig
    from isaklm_raytracer_tpu.integrator.render import (
        compact_bucket,
        make_step_fn,
    )
    from isaklm_raytracer_tpu.scene.types import GBuffer

    config = RenderConfig(width=1920, height=1080, max_bounces=6)
    key = jax.random.PRNGKey(0)
    rays_per_sample = config.num_pixels * config.max_bounces * 2

    step = make_step_fn(config)
    t0 = time.perf_counter()
    gb = step(scene, camera, GBuffer.create(config.num_pixels), key, False)
    jax.block_until_ready(gb)
    log(f"hero 1080p uniform compile+step: {time.perf_counter() - t0:.1f}s")
    times = []
    for i in range(2):
        t0 = time.perf_counter()
        gb = step(scene, camera, gb, jax.random.fold_in(key, 1 + i), False)
        jax.block_until_ready(gb)
        times.append(time.perf_counter() - t0)
    full_time = sum(times) / len(times)

    # 95%-converged adaptive tail step (the dominant phase at 1000 spp),
    # measured through the PRODUCTION tail-mode machinery (candidate set
    # gathered once, then O(bucket) steps -- integrator.render.render's
    # loop), not the one-off compact entry step.
    from isaklm_raytracer_tpu.integrator.render import (
        make_candidates_fn,
        make_tail_step_fn,
    )

    rng_np = np.random.default_rng(0)
    conv = rng_np.random(config.num_pixels) < 0.95
    counts = np.where(conv, config.max_samples, 0).astype(np.int32)
    gb = GBuffer(
        frame=jnp.zeros((config.num_pixels, 3), jnp.float32),
        sq_luminance=jnp.zeros((config.num_pixels,), jnp.float32),
        count=jnp.asarray(counts),
    )
    n_active = int((~conv).sum())
    bucket = compact_bucket(n_active, config.num_pixels, config.min_wavefront)
    cand, _n = make_candidates_fn(config, bucket)(gb)
    tstep = make_tail_step_fn(config, bucket)
    gb, cand, _n = tstep(scene, camera, gb, cand, key)
    jax.block_until_ready(gb)
    atimes = []
    for i in range(3):
        t0 = time.perf_counter()
        gb, cand, _n = tstep(scene, camera, gb, cand,
                             jax.random.fold_in(key, 300 + i))
        jax.block_until_ready(gb)
        atimes.append(time.perf_counter() - t0)
    adaptive_time = sorted(atimes)[1]

    out = {
        "resolution": "1920x1080",
        "triangles": scene.num_triangles,
        "max_bounces": config.max_bounces,
        "fwd_ms_per_sample": round(full_time * 1e3, 1),
        "fwd_step_times_ms": [round(t * 1e3, 1) for t in times],
        "rays_per_sec_fwd": round(rays_per_sample / full_time),
        "converged_fraction": 0.95,
        "adaptive_ms_per_step": round(adaptive_time * 1e3, 1),
        "adaptive_speedup": round(full_time / adaptive_time, 2),
        "ideal_speedup": round(config.num_pixels / bucket, 2),
        "bucket": bucket,
        "oracle_gate": "hero preset (same scene + intersector, this run)",
    }
    log(f"hero 1080p: {full_time:.2f} s/sample uniform "
        f"({rays_per_sample / full_time / 1e6:.2f} M rays/s); adaptive tail "
        f"{adaptive_time * 1e3:.0f} ms/step ({out['adaptive_speedup']}x of "
        f"ideal {out['ideal_speedup']}x)")
    return out


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--preset", default="all", choices=["all", "quick", "default", "hero"]
    )
    parser.add_argument("--json-only", action="store_true")
    parser.add_argument("--no-bwd", action="store_true")
    parser.add_argument("--no-check", action="store_true",
                        help="skip the compiled-kernel-vs-oracle gate")
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="capture a jax.profiler device trace of the "
                             "run into DIR (perfetto export)")
    args = parser.parse_args()

    from isaklm_raytracer_tpu import compile_cache

    compile_cache.enable()

    log = (lambda *a: None) if args.json_only else (
        lambda *a: print(*a, file=sys.stderr)
    )

    import contextlib

    if args.trace:
        import jax

        trace_cm = jax.profiler.trace(args.trace, create_perfetto_trace=True)
    else:
        trace_cm = contextlib.nullcontext()

    with trace_cm:
        _run(args, log)


def _run(args, log) -> None:
    if args.preset != "all":
        result = run_preset(
            args.preset, log, no_check=args.no_check, no_bwd=args.no_bwd
        )
    else:
        result = run_preset(
            "default", log, no_check=args.no_check, no_bwd=args.no_bwd
        )
        hero_keep = (
            "value", "triangles", "resolution", "max_bounces",
            "fwd_ms_per_sample", "fwd_step_times_ms", "kernel_check_rays",
            "kernel_check_max_rel_dt", "intersector", "ordering",
            "fwd_bwd_ms_per_sample", "rays_per_sec_fwd_bwd",
        )
        stash = {}
        try:
            hero = run_preset(
                "hero", log, no_check=args.no_check, no_bwd=args.no_bwd,
                stash=stash,
            )
            result["hero"] = {
                ("rays_per_sec_fwd" if k == "value" else k): hero[k]
                for k in hero_keep if k in hero
            }
            # configs[3] at its stated 1920x1080 operating point, on the
            # hero scene prepared above
            result["hero_1080p"] = run_hero_1080p(
                log, stash["scene"], stash["camera"]
            )
            result["adaptive_1080p"] = run_adaptive_1080p(log)
        except Exception as e:
            # the partial result is printed, then the failure ends the run
            result["error"] = repr(e)[:300]
            print(json.dumps(result))
            raise

    print(json.dumps(result))


if __name__ == "__main__":
    main()
