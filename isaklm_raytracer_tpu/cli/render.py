"""Render entrypoint: the reference's main loop (main.cu:62-160), headless.

Usage:
  python -m isaklm_raytracer_tpu.cli.render --scene cornell --width 512 \
      --height 512 --max-samples 256 --out renders/render.png

Scenes: procedural presets (cornell / demo / hero) or a JSON manifest that
replaces the reference's hardcoded create_models.cuh:17-43:

  [{"obj": "models/room.obj", "mat": "materials/room.mat",
    "offset": [0, 1.5, 0], "yaw": 0.1, "pitch": 0, "roll": 0,
    "scale": 1.0, "smooth_normals": false}, ...]

Everything the reference pins at compile time (macros.h) is a flag here.
Structured progress (spp, rays/s, convergence fraction -- cf. the stdout
prints at main.cu:141-154, create_scene.cuh:37,66) goes to stderr; optional
checkpointing makes long renders resumable (the reference loses all state
on exit, SURVEY.md section 5).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from isaklm_raytracer_tpu.config import RenderConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="cornell",
                   help="cornell | demo | hero | path to JSON scene manifest")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--min-samples", type=int, default=100)
    p.add_argument("--max-samples", type=int, default=5000)
    p.add_argument("--max-tolerance", type=float, default=0.05)
    p.add_argument("--max-bounces", type=int, default=24)
    p.add_argument("--kd-depth", type=int, default=19)
    p.add_argument("--kd-leaf", type=int, default=7)
    p.add_argument("--ray-chunk", type=int, default=RenderConfig.ray_chunk,
                   help="rays per inner launch; 0 = the whole image at once")
    p.add_argument("--no-adaptive", action="store_true")
    p.add_argument("--no-kd", action="store_true")
    p.add_argument("--camera", type=float, nargs=5,
                   metavar=("X", "Y", "Z", "YAW", "PITCH"),
                   default=[-2.1, 1.7, -1.2, 0.975, 0.3],
                   help="initial pose (default: the reference's, main.cu:101-104)")
    p.add_argument("--fov", type=float, default=1.5707963)
    p.add_argument("--aperture", type=float, default=0.002)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="renders/render.png")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path; resumes if it exists")
    p.add_argument("--checkpoint-every", type=int, default=64)
    p.add_argument("--devices", default="auto",
                   help="'auto' = shard the render over all devices (mesh "
                        "('tile',) over pixels); N = use the first N; "
                        "'1' = single-device loop")
    p.add_argument("--multihost", action="store_true",
                   help="call jax.distributed.initialize() first")
    p.add_argument("--preview", action="store_true",
                   help="progressive terminal preview with interactive camera "
                        "(the reference's GLFW window loop, main.cu:114-155)")
    return p.parse_args(argv)


def load_scene(args):
    import numpy as np

    from isaklm_raytracer_tpu.accel import prepare_scene
    from isaklm_raytracer_tpu.scene import procedural
    from isaklm_raytracer_tpu.scene.obj import (
        Transformation,
        create_scene_from_files,
    )

    if args.scene == "cornell":
        scene = procedural.cornell_box(glossy=True)
    elif args.scene == "demo":
        scene = procedural.material_demo_scene()
    elif args.scene == "hero":
        scene = procedural.hero_scene()
    else:
        from isaklm_raytracer_tpu.math import transforms

        with open(args.scene) as f:
            manifest = json.load(f)
        meshes = []
        for entry in manifest:
            rot = np.asarray(
                transforms.rotation_matrix(
                    entry.get("yaw", 0.0),
                    entry.get("pitch", 0.0),
                    entry.get("roll", 0.0),
                ),
                np.float32,
            ) * entry.get("scale", 1.0)
            meshes.append(
                (
                    entry["obj"],
                    entry.get("mat", ""),
                    Transformation(
                        np.asarray(entry.get("offset", [0, 0, 0]), np.float32), rot
                    ),
                    entry.get("smooth_normals", False),
                )
            )
        return create_scene_from_files(
            meshes, build_kd=not args.no_kd, kd_depth=args.kd_depth,
            kd_leaf=args.kd_leaf,
        )
    if not args.no_kd:
        scene = prepare_scene(scene, args.kd_depth, args.kd_leaf)
    return scene


def main(argv=None) -> int:
    args = parse_args(argv)

    # Honor JAX_PLATFORMS even when something imported jax earlier and set
    # jax_platforms via config (config beats the env var, so e.g. a test's
    # JAX_PLATFORMS=cpu would silently run on the accelerator). A config
    # update is still valid until backends initialize.
    import os

    from isaklm_raytracer_tpu import compile_cache

    if os.environ.get("JAX_PLATFORMS"):
        import jax

        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    compile_cache.enable()

    if args.multihost:
        import jax

        jax.distributed.initialize()

    import jax
    import numpy as np

    from isaklm_raytracer_tpu.camera import Camera
    from isaklm_raytracer_tpu.integrator.render import (
        render,
        resolve_image,
    )
    from isaklm_raytracer_tpu.io.checkpoint import load_checkpoint, save_checkpoint
    from isaklm_raytracer_tpu.io.png import save_png
    from isaklm_raytracer_tpu.scene.types import GBuffer

    config = RenderConfig(
        width=args.width,
        height=args.height,
        min_samples=args.min_samples,
        max_samples=args.max_samples,
        max_tolerance=args.max_tolerance,
        max_bounces=args.max_bounces,
        kd_tree_depth=args.kd_depth,
        kd_leaf_size=args.kd_leaf,
        ray_chunk=args.ray_chunk,
    )

    t0 = time.time()
    scene = load_scene(args)
    print(
        f"triangle count: {scene.num_triangles}\n"
        f"light count: {scene.num_lights if scene.has_lights else 0}\n"
        f"scene build: {time.time() - t0:.1f}s",
        file=sys.stderr,
    )

    x, y, z, yaw, pitch = args.camera
    camera = Camera.create((x, y, z), yaw, pitch, args.fov, args.aperture)

    if args.preview:
        from isaklm_raytracer_tpu.cli.preview import run_preview
        from isaklm_raytracer_tpu.viewer import InteractiveSession

        session = InteractiveSession(
            scene, camera, config, seed=args.seed,
            adaptive=not args.no_adaptive,
        )
        image = run_preview(session, max_samples=args.max_samples)
        save_png(args.out, image)
        print(f"wrote {args.out}", file=sys.stderr)
        return 0

    # Multi-chip product path (BASELINE.json configs[4]): shard the render
    # over a ("tile",) mesh of pixels; bit-identical to the single-device
    # loop (dist.sharding.render_sharded, pinned by tests/test_sharding.py).
    mesh = None
    n_req = len(jax.devices()) if args.devices == "auto" else int(args.devices)
    if n_req > 1:
        from isaklm_raytracer_tpu.dist.sharding import (
            make_render_mesh,
            render_sharded,
            unshard_gbuffer,
        )

        mesh = make_render_mesh(
            num_tile=n_req, num_sample=1, devices=jax.devices()[:n_req]
        )
        print(f"mesh: {n_req} device(s) on 'tile'", file=sys.stderr)

    gbuffer = None
    start_sample = 0
    if args.checkpoint:
        try:
            gbuffer, camera, _, start_sample = load_checkpoint(args.checkpoint)
            print(f"resumed at sample {start_sample}", file=sys.stderr)
        except FileNotFoundError:
            pass
    if gbuffer is None:
        gbuffer = GBuffer.create(config.num_pixels)

    # is_sharded tracks the G-buffer's layout EXPLICITLY (a shape test is
    # fragile: when num_pixels divides the tile count the padded total
    # equals num_pixels and a sharded array would masquerade as plain).
    is_sharded = False

    def plain(gb):
        """Gather a (possibly tile-sharded) G-buffer to (num_pixels,).

        COLLECTIVE under multi-host (process_allgather): every process
        must call it, so callers gather BEFORE any process_index() guard.
        """
        if is_sharded:
            return unshard_gbuffer(gb, config)
        return gb

    adaptive = not args.no_adaptive
    rays_per_sample = config.num_pixels * config.max_bounces * 2
    sample = start_sample
    retries_left = 2
    while sample < args.max_samples:
        batch = min(args.checkpoint_every, args.max_samples - sample)
        t0 = time.time()
        try:
            if mesh is not None:
                gbuffer = render_sharded(
                    scene, camera, config, num_samples=batch, mesh=mesh,
                    seed=args.seed, adaptive=adaptive, gbuffer=gbuffer,
                    sample_offset=sample,
                )
                is_sharded = True
            else:
                gbuffer = render(
                    scene, camera, config, num_samples=batch, seed=args.seed,
                    adaptive=adaptive, gbuffer=gbuffer, sample_offset=sample,
                )
            jax.block_until_ready(gbuffer)
        except Exception as e:  # noqa: BLE001 -- failure recovery:
            # a device/runtime fault mid-batch loses at most one batch;
            # reload the last atomic checkpoint and retry (the reference
            # loses the whole render, SURVEY.md section 5).
            if not args.checkpoint or retries_left == 0:
                raise
            retries_left -= 1
            print(f"batch failed ({type(e).__name__}: {e}); resuming from "
                  f"checkpoint ({retries_left} retries left)", file=sys.stderr)
            try:
                gbuffer, camera, _, sample = load_checkpoint(args.checkpoint)
            except FileNotFoundError:
                gbuffer = GBuffer.create(config.num_pixels)
                sample = 0
            is_sharded = False  # checkpoints hold the plain layout
            continue
        dt = time.time() - t0
        sample += batch
        if is_sharded:
            # Replicated jitted reduction: np.asarray on the tile-sharded
            # count vector would raise on non-addressable shards when the
            # mesh spans processes (--multihost).
            from isaklm_raytracer_tpu.dist.sharding import gbuffer_progress

            min_spp, converged, n_unconverged = gbuffer_progress(
                gbuffer, config, mesh
            )
        else:
            counts = np.asarray(gbuffer.count)[: config.num_pixels]
            min_spp = int(counts.min())
            converged = float((counts >= config.min_samples).mean())
            n_unconverged = None  # computed lazily below
        print(
            f"sample {sample}/{args.max_samples}: {dt / batch * 1e3:.0f} ms/sample, "
            f"{rays_per_sample * batch / dt / 1e6:.1f} Mrays/s, "
            f"min spp {min_spp}, converged {converged:.0%}",
            file=sys.stderr,
        )
        if args.checkpoint:
            gb_plain = plain(gbuffer)  # collective: outside the rank guard
            if jax.process_index() == 0:
                save_checkpoint(
                    args.checkpoint, gb_plain, camera, args.seed, sample
                )
        if adaptive and min_spp >= config.min_samples:
            if n_unconverged is None:
                from isaklm_raytracer_tpu.integrator.adaptive import needs_sample

                n_unconverged = int(
                    np.asarray(needs_sample(gbuffer, config)).sum()
                )
            if n_unconverged == 0:
                print("all pixels converged", file=sys.stderr)
                break

    image = resolve_image(plain(gbuffer), config)
    save_png(args.out, np.asarray(image))
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
