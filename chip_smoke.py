#!/usr/bin/env python
"""Smoke test of the path tracer on one NVIDIA GPU, through its own entry points.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # the sharded phase alone, on four cards

Phases (one process; any failure exits non-zero):
  1. intersector: the compiled KD-walk kernel against the brute-force oracle
     and the XLA KD walk, on the 660-triangle demo scene and the 2M-triangle
     hero scene;
  2. goldens: the three golden renders of tests/golden/ on the card;
  3. cli: `cli.render.main` at demo 512x512x8 and hero 1920x1080x6, with the
     PNG checked and ms/sample reported;
  4. train: five inverse-rendering steps of `sharded_train_step_fn` on a
     one-card mesh (demo 256x256, albedo recovery) and one albedo gradient
     against finite differences.
With --four-cards: `render_sharded` of the hero at 1080p over a 4-card tile
mesh against the one-card `render()`, and 4-card training gradients against
one card.

The last line of stdout is the result, as JSON:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
It is printed only when every phase passed on a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def log(*args):
    print(*args, flush=True)


class _Tee(io.TextIOBase):
    """Copy of everything written to a stream, passed on to the stream."""

    def __init__(self, stream):
        self.stream, self.lines = stream, []

    def write(self, text):
        self.lines.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# A plane hit's distance is t = (n.p1 - n.o) / (n.d): its relative rounding
# error grows as 1/|n.d|. Rays within GRAZING_COS of the hit triangle's plane
# (about half a degree) are held to GRAZING_RTOL instead of rtol.
GRAZING_COS = 1e-2
GRAZING_RTOL = 1e-2


def compare_hits(name, got, want, verts, o, d, rtol=1e-4):
    """Hit masks identical, t within rtol (GRAZING_RTOL for grazing rays),
    ids differing only at ties in t."""
    import jax.numpy as jnp

    from isaklm_raytracer_tpu.accel import nearest_hit_brute

    (t1, i1, h1), (t0, i0, h0) = [tuple(map(np.asarray, r)) for r in (got, want)]
    mism = int((h1 != h0).sum())
    both = h1 & h0
    # t is a difference of dot products of scene coordinates, so its rounding
    # error scales with the scene, not with t: short hits are measured
    # against 1% of the scene's diagonal.
    flat = np.asarray(verts).reshape(-1, 3)
    floor = 1e-2 * float(np.linalg.norm(flat.max(0) - flat.min(0)))
    rel = np.abs(t1[both] - t0[both]) / np.maximum(np.abs(t0[both]), floor)
    tri = np.asarray(verts)[i0[both]].astype(np.float64)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    cos = np.abs((n * np.asarray(d)[both]).sum(axis=1))
    grazing = cos < GRAZING_COS
    max_rel = float(rel[~grazing].max()) if (~grazing).any() else 0.0
    max_graze = float(rel[grazing].max()) if grazing.any() else 0.0
    differ = np.nonzero(both & (i1 != i0))[0]
    untied = 0
    if differ.size:
        tri = jnp.asarray(np.asarray(verts)[i1[differ]])
        t_own = np.array([
            float(nearest_hit_brute(o[k:k + 1], d[k:k + 1], tri[j:j + 1])[0][0])
            for j, k in enumerate(differ)
        ])
        untied = int((np.abs(t_own - t0[differ]) > rtol * np.abs(t0[differ])).sum())
    log(f"  {name}: {len(h0)} rays, hit rate {h0.mean():.3f}, hit mismatches "
        f"{mism}, max rel dt {max_rel:.2e} ({int(grazing.sum())} grazing rays: "
        f"{max_graze:.2e}), id mismatches {differ.size} (not at ties: {untied})")
    if mism or max_rel > rtol or max_graze > GRAZING_RTOL or untied:
        raise AssertionError(f"{name}: kernel disagrees with reference")


def random_rays(verts, n, seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    flat = np.asarray(verts).reshape(-1, 3)
    lo, hi = flat.min(0), flat.max(0)
    o = (rng.random((n, 3)) * (hi - lo) + lo).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def camera_rays(camera, width, height, n, seed):
    import jax.numpy as jnp

    from isaklm_raytracer_tpu.camera.camera import generate_rays

    rng = np.random.default_rng(seed)
    ids = jnp.asarray(rng.integers(0, width * height, n).astype(np.int32))
    cam_u = jnp.asarray(rng.random((n, 4)).astype(np.float32))
    return generate_rays(camera, width, height, ids % width, ids // width, cam_u)


def hero_camera():
    from isaklm_raytracer_tpu.camera import Camera

    return Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2)


def phase_intersector(demo, hero):
    import functools

    import jax
    import jax.numpy as jnp

    from isaklm_raytracer_tpu.accel import nearest_hit_brute, nearest_hit_wavefront
    from isaklm_raytracer_tpu.accel.kd_kernel import nearest_hit_kd_kernel
    from isaklm_raytracer_tpu.config import RenderConfig
    from isaklm_raytracer_tpu.integrator.render import make_trace_fn

    log("phase intersector")
    chosen = make_trace_fn(demo, RenderConfig()).func
    if chosen is not nearest_hit_kd_kernel:
        raise AssertionError(f"make_trace_fn picked {chosen.__name__} on the GPU")
    cases = [("demo random", demo, *random_rays(demo.vertices, 2048, 1))]
    o_r, d_r = random_rays(hero.vertices, 256, 2)
    o_c, d_c = camera_rays(hero_camera(), 1920, 1080, 256, 3)
    cases.append(("hero random+camera", hero, jnp.concatenate([o_r, o_c]),
                  jnp.concatenate([d_r, d_c])))
    for name, scene, o, d in cases:
        kern = jax.jit(functools.partial(nearest_hit_kd_kernel, scene.wkd))
        got = jax.block_until_ready(kern(o, d))
        brute = jax.jit(nearest_hit_brute)(o, d, scene.vertices)
        xla = jax.jit(functools.partial(nearest_hit_wavefront, scene.wkd))(o, d)
        compare_hits(f"{name} vs brute", got, brute, scene.vertices, o, d)
        compare_hits(f"{name} vs xla walk", got, xla, scene.vertices, o, d)


# Golden renders on the card against the CPU goldens. Path decisions
# (lobe choice, Russian roulette, hit/miss at an edge) compare a uniform with
# a threshold computed in float32; a last-bit difference from FMA contraction
# or operation order flips a few paths, and each flip moves its pixel far.
# So a case passes when at most GOLDEN_SHARE of its pixels differ by more
# than 1e-4 (the CPU test's atol) and the mean absolute difference stays
# under GOLDEN_MEAN; PERF.md records the measured distribution.
GOLDEN_SHARE = 0.01
GOLDEN_MEAN = 1e-3


def phase_goldens():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from golden_cases import GOLDENS, render_case

    log("phase goldens")
    for name in GOLDENS:
        with np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz")) as f:
            want = f["image"]
        got = render_case(name)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"golden {name}: shape or finiteness")
        diff = np.abs(got - want)
        share = float((diff > 1e-4).mean())
        q = np.quantile(diff, [0.5, 0.9, 0.99, 0.999])
        log(f"  {name}: max {diff.max():.3e}, mean {diff.mean():.3e}, share "
            f">1e-4 {share:.4f}, quantiles 50/90/99/99.9% "
            + " ".join(f"{v:.2e}" for v in q))
        if share > GOLDEN_SHARE or diff.mean() > GOLDEN_MEAN:
            raise AssertionError(f"golden {name} outside its bound")


def phase_cli(card):
    from isaklm_raytracer_tpu.cli.render import main as cli_main
    from isaklm_raytracer_tpu.io.png import load_image

    log("phase cli")
    runs = [
        ("demo", 512, 512, 8, 4),
        ("hero", 1920, 1080, 6, 3),
    ]
    os.makedirs(os.path.join(REPO, "renders"), exist_ok=True)
    for scene, w, h, bounces, max_spp in runs:
        out = os.path.join(REPO, "renders", f"smoke_{scene}.png")
        argv = [
            "--scene", scene, "--width", str(w), "--height", str(h),
            "--max-bounces", str(bounces), "--min-samples", "2",
            "--max-samples", str(max_spp), "--checkpoint-every", "1",
            "--out", out,
        ]
        tee = _Tee(sys.stderr)
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(tee):
            rc = cli_main(argv)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli {scene} returned {rc}")
        img = load_image(out)
        if img.shape[:2] != (h, w) or not img[..., :3].mean() > 0:
            raise AssertionError(f"cli {scene}: bad image {img.shape}")
        per = [
            (float(m.group(1)), float(m.group(2)))
            for m in re.finditer(r"(\d+) ms/sample, ([\d.]+) Mrays/s",
                                 "".join(tee.lines))
        ]
        if len(per) < 2:
            raise AssertionError(f"cli {scene}: no steady-state sample")
        steady = min(per[1:])  # sample 1 includes compilation
        log(f"  cli {scene} {w}x{h}x{bounces}: {steady[0]:.0f} ms/sample, "
            f"{steady[1]:.1f} Mrays/s steady (per batch: "
            f"{[p[0] for p in per]} ms), wall {wall:.1f}s incl. scene build "
            f"and compile, image mean {img[..., :3].mean():.1f} | {card}")


def train_setup(width, height):
    from isaklm_raytracer_tpu.accel import prepare_scene
    from isaklm_raytracer_tpu.config import RenderConfig
    from isaklm_raytracer_tpu.scene import procedural

    config = RenderConfig(width=width, height=height, max_bounces=4)
    scene = prepare_scene(procedural.material_demo_scene())
    return scene, config, hero_camera()


def phase_train():
    import jax
    import jax.numpy as jnp

    from isaklm_raytracer_tpu.accel import prepare_scene
    from isaklm_raytracer_tpu.camera import Camera
    from isaklm_raytracer_tpu.config import RenderConfig
    from isaklm_raytracer_tpu.diff.fd import check_grad_vs_fd
    from isaklm_raytracer_tpu.dist.sharding import (
        make_render_mesh,
        sharded_train_step_fn,
    )
    from isaklm_raytracer_tpu.integrator.render import render_sample
    from isaklm_raytracer_tpu.scene import procedural

    log("phase train")
    scene, config, camera = train_setup(256, 256)
    key = jax.random.PRNGKey(5)
    target = render_sample(scene, camera, jax.random.fold_in(key, 0), config)
    mesh = make_render_mesh(num_tile=1, num_sample=1, devices=jax.devices()[:1])
    step = sharded_train_step_fn(scene, config, mesh, learning_rate=0.3)
    true_albedo = np.asarray(scene.materials.albedo)
    p = scene.materials.replace(albedo=scene.materials.albedo * 0.4)
    err0 = float(np.abs(np.asarray(p.albedo) - true_albedo).mean())
    losses = []
    for i in range(5):
        p, loss = step(p, camera, target, jax.random.fold_in(key, 10 + i))
        losses.append(float(loss))
    err = float(np.abs(np.asarray(p.albedo) - true_albedo).mean())
    # With one card the sample axis has size 1, so the step uses the plain
    # (correlated) gradient estimator: the loss falls, the albedo error is
    # reported.
    log(f"  train {config.width}x{config.height}: losses "
        f"{['%.5f' % v for v in losses]}, albedo error {err0:.4f} -> {err:.4f}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("training loss did not fall")

    # the albedo gradient against central differences: the setup and
    # tolerances of tests/test_estimator.py (Russian roulette off, so the
    # estimator is smooth in albedo)
    fd_scene = prepare_scene(procedural.cornell_box(include_blockers=False))
    fd_config = RenderConfig(width=16, height=16, max_bounces=4, rr_start_bounce=4)
    fd_camera = Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2)
    fd_key = jax.random.PRNGKey(11)

    def loss_of(albedo):
        s = fd_scene.replace(materials=fd_scene.materials.replace(albedo=albedo))
        return jnp.mean(render_sample(s, fd_camera, fd_key, fd_config))

    auto, fd = check_grad_vs_fd(
        loss_of, fd_scene.materials.albedo, h=2e-3, rtol=0.05, atol=2e-4
    )
    log(f"  fd check, cornell albedo {auto.shape}: max |autodiff - fd| "
        f"{np.abs(auto - fd).max():.2e}")


def phase_four_cards(card, scene, config, train_size=128):
    """`render_sharded` over a 4-device tile mesh against one-device
    `render()`, then 4-device training gradients against one device."""
    import jax

    from isaklm_raytracer_tpu.dist.sharding import (
        make_render_mesh,
        render_sharded,
        sharded_value_and_grad_fn,
        unshard_gbuffer,
    )
    from isaklm_raytracer_tpu.integrator.render import render, render_sample

    devices = jax.devices()
    if len(devices) != 4:
        raise AssertionError(f"--four-cards needs 4 devices, found {len(devices)}")
    log("phase four-cards")
    camera = hero_camera()
    mesh = make_render_mesh(num_tile=4, num_sample=1, devices=devices)
    t0 = time.perf_counter()
    sharded = unshard_gbuffer(
        jax.block_until_ready(render_sharded(
            scene, camera, config, num_samples=2, mesh=mesh, seed=3)),
        config,
    )
    t1 = time.perf_counter()
    single = jax.block_until_ready(render(scene, camera, config, 2, seed=3))
    t2 = time.perf_counter()
    a, b = np.asarray(sharded.frame), np.asarray(single.frame)
    diff = np.abs(a - b).max(axis=1)
    share = float((diff > FOUR_CARD_PIXEL_ATOL).mean())
    counts_equal = bool((np.asarray(sharded.count) == np.asarray(single.count)).all())
    log(f"  {scene.num_triangles} tris {config.width}x{config.height} x2 spp, "
        f"4-card tile mesh vs one card: max |diff| {diff.max():.3e}, mean "
        f"{diff.mean():.3e}, pixels differing at all {float((diff > 0).mean()):.5f}, "
        f"over {FOUR_CARD_PIXEL_ATOL:g}: {share:.5f}, counts equal "
        f"{counts_equal}; wall incl. compile 4-card {t1 - t0:.1f}s, 1-card "
        f"{t2 - t1:.1f}s | {card}")
    if not counts_equal or share > FOUR_CARD_SHARE or diff.mean() > FOUR_CARD_MEAN:
        raise AssertionError("sharded render differs from one card")

    scene_t, config_t, camera_t = train_setup(train_size, train_size)
    key = jax.random.PRNGKey(13)
    target = render_sample(scene_t, camera_t, jax.random.fold_in(key, 0), config_t)
    params = scene_t.materials.replace(albedo=scene_t.materials.albedo * 0.6)
    grads = {}
    for n in (4, 1):
        mesh = make_render_mesh(num_tile=n, num_sample=1, devices=devices[:n])
        vg = sharded_value_and_grad_fn(scene_t, config_t, mesh)
        loss, g = vg(params, camera_t, target, key)
        grads[n] = (float(loss), jax.tree.map(np.asarray, g))
    worst = 0.0
    for f, g4 in grads[4][1].items():
        g1 = grads[1][1][f]
        scale = max(float(np.abs(g1).max()), 1e-12)
        worst = max(worst, float(np.abs(g4 - g1).max()) / scale)
    log(f"  train grads 4 cards vs 1: loss {grads[4][0]:.6f} vs {grads[1][0]:.6f}, "
        f"max |dg|/max|g| {worst:.2e}")
    if worst > FOUR_CARD_GRAD_RTOL or not np.isclose(
            grads[4][0], grads[1][0], rtol=FOUR_CARD_LOSS_RTOL):
        raise AssertionError("4-card gradients differ from one card")


# Every pixel of a tile-sharded render follows the same per-ray program as
# on one card (counter-based RNG keyed on the global pixel id), so the
# images agree to float rounding: XLA may fuse the 4-card program, whose
# shapes differ, in another order. A last-bit difference can flip a path
# decision (as in the goldens), and a flipped path moves its pixel far: at
# most FOUR_CARD_SHARE of pixels may differ by more than FOUR_CARD_PIXEL_ATOL,
# and the mean difference (radiance summed over 2 samples) stays under
# FOUR_CARD_MEAN. PERF.md records the measured values.
FOUR_CARD_PIXEL_ATOL = 1e-3
FOUR_CARD_SHARE = 2e-3
FOUR_CARD_MEAN = 1e-3
# The 4-card gradient is a psum of four partial sums (another summation
# order), over pixels some of whose paths may flip as above; each pixel adds
# about 1/num_pixels of the gradient and the loss.
FOUR_CARD_GRAD_RTOL = 1e-2
FOUR_CARD_LOSS_RTOL = 1e-2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card sharded phase")
    args = parser.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    count = len(jax.devices())
    log(f"device: platform={dev.platform} kind={dev.device_kind} count={count}")
    if dev.platform != "gpu":
        log("no GPU: JAX found only", dev.platform)
        return 1
    card = card_line()
    log(card)

    from isaklm_raytracer_tpu import compile_cache

    log(f"compile cache: {compile_cache.enable()}")
    if args.four_cards:
        from isaklm_raytracer_tpu.accel import prepare_scene
        from isaklm_raytracer_tpu.config import RenderConfig
        from isaklm_raytracer_tpu.scene import procedural

        phase_four_cards(
            card, prepare_scene(procedural.hero_scene(2_000_000)),
            RenderConfig(width=1920, height=1080, max_bounces=6),
        )
    else:
        if count != 1:
            raise AssertionError(f"the one-card smoke found {count} devices")
        from isaklm_raytracer_tpu.accel import prepare_scene
        from isaklm_raytracer_tpu.scene import procedural

        t0 = time.perf_counter()
        demo = prepare_scene(procedural.material_demo_scene())
        hero = prepare_scene(procedural.hero_scene(2_000_000))
        log(f"scenes: demo {demo.num_triangles} tris, hero {hero.num_triangles} "
            f"tris, built in {time.perf_counter() - t0:.1f}s")
        phase_intersector(demo, hero)
        del demo, hero
        phase_goldens()
        phase_cli(card)
        phase_train()

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
