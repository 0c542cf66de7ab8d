"""Progressive frame orchestration: the reference's render loop, headless.

Equivalent of render.cuh:62-76 + the main loop (main.cu:114-155): each step
adds one path-traced sample to every unconverged pixel, updating the
G-buffer's running radiance / squared-luminance / count accumulators; the
display image at any moment is the tonemapped per-pixel average
(draw_frame, render.cuh:37-59). A camera move resets the accumulators
(reset_frame, render.cuh:18-34).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from isaklm_raytracer_tpu.accel.traverse import nearest_hit_brute
from isaklm_raytracer_tpu.camera.camera import Camera, generate_rays
from isaklm_raytracer_tpu.config import RenderConfig
from isaklm_raytracer_tpu.integrator.adaptive import needs_sample
from isaklm_raytracer_tpu.integrator.path_trace import trace_paths
from isaklm_raytracer_tpu.math import rng
from isaklm_raytracer_tpu.math.color import correct_color, luminance
from isaklm_raytracer_tpu.scene.types import GBuffer, Scene


def make_trace_fn(scene: Scene, config: RenderConfig):
    """Pick the intersector, in descending preference: on a GPU the fused
    KD-walk kernel (accel.kd_kernel), elsewhere the batched lockstep KD
    walk in plain XLA (accel.wavefront), then the vmapped scalar KD walk,
    then the brute-force oracle when no KD tree was built (cli --no-kd).
    All share trace(o, d, active=None, t_max=None) -> (t, idx, hit)."""
    if scene.wkd is not None:
        if jax.default_backend() == "gpu":
            from isaklm_raytracer_tpu.accel.kd_kernel import nearest_hit_kd_kernel

            return functools.partial(
                nearest_hit_kd_kernel, scene.wkd, t_eps=config.t_epsilon
            )
        from isaklm_raytracer_tpu.accel.wavefront import nearest_hit_wavefront

        return functools.partial(
            nearest_hit_wavefront, scene.wkd, t_eps=config.t_epsilon
        )
    if scene.kd is not None:
        from isaklm_raytracer_tpu.accel.kd_traverse import nearest_hit_kd

        return functools.partial(
            nearest_hit_kd, scene.kd, scene.vertices, t_eps=config.t_epsilon
        )
    return functools.partial(
        nearest_hit_brute, vertices=scene.vertices, t_eps=config.t_epsilon
    )


def pixel_coords(config: RenderConfig):
    """Flat pixel index -> (x, y), row-major y*W + x like the reference
    (path_tracing.cuh:350)."""
    idx = jnp.arange(config.num_pixels, dtype=jnp.int32)
    return idx % config.width, idx // config.width


def sample_key_data(key: jnp.ndarray) -> jnp.ndarray:
    """Per-sample (2,) uint32 Threefry key words for the counter sampler.

    Every variate downstream is a pure function of (these words, GLOBAL
    pixel id, stream, dim) -- identical regardless of device sharding or
    ray reordering (SURVEY.md section 2.3: deterministic under sharding).
    This replaces per-ray fold_in key plumbing, which costs a full hash
    per ray before a single variate is drawn."""
    return jax.random.key_data(key).astype(jnp.uint32).reshape(-1)[:2]


def render_sample(
    scene: Scene,
    camera: Camera,
    key: jnp.ndarray,
    config: RenderConfig,
    active: Optional[jnp.ndarray] = None,
    trace_fn=None,
    pixel_ids: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """One radiance sample per pixel; returns (R, 3).

    `pixel_ids` (global flat ids) selects a pixel subset -- the unit of
    sharding across devices; default = all pixels. `active` optionally masks
    pixels (adaptive sampling); inactive pixels still compute (uniform
    control flow) but their result is zeroed.
    """
    if trace_fn is None:
        trace_fn = make_trace_fn(scene, config)
    if pixel_ids is None:
        pixel_ids = jnp.arange(config.num_pixels, dtype=jnp.int32)
    num_rays = pixel_ids.shape[0]

    kd = sample_key_data(key)

    def run_chunk(ids):
        px = ids % config.width
        py = ids // config.width
        cam_u = rng.uniforms(kd, ids, rng.CAMERA_STREAM, 4).T  # (R, 4)
        origins, directions = generate_rays(
            camera, config.width, config.height, px, py, cam_u
        )
        return trace_paths(scene, trace_fn, origins, directions, kd, ids, config)

    chunk = config.ray_chunk
    if chunk and num_rays > chunk:
        # Fixed-size inner launches sequenced by lax.map: bounds the live
        # per-ray state (the analog of the reference's fixed 20x45 grid of
        # 3x3-pixel cells, render.cuh:64-65).
        num_chunks = -(-num_rays // chunk)
        padded = num_chunks * chunk
        ids = jnp.concatenate(
            [pixel_ids, jnp.zeros((padded - num_rays,), jnp.int32)]
        ).reshape(num_chunks, chunk)
        radiance = jax.lax.map(run_chunk, ids).reshape(padded, 3)[:num_rays]
    else:
        radiance = run_chunk(pixel_ids)
    if active is not None:
        radiance = jnp.where(active[:, None], radiance, 0.0)
    return radiance


def render_step(
    scene: Scene,
    camera: Camera,
    gbuffer: GBuffer,
    key: jnp.ndarray,
    config: RenderConfig,
    adaptive: bool = True,
    trace_fn=None,
) -> GBuffer:
    """Progressive step: path_tracing kernel + accumulate
    (path_tracing.cuh:338-395)."""
    active = needs_sample(gbuffer, config) if adaptive else None
    radiance = render_sample(scene, camera, key, config, active, trace_fn)
    took = (
        active
        if active is not None
        else jnp.ones((config.num_pixels,), bool)
    )
    return GBuffer(
        frame=gbuffer.frame + radiance,
        sq_luminance=gbuffer.sq_luminance
        + jnp.where(took, jnp.square(luminance(radiance)), 0.0),
        count=gbuffer.count + took.astype(jnp.int32),
    )


def resolve_image(gbuffer: GBuffer, config: RenderConfig) -> jnp.ndarray:
    """Tonemapped display image (H, W, 3) in [0,1] (draw_frame,
    render.cuh:37-59): per-pixel average -> correct_color."""
    counts = jnp.maximum(gbuffer.count, 1).astype(jnp.float32)
    avg = gbuffer.frame / counts[:, None]
    img = correct_color(avg)
    return img.reshape(config.height, config.width, 3)


@functools.lru_cache(maxsize=8)
def make_active_count_fn(config: RenderConfig):
    """Jitted (gbuffer) -> int32 count of pixels still needing a sample."""

    @jax.jit
    def count(gb):
        return jnp.sum(needs_sample(gb, config).astype(jnp.int32))

    return count


def compact_bucket(n_active: int, num_pixels: int, chunk: int) -> int:
    """Smallest ceil-halving of num_pixels (floored at `chunk`) >= n_active.

    The bucket ladder {num_pixels, ceil(/2), ceil(/4), ..., chunk} bounds
    the number of distinct compiled programs to log2(num_pixels/chunk) + 1
    while keeping padding waste below 2x. Ceil-halving (round 3 used exact
    halving) makes the ladder work for ODD pixel counts too -- 639x360
    previously never compacted at all.
    """
    size = num_pixels
    while -(-size // 2) >= max(n_active, 1) and -(-size // 2) >= chunk:
        size = -(-size // 2)
    return size


@functools.lru_cache(maxsize=64)
def make_compact_step_fn(config: RenderConfig, bucket: int):
    """Jitted compute-skipping adaptive step: gather the unconverged pixel
    ids into a fixed `bucket`-sized wavefront, render ONLY those, scatter-add
    back into the G-buffer.

    This is the wavefront re-architecture of the reference's per-thread
    skip (path_tracing.cuh:347-379: converged threads simply do not call
    trace_path): lanes of a batched wavefront can't individually skip, so
    the saving comes from shrinking the launched wavefront instead. Because every variate is
    a counter-mode function of the GLOBAL pixel id (math/rng.py), the
    compacted render is bit-identical to the full masked render -- tested in
    tests/test_render_e2e.py.
    """

    @functools.partial(jax.jit, donate_argnums=(2,))
    def step(scene, camera, gb, k):
        active = needs_sample(gb, config)
        n_active = jnp.sum(active)
        # Ascending ids (coherent packets); overflow lanes repeat id 0 but
        # are masked off via their position past n_active.
        ids = jnp.nonzero(active, size=bucket, fill_value=0)[0].astype(jnp.int32)
        valid = jnp.arange(bucket, dtype=jnp.int32) < n_active
        radiance = render_sample(
            scene, camera, k, config, active=valid, pixel_ids=ids
        )
        vi = valid.astype(jnp.int32)
        return GBuffer(
            frame=gb.frame.at[ids].add(radiance),  # masked lanes add 0
            sq_luminance=gb.sq_luminance.at[ids].add(
                jnp.where(valid, jnp.square(luminance(radiance)), 0.0)
            ),
            count=gb.count.at[ids].add(vi),
        )

    return step


@functools.lru_cache(maxsize=8)
def make_candidates_fn(config: RenderConfig, bucket: int):
    """Jitted: gather the unconverged pixel ids into a (bucket,) candidate
    array (-1 padded), ascending. One O(num_pixels) scan -- done ONCE when
    entering tail mode, not per step."""

    @jax.jit
    def cands(gb):
        active = needs_sample(gb, config)
        n = jnp.sum(active)
        ids = jnp.nonzero(active, size=bucket, fill_value=0)[0].astype(jnp.int32)
        ids = jnp.where(jnp.arange(bucket, dtype=jnp.int32) < n, ids, -1)
        return ids, n

    return cands


@functools.lru_cache(maxsize=64)
def make_tail_step_fn(config: RenderConfig, bucket: int):
    """Jitted O(bucket) adaptive tail step over a CANDIDATE id set.

    Once a pixel leaves the active set it accumulates nothing, so its
    adaptive state is frozen and it can never re-activate (monotone under
    no camera reset). The active set therefore only SHRINKS, and the tail
    loop needs to re-test needs_sample only on the current candidates --
    an O(bucket) gather -- instead of scanning all pixels each step (the
    round-3 floor cost, BASELINE.md adaptive table). Candidates stay
    order-preserved (ascending ids -> coherent packets) and compact to the
    front, so the host can shrink the bucket by slicing.

    Returns (gbuffer', candidates', n_active). Sampled-pixel CHOICE and
    radiance values are bit-identical to the full masked step (same
    per-pixel gate, same global-pixel-keyed RNG).
    """

    @functools.partial(jax.jit, donate_argnums=(2, 3))
    def step(scene, camera, gb, cand, k):
        valid_c = cand >= 0
        safe = jnp.maximum(cand, 0)
        sub = GBuffer(
            frame=gb.frame[safe],
            sq_luminance=gb.sq_luminance[safe],
            count=gb.count[safe],
        )
        active = needs_sample(sub, config) & valid_c
        n = jnp.sum(active)
        # stable partition: actives (ascending) to the front
        order = jnp.argsort(~active, stable=True)
        cand2 = jnp.where(
            jnp.arange(bucket, dtype=jnp.int32) < n, cand[order], -1
        )
        ids = jnp.maximum(cand2, 0)
        valid = cand2 >= 0
        radiance = render_sample(
            scene, camera, k, config, active=valid, pixel_ids=ids
        )
        vi = valid.astype(jnp.int32)
        gb2 = GBuffer(
            frame=gb.frame.at[ids].add(radiance),  # masked lanes add 0
            sq_luminance=gb.sq_luminance.at[ids].add(
                jnp.where(valid, jnp.square(luminance(radiance)), 0.0)
            ),
            count=gb.count.at[ids].add(vi),
        )
        return gb2, cand2, n

    return step


@functools.lru_cache(maxsize=8)
def make_step_fn(config: RenderConfig):
    """Jitted progressive step (scene, camera, gbuffer, key) -> gbuffer.

    Scene and camera are jit ARGUMENTS, not closure constants: closed-over
    arrays get baked into the compiled program as constants (at hero scale
    ~400MB of geometry), and a fresh closure would recompile on every
    render() call -- an early CLI recompiled on every checkpoint batch
    because of exactly that. lru_cache keyed on the
    (hashable) config keeps one compiled program per configuration.
    """

    @functools.partial(jax.jit, static_argnames=("adaptive_",), donate_argnums=(2,))
    def step(scene, camera, gb, k, adaptive_):
        return render_step(scene, camera, gb, k, config, adaptive_)

    return step


def render(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    num_samples: int,
    seed: int = 0,
    adaptive: bool = False,
    gbuffer: Optional[GBuffer] = None,
    sample_offset: int = 0,
) -> GBuffer:
    """Render `num_samples` progressive steps (the reference's main loop,
    main.cu:114-132, without the window).

    `sample_offset` continues the key sequence across calls (progressive
    batches / checkpoint resume): step i uses fold_in(seed, offset + i).
    """
    if gbuffer is None:
        gbuffer = GBuffer.create(config.num_pixels)
    step = make_step_fn(config)
    count_active = make_active_count_fn(config) if adaptive else None
    floor = min(config.min_wavefront, config.num_pixels)

    base = jax.random.PRNGKey(seed)
    cand = None  # tail-mode candidate ids (ascending, -1 padded)
    bucket = config.num_pixels
    for i in range(num_samples):
        key = jax.random.fold_in(base, sample_offset + i)
        if adaptive:
            # Host-side wavefront sizing (one scalar sync per step, cheap
            # next to tracing): shrink the launch to the unconverged set so
            # converged pixels cost NOTHING, like the reference's per-thread
            # skip (path_tracing.cuh:347-379).
            if cand is None:
                n_active = int(count_active(gbuffer))
                if n_active == 0:
                    break
                bucket = compact_bucket(n_active, config.num_pixels, floor)
                if bucket < config.num_pixels:
                    # Enter TAIL MODE: one O(num_pixels) candidate gather,
                    # then every further step is O(bucket)
                    # (make_tail_step_fn; the active set is monotone).
                    cand, _n = make_candidates_fn(config, bucket)(gbuffer)
            if cand is not None:
                gbuffer, cand, n_dev = make_tail_step_fn(config, bucket)(
                    scene, camera, gbuffer, cand, key
                )
                n_active = int(n_dev)
                if n_active == 0:
                    break
                nb = compact_bucket(n_active, config.num_pixels, floor)
                if nb < bucket:
                    cand = cand[:nb]  # actives are compacted to the front
                    bucket = nb
                continue
        gbuffer = step(scene, camera, gbuffer, key, adaptive)
    return gbuffer
