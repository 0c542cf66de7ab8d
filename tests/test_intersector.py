"""The GPU nearest-hit kernel (accel.kd_kernel) and the scene preparation
and intersector choice around it.

The kernel runs here through the Pallas interpreter, which executes the
same kernel program as the compiled GPU build, and must agree with the
brute-force oracle and with the XLA KD walk (SURVEY.md section 4: KD-tree
vs brute-force intersect_triangle over random rays). Tests marked `gpu`
compile it for the card and skip where there is none.
"""

import functools
import os
import shutil
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isaklm_raytracer_tpu.accel import (
    build_kd_tree,
    build_wavefront_kd,
    nearest_hit_brute,
    nearest_hit_wavefront,
    prepare_scene,
)
from isaklm_raytracer_tpu.accel.cluster import (
    CLUSTER_WIDTH,
    cluster_order,
    morton_order,
)
from isaklm_raytracer_tpu.accel.kd_kernel import BLOCK, nearest_hit_kd_kernel
from isaklm_raytracer_tpu.camera import Camera
from isaklm_raytracer_tpu.camera.camera import generate_rays
from isaklm_raytracer_tpu.config import RenderConfig
from isaklm_raytracer_tpu.scene import procedural

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

kernel = functools.partial(nearest_hit_kd_kernel, interpret=True)


def _random_soup(rng, num_tris, spread=2.0, size=0.4):
    base = rng.uniform(-spread, spread, (num_tris, 1, 3)).astype(np.float32)
    return (base + rng.uniform(-size, size, (num_tris, 3, 3))).astype(
        np.float32
    )


def _random_rays(rng, num_rays, spread=3.0):
    o = rng.uniform(-spread, spread, (num_rays, 3)).astype(np.float32)
    d = rng.normal(size=(num_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _wkd(verts, **kd_kwargs):
    return build_wavefront_kd(build_kd_tree(verts, **kd_kwargs), verts)


def assert_same_hits(verts, o, d, got, want, rtol=1e-5, atol=1e-6):
    """Hit masks identical, t close, ids equal except at ties in t (the
    other triangle is hit at the same distance)."""
    (t1, i1, h1), (t0, i0, h0) = [tuple(map(np.asarray, r)) for r in (got, want)]
    np.testing.assert_array_equal(h1, h0)
    np.testing.assert_allclose(t1[h0], t0[h0], rtol=rtol, atol=atol)
    assert (i1[~h0] == -1).all()
    differ = np.nonzero(h0 & (i1 != i0))[0]
    if differ.size:
        tri = jnp.asarray(np.asarray(verts)[i1[differ]])
        t_own = np.array([
            float(nearest_hit_brute(o[k:k + 1], d[k:k + 1], tri[j:j + 1])[0][0])
            for j, k in enumerate(differ)
        ])
        np.testing.assert_allclose(t_own, t0[differ], rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# spatial renumbering (accel.cluster)


class TestOrdering:
    def test_morton_order_is_permutation(self):
        rng = np.random.default_rng(0)
        verts = _random_soup(rng, 333)
        order = morton_order(verts)
        assert sorted(order.tolist()) == list(range(333))

    @pytest.mark.parametrize("num_tris", [333, 128 * 3, 128 * 5 + 1])
    def test_cluster_order_is_permutation_with_tail_last(self, num_tris):
        """cluster_order is the renumbering prepare_scene applies: a
        permutation whose full CLUSTER_WIDTH groups are spatially compact
        and whose partial group (num_tris % 128) comes LAST."""
        rng = np.random.default_rng(num_tris)
        verts = _random_soup(rng, num_tris)
        order = cluster_order(verts)
        assert sorted(order.tolist()) == list(range(num_tris))
        cent = verts[order].mean(axis=1)
        n_full = num_tris // CLUSTER_WIDTH
        span = cent.max(0) - cent.min(0)
        # Leaves are the consecutive CLUSTER_WIDTH groups, the partial one
        # last. They partition space by centroid, so their centroid boxes
        # are disjoint and their volumes sum to at most the whole box.
        groups = [
            cent[c * CLUSTER_WIDTH:(c + 1) * CLUSTER_WIDTH]
            for c in range(-(-num_tris // CLUSTER_WIDTH))
        ]
        assert groups[-1].shape[0] == (num_tris % CLUSTER_WIDTH or CLUSTER_WIDTH)
        volumes = [np.prod(g.max(0) - g.min(0)) for g in groups]
        assert sum(volumes) <= np.prod(span) * (1 + 1e-5)
        assert max(volumes[:n_full]) < np.prod(span)


# ---------------------------------------------------------------------------
# kernel vs oracle


class TestKernelVsOracle:
    @pytest.mark.parametrize("num_tris,num_rays", [(60, 257), (900, 512)])
    def test_random_soup(self, num_tris, num_rays):
        rng = np.random.default_rng(num_tris)
        verts = _random_soup(rng, num_tris)
        verts = verts[morton_order(verts)]
        wkd = _wkd(verts)
        o, d = _random_rays(rng, num_rays)
        want = nearest_hit_brute(o, d, vertices=jnp.asarray(verts))
        assert_same_hits(verts, o, d, kernel(wkd, o, d), want)

    def test_active_mask(self):
        rng = np.random.default_rng(7)
        verts = _random_soup(rng, 100)
        wkd = _wkd(verts)
        o, d = _random_rays(rng, 256)
        act = jnp.asarray(rng.random(256) > 0.5)

        _, i_all, h_all = kernel(wkd, o, d)
        t, i, h = kernel(wkd, o, d, active=act)
        act_np = np.asarray(act)
        assert not np.asarray(h)[~act_np].any()
        assert (np.asarray(i)[~act_np] == -1).all()
        assert np.isinf(np.asarray(t)[~act_np]).all()
        np.testing.assert_array_equal(
            np.asarray(h)[act_np], np.asarray(h_all)[act_np]
        )
        np.testing.assert_array_equal(
            np.asarray(i)[act_np], np.asarray(i_all)[act_np]
        )

    def test_all_inactive(self):
        rng = np.random.default_rng(8)
        verts = _random_soup(rng, 100)
        o, d = _random_rays(rng, 100)
        t, i, h = kernel(_wkd(verts), o, d, active=jnp.zeros((100,), bool))
        assert not np.asarray(h).any()
        assert (np.asarray(i) == -1).all() and np.isinf(np.asarray(t)).all()

    def test_ray_count_not_multiple_of_block(self):
        rng = np.random.default_rng(9)
        verts = _random_soup(rng, 100)
        o, d = _random_rays(rng, 77)
        want = nearest_hit_brute(o, d, vertices=jnp.asarray(verts))
        assert_same_hits(verts, o, d, kernel(_wkd(verts), o, d), want)

    @pytest.mark.parametrize("num_rays", [1, BLOCK - 1, BLOCK + 1])
    def test_padding_shapes(self, num_rays):
        """Padded lanes never leak into the result: shapes follow the input
        and every ray matches the XLA walk."""
        rng = np.random.default_rng(num_rays)
        verts = _random_soup(rng, 200)
        wkd = _wkd(verts)
        o, d = _random_rays(rng, num_rays)
        t, i, h = kernel(wkd, o, d)
        assert t.shape == i.shape == h.shape == (num_rays,)
        assert t.dtype == jnp.float32 and i.dtype == jnp.int32
        assert h.dtype == jnp.bool_
        want = nearest_hit_wavefront(wkd, o, d)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(want[1]))
        np.testing.assert_array_equal(np.asarray(h), np.asarray(want[2]))

    def test_rays_from_inside_scene(self):
        """Origins on/inside geometry: the t_eps rule and axis-parallel
        rays (d component == 0 -> inf slab reciprocals)."""
        rng = np.random.default_rng(11)
        verts = _random_soup(rng, 300, spread=1.0)
        o = jnp.zeros((256, 3), jnp.float32)
        axes = np.zeros((256, 3), np.float32)
        axes[np.arange(256), np.arange(256) % 3] = np.where(
            (np.arange(256) // 3) % 2 == 0, 1.0, -1.0
        )
        d = jnp.asarray(axes)
        want = nearest_hit_brute(o, d, vertices=jnp.asarray(verts))
        assert_same_hits(verts, o, d, kernel(_wkd(verts), o, d), want)

    def test_axis_aligned_rays_from_outside(self):
        """Axis-parallel rays entering the root box from outside, some in
        the plane of a split: NaN plane distances take the near child only."""
        scene = procedural.cornell_box()
        verts = np.asarray(scene.vertices)
        rng = np.random.default_rng(12)
        n = 192
        o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
        d = np.zeros((n, 3), np.float32)
        ax = np.arange(n) % 3
        sign = np.where((np.arange(n) // 3) % 2 == 0, 1.0, -1.0)
        d[np.arange(n), ax] = sign
        o[np.arange(n), ax] = -3.0 * sign  # start outside, looking in
        o[:16, (ax[:16] + 1) % 3] = 0.0  # on the central planes
        o, d = jnp.asarray(o), jnp.asarray(d)
        want = nearest_hit_brute(o, d, vertices=scene.vertices)
        wkd = _wkd(verts, max_depth=8, leaf_size=2)
        assert_same_hits(verts, o, d, kernel(wkd, o, d), want)

    def test_duplicated_straddlers(self):
        """Large triangles straddle many split planes and sit in several
        leaves; the exit-distance clamp keeps each hit in its own leaf."""
        rng = np.random.default_rng(13)
        small = _random_soup(rng, 400, spread=2.0, size=0.2)
        big = _random_soup(rng, 24, spread=1.0, size=2.5)
        verts = np.concatenate([small, big])
        wkd = _wkd(verts, max_depth=12, leaf_size=2)
        o, d = _random_rays(rng, 384)
        want = nearest_hit_brute(o, d, vertices=jnp.asarray(verts))
        assert_same_hits(verts, o, d, kernel(wkd, o, d), want)
        assert_same_hits(verts, o, d, kernel(wkd, o, d),
                         nearest_hit_wavefront(wkd, o, d))

    def test_jit_and_t_max_accepted(self):
        """The integrator calls trace(o, d, active=, t_max=) under jit; t_max
        is an ignored hint, as for the XLA walk."""
        rng = np.random.default_rng(14)
        verts = _random_soup(rng, 200)
        wkd = _wkd(verts)
        o, d = _random_rays(rng, 100)
        fn = jax.jit(lambda o, d, w: kernel(wkd, o, d, active=None, t_max=w))
        got = fn(o, d, jnp.full((100,), 0.5, jnp.float32))
        ref = kernel(wkd, o, d)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _scene_geometry(name):
    """(vertices, wkd, camera) for the oracle matrix."""
    if name == "soup900":
        verts = _random_soup(np.random.default_rng(900), 900)
        return verts, _wkd(verts), Camera.create((0.0, 0.0, -6.0), fov=1.2)
    if name == "cornell":
        scene, cam = procedural.cornell_box(), ((0.0, 0.0, -0.9), 0.0)
    elif name == "demo":
        scene, cam = procedural.material_demo_scene(), ((0.0, 1.2, -1.8), 0.15)
    else:
        scene, cam = procedural.hero_scene(20_000), ((0.0, 2.0, -6.0), 0.0)
    scene = prepare_scene(scene)
    camera = Camera.create(cam[0], pitch=cam[1], fov=np.pi / 2)
    return np.asarray(scene.vertices), scene.wkd, camera


def _rays(kind, verts, camera, rng, n=256):
    if kind == "camera":
        side = int(np.sqrt(n))
        ids = jnp.arange(side * side, dtype=jnp.int32)
        cam_u = jnp.asarray(rng.random((side * side, 4)).astype(np.float32))
        return generate_rays(camera, side, side, ids % side, ids // side, cam_u)
    flat = verts.reshape(-1, 3)
    if kind == "random":
        lo, hi = flat.min(0), flat.max(0)
        o = (rng.random((n, 3)) * (hi - lo) + lo).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if kind == "surface":  # bounce rays: leave a surface point, 1e-3 out
        tri = verts[rng.integers(0, verts.shape[0], n)]
        w = rng.dirichlet(np.ones(3), n).astype(np.float32)
        o = (np.einsum("nk,nkc->nc", w, tri) + 1e-3 * d).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("kind", ["camera", "random", "surface"])
@pytest.mark.parametrize("scene_name", ["cornell", "demo", "soup900", "hero20k"])
def test_kernel_matches_oracle_and_xla_walk(scene_name, kind):
    verts, wkd, camera = _scene_geometry(scene_name)
    rng = np.random.default_rng(zlib.crc32(f"{scene_name}/{kind}".encode()))
    o, d = _rays(kind, verts, camera, rng)
    got = kernel(wkd, o, d)
    # Grazing bounce rays make t ill-conditioned (t ~ 1/(d.n)), so the
    # last-bit differences of another operation order show: an absolute
    # 1e-4 in scene units covers them.
    tol = dict(rtol=1e-4, atol=1e-4) if kind == "surface" else {}
    want = nearest_hit_brute(o, d, jnp.asarray(verts))
    assert_same_hits(verts, o, d, got, want, **tol)
    assert_same_hits(verts, o, d, got, nearest_hit_wavefront(wkd, o, d), **tol)
    assert np.asarray(got[2]).any()


# ---------------------------------------------------------------------------
# gradients through a render that uses the kernel


class TestGradThroughKernel:
    """jax.grad through a render using the Pallas intersector must not
    crash: pallas_call has no differentiation rule, so the wrapper detaches
    its inputs."""

    def _setup(self):
        config = RenderConfig(width=8, height=8, max_bounces=3, ray_chunk=0)
        scene = prepare_scene(procedural.cornell_box())
        trace_fn = functools.partial(
            kernel, scene.wkd, t_eps=config.t_epsilon
        )
        camera = Camera.create(position=(0.0, 0.0, -0.9), fov=3.14159 / 2)
        return scene, camera, config, trace_fn

    def test_grad_albedo(self):
        from isaklm_raytracer_tpu.integrator.render import render_sample

        scene, camera, config, trace_fn = self._setup()
        key = jax.random.PRNGKey(0)

        def loss(albedo):
            s = scene.replace(materials=scene.materials.replace(albedo=albedo))
            return jnp.mean(render_sample(s, camera, key, config, trace_fn=trace_fn))

        g = np.asarray(jax.grad(loss)(scene.materials.albedo))
        assert np.isfinite(g).all()
        assert np.abs(g).sum() > 0

    def test_grad_camera_position(self):
        """Camera-pose tangents flow through ray ORIGINS straight into the
        kernel inputs."""
        from isaklm_raytracer_tpu.integrator.render import render_sample

        scene, camera, config, trace_fn = self._setup()
        key = jax.random.PRNGKey(1)

        def loss(pos):
            cam = camera.replace(position=pos)
            return jnp.mean(render_sample(scene, cam, key, config, trace_fn=trace_fn))

        g = np.asarray(jax.grad(loss)(camera.position))
        assert np.isfinite(g).all()


# ---------------------------------------------------------------------------
# scene preparation and intersector choice


class TestPreparedScene:
    def test_renumbering_keeps_render_semantics(self):
        """prepare_scene permutes triangles; lights/materials/uvs must stay
        consistent: a cornell render through the KD path must be finite
        and lit."""
        from isaklm_raytracer_tpu.integrator.render import render, resolve_image

        config = RenderConfig(width=16, height=16, max_bounces=3, ray_chunk=0)
        scene = prepare_scene(procedural.cornell_box())
        mats = np.asarray(scene.materials.emittance[np.asarray(scene.mat_id)])
        lights = np.asarray(scene.light_indices)
        # every light triangle is emissive in the permuted numbering
        assert (mats[lights] > 0).any(axis=-1).all()
        camera = Camera.create(position=(0.0, 0.0, -0.9), fov=3.14159 / 2)
        gb = render(scene, camera, config, num_samples=2)
        img = np.asarray(resolve_image(gb, config))
        assert np.isfinite(img).all() and img.mean() > 0.01

    def test_kd_built_above_former_size_limit(self):
        """The KD tree is built at every size: a scene above 300k triangles
        (where the build used to be skipped, leaving brute force) gets one."""
        import isaklm_raytracer_tpu.accel as accel

        assert not hasattr(accel, "KD_BUILD_LIMIT")
        scene = prepare_scene(procedural.hero_scene(320_000))
        assert scene.num_triangles > 300_000
        assert scene.kd is not None and scene.wkd is not None
        assert int(scene.wkd.chunk_tri.max()) == scene.num_triangles - 1

    def test_compact_bucket_ceil_halving_odd_sizes(self):
        from isaklm_raytracer_tpu.integrator.render import compact_bucket

        # odd pixel count must still halve
        assert compact_bucket(10, 399, 8) < 399
        assert compact_bucket(10, 399, 8) >= 10
        # ladder floors at chunk
        assert compact_bucket(1, 1024, 128) == 128
        # full when active ~ all
        assert compact_bucket(1000, 1024, 8) == 1024


@pytest.mark.parametrize(
    "backend,strip,expected",
    [
        ("gpu", (), "nearest_hit_kd_kernel"),
        ("cpu", (), "nearest_hit_wavefront"),
        ("cpu", ("wkd",), "nearest_hit_kd"),
        ("gpu", ("wkd", "kd"), "nearest_hit_brute"),
    ],
)
def test_make_trace_fn_choice(monkeypatch, backend, strip, expected):
    """The fused kernel on a GPU, the XLA walk elsewhere; brute force only
    when no KD tree was built."""
    from isaklm_raytracer_tpu.integrator.render import make_trace_fn

    scene = prepare_scene(procedural.cornell_box())
    scene = scene.replace(**{name: None for name in strip})
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    fn = make_trace_fn(scene, RenderConfig(width=8, height=8))
    assert fn.func.__name__ == expected
    assert fn.keywords["t_eps"] == 1e-5


# ---------------------------------------------------------------------------
# compile cache and the chip smoke's refusal to run off the card


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    from isaklm_raytracer_tpu import compile_cache

    before = jax.config.jax_compilation_cache_dir
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert compile_cache.cache_dir(env) == str(tmp_path)
    assert compile_cache.enable(env) == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout():
    from isaklm_raytracer_tpu import compile_cache

    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.cache_dir({}) == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable({}) == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_written_to_env_dir(tmp_path):
    cache = tmp_path / "cache"
    code = (
        "import jax, jax.numpy as jnp\n"
        "from isaklm_raytracer_tpu import compile_cache\n"
        "compile_cache.enable()\n"
        "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(3)).block_until_ready()\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
    assert any(cache.iterdir())


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """On the CPU, and in a directory holding only the script, the smoke
    exits non-zero and never prints a passing result line."""
    src = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(src, tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# ---------------------------------------------------------------------------
# compiled on the card


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_walk(gpu_device):
    scene = prepare_scene(procedural.material_demo_scene())
    verts = np.asarray(scene.vertices)
    o, d = _rays("random", verts, None, np.random.default_rng(0), n=2048)
    o, d = jax.device_put((o, d), gpu_device)
    got = jax.jit(functools.partial(nearest_hit_kd_kernel, scene.wkd))(o, d)
    want = nearest_hit_brute(o, d, scene.vertices)
    assert_same_hits(verts, o, d, got, want, rtol=1e-4)
