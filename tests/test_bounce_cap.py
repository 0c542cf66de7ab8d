"""Quantify the max_bounces truncation bias (VERDICT round 2, item #7).

The reference's path loop is unbounded -- only Russian roulette terminates
paths (path_tracing.cuh:279-319). The wavefront loop needs a static
bound (config.max_bounces, default 24). Because RR reweights survivors,
the bounded estimator differs from the unbounded one ONLY by truncation of
paths that survive past the cap: with counter-mode per-(pixel, sample,
bounce) RNG the first k bounces of a path are bit-identical under any cap
>= k, so raising the cap can only ADD non-negative radiance. These tests
pin that monotonicity and measure the residual bias on the worst case
(glass interior: specular weight forced to 1, throughput ~0.995, RR kills
slowly) to justify the default.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isaklm_raytracer_tpu.camera import Camera
from isaklm_raytracer_tpu.config import RenderConfig
from isaklm_raytracer_tpu.integrator.render import render_sample
from isaklm_raytracer_tpu.scene.procedural import glass_box_scene

CAPS = (8, 16, 24, 48)
SPP = 8


@pytest.fixture(scope="module")
def mean_luminance_by_cap():
    scene = glass_box_scene(subdiv=2)
    camera = Camera.create((0.0, 0.0, -0.92), fov=jnp.pi / 2)
    key = jax.random.PRNGKey(11)
    means = {}
    for cap in CAPS:
        config = RenderConfig(width=16, height=16, max_bounces=cap)
        acc = 0.0
        for s in range(SPP):
            rad = render_sample(scene, camera, jax.random.fold_in(key, s), config)
            acc += float(jnp.mean(rad))
        means[cap] = acc / SPP
    return means


def test_cap_monotone_nondecreasing(mean_luminance_by_cap):
    """Same keys, longer cap => strictly more (or equal) radiance: the
    bounded loop is a pure truncation of the unbounded reference
    estimator, never a re-randomization."""
    m = mean_luminance_by_cap
    for lo, hi in zip(CAPS, CAPS[1:]):
        assert m[hi] >= m[lo] - 1e-6, (
            f"cap {hi} lost energy vs {lo}: {m[hi]:.6f} < {m[lo]:.6f}"
        )


def test_default_cap_bias_is_small(mean_luminance_by_cap):
    """The default cap (24) must capture nearly all the energy the 2x cap
    finds, even on the glass-dominated worst case; the remaining tail is
    the documented truncation bias of the wavefront formulation."""
    m = mean_luminance_by_cap
    rel_24 = (m[48] - m[24]) / max(m[48], 1e-9)
    rel_8 = (m[48] - m[8]) / max(m[48], 1e-9)
    # cap=8 must measurably truncate (the scene exercises deep chains) ...
    assert rel_8 > rel_24
    # ... while the default cap's residual vs 2x-cap is under 2%.
    assert rel_24 < 0.02, (
        f"max_bounces=24 loses {rel_24:.1%} vs cap 48 "
        f"(caps: { {k: round(v, 5) for k, v in m.items()} })"
    )
