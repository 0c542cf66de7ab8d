"""Wavefront path tracing: a bounded `lax.scan` over bounces with masks.

Wavefront re-derivation of the reference megakernel loop `trace_path`
(path_tracing.cuh:268-325). The reference runs an unbounded per-thread
`while` with divergent control flow; here all lanes step through the same
bounded bounce loop with an active mask -- Russian roulette kills lanes
exactly as the reference does (path_tracing.cuh:309-318), so with a
sufficiently high static cap the estimators agree (RR reweighting keeps the
estimate unbiased regardless of where the cap lands; see RenderConfig).

Estimator bookkeeping preserved exactly:
  - emitted radiance is added only when the PREVIOUS event was not diffuse,
    avoiding double counting against NEE (path_tracing.cuh:285-288);
  - after a diffuse event, NEE contribution is weighted by the throughput
    INCLUDING the new diffuse albedo weight (path_tracing.cuh:296-301);
  - miss terminates the path with a black background
    (path_tracing.cuh:303-306);
  - RR survival probability = max throughput channel, reweight 1/p
    (path_tracing.cuh:309-318).

Randomness: each ray carries a uint32 root seed derived from the GLOBAL
pixel index (see integrator.render.ray_keys); per-bounce variates come
from the counter-based sampler math.rng (stream = bounce) -- so the
sample sequence of a pixel is a pure function of (seed, sample index,
pixel id), independent of how rays are sharded across devices or reordered
by compaction. This is the stateless replacement for the reference's
per-pixel mutable hash state (path_tracing.cuh:34-43, screen.cuh:34-45);
jax.random threefry was measured ~15x more expensive here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from isaklm_raytracer_tpu.accel.traverse import hit_attributes
from isaklm_raytracer_tpu.config import RenderConfig
from isaklm_raytracer_tpu.integrator.bsdf import scatter
from isaklm_raytracer_tpu.integrator.nee import sample_direct_light
from isaklm_raytracer_tpu.math import rng
from isaklm_raytracer_tpu.scene.types import Scene


def trace_paths(
    scene: Scene,
    trace_fn,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    key_data: jnp.ndarray,
    ray_ids: jnp.ndarray,
    config: RenderConfig,
) -> jnp.ndarray:
    """Trace one full path per ray; returns outgoing radiance (R, 3).

    trace_fn(o, d) -> (t, idx, hit): pluggable nearest-hit intersector.
    key_data: (2,) uint32 per-sample key (integrator.render.sample_key_data);
    ray_ids: (R,) global pixel ids (the RNG counter words).
    """
    num_rays = origins.shape[0]

    def bounce_step(state, bounce):
        (ray_o, ray_d, throughput, radiance, inside, prev_diffuse, active) = state

        u = rng.uniforms(key_data, ray_ids, bounce, 9)  # (9, R)

        t, idx, hit = trace_fn(ray_o, ray_d, active=active)
        attrs = hit_attributes(scene, ray_o, ray_d, idx, hit)

        live = active & hit

        # Emittance pickup for non-diffuse previous events
        # (path_tracing.cuh:285-288).
        emit_mask = live & (~prev_diffuse)
        radiance = radiance + jnp.where(
            emit_mask[:, None], attrs.emittance * throughput, 0.0
        )

        event = scatter(
            attrs, ray_d, inside, u[0], u[1], u[2], u[3], u[4],
            lobe_ratio_grad=config.lobe_ratio_grad,
        )
        new_throughput = throughput * event.weight

        if scene.has_lights:
            nee_mask = live & event.is_diffuse
            direct = sample_direct_light(
                scene, attrs.position, attrs.normal, u[5], u[6], u[7], trace_fn,
                active=nee_mask,
            )
            radiance = radiance + jnp.where(
                nee_mask[:, None], direct * new_throughput, 0.0
            )

        # Russian roulette (path_tracing.cuh:309-318). Note the reference
        # divides by the raw max channel even when it exceeds 1; replicated.
        # Bounces below rr_start_bounce skip RR entirely (neither kill nor
        # reweight) -- used to make the estimator smooth for FD checks.
        # Survival is DETACHED in both the kill test and the reweight: a RR
        # estimator whose threshold and 1/p factor share the same detached p
        # has gradient E[dw/p_det * 1{u<p_det}] = dw -- unbiased -- whereas a
        # live p would leave an uncancelled -w dp/p^2 reparameterized term
        # (the matching flip term is invisible to autodiff). Forward values
        # are unchanged.
        survival = jax.lax.stop_gradient(jnp.max(new_throughput, axis=-1))
        apply_rr = bounce >= config.rr_start_bounce
        rr_alive = (u[8] <= survival) | (~apply_rr)
        new_throughput = jnp.where(
            (apply_rr & rr_alive)[:, None],
            new_throughput / jnp.maximum(survival, 1e-30)[:, None],
            new_throughput,
        )

        next_active = live & rr_alive
        ray_o = jnp.where(live[:, None], attrs.position, ray_o)
        ray_d = jnp.where(live[:, None], event.direction, ray_d)
        throughput = jnp.where(live[:, None], new_throughput, throughput)
        inside = jnp.where(live, event.inside_medium, inside)
        prev_diffuse = jnp.where(live, event.is_diffuse, prev_diffuse)

        return (
            (ray_o, ray_d, throughput, radiance, inside, prev_diffuse, next_active),
            None,
        )

    init = (
        origins,
        directions,
        jnp.ones((num_rays, 3), jnp.float32),
        jnp.zeros((num_rays, 3), jnp.float32),
        jnp.zeros((num_rays,), bool),
        jnp.zeros((num_rays,), bool),
        jnp.ones((num_rays,), bool),
    )
    final_state, _ = jax.lax.scan(
        bounce_step, init, jnp.arange(config.max_bounces, dtype=jnp.int32)
    )
    return final_state[3]
