"""Interactive progressive-rendering session (headless).

Capability-equivalent of the reference's GLFW window loop (main.cu:114-155
+ camera_movement, camera.cuh:28-100): a stateful session that accumulates
one sample per step, restarts accumulation on any camera input, and exposes
the tonemapped running average at every moment. Rendering backends (matplotlib
window, notebook display, terminal preview) can wrap this; the core loop is
display-agnostic because interactive display is not an accelerator-host capability
(SURVEY.md section 2.2: "headless render-to-PNG is the core path").
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import jax
import numpy as np

from isaklm_raytracer_tpu.camera.camera import Camera, camera_movement
from isaklm_raytracer_tpu.config import RenderConfig
from isaklm_raytracer_tpu.integrator.render import (
    make_trace_fn,
    render_step,
    resolve_image,
)
from isaklm_raytracer_tpu.scene.types import GBuffer, Scene


class InteractiveSession:
    """Progressive render session with reference input semantics."""

    def __init__(
        self,
        scene: Scene,
        camera: Camera,
        config: RenderConfig,
        seed: int = 0,
        adaptive: bool = True,
    ) -> None:
        self.scene = scene
        self.camera = camera
        self.config = config
        self.adaptive = adaptive
        self._base_key = jax.random.PRNGKey(seed)
        self._sample = 0
        self._last_time: Optional[float] = None
        self.gbuffer = GBuffer.create(config.num_pixels)
        trace_fn = make_trace_fn(scene, config)

        import functools

        @functools.partial(
            jax.jit, static_argnames=("adaptive_",), donate_argnums=(0,)
        )
        def _step(gb, cam, key, adaptive_):
            return render_step(scene, cam, gb, key, config, adaptive_, trace_fn)

        self._step = _step

    @property
    def sample_count(self) -> int:
        """Progressive frame counter (main.cu:124: sample_count)."""
        return self._sample

    def handle_input(self, keys: Iterable[str], time_step: Optional[float] = None):
        """Apply movement keys; any input resets accumulation
        (camera.cuh:38-98 zero sample_count)."""
        now = time.monotonic()
        if time_step is None:
            time_step = 0.0 if self._last_time is None else now - self._last_time
        self._last_time = now
        self.camera, moved = camera_movement(self.camera, keys, time_step)
        if moved:
            self.reset()
        return moved

    def reset(self) -> None:
        """Zero the accumulators (reset_frame, render.cuh:18-34)."""
        self.gbuffer = self.gbuffer.reset()
        self._sample = 0

    def step(self, keys: Iterable[str] = ()) -> None:
        """One frame: input -> render one progressive sample
        (call_render, main.cu:20-59)."""
        if keys:
            self.handle_input(keys)
        key = jax.random.fold_in(self._base_key, self._sample)
        self.gbuffer = self._step(self.gbuffer, self.camera, key, self.adaptive)
        self._sample += 1

    def image(self) -> np.ndarray:
        """Current tonemapped average, (H, W, 3) float in [0,1]
        (draw_frame, render.cuh:37-59)."""
        return np.asarray(resolve_image(self.gbuffer, self.config))

    def converged(self) -> bool:
        from isaklm_raytracer_tpu.integrator.adaptive import needs_sample

        counts = np.asarray(self.gbuffer.count)
        if counts.min() < self.config.min_samples:
            return False
        return not bool(np.asarray(needs_sample(self.gbuffer, self.config)).any())

    def run(self, max_samples: Optional[int] = None, save_path: Optional[str] = None):
        """Headless main loop: render until MAX_SAMPLES or convergence, then
        optionally save the PNG (main.cu:114-132)."""
        limit = max_samples or self.config.max_samples
        while self._sample < limit and not (self.adaptive and self.converged()):
            self.step()
        if save_path:
            from isaklm_raytracer_tpu.io.png import save_png

            save_png(save_path, self.image())
        return self.image()
