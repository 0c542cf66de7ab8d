"""Differentiable pinhole + thin-aperture camera.

Reference: Camera struct and input handling (camera.cuh:15-100), primary-ray
construction (path_tracing.cuh:379-391), aperture sampling
(path_tracing.cuh:327-336). The pose (position, yaw, pitch) and optics
(fov, aperture_radius) are ordinary pytree leaves, so image gradients flow to
them through ray generation.
"""

from __future__ import annotations

from typing import Iterable

import jax.numpy as jnp

from isaklm_raytracer_tpu import pytree
from isaklm_raytracer_tpu.math import sampling, transforms


@pytree.dataclass
class Camera:
    """Pose + optics (reference camera.cuh:15-26)."""

    position: jnp.ndarray  # (3,)
    yaw: jnp.ndarray  # scalar
    pitch: jnp.ndarray  # scalar
    fov: jnp.ndarray  # scalar, radians (full horizontal FOV)
    aperture_radius: jnp.ndarray  # scalar

    @staticmethod
    def create(position, yaw=0.0, pitch=0.0, fov=jnp.pi / 2, aperture_radius=0.0):
        return Camera(
            position=jnp.asarray(position, jnp.float32),
            yaw=jnp.asarray(yaw, jnp.float32),
            pitch=jnp.asarray(pitch, jnp.float32),
            fov=jnp.asarray(fov, jnp.float32),
            aperture_radius=jnp.asarray(aperture_radius, jnp.float32),
        )

    def rotation(self) -> jnp.ndarray:
        """3x3 view rotation = rotation_matrix(yaw, pitch) (camera.cuh:22-25)."""
        return transforms.rotation_matrix(self.yaw, self.pitch)


def generate_rays(
    camera: Camera,
    width: int,
    height: int,
    pixel_x: jnp.ndarray,
    pixel_y: jnp.ndarray,
    uniforms: jnp.ndarray,
):
    """Primary rays for pixel coordinates with jitter + aperture.

    Matches path_tracing.cuh:379-391: direction = R @ normalize(
    [thf*(x+ux-W/2)/(W/2), thf*(y+uy-H/2)/(W/2), 1]) -- note BOTH axes are
    normalized by W/2 (x-normalized FOV), and W/2, H/2 use integer division
    like the CUDA macros. Origin = position + R@[ox,0,0] + R@[0,oy,0] with
    (ox, oy) a sqrt-warped disc sample of the aperture
    (path_tracing.cuh:327-336).

    pixel_x/pixel_y: (R,) int32; uniforms: (R, 4) in [0,1)
    (jitter_x, jitter_y, aperture_theta_u, aperture_r_u).
    Returns (origins (R,3), directions (R,3)).
    """
    half_w = float(width // 2)
    half_h = float(height // 2)
    thf = jnp.tan(camera.fov / 2.0)
    rot = camera.rotation()

    x = pixel_x.astype(jnp.float32) + uniforms[..., 0]
    y = pixel_y.astype(jnp.float32) + uniforms[..., 1]

    dirs = jnp.stack(
        [
            thf * (x - half_w) / half_w,
            thf * (y - half_h) / half_w,
            jnp.ones_like(x),
        ],
        axis=-1,
    )
    dirs = transforms.normalize(dirs)
    dirs = dirs @ rot.T

    ox, oy = sampling.disc_aperture(
        uniforms[..., 2], uniforms[..., 3], camera.aperture_radius
    )
    offset = jnp.stack([ox, oy, jnp.zeros_like(ox)], axis=-1) @ rot.T
    origins = camera.position + offset
    return origins, dirs


# Key names accepted by camera_movement, mirroring camera.cuh:34-99.
_MOVE_KEYS = {
    "w": jnp.array([0.0, 0.0, 1.0]),
    "a": jnp.array([-1.0, 0.0, 0.0]),
    "s": jnp.array([0.0, 0.0, -1.0]),
    "d": jnp.array([1.0, 0.0, 0.0]),
}


def camera_movement(camera: Camera, keys: Iterable[str], time_step: float):
    """Headless equivalent of the GLFW input handler (camera.cuh:28-100).

    WASD move in the view frame, space/shift move world up/down
    (speed 0.5/s), arrows rotate (2 rad/s). Returns (new_camera, moved):
    any pressed key invalidates the progressive accumulation exactly as the
    reference zeroes sample_count.
    """
    keys = set(keys)
    movement_speed = 0.5 * time_step
    rotation_speed = 2.0 * time_step

    position = camera.position
    yaw = camera.yaw
    pitch = camera.pitch
    moved = False

    motion = None
    rot = camera.rotation()
    for key, local in _MOVE_KEYS.items():
        if key in keys:
            motion = (rot @ local) * movement_speed
            moved = True
    if "space" in keys:
        motion = jnp.array([0.0, 1.0, 0.0]) * movement_speed
        moved = True
    if "shift" in keys:
        motion = jnp.array([0.0, -1.0, 0.0]) * movement_speed
        moved = True
    if motion is not None:
        position = position + motion

    if "left" in keys:
        yaw = yaw - rotation_speed
        moved = True
    if "right" in keys:
        yaw = yaw + rotation_speed
        moved = True
    if "up" in keys:
        pitch = pitch - rotation_speed
        moved = True
    if "down" in keys:
        pitch = pitch + rotation_speed
        moved = True

    return camera.replace(position=position, yaw=yaw, pitch=pitch), moved
