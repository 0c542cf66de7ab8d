"""Counter-mode Threefry-2x32 sampler for the wavefront integrator.

The reference advances one mutable uint32 per pixel with a multiply-xor
hash (path_tracing.cuh:34-43, seeded in screen.cuh:34-45). The wavefront
version must be stateless and order-independent (rays are sharded,
chunked and masked), so every variate is a pure function of

    (sample key, global pixel id, stream, dimension)

where stream = bounce index (or the camera stream) and the (pixel id,
stream*dim) pair forms the Threefry counter words. Threefry-2x32 is
adds/xors/rotates only, and one counter-form hash per variate replaces
per-ray `jax.vmap(fold_in)` key plumbing, which costs a full key
derivation per ray before a single variate is drawn.

This is the full 20-round Threefry-2x32 (same algorithm jax.random uses),
so statistical quality matches jax.random exactly; only the counter
assignment differs (global pixel id instead of array position, which is
what makes images identical under any sharding or chunking,
SURVEY.md section 2.3).
"""

from __future__ import annotations

import jax.numpy as jnp

# Stream ids: bounces use 0..MAX_STREAMS-1, the camera jitter stream is
# fixed below them.
CAMERA_STREAM = 255
_DIMS_PER_STREAM = 64  # max variate PAIRS per stream


def _rotl(x, r):
    return (x << r) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Random123). All args uint32 arrays."""
    ks0 = k0
    ks1 = k1
    ks2 = jnp.uint32(0x1BD11BDA) ^ k0 ^ k1
    x0 = x0 + ks0
    x1 = x1 + ks1

    def four(x0, x1, rots):
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        return x0, x1

    ra = (13, 15, 26, 6)
    rb = (17, 29, 16, 24)
    x0, x1 = four(x0, x1, ra)
    x0, x1 = x0 + ks1, x1 + ks2 + jnp.uint32(1)
    x0, x1 = four(x0, x1, rb)
    x0, x1 = x0 + ks2, x1 + ks0 + jnp.uint32(2)
    x0, x1 = four(x0, x1, ra)
    x0, x1 = x0 + ks0, x1 + ks1 + jnp.uint32(3)
    x0, x1 = four(x0, x1, rb)
    x0, x1 = x0 + ks1, x1 + ks2 + jnp.uint32(4)
    x0, x1 = four(x0, x1, ra)
    x0, x1 = x0 + ks2, x1 + ks0 + jnp.uint32(5)
    return x0, x1


def _to_unit(bits):
    # 24 high bits -> [0, 1): matches float32 mantissa, never returns 1.0.
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def uniforms(
    key_data: jnp.ndarray,
    pixel_ids: jnp.ndarray,
    stream,
    n: int,
) -> jnp.ndarray:
    """n uniform [0,1) variates per ray: (n, R) f32.

    key_data: (2,) uint32 per-sample key words (jax.random.key_data).
    pixel_ids: (R,) GLOBAL pixel/ray ids -- the counter word, so results
    are independent of sharding, chunking and ray order.
    stream: python int or traced int32 (bounce index / CAMERA_STREAM).
    """
    if n > 2 * _DIMS_PER_STREAM:
        raise ValueError(
            f"uniforms(n={n}) exceeds the stream's {2 * _DIMS_PER_STREAM} "
            "variates; counter words would collide with the next stream"
        )
    if isinstance(stream, int) and not (
        0 <= stream <= CAMERA_STREAM
    ):
        raise ValueError(f"stream {stream} outside [0, {CAMERA_STREAM}]")
    k0 = key_data[0].astype(jnp.uint32)
    k1 = key_data[1].astype(jnp.uint32)
    w0 = pixel_ids.astype(jnp.uint32)
    base = jnp.asarray(stream).astype(jnp.uint32) * jnp.uint32(_DIMS_PER_STREAM)
    rows = []
    for p in range(-(-n // 2)):
        w1 = jnp.broadcast_to(base + jnp.uint32(p), w0.shape)
        a, b = threefry2x32(k0, k1, w0, w1)
        rows.append(_to_unit(a))
        rows.append(_to_unit(b))
    return jnp.stack(rows[:n])
