"""Spatial renumbering of a scene's triangles.

`accel.prepare_scene` permutes every per-triangle array (and the light
list) by `cluster_order`, so that triangles close in space get close ids.
The golden images in tests/golden/ were rendered with this numbering: the
nearest-hit tie rule (lowest triangle id wins) makes the permutation part
of the rendered result.
"""

from __future__ import annotations

import numpy as np

CLUSTER_WIDTH = 128  # triangles per leaf of the median-split partition


def _morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 10-bit integer coords into a 30-bit Morton code."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def morton_order(vertices: np.ndarray) -> np.ndarray:
    """Morton-sort permutation of triangles by quantised centroid.

    Returns `order` (T,) int64 such that vertices[order] is Morton-ordered.
    The simpler alternative to `cluster_order`; whichever permutation is
    used must be applied to ALL per-triangle scene arrays so that triangle
    ids stay consistent everywhere.
    """
    vertices = np.asarray(vertices, np.float32)
    centroids = vertices.mean(axis=1)  # (T, 3)
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-12)
    q = np.clip(((centroids - lo) / span) * 1023.0, 0, 1023).astype(np.uint32)
    return np.argsort(_morton3(q[:, 0], q[:, 1], q[:, 2]), kind="stable")


def cluster_order(vertices: np.ndarray) -> np.ndarray:
    """Spatial median-split permutation: tighter groups than Morton slices.

    Recursive longest-axis median partition of the triangle centroids,
    with the left split size rounded up to a CLUSTER_WIDTH multiple so
    every leaf except the global tail holds exactly CLUSTER_WIDTH
    triangles; leaves are emitted in DFS order, so consecutive leaves are
    sibling subtrees with compact merged bboxes (Morton slices straddle
    code-curve jumps; median splits cannot).

    Drop-in replacement for `morton_order`: returns `order` (T,) such
    that vertices[order] is spatially packed.
    """
    verts = np.asarray(vertices, np.float32)
    cent = verts.mean(axis=1)  # (T, 3)
    total = cent.shape[0]
    out = np.empty(total, np.int64)
    pos = 0
    stack = [np.arange(total, dtype=np.int64)]
    while stack:
        idx = stack.pop()
        n = idx.size
        if n <= CLUSTER_WIDTH:
            out[pos:pos + n] = idx
            pos += n
            continue
        c = cent[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        left = -(-((n + 1) // 2) // CLUSTER_WIDTH) * CLUSTER_WIDTH
        part = np.argpartition(c[:, axis], left - 1)
        stack.append(idx[part[left:]])  # right pushed first ->
        stack.append(idx[part[:left]])  # left popped/emitted first (DFS)
    return out
