from isaklm_raytracer_tpu.accel.traverse import (
    HitAttributes,
    hit_attributes,
    nearest_hit_brute,
)
from isaklm_raytracer_tpu.accel.kdtree import build_kd_tree
from isaklm_raytracer_tpu.accel.cluster import cluster_order, morton_order
from isaklm_raytracer_tpu.accel.wavefront import (
    WavefrontKD,
    build_wavefront_kd,
    nearest_hit_wavefront,
)


def prepare_scene(scene, max_depth: int = 19, leaf_size: int = 7,
                  leaf_width: int = 8):
    """Build every acceleration structure for a Scene.

    1. Renumbers the triangles spatially (accel.cluster.cluster_order);
       all per-triangle arrays and the light list are permuted
       consistently, so ids stay coherent across the whole framework.
    2. Packs the per-triangle shading rows (Scene.shade_table).
    3. Builds the KD tree (create_kd_tree.cuh) and its chunked leaf layout
       (accel.wavefront.WavefrontKD), which every KD intersector walks. The
       tree is built at every scene size: the native builder takes seconds
       even at the 2M-triangle hero size, and without it a trace falls to
       brute force.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    verts = np.asarray(scene.vertices)
    order = cluster_order(verts)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)

    lights = np.sort(inv[np.asarray(scene.light_indices)]).astype(np.int32)
    scene = scene.replace(
        vertices=np.asarray(scene.vertices)[order],
        normals=np.asarray(scene.normals)[order],
        uvs=np.asarray(scene.uvs)[order],
        mat_id=np.asarray(scene.mat_id)[order],
        light_indices=lights,
    )

    verts = verts[order]
    num = verts.shape[0]
    table = np.zeros((num, 32), np.float32)
    table[:, 0:9] = verts.reshape(num, 9)
    table[:, 9:18] = np.asarray(scene.normals).reshape(num, 9)
    table[:, 18:24] = np.asarray(scene.uvs).reshape(num, 6)
    table[:, 24] = np.asarray(scene.mat_id)
    kd = build_kd_tree(verts, max_depth, leaf_size)
    wkd = build_wavefront_kd(kd, verts, leaf_width)
    scene = scene.replace(shade_table=table, kd=kd, wkd=wkd)
    # ONE host->device conversion for the finished scene (host-side numpy
    # leaves from build_scene; see scene.types.build_scene).
    return jax.tree.map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, scene
    )


__all__ = [
    "HitAttributes",
    "WavefrontKD",
    "build_kd_tree",
    "build_wavefront_kd",
    "cluster_order",
    "hit_attributes",
    "morton_order",
    "nearest_hit_brute",
    "nearest_hit_wavefront",
    "prepare_scene",
]
