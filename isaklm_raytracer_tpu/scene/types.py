"""Device-resident scene model as struct-of-arrays JAX pytrees.

Redesign of the reference's device structs (scene.cuh:65-121):

  - The reference embeds a full Material BY VALUE in every Triangle
    (scene.cuh:76-82) -- cache-hostile and non-differentiable as a parameter
    set. Here materials live in a compact `MaterialTable` (the differentiable
    parameter pytree) and triangles carry an int32 material index; semantics
    are identical.
  - Textures become one flat atlas buffer + per-texture (offset, w, h), so a
    single gather serves any texture (no pointers, XLA-friendly).
  - The per-pixel accumulators (screen.cuh:15-46: frame_buffer,
    squared_luminance, sample_count) become the `GBuffer` pytree; RNG state
    is NOT stored -- randomness is counter-based (threefry) keyed on
    (seed, sample index, pixel), deterministic under any sharding.

All "count" information is carried by static array shapes.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from isaklm_raytracer_tpu import pytree


@pytree.dataclass
class MaterialTable:
    """Differentiable material parameters (reference Material, scene.cuh:65-74).

    Shapes: albedo/emittance (M, 3); roughness/ior/extinction/transparent (M,);
    tex_id (M,) int32, -1 = no texture. `transparent` is {0.,1.} float so the
    table is one homogeneous differentiable pytree (it gates a discrete branch
    and receives zero gradient).
    """

    albedo: jnp.ndarray
    emittance: jnp.ndarray
    roughness: jnp.ndarray
    ior: jnp.ndarray
    extinction: jnp.ndarray
    transparent: jnp.ndarray
    tex_id: jnp.ndarray

    @staticmethod
    def stack(mats: list[dict]) -> "MaterialTable":
        """Build from a list of material dicts (parser output).

        Leaves are HOST numpy arrays: scene construction stays device-free
        (no H2D or D2H round trips while assembling/ordering geometry);
        accel.prepare_scene device_puts the finished Scene once."""

        def col(key, default, dim=None):
            rows = []
            for m in mats:
                v = m.get(key, default)
                rows.append(v)
            return np.asarray(rows, np.float32 if key != "tex_id" else np.int32)

        return MaterialTable(
            albedo=col("albedo", (0.0, 0.0, 0.0)),
            emittance=col("emittance", (0.0, 0.0, 0.0)),
            roughness=col("roughness", 0.0),
            ior=col("ior", 0.0),
            extinction=col("extinction", 0.0),
            transparent=col("transparent", 0.0),
            tex_id=col("tex_id", -1),
        )


@pytree.dataclass
class TextureAtlas:
    """All textures in one flat RGB buffer (reference Texture, scene.cuh:16-23).

    buffer: (P, 3) float32 in [0,1] (uchar/255, scene.cuh:43-53 +
    trace_ray.cuh:45). offset/width/height: (T,) int32. A scene with no
    textures carries a 1-texel dummy so shapes stay non-empty.
    """

    buffer: jnp.ndarray
    offset: jnp.ndarray
    width: jnp.ndarray
    height: jnp.ndarray

    @staticmethod
    def empty() -> "TextureAtlas":
        return TextureAtlas(
            buffer=jnp.ones((1, 3), jnp.float32),
            offset=jnp.zeros((1,), jnp.int32),
            width=jnp.ones((1,), jnp.int32),
            height=jnp.ones((1,), jnp.int32),
        )


@pytree.dataclass
class KDTreeArrays:
    """Flattened KD tree (reference KD_Tree/KD_Tree_Node, scene.cuh:84-112).

    The unioned node struct becomes parallel arrays: for inner nodes
    (child_a, child_b) are child indices; for leaves they are
    (index_offset, triangle_count). DFS order, root = 0
    (create_kd_tree.cuh:267-328).
    """

    child_a: jnp.ndarray  # (K,) int32: child_index1 | index_offset
    child_b: jnp.ndarray  # (K,) int32: child_index2 | triangle_count
    axis: jnp.ndarray  # (K,) int32 in {0,1,2}
    plane: jnp.ndarray  # (K,) float32
    is_leaf: jnp.ndarray  # (K,) bool
    tri_indices: jnp.ndarray  # (I,) int32 into triangle arrays
    bbox_min: jnp.ndarray  # (3,) float32 (root bbox, +/- 0.01 pad)
    bbox_max: jnp.ndarray  # (3,) float32
    max_depth: int = pytree.field(pytree_node=False, default=19)


@pytree.dataclass
class Scene:
    """Full device scene (reference Scene, scene.cuh:114-121).

    vertices: (N, 3, 3) f32 -- triangle corner positions [tri, corner, xyz]
    normals:  (N, 3, 3) f32 -- per-corner shading normals
    uvs:      (N, 3, 2) f32 -- per-corner texture coordinates
    mat_id:   (N,) int32 into `materials`
    light_indices: (L,) int32 -- triangles with any emittance channel > 0
      (create_scene.cuh:40-50)
    """

    vertices: jnp.ndarray
    normals: jnp.ndarray
    uvs: jnp.ndarray
    mat_id: jnp.ndarray
    light_indices: jnp.ndarray
    materials: MaterialTable
    textures: TextureAtlas
    kd: Optional[KDTreeArrays] = None
    # Batched-traversal re-layout (accel.wavefront.WavefrontKD); typed Any
    # to avoid a scene<->accel import cycle.
    wkd: Optional[object] = None
    # Packed per-triangle shading row (T, 32) f32:
    # [p1 p2 p3 | n1 n2 n3 | uv1 uv2 uv3 | mat_id | pad...] -- lets
    # hit_attributes fetch everything with ONE row gather instead of five
    # strided ones. Geometry is a scene constant, so baking it loses no
    # gradients; material parameters stay in `materials` (the
    # differentiable path).
    shade_table: Optional[jnp.ndarray] = None
    has_lights: bool = pytree.field(pytree_node=False, default=True)

    @property
    def num_triangles(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_indices.shape[0]


@pytree.dataclass
class GBuffer:
    """Per-pixel progressive accumulators (reference G_Buffer, screen.cuh:15-46).

    frame: (H*W, 3) running radiance sum; sq_luminance: (H*W,) running sum of
    squared sample luminance; count: (H*W,) int32 per-pixel sample counts
    (pixels converge at different rates under adaptive sampling).
    """

    frame: jnp.ndarray
    sq_luminance: jnp.ndarray
    count: jnp.ndarray

    @staticmethod
    def create(num_pixels: int) -> "GBuffer":
        return GBuffer(
            frame=jnp.zeros((num_pixels, 3), jnp.float32),
            sq_luminance=jnp.zeros((num_pixels,), jnp.float32),
            count=jnp.zeros((num_pixels,), jnp.int32),
        )

    def reset(self) -> "GBuffer":
        """Zero all accumulators (reference reset_frame, render.cuh:18-34)."""
        return GBuffer.create(self.frame.shape[0])


def build_scene(
    vertices: np.ndarray,
    normals: np.ndarray,
    uvs: np.ndarray,
    mat_id: np.ndarray,
    materials: MaterialTable,
    textures: Optional[TextureAtlas] = None,
) -> Scene:
    """Assemble a Scene; scans emissive materials for light triangles
    (reference create_scene.cuh:40-66)."""
    mat_id = np.asarray(mat_id, np.int32)
    emittance = np.asarray(materials.emittance)
    is_light = (emittance[mat_id] > 0.0).any(axis=-1)
    light_indices = np.nonzero(is_light)[0].astype(np.int32)
    has_lights = light_indices.size > 0
    if not has_lights:
        # Keep a non-empty array for static shapes; NEE is disabled by the
        # integrator when the scene has no real lights (has_lights=False).
        light_indices = np.zeros((1,), np.int32)
    # HOST numpy leaves throughout: assembling, renumbering and accel
    # builds all happen on the host; accel.prepare_scene device_puts the
    # finished Scene once (no per-stage round trips).
    return Scene(
        vertices=np.asarray(vertices, np.float32),
        normals=np.asarray(normals, np.float32),
        uvs=np.asarray(uvs, np.float32),
        mat_id=mat_id,
        light_indices=light_indices,
        materials=materials,
        textures=textures if textures is not None else TextureAtlas.empty(),
        has_lights=has_lights,
    )


def sample_texture(
    textures: TextureAtlas, tex_id: jnp.ndarray, color: jnp.ndarray, uv: jnp.ndarray
) -> jnp.ndarray:
    """Nearest-neighbor, wrap-mode texture lookup times material color.

    Matches sample_texture (trace_ray.cuh:31-46): uv wrapped by mod 1,
    pixel = int(v*h)*w + int(u*w), texel/255 * color; no texture -> color.
    tex_id: (...,) int32; color: (..., 3); uv: (..., 2).
    """
    valid = tex_id >= 0
    safe_id = jnp.maximum(tex_id, 0)
    w = jnp.asarray(textures.width)[safe_id]
    h = jnp.asarray(textures.height)[safe_id]
    off = jnp.asarray(textures.offset)[safe_id]
    u = jnp.mod(uv[..., 0], 1.0)
    v = jnp.mod(uv[..., 1], 1.0)
    px = (v * h.astype(jnp.float32)).astype(jnp.int32) * w + (
        u * w.astype(jnp.float32)
    ).astype(jnp.int32)
    texel = jnp.asarray(textures.buffer)[off + px]
    return jnp.where(valid[..., None], texel * color, color)
