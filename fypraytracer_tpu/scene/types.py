"""Scene data model — dense SoA arrays, registered as JAX pytrees.

The reference already stores geometry as flat global arrays with
index-based triangles (Scene.h:23-56); this module keeps exactly that data
model but as immutable array bundles that can cross the jit boundary,
be donated, and be replicated across a device mesh.

All arrays may be numpy (host, during building) or jax (device).  Counts
are implied by shapes, so a compiled render specializes on scene size.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np

Array = Any


def _pytree_dataclass(cls=None, *, meta=()):
    """Register a frozen dataclass; ``meta`` fields are static (hashable)."""

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        fields = [f.name for f in dataclasses.fields(c) if f.name not in meta]
        jax.tree_util.register_dataclass(c, data_fields=fields, meta_fields=list(meta))
        return c

    return wrap(cls) if cls is not None else wrap


@_pytree_dataclass
class MaterialTable:
    """Material SoA (Material.cuh:7-21).

    emission(i) = emission_color[i] * emission_power[i] (Material.cu:5-18).
    ``albedo_map`` is an index into the texture atlas, -1 = untextured
    (isUseAlbedoMap equivalent).
    """

    albedo: Array          # (M, 3) f32
    roughness: Array       # (M,)   f32
    metallic: Array        # (M,)   f32
    emission_color: Array  # (M, 3) f32
    emission_power: Array  # (M,)   f32
    albedo_map: Array      # (M,)   i32, -1 = none

    def emission(self, xp=None):
        return self.emission_color * self.emission_power[..., None]


@_pytree_dataclass
class Geometry:
    """World-space triangle soup (Scene.h:27-37 equivalents).

    Vertices are pre-baked to world space (the reference's ``worldVertices``
    discipline, Scene.cpp:42-51); local vertices + per-mesh transforms live
    host-side in the builder for incremental updates.
    """

    positions: Array   # (V, 3) f32  world-space
    normals: Array     # (V, 3) f32  world-space unit
    uvs: Array         # (V, 2) f32
    tri_v: Array       # (T, 3) i32  vertex indices
    tri_mat: Array     # (T,)   i32  material index


@_pytree_dataclass(meta=("leaf_size",))
class FlatBVH:
    """Stackless threaded BVH in preorder (flat array layout).

    Semantics replace the reference's node+stack traversal
    (BVH.cuh:27-69, Renderer.cu:460-561) with skip links:
      * nodes are stored in depth-first preorder;
      * on AABB hit at an inner node, traversal falls through to ``i+1``;
      * on miss (or after a leaf), it jumps to ``miss[i]``; ``miss == N``
        terminates.
      * ``first[i] >= 0`` marks a leaf owning primitives
        ``prim_idx[first[i] : first[i] + count[i]]`` (count ≤ leaf_size,
        padded slots hold -1).

    A two-level TLAS/BLAS build is flattened into this single array at
    scene-compile time (see accel/bvh.py), keeping per-mesh rebuilds cheap
    while the hot loop stays a single ``while_loop`` of gathers.
    """

    lo: Array        # (N, 3) f32 AABB lower
    hi: Array        # (N, 3) f32 AABB upper
    miss: Array      # (N,)   i32 skip link (N = done)
    first: Array     # (N,)   i32 leaf primitive slot start, -1 = inner
    count: Array     # (N,)   i32 leaf primitive count (0 for inner)
    prim_idx: Array  # (P,)   i32 triangle ids, padded with -1
    leaf_size: int = 4  # static: slots per leaf (meta field)


@_pytree_dataclass(meta=("max_depth",))
class LightTreeArrays:
    """Flat light tree (LightTree.cuh:28-49 node fields, SoA).

    Stored in preorder with explicit child links for binary importance
    descent (PickLight, LightTree.cu:4-154).  Leaves reference global
    triangle ids (the reference's convention, Mesh.cpp:187,203).
    ``leaf_of_tri`` inverts leaf lookup for PMF replay, replacing the
    reference's linear scans (LightTree.cu:156-191).
    """

    energy: Array      # (N,)   f32
    axis: Array        # (N, 3) f32 orientation cone axis
    theta_o: Array     # (N,)   f32
    theta_e: Array     # (N,)   f32
    box_lo: Array      # (N, 3) f32 spatial bounds
    box_hi: Array      # (N, 3) f32
    left: Array        # (N,)   i32 child index, -1 for leaf
    right: Array       # (N,)   i32 child index, -1 for leaf
    tri: Array         # (N,)   i32 global triangle id at leaves, -1 inner
    parent: Array      # (N,)   i32 parent index, -1 at root
    leaf_of_tri: Array  # (T,)  i32 leaf node id per triangle, -1 if none
    max_depth: int = 1  # static: tree depth bound for fixed-length descent


@_pytree_dataclass
class TextureAtlas:
    """All textures packed into one array for single-source gathers.

    ``pages``: (K, H, W, 3) f32 RGB in [0,1] — the full-detail mip-0 level
    (textures smaller than the page are bilinearly resampled up so per-ray
    texture ids stay a single gather axis, SURVEY.md §7 hard-part #5).
    ``size``: (K, 2) i32 original (w, h) for exact bilinear footprints.
    ``bounce_pages``: (K, hb, wb, 3) f32 box-filtered minified level.

    Sampling policy (shared by EVERY render path so they stay bit-matched):
    primary/visible-point fetches read ``pages`` at full detail; fetches at
    secondary bounce hits read ``bounce_pages``.  Secondary-ray footprints
    span many texels (diffuse scatter), so a prefiltered level is the
    correct minification — the reference samples mip 0 everywhere
    (Texture.cu:94-139, no mip chain) and aliases under minification; this
    is a documented fix, not a quirk reproduction.  ``bounce_pages`` is
    a small fixed size, so secondary fetches gather from a table that
    stays cache-resident.
    """

    pages: Array  # (K, H, W, 3) f32
    size: Array   # (K, 2) i32
    bounce_pages: Array = None  # (K, hb, wb, 3) f32; None -> use pages


@_pytree_dataclass
class Scene:
    """The complete device-resident scene."""

    geometry: Geometry
    materials: MaterialTable
    bvh: FlatBVH
    light_tree: LightTreeArrays
    emissive_tris: Array  # (E,) i32 global triangle ids (Scene.cpp:209-221)
    textures: TextureAtlas

    @property
    def num_triangles(self) -> int:
        return self.geometry.tri_v.shape[0]

    @property
    def num_emissive(self) -> int:
        return self.emissive_tris.shape[0]

    def device_put(self, sharding=None) -> "Scene":
        """Upload every leaf to device (replicated under ``sharding``)."""
        leaves, treedef = jax.tree_util.tree_flatten(self)
        if sharding is None:
            leaves = [jax.device_put(np.asarray(x)) for x in leaves]
        else:
            leaves = [jax.device_put(np.asarray(x), sharding) for x in leaves]
        return jax.tree_util.tree_unflatten(treedef, leaves)
