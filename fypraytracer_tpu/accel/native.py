"""ctypes bindings for the native C++ structure builders (native/builders.cpp).

Compiles the shared library on first use (g++ -O3) and caches it beside
the source; every entry point falls back to the NumPy builders on any
failure, so the native path is a pure build-throughput optimization — the
same role the reference's C++/OpenMP builders play (BVH.cpp, LightTree.cpp,
SURVEY.md §2.7 last row).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from fypraytracer_tpu.scene.types import FlatBVH, LightTreeArrays

_LIB = None
_LIB_FAILED = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "builders.cpp")
_SO = os.path.join(os.path.dirname(_SRC), "libbuilders.so")

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C")


def _load():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            # build beside the target, then rename: concurrent processes
            # (parallel test workers) never load a half-written library
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True, capture_output=True, timeout=300)
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        lib.build_scene_bvh.restype = ctypes.c_int
        lib.build_scene_bvh.argtypes = [
            _f32p, _f32p, ctypes.c_int64, _i64p, ctypes.c_int, ctypes.c_int,
            _f32p, _f32p, _i32p, _i32p, _i32p, _i32p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.build_light_tree.restype = ctypes.c_int
        lib.build_light_tree.argtypes = [
            _f32p, _i32p, ctypes.c_int64, _f32p, _i64p, ctypes.c_int,
            _f32p, _f32p, _f32p, _f32p, _f32p, _f32p,
            _i32p, _i32p, _i32p, _i32p, _i32p,
            ctypes.POINTER(ctypes.c_int64)]
        _u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [_u8p, _u8p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int]
        _LIB = lib
    except Exception:
        _LIB_FAILED = True
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def build_scene_bvh_native(tri_lo, tri_hi, mesh_tri_ranges, leaf_size=4):
    """Native two-level BVH; returns FlatBVH or None on failure."""
    lib = _load()
    if lib is None:
        return None
    n_tris = len(tri_lo)
    n_meshes = len(mesh_tri_ranges)
    if n_tris == 0:
        return None
    ranges = np.asarray(mesh_tri_ranges, np.int64).reshape(-1)
    max_nodes = 2 * n_tris + 2 * n_meshes + 2
    max_slots = (n_tris + n_meshes + 1) * leaf_size

    lo = np.empty((max_nodes, 3), np.float32)
    hi = np.empty((max_nodes, 3), np.float32)
    miss = np.empty(max_nodes, np.int32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    prim_idx = np.empty(max_slots, np.int32)
    n_nodes = ctypes.c_int64()
    n_slots = ctypes.c_int64()

    rc = lib.build_scene_bvh(
        np.ascontiguousarray(tri_lo, np.float32),
        np.ascontiguousarray(tri_hi, np.float32),
        n_tris, ranges, n_meshes, leaf_size,
        lo.reshape(-1), hi.reshape(-1), miss, first, count, prim_idx,
        ctypes.byref(n_nodes), ctypes.byref(n_slots))
    if rc != 0:
        return None
    n = n_nodes.value
    return FlatBVH(lo=lo[:n].copy(), hi=hi[:n].copy(), miss=miss[:n].copy(),
                   first=first[:n].copy(), count=count[:n].copy(),
                   prim_idx=prim_idx[:n_slots.value].copy(),
                   leaf_size=leaf_size)


def png_unfilter_native(raw: np.ndarray, height: int, stride: int,
                        bpp: int) -> np.ndarray | None:
    """Reconstruct PNG scanlines from the inflated IDAT stream (native/
    builders.cpp::png_unfilter); returns (height*stride,) uint8 or None."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(height * stride, np.uint8)
    rc = lib.png_unfilter(np.ascontiguousarray(raw, np.uint8), out,
                          height, stride, bpp)
    return out if rc == 0 else None


def build_light_tree_native(positions, tri_v, tri_mat, emission_per_mat,
                            mesh_tri_ranges):
    """Native SAOH light tree; returns LightTreeArrays or None."""
    lib = _load()
    if lib is None:
        return None
    n_tris = len(tri_v)
    emission_per_tri = emission_per_mat[tri_mat]
    norm = np.linalg.norm(emission_per_tri, axis=-1).astype(np.float32)
    n_emissive = int((norm > 0).sum())
    if n_emissive == 0:
        return None
    ranges = np.asarray(mesh_tri_ranges, np.int64).reshape(-1)
    max_nodes = 2 * n_emissive + 2 * len(mesh_tri_ranges) + 2

    energy = np.empty(max_nodes, np.float32)
    axis = np.empty((max_nodes, 3), np.float32)
    theta_o = np.empty(max_nodes, np.float32)
    theta_e = np.empty(max_nodes, np.float32)
    box_lo = np.empty((max_nodes, 3), np.float32)
    box_hi = np.empty((max_nodes, 3), np.float32)
    left = np.empty(max_nodes, np.int32)
    right = np.empty(max_nodes, np.int32)
    tri = np.empty(max_nodes, np.int32)
    parent = np.empty(max_nodes, np.int32)
    leaf_of_tri = np.empty(n_tris, np.int32)
    n_nodes = ctypes.c_int64()

    depth = lib.build_light_tree(
        np.ascontiguousarray(positions, np.float32).reshape(-1),
        np.ascontiguousarray(tri_v, np.int32).reshape(-1),
        n_tris, norm, ranges, len(mesh_tri_ranges),
        energy, axis.reshape(-1), theta_o, theta_e,
        box_lo.reshape(-1), box_hi.reshape(-1),
        left, right, tri, parent, leaf_of_tri,
        ctypes.byref(n_nodes))
    if depth <= 0:
        return None
    n = n_nodes.value
    return LightTreeArrays(
        energy=energy[:n].copy(), axis=axis[:n].copy(),
        theta_o=theta_o[:n].copy(), theta_e=theta_e[:n].copy(),
        box_lo=box_lo[:n].copy(), box_hi=box_hi[:n].copy(),
        left=left[:n].copy(), right=right[:n].copy(), tri=tri[:n].copy(),
        parent=parent[:n].copy(), leaf_of_tri=leaf_of_tri.copy(),
        max_depth=int(depth))
