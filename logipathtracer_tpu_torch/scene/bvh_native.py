"""ctypes bindings for the native C++ BVH builder (native/bvh_builder.cpp).

Carried over from the JAX package's module of the same name so that
this package never imports JAX; tests/test_torch_scene.py holds the
two copies to bit-identical output.

Compiled on demand with g++ (no pip deps; pybind11 not available in
this image — SURVEY.md environment notes).  Falls back silently to the
numpy builder when the toolchain is missing: both emit the same schema,
so callers can't tell them apart (scene/bvh.py docstring).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from logipathtracer_tpu_torch.scene.bvh import BVH

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "bvh_builder.cpp")


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            # The port's own git-ignored build directory: native/ is
            # shared with the JAX package and left untouched.
            build_dir = os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "build", "native")
            os.makedirs(build_dir, exist_ok=True)
            so = os.path.join(build_dir, "libbvh_builder.so")
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(_SRC)):
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-o", so, _SRC],
                    check=True, capture_output=True)
            lib = ctypes.CDLL(so)
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
            outs = [f32p, f32p, i32p, i32p,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32)]
            lib.lpt_build_bvh.restype = ctypes.c_int
            lib.lpt_build_bvh.argtypes = (
                [f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                + outs)
            lib.lpt_build_triangle_bvh.restype = ctypes.c_int
            lib.lpt_build_triangle_bvh.argtypes = (
                [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int] + outs)
            lib.lpt_build_triangle_sbvh.restype = ctypes.c_int
            lib.lpt_build_triangle_sbvh.argtypes = (
                [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, ctypes.c_int]
                + outs + [ctypes.POINTER(ctypes.c_int32)])
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def native_available() -> bool:
    return _load() is not None


def _out_buffers(n):
    cap = max(2 * n, 2)
    return (np.zeros((cap, 3), np.float32), np.zeros((cap, 3), np.float32),
            np.zeros((cap, 3), np.int32), np.zeros(n, np.int32),
            ctypes.c_int32(0), ctypes.c_int32(0))


def _pack(nodes_min, nodes_max, nodes_meta, prim_order, num_nodes,
          max_depth) -> BVH:
    m = num_nodes.value
    return BVH(nodes_min=nodes_min[:m].copy(), nodes_max=nodes_max[:m].copy(),
               nodes_meta=nodes_meta[:m].copy(), prim_order=prim_order,
               max_depth=int(max_depth.value))


def build_bvh_native(aabb_min, aabb_max, leaf_size: int = 4,
                     bins: int = 16) -> BVH:
    lib = _load()
    if lib is None:
        from logipathtracer_tpu_torch.scene.bvh import build_bvh
        return build_bvh(aabb_min, aabb_max, leaf_size, bins)
    n = np.asarray(aabb_min).shape[0]
    nmin, nmax, meta, order, nn, md = _out_buffers(n)
    rc = lib.lpt_build_bvh(
        np.ascontiguousarray(aabb_min, np.float32),
        np.ascontiguousarray(aabb_max, np.float32), n, leaf_size, bins,
        nmin, nmax, meta, order, ctypes.byref(nn), ctypes.byref(md))
    if rc != 0:
        raise RuntimeError(f"native BVH build failed (rc={rc})")
    return _pack(nmin, nmax, meta, order, nn, md)


def build_triangle_bvh_native(tri_pos, leaf_size: int = 4,
                              bins: int = 16) -> BVH:
    lib = _load()
    if lib is None:
        from logipathtracer_tpu_torch.scene.bvh import build_triangle_bvh
        return build_triangle_bvh(tri_pos, leaf_size, bins)
    tri = np.ascontiguousarray(tri_pos, np.float32).reshape(-1, 9)
    n = tri.shape[0]
    nmin, nmax, meta, order, nn, md = _out_buffers(n)
    rc = lib.lpt_build_triangle_bvh(
        tri, n, leaf_size, bins, nmin, nmax, meta, order,
        ctypes.byref(nn), ctypes.byref(md))
    if rc != 0:
        raise RuntimeError(f"native BVH build failed (rc={rc})")
    return _pack(nmin, nmax, meta, order, nn, md)


def build_triangle_sbvh_native(tri_pos, leaf_size: int = 4,
                               bins: int = 16, min_overlap: float = 1e-5,
                               max_dup: float = 2.0) -> BVH:
    """SBVH with spatial splits (lsg::bvh::SplitBVHBuilder quality,
    src/PTSceneConverter.cpp:97-98).  prim_order may contain DUPLICATE
    triangle ids (straddling triangles clipped into both children);
    downstream code materializes the duplicates when reordering the
    soup.  Falls back to the plain SAH builder when the native
    toolchain is missing."""
    lib = _load()
    tri = np.ascontiguousarray(tri_pos, np.float32).reshape(-1, 9)
    n = tri.shape[0]
    if lib is None:
        from logipathtracer_tpu_torch.scene.bvh import build_triangle_bvh
        return build_triangle_bvh(tri_pos, leaf_size, bins)
    max_refs = max(int(n * max_dup), n + 8)
    cap = 2 * max_refs
    nmin = np.zeros((cap, 3), np.float32)
    nmax = np.zeros((cap, 3), np.float32)
    meta = np.zeros((cap, 3), np.int32)
    order = np.zeros(max_refs, np.int32)
    nn = ctypes.c_int32(0)
    md = ctypes.c_int32(0)
    nr = ctypes.c_int32(0)
    rc = lib.lpt_build_triangle_sbvh(
        tri, n, leaf_size, bins, ctypes.c_float(min_overlap), max_refs,
        nmin, nmax, meta, order, ctypes.byref(nn), ctypes.byref(md),
        ctypes.byref(nr))
    if rc != 0:
        raise RuntimeError(f"native SBVH build failed (rc={rc})")
    m = nn.value
    return BVH(nodes_min=nmin[:m].copy(), nodes_max=nmax[:m].copy(),
               nodes_meta=meta[:m].copy(),
               prim_order=order[:nr.value].copy(),
               max_depth=int(md.value))