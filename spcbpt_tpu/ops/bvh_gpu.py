"""BVH traversal on the GPU: one CUDA thread per ray (scene mode "cuda").

Replaces OptiX's hardware traversal (reference optixTrace, cuProg.h:387-533,
over the GAS of sutil/Scene.cpp:943) on an NVIDIA card. Each thread walks
the flat BVH of ops/bvh.py with a short stack, near child first; any-hit
rays stop at their first blocker. The kernels are native/bvh_trace.cu,
compiled with nvcc at first use into the package's native directory
(listed in .gitignore) and called through jax.ffi.

ops/traverse.py is the plain XLA form of the same walk and ops/intersect.py
the brute-force oracle; this module keeps their contract (intersect.Hit:
miss -> t = 1e30, tri = -1; dead lanes with tmax < tmin do no work).
"""
from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import jax
import jax.numpy as jnp

from .intersect import Hit

_BIG = 1e30
_NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SOURCES = ("bvh_trace.cu", "bvh_trace.cuh")
LIBRARY = os.path.join(_NATIVE, "libspcbpt_bvh_trace.so")
_CLOSEST = "spcbpt_bvh_closest"
_ANY = "spcbpt_bvh_any"

_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build_library() -> str:
    """Compile native/bvh_trace.cu for Hopper (sm_90a) unless the library
    is newer than its sources. Returns the library's path."""
    srcs = [os.path.join(_NATIVE, f) for f in _SOURCES]
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= max(
            os.path.getmtime(s) for s in srcs):
        return LIBRARY
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_NATIVE)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, srcs[0]]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIBRARY


def _register() -> None:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return
        lib = ctypes.cdll.LoadLibrary(build_library())
        jax.ffi.register_ffi_target(
            _CLOSEST, jax.ffi.pycapsule(lib.SpcbptBvhClosest), platform="CUDA")
        jax.ffi.register_ffi_target(
            _ANY, jax.ffi.pycapsule(lib.SpcbptBvhAny), platform="CUDA")
        _LIB = lib


def pack_nodes(bvh_min, bvh_max, bvh_skip, bvh_leaf_start, bvh_leaf_count):
    """(N, 8) float32 node records, two float4 each (native/bvh_trace.cuh):
    (min.xyz, right child | leaf count) and (max.xyz, first tri | -1), the
    integers stored bit for bit. In depth-first order the right child of
    interior node i is skip[i + 1]."""
    n = bvh_skip.shape[0]
    right = jnp.concatenate([bvh_skip[1:], jnp.full((1,), n, jnp.int32)])
    w0 = jnp.where(bvh_leaf_start < 0, right, bvh_leaf_count)
    bits = lambda a: jax.lax.bitcast_convert_type(
        a.astype(jnp.int32), jnp.float32)[:, None]
    return jnp.concatenate([bvh_min, bits(w0), bvh_max, bits(bvh_leaf_start)],
                           axis=1)


def pack_tris(tri_p0, tri_e1, tri_e2):
    """(T, 12) float32: three float4 per triangle, (p0, e1, e2, pad)."""
    return jnp.concatenate([tri_p0, tri_e1, tri_e2, jnp.zeros_like(tri_p0)],
                           axis=1)


def _closest_call(o, d, tmin, tmax, nodes, tris, cull: bool):
    _register()
    n = tmin.shape[0]
    return jax.ffi.ffi_call(_CLOSEST, (
        jax.ShapeDtypeStruct((n,), jnp.float32),
        jax.ShapeDtypeStruct((n,), jnp.int32),
        jax.ShapeDtypeStruct((n,), jnp.float32),
        jax.ShapeDtypeStruct((n,), jnp.float32)))(
            o, d, tmin, tmax, nodes, tris, cull=np.int32(cull))


def _any_call(o, d, tmin, tmax, nodes, tris):
    _register()
    n = tmin.shape[0]
    return jax.ffi.ffi_call(_ANY, jax.ShapeDtypeStruct((n,), jnp.int32))(
        o, d, tmin, tmax, nodes, tris)


def _flat_rays(origins, dirs, tmin, tmax):
    batch = origins.shape[:-1]
    n = math.prod(batch)
    flat = lambda a: jnp.broadcast_to(
        jnp.asarray(a, jnp.float32), batch).reshape(n)
    return (batch, n, jnp.asarray(origins, jnp.float32).reshape(n, 3),
            jnp.asarray(dirs, jnp.float32).reshape(n, 3), flat(tmin),
            flat(tmax))


def bvh_closest(origins, dirs, tmin, tmax,
                bvh_min, bvh_max, bvh_skip, bvh_leaf_start, bvh_leaf_count,
                tri_p0, tri_e1, tri_e2, cull_backface: bool = True) -> Hit:
    """Closest hit per ray; the arguments of ops/traverse.bvh_closest.
    origins/dirs (..., 3); tmin/tmax broadcast to the batch shape."""
    batch, n, o, d, tmn, tmx = _flat_rays(origins, dirs, tmin, tmax)
    if n == 0:
        return Hit(t=jnp.full(batch, _BIG, jnp.float32),
                   tri=jnp.full(batch, -1, jnp.int32),
                   u=jnp.zeros(batch, jnp.float32),
                   v=jnp.zeros(batch, jnp.float32))
    nodes = pack_nodes(bvh_min, bvh_max, bvh_skip, bvh_leaf_start,
                       bvh_leaf_count)
    t, tri, u, v = _closest_call(o, d, tmn, tmx, nodes,
                                 pack_tris(tri_p0, tri_e1, tri_e2),
                                 cull_backface)
    return Hit(t=t.reshape(batch), tri=tri.reshape(batch), u=u.reshape(batch),
               v=v.reshape(batch))


def bvh_any(origins, dirs, tmin, tmax,
            bvh_min, bvh_max, bvh_skip, bvh_leaf_start, bvh_leaf_count,
            tri_p0, tri_e1, tri_e2):
    """True where some triangle blocks (tmin, tmax); no back-face culling
    (reference cuProg.h:478). The arguments of ops/traverse.bvh_any."""
    batch, n, o, d, tmn, tmx = _flat_rays(origins, dirs, tmin, tmax)
    if n == 0:
        return jnp.zeros(batch, bool)
    nodes = pack_nodes(bvh_min, bvh_max, bvh_skip, bvh_leaf_start,
                       bvh_leaf_count)
    occ = _any_call(o, d, tmn, tmx, nodes, pack_tris(tri_p0, tri_e1, tri_e2))
    return (occ > 0).reshape(batch)
