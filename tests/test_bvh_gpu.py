"""GPU BVH traversal (ops/bvh_gpu.py, native/bvh_trace.cu) vs the
brute-force oracle.

The CUDA kernel has no interpret mode. On the CPU the per-ray walk it runs
(native/bvh_trace.cuh) is compiled for the host from the same header and put
in place of the kernel launch, so these tests cover the wrapper (node and
triangle packing, batch shapes, empty wavefronts), the scene dispatch and the
walk's arithmetic and stack. The `gpu` tests run the real kernel on a card.
"""
import ctypes
import os
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spcbpt_tpu.native.loader import native_build_bvh
from spcbpt_tpu.ops import bvh as bvh_mod
from spcbpt_tpu.ops import bvh_gpu, intersect
from spcbpt_tpu.scene import scene as scene_mod

HERE = os.path.dirname(os.path.abspath(__file__))
NATIVE = os.path.join(os.path.dirname(HERE), "spcbpt_tpu", "native")
F32P = ctypes.POINTER(ctypes.c_float)
I32P = ctypes.POINTER(ctypes.c_int32)


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("walk") / "libwalk.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", NATIVE, "-o", so,
                    os.path.join(HERE, "bvh_trace_host.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(so)
    lib.closest_host.argtypes = [ctypes.c_int64] + [F32P] * 6 + [
        ctypes.c_int32, F32P, I32P, F32P, F32P]
    lib.any_host.argtypes = [ctypes.c_int64] + [F32P] * 6 + [I32P]
    return lib


@pytest.fixture
def host_kernels(host_walk, monkeypatch):
    """Route bvh_gpu's kernel calls to the host build of the same walk;
    returns the list of wavefront sizes it was called with."""
    calls = []

    def inputs(*arrays):
        return [np.ascontiguousarray(a, np.float32) for a in arrays]

    def closest(o, d, tmin, tmax, nodes, tris, cull):
        n = tmin.shape[0]
        calls.append(n)

        def run(*arrays):
            ins = inputs(*arrays)
            t = np.empty(n, np.float32)
            tri = np.empty(n, np.int32)
            u = np.empty(n, np.float32)
            v = np.empty(n, np.float32)
            host_walk.closest_host(
                n, *[a.ctypes.data_as(F32P) for a in ins], int(cull),
                t.ctypes.data_as(F32P), tri.ctypes.data_as(I32P),
                u.ctypes.data_as(F32P), v.ctypes.data_as(F32P))
            return t, tri, u, v

        shapes = (jax.ShapeDtypeStruct((n,), jnp.float32),
                  jax.ShapeDtypeStruct((n,), jnp.int32),
                  jax.ShapeDtypeStruct((n,), jnp.float32),
                  jax.ShapeDtypeStruct((n,), jnp.float32))
        return jax.pure_callback(run, shapes, o, d, tmin, tmax, nodes, tris)

    def any_hit(o, d, tmin, tmax, nodes, tris):
        n = tmin.shape[0]
        calls.append(n)

        def run(*arrays):
            ins = inputs(*arrays)
            occ = np.empty(n, np.int32)
            host_walk.any_host(n, *[a.ctypes.data_as(F32P) for a in ins],
                               occ.ctypes.data_as(I32P))
            return occ

        return jax.pure_callback(run, jax.ShapeDtypeStruct((n,), jnp.int32),
                                 o, d, tmin, tmax, nodes, tris)

    monkeypatch.setattr(bvh_gpu, "_closest_call", closest)
    monkeypatch.setattr(bvh_gpu, "_any_call", any_hit)
    return calls


def random_scene(n_tris, seed):
    """Reordered random triangles and their flat BVH as device arrays."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-5, 5, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    flat = bvh_mod.build_bvh_numpy(p0, e1, e2)
    o = flat.order
    bvh = [jnp.asarray(a) for a in (flat.bounds_min, flat.bounds_max,
                                    flat.skip, flat.leaf_start,
                                    flat.leaf_count)]
    tris = [jnp.asarray(a[o]) for a in (p0, e1, e2)]
    return bvh, tris


def random_rays(n, seed):
    """Rays from around the triangle cloud aimed at points inside it."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.uniform(-4, 4, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _check_closest(got, ref):
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(ref.tri))
    hit = np.asarray(ref.tri) >= 0
    np.testing.assert_allclose(np.asarray(got.t)[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.u)[hit], np.asarray(ref.u)[hit],
                               atol=1e-4)
    assert (np.asarray(got.t)[~hit] == 1e30).all()
    assert 0.2 < hit.mean() < 0.98   # the rays exercise hits and misses


@pytest.mark.parametrize("cull", [True, False])
def test_walk_closest_matches_brute(host_kernels, cull):
    bvh, tris = random_scene(400, 0)
    o, d = random_rays(1024, 1)
    tmin, tmax = jnp.full(1024, 1e-3), jnp.full(1024, 1e30)
    ref = intersect.brute_force_closest(o, d, *tris, tmin, tmax, cull)
    got = bvh_gpu.bvh_closest(o, d, tmin, tmax, *bvh, *tris, cull)
    _check_closest(got, ref)


def test_walk_any_matches_brute(host_kernels):
    bvh, tris = random_scene(300, 2)
    o, d = random_rays(1024, 3)
    tmin, tmax = jnp.full(1024, 1e-3), jnp.full(1024, 4.0)
    ref = np.asarray(intersect.brute_force_any(o, d, *tris, tmin, tmax))
    got = np.asarray(bvh_gpu.bvh_any(o, d, tmin, tmax, *bvh, *tris))
    np.testing.assert_array_equal(got, ref)
    assert 0.1 < ref.mean() < 0.9


def test_walk_dead_lanes_miss(host_kernels):
    """tmax < tmin marks a lane that must not be traced (scene.visibility's
    mask): it misses / is unoccluded even where a live ray would hit."""
    bvh, tris = random_scene(300, 4)
    o, d = random_rays(512, 5)
    dead = np.arange(512) % 2 == 1
    tmin = jnp.full(512, 1e-3)
    tmax = jnp.where(jnp.asarray(dead), -1.0, 1e30)
    ref = intersect.brute_force_closest(o, d, *tris, tmin,
                                        jnp.full(512, 1e30), False)
    got = bvh_gpu.bvh_closest(o, d, tmin, tmax, *bvh, *tris, False)
    assert (np.asarray(ref.tri)[dead] >= 0).any()
    assert (np.asarray(got.tri)[dead] == -1).all()
    assert (np.asarray(got.t)[dead] == 1e30).all()
    np.testing.assert_array_equal(np.asarray(got.tri)[~dead],
                                  np.asarray(ref.tri)[~dead])
    occ = np.asarray(bvh_gpu.bvh_any(o, d, tmin, tmax, *bvh, *tris))
    assert not occ[dead].any()


def test_empty_wavefront_launches_nothing(host_kernels):
    bvh, tris = random_scene(50, 6)
    o = jnp.zeros((0, 3))
    hit = bvh_gpu.bvh_closest(o, o, 1e-3, 1e30, *bvh, *tris)
    assert hit.t.shape == hit.tri.shape == hit.u.shape == (0,)
    assert bvh_gpu.bvh_any(o, o, 1e-3, 1.0, *bvh, *tris).shape == (0,)
    assert host_kernels == []


def test_batch_shape_and_scalar_bounds(host_kernels):
    """(..., 3) rays with scalar tmin/tmax flatten into one wavefront and
    come back in the batch shape."""
    bvh, tris = random_scene(200, 7)
    o, d = random_rays(256, 8)
    flat = bvh_gpu.bvh_closest(o, d, jnp.full(256, 1e-3),
                               jnp.full(256, 1e30), *bvh, *tris)
    got = bvh_gpu.bvh_closest(o.reshape(4, 64, 3), d.reshape(4, 64, 3),
                              1e-3, 1e30, *bvh, *tris)
    assert got.tri.shape == (4, 64)
    np.testing.assert_array_equal(np.asarray(got.tri).ravel(),
                                  np.asarray(flat.tri))
    occ = bvh_gpu.bvh_any(o.reshape(16, 16, 3), d.reshape(16, 16, 3),
                          1e-3, 3.0, *bvh, *tris)
    assert occ.shape == (16, 16) and occ.dtype == bool
    assert host_kernels == [256, 256, 256]


def test_pack_nodes_layout():
    bvh, _ = random_scene(100, 9)
    bmin, bmax, skip, leaf_start, leaf_count = [np.asarray(a) for a in bvh]
    packed = np.asarray(bvh_gpu.pack_nodes(*bvh))
    assert packed.shape == (len(skip), 8)
    w = packed.view(np.int32)
    np.testing.assert_array_equal(packed[:, 0:3], bmin)
    np.testing.assert_array_equal(packed[:, 4:7], bmax)
    np.testing.assert_array_equal(w[:, 7], leaf_start)
    leaf = leaf_start >= 0
    np.testing.assert_array_equal(w[leaf, 3], leaf_count[leaf])
    interior = np.nonzero(~leaf)[0]
    np.testing.assert_array_equal(w[interior, 3], skip[interior + 1])


@pytest.mark.parametrize("builder", ["numpy", "native"])
def test_right_child_is_skip_of_left(builder):
    """The depth-first layout the kernel relies on: interior node i has its
    left child at i + 1 and its right child at skip[i + 1]; the two subtrees
    tile [i + 1, skip[i]) and the parent's box holds both."""
    rng = np.random.default_rng(10)
    p0 = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    if builder == "numpy":
        flat = bvh_mod.build_bvh_numpy(p0, e1, e2)
    else:
        flat = native_build_bvh(p0, e1, e2, bvh_mod.LEAF_SIZE)
        assert flat is not None, "native BVH builder failed to build"
    n = len(flat.skip)
    interior = np.nonzero(flat.leaf_start < 0)[0]
    assert len(interior) > 50
    for i in interior:
        left, right = i + 1, flat.skip[i + 1]
        assert i + 1 < right < flat.skip[i] <= n
        assert flat.skip[right] == flat.skip[i]
        for c in (left, right):
            assert (flat.bounds_min[i] <= flat.bounds_min[c]).all()
            assert (flat.bounds_max[i] >= flat.bounds_max[c]).all()


@pytest.fixture(scope="module")
def cornell_desc():
    from spcbpt_tpu.scene.cornell import default_scene_path
    from spcbpt_tpu.scene.parser import load_scene
    return load_scene(default_scene_path())


def test_scene_cuda_mode_matches_brute(host_kernels, cornell_desc):
    """trace_closest / visibility of a scene in mode "cuda" agree with mode
    "brute" through the scene API (the renderers' entry points)."""
    ts_k = scene_mod.build_scene(cornell_desc, mode="cuda")
    ts_b = scene_mod.build_scene(cornell_desc, mode="brute")
    o, d = random_rays(2048, 11)
    o = o * 0.5
    hk = scene_mod.trace_closest(ts_k, o, d, 1e-3, 1e16)
    hb = scene_mod.trace_closest(ts_b, o, d, 1e-3, 1e16)
    np.testing.assert_array_equal(np.asarray(hk.tri), np.asarray(hb.tri))
    assert (np.asarray(hb.tri) >= 0).mean() > 0.2
    b = o + 3.0 * d
    mask = jnp.arange(2048) % 3 != 0
    vk = np.asarray(scene_mod.visibility(ts_k, o, b, mask=mask))
    vb = np.asarray(scene_mod.visibility(ts_b, o, b))
    m = np.asarray(mask)
    np.testing.assert_array_equal(vk[m], vb[m])
    assert len(host_kernels) == 2


@pytest.mark.parametrize("backend,limit,mode", [
    ("cpu", None, "brute"), ("cpu", 16, "bvh"), ("gpu", None, "cuda")])
def test_build_scene_selects_mode(cornell_desc, monkeypatch, backend, limit,
                                  mode):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if limit is not None:
        monkeypatch.setattr(scene_mod, "BRUTE_FORCE_MAX_TRIS_CPU", limit)
    assert scene_mod.build_scene(cornell_desc).mode == mode


@pytest.mark.gpu
@pytest.mark.parametrize("cull", [True, False])
def test_cuda_closest_matches_brute(gpu, cull):
    bvh, tris = random_scene(2000, 12)
    o, d = random_rays(1 << 15, 13)
    n = o.shape[0]
    tmin, tmax = jnp.full(n, 1e-3), jnp.full(n, 1e30)
    ref = intersect.brute_force_closest(o, d, *tris, tmin, tmax, cull)
    got = jax.jit(bvh_gpu.bvh_closest, static_argnums=12)(
        o, d, tmin, tmax, *bvh, *tris, cull)
    # rounding differs between the kernel and XLA's brute force, so a near
    # tie between two triangles may resolve either way: agreement is counted
    gt, rt = np.asarray(got.t), np.asarray(ref.t)
    t_bad = np.abs(gt - rt) > 1e-4 * np.maximum(1.0, np.abs(rt))
    tri_bad = np.asarray(got.tri) != np.asarray(ref.tri)
    assert tri_bad.sum() <= 1e-4 * n and t_bad.sum() <= 1e-4 * n, (
        tri_bad.sum(), t_bad.sum())
    assert (rt < 1e30).mean() > 0.5


@pytest.mark.gpu
def test_cuda_any_dead_lanes_and_empty(gpu):
    bvh, tris = random_scene(2000, 14)
    o, d = random_rays(1 << 15, 15)
    n = o.shape[0]
    dead = jnp.arange(n) % 4 == 0
    tmin = jnp.full(n, 1e-3)
    tmax = jnp.where(dead, -1.0, 4.0)
    ref = np.asarray(intersect.brute_force_any(o, d, *tris, tmin, tmax))
    got = np.asarray(jax.jit(bvh_gpu.bvh_any)(o, d, tmin, tmax, *bvh, *tris))
    np.testing.assert_array_equal(got, ref)
    assert not got[np.asarray(dead)].any()
    hit = jax.jit(bvh_gpu.bvh_closest)(o, d, tmin, tmax, *bvh, *tris)
    assert (np.asarray(hit.tri)[np.asarray(dead)] == -1).all()
    empty = bvh_gpu.bvh_closest(o[:0], d[:0], 1e-3, 1e30, *bvh, *tris)
    assert empty.tri.shape == (0,)
