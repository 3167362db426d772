"""Tiled two-level traversal: per-tile near-to-far cluster walk with
matrix-product triangle intersection (scene mode "tile").

Replaces OptiX hardware traversal at scene scale (reference: optixTrace in
cuProg.h:434 over the GAS built by sutil/Scene.cpp:943), written entirely in
jnp/lax:

1. Rays are grouped into tiles of R lanes (camera rays: 8x8 pixel blocks via
   block_order()).
2. Top level: every tile runs a conservative interval-arithmetic slab test
   against all C cluster AABBs (ops/clusters.py) — (NT x C) dense work.
   The per-tile lower bound of the entry distance orders clusters near-to-far
   and gives a safe termination bound: a cluster whose entry lower bound
   exceeds every lane's current best t cannot improve the tile.
3. The per-tile visit order is SORTED once (stable two-operand lax.sort), so
   each round's "next cluster" is a scalar-indexed column slice instead of a
   masked argmin over (NT x C).
4. Tiles are sorted by overlap count and processed in size-graded buckets
   (busiest tiles in the smallest while_loop): a lock-step loop over all
   tiles would pay the worst tile's round count for every tile.
5. Rounds: fetch the tile's next cluster coefficient block (16, 4K) and
   intersect all R rays against all K triangles as ONE batched matmul
   (ray features x Moller-Trumbore coefficients; ops/clusters.py). The loop
   epilogue is one variadic min-by-t reduce that carries the winner's
   barycentric numerators and determinant.

Matmul precision is HIGHEST (full f32): at lower precision, rays at grazing
triangle edges take a wrong surface with O(1-unit) t error, and on a GPU a
float32 matmul may otherwise run in TF32.

Correctness oracle: ops/intersect.brute_force_* (tests/test_tile_trace.py).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .clusters import ClusterSet, ray_features
from .intersect import Hit

_BIG = 1e30
_EPS_DET = 1e-10
# bucket divisors of the tile count, busiest tiles first
_BUCKETS = (16, 16, 8, 4, 2)


def block_order(width: int, height: int, bw: int = 8, bh: int = 8):
    """Permutation turning row-major pixel lanes into bw x bh blocks
    (numpy, host-side; apply as rays[perm], invert with argsort)."""
    idx = np.arange(width * height).reshape(height, width)
    return (idx.reshape(height // bh, bh, width // bw, bw)
            .transpose(0, 2, 1, 3).reshape(-1))


def _morton3(q, bits: int):
    """Interleave the low `bits` of 3 int32 coords (q: (..., 3))."""
    out = jnp.zeros(q.shape[:-1], jnp.int32)
    for b in range(bits):
        for a in range(3):
            out = out | (((q[..., a] >> b) & 1) << (3 * b + a))
    return out


def ray_sort_key(cmin, cmax, origins, dirs, bits: int = 5):
    """Wavefront coherence key: direction octant (major) then origin morton
    cell (minor). Secondary-bounce wavefronts arrive in arbitrary lane order;
    tiles of such rays defeat the per-tile interval culling of tile_entries
    (origin bbox ~ scene, direction intervals straddle every axis -> every
    cluster overlaps every tile). Sorting by this key re-forms coherent
    tiles: within a tile all directions share sign per axis (no straddle)
    and origins share a morton cell (tight origin box)."""
    lo = jnp.min(cmin, axis=0)
    hi = jnp.max(cmax, axis=0)
    scale = (1 << bits) / jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip(((origins - lo) * scale).astype(jnp.int32), 0,
                 (1 << bits) - 1)
    morton = _morton3(q, bits)
    octant = ((dirs[..., 0] < 0).astype(jnp.int32)
              | ((dirs[..., 1] < 0).astype(jnp.int32) << 1)
              | ((dirs[..., 2] < 0).astype(jnp.int32) << 2))
    return (octant << (3 * bits)) | morton


def ray_sort_key_live(cmin, cmax, origins, dirs, tmin, tmax, bits: int = 5):
    """ray_sort_key with DEAD lanes (tmax < tmin, the masked-lane convention)
    sorted to the end: masked connection/occlusion lanes then pack into whole
    tiles whose cluster overlaps are empty, which the walk skips in one round
    instead of paying for each tile's live minority."""
    key = ray_sort_key(cmin, cmax, origins, dirs, bits)
    dead = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), key.shape) \
        < jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), key.shape)
    return key | (dead.astype(jnp.int32) << 24)


def _pad_rays(origins, dirs, tmin, tmax, tile):
    n = origins.shape[0]
    pad = (-n) % tile
    if pad:
        origins = jnp.concatenate(
            [origins, jnp.zeros((pad, 3), origins.dtype)])
        dirs = jnp.concatenate(
            [dirs, jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], dirs.dtype),
                                    (pad, 3))])
        tmin = jnp.concatenate([tmin, jnp.zeros((pad,), tmin.dtype)])
        # tmax < tmin: padded lanes never hit and never extend the walk
        tmax = jnp.concatenate([tmax, jnp.full((pad,), -1.0, tmax.dtype)])
    return origins, dirs, tmin, tmax, n, pad


def tile_entries(cs: ClusterSet, origins, dirs, tmin, tmax, tile: int):
    """Conservative per-tile cluster entry bounds.

    Returns entry_lb of shape (NT, C): a lower bound on every lane's slab
    entry distance for the cluster, _BIG where NO lane can intersect the
    cluster AABB within [tmin, tmax]. Uses interval arithmetic over the
    tile's origin/direction bounding boxes, so it is safe for arbitrary
    (even incoherent) lane groupings — just less tight."""
    nt = origins.shape[0] // tile
    o = origins.reshape(nt, tile, 3)
    d = dirs.reshape(nt, tile, 3)
    olo = jnp.min(o, axis=1)[:, None, :]     # (NT, 1, 3)
    ohi = jnp.max(o, axis=1)[:, None, :]
    dlo = jnp.min(d, axis=1)[:, None, :]
    dhi = jnp.max(d, axis=1)[:, None, :]
    tmin_lb = jnp.min(tmin.reshape(nt, tile), axis=1)
    tmax_ub = jnp.max(tmax.reshape(nt, tile), axis=1)

    # inverse-direction interval per axis; sign-straddling axes give no
    # constraint (interval of 1/d is disconnected through +-inf)
    straddle = (dlo <= 0.0) & (dhi >= 0.0)
    safe_lo = jnp.where(jnp.abs(dlo) < 1e-12,
                        jnp.where(dlo < 0, -1e-12, 1e-12), dlo)
    safe_hi = jnp.where(jnp.abs(dhi) < 1e-12,
                        jnp.where(dhi < 0, -1e-12, 1e-12), dhi)
    il = jnp.minimum(1.0 / safe_lo, 1.0 / safe_hi)
    ih = jnp.maximum(1.0 / safe_lo, 1.0 / safe_hi)

    bmin = cs.cmin[None, :, :]               # (1, C, 3)
    bmax = cs.cmax[None, :, :]
    # interval endpoints of (b - o) for both slabs
    a_lo = bmin - ohi
    a_hi = bmin - olo
    b_lo = bmax - ohi
    b_hi = bmax - olo
    lo_ab = jnp.minimum(a_lo, b_lo)          # lower of (b-o) across both slabs
    hi_ab = jnp.maximum(a_hi, b_hi)
    # conservative hull of t = (b-o) * inv_d over all endpoint products
    p1 = lo_ab * il
    p2 = lo_ab * ih
    p3 = hi_ab * il
    p4 = hi_ab * ih
    ax_lo = jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4))
    ax_hi = jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4))
    ax_lo = jnp.where(straddle, -_BIG, ax_lo)
    ax_hi = jnp.where(straddle, _BIG, ax_hi)
    entry_lb = jnp.max(ax_lo, axis=-1)       # (NT, C)
    exit_ub = jnp.min(ax_hi, axis=-1)
    overlap = (entry_lb <= exit_ub) & (exit_ub >= tmin_lb[:, None]) \
        & (entry_lb <= tmax_ub[:, None])
    return jnp.where(overlap, entry_lb, _BIG)


def _prepare(cs, origins, dirs, tmin, tmax, tile):
    """Shared setup: entries, per-tile visit order, busiest-first tile order,
    permuted per-tile arrays. Returns (entries_s, ids_s, feats, tmin_t,
    tmax_t, inv_order, nt)."""
    n = origins.shape[0]
    nt = n // tile
    c = cs.num_clusters
    entries = tile_entries(cs, origins, dirs, tmin, tmax, tile)
    ids = jnp.broadcast_to(jnp.arange(c, dtype=jnp.int32)[None, :], (nt, c))
    # stable sort keeps equal-entry clusters in id order (near-to-far walk)
    entries_s, ids_s = jax.lax.sort((entries, ids), dimension=1, num_keys=1)

    feats = ray_features(origins, dirs).reshape(nt, tile, -1)
    tmin_t = tmin.reshape(nt, tile)
    tmax_t = tmax.reshape(nt, tile)

    count = jnp.sum(entries < _BIG, axis=1)
    order = jnp.argsort(-count)
    inv_order = jnp.argsort(order)
    # transpose to (C, NT): each round slices a contiguous row (a dynamic
    # slice on the lane axis of (NT, C) forces a strided pass per round)
    return (entries_s[order].T, ids_s[order].T, feats[order], tmin_t[order],
            tmax_t[order], inv_order, nt)


def _bucket_sizes(nt: int):
    """Static split of nt tiles into busiest-first buckets."""
    sizes = []
    left = nt
    for div in _BUCKETS[:-1]:
        s = min(max(nt // div, 1) if left > 0 else 0, left)
        sizes.append(s)
        left -= s
    sizes.append(left)
    return [s for s in sizes if s > 0]


def _split_mt(outs, k):
    outs = outs.reshape(outs.shape[0], outs.shape[1], 4, k)
    return outs[:, :, 0], outs[:, :, 1], outs[:, :, 2], outs[:, :, 3]


def _min_by_t(a, b):
    """Variadic reduce combiner: min t wins, ties broken by smaller slot."""
    at, au, av, ad, as_ = a
    bt, bu, bv, bd, bs = b
    take_a = (at < bt) | ((at == bt) & (as_ <= bs))
    sel = lambda x, y: jnp.where(take_a, x, y)
    return sel(at, bt), sel(au, bu), sel(av, bv), sel(ad, bd), sel(as_, bs)


def _hit_t(u_num, v_num, t_num, det, tmin, tmax, cull_backface):
    """Per-(lane, slot) hit test; returns t where hit else _BIG."""
    if cull_backface:
        det_ok = det > _EPS_DET
        s_u, s_v, s_det = u_num, v_num, det
    else:
        det_ok = jnp.abs(det) > _EPS_DET
        sgn = jnp.sign(det)
        s_u, s_v, s_det = u_num * sgn, v_num * sgn, jnp.abs(det)
    inv = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    t = t_num * inv
    hit = det_ok & (s_u >= 0.0) & (s_v >= 0.0) & (s_u + s_v <= s_det) \
        & (t > tmin[..., None]) & (t < tmax[..., None])
    return jnp.where(hit, t, _BIG)


def _closest_loop(cs, entries_s, ids_s, feats, tmin_t, tmax_t, cull_backface,
                  precision):
    """Near-to-far cluster walk over one tile subset."""
    nt = feats.shape[0]
    tile = feats.shape[1]
    k = cs.tri_k
    n_cols = entries_s.shape[0]
    slot = jnp.arange(k, dtype=jnp.int32)[None, None, :]

    def cond(state):
        *_, alive, r = state
        return jnp.any(alive)

    def body(state):
        best_t, best_id, best_un, best_vn, best_dn, alive, r = state
        rc = jnp.minimum(r, n_cols - 1)
        e = jax.lax.dynamic_slice_in_dim(entries_s, rc, 1, axis=0)[0]
        c = jax.lax.dynamic_slice_in_dim(ids_s, rc, 1, axis=0)[0]
        t_bound = jnp.max(jnp.minimum(best_t, tmax_t), axis=1)
        run = alive & (e < _BIG) & (e <= t_bound) & (r < n_cols)

        block = jnp.take(cs.coeff, jnp.where(run, c, 0), axis=0)
        outs = jax.lax.dot_general(
            feats, block, (((2,), (1,)), ((0,), (0,))), precision=precision)
        u_num, v_num, t_num, det = _split_mt(outs, k)
        tt = _hit_t(u_num, v_num, t_num, det, tmin_t,
                    jnp.minimum(best_t, tmax_t), cull_backface)
        tt = jnp.where(run[:, None, None], tt, _BIG)
        # single-pass min-by-t reduce carrying the winner's payload (one read
        # of the matmul output instead of separate min + 4 pick passes)
        slot_b = jnp.broadcast_to(slot, tt.shape)
        t_min, u_np, v_np, d_np, s_pick = jax.lax.reduce(
            (tt, u_num, v_num, det, slot_b),
            (jnp.float32(_BIG), jnp.float32(0), jnp.float32(0),
             jnp.float32(1), jnp.int32(k)),
            _min_by_t, (2,))
        improved = t_min < best_t
        tri = jnp.take(cs.tri_begin, c)[:, None] + s_pick
        best_id = jnp.where(improved, tri, best_id)
        best_un = jnp.where(improved, u_np, best_un)
        best_vn = jnp.where(improved, v_np, best_vn)
        best_dn = jnp.where(improved, d_np, best_dn)
        best_t = jnp.where(improved, t_min, best_t)
        return best_t, best_id, best_un, best_vn, best_dn, alive & run, r + 1

    state = (jnp.full((nt, tile), _BIG),
             jnp.full((nt, tile), -1, jnp.int32),
             jnp.zeros((nt, tile)), jnp.zeros((nt, tile)),
             jnp.ones((nt, tile)),
             jnp.ones((nt,), bool), jnp.int32(0))
    best_t, best_id, best_un, best_vn, best_dn, *_ = jax.lax.while_loop(
        cond, body, state)
    inv = 1.0 / jnp.where(jnp.abs(best_dn) > 0, best_dn, 1.0)
    return best_t, best_id, best_un * inv, best_vn * inv


@partial(jax.jit,
         static_argnames=("tile", "cull_backface", "precision", "sort_rays"))
def tile_closest(cs: ClusterSet, origins, dirs, tmin, tmax,
                 cull_backface: bool = True, tile: int = 64,
                 precision=jax.lax.Precision.HIGHEST,
                 sort_rays: bool = False) -> Hit:
    """Closest-hit traversal. Returns Hit with t=_BIG / tri=-1 on miss.
    sort_rays=True re-orders the wavefront by ray_sort_key first (use for
    incoherent secondary-bounce wavefronts; camera tiles are already
    coherent)."""
    ray_perm = None
    if sort_rays:
        key = ray_sort_key_live(cs.cmin, cs.cmax, origins, dirs,
                                tmin, tmax)
        ray_perm = jnp.argsort(key).astype(jnp.int32)
        origins, dirs = origins[ray_perm], dirs[ray_perm]
        tmin, tmax = tmin[ray_perm], tmax[ray_perm]
    origins, dirs, tmin, tmax, n_orig, pad = _pad_rays(
        origins, dirs, tmin, tmax, tile)
    n = origins.shape[0]

    entries_s, ids_s, feats, tmin_t, tmax_t, inv_order, nt = \
        _prepare(cs, origins, dirs, tmin, tmax, tile)

    parts = []
    pos = 0
    for sz in _bucket_sizes(nt):
        sl = slice(pos, pos + sz)
        parts.append(_closest_loop(cs, entries_s[:, sl], ids_s[:, sl],
                                   feats[sl], tmin_t[sl], tmax_t[sl],
                                   cull_backface, precision))
        pos += sz
    out = [jnp.concatenate([p[i] for p in parts])[inv_order].reshape(n)[:n_orig]
           for i in range(4)]
    if ray_perm is not None:
        # scatter back to caller lane order
        out = [jnp.zeros_like(a).at[ray_perm].set(a) for a in out]
    best_t, best_id, best_u, best_v = out
    found = best_id >= 0
    return Hit(t=jnp.where(found, best_t, _BIG), tri=best_id,
               u=jnp.where(found, best_u, 0.0), v=jnp.where(found, best_v, 0.0))


def _any_loop(cs, entries_s, ids_s, feats, tmin_t, tmax_t, precision):
    nt, tile, _ = feats.shape
    k = cs.tri_k
    n_cols = entries_s.shape[0]

    def cond(state):
        occ, alive, r = state
        return jnp.any(alive)

    def body(state):
        occ, alive, r = state
        rc = jnp.minimum(r, n_cols - 1)
        e = jax.lax.dynamic_slice_in_dim(entries_s, rc, 1, axis=0)[0]
        c = jax.lax.dynamic_slice_in_dim(ids_s, rc, 1, axis=0)[0]
        run = alive & (e < _BIG) & (r < n_cols) \
            & ~jnp.all(occ | (tmax_t < tmin_t), axis=1)

        block = jnp.take(cs.coeff, jnp.where(run, c, 0), axis=0)
        outs = jax.lax.dot_general(
            feats, block, (((2,), (1,)), ((0,), (0,))), precision=precision)
        u_num, v_num, t_num, det = _split_mt(outs, k)
        tt = _hit_t(u_num, v_num, t_num, det, tmin_t, tmax_t, False)
        hit_any = jnp.any(tt < _BIG, axis=2) & run[:, None]
        occ = occ | hit_any
        return occ, alive & run, r + 1

    state = (jnp.zeros((nt, tile), bool), jnp.ones((nt,), bool), jnp.int32(0))
    occ, *_ = jax.lax.while_loop(cond, body, state)
    return occ


@partial(jax.jit, static_argnames=("tile", "precision", "sort_rays"))
def tile_any(cs: ClusterSet, origins, dirs, tmin, tmax, tile: int = 64,
             precision=jax.lax.Precision.HIGHEST, sort_rays: bool = False):
    """Any-hit (occlusion) traversal: True where some triangle blocks
    [tmin, tmax]. No back-face culling (reference cuProg.h:478)."""
    ray_perm = None
    if sort_rays:
        key = ray_sort_key_live(cs.cmin, cs.cmax, origins, dirs,
                                tmin, tmax)
        ray_perm = jnp.argsort(key).astype(jnp.int32)
        origins, dirs = origins[ray_perm], dirs[ray_perm]
        tmin, tmax = tmin[ray_perm], tmax[ray_perm]
    origins, dirs, tmin, tmax, n_orig, pad = _pad_rays(
        origins, dirs, tmin, tmax, tile)
    n = origins.shape[0]

    entries_s, ids_s, feats, tmin_t, tmax_t, inv_order, nt = \
        _prepare(cs, origins, dirs, tmin, tmax, tile)

    parts = []
    pos = 0
    for sz in _bucket_sizes(nt):
        sl = slice(pos, pos + sz)
        parts.append(_any_loop(cs, entries_s[:, sl], ids_s[:, sl], feats[sl],
                               tmin_t[sl], tmax_t[sl], precision))
        pos += sz
    occ = jnp.concatenate(parts)[inv_order].reshape(n)[:n_orig]
    if ray_perm is not None:
        occ = jnp.zeros_like(occ).at[ray_perm].set(occ)
    return occ
