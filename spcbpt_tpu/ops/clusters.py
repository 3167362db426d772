"""Two-level traversal clusters: cut the SAH BVH into contiguous triangle
blocks and pack per-triangle Moller-Trumbore coefficient matrices, so that
intersection is a matrix product.

Replaces OptiX hardware BVH traversal (reference: sutil/Scene.cpp
buildMeshAccels:943 + optixTrace cuProg.h:434) with a two-level scheme:
a flat top level of a few hundred cluster AABBs (dense slab tests) over
leaf blocks of <=K triangles whose ray tests run as one batched matmul
(see ops/tile_trace.py for the math and the traversal loop).

The key packing trick: for a triangle (p0, e1, e2) with n = e1 x e2, the
Moller-Trumbore quantities are all linear in the 16-dim ray feature vector
F = [vec(o x d outer, 9), d (3), o (3), 1]:
    u_num = (o-p0).(d x e2)   -> o_i d_j coeffs  eps_ijk e2_k, d coeff -(e2 x p0)
    v_num = ((o-p0) x e1).d   -> o_i d_j coeffs -eps_ijk e1_k, d coeff -(p0 x e1)
    t_num = (o-p0).n          -> o coeff n, const -p0.n
    det   = (d x e2).e1       -> d coeff  e2 x e1 = -n
so a cluster of K triangles becomes a (16, 4K) matrix and testing R rays is a
(R,16)x(16,4K) matmul. Triangle ids are reconstructed as
tri_begin[cluster] + slot (clusters are contiguous ranges of the reordered
triangle array).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..utils import struct
from .bvh import FlatBVH

FEAT_DIM = 16
N_OUT = 4  # u_num, v_num, t_num, det


@struct.dataclass
class ClusterSet:
    cmin: jnp.ndarray      # (C, 3) cluster AABB min
    cmax: jnp.ndarray      # (C, 3)
    coeff: jnp.ndarray     # (C, 16, 4*K) triangle coefficient blocks
    tri_begin: jnp.ndarray  # (C,) int32 first (reordered) triangle id
    tri_k: int = struct.field(pytree_node=False, default=64)

    @property
    def num_clusters(self) -> int:
        return self.cmin.shape[0]


def _cut_bvh(flat: FlatBVH, max_tris: int):
    """Walk the DFS-ordered skip-link BVH; emit the shallowest subtrees whose
    triangle range is <= max_tris. DFS order makes every subtree's triangles a
    contiguous range of the reordered array."""
    n = len(flat.skip)
    # cumulative triangle count up to each node (leaves contribute)
    leaf_tris = np.where(flat.leaf_start >= 0, flat.leaf_count, 0)
    pref = np.concatenate([[0], np.cumsum(leaf_tris)])
    # tri range of node i's subtree = [pref[i], pref[skip[i]])
    clusters = []  # (tri_begin, tri_end, node)
    i = 0
    while i < n:
        end = int(flat.skip[i])
        count = int(pref[end] - pref[i])
        if count <= max_tris or flat.leaf_start[i] >= 0:
            if count > 0:
                clusters.append((int(pref[i]), int(pref[end]), i))
            i = end
        else:
            i += 1
    return clusters


def pack_coefficients(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> np.ndarray:
    """(T,3)x3 -> (T, 16, 4) coefficient blocks (see module docstring).
    Degenerate triangles (zero normal) produce det == 0 and never hit."""
    t = len(p0)
    n = np.cross(e1, e2)
    eps = np.zeros((3, 3, 3), np.float64)
    eps[0, 1, 2] = eps[1, 2, 0] = eps[2, 0, 1] = 1.0
    eps[0, 2, 1] = eps[2, 1, 0] = eps[1, 0, 2] = -1.0

    coeff = np.zeros((t, FEAT_DIM, N_OUT), np.float64)
    # u_num: o_i d_j block = sum_k eps_ijk e2_k ; d block = -(e2 x p0)
    u_od = np.einsum("ijk,tk->tij", eps, e2)            # (T,3,3) [i=o, j=d]
    coeff[:, 0:9, 0] = u_od.reshape(t, 9)
    coeff[:, 9:12, 0] = -np.cross(e2, p0)
    # v_num: o_i d_j block = -eps_ijk e1_k ; d block = -(p0 x e1)
    v_od = -np.einsum("ijk,tk->tij", eps, e1)
    coeff[:, 0:9, 1] = v_od.reshape(t, 9)
    coeff[:, 9:12, 1] = -np.cross(p0, e1)
    # t_num: o block = n ; const = -p0.n
    coeff[:, 12:15, 2] = n
    coeff[:, 15, 2] = -np.sum(p0 * n, axis=-1)
    # det: d block = -n
    coeff[:, 9:12, 3] = -n
    return coeff.astype(np.float32)


def ray_features(o, d):
    """(N,3),(N,3) -> (N,16) feature matrix F = [vec(o d^T), d, o, 1]."""
    od = (o[..., :, None] * d[..., None, :]).reshape(o.shape[:-1] + (9,))
    one = jnp.ones(o.shape[:-1] + (1,), o.dtype)
    return jnp.concatenate([od, d, o, one], axis=-1)


def build_clusters(flat: FlatBVH, p0: np.ndarray, e1: np.ndarray,
                   e2: np.ndarray, max_tris: int = 64) -> ClusterSet:
    """Build a ClusterSet from a flattened BVH and the REORDERED triangle
    arrays (p0/e1/e2 already permuted by flat.order). Triangle ids in the
    packed blocks refer to the reordered arrays (matching Hit.tri)."""
    cl = _cut_bvh(flat, max_tris)
    p0 = np.asarray(p0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    c = len(cl)
    coeff = np.zeros((c, max_tris, FEAT_DIM, N_OUT), np.float32)
    cmin = np.zeros((c, 3), np.float32)
    cmax = np.zeros((c, 3), np.float32)
    begin = np.zeros((c,), np.int32)
    for ci, (lo, hi, node) in enumerate(cl):
        coeff[ci, :hi - lo] = pack_coefficients(p0[lo:hi], e1[lo:hi],
                                                e2[lo:hi])
        cmin[ci] = flat.bounds_min[node]
        cmax[ci] = flat.bounds_max[node]
        begin[ci] = lo
    # (C, K, 16, 4) -> (C, 16, 4K): outputs grouped by kind then triangle slot
    coeff = coeff.transpose(0, 2, 3, 1).reshape(c, FEAT_DIM, N_OUT * max_tris)
    return ClusterSet(cmin=jnp.asarray(cmin), cmax=jnp.asarray(cmax),
                      coeff=jnp.asarray(coeff), tri_begin=jnp.asarray(begin),
                      tri_k=max_tris)
