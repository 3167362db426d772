"""Stackless skip-link BVH traversal as a vectorized XLA while_loop.

Every ray lane carries a single node pointer. Per step a lane either descends
(node+1) on AABB hit, or jumps the skip link; leaf lanes test their LEAF_SIZE
triangle slots (dense, unrolled) and jump the skip link. Lanes finish when
their pointer reaches the node count. This maps to gathers + elementwise ops —
no per-lane stacks, no divergence beyond the usual masked lanes.

Replaces OptiX hardware traversal (reference optixTrace; SBT dispatch becomes
the caller's masked selects). The loop takes as many steps as its slowest
ray needs; ops/bvh_gpu.py walks the same tree with one GPU thread per ray.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .bvh import LEAF_SIZE
from .intersect import Hit, tri_test

_BIG = 1e30


def _aabb_hit(o, inv_d, bmin, bmax, tmin, tmax):
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    near = jnp.maximum(jnp.max(tlo, axis=-1), tmin)
    far = jnp.minimum(jnp.min(thi, axis=-1), tmax)
    return near <= far


def bvh_closest(origins, dirs, tmin, tmax,
                bvh_min, bvh_max, bvh_skip, bvh_leaf_start, bvh_leaf_count,
                tri_p0, tri_e1, tri_e2, cull_backface: bool = True) -> Hit:
    n = origins.shape[0]
    n_nodes = bvh_min.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(dirs) < 1e-12,
                            jnp.where(dirs < 0, -1e-12, 1e-12), dirs)

    def cond(state):
        node, *_ = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, best_t, best_tri, best_u, best_v = state
        active = node < n_nodes
        idx = jnp.minimum(node, n_nodes - 1)
        nmin = bvh_min[idx]
        nmax = bvh_max[idx]
        skip = bvh_skip[idx]
        lstart = bvh_leaf_start[idx]
        lcount = bvh_leaf_count[idx]
        box_ok = _aabb_hit(origins, inv_d, nmin, nmax, tmin, best_t) & active
        is_leaf = lstart >= 0

        # leaf triangle tests (unrolled over the fixed leaf slot count)
        do_leaf = box_ok & is_leaf
        for k in range(LEAF_SIZE):
            ti = jnp.clip(lstart + k, 0, tri_p0.shape[0] - 1)
            t, u, v, hit = tri_test(origins, dirs, tri_p0[ti], tri_e1[ti],
                                    tri_e2[ti], cull_backface)
            ok = do_leaf & (k < lcount) & hit & (t > tmin) & (t < best_t)
            best_tri = jnp.where(ok, ti.astype(jnp.int32), best_tri)
            best_u = jnp.where(ok, u, best_u)
            best_v = jnp.where(ok, v, best_v)
            best_t = jnp.where(ok, t, best_t)

        descend = box_ok & ~is_leaf
        new_node = jnp.where(active, jnp.where(descend, node + 1, skip), node)
        return new_node, best_t, best_tri, best_u, best_v

    state = (jnp.zeros((n,), jnp.int32),
             jnp.minimum(tmax, _BIG),
             jnp.full((n,), -1, jnp.int32),
             jnp.zeros((n,)), jnp.zeros((n,)))
    node, best_t, best_tri, best_u, best_v = jax.lax.while_loop(cond, body, state)
    best_t = jnp.where(best_tri >= 0, best_t, _BIG)
    return Hit(t=best_t, tri=best_tri, u=best_u, v=best_v)


def bvh_any(origins, dirs, tmin, tmax,
            bvh_min, bvh_max, bvh_skip, bvh_leaf_start, bvh_leaf_count,
            tri_p0, tri_e1, tri_e2):
    n = origins.shape[0]
    n_nodes = bvh_min.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(dirs) < 1e-12,
                            jnp.where(dirs < 0, -1e-12, 1e-12), dirs)

    def cond(state):
        node, occluded = state
        return jnp.any((node < n_nodes) & ~occluded)

    def body(state):
        node, occluded = state
        active = (node < n_nodes) & ~occluded
        idx = jnp.minimum(node, n_nodes - 1)
        box_ok = _aabb_hit(origins, inv_d, bvh_min[idx], bvh_max[idx],
                           tmin, tmax) & active
        lstart = bvh_leaf_start[idx]
        lcount = bvh_leaf_count[idx]
        is_leaf = lstart >= 0
        do_leaf = box_ok & is_leaf
        hit_any = jnp.zeros_like(occluded)
        for k in range(LEAF_SIZE):
            ti = jnp.clip(lstart + k, 0, tri_p0.shape[0] - 1)
            t, _, _, hit = tri_test(origins, dirs, tri_p0[ti], tri_e1[ti],
                                    tri_e2[ti], False)
            hit_any = hit_any | (do_leaf & (k < lcount) & hit
                                 & (t > tmin) & (t < tmax))
        occluded = occluded | hit_any
        descend = box_ok & ~is_leaf
        new_node = jnp.where(active, jnp.where(descend, node + 1,
                                               bvh_skip[idx]), node)
        return new_node, occluded

    _, occluded = jax.lax.while_loop(
        cond, body, (jnp.zeros((n,), jnp.int32), jnp.zeros((n,), bool)))
    return occluded
