"""Ray-triangle intersection (Moller-Trumbore) and brute-force tracing.

This is the traversal correctness oracle and, on the CPU, the fast path for
small scenes (a Cornell box has ~32 triangles: testing all of them as one
fused broadcast beats XLA's tree walk). Larger scenes use ops/traverse.py
(XLA skip-link BVH) and, on a GPU, ops/bvh_gpu.py.

Replaces OptiX RT core dispatch (reference: optixTrace calls in
src/OptiXPathTracer/cuProg.h:387-533). Two ray "types" as in the reference
(optixPathTracer.h:202-209): closest-hit (radiance/subpath; optionally
back-face culled, matching OPTIX_RAY_FLAG_CULL_BACK_FACING_TRIANGLES at
cuProg.h:402/427/452) and any-hit occlusion (no culling, cuProg.h:478).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_EPS_DET = 1e-10


class Hit(NamedTuple):
    t: jnp.ndarray        # (N,) float32; large where miss
    tri: jnp.ndarray      # (N,) int32; -1 where miss
    u: jnp.ndarray        # (N,) float32 barycentric
    v: jnp.ndarray        # (N,) float32

    @property
    def valid(self):
        return self.tri >= 0


def tri_test(origins, dirs, p0, e1, e2, cull_backface: bool):
    """Batched Moller-Trumbore. origins/dirs: (..., 3); p0/e1/e2 broadcastable
    to (..., 3). Returns (t, u, v, hit_mask)."""
    pvec = jnp.cross(dirs, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    # front face: dot(dir, n) < 0 with n = cross(e1, e2)  <=>  det > 0
    if cull_backface:
        det_ok = det > _EPS_DET
    else:
        det_ok = jnp.abs(det) > _EPS_DET
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    tvec = origins - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(dirs * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, hit


def brute_force_closest(origins, dirs, tri_p0, tri_e1, tri_e2,
                        tmin, tmax, cull_backface: bool = True,
                        chunk: int = 512) -> Hit:
    """Closest hit over all triangles, streamed in chunks of `chunk`."""
    n = origins.shape[0]
    t_total = tri_p0.shape[0]
    pad = (-t_total) % chunk
    if pad:
        padv = jnp.zeros((pad, 3), tri_p0.dtype)
        tri_p0 = jnp.concatenate([tri_p0, padv])
        # degenerate padding triangles never hit
        tri_e1 = jnp.concatenate([tri_e1, padv])
        tri_e2 = jnp.concatenate([tri_e2, padv])
    n_chunks = (t_total + pad) // chunk
    p0c = tri_p0.reshape(n_chunks, chunk, 3)
    e1c = tri_e1.reshape(n_chunks, chunk, 3)
    e2c = tri_e2.reshape(n_chunks, chunk, 3)

    big = jnp.float32(1e30)
    init = (jnp.full((n,), big), jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n,)), jnp.zeros((n,)))

    o = origins[:, None, :]
    d = dirs[:, None, :]

    tri_ids = jnp.arange(chunk, dtype=jnp.int32)[None, :]

    def body(carry, inputs):
        # gather-free reduction: min + tie-break masks (elementwise ops that
        # fuse) instead of argmin/take_along_axis
        best_t, best_tri, best_u, best_v = carry
        p0, e1, e2, base = inputs
        t, u, v, hit = tri_test(o, d, p0[None], e1[None], e2[None], cull_backface)
        ok = hit & (t > tmin[:, None]) & (t < tmax[:, None]) & (t < best_t[:, None])
        t = jnp.where(ok, t, big)
        tj = jnp.min(t, axis=1)
        at_min = t == tj[:, None]
        # tie-break: smallest triangle id among the minima
        jid = jnp.min(jnp.where(at_min, tri_ids, chunk), axis=1)
        pick = at_min & (tri_ids == jid[:, None])
        uj = jnp.sum(jnp.where(pick, u, 0.0), axis=1)
        vj = jnp.sum(jnp.where(pick, v, 0.0), axis=1)
        improved = tj < best_t
        sel = lambda new, old: jnp.where(improved, new, old)
        best_t = sel(tj, best_t)
        best_tri = sel(base + jid, best_tri)
        best_u = sel(uj, best_u)
        best_v = sel(vj, best_v)
        return (best_t, best_tri, best_u, best_v), None

    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (bt, btri, bu, bv), _ = jax.lax.scan(body, init, (p0c, e1c, e2c, bases))
    return Hit(t=bt, tri=btri, u=bu, v=bv)


def brute_force_any(origins, dirs, tri_p0, tri_e1, tri_e2,
                    tmin, tmax, chunk: int = 512):
    """Any-hit (occlusion): True where some triangle blocks [tmin, tmax]."""
    n = origins.shape[0]
    t_total = tri_p0.shape[0]
    pad = (-t_total) % chunk
    if pad:
        padv = jnp.zeros((pad, 3), tri_p0.dtype)
        tri_p0 = jnp.concatenate([tri_p0, padv])
        tri_e1 = jnp.concatenate([tri_e1, padv])
        tri_e2 = jnp.concatenate([tri_e2, padv])
    n_chunks = (t_total + pad) // chunk
    p0c = tri_p0.reshape(n_chunks, chunk, 3)
    e1c = tri_e1.reshape(n_chunks, chunk, 3)
    e2c = tri_e2.reshape(n_chunks, chunk, 3)
    o = origins[:, None, :]
    d = dirs[:, None, :]

    def body(occluded, inputs):
        p0, e1, e2 = inputs
        t, _, _, hit = tri_test(o, d, p0[None], e1[None], e2[None], False)
        ok = hit & (t > tmin[:, None]) & (t < tmax[:, None])
        return occluded | jnp.any(ok, axis=1), None

    occluded, _ = jax.lax.scan(body, jnp.zeros((n,), bool), (p0c, e1c, e2c))
    return occluded
