"""Shared wavefront plumbing: camera rays, film accumulation."""
from __future__ import annotations

import jax.numpy as jnp

from ..utils import rng as rng_mod


def camera_rays(eye, U, V, W, width: int, height: int,
                subframe: int | jnp.ndarray, block: int = 0):
    """Generate one primary ray per pixel (reference raygen.cu:100-113):
    lane i = pixel (x=i%W, y=i//W); subframe 0 uses the pixel center, later
    subframes jitter. Returns (origins, dirs, rng_state) with N = W*H lanes.
    Row 0 is the image bottom (d.y = -1).

    block > 0 emits lanes in block x block pixel tiles (arithmetic lane ->
    pixel decode, no gathers) so consecutive lane groups are spatially
    coherent — the layout the tiled traversal wants
    (ops/tile_trace.block_order gives the equivalent permutation)."""
    n = width * height
    lane = jnp.arange(n, dtype=jnp.uint32)
    state = rng_mod.seed(lane, jnp.asarray(subframe, jnp.uint32))
    jx, state = rng_mod.next_float(state)
    jy, state = rng_mod.next_float(state)
    first = jnp.asarray(subframe, jnp.int32) == 0
    jx = jnp.where(first, 0.5, jx)
    jy = jnp.where(first, 0.5, jy)
    if block:
        bw = width // block
        bid = lane // (block * block)
        within = lane % (block * block)
        x = ((bid % bw) * block + within % block).astype(jnp.float32)
        y = ((bid // bw) * block + within // block).astype(jnp.float32)
    else:
        x = (lane % width).astype(jnp.float32)
        y = (lane // width).astype(jnp.float32)
    dx = 2.0 * (x + jx) / width - 1.0
    dy = 2.0 * (y + jy) / height - 1.0
    eye = jnp.asarray(eye, jnp.float32)
    U = jnp.asarray(U, jnp.float32)
    V = jnp.asarray(V, jnp.float32)
    W = jnp.asarray(W, jnp.float32)
    d = dx[:, None] * U + dy[:, None] * V + W
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(eye, d.shape)
    return o, d, state


def accumulate(accum, sample, subframe, clamp_c: float | None = None):
    """Progressive running mean (raygen.cu:158-166).

    clamp_c enables a CONSISTENT progressive firefly clamp (beyond reference
    parity — the reference accumulates unclamped, cuProg.h:901-938): each
    subframe's per-channel radiance is capped at clamp_c * sqrt(subframe+1),
    so the bound grows without limit and the bias vanishes as N -> inf while
    the unbounded-second-moment connection tail (relMSE falling slower than
    1/N on the cove interior) is cut to a finite-variance
    estimator at every finite N."""
    if clamp_c is not None:
        bound = clamp_c * jnp.sqrt(jnp.asarray(subframe, jnp.float32) + 1.0)
        sample = jnp.minimum(sample, bound)
    a = 1.0 / (jnp.asarray(subframe, jnp.float32) + 1.0)
    return accum + (sample - accum) * a
