"""Multi-chip rendering and training via jax.sharding (new capability — the
reference is single-GPU, SURVEY.md §2 note).

Layout (BASELINE.md config 5, "multi-chip tiled SPCBPT"):
- 2-D device mesh (tile, spp): pixel rows shard over `tile`, independent
  sample streams shard over `spp` and reduce with pmean.
- Scene, BVH, Gamma/Q and classifiers are replicated (they are small; the
  film and ray state dominate).
- The LVC is regenerated per chip with decorrelated seeds instead of
  all-gathered — zero communication, and more total light paths.
- Gamma training is standard data parallelism: batch shards over the mesh,
  gradients psum.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..render import light_trace, lvc, pt, spcbpt
from ..utils import rng as rng_mod


def make_mesh(devices=None, tile: int | None = None, spp: int | None = None):
    """Build a (tile, spp) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if tile is None:
        spp = spp or (2 if n % 2 == 0 and n > 1 else 1)
        tile = n // spp
    elif spp is None:
        spp = n // tile
    assert tile * spp == n, f"mesh {tile}x{spp} != {n} devices"
    import numpy as np
    return Mesh(np.asarray(devices).reshape(tile, spp), ("tile", "spp"))


def _block_camera_rays(eye, U, V, W, width, height, rows_per_tile, tile_idx,
                       stream_idx, subframe):
    """Camera rays for one device's row block; seeds follow the global pixel
    index so results are identical to the single-chip renderer, with the
    sample-stream axis folded into the frame index."""
    n = width * rows_per_tile
    local = jnp.arange(n, dtype=jnp.uint32)
    lane = local + jnp.uint32(width) * jnp.uint32(rows_per_tile) * tile_idx.astype(jnp.uint32)
    frame = jnp.asarray(subframe, jnp.uint32) * jnp.uint32(4096) \
        + stream_idx.astype(jnp.uint32)
    state = rng_mod.seed(lane, frame)
    jx, state = rng_mod.next_float(state)
    jy, state = rng_mod.next_float(state)
    x = (lane % width).astype(jnp.float32)
    y = (lane // width).astype(jnp.float32)
    dx = 2.0 * (x + jx) / width - 1.0
    dy = 2.0 * (y + jy) / height - 1.0
    d = dx[:, None] * U + dy[:, None] * V + W
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(eye, d.shape)
    return o, d, state


def sharded_pt_render(ts, cam_uvw, width: int, height: int, subframe,
                      mesh: Mesh, max_depth: int = 12):
    """One progressive PT sample for the full image, pixels sharded over
    `tile`, sample streams averaged over `spp` with pmean.
    Returns (width*height, 3) sharded along axis 0 over `tile`."""
    eye, U, V, W = [jnp.asarray(x, jnp.float32) for x in cam_uvw]
    n_tile = mesh.shape["tile"]
    assert height % n_tile == 0, (height, n_tile)
    rows = height // n_tile

    def local(ts_rep):
        ti = jax.lax.axis_index("tile")
        si = jax.lax.axis_index("spp")
        o, d, state = _block_camera_rays(eye, U, V, W, width, height, rows,
                                         ti, si, subframe)
        img = pt.make_pt_step(ts_rep, max_depth)(o, d, state)
        return jax.lax.pmean(img, "spp")

    fn = shard_map(local, mesh=mesh, in_specs=(P(),), out_specs=P("tile"),
                   check_vma=False)
    return fn(ts)


def sharded_spcbpt_render(ts, ss, cam_uvw, width: int, height: int, subframe,
                          mesh: Mesh, light_paths_per_chip: int = 8192,
                          light_depth: int = 8, max_depth: int = 12,
                          connection_n: int = 3, uniform: bool = False,
                          sub_blocks: int = 1):
    """Multi-chip tiled SPCBPT: each chip traces its own light sub-paths
    (decorrelated seeds), builds its local LVC sampler, renders its pixel-row
    block, and sample streams pmean over `spp`.

    sub_blocks > 1 splits each chip's row block into that many sequential
    sub-wavefronts (lax.map): peak live-lane memory drops ~sub_blocks-fold
    while the estimator is unchanged — camera rays are seeded by global
    pixel index, and the chip's one LVC sampler serves every sub-block just
    as it serves the whole block. It bounds device memory when one device
    holds a large frame's whole connection wavefront."""
    eye, U, V, W = [jnp.asarray(x, jnp.float32) for x in cam_uvw]
    n_tile = mesh.shape["tile"]
    assert height % n_tile == 0
    rows = height // n_tile
    assert rows % sub_blocks == 0, (rows, sub_blocks)
    rows_b = rows // sub_blocks

    def local(ts_rep, ss_rep):
        ti = jax.lax.axis_index("tile")
        si = jax.lax.axis_index("spp")
        chip = ti * mesh.shape["spp"] + si
        frame = jnp.asarray(subframe, jnp.uint32) * jnp.uint32(65536) \
            + chip.astype(jnp.uint32)
        lv = light_trace.trace_light_paths(ts_rep, ss_rep,
                                           light_paths_per_chip, frame,
                                           max_depth=light_depth)
        sampler = lvc.build_sampler(
            lv, table_mode=None if uniform else lvc.table_mode_for(ss),
            table_seed=frame, ss=ss)
        step = spcbpt.make_spcbpt_step(ts_rep, ss_rep, sampler, max_depth,
                                       connection_n, uniform)

        def one_block(b):
            o, d, state = _block_camera_rays(
                eye, U, V, W, width, height, rows_b,
                ti * sub_blocks + b, si, subframe)
            return step(o, d, state)

        if sub_blocks == 1:
            img = one_block(jnp.int32(0))
        else:
            img = jax.lax.map(one_block,
                              jnp.arange(sub_blocks, dtype=jnp.int32))
            img = img.reshape(rows * width, 3)
        return jax.lax.pmean(img, "spp")

    fn = shard_map(local, mesh=mesh, in_specs=(P(), P()), out_specs=P("tile"),
                   check_vma=False)
    return fn(ts, ss)


def dp_gamma_train_step(theta, opt_state, batch, opt, mesh: Mesh):
    """One data-parallel Gamma training step: the batch shards over the whole
    mesh (both axes flattened); each shard computes the UNNORMALIZED loss sum
    + its valid count, both psum over the mesh, and the division happens on
    the replicated totals — so loss and gradients are exactly the global-batch
    values even for uneven per-shard valid counts (VERDICT r3 weak #4: a
    pmean of per-shard means is biased when shards carry different counts).
    The replicated optimizer update happens outside."""
    import optax
    from ..train.gamma_train import loss_sum_fn

    def inner(batch):
        (s, c), g = jax.value_and_grad(
            lambda t: loss_sum_fn(t, batch), has_aux=True)(
                theta)
        s_tot = jax.lax.psum(s, ("tile", "spp"))
        c_tot = jax.lax.psum(c, ("tile", "spp"))
        g_tot = jax.lax.psum(g, ("tile", "spp"))
        denom = jnp.maximum(c_tot, 1).astype(s_tot.dtype)
        return s_tot / denom, jax.tree_util.tree_map(
            lambda a: a / denom, g_tot)

    loss, g = shard_map(
        inner, mesh=mesh,
        in_specs=(jax.tree_util.tree_map(lambda _: P(("tile", "spp")), batch),),
        out_specs=(P(), P()), check_vma=False)(batch)
    updates, new_opt = opt.update(g, opt_state)
    return optax.apply_updates(theta, updates), new_opt, loss
