"""LVC processing: per-subspace vertex CMFs + the two-stage sampler.

The reference copies up to 800k vertices to the host every frame and groups
them by subspace in a CPU loop (reference: MyThrustOp::LVC_Process
device_thrust.cu:241-332). Here the grouping is a device-side stable sort by
subspace + segmented cumsum — no host round trip.

Sampler semantics match SubspaceSampler_device (cuProg.h:266-302):
first stage picks a light subspace from the eye subspace's Gamma-CMF row;
second stage picks a cached vertex from that subspace's weight CMF
(weight = float3weight(flux)/pdf, device_thrust.cu:200-207). The final pmf is
path_count * pmf1 * pmf2 (raygen.cu:410-414).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils import struct
from ..config import NUM_SUBSPACE
from ..ops.cmf import segment_pmf, segment_searchsorted
from ..train import classify
from ..utils import rng as rng_mod
from ..utils import vec
from .vertex import LightVertices, pack_matrix, reshape_flat


@struct.dataclass
class LVCSampler:
    vertices: LightVertices      # flat (V,) SoA
    order: jnp.ndarray           # (V,) int32: sorted-by-subspace vertex index
    cmf: jnp.ndarray             # (V,) segment-local cumulative weights (normalized)
    seg_start: jnp.ndarray       # (NUM_SUBSPACE,) int32
    seg_size: jnp.ndarray        # (NUM_SUBSPACE,) int32
    seg_sum: jnp.ndarray         # (NUM_SUBSPACE,) float32
    vertex_count: jnp.ndarray    # () int32 valid vertices
    path_count: jnp.ndarray      # () int32 valid light paths
    # packed (V, 32) copy of `vertices` (vertex.pack_matrix): connection
    # draws fetch one row instead of ~20 scalar gathers
    packed: jnp.ndarray = None
    # per-subspace presampled second-stage tables (see presample_tables):
    # table_idx[s, k] = vertex flat-index of the k-th presampled draw for
    # subspace s; table_pmf[s, k] = the density that draw was made from.
    # Picking a uniform slot and dividing by table_pmf is unbiased for the
    # table_mode distribution (E[f/p] over the i.i.d. table draws), and
    # replaces an 18 ms/wavefront CMF bisection with two sub-ms gathers.
    table_idx: jnp.ndarray = None    # (NUM_SUBSPACE, K) int32
    table_pmf: jnp.ndarray = None    # (NUM_SUBSPACE, K) f32
    # fused (idx, pmf) copy: one render-time gather instead of two; pmf is
    # zeroed on empty subspaces so ok_seg needs no extra seg_size gather
    # (idx stored as f32 — vertex indices < 2^24, exact)
    table_pack: jnp.ndarray = None   # (NUM_SUBSPACE, K, 2) f32
    table_mode: str = struct.field(pytree_node=False, default=None)
    # True when `packed` carries the precomputed tracing_weight_light column
    # (vertex.WEIGHT_B_COL) — requires building with the SubspaceState
    has_weight_b: bool = struct.field(pytree_node=False, default=False)


def build_sampler(lv: LightVertices, table_mode: str = None,
                  table_k: int = 128, table_seed: int = 0,
                  ss=None) -> LVCSampler:
    """table_mode: presample per-subspace connection tables for this
    second-stage mode ("weighted" | "mixture"; "uniform" needs none).
    MUST match the SubspaceState's second_stage or the MIS rate calibration
    breaks — renderers only use a table whose mode matches.

    ss (optional SubspaceState): when given, the packed matrix additionally
    carries each vertex's precomputed light-side strategy weight
    (rmis.tracing_weight_light — a pure function of vertex fields), saving a
    Gamma gather per connection draw in the fused evaluator."""
    flat = reshape_flat(lv)
    v_count = flat.valid.shape[0]

    w = vec.float3weight(flat.ratio)
    w = jnp.where(jnp.isnan(w) | jnp.isinf(w), 0.0, w)
    w = jnp.where(flat.valid, w, 0.0)

    key = jnp.where(flat.valid, flat.subspace_id, NUM_SUBSPACE).astype(jnp.int32)
    order = jnp.argsort(key, stable=True).astype(jnp.int32)
    skey = key[order]
    sw = w[order]

    csum = jnp.cumsum(sw)
    ones = jnp.where(flat.valid, 1, 0)
    counts = jnp.zeros(NUM_SUBSPACE + 1, jnp.int32).at[key].add(ones)
    seg_sum = jnp.zeros(NUM_SUBSPACE + 1, jnp.float32).at[key].add(w)
    start = jnp.cumsum(counts) - counts

    base = jnp.where(start > 0, csum[jnp.maximum(start - 1, 0)], 0.0)
    denom = jnp.maximum(seg_sum, 1e-30)
    cmf = (csum - base[skey]) / denom[skey]

    wb = None
    if ss is not None:
        from . import rmis
        wb = rmis.tracing_weight_light(None, ss, flat, None)
    s = LVCSampler(
        vertices=flat, order=order, cmf=cmf,
        seg_start=start[:NUM_SUBSPACE], seg_size=counts[:NUM_SUBSPACE],
        seg_sum=seg_sum[:NUM_SUBSPACE],
        vertex_count=jnp.sum(ones),
        path_count=jnp.sum(jnp.where(flat.valid & (flat.depth == 0), 1, 0)),
        packed=pack_matrix(flat, weight_b=wb),
        has_weight_b=wb is not None,
    )
    if table_mode in ("weighted", "mixture"):
        idx, pmf = presample_tables(s, table_mode, table_k, table_seed)
        pmf_ok = jnp.where((s.seg_size > 0)[:, None], pmf, 0.0)
        pack = jnp.stack([idx.astype(jnp.float32), pmf_ok], axis=-1)
        s = s.replace(table_idx=idx, table_pmf=pmf, table_pack=pack,
                      table_mode=table_mode)
    return s


def table_mode_for(ss) -> str:
    """The presample mode matching a SubspaceState's second stage (None when
    no table helps: untrained states connect uniformly; the 'uniform' second
    stage is already O(1))."""
    if ss is None or not ss.trained:
        return None
    return ss.second_stage if ss.second_stage in ("weighted", "mixture") \
        else None


def make_builder(ss, table_k: int = 128):
    """Jitted per-frame sampler builder whose presampled table mode matches
    ss — the common caller pattern (build(lt(frame), frame))."""
    import jax
    mode = table_mode_for(ss)

    def f(lv, seed=0):
        return build_sampler(lv, table_mode=mode, table_k=table_k,
                             table_seed=seed, ss=ss)
    return jax.jit(f)


def presample_tables(s: LVCSampler, mode: str, k: int, seed: int = 0):
    """Draw K i.i.d. second-stage samples per subspace ONCE per frame and
    record the density each was drawn from. Render-time draws pick a uniform
    slot; since every slot is an i.i.d. draw from the mode's density p and
    the estimator divides by the recorded p(v_slot), E[f/p] equals the
    segment sum — unbiased, same marginal targeting as the per-draw CMF
    bisection (cuProg.h:268-288), shared across the frame's eye vertices."""
    lsub = jnp.tile(jnp.arange(NUM_SUBSPACE, dtype=jnp.int32), (k,))
    state = rng_mod.seed(
        jnp.arange(lsub.shape[0], dtype=jnp.uint32),
        jnp.asarray(seed, jnp.uint32) + jnp.uint32(0x7ab1e))
    if mode == "mixture":
        idx, pmf, _, _ = sample_second_stage_mixture(s, lsub, state)
    else:
        idx, pmf, _, _ = sample_second_stage(s, lsub, state)
    # (k*S,) -> (S, k)
    return (idx.reshape(k, NUM_SUBSPACE).T,
            pmf.reshape(k, NUM_SUBSPACE).T)


def sample_second_stage_table(s: LVCSampler, light_subspace, state):
    """O(1) presampled second stage: uniform slot from the subspace's table
    (presample_tables). Returns (vertex flat-index, pmf, valid, state).

    Uses the fused (idx, pmf) pack when present — ONE gather, with empty
    subspaces signaled by pmf == 0 (exactly the lanes the old seg_size
    gather invalidated; downstream already requires pmf > 0)."""
    r, state = rng_mod.next_float(state)
    k = s.table_idx.shape[1]
    slot = jnp.clip((r * k).astype(jnp.int32), 0, k - 1)
    row = light_subspace.astype(jnp.int32)
    if s.table_pack is not None:
        packed = s.table_pack[row, slot]
        pmf = packed[..., 1]
        return packed[..., 0].astype(jnp.int32), pmf, pmf > 0.0, state
    idx = s.table_idx[row, slot]
    pmf = s.table_pmf[row, slot]
    return idx, pmf, s.seg_size[row] > 0, state


def sample_first_stage(ss: classify.SubspaceState, eye_subspace, state,
                       position=None, normal=None):
    """Pick a light subspace from the eye subspace's Gamma row.

    Uses O(1) alias tables when published (2 gathers instead of the
    reference's ~10-round CMF binary search, cuProg.h:290-302; identical
    distribution). Returns (light_subspace, pmf, state).

    When ss.nn is set (close-set refinement network, train/nn_classifier)
    and the eye vertex is supplied, samples the blended mixture
        (1-b) * Gamma_row + b * nn_close(x)
    and reports its exact pmf — the denominator stays the true sampling
    density, so the estimator is unbiased for any network."""
    if ss.nn is not None and position is not None:
        from ..train import nn_classifier as nn_mod
        row = eye_subspace.astype(jnp.int32)
        probs, ids = nn_mod.close_probs(ss.nn, row, position, normal)
        r_sel, state = rng_mod.next_float(state)
        r_cl, state = rng_mod.next_float(state)
        # close-set categorical via row cumsum (K=32 lanes, no gather)
        cum = jnp.cumsum(probs, axis=-1)
        k = jnp.sum((cum < r_cl[..., None] * cum[..., -1:]), axis=-1)
        k = jnp.clip(k, 0, probs.shape[-1] - 1)
        l_nn = jnp.take_along_axis(ids, k[..., None], axis=-1)[..., 0]
        l_row, pmf_row_l, state = sample_first_stage(
            ss.replace(nn=None), eye_subspace, state)
        b = ss.nn.blend
        take_nn = r_sel < b
        l = jnp.where(take_nn, l_nn, l_row).astype(jnp.int32)
        pmf = ((1.0 - b) * classify.gamma_block(ss, row, l)
               + b * nn_mod.close_pmf_of(probs, ids, l))
        return l, pmf, state
    r, state = rng_mod.next_float(state)
    row = eye_subspace.astype(jnp.int32)
    if ss.alias_pack is not None:
        # fused alias row: [prob, idx, pmf_take, pmf_alias] in ONE gather
        scaled = r * NUM_SUBSPACE
        j = jnp.clip(scaled.astype(jnp.int32), 0, NUM_SUBSPACE - 1)
        frac = scaled - j.astype(jnp.float32)
        packed = ss.alias_pack[row, j]
        take = frac < packed[..., 0]
        l = jnp.where(take, j, packed[..., 1].astype(jnp.int32))
        pmf = jnp.where(take, packed[..., 2], packed[..., 3])
        return l, pmf, state
    if ss.alias_prob is not None and ss.alias_prob.shape[0] == NUM_SUBSPACE:
        scaled = r * NUM_SUBSPACE
        j = jnp.clip(scaled.astype(jnp.int32), 0, NUM_SUBSPACE - 1)
        frac = scaled - j.astype(jnp.float32)
        take = frac < ss.alias_prob[row, j]
        l = jnp.where(take, j, ss.alias_idx[row, j])
        pmf = classify.gamma_block(ss, row, l)
        return l.astype(jnp.int32), pmf, state
    flat = ss.cmf_gamma.reshape(-1)
    base = row * NUM_SUBSPACE
    size = jnp.full_like(base, NUM_SUBSPACE)
    l = segment_searchsorted(flat, base, size, r, NUM_SUBSPACE)
    pmf = segment_pmf(flat, base, l)
    return l.astype(jnp.int32), pmf, state


def sample_second_stage(s: LVCSampler, light_subspace, state):
    """Pick a cached vertex from the subspace's weight CMF (cuProg.h:268-288).
    Returns (vertex flat-index, pmf, valid, state)."""
    r, state = rng_mod.next_float(state)
    base = s.seg_start[light_subspace]
    size = s.seg_size[light_subspace]
    l = segment_searchsorted(s.cmf, base, size, r, int(s.cmf.shape[0]))
    pmf = segment_pmf(s.cmf, base, l)
    idx = s.order[jnp.clip(base + l, 0, s.order.shape[0] - 1)]
    return idx, pmf, size > 0, state


def sample_uniform(s: LVCSampler, state):
    """Classic-BDPT uniform vertex pick (cuProg.h:279-287 uniformSample).
    Returns (vertex flat-index, pmf, valid, state)."""
    r, state = rng_mod.next_float(state)
    # valid vertices occupy the first vertex_count slots of `order`
    j = jnp.clip((r * s.vertex_count).astype(jnp.int32), 0,
                 jnp.maximum(s.vertex_count - 1, 0))
    idx = s.order[j]
    pmf = 1.0 / jnp.maximum(s.vertex_count.astype(jnp.float32), 1.0)
    return idx, pmf, s.vertex_count > 0, state


def sample_second_stage_mixture(s: LVCSampler, light_subspace, state):
    """Defensive 50/50 mixture second stage: half the draws pick uniformly
    within the subspace, half by the flux-weighted CMF; the reported pmf is
    the exact mixture density 0.5/n_l + 0.5*w_v/W_l. Robust across scenes:
    flux-weighting is near-optimal when visibility ~ 1 (open scenes) but
    oversamples invisible bright vertices on occluded interiors, where the
    uniform component bounds the loss at 2x (measured: each pure mode is
    5-10x WORSE than the other on its bad scene class)."""
    rsel, state = rng_mod.next_float(state)
    r, state = rng_mod.next_float(state)
    base = s.seg_start[light_subspace]
    size = s.seg_size[light_subspace]
    # flux-CMF pick
    l_w = segment_searchsorted(s.cmf, base, size, r, int(s.cmf.shape[0]))
    # uniform pick
    l_u = jnp.clip((r * size.astype(jnp.float32)).astype(jnp.int32), 0,
                   jnp.maximum(size - 1, 0))
    l = jnp.where(rsel < 0.5, l_u, l_w)
    pmf_w = segment_pmf(s.cmf, base, l)
    pmf_u = 1.0 / jnp.maximum(size.astype(jnp.float32), 1.0)
    idx = s.order[jnp.clip(base + l, 0, s.order.shape[0] - 1)]
    return idx, 0.5 * pmf_u + 0.5 * pmf_w, size > 0, state


def sample_second_stage_uniform(s: LVCSampler, light_subspace, state):
    """O(1) second stage: uniform vertex pick WITHIN the chosen subspace
    (pmf = 1/segment_size). Trades the reference's flux-weighted vertex CMF
    (cuProg.h:268) for a single gather; the subspace targeting (the main
    SPCBPT variance win) is unchanged and the pmf stays exact."""
    r, state = rng_mod.next_float(state)
    base = s.seg_start[light_subspace]
    size = s.seg_size[light_subspace]
    l = jnp.clip((r * size.astype(jnp.float32)).astype(jnp.int32), 0,
                 jnp.maximum(size - 1, 0))
    idx = s.order[jnp.clip(base + l, 0, s.order.shape[0] - 1)]
    pmf = 1.0 / jnp.maximum(size.astype(jnp.float32), 1.0)
    return idx, pmf, size > 0, state
