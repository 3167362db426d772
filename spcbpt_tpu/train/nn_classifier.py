"""Optional neural refinement of the subspace sampling distribution (C21).

The reference contains a complete but UNUSED-in-main per-eye-subspace MLP
trainer (reference: network_operator device_thrust.cu:1836-2824 — positional
encoding :1384, batched per-class GEMMs via cublasSgemmBatched :2138, relu,
softmax-with-temperature :2558, Kaiming init :1486; network_parameter
:2870-3079 refines labels over a 32-nearby-subspace close set). It corresponds
to the paper's learned-classification extension; main only calls the matrix
trainer. We provide the same capability behind a flag, shaped as batched
matrix products:

- every eye subspace owns a small MLP (stacked weights, one batched einsum —
  the analogue of the reference's batched cuBLAS GEMMs, run at float32
  precision rather than a GPU's default TF32);
- input is a sin/cos positional encoding of the connection point;
- output is a distribution over that eye subspace's CLOSE_SET nearest light
  subspaces (softmax with temperature), which refines the trained Gamma row
  at sampling time;
- training minimizes the same second-moment objective as the Gamma matrix,
  with optax Adam (autodiff instead of the reference's hand-written backward).

Disabled by default, as in the reference (preprocessing uses train_optimal_E
only, optixPathTracer.cpp:600).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..utils import struct
from ..config import NUM_SUBSPACE

CLOSE_SET = 32          # nearby light subspaces per eye subspace (ref :2870)
ENC_FREQS = 4           # positional encoding octaves (ref position_encoding)
HIDDEN = 32
TEMPERATURE = 2.0       # softmax temperature (sigmoid_peak_op :2558)
# float32 products: a GPU would otherwise run them in TF32 (10 mantissa bits)
_PRECISION = jax.lax.Precision.HIGHEST


class NNParams(NamedTuple):
    w1: jnp.ndarray       # (S, F, H)
    b1: jnp.ndarray       # (S, H)
    w2: jnp.ndarray       # (S, H, CLOSE_SET)
    b2: jnp.ndarray       # (S, CLOSE_SET)


class NNState(NamedTuple):
    params: NNParams
    close_set: jnp.ndarray  # (S, CLOSE_SET) int32 light-subspace ids (static data)


@struct.dataclass
class NNTables:
    """Render-time form of the trained network, carried on SubspaceState.nn.

    When present, the first-stage light-subspace pick becomes the mixture
        p(l | e, x) = (1-blend) * Gamma_mix(e, l)
                    + blend * softmax_close(e, x)(l)
    where softmax_close is this network's distribution over the eye
    subspace's CLOSE_SET nearest light subspaces at the eye vertex x.
    The reported pmf is this exact mixture, so the estimator stays unbiased;
    the label-level RMIS strategy weights (rmis.rate_parts) keep using
    Gamma — any self-consistent partition of unity is a valid MIS weight,
    the position-dependent part only moves weights off the variance optimum.
    """
    w1: jnp.ndarray          # (S, F, H)
    b1: jnp.ndarray          # (S, H)
    w2: jnp.ndarray          # (S, H, CLOSE_SET)
    b2: jnp.ndarray          # (S, CLOSE_SET)
    close_set: jnp.ndarray   # (S, CLOSE_SET) int32
    scene_lo: jnp.ndarray    # (3,) for the positional encoding
    scene_hi: jnp.ndarray    # (3,)
    blend: float = struct.field(pytree_node=False, default=0.5)


def tables_from_state(state: NNState, scene_lo, scene_hi,
                      blend: float = 0.5) -> NNTables:
    p = state.params
    return NNTables(w1=p.w1, b1=p.b1, w2=p.w2, b2=p.b2,
                    close_set=state.close_set,
                    scene_lo=jnp.asarray(scene_lo, jnp.float32),
                    scene_hi=jnp.asarray(scene_hi, jnp.float32),
                    blend=blend)


def close_probs(nt: NNTables, eye_label, position, normal):
    """Per-lane close-set distribution at an eye vertex.
    Returns (probs (N, CLOSE_SET) summing to 1, ids (N, CLOSE_SET))."""
    feats = encode(position, normal, nt.scene_lo, nt.scene_hi)
    row = jnp.clip(eye_label, 0, nt.w1.shape[0] - 1)
    h = jax.nn.relu(jnp.einsum("nf,nfh->nh", feats, nt.w1[row],
                               precision=_PRECISION,
                               preferred_element_type=jnp.float32)
                    + nt.b1[row])
    logits = jnp.einsum("nh,nhk->nk", h, nt.w2[row], precision=_PRECISION,
                        preferred_element_type=jnp.float32) + nt.b2[row]
    return jax.nn.softmax(logits / TEMPERATURE, axis=-1), nt.close_set[row]


def close_pmf_of(probs, ids, light_subspace):
    """pmf the close-set distribution assigns to a given light subspace
    (0 when outside the close set). Shapes: probs/ids (N,K), l (N,)."""
    match = ids == light_subspace[..., None].astype(ids.dtype)
    return jnp.sum(jnp.where(match, probs, 0.0), axis=-1)


def feature_dim() -> int:
    return 3 * 2 * ENC_FREQS + 3  # enc(position) + normal


def encode(position, normal, scene_lo, scene_hi):
    """Sin/cos positional encoding of the normalized position + raw normal
    (reference position_encoding device_thrust.cu:1384)."""
    p = (position - scene_lo) / jnp.maximum(scene_hi - scene_lo, 1e-6)
    feats = [normal]
    for k in range(ENC_FREQS):
        w = (2.0 ** k) * jnp.pi
        feats.append(jnp.sin(w * p))
        feats.append(jnp.cos(w * p))
    return jnp.concatenate(feats, axis=-1)


def init_params(rng: np.random.Generator, gamma: np.ndarray) -> NNParams:
    """Kaiming init (ref :1486); close sets = top-CLOSE_SET Gamma columns of
    each eye row (the reference builds close sets from subspace affinity)."""
    s = NUM_SUBSPACE
    f = feature_dim()
    w1 = rng.normal(0, np.sqrt(2.0 / f), (s, f, HIDDEN)).astype(np.float32)
    w2 = rng.normal(0, np.sqrt(2.0 / HIDDEN),
                    (s, HIDDEN, CLOSE_SET)).astype(np.float32)
    close = np.argsort(-gamma, axis=1)[:, :CLOSE_SET].astype(np.int32)
    return NNState(params=NNParams(w1=jnp.asarray(w1),
                                   b1=jnp.zeros((s, HIDDEN)),
                                   w2=jnp.asarray(w2),
                                   b2=jnp.zeros((s, CLOSE_SET))),
                   close_set=jnp.asarray(close))


def forward(state: NNState, eye_label, feats):
    """Per-sample distribution over the eye subspace's close set.
    feats: (N, F); eye_label: (N,). Returns (probs (N, CLOSE_SET),
    light_ids (N, CLOSE_SET))."""
    params = state.params
    w1 = params.w1[eye_label]          # (N, F, H) gather
    b1 = params.b1[eye_label]
    w2 = params.w2[eye_label]
    b2 = params.b2[eye_label]
    h = jax.nn.relu(jnp.einsum("nf,nfh->nh", feats, w1, precision=_PRECISION,
                               preferred_element_type=jnp.float32) + b1)
    logits = jnp.einsum("nh,nhk->nk", h, w2, precision=_PRECISION,
                        preferred_element_type=jnp.float32) + b2
    probs = jax.nn.softmax(logits / TEMPERATURE, axis=-1)
    return probs, state.close_set[eye_label]


def refined_gamma_row(state: NNState, gamma, eye_label, feats,
                      blend: float = 0.5):
    """Gamma row refined by the network: probability mass inside the close
    set is redistributed by the MLP; the rest of the row is kept."""
    probs, ids = forward(state, eye_label, feats)
    row = gamma[eye_label]
    close_mass = jnp.take_along_axis(row, ids, axis=-1).sum(-1, keepdims=True)
    refined = row.at[jnp.arange(row.shape[0])[:, None], ids].set(
        (1 - blend) * jnp.take_along_axis(row, ids, axis=-1)
        + blend * probs * close_mass)
    return refined


def second_moment_loss(params: NNParams, close_set, gamma, batch):
    """Same objective as the Gamma matrix trainer, with the network's refined
    row as the first-stage pmf. batch: dict with eye_label (N,), feats (N,F),
    light_label (N,), f_square, pdf0, peak (N,)."""
    probs, ids = forward(NNState(params, close_set), batch["eye_label"],
                         batch["feats"])
    # pmf of the actually-used light subspace under the refined distribution
    match = (ids == batch["light_label"][:, None])
    inside = jnp.any(match, axis=-1)
    pmf_net = jnp.sum(jnp.where(match, probs, 0.0), axis=-1)
    row_pmf = gamma[batch["eye_label"], batch["light_label"]]
    pmf = jnp.where(inside, pmf_net * 0.5 + row_pmf * 0.5, row_pmf)
    den = batch["pdf0"] + pmf * batch["peak"] + 1e-9
    return jnp.mean(batch["f_square"] / den)


def train_from_corpus(state: NNState, gamma_mixed, td, a_position, a_normal,
                      label_a, label_b, scene_lo, scene_hi,
                      blend: float = 0.5, lr: float = 1e-3,
                      batch_size: int = 4096, epochs: int = 1,
                      max_paths: int = 500_000):
    """Train the close-set network on the pretrace corpus against the SAME
    second-moment objective as the Gamma matrix (gamma_train.loss_fn), with
    the render-time BLENDED first-stage density in the denominator:
        den = pdf0 + sum_c [(1-b) Gamma_mix(e_c,l_c) + b nn(l_c|e_c,x_c)] peak_c
    Gamma stays frozen; only the network moves. Inputs follow
    gamma_train.GammaTrainData (f_square/pdf0/peak/valid per path, peak=0 on
    invalid slots) plus the per-connection endpoints (P,C,3)/(P,C).
    Returns (NNTables, losses). Reference analogue: network_operator's
    trainer (device_thrust.cu:1836-2824), driven by train_optimal_E-style
    batching; unused in the reference's main, wired behind --nn here."""
    g = jnp.asarray(gamma_mixed)
    lo = jnp.asarray(scene_lo, jnp.float32)
    hi = jnp.asarray(scene_hi, jnp.float32)
    n = min(int(td.f_square.shape[0]), max_paths)
    opt = optax.chain(optax.zero_nans(), optax.adam(lr))
    opt_state = opt.init(state.params)

    def loss_fn(params, b):
        st = NNState(params, state.close_set)
        pc, cc = b["pos"].shape[0], b["pos"].shape[1]
        feats = encode(b["pos"].reshape(-1, 3), b["nrm"].reshape(-1, 3),
                       lo, hi)
        la = jnp.clip(b["la"].reshape(-1), 0, NUM_SUBSPACE - 1)
        lb = jnp.clip(b["lb"].reshape(-1), 0, NUM_SUBSPACE - 1)
        probs, ids = forward(st, la, feats)
        p_close = close_pmf_of(probs, ids, lb).reshape(pc, cc)
        p_row = g[la, lb].reshape(pc, cc)
        p_blend = (1.0 - blend) * p_row + blend * p_close
        den = b["pdf0"] + jnp.sum(p_blend * b["peak"], axis=1) + 1e-9
        loss = jnp.where(b["valid"], b["f_square"], 0.0) / den
        return jnp.sum(loss) / jnp.maximum(jnp.sum(b["valid"]), 1)

    @jax.jit
    def step(params, opt_state, b):
        loss, grads = jax.value_and_grad(loss_fn)(params, b)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    params = state.params
    losses = []
    for _ in range(epochs):
        for i0 in range(0, n - batch_size + 1, batch_size):
            sl = slice(i0, i0 + batch_size)
            b = dict(pos=jnp.asarray(a_position[sl]),
                     nrm=jnp.asarray(a_normal[sl]),
                     la=jnp.asarray(label_a[sl]),
                     lb=jnp.asarray(label_b[sl]),
                     pdf0=td.pdf0[sl], peak=td.peak[sl],
                     f_square=td.f_square[sl], valid=td.valid[sl])
            params, opt_state, loss = step(params, opt_state, b)
            losses.append(float(loss))
    return tables_from_state(NNState(params, state.close_set), lo, hi,
                             blend), losses


def train(state: NNState, gamma, batches, lr: float = 1e-3):
    opt = optax.adam(lr)
    opt_state = opt.init(state.params)

    @jax.jit
    def step(params, opt_state, batch):
        loss, g = jax.value_and_grad(second_moment_loss)(
            params, state.close_set, gamma, batch)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    params = state.params
    losses = []
    for batch in batches:
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return NNState(params, state.close_set), losses
