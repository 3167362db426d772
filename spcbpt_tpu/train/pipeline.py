"""End-to-end SPCBPT preprocessing: the "training phase" of the renderer.

Mirrors the reference driver (reference: preprocessing()
optixPathTracer.cpp:552-608):
  1. pretrace NEE paths until target_samples accepted paths exist
  2. spatially reweight contributions (10x10 pixel blocks)
  3. build eye (1000-label) and light (800-label) classifiers from weighted
     connection endpoints
  4. label every connection record
  5. estimate Q from light-trace launches until target_q_samples paths
  6. initialize Gamma from contribution integrals, train with Adam
  7. publish Q + CMFGamma in a trained SubspaceState
"""
from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..config import NUM_SUBSPACE, PretraceConfig
from ..render import light_trace
from ..scene.scene import TraceScene
from ..utils import vec
from . import classify, gamma_train, pretrace, qgamma


@dataclasses.dataclass
class PreprocessStats:
    n_paths: int = 0
    n_conns: int = 0
    q_paths: int = 0
    gamma_losses: list = dataclasses.field(default_factory=list)
    nn_losses: list = dataclasses.field(default_factory=list)
    seconds: dict = dataclasses.field(default_factory=dict)


def _concat_batches(batches):
    return jax.tree_util.tree_map(
        lambda *xs: np.concatenate([np.asarray(x) for x in xs]), *batches)


def preprocess(ts: TraceScene, cam_uvw, width: int, height: int,
               cfg: PretraceConfig | None = None,
               lt_paths: int = 100_000, lt_depth: int = 8,
               gamma_cfg=None, nn_train: bool = False,
               verbose: bool = False):
    """Returns (SubspaceState with trained=True, PreprocessStats)."""
    cfg = cfg or PretraceConfig()
    stats = PreprocessStats()
    t_all = time.time()

    # --- 1. pretrace ---
    t0 = time.time()
    launch_jit = jax.jit(pretrace.make_pretracer(cam_uvw, cfg.num_core,
                                                 cfg.padding))
    launch = lambda f: launch_jit(ts, f)
    batches = []
    total = 0
    frame = 0
    # low-acceptance scenes (pure-indirect: NEE rarely connects) need
    # thousands of launches; storing the PADDED batches held ~50 GB host RAM
    # at 2M paths on the cove scene — compact to accepted rows per batch
    while total < cfg.target_samples and frame < 20_000:
        b = launch(frame)
        frame += 1
        b_host = jax.device_get(b)
        keep = b_host.valid
        if keep.any():
            batches.append(type(b_host)(*[np.asarray(f)[keep]
                                          for f in b_host]))
            total += int(keep.sum())
        if verbose and frame % 20 == 0:
            print(f"pretrace: {total}/{cfg.target_samples} paths "
                  f"({frame} launches)")
    data = _concat_batches(batches)
    stats.n_paths = total
    stats.n_conns = int(data.conn_valid.sum())
    stats.seconds["pretrace"] = time.time() - t0

    # --- 2. reweight ---
    contri = np.asarray(qgamma.sample_reweight(
        jnp.asarray(data.contri), jnp.asarray(data.sample_pdf),
        jnp.asarray(data.pixel), width, height))
    data = data._replace(contri=contri)

    # --- 3. classifiers ---
    t0 = time.time()
    w_path = vec.float3weight(jnp.asarray(contri)) / np.maximum(
        data.sample_pdf, 1e-30)
    w_path = np.where(np.isfinite(np.asarray(w_path)) & data.valid,
                      np.asarray(w_path), 0.0)
    cv = data.conn_valid
    w_conn = np.broadcast_to(w_path[:, None], cv.shape)[cv]
    eye_cls = classify.build_classifier(
        data.a_position[cv], data.a_normal[cv], w_conn, NUM_SUBSPACE)
    light_mask = cv & ~data.light_source
    w_light = np.broadcast_to(w_path[:, None], cv.shape)[light_mask]
    light_cls = classify.build_classifier(
        data.b_position[light_mask], data.b_normal[light_mask], w_light,
        classify.NUM_LIGHT_TREE_SUBSPACE)
    stats.seconds["trees"] = time.time() - t0

    # --- 4. label connections (node_label device_thrust.cu:569-573) ---
    # chunked: the (N, NUM_SUBSPACE) score matrix of classify() would be
    # ~80 GB at the reference's 2M x 10-conn corpus if done in one call
    cls_eye = jax.jit(lambda p, n: classify.classify(eye_cls, p, n))
    cls_light = jax.jit(lambda p, n: classify.classify(light_cls, p, n))

    def label_chunked(fn, p, n, chunk=1 << 18):
        outs = []
        for i in range(0, len(p), chunk):
            pc = np.zeros((chunk, 3), np.float32)
            nc = np.zeros((chunk, 3), np.float32)
            m = len(p[i:i + chunk])
            pc[:m] = p[i:i + chunk]
            nc[:m] = n[i:i + chunk]
            outs.append(np.asarray(fn(jnp.asarray(pc), jnp.asarray(nc)))[:m])
        return np.concatenate(outs)

    label_a = label_chunked(cls_eye, data.a_position.reshape(-1, 3),
                            data.a_normal.reshape(-1, 3)).reshape(cv.shape)
    bl = label_chunked(cls_light, data.b_position.reshape(-1, 3),
                       data.b_normal.reshape(-1, 3))
    label_b = np.where(data.light_source, data.label_b, bl.reshape(cv.shape))

    # --- 5. Q ---
    t0 = time.time()
    # temporary state: trees trained so light vertices get labeled
    ss_trees = classify.SubspaceState(
        eye=eye_cls, light=light_cls,
        q=jnp.ones((NUM_SUBSPACE,)),
        cmf_gamma=classify.untrained_state().cmf_gamma, trained=True)
    # ts as a jit ARGUMENT (not a closure constant): closed-over device
    # arrays would be embedded in the compiled program as constants
    lt_jit = jax.jit(lambda ts_, ss_, f: light_trace.trace_light_paths(
        ts_, ss_, lt_paths, f, max_depth=lt_depth))
    lt_fn = lambda f: lt_jit(ts, ss_trees, f)
    qb_fn = jax.jit(qgamma.q_batch)
    q_mean = jnp.zeros((NUM_SUBSPACE,))
    occ_total = jnp.zeros((NUM_SUBSPACE,))
    acc_paths = jnp.asarray(0, jnp.int32)
    f = 0
    while int(acc_paths) < cfg.target_q_samples and f < 200:
        qs, oc, pc = qb_fn(lt_fn(f + 7777))
        q_mean, acc_paths = qgamma.q_update(q_mean, acc_paths, qs, pc)
        occ_total = occ_total + oc
        f += 1
    q = qgamma.q_finalize(q_mean)
    inv_occ = qgamma.inv_occ_finalize(occ_total, acc_paths)
    stats.q_paths = int(acc_paths)
    stats.seconds["q"] = time.time() - t0

    # --- 6. Gamma init + train ---
    t0 = time.time()
    g0 = qgamma.gamma_init(jnp.asarray(label_a), jnp.asarray(label_b),
                           jnp.asarray(data.conn_valid),
                           jnp.asarray(data.contri),
                           jnp.asarray(data.sample_pdf))
    batch_nt = pretrace.PretraceBatch(*[jnp.asarray(getattr(data, k))
                                        for k in data._fields])
    td = gamma_train.build_train_data(batch_nt, q, jnp.asarray(label_a),
                                      jnp.asarray(label_b))
    td = gamma_train.clamp_outliers(td)
    gcfg = gamma_cfg or {}
    gamma, losses = gamma_train.train_gamma(
        g0, td, lr=gcfg.get("lr", 0.01),
        batch_size=gcfg.get("batch_size", 20000),
        epochs=gcfg.get("epochs", 1),
        log_every=50 if verbose else 0)
    stats.gamma_losses = losses
    stats.seconds["gamma"] = time.time() - t0

    from ..config import CONSERVATIVE_RATE
    mixed = np.asarray(gamma) * (1.0 - CONSERVATIVE_RATE) \
        + CONSERVATIVE_RATE / NUM_SUBSPACE
    aprob, aidx = classify.build_alias(mixed)

    # --- 6b. optional close-set refinement network (C21, behind --nn) ---
    nn_tables = None
    if nn_train:
        t0 = time.time()
        from . import nn_classifier as nn_mod
        # scene AABB over all three triangle vertices (p0, p0+e1, p0+e2) —
        # min/max of p0 alone lets boundary eye vertices fall outside
        # [lo, hi] and skews the positional encoding baked into checkpoints
        # (ADVICE r3)
        verts = jnp.concatenate([ts.tri_p0, ts.tri_p0 + ts.tri_e1,
                                 ts.tri_p0 + ts.tri_e2])
        lo = np.asarray(jnp.min(verts, axis=0))
        hi = np.asarray(jnp.max(verts, axis=0))
        nn_state = nn_mod.init_params(np.random.default_rng(12345), mixed)
        nn_tables, nn_losses = nn_mod.train_from_corpus(
            nn_state, mixed, td, data.a_position, data.a_normal,
            label_a, label_b, lo, hi)
        stats.nn_losses = nn_losses
        stats.seconds["nn"] = time.time() - t0
        if verbose and nn_losses:
            print(f"[train] nn close-set refinement: loss "
                  f"{nn_losses[0]:.4g} -> {nn_losses[-1]:.4g} "
                  f"({len(nn_losses)} steps)", flush=True)
    from ..render.autotune import select_second_stage
    second, sel_stats = select_second_stage(np.asarray(q),
                                            np.asarray(inv_occ))
    if verbose:
        print(f"[train] second stage '{second}' "
              f"(flux DR {sel_stats['flux_dr']:.2f})", flush=True)
    ss = classify.publish_tables(classify.SubspaceState(
        eye=eye_cls, light=light_cls, q=q,
        cmf_gamma=qgamma.gamma_to_cmf(gamma),
        alias_prob=jnp.asarray(aprob),
        alias_idx=jnp.asarray(aidx),
        inv_occ=inv_occ, nn=nn_tables,
        trained=True, second_stage=second))
    stats.seconds["total"] = time.time() - t_all
    return ss, stats
