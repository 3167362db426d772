"""Integrator-level tests on CPU (small shapes; tolerance-gated)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spcbpt_tpu.render import light_trace, lvc, pt, spcbpt
from spcbpt_tpu.render.common import accumulate
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene
from spcbpt_tpu.train import classify


@pytest.fixture(scope="module")
def cornell():
    ts, desc, cam = load_trace_scene(default_scene_path())
    cam.aspect = 1.0
    return ts, cam.uvw()


def test_pt_frame_finite_and_lit(cornell):
    ts, (eye, U, V, W) = cornell
    img = pt.render_frame_jit(ts, eye, U, V, W, 32, 32, 0, 6)
    a = np.asarray(img)
    assert np.isfinite(a).all()
    assert a.mean() > 0.01  # scene is lit
    assert (a >= 0).all()


def test_light_trace_physicality(cornell):
    ts, _ = cornell
    ss = classify.untrained_state()
    area = float(ts.lights.area[0])  # scene-unit-normalized light area
    lv = light_trace.trace_light_paths(ts, ss, 512, 0, max_depth=4)
    v = jax.tree_util.tree_map(np.asarray, lv)
    # depth 0: all valid, ratio = emission/pdf with pdf = 1/(area*num_lights),
    # single_pdf = the light pdf itself
    assert v.valid[0].all()
    np.testing.assert_allclose(
        v.ratio[0], np.tile([18.4, 15.6, 8.0], (512, 1)) * area, rtol=1e-5)
    np.testing.assert_allclose(v.single_pdf[0], 1.0 / area, rtol=1e-5)
    # depth 1 RMIS_pointer = 1/light_pdf (rmis.h:22-26)
    d1 = v.valid[1]
    assert d1.sum() > 100
    np.testing.assert_allclose(v.rmis[1][d1], area, rtol=1e-4)
    # valid counts decay with depth (RR)
    counts = v.valid.sum(axis=1)
    assert (np.diff(counts) <= 0).all()
    # all stored quantities finite on valid slots
    for field in ("ratio", "single_pdf", "rmis", "position"):
        arr = getattr(v, field)
        assert np.isfinite(arr[v.valid]).all(), field


def test_bdpt_matches_pt_mean(cornell):
    """Cross-convergence: BDPT-uniform and PT must estimate the same image
    (the reference's implicit Space-toggle A/B test, SURVEY.md §4)."""
    ts, (eye, U, V, W) = cornell
    ss = classify.untrained_state()
    W_, H_ = 24, 24
    spp = 24
    lt = jax.jit(lambda f: light_trace.trace_light_paths(ts, ss, 2048, f,
                                                         max_depth=6))
    build = jax.jit(lvc.build_sampler)
    acc_pt = jnp.zeros((W_ * H_, 3))
    acc_bd = jnp.zeros((W_ * H_, 3))
    for s in range(spp):
        acc_pt = accumulate(acc_pt, pt.render_frame_jit(
            ts, eye, U, V, W, W_, H_, s, 8), s)
        sampler = build(lt(s))
        acc_bd = accumulate(acc_bd, spcbpt.render_frame_jit(
            ts, ss, sampler, eye, U, V, W, W_, H_, s,
            max_depth=8, uniform=True), s)
    a = np.asarray(acc_pt)
    b = np.asarray(acc_bd)
    assert np.isfinite(b).all()
    ratio = b.mean(0) / a.mean(0)
    # loose gate at this sample count; systematic deviation beyond ~15%
    # means an estimator bug rather than noise
    assert (np.abs(ratio - 1.0) < 0.15).all(), ratio


def test_spcbpt_trained_state_runs(cornell):
    """Trained-Gamma sampling path executes and stays finite (full pipeline
    quality is covered by the benchmark app)."""
    ts, (eye, U, V, W) = cornell
    rng = np.random.default_rng(0)
    from spcbpt_tpu.config import NUM_SUBSPACE
    from spcbpt_tpu.train import qgamma
    # synthetic trained state: random classifiers + random CMF
    g = rng.uniform(0.0, 1.0, (NUM_SUBSPACE, NUM_SUBSPACE)).astype(np.float32)
    g /= g.sum(1, keepdims=True)
    ss = classify.SubspaceState(
        eye=classify.Classifier(
            centers_pos=jnp.asarray(rng.uniform(0, 556, (NUM_SUBSPACE, 3)), jnp.float32),
            centers_norm=jnp.asarray(rng.normal(size=(NUM_SUBSPACE, 3)), jnp.float32),
            diag2=jnp.float32(1e4)),
        light=classify.Classifier(
            centers_pos=jnp.asarray(rng.uniform(0, 556, (800, 3)), jnp.float32),
            centers_norm=jnp.asarray(rng.normal(size=(800, 3)), jnp.float32),
            diag2=jnp.float32(1e4)),
        q=jnp.asarray(rng.uniform(10, 1000, NUM_SUBSPACE), jnp.float32),
        cmf_gamma=qgamma.gamma_to_cmf(jnp.asarray(g)),
        trained=True)
    lv = light_trace.trace_light_paths(ts, ss, 1024, 3, max_depth=4)
    sampler = lvc.build_sampler(lv)
    img = spcbpt.render_frame_jit(ts, ss, sampler, eye, U, V, W, 16, 16, 0,
                                  max_depth=5, uniform=False)
    a = np.asarray(img)
    assert np.isfinite(a).all()
    assert a.mean() > 0.0


def test_pt_pool_matches_naive(cornell):
    """Path-regeneration pool renderer must reproduce the naive wavefront
    exactly (same seeds, same estimator)."""
    from spcbpt_tpu.render import pt_pool
    ts, (eye, U, V, W) = cornell
    W_, H_, spp = 16, 16, 4
    acc = jnp.zeros((W_ * H_, 3))
    for s in range(spp):
        acc = accumulate(acc, pt.render_frame_jit(ts, eye, U, V, W,
                                                  W_, H_, s, 6), s)
    fsum, count = pt_pool.render_pool_jit(ts, eye, U, V, W, W_, H_, spp, 0,
                                          n_pool=128, max_depth=6)
    cnt = np.asarray(count)
    assert (cnt == spp).all()
    b = np.asarray(fsum) / cnt[:, None]
    np.testing.assert_allclose(b, np.asarray(acc), atol=1e-4)


def test_spcbpt_pool_matches_naive(cornell):
    from spcbpt_tpu.render import spcbpt_pool
    ts, (eye, U, V, W) = cornell
    ss = classify.untrained_state()
    lv = light_trace.trace_light_paths(ts, ss, 1024, 5, max_depth=5)
    sampler = lvc.build_sampler(lv)
    W_ = H_ = 16
    img = spcbpt.render_frame_jit(ts, ss, sampler, eye, U, V, W, W_, H_, 2,
                                  max_depth=6, uniform=True)
    fsum, count = spcbpt_pool.render_pool_jit(
        ts, ss, sampler, eye, U, V, W, W_, H_, 1, 2, n_pool=64,
        max_depth=6, uniform=True)
    cnt = np.asarray(count)
    assert (cnt == 1).all()
    np.testing.assert_allclose(np.asarray(fsum), np.asarray(img), atol=1e-4)


def test_pt_pool_presort_matches_brute():
    """The pool's per-bounce lane presorting (active in tile/walk modes) is
    estimator-invariant: same scene forced into tile mode must reproduce the
    brute-mode render to float tolerance."""
    from spcbpt_tpu.render import pt_pool
    from spcbpt_tpu.scene.scene import load_trace_scene
    ts_b, _, cam = load_trace_scene(default_scene_path())
    ts_t, _, _ = load_trace_scene(default_scene_path(), mode="tile")
    assert ts_t.mode == "tile" and ts_t.clusters is not None
    cam.aspect = 1.0
    eye, U, V, W = cam.uvw()
    W_ = H_ = 16
    fb, cb = pt_pool.render_pool_jit(ts_b, eye, U, V, W, W_, H_, 2, 3,
                                     n_pool=256, max_depth=5)
    ft, ct = pt_pool.render_pool_jit(ts_t, eye, U, V, W, W_, H_, 2, 3,
                                     n_pool=256, max_depth=5)
    np.testing.assert_array_equal(np.asarray(cb), np.asarray(ct))
    np.testing.assert_allclose(np.asarray(ft), np.asarray(fb),
                               rtol=1e-4, atol=1e-4)
