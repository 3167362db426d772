"""Multi-chip sharding correctness on the 8-device virtual CPU mesh.

The reference is single-GPU (SURVEY.md §2 parallelism note); the
rebuild's mesh layout (tile, spp) is new capability and must be proven
equivalent to the single-chip renderer: shard_map semantics are per-shard,
so the sharded render must equal the same per-tile bodies run sequentially
on one device, and the data-parallel Gamma step must match the unsharded
gradient step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from spcbpt_tpu.parallel import tile as ptile
from spcbpt_tpu.render import pt
from spcbpt_tpu.train import classify, gamma_train
from spcbpt_tpu.config import NUM_SUBSPACE


@pytest.fixture(scope="module")
def cornell():
    from spcbpt_tpu.scene.cornell import default_scene_path
    from spcbpt_tpu.scene.scene import load_trace_scene
    ts, desc, cam = load_trace_scene(default_scene_path())
    cam.aspect = 1.0
    return ts, cam.uvw()


def test_mesh_has_8_devices():
    assert len(jax.devices("cpu")) >= 8


def test_sharded_pt_equals_sequential_tiles(cornell):
    ts, cam_uvw = cornell
    width, height = 16, 16
    n_dev = 4
    mesh = ptile.make_mesh(jax.devices("cpu")[:n_dev], tile=n_dev, spp=1)
    rows = height // n_dev

    img = ptile.sharded_pt_render(ts, cam_uvw, width, height, 0, mesh,
                                  max_depth=3)
    img = np.asarray(img)
    assert img.shape == (width * height, 3)
    assert np.isfinite(img).all()

    # reference: run each tile's shard body sequentially on one device
    eye, U, V, W = [jnp.asarray(x, jnp.float32) for x in cam_uvw]
    step = pt.make_pt_step(ts, 3)
    parts = []
    for ti in range(n_dev):
        o, d, state = ptile._block_camera_rays(
            eye, U, V, W, width, height, rows,
            jnp.asarray(ti), jnp.asarray(0), 0)
        parts.append(np.asarray(step(o, d, state)))
    ref = np.concatenate(parts, axis=0)
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)


def test_sharded_pt_spp_axis_is_mean_of_streams(cornell):
    ts, cam_uvw = cornell
    width, height = 16, 8
    mesh = ptile.make_mesh(jax.devices("cpu")[:4], tile=2, spp=2)
    img = np.asarray(ptile.sharded_pt_render(ts, cam_uvw, width, height, 0,
                                             mesh, max_depth=3))
    eye, U, V, W = [jnp.asarray(x, jnp.float32) for x in cam_uvw]
    step = pt.make_pt_step(ts, 3)
    rows = height // 2
    parts = []
    for ti in range(2):
        streams = []
        for si in range(2):
            o, d, state = ptile._block_camera_rays(
                eye, U, V, W, width, height, rows,
                jnp.asarray(ti), jnp.asarray(si), 0)
            streams.append(np.asarray(step(o, d, state)))
        parts.append(np.mean(streams, axis=0))
    ref = np.concatenate(parts, axis=0)
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)


def test_sharded_spcbpt_render_runs(cornell):
    ts, cam_uvw = cornell
    ss = classify.untrained_state()
    mesh = ptile.make_mesh(jax.devices("cpu")[:4], tile=2, spp=2)
    img = np.asarray(ptile.sharded_spcbpt_render(
        ts, ss, cam_uvw, 16, 8, 0, mesh, light_paths_per_chip=32,
        light_depth=3, max_depth=3, connection_n=1, uniform=True))
    assert img.shape == (16 * 8, 3)
    assert np.isfinite(img).all()
    assert img.sum() > 0.0


def test_sharded_spcbpt_trained_equals_sequential_tiles(cornell):
    """Exact sequential-equivalence for the estimator actually shipped for
    config 5 (VERDICT r3 weak #2): trained two-stage sampler (alias_pack
    first stage + presampled mixture tables), connection_n=3, per-chip LVC —
    the sharded render must bit-for-bit reproduce the same per-chip bodies
    run sequentially on one device."""
    from spcbpt_tpu.render import light_trace, lvc, spcbpt

    ts, cam_uvw = cornell
    ss = classify.synthetic_trained_state(ts, seed=3)
    assert ss.trained and lvc.table_mode_for(ss) == "mixture"
    width, height = 16, 8
    n_tile, n_spp = 2, 2
    mesh = ptile.make_mesh(jax.devices("cpu")[:4], tile=n_tile, spp=n_spp)
    lpp, ldepth, mdepth, conn = 32, 3, 3, 3
    subframe = 0

    img = np.asarray(ptile.sharded_spcbpt_render(
        ts, ss, cam_uvw, width, height, subframe, mesh,
        light_paths_per_chip=lpp, light_depth=ldepth, max_depth=mdepth,
        connection_n=conn, uniform=False))
    assert img.shape == (width * height, 3)
    assert np.isfinite(img).all()
    assert img.sum() > 0.0

    eye, U, V, W = [jnp.asarray(x, jnp.float32) for x in cam_uvw]
    rows = height // n_tile
    parts = []
    for ti in range(n_tile):
        streams = []
        for si in range(n_spp):
            chip = ti * n_spp + si
            frame = jnp.uint32(subframe * 65536 + chip)
            lv = light_trace.trace_light_paths(ts, ss, lpp, frame,
                                               max_depth=ldepth)
            sampler = lvc.build_sampler(lv, table_mode=lvc.table_mode_for(ss),
                                        table_seed=frame)
            o, d, state = ptile._block_camera_rays(
                eye, U, V, W, width, height, rows,
                jnp.asarray(ti), jnp.asarray(si), subframe)
            step = spcbpt.make_spcbpt_step(ts, ss, sampler, mdepth, conn,
                                           False)
            streams.append(np.asarray(step(o, d, state)))
        parts.append(np.mean(streams, axis=0))
    ref = np.concatenate(parts, axis=0)
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)


def test_dp_gamma_step_matches_single_device():
    rng = np.random.RandomState(0)
    p, c = 64, 4
    # UNEVEN per-shard validity (real batches are ragged): the dp step psums
    # unnormalized loss sums + valid counts, so the global mean and its
    # gradient are exact regardless of how validity distributes over shards
    valid = rng.rand(p) < 0.6
    valid[:8] = False  # make the first shard fully invalid for good measure
    assert valid.sum() > 0
    batch = gamma_train.GammaTrainData(
        f_square=jnp.asarray(rng.rand(p)),
        pdf0=jnp.asarray(rng.rand(p) + 0.1),
        peak=jnp.asarray(rng.rand(p, c)),
        label_e=jnp.asarray(rng.randint(0, NUM_SUBSPACE, (p, c)), jnp.int32),
        valid=jnp.asarray(valid),
    )
    theta = jnp.zeros((NUM_SUBSPACE, NUM_SUBSPACE))
    opt = optax.adam(0.01)

    mesh = ptile.make_mesh(jax.devices("cpu")[:8])
    t_sh, _, loss_sh = ptile.dp_gamma_train_step(
        theta, opt.init(theta), batch, opt, mesh)

    loss_ref, g = jax.value_and_grad(gamma_train.loss_fn)(theta, batch)
    upd, _ = opt.update(g, opt.init(theta))
    t_ref = optax.apply_updates(theta, upd)

    assert np.isclose(float(loss_sh), float(loss_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(t_sh), np.asarray(t_ref),
                               rtol=1e-4, atol=1e-6)


def test_sharded_spcbpt_sub_blocks_exact(cornell):
    """sub_blocks splits each chip's row block into sequential
    sub-wavefronts for memory (the 2048^2 1x1-mesh OOM fix); camera rays
    are global-pixel-seeded and the chip's one sampler serves every
    sub-block, so the image must be identical to sub_blocks=1."""
    ts, cam_uvw = cornell
    ss = classify.synthetic_trained_state(ts, seed=3)
    mesh = ptile.make_mesh(jax.devices("cpu")[:4], tile=2, spp=2)
    kw = dict(light_paths_per_chip=32, light_depth=3, max_depth=3,
              connection_n=3, uniform=False)
    a = np.asarray(ptile.sharded_spcbpt_render(
        ts, ss, cam_uvw, 16, 8, 0, mesh, sub_blocks=1, **kw))
    b = np.asarray(ptile.sharded_spcbpt_render(
        ts, ss, cam_uvw, 16, 8, 0, mesh, sub_blocks=2, **kw))
    assert a.sum() > 0.0
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
