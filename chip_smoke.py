"""End-to-end smoke test of the renderer on NVIDIA GPUs.

    python chip_smoke.py [--out DIR]              # one card: phases 0-4
    python chip_smoke.py --multichip [--out DIR]  # four cards: the mesh phase

One card, in one process (a JAX process reserves most of the card's memory,
so a second one could not share it):

  0. device     JAX's default device must be a GPU; prints its kind, the
                device count and nvidia-smi's name and power limit.
  1. traversal  the one-thread-per-ray BVH kernel (scene mode "cuda") vs the
                brute-force oracle on interior_cove: camera, incoherent
                bounce and shadow-segment wavefronts of 2^18 rays, closest-hit
                with culling on and off and any-hit; then its time against
                XLA's while_loop walk (mode "bvh") at 1920x1000.
  2. renders    PT, BDPT and trained SPCBPT through the render CLI on
                interior_cove at the reference's frame (1920x1000, 100k light
                paths, 3 connections); images must be finite and lit.
  3. quality    the committed golden gates (Cornell PT; interior_lit PT, BDPT
                and trained-path SPCBPT) and a same-seed PT A/B of brute
                force against the kernel.
  4. gpu tests  the tests marked `gpu`.

--multichip runs only the (tile, spp) mesh over four cards: SPCBPT at 2048^2
on interior_cove against the same per-chip bodies run one by one on one
card, and one data-parallel Gamma step against the single-device step.

Any failed phase exits non-zero. The last line of a passing run is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1000
ORACLE_RAYS = 1 << 18


def log(msg: str) -> None:
    print(msg, flush=True)


def _timed_compile(fn, *args):
    """jit-compile fn for args; returns (compiled, compile seconds)."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _median_seconds(compiled, *args, reps: int):
    import jax
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

def phase_device(n_devices: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"JAX's default device is {devs[0].platform}, "
                           "not a GPU")
    if len(devs) < n_devices:
        raise RuntimeError(f"need {n_devices} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    log(f"[device] {devs[0].device_kind} x{len(devs)}")
    for line in smi.strip().splitlines():
        log(f"[nvidia-smi] {line.strip()}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def _scene(name: str):
    from spcbpt_tpu.apps.render_cli import resolve_scene
    from spcbpt_tpu.scene.scene import load_trace_scene
    ts, desc, cam = load_trace_scene(resolve_scene(name))
    cam.aspect = WIDTH / HEIGHT
    return ts, cam.uvw()


def wavefronts(ts, cam_uvw, width: int, height: int):
    """Camera rays, one bounce of BSDF-sampled rays from the camera hits in
    shuffled lane order (incoherent), and shadow segments between random
    pairs of those hit points (the shape of SPCBPT's connection rays)."""
    import jax
    import jax.numpy as jnp
    from spcbpt_tpu.ops import bsdf as bsdf_mod
    from spcbpt_tpu.render.common import camera_rays
    from spcbpt_tpu.scene.scene import local_geometry, trace_closest
    from spcbpt_tpu.utils import rng as rng_mod

    def make(ts):
        o, d, _ = camera_rays(*cam_uvw, width, height, 0)
        hit = trace_closest(ts, o, d, 1e-3, 1e16, True)
        geom = local_geometry(ts, hit, o, d)
        n = o.shape[0]
        st = rng_mod.seed(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(7))
        mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
        nd, _ = bsdf_mod.sample_bsdf(mat, geom["Ns"], -d, st)
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        perm = jax.random.permutation(k1, n)
        p = geom["P"]
        b = p[jax.random.permutation(k2, n)]
        seg = b - p
        dist = jnp.sqrt(jnp.maximum(jnp.sum(seg * seg, -1), 1e-30))
        return dict(camera=(o, d), bounce=(p[perm], nd[perm]),
                    shadow=(p, seg / dist[:, None], dist - 1e-3),
                    hit_frac=jnp.mean(hit.tri >= 0))
    return jax.jit(make)(ts)


def _closest_agreement(got, ref):
    import numpy as np
    gt, rt = np.asarray(got.t), np.asarray(ref.t)
    t_ok = np.abs(gt - rt) <= 1e-4 * np.maximum(1.0, np.abs(rt))
    tri_ok = np.asarray(got.tri) == np.asarray(ref.tri)
    return int((~t_ok).sum()), int((~tri_ok).sum()), len(gt)


def phase_traversal():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from spcbpt_tpu.ops import intersect
    from spcbpt_tpu.scene.scene import trace_any, trace_closest

    ts, cam_uvw = _scene("interior_cove")
    log(f"[traversal] interior_cove: {ts.num_tris} tris, "
        f"{ts.bvh_skip.shape[0]} nodes, mode {ts.mode}")
    if ts.mode != "cuda":
        raise RuntimeError(f"expected traversal mode 'cuda', got {ts.mode}")
    waves = wavefronts(ts, cam_uvw, WIDTH, HEIGHT)
    log(f"[traversal] camera hit fraction {float(waves['hit_frac']):.4f}")

    # --- oracle: brute force over every triangle, 2^18 rays of each kind
    sub = np.random.RandomState(1).choice(WIDTH * HEIGHT, ORACLE_RAYS,
                                          replace=False)
    tris = (ts.tri_p0, ts.tri_e1, ts.tri_e2)
    n = ORACLE_RAYS
    tmin = jnp.full((n,), 1e-3)
    tmax = jnp.full((n,), 1e16)
    for kind in ("camera", "bounce"):
        o, d = [a[sub] for a in waves[kind]]
        for cull in (True, False):
            got = jax.jit(lambda ts, o, d: trace_closest(
                ts, o, d, 1e-3, 1e16, cull))(ts, o, d)
            ref = jax.jit(lambda o, d, tmin, tmax, *tris:
                          intersect.brute_force_closest(
                              o, d, *tris, tmin, tmax, cull))(
                o, d, tmin, tmax, *tris)
            bad_t, bad_tri, total = _closest_agreement(got, ref)
            log(f"[traversal] closest {kind} cull={cull}: |dt| beyond "
                f"1e-4*max(1,t) on {bad_t}/{total}, triangle differs on "
                f"{bad_tri}/{total}")
            if bad_t > 1e-3 * total or bad_tri > 1e-2 * total:
                raise AssertionError(f"closest-hit {kind} cull={cull} "
                                     "disagrees with brute force")
    o, d, tm = [a[sub] for a in waves["shadow"]]
    got = jax.jit(lambda ts, o, d, tm: trace_any(ts, o, d, 1e-3, tm))(
        ts, o, d, tm)
    ref = jax.jit(lambda o, d, tmin, tm, *tris: intersect.brute_force_any(
        o, d, *tris, tmin, tm))(o, d, tmin, tm, *tris)
    bad = int((np.asarray(got) != np.asarray(ref)).sum())
    log(f"[traversal] any-hit shadow: differs on {bad}/{n} "
        f"(occluded fraction {float(np.asarray(ref).mean()):.3f})")
    if bad > 1e-4 * n:
        raise AssertionError("any-hit disagrees with brute force")

    # --- time: kernel vs XLA's while_loop walk of the same BVH, full frame
    ts_xla = ts.replace(mode="bvh")
    n_full = WIDTH * HEIGHT
    jobs = [
        ("camera closest", lambda ts, o, d: trace_closest(
            ts, o, d, 1e-3, 1e16, True).t, waves["camera"]),
        ("bounce closest", lambda ts, o, d: trace_closest(
            ts, o, d, 1e-3, 1e16, True).t, waves["bounce"]),
        ("shadow any", lambda ts, o, d, tm: trace_any(ts, o, d, 1e-3, tm),
         waves["shadow"]),
    ]
    timings = {}
    for name, fn, args in jobs:
        row = {}
        for label, scene, reps in (("kernel", ts, 10), ("xla", ts_xla, 3)):
            compiled, c_s = _timed_compile(fn, scene, *args)
            s = _median_seconds(compiled, scene, *args, reps=reps)
            row[label] = {"ms": s * 1e3, "mrays_s": n_full / s / 1e6,
                          "compile_s": c_s}
        log(f"[traversal] {name} {WIDTH}x{HEIGHT}: kernel "
            f"{row['kernel']['ms']:.2f} ms ({row['kernel']['mrays_s']:.1f} "
            f"Mrays/s), XLA {row['xla']['ms']:.2f} ms "
            f"({row['xla']['mrays_s']:.2f} Mrays/s); compile "
            f"{row['kernel']['compile_s']:.1f} s / {row['xla']['compile_s']:.1f} s")
        timings[name] = row

    # --- small scene: the kernel against the fused brute force
    tc, cam_c = _scene("cornell")
    o, d = wavefronts(tc, cam_c, WIDTH, HEIGHT)["camera"]
    fn = lambda ts, o, d: trace_closest(ts, o, d, 1e-3, 1e16, True).t
    for label, scene in (("kernel", tc), ("brute", tc.replace(mode="brute"))):
        compiled, _ = _timed_compile(fn, scene, o, d)
        s = _median_seconds(compiled, scene, o, d, reps=10)
        log(f"[traversal] cornell ({tc.num_tris} tris) camera closest "
            f"{label}: {s * 1e3:.2f} ms")
        timings[f"cornell camera closest {label}"] = {"ms": s * 1e3}
    return timings


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def phase_renders(out_dir: str, spp: int = 4, light_paths: int = 100_000,
                  extra_args=()):
    import numpy as np
    from spcbpt_tpu.apps import render_cli

    results = {}
    for alg in ("pt", "bdpt", "spcbpt"):
        stats_path = os.path.join(out_dir, f"{alg}.json")
        hdr_path = os.path.join(out_dir, f"{alg}.npz")
        rc = render_cli.main([
            "--scene", "interior_cove", "--alg", alg,
            "--dim", f"{WIDTH}x{HEIGHT}", "--spp", str(spp),
            "--light-paths", str(light_paths), "--connection-n", "3",
            "--out", os.path.join(out_dir, f"{alg}.png"),
            "--hdr-out", hdr_path, "--stats-json", stats_path,
            *extra_args])
        if rc != 0:
            raise RuntimeError(f"render_cli {alg} returned {rc}")
        with open(stats_path) as f:
            stats = json.load(f)
        img = np.load(hdr_path)["radiance"]
        if not np.isfinite(img).all() or not img.mean() > 0.0:
            raise AssertionError(f"{alg}: image not finite or black "
                                 f"(mean {img.mean()})")
        log(f"[renders] {alg}: {stats['ms_per_spp']:.1f} ms/spp steady "
            f"(light {stats['light_ms_per_spp']:.1f} + eye "
            f"{stats['eye_ms_per_spp']:.1f}), compile "
            f"{stats['compile_seconds']:.1f} s, preprocess "
            f"{stats['phases'].get('preprocess', {}).get('total', 0.0):.1f} s, "
            f"peak {stats['peak_bytes_in_use'] / 2**30:.2f} GiB, "
            f"mean radiance {img.mean():.4g}")
        results[alg] = stats
    return results


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------

def _pytest(args):
    import pytest
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "--rootdir", ROOT,
                      *args])
    if rc != 0:
        raise RuntimeError(f"pytest {' '.join(args)} returned {rc}")


def phase_quality():
    import numpy as np
    from spcbpt_tpu.render import pt_pool
    from spcbpt_tpu.utils.image import rel_mse

    tests = os.path.join(ROOT, "tests")
    _pytest([os.path.join(tests, "test_convergence.py") + "::test_pt_convergence",
             os.path.join(tests, "test_convergence_interior.py")])

    # same-seed A/B: only the traversal differs (the rng is per lane)
    ts, (eye, U, V, W) = _scene("interior_cove")
    imgs = {}
    for mode in ("brute", "cuda"):
        fs, ct = pt_pool.render_pool_jit(ts.replace(mode=mode), eye, U, V, W,
                                         256, 256, 4, 0)
        imgs[mode] = np.asarray(fs) / np.maximum(np.asarray(ct)[:, None], 1)
    r = rel_mse(imgs["cuda"], imgs["brute"])
    log(f"[quality] PT 256^2 4 spp, brute vs kernel: relMSE {r:.3g}")
    if not r <= 1e-4:
        raise AssertionError(f"brute vs kernel PT relMSE {r} > 1e-4")


def phase_gpu_tests():
    _pytest([os.path.join(ROOT, "tests"), "-m", "gpu"])


# ---------------------------------------------------------------------------
# --multichip
# ---------------------------------------------------------------------------

def phase_mesh(scene: str = "interior_cove", size: int = 2048,
               light_paths: int = 25_000, max_depth: int = 12,
               gamma_batch: int = 20_000):
    """Sharded SPCBPT over a (tile, spp) mesh of every device against the
    same per-chip bodies run one after another on device 0, and one
    data-parallel Gamma step against the single-device step."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from spcbpt_tpu.config import NUM_SUBSPACE
    from spcbpt_tpu.parallel import tile as ptile
    from spcbpt_tpu.render import light_trace, lvc, spcbpt
    from spcbpt_tpu.train import classify, gamma_train
    from spcbpt_tpu.apps.render_cli import resolve_scene
    from spcbpt_tpu.scene.scene import load_trace_scene
    ts, _, cam = load_trace_scene(resolve_scene(scene))
    cam.aspect = 1.0
    cam_uvw = cam.uvw()
    ss = classify.synthetic_trained_state(ts, seed=3)
    mesh = ptile.make_mesh()
    n_tile, n_spp = mesh.shape["tile"], mesh.shape["spp"]
    log(f"[mesh] {scene} {size}^2 on mesh {dict(mesh.shape)}, "
        f"{light_paths} light paths per chip, mode {ts.mode}")

    t0 = time.perf_counter()
    render = jax.jit(lambda ts, ss: ptile.sharded_spcbpt_render(
        ts, ss, cam_uvw, size, size, 0, mesh,
        light_paths_per_chip=light_paths, max_depth=max_depth))
    img = np.asarray(render(ts, ss))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(render(ts, ss))
    t_steady = time.perf_counter() - t0
    log(f"[mesh] sharded render: first call {t_first:.1f} s, steady "
        f"{t_steady * 1e3:.1f} ms")

    eye, U, V, W = [jnp.asarray(x, jnp.float32) for x in cam_uvw]
    rows = size // n_tile
    dev0 = jax.devices()[0]

    @jax.jit
    def body(ts, ss, ti, si):
        frame = (ti * n_spp + si).astype(jnp.uint32)
        lv = light_trace.trace_light_paths(ts, ss, light_paths, frame,
                                           max_depth=8)
        sampler = lvc.build_sampler(lv, table_mode=lvc.table_mode_for(ss),
                                    table_seed=frame, ss=ss)
        o, d, state = ptile._block_camera_rays(eye, U, V, W, size, size,
                                               rows, ti, si, 0)
        step = spcbpt.make_spcbpt_step(ts, ss, sampler, max_depth, 3, False)
        return step(o, d, state)

    ts0, ss0 = jax.device_put((ts, ss), dev0)

    def tile_by_tile():
        parts = []
        for ti in range(n_tile):
            streams = [np.asarray(body(ts0, ss0, jnp.int32(ti), jnp.int32(si)))
                       for si in range(n_spp)]
            parts.append(np.mean(streams, axis=0))
        return np.concatenate(parts, axis=0)

    def n_differ(a, b):
        return int((~np.isclose(a, b, rtol=1e-3, atol=1e-6).all(-1)).sum())

    ref = tile_by_tile()
    if not (np.isfinite(img).all() and img.mean() > 0.0):
        raise AssertionError("sharded image not finite or black")
    # XLA's GPU scatter-adds use atomics, so even one program run twice
    # differs in the last bits, and a path tracer turns that into a different
    # path (a light-vertex draw on the other side of a CMF step) in a few
    # pixels: the second tile-by-tile run measures that floor. The same
    # estimator agrees on all but a few pixels and in the image mean; a
    # sharding fault (tile order, seeds, the spp mean) changes nearly all.
    floor = n_differ(tile_by_tile(), ref)
    differ = n_differ(img, ref)
    dmean = abs(float(img.mean()) / float(ref.mean()) - 1.0)
    log(f"[mesh] sharded vs one card tile by tile: {differ} of "
        f"{size * size} pixels differ beyond 1e-3 (one card run twice: "
        f"{floor}), image means {img.mean():.6g} vs {ref.mean():.6g} "
        f"(rel {dmean:.2g})")
    if not (differ <= 1e-3 * size * size and dmean <= 1e-3):
        raise AssertionError("sharded render differs from the tile-by-tile "
                             "render on one card")

    rng = np.random.RandomState(0)
    p, c = gamma_batch, 10
    batch = gamma_train.GammaTrainData(
        f_square=jnp.asarray(rng.rand(p), jnp.float32),
        pdf0=jnp.asarray(rng.rand(p) + 0.1, jnp.float32),
        peak=jnp.asarray(rng.rand(p, c), jnp.float32),
        label_e=jnp.asarray(rng.randint(0, NUM_SUBSPACE ** 2, (p, c)),
                            jnp.int32),
        valid=jnp.asarray(rng.rand(p) < 0.8))
    theta = jnp.zeros((NUM_SUBSPACE, NUM_SUBSPACE))
    opt = optax.adam(0.01)
    t_sh, _, loss_sh = jax.jit(
        lambda t, o, b: ptile.dp_gamma_train_step(t, o, b, opt, mesh))(
            theta, opt.init(theta), batch)
    theta0, batch0 = jax.device_put((theta, batch), dev0)
    loss_ref, g = jax.jit(jax.value_and_grad(gamma_train.loss_fn))(
        theta0, batch0)
    upd, _ = opt.update(g, opt.init(theta0))
    t_ref = optax.apply_updates(theta0, upd)
    dl = abs(float(loss_sh) / float(loss_ref) - 1.0)
    dt = float(np.max(np.abs(np.asarray(t_sh) - np.asarray(t_ref))))
    log(f"[mesh] DP Gamma step, batch {p}: loss {float(loss_sh):.6g} vs "
        f"{float(loss_ref):.6g} (rel {dl:.2g}), max |dtheta| {dt:.2g}")
    # float32 sums over 20k paths in another order (four shards + psum):
    # the loss agrees to ~1e-6 relative; 1e-4 leaves room for atomics
    if not (dl <= 1e-4 and dt <= 1e-6 + 1e-4 * float(
            np.max(np.abs(np.asarray(t_ref))))):
        raise AssertionError("data-parallel Gamma step differs from the "
                             "single-device step")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                    help="directory for images and stats")
    args = ap.parse_args(argv)
    # no silent CPU fallback: JAX fails at start-up when it finds no GPU
    os.environ["JAX_PLATFORMS"] = "cuda"
    sys.path.insert(0, ROOT)
    os.makedirs(args.out, exist_ok=True)
    import jax
    from spcbpt_tpu.runtime import setup
    setup()

    if args.multichip:
        phases = [("mesh", phase_mesh)]
        n_devices = 4
    else:
        phases = [("traversal", phase_traversal),
                  ("renders", lambda: phase_renders(args.out)),
                  ("quality", phase_quality),
                  ("gpu tests", phase_gpu_tests)]
        n_devices = 1
    t_all = time.perf_counter()
    try:
        device = phase_device(n_devices)
        report = {"device": device}
        for name, fn in phases:
            t0 = time.perf_counter()
            log(f"[{name}] start")
            report[name] = fn()
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        log(f"[smoke] FAILED after {time.perf_counter() - t_all:.1f} s")
        return 1
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=1, default=float)
    log(f"[smoke] all phases ok in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
