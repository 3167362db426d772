"""BASELINE config 5: multi-chip tiled SPCBPT at 2048x2048, equal-time
SPCBPT(uniform)=BDPT vs SPCBPT over a device mesh.

By default it runs over the accelerators JAX finds (--platform default).
--platform cpu validates on a virtual CPU mesh of --cpu-devices devices:
correctness (estimator equivalence between mesh shapes) plus scaling shape
(work per chip vs mesh size — on virtual devices wall-clock scaling is
meaningless, so it reports per-chip lane counts and compares estimator means
across meshes with identical seed streams).

Usage:
  python -m spcbpt_tpu.apps.multichip_bench --dim 2048x2048 --json out.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="cornell_glossy")
    p.add_argument("--dim", default="2048x2048")
    p.add_argument("--light-paths-per-chip", type=int, default=8192)
    p.add_argument("--max-depth", type=int, default=8)
    p.add_argument("--meshes", default="1x1,2x1,4x1,4x2",
                   help="comma list of TILExSPP mesh shapes")
    p.add_argument("--checkpoint", default=None,
                   help="trained SubspaceState npz: spcbpt entries run the "
                        "trained two-stage sampler instead of untrained")
    p.add_argument("--equal-time", type=float, default=None,
                   help="seconds per algorithm: after the mesh sweep, "
                        "accumulate subframes of bdpt+spcbpt on the LARGEST "
                        "mesh through the sharded code path and report "
                        "relMSE vs --ref-npz")
    p.add_argument("--ref-npz", default=None,
                   help="reference image npz (key 'img', (W*H,3)) for the "
                        "equal-time relMSE")
    p.add_argument("--discard", type=float, default=0.001)
    p.add_argument("--sub-blocks", type=int, default=1,
                   help="sequential sub-wavefronts per chip row block "
                        "(memory / sub_blocks, estimator unchanged); "
                        "to bound device memory at large dims")
    p.add_argument("--platform", default="default", choices=["cpu", "default"],
                   help="'default' = the accelerators jax.devices() returns; "
                        "'cpu' = a virtual host mesh")
    p.add_argument("--cpu-devices", type=int, default=8,
                   help="virtual CPU device count for --platform cpu")
    p.add_argument("--subframes", type=int, default=3,
                   help="subframes per mesh-correctness render (lower = "
                        "cheaper large-dim rows on the CPU virtual mesh)")
    p.add_argument("--mesh-algs", default="pt,bdpt,spcbpt",
                   help="algorithms to run in the mesh-correctness sweep")
    p.add_argument("--single-run", action="store_true",
                   help="mesh-correctness sweep only: take the mean from the "
                        "compile run and skip the warm timed rerun (halves "
                        "the cost of large-dim CPU rows; 'seconds' then "
                        "includes compile time and is not a clean rate)")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    import jax
    if args.platform == "cpu":
        # Before backend init. jax 0.9 ignores XLA_FLAGS
        # --xla_force_host_platform_device_count; jax_num_cpu_devices is the
        # supported virtual-mesh mechanism (also pre-init only).
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu_devices)
    import numpy as np
    import jax.numpy as jnp
    from ..runtime import setup as _setup
    _setup()
    from ..parallel import tile as par
    from ..scene.scene import load_trace_scene
    from ..train import classify
    from .render_cli import resolve_scene

    devices = jax.devices()
    print(f"[devices] {len(devices)} x {devices[0].platform}", flush=True)

    width, height = map(int, args.dim.lower().split("x"))
    ts, desc, cam = load_trace_scene(resolve_scene(args.scene))
    cam.aspect = width / height
    uvw = cam.uvw()
    ss = classify.untrained_state()
    if args.checkpoint:
        from .. import checkpoint as ckpt_mod
        ss = ckpt_mod.load_subspace_state(args.checkpoint)
        print(f"[state] trained checkpoint {args.checkpoint} "
              f"(second stage '{ss.second_stage}')", flush=True)

    results = {"scene": args.scene, "dim": args.dim,
               "devices": len(devices), "meshes": {}}
    base_mean = {}
    for shape in args.meshes.split(","):
        t_, s_ = map(int, shape.lower().split("x"))
        if t_ * s_ > len(devices):
            print(f"[skip] mesh {shape}: needs {t_*s_} devices", flush=True)
            continue
        mesh = par.make_mesh(devices[:t_ * s_], tile=t_, spp=s_)
        entry = {}
        mesh_algs = args.mesh_algs.split(",")
        nsub = args.subframes

        # PT: pixel-seeded RNG only, so every TILEx1 mesh must reproduce
        # the single-chip image EXACTLY (pure pixel split, no chip state)
        if "pt" in mesh_algs:
            fn = jax.jit(lambda ts_, mesh=mesh: par.sharded_pt_render(
                ts_, uvw, width, height, nsub, mesh,
                max_depth=args.max_depth))
            img = fn(ts); jax.block_until_ready(img)
            t0 = time.time(); img = fn(ts); jax.block_until_ready(img)
            dt = time.time() - t0
            m = float(jnp.mean(img))
            if ("pt", s_) not in base_mean:
                base_mean[("pt", s_)] = m
            dev = abs(m / base_mean[("pt", s_)] - 1.0)
            entry["pt"] = {"mean": m, "seconds": dt,
                           "mpaths_per_s_total": width * height / dt / 1e6,
                           "mean_vs_smallest_mesh": dev}
            print(f"[mesh {shape}] pt: mean {m:.6f} (dev {dev:.2e}) "
                  f"{dt:.1f}s", flush=True)
            assert dev < 1e-5, f"PT pixel-split mismatch on mesh {shape}"

        for alg, uniform in (("bdpt", True), ("spcbpt", False)):
            if alg not in mesh_algs:
                continue
            fn = jax.jit(lambda ts_, ss_, mesh=mesh, uniform=uniform:
                         par.sharded_spcbpt_render(
                             ts_, ss_, uvw, width, height, nsub, mesh,
                             args.light_paths_per_chip,
                             max_depth=args.max_depth, uniform=uniform,
                             sub_blocks=args.sub_blocks))
            t0 = time.time()
            img = fn(ts, ss)
            jax.block_until_ready(img)
            compile_s = time.time() - t0
            if args.single_run:
                dt = compile_s
            else:
                t0 = time.time()
                img = fn(ts, ss)
                jax.block_until_ready(img)
                dt = time.time() - t0
            m = float(jnp.mean(img))
            lanes = width * height // t_
            entry[alg] = {
                "mean": m, "seconds": dt, "compile_seconds": compile_s,
                "lanes_per_chip": lanes,
                "mpaths_per_s_total": width * height / dt / 1e6,
            }
            if args.single_run:
                entry[alg]["single_run"] = True
            # BDPT/SPCBPT regenerate the LVC per chip with decorrelated
            # seeds (parallel/tile.py), so cross-mesh agreement is
            # statistical, not bitwise; at 1 spp the two-stage estimator's
            # long tail leaves ~5-10% mean scatter between seed sets
            key = (alg, s_)
            if key not in base_mean:
                base_mean[key] = m
            dev = abs(m / base_mean[key] - 1.0)
            entry[alg]["mean_vs_smallest_mesh"] = dev
            print(f"[mesh {shape}] {alg}: mean {m:.6f} "
                  f"(dev {dev:.2e}) {dt:.1f}s "
                  f"({width*height/dt/1e6:.2f} Mpaths/s total)", flush=True)
            assert dev < 0.15, f"estimator mismatch on mesh {shape} {alg}"
        results["meshes"][shape] = entry
        if args.json:
            # partial dump after every mesh: a deadline-killed large-dim CPU
            # row still stages the meshes it finished
            with open(args.json, "w") as f:
                json.dump(results, f, indent=2)

    if args.equal_time:
        # BASELINE config 5 proper: equal-time SPCBPT vs BDPT through the
        # sharded render path on the largest mesh that fits this host
        from ..utils.image import rel_mse
        ref = np.load(args.ref_npz)["img"] if args.ref_npz else None
        shapes = [tuple(map(int, s.lower().split("x")))
                  for s in args.meshes.split(",")]
        t_, s_ = max((t, s) for t, s in shapes if t * s <= len(devices))
        mesh = par.make_mesh(devices[:t_ * s_], tile=t_, spp=s_)
        results["equal_time"] = {"mesh": f"{t_}x{s_}",
                                 "budget_s": args.equal_time, "algs": {}}
        for alg, uniform in (("bdpt", True), ("spcbpt", False)):
            fn = jax.jit(lambda ts_, ss_, sub, uniform=uniform:
                         par.sharded_spcbpt_render(
                             ts_, ss_, uvw, width, height, sub, mesh,
                             args.light_paths_per_chip,
                             max_depth=args.max_depth, uniform=uniform,
                             sub_blocks=args.sub_blocks))
            # accumulate ON DEVICE and transfer once after the budget: a
            # per-subframe np.asarray would copy the film to the host inside
            # the timed window
            # warm-up/compile subframe: DISCARDED (not accumulated, not
            # counted) so the timed window contains exactly the counted
            # work and subframes/seconds is a clean rate; the loop stops
            # when the projected next subframe would overshoot the budget
            # (the r4 artifacts overshot by one whole 33 s subframe)
            jax.block_until_ready(fn(ts, ss, 0))
            acc = None
            n = 0
            t0 = time.time()
            while True:
                el = time.time() - t0
                if n > 0 and el + el / n > args.equal_time:
                    break
                img = fn(ts, ss, n + 1)
                acc = img if acc is None else acc + img
                jax.block_until_ready(acc)
                n += 1
            dt = time.time() - t0
            out = (np.asarray(acc).reshape(height, width, 3) / n).reshape(-1, 3)
            e = (rel_mse(out, ref, discard=args.discard)
                 if ref is not None else None)
            results["equal_time"]["algs"][alg] = {
                "relmse": e, "subframes": n, "seconds": dt,
                "spp_per_pixel": n * s_}
            print(f"[equal-time {t_}x{s_}] {alg}: "
                  f"relMSE {e if e is not None else float('nan'):.5f} "
                  f"at {n} subframes ({dt:.1f}s)", flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
