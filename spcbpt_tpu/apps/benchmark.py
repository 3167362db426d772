"""Quality/performance benchmark harness: relMSE at equal time or equal spp.

Implements the BASELINE.md comparisons: PT / classic BDPT / SPCBPT on the
bundled scenes, against a high-spp PT ground truth, reporting relMSE and
throughput. This is the quantitative version of the reference's manual
Space-toggle A/B check (SURVEY.md §4).

Usage:
  python -m spcbpt_tpu.apps.benchmark --scene cornell --dim 256x256 \
      --ref-spp 512 --spp 16 --algs pt,bdpt,spcbpt --json out.json
  python -m spcbpt_tpu.apps.benchmark --equal-time 10  # seconds per alg
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="cornell")
    p.add_argument("--dim", default="256x256")
    p.add_argument("--ref-spp", type=int, default=256)
    p.add_argument("--ref-alg", default="pt", choices=["pt", "bdpt"],
                   help="reference renderer; use bdpt on indirect-dominant "
                        "scenes where a PT reference stays unconverged")
    p.add_argument("--ref-check-spp", type=int, default=0,
                   help="if >0, cross-check the reference's mean energy "
                        "against an independent PT run of this many spp")
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--equal-time", type=float, default=None,
                   help="seconds per algorithm instead of fixed spp")
    p.add_argument("--algs", default="pt,bdpt,spcbpt")
    p.add_argument("--max-depth", type=int, default=12)
    p.add_argument("--light-paths", type=int, default=65536)
    p.add_argument("--light-depth", type=int, default=8)
    p.add_argument("--train-samples", type=int, default=200_000)
    p.add_argument("--q-samples", type=int, default=None)
    p.add_argument("--gamma-epochs", type=int, default=1,
                   help="Adam epochs over the Gamma corpus; 0 = keep the "
                        "contribution-integral initial Gamma (BASELINE "
                        "config 3, reference preprocess_getGamma "
                        "device_thrust.cu:627-667 without train_optimal_E)")
    p.add_argument("--classifier", default="centroid",
                   choices=["centroid", "nn"],
                   help="'nn' trains the close-set refinement network on top "
                        "of Gamma (C21) for the spcbpt entries")
    p.add_argument("--second-stage", default="auto",
                   choices=["auto", "mixture", "uniform", "weighted"])
    p.add_argument("--discard", type=float, default=0.001,
                   help="fraction of largest per-value errors dropped from "
                        "relMSE (firefly protocol; 0 disables)")
    p.add_argument("--clamp", type=float, default=None,
                   help="progressive firefly clamp: cap each subframe's "
                        "per-channel radiance at CLAMP*sqrt(subframe+1). "
                        "Consistent (bias -> 0 as spp grows); cuts the "
                        "unbounded connection tail the reference leaves "
                        "unclamped. Off by default (reference parity)")
    p.add_argument("--repeats", type=int, default=1,
                   help="independent renders per algorithm (decorrelated "
                        "seed blocks); reports per-repeat relMSE + median. "
                        "SPCBPT-family relMSE at ~30 spp has a measured >5x "
                        "realization band from correlated firefly blotches "
                        "(one huge-weight light vertex contaminates many "
                        "pixels in a subframe), so single draws mislead")
    p.add_argument("--ref-npz", default=None,
                   help="cache the PT reference here (load if it exists)")
    p.add_argument("--ref-chunk", type=int, default=256,
                   help="spp per reference chunk; a partial accumulation is "
                        "checkpointed after each chunk so killed runs resume")
    p.add_argument("--checkpoint", default=None,
                   help="save/load the trained state npz (skip retraining)")
    p.add_argument("--json", default=None)
    p.add_argument("--save-images", default=None, help="dir for PNGs")
    p.add_argument("--platform", default="default",
                   choices=["default", "cpu"],
                   help="'cpu' forces the CPU backend")
    args = p.parse_args(argv)

    import jax
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from ..runtime import setup as _setup
    _setup()
    from ..config import PretraceConfig
    from ..render import light_trace, lvc, pt_pool, spcbpt
    from ..render.common import accumulate
    from ..scene.scene import load_trace_scene
    from ..train import classify, pipeline
    from ..utils.image import rel_mse, to_display, write_png
    from .render_cli import resolve_scene

    width, height = map(int, args.dim.lower().split("x"))
    ts, desc, cam = load_trace_scene(resolve_scene(args.scene))
    cam.aspect = width / height
    eye, U, V, W = cam.uvw()

    results = {"scene": args.scene, "dim": args.dim,
               "discard": args.discard, "ref_alg": args.ref_alg,
               "ref_spp": args.ref_spp, "clamp": args.clamp, "algs": {}}

    def render_ref_chunk(alg, spp, seed_base):
        """(film_sum, counts) for `spp` samples of the reference renderer."""
        if alg == "pt":
            # 1-spp executions accumulated on device: one compile serves
            # every chunk size, and no single execution runs for minutes
            acc_f = jnp.zeros((width * height, 3))
            acc_c = jnp.zeros((width * height,))
            for s in range(spp):
                fs, ct = pt_pool.render_pool_jit(
                    ts, eye, U, V, W, width, height, 1, seed_base + s,
                    max_depth=args.max_depth)
                acc_f = acc_f + fs
                acc_c = acc_c + ct
            jax.block_until_ready(acc_f)
            return np.asarray(acc_f), np.asarray(acc_c)
        # bdpt: uniform vertex connections — structurally different sampler
        # from PT; on indirect-dominant scenes a PT reference at any
        # practical spp stays speckle-noisy and relMSE against it punishes
        # converged images (zero-agrees-with-zero artifact)
        from ..render import spcbpt_pool
        ss0 = classify.untrained_state()
        # ts/ss go in as jit ARGUMENTS, not closure constants: closed-over
        # device arrays would be embedded in the program as constants
        lt_jit = jax.jit(lambda ts_, ss_, f: light_trace.trace_light_paths(
            ts_, ss_, args.light_paths, f, max_depth=args.light_depth))
        lt = lambda f: lt_jit(ts, ss0, f)
        build = jax.jit(lvc.build_sampler)
        # accumulate ON DEVICE and transfer once per chunk: a per-spp
        # np.asarray would copy the whole film to the host every sample
        acc_f = jnp.zeros((width * height, 3))
        acc_c = jnp.zeros((width * height,))
        for s in range(spp):
            sampler = build(lt(seed_base + s + 3331))
            fs, ct = spcbpt_pool.render_pool_jit(
                ts, ss0, sampler, eye, U, V, W, width, height, 1,
                seed_base + s, max_depth=args.max_depth, uniform=True)
            acc_f = acc_f + fs
            acc_c = acc_c + ct
        jax.block_until_ready(acc_f)
        return np.asarray(acc_f), np.asarray(acc_c)

    # ground truth: high-spp render (cached in --ref-npz)
    import os
    if args.ref_npz and os.path.exists(args.ref_npz):
        ref = np.load(args.ref_npz)["img"]
        assert ref.shape == (width * height, 3), ref.shape
        print(f"[ref] loaded {args.ref_npz}", flush=True)
    else:
        print(f"[ref] {args.ref_alg} {args.ref_spp} spp ...", flush=True)
        t0 = time.time()
        ref_acc = np.zeros((width * height, 3))
        ref_cnt = np.zeros((width * height,))
        chunk = args.ref_chunk
        s_start = 0
        partial = (args.ref_npz + ".partial.npz") if args.ref_npz else None
        if partial and os.path.exists(partial):
            # resume a killed/stalled run: per-chunk seeds are a pure function
            # of s0, so continuing reproduces the uninterrupted render exactly
            pz = np.load(partial)
            if int(pz["chunk"]) == chunk:
                ref_acc = pz["acc"].astype(np.float64)
                ref_cnt = pz["cnt"].astype(np.float64)
                s_start = int(pz["spp_done"])
                print(f"[ref] resumed {s_start} spp from {partial}",
                      flush=True)
        for s0 in range(s_start, args.ref_spp, chunk):
            fsum, count = render_ref_chunk(
                args.ref_alg, min(chunk, args.ref_spp - s0), 10_000 + s0)
            jax.block_until_ready(fsum)
            ref_acc += np.asarray(fsum)
            ref_cnt += np.asarray(count)
            done = s0 + min(chunk, args.ref_spp - s0)
            if partial:
                np.savez_compressed(partial, acc=ref_acc.astype(np.float32),
                                    cnt=ref_cnt.astype(np.float32),
                                    spp_done=done, chunk=chunk)
            print(f"[ref] {done}/{args.ref_spp} spp ({time.time()-t0:.0f}s)",
                  flush=True)
        ref = ref_acc / np.maximum(ref_cnt[:, None], 1)
        print(f"[ref] done in {time.time()-t0:.1f}s", flush=True)
        if args.ref_npz:
            np.savez_compressed(args.ref_npz, img=ref.astype(np.float32))
            if partial and os.path.exists(partial):
                os.remove(partial)

    if args.ref_check_spp:
        # unbiasedness cross-check: mean energy of an independent PT run must
        # agree with the reference (both estimators are unbiased; the PT mean
        # converges long before its relMSE does)
        fs, ct = render_ref_chunk("pt", args.ref_check_spp, 777_000)
        pt_mean = float((np.asarray(fs)
                         / np.maximum(np.asarray(ct)[:, None], 1)).mean())
        ref_mean = float(ref.mean())
        results["energy_check"] = {
            "ref_mean": ref_mean, "pt_mean": pt_mean,
            "pt_check_spp": args.ref_check_spp,
            "rel_diff": abs(pt_mean - ref_mean) / max(ref_mean, 1e-9)}
        print(f"[ref] energy check: ref {ref_mean:.5f} vs PT "
              f"{pt_mean:.5f} ({args.ref_check_spp} spp)", flush=True)

    algs = args.algs.split(",")
    ss_trained = None

    def render_alg(alg, budget_s=None, spp=None, seed_base=0):
        nonlocal ss_trained
        ss = classify.untrained_state()
        if alg == "spcbpt":
            if ss_trained is None:
                import os as _os
                from .. import checkpoint as ckpt_mod
                if args.checkpoint and _os.path.exists(args.checkpoint):
                    ss_trained = ckpt_mod.load_subspace_state(args.checkpoint)
                    print(f"[train] resumed {args.checkpoint}", flush=True)
                else:
                    t0 = time.time()
                    cfg = PretraceConfig(
                        num_core=8192,
                        target_samples=args.train_samples,
                        target_q_samples=args.q_samples or args.train_samples)
                    ss_trained, pstats = pipeline.preprocess(
                        ts, (eye, U, V, W), width, height, cfg,
                        lt_paths=min(args.light_paths, 50_000),
                        lt_depth=args.light_depth,
                        gamma_cfg={"epochs": args.gamma_epochs},
                        nn_train=args.classifier == "nn", verbose=True)
                    print(f"[train] {time.time()-t0:.0f}s "
                          f"{pstats.seconds}", flush=True)
                    if args.checkpoint:
                        ckpt_mod.save_subspace_state(args.checkpoint,
                                                     ss_trained)
            ss = ss_trained
        if alg == "spcbpt" and ss.trained:
            if args.second_stage == "auto":
                print(f"[bench] second stage '{ss.second_stage}' "
                      f"(trained selection)", flush=True)
            else:
                ss = ss.replace(second_stage=args.second_stage)
        if alg == "pt":
            def one(s, acc):
                fs, ct = pt_pool.render_pool_jit(
                    ts, eye, U, V, W, width, height, 1, seed_base + s,
                    max_depth=args.max_depth)
                return accumulate(acc, fs / jnp.maximum(ct[:, None], 1), s,
                                  clamp_c=args.clamp)
        else:
            from ..render import spcbpt_pool
            uniform = alg == "bdpt"
            # ts/ss as jit arguments, not constants (see render_ref_chunk)
            lt_jit = jax.jit(
                lambda ts_, ss_, f: light_trace.trace_light_paths(
                    ts_, ss_, args.light_paths, f,
                    max_depth=args.light_depth))
            lt = lambda f: lt_jit(ts, ss, f)
            build = lvc.make_builder(None if uniform else ss)

            def one(s, acc):
                sampler = build(lt(seed_base + s + 7919), seed_base + s)
                fs, ct = spcbpt_pool.render_pool_jit(
                    ts, ss, sampler, eye, U, V, W, width, height, 1,
                    seed_base + s,
                    max_depth=args.max_depth, uniform=uniform)
                return accumulate(acc, fs / jnp.maximum(ct[:, None], 1), s,
                                  clamp_c=args.clamp)

        acc = jnp.zeros((width * height, 3))
        # warm up / compile outside the timed loop
        acc = one(0, acc)
        jax.block_until_ready(acc)
        t0 = time.time()
        s = 1
        while True:
            acc = one(s, acc)
            s += 1
            if budget_s is not None:
                jax.block_until_ready(acc)
                if time.time() - t0 > budget_s:
                    break
            elif s >= spp:
                break
        jax.block_until_ready(acc)
        return np.asarray(acc), s, time.time() - t0

    for alg in algs:
        print(f"[bench] {alg} ...", flush=True)
        reps = []

        for r in range(max(1, args.repeats)):
            img, spp_done, dt = render_alg(
                alg, budget_s=args.equal_time,
                spp=None if args.equal_time else args.spp,
                seed_base=r * 1_000_003)
            rep = {"relmse": rel_mse(img, ref, discard=args.discard),
                   "spp": spp_done, "seconds": dt}
            reps.append(rep)
            print(f"[bench] {alg}[{r}]: relMSE {rep['relmse']:.5f} at "
                  f"{rep['spp']} spp ({rep['seconds']:.1f}s)", flush=True)
        med = sorted(rr["relmse"] for rr in reps)[len(reps) // 2]
        results["algs"][alg] = {
            "relmse": med, "spp": reps[0]["spp"],
            "seconds": sum(rr["seconds"] for rr in reps),
            "repeats": reps}
        print(f"[bench] {alg}: median relMSE {med:.5f} over {len(reps)} "
              f"repeat(s)", flush=True)
        if args.save_images:
            import os
            os.makedirs(args.save_images, exist_ok=True)
            write_png(f"{args.save_images}/{alg}.png",
                      to_display(jnp.asarray(img.reshape(height, width, 3)))[::-1])
    if args.save_images:
        from ..utils.image import write_png as wp
        import jax.numpy as jnp2
        wp(f"{args.save_images}/ref.png",
           to_display(jnp2.asarray(ref.reshape(height, width, 3)))[::-1])

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
