"""Renderer CLI — headless counterpart of the reference's interactive app.

Parity with reference UX (reference: optixPathTracer.cpp:121-240, 680-837):
  --alg pt|bdpt|spcbpt      algorithm select (Space toggle equivalent)
  --spp N                   progressive accumulation target
  --one-frame               single-sample inspection (P key)
  --print-camera            camera pose print (C key)
  --dim WxH                 resolution override (--dim flag)
plus training/checkpoint controls. Stats (per-phase ms + samples/s) print per
frame like the ImGui overlay (sutil.cpp:715-752).

Usage:
  python -m spcbpt_tpu.apps.render_cli --scene cornell --alg spcbpt \
      --spp 64 --out out.png
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description="spcbpt_tpu renderer")
    p.add_argument("--scene", default="cornell",
                   help=".scene path, or builtin: cornell | cornell_glossy |"
                        " interior | interior_lit | interior_cove")
    p.add_argument("--alg", default="spcbpt",
                   choices=["pt", "bdpt", "spcbpt"])
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--dim", default=None, help="WxH override, e.g. 512x512")
    p.add_argument("--max-depth", type=int, default=None)
    p.add_argument("--out", default="render.png")
    p.add_argument("--hdr-out", default=None, help="also save HDR npz")
    p.add_argument("--one-frame", action="store_true",
                   help="render a single sample (reference P key)")
    p.add_argument("--print-camera", action="store_true")
    p.add_argument("--light-paths", type=int, default=100_000,
                   help="light sub-paths per frame (reference M=100000)")
    p.add_argument("--light-depth", type=int, default=16)
    p.add_argument("--connection-n", type=int, default=3)
    p.add_argument("--train-samples", type=int, default=200_000,
                   help="pretraced paths for Gamma training")
    p.add_argument("--q-samples", type=int, default=500_000)
    p.add_argument("--classifier", default="centroid",
                   choices=["centroid", "nn"],
                   help="'nn' additionally trains the close-set refinement "
                        "network (C21; reference network_operator, unused in "
                        "its main) and samples the blended first stage")
    p.add_argument("--checkpoint", default=None,
                   help="save trained state (npz) here after preprocessing")
    p.add_argument("--resume", default=None,
                   help="load trained state instead of preprocessing")
    p.add_argument("--stats-json", default=None,
                   help="write render stats as JSON here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", default="default",
                   choices=["default", "cpu"],
                   help="'cpu' forces the CPU backend")
    return p


def resolve_scene(name: str) -> str:
    if os.path.exists(name):
        return name
    from ..scene.cornell import default_scene_path
    if name == "cornell":
        return default_scene_path()
    if name == "cornell_glossy":
        return default_scene_path(glossy=True)
    if name in ("interior", "interior_lit", "interior_cove"):
        from ..scene.interior import default_scene_path as interior_path
        mode = {"interior": "interior", "interior_lit": "lit",
                "interior_cove": "cove"}[name]
        return interior_path(mode=mode)
    raise SystemExit(f"scene not found: {name}")


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import jax
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from ..runtime import setup as _setup
    _setup()
    from ..config import PT_MAX_DEPTH, PretraceConfig
    from ..render import light_trace, lvc, pt_pool, spcbpt_pool
    from ..render.film import Film
    from ..scene.scene import load_trace_scene
    from ..train import classify, pipeline
    from ..utils.profiling import compile_clock
    from .. import checkpoint as ckpt_mod

    scene_path = resolve_scene(args.scene)
    t0 = time.time()
    ts, desc, cam = load_trace_scene(scene_path)
    width, height = desc.width, desc.height
    if args.dim:
        width, height = map(int, args.dim.lower().split("x"))
        cam.aspect = width / height
    eye, U, V, W = cam.uvw()
    device = jax.devices()[0]
    stats = {"alg": args.alg, "width": width, "height": height,
             "device_kind": device.device_kind, "phases": {
                 "scene_load": time.time() - t0}}
    print(f"[scene] {scene_path}: {ts.num_tris} tris, "
          f"{ts.num_lights} lights, mode={ts.mode} "
          f"({time.time()-t0:.1f}s) on {device.device_kind}", flush=True)
    if args.print_camera:
        print(f"[camera] eye {desc.eye} lookat {desc.lookat} up {desc.up} "
              f"fov {desc.fov}")

    spp = 1 if args.one_frame else args.spp
    max_depth = args.max_depth or (PT_MAX_DEPTH if args.alg == "pt" else 16)
    film = Film(width, height)
    stats["spp"] = spp

    with compile_clock() as compiled:
        ss = classify.untrained_state()
        if args.alg == "spcbpt":
            if args.resume:
                ss = ckpt_mod.load_subspace_state(args.resume)
                print(f"[train] resumed from {args.resume}")
            else:
                print("[train] preprocessing (pretrace + trees + Q + "
                      "Gamma)...", flush=True)
                cfg = PretraceConfig(num_core=8192,
                                     target_samples=args.train_samples,
                                     target_q_samples=args.q_samples)
                ss, pstats = pipeline.preprocess(
                    ts, (eye, U, V, W), width, height, cfg,
                    lt_paths=min(args.light_paths, 50_000),
                    lt_depth=min(args.light_depth, 8),
                    nn_train=args.classifier == "nn", verbose=True)
                stats["phases"]["preprocess"] = pstats.seconds
                print(f"[train] done: {pstats.seconds}")
                if args.checkpoint:
                    ckpt_mod.save_subspace_state(args.checkpoint, ss)
                    print(f"[train] checkpoint -> {args.checkpoint}")
        stats["preprocess_compile_seconds"] = compiled["seconds"]

        # one progressive frame (1 spp) per step; the light phase (light
        # sub-paths + LVC build) and the eye phase are fenced apart so each
        # is timed on its own
        if args.alg == "pt":
            def light_phase(s):
                return None

            def eye_phase(s, sampler):
                return pt_pool.render_pool_jit(
                    ts, eye, U, V, W, width, height, 1, s + args.seed,
                    max_depth=max_depth)
        else:
            uniform = args.alg == "bdpt"
            lt_jit = jax.jit(lambda ts_, ss_, f: light_trace.trace_light_paths(
                ts_, ss_, args.light_paths, f, max_depth=args.light_depth))
            build = lvc.make_builder(None if uniform else ss)
            if args.alg == "spcbpt" and ss.trained:
                print(f"[render] second stage '{ss.second_stage}'",
                      flush=True)

            def light_phase(s):
                return build(lt_jit(ts, ss, s + args.seed + 7919),
                             s + args.seed)

            def eye_phase(s, sampler):
                return spcbpt_pool.render_pool_jit(
                    ts, ss, sampler, eye, U, V, W, width, height, 1,
                    s + args.seed, max_depth=max_depth,
                    connection_n=args.connection_n, uniform=uniform)

        fsum = jnp.zeros((width * height, 3))
        count = jnp.zeros((width * height,), jnp.int32)
        light_s, eye_s = [], []
        t_render = time.time()
        for s in range(spp):
            t_lt = time.time()
            sampler = jax.block_until_ready(light_phase(s))
            t_eye = time.time()
            fs, ct = jax.block_until_ready(eye_phase(s, sampler))
            light_s.append(t_eye - t_lt)
            eye_s.append(time.time() - t_eye)
            fsum = fsum + fs
            count = count + ct
            if s == 0 or (s + 1) % 16 == 0:
                print(f"[frame {s+1}/{spp}] light {1e3*light_s[-1]:.0f} ms "
                      f"+ eye {1e3*eye_s[-1]:.0f} ms", flush=True)
        film.accum = fsum / jnp.maximum(count[:, None], 1)
        film.subframe = spp
        jax.block_until_ready(film.accum)
        dt = time.time() - t_render
    # the first frame compiles; the steady rate is over the frames after it
    steady = slice(1, None) if spp > 1 else slice(None)
    stats["compile_seconds"] = compiled["seconds"]
    stats["render_seconds"] = dt
    stats["first_frame_seconds"] = light_s[0] + eye_s[0]
    stats["light_ms_per_spp"] = 1e3 * float(np.mean(light_s[steady]))
    stats["eye_ms_per_spp"] = 1e3 * float(np.mean(eye_s[steady]))
    stats["ms_per_spp"] = stats["light_ms_per_spp"] + stats["eye_ms_per_spp"]
    mem = device.memory_stats() or {}
    stats["peak_bytes_in_use"] = mem.get("peak_bytes_in_use", 0)
    print(f"[render] {spp} spp in {dt:.1f}s: {stats['ms_per_spp']:.1f} "
          f"ms/spp after the first frame, {compiled['seconds']:.1f}s "
          f"compiling, peak device memory "
          f"{stats['peak_bytes_in_use'] / 2**30:.2f} GiB", flush=True)

    film.save_png(args.out)
    print(f"[out] {args.out}")
    if args.hdr_out:
        film.save_hdr(args.hdr_out)
        print(f"[out] {args.hdr_out}")
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
