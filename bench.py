"""Benchmark entry: prints JSON metric lines, the last one merged.

Primary metric (name frozen): ``traversal_throughput_33k_tris``, closest-hit
traversal of full camera wavefronts over the bundled ~33k-triangle interior
through the tiled two-level cluster traversal (ops/tile_trace.py), in
Mrays/s per device, steady state over several iterations. Extras, each under
the remaining wall-clock budget: incoherent bounce rays through the scene's
own traversal (on a GPU the one-thread-per-ray kernel of ops/bvh_gpu.py),
the interior subdivided 1:4 per level (130k and 521k triangles) through the
same traversal, and PT ms/spp at 512^2.

One process on JAX's default device; it fails when that device is not a
GPU. Every line names the device kind and count, and the first line also
the card's name and power limit as nvidia-smi reports them.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

T0 = time.time()
BUDGET = float(os.environ.get("SPCBPT_BENCH_BUDGET", "420"))
METRIC = "traversal_throughput_33k_tris"


def _remaining():
    return BUDGET - (time.time() - T0)


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _geom_cache_path(tag: str) -> str:
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"bench_geom_{tag}.npz")


# Bump when the ClusterSet packing format changes (a cache keyed only by
# triangle count once measured stale geometry silently).
_GEOM_FORMAT_VERSION = 3


def _geom_tag(ts) -> str:
    import numpy as np
    h = hashlib.sha256()
    for a in (ts.tri_p0, ts.tri_e1, ts.tri_e2):
        h.update(np.ascontiguousarray(np.asarray(a, np.float32)).tobytes())
    return f"v{_GEOM_FORMAT_VERSION}_{h.hexdigest()[:16]}"


def _build_or_load_clusters(ts):
    """The bench's cluster set (max_tris=16) takes tens of seconds of host
    numpy on the 33k-tri interior; cache it on disk keyed by geometry
    content hash + format version."""
    import numpy as np
    import jax.numpy as jnp
    from spcbpt_tpu.ops import bvh as bvh_mod
    from spcbpt_tpu.ops import clusters as cl_mod

    path = _geom_cache_path(_geom_tag(ts))
    if os.path.exists(path):
        z = np.load(path)
        return cl_mod.ClusterSet(
            cmin=jnp.asarray(z["cmin"]), cmax=jnp.asarray(z["cmax"]),
            coeff=jnp.asarray(z["coeff"]),
            tri_begin=jnp.asarray(z["tri_begin"]), tri_k=int(z["tri_k"]))
    flat = bvh_mod.build_bvh(np.asarray(ts.tri_p0), np.asarray(ts.tri_e1),
                             np.asarray(ts.tri_e2))
    order = flat.order
    cs = cl_mod.build_clusters(flat, np.asarray(ts.tri_p0)[order],
                               np.asarray(ts.tri_e1)[order],
                               np.asarray(ts.tri_e2)[order], max_tris=16)
    np.savez(path, cmin=np.asarray(cs.cmin), cmax=np.asarray(cs.cmax),
             coeff=np.asarray(cs.coeff), tri_begin=np.asarray(cs.tri_begin),
             tri_k=cs.tri_k)
    return cs


def _rate(fn, n_rays: int, iters: int) -> float:
    """Mrays/s of fn() over `iters` steady-state calls (after a warm-up)."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.time()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return n_rays * iters / (time.time() - t0) / 1e6


def _measure_tile(cs, eye, U, V, W, width, height, iters, tile):
    import jax
    import jax.numpy as jnp
    from spcbpt_tpu.ops import tile_trace
    from spcbpt_tpu.render.common import camera_rays

    n = width * height
    tmn = jnp.full((n,), 1e-3)
    tmx = jnp.full((n,), 1e16)

    @jax.jit
    def trace(cs, frame):
        o, d, _ = camera_rays(eye, U, V, W, width, height, frame, block=32)
        hit = tile_trace.tile_closest(cs, o, d, tmn, tmx, True, tile=tile)
        return hit.t.sum(), (hit.tri >= 0).sum()

    n_hits = int(trace(cs, 0)[1])
    assert n_hits > 0.9 * n, f"camera rays must hit the interior ({n_hits})"
    frame = iter(range(1, iters + 2))
    return _rate(lambda: trace(cs, next(frame)), n, iters)


def _subdivide(p0, e1, e2):
    """Midpoint-split every triangle into four."""
    import numpy as np
    A, B, C = p0, p0 + e1, p0 + e2
    mab, mac, mbc = (A + B) / 2, (A + C) / 2, (B + C) / 2
    sp0 = np.concatenate([A, mab, mac, mbc])
    sp1 = np.concatenate([mab, B, mbc, mac])
    sp2 = np.concatenate([mac, mbc, C, mab])
    return sp0, sp1 - sp0, sp2 - sp0


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from spcbpt_tpu.runtime import setup
    setup()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench needs a GPU; JAX's default device is "
                         f"{dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    extras = {"device_kind": dev.device_kind,
              "device_count": len(jax.devices()),
              "card": card[0] if card else "unknown"}

    from spcbpt_tpu.ops import bvh as bvh_mod
    from spcbpt_tpu.ops import bvh_gpu
    from spcbpt_tpu.render.common import camera_rays
    from spcbpt_tpu.scene.interior import default_scene_path
    from spcbpt_tpu.scene.scene import load_trace_scene

    ts, desc, cam = load_trace_scene(default_scene_path())
    cam.aspect = 1.0
    eye, U, V, W = cam.uvw()
    cs = _build_or_load_clusters(ts)

    mrays = _measure_tile(cs, eye, U, V, W, 512, 512, 6, tile=1024)
    primary = {"metric": METRIC, "value": round(mrays, 2),
               "unit": "Mrays/s/device", "wavefront": "512x512"}
    _emit({**primary, **extras})

    if _remaining() > 120:
        mrays_big = _measure_tile(cs, eye, U, V, W, 1024, 1024, 10,
                                  tile=1024)
        extras["mrays_512"] = round(mrays, 2)
        primary.update(value=round(mrays_big, 2), wavefront="1024x1024")
        _emit({**primary, **extras})

    if _remaining() > 150:
        from spcbpt_tpu.ops import bsdf as bsdf_mod
        from spcbpt_tpu.scene.scene import local_geometry, trace_closest
        from spcbpt_tpu.utils import rng as rng_mod

        # one bounce of BSDF-sampled rays from the camera hits, lanes
        # shuffled: the incoherent wavefront the renderers trace
        nb = 1 << 17
        o1, d1, _ = camera_rays(eye, U, V, W, 512, 512, 0, block=16)
        hit = trace_closest(ts, o1[:nb], d1[:nb], 1e-3, 1e16, True)
        geom = local_geometry(ts, hit, o1[:nb], d1[:nb])
        st = rng_mod.seed(jnp.arange(nb, dtype=jnp.uint32), jnp.uint32(7))
        mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
        nd, _ = bsdf_mod.sample_bsdf(mat, geom["Ns"], -d1[:nb], st)
        perm = np.random.RandomState(0).permutation(nb)
        o2 = jnp.asarray(np.asarray(geom["P"])[perm])
        d2 = jnp.asarray(np.asarray(nd)[perm])
        f2 = jax.jit(lambda ts, o, d: trace_closest(
            ts, o, d, 1e-3, 1e16, True).t.sum())
        extras["secondary_mrays_" + ts.mode] = round(
            _rate(lambda: f2(ts, o2, d2), nb, 5), 2)

    if _remaining() > 150:
        # larger scenes through the same one-BVH traversal
        sp0, se1, se2 = (np.asarray(a) for a in (ts.tri_p0, ts.tri_e1,
                                                 ts.tri_e2))
        oL, dL, _ = camera_rays(eye, U, V, W, 512, 512, 0, block=32)
        fL = jax.jit(lambda o, d, *scene: bvh_gpu.bvh_closest(
            o, d, 1e-3, 1e16, *scene).t.sum())
        for _ in range(2):
            if _remaining() < 150:
                break
            sp0, se1, se2 = _subdivide(sp0, se1, se2)
            t_build = time.time()
            flat = bvh_mod.build_bvh(sp0, se1, se2)
            t_build = time.time() - t_build
            o = flat.order
            scene = [jnp.asarray(a) for a in (
                flat.bounds_min, flat.bounds_max, flat.skip, flat.leaf_start,
                flat.leaf_count, sp0[o], se1[o], se2[o])]
            key = f"mrays_{len(sp0) // 1000}k"
            extras[key] = round(_rate(lambda: fL(oL, dL, *scene),
                                      512 * 512, 5), 2)
            extras[key + "_bvh_build_s"] = round(t_build, 2)

    if _remaining() > 90:
        from spcbpt_tpu.render import pt_pool
        fr = lambda s: pt_pool.render_pool_jit(
            ts, eye, U, V, W, 512, 512, 1, s, max_depth=12)
        jax.block_until_ready(fr(0))
        t0 = time.time()
        for s in range(2):
            out3 = fr(s + 1)
        jax.block_until_ready(out3)
        extras["pt_ms_per_spp_512"] = round((time.time() - t0) / 2 * 1e3, 1)

    extras["bench_seconds"] = round(time.time() - T0, 1)
    _emit({**primary, **extras})
    return 0


if __name__ == "__main__":
    sys.exit(main())
