"""Light sub-path tracing into the light vertex cache (LVC).

Behavior contract from the reference light tracer (reference:
__raygen__lightTrace raygen.cu:620-685, __closesthit__lightSubpath
hit_program.cu:341-438, vertex init raygen.cu:173-216): sample a light
uniformly, draw a cosine start direction (env: disk-projected origin), store
the origin vertex, then bounce with Disney sampling under RR, storing at every
hit a vertex with the cumulative flux/pdf RATIO (unit-invariant; see
LightVertices), subspace label (light tree), and the light-side
recursive-MIS accumulator updated per rmis.h:22-98.

Wavefront shape: one lane per light path (the reference's core x M_per_core loop is
flattened), lax.scan over the depth cap; the per-depth vertex batches are the
LVC — a fixed (max_depth+1, n_paths) SoA with valid flags, no compaction.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import CONNECTION_N, CULL_BACKFACE, MIN_RR_RATE, SCENE_EPSILON
from ..ops import bsdf as bsdf_mod
from ..ops import lights as lights_mod
from ..scene.scene import TraceScene, local_geometry, trace_closest
from ..train import classify
from ..utils import rng as rng_mod
from ..utils import vec
from .vertex import LightVertices


def _origin_vertices(ts: TraceScene, ls: lights_mod.LightSample, n: int):
    """LVC record for the light-source sample itself
    (init_vertex_from_lightSample raygen.cu:173-196)."""
    z3 = jnp.zeros((n, 3))
    return LightVertices(
        position=ls.position,
        normal=ls.normal,
        ratio=ls.emission / jnp.maximum(ls.pdf, 1e-30)[..., None],
        color=jnp.ones((n, 3)),
        last_position=z3,
        single_pdf=ls.pdf,
        last_normal_proj=jnp.ones((n,)),
        last_lum=jnp.zeros((n,)),
        rmis=jnp.ones((n,)),
        mat_id=ls.light_id,
        subspace_id=ls.subspace_id,
        eye_label=jnp.zeros((n,), jnp.int32),
        last_zone_id=jnp.zeros((n,), jnp.int32),
        depth=jnp.zeros((n,), jnp.int32),
        is_origin=jnp.ones((n,), bool),
        is_env=ls.is_env,
        is_ll_direction=jnp.zeros((n,), bool),
        is_brdf=jnp.zeros((n,), bool),
        last_brdf=jnp.zeros((n,), bool),
        valid=jnp.ones((n,), bool),
    )


def _vertex_pdf_bsdf(ts: TraceScene, v: LightVertices, in_dir, out_dir):
    """Tracer::Pdf at a stored vertex (color-overridden material)."""
    mat = bsdf_mod.gather_mat(ts.mats, jnp.maximum(v.mat_id, 0), v.color)
    return bsdf_mod.pdf_bsdf(mat, v.normal, in_dir, out_dir)


def _get_last_pdf(ts: TraceScene, v: LightVertices, in_dir):
    """rmis::getLast_pdf (rmis.h:41-51): area-measure pdf of re-generating the
    previous vertex from v given incident direction in_dir, including RR."""
    out_vec = v.last_position - v.position
    out_dir = vec.normalize(out_vec)
    pdf = _vertex_pdf_bsdf(ts, v, in_dir, out_dir)
    conv = v.last_normal_proj / jnp.maximum(vec.dot(out_vec, out_vec), 1e-20)
    pdf = jnp.where(v.is_ll_direction, pdf, pdf * conv)
    return pdf * bsdf_mod.rr_rate(v.color, MIN_RR_RATE)


def _tracing_weight_light(ts: TraceScene, ss: classify.SubspaceState,
                          last: LightVertices, mid_position):
    """rmis::tracing_weight_light (rmis.h:57-79): the connect-rate weight of
    the strategy that connects at `last` (treated as an eye vertex). Uses
    the shared rmis.connect_rate so the light-side RMIS chains stay
    calibrated to the active second stage."""
    from . import rmis
    w = rmis.connect_rate(ss, last.eye_label, last.last_zone_id,
                          last.last_lum)
    return jnp.where(last.last_brdf | last.is_brdf, 0.0, w)


def trace_light_paths(ts: TraceScene, ss: classify.SubspaceState,
                      n_paths: int, frame, max_depth: int = 8,
                      seed_salt: int = 0x9E37) -> LightVertices:
    """Trace n_paths light sub-paths; returns LightVertices with shape
    (max_depth+1, n_paths) — slot d holds the depth-d vertex of each path."""
    lane = jnp.arange(n_paths, dtype=jnp.uint32)
    state = rng_mod.seed(lane + jnp.uint32(seed_salt),
                         jnp.asarray(frame, jnp.uint32))

    ls, state = lights_mod.sample_light(ts, state)
    v0 = _origin_vertices(ts, ls, n_paths)
    direction, origin, dir_pdf, state = lights_mod.trace_mode(ts, ls, state)

    carry = dict(
        v=v0, o=origin, d=direction, state=state,
        pending_single_pdf=dir_pdf,            # next vertex's segment pdf
        pending_f=jnp.ones((n_paths, 3)),      # bsdf value folded at next hit
        done=jnp.zeros((n_paths,), bool),
    )

    def body(c, _):
        last = c["v"]
        # dead-lane tmax: RR-terminated paths would otherwise re-trace the
        # same ray every remaining scan step (see render/pt.py body note)
        hit = trace_closest(ts, c["o"], c["d"], SCENE_EPSILON,
                            jnp.where(c["done"], -1.0, 1e16), CULL_BACKFACE)
        geom = local_geometry(ts, hit, c["o"], c["d"])
        # light sub-paths stop on emitters (hit_program.cu:239-244) and misses
        alive = ~c["done"] & hit.valid & (geom["light_id"] < 0)

        d = c["d"]
        n_mid = geom["Ns"]
        cos_mid = jnp.abs(vec.dot(n_mid, d))
        cos_last = jnp.abs(vec.dot(last.normal, d))
        inv_t2 = 1.0 / jnp.maximum(hit.t * hit.t, 1e-20)
        # directional/env previous vertex: no 1/t^2 (hit_program.cu:372-375)
        pdf_g = jnp.where(last.is_env, cos_mid * cos_last,
                          cos_mid * cos_last * inv_t2)

        # ratio update: the pdf_g geometry factor cancels between cumulative
        # flux and pdf, leaving the unit-invariant throughput recurrence
        # ratio *= f * cos / (bpdf * rr) (see LightVertices docstring)
        step = (cos_last / jnp.maximum(c["pending_single_pdf"], 1e-30))[..., None]
        ratio = jnp.where(last.is_origin[..., None],
                          last.ratio * step,
                          last.ratio * c["pending_f"] * step)
        single_pdf = c["pending_single_pdf"] * pdf_g / jnp.maximum(cos_last, 1e-20)

        last_position = jnp.where(last.is_env[..., None],
                                  geom["P"] - d, last.position)
        subspace = classify.label_light(ss, geom["P"], n_mid)
        last_lum = vec.float3weight(last.ratio)

        # light-side RMIS update (rmis.h:22-26, 80-98)
        ll_pdf = _get_last_pdf(ts, last, d)
        weight = _tracing_weight_light(ts, ss, last, geom["P"])
        rmis_init = last.rmis / jnp.maximum(last.single_pdf, 1e-30)
        rmis_upd = ((last.rmis * ll_pdf + weight)
                    / jnp.maximum(last.single_pdf, 1e-30))
        rmis = jnp.where(last.is_origin, rmis_init, rmis_upd)

        mid = LightVertices(
            position=geom["P"], normal=n_mid, ratio=ratio, color=geom["base_color"],
            last_position=last_position, single_pdf=single_pdf,
            last_normal_proj=cos_last, last_lum=last_lum, rmis=rmis,
            mat_id=geom["mat_id"], subspace_id=subspace,
            eye_label=classify.label_eye(ss, geom["P"], n_mid),
            last_zone_id=last.subspace_id,
            depth=last.depth + 1,
            is_origin=jnp.zeros_like(alive),
            is_env=jnp.zeros_like(alive),
            is_ll_direction=last.is_env & (last.depth == 0),
            is_brdf=jnp.zeros_like(alive),
            last_brdf=last.is_brdf,
            valid=alive,
        )

        # next bounce: Disney sample + RR (hit_program.cu:354-357, 420-436)
        v_dir = -d
        mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
        new_d, state2 = bsdf_mod.sample_bsdf(mat, n_mid, v_dir, c["state"])
        bpdf = bsdf_mod.pdf_bsdf(mat, n_mid, v_dir, new_d)
        f = bsdf_mod.eval_bsdf(mat, n_mid, v_dir, new_d)
        rr = bsdf_mod.rr_rate(geom["base_color"], MIN_RR_RATE)
        r, state2 = rng_mod.next_float(state2)
        cont = alive & (r <= rr) & (bpdf > 0.0)

        # keep dead lanes' carry stable; only advancing lanes update
        new_carry = dict(
            v=jax.tree_util.tree_map(
                lambda new, old: jnp.where(
                    alive.reshape(alive.shape + (1,) * (new.ndim - 1)), new, old),
                mid, last),
            o=vec.where3(cont, geom["P"], c["o"]),
            d=vec.where3(cont, new_d, c["d"]),
            state=state2,
            pending_single_pdf=jnp.where(cont, bpdf * rr,
                                         c["pending_single_pdf"]),
            pending_f=vec.where3(cont, f, c["pending_f"]),
            done=c["done"] | ~cont,
        )
        return new_carry, mid

    _, per_depth = jax.lax.scan(body, carry, None, length=max_depth)
    # prepend the origin vertices as depth slot 0
    out = jax.tree_util.tree_map(
        lambda v0f, rest: jnp.concatenate([v0f[None], rest], axis=0),
        v0, per_depth)
    return out
