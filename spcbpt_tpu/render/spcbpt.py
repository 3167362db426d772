"""SPCBPT eye-side renderer: eye sub-paths with probabilistic, subspace-driven
connections to cached light vertices, weighted by recursive MIS.

Behavior contract (reference: __raygen__SPCBPT raygen.cu:319-443,
__closesthit__eyeSubpath hit_program.cu:246-340, emitter hit
hit_program.cu:62-147, connection eval connectVertex_SPCBPT raygen.cu:253-303):
per eye vertex draw CONNECTION_N light vertices by two-stage subspace sampling
(Gamma-CMF row, then per-subspace vertex CMF), test visibility, and add
  contri/(pdf_eye*pdf_light) * G * fa * fb * rmis_weight / pmf / CONNECTION_N
with pmf = path_count * pmf1 * pmf2 (raygen.cu:410-414). Direct emitter hits
use the cached light_hit weight (hit_program.cu:128-147).

The same loop with uniform vertex choice (uniform=True) and an untrained
subspace state is the classic-BDPT baseline (BASELINE.md config 2).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import (CONNECTION_N, CULL_BACKFACE, MIN_RR_RATE, SCENE_EPSILON,
                      SUBPATH_MAX_DEPTH)
from ..ops import bsdf as bsdf_mod
from ..ops import lights as lights_mod
from ..scene.scene import TraceScene, local_geometry, trace_closest, visibility
from ..train import classify
from ..utils import rng as rng_mod
from ..utils import vec
from . import common, rmis
from .lvc import (LVCSampler, sample_first_stage, sample_second_stage,
                  sample_second_stage_mixture, sample_second_stage_table,
                  sample_second_stage_uniform, sample_uniform)
from .vertex import unpack_rows, unpack_weight_b
from .rmis import EyeVertices


def _init_eye_vertices(origins, dirs):
    """init_EyeSubpath (raygen.cu:222-238): camera vertex."""
    n = origins.shape[0]
    z = jnp.zeros((n,))
    zi = jnp.zeros((n,), jnp.int32)
    zb = jnp.zeros((n,), bool)
    return EyeVertices(
        position=origins, normal=dirs, color=jnp.ones((n, 3)),
        last_position=origins, single_pdf=jnp.ones((n,)),
        last_normal_proj=jnp.ones((n,)), rmis3=jnp.zeros((n, 3)),
        rmis_u=jnp.zeros((n,)),
        mat_id=zi, subspace_id=zi, light_label=zi, last_zone_id=zi, depth=zi,
        is_ll_direction=zb, is_brdf=zb, last_brdf=zb,
    )


def connect_vertex(ts: TraceScene, ss: classify.SubspaceState,
                   eye_v, light_v):
    """connectVertex_SPCBPT (raygen.cu:253-303) WITHOUT the pmf division.
    Returns (N, 3) contribution (zero where invalid)."""
    connect_vec = eye_v.position - light_v.position
    connect_dir = vec.normalize(connect_vec)
    # direction/env light vertices connect by direction (raygen.cu:234-252)
    dir_conn = light_v.is_env
    conn_dir_e = jnp.where(dir_conn[..., None], -light_v.normal, connect_dir)

    cos_a = jnp.abs(vec.dot(eye_v.normal, conn_dir_e))
    cos_b = jnp.abs(vec.dot(light_v.normal, connect_dir))
    g = cos_a * cos_b / jnp.maximum(vec.dot(connect_vec, connect_vec), 1e-20)

    la_dir = vec.normalize(eye_v.last_position - eye_v.position)
    lb_dir = vec.normalize(light_v.last_position - light_v.position)

    # eye->light direction: -connect_dir for surface vertices; for env
    # vertices conn_dir_e already points surface->env (negating it would
    # put the eval in the wrong hemisphere and zero all env connections)
    to_light = jnp.where(dir_conn[..., None], conn_dir_e, -conn_dir_e)
    fa = rmis._eval_at(ts, eye_v, to_light, la_dir)
    fb = rmis._eval_at(ts, light_v, connect_dir, lb_dir)
    # origin (on-light) vertices: fb = [facing ? 1 : 0] (raygen.cu:275-287)
    facing = vec.dot(light_v.normal, -connect_dir) <= 0.0
    fb = jnp.where(light_v.is_origin[..., None],
                   jnp.where(facing[..., None], 1.0, 0.0), fb)

    # cumulative flux/pdf enter only as their ratio (unit-invariant; see
    # LightVertices): contri/pdf == eye.ratio * light.ratio * fa * fb * g
    contri = eye_v.ratio * light_v.ratio * fa * fb * g[..., None]

    w_general = rmis.general_connection(ts, ss, eye_v, light_v)
    w_source = rmis.connection_light_source(ts, ss, eye_v, light_v)
    w = jnp.where(light_v.depth == 0, w_source, w_general)

    # direction-connect variant (raygen.cu:234-252): L = a.flux/a.pdf * fa *
    # cos * b.flux/b.pdf * w — i.e. the ratio product without fb and with
    # g -> cos_a for env vertices
    contri_dir = (eye_v.ratio * light_v.ratio * fa
                  * vec.dot(eye_v.normal, conn_dir_e)[..., None])
    ok_dir = vec.dot(eye_v.normal, conn_dir_e) > 0.0
    contri = jnp.where(dir_conn[..., None],
                       jnp.where(ok_dir[..., None], contri_dir, 0.0), contri)

    ans = contri * w[..., None]
    return vec.scrub(ans)


def connect_vertex_fused(ts: TraceScene, ss: classify.SubspaceState,
                         eye_v, light_v, pmf1=None, eye_parts=None,
                         weight_b=None):
    """connect_vertex + general_connection + connection_light_source fused:
    the same weighted contribution with every shared quantity computed once.
    The three originals independently re-derive materials, BSDF evals and
    pdfs; here

      * one material gather per endpoint serves every eval/pdf;
      * one eval per endpoint serves both the contribution factor (fa/fb)
        and the RMIS flux multiplier (fm0/fm1) — eval_bsdf is reciprocal
        (Burley BRDF: h, |dot(l,h)|=|dot(v,h)| symmetric), pinned by
        tests/test_bsdf.py;
      * both pdf directions of each endpoint come from one pdf_bsdf_pair
        (shared half-vector term);
      * the eye-side RMIS accumulator (_eye_side_D) is computed once and
        shared by the general and light-source combiners (the originals each
        recompute it; their connect_dir differs only on env lanes, where the
        general combiner's result is never selected).

    Optional precomputed args (all exactness-preserving, each removing
    Gamma-table gathers — the dominant connection cost, 164 ms of the 501 ms
    256^2 frame in the r5 ablation):
      * pmf1: the first-stage sampling pmf of light_v's subspace. When the
        first stage sampled the Gamma row (trained, no nn, not uniform),
        pmf1 == Gamma(eye_ss, light_ss) exactly (alias_pack stores gamma_pmf
        values, classify.publish_tables), so the connection strategy weight
        needs only the small q/inv_occ gathers instead of a 2D Gamma gather.
      * eye_parts: (w_part, u_part) = rmis.tracing_weight_eye_parts(eye_v)
        computed ONCE per eye vertex by the caller instead of per draw.
      * weight_b: per-vertex rmis.tracing_weight_light, precomputed at LVC
        build (vertex.pack_matrix weight_b column).

    Equivalence to connect_vertex is pinned by
    tests/test_rmis_oracle.py::test_connect_vertex_fused_matches (both bare
    and with every precomputed arg supplied).
    Reference: connectVertex_SPCBPT raygen.cu:253-303 + rmis.h:212-323."""
    conn_vec = eye_v.position - light_v.position
    connect_dir = vec.normalize(conn_vec)            # light -> eye
    dir_conn = light_v.is_env
    conn_dir_e = jnp.where(dir_conn[..., None], -light_v.normal, connect_dir)
    # eye->light direction; for env lanes conn_dir_e already points
    # surface->env. Equals -connect_dir on every lane where the general
    # combiner or the non-env source combiner is selected, and equals the
    # source combiner's -connect_dir on env lanes.
    in_e = jnp.where(dir_conn[..., None], conn_dir_e, -conn_dir_e)

    la = vec.normalize(eye_v.last_position - eye_v.position)
    lb = vec.normalize(light_v.last_position - light_v.position)
    mat_e = bsdf_mod.gather_mat(ts.mats, jnp.maximum(eye_v.mat_id, 0),
                                eye_v.color)
    mat_l = bsdf_mod.gather_mat(ts.mats, jnp.maximum(light_v.mat_id, 0),
                                light_v.color)
    rr_e = bsdf_mod.rr_rate(eye_v.color, MIN_RR_RATE)
    rr_l = bsdf_mod.rr_rate(light_v.color, MIN_RR_RATE)
    flux = light_v.ratio
    lum_flux = vec.float3weight(flux)
    inv_sp_e = 1.0 / jnp.maximum(eye_v.single_pdf, 1e-30)
    inv_sp_l = 1.0 / jnp.maximum(light_v.single_pdf, 1e-30)
    aw, au = rmis.mix_coeffs(ss)

    # ---- contribution factors (connectVertex_SPCBPT raygen.cu:253-303) ----
    cos_a = jnp.abs(vec.dot(eye_v.normal, conn_dir_e))
    cos_b = jnp.abs(vec.dot(light_v.normal, connect_dir))
    g = cos_a * cos_b / jnp.maximum(vec.dot(conn_vec, conn_vec), 1e-20)
    fa = bsdf_mod.eval_bsdf(mat_e, eye_v.normal, in_e, la)
    fb = bsdf_mod.eval_bsdf(mat_l, light_v.normal, connect_dir, lb)
    facing = vec.dot(light_v.normal, -connect_dir) <= 0.0
    fb_eff = jnp.where(light_v.is_origin[..., None],
                       jnp.where(facing[..., None], 1.0, 0.0), fb)
    contri = eye_v.ratio * flux * fa * fb_eff * g[..., None]
    contri_dir = (eye_v.ratio * flux * fa
                  * vec.dot(eye_v.normal, conn_dir_e)[..., None])
    ok_dir = vec.dot(eye_v.normal, conn_dir_e) > 0.0
    contri = jnp.where(dir_conn[..., None],
                       jnp.where(ok_dir[..., None], contri_dir, 0.0), contri)

    # ---- shared eye-side RMIS accumulator (rmis.h:219-233) ----
    pdf_e_fwd, pdf_e_rev = bsdf_mod.pdf_bsdf_pair(mat_e, eye_v.normal, in_e,
                                                  la)
    # get_last_pdf(eye_v, in_e): area pdf of regenerating eye_v's previous
    # vertex, seen from the connection direction
    conv_last_e = eye_v.last_normal_proj / jnp.maximum(
        vec.dot(eye_v.last_position - eye_v.position,
                eye_v.last_position - eye_v.position), 1e-20)
    ll_pdf_a = (jnp.where(eye_v.is_ll_direction, pdf_e_fwd,
                          pdf_e_fwd * conv_last_e) * rr_e)
    cos_e_la = jnp.abs(vec.dot(eye_v.normal, la))
    fm0 = fa * (cos_e_la / jnp.maximum(pdf_e_fwd * rr_e, 1e-20))[..., None]
    if eye_parts is None:
        eye_parts = rmis.tracing_weight_eye_parts(ts, ss, eye_v,
                                                  light_v.position)
    w_part, u_part = eye_parts
    d_a0_w = eye_v.rmis3 * ll_pdf_a[..., None] * fm0 + w_part[..., None]
    d_a0_u = eye_v.rmis_u * ll_pdf_a + u_part

    # pdf_b = get_pdf(eye_v, light_v.position, light_v.normal, is_env, la):
    # its out_dir equals in_e on every lane (env: -light normal; else
    # -connect_dir), so the reverse pdf of the shared pair serves it
    conv_b = cos_b / jnp.maximum(vec.dot(conn_vec, conn_vec), 1e-20)
    pdf_b = jnp.where(light_v.is_env, pdf_e_rev, pdf_e_rev * conv_b) * rr_e

    # strategy weight of THIS connection (shared by both combiners)
    if pmf1 is not None and ss.trained:
        # pmf1 == Gamma(eye_ss, light_ss): connect_rate without the 2D gather
        lsub = light_v.subspace_id
        base = pmf1 * CONNECTION_N
        weight = jnp.zeros_like(pmf1)
        if aw != 0.0:
            weight = weight + aw * base * lum_flux / ss.q[lsub]
        if au != 0.0 and ss.inv_occ is not None:
            from ..config import NUM_SUBSPACE
            weight = weight + au * base * ss.inv_occ[
                jnp.clip(lsub, 0, NUM_SUBSPACE - 1)]
    else:
        weight = rmis.connect_rate(ss, eye_v.subspace_id,
                                   light_v.subspace_id, lum_flux)

    # ---- general combiner (light depth > 0; rmis.h:212-247) ----
    pdf_l_fwd, pdf_l_rev = bsdf_mod.pdf_bsdf_pair(mat_l, light_v.normal, lb,
                                                  connect_dir)
    conv_a = cos_a / jnp.maximum(vec.dot(conn_vec, conn_vec), 1e-20)
    pdf_a_gen = pdf_l_fwd * conv_a * rr_l
    cos_l_cd = jnp.abs(vec.dot(light_v.normal, connect_dir))
    # fm1 = flux_multiplier(light_v, lb, connect_dir); eval reciprocity
    # folds its eval into fb
    fm1 = fb * (cos_l_cd / jnp.maximum(pdf_l_fwd * rr_l, 1e-20))[..., None]
    d_a_gen = (aw * vec.float3weight(d_a0_w * pdf_a_gen[..., None] * fm1
                                     * flux)
               + au * d_a0_u * pdf_a_gen) * inv_sp_e
    conv_last_l = light_v.last_normal_proj / jnp.maximum(
        vec.dot(light_v.last_position - light_v.position,
                light_v.last_position - light_v.position), 1e-20)
    ll_pdf_b = (jnp.where(light_v.is_ll_direction, pdf_l_rev,
                          pdf_l_rev * conv_last_l) * rr_l)
    if weight_b is None:
        weight_b = rmis.tracing_weight_light(ts, ss, light_v, eye_v.position)
    d_b_gen = (light_v.rmis * ll_pdf_b + weight_b) * pdf_b * inv_sp_l
    w_gen = weight / jnp.maximum(weight + d_a_gen + d_b_gen, 1e-30)

    # ---- light-source combiner (light depth == 0; rmis.h:281-323) ----
    pdf_a_src = rmis.get_pdf_from_light_source(ts, light_v, eye_v.position,
                                               eye_v.normal)
    if ts.has_env:
        from ..scene import envmap as env_mod
        fm1_src = jnp.where(light_v.is_env,
                            1.0 / env_mod.env_project_pdf(ts.env), jnp.pi)
    else:
        fm1_src = jnp.full_like(pdf_a_src, jnp.pi)
    d_a_src = (aw * vec.float3weight(d_a0_w * (pdf_a_src * fm1_src)[..., None]
                                     * flux)
               + au * d_a0_u * pdf_a_src) * inv_sp_e
    d_b_src = light_v.rmis * pdf_b * inv_sp_l
    w_src = weight / jnp.maximum(weight + d_a_src + d_b_src, 1e-30)

    w = jnp.where(light_v.depth == 0, w_src, w_gen)
    w = jnp.where(eye_v.is_brdf | light_v.is_brdf, 0.0, w)
    return vec.scrub(contri * w[..., None])


def make_spcbpt_step(ts: TraceScene, ss: classify.SubspaceState,
                     sampler: LVCSampler, max_depth: int = SUBPATH_MAX_DEPTH,
                     connection_n: int = CONNECTION_N, uniform: bool = False,
                     second_stage=None, record: bool = False):
    """Returns f(origins, dirs, rng_state) -> (N, 3) one SPCBPT sample/lane.

    record=True additionally returns the per-depth eye vertices (the scan's
    `mid` outputs plus the extended flux/pdf ratio and a validity mask) so tests can
    rebuild complete paths and check the cached RMIS weights against the
    exact full-path oracle (render/oracle.py; reference
    __raygen__SPCBPT_no_rmis raygen.cu:445-463).

    Note: the carried 'ratio' is the cumulative flux/pdf of BDPTVertex as a
    single unit-invariant quantity (see LightVertices)."""

    def step(origins, dirs, state):
        n = origins.shape[0]
        eye0 = _init_eye_vertices(origins, dirs)
        carry = dict(
            o=origins, d=dirs, state=state,
            v=eye0,
            ratio=jnp.ones((n, 3)),
            pending_f=jnp.ones((n, 3)), pending_single=jnp.ones((n,)),
            result=jnp.zeros((n, 3)),
            done=jnp.zeros((n,), bool),
            depth=jnp.zeros((n,), jnp.int32),
        )

        def body(c, _):
            last = c["v"]
            live = ~c["done"]
            # dead-lane tmax: done lanes would otherwise re-trace their last
            # ray every remaining scan step (see pt.py body note)
            hit = trace_closest(ts, c["o"], c["d"], SCENE_EPSILON,
                                jnp.where(live, 1e16, -1.0), CULL_BACKFACE)
            geom = local_geometry(ts, hit, c["o"], c["d"])
            miss = ~hit.valid & live
            hit_light = hit.valid & (geom["light_id"] >= 0) & live
            hit_surf = hit.valid & (geom["light_id"] < 0) & live

            d = c["d"]
            cos_mid_l = jnp.abs(vec.dot(geom["Ns"], d))
            # camera vertex "normal" is the primary ray direction, so this is
            # exactly 1 on the first segment (init_EyeSubpath raygen.cu:222)
            cos_last = jnp.abs(vec.dot(last.normal, d))
            inv_t2 = 1.0 / jnp.maximum(hit.t * hit.t, 1e-20)

            # RMIS recursion update for the next vertex — computed FIRST so
            # the emitter-hit / env-escape weights below reuse its products
            # (rmis.light_hit_cached: saves 3 pdf + 1 eval BSDF calls per
            # lane per bounce). in_dir=d: exact for miss lanes too.
            rmis3_new, rmis_u_new = rmis.tracing_update_eye(
                ts, ss, last, geom["P"], jnp.zeros_like(hit.valid), in_dir=d)

            # ---- emitter hit (hit_program.cu:62-147) ----
            # the (cos*cos/t^2) geometry factor cancels between cumulative
            # flux and pdf; carry the unit-invariant ratio directly
            lid = jnp.maximum(geom["light_id"], 0)
            ls_rev = lights_mod.reverse_sample_quad(ts, lid, geom["uv"])
            front = vec.dot(d, ls_rev.normal) <= 0.0
            # depth>=2: the pending BSDF factor from the previous bounce folds
            # in here (hit_program.cu:99-106 multiplies MidVertex.flux,
            # pre-seeded with Eval at the previous hit, into the product)
            step = (cos_last / jnp.maximum(c["pending_single"], 1e-30))[..., None]
            ratio_l = jnp.where((last.depth == 0)[..., None],
                                c["ratio"],
                                c["pending_f"] * c["ratio"]) \
                * (step * ls_rev.emission)
            direct = c["depth"] == 0  # MidVertex.depth == 1
            w_hit = rmis.light_hit_cached(
                ss, last, rmis3_new, rmis_u_new, d, cos_last, inv_t2,
                c["pending_single"], ls_rev.normal, ls_rev.emission,
                ls_rev.pdf, ls_rev.subspace_id)
            w_hit = jnp.where(direct, 1.0, w_hit)
            emit = ratio_l * w_hit[..., None]
            result = c["result"] + jnp.where((hit_light & front)[..., None],
                                             vec.scrub(emit), 0.0)

            # ---- env escape: virtual direction-light hit ----
            # (beyond reference parity: __miss__BDPTVertex raygen.cu:699
            # drops this; we weight it against env LVC connections with
            # rmis.light_hit_env so env scenes converge to PT)
            if ts.has_env:
                from ..scene import envmap as env_mod
                env_rad = env_mod.env_color(ts.env, d)
                ratio_env = jnp.where((last.depth == 0)[..., None],
                                      c["ratio"],
                                      c["pending_f"] * c["ratio"]) \
                    * (step * env_rad)
                e_pdf = env_mod.env_pdf(ts.env, d) / ts.num_lights
                w_env = rmis.light_hit_env_cached(
                    ts, ss, last, rmis3_new, rmis_u_new, d, cos_last,
                    c["pending_single"], env_rad, e_pdf,
                    env_mod.env_label(ts.env, d))
                w_env = jnp.where(c["depth"] == 0, 1.0, w_env)
                result = result + jnp.where(
                    miss[..., None],
                    vec.scrub(ratio_env * w_env[..., None]), 0.0)

            # ---- new eye vertex (hit_program.cu:246-340) ----
            pdf_g = cos_mid_l * cos_last * inv_t2
            ratio_mid = jnp.where((last.depth == 0)[..., None],
                                  c["ratio"],
                                  c["pending_f"] * c["ratio"]) * step
            single_mid = c["pending_single"] * pdf_g / jnp.maximum(cos_last, 1e-20)
            sub_mid = classify.label_eye(ss, geom["P"], geom["Ns"])
            first = last.depth == 0
            rmis3 = jnp.where(first[..., None],
                              jnp.zeros((geom["P"].shape[0], 3)), rmis3_new)
            rmis_u = jnp.where(first, 0.0, rmis_u_new)
            mid = EyeVertices(
                position=geom["P"], normal=geom["Ns"], color=geom["base_color"],
                last_position=last.position, single_pdf=single_mid,
                last_normal_proj=cos_last, rmis3=rmis3, rmis_u=rmis_u,
                mat_id=geom["mat_id"], subspace_id=sub_mid,
                light_label=classify.label_light(ss, geom["P"], geom["Ns"]),
                last_zone_id=last.subspace_id, depth=last.depth + 1,
                is_ll_direction=jnp.zeros_like(hit_surf),
                is_brdf=jnp.zeros_like(hit_surf), last_brdf=last.is_brdf,
            )

            # ---- CONNECTION_N probabilistic connections (raygen.cu:390-420) ----
            if connection_n > 0:
                conn_total, state2 = _connections(
                    ts, ss, sampler, mid, ratio_mid, c["state"],
                    connection_n, uniform, second_stage, live=hit_surf)
                result = result + jnp.where(hit_surf[..., None],
                                            conn_total / connection_n, 0.0)
            else:
                state2 = c["state"]

            # ---- RR + bounce ----
            v_dir = -d
            mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
            new_d, state2 = bsdf_mod.sample_bsdf(mat, geom["Ns"], v_dir, state2)
            bpdf = bsdf_mod.pdf_bsdf(mat, geom["Ns"], v_dir, new_d)
            f = bsdf_mod.eval_bsdf(mat, geom["Ns"], v_dir, new_d)
            rr = bsdf_mod.rr_rate(geom["base_color"], MIN_RR_RATE)
            r, state2 = rng_mod.next_float(state2)
            cont = hit_surf & (r <= rr) & (bpdf > 0.0)

            depth = c["depth"] + jnp.where(live, 1, 0)
            done = c["done"] | miss | hit_light | (hit_surf & ~cont) \
                | (depth > max_depth)

            keep = hit_surf

            def sel(new, old):
                return jnp.where(
                    keep.reshape(keep.shape + (1,) * (new.ndim - 1)), new, old)

            y = 0
            if record:
                y = dict(v=mid, ratio=ratio_mid, valid=hit_surf)
            return dict(
                o=vec.where3(cont, geom["P"], c["o"]),
                d=vec.where3(cont, new_d, c["d"]),
                state=state2,
                v=jax.tree_util.tree_map(sel, mid, last),
                ratio=sel(ratio_mid, c["ratio"]),
                pending_f=vec.where3(cont, f, c["pending_f"]),
                pending_single=jnp.where(cont, bpdf * rr, c["pending_single"]),
                result=result,
                done=done,
                depth=depth,
            ), y

        c, ys = jax.lax.scan(body, carry, None, length=max_depth + 1)
        if record:
            return c["result"], ys
        return c["result"]

    return step


def trace_eye_paths(ts: TraceScene, ss: classify.SubspaceState,
                    origins, dirs, state, max_depth: int):
    """Trace eye sub-paths and return the per-depth EyeVertices records
    (dict with v: EyeVertices, flux, pdf, valid; leading axis = depth-1).
    Runs the SAME scan body as the SPCBPT renderer (connections disabled),
    so cached RMIS state is exactly what the renderer would use."""
    step = make_spcbpt_step(ts, ss, None, max_depth=max_depth,
                            connection_n=0, record=True)
    _, ys = step(origins, dirs, state)
    return ys


def _env_r(ts):
    return ts.env.r if ts.has_env else jnp.float32(1.0)


def _connections(ts, ss, sampler, mid: EyeVertices, eye_ratio, state,
                 connection_n: int, uniform: bool, second_stage=None,
                 live=None):
    # second_stage=None (default): O(1) uniform-in-subspace vertex pick,
    # 1.48x faster frames at ~3% relMSE on the glossy A/B — equal-time win.
    # "weighted" = the reference's flux-weighted vertex CMF (cuProg.h:268).
    """The CONNECTION_N sampling/eval loop; returns (sum contribution, state)."""
    n = eye_ratio.shape[0]
    total = jnp.zeros((n, 3))
    if connection_n == 0:
        return total, state
    if second_stage is None:
        # weights (rmis.connect_rate) key off the state; keep sampling in
        # lockstep so the MIS calibration always matches the sampler
        second_stage = ss.second_stage if ss.trained else "uniform"
    eye_for_conn = _ConnEye(mid, eye_ratio)
    # per-frame presampled table for this mode: replaces the per-draw CMF
    # bisection with two gathers — see lvc.presample_tables for the
    # unbiasedness argument
    use_table = (sampler.table_idx is not None
                 and sampler.table_mode == second_stage)
    draws = []
    for _ in range(connection_n):
        if uniform:
            idx, pmf2, ok_seg, state = sample_uniform(sampler, state)
            pmf1 = jnp.ones_like(pmf2)
        else:
            lsub, pmf1, state = sample_first_stage(
                ss, mid.subspace_id, state,
                position=mid.position, normal=mid.normal)
            if second_stage == "uniform":
                idx, pmf2, ok_seg, state = sample_second_stage_uniform(
                    sampler, lsub, state)
            elif use_table:
                idx, pmf2, ok_seg, state = sample_second_stage_table(
                    sampler, lsub, state)
            elif second_stage == "mixture":
                idx, pmf2, ok_seg, state = sample_second_stage_mixture(
                    sampler, lsub, state)
            else:
                idx, pmf2, ok_seg, state = sample_second_stage(
                    sampler, lsub, state)
        draws.append((idx, pmf1, pmf2, ok_seg))
    # ONE occlusion wavefront for all connection_n draws: per-call traversal
    # overhead (entry prep + kernel dispatch) amortizes 3x
    idx_all = jnp.concatenate([d[0] for d in draws])
    wb_all = None
    if sampler.packed is not None:
        # one row-gather for the whole record vs ~20 scalar gathers
        rows = sampler.packed[idx_all]
        lv_all = unpack_rows(rows)
        if sampler.has_weight_b:
            wb_all = unpack_weight_b(rows)
    else:
        lv_all = sampler.vertices.take(idx_all)
    pos_all = jnp.tile(mid.position, (connection_n, 1))
    target_all = jnp.where(lv_all.is_env[..., None],
                           pos_all - 10.0 * _env_r(ts) * lv_all.normal,
                           lv_all.position)
    # Evaluate contribution + pmf BEFORE the occlusion walk (one batched
    # connection_n*n connect_vertex call instead of connection_n slices) so
    # lanes that cannot contribute — zero BSDF/geometry/RMIS weight, empty
    # segment, invalid vertex, zero pmf — are masked OUT of the walk: their
    # tmax drops below tmin and the kernel's per-row pruning never visits a
    # cluster for them (visibility mask= contract).
    eye_all = _ConnEye(
        jax.tree_util.tree_map(lambda a: jnp.tile(a, (connection_n,) + (1,) * (a.ndim - 1)), mid),
        jnp.tile(eye_ratio, (connection_n, 1)))
    pmf1_all = jnp.concatenate([jnp.broadcast_to(d[1], (n,)) for d in draws])
    pmf2_all = jnp.concatenate([jnp.broadcast_to(d[2], (n,)) for d in draws])
    ok_seg_all = jnp.concatenate([jnp.broadcast_to(d[3], (n,)) for d in draws])
    # precomputed Gamma-gather eliminations (see connect_vertex_fused):
    # eye_parts once per eye vertex instead of per draw; weight_b from the
    # packed LVC column; the strategy weight from pmf1 (== Gamma(e,l) when
    # the first stage sampled the Gamma row)
    parts = rmis.tracing_weight_eye_parts(ts, ss, mid, mid.position)
    tile_n = lambda a: jnp.tile(a, (connection_n,))
    eye_parts = (tile_n(parts[0]), tile_n(parts[1]))
    pmf1_is_gamma = (not uniform) and ss.trained and ss.nn is None
    contrib_all = connect_vertex_fused(
        ts, ss, eye_all, lv_all,
        pmf1=pmf1_all if pmf1_is_gamma else None,
        eye_parts=eye_parts, weight_b=wb_all)
    pmf_all = sampler.path_count.astype(jnp.float32) * pmf1_all * pmf2_all
    can_contribute = (ok_seg_all & lv_all.valid & (pmf_all > 0.0)
                      & jnp.any(contrib_all != 0.0, axis=-1))
    if live is not None:
        # dead eye lanes (missed / emitter-hit / done): the caller zeroes
        # their result anyway — skip their occlusion rays too
        can_contribute = can_contribute & jnp.tile(live, (connection_n,))
    # the connection wavefront's directions are unrelated to the bounce
    # rays: a traversal that sorts (mode "tile") sorts it by its own key
    vis_all = visibility(ts, pos_all, target_all, SCENE_EPSILON, sort=None,
                         mask=can_contribute)
    ok_all = can_contribute & vis_all
    term = jnp.where(ok_all[..., None],
                     contrib_all / jnp.maximum(pmf_all, 1e-30)[..., None],
                     0.0)
    total = jnp.sum(term.reshape(connection_n, n, 3), axis=0)
    return total, state


class _ConnEye:
    """Eye vertex view exposing the cumulative flux/pdf ratio for
    connection eval."""

    def __init__(self, v: EyeVertices, ratio):
        self._v = v
        self.ratio = ratio

    def __getattr__(self, k):
        return getattr(self._v, k)

    def replace(self, **kw):
        return self


def render_frame(ts, ss, sampler, cam_uvw, width, height, subframe,
                 max_depth=SUBPATH_MAX_DEPTH, connection_n=CONNECTION_N,
                 uniform=False):
    eye, U, V, W = cam_uvw
    o, d, state = common.camera_rays(eye, U, V, W, width, height, subframe)
    return make_spcbpt_step(ts, ss, sampler, max_depth, connection_n,
                            uniform)(o, d, state)


@partial(jax.jit, static_argnames=("width", "height", "max_depth",
                                   "connection_n", "uniform"))
def render_frame_jit(ts, ss, sampler, eye, U, V, W, width, height, subframe,
                     max_depth=16, connection_n=CONNECTION_N, uniform=False):
    return render_frame(ts, ss, sampler, (eye, U, V, W), width, height,
                        subframe, max_depth, connection_n, uniform)
