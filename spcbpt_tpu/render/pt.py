"""Wavefront unidirectional path tracer with NEE + MIS (baseline algorithm).

Behavior contract from the reference's "pt" configuration (reference:
__raygen__pinhole raygen.cu:71-170, __closesthit__radiance
hit_program.cu:439-552, __closesthit__lightsource hit_program.cu:148-180,
__miss__constant_radiance raygen.cu:687-696):

per bounce: trace (back-face culled) -> if miss, env radiance only at depth 0
-> if emitter, one-sided emission with area-vs-bsdf MIS (weight 1 at depth 0)
-> else NEE to one uniformly picked light with the reciprocal MIS weight and a
deferred visibility ray, then RR (rate = clamp(max base_color, MIN_RR_RATE, 1))
and Disney BSDF bounce. 30-bounce cap.

Wavefront shape: all pixels advance together through a lax.scan over the depth cap
with an alive mask; the two traversal calls per bounce (closest + shadow) are
batched over the full wavefront.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import CULL_BACKFACE, MIN_RR_RATE, PT_MAX_DEPTH, SCENE_EPSILON
from ..ops import bsdf as bsdf_mod
from ..ops import lights as lights_mod
from ..scene import envmap as env_mod
from ..scene.scene import TraceScene, local_geometry, trace_any, trace_closest
from ..utils import rng as rng_mod
from ..utils import vec
from . import common


def _nee(ts: TraceScene, geom, v_dir, throughput, state, sort=None,
         mask=None):
    """Next-event estimation at a surface hit (hit_program.cu:462-525).
    Returns (contribution, state); contribution already includes the
    visibility test (the reference defers the shadow ray to raygen).
    sort=False skips the traversal-internal ray sort (for presorted pools).
    mask: lanes where False are not shadow-traced (dead-lane tmax
    convention); their contribution is zeroed."""
    ls, state = lights_mod.sample_light(ts, state)
    P = geom["P"]
    N = geom["Ns"]
    mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
    rr = bsdf_mod.rr_rate(geom["base_color"], MIN_RR_RATE)

    # quad branch
    to_l = ls.position - P
    l_dist = jnp.maximum(vec.length(to_l), 1e-8)
    L_q = to_l / l_dist[..., None]
    ln = ls.normal
    l_dot_ln = vec.dot(-L_q, ln)
    n_dot_l = vec.dot(N, L_q)
    n_dot_v = vec.dot(N, v_dir)
    ok_q = (n_dot_l > 0.0) & (n_dot_v > 0.0) & (l_dot_ln > 0.0) & ~ls.is_env
    f_q = bsdf_mod.eval_bsdf(mat, N, v_dir, L_q)
    pdf_hit = (bsdf_mod.pdf_bsdf(mat, N, v_dir, L_q)
               * jnp.abs(l_dot_ln) / jnp.maximum(l_dist * l_dist, 1e-12) * rr)
    mis_q = ls.pdf / jnp.maximum(pdf_hit + ls.pdf, 1e-30)
    contrib_q = (throughput * ls.emission / ls.pdf[..., None]
                 * (n_dot_l * l_dot_ln / (l_dist * l_dist) * mis_q)[..., None]
                 * f_q)
    contrib_q = jnp.where(ok_q[..., None], contrib_q, 0.0)
    target = ls.position

    if ts.has_env:
        # env branch (hit_program.cu:505-521): no MIS weight in the reference
        L_e = ls.direction
        l_dot_n = vec.dot(L_e, N)
        ok_e = (l_dot_n > 0.0) & ls.is_env
        f_e = bsdf_mod.eval_bsdf(mat, N, v_dir, L_e)
        contrib_e = (throughput * ls.emission / ls.pdf[..., None]
                     * l_dot_n[..., None] * f_e)
        contrib = jnp.where(ok_e[..., None], contrib_e, contrib_q)
        target = vec.where3(ls.is_env, P + L_e * (2.0 * ts.env.r), ls.position)
        ok = ok_q | ok_e
    else:
        contrib = contrib_q
        ok = ok_q

    # deferred visibility ray (raygen.cu:134-143); lanes that cannot
    # contribute (geometry-rejected or masked by the caller) drop their
    # tmax below tmin so the walk kernels skip them
    if mask is not None:
        ok = ok & mask
    seg = target - P
    seg_len = jnp.maximum(vec.length(seg), 1e-8)
    seg_dir = seg / seg_len[..., None]
    tmax_v = jnp.where(ok, seg_len - SCENE_EPSILON, -1.0)
    occluded = trace_any(ts, P, seg_dir,
                         jnp.full_like(seg_len, SCENE_EPSILON),
                         tmax_v, sort=sort)
    contrib = jnp.where((ok & ~occluded)[..., None], contrib, 0.0)
    return vec.scrub(contrib), state


def make_pt_step(ts: TraceScene, max_depth: int = PT_MAX_DEPTH):
    """Returns f(origins, dirs, rng_state) -> radiance (N, 3): one sample per
    lane of the full PT estimator."""

    def step(origins, dirs, state):
        n = origins.shape[0]
        carry = dict(
            o=origins, d=dirs, state=state,
            throughput=jnp.ones((n, 3)),
            result=jnp.zeros((n, 3)),
            bsdf_pdf=jnp.zeros((n,)),
            done=jnp.zeros((n,), bool),
            depth=jnp.zeros((n,), jnp.int32),
        )

        def body(c, _):
            live = ~c["done"]
            # done lanes keep their last (o, d): without masking they would
            # re-trace the same ray every remaining scan step (RR kills most
            # lanes well before the depth cap). A dead-lane tmax makes the
            # traversal skip them.
            hit = trace_closest(ts, c["o"], c["d"], SCENE_EPSILON,
                                jnp.where(live, 1e16, -1.0), CULL_BACKFACE)
            miss = ~hit.valid & live

            result = c["result"]
            if ts.has_env:
                # env radiance only for primary rays (raygen.cu:691-695)
                env_rad = c["throughput"] * env_mod.env_color(ts.env, c["d"])
                add = jnp.where((miss & (c["depth"] == 0))[..., None], env_rad, 0.0)
                result = result + vec.scrub(add)

            geom = local_geometry(ts, hit, c["o"], c["d"])
            hit_light = hit.valid & (geom["light_id"] >= 0) & live
            hit_surface = hit.valid & (geom["light_id"] < 0) & live

            # --- emitter hit (hit_program.cu:148-180) ---
            lid = jnp.maximum(geom["light_id"], 0)
            ls_rev = lights_mod.reverse_sample_quad(ts, lid, geom["uv"])
            front = vec.dot(c["d"], ls_rev.normal) <= 0.0
            pdf_hit = (c["bsdf_pdf"] * jnp.abs(vec.dot(c["d"], ls_rev.normal))
                       / jnp.maximum(hit.t * hit.t, 1e-12))
            mis = jnp.where(c["depth"] == 0, 1.0,
                            pdf_hit / jnp.maximum(ls_rev.pdf + pdf_hit, 1e-30))
            emit = c["throughput"] * ls_rev.emission * mis[..., None]
            add = jnp.where((hit_light & front)[..., None], emit, 0.0)
            result = result + vec.scrub(add)

            # --- surface: NEE (shadow rays only for live surface lanes) ---
            v_dir = -c["d"]
            nee, state2 = _nee(ts, geom, v_dir, c["throughput"], c["state"],
                               mask=hit_surface)
            result = result + jnp.where(hit_surface[..., None], nee, 0.0)

            # --- RR + BSDF bounce (hit_program.cu:527-551) ---
            rr = bsdf_mod.rr_rate(geom["base_color"], MIN_RR_RATE)
            r, state2 = rng_mod.next_float(state2)
            kill = r > rr
            mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
            new_d, state2 = bsdf_mod.sample_bsdf(mat, geom["Ns"], v_dir, state2)
            pdf = bsdf_mod.pdf_bsdf(mat, geom["Ns"], v_dir, new_d)
            f = bsdf_mod.eval_bsdf(mat, geom["Ns"], v_dir, new_d)
            cos = jnp.abs(vec.dot(new_d, geom["Ns"]))
            ratio = f * (cos / jnp.maximum(pdf, 1e-20) / rr)[..., None]
            cont = hit_surface & ~kill & (pdf > 0.0)
            throughput = jnp.where(cont[..., None],
                                   c["throughput"] * ratio, c["throughput"])

            depth = c["depth"] + jnp.where(live, 1, 0)
            done = c["done"] | miss | hit_light | (hit_surface & ~cont) \
                | (depth > max_depth)
            return dict(
                o=vec.where3(cont, geom["P"], c["o"]),
                d=vec.where3(cont, new_d, c["d"]),
                state=state2,
                throughput=throughput,
                result=result,
                bsdf_pdf=jnp.where(cont, pdf * rr, c["bsdf_pdf"]),
                done=done,
                depth=depth,
            ), None

        c, _ = jax.lax.scan(body, carry, None, length=max_depth + 1)
        return c["result"]

    return step


def render_frame(ts: TraceScene, cam_uvw, width: int, height: int,
                 subframe, max_depth: int = PT_MAX_DEPTH):
    """One progressive PT sample for every pixel. Returns (W*H, 3)."""
    eye, U, V, W = cam_uvw
    o, d, state = common.camera_rays(eye, U, V, W, width, height, subframe)
    return make_pt_step(ts, max_depth)(o, d, state)


@partial(jax.jit, static_argnames=("width", "height", "max_depth"))
def render_frame_jit(ts, eye, U, V, W, width, height, subframe,
                     max_depth=PT_MAX_DEPTH):
    return render_frame(ts, (eye, U, V, W), width, height, subframe, max_depth)
