"""Path-regeneration SPCBPT/BDPT eye renderer (pool variant of
render/spcbpt.py — same estimator, ~full lane utilization).

One LVC sampler (one frame of light sub-paths) serves all samples of the
call; the reference refreshes the LVC every progressive frame, so callers
should use spp=1 per sampler for strict parity, or more for extra speed at
slightly correlated light paths.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import CONNECTION_N, CULL_BACKFACE, MIN_RR_RATE, SCENE_EPSILON
from ..ops import bsdf as bsdf_mod
from ..ops import lights as lights_mod
from ..scene.scene import TraceScene, local_geometry, trace_closest
from ..train import classify
from ..utils import rng as rng_mod
from ..utils import vec
from . import rmis
from .lvc import LVCSampler
from .rmis import EyeVertices
from .spcbpt import _connections, _init_eye_vertices


def render_pool(ts: TraceScene, ss: classify.SubspaceState,
                sampler: LVCSampler, cam_uvw, width: int, height: int,
                spp: int, subframe0=0, n_pool: int = 1 << 16,
                max_depth: int = 16, connection_n: int = CONNECTION_N,
                uniform: bool = False, second_stage=None):
    """Returns (film_sum (W*H, 3), counts (W*H,))."""
    eye_p, U, V, W = [jnp.asarray(x, jnp.float32) for x in cam_uvw]
    n_pixels = width * height
    total = n_pixels * spp
    n_pool = min(n_pool, total)

    def camera_ray(pixel, rep):
        state = rng_mod.seed(pixel.astype(jnp.uint32),
                             jnp.asarray(subframe0, jnp.uint32)
                             + rep.astype(jnp.uint32))
        jx, state = rng_mod.next_float(state)
        jy, state = rng_mod.next_float(state)
        first = (jnp.asarray(subframe0, jnp.int32) + rep) == 0
        jx = jnp.where(first, 0.5, jx)
        jy = jnp.where(first, 0.5, jy)
        x = (pixel % width).astype(jnp.float32)
        y = (pixel // width).astype(jnp.float32)
        dx = 2.0 * (x + jx) / width - 1.0
        dy = 2.0 * (y + jy) / height - 1.0
        d = dx[:, None] * U + dy[:, None] * V + W
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return jnp.broadcast_to(eye_p, d.shape), d, state

    def fresh_lane_state(pixel, rep):
        o, d, state = camera_ray(pixel, rep)
        n = pixel.shape[0]
        return dict(o=o, d=d, state=state, v=_init_eye_vertices(o, d),
                    ratio=jnp.ones((n, 3)),
                    pending_f=jnp.ones((n, 3)),
                    pending_single=jnp.ones((n,)),
                    result=jnp.zeros((n, 3)),
                    depth=jnp.zeros((n,), jnp.int32))

    def init_state():
        lane = jnp.arange(n_pool, dtype=jnp.int32)
        pixel = lane % n_pixels
        rep = lane // n_pixels
        c = fresh_lane_state(pixel, rep)
        c.update(pixel=pixel,
                 alive=jnp.ones((n_pool,), bool),
                 next_sample=jnp.asarray(n_pool, jnp.int32),
                 film=jnp.zeros((n_pixels, 3)),
                 count=jnp.zeros((n_pixels,), jnp.int32))
        return c

    # no presort of the 20+-array lane state (EyeVertices included):
    # permuting it every bounce would be pure memory traffic, and pool lanes
    # are almost always live, so packing dead lanes buys nothing.

    def cond(c):
        return jnp.any(c["alive"]) | (c["next_sample"] < total)

    def body(c):
        last = c["v"]
        live = c["alive"]
        # pool-exhausted (~alive) lanes: dead-lane tmax skips their traversal
        hit = trace_closest(ts, c["o"], c["d"], SCENE_EPSILON,
                            jnp.where(live, 1e16, -1.0), CULL_BACKFACE)
        geom = local_geometry(ts, hit, c["o"], c["d"])
        miss = ~hit.valid & live
        hit_light = hit.valid & (geom["light_id"] >= 0) & live
        hit_surf = hit.valid & (geom["light_id"] < 0) & live

        d = c["d"]
        cos_mid_l = jnp.abs(vec.dot(geom["Ns"], d))
        cos_last = jnp.abs(vec.dot(last.normal, d))
        inv_t2 = 1.0 / jnp.maximum(hit.t * hit.t, 1e-20)

        # RMIS recursion update for the next vertex — computed FIRST so the
        # emitter-hit / env-escape weights below reuse its products
        # (rmis.light_hit_cached). in_dir=d: exact for miss lanes too.
        rmis3_new, rmis_u_new = rmis.tracing_update_eye(
            ts, ss, last, geom["P"], jnp.zeros_like(hit.valid), in_dir=d)

        # emitter hit (hit_program.cu:62-147); cumulative flux/pdf carried
        # as their unit-invariant ratio (see LightVertices)
        lid = jnp.maximum(geom["light_id"], 0)
        ls_rev = lights_mod.reverse_sample_quad(ts, lid, geom["uv"])
        front = vec.dot(d, ls_rev.normal) <= 0.0
        # depth>=2: the pending BSDF factor from the previous bounce folds in
        # here (hit_program.cu:99-106 multiplies MidVertex.flux,
        # pre-seeded with Eval at the previous hit, into the product)
        step = (cos_last / jnp.maximum(c["pending_single"], 1e-30))[..., None]
        ratio_l = jnp.where((last.depth == 0)[..., None],
                            c["ratio"],
                            c["pending_f"] * c["ratio"]) \
            * (step * ls_rev.emission)
        direct = c["depth"] == 0
        w_hit = rmis.light_hit_cached(
            ss, last, rmis3_new, rmis_u_new, d, cos_last, inv_t2,
            c["pending_single"], ls_rev.normal, ls_rev.emission,
            ls_rev.pdf, ls_rev.subspace_id)
        w_hit = jnp.where(direct, 1.0, w_hit)
        emit = ratio_l * w_hit[..., None]
        result = c["result"] + jnp.where((hit_light & front)[..., None],
                                         vec.scrub(emit), 0.0)

        # env escape with MIS vs env-LVC connections (render/spcbpt.py)
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
                miss[..., None], vec.scrub(ratio_env * w_env[..., None]), 0.0)

        # new eye vertex
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

        if connection_n > 0:
            conn_total, state2 = _connections(
                ts, ss, sampler, mid, ratio_mid, c["state"],
                connection_n, uniform, second_stage, live=hit_surf)
            result = result + jnp.where(hit_surf[..., None],
                                        conn_total / connection_n, 0.0)
        else:
            state2 = c["state"]

        # RR + bounce
        v_dir = -d
        mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
        new_d, state2 = bsdf_mod.sample_bsdf(mat, geom["Ns"], v_dir, state2)
        bpdf = bsdf_mod.pdf_bsdf(mat, geom["Ns"], v_dir, new_d)
        f = bsdf_mod.eval_bsdf(mat, geom["Ns"], v_dir, new_d)
        rr = bsdf_mod.rr_rate(geom["base_color"], MIN_RR_RATE)
        r, state2 = rng_mod.next_float(state2)
        cont = hit_surf & (r <= rr) & (bpdf > 0.0)

        depth = c["depth"] + 1
        terminated = live & (miss | hit_light | (hit_surf & ~cont)
                             | (depth > max_depth))
        still = live & ~terminated

        film = c["film"].at[c["pixel"]].add(
            jnp.where(terminated[..., None], result, 0.0))
        count = c["count"].at[c["pixel"]].add(jnp.where(terminated, 1, 0))

        want = terminated | ~live
        rank = jnp.cumsum(want.astype(jnp.int32)) - 1
        sid = c["next_sample"] + rank
        take = want & (sid < total)
        n_taken = jnp.sum(take.astype(jnp.int32))
        new_pixel = sid % n_pixels
        new_rep = sid // n_pixels
        fresh = fresh_lane_state(new_pixel, new_rep)

        keep_v = hit_surf

        def selv(new, old):
            return jnp.where(
                keep_v.reshape(keep_v.shape + (1,) * (new.ndim - 1)), new, old)

        def taker(new, old):
            return jnp.where(
                take.reshape(take.shape + (1,) * (new.ndim - 1)), new, old)

        v_next = jax.tree_util.tree_map(selv, mid, last)
        v_next = jax.tree_util.tree_map(taker, fresh["v"], v_next)

        return dict(
            o=taker(fresh["o"], vec.where3(cont, geom["P"], c["o"])),
            d=taker(fresh["d"], vec.where3(cont, new_d, c["d"])),
            state=jnp.where(take, fresh["state"], state2),
            v=v_next,
            ratio=taker(fresh["ratio"], selv(ratio_mid, c["ratio"])),
            pending_f=taker(fresh["pending_f"],
                            vec.where3(cont, f, c["pending_f"])),
            pending_single=jnp.where(take, 1.0,
                                     jnp.where(cont, bpdf * rr,
                                               c["pending_single"])),
            result=taker(jnp.zeros_like(result),
                         jnp.where(terminated[..., None],
                                   jnp.zeros_like(result), result)),
            depth=jnp.where(take, 0, depth),
            pixel=jnp.where(take, new_pixel, c["pixel"]),
            alive=still | take,
            next_sample=c["next_sample"] + n_taken,
            film=film,
            count=count,
        )

    c = jax.lax.while_loop(cond, body, init_state())
    return c["film"], c["count"]


@partial(jax.jit, static_argnames=("width", "height", "spp", "n_pool",
                                   "max_depth", "connection_n", "uniform",
                                   "second_stage"))
def render_pool_jit(ts, ss, sampler, eye, U, V, W, width, height, spp,
                    subframe0=0, n_pool=1 << 16, max_depth=16,
                    connection_n=CONNECTION_N, uniform=False,
                    second_stage=None):
    return render_pool(ts, ss, sampler, (eye, U, V, W), width, height, spp,
                       subframe0, n_pool, max_depth, connection_n, uniform,
                       second_stage)
