"""Path-regeneration wavefront PT: the throughput variant of render/pt.py.

The naive wavefront scans a fixed depth cap with alive masks, so lanes killed
by Russian roulette (expected path length ~4 on Cornell) waste ~85% of every
iteration. Here a fixed pool of lanes runs a while_loop: whenever a lane
terminates, its result scatter-adds into the film and the lane immediately
restarts on the next camera sample from a global counter. Utilization stays
~100% independent of path-length distribution — same estimator, same per-pixel
sample counts (film tracks sums and counts).

Estimator semantics per bounce are identical to render/pt.py (reference
__raygen__pinhole / __closesthit__radiance contract).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import CULL_BACKFACE, MIN_RR_RATE, PT_MAX_DEPTH, SCENE_EPSILON
from ..ops import bsdf as bsdf_mod
from ..scene import envmap as env_mod
from ..scene.scene import TraceScene, local_geometry, trace_closest
from ..utils import rng as rng_mod
from ..utils import vec
from .pt import _nee
from ..ops import lights as lights_mod


def render_pool(ts: TraceScene, cam_uvw, width: int, height: int,
                spp: int, subframe0=0, n_pool: int = 1 << 17,
                max_depth: int = PT_MAX_DEPTH):
    """Render `spp` samples/pixel; returns (film_sum (W*H,3), counts (W*H,)).

    Per-sample rng matches render_frame: sample rep r of pixel p uses
    seed(p, subframe0 + r)."""
    eye, U, V, W = [jnp.asarray(x, jnp.float32) for x in cam_uvw]
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
        return jnp.broadcast_to(eye, d.shape), d, state

    def init_state():
        lane = jnp.arange(n_pool, dtype=jnp.int32)
        pixel = lane % n_pixels
        rep = lane // n_pixels
        o, d, state = camera_ray(pixel, rep)
        return dict(
            o=o, d=d, state=state,
            pixel=pixel,
            throughput=jnp.ones((n_pool, 3)),
            result=jnp.zeros((n_pool, 3)),
            bsdf_pdf=jnp.zeros((n_pool,)),
            depth=jnp.zeros((n_pool, ), jnp.int32),
            alive=jnp.ones((n_pool,), bool),
            next_sample=jnp.asarray(n_pool, jnp.int32),
            film=jnp.zeros((n_pixels, 3)),
            count=jnp.zeros((n_pixels,), jnp.int32),
        )

    # no presort of the lane state: permuting it every bounce would be pure
    # memory traffic

    def cond(c):
        return jnp.any(c["alive"]) | (c["next_sample"] < total)

    def body(c):
        live = c["alive"]
        # pool-exhausted (~alive) lanes: dead-lane tmax skips their traversal
        hit = trace_closest(ts, c["o"], c["d"], SCENE_EPSILON,
                            jnp.where(live, 1e16, -1.0), CULL_BACKFACE)
        miss = ~hit.valid & live
        geom = local_geometry(ts, hit, c["o"], c["d"])
        hit_light = hit.valid & (geom["light_id"] >= 0) & live
        hit_surf = hit.valid & (geom["light_id"] < 0) & live

        result = c["result"]
        if ts.has_env:
            env_rad = c["throughput"] * env_mod.env_color(ts.env, c["d"])
            result = result + vec.scrub(jnp.where(
                (miss & (c["depth"] == 0))[..., None], env_rad, 0.0))

        lid = jnp.maximum(geom["light_id"], 0)
        ls_rev = lights_mod.reverse_sample_quad(ts, lid, geom["uv"])
        front = vec.dot(c["d"], ls_rev.normal) <= 0.0
        pdf_hit = (c["bsdf_pdf"] * jnp.abs(vec.dot(c["d"], ls_rev.normal))
                   / jnp.maximum(hit.t * hit.t, 1e-12))
        mis = jnp.where(c["depth"] == 0, 1.0,
                        pdf_hit / jnp.maximum(ls_rev.pdf + pdf_hit, 1e-30))
        emit = c["throughput"] * ls_rev.emission * mis[..., None]
        result = result + vec.scrub(jnp.where((hit_light & front)[..., None],
                                              emit, 0.0))

        v_dir = -c["d"]
        nee, state2 = _nee(ts, geom, v_dir, c["throughput"], c["state"],
                           mask=hit_surf)
        result = result + jnp.where(hit_surf[..., None], nee, 0.0)

        rr = bsdf_mod.rr_rate(geom["base_color"], MIN_RR_RATE)
        r, state2 = rng_mod.next_float(state2)
        kill = r > rr
        mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
        new_d, state2 = bsdf_mod.sample_bsdf(mat, geom["Ns"], v_dir, state2)
        pdf = bsdf_mod.pdf_bsdf(mat, geom["Ns"], v_dir, new_d)
        f = bsdf_mod.eval_bsdf(mat, geom["Ns"], v_dir, new_d)
        cos = jnp.abs(vec.dot(new_d, geom["Ns"]))
        ratio = f * (cos / jnp.maximum(pdf, 1e-20) / rr)[..., None]
        cont = hit_surf & ~kill & (pdf > 0.0)

        depth = c["depth"] + 1
        terminated = live & (miss | hit_light | (hit_surf & ~cont)
                             | (depth > max_depth))
        still = live & ~terminated

        # flush finished samples into the film
        film = c["film"].at[c["pixel"]].add(
            jnp.where(terminated[..., None], result, 0.0))
        count = c["count"].at[c["pixel"]].add(
            jnp.where(terminated, 1, 0))

        # regenerate dead lanes from the global sample counter
        want = terminated | ~live
        rank = jnp.cumsum(want.astype(jnp.int32)) - 1
        sid = c["next_sample"] + rank
        take = want & (sid < total)
        n_taken = jnp.sum(take.astype(jnp.int32))
        new_pixel = sid % n_pixels
        new_rep = sid // n_pixels
        o_new, d_new, st_new = camera_ray(new_pixel, new_rep)

        sel3 = lambda m, a, b: jnp.where(m[..., None], a, b)
        o = sel3(cont, geom["P"], c["o"])
        d = sel3(cont, new_d, c["d"])
        throughput = sel3(cont, c["throughput"] * ratio, c["throughput"])
        bsdf_pdf = jnp.where(cont, pdf * rr, c["bsdf_pdf"])

        return dict(
            o=sel3(take, o_new, o),
            d=sel3(take, d_new, d),
            state=jnp.where(take, st_new, state2),
            pixel=jnp.where(take, new_pixel, c["pixel"]),
            throughput=sel3(take, jnp.ones((n_pool, 3)), throughput),
            result=sel3(take | terminated, jnp.zeros((n_pool, 3)), result),
            bsdf_pdf=jnp.where(take, 0.0, bsdf_pdf),
            depth=jnp.where(take, 0, depth),
            alive=(still | take),
            next_sample=c["next_sample"] + n_taken,
            film=film,
            count=count,
        )

    c = jax.lax.while_loop(cond, body, init_state())
    return c["film"], c["count"]


@partial(jax.jit, static_argnames=("width", "height", "spp", "n_pool",
                                   "max_depth"))
def render_pool_jit(ts, eye, U, V, W, width, height, spp, subframe0=0,
                    n_pool=1 << 17, max_depth=PT_MAX_DEPTH):
    return render_pool(ts, (eye, U, V, W), width, height, spp, subframe0,
                       n_pool, max_depth)


def render_waves(ts: TraceScene, cam_uvw, width: int, height: int,
                 spp: int, subframe0=0, max_depth: int = PT_MAX_DEPTH):
    """Scatter-free variant: one lane per pixel, each lane renders its spp
    samples sequentially (regeneration restarts the SAME pixel on the next
    sample). The film is just the per-lane accumulator — no scatter-add per
    iteration — at the cost of tail idling when a pixel's last path outlives
    its neighbors'. Returns (film_sum (W*H, 3), counts (W*H,))."""
    eye, U, V, W = [jnp.asarray(x, jnp.float32) for x in cam_uvw]
    n_pixels = width * height
    pixel = jnp.arange(n_pixels, dtype=jnp.int32)

    def camera_ray(rep):
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
        return jnp.broadcast_to(eye, d.shape), d, state

    def init_state():
        o, d, state = camera_ray(jnp.zeros((n_pixels,), jnp.int32))
        return dict(
            o=o, d=d, state=state,
            throughput=jnp.ones((n_pixels, 3)),
            result=jnp.zeros((n_pixels, 3)),
            bsdf_pdf=jnp.zeros((n_pixels,)),
            depth=jnp.zeros((n_pixels,), jnp.int32),
            rep=jnp.zeros((n_pixels,), jnp.int32),
            alive=jnp.ones((n_pixels,), bool),
            film=jnp.zeros((n_pixels, 3)),
        )

    def cond(c):
        return jnp.any(c["alive"])

    def body(c):
        live = c["alive"]
        hit = trace_closest(ts, c["o"], c["d"], SCENE_EPSILON,
                            jnp.where(live, 1e16, -1.0), CULL_BACKFACE)
        miss = ~hit.valid & live
        geom = local_geometry(ts, hit, c["o"], c["d"])
        hit_light = hit.valid & (geom["light_id"] >= 0) & live
        hit_surf = hit.valid & (geom["light_id"] < 0) & live

        result = c["result"]
        if ts.has_env:
            env_rad = c["throughput"] * env_mod.env_color(ts.env, c["d"])
            result = result + vec.scrub(jnp.where(
                (miss & (c["depth"] == 0))[..., None], env_rad, 0.0))

        lid = jnp.maximum(geom["light_id"], 0)
        ls_rev = lights_mod.reverse_sample_quad(ts, lid, geom["uv"])
        front = vec.dot(c["d"], ls_rev.normal) <= 0.0
        pdf_hit = (c["bsdf_pdf"] * jnp.abs(vec.dot(c["d"], ls_rev.normal))
                   / jnp.maximum(hit.t * hit.t, 1e-12))
        mis = jnp.where(c["depth"] == 0, 1.0,
                        pdf_hit / jnp.maximum(ls_rev.pdf + pdf_hit, 1e-30))
        emit = c["throughput"] * ls_rev.emission * mis[..., None]
        result = result + vec.scrub(jnp.where((hit_light & front)[..., None],
                                              emit, 0.0))

        v_dir = -c["d"]
        nee, state2 = _nee(ts, geom, v_dir, c["throughput"], c["state"],
                           mask=hit_surf)
        result = result + jnp.where(hit_surf[..., None], nee, 0.0)

        rr = bsdf_mod.rr_rate(geom["base_color"], MIN_RR_RATE)
        r, state2 = rng_mod.next_float(state2)
        kill = r > rr
        mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
        new_d, state2 = bsdf_mod.sample_bsdf(mat, geom["Ns"], v_dir, state2)
        pdf = bsdf_mod.pdf_bsdf(mat, geom["Ns"], v_dir, new_d)
        f = bsdf_mod.eval_bsdf(mat, geom["Ns"], v_dir, new_d)
        cos = jnp.abs(vec.dot(new_d, geom["Ns"]))
        ratio = f * (cos / jnp.maximum(pdf, 1e-20) / rr)[..., None]
        cont = hit_surf & ~kill & (pdf > 0.0)

        depth = c["depth"] + 1
        terminated = live & (miss | hit_light | (hit_surf & ~cont)
                             | (depth > max_depth))

        film = c["film"] + jnp.where(terminated[..., None], result, 0.0)
        rep = c["rep"] + jnp.where(terminated, 1, 0)
        restart = terminated & (rep < spp)
        o_new, d_new, st_new = camera_ray(rep)

        sel3 = lambda m, a, b: jnp.where(m[..., None], a, b)
        o = sel3(cont, geom["P"], c["o"])
        d = sel3(cont, new_d, c["d"])
        throughput = sel3(cont, c["throughput"] * ratio, c["throughput"])
        bsdf_pdf = jnp.where(cont, pdf * rr, c["bsdf_pdf"])

        return dict(
            o=sel3(restart, o_new, o),
            d=sel3(restart, d_new, d),
            state=jnp.where(restart, st_new, state2),
            throughput=sel3(restart, jnp.ones((n_pixels, 3)), throughput),
            result=sel3(restart | terminated, jnp.zeros((n_pixels, 3)), result),
            bsdf_pdf=jnp.where(restart, 0.0, bsdf_pdf),
            depth=jnp.where(restart, 0, depth),
            rep=rep,
            alive=(live & ~terminated) | restart,
            film=film,
        )

    c = jax.lax.while_loop(cond, body, init_state())
    return c["film"], jnp.full((n_pixels,), spp, jnp.int32)


@partial(jax.jit, static_argnames=("width", "height", "spp", "max_depth"))
def render_waves_jit(ts, eye, U, V, W, width, height, spp, subframe0=0,
                     max_depth=PT_MAX_DEPTH):
    return render_waves(ts, (eye, U, V, W), width, height, spp, subframe0,
                        max_depth)
