"""Training-data tracer: NEE path tracer that records, per sampled path, its
contribution/pdf and a connection record for every prefix-suffix split.

Behavior contract (reference: __raygen__TrainData raygen.cu:751-868,
PreTrace_buildPathInfo raygen.cu:708-739, nVertex/nVertex_device
optixPathTracer.h:264-385 + cuProg.h:1128-1292): each lane traces one eye path
per launch; at every vertex it samples one light (NEE) and, if visible,
reservoir-accepts the completed path with probability 1/(n+1); hitting an
emitter likewise completes a path. An accepted path replaces the lane's stored
record: contribution, sample_pdf (BSDF-strategy pdf + NEE pdf; divided at the
end by the number of resample candidates), fix_pdf, and one connection node
per split with peak_pdf = eye_prefix_pdf * light_suffix_contribution.

Wavefront shape: fixed (n_core,) lanes; eye prefix vertices live in per-lane buffers
of `padding` slots; the backward light-side walk of PreTrace_buildPathInfo is
a masked unrolled loop over the buffer.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import (CULL_BACKFACE, MIN_RR_RATE, PRETRACE_CONN_PADDING,
                      SCENE_EPSILON)
from ..ops import bsdf as bsdf_mod
from ..ops import lights as lights_mod
from ..scene.scene import TraceScene, local_geometry, trace_closest, visibility
from ..utils import rng as rng_mod
from ..utils import vec


class PretraceBatch(NamedTuple):
    """One launch worth of pathInfo_sample + padded pathInfo_node records
    (optixPathTracer.h:316-364)."""
    contri: jnp.ndarray       # (P, 3)
    sample_pdf: jnp.ndarray   # (P,)
    fix_pdf: jnp.ndarray      # (P,)
    n_conns: jnp.ndarray      # (P,) int32
    pixel: jnp.ndarray        # (P, 2) int32
    valid: jnp.ndarray        # (P,) bool
    a_position: jnp.ndarray   # (P, C, 3) eye-side split vertex
    a_normal: jnp.ndarray     # (P, C, 3)
    a_dir: jnp.ndarray        # (P, C, 3)
    b_position: jnp.ndarray   # (P, C, 3) light-side aggregate vertex
    b_normal: jnp.ndarray     # (P, C, 3)
    b_dir: jnp.ndarray        # (P, C, 3)
    peak_pdf: jnp.ndarray     # (P, C)
    label_a: jnp.ndarray      # (P, C) int32 (filled after tree build)
    label_b: jnp.ndarray      # (P, C) int32 (light-source bins pre-filled)
    light_source: jnp.ndarray  # (P, C) bool
    conn_valid: jnp.ndarray   # (P, C) bool


def _pdf_rr(ts, mat_id, color, normal, in_dir, out_dir):
    mat = bsdf_mod.gather_mat(ts.mats, jnp.maximum(mat_id, 0), color)
    pdf = bsdf_mod.pdf_bsdf(mat, normal, in_dir, out_dir)
    rr = jnp.maximum(jnp.max(color, axis=-1), MIN_RR_RATE)
    return pdf * rr


def _eval_at(ts, mat_id, color, normal, in_dir, out_dir):
    mat = bsdf_mod.gather_mat(ts.mats, jnp.maximum(mat_id, 0), color)
    return bsdf_mod.eval_bsdf(mat, normal, in_dir, out_dir)


def _build_path_info(ts: TraceScene, buf, k, light):
    """PreTrace_buildPathInfo (raygen.cu:708-739), vectorized over lanes.

    buf: dict of (N, C[, 3]) eye-vertex buffers (slot 0 = camera vertex;
      fields: position, normal, dir (toward previous), color, mat_id, flux,
      pdf, depth);
    k: (N,) number of filled eye slots; the path connects at slot k-1;
    light: dict light-source nVertex: position, normal, weight (3,) emission,
      pdf, label, is_dir.
    Returns (path dict, conn dict of (N, C, ...) arrays)."""
    n, cpad = buf["position"].shape[:2]
    lanes = jnp.arange(n)

    def slot(name, i):
        return buf[name][lanes, i]

    ke = jnp.maximum(k - 1, 0)
    eye_pos = slot("position", ke)
    eye_norm = slot("normal", ke)
    eye_dirv = slot("dir", ke)
    eye_color = slot("color", ke)
    eye_mat = slot("mat_id", ke)
    eye_pdf = slot("pdf", ke)
    eye_flux = slot("flux", ke)

    # n_eye.forward_eye(light): BSDF-strategy pdf of generating the light
    # vertex from the eye vertex (cuProg.h:1221-1242)
    vecl = light["position"] - eye_pos
    c_dir = jnp.where(light["is_dir"][..., None], -light["normal"],
                      vec.normalize(vecl))
    g_e = (jnp.abs(vec.dot(c_dir, light["normal"]))
           / jnp.maximum(vec.dot(vecl, vecl), 1e-20))
    d_pdf = _pdf_rr(ts, eye_mat, eye_color, eye_norm, eye_dirv, c_dir)
    fwd_eye_pdf = eye_pdf * d_pdf * jnp.where(light["is_dir"], 1.0, g_e)

    seg_contri = _eval_at(ts, eye_mat, eye_color, eye_norm, eye_dirv, c_dir)

    # light.forward_light(n_eye) (cuProg.h:1244-1258): this = light source
    cdir_le = -c_dir  # light -> eye (abs() makes the sign immaterial)
    g_area = (jnp.abs(vec.dot(cdir_le, eye_norm))
              * jnp.abs(vec.dot(cdir_le, light["normal"]))
              / jnp.maximum(vec.dot(vecl, vecl), 1e-20))
    fwd_light = light["weight"] * jnp.where(
        light["is_dir"], jnp.abs(vec.dot(light["normal"], eye_norm)),
        g_area)[..., None]

    path = dict(
        contri=eye_flux * fwd_light * seg_contri,
        sample_pdf=fwd_eye_pdf + eye_pdf * light["pdf"],
        fix_pdf=fwd_eye_pdf,
        n_conns=jnp.maximum(k - 1, 0),
    )

    # --- backward walk creating one conn per split (raygen.cu:726-733) ---
    conn = dict(
        a_position=jnp.zeros((n, cpad, 3)), a_normal=jnp.zeros((n, cpad, 3)),
        a_dir=jnp.zeros((n, cpad, 3)), b_position=jnp.zeros((n, cpad, 3)),
        b_normal=jnp.zeros((n, cpad, 3)), b_dir=jnp.zeros((n, cpad, 3)),
        peak_pdf=jnp.zeros((n, cpad)),
        label_a=jnp.zeros((n, cpad), jnp.int32),
        label_b=jnp.zeros((n, cpad), jnp.int32),
        light_source=jnp.zeros((n, cpad), bool),
        conn_valid=jnp.zeros((n, cpad), bool),
    )

    # current light-side aggregate vertex ("this" of forward_light)
    b = dict(pos=light["position"], norm=light["normal"],
             dir=jnp.zeros((n, 3)), weight=light["weight"],
             pdf=light["pdf"], is_src=jnp.ones((n,), bool),
             is_dir=light["is_dir"], label=light["label"],
             mat=jnp.full((n,), -1, jnp.int32), color=jnp.ones((n, 3)))

    end_ind = path["n_conns"]
    for step in range(cpad - 1):
        ei = jnp.maximum(k - 1 - step, 0)     # eye slot of this split's A
        a_pos = slot("position", ei)
        a_norm = slot("normal", ei)
        a_dirv = slot("dir", ei)
        a_color = slot("color", ei)
        a_mat = slot("mat_id", ei)
        a_pdfw = slot("pdf", ei)
        a_depth = slot("depth", ei)

        do = step < end_ind
        widx = jnp.maximum(end_ind - 1 - step, 0)

        peak = a_pdfw * vec.float3weight(b["weight"])
        writes = dict(a_position=a_pos, a_normal=a_norm, a_dir=a_dirv,
                      b_position=b["pos"], b_normal=b["norm"], b_dir=b["dir"],
                      peak_pdf=peak, label_a=a_depth, label_b=b["label"],
                      light_source=b["is_src"], conn_valid=do)
        for name, val in writes.items():
            cur = conn[name]
            old = cur[lanes, widx]
            msk = do if cur.ndim == 2 else do[:, None]
            conn[name] = cur.at[lanes, widx].set(jnp.where(msk, val, old))

        # b' = nVertex_device(a, b, eye_side=False) (cuProg.h:1130-1147):
        # sits at a, dir points back to old b, weight/pdf via b.forward_*(a)
        vec_ba = a_pos - b["pos"]
        cdir = jnp.where(b["is_dir"][..., None], -b["norm"],
                         vec.normalize(vec_ba))  # b -> a
        g_gen = (jnp.abs(vec.dot(cdir, a_norm)) * jnp.abs(vec.dot(cdir, b["norm"]))
                 / jnp.maximum(vec.dot(vec_ba, vec_ba), 1e-20))
        f_b = _eval_at(ts, b["mat"], b["color"], b["norm"], b["dir"], cdir)
        w_general = b["weight"] * f_b * g_gen[..., None]
        w_area = b["weight"] * g_gen[..., None]
        w_dir = b["weight"] * jnp.abs(vec.dot(b["norm"], a_norm))[..., None]
        new_weight = jnp.where(
            b["is_src"][..., None],
            jnp.where(b["is_dir"][..., None], w_dir, w_area), w_general)

        g_pdf = (jnp.abs(vec.dot(cdir, a_norm))
                 / jnp.maximum(vec.dot(vec_ba, vec_ba), 1e-20))
        pdf_area = b["pdf"] * g_pdf * jnp.abs(vec.dot(b["norm"], cdir)) / jnp.pi
        if ts.has_env:
            from ..scene import envmap as env_mod
            pdf_dirl = (b["pdf"] * jnp.abs(vec.dot(cdir, a_norm))
                        * env_mod.env_project_pdf(ts.env))
        else:
            pdf_dirl = pdf_area
        d_pdf_b = _pdf_rr(ts, b["mat"], b["color"], b["norm"], b["dir"], cdir)
        pdf_general = b["pdf"] * d_pdf_b * g_pdf
        new_pdf = jnp.where(b["is_src"],
                            jnp.where(b["is_dir"], pdf_dirl, pdf_area),
                            pdf_general)

        sel3 = lambda nw, od: jnp.where(do[..., None], nw, od)
        sel = lambda nw, od: jnp.where(do, nw, od)
        b = dict(pos=sel3(a_pos, b["pos"]), norm=sel3(a_norm, b["norm"]),
                 dir=sel3(-cdir, b["dir"]),     # new vertex's dir -> old b
                 weight=sel3(new_weight, b["weight"]),
                 pdf=sel(new_pdf, b["pdf"]),
                 is_src=sel(jnp.zeros_like(do), b["is_src"]),
                 is_dir=sel(jnp.zeros_like(do), b["is_dir"]),
                 label=sel(jnp.zeros_like(b["label"]), b["label"]),
                 mat=sel(a_mat, b["mat"]), color=sel3(a_color, b["color"]))

    return path, conn


def make_pretracer(cam_uvw, n_core: int,
                   padding: int = PRETRACE_CONN_PADDING,
                   max_depth: int | None = None):
    """Returns jit-able f(ts, frame) -> PretraceBatch.

    The scene is a launch ARGUMENT, not a closure constant: closed-over
    device arrays would be embedded in the compiled program, which for a
    scene with native-resolution textures is large."""
    eye, U, V, W = [jnp.asarray(x, jnp.float32) for x in cam_uvw]
    if max_depth is None:
        max_depth = padding - 1
    lanes = jnp.arange(n_core, dtype=jnp.uint32)

    def launch(ts: TraceScene, frame):
        state = rng_mod.seed(lanes, jnp.asarray(frame, jnp.uint32)
                             + jnp.uint32(0x51000000))
        r1, state = rng_mod.next_float(state)
        r2, state = rng_mod.next_float(state)
        d = (2.0 * r1 - 1.0)[:, None] * U + (2.0 * r2 - 1.0)[:, None] * V + W
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        o = jnp.broadcast_to(eye, d.shape)
        pixel = jnp.stack([r1, r2], axis=-1)

        buf = dict(
            position=jnp.zeros((n_core, padding, 3)).at[:, 0].set(o),
            normal=jnp.zeros((n_core, padding, 3)).at[:, 0].set(d),
            dir=jnp.zeros((n_core, padding, 3)),
            color=jnp.ones((n_core, padding, 3)),
            flux=jnp.ones((n_core, padding, 3)),
            mat_id=jnp.zeros((n_core, padding), jnp.int32),
            pdf=jnp.ones((n_core, padding)),
            depth=jnp.zeros((n_core, padding), jnp.int32),
        )

        # reservoir state: the chosen candidate (split index + light record)
        chosen = dict(k=jnp.ones((n_core,), jnp.int32),
                      position=jnp.zeros((n_core, 3)),
                      normal=jnp.zeros((n_core, 3)),
                      weight=jnp.zeros((n_core, 3)),
                      pdf=jnp.ones((n_core,)),
                      label=jnp.zeros((n_core,), jnp.int32),
                      is_dir=jnp.zeros((n_core,), bool))

        carry = dict(o=o, d=d, state=state, buf=buf,
                     k=jnp.ones((n_core,), jnp.int32),
                     flux=jnp.ones((n_core, 3)), pdf=jnp.ones((n_core,)),
                     pending_f=jnp.ones((n_core, 3)),
                     pending_single=jnp.ones((n_core,)),
                     n_resample=jnp.zeros((n_core,), jnp.int32),
                     chosen=chosen,
                     done=jnp.zeros((n_core,), bool))

        def accept(c, light, cond):
            """Reservoir-accept (rr_acc_accept raygen.cu:741-749): streaming
            1/(n+1) replacement of the lane's chosen candidate. Only the
            candidate (split index k + light record) is stored here; the path
            info is built once after the scan — the reference rebuilds it per
            acceptance inside the trace loop, which is redundant work."""
            r, st = rng_mod.next_float(c["state"])
            take = cond & (1.0 / (c["n_resample"].astype(jnp.float32) + 1.0) > r)
            sel = lambda new, old: jnp.where(
                take.reshape(take.shape + (1,) * (new.ndim - 1)), new, old)
            chosen = {"k": sel(c["k"], c["chosen"]["k"])}
            for kk, vv in light.items():
                chosen[kk] = sel(vv, c["chosen"][kk])
            n_res = c["n_resample"] + jnp.where(cond, 1, 0)
            return dict(c, state=st, chosen=chosen, n_resample=n_res)

        def body(c, _):
            live = ~c["done"]
            # dead-lane tmax: see render/pt.py body note
            hit = trace_closest(ts, c["o"], c["d"], SCENE_EPSILON,
                                jnp.where(live, 1e16, -1.0), CULL_BACKFACE)
            geom = local_geometry(ts, hit, c["o"], c["d"])
            hit_light = hit.valid & (geom["light_id"] >= 0) & live
            hit_surf = hit.valid & (geom["light_id"] < 0) & live

            lanes_i = jnp.arange(n_core)
            dvec = c["d"]
            last_norm = c["buf"]["normal"][lanes_i, jnp.maximum(c["k"] - 1, 0)]
            cos_mid = jnp.abs(vec.dot(geom["Ns"], dvec))
            cos_last = jnp.abs(vec.dot(last_norm, dvec))
            inv_t2 = 1.0 / jnp.maximum(hit.t * hit.t, 1e-20)
            pdf_g = cos_mid * cos_last * inv_t2

            first = c["k"] == 1
            flux_mid = jnp.where(first[..., None],
                                 c["flux"] * pdf_g[..., None],
                                 c["pending_f"] * c["flux"] * pdf_g[..., None])
            single = c["pending_single"] * pdf_g / jnp.maximum(cos_last, 1e-20)
            pdf_mid = c["pdf"] * single

            # --- emitter hit: complete path via ReverseSample (raygen.cu:804-817)
            lid = jnp.maximum(geom["light_id"], 0)
            ls_rev = lights_mod.reverse_sample_quad(ts, lid, geom["uv"])
            light_rec = dict(position=ls_rev.position, normal=ls_rev.normal,
                             weight=ls_rev.emission, pdf=ls_rev.pdf,
                             label=ls_rev.subspace_id,
                             is_dir=jnp.zeros((n_core,), bool))
            cond_hit = hit_light & (c["k"] >= 2)
            c = accept(c, light_rec, cond_hit)

            # --- store surface vertex in the buffer ---
            kcl = jnp.minimum(c["k"], padding - 1)
            newbuf = dict(c["buf"])
            put = hit_surf

            def setbuf(name, val):
                cur = newbuf[name]
                old = cur[lanes_i, kcl]
                msk = put if cur.ndim == 2 else put[:, None]
                newbuf[name] = cur.at[lanes_i, kcl].set(jnp.where(msk, val, old))

            setbuf("position", geom["P"])
            setbuf("normal", geom["Ns"])
            setbuf("dir", -dvec)
            setbuf("color", geom["base_color"])
            setbuf("flux", flux_mid)
            setbuf("mat_id", geom["mat_id"])
            setbuf("pdf", pdf_mid)
            setbuf("depth", c["k"])
            c = dict(c, buf=newbuf,
                     k=c["k"] + jnp.where(put, 1, 0),
                     flux=jnp.where(put[..., None], flux_mid, c["flux"]),
                     pdf=jnp.where(put, pdf_mid, c["pdf"]))

            # --- NEE + reservoir accept (raygen.cu:823-841) ---
            ls, st = lights_mod.sample_light(ts, c["state"])
            c = dict(c, state=st)
            # visibility target: env lights along +direction (cuProg.h:489-501)
            vis_ok = visibility(ts, geom["P"], jnp.where(
                ls.is_env[..., None],
                geom["P"] + ls.direction * 10.0 * _env_r(ts),
                ls.position), SCENE_EPSILON, mask=hit_surf)
            # one-sidedness checks (raygen.cu:835-837)
            facing = jnp.where(
                ls.is_env,
                vec.dot(-ls.direction, geom["Ns"]) < 0,
                vec.dot(ls.position - geom["P"], ls.normal) < 0)
            light_rec2 = dict(position=ls.position, normal=ls.normal,
                              weight=ls.emission, pdf=ls.pdf,
                              label=ls.subspace_id, is_dir=ls.is_env)
            c = accept(c, light_rec2, hit_surf & vis_ok & facing)

            # --- bounce ---
            v_dir = -dvec
            mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
            new_d, st = bsdf_mod.sample_bsdf(mat, geom["Ns"], v_dir, c["state"])
            bpdf = bsdf_mod.pdf_bsdf(mat, geom["Ns"], v_dir, new_d)
            f = bsdf_mod.eval_bsdf(mat, geom["Ns"], v_dir, new_d)
            rr = bsdf_mod.rr_rate(geom["base_color"], MIN_RR_RATE)
            r, st = rng_mod.next_float(st)
            cont = hit_surf & (r <= rr) & (bpdf > 0.0) & (c["k"] < padding)
            done = c["done"] | ~cont

            return dict(c, state=st,
                        o=vec.where3(cont, geom["P"], c["o"]),
                        d=vec.where3(cont, new_d, c["d"]),
                        pending_f=vec.where3(cont, f, c["pending_f"]),
                        pending_single=jnp.where(cont, bpdf * rr,
                                                 c["pending_single"]),
                        done=done), None

        c, _ = jax.lax.scan(body, carry, None, length=max_depth)

        # build the chosen candidate's records once (vs per-acceptance in the
        # reference trace loop)
        light_rec = {kk: c["chosen"][kk] for kk in
                     ("position", "normal", "weight", "pdf", "label", "is_dir")}
        path, conn = _build_path_info(ts, c["buf"], c["chosen"]["k"], light_rec)

        n_res = jnp.maximum(c["n_resample"], 1)
        sample_pdf = path["sample_pdf"] / n_res.astype(jnp.float32)
        valid = (c["n_resample"] > 0) & (path["n_conns"] > 0) \
            & (vec.float3weight(path["contri"]) > 0) \
            & jnp.isfinite(sample_pdf) \
            & jnp.isfinite(vec.float3weight(path["contri"]))
        px = jnp.stack([(pixel[:, 0] * 65535).astype(jnp.int32),
                        (pixel[:, 1] * 65535).astype(jnp.int32)], axis=-1)
        nc = path["n_conns"]
        slot_valid = (jnp.arange(padding)[None, :] < nc[:, None]) & valid[:, None]
        return PretraceBatch(
            contri=path["contri"], sample_pdf=sample_pdf,
            fix_pdf=path["fix_pdf"], n_conns=nc, pixel=px,
            valid=valid,
            a_position=conn["a_position"], a_normal=conn["a_normal"],
            a_dir=conn["a_dir"], b_position=conn["b_position"],
            b_normal=conn["b_normal"], b_dir=conn["b_dir"],
            peak_pdf=conn["peak_pdf"], label_a=conn["label_a"],
            label_b=conn["label_b"], light_source=conn["light_source"],
            conn_valid=conn["conn_valid"] & slot_valid)

    return launch


def _env_r(ts):
    return ts.env.r if ts.has_env else jnp.float32(1.0)
