"""Scene assembly: parsed description -> device-resident SoA pytrees + trace API.

Replaces the reference's scene conversion/upload and RT pipeline state
(reference: scene_shift.cpp:32-328, sutil/Scene.cpp): materials become a flat
SoA table, quad lights become both light records and emissive triangles
(scene_shift.cpp:92-103,252-328), per-light subspace-id blocks are assigned via
ssBase/divLevel (scene_shift.cpp:110-143), meshes+BVH live as jnp arrays.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..config import NUM_SUBSPACE_LIGHTSOURCE
from ..ops import bvh as bvh_mod
from ..ops import bvh_gpu
from ..ops import clusters as clusters_mod
from ..ops import intersect, tile_trace, traverse
from ..utils import struct
from . import obj as obj_mod
from .camera import Camera
from .envmap import EnvMap, build_envmap, dummy_envmap
from .parser import SceneDesc, load_scene

# Textures are kept at NATIVE resolution (reference: stb native-res CUDA
# textures, scene_shift.cpp:40), padded into one shared (NT, Hmax, Wmax, 3)
# stack with per-texture (h, w) for wrap addressing. Only textures whose
# longest edge exceeds TEX_MAX are area-downsampled (memory bound: the stack
# is dense HBM).
TEX_MAX = 2048
# Traversal-mode auto-selection. On the CPU, testing every triangle of a
# small scene as one fused broadcast beats XLA's BVH while_loop; on the GPU
# the one-thread-per-ray kernel (ops/bvh_gpu.py) serves every size.
BRUTE_FORCE_MAX_TRIS_CPU = 1024
CLUSTER_TRI_K = 32
TILE_LANES = 256
# sorting restores the two-level interval culling of mode "tile" on
# incoherent wavefronts (see tile_trace.ray_sort_key)
SORT_RAYS = os.environ.get("SPCBPT_SORT_RAYS", "1") != "0"


@struct.dataclass
class Materials:
    """Disney BSDF parameter table (reference cuda/MaterialData.h:82-101).

    Per Material_shift (scene_shift.cpp:70-75) only color/metallic/roughness/
    brdf + albedo texture come from the scene file; the rest keep MaterialData
    defaults."""
    base_color: jnp.ndarray     # (M, 3)
    metallic: jnp.ndarray       # (M,)
    roughness: jnp.ndarray      # (M,)
    specular: jnp.ndarray
    specular_tint: jnp.ndarray
    subsurface: jnp.ndarray
    anisotropic: jnp.ndarray
    sheen: jnp.ndarray
    sheen_tint: jnp.ndarray
    clearcoat: jnp.ndarray
    clearcoat_gloss: jnp.ndarray
    brdf: jnp.ndarray           # (M,) bool "pure specular" flag
    tex_id: jnp.ndarray         # (M,) int32, -1 = no albedo texture


@struct.dataclass
class QuadLights:
    """Quad area lights (reference cuda/Light.h:31-92)."""
    corner: jnp.ndarray      # (L, 3)
    u: jnp.ndarray           # (L, 3) edge vector
    v: jnp.ndarray           # (L, 3) edge vector
    normal: jnp.ndarray      # (L, 3) = normalize(cross(u, v))
    emission: jnp.ndarray    # (L, 3)
    area: jnp.ndarray        # (L,) = |cross(u, v)|
    ss_base: jnp.ndarray     # (L,) int32 subspace block base
    div_level: jnp.ndarray   # (L,) int32


@struct.dataclass
class TraceScene:
    # geometry (SoA, includes emissive light quads)
    tri_p0: jnp.ndarray      # (T, 3)
    tri_e1: jnp.ndarray      # (T, 3)
    tri_e2: jnp.ndarray      # (T, 3)
    tri_n: jnp.ndarray       # (T, 3, 3) shading normals per corner
    tri_uv: jnp.ndarray      # (T, 3, 2)
    tri_mat: jnp.ndarray     # (T,) int32
    tri_light: jnp.ndarray   # (T,) int32 light id for emitter tris, else -1
    mats: Materials
    textures: jnp.ndarray    # (NT, Hmax, Wmax, 3) linear albedo, zero-padded
    lights: QuadLights
    env: EnvMap
    # BVH (skip-link flattened)
    bvh_min: jnp.ndarray
    bvh_max: jnp.ndarray
    bvh_skip: jnp.ndarray
    bvh_leaf_start: jnp.ndarray
    bvh_leaf_count: jnp.ndarray
    # two-level cluster traversal (mode "tile"; None otherwise)
    clusters: Optional[clusters_mod.ClusterSet] = None
    # per-texture native (h, w) inside the padded stack (None = every
    # texture fills its slot, legacy/test scenes)
    tex_h: Optional[jnp.ndarray] = None   # (NT,) int32
    tex_w: Optional[jnp.ndarray] = None   # (NT,) int32
    # static metadata
    num_lights: int = struct.field(pytree_node=False, default=0)  # quads + env
    num_quad_lights: int = struct.field(pytree_node=False, default=0)
    has_env: bool = struct.field(pytree_node=False, default=False)
    mode: str = struct.field(pytree_node=False, default="brute")
    # uniform scene-unit scale applied at build (radiance-invariant);
    # multiply world-space inputs (camera) by this
    world_scale: float = struct.field(pytree_node=False, default=1.0)

    @property
    def num_tris(self) -> int:
        return self.tri_p0.shape[0]


# ---------------------------------------------------------------------------
# tracing entry points (the two "ray types" of optixPathTracer.h:202-209)
# ---------------------------------------------------------------------------

def trace_closest(ts: TraceScene, origins, dirs, tmin, tmax,
                  cull_backface: bool = True,
                  sort: bool | None = None) -> intersect.Hit:
    do_sort = SORT_RAYS if sort is None else sort
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), origins.shape[:-1])
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), origins.shape[:-1])
    if ts.mode == "brute":
        return intersect.brute_force_closest(
            origins, dirs, ts.tri_p0, ts.tri_e1, ts.tri_e2, tmin, tmax,
            cull_backface, chunk=min(512, max(8, ts.num_tris)))
    if ts.mode == "tile":
        return tile_trace.tile_closest(ts.clusters, origins, dirs, tmin, tmax,
                                       cull_backface, tile=TILE_LANES,
                                       sort_rays=do_sort)
    walk = bvh_gpu if ts.mode == "cuda" else traverse
    return walk.bvh_closest(
        origins, dirs, tmin, tmax,
        ts.bvh_min, ts.bvh_max, ts.bvh_skip, ts.bvh_leaf_start,
        ts.bvh_leaf_count, ts.tri_p0, ts.tri_e1, ts.tri_e2, cull_backface)


def trace_any(ts: TraceScene, origins, dirs, tmin, tmax,
              sort: bool | None = None):
    do_sort = SORT_RAYS if sort is None else sort
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), origins.shape[:-1])
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), origins.shape[:-1])
    if ts.mode == "brute":
        return intersect.brute_force_any(
            origins, dirs, ts.tri_p0, ts.tri_e1, ts.tri_e2, tmin, tmax,
            chunk=min(512, max(8, ts.num_tris)))
    if ts.mode == "tile":
        return tile_trace.tile_any(ts.clusters, origins, dirs, tmin, tmax,
                                   tile=TILE_LANES, sort_rays=do_sort)
    walk = bvh_gpu if ts.mode == "cuda" else traverse
    return walk.bvh_any(
        origins, dirs, tmin, tmax,
        ts.bvh_min, ts.bvh_max, ts.bvh_skip, ts.bvh_leaf_start,
        ts.bvh_leaf_count, ts.tri_p0, ts.tri_e1, ts.tri_e2)


def visibility(ts: TraceScene, pos_a, pos_b, eps: float = 1e-3,
               sort: bool | None = None, mask=None):
    """True if the segment a->b is unoccluded (reference visibilityTest,
    cuProg.h:463-487).

    mask (optional, bool (...,)): lanes where mask is False are not traced —
    their tmax is set below tmin, which every traversal treats as a dead
    lane that does no work; the returned value for those lanes is
    unspecified. Callers use this to skip occlusion work for
    connections whose contribution is already known to be zero."""
    d = pos_b - pos_a
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-30))
    dirs = d / dist[..., None]
    tmax = dist - eps
    if mask is not None:
        tmax = jnp.where(mask, tmax, -1.0)
    occ = trace_any(ts, pos_a, dirs, jnp.full_like(dist, eps), tmax,
                    sort=sort)
    return ~occ


# ---------------------------------------------------------------------------
# hit shading data (reference cuda/LocalGeometry.h + ColorTexSample)
# ---------------------------------------------------------------------------

def sample_albedo(ts: TraceScene, tex_id, uv):
    """Bilinear, wrap-mode albedo fetch from the texture stack; returns
    linear-space rgb. tex_id < 0 lanes return 1 (multiplied away by caller)."""
    nt, hmax, wmax, _ = ts.textures.shape
    tid = jnp.clip(tex_id, 0, nt - 1)
    # per-texture native extent inside the padded stack
    if ts.tex_h is not None:
        h = ts.tex_h[tid].astype(jnp.float32)
        w = ts.tex_w[tid].astype(jnp.float32)
    else:
        h, w = float(hmax), float(wmax)
    fu = uv[..., 0] * w - 0.5
    fv = uv[..., 1] * h - 0.5
    x0 = jnp.floor(fu)
    y0 = jnp.floor(fv)
    du = (fu - x0)[..., None]
    dv = (fv - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    hi = jnp.asarray(h, jnp.int32) if ts.tex_h is None else ts.tex_h[tid]
    wi = jnp.asarray(w, jnp.int32) if ts.tex_w is None else ts.tex_w[tid]

    def fetch(xi, yi):
        return ts.textures[tid, jnp.mod(yi, hi), jnp.mod(xi, wi)]

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    c = (c00 * (1 - du) * (1 - dv) + c10 * du * (1 - dv)
         + c01 * (1 - du) * dv + c11 * du * dv)
    return jnp.where((tex_id >= 0)[..., None], c, jnp.ones_like(c))


def local_geometry(ts: TraceScene, hit: intersect.Hit, origins, dirs):
    """Gather per-hit shading data. Returns a dict of SoA arrays:
    P, Ns (shading normal flipped toward -dir), Ng, uv, mat_id, light_id,
    base_color (texture-modulated, linear)."""
    tri = jnp.maximum(hit.tri, 0)
    p0 = ts.tri_p0[tri]
    e1 = ts.tri_e1[tri]
    e2 = ts.tri_e2[tri]
    u = hit.u[..., None]
    v = hit.v[..., None]
    P = p0 + u * e1 + v * e2
    n = ts.tri_n[tri]
    Ns = n[..., 0, :] * (1 - u - v) + n[..., 1, :] * u + n[..., 2, :] * v
    Ns = Ns / jnp.maximum(jnp.linalg.norm(Ns, axis=-1, keepdims=True), 1e-20)
    Ng = jnp.cross(e1, e2)
    Ng = Ng / jnp.maximum(jnp.linalg.norm(Ng, axis=-1, keepdims=True), 1e-20)
    # flip shading normal toward the incoming side (hit_program.cu:258-259)
    facing = jnp.sum(Ns * dirs, axis=-1) <= 0.0
    Ns = jnp.where(facing[..., None], Ns, -Ns)
    uvs = ts.tri_uv[tri]
    uv = uvs[..., 0, :] * (1 - u - v) + uvs[..., 1, :] * u + uvs[..., 2, :] * v
    mat_id = ts.tri_mat[tri]
    light_id = ts.tri_light[tri]
    base = ts.mats.base_color[mat_id]
    tex_id = ts.mats.tex_id[mat_id]
    base = base * sample_albedo(ts, tex_id, uv)
    return dict(P=P, Ns=Ns, Ng=Ng, uv=uv, mat_id=mat_id, light_id=light_id,
                base_color=base)


# ---------------------------------------------------------------------------
# host-side assembly
# ---------------------------------------------------------------------------

def _quad_light_tris(corner, u, v):
    """Two CCW triangles whose geometric normal equals normalize(cross(u,v))."""
    p0 = corner
    tris = [
        (p0, u, v),               # (p0, p0+u, p0+v)
        (p0 + u + v, -u, -v),     # (p0+u+v, p0+v, p0+u) -> n = cross(-u,-v) = cross(u,v)
    ]
    return tris


TARGET_DIAG = 10.0  # normalized scene bbox diagonal (house-like units)


def build_scene(desc: SceneDesc, data_dir: Optional[str] = None,
                mode: Optional[str] = None,
                normalize_units: bool = True) -> TraceScene:
    data_dir = data_dir or desc.root_dir

    mat_names = list(desc.materials.keys())
    mat_index = {n: i for i, n in enumerate(mat_names)}
    if not mat_names:
        mat_names = ["default"]
        mat_index = {"default": 0}
        from .parser import MaterialDesc
        desc.materials["default"] = MaterialDesc(name="default",
                                                 color=(0.8, 0.8, 0.8))

    # texture stack
    tex_paths, tex_ids = [], {}
    for n in mat_names:
        m = desc.materials[n]
        if m.albedo_tex and m.albedo_tex not in tex_ids:
            tex_ids[m.albedo_tex] = len(tex_paths)
            tex_paths.append(m.albedo_tex)
    textures = np.ones((max(len(tex_paths), 1), 1, 1, 3), np.float32)
    tex_hw = np.ones((max(len(tex_paths), 1), 2), np.int32)
    if tex_paths:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                "scenes with albedo textures need OpenCV (the 'textures' "
                "extra: pip install opencv-python)") from e
        texs = []
        for p in tex_paths:
            full = os.path.join(data_dir, p)
            img = cv2.imread(full, cv2.IMREAD_COLOR)
            if img is None:
                img = np.full((4, 4, 3), 255, np.uint8)
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            # native resolution (scene_shift.cpp:40 stb native-res textures);
            # only bound the longest edge to TEX_MAX (dense-stack memory cap)
            h, w = img.shape[:2]
            if max(h, w) > TEX_MAX:
                s = TEX_MAX / max(h, w)
                img = cv2.resize(img, (max(1, round(w * s)),
                                       max(1, round(h * s))),
                                 interpolation=cv2.INTER_AREA)
            linear = np.power(img.astype(np.float32) / 255.0, 2.2)
            # reference samples textures with v ascending from the top row
            texs.append(linear)
        hmax = max(t.shape[0] for t in texs)
        wmax = max(t.shape[1] for t in texs)
        textures = np.zeros((len(texs), hmax, wmax, 3), np.float32)
        tex_hw = np.ones((len(texs), 2), np.int32)
        for i, t in enumerate(texs):
            textures[i, :t.shape[0], :t.shape[1]] = t
            tex_hw[i] = t.shape[:2]

    M = len(mat_names)
    mats = Materials(
        base_color=np.zeros((M, 3), np.float32),
        metallic=np.zeros(M, np.float32),
        roughness=np.zeros(M, np.float32),
        specular=np.full(M, 0.5, np.float32),
        specular_tint=np.zeros(M, np.float32),
        subsurface=np.zeros(M, np.float32),
        anisotropic=np.zeros(M, np.float32),
        sheen=np.zeros(M, np.float32),
        sheen_tint=np.full(M, 0.5, np.float32),
        clearcoat=np.zeros(M, np.float32),
        clearcoat_gloss=np.ones(M, np.float32),
        brdf=np.zeros(M, bool),
        tex_id=np.full(M, -1, np.int32),
    )
    for n in mat_names:
        i = mat_index[n]
        m = desc.materials[n]
        mats.base_color[i] = m.color
        mats.metallic[i] = m.metallic
        mats.roughness[i] = m.roughness
        mats.brdf[i] = bool(m.brdf)
        if m.albedo_tex:
            mats.tex_id[i] = tex_ids[m.albedo_tex]

    # geometry from meshes
    pos_l, n_l, uv_l, matid_l, light_l = [], [], [], [], []
    for mesh in desc.meshes:
        path = os.path.join(data_dir, mesh.file)
        if not os.path.exists(path):
            # the reference repo ships only a subset of the house OBJs;
            # skip with a warning instead of failing the whole scene
            print(f"[scene] warning: missing mesh {mesh.file}, skipped")
            continue
        md = obj_mod.load_obj(path)
        t = len(md.positions)
        if t == 0:
            continue
        pos_l.append(md.positions)
        n_l.append(md.normals)
        uv_l.append(md.uvs)
        mid = mat_index.get(mesh.material, 0)
        matid_l.append(np.full(t, mid, np.int32))
        light_l.append(np.full(t, -1, np.int32))

    # quad lights: light records + emissive geometry
    quads = [l for l in desc.lights if l.light_type == "Quad"]
    dir_lights = [(l.direction, l.emission) for l in desc.lights
                  if l.light_type == "Direction"]
    has_env = desc.has_envmap()
    # ssBase starts at half the reserved block when an env map exists
    # (scene_shift.cpp:110)
    ss_base_run = int(0.5 * NUM_SUBSPACE_LIGHTSOURCE) if has_env else 0

    L = len(quads)
    lights = QuadLights(
        corner=np.zeros((max(L, 1), 3), np.float32),
        u=np.zeros((max(L, 1), 3), np.float32),
        v=np.zeros((max(L, 1), 3), np.float32),
        normal=np.zeros((max(L, 1), 3), np.float32),
        emission=np.zeros((max(L, 1), 3), np.float32),
        area=np.ones(max(L, 1), np.float32),
        ss_base=np.zeros(max(L, 1), np.int32),
        div_level=np.ones(max(L, 1), np.int32),
    )
    for i, l in enumerate(quads):
        corner = np.asarray(l.position, np.float32)
        uvec = np.asarray(l.u, np.float32)
        vvec = np.asarray(l.v, np.float32)
        # (scaled below with the rest of the geometry via world_scale)
        lights.corner[i] = corner
        lights.u[i] = uvec
        lights.v[i] = vvec
        lights.normal[i] = l.normal
        lights.emission[i] = l.emission
        lights.area[i] = l.area
        lights.ss_base[i] = ss_base_run
        lights.div_level[i] = l.div_level
        ss_base_run += l.div_level * l.div_level

        tris = _quad_light_tris(corner, uvec, vvec)
        pos = np.stack([[p0, p0 + e1, p0 + e2] for p0, e1, e2 in tris])
        pos_l.append(pos.astype(np.float32))
        nrm = np.tile(np.asarray(l.normal, np.float32), (2, 3, 1))
        n_l.append(nrm)
        # uv = barycentric (u, v) over the quad: corner-of-quad coords so the
        # reverse light sample (uv->subspace bin) is exact per triangle
        uv_l.append(np.array([[[0, 0], [1, 0], [0, 1]],
                              [[1, 1], [0, 1], [1, 0]]], np.float32))
        matid_l.append(np.zeros(2, np.int32))
        light_l.append(np.full(2, i, np.int32))

    if not pos_l:
        raise ValueError("scene has no geometry")
    positions = np.concatenate(pos_l)

    # --- scene-unit normalization ---
    # BDPT-family estimators carry separate cumulative flux and pdf whose
    # magnitudes scale like (1/dist^2)^depth; at large scene units (classic
    # Cornell is 556 wide) the flux*flux product of a connection underflows
    # f32 near total path depth ~6 and silently drops long-path energy.
    # Radiance is invariant under uniform geometric scaling, so normalize the
    # world to a ~TARGET_DIAG bounding diagonal (the reference's scenes are
    # ~10-20 units, which is the envelope its f32 math was validated in).
    world_scale = 1.0
    if normalize_units:
        lo0 = positions.reshape(-1, 3).min(axis=0)
        hi0 = positions.reshape(-1, 3).max(axis=0)
        diag0 = float(np.linalg.norm(hi0 - lo0))
        if diag0 > 0:
            world_scale = TARGET_DIAG / diag0
            positions = positions * world_scale
            lights.corner[:] = lights.corner * world_scale
            lights.u[:] = lights.u * world_scale
            lights.v[:] = lights.v * world_scale
            lights.area[:] = lights.area * (world_scale * world_scale)
    normals = np.concatenate(n_l)
    uvs = np.concatenate(uv_l)
    mat_ids = np.concatenate(matid_l)
    light_ids = np.concatenate(light_l)

    if desc.use_geometry_normal:
        e1 = positions[:, 1] - positions[:, 0]
        e2 = positions[:, 2] - positions[:, 0]
        gn = np.cross(e1, e2)
        gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-30)
        keep = light_ids >= 0  # light quads already carry exact normals
        normals = np.where(keep[:, None, None], normals,
                           np.repeat(gn[:, None, :], 3, axis=1))

    p0 = positions[:, 0]
    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]

    # scene bounds for env
    lo = positions.reshape(-1, 3).min(axis=0)
    hi = positions.reshape(-1, 3).max(axis=0)
    center = (lo + hi) / 2
    diag = float(np.linalg.norm(hi - lo))

    env = dummy_envmap()
    if has_env:
        from .hdr import load_hdr
        raster = load_hdr(os.path.join(data_dir, desc.env_file))
        env = build_envmap(raster, center, diag, dir_lights, desc.env_factor)

    flat = bvh_mod.build_bvh(p0, e1, e2)
    order = flat.order

    if mode is None:
        import jax
        if jax.default_backend() == "gpu":
            mode = "cuda"
        else:
            mode = "brute" if len(p0) <= BRUTE_FORCE_MAX_TRIS_CPU else "bvh"

    cset = None
    if mode == "tile":
        cset = clusters_mod.build_clusters(flat, p0[order], e1[order],
                                           e2[order], max_tris=CLUSTER_TRI_K)

    def dev(x, dt=jnp.float32):
        return jnp.asarray(x, dt)

    return TraceScene(
        tri_p0=dev(p0[order]), tri_e1=dev(e1[order]), tri_e2=dev(e2[order]),
        tri_n=dev(normals[order]), tri_uv=dev(uvs[order]),
        tri_mat=dev(mat_ids[order], jnp.int32),
        tri_light=dev(light_ids[order], jnp.int32),
        mats=Materials(**{k: jnp.asarray(getattr(mats, k))
                          for k in Materials.__dataclass_fields__}),
        textures=dev(textures),
        tex_h=dev(tex_hw[:, 0], jnp.int32), tex_w=dev(tex_hw[:, 1], jnp.int32),
        lights=QuadLights(**{k: jnp.asarray(getattr(lights, k))
                             for k in QuadLights.__dataclass_fields__}),
        env=env,
        bvh_min=dev(flat.bounds_min), bvh_max=dev(flat.bounds_max),
        bvh_skip=dev(flat.skip, jnp.int32),
        bvh_leaf_start=dev(flat.leaf_start, jnp.int32),
        bvh_leaf_count=dev(flat.leaf_count, jnp.int32),
        clusters=cset,
        num_lights=L + (1 if has_env else 0),
        num_quad_lights=L,
        has_env=has_env,
        mode=mode,
        world_scale=float(world_scale),
    )


def load_trace_scene(scene_path: str, mode: Optional[str] = None):
    """Parse + assemble in one step; returns (TraceScene, SceneDesc, Camera).
    The camera is expressed in the normalized scene units (world_scale)."""
    desc = load_scene(scene_path)
    ts = build_scene(desc, mode=mode)
    s = ts.world_scale
    cam = Camera(eye=np.asarray(desc.eye) * s,
                 lookat=np.asarray(desc.lookat) * s,
                 up=np.asarray(desc.up), fov_y=desc.fov,
                 aspect=desc.width / desc.height)
    return ts, desc, cam
