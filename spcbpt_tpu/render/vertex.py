"""BDPT vertex record (SoA) shared by the light tracer, LVC and SPCBPT.

Mirrors the fields of the reference BDPTVertex (reference: BDPTVertex.h:9-70)
that the connection/RMIS math consumes. Stored as a pytree dataclass of arrays so a
whole LVC is one pytree; per-lane slices are plain dict-like gathers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import struct


@struct.dataclass
class LightVertices:
    """A batch of light sub-path vertices; leading axes arbitrary.

    The reference stores cumulative flux and cumulative pdf separately
    (BDPTVertex.h:9-70); every consumer (connection eval raygen.cu:253-303,
    LVC weights device_thrust.cu:200-207, RMIS rmis.h) only ever uses their
    RATIO, and the separate products underflow f32 at path length ~6 in
    large-unit scenes (the (cos*cos/t^2)^depth factor cancels in the ratio).
    We therefore carry `ratio = flux / pdf` directly — unit-invariant and
    perfectly conditioned — plus the per-segment `single_pdf` that the RMIS
    recursion consumes."""
    position: jnp.ndarray        # (..., 3)
    normal: jnp.ndarray          # (..., 3)
    ratio: jnp.ndarray           # (..., 3) cumulative flux / cumulative pdf
    color: jnp.ndarray           # (..., 3) texture-modulated base color
    last_position: jnp.ndarray   # (..., 3)
    single_pdf: jnp.ndarray      # (...,) segment pdf for this vertex
    last_normal_proj: jnp.ndarray  # (...,) |dot(N_prev, dir)|
    last_lum: jnp.ndarray        # (...,) float3sum(prev.ratio)
    rmis: jnp.ndarray            # (...,) light-side RMIS_pointer
    mat_id: jnp.ndarray          # (...,) int32
    subspace_id: jnp.ndarray     # (...,) int32
    eye_label: jnp.ndarray       # (...,) int32 eye-tree label at this vertex
                                 # (precomputed: rmis tracing_weight_light
                                 # re-labels light vertices with the EYE tree
                                 # per connection in the reference, rmis.h:71)
    last_zone_id: jnp.ndarray    # (...,) int32
    depth: jnp.ndarray           # (...,) int32
    is_origin: jnp.ndarray       # (...,) bool — on the light source
    is_env: jnp.ndarray          # (...,) bool — directional/env "position-less"
    is_ll_direction: jnp.ndarray  # (...,) bool — previous vertex was directional
    is_brdf: jnp.ndarray         # (...,) bool (dormant, reference parity)
    last_brdf: jnp.ndarray       # (...,) bool
    valid: jnp.ndarray           # (...,) bool

    def take(self, idx):
        """Gather vertices at flat indices idx (any shape)."""
        return jax.tree_util.tree_map(lambda a: a[idx], self)


# Packed-matrix layout: one (V, 32) f32 row per vertex so a connection draw
# fetches the whole record with ONE row-gather instead of ~20 scalar gathers
# of the SoA fields. Ints are stored as f32 (all ids < 2^24, exact); bools
# as 0/1.
_VEC3_FIELDS = ("position", "normal", "ratio", "color", "last_position")
_F32_FIELDS = ("single_pdf", "last_normal_proj", "last_lum", "rmis")
_INT_FIELDS = ("mat_id", "subspace_id", "eye_label", "last_zone_id", "depth")
_BOOL_FIELDS = ("is_origin", "is_env", "is_ll_direction", "is_brdf",
                "last_brdf", "valid")
PACK_WIDTH = 32  # 15 + 4 + 5 + 6 = 30 (+1 optional weight_b), padded to 32
WEIGHT_B_COL = 30  # precomputed rmis.tracing_weight_light (see pack_matrix)


def pack_matrix(lv: LightVertices, weight_b=None) -> jnp.ndarray:
    """Pack a flat (V,) LightVertices into one (V, 32) f32 matrix.

    weight_b (optional, (V,) f32): the vertex's light-side connection
    strategy weight rmis.tracing_weight_light — a pure function of vertex
    fields, so precomputing it here (once per LVC vertex per frame) saves a
    Gamma-table gather per connection draw (~196k 2D gathers per bounce).
    Stored in the otherwise-padded column WEIGHT_B_COL."""
    cols = [getattr(lv, f) for f in _VEC3_FIELDS]
    cols += [getattr(lv, f)[..., None] for f in _F32_FIELDS]
    cols += [getattr(lv, f).astype(jnp.float32)[..., None]
             for f in _INT_FIELDS + _BOOL_FIELDS]
    if weight_b is not None:
        cols += [weight_b[..., None]]
    m = jnp.concatenate(cols, axis=-1)
    pad = PACK_WIDTH - m.shape[-1]
    return jnp.pad(m, ((0, 0), (0, pad)))


def unpack_weight_b(rows: jnp.ndarray) -> jnp.ndarray:
    """The precomputed tracing_weight_light column of gathered packed rows
    (only meaningful when the sampler was built with a SubspaceState —
    LVCSampler.has_weight_b)."""
    return rows[..., WEIGHT_B_COL]


def unpack_rows(rows: jnp.ndarray) -> LightVertices:
    """Inverse of pack_matrix for gathered (N, 32) rows."""
    kw = {}
    o = 0
    for f in _VEC3_FIELDS:
        kw[f] = rows[..., o:o + 3]
        o += 3
    for f in _F32_FIELDS:
        kw[f] = rows[..., o]
        o += 1
    for f in _INT_FIELDS:
        kw[f] = rows[..., o].astype(jnp.int32)
        o += 1
    for f in _BOOL_FIELDS:
        kw[f] = rows[..., o] != 0.0
        o += 1
    return LightVertices(**kw)


def reshape_flat(lv: LightVertices) -> LightVertices:
    """Collapse the batch axes to one flat vertex axis. The batch rank is
    taken from `valid` (a pure-batch field), so feature axes like xyz
    survive regardless of how many batch dims the input has."""
    batch_ndim = lv.valid.ndim

    def r(a):
        return a.reshape((-1,) + a.shape[batch_ndim:])
    return jax.tree_util.tree_map(r, lv)
