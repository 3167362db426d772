"""Vector math over SoA arrays of shape (..., 3).

Batched replacement for the reference's float3 operator headers
(reference: src/sutil/vec_math.h) — everything is batched jnp, last axis = xyz.
"""
from __future__ import annotations

import jax.numpy as jnp


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def normalize(a, eps: float = 1e-20):
    return a / jnp.maximum(length(a), eps)[..., None]


def lerp(a, b, t):
    return a + (b - a) * t


def luminance(c):
    """Reference luminance weights (raygen.cu:56, cuProg.h:757): 0.3/0.6/0.1."""
    return 0.3 * c[..., 0] + 0.6 * c[..., 1] + 0.1 * c[..., 2]


def float3weight(c):
    """Sum of components; the reference's scalarization of flux values
    (BDPTVertex.h float3weight)."""
    return c[..., 0] + c[..., 1] + c[..., 2]


def vmax(c):
    return jnp.max(c, axis=-1)


def onb(normal):
    """Orthonormal basis matching the reference construction (cuProg.h:81-111).

    Returns (tangent, binormal); frame vectors satisfy
    world = x*tangent + y*binormal + z*normal.
    """
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    use_x = jnp.abs(nx) > jnp.abs(nz)
    bx = jnp.where(use_x, -ny, jnp.zeros_like(nx))
    by = jnp.where(use_x, nx, -nz)
    bz = jnp.where(use_x, jnp.zeros_like(nx), ny)
    binormal = normalize(jnp.stack([bx, by, bz], axis=-1))
    tangent = cross(binormal, normal)
    return tangent, binormal


def onb_transform(normal, local):
    """Local (x,y,z) -> world using the reference's Onb.inverse_transform."""
    t, b = onb(normal)
    return (local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * normal)


def cosine_sample_hemisphere(u1, u2):
    """Reference cosine_sample_hemisphere (cuProg.h:113-124): concentric-free
    sqrt disk + project up. Returns local-frame direction (..., 3)."""
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - x * x - y * y))
    return jnp.stack([x, y, z], axis=-1)


def reflect(v, h):
    """Mirror direction of v about h (both pointing away from surface)."""
    return 2.0 * dot(v, h)[..., None] * h - v


def where3(mask, a, b):
    """Select over (...,3) given (...) mask."""
    return jnp.where(mask[..., None], a, b)


def is_invalid_value(c, clamp: float = 1e5):
    """Reference ISINVALIDVALUE (raygen.cu:43): any component >1e5 or NaN."""
    bad = jnp.isnan(c) | (c > clamp)
    return jnp.any(bad, axis=-1)


def scrub(c, clamp: float = 1e5):
    """Zero out invalid contributions, replicating the reference's estimator
    guard (raygen.cu:43 usage)."""
    bad = is_invalid_value(c, clamp) | jnp.any(jnp.isinf(c), axis=-1)
    return jnp.where(bad[..., None], jnp.zeros_like(c), c)
