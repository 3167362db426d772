"""Image/film helpers: tonemap, srgb, PNG IO, error metrics."""
from __future__ import annotations

import struct
import zlib

import numpy as np
import jax.numpy as jnp

from ..config import TONEMAP_LIMIT
from .vec import luminance


def tonemap(c, limit: float = TONEMAP_LIMIT):
    """Reference display tonemap (raygen.cu:52-58): c / (1 + lum/limit)."""
    lum = luminance(c)
    return c / (1.0 + lum / limit)[..., None]


def linear_to_srgb(c):
    """Reference LinearToSrgb (raygen.cu:65-69): pow(c, 1/2.2)."""
    return jnp.power(jnp.clip(c, 0.0, 1.0), 1.0 / 2.2)


def to_display(c, limit: float = TONEMAP_LIMIT):
    """HDR accumulation -> 8-bit displayable array (reference make_color path:
    tonemap then gamma via make_color's sRGB-ish clamp)."""
    ldr = linear_to_srgb(tonemap(c, limit))
    return np.asarray(jnp.clip(ldr * 255.0 + 0.5, 0, 255).astype(jnp.uint8))


def write_png(path: str, rgb8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG: one zlib-deflated
    IDAT chunk of unfiltered scanlines."""
    img = np.ascontiguousarray(rgb8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)],
                          axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def write_hdr_npz(path: str, img: np.ndarray) -> None:
    np.savez_compressed(path, radiance=np.asarray(img, np.float32))


def rel_mse(img, ref, eps: float = 1e-2, discard: float = 0.0) -> float:
    """Relative MSE against a reference image (standard renderer metric).
    discard > 0 drops that fraction of the largest per-value errors before
    averaging (the SPCBPT paper's outlier/firefly protocol — hard indirect
    scenes otherwise let a handful of fireflies dominate the metric)."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    d = (img - ref) ** 2 / (ref ** 2 + eps)
    if d.ndim >= 2 and d.shape[-1] == 3:
        # Aggregate per pixel before ranking so the discard drops whole
        # firefly pixels (the paper's protocol), not individual channels.
        d = d.mean(axis=-1)
    d = d.ravel()
    if discard > 0.0:
        k = max(1, int(len(d) * (1.0 - discard)))
        d = np.partition(d, k - 1)[:k]
    return float(np.mean(d))


def mape(img, ref, eps: float = 1e-2) -> float:
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.mean(np.abs(img - ref) / (ref + eps)))
