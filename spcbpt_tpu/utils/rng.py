"""Counter-based per-lane RNG: tea<4> seed hash + LCG stream.

The reference seeds each thread with tea<4>(linear_index, subframe) and draws
sequential uniforms with a 1664525/1013904223 LCG (reference: src/cuda/random.h).
We reproduce the same scheme as pure elementwise uint32 jnp ops — it fuses
into the surrounding kernels, is stateless per (lane, frame), and keeps
sample sequences structurally comparable to the reference.

Usage is functional: every draw returns (value, new_state).
"""
from __future__ import annotations

import jax.numpy as jnp

_LCG_A = jnp.uint32(1664525)
_LCG_C = jnp.uint32(1013904223)


def tea(val0, val1, rounds: int = 4):
    """TEA hash of two uint32 lanes (reference src/cuda/random.h:32)."""
    v0 = jnp.asarray(val0, jnp.uint32)
    v1 = jnp.asarray(val1, jnp.uint32)
    s0 = jnp.uint32(0)
    for _ in range(rounds):
        s0 = s0 + jnp.uint32(0x9E3779B9)
        v0 = v0 + (((v1 << 4) + jnp.uint32(0xA341316C)) ^ (v1 + s0)
                   ^ ((v1 >> 5) + jnp.uint32(0xC8013EA4)))
        v1 = v1 + (((v0 << 4) + jnp.uint32(0xAD90777D)) ^ (v0 + s0)
                   ^ ((v0 >> 5) + jnp.uint32(0x7E95761E)))
    return v0


def seed(lane_index, frame_index):
    """Per-lane stream state for a frame."""
    return tea(lane_index, frame_index)


def next_uint(state):
    """Advance the LCG; returns (24-bit random uint, new_state)."""
    new = _LCG_A * state + _LCG_C
    return new & jnp.uint32(0x00FFFFFF), new


def next_float(state):
    """Uniform in [0, 1) and the advanced state (reference rnd())."""
    bits, new = next_uint(state)
    return bits.astype(jnp.float32) / jnp.float32(1 << 24), new


def next_floats(state, n: int):
    """Draw n sequential uniforms; returns (tuple of arrays, new_state)."""
    outs = []
    for _ in range(n):
        x, state = next_float(state)
        outs.append(x)
    return tuple(outs), state
