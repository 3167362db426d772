"""Tracing/profiling utilities (SURVEY.md §5 parity).

The reference has wall-clock section timers surfaced in an ImGui overlay
(optixPathTracer.cpp:787-817, sutil.cpp:715-752) and CUDA-event stage timers
for training (device_thrust.h:16-30). Here: a phase timer with
block_until_ready fences, a clock for JAX's compile time, and an optional
jax.profiler trace context for xprof/tensorboard dumps.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class PhaseTimer:
    """Accumulating per-phase wall timers with device fences.

    with timer.phase("light_trace", fence=result): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            if "fence" in holder:
                jax.block_until_ready(holder["fence"])
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:>16}: {tot*1e3:9.1f} ms total, "
                         f"{tot/n*1e3:8.2f} ms/call x{n}")
        return "\n".join(lines)

    def as_dict(self):
        return {k: {"total_s": self.totals[k], "calls": self.counts[k]}
                for k in self.totals}


_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


@contextlib.contextmanager
def compile_clock():
    """Yields a dict that accumulates, while the block runs, the seconds JAX
    spends tracing, lowering and compiling ("seconds") and the number of
    backend compilations ("compiles"); cache hits compile nothing."""
    acc = {"seconds": 0.0, "compiles": 0}

    def listener(event, duration_secs, **kwargs):
        if event in _COMPILE_EVENTS:
            acc["seconds"] += duration_secs
            acc["compiles"] += event == _COMPILE_EVENTS[-1]

    jax.monitoring.register_event_duration_secs_listener(listener)
    try:
        yield acc
    finally:
        jax.monitoring.unregister_event_duration_listener(listener)


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace context (view with tensorboard/xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
