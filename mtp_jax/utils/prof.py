"""Profiling / tracing helpers.

The reference relies on Kokkos kernel labels ("ComputeAlphaBasic", …) feeding
Kokkos Tools profilers (SURVEY.md §5.1). Equivalent here: `jax.named_scope`
annotations on each pipeline stage (visible in XLA HLO and device profiler
timelines) plus a one-call trace capture helper for `jax.profiler`.
"""

from __future__ import annotations

import contextlib
import time

import jax

named_scope = jax.named_scope


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device profiler trace for the enclosed block.

    View with TensorBoard or xprof: points at `log_dir`.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-clock section timer with a `block_until_ready`d stop."""

    def __init__(self):
        self.sections: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if result is not None:
                jax.block_until_ready(result)
            self.sections[name] = self.sections.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.sections.values()) or 1.0
        lines = [
            f"{name:30s} {t * 1e3:10.2f} ms  {100 * t / total:5.1f}%"
            for name, t in sorted(self.sections.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
