"""Observability: wall-clock chronometers, throughput counters, and
optional device profiling.

Replacement for the reference's two-level chronometers and
throttled progress lines (biomcmc_get_time / biomcmc_update_elapsed_time
pairs + print_interval counters, nearest.c:173,321-328; SURVEY.md §5).

Set ``UVAIA_TPU_PROFILE=<dir>`` to capture a `jax.profiler` trace of
any engine run (viewable in TensorBoard / Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field


@dataclass
class Chronometer:
    """Two-level timer: total since construction + lap since last call
    (the reference's time0/time1 pattern)."""

    t0: float = field(default_factory=time.monotonic)
    t_lap: float = field(default_factory=time.monotonic)

    def lap(self) -> float:
        now = time.monotonic()
        dt = now - self.t_lap
        self.t_lap = now
        return dt

    def total(self) -> float:
        return time.monotonic() - self.t0


@contextlib.contextmanager
def maybe_profile():
    """jax.profiler trace when UVAIA_TPU_PROFILE is set to a directory."""
    outdir = os.environ.get("UVAIA_TPU_PROFILE")
    if not outdir:
        yield
        return
    import jax
    jax.profiler.start_trace(outdir)
    print(f"uvaia-tpu: profiling to {outdir}", file=sys.stderr)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        print(f"uvaia-tpu: profile written to {outdir}", file=sys.stderr)
