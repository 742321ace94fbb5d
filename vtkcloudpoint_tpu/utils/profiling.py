"""Profiling + op accounting.

Equivalents of the reference's measurement machinery (SURVEY.md §5):
- Stopwatch wall-clock (FrmMain.cs:1342-1344) -> Stopwatch context manager
  that waits for the device (block_until_ready) before reading the clock.
- iritatorNum distance-eval counter (DBImproved.cs:12,19) -> analytic
  distance-eval accounting for the vectorized kernels (the dense formulation
  evaluates a deterministic, shape-derived count; no mutable global needed).
- jax.profiler trace hook for real device profiles.
"""
from __future__ import annotations

import contextlib
import time

import jax


class Stopwatch:
    """with Stopwatch() as sw: ...; sw.elapsed (seconds, host-synced)."""

    def __init__(self, sync_on=None):
        self._sync_on = sync_on
        self.elapsed = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync_on is not None:
            jax.block_until_ready(self._sync_on)
        self.elapsed = time.perf_counter() - self._t0
        return False

    def sync(self, value):
        self._sync_on = value
        return value


def dbscan_distance_evals(n_blocks: int, capacity: int, iters: int = 1) -> int:
    """Distance evaluations of the dense blocked DBSCAN: every block computes
    its full [cap, cap] metric once (adjacency), label propagation reuses it.
    The reference's counter (iritatorNum) counts the same quantity for its
    O(n^2) isKeyPoint scans."""
    return n_blocks * capacity * capacity * iters


def nn_distance_evals(n_query: int, n_ref: int, iterations: int = 1) -> int:
    """ICP correspondence distance evals: full bipartite per iteration
    (ICP.cs:224-250 brute force does exactly this)."""
    return n_query * n_ref * iterations


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace scope (view with tensorboard/xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
