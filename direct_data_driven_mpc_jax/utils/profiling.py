"""Tracing / profiling / structured metrics.

The reference's observability is print-statements and plots (SURVEY.md
section 5). JAX equivalents provided here:

- :func:`trace` -- context manager around ``jax.profiler`` emitting an
  XPlane trace viewable in TensorBoard/Perfetto.
- :class:`Timer` -- wall-clock timer with ``block_until_ready`` so
  device work is actually measured, keeping p50/p99 percentiles.
- :func:`rollout_metrics` -- structured per-run metric dict from a
  :class:`ClosedLoopResult` (costs, tracking error, convergence lanes)
  for host-side logging; the arrays themselves come out of the scan,
  not from per-step host callbacks.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with the JAX profiler (XPlane)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-clock timer for device work (blocks on results)."""

    def __init__(self):
        self.samples: List[float] = []

    @contextlib.contextmanager
    def measure(self):
        """Wall-clock a host-side block. For DEVICE work use
        :meth:`timeit` with synchronization inside the function (a
        context manager cannot block on a result produced within its
        own body)."""
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    def timeit(self, fn, *args, iters: int = 3, warmup: int = 1):
        """Run ``fn(*args)`` ``warmup + iters`` times; record the timed
        iterations and return the last result."""
        out = None
        for _ in range(warmup):
            out = fn(*args)
            jax.block_until_ready(out)
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(*args)
            jax.block_until_ready(out)
            self.samples.append(time.perf_counter() - t0)
        return out

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.samples, q))

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    @property
    def best(self) -> float:
        return min(self.samples)

    def summary(self) -> Dict[str, float]:
        return {
            "n": len(self.samples),
            "best_s": self.best,
            "p50_s": self.p50,
            "p99_s": self.p99,
        }


def rollout_metrics(
    result,
    u_s: Optional[np.ndarray] = None,
    y_s: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Aggregate metrics from a (possibly batched) ClosedLoopResult."""
    costs = np.asarray(result.costs)
    conv = np.asarray(result.converged)
    u = np.asarray(result.u_sys)
    y = np.asarray(result.y_sys)
    metrics = {
        "n_solves": int(costs.size),
        "final_cost_mean": float(costs[..., -1].mean()),
        "final_cost_max": float(costs[..., -1].max()),
        "frac_converged": float(conv.mean()),
        "finite": bool(np.isfinite(u).all() and np.isfinite(y).all()),
    }
    if y_s is not None:
        err = np.abs(y[..., -1, :] - np.asarray(y_s).reshape(-1))
        metrics["final_output_error_mean"] = float(err.mean())
        metrics["final_output_error_max"] = float(err.max())
    if u_s is not None:
        erru = np.abs(u[..., -1, :] - np.asarray(u_s).reshape(-1))
        metrics["final_input_error_mean"] = float(erru.mean())
    return metrics
