"""Tracing and profiling: named stages, a profiler trace, the bandwidth
of the dense scorer.

Counterpart of ``graal_tpu.utils.profiling``. The reference brackets every
kernel launch with CUDA events (cuda_lib_gl.py:544-593) and ships a
``timing.Timing`` decorator (timing.py:3-44). Here:

- :class:`StageTimer`: named wall-clock stages with counts and totals. A
  stage that wraps device work must end in a host read or
  ``torch.cuda.synchronize()`` to time the device;
- :func:`trace`: a ``torch.profiler`` trace of the block it wraps (host
  ops, and on a card its kernels, memcpys and memsets) written as a Chrome
  trace (``trace.json``, open in chrome://tracing or Perfetto);
- :func:`dense_scorer_traffic` / :func:`bandwidth_report`: the bytes the
  dense scorer B1 (``csrc/ll_dense.cu``) must read per EM step, so that an
  achieved bandwidth is computed from a measured time, against the H100
  80GB HBM3's 3.35 TB/s.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

# Peak HBM bandwidth of an NVIDIA H100 80GB HBM3 (SXM), bytes/s.
H100_HBM_BYTES_PER_S = 3.35e12


class StageTimer:
    """Accumulating named wall-clock stages.

    >>> t = StageTimer()
    >>> with t.stage("scoring"): ...
    >>> t.report()
    {'scoring': {'calls': 1, 'total_s': ..., 'mean_ms': ...}}
    """

    def __init__(self):
        self._acc = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            ent = self._acc.setdefault(name, [0, 0.0])
            ent[0] += 1
            ent[1] += dt

    def report(self) -> dict:
        return {
            name: {"calls": calls, "total_s": round(total, 4),
                   "mean_ms": round(total / calls * 1000, 3)}
            for name, (calls, total) in self._acc.items()}

    def print_report(self, header="stage timing"):
        rep = self.report()
        width = max((len(k) for k in rep), default=5)
        print(f"--- {header} ---", flush=True)
        for name, r in rep.items():
            print(f"{name:<{width}}  calls={r['calls']:<6} "
                  f"total={r['total_s']:.3f}s  mean={r['mean_ms']:.2f}ms",
                  flush=True)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the wrapped block with ``torch.profiler`` (CPU ops, and the
    card's kernels when CUDA is available) and write the Chrome trace
    ``<log_dir>/trace.json``. Usage: ``with profiling.trace(out_dir):
    run_cycles()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path} (chrome://tracing or Perfetto)", flush=True)


def dense_scorer_traffic(k_subs: int, candidates_per_step: int, steps: int) -> dict:
    """Bytes the dense scorer B1 must read per EM step, and per cycle of
    ``steps`` steps: the strict upper triangle of the (K, K) f32 observed
    matrix (the scorer reads nothing else of it), the four (B, K) candidate
    vectors (midpoint, contig, circularity, contig length), the three (K,)
    per-row factors and the B scores, as ``chip_smoke.dense_bound`` counts
    them. A floor on the traffic, from which a measured time gives an
    achieved bandwidth."""
    b, k = candidates_per_step, k_subs
    obs_bytes = 4 * (k * (k - 1) // 2)
    vec_bytes = 4 * (4 * b * k + 3 * k + b)
    per_step = obs_bytes + vec_bytes
    return {"per_step_bytes": per_step, "per_cycle_bytes": per_step * steps}


def bandwidth_report(k_subs: int, candidates_per_step: int, steps: int,
                     cycle_seconds: float,
                     peak_bytes_per_s: float = H100_HBM_BYTES_PER_S) -> dict:
    """Achieved bandwidth of a measured EM cycle against the card's peak
    (an H100 80GB HBM3's 3.35 TB/s by default)."""
    traffic = dense_scorer_traffic(k_subs, candidates_per_step, steps)
    gbps = traffic["per_cycle_bytes"] / cycle_seconds / 1e9
    return {
        "cycle_seconds": round(cycle_seconds, 4),
        "traffic_gb": round(traffic["per_cycle_bytes"] / 1e9, 4),
        "achieved_gb_per_s": round(gbps, 2),
        "fraction_of_peak": round(gbps * 1e9 / peak_bytes_per_s, 6),
        "note": ("traffic counts the observed matrix's strict upper triangle and the "
                 "candidate vectors once a step; a host-bound or compute-bound cycle "
                 "reports a low fraction by construction"),
    }
