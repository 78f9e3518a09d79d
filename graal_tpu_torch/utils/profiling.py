"""Named wall-clock stages of a run.

Counterpart of ``graal_tpu.utils.profiling.StageTimer``. A stage that
wraps device work must end in a host read or ``torch.cuda.synchronize()``
to time the device. The profiler trace and the bandwidth report wait for
ROADMAP A13.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict


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
