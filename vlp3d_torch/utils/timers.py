"""Phase timers + ETA reporting (solver_3dvlp.py:836-930, utils/eta.py).

The port's own copy of ``vlp3d/utils/timers.py``. The clock is the
host's. A PyTorch step returns once its kernels are queued, so a phase
that ends without a synchronise times the launches, not the card's
work. :class:`vlp3d_torch.train.solver.Solver` synchronises the device
before it stops ``iter`` on the steps it logs (every ``log_every``-th
and the last of an epoch, where the JAX solver reads a metric): those
steps time the whole step; the others time its launches and whatever
waiting the launch queue forces.
"""

from __future__ import annotations

import time
from collections import defaultdict


class PhaseTimers:
    """Accumulates wall-clock per phase (fetch/forward/backward/eval/iter)."""

    def __init__(self):
        self.times = defaultdict(list)
        self._start = {}

    def start(self, phase: str):
        self._start[phase] = time.perf_counter()

    def stop(self, phase: str):
        self.times[phase].append(time.perf_counter() - self._start[phase])

    def mean(self, phase: str) -> float:
        v = self.times[phase]
        return sum(v) / len(v) if v else 0.0

    def report(self) -> dict:
        return {f"mean_{k}_time": self.mean(k) for k in self.times}


def eta_str(mean_iter_time: float, remaining_iters: int) -> str:
    secs = int(mean_iter_time * remaining_iters)
    h, rem = divmod(secs, 3600)
    m, s = divmod(rem, 60)
    return f"{h}h {m}m {s}s"
