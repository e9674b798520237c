"""Metrics logging: the training loop's ``TimeSeries`` and the console
sparkline used by the MSE evaluator.

Port of ``scmgan_tpu/utils/timeseries.py``: a TimeSeries in the spirit of the
reference's ``logutil.TimeSeries`` (reference main.py:130,184,196,297,
``collect()`` / ``print_every()`` with TensorBoard mirroring through
tensorboardX where it imports), and the sparkline (main.py:841-844).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

import numpy as np

_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def sparkline(values, length: int = 80) -> str:
    """Unicode sparkline of a series, resampled to ``length`` columns."""
    vals = np.asarray(list(values), dtype=np.float64)
    if vals.size == 0:
        return ""
    if vals.size > length:
        idx = np.linspace(0, vals.size - 1, length).astype(int)
        vals = vals[idx]
    lo, hi = float(np.nanmin(vals)), float(np.nanmax(vals))
    if hi - lo < 1e-12:
        return _SPARK_CHARS[0] * len(vals)
    norm = (vals - lo) / (hi - lo)
    return "".join(_SPARK_CHARS[int(v * (len(_SPARK_CHARS) - 1))] for v in norm)


class TimeSeries:
    """Named-scalar collector with periodic console summaries and optional
    TensorBoard mirroring (via tensorboardX when available)."""

    def __init__(self, title: str, total_iters: Optional[int] = None,
                 tensorboard: bool = False, logdir: str = "runs"):
        self.title = title
        self.total_iters = total_iters
        self.start_time = time.time()
        self.series: Dict[str, List[float]] = collections.defaultdict(list)
        self.iteration = 0
        self._writer = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._writer = SummaryWriter(logdir)
            except Exception:
                self._writer = None

    def collect(self, name: str, value):
        v = float(value)
        self.series[name].append(v)
        if self._writer is not None:
            self._writer.add_scalar(name, v, len(self.series[name]))

    def collect_dict(self, metrics: dict):
        for k, v in metrics.items():
            self.collect(k, v)

    def print_every(self, n_iters: int = 10):
        self.iteration += 1
        if self.iteration % n_iters == 0:
            print(self.summary())

    def summary(self) -> str:
        elapsed = time.time() - self.start_time
        lines = [f"{self.title}  iter {self.iteration}"
                 + (f"/{self.total_iters}" if self.total_iters else "")
                 + f"  ({elapsed:.1f}s)"]
        for name in sorted(self.series):
            vals = self.series[name]
            recent = np.mean(vals[-10:])
            lines.append(f"  {name:<32s} {recent: .6f}  {sparkline(vals, 40)}")
        return "\n".join(lines)

    def __str__(self):
        return self.summary()

    def close(self):
        if self._writer is not None:
            self._writer.close()
