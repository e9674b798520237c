"""Tracing and per-phase timing.

Port of ``scmgan_tpu/utils/profiling.py``:

  * ``trace(logdir)``: ``torch.profiler`` around the block (the CPU, and the
    card where there is one), written to ``<logdir>/trace.json`` as a Chrome
    trace (Perfetto or chrome://tracing open it);
  * ``sync(tree)``: waits for the card that holds the first tensor of a
    nested structure (``torch.cuda.synchronize``); a CPU tree needs nothing;
  * ``PhaseTimer``: wall seconds per named phase, synchronized on request.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(logdir: str = "profile"):
    """Profile the block into ``<logdir>/trace.json``; yields ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _first_tensor(tree):
    if torch.is_tensor(tree):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for node in tree:
            found = _first_tensor(node)
            if found is not None:
                return found
    return None


def sync(tree) -> None:
    """Wait until the card that holds ``tree``'s first tensor is idle."""
    t = _first_tensor(tree)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class PhaseTimer:
    """Accumulates wall seconds per named phase.

        timer = PhaseTimer()
        with timer.phase("collect"):
            batch = ds.collect(...)
        with timer.phase("step", sync_tree=metrics):
            state, metrics = step(...)
        print(timer.summary())
    """

    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_tree=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_tree is not None:
                sync(sync_tree)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = ["phase timings:"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            total, n = self.totals[name], self.counts[name]
            lines.append(f"  {name:<20s} total {total:8.2f}s  x{n:<6d} "
                         f"avg {1e3 * total / max(n, 1):8.2f}ms")
        return "\n".join(lines)
