"""Thread-pooled synchronous batch stepping of host-process environments.

Port of ``scmgan_tpu/envs/host/multi_env.py``.  The reference steps a batch
of host envs through a 4-worker thread pool (reference multi_env.py:8-39):
``step(actions)`` dispatches one ``env.step`` per env, auto-resets any env
that finishes, and returns stacked arrays.  Host emulators (ALE, SC2)
release the GIL inside their native step, so a thread pool overlaps them.

The port's synthetic envs never need this: they batch on the card
(``envs/base.py::rollout``).  This class is only for host-process envs, the
synchronous sibling of the asynchronous N-actor ingest
(``data/replay.py::HostReplayDatasource(n_actors=...)``).
"""

from __future__ import annotations

from concurrent import futures
from typing import List, Optional, Sequence

import numpy as np


class MultiHostEnvironment:
    """Steps ``envs`` in lock-step via a shared thread pool.

    Contract matches the reference's MultiEnvironment
    (reference multi_env.py:14-38):
      * ``reset()`` -> list of initial states
      * ``step(actions)`` -> (states (B,...), rewards (B,), dones (B,),
        infos tuple); an env whose episode ends is reset immediately and
        its FINAL state/reward/done are returned for that step.
      * ``action_space`` is env 0's.

    The pool is persistent (the reference rebuilds one per call,
    multi_env.py:9-11) and sized to the batch by default rather than the
    reference's hard-coded 4 workers.
    """

    def __init__(self, envs: Sequence, max_workers: Optional[int] = None):
        if not envs:
            raise ValueError("MultiHostEnvironment needs at least one env")
        self.envs: List = list(envs)
        self.batch_size = len(self.envs)
        self._pool = futures.ThreadPoolExecutor(
            max_workers=max_workers or self.batch_size)
        self.reset()
        self.action_space = getattr(self.envs[0], "action_space", None)

    def _map(self, fn, *iterables):
        return list(self._pool.map(fn, *iterables))

    def reset(self):
        return self._map(lambda env: env.reset(), self.envs)

    def step(self, actions):
        if len(actions) != self.batch_size:
            raise ValueError(
                f"got {len(actions)} actions for {self.batch_size} envs")

        def run_one_step(env, action):
            state, reward, done, info = env.step(int(action))
            if done:
                env.reset()  # reference multi_env.py:30-32
            return state, reward, done, info

        results = self._map(run_one_step, self.envs, actions)
        states, rewards, dones, infos = zip(*results)
        return (np.array(states), np.array(rewards), np.array(dones),
                infos)

    def close(self):
        self._pool.shutdown(wait=True)
        for env in self.envs:
            close = getattr(env, "close", None)
            if close:
                try:
                    close()
                except Exception:  # noqa: BLE001 - close the rest whatever one does
                    pass
