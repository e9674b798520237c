#!/usr/bin/env python3
"""Time both transition kernels of several trees of the port on one card.

    python3 scripts/time_transition_trees.py ROOT [ROOT ...]   # on a CUDA machine

Each ROOT is a directory that holds a ``scmgan_tpu_torch`` package (a
checkout, or a ``git archive`` of one).  Name a root twice to interleave
two versions in one call: parent, change, change, parent.  Each root runs
in a process of its own, which builds that root's kernels into its own
``build/`` and times the transition step at B = 100, 64x64 on the same
seeded random weights and inputs, at hidden 128 and 48 with 5 and 16
actions, and the int8 transition (static ``sum_first`` packing, sigmoid
head) at both widths with 5 actions: ms per call by CUDA events (three
rounds of 50 calls) and the device microseconds of each of the step's six
conv launches (torch.profiler, mean of 5 steps; retried when the profiler
drops an event).  Prints the card line and one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CASES = ((128, 5), (128, 16), (48, 5), (48, 16))
INT8_ACTIONS = 5
BATCH, SEED = 100, 20261017


def timed(step, kernel: str) -> dict:
    """ms per call of ``step`` and the mean device microseconds of each of
    its six launches of the kernel whose name holds ``kernel``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            step()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / 50)
    for _ in range(3):      # the profiler now and then drops a kernel event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
        us = [e.device_time for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if len(us) == 30:
            break
    else:
        raise RuntimeError(f"the profiler saw {len(us)} of 30 {kernel} launches")
    return {"ms": ms, "layers_us": [float(t) for t in np.array(us).reshape(5, 6).mean(0)]}


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import scmgan_tpu_torch
    from scmgan_tpu_torch.models.world_model import init_transition
    from scmgan_tpu_torch.ops.kernels import int8_transition as i8
    from scmgan_tpu_torch.ops.kernels.fused_transition import (
        fused_transition, pack_transition_weights)

    assert Path(scmgan_tpu_torch.__file__).resolve().is_relative_to(Path(root).resolve())
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    z = torch.from_numpy((rng.random((BATCH, 64, 64, 16)) > 0.5).astype(np.float32)).cuda()
    zi = z.to(torch.int8)
    out = {}
    with torch.inference_mode():
        for hidden, acts in CASES:
            gen = torch.Generator(device="cuda").manual_seed(SEED + hidden + acts)
            params = init_transition(gen, 16, acts, hidden=hidden)
            pt = pack_transition_weights(params, 16, acts)
            a = torch.from_numpy(np.eye(acts, dtype=np.float32)[
                rng.integers(0, acts, BATCH)]).cuda()
            out[f"h{hidden}_a{acts}"] = timed(lambda: fused_transition(pt, z, a),
                                              "conv3x3_wgmma")
            if acts == INT8_ACTIONS:
                pq = i8.pack_quantized_weights(params)
                out[f"int8_h{hidden}_a{acts}"] = timed(
                    lambda: i8.int8_transition(pq, zi, a, head="sigmoid"), "conv3x3_s8")
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])))
        return 0
    roots = sys.argv[1:]
    if not roots:
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_transition_trees: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    runs = []
    for root in roots:
        r = subprocess.run([sys.executable, __file__, "--child", root], capture_output=True,
                           text=True, timeout=600)
        if r.returncode:
            raise SystemExit(f"{root}: exit {r.returncode}\n{r.stderr[-4000:]}")
        runs.append({"root": root, **json.loads(r.stdout.strip().splitlines()[-1])})
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
