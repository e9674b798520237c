"""Pipeline parallelism for the Transition: GPipe-style microbatching over
three devices.

Port of ``scmgan_tpu/parallel/pipeline.py``.  The JAX package runs the
stages under ``shard_map`` over a 'pipe' mesh axis and moves payloads with
``lax.ppermute``; the port runs them from one process over a list of three
``torch.device``s, which may repeat (the single-controller GPipe idiom of
torchgpipe): each stage's parameters live on its device and each stage runs
on its own CUDA stream; payloads move with ``.to(..., non_blocking=True)``,
ordered by events.  At tick t, stage s works on microbatch t - s, over
``n_micro + 2`` ticks: the classic GPipe schedule with a
(S-1)/(n_micro+S-1) bubble.

The Transition's six-conv U-Net (models/world_model.py::transition) splits
into three two-conv stages.  Its long skips (conv1 -> conv6 and conv2 ->
conv5) mean later stages need early activations, so the payload is the
uniform triple (x, skip1, skip2): stage 0 fills the skips, stage 1 forwards
them, stage 2 consumes them.  (JAX pads the last stage's probabilities to
the payload's width so that every ``ppermute`` has one shape; the port's
last stage hands its probabilities to no one, so they keep theirs.)  The
stage convs are the port's ``_sn_conv`` and ``conv2d`` (cuDNN on the card),
as JAX's are XLA convs; no hand-written kernel is on this path.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from scmgan_tpu_torch.models.world_model import _sn_conv
from scmgan_tpu_torch.ops.conv import conv2d, leaky_relu
from scmgan_tpu_torch.ops.stochastic import hard_threshold

N_STAGES = 3
STAGE_CONVS = (("conv1", "conv2"), ("conv3", "conv4"), ("conv5", "conv6"))


def _stage0(params, payload, z, a_map):
    x = torch.cat([z, a_map], dim=-1)
    s1 = leaky_relu(_sn_conv(params["conv1"], x, circular=True))
    s2 = leaky_relu(_sn_conv(params["conv2"], s1, circular=True))
    return s2, s1, s2


def _stage1(params, payload, z, a_map):
    x, s1, s2 = payload
    x = leaky_relu(_sn_conv(params["conv3"], x, circular=True))
    x = leaky_relu(_sn_conv(params["conv4"], x, circular=True))
    return x, s1, s2


def _stage2(params, payload, z, a_map):
    x, s1, s2 = payload
    x = leaky_relu(_sn_conv(params["conv5"], torch.cat([x, s2], dim=-1),
                            circular=True))
    x = conv2d(params["conv6"], torch.cat([x, s1], dim=-1), circular=True)
    return torch.sigmoid(x), s1, s2


STAGES = (_stage0, _stage1, _stage2)
# One stream per (device, stage), made once: the caching allocator keeps
# its blocks per stream, so a fresh stream every call would allocate every
# activation anew with cudaMalloc.
_STREAMS: dict = {}


def _stream(device: torch.device, stage: int):
    key = (device.index if device.index is not None else torch.cuda.current_device(),
           stage)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device=device)
    return _STREAMS[key]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@torch.no_grad()
def pipeline_transition(params: dict, z: torch.Tensor, action_onehot: torch.Tensor,
                        devices: Sequence, n_micro: int = 4,
                        sample: bool = True) -> torch.Tensor:
    """Serving-mode transition over a pipeline of three devices.

    z: (B, H, W, latent); action_onehot: (B, A).  B must divide by
    ``n_micro``.  Returns, on z's device, what ``transition(train=False)``
    returns (hard-thresholded latents), or the sigmoid probabilities when
    ``sample=False``.
    """
    devices = [torch.device(d) for d in devices]
    if len(devices) != N_STAGES:
        raise ValueError(f"the pipeline has {N_STAGES} stages, got {len(devices)} devices")
    b, h, w, latent = z.shape
    if b % n_micro != 0:
        raise ValueError(f"batch {b} must divide into {n_micro} microbatches")
    bm = b // n_micro
    stage_params = [_to({k: params[k] for k in convs}, dev)
                    for convs, dev in zip(STAGE_CONVS, devices)]
    cuda = [dev.type == "cuda" for dev in devices]
    streams = [_stream(dev, i) if c else None
               for i, (dev, c) in enumerate(zip(devices, cuda))]
    a_map = action_onehot[:, None, None, :].to(z.dtype).expand(
        b, h, w, action_onehot.shape[-1])
    z0, a0 = z.to(devices[0]), a_map.to(devices[0])
    if cuda[0]:
        # stage 0's stream reads what the caller's stream wrote
        streams[0].wait_stream(torch.cuda.current_stream(devices[0]))

    n_ticks = n_micro + N_STAGES - 1
    inbox = [None] * N_STAGES          # (payload, event) each stage takes next
    outs = [None] * n_micro
    for t in range(n_ticks):
        sent = [None] * N_STAGES
        for s in range(N_STAGES):
            mb = t - s
            if not 0 <= mb < n_micro:
                continue
            with torch.cuda.stream(streams[s]) if cuda[s] else contextlib.nullcontext():
                if s == 0:
                    rows = slice(mb * bm, (mb + 1) * bm)
                    payload = _stage0(stage_params[0], None, z0[rows], a0[rows])
                else:
                    payload, ready = inbox[s]
                    if ready is not None:    # the producer ran on a card
                        if cuda[s]:
                            streams[s].wait_event(ready)
                        else:
                            ready.synchronize()
                    payload = tuple(p.to(devices[s], non_blocking=cuda[s])
                                    for p in payload)
                    if cuda[s]:   # made on the producer's stream, freed after ours
                        for p in payload:
                            p.record_stream(streams[s])
                    payload = STAGES[s](stage_params[s], payload, None, None)
                if s == N_STAGES - 1:
                    outs[mb] = payload[0]
                    continue
                ready = None
                if cuda[s]:
                    ready = torch.cuda.Event()
                    ready.record(streams[s])
                sent[s + 1] = (payload, ready)
        for s, msg in enumerate(sent):
            if msg is not None:
                inbox[s] = msg
    if cuda[-1]:
        current = torch.cuda.current_stream(devices[-1])
        current.wait_stream(streams[-1])
        for o in outs:
            o.record_stream(current)
    probs = torch.cat([o.to(z.device) for o in outs], dim=0)
    return hard_threshold(probs) if sample else probs
