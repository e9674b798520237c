#!/usr/bin/env python3
"""Where the port's kernels spend their time, by ablation, on one card.

    python3 scripts/torch_kernel_ablation.py      # from the repository root, on a CUDA machine

Builds the kernel library several times into build/ablation/, each time with
one part of the bf16 transition, int8 transition and decoder kernels cut out
of the sources (their MMAs, their epilogues, their activation loads, or the
transitions' weight loads after a block's first tile), and times each build
at B = 100, 64x64: the bf16 transition per conv layer (torch.profiler device
times) at hidden 128 and 48, the int8 transition likewise (the teacher's
static sum_first packing at hidden 128, the calibrated h48 student's joint
packing of the fidelity gate), and the decoder (CUDA events).  A cut kernel
computes garbage; only its time is read.  The difference to the full kernel
bounds what the cut part costs where it does not overlap the rest.  Prints
the card line and one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from scmgan_tpu_torch.data.datasource import allocate_datasource  # noqa: E402
from scmgan_tpu_torch.ops.kernels import _build  # noqa: E402
from scmgan_tpu_torch.ops.kernels import fused_decoder as fd  # noqa: E402
from scmgan_tpu_torch.ops.kernels import fused_transition as ft  # noqa: E402
from scmgan_tpu_torch.ops.kernels import int8_transition as i8  # noqa: E402
from scmgan_tpu_torch.train.checkpoint import load_model, load_pytree  # noqa: E402
from scmgan_tpu_torch.train.distill import calibrate_student  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ablation"
BATCH = 100

# variant -> {source: [(text, replacement)]}; every edit must apply.
TMA = ("            mbar_arrive_expect_tx(&full[stage], L::STAGE_BYTES);\n"
       "            tma_load_2d(base_s + L::B_OFF + stage * L::STAGE_BYTES, &wmap, &full[stage], 0,\n"
       "                        (c * 9 + tap) * p.ldo + p.n_off);")
TMA_S8 = ("          mbar_arrive_expect_tx(&full[stage], L::STAGE_BYTES);\n"
          "          tma_load_2d(base_s + L::B_OFF + stage * L::STAGE_BYTES, &wmap, &full[stage], 0,\n"
          "                      t * p.ldo + p.n_off);")
VARIANTS = {
    "full": {},
    "no_mma": {
        "transition_conv.cuh": [
            ("for (int ks = 0; ks < KC; ++ks) WgmmaRS<BN>::run(acc[i], frag[i][ks], desc + 2 * ks);", "")],
        "int8_conv.cuh": [
            ("      if (4 * t + k < STEPS) WgmmaS8<BN>::run(acc[i][S], frag[buf][k], desc + 2 * k);",
             "      ;")],
        "fused_decoder.cu": [
            ("                mma_bf16_16816(acc[u][0], a, bw[0][0], bw[0][1]);\n"
             "                mma_bf16_16816(acc[u][1], a, bw[1][0], bw[1][1]);", ""),
            ("          mma_bf16_16816(acc2[i], a, b0, b1);", "")],
    },
    "no_epilogue": {
        "transition_conv.cuh": [
            ("    // ---------------- epilogue ----------------", "    if (tile >= 0) continue;")],
        "int8_conv.cuh": [
            ("    // ---------------- epilogue ----------------", "    if (tile >= 0) continue;")],
        "fused_decoder.cu": [
            ("    // Logits -> bf16, staged in mid_s as [pixel][color], then stored.",
             "    if (tile >= 0) continue;")],
    },
    "no_activation_loads": {
        "transition_conv.cuh": [
            ("      cp_async_16(dst0 + slot * 128", "      if (n < 0) cp_async_16(dst0 + slot * 128")],
        "int8_conv.cuh": [
            ("            cp_async_16(dst0 + slot * 128",
             "            if (n < 0) cp_async_16(dst0 + slot * 128")],
        "fused_decoder.cu": [
            ("    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {", "    if (H < 0) {")],
    },
    "no_weight_stream": {
        "transition_conv.cuh": [
            (TMA, "            if (tile == (int)blockIdx.x) {\n" + TMA
             + "\n            } else {\n              mbar_arrive(&full[stage]);\n            }")],
        "int8_conv.cuh": [
            (TMA_S8, "          if (tile == (int)blockIdx.x) {\n" + TMA_S8
             + "\n          } else {\n            mbar_arrive(&full[stage]);\n          }")],
    },
}


def build(name: str, edits: dict) -> Path:
    """Copy the sources, apply the edits, compile and link; return the library."""
    src = OUT / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    for fname, reps in edits.items():
        text = (src / fname).read_text()
        for old, new in reps:
            if old not in text:
                raise RuntimeError(f"{name}: edit does not apply to {fname}: {old[:60]!r}")
            text = text.replace(old, new)
        (src / fname).write_text(text)
    nvcc = _build._nvcc()
    objs = [src / (Path(s).stem + ".o") for s in _build.SOURCES]
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        results = list(pool.map(lambda a: subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(a[0]), str(src / a[1])],
            capture_output=True, text=True), zip(objs, _build.SOURCES)))
    for r in results:
        if r.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{r.stderr}")
    lib = src / "lib.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)], check=True)
    return lib


def use(lib_path: Path):
    """Point the wrappers at this library."""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _build._lib = lib


def layer_us(fn, kernel: str, steps: int = 5) -> list[float]:
    """Mean device microseconds of each of the six conv launches of a step
    (the device kernels whose name holds ``kernel``)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    return [round(float(t), 1) for t in np.array(times).reshape(steps, 6).mean(0)]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ablation: no CUDA device is available")
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(2) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    model = load_model(cs.BUNDLE, device="cuda")
    student = load_pytree(f"{cs.STUDENT}/model-transition.npz", "cuda")
    packs = {"h128": ft.pack_transition_weights(model.transition, 16, 5),
             "h48": ft.pack_transition_weights(student, 16, 5)}
    ds = allocate_datasource(cs.ENV, seed=cs.SEED, device="cuda")
    packs_i8 = {"h128": i8.pack_quantized_weights(model.transition),
                "h48": calibrate_student(model, student, ds, cs.SEED).packed}
    pd = fd.pack_decoder_weights(model.decoder, 16)
    rng = np.random.default_rng(cs.SEED)
    z, a = cs.binary_latents(rng, BATCH), cs.onehot_actions(rng, BATCH, 5)
    zi = z.to(torch.int8)
    result = {}
    for name, lib in libs.items():
        use(lib)
        row = {}
        with torch.inference_mode():
            for key, pt in packs.items():
                row[f"transition_{key}_ms"] = cs.cuda_ms(lambda: ft.fused_transition(pt, z, a))
                row[f"transition_{key}_layers_us"] = layer_us(
                    lambda: ft.fused_transition(pt, z, a), "conv3x3_wgmma")
            for key, pq in packs_i8.items():
                row[f"int8_{key}_ms"] = cs.cuda_ms(lambda: i8.int8_transition(pq, zi, a))
                row[f"int8_{key}_layers_us"] = layer_us(
                    lambda: i8.int8_transition(pq, zi, a), "conv3x3_s8")
            row["decoder_ms"] = cs.cuda_ms(lambda: fd.fused_decode(pd, z), iters=50)
        result[name] = row
        print(name, json.dumps(row), flush=True)
    print(card)
    print(json.dumps({"batch": BATCH, "variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
