"""Build and load the port's CUDA kernels.

The sources under ``scmgan_tpu_torch/csrc/`` have a plain ``extern "C"``
interface and include no PyTorch header.  One ``nvcc -c`` per source, all
started together, then one link make one shared library in seconds;
``ctypes`` loads it.  The library lands in ``build/scmgan_tpu_torch/`` under
a name keyed by a hash of the sources, headers and flags, so an edited
source rebuilds and a stale library is never loaded.  A build writes to
temporary names and renames the library into place: there is no lock file
for a cut-off build to leave behind.

Nothing here runs at import: the first kernel call builds (on the card's
machine; the CPU tests never reach it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "scmgan_tpu_torch"
SOURCES = ("fused_transition.cu", *(f"transition_h{n}.cu" for n in range(16, 129, 16)),
           "transition_head.cu", "fused_decoder.cu", "int8_transition.cu",
           *(f"int8_h{n}.cu" for n in range(32, 129, 16)), "int8_head.cu")
HEADERS = ("common.cuh", "mma.cuh", "wgmma.cuh", "tensor_map.cuh",
           "transition_conv.cuh", "int8_conv.cuh")
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and spill
# bytes; build() keeps that report beside the library (ptxas_report()).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 120

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every pointer and the stream as c_void_p, or ctypes would
# cut them to 32 bits.
_SIGNATURES = {
    "scm_transition_step": [_P] * 2 + [_P] * 6 + [_P] * 6 + [_P] + [_P] * 5
                           + [_I] * 11 + [_I, ctypes.c_ulonglong, _P],
    "scm_transition_smem": [_I],
    "scm_decode": [_P] * 6 + [_I] * 6 + [_P],
    "scm_decode_smem": [_I, _I],
    "scm_int8_step": [_P] * 3 + [_P] * 6 + [_P] * 8 + [_P] * 6 + [_P] * 5
                     + [_P] * 5 + [_I] * 8 + [_I] * 10 + [ctypes.c_ulonglong, _P],
    "scm_int8_smem": [_I],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libscmgan_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds, deadline: float) -> str:
    """Run the commands at once; raise with the first failure's output, else
    return their joined stdout and stderr.  No process outlives the call."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    report = []
    try:
        for c, p in zip(cmds, procs):
            try:
                out, err = p.communicate(timeout=max(deadline - time.monotonic(), 0))
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(f"nvcc timed out after {BUILD_TIMEOUT_S} s: "
                                   f"{c[-1]}") from e
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with code {p.returncode} on {c[-1]}:\n{err}")
            report.append(out + err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return "".join(report)


def build() -> Path:
    """Compile the sources (in parallel) and link them into one library,
    unless it is already built.  Raises with nvcc's output if a step fails
    or the whole build outlasts ``BUILD_TIMEOUT_S``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    deadline = time.monotonic() + BUILD_TIMEOUT_S
    try:
        report = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
                           for obj, name in zip(objs, SOURCES)], deadline)
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]], deadline)
        _report_path(out).write_text(report)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def _report_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".ptxas.txt")


def ptxas_report() -> list[dict]:
    """Per kernel of the built library, from ptxas -v: its name with the
    template arguments, registers a thread, static shared memory and spill
    bytes (stores + loads)."""
    path = _report_path(library_path())
    rows, cur = [], None
    for line in path.read_text().splitlines() if path.exists() else []:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1)), "registers": None,
                   "smem_static": 0, "spill_bytes": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem_static"] = int(m.group(1))
    return rows


def _kernel_name(mangled: str) -> str:
    """conv3x3_wgmma<128,0> or decode_kernel from an Itanium-mangled kernel
    name (integer template arguments only)."""
    m = re.search(r"(conv3x3_[a-z0-9]+|decode_kernel)(I(?:Li\d+E)+E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"Li(\d+)E", m.group(2) or "")
    return f"{m.group(1)}<{','.join(args)}>" if args else m.group(1)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
