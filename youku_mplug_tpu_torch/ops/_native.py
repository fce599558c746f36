"""Build and load the package's hand-written CUDA kernels.

The sources in ``youku_mplug_tpu_torch/csrc/*.cu`` have a plain C interface
and are compiled by ``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per
source, all started together, then linked into one shared library loaded
with ``ctypes``.  The build happens at the first kernel
launch of a process (never at import), into
``build/kernels/<hash of sources and flags>/`` at the repository root, so a
fresh checkout builds everything on first use and an edited source never
loads a stale library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "decode_attention.cu")
_HEADERS = ("hopper.cuh",)  # included by the flash sources
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v")
BUILD_ROOT = _PKG.parent / "build" / "kernels"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # ... scale, period, causal, head_dim, slopes (or null), [the
    # forward's splits and their scratch,] stream
    "ymt_flash_fwd_bf16": [_P] * 5 + [_I] * 5 + [_LL] * 12
    + [_F, _I, _I, _I, _P, _I, _P, _P, _P],
    # head_dim, alibi, the int it writes the count to
    "ymt_flash_fwd_blocks_per_sm": [_I, _I, ctypes.POINTER(_I)],
    # o, dout, delta, B, H, Sq, the strides of o and dout, head_dim, stream
    "ymt_flash_bwd_delta_bf16": [_P] * 3 + [_I] * 3 + [_LL] * 6 + [_I, _P],
    # head_dim, alibi, kind (0 dq, 1 dk/dv, 2 short-query dk/dv), the int
    # it writes the count to
    "ymt_flash_bwd_blocks_per_sm": [_I, _I, _I, ctypes.POINTER(_I)],
    "ymt_flash_bwd_dq_bf16": [_P] * 7 + [_I] * 5 + [_LL] * 15
    + [_F, _I, _I, _I, _P, _P],
    # ... scale, period, causal, head_dim, slopes, short-query splits,
    # stream
    "ymt_flash_bwd_dkv_bf16": [_P] * 8 + [_I] * 5 + [_LL] * 18
    + [_F, _I, _I, _I, _P, _I, _P],
    # q, k, v (each pointer, batch and head stride), ckv, kv_scales (or
    # null), out, cache_len, valid_from, B, n, M, lidx, scale, head_dim,
    # alibi, stream
    "ymt_decode_attention": [_P, _LL, _LL] * 3 + [_P] * 5 + [_I] * 4
    + [_F, _I, _I, _P],
}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from source at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_PKG / "csrc" / name).read_bytes())
    return h.hexdigest()[:16]


def _library_path() -> Path:
    return BUILD_ROOT / _digest() / "libymt_kernels.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless this exact build exists.  Returns
    (library path, seconds spent compiling, nvcc's resource report)."""
    so = _library_path()
    if so.exists():
        return so, 0.0, (so.parent / "nvcc.log").read_text()
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # compile to a private name, then rename: a concurrent process never
    # sees (or loads) a half-written library
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        objs = [Path(tmp) / (name + ".o") for name in _SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(_PKG / "csrc" / name), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for name, obj in zip(_SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(name, proc.returncode, log) for name, proc, log
                  in zip(_SOURCES, procs, logs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        out = Path(tmp) / so.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        (so.parent / "nvcc.log").write_text("".join(logs))
        os.replace(out, so)
    return so, time.perf_counter() - t0, (so.parent / "nvcc.log").read_text()


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def ptxas_report(log: str) -> dict:
    """Each kernel build's registers and spill bytes from nvcc's
    ``-Xptxas -v`` report (``build()``'s log), keyed by template instance
    as ``flash_bwd_dq<96,plain>``, ``flash_bwd_dkv_short<96,plain>``,
    ``decode_attn<64,alibi,int8>``, ``flash_fwd_merge<80>`` or
    ``flash_bwd_delta<96>``: {"registers", "spill_stores",
    "spill_loads"}."""
    builds, entry, spill = {}, "?", (None, None)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(flash_fwd|flash_bwd_dq|flash_bwd_dkv_short|"
                          r"flash_bwd_dkv|decode_attn)_kernelILi(\d+)ELb"
                          r"([01])E(?:Lb([01])E)?", line)
            merge = re.search(r"(flash_fwd_merge|flash_bwd_delta)_kernel"
                              r"ILi(\d+)E", line)
            entry = (f"{m[1]}<{m[2]},{'alibi' if m[3] == '1' else 'plain'}"
                     f"{',int8' if m[4] == '1' else ''}>" if m
                     else f"{merge[1]}<{merge[2]}>" if merge else "?")
        elif "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            spill = (int(m[1]), int(m[2])) if m else (None, None)
        elif re.search(r"Used \d+ registers", line):
            regs = int(re.search(r"Used (\d+) registers", line)[1])
            builds[entry] = {"registers": regs, "spill_stores": spill[0],
                             "spill_loads": spill[1]}
    return builds
