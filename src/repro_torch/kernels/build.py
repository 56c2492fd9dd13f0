"""Builds the CUDA sources in kernels/csrc/ at first use and loads them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The libraries go into
``build/repro_torch_kernels/`` at the root of the checkout, named by a hash
of their source, the headers they include and the flags, so an unchanged
source is built once.  Every missing library is compiled at the same
time, one ``nvcc`` per source.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("lora_matmul", "flash_attention", "kd_loss", "quantize", "dp_clip",
           "rglru_scan", "rwkv6_scan", "floor")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if Path("/usr/local/cuda/bin/nvcc").exists() else None)
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library goes: named by a hash of the
    source, of the headers of ``csrc/`` it includes (``#include "..."``)
    and of the flags, so an edited header rebuilds every source that
    includes it."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src)
    for header in re.findall(rb'^\s*#include\s+"([^"]+)"', src, re.M):
        digest.update((CSRC / header.decode()).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compiles every source whose library is missing, all at once.

    Returns ``{name: {"seconds": wall time of its nvcc, "log": ptxas
    report}}`` for the sources it compiled; raises with nvcc's output if
    any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    running = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    report, failures = {}, []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    with _LOCK:
        if name not in _LIBS:
            path = library_path(name)
            if not path.exists():
                build_all()
            _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[name]


def check(rc: int, kernel: str) -> None:
    """Raises if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")


def check_tensors(kernel: str, device, dtype=torch.float32, **tensors):
    """Raises unless every tensor is a contiguous CUDA tensor of ``dtype``
    on ``device`` with the expected shape (given as ``name=(tensor,
    shape)``)."""
    for name, (t, shape) in tensors.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{kernel}: {name} must be a CUDA tensor on "
                             f"{device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def stream(device) -> int:
    """The handle of PyTorch's current stream on ``device`` (the capture
    stream while a CUDA graph records), read raw as PyTorch's own
    generated kernels read it: ``torch.cuda.current_stream(device)``
    builds a Stream object on every call, and on the card's host that
    took longer than the small kernels take on the card."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
