"""Fused top-k + symmetric int quantization of rows: the KD b3 logit upload.

Counterpart of ``topk_quantize_rows`` in ``src/repro/kernels/quantize.py``.
The TPU kernel becomes the CUDA kernel of ``csrc/quantize.cu``:

    topk_quantize  <- topk_quantize_rows   k largest values per row (ties
                                           to the lower index), then an
                                           int8/int4 level and fp32 scale

For CUDA tensors ``topk_quantize`` launches the kernel (or raises); its
plain version is kernels/ref.topk_quantize_rows_ref, bit-identical.  The
per-row quantizers of the Split slice (``quantize_rows``,
``quantize_pack4_rows``) are not ported yet.

The wrapper adds one to ``LAUNCHES["topk_quantize"]`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = {"topk_quantize": 0}
K_MAX = 512
_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("quantize")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.topk_quantize.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.topk_quantize.restype = i32
        _LIB = lib
    return _LIB


def topk_quantize(x, k: int, bits: int = 8):
    """x fp32 (R, C) on CUDA -> (q int8 (R, k), idx int32 (R, k),
    scale fp32 (R, 1))."""
    R, C = x.shape
    if not 0 < k <= min(C, K_MAX):
        raise ValueError(f"topk_quantize: k={k} outside [1, min(C={C}, "
                         f"{K_MAX})]")
    if bits not in (4, 8):
        raise ValueError(f"topk_quantize: bits={bits} (expected 4 or 8)")
    build.check_tensors("topk_quantize", x.device, x=(x, (R, C)))
    q = torch.empty((R, k), device=x.device, dtype=torch.int8)
    idx = torch.empty((R, k), device=x.device, dtype=torch.int32)
    scale = torch.empty((R, 1), device=x.device, dtype=torch.float32)
    # the C side writes int8_t and int: hold the outputs to those types too
    build.check_tensors("topk_quantize", x.device, torch.int8, q=(q, (R, k)))
    build.check_tensors("topk_quantize", x.device, torch.int32,
                        idx=(idx, (R, k)))
    rc = _lib().topk_quantize(x.data_ptr(), q.data_ptr(), idx.data_ptr(),
                              scale.data_ptr(), R, C, k, bits,
                              build.stream(x.device))
    build.check(rc, "topk_quantize")
    LAUNCHES["topk_quantize"] += 1
    return q, idx, scale
