"""Symmetric per-row int quantization: the Split-FedLLM boundary wire
format and the KD b3 logit upload.

Counterpart of ``src/repro/kernels/quantize.py``.  Its TPU kernels become
the CUDA kernels of ``csrc/quantize.cu``:

    quantize_rows  <- quantize_rows        per-row absmax -> int8/intN
                                           levels and an fp32 scale
    quant_roundtrip_rows <- quantize_rows  its levels dequantized in the
                                           same pass (float(q) * scale, in
                                           fp32): the Split boundary's
                                           compression.quant_roundtrip
    quantize_pack4 <- quantize_pack4_rows  the same at int4, two levels a
                                           byte (even column low nibble)
    topk_quantize  <- topk_quantize_rows   k largest values per row (ties
                                           to the lower index), then an
                                           int8/int4 level and fp32 scale

For CUDA tensors each wrapper launches its kernel (or raises); the plain
versions are kernels/ref.{quantize_rows_ref, quant_roundtrip_rows_ref,
quantize_pack4_rows_ref, topk_quantize_rows_ref}, bit-identical.

Each wrapper adds one to ``LAUNCHES[<its name>]`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = {"quantize_rows": 0, "quant_roundtrip_rows": 0,
            "quantize_pack4": 0, "topk_quantize": 0}
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
        lib.quantize_rows.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
        lib.quantize_rows.restype = i32
        lib.quant_roundtrip_rows.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
        lib.quant_roundtrip_rows.restype = i32
        lib.quantize_pack4.argtypes = [ptr] * 3 + [i32] * 2 + [ptr]
        lib.quantize_pack4.restype = i32
        _LIB = lib
    return _LIB


def quantize_rows(x, bits: int = 8):
    """x fp32 (R, C) on CUDA -> (q int8 (R, C), scale fp32 (R, 1))."""
    R, C = x.shape
    if bits not in (4, 8):
        raise ValueError(f"quantize_rows: bits={bits} (expected 4 or 8)")
    build.check_tensors("quantize_rows", x.device, x=(x, (R, C)))
    q = torch.empty((R, C), device=x.device, dtype=torch.int8)
    scale = torch.empty((R, 1), device=x.device, dtype=torch.float32)
    rc = _lib().quantize_rows(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                              R, C, bits, build.stream(x.device))
    build.check(rc, "quantize_rows")
    LAUNCHES["quantize_rows"] += 1
    return q, scale


def quant_roundtrip_rows(x, bits: int = 8, with_scale: bool = False):
    """x fp32 (R, C) on CUDA -> y fp32 (R, C), each row's int levels times
    its scale, in one pass; with ``with_scale``, (y, scale fp32 (R, 1))."""
    R, C = x.shape
    if bits not in (4, 8):
        raise ValueError(f"quant_roundtrip_rows: bits={bits} (expected 4 or "
                         f"8)")
    build.check_tensors("quant_roundtrip_rows", x.device, x=(x, (R, C)))
    y = torch.empty((R, C), device=x.device, dtype=torch.float32)
    scale = torch.empty((R, 1), device=x.device, dtype=torch.float32) \
        if with_scale else None
    rc = _lib().quant_roundtrip_rows(x.data_ptr(), y.data_ptr(),
                                     None if scale is None
                                     else scale.data_ptr(), R, C, bits,
                                     build.stream(x.device))
    build.check(rc, "quant_roundtrip_rows")
    LAUNCHES["quant_roundtrip_rows"] += 1
    return (y, scale) if with_scale else y


def quantize_pack4(x):
    """x fp32 (R, C even) on CUDA -> (packed uint8 (R, C/2), scale fp32
    (R, 1))."""
    R, C = x.shape
    if C % 2:
        raise ValueError(f"quantize_pack4: C={C} is odd (pad it first)")
    build.check_tensors("quantize_pack4", x.device, x=(x, (R, C)))
    q = torch.empty((R, C // 2), device=x.device, dtype=torch.uint8)
    scale = torch.empty((R, 1), device=x.device, dtype=torch.float32)
    rc = _lib().quantize_pack4(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                               R, C, build.stream(x.device))
    build.check(rc, "quantize_pack4")
    LAUNCHES["quantize_pack4"] += 1
    return q, scale


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
