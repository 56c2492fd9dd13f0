"""Knowledge and activation compression (paper SSIV.B.2 / SSIV.C.2).

Counterpart of ``src/repro/core/compression.py``:

- top-k logit sparsification (``topk_compress``/``topk_decompress``);
- fused top-k + int8/int4 quantization (``topk_quantize``/
  ``topk_dequantize``; the CUDA kernel of kernels/quantize.py under the
  ``cuda`` kernel policy), int4 nibble-packed;
- int8/int4 symmetric per-row quantization (``quantize``/``dequantize``,
  int4 nibble-packed) and its straight-through round trip
  (``quant_roundtrip``, the Split boundary, one pass), both through the
  per-row CUDA kernels of kernels/quantize.py under the ``cuda`` policy,
  with the exact wire size;
- softened labels (temperature + float16).

Each compressor returns its payload with the exact wire size; each
decompressor rebuilds the dense tensor the receiver trains on.  Everything
stays on the tensors' device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kernel_ops

NEG_FILL = -1e9


def _n_rows(x) -> int:
    return math.prod(x.shape[:-1])


# --------------------------------------------------------------------------- #
# Top-k logits
# --------------------------------------------------------------------------- #
def topk_compress(logits, k: int):
    """logits (..., V) -> ({"values", "indices", "dim"}, wire_bytes).
    Ties go to the lower index, as ``lax.top_k``."""
    x = logits.float()
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k].to(torch.int32)
    wire = vals.numel() * 4 + idx.numel() * 4
    return {"values": vals, "indices": idx, "dim": logits.shape[-1]}, wire


def topk_decompress(comp):
    """Dense logits; missing entries get ``NEG_FILL`` so the softmax mass
    matches the transmitted top-k support."""
    vals = comp["values"]
    dense = torch.full(vals.shape[:-1] + (comp["dim"],), NEG_FILL,
                       dtype=vals.dtype, device=vals.device)
    return _scatter_last(dense, comp["indices"], vals)


def _scatter_last(dense, idx, vals):
    return dense.scatter(-1, idx.long(), vals)


# --------------------------------------------------------------------------- #
# Fused top-k + int quantization
# --------------------------------------------------------------------------- #
def topk_quantize(logits, k: int, bits: int = 8):
    """logits (..., V) -> ({"values_q", "indices", "scale", "dim", "k"},
    wire).  The wire size is the packed payload: k levels (nibble-packed
    for int4) + k int32 indices + one fp32 scale per row."""
    if bits not in (4, 8):
        raise ValueError(f"topk_quantize: bits={bits} (expected 4 or 8)")
    q, idx, scale = kernel_ops.topk_quantize(logits, k, bits=bits)
    if bits == 4:
        q = pack_int4(q)
    wire = q.numel() + idx.numel() * 4 + _n_rows(logits) * 4
    return {"values_q": q, "indices": idx, "scale": scale,
            "dim": logits.shape[-1], "k": k}, int(wire)


def topk_dequantize(comp):
    q = comp["values_q"]
    if q.dtype == torch.uint8:                      # int4-packed
        q = unpack_int4(q, comp["k"])
    vals = q.float() * comp["scale"]
    dense = torch.full(vals.shape[:-1] + (comp["dim"],), NEG_FILL,
                       dtype=torch.float32, device=vals.device)
    return _scatter_last(dense, comp["indices"], vals)


# --------------------------------------------------------------------------- #
# int4 nibble packing (two values per byte)
# --------------------------------------------------------------------------- #
def pack_int4(q):
    """q int8 (..., C) with values in [-7, 7] -> uint8 (..., ceil(C/2)):
    even column in the low nibble, odd column in the high nibble (two's
    complement); odd C is zero-padded."""
    C = q.shape[-1]
    if C % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    u = q.to(torch.int32) & 0xF
    pair = u.reshape(*u.shape[:-1], -1, 2)
    return (pair[..., 0] | (pair[..., 1] << 4)).to(torch.uint8)


def unpack_int4(packed, C: int):
    """Inverse of ``pack_int4``: uint8 (..., P) -> int8 (..., C)."""
    p = packed.to(torch.int32)
    inter = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1)
    inter = inter.reshape(*p.shape[:-1], -1)[..., :C]
    return torch.where(inter > 7, inter - 16, inter).to(torch.int8)


# --------------------------------------------------------------------------- #
# Symmetric per-row quantization
# --------------------------------------------------------------------------- #
def quant_wire_bytes(shape, bits: int) -> int:
    """Exact transmittable size of a per-row quantized (..., d) tensor:
    nibble-packed payload (ceil per row for int4) + 4-byte row scales."""
    rows = math.prod(shape[:-1])
    return rows * ((shape[-1] * bits + 7) // 8) + rows * 4


def quantize(x, bits: int = 8):
    """(..., d) -> ({"q" | "q4", "scale"[, "dim"]}, wire_bytes): per-row
    absmax levels; int4 is nibble-packed, so ``wire`` is the payload's
    size exactly (two levels a byte, ceil per row, plus 4-byte row
    scales)."""
    if bits not in (4, 8):
        raise ValueError(f"quantize: bits={bits} (expected 4 or 8)")
    if bits == 4:
        if x.shape[-1] % 2 == 0:
            # quantize and pack in one pass
            packed, scale = kernel_ops.quantize_pack4(x)
        else:
            q, scale = kernel_ops.quantize(x, bits)
            packed = pack_int4(q)
        return {"q4": packed, "scale": scale,
                "dim": x.shape[-1]}, quant_wire_bytes(x.shape, bits)
    q, scale = kernel_ops.quantize(x, bits)
    return {"q": q, "scale": scale}, quant_wire_bytes(x.shape, bits)


def dequantize(comp):
    if "q4" in comp:
        q = unpack_int4(comp["q4"], comp["dim"])
        return q.float() * comp["scale"]
    return comp["q"].float() * comp["scale"]


def quant_roundtrip(x, bits: int = 8):
    """Quantize -> dequantize with the wire size ``quantize`` would report
    for the same tensor (the packed payload is never built).  One pass of
    kernels/ops.quant_roundtrip (a single CUDA kernel under the ``cuda``
    policy, which writes the dequantized values and no levels)."""
    return (kernel_ops.quant_roundtrip(x, bits).to(x.dtype),
            quant_wire_bytes(x.shape, bits))


# --------------------------------------------------------------------------- #
# Softened labels
# --------------------------------------------------------------------------- #
def soften(logits, temperature: float = 2.0):
    """Temperature-softened probabilities in fp16 (half the wire size)."""
    p = torch.softmax(logits.float() / temperature, dim=-1)
    return p.half(), p.numel() * 2


def soft_to_logits(soft_p, temperature: float = 2.0):
    """Invert to (scaled) logits for the KD loss: T · log p."""
    return temperature * torch.log(torch.clamp_min(soft_p.float(), 1e-8))
