"""Logit compression for the KD b3 upload (paper SSIV.B.2).

Counterpart of the KD part of ``src/repro/core/compression.py``:

- top-k logit sparsification (``topk_compress``/``topk_decompress``);
- fused top-k + int8/int4 quantization (``topk_quantize``/
  ``topk_dequantize``; the CUDA kernel of kernels/quantize.py under the
  ``cuda`` kernel policy), int4 nibble-packed;
- int8/int4 symmetric per-row round trip (``quant_roundtrip``) with its
  exact wire size;
- softened labels (temperature + float16).

Each compressor returns its payload with the exact wire size; each
decompressor rebuilds the dense tensor the receiver trains on.  Everything
stays on the tensors' device.  ``quantize``/``dequantize`` (the Split
slice's packed activations) are not ported yet.
"""
from __future__ import annotations

import math

import torch

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
    from repro_torch.kernels import ops as kernel_ops
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


def _quantize_rows(x, bits: int):
    qmax = float((1 << (bits - 1)) - 1)
    xf = x.float()
    absmax = xf.abs().max(-1, keepdim=True).values
    # IEEE division on every device (kernels/ref.topk_quantize_rows_ref)
    scale = torch.clamp_min(absmax / absmax.new_tensor(qmax), 1e-12)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def quant_roundtrip(x, bits: int = 8):
    """Quantize -> dequantize with the wire size ``quantize`` would report
    for the same tensor (the packed payload is never built)."""
    q, scale = _quantize_rows(x, bits)
    return (q.float() * scale).to(x.dtype), quant_wire_bytes(x.shape, bits)


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
