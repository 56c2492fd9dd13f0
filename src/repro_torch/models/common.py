"""Shared model building blocks: initializers, LayerNorm, GELU, the
LoRA-aware projection and the causal mask.

Counterpart of ``src/repro/models/common.py`` for what the GPT-2 path
uses.  Parameters are nested dicts of tensors; initializers draw on the
CPU from an explicit ``torch.Generator`` (so a seed gives the same weights
on every device) and move the result to ``device``.  All math is fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------- #
# Initializers
# --------------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape, device,
               scale: Optional[float] = None):
    """Truncated-normal (±2σ) fan-in init (LLM default), by inverting the
    normal CDF on uniform draws."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(shape, generator=gen) * (hi - lo) + lo
    t = (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return (t * std).to(device)


def embed_init(gen: torch.Generator, shape, device):
    return (torch.randn(shape, generator=gen) * 0.02).to(device)


# --------------------------------------------------------------------------- #
# Norms and activations
# --------------------------------------------------------------------------- #
def init_layernorm(d: int, device):
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    """fp32 LayerNorm with the biased variance, as the reference."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]


def gelu(x):
    """tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


# --------------------------------------------------------------------------- #
# LoRA-aware matmul
# --------------------------------------------------------------------------- #
def mm(x, w):
    """``x @ W`` for a plain weight, or the LoRA projection for a bound
    leaf ``{"w": W, "a": A, "b": B}`` (scale and dropout mask folded into
    a/b at bind time) through peft/lora.lora_apply, which dispatches to the
    fused CUDA kernel or the plain chain by the ambient kernel policy."""
    if isinstance(w, dict) and "a" in w:
        from repro_torch.peft.lora import lora_apply
        return lora_apply(x, w["w"], w["a"], w["b"])
    return x @ w


# --------------------------------------------------------------------------- #
# Masking
# --------------------------------------------------------------------------- #
def causal_mask(q_len: int, kv_len: int, q_offset: int = 0, window: int = 0,
                device=None):
    """(q_len, kv_len) boolean mask; True = attend.  ``q_offset`` is the
    absolute position of the first query; ``window`` > 0 keeps a trailing
    sliding window."""
    q_pos = torch.arange(q_len, device=device) + q_offset
    kv_pos = torch.arange(kv_len, device=device)
    m = kv_pos[None, :] <= q_pos[:, None]
    if window:
        m = m & (kv_pos[None, :] > q_pos[:, None] - window)
    return m
