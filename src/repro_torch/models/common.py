"""Shared model building blocks: initializers, LayerNorm and RMSNorm,
GELU, SiLU and squared ReLU, rotary and sinusoidal position embeddings,
the LoRA-aware projection and the causal mask.

Counterpart of ``src/repro/models/common.py`` for what the port's model
paths use.  Parameters are nested dicts of tensors;
initializers draw on the CPU from an explicit ``torch.Generator`` (so a
seed gives the same weights on every device) and move the result to
``device``.  All math is fp32; the norms and RoPE take bf16 inputs too,
compute in fp32 and return the input's dtype, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import dtensor
from repro_torch.runtime import compute_dtype


# --------------------------------------------------------------------------- #
# Lookups and head splits, DTensor-aware (repro_torch/dtensor.py)
# --------------------------------------------------------------------------- #
def lookup(table, ids):
    """``table[ids]``: rows of a (V, d) table.  DTensors take it on each
    rank's shards, a vocab-parallel lookup (an id outside the rank's
    vocab shard gives zeros, the ranks' rows a partial sum over the axes
    sharding V), the ids' row shards kept: DTensor's index rule refuses
    ids whose dim 0 two mesh axes shard (the multi-pod batch) in some
    torch versions."""
    if not (dtensor.is_distributed(table) or dtensor.is_distributed(ids)):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = (table if dtensor.is_distributed(table) else ids).device_mesh
    table = dtensor.replicated(table, (1,), "models/common.lookup: the table's "
                       "width")
    vocab = [dtensor.shard_dim(p) == 0 for p in table.placements]
    rows = [dtensor.shard_dim(p) == 0 for p in ids.placements]
    ids = dtensor.relayout(ids, [p if r else Replicate()
                         for p, r in zip(ids.placements, rows)])
    t, i = table.to_local(), ids.to_local().long()
    for ax in (ax for ax, v in enumerate(vocab) if v):
        start = mesh.get_local_rank(ax) * t.shape[0]
        inside = (i >= start) & (i < start + t.shape[0])
        i = torch.where(inside, i - start, 0)
    out = t[i]
    if any(vocab):
        out = out * inside[..., None].to(out.dtype)
    shape = (*ids.shape, table.shape[1])
    return DTensor.from_local(
        out, mesh, [Partial() if v else p
                    for p, v in zip(ids.placements, vocab)],
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def merge_heads(x):
    """x (..., n, size) -> (..., n·size).  A DTensor's gradient is held
    to the result's layout, whose last dim is sharded only where x's
    heads were, so that DTensor can split it back into heads."""
    out = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if not dtensor.is_distributed(out) or not out.requires_grad:
        return out
    return dtensor._relabelled(out, out.placements)


def split_heads(x, n: int, size: int, site: str):
    """x (..., n·size) -> (..., n, size).  A DTensor whose last dim is
    sharded over mesh axes whose extents' product does not divide ``n``
    has that dim made whole first (``replicated``, noted at ``site``):
    DTensor cannot unflatten it."""
    if n % dtensor.shard_extent(x, -1):
        x = dtensor.replicated(x, (-1,), site)
    return x.reshape(*x.shape[:-1], n, size)


# --------------------------------------------------------------------------- #
# Initializers
# --------------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape, device,
               scale: Optional[float] = None):
    """Truncated-normal (±2σ) fan-in init (LLM default), by inverting the
    normal CDF on uniform draws.  On the ``meta`` device only the shape is
    made (Model.init_abstract): nothing is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(shape, generator=gen) * (hi - lo) + lo
    t = (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return (t * std).to(device)


def embed_init(gen: torch.Generator, shape, device):
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return (torch.randn(shape, generator=gen) * 0.02).to(device)


# --------------------------------------------------------------------------- #
# Norms and activations
# --------------------------------------------------------------------------- #
def init_layernorm(d: int, device):
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    """fp32 LayerNorm with the biased variance, in x's dtype, as the
    reference."""
    dt = compute_dtype(x.dtype)
    xc = x.to(dt)
    mu = xc.mean(-1, keepdim=True)
    var = ((xc - mu) ** 2).mean(-1, keepdim=True)
    return ((xc - mu) * torch.rsqrt(var + eps) * params["scale"].to(dt)
            + params["bias"].to(dt)).to(x.dtype)


def init_rmsnorm(d: int, device):
    return {"scale": torch.ones(d, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    """fp32 RMSNorm: x / sqrt(mean(x²) + eps) · scale, in x's dtype."""
    dt = compute_dtype(x.dtype)
    xc = x.to(dt)
    var = (xc * xc).mean(-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * params["scale"].to(dt)).to(x.dtype)


def init_norm(kind: str, d: int, device):
    return init_rmsnorm(d, device) if kind == "rmsnorm" \
        else init_layernorm(d, device)


def apply_norm(kind: str, params, x):
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


def gelu(x):
    """tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


def relu2(x):
    """Squared ReLU (RWKV-6's channel-mix; Nemotron-4)."""
    r = torch.relu(x)
    return r * r


# --------------------------------------------------------------------------- #
# Rotary position embeddings
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                       # (head_dim/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions broadcastable to (..., S).  The
    split-half convention of the reference: the first and second halves
    of D form the rotated pairs (not interleaved neighbours).  Computed in
    fp32 (fp64 for fp64), returned in x's dtype."""
    positions = dtensor.rows_like(positions, x)
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (D/2,)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    angles = angles[..., None, :]                           # (..., S, 1, D/2)
    dt = compute_dtype(x.dtype)
    cos, sin = torch.cos(angles).to(dt), torch.sin(angles).to(dt)
    x1, x2 = x.to(dt).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(n_pos: int, d: int, device=None):
    """Whisper's fixed sinusoidal embeddings (n_pos, d), fp32: the sines
    of the first d/2 columns, then the cosines, as the reference."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * dim / (d // 2 - 1 + 1e-9))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
NEG_INF = -1e30             # the score of a masked key (the reference's)


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
