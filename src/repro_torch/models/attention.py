"""Causal self-attention: multi-head with QKV bias and learned positions
(GPT-2), or grouped-query with RoPE, optionally with QKV bias (Qwen2),
per-head qk-norm (Qwen3) and a sliding window (RecurrentGemma's local
attention, Mixtral); the encoder-decoder's bidirectional self-attention
and cross-attention (Whisper).

Counterpart of ``init_attention``, ``attention_fwd``,
``attention_fwd_noncausal``, ``cross_attention_fwd`` and
``encode_cross_kv`` in ``src/repro/models/attention.py``: projections
through models/common.mm
(LoRA-bound leaves go through the fused LoRA kernel), attention through
kernels/ops.mha_attention (the flash kernels under the ``cuda`` policy,
which group the KV heads and mask the window themselves).  qk-norm is an
RMSNorm over each head's D of q and of k, after the bias and the reshape
and before RoPE, with a (D,) scale shared by the heads.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import common
from repro_torch.models.common import mm


def init_attention(gen: torch.Generator, cfg: ModelConfig, device,
                   cross: bool = False):
    """A cross-attention (``cross``) has no QKV bias and no qk-norm."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": common.dense_init(gen, (d, h * hd), device),
        "wk": common.dense_init(gen, (d, kv * hd), device),
        "wv": common.dense_init(gen, (d, kv * hd), device),
        "wo": common.dense_init(gen, (h * hd, d), device,
                                scale=(h * hd) ** -0.5),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros(h * hd, device=device)
        p["bk"] = torch.zeros(kv * hd, device=device)
        p["bv"] = torch.zeros(kv * hd, device=device)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones(hd, device=device)
        p["k_norm"] = torch.ones(hd, device=device)
    return p


def attention_fwd(params, cfg: ModelConfig, x, positions=None,
                  window: int = 0, use_rope=None):
    """x: (B, S, d) -> (B, S, d).  ``window`` > 0 -> sliding window;
    ``positions`` (B, S) or (S,) feed RoPE (default 0 .. S-1)."""
    rope = cfg.use_rope if use_rope is None else use_rope
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = mm(x, params["wq"])
    k = mm(x, params["wk"])
    v = mm(x, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, h, hd)
    k = k.reshape(B, S, kv, hd)
    v = v.reshape(B, S, kv, hd)
    if "q_norm" in params:
        q = common.rmsnorm({"scale": params["q_norm"]}, q)
        k = common.rmsnorm({"scale": params["k_norm"]}, k)
    if rope:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    out = kernel_ops.mha_attention(q, k, v, causal=True, window=window)
    return mm(out.reshape(B, S, h * hd), params["wo"])


def attention_fwd_noncausal(params, cfg: ModelConfig, x, positions):
    """Bidirectional self-attention (Whisper's encoder): x (B, S, d) ->
    (B, S, d).  As the reference, no QKV bias and no qk-norm; RoPE when
    the config uses it."""
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = mm(x, params["wq"]).reshape(B, S, h, hd)
    k = mm(x, params["wk"]).reshape(B, S, kv, hd)
    v = mm(x, params["wv"]).reshape(B, S, kv, hd)
    if cfg.use_rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    out = kernel_ops.mha_attention(q, k, v, causal=False)
    return mm(out.reshape(B, S, h * hd), params["wo"])


def cross_attention_fwd(params, cfg: ModelConfig, x, enc_kv):
    """Decoder cross-attention: x (B, S, d) against ``enc_kv`` = (k, v),
    each (B, Se, KV, D) from encode_cross_kv; non-causal."""
    B, S, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = mm(x, params["wq"]).reshape(B, S, h, hd)
    k, v = enc_kv
    out = kernel_ops.mha_attention(q, k, v, causal=False)
    return mm(out.reshape(B, S, h * hd), params["wo"])


def encode_cross_kv(params, cfg: ModelConfig, enc_out):
    """The encoder output (B, Se, d) projected once into a cross-attention's
    (k, v), each (B, Se, KV, D)."""
    B, Se, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return (mm(enc_out, params["wk"]).reshape(B, Se, kv, hd),
            mm(enc_out, params["wv"]).reshape(B, Se, kv, hd))
