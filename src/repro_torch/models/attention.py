"""Causal self-attention: multi-head with QKV bias and learned positions
(GPT-2), or grouped-query with RoPE, optionally with QKV bias (Qwen2),
per-head qk-norm (Qwen3) and a sliding window (RecurrentGemma's local
attention, Mixtral); the encoder-decoder's bidirectional self-attention
and cross-attention (Whisper).

Counterpart of ``init_attention``, ``attention_fwd``,
``attention_fwd_noncausal``, ``cross_attention_fwd``,
``encode_cross_kv``, ``init_kv_cache`` and ``attention_decode`` in
``src/repro/models/attention.py``: projections
through models/common.mm
(LoRA-bound leaves go through the fused LoRA kernel), attention through
kernels/ops.mha_attention (the flash kernels under the ``cuda`` policy,
which group the KV heads and mask the window themselves).  qk-norm is an
RMSNorm over each head's D of q and of k, after the bias and the reshape
and before RoPE, with a (D,) scale shared by the heads.

One-token decode (``attention_decode``) scores the query against the KV
cache with plain matmuls in fp32, as the reference does with an einsum
outside any Pallas kernel; its projections still go through
models/common.mm.
"""
from __future__ import annotations

import torch

from repro_torch import dtensor
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import common
from repro_torch.models.common import mm
from repro_torch.runtime import compute_dtype

# where a DTensor's projected heads are made whole (common.split_heads)
_SITE_Q = "models/attention: q heads not divisible by the model axis"
_SITE_KV = "models/attention: k/v heads not divisible by the model axis"


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
    q = common.split_heads(q, h, hd, _SITE_Q)
    k = common.split_heads(k, kv, hd, _SITE_KV)
    v = common.split_heads(v, kv, hd, _SITE_KV)
    if "q_norm" in params:
        q = common.rmsnorm({"scale": params["q_norm"]}, q)
        k = common.rmsnorm({"scale": params["k_norm"]}, k)
    if rope:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    q = dtensor.hint(q, ("pod", "data"), None, "model", None)
    k = dtensor.hint(k, ("pod", "data"), None, None, None)
    out = kernel_ops.mha_attention(q, k, v, causal=True, window=window)
    return mm(common.merge_heads(out), params["wo"])


def attention_fwd_noncausal(params, cfg: ModelConfig, x, positions):
    """Bidirectional self-attention (Whisper's encoder): x (B, S, d) ->
    (B, S, d).  As the reference, no QKV bias and no qk-norm; RoPE when
    the config uses it."""
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = common.split_heads(mm(x, params["wq"]), h, hd, _SITE_Q)
    k = common.split_heads(mm(x, params["wk"]), kv, hd, _SITE_KV)
    v = common.split_heads(mm(x, params["wv"]), kv, hd, _SITE_KV)
    if cfg.use_rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    out = kernel_ops.mha_attention(q, k, v, causal=False)
    return mm(common.merge_heads(out), params["wo"])


def cross_attention_fwd(params, cfg: ModelConfig, x, enc_kv):
    """Decoder cross-attention: x (B, S, d) against ``enc_kv`` = (k, v),
    each (B, Se, KV, D) from encode_cross_kv; non-causal."""
    B, S, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = common.split_heads(mm(x, params["wq"]), h, hd, _SITE_Q)
    k, v = enc_kv
    out = kernel_ops.mha_attention(q, k, v, causal=False)
    return mm(common.merge_heads(out), params["wo"])


def encode_cross_kv(params, cfg: ModelConfig, enc_out):
    """The encoder output (B, Se, d) projected once into a cross-attention's
    (k, v), each (B, Se, KV, D)."""
    B, Se, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return (common.split_heads(mm(enc_out, params["wk"]), kv, hd, _SITE_KV),
            common.split_heads(mm(enc_out, params["wv"]), kv, hd, _SITE_KV))


# --------------------------------------------------------------------------- #
# KV cache (decode)
# --------------------------------------------------------------------------- #
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, window: int = 0,
                  dtype=torch.bfloat16, device=None):
    """{"k", "v"}: zeros (batch, size, KV, D) in ``dtype``; a ring buffer
    of size min(max_len, window) when ``window`` > 0, a linear cache of
    ``max_len`` slots otherwise (``init_kv_cache`` of the reference)."""
    size = min(max_len, window) if window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(params, cfg: ModelConfig, x, cache, pos: int,
                     window: int = 0):
    """One-token decode (``attention_decode`` of the reference): x (B, 1,
    d) at absolute position ``pos`` -> (out (B, 1, d), cache).  The
    token's k and v, cast to the cache's dtype, are written into ``cache``
    in place at slot ``pos % size`` (a ring, ``window`` > 0) or
    ``min(pos, size - 1)`` (linear: past the end the last slot is
    overwritten, as in the reference); the query attends to the valid
    slots, idx < min(pos + 1, size) for a ring and idx <= pos for a linear
    cache, the scores and softmax in fp32 (fp64 beside fp64 weights)."""
    B = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = mm(x, params["wq"])
    k = mm(x, params["wk"])
    v = mm(x, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = common.split_heads(q, h, hd, _SITE_Q)
    k = common.split_heads(k, kv, hd, _SITE_KV)
    v = common.split_heads(v, kv, hd, _SITE_KV)
    if "q_norm" in params:
        q = common.rmsnorm({"scale": params["q_norm"]}, q)
        k = common.rmsnorm({"scale": params["k_norm"]}, k)
    if cfg.use_rope:
        posv = torch.full((1,), pos, device=x.device)
        q = common.apply_rope(q, posv, cfg.rope_theta)
        k = common.apply_rope(k, posv, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    size = ck.shape[1]
    slot = pos % size if window > 0 else min(pos, size - 1)
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    n_valid = min(pos + 1, size) if window else pos + 1
    valid = torch.arange(size, device=x.device) < n_valid
    dt = q.dtype
    q = dtensor.replicated(q, (2,), "models/attention.attention_decode: q "
                          "heads grouped by KV head") \
        if kv % dtensor.shard_extent(q, 2) else q
    qr = q.reshape(B, kv, h // kv, hd)                      # (B, KV, G, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qr, ck.to(dt))
    scores = scores.to(compute_dtype(dt)) * hd ** -0.5
    scores = torch.where(valid, scores, common.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(cv.dtype).to(dt),
                       cv.to(dt))
    return mm(out.reshape(B, 1, h * hd), params["wo"]), cache
