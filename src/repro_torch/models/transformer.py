"""Decoder-only LM: GPT-2 (learned positions, pre-LayerNorm blocks of
GELU MLP and multi-head attention); the dense GQA families (Qwen2 with
QKV bias, Qwen3 with qk-norm, Mistral-Large; RoPE, RMSNorm, SwiGLU;
Nemotron-4 with LayerNorm and a squared-ReLU MLP); the MoE families
(Mixtral with a sliding window, Qwen3-MoE with qk-norm; models/moe.py in
place of the MLP); the Griffin hybrid of RecurrentGemma (RG-LRU and
local-attention layers in a repeating pattern, the embedding scaled by
sqrt(d)); RWKV-6 (``rwkv6`` blocks of time-mix and squared-ReLU
channel-mix, LayerNorm, an untied head); the VLM image prefix (LLaVA:
``img_proj`` projects the stub image embeddings, prepended to the text);
and the decoder of the encoder-decoder (Whisper: each block adds a
cross-attention on the encoder's output; models/encdec.py holds the
encoder).  A soft prompt (peft/prompt.py) is prepended unprojected, and
a block whose parameters carry an "adapter" (peft/adapters.py) applies
it after the MLP residual.

Counterpart of ``init_params``, ``init_block``, ``block_fwd``,
``embed_tokens``, ``forward``, ``lm_logits``, the decode path
(``init_block_cache``, ``block_decode``, ``init_cache``,
``decode_step``) and the layer-range functions of Split-FedLLM
(``n_groups_of``, ``forward_groups``) in
``src/repro/models/transformer.py``.  The reference stacks the layers of
each pattern position over the G full pattern groups and scans them, and
keeps the remainder in ``tail``; here ``params["layers"]`` is a list of
per-layer dicts in forward order (layer g·P + pi of group g at pattern
position pi, then the tail) and the forward is a Python loop
(repro_torch/bridge.py converts between the two layouts).  Layer i has
kind ``cfg.layer_kinds[i]``; an RG-LRU layer keeps its recurrent block
under "attn", and an RWKV-6 layer its time-mix and channel-mix weights
together under "attn" with no "mlp", as the reference does.  A MoE
model's "mlp" holds its router and stacked experts.

    {"embed": (V, d), ["pos_embed": (P, d)], ["lm_head": (d, V)],
     ["img_proj": (d_img, d)], "final_norm": {...},
     "layers": [{"norm1", "attn": {wq, wk, wv, wo, [bq, bk, bv],
                                   [q_norm, k_norm]}
                                  | {w_rec_in, ..., lambda, w_out}
                                  | {mu_r, ..., w_r, ..., cm_w_r},
                 ["xnorm", "xattn": {wq, wk, wv, wo}],
                 "norm2", ["mlp": {[w_gate], w_in, w_out}
                                  | {router, [w_gate], w_in, w_out}],
                 ["adapter": {w_down, w_up}]},
                ...],
     ["encoder": {"layers": [...], "norm": {...}}]}

The decode cache is ``{"layers": [...]}``, one entry a layer in the
order of ``params["layers"]``: an attention layer's {"k", "v"} (B, size,
KV, D) in the cache dtype (models/attention.init_kv_cache: a ring of the
window's size for a windowed layer), an RG-LRU layer's {"h", "conv"}
and an RWKV-6 layer's {"S", "x_tm", "x_cm"}, the recurrent states in
fp32 (fp64 for an fp64 cache).  ``decode_step`` updates the cache it is
given in place and returns it.

The forward's ``aux`` is the sum over layers of the MoE load-balance
terms (0 without MoE layers): a scalar, or one entry a routing group
(models/moe.routing_groups) under the per-example and stacked-clients
scopes of kernels/ops.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import dtensor
from repro_torch.configs.base import (ATTN, LOCAL_ATTN, RGLRU, RWKV6,
                                     ModelConfig)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention, common, mlp, moe, rglru, rwkv6
from repro_torch.peft import adapters
from repro_torch.runtime import compute_dtype, resolve_device

KINDS = (ATTN, LOCAL_ATTN, RGLRU, RWKV6)


def check_supported(cfg: ModelConfig) -> None:
    """Raises NotImplementedError for a config outside what the port
    runs: every registry config runs, a family, layer kind, norm or
    activation the port has no code for does not."""
    missing = []
    if cfg.family not in ("dense", "moe", "hybrid", "ssm", "vlm", "audio"):
        missing.append(f"family {cfg.family!r}")
    unported = sorted(set(cfg.layer_kinds) - set(KINDS))
    if unported:
        missing.append(f"layer kinds {unported}")
    if cfg.norm not in ("layernorm", "rmsnorm") or \
            cfg.activation not in ("gelu", "swiglu", "relu2"):
        missing.append(f"norm {cfg.norm!r} / activation {cfg.activation!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: " + "; ".join(missing))


def _group_split(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, int]:
    """(pattern, n_full_groups, n_tail_layers)."""
    pat = cfg.layer_pattern or (ATTN,)
    n_groups = cfg.n_layers // len(pat)
    return pat, n_groups, cfg.n_layers - n_groups * len(pat)


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, device,
               cross: bool = False):
    """One layer's weights; ``cross`` adds a cross-attention ("xnorm",
    "xattn"), drawn after the mixer and before the MLP."""
    d = cfg.d_model
    if kind == RWKV6:                     # the block embeds its channel-mix
        return {"norm1": common.init_norm(cfg.norm, d, device),
                "attn": rwkv6.init_rwkv6(gen, cfg, device),
                "norm2": common.init_norm(cfg.norm, d, device)}
    p = {"norm1": common.init_norm(cfg.norm, d, device),
         "attn": rglru.init_rglru(gen, cfg, device) if kind == RGLRU
         else attention.init_attention(gen, cfg, device)}
    if cross:
        p["xnorm"] = common.init_norm(cfg.norm, d, device)
        p["xattn"] = attention.init_attention(gen, cfg, device, cross=True)
    p["norm2"] = common.init_norm(cfg.norm, d, device)
    p["mlp"] = moe.init_moe(gen, cfg, device) if cfg.is_moe \
        else mlp.init_mlp(gen, cfg, device)
    return p


def _stream(x):
    """The residual stream's layout on a DTensor step: batch on the data
    axes, the rest whole (a row-parallel projection's partial sums
    reduced); a plain tensor as it is."""
    return dtensor.hint(x, ("pod", "data"), None, None)


def block_fwd(p, cfg: ModelConfig, kind: str, x, positions, enc_kv=None,
              causal: bool = True):
    """Returns (x, aux): aux the MoE load-balance term, None without.
    ``enc_kv`` (the encoder's (k, v) for this layer) adds the
    cross-attention after the mixer; ``causal=False`` makes an attention
    layer bidirectional, without a window."""
    h = common.apply_norm(cfg.norm, p["norm1"], x)
    if kind == RWKV6:
        out, _ = rwkv6.timemix_fwd(p["attn"], cfg, h)
        x = _stream(x + out)
        h = common.apply_norm(cfg.norm, p["norm2"], x)
        return _stream(x + rwkv6.channelmix_fwd(p["attn"], cfg, h)), None
    if kind == RGLRU:
        out, _ = rglru.rglru_fwd(p["attn"], cfg, h)
    elif kind == ATTN and not causal:
        out = attention.attention_fwd_noncausal(p["attn"], cfg, h, positions)
    else:
        window = cfg.local_window if kind == LOCAL_ATTN else cfg.sliding_window
        out = attention.attention_fwd(p["attn"], cfg, h, positions,
                                      window=window)
    x = _stream(x + out)
    if enc_kv is not None:
        hx = common.apply_norm(cfg.norm, p["xnorm"], x)
        x = _stream(x + attention.cross_attention_fwd(p["xattn"], cfg, hx,
                                                      enc_kv))
    h = common.apply_norm(cfg.norm, p["norm2"], x)
    aux = None
    if cfg.is_moe:
        m, aux = moe.moe_fwd(p["mlp"], cfg, h)
    else:
        m = mlp.mlp_fwd(p["mlp"], cfg, h)
    x = _stream(x + m)
    if "adapter" in p:                    # bottleneck adapter (PEFT)
        x = adapters.adapter_fwd(p["adapter"], x)
    return x, aux


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None):
    """One layer's decode cache: K/V slots in ``dtype`` for an attention
    layer, recurrent states in fp32 (``compute_dtype(dtype)``) for an
    RG-LRU or RWKV-6 layer."""
    if kind in (ATTN, LOCAL_ATTN):
        window = cfg.local_window if kind == LOCAL_ATTN else cfg.sliding_window
        return attention.init_kv_cache(cfg, batch, max_len, window, dtype,
                                       device)
    if kind == RGLRU:
        return rglru.init_rglru_cache(cfg, batch, compute_dtype(dtype), device)
    if kind == RWKV6:
        return rwkv6.init_rwkv_cache(cfg, batch, compute_dtype(dtype), device)
    raise ValueError(kind)


def block_decode(p, cfg: ModelConfig, kind: str, x, cache, pos: int,
                 enc_kv=None):
    """One-token decode of a layer: x (B, 1, d) at position ``pos`` ->
    (x, the layer's cache).  As in the reference, a bottleneck adapter
    is not applied (block_fwd applies it)."""
    h = common.apply_norm(cfg.norm, p["norm1"], x)
    if kind == RWKV6:
        out, S = rwkv6.timemix_fwd(p["attn"], cfg, h, state=cache["S"],
                                   x_last=cache["x_tm"])
        x = _stream(x + out)
        h2 = common.apply_norm(cfg.norm, p["norm2"], x)
        cm = rwkv6.channelmix_fwd(p["attn"], cfg, h2, x_last=cache["x_cm"])
        return _stream(x + cm), {"S": S, "x_tm": h[:, -1].to(cache["x_tm"].dtype),
                        "x_cm": h2[:, -1].to(cache["x_cm"].dtype)}
    if kind == RGLRU:
        out, cache = rglru.rglru_decode(p["attn"], cfg, h, cache)
    else:
        window = cfg.local_window if kind == LOCAL_ATTN else cfg.sliding_window
        out, cache = attention.attention_decode(p["attn"], cfg, h, cache, pos,
                                                window=window)
    x = _stream(x + out)
    if enc_kv is not None:
        hx = common.apply_norm(cfg.norm, p["xnorm"], x)
        x = _stream(x + attention.cross_attention_fwd(p["xattn"], cfg, hx,
                                                      enc_kv))
    h = common.apply_norm(cfg.norm, p["norm2"], x)
    if cfg.is_moe:
        m, _ = moe.moe_fwd(p["mlp"], cfg, h)
    else:
        m = mlp.mlp_fwd(p["mlp"], cfg, h)
    return x + m, cache


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Random parameters on ``device`` (None: CUDA, or raise), drawn on
    the CPU from ``gen`` layer by layer in forward order."""
    check_supported(cfg)
    device = resolve_device(device)
    V, d = cfg.vocab_size, cfg.d_model
    params = {
        "embed": common.embed_init(gen, (V, d), device),
        "final_norm": common.init_norm(cfg.norm, d, device),
    }
    if not cfg.use_rope:
        params["pos_embed"] = common.embed_init(
            gen, (cfg.max_position_embeddings, d), device)
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(gen, (d, V), device)
    if cfg.n_image_tokens:
        params["img_proj"] = common.dense_init(
            gen, (cfg.image_embed_dim or d, d), device)
    params["layers"] = [init_block(gen, cfg, kind, device,
                                   cross=cfg.is_encoder_decoder)
                        for kind in cfg.layer_kinds]
    return params


def embed_tokens(params, cfg: ModelConfig, tokens, img_embeds=None,
                 prefix_embeds=None, pos_offset: int = 0):
    """tokens: (B, S) int -> (h (B, S', d), positions (B, S')).  A VLM's
    image embeddings (B, n_img, d_img), projected by ``img_proj`` (a plain
    matmul: no LoRA target), are prepended, then the soft prompt's
    ``prefix_embeds`` (B, n_virtual, d) unprojected: S' = n_virtual +
    n_img + S, and the positions run over all of them."""
    h = common.lookup(params["embed"], tokens)
    if cfg.embed_scale:
        h = h * cfg.d_model ** 0.5
    if img_embeds is not None:
        proj = img_embeds.to(h.dtype) @ params["img_proj"]
        h = torch.cat([proj, h], dim=1)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device) + pos_offset
    if not cfg.use_rope:
        h = h + params["pos_embed"][positions][None]
    return h, positions[None].expand(B, S)


def lm_logits(params, cfg: ModelConfig, h):
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    h = dtensor.hint(h, ("pod", "data"), None, None)
    return common.mm(h, w)


REMAT = ("none", "full", "selective")
# the products whose outputs the "selective" recomputation saves: the plain
# matrix products; a CUDA kernel's output is recomputed, as the
# reference's ``dots_with_no_batch_dims_saveable`` recomputes a pallas_call
SELECTIVE_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default)


def _selective_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in SELECTIVE_SAVED \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _selective_contexts():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_selective_policy)


def _remat_group(fn, remat: str):
    """``fn`` recomputed in the backward (non-reentrant
    ``torch.utils.checkpoint``): ``full`` saves only its inputs,
    ``selective`` also the plain products' outputs (SELECTIVE_SAVED).
    The recompute runs in the backward, outside the forward's kernel
    policy and clients scopes, so it re-enters them
    (kernels/ops.scope_state): otherwise it would take another path."""
    from torch.utils.checkpoint import checkpoint

    state = kernel_ops.scope_state()

    def scoped(*args):
        with kernel_ops.restored_scopes(state):
            return fn(*args)

    extra = {"context_fn": _selective_contexts} if remat == "selective" \
        else {}
    return lambda *args: checkpoint(scoped, *args, use_reentrant=False,
                                    **extra)


def forward(params, cfg: ModelConfig, tokens, img_embeds=None,
            prefix_embeds=None, remat: str = "none"):
    """Returns (logits (B, S', V), aux_loss) — the MoE layers' summed
    load-balance terms, 0 without MoE layers; S' counts the prepended
    image and prefix positions (embed_tokens).

    ``remat`` (the reference's ``forward(..., remat=)``): ``"none"``, or
    each full pattern group recomputed in the backward, ``"full"``
    keeping only the group's input and ``"selective"`` also the outputs
    of its plain matrix products (aten mm, addmm, bmm); the tail layers
    are not recomputed, as in the reference.  The launch counters count
    a recompute's kernel launches."""
    if remat not in REMAT:
        raise ValueError(f"unknown remat {remat!r} (expected one of "
                         f"{REMAT})")
    h, positions = embed_tokens(params, cfg, tokens, img_embeds,
                                prefix_embeds)
    h = dtensor.hint(h, ("pod", "data"), None, None)
    n_groups = _group_split(cfg)[1]
    if remat == "none":
        h, aux = forward_groups(params, cfg, h, positions, 0, n_groups,
                                include_tail=True)
    else:
        def apply_group(g, h, aux):
            h, a = forward_groups(params, cfg, h, positions, g, g + 1)
            return h, aux + a

        aux = torch.zeros((), device=h.device)
        for g in range(n_groups):
            h, aux = _remat_group(lambda h, aux, g=g: apply_group(g, h, aux),
                                  remat)(h, aux)
        h, a = forward_groups(params, cfg, h, positions, n_groups, n_groups,
                              include_tail=True)
        aux = aux + a
    h = common.apply_norm(cfg.norm, params["final_norm"], h)
    return lm_logits(params, cfg, h), aux


# --------------------------------------------------------------------------- #
# Decode
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """The decode cache of every layer (module docstring), zeros."""
    return {"layers": [init_block_cache(cfg, kind, batch, max_len, dtype,
                                        device)
                       for kind in cfg.layer_kinds]}


def embed_token(params, cfg: ModelConfig, token, pos: int, scale: bool = True):
    """token (B,) at position ``pos`` -> h (B, 1, d): the embedding, scaled
    by sqrt(d) where the config says so and ``scale``, plus the learned
    position without RoPE."""
    h = common.lookup(params["embed"], token)[:, None]
    if scale and cfg.embed_scale:
        h = h * cfg.d_model ** 0.5
    if not cfg.use_rope:
        h = h + params["pos_embed"][pos][None, None]
    return h


def decode_step(params, cfg: ModelConfig, cache, token, pos: int):
    """token: (B,) int; ``pos`` the tokens' absolute position (a Python
    int).  Returns (logits (B, V), cache), the cache updated in place.
    A VLM decodes text alone, as the reference does."""
    h = embed_token(params, cfg, token, pos)
    layers = cache["layers"]
    for i, (lp, kind) in enumerate(zip(params["layers"], cfg.layer_kinds)):
        h, layers[i] = block_decode(lp, cfg, kind, h, layers[i], pos)
    h = common.apply_norm(cfg.norm, params["final_norm"], h)
    return lm_logits(params, cfg, h)[:, 0], cache


# --------------------------------------------------------------------------- #
# Layer-range application (Split-FedLLM)
# --------------------------------------------------------------------------- #
def n_groups_of(cfg: ModelConfig) -> int:
    """Full pattern groups of the trunk (the tail layers after the last
    one are not counted): one per layer in the dense family and in
    RWKV-6, one per (rglru, rglru, local_attn) in the Griffin hybrid."""
    check_supported(cfg)
    return _group_split(cfg)[1]


def group_len(cfg: ModelConfig) -> int:
    """Layers per pattern group: pattern group g holds layers [g·P,
    (g + 1)·P) of ``params["layers"]``."""
    return len(_group_split(cfg)[0])


def forward_groups(params, cfg: ModelConfig, h, positions, start: int,
                   end: int, include_tail: bool = False):
    """Apply pattern groups [start, end) of ``params["layers"]`` (layers
    [start·P, end·P)) to the embedded hidden ``h``, then, with
    ``include_tail``, the tail layers that follow the last full group;
    returns (h, aux), aux the sum of the MoE layers' load-balance terms
    (0 without).  ``params`` may hold a Split half: its layers are
    counted from the start of that half."""
    pat, _, n_tail = _group_split(cfg)
    P, layers = len(pat), params["layers"]
    idx = list(range(start * P, end * P))
    if include_tail:
        idx += range(len(layers) - n_tail, len(layers))
    aux = torch.zeros((), device=h.device)
    for i in idx:
        h, a = block_fwd(layers[i], cfg, pat[i % P], h, positions)
        if a is not None:
            aux = aux + a
    return h, aux
