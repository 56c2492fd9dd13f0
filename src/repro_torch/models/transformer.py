"""Decoder-only GPT-2 transformer: learned positions, pre-LayerNorm blocks,
tied embeddings.

Counterpart of ``init_params``, ``embed_tokens``, ``forward``,
``lm_logits`` and the layer-range functions of Split-FedLLM
(``n_groups_of``, ``forward_groups``) in
``src/repro/models/transformer.py`` for the dense attention family, where
a pattern group is one layer.  The reference stacks the layers and scans
them; here ``params["layers"]`` is a list of per-layer dicts and the
forward is a Python loop (models/../bridge.py converts between the two
layouts).

    {"embed": (V, d), "pos_embed": (P, d), ["lm_head": (d, V)],
     "final_norm": {"scale", "bias"},
     "layers": [{"norm1", "attn": {wq, wk, wv, wo, bq, bk, bv},
                 "norm2", "mlp": {w_in, w_out}}, ...]}
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, mlp
from repro_torch.runtime import resolve_device


def check_supported(cfg: ModelConfig) -> None:
    """Raises NotImplementedError for what the port does not run yet."""
    missing = []
    if cfg.family != "dense" or cfg.layer_pattern is not None:
        missing.append(f"family {cfg.family!r} / layer pattern")
    if cfg.is_moe or cfg.is_encoder_decoder or cfg.n_image_tokens:
        missing.append("MoE, encoder-decoder and VLM models")
    if cfg.use_rope or cfg.qk_norm:
        missing.append("RoPE and qk-norm")
    if cfg.norm != "layernorm" or cfg.activation != "gelu":
        missing.append(f"norm {cfg.norm!r} / activation {cfg.activation!r}")
    if cfg.embed_scale:
        missing.append("embedding scale")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: " + "; ".join(missing))


def init_block(gen: torch.Generator, cfg: ModelConfig, device):
    d = cfg.d_model
    return {"norm1": common.init_layernorm(d, device),
            "attn": attention.init_attention(gen, cfg, device),
            "norm2": common.init_layernorm(d, device),
            "mlp": mlp.init_mlp(gen, cfg, device)}


def block_fwd(p, cfg: ModelConfig, x, positions):
    h = common.layernorm(p["norm1"], x)
    x = x + attention.attention_fwd(p["attn"], cfg, h, positions,
                                    window=cfg.sliding_window)
    h = common.layernorm(p["norm2"], x)
    return x + mlp.mlp_fwd(p["mlp"], cfg, h)


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Random GPT-2 parameters on ``device`` (None: CUDA, or raise)."""
    check_supported(cfg)
    device = resolve_device(device)
    V, d = cfg.vocab_size, cfg.d_model
    params = {
        "embed": common.embed_init(gen, (V, d), device),
        "final_norm": common.init_layernorm(d, device),
        "pos_embed": common.embed_init(
            gen, (cfg.max_position_embeddings, d), device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(gen, (d, V), device)
    params["layers"] = [init_block(gen, cfg, device)
                        for _ in range(cfg.n_layers)]
    return params


def embed_tokens(params, cfg: ModelConfig, tokens, pos_offset: int = 0):
    """tokens: (B, S) int -> (h (B, S, d), positions (B, S))."""
    B, S = tokens.shape
    h = params["embed"][tokens]
    positions = torch.arange(S, device=tokens.device) + pos_offset
    h = h + params["pos_embed"][positions][None]
    return h, positions[None].expand(B, S)


def lm_logits(params, cfg: ModelConfig, h):
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return common.mm(h, w)


def forward(params, cfg: ModelConfig, tokens):
    """Returns (logits (B, S, V), aux_loss) — aux is 0 for dense models."""
    h, positions = embed_tokens(params, cfg, tokens)
    h, aux = forward_groups(params, cfg, h, positions, 0,
                            len(params["layers"]))
    h = common.layernorm(params["final_norm"], h)
    return lm_logits(params, cfg, h), aux


# --------------------------------------------------------------------------- #
# Layer-range application (Split-FedLLM)
# --------------------------------------------------------------------------- #
def n_groups_of(cfg: ModelConfig) -> int:
    """Pattern groups of the trunk: one per layer in the dense family."""
    check_supported(cfg)
    return cfg.n_layers


def forward_groups(params, cfg: ModelConfig, h, positions, start: int,
                   end: int, include_tail: bool = False):
    """Apply groups [start, end) of ``params["layers"]`` to the embedded
    hidden ``h``; returns (h, aux), aux 0 for dense models.  The dense
    family has no tail layers, so ``include_tail`` adds none."""
    for p in params["layers"][start:end]:
        h = block_fwd(p, cfg, h, positions)
    if include_tail:
        for p in params.get("tail", ()):
            h = block_fwd(p, cfg, h, positions)
    return h, torch.zeros((), device=h.device)
