"""Encoder-decoder assembly: Whisper-base's backbone [arXiv:2212.04356].

Counterpart of ``init_encoder``, ``init_encdec_params``, ``encode``,
``_cross_kvs``, ``encdec_forward``, ``decode_given_enc``,
``init_encdec_cache`` and ``encdec_decode_step`` in
``src/repro/models/encdec.py``.  The mel-spectrogram and conv frontend is
a stub, as in the reference: the encoder takes precomputed frame
embeddings ``enc_embeds`` (B, S_enc, d), adds fixed sinusoidal positions
and runs bidirectional attention blocks (flash, non-causal, under the
``cuda`` policy).  The decoder is models/transformer's stack built with
cross-attention blocks: each layer projects the encoder's output once
into its cross-attention's (k, v) and attends to it from the text
positions (flash with Sq != Skv).

    params = {...the decoder (models/transformer.py)...,
              "encoder": {"layers": [block, ...], "norm": {...}}}

The reference stacks the encoder's blocks for ``lax.scan``; here they are
a list in forward order (repro_torch/bridge.py converts).

Decode: ``init_encdec_cache`` runs the encoder once (the prefill) and
projects each decoder layer's cross-attention K/V from its output once,
``{"layers": [the self-attention KV caches], "xkv": [(k, v) a layer]}``;
each ``encdec_decode_step`` reuses them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models import attention, common, transformer
from repro_torch.runtime import resolve_device


def init_encoder(gen: torch.Generator, cfg: ModelConfig, device):
    """``cfg.n_encoder_layers`` attention blocks and the final norm."""
    return {"layers": [transformer.init_block(gen, cfg, ATTN, device)
                       for _ in range(cfg.n_encoder_layers)],
            "norm": common.init_norm(cfg.norm, cfg.d_model, device)}


def init_encdec_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """The decoder's parameters (with cross-attention blocks), then the
    encoder's under "encoder", drawn from ``gen`` in that order on
    ``device`` (None: CUDA, or raise)."""
    device = resolve_device(device)
    params = transformer.init_params(gen, cfg, device)
    params["encoder"] = init_encoder(gen, cfg, device)
    return params


def encode(params, cfg: ModelConfig, enc_embeds):
    """enc_embeds (B, S_enc, d), the stub frontend's output -> the
    encoder's states (B, S_enc, d), from ``params["encoder"]``."""
    B, Se, d = enc_embeds.shape
    pos = torch.arange(Se, device=enc_embeds.device)[None].expand(B, Se)
    h = enc_embeds + common.sinusoidal_positions(
        Se, d, enc_embeds.device).to(enc_embeds.dtype)[None]
    for bp in params["encoder"]["layers"]:
        h, _ = transformer.block_fwd(bp, cfg, ATTN, h, pos, causal=False)
    return common.apply_norm(cfg.norm, params["encoder"]["norm"], h)


def _cross_kvs(params, cfg: ModelConfig, enc_out):
    """Each decoder layer's cross-attention (k, v) of ``enc_out``."""
    if set(cfg.layer_kinds) != {ATTN}:
        raise ValueError("the encoder-decoder needs a decoder of attention "
                         "layers alone")
    return [attention.encode_cross_kv(lp["xattn"], cfg, enc_out)
            for lp in params["layers"]]


def encdec_forward(params, cfg: ModelConfig, tokens, enc_embeds):
    """The training and scoring forward: (logits (B, S, V), aux)."""
    return decode_given_enc(params, cfg, tokens,
                            encode(params, cfg, enc_embeds))


def decode_given_enc(params, cfg: ModelConfig, tokens, enc_out):
    """The decoder stack given the encoder's states: Split-FedLLM's
    boundary of an encoder-decoder model (the client runs the encoder,
    the server this).  Returns (logits (B, S, V), aux)."""
    xkvs = _cross_kvs(params, cfg, enc_out)
    h, positions = transformer.embed_tokens(params, cfg, tokens)
    aux = torch.zeros((), device=h.device)
    for lp, xkv in zip(params["layers"], xkvs):
        h, a = transformer.block_fwd(lp, cfg, ATTN, h, positions,
                                     enc_kv=xkv)
        if a is not None:
            aux = aux + a
    h = common.apply_norm(cfg.norm, params["final_norm"], h)
    return transformer.lm_logits(params, cfg, h), aux


def init_encdec_cache(params, cfg: ModelConfig, batch: int, max_len: int,
                      enc_embeds, dtype=torch.bfloat16):
    """The decoder's self-attention KV caches (transformer.init_cache, in
    ``dtype``) and each layer's cross-attention (k, v) of the encoded
    ``enc_embeds`` (B, S_enc, d), computed here once (kept in the
    encoder's dtype, as in the reference)."""
    cache = transformer.init_cache(cfg, batch, max_len, dtype,
                                   enc_embeds.device)
    cache["xkv"] = _cross_kvs(params, cfg, encode(params, cfg, enc_embeds))
    return cache


def encdec_decode_step(params, cfg: ModelConfig, cache, token, pos: int):
    """One decoder step: token (B,) at position ``pos`` -> (logits (B, V),
    cache), the cache updated in place.  As in the reference, no embed
    scale."""
    h = transformer.embed_token(params, cfg, token, pos, scale=False)
    layers = cache["layers"]
    for i, (lp, xkv) in enumerate(zip(params["layers"], cache["xkv"])):
        h, layers[i] = transformer.block_decode(lp, cfg, ATTN, h, layers[i],
                                                pos, enc_kv=xkv)
    h = common.apply_norm(cfg.norm, params["final_norm"], h)
    return transformer.lm_logits(params, cfg, h)[:, 0], cache
