"""Stand-ins for every model input on the ``meta`` device: shapes and
dtypes, nothing allocated.

Counterpart of ``src/repro/launch/specs.py`` (its ``ShapeDtypeStruct``s
become ``meta`` tensors).  The modality frontends are stubs: a VLM's
patch embeddings and an encoder-decoder's audio frames arrive as
precomputed bf16 arrays of the right shape, as in the reference; tokens
are int32."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    GB, S = shape.global_batch, shape.seq_len
    out = {}
    if cfg.n_image_tokens:
        # the image prefix takes part of the context budget
        out["img_embeds"] = _meta((GB, cfg.n_image_tokens,
                                   cfg.image_embed_dim), torch.bfloat16)
        out["tokens"] = _meta((GB, S - cfg.n_image_tokens), torch.int32)
    elif cfg.is_encoder_decoder:
        out["enc_embeds"] = _meta((GB, cfg.encoder_seq_len, cfg.d_model),
                                  torch.bfloat16)
        out["tokens"] = _meta((GB, S), torch.int32)
    else:
        out["tokens"] = _meta((GB, S), torch.int32)
    return out


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """One new token against a seq_len-deep cache."""
    return {"token": _meta((shape.global_batch,), torch.int32),
            "pos": _meta((), torch.int32)}


def abstract_cache(model, params_shape, shape: ShapeConfig,
                   dtype=torch.bfloat16):
    """The decode cache of ``model`` for ``shape`` on the ``meta`` device,
    through ``Model.init_cache`` on ``params_shape`` (meta parameters):
    an encoder-decoder runs its encoder on meta stub frames."""
    cfg = model.cfg
    GB = shape.global_batch
    batch = None
    if cfg.is_encoder_decoder:
        batch = {"enc_embeds": _meta((GB, cfg.encoder_seq_len, cfg.d_model),
                                     torch.bfloat16)}
    return model.init_cache(params_shape, GB, shape.seq_len, batch, dtype)
