"""GELU MLP (GPT-2).  Counterpart of ``src/repro/models/mlp.py`` for
``activation="gelu"``; SwiGLU and squared ReLU are not ported yet."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import mm


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device):
    if cfg.activation != "gelu":
        raise NotImplementedError(
            f"activation {cfg.activation!r} is not ported yet")
    d, ff = cfg.d_model, cfg.d_ff
    return {"w_in": common.dense_init(gen, (d, ff), device),
            "w_out": common.dense_init(gen, (ff, d), device,
                                       scale=ff ** -0.5)}


def mlp_fwd(params, cfg: ModelConfig, x):
    return mm(common.gelu(mm(x, params["w_in"])), params["w_out"])
