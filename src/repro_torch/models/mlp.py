"""Dense MLP blocks: SwiGLU (RecurrentGemma) and GELU (GPT-2).
Counterpart of ``src/repro/models/mlp.py``; squared ReLU is not ported
yet."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import mm


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.activation == "swiglu":
        return {"w_gate": common.dense_init(gen, (d, ff), device),
                "w_in": common.dense_init(gen, (d, ff), device),
                "w_out": common.dense_init(gen, (ff, d), device,
                                           scale=ff ** -0.5)}
    if cfg.activation != "gelu":
        raise NotImplementedError(
            f"activation {cfg.activation!r} is not ported yet")
    return {"w_in": common.dense_init(gen, (d, ff), device),
            "w_out": common.dense_init(gen, (ff, d), device,
                                       scale=ff ** -0.5)}


def mlp_fwd(params, cfg: ModelConfig, x):
    if cfg.activation == "swiglu":
        g = common.silu(mm(x, params["w_gate"]))
        return mm(mm(x, params["w_in"]) * g, params["w_out"])
    return mm(common.gelu(mm(x, params["w_in"])), params["w_out"])
