"""Dense MLP blocks: SwiGLU (RecurrentGemma, Qwen2, Qwen3, Mistral),
GELU (GPT-2) and squared ReLU (Nemotron-4).  Counterpart of
``src/repro/models/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch import dtensor
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
    return {"w_in": common.dense_init(gen, (d, ff), device),
            "w_out": common.dense_init(gen, (ff, d), device,
                                       scale=ff ** -0.5)}


def mlp_fwd(params, cfg: ModelConfig, x):
    if cfg.activation == "swiglu":
        g = common.silu(mm(x, params["w_gate"]))
        h = mm(x, params["w_in"]) * g
    else:
        act = common.relu2 if cfg.activation == "relu2" else common.gelu
        h = act(mm(x, params["w_in"]))
    h = dtensor.hint(h, ("pod", "data"), None, "model")
    return mm(h, params["w_out"])
