"""RecurrentGemma / Griffin recurrent block (RG-LRU) [arXiv:2402.19427].

Counterpart of ``init_rglru``, ``rglru_fwd``, ``init_rglru_cache`` and
``rglru_decode`` in ``src/repro/models/rglru.py``.  Block:

    x -> { linear -> temporal conv1d -> RG-LRU } * { linear -> GeLU }
      -> linear out

RG-LRU recurrence (per channel):

    r_t = sigmoid(W_a x_t + b_a)                recurrence gate
    i_t = sigmoid(W_x x_t + b_x)                input gate
    a_t = exp(c · r_t · log(sigmoid(Lambda)))   c = 8
    h_t = a_t · h_{t-1} + sqrt(1 - a_t²) · (i_t · x_t)

The reference runs the recurrence as ``lax.associative_scan``; here it
goes through kernels/ops.rglru: the hand-written CUDA scan (row 15) on the
card, its step-by-step plain version under the ``torch`` policy.  The
gates are fp32 matmuls through models/common.mm.  One-token decode
carries the (B, w) state and the conv's last K - 1 inputs, and takes its
one step ``h = a·h + b·x`` on the host graph, without the scan kernel, as
the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import common
from repro_torch.models.common import mm
from repro_torch.runtime import compute_dtype

RGLRU_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ModelConfig, device):
    d, w, K = cfg.d_model, cfg.lru_width, cfg.conv1d_width
    # Lambda so that a = sigmoid(Lambda) starts in [0.9, 0.999]
    u = torch.rand(w, generator=gen) * (0.999 - 0.9) + 0.9
    return {
        "w_rec_in": common.dense_init(gen, (d, w), device),
        "w_gate_in": common.dense_init(gen, (d, w), device),
        "conv_w": common.dense_init(gen, (K, w), device, scale=K ** -0.5),
        "conv_b": torch.zeros(w, device=device),
        "w_a": common.dense_init(gen, (w, w), device),
        "b_a": torch.zeros(w, device=device),
        "w_x": common.dense_init(gen, (w, w), device),
        "b_x": torch.zeros(w, device=device),
        "lambda": torch.log(u / (1 - u)).to(device),
        "w_out": common.dense_init(gen, (w, d), device, scale=w ** -0.5),
    }


def _gates(params, u):
    """u: (..., w) post-conv activations -> (a, gated input), fp32 (fp64
    for fp64) whatever u's dtype, as the reference."""
    dt = compute_dtype(u.dtype)
    r = torch.sigmoid(mm(u, params["w_a"]) + params["b_a"])
    i = torch.sigmoid(mm(u, params["w_x"]) + params["b_x"])
    a = torch.exp(RGLRU_C * r.to(dt) * F.logsigmoid(params["lambda"].to(dt)))
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    return a, beta * (i.to(dt) * u.to(dt))


def _conv1d(params, x, state=None):
    """Depthwise causal temporal conv over (B, S, w), the K taps summed in
    the reference's order (tap 0 first).  ``state`` (B, K-1, w): the
    trailing inputs of the previous call (decode), zeros when None.
    Returns (out, the new state: the last K-1 inputs, None when K is 1)."""
    K = params["conv_w"].shape[0]
    S = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))                   # (B, S+K-1, w)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = xp[:, :S] * params["conv_w"][0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * params["conv_w"][i]
    return out + params["conv_b"], (xp[:, -(K - 1):] if K > 1 else None)


def rglru_fwd(params, cfg: ModelConfig, x, h0=None):
    """Full-sequence forward.  x: (B, S, d) -> ((B, S, d), h_final (B, w)).
    ``h0`` (B, w) is the initial state; the scan starts from it, so its
    first step computes a_0·h0 + b_0, the value the reference folds into
    its first input."""
    u, _ = _conv1d(params, mm(x, params["w_rec_in"]))
    a, bx = _gates(params, u)
    h, h_final = kernel_ops.rglru(a, bx, h0)
    gate = common.gelu(mm(x, params["w_gate_in"]))
    return mm(h.to(x.dtype) * gate, params["w_out"]), h_final


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None):
    """{"h": the (batch, w) state, "conv": the conv's (batch, K-1, w)
    trailing inputs}, zeros in ``dtype`` (fp32 in the reference)."""
    w = cfg.lru_width
    return {"h": torch.zeros(batch, w, dtype=dtype, device=device),
            "conv": torch.zeros(batch, cfg.conv1d_width - 1, w, dtype=dtype,
                                device=device)}


def rglru_decode(params, cfg: ModelConfig, x, cache):
    """One-token decode: x (B, 1, d) -> ((B, 1, d), the new cache)."""
    u, conv = _conv1d(params, mm(x, params["w_rec_in"]), cache["conv"])
    a, bx = _gates(params, u)                             # (B, 1, w)
    h = a[:, 0] * cache["h"] + bx[:, 0]                   # (B, w)
    gate = common.gelu(mm(x, params["w_gate_in"]))
    out = h[:, None].to(x.dtype) * gate
    return mm(out, params["w_out"]), {"h": h, "conv": conv}
