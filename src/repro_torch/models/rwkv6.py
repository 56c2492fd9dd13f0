"""RWKV-6 "Finch" block [arXiv:2404.05892]: time-mix (the WKV recurrence
with a data-dependent decay) and channel-mix.

Counterpart of ``init_rwkv6``, ``_shift``, ``_lerp``, ``_decay``,
``_project``, ``timemix_fwd``, ``_wkv_ref_with_state``,
``channelmix_fwd`` and ``init_rwkv_cache`` in
``src/repro/models/rwkv6.py``.  Per head (dk = dv = head_dim), with the
decay w_t:

    S_t = diag(w_t)·S_{t-1} + k_tᵀv_t          state (dk, dv)
    y_t = r_t·(S_{t-1} + diag(u)·k_tᵀv_t)

The reference runs the WKV in its chunked form at S % 16 == 0 (exponents
clamped to ±80) and as a step scan otherwise; here it always goes through
kernels/ops.rwkv6, the exact recurrence: the hand-written CUDA kernels
(row 16, with their backward) on the card, the step-by-step plain
version under the ``torch`` policy.  The projections w_r, w_k, w_v, w_g
and w_o go through models/common.mm (LoRA-bound where targeted); the
decay LoRA and the channel-mix weights are base weights.

Decode carries the (B, H, D, D) WKV state and each mix's last input
(``x_tm``, ``x_cm``); from a given state the WKV is the plain stateful
recurrence (``_wkv_ref_with_state``), as in the reference: row 16's
kernel, like the reference's Pallas kernel, starts from a zero state.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import common
from repro_torch.models.common import mm
from repro_torch.runtime import compute_dtype

DECAY_LORA = 64


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig, device):
    """Random block weights, drawn in the reference's key order."""
    d, ff = cfg.d_model, cfg.d_ff

    def full(value):
        return torch.full((d,), value, device=device)

    w_r, w_k, w_v, w_g = (common.dense_init(gen, (d, d), device)
                          for _ in range(4))
    w_o = common.dense_init(gen, (d, d), device, scale=d ** -0.5)
    decay_a = common.dense_init(gen, (d, DECAY_LORA), device)
    decay_b = common.dense_init(gen, (DECAY_LORA, d), device,
                                scale=DECAY_LORA ** -1.0)
    cm_w_k = common.dense_init(gen, (d, ff), device)
    cm_w_v = common.dense_init(gen, (ff, d), device, scale=ff ** -0.5)
    cm_w_r = common.dense_init(gen, (d, d), device)
    return {
        # time-mix
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_g": full(0.5), "mu_w": full(0.5),
        "w_r": w_r, "w_k": w_k, "w_v": w_v, "w_g": w_g, "w_o": w_o,
        # data-dependent decay: w0 + tanh(x@A)@B
        "decay_w0": full(-4.0), "decay_a": decay_a, "decay_b": decay_b,
        "bonus_u": full(0.0),
        "ln_x": common.init_layernorm(d, device),
        # channel-mix
        "cm_mu_k": full(0.5), "cm_mu_r": full(0.5),
        "cm_w_k": cm_w_k, "cm_w_v": cm_w_v, "cm_w_r": cm_w_r,
    }


def _shift(x, last=None):
    """The x_{t-1} stream of (B, S, d): ``last`` (B, d), the previous
    call's last input, before the first step, or zeros."""
    pad = torch.zeros_like(x[:, :1]) if last is None \
        else last[:, None].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _lerp(x, xp, mu):
    return x + (xp - x) * mu


def _decay(params, xw):
    """log(w_t) <= 0:  w_t = exp(-exp(w0 + tanh(x@A)@B)), the exponent
    clipped to [-8, 3]."""
    dt = compute_dtype(xw.dtype)
    dd = torch.tanh(mm(xw, params["decay_a"]))
    ww = params["decay_w0"].to(dt) + mm(dd, params["decay_b"]).to(dt)
    return -torch.exp(torch.clamp(ww, -8.0, 3.0))


def _project(params, cfg: ModelConfig, x, x_prev):
    """(r, k, v, logw (B, S, H, D), u (H, D), gate g (B, S, d))."""
    hd = cfg.head_dim if cfg.head_dim else 64
    B, S, d = x.shape
    shp = (B, S, d // hd, hd)
    r = mm(_lerp(x, x_prev, params["mu_r"]), params["w_r"])
    k = mm(_lerp(x, x_prev, params["mu_k"]), params["w_k"])
    v = mm(_lerp(x, x_prev, params["mu_v"]), params["w_v"])
    g = common.silu(mm(_lerp(x, x_prev, params["mu_g"]), params["w_g"]))
    logw = _decay(params, _lerp(x, x_prev, params["mu_w"]))
    u = params["bonus_u"].to(compute_dtype(x.dtype)).reshape(d // hd, hd)
    return (r.reshape(shp), k.reshape(shp), v.reshape(shp),
            logw.reshape(shp), u, g)


def timemix_fwd(params, cfg: ModelConfig, x, state=None, x_last=None):
    """x: (B, S, d) -> (out (B, S, d), final WKV state (B, H, D, D)).
    ``state`` (B, H, D, D) and ``x_last`` (B, d) continue an earlier call
    (decode); the new ``x_last`` is ``x[:, -1]``.  From a zero state the
    WKV goes through kernels/ops.rwkv6, from a given one through
    ``_wkv_ref_with_state``."""
    B, S, d = x.shape
    r, k, v, logw, u, g = _project(params, cfg, x, _shift(x, x_last))
    # the recurrence runs in fp32 (fp64 for fp64) whatever x's dtype
    dt = compute_dtype(x.dtype)
    r, k, v = r.to(dt), k.to(dt), v.to(dt)
    if state is None:
        y, state = kernel_ops.rwkv6(r, k, v, logw, u)
    else:
        y, state = _wkv_ref_with_state(r, k, v, logw, u, state)
    y = common.layernorm(params["ln_x"], y.reshape(B, S, d).to(x.dtype)) * g
    return mm(y, params["w_o"]), state


def _wkv_ref_with_state(r, k, v, logw, u, S0):
    """The WKV recurrence step by step from the state ``S0`` (B, H, D, D):
    r, k, v, logw (B, S, H, D), u (H, D) -> (y (B, S, H, D), S_final), in
    the reference's form y_t = r_t·(S_{t-1} + diag(u)·k_tᵀv_t)."""
    state, ys = S0, []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], logw[:, t]
        kv = kt[..., :, None] * vt[..., None, :]          # (B, H, D, D)
        ys.append(torch.einsum("bhd,bhde->bhe", rt,
                               state + u[None, :, :, None] * kv))
        state = torch.exp(lwt)[..., None] * state + kv
    return torch.stack(ys, 1), state


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device=None):
    """{"S": the (batch, H, D, D) WKV state, "x_tm", "x_cm": the time-mix's
    and channel-mix's last inputs (batch, d)}, zeros in ``dtype`` (fp32 in
    the reference)."""
    d = cfg.d_model
    hd = cfg.head_dim if cfg.head_dim else 64
    return {"S": torch.zeros(batch, d // hd, hd, hd, dtype=dtype,
                             device=device),
            "x_tm": torch.zeros(batch, d, dtype=dtype, device=device),
            "x_cm": torch.zeros(batch, d, dtype=dtype, device=device)}


def channelmix_fwd(params, cfg: ModelConfig, x, x_last=None):
    """x: (B, S, d) -> (B, S, d); ``x_last`` (B, d) as in timemix_fwd."""
    x_prev = _shift(x, x_last)
    kx = _lerp(x, x_prev, params["cm_mu_k"])
    rx = _lerp(x, x_prev, params["cm_mu_r"])
    k = common.relu2(mm(kx, params["cm_w_k"]))
    return torch.sigmoid(mm(rx, params["cm_w_r"])) * mm(k, params["cm_w_v"])
