"""Plain PyTorch versions of the ported kernels.

Counterpart of ``src/repro/kernels/ref.py`` (``lora_matmul_ref`` and
``attention_ref`` there), plus the plain forward-with-residuals and
backward functions whose math is that of the TPU backward kernels in
``src/repro/kernels/lora_matmul.py`` and ``flash_attention.py``.  The
autograd Functions in kernels/lora_matmul.py and
kernels/flash_attention.py take these for CPU tensors; chip_smoke.py holds
each CUDA kernel against them on the card.  All math is fp32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# LoRA matmul
# --------------------------------------------------------------------------- #
def lora_matmul_ref(x, w, a, b):
    """x: (M, K); w: (K, N); a: (K, r); b: (r, N) -> x@W + (x@A)@B."""
    return x @ w + (x @ a) @ b


def lora_fwd(x, w, a, b):
    """(y, xa): the forward kernel's outputs (row 1), xa = x@A saved."""
    xa = x @ a
    return x @ w + xa @ b, xa


def lora_dx(g, w, a, b):
    """(dx, gb): dx = g@Wᵀ + (g@Bᵀ)@Aᵀ, gb = g@Bᵀ (row 2)."""
    gb = g @ b.t()
    return g @ w.t() + gb @ a.t(), gb


def panel_grad(lhs, panel, transpose_out: bool = False):
    """lhsᵀ·panel: (M, L), (M, r) -> (L, r), or (r, L) transposed (row 4).
    dA = panel_grad(x, gb); dB = panel_grad(g, xa, transpose_out=True)."""
    out = lhs.t() @ panel
    return out.t().contiguous() if transpose_out else out


# --------------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------------- #
def _mask(Sq: int, Skv: int, causal: bool, window: int, q_offset: int,
          device):
    q_pos = torch.arange(Sq, device=device)[:, None] + q_offset
    kv_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kv_pos <= q_pos)
    if window > 0:
        mask = mask & (kv_pos > q_pos - window)
    return mask


def _scores(q, k, causal, window, q_offset):
    """(masked fp32 scores (BH, Sq, Skv), mask, G) with GQA head repeat."""
    BH, Sq, D = q.shape
    BKV, Skv, _ = k.shape
    G = BH // BKV
    kr = k.repeat_interleave(G, dim=0)
    s = (q * D ** -0.5) @ kr.transpose(1, 2)
    mask = _mask(Sq, Skv, causal, window, q_offset, q.device)
    return s.masked_fill(~mask, NEG_INF), mask, G


def attention_ref(q, k, v, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """q: (BH, Sq, D); k, v: (BKV, Skv, D); GQA kv head = bh // G."""
    s, _, G = _scores(q, k, causal, window, q_offset)
    p = torch.softmax(s, dim=-1)
    return p @ v.repeat_interleave(G, dim=0)


def attention_fwd(q, k, v, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """(o, lse (BH, Sq) fp32): the flash forward's outputs (row 5)."""
    s, _, G = _scores(q, k, causal, window, q_offset)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.exp(s - lse[..., None]) @ v.repeat_interleave(G, dim=0)
    return o, lse


def _p_ds(q, k, v, do, lse, dd, causal, window, q_offset):
    """Recomputed p = exp(s − lse) (0 where masked) and ds = p(do·vᵀ − D)."""
    s, mask, G = _scores(q, k, causal, window, q_offset)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = do @ v.repeat_interleave(G, dim=0).transpose(1, 2)
    return p, p * (dp - dd[..., None]), G


def attention_dq(q, k, v, do, lse, dd, causal: bool = True, window: int = 0,
                 q_offset: int = 0):
    """dq = scale·ds·k (row 6); dd = rowsum(do∘o) of shape (BH, Sq)."""
    _, ds, G = _p_ds(q, k, v, do, lse, dd, causal, window, q_offset)
    return (ds @ k.repeat_interleave(G, dim=0)) * q.shape[-1] ** -0.5


def attention_dkv(q, k, v, do, lse, dd, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """(dk, dv) = (scale·dsᵀq, pᵀdo), summed over each GQA group (row 7)."""
    BKV, Skv, D = k.shape
    p, ds, G = _p_ds(q, k, v, do, lse, dd, causal, window, q_offset)
    dk = (ds.transpose(1, 2) @ q).view(BKV, G, Skv, D).sum(1) * D ** -0.5
    dv = (p.transpose(1, 2) @ do).view(BKV, G, Skv, D).sum(1)
    return dk, dv
