"""Plain PyTorch versions of the ported kernels.

Counterpart of ``src/repro/kernels/ref.py`` (``lora_matmul_ref``,
``attention_ref``, ``kd_loss_rows_ref``, ``clip_mean_rows_ref``,
``quantize_rows_ref``, ``topk_quantize_rows_ref``, ``rglru_scan_ref`` and
``rwkv6_scan_ref`` there, and the twin of ``quantize_pack4_rows``), plus
the plain forward-with-residuals and backward functions whose math is
that of the TPU kernels in ``src/repro/kernels/lora_matmul.py``,
``flash_attention.py`` and ``kd_loss.py``, and the gradients of the
RG-LRU scan and the RWKV-6 WKV recurrence.  The autograd Functions in
kernels/{lora_matmul,flash_attention,kd_loss,rglru_scan,rwkv6_scan}.py and
kernels/ops (for kernels/quantize.py and kernels/dp_clip.py) take these
for CPU tensors;
chip_smoke.py holds each CUDA kernel against them on the card.  All math
is fp32 (fp64 for fp64 operands): the LoRA and attention twins take bf16
operands too, compute in fp32 and return the operands' dtype, as the
reference's oracles do.
"""
from __future__ import annotations

import torch

from repro_torch.optim.clip import _clip_scale
from repro_torch.runtime import compute_dtype

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# LoRA matmul
# --------------------------------------------------------------------------- #
def _up(*ts):
    """``ts`` in the compute dtype of the first (kernels/ref.py of the
    reference computes in fp32 whatever the operands' dtype); fp32 and
    fp64 tensors come back as they are."""
    dt = compute_dtype(ts[0].dtype)
    return tuple(t.to(dt) for t in ts)


def lora_matmul_ref(x, w, a, b):
    """x: (M, K); w: (K, N); a: (K, r); b: (r, N) -> x@W + (x@A)@B, in
    x's dtype."""
    xc, wc, ac, bc = _up(x, w, a, b)
    return (xc @ wc + (xc @ ac) @ bc).to(x.dtype)


def lora_fwd(x, w, a, b):
    """(y, xa): the forward kernel's outputs (row 1), xa = x@A saved; both
    in x's dtype."""
    xc, wc, ac, bc = _up(x, w, a, b)
    xa = xc @ ac
    return (xc @ wc + xa @ bc).to(x.dtype), xa.to(x.dtype)


def lora_dx(g, w, a, b):
    """(dx, gb): dx = g@Wᵀ + (g@Bᵀ)@Aᵀ, gb = g@Bᵀ (row 2), in g's
    dtype."""
    gc, wc, ac, bc = _up(g, w, a, b)
    gb = gc @ bc.t()
    return (gc @ wc.t() + gb @ ac.t()).to(g.dtype), gb.to(g.dtype)


def lora_dw(x, g):
    """dW = xᵀg: (M, K), (M, N) -> (K, N) (row 3), in x's dtype."""
    xc, gc = _up(x, g)
    return (xc.t() @ gc).to(x.dtype)


def panel_grad(lhs, panel, transpose_out: bool = False):
    """lhsᵀ·panel: (M, L), (M, r) -> (L, r), or (r, L) transposed (row 4),
    in lhs's dtype.  dA = panel_grad(x, gb); dB = panel_grad(g, xa,
    transpose_out=True)."""
    lc, pc = _up(lhs, panel)
    out = (lc.t() @ pc).to(lhs.dtype)
    return out.t().contiguous() if transpose_out else out


def panel_grad_examples(lhs, panel, transpose_out: bool = False):
    """Each example's lhs_bᵀ·panel_b: (B, S, L), (B, S, r) -> (B, L, r),
    or (B, r, L) transposed, in lhs's dtype: row 4 under the ``vmap`` of
    the DP-SGD step's per-example loss."""
    lc, pc = _up(lhs, panel)
    out = (lc.transpose(1, 2) @ pc).to(lhs.dtype)
    return out.transpose(1, 2).contiguous() if transpose_out else out


def panel_grad_examples_pair(x, gb, g, xa):
    """(dA, dB) of a LoRA site for each example: x (B, S, K), gb (B, S,
    r), g (B, S, N), xa (B, S, r) -> ((B, K, r), (B, r, N)), row 4ᵉ's
    two products in one call."""
    return panel_grad_examples(x, gb), panel_grad_examples(g, xa, True)


def lora_fwd_clients(x, w, a, b):
    """(y, xa) of each client: x (C, M, K), w (K, N) shared, a (C, K, r),
    b (C, r, N) -> y (C, M, N), xa (C, M, r) in x's dtype (rows 1ᶜ under
    the ``vmap`` over clients of the stacked local update)."""
    xc, wc, ac, bc = _up(x, w, a, b)
    xa = xc @ ac
    return (xc @ wc + xa @ bc).to(x.dtype), xa.to(x.dtype)


def lora_dx_clients(g, w, a, b):
    """(dx, gb) of each client: g (C, M, N) -> dx (C, M, K), gb (C, M, r)
    in g's dtype (row 2ᶜ)."""
    gc, wc, ac, bc = _up(g, w, a, b)
    gb = gc @ bc.transpose(1, 2)
    return (gc @ wc.t() + gb @ ac.transpose(1, 2)).to(g.dtype), \
        gb.to(g.dtype)


def panel_grad_clients(lhs, panel, transpose_out: bool = False):
    """Each client's lhs_cᵀ·panel_c: (C, M, L), (C, M, r) -> (C, L, r), or
    (C, r, L) transposed (row 4ᶜ): the per-example form's function."""
    return panel_grad_examples(lhs, panel, transpose_out)


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
    """(masked scores (BH, Sq, Skv) in q's compute dtype, mask, G) with
    GQA head repeat."""
    BH, Sq, D = q.shape
    BKV, Skv, _ = k.shape
    G = BH // BKV
    qc, kc = _up(q, k)
    kr = kc.repeat_interleave(G, dim=0)
    s = (qc * D ** -0.5) @ kr.transpose(1, 2)
    mask = _mask(Sq, Skv, causal, window, q_offset, q.device)
    return s.masked_fill(~mask, NEG_INF), mask, G


def attention_ref(q, k, v, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """q: (BH, Sq, D); k, v: (BKV, Skv, D); GQA kv head = bh // G.  Scores,
    softmax and products in fp32 (fp64 for fp64), the result in q's
    dtype."""
    s, _, G = _scores(q, k, causal, window, q_offset)
    p = torch.softmax(s, dim=-1)
    return (p @ _up(q, v)[1].repeat_interleave(G, dim=0)).to(q.dtype)


def attention_fwd(q, k, v, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """(o in q's dtype, lse (BH, Sq) fp32): the flash forward's outputs
    (row 5)."""
    s, _, G = _scores(q, k, causal, window, q_offset)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.exp(s - lse[..., None]) @ _up(q, v)[1].repeat_interleave(
        G, dim=0)
    return o.to(q.dtype), lse


def _p_ds(q, k, v, do, lse, dd, causal, window, q_offset):
    """Recomputed p = exp(s − lse) (0 where masked) and ds = p(do·vᵀ − D),
    in q's compute dtype."""
    s, mask, G = _scores(q, k, causal, window, q_offset)
    _, vc, doc, lsec, ddc = _up(q, v, do, lse, dd)
    p = torch.where(mask, torch.exp(s - lsec[..., None]), 0.0)
    dp = doc @ vc.repeat_interleave(G, dim=0).transpose(1, 2)
    return p, p * (dp - ddc[..., None]), G


def attention_dq(q, k, v, do, lse, dd, causal: bool = True, window: int = 0,
                 q_offset: int = 0):
    """dq = scale·ds·k (row 6), in q's dtype; dd = rowsum(do∘o) of shape
    (BH, Sq)."""
    _, ds, G = _p_ds(q, k, v, do, lse, dd, causal, window, q_offset)
    kc = _up(q, k)[1]
    return ((ds @ kc.repeat_interleave(G, dim=0))
            * q.shape[-1] ** -0.5).to(q.dtype)


def attention_dkv(q, k, v, do, lse, dd, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """(dk, dv) = (scale·dsᵀq, pᵀdo), summed over each GQA group (row 7),
    in k's and v's dtypes."""
    BKV, Skv, D = k.shape
    p, ds, G = _p_ds(q, k, v, do, lse, dd, causal, window, q_offset)
    qc, doc = _up(q, do)
    dk = (ds.transpose(1, 2) @ qc).view(BKV, G, Skv, D).sum(1) * D ** -0.5
    dv = (p.transpose(1, 2) @ doc).view(BKV, G, Skv, D).sum(1)
    return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------- #
# KD loss
# --------------------------------------------------------------------------- #
def kd_loss_rows_ref(teacher, student, temperature: float = 1.0):
    """Per-row KL(softmax(t/T) || softmax(s/T)) · T² -> (R,), through
    log-softmax (the reference's oracle)."""
    tp = torch.log_softmax(teacher.float() / temperature, dim=-1)
    sp = torch.log_softmax(student.float() / temperature, dim=-1)
    return (tp.exp() * (tp - sp)).sum(-1) * temperature ** 2


def kd_loss_fwd(teacher, student, temperature: float = 1.0):
    """(rows (R,), (m_t, z_t, m_s, z_s, u) each (R,)): the forward kernel's
    outputs (row 8).  m, z: max and sum of exp(x/T − m) of each logit
    set; u = Σ exp(t/T − m_t)·((t/T − m_t) − (s/T − m_s)), so that
    rows = (u/z_t − log z_t + log z_s)·T² never subtracts two numbers of
    the size of the logits.  (The reference's u is Σ exp(t/T − m_t)·(t/T −
    s/T) = this u + z_t·(m_t − m_s); its KL = u/z_t − lse_t + lse_s
    cancels to nothing when a teacher row's maximum is near the top-k
    fill value −1e9, as after aggregating top-k uploads.)"""
    t = teacher.float() / temperature
    s = student.float() / temperature
    m_t = t.max(-1).values
    m_s = s.max(-1).values
    tc, sc = t - m_t[:, None], s - m_s[:, None]
    e_t = torch.exp(tc)
    z_t = e_t.sum(-1)
    z_s = torch.exp(sc).sum(-1)
    u = (e_t * (tc - sc)).sum(-1)
    kl = u / z_t - torch.log(z_t) + torch.log(z_s)
    return kl * temperature ** 2, (m_t, z_t, m_s, z_s, u)


def kd_loss_bwd(teacher, student, stats, g, temperature: float = 1.0,
                need_dt: bool = True):
    """(dt or None, ds), each (R, V), from the forward's row statistics and
    the upstream gradient g (R,) of the rows (row 9):
    dt = g·T·p(log p − log q − KL), ds = g·T·(q − p), with
    log p = (t/T − m_t) − log z_t and log q = (s/T − m_s) − log z_s."""
    m_t, z_t, m_s, z_s, u = (x[:, None] for x in stats)
    logp = (teacher.float() / temperature - m_t) - torch.log(z_t)
    logq = (student.float() / temperature - m_s) - torch.log(z_s)
    p, q = torch.exp(logp), torch.exp(logq)
    gt = g.float()[:, None] * temperature
    ds = gt * (q - p)
    if not need_dt:
        return None, ds
    kl = u / z_t - torch.log(z_t) + torch.log(z_s)
    return gt * p * (logp - logq - kl), ds


# --------------------------------------------------------------------------- #
# Symmetric per-row int quantization (and top-k)
# --------------------------------------------------------------------------- #
def quantize_rows_ref(x, bits: int = 8):
    """x (R, C) -> (q int8 (R, C), scale fp32 (R, 1)) (row 10):
    scale = max(absmax/qmax, 1e-12) by IEEE division, q = clamp(round(x /
    scale), -qmax, qmax), rounding half to even, qmax = 2^(bits-1) - 1."""
    qmax = float((1 << (bits - 1)) - 1)
    xf = x.float()
    absmax = xf.abs().amax(-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can differ in the last bit
    scale = torch.clamp_min(absmax / absmax.new_tensor(qmax), 1e-12)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def quant_roundtrip_rows_ref(x, bits: int = 8):
    """x (R, C) -> (y fp32 (R, C), scale fp32 (R, 1)): the levels of
    ``quantize_rows_ref`` dequantized, y = float(q) * scale, the reference's
    ``compression.quant_roundtrip``."""
    q, scale = quantize_rows_ref(x, bits)
    return q.float() * scale, scale


def quantize_pack4_rows_ref(x):
    """x (R, C even) -> (packed uint8 (R, C/2), scale fp32 (R, 1)) (row
    11): int4 levels of ``quantize_rows_ref``, the even column in the low
    nibble and the odd column in the high one, in two's complement."""
    R, C = x.shape
    if C % 2:
        raise ValueError(f"quantize_pack4_rows_ref: C={C} is odd")
    q, scale = quantize_rows_ref(x, 4)
    pair = (q.to(torch.int32) & 0xF).reshape(R, C // 2, 2)
    return (pair[..., 0] | (pair[..., 1] << 4)).to(torch.uint8), scale


def topk_quantize_rows_ref(x, k: int, bits: int = 8):
    """x (R, C) -> (q int8 (R, k), idx int32 (R, k), scale fp32 (R, 1)).

    Top-k by value with ties to the lower index (``lax.top_k``'s order;
    ``torch.topk`` promises none, so a stable sort selects), then the
    symmetric per-row level of the k values: scale = max(absmax/qmax,
    1e-12) by IEEE division, q = clamp(round(v/scale)), rounding half to
    even."""
    qmax = float((1 << (bits - 1)) - 1)
    vals, idx = torch.sort(x.float(), dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    absmax = vals.abs().max(-1, keepdim=True).values
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can differ in the last bit
    scale = torch.clamp_min(absmax / absmax.new_tensor(qmax), 1e-12)
    q = torch.clamp(torch.round(vals / scale), -qmax, qmax)
    return q.to(torch.int8), idx.to(torch.int32), scale


# --------------------------------------------------------------------------- #
# DP-SGD clip-scale-accumulate
# --------------------------------------------------------------------------- #
def clip_norms_ref(g):
    """Squared L2 norms of the rows of g (B, P) -> (B,) fp32 (row 13;
    fp64 for fp64 rows)."""
    g32 = g.to(compute_dtype(g.dtype))
    return (g32 * g32).sum(dim=1)


def clip_acc_ref(g, sq, clip: float):
    """Mean of the rows of g (B, P), row b scaled by
    ``min(1, C / max(sqrt(sq[b]), EPS))`` -> (P,) fp32 (row 14)."""
    scale = _clip_scale(torch.sqrt(sq.to(compute_dtype(sq.dtype))), clip)
    return (g.to(compute_dtype(g.dtype)) * scale[:, None]).mean(dim=0)


def clip_mean_rows_ref(g, clip: float):
    """Mean of the per-row L2-clipped (B, P) grads -> (P,) fp32: the
    DP-SGD clip-scale-accumulate oracle, through optim/clip's fp32
    eps-guarded scale."""
    return clip_acc_ref(g, clip_norms_ref(g), clip)


def clip_acc_clients(g, sq, clip: float):
    """Each client's clip_acc_ref: g (C, B, P), sq (C, B) -> (C, P) fp32
    (row 14ᶜ under the ``vmap`` over clients of the stacked DP-SGD
    step)."""
    scale = _clip_scale(torch.sqrt(sq.to(compute_dtype(sq.dtype))), clip)
    return (g.to(compute_dtype(g.dtype)) * scale[..., None]).mean(dim=1)


def clip_mean_rows_clients(g, clip: float):
    """Each client's clip_mean_rows_ref: g (C, B, P) -> (C, P) fp32, the
    squared norms of the C·B rows taken as one (B, P) call's."""
    C, B, P = g.shape
    return clip_acc_clients(g, clip_norms_ref(g.reshape(C * B, P)).view(C, B),
                            clip)


# --------------------------------------------------------------------------- #
# RG-LRU linear recurrence
# --------------------------------------------------------------------------- #
def rglru_scan(a, b, h0=None):
    """h_t = a_t·h_{t-1} + b_t from h_{-1} = h0 (zeros if None), one step
    at a time: a, b (B, S, W) -> (h (B, S, W), h_final (B, W)) (row 15).
    One multiply, then one add, each rounded: the CUDA kernel's bits."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    steps = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        steps.append(h)
    return torch.stack(steps, 1), h


def rglru_scan_bwd(a, h, h0, dh, dh_final=None, need_dh0: bool = False):
    """The recurrence's gradient, backward in time from c = dh_final (or
    0): g_t = dh_t + c, c = a_t·g_t, db_t = g_t, da_t = g_t·h_{t-1}
    (h_{-1} = h0, or 0).  Returns (da, db, dh0 = c after step 0 if
    ``need_dh0`` else None)."""
    S = a.shape[1]
    c = torch.zeros_like(a[:, 0]) if dh_final is None else dh_final
    h_prev = torch.zeros_like(a[:, 0]) if h0 is None else h0
    da, db = torch.empty_like(a), torch.empty_like(a)
    for t in range(S - 1, -1, -1):
        g = dh[:, t] + c
        c = a[:, t] * g
        db[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t > 0 else h_prev)
    return da, db, (c if need_dh0 else None)


# --------------------------------------------------------------------------- #
# RWKV-6 WKV recurrence
# --------------------------------------------------------------------------- #
def _bonus(u, BH: int):
    """u (U, D), U dividing BH -> (BH, D): row bh is u[bh mod U] (the
    (H, D) bonus tiled over the batch of a (B·H, S, D) layout)."""
    return u.repeat(BH // u.shape[0], 1)


def rwkv6_scan(r, k, v, logw, u):
    """The WKV recurrence one step at a time (row 16): r, k, v, logw (BH,
    S, D), u (U, D) with U dividing BH -> (y (BH, S, D), S_final (BH, D,
    D)).  From S = 0, with w_t = exp(logw_t):

        y_t = r_t·S_{t-1} + (Σ_d r_t[d]·u[d]·k_t[d])·v_t
        S_t = w_t ⊙_rows S_{t-1} + k_t v_tᵀ

    (the reference's ``r_t·(S_{t-1} + diag(u)·k_t v_tᵀ)``, split).  The
    state update rounds each multiply and the add: the CUDA kernel's bits.
    Autograd keeps one (BH, D, D) state a step."""
    BH, S, D = r.shape
    ub = _bonus(u, BH)
    w = torch.exp(logw)
    state = r.new_zeros(BH, D, D)
    ys = []
    for t in range(S):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        c = (rt * ub * kt).sum(-1, keepdim=True)
        ys.append((rt[:, None, :] @ state)[:, 0] + c * vt)
        state = w[:, t, :, None] * state + kt[:, :, None] * vt[:, None, :]
    return torch.stack(ys, 1), state


def rwkv6_scan_bwd(r, k, v, logw, u, dy, dS_final=None,
                   need_dlogw: bool = True, need_du: bool = False):
    """The recurrence's gradient, backward in time carrying G = dL/dS_t
    (dS_final, or 0, after the last step), with c_t = v_t·dy_t:

        dr_t    = S_{t-1}·dy_t + u ⊙ k_t·c_t
        dk_t    = G·v_t + r_t ⊙ u·c_t
        dv_t    = Gᵀ·k_t + (Σ_d r_t[d]·u[d]·k_t[d])·dy_t
        dlogw_t = w_t ⊙ rowsum(G ⊙ S_{t-1})
        du     += r_t ⊙ k_t·c_t
        G       = w_t ⊙_rows G + r_t dy_tᵀ

    S_{t-1} is recomputed forward (never S_t divided by w, which may be
    ~2e-9).  Returns (dr, dk, dv, dlogw or None, du (U, D) or None)."""
    BH, S, D = r.shape
    ub = _bonus(u, BH)
    w = torch.exp(logw)
    prev, state = [], r.new_zeros(BH, D, D)
    for t in range(S):
        prev.append(state)
        state = w[:, t, :, None] * state + k[:, t, :, None] * v[:, t, None, :]
    G = torch.zeros_like(state) if dS_final is None else dS_final
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlogw = torch.empty_like(r) if need_dlogw else None
    du = torch.zeros_like(ub) if need_du else None
    for t in range(S - 1, -1, -1):
        rt, kt, vt, dyt, wt = r[:, t], k[:, t], v[:, t], dy[:, t], w[:, t]
        c = (vt * dyt).sum(-1, keepdim=True)
        dr[:, t] = (prev[t] @ dyt[..., None])[..., 0] + ub * kt * c
        dk[:, t] = (G @ vt[..., None])[..., 0] + rt * ub * c
        dv[:, t] = (G.transpose(1, 2) @ kt[..., None])[..., 0] \
            + (rt * ub * kt).sum(-1, keepdim=True) * dyt
        if need_dlogw:
            dlogw[:, t] = wt * (G * prev[t]).sum(-1)
        if need_du:
            du = du + rt * kt * c
        G = wt[..., None] * G + rt[..., None] * dyt[:, None, :]
    if need_du:
        du = du.view(BH // u.shape[0], *u.shape).sum(0)
    return dr, dk, dv, dlogw, du
