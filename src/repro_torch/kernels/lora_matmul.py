"""Fused LoRA matmul: ``y = x @ W + (x @ A) @ B``, differentiable.

Counterpart of ``src/repro/kernels/lora_matmul.py``.  The TPU kernels
become the CUDA kernels of ``csrc/lora_matmul.cu``:

    lora_fwd    <- _fwd_call    y and the saved (M, r) panel xa = x@A
    lora_dx     <- _dx_call     dx = g@Wᵀ + (g@Bᵀ)@Aᵀ and gb = g@Bᵀ
                                (the forward's template, operands transposed)
    lora_dw     <- _dw_call     the dense dW = xᵀg, summed over M
    lora_panel  <- _panel_grad_call   dA = xᵀ·gb, dB = (gᵀ·xa)ᵀ
    lora_panel_examples <- _panel_grad_call under the ``vmap`` of the
                DP-SGD step's per-example loss: each example's dA or dB,
                (B, K, r) or (B, r, N)
    lora_panel_examples_pair <- the same, both of a LoRA site's products
                (each example's dA and dB) in one launch
    lora_fwd_clients, lora_dx_clients, lora_panel_clients
                <- _fwd_call, _dx_call, _panel_grad_call under the ``vmap``
                over clients of the ``spmd`` backend's stacked local update:
                W shared, each client's A, B and rows its own, every
                client's outputs the bits of the one-client kernel on its
                rows

``LoRAMatmul`` is the ``torch.autograd.Function`` around them.  For CUDA
tensors it launches the kernels (or raises); for CPU tensors it takes the
plain versions in kernels/ref.py.  dW runs only where W itself requires a
gradient (``ctx.needs_input_grad``): in PEFT the base is frozen, so every
training path skips it; the gradient with respect to the bound base
weights reaches it.  ``LoRAMatmulExamples`` is its per-example form for
the DP-SGD step's one batched pass (kernels/ops.per_example_scope): the
same forward, and a backward that gives each example's dA and dB
(through ``lora_panel_examples_pair``) as the gradients of two sink tensors,
so that no gradient summed over the examples is formed.
``LoRAMatmulClients`` is the stacked clients' form (core/fedavg's stacked
train step): x (C, M_c, K) against each client's (C, K, r) and (C, r, N)
factors, whose backward gives each client's dA and dB straight as the
gradients of the stacked factors.  ``LoRAMatmulClientsExamples`` is the
stacked clients' form under the DP-SGD step's per-example pass: the
client-axis forward and dx, and each example's dA and dB through one
``lora_panel_examples_pair`` launch over the C·B examples.

Each kernel wrapper adds one to ``LAUNCHES[name]`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"lora_fwd": 0, "lora_dx": 0, "lora_dw": 0, "lora_panel": 0,
            "lora_panel_examples": 0, "lora_panel_examples_pair": 0,
            "lora_fwd_clients": 0,
            "lora_dx_clients": 0, "lora_panel_clients": 0}
R_MAX = 64
_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("lora_matmul")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lora_fused.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.lora_fused.restype = i32
        lib.lora_panel_splits.argtypes = [i32] * 3
        lib.lora_panel_splits.restype = i32
        lib.lora_panel_grad.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.lora_panel_grad.restype = i32
        lib.lora_panel_examples.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
        lib.lora_panel_examples.restype = i32
        lib.lora_panel_examples_pair.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.lora_panel_examples_pair.restype = i32
        lib.lora_fused_clients.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        lib.lora_fused_clients.restype = i32
        lib.lora_panel_clients.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        lib.lora_panel_clients.restype = i32
        lib.lora_dw_splits.argtypes = [i32] * 3
        lib.lora_dw_splits.restype = i32
        lib.lora_dw.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        lib.lora_dw.restype = i32
        _LIB = lib
    return _LIB


def _rank(r: int, kernel: str) -> None:
    if not 1 <= r <= R_MAX:
        raise ValueError(f"{kernel}: rank {r} outside [1, {R_MAX}]")


# --------------------------------------------------------------------------- #
# Kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------- #
def lora_fwd(x, w, a, b):
    """x (M, K), w (K, N), a (K, r), b (r, N) -> (y (M, N), xa (M, r))."""
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    _rank(r, "lora_fwd")
    build.check_tensors("lora_fwd", x.device, x=(x, (M, K)), w=(w, (K, N)),
                        a=(a, (K, r)), b=(b, (r, N)))
    y = torch.empty((M, N), device=x.device, dtype=torch.float32)
    xa = torch.empty((M, r), device=x.device, dtype=torch.float32)
    rc = _lib().lora_fused(x.data_ptr(), w.data_ptr(), a.data_ptr(),
                           b.data_ptr(), y.data_ptr(), xa.data_ptr(),
                           M, K, N, r, 0, build.stream(x.device))
    build.check(rc, "lora_fwd")
    LAUNCHES["lora_fwd"] += 1
    return y, xa


def lora_dx(g, w, a, b):
    """g (M, N), w (K, N), a (K, r), b (r, N) -> (dx (M, K), gb (M, r))."""
    M, N = g.shape
    K, r = w.shape[0], a.shape[1]
    _rank(r, "lora_dx")
    build.check_tensors("lora_dx", g.device, g=(g, (M, N)), w=(w, (K, N)),
                        a=(a, (K, r)), b=(b, (r, N)))
    dx = torch.empty((M, K), device=g.device, dtype=torch.float32)
    gb = torch.empty((M, r), device=g.device, dtype=torch.float32)
    rc = _lib().lora_fused(g.data_ptr(), w.data_ptr(), a.data_ptr(),
                           b.data_ptr(), dx.data_ptr(), gb.data_ptr(),
                           M, N, K, r, 1, build.stream(g.device))
    build.check(rc, "lora_dx")
    LAUNCHES["lora_dx"] += 1
    return dx, gb


def lora_dw(x, g):
    """x (M, K), g (M, N) -> dW = xᵀg (K, N).  Where the card would not be
    filled by the (K, N) tiles alone, the kernel splits M into slices and
    sums them in a fixed order through a workspace allocated here."""
    M, K = x.shape
    N = g.shape[1]
    build.check_tensors("lora_dw", x.device, x=(x, (M, K)), g=(g, (M, N)))
    lib = _lib()
    splits = lib.lora_dw_splits(M, K, N)
    dw = torch.empty((K, N), device=x.device, dtype=torch.float32)
    ws = torch.empty((splits, K, N), device=x.device, dtype=torch.float32) \
        if splits > 1 else None
    rc = lib.lora_dw(x.data_ptr(), g.data_ptr(), dw.data_ptr(),
                     None if ws is None else ws.data_ptr(), M, K, N,
                     build.stream(x.device))
    build.check(rc, "lora_dw")
    LAUNCHES["lora_dw"] += 1
    return dw


def lora_panel(lhs, panel, transpose_out: bool = False):
    """lhs (M, L), panel (M, r) -> lhsᵀ·panel (L, r), or (r, L) transposed.
    The kernel splits M into slices to fill the card and sums them in a
    fixed order through a workspace allocated here."""
    M, L = lhs.shape
    r = panel.shape[1]
    _rank(r, "lora_panel")
    build.check_tensors("lora_panel", lhs.device, lhs=(lhs, (M, L)),
                        panel=(panel, (M, r)))
    lib = _lib()
    splits = lib.lora_panel_splits(M, L, r)
    out = torch.empty((r, L) if transpose_out else (L, r), device=lhs.device,
                      dtype=torch.float32)
    ws = torch.empty((splits, L * r), device=lhs.device,
                     dtype=torch.float32) if splits > 1 else None
    rc = lib.lora_panel_grad(lhs.data_ptr(), panel.data_ptr(),
                             out.data_ptr(),
                             None if ws is None else ws.data_ptr(), M, L, r,
                             int(transpose_out), build.stream(lhs.device))
    build.check(rc, "lora_panel")
    LAUNCHES["lora_panel"] += 1
    return out


def lora_panel_examples(lhs, panel, transpose_out: bool = False):
    """lhs (B, S, L), panel (B, S, r) -> each example's lhs_bᵀ·panel_b,
    (B, L, r), or (B, r, L) transposed: one launch, one slice of S rows
    per example, written straight to the output."""
    B, S, L = lhs.shape
    r = panel.shape[2]
    _rank(r, "lora_panel_examples")
    build.check_tensors("lora_panel_examples", lhs.device,
                        lhs=(lhs, (B, S, L)), panel=(panel, (B, S, r)))
    out = torch.empty((B, r, L) if transpose_out else (B, L, r),
                      device=lhs.device, dtype=torch.float32)
    rc = _lib().lora_panel_examples(lhs.data_ptr(), panel.data_ptr(),
                                    out.data_ptr(), B, S, L, r,
                                    int(transpose_out),
                                    build.stream(lhs.device))
    build.check(rc, "lora_panel_examples")
    LAUNCHES["lora_panel_examples"] += 1
    return out


def lora_panel_examples_pair(x, gb, g, xa):
    """x (B, S, K), gb (B, S, r), g (B, S, N), xa (B, S, r) -> (da (B, K,
    r), db (B, r, N)): each example's dA_b = x_bᵀ·gb_b and dB_b = (g_bᵀ·
    xa_b)ᵀ in one launch, the bits of lora_panel_examples(x, gb) and
    lora_panel_examples(g, xa, True)."""
    B, S, K = x.shape
    N, r = g.shape[2], gb.shape[2]
    _rank(r, "lora_panel_examples_pair")
    build.check_tensors("lora_panel_examples_pair", x.device,
                        x=(x, (B, S, K)), gb=(gb, (B, S, r)),
                        g=(g, (B, S, N)), xa=(xa, (B, S, r)))
    da = torch.empty((B, K, r), device=x.device, dtype=torch.float32)
    db = torch.empty((B, r, N), device=x.device, dtype=torch.float32)
    rc = _lib().lora_panel_examples_pair(x.data_ptr(), gb.data_ptr(),
                                         g.data_ptr(), xa.data_ptr(),
                                         da.data_ptr(), db.data_ptr(), B, S,
                                         K, N, r, build.stream(x.device))
    build.check(rc, "lora_panel_examples_pair")
    LAUNCHES["lora_panel_examples_pair"] += 1
    return da, db


def _fused_clients(x, w, a, b, trans: bool, name: str):
    """lora_fused_clients: x (C, M, Cin) against w (K, N), a (C, K, r), b
    (C, r, N) -> (out (C, M, Nout), panel (C, M, r))."""
    Cl, M, Cin = x.shape
    K, N = w.shape
    r = a.shape[2]
    _rank(r, name)
    build.check_tensors(name, x.device, x=(x, (Cl, M, N if trans else K)),
                        w=(w, (K, N)), a=(a, (Cl, K, r)), b=(b, (Cl, r, N)))
    nout = K if trans else N
    out = torch.empty((Cl, M, nout), device=x.device, dtype=torch.float32)
    panel = torch.empty((Cl, M, r), device=x.device, dtype=torch.float32)
    rc = _lib().lora_fused_clients(x.data_ptr(), w.data_ptr(), a.data_ptr(),
                                   b.data_ptr(), out.data_ptr(),
                                   panel.data_ptr(), Cl, M, Cin, nout, r,
                                   int(trans), build.stream(x.device))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return out, panel


def lora_fwd_clients(x, w, a, b):
    """x (C, M, K), w (K, N), a (C, K, r), b (C, r, N) -> (y (C, M, N), xa
    (C, M, r)): lora_fwd on each client's rows and factors, one launch."""
    return _fused_clients(x, w, a, b, False, "lora_fwd_clients")


def lora_dx_clients(g, w, a, b):
    """g (C, M, N), w (K, N), a (C, K, r), b (C, r, N) -> (dx (C, M, K),
    gb (C, M, r)): lora_dx on each client's rows and factors, one launch."""
    return _fused_clients(g, w, a, b, True, "lora_dx_clients")


def lora_panel_clients(lhs, panel, transpose_out: bool = False):
    """lhs (C, M, L), panel (C, M, r) -> each client's lhs_cᵀ·panel_c, (C,
    L, r), or (C, r, L) transposed: lora_panel on each client's rows, the
    same slices summed in the same order through a workspace allocated
    here, one launch (and one of the sum)."""
    Cl, M, L = lhs.shape
    r = panel.shape[2]
    _rank(r, "lora_panel_clients")
    build.check_tensors("lora_panel_clients", lhs.device,
                        lhs=(lhs, (Cl, M, L)), panel=(panel, (Cl, M, r)))
    lib = _lib()
    splits = lib.lora_panel_splits(M, L, r)
    out = torch.empty((Cl, r, L) if transpose_out else (Cl, L, r),
                      device=lhs.device, dtype=torch.float32)
    ws = torch.empty((Cl, splits, L * r), device=lhs.device,
                     dtype=torch.float32) if splits > 1 else None
    rc = lib.lora_panel_clients(lhs.data_ptr(), panel.data_ptr(),
                                out.data_ptr(),
                                None if ws is None else ws.data_ptr(), Cl, M,
                                L, r, int(transpose_out),
                                build.stream(lhs.device))
    build.check(rc, "lora_panel_clients")
    LAUNCHES["lora_panel_clients"] += 1
    return out


# --------------------------------------------------------------------------- #
# autograd
# --------------------------------------------------------------------------- #
class LoRAMatmul(torch.autograd.Function):
    """x (M, K), w (K, N), a (K, r), b (r, N) -> x@W + (x@A)@B."""

    @staticmethod
    def forward(ctx, x, w, a, b):
        y, xa = (lora_fwd if x.is_cuda else ref.lora_fwd)(x, w, a, b)
        ctx.save_for_backward(x, w, a, b, xa)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, a, b, xa = ctx.saved_tensors
        g = g.contiguous()
        cuda = g.is_cuda
        need_dx, need_dw, need_da, need_db = ctx.needs_input_grad
        dx = dw = da = db = None
        if need_dw:
            dw = (lora_dw if cuda else ref.lora_dw)(x, g)
        if need_dx or need_da:
            dx, gb = (lora_dx if cuda else ref.lora_dx)(g, w, a, b)
            if need_da:
                da = (lora_panel if cuda else ref.panel_grad)(x, gb)
        if need_db:
            db = (lora_panel if cuda else ref.panel_grad)(g, xa, True)
        return (dx if need_dx else None), dw, da, db


class LoRAMatmulExamples(torch.autograd.Function):
    """x (B, S, K), w (K, N), a (K, r), b (r, N) -> x@W + (x@A)@B, (B, S,
    N), with the sinks sa (B, K, r) and sb (B, r, N): y does not read
    them, and their gradients are each example's dA_b = x_bᵀ·gb_b and dB_b
    = (g_bᵀ·xa_b)ᵀ.  w, a and b get no gradient.  ``cuda`` (the resolved
    kernel policy) picks the kernels or their plain twins."""

    @staticmethod
    def forward(ctx, x, w, a, b, sa, sb, cuda):
        B, S, K = x.shape
        y, xa = (lora_fwd if cuda else ref.lora_fwd)(x.view(B * S, K), w, a,
                                                    b)
        ctx.cuda = cuda
        ctx.save_for_backward(x, w, a, b, xa)
        return y.view(B, S, -1)

    @staticmethod
    def backward(ctx, g):
        x, w, a, b, xa = ctx.saved_tensors
        B, S, K = x.shape
        g = g.contiguous()
        cuda = ctx.cuda
        dx, gb = (lora_dx if cuda else ref.lora_dx)(g.view(B * S, -1), w, a,
                                                    b)
        da, db = (lora_panel_examples_pair if cuda
                  else ref.panel_grad_examples_pair)(
            x, gb.view(B, S, -1), g, xa.view(B, S, -1))
        dx = dx.view(B, S, K) if ctx.needs_input_grad[0] else None
        return dx, None, None, None, da, db, None


class LoRAMatmulClients(torch.autograd.Function):
    """x (C, M, K), w (K, N), a (C, K, r), b (C, r, N) -> y (C, M, N),
    each client's x_c@W + (x_c@A_c)@B_c.  The backward gives dx and each
    client's dA_c = x_cᵀ·gb_c and dB_c = (g_cᵀ·xa_c)ᵀ as the gradients of
    a and b; w gets none.  ``cuda`` (the resolved kernel policy) picks the
    kernels or their plain twins."""

    @staticmethod
    def forward(ctx, x, w, a, b, cuda):
        y, xa = (lora_fwd_clients if cuda else ref.lora_fwd_clients)(x, w, a,
                                                                    b)
        ctx.cuda = cuda
        ctx.save_for_backward(x, w, a, b, xa)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, a, b, xa = ctx.saved_tensors
        g = g.contiguous()
        cuda = ctx.cuda
        panel = lora_panel_clients if cuda else ref.panel_grad_clients
        need_dx, _, need_da, need_db, _ = ctx.needs_input_grad
        dx = da = db = None
        if need_dx or need_da:
            dx, gb = (lora_dx_clients if cuda else ref.lora_dx_clients)(
                g, w, a, b)
            if need_da:
                da = panel(x, gb)
        if need_db:
            db = panel(g, xa, True)
        return (dx if need_dx else None), None, da, db, None


class LoRAMatmulClientsExamples(torch.autograd.Function):
    """x (C, B·S, K), w (K, N), a (C, K, r), b (C, r, N) -> y (C, B·S, N)
    as LoRAMatmulClients, with the sinks sa (C·B, K, r) and sb (C·B, r,
    N): y does not read them, and their gradients are each example's dA
    and dB with respect to its client's factors (example j of client c at
    row c·B + j).  The example axis is the flattened client and batch
    axes, so one pair launch serves the whole stacked batch.  w, a and b
    get no gradient."""

    @staticmethod
    def forward(ctx, x, w, a, b, sa, sb, S, cuda):
        y, xa = (lora_fwd_clients if cuda else ref.lora_fwd_clients)(x, w, a,
                                                                    b)
        ctx.cuda, ctx.S = cuda, S
        ctx.save_for_backward(x, w, a, b, xa)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, a, b, xa = ctx.saved_tensors
        Cl, M, K = x.shape
        S, cuda = ctx.S, ctx.cuda
        n = Cl * M // S
        g = g.contiguous()
        dx, gb = (lora_dx_clients if cuda else ref.lora_dx_clients)(g, w, a,
                                                                    b)
        da, db = (lora_panel_examples_pair if cuda
                  else ref.panel_grad_examples_pair)(
            x.view(n, S, K), gb.view(n, S, -1), g.view(n, S, -1),
            xa.view(n, S, -1))
        dx = dx if ctx.needs_input_grad[0] else None
        return dx, None, None, None, da, db, None, None


def lora_matmul(x, w, a, b):
    """Differentiable fused LoRA product on 2-D ``x``; scale (alpha/r) is
    expected folded into ``b`` (peft/lora.bind)."""
    return LoRAMatmul.apply(x, w, a, b)
