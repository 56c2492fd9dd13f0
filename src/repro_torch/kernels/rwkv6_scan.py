"""The RWKV-6 WKV recurrence, differentiable.

Counterpart of ``rwkv6_scan`` in ``src/repro/kernels/rwkv6_scan.py`` (row
16 of the kernel table).  The TPU kernel becomes the CUDA kernels of
``csrc/rwkv6_scan.cu``:

    rwkv6_fwd  <- rwkv6_scan    y (BH, S, D), S_final (BH, D, D) and,
                                when a gradient follows, the state
                                before every BT-th step
    rwkv6_bwd  (its gradient)   dr, dk, dv and, when asked, dlogw and du:
                                backward in time from the checkpoints

``RWKV6Scan`` is the ``torch.autograd.Function`` around them.  For CUDA
tensors it launches the kernels (or raises); for CPU tensors it takes the
plain versions in kernels/ref.py.  It asks for dlogw only where logw
needs a gradient and for du only where u does (the bonus is a frozen base
weight in FedLLM).

Each kernel wrapper adds one to ``LAUNCHES[name]`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"rwkv6_fwd": 0, "rwkv6_bwd": 0}
HEAD_DIMS = (16, 32, 64)
BT = 8              # checkpoint interval of csrc/rwkv6_scan.cu
_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("rwkv6_scan")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rwkv6_fwd.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        lib.rwkv6_fwd.restype = i32
        lib.rwkv6_bwd.argtypes = [ptr] * 13 + [i32] * 4 + [ptr]
        lib.rwkv6_bwd.restype = i32
        _LIB = lib
    return _LIB


def checkpoint_shape(BH: int, S: int, D: int):
    """The checkpoints' shape: the state before every BT-th step."""
    return (BH, -(-S // BT), D, D)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(kernel: str, r, k, v, logw, u, **extra):
    """Shapes, dtypes and devices of the inputs; returns (BH, S, D, U)."""
    if r.dim() != 3 or u.dim() != 2:
        raise ValueError(f"{kernel}: r must be (BH, S, D) and u (U, D), got "
                         f"{tuple(r.shape)} and {tuple(u.shape)}")
    BH, S, D = r.shape
    U = u.shape[0]
    if D not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim {D} not in {HEAD_DIMS}")
    if U == 0 or BH % U:
        raise ValueError(f"{kernel}: u has {U} rows, which must divide "
                         f"BH = {BH}")
    build.check_tensors(kernel, r.device, r=(r, (BH, S, D)),
                        k=(k, (BH, S, D)), v=(v, (BH, S, D)),
                        logw=(logw, (BH, S, D)), u=(u, (U, D)))
    build.check_tensors(kernel, r.device, **{
        name: (t, shape) for name, (t, shape) in extra.items()
        if t is not None})
    return BH, S, D, U


# --------------------------------------------------------------------------- #
# Kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------- #
def rwkv6_fwd(r, k, v, logw, u, checkpoints: bool = False):
    """r, k, v, logw (BH, S, D), u (U, D) -> (y (BH, S, D), S_final (BH,
    D, D), ckpt (BH, ceil(S/BT), D, D) with ``checkpoints``, else None)."""
    BH, S, D, U = _check("rwkv6_fwd", r, k, v, logw, u)
    y = torch.empty_like(r)
    sf = torch.empty((BH, D, D), device=r.device, dtype=torch.float32)
    ckpt = torch.empty(checkpoint_shape(BH, S, D), device=r.device,
                       dtype=torch.float32) if checkpoints else None
    rc = _lib().rwkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          logw.data_ptr(), u.data_ptr(), y.data_ptr(),
                          sf.data_ptr(), _ptr(ckpt), BH, S, D, U,
                          build.stream(r.device))
    build.check(rc, "rwkv6_fwd")
    LAUNCHES["rwkv6_fwd"] += 1
    return y, sf, ckpt


def rwkv6_bwd(r, k, v, logw, u, ckpt, dy, dS_final=None,
              need_dlogw: bool = True, need_du: bool = False):
    """Gradient of ``rwkv6_fwd`` from its checkpoints, dy (BH, S, D) and
    dS_final (BH, D, D) or None -> (dr, dk, dv, dlogw or None, du (U, D)
    or None)."""
    BH, S, D = r.shape
    if ckpt is None:
        raise ValueError("rwkv6_bwd: no checkpoints (the forward ran "
                         "without checkpoints=True)")
    _, _, _, U = _check("rwkv6_bwd", r, k, v, logw, u,
                        ckpt=(ckpt, checkpoint_shape(BH, S, D)),
                        dy=(dy, (BH, S, D)), dS_final=(dS_final, (BH, D, D)))
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlogw = torch.empty_like(r) if need_dlogw else None
    du_rows = torch.empty((BH, D), device=r.device, dtype=torch.float32) \
        if need_du else None
    rc = _lib().rwkv6_bwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          logw.data_ptr(), u.data_ptr(), ckpt.data_ptr(),
                          dy.data_ptr(), _ptr(dS_final), dr.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(), _ptr(dlogw),
                          _ptr(du_rows), BH, S, D, U, build.stream(r.device))
    build.check(rc, "rwkv6_bwd")
    LAUNCHES["rwkv6_bwd"] += 1
    du = du_rows.view(BH // U, U, D).sum(0) if need_du else None
    return dr, dk, dv, dlogw, du


# --------------------------------------------------------------------------- #
# autograd
# --------------------------------------------------------------------------- #
class RWKV6Scan(torch.autograd.Function):
    """r, k, v, logw (BH, S, D), u (U, D) -> (y, S_final)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, checkpoints):
        ckpt = None
        if r.is_cuda:
            y, sf, ckpt = rwkv6_fwd(r, k, v, logw, u, checkpoints)
        else:
            y, sf = ref.rwkv6_scan(r, k, v, logw, u)
        ctx.save_for_backward(r, k, v, logw, u, ckpt)
        ctx.set_materialize_grads(False)
        return y, sf

    @staticmethod
    def backward(ctx, dy, dS_final):
        r, k, v, logw, u, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.contiguous()
        if dS_final is not None:
            dS_final = dS_final.contiguous()
        need_dlogw, need_du = ctx.needs_input_grad[3], ctx.needs_input_grad[4]
        if r.is_cuda:
            grads = rwkv6_bwd(r, k, v, logw, u, ckpt, dy, dS_final,
                              need_dlogw, need_du)
        else:
            grads = ref.rwkv6_scan_bwd(r, k, v, logw, u, dy, dS_final,
                                       need_dlogw, need_du)
        return (*grads, None)


def rwkv6_scan(r, k, v, logw, u):
    """Differentiable ``(y, S_final)`` of the WKV recurrence on contiguous
    fp32 (BH, S, D) inputs and a (U, D) bonus.  The forward writes
    checkpoints only when a gradient can follow."""
    checkpoints = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, logw, u))
    return RWKV6Scan.apply(r, k, v, logw, u, checkpoints)
