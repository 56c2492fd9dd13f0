"""The RG-LRU linear recurrence ``h_t = a_t·h_{t-1} + b_t``, differentiable.

Counterpart of ``rglru_scan`` in ``src/repro/kernels/rglru_scan.py`` (row
15 of the kernel table).  The TPU kernel becomes the CUDA kernels of
``csrc/rglru_scan.cu``:

    rglru_fwd  <- rglru_scan    h (B, S, W) and h_final (B, W)
    rglru_bwd  (its gradient)   da, db and, when asked, dh0: the same
                                recurrence run backward in time

``RGLRUScan`` is the ``torch.autograd.Function`` around them.  For CUDA
tensors it launches the kernels (or raises); for CPU tensors it takes the
plain versions in kernels/ref.py, which give the same bits.

Each kernel wrapper adds one to ``LAUNCHES[name]`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"rglru_fwd": 0, "rglru_bwd": 0}
_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("rglru_scan")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rglru_fwd.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        lib.rglru_fwd.restype = i32
        lib.rglru_bwd.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        lib.rglru_bwd.restype = i32
        _LIB = lib
    return _LIB


def _ptr(t):
    return None if t is None else t.data_ptr()


def _vec(W: int, *tensors) -> int:
    """1 when rows can be read as float4: W a multiple of 4 and every
    base 16-byte aligned."""
    return int(W % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in tensors if t is not None))


def _state(kernel: str, device, W: int, **tensors):
    """Checks the optional (B, W) state tensors."""
    for name, (t, B) in tensors.items():
        if t is not None:
            build.check_tensors(kernel, device, **{name: (t, (B, W))})


# --------------------------------------------------------------------------- #
# Kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------- #
def rglru_fwd(a, b, h0=None):
    """a, b (B, S, W), h0 (B, W) or None (zeros) -> (h (B, S, W), h_final
    (B, W))."""
    B, S, W = a.shape
    build.check_tensors("rglru_fwd", a.device, a=(a, (B, S, W)),
                        b=(b, (B, S, W)))
    _state("rglru_fwd", a.device, W, h0=(h0, B))
    h = torch.empty_like(a)
    hf = torch.empty((B, W), device=a.device, dtype=torch.float32)
    rc = _lib().rglru_fwd(a.data_ptr(), b.data_ptr(), _ptr(h0), h.data_ptr(),
                          hf.data_ptr(), B, S, W, _vec(W, a, b, h0, h, hf),
                          build.stream(a.device))
    build.check(rc, "rglru_fwd")
    LAUNCHES["rglru_fwd"] += 1
    return h, hf


def rglru_bwd(a, h, h0, dh, dh_final=None, need_dh0: bool = False):
    """Gradient of ``rglru_fwd`` from dh (B, S, W) and dh_final (B, W) or
    None -> (da, db (B, S, W), dh0 (B, W) or None)."""
    B, S, W = a.shape
    build.check_tensors("rglru_bwd", a.device, a=(a, (B, S, W)),
                        h=(h, (B, S, W)), dh=(dh, (B, S, W)))
    _state("rglru_bwd", a.device, W, h0=(h0, B), dh_final=(dh_final, B))
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty((B, W), device=a.device, dtype=torch.float32) \
        if need_dh0 else None
    rc = _lib().rglru_bwd(a.data_ptr(), h.data_ptr(), _ptr(h0), dh.data_ptr(),
                          _ptr(dh_final), da.data_ptr(), db.data_ptr(),
                          _ptr(dh0), B, S, W,
                          _vec(W, a, h, h0, dh, dh_final, da, db, dh0),
                          build.stream(a.device))
    build.check(rc, "rglru_bwd")
    LAUNCHES["rglru_bwd"] += 1
    return da, db, dh0


# --------------------------------------------------------------------------- #
# autograd
# --------------------------------------------------------------------------- #
class RGLRUScan(torch.autograd.Function):
    """a, b (B, S, W), h0 (B, W) or None -> (h, h_final)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, hf = (rglru_fwd if a.is_cuda else ref.rglru_scan)(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.set_materialize_grads(False)
        return h, hf

    @staticmethod
    def backward(ctx, dh, dh_final):
        a, h, h0 = ctx.saved_tensors
        dh = torch.zeros_like(h) if dh is None else dh.contiguous()
        if dh_final is not None:
            dh_final = dh_final.contiguous()
        need_dh0 = ctx.needs_input_grad[2]
        bwd = rglru_bwd if a.is_cuda else ref.rglru_scan_bwd
        da, db, dh0 = bwd(a, h, h0, dh, dh_final, need_dh0)
        return da, db, dh0


def rglru_scan(a, b, h0=None):
    """Differentiable ``(h, h_final)`` of the recurrence on contiguous fp32
    (B, S, W) inputs."""
    return RGLRUScan.apply(a, b, h0)
