"""Flash attention with causal masking, sliding windows, ``q_offset`` and
GQA, differentiable.

Counterpart of ``src/repro/kernels/flash_attention.py``.  The TPU kernels
become the CUDA kernels of ``csrc/flash_attention.cu``:

    flash_fwd  <- _fwd_call     o and the per-row logsumexp lse
    flash_dq   <- _bwd_call's _dq_kernel
    flash_dkv  <- _bwd_call's _dkv_kernel (GQA group summed over head
                  chunks in a fixed order)

Layout: q (BH, Sq, D), k/v (BKV, Skv, D), BH = B·H, BKV = B·KV; GQA maps
query head bh to kv head bh // (BH // BKV).  ``FlashAttention`` is the
``torch.autograd.Function``: for CUDA tensors it launches the kernels (or
raises), for CPU tensors it takes the plain versions in kernels/ref.py.
Its backward forms D = rowsum(do∘o) with one PyTorch expression, as the
reference does outside its kernels.

Each kernel wrapper adds one to ``LAUNCHES[name]`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
D_MAX = 256
_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i32] * 5 + [f32] + [i32] * 3 + [ptr]
        lib.flash_fwd.argtypes = [ptr] * 5 + tail
        lib.flash_dq.argtypes = [ptr] * 7 + tail
        lib.flash_dkv.argtypes = [ptr] * 9 + tail
        lib.flash_dkv_chunks.argtypes = [i32] * 3
        for fn in (lib.flash_fwd, lib.flash_dq, lib.flash_dkv,
                   lib.flash_dkv_chunks):
            fn.restype = i32
        _LIB = lib
    return _LIB


def _dims(kernel: str, q, k):
    BH, Sq, D = q.shape
    BKV, Skv, _ = k.shape
    if not 0 < D <= D_MAX:
        raise ValueError(f"{kernel}: head dim {D} outside [1, {D_MAX}]")
    if BKV == 0 or BH % BKV:
        raise ValueError(f"{kernel}: {BH} query heads not a multiple of "
                         f"{BKV} kv heads")
    return BH, BKV, Sq, Skv, D


def _cfg(causal: bool, window: int, q_offset: int):
    return int(bool(causal)), int(window), int(q_offset)


# --------------------------------------------------------------------------- #
# Kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------- #
def flash_fwd(q, k, v, causal: bool = True, window: int = 0,
              q_offset: int = 0):
    """-> (o (BH, Sq, D), lse (BH, Sq) fp32)."""
    BH, BKV, Sq, Skv, D = _dims("flash_fwd", q, k)
    build.check_tensors("flash_fwd", q.device, q=(q, (BH, Sq, D)),
                        k=(k, (BKV, Skv, D)), v=(v, (BKV, Skv, D)))
    o = torch.empty_like(q)
    lse = torch.empty((BH, Sq), device=q.device, dtype=torch.float32)
    rc = _lib().flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr(), BH, BKV, Sq, Skv, D,
                          D ** -0.5, *_cfg(causal, window, q_offset),
                          build.stream(q.device))
    build.check(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _bwd_check(kernel, q, k, v, do, lse, dd):
    BH, BKV, Sq, Skv, D = _dims(kernel, q, k)
    build.check_tensors(kernel, q.device, q=(q, (BH, Sq, D)),
                        k=(k, (BKV, Skv, D)), v=(v, (BKV, Skv, D)),
                        do=(do, (BH, Sq, D)), lse=(lse, (BH, Sq)),
                        dd=(dd, (BH, Sq)))
    return BH, BKV, Sq, Skv, D


def flash_dq(q, k, v, do, lse, dd, causal: bool = True, window: int = 0,
             q_offset: int = 0):
    """dq (BH, Sq, D); ``dd`` = rowsum(do∘o) of shape (BH, Sq)."""
    BH, BKV, Sq, Skv, D = _bwd_check("flash_dq", q, k, v, do, lse, dd)
    dq = torch.empty_like(q)
    rc = _lib().flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
                         dq.data_ptr(), BH, BKV, Sq, Skv, D, D ** -0.5,
                         *_cfg(causal, window, q_offset),
                         build.stream(q.device))
    build.check(rc, "flash_dq")
    LAUNCHES["flash_dq"] += 1
    return dq


def flash_dkv(q, k, v, do, lse, dd, causal: bool = True, window: int = 0,
              q_offset: int = 0):
    """(dk, dv), each (BKV, Skv, D), summed over the GQA group.  Where the
    kernel splits each group into head chunks to fill the card, the
    chunks' partial sums go into a workspace allocated here and are added
    in a fixed order."""
    BH, BKV, Sq, Skv, D = _bwd_check("flash_dkv", q, k, v, do, lse, dd)
    lib = _lib()
    chunks = lib.flash_dkv_chunks(BH, BKV, Skv)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ws = torch.empty((2, chunks, BKV, Skv, D), device=q.device,
                     dtype=torch.float32) if chunks > 1 else None
    rc = lib.flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
                       dk.data_ptr(), dv.data_ptr(),
                       None if ws is None else ws.data_ptr(), BH, BKV, Sq,
                       Skv, D, D ** -0.5, *_cfg(causal, window, q_offset),
                       build.stream(q.device))
    build.check(rc, "flash_dkv")
    LAUNCHES["flash_dkv"] += 1
    return dk, dv


# --------------------------------------------------------------------------- #
# autograd
# --------------------------------------------------------------------------- #
class FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        fwd = flash_fwd if q.is_cuda else ref.attention_fwd
        o, lse = fwd(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dd = (do * o).sum(-1)
        if do.is_cuda:
            dq = flash_dq(q, k, v, do, lse, dd, *ctx.cfg)
            dk, dv = flash_dkv(q, k, v, do, lse, dd, *ctx.cfg)
        else:
            dq = ref.attention_dq(q, k, v, do, lse, dd, *ctx.cfg)
            dk, dv = ref.attention_dkv(q, k, v, do, lse, dd, *ctx.cfg)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q: (BH, Sq, D); k, v: (BKV, Skv, D) -> (BH, Sq, D), differentiable."""
    return FlashAttention.apply(q, k, v, causal, window, q_offset)
