"""Streaming KD distillation loss: per-row
``KL(softmax(t/T) || softmax(s/T)) · T²``, differentiable.

Counterpart of ``src/repro/kernels/kd_loss.py``.  The TPU kernels become
the CUDA kernels of ``csrc/kd_loss.cu``:

    kd_fwd  <- _fwd_call    the rows and five row statistics
                            (m_t, z_t, m_s, z_s, u), the only residuals
    kd_bwd  <- _bwd_call    ds = g·T·(q − p) and, when asked,
                            dt = g·T·p(log p − log q − KL)

``KDLoss`` is the ``torch.autograd.Function`` that mirrors the reference's
``custom_vjp``: the forward saves the two logit tensors and the five (R,)
statistics, nothing else of size (R, V); the backward always forms ``ds``
and forms ``dt`` only when the teacher needs a gradient (in KD it is a
constant).  For CUDA tensors it launches the kernels (or raises); for CPU
tensors it takes the plain versions in kernels/ref.py.

Each kernel wrapper adds one to ``LAUNCHES[name]`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"kd_fwd": 0, "kd_bwd": 0}
_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("kd_loss")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.kd_fwd.argtypes = [ptr] * 8 + [i32, i32, f32, ptr]
        lib.kd_fwd.restype = i32
        lib.kd_bwd.argtypes = [ptr] * 10 + [i32, i32, f32, ptr]
        lib.kd_bwd.restype = i32
        lib.kd_narrow_max.argtypes = []
        lib.kd_narrow_max.restype = i32
        _LIB = lib
    return _LIB


def narrow_max() -> int:
    """The widest row ``kd_fwd`` holds in registers (csrc/kd_loss.cu's
    NARROW_MAX): the crossover between its two regimes.  Loads the
    library, so it needs the built kernels."""
    return int(_lib().kd_narrow_max())


def _temperature(kernel: str, temperature: float) -> float:
    if not temperature > 0:
        raise ValueError(f"{kernel}: temperature {temperature} must be > 0")
    return float(temperature)


# --------------------------------------------------------------------------- #
# Kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------- #
def kd_fwd(teacher, student, temperature: float = 1.0):
    """teacher, student (R, V) -> (rows (R,), (m_t, z_t, m_s, z_s, u))."""
    R, V = teacher.shape
    temp = _temperature("kd_fwd", temperature)
    build.check_tensors("kd_fwd", teacher.device, teacher=(teacher, (R, V)),
                        student=(student, (R, V)))
    rows, *stats = torch.empty((6, R), device=teacher.device,
                               dtype=torch.float32)
    rc = _lib().kd_fwd(teacher.data_ptr(), student.data_ptr(),
                       rows.data_ptr(), *(x.data_ptr() for x in stats),
                       R, V, temp, build.stream(teacher.device))
    build.check(rc, "kd_fwd")
    LAUNCHES["kd_fwd"] += 1
    return rows, tuple(stats)


def kd_bwd(teacher, student, stats, g, temperature: float = 1.0,
           need_dt: bool = True):
    """(dt or None, ds), each (R, V), from the forward's statistics and the
    upstream gradient ``g`` (R,) of the rows."""
    R, V = teacher.shape
    temp = _temperature("kd_bwd", temperature)
    names = ("m_t", "z_t", "m_s", "z_s", "u")
    build.check_tensors("kd_bwd", teacher.device, teacher=(teacher, (R, V)),
                        student=(student, (R, V)), g=(g, (R,)),
                        **{n: (x, (R,)) for n, x in zip(names, stats)})
    ds = torch.empty((R, V), device=teacher.device, dtype=torch.float32)
    dt = torch.empty_like(ds) if need_dt else None
    rc = _lib().kd_bwd(teacher.data_ptr(), student.data_ptr(),
                       *(x.data_ptr() for x in stats), g.data_ptr(),
                       dt.data_ptr() if need_dt else None, ds.data_ptr(),
                       R, V, temp, build.stream(teacher.device))
    build.check(rc, "kd_bwd")
    LAUNCHES["kd_bwd"] += 1
    return dt, ds


# --------------------------------------------------------------------------- #
# autograd
# --------------------------------------------------------------------------- #
class KDLoss(torch.autograd.Function):
    """teacher, student (R, V) -> per-row KL · T² (R,)."""

    @staticmethod
    def forward(ctx, teacher, student, temperature):
        fwd = kd_fwd if teacher.is_cuda else ref.kd_loss_fwd
        rows, stats = fwd(teacher, student, temperature)
        ctx.save_for_backward(teacher, student, *stats)
        ctx.temperature = temperature
        return rows

    @staticmethod
    def backward(ctx, g):
        teacher, student, *stats = ctx.saved_tensors
        bwd = kd_bwd if g.is_cuda else ref.kd_loss_bwd
        dt, ds = bwd(teacher, student, tuple(stats), g.contiguous(),
                     ctx.temperature, need_dt=ctx.needs_input_grad[0])
        return dt, ds, None


def kd_loss_rows(teacher, student, temperature: float = 1.0):
    """Differentiable per-row KD loss (R,) of (R, V) logits; the mean over
    rows (and masking) is kernels/ops.kd_loss's."""
    return KDLoss.apply(teacher, student, float(temperature))
