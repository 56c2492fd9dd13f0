"""DP-SGD clip-scale-accumulate: the mean of a client's per-example
gradients, each row clipped to L2 norm C,

    out[p] = (1/B) · Σ_b g[b, p] · min(1, C / max(‖g[b]‖, EPS)).

Counterpart of ``dp_clip_mean_rows`` in ``src/repro/kernels/dp_clip.py``.
Its two TPU kernels become the CUDA kernels of ``csrc/dp_clip.cu``:

    dp_clip_norms  <- _norm_kernel      squared row norms (B,), fp32, one
                                        launch of a cluster a row
    dp_clip_acc    <- _clip_acc_kernel  scale each row, mean over rows
    dp_clip_acc_clients <- _clip_acc_kernel under the ``vmap`` over
                                        clients of the spmd backend's
                                        stacked DP-SGD step: (C, B, P)
                                        rows -> (C, P), one launch, each
                                        client's output the bits of
                                        dp_clip_acc on its rows

The stacked step's squared norms stay one ``dp_clip_norms`` launch over
the C·B rows, which are independent.

Forward only, as the reference: the function runs on gradients, after the
backward, so nothing differentiates through it and there is no
``autograd.Function``.  The wrappers take CUDA tensors only (or raise);
kernels/ops.clip_mean_rows takes the plain version
(kernels/ref.clip_mean_rows_ref) for CPU tensors.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.optim.clip import EPS

LAUNCHES = {"dp_clip_norms": 0, "dp_clip_acc": 0, "dp_clip_acc_clients": 0}
MAX_B = 12288           # rows whose scales fit the kernel's shared memory
MAX_NORM_ROWS = 65535   # rows of the norm kernel's grid
MAX_CLIENTS = 65535     # clients of the clip-accumulate kernel's grid
_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("dp_clip")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dp_clip_norms.argtypes = [ptr, ptr, i32, i32, ptr]
        lib.dp_clip_norms.restype = i32
        lib.dp_clip_acc.argtypes = [ptr] * 3 + [i32, i32, f32, f32, i32, ptr]
        lib.dp_clip_acc.restype = i32
        lib.dp_clip_acc_clients.argtypes = [ptr] * 3 + [i32] * 3 + [f32, f32,
                                                                    i32, ptr]
        lib.dp_clip_acc_clients.restype = i32
        _LIB = lib
    return _LIB


def _vec(P: int, *tensors) -> int:
    """1 when the rows can be read as float4: P a multiple of 4 and every
    base 16-byte aligned."""
    return int(P % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def dp_clip_norms(g):
    """g fp32 (B, P) on CUDA -> squared row norms fp32 (B,): one launch,
    no scratch (the kernel picks float4 or scalar loads itself)."""
    B, P = g.shape
    if not 0 < B <= MAX_NORM_ROWS:
        raise ValueError(f"dp_clip_norms: B={B} outside [1, {MAX_NORM_ROWS}]")
    build.check_tensors("dp_clip_norms", g.device, g=(g, (B, P)))
    sq = torch.empty(B, device=g.device, dtype=torch.float32)
    rc = _lib().dp_clip_norms(g.data_ptr(), sq.data_ptr(), B, P,
                              build.stream(g.device))
    build.check(rc, "dp_clip_norms")
    LAUNCHES["dp_clip_norms"] += 1
    return sq


def dp_clip_acc(g, sq, clip: float):
    """g fp32 (B, P), squared norms ``sq`` fp32 (B,) on CUDA -> the mean of
    the clipped rows, fp32 (P,)."""
    B, P = g.shape
    if not 0 < B <= MAX_B:
        raise ValueError(f"dp_clip_acc: B={B} outside [1, {MAX_B}]")
    if not clip > 0:
        raise ValueError(f"dp_clip_acc: clip {clip} must be > 0")
    build.check_tensors("dp_clip_acc", g.device, g=(g, (B, P)),
                        sq=(sq, (B,)))
    out = torch.empty(P, device=g.device, dtype=torch.float32)
    rc = _lib().dp_clip_acc(g.data_ptr(), sq.data_ptr(), out.data_ptr(), B,
                            P, float(clip), EPS, _vec(P, g, out),
                            build.stream(g.device))
    build.check(rc, "dp_clip_acc")
    LAUNCHES["dp_clip_acc"] += 1
    return out


def dp_clip_acc_clients(g, sq, clip: float):
    """g fp32 (C, B, P), squared norms ``sq`` fp32 (C, B) on CUDA -> each
    client's mean of its clipped rows, fp32 (C, P): one launch, client c's
    row the bits of ``dp_clip_acc(g[c], sq[c], clip)``."""
    C, B, P = g.shape
    if not 0 < C <= MAX_CLIENTS:
        raise ValueError(f"dp_clip_acc_clients: C={C} outside "
                         f"[1, {MAX_CLIENTS}]")
    if not 0 < B <= MAX_B:
        raise ValueError(f"dp_clip_acc_clients: B={B} outside [1, {MAX_B}]")
    if not clip > 0:
        raise ValueError(f"dp_clip_acc_clients: clip {clip} must be > 0")
    build.check_tensors("dp_clip_acc_clients", g.device, g=(g, (C, B, P)),
                        sq=(sq, (C, B)))
    out = torch.empty((C, P), device=g.device, dtype=torch.float32)
    rc = _lib().dp_clip_acc_clients(g.data_ptr(), sq.data_ptr(),
                                    out.data_ptr(), C, B, P, float(clip), EPS,
                                    _vec(P, g, out), build.stream(g.device))
    build.check(rc, "dp_clip_acc_clients")
    LAUNCHES["dp_clip_acc_clients"] += 1
    return out


def clip_mean_rows(g, clip: float):
    """g fp32 (B, P) on CUDA -> (P,) fp32 mean of the rows clipped to L2
    norm ``clip``: the norm kernel, then the clip-accumulate kernel."""
    return dp_clip_acc(g, dp_clip_norms(g), clip)


def clip_mean_rows_clients(g, clip: float):
    """g fp32 (C, B, P) on CUDA -> (C, P) fp32, each client's mean of its
    rows clipped to L2 norm ``clip``: one norm launch over the C·B rows,
    then one clip-accumulate launch with the client on a grid axis."""
    C, B, P = g.shape
    sq = dp_clip_norms(g.view(C * B, P))
    return dp_clip_acc_clients(g, sq.view(C, B), clip)
