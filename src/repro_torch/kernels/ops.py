"""Model-facing kernel calls and the kernel dispatch layer.

Counterpart of ``src/repro/kernels/ops.py``.  ``ModelConfig.kernel_policy``
(``torch | cuda | auto``) becomes the ambient policy scope here, entered
by models/factory.Model.forward; peft/lora.lora_apply and
models/attention.attention_fwd call ``lora_matmul`` and ``mha_attention``,
which follow it:

    ``cuda``  — the differentiable CUDA kernels (kernels/lora_matmul.py,
                kernels/flash_attention.py).  The tensors must be on a CUDA
                device: a CPU tensor raises rather than falling back.
    ``torch`` — the plain PyTorch versions (kernels/ref.py) on whatever
                device the tensors live, differentiated by autograd.
    ``auto``  — ``cuda`` for CUDA tensors, ``torch`` for CPU tensors.  It
                is also the policy outside any scope.

The kernels mask their ragged edges, so unlike the reference there is no
block fitting and no padding of M here.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lora_matmul as _lm
from repro_torch.kernels import ref

POLICIES = ("torch", "cuda", "auto")
_ACTIVE = "auto"


def resolve(policy: str, device) -> str:
    """``auto`` -> ``cuda`` for a CUDA device, ``torch`` otherwise."""
    if policy not in POLICIES:
        raise ValueError(f"unknown kernel_policy {policy!r} "
                         f"(expected one of {POLICIES})")
    if policy == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return policy


@contextlib.contextmanager
def policy_scope(policy: str):
    """Make ``policy`` the ambient kernel policy; ``auto`` is resolved per
    call against the device of the tensors it is given."""
    global _ACTIVE
    resolve(policy, "cpu")                  # validates the name
    prev = _ACTIVE
    _ACTIVE = policy
    try:
        yield
    finally:
        _ACTIVE = prev


def use_cuda(t: torch.Tensor) -> bool:
    return resolve(_ACTIVE, t.device) == "cuda"


def _require_cuda(op: str, *tensors) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{op}: kernel policy 'cuda' needs CUDA tensors, "
                             f"got one on {t.device}")


def lora_matmul(x, w, a, b):
    """x: (..., K) -> (..., N): x@W + (x@A)@B, differentiable."""
    if not use_cuda(x):
        return ref.lora_matmul_ref(x, w, a, b)
    _require_cuda("lora_matmul", x, w, a, b)
    *lead, K = x.shape
    out = _lm.lora_matmul(x.reshape(math.prod(lead), K).contiguous(), w, a, b)
    return out.reshape(*lead, w.shape[1])


def mha_attention(q, k, v, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D) -> (B, Sq, H, D).

    Same transposes as the reference: heads move next to the batch into
    the kernel layout (B·H, S, D), and back."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    qf = q.transpose(1, 2).reshape(B * H, Sq, D)
    kf = k.transpose(1, 2).reshape(B * KV, Skv, D)
    vf = v.transpose(1, 2).reshape(B * KV, Skv, D)
    if use_cuda(q):
        _require_cuda("mha_attention", q, k, v)
        out = _fa.flash_attention(qf.contiguous(), kf.contiguous(),
                                  vf.contiguous(), causal, window, q_offset)
    else:
        out = ref.attention_ref(qf, kf, vf, causal, window, q_offset)
    return out.reshape(B, H, Sq, D).transpose(1, 2)


def launches() -> dict:
    """Launch counts of every ported kernel since the last reset."""
    return {**_lm.LAUNCHES, **_fa.LAUNCHES}


def reset_launches() -> None:
    _lm.reset_launches()
    _fa.reset_launches()
