"""The port's LoRA-matmul and flash-attention ops (their autograd Functions
on CPU tensors, i.e. the plain versions of kernels/ref.py that the CUDA
kernels are held against on the card) against the reference's Pallas
kernels run in interpret mode, forward and gradients.

Same inputs from a numpy seed through both.  Tolerances: fp32 on both
sides with a different summation order, atol 1e-5 / rtol 1e-4 forward and
atol 1e-4 / rtol 1e-4 on gradients."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.lora_matmul import lora_matmul as jax_lora  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.lora_matmul import lora_matmul  # noqa: E402

FWD = dict(atol=1e-5, rtol=1e-4)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, *shapes_scales):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * sc).astype(np.float32)
            for s, sc in shapes_scales]


def _torch_value_and_grads(fn, arrays, probe):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad((out * torch.tensor(probe)).sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_value_and_grads(fn, arrays, probe):
    args = [jnp.asarray(a) for a in arrays]
    out = fn(*args)
    grads = jax.grad(lambda *xs: jnp.sum(fn(*xs) * probe),
                     argnums=tuple(range(len(args))))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assert_match(port, ref, names):
    np.testing.assert_allclose(port[0], ref[0], **FWD, err_msg="forward")
    for name, gp, gr in zip(names, port[1], ref[1]):
        np.testing.assert_allclose(gp, gr, **GRAD, err_msg=name)


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("M,K,N,r", [(37, 96, 64, 2), (50, 128, 96, 4),
                                     (77, 64, 128, 8), (100, 160, 48, 16)])
def test_lora_matmul_matches_pallas(M, K, N, r):
    """Rows 1, 2 and 4 of the kernel table (y, dx, dA, dB) and the plain
    dW of row 3, with a ragged M (no tile divides it on the card)."""
    x, w, a, b, probe = _inputs(M + r, ((M, K), 1.0), ((K, N), 0.05),
                                ((K, r), 0.05), ((r, N), 0.05), ((M, N), 1.0))
    port = _torch_value_and_grads(lora_matmul, (x, w, a, b), probe)
    ref = _jax_value_and_grads(
        lambda *t: jax_lora(*t, interpret=True), (x, w, a, b), probe)
    _assert_match(port, ref, "x w a b".split())


def test_lora_matmul_skips_dw_for_frozen_base():
    x, w, a, b = (torch.randn(8, 16), torch.randn(16, 12),
                  torch.randn(16, 4, requires_grad=True),
                  torch.randn(4, 12, requires_grad=True))
    lora_matmul(x, w, a, b).sum().backward()
    assert w.grad is None and a.grad is not None and b.grad is not None


# --------------------------------------------------------------------------- #
ATTN_CASES = [
    # BH, BKV, Sq, Skv, D, causal, window, q_offset
    (4, 4, 24, 24, 32, True, 0, 0),
    (4, 2, 24, 32, 32, True, 16, 8),
    (2, 2, 40, 40, 64, False, 0, 0),
    (6, 2, 32, 32, 64, True, 8, 0),
    (2, 1, 16, 48, 32, True, 0, 32),
]


@pytest.mark.parametrize("BH,BKV,Sq,Skv,D,causal,window,q_offset", ATTN_CASES)
def test_flash_attention_matches_pallas(BH, BKV, Sq, Skv, D, causal, window,
                                        q_offset):
    """Rows 5, 6 and 7: o, dq and the GQA-summed dk/dv."""
    q, k, v, probe = _inputs(BH + Sq + D, ((BH, Sq, D), 1.0),
                             ((BKV, Skv, D), 1.0), ((BKV, Skv, D), 1.0),
                             ((BH, Sq, D), 1.0))
    port = _torch_value_and_grads(
        lambda *t: flash_attention(*t, causal, window, q_offset), (q, k, v),
        probe)
    ref = _jax_value_and_grads(
        lambda *t: jax_flash(*t, causal=causal, window=window,
                             q_offset=q_offset, interpret=True),
        (q, k, v), probe)
    _assert_match(port, ref, "qkv")


def test_ops_layouts_match_reference_ops():
    """kernels/ops on model layouts, (..., K) and (B, S, H, D), under the
    plain policy against the reference's ops."""
    from repro.kernels import ops as ref_ops
    x, w, a, b = _inputs(3, ((2, 12, 64), 1.0), ((64, 32), 0.1),
                         ((64, 4), 0.1), ((4, 32), 0.1))
    q, k, v = _inputs(4, ((2, 16, 4, 32), 1.0), ((2, 16, 2, 32), 1.0),
                      ((2, 16, 2, 32), 1.0))
    t = [torch.tensor(z) for z in (x, w, a, b, q, k, v)]
    with ops.policy_scope("auto"):
        y = ops.lora_matmul(*t[:4]).numpy()
        o = ops.mha_attention(*t[4:], causal=True, window=8).numpy()
    np.testing.assert_allclose(y, np.asarray(ref_ops.lora_matmul(x, w, a, b)),
                               **FWD)
    np.testing.assert_allclose(
        o, np.asarray(ref_ops.mha_attention(q, k, v, causal=True, window=8)),
        **FWD)
