"""The port's LoRA-matmul (dW included), flash-attention, KD-loss, per-row quantize,
top-k-quantize and DP clip-scale-accumulate ops (their autograd Functions on CPU tensors, i.e. the plain versions of
kernels/ref.py that the CUDA kernels are held against on the card)
against the reference's Pallas kernels run in interpret mode, forward
and gradients.

Same inputs from a numpy seed through both.  Tolerances: fp32 on both
sides with a different summation order, atol 1e-5 / rtol 1e-4 forward and
atol 1e-4 / rtol 1e-4 on gradients; the KD loss and its statistics at the
reference's own bar for its kernel (rtol 1e-4 / atol 1e-5); per-row and
top-k quantization bit for bit; the clipped mean at atol 1e-6, the reference's
bar for its clip kernel (tests/test_privacy.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import kd_loss as jax_kd  # noqa: E402
from repro.kernels.dp_clip import dp_clip_mean_rows as jax_clip  # noqa: E402
from repro.optim import clip as jax_clip_lib  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.quantize import quantize_pack4_rows as jax_pack4  # noqa: E402
from repro.kernels.quantize import quantize_rows as jax_quantize  # noqa: E402
from repro.kernels.quantize import topk_quantize_rows as jax_topk  # noqa: E402
from repro.kernels.lora_matmul import lora_matmul as jax_lora  # noqa: E402
from repro_torch.kernels import kd_loss, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.lora_matmul import lora_matmul  # noqa: E402
from repro_torch.optim import clip as clip_lib  # noqa: E402

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
                                     (77, 64, 128, 8), (100, 160, 48, 16),
                                     (80, 96, 64, 1), (80, 136, 72, 64)])
def test_lora_matmul_matches_pallas(M, K, N, r):
    """Rows 1, 2 and 4 of the kernel table (y, dx, dA, dB) and the plain
    dW of row 3, with a ragged M (no tile divides it on the card); ranks 1
    (one panel fragment, seven columns of it zero) and 64 (eight) and the
    M of a DP batch-1 pass (80), the twins the card holds the fused kernel
    to at those ranks."""
    x, w, a, b, probe = _inputs(M + r, ((M, K), 1.0), ((K, N), 0.05),
                                ((K, r), 0.05), ((r, N), 0.05), ((M, N), 1.0))
    port = _torch_value_and_grads(lora_matmul, (x, w, a, b), probe)
    ref = _jax_value_and_grads(
        lambda *t: jax_lora(*t, interpret=True), (x, w, a, b), probe)
    _assert_match(port, ref, "x w a b".split())


@pytest.mark.parametrize("M,K,N,bm,bk,bn", [(128, 256, 128, 128, 256, 128),
                                            (256, 512, 384, 128, 256, 128),
                                            (128, 1024, 256, 128, 256, 128)])
def test_lora_dw_matches_pallas_dw_call(M, K, N, bm, bk, bn):
    """Row 3: the dW twin against the reference's ``_dw_call`` in
    interpret mode at tests/test_kernels.py's shapes, blocks dividing
    them; g scaled by M^-0.5 so that dW is O(1)."""
    from repro.kernels.lora_matmul import _dw_call
    x, g = _inputs(M + K + N, ((M, K), 1.0), ((M, N), M ** -0.5))
    want = _dw_call(jnp.asarray(x), jnp.asarray(g), bm, bk, bn, True,
                    jnp.float32)
    got = ref.lora_dw(torch.tensor(x), torch.tensor(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)


@pytest.mark.parametrize("transpose_out", [False, True])
@pytest.mark.parametrize("M,L,r,bm,bl", [(128, 256, 8, 128, 128),
                                         (256, 384, 4, 128, 128),
                                         (80, 512, 16, 16, 256),
                                         (384, 128, 64, 128, 128)])
def test_panel_grad_matches_pallas_panel_grad_call(M, L, r, bm, bl,
                                                   transpose_out):
    """Row 4: the panel-gradient twin (dA = xᵀ·gb, and dB = (gᵀ·xa)ᵀ
    transposed out) against the reference's ``_panel_grad_call`` in
    interpret mode, blocks dividing the shapes (M 80: a DP batch-1 pass;
    ranks 4 to 64); the panel scaled by M^-0.5 so that the output is
    O(1)."""
    from repro.kernels.lora_matmul import _panel_grad_call
    lhs, panel = _inputs(M + L + r, ((M, L), 1.0), ((M, r), M ** -0.5))
    want = np.asarray(_panel_grad_call(jnp.asarray(lhs), jnp.asarray(panel),
                                       bm, bl, True, jnp.float32))
    got = ref.panel_grad(torch.tensor(lhs), torch.tensor(panel),
                         transpose_out)
    np.testing.assert_allclose(got.numpy(), want.T if transpose_out else want,
                               **GRAD)


@pytest.mark.parametrize("M,K,N", [(77, 160, 48), (130, 96, 200)])
def test_lora_dw_ragged_matches_reference_ops(M, K, N):
    """Row 3 at a ragged M, K and N through the reference's
    ``kernels/ops.lora_matmul`` (which pads M to its tile): the port's
    LoRAMatmul dW against ``jax.grad`` with respect to W."""
    x, w, a, b, probe = _inputs(M * 7 + N, ((M, K), 1.0), ((K, N), 0.05),
                                ((K, 4), 0.05), ((4, N), 0.05),
                                ((M, N), M ** -0.5))
    want = jax.grad(lambda w_: jnp.sum(jax_ops.lora_matmul(
        jnp.asarray(x), w_, jnp.asarray(a), jnp.asarray(b)) * probe))(
        jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    (lora_matmul(torch.tensor(x), wt, torch.tensor(a), torch.tensor(b))
     * torch.tensor(probe)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want), **GRAD)


def test_lora_matmul_cpu_dw_is_the_twin_bit_for_bit():
    x, w, a, b, g = (torch.tensor(t) for t in _inputs(
        5, ((45, 70), 1.0), ((70, 33), 0.1), ((70, 4), 0.1), ((4, 33), 0.1),
        ((45, 33), 1.0)))
    w.requires_grad_(True)
    lora_matmul(x, w, a, b).backward(g)
    assert a.grad is None and b.grad is None
    assert torch.equal(w.grad, ref.lora_dw(x, g))


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
    # RecurrentGemma's geometry: 10 query heads of 256 on one kv head
    (10, 1, 40, 40, 256, True, 2048, 0),
    # Whisper's cross-attention: non-causal, fewer queries than keys, a
    # key count no tile divides
    (4, 4, 10, 45, 32, False, 0, 0),
    # LLaVA's odd GQA group: 7 query heads a kv head
    (14, 2, 21, 21, 64, True, 0, 0),
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


# --------------------------------------------------------------------------- #
# KD loss (rows 8 and 9)
# --------------------------------------------------------------------------- #
KD = dict(atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("R,V,br,bv", [(64, 1024, 32, 256),
                                       (128, 4096, 64, 512),
                                       (32, 512, 32, 512)])
@pytest.mark.parametrize("T", [1.0, 2.0, 4.0])
def test_kd_loss_fwd_matches_pallas(R, V, br, bv, T):
    """Row 8: the rows and the five statistics (m_t, z_t, m_s, z_s, u) of
    the plain twin against the Pallas forward; the log-softmax oracle
    against the Pallas rows.  The port keeps u relative to the two row
    maxima; the reference's is u + z_t·(m_t − m_s)."""
    t, s = _inputs(R + V, ((R, V), 3.0), ((R, V), 3.0))
    want = [np.asarray(x)[:, 0] for x in jax_kd._fwd_call(
        jnp.asarray(t), jnp.asarray(s), T, br, bv, True)]
    rows, (m_t, z_t, m_s, z_s, u) = ref.kd_loss_fwd(torch.tensor(t),
                                                    torch.tensor(s), T)
    got = [rows, m_t, z_t, m_s, z_s, u + z_t * (m_t - m_s)]
    names = ["rows", "m_t", "z_t", "m_s", "z_s", "u"]
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), w, **KD, err_msg=name)
    np.testing.assert_allclose(
        ref.kd_loss_rows_ref(torch.tensor(t), torch.tensor(s), T).numpy(),
        want[0], **KD)


@pytest.mark.parametrize("T", [1.0, 2.0])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("R,V,bv", [(48, 384, 128), (16, 512, 384)])
def test_kd_loss_grads_match_pallas(R, V, bv, T, masked):
    """Row 9: dt and ds of the masked row mean through the KDLoss
    Function (plain backward twin from the saved statistics) against
    jax.grad through the reference's custom_vjp kernels; V = 512 with
    bv = 384 streams ragged vocab chunks in the reference."""
    t, s, u = _inputs(R + V + int(T) + masked, ((R, V), 3.0), ((R, V), 3.0),
                      ((R,), 1.0))
    mask = (u > -0.5).astype(np.float32) if masked else None

    def port(tt, ss):
        rows = kd_loss.kd_loss_rows(tt, ss, T)
        if mask is None:
            return rows.mean()
        m = torch.tensor(mask)
        return (rows * m).sum() / torch.clamp_min(m.sum(), 1.0)

    def jax_fn(tt, ss):
        return jax_ops.kd_loss(tt, ss, temperature=T, mask=mask, br=16,
                               bv=bv)

    ts = [torch.tensor(x, requires_grad=True) for x in (t, s)]
    out = port(*ts)
    grads = torch.autograd.grad(out, ts)
    want = jax_fn(jnp.asarray(t), jnp.asarray(s))
    want_g = jax.grad(jax_fn, argnums=(0, 1))(jnp.asarray(t), jnp.asarray(s))
    np.testing.assert_allclose(out.item(), float(want), **KD)
    for name, g, w in zip(("teacher", "student"), grads, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KD,
                                   err_msg=name)


def test_kd_loss_zero_when_identical():
    (t,) = _inputs(3, ((32, 2048), 5.0))
    tt = torch.tensor(t)
    rows, _ = ref.kd_loss_fwd(tt, tt, 2.0)
    np.testing.assert_allclose(rows.numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(jax_kd.kd_loss_rows(jnp.asarray(t), jnp.asarray(t),
                                       temperature=2.0, br=32, bv=256)),
        0.0, atol=1e-5)


def test_kd_backward_skips_dt_for_constant_teacher():
    t, s = (torch.tensor(x) for x in _inputs(5, ((6, 77), 3.0),
                                             ((6, 77), 3.0)))
    rows, stats = ref.kd_loss_fwd(t, s, 2.0)
    g = torch.ones(6)
    dt, ds = ref.kd_loss_bwd(t, s, stats, g, 2.0, need_dt=False)
    assert dt is None
    np.testing.assert_array_equal(ds.numpy(), ref.kd_loss_bwd(
        t, s, stats, g, 2.0)[1].numpy())
    leaf = s.clone().requires_grad_(True)
    kd_loss.kd_loss_rows(t, leaf, 2.0).sum().backward()
    np.testing.assert_array_equal(leaf.grad.numpy(), ds.numpy())


def test_kd_loss_stays_finite_on_topk_filled_teacher():
    """Teacher rows after top-k hold -1e9 off the support: exp gives 0 and
    nothing may form inf - inf or 0 * inf.  Rows averaged over uploads
    whose supports differ peak near -1e9/3: the KL must still agree with
    log-softmax (a form that subtracts lse_t ≈ -1.7e8 would not)."""
    t, s = _inputs(11, ((8, 77), 3.0), ((8, 77), 3.0))
    t[:, 8:] = -1e9
    t[4:, :8] = (t[4:, :8] - 2e9) / 3.0
    tt, ss = torch.tensor(t), torch.tensor(s, requires_grad=True)
    rows = kd_loss.kd_loss_rows(tt, ss, 2.0)
    (ds,) = torch.autograd.grad(rows.sum(), ss)
    assert torch.isfinite(rows).all() and torch.isfinite(ds).all()
    np.testing.assert_allclose(rows.detach().numpy(),
                               ref.kd_loss_rows_ref(tt, ss, 2.0).detach()
                               .numpy(), **KD)


# --------------------------------------------------------------------------- #
# Per-row int quantization (rows 10, 11)
# --------------------------------------------------------------------------- #
def _quant_input(R, C, special):
    """Seeded (R, C) rows; with ``special``, row 1 all zeros (the 1e-12
    scale floor) and rows 2, 3 exact half levels: absmax 127 (bits 8) or 7
    (bits 4) makes the scale exactly 1, and +-0.5, 1.5, 2.5 round half to
    even to 0, +-2, +-2."""
    (x,) = _inputs(R * C, ((R, C), 3.0))
    if special:
        halves = [0.5, -0.5, 1.5, -1.5, 2.5, -2.5]
        x[1] = 0.0
        x[2, :] = 0.0
        x[2, 0], x[2, 1:7] = 127.0, halves
        x[3, :] = 0.0
        x[3, 0], x[3, 1:7] = 7.0, halves
    return x


QUANT_SHAPES = [(8, 128, False), (16, 384, False), (32, 1000, False),
                (8, 130, True)]


@pytest.mark.parametrize("R,C,special", QUANT_SHAPES)
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_rows_matches_pallas_bit_for_bit(R, C, special, bits):
    """q and scale equal the reference's oracle bit for bit, and q equals
    quantize_rows in interpret mode (its scale is held at the reference's
    own tolerance, rtol 1e-6: XLA turns the kernel's ``absmax / qmax`` into
    a reciprocal product, one ulp off at times); directly and through
    ops.quantize on a 3-D input."""
    x = _quant_input(R, C, special)
    oracle = jax_ref.quantize_rows_ref(jnp.asarray(x), bits)
    pallas = jax_quantize(jnp.asarray(x), bits=bits, br=8, interpret=True)
    got = ref.quantize_rows_ref(torch.tensor(x), bits)
    for name, g, w in zip(("q", "scale"), got, oracle):
        assert g.numpy().dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(pallas[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(pallas[1]),
                               rtol=1e-6)
    if special:
        qmax = 127 if bits == 8 else 7
        row = 2 if bits == 8 else 3
        assert not got[0][1].any()
        assert float(got[1][1, 0]) == float(np.float32(1e-12))
        np.testing.assert_array_equal(got[0][row, :7].numpy(),
                                      [qmax, 0, 0, 2, -2, 2, -2])
    with ops.policy_scope("torch"):
        q, sc = ops.quantize(torch.tensor(x).reshape(2, R // 2, C), bits)
    assert q.shape == (2, R // 2, C) and sc.shape == (2, R // 2, 1)
    np.testing.assert_array_equal(q.reshape(R, C).numpy(), got[0].numpy())
    np.testing.assert_array_equal(sc.reshape(R, 1).numpy(), got[1].numpy())


@pytest.mark.parametrize("R,C,special", [(8, 128, False), (16, 384, False),
                                         (4, 1000, False), (8, 130, True)])
def test_quantize_pack4_matches_pallas_bit_for_bit(R, C, special):
    """The packed bytes equal quantize_pack4_rows in interpret mode and the
    reference's pack of its oracle levels bit for bit; they unpack to the
    oracle's int4 levels; the scale equals the oracle's."""
    from repro.core import compression as jax_compression
    from repro_torch.core import compression

    x = _quant_input(R, C, special)
    packed, sc = ref.quantize_pack4_rows_ref(torch.tensor(x))
    assert packed.dtype == torch.uint8 and packed.shape == (R, C // 2)
    q_want, sc_want = jax_ref.quantize_rows_ref(jnp.asarray(x), 4)
    pallas = jax_pack4(jnp.asarray(x), br=4, interpret=True)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(pallas[0]))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jax_compression.pack_int4(q_want)))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_want))
    np.testing.assert_allclose(sc.numpy(), np.asarray(pallas[1]), rtol=1e-6)
    np.testing.assert_array_equal(
        compression.unpack_int4(packed, C).numpy(), np.asarray(q_want))


@pytest.mark.parametrize("R,C", [(5, 9), (6, 131), (8, 128)])
def test_ops_quantize_pack4_odd_width_matches_reference(R, C):
    """ops.quantize_pack4 pads an odd width by one zero column, as the
    reference's ops.quantize_pack4 does: the same bytes, and the same
    scales at the reference's tolerance for its Pallas kernel (rtol
    1e-6)."""
    x = _quant_input(R, C, False)
    want = jax_ops.quantize_pack4(jnp.asarray(x).reshape(1, R, C))
    with ops.policy_scope("torch"):
        got = ops.quantize_pack4(torch.tensor(x).reshape(1, R, C))
    assert got[0].shape == (1, R, (C + 1) // 2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6)


def _roundtrip_input(R, C, special):
    """_quant_input's rows; with ``special`` also row 4 of +0.0, -0.0 and
    values whose level rounds to -0 (absmax 7: scale 1 at bits 4, 7/127 at
    bits 8), which the dequantized value must carry as +0.0 (the level is
    an integer there)."""
    x = _quant_input(R, C, special)
    if special:
        x[4, :] = 0.0
        x[4, 0] = 7.0
        x[4, 1:7] = [0.0, -0.0, -0.01, -0.02, 0.01, -1e-30]
    return x


# a row multiple of 4, 2 mod 4, odd, and longer than 2048
ROUNDTRIP_SHAPES = [(8, 128, False), (8, 130, True), (6, 131, True),
                    (5, 2050, True)]


@pytest.mark.parametrize("R,C,special", ROUNDTRIP_SHAPES)
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_roundtrip_rows_matches_reference_bit_for_bit(R, C, special,
                                                            bits):
    """The one-pass roundtrip's twin (row 10's levels dequantized, the
    kernel's plain version on the card) bit for bit, sign of zero
    included, against the reference's ``compression.quant_roundtrip``, and
    against quantize_rows in interpret mode followed by the dequantization:
    its levels times the twin's scale bit for bit, times its own scale at
    the reference's tolerance for that scale (rtol 1e-6: XLA may turn
    ``absmax / qmax`` into a reciprocal product).  Odd widths, widths that
    are 2 mod 4, all-zero rows, half levels and ±0; directly, through
    ops.quant_roundtrip on a 3-D input and through compression's, whose
    wire size is the reference's."""
    from repro.core import compression as jax_compression
    from repro_torch.core import compression

    x = _roundtrip_input(R, C, special)
    want, wire = jax_compression.quant_roundtrip(jnp.asarray(x), bits)
    want = np.asarray(want)
    y, scale = ref.quant_roundtrip_rows_ref(torch.tensor(x), bits)
    assert y.dtype == scale.dtype == torch.float32
    assert y.shape == (R, C) and scale.shape == (R, 1)
    np.testing.assert_array_equal(y.numpy().view(np.int32),
                                  want.view(np.int32))
    q_p, sc_p = jax_quantize(jnp.asarray(x), bits=bits, br=1,
                             interpret=True)
    q_p = np.asarray(q_p).astype(np.float32)
    np.testing.assert_array_equal((q_p * scale.numpy()).view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_allclose(q_p * np.asarray(sc_p), want, rtol=1e-6,
                               atol=0)
    if special:
        assert not y[1].any() and not np.signbit(y.numpy()[4, 1:7]).any()
    with ops.policy_scope("torch"):
        via_ops = ops.quant_roundtrip(torch.tensor(x).reshape(1, R, C), bits)
        via_comp, wire_got = compression.quant_roundtrip(
            torch.tensor(x).reshape(1, R, C), bits)
    for got in (via_ops, via_comp):
        assert got.shape == (1, R, C)
        np.testing.assert_array_equal(got.reshape(R, C).numpy().view(
            np.int32), want.view(np.int32))
    assert wire_got == wire


def test_new_kernel_wrappers_refuse_cpu_tensors():
    """The pair and the roundtrip launch on CUDA tensors only: their
    wrappers, and the roundtrip's dispatch under the ``cuda`` policy,
    raise on a CPU tensor before anything is built."""
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import quantize as qz

    x, g, p = torch.randn(2, 5, 16), torch.randn(2, 5, 8), torch.randn(2, 5, 4)
    with pytest.raises(ValueError, match="CUDA"):
        lm.lora_panel_examples_pair(x, p, g, p)
    with pytest.raises(ValueError, match="CUDA"):
        qz.quant_roundtrip_rows(x[0], 8)
    with ops.policy_scope("cuda"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.quant_roundtrip(x, 8)


# --------------------------------------------------------------------------- #
# Top-k + int quantization (row 12)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("R,C,k,ties", [(8, 128, 8, False),
                                        (16, 500, 16, False),
                                        (4, 64, 1, False),
                                        (8, 77, 8, True)])
@pytest.mark.parametrize("bits", [8, 4])
def test_topk_quantize_matches_pallas_bit_for_bit(R, C, k, bits, ties):
    """q, idx and scale equal the reference's oracle bit for bit, and q and
    idx equal the Pallas kernel's; the tie case repeats values (whole rows
    of one value, and equal values at both ends of a row), so the lower
    index must win as in lax.top_k.  The Pallas kernel's scale may sit
    one ulp off: XLA turns its ``absmax / qmax`` into ``absmax · (1/qmax)``,
    so it is held at the reference's own tolerance for that pair
    (tests/test_kernels.py, rtol 1e-6)."""
    (x,) = _inputs(R + C + k, ((R, C), 3.0))
    if ties:
        x = np.round(x).astype(np.float32)      # many equal values
        x[0] = 1.5
        x[1, [3, 70, 5, 60]] = 9.0
    oracle = jax_ref.topk_quantize_rows_ref(jnp.asarray(x), k, bits)
    pallas = jax_topk(jnp.asarray(x), k=k, bits=bits, br=min(4, R),
                      interpret=True)
    got = ref.topk_quantize_rows_ref(torch.tensor(x), k, bits)
    for name, g, w, p in zip(("q", "idx", "scale"), got, oracle, pallas):
        assert g.numpy().dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        if name == "scale":
            np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(p),
                                          err_msg=name)
    with ops.policy_scope("torch"):
        via_ops = ops.topk_quantize(torch.tensor(x).reshape(2, R // 2, C),
                                    k, bits)
    for g, w in zip(via_ops, got):
        np.testing.assert_array_equal(g.reshape(w.shape).numpy(), w.numpy())


# --------------------------------------------------------------------------- #
# DP-SGD clip-scale-accumulate (rows 13, 14)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B,P,bp,clip,zero_row", [(8, 384, 128, 1.0, False),
                                                  (4, 257, 257, 0.5, False),
                                                  (16, 1000, 200, 20.0, True)])
def test_clip_mean_rows_matches_pallas(B, P, bp, clip, zero_row):
    """The plain version the CUDA kernels are held to, directly and through
    ops.clip_mean_rows, against dp_clip_mean_rows in interpret mode: a
    whole-width block at a ragged width, and a zero row (the EPS guard);
    at (16, 1000) the rows' norms straddle the clip, so some rows are
    scaled and some are not."""
    (g,) = _inputs(B * P, ((B, P), 3.0))
    g *= np.linspace(0.2, 2.0, B, dtype=np.float32)[:, None]
    if zero_row:
        g[3] = 0.0
    norms = np.linalg.norm(g, axis=1)
    if zero_row:
        assert (norms > clip).any() and (norms[norms > 0] < clip).any()
    want = np.asarray(jax_clip(jnp.asarray(g), clip=clip, bp=bp,
                               interpret=True))[0]
    np.testing.assert_allclose(
        ref.clip_mean_rows_ref(torch.tensor(g), clip).numpy(), want,
        atol=1e-6, rtol=0)
    with ops.policy_scope("auto"):
        got = ops.clip_mean_rows(torch.tensor(g), clip)
    assert got.dtype == torch.float32 and got.shape == (P,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ref.clip_norms_ref(torch.tensor(g)).numpy(),
                               (g.astype(np.float64) ** 2).sum(1),
                               rtol=1e-5)


def test_clip_scale_and_eps_match_reference():
    """One EPS for host, twin and kernel, equal to the reference's, and the
    same fp32 scale bit for bit: zero, below-EPS, at-the-clip, and large
    norms."""
    assert clip_lib.EPS == jax_clip_lib.EPS
    norms = np.array([0.0, 1e-12, 1e-9, 0.3, 0.7, 0.7000001, 5.0, 1e30],
                     np.float32)
    for c in (0.7, 1.0, 41.0):
        got = clip_lib._clip_scale(torch.tensor(norms), c)
        want = jax_clip_lib._clip_scale(jnp.asarray(norms), c)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
