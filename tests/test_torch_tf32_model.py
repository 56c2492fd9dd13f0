"""A numpy model of the 3xTF32 arithmetic of the dense dW kernel
(``lora_dw_kernel`` in src/repro_torch/kernels/csrc/lora_matmul.cu), which
runs dW = xᵀg on the tensor cores (wgmma, TF32 operands, fp32 sums).

What the model copies from the kernel:

* ``split_fast`` (csrc/mma_tf32.cuh) as integer operations on the int32
  view of fp32: big = (u + 0x1000) & 0xffffe000 (round to nearest, ties
  away: the bits of cvt.rna.tf32), small = x − big left in fp32, of which
  the tensor core reads the top 19 bits (a truncation);
* each step of 8 rows of M as three products, small·big, big·small,
  big·big, in that order, each product exact and each step's sum with
  the accumulator rounded once to fp32;
* the contraction summed in blocks of ``block`` rows, each into a fresh
  accumulator that is then added to the running fp32 total, and the M
  slices' totals added in slice order (the fixed-order second pass).

Its one known gap: the tensor cores' own accumulation (eight products and
the accumulator) is not IEEE round-to-nearest; here it is.  So the model
can rank block lengths and show what the split costs, and the kernel's
error against fp64 on the card (chip_smoke.py phase 2, within 1.5x
cuBLAS's) decides.

The bar: at M 1280 (every case study's) the model's rms error against an
fp64 product stays within 1.5x that of a plain fp32 ``x.t() @ g`` (torch on
the CPU), and one TF32 pass (operands rounded to TF32, one product) falls
outside it by 10x or more.  Pure numpy and torch on the CPU, a few
milliseconds a case.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "lora_matmul.cu")
# the fresh-accumulator lengths (rows of M) the model ranks; the kernel's
# DW_BLOCK must be one of them
BLOCKS = (8, 32, 128)
M, K, N = 1280, 64, 48
FP32_FACTOR, TF32_FACTOR = 1.5, 10.0


def split_fast(x):
    """(big, small as the tensor core reads it) of fp32 ``x``."""
    u = x.view(np.uint32)
    big = ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    small = (x - big).view(np.uint32) & np.uint32(0xFFFFE000)
    return big, small.view(np.float32)


def _step(acc, a, b):
    """acc + aᵀb over one step of rows, the products exact, one fp32
    rounding."""
    return (acc.astype(np.float64)
            + a.T.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def dw_3xtf32(x, g, block, slices=1):
    """dW = xᵀg as the kernel sums it (module docstring)."""
    rows = x.shape[0]
    xb, xs = split_fast(x)
    gb, gs = split_fast(g)
    blocks = -(-rows // block)
    per = -(-blocks // slices) * block
    out = None
    for z0 in range(0, rows, per):
        tot = np.zeros((x.shape[1], g.shape[1]), np.float32)
        for b0 in range(z0, min(rows, z0 + per), block):
            acc = np.zeros_like(tot)
            for s in range(b0, min(rows, b0 + block), 8):
                for a, b in ((xs, gb), (xb, gs), (xb, gb)):
                    acc = _step(acc, a[s:s + 8], b[s:s + 8])
            tot = tot + acc
        out = tot if out is None else out + tot
    return out


def dw_tf32(x, g):
    """One TF32 pass: operands rounded to TF32, one accumulator over M."""
    xb, gb = split_fast(x)[0], split_fast(g)[0]
    acc = np.zeros((x.shape[1], g.shape[1]), np.float32)
    for s in range(0, x.shape[0], 8):
        acc = _step(acc, xb[s:s + 8], gb[s:s + 8])
    return acc


@pytest.fixture(scope="module")
def case():
    """x (M, K), g (M, N) scaled by M^-0.5 (O(1) outputs, as chip_smoke's
    cases), the fp64 product and plain fp32's rms error against it."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((M, K)).astype(np.float32)
    g = (rng.standard_normal((M, N)) * M ** -0.5).astype(np.float32)
    exact = x.astype(np.float64).T @ g.astype(np.float64)
    plain = (torch.from_numpy(x).t() @ torch.from_numpy(g)).numpy()
    return x, g, exact, rms(plain, exact)


def rms(got, exact):
    return float(np.sqrt(np.mean((got.astype(np.float64) - exact) ** 2)))


def test_split_fast_is_exact_and_rounds_to_nearest():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 4, 4096)
         ).astype(np.float32)
    big, small = split_fast(x)
    assert np.all((big.view(np.uint32) & 0x1FFF) == 0)     # TF32 bits
    assert np.all(np.abs(x - big) <= np.abs(x) * 2.0 ** -11)
    # x − big is exact in fp32, so big + (x − big) gives x back
    assert np.array_equal(big + (x - big), x)
    assert np.all(np.abs(x - big - small) <= np.abs(x) * 2.0 ** -21)


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("block", BLOCKS)
def test_3xtf32_dw_is_within_fp32s_error(case, block, slices):
    x, g, exact, fp32 = case
    got = rms(dw_3xtf32(x, g, block, slices), exact)
    assert got <= FP32_FACTOR * fp32, (block, slices, got, fp32)


def test_one_tf32_pass_falls_far_outside(case):
    x, g, exact, fp32 = case
    assert rms(dw_tf32(x, g), exact) >= TF32_FACTOR * fp32


def test_kernels_block_length_is_a_modelled_one():
    """The kernel's fresh-accumulator length is one the model holds to the
    bar, and whole stages of its pipeline."""
    text = SOURCE.read_text()
    block = int(re.search(r"constexpr int DW_BLOCK = (\d+);", text)[1])
    stage = int(re.search(r"constexpr int DW_BK = (\d+);", text)[1])
    assert block in BLOCKS and block % stage == 0
