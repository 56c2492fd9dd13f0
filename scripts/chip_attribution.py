#!/usr/bin/env python3
"""Which kernels move the final LoRA of chip_smoke.py's phase 7 (FedLLM on
RecurrentGemma-2B at full width and depth, seed 0, phase 3's data) away
from the plain-PyTorch run, on one CUDA card:

    python3 scripts/chip_attribution.py

or, with ``rwkv``, where phase 8's runs (FedLLM on RWKV-6 Finch 1.6B)
part: six train steps from the run's initial LoRA under each of
chip_smoke.py's four settings (kernels, plain, the other BLAS library,
TF32), printing each step's loss and the LoRA's relative L2 distance
from the plain run's (all factors, and the B factors alone):

    python3 scripts/chip_attribution.py rwkv

Runs the plain run (kernel policy ``torch``), then kernel runs (policy
``cuda``) with one op family at a time sent back to plain PyTorch (the
LoRA projection, the attention, the RG-LRU scan), and with only the
RG-LRU scan on its kernels; prints each run's relative L2 distance from
the plain run's final LoRA, its per-round loss differences and its
kernel launches.  Then the fp32 error of the LoRA forward, dx, dW and
panel-gradient kernels, of cuBLAS and of cuBLASLt against fp64 products at GPT-2's and
RecurrentGemma-2B's projection shapes; that part alone:

    python3 scripts/chip_attribution.py fp64

With ``split``, why phase 6's fp32 Split runs (GPT-2 at full width, split
after layer 2, fp32 boundary) part from fp64 more often through the
kernels than through plain PyTorch: for the kernel and plain runs, from
the seed-0 weights and from nudged copy 2, each of round 0's nine steps
replayed beside an fp64 replay of the same weights, printing the LoRA's
relative L2 from it, the coordinates more than lr/2 away and, where they
first appear, the gradient there against the fp64 one.  Then, for the
plain run and every kernel run of split_configs (all kernels; one family
sent back to plain PyTorch, as the default mode does it: the LoRA
projection, rows 1, 2, 4, or the attention, rows 5-7; one kernel at a
time, its wrapper replaced by its twin: rows 1, 2, 5, 6, 7; row 1 with
only its y or only its saved x@A panel from plain PyTorch; and the
arithmetic variants of SPLIT_VARIANTS, each a library built from a
patched copy of csrc/), from the seed-0 weights and nudged copies 0-7:
round 0's first LoRA gradient against the fp64 one of the same weights
(relative L2, leaf by leaf, at the coordinates whose fp64 value is below
1e-3 of its leaf's rms, and the coordinates of Adam's first update that
move by over lr/2, and where they move from the seed-0 weights), then
the final LoRA of full runs, each measured from one fp64 run of the
same weights that all share, with how many of the weight sets part (above PARTS_AT from their fp64 run) and the one-sided
Fisher exact p that a kernel run parts more often than plain; then the
int8 set's spread: plain runs from nudged copies 0-11, kernel runs from
0-5 and TF32 runs from 0-2, measured from the plain run.  A count after
``split`` takes that many nudged copies instead of 8 (each about 1.5 s
a run); keys after it (``lora``, ``attention``, ``row1``, ``row2``,
``row5``, ``row6``, ``row7``, ``row1-xa``, ``row1-y`` or a SPLIT_VARIANTS
key) run only those kernel runs beside the kernels and plain (all of
them take about twenty minutes at 30 copies):

    python3 scripts/chip_attribution.py split [COPIES] [KEY ...]

With ``kblock KB``, chip_smoke.py's precision gates with the fused LoRA
kernel summing K in blocks of KB instead of the source's: a copy of
src/repro_torch and chip_smoke.py under build/kblock-KB/ with that one
constant changed runs the LoRA kernels' fp64 errors, phases 3-7 and 9
and phase 8's first-step gate, and prints every gate, none stopping the
run (the K block of the source was chosen this way):

    python3 scripts/chip_attribution.py kblock 128

With ``dw``, where the dense dW kernel (``lora_dw_kernel``, wgmma in
3xTF32) spends its time: copies of csrc/lora_matmul.cu under
build/dw-ablation/ with one part of its stage loop taken out (DW_ABLATIONS:
the loads after the first two stages, the products, or two of each step's
three products), each built with the port's flags and timed beside the
kernel and ``x.t() @ g`` at GPT-2's, RecurrentGemma-2B's and RWKV-6's
(1280, K, N), in turns; the ablated copies compute wrong values by design
(under a minute):

    python3 scripts/chip_attribution.py dw

With ``wkv``, where the WKV backward (``rwkv6_bwd_kernel``, each chunk in
closed form) spends its time: copies of csrc/rwkv6_scan.cu under
build/wkv-ablation/ with one phase taken out (WKV_ABLATIONS), each timed
in a CUDA graph beside the kernel at the train step's (512, 80, 64), in
turns; the ablated copies compute wrong values by design (under a
minute):

    python3 scripts/chip_attribution.py wkv

With ``pair``, what sets the time of row 4ᵉ's pair
(``lora_panel_examples_pair``) and of the Split boundary's roundtrip
(``quant_roundtrip_rows``): copies of csrc/ under build/pair-ablation/
with one design choice changed (PAIR_VARIANTS, ROUNDTRIP_VARIANTS), their
ptxas registers and spills, and each timed in a CUDA graph (the faster
of two turns) beside the shipped kernel, its old way (two
lora_panel_examples launches; quantize_rows, then q.float() and *
scale) and the library (two torch.bmm calls; the eager quantize chain),
at the DP step's four LoRA sites and at the boundary's widths; every
variant must give the shipped kernel's bits (under a minute):

    python3 scripts/chip_attribution.py pair

With ``kd``, the design choices of row 8's forward (``kd_fwd``): copies of
csrc/kd_loss.cu under build/kd-ablation/ with one choice changed
(kd_variants: the online kernel row 8 shipped before its redesign, the
streaming kernel at every V, division in place of the reciprocal,
narrow blocks of 32 or 128 threads, narrow rows
to V 2048, clusters of at most 1, 2 or 8 blocks a wide row or of
smaller blocks, 2 or 8 loads in flight), their ptxas registers and spills, each held to the plain twin
and timed in a CUDA graph (the faster of two turns) beside the shipped
kernel and F.kl_div at the main path's (64, 77) with a top-k teacher, at
the generative (1280, 50257), and at R 64 and 1280 across the two
regimes' crossover and the wide kernel's cluster sizes (V 512,
NARROW_MAX, NARROW_MAX + 1, 2048 to 32768), all at T 2 (about a
minute):

    python3 scripts/chip_attribution.py kd

With ``nan``, what keeping NaN costs the quantizers (rows 10, 11, 12):
copies of csrc/quantize.cu under build/nan-ablation/ with the NaN-keeping
maximum and level written another way (NAN_VARIANTS: "shipped", the
source as it is; "select", a compare and select; "fmaxf", fmaxf / fminf
and no NaN key, which drop NaN as the kernels did before; "parent", the
source before the kernels kept NaN, "fmaxf" with the warp top-k comparing
floats again), their ptxas registers and spills, each held bit for bit
to the shipped wrapper on finite rows (and, but for "fmaxf" and
"parent", to the twin on chip_smoke's non-finite rows) and timed in a
CUDA graph (the faster of two turns) in turns: the roundtrip at
(1280, 768) int8 and (1280, 2560), the levels and the int4 pack at
(1280, 768), the top-k at (150, 77) k 8 and (1280, 50257) k 64 (under a
minute):

    python3 scripts/chip_attribution.py nan

Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# a Split fp32 run "parts" from fp64 where its final LoRA lies this far
# (relative L2) from the fp64 run of the same weights: the runs that stay
# lie within ~1.3e-5, those that part at 7e-5 to 1.2e-4
PARTS_AT = 5e-5


def fisher_exact(a: int, n_a: int, b: int, n_b: int):
    """(two-sided p, one-sided p that the first group parts more often)
    of a parts in n_a against b parts in n_b: the hypergeometric law of
    the first group's count with the margins fixed."""
    from math import comb
    parts, n = a + b, n_a + n_b
    lo, hi = max(0, parts - n_b), min(parts, n_a)
    prob = {k: comb(n_a, k) * comb(n_b, parts - k) / comb(n, parts)
            for k in range(lo, hi + 1)}
    two = sum(q for q in prob.values() if q <= prob[a] * (1 + 1e-9))
    return min(1.0, two), sum(q for k, q in prob.items() if k >= a)


def rwkv_setup(dev):
    """(cfg, clients, base, fed) of chip_smoke.py's phase 8: RWKV-6 Finch
    1.6B at full width (seed-0 weights), phase 3's data, LoRA on
    w_r/w_k/w_v/w_g."""
    import torch

    import chip_smoke
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.rwkv6_1_6b import rwkv6_1_6b
    from repro_torch.data import banking77, partition
    from repro_torch.models.factory import build_model
    from repro_torch.peft import lora

    cfg = rwkv6_1_6b()
    _, train, _ = banking77.paper_splits(
        cfg.vocab_size, pad_len=chip_smoke.PAD_LEN, scale=0.03)
    clients = partition.iid_partition(train, 3)
    base = build_model(cfg).init(torch.Generator().manual_seed(0), dev)
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=chip_smoke.RANK,
                    lora_dropout=0.0, lora_targets=lora.RWKV_TARGETS)
    return cfg, clients, base, fed


# (name, what it shows, the text of lora_dw_kernel's stage loop it
# replaces, what it puts there)
DW_ABLATIONS = (
    ("noload", "the products and stores alone: no loads after the first "
     "two stages", """      if (s + 2 < stages) {
        const int m0 = mbeg + (s + 2) * DW_BK;
        dw_load(xv, X, K, m0, mend, k0, K);
        dw_load(gv, G, N, m0, mend, n0, N);
      }""", ""),
    ("nomma", "the staging alone: loads, splits and stores, no wgmma",
     """      wgmma_tf32(acc, wgmma_desc(xs + 8 * kk), wgmma_desc(gb + 8 * kk),
                 fresh && kk == 0 ? 0 : 1);
      wgmma_tf32(acc, wgmma_desc(xb + 8 * kk), wgmma_desc(gs + 8 * kk), 1);
      wgmma_tf32(acc, wgmma_desc(xb + 8 * kk), wgmma_desc(gb + 8 * kk), 1);""",
     "      acc[kk] += xs[threadIdx.x % DW_T] * gb[kk];"),
    ("one", "one product a step (big·big) instead of three",
     """      wgmma_tf32(acc, wgmma_desc(xs + 8 * kk), wgmma_desc(gb + 8 * kk),
                 fresh && kk == 0 ? 0 : 1);
      wgmma_tf32(acc, wgmma_desc(xb + 8 * kk), wgmma_desc(gs + 8 * kk), 1);
      wgmma_tf32(acc, wgmma_desc(xb + 8 * kk), wgmma_desc(gb + 8 * kk), 1);""",
     """      wgmma_tf32(acc, wgmma_desc(xb + 8 * kk), wgmma_desc(gb + 8 * kk),
                 fresh && kk == 0 ? 0 : 1);"""),
)


def dw_ablation(dev) -> None:
    """``dw``: see the module's docstring."""
    import ctypes

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, lora_matmul as lm

    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    source = (csrc / "lora_matmul.cu").read_text()
    libs = {"kernel": lm._lib()}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, what, old, new in DW_ABLATIONS:
        if source.count(old) != 1:
            raise RuntimeError(f"chip_attribution: {name}: the text it "
                               "replaces is not in lora_matmul.cu once")
        dst = ROOT / "build" / "dw-ablation" / name
        shutil.rmtree(dst, ignore_errors=True)
        dst.mkdir(parents=True)
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, dst)
        (dst / "lora_matmul.cu").write_text(source.replace(old, new))
        out = dst / "liblora_matmul.so"
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                        str(dst / "lora_matmul.cu")], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(out))
        lib.lora_dw_splits.argtypes, lib.lora_dw_splits.restype = [i32] * 3, i32
        lib.lora_dw.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        lib.lora_dw.restype = i32
        libs[name] = lib
        print(f"{name}: {what}", flush=True)

    def run(lib, x, g):
        (M, K), N = x.shape, g.shape[1]
        splits = lib.lora_dw_splits(M, K, N)
        dw = torch.empty((K, N), device=dev)
        ws = torch.empty((splits, K, N), device=dev) if splits > 1 else None
        build.check(lib.lora_dw(x.data_ptr(), g.data_ptr(), dw.data_ptr(),
                                None if ws is None else ws.data_ptr(), M, K,
                                N, build.stream(dev)), "lora_dw")
        return dw

    gen = torch.Generator(device=dev).manual_seed(0)
    M = cs.BATCH * cs.PAD_LEN
    for K in (768, 2560, 2048):
        x = torch.randn((M, K), device=dev, generator=gen)
        g = torch.randn((M, K), device=dev, generator=gen) * M ** -0.5
        times = {name: [] for name in ["library", *libs]}
        for _ in range(2):
            times["library"].append(cs.cuda_ms(lambda: x.t() @ g))
            for name, lib in libs.items():
                times[name].append(cs.cuda_ms(lambda: run(lib, x, g)))
        print(f"dW at ({M}, {K}, {K}), ms (the faster of two turns): "
              + ", ".join(f"{k} {min(v):.4f}" for k, v in times.items()),
              flush=True)


# (name, what it shows, then pairs of the text of rwkv6_bwd_kernel it
# replaces and what it puts there)
WKV_ABLATIONS = (
    ("noproducts", "no Y1, Y2, Y3 (phase 3's tensor-core products)",
     "      for (int tile = tid >> 5; tile < 3 * MT; tile += BNT / 32) {",
     "      for (int tile = tid >> 5; tile < 0; tile += BNT / 32) {"),
    ("nooutputs", "no dr, dk, dlogw (phase 4's first loop)",
     "    for (int item = tid; item < n * D; item += BNT) {\n"
     "      const int j = item / D, d = item % D;",
     "    for (int item = tid; item < 0; item += BNT) {\n"
     "      const int j = item / D, d = item % D;"),
    ("noupdate", "no update of H between chunks",
     "      for (int d = tid / D; d < D; d += BNT / D) {",
     "      for (int d = D; d < D; d += BNT / D) {"),
    ("nostage", "no staging after the first chunk",
     "    if (ci > 0)\n      stage_inputs",
     "    if (false)\n      stage_inputs",
     "    if (ci > 0) stage_ckpt", "    if (false) stage_ckpt"),
)


def wkv_ablation(dev) -> None:
    """``wkv``: see the module's docstring."""
    import ctypes

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, rwkv6_scan as rw

    source = (build.CSRC / "rwkv6_scan.cu").read_text()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = {"kernel": rw._lib()}
    for name, what, *edits in WKV_ABLATIONS:
        text = source
        for old, new in zip(edits[::2], edits[1::2]):
            if text.count(old) != 1:
                raise RuntimeError(f"chip_attribution: {name}: the text it "
                                   "replaces is not in rwkv6_scan.cu once")
            text = text.replace(old, new)
        dst = ROOT / "build" / "wkv-ablation" / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(build.CSRC, dst)
        (dst / "rwkv6_scan.cu").write_text(text)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                        str(dst / "librwkv6_scan.so"),
                        str(dst / "rwkv6_scan.cu")], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(dst / "librwkv6_scan.so"))
        lib.rwkv6_bwd.argtypes = [ptr] * 13 + [i32] * 4 + [ptr]
        lib.rwkv6_bwd.restype = i32
        libs[name] = lib
        print(f"{name}: {what}", flush=True)
    BH, S, D, U = cs.BATCH * cs.RWKV_HEADS, cs.PAD_LEN, 64, cs.RWKV_HEADS
    r, k, v, lw, u, dy, _ = cs.rwkv_inputs(dev, BH, S, D, U, "model", False,
                                           14)
    ckpt = rw.rwkv6_fwd(r, k, v, lw, u, checkpoints=True)[2]
    outs = [torch.empty_like(r) for _ in range(4)]

    def run(lib):
        build.check(lib.rwkv6_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), ckpt.data_ptr(), dy.data_ptr(), None,
            *(t.data_ptr() for t in outs), None, BH, S, D, U,
            build.stream(dev)), "rwkv6_bwd")

    times = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            times[name].append(cs.graph_ms(lambda: run(lib)))
    print(f"rwkv6_bwd at ({BH}, {S}, {D}), ms in a CUDA graph (the faster "
          f"of two turns): " + ", ".join(f"{k} {min(v):.4f}"
                                         for k, v in times.items()),
          flush=True)


# (name, what it shows, then pairs of the text of panel_grad_kernel it
# replaces and what it puts there)
PAIR_VARIANTS = (
    ("prefetch", "each warp's first 8 rows of lhs loaded before the panel "
     "is staged (their latency overlaps the staging's)",
     """      __syncthreads();              // the last chunk's panel and red are read
      for (int e = threadIdx.x; e < PCH * PRG; e += 32 * PWARPS) {""",
     """      float4 x[P_UNROLL];
      #pragma unroll
      for (int u = 0; u < P_UNROLL; ++u) {
        const int mm = warp + u * PWARPS;
        x[u] = mm < n ? lhs_quad(lhs + (size_t)(m0 + mm) * L, c, L, vec)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();              // the last chunk's panel and red are read
      for (int e = threadIdx.x; e < PCH * PRG; e += 32 * PWARPS) {""",
     """      for (int i0 = warp; i0 < n; i0 += PWARPS * P_UNROLL) {
        float4 x[P_UNROLL];
        #pragma unroll
        for (int u = 0; u < P_UNROLL; ++u) {""",
     """      for (int i0 = warp; i0 < n; i0 += PWARPS * P_UNROLL) {
        #pragma unroll
        for (int u = 0; u < P_UNROLL && i0 != warp; ++u) {"""),
    ("rows16", "16 rows of lhs in flight a warp instead of 8",
     "constexpr int P_UNROLL = 8;", "constexpr int P_UNROLL = 16;"),
)
# (name, what it shows, then pairs of the text of quantize.cu it replaces
# and what it puts there)
ROUNDTRIP_VARIANTS = tuple(
    (f"tpr{tpr}", f"{tpr} threads a row up to C 1024, {per} floats held a "
     f"thread", "constexpr int RT_TPR = 128;", f"constexpr int RT_TPR = {tpr};",
     "constexpr int RT_PER = 8;", f"constexpr int RT_PER = {per};")
    for tpr, per in ((32, 32), (64, 16), (256, 4)))


def ablation_library(name, source, variants, dst_root):
    """Builds csrc/<source>.cu with each variant's edits into
    dst_root/<variant>/; prints each one's registers and spills; returns
    {variant: ctypes library}."""
    import ctypes

    from repro_torch.kernels import build

    text0 = (build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for vname, what, *edits in variants:
        text = text0
        for old, new in zip(edits[::2], edits[1::2]):
            if text.count(old) != 1:
                raise RuntimeError(f"chip_attribution: {vname}: the text it "
                                   f"replaces is not in {source}.cu once")
            text = text.replace(old, new)
        dst = dst_root / vname
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(build.CSRC, dst)
        (dst / f"{source}.cu").write_text(text)
        procs[vname] = (what, dst, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(dst / "lib.so"),
             str(dst / f"{source}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for vname, (what, dst, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"chip_attribution: {vname}: nvcc failed\n"
                               f"{log}")
        lines = log.splitlines()
        regs = [f"{lines[i + 2].split(':')[-1].strip()}; "
                f"{lines[i + 1].strip()}"
                for i, line in enumerate(lines)
                if "properties for" in line and name in line]
        print(f"{vname}: {what}; {name}: " + " | ".join(regs), flush=True)
        libs[vname] = ctypes.CDLL(str(dst / "lib.so"))
    return libs


def pair_ablation(dev) -> None:
    """``pair``: see the module's docstring."""
    import ctypes

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import quantize as qz

    root = ROOT / "build" / "pair-ablation"
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    plibs = ablation_library("panel_grad_kernel", "lora_matmul",
                             PAIR_VARIANTS, root)
    for lib in plibs.values():
        lib.lora_panel_examples_pair.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.lora_panel_examples_pair.restype = i32
    qlibs = ablation_library("quant_roundtrip_kernel", "quantize",
                             ROUNDTRIP_VARIANTS, root)
    for lib in qlibs.values():
        lib.quant_roundtrip_rows.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
        lib.quant_roundtrip_rows.restype = i32

    def faster_of_two(calls):
        times = {name: [] for name in calls}
        for _ in range(2):
            for name, fn in calls.items():
                times[name].append(cs.graph_ms(fn))
        return ", ".join(f"{k} {min(v):.4f}" for k, v in times.items())

    B, S, r = cs.BATCH, cs.PAD_LEN, cs.RANK
    for K, N in ((768, 768), (2560, 2560), (2560, 256), (2048, 2048)):
        x, gb = cs.panel_examples_inputs(dev, B, S, K, r, 0, 1)
        g, xa = cs.panel_examples_inputs(dev, B, S, N, r, 0, 2)
        want = lm.lora_panel_examples_pair(x, gb, g, xa)
        calls = {
            "pair": lambda: lm.lora_panel_examples_pair(x, gb, g, xa),
            "old way": lambda: (lm.lora_panel_examples(x, gb),
                                lm.lora_panel_examples(g, xa, True)),
            "torch.bmm x2": lambda: (torch.bmm(x.transpose(1, 2), gb),
                                     torch.bmm(xa.transpose(1, 2), g))}
        for vname, lib in plibs.items():
            def call(lib=lib):
                da, db = torch.empty_like(want[0]), torch.empty_like(want[1])
                build.check(lib.lora_panel_examples_pair(
                    x.data_ptr(), gb.data_ptr(), g.data_ptr(), xa.data_ptr(),
                    da.data_ptr(), db.data_ptr(), B, S, K, N, r,
                    build.stream(dev)), vname)
                return da, db
            got = call()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"chip_attribution: {vname} changes the "
                                   f"pair's bits")
            calls[vname] = call
        print(f"pair at (16, 80, {K} | {N}), ms in a CUDA graph: "
              + faster_of_two(calls), flush=True)
    R = B * S
    for C in (768, 769, 2048, 2560):
        x = torch.randn((R, C), device=dev, generator=torch.Generator(
            device=dev).manual_seed(C)) * 3.0
        x[1] = 0.0
        want = qz.quant_roundtrip_rows(x, 8)

        def old():
            q, scale = qz.quantize_rows(x, 8)
            return q.float() * scale

        calls = {"roundtrip": lambda: qz.quant_roundtrip_rows(x, 8),
                 "quantize_rows": lambda: qz.quantize_rows(x, 8),
                 "old way": old}
        for vname, lib in qlibs.items():
            def call(lib=lib):
                y = torch.empty_like(x)
                build.check(lib.quant_roundtrip_rows(
                    x.data_ptr(), y.data_ptr(), None, R, C, 8,
                    build.stream(dev)), vname)
                return y
            if not torch.equal(call().view(torch.int32),
                               want.view(torch.int32)):
                raise RuntimeError(f"chip_attribution: {vname} changes the "
                                   f"roundtrip's bits")
            calls[vname] = call
        print(f"roundtrip at ({R}, {C}) int8, ms in a CUDA graph: "
              + faster_of_two(calls), flush=True)


# (name, what it shows, then pairs of the text of quantize.cu it replaces
# and what it puts there)
NAN_MAX = """  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;"""
NAN_MIN = """  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;"""
# the warp top-k as it compared floats before the NaN key (its Pick, its
# order, its shuffle and its selection loop storing from lane 0)
FLOAT_PICK = (
    "struct Pick {\n  uint32_t key;", "struct Pick {\n  float v;",
    """__device__ __forceinline__ bool before(uint32_t ak, int aj, uint32_t bk,
                                       int bj) {
  return ak > bk || (ak == bk && aj < bj);""",
    """__device__ __forceinline__ bool before(float av, int aj, float bv, int bj) {
  return av > bv || (av == bv && aj < bj);""",
    """    const uint32_t ok = __shfl_xor_sync(0xffffffffu, p.key, off);
    const int oj = __shfl_xor_sync(0xffffffffu, p.j, off);
    if (before(ok, oj, p.key, p.j)) p = Pick{ok, oj};""",
    """    const float ov = __shfl_xor_sync(0xffffffffu, p.v, off);
    const int oj = __shfl_xor_sync(0xffffffffu, p.j, off);
    if (before(ov, oj, p.v, p.j)) p = Pick{ov, oj};""",
    """  uint32_t prev_k = 0xFFFFFFFFu;
  int prev_j = -1;
  for (int t = 0; t < k; ++t) {
    Pick best{0u, INT_MAX};
    float best_v = 0.f;
    if (live) {
      for (int j = tr; j < C; j += 32) {
        const float v = x[j];
        const uint32_t key = fkey(v);
        if (before(prev_k, prev_j, key, j) && before(key, j, best.key,
                                                     best.j)) {
          best = Pick{key, j};
          best_v = v;
        }
      }
    }
    // the lane whose own best won stores it (its j is unique in the warp)
    const Pick win = warp_best(best);
    if (live && win.j == best.j) {
      pv[rb][t] = best_v;
      pj[rb][t] = best.j;
    }
    prev_k = win.key;
    prev_j = win.j;""",
    """  float prev_v = INFINITY;
  int prev_j = -1;
  for (int t = 0; t < k; ++t) {
    Pick best{-INFINITY, INT_MAX};
    if (live) {
      for (int j = tr; j < C; j += 32) {
        const float v = x[j];
        if (before(prev_v, prev_j, v, j) && before(v, j, best.v, best.j))
          best = Pick{v, j};
      }
    }
    best = warp_best(best);
    if (tr == 0) {
      pv[rb][t] = best.v;
      pj[rb][t] = best.j;
    }
    prev_v = best.v;
    prev_j = best.j;""")
# the levels stored straight from the float (no int between)
FLOAT_LEVELS = tuple(x for old in (
    """    Q[(size_t)row * k + t] = (int8_t)(int)q;
    IDX[(size_t)row * k + t] = pj[rb][t];""",
    """    Q[(size_t)row * k + t] = (int8_t)(int)q;
    IDX[(size_t)row * k + t] = sidx[t];""",
    *(f"(signed char)(int)level(v.{c}, scale, qmax)" for c in "xyzw"),
    "q[j] = (int8_t)(int)level(x[j], scale, qmax);")
    for x in (old, old.replace("(int)", "", 1)))
NAN_VARIANTS = (
    ("shipped", "csrc/quantize.cu as it is"),
    ("select", "the NaN-keeping maximum and minimum as a compare and a "
     "select", NAN_MAX, "  return (a != a || a > b) ? a : b;",
     NAN_MIN, "  return (a != a || a < b) ? a : b;"),
    ("fmaxf", "fmaxf / fminf and no NaN key: NaN dropped, as the kernels "
     "did before they kept it",
     NAN_MAX, "  return fmaxf(a, b);", NAN_MIN, "  return fminf(a, b);",
     "  if (x != x) return 0xFFFFFFFFu;\n", ""),
    ("parent", "the source before the kernels kept NaN: fmaxf / fminf, no "
     "NaN key, the warp top-k comparing floats",
     NAN_MAX, "  return fmaxf(a, b);", NAN_MIN, "  return fminf(a, b);",
     "  if (x != x) return 0xFFFFFFFFu;\n", "", *FLOAT_PICK, *FLOAT_LEVELS),
)


def nan_ablation(dev) -> None:
    """``nan``: see the module's docstring."""
    import ctypes

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref

    def qz_call(name, x, k):
        """The shipped wrapper's outputs (the scale last)."""
        if name.startswith("quant_roundtrip"):
            return qz.quant_roundtrip_rows(x, 8, with_scale=True)
        if name == "topk_quantize":
            return qz.topk_quantize(x, k, 8)
        if name == "quantize_pack4":
            return qz.quantize_pack4(x)
        return qz.quantize_rows(x, 8)

    libs = ablation_library("quantize_cu", "quantize", NAN_VARIANTS,
                            ROOT / "build" / "nan-ablation")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.quant_roundtrip_rows.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
        lib.quantize_rows.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
        lib.quantize_pack4.argtypes = [ptr] * 3 + [i32] * 2 + [ptr]
        lib.topk_quantize.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        for fn in ("quant_roundtrip_rows", "quantize_rows", "quantize_pack4",
                   "topk_quantize"):
            getattr(lib, fn).restype = i32

    def variant(lib, name, x, k=8):
        R, C = x.shape
        s = build.stream(dev)
        scale = torch.empty((R, 1), device=dev)
        if name.startswith("quant_roundtrip"):
            y = torch.empty_like(x)
            build.check(lib.quant_roundtrip_rows(
                x.data_ptr(), y.data_ptr(), scale.data_ptr(), R, C,
                8, s), name)
            return y, scale
        if name == "topk_quantize":
            q = torch.empty((R, k), device=dev, dtype=torch.int8)
            idx = torch.empty((R, k), device=dev, dtype=torch.int32)
            build.check(lib.topk_quantize(
                x.data_ptr(), q.data_ptr(), idx.data_ptr(),
                scale.data_ptr(), R, C, k, 8, s), name)
            return q, idx, scale
        if name == "quantize_pack4":
            q = torch.empty((R, C // 2), device=dev, dtype=torch.uint8)
            build.check(lib.quantize_pack4(x.data_ptr(), q.data_ptr(),
                                           scale.data_ptr(), R, C, s), name)
            return q, scale
        q = torch.empty((R, C), device=dev, dtype=torch.int8)
        build.check(lib.quantize_rows(x.data_ptr(), q.data_ptr(),
                                      scale.data_ptr(), R, C, 8, s), name)
        return q, scale

    twins = {
        "quant_roundtrip_rows": lambda x, k: ref.quant_roundtrip_rows_ref(
            x, 8),
        "quantize_rows": lambda x, k: ref.quantize_rows_ref(x, 8),
        "quantize_pack4": lambda x, k: ref.quantize_pack4_rows_ref(x),
        "topk_quantize": lambda x, k: ref.topk_quantize_rows_ref(x, k, 8)}
    R = cs.BATCH * cs.PAD_LEN
    cases = (("quant_roundtrip_rows", R, 768, 8),
             ("quant_roundtrip_rows", R, 2560, 8),
             ("quantize_rows", R, 768, 8), ("quantize_pack4", R, 768, 8),
             ("topk_quantize", 150, 77, 8), ("topk_quantize", R, 50257, 64))
    n_bad = len(cs.NONFINITE_ROWS)
    for i, (name, rows, C, k) in enumerate(cases):
        x = torch.randn((rows, C), device=dev, generator=torch.Generator(
            device=dev).manual_seed(900 + i)) * 3.0
        bad = cs.nonfinite_rows(dev, rows, C, 950 + i)
        want = qz_call(name, x, k)
        calls = {}
        for vname, lib in libs.items():
            got = variant(lib, name, x, k)
            if not all(torch.equal(g.view(torch.int32) if g.is_floating_point()
                                   else g, w.view(torch.int32)
                                   if w.is_floating_point() else w)
                       for g, w in zip(got, want)):
                raise RuntimeError(f"chip_attribution: {vname} changes "
                                   f"{name}'s bits on finite rows")
            if vname not in ("fmaxf", "parent"):
                cs.nonfinite_agree(name, variant(lib, name, bad, k),
                                   twins[name](bad, k), n_bad)
            calls[vname] = lambda lib=lib: variant(lib, name, x, k)
        times = {v: [] for v in calls}
        for _ in range(2):
            for v, fn in calls.items():
                times[v].append(cs.graph_ms(fn))
        print(f"{name} at ({rows}, {C})" + (f" k {k}" if "topk" in name
                                             else "")
              + ", ms in a CUDA graph: "
              + ", ".join(f"{v} {min(t):.4f}" for v, t in times.items()),
              flush=True)


# kd_fwd_kernel, the online pass row 8 shipped before its redesign:
# TPR threads a row (a warp to V 2048, a block above), a division an
# element, (m_t, z_t, u, m_s, z_s) merged by xor butterfly
PARENT_KD_FWD = r"""
// TPR threads per row (32: one warp, NT: the whole block).
template <int TPR>
__global__ void __launch_bounds__(NT)
kd_fwd_kernel(const float* __restrict__ T, const float* __restrict__ S,
              float* __restrict__ rows, float* __restrict__ mt_out,
              float* __restrict__ zt_out, float* __restrict__ ms_out,
              float* __restrict__ zs_out, float* __restrict__ u_out, int R,
              int V, float temp) {
  constexpr int RPB = NT / TPR;            // rows per block
  constexpr int WPR = TPR / 32;            // warps per row
  __shared__ Stats part[RPB][WPR];
  const int rb = threadIdx.x / TPR, tr = threadIdx.x % TPR;
  const int row = blockIdx.x * RPB + rb;
  Stats st{NEG_INIT, 0.f, 0.f, NEG_INIT, 0.f};
  if (row < R) {
    const float* t_row = T + (size_t)row * V;
    const float* s_row = S + (size_t)row * V;
    for (int j = tr; j < V; j += TPR) {
      const float t = t_row[j] / temp, s = s_row[j] / temp;
      if (t > st.mt) {                   // new teacher max: rescale, shift
        const float c = expf(st.mt - t);
        st.u = c * (st.u - st.zt * (t - st.mt));
        st.zt *= c;
        st.mt = t;
      }
      if (s > st.ms) {                   // new student max: shift, rescale
        st.u += st.zt * (s - st.ms);
        st.zs *= expf(st.ms - s);
        st.ms = s;
      }
      const float et = expf(t - st.mt);
      st.zt += et;
      st.zs += expf(s - st.ms);
      st.u += et * ((t - st.mt) - (s - st.ms));
    }
  }
  st = warp_merge(st);
  if constexpr (WPR > 1) {
    if (tr % 32 == 0) part[rb][tr / 32] = st;
    __syncthreads();
    if (tr == 0) {
      st = part[rb][0];
      for (int w = 1; w < WPR; ++w) st = merge(st, part[rb][w]);
    }
  }
  if (tr == 0 && row < R) {
    const float kl = st.u / st.zt - logf(st.zt) + logf(st.zs);
    rows[row] = kl * temp * temp;
    mt_out[row] = st.mt;
    zt_out[row] = st.zt;
    ms_out[row] = st.ms;
    zs_out[row] = st.zs;
    u_out[row] = st.u;
  }
}
"""
PARENT_KD_DISPATCH = """  if (V <= 2048) {
    kd_fwd_kernel<32><<<(R + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
        teacher, student, rows, mt, zt, ms, zs, u, R, V, temp);
  } else {
    kd_fwd_kernel<NT><<<R, NT, 0, st>>>(teacher, student, rows, mt, zt, ms,
                                       zs, u, R, V, temp);
  }
  return (int)cudaGetLastError();
"""
KD_ROWS_AT = "template <int PER>\nvoid launch_rows("
KD_DISPATCH = "  const float inv = 1.f / temp, t2 = temp * temp;\n"
KD_LAST_NARROW = """  } else {
    launch_rows<32>(teacher, student, rows, mt, zt, ms, zs, u, R, V, inv, t2,
                    st);
  }"""


def kd_variants(text):
    """(name, what it shows, then pairs of the text of csrc/kd_loss.cu it
    replaces and what it puts there) for ``kd``, read against ``text``,
    the source as it stands (its constants are read from it)."""
    def const(name):
        return re.search(rf"^constexpr int {name} = \d+;", text, re.M)[0]

    def set_(name, value):
        return const(name), f"constexpr int {name} = {value};"

    return (
        ("parent", "the previous online kernel (a warp a row to V 2048, a "
         "block above, x / T an element)", KD_ROWS_AT, PARENT_KD_FWD + KD_ROWS_AT,
         KD_DISPATCH, PARENT_KD_DISPATCH + KD_DISPATCH),
        ("wide only", "the streaming kernel at every V",
         *set_("NARROW_MAX", 0)),
        ("division", "x / T an element in place of x * (1/T)",
         "  return __fmul_rn(x, inv_temp);", "  return x / inv_temp;",
         KD_DISPATCH, KD_DISPATCH.replace("1.f / temp", "temp")),
        ("block 32", "narrow blocks of 32 threads (a row each)",
         *set_("NARROW_THREADS", 32)),
        ("block 128", "narrow blocks of 128 threads (4 rows each)",
         *set_("NARROW_THREADS", 128)),
        ("narrow 2048", "rows to V 2048 held in registers (64 values a "
         "lane from V 1025)", *set_("NARROW_MAX", 2048), KD_LAST_NARROW,
         KD_LAST_NARROW.replace("} else {", "} else if (V <= 1024) {")
         + """ else {
    launch_rows<64>(teacher, student, rows, mt, zt, ms, zs, u, R, V, inv, t2,
                    st);
  }"""),
        ("cluster 1", "one block a wide row", *set_("WIDE_CLUSTER", 1)),
        ("cluster 2", "at most 2 blocks a wide row",
         *set_("WIDE_CLUSTER", 2)),
        ("cluster 8", "up to 8 blocks of at least 4096 elements a wide row",
         *set_("WIDE_CLUSTER", 8), *set_("WIDE_SPAN", 4096)),
        ("span 2048", "up to 4 blocks of at least 2048 elements a wide row",
         *set_("WIDE_SPAN", 2048)),
        ("unroll 2", "2 float4 loads of each tensor in flight a thread",
         *set_("WIDE_UNROLL", 2)),
        ("unroll 8", "8 float4 loads of each tensor in flight a thread",
         *set_("WIDE_UNROLL", 8)),
    )


def kd_ablation(dev) -> None:
    """``kd``: see the module's docstring."""
    import ctypes

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import kd_loss as kdl
    from repro_torch.kernels import ref

    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    text = (build.CSRC / "kd_loss.cu").read_text()
    libs = ablation_library("kd_fwd_kernel", "kd_loss", kd_variants(text),
                            ROOT / "build" / "kd-ablation")
    for lib in libs.values():
        lib.kd_fwd.argtypes = [ptr] * 8 + [i32, i32, f32, ptr]
        lib.kd_fwd.restype = i32

    def faster_of_two(calls):
        times = {name: [] for name in calls}
        for _ in range(2):
            for name, fn in calls.items():
                times[name].append(cs.graph_ms(fn))
        return ", ".join(f"{k} {min(v):.4f}" for k, v in times.items())

    def variant(lib, t, s, T):
        def call():
            R, V = t.shape
            rows, *stats = torch.empty((6, R), device=dev)
            build.check(lib.kd_fwd(t.data_ptr(), s.data_ptr(),
                                   rows.data_ptr(),
                                   *(x.data_ptr() for x in stats), R, V, T,
                                   build.stream(dev)), "kd_fwd")
            return rows, tuple(stats)
        return call

    cross = kdl.narrow_max()
    shapes = [(64, 77, True), (1280, 50257, False)] + [
        (R, V, False) for R in (64, 1280)
        for V in (512, cross, cross + 1, 2048, 4096, 8192, 16384, 32768)]
    for R, V, topk in shapes:
        gen = torch.Generator(device=dev).manual_seed(R + V)
        t, s, _ = cs.kd_inputs(dev, R, V, topk, 0, gen)
        want = ref.kd_loss_fwd(t, s, 2.0)
        calls = {"kernel": lambda: kdl.kd_fwd(t, s, 2.0),
                 "F.kl_div": lambda: cs.kd_lib_rows(t, s, 2.0)}
        for vname, lib in libs.items():
            calls[vname] = variant(lib, t, s, 2.0)
            cs.max_err("kd_fwd", calls[vname](), want)
        print(f"kd_fwd at ({R}, {V}), T 2{', top-k teacher' if topk else ''}"
              f", ms in a CUDA graph: " + faster_of_two(calls), flush=True)


def kblock(kb: int) -> int:
    """chip_smoke's precision gates with the fused LoRA kernel's K block
    set to ``kb``, from a copy of the port under build/kblock-<kb>/."""
    import torch

    dst = ROOT / "build" / f"kblock-{kb}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst)
    cu = dst / "src" / "repro_torch" / "kernels" / "csrc" / "lora_matmul.cu"
    text, n = re.subn(r"constexpr int KB = \d+;", f"constexpr int KB = {kb};",
                      cu.read_text())
    if n != 1:
        raise RuntimeError("chip_attribution: no K block in lora_matmul.cu")
    cu.write_text(text)
    sys.path[:0] = [str(dst / "src"), str(dst)]
    import chip_smoke
    from repro_torch.kernels import build

    def report(ok: bool, what: str) -> None:
        if not ok:
            print(f"  gate missed: {what}", flush=True)

    chip_smoke.require = report
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), torch.__version__, f"K block {kb}",
        flush=True)
    build.build_all()
    M = chip_smoke.BATCH * chip_smoke.PAD_LEN
    for K in (768, 2560):
        chip_smoke.lora_fp64_errors(dev, M, K, K, 17)
    chip_smoke.run_slices(dev)
    chip_smoke.run_recurrent(dev)
    chip_smoke.run_base_grad(dev)
    print("phase 8: first step", flush=True)
    cfg, clients, base, fed = rwkv_setup(dev)
    chip_smoke.floor_gate("first-step LoRA gradient",
                          chip_smoke.first_step_gaps(dev, cfg, base, fed,
                                                     clients))
    return 0


def rwkv_trajectory(dev) -> None:
    """Six train steps of RWKV-6 Finch 1.6B (the first-epoch batches of
    clients 0 and 1, seed 0) from FedLLM's initial LoRA under each of
    chip_smoke's four settings; prints the distances from the plain run
    after every step."""
    import torch

    import chip_smoke
    from repro_torch import tree as tree_lib
    from repro_torch.core.fedavg import make_fns, to_device
    from repro_torch.data.loader import epoch_batches
    from repro_torch.models.factory import build_model
    from repro_torch.peft import lora

    cfg, clients, base, fed = rwkv_setup(dev)
    lt0 = lora.init_lora(torch.Generator().manual_seed(fed.seed + 1), base,
                         fed.lora_targets, fed.lora_rank, fed.lora_alpha)
    batches = [to_device(b, dev) for c in clients
               for b in epoch_batches(c, chip_smoke.BATCH, seed=0)][:6]
    steps, tags = {}, {}
    for role, tag, policy in chip_smoke.each_run():
        tags[role] = tag
        fns = make_fns(build_model(dataclasses.replace(
            cfg, kernel_policy=policy)), fed)
        lt, opt = lt0, fns["opt_init"](lt0)
        steps[role] = []
        for batch in batches:
            lt, opt, loss = fns["train_step"](base, lt, opt, batch)
            steps[role].append((float(loss), lt))

    def rel(pairs):
        pairs = list(pairs)
        num = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
        return (num / sum(float((b ** 2).sum()) for _, b in pairs)) ** 0.5

    for role in ("kernels", "floor", "control"):
        for i, ((loss, lt), (plain_loss, plain_lt)) in enumerate(
                zip(steps[role], steps["plain"])):
            pairs = list(zip(tree_lib.leaves(lt), tree_lib.leaves(plain_lt)))
            print(f"{tags[role]} step {i}: loss {loss:.7f} vs plain "
                  f"{plain_loss:.7f}; LoRA relative L2 {rel(pairs):.3e}, "
                  f"B factors {rel(pairs[1::2]):.3e}", flush=True)


def plain_version(op):
    """``op`` called under the plain-PyTorch kernel policy."""
    from repro_torch.kernels import ops

    def call(*args, **kwargs):
        with ops.policy_scope("torch"):
            return op(*args, **kwargs)
    return call


@contextlib.contextmanager
def patched(patches):
    """Sets each (module, attribute, value) of ``patches`` for the body."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, value in patches:
        setattr(mod, attr, value)
    try:
        yield
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)


# Arithmetic variants of the tensor-core kernels that ``split`` can run:
# {key: (what it changes, [(file in csrc/, the text it replaces, what it
# puts there)])}, each built from a copy of csrc/ under
# build/split-variant/<key>/ (both the fused LoRA and the flash
# libraries).  Of them all (PERF.md §6) only "ffma", the fused forward's
# main product y summed in fp32 FMA off the tensor cores, brings the
# kernels' partings down to plain's.
KERNEL_HEAD = ("template <bool TRANS, int NR>\n__global__ void "
               "__launch_bounds__(FT)\nlora_fused_kernel(")
MAIN_MMA = "mma3(part[i][j], a[i], b)"
PARTIALS = "  float part[FM][FN][4], ppart[PM][NR][4];"
K_BLOCK_END = ("    // the end of a K block of a contraction that has "
               "several:")
MMA3_BODY = """  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.small, b.big);
  mma_tf32(t, a.big, b.small);
  mma_tf32(t, a.big, b.big);
  #pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];"""
PANEL_MMA = """      #pragma unroll
      for (int j = 0; j < NR; ++j) {
        const FragB b = TRANS ? frag_b<true, LDC>(as, kk, 8 * j, g, t)
                              : frag_b<false, F::LDA>(as, kk, 8 * j, g, t);
        #pragma unroll
        for (int i = 0; i < FM; ++i)
          if (i % WARPS_N == wn) mma3(ppart[i / WARPS_N][j], a[i], b);
      }
    }
"""
PANEL_FFMA = """    }
    // the panel in fp32 FMA, each element's contraction in order
    #pragma unroll
    for (int i = 0; i < PM; ++i)
      #pragma unroll
      for (int j = 0; j < NR; ++j)
        #pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = wr + 16 * (i * WARPS_N + wn) + g + 8 * (q >> 1);
          const int col = 8 * j + 2 * t + (q & 1);
          float s = ppart[i][j][q];
          #pragma unroll 8
          for (int c = 0; c < TK; ++c)
            s = fmaf(xs[row * LDC + c],
                     TRANS ? as[col * LDC + c] : as[c * F::LDA + col], s);
          ppart[i][j][q] = s;
        }
"""
MMA3_K4 = """__device__ __forceinline__ void mma_k4(float (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// acc += a·b as two m16n8k4 halves, each into a fresh fragment
__device__ __forceinline__ void mma3_k4(float (&acc)[4], const FragA& a,
                                        const FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_k4(t, a.small.x, a.small.y, b.big[0]);
  mma_k4(t, a.big.x, a.big.y, b.small[0]);
  mma_k4(t, a.big.x, a.big.y, b.big[0]);
  #pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
  float u[4] = {0.f, 0.f, 0.f, 0.f};
  mma_k4(u, a.small.z, a.small.w, b.big[1]);
  mma_k4(u, a.big.z, a.big.w, b.small[1]);
  mma_k4(u, a.big.z, a.big.w, b.big[1]);
  #pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += u[i];
}

"""
# the main tile's fresh fragments added with a compensation term: Neumaier's
# sum ("kahan"), or half an ulp of each fragment's sum, the mean of the
# tensor core's truncation toward zero ("unbias"), folded into the total
# at the end of each K block
COMP_MMA = """template <bool KAHAN>
__device__ __forceinline__ void mma3_comp(float (&acc)[4], float (&comp)[4],
                                          const FragA& a, const FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.small, b.big);
  mma_tf32(t, a.big, b.small);
  mma_tf32(t, a.big, b.big);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (KAHAN) {
      const float s = acc[i] + t[i];
      comp[i] += fabsf(acc[i]) >= fabsf(t[i]) ? (acc[i] - s) + t[i]
                                              : (t[i] - s) + acc[i];
      acc[i] = s;
    } else {
      comp[i] += __uint_as_float(__float_as_uint(t[i]) & 0xff800000u)
                 * 0x1p-24f;
      acc[i] += t[i];
    }
  }
}

"""
COMP_EDITS = [
    ("lora_matmul.cu", PARTIALS,
     "  float part[FM][FN][4], ppart[PM][NR][4], comp[FM][FN][4];"),
    ("lora_matmul.cu",
     "          for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;",
     "          for (int q = 0; q < 4; ++q) part[i][j][q] = comp[i][j][q] = "
     "0.f;"),
    ("lora_matmul.cu", K_BLOCK_END, """    if ((kt + 1) % KT == 0 || kt == nk - 1) {
      #pragma unroll
      for (int i = 0; i < FM; ++i)
        #pragma unroll
        for (int j = 0; j < FN; ++j)
          #pragma unroll
          for (int q = 0; q < 4; ++q) part[i][j][q] += comp[i][j][q];
    }
""" + K_BLOCK_END),
]
# x = big + small (split_fast: small exact in fp32), small = mid + lo with
# mid = tf32(small) and lo = small - mid (exact in TF32): TERMS products,
# the smallest first, into a fresh fragment, lo·big / big·lo where A_LO /
# B_LO
SPLIT3_MMA = """__device__ __forceinline__ uint32_t mid_of(uint32_t small) {
  return to_tf32(__uint_as_float(small));
}

__device__ __forceinline__ uint32_t lo_of(uint32_t small, uint32_t mid) {
  return __float_as_uint(__uint_as_float(small) - __uint_as_float(mid));
}

template <bool A_LO, bool B_LO>
__device__ __forceinline__ void mma_split3(float (&acc)[4], const FragA& a,
                                           const FragB& b) {
  uint4 am, al;
  am.x = mid_of(a.small.x); am.y = mid_of(a.small.y);
  am.z = mid_of(a.small.z); am.w = mid_of(a.small.w);
  al.x = lo_of(a.small.x, am.x); al.y = lo_of(a.small.y, am.y);
  al.z = lo_of(a.small.z, am.z); al.w = lo_of(a.small.w, am.w);
  uint32_t bm[2], bl[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    bm[i] = mid_of(b.small[i]);
    bl[i] = lo_of(b.small[i], bm[i]);
  }
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  if (A_LO) mma_tf32(t, al, b.big);
  if (B_LO) mma_tf32(t, a.big, bl);
  mma_tf32(t, am, bm);
  mma_tf32(t, am, b.big);
  mma_tf32(t, a.big, bm);
  mma_tf32(t, a.big, b.big);
  #pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

"""
F64_MMA = """__device__ __forceinline__ double whole(uint32_t big, uint32_t small) {
  return (double)__uint_as_float(big) + (double)__uint_as_float(small);
}

__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// acc += a·b over a step of 8 in fp64, each operand whole (big + small):
// two m8n8k4 products for each 8-row half
__device__ __forceinline__ void mma_f64(double (&acc)[4], const FragA& a,
                                        const FragB& b) {
  double top[2] = {acc[0], acc[1]}, bot[2] = {acc[2], acc[3]};
  const double b0 = whole(b.big[0], b.small[0]);
  const double b1 = whole(b.big[1], b.small[1]);
  dmma(top, whole(a.big.x, a.small.x), b0);
  dmma(top, whole(a.big.z, a.small.z), b1);
  dmma(bot, whole(a.big.y, a.small.y), b0);
  dmma(bot, whole(a.big.w, a.small.w), b1);
  acc[0] = top[0];
  acc[1] = top[1];
  acc[2] = bot[0];
  acc[3] = bot[1];
}

"""
MAIN_FFMA = """    #pragma unroll
    for (int i = 0; i < FM; ++i)
      #pragma unroll
      for (int j = 0; j < FN; ++j)
        #pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = wr + 16 * i + g + 8 * (q >> 1);
          const int col = wc + 8 * j + 2 * t + (q & 1);
          float s = part[i][j][q];
          #pragma unroll 8
          for (int c = 0; c < TK; ++c)
            s = fmaf(xs[row * LDC + c],
                     TRANS ? ws[col * LDC + c] : ws[c * LDN + col], s);
          part[i][j][q] = s;
        }
"""


def _split3(what, a_lo, b_lo):
    call = (f"mma_split3<{str(a_lo).lower()}, {str(b_lo).lower()}>"
            f"(part[i][j], a[i], b)")
    return (what, [("lora_matmul.cu", KERNEL_HEAD, SPLIT3_MMA + KERNEL_HEAD),
                   ("lora_matmul.cu", MAIN_MMA, call)])


SPLIT_VARIANTS = {
    "rna-small": (
        "split_fast rounds the small part to TF32 (cvt.rna) instead of "
        "handing the tensor core its fp32 bits, which it truncates",
        [("mma_tf32.cuh",
          "  small = __float_as_uint(x - __uint_as_float(big));",
          "  small = to_tf32(x - __uint_as_float(big));")]),
    "one-accumulator": (
        "mma3 adds its three products into the running sum inside the "
        "tensor core, with no fresh fragment a step of 8",
        [("mma_tf32.cuh", MMA3_BODY, """  mma_tf32(acc, a.small, b.big);
  mma_tf32(acc, a.big, b.small);
  mma_tf32(acc, a.big, b.big);""")]),
    "divide": (
        "flash_fwd divides its output row by the softmax sum instead of "
        "multiplying by its reciprocal",
        [("flash_attention.cu", "ob[d] = acc[n][2 * r + c] * inv_l;",
          "ob[d] = acc[n][2 * r + c] / fmaxf(l_i[r], 1e-30f);")]),
    "panel-ffma": (
        "the fused kernel's rank-r panel (x@A, g@Bᵀ) in fp32 FMA, each "
        "element's contraction in order",
        [("lora_matmul.cu", PANEL_MMA, PANEL_FFMA)]),
    "k4": (
        "the fused kernel's products in m16n8k4 halves, four products a "
        "fresh fragment instead of eight",
        [("lora_matmul.cu", KERNEL_HEAD, MMA3_K4 + KERNEL_HEAD),
         ("lora_matmul.cu", MAIN_MMA, "mma3_k4(part[i][j], a[i], b)"),
         ("lora_matmul.cu", "mma3(ppart[i / WARPS_N][j], a[i], b)",
          "mma3_k4(ppart[i / WARPS_N][j], a[i], b)"),
         ("lora_matmul.cu", "mma3(low[i][j], a[i], b)",
          "mma3_k4(low[i][j], a[i], b)")]),
    "kahan": (
        "the fused kernel's main tile adds its fresh fragments by "
        "Neumaier's compensated sum",
        [("lora_matmul.cu", KERNEL_HEAD, COMP_MMA + KERNEL_HEAD),
         ("lora_matmul.cu", MAIN_MMA,
          "mma3_comp<true>(part[i][j], comp[i][j], a[i], b)"),
         *COMP_EDITS]),
    "unbias": (
        "the fused kernel's main tile adds half an ulp of each fresh "
        "fragment's sum, the mean of the truncation, in a second "
        "accumulator",
        [("lora_matmul.cu", KERNEL_HEAD, COMP_MMA + KERNEL_HEAD),
         ("lora_matmul.cu", MAIN_MMA,
          "mma3_comp<false>(part[i][j], comp[i][j], a[i], b)"),
         *COMP_EDITS]),
    "rna4": _split3("the fused kernel's main tile from big + mid, four "
                    "products", False, False),
    "exact6": _split3("the fused kernel's main tile from big + mid + lo, "
                      "each operand exact, six products", True, True),
    "exacta": _split3("as rna4, with the A operand (x, g) exact: five "
                      "products", True, False),
    "exactb": _split3("as rna4, with the B operand (W) exact: five "
                      "products", False, True),
    "fp64": (
        "the fused kernel's main tile on the fp64 tensor cores, fp64 "
        "partials", [("lora_matmul.cu", KERNEL_HEAD, F64_MMA + KERNEL_HEAD),
                     ("lora_matmul.cu", PARTIALS,
                      "  double part[FM][FN][4];\n"
                      "  float ppart[PM][NR][4];"),
                     ("lora_matmul.cu", MAIN_MMA,
                      "mma_f64(part[i][j], a[i], b)")]),
    "ffma": (
        "the fused kernel's main tile in fp32 FMA, each element's "
        "contraction in order, off the tensor cores",
        [("lora_matmul.cu", MAIN_MMA, "(void)0"),
         ("lora_matmul.cu", K_BLOCK_END, MAIN_FFMA + K_BLOCK_END)]),
}


def variant_patches(name, edits):
    """[(module, "_LIB", library)] of the fused LoRA and flash kernels
    built from csrc/ with ``edits`` applied."""
    import ctypes

    from repro_torch.kernels import build, flash_attention as fa, \
        lora_matmul as lm

    dst = ROOT / "build" / "split-variant" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC, dst)
    for file, old, new in edits:
        text = (dst / file).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"chip_attribution: {name}: the text it "
                               f"replaces is not in {file} once")
        (dst / file).write_text(text.replace(old, new))
    procs = [subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o",
                               str(dst / f"lib{src}.so"),
                               str(dst / f"{src}.cu")],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for src in ("lora_matmul", "flash_attention")]
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"chip_attribution: {name}: nvcc failed\n"
                               + log.decode())
        lines = log.decode().splitlines()
        for i, line in enumerate(lines[:-2]):
            if "properties for" in line and "lora_fused_kernel" in line:
                print(f"  {name}: " + lines[i + 2].split(":", 1)[-1].strip()
                      + "; " + lines[i + 1].strip(), flush=True)
    patches = []
    for mod in (lm, fa):
        with patched([(mod, "_LIB", None), (build, "load", lambda src:
                      ctypes.CDLL(str(dst / f"lib{src}.so")))]):
            patches.append((mod, "_LIB", mod._lib()))
    return patches


def split_configs(keys=()):
    """The kernel runs of ``split``, as [(tag, [(module, attribute,
    value)])]: all kernels, then each of SPLIT_CONFIGS' keys (all of them
    unless ``keys`` names some): one family sent back to plain PyTorch
    through its ``ops`` entry, as the default mode does ("lora": rows 1,
    2, 4; "attention": rows 5-7), one kernel at a time (its wrapper
    replaced by its twin in kernels/ref.py: "row1", "row2", "row5",
    "row6", "row7"), one output of row 1 from plain PyTorch ("row1-xa":
    the saved panel x@A; "row1-y": y), and SPLIT_VARIANTS' libraries."""
    from repro_torch.kernels import flash_attention as fa, \
        lora_matmul as lm, ops, ref

    kernel_fwd = lm.lora_fwd

    def plain_xa(x, w, a, b):
        return kernel_fwd(x, w, a, b)[0], x @ a

    def plain_y(x, w, a, b):
        xa = kernel_fwd(x, w, a, b)[1]
        return x @ w + xa @ b, xa

    table = {
        "lora": ("LoRA plain (rows 1, 2, 4)",
                 [(ops, "lora_matmul", plain_version(ops.lora_matmul))]),
        "attention": ("attention plain (rows 5, 6, 7)",
                      [(ops, "mha_attention",
                        plain_version(ops.mha_attention))]),
        "row1": ("row 1 plain", [(lm, "lora_fwd", ref.lora_fwd)]),
        "row2": ("row 2 plain", [(lm, "lora_dx", ref.lora_dx)]),
        "row5": ("row 5 plain", [(fa, "flash_fwd", ref.attention_fwd)]),
        "row6": ("row 6 plain", [(fa, "flash_dq", ref.attention_dq)]),
        "row7": ("row 7 plain", [(fa, "flash_dkv", ref.attention_dkv)]),
        "row1-xa": ("row 1 with a plain x@A panel",
                    [(lm, "lora_fwd", plain_xa)]),
        "row1-y": ("row 1 with a plain y", [(lm, "lora_fwd", plain_y)]),
    }
    unknown = set(keys) - set(table) - set(SPLIT_VARIANTS)
    if unknown:
        raise SystemExit(f"chip_attribution: unknown split runs {unknown}")
    configs = [("kernels", [])]
    for key in keys or [*table, *SPLIT_VARIANTS]:
        if key in table:
            configs.append(table[key])
        else:
            what, edits = SPLIT_VARIANTS[key]
            print(f"variant {key}: {what}", flush=True)
            configs.append((f"variant {key}", variant_patches(key, edits)))
    return configs


def split_spread(dev, copies: int = 8, keys=()) -> None:
    """``split [COPIES]``: see the module's docstring."""
    import torch

    import chip_smoke as cs
    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.gpt2_small import gpt2
    from repro_torch.core import split
    from repro_torch.core.fedavg import to_device
    from repro_torch.core.rounds import run_federated
    from repro_torch.data import banking77, partition
    from repro_torch.data.loader import epoch_batches
    from repro_torch.models.factory import build_model
    from repro_torch.peft import lora as lora_lib

    cfg = gpt2()
    pub, train, test = banking77.paper_splits(
        cfg.vocab_size, pad_len=cs.PAD_LEN, scale=0.03)
    clients = partition.iid_partition(train, 3)
    base = build_model(cfg).init(torch.Generator().manual_seed(0), dev)

    def name(seed):
        return "the seed-0 weights" if seed is None else \
            f"nudged copy {seed}"

    def fed(bits):
        return FedConfig(framework="split", rounds=2, lora_rank=cs.RANK,
                         lora_dropout=0.0, split_layer=cs.SPLIT_LAYER,
                         activation_quant_bits=bits)

    def weights(mode, seed):
        w = base if seed is None else cs.nudged(base, seed, dev)
        return cs.fp64(w) if mode == "fp64" else w

    def replay(mode, seed):
        """Round 0 of the Split program: [(LoRA, gradient) a step]."""
        f = fed(0)
        sfns = split.make_split_fns(build_model(dataclasses.replace(
            cfg, kernel_policy="cuda" if mode == "kernels" else "torch")), f)
        lt = lora_lib.init_lora(torch.Generator().manual_seed(f.seed + 3),
                                base, lora_lib.DEFAULT_TARGETS, f.lora_rank,
                                f.lora_alpha)
        lt = cs.fp64(lt) if mode == "fp64" else lt
        L = sfns["n_client_layers"]
        c_glob, s_lt = split.split_lora(lt, L)
        base_c, base_s = split.split_base(weights(mode, seed), L)
        s_opt, steps = sfns["opt_init"](s_lt), []
        for data in clients:
            c_lt, c_opt = c_glob, sfns["opt_init"](c_glob)
            for batch in epoch_batches(data, cs.BATCH, seed=f.seed * 983):
                b = to_device(batch, dev)
                _, cg, sg, _, _ = sfns["split_grads"](base_c, base_s, c_lt,
                                                      s_lt, b)
                c_lt, s_lt, c_opt, s_opt, _ = sfns["split_step"](
                    base_c, base_s, c_lt, s_lt, c_opt, s_opt, b)
                steps.append(([t.double() for t in tree_lib.leaves(c_lt)
                               + tree_lib.leaves(s_lt)],
                              [g.double() for g in cg + sg]))
        return steps

    lr = fed(0).lr
    for seed in (None, 2):
        exact = replay("fp64", seed)
        for mode in ("kernels", "plain"):
            first = None
            for i, ((lt, g), (xlt, xg)) in enumerate(zip(replay(mode, seed),
                                                         exact)):
                far = [(a - b).abs() > lr / 2 for a, b in zip(lt, xlt)]
                n = sum(int(f.sum()) for f in far)
                line = (f"split fp32 {mode} from {name(seed)}, step {i}: "
                        f"LoRA relative L2 from fp64 "
                        f"{cs.rel_l2(lt, xlt):.3e}, {n} coordinates > lr/2")
                if n and first is None:
                    k = next(j for j, f in enumerate(far) if f.any())
                    at = tuple(far[k].nonzero()[0].tolist())
                    first = i
                    line += (f"; first in leaf {k} at {at}: gradient "
                             f"{float(g[k][at]):.3e}, fp64 "
                             f"{float(xg[k][at]):.3e} (median |fp64| "
                             f"{float(xg[k].abs().median()):.3e})")
                print(line, flush=True)

    def run(mode, seed, bits):
        torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
        res = run_federated(
            dataclasses.replace(cfg, kernel_policy="cuda" if mode ==
                                "kernels" else "torch"),
            fed(bits), pub, clients, test, batch_size=cs.BATCH,
            eval_batch=64, device=dev, base=weights(mode, seed))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.empty_cache()
        return [t.double() for t in tree_lib.leaves(res.final_lora)]

    def first_step(mode, seed):
        """Round 0 step 0's LoRA gradient of both halves (client 0's
        first batch), as float64."""
        f = fed(0)
        sfns = split.make_split_fns(build_model(dataclasses.replace(
            cfg, kernel_policy="cuda" if mode == "kernels" else "torch")), f)
        lt = lora_lib.init_lora(torch.Generator().manual_seed(f.seed + 3),
                                base, lora_lib.DEFAULT_TARGETS, f.lora_rank,
                                f.lora_alpha)
        lt = cs.fp64(lt) if mode == "fp64" else lt
        L = sfns["n_client_layers"]
        c_lt, s_lt = split.split_lora(lt, L)
        base_c, base_s = split.split_base(weights(mode, seed), L)
        batch = to_device(next(iter(epoch_batches(
            clients[0], cs.BATCH, seed=f.seed * 983))), dev)
        _, cg, sg, _, _ = sfns["split_grads"](base_c, base_s, c_lt, s_lt,
                                              batch)
        return [g.double() for g in cg + sg]

    configs = split_configs(keys)
    seeds = [None] + list(range(copies))
    # the first step from each weight set: how far each configuration's
    # LoRA gradient lies from fp64 (whole, and each leaf's relative L2
    # weighted by its size), the rms error at the coordinates whose fp64
    # gradient is below 1e-3 of its leaf's rms (in units of that rms: the
    # coordinates a first Adam update can flip), and how many coordinates
    # of that update (lr·g / (|g| + eps)) move by over lr/2
    eps = 1e-8
    step0 = {tag: [0.0, 0.0, 0.0, 0, 0]
             for tag in ["plain"] + [t for t, _ in configs]}
    for seed in seeds:
        exact = first_step("fp64", seed)
        for tag, patches in [("plain", ())] + list(configs):
            with patched(patches):
                got = first_step("plain" if tag == "plain" else "kernels",
                                 seed)
            live = [(a, b) for a, b in zip(got, exact) if float(b.abs().max())]
            n = sum(b.numel() for _, b in live)
            acc = step0[tag]
            acc[0] += cs.rel_l2(got, exact) / len(seeds)
            acc[1] += sum(b.numel() * cs.rel_l2([a], [b])
                          for a, b in live) / n / len(seeds)
            for leaf, (a, b) in enumerate(zip(got, exact)):
                if not float(b.abs().max()):
                    continue
                rms = float(b.pow(2).mean().sqrt())
                near = b.abs() < 1e-3 * rms
                acc[2] += float(((a - b)[near] / rms).pow(2).sum())
                acc[3] += int(near.sum())
                flip = (a / (a.abs() + eps) - b / (b.abs() + eps)).abs() > 0.5
                acc[4] += int(flip.sum())
                # where the first update moves, from the seed-0 weights
                for at in flip.nonzero().tolist()[:4] if seed is None else ():
                    at = tuple(at)
                    print(f"split fp32 first step, {tag}, the seed-0 "
                          f"weights: leaf {leaf} {tuple(b.shape)} at {at}: "
                          f"gradient {float(a[at]):.4e}, fp64 "
                          f"{float(b[at]):.4e}, leaf rms {rms:.3e}",
                          flush=True)
        torch.cuda.empty_cache()
    for tag, (whole, leafwise, near_sq, near_n, flips) in step0.items():
        print(f"split fp32 first step, {tag}: LoRA gradient relative L2 "
              f"from fp64 {whole:.4e} (mean of {len(seeds)} weight sets), "
              f"leaf by leaf {leafwise:.4e}, at its {near_n} near-zero "
              f"coordinates {(near_sq / max(near_n, 1)) ** 0.5:.4e} of the "
              f"leaf's rms; {flips} first-update coordinates moved over "
              f"lr/2 in all", flush=True)

    exact0 = run("fp64", None, 0)
    parted = {"plain": 0, **{tag: 0 for tag, _ in configs}}
    for seed in seeds:
        exact = exact0 if seed is None else run("fp64", seed, 0)
        gap = {"plain": cs.rel_l2(run("plain", seed, 0), exact)}
        for tag, patches in configs:
            with patched(patches):
                gap[tag] = cs.rel_l2(run("kernels", seed, 0), exact)
        for tag in parted:
            parted[tag] += gap[tag] > PARTS_AT
        print(f"split fp32 from {name(seed)}: final LoRA relative L2 from "
              f"the fp64 run of the same weights: " + ", ".join(
                  f"{tag} {v:.3e}" for tag, v in gap.items())
              + f"; that fp64 run from the seed-0 weights' "
              f"{cs.rel_l2(exact, exact0):.3e}", flush=True)
    sets = len(seeds)
    for tag, _ in configs:
        two, one = fisher_exact(parted[tag], sets, parted["plain"], sets)
        print(f"split fp32: parted from fp64 (above {PARTS_AT:g}): {tag} "
              f"{parted[tag]} of {sets} weight sets, plain "
              f"{parted['plain']} of {sets}; Fisher exact p {two:.3g} "
              f"(two-sided), {one:.3g} (more often than plain)", flush=True)
    plain = run("plain", None, cs.SPLIT_BITS)
    for mode, seeds in (("plain", range(12)), ("kernels", range(6)),
                        ("tf32", range(3))):
        gaps = [cs.rel_l2(run(mode, s, cs.SPLIT_BITS), plain) for s in seeds]
        print(f"split int8 {mode}, nudged copies 0-{len(gaps) - 1}: final "
              f"LoRA relative L2 from the plain run "
              + ", ".join(f"{v:.3e}" for v in gaps), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_attribution: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["kblock"] and len(sys.argv) == 3:
        return kblock(int(sys.argv[2]))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    if sys.argv[1:] == ["dw"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), torch.__version__, flush=True)
        dw_ablation(torch.device("cuda", 0))
        return 0
    if sys.argv[1:] == ["wkv"]:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), torch.__version__, flush=True)
        wkv_ablation(torch.device("cuda", 0))
        return 0
    if sys.argv[1:] == ["pair"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), torch.__version__, flush=True)
        pair_ablation(torch.device("cuda", 0))
        return 0
    if sys.argv[1:] == ["nan"]:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), torch.__version__, flush=True)
        nan_ablation(torch.device("cuda", 0))
        return 0
    if sys.argv[1:] == ["kd"]:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), torch.__version__, flush=True)
        kd_ablation(torch.device("cuda", 0))
        return 0
    if sys.argv[1:] == ["fp64"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
        fp64_errors(torch.device("cuda", 0))
        return 0
    if sys.argv[1:2] == ["split"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), torch.__version__)
        args = sys.argv[2:]
        copies = int(args.pop(0)) if args and args[0].isdigit() else 8
        split_spread(torch.device("cuda", 0), copies, args)
        return 0
    if sys.argv[1:] == ["rwkv"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), torch.__version__)
        rwkv_trajectory(torch.device("cuda", 0))
        return 0
    import chip_smoke
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.recurrentgemma_2b import recurrentgemma_2b
    from repro_torch.core.rounds import run_federated
    from repro_torch.data import banking77, partition
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), torch.__version__)
    cfg = recurrentgemma_2b()
    pub, train, test = banking77.paper_splits(
        cfg.vocab_size, pad_len=chip_smoke.PAD_LEN, scale=0.03)
    clients = partition.iid_partition(train, 3)
    base = build_model(cfg).init(torch.Generator().manual_seed(0), dev)
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=chip_smoke.RANK,
                    lora_dropout=0.0)

    def run(policy):
        return run_federated(dataclasses.replace(cfg, kernel_policy=policy),
                             fed, pub, clients, test,
                             batch_size=chip_smoke.BATCH, eval_batch=64,
                             device=dev, base=base)

    plain = run("torch")
    for tag, names in (("all kernels", ()),
                       ("plain LoRA projection", ("lora_matmul",)),
                       ("plain attention", ("mha_attention",)),
                       ("plain RG-LRU scan", ("rglru",)),
                       ("only the RG-LRU scan kernels",
                        ("lora_matmul", "mha_attention"))):
        saved = {name: getattr(ops, name) for name in names}
        for name, op in saved.items():
            setattr(ops, name, plain_version(op))
        ops.reset_launches()
        try:
            res = run("cuda")
        finally:
            for name, op in saved.items():
                setattr(ops, name, op)
        _, rel, worst = chip_smoke.lora_gap(res.final_lora, plain.final_lora)
        losses = [f"{h.loss - p.loss:.3e}"
                  for h, p in zip(res.history, plain.history)]
        print(f"{tag}: final LoRA relative L2 {rel:.4e}, max abs "
              f"{worst:.3e}; round loss - plain {losses}; launches "
              f"{ {k: n for k, n in ops.launches().items() if n} }",
              flush=True)

    fp64_errors(dev)
    return 0


def fp64_errors(dev) -> None:
    """The LoRA forward, dx and dW kernels' rms error against fp64, beside
    cuBLAS's and cuBLASLt's, at GPT-2's and RecurrentGemma-2B's
    projection shapes (chip_smoke.lora_fp64_errors)."""
    import chip_smoke
    M = chip_smoke.BATCH * chip_smoke.PAD_LEN
    for K, N in ((768, 768), (2560, 2560), (2560, 256)):
        chip_smoke.lora_fp64_errors(dev, M, K, N, 17)


if __name__ == "__main__":
    sys.exit(main())
