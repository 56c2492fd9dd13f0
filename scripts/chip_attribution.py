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
after layer 2, fp32 boundary) part from fp64: for the kernel and plain
runs, from the seed-0 weights and from nudged copy 2, each of round 0's
nine steps replayed beside an fp64 replay of the same weights, printing
the LoRA's relative L2 from it, the coordinates more than lr/2 away and,
where they first appear, the gradient there against the fp64 one; then
the final LoRA of full runs from the seed-0 weights and from nudged
copies 0-7, kernels and plain each measured from an fp64 run of the same
weights, with how many of those weight sets part (above PARTS_AT from
their own fp64 run) for each and the Fisher exact p of the difference;
then the int8 set's spread: plain runs from nudged copies 0-11, kernel
runs from 0-5 and TF32 runs from 0-2, measured from the plain run (about
two minutes).  A count after ``split`` takes that many nudged copies
instead of 8 (each adds three Split runs, about 8 seconds):

    python3 scripts/chip_attribution.py split [COPIES]

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

Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

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


def split_spread(dev, copies: int = 8) -> None:
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
        L = sfns["n_client_groups"]
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

    exact0 = run("fp64", None, 0)
    parted = {"plain": 0, "kernels": 0}
    for seed in [None] + list(range(copies)):
        exact = exact0 if seed is None else run("fp64", seed, 0)
        gap = {mode: cs.rel_l2(run(mode, seed, 0), exact) for mode in parted}
        for mode in parted:
            parted[mode] += gap[mode] > PARTS_AT
        print(f"split fp32 from {name(seed)}: final LoRA relative L2 from "
              f"the fp64 run of the same weights: plain "
              f"{gap['plain']:.3e}, kernels {gap['kernels']:.3e}; that fp64 "
              f"run from the seed-0 weights' {cs.rel_l2(exact, exact0):.3e}",
              flush=True)
    sets = copies + 1
    two, one = fisher_exact(parted["kernels"], sets, parted["plain"], sets)
    print(f"split fp32: parted from fp64 (above {PARTS_AT:g}): kernels "
          f"{parted['kernels']} of {sets} weight sets, plain "
          f"{parted['plain']} of {sets}; Fisher exact p {two:.3g} "
          f"(two-sided), {one:.3g} (kernels more often)", flush=True)
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
    if sys.argv[1:] == ["fp64"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
        fp64_errors(torch.device("cuda", 0))
        return 0
    if sys.argv[1:2] == ["split"] and len(sys.argv) <= 3:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), torch.__version__)
        split_spread(torch.device("cuda", 0),
                     int(sys.argv[2]) if len(sys.argv) == 3 else 8)
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

    def plain_version(op):
        def call(*args, **kwargs):
            with ops.policy_scope("torch"):
                return op(*args, **kwargs)
        return call

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
