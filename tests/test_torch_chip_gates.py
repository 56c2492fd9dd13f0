"""The arithmetic of chip_smoke.py's gates that hold a case study's runs to
its fp32 plain runs (``fp32_gates``): with the floor run alone it gives
the limits the script had before nudged runs joined, with nudged runs
each limit is set by the largest fp32 run, and a TF32 control inside a
limit fails.  Pure arithmetic on measured distances: no card, no model."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

F, SLACK, SPREAD = cs.FLOOR_FACTOR, cs.FLOOR_SLACK, cs.SPREAD_FACTOR

# two rounds of |loss - plain loss| and the final LoRA's distances, as a
# phase measures them with the floor run alone
LOSS = [{"kernels": 2e-4, "floor": 3e-4, "control": 5e-2},
        {"kernels": 1e-3, "floor": 5e-4, "control": 6e-3}]
FROM_FP64 = {"kernels": 2e-5, "plain": 1e-5, "floor": 7e-6, "control": 5e-4}
FROM_PLAIN = {"kernels": 6e-4, "floor": 5e-4, "control": 4e-3}
FLIPS = {"kernels": 4.7e-4, "floor": 5.8e-4, "control": 4.8e-2}


def test_importing_chip_smoke_loads_no_torch():
    code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
            "assert 'torch' not in sys.modules" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, env=dict(os.environ))
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("kind", ["continuous", "spread"])
def test_floor_run_alone_gives_the_earlier_limits(kind):
    lora = FROM_FP64 if kind == "continuous" else FROM_PLAIN
    limits, failed = cs.fp32_gates(kind, LOSS, lora)
    if kind == "continuous":
        assert limits["loss"] == [1e-3, 1e-3]
        assert limits["lora"] == F * max(lora["plain"], lora["floor"]) + SLACK
    else:
        assert limits["loss"] == [1e-3 + F * d["floor"] for d in LOSS]
        assert limits["lora"] == SPREAD * lora["floor"] + SLACK
    assert limits["flips"] is None
    assert failed == []


def test_flip_floor_alone_gives_the_earlier_limit():
    limits, failed = cs.fp32_gates(flips=FLIPS)
    assert limits == {"loss": [], "lora": None,
                      "flips": F * FLIPS["floor"] + SLACK}
    assert failed == []


@pytest.mark.parametrize("kind", ["continuous", "spread"])
def test_nudged_runs_widen_each_limit_to_the_largest_fp32_run(kind):
    base = FROM_FP64 if kind == "continuous" else FROM_PLAIN
    lora = {**base, "seed 0": base["floor"] / 2, "seed 1": base["floor"] * 4,
            "seed 2": base["floor"]}
    loss = [{**d, "seed 0": d["floor"] * 2, "seed 1": 0.0, "seed 2": 1e-7}
            for d in LOSS]
    limits, failed = cs.fp32_gates(kind, loss, lora)
    fp32 = max(v for r, v in lora.items() if r not in ("kernels", "control"))
    assert fp32 == lora["seed 1"]
    factor = SPREAD if kind == "spread" else F
    assert limits["lora"] == factor * fp32 + SLACK
    if kind == "continuous":
        assert limits["loss"] == [1e-3, 1e-3]
    else:
        assert limits["loss"] == [1e-3 + F * 2 * d["floor"] for d in LOSS]
    assert failed == []
    # the kernel run beyond the floor-only limit passes only by the
    # nudged runs it is measured with
    wide = {**lora, "kernels": factor * lora["floor"] * 3}
    assert cs.fp32_gates(kind, loss, wide)[1] == []
    assert cs.fp32_gates(kind, LOSS, {r: v for r, v in wide.items()
                                      if not r.startswith("seed")})[1]


def test_nudged_flip_shares_widen_the_flip_floor():
    flips = {**FLIPS, "seed 0": 9e-4, "seed 1": 2e-4}
    limits, failed = cs.fp32_gates(flips=flips)
    assert limits["flips"] == F * 9e-4 + SLACK
    assert failed == []


@pytest.mark.parametrize("kind", ["continuous", "spread"])
def test_tf32_inside_the_final_lora_limit_fails(kind):
    lora = dict(FROM_FP64 if kind == "continuous" else FROM_PLAIN)
    lora["control"] = lora["floor"]
    failed = cs.fp32_gates(kind, LOSS, lora)[1]
    assert any("TF32" in what for what in failed)


def test_tf32_inside_the_flip_floor_fails():
    failed = cs.fp32_gates(flips={**FLIPS, "control": 1e-3})[1]
    assert any("boundary-level gate" in what for what in failed)


@pytest.mark.parametrize("case", [
    ("continuous", "loss"), ("continuous", "lora"), ("spread", "loss"),
    ("spread", "lora"), (None, "flips")])
def test_kernel_run_beyond_a_limit_fails(case):
    kind, gate = case
    if gate == "flips":
        failed = cs.fp32_gates(flips={**FLIPS, "kernels": 1.0})[1]
        assert any("boundary levels" in what for what in failed)
        return
    lora = FROM_FP64 if kind == "continuous" else FROM_PLAIN
    loss = [{**d, "kernels": 1.0} for d in LOSS] if gate == "loss" else LOSS
    if gate == "lora":
        lora = {**lora, "kernels": 1.0}
    failed = cs.fp32_gates(kind, loss, lora)[1]
    assert failed and all(("round loss" if gate == "loss" else "final LoRA")
                          in what for what in failed)


@pytest.mark.parametrize("role, kind, want", [
    ("kernels", "continuous", "exact"), ("plain", "continuous", "exact"),
    ("seed 2", "continuous", "exact 2"), ("kernels", "spread", "plain"),
    ("seed 2", "spread", "plain")])
def test_each_run_is_measured_from_the_fp64_run_of_its_own_weights(
        role, kind, want):
    assert cs.yardstick(role, kind) == want


PTXAS = """ptxas info    : Compiling entry function '_Z15flash_dq_kernelILi64EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z15flash_dq_kernelILi64EEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 17408 bytes smem
ptxas info    : Function properties for _Z15flash_dq_kernelILi256EEvPKf
    16 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 82944 bytes smem
ptxas info    : Function properties for _Z17flash_fwd_kernelILi64EEvPKf
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
"""


@pytest.mark.parametrize("kernel,want", [
    ("flash_dq_kernel", {"_Z15flash_dq_kernelILi64EEvPKf": 0,
                         "_Z15flash_dq_kernelILi256EEvPKf": 32}),
    ("flash_fwd_kernel", {"_Z17flash_fwd_kernelILi64EEvPKf": 16}),
    ("lora_fused_kernel", {})])
def test_kernel_spills_reads_each_instance_of_the_named_kernel(kernel, want):
    """Phase 1's spill check: the spill stores plus loads of every
    instance of one kernel in a ptxas -v report, and no other kernel's."""
    assert cs.kernel_spills(PTXAS, kernel) == want


def test_kernel_resources_reads_registers_beside_spills():
    """The build report's registers and spill bytes of each instance,
    printed for the three flash kernels by head dim (flash_instances)."""
    assert cs.kernel_resources(PTXAS, "flash_dq_kernel") == {
        "_Z15flash_dq_kernelILi64EEvPKf": (0, 128),
        "_Z15flash_dq_kernelILi256EEvPKf": (32, 255)}
    assert cs.kernel_resources(PTXAS, "flash_fwd_kernel") == {
        "_Z17flash_fwd_kernelILi64EEvPKf": (16, 96)}


def test_no_spill_check_covers_flash_dq_and_the_fused_lora_kernel():
    """Every flash kernel's four head-dim instances (DT 128 among them,
    the attention of Qwen2/3, Mistral, Mixtral and Qwen3-MoE) join the
    check."""
    assert cs.NO_SPILLS == {"lora_fused_kernel": ("lora_matmul", 8),
                            "lora_dw_kernel": ("lora_matmul", 1),
                            "flash_fwd_kernel": ("flash_attention", 4),
                            "flash_dq_kernel": ("flash_attention", 4),
                            "flash_dkv_kernel": ("flash_attention", 4),
                            "rwkv6_bwd_kernel": ("rwkv6_scan", 6),
                            "topk_radix_kernel": ("quantize", 2),
                            "panel_grad_kernel": ("lora_matmul", 1),
                            "kd_fwd_kernel": ("kd_loss", 7),
                            "quant_roundtrip_kernel": ("quantize", 4)}


H100 = cs.PEAKS["H100"]


@pytest.mark.parametrize("name", ["lora_fwd", "lora_dx", "lora_dw"])
def test_3xtf32_lora_kernels_take_their_bound_at_a_third_of_tf32(name):
    """The dense dW kernel (row 3) runs on the tensor cores in 3xTF32, as
    the fused forward and dx do: its operation bound is at a third of the
    card's TF32 rate, its fp32-rate bound printed beside it."""
    M, K, N = 1280, 2560, 2560
    nbytes, nflops = 4 * (M * K + M * N + K * N), 2 * M * K * N
    got = cs.kernel_bound(name, nbytes, nflops, H100)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(nflops / (H100[2] / 3) * 1e3)
    assert got["bound_fp32_ms"] == pytest.approx(nflops / H100[0] * 1e3)


def test_byte_bound_kernels_keep_the_fp32_rate():
    nbytes, nflops = 4 * (16 * 442368 + 16), 2 * 16 * 442368
    got = cs.kernel_bound("dp_clip_norms", nbytes, nflops, H100)
    assert got == {"bound_ms": pytest.approx(nbytes / H100[1] * 1e3),
                   "bound_by": "bytes"}


def test_every_counted_kernel_has_its_row_in_the_kernels_line():
    """chip_smoke's JSON line has one row for each launch counter the
    port keeps (``ops.launches()``), the per-example panel with the
    ``vmap`` of the reference's DP step beside the TPU kernel it
    replaces."""
    pytest.importorskip("torch")
    from repro_torch.kernels import ops

    assert set(cs.REPLACES) == set(ops.launches())
    assert set(cs.VMAPPED) <= set(cs.REPLACES)
    assert cs.REPLACES["lora_panel_examples"][0] == \
        cs.REPLACES["lora_panel"][0]


@pytest.mark.parametrize("seed,n,staleness,rounds", [
    (17, 3, 2, 4), (17, 3, 0, 3), (4, 5, 3, 7), (30, 2, 1, 6)])
def test_async_reckoning_is_the_schedule_the_run_follows(seed, n, staleness,
                                                         rounds):
    """Phase 11's hand reckoning of an async run's jobs (numpy alone) is
    the round program's AsyncSchedule driven as run_program drives it:
    the same starts, and the same arrivals at the same staleness."""
    pytest.importorskip("torch")
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.round_program import AsyncSchedule

    sched = AsyncSchedule(FedConfig(seed=seed - 17, max_staleness=staleness,
                                    aggregation="async"), n)
    starts, arrivals = [], []
    for rnd in range(rounds):
        for ci in sched.starters(rnd):
            starts.append((rnd, ci))
            sched.submit(rnd, ci, None)
        arrivals += [(rnd, j.client, rnd - j.start)
                     for j in sched.pop_arrivals(rnd)]
    assert cs.async_reckoning(seed, n, staleness, rounds) == (starts,
                                                              arrivals)


def test_lora_deltas_walks_the_tree_in_order():
    """Phase 11's lora_deltas: alpha / r * A @ B of every LoRA leaf, in
    tree order, skipping the None layers of a hybrid; two trees whose
    factors differ by a sign flip of a rank component give the same
    deltas."""
    torch = pytest.importorskip("torch")
    gen = torch.Generator().manual_seed(0)

    def leaf(d, r, f):
        return {"a": torch.randn(d, r, generator=gen),
                "b": torch.randn(r, f, generator=gen)}
    tree = {"layers": [None, {"attn": {"wq": leaf(6, 2, 5),
                                       "wv": leaf(6, 2, 3)}},
                       None, {"attn": {"wq": leaf(6, 4, 5)}}]}
    flip = torch.tensor([-1.0, 1.0])
    flipped = {"layers": [None, {"attn": {
        k: {"a": v["a"] * flip, "b": v["b"] * flip[:, None]}
        for k, v in tree["layers"][1]["attn"].items()}}, None,
        tree["layers"][3]]}
    want = [8.0 / 2 * tree["layers"][1]["attn"]["wq"]["a"]
            @ tree["layers"][1]["attn"]["wq"]["b"],
            8.0 / 2 * tree["layers"][1]["attn"]["wv"]["a"]
            @ tree["layers"][1]["attn"]["wv"]["b"],
            8.0 / 4 * tree["layers"][3]["attn"]["wq"]["a"]
            @ tree["layers"][3]["attn"]["wq"]["b"]]
    for got in (cs.lora_deltas(tree, 8.0), cs.lora_deltas(flipped, 8.0)):
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("faults,quorum,secagg,cohort", [
    (dict(dropout_rate=0.3, byzantine=1, byzantine_mode="nan"), 0.0, True,
     {}),
    (dict(dropout_rate=0.5), 1.0, False, {}),
    (dict(dropout_rate=0.4, byzantine=1, byzantine_mode="inf", seed=3), 0.5,
     True, {}),
    (dict(dropout_rate=0.3, byzantine=1, byzantine_mode="nan"), 0.5, True,
     dict(backend="cohort", cohort_size=2, n_edges=2,
          robust_agg="trimmed_mean", trim_frac=0.34))])
def test_fault_reckoning_is_the_run_the_port_makes(faults, quorum, secagg,
                                                   cohort):
    """Phase 13's hand reckoning of a faulted sync FedLLM run (numpy and
    the FaultPlan alone) against the port's run on the CPU at a tiny
    size: the ledger by name, the fault events in order and the
    rollovers.  Streamed by the cohort executor (4 clients in chunks of
    2 over 2 edges, as phase 13's faulted cohort run is) the key
    exchange, the recovery shares and the edge hop are the chunks', so
    there the fault events, the rollovers and the payload and fault
    bytes are held."""
    pytest.importorskip("torch")
    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import FaultConfig, FedConfig, PrivacyConfig
    from repro_torch.configs.gpt2_small import gpt2_tiny
    from repro_torch.core import metrics
    from repro_torch.core.rounds import run_federated
    from repro_torch.data import banking77, partition

    cfg = gpt2_tiny()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.02)
    n = 4 if cohort else 3
    fed = FedConfig(rounds=3, lora_rank=2, lora_dropout=0.0, quorum=quorum,
                    faults=FaultConfig(**faults),
                    privacy=PrivacyConfig(secure_agg=secagg), **cohort)
    res = run_federated(cfg, fed, pub, partition.iid_partition(train, n),
                        test, device="cpu")
    lora_bytes = metrics.tree_bytes(res.final_lora)
    assert lora_bytes == sum(x.numel() * 4
                             for x in tree_lib.leaves(res.final_lora))
    ledger, events, rollovers = cs.fault_reckoning(fed, n, lora_bytes)
    got = res.ledger.by_name()
    if cohort:
        names = ("lora_params", "quarantine", "retransmit")
        got, ledger = ({k: d.get(k) for k in names} for d in (got, ledger))
        assert 0 < rollovers < fed.rounds
    assert got == ledger
    assert cs.fault_events(res) == events
    assert res.rollovers == rollovers
    assert events


def _drops_nan(x, bits=8):
    """Row 10's levels as fmaxf-based kernels would take them: NaN left
    out of the absmax and the scale's clamp, a NaN level clamped to
    -qmax."""
    import torch
    qmax = float((1 << (bits - 1)) - 1)
    xf = x.float()
    absmax = torch.nan_to_num(xf.abs(), nan=0.0).amax(-1, keepdim=True)
    scale = torch.clamp_min(absmax / qmax, 1e-12)
    q = torch.nan_to_num(torch.round(xf / scale), nan=-qmax)
    return torch.clamp(q, -qmax, qmax).to(torch.int8), scale


def test_nonfinite_agree_holds_twins_and_catches_a_dropped_nan():
    """Phase 2's check on non-finite rows: each quantizer's twin agrees
    with itself on nonfinite_rows, whose first rows hold NaN and +-inf
    where NONFINITE_ROWS says; a quantizer that drops a NaN (a finite
    scale where the twin's is NaN) fails it."""
    torch = pytest.importorskip("torch")
    from repro_torch.kernels import ref

    n_bad = len(cs.NONFINITE_ROWS)
    x = cs.nonfinite_rows("cpu", 40, 77, 5)
    assert torch.isnan(x[1]).all() and torch.isneginf(x[4]).all()
    assert torch.isfinite(x[n_bad:]).all()
    for name, out in (
            ("topk_quantize", lambda: ref.topk_quantize_rows_ref(x, 8, 8)),
            ("quantize_rows", lambda: ref.quantize_rows_ref(x, 8)),
            ("quant_roundtrip_rows",
             lambda: ref.quant_roundtrip_rows_ref(x, 8)),
            ("quantize_pack4",
             lambda: ref.quantize_pack4_rows_ref(x[:, :76].contiguous()))):
        assert cs.nonfinite_agree(name, out(), out(), n_bad) == 0
    q, scale = ref.quantize_rows_ref(x, 8)
    assert torch.isnan(scale[[0, 1, 5]]).all()
    assert torch.isinf(scale[[2, 3]]).all()
    with pytest.raises(RuntimeError, match="scales of non-finite rows"):
        cs.nonfinite_agree("quantize_rows", _drops_nan(x),
                           ref.quantize_rows_ref(x, 8), n_bad)


def test_loss_kind_widens_the_round_losses_alone():
    """``loss_kind="spread"`` on a continuous path: each round's loss
    limit adds FLOOR_FACTOR times the largest fp32 difference from plain,
    while the final LoRA keeps the continuous limit from fp64."""
    loss = [{"kernels": 4.1e-3, "floor": 4.4e-3, "control": 2.8e-3}]
    lora = {"kernels": 1.3e-4, "plain": 1.0e-4, "floor": 1.6e-4,
            "control": 1.1e-3}
    limits, failed = cs.fp32_gates("continuous", loss, lora)
    assert limits["loss"] == [1e-3] and failed == [
        "round loss of the kernel run is off the plain run's beyond its "
        "limit"]
    limits, failed = cs.fp32_gates("continuous", loss, lora,
                                   loss_kind="spread")
    assert failed == []
    assert limits["loss"] == [pytest.approx(1e-3 + cs.FLOOR_FACTOR * 4.4e-3)]
    assert limits["lora"] == pytest.approx(cs.FLOOR_FACTOR * 1.6e-4
                                           + cs.FLOOR_SLACK)

