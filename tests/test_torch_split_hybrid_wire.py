"""The port's Split-FedLLM on the Griffin hybrid (RecurrentGemma) against
the reference's through a quantized boundary, on the CPU:
``recurrentgemma-2b.reduced(n_layers=8, d_model=128)`` at
``split_layer=1`` (tests/test_torch_split_hybrid.py has the fp32
boundary; the shared pieces and bars: tests/test_torch_split_family.py)
with an int8 boundary and the c2 DP mechanism (each boundary row clipped
at about the median row norm of the first batch, noise 0, secure
aggregation) and with an int4 boundary, 1 round each.  Level flips
part the runs (ROADMAP §3), so the final LoRA is held to the port's own
nudged runs and the first step to its boundary levels; a run with a
planted quantizer fault is the control of both."""
from unittest import mock

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import test_torch_split_family as fam  # noqa: E402

# about the median L2 norm of a boundary row of the first batch (7.4-13.5
# at split_layer 1), so some rows clip and some do not
CLIP = 9.8
SETTINGS = {"bits8-dp": dict(layers=8, split_layer=1, rounds=1,
                             activation_quant_bits=8,
                             privacy=dict(dp_clip=CLIP, secure_agg=True)),
            "bits4": dict(layers=8, split_layer=1, rounds=1,
                          activation_quant_bits=4)}

# The run-level bar that fails the planted one-level fault (fam.
# planted_roundtrip), as measured: the final LoRA's, at 5.5x (int8 + DP)
# and 1.3x (int4) its limit; the rounds stay within theirs
PLANTED_CAUGHT_BY = {"bits8-dp": "final_lora", "bits4": "final_lora"}


@pytest.fixture(scope="module")
def runs():
    return fam.run_pairs("hybrid", SETTINGS, quantized=tuple(SETTINGS))


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_split_ledger_flops_epsilon_and_rounds(runs, setting):
    """Accounting exact (epsilon inf under DP at noise 0); rounds within
    the nudged runs' spread."""
    ref, port = runs[setting]
    fam.assert_accounting_equal(ref, port)
    fam.assert_rounds_within_flip_floor(runs, setting)
    dp = "privacy" in SETTINGS[setting]
    assert all((h.epsilon == float("inf")) == dp for h in port.history)
    assert ("secagg_keys" in port.ledger.by_name()) == dp


def test_split_ledger_matches_hand_reckoning(runs):
    """int8 with DP: the wire by hand; the client half is layer 2's A and
    B of wq, wk (one KV head) and wv."""
    _, port = runs["bits8-dp"]
    _, cfg = fam.cfgs("hybrid", 8)
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv_heads * cfg.head_dim
    fam.assert_split_ledger_by_hand(
        port, cfg, 1, fam.RANK * ((d + q) + 2 * (d + kv)) * 4, dp=True)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_split_final_lora_within_level_flip_floor(runs, setting):
    fam.assert_final_lora_within_flip_floor(runs, setting, "hybrid", 8)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_split_planted_level_fault_is_caught(runs, setting):
    """The control of the bars above: the port with its boundary one
    level off on one row in 64 (fam.planted_roundtrip) fails the first
    step's boundary levels, and the run-level bar named in
    PLANTED_CAUGHT_BY (None: neither run-level bar resolves it after one
    round).  The readings, with the port's fp64 run's, are printed."""
    got = fam.flip_floor_readings(runs, setting, "hybrid", 8)
    print(f"{setting}: " + ", ".join(
        f"{k} {v:.4e}" if isinstance(v, float) else
        f"{k} [" + ", ".join(f"{x:.4e}" for x in v) + "]"
        for k, v in got.items()))
    with mock.patch.object(fam.compression, "quant_roundtrip",
                           fam.planted_roundtrip):
        with pytest.raises(AssertionError):
            fam.assert_boundary_levels_match("hybrid", 8, 1,
                                             SETTINGS[setting]
                                             ["activation_quant_bits"])
    bar = PLANTED_CAUGHT_BY[setting]
    if bar == "rounds":
        with pytest.raises(AssertionError):
            fam.assert_rounds_within_flip_floor(runs, setting, "planted")
    elif bar == "final_lora":
        with pytest.raises(AssertionError):
            fam.assert_final_lora_within_flip_floor(runs, setting, "hybrid", 8,
                                                    judged="planted")


@pytest.mark.parametrize("bits", [8, 4])
def test_split_boundary_levels_match(bits):
    fam.assert_boundary_levels_match("hybrid", 8, 1, bits)
