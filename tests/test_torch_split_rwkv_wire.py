"""The port's Split-FedLLM on RWKV-6 (Finch) against the reference's
through a quantized boundary, on the CPU: ``rwkv6_1_6b().reduced(
n_layers=2, d_model=128)`` at ``split_layer=1`` with LoRA on
w_r/w_k/w_v/w_g (tests/test_torch_split_rwkv.py has the fp32 boundary;
the shared pieces and bars: tests/test_torch_split_family.py), with an
int8 boundary and the c2 DP mechanism (each boundary row clipped at
about the median row norm of the first batch, noise 0, secure
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

# about the median L2 norm of a boundary row of the first batch (0.73-7.9
# at split_layer 1), so some rows clip and some do not
CLIP = 5.1
SETTINGS = {"bits8-dp": dict(layers=2, split_layer=1, rounds=1,
                             activation_quant_bits=8,
                             privacy=dict(dp_clip=CLIP, secure_agg=True)),
            "bits4": dict(layers=2, split_layer=1, rounds=1,
                          activation_quant_bits=4)}

# The run-level bar that fails the planted one-level fault (fam.
# planted_roundtrip), as measured: int4's round loss, at 2.7x its limit.
# Under int8 + DP the port's own nudged runs part by up to 7e-3 in loss
# and 5e-4 in the final LoRA after one round, and the fault stays within
# both bars (0.10 and 0.51 of them; a one-level fault on every row, 0.40
# and 0.98), so there only the first step's levels hold the boundary
PLANTED_CAUGHT_BY = {"bits8-dp": None, "bits4": "rounds"}


@pytest.fixture(scope="module")
def runs():
    return fam.run_pairs("rwkv", SETTINGS, quantized=tuple(SETTINGS))


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
    """int8 with DP: the wire by hand; the client half is layer 0's A and
    B of the four time-mix projections (d x d each)."""
    _, port = runs["bits8-dp"]
    _, cfg = fam.cfgs("rwkv", 2)
    d = cfg.d_model
    fam.assert_split_ledger_by_hand(port, cfg, 1, 4 * fam.RANK * 2 * d * 4,
                                    dp=True)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_split_final_lora_within_level_flip_floor(runs, setting):
    fam.assert_final_lora_within_flip_floor(runs, setting, "rwkv", 2)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_split_planted_level_fault_is_caught(runs, setting):
    """The control of the bars above: the port with its boundary one
    level off on one row in 64 (fam.planted_roundtrip) fails the first
    step's boundary levels, and the run-level bar named in
    PLANTED_CAUGHT_BY (None: neither run-level bar resolves it after one
    round).  The readings, with the port's fp64 run's, are printed."""
    got = fam.flip_floor_readings(runs, setting, "rwkv", 2)
    print(f"{setting}: " + ", ".join(
        f"{k} {v:.4e}" if isinstance(v, float) else
        f"{k} [" + ", ".join(f"{x:.4e}" for x in v) + "]"
        for k, v in got.items()))
    with mock.patch.object(fam.compression, "quant_roundtrip",
                           fam.planted_roundtrip):
        with pytest.raises(AssertionError):
            fam.assert_boundary_levels_match("rwkv", 2, 1,
                                             SETTINGS[setting]
                                             ["activation_quant_bits"])
    bar = PLANTED_CAUGHT_BY[setting]
    if bar == "rounds":
        with pytest.raises(AssertionError):
            fam.assert_rounds_within_flip_floor(runs, setting, "planted")
    elif bar == "final_lora":
        with pytest.raises(AssertionError):
            fam.assert_final_lora_within_flip_floor(runs, setting, "rwkv", 2,
                                                    judged="planted")


@pytest.mark.parametrize("bits", [8, 4])
def test_split_boundary_levels_match(bits):
    fam.assert_boundary_levels_match("rwkv", 2, 1, bits)
