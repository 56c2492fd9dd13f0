"""The port's Split-FedLLM on RWKV-6 (Finch) against the reference's, on
the CPU, with an fp32 boundary (the quantized ones and the c2 DP
mechanism: tests/test_torch_split_rwkv_wire.py; the shared pieces and
bars: tests/test_torch_split_family.py): ``rwkv6_1_6b().reduced(
n_layers=2, d_model=128)`` with LoRA on w_r/w_k/w_v/w_g, split after
layer 0 (``split_layer=1``: the client holds layer 0, the server layer 1,
the final LayerNorm and the untied head), under ``sequential`` and
``spmd`` (2 rounds each; the latter against the reference's unsharded
spmd run).  The runs' sequences are 24 long, no multiple of the
reference's WKV chunk, so its time-mix takes the exact step scan, whose
exponents no clamp touches."""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import test_torch_split_family as fam  # noqa: E402
from repro.models import rwkv6 as ref_rwkv6  # noqa: E402
from repro_torch.core import split  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

SETTINGS = {"bits0": dict(layers=2, split_layer=1, rounds=2),
            "spmd": dict(layers=2, split_layer=1, rounds=2, backend="spmd")}


@pytest.fixture(scope="module")
def runs():
    return fam.run_pairs("rwkv", SETTINGS)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_split_ledger_flops_and_epsilon_equal(runs, setting):
    fam.assert_accounting_equal(*runs[setting])


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_split_rounds_and_final_lora_close(runs, setting):
    """The reference's Split runs on RWKV-6 to the end; the port's rounds
    and joined final LoRA (2 layers x 4 targets x A, B) at the bar."""
    ref, port = runs[setting]
    assert len(ref.history) == 2
    fam.assert_rounds_close(ref, port)
    fam.assert_final_lora_close(ref, port, "rwkv", 2, 8)


def test_split_spmd_is_the_sequential_run_bit_for_bit(runs):
    fam.assert_spmd_is_sequential(runs["bits0"][1], runs["spmd"][1])


def test_split_step_with_no_client_layer_matches_reference():
    """split_layer 0 (L = 0): the client only embeds, the server holds
    both layers; one step against the reference's, and the reference's
    WKV takes its step scan at this S (no exponent clamp)."""
    assert 24 % ref_rwkv6.CHUNK != 0
    sfns = fam.assert_split_step_matches("rwkv", 2, 0, 8)
    assert sfns["n_client_layers"] == 0


def test_split_partition_of_rwkv():
    """One layer a pattern group: the client takes layers [0, L), the
    server the rest and the untied head."""
    _, cfg = fam.cfgs("rwkv", 2)
    base, lora = fam.bridged("rwkv", 2)
    assert transformer.n_groups_of(cfg) == 2
    assert transformer.group_len(cfg) == 1
    c, s = split.split_lora(lora, 1)
    assert len(c["layers"]) == len(s["layers"]) == 1
    bc, bs = split.split_base(base, 1)
    assert "lm_head" in bs and "lm_head" not in bc
    assert "final_norm" in bs and "final_norm" not in bc
