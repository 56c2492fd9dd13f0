"""The port's Split-FedLLM on the Griffin hybrid (RecurrentGemma) against
the reference's, on the CPU, with an fp32 boundary (the quantized ones
and the c2 DP mechanism: tests/test_torch_split_hybrid_wire.py; the
shared pieces and bars: tests/test_torch_split_family.py):
``recurrentgemma-2b.reduced(n_layers=8, d_model=128)`` (two (rglru,
rglru, local_attn) pattern groups and a two-layer RG-LRU tail) split
after pattern group 0 (``split_layer=1``: the client holds layers 0-2,
one of them local attention with LoRA on wq/wk/wv; the server layers
3-7, the final RMSNorm and the tied head), under ``sequential`` (2
rounds) and ``spmd`` (2 rounds, against the reference's unsharded spmd
run); and the 5-layer hybrid of tests/test_torch_recurrent.py, whose one
group leaves the client no layer (L = 0: the client only embeds; 1
round)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import test_torch_split_family as fam  # noqa: E402
from repro.core import split as ref_split  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.core import split  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

SETTINGS = {"bits0": dict(layers=8, split_layer=1, rounds=2),
            "spmd": dict(layers=8, split_layer=1, rounds=2, backend="spmd"),
            "L0": dict(layers=5, split_layer=1, rounds=1)}


@pytest.fixture(scope="module")
def runs():
    return fam.run_pairs("hybrid", SETTINGS)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_split_ledger_flops_and_epsilon_equal(runs, setting):
    ref, port = runs[setting]
    fam.assert_accounting_equal(ref, port)
    if setting == "L0":
        # the client holds no layer: no adapter crosses the wire, and its
        # share of the model's FLOPs is 0 of 1 groups
        assert port.ledger.by_name()["lora_params"] == 0
        assert port.client_flops == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_split_rounds_and_final_lora_close(runs, setting):
    """The reference's Split runs on the hybrid (with a tail, L 1 and L 0)
    to the end; the port's rounds and joined final LoRA at the bar."""
    ref, port = runs[setting]
    assert len(ref.history) == SETTINGS[setting]["rounds"]
    fam.assert_rounds_close(ref, port)
    fam.assert_final_lora_close(ref, port, "hybrid",
                                SETTINGS[setting]["layers"], 6)


def test_split_spmd_is_the_sequential_run_bit_for_bit(runs):
    fam.assert_spmd_is_sequential(runs["bits0"][1], runs["spmd"][1])


def test_split_step_matches_reference():
    """One split step at L = 1 on 8 layers: the client half holds 3
    layers, the server the other 5 with the tail (L = 0 on 5 layers:
    tests/test_torch_recurrent.py)."""
    sfns = fam.assert_split_step_matches("hybrid", 8, 1, 6)
    assert sfns["n_client_groups"] == 1 and sfns["n_client_layers"] == 3


def test_forward_groups_on_a_hybrid_half():
    """The server half of the 8-layer hybrid at L = 1 (group 1 and the
    tail, counted from the start of the half) against the reference's
    forward_groups on its server half, from the same input."""
    ref_cfg, cfg = fam.cfgs("hybrid", 8)
    params, _ = fam.weights("hybrid", 8)
    base, _ = fam.bridged("hybrid", 8)
    _, base_s = split.split_base(base, 3)
    _, ref_s = ref_split.split_base(params, 1, False)
    x = np.random.default_rng(5).standard_normal((2, 24, 128)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32)[None], (2, 24))
    want, _ = jax.jit(lambda p, h, ps: ref_tf.forward_groups(
        p, ref_cfg, h, ps, 0, 1, include_tail=True))(
            ref_s, jnp.asarray(x), jnp.asarray(pos))
    got, _ = transformer.forward_groups(base_s, cfg, torch.tensor(x),
                                        torch.tensor(pos, dtype=torch.int64),
                                        0, 1, include_tail=True)
    assert len(base_s["layers"]) == 5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_split_lora_partition_counts_pattern_groups():
    """split_lora and split_base cut the flat layer list after L pattern
    groups (L·P layers); join_lora rebuilds the same list, the RG-LRU
    layers' None entries included."""
    _, cfg = fam.cfgs("hybrid", 8)
    base, lora = fam.bridged("hybrid", 8)
    assert transformer.n_groups_of(cfg) == 2
    assert transformer.group_len(cfg) == 3
    c, s = split.split_lora(lora, 3)
    assert len(c["layers"]) == 3 and len(s["layers"]) == 5
    assert [x is None for x in c["layers"]] == [True, True, False]
    joined = split.join_lora(c, s)
    assert len(joined["layers"]) == 8
    for x, y in zip(tree_lib.leaves(joined), tree_lib.leaves(lora)):
        assert x is y
    bc, bs = split.split_base(base, 3)
    assert "final_norm" not in bc and "embed" in bc and "embed" in bs
    assert [id(p) for p in bc["layers"] + bs["layers"]] == \
        [id(p) for p in base["layers"]]
