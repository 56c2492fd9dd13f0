"""The port's client populations and host seed derivations against the
reference's, on the CPU, with no federated run.

- core/rng.fold_chain and host_fold_rng (a numpy Threefry-2x32) against
  the reference's ``jax.random`` key chain, word for word, over seeds
  across the int32 and uint32 ranges and fold values up to 2³² - 1
  (values ≥ 2³¹ included), and the numpy draws of the seeded Generator;
  a fold value outside uint32 raises as the reference's does.
- data/population.DirichletPopulation: each client's shard and each
  ``cohort()`` equal to the reference's array for array, in any
  materialization order; a 100k-client fleet stays lazy (no array with a
  leading axis near the fleet's size).
- data/partition.dirichlet_partition and label_histogram equal to the
  reference's; EagerPopulation holds shards by reference.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import rng as ref_rng  # noqa: E402
from repro.data import banking77 as ref_banking77  # noqa: E402
from repro.data import partition as ref_partition  # noqa: E402
from repro.data import population as ref_population  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core.round_program import RoundContext  # noqa: E402
from repro_torch.data import banking77, partition, population  # noqa: E402

VOCAB = 192


def _base(n=120, seed=3):
    return banking77.generate(n, VOCAB, 12, seed=seed)


def _cases(n):
    r = random.Random(0)
    seeds = [0, 1, 7, 12345, -1, 2 ** 31 - 1, -2 ** 31, 2 ** 31, 2 ** 32 - 1]
    vals = [0, 1, 0x9E37, 99999, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    out = [(s, ()) for s in seeds]
    for _ in range(n):
        out.append((r.choice(seeds + [r.randrange(-2 ** 31, 2 ** 32)]),
                    tuple(r.choice(vals + [r.randrange(2 ** 32)])
                          for _ in range(r.randrange(1, 5)))))
    return out


@pytest.mark.parametrize("seed,vals", _cases(60))
def test_fold_chain_and_host_rng_match_reference(seed, vals):
    want = np.asarray(jax.random.key_data(ref_rng.fold_chain(
        jax.random.PRNGKey(seed), *vals)), dtype=np.uint32)
    assert rng.fold_chain(seed, *vals) == tuple(int(w) for w in want)
    np.testing.assert_array_equal(rng.host_fold_rng(seed, *vals).random(4),
                                  ref_rng.host_fold_rng(seed, *vals)
                                  .random(4))


def test_fold_value_outside_uint32_raises_as_the_reference():
    for v in (-1, 2 ** 32):
        with pytest.raises(OverflowError):
            jax.random.fold_in(jax.random.PRNGKey(0), v)
        with pytest.raises(OverflowError):
            rng.fold_chain(0, v)


def test_threefry2x32_known_answer():
    """The Threefry-2x32 known-answer vector of Salmon et al. (SC'11):
    key and counts all ones."""
    assert rng.threefry2x32((0xFFFFFFFF, 0xFFFFFFFF),
                            (0xFFFFFFFF, 0xFFFFFFFF)) == \
        (0x1CB996FC, 0xBB002BE7)


@pytest.mark.parametrize("alpha,seed,n,shard", [(0.5, 0, 12, 16),
                                                (0.3, 11, 50, None),
                                                (5.0, 7, 9, 33)])
def test_dirichlet_population_shards_are_the_references(alpha, seed, n,
                                                        shard):
    base = _base()
    got = population.DirichletPopulation(base, n, alpha=alpha, seed=seed,
                                         shard_size=shard)
    want = ref_population.DirichletPopulation(base, n, alpha=alpha,
                                              seed=seed, shard_size=shard)
    assert len(got) == len(want) == n
    assert got.data_weights() == want.data_weights()
    # built in reverse order: no shard depends on another
    for ci in reversed(range(n)):
        g, w = got.client(ci), want.client(ci)
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    for idx in range(got.n_cohorts(4)):
        gc, wc = got.cohort(1, idx, 4), want.cohort(1, idx, 4)
        assert (gc.round, gc.index, gc.clients) == \
            (wc.round, wc.index, wc.clients)
        for g, w in zip(gc.data, wc.data):
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


def test_dirichlet_population_of_unlabeled_data_is_the_references():
    base = {"tokens": _base()["tokens"]}
    got = population.DirichletPopulation(base, 5, seed=2, shard_size=7)
    want = ref_population.DirichletPopulation(base, 5, seed=2, shard_size=7)
    for ci in range(5):
        np.testing.assert_array_equal(got[ci]["tokens"], want[ci]["tokens"])


def test_dirichlet_population_100k_is_lazy():
    """A 100k-client fleet costs O(base data): no array in the population
    with a leading axis near the fleet's size, and a cohort builds only
    its clients; the ragged last cohort and the bounds as the
    reference's."""
    pop = population.DirichletPopulation(_base(), 100_000, alpha=0.5, seed=7,
                                         shard_size=8)
    assert len(pop) == 100_000 and pop.n_cohorts(64) == 1563
    for v in list(pop.__dict__.values()) + pop._pools:
        if isinstance(v, np.ndarray):
            assert v.shape[0] < 100_000
        if isinstance(v, (list, tuple)):
            assert len(v) < 100_000
    built = []
    real = pop.client

    def spy(ci):
        built.append(ci)
        return real(ci)

    pop.client = spy
    last = pop.cohort(0, 1562, 64)
    assert last.clients[0] == 1562 * 64 and len(last) == 100_000 - 1562 * 64
    assert built == last.clients
    want = ref_population.DirichletPopulation(_base(), 100_000, alpha=0.5,
                                              seed=7, shard_size=8)
    np.testing.assert_array_equal(last.data[5]["tokens"],
                                  want.client(last.clients[5])["tokens"])
    with pytest.raises(IndexError):
        pop.cohort(0, 1563, 64)
    with pytest.raises(IndexError):
        pop[100_000]
    assert pop.data_weights() == [8] * 100_000


def test_round_context_reads_weights_without_building_shards():
    """The round engine's data weights and accountant rate come from
    ``data_weights()``: no shard is built to set up a run."""
    from repro_torch.configs.base import FedConfig, PrivacyConfig
    from repro_torch.configs.gpt2_small import gpt2_tiny
    from repro_torch.models.factory import build_model

    pop = population.DirichletPopulation(_base(), 1000, shard_size=32)
    pop.client = lambda ci: pytest.fail(f"client {ci} built")
    cfg = gpt2_tiny()
    fed = FedConfig(privacy=PrivacyConfig(dp_clip=1.0, dp_noise_multiplier=1.0))
    ctx = RoundContext(build_model(cfg), None, cfg, fed, (), None, pop, None,
                       "classification", 8, 16, False, "cpu")
    assert ctx.n_clients == 1000 and ctx.total_w == 32000.0
    assert ctx.acct.sample_rate == 8 / 32


def test_dirichlet_partition_and_label_histogram_are_the_references():
    base = _base()
    got = partition.dirichlet_partition(base, 6, alpha=0.5, seed=5)
    want = ref_partition.dirichlet_partition(base, 6, alpha=0.5, seed=5)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(partition.label_histogram(g),
                                      ref_partition.label_histogram(w))
    np.testing.assert_array_equal(
        partition.label_histogram(base, n_classes=80),
        ref_partition.label_histogram(base, n_classes=80))


def test_generated_data_is_the_references():
    """The base data the populations draw from is the reference's."""
    got, want = _base(), ref_banking77.generate(120, VOCAB, 12, seed=3)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_eager_population_wraps_by_reference():
    clients = partition.iid_partition(_base(), 4)
    pop = population.ClientPopulation.from_clients_data(clients)
    assert isinstance(pop, population.EagerPopulation)
    assert len(pop) == 4 and pop[2] is clients[2]
    assert pop.data_weights() == [len(d["tokens"]) for d in clients]
    assert population.as_population(pop) is pop
    assert population.as_population(clients)[1] is clients[1]
    assert pop.cohort(0, 0).clients == [0, 1, 2, 3]
    with pytest.raises(IndexError):
        pop[-1]
    with pytest.raises(ValueError):
        population.DirichletPopulation(_base(), 0)
