"""Million-client rounds on the PyTorch/H100 port: cohort streaming over
a lazy ClientPopulation (paper SSVI cross-device directions).

Two parts:

1. A *laziness demo*: build a 100k-virtual-client DirichletPopulation
   over a small base dataset and materialize exactly one cohort —
   showing the fleet costs O(base data) resident memory and cohort
   materialization is O(cohort), bit-stable in any order.
2. A *training run* at tractable scale: the same population API driven
   through ``FedConfig(backend="cohort")``, streaming each round
   ``cohort_size`` clients at a time, optionally with hierarchical
   (client->edge->server) aggregation accounting via ``--n-edges``.

    PYTHONPATH=src python examples/torch/million_client_cohorts.py
    PYTHONPATH=src python examples/torch/million_client_cohorts.py \
        --n-virtual 2000 --cohort-size 128 --n-edges 4 [--device cpu]

Counterpart of examples/million_client_cohorts.py, with its flags and
``--device`` (the card by default).
"""
import argparse

import numpy as np

from repro_torch.configs.base import FedConfig
from repro_torch.configs.gpt2_small import gpt2_tiny
from repro_torch.core import metrics as M
from repro_torch.core.rounds import run_federated
from repro_torch.data import banking77
from repro_torch.data.population import DirichletPopulation


def laziness_demo(base, n_virtual: int, cohort_size: int, alpha: float):
    pop = DirichletPopulation(base, n_virtual, alpha=alpha, seed=7,
                              shard_size=16)
    resident = sum(a.nbytes for a in pop.__dict__.values()
                   if isinstance(a, np.ndarray))
    resident += sum(a.nbytes for a in pop.base.values())
    print(f"population: {len(pop):,} virtual clients over "
          f"{len(base['tokens'])} base samples "
          f"({resident / 2**20:.2f} MiB resident, "
          f"{pop.n_cohorts(cohort_size):,} cohorts of {cohort_size})")
    cohort = pop.cohort(0, pop.n_cohorts(cohort_size) // 2, cohort_size)
    shard_bytes = sum(a.nbytes for d in cohort.data for a in d.values())
    print(f"materialized cohort {cohort.index}: clients "
          f"{cohort.clients[0]:,}..{cohort.clients[-1]:,} "
          f"({shard_bytes / 2**20:.2f} MiB — the streaming peak)")
    # bit-stable: revisiting a client reproduces its shard exactly
    again = pop.client(cohort.clients[3])
    assert np.array_equal(cohort.data[3]["tokens"], again["tokens"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-virtual", type=int, default=512,
                    help="virtual fleet size for the training run")
    ap.add_argument("--lazy-demo-virtual", type=int, default=100_000,
                    help="fleet size for the no-training laziness demo")
    ap.add_argument("--cohort-size", type=int, default=64)
    ap.add_argument("--n-edges", type=int, default=0,
                    help="edge aggregators for hierarchical accounting "
                         "(0 = flat)")
    ap.add_argument("--alpha", type=float, default=0.5,
                    help="Dirichlet non-IID concentration")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--framework", default="fedllm",
                    choices=["fedllm", "kd", "split"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = gpt2_tiny()
    public, train, test = banking77.paper_splits(cfg.vocab_size,
                                                 pad_len=24, scale=0.04,
                                                 seed=args.seed)

    print("== laziness demo (no training) ==")
    laziness_demo(train, args.lazy_demo_virtual, args.cohort_size,
                  args.alpha)

    print(f"\n== cohort-streaming round(s): {args.n_virtual} virtual "
          f"clients, {args.cohort_size}/cohort ==")
    pop = DirichletPopulation(train, args.n_virtual, alpha=args.alpha,
                              seed=args.seed, shard_size=16)
    fed = FedConfig(framework=args.framework, backend="cohort",
                    n_clients=args.n_virtual, rounds=args.rounds,
                    cohort_size=args.cohort_size,
                    n_virtual_clients=args.n_virtual,
                    n_edges=args.n_edges, lora_rank=4, lora_dropout=0.0,
                    split_layer=2, kd_epochs=1, seed=args.seed)
    result = run_federated(cfg, fed, public, pop, test, batch_size=8,
                           eval_batch=32, verbose=True, device=args.device)
    print(f"final accuracy: {result.final_accuracy:.4f}")
    by_hop = result.ledger.by_hop()
    for hop in (M.CLIENT_SERVER, M.CLIENT_EDGE, M.EDGE_SERVER):
        if hop in by_hop:
            print(f"  {hop:>13}: {by_hop[hop] / 2**20:.2f} MiB")
    print(f"  per-client/round: "
          f"{result.history[-1].comm_bytes_per_client / 2**10:.1f} KiB")


if __name__ == "__main__":
    main()
