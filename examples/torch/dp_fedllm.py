"""Differentially-private federated LoRA fine-tuning on the PyTorch/H100
port: the epsilon-vs-accuracy trade-off (paper SSVI research direction,
PrivacyConfig).

Sweeps the Gaussian noise multiplier over the paper's SSV case study
(Banking77-style intent classification, 3 clients) with per-example
DP-SGD clipping and simulated secure aggregation on, and prints the
(eps, delta) the RDP accountant reports next to final accuracy and the
wire overhead the privacy machinery costs.

    PYTHONPATH=src python examples/torch/dp_fedllm.py [--rounds 8] \
        [--device cpu]

Counterpart of examples/dp_fedllm.py, with its flags and ``--device``
(the card by default).
"""
import argparse
import dataclasses

from repro_torch.configs.base import FedConfig, PrivacyConfig
from repro_torch.configs.gpt2_small import gpt2_tiny
from repro_torch.core.rounds import run_federated
from repro_torch.data import banking77, partition
from repro_torch.privacy.accountant import GaussianAccountant


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--scale", type=float, default=0.08,
                    help="fraction of the paper's 10k-sample setup")
    ap.add_argument("--clip", type=float, default=1.0,
                    help="per-example L2 clip C")
    ap.add_argument("--delta", type=float, default=1e-5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="sequential",
                    choices=["sequential", "spmd"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = gpt2_tiny()
    public, train, test = banking77.paper_splits(
        cfg.vocab_size, pad_len=32, seed=args.seed, scale=args.scale)
    clients = partition.iid_partition(train, 3, seed=args.seed)
    print(f"clients: {[len(c['tokens']) for c in clients]} samples, "
          f"test: {len(test['tokens'])}")

    fed0 = FedConfig(framework="fedllm", backend=args.backend, n_clients=3,
                     rounds=args.rounds, lora_rank=4, lr=1e-3,
                     lora_dropout=0.0, seed=args.seed)
    print(f"{'sigma':>6} {'epsilon':>9} {'accuracy':>9} "
          f"{'privacy-overhead B/client/round':>32}")
    for sigma in (0.0, 0.3, 0.6, 1.2, 2.4):
        priv = PrivacyConfig(dp_clip=args.clip if sigma else 0.0,
                             dp_noise_multiplier=sigma,
                             dp_delta=args.delta, secure_agg=True)
        fed = dataclasses.replace(fed0, privacy=priv)
        res = run_federated(cfg, fed, public, clients, test,
                            batch_size=16, eval_batch=64, device=args.device)
        eps = res.history[-1].epsilon
        if sigma:
            # pin the engine-reported epsilon to the subsampled-Gaussian
            # accountant at the run's actual sampling rate q = B/|data|
            q = max(min(1.0, 16 / len(c["tokens"])) for c in clients)
            want = GaussianAccountant(sigma, args.delta,
                                      sample_rate=q).epsilon(args.rounds)
            assert eps == want, (eps, want)
        overhead = res.ledger.privacy_overhead_bytes() \
            / (fed.rounds * fed.n_clients)
        print(f"{sigma:6.1f} {eps if eps else float('inf'):9.2f} "
              f"{res.final_accuracy:9.3f} {overhead:32.1f}")
    print("\nExpected: accuracy degrades as sigma grows (epsilon "
          "shrinks, amplified by the q = batch/|data| subsampling rate "
          "the engines report); the secure-agg/DP wire overhead is "
          "constant and tiny next to the adapter payload (Fig. 4 "
          "column).")


if __name__ == "__main__":
    main()
