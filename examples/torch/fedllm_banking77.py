"""End-to-end driver: the paper's SSV case study on the PyTorch/H100
port — federated LoRA fine-tuning of a GPT-2-family model on
Banking77-style intent classification, 3 clients, with the LoRA-rank
ablation of Fig. 3(a), a few hundred local steps total.

    PYTHONPATH=src python examples/torch/fedllm_banking77.py [--rounds 8] \
        [--device cpu]

Counterpart of examples/fedllm_banking77.py, with its flags and
``--device`` (the card by default).
"""
import argparse

from repro_torch.configs.base import FedConfig
from repro_torch.configs.gpt2_small import gpt2_tiny
from repro_torch.core.rounds import run_federated
from repro_torch.data import banking77, partition


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--scale", type=float, default=0.08,
                    help="fraction of the paper's 10k-sample setup")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--non-iid", action="store_true",
                    help="dirichlet(0.5) label-skew partition")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = gpt2_tiny()
    public, train, test = banking77.paper_splits(
        cfg.vocab_size, pad_len=32, seed=args.seed, scale=args.scale)
    if args.non_iid:
        clients = partition.dirichlet_partition(train, 3, alpha=0.5,
                                                seed=args.seed)
    else:
        clients = partition.iid_partition(train, 3, seed=args.seed)
    print(f"clients: {[len(c['tokens']) for c in clients]} samples, "
          f"test: {len(test['tokens'])}")

    for rank in (2, 4, 8):
        fed = FedConfig(framework="fedllm", n_clients=3,
                        rounds=args.rounds, lora_rank=rank, lr=1e-3,
                        lora_dropout=0.1, seed=args.seed)
        res = run_federated(cfg, fed, public, clients, test,
                            batch_size=16, verbose=False,
                            device=args.device)
        accs = [h.accuracy for h in res.history]
        print(f"rank={rank}: acc {accs[0]:.3f} -> {accs[-1]:.3f}  "
              f"comm/client/round="
              f"{res.ledger.mean_client_bytes_per_round():.2e}B")
    print("\nExpected (paper Fig. 3a/4): higher rank -> higher accuracy "
          "and proportionally higher comm.")


if __name__ == "__main__":
    main()
