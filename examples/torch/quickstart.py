"""Quickstart: the paper's three federated fine-tuning frameworks in ~40
lines against one shared substrate, on the PyTorch/H100 port.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Counterpart of examples/quickstart.py; it runs on the card unless
``--device`` names another device.
"""
import argparse

from repro_torch.configs.base import FedConfig
from repro_torch.configs.gpt2_small import gpt2_tiny
from repro_torch.core.rounds import run_federated
from repro_torch.data import banking77, partition


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. The case-study setup (paper SSV, reduced): GPT-2-family model,
    #    Banking77-style intent classification, 3 clients, public set for
    #    KD.
    cfg = gpt2_tiny()
    public, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                                 scale=0.04)
    clients = partition.iid_partition(train, n_clients=3)

    # 2. Run each framework; everything (accuracy, per-client
    #    communication bytes, client-side FLOPs) is measured by the engine.
    for framework in ("fedllm", "kd", "split"):
        fed = FedConfig(framework=framework, n_clients=3, rounds=2,
                        lora_rank=4, split_layer=2, kd_epochs=1, seed=0)
        res = run_federated(cfg, fed, public, clients, test, batch_size=16,
                            device=args.device)
        last = res.history[-1]
        print(f"{framework:7s} acc={last.accuracy:.3f} "
              f"comm/client/round={last.comm_bytes_per_client:.2e}B "
              f"client_flops={last.client_flops:.2e}")

    print("\nPaper Table I orderings should be visible above: "
          "split=highest comm, kd=highest compute.")


if __name__ == "__main__":
    main()
