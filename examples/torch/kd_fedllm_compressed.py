"""KD-FedLLM scenario on the PyTorch/H100 port: logit-based knowledge
sharing, then the paper's SSIV.B research directions as working
features — top-k logit compression and public-dataset alignment under
non-IID clients.

    PYTHONPATH=src python examples/torch/kd_fedllm_compressed.py \
        [--device cpu]

Counterpart of examples/kd_fedllm_compressed.py; the card by default.
"""
import argparse

from repro_torch.configs.base import FedConfig
from repro_torch.configs.gpt2_small import gpt2_tiny
from repro_torch.core import kd
from repro_torch.core.rounds import run_federated
from repro_torch.data import banking77, partition


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = gpt2_tiny()
    public, train, test = banking77.paper_splits(cfg.vocab_size,
                                                 pad_len=24, scale=0.06)
    clients = partition.dirichlet_partition(train, 3, alpha=0.5, seed=0)

    # baseline KD (dense logits)
    fed = FedConfig(framework="kd", n_clients=3, rounds=3, lora_rank=4,
                    kd_epochs=1, seed=0)
    base = run_federated(cfg, fed, public, clients, test, batch_size=16,
                         device=args.device)
    base_bytes = base.ledger.by_name()["logits"]
    print(f"dense-logit KD:  acc={base.final_accuracy:.3f} "
          f"logit_bytes={base_bytes:.2e}")

    # SSIV.B.2: top-k logit compression
    fed_tk = FedConfig(framework="kd", n_clients=3, rounds=3, lora_rank=4,
                       kd_epochs=1, logit_topk=8, seed=0)
    topk = run_federated(cfg, fed_tk, public, clients, test, batch_size=16,
                         device=args.device)
    tk_bytes = topk.ledger.by_name()["logits"]
    print(f"top-8 KD:        acc={topk.final_accuracy:.3f} "
          f"logit_bytes={tk_bytes:.2e} "
          f"({base_bytes/tk_bytes:.1f}x smaller wire)")

    # SSIV.B.1: public-dataset alignment from client label histograms
    hists = [partition.label_histogram(c) for c in clients]
    aligned_pub = kd.align_public_dataset(public, hists,
                                          len(public["tokens"]), seed=1)
    al = run_federated(cfg, fed, aligned_pub, clients, test, batch_size=16,
                       device=args.device)
    print(f"aligned-PD KD:   acc={al.final_accuracy:.3f} "
          f"(public set resampled toward client label mix)")


if __name__ == "__main__":
    main()
