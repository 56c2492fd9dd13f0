"""Split-FedLLM scenario on the PyTorch/H100 port: activation-based
updates with the paper's SSIV.C directions — int8 activation/gradient
transfer and resource-aware dynamic split-point selection.

    PYTHONPATH=src python examples/torch/split_fedllm_quantized.py \
        [--device cpu]

Counterpart of examples/split_fedllm_quantized.py; the card by default.
"""
import argparse

from repro_torch.configs.base import FedConfig
from repro_torch.configs.gpt2_small import gpt2_tiny
from repro_torch.core.rounds import run_federated
from repro_torch.core.split import choose_split_point
from repro_torch.data import banking77, partition


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = gpt2_tiny()
    public, train, test = banking77.paper_splits(cfg.vocab_size,
                                                 pad_len=24, scale=0.06)
    clients = partition.iid_partition(train, 3)

    # SSIV.C.1: pick the split point from a client FLOPs budget
    n_tok_round = len(clients[0]["tokens"]) * 24
    for budget in (1e10, 1e13):
        L = choose_split_point(cfg, budget, n_tok_round)
        print(f"client budget {budget:.0e} FLOPs/round -> split at "
              f"layer {L}/{cfg.n_layers}")

    # fp32 vs int8 activation transfer (SSIV.C.2)
    for bits, tag in ((0, "fp32 wire"), (8, "int8 wire")):
        fed = FedConfig(framework="split", n_clients=3, rounds=3,
                        lora_rank=4, split_layer=2,
                        activation_quant_bits=bits, seed=0)
        res = run_federated(cfg, fed, public, clients, test, batch_size=16,
                            device=args.device)
        acts = res.ledger.by_name()["activations"]
        print(f"{tag}: acc={res.final_accuracy:.3f} "
              f"activation_bytes={acts:.2e} "
              f"comm/client/round="
              f"{res.ledger.mean_client_bytes_per_round():.2e}B")
    print("\nExpected: int8 cuts the dominant activation wire ~4x with "
          "minimal accuracy change (paper SSIV.C.2).")


if __name__ == "__main__":
    main()
