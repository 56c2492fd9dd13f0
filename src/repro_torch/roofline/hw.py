"""NVIDIA H100 SXM5 80GB constants, from NVIDIA's H100 Tensor Core GPU
datasheet (dense rates, no sparsity): the card ``nvidia-smi`` names
"NVIDIA H100 80GB HBM3", at its 700 W power limit.  A card set below
700 W runs slower under load than these rates.

Counterpart of ``src/repro/roofline/hw.py`` (TPU v5e constants there).
The compute peak is chosen by dtype: bf16 by default, as the reference's
one peak; ``"3xtf32"`` is what the port's fp32 CUDA kernels run (three
TF32 tensor-core products a product), ``"fp32"`` the SIMT rate.
"""

PEAK_FLOPS_BF16 = 989.4e12      # per GPU, bf16 tensor cores
PEAK_FLOPS_TF32 = 494.7e12      # per GPU, TF32 tensor cores
PEAK_FLOPS_3XTF32 = PEAK_FLOPS_TF32 / 3
PEAK_FLOPS_FP32 = 66.9e12       # per GPU, fp32 SIMT
HBM_BW = 3.35e12                # bytes/s per GPU
HBM_BYTES = 80e9                # HBM3 capacity
NVLINK_BW = 450e9               # bytes/s per direction a GPU, 8-GPU node
NET_BW = 50e9                   # bytes/s a GPU between nodes (400 Gb/s NDR,
                                # one NIC a GPU)

PEAKS = {"bf16": PEAK_FLOPS_BF16, "tf32": PEAK_FLOPS_TF32,
         "3xtf32": PEAK_FLOPS_3XTF32, "fp32": PEAK_FLOPS_FP32}


def compute_time_s(flops: float, chips: int, dtype: str = "bf16") -> float:
    return flops / (chips * PEAKS[dtype])


def memory_time_s(bytes_: float, chips: int) -> float:
    return bytes_ / (chips * HBM_BW)


def collective_time_s(bytes_: float, chips: int) -> float:
    # each axis of the 16 x 16 production mesh spans more than one 8-GPU
    # NVLink node (16 GPUs an axis), so a collective over either axis
    # runs at the inter-node rate
    return bytes_ / (chips * NET_BW)
