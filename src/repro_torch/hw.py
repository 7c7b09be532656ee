"""The card's rates that the port's bounds and peak shares divide by: an
NVIDIA H100 SXM (80 GB HBM3, 700 W), from NVIDIA's H100 Tensor Core GPU
data sheet.  A card set below 700 W runs slower under load; the scripts
print its name and power limit beside every figure."""
import torch

# HBM3 bandwidth, bytes per second
HBM_BYTES_PER_S = 3.35e12
# dense (no sparsity) bf16 tensor-core operations per second
BF16_PEAK = 989e12
# peak operations per second by dtype: float64 and float32 on the
# non-tensor-core units, bf16 on the tensor cores (dense)
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12, torch.bfloat16: BF16_PEAK}
# device memory, bytes: the data sheet's 80 GB (the dry-run's fit check)
HBM_CAPACITY = 80e9
# NVLink between the cards of one node: the data sheet's 900 GB/s is the
# sum over both directions of the card's 18 links, so a card sends (and
# receives) at most 450e9 bytes per second.  A collective's time is its
# operand bytes a rank over this one-direction rate.
NVLINK_BYTES_PER_S = 450e9
# between nodes: one ConnectX-7 NDR adapter of 400 Gb/s per GPU (NVIDIA
# DGX H100 / HGX H100 data sheets), 50e9 bytes per second each way
NETWORK_BYTES_PER_S = 400e9 / 8
# cards of one NVLink node (DGX/HGX H100: 8 SXM cards joined by NVSwitch)
CARDS_PER_NODE = 8

__all__ = ["BF16_PEAK", "CARDS_PER_NODE", "HBM_BYTES_PER_S", "HBM_CAPACITY",
           "NETWORK_BYTES_PER_S", "NVLINK_BYTES_PER_S", "PEAK_FLOPS"]
