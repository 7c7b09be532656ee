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

__all__ = ["BF16_PEAK", "HBM_BYTES_PER_S", "PEAK_FLOPS"]
