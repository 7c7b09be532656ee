"""zamba2-2.7b — Mamba2 backbone + shared attention block [arXiv:2411.15242; hf].

54L d_model=2560 d_ff=10240 vocab=32000, ssm_state=64.  One SHARED
attention+MLP block (32H, input = concat([x, x0])) invoked every 6 mamba2
layers with per-invocation LoRA deltas on q/k/v.  O(1) mamba state ->
runs the long_500k shape.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    mlp="geglu",
    tie_embeddings=True,
    ssm=SSMConfig(kind="mamba2", head_dim=64, d_state=64, d_conv=4, expand=2),
    attn_every=6,
    norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    mlp="geglu",
    tie_embeddings=True,
    ssm=SSMConfig(kind="mamba2", head_dim=16, d_state=16, d_conv=4, expand=2),
    attn_every=2,
    norm_eps=1e-5,
)
