"""moonshot-v1-16b-a3b (kimi/Moonlight) — MoE, 3B active
[hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (kv=16) vocab=163840; 64 routed experts (d_ff=1408)
top-6 + 2 shared; first layer dense.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    mlp="swiglu",
    tie_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, capacity_factor=1.25),
    first_dense=1,
    dense_ff=11264,
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    mlp="swiglu",
    tie_embeddings=False,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=2, capacity_factor=1.5),
    first_dense=1,
    dense_ff=256,
)
