"""deepseek-moe-16b — fine-grained MoE [arXiv:2401.06066; hf].

28L d_model=2048 16H (kv=16) vocab=102400; 64 routed experts (d_ff=1408)
top-6 + 2 shared experts; layer 0 is a dense FFN (d_ff=10944).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    mlp="swiglu",
    tie_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, capacity_factor=1.25),
    first_dense=1,
    dense_ff=10944,
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    mlp="swiglu",
    tie_embeddings=False,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, capacity_factor=1.5),
    first_dense=1,
    dense_ff=256,
)
