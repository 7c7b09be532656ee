"""chatglm3-6b — dense GQA with 2d (half-dim) RoPE [arXiv:2406.12793; hf].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.  SwiGLU, QKV bias,
rotary applied to half the head dim ("2d RoPE"), untied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    mlp="swiglu",
    qkv_bias=True,
    rope_fraction=0.5,
    tie_embeddings=False,
    norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="chatglm3-6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    mlp="swiglu",
    qkv_bias=True,
    rope_fraction=0.5,
    tie_embeddings=False,
    norm_eps=1e-5,
)
