"""starcoder2-3b — dense GQA code LM [arXiv:2402.19173; hf].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.  Non-gated GELU MLP
(pre-SwiGLU lineage), full RoPE, sliding-window-free, learned bias on QKV.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    mlp="gelu",
    qkv_bias=True,
    rope_theta=100000.0,
    tie_embeddings=True,
    norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="starcoder2-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    mlp="gelu",
    qkv_bias=True,
    tie_embeddings=True,
    norm_eps=1e-5,
)
