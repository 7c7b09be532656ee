"""qwen1.5-32b — dense MHA (kv=40) with QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064.  SwiGLU, untied.
The largest assigned dense arch — the FSDP+TP stress cell.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    mlp="swiglu",
    qkv_bias=True,
    tie_embeddings=False,
    norm_eps=1e-6,
)

SMOKE = ModelConfig(
    name="qwen1.5-32b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab_size=512,
    mlp="swiglu",
    qkv_bias=True,
    tie_embeddings=False,
)
