"""rwkv6-3b "Finch" — attention-free, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=2560 d_ff=8960 vocab=65536, head_dim=64 (40 heads).  Linear
recurrence with O(1) decode state -> runs the long_500k shape.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # d_model / head_dim (bookkeeping; blocks are attn-free)
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    tie_embeddings=False,
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="rwkv6-3b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    tie_embeddings=False,
    ssm=SSMConfig(kind="rwkv6", head_dim=16),
    norm_eps=1e-5,
)
