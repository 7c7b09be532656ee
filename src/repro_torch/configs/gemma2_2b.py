"""gemma2-2b — local/global alternating attention + logit softcaps
[arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, head_dim=256.
GeGLU, sandwich (post) norms, embeddings scaled by sqrt(d), attention
softcap 50, final logit softcap 30, query scale 1/sqrt(256), local window
4096 on alternating layers.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    mlp="geglu",
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=256.0 ** -0.5,
    local_window=4096,
    layer_pattern="local_global",
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    mlp="geglu",
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=32.0 ** -0.5,
    local_window=16,
    layer_pattern="local_global",
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
)
