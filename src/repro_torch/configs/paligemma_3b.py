"""paligemma-3b — SigLIP + gemma VLM [arXiv:2407.07726; hf].

Backbone only per task spec: 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216, head_dim=256.  The SigLIP vision tower is a STUB —
input_specs() feeds 256 precomputed patch embeddings per image; the prefix
(image + prompt) attends bidirectionally (prefix-LM mask).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
    frontend="vision",
    prefix_tokens=256,
)

SMOKE = ModelConfig(
    name="paligemma-3b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    head_dim=16,
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
    frontend="vision",
    prefix_tokens=8,
)
