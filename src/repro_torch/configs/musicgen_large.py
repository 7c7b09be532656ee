"""musicgen-large — decoder-only LM over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only per task spec: 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048 per codebook, 4 codebooks.  The EnCodec encoder is a STUB —
input_specs() feeds codebook token ids directly; the 4 codebook embeddings
are summed and the head predicts all 4 codebooks per step (the MusicGen
delay pattern is a data-prep transform, not a model change).  Deviation
noted in DESIGN.md: RoPE replaces MusicGen's sinusoidal embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp="gelu",
    tie_embeddings=False,
    frontend="audio",
    num_codebooks=4,
    norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=128,
    mlp="gelu",
    tie_embeddings=False,
    frontend="audio",
    num_codebooks=4,
    norm_eps=1e-5,
)
