"""Model configuration covering all 10 assigned architectures.

A plain copy of the reference's ``repro.models.config`` (pure-Python
dataclasses); the tests hold both equal field by field.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64
    top_k: int = 6
    n_shared: int = 2              # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "rwkv6"            # 'rwkv6' | 'mamba2'
    head_dim: int = 64
    d_state: int = 64              # mamba2 state per head
    d_conv: int = 4                # mamba2 depthwise conv width
    expand: int = 2                # mamba2 inner expansion
    chunk: int = 64                # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # 'dense' | 'moe' | 'ssm' | 'hybrid'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    mlp: str = "swiglu"            # 'swiglu' | 'geglu' | 'gelu'
    qkv_bias: bool = False
    rope_fraction: float = 1.0     # chatglm3 "2d" rope = 0.5
    rope_theta: float = 10000.0
    attn_softcap: float | None = None
    final_softcap: float | None = None
    query_scale: float | None = None   # gemma2: 1/sqrt(query_pre_attn_scalar)
    local_window: int | None = None
    layer_pattern: str = "global"  # 'global' | 'local_global'
    post_norms: bool = False       # gemma2 extra post-sublayer norms
    embed_scale: bool = False      # gemma multiplies embeddings by sqrt(d)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # MoE
    moe: MoEConfig | None = None
    first_dense: int = 0
    dense_ff: int | None = None
    # SSM / hybrid
    ssm: SSMConfig | None = None
    attn_every: int = 6            # zamba2: shared attn block period
    # modality frontends (STUBS: input_specs feeds precomputed embeddings)
    frontend: str | None = None    # 'vision' | 'audio'
    num_codebooks: int = 1         # musicgen EnCodec codebooks
    prefix_tokens: int = 256       # paligemma image patch tokens
    # numerics
    dtype: str = "bfloat16"        # activation compute dtype
    param_dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter counts — for MODEL_FLOPS = 6*N*D."""
        d, v = self.d_model, self.vocab_size
        embed = v * d
        total = embed if self.tie_embeddings else 2 * embed
        active = total
        per_layer_attn = d * self.n_heads * self.hd + d * 2 * self.n_kv_heads * self.hd \
            + self.n_heads * self.hd * d
        gate_mult = 3 if self.mlp in ("swiglu", "geglu") else 2

        def ffn(dff):
            return gate_mult * d * dff

        for i in range(self.n_layers):
            if self.family == "ssm":  # rwkv6: time-mix ~ 4 d^2, channel-mix
                lp = 4 * d * d + int(3.5 * d * d)
                total += lp
                active += lp
                continue
            if self.family == "hybrid":  # mamba2 blocks (+ shared attn once)
                exp = self.ssm.expand if self.ssm else 2
                lp = 2 * d * exp * d + exp * d * d
                total += lp
                active += lp
                continue
            total += per_layer_attn
            active += per_layer_attn
            if self.moe is not None and i >= self.first_dense:
                e = ffn(self.d_ff)
                total += self.moe.n_experts * e + self.moe.n_shared * e
                active += (self.moe.top_k + self.moe.n_shared) * e
                total += d * self.moe.n_experts  # router
                active += d * self.moe.n_experts
            else:
                dff = self.dense_ff or self.d_ff
                total += ffn(dff)
                active += ffn(dff)
        if self.family == "hybrid":  # one shared attention block
            shared = per_layer_attn + ffn(self.d_ff)
            total += shared
            active += shared * (self.n_layers // self.attn_every)
        return total, active
