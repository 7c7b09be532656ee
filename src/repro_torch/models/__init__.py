"""The LM stack of the dense global family: config, layers, MLP,
attention (prefill on kernel K3), decoder stack and ``CausalLM``."""
