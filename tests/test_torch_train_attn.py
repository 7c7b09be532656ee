"""Training of the attention families beyond the dense global stack, on
the CPU against the JAX package: gemma2-2b (local/global pairs, a window
of 16 keys at the smoke size, post-norms, softcaps), paligemma-3b (the
prefix-LM mask over 8 ``prefix_embeds`` positions, which the loss skips),
chatglm3-6b (partial RoPE, qkv bias) and qwen1.5-32b (qkv bias).

Parameters come from the JAX ``CausalLM.init``, carried across with
``repro_torch.convert``; models compute in float32.  Tolerances
(``_train_parity``): loss and every gradient 1e-5 relative (to the leaf's
largest gradient); three train steps with losses and grad norms to 1e-5
and parameters to 1e-4.  chatglm3-6b's three free-running steps leave
``layers.0.attn.wo`` 1.9e-4 from the reference's at B 4, S 16 (its
gradients match to 8.3e-7 at B 2, S 32): AdamW's eps amplification, so its steps are
re-seated from the reference's state before each one and hold every
gradient and metric to 1e-5.
"""
import pytest

from _train_parity import check_loss_and_grads, check_three_steps

ARCHS = ("gemma2-2b", "paligemma-3b", "chatglm3-6b", "qwen1.5-32b")
RESEAT = ("chatglm3-6b",)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    """S 32 over 4 loss chunks: past gemma2's smoke window (16), and for
    paligemma 32 text positions after its 8-position prefix."""
    check_loss_and_grads(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    check_three_steps(arch, reseat=arch in RESEAT)
