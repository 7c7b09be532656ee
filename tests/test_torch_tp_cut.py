"""Query heads that the "model" axis does not divide, placed as the
reference's rules place them (``models.attention.cut_heads``): ``wq``'s
column shard cuts a head, so the q projection is gathered over "model",
every rank attends with every head, and each rank takes its own columns of
the output before ``wo``'s row shard.  The production mesh's M = 16 cuts
starcoder2-3b's 24 heads, qwen1.5-32b's 40 and gemma2-2b's and
paligemma-3b's 8; here the smoke configs' 4 heads over M = 8 (half a head
a rank), with every rank in one process (``LocalComm``), held in float32
to the unsharded port and to ``jax.value_and_grad`` of the reference
(``tests/_tp_parity.py``): logits, loss and every gradient within 1e-5,
prefill and decode logits within 1e-5 and the same greedy tokens.
"""
import pytest

import _tp_parity as T
from repro_torch.configs import get_config, get_smoke
from repro_torch.dist import tp
from repro_torch.models.attention import cut_heads
from repro_torch.models.transformer import attn_cfg_for

# qwen1.5 with its QKV bias, gemma2 with its local/global pairs and
# softcap, paligemma with its prefix; 2 x 8 puts two data rows beside it
CASES = (("starcoder2-3b", (1, 8)), ("qwen1.5-32b", (1, 8)), ("gemma2-2b", (1, 8)),
         ("paligemma-3b", (2, 8)))
IDS = [f"{a}-{d}x{m}" for a, (d, m) in CASES]


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_cut_heads_match_unsharded_and_reference(arch, mesh, monkeypatch):
    assert cut_heads(attn_cfg_for(get_smoke(arch), None), mesh[1])
    T.check_train(arch, mesh, 32, monkeypatch)
    T.check_serving(arch, mesh)


@pytest.mark.parametrize("arch", ("starcoder2-3b", "qwen1.5-32b", "gemma2-2b",
                                  "paligemma-3b"))
def test_production_model_axis_places_every_dense_config(arch):
    """``check_tp`` took these four on M = 16 no longer before this
    placement; their leaves are the spec's shards."""
    tp.check_tp(get_config(arch), 16)
    assert T.check_local_shapes(arch, (1, 16)) > 0


def test_check_tp_still_refuses_what_cannot_split():
    cfg = get_smoke("deepseek-moe-16b")
    with pytest.raises(NotImplementedError, match="query heads"):
        tp.check_tp(cfg, 8)
