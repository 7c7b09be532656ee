"""The vlm (paligemma-3b) and audio (musicgen-large) families across ranks
on the CPU: tensor and sequence parallelism over "model"
(``repro_torch.dist.tp``) with every rank of a (data D, model M) mesh in
one process (``LocalComm``), held in float32 to the unsharded port and to
``jax.value_and_grad`` of the reference (``tests/_tp_parity.py``): logits,
loss and every gradient within 1e-5, prefill and decode logits within
1e-5 of the unsharded port with caches placed as ``cache_specs`` says.

* paligemma at 1 x 2, 2 x 2 and 1 x 4: its one KV head of 16 columns is
  cut over the ranks (gathered, as starcoder2's two heads at M = 4), its
  query heads split, the bidirectional prefix over the ranks' 8
  ``prefix_embeds`` positions (the global batch's, cut by rows).
* musicgen at M = 2, 4 (the smoke's 4 heads; 2 x 2 too) and 8 (the smoke
  with 8 heads of 8): its (K, V, D) tables split on V, its head's K V
  codebook-major columns split so that a rank holds two codebooks, one,
  or half of one; each codebook's maximum and log-sum-exp reduce over the
  ranks holding its columns.
* The two faults the families had across ranks, pinned: a vlm's prefix
  was added to every rank's partial lookup before the sum over "model"
  (M times the prefix), and an audio id past V/M indexed outside the
  rank's rows of a split table.
"""
import pytest
import torch

import _tp_parity as T
from repro_torch.configs import get_smoke
from repro_torch.dist import tp
from repro_torch.dist.comm import LocalComm
from repro_torch.models.model import CausalLM, embed_ranks

MESHES = ((1, 2), (2, 2), (1, 4))
IDS = [f"{d}x{m}" for d, m in MESHES]
S = 32
# musicgen at M = 8: the smoke config with 8 query heads (hd 8)
HEADS8 = (("n_heads", 8), ("n_kv_heads", 8))
AUDIO = [((1, 2), ()), ((2, 2), ()), ((1, 4), ()), ((1, 8), HEADS8)]
AUDIO_IDS = ["1x2", "2x2", "1x4", "1x8"]


@pytest.mark.parametrize("mesh", MESHES + ((1, 8),), ids=IDS + ["1x8"])
@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large"])
def test_local_parameter_shapes_are_the_spec_shards(arch, mesh):
    assert T.check_local_shapes(arch, mesh) > 0


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_vlm_logits_loss_and_grads_match_unsharded_and_reference(mesh, monkeypatch):
    T.check_train("paligemma-3b", mesh, S, monkeypatch)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_vlm_prefill_and_decode_match_unsharded(mesh):
    T.check_serving("paligemma-3b", mesh)


@pytest.mark.parametrize("mesh,change", AUDIO, ids=AUDIO_IDS)
def test_audio_logits_loss_and_grads_match_unsharded_and_reference(mesh, change,
                                                                   monkeypatch):
    ranks = T.check_train("musicgen-large", mesh, S, monkeypatch, change)
    k, v, m = ranks[0].cfg.num_codebooks, ranks[0].cfg.vocab_size, mesh[1]
    blocks = [r._codebook_block() for r in ranks[:m]]
    per = k * v // m
    assert blocks == [(i * per // v, i * per % v) for i in range(m)]


@pytest.mark.parametrize("mesh,change", AUDIO, ids=AUDIO_IDS)
def test_audio_prefill_and_decode_match_unsharded(mesh, change):
    T.check_serving("musicgen-large", mesh, change=change)


def test_prefix_enters_the_vocab_parallel_sum_once():
    """paligemma's embedding over M = 2 and 4 ranks with the table split:
    the prefix positions of the joined stream are the prefix itself (times
    gemma's sqrt(d) scale), bit for bit the unsharded embedding."""
    cfg = T.f32(get_smoke("paligemma-3b"))
    one = CausalLM(cfg, device="cpu", seed=0).requires_grad_(False)
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    prefix = torch.randn(2, cfg.prefix_tokens, cfg.d_model, generator=gen)
    want = embed_ranks([one], [toks], False, [prefix])[0]
    for m in (2, 4):
        comm = LocalComm(1, m)
        ranks = tp.split_ranks(one, comm)
        assert "embed" in ranks[0].tp_split
        for sp in (True, False):
            xs = embed_ranks(ranks, [toks] * m, sp, [prefix] * m)
            got = torch.cat(xs, 1) if sp else xs[0]
            assert torch.equal(got, want), (m, sp)


def test_audio_ids_past_a_ranks_rows():
    """musicgen's (K, V, D) tables split on V over M = 4: every id of every
    codebook, those past V/M included, looks up its row on the rank that
    holds it and zeros elsewhere; the lookups summed over the ranks are the
    unsharded lookup."""
    cfg = T.f32(get_smoke("musicgen-large"))
    one = CausalLM(cfg, device="cpu", seed=0).requires_grad_(False)
    v, k = cfg.vocab_size, cfg.num_codebooks
    toks = torch.stack([torch.arange(v).roll(kb * 37) for kb in range(k)], -1)[None]
    ranks = tp.split_ranks(one, LocalComm(1, 4))
    assert ranks[0].embed.shape == (k, v // 4, cfg.d_model)
    parts = [r._lookup(toks) for r in ranks]
    torch.testing.assert_close(sum(parts), one._lookup(toks), rtol=0, atol=1e-6)
    rows = v // 4
    for m, part in enumerate(parts):
        want = sum(one.embed[kb][toks[..., kb]] * (toks[..., kb] // rows == m)[..., None]
                   for kb in range(k))
        torch.testing.assert_close(part, want, rtol=0, atol=1e-6)
