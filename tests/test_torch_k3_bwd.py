"""K3's backward on the CPU: its row statistics and widths against the JAX package, and the arithmetic of its kernels emulated in torch.

* The plain version's lse (``flash_attention_ref(..., return_lse=True)``,
  what K3's forward writes for the backward) against ``m + log(l_safe)``
  of the reference's ``_flash_scan_fwd`` on pre-scaled q, float32: 1e-5
  (relative, and absolute below 1), at G = 1, 2, 4 with a window, a prefix
  and a softcap, S not a multiple of the scan's block.
* ``flash_attention_bwd_ref`` against ``jax.vjp`` of the reference's
  ``_attend_blockwise`` at hd 80 (zamba2's shared block) and 256 (gemma2,
  paligemma), float32: 1e-5 absolute on gradients of order 1, both with
  the forward's lse and with the dense softmax.
* ``FlashAttention`` (forward with lse saved, backward from it) against
  the plain gradients without lse, float64: 1e-12.
* The backward kernels' arithmetic (``csrc/flash_attn_bwd.cu``) written
  out in torch: p = exp2 of the float32 logits in log2 units less the
  forward's lse, p and dS rounded to bfloat16 before the products that read
  them, dK and dV summed over 64-query tiles in order per query head, then
  over the group in head order (the Hopper kernels, bf16 at hd
  64/80/128/256), dQ summed over 64-key tiles in order, each output
  rounded to bfloat16 once.  Held element by element within
  ``kernels.flash.error_bound_bwd`` of the plain version on float64
  copies, at hd 64/80/128/256 for causal, window,
  prefix and softcap cases at S <= 300; controls (a key tile left out of
  dQ, a query head left out of dK) must fall outside it.  Like
  ``tests/test_torch_k3_rounding.py``, this checks the width of the bound
  and the design's order of sums, not the CUDA code: the card tests
  (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` hold the kernels to
  the same bound.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
from repro_torch.kernels import flash as k3

LOG2E = 1.4426950408889634
TILE = 64                     # query tiles of dK/dV, key tiles of dQ

REF_MASKS = {
    "causal": dict(),
    "window": dict(window=5),
    "prefix": dict(prefix_len=11),
    "softcap": dict(softcap=3.0),
    "all": dict(window=7, prefix_len=20, softcap=3.0),
}


def _inputs(seed, b, s, h, kvh, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd), (b, s, h, hd)))


def _cfg(h, kvh, hd, kw):
    return RA.AttnConfig(d_model=0, n_heads=h, n_kv_heads=kvh, head_dim=hd,
                         softcap=kw.get("softcap"), window=kw.get("window"),
                         prefix_len=kw.get("prefix_len", 0))


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("mask", list(REF_MASKS))
def test_plain_lse_matches_reference_scan_statistics(group, mask):
    b, s, kvh, hd, block = 2, 37, 2, 16, 16
    kw = REF_MASKS[mask]
    q, k, v, _ = _inputs(group, b, s, kvh * group, kvh, hd)
    cfg = _cfg(kvh * group, kvh, hd, kw)
    pad = ((0, 0), (0, -s % block), (0, 0), (0, 0))
    qg = (q * np.float32(cfg.scale)).reshape(b, s, kvh, group, hd)
    _, m, l_safe = RA._flash_scan_fwd(jnp.asarray(qg), jnp.asarray(np.pad(k, pad)),
                                      jnp.asarray(np.pad(v, pad)), cfg,
                                      jnp.arange(s, dtype=jnp.int32), block, s)
    want = (np.asarray(m) + np.log(np.asarray(l_safe))).reshape(b, kvh * group, s)
    _, got = k3.flash_attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                    scale=cfg.scale, return_lse=True, **kw)
    assert got.dtype == torch.float32 and got.shape == (b, kvh * group, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd", [80, 256])
@pytest.mark.parametrize("mask", list(REF_MASKS))
def test_flash_bwd_ref_matches_reference_vjp_at_wide_heads(hd, mask):
    b, s, kvh, group = 2, 40, 2, 2
    kw = REF_MASKS[mask]
    q, k, v, do = _inputs(hd, b, s, kvh * group, kvh, hd)
    cfg = _cfg(kvh * group, kvh, hd, kw)
    pos = jnp.arange(s, dtype=jnp.int32)
    out, vjp = jax.vjp(lambda q, k, v: RA._attend_blockwise(q, k, v, cfg, pos, pos, block=16),
                       q, k, v)
    want = vjp(jnp.asarray(do))
    kw = dict(scale=cfg.scale, **kw)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    tout, lse = k3.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), atol=1e-5)
    for row_stats in (lse, None):
        got = k3.flash_attention_bwd_ref(tq, tk, tv, tout, tdo, row_stats, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("window,prefix,softcap", [
    (None, 0, None), (4, 0, 2.0), (3, 9, 1.5)])
def test_flash_attention_function_reads_its_saved_lse(window, prefix, softcap):
    """The backward from the lse saved by ``FlashAttention``'s forward gives
    the plain gradients (dense softmax, no lse), float64."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(*shape, generator=gen, dtype=torch.float64, requires_grad=True)
               for shape in ((2, 21, 4, 80), (2, 21, 2, 80), (2, 21, 2, 80)))
    dout = torch.randn(2, 21, 4, 80, generator=gen, dtype=torch.float64)
    out = k3.FlashAttention.apply(q, k, v, None, softcap, True, window, prefix)
    out.backward(dout)
    kw = dict(softcap=softcap, window=window, prefix_len=prefix)
    want = k3.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(),
                                      dout, **kw)
    for x, w in zip((q, k, v), want):
        torch.testing.assert_close(x.grad, w, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the kernels' arithmetic
# ---------------------------------------------------------------------------
def kernel_emulation(q, k, v, out, dout, lse, *, scale, softcap=None, window=None,
                     prefix_len=0, drop_key_tile=False, drop_head=False):
    """(dq, dk, dv) in bfloat16 as the Hopper backward kernels compute
    them, from bf16 inputs and the forward's float32 lse (B, H, S): dK and
    dV per query head over 64-query tiles, then over the group in head
    order; dQ over 64-key tiles in order.  Controls:
    ``drop_key_tile`` leaves each query's own 64-key tile out of dQ,
    ``drop_head`` leaves the group's first query head out of dK."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    qf, kf, vf, of, dof = (x.float().transpose(1, 2) for x in (q, k, v, out, dout))
    kf, vf = (x.repeat_interleave(group, dim=1) for x in (kf, vf))   # (B, H, T, hd)
    raw = qf @ kf.transpose(-1, -2)                       # exact products, float32 sums
    if softcap is None:
        x = raw * torch.tensor(scale * LOG2E, dtype=torch.float32)
        dcap = 1.0
    else:
        th = torch.tanh(raw * scale / softcap)
        x, dcap = softcap * th * LOG2E, 1.0 - th * th
    visible = k3.visible_mask(torch.arange(s), torch.arange(t), window=window,
                              prefix_len=prefix_len)
    p = torch.where(visible, torch.exp2(x - (lse * LOG2E)[..., None]), torch.zeros(()))
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * of).sum(-1)
    ds = p * (dp - delta[..., None]) * dcap
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    if drop_key_tile:
        own = (torch.arange(s)[:, None] // TILE) == (torch.arange(t)[None, :] // TILE)
        dsq = dsb.masked_fill(own, 0.0)
    else:
        dsq = dsb
    dq = torch.zeros(b, h, s, hd)
    for k0 in range(0, t, TILE):
        dq = dq + dsq[..., k0:k0 + TILE] @ kf[:, :, k0:k0 + TILE]
    # per query head and 64-query tile: (B, H, T, hd)
    parts_k = [dsb[:, :, q0:q0 + TILE].transpose(-1, -2) @ qf[:, :, q0:q0 + TILE]
               for q0 in range(0, s, TILE)]
    parts_v = [pb[:, :, q0:q0 + TILE].transpose(-1, -2) @ dof[:, :, q0:q0 + TILE]
               for q0 in range(0, s, TILE)]
    heads = [g for g in range(group) if not (drop_head and g == 0)]
    hk, hv = torch.zeros(b, h, t, hd), torch.zeros(b, h, t, hd)
    for pk, pv in zip(parts_k, parts_v):
        hk, hv = hk + pk, hv + pv
    dk, dv = torch.zeros(b, kvh, t, hd), torch.zeros(b, kvh, t, hd)
    for g in heads:
        dk, dv = dk + hk[:, g::group], dv + hv[:, g::group]
    return ((dq * scale).transpose(1, 2).bfloat16(), (dk * scale).transpose(1, 2).bfloat16(),
            dv.transpose(1, 2).bfloat16())


def _bf16_case(seed, b, s, h, kvh, hd, kw):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
                     for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd),
                                   (b, s, h, hd)))
    out, lse = k3.flash_attention_ref(q, k, v, return_lse=True, **kw)
    want = k3.flash_attention_bwd_ref(*(x.double() for x in (q, k, v, out, dout)), **kw)
    bounds = k3.error_bound_bwd(q, k, v, out, dout, want, **kw)
    return (q, k, v, out, dout, lse), want, bounds


def _ratios(got, want, bounds):
    return [float(((g.double() - w).abs() / bd.double()).max())
            for g, w, bd in zip(got, want, bounds)]


EMU_MASKS = {
    "causal": dict(),
    "window": dict(window=70),
    "prefix": dict(prefix_len=130),
    "softcap": dict(softcap=30.0),
    "window_prefix_softcap": dict(window=40, prefix_len=100, softcap=30.0),
}


@pytest.mark.parametrize("mask", list(EMU_MASKS))
@pytest.mark.parametrize("s", [65, 300])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_kernel_arithmetic_within_error_bound_bwd(hd, s, mask):
    """The emulated kernels lie within ``error_bound_bwd`` of the plain
    version, element by element: B = 2, 4 query heads over 2 KV heads."""
    kw = dict(scale=1.0 / math.sqrt(hd), **EMU_MASKS[mask])
    args, want, bounds = _bf16_case(hd * 1000 + s, 2, s, 4, 2, hd, kw)
    got = kernel_emulation(*args, **kw)
    for g, x in zip(got, args):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
    ratios = _ratios(got, want, bounds)
    assert max(ratios) <= 1.0, f"dq, dk, dv: {ratios} of the bound at the worst element"


@pytest.mark.parametrize("hd", [128, 256])
def test_error_bound_bwd_catches_a_dropped_tile_or_head(hd):
    """Controls: dQ without each query's own 64-key tile, and dK without
    the group's first query head, lie far outside ``error_bound_bwd``."""
    kw = dict(scale=1.0 / math.sqrt(hd))
    args, want, bounds = _bf16_case(hd, 1, 300, 4, 2, hd, kw)
    assert max(_ratios(kernel_emulation(*args, **kw), want, bounds)) <= 1.0
    tile = _ratios(kernel_emulation(*args, drop_key_tile=True, **kw), want, bounds)
    head = _ratios(kernel_emulation(*args, drop_head=True, **kw), want, bounds)
    assert tile[0] > 4.0, tile
    assert head[1] > 4.0, head
