"""K3's Hopper-kernel arithmetic, emulated in plain torch, against the plain version.

The Hopper kernel of ``csrc/flash_attn.cu`` (bfloat16 at hd 64, 80, 128
and 256) runs the online softmax over 128-key tiles with p = exp2 of the
float32 logits (in log2 units) less the running max, rounds p to bfloat16
for P V while the row sum l adds the float32 values, rescales O by alpha
as the max moves, and rounds the output to bfloat16 once.  The card checks
hold the kernel to ``kernels.flash.error_bound``; here the same arithmetic,
written out in torch on the CPU, is held to the same bound at hd 80
(zamba2's shared block) and hd 128, for causal, window, prefix and softcap
cases at lengths around one 128-key tile.  This pins that the bound covers
p in bfloat16 where the card cannot be reached, and a control shows that
the bound catches a fault of the online softmax (a missed rescale).

These tests check the width of ``error_bound``, not the kernel: they run
none of the CUDA code, and a kernel whose arithmetic drifted from this
emulation would not fail here.  The kernel's evidence is the card tests
(``tests/test_torch_cuda.py::test_k3_hd80_block_edges`` and the K3 checks
of ``chip_smoke.py``), which hold its output to the same bound.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash as k3

BK = 128                      # keys per tile at hd 80 and 128
LOG2E = 1.4426950408889634


def hopper_emulation(q, k, v, *, scale, softcap=None, causal=True, window=None,
                     prefix_len=0, rescale=True):
    """K3's Hopper kernel in plain torch: (B, S, H, hd) bf16 out.  With
    ``rescale=False`` the running sums are not rescaled when the max moves
    (a fault, for the control)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, s, kvh, h // kvh, hd)
    raw = torch.einsum("bskgd,btkd->bkgst", qf, k.float())   # exact products, f32 sums
    if softcap is None:
        x = raw * torch.tensor(scale * LOG2E, dtype=torch.float32)
    else:
        x = softcap * torch.tanh(raw * scale / softcap) * LOG2E
    if causal:
        visible = k3.visible_mask(torch.arange(s), torch.arange(t), window=window,
                                  prefix_len=prefix_len)
        x = x.masked_fill(~visible, -math.inf)
    m = torch.full(x.shape[:-1], -math.inf)
    l = torch.zeros(x.shape[:-1])
    o = torch.zeros(*x.shape[:-1], hd)
    for k0 in range(0, t, BK):
        xt = x[..., k0:k0 + BK]
        m_new = torch.maximum(m, xt.amax(-1))
        m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - m_use) if rescale else torch.ones_like(m)
        p = torch.exp2(xt - m_use[..., None])                # float32
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.bfloat16().float(), v[:, k0:k0 + BK].float())
        o = o * alpha[..., None] + pv
        m = m_new
    out = o * (1.0 / torch.where(l == 0, torch.ones_like(l), l))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


def _qkv(seed, b, s, h, kvh, hd):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
                 for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd)))


MASKS = {
    "full": dict(causal=False),
    "causal": dict(causal=True),
    "window": dict(causal=True, window=63),
    "prefix": dict(causal=True, prefix_len=127),
    "softcap": dict(causal=True, softcap=50.0),
    "window_prefix_softcap": dict(causal=True, window=100, prefix_len=300, softcap=30.0),
}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("s", [1, 127, 128, 129, 300])
@pytest.mark.parametrize("hd", [80, 128])
def test_hopper_rounding_within_error_bound(hd, s, mask):
    """The emulated kernel (p in bf16 for P V) lies within ``error_bound``
    of the plain version, element by element: B = 2, GQA (4 heads over
    2)."""
    q, k, v = _qkv(hd * 1000 + s, 2, s, 4, 2, hd)
    kw = dict(scale=1.0 / math.sqrt(hd), **MASKS[mask])
    want = k3.flash_attention_ref(q, k, v, **kw)
    got = hopper_emulation(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    bound = k3.error_bound(q, k, v, want, **kw)
    ratio = float(((got.float() - want.float()).abs() / bound).max())
    assert ratio <= 1.0, f"{ratio:.3f} of the bound at the worst element"


@pytest.mark.parametrize("hd", [80, 128])
def test_error_bound_catches_a_missed_rescale(hd):
    """Control: the same emulation without the rescale by alpha (rows of
    three tiles whose max moves) lies far outside the bound."""
    q, k, v = _qkv(hd, 1, 300, 4, 2, hd)
    q = q * 4                                  # logits far apart: the max moves a lot
    kw = dict(scale=1.0 / math.sqrt(hd), causal=True)
    want = k3.flash_attention_ref(q, k, v, **kw)
    bound = k3.error_bound(q, k, v, want, **kw)
    good = hopper_emulation(q, k, v, **kw)
    bad = hopper_emulation(q, k, v, rescale=False, **kw)
    assert bool(((good.float() - want.float()).abs() <= bound).all())
    assert float(((bad.float() - want.float()).abs() / bound).max()) > 10.0
