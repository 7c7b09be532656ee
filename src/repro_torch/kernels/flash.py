"""Flash-attention forward kernel (K3) and its plain PyTorch version.

``flash_attention(q, k, v, scale=, softcap=, causal=, window=,
prefix_len=)`` is the reference's ``repro.kernels.flash.flash_attention``
(the Pallas kernel at ``src/repro/kernels/flash.py:70``): q (B, S, H, hd),
k/v (B, T, KVH, hd) with H = KVH * G, query head h reading KV head h // G.
It returns (B, S, H, hd) in q's dtype.  q is scaled in float32, logits and
probabilities are float32, an optional ``softcap * tanh(x / softcap)``
caps the logits, and the causal mask keeps key t for query s when t <= s.
Unlike the Pallas kernel it takes any S and T, and the two masks of the
reference's model path (``_mask_block``, ``src/repro/models/attention.py``):
with a ``window`` (gemma2's local layers) the causal mask keeps only keys
t > s - window, and with a ``prefix_len`` P (paligemma) every query s < P
also sees every key t < P.  In all, with causal on, key t is visible to
query s when

    (t <= s and (window is None or t > s - window))
    or (t < prefix_len and s < prefix_len).

On a CUDA tensor it launches the hand-written kernel ``csrc/flash_attn.cu``
(bfloat16 or float32; hd in :data:`HEAD_DIMS`) or raises; on a CPU tensor
it runs :func:`flash_attention_ref`.  In bfloat16 (hd >= 16) the kernel
runs both products on the tensor cores: q.k as exact bf16 products summed
in float32, then scaled in float32; for p.v, at hd 64, 80, 128 and 256
(the Hopper kernel: TMA, wgmma, warp-specialised; hd 80, zamba2's shared
attention block, as a 64-column and a 16-column chunk) p is rounded to
bfloat16 as the reference's dense path does, at hd 16 and 32 (the
mma.sync kernel, for the smoke configs) to TF32.  In float32, and at hd
8, it computes in float32 throughout.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 80, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def visible_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                 window: int | None = None, prefix_len: int = 0) -> torch.Tensor:
    """(S,) x (T,) positions -> (S, T) bool: key visible to query under the
    causal mask with ``window`` and ``prefix_len`` (the predicate of the
    module docstring; K3 applies it at positions 0..S-1 and 0..T-1)."""
    kp, qp = k_pos[None, :], q_pos[:, None]
    m = kp <= qp
    if window is not None:
        m &= kp > qp - window
    if prefix_len:
        m |= (kp < prefix_len) & (qp < prefix_len)
    return m


def _check_mask_args(causal: bool, window: int | None, prefix_len: int) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    if not causal and (window is not None or prefix_len):
        raise ValueError("window and prefix_len refine the causal mask: "
                         "they need causal=True")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float | None = None, softcap: float | None = None,
                        causal: bool = True, window: int | None = None,
                        prefix_len: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention` with K3's numerics:
    q scaled in float32, float32 logits and probabilities (dense softmax),
    the output cast to q's dtype at the end, zeros for a row that sees no
    key."""
    _check_mask_args(causal, window, prefix_len)
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(b, s, kvh, h // kvh, hd) * scale
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if causal:
        visible = visible_mask(torch.arange(s, device=q.device),
                               torch.arange(t, device=q.device), window=window,
                               prefix_len=prefix_len)
        logits = logits.masked_fill(~visible, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if causal and window is not None:
        # a row that sees no key (a window past T < S) has l == 0 in K3 and
        # gives zeros
        probs = probs * visible.any(-1)[:, None]
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                want: torch.Tensor, **kw) -> torch.Tensor:
    """How far K3's output may lie from ``want = flash_attention_ref(q, k,
    v, **kw)``, element by element (float32, ``want``'s shape).

    float32: 1e-5 absolute (outputs of order 1 at most; the two sum in
    another order).  bfloat16: ``2**-7 |want| + 2**-7 (P |v|)``, where
    ``P |v|`` is the attention of the same rows over ``|v|``.  Both
    versions compute in float32 and round to bfloat16 once, so they differ
    by one bf16 ulp (at most ``2**-7 |want|``) where their float32 results
    straddle a rounding boundary.  K3 also rounds each unnormalised
    probability to bfloat16 before p.v, as the reference's dense path
    does, while it sums the row's l from the float32 values: a relative
    error of at most the unit roundoff 2**-8 on every term, so an output
    ``sum_j p_j v_j`` moves by at most ``2**-8 sum_j p_j |v_j| = 2**-8
    (P |v|)`` however much its terms cancel; the bound doubles that, as it
    doubles the half-ulp of the output rounding.  A fault that changes a
    row's softmax (a dropped key tile, a missed rescale) moves its outputs
    by far more."""
    if want.dtype == torch.float32:
        return torch.full_like(want, 1e-5)
    mass = flash_attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    return (want.float().abs() + mass) * 2.0 ** -7


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attn")
    lib.repro_flash_attention.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_double] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.repro_flash_attention.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, softcap: float | None = None,
                    causal: bool = True, window: int | None = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """GQA attention forward; K3 on the card, the plain version on the
    CPU."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, softcap=softcap,
                                   causal=causal, window=window,
                                   prefix_len=prefix_len)
    _check_mask_args(causal, window, prefix_len)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be (B, S, H, hd) and k, v (B, T, KVH, hd)")
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32/bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} KV heads")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    build.check_tensor(q, "q", q.device)
    build.check_tensor(k, "k", q.device, q.dtype, (b, t, kvh, hd))
    build.check_tensor(v, "v", q.device, q.dtype, (b, t, kvh, hd))
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    # a window as long as the queries hides no key: 0 tells the kernel so,
    # and keeps s - window inside an int
    win = 0 if window is None or window >= s else int(window)
    prefix = min(int(prefix_len), max(s, t))
    out = torch.empty_like(q)
    lib = _lib()
    # the launch function launches into, and sets attributes on, the
    # current card: make it the tensor's, which may be another card
    with torch.cuda.device(q.device):
        code = lib.repro_flash_attention(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), b, s, t,
            h, kvh, hd, build.DTYPE_CODES[q.dtype], float(scale),
            float(softcap or 0.0), int(causal), win, prefix,
            build.stream(q.device))
    build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    if win:
        flash_attention.mask_launches["window"] += 1
    if prefix:
        flash_attention.mask_launches["prefix"] += 1
    return out


# launches, and those of them that applied a window or a prefix
flash_attention.launches = 0
flash_attention.mask_launches = {"window": 0, "prefix": 0}
