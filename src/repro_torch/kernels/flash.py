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
it runs :func:`flash_attention_ref`.  With ``return_lse=True`` both also
return each row's log-sum-exp of its logits, (B, H, S) float32, which the
backward reads.  :class:`FlashAttention` is the differentiable form the
model calls: K3 forward (with lse) and its backward kernel
``csrc/flash_attn_bwd.cu`` (:func:`flash_attention_bwd`, which takes that
lse) on the card, :func:`flash_attention_ref` and
:func:`flash_attention_bwd_ref` on the CPU.  In bfloat16 (hd >= 16) the kernel
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

import numpy as np
import torch

from ..roofline import count
from . import build

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 80, 128, 256)
BWD_HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # csrc/flash_attn_bwd.cu
# bfloat16 at these widths runs the backward's Hopper kernels (TMA, wgmma),
# which sum dK and dV per query head in a float32 workspace (with GQA);
# float32 and the smoke widths take the mma.sync / FMA kernels
BWD_HOPPER_HEAD_DIMS = (64, 80, 128, 256)
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


def visible_pairs(s: int, t: int, *, causal: bool = True, window: int | None = None,
                  prefix_len: int = 0) -> int:
    """The (query, key) pairs that ``visible_mask`` keeps among queries
    0..S-1 and keys 0..T-1 (all S T without ``causal``), counted row by row
    without building the mask."""
    if not causal:
        return s * t
    rows = np.arange(s, dtype=np.int64)
    hi = np.minimum(rows, t - 1)
    lo = np.maximum(0, rows - window + 1) if window is not None else np.zeros_like(rows)
    seen = np.maximum(0, hi - lo + 1)
    p = min(int(prefix_len), t)
    if p:
        pre = rows < prefix_len
        inside = np.maximum(0, np.minimum(hi, p - 1) - lo + 1)
        seen = seen + np.where(pre, p - inside, 0)
    return int(seen.sum())


def flash_attention_cost(b: int, s: int, t: int, h: int, kvh: int, hd: int, itemsize: int,
                         *, causal: bool = True, window: int | None = None,
                         prefix_len: int = 0, return_lse: bool = False) -> tuple[float, float]:
    """(FLOPs, bytes) of one K3 forward launch: the two products of every
    visible pair and query head, 4 hd each; q read and the output written,
    k and v read once (and each row's float32 lse written with
    ``return_lse``)."""
    pairs = visible_pairs(s, t, causal=causal, window=window, prefix_len=prefix_len)
    nbytes = (2 * b * s * h * hd + 2 * b * t * kvh * hd) * itemsize
    return 4.0 * hd * h * b * pairs, float(nbytes + (4 * b * h * s if return_lse else 0))


def flash_attention_bwd_cost(b: int, s: int, t: int, h: int, kvh: int, hd: int,
                             itemsize: int, *, window: int | None = None,
                             prefix_len: int = 0) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch of K3's backward: the five products of
    every visible pair and query head (S, dP, dV, dK, dQ; 10 hd); q, out,
    dout read and dq written, k and v read and dk, dv written."""
    pairs = visible_pairs(s, t, window=window, prefix_len=prefix_len)
    return (10.0 * hd * h * b * pairs,
            float((4 * b * s * h * hd + 4 * b * t * kvh * hd) * itemsize))


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
                        prefix_len: int = 0, return_lse: bool = False):
    """Plain PyTorch version of :func:`flash_attention` with K3's numerics:
    q scaled in float32, float32 logits and probabilities (dense softmax),
    the output cast to q's dtype at the end, zeros for a row that sees no
    key.  With ``return_lse``, also each row's log-sum-exp of its visible
    logits, (B, H, S) (0 for a row that sees no key)."""
    _check_mask_args(causal, window, prefix_len)
    b, s, h, hd = q.shape
    kw = dict(scale=scale, softcap=softcap, causal=causal, window=window,
              prefix_len=prefix_len)
    if return_lse:
        logits, _, seen = _logits(q, k, **kw)
        probs, lse = _softmax(logits, seen), _lse(logits, seen)
    else:
        probs, _ = _probs(q, k, **kw)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(probs.dtype))
    out = out.reshape(b, s, h, hd).to(q.dtype)
    return (out, lse) if return_lse else out


def _logits(q, k, *, scale=None, softcap=None, causal=True, window=None,
            prefix_len=0):
    """K3's logits (B, KVH, G, S, T) in float32 (float64 for float64 inputs:
    gradcheck): scaled, capped, NEG_INF where hidden; the softcap's
    derivative 1 - tanh^2 at the logits (None without one); and (S,) bool,
    whether each row sees a key (None when every row does)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qg = q.to(ct).reshape(b, s, kvh, h // kvh, hd) * scale
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(ct))
    dcap = seen = None
    if softcap is not None:
        th = torch.tanh(logits / softcap)
        logits, dcap = softcap * th, 1.0 - th * th
    if causal:
        visible = visible_mask(torch.arange(s, device=q.device),
                               torch.arange(t, device=q.device), window=window,
                               prefix_len=prefix_len)
        logits = logits.masked_fill(~visible, NEG_INF)
        if window is not None:
            # a row that sees no key (a window past T < S) has l == 0 in K3
            seen = visible.any(-1)
    return logits, dcap, seen


def _softmax(logits, seen):
    probs = torch.softmax(logits, dim=-1)
    # a row that sees no key gives zeros
    return probs if seen is None else probs * seen[:, None]


def _lse(logits, seen):
    """(B, KVH, G, S) logits' log-sum-exp as K3 writes it, (B, H, S): 0 for
    a row that sees no key."""
    b, kvh, g, s, _ = logits.shape
    lse = torch.logsumexp(logits, dim=-1)
    if seen is not None:
        lse = torch.where(seen, lse, torch.zeros_like(lse))
    return lse.reshape(b, kvh * g, s)


def _probs(q, k, **kw):
    """K3's probabilities (B, KVH, G, S, T) in float32 (float64 for float64
    inputs: gradcheck), and the softcap's derivative 1 - tanh^2 at the
    logits (None without one)."""
    logits, dcap, seen = _logits(q, k, **kw)
    return _softmax(logits, seen), dcap


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor,
                            lse: torch.Tensor | None = None, *,
                            scale: float | None = None, softcap: float | None = None,
                            causal: bool = True, window: int | None = None,
                            prefix_len: int = 0):
    """Plain PyTorch version of :func:`flash_attention_bwd`: the gradients
    (dq, dk, dv) of :func:`flash_attention_ref` at ``out`` (its output)
    for the output gradient ``dout``, in the inputs' dtypes.  The
    reference's blockwise backward math (``_make_flash``'s bwd,
    ``src/repro/models/attention.py:269-314``) over dense tensors, in
    float32 (float64 for float64 inputs): p = exp(x - lse) over the visible
    logits x with the forward's ``lse`` (B, H, S) when one is given, as the
    reference's bwd reads the forward's m and l, else the dense softmax;
    dP = dO V^T, D = rowsum(dO o O), dS = p (dP - D) (times 1 - tanh^2
    under the softcap), dV = P^T dO and dK = dS^T q scale summed over each
    KV head's query heads, dQ = dS K scale."""
    _check_mask_args(causal, window, prefix_len)
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    logits, dcap, seen = _logits(q, k, scale=scale, softcap=softcap, causal=causal,
                                 window=window, prefix_len=prefix_len)
    if lse is None:
        p = _softmax(logits, seen)
    else:
        # hidden logits are NEG_INF: p = 0 there, and for a row that sees
        # no key (lse 0)
        p = torch.exp(logits - lse.to(logits.dtype).reshape(b, kvh, h // kvh, s, 1))
    del logits
    ct = p.dtype
    do = dout.to(ct).reshape(b, s, kvh, h // kvh, hd)
    dp = torch.einsum("bskgd,btkd->bkgst", do, v.to(ct))
    delta = (do * out.to(ct).reshape(do.shape)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (dp - delta[..., None])
    if dcap is not None:
        ds = ds * dcap
    qg = q.to(ct).reshape(b, s, kvh, h // kvh, hd)
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(ct)) * scale
    return (dq.reshape(b, s, h, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


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


# repro_flash_attention's arguments: q, k, v, out; B, S, T, H, KVH, hd,
# dtype; scale, softcap; causal, window, prefix; lse, stream
FWD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_double] * 2
                + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attn")
    lib.repro_flash_attention.argtypes = FWD_ARGTYPES
    lib.repro_flash_attention.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, softcap: float | None = None,
                    causal: bool = True, window: int | None = None,
                    prefix_len: int = 0, return_lse: bool = False):
    """GQA attention forward; K3 on the card, the plain version on the
    CPU.  With ``return_lse``: (out, lse), lse each row's log-sum-exp of
    its logits, (B, H, S) float32 on the card.  On the meta device it
    returns outputs of the right shapes, launches nothing and reports
    :func:`flash_attention_cost` to the active counter (``roofline.count``),
    as a launch on the card does."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, softcap=softcap,
                                   causal=causal, window=window,
                                   prefix_len=prefix_len, return_lse=return_lse)
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
    lse = (torch.empty(b, h, s, dtype=torch.float32, device=q.device)
           if return_lse else None)
    cost = flash_attention_cost(b, s, t, h, kvh, hd, q.element_size(), causal=causal,
                                window=window, prefix_len=prefix_len, return_lse=return_lse)
    if q.device.type == "meta":
        count.kernel("flash_attention", *cost)
        return (out, lse) if return_lse else out
    lib = _lib()
    # the launch function launches into, and sets attributes on, the
    # current card: make it the tensor's, which may be another card
    with torch.cuda.device(q.device):
        code = lib.repro_flash_attention(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), b, s, t,
            h, kvh, hd, build.DTYPE_CODES[q.dtype], float(scale),
            float(softcap or 0.0), int(causal), win, prefix, build.ptr(lse),
            build.stream(q.device))
    build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    count.kernel("flash_attention", *cost)
    if win:
        flash_attention.mask_launches["window"] += 1
    if prefix:
        flash_attention.mask_launches["prefix"] += 1
    return (out, lse) if return_lse else out


# launches, and those of them that applied a window or a prefix
flash_attention.launches = 0
flash_attention.mask_launches = {"window": 0, "prefix": 0}


def error_bound_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, dout: torch.Tensor, want, **kw):
    """How far :func:`flash_attention_bwd`'s (dq, dk, dv) may lie from
    ``want``, the plain version's gradients (on float64 copies of the
    inputs for float32 ones), element by element (three tensors, float64
    for float32 inputs, float32 for bfloat16).

    Each output's mass is its sum over absolute values: |dV| = P^T |dO|,
    |dK| = scale M^T |q| and |dQ| = scale M |k|, where M = p (|dO| |V|^T +
    rowsum(|dO| o |O|)) (times 1 - tanh^2) bounds |dS| and the rounding of
    every float32 sum that makes it, however much dP and D cancel:

    * float32: ``2**-14 (|want| + mass)``.  The kernel sums each output in
      float32, within a 64-term tile and then across at most G x S / 64
      tiles: a blocked sum's error is below (64 + tiles) 2**-24 of the
      mass, under 2**-14 for the 832 tiles of G = 12 heads over S = 4096
      queries, and p, D and dS each carry a few more roundings.
    * bfloat16: ``2**-7 (|want| + mass)``.  Both versions compute in (at
      least) float32 and the kernel rounds each output to bfloat16 once:
      one bf16 ulp, at most 2**-7 |want|.  The kernel also rounds p and dS
      to bfloat16 before the products that read them, a relative error of
      at most 2**-8 on every term, so an output moves by at most 2**-8 of
      its mass however much its terms cancel; the bound doubles both, as
      :func:`error_bound` does.  Where many terms cancel the mass is
      large beside the output itself, so ``chip_smoke.py`` also holds the
      outputs norm-wise at the training shapes and plants faults there (a
      query head dropped, each row's own key tile left out of dQ) that
      must fall outside one check or the other."""
    kw = {**kw, "scale": kw.get("scale") or 1.0 / math.sqrt(q.shape[-1])}
    # the masses in float64 for float32 inputs; float32 is ample beside
    # bfloat16's 2**-7
    ct = torch.float32 if q.dtype == torch.bfloat16 else torch.float64
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    p, dcap = _probs(q.to(ct), k.to(ct), **kw)
    qa, ka, va, oa, doa = (t.to(ct).abs() for t in (q, k, v, out, dout))
    qa, oa, doa = (t.reshape(b, s, kvh, h // kvh, hd) for t in (qa, oa, doa))
    m = torch.einsum("bskgd,btkd->bkgst", doa, va)
    m += (doa * oa).sum(-1).permute(0, 2, 3, 1)[..., None]
    m *= p
    if dcap is not None:
        m *= dcap
    scale = kw["scale"]
    mass = (torch.einsum("bkgst,btkd->bskgd", m, ka).reshape(q.shape) * scale,
            torch.einsum("bkgst,bskgd->btkd", m, qa) * scale,
            torch.einsum("bkgst,bskgd->btkd", p, doa))
    rel = 2.0 ** -14 if q.dtype == torch.float32 else 2.0 ** -7
    return tuple((w.to(ct).abs() + ms) * rel for w, ms in zip(want, mass))


@lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attn_bwd")
    lib.repro_flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_double] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.repro_flash_attention_bwd.restype = ctypes.c_int
    return lib


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                        scale: float | None = None, softcap: float | None = None,
                        causal: bool = True, window: int | None = None,
                        prefix_len: int = 0):
    """The gradients (dq, dk, dv) of :func:`flash_attention` at its output
    ``out`` and row statistics ``lse`` (``flash_attention(...,
    return_lse=True)``) for the output gradient ``dout``: the backward
    kernel on the card (causal only; bfloat16 or float32; hd in
    :data:`BWD_HEAD_DIMS`), else it raises; :func:`flash_attention_bwd_ref`
    on the CPU; on the meta device shapes only, reporting
    :func:`flash_attention_bwd_cost` to the active counter."""
    kw = dict(scale=scale, softcap=softcap, causal=causal, window=window,
              prefix_len=prefix_len)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, dout, lse, **kw)
    _check_mask_args(causal, window, prefix_len)
    if not causal:
        raise ValueError("K3's backward kernel takes the causal mask only")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be (B, S, H, hd) and k, v (B, T, KVH, hd)")
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_bwd takes float32/bfloat16, got {q.dtype}")
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the backward kernel's {BWD_HEAD_DIMS}")
    if kvh == 0 or h % kvh or t == 0:
        raise ValueError(f"{h} query heads over {kvh} KV heads and {t} keys")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    for name, x, shape in (("q", q, q.shape), ("k", k, k.shape), ("v", v, k.shape),
                           ("out", out, q.shape), ("dout", dout, q.shape)):
        build.check_tensor(x, name, q.device, q.dtype, shape)
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    build.check_tensor(lse, "lse", q.device, torch.float32, (b, h, s))
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    win = 0 if window is None or window >= s else int(window)
    prefix = min(int(prefix_len), max(s, t))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the forward's lse and D = rowsum(dO o O), rows padded to 64
    rows = torch.empty(2, b, h, -(-s // 64) * 64, dtype=torch.float32, device=q.device)
    ws = None
    if q.dtype == torch.bfloat16 and hd in BWD_HOPPER_HEAD_DIMS and h > kvh:
        # dK and dV per query head, summed over each group by the kernel
        ws = torch.empty(2, b, t, h, hd, dtype=torch.float32, device=q.device)
    cost = flash_attention_bwd_cost(b, s, t, h, kvh, hd, q.element_size(), window=window,
                                    prefix_len=prefix_len)
    if q.device.type == "meta":
        count.kernel("flash_attention_bwd", *cost)
        return dq, dk, dv
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        code = lib.repro_flash_attention_bwd(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), build.ptr(dout),
            build.ptr(lse), build.ptr(dq), build.ptr(dk), build.ptr(dv), build.ptr(rows[0]),
            build.ptr(rows[1]), build.ptr(ws), b, s, t, h, kvh, hd,
            build.DTYPE_CODES[q.dtype], float(scale), float(softcap or 0.0), win, prefix,
            build.stream(q.device))
    build.check(lib, code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    count.kernel("flash_attention_bwd", *cost)
    return dq, dk, dv


# launches of the backward kernel (one per call: its kernels in turn)
flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """K3 with its gradient: ``FlashAttention.apply(q, k, v, scale,
    softcap, causal, window, prefix_len)``.  The forward is
    :func:`flash_attention` with its row statistics and the backward
    :func:`flash_attention_bwd` at the saved q, k, v, output and lse (the
    kernels on the card, the plain versions on the CPU); under
    ``torch.utils.checkpoint`` the recomputed forward's lse is the one the
    backward reads.  Where no input needs a gradient (serving) the forward
    writes no lse and saves nothing.  The non-tensor arguments get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, softcap, causal, window, prefix_len):
        kw = dict(scale=scale, softcap=softcap, causal=causal, window=window,
                  prefix_len=prefix_len)
        if not any(ctx.needs_input_grad[:3]):
            # no backward will run (serving, or no grad): no lse
            return flash_attention(q, k, v, **kw)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
