"""Full-sequence (train / prefill) attention as hand-written Hopper
kernels, forward and backward.

Counterpart of ``repro.kernels.flash_attention``, whose Pallas kernel
``_attn_kernel`` the forward replaces: FlashAttention-2 with an fp32
online softmax, GQA through the kv head ``h // rep``, the causal mask
``kpos <= qpos`` from position 0 plus ``kpos < Sk``, the reference's
``-1e30`` sentinel and its ``l_safe`` finalize. The forward also returns
the fp32 per-row log-sum-exp that the backward needs. The backward has
no TPU counterpart: JAX cannot differentiate through the Pallas call, so
the reference trains with its jnp attention. ``FlashAttentionFn`` ties
the two into a ``torch.autograd.Function``; ``flash_attention`` is the
entry point.

Three kernel variants, one per (dtype, head dim, direction), chosen by
``_variant``:

- ``"wgmma"``: bf16 at the head dims of ``WGMMA_FWD_DIMS`` and
  ``WGMMA_BWD_DIMS`` (both 64: minicpm-2b, internvl2-1b; 80,
  hubert-xlarge; 112, zamba2-7b's shared attention block; 128, the other
  full-width text models), ``csrc/flash_attention_sm90.cu`` and
  ``csrc/flash_attention_bwd_sm90.cu``: wgmma on 128-byte-swizzled bf16
  tiles staged by TMA (head dims 80 and 112 zero-filled to two 64-column
  tiles), P and dS rounded to bf16 as the
  second product's operand (``_fwd_rounded`` and ``_bwd_rounded`` model
  those rounding points in plain PyTorch);
- ``"tf32x3"``: fp32 at every built pair, ``csrc/flash_attention_tf32x3.cu``
  and ``csrc/flash_attention_bwd_tf32x3.cu``: mma.sync on the tensor
  cores in 3xTF32 (each operand split into two TF32 halves, three
  products a pair, fp32 accuracy to a few ulps) on cp.async-staged tiles,
  the backward's dK / dV pass a CTA per query head with the GQA group
  summed in a second pass (``_split_tf32`` and ``_fwd_tf32x3`` /
  ``_bwd_tf32x3`` model the split in plain PyTorch);
- ``"cuda_core"``: bf16 at the other head dims (16: the reduced
  configs), ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``:
  fp32 products on the CUDA cores.

Each wrapper takes the plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches its variant's kernel or raises. The
forward counts kernel launches in ``flash_attention.launches``, the
backward in ``flash_attention_bwd.launches``; the wgmma and tf32x3
launches among them also in ``flash_attention.wgmma_launches`` /
``flash_attention.tf32x3_launches`` and
``flash_attention_bwd.wgmma_launches`` /
``flash_attention_bwd.tf32x3_launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.flash_decode import (_DTYPE_CODE, _ptr, _stream,
                                              check_launch)

NEG_INF = -1e30
# (head dim, GQA group) pairs the forward kernels are built for, whatever
# the dtype: csrc/attention_common.cuh's PAM_ATTN_FWD_BUILT (fp32: every
# pair, flash_attention_tf32x3.cu; bf16: the wgmma forward,
# flash_attention_sm90.cu, takes those at WGMMA_FWD_DIMS, its
# PAM_ATTN_FWD90_BUILT, and flash_attention.cu the rest): the reduced
# configs' head dim 16, and minicpm-2b (64, 1), internvl2-1b (64, 7),
# hubert-xlarge (80, 1), zamba2-7b's shared block (112, 1), pam-llama-7b
# (128, 1), qwen3-0.6b (128, 2), qwen3-14b (128, 5), deepseek-67b (128, 8)
# and qwen3-moe-235b-a22b (128, 16)
BUILT = ((16, 1), (16, 2),
         (64, 1), (64, 7),
         (80, 1),
         (112, 1),
         (128, 1), (128, 2), (128, 5), (128, 8), (128, 16))
# the backward's pairs: PAM_ATTN_BWD_BUILT (flash_attention_bwd_sm90.cu's
# PAM_ATTN_BWD90_BUILT at WGMMA_BWD_DIMS), the same list: every built
# forward trains
BUILT_BWD = BUILT
# head dims whose bf16 forward / backward run the wgmma kernels:
# csrc/attention_common.cuh's PAM_ATTN_WGMMA_FWD_DIMS / _BWD_DIMS
WGMMA_FWD_DIMS = (64, 80, 112, 128)
WGMMA_BWD_DIMS = (64, 80, 112, 128)
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
SM90_PAD = 128          # row padding of the wgmma backward's fp32 scratch


def _variant(dtype: torch.dtype, d: int, backward: bool = False) -> str:
    """The kernel variant of the forward (or, with ``backward``, the
    backward) on operands of ``dtype`` and head dim ``d``: ``"tf32x3"``
    for fp32, ``"wgmma"`` for bf16 at a head dim of ``WGMMA_FWD_DIMS``
    (``WGMMA_BWD_DIMS``), ``"cuda_core"`` for bf16 at the others. Each
    (dtype, d, group) of a direction has exactly one kernel; a (d, group)
    pair outside ``BUILT`` (forward) or ``BUILT_BWD`` (backward) raises in
    the wrapper before any launch."""
    if dtype == torch.float32:
        return "tf32x3"
    dims = WGMMA_BWD_DIMS if backward else WGMMA_FWD_DIMS
    return "wgmma" if d in dims else "cuda_core"


def _fwd_lib():
    from repro_torch.kernels import build
    fn = build.load("flash_attention").pam_flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _bwd_lib():
    from repro_torch.kernels import build
    fn = build.load("flash_attention_bwd").pam_flash_attention_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _fwd_sm90_lib():
    from repro_torch.kernels import build
    fn = build.load("flash_attention_sm90").pam_flash_attention_fwd_sm90
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _bwd_sm90_lib():
    from repro_torch.kernels import build
    fn = build.load("flash_attention_bwd_sm90").pam_flash_attention_bwd_sm90
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _fwd_tf32x3_lib():
    from repro_torch.kernels import build
    fn = build.load(
        "flash_attention_tf32x3").pam_flash_attention_fwd_tf32x3
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _bwd_tf32x3_lib():
    from repro_torch.kernels import build
    fn = build.load(
        "flash_attention_bwd_tf32x3").pam_flash_attention_bwd_tf32x3
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on fp32 ``x`` with the low 13 mantissa bits
    zeroed: on the int32 view, add 2^12 (round to nearest, ties away from
    zero; a carry runs into the exponent as the rounding does) and clear
    the 13 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``x`` as (hi, lo) = (tf32(x), tf32(x - hi)), the 3xTF32 split
    of ``csrc/attention_tf32.cuh``: hi + lo holds x to 2^-22 relative."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the tf32x3 kernels take it: lo_a hi_b + hi_a lo_b, then
    + hi_a hi_b (each elementary product exact in fp32, the sums fp32)."""
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _live(Sq: int, Sk: int, causal: bool, device) -> torch.Tensor:
    """(Sq, Sk) bool: the keys each query row attends."""
    if not causal:
        return torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    qpos = torch.arange(Sq, device=device)[:, None]
    return torch.arange(Sk, device=device)[None, :] <= qpos


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' accumulation type: fp32, or float64
    for float64 operands."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _grouped(q, k, v):
    """q as (B, Hkv, rep, Sq, d) and k, v as (B, Hkv, 1, Sk, d), in the
    accumulation type."""
    B, H, Sq, d = q.shape
    Hkv = k.shape[1]
    return (_acc(q).reshape(B, Hkv, H // Hkv, Sq, d), _acc(k)[:, :, None],
            _acc(v)[:, :, None])


# ------------------------------------------------------------ forward
def _fwd_math(q, k, v, causal, scale, round_p, mm=torch.matmul):
    """One masked softmax with the kernels' sentinel and ``l_safe``; with
    ``round_p`` P is rounded to bf16 before P V (the row sums stay fp32);
    ``mm`` takes both products."""
    B, H, Sq, d = q.shape
    qg, kg, vg = _grouped(q, k, v)
    live = _live(Sq, k.shape[2], causal, q.device)
    s = mm(qg, kg.transpose(-1, -2)) * scale
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1)
    p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = torch.sum(p, dim=-1)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    pv = _acc(p.bfloat16()) if round_p else p
    o = mm(pv, vg) / l_safe[..., None]
    lse = m + torch.log(l_safe)
    return o.reshape(B, H, Sq, d).to(q.dtype), lse.reshape(B, H, Sq)


def _fwd_plain(q, k, v, causal, scale):
    """Plain PyTorch version of the forward kernels: one masked softmax
    with the kernels' sentinel and ``l_safe``."""
    return _fwd_math(q, k, v, causal, scale, round_p=False)


def _fwd_rounded(q, k, v, causal, scale):
    """Plain PyTorch model of the wgmma forward's rounding points (tests
    and ``chip_smoke.py`` only, never on the main path): the products
    accumulate in fp32 from bf16 operands, the row sums come from fp32 P,
    and P is rounded to bf16 before P V. Computed against each row's
    final max, where the kernel rounds against the running max and
    rescales in fp32: the same rounding, one bf16 step of each P entry."""
    return _fwd_math(q, k, v, causal, scale, round_p=True)


def _fwd_tf32x3(q, k, v, causal, scale):
    """Plain PyTorch model of the tf32x3 forward's split (tests and
    ``chip_smoke.py`` only, never on the main path): S = Q K^T and P V in
    3xTF32 (``_mm_tf32x3``), P split against each row's final max where
    the kernel splits it against the running max (the same split up to
    one rounding of lo, 2^-22 relative)."""
    return _fwd_math(q, k, v, causal, scale, round_p=False, mm=_mm_tf32x3)


def _check_args(name, q, k, v):
    if k.dtype not in _DTYPE_CODE or q.dtype != k.dtype \
            or v.dtype != k.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype} "
                         f"not built (float32 or bfloat16, all alike)")


def _fwd_cuda(q, k, v, causal, scale):
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    check_launch("flash_attention", d, H // Hkv, q, k, v, built=BUILT)
    _check_args("flash_attention", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    variant = _variant(q.dtype, d)
    if variant == "wgmma":
        rc = _fwd_sm90_lib()(_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse),
                             B, H, Hkv, Sq, Sk, d, int(causal), float(scale),
                             _stream(q.device))
    elif variant == "tf32x3":
        rc = _fwd_tf32x3_lib()(_ptr(q), _ptr(k), _ptr(v), _ptr(o),
                               _ptr(lse), B, H, Hkv, Sq, Sk, d, int(causal),
                               float(scale), _stream(q.device))
    else:
        rc = _fwd_lib()(_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), B,
                        H, Hkv, Sq, Sk, d, int(causal), float(scale),
                        _DTYPE_CODE[q.dtype], _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention {variant} kernel launch "
                           f"failed (code {rc})")
    flash_attention.launches += 1
    if variant == "wgmma":
        flash_attention.wgmma_launches += 1
    elif variant == "tf32x3":
        flash_attention.tf32x3_launches += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward without autograd: (o (B, H, Sq, d) in q.dtype, lse (B, H,
    Sq) fp32). Operands must be contiguous."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, causal, scale)
    return _fwd_cuda(q, k, v, causal, scale)


# ------------------------------------------------------------ backward
def _bwd_math(q, k, v, o, lse, do, causal, scale, rounded,
              mm=torch.matmul):
    """P = exp(S - LSE), Delta = rowsum(dO * O), dV = P^T dO, dP = dO V^T,
    dS = P (dP - Delta), dQ = scale dS K, dK = scale dS^T Q, with the GQA
    group's query heads summed into their kv head; with ``rounded`` P is
    rounded to bf16 before dV and dS before dQ and dK; ``mm`` takes the
    five products."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = H // Hkv
    qg, kg, vg = _grouped(q, k, v)
    dog = _acc(do).reshape(B, Hkv, rep, Sq, d)
    lse_g = lse.reshape(B, Hkv, rep, Sq, 1)
    delta = torch.sum(dog * _acc(o).reshape(B, Hkv, rep, Sq, d), dim=-1,
                      keepdim=True)
    live = _live(Sq, Sk, causal, q.device)
    s = mm(qg, kg.transpose(-1, -2)) * scale
    p = torch.where(live, torch.exp(s - lse_g), torch.zeros_like(s))
    pv = _acc(p.bfloat16()) if rounded else p
    dv = torch.sum(mm(pv.transpose(-1, -2), dog), dim=2)
    dp = mm(dog, vg.transpose(-1, -2))
    ds = p * (dp - delta)
    if rounded:
        ds = _acc(ds.bfloat16())
    dq = mm(ds, kg) * scale
    dk = torch.sum(mm(ds.transpose(-1, -2), qg), dim=2) * scale
    return (dq.reshape(B, H, Sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bwd_plain(q, k, v, o, lse, do, causal, scale):
    """Plain PyTorch version of the backward kernels (``_bwd_math``
    unrounded)."""
    return _bwd_math(q, k, v, o, lse, do, causal, scale, rounded=False)


def _bwd_rounded(q, k, v, o, lse, do, causal, scale):
    """Plain PyTorch model of the wgmma backward's rounding points (tests
    and ``chip_smoke.py`` only): P rounded to bf16 before dV = P^T dO and
    dS rounded to bf16 before dQ = dS K and dK = dS^T Q; every product
    accumulates in fp32."""
    return _bwd_math(q, k, v, o, lse, do, causal, scale, rounded=True)


def _bwd_tf32x3(q, k, v, o, lse, do, causal, scale):
    """Plain PyTorch model of the tf32x3 backward's split (tests and
    ``chip_smoke.py`` only): the five products in 3xTF32
    (``_mm_tf32x3``, P and dS split as operands), Delta in plain fp32 as
    the kernels' delta pass takes it."""
    return _bwd_math(q, k, v, o, lse, do, causal, scale, rounded=False,
                     mm=_mm_tf32x3)


def _bwd_cuda(q, k, v, o, lse, do, causal, scale):
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    check_launch("flash_attention_bwd", d, H // Hkv, q, k, v, o, lse, do,
                 built=BUILT_BWD)
    _check_args("flash_attention_bwd", q, k, v)
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: o and do must have q's "
                         "dtype")
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    variant = _variant(q.dtype, d, backward=True)
    if variant == "wgmma":
        pad = -(-Sq // SM90_PAD) * SM90_PAD
        scratch = torch.empty((2, B, H, pad), dtype=torch.float32,
                              device=q.device)        # delta, lse log2(e)
        rc = _bwd_sm90_lib()(_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do),
                             _ptr(lse), _ptr(scratch[0]), _ptr(scratch[1]),
                             _ptr(dq), _ptr(dk), _ptr(dv), B, H, Hkv, Sq,
                             Sk, pad, d, int(causal), float(scale),
                             _stream(q.device))
    elif variant == "tf32x3":
        delta = torch.empty((B, H, Sq), dtype=torch.float32,
                            device=q.device)
        # the dK / dV pass's per-query-head partials, summed over the group
        # by a second pass (group 1 writes dk, dv directly)
        part = (torch.empty((2, B, H, Sk, d), dtype=torch.float32,
                            device=q.device) if H > Hkv else None)
        rc = _bwd_tf32x3_lib()(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
            _ptr(delta), None if part is None else _ptr(part[0]),
            None if part is None else _ptr(part[1]), _ptr(dq), _ptr(dk),
            _ptr(dv), B, H, Hkv, Sq, Sk, d, int(causal), float(scale),
            _stream(q.device))
    else:
        delta = torch.empty((B, H, Sq), dtype=torch.float32,
                            device=q.device)
        rc = _bwd_lib()(_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do),
                        _ptr(lse), _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv),
                        B, H, Hkv, Sq, Sk, d, int(causal), float(scale),
                        _DTYPE_CODE[q.dtype], _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd {variant} kernel launch "
                           f"failed (code {rc})")
    flash_attention_bwd.launches += 1
    if variant == "wgmma":
        flash_attention_bwd.wgmma_launches += 1
    elif variant == "tf32x3":
        flash_attention_bwd.tf32x3_launches += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_fwd`` given its (o, lse) and the
    output gradient ``do``; each in its operand's dtype. Operands must
    be contiguous."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, o, lse, do, causal, scale)
    return _bwd_cuda(q, k, v, o, lse, do, causal, scale)


flash_attention_bwd.launches = 0
flash_attention_bwd.wgmma_launches = 0
flash_attention_bwd.tf32x3_launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel with the backward kernels as its gradient. Saves
    q, k, v, o and the fp32 log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Fused attention. q: (B, H, Sq, d); k, v: (B, H_kv, Sk, d) (GQA ok).

    Returns (B, H, Sq, d) in q.dtype, differentiable in q, k and v.
    ``block_q``/``block_k`` are kept for parity with the reference's
    signature; the CUDA kernels choose their own tiles and the result does
    not depend on them. Non-contiguous operands (a head axis moved in front of the
    sequence) are copied to contiguous ones first.
    """
    del block_q, block_k
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"heads {q.shape[1]} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttentionFn.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal, float(scale))


flash_attention.launches = 0
flash_attention.wgmma_launches = 0
flash_attention.tf32x3_launches = 0
