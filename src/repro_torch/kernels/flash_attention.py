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

Two kernel variants, one per (dtype, head dim), chosen by ``_variant``:

- ``"wgmma"``: bf16 with head dim 128 (every full-width model),
  ``csrc/flash_attention_sm90.cu`` and ``csrc/flash_attention_bwd_sm90.cu``:
  wgmma on 128-byte-swizzled bf16 tiles staged by TMA, P and dS rounded
  to bf16 as the second product's operand (``_fwd_rounded`` and
  ``_bwd_rounded`` model those rounding points in plain PyTorch);
- ``"cuda_core"``: fp32, and head dim 16 (the reduced configs),
  ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``: fp32
  products on the CUDA cores, exact to the plain versions up to the
  order of sums (fp32 wgmma would be TF32).

Each wrapper takes the plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches its variant's kernel or raises. The
forward counts kernel launches in ``flash_attention.launches``, the
backward in ``flash_attention_bwd.launches``; the wgmma launches among
them also in ``flash_attention.wgmma_launches`` and
``flash_attention_bwd.wgmma_launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.flash_decode import (_DTYPE_CODE, _check_cuda, _ptr,
                                              _stream)

NEG_INF = -1e30
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
SM90_PAD = 128          # row padding of the wgmma backward's fp32 scratch


def _variant(dtype: torch.dtype, d: int) -> str:
    """The kernel variant of operands of ``dtype`` and head dim ``d``:
    ``"wgmma"`` for bf16 with d = 128, ``"cuda_core"`` otherwise (fp32,
    or d = 16). Each (dtype, d, group) has exactly one kernel; a case
    that kernel was not built for raises in the wrapper."""
    return "wgmma" if dtype == torch.bfloat16 and d == 128 else "cuda_core"


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
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _bwd_sm90_lib():
    from repro_torch.kernels import build
    fn = build.load("flash_attention_bwd_sm90").pam_flash_attention_bwd_sm90
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


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
def _fwd_math(q, k, v, causal, scale, round_p):
    """One masked softmax with the kernels' sentinel and ``l_safe``; with
    ``round_p`` P is rounded to bf16 before P V (the row sums stay fp32)."""
    B, H, Sq, d = q.shape
    qg, kg, vg = _grouped(q, k, v)
    live = _live(Sq, k.shape[2], causal, q.device)
    s = torch.matmul(qg, kg.transpose(-1, -2)) * scale
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1)
    p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = torch.sum(p, dim=-1)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    pv = _acc(p.bfloat16()) if round_p else p
    o = torch.matmul(pv, vg) / l_safe[..., None]
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


def _check_args(name, q, k, v):
    if k.dtype not in _DTYPE_CODE or q.dtype != k.dtype \
            or v.dtype != k.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype} "
                         f"not built (float32 or bfloat16, all alike)")


def _fwd_cuda(q, k, v, causal, scale):
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    _check_args("flash_attention", q, k, v)
    _check_cuda("flash_attention", d, H // Hkv, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    variant = _variant(q.dtype, d)
    if variant == "wgmma":
        rc = _fwd_sm90_lib()(_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse),
                             B, H, Hkv, Sq, Sk, int(causal), float(scale),
                             _stream(q.device))
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
def _bwd_math(q, k, v, o, lse, do, causal, scale, rounded):
    """P = exp(S - LSE), Delta = rowsum(dO * O), dV = P^T dO, dP = dO V^T,
    dS = P (dP - Delta), dQ = scale dS K, dK = scale dS^T Q, with the GQA
    group's query heads summed into their kv head; with ``rounded`` P is
    rounded to bf16 before dV and dS before dQ and dK."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = H // Hkv
    qg, kg, vg = _grouped(q, k, v)
    dog = _acc(do).reshape(B, Hkv, rep, Sq, d)
    lse_g = lse.reshape(B, Hkv, rep, Sq, 1)
    delta = torch.sum(dog * _acc(o).reshape(B, Hkv, rep, Sq, d), dim=-1,
                      keepdim=True)
    live = _live(Sq, Sk, causal, q.device)
    s = torch.matmul(qg, kg.transpose(-1, -2)) * scale
    p = torch.where(live, torch.exp(s - lse_g), torch.zeros_like(s))
    pv = _acc(p.bfloat16()) if rounded else p
    dv = torch.sum(torch.matmul(pv.transpose(-1, -2), dog), dim=2)
    dp = torch.matmul(dog, vg.transpose(-1, -2))
    ds = p * (dp - delta)
    if rounded:
        ds = _acc(ds.bfloat16())
    dq = torch.matmul(ds, kg) * scale
    dk = torch.sum(torch.matmul(ds.transpose(-1, -2), qg), dim=2) * scale
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


def _bwd_cuda(q, k, v, o, lse, do, causal, scale):
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    _check_args("flash_attention_bwd", q, k, v)
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: o and do must have q's "
                         "dtype")
    _check_cuda("flash_attention_bwd", d, H // Hkv, q, k, v, o, lse, do)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    variant = _variant(q.dtype, d)
    if variant == "wgmma":
        pad = -(-Sq // SM90_PAD) * SM90_PAD
        scratch = torch.empty((2, B, H, pad), dtype=torch.float32,
                              device=q.device)        # delta, lse log2(e)
        rc = _bwd_sm90_lib()(_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do),
                             _ptr(lse), _ptr(scratch[0]), _ptr(scratch[1]),
                             _ptr(dq), _ptr(dk), _ptr(dv), B, H, Hkv, Sq,
                             Sk, pad, int(causal), float(scale),
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
