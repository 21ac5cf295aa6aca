"""Mamba-2 SSD (state-space duality) chunked scan as hand-written Hopper
kernels, forward and backward.

Counterpart of ``repro.kernels.ssd_scan``, whose Pallas kernel
``_ssd_kernel`` the forward replaces. The selective-state recurrence

    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * outer(B_t, x_t)     [N, P]
    y_t = C_t @ h_t + D_h * x_t                                  [P]

is computed chunk by chunk: inside a chunk of Q tokens an ``exp(segsum)``
masked product ``(C B^T o decay) x`` plus ``exp(s_t) C h_in``; between
chunks an (N, P) fp32 state carries ``h_out = exp(s_Q) h_in + sum_u
exp(s_Q - s_u) dt_u B_u x_u^T``; at the end ``D x``. The forward also
returns the chunk-start states h_in, (B, H, n_chunks, N, P) fp32, which
the backward reads.

The backward has no TPU counterpart: JAX cannot differentiate through
the Pallas call. Its derivation is in ``_bwd_plain``; ``SSDScanFn`` ties
the two into a ``torch.autograd.Function`` and ``ssd_scan`` is the entry
point.

Two kernel variants, both for (d_state N, head dim P) = (128, 64)
(mamba2-780m) and (64, 64) (zamba2-7b), chosen by dtype in ``_variant``.
Both run Mamba-2's chunked SSD decomposition with every chunk in
parallel (chunk states, an elementwise state pass, chunk outputs with C
B^T shared by a block of heads; backward the chunk terms of dh, a
reverse pass, a t-side and a u-side of every chunk):

- ``"wgmma"``: bf16,
  ``csrc/ssd_scan_sm90.cu`` and ``csrc/ssd_scan_bwd_sm90.cu``: wgmma,
  bf16 operands into fp32 products (``_fwd_rounded`` and ``_bwd_rounded``
  model its rounding points in plain PyTorch, at either N: d_state changes
  the kernels' tile counts and k-steps, not where they round);
- ``"tf32x3"``: fp32 (the parity runs), ``csrc/ssd_scan_tf32x3.cu`` and
  ``csrc/ssd_scan_bwd_tf32x3.cu``: mma.sync on the tensor cores in 3xTF32
  (each operand split into two TF32 halves, three products a pair, fp32
  accuracy to a few ulps) on cp.async-staged tiles (``_fwd_tf32x3`` and
  ``_bwd_tf32x3`` model the split in plain PyTorch).

The wrapper keeps the reference's contract: ``chunk = min(chunk, max(L,
8))``, the sequence padded to a chunk multiple with padded tokens at
``dt = 0`` (the identity), output in ``x.dtype``, ``H % G == 0``. Each
wrapper takes the plain PyTorch version only for tensors on the CPU; for
CUDA tensors it launches its variant's kernel or raises. The forward
counts its launches in ``ssd_scan.launches``, the backward in
``ssd_scan_bwd.launches``; the wgmma and tf32x3 launches among them also
in ``ssd_scan.wgmma_launches`` / ``ssd_scan.tf32x3_launches`` and
``ssd_scan_bwd.wgmma_launches`` / ``ssd_scan_bwd.tf32x3_launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import _split_tf32
from repro_torch.kernels.flash_decode import _ptr, _stream

DEFAULT_CHUNK = 128
MAX_CHUNK = 128                  # rows of the kernels' chunk tiles
SUPPORTED_NP = ((128, 64), (64, 64))   # (d_state N, head dim P) built
HEAD_BLOCKS = (6, 4, 3, 2, 1)    # heads of one group per wgmma CTA
DEC_ROWS = 128                   # row stride of the wgmma kernels' scratch
VARIANTS = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}


def _variant(dtype: torch.dtype, N: int, P: int) -> str:
    """The kernel variant of operands of ``dtype`` with d_state ``N`` and
    head dim ``P``: at an (N, P) of ``SUPPORTED_NP``, ``"wgmma"`` for bf16
    and ``"tf32x3"`` for fp32. Each (dtype, N, P) has exactly one
    kernel; any other case was not built and raises."""
    if (N, P) not in SUPPORTED_NP or dtype not in VARIANTS:
        raise ValueError(f"ssd_scan: {dtype} with (d_state, head dim) "
                         f"({N}, {P}) not built (built: float32 and "
                         f"bfloat16 with {SUPPORTED_NP})")
    return VARIANTS[dtype]


def _head_block(rep: int) -> int:
    """Heads per CTA of the wgmma kernels: the largest of ``HEAD_BLOCKS``
    that divides the group size ``rep`` (mamba2-780m: 48 heads in one
    group, so 6 and 512 CTAs at B 4, L 2048: C B^T shared by six heads
    in the forward, and about four waves of CTAs over 132 SMs; zamba2-7b:
    112 heads in one group, so 4 and 896 CTAs at B 2, L 2048)."""
    return next(hb for hb in HEAD_BLOCKS if rep % hb == 0)


def _tf32x3_head_block(rep: int, ctas_per_head: int, n_sm: int) -> int:
    """Heads per CTA of the tf32x3 forward's output kernel: the divisor hb
    of the group size ``rep`` with the least ``waves x (1 + hb)``, a CTA's
    time being C B^T (about one head's products) and hb heads, and
    ``waves`` its grid of ``ctas_per_head x rep / hb`` CTAs (``ctas_per_head``
    = batch x chunks x groups) over ``n_sm`` SMs at one CTA an SM; the
    smaller hb on a tie. At B 2, L 500 on 132 SMs: mamba2-780m's 48 heads
    take 3 (128 CTAs), zamba2-7b's 112 take 7 (128 CTAs)."""
    def cost(hb):
        return -(-ctas_per_head * rep // hb // n_sm) * (1 + hb)
    return min((hb for hb in range(1, rep + 1) if rep % hb == 0),
               key=lambda hb: (cost(hb), hb))


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fwd_tf32x3_lib():
    from repro_torch.kernels import build
    fn = build.load("ssd_scan_tf32x3").pam_ssd_scan_fwd_tf32x3
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    return fn


def _bwd_tf32x3_lib():
    from repro_torch.kernels import build
    fn = build.load("ssd_scan_bwd_tf32x3").pam_ssd_scan_bwd_tf32x3
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    return fn


def _fwd_sm90_lib():
    from repro_torch.kernels import build
    fn = build.load("ssd_scan_sm90").pam_ssd_scan_fwd_sm90
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    return fn


def _bwd_sm90_lib():
    from repro_torch.kernels import build
    fn = build.load("ssd_scan_bwd_sm90").pam_ssd_scan_bwd_sm90
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    return fn


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' accumulation type: fp32, or float64
    for float64 operands."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def chunk_len(L: int, chunk: int) -> tuple[int, int]:
    """(chunk, padded length) as the reference's wrapper chooses them."""
    chunk = min(chunk, max(L, 8))
    return chunk, L + (chunk - L % chunk) % chunk


def _pad(t: torch.Tensor, Lp: int) -> torch.Tensor:
    """Zero-pad the sequence axis (1) to ``Lp``."""
    pad = Lp - t.shape[1]
    if not pad:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


# ------------------------------------------------------------ oracle
def ssd_scan_ref(x, dt, a, b, c, d_skip) -> torch.Tensor:
    """Sequential (scan) oracle of the SSD recurrence, one token at a
    time (counterpart of ``repro.kernels.ref.ssd_scan_ref``)."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    bh = _acc(b).repeat_interleave(rep, dim=2)
    ch = _acc(c).repeat_interleave(rep, dim=2)
    xf, dtf, af = _acc(x), _acc(dt), _acc(a)
    h = torch.zeros((B, H, N, P), dtype=xf.dtype, device=x.device)
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * af)[..., None, None]
        upd = (dtf[:, t, :, None, None] * bh[:, t, :, :, None]
               * xf[:, t, :, None, :])
        h = decay * h + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t], h))
    y = torch.stack(ys, dim=1) + _acc(d_skip)[None, None, :, None] * xf
    return y.to(x.dtype)


# ------------------------------------------------------------ forward
def _chunks(x, dt, b, c, chunk):
    """Padded operands split into chunks, heads broadcast over groups:
    x (B, nc, Q, H, P), dt (B, nc, Q, H), b/c (B, nc, Q, H, N), all in
    the accumulation type."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Q, Lp = chunk_len(L, chunk)
    nc = Lp // Q
    rep = H // G

    def split(t, *tail):
        return _acc(_pad(t, Lp)).reshape(B, nc, Q, *tail)
    return (split(x, H, P), split(dt, H),
            split(b.repeat_interleave(rep, dim=2), H, N),
            split(c.repeat_interleave(rep, dim=2), H, N), Q, nc)


def segsum_decay(s: torch.Tensor) -> torch.Tensor:
    """E[..., t, u, h] = exp(s_t - s_u) for u <= t, else 0; masked before
    the exp (upper-triangle gaps are positive and overflow). s: (..., Q,
    H)."""
    Q = s.shape[-2]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=s.device).tril()
    gap = s[..., :, None, :] - s[..., None, :, :]
    return torch.exp(torch.where(tri[:, :, None], gap,
                                 torch.full_like(gap, float("-inf"))))


def ssd_chunked_states(x, dt, a, b, c, d_skip, chunk):
    """Plain PyTorch version of the forward kernel, the one plain chunked
    forward of the port: every chunk's intra-chunk masked product at
    once, then a sequential pass of the states and the ``C h_in`` term.
    Returns (y (B, L, H, P) in x.dtype, chunk-start states (B, H, nc, N,
    P) and the final state h_L (B, H, N, P), both in the accumulation
    type)."""
    B, L, H, P = x.shape
    xf, dtf, bh, ch, Q, nc = _chunks(x, dt, b, c, chunk)
    af, df = _acc(a), _acc(d_skip)
    s = torch.cumsum(dtf * af, dim=2)                    # (B, nc, Q, H)
    m = (torch.einsum("bcthn,bcuhn->bctuh", ch, bh) * segsum_decay(s)
         * dtf[:, :, None])
    y = torch.einsum("bctuh,bcuhp->bcthp", m, xf)
    w = torch.exp(s[:, :, -1:] - s) * dtf                # (B, nc, Q, H)
    dstate = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", w, bh, xf)
    e_last = torch.exp(s[:, :, -1])                      # (B, nc, H)
    h = torch.zeros((B, H, b.shape[3], P), dtype=xf.dtype, device=x.device)
    states = []
    for ic in range(nc):
        states.append(h)
        h = e_last[:, ic, :, None, None] * h + dstate[:, ic]
    states = torch.stack(states, dim=2)                  # (B, H, nc, N, P)
    y = (y + torch.exp(s)[..., None]
         * torch.einsum("bcthn,bhcnp->bcthp", ch, states)
         + df[:, None] * xf)
    return y.reshape(B, nc * Q, H, P)[:, :L].to(x.dtype), states, h


def _bf16(t: torch.Tensor, on: bool) -> torch.Tensor:
    """``t`` rounded to bf16 and back when ``on`` (a tensor-core operand of
    the wgmma kernels), else ``t``."""
    return t.bfloat16().to(t.dtype) if on else t


def _bf16_pair(t: torch.Tensor, on: bool) -> torch.Tensor:
    """``t`` as the sum of a hi / lo pair of bf16 operands when ``on``
    (hi = bf16(t), lo = bf16(t - hi): about 16 bits of mantissa), else
    ``t``."""
    if not on:
        return t
    hi = _bf16(t, True)
    return hi + _bf16(t - hi, True)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
            tf32: bool) -> torch.Tensor:
    """``einsum(eq, a, b)``, or with ``tf32`` as the tf32x3 kernels take the
    product: every operand split into TF32 halves (``_split_tf32``), lo_a
    hi_b + hi_a lo_b, then + hi_a hi_b (each elementary product exact in
    fp32, the sums fp32)."""
    if not tf32:
        return torch.einsum(eq, a, b)
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    return ((torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl))
            + torch.einsum(eq, ah, bh))


def _decay(dtf, af):
    """The tensor-core kernels' decay terms per (batch, chunk, token, head): s
    (in-chunk inclusive prefix sum of dt a), exp(s), w = exp(s_Q - s) dt
    and exp(s_Q) per chunk."""
    s = torch.cumsum(dtf * af, dim=2)                    # (B, nc, Q, H)
    return s, torch.exp(s), torch.exp(s[:, :, -1:] - s) * dtf, \
        torch.exp(s[:, :, -1])


def _fwd_rounded(x, dt, a, b, c, d_skip, chunk, round_bf16: bool = True,
                 tf32: bool = False):
    """Plain PyTorch model of the wgmma forward (``csrc/ssd_scan_sm90.cu``;
    tests and ``chip_smoke.py`` only, never on the main path), in its
    decomposition and with its bf16 operands when ``round_bf16``; with
    ``tf32`` (and ``round_bf16`` off) every product in 3xTF32 as the tf32x3
    forward (``csrc/ssd_scan_tf32x3.cu``) takes it (``_einsum``):

    1. decay terms s, exp(s), w, exp(s_Q) per chunk (``_decay``);
    2. chunk states U_c = sum_u B_u (w_u x_u)^T, w x a hi / lo bf16 pair;
    3. the state pass h_{c+1} = exp(s_Q) h_c + U_c in fp32;
    4. chunk outputs y = exp(s_t) (C h_in)_t + (M x)_t + D x_t with M = S
       o E dt_u (S = C B^T, E the masked exp(s_t - s_u)) and h_in each a
       hi / lo bf16 pair, the products accumulating in fp32.

    The pairs (``_bf16_pair``) keep the forward within the bf16 tolerance
    of the plain version where y is a small difference of large terms
    (slow decay) and the states within 1e-3 of their largest entry; one
    bf16 rounding of each would not.

    Returns (y in x.dtype, chunk-start states (B, H, nc, N, P))."""
    B, L, H, P = x.shape
    xf, dtf, bh, ch, Q, nc = _chunks(x, dt, b, c, chunk)
    s, es, w, e_last = _decay(dtf, _acc(a))

    def ein(eq, p, q):
        return _einsum(eq, p, q, tf32)
    u = ein("bcqhn,bcqhp->bchnp", bh,
            _bf16_pair(w[..., None] * xf, round_bf16))
    h = torch.zeros_like(u[:, 0])
    states = []
    for ic in range(nc):
        states.append(h)
        h = e_last[:, ic, :, None, None] * h + u[:, ic]
    states = torch.stack(states, dim=2)                  # (B, H, nc, N, P)
    m = _bf16_pair(ein("bcthn,bcuhn->bctuh", ch, bh)
                   * segsum_decay(s) * dtf[:, :, None], round_bf16)
    y = (es[..., None] * ein("bcthn,bhcnp->bcthp", ch,
                             _bf16_pair(states, round_bf16))
         + ein("bctuh,bcuhp->bcthp", m, xf)
         + _acc(d_skip)[:, None] * xf)
    return y.reshape(B, nc * Q, H, P)[:, :L].to(x.dtype), states


def _fwd_tf32x3(x, dt, a, b, c, d_skip, chunk):
    """Plain PyTorch model of the tf32x3 forward's split (tests and
    ``chip_smoke.py`` only): ``_fwd_rounded`` with every product in
    3xTF32 and no bf16 rounding. Returns (y, chunk-start states)."""
    return _fwd_rounded(x, dt, a, b, c, d_skip, chunk, round_bf16=False,
                        tf32=True)


def _check_cuda(name: str, x, dt, a, b, c, d_skip, chunk) -> str:
    """Checks what the kernels need; returns the variant."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    variant = _variant(x.dtype, N, P)
    if chunk_len(L, chunk)[0] > MAX_CHUNK:
        raise ValueError(f"{name}: chunk {chunk} > {MAX_CHUNK}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"{name}: x/b/c dtypes {x.dtype}/{b.dtype}/"
                         f"{c.dtype} differ")
    for t in (dt, a, d_skip):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dt, a and d_skip must be float32")
    for t in (x, dt, a, b, c, d_skip):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be CUDA tensors")
    for t, inner in ((x, P), (b, N), (c, N)):
        if t.stride(3) != 1 or t.stride(2) != inner:
            raise ValueError(f"{name}: the last two axes of x, b and c must "
                             f"be contiguous (views of the conv output are "
                             f"fine)")
    for t in (dt, a, d_skip):
        if not t.is_contiguous():
            raise ValueError(f"{name}: dt, a and d_skip must be contiguous")
    # wgmma: TMA; tf32x3: 16-byte cp.async copies. Either way base
    # addresses and batch / sequence strides in 16-byte units.
    how = "by TMA" if variant == "wgmma" else "in 16-byte copies"
    for t in (x, b, c):
        if t.data_ptr() % 16 or any(t.stride(i) * t.element_size() % 16
                                    for i in (0, 1)):
            raise ValueError(f"{name}: the {variant} kernels read x, b and "
                             f"c {how}: base address and batch / sequence "
                             f"strides must be multiples of 16 bytes")
    return variant


def _strides(x, b, c) -> list[int]:
    """Batch and sequence strides (elements) of x, b and c."""
    return [x.stride(0), x.stride(1), b.stride(0), b.stride(1),
            c.stride(0), c.stride(1)]


def _fwd_cuda(x, dt, a, b, c, d_skip, chunk):
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    variant = _check_cuda("ssd_scan", x, dt, a, b, c, d_skip, chunk)
    Q, Lp = chunk_len(L, chunk)
    nc = Lp // Q
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=x.device)
    states = torch.empty((B, H, nc, N, P), dtype=torch.float32,
                         device=x.device)
    dec = torch.empty((2, B, H, nc, DEC_ROWS), dtype=torch.float32,
                      device=x.device)               # s_t, masked dt
    rep = H // G
    if variant == "wgmma":
        hb, lib = _head_block(rep), _fwd_sm90_lib()
    else:
        hb = _tf32x3_head_block(rep, B * nc * G, _n_sm(x.device.index))
        lib = _fwd_tf32x3_lib()
    rc = lib(_ptr(x), _ptr(dt), _ptr(a), _ptr(b), _ptr(c), _ptr(d_skip),
             _ptr(y), _ptr(states), _ptr(dec), B, L, H, G, Q, nc, hb, N,
             *_strides(x, b, c), _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"ssd_scan {variant} kernel launch failed "
                           f"(code {rc})")
    ssd_scan.launches += 1
    if variant == "wgmma":
        ssd_scan.wgmma_launches += 1
    else:
        ssd_scan.tf32x3_launches += 1
    return y, states


def ssd_scan_fwd(x, dt, a, b, c, d_skip, *, chunk: int = DEFAULT_CHUNK
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward without autograd: (y (B, L, H, P) in x.dtype, chunk-start
    states (B, H, nc, N, P) fp32)."""
    if x.device.type == "cpu":
        return ssd_chunked_states(x, dt, a, b, c, d_skip, chunk)[:2]
    return _fwd_cuda(x, dt, a, b, c, d_skip, chunk)


# ------------------------------------------------------------ backward
def _bwd_plain(x, dt, a, b, c, d_skip, states, dy, chunk):
    """Plain PyTorch version of the backward kernels, in their order.

    Per chunk, with s_t = sum_{u<=t} dt_u a (in-chunk cumsum), es_t =
    exp(s_t), E_tu = exp(s_t - s_u) [u <= t], w_u = exp(s_Q - s_u) dt_u,
    g = dy, h_in the saved chunk-start state and dh the gradient of the
    chunk's final state h_out:

    1. (reverse pass over chunks) dh of chunk c-1 = dh_in of chunk c =
       exp(s_Q) dh + sum_t es_t C_t g_t^T; zero for the last chunk.
    2. (each chunk on its own) S' = C B^T, G = g x^T, A' = S' o G o E,
       A = A' dt_u (column-wise);
       dx = (S' o E dt_u)^T g + w o (B dh) + D g;
       dC = es o (g h_in^T) + (G o E dt_u) B;
       dB = (G o E dt_u)^T C + w o (x dh^T);
       beta_u = x_u . (B dh)_u;
       ds_t = es_t g_t . (C h_in)_t + rowsum_t A - colsum_t A - w_t beta_t,
       plus exp(s_Q) <dh, h_in> + sum_u w_u beta_u at t = Q - 1;
       dla = reverse cumsum of ds over the chunk;
       ddt = colsum A' + exp(s_Q - s) beta + a dla;
       da = sum dla dt; dD = sum g . x.
    3. dB and dC summed over the heads of each group.

    Padded tokens (dt = 0) get no gradient. Returns (dx, ddt, da, db,
    dc, dd), each in its operand's dtype.
    """
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    xf, dtf, bh, ch, Q, nc = _chunks(x, dt, b, c, chunk)
    g = _acc(_pad(dy, nc * Q)).reshape(B, nc, Q, H, P)
    af, df = _acc(a), _acc(d_skip)
    hin = _acc(states)                                   # (B, H, nc, N, P)
    s = torch.cumsum(dtf * af, dim=2)                    # (B, nc, Q, H)
    es = torch.exp(s)
    e_last = torch.exp(s[:, :, -1])                      # (B, nc, H)
    w = torch.exp(s[:, :, -1:] - s) * dtf
    # 1. reverse state-gradient pass
    dh = torch.zeros_like(hin[:, :, 0])
    dhs = [None] * nc
    for ic in range(nc - 1, -1, -1):
        dhs[ic] = dh
        dh = (e_last[:, ic, :, None, None] * dh
              + torch.einsum("bqh,bqhn,bqhp->bhnp", es[:, ic], ch[:, ic],
                             g[:, ic]))
    dh = torch.stack(dhs, dim=2)                         # (B, H, nc, N, P)
    # 2. every chunk on its own
    E = segsum_decay(s)                                  # (B, nc, Q, Q, H)
    dt_u = dtf[:, :, None]                               # over u
    SE = torch.einsum("bcthn,bcuhn->bctuh", ch, bh) * E
    Gm = torch.einsum("bcthp,bcuhp->bctuh", g, xf)
    GE = Gm * E
    Ap = SE * Gm
    A = Ap * dt_u
    bdh = torch.einsum("bcuhn,bhcnp->bcuhp", bh, dh)
    chin = torch.einsum("bcthn,bhcnp->bcthp", ch, hin)
    dx = (torch.einsum("bctuh,bcthp->bcuhp", SE * dt_u, g)
          + w[..., None] * bdh + df[:, None] * g)
    dc = (es[..., None] * torch.einsum("bcthp,bhcnp->bcthn", g, hin)
          + torch.einsum("bctuh,bcuhn->bcthn", GE * dt_u, bh))
    db = (torch.einsum("bctuh,bcthn->bcuhn", GE * dt_u, ch)
          + w[..., None] * torch.einsum("bcuhp,bhcnp->bcuhn", xf, dh))
    beta = torch.sum(xf * bdh, dim=-1)                   # (B, nc, Q, H)
    colp = torch.sum(Ap, dim=2)                          # over t
    ds = (es * torch.sum(g * chin, dim=-1) + torch.sum(A, dim=3)
          - dtf * colp - w * beta)
    last = (e_last * torch.einsum("bhcnp,bhcnp->bch", dh, hin)
            + torch.sum(w * beta, dim=2))
    ds = torch.cat([ds[:, :, :-1], ds[:, :, -1:] + last[:, :, None]], dim=2)
    dla = torch.flip(torch.cumsum(torch.flip(ds, [2]), dim=2), [2])
    ddt = colp + torch.exp(s[:, :, -1:] - s) * beta + af * dla
    da = torch.sum(dla * dtf, dim=(0, 1, 2))
    dd = torch.sum(g * xf, dim=(0, 1, 2, 4))
    # 3. unpad, and sum dB / dC over each group's heads

    def seq(t, *tail):
        return t.reshape(B, nc * Q, *tail)[:, :L]
    db = seq(db, H, N).reshape(B, L, G, H // G, N).sum(dim=3)
    dc = seq(dc, H, N).reshape(B, L, G, H // G, N).sum(dim=3)
    return (seq(dx, H, P).to(x.dtype), seq(ddt, H).to(dt.dtype),
            da.to(a.dtype), db.to(b.dtype), dc.to(c.dtype),
            dd.to(d_skip.dtype))


def _bwd_rounded(x, dt, a, b, c, d_skip, states, dy, chunk,
                 round_bf16: bool = True, tf32: bool = False):
    """Plain PyTorch model of the wgmma backward
    (``csrc/ssd_scan_bwd_sm90.cu``; tests and ``chip_smoke.py`` only), in
    its decomposition and with its bf16 roundings when ``round_bf16``; with
    ``tf32`` (and ``round_bf16`` off) every product in 3xTF32 as the tf32x3
    backward (``csrc/ssd_scan_bwd_tf32x3.cu``) takes it (``_einsum``; that
    kernel takes g . (C h_in) as C . (g h_in^T), the same products in
    another order of fp32 sums):

    1. dstate: V_c = sum_t C_t (exp(s_t) g_t)^T, exp(s) g rounded, then the
       reverse pass dh_{c-1} = exp(s_Q) dh_c + V_c in fp32;
    2. the t-side of each chunk: S' = C B^T, G = g x^T, A' = S' o E o G
       (fp32: its row sums), Pb = G o E dt_u rounded, dC = (exp(s) g)
       h_in^T + Pb B over the group's heads, and C h_in for ds; h_in
       rounded;
    3. the u-side: the column sums of A', dB = (w x) dh^T + Pb^T C over
       the group's heads, B dh and beta = x . (B dh), dx = (S' o E
       dt_u)^T g + w B dh + D g with S' o E dt_u rounded; dh rounded;
    4. ds, its reverse cumsum dla, ddt, and the da and dD sums in fp32;
       <dh, h_in> from the fp32 states.

    Returns (dx, ddt, da, db, dc, dd), each in its operand's dtype."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    r = round_bf16
    xf, dtf, bh, ch, Q, nc = _chunks(x, dt, b, c, chunk)
    g = _acc(_pad(dy, nc * Q)).reshape(B, nc, Q, H, P)
    af, df = _acc(a), _acc(d_skip)
    hin = _acc(states)                                   # (B, H, nc, N, P)
    s, es, w, e_last = _decay(dtf, af)

    def ein(eq, p, q):
        return _einsum(eq, p, q, tf32)
    # 1. dstate
    v = ein("bcqhn,bcqhp->bchnp", ch, _bf16(es[..., None] * g, r))
    dh = torch.zeros_like(hin[:, :, 0])
    dhs = [None] * nc
    for ic in range(nc - 1, -1, -1):
        dhs[ic] = dh
        dh = e_last[:, ic, :, None, None] * dh + v[:, ic]
    dh = torch.stack(dhs, dim=2)                         # (B, H, nc, N, P)
    hin_r, dh_r = _bf16(hin, r), _bf16(dh, r)
    # 2. t-side
    E = segsum_decay(s)                                  # (B, nc, Q, Q, H)
    dt_u = dtf[:, :, None]
    SE = ein("bcthn,bcuhn->bctuh", ch, bh) * E
    Gm = ein("bcthp,bcuhp->bctuh", g, xf)
    Ap = SE * Gm
    Pb = _bf16(Gm * E * dt_u, r)
    dc = (ein("bcthp,bhcnp->bcthn", _bf16(es[..., None] * g, r), hin_r)
          + ein("bctuh,bcuhn->bcthn", Pb, bh))
    chin = ein("bcthn,bhcnp->bcthp", ch, hin_r)
    # 3. u-side
    db = (ein("bcuhp,bhcnp->bcuhn", _bf16(w[..., None] * xf, r), dh_r)
          + ein("bctuh,bcthn->bcuhn", Pb, ch))
    bdh = ein("bcuhn,bhcnp->bcuhp", bh, dh_r)
    beta = torch.sum(xf * bdh, dim=-1)                   # (B, nc, Q, H)
    dx = (ein("bctuh,bcthp->bcuhp", _bf16(SE * dt_u, r), g)
          + w[..., None] * bdh + df[:, None] * g)
    colp = torch.sum(Ap, dim=2)                          # over t
    # 4. ds, dla, ddt, da, dD
    ds = (es * torch.sum(g * chin, dim=-1) + torch.sum(Ap * dt_u, dim=3)
          - dtf * colp - w * beta)
    last = (e_last * torch.einsum("bhcnp,bhcnp->bch", dh, hin)
            + torch.sum(w * beta, dim=2))
    ds = torch.cat([ds[:, :, :-1], ds[:, :, -1:] + last[:, :, None]], dim=2)
    dla = torch.flip(torch.cumsum(torch.flip(ds, [2]), dim=2), [2])
    ddt = colp + torch.exp(s[:, :, -1:] - s) * beta + af * dla
    da = torch.sum(dla * dtf, dim=(0, 1, 2))
    dd = torch.sum(g * xf, dim=(0, 1, 2, 4))

    def seq(t, *tail):
        return t.reshape(B, nc * Q, *tail)[:, :L]
    db = seq(db, H, N).reshape(B, L, G, H // G, N).sum(dim=3)
    dc = seq(dc, H, N).reshape(B, L, G, H // G, N).sum(dim=3)
    return (seq(dx, H, P).to(x.dtype), seq(ddt, H).to(dt.dtype),
            da.to(a.dtype), db.to(b.dtype), dc.to(c.dtype),
            dd.to(d_skip.dtype))


def _bwd_tf32x3(x, dt, a, b, c, d_skip, states, dy, chunk):
    """Plain PyTorch model of the tf32x3 backward's split (tests and
    ``chip_smoke.py`` only): ``_bwd_rounded`` with every product in
    3xTF32 and no bf16 rounding. Returns (dx, ddt, da, db, dc, dd)."""
    return _bwd_rounded(x, dt, a, b, c, d_skip, states, dy, chunk,
                        round_bf16=False, tf32=True)


# A tf32x3 result's norm-wise error against the plain versions in float64
# may be at most this many times the fp32 plain versions' own (floored at
# the split's 2^-22). Kernel and model differ from the fp32 plain versions
# by fp32 sums in another order, elementwise as much as the plain versions
# differ from float64, so only the float64 reference tells the 2^-22 of a
# 3xTF32 product from the 2^-11 of one TF32 product or of a split that
# drops a cross term: those put y, the states, dx, ddt, dB and dC tens to
# hundreds of times the fp32 plain versions' error.
F64_RATIO = 10.0
WITNESS_FWD = ("y", "states")
WITNESS_BWD = ("dx", "ddt", "da", "db", "dc", "dd")


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref||, in float64 (the absolute norm where ref
    is zero)."""
    ref = ref.double()
    num = float((got.double() - ref).norm())
    den = float(ref.norm())
    return num / den if den else num


def _f64_witness(ins, dy, chunk, y, states, grads) -> dict:
    """A fp32 scan result (y, the chunk-start states, and the six
    gradients of the backward fed those states) against the plain
    versions in float64, norm-wise, beside the plain versions in fp32
    against the same (tests and ``chip_smoke.py`` only). Returns {leaf:
    (error, the fp32 plain version's error)} over ``WITNESS_FWD`` and
    ``WITNESS_BWD``."""
    ins64 = [t.double() for t in ins]
    y64, st64, _ = ssd_chunked_states(*ins64, chunk)
    g64 = _bwd_plain(*ins64, st64, dy.double(), chunk)
    y32, st32, _ = ssd_chunked_states(*ins, chunk)
    g32 = _bwd_plain(*ins, st32, dy, chunk)
    return {n: (_rel_err(got, ref), _rel_err(plain, ref))
            for n, got, plain, ref in zip(
                WITNESS_FWD + WITNESS_BWD, (y, states, *grads),
                (y32, st32, *g32), (y64, st64, *g64))}


def _f64_within(witness: dict, leaves) -> bool:
    """Every leaf of ``witness`` among ``leaves`` within ``F64_RATIO``
    times the fp32 plain versions' error (at least 2^-22)."""
    return all(err <= F64_RATIO * max(plain, 2.0 ** -22)
               for n, (err, plain) in witness.items() if n in leaves)


def _bwd_cuda(x, dt, a, b, c, d_skip, states, dy, chunk):
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    variant = _check_cuda("ssd_scan_bwd", x, dt, a, b, c, d_skip, chunk)
    Q, Lp = chunk_len(L, chunk)
    nc = Lp // Q
    if dy.dtype != x.dtype or not dy.is_contiguous() or dy.data_ptr() % 16 \
            or states.shape != (B, H, nc, N, P) \
            or states.dtype != torch.float32 or not states.is_contiguous():
        raise ValueError("ssd_scan_bwd: dy must be contiguous in x's dtype, "
                         "16-byte aligned, and states the forward's (B, H, "
                         "nc, N, P) fp32")
    dev, f32 = x.device, torch.float32
    dx = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, L, H), dtype=f32, device=dev)
    da = torch.empty((H,), dtype=f32, device=dev)
    dd = torch.empty((H,), dtype=f32, device=dev)
    db = torch.empty((B, L, G, N), dtype=b.dtype, device=dev)
    dc = torch.empty((B, L, G, N), dtype=c.dtype, device=dev)
    # scratch: decay rows, state gradients, the side kernels' row terms,
    # parts of <dh, h_in> (a warp's), partials of dB / dC (reduced over
    # each group's head blocks, or heads, in the kernels' last pass),
    # per-chunk partials of da / dD
    dec = torch.empty((2, B, H, nc, DEC_ROWS), dtype=f32, device=dev)
    dstates = torch.empty_like(states)
    rows = torch.empty((4, B, H, nc, DEC_ROWS), dtype=f32, device=dev)
    frob = torch.empty((B, H, nc, N * P // 128), dtype=f32, device=dev)
    da_part = torch.empty((B, H, nc), dtype=f32, device=dev)
    dd_part = torch.empty((B, H, nc), dtype=f32, device=dev)
    ptrs = [_ptr(t) for t in (x, dt, a, b, c, d_skip, states, dy, dx, ddt,
                              da, db, dc, dd, dec, dstates, frob, rows)]
    if variant == "wgmma":
        hb = _head_block(H // G)
        db_part = torch.empty((B, H // hb, Lp, N), dtype=f32, device=dev)
        dc_part = torch.empty_like(db_part)
        rc = _bwd_sm90_lib()(
            *ptrs, _ptr(db_part), _ptr(dc_part), _ptr(da_part),
            _ptr(dd_part), B, L, H, G, Q, nc, hb, N, *_strides(x, b, c),
            _stream(dev))
    else:
        # S' = C B^T of each (batch, group, chunk) and its transpose, read
        # by both side kernels
        sbuf = torch.empty((2, B, G, nc, DEC_ROWS, DEC_ROWS), dtype=f32,
                           device=dev)
        db_part = torch.empty((B, H, Lp, N), dtype=f32, device=dev)
        dc_part = torch.empty_like(db_part)
        rc = _bwd_tf32x3_lib()(
            *ptrs, _ptr(sbuf), _ptr(db_part), _ptr(dc_part), _ptr(da_part),
            _ptr(dd_part), B, L, H, G, Q, nc, N, *_strides(x, b, c),
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd {variant} kernel launch failed "
                           f"(code {rc})")
    ssd_scan_bwd.launches += 1
    if variant == "wgmma":
        ssd_scan_bwd.wgmma_launches += 1
    else:
        ssd_scan_bwd.tf32x3_launches += 1
    return dx, ddt, da, db, dc, dd


def ssd_scan_bwd(x, dt, a, b, c, d_skip, states, dy, *,
                 chunk: int = DEFAULT_CHUNK):
    """(dx, ddt, da, db, dc, dd) of ``ssd_scan_fwd`` given its chunk-start
    ``states`` and the output gradient ``dy`` (contiguous, x's dtype);
    each in its operand's dtype."""
    if x.device.type == "cpu":
        return _bwd_plain(x, dt, a, b, c, d_skip, states, dy, chunk)
    return _bwd_cuda(x, dt, a, b, c, d_skip, states, dy, chunk)


ssd_scan_bwd.launches = 0
ssd_scan_bwd.wgmma_launches = 0
ssd_scan_bwd.tf32x3_launches = 0


def ssd_scan_plain_grads(x, dt, a, b, c, d_skip, dy, *,
                         chunk: int = DEFAULT_CHUNK):
    """Autograd of the plain forward: the six input gradients of
    ``sum(y * dy)``. A second, independent backward for the tests."""
    ins = [t.detach().clone().requires_grad_(True)
           for t in (x, dt, a, b, c, d_skip)]
    y = ssd_chunked_states(*ins, chunk)[0]
    return torch.autograd.grad(y, ins, dy)


class SSDScanFn(torch.autograd.Function):
    """The forward kernel with the backward kernels as its gradient.
    Saves the six inputs and the fp32 chunk-start states."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d_skip, chunk: int):
        y, states = ssd_scan_fwd(x, dt, a, b, c, d_skip, chunk=chunk)
        ctx.save_for_backward(x, dt, a, b, c, d_skip, states)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, a, b, c, d_skip, states = ctx.saved_tensors
        grads = ssd_scan_bwd(x, dt, a, b, c, d_skip, states,
                             dy.contiguous(), chunk=ctx.chunk)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
             chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Chunked SSD scan, differentiable in all six inputs.

    x: (B, L, H, P) inputs; dt: (B, L, H) post-softplus step sizes;
    a: (H,) negative decay rates; b, c: (B, L, G, N) input/output
    projections (G groups, H % G == 0); d_skip: (H,) skip gains.
    Returns y: (B, L, H, P) in x.dtype. On the card x, b and c may be
    views with any batch and sequence strides (the conv output's
    columns); their last two axes must be contiguous.
    """
    H, G = x.shape[2], b.shape[2]
    if H % G:
        raise ValueError(f"heads {H} not a multiple of groups {G}")
    return SSDScanFn.apply(x, dt.contiguous(), a.contiguous(), b, c,
                           d_skip.contiguous(), int(chunk))


ssd_scan.launches = 0
ssd_scan.wgmma_launches = 0
ssd_scan.tf32x3_launches = 0
