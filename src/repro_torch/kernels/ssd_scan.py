"""Mamba-2 SSD (state-space duality) chunked scan as hand-written Hopper
kernels, forward and backward.

Counterpart of ``repro.kernels.ssd_scan``, whose Pallas kernel
``_ssd_kernel`` the forward replaces (CUDA source ``csrc/ssd_scan.cu``).
The selective-state recurrence

    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * outer(B_t, x_t)     [N, P]
    y_t = C_t @ h_t + D_h * x_t                                  [P]

is computed chunk by chunk: inside a chunk of Q tokens an ``exp(segsum)``
masked product ``(C B^T o decay) x`` plus ``exp(s_t) C h_in``; between
chunks an (N, P) fp32 state carries ``h_out = exp(s_Q) h_in + sum_u
exp(s_Q - s_u) dt_u B_u x_u^T``; at the end ``D x``. The forward also
returns the chunk-start states h_in, (B, H, n_chunks, N, P) fp32, which
the backward reads.

The backward (``csrc/ssd_scan_bwd.cu``) has no TPU counterpart: JAX
cannot differentiate through the Pallas call. Its derivation is in
``_bwd_plain``; ``SSDScanFn`` ties the two into a
``torch.autograd.Function`` and ``ssd_scan`` is the entry point.

The wrapper keeps the reference's contract: ``chunk = min(chunk, max(L,
8))``, the sequence padded to a chunk multiple with padded tokens at
``dt = 0`` (the identity), output in ``x.dtype``, ``H % G == 0``. Each
wrapper takes the plain PyTorch version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. The forward counts its
launches in ``ssd_scan.launches``, the backward in
``ssd_scan_bwd.launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_decode import _DTYPE_CODE, _ptr, _stream

DEFAULT_CHUNK = 128
MAX_CHUNK = 128                  # rows of the kernels' chunk tiles
SUPPORTED_NP = ((128, 64),)      # (d_state N, head dim P) built


def _fwd_lib():
    from repro_torch.kernels import build
    fn = build.load("ssd_scan").pam_ssd_scan_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return fn


def _bwd_lib():
    from repro_torch.kernels import build
    fn = build.load("ssd_scan_bwd").pam_ssd_scan_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
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


def _check_cuda(name: str, x, dt, a, b, c, d_skip, chunk) -> None:
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if (N, P) not in SUPPORTED_NP:
        raise ValueError(f"{name}: (d_state, head dim) ({N}, {P}) not built "
                         f"(built: {SUPPORTED_NP})")
    if chunk_len(L, chunk)[0] > MAX_CHUNK:
        raise ValueError(f"{name}: chunk {chunk} > {MAX_CHUNK}")
    if x.dtype not in _DTYPE_CODE or b.dtype != x.dtype \
            or c.dtype != x.dtype:
        raise ValueError(f"{name}: x/b/c dtypes {x.dtype}/{b.dtype}/"
                         f"{c.dtype} not built (float32 or bfloat16, alike)")
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


def _strides(x, b, c) -> list[int]:
    """Batch and sequence strides (elements) of x, b and c."""
    return [x.stride(0), x.stride(1), b.stride(0), b.stride(1),
            c.stride(0), c.stride(1)]


def _fwd_cuda(x, dt, a, b, c, d_skip, chunk):
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    _check_cuda("ssd_scan", x, dt, a, b, c, d_skip, chunk)
    Q, Lp = chunk_len(L, chunk)
    nc = Lp // Q
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=x.device)
    states = torch.empty((B, H, nc, N, P), dtype=torch.float32,
                         device=x.device)
    rc = _fwd_lib()(_ptr(x), _ptr(dt), _ptr(a), _ptr(b), _ptr(c),
                    _ptr(d_skip), _ptr(y), _ptr(states), B, L, H, G, Q, nc,
                    *_strides(x, b, c), N, P, _DTYPE_CODE[x.dtype],
                    _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (code {rc})")
    ssd_scan.launches += 1
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


def _bwd_cuda(x, dt, a, b, c, d_skip, states, dy, chunk):
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    _check_cuda("ssd_scan_bwd", x, dt, a, b, c, d_skip, chunk)
    Q, Lp = chunk_len(L, chunk)
    nc = Lp // Q
    if dy.dtype != x.dtype or not dy.is_contiguous() \
            or states.shape != (B, H, nc, N, P) \
            or states.dtype != torch.float32 or not states.is_contiguous():
        raise ValueError("ssd_scan_bwd: dy must be contiguous in x's dtype "
                         "and states the forward's (B, H, nc, N, P) fp32")
    dev, f32 = x.device, torch.float32
    dx = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, L, H), dtype=f32, device=dev)
    da = torch.empty((H,), dtype=f32, device=dev)
    dd = torch.empty((H,), dtype=f32, device=dev)
    db = torch.empty((B, L, G, N), dtype=b.dtype, device=dev)
    dc = torch.empty((B, L, G, N), dtype=c.dtype, device=dev)
    # scratch: state gradients, per-head partials of dB / dC (reduced over
    # each group's heads in the kernel's last pass), per-chunk partials of
    # da / dD
    dstates = torch.empty_like(states)
    db_part = torch.empty((B, H, Lp, N), dtype=f32, device=dev)
    dc_part = torch.empty((B, H, Lp, N), dtype=f32, device=dev)
    da_part = torch.empty((B, H, nc), dtype=f32, device=dev)
    dd_part = torch.empty((B, H, nc), dtype=f32, device=dev)
    rc = _bwd_lib()(
        _ptr(x), _ptr(dt), _ptr(a), _ptr(b), _ptr(c), _ptr(d_skip),
        _ptr(states), _ptr(dy), _ptr(dx), _ptr(ddt), _ptr(da), _ptr(db),
        _ptr(dc), _ptr(dd), _ptr(dstates), _ptr(db_part), _ptr(dc_part),
        _ptr(da_part), _ptr(dd_part), B, L, H, G, Q, nc,
        *_strides(x, b, c), N, P, _DTYPE_CODE[x.dtype], _stream(dev))
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed (code {rc})")
    ssd_scan_bwd.launches += 1
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
