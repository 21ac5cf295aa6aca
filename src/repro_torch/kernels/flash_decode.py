"""Split-KV decode attention — PAMattention's Local_Attention stage
(paper Alg. 1 lines 9-13) as hand-written Hopper kernels.

Counterpart of ``repro.kernels.flash_decode``, whose Pallas kernels
``_decode_kernel`` and ``_paged_decode_kernel`` these replace:

``flash_decode`` (dense): per (batch, kv head, split of ``block_s``
tokens) the partial ``(O, m, l)`` of the ``rep`` grouped query heads over
a (B, Hkv, S, d) cache. CUDA source: ``csrc/flash_decode.cu``.

``flash_decode_paged`` (paged): per (batch, kv head, logical block) the
partial over one pool block found through the block table; blocks with
``block_live == 0`` emit the merge identity without reading KV. CUDA
source: ``csrc/flash_decode_paged.cu``.

Both kernels are bound by the bytes of live K/V rows they read from HBM
(see the notes in the sources). Each wrapper takes the plain PyTorch
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises. Dead partitions carry ``m = -1e30`` in both versions,
as the TPU kernels do. Each wrapper counts its launches in its
``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
DEFAULT_BLOCK_S = 512
SUPPORTED_D = (16, 128)          # head dims built (the port's configs)
SUPPORTED_REP = (1, 2)           # GQA group sizes built
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ring_position_map(lengths: torch.Tensor, window: int, *, start: int = 0,
                      size: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotated position map of the hot-window ring buffer.

    Absolute position ``p`` lives at ring slot ``p % window``. Returns
    ``(ring_pos (B, size) int64, valid (B, size) bool)``: ``ring_pos[b,
    j]`` is the absolute position resident in slot ``start + j`` and
    ``valid`` marks slots holding a live token.
    """
    lengths = lengths.to(torch.int64)
    base = (lengths - window)[:, None]                        # (B, 1)
    slots = (start + torch.arange(size if size is not None else window,
                                  device=lengths.device))[None, :]
    ring_pos = base + torch.remainder(slots - base, window)  # [base, base+W)
    return ring_pos, ring_pos >= 0


def ring_gather_mask(mask: torch.Tensor, ring_pos: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Pull a (B, Smax) absolute-coordinate boolean mask onto ring
    coordinates: (B, W) with dead slots False."""
    idx = ring_pos.clamp(0, mask.shape[-1] - 1)
    return valid & torch.gather(mask, 1, idx)


def _check_cuda(name: str, d: int, rep: int, *tensors: torch.Tensor) -> None:
    if d not in SUPPORTED_D or rep not in SUPPORTED_REP:
        raise ValueError(f"{name}: head dim {d} / group size {rep} not "
                         f"built (head dims {SUPPORTED_D}, groups "
                         f"{SUPPORTED_REP})")
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be CUDA tensors")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             f"16-byte aligned")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ------------------------------------------------------------ dense kernel
def _dense_lib():
    from repro_torch.kernels import build
    lib = build.load("flash_decode")
    fn = lib.pam_flash_decode
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _flash_decode_plain(q, k, v, mask, kv_len, scale, block_s, nsplit):
    """Plain PyTorch version: pad S to ``nsplit * block_s`` and compute
    every split's partial with the TPU kernel's arithmetic."""
    B, H, d = q.shape
    _, Hkv, S, _ = k.shape
    rep = H // Hkv
    pad = nsplit * block_s - S
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    msk = torch.nn.functional.pad(mask, (0, pad))
    qg = q.float().reshape(B, Hkv, rep, d)
    kf = kf.reshape(B, Hkv, nsplit, block_s, d)
    vf = vf.reshape(B, Hkv, nsplit, block_s, d)
    s = torch.einsum("bgrd,bgntd->bgrnt", qg, kf) * scale
    pos = torch.arange(nsplit * block_s, device=q.device)
    live = ((pos < kv_len)[None, :] & (msk != 0)).reshape(
        B, 1, 1, nsplit, block_s)
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(live, p, torch.zeros_like(p))
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bgrnt,bgntd->bgrnd", p, vf)
    return (o.reshape(B, H, nsplit, d), m.reshape(B, H, nsplit),
            l.reshape(B, H, nsplit))


def _flash_decode_cuda(q, k, v, mask, kv_len, scale, block_s, nsplit):
    B, H, d = q.shape
    _, Hkv, S, _ = k.shape
    if k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
        raise ValueError(f"flash_decode: K/V dtype {k.dtype} not built")
    qf = q.float().contiguous()
    _check_cuda("flash_decode", d, H // Hkv, qf, k, v, mask)
    o = torch.empty((B, H, nsplit, d), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, nsplit), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    rc = _dense_lib()(_ptr(qf), _ptr(k), _ptr(v), _ptr(mask), _ptr(o),
                      _ptr(m), _ptr(l), B, H, Hkv, S, d, block_s, nsplit,
                      kv_len, float(scale), _DTYPE_CODE[k.dtype],
                      _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed (code {rc})")
    flash_decode.launches += 1
    return o, m, l


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor | None = None, *,
                 kv_len: int | None = None,
                 kv_lens: torch.Tensor | None = None,
                 scale: float | None = None,
                 block_s: int = DEFAULT_BLOCK_S
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PAMattention local stage. Returns stacked partials over splits.

    q: (B, H, d); k, v: (B, H_kv, S, d); mask: (B, S) participation.
    ``kv_len`` is a whole-batch length bound; ``kv_lens`` an optional
    per-sequence (B,) length folded into the mask. Returns (o, m, l): o
    (B, H, nsplit, d) fp32 unnormalized, m/l (B, H, nsplit) fp32, with
    ``block_s = min(block_s, max(S, 8))`` and ``nsplit = ceil(S /
    block_s)`` as in the reference. Merge with ``ops.merge_decode``.
    """
    B, H, d = q.shape
    S = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if kv_len is None:
        kv_len = S
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.int8, device=q.device)
    else:
        mask = mask.to(torch.int8)
    if kv_lens is not None:
        live = torch.arange(S, device=q.device)[None, :] < kv_lens[:, None]
        mask = mask * live.to(torch.int8)
    mask = mask.contiguous()
    block_s = min(block_s, max(S, 8))
    nsplit = -(-S // block_s)
    if q.device.type == "cpu":
        return _flash_decode_plain(q, k, v, mask, kv_len, scale, block_s,
                                   nsplit)
    return _flash_decode_cuda(q, k, v, mask, kv_len, scale, block_s, nsplit)


flash_decode.launches = 0


# ------------------------------------------------------------ paged kernel
def _paged_lib():
    from repro_torch.kernels import build
    lib = build.load("flash_decode_paged")
    fn = lib.pam_flash_decode_paged
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _flash_decode_paged_plain(q, k_pool, v_pool, table, block_live, mask,
                              scale):
    """Plain PyTorch version: gather every table entry's block and compute
    each block's partial; dead blocks take the identity."""
    B, H, d = q.shape
    _, bs, Hkv, _ = k_pool.shape
    nb = table.shape[1]
    rep = H // Hkv
    qg = q.float().reshape(B, Hkv, rep, d)
    kb = k_pool[table].float()                   # (B, nb, bs, Hkv, d)
    vb = v_pool[table].float()
    s = torch.einsum("bgrd,bntgd->bgrnt", qg, kb) * scale
    live = (mask.reshape(B, 1, 1, nb, bs) != 0)
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(live, p, torch.zeros_like(p))
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bgrnt,bntgd->bgrnd", p, vb)
    blk = (block_live != 0).reshape(B, 1, 1, nb)
    o = torch.where(blk[..., None], o, torch.zeros_like(o))
    m = torch.where(blk, m, torch.full_like(m, NEG_INF))
    l = torch.where(blk, l, torch.zeros_like(l))
    return (o.reshape(B, H, nb, d), m.reshape(B, H, nb), l.reshape(B, H, nb))


def _flash_decode_paged_cuda(q, k_pool, v_pool, table, block_live, mask,
                             scale):
    B, H, d = q.shape
    _, bs, Hkv, _ = k_pool.shape
    nb = table.shape[1]
    if k_pool.dtype not in _DTYPE_CODE or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"flash_decode_paged: pool dtype {k_pool.dtype} "
                         f"not built")
    qf = q.float().contiguous()
    _check_cuda("flash_decode_paged", d, H // Hkv, qf, k_pool, v_pool,
                table, block_live, mask)
    o = torch.empty((B, H, nb, d), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, nb), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    rc = _paged_lib()(_ptr(qf), _ptr(k_pool), _ptr(v_pool), _ptr(table),
                      _ptr(block_live), _ptr(mask), _ptr(o), _ptr(m),
                      _ptr(l), B, H, Hkv, nb, bs, d, float(scale),
                      _DTYPE_CODE[k_pool.dtype], _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_decode_paged kernel launch failed "
                           f"(code {rc})")
    flash_decode_paged.launches += 1
    return o, m, l


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_table: torch.Tensor,
                       mask: torch.Tensor, *,
                       block_live: torch.Tensor | None = None,
                       block_offset: int | torch.Tensor | None = None,
                       scale: float | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PAMattention local stage over a paged KV pool.

    q: (B, H, d); k_pool/v_pool: (NB+1, block_size, H_kv, d) single-layer
    pool slices, sentinel block last; block_table: (B, nb) physical ids;
    mask: (B, nb*bs) participation at logical positions (length bound
    folded in). ``block_offset`` makes the read shard-local: the pools
    hold physical blocks ``[block_offset, block_offset + NB_local)`` and
    table entries outside that range are dead.

    Returns stacked partials over logical blocks: (o (B, H, nb, d) fp32
    unnormalized, m/l (B, H, nb)). Merge with ``ops.merge_decode``.
    """
    B, H, d = q.shape
    NBp, bs = k_pool.shape[0], k_pool.shape[1]
    nb = block_table.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    mask = mask.to(torch.int8).contiguous()
    if block_live is None:
        block_live = mask.reshape(B, nb, bs).ne(0).any(dim=-1)
    block_live = block_live.to(torch.int32)
    block_table = block_table.to(torch.int32)
    if block_offset is not None:
        # localise: only entries inside my block range stay live, and
        # surviving ids rebase onto local pool coordinates
        inside = ((block_table >= block_offset)
                  & (block_table < block_offset + NBp))
        block_live = block_live * inside.to(torch.int32)
        block_table = torch.where(inside, block_table - block_offset,
                                  torch.zeros_like(block_table))
    # dead logical blocks alias the sentinel page (never read for them)
    table = torch.where(block_live != 0, block_table,
                        torch.full_like(block_table, NBp - 1)).contiguous()
    block_live = block_live.contiguous()
    if q.device.type == "cpu":
        return _flash_decode_paged_plain(q, k_pool, v_pool, table.long(),
                                         block_live, mask, scale)
    return _flash_decode_paged_cuda(q, k_pool, v_pool, table, block_live,
                                    mask, scale)


flash_decode_paged.launches = 0
