"""Split-KV decode attention — PAMattention's Local_Attention stage
(paper Alg. 1 lines 9-13) as hand-written Hopper kernels.

Counterpart of ``repro.kernels.flash_decode``, whose Pallas kernels
``_decode_kernel`` and ``_paged_decode_kernel`` these replace. Two
layouts, one CUDA kernel each, two contracts each:

``flash_decode`` / ``flash_decode_merged`` (dense): the partial ``(O, m,
l)`` of the ``rep`` grouped query heads of each kv head over a (B, Hkv,
S, d) cache, or over a view of S consecutive rows of a longer cache (a
sharded engine's site slice of its ring, ``cache[:, :, a:b]``). CUDA
source: ``csrc/flash_decode.cu``.

``flash_decode_paged`` / ``flash_decode_paged_merged`` (paged): the same
over a paged pool through a block table; dead table entries are skipped
without reading KV. CUDA source: ``csrc/flash_decode_paged.cu``.

The stacked functions keep the reference's contract: partials stacked
over its ``block_s`` splits, or over logical blocks (merge with
``ops.merge_decode``). The merged functions are the serving path's: the
kernel splits the tokens into runs chosen from shapes alone
(``split_len``, enough CUDA blocks for two waves of the card's SMs),
merges the runs itself, and returns ``(o (B, H, d), m, l (B, H))``, with
``scores=True`` also the fp32 scaled score of every position (-1e30 where
the token does not participate): the values that entered the softmax,
from which ``ops`` takes the per-token attention mass.

Each wrapper takes the plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises, and it reads no
tensor value on the host. Dead partitions carry ``m = -1e30`` in both
versions, as the TPU kernels do. Each function counts its kernel
launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.core import online_softmax as osm

NEG_INF = -1e30
DEFAULT_BLOCK_S = 512
# (head dim, GQA group) pairs the kernels are built for, the list of
# csrc/decode_common.cuh's PAM_DECODE_BUILT: the port's configs' (128 at
# groups 1, 2, 5, 8, 16; 64 at groups 1 and 7; 112 at group 1) and the
# reduced variants' (16 at every built group but 7, 64 at group 2)
BUILT = ((16, 1), (16, 2), (16, 5), (16, 8), (16, 16),
         (64, 1), (64, 2), (64, 7),
         (112, 1),
         (128, 1), (128, 2), (128, 5), (128, 8), (128, 16))
RUN_LENGTHS = (512, 256, 128, 64, 32, 16)   # tokens a CUDA block walks
MAX_RUN_PAGES = 128              # table entries a paged CUDA block walks
MAX_SPLITS = 8                   # runs a merged launch reduces (a cluster)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MASK_DTYPES = (torch.bool, torch.uint8, torch.int8)


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


def split_len(B: int, Hkv: int, S: int, n_sm: int, *,
              block: int | None = None) -> int:
    """Tokens each CUDA block of a merged kernel walks, from shapes alone.

    The longest run of ``RUN_LENGTHS`` (for a paged pool a multiple of
    its ``block`` size) whose grid of ceil(S / L) x Hkv x B CUDA blocks
    fills two waves of ``n_sm`` SMs, the shortest when none does; then
    lengthened, if need be, to at most ``MAX_SPLITS`` runs (the runs of
    one batch row and kv head merge inside one cluster).
    """
    unit = block or 1
    cands = [L for L in RUN_LENGTHS if L % unit == 0] or [unit]
    L = next((L for L in cands if -(-S // L) * Hkv * B >= 2 * n_sm),
             cands[-1])
    longest = -(-S // MAX_SPLITS)
    return max(L, -(-longest // unit) * unit)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_launch(name: str, d: int, rep: int, *tensors: torch.Tensor,
                 built=BUILT) -> None:
    """Refuse a launch before it starts: a (head dim ``d``, GQA group
    ``rep``) pair outside ``built`` (the decode kernels' unless given)
    first, whatever the operands, then operands that are not contiguous,
    16-byte aligned CUDA tensors."""
    if (d, rep) not in built:
        raise ValueError(f"{name}: head dim {d} / group size {rep} not "
                         f"built (built (head dim, group) pairs: "
                         f"{sorted(built)})")
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


def _byte_mask(name: str, mask: torch.Tensor | None) -> torch.Tensor | None:
    """A CUDA mask as the kernels read it: one byte an entry, != 0 live."""
    if mask is None:
        return None
    if mask.device.type != "cuda":
        raise ValueError(f"{name}: all operands must be CUDA tensors")
    if mask.dtype not in _MASK_DTYPES:
        mask = mask != 0
    return mask.contiguous()


def _int32(name: str, t: torch.Tensor | None) -> torch.Tensor | None:
    if t is None:
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{name}: all operands must be CUDA tensors")
    return t.to(torch.int32).contiguous()


def _q_operand(q: torch.Tensor) -> torch.Tensor:
    """q as the kernels read it: fp32 or bf16, converted in the kernel."""
    return (q if q.dtype in _DTYPE_CODE else q.float()).contiguous()


def _buffers(q, nsplit, n_pos, merged, scores):
    """Outputs of one launch: (o, m, l, s); stacked partials carry an
    ``nsplit`` axis, a merged launch writes the merged partial."""
    B, H, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    rows = (B, H) if merged else (B, H, nsplit)
    return (torch.empty(rows + (d,), **f32), torch.empty(rows, **f32),
            torch.empty(rows, **f32),
            torch.empty((B, H, n_pos), **f32) if scores else None)


def _merged_plain(o, m, l, s):
    """The merged plain version from a stacked one: ``merge_many`` over
    the split (or block) axis; the scores pass through."""
    part = osm.merge_many(osm.AttnPartial(
        o=torch.movedim(o, 2, 0), m=torch.movedim(m, 2, 0),
        l=torch.movedim(l, 2, 0)))
    return tuple(part) + (s,)


def _addr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


# ------------------------------------------------------------ dense kernel
def _dense_lib():
    from repro_torch.kernels import build
    lib = build.load("flash_decode")
    fn = lib.pam_flash_decode
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    return fn


def _kv_stride(name: str, k: torch.Tensor, v: torch.Tensor) -> int:
    """Rows between kv heads of a (B, Hkv, S, d) K / V operand: S for a
    contiguous cache, more for a view of S consecutive rows of a longer
    one (a sharded engine's slice of its ring). Refuses any other layout,
    and operands that are not 16-byte aligned CUDA tensors."""
    B, Hkv, S, d = k.shape
    for t in (k, v):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be CUDA tensors")
        st = t.stride()
        if (t.shape != k.shape or st != k.stride() or st[3] != 1
                or st[2] != d or st[1] % d or st[1] < S * d
                or (B > 1 and st[0] != Hkv * st[1]) or t.data_ptr() % 16):
            raise ValueError(f"{name}: K / V must be (B, Hkv, S, d) with "
                             f"contiguous rows, 16-byte aligned, kv heads "
                             f"a whole number of rows apart")
    return k.stride(1) // d


def _dense_live(mask, kv_len, kv_lens, B, S, device) -> torch.Tensor:
    """(B, S) participation: below both length bounds and in the mask."""
    pos = torch.arange(S, device=device)[None, :]
    live = (pos < kv_len).expand(B, S)
    if kv_lens is not None:
        live = live & (pos < kv_lens[:, None])
    if mask is not None:
        live = live & (mask != 0)
    return live


def _flash_decode_plain(q, k, v, live, scale, block_s):
    """Plain PyTorch version: every split's partial with the TPU kernel's
    arithmetic, and the scores (B, H, S) that entered it (-1e30 where
    ``live`` is False). Returns (o, m, l, s)."""
    B, H, d = q.shape
    _, Hkv, S, _ = k.shape
    rep = H // Hkv
    nsplit = -(-S // block_s)
    pad = nsplit * block_s - S
    qg = q.float().reshape(B, Hkv, rep, d)
    s = torch.einsum("bgrd,bgsd->bgrs", qg, k.float()) * scale
    s = torch.where(live[:, None, None, :], s, torch.full_like(s, NEG_INF))
    sp = F.pad(s, (0, pad), value=NEG_INF).reshape(B, Hkv, rep, nsplit,
                                                   block_s)
    lp = F.pad(live, (0, pad)).reshape(B, 1, 1, nsplit, block_s)
    m = torch.amax(sp, dim=-1)
    p = torch.exp(sp - m[..., None])
    p = torch.where(lp, p, torch.zeros_like(p))
    l = torch.sum(p, dim=-1)
    vf = F.pad(v.float(), (0, 0, 0, pad)).reshape(B, Hkv, nsplit, block_s, d)
    o = torch.einsum("bgrnt,bgntd->bgrnd", p, vf)
    return (o.reshape(B, H, nsplit, d), m.reshape(B, H, nsplit),
            l.reshape(B, H, nsplit), s.reshape(B, H, S))


def _flash_decode_cuda(q, k, v, mask, kv_lens, kv_len, scale, L, *, merged,
                       scores=False):
    B, H, d = q.shape
    _, Hkv, S, _ = k.shape
    nsplit = -(-S // L)
    if merged and nsplit > MAX_SPLITS:
        raise ValueError(f"flash_decode_merged: {nsplit} splits of {L} "
                         f"tokens, at most {MAX_SPLITS} merge in a cluster")
    if k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
        raise ValueError(f"flash_decode: K/V dtype {k.dtype} not built")
    q = _q_operand(q)
    check_launch("flash_decode", d, H // Hkv, q)
    stride = _kv_stride("flash_decode", k, v)
    mask = _byte_mask("flash_decode", mask)
    lens = _int32("flash_decode", kv_lens)
    bufs = _buffers(q, nsplit, S, merged, scores)
    rc = _dense_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), _addr(mask),
                      _addr(lens), *(_addr(t) for t in bufs), B, H, Hkv, S,
                      d, L, nsplit, int(merged), min(kv_len, S), stride,
                      float(scale), _DTYPE_CODE[k.dtype],
                      _DTYPE_CODE[q.dtype], _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed (code {rc})")
    return bufs if scores else bufs[:3]


def _dense_args(q, k, kv_len, scale):
    S = k.shape[2]
    return (S if kv_len is None else kv_len,
            1.0 / math.sqrt(q.shape[-1]) if scale is None else scale)


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
    per-sequence (B,) length. Returns (o, m, l): o (B, H, nsplit, d) fp32
    unnormalized, m/l (B, H, nsplit) fp32, with ``block_s = min(block_s,
    max(S, 8))`` and ``nsplit = ceil(S / block_s)`` as in the reference.
    Merge with ``ops.merge_decode``.
    """
    kv_len, scale = _dense_args(q, k, kv_len, scale)
    S = k.shape[2]
    block_s = min(block_s, max(S, 8))
    if q.device.type == "cpu":
        live = _dense_live(mask, kv_len, kv_lens, q.shape[0], S, q.device)
        return _flash_decode_plain(q, k, v, live, scale, block_s)[:3]
    out = _flash_decode_cuda(q, k, v, mask, kv_lens, kv_len, scale, block_s,
                             merged=False)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_merged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor | None = None, *,
                        kv_len: int | None = None,
                        kv_lens: torch.Tensor | None = None,
                        scale: float | None = None, scores: bool = False,
                        split: int | None = None) -> tuple:
    """PAMattention local stage with the splits merged in the kernel.

    Arguments as ``flash_decode``. Returns (o (B, H, d) fp32 unnormalized,
    m, l (B, H) fp32), and with ``scores`` also s (B, H, S) fp32: the
    scaled score of every participating token, -1e30 elsewhere. ``split``
    is the tokens per split; by default the card's kernel takes
    ``split_len`` of the shapes (the card merges at most ``MAX_SPLITS``
    splits) and the plain version the reference's ``block_s``. Any split
    gives the same result up to summation order.
    """
    kv_len, scale = _dense_args(q, k, kv_len, scale)
    B, _, _ = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        L = split or min(DEFAULT_BLOCK_S, max(S, 8))
        live = _dense_live(mask, kv_len, kv_lens, B, S, q.device)
        out = _merged_plain(*_flash_decode_plain(q, k, v, live, scale, L))
        return out if scores else out[:3]
    L = split or split_len(B, Hkv, S, _sm_count(q.device))
    out = _flash_decode_cuda(q, k, v, mask, kv_lens, kv_len, scale, L,
                             merged=True, scores=scores)
    flash_decode_merged.launches += 1
    return out


flash_decode_merged.launches = 0


# ------------------------------------------------------------ paged kernel
def _paged_lib():
    from repro_torch.kernels import build
    lib = build.load("flash_decode_paged")
    fn = lib.pam_flash_decode_paged
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    return fn


def _flash_decode_paged_plain(q, k_pool, v_pool, table, block_live, mask,
                              block_offset, scale):
    """Plain PyTorch version: gather every table entry's block and compute
    each block's partial; a dead entry (``block_live`` 0, or outside the
    pool slice of ``block_offset``) takes the identity. Returns (o, m, l)
    stacked over logical blocks and the scores s (B, H, nb * bs)."""
    B, H, d = q.shape
    nb_local, bs, Hkv, _ = k_pool.shape
    nb = table.shape[1]
    rep = H // Hkv
    table = table.long()
    blk = (torch.ones_like(table, dtype=torch.bool) if block_live is None
           else block_live != 0)
    if block_offset is not None:
        inside = (table >= block_offset) & (table < block_offset + nb_local)
        blk = blk & inside
        table = table - block_offset
    table = torch.where(blk, table, torch.zeros_like(table))
    qg = q.float().reshape(B, Hkv, rep, d)
    kb = k_pool[table].float()                   # (B, nb, bs, Hkv, d)
    vb = v_pool[table].float()
    s = torch.einsum("bgrd,bntgd->bgrnt", qg, kb) * scale
    live = ((mask.reshape(B, nb, bs) != 0) & blk[..., None])[:, None, None]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(live, p, torch.zeros_like(p))
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bgrnt,bntgd->bgrnd", p, vb)
    return (o.reshape(B, H, nb, d), m.reshape(B, H, nb), l.reshape(B, H, nb),
            s.reshape(B, H, nb * bs))


def _flash_decode_paged_cuda(q, k_pool, v_pool, table, block_live, mask,
                             block_offset, scale, R, *, merged, scores=False):
    B, H, d = q.shape
    nb_local, bs, Hkv, _ = k_pool.shape
    nb = table.shape[1]
    nruns = -(-nb // R)
    if R > MAX_RUN_PAGES or (merged and nruns > MAX_SPLITS):
        raise ValueError(f"flash_decode_paged: {nruns} runs of {R} blocks; "
                         f"a run walks at most {MAX_RUN_PAGES} blocks, and "
                         f"at most {MAX_SPLITS} runs merge in a cluster")
    if k_pool.dtype not in _DTYPE_CODE or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"flash_decode_paged: pool dtype {k_pool.dtype} "
                         f"not built")
    if isinstance(block_offset, torch.Tensor):
        raise TypeError("flash_decode_paged: block_offset must be an int")
    q = _q_operand(q)
    check_launch("flash_decode_paged", d, H // Hkv, q, k_pool, v_pool)
    table = _int32("flash_decode_paged", table)
    block_live = _byte_mask("flash_decode_paged", block_live)
    mask = _byte_mask("flash_decode_paged", mask)
    bufs = _buffers(q, nruns, nb * bs, merged, scores)
    rc = _paged_lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                      table.data_ptr(), _addr(block_live), mask.data_ptr(),
                      *(_addr(t) for t in bufs), B, H, Hkv, nb, bs, d, R,
                      nruns, int(merged), nb_local, block_offset or 0,
                      float(scale), _DTYPE_CODE[k_pool.dtype],
                      _DTYPE_CODE[q.dtype], _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_decode_paged kernel launch failed "
                           f"(code {rc})")
    return bufs if scores else bufs[:3]


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_table: torch.Tensor,
                       mask: torch.Tensor, *,
                       block_live: torch.Tensor | None = None,
                       block_offset: int | None = None,
                       scale: float | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PAMattention local stage over a paged KV pool.

    q: (B, H, d); k_pool/v_pool: (NB+1, block_size, H_kv, d) single-layer
    pool slices, sentinel block last; block_table: (B, nb) physical ids;
    mask: (B, nb*bs) participation at logical positions (length bound
    folded in); block_live: (B, nb), a dead entry's tokens never
    participate (default: every entry live). ``block_offset`` makes the
    read shard-local: the pools hold physical blocks ``[block_offset,
    block_offset + NB_local)`` and table entries outside that range are
    dead.

    Returns stacked partials over logical blocks: (o (B, H, nb, d) fp32
    unnormalized, m/l (B, H, nb)). Merge with ``ops.merge_decode``.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _flash_decode_paged_plain(q, k_pool, v_pool, block_table,
                                         block_live, mask, block_offset,
                                         scale)[:3]
    out = _flash_decode_paged_cuda(q, k_pool, v_pool, block_table,
                                   block_live, mask, block_offset, scale, 1,
                                   merged=False)
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


def flash_decode_paged_merged(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor,
                              block_table: torch.Tensor, mask: torch.Tensor,
                              *, block_live: torch.Tensor | None = None,
                              block_offset: int | None = None,
                              scale: float | None = None,
                              scores: bool = False,
                              split: int | None = None) -> tuple:
    """Paged local stage with the partials merged in the kernel.

    Arguments as ``flash_decode_paged``. Returns (o (B, H, d) fp32
    unnormalized, m, l (B, H) fp32), and with ``scores`` also s (B, H, nb
    * bs) fp32: the scaled score of every participating token, -1e30
    elsewhere. ``split`` is the tokens a CUDA block walks on the card (a
    multiple of the block size giving at most ``MAX_SPLITS`` runs;
    default ``split_len`` of the shapes); the plain version merges per
    logical block.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    B, bs, Hkv = q.shape[0], k_pool.shape[1], k_pool.shape[2]
    nb = block_table.shape[1]
    if split is not None and split % bs:
        raise ValueError(f"flash_decode_paged_merged: split {split} is not "
                         f"a multiple of the block size {bs}")
    if q.device.type == "cpu":
        out = _merged_plain(*_flash_decode_paged_plain(
            q, k_pool, v_pool, block_table, block_live, mask, block_offset,
            scale))
        return out if scores else out[:3]
    L = split or split_len(B, Hkv, nb * bs, _sm_count(q.device), block=bs)
    out = _flash_decode_paged_cuda(q, k_pool, v_pool, block_table,
                                   block_live, mask, block_offset, scale,
                                   L // bs, merged=True, scores=scores)
    flash_decode_paged_merged.launches += 1
    return out


flash_decode_paged_merged.launches = 0
