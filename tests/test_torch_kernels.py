"""The port's decode kernels against the JAX reference.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
it to the Pallas kernels in interpret mode (stacked (o, m, l), dead
partitions with m = -1e30 included) and the entry points of ``ops`` to
the JAX ops. Inputs come from a seeded numpy generator. Tolerance: 1e-5
absolute/relative in fp32 (the two sides sum in different orders).

The CUDA kernels themselves are held to these plain versions on the
card by ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_decode as jfd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               **(tol or TOL))


def _dense_inputs(seed, B=2, H=4, Hkv=2, S=40, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    mask = rng.random((B, S)) < 0.6
    mask[0, 16:32] = False                  # a dead split at block_s 16
    return q, k, v, mask


DENSE_CASES = {
    "full": dict(),
    "mask": dict(mask=True),
    "mask_kv_len_ragged_tail": dict(mask=True, kv_len=35, block_s=16),
    "ragged_kv_lens": dict(mask=True, kv_lens=[40, 13], block_s=16),
    "all_dead_row": dict(mask=True, kv_lens=[0, 27], block_s=16),
    "block_s_past_S": dict(mask=True, block_s=512),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_flash_decode_plain_matches_pallas(case):
    kw = dict(DENSE_CASES[case])
    q, k, v, mask = _dense_inputs(1)
    msk = mask if kw.pop("mask", False) else None
    lens = kw.pop("kv_lens", None)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens)
    jo = jfd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if msk is None else jnp.asarray(msk),
                          kv_lens=jl, interpret=True, **kw)
    to = tfd.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          None if msk is None else torch.from_numpy(msk),
                          kv_lens=tl, **kw)
    for t, j in zip(to, jo):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)


def _paged_inputs(seed, B=2, H=4, Hkv=2, d=16, NB=12, bs=4, nb=6):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp = rng.standard_normal((NB + 1, bs, Hkv, d)).astype(np.float32)
    vp = rng.standard_normal((NB + 1, bs, Hkv, d)).astype(np.float32)
    table = rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32)
    table[1, 4:] = NB                      # unmapped tail -> sentinel
    mask = rng.random((B, nb * bs)) < 0.5
    mask[0, 4:12] = False                  # dead blocks 1 and 2 of row 0
    mask[1, 16:] = False                   # sentinel blocks are dead
    return q, kp, vp, table, mask


PAGED_CASES = {
    "mask_only": dict(),
    "block_live": dict(block_live=True),
    "live_block_fully_masked": dict(block_live="all"),
    "block_offset": dict(block_offset=4),
}


def _paged_kw(case, table, mask, mod):
    kw = dict(PAGED_CASES[case])
    B, nb = table.shape
    bl = kw.pop("block_live", None)
    if bl is True:
        live = mask.reshape(B, nb, -1).any(-1)
        live[0, 0] = False                 # a live token in a dead block
        kw["block_live"] = live
    elif bl == "all":
        kw["block_live"] = np.ones((B, nb), bool)
    if "block_live" in kw:
        kw["block_live"] = mod(kw["block_live"])
    return kw


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_flash_decode_paged_plain_matches_pallas(case):
    q, kp, vp, table, mask = _paged_inputs(2)
    if case == "block_offset":
        kp, vp = kp[4:12], vp[4:12]        # a shard owning blocks [4, 12)
    jkw = _paged_kw(case, table, mask, jnp.asarray)
    tkw = _paged_kw(case, table, mask, torch.from_numpy)
    jo = jfd.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(table),
                                jnp.asarray(mask), interpret=True, **jkw)
    to = tfd.flash_decode_paged(torch.from_numpy(q), torch.from_numpy(kp),
                                torch.from_numpy(vp),
                                torch.from_numpy(table),
                                torch.from_numpy(mask), **tkw)
    for t, j in zip(to, jo):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)
    assert (to[1] == tfd.NEG_INF).any()    # dead partitions present


def test_plain_versions_do_not_count_launches():
    before = (tfd.flash_decode.launches, tfd.flash_decode_paged.launches)
    q, k, v, mask = _dense_inputs(3)
    tfd.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), torch.from_numpy(mask))
    q, kp, vp, table, mask = _paged_inputs(3)
    tfd.flash_decode_paged(torch.from_numpy(q), torch.from_numpy(kp),
                           torch.from_numpy(vp), torch.from_numpy(table),
                           torch.from_numpy(mask))
    assert (tfd.flash_decode.launches,
            tfd.flash_decode_paged.launches) == before


@pytest.mark.parametrize("lens", [[40, 40], [31, 9], [0, 17]])
@pytest.mark.parametrize("with_mask", [False, True])
def test_masked_decode_attention_matches_jax(lens, with_mask):
    q, k, v, mask = _dense_inputs(4)
    part = mask if with_mask else None
    jo, jm = jops.masked_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if part is None else jnp.asarray(part),
        jnp.asarray(lens, jnp.int32))
    to, tm = tops.masked_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if part is None else torch.from_numpy(part),
        torch.tensor(lens, dtype=torch.int32))
    _close(to, jo)
    _close(tm, jm, rtol=1e-5, atol=1e-4)   # mass is count-scaled (~S)


def _tiered_inputs(seed, B=3, H=4, Hkv=2, d=16, W=8, bs=4, Smax=32,
                   NB=26):
    rng = np.random.default_rng(seed)
    nb = Smax // bs
    lens = np.array([27, 8, 5], np.int32)[:B]
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, W, d)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, W, d)).astype(np.float32)
    kp = rng.standard_normal((NB + 1, bs, Hkv, d)).astype(np.float32)
    vp = rng.standard_normal((NB + 1, bs, Hkv, d)).astype(np.float32)
    table = np.full((B, nb), NB, np.int32)
    ids = rng.permutation(NB)
    used = 0
    for b in range(B):
        n = -(-int(lens[b]) // bs)
        table[b, :n] = ids[used:used + n]
        used += n
    pos = np.arange(Smax)[None, :]
    part = (rng.random((B, Smax)) < 0.6) & (pos < lens[:, None])
    in_win = pos >= lens[:, None] - W
    hot_tag = rng.random((B, Smax)) < 0.5
    hot = part & hot_tag & in_win
    pgd = part & ~(hot_tag & in_win)
    live = pgd.reshape(B, nb, bs).any(-1)
    table_eff = np.where(live, table, NB).astype(np.int32)
    return q, kc, vc, kp, vp, table_eff, hot, pgd, lens, live


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_paged_masked_decode_attention_matches_jax(seed):
    args = _tiered_inputs(seed)
    *arrays, live = args
    jo, jm = jops.paged_masked_decode_attention(
        *[jnp.asarray(a) for a in arrays], block_live=jnp.asarray(live))
    to, tm = tops.paged_masked_decode_attention(
        *[torch.from_numpy(a) for a in arrays],
        block_live=torch.from_numpy(live))
    _close(to, jo)
    _close(tm, jm, rtol=1e-5, atol=1e-4)


def test_cuda_launch_checks_refuse_unbuilt_shapes_and_host_operands():
    """The CUDA path validates before any launch: head dims and GQA
    groups outside the built set, and operands not on the card, raise."""
    t = torch.zeros(4)
    with pytest.raises(ValueError, match="not built"):
        tfd.check_launch("flash_decode", 112, 2, t)
    with pytest.raises(ValueError, match="not built"):
        tfd.check_launch("flash_decode", 128, 4, t)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfd.check_launch("flash_decode_paged", 128, 2, t)
