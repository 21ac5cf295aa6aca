"""The merged decode entry points (``flash_decode_merged``,
``flash_decode_paged_merged``) against the JAX reference, on the CPU.

Their plain versions (the stacked plain version, then ``merge_many``)
are held to the JAX ``decode_attention_partial`` and
``paged_decode_attention_partial`` with the Pallas kernels in interpret
mode, at fp32 rtol / atol 1e-5 (the two sides sum in different orders);
any split length merges to the reference split's result; the returned
scores are the grouped QK^T on live tokens and -1e30 elsewhere; the
split choice fills two waves of an H100's 132 SMs at the serving path's
shapes from shapes alone; the masked decode functions no longer gather
the pool or recompute scores. Inputs come from seeded numpy generators.
The CUDA kernels are held to these plain versions by
``test_torch_cuda.py`` on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import online_softmax as osm  # noqa: E402
from repro_torch.core import pam_interface as tpi  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               **(tol or TOL))


def _dense_inputs(seed, B=3, H=4, Hkv=2, S=70, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    mask = rng.random((B, S)) < 0.6
    mask[0, 16:48] = False                  # dead splits at split 16
    return q, k, v, mask


DENSE_CASES = {
    "full": dict(),
    "mask": dict(mask=True),
    "mask_kv_len_ragged_tail": dict(mask=True, kv_len=61),
    "ragged_kv_lens": dict(mask=True, kv_lens=[70, 13, 41]),
    "kv_len_zero_row": dict(mask=True, kv_lens=[0, 27, 70]),
    "group_of_one": dict(mask=True, kv_lens=[5, 70, 33], H=2),
}


def _dense_case(case):
    kw = dict(DENSE_CASES[case])
    q, k, v, mask = _dense_inputs(11, H=kw.pop("H", 4))
    msk = mask if kw.pop("mask", False) else None
    lens = kw.pop("kv_lens", None)
    return q, k, v, msk, lens, kw


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_merged_plain_matches_jax_partial(case):
    q, k, v, msk, lens, kw = _dense_case(case)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    ref = jops.decode_attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if msk is None else jnp.asarray(msk), kv_lens=jl,
        interpret=True, **kw)
    got = tfd.flash_decode_merged(_t(q), _t(k), _t(v), _t(msk),
                                  kv_lens=_t(lens), **kw)
    assert len(got) == 3
    for t, j in zip(got, ref):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)
    if lens is not None and 0 in lens:      # the all-dead row
        b = lens.index(0)
        assert bool((got[1][b] == tfd.NEG_INF).all())
        assert bool((got[0][b] == 0).all() and (got[2][b] == 0).all())


def _paged_inputs(seed, B=3, H=4, Hkv=2, d=16, NB=20, bs=4, nb=6):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp = rng.standard_normal((NB + 1, bs, Hkv, d)).astype(np.float32)
    vp = rng.standard_normal((NB + 1, bs, Hkv, d)).astype(np.float32)
    table = rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32)
    table[1, 4:] = NB                      # unmapped tail -> sentinel
    mask = rng.random((B, nb * bs)) < 0.5
    mask[0, 4:12] = False                  # dead blocks 1 and 2 of row 0
    mask[1, 16:] = False                   # sentinel blocks are dead
    mask[2, :] = False                     # a row with no live token
    live = mask.reshape(B, nb, bs).any(-1)
    live[0, 3] = False                     # live tokens in a dead block
    return q, kp, vp, table, mask, live


PAGED_CASES = {
    "mask_only": dict(),
    "block_live": dict(block_live=True),
    "block_offset": dict(block_offset=4),
    "block_offset_and_live": dict(block_offset=4, block_live=True),
}


def _paged_case(case):
    kw = dict(PAGED_CASES[case])
    q, kp, vp, table, mask, live = _paged_inputs(12)
    if kw.pop("block_live", False):
        kw["block_live"] = live
    if "block_offset" in kw:
        kp, vp = kp[4:16], vp[4:16]        # a shard owning blocks [4, 16)
    return q, kp, vp, table, mask, kw


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_merged_plain_matches_jax_partial(case):
    q, kp, vp, table, mask, kw = _paged_case(case)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ref = jops.paged_decode_attention_partial(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(mask), use_kernel=True, interpret=True, **jkw)
    got = tfd.flash_decode_paged_merged(_t(q), _t(kp), _t(vp), _t(table),
                                        _t(mask), **tkw)
    for t, j in zip(got, ref):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)
    assert bool((got[1][2] == tfd.NEG_INF).all())   # the row with no token


@pytest.mark.parametrize("split", [1, 7, 16, 24, 40, 64, 512])
def test_any_split_merges_to_the_reference_split(split):
    q, k, v, msk, lens, kw = _dense_case("ragged_kv_lens")
    args = (_t(q), _t(k), _t(v), _t(msk))
    ref = tfd.flash_decode_merged(*args, kv_lens=_t(lens), **kw)
    got = tfd.flash_decode_merged(*args, kv_lens=_t(lens), split=split, **kw)
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(osm.finalize(osm.AttnPartial(*got)).numpy(),
                               osm.finalize(osm.AttnPartial(*ref)).numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), ref[2].numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["ragged_kv_lens", "kv_len_zero_row",
                                  "mask_kv_len_ragged_tail"])
def test_dense_scores_are_the_grouped_scores_on_live_tokens(case):
    q, k, v, msk, lens, kw = _dense_case(case)
    B, H, d = q.shape
    S = k.shape[2]
    scale = 0.3
    *_, s = tfd.flash_decode_merged(_t(q), _t(k), _t(v), _t(msk),
                                    kv_lens=_t(lens), scale=scale,
                                    scores=True, **kw)
    assert tuple(s.shape) == (B, H, S) and s.dtype == torch.float32
    ref = tops._grouped_scores(_t(q), _t(k), scale).reshape(B, H, S)
    pos = torch.arange(S)[None, :]
    live = pos < kw.get("kv_len", S)
    if lens is not None:
        live = live & (pos < _t(lens)[:, None])
    if msk is not None:
        live = live & _t(msk)
    live = live[:, None, :].expand(B, H, S)
    _close(s[live], ref[live].numpy())
    assert bool((s[~live] == tfd.NEG_INF).all())


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_scores_are_the_grouped_scores_on_live_tokens(case):
    q, kp, vp, table, mask, kw = _paged_case(case)
    B, H, d = q.shape
    nb, bs = table.shape[1], kp.shape[1]
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    *_, s = tfd.flash_decode_paged_merged(_t(q), _t(kp), _t(vp), _t(table),
                                          _t(mask), scores=True, **tkw)
    assert tuple(s.shape) == (B, H, nb * bs)
    off = kw.get("block_offset", 0)
    inside = (table >= off) & (table < off + kp.shape[0])
    blk = inside & kw.get("block_live", np.ones_like(inside))
    local = np.where(blk, table - off, 0)
    ref = tops._grouped_scores(
        _t(q), tpi.paged_gather_logical(_t(kp), _t(local)),
        1.0 / d ** 0.5).reshape(B, H, nb * bs)
    live = (_t(mask) & _t(np.repeat(blk, bs, axis=1)))[:, None, :]
    live = live.expand(B, H, nb * bs)
    assert bool(live.any()) and bool((~live).any())
    _close(s[live], ref[live].numpy())
    assert bool((s[~live] == tfd.NEG_INF).all())


MAIN_PATH = {            # (B, Hkv, S tokens, paged block size)
    "ring_256": (8, 8, 256, None),
    "dense_2048": (8, 8, 2048, None),
    "paged_2048": (8, 8, 2048, 16),
}


@pytest.mark.parametrize("shape", sorted(MAIN_PATH))
def test_split_len_fills_two_waves_at_the_main_path_shapes(shape):
    B, Hkv, S, bs = MAIN_PATH[shape]
    L = tfd.split_len(B, Hkv, S, H100_SMS, block=bs)
    if bs is not None:
        assert L % bs == 0 and L // bs <= tfd.MAX_RUN_PAGES
    assert -(-S // L) * Hkv * B >= 2 * H100_SMS
    assert L in tfd.RUN_LENGTHS and -(-S // L) <= tfd.MAX_SPLITS


def test_split_len_is_a_function_of_shapes_only():
    """The choice takes integers only (no tensor, so no host read): the
    longest listed run that fills two waves (or the shortest), lengthened
    to at most MAX_SPLITS runs, a multiple of the paged block size."""
    seen = {}
    for B in (1, 3, 8, 32):
        for S in (8, 40, 256, 1000, 2048, 8192, 65536):
            for bs in (None, 1, 4, 16):
                L = tfd.split_len(B, 8, S, H100_SMS, block=bs)
                assert tfd.split_len(B, 8, S, H100_SMS, block=bs) == L
                assert L % (bs or 1) == 0 and -(-S // L) <= tfd.MAX_SPLITS
                ok = [x for x in tfd.RUN_LENGTHS if x % (bs or 1) == 0]
                fill = [x for x in ok if -(-S // x) * 8 * B >= 2 * H100_SMS]
                want = max(fill) if fill else min(ok)
                if -(-S // want) <= tfd.MAX_SPLITS:
                    assert L == want
                else:
                    assert -(-S // L) == tfd.MAX_SPLITS or L - (bs or 1) < \
                        -(-S // tfd.MAX_SPLITS)
                seen[(B, S, bs)] = L
    assert len(set(seen.values())) > 1


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


def _raise(*a, **k):
    raise AssertionError("the masked decode path must not call this")


@pytest.mark.parametrize("seed", [21, 22])
def test_masked_decode_functions_neither_gather_nor_rescore(monkeypatch,
                                                            seed):
    """With ``paged_gather_logical`` and ``_grouped_scores`` made to raise,
    both masked decode functions still run and still equal the JAX
    functions: the mass comes from the kernels' scores."""
    monkeypatch.setattr(tpi, "paged_gather_logical", _raise)
    monkeypatch.setattr(tops, "_grouped_scores", _raise)
    *arrays, live = _tiered_inputs(seed)
    jo, jm = jops.paged_masked_decode_attention(
        *[jnp.asarray(a) for a in arrays], block_live=jnp.asarray(live))
    to, tm = tops.paged_masked_decode_attention(
        *[torch.from_numpy(a) for a in arrays],
        block_live=torch.from_numpy(live))
    _close(to, jo)
    _close(tm, jm, rtol=1e-5, atol=1e-4)   # mass is count-scaled (~S)
    q, k, v, mask = _dense_inputs(seed)
    lens = np.array([70, 0, 33], np.int32)
    jo, jm = jops.masked_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.asarray(lens))
    to, tm = tops.masked_decode_attention(_t(q), _t(k), _t(v), _t(mask),
                                          _t(lens))
    _close(to, jo)
    _close(tm, jm, rtol=1e-5, atol=1e-4)
    assert bool((tm[1] == 0).all())        # the kv_len = 0 row: no mass


def test_plain_versions_do_not_count_launches():
    before = (tfd.flash_decode_merged.launches,
              tfd.flash_decode_paged_merged.launches)
    q, k, v, msk, lens, kw = _dense_case("mask")
    tfd.flash_decode_merged(_t(q), _t(k), _t(v), _t(msk), scores=True)
    q, kp, vp, table, mask, kw = _paged_case("block_live")
    tfd.flash_decode_paged_merged(_t(q), _t(kp), _t(vp), _t(table),
                                  _t(mask), block_live=_t(kw["block_live"]))
    assert (tfd.flash_decode_merged.launches,
            tfd.flash_decode_paged_merged.launches) == before


def test_tensors_off_the_cpu_reach_the_kernel_path_not_the_plain_one():
    """A tensor that is not on the CPU (here on the meta device) goes to
    the CUDA launch, whose checks refuse it: no fallback."""
    meta = torch.device("meta")
    q = torch.empty((2, 4, 16), device=meta)
    k = torch.empty((2, 2, 32, 16), device=meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lens = torch.ones(2, dtype=torch.int32, device=meta)
        tfd.flash_decode_merged(q, k, k, kv_lens=lens, scores=True, split=16)
    pool = torch.empty((5, 4, 2, 16), device=meta)
    table = torch.zeros((2, 8), dtype=torch.int32, device=meta)
    mask = torch.ones((2, 32), dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfd.flash_decode_paged_merged(q, pool, pool, table, mask, split=16)
    with pytest.raises(ValueError, match="multiple of the block size"):
        tfd.flash_decode_paged_merged(q, pool, pool, table, mask, split=6)
    with pytest.raises(ValueError, match="at most 8"):   # one cluster
        tfd.flash_decode_merged(q, k, k, split=2)
    with pytest.raises(ValueError, match="at most 8"):   # 12 runs
        tfd.flash_decode_paged_merged(q, pool, pool, table.repeat(1, 2)[:, :12],
                                      mask.repeat(1, 2)[:, :48], split=4)
