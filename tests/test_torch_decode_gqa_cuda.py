"""The decode kernels at GQA groups 5 and 8 and at head dim 64 (qwen3-14b:
40 query heads over 8 kv heads; deepseek-67b: 64 over 8; minicpm-2b: 36
over 36 of head dim 64) on the card, held to their plain versions.

Groups 5 and 8 run the kernels' wide path (``csrc/decode_common.cuh``
``attend_run_wide``: whole heads a warp, 1, 1, 1, 2 heads at group 5 and
two each at group 8; the merge over distributed shared memory); head dim
64 runs the narrow path at two output dimensions a lane. Every test here
needs an NVIDIA GPU and skips without one; the file imports neither JAX
nor the reference package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_decode_gqa_cuda.py

Tolerance as in ``tests/test_torch_decode_g16_cuda.py``: both sides upcast
to fp32 and differ in summation order and in the kernels' exp
(ex2.approx), so rtol 1e-4 / atol 1e-4 on (o, m, l) and the scores, TF32
off.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_decode as tfd  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# (head dim, query heads, kv heads): the full-width configs', the reduced
# variants' at the same groups, and head dim 64 at group 2
GQA_HEADS = [(128, 40, 8), (128, 64, 8), (64, 36, 36), (16, 10, 2),
             (16, 16, 2), (64, 8, 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), **TOL)


def _launched(fn, n0):
    torch.cuda.synchronize()
    return fn.launches - n0


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, 40, 64, 300])
@pytest.mark.parametrize("d,H,Hkv", GQA_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_gqa_matches_plain(cuda, dtype, d, H, Hkv, split):
    """The dense kernel, stacked and merged (scores included): ragged
    lengths, an all-dead row, a dead split, a length bound inside the
    last split."""
    rng = np.random.default_rng(5)
    B, S = 3, 300
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
               for s in ((B, H, d), (B, Hkv, S, d), (B, Hkv, S, d)))
    mask = torch.from_numpy(rng.random((B, S)) < 0.5)
    mask[0, 128:256] = False
    lens = torch.tensor([300, 77, 0])
    dev = [t.to(cuda) for t in (q, k, v, mask)]
    ref = tfd.flash_decode(q, k, v, mask, kv_lens=lens, block_s=split or 128)
    n0 = tfd.flash_decode.launches
    got = tfd.flash_decode(*dev, kv_lens=lens.to(cuda), block_s=split or 128)
    assert _launched(tfd.flash_decode, n0) == 1
    _close(got, ref)
    for kw in (dict(kv_lens=lens), dict(kv_len=250)):
        ref = tfd.flash_decode_merged(q, k, v, mask, scores=True, **kw)
        kw = {n: (x.to(cuda) if torch.is_tensor(x) else x)
              for n, x in kw.items()}
        n0 = tfd.flash_decode_merged.launches
        got = tfd.flash_decode_merged(*dev, scores=True, split=split, **kw)
        assert _launched(tfd.flash_decode_merged, n0) == 1
        _close(got, ref)
        if "kv_lens" in kw:                  # the all-dead row
            assert bool((got[1][2] == tfd.NEG_INF).all())
            assert bool((got[0][2] == 0).all() and (got[2][2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, 32, 64, 192])
@pytest.mark.parametrize("d,H,Hkv", GQA_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_paged_gqa_matches_plain(cuda, dtype, d, H, Hkv, split):
    """The paged kernel, stacked and merged (scores included): sentinel
    entries, dead blocks, live tokens in a dead block, a dead page inside
    a live run, a row with no live token, a shard-local pool slice."""
    rng = np.random.default_rng(8)
    B, bs, nb, NB = 3, 16, 12, 40
    q = torch.from_numpy(rng.standard_normal((B, H, d), np.float32)).to(dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (NB + 1, bs, Hkv, d), np.float32)).to(dtype) for _ in range(2))
    table = torch.from_numpy(
        rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32))
    table[2, 5:] = NB
    mask = torch.from_numpy(rng.random((B, nb * bs)) < 0.3)
    mask[1, :] = False
    mask[2, 5 * bs:] = False
    live = mask.reshape(B, nb, bs).any(-1)
    live[0, 0] = False
    live[0, 6] = False
    for kw, pools in ((dict(block_live=live), (kp, vp)),
                      (dict(block_offset=8), (kp[8:32], vp[8:32]))):
        args = (q, *pools, table, mask)
        dev = [t.to(cuda).contiguous() for t in args]
        dkw = {n: (x.to(cuda) if torch.is_tensor(x) else x)
               for n, x in kw.items()}
        ref = tfd.flash_decode_paged(*args, **kw)
        n0 = tfd.flash_decode_paged.launches
        got = tfd.flash_decode_paged(*dev, **dkw)
        assert _launched(tfd.flash_decode_paged, n0) == 1
        _close(got, ref)
        ref = tfd.flash_decode_paged_merged(*args, scores=True, **kw)
        n0 = tfd.flash_decode_paged_merged.launches
        got = tfd.flash_decode_paged_merged(*dev, scores=True, split=split,
                                            **dkw)
        assert _launched(tfd.flash_decode_paged_merged, n0) == 1
        _close(got, ref)
        assert bool((got[1][1] == tfd.NEG_INF).all())   # no live token


@pytest.mark.cuda
@pytest.mark.parametrize("d,H,Hkv", [(128, 40, 8), (16, 10, 2)])
def test_group5_merge_is_deterministic(cuda, d, H, Hkv):
    """Group 5's warps hold 1, 1, 1 and 2 heads, and the merge reads the
    runs' partials in run order: repeated launches at the serving shape
    (B 8, S 2048, bf16) give the same bits, dense and paged, and every
    split count up to the cluster's 8 matches the plain version."""
    rng = np.random.default_rng(55)
    B, S, bs = 8, 2048, 16
    q = torch.from_numpy(rng.standard_normal((B, H, d), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, S, d),
                                                 np.float32)).bfloat16()
            for _ in range(2))
    mask = torch.from_numpy(rng.random((B, S)) < 0.3)
    ref = tfd.flash_decode_merged(q, k, v, mask, scores=True)
    dev = [t.to(cuda) for t in (q, k, v, mask)]
    first = tfd.flash_decode_merged(*dev, scores=True)
    for _ in range(3):
        again = tfd.flash_decode_merged(*dev, scores=True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    for split in (256, 512, 1024, 2048):
        _close(tfd.flash_decode_merged(*dev, scores=True, split=split), ref)
    # the same cache as a paged pool: block i of row b is physical
    # block b * nb + i
    nb = S // bs
    pool = [t.reshape(B, Hkv, nb, bs, d).permute(0, 2, 3, 1, 4)
            .reshape(B * nb, bs, Hkv, d) for t in (k, v)]
    pool = [torch.cat([p, torch.zeros_like(p[:1])]).to(cuda) for p in pool]
    table = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb).to(cuda)
    first = tfd.flash_decode_paged_merged(dev[0], *pool, table, dev[3],
                                          scores=True)
    for _ in range(3):
        again = tfd.flash_decode_paged_merged(dev[0], *pool, table, dev[3],
                                              scores=True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    _close(first, ref)
