"""The decode kernels at zamba2-7b's (head dim 112, group 1) on the card,
held to their plain versions, and the port's hybrid engine on the card
held to its own CPU run.

Head dim 112 runs the kernels' narrow path at four output dimensions a
lane on lanes 0-27 (lanes 28-31 hold none) and stages bf16 rows of 14
16-byte chunks (fp32: 28), so two rows a warp step leave four lanes
idle. The values in dims 96-111 are drawn apart from the rest, so a lane
mapping that dropped them (three dimensions a lane cover only 96) would
fail the comparison. Both kernels run stacked and merged, bf16 and
fp32.

The reduced hybrid engine (fp32, TF32 off) on dense PAM gives the greedy
streams of the same engine on the CPU, eager and through the CUDA
graphs, at ``micro_steps`` 1 and 4: 6 requests through 4 slots, one of
them to ``max_len`` exactly; once at the reduced width (4 q / 2 kv heads
of 16) and once with 4 q / 4 kv heads of 112, which puts the new pair
inside the engine. The merged dense wrapper is called n_groups x the
host-run body steps, the paged one never.

Every test needs an NVIDIA GPU and skips without one; the file imports
neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_hybrid_cuda.py

Kernel tolerance as in ``tests/test_torch_decode_gqa_cuda.py``: both
sides upcast to fp32 and differ in summation order and in the kernels'
exp (ex2.approx), so rtol 1e-4 / atol 1e-4 on (o, m, l) and the scores.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import get_config, reduced  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
D = 112
HEADS = [(32, 32), (4, 4)]     # zamba2's 32 over 32, and the reduced 4 / 4
VARIANTS = {"reduced": {},
            "d112": dict(n_heads=4, n_kv_heads=4, d_head=112)}


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


def _rows(rng, shape, dtype):
    """Normal draws whose last 16 dims (96-111) sit at 4 + 3 x another
    draw: far from the others, so a dropped dim shows in o."""
    a = rng.standard_normal(shape, np.float32)
    a[..., 96:] = 4.0 + 3.0 * a[..., 96:]
    return torch.from_numpy(a).to(dtype)


def _tail_live(o):
    """Whether dims 96-111 of every live row's output are written."""
    return bool((o[..., 96:].abs().amax(-1) > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, 40, 64, 300])
@pytest.mark.parametrize("H,Hkv", HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_d112_matches_plain(cuda, dtype, H, Hkv, split):
    """The dense kernel, stacked and merged (scores included): ragged
    lengths, an all-dead row, a dead split, a length bound inside the
    last split."""
    rng = np.random.default_rng(5)
    B, S = 3, 300
    q = _rows(rng, (B, H, D), dtype)
    k = _rows(rng, (B, Hkv, S, D), dtype)
    v = _rows(rng, (B, Hkv, S, D), dtype)
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
        assert _tail_live(got[0][:2])
        if "kv_lens" in kw:                  # the all-dead row
            assert bool((got[1][2] == tfd.NEG_INF).all())
            assert bool((got[0][2] == 0).all() and (got[2][2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, 32, 64, 192])
@pytest.mark.parametrize("H,Hkv", HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_paged_d112_matches_plain(cuda, dtype, H, Hkv, split):
    """The paged kernel, stacked and merged (scores included): sentinel
    entries, dead blocks, live tokens in a dead block, a row with no live
    token, a shard-local pool slice."""
    rng = np.random.default_rng(8)
    B, bs, nb, NB = 3, 16, 12, 40
    q = _rows(rng, (B, H, D), dtype)
    kp, vp = (_rows(rng, (NB + 1, bs, Hkv, D), dtype) for _ in range(2))
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
def test_d112_merge_is_deterministic_at_the_serving_shape(cuda):
    """zamba2's attention at the serving shape (B 8, 32 heads over 32 of
    112, S 2048, bf16 K/V): repeated merged launches give the same bits,
    and every split count up to the cluster's 8 matches the plain
    version."""
    rng = np.random.default_rng(55)
    B, S, H = 8, 2048, 32
    q = _rows(rng, (B, H, D), torch.float32)
    k, v = (_rows(rng, (B, H, S, D), torch.bfloat16) for _ in range(2))
    mask = torch.from_numpy(rng.random((B, S)) < 0.3)
    ref = tfd.flash_decode_merged(q, k, v, mask, scores=True)
    dev = [t.to(cuda) for t in (q, k, v, mask)]
    first = tfd.flash_decode_merged(*dev, scores=True)
    for _ in range(3):
        again = tfd.flash_decode_merged(*dev, scores=True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    _close(first, ref)
    for split in (256, 512, 1024, 2048):
        _close(tfd.flash_decode_merged(*dev, scores=True, split=split), ref)


def _streams(cfg, host, dev, micro, eager):
    params = host if dev == "cpu" else tree.tree_map(lambda t: t.to(dev),
                                                     host)
    eng = teng.ServingEngine(cfg, params, teng.ServingConfig(
        pam=tpm.PAMManagerConfig(max_tokens=128, hot_capacity=16,
                                 warm_capacity=16, compression=2,
                                 recency_window=4, schedule_interval=2),
        max_batch=4, max_len=128, micro_steps=micro), device=dev)
    if eager:
        eng._dispatch = eng._dispatch_eager
    rng = np.random.default_rng(11)
    lens = [int(n) for n in rng.integers(20, 61, 5)] + [128 - 24]
    for i, n in enumerate(lens):
        eng.submit(teng.Request(i, rng.integers(0, cfg.vocab, n), 24))
    eng.run()
    return {i: list(rs.outputs) for i, rs in eng.requests.items()}, eng


@pytest.mark.cuda
@pytest.mark.parametrize("micro", [1, 4])
@pytest.mark.parametrize("eager", [True, False])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reduced_engine_streams_equal_cpu(cuda, variant, eager, micro):
    cfg = dataclasses.replace(reduced(get_config(ARCH)), **VARIANTS[variant])
    host = ttf.init_params(cfg, 0, device="cpu")
    want, _ = _streams(cfg, host, "cpu", micro, eager=True)
    n0 = {f: f.launches for f in (tfd.flash_decode_merged,
                                  tfd.flash_decode_paged_merged)}
    got, eng = _streams(cfg, host, cuda, micro, eager)
    assert got == want
    assert all(len(v) == 24 for v in got.values())
    assert bool(eng._graphs) != eager
    assert _launched(tfd.flash_decode_merged, n0[tfd.flash_decode_merged]) \
        == cfg.hybrid.n_groups * eng.decode_body_steps > 0
    assert _launched(tfd.flash_decode_paged_merged,
                     n0[tfd.flash_decode_paged_merged]) == 0
