"""The sharded engine's kernel calls on the card, held to the plain
versions: the merged dense kernel on a site's view of the hot ring (kv
heads a whole ring apart, ``start`` past 0) and the merged paged kernel
on a site's slice of the pool with ``block_offset``, on the narrow path
and on the wide one (groups 16 and 7); the sharded decode
attention against the unsharded one; a reduced sharded engine's streams
on the card against its CPU run. Every test here needs an NVIDIA GPU and
skips without one; the file imports neither JAX nor the reference
package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_shard_cuda.py

Tolerance as the other decode card tests: rtol 1e-4 / atol 1e-4 (fp32
sums in another order, the kernels' ex2.approx), TF32 off; streams
exactly equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import pam_shard as psh  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.config import get_config, reduced  # noqa: E402
from repro_torch.serving import (EngineSpec, PAMManagerConfig,  # noqa: E402
                                 Request, ServingConfig)
from repro_torch.serving import pam_manager as pm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


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


@pytest.mark.cuda
@pytest.mark.parametrize("W,g", [(256, 2), (256, 4), (16, 4), (64, 2)])
@pytest.mark.parametrize("d,H,Hkv", [(128, 16, 8), (16, 4, 2),
                                     (128, 64, 4), (64, 14, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_site_view_matches_plain(cuda, dtype, d, H, Hkv, W, g):
    """Every site's view of the ring, the kernel reading kv heads W rows
    apart: (o, m, l) and the scores equal the plain version's on the same
    view and on a contiguous copy. Groups 16 (qwen3-moe-235b-a22b's 64 / 4
    heads of 128) and 7 (internvl2-1b's 14 / 2 of 64) take the kernel's
    wide path."""
    rng = np.random.default_rng(W + g)
    B = 3
    q = torch.from_numpy(rng.standard_normal((B, H, d), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, W, d),
                                                 np.float32)).to(dtype)
            for _ in range(2))
    mask = torch.from_numpy(rng.random((B, W)) < 0.6)
    w = W // g
    for r in range(g):
        sl = slice(r * w, (r + 1) * w)
        m = mask[:, sl].contiguous()
        ref = tfd.flash_decode_merged(q, k[:, :, sl], v[:, :, sl], m,
                                      kv_len=w, scores=True)
        n0 = tfd.flash_decode_merged.launches
        got = tfd.flash_decode_merged(
            q.to(cuda), k.to(cuda)[:, :, sl], v.to(cuda)[:, :, sl],
            m.to(cuda), kv_len=w, scores=True)
        torch.cuda.synchronize()
        assert tfd.flash_decode_merged.launches == n0 + 1
        _close(got, ref)
        copy = tfd.flash_decode_merged(
            q.to(cuda), k[:, :, sl].contiguous().to(cuda),
            v[:, :, sl].contiguous().to(cuda), m.to(cuda), kv_len=w,
            scores=True)
        _close(got, copy)


@pytest.mark.cuda
def test_ring_view_refuses_other_layouts(cuda):
    """Rows not contiguous, or K and V laid out apart, are refused before
    the launch."""
    k = torch.zeros((2, 2, 32, 16), device=cuda)
    q = torch.zeros((2, 4, 16), device=cuda)
    cols = torch.zeros((2, 2, 16, 32), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="rows"):
        tfd.flash_decode_merged(q, cols, k, kv_len=32)
    with pytest.raises(ValueError, match="rows"):
        tfd.flash_decode_merged(q, k[:, :, 8:24], k[:, :, 8:24].contiguous(),
                                kv_len=16)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("d,H,Hkv", [(128, 16, 8), (128, 64, 4),
                                     (64, 14, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_site_slice_matches_plain(cuda, dtype, d, H, Hkv, g):
    """Each site's slice of a 64-block pool through the global table,
    ``block_offset`` r NB_loc: equal to the plain version's, at
    qwen3-0.6b's heads and on the wide path at groups 16 and 7."""
    rng = np.random.default_rng(g)
    B, bs, nb, NB1 = 3, 16, 8, 64
    q = torch.from_numpy(rng.standard_normal((B, H, d), np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((NB1, bs, Hkv, d),
                                                   np.float32)).to(dtype)
              for _ in range(2))
    table = torch.from_numpy(np.stack([rng.permutation(NB1 - 1)[:nb]
                                       for _ in range(B)]).astype(np.int32))
    live = torch.from_numpy(rng.random((B, nb)) < 0.7)
    mask = torch.from_numpy(rng.random((B, nb * bs)) < 0.6)
    n = NB1 // g
    for r in range(g):
        lo = r * n
        ref = tfd.flash_decode_paged_merged(
            q, kp[lo:lo + n], vp[lo:lo + n], table, mask, block_live=live,
            block_offset=lo, scores=True)
        got = tfd.flash_decode_paged_merged(
            q.to(cuda), kp.to(cuda)[lo:lo + n], vp.to(cuda)[lo:lo + n],
            table.to(cuda), mask.to(cuda), block_live=live.to(cuda),
            block_offset=lo, scores=True)
        _close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [2, 4])
def test_sharded_attention_equals_unsharded_on_card(cuda, g):
    """One layer's sharded attention (2 g kernel launches) against the
    unsharded call and against its own CPU run: out and mass."""
    rng = np.random.default_rng(11)
    B, H, Hkv, d, W, smax, bs, NB1 = 3, 16, 8, 128, 64, 256, 16, 48
    nb = smax // bs
    lens = np.array([200, 256, 0], np.int32)
    pos = np.arange(smax)[None]
    alive = (rng.random((B, smax)) < 0.6) & (pos < lens[:, None])
    hot = alive & (pos >= lens[:, None] - W) & (rng.random((B, smax)) < 0.7)
    pgd = alive & ~hot
    blive = pgd.reshape(B, nb, bs).any(-1)
    table = np.stack([rng.permutation(NB1 - 1)[:nb] for _ in range(B)])
    table = np.where(blive, table, NB1 - 1).astype(np.int32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = dict(q=f(B, H, d), kc=f(B, Hkv, W, d), vc=f(B, Hkv, W, d),
             pk=f(NB1, bs, Hkv, d), pv=f(NB1, bs, Hkv, d), lens=lens,
             hot=hot, pgd=pgd, blive=blive, table=table)
    cpu = {k: torch.from_numpy(v) for k, v in x.items()}
    dev = {k: t.to(cuda) for k, t in cpu.items()}

    def run(t, sites):
        args = (t["q"], t["kc"], t["vc"], t["pk"], t["pv"], t["lens"])
        if sites is None:
            return pm.make_paged_decode_attn(t["hot"], t["pgd"], t["table"],
                                             t["blive"])(*args)
        return psh.make_sharded_paged_decode_attn(
            sites, t["hot"], t["pgd"], t["table"], t["blive"])(*args)
    n0 = (tfd.flash_decode_merged.launches,
          tfd.flash_decode_paged_merged.launches)
    got = run(dev, psh.decode_sites(g, cuda))
    torch.cuda.synchronize()
    assert (tfd.flash_decode_merged.launches - n0[0],
            tfd.flash_decode_paged_merged.launches - n0[1]) == (g, g)
    _close(got, run(dev, None))
    _close(got, run(cpu, psh.decode_sites(g, "cpu")))


@pytest.mark.cuda
@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-235b-a22b",
                                  "internvl2-1b"])
def test_reduced_sharded_engine_card_equals_cpu(cuda, arch, g):
    """A reduced model (fp32; the dense, MoE and vlm families) at shard
    g, on the card (decode through the graphs) and on the CPU: equal
    greedy streams, equal to shard 1's on the card."""
    cfg = reduced(get_config(arch))
    pam = PAMManagerConfig(max_tokens=64, hot_capacity=8, warm_capacity=16,
                           compression=4, recency_window=4,
                           schedule_interval=2)
    scfg = ServingConfig(pam=pam, max_batch=2, max_len=64, block_size=8,
                         pool_blocks=23, hot_window=16)
    params = tf.init_params(cfg, 0, device="cpu")
    streams = {}
    for dev, shard in (("cpu", g), ("cuda", g), ("cuda", 1)):
        p = params if dev == "cpu" else _to(params, cuda)
        eng = EngineSpec(model=cfg, serving=scfg, shard=shard).build(
            p, device=dev)
        rng = np.random.default_rng(7)
        for i in range(3):
            eng.submit(Request(i + 1, rng.integers(1, cfg.vocab, 20), 10))
        eng.run()
        streams[(dev, shard)] = {r: s.outputs
                                 for r, s in eng.requests.items()}
    assert streams[("cuda", g)] == streams[("cpu", g)]
    assert streams[("cuda", g)] == streams[("cuda", 1)]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
