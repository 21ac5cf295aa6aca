"""The port's paper core library on the card, held to its CPU run.

Every test here needs an NVIDIA GPU and skips without one (the decode
kernels have no interpret mode). The file imports neither JAX nor the
reference package, so it runs on a machine with PyTorch alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_core_cuda.py

The CPU side of each test is the function the CPU tests hold to the JAX
package. Tolerances: the tier-list decode attention through the merged
kernels against its plain version at rtol / atol 1e-4 (summation order
and the kernels' ex2.approx exp, as ``tests/test_torch_cuda.py``);
PAMattention's plain tensor code on the card against the CPU at 2e-5
(fp32, TF32 off); selections, assignments, plans and tags exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import mapping as tmap  # noqa: E402
from repro_torch.core import pam_attention as tpam  # noqa: E402
from repro_torch.core import pam_interface as tpif  # noqa: E402
from repro_torch.core import importance as timp  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serving import paged_kv as tpkv  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
FP32_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "interpret mode")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)


def _same(got, ref):
    assert got.dtype == ref.dtype and torch.equal(got.cpu(), ref.cpu())


def _tier_case(dtype, d, H, Hkv, seed=0):
    """Three tiers: hot and warm dense (32 / 224 tokens), cold paged at
    block 16 (12 table entries over a 40-block pool, two unmapped in
    row 1); masks with a dead row in the warm tier."""
    rng = np.random.default_rng(seed)
    B, bs, nb, NB = 3, 16, 12, 40

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    q = arr(B, H, d)
    dense = [(arr(B, Hkv, s, d), arr(B, Hkv, s, d)) for s in (32, 224)]
    masks = [torch.from_numpy(rng.random((B, s)) < 0.7) for s in (32, 224)]
    masks[1][2] = False
    table = torch.from_numpy(rng.permutation(NB)[:B * nb].reshape(
        B, nb).astype(np.int32))
    table[1, 10:] = NB
    pmask = torch.from_numpy(rng.random((B, nb * bs)) < 0.6)
    pmask[1, 10 * bs:] = False
    paged = tops.PagedTier(arr(NB + 1, bs, Hkv, d), arr(NB + 1, bs, Hkv, d),
                           table, pmask.reshape(B, nb, bs).any(-1))
    return q, dense + [paged], masks + [pmask]


def _to(tiers, masks, dev):
    moved = [tops.PagedTier(*(None if x is None else x.to(dev) for x in t))
             if isinstance(t, tops.PagedTier) else (t[0].to(dev),
                                                    t[1].to(dev))
             for t in tiers]
    return moved, [m.to(dev) for m in masks]


@pytest.mark.cuda
@pytest.mark.parametrize("d,H,Hkv", [(128, 16, 8), (16, 4, 2), (128, 8, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pam_decode_attention_card_equals_plain(cuda, dtype, d, H, Hkv):
    """One merged dense launch a dense tier and one paged launch for the
    paged tier; the card's output equals the plain versions' (the CPU
    run of the same call)."""
    q, tiers, masks = _tier_case(dtype, d, H, Hkv)
    ref = tops.pam_decode_attention(q, tiers, masks)
    fns = (tfd.flash_decode_merged, tfd.flash_decode_paged_merged,
           tfd.flash_decode, tfd.flash_decode_paged)
    n0 = [f.launches for f in fns]
    ctiers, cmasks = _to(tiers, masks, cuda)
    got = tops.pam_decode_attention(q.to(cuda), ctiers, cmasks)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, n0)] == [2, 1, 0, 0]
    assert got.dtype == dtype and got.shape == ref.shape
    _close(got, ref, TOL if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    n1 = tfd.flash_decode_merged.launches
    one = tops.decode_attention(q.to(cuda), ctiers[0][0], ctiers[0][1],
                                cmasks[0])
    assert tfd.flash_decode_merged.launches - n1 == 1
    _close(one, tops.decode_attention(q, tiers[0][0], tiers[0][1], masks[0]),
           TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("sparse,imp_kind", [(False, "random"),
                                             (True, "random"),
                                             (True, "equal")])
def test_pam_attention_step_card_equals_cpu(cuda, sparse, imp_kind):
    rng = np.random.default_rng(1)
    S, H, Hkv, d = 512, 16, 8, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((H, d), (S, Hkv, d), (S, Hkv, d)))
    tier = torch.from_numpy(rng.integers(0, 3, S).astype(np.int32))
    imp = (torch.from_numpy(rng.random(S).astype(np.float32))
           if imp_kind == "random" else torch.full((S,), 0.5))
    valid = torch.arange(S) < 480
    cfg = tpam.PAMAttentionConfig(use_sparsity=sparse, compression=8)
    ref = tpam.pam_attention_step(q, k, v, tier, valid, imp, cfg)
    got = tpam.pam_attention_step(*(x.to(cuda) for x in (
        q, k, v, tier, valid, imp)), cfg)
    _same(got.step_scores > 0, ref.step_scores > 0)
    for g, r in zip(got, ref):
        _close(g, r, FP32_TOL)


@pytest.mark.cuda
def test_selections_on_card_keep_index_order(cuda):
    """Stable sorts on the card: tie-heavy selections equal the CPU's."""
    rng = np.random.default_rng(2)
    S = 4096
    scores = torch.from_numpy(rng.integers(0, 3, S).astype(np.float32))
    valid = torch.arange(S) < 4000
    for args in ((scores, valid, 512, torch.tensor(4000), 32),
                 (torch.zeros(S), valid, 256, None, 0)):
        ref = tsp.select_topk(*args[:3], args[3], recency_window=args[4])
        got = tsp.select_topk(*(None if a is None else a.to(cuda)
                                for a in args[:2]), args[2],
                              None if args[3] is None else args[3].to(cuda),
                              recency_window=args[4])
        for g, r in zip(got, ref):
            _same(g, r)
    ref = timp.topk_hot_set(scores, 300, valid)
    for g, r in zip(timp.topk_hot_set(scores.to(cuda), 300,
                                      valid.to(cuda)), ref):
        _same(g, r)
    k = torch.from_numpy(rng.integers(-2, 3, (256, 128)).astype(np.float32))
    _same(tsp.choose_label_channels(k.to(cuda), 16),
          tsp.choose_label_channels(k, 16))


@pytest.mark.cuda
def test_mapping_and_migration_card_equal_cpu(cuda):
    rng = np.random.default_rng(3)
    n, G = 2048, 16
    freq = torch.from_numpy(rng.integers(0, 11, n).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    assign = tmap.greedy_balanced_assign(freq.to(cuda), valid.to(cuda), G)
    assert assign.device.type == "cuda"
    ref = tmap.greedy_balanced_assign(freq, valid, G)
    _same(assign, ref)
    _close(tmap.imbalance(freq.to(cuda), assign, valid.to(cuda), G),
           tmap.imbalance(freq, ref, valid, G), FP32_TOL)
    dense = torch.from_numpy(rng.standard_normal((n, 8, 16)).astype(
        np.float32))
    cap = int(torch.bincount(ref.long(), minlength=G).max())  # no overflow
    for g, r in zip(tpif.bank_interleave(dense.to(cuda), assign, G, cap),
                    tpif.bank_interleave(dense, ref, G, cap)):
        _same(g, r)
    moved = torch.from_numpy(rng.random(n) < 0.25)
    slots = torch.from_numpy(rng.permutation(n).astype(np.int32))
    free = torch.from_numpy(rng.permutation(700)[:600].astype(np.int32))
    src = dense.bfloat16()
    dst = torch.zeros((700, 8, 16), dtype=torch.bfloat16)
    plan = tpif.make_migration_plan(moved, slots, free)
    cplan = tpif.make_migration_plan(moved.to(cuda), slots.to(cuda),
                                     free.to(cuda))
    for g, r in zip(cplan, plan):
        _same(g, r)
    _same(tpif.apply_migration(src.to(cuda), dst.to(cuda), cplan,
                               slots.to(cuda)),
          tpif.apply_migration(src, dst, plan, slots))


@pytest.mark.cuda
def test_pool_manager_and_placement_default_to_card(cuda):
    st = ttiers.initial_placement(100, 128, [16, 32, 1000])
    assert st.valid.device.type == "cuda"
    ref = ttiers.initial_placement(100, 128, [16, 32, 1000], device="cpu")
    _same(st.tier_of_token, ref.tier_of_token)
    pool = tpkv.PagedKVPool.create(2, 8, 4, 2, 8, dtype=torch.float32)
    assert pool.k.device.type == "cuda"
    k = torch.randn(2, 10, 2, 8)
    table = tpkv.BlockAllocator(8, 4).allocate(0, 10)
    bids, slots = tpkv.token_to_block_slot(np.arange(10), table, 4)
    pool = pool.write_tokens(k.to(cuda), -k.to(cuda), bids, slots)
    gk, gv = pool.gather_tokens(bids, slots)
    _same(gk, k)
    _same(gv, -k)
    mgr = tpm.PAMManager(tpm.PAMManagerConfig(32, 4, 8,
                                              schedule_interval=1))
    states = {}
    for dev in ("cpu", cuda):
        s = mgr.place_prefill(tpm.init_pam_state(1, 32, device=dev), 0, 24)
        scores = torch.zeros(1, 32, device=dev)
        scores[0, 2] = 50.0
        lengths = torch.tensor([24], device=dev)
        for _ in range(6):
            lengths = lengths + 1
            s = mgr.observe(s, scores, lengths,
                            mgr.participation(s, lengths))
        states[str(dev)] = s
    for f in ("importance", "tier", "last_hot"):
        _close(getattr(states["cuda"], f), getattr(states["cpu"], f),
               FP32_TOL)
