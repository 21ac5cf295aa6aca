"""The port's CUDA kernels on the card, held to their plain versions.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the reference package, so it runs on a machine
with PyTorch alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_cuda.py

Tolerance: both sides upcast the stored K/V (and q) to fp32 and differ
only in summation order (tiled online softmax and the in-kernel merge vs
one reduction) and in the decode kernels' exp (ex2.approx, within 2^-21
relative), so rtol 1e-4 / atol 1e-4 on (o, m, l) and the scores, with
TF32 off for the plain side's matrix products. The attention backward
sums up to S products per gradient entry in another order: rtol / atol
1e-3 in fp32. In bf16 both sides compute in fp32 and round the result to
bf16, so they may differ by one bf16 step; the wgmma kernels (bf16, head dim 128) also
round P and dS to bf16 as tensor-core operands, which
tests/test_torch_flash_attention_sm90.py shows stays inside the same
rtol / atol 2e-2. The SSD scan's kernels and
plain versions differ in summation order and in the order of the
in-chunk prefix sum of dt a, whose rounding moves each exp(s_t - s_u) by
a few ulp of |s|: fp32 outputs at rtol 1e-4 / atol 1e-3 and gradients
within 1e-3 of each leaf's largest entry; bf16 (the wgmma kernels, whose
roundings tests/test_torch_ssd_scan_sm90.py bounds on the CPU) at 2e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ssd_scan as tss  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

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
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), **TOL)


DECODE_HEADS = [(128, 16, 8), (128, 8, 8), (16, 4, 2)]   # group 2, 1, 2


def _launched(fn, n0):
    torch.cuda.synchronize()
    return fn.launches - n0


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, 40, 64, 300])
@pytest.mark.parametrize("d,H,Hkv", DECODE_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(cuda, dtype, d, H, Hkv, split):
    """The dense kernel, stacked (the reference's splits of ``split`` or
    128 tokens) and merged (any split; scores included), against the
    plain versions: ragged lengths, an all-dead row, a dead split, a
    length bound inside the last split, q in the storage dtype."""
    rng = np.random.default_rng(0)
    B, S = 3, 300                        # S not a multiple of the splits
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
               for s in ((B, H, d), (B, Hkv, S, d), (B, Hkv, S, d)))
    mask = torch.from_numpy(rng.random((B, S)) < 0.5)
    mask[0, 128:256] = False             # a dead split
    lens = torch.tensor([300, 77, 0])    # ragged, and an all-dead row
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
        assert len(got) == 4
        _close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, 32, 64, 192])
@pytest.mark.parametrize("d,H,Hkv", DECODE_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_paged_kernel_matches_plain(cuda, dtype, d, H, Hkv,
                                                 split):
    """The paged kernel, stacked (one partial per logical block) and
    merged (runs of ``split`` tokens; scores included), against the plain
    versions: sentinel entries, dead blocks, live tokens inside a dead
    block, dead pages inside live runs, and a shard-local pool slice."""
    rng = np.random.default_rng(1)
    B, bs, nb, NB = 3, 16, 12, 40
    q = torch.from_numpy(rng.standard_normal((B, H, d), np.float32)).to(dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (NB + 1, bs, Hkv, d), np.float32)).to(dtype) for _ in range(2))
    table = torch.from_numpy(
        rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32))
    table[2, 5:] = NB                    # sentinel entries
    mask = torch.from_numpy(rng.random((B, nb * bs)) < 0.3)
    mask[1, :64] = False                 # dead blocks
    mask[2, 5 * bs:] = False
    live = mask.reshape(B, nb, bs).any(-1)
    live[0, 0] = False                   # live tokens in a dead block
    live[0, 6] = False                   # a dead page inside a live run
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


@pytest.mark.cuda
def test_merged_kernels_are_deterministic(cuda):
    """The in-cluster merge reduces the splits in split order: repeated
    launches at the serving shape (B 8, Hkv 8, S 2048, bf16) give the same
    bits, and every split count up to the cluster's 8 matches the plain
    version."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((8, 16, 128), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((8, 8, 2048, 128),
                                                 np.float32)).bfloat16()
            for _ in range(2))
    mask = torch.from_numpy(rng.random((8, 2048)) < 0.3)
    ref = tfd.flash_decode_merged(q, k, v, mask, scores=True)
    dev = [t.to(cuda) for t in (q, k, v, mask)]
    first = tfd.flash_decode_merged(*dev, scores=True)
    for _ in range(3):
        again = tfd.flash_decode_merged(*dev, scores=True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    for split in (256, 512, 1024, 2048):
        _close(tfd.flash_decode_merged(*dev, scores=True, split=split), ref)


@pytest.mark.cuda
def test_reduced_engine_runs_through_both_kernels(cuda):
    cfg = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    params = ttf.init_params(cfg, 0, device=cuda)
    pam = tpm.PAMManagerConfig(max_tokens=64, hot_capacity=8,
                               warm_capacity=8, compression=2,
                               recency_window=4, schedule_interval=2)
    eng = teng.ServingEngine(cfg, params, teng.ServingConfig(
        max_batch=3, max_len=64, block_size=8, hot_window=16, pam=pam),
        device=cuda)
    rng = np.random.default_rng(0)
    for i in range(4):
        eng.submit(teng.Request(i, rng.integers(0, cfg.vocab, 40), 16))
    fns = (tfd.flash_decode_merged, tfd.flash_decode_paged_merged,
           tfd.flash_decode, tfd.flash_decode_paged)
    n0 = [f.launches for f in fns]
    summ = eng.run()
    steps = summ["decode_device_steps"]
    assert summ["finished"] == 4 and summ["total_tokens"] == 64
    ran = [f.launches - n for f, n in zip(fns, n0)]
    assert ran == [cfg.n_layers * steps] * 2 + [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,d", [
    (2, 16, 8, 200, 200, 128),     # qwen3-0.6b heads, ragged tiles
    (1, 8, 8, 130, 130, 128),      # MHA (pam-llama-7b's group of 1)
    (2, 4, 2, 96, 96, 16),         # the reduced configs' heads
    (1, 4, 2, 70, 150, 16),        # Sq != Sk
    (1, 4, 2, 70, 150, 128),       # Sq != Sk on the wgmma kernels (bf16)
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_plain(cuda, dtype, causal, B, H, Hkv,
                                             Sq, Sk, d):
    rng = np.random.default_rng(Sq + d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32))
                   .to(dtype) for s in ((B, H, Sq, d), (B, Hkv, Sk, d),
                                        (B, Hkv, Sk, d), (B, H, Sq, d)))
    fwd_tol = (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
               else TOL)
    bwd_tol = (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
               else dict(rtol=1e-3, atol=1e-3))
    ref_o, ref_lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    ref_g = tfa.flash_attention_bwd(q, k, v, ref_o, ref_lse, do,
                                    causal=causal)
    n0 = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches,
          tfa.flash_attention.wgmma_launches,
          tfa.flash_attention_bwd.wgmma_launches)
    qc, kc, vc = (t.to(cuda).requires_grad_() for t in (q, k, v))
    o, lse = tfa.flash_attention_fwd(qc.detach(), kc.detach(), vc.detach(),
                                     causal=causal)
    out = tfa.flash_attention(qc, kc, vc, causal=causal)
    out.backward(do.to(cuda))
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == n0[0] + 2
    assert tfa.flash_attention_bwd.launches == n0[1] + 1
    # bf16 with head dim 128 runs the wgmma kernels, the rest the CUDA-core
    # ones
    wgmma = dtype == torch.bfloat16 and d == 128
    assert tfa._variant(dtype, d) == ("wgmma" if wgmma else "cuda_core")
    assert tfa.flash_attention.wgmma_launches == n0[2] + 2 * wgmma
    assert tfa.flash_attention_bwd.wgmma_launches == n0[3] + wgmma
    assert out.dtype == dtype and qc.grad.dtype == dtype
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.numpy(), **TOL)
    for got, ref in ((o, ref_o), (out, ref_o)):
        np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                                   ref.float().numpy(), **fwd_tol)
    for got, ref in zip((qc.grad, kc.grad, vc.grad), ref_g):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().numpy(), **bwd_tol)


@pytest.mark.cuda
def test_flash_attention_wgmma_long_causal_matches_plain(cuda):
    """The wgmma kernels at qwen3-0.6b's heads over a train-length causal
    sequence (16 query tiles, 32 key tiles of the backward's dQ pass),
    held to the plain versions run on the card in fp32."""
    g = torch.Generator(device=cuda).manual_seed(2048)
    B, H, Hkv, S, d = 1, 16, 8, 2048, 128
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).bfloat16()
                   for s in ((B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d),
                             (B, H, S, d)))
    scale = d ** -0.5
    n0 = (tfa.flash_attention.wgmma_launches,
          tfa.flash_attention_bwd.wgmma_launches)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.wgmma_launches,
            tfa.flash_attention_bwd.wgmma_launches) == (n0[0] + 1, n0[1] + 1)
    ref_o, ref_lse = tfa._fwd_plain(q, k, v, True, scale)
    torch.testing.assert_close(lse, ref_lse, **TOL)
    torch.testing.assert_close(o.float(), ref_o.float(), rtol=2e-2,
                               atol=2e-2)
    ref_g = tfa._bwd_plain(q, k, v, o, lse, do, True, scale)
    for got, ref in zip(grads, ref_g):
        torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)


def _ssd_case(seed, B, L, H, G, view, dtype):
    """SSD operands at mamba2-780m's head shape (N 128, P 64) with the
    model's decay rates (a = -exp(a_log), a_log from log 1 to log 16);
    with ``view`` x, b and c are column slices of one conv-output-like
    tensor, as ssm_forward passes them."""
    N, P = 128, 64
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal(
        (B, L, H * P + 2 * G * N), np.float32) * 0.5).to(dtype)
    if view:
        x = xbc[..., :H * P].reshape(B, L, H, P)
        b = xbc[..., H * P:H * P + G * N].reshape(B, L, G, N)
        c = xbc[..., H * P + G * N:].reshape(B, L, G, N)
    else:
        x, b, c = (t.contiguous() for t in (
            xbc[..., :H * P].reshape(B, L, H, P),
            xbc[..., H * P:H * P + G * N].reshape(B, L, G, N),
            xbc[..., H * P + G * N:].reshape(B, L, G, N)))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((B, L, H), np.float32)))
    a = -torch.exp(torch.linspace(0.0, float(np.log(16.0)), H))
    d = torch.from_numpy(rng.standard_normal(H, np.float32))
    dy = torch.from_numpy(rng.standard_normal((B, L, H, P),
                                              np.float32)).to(dtype)
    return x, dt, a, b, c, d, dy


def _ssd_close(got, ref, dtype, grad=False):
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    if dtype == torch.bfloat16:
        tol = dict(rtol=2e-2, atol=2e-2 * max(1.0, np.abs(ref).max())
                   if grad else 2e-2)
    elif grad:
        tol = dict(rtol=0, atol=1e-3 * max(np.abs(ref).max(), 1e-30))
    else:
        tol = dict(rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,G,chunk,view", [
    (2, 300, 4, 2, 128, True),     # three chunks, ragged tail, two groups
    (1, 100, 2, 1, 128, True),     # one short chunk (Q = L = 100)
    (1, 2047, 2, 1, 128, False),   # sixteen chunks, one token short
    (2, 257, 4, 1, 64, True),      # chunk 64
    (1, 8300, 2, 1, 128, True),    # 65 chunks, past 64
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernels_match_plain(cuda, dtype, B, L, H, G, chunk, view):
    x, dt, a, b, c, d, dy = _ssd_case(L + H, B, L, H, G, view, dtype)
    ref_y, ref_st = tss.ssd_scan_fwd(x, dt, a, b, c, d, chunk=chunk)
    ref_g = tss.ssd_scan_bwd(x, dt, a, b, c, d, ref_st, dy, chunk=chunk)
    n0 = (tss.ssd_scan.launches, tss.ssd_scan_bwd.launches)
    w0 = (tss.ssd_scan.wgmma_launches, tss.ssd_scan_bwd.wgmma_launches)
    xc, dtc, ac, bc, cc, dc = (t.to(cuda).requires_grad_()
                               for t in (x, dt, a, b, c, d))
    y, st = tss.ssd_scan_fwd(xc.detach(), dtc.detach(), ac.detach(),
                             bc.detach(), cc.detach(), dc.detach(),
                             chunk=chunk)
    out = tss.ssd_scan(xc, dtc, ac, bc, cc, dc, chunk=chunk)
    out.backward(dy.to(cuda))
    torch.cuda.synchronize()
    assert tss.ssd_scan.launches == n0[0] + 2
    assert tss.ssd_scan_bwd.launches == n0[1] + 1
    wgmma = dtype == torch.bfloat16     # (N, P) = (128, 64): the wgmma pair
    assert (tss.ssd_scan.wgmma_launches - w0[0],
            tss.ssd_scan_bwd.wgmma_launches - w0[1]) == (
                (2, 1) if wgmma else (0, 0))
    assert out.dtype == dtype and xc.grad.dtype == dtype
    _ssd_close(y, ref_y, dtype)
    _ssd_close(out.detach(), ref_y, dtype)
    _ssd_close(st, ref_st, torch.float32, grad=True)
    for got, ref in zip((xc.grad, dtc.grad, ac.grad, bc.grad, cc.grad,
                         dc.grad), ref_g):
        _ssd_close(got, ref, dtype, grad=True)


@pytest.mark.cuda
def test_ssd_scan_refuses_unbuilt_shapes(cuda):
    x = torch.zeros((1, 16, 2, 32), device=cuda)
    b = torch.zeros((1, 16, 1, 128), device=cuda)
    dt = torch.zeros((1, 16, 2), device=cuda)
    h = torch.zeros(2, device=cuda)
    with pytest.raises(ValueError, match="not built"):
        tss.ssd_scan(x, dt, h, b, b, h)
