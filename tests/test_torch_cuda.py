"""The port's CUDA kernels on the card, held to their plain versions.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the reference package, so it runs on a machine
with PyTorch alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_cuda.py

Tolerance: both sides upcast the stored K/V to fp32 and differ only in
summation order (warp-parallel online softmax vs one reduction), so
rtol 1e-4 / atol 1e-4 on (o, m, l), with TF32 off for the plain side's
matrix products. The attention backward sums up to S products per
gradient entry in another order: rtol / atol 1e-3 in fp32. In bf16
both sides compute in fp32 and round the result to bf16, so they may
differ by one bf16 step: rtol / atol 2e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
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


@pytest.mark.cuda
@pytest.mark.parametrize("d,H,Hkv", [(128, 16, 8), (128, 8, 8), (16, 4, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(cuda, dtype, d, H, Hkv):
    rng = np.random.default_rng(0)
    B, S = 3, 300                        # S not a multiple of block_s
    q = torch.from_numpy(rng.standard_normal((B, H, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Hkv, S, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, Hkv, S, d), np.float32))
    mask = torch.from_numpy(rng.random((B, S)) < 0.5)
    mask[0, 128:256] = False             # a dead split
    lens = torch.tensor([300, 77, 0])    # ragged, and an all-dead row
    k, v = k.to(dtype), v.to(dtype)
    ref = tfd.flash_decode(q, k, v, mask, kv_lens=lens, block_s=128)
    n0 = tfd.flash_decode.launches
    got = tfd.flash_decode(q.to(cuda), k.to(cuda), v.to(cuda),
                           mask.to(cuda), kv_lens=lens.to(cuda),
                           block_s=128)
    torch.cuda.synchronize()
    assert tfd.flash_decode.launches == n0 + 1
    _close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_paged_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(1)
    B, H, Hkv, d, bs, nb, NB = 3, 16, 8, 128, 16, 12, 40
    q = torch.from_numpy(rng.standard_normal((B, H, d), np.float32))
    kp = torch.from_numpy(
        rng.standard_normal((NB + 1, bs, Hkv, d), np.float32)).to(dtype)
    vp = torch.from_numpy(
        rng.standard_normal((NB + 1, bs, Hkv, d), np.float32)).to(dtype)
    table = torch.from_numpy(
        rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32))
    table[2, 5:] = NB                    # sentinel entries
    mask = torch.from_numpy(rng.random((B, nb * bs)) < 0.3)
    mask[1, :64] = False                 # dead blocks
    mask[2, 5 * bs:] = False
    live = mask.reshape(B, nb, bs).any(-1)
    live[0, 0] = False                   # live tokens in a dead block
    ref = tfd.flash_decode_paged(q, kp, vp, table, mask, block_live=live)
    n0 = tfd.flash_decode_paged.launches
    got = tfd.flash_decode_paged(q.to(cuda), kp.to(cuda), vp.to(cuda),
                                 table.to(cuda), mask.to(cuda),
                                 block_live=live.to(cuda))
    torch.cuda.synchronize()
    assert tfd.flash_decode_paged.launches == n0 + 1
    _close(got, ref)


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
    n0 = (tfd.flash_decode.launches, tfd.flash_decode_paged.launches)
    summ = eng.run()
    steps = summ["decode_device_steps"]
    assert summ["finished"] == 4 and summ["total_tokens"] == 64
    assert tfd.flash_decode.launches - n0[0] == cfg.n_layers * steps
    assert tfd.flash_decode_paged.launches - n0[1] == cfg.n_layers * steps


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,d", [
    (2, 16, 8, 200, 200, 128),     # qwen3-0.6b heads, ragged tiles
    (1, 8, 8, 130, 130, 128),      # MHA (pam-llama-7b's group of 1)
    (2, 4, 2, 96, 96, 16),         # the reduced configs' heads
    (1, 4, 2, 70, 150, 16),        # Sq != Sk
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
    n0 = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    qc, kc, vc = (t.to(cuda).requires_grad_() for t in (q, k, v))
    o, lse = tfa.flash_attention_fwd(qc.detach(), kc.detach(), vc.detach(),
                                     causal=causal)
    out = tfa.flash_attention(qc, kc, vc, causal=causal)
    out.backward(do.to(cuda))
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == n0[0] + 2
    assert tfa.flash_attention_bwd.launches == n0[1] + 1
    assert out.dtype == dtype and qc.grad.dtype == dtype
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.numpy(), **TOL)
    for got, ref in ((o, ref_o), (out, ref_o)):
        np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                                   ref.float().numpy(), **fwd_tol)
    for got, ref in zip((qc.grad, kc.grad, vc.grad), ref_g):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().numpy(), **bwd_tol)
