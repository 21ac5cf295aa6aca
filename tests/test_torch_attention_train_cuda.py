"""The ``flash_attention`` forward and backward on the card at the train
paths' (head dim, GQA group) pairs added for the vlm, audio and wider
dense families: minicpm-2b's (64, 1), internvl2-1b's (64, 7),
hubert-xlarge's (80, 1), qwen3-14b's (128, 5) and deepseek-67b's (128,
8). bf16 runs the wgmma kernels (``csrc/flash_attention_sm90.cu``,
``csrc/flash_attention_bwd_sm90.cu``: one wgmma launch each a call, held
to the plain versions and to ``_fwd_rounded`` / ``_bwd_rounded``, the
plain model of their bf16 roundings of P and dS), fp32 the 3xTF32
tensor-core ones (``csrc/flash_attention_tf32x3.cu``,
``csrc/flash_attention_bwd_tf32x3.cu``), causal and bidirectional, over
sequences that end in a ragged tile. Every test
needs an NVIDIA GPU and skips without one; the file imports neither JAX
nor the reference package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_attention_train_cuda.py

Tolerances, as chip_smoke's attention rows and ``tests/test_torch_cuda.py``:
bf16 outputs and gradients rtol / atol 2e-2 (both sides compute in fp32
and round to bf16, one bf16 step apart; the rounding of P and dS, which
``tests/test_torch_flash_attention_sm90.py`` bounds on the CPU at these
pairs), the fp32 log-sum-exp rtol 1e-4 / atol 1e-3; fp32 outputs rtol
1e-4 / atol 1e-3 and gradients rtol / atol 1e-3 (sums over up to S
products in another order); TF32 off.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FP32_TOL = dict(rtol=1e-4, atol=1e-3)
FP32_BWD_TOL = dict(rtol=1e-3, atol=1e-3)
# (H, Hkv, d): the new pairs at narrow head counts
PAIRS = {"minicpm-2b": (4, 4, 64), "internvl2-1b": (14, 2, 64),
         "hubert-xlarge": (8, 8, 80), "qwen3-14b": (10, 2, 128),
         "deepseek-67b": (16, 2, 128)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, tol):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().float().cpu().numpy(),
                                   r.detach().float().cpu().numpy(), **tol)


def _counts():
    return (tfa.flash_attention.launches, tfa.flash_attention.wgmma_launches,
            tfa.flash_attention_bwd.launches,
            tfa.flash_attention_bwd.wgmma_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [200, 130])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", list(PAIRS))
def test_train_pair_forward_backward_match_plain(cuda, arch, dtype, causal,
                                                 S):
    """``flash_attention``'s autograd Function on the card against the
    plain versions on the same inputs: one forward and one backward
    launch a call, both wgmma ones in bf16, both tf32x3 ones in fp32."""
    H, Hkv, d = PAIRS[arch]
    assert (d, H // Hkv) in tfa.BUILT_BWD
    rng = np.random.default_rng(S + d + H)
    B = 2
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32))
                   .to(dtype).to(cuda)
                   for s in ((B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d),
                             (B, H, S, d)))
    scale = d ** -0.5
    wgmma = dtype == torch.bfloat16
    assert tfa._variant(dtype, d, backward=True) == (
        "wgmma" if wgmma else "tf32x3")
    qc, kc, vc = (t.detach().requires_grad_() for t in (q, k, v))
    n0 = _counts()
    out = tfa.flash_attention(qc, kc, vc, causal=causal)
    out.backward(do)
    torch.cuda.synchronize()
    n1 = _counts()
    assert tuple(b - a for a, b in zip(n0, n1)) == (1, int(wgmma), 1,
                                                    int(wgmma))
    grads = (qc.grad, kc.grad, vc.grad)
    assert all(g.dtype == dtype and g.shape == t.shape
               for g, t in zip(grads, (q, k, v)))
    ref_o, ref_lse = tfa._fwd_plain(q, k, v, causal, scale)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    _close([lse], [ref_lse], FP32_TOL)
    _close([out], [ref_o], BF16_TOL if wgmma else FP32_TOL)
    # the backward of the kernel forward's own (o, lse), as autograd ran it
    ref_g = tfa._bwd_plain(q, k, v, o, lse, do, causal, scale)
    _close(grads, ref_g, BF16_TOL if wgmma else FP32_BWD_TOL)
    if wgmma:
        _close(grads, tfa._bwd_rounded(q, k, v, o, lse, do, causal, scale),
               BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,causal,S", [("internvl2-1b", True, 2048),
                                           ("hubert-xlarge", False, 1500),
                                           ("deepseek-67b", True, 1024)])
def test_train_pair_wgmma_backward_at_train_length(cuda, arch, causal, S):
    """The bf16 wgmma backward over a train-length sequence: the group's
    serial walk over every query tile of its kv head (group 7 at S 2048:
    7 x 32 tiles a key CTA), one wgmma launch, against the plain
    version run on the card in fp32."""
    H, Hkv, d = PAIRS[arch]
    g = torch.Generator(device=cuda).manual_seed(S + d)
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).bfloat16()
                   for s in ((1, H, S, d), (1, Hkv, S, d), (1, Hkv, S, d),
                             (1, H, S, d)))
    scale = d ** -0.5
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    n0 = tfa.flash_attention_bwd.wgmma_launches
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.wgmma_launches == n0 + 1
    _close(grads, tfa._bwd_plain(q, k, v, o, lse, do, causal, scale),
           BF16_TOL)
