"""The fp32 ``flash_attention`` kernels on the tensor cores (3xTF32,
``csrc/flash_attention_tf32x3.cu`` and ``csrc/flash_attention_bwd_tf32x3.cu``)
on the card, at every built (head dim, group) pair, causal and
bidirectional, over sequences that end in a ragged tile. Every test needs
an NVIDIA GPU and skips without one; the file imports neither JAX nor the
reference package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_flash_attention_tf32x3_cuda.py

Tolerances. Against the plain versions (fp32, TF32 off, on the card) the
card's fp32 bounds, as chip_smoke's attention rows and
``tests/test_torch_cuda.py``: O and the log-sum-exp rtol 1e-4 / atol
1e-3, the gradients rtol / atol 1e-3. Against ``_fwd_tf32x3`` /
``_bwd_tf32x3`` (the plain model of the same split, also on the card)
ten times tighter: O and the log-sum-exp rtol / atol 1e-5, the gradients
rtol / atol 1e-4. Kernel and model multiply the same TF32 halves; they
differ only in the order of the fp32 sums (over up to S products of
order 1, and the GQA group's heads) and in P's split against the running
rather than the final row max, a few fp32 ulps of each sum.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402

FP32_TOL = dict(rtol=1e-4, atol=1e-3)
FP32_BWD_TOL = dict(rtol=1e-3, atol=1e-3)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_BWD_TOL = dict(rtol=1e-4, atol=1e-4)
PAIRS = [pytest.param(d, rep, id=f"{d}-{rep}") for d, rep in tfa.BUILT]


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


def _inputs(d, rep, S, dtype, device, seed):
    """q, dO (2, H, S, d) and k, v (2, 2, S, d), H = 2 rep."""
    rng = np.random.default_rng(seed)
    shapes = ((2, 2 * rep, S, d), (2, 2, S, d), (2, 2, S, d),
              (2, 2 * rep, S, d))
    return [torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
            .to(device) for s in shapes]


def _counts():
    return (tfa.flash_attention.launches,
            tfa.flash_attention.tf32x3_launches,
            tfa.flash_attention.wgmma_launches,
            tfa.flash_attention_bwd.launches,
            tfa.flash_attention_bwd.tf32x3_launches,
            tfa.flash_attention_bwd.wgmma_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [150, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,rep", PAIRS)
def test_tf32x3_matches_plain_and_model(cuda, d, rep, causal, S):
    """Forward and backward against the plain versions at the card's fp32
    bounds and against the plain model of the split at the tighter
    ones; one launch a call of each direction, each a tf32x3 one."""
    q, k, v, do = _inputs(d, rep, S, torch.float32, cuda, S + d + rep)
    scale = d ** -0.5
    assert tfa._variant(torch.float32, d) == "tf32x3"
    assert tfa._variant(torch.float32, d, backward=True) == "tf32x3"
    n0 = _counts()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(n0, _counts())) == (1, 1, 0, 1, 1, 0)
    _close([o, lse], tfa._fwd_plain(q, k, v, causal, scale), FP32_TOL)
    _close([o, lse], tfa._fwd_tf32x3(q, k, v, causal, scale), MODEL_TOL)
    _close(grads, tfa._bwd_plain(q, k, v, o, lse, do, causal, scale),
           FP32_BWD_TOL)
    _close(grads, tfa._bwd_tf32x3(q, k, v, o, lse, do, causal, scale),
           MODEL_BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,rep", [(128, 16), (112, 1), (64, 7)])
def test_tf32x3_backward_is_bit_equal_across_calls(cuda, d, rep):
    """No atomics: two backward calls on the same inputs (the group's
    partials summed in head order) give the same bits."""
    q, k, v, do = _inputs(d, rep, 500, torch.float32, cuda, d + rep)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    first = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    second = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("d,rep", [(128, 2), (112, 1), (80, 1), (64, 7),
                                   (16, 2)])
def test_bf16_keeps_its_routes(cuda, d, rep):
    """bf16 still runs the wgmma kernels at head dims 64, 80, 112 and 128
    and the CUDA-core ones at 16, in both directions; no tf32x3 launch."""
    q, k, v, do = _inputs(d, rep, 130, torch.bfloat16, cuda, d)
    wgmma = d in tfa.WGMMA_FWD_DIMS
    assert tfa._variant(torch.bfloat16, d) == (
        "wgmma" if wgmma else "cuda_core")
    n0 = _counts()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(n0, _counts())) == (
        1, 0, int(wgmma), 1, 0, int(wgmma))


@pytest.mark.cuda
def test_unbuilt_pair_raises_before_a_launch(cuda):
    """An fp32 (head dim, group) pair outside BUILT raises in the wrapper
    and launches nothing: there is no fallback."""
    q, k, v, do = _inputs(128, 3, 64, torch.float32, cuda, 3)
    assert (128, 3) not in tfa.BUILT
    n0 = _counts()
    with pytest.raises(ValueError, match="not built"):
        tfa.flash_attention_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError, match="not built"):
        tfa.flash_attention_bwd(q, k, v, q, q[..., 0], do, causal=True)
    assert _counts() == n0
