"""The bf16 wgmma variant of the port's ``flash_attention`` on the CPU:
its routing, and a plain PyTorch model of its rounding points held to the
fp32 plain versions.

The wgmma kernels (``csrc/flash_attention_sm90.cu``,
``csrc/flash_attention_bwd_sm90.cu``) take bf16 operands into fp32
products, as the CUDA-core kernels do, but round two intermediates to
bf16 to feed them to the tensor cores as register operands: P before P V
and before dV = P^T dO, and dS before dQ = dS K and dK = dS^T Q.
``_fwd_rounded`` and ``_bwd_rounded`` compute with exactly those
roundings. Held to ``_fwd_plain`` / ``_bwd_plain`` on fp32 copies of the
same bf16 inputs at the card-side tolerance (rtol / atol 2e-2 on the
outputs; the LSE, which no rounding reaches, at 1e-4 / 1e-3), they
predict on the CPU that the kernels can meet that tolerance. Inputs come
from seeded numpy generators; every case is small (one batch row, 16 /
8 heads of 128, at most 256 positions) and builds nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402

ATTN_BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LSE_TOL = dict(rtol=1e-4, atol=1e-3)
QWEN_CASES = [(256, True), (200, False)]   # (S, causal), qwen3-0.6b heads


def _qwen_inputs(S, seed):
    """bf16 q, dO (1, 16, S, 128) and k, v (1, 8, S, 128)."""
    rng = np.random.default_rng(seed)
    shapes = ((1, 16, S, 128), (1, 8, S, 128), (1, 8, S, 128),
              (1, 16, S, 128))
    return [torch.from_numpy(rng.standard_normal(s, np.float32))
            .to(torch.bfloat16) for s in shapes]


@pytest.mark.parametrize("dtype,d,variant", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 128, "cuda_core"),
    (torch.bfloat16, 16, "cuda_core"),
    (torch.float32, 16, "cuda_core"),
])
def test_variant_routes_each_dtype_and_head_dim(dtype, d, variant):
    assert tfa._variant(dtype, d) == variant


@pytest.mark.parametrize("S,causal", QWEN_CASES)
def test_rounded_forward_within_bf16_tolerance_of_plain(S, causal):
    q, k, v, _ = _qwen_inputs(S, seed=S)
    scale = 128 ** -0.5
    o, lse = tfa._fwd_rounded(q, k, v, causal, scale)
    ref_o, ref_lse = tfa._fwd_plain(q.float(), k.float(), v.float(), causal,
                                    scale)
    assert o.dtype == torch.bfloat16 and ref_o.dtype == torch.float32
    torch.testing.assert_close(o.float(), ref_o, **ATTN_BF16_TOL)
    torch.testing.assert_close(lse, ref_lse, **LSE_TOL)
    # P really is rounded: without it the model is the plain version
    # rounded once to bf16
    assert not torch.equal(o, ref_o.to(torch.bfloat16))


@pytest.mark.parametrize("S,causal", QWEN_CASES)
def test_rounded_backward_within_bf16_tolerance_of_plain(S, causal):
    q, k, v, do = _qwen_inputs(S, seed=S + 1)
    scale = 128 ** -0.5
    o, lse = tfa._fwd_plain(q, k, v, causal, scale)
    got = tfa._bwd_rounded(q, k, v, o, lse, do, causal, scale)
    ref = tfa._bwd_plain(*(t.float() for t in (q, k, v, o)), lse, do.float(),
                         causal, scale)
    for g, r, t in zip(got, ref, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        torch.testing.assert_close(g.float(), r, **ATTN_BF16_TOL)
    # dS is rounded before dQ: the model is not the plain version rounded
    # once to bf16
    assert not torch.equal(got[0], ref[0].to(torch.bfloat16))


def test_cpu_bf16_head_dim_128_runs_plain_and_counts_no_launch():
    """The wgmma variant's shapes on CPU tensors go to the plain version:
    no launch of either variant is counted."""
    q, k, v, do = _qwen_inputs(64, seed=3)
    n0 = (tfa.flash_attention.launches, tfa.flash_attention.wgmma_launches,
          tfa.flash_attention_bwd.launches,
          tfa.flash_attention_bwd.wgmma_launches)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert (tfa.flash_attention.launches, tfa.flash_attention.wgmma_launches,
            tfa.flash_attention_bwd.launches,
            tfa.flash_attention_bwd.wgmma_launches) == n0
