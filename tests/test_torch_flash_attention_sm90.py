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
predict on the CPU that the kernels can meet that tolerance. Both
directions run the wgmma kernels at head dims 64, 80, 112 and 128, at
the train pairs: internvl2-1b's 14 / 2 heads of 64, minicpm-2b's 36 / 36
of 64 (here 4 / 4), hubert-xlarge's 16 / 16 of 80, zamba2-7b's shared
block's 32 / 32 of 112 (here 4 / 4), qwen3-0.6b's 16 / 8, qwen3-14b's
group 5 (here 10 / 2) and deepseek-67b's group 8 (here 16 / 2) of 128;
the head-dim lists and both directions' (head dim, group) pairs are
parsed out of the CUDA sources and held to the Python route.
Inputs come from seeded numpy generators; every case is small (one batch
row, at most 16 heads and 256 positions) and builds nothing.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402

ATTN_BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LSE_TOL = dict(rtol=1e-4, atol=1e-3)
QWEN_CASES = [(256, True), (200, False)]   # (S, causal), qwen3-0.6b heads
QWEN_HEADS = (16, 8, 128)                  # (H, Hkv, d)
# (S, causal, (H, Hkv, d)) of the train pairs past qwen3-0.6b's, with
# ragged last tiles
PAIR_CASES = [
    pytest.param(200, True, (14, 2, 64), id="200-True-internvl2-1b"),
    pytest.param(150, False, (16, 16, 80), id="150-False-hubert-xlarge"),
    pytest.param(130, True, (4, 4, 64), id="130-True-minicpm-2b"),
    pytest.param(100, True, (10, 2, 128), id="100-True-qwen3-14b"),
    pytest.param(70, True, (16, 2, 128), id="70-True-deepseek-67b"),
    pytest.param(160, True, (4, 4, 112), id="160-True-zamba2-7b")]
# the qwen3-0.6b cases keep their ids
FWD_CASES = [pytest.param(S, causal, QWEN_HEADS, id=f"{S}-{causal}")
             for S, causal in QWEN_CASES] + PAIR_CASES
CSRC = Path(tfa.__file__).parent / "csrc"


def _inputs(S, seed, heads=QWEN_HEADS):
    """bf16 q, dO (1, H, S, d) and k, v (1, Hkv, S, d)."""
    H, Hkv, d = heads
    rng = np.random.default_rng(seed)
    shapes = ((1, H, S, d), (1, Hkv, S, d), (1, Hkv, S, d), (1, H, S, d))
    return [torch.from_numpy(rng.standard_normal(s, np.float32))
            .to(torch.bfloat16) for s in shapes]


@pytest.mark.parametrize("dtype,d,variant", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 128, "tf32x3"),
    (torch.bfloat16, 16, "cuda_core"),
    (torch.float32, 16, "tf32x3"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 80, "wgmma"),
    (torch.float32, 64, "tf32x3"),
    (torch.float32, 80, "tf32x3"),
    (torch.bfloat16, 112, "wgmma"),
    (torch.float32, 112, "tf32x3"),
])
def test_variant_routes_each_dtype_and_head_dim(dtype, d, variant):
    """The forward's route by (dtype, head dim)."""
    assert tfa._variant(dtype, d) == variant


@pytest.mark.parametrize("dtype,d,variant", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 80, "wgmma"),
    (torch.bfloat16, 16, "cuda_core"),
    (torch.float32, 64, "tf32x3"),
    (torch.float32, 80, "tf32x3"),
    (torch.float32, 128, "tf32x3"),
    (torch.bfloat16, 112, "wgmma"),
])
def test_backward_variant_keeps_wgmma_at_head_dim_128(dtype, d, variant):
    """The backward's route: wgmma for bf16 at head dims 64, 80, 112 and
    128 (the forward's wgmma dims), the 3xTF32 tensor-core kernels for
    fp32 at every head dim, the CUDA cores for bf16 at head dim 16."""
    assert tfa._variant(dtype, d, backward=True) == variant


def _macro_items(path: Path, macro: str) -> tuple:
    """The integer arguments of each ``X(..)`` in ``#define macro(X)``."""
    body = re.search(rf"#define {macro}\(X\)((?:.*\\\n)*.*)",
                     path.read_text()).group(1)
    return tuple(tuple(int(n) for n in re.findall(r"\d+", item))
                 for item in re.findall(r"X\(([^)]*)\)", body))


@pytest.mark.parametrize("macro,dims", [
    ("PAM_ATTN_WGMMA_FWD_DIMS", tfa.WGMMA_FWD_DIMS),
    ("PAM_ATTN_WGMMA_BWD_DIMS", tfa.WGMMA_BWD_DIMS),
])
def test_wgmma_head_dims_match_the_cuda_source(macro, dims):
    """The head dims whose bf16 kernels are the wgmma ones, as the CUDA
    side lists them (``csrc/attention_common.cuh``: the CUDA-core
    dispatch leaves bf16 out at these dims) and as the Python route
    sends them."""
    assert tuple(d for (d,) in _macro_items(
        CSRC / "attention_common.cuh", macro)) == dims


def test_wgmma_forward_pairs_match_the_cuda_dispatch():
    """The wgmma forward instantiates exactly the built (head dim, group)
    pairs at its head dims (``csrc/flash_attention_sm90.cu``'s
    ``PAM_ATTN_FWD90_BUILT``): every bf16 pair the route sends there is
    built, and no other."""
    want = tuple(p for p in tfa.BUILT if p[0] in tfa.WGMMA_FWD_DIMS)
    assert want == ((64, 1), (64, 7), (80, 1), (112, 1), (128, 1), (128, 2),
                    (128, 5), (128, 8), (128, 16))
    assert _macro_items(CSRC / "flash_attention_sm90.cu",
                        "PAM_ATTN_FWD90_BUILT") == want


def test_wgmma_backward_pairs_match_the_cuda_dispatch():
    """The wgmma backward instantiates exactly the built backward pairs at
    its head dims (``csrc/flash_attention_bwd_sm90.cu``'s
    ``PAM_ATTN_BWD90_BUILT``): every train pair of the full-width
    configs, the forward's list."""
    want = tuple(p for p in tfa.BUILT_BWD if p[0] in tfa.WGMMA_BWD_DIMS)
    assert want == ((64, 1), (64, 7), (80, 1), (112, 1), (128, 1), (128, 2),
                    (128, 5), (128, 8), (128, 16))
    assert _macro_items(CSRC / "flash_attention_bwd_sm90.cu",
                        "PAM_ATTN_BWD90_BUILT") == want
    assert want == tuple(p for p in tfa.BUILT if p[0] in tfa.WGMMA_FWD_DIMS)


@pytest.mark.parametrize("S,causal,heads", FWD_CASES)
def test_rounded_forward_within_bf16_tolerance_of_plain(S, causal, heads):
    q, k, v, _ = _inputs(S, seed=S, heads=heads)
    scale = heads[2] ** -0.5
    o, lse = tfa._fwd_rounded(q, k, v, causal, scale)
    ref_o, ref_lse = tfa._fwd_plain(q.float(), k.float(), v.float(), causal,
                                    scale)
    assert o.dtype == torch.bfloat16 and ref_o.dtype == torch.float32
    torch.testing.assert_close(o.float(), ref_o, **ATTN_BF16_TOL)
    torch.testing.assert_close(lse, ref_lse, **LSE_TOL)
    # P really is rounded: without it the model is the plain version
    # rounded once to bf16
    assert not torch.equal(o, ref_o.to(torch.bfloat16))


@pytest.mark.parametrize("S,causal,heads", FWD_CASES)
def test_rounded_backward_within_bf16_tolerance_of_plain(S, causal, heads):
    q, k, v, do = _inputs(S, seed=S + 1, heads=heads)
    scale = heads[2] ** -0.5
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
    q, k, v, do = _inputs(64, seed=3)
    n0 = (tfa.flash_attention.launches, tfa.flash_attention.wgmma_launches,
          tfa.flash_attention_bwd.launches,
          tfa.flash_attention_bwd.wgmma_launches)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert (tfa.flash_attention.launches, tfa.flash_attention.wgmma_launches,
            tfa.flash_attention_bwd.launches,
            tfa.flash_attention_bwd.wgmma_launches) == n0
