"""The fp32 ``ssd_scan`` kernels on the tensor cores (3xTF32,
``csrc/ssd_scan_tf32x3.cu`` and ``csrc/ssd_scan_bwd_tf32x3.cu``) on the
card, at mamba2-780m's (d_state, head dim) = (128, 64) and zamba2-7b's
(64, 64), over sequences that end in a ragged chunk. Every test needs an
NVIDIA GPU and skips without one; the file imports neither JAX nor the
reference package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_ssd_scan_tf32x3_cuda.py

Tolerances: chip_smoke's ``SSD_FP32_TOL`` (rtol 1e-4, atol 1e-3; for the
chunk-start states and the gradients the atol times max(1, the leaf's
largest entry)) against the plain versions (fp32, TF32 off, on the card)
and against ``_fwd_tf32x3`` / ``_bwd_tf32x3``, the plain model of the
same split: kernel and model multiply the same TF32 halves, in another
order of fp32 sums (and the backward's g . (C h_in) as C . (g h_in^T)).
Neither comparison tells a 3xTF32 product from one TF32 product on the
gradients, so each result's norm-wise error against the plain versions
in float64 is also held within ``F64_RATIO`` (10) times the fp32 plain
versions' (``_f64_witness``; one TF32 product a product is 20 to 1,700
times, tests/test_torch_ssd_scan_tf32x3.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssd_scan as tss  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-3)
P = 64
# (B, L, H, G, N, chunk, view): x, B and C column views of one tensor, or
# contiguous
CASES = [
    pytest.param(2, 300, 4, 2, 128, 128, True, id="n128-ragged-groups"),
    pytest.param(1, 100, 2, 1, 128, 128, False, id="n128-short-chunk"),
    pytest.param(2, 257, 4, 1, 128, 64, True, id="n128-chunk64"),
    pytest.param(2, 500, 48, 1, 128, 128, True, id="n128-mamba2-parity"),
    pytest.param(2, 300, 8, 1, 64, 128, True, id="n64-ragged"),
    pytest.param(2, 500, 112, 1, 64, 128, True, id="n64-zamba2-parity"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(B, L, H, G, N, view, device, seed):
    """x, dt, a, b, c, d and dy on the card, from a seeded numpy
    generator: x, B and C at chip_smoke's scale 0.5 (column views of one
    (B, L, H P + 2 G N) tensor, or contiguous copies), dt = softplus(N(0,
    1)), a = -linspace(1, 16), D = 1."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal(
        (B, L, H * P + 2 * G * N), np.float32) * 0.5).to(device)
    x = xbc[..., :H * P].reshape(B, L, H, P)
    b = xbc[..., H * P:H * P + G * N].reshape(B, L, G, N)
    c = xbc[..., H * P + G * N:].reshape(B, L, G, N)
    if not view:
        x, b, c = x.contiguous(), b.contiguous(), c.contiguous()
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, L, H), np.float32))).to(device)
    a = -torch.linspace(1.0, 16.0, H, device=device)
    d = torch.ones(H, device=device)
    dy = torch.from_numpy(rng.standard_normal((B, L, H, P),
                                              np.float32)).to(device)
    return (x, dt, a, b, c, d), dy


def _close(got, ref, scaled: bool):
    for g, r in zip(got, ref):
        atol = TOL["atol"] * (max(1.0, float(r.abs().max())) if scaled
                              else 1.0)
        torch.testing.assert_close(g, r, rtol=TOL["rtol"], atol=atol)


def _counts():
    return tuple((f.launches, f.tf32x3_launches, f.wgmma_launches)
                 for f in (tss.ssd_scan, tss.ssd_scan_bwd))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,G,N,chunk,view", CASES)
def test_tf32x3_matches_plain_and_model(cuda, B, L, H, G, N, chunk, view):
    """y, the chunk-start states and the six gradients against the plain
    versions and the plain model of the split, and against float64
    within ``F64_RATIO`` times the fp32 plain versions' error; one tf32x3
    launch a call of each direction, no wgmma one."""
    ins, dy = _case(B, L, H, G, N, view, cuda, seed=L + H + N)
    assert tss._variant(torch.float32, N, P) == "tf32x3"
    n0 = _counts()
    y, st = tss.ssd_scan_fwd(*ins, chunk=chunk)
    grads = tss.ssd_scan_bwd(*ins, st, dy, chunk=chunk)
    torch.cuda.synchronize()
    assert tuple(tuple(v - u for u, v in zip(a, b))
                 for a, b in zip(n0, _counts())) == ((1, 1, 0), (1, 1, 0))
    ref_y, ref_st, _ = tss.ssd_chunked_states(*ins, chunk)
    _close([y], [ref_y], scaled=False)
    _close([st], [ref_st], scaled=True)
    _close(grads, tss._bwd_plain(*ins, st, dy, chunk), scaled=True)
    mod_y, mod_st = tss._fwd_tf32x3(*ins, chunk)
    _close([y], [mod_y], scaled=False)
    _close([st], [mod_st], scaled=True)
    _close(grads, tss._bwd_tf32x3(*ins, st, dy, chunk), scaled=True)
    witness = tss._f64_witness(ins, dy, chunk, y, st, grads)
    assert tss._f64_within(witness, tss.WITNESS_FWD + tss.WITNESS_BWD), (
        witness)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H", [(128, 48), (64, 112)])
def test_tf32x3_backward_is_bit_equal_across_calls(cuda, N, H):
    """No atomics: two backward calls on the same inputs (dB and dC summed
    over the group's heads, da and dD over batch and chunks, in a fixed
    order) give the same bits."""
    ins, dy = _case(2, 500, H, 1, N, True, cuda, seed=N + H)
    _, st = tss.ssd_scan_fwd(*ins)
    first = tss.ssd_scan_bwd(*ins, st, dy)
    second = tss.ssd_scan_bwd(*ins, st, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.cuda
def test_autograd_runs_the_tf32x3_pair(cuda):
    """``ssd_scan``'s autograd Function in fp32: the forward and the
    backward each one tf32x3 launch, gradients as ``ssd_scan_bwd``'s."""
    ins, dy = _case(1, 300, 4, 1, 128, True, cuda, seed=3)
    leaves = [t.detach().requires_grad_() for t in ins]
    n0 = _counts()
    tss.ssd_scan(*leaves).backward(dy)
    torch.cuda.synchronize()
    assert tuple(tuple(v - u for u, v in zip(a, b))
                 for a, b in zip(n0, _counts())) == ((1, 1, 0), (1, 1, 0))
    _, st = tss.ssd_scan_fwd(*ins)
    want = tss.ssd_scan_bwd(*ins, st, dy)
    _close([t.grad for t in leaves], want, scaled=True)


@pytest.mark.cuda
def test_unbuilt_or_misaligned_raises_before_a_launch(cuda):
    """An fp32 (d_state, head dim) outside SUPPORTED_NP, or x / B / C
    whose base or strides the 16-byte copies cannot take, raises in the
    wrapper and launches nothing: there is no fallback."""
    n0 = _counts()
    ins, _ = _case(1, 64, 2, 1, 32, True, cuda, seed=1)
    with pytest.raises(ValueError, match="not built"):
        tss.ssd_scan_fwd(*ins)
    ins, _ = _case(1, 64, 2, 1, 128, True, cuda, seed=2)
    x, dt, a, b, c, d = ins
    shifted = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16 bytes"):
        tss.ssd_scan_fwd(shifted, dt, a, b, c, d)
    assert _counts() == n0
