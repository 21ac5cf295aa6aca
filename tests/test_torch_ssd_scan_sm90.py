"""The bf16 wgmma variant of the port's ``ssd_scan`` on the CPU: its
routing, and a plain PyTorch model of its decomposition and rounding
points.

The wgmma kernels (``csrc/ssd_scan_sm90.cu``, ``csrc/ssd_scan_bwd_sm90.cu``)
run Mamba-2's chunked SSD decomposition: decay terms, chunk states, an
elementwise state pass and chunk outputs forward; per-chunk dstate terms
and a reverse pass, then a t-side and a u-side of every chunk backward.
They take bf16 operands into fp32 products and round intermediates to
bf16 to feed the tensor cores: forward w x, h_in and M = S o E dt_u, each
as a hi / lo pair of bf16 operands; backward exp(s) g, h_in, dh, Pb = G o
E dt_u, w x and S' o E dt_u, once each. ``_fwd_rounded`` and
``_bwd_rounded`` compute in exactly that decomposition and with exactly
those roundings (``round_bf16``).

- With the roundings off, the model is held to the Pallas kernel
  (``interpret=True``) at rtol / atol 2e-4 and to ``jax.grad`` of
  ``ssd_chunked_jnp`` within 1e-4 of each leaf's largest entry, as
  ``tests/test_torch_ssd_scan.py`` holds the plain versions: this checks
  the decomposition.
- With the roundings on, it is held to ``ssd_chunked_states`` and
  ``_bwd_plain`` on fp32 copies of the same bf16 inputs at the card's
  tolerance (``chip_smoke.py``): y at rtol / atol 2e-2, the fp32 states at
  rtol 1e-4 and atol 1e-3 x max(1, their largest entry), each gradient at
  rtol 2e-2 and atol 2e-2 x max(1, the leaf's largest entry). That
  predicts on the CPU that the kernels can meet it.

Largest errors of the rounded model against the plain versions (absolute;
leaf max in brackets), mamba2-780m's (N, P) = (128, 64) with chip_smoke's
input scales: ragged (B 1, L 300, H 4): y 0.0575 (20.2), states 4.4e-6
relative, dx 0.171 (49.0), ddt 0.0360 (84.7), da 0.0175 (89.5), db 0.129
(51.6), dc 0.127 (48.7), dD 0; groups (B 2, L 256, H 6, G 2): y 0.0564,
dx 0.198, ddt 0.0522, da 0.00828, db 0.164, dc 0.132, dD 0; strong decay
(dt 2, a -4 / -0.01, L 384): y 0.125 (62.4; one bf16 step of y), dx 0.360
(121.5), ddt 0.284 (196.1), da 293 (155243), db 0.322, dc 0.347, dD 0.
With one bf16 rounding in place of each forward pair, the strong-decay y
misses 2e-2 on 394 entries and the states are 2.6e-3 off: hence the
pairs (``python tests/test_torch_ssd_scan_sm90.py`` prints these
errors). Inputs come from seeded numpy generators; every case is small
and builds nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan as jssd  # noqa: E402
from repro.models.ssm import ssd_chunked_jnp  # noqa: E402
from repro_torch.kernels import ssd_scan as tss  # noqa: E402

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_REL = 1e-4
CARD_TOL = dict(rtol=2e-2, atol=2e-2)
STATE_TOL = dict(rtol=1e-4, atol=1e-3)
NAMES = ("dx", "ddt", "da", "db", "dc", "dd")


def _fp32_inputs(B, L, H, G, N, P, seed):
    """x, dt, a, b, c, d_skip as fp32 numpy (test_torch_ssd_scan.py's
    scales)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    b = (rng.standard_normal((B, L, G, N)) / np.sqrt(N)).astype(np.float32)
    c = (rng.standard_normal((B, L, G, N)) / np.sqrt(N)).astype(np.float32)
    d = rng.standard_normal(H).astype(np.float32)
    return x, dt, a, b, c, d


def _strong_decay():
    """Strong decay over many chunks (test_kernels.py's stability case)."""
    B, L, H, G, N, P = 1, 256, 2, 1, 16, 8
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, L, H, P), np.float32)
    dt = np.full((B, L, H), 2.0, np.float32)
    a = np.array([-4.0, -0.01], np.float32)
    b = (rng.standard_normal((B, L, G, N)) / 4.0).astype(np.float32)
    c = (rng.standard_normal((B, L, G, N)) / 4.0).astype(np.float32)
    return x, dt, a, b, c, np.zeros((H,), np.float32)


DECOMP_CASES = {
    "multi_chunk": (_fp32_inputs(1, 64, 2, 1, 16, 8, 0), 32),
    "padding_groups": (_fp32_inputs(2, 100, 4, 2, 8, 16, 1), 64),
    "mamba2_np_ragged": (_fp32_inputs(1, 150, 2, 1, 128, 64, 2), 64),
    "strong_decay": (_strong_decay(), 64),
}


def _t(arrs):
    return [torch.from_numpy(np.array(v)) for v in arrs]


def _j(arrs):
    return [jnp.asarray(v) for v in arrs]


@pytest.mark.parametrize("dtype,N,P,variant", [
    (torch.bfloat16, 128, 64, "wgmma"),
    (torch.float32, 128, 64, "cuda_core"),
    (torch.bfloat16, 16, 8, None),          # None: not built, raises
    (torch.float32, 8, 16, None),
    (torch.float16, 128, 64, None),
])
def test_variant_routes_each_dtype_and_shape(dtype, N, P, variant):
    if variant is None:
        with pytest.raises(ValueError, match="not built"):
            tss._variant(dtype, N, P)
    else:
        assert tss._variant(dtype, N, P) == variant


@pytest.mark.parametrize("rep,hb", [(48, 6), (6, 6), (8, 4), (2, 2), (3, 3),
                                    (1, 1), (5, 1)])
def test_head_block_divides_the_group(rep, hb):
    assert tss._head_block(rep) == hb


@pytest.mark.parametrize("case", list(DECOMP_CASES))
def test_unrounded_forward_model_matches_pallas(case):
    ins, chunk = DECOMP_CASES[case]
    want = np.asarray(jssd(*_j(ins), chunk=chunk, interpret=True))
    y, st = tss._fwd_rounded(*_t(ins), chunk, round_bf16=False)
    np.testing.assert_allclose(y.numpy(), want, **FWD_TOL)
    _, ref_st, _ = tss.ssd_chunked_states(*_t(ins), chunk)
    np.testing.assert_allclose(st.numpy(), ref_st.numpy(), **FWD_TOL)


@pytest.mark.parametrize("case", list(DECOMP_CASES))
def test_unrounded_backward_model_matches_jax_grad(case):
    ins, chunk = DECOMP_CASES[case]
    L = ins[0].shape[1]
    dy = np.random.default_rng(9).standard_normal(ins[0].shape, np.float32)

    def f(*args):
        return jnp.sum(ssd_chunked_jnp(*args, min(chunk, max(L, 8))) * dy)
    want = jax.grad(f, argnums=tuple(range(6)))(*_j(ins))
    _, st = tss._fwd_rounded(*_t(ins), chunk, round_bf16=False)
    got = tss._bwd_rounded(*_t(ins), st, torch.from_numpy(dy), chunk,
                           round_bf16=False)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()), (name, err)


def _bf16_case(B, L, H, G, seed, strong=False):
    """bf16 x, b, c (column views of one conv-output-like tensor, scaled
    0.5 as chip_smoke's) and dy; fp32 dt, a, d: mamba2-780m's (N, P) =
    (128, 64) and decay rates -linspace(1, 16), or strong decay."""
    N, P = 128, 64
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal(
        (B, L, H * P + 2 * G * N), np.float32) * 0.5).bfloat16()
    x = xbc[..., :H * P].reshape(B, L, H, P)
    b = xbc[..., H * P:H * P + G * N].reshape(B, L, G, N)
    c = xbc[..., H * P + G * N:].reshape(B, L, G, N)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, L, H), np.float32)))
    a = -torch.linspace(1.0, 16.0, H)
    if strong:
        dt = torch.full((B, L, H), 2.0)
        a = torch.tensor([-4.0, -0.01] * (H // 2))
    d = torch.ones(H)
    dy = torch.from_numpy(rng.standard_normal((B, L, H, P),
                                              np.float32)).bfloat16()
    return (x, dt, a, b, c, d), dy


ROUNDED_CASES = {
    "ragged_heads": (1, 300, 4, 1, 0, False),
    "groups": (2, 256, 6, 2, 1, False),
    "strong_decay": (1, 384, 2, 1, 2, True),
}


def _card_close(got, ref, tol, scaled):
    got, ref = got.float(), ref.float()
    atol = tol["atol"] * (max(1.0, float(ref.abs().max())) if scaled else 1)
    torch.testing.assert_close(got, ref, rtol=tol["rtol"], atol=atol)


@pytest.mark.parametrize("case", list(ROUNDED_CASES))
def test_rounded_forward_within_card_tolerance_of_plain(case):
    ins, _ = _bf16_case(*ROUNDED_CASES[case])
    y, st = tss._fwd_rounded(*ins, 128)
    ref_y, ref_st, _ = tss.ssd_chunked_states(*(t.float() for t in ins), 128)
    assert y.dtype == torch.bfloat16 and ref_y.dtype == torch.float32
    _card_close(y, ref_y, CARD_TOL, scaled=False)
    _card_close(st, ref_st, STATE_TOL, scaled=True)
    # the operands really are rounded: the states differ from the plain
    # version's
    assert not torch.equal(st, ref_st)


@pytest.mark.parametrize("case", list(ROUNDED_CASES))
def test_rounded_backward_within_card_tolerance_of_plain(case):
    ins, dy = _bf16_case(*ROUNDED_CASES[case])
    f32 = [t.float() for t in ins]
    _, st, _ = tss.ssd_chunked_states(*f32, 128)
    got = tss._bwd_rounded(*ins, st, dy, 128)
    ref = tss._bwd_plain(*f32, st, dy.float(), 128)
    for name, g, r, t in zip(NAMES, got, ref, ins):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _card_close(g, r, CARD_TOL, scaled=True)
    # Pb and S' o E dt_u are rounded: dx and dB are not the plain version
    # rounded once to bf16
    assert not torch.equal(got[0], ref[0].to(torch.bfloat16))
    assert not torch.equal(got[3], ref[3].to(torch.bfloat16))


def test_cpu_bf16_wgmma_shape_runs_plain_and_counts_no_launch():
    """The wgmma variant's shapes on CPU tensors go to the plain version:
    no launch of either variant is counted."""
    ins, dy = _bf16_case(1, 64, 2, 1, 3)
    counters = (tss.ssd_scan, tss.ssd_scan_bwd)
    n0 = [(f.launches, f.wgmma_launches) for f in counters]
    y, st = tss.ssd_scan_fwd(*ins)
    tss.ssd_scan_bwd(*ins, st, dy)
    assert [(f.launches, f.wgmma_launches) for f in counters] == n0
    assert y.dtype == torch.bfloat16


if __name__ == "__main__":
    # the largest errors of the rounded model, as the docstring quotes them
    for case, args in ROUNDED_CASES.items():
        ins, dy = _bf16_case(*args)
        f32 = [t.float() for t in ins]
        y, st = tss._fwd_rounded(*ins, 128)
        ref_y, ref_st, _ = tss.ssd_chunked_states(*f32, 128)
        print(case, "y", float((y.float() - ref_y).abs().max()),
              float(ref_y.abs().max()), "states (relative)",
              float((st - ref_st).abs().max() / ref_st.abs().max()))
        got = tss._bwd_rounded(*ins, st, dy, 128)
        ref = tss._bwd_plain(*f32, ref_st, dy.float(), 128)
        for name, g, r in zip(NAMES, got, ref):
            print("   ", name, float((g.float() - r).abs().max()),
                  float(r.abs().max()))
