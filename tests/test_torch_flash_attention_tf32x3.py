"""The fp32 ``tf32x3`` variant of the port's ``flash_attention`` on the
CPU: the plain model of its 3xTF32 split, held to the plain versions and
to the JAX reference.

The fp32 kernels (``csrc/flash_attention_tf32x3.cu``,
``csrc/flash_attention_bwd_tf32x3.cu``) run every product on the tensor
cores from operands split as x = hi + lo, each half a TF32 value
(``cvt.rna.tf32.f32``: the low 13 mantissa bits rounded to nearest, ties
away from zero, and zeroed), summing lo_a hi_b + hi_a lo_b + hi_a hi_b in
fp32. ``_split_tf32`` emulates the split on the int32 view and
``_fwd_tf32x3`` / ``_bwd_tf32x3`` the products. Checked here:

- the split on hand-built bit patterns: hi has 13 zero low bits, hi + lo
  recovers x within 2^-22 relative, ties round away from zero;
- at every built (head dim, group) pair, causal and bidirectional, S 100
  (a ragged last tile of every kernel tile size), the model's O and LSE
  within ``FP32_TOL`` (rtol 1e-4, atol 1e-3) and its (dQ, dK, dV) within
  ``FP32_BWD_TOL`` (rtol / atol 1e-3) of ``_fwd_plain`` / ``_bwd_plain``
  and of the JAX reference as its own tests run it: the Pallas kernel with
  ``interpret=True`` for the forward, ``jax.grad`` of the plain
  (``use_kernel=False``) chunked attention for the backward. These are the
  card's fp32 tolerances, so the split alone keeps the kernels inside
  them.

Inputs come from seeded numpy generators; nothing is built.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jfa  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

FP32_TOL = dict(rtol=1e-4, atol=1e-3)
FP32_BWD_TOL = dict(rtol=1e-3, atol=1e-3)
S = 100


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _f32(bits):
    return np.asarray(bits, np.int32).view(np.float32)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-20), (2, 3e25)])
def test_split_zeroes_13_bits_and_recovers_x(seed, scale):
    x = (np.random.default_rng(seed).standard_normal(4096) * scale
         ).astype(np.float32)
    hi, lo = tfa._split_tf32(torch.from_numpy(x))
    hi, lo = hi.numpy(), lo.numpy()
    assert not (_bits(hi) & 0x1FFF).any()
    assert not (_bits(lo) & 0x1FFF).any()
    # hi + lo, summed exactly in float64, holds x to 2^-22 relative
    err = np.abs(hi.astype(np.float64) + lo - x.astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(x.astype(np.float64))).all()


@pytest.mark.parametrize("low,want_up", [
    (0x1000, True),    # exactly half: away from zero
    (0x0FFF, False),   # below half: toward zero
    (0x1001, True),    # above half
    (0x0000, False),   # already TF32
])
@pytest.mark.parametrize("sign", [1, -1])
def test_split_rounds_ties_away_from_zero(low, want_up, sign):
    """On 1.5 (0x3FC00000) plus the low bits: up means the magnitude
    grows by one TF32 step (2^13 in the bit pattern)."""
    base = 0x3FC00000
    x = _f32([base | low]) * sign
    hi, lo = tfa._split_tf32(torch.from_numpy(x))
    want = _f32([base + (0x2000 if want_up else 0)]) * sign
    assert _bits(hi.numpy())[0] == _bits(want)[0]
    err = abs(float(hi.numpy()[0]) + float(lo.numpy()[0]) - float(x[0]))
    assert err <= 2.0 ** -22 * abs(float(x[0]))


def test_split_carries_into_the_exponent():
    """The largest mantissa below 2.0 with a tie rounds up to 2.0."""
    x = _f32([0x3FFFF000])
    hi, lo = tfa._split_tf32(torch.from_numpy(x))
    assert hi.numpy()[0] == 2.0
    assert float(hi.numpy()[0] + lo.numpy()[0]) == float(x[0])


def _inputs(d, rep, seed):
    """fp32 q, dO (1, H, S, d) and k, v (1, Hkv, S, d): Hkv 2 up to group
    2, else 1 (group 16: 16 query heads)."""
    hkv = 2 if rep <= 2 else 1
    rng = np.random.default_rng(seed)
    shapes = ((1, rep * hkv, S, d), (1, hkv, S, d), (1, hkv, S, d),
              (1, rep * hkv, S, d))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


PAIRS = [pytest.param(d, rep, id=f"{d}-{rep}") for d, rep in tfa.BUILT]


def _close(got, ref, tol):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), **tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,rep", PAIRS)
def test_model_forward_matches_plain_and_pallas(d, rep, causal):
    q, k, v, _ = _inputs(d, rep, seed=d + rep)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    scale = d ** -0.5
    o, lse = tfa._fwd_tf32x3(tq, tk, tv, causal, scale)
    ref_o, ref_lse = tfa._fwd_plain(tq, tk, tv, causal, scale)
    _close([o, lse], [ref_o, ref_lse], FP32_TOL)
    want = jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               causal=causal, block_q=64, block_k=64, interpret=True)
    _close([o], [want], FP32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,rep", PAIRS)
def test_model_backward_matches_plain_and_jax_grad(d, rep, causal):
    q, k, v, g = _inputs(d, rep, seed=d + rep + 1)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    scale = d ** -0.5
    o, lse = tfa._fwd_plain(tq, tk, tv, causal, scale)
    grads = tfa._bwd_tf32x3(tq, tk, tv, o, lse, tg, causal, scale)
    _close(grads, tfa._bwd_plain(tq, tk, tv, o, lse, tg, causal, scale),
           FP32_BWD_TOL)

    def f(q_, k_, v_):
        # the plain attention of the reference's use_kernel=False path,
        # (B, S, H, d) layout
        out = chunked_attention(jnp.moveaxis(q_, 1, 2),
                                jnp.moveaxis(k_, 1, 2),
                                jnp.moveaxis(v_, 1, 2), causal=causal)
        return jnp.sum(jnp.moveaxis(out, 2, 1) * g)
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    _close(grads, want, FP32_BWD_TOL)
