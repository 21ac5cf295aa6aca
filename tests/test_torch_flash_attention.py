"""The port's ``flash_attention`` (forward and backward) against the JAX
reference on the CPU, where the wrappers run their plain versions.

- forward vs the Pallas kernel ``repro.kernels.flash_attention``
  (``interpret=True``) over ``tests/test_kernels.py``'s shape grid, causal
  and not: fp32 at 2e-5 (one masked softmax against the tiled online
  softmax), bf16 at 2e-2 (one bf16 rounding of the output);
- backward (dq, dk, dv through ``FlashAttentionFn``) vs ``jax.grad`` of
  ``repro.kernels.ref.flash_attention_ref`` at 1e-4 (fp32; sums over up
  to 200 keys in another order).

Inputs are drawn from seeded numpy generators and handed to both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jfa  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
GRID = [(1, 2, 2, 64, 32),       # MHA, one block
        (2, 4, 2, 96, 16),       # GQA, ragged seq vs block
        (1, 8, 1, 200, 64),      # MQA, multi-block with padding
        (2, 2, 2, 130, 8)]       # tiny d, cross-block causal boundary


def _inputs(B, H, Hkv, Sq, d, Sk=None, seed=0):
    rng = np.random.default_rng(seed + B * 100 + H + Sq)
    Sk = Sq if Sk is None else Sk
    return (rng.standard_normal((B, H, Sq, d), np.float32),
            rng.standard_normal((B, Hkv, Sk, d), np.float32),
            rng.standard_normal((B, Hkv, Sk, d), np.float32))


def _t(*xs, grad=False):
    return [torch.from_numpy(x).requires_grad_(grad) for x in xs]


@pytest.mark.parametrize("B,H,Hkv,S,d", GRID)
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_pallas(B, H, Hkv, S, d, causal):
    q, k, v = _inputs(B, H, Hkv, S, d)
    want = jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               causal=causal, block_q=64, block_k=64, interpret=True)
    got = tfa.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_forward_bf16_matches_pallas():
    q, k, v = _inputs(1, 4, 2, 128, 32, seed=7)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jfa(jq, jk, jv, causal=True, block_q=64, block_k=64,
               interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (jq, jk, jv))
    got = tfa.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_sq_differs_from_sk(causal):
    """Sq != Sk: the causal mask runs from position 0 for both."""
    q, k, v = _inputs(2, 4, 2, 70, 16, Sk=150)
    want = jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               causal=causal, block_q=64, block_k=64, interpret=True)
    got = tfa.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("B,H,Hkv,S,d", GRID)
@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_jax_grad(B, H, Hkv, S, d, causal):
    q, k, v = _inputs(B, H, Hkv, S, d, seed=1)
    g = np.random.default_rng(S).standard_normal((B, H, S, d)).astype(
        np.float32)
    tq, tk, tv = _t(q, k, v, grad=True)
    tfa.flash_attention(tq, tk, tv, causal=causal).backward(
        torch.from_numpy(g))

    def f(q_, k_, v_):
        return jnp.sum(ref.flash_attention_ref(q_, k_, v_, causal=causal) * g)
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL)


def test_lse_is_the_rows_logsumexp():
    q, k, v = _inputs(2, 4, 2, 96, 16)
    tq, tk, tv = _t(q, k, v)
    _, lse = tfa.flash_attention_fwd(tq, tk, tv, causal=True)
    kr = torch.repeat_interleave(tk, 2, dim=1)
    s = tq @ kr.transpose(-1, -2) / 4.0
    s = s.masked_fill(torch.ones(96, 96).triu(1).bool(), float("-inf"))
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(s, dim=-1).numpy(), **FWD_TOL)


def test_block_sizes_and_layout_do_not_change_the_result():
    """``block_q``/``block_k`` are API parity only; a non-contiguous
    (B, S, H, d) view moved to (B, H, S, d) gives the same output and
    gradients as a contiguous copy."""
    q, k, v = _inputs(1, 4, 2, 100, 16)
    tq, tk, tv = _t(q, k, v, grad=True)
    a = tfa.flash_attention(tq, tk, tv, block_q=32, block_k=16)
    b = tfa.flash_attention(tq, tk, tv)
    assert torch.equal(a, b)
    qs = torch.from_numpy(np.ascontiguousarray(q.transpose(0, 2, 1, 3)))
    qs.requires_grad_(True)
    c = tfa.flash_attention(torch.movedim(qs, 2, 1), tk, tv)
    assert not torch.movedim(qs, 2, 1).is_contiguous()
    torch.testing.assert_close(c, b, rtol=0, atol=0)
    c.sum().backward()
    b.sum().backward()
    torch.testing.assert_close(torch.movedim(qs.grad, 2, 1), tq.grad,
                               rtol=0, atol=0)


def test_cpu_runs_plain_and_counts_no_launch():
    q, k, v = _inputs(1, 2, 2, 64, 16)
    n0 = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    tq, tk, tv = _t(q, k, v, grad=True)
    tops.fused_attention(tq, tk, tv, causal=True).sum().backward()
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_bwd.launches) == n0
    assert tq.grad is not None and tk.grad.shape == tk.shape


def test_gradcheck_plain_backward_in_float64():
    """The plain backward's formulas against finite differences (float64
    operands through the same Function)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s))
               .requires_grad_(True)
               for s in ((1, 2, 9, 4), (1, 1, 9, 4), (1, 1, 9, 4)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfa.FlashAttentionFn.apply(a, b, c, True, 0.5),
        (q, k, v))


def test_rejects_heads_not_a_multiple_of_kv_heads():
    q, k, v = _inputs(1, 3, 2, 16, 8)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(*_t(q, k, v))
