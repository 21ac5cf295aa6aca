"""The port's ``ssd_scan`` (forward and backward) against the JAX
reference on the CPU, where the wrappers run their plain versions.

- forward vs the Pallas kernel ``repro.kernels.ssd_scan`` (``interpret=
  True``) and the sequential oracle ``repro.kernels.ref.ssd_scan_ref`` at
  ``tests/test_kernels.py``'s four shapes (multi-chunk, padding + groups,
  single chunk, strong-decay stability): rtol / atol 2e-4, the
  reference's own tolerance between its kernel and its oracle;
- backward (all six inputs, through ``SSDScanFn``, and the autograd of
  the plain forward) vs ``jax.grad`` of ``repro.models.ssm.
  ssd_chunked_jnp``, with padding and G > 1: within 1e-4 of each leaf's
  largest entry (sums over up to two chunks in another order);
- the chunk-start states and the final state vs the reference's chunked
  form.

Inputs are drawn from seeded numpy generators and handed to both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd  # noqa: E402
from repro.models.ssm import ssd_chunked_jnp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd_scan as tss  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_REL = 1e-4
SHAPES = [(1, 64, 2, 1, 16, 8, 32),     # multi-chunk
          (2, 100, 4, 2, 8, 16, 64),    # padding + groups
          (1, 32, 2, 2, 32, 32, 32)]    # single chunk
NAMES = ("x", "dt", "a", "b", "c", "d_skip")


def _inputs(B, L, H, G, N, P, seed=0):
    """x, dt (post-softplus), a (negative), b, c, d_skip as fp32 numpy."""
    rng = np.random.default_rng(seed + L + N)
    x = rng.standard_normal((B, L, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    b = (rng.standard_normal((B, L, G, N)) / np.sqrt(N)).astype(np.float32)
    c = (rng.standard_normal((B, L, G, N)) / np.sqrt(N)).astype(np.float32)
    d = rng.standard_normal(H).astype(np.float32)
    return x, dt, a, b, c, d


def _decay_inputs():
    """Strong decay over many chunks (test_kernels.py's stability case)."""
    B, L, H, G, N, P = 1, 256, 2, 1, 16, 8
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, L, H, P), np.float32)
    dt = np.full((B, L, H), 2.0, np.float32)
    a = np.array([-4.0, -0.01], np.float32)
    b = (rng.standard_normal((B, L, G, N)) / 4.0).astype(np.float32)
    c = (rng.standard_normal((B, L, G, N)) / 4.0).astype(np.float32)
    return x, dt, a, b, c, np.zeros((H,), np.float32)


def _t(arrs, grad=False):
    return [torch.from_numpy(np.array(v)).requires_grad_(grad) for v in arrs]


def _j(arrs):
    return [jnp.asarray(v) for v in arrs]


CASES = [(_inputs(*s[:6]), s[6]) for s in SHAPES] + [(_decay_inputs(), 64)]
IDS = ["multi_chunk", "padding_groups", "single_chunk", "strong_decay"]


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_forward_matches_pallas_and_oracle(case):
    ins, chunk = CASES[case]
    want = np.asarray(jssd(*_j(ins), chunk=chunk, interpret=True))
    oracle = np.asarray(ref.ssd_scan_ref(*_j(ins)))
    got = tss.ssd_scan(*_t(ins), chunk=chunk)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **FWD_TOL)
    np.testing.assert_allclose(tops.ssd(*_t(ins), chunk=chunk).numpy(),
                               want, **FWD_TOL)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_port_oracle_matches_reference_oracle(case):
    ins, _ = CASES[case]
    np.testing.assert_allclose(tss.ssd_scan_ref(*_t(ins)).numpy(),
                               np.asarray(ref.ssd_scan_ref(*_j(ins))),
                               **FWD_TOL)


def test_forward_bf16_matches_pallas():
    """bf16 x, b, c: both sides compute in fp32 and round y to bf16."""
    ins, chunk = CASES[1]
    bf = [np.asarray(jnp.asarray(v, jnp.bfloat16)) if i in (0, 3, 4) else v
          for i, v in enumerate(ins)]
    want = jssd(*_j(bf), chunk=chunk, interpret=True)
    tins = _t([np.asarray(v, np.float32) for v in bf])
    for i in (0, 3, 4):
        tins[i] = tins[i].bfloat16()
    got = tss.ssd_scan(*tins, chunk=chunk)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def _jax_grads(ins, dy, chunk):
    L = ins[0].shape[1]

    def f(*args):
        return jnp.sum(ssd_chunked_jnp(*args, min(chunk, max(L, 8))) * dy)
    return jax.grad(f, argnums=tuple(range(6)))(*_j(ins))


def _close_rel(got, want, name):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= GRAD_REL * scale, (name, err, scale)


@pytest.mark.parametrize("shape", SHAPES + [(2, 37, 4, 1, 8, 8, 16)],
                         ids=IDS[:3] + ["ragged_three_chunks"])
def test_backward_matches_jax_grad(shape):
    """Gradients of all six inputs through ``SSDScanFn`` (the plain
    version of the backward kernels) and through the autograd of the
    plain forward, vs ``jax.grad`` of the reference's chunked form."""
    ins = _inputs(*shape[:6], seed=3)
    chunk = shape[6]
    dy = np.random.default_rng(9).standard_normal(ins[0].shape,
                                                  np.float32)
    want = _jax_grads(ins, dy, chunk)
    tins = _t(ins, grad=True)
    tss.ssd_scan(*tins, chunk=chunk).backward(torch.from_numpy(dy))
    auto = tss.ssd_scan_plain_grads(*_t(ins), torch.from_numpy(dy),
                                    chunk=chunk)
    for name, t, g, w in zip(NAMES, tins, auto, want):
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype
        _close_rel(t.grad.numpy(), w, name)
        _close_rel(g.numpy(), w, name)


def test_backward_strong_decay_is_finite_and_matches():
    ins, chunk = CASES[3]
    dy = np.random.default_rng(2).standard_normal(ins[0].shape, np.float32)
    want = _jax_grads(ins, dy, chunk)
    tins = _t(ins, grad=True)
    tss.ssd_scan(*tins, chunk=chunk).backward(torch.from_numpy(dy))
    for name, t, w in zip(NAMES, tins, want):
        assert bool(torch.isfinite(t.grad).all()), name
        _close_rel(t.grad.numpy(), w, name)


def test_later_tokens_leave_earlier_outputs_states_and_grads():
    """Cutting a sequence after 30 tokens changes neither the first 30
    outputs nor the chunk-start states before the cut (the short run's
    padded tokens act as dt = 0), and the first 30 outputs pass no
    gradient to later tokens."""
    ins = _inputs(1, 40, 2, 1, 8, 8, seed=4)
    short = [v[:, :30] if v.ndim > 1 else v for v in ins]
    y_long, st_long = tss.ssd_scan_fwd(*_t(ins), chunk=16)
    y_short, st_short = tss.ssd_scan_fwd(*_t(short), chunk=16)
    np.testing.assert_allclose(y_long[:, :30].numpy(), y_short.numpy(),
                               **FWD_TOL)
    np.testing.assert_allclose(st_long[:, :, :2].numpy(),
                               st_short[:, :, :2].numpy(), **FWD_TOL)
    dy = np.zeros(ins[0].shape, np.float32)
    dy[:, :30] = 1.0
    tins = _t(ins, grad=True)
    tss.ssd_scan(*tins, chunk=16).backward(torch.from_numpy(dy))
    assert float(tins[0].grad[:, 30:].abs().max()) == 0.0
    assert float(tins[1].grad[:, 30:].abs().max()) == 0.0


def test_states_and_final_state_match_reference_chunked():
    """The forward's chunk-start states continue into the final state of
    ``ssd_chunked_jnp(return_final_state=True)``, and the port's
    ``ssd_chunked`` returns the same final state."""
    ins = _inputs(2, 100, 4, 2, 8, 16)
    jy, jh = ssd_chunked_jnp(*_j(ins), 32, return_final_state=True)
    ty, th = tssm.ssd_chunked(*_t(ins), 32, return_final_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FWD_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **FWD_TOL)
    _, st = tss.ssd_scan_fwd(*_t(ins), chunk=32)
    assert st.shape == (2, 4, 4, 8, 16)
    # the last chunk's start state, advanced over its 4 live tokens by
    # the sequential recurrence, is the final state
    x, dt, a, b, c, _ = ins
    h = st[:, :, -1].double().numpy()
    for t in range(96, 100):
        dec = np.exp(dt[:, t] * a)[..., None, None]
        bh = np.repeat(b[:, t], 2, axis=1)
        h = dec * h + dt[:, t, :, None, None] * bh[..., None] \
            * x[:, t, :, None, :]
    np.testing.assert_allclose(h, np.asarray(jh), **FWD_TOL)


def test_chunk_contract():
    """``chunk = min(chunk, max(L, 8))``; H % G must be 0."""
    assert tss.chunk_len(5, 128) == (8, 8)
    assert tss.chunk_len(100, 128) == (100, 100)
    assert tss.chunk_len(2047, 128) == (128, 2048)
    ins = _inputs(1, 5, 2, 1, 8, 8)
    want = np.asarray(jssd(*_j(ins), interpret=True))
    np.testing.assert_allclose(tss.ssd_scan(*_t(ins)).numpy(), want,
                               **FWD_TOL)
    bad = _inputs(1, 16, 3, 2, 8, 8)
    with pytest.raises(ValueError, match="multiple of groups"):
        tss.ssd_scan(*_t(bad))


def test_non_cpu_tensors_take_the_kernel_path_or_raise():
    """The plain version serves CPU tensors only: any other device goes
    to the kernel wrapper, which raises for what it cannot launch."""
    ins = [torch.empty(v.shape, device="meta") for v in _inputs(1, 16, 2, 1,
                                                               128, 64)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tss.ssd_scan(*ins)
    n0 = tss.ssd_scan.launches
    tss.ssd_scan(*_t(_inputs(1, 16, 2, 1, 8, 8)))
    assert tss.ssd_scan.launches == n0     # the plain version launches none
