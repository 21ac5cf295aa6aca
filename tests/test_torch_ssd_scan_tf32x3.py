"""The fp32 ``tf32x3`` variant of the port's ``ssd_scan`` on the CPU: its
head block, and the plain model of its 3xTF32 split, held to the plain
versions and to the JAX reference.

The fp32 kernels (``csrc/ssd_scan_tf32x3.cu``,
``csrc/ssd_scan_bwd_tf32x3.cu``) run the chunked SSD decomposition of the
bf16 kernels with every product on the tensor cores from operands split
as x = hi + lo, each half a TF32 value, summing lo_a hi_b + hi_a lo_b +
hi_a hi_b in fp32. ``_fwd_tf32x3`` / ``_bwd_tf32x3`` are ``_fwd_rounded``
/ ``_bwd_rounded`` with every product taken that way (``_einsum``, on
``flash_attention._split_tf32``). Checked here, at mamba2-780m's (d_state,
head dim) = (128, 64) and zamba2-7b's (64, 64), ragged last chunks, two
groups in one short chunk, and strong / slow decay (y a small difference
of large terms):

- the model's y within ``SSD_FP32_TOL`` (rtol 1e-4, atol 1e-3) and its
  chunk-start states within rtol 1e-4, atol 1e-3 x max(1, their largest
  entry) of ``ssd_chunked_states``, and y of the Pallas kernel as the
  reference's own tests run it (``interpret=True``);
- the model's six gradients within rtol 1e-4, atol 1e-3 x max(1, the
  leaf's largest entry) of ``_bwd_plain`` and of ``jax.grad`` of the
  reference's plain chunked scan (``ssd_chunked_jnp``, jitted).

These are the card's fp32 tolerances (``chip_smoke.py``), so the split
alone keeps the kernels inside them. With the atol scaled by a leaf's
largest entry they also pass a model that takes one TF32 product a
product, so the float64 witness (``_f64_witness``: the norm-wise error
against the plain versions in float64, at most ``F64_RATIO`` times the
fp32 plain versions') is checked here to pass the 3xTF32 model and to
fail one TF32 product or a split that drops a cross term. Inputs come from seeded numpy
generators; every case is small and builds nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan as jssd  # noqa: E402
from repro.models.ssm import ssd_chunked_jnp  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ssd_scan as tss  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-3)
NAMES = ("dx", "ddt", "da", "db", "dc", "dd")


def _inputs(B, L, H, G, N, P, seed, strong=False):
    """x, dt, a, b, c, d_skip as fp32 numpy: x / B / C at chip_smoke's
    scale (0.5), dt = softplus(N(0, 1)), a = -linspace(1, 16), D = 1; or
    strong decay (dt 2, a alternating -4 and -0.01, test_kernels.py's
    stability case)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, L, H, P)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((B, L, G, N)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((B, L, G, N)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    a = -np.linspace(1.0, 16.0, H).astype(np.float32)
    if strong:
        dt = np.full((B, L, H), 2.0, np.float32)
        a = np.array([-4.0, -0.01] * (H // 2), np.float32)
    return x, dt, a, b, c, np.ones((H,), np.float32)


CASES = {
    # ragged last chunk, one head at strong decay and one at slow decay
    "mamba2_np_ragged_decay": (_inputs(1, 150, 2, 1, 128, 64, 0, True), 64),
    # two groups, one short chunk (Q = L = 100)
    "mamba2_np_groups": (_inputs(2, 100, 4, 2, 128, 64, 1), 128),
    "zamba2_np_ragged": (_inputs(1, 150, 4, 1, 64, 64, 2), 64),
}


def _t(arrs):
    return [torch.from_numpy(np.array(v)) for v in arrs]


def _close(got, ref, scaled: bool, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    atol = TOL["atol"] * (max(1.0, float(np.abs(ref).max())) if scaled
                          else 1.0)
    np.testing.assert_allclose(got, ref, rtol=TOL["rtol"], atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("rep,ctas,n_sm,hb", [
    (48, 2 * 4, 132, 3),       # mamba2-780m at B 2, L 500: 128 CTAs
    (112, 2 * 4, 132, 7),      # zamba2-7b at B 2, L 500: 128 CTAs
    (48, 4 * 16, 132, 24),     # mamba2-780m at B 4, L 2048
    (6, 2, 132, 1),            # a small grid: one head a CTA
    (1, 5, 132, 1),
])
def test_tf32x3_head_block_fills_the_card(rep, ctas, n_sm, hb):
    got = tss._tf32x3_head_block(rep, ctas, n_sm)
    assert got == hb and rep % got == 0
    assert ctas * rep // got <= max(n_sm, ctas * rep // rep)


def test_one_split_for_both_families():
    """ssd_scan takes the split from flash_attention (one Python
    ``_split_tf32``); its 3xTF32 einsum of a plain product is
    flash_attention's ``_mm_tf32x3``."""
    assert tss._split_tf32 is tfa._split_tf32
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((32, 48), (48, 16)))
    torch.testing.assert_close(tss._einsum("ij,jk->ik", a, b, True),
                               tfa._mm_tf32x3(a, b), rtol=1e-6, atol=1e-6)
    assert not torch.equal(tss._einsum("ij,jk->ik", a, b, True), a @ b)


@pytest.mark.parametrize("case", list(CASES))
def test_model_forward_matches_plain_and_pallas(case):
    ins, chunk = CASES[case]
    y, st = tss._fwd_tf32x3(*_t(ins), chunk)
    ref_y, ref_st, _ = tss.ssd_chunked_states(*_t(ins), chunk)
    _close(y.numpy(), ref_y.numpy(), scaled=False)
    _close(st.numpy(), ref_st.numpy(), scaled=True)
    want = np.asarray(jssd(*[jnp.asarray(v) for v in ins], chunk=chunk,
                           interpret=True))
    _close(y.numpy(), want, scaled=False)
    # the operands really are split: y is not the plain version's
    assert not torch.equal(y, ref_y)


@pytest.mark.parametrize("case", list(CASES))
def test_model_backward_matches_plain_and_jax_grad(case):
    ins, chunk = CASES[case]
    L = ins[0].shape[1]
    dy = np.random.default_rng(9).standard_normal(
        ins[0].shape).astype(np.float32)
    _, st = tss._fwd_tf32x3(*_t(ins), chunk)
    got = tss._bwd_tf32x3(*_t(ins), st, torch.from_numpy(dy), chunk)
    ref = tss._bwd_plain(*_t(ins), st, torch.from_numpy(dy), chunk)

    def f(*args):
        return jnp.sum(ssd_chunked_jnp(*args, min(chunk, max(L, 8))) * dy)
    want = jax.jit(jax.grad(f, argnums=tuple(range(6))))(
        *[jnp.asarray(v) for v in ins])
    for name, g, r, w, t in zip(NAMES, got, ref, want, ins):
        assert g.dtype == torch.float32 and g.shape == t.shape, name
        _close(g.numpy(), r.numpy(), scaled=True, name=name)
        _close(g.numpy(), np.asarray(w), scaled=True, name=name)


def _einsum_1xtf32(eq, a, b, tf32):
    """One TF32 product a product: hi_a hi_b only."""
    assert tf32
    return torch.einsum(eq, tfa._split_tf32(a)[0], tfa._split_tf32(b)[0])


def _einsum_no_lo_a(eq, a, b, tf32):
    """A split that drops lo_a hi_b."""
    assert tf32
    ah, _ = tfa._split_tf32(a)
    bh, bl = tfa._split_tf32(b)
    return torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


@pytest.mark.parametrize("split", ["3xtf32", "1xtf32", "no_lo_a"])
@pytest.mark.parametrize("case", list(CASES))
def test_f64_witness_tells_the_split(case, split, monkeypatch):
    """The 3xTF32 model passes the float64 witness in both directions; one
    TF32 product a product, or a split without lo_a hi_b, fails it in
    both."""
    if split != "3xtf32":
        monkeypatch.setattr(tss, "_einsum", {
            "1xtf32": _einsum_1xtf32, "no_lo_a": _einsum_no_lo_a}[split])
    ins, chunk = CASES[case]
    x = _t(ins)
    dy = torch.from_numpy(np.random.default_rng(9).standard_normal(
        ins[0].shape).astype(np.float32))
    y, st = tss._fwd_tf32x3(*x, chunk)
    grads = tss._bwd_tf32x3(*x, st, dy, chunk)
    witness = tss._f64_witness(x, dy, chunk, y, st, grads)
    want = split == "3xtf32"
    assert tss._f64_within(witness, tss.WITNESS_FWD) == want, witness
    assert tss._f64_within(witness, tss.WITNESS_BWD) == want, witness


def test_cpu_fp32_runs_plain_and_counts_no_launch():
    """The tf32x3 variant's shapes on CPU tensors go to the plain version:
    no launch of any variant is counted."""
    ins, _ = CASES["zamba2_np_ragged"]
    x = _t(ins)
    dy = torch.ones_like(x[0])
    counters = (tss.ssd_scan, tss.ssd_scan_bwd)
    n0 = [(f.launches, f.wgmma_launches, f.tf32x3_launches)
          for f in counters]
    y, st = tss.ssd_scan_fwd(*x)
    tss.ssd_scan_bwd(*x, st, dy)
    assert [(f.launches, f.wgmma_launches, f.tf32x3_launches)
            for f in counters] == n0
    assert tss._variant(torch.float32, 64, 64) == "tf32x3"
    assert y.dtype == torch.float32
