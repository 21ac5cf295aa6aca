"""The port's tier-list decode attention against the JAX package's
Pallas path, on the CPU.

``kernels.ops.pam_decode_attention`` (Alg. 1 over a list of tier pools:
one merged kernel partial a tier, the exact merge across tiers) and
``ops.decode_attention`` (one pool) run their kernels' plain versions on
CPU tensors; the reference's ``ops.pam_decode_attention`` /
``decode_attention`` run the Pallas decode kernel with
``interpret=True`` (as ``tests/test_kernels.py`` does), on the same
numpy inputs from fixed seeds. Tolerance rtol / atol 1e-4 against the
interpret path (fp32; the kernels' split and merge orders differ), 2e-2
for bf16 storage. A paged tier (``ops.PagedTier``) is held to the
reference over its block-table gather, and every tier list to one
dense attention over the concatenated tiers (the paper's exactness
claim, ``test_kernels.py::test_pam_decode_attention_tiers_equals_dense``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pam_interface as jpif  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module, restored afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _tiers(seed, B, H, Hkv, d, sizes, p_live=0.8, dead=None):
    """q and per-tier (k, v, mask) numpy arrays; ``dead`` = (tier, row)
    whose mask is all False, or (tier, None) for the whole tier."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    ks, vs, masks = [], [], []
    for i, s_t in enumerate(sizes):
        ks.append(rng.standard_normal((B, Hkv, s_t, d)).astype(np.float32))
        vs.append(rng.standard_normal((B, Hkv, s_t, d)).astype(np.float32))
        m = rng.random((B, s_t)) < p_live
        m[:, 0] = True
        if dead is not None and dead[0] == i:
            m[slice(None) if dead[1] is None else dead[1]] = False
        masks.append(m)
    return q, ks, vs, masks


@pytest.mark.parametrize("B,H,Hkv,d,sizes,dead", [
    (2, 4, 2, 32, (32, 96, 160), None),       # the reference's case
    (3, 8, 8, 16, (8, 40, 200), (1, None)),   # a fully dead tier
    (2, 16, 8, 128, (16, 64, 96), (2, 1)),    # qwen3-0.6b heads, dead row
    (1, 4, 4, 8, (5, 7), None),               # two tiers, ragged sizes
])
def test_pam_decode_attention_equals_jax_and_dense(B, H, Hkv, d, sizes, dead):
    q, ks, vs, masks = _tiers(sum(sizes), B, H, Hkv, d, sizes, dead=dead)
    got = tops.pam_decode_attention(
        _t(q), [(_t(k), _t(v)) for k, v in zip(ks, vs)],
        [_t(m) for m in masks])
    want = jops.pam_decode_attention(
        jnp.asarray(q), [(jnp.asarray(k), jnp.asarray(v))
                         for k, v in zip(ks, vs)],
        [jnp.asarray(m) for m in masks], interpret=True)
    assert got.shape == (B, H, d) and got.dtype == torch.float32
    _close(got, want)
    dense = jref.flash_decode_ref(jnp.asarray(q),
                                  jnp.asarray(np.concatenate(ks, axis=2)),
                                  jnp.asarray(np.concatenate(vs, axis=2)),
                                  jnp.asarray(np.concatenate(masks, axis=1)))
    _close(got, dense)


def test_pam_decode_attention_without_masks_equals_jax():
    q, ks, vs, _ = _tiers(3, 2, 4, 2, 16, (24, 48))
    got = tops.pam_decode_attention(
        _t(q), [(_t(k), _t(v)) for k, v in zip(ks, vs)], [None, None])
    want = jops.pam_decode_attention(
        jnp.asarray(q), [(jnp.asarray(k), jnp.asarray(v))
                         for k, v in zip(ks, vs)], [None, None],
        interpret=True)
    _close(got, want)


@pytest.mark.parametrize("block_live", [False, True])
def test_pam_decode_attention_paged_tier_equals_jax(block_live):
    """Hot and warm dense, cold paged (block 16, a shuffled table with
    sentinel entries): equal to the reference's tier list over the
    cold pool's block-table gather, and to one dense attention."""
    B, H, Hkv, d, bs, nb, NB = 2, 16, 8, 128, 16, 6, 20
    q, ks, vs, masks = _tiers(11, B, H, Hkv, d, (16, 48))
    rng = np.random.default_rng(12)
    kp = rng.standard_normal((NB + 1, bs, Hkv, d)).astype(np.float32)
    vp = rng.standard_normal((NB + 1, bs, Hkv, d)).astype(np.float32)
    table = rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32)
    table[1, 4:] = NB                                   # unmapped entries
    pmask = rng.random((B, nb * bs)) < 0.7
    pmask[1, 4 * bs:] = False
    live = None
    if block_live:
        live = pmask.reshape(B, nb, bs).any(-1)
        live[0, 2] = False                              # a skipped block
        pmask[0, 2 * bs:3 * bs] = False
    got = tops.pam_decode_attention(
        _t(q), [(_t(ks[0]), _t(vs[0])), (_t(ks[1]), _t(vs[1])),
                tops.PagedTier(_t(kp), _t(vp), _t(table),
                               None if live is None else _t(live))],
        [_t(masks[0]), _t(masks[1]), _t(pmask)])
    gk = np.asarray(jpif.paged_gather_logical(jnp.asarray(kp),
                                              jnp.asarray(table)))
    gv = np.asarray(jpif.paged_gather_logical(jnp.asarray(vp),
                                              jnp.asarray(table)))
    tiers = [(ks[0], vs[0]), (ks[1], vs[1]), (gk, gv)]
    want = jops.pam_decode_attention(
        jnp.asarray(q), [(jnp.asarray(k), jnp.asarray(v)) for k, v in tiers],
        [jnp.asarray(m) for m in (masks[0], masks[1], pmask)],
        interpret=True)
    _close(got, want)
    dense = jref.flash_decode_ref(
        jnp.asarray(q), jnp.asarray(np.concatenate([ks[0], ks[1], gk], 2)),
        jnp.asarray(np.concatenate([vs[0], vs[1], gv], 2)),
        jnp.asarray(np.concatenate([masks[0], masks[1], pmask], 1)))
    _close(got, dense)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens", [None, (200, 37)])
def test_decode_attention_equals_jax(dtype, lens):
    rng = np.random.default_rng(17)
    B, H, Hkv, S, d = 2, 4, 2, 256, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, d), (B, Hkv, S, d), (B, Hkv, S, d)))
    mask = rng.random((B, S)) < 0.6
    kv_lens = None if lens is None else np.array(lens, np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = tops.decode_attention(
        _t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt), _t(mask),
        kv_lens=None if kv_lens is None else _t(kv_lens))
    want = jops.decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(mask), kv_lens=None if kv_lens is None
        else jnp.asarray(kv_lens), block_s=128, interpret=True)
    assert got.dtype == tdt
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    _close(got.float(), np.asarray(want, np.float32), tol)


def test_pam_decode_attention_needs_a_tier():
    with pytest.raises(ValueError, match="at least one tier"):
        tops.pam_decode_attention(torch.zeros(1, 2, 8), [], [])
