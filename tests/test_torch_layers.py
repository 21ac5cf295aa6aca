"""The port's layers, partial-attention algebra and layout helpers
against the JAX reference, on inputs from a seeded numpy generator.
Tolerance 1e-5 (fp32; different summation orders), exact for integer
and boolean results."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import importance as jimp  # noqa: E402
from repro.core import online_softmax as josm  # noqa: E402
from repro.core import pam_interface as jpif  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.kernels import flash_decode as jfd  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.serving import paged_kv as jpkv  # noqa: E402
from repro_torch.core import importance as timp  # noqa: E402
from repro_torch.core import online_softmax as tosm  # noqa: E402
from repro_torch.core import pam_interface as tpif  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.serving import paged_kv as tpkv  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 4, 16)])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rms_norm(shape, eps):
    r = _rng(0)
    x = r.standard_normal(shape).astype(np.float32) * 3
    w = r.standard_normal(shape[-1]).astype(np.float32)
    _close(tl.rms_norm(_t(x), _t(w), eps), jl.rms_norm(x, w, eps))


def test_rms_norm_casts_back_from_fp32_math():
    r = _rng(1)
    x = r.standard_normal((4, 64)).astype(np.float32)
    w = r.standard_normal(64).astype(np.float32)
    out = tl.rms_norm(_t(x).bfloat16(), _t(w).bfloat16())
    ref = jl.rms_norm(jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(w, jnp.bfloat16))
    assert out.dtype == torch.bfloat16
    _close(out.float(), np.asarray(ref, np.float32), rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("heads", [False, True])
def test_apply_rope(theta, heads):
    r = _rng(2)
    shape = (2, 7, 3, 16) if heads else (2, 7, 16)
    x = r.standard_normal(shape).astype(np.float32)
    pos = r.integers(0, 5000, (2, 7)).astype(np.int32)
    _close(tl.apply_rope(_t(x), _t(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           rtol=1e-4, atol=1e-4)   # cos/sin of angles up to 5e3 rad


def test_rope_freqs():
    _close(tl.rope_freqs(128, 1e6), jl.rope_freqs(128, 1e6), rtol=1e-6)


def test_swiglu():
    r = _rng(3)
    x = r.standard_normal((3, 16)).astype(np.float32)
    g, u = (r.standard_normal((16, 40)).astype(np.float32) for _ in "gu")
    dn = r.standard_normal((40, 16)).astype(np.float32)
    _close(tl.swiglu(*map(_t, (x, g, u, dn))), jl.swiglu(x, g, u, dn),
           rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fn,std", [("linear", 1 / 8.0), ("embed", 0.02)])
def test_init_scales(fn, std):
    gen = torch.Generator().manual_seed(0)
    if fn == "linear":
        w = tl.init_linear(gen, 64, 512, torch.float32, torch.device("cpu"))
        assert w.shape == (64, 512)
    else:
        w = tl.init_embedding(gen, 512, 64, torch.float32,
                              torch.device("cpu"))
        assert w.shape == (512, 64)
    assert abs(float(w.std()) / std - 1) < 0.05


def _partials(seed, T=4, dead="inf"):
    r = _rng(seed)
    o = r.standard_normal((T, 3, 2, 8)).astype(np.float32)
    m = r.standard_normal((T, 3, 2)).astype(np.float32) * 4
    l = r.random((T, 3, 2)).astype(np.float32) + 0.5
    sentinel = -np.inf if dead == "inf" else -1e30
    m[1] = sentinel                        # a dead partition everywhere
    m[:, 0, 0] = sentinel                  # an all-dead position
    o[1], l[1] = 0, 0
    o[:, 0, 0], l[:, 0, 0] = 0, 0
    return o, m, l


@pytest.mark.parametrize("dead", ["inf", "1e30"])
def test_merge_many_and_finalize(dead):
    o, m, l = _partials(4, dead=dead)
    tp = tosm.merge_many(tosm.AttnPartial(_t(o), _t(m), _t(l)))
    jp = josm.merge_many(josm.AttnPartial(o, m, l))
    for a, b in zip(tp, jp):
        _close(a, b)
    _close(tosm.finalize(tp), josm.finalize(jp))


@pytest.mark.parametrize("dead", ["inf", "1e30"])
def test_merge_partials(dead):
    o, m, l = _partials(5, T=2, dead=dead)
    ta = [tosm.AttnPartial(_t(o[i]), _t(m[i]), _t(l[i])) for i in (0, 1)]
    ja = [josm.AttnPartial(o[i], m[i], l[i]) for i in (0, 1)]
    for a, b in zip(tosm.merge_partials(*ta), josm.merge_partials(*ja)):
        _close(a, b)


def test_sentinel_and_inf_dead_partitions_merge_alike():
    o, m, l = _partials(6, dead="inf")
    m2 = np.where(np.isinf(m), -1e30, m).astype(np.float32)
    a = tosm.finalize(tosm.merge_many(tosm.AttnPartial(_t(o), _t(m), _t(l))))
    b = tosm.finalize(tosm.merge_many(tosm.AttnPartial(_t(o), _t(m2),
                                                       _t(l))))
    _close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("window,start,size", [(8, 0, None), (5, 0, None),
                                               (8, 4, 4)])
def test_ring_position_map_and_mask(window, start, size):
    lens = np.array([0, 3, 8, 13, 21], np.int32)
    tp, tv = tfd.ring_position_map(_t(lens), window, start=start, size=size)
    jp, jv = jfd.ring_position_map(jnp.asarray(lens), window, start=start,
                                   size=size)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    mask = _rng(7).random((5, 24)) < 0.5
    np.testing.assert_array_equal(
        tfd.ring_gather_mask(_t(mask), tp, tv).numpy(),
        np.asarray(jfd.ring_gather_mask(jnp.asarray(mask), jp, jv)))


def test_clamp_hot_to_window():
    tier = _rng(8).integers(0, 3, (3, 20)).astype(np.int32)
    lens = np.array([20, 9, 3], np.int32)
    np.testing.assert_array_equal(
        ttiers.clamp_hot_to_window(_t(tier), _t(lens), 6).numpy(),
        np.asarray(jtiers.clamp_hot_to_window(jnp.asarray(tier),
                                              jnp.asarray(lens), 6)))


def test_update_importance():
    r = _rng(9)
    imp = r.random((2, 10)).astype(np.float32)
    sc = r.random((2, 10)).astype(np.float32) * 3
    _close(timp.update_importance(_t(imp), _t(sc), 0.6),
           jimp.update_importance(imp, sc, lam=0.6))


def test_logical_to_ring():
    r = _rng(10)
    kv = r.standard_normal((2, 3, 20, 4)).astype(np.float32)
    rp, va = jfd.ring_position_map(jnp.array([13]), 8)
    got = tpif.logical_to_ring(_t(kv), _t(rp[0]), _t(va[0]))
    _close(got, jpif.logical_to_ring(kv, rp[0], va[0]), rtol=0, atol=0)


def test_paged_gather_logical():
    r = _rng(11)
    pool = r.standard_normal((9, 4, 2, 8)).astype(np.float32)
    table = r.integers(0, 9, (3, 5)).astype(np.int32)
    _close(tpif.paged_gather_logical(_t(pool), _t(table)),
           jpif.paged_gather_logical(pool, table), rtol=0, atol=0)


def test_token_block_mask_and_write_prefill():
    r = _rng(12)
    mask = r.random((3, 16)) < 0.2
    np.testing.assert_array_equal(
        tpkv.token_block_mask(_t(mask), 4).numpy(),
        np.asarray(jpkv.token_block_mask(jnp.asarray(mask), 4)))
    pool = np.zeros((2, 7, 4, 2, 3), np.float32)
    kv = r.standard_normal((2, 2, 16, 3)).astype(np.float32)
    row = np.array([4, 1, 6, 6], np.int32)          # 6 = sentinel
    tpool = _t(pool)
    tpkv.write_prefill(tpool, _t(kv), _t(row), 4)
    ref = np.asarray(jpkv.write_prefill(jnp.asarray(pool), kv, row, 4))
    _close(tpool[:, :6], ref[:, :6], rtol=0, atol=0)   # sentinel is trash
