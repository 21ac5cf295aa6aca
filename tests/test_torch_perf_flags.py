"""The perf flags (``repro_torch.models.perf_flags``) against the JAX
package on the CPU: the cases of ``tests/test_perf_variants.py``, each
holding the port to the JAX function on the same inputs (numpy draws
from fixed seeds), at that file's bounds.

* ``sp_attention`` against JAX ``chunked_attention`` within 2e-5, causal
  and not, on one site and under a (1, 4) grid (each model site its
  query slice);
* ``bf16_probs``: the port's chunked attention against JAX's with the
  flag on, within 2e-2;
* ``remat_dots``: the loss to 1e-6 and the grads to rtol 1e-5 / atol
  1e-6 of ``remat`` without the flag (the reference's check, in the
  port), and both within 1e-4 of JAX's loss and grads with the flag;
* ``moe_pin``: the MoE output equal with and without the flag, and
  within 1e-5 of JAX's with it;
* ``sp_attn`` and ``sp_pin`` in a train step on a (1, 4) grid: the loss
  and grads within 1e-4 of the JAX unsharded loss and grads;
* ``pam_shard_decode``: a decode step under a (1, 4) grid equals the
  dense decode (cache written in place) and refuses paged pools;
* the flag state: ``from_env`` reads ``REPRO_PERF``, import leaves it
  empty, ``use_grid`` nests.
fp32 throughout; every test resets the flags of both packages.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import perf_flags as jflags  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import get_config as jget  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_grid  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import perf_flags as tflags  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    tflags.set_flags()
    jflags.set_flags()


def _both(*names):
    tflags.set_flags(*names)
    jflags.set_flags(*names)


def _qkv(seed, B=2, S=64, H=8, Hkv=4, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, d), (B, S, Hkv, d), (B, S, Hkv, d))]


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("grid", [None, (1, 4)], ids=["one_site", "1x4"])
@pytest.mark.parametrize("causal", [True, False])
def test_sp_attention_matches_chunked(causal, grid):
    q, k, v = _qkv(0)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, chunk=16)
    tflags.set_flags("sp_attn")
    with tflags.use_grid(None if grid is None
                         else make_grid(grid, device="cpu")):
        got = tattn.sp_attention(*_t((q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_bf16_probs_matches_the_reference():
    q, k, v = _qkv(1)
    _both("bf16_probs")
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=True, chunk=16)
    got = tattn.chunked_attention(*_t((q, k, v)), causal=True, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)
    tflags.set_flags()
    plain = tattn.chunked_attention(*_t((q, k, v)), causal=True, chunk=16)
    assert not torch.equal(got, plain)        # the flag changed the path
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.fixture(scope="module")
def dense():
    """Reduced qwen3-0.6b in both packages (the same weights) and a
    SyntheticLM batch."""
    jcfg = jreduced(jget("qwen3-0.6b"))
    params = jtf.init_params(jcfg, jax.random.PRNGKey(2))
    cfg = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    tparams = bridge.params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                     device="cpu")
    b = SyntheticLM(vocab=cfg.vocab, seq_len=16, batch=2,
                    seed=3).batch_at(0)
    return jcfg, params, cfg, tparams, b


def _jax_grads(jcfg, params, b, remat=False):
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    return jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, batch, remat=remat))(params)


def _port_grads(cfg, tparams, b, grid=None, **kw):
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    return tts.build_grad_fn(cfg, tts.TrainConfig(**kw), grid=grid)(
        tparams, batch)


def _close_to_jax(loss, grads, jl, jg):
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    for (path, a), c in zip(leaves_with_paths(grads),
                            jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), err_msg=path,
                                   **TOL)


def test_remat_dots_same_loss_and_grads(dense):
    jcfg, params, cfg, tparams, b = dense
    l0, g0 = _port_grads(cfg, tparams, b, remat=True)
    _both("remat_dots")
    l1, g1 = _port_grads(cfg, tparams, b, remat=True)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for a, c in zip(leaves(g0), leaves(g1)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-6)
    _close_to_jax(l1, g1, *_jax_grads(jcfg, params, b, remat=True))


def test_remat_dots_saves_the_weight_products():
    """The policy keeps ``mm`` / ``addmm`` and recomputes the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    assert (ttf._save_dots(None, torch.ops.aten.mm.default)
            == CheckpointPolicy.MUST_SAVE)
    assert (ttf._save_dots(None, torch.ops.aten.bmm.default)
            == CheckpointPolicy.PREFER_RECOMPUTE)


def test_moe_pin_is_noop_numerically():
    jcfg = jreduced(jget("qwen3-moe-235b-a22b"))
    jm = dataclasses.replace(jcfg.moe, capacity_factor=2.0)
    p = jmoe.init_moe(jax.random.PRNGKey(4), jcfg.d_model, jm, jnp.float32)
    x = np.random.default_rng(5).standard_normal(
        (2, 8, jcfg.d_model)).astype(np.float32)
    cfg = tcfg.reduced(tcfg.get_config("qwen3-moe-235b-a22b"))
    tm = dataclasses.replace(cfg.moe, capacity_factor=2.0)
    tp_ = tmoe.MoEParams(*[None if a is None else torch.from_numpy(
        np.array(a)) for a in p])
    y0, _ = tmoe.moe_forward(tp_, torch.from_numpy(x), tm)
    _both("moe_pin")
    y1, _ = tmoe.moe_forward(tp_, torch.from_numpy(x), tm)
    assert torch.equal(y0, y1)
    want, _ = jmoe.moe_forward(p, jnp.asarray(x), jm)
    np.testing.assert_allclose(y1.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("flags", [("sp_attn",), ("sp_pin",),
                                   ("sp_attn", "sp_pin")])
def test_sequence_flags_on_a_grid_match_the_unsharded_reference(dense,
                                                                flags):
    jcfg, params, cfg, tparams, b = dense
    want = _jax_grads(jcfg, params, b)
    tflags.set_flags(*flags)
    got = _port_grads(cfg, tparams, b, grid=make_grid((1, 4), device="cpu"))
    _close_to_jax(*got, *want)


def _decode_case():
    cfg = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    params = ttf.init_params(cfg, 0, device="cpu")
    ap = ttf._attn_params(ttf._layers(params)[0])
    rng = np.random.default_rng(6)
    B, Hkv, Smax = 3, cfg.n_kv_heads, 32
    x = torch.from_numpy(rng.standard_normal((B, cfg.d_model))
                         .astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal(
        (B, Hkv, Smax, cfg.head_dim)).astype(np.float32)) for _ in range(2))
    lens = torch.tensor([5, 20, 31], dtype=torch.int32)
    kw = dict(n_heads=cfg.n_heads, n_kv=Hkv, d_head=cfg.head_dim,
              rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps)
    return ap, x, kc, vc, lens, kw


def test_pam_shard_decode_equals_the_dense_decode():
    ap, x, kc, vc, lens, kw = _decode_case()
    want = tattn.attention_decode(ap, x, kc.clone(), vc.clone(), lens, **kw)
    tflags.set_flags("pam_shard_decode")
    for grid in ((1, 4), (1, 1)):
        k2, v2 = kc.clone(), vc.clone()
        with tflags.use_grid(make_grid(grid, device="cpu")):
            got = tattn.attention_decode(ap, x, k2, v2, lens, **kw)
        for a, c in zip(got, want):
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-5,
                                       atol=2e-5)
        assert got[2] is k2 and got[3] is v2     # written in place
    with pytest.raises(ValueError, match="mutually exclusive"):
        tattn.attention_decode(ap, x, kc, vc, lens, paged=(None,) * 4, **kw)


def test_flag_state(monkeypatch):
    assert tflags.active() == ()
    monkeypatch.setenv("REPRO_PERF", "sp_pin,bf16_probs")
    tflags.from_env()
    assert tflags.active() == ("bf16_probs", "sp_pin")
    assert tflags.enabled("sp_pin") and not tflags.enabled("sp_attn")
    assert tflags.abstract_mesh().axis_names == ()
    outer, inner = (make_grid(s, device="cpu") for s in ((2, 2), (1, 4)))
    with tflags.use_grid(outer):
        with tflags.use_grid(inner):
            assert tflags.abstract_mesh() is inner
        assert tflags.abstract_mesh().shape == {"data": 2, "model": 2}
    assert tflags.abstract_mesh().shape == {}
