"""The port's vision-language family (``internvl2-1b``: a dense GQA decoder
whose linear front end projects image patch embeddings into a prefix
before the token embeddings) against the JAX reference, on the CPU.

- the copied config, full and reduced, field for field, with its
  parameter count and ``has_decode`` / ``sub_quadratic``;
- ``init_params``' layout (``frontend`` beside the dense layers, tied
  embeddings);
- ``forward`` with patches: logits against the reference with
  ``use_kernel=False``, and through the port's plain ``flash_attention``
  against the Pallas kernel in ``interpret=True``; ``loss_fn`` and its
  gradients against ``jax.grad`` of the reference loss without the
  kernel (which JAX cannot differentiate);
- ``prefill(patches=)`` with and without ``true_len`` (the cache lengths
  count the prefix): logits and every cache field; then three decode
  steps: logits, cache and scores;
- the decode kernels' plain versions at (head dim 64, group 7), stacked
  and merged, dense and paged, against the Pallas kernels in
  ``interpret=True``;
- the refusals: ``prefill_suffix`` and, in the engine, ``prefix_cache``
  and chunked admission, each raising what the reference raises.

Each model case runs at the reduced config (4 q / 2 kv heads of 16) and
at a reduced variant with internvl2-1b's own heads, 14 q / 2 kv of 64, so
that the built pair (64, 7) is on the tested path. Inputs are fixed-seed
numpy draws, fp32 throughout. Tolerances: logits rtol / atol 1e-4,
everything else 1e-5 (kernel partials rtol 1e-5 / atol 1e-4, as
``tests/test_torch_gqa.py``). The engine's streams are held to the JAX
engine's in ``tests/test_torch_vlm_engine.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import make_engine, make_pam  # noqa: E402

from repro.kernels import flash_decode as jfd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import get_config, reduced  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

ARCH = "internvl2-1b"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)
# the reduced config, and internvl2-1b's heads (group 7 at head dim 64)
VARIANTS = {"reduced": {},
            "g7": dict(n_heads=14, n_kv_heads=2, d_head=64)}

_jprefill = jax.jit(jtf.prefill, static_argnums=(0, 3))
_jdecode = jax.jit(jtf.decode_step, static_argnums=0)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _t(a):
    return torch.from_numpy(np.array(a))


_MODELS: dict = {}


def _models(variant="reduced"):
    """(JAX cfg, JAX params, port cfg, port params) of a reduced
    variant: the same ``dataclasses.replace`` on both sides, the same
    weights (the reference's ``init_params`` at seed 0)."""
    if variant not in _MODELS:
        cfg = dataclasses.replace(reduced(get_config(ARCH)),
                                  **VARIANTS[variant])
        params = jtf.init_params(cfg, jax.random.PRNGKey(0))
        tcf = dataclasses.replace(tcfg.reduced(tcfg.get_config(ARCH)),
                                  **VARIANTS[variant])
        _MODELS[variant] = (cfg, params, tcf, bridge.params_from_jax(
            tcf, _np_tree(params), device="cpu"))
    return _MODELS[variant]


def _batch(cfg, seed, B=2, S=12):
    """Tokens, labels (some ignored) and patches (B, num_patches,
    frontend_dim) as numpy."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[1, :3] = -1
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": labels,
            "patches": rng.standard_normal(
                (B, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


# ------------------------------------------------------------ the config
def test_config_and_param_count_match_reference():
    """The copied config, full and reduced, field for field, its
    parameter count (0.494 B: 0.99 GB of bf16 at full size) and its
    family properties."""
    for own, ref in ((tcfg.get_config(ARCH), get_config(ARCH)),
                     (tcfg.reduced(tcfg.get_config(ARCH)),
                      reduced(get_config(ARCH)))):
        assert dataclasses.asdict(own) == dataclasses.asdict(ref)
        assert own.param_count() == ref.param_count()
        assert own.active_param_count() == ref.active_param_count()
        assert own.has_decode is ref.has_decode is True
        assert own.sub_quadratic is ref.sub_quadratic is False
    full = tcfg.get_config(ARCH)
    assert (full.n_heads // full.n_kv_heads, full.head_dim) == (7, 64)
    assert (full.head_dim, 7) in tfd.BUILT


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_params_layout_matches_reference(variant):
    """Keys, shapes and dtypes of ``tf.init_params`` against the
    reference's tree, bf16 and fp32: the dense layers, the tied
    embedding (no ``lm_head``) and the (frontend_dim, d_model)
    ``frontend``."""
    cfg, _, tcf, _ = _models(variant)
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        ref = _leaves(jax.tree.map(
            lambda a: np.zeros(a.shape, a.dtype),
            jax.eval_shape(lambda: jtf.init_params(
                c, jax.random.PRNGKey(0)))))
        own = _leaves(ttf.init_params(dataclasses.replace(tcf, dtype=dtype),
                                      0, device="cpu"))
        assert sorted(own) == sorted(ref)
        for name, a in ref.items():
            assert tuple(own[name].shape) == a.shape, name
            got = str(own[name].dtype).split(".")[-1]
            assert got == a.dtype.name, (name, got, a.dtype)
    assert tuple(own["/frontend"].shape) == (cfg.frontend_dim, cfg.d_model)
    assert "/lm_head" not in own


# ------------------------------------------------------------ forward
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["chunked", "flash_attention"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_with_patches_matches_reference(variant, use_kernel):
    """Logits of the text positions (the ``num_patches`` prefix
    stripped): the port's chunked attention against the reference's
    ``use_kernel=False``, and the port's ``flash_attention`` (its plain
    version on the CPU) against the Pallas kernel in ``interpret=True``
    (the reference's ``use_kernel=True`` off the TPU)."""
    cfg, params, tcf, tparams = _models(variant)
    b = _batch(cfg, seed=1)
    jl, _ = jtf.forward(cfg, params, _jb(b), use_kernel=use_kernel)
    tl, aux = ttf.forward(tcf, tparams, _tb(b), use_kernel=use_kernel)
    assert tuple(tl.shape) == (2, 12, cfg.vocab) == jl.shape
    _close(tl, jl, **LOGIT_TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match_jax_grad(variant):
    """``loss_fn`` (ignored labels included) and the gradient of every
    leaf, the front end's among them, with the port's ``flash_attention``
    autograd Function, against ``jax.grad`` of the reference loss with
    ``use_kernel=False``."""
    from repro_torch.training import train_step as tts
    from repro_torch.tree import leaves
    cfg, params, tcf, tparams = _models(variant)
    b = _batch(cfg, seed=2)
    jl, jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(cfg, p, _jb(b), use_kernel=False))(params)
    tl, tg = tts.build_grad_fn(tcf, tts.TrainConfig(use_kernel=True))(
        tparams, _tb(b))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(leaves(tg)) == len(jleaves)
    for g, w in zip(leaves(tg), jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert float(tg["frontend"].abs().max()) > 0


# ------------------------------------------------------------ prefill
def _assert_cache_close(tc, jc):
    for f in ("k", "v"):
        _close(getattr(tc, f), getattr(jc, f))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    for f in ("pk", "pv", "ckv", "krope", "conv", "state"):
        assert getattr(tc, f).numel() == 0, f


@pytest.mark.parametrize("bucketed", [False, True],
                         ids=["exact", "true_len"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_with_patches_and_decode_match_reference(variant, bucketed):
    """``prefill(patches=)`` of 2 prompts of 9 tokens behind 4 patches
    (right-padded to 16 tokens with ``true_len`` 9, or exact): logits,
    every cache field and lengths 13 (the prefix counted); then three
    greedy ``decode_step``s fed the reference's token: logits, cache and
    scores each step."""
    cfg, params, tcf, tparams = _models(variant)
    b = _batch(cfg, seed=3, S=9)
    toks = np.pad(b["tokens"], ((0, 0), (0, 7))) if bucketed else b["tokens"]
    jl, jc = _jprefill(cfg, params, jnp.asarray(toks), 32,
                       patches=jnp.asarray(b["patches"]),
                       true_len=None if not bucketed else jnp.int32(9))
    ol, oc = ttf.prefill(tcf, tparams, _t(toks), 32,
                         patches=_t(b["patches"]),
                         true_len=torch.tensor(9) if bucketed else None)
    np.testing.assert_array_equal(oc.lengths.numpy(), [13, 13])
    _close(ol, jl, **LOGIT_TOL)
    for step in range(4):
        _assert_cache_close(oc, jc)
        if step == 3:
            break
        nxt = jnp.argmax(jl, -1).astype(jnp.int32)
        jl, jc, js = _jdecode(cfg, params, nxt, jc)
        ol, oc, os_ = ttf.decode_step(tcf, tparams, _t(nxt), oc)
        _close(ol, jl, **LOGIT_TOL)
        assert tuple(os_.shape) == (2, 32)
        _close(os_, js)


def test_prefill_without_patches_is_the_text_model():
    """Without patches the vlm prefill is the dense decoder's on the
    tokens alone (what the engine serves, as the reference's)."""
    cfg, params, tcf, tparams = _models()
    toks = _batch(cfg, seed=4, S=10)["tokens"]
    jl, jc = _jprefill(cfg, params, jnp.asarray(toks), 16)
    ol, oc = ttf.prefill(tcf, tparams, _t(toks), 16)
    _close(ol, jl, **LOGIT_TOL)
    _assert_cache_close(oc, jc)
    np.testing.assert_array_equal(oc.lengths.numpy(), [10, 10])


# ------------------------------------------------------------ kernels
def _dense_inputs(seed, B=3, S=48, H=14, Hkv=2, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    mask = rng.random((B, S)) < 0.6
    mask[0, 16:32] = False                  # a dead split at block_s 16
    lens = np.array([S, 21, 0], np.int32)   # ragged, an all-dead row
    return q, k, v, mask, lens


def test_flash_decode_plain_matches_pallas_at_group_7():
    """Stacked over 16-token splits and merged, at (head dim 64, group
    7): (o, m, l) against the Pallas kernel and the JAX partial."""
    q, k, v, mask, lens = _dense_inputs(seed=5)
    want = jfd.flash_decode(*map(jnp.asarray, (q, k, v, mask)),
                            kv_lens=jnp.asarray(lens), block_s=16,
                            interpret=True)
    got = tfd.flash_decode(*map(_t, (q, k, v, mask)), kv_lens=_t(lens),
                           block_s=16)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, **KERNEL_TOL)
    want = jops.decode_attention_partial(*map(jnp.asarray, (q, k, v, mask)),
                                         kv_lens=jnp.asarray(lens),
                                         interpret=True)
    got = tfd.flash_decode_merged(*map(_t, (q, k, v, mask)),
                                  kv_lens=_t(lens))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, **KERNEL_TOL)


def test_flash_decode_paged_plain_matches_pallas_at_group_7():
    """Stacked and merged over a paged pool at (head dim 64, group 7),
    with dead blocks, sentinel entries and a row with no live token."""
    rng = np.random.default_rng(6)
    B, NB, bs, nb, H, Hkv, d = 3, 20, 4, 6, 14, 2, 64
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp = rng.standard_normal((NB + 1, bs, Hkv, d)).astype(np.float32)
    vp = rng.standard_normal((NB + 1, bs, Hkv, d)).astype(np.float32)
    table = rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32)
    table[1, 4:] = NB
    mask = rng.random((B, nb * bs)) < 0.5
    mask[1, 16:] = False
    mask[2, :] = False
    live = mask.reshape(B, nb, bs).any(-1)
    live[0, 3] = False
    args = (q, kp, vp, table, mask)
    want = jfd.flash_decode_paged(*map(jnp.asarray, args),
                                  block_live=jnp.asarray(live),
                                  interpret=True)
    got = tfd.flash_decode_paged(*map(_t, args), block_live=_t(live))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, **KERNEL_TOL)
    want = jops.paged_decode_attention_partial(
        *map(jnp.asarray, args), block_live=jnp.asarray(live),
        use_kernel=True, interpret=True)
    got = tfd.flash_decode_paged_merged(*map(_t, args), block_live=_t(live))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, **KERNEL_TOL)


# ------------------------------------------------------------ refusals
def _port_pam(max_len=64):
    j = make_pam(max_len=max_len)
    return tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval)


def test_suffix_prefill_refuses_vlm_as_the_reference():
    """``prefill_suffix`` (the prefix-cache and chunked admissions'
    prefill) refuses the vlm family with the reference's error."""
    cfg, params, tcf, tparams = _models()
    toks = np.zeros((1, 8), np.int32)
    z = np.zeros((cfg.n_layers, 1, cfg.n_kv_heads, 4, cfg.head_dim),
                 np.float32)
    with pytest.raises(ValueError, match="suffix prefill needs a token-"
                                         "only GQA cache; family vlm"):
        jtf.prefill_suffix(cfg, params, jnp.asarray(toks), jnp.asarray(z),
                           jnp.asarray(z), 4)
    with pytest.raises(ValueError, match="suffix prefill needs a token-"
                                         "only GQA cache; family vlm"):
        ttf.prefill_suffix(tcf, tparams, _t(toks), _t(z), _t(z), 4)


def test_engine_refuses_prefix_cache_as_the_reference():
    """``prefix_cache`` on a vlm model raises the reference's
    ``ValueError`` at construction."""
    cfg, params, tcf, tparams = _models()
    kw = dict(max_batch=2, max_len=64, block_size=8, prefix_cache=True)
    with pytest.raises(ValueError, match="vlm patch prefix has none"):
        make_engine(cfg, params, pam=make_pam(max_len=64), **kw)
    with pytest.raises(ValueError, match="vlm patch prefix has none"):
        teng.ServingEngine(tcf, tparams, teng.ServingConfig(
            pam=_port_pam(), **kw), device="cpu")


def test_chunked_admission_fails_as_the_reference():
    """A prompt above ``prefill_chunk`` admits in slices through
    ``prefill_suffix``, which refuses vlm: both engines raise its
    ``ValueError`` at the first slice, and a prompt within the budget
    is served."""
    cfg, params, tcf, tparams = _models()
    kw = dict(max_batch=2, max_len=64, block_size=8, prefill_chunk=8)
    jeng = make_engine(cfg, params, pam=make_pam(max_len=64), **kw)
    peng = teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=_port_pam(), **kw), device="cpu")
    rng = np.random.default_rng(9)
    short = rng.integers(0, cfg.vocab, 6).astype(np.int32)
    long = rng.integers(0, cfg.vocab, 20).astype(np.int32)
    jeng.submit(JaxRequest(id=0, prompt=short, max_new_tokens=3))
    peng.submit(teng.Request(id=0, prompt=short, max_new_tokens=3))
    jeng.run()
    peng.run()
    assert ([int(t) for t in peng.requests[0].outputs]
            == [int(t) for t in jeng.requests[0].outputs])
    for eng, cls in ((jeng, JaxRequest), (peng, teng.Request)):
        eng.submit(cls(id=1, prompt=long, max_new_tokens=3))
        with pytest.raises(ValueError, match="suffix prefill needs a "
                                             "token-only GQA cache"):
            eng.run()
