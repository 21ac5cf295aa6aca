"""The port's dense model against the JAX reference on reduced
``qwen3-0.6b`` and ``pam-llama-7b``: the parameter layout and bridge,
bucketed prefill, and ``decode_step`` on the dense path and on the paged
+ hot-ring path (logits, attention-mass scores, ring, pools).

Weights come from ``conftest.build_model`` through ``repro_torch.bridge``;
every other input is drawn from a seeded numpy generator. fp32
throughout. Tolerances: logits 1e-4 (a few layers of matrix products in
different summation orders), caches and scores 1e-5; integer state is
exact.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import build_model  # noqa: E402

from repro.models import transformer as jtf  # noqa: E402
from repro.serving import pam_manager as jpm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

torch.set_num_threads(2)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("qwen3-0.6b", "pam-llama-7b")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg, params = build_model(request.param)
    tcf = tcfg.reduced(tcfg.get_config(request.param))
    return cfg, params, tcf, bridge.params_from_jax(tcf, _np_tree(params),
                                                    device="cpu")


def test_reduced_config_matches_reference(model):
    cfg, _, tcf, _ = model
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "head_dim", "qk_norm",
              "rope_theta", "tie_embeddings", "rms_eps", "dtype", "causal"):
        assert getattr(tcf, f) == getattr(cfg, f), f


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_init_params_layout_matches_reference(model):
    """Same keys, shapes and dtypes as ``tf.init_params``, so the bridge
    is a plain copy; the bridged weights are bit-equal."""
    _, params, tcf, tparams = model
    ref = _leaves(_np_tree(params))
    own = _leaves(ttf.init_params(tcf, 0, device="cpu"))
    assert sorted(own) == sorted(ref)
    for name, a in ref.items():
        assert tuple(own[name].shape) == a.shape, name
        assert str(own[name].dtype).split(".")[-1] == a.dtype.name, name
    for name, t in _leaves(tparams).items():
        np.testing.assert_array_equal(t.numpy(), ref[name])


def _prompts(vocab, B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("bucketed", [False, True])
def test_prefill_matches_jax(model, bucketed):
    """Logits, the filled cache and lengths; ``bucketed`` right-pads the
    prompts to a pow-2 bucket with ragged ``true_len`` (logits from
    position ``true_len - 1``)."""
    cfg, params, tcf, tparams = model
    toks = _prompts(cfg.vocab)
    true_len = None
    if bucketed:
        true_len = np.array([12, 9], np.int32)
        toks = np.pad(toks, ((0, 0), (0, 4)))
        toks[1, 9:] = 0
    jl, jc = jtf.prefill(cfg, params, jnp.asarray(toks), 32,
                         true_len=None if true_len is None
                         else jnp.asarray(true_len))
    tl, tc = ttf.prefill(tcf, tparams, torch.from_numpy(toks), 32,
                         true_len=None if true_len is None
                         else torch.from_numpy(true_len))
    _close(tl, jl, **LOGIT_TOL)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def test_decode_step_dense_matches_jax(model):
    """Three greedy steps after a JAX prefill, the cache carried across
    by ``bridge.cache_from_jax``; default dense attention."""
    cfg, params, tcf, tparams = model
    jl, jc = jtf.prefill(cfg, params, jnp.asarray(_prompts(cfg.vocab, S=10)),
                         24)
    tc = bridge.cache_from_jax(jc, device="cpu")
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    tt = torch.from_numpy(np.array(jt))
    for _ in range(3):
        jl, jc, js = jtf.decode_step(cfg, params, jt, jc)
        tl, tc, ts = ttf.decode_step(tcf, tparams, tt, tc)
        _close(tl, jl, **LOGIT_TOL)
        _close(ts, js)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths))
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _paged_state(cfg, seed, B=2, Smax=32, bs=4, W=8, NB=16):
    """A paged + ring cache with random contents, per-row block tables,
    and one step's tiered participation split."""
    rng = np.random.default_rng(seed)
    L, Hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    nb = Smax // bs
    lens = np.array([21, 7], np.int32)[:B]           # tokens cached
    cache = jtf.init_decode_cache(cfg, B, Smax, paged_blocks=NB,
                                  block_size=bs, hot_window=W)
    f32 = np.float32
    cache = cache._replace(
        k=jnp.asarray(rng.standard_normal((L, B, Hkv, W, dh)).astype(f32)),
        v=jnp.asarray(rng.standard_normal((L, B, Hkv, W, dh)).astype(f32)),
        pk=jnp.asarray(rng.standard_normal(
            (L, NB + 1, bs, Hkv, dh)).astype(f32)),
        pv=jnp.asarray(rng.standard_normal(
            (L, NB + 1, bs, Hkv, dh)).astype(f32)),
        lengths=jnp.asarray(lens))
    table = np.full((B, nb), NB, np.int32)
    ids = rng.permutation(NB)
    used = 0
    for b in range(B):
        n = -(-(int(lens[b]) + 1) // bs)
        table[b, :n] = ids[used:used + n]
        used += n
    new_len = lens + 1
    pos = np.arange(Smax)[None, :]
    part = (rng.random((B, Smax)) < 0.6) & (pos < new_len[:, None])
    part[np.arange(B), lens] = True                  # the new token
    tier = rng.integers(0, 3, (B, Smax)).astype(np.int32)
    hot, pgd, live = (np.array(a) for a in jpm.paged_participation_split(
        jnp.asarray(part), jnp.asarray(tier), jnp.asarray(new_len), bs, W))
    table_eff = np.where(live, table, NB).astype(np.int32)
    dst = (table[np.arange(B), lens // bs], (lens % bs).astype(np.int32))
    return cache, hot, pgd, table_eff, live, dst


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_step_paged_ring_matches_jax(model, seed):
    """One step on the paged + ring layout: ring append at ``pos % W``,
    pool mirror at (dst_block, dst_slot), hot-ring ⊕ paged attention —
    logits, scores, ring and pools."""
    cfg, params, tcf, tparams = model
    jc, hot, pgd, table, live, (blk, slot) = _paged_state(cfg, seed)
    tc = bridge.cache_from_jax(jc, device="cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, 2).astype(
        np.int32)
    jfn = jpm.make_paged_decode_attn(jnp.asarray(hot), jnp.asarray(pgd),
                                     jnp.asarray(table), jnp.asarray(live))
    tfn = tpm.make_paged_decode_attn(torch.from_numpy(hot),
                                     torch.from_numpy(pgd),
                                     torch.from_numpy(table),
                                     torch.from_numpy(live))
    jl, jc2, js = jtf.decode_step(
        cfg, params, jnp.asarray(toks), jc, decode_attn_fn=jfn,
        paged_append=(jnp.asarray(blk), jnp.asarray(slot)))
    tl, tc2, ts = ttf.decode_step(
        tcf, tparams, torch.from_numpy(toks), tc, decode_attn_fn=tfn,
        paged_append=(torch.from_numpy(blk), torch.from_numpy(slot)))
    assert live.any() and hot.any()
    _close(tl, jl, **LOGIT_TOL)
    _close(ts, js, rtol=1e-5, atol=1e-4)             # count-scaled mass
    for name in ("k", "v", "pk", "pv"):
        _close(getattr(tc2, name), getattr(jc2, name))
    np.testing.assert_array_equal(tc2.lengths.numpy(),
                                  np.asarray(jc2.lengths))


def test_paged_cache_without_append_raises(model):
    _, _, tcf, tparams = model
    cache = ttf.init_decode_cache(tcf, 1, 16, paged_blocks=4, block_size=4,
                                  device="cpu")
    with pytest.raises(ValueError, match="paged_append"):
        ttf.decode_step(tcf, tparams, torch.zeros(1, dtype=torch.int32),
                        cache)


def test_other_families_name_their_roadmap_item():
    """A family whose cache the paged pools cannot hold (MLA's latent
    cache) raises the reference's ``ValueError`` from its cache at any
    shard, as the JAX engine does: its sharded engine builds the cache
    before it checks the shard."""
    from repro_torch.serving.engine import ServingConfig
    from repro_torch.serving.spec import EngineSpec
    cfg = tcfg.reduced(tcfg.get_config("deepseek-v2-lite-16b"))
    pam = tpm.PAMManagerConfig(max_tokens=64, hot_capacity=8,
                               warm_capacity=16)
    scfg = ServingConfig(max_batch=2, max_len=64, pam=pam, block_size=8,
                         pool_blocks=23, hot_window=16)
    with pytest.raises(ValueError, match="paged KV pools require a GQA"):
        EngineSpec(model=cfg, serving=scfg, shard=2).build({}, device="cpu")
