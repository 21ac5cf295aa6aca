"""The port's MLA mixture-of-experts family (``deepseek-v2-lite-16b``)
against the JAX reference.

``repro_torch.models.mla`` (``mla_train``, ``mla_prefill``,
``mla_latent_decode_attn``, ``mla_decode``) and
``serving.pam_manager.make_masked_latent_attn`` against the reference's
functions at the reduced widths (4 heads, r 32, nope 16, rope 8, v 16)
and at one layer of full MLA width (d 2048, 16 heads, r 512, nope 128,
rope 64, v 128; B 2, S 64); the copied config; the reduced model's
layout, prefill (with and without ``true_len``) and three decode steps
(logits and the latent cache) with the reference's weights through
``repro_torch.bridge``; the serving engine's greedy streams and every
dispatch's ``StepBufs`` against the JAX engine on dense PAM at
``micro_steps`` 1 and 4, with one request filling ``max_len`` exactly
while another decodes; the refusals (pools, migration, the training
forward); the serve CLI.

Inputs are fixed-seed numpy draws, fp32 throughout. Tolerances:
module outputs and latent caches rtol / atol 1e-5, at both widths;
logits 1e-4 as in ``tests/test_torch_moe.py``; streams, tier reads,
moves and lengths exactly, the hit rate bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import build_model, make_engine, make_pam  # noqa: E402
from test_torch_decode_graph import (_assert_bufs_equal,  # noqa: E402
                                     _outputs, _record_jax, _record_port)

from repro.models import mla as jmla  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import get_config, reduced  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import pam_manager as jpm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 64
PAM_KW = dict(hot=8, warm=8, compression=2)      # every tier read, Alg. 2

# the reference's functions under jit (one compile a shape, not one per
# eager call of their scans and maps)
_MLA_KW = ("cfg", "n_heads", "rope_theta", "rms_eps", "causal", "q_chunk")
_jtrain = jax.jit(jmla.mla_train, static_argnames=_MLA_KW)
_jprefill_mla = jax.jit(jmla.mla_prefill, static_argnames=_MLA_KW)
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


# ------------------------------------------------------------ the config
def test_config_matches_reference():
    """The copied config, full and reduced, field for field, and its
    parameter counts (32.42 GB of bf16 at full size)."""
    for own, ref in ((tcfg.get_config(ARCH), get_config(ARCH)),
                     (tcfg.reduced(tcfg.get_config(ARCH)),
                      reduced(get_config(ARCH)))):
        assert dataclasses.asdict(own) == dataclasses.asdict(ref)
        assert own.param_count() == ref.param_count()
        assert own.active_param_count() == ref.active_param_count()
    full = tcfg.get_config(ARCH)
    assert (full.n_layers, full.mla.kv_lora_rank, full.mla.q_lora_rank,
            full.moe.num_experts, full.moe.top_k,
            full.moe.num_shared) == (27, 512, 0, 64, 6, 2)
    assert round(full.param_count() * 2 / 1e9, 2) == 32.42


# ------------------------------------------------------------ the module
WIDTHS = {"reduced": reduced(get_config(ARCH)),
          "full_width": get_config(ARCH)}


def _layer(width, seed=0):
    """(cfg, JAX MLAParams, port MLAParams): one layer of ``width``'s
    MLA in fp32, the reference's initialiser."""
    cfg = WIDTHS[width]
    jp = jmla.init_mla(jax.random.PRNGKey(seed), cfg.d_model, cfg.n_heads,
                       cfg.mla, jnp.float32)
    tp = tmla.MLAParams(*(_t(a) for a in jp))
    return cfg, jp, tp


def _kw(cfg):
    return dict(n_heads=cfg.n_heads, rope_theta=cfg.rope_theta,
                rms_eps=cfg.rms_eps)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_mla_train_and_prefill_match_reference(width):
    """``mla_train`` (B 2, S 64; causal, and bidirectional at the reduced
    width) and ``mla_prefill``'s output, latent and rope key."""
    cfg, jp, tp = _layer(width)
    x = np.random.default_rng(1).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    for causal in ((True, False) if width == "reduced" else (True,)):
        _close(tmla.mla_train(tp, _t(x), cfg.mla, causal=causal,
                              q_chunk=24, **_kw(cfg)),
               _jtrain(jp, jnp.asarray(x), cfg=cfg.mla, causal=causal,
                       q_chunk=24, **_kw(cfg)))
    got = tmla.mla_prefill(tp, _t(x), cfg.mla, **_kw(cfg))
    want = _jprefill_mla(jp, jnp.asarray(x), cfg=cfg.mla, **_kw(cfg))
    assert tuple(got[1].shape) == (2, 64, cfg.mla.kv_lora_rank)
    assert tuple(got[2].shape) == (2, 64, cfg.mla.qk_rope_head_dim)
    for g, w in zip(got, want):
        _close(g, w)


def _latent_case(cfg, seed, B=3, smax=40):
    """q_eff, latent, rope key, kv_lens (one row empty), participation
    (one live row masked out entirely)."""
    rng = np.random.default_rng(seed)
    m = cfg.mla
    r, dr = m.kv_lora_rank, m.qk_rope_head_dim
    q = rng.standard_normal((B, cfg.n_heads, r + dr)).astype(np.float32)
    lat = rng.standard_normal((B, smax, r)).astype(np.float32)
    kr = rng.standard_normal((B, smax, dr)).astype(np.float32)
    lens = np.array([smax, 0, 17][:B], np.int32)
    part = rng.random((B, smax)) < 0.6
    part[0] = False
    return q, lat, kr, lens, part


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_latent_decode_attention_matches_reference(width):
    """``mla_latent_decode_attn`` (mass: head mean x ``kv_lens``) and
    ``make_masked_latent_attn`` (mass: head mean x the live count): the
    latent output and the mass; rows with nothing live give zeros."""
    cfg = WIDTHS[width]
    q, lat, kr, lens, part = _latent_case(cfg, seed=2)
    m = cfg.mla
    scale = 1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    cases = ((tmla.mla_latent_decode_attn, jmla.mla_latent_decode_attn),
             (tpm.make_masked_latent_attn(_t(part)),
              jpm.make_masked_latent_attn(jnp.asarray(part))))
    for own, ref in cases:
        got = own(_t(q), _t(lat), _t(kr), _t(lens), scale=scale)
        want = ref(jnp.asarray(q), jnp.asarray(lat), jnp.asarray(kr),
                   jnp.asarray(lens), scale=scale)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            _close(g, w)
        assert not got[0][1].any() and not got[1][1].any()
    masked = cases[1][0](_t(q), _t(lat), _t(kr), _t(lens), scale=scale)
    assert not masked[0][0].any() and not masked[1][0].any()


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_mla_decode_matches_reference(width):
    """Three ``mla_decode`` steps over a latent cache (B 2, Smax 64, rows
    at 5 and 63 tokens: the second writes its last slot), default and
    participation-masked attention: the output, the mass and both caches
    written in place."""
    cfg, jp, tp = _layer(width, seed=3)
    m = cfg.mla
    rng = np.random.default_rng(4)
    B, smax = 2, 64
    ckv = rng.standard_normal((B, smax, m.kv_lora_rank)).astype(np.float32)
    krp = rng.standard_normal((B, smax, m.qk_rope_head_dim)).astype(
        np.float32)
    part = rng.random((B, smax)) < 0.7
    for masked in (False, True):
        jc, jk = jnp.asarray(ckv), jnp.asarray(krp)
        tc, tk = _t(ckv), _t(krp)
        for step, lens in enumerate(([3, 61], [4, 62], [5, 63])):
            x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
            lens = np.array(lens, np.int32)
            jfn = (jpm.make_masked_latent_attn(jnp.asarray(part)) if masked
                   else jmla.mla_latent_decode_attn)
            tfn = (tpm.make_masked_latent_attn(_t(part)) if masked
                   else tmla.mla_latent_decode_attn)
            jo, jmass, jc, jk = jmla.mla_decode(
                jp, jnp.asarray(x), jc, jk, jnp.asarray(lens), cfg.mla,
                latent_attn_fn=jfn, **_kw(cfg))
            to, tmass, tc2, tk2 = tmla.mla_decode(
                tp, _t(x), tc, tk, _t(lens), cfg.mla, latent_attn_fn=tfn,
                **_kw(cfg))
            assert tc2 is tc and tk2 is tk          # written in place
            _close(to, jo)
            _close(tmass, jmass)
            _close(tc, jc)
            _close(tk, jk)


# ------------------------------------------------------------ the model
_TORCH: dict = {}


def _models():
    """(JAX cfg, JAX params, port cfg, port params): the same weights."""
    cfg, params = build_model(ARCH)
    if not _TORCH:
        tcf = tcfg.reduced(tcfg.get_config(ARCH))
        _TORCH["m"] = (tcf, bridge.params_from_jax(tcf, _np_tree(params),
                                                   device="cpu"))
    return (cfg, params) + _TORCH["m"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_init_params_layout_matches_reference():
    """Keys, shapes and dtypes of ``tf.init_params``: ``layers/mla`` in
    place of ``attn``, ``layers/moe`` with its shared experts, no
    ``mlp``; the latent decode cache's shapes."""
    cfg, _, tcf, _ = _models()
    ref = _leaves(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda: jtf.init_params(cfg,
                                               jax.random.PRNGKey(0)))))
    own = _leaves(ttf.init_params(tcf, 0, device="cpu"))
    assert sorted(own) == sorted(ref)
    assert "/layers/mla/w_uk" in own and "/layers/moe/shared_gate" in own
    for name, a in ref.items():
        assert tuple(own[name].shape) == a.shape, name
        assert str(own[name].dtype).split(".")[-1] == a.dtype.name, name
    jc = jtf.init_decode_cache(cfg, 3, MAX_LEN)
    tc = ttf.init_decode_cache(tcf, 3, MAX_LEN, device="cpu")
    for f in ttf.DecodeCache._fields:
        assert tuple(getattr(tc, f).shape) == getattr(jc, f).shape, f


@pytest.mark.parametrize("bucketed", [False, True])
def test_prefill_and_decode_match_reference(bucketed):
    """``prefill`` (B 2 prompts of 11 tokens, or right-padded to 16 with
    ``true_len`` 11 and 7) and three greedy ``decode_step``s, each fed
    the reference's token: logits and the latent cache (``ckv``,
    ``krope``) every step, and the layer-mean scores."""
    cfg, params, tcf, tparams = _models()
    rng = np.random.default_rng(5 + bucketed)
    toks = rng.integers(0, cfg.vocab, (2, 16 if bucketed else 11)).astype(
        np.int32)
    tl = np.array([11, 7], np.int32) if bucketed else None
    jl, jc = _jprefill(cfg, params, jnp.asarray(toks), 32,
                       true_len=None if tl is None else jnp.asarray(tl))
    ol, oc = ttf.prefill(tcf, tparams, _t(toks), 32,
                         true_len=None if tl is None else _t(tl))
    _close(ol, jl, **LOGIT_TOL)
    assert oc.k.numel() == 0 and oc.ckv.shape == jc.ckv.shape
    for step in range(4):
        _close(oc.ckv, jc.ckv)
        _close(oc.krope, jc.krope)
        np.testing.assert_array_equal(oc.lengths.numpy(),
                                      np.asarray(jc.lengths))
        if step == 3:
            break
        nxt = jnp.argmax(jl, -1).astype(jnp.int32)
        jl, jc, js = _jdecode(cfg, params, nxt, jc)
        ol, oc, os_ = ttf.decode_step(tcf, tparams, _t(nxt), oc)
        _close(ol, jl, **LOGIT_TOL)
        _close(os_, js)


def test_bridged_cache_decodes_as_reference():
    """A reference cache through ``bridge.cache_from_jax`` carries the
    latent fields; one decode step from it matches."""
    cfg, params, tcf, tparams = _models()
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 9)).astype(
        np.int32)
    jl, jc = _jprefill(cfg, params, jnp.asarray(toks), 16)
    tc = bridge.cache_from_jax(jc, device="cpu")
    _close(tc.ckv, jc.ckv, rtol=0, atol=0)
    nxt = jnp.argmax(jl, -1).astype(jnp.int32)
    jl, jc, _ = _jdecode(cfg, params, nxt, jc)
    ol, tc, _ = ttf.decode_step(tcf, tparams, _t(nxt), tc)
    _close(ol, jl, **LOGIT_TOL)
    _close(tc.krope, jc.krope)


def test_training_forward_and_pools_refuse():
    """``forward`` / ``loss_fn`` with ``activation_spec`` (the
    sequence-parallel residual, a refusal that still stands) raise
    naming ROADMAP Queue 1 item 10 (this family's sharded
    training); paged pools raise the reference's
    ``ValueError``, as the suffix prefill does."""
    _, _, tcf, tparams = _models()
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64),
             "labels": torch.zeros((1, 4), dtype=torch.int64)}
    for fn in (ttf.forward, ttf.loss_fn):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 10"):
            fn(tcf, tparams, batch, activation_spec=object())
    with pytest.raises(ValueError, match="paged KV pools require a GQA"):
        ttf.init_decode_cache(tcf, 2, 32, paged_blocks=4, block_size=8,
                              device="cpu")
    z = torch.zeros((1, 2, 2, 4, 16))
    with pytest.raises(ValueError, match="suffix prefill"):
        ttf.prefill_suffix(tcf, tparams, torch.zeros((1, 4),
                                                     dtype=torch.int64),
                           z, z, 4)


# ------------------------------------------------------------ the engine
def _port_pam():
    j = make_pam(max_len=MAX_LEN, **PAM_KW)
    return tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval)


def _port_engine(**extra):
    _, _, tcf, tparams = _models()
    eng = teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=_port_pam(), max_batch=3, max_len=MAX_LEN, **extra),
        device="cpu")
    _record_port(eng)
    return eng


def _jax_engine(**extra):
    cfg, params = _models()[:2]
    jeng = make_engine(cfg, params, pam=make_pam(max_len=MAX_LEN, **PAM_KW),
                       max_batch=3, max_len=MAX_LEN, **extra)
    _record_jax(jeng)
    return jeng


# request 1 fills max_len exactly (56 + 8 = 64) while the others decode
FULL_PROMPT = 56


def _prompts(vocab, seed=0, lens=(20, FULL_PROMPT, 9, 33, 14)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve(eng, prompts, new, cls):
    for i, p in enumerate(prompts):
        eng.submit(cls(id=i, prompt=p, max_new_tokens=new))
    eng.run()
    return _outputs(eng)


@pytest.mark.parametrize("micro", [1, 4])
def test_greedy_streams_and_stepbufs_equal_jax_engine(micro):
    """Five requests through three slots on dense PAM, greedy, one of
    them to exactly ``max_len``: the streams equal the JAX engine's at
    ``micro_steps`` 1 (ROADMAP Queue 3: its pipelined loop is held to
    its own single-step streams), and every dispatch's StepBufs equal
    the JAX engine's at the same ``micro_steps``."""
    peng = _port_engine(micro_steps=micro)
    prompts = _prompts(peng.cfg.vocab)
    got = _serve(peng, prompts, 8, teng.Request)
    jeng = _jax_engine(micro_steps=micro)
    want = _serve(jeng, prompts, 8, JaxRequest)
    if micro > 1:
        assert peng.decode_device_steps > peng.decode_dispatches
        assert want == _serve(_jax_engine(), prompts, 8, JaxRequest)
    assert got == want
    _assert_bufs_equal(jeng, peng)
    assert all(len(v) == 8 for v in got.values())
    assert max(int(b["lengths"].max()) for b in peng.log) == MAX_LEN - 1
    assert sum(peng.summary()["tier_reads"]) > 0


def test_engine_refuses_what_the_reference_refuses():
    """Past ``max_len`` (57 + 8 at 64), pools, and migration (export,
    import, suspend) raise as in the reference."""
    peng = _port_engine()
    vocab = peng.cfg.vocab
    peng.submit(teng.Request(id=0, prompt=np.zeros(57, np.int32),
                             max_new_tokens=8))
    with pytest.raises(ValueError, match="exceeds max_len"):
        peng.step()
    with pytest.raises(ValueError, match="paged KV pools require a GQA"):
        _port_engine(block_size=8)
    peng = _port_engine()
    peng.submit(teng.Request(id=0, prompt=_prompts(vocab)[0],
                             max_new_tokens=8))
    peng.step()
    for fn in (peng.export_request, peng.suspend_request):
        with pytest.raises(ValueError, match="pure GQA decode cache"):
            fn(0)
    with pytest.raises(ValueError, match="pure GQA decode cache"):
        peng.import_request({})


def test_serve_cli_runs_the_mla_family():
    """``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    --reduced --device cpu`` serves on dense PAM; ``--block-size``
    raises the reference's error."""
    from repro_torch.launch import serve as tserve
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
            "3", "--prompt-len", "12", "--gen-len", "5", "--max-len", "32",
            "--max-batch", "2"]
    out = tserve.main(args)
    assert out["finished"] == 3 and out["total_tokens"] == 15
    with pytest.raises(ValueError, match="paged KV pools require a GQA"):
        tserve.main(args + ["--block-size", "8"])
