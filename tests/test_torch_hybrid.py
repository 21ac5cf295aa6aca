"""The port's hybrid family (``zamba2-7b``: groups of Mamba-2 layers, each
followed by one shared attention + MLP block at a KV cache site of its
own, then a Mamba-2 tail) against the JAX reference.

- the copied config, full and reduced, and both parameter counts;
- ``init_params``' layout (``mamba_groups`` stacked (n_groups,
  mamba_per_group, ...), ``tail_mamba``, the unstacked ``shared_attn``)
  and the decode cache's shapes against the reference's;
- ``prefill`` and three ``decode_step``s on the reference's weights
  through ``repro_torch.bridge``: logits, the cache field by field
  (every site's K/V, the conv rings and the fp32 states) and the
  sites' mean scores, at the reduced width (head dim 16, group 2) and
  with 4 q / 4 kv heads of 112 (zamba2's head dim inside the model);
  a bridged cache decodes as the reference's;
- the decode kernels' plain versions at (head dim 112, group 1), stacked
  and merged, dense and paged, against the Pallas kernels in
  ``interpret=True``;
- the serving engine's greedy streams and every dispatch's ``StepBufs``
  against the JAX engine's, on dense PAM and with no PAM, at
  ``micro_steps`` 1 and 4 (one request filling ``max_len`` exactly), and
  one sampled run;
- the refusals (pools, ``true_len``, the training forward's
  ``activation_spec`` naming ROADMAP Queue 1 item 10, migration) and the
  serve CLI (training: ``tests/test_torch_hybrid_train.py``).

Inputs are fixed-seed numpy draws, fp32 throughout. Tolerances: logits
1e-4 as in ``tests/test_torch_mla.py``; K/V and scores 1e-5; recurrent
state 1e-5; kernel partials rtol 1e-5 / atol 1e-4 as
``tests/test_torch_gqa.py``; streams, tier reads, moves and lengths
exactly, the hit rate bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import make_engine, make_pam  # noqa: E402
from test_torch_decode_graph import (_assert_bufs_equal,  # noqa: E402
                                     _outputs, _record_jax, _record_port)

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

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)
MAX_LEN = 64
PAM_KW = dict(hot=8, warm=8, compression=2)      # every tier read, Alg. 2
SAMPLED = dict(temperature=0.8, top_k=8, sample_seed=3)
# the reduced variants: the reduced config (4 q / 2 kv heads of 16), and
# zamba2's head dim with its group 1 (4 q / 4 kv heads of 112)
VARIANTS = {"reduced": {},
            "d112": dict(n_heads=4, n_kv_heads=4, d_head=112)}

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


# ------------------------------------------------------------ the config
def test_config_and_param_counts_match_reference():
    """The copied config, full and reduced, field for field, and both
    parameter counts (5.737 B parameters, 11.47 GB of bf16, at full
    size: 68 Mamba-2 layers and one shared block)."""
    for own, ref in ((tcfg.get_config(ARCH), get_config(ARCH)),
                     (tcfg.reduced(tcfg.get_config(ARCH)),
                      reduced(get_config(ARCH)))):
        assert dataclasses.asdict(own) == dataclasses.asdict(ref)
        assert own.param_count() == ref.param_count()
        assert own.active_param_count() == ref.active_param_count()
    full = tcfg.get_config(ARCH)
    hb = full.hybrid
    assert (hb.n_groups, hb.mamba_per_group, hb.tail_mamba) == (13, 5, 3)
    assert (full.n_heads, full.n_kv_heads, full.head_dim) == (32, 32, 112)
    assert round(full.param_count() / 1e9, 3) == 5.737
    assert round(full.param_count() * 2 / 1e9, 2) == 11.47


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
    reference's tree (fp32 ``dt_bias`` / ``a_log`` / ``d_skip`` kept
    fp32 in a bf16 model too), and the decode cache's shapes: a K/V
    site a group, a conv ring and an fp32 state a Mamba-2 layer."""
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
        assert "/shared_attn/attn/wq" in own and "/layers/ln" not in own
        for name, a in ref.items():
            assert tuple(own[name].shape) == a.shape, name
            got = str(own[name].dtype).split(".")[-1]
            assert got == a.dtype.name, (name, got, a.dtype)
    hb = cfg.hybrid
    assert own["/mamba_groups/ln"].shape[:2] == (hb.n_groups,
                                                 hb.mamba_per_group)
    assert tuple(own["/shared_attn/attn/q_norm"].shape) == (0,)
    jc = jtf.init_decode_cache(cfg, 3, MAX_LEN)
    tc = ttf.init_decode_cache(tcf, 3, MAX_LEN, device="cpu")
    for f in ttf.DecodeCache._fields:
        assert tuple(getattr(tc, f).shape) == getattr(jc, f).shape, f
        assert str(getattr(tc, f).dtype).split(".")[-1] == \
            getattr(jc, f).dtype.name, f
    assert tc.k.shape[0] == hb.n_groups
    assert tc.state.shape[0] == hb.n_groups * hb.mamba_per_group + \
        hb.tail_mamba


def _assert_cache_close(tc, jc):
    for f in ("k", "v", "conv", "state"):
        _close(getattr(tc, f), getattr(jc, f))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    for f in ("pk", "pv", "ckv", "krope"):
        assert getattr(tc, f).numel() == 0, f


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_match_reference(variant):
    """``prefill`` (B 2 prompts of 11 tokens, exact length) and three
    greedy ``decode_step``s, each fed the reference's token: logits, the
    cache field by field and the sites' mean scores every step."""
    cfg, params, tcf, tparams = _models(variant)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 11)).astype(
        np.int32)
    jl, jc = _jprefill(cfg, params, jnp.asarray(toks), 32)
    ol, oc = ttf.prefill(tcf, tparams, _t(toks), 32)
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


def test_bridged_cache_decodes_as_reference():
    """A reference cache through ``bridge.cache_from_jax`` carries the
    sites' K/V, the conv rings and the states exactly; one decode step
    from it matches."""
    cfg, params, tcf, tparams = _models()
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 9)).astype(
        np.int32)
    jl, jc = _jprefill(cfg, params, jnp.asarray(toks), 16)
    tc = bridge.cache_from_jax(jc, device="cpu")
    for f in ("k", "v", "conv", "state"):
        _close(getattr(tc, f), getattr(jc, f), rtol=0, atol=0)
    assert tc.state.dtype == torch.float32
    nxt = jnp.argmax(jl, -1).astype(jnp.int32)
    jl, jc, js = _jdecode(cfg, params, nxt, jc)
    ol, tc, ts = ttf.decode_step(tcf, tparams, _t(nxt), tc)
    _close(ol, jl, **LOGIT_TOL)
    _close(ts, js)
    _assert_cache_close(tc, jc)


# ------------------------------------------------------------ kernels


def _dense_inputs(seed, B=2, S=64, H=4, Hkv=4, d=112):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    v[..., 96:] *= 3.0                     # the last 16 dims stand apart
    mask = rng.random((B, S)) < 0.6
    mask[0, 16:32] = False                 # a dead split at block_s 16
    lens = np.array([S, 0][:B], np.int32)  # a full row and an all-dead one
    return q, k, v, mask, lens


def test_flash_decode_plain_matches_pallas_at_head_dim_112():
    """``flash_decode`` (stacked over 16-token splits) and
    ``flash_decode_merged`` at head dim 112, group 1 (B 2, S 64): (o, m,
    l) against the Pallas kernel in ``interpret=True`` and the JAX
    partial; the all-dead row keeps m = -1e30 and o = l = 0."""
    q, k, v, mask, lens = _dense_inputs(seed=5)
    j = [jnp.asarray(x) for x in (q, k, v, mask)]
    t = [_t(x) for x in (q, k, v, mask)]
    want = jfd.flash_decode(*j, kv_lens=jnp.asarray(lens), block_s=16,
                            interpret=True)
    got = tfd.flash_decode(*t, kv_lens=_t(lens), block_s=16)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, **KERNEL_TOL)
    want = jops.decode_attention_partial(*j, kv_lens=jnp.asarray(lens),
                                         interpret=True)
    got = tfd.flash_decode_merged(*t, kv_lens=_t(lens))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, **KERNEL_TOL)
    assert bool((got[1][1] == tfd.NEG_INF).all())
    assert bool((got[0][1] == 0).all() and (got[2][1] == 0).all())


def test_flash_decode_paged_plain_matches_pallas_at_head_dim_112():
    """``flash_decode_paged`` and its merged form at (112, 1) over a pool
    with sentinel entries, dead blocks and a row with no live token,
    against the Pallas kernel and the JAX paged partial."""
    rng = np.random.default_rng(6)
    B, H, d, NB, bs, nb = 3, 4, 112, 20, 4, 6
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp = rng.standard_normal((NB + 1, bs, H, d)).astype(np.float32)
    vp = rng.standard_normal((NB + 1, bs, H, d)).astype(np.float32)
    table = rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32)
    table[1, 4:] = NB                      # unmapped tail -> sentinel
    mask = rng.random((B, nb * bs)) < 0.5
    mask[1, 16:] = False
    mask[2, :] = False                     # a row with no live token
    live = mask.reshape(B, nb, bs).any(-1)
    live[0, 3] = False                     # live tokens in a dead block
    j = [jnp.asarray(x) for x in (q, kp, vp, table, mask)]
    t = [_t(x) for x in (q, kp, vp, table, mask)]
    want = jfd.flash_decode_paged(*j, block_live=jnp.asarray(live),
                                  interpret=True)
    got = tfd.flash_decode_paged(*t, block_live=_t(live))
    for g, w in zip(got, want):
        _close(g, w, **KERNEL_TOL)
    want = jops.paged_decode_attention_partial(
        *j, block_live=jnp.asarray(live), use_kernel=True, interpret=True)
    got = tfd.flash_decode_paged_merged(*t, block_live=_t(live))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, **KERNEL_TOL)


# ------------------------------------------------------------ the engine
def _port_pam():
    j = make_pam(max_len=MAX_LEN, **PAM_KW)
    return tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval)


def _port_engine(pam=True, **extra):
    _, _, tcf, tparams = _models()
    eng = teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=_port_pam() if pam else None, max_batch=3, max_len=MAX_LEN,
        **extra), device="cpu")
    _record_port(eng)
    return eng


def _jax_engine(pam=True, **extra):
    cfg, params = _models()[:2]
    jeng = make_engine(cfg, params,
                       pam=make_pam(max_len=MAX_LEN, **PAM_KW) if pam
                       else None, max_batch=3, max_len=MAX_LEN, **extra)
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


_JAX_RUNS: dict = {}


def _jax_run(pam, micro, **extra):
    """The JAX engine's streams and recorded engine, once a case."""
    key = (pam, micro, tuple(sorted(extra.items())))
    if key not in _JAX_RUNS:
        jeng = _jax_engine(pam, micro_steps=micro, **extra)
        prompts = _prompts(jeng.cfg.vocab)
        _JAX_RUNS[key] = (_serve(jeng, prompts, 8, JaxRequest), jeng)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("micro", [1, 4])
@pytest.mark.parametrize("pam", [True, False], ids=["dense_pam", "no_pam"])
def test_greedy_streams_and_stepbufs_equal_jax_engine(pam, micro):
    """Five requests through three slots (later admissions reuse a
    finished slot's conv, state and site rows), greedy, one of them to
    exactly ``max_len``: the streams equal the JAX engine's at
    ``micro_steps`` 1 (ROADMAP Queue 3: its pipelined loop is held to
    its own single-step streams), and every dispatch's StepBufs equal
    the JAX engine's at the same ``micro_steps``."""
    peng = _port_engine(pam, micro_steps=micro)
    prompts = _prompts(peng.cfg.vocab)
    got = _serve(peng, prompts, 8, teng.Request)
    want, _ = _jax_run(pam, 1)
    jeng = _jax_run(pam, micro)[1]
    if micro > 1:
        assert peng.decode_device_steps > peng.decode_dispatches
        assert _outputs(jeng) == want
    assert got == want
    _assert_bufs_equal(jeng, peng)
    assert all(len(v) == 8 for v in got.values())
    assert max(int(b["lengths"].max()) for b in peng.log) == MAX_LEN - 1
    if pam:
        assert sum(peng.summary()["tier_reads"]) > 0


def test_sampled_streams_and_stepbufs_equal_jax_engine():
    """The same five requests sampled (temperature 0.8, top-8) on dense
    PAM: streams and every dispatch's StepBufs equal the JAX engine's."""
    peng = _port_engine(**SAMPLED)
    got = _serve(peng, _prompts(peng.cfg.vocab), 8, teng.Request)
    want, jeng = _jax_run(True, 1, **SAMPLED)
    assert got == want
    assert got != _jax_run(True, 1)[0]        # sampling changed a token
    _assert_bufs_equal(jeng, peng)


def test_engine_prefills_at_exact_length():
    """Admission never pads a hybrid prompt (its state would absorb the
    padding), whatever ``bucket_prefill`` says."""
    eng = _port_engine()
    assert [eng._bucket_len(n) for n in (5, 9, 17)] == [5, 9, 17]


# ------------------------------------------------------------ refusals
def test_model_refusals():
    """``forward`` / ``loss_fn`` with ``activation_spec`` raise naming
    ROADMAP Queue 1 item 10 (the hybrid trains since item 17 was ported;
    its sharded training is not); ``true_len`` and paged pools
    raise the reference's ``ValueError``, as the suffix prefill does."""
    _, _, tcf, tparams = _models()
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64),
             "labels": torch.zeros((1, 4), dtype=torch.int64)}
    for fn in (ttf.forward, ttf.loss_fn):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 10"):
            fn(tcf, tparams, batch, activation_spec=("data",))
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="absorbs padding"):
        ttf.prefill(tcf, tparams, toks, 16, true_len=torch.tensor([5]))
    with pytest.raises(ValueError, match="paged KV pools require a GQA"):
        ttf.init_decode_cache(tcf, 2, 32, paged_blocks=4, block_size=8,
                              device="cpu")
    z = torch.zeros((1, 1, 2, 4, 16))
    with pytest.raises(ValueError, match="suffix prefill"):
        ttf.prefill_suffix(tcf, tparams, toks, z, z, 4)


def test_engine_refuses_what_the_reference_refuses():
    """Pools, a ring without pools, and migration (export, import,
    suspend) raise as in the reference."""
    with pytest.raises(ValueError, match="paged KV pools require a GQA"):
        _port_engine(block_size=8)
    with pytest.raises(ValueError, match="hot_window"):
        _port_engine(hot_window=16)
    peng = _port_engine()
    peng.submit(teng.Request(id=0, prompt=_prompts(peng.cfg.vocab)[0],
                             max_new_tokens=8))
    peng.step()
    for fn in (peng.export_request, peng.suspend_request):
        with pytest.raises(ValueError, match="pure GQA decode cache"):
            fn(0)
    with pytest.raises(ValueError, match="pure GQA decode cache"):
        peng.import_request({})


def test_serve_cli_runs_the_hybrid_family():
    """``python -m repro_torch.launch.serve --arch zamba2-7b --reduced
    --device cpu`` serves on dense PAM; ``--block-size`` and
    ``--hot-window`` raise the reference's errors, and ``--layers``
    (which cuts a stacked layer axis) is refused."""
    from repro_torch.launch import serve as tserve
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
            "3", "--prompt-len", "12", "--gen-len", "5", "--max-len", "32",
            "--max-batch", "2"]
    out = tserve.main(args)
    assert out["finished"] == 3 and out["total_tokens"] == 15
    with pytest.raises(ValueError, match="paged KV pools require a GQA"):
        tserve.main(args + ["--block-size", "8"])
    with pytest.raises(ValueError, match="hot_window"):
        tserve.main(args + ["--hot-window", "16"])
    with pytest.raises(SystemExit):
        tserve.main(args + ["--layers", "3"])
