"""The port's Mamba-2 (SSM) family against the JAX reference on reduced
``mamba2-780m``: the block functions (``ssm_forward`` with and without
the kernel, ``ssm_prefill`` and its cache, ``ssm_decode``), the model's
parameter layout, logits, loss and gradients, a 5-step AdamW trajectory,
prefill and decode, teacher-forced decode against the parallel forward,
checkpoints across the packages, the serving engine's token streams and
the CLIs.

Weights come from ``conftest.build_model`` through ``repro_torch.bridge``;
every other input is drawn from a seeded numpy generator. fp32
throughout. Tolerances: logits, block outputs, losses and gradients 1e-4
(a few layers of products summed in another order; the port's
``use_kernel=True`` runs the plain versions of the ``ssd_scan`` kernels,
the reference's the Pallas kernel in interpret mode); recurrent state
1e-5; train-trajectory losses 1e-5 relative; token streams exact.
JAX cannot differentiate its own Pallas ``ssd_scan``, so gradients are
held to ``jax.grad`` with ``use_kernel=False``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import build_model, make_engine, make_pam  # noqa: E402

from repro.checkpoint import restore_pytree as j_restore  # noqa: E402
from repro.checkpoint import save_pytree as j_save  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import restore_pytree, save_pytree  # noqa: E402
from repro_torch.kernels import ssd_scan as tss  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

torch.set_num_threads(2)
ARCH = "mamba2-780m"
TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 40          # S > 2 chunks of the reduced chunk (16), ragged


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def model():
    cfg, params = build_model(ARCH)
    tcf = tcfg.reduced(tcfg.get_config(ARCH))
    return cfg, params, tcf, bridge.params_from_jax(tcf, _np(params),
                                                    device="cpu")


def _batch(vocab, seed=0, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": toks, "labels": labels}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ------------------------------------------------------------ config, init
def test_config_and_init_layout_match_reference(model):
    """Same config fields; the port's own init has the reference's tree:
    keys, shapes and dtypes (fp32 dt_bias / a_log / d_skip in a bf16
    model) and the same leaf order."""
    cfg, params, tcf, tparams = model
    for f in dataclasses.fields(tcf):
        assert getattr(tcf, f.name) == getattr(cfg, f.name) or \
            f.name == "ssm", f.name
    assert dataclasses.asdict(tcf.ssm) == dataclasses.asdict(cfg.ssm)
    full = tcfg.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.vocab) == (48, 1536, 50280)
    assert tssm._dims(full.d_model, full.ssm) == (3072, 48, 3328)
    bf = dataclasses.replace(tcf, dtype="bfloat16")
    jp = jtf.init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                         jax.random.PRNGKey(0))
    tp = ttf.init_params(bf, 0, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = leaves_with_paths(tp)
    assert len(jl) == len(tl)
    for (jpath, jleaf), (tpath, tleaf) in zip(jl, tl):
        assert tpath.split(".")[-1] == jpath[-1].key
        assert tuple(tleaf.shape) == jleaf.shape, tpath
        assert str(tleaf.dtype).replace("torch.", "") == str(jleaf.dtype)
    s = tp["layers"]["ssm"]
    np.testing.assert_allclose(s["a_log"].numpy(),
                               np.asarray(jp["layers"]["ssm"]["a_log"]))
    assert tp["lm_head"].shape == (tcf.d_model, tcf.vocab)


# ------------------------------------------------------------ block
def _layer(params, i=0):
    lyr = params["layers"]["ssm"]
    return {k: v[i] for k, v in lyr.items()}


def test_ssm_block_functions_match_reference(model):
    """ssm_forward (plain chunked and the kernel path), ssm_prefill (out,
    conv tail, final state) and three ssm_decode steps on layer 0."""
    cfg, params, tcf, tparams = model
    jp = jssm.SSMParams(**_layer(params))
    tp = tssm.SSMParams(**_layer(tparams))
    x = np.random.default_rng(1).standard_normal(
        (B, S, tcf.d_model)).astype(np.float32)
    kw = dict(rms_eps=cfg.rms_eps)
    for use_kernel in (False, True):
        want = jssm.ssm_forward(jp, jnp.asarray(x), cfg.ssm,
                                use_kernel=use_kernel, **kw)
        got = tssm.ssm_forward(tp, torch.from_numpy(x), tcf.ssm,
                               use_kernel=use_kernel, **kw)
        _close(got, want)
    jo, jc = jssm.ssm_prefill(jp, jnp.asarray(x), cfg.ssm, **kw)
    to, tc = tssm.ssm_prefill(tp, torch.from_numpy(x), tcf.ssm, **kw)
    _close(to, jo)
    _close(tc.conv, jc.conv, **STATE_TOL)
    _close(tc.state, jc.state, **STATE_TOL)
    for t in range(3):
        xt = np.random.default_rng(10 + t).standard_normal(
            (B, tcf.d_model)).astype(np.float32)
        jo, jc = jssm.ssm_decode(jp, jnp.asarray(xt), jc, cfg.ssm, **kw)
        to, tc = tssm.ssm_decode(tp, torch.from_numpy(xt), tc, tcf.ssm,
                                 **kw)
        _close(to, jo)
        _close(tc.conv, jc.conv, **STATE_TOL)
        _close(tc.state, jc.state, **STATE_TOL)


def test_short_prompt_conv_tail_is_left_padded(model):
    """A prompt shorter than the conv window leaves zeros in front of the
    cached conv inputs, as in the reference."""
    cfg, params, tcf, tparams = model
    x = np.random.default_rng(2).standard_normal(
        (1, 2, tcf.d_model)).astype(np.float32)
    _, jc = jssm.ssm_prefill(jssm.SSMParams(**_layer(params)),
                             jnp.asarray(x), cfg.ssm, rms_eps=cfg.rms_eps)
    _, tc = tssm.ssm_prefill(tssm.SSMParams(**_layer(tparams)),
                             torch.from_numpy(x), tcf.ssm,
                             rms_eps=cfg.rms_eps)
    assert tc.conv.shape == (1, tcf.ssm.conv_kernel - 1,
                             tssm._dims(tcf.d_model, tcf.ssm)[2])
    _close(tc.conv, jc.conv, **STATE_TOL)
    assert float(tc.conv[0, 0].abs().max()) == 0.0


# ------------------------------------------------------------ model
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_match_reference(model, use_kernel):
    """The port's logits against ``tf.forward`` with the same flag (the
    Pallas ``ssd_scan`` in interpret mode when True)."""
    cfg, params, tcf, tparams = model
    b = _batch(tcf.vocab)
    want, _ = jtf.forward(cfg, params, _jb(b), use_kernel=use_kernel)
    got, aux = ttf.forward(tcf, tparams, _tb(b), use_kernel=use_kernel)
    assert got.shape == (B, S, tcf.vocab) and float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_loss_and_grads_match_jax_grad(model, use_kernel):
    """The port's gradient, through ``SSDScanFn`` (the plain version of
    the backward kernels) or through autograd of ``ssd_chunked``, against
    ``jax.grad`` of the reference loss without the kernel."""
    cfg, params, tcf, tparams = model
    b = _batch(tcf.vocab, seed=1)
    b["labels"][1, :5] = -1
    jl, jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(cfg, p, _jb(b), use_kernel=False))(params)
    n0 = tss.ssd_scan.launches
    tl, tg = tts.build_grad_fn(tcf, tts.TrainConfig(use_kernel=use_kernel))(
        tparams, _tb(b))
    assert tss.ssd_scan.launches == n0      # CPU: the plain versions
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(leaves(tg)) == len(jleaves)
    for (name, g), w in zip(leaves_with_paths(tg), jleaves):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_remat_gives_the_same_grads(model):
    _, _, tcf, tparams = model
    b = _tb(_batch(tcf.vocab, seed=2))
    tc = tts.TrainConfig(use_kernel=True)
    l0, g0 = tts.build_grad_fn(tcf, tc)(tparams, b)
    l1, g1 = tts.build_grad_fn(tcf, dataclasses.replace(tc, remat=True))(
        tparams, b)
    assert float(l0) == float(l1)
    for a, c in zip(leaves(g0), leaves(g1)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_train_steps_match_reference():
    """Five AdamW steps from the reference's initial state (cosine
    schedule), the port with the kernel path, the reference without (it
    cannot differentiate its kernel): losses at 1e-5 relative, grad norms
    at 1e-4."""
    cfg = build_model(ARCH)[0]
    tcf = tcfg.reduced(tcfg.get_config(ARCH))
    steps = 5
    jc = jts.TrainConfig(adamw=joptim.AdamWConfig(
        lr=joptim.cosine_schedule(3e-3, 2, steps)))
    state = jts.init_train_state(cfg, jc, jax.random.PRNGKey(0))
    tstate = bridge.train_state_from_jax(tcf, _np(state), device="cpu")
    jstep = jax.jit(jts.build_train_step(cfg, jc))
    tstep = tts.build_train_step(tcf, tts.TrainConfig(
        adamw=toptim.AdamWConfig(lr=toptim.cosine_schedule(3e-3, 2, steps)),
        use_kernel=True))
    ds = JSyntheticLM(vocab=cfg.vocab, seq_len=24, batch=4, seed=3)
    jl, tl, jn, tn = [], [], [], []
    for s in range(steps):
        b = ds.batch_at(s)
        state, m = jstep(state, _jb(b))
        tstate, tm = tstep(tstate, _tb(b))
        jl.append(float(m["loss"]))
        jn.append(float(m["grad_norm"]))
        tl.append(float(tm["loss"]))
        tn.append(float(tm["grad_norm"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)
    assert tl[-1] < tl[0]
    for p, w in zip(leaves(tstate.params), jax.tree.leaves(state.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), **TOL)


# ------------------------------------------------------------ prefill, decode
def test_prefill_and_decode_match_reference(model):
    """Exact-length prefill (logits, conv, state, lengths), then three
    greedy decode steps from the bridged reference cache."""
    cfg, params, tcf, tparams = model
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (B, 21)).astype(
        np.int32)
    jl, jc = jtf.prefill(cfg, params, jnp.asarray(toks), 32)
    tl, tc = ttf.prefill(tcf, tparams, torch.from_numpy(toks), 32)
    _close(tl, jl)
    _close(tc.conv, jc.conv, **STATE_TOL)
    _close(tc.state, jc.state, **STATE_TOL)
    assert tc.k.numel() == 0 and tc.pk.numel() == 0
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    tc = bridge.cache_from_jax(jc, device="cpu")
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    tt = torch.from_numpy(np.array(jt))
    for _ in range(3):
        jl, jc, js = jtf.decode_step(cfg, params, jt, jc)
        tl, tc, ts = ttf.decode_step(tcf, tparams, tt, tc)
        assert js is None and ts is None
        _close(tl, jl)
        _close(tc.conv, jc.conv, **STATE_TOL)
        _close(tc.state, jc.state, **STATE_TOL)
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths))
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_teacher_forced_decode_equals_parallel_forward(model):
    """The recurrent path reproduces the train forward's logits (the
    counterpart of test_arch_smoke's ``test_decode_matches_prefill_logits``,
    here at 1e-4 and with a kernel-path forward)."""
    _, _, tcf, tparams = model
    toks = torch.from_numpy(_batch(tcf.vocab, seed=4, batch=1, seq=20)[
        "tokens"])
    par, _ = ttf.forward(tcf, tparams, {"tokens": toks}, use_kernel=True)
    cache = ttf.init_decode_cache(tcf, 1, 21, device="cpu")
    seq = []
    for t in range(toks.shape[1]):
        lg, cache, _ = ttf.decode_step(tcf, tparams, toks[:, t], cache)
        seq.append(lg)
    _close(torch.stack(seq, dim=1), par.numpy())


def test_ssm_refuses_padding_pools_and_ring(model):
    _, _, tcf, tparams = model
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="absorbs padding"):
        ttf.prefill(tcf, tparams, toks, 16, true_len=torch.tensor([5]))
    with pytest.raises(ValueError, match="paged KV pools"):
        ttf.init_decode_cache(tcf, 1, 16, paged_blocks=4, block_size=4,
                              device="cpu")
    pam = tpm.PAMManagerConfig(max_tokens=64, hot_capacity=8,
                               warm_capacity=8)
    with pytest.raises(ValueError, match="paged KV pools"):
        teng.ServingEngine(tcf, tparams, teng.ServingConfig(
            max_len=64, block_size=8, pam=pam), device="cpu")
    with pytest.raises(ValueError, match="hot_window"):
        teng.ServingEngine(tcf, tparams, teng.ServingConfig(
            max_len=64, hot_window=16, pam=pam), device="cpu")


# ------------------------------------------------------------ checkpoints
def test_checkpoints_cross_between_packages(tmp_path):
    """The SSM TrainState (bf16 leaves beside fp32 dt_bias / a_log /
    d_skip) saved by the reference restores into the port's and back,
    in the same leaf order."""
    cfg = dataclasses.replace(build_model(ARCH)[0], dtype="bfloat16")
    tcf = dataclasses.replace(tcfg.reduced(tcfg.get_config(ARCH)),
                              dtype="bfloat16")
    jstate = jts.init_train_state(cfg, jts.TrainConfig(),
                                  jax.random.PRNGKey(1))
    jstate = jstate._replace(opt=jstate.opt._replace(step=jnp.int32(3)))
    j_save(jstate, str(tmp_path / "j"))
    template = tts.init_train_state(tcf, tts.TrainConfig(), 0, device="cpu")
    got = restore_pytree(template, str(tmp_path / "j"))
    want = bridge.train_state_from_jax(tcf, _np(jstate), device="cpu")
    assert int(got.opt.step) == 3
    assert got.params["layers"]["ssm"]["a_log"].dtype == torch.float32
    assert got.params["layers"]["ssm"]["in_proj"].dtype == torch.bfloat16
    for a, w in zip(leaves(got), leaves(want)):
        assert a.dtype == w.dtype and torch.equal(a, w)
    save_pytree(got, str(tmp_path / "t"))
    back = j_restore(jstate, str(tmp_path / "t"))
    for a, w in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(w, np.float32))


# ------------------------------------------------------------ engine
PLENS = (9, 20, 9, 14, 5)     # mixed exact lengths; two share one
MAX_NEW = 10
ENGINE_KW = dict(max_batch=3, max_len=48)
PAM_KW = dict(hot=8, warm=8, compression=2)


def _reqs(cls, vocab):
    rng = np.random.default_rng(7)
    return [cls(id=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=MAX_NEW) for i, n in enumerate(PLENS)]


def _streams(eng, reqs):
    for r in reqs:
        eng.submit(r)
    summ = eng.run()
    return {r.id: list(eng.requests[r.id].outputs) for r in reqs}, summ


@pytest.fixture(scope="module")
def jax_streams(model):
    cfg, params, _, _ = model
    eng = make_engine(cfg, params, pam=make_pam(
        max_len=ENGINE_KW["max_len"], **PAM_KW), **ENGINE_KW)
    return _streams(eng, _reqs(JRequest, cfg.vocab))[0]


@pytest.mark.parametrize("micro", [1, 4])
def test_engine_streams_equal_jax_engine(model, jax_streams, micro):
    """PAM on, dense cache, five prompts of four exact lengths through
    three slots (so later admissions reuse a finished slot's conv and
    state rows), greedy."""
    _, _, tcf, tparams = model
    j = make_pam(max_len=ENGINE_KW["max_len"], **PAM_KW)
    pam = tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval)
    eng = teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=pam, micro_steps=micro, **ENGINE_KW), device="cpu")
    got, summ = _streams(eng, _reqs(teng.Request, tcf.vocab))
    assert got == jax_streams
    assert summ["finished"] == len(PLENS)
    assert summ["total_tokens"] == len(PLENS) * MAX_NEW
    assert sum(summ["tier_reads"]) > 0       # recency scores drive PAM


def test_engine_prefills_each_exact_length(model):
    _, _, tcf, tparams = model
    eng = teng.ServingEngine(tcf, tparams, teng.ServingConfig(**ENGINE_KW),
                             device="cpu")
    assert [eng._bucket_len(n) for n in (5, 9, 17)] == [5, 9, 17]
    _, summ = _streams(eng, _reqs(teng.Request, tcf.vocab))
    assert summ["finished"] == len(PLENS)


# ------------------------------------------------------------ CLIs
def test_train_and_serve_clis_run_mamba_on_cpu(capsys):
    out = train_cli.main(["--arch", ARCH, "--reduced", "--steps", "3",
                          "--batch", "2", "--seq", "24", "--device", "cpu"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    summ = serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--requests", "3", "--prompt-len", "12",
                           "--gen-len", "4", "--max-len", "64",
                           "--max-batch", "2"])
    assert summ["finished"] == 3 and summ["total_tokens"] == 12
    assert '"device": "cpu"' in capsys.readouterr().out
