"""The port's training path against the JAX reference on the CPU: the
training forward and loss, gradients, AdamW and its schedules, the train
step (plain, microbatched, compressed), the data pipeline, checkpoints
and the train CLI.

Weights and optimizer state cross through ``repro_torch.bridge``; batches
come from the (numpy) ``SyntheticLM`` of each package, which are
bit-equal. fp32 throughout, on reduced configs. Tolerances: logits,
losses, gradients and grad norms 1e-4 (a few layers of products summed
in another order; the port's ``use_kernel=True`` runs the plain version
of the attention kernels, a monolithic masked softmax, against the
reference's tiled Pallas kernel or ``chunked_attention``); optimizer
states 1e-5; int8 compression within one quantisation step.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_pytree as j_restore  # noqa: E402
from repro.checkpoint import save_pytree as j_save  # noqa: E402
from repro.data import FileCorpus as JFileCorpus  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import get_config as j_get_config  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, restore_pytree, save_pytree)
from repro_torch.data import (  # noqa: E402
    FileCorpus, SyntheticLM, shard_for_rank)
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
ARCHS = ("qwen3-0.6b", "pam-llama-7b")
B, S = 4, 24


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(vocab, seed=0, batch=B, seq=S):
    return SyntheticLM(vocab=vocab, seq_len=seq, batch=batch,
                       seed=seed).batch_at(0)


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = j_reduced(j_get_config(request.param))
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tcf = tcfg.reduced(tcfg.get_config(request.param))
    return cfg, params, tcf, bridge.params_from_jax(tcf, _np(params),
                                                    device="cpu")


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_match_reference(model, use_kernel):
    cfg, params, tcf, tparams = model
    b = _batch(tcf.vocab)
    want, _ = jtf.forward(cfg, params, _jb(b), use_kernel=use_kernel)
    got, aux = ttf.forward(tcf, tparams, _tb(b), use_kernel=use_kernel)
    assert got.shape == (B, S, tcf.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_loss_and_grads_match_jax_grad(model, use_kernel):
    """The port's gradient, with the attention kernels' autograd Function
    or with differentiable ``chunked_attention``, against ``jax.grad`` of
    the reference loss without the kernel (which JAX cannot
    differentiate)."""
    cfg, params, tcf, tparams = model
    b = _batch(tcf.vocab, seed=1)
    b["labels"][1, :5] = -1                       # ignored positions
    jl, jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(cfg, p, _jb(b), use_kernel=False))(params)
    grad_fn = tts.build_grad_fn(tcf, tts.TrainConfig(use_kernel=use_kernel))
    tl, tg = grad_fn(tparams, _tb(b))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(leaves(tg)) == len(jleaves)
    for g, w in zip(leaves(tg), jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert not any(p.requires_grad for p in leaves(tparams))


def test_remat_gives_the_same_grads(model):
    _, _, tcf, tparams = model
    b = _tb(_batch(tcf.vocab, seed=2))
    l0, g0 = tts.build_grad_fn(tcf, tts.TrainConfig(use_kernel=True))(
        tparams, b)
    l1, g1 = tts.build_grad_fn(tcf, tts.TrainConfig(use_kernel=True,
                                                    remat=True))(tparams, b)
    assert float(l0) == float(l1)
    for a, c in zip(leaves(g0), leaves(g1)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_activation_spec_is_not_ported(model):
    _, _, tcf, tparams = model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttf.forward(tcf, tparams, _tb(_batch(tcf.vocab)),
                    activation_spec=("data",))


# ---------------------------------------------------------------- AdamW
def _opt_case(seed):
    rng = np.random.default_rng(seed)
    p = {"a": rng.standard_normal((5, 3)).astype(np.float32),
         "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}
    gs = [{"a": rng.standard_normal((5, 3)).astype(np.float32) * s,
           "b": {"c": rng.standard_normal((7,)).astype(np.float32) * s}}
          for s in (0.1, 3.0, 0.5)]          # the middle step is clipped
    return p, gs


@pytest.mark.parametrize("lr", ["cosine", "wsd", 0.05])
def test_adamw_update_matches_reference(lr):
    p, gs = _opt_case(0)
    jlr = {"cosine": joptim.cosine_schedule(0.1, 2, 10),
           "wsd": joptim.wsd_schedule(0.1, 1, 1, 3)}.get(lr, lr)
    tlr = {"cosine": toptim.cosine_schedule(0.1, 2, 10),
           "wsd": toptim.wsd_schedule(0.1, 1, 1, 3)}.get(lr, lr)
    jcfg = joptim.AdamWConfig(lr=jlr, grad_clip=1.0)
    tcfg_ = toptim.AdamWConfig(lr=tlr, grad_clip=1.0)
    jp = jax.tree.map(jnp.asarray, p)
    tp = tree_map(torch.from_numpy, p)
    js, ts = joptim.adamw_init(jp), toptim.adamw_init(tp)
    for g in gs:
        jp, js, jn = joptim.adamw_update(jcfg, jax.tree.map(jnp.asarray, g),
                                         js, jp)
        tp, ts, tn = toptim.adamw_update(
            tcfg_, tree_map(torch.from_numpy, g), ts, tp)
        np.testing.assert_allclose(float(tn), float(jn), **STATE_TOL)
        for a, w in zip(leaves((tp, ts.mu, ts.nu)),
                        jax.tree.leaves((jp, js.mu, js.nu))):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **STATE_TOL)
    assert int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32


def test_adamw_keeps_bf16_params_and_fp32_moments():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = toptim.adamw_init(p)
    new, st, _ = toptim.adamw_update(
        toptim.AdamWConfig(lr=0.1), {"w": torch.full((4,), 0.5,
                                                     dtype=torch.bfloat16)},
        st, p)
    assert new["w"].dtype == torch.bfloat16
    assert st.mu["w"].dtype == st.nu["w"].dtype == torch.float32
    assert float(new["w"][0]) < 1.0


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_match_reference(name):
    if name == "cosine":
        j, t = (m.cosine_schedule(1e-2, warmup=10, total=60)
                for m in (joptim, toptim))
    else:
        j, t = (m.wsd_schedule(1e-2, warmup=10, stable=20, decay=15)
                for m in (joptim, toptim))
    steps = np.arange(0, 70, dtype=np.int32)
    want = [float(j(jnp.int32(s))) for s in steps]
    got = [float(t(torch.tensor(s, dtype=torch.int32))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------ compression
def test_int8_compression_matches_reference():
    g = np.random.default_rng(4).standard_normal((257,)).astype(np.float32)
    jq, js = jts.compress_int8(jnp.asarray(g))
    tq, tsc = tts.compress_int8(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_allclose(float(tsc), float(js), rtol=1e-7)
    # rounding ties may fall either way: within one quantisation step
    assert np.max(np.abs(tq.numpy().astype(int) - np.asarray(jq, int))) <= 1
    deq = tts.decompress_int8(tq, tsc).numpy()
    assert np.max(np.abs(deq - g)) <= float(tsc) / 2 + 1e-7


def test_error_feedback_matches_reference_and_keeps_signal():
    g = {"w": np.full((64,), 0.013, np.float32),
         "v": np.random.default_rng(5).standard_normal(9).astype(np.float32)}
    jg = jax.tree.map(jnp.asarray, g)
    tg = tree_map(torch.from_numpy, g)
    jef = jax.tree.map(jnp.zeros_like, jg)
    tef = tree_map(torch.zeros_like, tg)
    total = torch.zeros(64)
    for _ in range(50):
        jdq, jef = jts._compress_with_feedback(jg, jef)
        tdq, tef = tts.compress_with_feedback(tg, tef)
        for k in g:
            step = float(np.max(np.abs(g[k]) + 1)) / 127
            np.testing.assert_allclose(tdq[k].numpy(), np.asarray(jdq[k]),
                                       rtol=0, atol=step)
        total += tdq["w"]
    np.testing.assert_allclose((total / 50).numpy(), np.full(64, 0.013),
                               rtol=0.02)


# ------------------------------------------------------------ train step
_JAX_RUNS: dict = {}


def _jax_trajectory(microbatches, steps=5):
    """Losses and grad norms of the reference's train step, its initial
    state, and the batches it saw (cached per process)."""
    if microbatches not in _JAX_RUNS:
        cfg = j_reduced(j_get_config("qwen3-0.6b"))
        tc = jts.TrainConfig(adamw=joptim.AdamWConfig(
            lr=joptim.cosine_schedule(1e-2, 2, steps)),
            microbatches=microbatches)
        state = jts.init_train_state(cfg, tc, jax.random.PRNGKey(0))
        state0 = _np(state)
        step_fn = jax.jit(jts.build_train_step(cfg, tc))
        ds = JSyntheticLM(vocab=cfg.vocab, seq_len=16, batch=8, seed=3)
        batches, losses, norms = [], [], []
        for s in range(steps):
            b = ds.batch_at(s)
            if microbatches > 1:
                b = {k: v.reshape((microbatches, -1) + v.shape[1:])
                     for k, v in b.items()}
            batches.append(b)
            state, m = step_fn(state, _jb(b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        _JAX_RUNS[microbatches] = (state0, batches, losses, norms)
    return _JAX_RUNS[microbatches]


@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_train_steps_match_reference(microbatches, use_kernel):
    state0, batches, losses, norms = _jax_trajectory(microbatches)
    tcf = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    tc = tts.TrainConfig(adamw=toptim.AdamWConfig(
        lr=toptim.cosine_schedule(1e-2, 2, len(batches))),
        microbatches=microbatches, use_kernel=use_kernel)
    state = bridge.train_state_from_jax(tcf, state0, device="cpu")
    step_fn = tts.build_train_step(tcf, tc)
    got_l, got_n = [], []
    for b in batches:
        state, m = step_fn(state, _tb(b))
        got_l.append(float(m["loss"]))
        got_n.append(float(m["grad_norm"]))
    np.testing.assert_allclose(got_l, losses, **TOL)
    np.testing.assert_allclose(got_n, norms, **TOL)
    assert int(state.opt.step) == len(batches)


def test_microbatched_grads_equal_full_batch():
    """The accumulation algebra: M microbatches of B/M (equal label
    counts, so the mean of means is the mean) give the full batch's loss
    and gradients."""
    tcf = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    params = ttf.init_params(tcf, 0, device="cpu")
    b = _tb(_batch(tcf.vocab, seed=3, batch=8, seq=16))
    mb = {k: v.reshape((4, 2) + v.shape[1:]) for k, v in b.items()}
    l_full, g_full = tts.build_grad_fn(tcf, tts.TrainConfig())(params, b)
    l_mb, g_mb = tts.build_grad_fn(tcf, tts.TrainConfig(microbatches=4))(
        params, mb)
    np.testing.assert_allclose(float(l_mb), float(l_full), rtol=1e-6)
    for a, c in zip(leaves(g_full), leaves(g_mb)):
        assert c.dtype == torch.float32
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_compressed_train_step_tracks_reference():
    """``compress_grads``: the error-feedback tree crosses the bridge, the
    first step's loss and grad norm match the reference's, and each new
    residual is within one quantisation step of the reference's (a
    rounding tie may fall the other way)."""
    cfg = j_reduced(j_get_config("qwen3-0.6b"))
    tcf = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    jtc = jts.TrainConfig(compress_grads=True)
    jstate = jts.init_train_state(cfg, jtc, jax.random.PRNGKey(0))
    b = _batch(tcf.vocab, seed=6, batch=4, seq=16)
    state = bridge.train_state_from_jax(tcf, _np(jstate), device="cpu")
    assert state.error_feedback is not None
    jstate, jm = jax.jit(jts.build_train_step(cfg, jtc))(jstate, _jb(b))
    tc = tts.TrainConfig(compress_grads=True)
    _, grads = tts.build_grad_fn(tcf, tc)(state.params, _tb(b))
    state, m = tts.build_train_step(tcf, tc)(state, _tb(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               **TOL)
    for g, e, w in zip(leaves(grads), leaves(state.error_feedback),
                       jax.tree.leaves(jstate.error_feedback)):
        step = max(float(g.abs().max()), 1e-12) / 127    # one int8 step
        diff = np.abs(e.numpy() - np.asarray(w))
        assert diff.max() <= step * 1.001
        assert np.mean(diff <= step * 1e-2) >= 0.99


# ------------------------------------------------------------------ data
def test_synthetic_lm_bit_equal_to_reference():
    for step, rank in ((0, 0), (5, 2), (9, 1)):
        a = SyntheticLM(vocab=5000, seq_len=33, batch=3, seed=7).batch_at(
            step, rank)
        b = JSyntheticLM(vocab=5000, seq_len=33, batch=3, seed=7).batch_at(
            step, rank)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert a["labels"][0, -1] == -1


def test_file_corpus_and_sharding_match_reference(tmp_path):
    path = str(tmp_path / "toks.u16.bin")
    np.arange(1000, dtype=np.uint16).tofile(path)
    for step, rank in ((0, 0), (3, 1)):
        a = FileCorpus(path, seq_len=16, batch=4).batch_at(step, rank, 2)
        b = JFileCorpus(path, seq_len=16, batch=4).batch_at(step, rank, 2)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["labels"], a["tokens"] + 1)
    assert shard_for_rank(32, 3, 4) == (24, 8)


# ------------------------------------------------------------ checkpoints
def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "s": torch.tensor(3, dtype=torch.int32)}
    d = str(tmp_path / "ck")
    save_pytree(tree, d)
    back = restore_pytree(tree_map(torch.zeros_like, tree), d)
    for x, y in zip(leaves(tree), leaves(back)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)
    assert not os.path.exists(d + ".tmp")


def test_checkpoint_manager_retention_and_crash_recovery(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    os.makedirs(str(tmp_path / "step_00000099.tmp"))
    assert mgr.latest_step() is None
    tree = {"w": torch.zeros(3)}
    for s in (10, 20, 30):
        mgr.save(s, {"w": tree["w"] + s})
    assert mgr.steps() == [20, 30] and mgr.latest_step() == 30
    assert not os.path.exists(str(tmp_path / "step_00000099.tmp"))
    step, restored = mgr.restore_latest(tree)
    assert step == 30
    np.testing.assert_allclose(restored["w"].numpy(), 30.0)


def test_checkpoints_cross_between_packages(tmp_path):
    """Same directory format and leaf order: a reference TrainState
    checkpoint restores into the port's TrainState, and back."""
    cfg = j_reduced(j_get_config("qwen3-0.6b"))
    tcf = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    jstate = jts.init_train_state(cfg, jts.TrainConfig(),
                                  jax.random.PRNGKey(1))
    jstate = jstate._replace(opt=jstate.opt._replace(step=jnp.int32(7)))
    j_save(jstate, str(tmp_path / "j"))
    template = tts.init_train_state(tcf, tts.TrainConfig(), 0,
                                    device="cpu")
    got = restore_pytree(template, str(tmp_path / "j"))
    want = bridge.train_state_from_jax(tcf, _np(jstate), device="cpu")
    assert int(got.opt.step) == 7
    for a, w in zip(leaves(got), leaves(want)):
        assert torch.equal(a, w)
    save_pytree(got, str(tmp_path / "t"))
    back = j_restore(jstate, str(tmp_path / "t"))
    for a, w in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))


def test_train_loss_decreases_and_resumes(tmp_path):
    """Port of the reference's end-to-end test: the loss falls, and a run
    resumed from a mid-run checkpoint reproduces the uninterrupted
    trajectory."""
    tcf = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    tc = tts.TrainConfig(adamw=toptim.AdamWConfig(lr=1e-2,
                                                  weight_decay=0.0),
                         use_kernel=True)
    ds = SyntheticLM(vocab=tcf.vocab, seq_len=32, batch=8, seed=1)
    step_fn = tts.build_train_step(tcf, tc)
    state = tts.init_train_state(tcf, tc, 0, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=1)
    losses = []
    for s in range(40):
        state, m = step_fn(state, _tb(ds.batch_at(s)))
        losses.append(float(m["loss"]))
        if s == 19:
            mgr.save(20, state)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
    step0, resumed = mgr.restore_latest(state)
    assert step0 == 20
    relosses = []
    for s in range(20, 40):
        resumed, m = step_fn(resumed, _tb(ds.batch_at(s)))
        relosses.append(float(m["loss"]))
    np.testing.assert_allclose(relosses, losses[20:], rtol=1e-6)


# ------------------------------------------------------------------- CLI
def test_train_cli_on_cpu_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--reduced", "--batch", "4", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
            "--microbatches", "2", "--wsd"]
    n0 = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    first = train_cli.main(argv + ["--steps", "12"])
    assert first["start_step"] == 0 and len(first["losses"]) == 12
    assert all(np.isfinite(first["losses"]))
    assert CheckpointManager(str(tmp_path)).latest_step() == 10
    again = train_cli.main(argv + ["--steps", "12"])
    assert again["start_step"] == 10
    np.testing.assert_allclose(again["losses"], first["losses"][10:],
                               rtol=1e-6)
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_bwd.launches) == n0
    out = capsys.readouterr().out
    assert "[resume] from step 10" in out and '"device": "cpu"' in out


def test_train_cli_uses_the_kernel_path():
    """The CLI trains through the attention kernels (their plain versions
    on the CPU), unlike ``TrainConfig``'s reference default."""
    assert train_cli.train_config(steps=10).use_kernel
    assert not tts.TrainConfig().use_kernel
