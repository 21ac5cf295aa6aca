"""The train step of the vlm, audio and wider dense families against the
JAX reference, on the CPU.

- 3-step train trajectories of reduced internvl2-1b on patch batches (at
  the reduced heads, 4 q / 2 kv of 16, and at internvl2-1b's 14 / 2 heads
  of 64: the (64, 7) pair) and of reduced hubert-xlarge on frame batches
  (the reduced heads, 4 / 2 of 16, and 4 / 4 heads of 80: the (80, 1)
  pair): the losses, the grad norms and every parameter after the last
  step. Both packages start from one state (the reference's
  ``init_train_state``, carried over by ``bridge.train_state_from_jax``)
  and see the same batches; the reference's train step runs with
  ``use_kernel=False`` (JAX cannot differentiate its Pallas kernel), the
  port's with ``use_kernel=True``: its ``flash_attention`` autograd
  Function, whose wrappers run the plain versions for CPU tensors.
- the loss and every gradient leaf against ``jax.grad`` of the reference
  loss at narrowed shapes of the wider dense models: qwen3-14b's group 5
  (10 q / 2 kv heads of 128), deepseek-67b's group 8 (16 / 2 of 128) and
  minicpm-2b's MHA at head dim 64 (4 / 4 of 64), each on its reduced
  config otherwise, through the port's ``flash_attention`` autograd
  Function.
- microbatching of patch and frame batches: ``device_batch``'s split
  ``(M, B/M, ...)`` of every key and ``build_grad_fn``'s accumulation give
  the full batch's loss and gradients.

Inputs are fixed-seed numpy draws, fp32. Tolerances, set before the first
run: losses, grad norms and gradients rtol / atol 1e-4, as
``tests/test_torch_training.py`` (a few layers of products summed in
another order: the port's plain attention is one masked softmax, the
reference's ``chunked_attention`` an online one). Parameters after three
AdamW steps (lr 5e-3, 1e-2, 1e-3): at most 1e-3 apart, a fifth of the
first step, and 1e-5 apart on average over each leaf. Adam's normalised
step turns a gradient entry's summation-order difference into a parameter
difference of up to lr |dg| / (|g| + eps), which stays far below a step
except for entries whose gradient is near eps (1e-8); a wrong gradient
moves whole leaves by whole steps. Microbatched against full-batch loss
and gradients: rtol 1e-6 and rtol 1e-5 / atol 1e-7, as
``tests/test_torch_training.py`` (the same products, summed in two).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import get_config, reduced  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_MAX_DIFF = 1e-3
PARAM_MEAN_DIFF = 1e-5
STEPS = 3
# (arch, the heads of the reduced variant): the family train cases
FAMILY_CASES = {
    "vlm-reduced": ("internvl2-1b", {}),
    "vlm-g7": ("internvl2-1b", dict(n_heads=14, n_kv_heads=2, d_head=64)),
    "audio-reduced": ("hubert-xlarge", {}),
    "audio-d80": ("hubert-xlarge", dict(n_heads=4, n_kv_heads=4, d_head=80)),
}
# the wider dense models' train pairs at narrowed widths
DENSE_CASES = {
    "qwen3-14b": dict(n_heads=10, n_kv_heads=2, d_head=128),
    "deepseek-67b": dict(n_heads=16, n_kv_heads=2, d_head=128),
    "minicpm-2b": dict(n_heads=4, n_kv_heads=4, d_head=64),
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, heads):
    """(JAX cfg, port cfg): the same ``dataclasses.replace`` of the
    reduced config on both sides."""
    return (dataclasses.replace(reduced(get_config(arch)), **heads),
            dataclasses.replace(tcfg.reduced(tcfg.get_config(arch)),
                                **heads))


def _batch(cfg, seed, B=2, S=40):
    """A numpy batch of ``cfg``'s family with some labels ignored: tokens
    (and, for the vlm, ``num_patches`` patches), or ``S`` frames (audio,
    past one 32-row tile); labels in the vocabulary."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[1, -4:] = -1
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
                    (B, S, cfg.frontend_dim)).astype(np.float32),
                "labels": labels}
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": labels}
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


def _schedule(optim):
    return optim.cosine_schedule(1e-2, 2, STEPS)


@pytest.mark.parametrize("case", sorted(FAMILY_CASES))
def test_train_steps_match_reference(case):
    """Three steps of the port's train step (``use_kernel=True``) against
    the reference's (``use_kernel=False``) from one state on the same
    patch or frame batches: losses, grad norms, parameters."""
    cfg, tcf = _cfgs(*FAMILY_CASES[case])
    jtc = jts.TrainConfig(adamw=joptim.AdamWConfig(lr=_schedule(joptim)),
                          use_kernel=False)
    jstate = jts.init_train_state(cfg, jtc, jax.random.PRNGKey(0))
    state = bridge.train_state_from_jax(tcf, _np_tree(jstate), device="cpu")
    jstep = jax.jit(jts.build_train_step(cfg, jtc))
    step = tts.build_train_step(tcf, tts.TrainConfig(
        adamw=toptim.AdamWConfig(lr=_schedule(toptim)), use_kernel=True))
    n0 = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    got, want = [], []
    for s in range(STEPS):
        b = _batch(cfg, seed=10 + s)
        jstate, jm = jstep(jstate, _jb(b))
        state, m = step(state, _tb(b))
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(got, want, **TOL)
    assert want[-1][0] != want[0][0]
    assert int(state.opt.step) == STEPS
    # CPU tensors: the plain versions, no kernel launch counted
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_bwd.launches) == n0
    jleaves = jax.tree.leaves(jstate.params)
    assert len(leaves(state.params)) == len(jleaves)
    for (name, p), w in zip(leaves_with_paths(state.params), jleaves):
        diff = np.abs(p.numpy() - np.asarray(w))
        assert p.shape == w.shape, name
        if diff.size:
            assert diff.max() <= PARAM_MAX_DIFF, (name, diff.max())
            assert diff.mean() <= PARAM_MEAN_DIFF, (name, diff.mean())


@pytest.mark.parametrize("arch", sorted(DENSE_CASES))
def test_dense_loss_and_grads_match_jax_grad(arch):
    """``loss_fn`` and the gradient of every leaf through the port's
    ``flash_attention`` autograd Function, at a (head dim, group) pair of
    the wider dense models, against ``jax.grad`` of the reference loss
    with ``use_kernel=False``."""
    cfg, tcf = _cfgs(arch, DENSE_CASES[arch])
    assert (tcf.head_dim, tcf.n_heads // tcf.n_kv_heads) in tfa.BUILT_BWD
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(tcf, _np_tree(params), device="cpu")
    b = _batch(cfg, seed=7)
    jl, jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(cfg, p, _jb(b), use_kernel=False))(params)
    tl, tg = tts.build_grad_fn(tcf, tts.TrainConfig(use_kernel=True))(
        tparams, _tb(b))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(leaves(tg)) == len(jleaves)
    for (name, g), w in zip(leaves_with_paths(tg), jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    # the attention's projections get a gradient through the kernel path
    assert float(tg["layers"]["attn"]["wq"].abs().max()) > 0


@pytest.mark.parametrize("case", ["vlm-g7", "audio-d80"])
def test_microbatches_split_patches_and_frames(case):
    """Two microbatches of a patch or frame batch (equal label counts, so
    the mean of means is the mean), split as the train CLI's
    ``device_batch`` splits every key, give the full batch's loss and
    gradients."""
    from repro_torch.models import transformer as ttf
    _, tcf = _cfgs(*FAMILY_CASES[case])
    params = ttf.init_params(tcf, 0, device="cpu")
    b = _batch(tcf, seed=5, B=4, S=24)
    b["labels"] = np.abs(b["labels"])
    full = _tb(b)
    mb = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in full.items()}
    l_full, g_full = tts.build_grad_fn(tcf, tts.TrainConfig(
        use_kernel=True))(params, full)
    l_mb, g_mb = tts.build_grad_fn(tcf, tts.TrainConfig(
        use_kernel=True, microbatches=2))(params, mb)
    np.testing.assert_allclose(float(l_mb), float(l_full), rtol=1e-6)
    for (name, a), c in zip(leaves_with_paths(g_full), leaves(g_mb)):
        assert c.dtype == torch.float32
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
