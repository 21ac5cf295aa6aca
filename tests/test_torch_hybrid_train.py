"""The hybrid family's training forward, loss and train step against the
JAX reference, on the CPU.

- ``forward``'s logits and ``loss_fn`` of zamba2-7b's reduced config (2
  groups of 1 Mamba-2 layer around the shared block, a tail of 1; heads
  of 16, d_state 16, SSM head dim 8) and of a narrowed variant that
  carries the pairs the card builds for zamba2-7b: the shared block at 4
  / 4 heads of 112 (``flash_attention``'s (112, 1)) and Mamba-2 at
  ``SSMConfig(d_state=64, head_dim=64)`` (``ssd_scan``'s (64, 64)),
  against the reference's ``forward`` / ``loss_fn``; the port with and
  without ``use_kernel`` (its kernel wrappers run their plain versions
  for CPU tensors), the reference at ``use_kernel=False``.
- every gradient leaf at both configs against ``jax.grad`` of the
  reference loss (``use_kernel=False``: JAX cannot differentiate its
  Pallas kernels), the shared block's summed over its sites.
- a 3-step trajectory of the reference's train step from one state, the
  port's train step taken from the reference's state at each step
  (``bridge.train_state_from_jax``), with remat off and on: losses, grad
  norms, every parameter and AdamW moment.
- the train CLI's ``run`` on the reduced hybrid.

Inputs are fixed-seed numpy draws, fp32. Tolerances, as
``tests/test_torch_train_families.py`` (set there before its first run):
logits, losses, grad norms, gradients and AdamW's moments rtol / atol
1e-4 (a few layers of products summed in another order); parameters
after an AdamW step at most 1e-3 apart and 1e-5 apart on average over
each leaf (Adam's normalised step turns a summation-order difference of
a gradient entry near eps into a parameter difference; a wrong gradient
moves whole leaves by whole steps).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import SSMConfig as JSSMConfig  # noqa: E402
from repro.models.config import get_config, reduced  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ssd_scan as tss  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_MAX_DIFF = 1e-3
PARAM_MEAN_DIFF = 1e-5
STEPS = 3
# the narrowed variant: the card's attention pair (112, 1) and SSD pair
# (64, 64), two SSM heads of one group at d_model 64
D112 = dict(n_heads=4, n_kv_heads=4, d_head=112)
N64 = dict(d_state=64, head_dim=64, expand=2, n_groups=1, conv_kernel=4,
           chunk=16)
CASES = ("reduced", "d112-n64")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(case):
    """(JAX cfg, port cfg): the same replacement of the reduced config on
    both sides."""
    jc, tc = reduced(get_config(ARCH)), tcfg.reduced(tcfg.get_config(ARCH))
    if case == "d112-n64":
        jc = dataclasses.replace(jc, ssm=JSSMConfig(**N64), **D112)
        tc = dataclasses.replace(tc, ssm=tcfg.SSMConfig(**N64), **D112)
    return jc, tc


def _batch(cfg, seed, B=2, S=40):
    """Tokens and labels in the vocabulary, some labels ignored; S spans
    several SSM chunks (16) and ends in a ragged one."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[1, -4:] = -1
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": labels}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _counts():
    return (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches,
            tss.ssd_scan.launches, tss.ssd_scan_bwd.launches)


def test_narrowed_variant_carries_the_card_pairs():
    """The narrowed variant's shared block is the (112, 1) pair of both
    attention directions and its Mamba-2 layers the (64, 64) SSD pair;
    the reduced config's (16, 1) and (16, 8) run only on the CPU."""
    _, tc = _cfgs("d112-n64")
    assert (tc.head_dim, tc.n_heads // tc.n_kv_heads) == (112, 1)
    assert (112, 1) in tfa.BUILT and (112, 1) in tfa.BUILT_BWD
    assert (tc.ssm.d_state, tc.ssm.head_dim) == (64, 64)
    assert (64, 64) in tss.SUPPORTED_NP
    full = tcfg.get_config(ARCH)
    assert (full.head_dim, full.ssm.d_state, full.ssm.head_dim) == (112, 64,
                                                                    64)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_forward_and_loss_match_reference(case, use_kernel):
    """``forward``'s logits (aux 0) and ``loss_fn`` against the
    reference's on the same weights and batch."""
    cfg, tcf = _cfgs(case)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(tcf, _np_tree(params), device="cpu")
    b = _batch(cfg, seed=3)
    jlogits, jaux = jtf.forward(cfg, params, _jb(b), use_kernel=False)
    n0 = _counts()
    with torch.no_grad():
        logits, aux = ttf.forward(tcf, tparams, _tb(b),
                                  use_kernel=use_kernel)
        loss = ttf.loss_fn(tcf, tparams, _tb(b), use_kernel=use_kernel)
    assert _counts() == n0         # CPU tensors: no kernel launch counted
    assert logits.shape == (2, 40, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert float(jaux) == 0.0
    jl = jtf.loss_fn(cfg, params, _jb(b), use_kernel=False)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_jax_grad(case, remat):
    """``loss_fn`` and the gradient of every leaf through the port's
    ``ssd_scan`` and ``flash_attention`` autograd Functions (their plain
    versions here), with and without remat, against ``jax.grad`` of the
    reference loss with ``use_kernel=False``; the shared block's
    gradient sums over its sites."""
    cfg, tcf = _cfgs(case)
    params = jtf.init_params(cfg, jax.random.PRNGKey(1))
    tparams = bridge.params_from_jax(tcf, _np_tree(params), device="cpu")
    b = _batch(cfg, seed=7)
    jl, jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(cfg, p, _jb(b), use_kernel=False))(params)
    tl, tg = tts.build_grad_fn(tcf, tts.TrainConfig(
        use_kernel=True, remat=remat))(tparams, _tb(b))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(leaves(tg)) == len(jleaves)
    for (name, g), w in zip(leaves_with_paths(tg), jleaves):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    # every site's attention and every Mamba-2 layer gets a gradient
    assert float(tg["shared_attn"]["attn"]["wq"].abs().max()) > 0
    for grp in ("mamba_groups", "tail_mamba"):
        w = tg[grp]["ssm"]["in_proj"]
        assert bool((w.flatten(0, w.dim() - 3).abs().amax((1, 2)) > 0).all())


@pytest.mark.parametrize("remat", [False, True])
def test_train_steps_match_reference(remat):
    """Three steps of the reference's train step (``use_kernel=False``)
    from one state, and at each the port's train step (``use_kernel=True``,
    the same remat) from the reference's state before it, carried over by
    ``bridge.train_state_from_jax`` (parameters, AdamW's step counter and
    moments): the loss, the grad norm and every parameter and moment
    after the step. Two free-running trajectories are not held to each
    other: Adam's normalised step turns a gradient entry near zero (an
    embedding entry of a token seen once, about 1e-6) into a step of
    either sign, so parameters a summation order apart after one step
    (1e-4) part by whole steps (1e-2) after the second; the two packages'
    losses on the same parameters agree to 1e-7 at every step."""
    cfg, tcf = _cfgs("reduced")

    def sched(optim):
        return optim.cosine_schedule(1e-2, 2, STEPS)
    jtc = jts.TrainConfig(adamw=joptim.AdamWConfig(lr=sched(joptim)),
                          use_kernel=False, remat=remat)
    jstate = jts.init_train_state(cfg, jtc, jax.random.PRNGKey(0))
    jstep = jax.jit(jts.build_train_step(cfg, jtc))
    step = tts.build_train_step(tcf, tts.TrainConfig(
        adamw=toptim.AdamWConfig(lr=sched(toptim)), use_kernel=True,
        remat=remat))
    got, want = [], []
    for s in range(STEPS):
        b = _batch(cfg, seed=10 + s)
        state = bridge.train_state_from_jax(tcf, _np_tree(jstate),
                                            device="cpu")
        assert int(state.opt.step) == s
        jstate, jm = jstep(jstate, _jb(b))
        state, m = step(state, _tb(b))
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
        got.append((float(m["loss"]), float(m["grad_norm"])))
        assert int(state.opt.step) == s + 1
        for part in ("params", "mu", "nu"):
            mine = state.params if part == "params" else getattr(
                state.opt, part)
            ref = jstate.params if part == "params" else getattr(
                jstate.opt, part)
            jleaves = jax.tree.leaves(ref)
            assert len(leaves(mine)) == len(jleaves)
            for (name, p), w in zip(leaves_with_paths(mine), jleaves):
                diff = np.abs(p.numpy() - np.asarray(w))
                assert p.shape == w.shape, name
                if diff.size and part == "params":
                    assert diff.max() <= PARAM_MAX_DIFF, (s, name, diff.max())
                    assert diff.mean() <= PARAM_MEAN_DIFF, (s, name,
                                                            diff.mean())
                elif diff.size:     # the moments: gradients' EMAs
                    np.testing.assert_allclose(p.numpy(), np.asarray(w),
                                               **TOL, err_msg=name)
    np.testing.assert_allclose(got, want, **TOL)
    assert want[-1][0] != want[0][0]


def test_train_cli_runs_the_reduced_hybrid(capsys):
    """The train CLI trains the reduced hybrid on the CPU through the
    kernel path (their plain versions: no launch counted), and its first
    loss is the loss of the CLI's initial state on its first batch."""
    n0 = _counts()
    out = train_cli.main(["--arch", ARCH, "--reduced", "--steps", "3",
                          "--batch", "2", "--seq", "24", "--device", "cpu"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert _counts() == n0
    assert '"device": "cpu"' in capsys.readouterr().out
    tcf = tcfg.reduced(tcfg.get_config(ARCH))
    tc = train_cli.train_config(steps=3)
    state = tts.init_train_state(tcf, tc, 0, device="cpu")
    from repro_torch.data import SyntheticLM
    b = train_cli.device_batch(SyntheticLM(vocab=tcf.vocab, seq_len=24,
                                           batch=2), 0, 1,
                               torch.device("cpu"))
    with torch.no_grad():
        first = ttf.loss_fn(tcf, state.params, b, use_kernel=True)
    np.testing.assert_allclose(out["losses"][0], float(first), rtol=1e-6)
