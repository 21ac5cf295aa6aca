"""The mixture-of-experts families' training forward, loss and train step
against the JAX reference, on the CPU.

Three configs, each the same replacement on both sides:

- ``qwen3-moe``: reduced qwen3-moe-235b-a22b (2 layers, 4 / 2 heads of
  16, 4 experts top-2, capacity 1.25);
- ``deepseek-v2-lite``: reduced deepseek-v2-lite-16b (MLA with a latent
  rank 32, 4 experts top-2 and one shared expert); MLA runs the plain
  chunked attention of ``mla_train`` whatever ``use_kernel`` says, as the
  reference does;
- ``g16``: the reduced qwen3-moe narrowed to the card's attention pair,
  16 query heads over 1 KV head of 128 (``flash_attention``'s (128, 16),
  qwen3-moe-235b-a22b's group), 4 experts top-2.

What is held:

- the routing tables of every layer's FFN input in the port's forward
  (expert ids, the capacity mask and the token table exactly, gates
  within 1e-6) against the reference's ``moe_forward`` on the same input,
  first, so a flipped expert cannot hide inside a tolerance; and the gap
  between each token's K-th and (K+1)-th router probability, which is
  what keeps a summation-order difference from flipping one;
- ``forward``'s logits and summed aux loss and ``loss_fn`` against the
  reference's (the port with and without ``use_kernel``: its kernel
  wrappers run their plain versions for CPU tensors; the reference at
  ``use_kernel=False``);
- every gradient leaf, the fp32 router included, against ``jax.grad`` of
  the reference loss with ``use_kernel=False`` (JAX cannot differentiate
  its Pallas kernels), remat off and on;
- a 3-step trajectory of the reference's train step, the port's step
  taken from the reference's state at each step
  (``bridge.train_state_from_jax``): losses, grad norms, every parameter
  and AdamW moment; one case at ``microbatches=2``, where each
  microbatch routes with its own capacity and adds its own aux loss;
- the train CLI's ``run`` on both reduced MoE models.

Inputs are fixed-seed numpy draws, fp32. Tolerances, as
``tests/test_torch_hybrid_train.py``: logits, losses, aux losses, grad
norms, gradients and AdamW's moments rtol / atol 1e-4; parameters after
an AdamW step at most 1e-3 apart and 1e-5 apart on average over each
leaf (Adam's normalised step turns a summation-order difference of a
gradient entry near zero into a parameter difference; a wrong gradient
moves whole leaves by whole steps).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_moe import _jax_routing  # noqa: E402

from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import get_config, reduced  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

ARCHS = {"qwen3-moe": "qwen3-moe-235b-a22b",
         "deepseek-v2-lite": "deepseek-v2-lite-16b",
         "g16": "qwen3-moe-235b-a22b"}
CASES = tuple(ARCHS)
# the narrowed variant: qwen3-moe-235b-a22b's attention pair (128, 16)
G16 = dict(n_heads=16, n_kv_heads=1, d_head=128)
TOL = dict(rtol=1e-4, atol=1e-4)
GATE_TOL = dict(rtol=0, atol=1e-6)
PARAM_MAX_DIFF = 1e-3
PARAM_MEAN_DIFF = 1e-5
# the smallest gap between a token's K-th and (K+1)-th router
# probability: the two packages' FFN inputs differ by about 1e-7, so
# the router's choice cannot flip across a gap this wide
ROUTE_GAP = 1e-5
STEPS = 3
B, S = 2, 24


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(case):
    """(JAX cfg, port cfg) of a case."""
    arch = ARCHS[case]
    jc, tc = reduced(get_config(arch)), tcfg.reduced(tcfg.get_config(arch))
    if case == "g16":
        jc, tc = (dataclasses.replace(jc, **G16),
                  dataclasses.replace(tc, **G16))
    return jc, tc


_MODELS: dict = {}


def _model(case, seed):
    """(cfg, JAX params, port cfg, port params), built once a (case,
    seed)."""
    if (case, seed) not in _MODELS:
        cfg, tcf = _cfgs(case)
        params = jtf.init_params(cfg, jax.random.PRNGKey(seed))
        _MODELS[case, seed] = (cfg, params, tcf, bridge.params_from_jax(
            tcf, _np_tree(params), device="cpu"))
    return _MODELS[case, seed]


def _batch(cfg, seed, b=B):
    """Tokens and labels in the vocabulary, some labels ignored."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)
    labels[1, -4:] = -1
    return {"tokens": rng.integers(0, cfg.vocab, (b, S)).astype(np.int32),
            "labels": labels}


def _split(b, m):
    """A batch's leaves as (M, B/M, ...), the train step's microbatches."""
    return {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])
            for k, v in b.items()}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _counts():
    return tfa.flash_attention.launches, tfa.flash_attention_bwd.launches


def test_narrowed_variant_carries_the_card_pair():
    """The narrowed variant's attention is the (128, 16) pair of both
    directions, qwen3-moe-235b-a22b's at full width; deepseek-v2-lite-16b
    is MLA (no attention kernel); the reduced qwen3-moe's (16, 2) runs
    only on the CPU."""
    _, tc = _cfgs("g16")
    pair = (tc.head_dim, tc.n_heads // tc.n_kv_heads)
    assert pair == (128, 16)
    assert pair in tfa.BUILT and pair in tfa.BUILT_BWD
    full = tcfg.get_config(ARCHS["qwen3-moe"])
    assert (full.head_dim, full.n_heads // full.n_kv_heads) == pair
    assert tcfg.get_config(ARCHS["deepseek-v2-lite"]).mla is not None
    assert _cfgs("deepseek-v2-lite")[1].mla is not None


@pytest.mark.parametrize("case", CASES)
def test_routing_tables_match_reference(case, monkeypatch):
    """Each layer's FFN input as the port's forward routes it: the
    routing tables equal the reference's ``moe_forward`` on that input,
    the routed output and aux loss within 1e-4, and every token's top-k
    choice lies at least ``ROUTE_GAP`` clear of the next expert."""
    cfg, params, tcf, tparams = _model(case, 0)
    seen = []
    real = tmoe.moe_forward

    def record(p, x, mcfg):
        seen.append((p, x.detach().clone()))
        return real(p, x, mcfg)
    monkeypatch.setattr(tmoe, "moe_forward", record)
    with torch.no_grad():
        ttf.forward(tcf, tparams, _tb(_batch(cfg, seed=3)), use_kernel=True)
    assert len(seen) == cfg.n_layers
    K = cfg.moe.top_k
    for i, (tp, x) in enumerate(seen):
        jp = jtf._moe_params(jax.tree.map(lambda a: a[i], params["layers"]))
        ref = _jax_routing(jp, jnp.asarray(x.numpy()), cfg.moe)
        r = tmoe.route(tp, x.reshape(-1, cfg.d_model), tcf.moe)
        np.testing.assert_array_equal(r.expert_ids.numpy(), ref["ids"])
        np.testing.assert_array_equal(r.keep.numpy(), ref["keep"])
        np.testing.assert_array_equal(r.tok_table.numpy(), ref["tok"])
        np.testing.assert_allclose(r.gate_table.numpy(), ref["gate"],
                                   **GATE_TOL)
        y, aux = real(tp, x, tcf.moe)
        np.testing.assert_allclose(y.numpy(), ref["y"], **TOL)
        np.testing.assert_allclose(float(aux), float(ref["aux"]), **TOL)
        probs = torch.softmax(x.reshape(-1, cfg.d_model) @ tp.router, -1)
        top = torch.sort(probs, -1, descending=True).values
        assert float((top[:, K - 1] - top[:, K]).min()) > ROUTE_GAP, i


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_forward_and_loss_match_reference(case, use_kernel):
    """``forward``'s logits and summed aux loss and ``loss_fn`` against
    the reference's on the same weights and batch; on CPU tensors no
    kernel launch is counted."""
    cfg, params, tcf, tparams = _model(case, 0)
    b = _batch(cfg, seed=3)
    jlogits, jaux = jtf.forward(cfg, params, _jb(b), use_kernel=False)
    n0 = _counts()
    with torch.no_grad():
        logits, aux = ttf.forward(tcf, tparams, _tb(b),
                                  use_kernel=use_kernel)
        loss = ttf.loss_fn(tcf, tparams, _tb(b), use_kernel=use_kernel)
    assert _counts() == n0
    assert logits.shape == (B, S, cfg.vocab) and float(aux) > 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    jl = jtf.loss_fn(cfg, params, _jb(b), use_kernel=False)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)


_JAX_GRADS: dict = {}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_jax_grad(case, remat):
    """``loss_fn`` and the gradient of every leaf (attention or MLA, the
    fp32 router, the experts, the shared expert, norms, embedding and
    head), with and without remat, against ``jax.grad`` of the
    reference loss with ``use_kernel=False``."""
    cfg, params, tcf, tparams = _model(case, 1)
    b = _batch(cfg, seed=7)
    if case not in _JAX_GRADS:
        _JAX_GRADS[case] = jax.value_and_grad(
            lambda p: jtf.loss_fn(cfg, p, _jb(b), use_kernel=False))(params)
    jl, jg = _JAX_GRADS[case]
    tl, tg = tts.build_grad_fn(tcf, tts.TrainConfig(
        use_kernel=True, remat=remat))(tparams, _tb(b))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(leaves(tg)) == len(jleaves)
    dtypes = {name: p.dtype for name, p in leaves_with_paths(tparams)}
    for (name, g), w in zip(leaves_with_paths(tg), jleaves):
        assert g.shape == w.shape and g.dtype == dtypes[name], name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    router = tg["layers"]["moe"]["router"]
    assert router.dtype == torch.float32
    assert bool((router.flatten(1).abs().amax(1) > 0).all())
    for leaf in ("w_gate", "w_down"):      # every layer's experts learn
        w = tg["layers"]["moe"][leaf]
        assert bool((w.flatten(1).abs().amax(1) > 0).all()), leaf


@pytest.mark.parametrize("case,micro", [("qwen3-moe", 1),
                                        ("deepseek-v2-lite", 1),
                                        ("g16", 1), ("qwen3-moe", 2)])
def test_train_steps_match_reference(case, micro):
    """Three steps of the reference's train step (``use_kernel=False``)
    from one state, and at each the port's train step (``use_kernel=True``)
    from the reference's state before it, carried over by
    ``bridge.train_state_from_jax`` (parameters with the fp32 router,
    AdamW's step counter and fp32 moments): the loss, the grad norm and
    every parameter and moment after the step. At ``microbatches=2``
    each half of the batch routes with its own capacity and adds its own
    aux loss; the losses' mean and the fp32 gradient sum / 2 are held.
    A free-running trajectory is not held (Adam turns gradient entries
    near zero into steps of either sign; see
    ``tests/test_torch_hybrid_train.py``)."""
    cfg, tcf = _cfgs(case)

    def sched(optim):
        return optim.cosine_schedule(1e-2, 2, STEPS)
    jtc = jts.TrainConfig(adamw=joptim.AdamWConfig(lr=sched(joptim)),
                          microbatches=micro, use_kernel=False)
    jstate = jts.init_train_state(cfg, jtc, jax.random.PRNGKey(0))
    jstep = jax.jit(jts.build_train_step(cfg, jtc))
    step = tts.build_train_step(tcf, tts.TrainConfig(
        adamw=toptim.AdamWConfig(lr=sched(toptim)), microbatches=micro,
        use_kernel=True))
    got, want = [], []
    for s in range(STEPS):
        b = _batch(cfg, seed=10 + s, b=2 * micro)
        if micro > 1:
            b = _split(b, micro)
        state = bridge.train_state_from_jax(tcf, _np_tree(jstate),
                                            device="cpu")
        assert int(state.opt.step) == s
        assert state.params["layers"]["moe"]["router"].dtype == torch.float32
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


@pytest.mark.parametrize("case", ["qwen3-moe", "deepseek-v2-lite"])
def test_train_cli_runs_the_reduced_moe(case, capsys):
    """The train CLI trains each reduced MoE model on the CPU through the
    kernel path (their plain versions: no launch counted), and its first
    loss is the loss, aux included, of the CLI's initial state on its
    first batch."""
    arch = ARCHS[case]
    n0 = _counts()
    out = train_cli.main(["--arch", arch, "--reduced", "--steps", "3",
                          "--batch", "2", "--seq", "24", "--device", "cpu"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert _counts() == n0
    assert '"device": "cpu"' in capsys.readouterr().out
    tcf = tcfg.reduced(tcfg.get_config(arch))
    state = tts.init_train_state(tcf, train_cli.train_config(steps=3), 0,
                                 device="cpu")
    b = train_cli.device_batch(SyntheticLM(vocab=tcf.vocab, seq_len=24,
                                           batch=2), 0, 1,
                               torch.device("cpu"))
    with torch.no_grad():
        first = ttf.loss_fn(tcf, state.params, b, use_kernel=True)
        _, aux = ttf.forward(tcf, state.params, b, use_kernel=True)
    assert float(aux) > 0.0
    np.testing.assert_allclose(out["losses"][0], float(first), rtol=1e-6)
