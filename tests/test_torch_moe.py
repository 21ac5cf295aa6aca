"""The port's GQA mixture-of-experts family against the JAX reference.

``repro_torch.models.moe`` (routing, capacity dispatch, combine, the
dense oracle) against ``repro.models.moe`` on the reduced
``qwen3-moe-235b-a22b`` MoE (4 experts, top-2, d_expert 32) and on 16
experts, top-4, with one shared expert; the reduced qwen3-moe model
(layout, ``params_from_jax`` with and without a shared expert, forward
logits and aux, prefill, suffix prefill, decode) against
``repro.models.transformer``; the copied config and the parameter
counts of every config the port registers; the decode kernels' built
shapes; and the port's import walk.

Inputs are fixed-seed numpy draws; weights come from the JAX package's
initialisers (``init_moe`` / ``conftest.build_model``) as numpy arrays.
fp32 throughout. The reference's routing tables are read from its own
intermediates (the ``top_k``, the capacity test and the two scatters of
``moe_forward``'s jaxpr, evaluated equation by equation). Tolerances:
expert ids, the capacity mask and the token table exactly; the gate
table within 1e-6 (the router's matrix product and softmax round their
last bit differently in the two packages); ``y`` and the aux loss
rtol / atol 1e-5; logits 1e-4 as in ``tests/test_torch_model.py``.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.extend import core as jex  # noqa: E402

from conftest import build_model  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.models.config import get_config, reduced  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCH = "qwen3-moe-235b-a22b"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GATE_TOL = dict(rtol=0, atol=1e-6)


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


# ------------------------------------------------------------ the module
def _moe_cfgs(case):
    """(JAX MoEConfig, port MoEConfig, d_model) of a case: the reduced
    qwen3-moe MoE (E 4, K 2), at capacity 4.0 for ``capacity_4``, or 16
    experts, top-4, one shared expert for ``shared``."""
    cfg = reduced(get_config(ARCH))
    jm = cfg.moe
    if case == "capacity_4":
        jm = dataclasses.replace(jm, capacity_factor=4.0)
    if case == "shared":
        jm = JMoEConfig(num_experts=16, top_k=4, num_shared=1, d_expert=32)
    return jm, tcfg.MoEConfig(**dataclasses.asdict(jm)), cfg.d_model


def _input(case, seed, d, B=2, S=16):
    """(B, S, d) fp32; ``capacity_1.25`` repeats one token 12 times (its
    two experts overflow); ``ties`` repeats rows (equal routes compete
    for capacity in token order) and zeroes some (uniform router
    probabilities: every top-k pick is a tie, taken at the lower id)."""
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)
    if case == "capacity_1.25":
        x[0, 4:16] = x[0, 3]
    if case == "ties":
        x[1, 4:12] = x[0, :8]
        x[0, 8:10] = x[0, 2]
        x[1, 12:15] = 0.0
    return x


def _jax_params(mcfg, d, seed):
    return jmoe.init_moe(jax.random.PRNGKey(seed), d, mcfg, jnp.float32)


def _torch_params(p):
    return tmoe.MoEParams(*[None if a is None
                            else torch.from_numpy(np.array(a)) for a in p])


def _jax_routing(p, x, mcfg):
    """The reference ``moe_forward`` evaluated equation by equation from
    its jaxpr: its outputs and its own routing intermediates (``top_k``;
    the first capacity test ``pos_in_expert < cap``; the token and gate
    scatters, sentinel slot cut off)."""
    closed = jax.make_jaxpr(lambda p, x: jmoe.moe_forward(p, x, mcfg))(p, x)
    jaxpr, env, rec = closed.jaxpr, {}, []

    def read(v):
        return v.val if isinstance(v, jex.Literal) else env[v]
    env.update(zip(jaxpr.constvars, closed.consts))
    env.update(zip(jaxpr.invars, jax.tree.leaves((p, x))))
    for eqn in jaxpr.eqns:
        outs = eqn.primitive.bind(*map(read, eqn.invars), **eqn.params)
        outs = outs if eqn.primitive.multiple_results else [outs]
        rec.append((eqn.primitive.name, outs))
        env.update(zip(eqn.outvars, outs))
    y, aux = map(read, jaxpr.outvars)
    (_, ids), = [o for n, o in rec if n == "top_k"]
    tk = ids.size
    keep = next(o[0] for n, o in rec if n == "lt" and o[0].shape == (tk,))
    tok, gate = (np.asarray(o[0])[:-1] for n, o in rec if n == "scatter")
    return dict(ids=np.asarray(ids), keep=np.asarray(keep), tok=tok,
                gate=gate, y=np.asarray(y), aux=np.asarray(aux))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["capacity_1.25", "capacity_4", "shared",
                                  "ties"])
def test_routing_and_output_match_jax(case, seed):
    """Routing tables equal the reference's (ids, keep and tokens
    exactly; gates within 1e-6); y and the aux loss within 1e-5. The
    default capacity drops assignments, 4.0 none."""
    jm, tm, d = _moe_cfgs(case)
    p = _jax_params(jm, d, seed + 5)
    x = _input(case, seed, d)
    ref = _jax_routing(p, jnp.asarray(x), jm)
    tp = _torch_params(p)
    xt = torch.from_numpy(x)
    r = tmoe.route(tp, xt.reshape(-1, d), tm)
    np.testing.assert_array_equal(r.expert_ids.numpy(), ref["ids"])
    np.testing.assert_array_equal(r.keep.numpy(), ref["keep"])
    np.testing.assert_array_equal(r.tok_table.numpy(), ref["tok"])
    _close(r.gate_table, ref["gate"], **GATE_TOL)
    y, aux = tmoe.moe_forward(tp, xt, tm)
    assert y.shape == x.shape and y.dtype == xt.dtype
    _close(y, ref["y"])
    _close(aux, ref["aux"])
    dropped = int((~r.keep).sum())
    if case == "capacity_4":
        assert dropped == 0
    elif case == "capacity_1.25":
        assert dropped > 0                 # the overflow sentinel is used
    if case == "shared":
        assert tp.shared_gate is not None and tp.shared_gate.numel()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_capacity_4_within_the_references_dense_oracle_bound(seed):
    """At capacity 4.0 nothing drops: the port stays within the bound
    the reference holds its own dispatch to (rtol / atol 1e-4 of
    ``moe_forward_dense_oracle``, ``tests/test_arch_smoke.py``)."""
    jm, tm, d = _moe_cfgs("capacity_4")
    p = _jax_params(jm, d, seed)
    x = np.random.default_rng(seed + 10).standard_normal(
        (2, 16, d)).astype(np.float32)
    oracle = jmoe.moe_forward_dense_oracle(p, jnp.asarray(x), jm)
    y, aux = tmoe.moe_forward(_torch_params(p), torch.from_numpy(x), tm)
    _close(y, oracle, rtol=1e-4, atol=1e-4)
    assert float(aux) >= 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_is_the_scatter_add_in_slot_order(dtype):
    """``combine`` equals a sequential scatter-add of every slot, in slot
    order, into zeros of the contributions' dtype (the reference's
    ``y.at[tok].add`` as XLA's CPU scatter runs it), bit for bit:
    dropped assignments add nothing, empty slots add zeros to token 0."""
    jm, tm, d = _moe_cfgs("capacity_1.25")
    x = torch.from_numpy(_input("capacity_1.25", 3, d))
    r = tmoe.route(_torch_params(_jax_params(jm, d, 3)), x.reshape(-1, d),
                   tm)
    n_slots = r.tok_table.numel()
    contrib = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n_slots, d)).astype(np.float32)).to(dtype)
    contrib = contrib * (r.gate_table[:, None] != 0)   # empty slots: zero
    want = torch.zeros(x.shape[0] * x.shape[1], d, dtype=dtype)
    for s in range(n_slots):
        t = int(r.tok_table[s])
        want[t] = want[t] + contrib[s]
    got = tmoe.combine(contrib, r.slot, tm.top_k)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert not bool(r.keep.all())                      # drops occurred


@pytest.mark.parametrize("shared", [0, 2])
def test_init_moe_scales_and_dtypes(shared):
    """Router N(0, 1/d) in fp32 whatever the model dtype; gate and up
    N(0, 1/d), down N(0, 1/f) in the model dtype; the fused shared
    experts N(0, 1/fan_in), or None without them, as the reference's
    ``init_moe``."""
    mcfg = tcfg.MoEConfig(num_experts=8, top_k=2, d_expert=96,
                          num_shared=shared)
    d = 128
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, d, mcfg, torch.bfloat16, torch.device("cpu"))
    assert p.router.dtype == torch.float32 and p.w_gate.dtype == \
        torch.bfloat16
    want = [(p.router, d ** -0.5), (p.w_gate, d ** -0.5),
            (p.w_up, d ** -0.5), (p.w_down, 96 ** -0.5)]
    if shared:
        assert tuple(p.shared_down.shape) == (shared * 96, d)
        want += [(p.shared_gate, d ** -0.5), (p.shared_up, d ** -0.5),
                 (p.shared_down, (shared * 96) ** -0.5)]
    else:
        assert p.shared_gate is None and p.shared_down is None
    for w, std in want:
        assert abs(float(w.float().std()) / std - 1) < 0.05
    assert tuple(p.w_down.shape) == (8, 96, d)


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def model():
    cfg, params = build_model(ARCH)
    tcf = tcfg.reduced(tcfg.get_config(ARCH))
    return cfg, params, tcf, bridge.params_from_jax(tcf, _np_tree(params),
                                                    device="cpu")


def test_config_matches_reference():
    """The copied config, full and reduced, field for field."""
    assert dataclasses.asdict(tcfg.get_config(ARCH)) == \
        dataclasses.asdict(get_config(ARCH))
    assert dataclasses.asdict(tcfg.reduced(tcfg.get_config(ARCH))) == \
        dataclasses.asdict(reduced(get_config(ARCH)))


PORT_CONFIGS = ["deepseek-67b", "deepseek-v2-lite-16b", "hubert-xlarge",
                "internvl2-1b", "mamba2-780m", "minicpm-2b", "pam-llama-7b",
                "qwen3-0.6b", "qwen3-14b", ARCH, "zamba2-7b"]


@pytest.mark.parametrize("arch", PORT_CONFIGS)
def test_param_counts_match_reference(arch):
    """``param_count`` / ``active_param_count`` of every config the port
    registers, full and reduced, equal the reference's."""
    assert sorted(tcfg.all_configs()) == PORT_CONFIGS
    for own, ref in ((tcfg.get_config(arch), get_config(arch)),
                     (tcfg.reduced(tcfg.get_config(arch)),
                      reduced(get_config(arch)))):
        assert own.param_count() == ref.param_count()
        assert own.active_param_count() == ref.active_param_count()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout_matches_reference(model, dtype):
    """Keys, shapes and dtypes of ``tf.init_params``: ``layers/moe``
    (fp32 router even in bf16, zero-size shared leaves), no ``mlp``; the
    bridged weights are bit-equal."""
    cfg, params, tcf, tparams = model
    cfg, tcf = (dataclasses.replace(c, dtype=dtype) for c in (cfg, tcf))
    ref = _leaves(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda: jtf.init_params(cfg,
                                               jax.random.PRNGKey(0)))))
    own = _leaves(ttf.init_params(tcf, 0, device="cpu"))
    assert sorted(own) == sorted(ref)
    assert not any("/mlp/" in n for n in own)
    for name, a in ref.items():
        assert tuple(own[name].shape) == a.shape, name
        assert str(own[name].dtype).split(".")[-1] == a.dtype.name, name
    assert own["/layers/moe/router"].dtype == torch.float32
    assert own["/layers/moe/shared_gate"].shape == (tcf.n_layers, 0)
    if dtype == "float32":
        bridged = _leaves(_np_tree(params))
        for name, t in _leaves(tparams).items():
            np.testing.assert_array_equal(t.numpy(), bridged[name])


def _prompts(vocab, B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("bucketed", [False, True])
def test_prefill_matches_jax(model, bucketed):
    """Logits, cache and lengths; ``bucketed`` pads to a pow-2 bucket with
    ragged ``true_len``: the padded rows are routed with the real ones,
    as in the reference (capacity couples them)."""
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


def test_prefill_suffix_matches_jax(model):
    """A 12-token suffix over a 10-token cached prefix: logits and the
    suffix K/V of the reference's ``prefill_suffix``."""
    cfg, params, tcf, tparams = model
    toks = _prompts(cfg.vocab, S=22, seed=3)
    _, jc = jtf.prefill(cfg, params, jnp.asarray(toks[:, :10]), 16)
    pk, pv = np.array(jc.k), np.array(jc.v)
    plen = np.array([10, 10], np.int32)
    true_len = np.array([12, 7], np.int32)
    jl, jk, jv = jtf.prefill_suffix(cfg, params, jnp.asarray(toks[:, 10:]),
                                    jnp.asarray(pk), jnp.asarray(pv),
                                    jnp.asarray(plen),
                                    true_len=jnp.asarray(true_len))
    tl, tk, tv = ttf.prefill_suffix(tcf, tparams,
                                    torch.from_numpy(toks[:, 10:]),
                                    torch.from_numpy(pk),
                                    torch.from_numpy(pv),
                                    torch.from_numpy(plen),
                                    true_len=torch.from_numpy(true_len))
    _close(tl, jl, **LOGIT_TOL)
    _close(tk, jk)
    _close(tv, jv)


def test_decode_step_matches_jax(model):
    """Three greedy steps after a JAX prefill of three rows: the decode
    FFN routes the rows of the batch together (T = B)."""
    cfg, params, tcf, tparams = model
    jl, jc = jtf.prefill(cfg, params,
                         jnp.asarray(_prompts(cfg.vocab, B=3, S=10)), 24)
    tc = bridge.cache_from_jax(jc, device="cpu")
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    tt = torch.from_numpy(np.array(jt))
    for _ in range(3):
        jl, jc, js = jtf.decode_step(cfg, params, jt, jc)
        tl, tc, ts = ttf.decode_step(tcf, tparams, tt, tc)
        _close(tl, jl, **LOGIT_TOL)
        _close(ts, js)
        _close(tc.k, jc.k)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_paged_cache_admitted_for_gqa_moe(model):
    """``init_decode_cache`` gives the GQA MoE family paged pools, as
    the reference does."""
    _, _, tcf, _ = model
    c = ttf.init_decode_cache(tcf, 2, 32, paged_blocks=4, block_size=8,
                              hot_window=16, device="cpu")
    assert tuple(c.pk.shape) == (tcf.n_layers, 5, 8, tcf.n_kv_heads,
                                 tcf.head_dim)
    assert tuple(c.k.shape) == (tcf.n_layers, 2, tcf.n_kv_heads, 16,
                                tcf.head_dim)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_logits_and_aux_match_jax(model, remat):
    """The training forward: logits and the layers' summed load-balance
    loss, and the loss, against the reference's ``forward`` /
    ``loss_fn``; ``remat`` checkpoints the MoE layers too."""
    cfg, params, tcf, tparams = model
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels[0, :3] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    jl, ja = jtf.forward(cfg, params, jb)
    tl, ta = ttf.forward(tcf, tparams, tb, remat=remat)
    _close(tl, jl, **LOGIT_TOL)
    _close(ta, ja)
    assert float(ta) > 0.0
    _close(ttf.loss_fn(tcf, tparams, tb, remat=remat),
           jtf.loss_fn(cfg, params, jb), **LOGIT_TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_dense_oracle_matches_jax(seed):
    """``moe_forward_dense_oracle`` (every token reaches its experts)
    against the reference's, with and without a shared expert."""
    for case in ("capacity_1.25", "shared"):
        jm, tm, d = _moe_cfgs(case)
        p = _jax_params(jm, d, seed)
        x = _input(case, seed, d)
        ref = jmoe.moe_forward_dense_oracle(p, jnp.asarray(x), jm)
        _close(tmoe.moe_forward_dense_oracle(_torch_params(p),
                                             torch.from_numpy(x), tm), ref)


@pytest.mark.parametrize("num_shared", [0, 1])
def test_params_from_jax_carries_the_moe_subtree(num_shared):
    """``params_from_jax`` moves the stacked ``moe`` leaves bit for bit,
    the fused shared experts when the config has one and the zero-size
    shared leaves when it has none; the bridged model decodes as the
    reference does."""
    cfg = reduced(get_config(ARCH))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_shared=num_shared))
    tcf = dataclasses.replace(tcfg.reduced(tcfg.get_config(ARCH)),
                              moe=tcfg.MoEConfig(**dataclasses.asdict(
                                  cfg.moe)))
    params = jtf.init_params(cfg, jax.random.PRNGKey(num_shared))
    tparams = bridge.params_from_jax(tcf, _np_tree(params), device="cpu")
    own, ref = _leaves(tparams), _leaves(_np_tree(params))
    assert sorted(own) == sorted(ref)
    for name, a in ref.items():
        assert tuple(own[name].shape) == a.shape, name
        np.testing.assert_array_equal(own[name].numpy(), a)
    sg = own["/layers/moe/shared_gate"]
    if num_shared:
        assert tuple(sg.shape) == (cfg.n_layers, cfg.d_model,
                                   cfg.moe.d_expert)
    else:
        assert tuple(sg.shape) == (cfg.n_layers, 0)
    toks = _prompts(cfg.vocab, B=2, S=8, seed=num_shared)
    jl, jc = jtf.prefill(cfg, params, jnp.asarray(toks), 16)
    tc = bridge.cache_from_jax(jc, device="cpu")
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    jl, _, _ = jtf.decode_step(cfg, params, jt, jc)
    tl, _, _ = ttf.decode_step(tcf, tparams, torch.from_numpy(np.array(jt)),
                               tc)
    _close(tl, jl, **LOGIT_TOL)


def test_mla_moe_names_its_roadmap_item():
    """A refusal that still stands (the sequence-parallel
    ``activation_spec`` of the training forward, which waits with this
    family's sharded training) raises naming ROADMAP Queue 1 item 10."""
    cfg = tcfg.reduced(tcfg.get_config(ARCH))
    toks = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
        ttf.forward(cfg, {}, {"tokens": toks}, activation_spec=object())


# ------------------------------------------------------------ kernels
def test_decode_kernels_built_for_group_16_only_among_wide_groups():
    """The decode kernels are built for the listed (head dim, GQA group)
    pairs: the launch check accepts group 16 at head dims 128 and 16 and
    group 7 at head dim 64 only (internvl2-1b's pair; a host tensor then
    fails the operand check, after the shape check passed) and still
    refuses group 4 and group 7 at head dim 128; head dim 112 is built at
    group 1 only (zamba2-7b's pair), head dim 80 at none (the audio
    family has no decode), so both kernels refuse (112, 2) and (80, 1)."""
    assert {(128, 16), (16, 16)} <= set(tfd.BUILT)
    assert 4 not in {rep for _, rep in tfd.BUILT}
    assert [d for d, rep in tfd.BUILT if rep == 7] == [64]
    assert 80 not in {d for d, _ in tfd.BUILT}
    assert [rep for d, rep in tfd.BUILT if d == 112] == [1]
    t = torch.zeros(4)
    for d, rep in ((128, 16), (16, 16), (112, 1), (64, 7)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            tfd.check_launch("flash_decode", d, rep, t)
    for d, rep in ((128, 4), (128, 7)):
        with pytest.raises(ValueError, match="not built"):
            tfd.check_launch("flash_decode_paged", d, rep, t)
    for name in ("flash_decode", "flash_decode_paged"):
        for d, rep in ((112, 2), (80, 1)):
            with pytest.raises(ValueError, match="not built"):
                tfd.check_launch(name, d, rep, t)


_WALK = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
assert "repro_torch.models.moe" in names, names
assert "repro_torch.configs.qwen3_moe_235b_a22b" in names, names
assert "repro_torch.models.mla" in names, names
assert "repro_torch.configs.deepseek_v2_lite_16b" in names, names
assert "repro_torch.configs.zamba2_7b" in names, names
bad = sorted(n for n in sys.modules
             if n in ("jax", "repro", "triton")
             or n.startswith(("jax.", "repro.", "triton.")))
assert not bad, bad
print("walked", len(names))
"""


def test_import_walk_reaches_the_moe_module():
    """The port's import walk (as ``tests/test_torch_engine.py`` does it)
    reaches the MoE and MLA modules, their configs and the hybrid config,
    and loads neither JAX, the reference package nor triton."""
    out = subprocess.run([sys.executable, "-c", _WALK], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("walked")
