"""The wider dense family on the port against the JAX package, on the CPU:
``qwen3-14b`` (GQA group 5), ``deepseek-67b`` (group 8) and
``minicpm-2b`` (MHA, head dim 64).

- each copied config equals the reference's field for field, full and
  reduced;
- the decode kernels' plain versions (``flash_decode``,
  ``flash_decode_paged`` and their merged forms) at groups 5 and 8 and at
  head dim 64 against the Pallas kernels in ``interpret=True`` (the
  merged forms against the JAX ``decode_attention_partial`` /
  ``paged_decode_attention_partial``), fp32 at rtol 1e-5 / atol 1e-4, as
  ``tests/test_torch_kernels.py``;
- the port's engine at reduced variants of the three (group 5: 10 q / 2
  kv heads; group 8: 16 / 2; minicpm-2b with 4 / 4 heads of 64), weights
  from the JAX package's ``init_params`` through ``repro_torch.bridge``:
  greedy streams and every dispatch's ``StepBufs`` equal the JAX
  engine's, paged + ring and dense PAM;
- the serve CLI runs each ``--arch`` reduced on the CPU;
- the built sets: the decode list in ``csrc/decode_common.cuh`` is the
  Python one, and ``flash_attention`` forward and backward refuse pairs
  outside their own set with "not built" before looking at the operands.

Inputs come from seeded numpy generators. The CUDA kernels at these
shapes are held to the plain versions on the card by
``tests/test_torch_decode_gqa_cuda.py``.
"""

import dataclasses
import json
import re
from pathlib import Path

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
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)
ARCHS = ("qwen3-14b", "deepseek-67b", "minicpm-2b")
# (H, Hkv, d) of the kernel cases: the reduced variants' heads, and
# head dim 64 at group 2 (built for the reduced variants' CLI)
KERNEL_HEADS = {"g5": (10, 2, 16), "g8": (16, 2, 16), "d64": (4, 4, 64),
                "d64_g2": (8, 4, 64)}
# the reduced variants the engines run: one per new built shape
VARIANTS = {"qwen3-14b": dict(n_heads=10, n_kv_heads=2),
            "deepseek-67b": dict(n_heads=16, n_kv_heads=2),
            "minicpm-2b": dict(n_heads=4, n_kv_heads=4, d_head=64)}
MAX_LEN = 64
PAM_KW = dict(hot=8, warm=8, compression=2)      # every tier read, Alg. 2
LAYOUTS = {"paged_ring": dict(block_size=8, hot_window=16),
           "dense_pam": dict()}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """The copied config, full and reduced, field for field, and its
    parameter count."""
    own, ref = tcfg.get_config(arch), get_config(arch)
    assert dataclasses.asdict(own) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tcfg.reduced(own)) == \
        dataclasses.asdict(reduced(ref))
    assert own.param_count() == ref.param_count()


# ------------------------------------------------------------- kernels
def _dense_inputs(H, Hkv, d, seed, B=3, S=48):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    mask = rng.random((B, S)) < 0.6
    mask[0, 16:32] = False                  # a dead split at block_s 16
    lens = np.array([S, 21, 0], np.int32)   # ragged, an all-dead row
    return q, k, v, mask, lens


def _paged_inputs(H, Hkv, d, seed, B=3, NB=20, bs=4, nb=6):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp = rng.standard_normal((NB + 1, bs, Hkv, d)).astype(np.float32)
    vp = rng.standard_normal((NB + 1, bs, Hkv, d)).astype(np.float32)
    table = rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32)
    table[1, 4:] = NB                      # unmapped tail -> sentinel
    mask = rng.random((B, nb * bs)) < 0.5
    mask[1, 16:] = False                   # sentinel blocks are dead
    mask[2, :] = False                     # a row with no live token
    live = mask.reshape(B, nb, bs).any(-1)
    live[0, 3] = False                     # live tokens in a dead block
    return q, kp, vp, table, mask, live


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("shape", sorted(KERNEL_HEADS))
def test_flash_decode_plain_matches_pallas(shape):
    """Stacked over 16-token splits and merged: (o, m, l) against the
    Pallas kernel and the JAX partial; the all-dead row keeps m = -1e30
    and o = l = 0."""
    q, k, v, mask, lens = _dense_inputs(*KERNEL_HEADS[shape], seed=5)
    want = jfd.flash_decode(*_j(q, k, v, mask), kv_lens=jnp.asarray(lens),
                            block_s=16, interpret=True)
    got = tfd.flash_decode(*_t(q, k, v, mask), kv_lens=torch.from_numpy(lens),
                           block_s=16)
    for t, j in zip(got, want):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)
    want = jops.decode_attention_partial(*_j(q, k, v, mask),
                                         kv_lens=jnp.asarray(lens),
                                         interpret=True)
    got = tfd.flash_decode_merged(*_t(q, k, v, mask),
                                  kv_lens=torch.from_numpy(lens))
    for t, j in zip(got, want):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)
    assert bool((got[1][2] == tfd.NEG_INF).all())
    assert bool((got[0][2] == 0).all() and (got[2][2] == 0).all())


@pytest.mark.parametrize("shape", sorted(KERNEL_HEADS))
def test_flash_decode_paged_plain_matches_pallas(shape):
    """Stacked over logical blocks and merged, with dead blocks, sentinel
    entries and a row with no live token, against the Pallas kernel and
    the JAX paged partial."""
    q, kp, vp, table, mask, live = _paged_inputs(*KERNEL_HEADS[shape],
                                                 seed=6)
    want = jfd.flash_decode_paged(*_j(q, kp, vp, table, mask),
                                  block_live=jnp.asarray(live),
                                  interpret=True)
    got = tfd.flash_decode_paged(*_t(q, kp, vp, table, mask),
                                 block_live=torch.from_numpy(live))
    for t, j in zip(got, want):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)
    want = jops.paged_decode_attention_partial(
        *_j(q, kp, vp, table, mask), block_live=jnp.asarray(live),
        use_kernel=True, interpret=True)
    got = tfd.flash_decode_paged_merged(*_t(q, kp, vp, table, mask),
                                        block_live=torch.from_numpy(live))
    for t, j in zip(got, want):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)


def test_decode_built_list_matches_the_cuda_dispatch():
    """``flash_decode.BUILT`` is the list of (head dim, group) pairs the
    CUDA dispatch instantiates (``PAM_DECODE_BUILT``), and holds the
    three configs' shapes."""
    src = (Path(tfd.__file__).parent / "csrc" / "decode_common.cuh"
           ).read_text()
    body = re.search(r"#define PAM_DECODE_BUILT\(X\)((?:.*\\\n)*.*)",
                     src).group(1)
    pairs = tuple((int(d), int(r))
                  for d, r in re.findall(r"X\((\d+),\s*(\d+)\)", body))
    assert pairs == tfd.BUILT
    for arch in ARCHS:
        cfg = tcfg.get_config(arch)
        assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads) in tfd.BUILT


@pytest.mark.parametrize("d,rep", [(16, 8), (16, 5), (64, 2)])
def test_flash_attention_refuses_unbuilt_pairs_first(d, rep):
    """The forward and the backward have their own built set (the train
    paths' pairs, ``BUILT`` / ``BUILT_BWD``): other pairs, here ones
    the decode kernels are built for, raise "not built" before any
    operand check, here on CPU tensors, so no launch can fail with a
    library's -1."""
    B, Hkv, S = 1, 1, 8
    q = torch.zeros((B, rep * Hkv, S, d))
    k = v = torch.zeros((B, Hkv, S, d))
    lse = torch.zeros((B, rep * Hkv, S))
    with pytest.raises(ValueError, match="not built"):
        tfa._fwd_cuda(q, k, v, True, 0.5)
    with pytest.raises(ValueError, match="not built"):
        tfa._bwd_cuda(q, k, v, q, lse, q, True, 0.5)
    # the decode kernels' check, which the wrappers used to share, passes
    assert (d, rep) not in tfa.BUILT and (d, rep) in tfd.BUILT


# ------------------------------------------------------------- engines
_MODELS: dict = {}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _models(arch):
    """(JAX cfg, JAX params, port cfg, port params) of ``arch``'s reduced
    variant: the same ``dataclasses.replace`` on both sides, the same
    weights."""
    if arch not in _MODELS:
        cfg = dataclasses.replace(reduced(get_config(arch)), **VARIANTS[arch])
        params = jtf.init_params(cfg, jax.random.PRNGKey(0))
        tcf = dataclasses.replace(tcfg.reduced(tcfg.get_config(arch)),
                                  **VARIANTS[arch])
        _MODELS[arch] = (cfg, params, tcf, bridge.params_from_jax(
            tcf, _np_tree(params), device="cpu"))
    return _MODELS[arch]


def _port_pam():
    j = make_pam(max_len=MAX_LEN, **PAM_KW)
    return tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_and_stepbufs_equal_jax_engine(arch, layout):
    """Four requests through three slots, greedy: streams and every
    dispatch's StepBufs equal the JAX engine's, and every tier is read."""
    cfg, params, tcf, tparams = _models(arch)
    jeng = make_engine(cfg, params, pam=make_pam(max_len=MAX_LEN, **PAM_KW),
                       max_batch=3, max_len=MAX_LEN, **LAYOUTS[layout])
    _record_jax(jeng)
    peng = teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=_port_pam(), max_batch=3, max_len=MAX_LEN, **LAYOUTS[layout]),
        device="cpu")
    _record_port(peng)
    rng = np.random.default_rng(3)
    for i, n in enumerate((20, 31, 9, 26)):
        p = rng.integers(0, tcf.vocab, n).astype(np.int32)
        jeng.submit(JaxRequest(id=i, prompt=p, max_new_tokens=10))
        peng.submit(teng.Request(id=i, prompt=p, max_new_tokens=10))
    jeng.run()
    peng.run()
    assert _outputs(peng) == _outputs(jeng)
    _assert_bufs_equal(jeng, peng)
    assert sum(peng.summary()["tier_reads"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_arch(capsys, arch):
    """``--arch <id> --reduced --device cpu`` on the serve CLI, paged +
    ring: every request finishes."""
    from repro_torch.launch import serve
    summ = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "20",
                       "--gen-len", "6", "--max-len", "64",
                       "--block-size", "8", "--hot-window", "16"])
    assert summ["finished"] == 3 and summ["total_tokens"] == 18
    assert json.loads(capsys.readouterr().out)["finished"] == 3
