"""The port's serving engine on the vision-language family
(``internvl2-1b``) against the JAX engine, on the CPU.

The reference's engine takes no patches: it serves a vlm model as the
text-only dense decoder on every dense path, so the port's does too.
Five requests through three slots (one filling ``max_len`` exactly) on
paged + ring and on dense PAM, greedy and sampled (temperature 0.8,
top-8), at ``micro_steps`` 1 and 4: the streams equal the JAX engine's
at ``micro_steps`` 1 (ROADMAP Queue 3: the reference's pipelined
micro-step loop is held to its own single-step streams), and every
dispatch's ``StepBufs`` equal the JAX engine's at the same
``micro_steps`` (greedy). One run at internvl2-1b's own heads (14 q / 2
kv of 64) puts the decode kernels' built pair (64, 7) on the path.

Weights are the reference's ``init_params`` at seed 0 through
``repro_torch.bridge``; prompts are fixed-seed numpy draws; fp32.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import make_engine, make_pam  # noqa: E402
from test_torch_decode_graph import (_assert_bufs_equal,  # noqa: E402
                                     _outputs, _record_jax, _record_port)

from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import get_config, reduced  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

ARCH = "internvl2-1b"
MAX_LEN = 64
NEW = 8
PAM_KW = dict(hot=8, warm=8, compression=2)      # every tier read, Alg. 2
SAMPLED = dict(temperature=0.8, top_k=8, sample_seed=3)
LAYOUTS = {"paged_ring": dict(block_size=8, hot_window=16),
           "dense_pam": dict()}
VARIANTS = {"reduced": {},
            "g7": dict(n_heads=14, n_kv_heads=2, d_head=64)}
# request 1 fills max_len exactly (56 + 8 = 64) while the others decode
PROMPT_LENS = (20, 56, 9, 33, 14)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


_MODELS: dict = {}


def _models(variant):
    if variant not in _MODELS:
        cfg = dataclasses.replace(reduced(get_config(ARCH)),
                                  **VARIANTS[variant])
        params = jtf.init_params(cfg, jax.random.PRNGKey(0))
        tcf = dataclasses.replace(tcfg.reduced(tcfg.get_config(ARCH)),
                                  **VARIANTS[variant])
        _MODELS[variant] = (cfg, params, tcf, bridge.params_from_jax(
            tcf, _np_tree(params), device="cpu"))
    return _MODELS[variant]


def _port_pam():
    j = make_pam(max_len=MAX_LEN, **PAM_KW)
    return tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _serve(eng, new, cls):
    for i, p in enumerate(_prompts(eng.cfg.vocab)):
        eng.submit(cls(id=i, prompt=p, max_new_tokens=new))
    eng.run()
    return _outputs(eng)


_JAX_RUNS: dict = {}


def _jax_run(variant, layout, micro, **extra):
    """The JAX engine's streams and recorded engine, once a case."""
    key = (variant, layout, micro, tuple(sorted(extra.items())))
    if key not in _JAX_RUNS:
        cfg, params = _models(variant)[:2]
        jeng = make_engine(cfg, params, pam=make_pam(max_len=MAX_LEN,
                                                     **PAM_KW),
                           max_batch=3, max_len=MAX_LEN, micro_steps=micro,
                           **LAYOUTS[layout], **extra)
        _record_jax(jeng)
        _JAX_RUNS[key] = (_serve(jeng, NEW, JaxRequest), jeng)
    return _JAX_RUNS[key]


def _port_run(variant, layout, micro, **extra):
    _, _, tcf, tparams = _models(variant)
    peng = teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=_port_pam(), max_batch=3, max_len=MAX_LEN, micro_steps=micro,
        **LAYOUTS[layout], **extra), device="cpu")
    _record_port(peng)
    return _serve(peng, NEW, teng.Request), peng


@pytest.mark.parametrize("micro", [1, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_streams_and_stepbufs_equal_jax_engine(layout, micro):
    """Greedy: streams equal the JAX engine's at ``micro_steps`` 1, and
    every dispatch's StepBufs the JAX engine's at the same
    ``micro_steps``; every tier is read, one request reaches
    ``max_len``."""
    got, peng = _port_run("reduced", layout, micro)
    want = _jax_run("reduced", layout, 1)[0]
    jeng = _jax_run("reduced", layout, micro)[1]
    if micro > 1:
        assert peng.decode_device_steps > peng.decode_dispatches
    assert got == want
    _assert_bufs_equal(jeng, peng)
    assert all(len(v) == NEW for v in got.values())
    assert max(int(b["lengths"].max()) for b in peng.log) == MAX_LEN - 1
    assert sum(peng.summary()["tier_reads"]) > 0


@pytest.mark.parametrize("micro", [1, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sampled_streams_equal_jax_engine(layout, micro):
    """Sampled (temperature 0.8, top-8): streams equal the JAX engine's
    at ``micro_steps`` 1, and at 1 every dispatch's StepBufs too."""
    got, peng = _port_run("reduced", layout, micro, **SAMPLED)
    want, jeng = _jax_run("reduced", layout, 1, **SAMPLED)
    assert got == want
    assert got != _jax_run("reduced", layout, 1)[0]  # sampling changed one
    if micro == 1:
        _assert_bufs_equal(jeng, peng)


def test_group_7_streams_and_stepbufs_equal_jax_engine():
    """internvl2-1b's heads (14 q / 2 kv of 64: the decode kernels' pair
    (64, 7)) on paged + ring, greedy: streams and StepBufs equal the JAX
    engine's."""
    got, peng = _port_run("g7", "paged_ring", 1)
    want, jeng = _jax_run("g7", "paged_ring", 1)
    assert got == want
    _assert_bufs_equal(jeng, peng)


def test_snapshot_exported_by_the_port_continues_in_the_jax_engine():
    """Migration (paged + ring): the port exports a running request
    mid-decode, a JAX engine of batch 2 commits the snapshot and runs it
    to the end; its stream and the stay-behinds' equal the unmigrated
    JAX twin's."""
    from repro.cluster import KVSnapshot as JSnap
    from repro_torch.cluster import KVSnapshot as TSnap
    twin = _jax_run("reduced", "paged_ring", 1)[0]
    _, _, tcf, tparams = _models("reduced")
    cfg, params = _models("reduced")[:2]
    src = teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=_port_pam(), max_batch=3, max_len=MAX_LEN,
        **LAYOUTS["paged_ring"]), device="cpu")
    dst = make_engine(cfg, params, pam=make_pam(max_len=MAX_LEN, **PAM_KW),
                      max_batch=2, max_len=MAX_LEN, **LAYOUTS["paged_ring"])
    for i, p in enumerate(_prompts(tcf.vocab)):
        src.submit(teng.Request(id=i, prompt=p, max_new_tokens=NEW))
    for _ in range(3):
        src.step()
    ts = TSnap.export(src, 1)
    snap = {f.name: getattr(ts, f.name) for f in dataclasses.fields(ts)}
    snap["request"] = JaxRequest(id=1, prompt=np.asarray(ts.request.prompt),
                                 max_new_tokens=NEW)
    assert JSnap(**snap).verify()
    JSnap(**snap).commit(dst)
    for eng in (src, dst):
        while eng.waiting or any(s is not None for s in eng.slots):
            eng.step()
    assert dst.requests[1].outputs == twin[1]
    for rid in (0, 2, 3, 4):
        assert list(src.requests[rid].outputs) == twin[rid], rid
