"""The port's serving engine on the GQA mixture-of-experts family against
the JAX engine: reduced ``qwen3-moe-235b-a22b`` (4 experts, top-2,
capacity 1.25), fp32, weights from the JAX package's ``init_params``
through ``repro_torch.bridge``, prompts from fixed numpy seeds.

Capacity couples the rows routed together, so a request's stream depends
on every other row of its batch (idle and finished slots included) and
on the prefill and chunk shapes: the engines must hand the MoE FFN the
same rows. The token streams must be identical to the JAX engine's in
five modes (greedy paged + ring, dense PAM, sampled through the prefix
cache and chunked prefill, fewer requests than slots, and
``micro_steps`` 4 against the JAX engine's single-step streams, ROADMAP
Queue 3), and every decode
dispatch's ``StepBufs`` equal to the JAX engine's dispatch by dispatch;
the MoE body reads no device value on the host and consumes no lifted
host value (what a CUDA graph holds); the serve CLI runs the family.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import build_model, make_engine, make_pam  # noqa: E402
from test_torch_decode_graph import (_NoHostReads,  # noqa: E402
                                     _assert_bufs_equal, _outputs,
                                     _record_jax, _record_port,
                                     _shared_prompts)

from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

ARCH = "qwen3-moe-235b-a22b"
MAX_LEN = 64
PAM_KW = dict(hot=8, warm=8, compression=2)      # every tier read, Alg. 2
LAYOUTS = {"paged_ring": dict(block_size=8, hot_window=16),
           "dense_pam": dict()}
SAMPLED = dict(temperature=0.8, top_k=8, sample_seed=3)


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


_TORCH: dict = {}


def _models():
    """(JAX cfg, JAX params, port cfg, port params): the same weights."""
    cfg, params = build_model(ARCH)
    if not _TORCH:
        tcf = tcfg.reduced(tcfg.get_config(ARCH))
        _TORCH["m"] = (tcf, bridge.params_from_jax(tcf, _np_tree(params),
                                                   device="cpu"))
    return (cfg, params) + _TORCH["m"]


def _port_pam():
    j = make_pam(max_len=MAX_LEN, **PAM_KW)
    return tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval)


def _port_engine(layout, max_batch=3, **extra):
    _, _, tcf, tparams = _models()
    eng = teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=_port_pam(), max_batch=max_batch, max_len=MAX_LEN,
        **LAYOUTS[layout], **extra), device="cpu")
    _record_port(eng)
    return eng


def _jax_engine(layout, max_batch=3, **extra):
    cfg, params = _models()[:2]
    jeng = make_engine(cfg, params, pam=make_pam(max_len=MAX_LEN, **PAM_KW),
                       max_batch=max_batch, max_len=MAX_LEN,
                       **LAYOUTS[layout], **extra)
    _record_jax(jeng)
    return jeng


def _prompts(vocab, n=5, seed=0, lens=(20, 26, 9, 33, 14)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, lens[i % len(lens)]).astype(np.int32)
            for i in range(n)]


def _submit(eng, prompts, new, cls, first=0):
    for i, p in enumerate(prompts):
        eng.submit(cls(id=first + i, prompt=p, max_new_tokens=new))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_streams_and_stepbufs_equal_jax_engine(layout):
    """Five requests through three slots (admission waves reuse freed
    slots, so idle and finished rows ride along in the MoE's routing),
    greedy: streams and every dispatch's StepBufs equal the JAX
    engine's."""
    jeng, peng = _jax_engine(layout), _port_engine(layout)
    prompts = _prompts(peng.cfg.vocab)
    _submit(jeng, prompts, 12, JaxRequest)
    _submit(peng, prompts, 12, teng.Request)
    jeng.run()
    peng.run()
    assert _outputs(peng) == _outputs(jeng)
    _assert_bufs_equal(jeng, peng)
    assert sum(peng.summary()["tier_reads"]) > 0


def test_sampled_prefix_cache_chunked_equal_jax_engine():
    """Sampled (temperature 0.8, top-8), prefix cache, 8-token chunks,
    paged + ring: the suffix and chunk prefills hand the MoE the
    reference's shapes; streams and StepBufs equal the JAX engine's."""
    kw = dict(prefix_cache=True, prefill_chunk=8, **SAMPLED)
    jeng, peng = _jax_engine("paged_ring", **kw), _port_engine("paged_ring",
                                                               **kw)
    prompts = _shared_prompts(peng.cfg.vocab)
    _submit(jeng, prompts[:1], 10, JaxRequest)
    _submit(peng, prompts[:1], 10, teng.Request)
    while peng.requests[0].status != teng.RUNNING:   # its slices fill
        jeng.step()
        peng.step()
    _submit(jeng, prompts[1:], 10, JaxRequest, first=1)
    _submit(peng, prompts[1:], 10, teng.Request, first=1)
    jeng.run()
    peng.run()
    assert _outputs(peng) == _outputs(jeng)
    _assert_bufs_equal(jeng, peng)
    s = peng.summary()
    assert s["prefix_hits"] >= 3 and s["chunked_admissions"] >= 1


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_micro_steps_4_streams_equal_jax_single_step(layout):
    """``micro_steps`` 4 on the port against the JAX engine at
    ``micro_steps`` 1 (its pipelined loop is held to its own single-step
    streams; ROADMAP Queue 3): identical greedy streams."""
    jeng, peng = _jax_engine(layout), _port_engine(layout, micro_steps=4)
    prompts = _prompts(peng.cfg.vocab, n=6, seed=2)
    _submit(jeng, prompts, 14, JaxRequest)
    _submit(peng, prompts, 14, teng.Request)
    jeng.run()
    peng.run()
    assert _outputs(peng) == _outputs(jeng)
    assert peng.decode_device_steps > peng.decode_dispatches


@pytest.mark.parametrize("sampled", [False, True])
def test_idle_slots_compete_for_capacity_as_in_jax_engine(sampled):
    """Two requests in a batch of five slots, paged + ring: the three
    idle slots are routed with the live rows at every decode step (the
    reference feeds the MoE all B slots), so they take expert capacity;
    streams and every dispatch's StepBufs equal the JAX engine's, greedy
    and sampled."""
    extra = SAMPLED if sampled else {}
    jeng = _jax_engine("paged_ring", max_batch=5, **extra)
    peng = _port_engine("paged_ring", max_batch=5, **extra)
    prompts = _prompts(peng.cfg.vocab, n=2, seed=5 + sampled)
    _submit(jeng, prompts, 16, JaxRequest)
    _submit(peng, prompts, 16, teng.Request)
    jeng.run()
    peng.run()
    assert _outputs(peng) == _outputs(jeng)
    _assert_bufs_equal(jeng, peng)
    assert peng.slots.count(None) == 5


@pytest.mark.parametrize("layout, extra", [
    ("paged_ring", dict(SAMPLED, prefix_cache=True, prefill_chunk=8,
                        micro_steps=4, eos_token=5)),
    ("dense_pam", dict(micro_steps=2)),
])
def test_moe_dispatch_reads_no_device_value(layout, extra):
    """The decode body with the MoE FFN (routing, capacity tables,
    gather, combine) reads no device value on the host, and what a graph
    would capture consumes no value lifted from the host."""
    peng = _port_engine(layout, **extra)
    decode, dispatch = peng._decode, peng._dispatch

    def guarded(k, active):
        with _NoHostReads():
            return decode(k, active)

    def captured(key, bufs):
        with _NoHostReads(lifted=True):
            return dispatch(key, bufs)
    peng._decode, peng._dispatch = guarded, captured
    _submit(peng, _shared_prompts(peng.cfg.vocab), 10, teng.Request)
    peng.run()
    assert peng.decode_dispatches > 0
    assert all(rs.status == teng.DONE for rs in peng.requests.values())


@pytest.mark.parametrize("layers", [None, 1])
def test_serve_cli_runs_the_moe_family(capsys, layers):
    """``--arch qwen3-moe-235b-a22b --reduced --device cpu`` on the serve
    CLI, paged + ring, at the config's depth and cut to one layer
    (``--layers``): every request finishes."""
    from repro_torch.launch import serve
    cut = [] if layers is None else ["--layers", str(layers)]
    summ = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "20",
                       "--gen-len", "6", "--max-len", "64",
                       "--block-size", "8", "--hot-window", "16"] + cut)
    assert summ["finished"] == 3 and summ["total_tokens"] == 18
    assert json.loads(capsys.readouterr().out)["finished"] == 3
