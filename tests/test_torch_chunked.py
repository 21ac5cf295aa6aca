"""The port's chunked prefill against the JAX package's.

* ``plan_slices``, ``ChunkPlan`` and ``validate_budget`` equal the
  reference's ``repro.frontend.chunking`` on a grid of inputs.
* Engine token streams equal the JAX engine's, with chunked admission
  at budgets 8 and 16 and micro_steps 1 and 8, on paged + ring and
  paged pools; and chunked + prefix cache + sampling together. The
  chunk counters (admissions, slices, largest slice) equal the JAX
  engine's, no slice exceeds the budget, and a running request keeps
  decoding one token a step while a long prompt fills.
* The configuration checks and the serve CLI's flags.

The JAX engine runs each configuration once at micro_steps 1; the
JAX suite pins its micro-step streams to its single-step ones, so the
port's micro-step runs are held to those. Reduced qwen3-0.6b, weights
from the JAX package's ``init_params`` through ``repro_torch.bridge``;
every input from a fixed numpy seed.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import build_model, make_engine, make_pam  # noqa: E402

from repro.frontend import chunking as jchunk  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.frontend import chunking as tchunk  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

torch.set_num_threads(2)


# ---------------------------------------------------------- host planning
@pytest.mark.parametrize("budget", [1, 4, 8, 16, 256])
def test_plan_slices_and_chunk_plan_match_reference(budget):
    for start, total in ((0, 30), (5, 64), (12, 13), (0, 1), (255, 1024)):
        want = jchunk.plan_slices(start, total, budget)
        assert tchunk.plan_slices(start, total, budget) == want
        assert sum(t for _, t in want) == total - start
        plan = tchunk.ChunkPlan(rid=0, slot=1, start=start, total=total,
                                budget=budget)
        seen = []
        while not plan.finished:
            begin, t = plan.next_slice()
            seen.append((begin, t))
            plan.done += t
        assert seen == want
    with pytest.raises(ValueError):
        tchunk.plan_slices(7, 7, budget)


@pytest.mark.parametrize("budget", [0, -8, 3, 12, 100])
def test_validate_budget_rejects_what_the_reference_rejects(budget):
    with pytest.raises(ValueError):
        jchunk.validate_budget(budget)
    with pytest.raises(ValueError, match="power-of-two"):
        tchunk.validate_budget(budget)


# ---------------------------------------------------------- engine streams
MAX_LEN, BLOCK = 64, 8
PLENS, NEW = (30, 9, 16, 5, 41), 8
LAYOUTS = {"paged_ring": dict(block_size=BLOCK, hot_window=16),
           "paged": dict(block_size=BLOCK)}
SAMPLED = dict(temperature=0.8, top_k=8, sample_seed=7)
CHUNK_COUNTERS = ("chunked_admissions", "chunk_slices",
                  "max_chunk_slice_tokens")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _torch_model():
    cfg, params = build_model("qwen3-0.6b")
    tcf = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    return tcf, bridge.params_from_jax(tcf, _np_tree(params), device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, p).astype(np.int32) for p in PLENS]


@functools.lru_cache(maxsize=None)
def _jax_run(layout, chunk, sampled=False, cache=False):
    cfg, params = build_model("qwen3-0.6b")
    eng = make_engine(cfg, params, pam=make_pam(max_len=MAX_LEN),
                      max_batch=4, max_len=MAX_LEN, prefill_chunk=chunk,
                      prefix_cache=cache, **LAYOUTS[layout],
                      **(SAMPLED if sampled else {}))
    for i, p in enumerate(_prompts(cfg.vocab)):
        eng.submit(JaxRequest(id=i, prompt=p, max_new_tokens=NEW))
    summ = eng.run()
    return ({i: list(eng.requests[i].outputs) for i in range(len(PLENS))},
            summ)


def _port_engine(layout, chunk, sampled=False, cache=False, **kw):
    tcf, tparams = _torch_model()
    j = make_pam(max_len=MAX_LEN)
    pam = tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval)
    args = dict(max_batch=4, max_len=MAX_LEN, prefill_chunk=chunk,
                prefix_cache=cache, **LAYOUTS[layout],
                **(SAMPLED if sampled else {}))
    args.update(kw)
    return tcf, teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=pam, **args), device="cpu")


def _port_run(layout, chunk, sampled=False, cache=False, **kw):
    tcf, eng = _port_engine(layout, chunk, sampled, cache, **kw)
    for i, p in enumerate(_prompts(tcf.vocab)):
        eng.submit(teng.Request(id=i, prompt=p, max_new_tokens=NEW))
    summ = eng.run()
    return ({i: list(eng.requests[i].outputs) for i in range(len(PLENS))},
            summ)


@pytest.mark.parametrize("micro", [1, 8])
@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chunked_streams_equal_jax_engine(layout, chunk, micro):
    want, jsumm = _jax_run(layout, chunk)
    got, summ = _port_run(layout, chunk, micro_steps=micro)
    assert got == want
    assert got == _jax_run(layout, 0)[0]         # single-shot twin
    assert {k: summ[k] for k in CHUNK_COUNTERS} == \
        {k: jsumm[k] for k in CHUNK_COUNTERS}
    assert summ["chunked_admissions"] == sum(p > chunk for p in PLENS)
    assert summ["max_chunk_slice_tokens"] <= chunk
    assert summ["chunk_slices"] == sum(
        len(tchunk.plan_slices(0, p, chunk)) for p in PLENS if p > chunk)


@functools.lru_cache(maxsize=None)
def _jax_chunk_prefix_sampled(prompts):
    cfg, params = build_model("qwen3-0.6b")
    eng = make_engine(cfg, params, pam=make_pam(max_len=MAX_LEN),
                      max_batch=1, max_len=MAX_LEN, block_size=BLOCK,
                      hot_window=16, prefix_cache=True, prefill_chunk=8,
                      **SAMPLED)
    for i, p in enumerate(prompts):
        eng.submit(JaxRequest(id=i, prompt=np.array(p, np.int32),
                              max_new_tokens=6))
    summ = eng.run()
    return {i: list(eng.requests[i].outputs) for i in range(3)}, summ


@pytest.mark.parametrize("micro", [1, 8])
def test_chunked_prefix_cache_sampled_equal_jax_engine(micro):
    """Chunked admission, the prefix cache and sampling together: a
    prompt that shares a 12-token prefix (not a block multiple) with an
    earlier one hits the trie, copy-on-writes in its first slice, and
    fills the rest in slices; every stream equals the JAX engine's."""
    cfg, params = build_model("qwen3-0.6b")
    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab, 12)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, n)])
               .astype(np.int32) for n in (18, 30, 7)]

    want, jsumm = _jax_chunk_prefix_sampled(tuple(map(tuple, prompts)))
    tcf, eng = _port_engine("paged_ring", 8, sampled=True, cache=True,
                            max_batch=1, micro_steps=micro)
    for i, p in enumerate(prompts):
        eng.submit(teng.Request(id=i, prompt=p, max_new_tokens=6))
    summ = eng.run()
    got = {i: list(eng.requests[i].outputs) for i in range(3)}
    assert got == want
    keys = CHUNK_COUNTERS + ("prefix_hits", "cached_prefix_tokens",
                             "novel_prefill_tokens", "cow_copies")
    assert {k: summ[k] for k in keys} == {k: jsumm[k] for k in keys}
    assert summ["prefix_hits"] == 2 and summ["cow_copies"] >= 1
    assert eng.allocator.check_refcounts(eng.trie.block_refs())


def test_decode_keeps_streaming_while_a_prompt_fills():
    """A running request emits one token every step while a 40-token
    prompt fills in slices of 8; the filling slot stays out of the
    decode mask (PREFILLING) until its final slice commits."""
    tcf, eng = _port_engine("paged_ring", 8, max_len=96)
    rng = np.random.default_rng(9)
    eng.submit(teng.Request(id=0, prompt=rng.integers(0, tcf.vocab, 8),
                            max_new_tokens=24))
    eng.step()
    assert eng.requests[0].status == teng.RUNNING
    eng.submit(teng.Request(id=1, prompt=rng.integers(0, tcf.vocab, 40),
                            max_new_tokens=4))
    eng.step()
    assert eng.requests[1].status == teng.PREFILLING
    emitted = [len(eng.requests[0].outputs)]
    while eng.requests[1].status == teng.PREFILLING:
        d0 = eng.decode_dispatches
        stats = eng.step()
        assert stats["active"] == 1 or eng.requests[1].status == \
            teng.RUNNING
        assert eng.decode_dispatches - d0 == 1
        emitted.append(len(eng.requests[0].outputs))
    assert all(b - a == 1 for a, b in zip(emitted, emitted[1:]))
    eng.run()
    s = eng.summary()
    assert s["chunk_slices"] == len(tchunk.plan_slices(0, 40, 8))
    assert s["max_chunk_slice_tokens"] <= 8


def test_chunk_config_checks():
    with pytest.raises(ValueError, match="paged pool"):
        _port_engine("paged", 8, block_size=0)
    with pytest.raises(ValueError, match="power-of-two"):
        _port_engine("paged", 12)


def test_serve_cli_sampling_and_chunk_flags(capsys):
    from repro_torch.launch import serve
    summ = serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                       "--prompt-len", "40", "--gen-len", "4",
                       "--max-len", "64", "--max-batch", "2",
                       "--block-size", "8", "--hot-window", "16",
                       "--temperature", "0.8", "--top-k", "5",
                       "--prefill-chunk", "16"])
    assert summ["finished"] == 3
    assert summ["chunked_admissions"] == 3
    assert summ["max_chunk_slice_tokens"] <= 16
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--prefill-chunk",
                    "16"])
    assert "requires --block-size" in capsys.readouterr().err
