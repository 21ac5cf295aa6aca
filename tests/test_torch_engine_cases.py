"""More cases of the port's serving engine against the JAX engine: the
greedy token streams must be identical.

The cases cover a batch of prompts of 5 to 100 tokens with 3 to 28 new
tokens each (more requests than slots, so admission queues), pool
backpressure (12 blocks of 8 tokens), the paged pool without a ring,
dense PAM, retrieval sparsity off, Alg. 2 every step, and micro_steps 3
with on-device EOS. They guard the per-token attention mass, which the
port takes from the decode kernels' scores and which feeds the eq. 7 EMA
and Alg. 2, and so the tiers and the streams.

A request's greedy stream depends on its own prompt only, so the JAX
streams are computed once per JAX engine configuration and shared by
the cases that change only the port's side (pool size, micro-steps,
EOS); the JAX engine's own suite pins its micro-step and EOS streams to
its single-step ones. Reduced qwen3-0.6b, weights from the JAX package's
``init_params`` through ``repro_torch.bridge``; inputs from numpy seeds.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import build_model, make_engine, make_pam  # noqa: E402

from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

torch.set_num_threads(2)

MAX_LEN, MAX_BATCH, BLOCK = 128, 4, 8
PLENS = (5, 17, 33, 47, 60, 68, 81, 100)
NEW = (28, 3, 12, 20, 7, 28, 16, 28)
POLICY = dict(hot=8, warm=8, compression=2)
LAYOUTS = {"paged_ring": dict(block_size=BLOCK, hot_window=16),
           "paged": dict(block_size=BLOCK),
           "dense": dict()}
POOL_BLOCKS = 12          # room for one or two requests at a time

# case: (layout, JAX/port PAM policy changes, port-only ServingConfig)
CASES = {
    "mixed_lengths_paged_ring": ("paged_ring", {}, {}),
    "mixed_lengths_dense": ("dense", {}, {}),
    "backpressure_pool_12": ("paged_ring", {}, dict(pool_blocks=POOL_BLOCKS)),
    "paged_without_ring": ("paged", {}, {}),
    "sparsity_off": ("paged_ring", dict(use_sparsity=False), {}),
    "schedule_interval_1": ("paged_ring", dict(schedule_interval=1), {}),
    "micro_steps_3_eos": ("paged_ring", {}, dict(micro_steps=3)),
}


def _prompts(vocab):
    rng = np.random.default_rng(17)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PLENS]


def _ids(case):
    """Requests of a case: all, or with pool backpressure those whose
    window (prompt + new tokens) fits the 12-block pool."""
    if "pool_blocks" in CASES[case][2]:
        return [i for i, (p, n) in enumerate(zip(PLENS, NEW))
                if -(-(p + n) // BLOCK) <= POOL_BLOCKS]
    return list(range(len(PLENS)))


@pytest.fixture(scope="module")
def model():
    cfg, params = build_model("qwen3-0.6b")
    tcf = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    tparams = bridge.params_from_jax(tcf, _np_tree(params), device="cpu")
    return cfg, params, tcf, tparams


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _jax_streams(layout, policy):
    """Greedy streams of every request from the JAX engine, once per
    (layout, PAM policy change)."""
    cfg, params = build_model("qwen3-0.6b")
    eng = make_engine(cfg, params,
                      pam=make_pam(max_len=MAX_LEN, **POLICY, **dict(policy)),
                      max_batch=MAX_BATCH, max_len=MAX_LEN,
                      **LAYOUTS[layout])
    for i, p in enumerate(_prompts(cfg.vocab)):
        eng.submit(JaxRequest(id=i, prompt=p, max_new_tokens=NEW[i]))
    eng.run()
    return {i: list(eng.requests[i].outputs) for i in range(len(PLENS))}


def _torch_pam(policy):
    j = make_pam(max_len=MAX_LEN, **POLICY, **policy)
    return tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval, use_sparsity=j.use_sparsity)


@pytest.mark.parametrize("case", sorted(CASES))
def test_streams_equal_jax_engine(model, case):
    layout, policy, port_kw = CASES[case]
    tcf, tparams = model[2], model[3]
    ref = _jax_streams(layout, tuple(sorted(policy.items())))
    ids = _ids(case)
    kw = dict(max_batch=MAX_BATCH, max_len=MAX_LEN, **LAYOUTS[layout],
              **port_kw)
    eos = None
    if port_kw.get("micro_steps", 1) > 1:
        # on-device EOS: every request admitted at once, so that early
        # finishes move no admission; the token is one of request 0's
        eos = ref[0][5]
        kw.update(eos_token=eos, max_batch=len(ids))
    eng = teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=_torch_pam(policy), **kw), device="cpu")
    prompts = _prompts(tcf.vocab)
    for i in ids:
        eng.submit(teng.Request(id=i, prompt=prompts[i],
                                max_new_tokens=NEW[i]))
    summ = eng.run()
    got = {i: list(eng.requests[i].outputs) for i in ids}
    want = {i: ref[i] for i in ids}
    if eos is not None:
        want = {i: s[:s.index(eos) + 1] if eos in s else s
                for i, s in want.items()}
        assert len(want[0]) <= 6          # EOS cut request 0 early
    assert got == want
    assert summ["finished"] == len(ids)
    if "pool_blocks" in port_kw:      # the windows cannot all fit at once
        assert sum(-(-(PLENS[i] + NEW[i]) // BLOCK) for i in ids) > \
            POOL_BLOCKS
        assert eng.allocator.num_blocks == POOL_BLOCKS
        assert 0.5 < summ["pool_occupancy_peak"] <= 1.0
