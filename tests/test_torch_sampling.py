"""The port's sampler against ``jax.random`` and the JAX engine's
``_sample_tokens``, and the port engine's sampled token streams against
the JAX engine's.

The random bits must be JAX's own, bit for bit: ``threefry2x32``,
``PRNGKey``, ``fold_in`` and the partitionable ``random_bits`` are held
with ``assert_array_equal``. The floats follow from them: ``uniform`` is
exact; ``gumbel`` takes two fp32 logs, which XLA's CPU code and torch's
round differently by at most one ulp. Tokens are then the same unless
two candidates tie within that rounding.

Engine streams: reduced qwen3-0.6b (paged + ring and dense PAM),
reduced mamba2-780m (dense PAM) and reduced pam-llama-7b (paged + ring),
with temperature and top-k, micro_steps 1 and 8, with and without
on-device EOS; exact-length prefill
(``bucket_prefill=False``); PAM tiering off. Each JAX engine
configuration runs once (its compile is the cost) at micro_steps 1; the
JAX suite pins its micro-step streams to its single-step ones, and a
request's sampled stream depends on its own (seed, rid, positions,
logits) only, so the port's micro-step and EOS variants are held to
those streams. Weights come from the JAX package's ``init_params``
through ``repro_torch.bridge``; every input from a fixed numpy seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import build_model, make_engine, make_pam  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving.engine import _sample_tokens  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402
from repro_torch.serving import sampling as S  # noqa: E402

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)
SEEDS = (0, 7, 123456789, 2**31 - 1, 2**32 + 5, -1)
RIDS = (0, 1, 5, 2**31 + 3, 2**32 - 1)
POSITIONS = (0, 3, 100, 2047, 65535)


def test_jax_draws_partitionable_bits():
    """The port reproduces the partitionable scheme (each element's
    counter its flat index); a JAX default change would fail here."""
    assert jax.config.jax_threefry_partitionable


def _keys():
    """(seed, rid, pos) -> the JAX key of fold_in(fold_in(PRNGKey(seed),
    rid), pos), as numpy words."""
    out = {}
    for seed in SEEDS:
        base = jax.random.PRNGKey(seed)
        for rid in RIDS:
            k_r = jax.random.fold_in(base, np.uint32(rid))
            for pos in POSITIONS:
                out[seed, rid, pos] = jax.random.fold_in(k_r, np.uint32(pos))
    return out


@pytest.fixture(scope="module")
def jax_keys():
    return _keys()


def test_threefry2x32_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    for _ in range(4):
        k = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
        x = rng.integers(0, 2**32, (2, 257), dtype=np.uint64).astype(
            np.uint32)
        want = jprng.threefry2x32_p.bind(
            jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(x[0]),
            jnp.asarray(x[1]))
        got = S.threefry2x32(int(k[0]), int(k[1]),
                             torch.as_tensor(x[0].astype(np.int64)),
                             torch.as_tensor(x[1].astype(np.int64)))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                          g.numpy())


def test_prng_key_and_fold_in_match_jax(jax_keys):
    for seed in SEEDS:
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))),
            np.array(S.prng_key(seed), np.uint32))
    for (seed, rid, pos), key in jax_keys.items():
        got = S.fold_in(S.fold_in(S.prng_key(seed), rid), pos)
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(key)),
                                      np.array(got, np.uint32))


def test_batched_fold_in_matches_scalar(jax_keys):
    """The engine folds (B,) tensors of rids and positions at once."""
    trip = sorted(jax_keys)
    rids = torch.tensor([r for _, r, _ in trip], dtype=torch.int64)
    pos = torch.tensor([p for _, _, p in trip], dtype=torch.int64)
    for seed in SEEDS:
        rows = [i for i, t in enumerate(trip) if t[0] == seed]
        k1, k2 = S.fold_in(S.fold_in(S.prng_key(seed), rids[rows]),
                           pos[rows])
        want = np.stack([np.asarray(jax.random.key_data(jax_keys[trip[i]]))
                         for i in rows])
        np.testing.assert_array_equal(want[:, 0], k1.numpy())
        np.testing.assert_array_equal(want[:, 1], k2.numpy())


@pytest.mark.parametrize("n", [1001, 151936])
def test_random_bits_and_uniform_match_jax(jax_keys, n):
    """Partitionable 32-bit draws over a vocab that is not a power of two
    (151,936 is qwen3's), bit for bit, and the uniform floats exactly."""
    picks = [k for i, k in enumerate(sorted(jax_keys)) if i % 23 == 0]
    for trip in picks:
        key = jax_keys[trip]
        tkey = S.fold_in(S.fold_in(S.prng_key(trip[0]), trip[1]), trip[2])
        bits = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
        np.testing.assert_array_equal(bits.astype(np.int64),
                                      S.random_bits(tkey, n, "cpu").numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(key, (n,))),
            S.uniform(tkey, n, "cpu").numpy())


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_gumbel_matches_jax_within_one_ulp(jax_keys):
    """The uniform draw is exact and the inner ``-log(u)`` within 1 ulp
    of XLA's; the Gumbel value within that ulp carried through the outer
    log plus 1 ulp of its own: |diff| <= eps * (1 + |g|)."""
    tiny = float(np.finfo(np.float32).tiny)
    n = 4096
    for trip in sorted(jax_keys)[::17]:
        key = jax_keys[trip]
        tkey = S.fold_in(S.fold_in(S.prng_key(trip[0]), trip[1]), trip[2])
        u = S.uniform(tkey, n, "cpu", tiny, 1.0)
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(key, (n,), minval=tiny)),
            u.numpy())
        inner = np.asarray(jax.jit(lambda x: -jnp.log(x))(u.numpy()))
        assert _ulps(inner, (-torch.log(u)).numpy()).max() <= 1
        want = np.asarray(jax.random.gumbel(key, (n,)))
        got = S.gumbel(tkey, n, "cpu").numpy()
        assert np.all(np.abs(got - want) <= EPS32 * (1 + np.abs(want)))


@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_tokens_matches_reference(temperature, top_k):
    """Token for token against the reference's ``_sample_tokens`` under
    jit, as the engine runs it (XLA turns the temperature division into
    a product with the fp32 reciprocal)."""
    ref = jax.jit(_sample_tokens, static_argnums=(1, 4, 5))
    rng = np.random.default_rng(int(temperature * 10) * 7 + top_k)
    for trial in range(6):
        B, V = 16, 1001
        logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
        logits[0, :4] = logits[0].max()             # ties at the top
        rids = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
        pos = rng.integers(0, 4096, B).astype(np.int32)
        seed = int(rng.integers(0, 2**31))
        want = np.asarray(ref(jnp.asarray(logits), seed, jnp.asarray(rids),
                              jnp.asarray(pos), temperature, top_k))
        got = S.sample_tokens(torch.as_tensor(logits), seed,
                              torch.as_tensor(rids.astype(np.int64)),
                              torch.as_tensor(pos), temperature, top_k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy())


# ------------------------------------------------------ engine streams
MAX_LEN = 64
N_REQ, NEW = 5, 12
SAMPLED = dict(temperature=0.8, top_k=8, sample_seed=3)
POLICY = dict(hot=8, warm=8, compression=2)
# case: (arch, JAX-side ServingConfig, JAX PAM policy change)
LAYOUTS = {
    "qwen_paged_ring": ("qwen3-0.6b", dict(block_size=8, hot_window=16),
                        {}),
    "qwen_dense_pam": ("qwen3-0.6b", {}, {}),
    "mamba_dense_pam": ("mamba2-780m", {}, {}),
    "qwen_exact_len": ("qwen3-0.6b", dict(block_size=8, hot_window=16,
                                          bucket_prefill=False), {}),
    "qwen_tiering_off": ("qwen3-0.6b", dict(block_size=8, hot_window=16),
                         dict(use_tiering=False)),
    "llama_paged_ring": ("pam-llama-7b", dict(block_size=8, hot_window=16),
                         {}),
}
PLENS = (5, 9, 14, 20, 27)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _torch_model(arch):
    cfg, params = build_model(arch)
    tcf = tcfg.reduced(tcfg.get_config(arch))
    return tcf, bridge.params_from_jax(tcf, _np_tree(params), device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(23)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PLENS]


@functools.lru_cache(maxsize=None)
def _jax_streams(layout):
    arch, scfg_kw, policy = LAYOUTS[layout]
    cfg, params = build_model(arch)
    eng = make_engine(cfg, params,
                      pam=make_pam(max_len=MAX_LEN, **POLICY, **policy),
                      max_batch=N_REQ, max_len=MAX_LEN, **SAMPLED,
                      **scfg_kw)
    for i, p in enumerate(_prompts(cfg.vocab)):
        eng.submit(JaxRequest(id=i, prompt=p, max_new_tokens=NEW))
    eng.run()
    return {i: list(eng.requests[i].outputs) for i in range(N_REQ)}


def _torch_engine(layout, **port_kw):
    arch, scfg_kw, policy = LAYOUTS[layout]
    tcf, tparams = _torch_model(arch)
    j = make_pam(max_len=MAX_LEN, **POLICY, **policy)
    pam = tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval, use_tiering=j.use_tiering)
    kw = dict(max_batch=N_REQ, max_len=MAX_LEN, **SAMPLED, **scfg_kw)
    kw.update(port_kw)
    return tcf, teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=pam, **kw), device="cpu")


def _run(tcf, eng):
    for i, p in enumerate(_prompts(tcf.vocab)):
        eng.submit(teng.Request(id=i, prompt=p, max_new_tokens=NEW))
    summ = eng.run()
    return {i: list(eng.requests[i].outputs) for i in range(N_REQ)}, summ


@pytest.mark.parametrize("micro", [1, 8])
@pytest.mark.parametrize("layout", ["qwen_paged_ring", "qwen_dense_pam",
                                    "mamba_dense_pam", "llama_paged_ring"])
def test_sampled_streams_equal_jax_engine(layout, micro):
    ref = _jax_streams(layout)
    tcf, eng = _torch_engine(layout, micro_steps=micro)
    got, summ = _run(tcf, eng)
    assert got == ref
    assert summ["finished"] == N_REQ
    # sampling is live: the streams are not the greedy ones
    tcf, greedy = _torch_engine(layout, temperature=0.0, top_k=0,
                                sample_seed=0)
    assert _run(tcf, greedy)[0] != ref


@pytest.mark.parametrize("micro", [1, 8])
@pytest.mark.parametrize("layout", ["qwen_paged_ring", "qwen_dense_pam",
                                    "mamba_dense_pam"])
def test_sampled_streams_equal_jax_engine_with_eos(layout, micro):
    """On-device EOS at a sampled token of request 0: each stream is the
    EOS-free JAX stream cut after its first EOS."""
    ref = _jax_streams(layout)
    eos = ref[0][4]
    tcf, eng = _torch_engine(layout, micro_steps=micro, eos_token=eos)
    got, summ = _run(tcf, eng)
    for rid, stream in ref.items():
        cut = stream.index(eos) + 1 if eos in stream else len(stream)
        assert got[rid] == stream[:cut], rid
    assert len(got[0]) <= 5
    assert summ["finished"] == N_REQ


@pytest.mark.parametrize("micro", [1, 8])
def test_exact_length_prefill_streams_equal_jax_engine(micro):
    """``bucket_prefill=False``: each prompt prefills at its own length
    (five lengths, five prefills), sampled streams unchanged."""
    ref = _jax_streams("qwen_exact_len")
    tcf, eng = _torch_engine("qwen_exact_len", micro_steps=micro)
    got, summ = _run(tcf, eng)
    assert got == ref
    assert summ["prefill_dispatches"] == len(set(PLENS))
    assert ref == _jax_streams("qwen_paged_ring")   # buckets change nothing


def test_sampled_streams_with_tiering_off_equal_jax_engine():
    ref = _jax_streams("qwen_tiering_off")
    tcf, eng = _torch_engine("qwen_tiering_off")
    got, summ = _run(tcf, eng)
    assert got == ref
    assert summ["moved_tokens"] == 0                 # Alg. 2 is off


def test_sampled_stream_independent_of_batch():
    """A sampled stream run alone equals the same request's stream in the
    batch, admitted late into another slot."""
    tcf, tparams = _torch_model("qwen3-0.6b")
    prompts = _prompts(tcf.vocab)
    _, batch = _torch_engine("qwen_paged_ring")
    together = _run(tcf, batch)[0]
    _, solo = _torch_engine("qwen_paged_ring")
    solo.submit(teng.Request(id=3, prompt=prompts[3], max_new_tokens=NEW))
    solo.run()
    assert solo.requests[3].outputs == together[3]
    _, late = _torch_engine("qwen_paged_ring", max_batch=2)
    late.submit(teng.Request(id=0, prompt=prompts[0], max_new_tokens=NEW))
    for _ in range(3):
        late.step()
    late.submit(teng.Request(id=3, prompt=prompts[3], max_new_tokens=NEW))
    late.run()
    assert late.requests[3].outputs == together[3]
