"""The port's prefix cache against the JAX package's.

* The refcounted ``BlockAllocator`` and the ``PrefixTrie``: the
  operation sequences of the reference's own suite
  (``tests/test_prefix_sharing.py``) run on the JAX objects and on the
  port's, which must give the same returns, refcounts, free lists,
  lookups and eviction order; then the reference's assertions.
* The interleaving invariant suite (admit / fork / append / finish /
  re-admit / evict against a content oracle) over a fixed list of
  seeds, the port's objects in lockstep with the JAX ones.
* ``copy_block``, ``gather_sequence``, ``gather_prefix_logical``,
  ``attention_prefill_with_prefix`` and ``prefill_suffix`` against the
  JAX functions at fp32 (atol 1e-5).
* Engine token streams and prefix counters equal to the JAX engine's:
  staggered prefix twins with full-block and mid-block hits (so CoW
  runs), greedy and sampled, on paged + ring and paged pools;
  micro_steps 5; trie eviction under ``pool_blocks`` pressure; a shared
  admission that fits where an unshared one cannot; the ``ValueError``
  checks.

Reduced qwen3-0.6b, weights from the JAX package's ``init_params``
through ``repro_torch.bridge``; every input from a fixed numpy seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import build_model, make_engine, make_pam  # noqa: E402

from repro.core import pam_interface as jpi  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import paged_kv as jpkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import pam_interface as tpi  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import paged_kv as tpkv  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

torch.set_num_threads(2)

MODULES = {"jax": jpkv, "port": tpkv}


# ------------------------------------------- allocator and trie in lockstep
def _state(alloc, trie=None):
    """What the two packages must agree on after an operation."""
    out = (dict(alloc.refcount), list(alloc._free),
           {k: list(v) for k, v in alloc.tables.items()})
    if trie is not None:
        out += (trie.block_refs(), trie.evictions, trie.hits)
    return out


def _adopt_shares_and_free_decrefs(m, log):
    alloc = m.BlockAllocator(num_blocks=8, block_size=4)
    t0 = list(alloc.allocate(0, 12))
    alloc.adopt(1, t0[:2])
    alloc.allocate(1, 12)
    log.append(_state(alloc))
    assert alloc.refcount[t0[0]] == 2
    assert alloc.used_blocks == 4
    log.append(alloc.free(0))
    assert alloc.refcount[t0[0]] == 1
    log.append(alloc.free(1))
    assert alloc.free_blocks == 8 and alloc.check_refcounts()
    log.append(_state(alloc))


def _free_unknown_is_noop_and_double_decref_raises(m, log):
    alloc = m.BlockAllocator(num_blocks=4, block_size=4)
    log.append(alloc.free(99))
    tbl = list(alloc.allocate(0, 4))
    log.append((alloc.free(0), alloc.free(0)))
    with pytest.raises(ValueError, match="double free"):
        alloc.decref(tbl[0])
    with pytest.raises(ValueError):
        alloc.incref(tbl[0])
    assert alloc.check_refcounts()
    log.append(_state(alloc))


def _admit_shared_is_atomic(m, log):
    alloc = m.BlockAllocator(num_blocks=4, block_size=4)
    t0 = list(alloc.allocate(0, 8))
    before = _state(alloc)
    with pytest.raises(m.OutOfBlocks):
        alloc.admit_shared(1, t0, 9 * 4)
    assert _state(alloc) == before and 1 not in alloc.tables
    log.append(_state(alloc))


def _backpressure_counts_shared_once(m, log):
    alloc = m.BlockAllocator(num_blocks=6, block_size=4)
    t0 = list(alloc.allocate(0, 16))
    alloc.admit_shared(1, t0[:3], 16)
    assert alloc.used_blocks == 5 and alloc.free_blocks == 1
    with pytest.raises(m.OutOfBlocks):
        alloc.allocate(2, 8)
    alloc.allocate(2, 4)
    assert alloc.check_refcounts()
    log.append(_state(alloc))


def _checker_catches_corruption(m, log):
    alloc = m.BlockAllocator(num_blocks=4, block_size=4)
    alloc.allocate(0, 8)
    checks = [alloc.check_refcounts()]
    alloc.refcount[alloc.table(0)[0]] += 1
    checks.append(alloc.check_refcounts())
    alloc.refcount[alloc.table(0)[0]] -= 1
    alloc.tables[0].append(alloc.tables[0][0])
    checks.append(alloc.check_no_double_mapping())
    alloc.tables[0].pop()
    alloc._free.append(alloc.table(0)[1])
    checks.append(alloc.check_refcounts())
    assert checks == [True, False, False, False]
    log.append(checks)


def _trie_roundtrip_full_and_partial(m, log):
    alloc = m.BlockAllocator(32, 4)
    trie = m.PrefixTrie(4, alloc)
    toks = list(range(10))
    tbl = list(alloc.allocate(0, 14))
    log.append(trie.insert(toks, tbl))
    for q in (toks, toks[:6], [99] + toks):
        log.append(trie.lookup(q))
    assert log[-3] == (10, tbl[:3]) and log[-2] == (6, tbl[:2])
    assert log[-1] == (0, [])
    alloc.free(0)
    assert alloc.used_blocks == 3
    assert alloc.check_refcounts(trie.block_refs())
    log.append(_state(alloc, trie))


def _trie_eviction_lru_leaf_first(m, log):
    alloc = m.BlockAllocator(8, 4)
    trie = m.PrefixTrie(4, alloc)
    a = list(range(8))
    b = list(range(4)) + [9, 9, 9, 9]
    trie.insert(a, alloc.allocate(0, 8))
    trie.insert(b, alloc.allocate(1, 8))
    alloc.free(0)
    log.append(trie.lookup(a))
    log.append(trie.evict(10))
    assert log[-1] == 1
    log.append((trie.lookup(b)[0], trie.lookup(a)[0]))
    assert log[-1] == (8, 4)
    assert alloc.check_refcounts(trie.block_refs())
    log.append(_state(alloc, trie))


def _trie_interior_nodes_survive(m, log):
    alloc = m.BlockAllocator(8, 4)
    trie = m.PrefixTrie(4, alloc)
    toks = list(range(12))
    trie.insert(toks, alloc.allocate(0, 12))
    alloc.free(0)
    log.append(trie.evict(1))
    log.append(trie.lookup(toks))
    assert log[-2] == 1 and log[-1][0] == 8
    log.append(_state(alloc, trie))


def _trie_lru_order_over_many_entries(m, log):
    """Eviction order among several trie-only leaves and partials
    follows the lookup stamps."""
    alloc = m.BlockAllocator(24, 4)
    trie = m.PrefixTrie(4, alloc)
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(0, 50, n)))
               for n in (6, 9, 13, 4, 17)]
    for i, p in enumerate(prompts):
        trie.insert(p, alloc.allocate(i, len(p) + 2))
        alloc.free(i)
    for p in (prompts[3], prompts[0], prompts[4]):
        log.append(trie.lookup(p))
    while trie.num_blocks:
        log.append((trie.evict(1), sorted(trie.block_refs())))
    assert alloc.free_blocks == alloc.num_blocks
    log.append(_state(alloc, trie))


SCENARIOS = {f.__name__.strip("_"): f for f in (
    _adopt_shares_and_free_decrefs,
    _free_unknown_is_noop_and_double_decref_raises,
    _admit_shared_is_atomic, _backpressure_counts_shared_once,
    _checker_catches_corruption, _trie_roundtrip_full_and_partial,
    _trie_eviction_lru_leaf_first, _trie_interior_nodes_survive,
    _trie_lru_order_over_many_entries)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_allocator_and_trie_match_reference(name):
    logs = {}
    for pkg, m in MODULES.items():
        logs[pkg] = []
        SCENARIOS[name](m, logs[pkg])
    assert logs["port"] == logs["jax"]


# ------------------------------------------------ interleaving invariants
def _drive_interleaving(m, seed, steps=40):
    """The reference suite's host model of the engine's admission / CoW
    protocol on the objects of package ``m``, asserting refcount
    conservation, no write to a shared block and content exactness after
    every operation. Returns the trace of states to compare."""
    rng = np.random.default_rng(seed)
    bs = 4
    alloc = m.BlockAllocator(num_blocks=24, block_size=bs)
    trie = m.PrefixTrie(bs, alloc)
    content: dict[int, list] = {}
    live: dict[int, dict] = {}
    past: list[list[int]] = []
    next_rid = [0]
    trace = []
    prefixes = [list(map(int, rng.integers(0, 5, 8))) for _ in range(3)]

    def table_refs(b):
        return alloc.refcount.get(b, 0) - trie.block_refs().get(b, 0)

    def write(rid, p, tok):
        b = alloc.table(rid)[p // bs]
        assert table_refs(b) == 1, f"write to shared block {b}"
        c = content.setdefault(b, [])
        while len(c) <= p % bs:
            c.append(None)
        c[p % bs] = tok

    def admit(toks, *, via_trie=True):
        rid = next_rid[0]
        next_rid[0] += 1
        window = len(toks) + int(rng.integers(1, 9))
        if alloc.blocks_for(window) > alloc.num_blocks:
            return
        matched, ids = trie.lookup(toks) if via_trie else (0, [])
        matched = min(matched, len(toks) - 1)
        trace.append((matched, list(ids)))
        nfull = matched // bs
        shared, cow = ids[:nfull], matched % bs > 0
        cow_src = ids[nfull] if cow else -1
        try:
            alloc.adopt(rid, shared)
            if cow:
                alloc.incref(cow_src)
            need = alloc.blocks_for(window) - len(shared)
            if need > alloc.free_blocks:
                trie.evict(need - alloc.free_blocks)
            alloc.allocate(rid, window)
        except m.OutOfBlocks:
            if cow:
                alloc.decref(cow_src)
            alloc.free(rid)
            assert alloc.check_refcounts(trie.block_refs())
            return
        tbl = alloc.table(rid)
        for b in tbl[len(shared):]:
            content[b] = []
        if cow:
            content[tbl[nfull]] = list(content[cow_src])
            alloc.decref(cow_src)
        for p in range(matched, len(toks)):
            write(rid, p, toks[p])
        trie.insert(toks, tbl)
        live[rid] = {"toks": list(toks), "prompt": len(toks),
                     "window": window}
        past.append(list(toks))

    def check_all():
        assert alloc.check_refcounts(trie.block_refs())
        for rid, info in live.items():
            tbl = alloc.table(rid)
            got = [content[tbl[p // bs]][p % bs]
                   for p in range(len(info["toks"]))]
            assert got == info["toks"], f"rid {rid} content diverged"
        stack = [trie.root]
        while stack:
            node = stack.pop()
            for key, child in node.children.items():
                assert content[child.block][:bs] == list(key)
                stack.append(child)
            for key, entry in node.partials.items():
                assert content[entry[0]][:len(key)] == list(key)
        trace.append(_state(alloc, trie))

    for _ in range(steps):
        op = rng.choice(["admit", "fork", "append", "finish", "readmit",
                         "evict"], p=[.3, .2, .25, .1, .08, .07])
        if op == "admit":
            pre = prefixes[rng.integers(len(prefixes))]
            admit(pre + list(map(int, rng.integers(0, 5,
                                                   rng.integers(1, 9)))))
        elif op == "fork" and past:
            admit(list(past[rng.integers(len(past))]))
        elif op == "append" and live:
            rid = int(rng.choice(sorted(live)))
            info = live[rid]
            if len(info["toks"]) < info["window"]:
                tok = int(rng.integers(0, 5))
                info["toks"].append(tok)
                write(rid, len(info["toks"]) - 1, tok)
        elif op == "finish" and live:
            rid = int(rng.choice(sorted(live)))
            alloc.free(rid)
            del live[rid]
        elif op == "readmit" and live:
            # a request re-admitted with fresh blocks only (the prompt
            # republished), as a migration import would do
            rid = int(rng.choice(sorted(live)))
            info = live.pop(rid)
            alloc.free(rid)
            nrid = next_rid[0]
            next_rid[0] += 1
            need = alloc.blocks_for(info["window"])
            if need > alloc.free_blocks:
                trie.evict(need - alloc.free_blocks)
            try:
                alloc.allocate(nrid, info["window"])
            except m.OutOfBlocks:
                check_all()
                continue
            for b in alloc.table(nrid):
                content[b] = []
            for p, tok in enumerate(info["toks"]):
                write(nrid, p, tok)
            trie.insert(info["toks"][:info["prompt"]], alloc.table(nrid))
            live[nrid] = info
        elif op == "evict":
            trace.append(trie.evict(int(rng.integers(1, 4))))
        check_all()
    for rid in sorted(live):
        alloc.free(rid)
    assert alloc.check_refcounts(trie.block_refs())
    trace.append(trie.evict(alloc.num_blocks))
    assert alloc.free_blocks == alloc.num_blocks
    return trace


@pytest.mark.parametrize("seed", list(range(40)))
def test_interleaving_invariants_in_lockstep(seed):
    """40 fixed seeds (no free draw): the invariants hold on the port's
    objects, which trace the JAX objects' states op for op."""
    assert _drive_interleaving(tpkv, seed) == _drive_interleaving(jpkv, seed)


# ------------------------------------------------ device-side functions
def _pool(seed=0, L=2, nb_pool=12, bs=4, hkv=2, dh=8):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((L, nb_pool + 1, bs, hkv, dh)).astype(
        np.float32)


def test_copy_block_and_gather_sequence_match_reference():
    pool = _pool()
    rows = np.array([[3, 7, 1, 12], [0, 5, 12, 12]], np.int32)
    for src, dst in ((2, 9), (12, 12), (4, 4)):
        want = np.asarray(jpkv.copy_block(jnp.asarray(pool), src, dst))
        got = torch.as_tensor(pool.copy())
        tpkv.copy_block(got, src, dst)
        np.testing.assert_array_equal(want, got.numpy())
    for row in rows:
        np.testing.assert_array_equal(
            np.asarray(jpkv.gather_sequence(jnp.asarray(pool),
                                            jnp.asarray(row))),
            tpkv.gather_sequence(torch.as_tensor(pool),
                                 torch.as_tensor(row)).numpy())
    batched = tpkv.gather_sequence(torch.as_tensor(pool),
                                   torch.as_tensor(rows))
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(
            np.asarray(jpkv.gather_sequence(jnp.asarray(pool),
                                            jnp.asarray(row))),
            batched[:, i].numpy())


def test_gather_prefix_logical_matches_reference():
    pool = _pool(1)
    rows = np.array([[3, 7, 1, 12], [0, 5, 12, 12], [8, 2, 6, 11]],
                    np.int32)
    lens = np.array([13, 5, 0], np.int32)
    for row, n in zip(rows, lens):
        want = np.asarray(jpi.gather_prefix_logical(
            jnp.asarray(pool), jnp.asarray(row), jnp.int32(n)))
        got = tpi.gather_prefix_logical(torch.as_tensor(pool),
                                        torch.as_tensor(row), int(n))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    batched = tpi.gather_prefix_logical(
        torch.as_tensor(pool), torch.as_tensor(rows), torch.as_tensor(lens))
    for i, (row, n) in enumerate(zip(rows, lens)):
        want = np.asarray(jpi.gather_prefix_logical(
            jnp.asarray(pool), jnp.asarray(row), jnp.int32(n)))
        np.testing.assert_allclose(batched[:, i].numpy(), want, rtol=0,
                                   atol=1e-5)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _torch_model():
    cfg, params = build_model("qwen3-0.6b")
    tcf = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    return tcf, bridge.params_from_jax(tcf, _np_tree(params), device="cpu")


def test_attention_prefill_with_prefix_matches_reference():
    cfg, params = build_model("qwen3-0.6b")
    tcf, tparams = _torch_model()
    rng = np.random.default_rng(5)
    B, S, P = 3, 7, 24
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pk = rng.standard_normal((B, cfg.n_kv_heads, P, cfg.head_dim)).astype(
        np.float32)
    pv = rng.standard_normal(pk.shape).astype(np.float32)
    plen = np.array([0, 11, 24], np.int32)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    want = jattn.attention_prefill_with_prefix(
        jtf._attn_params(lp), jnp.asarray(x), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(plen), n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
        rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps)
    tlp = ttf._layers(tparams)[0]
    got = tattn.attention_prefill_with_prefix(
        ttf._attn_params(tlp), torch.as_tensor(x), torch.as_tensor(pk),
        torch.as_tensor(pv), torch.as_tensor(plen), n_heads=tcf.n_heads,
        n_kv=tcf.n_kv_heads, d_head=tcf.head_dim,
        rope_theta=tcf.rope_theta, rms_eps=tcf.rms_eps)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_prefill_suffix_matches_reference_and_full_prefill():
    """``prefill_suffix`` over a prefix gathered from a pool equals the
    JAX function, and (by causality) the full prefill's logits and K/V
    at the suffix positions."""
    cfg, params = build_model("qwen3-0.6b")
    tcf, tparams = _torch_model()
    rng = np.random.default_rng(8)
    S = 16
    prompts = rng.integers(0, cfg.vocab, (3, 40)).astype(np.int32)
    plen = np.array([0, 12, 29], np.int32)
    slen = np.array([16, 9, 11], np.int32)
    _, full = ttf.prefill(tcf, tparams, torch.as_tensor(prompts), 64)
    toks = np.zeros((3, S), np.int32)
    for i in range(3):
        toks[i, :slen[i]] = prompts[i, plen[i]:plen[i] + slen[i]]
    pk = full.k.clone()
    pv = full.v.clone()
    for i in range(3):                 # only the cached prefix is live
        pk[:, i, :, plen[i]:] = 0
        pv[:, i, :, plen[i]:] = 0
    want = jtf.prefill_suffix(cfg, params, jnp.asarray(toks),
                              jnp.asarray(pk.numpy()),
                              jnp.asarray(pv.numpy()), jnp.asarray(plen),
                              true_len=jnp.asarray(slen))
    got = ttf.prefill_suffix(tcf, tparams, torch.as_tensor(toks), pk, pv,
                             torch.as_tensor(plen),
                             true_len=torch.as_tensor(slen))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    for i in range(3):
        ref_logits, _ = ttf.prefill(
            tcf, tparams,
            torch.as_tensor(prompts[i:i + 1, :plen[i] + slen[i]]), 64)
        np.testing.assert_allclose(got[0][i].numpy(),
                                   ref_logits[0].numpy(), rtol=0, atol=1e-4)
        np.testing.assert_allclose(
            got[1][:, i, :, :slen[i]].numpy(),
            full.k[:, i, :, plen[i]:plen[i] + slen[i]].numpy(), rtol=0,
            atol=1e-4)


def test_prefill_suffix_refuses_the_ssm_family():
    cfg = tcfg.reduced(tcfg.get_config("mamba2-780m"))
    with pytest.raises(ValueError, match="token-only GQA"):
        ttf.prefill_suffix(cfg, {}, torch.zeros((1, 4), dtype=torch.long),
                           None, None, 0)


# ------------------------------------------------------- engine streams
MAX_LEN, BLOCK = 64, 8
POLICY = dict(hot=16, warm=24)
LAYOUTS = {"paged_ring": dict(block_size=BLOCK, hot_window=16),
           "paged": dict(block_size=BLOCK)}
SAMPLED = dict(temperature=0.8, top_k=8, sample_seed=3)


def _shared_prompts(vocab, seed=7):
    """1-3 share a 20-token prefix (mid-block hits: CoW), 4 duplicates 1
    (a full-prompt hit, capped one short), 5 is unrelated, 6 shares only
    the first 16 tokens (a full-block hit, no CoW)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 20)
    p = {i: np.concatenate([shared, rng.integers(0, vocab, 6)])
         for i in (1, 2, 3)}
    p[4] = p[1].copy()
    p[5] = rng.integers(0, vocab, 5)
    p[6] = np.concatenate([shared[:16], rng.integers(0, vocab, 10)])
    return {i: v.astype(np.int32) for i, v in p.items()}


COUNTERS = ("prefix_hits", "cached_prefix_tokens", "novel_prefill_tokens",
            "cow_copies", "trie_blocks", "trie_evictions",
            "prefill_dispatches", "admit_dispatches")


@functools.lru_cache(maxsize=None)
def _jax_run(layout, cache, sampled, pool=None, max_batch=2, new=10,
             micro=1):
    cfg, params = build_model("qwen3-0.6b")
    eng = make_engine(cfg, params, pam=make_pam(max_len=MAX_LEN, **POLICY),
                      max_batch=max_batch, max_len=MAX_LEN,
                      prefix_cache=cache, pool_blocks=pool,
                      micro_steps=micro, **LAYOUTS[layout],
                      **(SAMPLED if sampled else {}))
    prompts = _shared_prompts(cfg.vocab)
    for i in sorted(prompts):
        eng.submit(JaxRequest(id=i, prompt=prompts[i], max_new_tokens=new))
    summ = eng.run()
    return ({i: list(eng.requests[i].outputs) for i in prompts},
            {k: summ.get(k) for k in COUNTERS})


def _port_run(layout, cache, sampled, pool=None, max_batch=2, new=10,
              micro=1):
    tcf, tparams = _torch_model()
    j = make_pam(max_len=MAX_LEN, **POLICY)
    pam = tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval)
    eng = teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=pam, max_batch=max_batch, max_len=MAX_LEN, prefix_cache=cache,
        pool_blocks=pool, micro_steps=micro, **LAYOUTS[layout],
        **(SAMPLED if sampled else {})), device="cpu")
    prompts = _shared_prompts(tcf.vocab)
    for i in sorted(prompts):
        eng.submit(teng.Request(id=i, prompt=prompts[i], max_new_tokens=new))
    summ = eng.run()
    if cache:
        assert eng.allocator.check_refcounts(eng.trie.block_refs())
    return ({i: list(eng.requests[i].outputs) for i in prompts},
            {k: summ.get(k) for k in COUNTERS}, eng)


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_staggered_prefix_twins_equal_jax_engine(layout, sampled):
    """Later waves hit the prefixes earlier ones published (mid-block
    hits copy-on-write their tail, a 16-token hit maps whole blocks):
    streams and counters equal the JAX engine's, and the streams equal
    the cache-off twin's."""
    want, want_c = _jax_run(layout, True, sampled)
    got, got_c, eng = _port_run(layout, True, sampled)
    assert got == want
    assert got_c == want_c
    assert got_c["prefix_hits"] >= 3 and got_c["cow_copies"] >= 2
    assert got == _jax_run(layout, False, sampled)[0]
    assert eng.summary()["pool_occupancy_now"] > 0      # trie-held blocks


def test_prefix_cache_micro_steps_5_equals_jax_engine():
    """micro_steps 5 (dispatches of 4, 1 steps): admissions land at other
    steps, so other prefixes are cached; streams stay the single-step
    ones, and the counters equal the JAX micro-step engine's."""
    want = _jax_run("paged_ring", True, False)[0]
    got, got_c, _ = _port_run("paged_ring", True, False, micro=5)
    assert got == want
    assert got_c == _jax_run("paged_ring", True, False, micro=5)[1]
    assert got_c["prefix_hits"] > 0


def test_trie_eviction_under_pool_pressure_equals_jax_engine():
    """A 9-block pool: admissions evict trie-only cached blocks instead
    of waiting forever; streams and eviction counts equal the JAX
    engine's."""
    want, want_c = _jax_run("paged", True, False, pool=9, max_batch=1)
    got, got_c, eng = _port_run("paged", True, False, pool=9, max_batch=1)
    assert got == want and got_c == want_c
    assert got_c["trie_evictions"] > 0
    assert got == _jax_run("paged", False, False, pool=9, max_batch=1)[0]


def test_shared_admission_fits_where_unshared_cannot():
    """A 6-block pool serves a 24-token prompt (4-block window) and its
    duplicate at once only with the prefix cache: shared blocks count
    once. Streams equal the cache-off run's."""
    tcf, tparams = _torch_model()
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, tcf.vocab, 24).astype(np.int32)
    j = make_pam(max_len=MAX_LEN, **POLICY)
    pam = tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval)
    both, streams = {}, {}
    for cache in (False, True):
        eng = teng.ServingEngine(tcf, tparams, teng.ServingConfig(
            pam=pam, max_batch=2, max_len=MAX_LEN, block_size=BLOCK,
            pool_blocks=6, prefix_cache=cache), device="cpu")
        for i in (0, 1):
            eng.submit(teng.Request(id=i, prompt=prompt, max_new_tokens=8))
        seen = False
        while any(s is not None for s in eng.slots) or eng.waiting:
            eng.step()
            if sum(s is not None for s in eng.slots) == 2:
                seen = True
                assert eng.allocator.used_blocks < sum(
                    len(t) for t in eng.allocator.tables.values())
        both[cache] = seen
        streams[cache] = [eng.requests[i].outputs for i in (0, 1)]
    assert both[True] and not both[False]
    assert streams[True] == streams[False]
    assert streams[True][0] == streams[True][1]


def test_prefix_cache_config_checks():
    tcf, tparams = _torch_model()
    with pytest.raises(ValueError, match="paged pool"):
        teng.ServingEngine(tcf, tparams, teng.ServingConfig(
            max_batch=2, max_len=MAX_LEN, prefix_cache=True,
            pam=tpm.PAMManagerConfig(max_tokens=MAX_LEN, hot_capacity=8,
                                     warm_capacity=16)), device="cpu")
