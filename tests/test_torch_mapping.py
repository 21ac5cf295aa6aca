"""The port's §6.1 mapping, §6.2 migration interface, paged pool object
and ``PAMManager`` against the JAX package's, on the CPU.

``repro_torch.core.mapping`` (greedy bank-group balance, loads,
imbalance, the activation window), ``core.pam_interface`` (migration
plans and their application, tag migration, ring promotion, paged <->
dense, bank interleaving), ``serving.paged_kv``'s ``PagedKVPool``,
``sequence_to_blocks``, ``gather_logical`` and ``token_to_block_slot``,
and ``serving.pam_manager.PAMManager`` take the same numpy inputs as
their ``repro`` counterparts (fixed seeds, parametrized cases) and must
give their results: integer outputs (assignments, plans, tags, slots)
exactly, fp32 values at rtol / atol 2e-5. The cases of the reference's
``tests/test_kv_management.py`` (mapping and interface parts) and
``tests/test_serving.py`` (pool and manager parts) are here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import mapping as jmap  # noqa: E402
from repro.core import pam_interface as jpif  # noqa: E402
from repro.serving import paged_kv as jpkv  # noqa: E402
from repro.serving import pam_manager as jpm  # noqa: E402
from repro_torch.core import mapping as tmap  # noqa: E402
from repro_torch.core import pam_interface as tpif  # noqa: E402
from repro_torch.serving import paged_kv as tpkv  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module, restored afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# -------------------------------------------------------------------- mapping
def _freq(kind, n, rng):
    return {"exponential": rng.exponential(size=n).astype(np.float32),
            "integer": rng.integers(0, 4, n).astype(np.float32),
            "equal": np.ones(n, np.float32),
            "skew": np.where(np.arange(n) < 8, 50.0, 1.0).astype(np.float32),
            "window": rng.integers(0, 11, n).astype(np.float32)}[kind]


@pytest.mark.parametrize("kind", ["exponential", "integer", "equal", "skew",
                                  "window"])
@pytest.mark.parametrize("n,g,valid_kind", [(16, 2, "all"), (64, 4, "most"),
                                            (128, 8, "all"), (300, 16, "most")])
def test_greedy_balanced_assign_equals_jax(kind, n, g, valid_kind):
    """Assignments equal the reference's scan exactly (ties in frequency
    and in group load everywhere for the integer, equal and window
    inputs), and meet the LPT bound."""
    rng = np.random.default_rng(n + g)
    freq = _freq(kind, n, rng)
    valid = (np.ones(n, bool) if valid_kind == "all"
             else rng.random(n) < 0.85)
    got = tmap.greedy_balanced_assign(_t(freq), _t(valid), g)
    want = jmap.greedy_balanced_assign(jnp.asarray(freq), jnp.asarray(valid),
                                       g)
    assert got.dtype == torch.int32
    _same(got, want)
    loads = tmap.group_loads(_t(freq), got, _t(valid), g)
    _close(loads, jmap.group_loads(jnp.asarray(freq), want,
                                   jnp.asarray(valid), g))
    _close(tmap.imbalance(_t(freq), got, _t(valid), g),
           jmap.imbalance(jnp.asarray(freq), want, jnp.asarray(valid), g))
    bound = float(loads.mean()) + float(freq[valid].max())
    assert float(loads.max()) <= bound + 1e-5


def test_balanced_assign_beats_naive_on_skew():
    n, g = 64, 4
    freq = torch.ones(n)
    freq[:8] = 50.0
    valid = torch.ones(n, dtype=torch.bool)
    bal = float(tmap.imbalance(freq, tmap.greedy_balanced_assign(
        freq, valid, g), valid, g))
    naive = torch.arange(n, dtype=torch.int32) // (n // g)
    assert bal < float(tmap.imbalance(freq, naive, valid, g)) and bal < 1.1


def test_activation_window_equals_jax():
    n, w = 8, 10
    tfw = torch.zeros((w, n), dtype=torch.uint8)
    jfw = jnp.zeros((w, n), jnp.uint8)
    rng = np.random.default_rng(3)
    for step in range(13):
        act = (np.arange(n) % 2 == (step % 2)) | (rng.random(n) < 0.1)
        prev, snapshot = tfw, tfw.clone()
        tfw = tmap.update_activation_freq(
            tfw, _t(act), torch.tensor(step) if step % 2 else step, window=w)
        jfw = jmap.update_activation_freq(jfw, jnp.asarray(act),
                                          jnp.int32(step), window=w)
        _same(tfw, jfw)
        assert torch.equal(prev, snapshot)       # the input untouched
    counts = tmap.windowed_frequency(tfw)
    assert counts.dtype == torch.int32
    _same(counts, jmap.windowed_frequency(jfw))


# -------------------------------------------------------------- PAM interface
@pytest.mark.parametrize("case", ["reference", "many", "overflow", "none",
                                  "permuted"])
def test_migration_plan_and_apply_equal_jax(case):
    """Plans equal the reference's exactly; applied, the destination
    equals the reference's and a gather oracle (no live write targets
    slot 0 here: see the next test)."""
    rng = np.random.default_rng(7)
    H, d, n_tok = 2, 4, 16
    src = rng.standard_normal((n_tok, H, d)).astype(np.float32)
    dst = rng.standard_normal((9, H, d)).astype(np.float32)
    slot_of_token = np.arange(n_tok, dtype=np.int32)
    moved = np.zeros(n_tok, bool)
    free = np.array([1, 4, 6, 7], np.int32)
    if case == "reference":
        moved[[3, 9, 14]] = True
    elif case == "many":
        moved[rng.random(n_tok) < 0.5] = True
        free = np.array([8, 2, 5, 1, 3, 6, 7, 4], np.int32)
    elif case == "overflow":
        moved[:] = True                       # more movers than free slots
    elif case == "permuted":
        slot_of_token = rng.permutation(n_tok).astype(np.int32)
        moved[rng.random(n_tok) < 0.3] = True
    got = tpif.make_migration_plan(_t(moved), _t(slot_of_token), _t(free))
    want = jpif.make_migration_plan(jnp.asarray(moved),
                                    jnp.asarray(slot_of_token),
                                    jnp.asarray(free))
    for g, w in zip(got, want):
        _same(g, w)
    out = tpif.apply_migration(_t(src), _t(dst), got, _t(slot_of_token))
    jout = jpif.apply_migration(jnp.asarray(src), jnp.asarray(dst), want,
                                jnp.asarray(slot_of_token))
    _same(out, jout)
    oracle = dst.copy()
    movers = np.flatnonzero(moved)
    movers = movers[np.argsort(slot_of_token[movers], kind="stable")]
    for tok, slot in zip(movers[:len(free)], free):
        oracle[slot] = src[slot_of_token[tok]]
    _same(out, oracle)
    if case == "reference":
        assert int(got.count) == 3
        _same(out[7], dst[7])                 # an unused free slot


def test_apply_migration_writes_live_slot_zero():
    """A live entry whose destination is slot 0 lands (the reference's
    masked scatter rewrites slot 0 for each padding entry after it)."""
    src = torch.arange(24, dtype=torch.float32).reshape(6, 2, 2)
    dst = torch.zeros(4, 2, 2)
    moved = torch.tensor([False, True, False, True, False, False])
    plan = tpif.make_migration_plan(moved, torch.arange(6),
                                    torch.tensor([0, 2, 3]))
    assert int(plan.count) == 2
    out = tpif.apply_migration(src, dst, plan, torch.arange(6))
    assert torch.equal(out[0], src[1]) and torch.equal(out[2], src[3])
    assert torch.equal(out[3], dst[3]) and torch.equal(dst, torch.zeros(4, 2, 2))


@pytest.mark.parametrize("dst", [1, 2, "tensor"])
def test_migrate_tier_tags_equals_jax(dst):
    rng = np.random.default_rng(2)
    tier = rng.integers(0, 3, (3, 20)).astype(np.int32)
    moved = rng.random((3, 20)) < 0.3
    d = rng.integers(0, 3, (3, 20)).astype(np.int32) if dst == "tensor" \
        else dst
    got = tpif.migrate_tier_tags(_t(tier), _t(moved),
                                 _t(d) if dst == "tensor" else d)
    _same(got, jpif.migrate_tier_tags(jnp.asarray(tier), jnp.asarray(moved),
                                      jnp.asarray(d) if dst == "tensor"
                                      else d))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("position", [0, 13, 37, 63])
def test_promote_block_to_ring_equals_jax(position):
    rng = np.random.default_rng(position)
    L, Hkv, W, dh, bs, NB = 2, 2, 16, 4, 8, 10
    ring = rng.standard_normal((L, Hkv, W, dh)).astype(np.float32)
    pool = rng.standard_normal((L, NB + 1, bs, Hkv, dh)).astype(np.float32)
    table = rng.permutation(NB)[:8].astype(np.int32)
    got = tpif.promote_block_to_ring(_t(ring), _t(pool), _t(table),
                                     torch.tensor(position), bs, W)
    want = jpif.promote_block_to_ring(jnp.asarray(ring), jnp.asarray(pool),
                                      jnp.asarray(table),
                                      jnp.int32(position), bs, W)
    _same(got, want)
    _same(tpif.promote_block_to_ring(_t(ring), _t(pool), _t(table), position,
                                     bs, W), want)


def test_paged_dense_roundtrip_equals_jax():
    rng = np.random.default_rng(0)
    nblocks, block, H, d = 6, 4, 2, 8
    pool = rng.standard_normal((nblocks, block, H, d)).astype(np.float32)
    table = np.array([3, 0, 5], np.int32)
    dense = tpif.paged_to_dense(_t(pool), _t(table), block)
    assert dense.shape == (12, H, d)
    _same(dense, jpif.paged_to_dense(jnp.asarray(pool), jnp.asarray(table),
                                     block))
    zeros = np.zeros_like(pool)
    got = tpif.dense_to_paged(dense, _t(zeros), _t(table), block)
    _same(got, jpif.dense_to_paged(jnp.asarray(dense.numpy()),
                                   jnp.asarray(zeros), jnp.asarray(table),
                                   block))
    _same(got[table], pool[table])


@pytest.mark.parametrize("n,G,cap,kind", [(10, 2, 8, "alternate"),
                                          (40, 4, 16, "greedy"),
                                          (33, 8, 5, "greedy")])
def test_bank_interleave_equals_jax(n, G, cap, kind):
    rng = np.random.default_rng(n)
    dense = rng.standard_normal((n, 2, 3)).astype(np.float32)
    if kind == "alternate":
        dense = (np.arange(n, dtype=np.float32)[:, None, None]
                 * np.ones((n, 1, 1), np.float32))
        assign = np.array([0, 1] * (n // 2), np.int32)
    else:
        freq = rng.exponential(size=n).astype(np.float32)
        assign = tmap.greedy_balanced_assign(
            _t(freq), torch.ones(n, dtype=torch.bool), G).numpy()
    got, slot = tpif.bank_interleave(_t(dense), _t(assign), G, cap)
    want, jslot = jpif.bank_interleave(jnp.asarray(dense),
                                       jnp.asarray(assign), G, cap)
    _same(slot, jslot)
    _same(got, want)
    if kind == "alternate":
        _same(got[0, :5, 0, 0], [0, 2, 4, 6, 8])
        _same(got[1, :5, 0, 0], [1, 3, 5, 7, 9])


# -------------------------------------------------------------------- paged KV
def test_sequence_to_blocks_and_gather_logical_equal_jax():
    rng = np.random.default_rng(4)
    L, Hkv, S, dh, bs = 2, 2, 16, 4, 4
    kv = rng.standard_normal((L, Hkv, S, dh)).astype(np.float32)
    _same(tpkv.sequence_to_blocks(_t(kv), bs),
          jpkv.sequence_to_blocks(jnp.asarray(kv), bs))
    pool = rng.standard_normal((9, bs, Hkv, dh)).astype(np.float32)
    table = rng.integers(0, 9, (3, 5)).astype(np.int32)
    _same(tpkv.gather_logical(_t(pool), _t(table)),
          jpkv.gather_logical(jnp.asarray(pool), jnp.asarray(table)))


def test_paged_pool_equals_jax():
    """The reference's pool round trip, and every write / gather of the
    pool object against the reference's, on the same allocator table."""
    kw = dict(n_layers=2, num_blocks=8, block_size=4, n_kv=2, d_head=8)
    tpool = tpkv.PagedKVPool.create(**kw, dtype=torch.float32, device="cpu")
    jpool = jpkv.PagedKVPool.create(**kw, dtype=jnp.float32)
    assert (tpool.num_blocks, tpool.sentinel) == (jpool.num_blocks,
                                                  jpool.sentinel)
    table = tpkv.BlockAllocator(8, 4).allocate(0, 10)
    assert table == jpkv.BlockAllocator(8, 4).allocate(0, 10)
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    bids, slots = tpkv.token_to_block_slot(np.arange(10), table, 4)
    jb, js = jpkv.token_to_block_slot(np.arange(10), table, 4)
    _same(bids, jb)
    _same(slots, js)
    t2 = tpool.write_tokens(_t(k), _t(v), bids, slots)
    j2 = jpool.write_tokens(jnp.asarray(k), jnp.asarray(v), jb, js)
    assert float(tpool.k.abs().sum()) == 0.0      # the old pool untouched
    _same(t2.k, j2.k)
    _same(t2.v, j2.v)
    for g, w in zip(t2.gather_tokens(bids, slots), (k, v)):
        _same(g, w)
    # a prefilled sequence through a sentinel-padded table
    kv = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
    row = np.array([5, 1, 7, tpool.sentinel], np.int32)
    t3 = t2.write_prefill(_t(kv), _t(-kv), _t(row))
    j3 = j2.write_prefill(jnp.asarray(kv), jnp.asarray(-kv), jnp.asarray(row))
    _same(t3.k, j3.k)
    _same(t3.v, j3.v)
    bt = np.array([[5, 1, 7, 8], [0, 2, 8, 8]], np.int32)
    for g, w in zip(t3.gather_logical(_t(bt)),
                    j3.gather_logical(jnp.asarray(bt))):
        _same(g, w)


# ------------------------------------------------------------------ manager
def _mgrs(smax=64, hot=8, warm=16, **kw):
    args = dict(max_tokens=smax, hot_capacity=hot, warm_capacity=warm, **kw)
    return (tpm.PAMManager(tpm.PAMManagerConfig(**args)),
            jpm.PAMManager(jpm.PAMManagerConfig(**args)))


def _states(B, smax, imp=None):
    t = tpm.init_pam_state(B, smax, device="cpu")
    j = jpm.init_pam_state(B, smax)
    if imp is not None:
        t = t._replace(importance=_t(imp))
        j = j._replace(importance=jnp.asarray(imp))
    return t, j


def _same_state(t, j):
    for f in ("importance", "tier", "last_hot", "moved_tokens"):
        np.testing.assert_allclose(np.asarray(getattr(t, f)),
                                   np.asarray(getattr(j, f)), **TOL)
    assert int(t.step) == int(j.step)


@pytest.mark.parametrize("imp_kind", ["random", "equal"])
def test_manager_participation_equals_jax(imp_kind):
    tm, jm = _mgrs(smax=64, compression=8, recency_window=4)
    rng = np.random.default_rng(0)
    imp = (rng.random((2, 64)).astype(np.float32) if imp_kind == "random"
           else np.full((2, 64), 0.25, np.float32))
    ts, js = _states(2, 64, imp)
    lengths = np.array([48, 16], np.int32)
    sel = tm.participation(ts, _t(lengths))
    _same(sel, jm.participation(js, jnp.asarray(lengths)))
    assert 6 <= int(sel[0].sum()) <= 10            # budget 6 + 4 pinned
    assert bool(sel[0, 44:48].all()) and not bool(sel[0, 48:].any())


@pytest.mark.parametrize("case", ["capacity", "schedule"])
def test_manager_observe_and_place_prefill_equal_jax(case):
    """The reference's manager cases: placement, five / six observed
    steps (capacity cascade; Alg. 2 promoting an important cold token),
    the read counts and the hit rate, state for state."""
    if case == "capacity":
        tm, jm = _mgrs(smax=32, hot=4, warm=8, schedule_interval=1000)
        plen, steps = 10, 5
        scores = np.ones((1, 32), np.float32)
    else:
        tm, jm = _mgrs(smax=32, hot=4, warm=8, schedule_interval=1,
                       use_sparsity=False)
        plen, steps = 24, 6
        scores = np.zeros((1, 32), np.float32)
        scores[0, 2] = 50.0
    ts, js = _states(1, 32)
    ts2 = tm.place_prefill(ts, 0, plen)
    js = jm.place_prefill(js, jnp.int32(0), jnp.int32(plen))
    assert float(ts.importance.abs().sum()) == 0.0   # the input untouched
    ts = ts2
    _same_state(ts, js)
    if case == "schedule":
        assert int(ts.tier[0, 2]) == tpm.COLD
    lengths = np.array([plen], np.int32)
    part = np.ones((1, 32), bool)
    for _ in range(steps):
        lengths = lengths + 1
        ts = tm.observe(ts, _t(scores), _t(lengths), _t(part))
        js = jm.observe(js, jnp.asarray(scores), jnp.asarray(lengths),
                        jnp.asarray(part))
        _same_state(ts, js)
    tier = ts.tier[0].numpy()
    if case == "capacity":
        valid = np.arange(32) < plen + steps
        assert (tier[valid] == tpm.HOT).sum() <= 4
        assert (tier[valid] == tpm.WARM).sum() <= 8
        assert tier[plen + steps - 1] == tpm.HOT
    else:
        assert tier[2] != tpm.COLD
    sel = tm.participation(ts, _t(lengths))
    _same(tm.tier_read_counts(ts, sel),
          jm.tier_read_counts(js, jm.participation(js, jnp.asarray(lengths))))
    _close(tm.hit_rate(ts, sel), jm.hit_rate(js, jnp.asarray(sel.numpy())))


def test_serving_exports_pool_and_manager():
    from repro_torch import serving as tserving
    assert tserving.PagedKVPool is tpkv.PagedKVPool
    assert tserving.PAMManager is tpm.PAMManager
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpkv.PagedKVPool.create(1, 2, 4, 1, 8)
