"""The port's PAM state machine against the JAX reference: Alg. 2, the
participation and capacity rankings (on inputs full of ties and
infinities), the EMA/append/cascade update, prefill placement, the tier
split, the counters and the block allocator. Integer and boolean
results must be identical; importance within 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import scheduling as jsch  # noqa: E402
from repro.serving import pam_manager as jpm  # noqa: E402
from repro.serving import paged_kv as jpkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import scheduling as tsch  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402
from repro_torch.serving import paged_kv as tpkv  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _state(seed, B=3, S=40, ties=True):
    """Importance with heavy ties (a few distinct levels), random tiers,
    ragged lengths."""
    r = np.random.default_rng(seed)
    levels = np.array([0.0, 0.25, 0.5, 1.0, 2.0], np.float32)
    imp = (levels[r.integers(0, 5, (B, S))] if ties
           else r.random((B, S)).astype(np.float32))
    tier = r.integers(0, 3, (B, S)).astype(np.int32)
    lens = np.array([S, S // 2 + 3, 5], np.int32)[:B]
    return imp.astype(np.float32), tier, lens


def _cfgs(**kw):
    j = jpm.PAMManagerConfig(max_tokens=40, hot_capacity=6,
                             warm_capacity=10, compression=4,
                             recency_window=4, schedule_interval=2, **kw)
    t = tpm.PAMManagerConfig(max_tokens=40, hot_capacity=6,
                             warm_capacity=10, compression=4,
                             recency_window=4, schedule_interval=2, **kw)
    return j, t


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ties", [True, False])
def test_schedule_kv_matches_jax(seed, ties):
    imp, tier, lens = _state(seed, ties=ties)
    valid = np.arange(imp.shape[1])[None] < lens[:, None]
    cfg = jsch.ScheduleConfig(max_swaps=8 if seed % 2 else 32)
    jt, jm, js = jax.vmap(lambda i, t, v: jsch.schedule_kv(i, t, v, cfg))(
        imp, tier, valid)
    tt, tm, ts = tsch.schedule_kv(_t(imp), _t(tier), _t(valid),
                                  tsch.ScheduleConfig(
                                      max_swaps=cfg.max_swaps))
    _eq(tt, jt)
    _eq(tm, jm)
    _eq(ts, js)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("sparsity", [True, False])
def test_participation_mask_matches_jax(seed, sparsity):
    imp, _, lens = _state(seed)
    jc, tc = _cfgs(use_sparsity=sparsity)
    _eq(tpm.participation_mask(tc, _t(imp), _t(lens)),
        jpm.participation_mask(jc, jnp.asarray(imp), jnp.asarray(lens)))


@pytest.mark.parametrize("seed", range(3))
def test_enforce_capacity_matches_jax(seed):
    imp, tier, lens = _state(seed)
    valid = np.arange(imp.shape[1])[None] < lens[:, None]
    for t_from, cap, t_to in ((0, 4, 1), (1, 3, 2)):
        _eq(tpm._enforce_capacity(_t(imp), _t(tier), _t(valid), t_from,
                                  cap, t_to),
            jpm._enforce_capacity(jnp.asarray(imp), jnp.asarray(tier),
                                  jnp.asarray(valid), t_from, cap, t_to))


def _jax_state(imp, tier, lens, step):
    B, S = imp.shape
    return jpm.PAMState(importance=jnp.asarray(imp), tier=jnp.asarray(tier),
                        step=jnp.int32(step), moved_tokens=jnp.int32(3),
                        last_hot=jnp.zeros((B, S), bool),
                        block_table=jnp.zeros((0,), jnp.int32))


@pytest.mark.parametrize("step", [0, 1])     # step 1 runs Alg. 2
@pytest.mark.parametrize("tiering", [True, False])
def test_observe_update_matches_jax(step, tiering):
    imp, tier, lens = _state(5, ties=False)
    r = np.random.default_rng(6)
    scores = (r.random(imp.shape) * 2).astype(np.float32)
    part = r.random(imp.shape) < 0.4
    jc, tc = _cfgs(use_tiering=tiering)
    js = _jax_state(imp, tier, lens, step)
    jo = jpm.observe_update(jc, js, jnp.asarray(scores), jnp.asarray(lens),
                            jnp.asarray(part))
    to = tpm.observe_update(tc, bridge.pam_state_from_jax(js, "cpu"),
                            _t(scores), _t(lens), _t(part))
    np.testing.assert_allclose(to.importance.numpy(),
                               np.asarray(jo.importance), rtol=1e-6,
                               atol=1e-6)
    _eq(to.tier, jo.tier)
    _eq(to.moved_tokens, jo.moved_tokens)
    _eq(to.last_hot, jo.last_hot)
    assert to.step == int(jo.step)


@pytest.mark.parametrize("step", [0, 1])     # step 1 runs Alg. 2
@pytest.mark.parametrize("tiering", [True, False])
def test_observe_update_in_place_matches_jax(step, tiering):
    """``observe_update_`` (the engine's captured decode body calls it)
    writes what the JAX ``observe_update`` returns into the tensors the
    state already holds, with Alg. 2 taken from the static flag the
    engine derives from the host step count."""
    imp, tier, lens = _state(5, ties=False)
    r = np.random.default_rng(6)
    scores = (r.random(imp.shape) * 2).astype(np.float32)
    part = r.random(imp.shape) < 0.4
    jc, tc = _cfgs(use_tiering=tiering)
    js = _jax_state(imp, tier, lens, step)
    jo = jpm.observe_update(jc, js, jnp.asarray(scores), jnp.asarray(lens),
                            jnp.asarray(part))
    ts = bridge.pam_state_from_jax(js, "cpu")
    ptrs = [t.data_ptr() for t in ts if isinstance(t, torch.Tensor)]
    sched = tpm.runs_schedule(tc, step)
    assert sched == (tiering and step == 1)
    moved = tpm.observe_update_(tc, ts, _t(scores), _t(lens), _t(part),
                                schedule=sched)
    assert [t.data_ptr() for t in ts if isinstance(t, torch.Tensor)] == ptrs
    np.testing.assert_allclose(ts.importance.numpy(),
                               np.asarray(jo.importance), rtol=1e-6,
                               atol=1e-6)
    _eq(ts.tier, jo.tier)
    _eq(ts.moved_tokens, jo.moved_tokens)
    _eq(ts.last_hot, jo.last_hot)
    assert moved.dtype == torch.int32
    assert int(moved) == int(jo.moved_tokens) - int(js.moved_tokens)
    assert ts.step == step          # the caller advances the host count


@pytest.mark.parametrize("length", [1, 7, 33, 40])
def test_place_prefill_state_matches_jax(length):
    B, S, nb = 3, 40, 10
    jc, tc = _cfgs()
    row = np.arange(nb, dtype=np.int32)[::-1].copy()
    js = jpm.init_pam_state(B, S, num_blocks=nb, sentinel=99)
    jo = jpm.place_prefill_state(jc, js, 1, length, jnp.asarray(row))
    ts = tpm.init_pam_state(B, S, num_blocks=nb, sentinel=99, device="cpu")
    to = tpm.place_prefill_state(tc, ts, 1, length, _t(row))
    np.testing.assert_allclose(to.importance.numpy(),
                               np.asarray(jo.importance), rtol=1e-7)
    for f in ("tier", "last_hot", "block_table"):
        _eq(getattr(to, f), getattr(jo, f))


@pytest.mark.parametrize("hot_window", [0, 6])
def test_paged_participation_split_matches_jax(hot_window):
    imp, tier, lens = _state(7)
    part = np.random.default_rng(8).random(imp.shape) < 0.5
    got = tpm.paged_participation_split(_t(part), _t(tier), _t(lens), 4,
                                        hot_window)
    ref = jpm.paged_participation_split(jnp.asarray(part), jnp.asarray(tier),
                                        jnp.asarray(lens), 4, hot_window)
    for a, b in zip(got, ref):
        _eq(a, b)


def test_counters_match_jax():
    imp, tier, lens = _state(9)
    r = np.random.default_rng(10)
    part, last = r.random(imp.shape) < 0.5, r.random(imp.shape) < 0.5
    _eq(tpm.tier_read_counts_of(_t(tier), _t(part)),
        jpm.tier_read_counts_of(jnp.asarray(tier), jnp.asarray(part)))
    np.testing.assert_allclose(
        float(tpm.hit_rate_of(_t(last), _t(part))),
        float(jpm.hit_rate_of(jnp.asarray(last), jnp.asarray(part))),
        rtol=1e-6)


def test_block_allocator_matches_reference_ids():
    ja, ta = jpkv.BlockAllocator(12, 4), tpkv.BlockAllocator(12, 4)
    for a in (ja, ta):
        a.allocate(0, 9)
        a.allocate(1, 13)
        a.free(0)
        a.allocate(2, 16)
    for rid in (1, 2):
        np.testing.assert_array_equal(ta.padded_table(rid, 5, 12),
                                      ja.padded_table(rid, 5, 12))
    assert ta.occupancy == ja.occupancy
    with pytest.raises(tpkv.OutOfBlocks):
        ta.allocate(3, 40)
    assert ta.free(7) == 0
