"""The port's paper core library against the JAX package's, on the CPU.

Every function of ``repro_torch.core``'s online-softmax algebra,
importance (eqs. 7-8), tiers, retrieval sparsity, PAMattention (Alg. 1)
and ``scheduling.ratio_error`` takes the same numpy inputs as its
``repro.core`` counterpart, drawn from fixed seeds (parametrized cases,
no random draws at run time), and must give its result: fp32 values at
rtol / atol 2e-5, integer outputs (selections, tiers, counts) exactly.
Tie-heavy inputs (equal importances, recency pins at +inf, integer
magnitudes) hold the port's stable sorts to ``jax.lax.top_k`` and
``jnp.argsort``'s index order. The cases of the reference's
``tests/test_online_softmax.py``, ``test_pam_attention.py`` and the
importance / scheduling / placement parts of ``test_kv_management.py``
are here; ``ratio_error``'s monotonicity under ``schedule_kv`` is held
on enumerated seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import importance as jimp  # noqa: E402
from repro.core import online_softmax as josm  # noqa: E402
from repro.core import pam_attention as jpam  # noqa: E402
from repro.core import scheduling as jsch  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import importance as timp  # noqa: E402
from repro_torch.core import online_softmax as tosm  # noqa: E402
from repro_torch.core import pam_attention as tpam  # noqa: E402
from repro_torch.core import scheduling as tsch  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402

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


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------ online softmax
@pytest.mark.parametrize("seed,lead,S,d,mask", [
    (0, (), 9, 16, "none"), (1, (), 24, 8, "thirds"), (2, (3,), 17, 4, "rand"),
    (3, (2, 4), 33, 16, "rand"), (4, (), 7, 8, "dead"),
    (5, (2,), 12, 32, "row_dead")])
def test_local_attention_equals_jax(seed, lead, S, d, mask):
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, *lead, d), _normal(rng, *lead, S, d),
               _normal(rng, *lead, S, d))
    m = {"none": None,
         "thirds": np.arange(S) % 3 == 0,
         "rand": rng.random(lead + (S,)) < 0.6,
         "dead": np.zeros(S, bool),
         "row_dead": np.stack([np.zeros(S, bool), rng.random(S) < 0.5])}[mask]
    got = tosm.local_attention(_t(q), _t(k), _t(v),
                               mask=None if m is None else _t(m))
    want = josm.local_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v),
                                mask=None if m is None else jnp.asarray(m))
    for g, w in zip(got, want):
        _close(g, w)


def _partials(seed, t, s, d):
    """``t`` stacked partials of independent (q, k, v), numpy."""
    rng = np.random.default_rng(seed)
    parts = [josm.local_attention(*(jnp.asarray(_normal(rng, *sh))
                                    for sh in ((d,), (s, d), (s, d))))
             for _ in range(t)]
    return [np.stack([np.asarray(getattr(p, f)) for p in parts])
            for f in ("o", "m", "l")]


def test_tree_merge_pairs_as_the_reference():
    """Partials whose sum cancels in fp32: 1 + (1e8 - 1e8) is 1, but
    (1 + 1e8) - 1e8 is 0, so only the reference's pairing (halves
    ``[:t//2]`` and ``[t//2:]``) gives its result."""
    o = np.float32([[1.0], [1e8], [-1e8]])
    m = np.zeros(3, np.float32)
    l = np.float32([1.0, 1e8, -1e8 + 8.0])
    got = tosm.tree_merge(tosm.AttnPartial(_t(o), _t(m), _t(l)))
    want = josm.tree_merge(josm.AttnPartial(jnp.asarray(o), jnp.asarray(m),
                                            jnp.asarray(l)))
    assert float(got.o[0]) == float(want.o[0]) == 1.0
    assert float(got.l) == float(want.l)


@pytest.mark.parametrize("t", [1, 2, 3, 5, 8, 9])
def test_tree_merge_equals_jax(t):
    """The port pairs halves as the reference does: the merged partial
    equals the reference's tree merge, and both finalize within 1e-6 of
    the flat merge (the reference's property)."""
    o, m, l = _partials(100 + t, t, 11, 8)
    got = tosm.tree_merge(tosm.AttnPartial(_t(o), _t(m), _t(l)))
    want = josm.tree_merge(josm.AttnPartial(jnp.asarray(o), jnp.asarray(m),
                                            jnp.asarray(l)))
    for g, w in zip(got, want):
        _close(g, w)
    flat = tosm.merge_many(tosm.AttnPartial(_t(o), _t(m), _t(l)))
    _close(tosm.finalize(got), tosm.finalize(flat),
           dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("seed,s,d,nsplit,logit_scale", [
    (0, 2, 4, 1, 1.0), (1, 96, 32, 5, 30.0), (2, 40, 8, 3, 0.1),
    (3, 17, 16, 4, 10.0), (4, 64, 8, 2, 5.0)])
def test_attention_from_partitions_equals_jax(seed, s, d, nsplit,
                                              logit_scale):
    """Any contiguous partitioning merges to the monolithic attention,
    in both packages (the reference's property, enumerated)."""
    rng = np.random.default_rng(seed)
    q = _normal(rng, d, scale=logit_scale)
    k, v = _normal(rng, s, d), _normal(rng, s, d)
    cuts = sorted(rng.choice(np.arange(1, s), size=min(nsplit, s - 1),
                             replace=False).tolist())
    bounds = [0] + cuts + [s]
    parts = list(zip(bounds[:-1], bounds[1:]))
    got = tosm.attention_from_partitions(
        _t(q), [_t(k[a:b]) for a, b in parts], [_t(v[a:b]) for a, b in parts])
    want = josm.attention_from_partitions(
        jnp.asarray(q), [jnp.asarray(k[a:b]) for a, b in parts],
        [jnp.asarray(v[a:b]) for a, b in parts])
    _close(got, want)
    _close(got, tosm.reference_attention(_t(q), _t(k), _t(v)))


@pytest.mark.parametrize("masked", [False, True])
def test_reference_attention_and_batched_partitions_equal_jax(masked):
    rng = np.random.default_rng(7)
    B, H, S, d = 2, 4, 33, 16
    q, k, v = (_normal(rng, B, H, d), _normal(rng, B, H, S, d),
               _normal(rng, B, H, S, d))
    m = (rng.random((B, H, S)) < 0.7) if masked else None
    m = None if m is None else m | (np.arange(S) == 0)
    got = tosm.reference_attention(_t(q), _t(k), _t(v),
                                   mask=None if m is None else _t(m))
    want = josm.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v),
                                    mask=None if m is None else jnp.asarray(m))
    assert got.shape == (B, H, d)
    _close(got, want)
    masks = None if m is None else [_t(m[..., :10]), _t(m[..., 10:])]
    parts = tosm.attention_from_partitions(
        _t(q), [_t(k[..., :10, :]), _t(k[..., 10:, :])],
        [_t(v[..., :10, :]), _t(v[..., 10:, :])], masks=masks)
    _close(parts, want)


def test_empty_partial_is_identity_and_merge_is_commutative():
    rng = np.random.default_rng(1)
    d = 16
    part = tosm.local_attention(_t(_normal(rng, d)), _t(_normal(rng, 9, d)),
                                _t(_normal(rng, 9, d)))
    ident = tosm.empty_partial(d, device="cpu")
    jident = josm.empty_partial(d)
    for g, w in zip(ident, jident):
        _same(g, w)
    for merged in (tosm.merge_partials(part, ident),
                   tosm.merge_partials(ident, part)):
        _close(tosm.finalize(merged), tosm.finalize(part),
               dict(rtol=1e-7, atol=1e-7))
    a, b, c = (tosm.local_attention(_t(_normal(rng, 8)), _t(_normal(rng, 7, 8)),
                                    _t(_normal(rng, 7, 8))) for _ in range(3))
    ab_c = tosm.merge_partials(tosm.merge_partials(a, b), c)
    for x in (tosm.merge_partials(a, tosm.merge_partials(b, c)),
              tosm.merge_partials(tosm.merge_partials(b, a), c)):
        _close(tosm.finalize(ab_c), tosm.finalize(x),
               dict(rtol=1e-6, atol=1e-6))
    ident2 = tosm.empty_partial(4, (2, 3), device="cpu")
    assert ident2.o.shape == (2, 3, 4) and ident2.m.shape == (2, 3)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    for make in (lambda: tosm.empty_partial(8),
                 lambda: ttiers.TieredKVState.create(8),
                 lambda: ttiers.initial_placement(4, 8, [2, 2, 4])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# ---------------------------------------------------------------- importance
def test_importance_ema_and_tier_scores_equal_jax():
    _close(timp.update_importance(_t(np.float32([0.5, 0.0, 1.0])),
                                  _t(np.float32([1.0, 1.0, 0.0])), lam=0.6),
           [0.8, 0.6, 0.4])
    impv = np.float32([1.0, 2.0, 3.0, 4.0, 100.0])
    tier = np.int32([0, 0, 1, 2, 2])
    valid = np.array([True, True, True, True, False])
    got = timp.tier_importance_score(_t(impv), _t(tier), 3, _t(valid))
    _close(got, [1.5, 3.0, 4.0])
    rng = np.random.default_rng(3)
    for n, nt in ((50, 3), (7, 4)):
        impv = rng.random(n).astype(np.float32)
        tier = rng.integers(0, nt - 1, n).astype(np.int32)  # last tier empty
        valid = rng.random(n) < 0.8
        for v in (None, valid):
            got = timp.tier_importance_score(
                _t(impv), _t(tier), nt, None if v is None else _t(v))
            want = jimp.tier_importance_score(
                jnp.asarray(impv), jnp.asarray(tier), nt,
                None if v is None else jnp.asarray(v))
            _close(got, want)
    assert timp.DEFAULT_LAMBDA == jimp.DEFAULT_LAMBDA


@pytest.mark.parametrize("head_axis,shape", [(0, (4, 10)), (1, (3, 2, 7)),
                                             (-2, (2, 5, 6))])
def test_step_score_from_attn_weights_equals_jax(head_axis, shape):
    w = np.random.default_rng(4).random(shape).astype(np.float32)
    _close(timp.step_score_from_attn_weights(_t(w), head_axis),
           jimp.step_score_from_attn_weights(jnp.asarray(w), head_axis))


def _tie_scores(kind, n, rng):
    return {"random": rng.random(n).astype(np.float32),
            "all_equal": np.full(n, 0.5, np.float32),
            "quantized": rng.integers(0, 3, n).astype(np.float32),
            "zeros": np.zeros(n, np.float32)}[kind]


@pytest.mark.parametrize("kind", ["random", "all_equal", "quantized",
                                  "zeros"])
@pytest.mark.parametrize("k,valid_kind", [(5, None), (12, "most"),
                                          (20, "few")])
def test_topk_hot_set_equals_jax(kind, k, valid_kind):
    """Selections and masks equal the reference's exactly, ties (and
    more slots than valid tokens) included."""
    rng = np.random.default_rng(5)
    n = 24
    imp = _tie_scores(kind, n, rng)
    valid = {None: None, "most": rng.random(n) < 0.8,
             "few": np.arange(n) % 4 == 1}[valid_kind]
    got = timp.topk_hot_set(_t(imp), k, None if valid is None else _t(valid))
    want = jimp.topk_hot_set(jnp.asarray(imp), k,
                             None if valid is None else jnp.asarray(valid))
    for g, w in zip(got, want):
        _same(g, w)


def test_context_locality_hit_rate_equals_jax():
    rng = np.random.default_rng(6)
    for _ in range(4):
        prev, cur = rng.random(30) < 0.4, rng.random(30) < 0.3
        _close(timp.context_locality_hit_rate(_t(prev), _t(cur)),
               jimp.context_locality_hit_rate(jnp.asarray(prev),
                                              jnp.asarray(cur)))
    empty = np.zeros(30, bool)
    assert float(timp.context_locality_hit_rate(_t(empty), _t(empty))) == 0.0


# ---------------------------------------------------------------------- tiers
def test_tier_specs_and_state_equal_jax():
    assert ttiers.TIER_NAMES == jtiers.TIER_NAMES
    for got, want in zip(ttiers.DEFAULT_TIERS, jtiers.DEFAULT_TIERS):
        assert got.__dict__ == want.__dict__
    assert (ttiers.HBM_PIM, ttiers.DDR_PIM, ttiers.SSD_PIM) == \
        ttiers.DEFAULT_TIERS
    st = ttiers.TieredKVState.create(16, device="cpu")
    assert st.max_tokens == 16 and st.tier_of_token.dtype == torch.int32
    rng = np.random.default_rng(8)
    tier = rng.integers(0, 3, 40).astype(np.int32)
    imp = rng.random(40).astype(np.float32)
    valid = rng.random(40) < 0.7
    got = ttiers.TieredKVState(_t(tier), _t(imp), _t(valid))
    want = jtiers.TieredKVState(jnp.asarray(tier), jnp.asarray(imp),
                                jnp.asarray(valid))
    for t in range(3):
        assert int(got.tokens_on_tier(t)) == int(want.tokens_on_tier(t))
    _same(got.tier_counts(), want.tier_counts())
    _same(got.tier_counts(4), want.tier_counts(4))


@pytest.mark.parametrize("lead,bs", [((), 4), ((3,), 8), ((2, 2), 2)])
def test_block_residency_and_blocks_per_tier_equal_jax(lead, bs):
    rng = np.random.default_rng(9)
    shape = lead + (bs * 6,)
    tier = rng.integers(0, 3, shape).astype(np.int32)
    valid = rng.random(shape) < 0.5
    valid[..., :bs] = False                            # an empty block
    got = ttiers.block_residency(_t(tier), _t(valid), bs)
    want = jtiers.block_residency(jnp.asarray(tier), jnp.asarray(valid), bs)
    assert got.dtype == torch.int32
    _same(got, want)
    _same(ttiers.blocks_per_tier(_t(tier), _t(valid), bs),
          jtiers.blocks_per_tier(jnp.asarray(tier), jnp.asarray(valid), bs))


@pytest.mark.parametrize("num_tokens,max_tokens,caps", [
    (20, 32, [4, 8, 100]), (0, 8, [2, 2, 4]), (32, 32, [40, 8, 0]),
    (100, 128, [16, 30, 1000]), (5, 16, [0, 0, 16])])
def test_initial_placement_equals_jax(num_tokens, max_tokens, caps):
    got = ttiers.initial_placement(num_tokens, max_tokens, caps, device="cpu")
    want = jtiers.initial_placement(num_tokens, max_tokens, caps)
    _same(got.tier_of_token, want.tier_of_token)
    _same(got.valid, want.valid)
    _close(got.importance, want.importance)
    if (num_tokens, caps) == (20, [4, 8, 100]):    # the reference's case
        tier = got.tier_of_token.numpy()
        assert (tier[16:20] == ttiers.HOT).all()
        assert (tier[8:16] == ttiers.WARM).all()
        assert (tier[:8] == ttiers.COLD).all()


# ------------------------------------------------------------------- sparsity
@pytest.mark.parametrize("kind", ["random", "integer_ties"])
@pytest.mark.parametrize("r", [1, 4, 16])
def test_choose_label_channels_equals_jax(kind, r):
    rng = np.random.default_rng(10)
    k = (_normal(rng, 40, 32) if kind == "random"
         else rng.integers(-2, 3, (40, 32)).astype(np.float32))
    got = tsp.choose_label_channels(_t(k), r)
    _same(got, jsp.choose_label_channels(jnp.asarray(k), r))


def test_approx_scores_and_step_scores_equal_jax():
    rng = np.random.default_rng(11)
    q, k = _normal(rng, 4, 32), _normal(rng, 50, 32)
    idx = np.asarray(jsp.choose_label_channels(jnp.asarray(k), 8))
    k_label = k[:, idx]
    _close(tsp.approx_scores(_t(q), _t(k_label), _t(idx)),
           jsp.approx_scores(jnp.asarray(q), jnp.asarray(k_label),
                             jnp.asarray(idx)))
    w, sel = rng.random(50).astype(np.float32), rng.random(50) < 0.3
    _same(tsp.sparse_step_scores(_t(w), _t(sel)),
          jsp.sparse_step_scores(jnp.asarray(w), jnp.asarray(sel)))
    assert tsp.SparsityConfig() == tsp.SparsityConfig(8, 16, 32)
    assert dict(tsp.SparsityConfig().__dict__) == dict(
        jsp.SparsityConfig().__dict__)


@pytest.mark.parametrize("kind", ["random", "all_equal", "quantized"])
@pytest.mark.parametrize("k,num_tokens,recency", [
    (8, None, 0), (8, 40, 4), (6, 30, 10), (16, 64, 32), (4, 12, 0)])
def test_select_topk_equals_jax(kind, k, num_tokens, recency):
    """Recency pins set many scores to +inf: the selected indices among
    them, and the mask, equal the reference's exactly."""
    rng = np.random.default_rng(12)
    S = 64
    scores = _tie_scores(kind, S, rng)
    n = S if num_tokens is None else num_tokens
    valid = np.arange(S) < n
    nt = None if num_tokens is None else np.int32(num_tokens)
    got = tsp.select_topk(_t(scores), _t(valid), k,
                          None if nt is None else torch.tensor(num_tokens),
                          recency_window=recency)
    want = jsp.select_topk(jnp.asarray(scores), jnp.asarray(valid), k,
                           None if nt is None else jnp.asarray(nt),
                           recency_window=recency)
    for g, w in zip(got, want):
        _same(g, w)


# ------------------------------------------------------------- PAMattention
def _setup(seed, S, H, H_kv, d, imp_kind="random"):
    rng = np.random.default_rng(seed)
    q, k, v = _normal(rng, H, d), _normal(rng, S, H_kv, d), \
        _normal(rng, S, H_kv, d)
    tier = rng.integers(0, 3, S).astype(np.int32)
    imp = _tie_scores(imp_kind, S, rng)
    return q, k, v, tier, imp


def _both_steps(q, k, v, tier, valid, imp, **cfg):
    got = tpam.pam_attention_step(_t(q), _t(k), _t(v), _t(tier), _t(valid),
                                  _t(imp), tpam.PAMAttentionConfig(**cfg))
    want = jpam.pam_attention_step(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tier),
        jnp.asarray(valid), jnp.asarray(imp), jpam.PAMAttentionConfig(**cfg))
    return got, want


@pytest.mark.parametrize("seed,S,heads", [
    (0, 8, (4, 4, 8)), (1, 64, (8, 2, 16)), (2, 33, (4, 1, 8)),
    (3, 50, (16, 8, 16)), (4, 17, (8, 2, 16))])
@pytest.mark.parametrize("sparse", [False, True])
def test_pam_attention_step_equals_jax(seed, S, heads, sparse):
    H, H_kv, d = heads
    q, k, v, tier, imp = _setup(seed, S, H, H_kv, d)
    valid = np.arange(S) < S - seed            # some tail tokens invalid
    got, want = _both_steps(q, k, v, tier, valid, imp, use_sparsity=sparse,
                            compression=4)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("imp_kind", ["all_equal", "quantized", "zeros"])
@pytest.mark.parametrize("compression,num_tiers", [(8, 3), (3, 2), (1, 1)])
def test_pam_attention_step_ties_equal_jax(imp_kind, compression, num_tiers):
    """Tie-heavy importances: the sparse selection keeps the reference's
    index order, so out, step scores and the new importance agree."""
    q, k, v, tier, imp = _setup(20, 48, 8, 2, 16, imp_kind)
    valid = np.ones(48, bool)
    valid[5:9] = False
    got, want = _both_steps(q, k, v, tier, valid, imp, use_sparsity=True,
                            compression=compression, num_tiers=num_tiers)
    _same(got.step_scores.numpy() > 0, np.asarray(want.step_scores) > 0)
    for g, w in zip(got, want):
        _close(g, w)


def test_pam_attention_reference_cases():
    """The reference's own PAMattention properties, on the port."""
    cfg_dense = tpam.PAMAttentionConfig(use_sparsity=False)
    # sparse == full attention over exactly the top-(S/c) tokens
    S, H, H_kv, d, c = 64, 4, 2, 8, 8
    q, k, v, tier, imp = _setup(11, S, H, H_kv, d)
    out = tpam.pam_attention_step(
        _t(q), _t(k), _t(v), _t(tier), torch.ones(S, dtype=torch.bool),
        _t(imp), tpam.PAMAttentionConfig(use_sparsity=True, compression=c))
    sel = np.argsort(-imp, kind="stable")[:S // c]
    kh = np.moveaxis(np.repeat(k, H // H_kv, axis=1), 0, 1)
    vh = np.moveaxis(np.repeat(v, H // H_kv, axis=1), 0, 1)
    _close(out.out, tosm.reference_attention(_t(q), _t(kh[:, sel]),
                                             _t(vh[:, sel])))
    # step scores of participating tokens sum to S
    q, k, v, tier, imp = _setup(5, 32, 4, 4, 8)
    out = tpam.pam_attention_step(_t(q), _t(k), _t(v), _t(tier),
                                  torch.ones(32, dtype=torch.bool), _t(imp),
                                  cfg_dense)
    np.testing.assert_allclose(float(out.step_scores.sum()), 32, rtol=1e-4)
    # an aligned key dominates, so its importance rises to the top
    q, k, v, tier, _ = _setup(9, 32, 2, 2, 8)
    k[17] = np.broadcast_to(q[0] * 5.0, (2, 8))
    out = tpam.pam_attention_step(_t(q), _t(k), _t(v), _t(tier),
                                  torch.ones(32, dtype=torch.bool),
                                  torch.zeros(32), cfg_dense)
    assert int(torch.argmax(out.new_importance)) == 17
    # invalid tokens are excluded and get no mass
    q, k, v, tier, imp = _setup(3, 24, 2, 2, 8)
    valid = torch.arange(24) < 10
    out = tpam.pam_attention_step(_t(q), _t(k), _t(v), _t(tier), valid,
                                  _t(imp), cfg_dense)
    _close(out.out, tosm.reference_attention(
        _t(q), _t(np.moveaxis(k[:10], 0, 1)), _t(np.moveaxis(v[:10], 0, 1))))
    assert float(out.step_scores[~valid].sum()) == 0.0


def test_core_exports_equal_jax():
    from repro import core as jcore
    assert sorted(tcore.__all__) == sorted(jcore.__all__)
    for name in tcore.__all__:
        assert hasattr(tcore, name), name


# ----------------------------------------------------------------- scheduling
def _rand_state(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.random(n).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32), rng.random(n) < 0.9)


@pytest.mark.parametrize("seed,n,x,y", [
    (0, 12, 4.0, 2.0), (1, 96, 8.0, 3.0), (2, 40, 16.0, 0.5),
    (3, 8, 1.0, 8.0), (4, 64, 2.5, 2.5)])
def test_ratio_error_equals_jax(seed, n, x, y):
    imp, tier, valid = _rand_state(seed, n)
    cfg = dict(x=x, y=y, max_swaps=12)
    got = tsch.ratio_error(_t(imp), _t(tier), _t(valid),
                           tsch.ScheduleConfig(**cfg))
    want = jsch.ratio_error(jnp.asarray(imp), jnp.asarray(tier),
                            jnp.asarray(valid), jsch.ScheduleConfig(**cfg))
    _close(got, want)
    batched = tsch.ratio_error(_t(np.stack([imp, imp])),
                               _t(np.stack([tier, tier])),
                               _t(np.stack([valid, valid])),
                               tsch.ScheduleConfig(**cfg))
    _close(batched, [float(want)] * 2)


@pytest.mark.parametrize("x,y", [(1.0, 0.5), (4.0, 2.0), (8.0, 3.0),
                                 (16.0, 8.0), (2.0, 6.0)])
def test_ratio_error_monotone_under_schedule_kv(x, y):
    """ratio_error never increases under the port's schedule_kv, on 32
    enumerated seeds a target (sizes 8-64, degenerate occupancies
    included), each row equal to the reference's."""
    cfg = dict(x=x, y=y, max_swaps=12)
    for seed in range(32):
        n = 8 + (seed * 7) % 57
        imp, tier, valid = _rand_state(1000 + seed, n)
        if seed % 8 == 0:
            tier[:] = seed % 3                       # one tier holds all
        tcfg_ = tsch.ScheduleConfig(**cfg)
        before = float(tsch.ratio_error(_t(imp), _t(tier), _t(valid), tcfg_))
        new_tier, _, _ = tsch.schedule_kv(_t(imp)[None], _t(tier)[None],
                                          _t(valid)[None], tcfg_)
        after = float(tsch.ratio_error(_t(imp), new_tier[0], _t(valid),
                                       tcfg_))
        assert after <= before + 1e-4, seed
        want = jsch.ratio_error(jnp.asarray(imp), jnp.asarray(tier),
                                jnp.asarray(valid),
                                jsch.ScheduleConfig(**cfg))
        np.testing.assert_allclose(before, float(want), **TOL)


# ------------------------------------------------------- the slice as a whole
def test_decode_loop_equals_jax():
    """Prefill placement, then eight Alg. 1 steps (sparse, c 4) each
    followed by Alg. 2: tiers and selections equal the reference's
    exactly at every step, and outputs and importances within
    tolerance."""
    rng = np.random.default_rng(30)
    S, H, H_kv, d = 64, 8, 2, 16
    k, v = _normal(rng, S, H_kv, d), _normal(rng, S, H_kv, d)
    n = 40
    t_st = ttiers.initial_placement(n, S, [8, 12, 100], device="cpu")
    j_st = jtiers.initial_placement(n, S, [8, 12, 100])
    t_tier, t_imp = t_st.tier_of_token, t_st.importance
    j_tier, j_imp = j_st.tier_of_token, j_st.importance
    scfg = dict(x=6.0, y=2.0, max_swaps=8)
    for step in range(8):
        q = _normal(rng, H, d)
        valid = np.arange(S) < n + step
        t_out = tpam.pam_attention_step(
            _t(q), _t(k), _t(v), t_tier, _t(valid), t_imp,
            tpam.PAMAttentionConfig(compression=4))
        j_out = jpam.pam_attention_step(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_tier,
            jnp.asarray(valid), j_imp, jpam.PAMAttentionConfig(compression=4))
        _same(t_out.step_scores.numpy() > 0,
              np.asarray(j_out.step_scores) > 0)
        _close(t_out.out, j_out.out)
        _close(t_out.new_importance, j_out.new_importance)
        t_imp, j_imp = t_out.new_importance, j_out.new_importance
        t_tier = tsch.schedule_kv(t_imp[None], t_tier[None],
                                  _t(valid)[None],
                                  tsch.ScheduleConfig(**scfg))[0][0]
        j_tier = jsch.schedule_kv(j_imp, j_tier, jnp.asarray(valid),
                                  jsch.ScheduleConfig(**scfg))[0]
        _same(t_tier, j_tier)
