"""The port's engine-side cluster hooks against the JAX engine's.

* Every step's stats dict (the latency model's input, key for key and
  dtype for dtype) and the modeled clock equal the JAX engine's, on
  paged + ring, paged and dense PAM engines; so do ``load_signal``,
  ``can_accept`` and ``serviceable``, and ``slot_importance_mass`` to
  atol 1e-5 (an fp32 sum over differently rounded EMAs).
* A request exported at the same step gives the JAX export's K, V and
  importance (rtol / atol 1e-5, the port's model tolerance: the
  packages' matmuls round differently, K by up to 2.2e-6 here),
  tier and participation rows, length, token and timing marks; the
  source frees its slot and blocks without finishing it.
* Snapshots cross between the packages in both directions and continue
  to the unmigrated JAX twin's stream; ring -> no-ring -> dense moves;
  the prefix cache's export (decref) and import (trie publish) against
  the JAX engine doing the same; import backpressure and rollback.
* The crc32 seal equals the reference's for the same snapshot, and a
  corrupted copy is refused before it claims a slot.
* bf16: a JAX export imported by a port engine and exported again has
  bit-equal K/V (``uint16`` views) and the same crc32.

Reduced qwen3-0.6b (fp32 unless stated), weights from the JAX package's
``init_params`` through ``repro_torch.bridge``; prompts from fixed numpy
seeds; engines on the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import build_model, make_pam  # noqa: E402

from repro.cluster import KVSnapshot as JSnap  # noqa: E402
from repro.cluster import migrate as jmigrate  # noqa: E402
from repro.perfmodel import devices as jdev  # noqa: E402
from repro.serving import EngineSpec as JSpec  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.serving import ServingConfig as JSC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.cluster import KVSnapshot as TSnap  # noqa: E402
from repro_torch.cluster import SnapshotCorruption, can_migrate  # noqa: E402
from repro_torch.cluster import migrate as tmigrate  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.perfmodel import devices as tdev  # noqa: E402
from repro_torch.serving import EngineSpec as TSpec  # noqa: E402
from repro_torch.serving import OutOfBlocks  # noqa: E402
from repro_torch.serving import PAMManagerConfig  # noqa: E402
from repro_torch.serving import Request as TReq  # noqa: E402
from repro_torch.serving import ServingConfig as TSC  # noqa: E402

torch.set_num_threads(2)

MAX_LEN = 64
MODES = {
    "paged_ring": dict(block_size=8, hot_window=16),
    "paged": dict(block_size=8),
    "dense": dict(),
}
# a policy that reads every tier and moves tokens (test_cluster.py's)
JPAM = make_pam(max_len=MAX_LEN, hot=4, warm=8, recency_window=2)
TPAM = PAMManagerConfig(
    max_tokens=JPAM.max_tokens, hot_capacity=JPAM.hot_capacity,
    warm_capacity=JPAM.warm_capacity, compression=JPAM.compression,
    recency_window=JPAM.recency_window,
    schedule_interval=JPAM.schedule_interval)
N_REQ, PLEN, MAX_NEW = 4, 20, 12


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _models(dtype="float32"):
    """(jax cfg, jax params, port cfg, port params) for reduced qwen3."""
    return _MODELS[dtype]


class _Models(dict):
    def __missing__(self, dtype):
        jcfg, jparams = build_model("qwen3-0.6b")
        tcf = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
        if dtype != "float32":
            import jax
            from repro.models import transformer as jtf
            jcfg = dataclasses.replace(jcfg, dtype=dtype)
            tcf = dataclasses.replace(tcf, dtype=dtype)
            jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        self[dtype] = (jcfg, jparams, tcf,
                       bridge.params_from_jax(tcf, _np_tree(jparams),
                                              device="cpu"))
        return self[dtype]


_MODELS = _Models()


def _engines(mode, name="dev", cls="hbm", latency=True, dtype="float32",
             **extra):
    """A JAX engine and a port engine of the same config, each under its
    package's latency model of device class ``cls``."""
    jcfg, jparams, tcf, tparams = _models(dtype)
    kw = dict(max_batch=3, max_len=MAX_LEN, **MODES[mode])
    kw.update(extra)
    jlat = (jdev.make_device_latency_model(jdev.get_device_class(cls))
            if latency else None)
    tlat = (tdev.make_device_latency_model(tdev.get_device_class(cls))
            if latency else None)
    je = JSpec(model=jcfg, serving=JSC(pam=JPAM, **kw), name=name).build(
        jparams, latency_model=jlat)
    te = TSpec(model=tcf, serving=TSC(pam=TPAM, **kw), name=name).build(
        tparams, latency_model=tlat, device="cpu")
    return je, te


def _reqs(R, n=N_REQ, plen=PLEN, max_new=MAX_NEW, seed=0):
    rng = np.random.default_rng(seed)
    return [R(id=i, prompt=rng.integers(0, 256, plen), max_new_tokens=max_new)
            for i in range(n)]


def _submit(eng, R, **kw):
    for r in _reqs(R, **kw):
        eng.submit(r)


def _drain(*engines):
    for eng in engines:
        while eng.waiting or any(s is not None for s in eng.slots):
            eng.step()


def _twin_streams(mode, **kw):
    je, _ = _engines(mode, name="twin", latency=False)
    _submit(je, JReq, **kw)
    _drain(je)
    return {rid: rs.outputs for rid, rs in je.requests.items()}


def _assert_stats_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), key
        else:
            assert type(g) is type(w) and g == w, (key, g, w)


# ----------------------------------------------- stats, clock, signals
@pytest.mark.parametrize("mode", sorted(MODES))
def test_step_stats_and_clock_equal_jax_engine(mode):
    je, te = _engines(mode)
    _submit(je, JReq)
    _submit(te, TReq)
    n = 0
    while je.waiting or any(s is not None for s in je.slots):
        _assert_stats_equal(te.step(), je.step())
        n += 1
        assert te.clock == je.clock and te.busy_time == je.busy_time
        assert te.last_step_time == je.last_step_time
        assert te.load_signal() == je.load_signal()
        for w in (20, 32, 33, 64, 65):
            assert te.serviceable(w) == je.serviceable(w)
            for rq in (True, False):
                assert (te.can_accept(w, reserve_queued=rq)
                        == je.can_accept(w, reserve_queued=rq))
        tm, jm = te.slot_importance_mass(), je.slot_importance_mass()
        assert sorted(tm) == sorted(jm)
        for rid in jm:
            assert tm[rid] == pytest.approx(jm[rid], abs=1e-5), \
                (rid, tm[rid], jm[rid])
    assert te.steps == je.steps == n
    assert te.summary()["sim_time_s"] == je.summary()["sim_time_s"]
    assert ({r: s.token_times for r, s in te.requests.items()}
            == {r: s.token_times for r, s in je.requests.items()})


def test_micro_steps_modeled_clock_equals_jax_engine():
    """``micro_steps`` 4 charges each sub-step as the reference's micro
    loop does: the same clock, busy time and token times."""
    je, te = _engines("paged_ring", micro_steps=4)
    _submit(je, JReq)
    _submit(te, TReq)
    je.run()
    te.run()
    assert te.clock == je.clock and te.busy_time == je.busy_time
    for rid, rs in je.requests.items():
        assert te.requests[rid].outputs == rs.outputs
        assert te.requests[rid].token_times == rs.token_times


# --------------------------------------------------------------- export
def _export_pair(mode, steps=5):
    je, te = _engines(mode, name="src")
    _submit(je, JReq)
    _submit(te, TReq)
    for _ in range(steps):
        je.step()
        te.step()
    return je, te


@pytest.mark.parametrize("mode", sorted(MODES))
def test_export_equals_jax_export_and_frees_without_finishing(mode):
    je, te = _export_pair(mode)
    slot = te.requests[1].slot
    free_before = (te.allocator.free_blocks if te.allocator is not None
                   else None)
    js, ts = JSnap.export(je, 1), TSnap.export(te, 1)
    for f in ("length", "token", "outputs", "first_token_time",
              "token_times", "src", "src_shard"):
        assert getattr(ts, f) == getattr(js, f), f
    for f in ("k", "v", "importance"):
        g, w = getattr(ts, f), np.asarray(getattr(js, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=f)
    for f in ("tier", "last_hot"):
        g, w = getattr(ts, f), np.asarray(getattr(js, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert ts.kv_bytes == js.kv_bytes
    # free without finishing: the request, its slot and blocks are gone
    assert 1 not in te.requests and te.slots[slot] is None
    assert te.migrations_out == je.migrations_out == 1
    if te.allocator is not None:
        assert te.allocator.free_blocks > free_before
        assert 1 not in te.allocator.tables
    _drain(je, te)
    for rid, rs in je.requests.items():
        assert te.requests[rid].outputs == rs.outputs


def _port_req(r):
    return TReq(id=r.id, prompt=np.asarray(r.prompt),
                max_new_tokens=r.max_new_tokens, arrival=r.arrival)


def _jax_req(r):
    return JReq(id=r.id, prompt=np.asarray(r.prompt),
                max_new_tokens=r.max_new_tokens, arrival=r.arrival)


def _fields(snap):
    return {f.name: getattr(snap, f.name) for f in dataclasses.fields(snap)}


def _to_port(js: JSnap) -> TSnap:
    """A JAX snapshot as the port's: numpy arrays, bf16 as uint16."""
    d = _fields(js)
    d["request"] = _port_req(js.request)
    for key in ("k", "v", "importance", "tier", "last_hot"):
        a = np.asarray(d[key])
        d[key] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return TSnap(**d)


def _to_jax(ts: TSnap) -> JSnap:
    d = _fields(ts)
    d["request"] = _jax_req(ts.request)
    return JSnap(**d)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("mode", ["paged_ring", "dense"])
def test_snapshot_crosses_packages_and_continues_to_twin(mode, direction):
    """Export mid-decode from one package, commit the snapshot into the
    other's engine (a CXL-class engine of batch 2), and run both to the
    end: every stream equals the unmigrated JAX twin's."""
    twin = _twin_streams(mode)
    je, te = _export_pair(mode)
    jd, td = _engines(mode, name="dst", cls="cxl", max_batch=2)
    if direction == "jax_to_port":
        snap = _to_port(JSnap.export(je, 1))
        assert snap.verify()                 # the JAX seal holds here
        snap.commit(td)
        src, dst = je, td
    else:
        snap = _to_jax(TSnap.export(te, 1))
        assert snap.verify()
        snap.commit(jd)
        src, dst = te, jd
    assert dst.migrations_in == 1
    _drain(src, dst)
    assert dst.requests[1].outputs == twin[1]
    for rid in (0, 2, 3):
        assert src.requests[rid].outputs == twin[rid], rid


def test_ring_to_no_ring_to_dense_migration():
    """Engines with different hot windows (or none) interoperate: a
    request moves ring -> paged without a ring -> dense mid-decode and
    ends on the twin's stream."""
    twin = _twin_streams("paged_ring")
    _, ring = _export_pair("paged_ring", steps=4)
    _, paged = _engines("paged", name="paged")
    _, dense = _engines("dense", name="dense")
    tmigrate(ring, paged, 2)
    for _ in range(3):
        ring.step()
        paged.step()
    tmigrate(paged, dense, 2)
    _drain(ring, paged, dense)
    assert dense.requests[2].outputs == twin[2]
    assert paged.migrations_in == paged.migrations_out == 1
    for rid in (0, 1, 3):
        assert ring.requests[rid].outputs == twin[rid]
    assert paged.allocator.free_blocks == paged.allocator.num_blocks


def test_import_backpressure_and_rollback():
    """A full target refuses the import (no blocks) and ``migrate`` puts
    the request back on the source unharmed, as the reference does."""
    twin = _twin_streams("paged")
    _, src = _export_pair("paged", steps=3)
    _, dst = _engines("paged", name="dst", max_batch=1, pool_blocks=3)
    assert not can_migrate(src, dst, 0)
    with pytest.raises(OutOfBlocks):
        tmigrate(src, dst, 0)
    assert src.requests[0].status == "running"
    assert 0 not in dst.requests and dst.allocator.free_blocks == 3
    _drain(src)
    for rid in range(N_REQ):
        assert src.requests[rid].outputs == twin[rid]


def test_crc32_equals_reference_and_corruption_is_refused():
    je, te = _export_pair("paged_ring")
    js = JSnap.export(je, 1)
    ts = _to_port(js)
    ts.checksum = None
    assert ts.seal().checksum == js.checksum
    assert ts._digest() == js._digest()
    own = TSnap.export(te, 2)
    assert own.checksum == own._digest() and own.verify()
    bad = own.clone()
    bad.k.reshape(-1).view(np.uint8)[123] ^= 0x10
    assert not bad.verify() and own.verify()     # the clone is a copy
    _, dst = _engines("paged_ring", name="dst")
    free = dst.allocator.free_blocks
    with pytest.raises(SnapshotCorruption, match="checksum"):
        bad.commit(dst)
    assert dst.allocator.free_blocks == free and not dst.requests
    own.commit(dst)
    assert dst.requests[2].status == "running"


def _prefix_prompts():
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 256, 20)
    return [np.concatenate([shared, rng.integers(0, 256, 6)])
            for _ in range(3)]


def _prefix_run(pkg):
    """Request 0 publishes a 20-token prefix, request 1 shares it; 1 is
    exported (its shared blocks survive for 0) into a prefix-cache
    target, which publishes the prompt; request 2 then hits it there."""
    R = JReq if pkg == "jax" else TReq
    engines = _engines("paged_ring", name="src", prefix_cache=True)
    dsts = _engines("paged_ring", name="dst", cls="cxl", prefix_cache=True)
    src = engines[0] if pkg == "jax" else engines[1]
    dst = dsts[0] if pkg == "jax" else dsts[1]
    mig = jmigrate if pkg == "jax" else tmigrate
    p = _prefix_prompts()
    src.submit(R(id=0, prompt=p[0], max_new_tokens=10))
    src.step()
    src.submit(R(id=1, prompt=p[1], max_new_tokens=10))
    for _ in range(3):
        src.step()
    rec = mig(src, dst, 1)
    dst.submit(R(id=2, prompt=p[2], max_new_tokens=10))
    _drain(src, dst)
    out = {rid: rs.outputs for rid, rs in src.requests.items()}
    out.update({rid: rs.outputs for rid, rs in dst.requests.items()})
    counts = [{k: e.summary()[k] for k in (
        "prefix_hits", "cached_prefix_tokens", "novel_prefill_tokens",
        "cow_copies", "trie_blocks", "migrations_in", "migrations_out")}
        for e in (src, dst)]
    return out, counts, (rec["tokens"], rec["bytes"]), [
        e.allocator.check_refcounts(e.trie.block_refs()) for e in (src, dst)]


def test_prefix_cache_export_and_import_equal_jax_engine():
    got, want = _prefix_run("port"), _prefix_run("jax")
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[1][1]["prefix_hits"] == 1          # request 2 hit on dst
    assert got[2] == want[2]
    assert got[3] == want[3] == [True, True]


def test_bf16_snapshot_bits_and_crc32_equal_jax_export():
    """bf16 K/V cross as uint16 bit patterns: a JAX export, imported by a
    port engine and exported again at once, has bit-equal K/V, the same
    kv_bytes and the same crc32 seal."""
    je, _ = _engines("paged_ring", name="src", dtype="bfloat16")
    _, td = _engines("paged_ring", name="dst", dtype="bfloat16")
    _submit(je, JReq)
    for _ in range(5):
        je.step()
    js = JSnap.export(je, 1)
    assert np.asarray(js.k).dtype.name == "bfloat16"
    ts = _to_port(js)
    assert ts.k.dtype == np.uint16 and ts.checksum == js.checksum
    ts.commit(td)
    assert td.cache.k.dtype == torch.bfloat16
    back = TSnap.export(td, 1)
    for f in ("k", "v"):
        want = np.asarray(getattr(js, f)).view(np.uint16)
        assert np.array_equal(getattr(back, f), want), f
    assert np.array_equal(back.importance, np.asarray(js.importance))
    assert back.kv_bytes == js.kv_bytes
    assert back.checksum == js.checksum
    with pytest.raises(ValueError, match="uint16"):
        td.import_request(dict(_fields(back), k=back.k.astype(np.float32),
                               planned=len(back.outputs)))
