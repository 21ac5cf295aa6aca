"""The port's fault-tolerant cluster against the JAX package's, event for
event.

Every case of the reference's ``tests/test_faults.py`` runs on both
fleets under the same spec, requests and fault trace: hard kills replayed
on survivors (greedy and sampled), the watchdog waiting out a silent sole
worker, a kill with no survivor, a stalled device drained, a slower
device class never flagged, snapshot corruption, transfer retry through
drop and corruption, terminal transfer failure with rollback, pool
exhaustion with preemption and resume, and the balancer kept off a
killed device. Equal means: the ``ServeEvent`` list (time, request,
token, index, device, done, rejected), ``summary()`` with its
``fault_tolerance`` block and device states, the recovery latencies, the
balancer log, the metrics snapshot and the trace JSON. Beyond the
reference's cases: ``kill:cxl1@40``, the mixed chaos trace (stall, kill,
corrupt, drop) and ``exhaust`` / ``release`` on ``hbm:1,cxl:2`` with
the balancer; ``parse_chaos``; and the byte positions a seeded
``corrupt`` flips, which equal the reference's.

Reduced qwen3-0.6b (fp32), weights from the JAX package's
``init_params`` through ``repro_torch.bridge``; prompts from fixed numpy
seeds; engines on the CPU.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import build_model, make_pam  # noqa: E402

from repro import cluster as jcl  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.perfmodel import devices as jdev  # noqa: E402
from repro.serving import EngineSpec as JSpec  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.serving import ServingConfig as JSC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import cluster as tcl  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.perfmodel import devices as tdev  # noqa: E402
from repro_torch.serving import EngineSpec as TSpec  # noqa: E402
from repro_torch.serving import PAMManagerConfig  # noqa: E402
from repro_torch.serving import Request as TReq  # noqa: E402
from repro_torch.serving import ServingConfig as TSC  # noqa: E402

torch.set_num_threads(2)

JCFG, JPARAMS = build_model("qwen3-0.6b")
TCF = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


TPARAMS = bridge.params_from_jax(TCF, _np_tree(JPARAMS), device="cpu")
# tests/test_faults.py's policy and layout
JPAM = make_pam(max_len=64, hot=4, warm=8, recency_window=2)
TPAM = PAMManagerConfig(
    max_tokens=JPAM.max_tokens, hot_capacity=JPAM.hot_capacity,
    warm_capacity=JPAM.warm_capacity, compression=JPAM.compression,
    recency_window=JPAM.recency_window,
    schedule_interval=JPAM.schedule_interval)
LAYOUT = dict(max_batch=4, max_len=64, block_size=8)
# scripts/cluster_smoke.py's balancer
BALANCER = dict(rebalance_interval=2, hysteresis=1.1, cooldown_ticks=4,
                min_remaining=2)


class _Pkg:
    """One package's side of a case: its cluster module, requests,
    serving config, device classes and telemetry modules."""

    def __init__(self, name):
        self.name = name
        jax = name == "jax"
        self.cl = jcl if jax else tcl
        self.R = JReq if jax else TReq
        self.dev = jdev if jax else tdev
        self.metrics = jmetrics if jax else tmetrics
        self.trace = jtrace if jax else ttrace

    def scfg(self, **kw):
        if self.name == "jax":
            return JSC(pam=JPAM, **LAYOUT, **kw)
        return TSC(pam=TPAM, **LAYOUT, **kw)

    def spec(self, classes, **kw):
        cfg = JCFG if self.name == "jax" else TCF
        return self.cl.ClusterSpec.of(
            cfg, [self.dev.get_device_class(c) for c in classes], **kw)

    def build(self, spec, **kw):
        if self.name == "jax":
            return spec.build(JPARAMS, **kw)
        return spec.build(TPARAMS, device="cpu", **kw)

    def engine(self, name, **kw):
        if self.name == "jax":
            return JSpec(model=JCFG, serving=self.scfg(**kw),
                         name=name).build(JPARAMS)
        return TSpec(model=TCF, serving=self.scfg(**kw), name=name).build(
            TPARAMS, device="cpu")

    def requests(self, n, plen=16, max_new=12, seed=0):
        """conftest.make_requests' draws."""
        rng = np.random.default_rng(seed)
        return [self.R(id=i, prompt=rng.integers(0, JCFG.vocab, plen),
                       max_new_tokens=max_new) for i in range(n)]


PKGS = {n: _Pkg(n) for n in ("jax", "port")}


def _events(evs):
    return [(e.time, e.request_id, e.token, e.index, e.device, e.done,
             e.rejected) for e in evs]


def _fleet(pkg, case):
    """Run ``case(pkg)`` (which builds, loads and runs a router) under a
    fresh metrics registry and trace collector; returns everything the
    packages must agree on."""
    p = PKGS[pkg]
    reg = p.metrics.MetricsRegistry()
    with p.metrics.use(reg), p.trace.use() as coll:
        router = case(p)
        snap = reg.snapshot()
        coll.close_open()
        tr = json.dumps(coll.export(), sort_keys=True)
    rec = router.recovery
    return dict(
        events=_events(router.drain_events()), summary=router.summary(),
        latencies=list(rec.recovery_latencies) if rec else None,
        balancer=router.balancer.log if router.balancer else None,
        metrics=snap, trace=tr,
        outputs={rid: rs.outputs for rid, rs in router.finished.items()})


def _both(case):
    got, want = _fleet("port", case), _fleet("jax", case)
    for i, (g, w) in enumerate(zip(got["events"], want["events"])):
        assert g == w, (i, g, w)
    for key in want:
        assert got[key] == want[key], key
    return got


def _assert_stream_integrity(got, rids):
    """Zero lost tokens: every stream is gapless, free of duplicates,
    equal to its finished outputs and ends with one done marker."""
    for rid in rids:
        mine = [e for e in got["events"] if e[1] == rid and not e[6]]
        assert [e[3] for e in mine] == list(range(len(mine))), rid
        assert [e[2] for e in mine] == got["outputs"][rid]
        assert sum(e[5] for e in mine) == 1 and mine[-1][5]


# ---------------------------------------------------- replay (hard kill)
def _kill_case(seed, tick, **scfg):
    def case(p):
        inj = p.cl.FaultInjector([p.cl.FaultEvent(tick=tick, kind="kill",
                                                  device="hbm1")])
        router = p.build(p.spec(
            ["hbm", "hbm"], serving=p.scfg(**scfg),
            recovery=p.cl.RecoveryConfig(heartbeat_timeout_s=0.01)),
            faults=inj)
        for i, r in enumerate(p.requests(4, seed=seed)):
            router.submit_to(r, f"hbm{i % 2}")
        router.run()
        return router
    return case


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_kill_replay_equals_jax_fleet(sampling):
    if sampling == "greedy":
        got = _both(_kill_case(0, 6))
    else:
        got = _both(_kill_case(2, 7, temperature=1.0, sample_seed=11))
    s = got["summary"]
    assert s["finished"] == 4 and s["rejected"] == 0
    ft = s["fault_tolerance"]
    assert ft["kills_detected"] == 1 and ft["replays"] >= 1
    assert ft["recovery_latency_mean_s"] > 0
    assert s["devices"]["hbm1"]["state"] == "dead"
    _assert_stream_integrity(got, range(4))


def test_watchdog_waits_out_a_silent_sole_worker():
    timeout = 0.05

    def case(p):
        inj = p.cl.FaultInjector([p.cl.FaultEvent(tick=4, kind="kill",
                                                  device="hbm1")])
        router = p.build(p.spec(
            ["hbm", "hbm"], serving=p.scfg(),
            recovery=p.cl.RecoveryConfig(heartbeat_timeout_s=timeout)),
            faults=inj)
        for r in p.requests(2, seed=3):
            router.submit_to(r, "hbm1")      # hbm0 stays idle
        router.run()
        return router
    got = _both(case)
    ft = got["summary"]["fault_tolerance"]
    assert got["summary"]["finished"] == 2
    assert ft["kills_detected"] == 1 and ft["replays"] == 2
    assert ft["recovery_latency_mean_s"] >= timeout
    _assert_stream_integrity(got, range(2))


def test_kill_with_no_survivor_degrades_to_rejection():
    def case(p):
        inj = p.cl.FaultInjector([p.cl.FaultEvent(tick=3, kind="kill",
                                                  device="hbm0")])
        router = p.build(p.spec(
            ["hbm"], serving=p.scfg(),
            recovery=p.cl.RecoveryConfig(heartbeat_timeout_s=0.01)),
            faults=inj)
        for r in p.requests(2, seed=4):
            router.submit(r)
        router.run()
        return router
    got = _both(case)
    assert got["summary"]["finished"] == 0
    assert got["summary"]["rejected"] == 2
    assert sum(e[6] for e in got["events"]) == 2


# ------------------------------------------------- drain (straggler stall)
def test_stall_drain_sampled_equals_jax_fleet():
    def case(p):
        inj = p.cl.FaultInjector([p.cl.FaultEvent(
            tick=4, kind="stall", device="hbm1", factor=50.0)])
        router = p.build(p.spec(
            ["hbm", "hbm"], serving=p.scfg(temperature=1.0, sample_seed=9),
            recovery=p.cl.RecoveryConfig()), faults=inj)
        for i, r in enumerate(p.requests(4, seed=5)):
            router.submit_to(r, f"hbm{i % 2}")
        router.run()
        return router
    got = _both(case)
    s = got["summary"]
    assert s["finished"] == 4 and s["rejected"] == 0
    assert s["fault_tolerance"]["drains"] >= 1
    assert s["fault_tolerance"]["kills_detected"] == 0
    assert s["devices"]["hbm1"]["state"] == "drained"
    assert s["devices"]["hbm0"]["migrations_in"] >= 1
    _assert_stream_integrity(got, range(4))


def test_heterogeneous_slow_device_is_not_a_straggler():
    def case(p):
        router = p.build(p.spec(["hbm", "cxl"], serving=p.scfg(),
                                recovery=p.cl.RecoveryConfig()))
        for r in p.requests(6, seed=6):
            router.submit(r)
        router.run()
        return router
    got = _both(case)
    s = got["summary"]
    assert s["finished"] == 6 and s["fault_tolerance"]["drains"] == 0
    assert all(d["state"] == "up" for d in s["devices"].values())


# --------------------------------------------------- transfer corruption
def _mid_decode_pair(p, n=2, steps=4):
    src, dst = p.engine("src"), p.engine("dst")
    for r in p.requests(n, seed=7):
        src.submit(r)
    for _ in range(steps):
        src.step()
    return src, dst


def test_snapshot_checksum_detects_corruption_at_the_same_bytes():
    """The seeded injector flips the same byte positions of the same
    snapshot in both packages, so the damaged wire copies are equal; both
    are refused before anything is committed."""
    wires = {}
    for pkg, p in PKGS.items():
        src, dst = _mid_decode_pair(p)
        snap = p.cl.KVSnapshot.export(src, 0)
        assert snap.checksum is not None and snap.verify()
        wire = snap.clone()
        p.cl.FaultInjector([]).corrupt(wire)
        assert not wire.verify()
        with pytest.raises(p.cl.SnapshotCorruption):
            wire.commit(dst)
        assert snap.verify()                 # sender copy untouched
        assert 0 not in dst.requests         # nothing half-committed
        wires[pkg] = (snap, wire)
    (ts, tw), (js, jw) = wires["port"], wires["jax"]
    flipped = np.flatnonzero(tw.k.reshape(-1).view(np.uint8)
                             != ts.k.reshape(-1).view(np.uint8))
    jflipped = np.flatnonzero(np.asarray(jw.k).reshape(-1).view(np.uint8)
                              != np.asarray(js.k).reshape(-1).view(np.uint8))
    assert len(flipped) >= 1 and np.array_equal(flipped, jflipped)


@pytest.mark.parametrize("layout", [
    dict(), dict(block_size=8), dict(block_size=8, hot_window=16)])
def test_suspended_snapshot_owns_its_arrays(layout):
    """A snapshot held while its slot serves another request keeps its
    seal: on a CPU engine export copies the KV and PAM rows instead of
    aliasing the live cache (dense, paged and ring layouts)."""
    eng = TSpec(model=TCF, serving=TSC(pam=TPAM, max_batch=1, max_len=64,
                                       **layout)).build(TPARAMS,
                                                        device="cpu")
    reqs = PKGS["port"].requests(2, seed=11)
    eng.submit(reqs[0])
    for _ in range(3):
        eng.step()
    rec = tcl.RecoveryManager()
    snap = rec.suspend(eng, 0, tick=0)
    before = snap.k.copy(), snap.importance.copy()
    eng.submit(reqs[1])
    for _ in range(4):
        eng.step()
    assert snap.verify()
    assert np.array_equal(snap.k, before[0])
    assert np.array_equal(snap.importance, before[1])
    assert rec.stats["preemptions"] == 1 and rec.resumable(8) == [snap]


def _transfer(p, retries, events, rid=1):
    src, dst = _mid_decode_pair(p)
    inj = p.cl.FaultInjector(events(p))
    inj.due(0)                               # arm the verdict queue
    rec = p.cl.RecoveryManager(
        p.cl.RecoveryConfig(transfer_retries=retries), injector=inj)
    snap = p.cl.KVSnapshot.export(src, rid)
    charged = []
    ok = rec.transfer(snap, dst, charged.append)
    return src, dst, rec, snap, charged, ok


def test_transfer_retries_through_drop_and_corruption():
    out = {}
    for pkg, p in PKGS.items():
        src, dst, rec, _, charged, ok = _transfer(p, 3, lambda p: [
            p.cl.FaultEvent(tick=0, kind="drop"),
            p.cl.FaultEvent(tick=0, kind="corrupt")])
        assert ok
        src.run()
        dst.run()
        out[pkg] = (dict(rec.stats), charged, src.requests[0].outputs,
                    dst.requests[1].outputs)
    assert out["port"] == out["jax"]
    stats = out["port"][0]
    assert stats["transfers_dropped"] == 1
    assert stats["corruptions_detected"] == 1
    assert stats["transfer_retries"] == 2 and sum(out["port"][1]) > 0


def test_transfer_terminal_failure_rolls_back_to_source():
    out = {}
    for pkg, p in PKGS.items():
        src, dst, rec, snap, charged, ok = _transfer(p, 1, lambda p: [
            p.cl.FaultEvent(tick=0, kind="corrupt", count=8)])
        assert not ok and snap.verify()
        snap.commit(src)                     # rollback
        src.run()
        out[pkg] = (dict(rec.stats), charged, src.requests[1].outputs,
                    dst.migrations_in)
    assert out["port"] == out["jax"]
    assert out["port"][0]["transfer_failures"] == 1
    assert out["port"][3] == 0


# ------------------------------------------- preemption / pool exhaustion
def test_pool_exhaustion_preempts_and_resumes_like_jax_fleet():
    def case(p):
        reqs = p.requests(3, plen=20, max_new=12, seed=8)
        inj = p.cl.FaultInjector([p.cl.FaultEvent(tick=2, kind="exhaust",
                                                  device="hbm0")])
        router = p.build(p.spec(
            ["hbm"], serving=p.scfg(),
            recovery=p.cl.RecoveryConfig(preempt_after_ticks=5,
                                         resume_cooldown_ticks=2)),
            faults=inj)
        router.submit_to(reqs[0], "hbm0")
        router.submit_to(reqs[1], "hbm0")
        for _ in range(4):                   # both mid-decode first
            router.tick()
        router.submit(reqs[2])
        router.run()
        return router
    got = _both(case)
    s = got["summary"]
    assert s["finished"] == 3 and s["rejected"] == 0
    ft = s["fault_tolerance"]
    assert ft["preemptions"] >= 1 and ft["resumes"] >= 1
    assert ft["suspended_now"] == 0
    _assert_stream_integrity(got, range(3))


# ------------------------------------------------------ balancer gating
def test_balancer_never_targets_a_killed_device():
    def case(p):
        inj = p.cl.FaultInjector([p.cl.FaultEvent(tick=1, kind="kill",
                                                  device="hbm0")])
        bal = p.cl.KVBalancer(p.cl.BalancerConfig(
            rebalance_interval=2, hysteresis=1.1, cooldown_ticks=2,
            min_remaining=2))
        router = p.build(p.spec(
            ["hbm", "cxl"], serving=p.scfg(),
            recovery=p.cl.RecoveryConfig(heartbeat_timeout_s=0.01)),
            balancer=bal, faults=inj)
        for r in p.requests(4, seed=9):
            router.submit_to(r, "cxl0")      # load the slow device only
        router.run()
        return router
    got = _both(case)
    s = got["summary"]
    assert s["finished"] == 4 and s["balancer_migrations"] == 0
    assert s["devices"]["hbm0"]["migrations_in"] == 0
    assert all(len(o) == 12 for o in got["outputs"].values())


# ------------------------------------- the chaos fleet on hbm:1,cxl:2
CHAOS = {
    "kill": "kill:cxl1@40",
    # benchmarks/chaos_bench.py's mixed trace, plus a dropped transfer
    "mixed": "stall:cxl0@25x6, kill:cxl1@40, corrupt@30*1, drop@45",
    "exhaust_release": "exhaust:hbm0@10, release:hbm0@60",
}


def _chaos_case(spec, seed=0, n=16, pinned=4, new=12, **scfg):
    """``pinned`` requests on cxl1 at arrival 0 (so a kill there lands on
    running work), the rest at Poisson gaps of mean 2 ms of modeled
    time, over ``hbm:1,cxl:2`` with a hot ring, the balancer and
    ``RecoveryConfig()``."""
    def case(p):
        rng = np.random.default_rng(seed)
        reqs, t = [], 0.0
        for i in range(n):
            if i >= pinned:
                t += float(rng.exponential(0.002))
            plen = int(rng.integers(10, 30))
            reqs.append(p.R(id=i, prompt=rng.integers(0, 256, plen),
                            max_new_tokens=new, arrival=t))
        cfg = JCFG if p.name == "jax" else TCF
        spec_ = p.cl.ClusterSpec.from_cli(
            "hbm:1,cxl:2", model=cfg,
            serving=p.scfg(hot_window=16, **scfg),
            recovery=p.cl.RecoveryConfig())
        router = p.build(
            spec_, balancer=p.cl.KVBalancer(p.cl.BalancerConfig(**BALANCER)),
            faults=p.cl.FaultInjector.from_spec(spec, seed=seed))
        for r in reqs[:pinned]:
            router.submit_to(r, "cxl1")
        for r in reqs[pinned:]:
            router.submit(r)
        router.run()
        return router
    return case


@pytest.mark.parametrize("chaos", sorted(CHAOS))
def test_chaos_fleet_equals_jax_fleet(chaos):
    got = _both(_chaos_case(CHAOS[chaos]))
    s, ft = got["summary"], got["summary"]["fault_tolerance"]
    assert s["finished"] == 16 and s["rejected"] == 0
    _assert_stream_integrity(got, range(16))
    if chaos != "exhaust_release":
        assert ft["kills_detected"] == 1 and ft["replays"] >= 1
        assert s["devices"]["cxl1"]["state"] == "dead"
    if chaos == "mixed":
        assert s["devices"]["cxl0"]["state"] == "drained"
        assert ft["drains"] >= 1


def test_chaos_fleet_sampled_equals_jax_fleet():
    got = _both(_chaos_case(CHAOS["mixed"], seed=1, temperature=0.8,
                            top_k=5, sample_seed=3))
    assert got["summary"]["finished"] == 16
    _assert_stream_integrity(got, range(16))


# ------------------------------------------------------------- chaos spec
def test_chaos_spec_parser_equals_reference():
    spec = ("kill:hbm0@120, stall:cxl0@50x8, corrupt@30*2, "
            "exhaust:cxl1@25, drop@7, release:cxl1@90, unstall:cxl0@60")
    got, want = tcl.parse_chaos(spec), jcl.parse_chaos(spec)
    assert [dataclasses_tuple(e) for e in got] == [
        dataclasses_tuple(e) for e in want]
    assert [e.kind for e in got[:4]] == ["kill", "stall", "corrupt",
                                        "exhaust"]
    assert got[0] == tcl.FaultEvent(tick=120, kind="kill", device="hbm0")
    assert got[1].factor == 8.0 and got[1].tick == 50
    assert got[2].count == 2 and got[2].device == ""
    for bad in ("kill:hbm0", "melt:hbm0@3", "kill@3"):
        with pytest.raises(ValueError):
            tcl.parse_chaos(bad)
        with pytest.raises(ValueError):
            jcl.parse_chaos(bad)


def dataclasses_tuple(ev):
    return (ev.tick, ev.kind, ev.device, ev.factor, ev.count)


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_injector_flips_the_reference_bytes(dtype):
    """The same seed flips the same byte positions as the reference's
    injector, for fp32 K and for bf16 K held as ``uint16`` bits; the
    verdict queue drains in the same order."""
    shape = (2, 2, 64, 16)
    base = np.random.default_rng(0).standard_normal(shape).astype(
        np.float32)
    if dtype == np.uint16:
        base = (base.view(np.uint32) >> 16).astype(np.uint16)

    class _Snap:                             # a corruptible stand-in
        def __init__(self, k):
            self.k = k
    for seed in (0, 1, 7):
        a = tcl.FaultInjector.from_spec("corrupt@0*2, drop@0", seed=seed)
        b = jcl.FaultInjector.from_spec("corrupt@0*2, drop@0", seed=seed)
        assert ([dataclasses_tuple(e) for e in a.due(0)]
                == [dataclasses_tuple(e) for e in b.due(0)])
        ka, kb = base.copy(), base.copy()
        for _ in range(2):
            a.corrupt(_Snap(ka))
            b.corrupt(_Snap(kb))
        assert ka.tobytes() == kb.tobytes() and ka.tobytes() != base.tobytes()
        assert [a.transfer_verdict() for _ in range(4)] == [
            b.transfer_verdict() for _ in range(4)] == [
            "corrupt", "corrupt", "drop", "ok"]
        assert a.exhausted and b.exhausted


# --------------------------------------- chip_smoke's dry-run constants
def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("phase", ["engine_chaos", "serve_frontend"])
def test_chip_smoke_dry_run_counts_hold(phase):
    """The recovery and admission counts ``chip_smoke.py`` holds the card
    runs to (``CHAOS_DRY_RUN``, ``SERVE_DRY_RUN``) are what the same
    schedules give on the CPU at the reduced size, under two weight
    seeds (the modeled schedule does not depend on the weights)."""
    from repro_torch.models import transformer as ttf
    cs = _chip_smoke()
    for seed in (0, 1):
        params = ttf.init_params(TCF, seed, device="cpu")
        if phase == "engine_chaos":
            run = cs.chaos_fleet_run(TCF, params, device="cpu")
            ft = run["router"].summary()["fault_tolerance"]
            assert {k: ft[k] for k in cs.CHAOS_COUNTS} == cs.CHAOS_DRY_RUN
            assert run["router"]._by_name("cxl1").state == "dead"
        else:
            run = cs.serve_frontend_run(TCF, params, device="cpu")
            assert cs._serve_counts(run) == cs.SERVE_DRY_RUN
