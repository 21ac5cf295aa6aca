"""The port's multi-device cluster against the JAX package's, event for
event.

Each engine's clock advances by its device class's latency model over
its step stats, and the router always steps the engine furthest behind,
so a seeded stream is deterministic. On ``hbm:1,cxl:2`` with the online
balancer, the port's ``ClusterSpec`` fleet gives the JAX fleet's list of
``ServeEvent``s (time, request, token, index, device, done, rejected),
``summary()``, balancer log, metrics snapshot and trace JSON, greedy and
sampled (temperature 0.8, top-k 5). The snapshot is compared whole,
the fault-tolerance layer's router series included (both packages
register ``pam_cluster_sheds_total`` and
``pam_cluster_force_preempts_total``, 0 in these runs).

Also: spill to the slow devices under overload, rejection of an
unserviceable request, ``engine.serve()`` / ``as_router()`` against the
JAX engine's, and the serve CLI's ``--devices`` mode on the CPU.

Reduced qwen3-0.6b (fp32), weights from the JAX package's
``init_params`` through ``repro_torch.bridge``; prompts and arrivals
from fixed numpy seeds.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import build_model, make_pam  # noqa: E402

from repro.cluster import BalancerConfig as JBal  # noqa: E402
from repro.cluster import ClusterSpec as JCluster  # noqa: E402
from repro.cluster import KVBalancer as JBalancer  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.perfmodel import devices as jdev  # noqa: E402
from repro.serving import EngineSpec as JSpec  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.serving import ServingConfig as JSC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.cluster import BalancerConfig as TBal  # noqa: E402
from repro_torch.cluster import ClusterRouter  # noqa: E402
from repro_torch.cluster import ClusterSpec as TCluster  # noqa: E402
from repro_torch.cluster import KVBalancer as TBalancer  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.perfmodel import devices as tdev  # noqa: E402
from repro_torch.serving import EngineSpec as TSpec  # noqa: E402
from repro_torch.serving import PAMManagerConfig  # noqa: E402
from repro_torch.serving import Request as TReq  # noqa: E402
from repro_torch.serving import ServeEvent  # noqa: E402
from repro_torch.serving import ServingConfig as TSC  # noqa: E402

torch.set_num_threads(2)

JCFG, JPARAMS = build_model("qwen3-0.6b")
TCF = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


TPARAMS = bridge.params_from_jax(TCF, _np_tree(JPARAMS), device="cpu")
JPAM = make_pam(max_len=64, hot=4, warm=8, recency_window=2)
TPAM = PAMManagerConfig(
    max_tokens=JPAM.max_tokens, hot_capacity=JPAM.hot_capacity,
    warm_capacity=JPAM.warm_capacity, compression=JPAM.compression,
    recency_window=JPAM.recency_window,
    schedule_interval=JPAM.schedule_interval)
LAYOUT = dict(max_batch=4, max_len=64, block_size=8, hot_window=16)
SAMPLED = dict(temperature=0.8, top_k=5, sample_seed=3)
# scripts/cluster_smoke.py's balancer
BALANCER = dict(rebalance_interval=2, hysteresis=1.1, cooldown_ticks=4,
                min_remaining=2)
FT_SERIES = ("pam_cluster_force_preempts_total", "pam_cluster_sheds_total")


def _stream(R, n_pinned=4, n=16, seed=0, max_new=12):
    """``n_pinned`` requests for ``cxl0`` at arrival 0 (to load the slow
    device, as scripts/cluster_smoke.py does), then Poisson arrivals of
    mean gap 2 ms with prompts of 10-30 tokens."""
    rng = np.random.default_rng(seed)
    pinned = [R(id=i, prompt=rng.integers(0, 256, 16),
                max_new_tokens=max_new) for i in range(n_pinned)]
    t, rest = 0.0, []
    for i in range(n_pinned, n):
        t += float(rng.exponential(0.002))
        rest.append(R(id=i, prompt=rng.integers(0, 256,
                                                int(rng.integers(10, 30))),
                      max_new_tokens=max_new, arrival=t))
    return pinned, rest


def _router(pkg, devices="hbm:1,cxl:2", balancer=True, **serving):
    kw = dict(LAYOUT, **serving)
    if pkg == "jax":
        bal = JBalancer(JBal(**BALANCER)) if balancer else None
        return JCluster.from_cli(devices, model=JCFG,
                                 serving=JSC(pam=JPAM, **kw)).build(
            JPARAMS, balancer=bal)
    bal = TBalancer(TBal(**BALANCER)) if balancer else None
    return TCluster.from_cli(devices, model=TCF,
                             serving=TSC(pam=TPAM, **kw)).build(
        TPARAMS, balancer=bal, device="cpu")


def _events(evs):
    return [(e.time, e.request_id, e.token, e.index, e.device, e.done,
             e.rejected) for e in evs]


def _serve(pkg, stream_kw=None, telemetry=False, **router_kw):
    """Run the stream; returns (events, summary, balancer log, metrics
    snapshot, trace JSON, router)."""
    metrics, trace = (jmetrics, jtrace) if pkg == "jax" else (tmetrics,
                                                              ttrace)
    reg = metrics.MetricsRegistry(enabled=telemetry)
    with metrics.use(reg), trace.use() as coll:
        router = _router(pkg, **router_kw)
        pinned, rest = _stream(JReq if pkg == "jax" else TReq,
                               **(stream_kw or {}))
        for r in pinned:
            router.submit_to(r, "cxl0")
        evs = list(router.serve(rest))
        snap = reg.snapshot()
        if telemetry:
            for key in FT_SERIES:
                assert snap["counters"][key] == 0.0
        coll.close_open()
        tr = json.dumps(coll.export(), sort_keys=True)
    log = router.balancer.log if router.balancer is not None else []
    return _events(evs), router.summary(), log, snap, tr, router


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_cluster_matches_jax_event_for_event(sampling):
    kw = SAMPLED if sampling == "sampled" else {}
    got = _serve("port", telemetry=True, **kw)
    want = _serve("jax", telemetry=True, **kw)
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert g == w, (i, g, w)
    assert len(got[0]) == len(want[0]) == 16 * 12
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[1]["balancer_migrations"] >= 1
    assert got[3] == want[3]
    assert got[4] == want[4]
    counters = got[3]["counters"]
    assert counters['pam_engine_migrations_total{device="hbm0",' \
                    'direction="in"}'] >= 1
    # the migrated requests' streams are the events' tokens
    router = got[5]
    for rid, rs in router.finished.items():
        assert [e[2] for e in got[0] if e[1] == rid] == rs.outputs


def test_spill_to_slow_devices_under_overload():
    """12 concurrent requests overflow the fast device's 4 slots: the
    router admits the rest on the slow devices, as the JAX router does."""
    kw = dict(stream_kw=dict(n_pinned=0, n=12, max_new=16), balancer=False)
    got, want = _serve("port", **kw), _serve("jax", **kw)
    assert got[0] == want[0] and got[1] == want[1]
    used = [n for n, d in got[1]["devices"].items() if d["tokens_emitted"]]
    assert len(used) >= 2 and got[1]["finished"] == 12
    assert (got[5].slo_attainment(1e-3) == want[5].slo_attainment(1e-3))


def test_unserviceable_request_is_rejected():
    got, want = [], []
    for pkg, out in (("port", got), ("jax", want)):
        R = JReq if pkg == "jax" else TReq
        router = _router(pkg, devices="hbm:1", balancer=False)
        router.submit(R(id=0, prompt=np.arange(16), max_new_tokens=4))
        router.submit(R(id=99, prompt=np.arange(60), max_new_tokens=30,
                        arrival=99.0))
        s = router.run()
        router.submit_to(R(id=98, prompt=np.arange(60), max_new_tokens=30,
                           arrival=100.0), "hbm0")
        out += [_events(router.drain_events()), s, router.rejected]
    assert got == want
    rejected = [e for e in got[0] if e[6]]
    assert [e[1] for e in rejected] == [99, 98]
    assert all(e[2] == -1 and e[5] for e in rejected)
    assert got[1]["finished"] == 1 and got[2] == 2


def test_engine_serve_and_as_router_equal_jax_engine():
    """``engine.serve()`` is the one-device router's stream: the same
    events as the JAX engine's, on the modeled clock."""
    got = []
    for pkg in ("port", "jax"):
        if pkg == "jax":
            eng = JSpec(model=JCFG, serving=JSC(pam=JPAM, **LAYOUT),
                        name="solo").build(
                JPARAMS, latency_model=jdev.make_device_latency_model(
                    jdev.HBM_CLASS))
        else:
            eng = TSpec(model=TCF, serving=TSC(pam=TPAM, **LAYOUT),
                        name="solo").build(
                TPARAMS, latency_model=tdev.make_device_latency_model(
                    tdev.HBM_CLASS), device="cpu")
        R = JReq if pkg == "jax" else TReq
        _, rest = _stream(R, n_pinned=0, n=6, max_new=6)
        evs = list(eng.serve(rest))
        assert all(isinstance(e, ServeEvent) == (pkg == "port")
                   for e in evs)
        got.append((_events(evs), eng.summary()["sim_time_s"]))
    assert got[0] == got[1]
    assert sum(e[5] for e in got[0][0]) == 6
    eng = TSpec(model=TCF, serving=TSC(pam=TPAM, **LAYOUT)).build(
        TPARAMS, device="cpu")
    router = eng.as_router()
    assert isinstance(router, ClusterRouter) and router.as_router() is router
    assert [d.engine for d in router.devices] == [eng]
    assert router.recovery is None
    pre = ClusterRouter.for_engine(eng, preemptible=True)
    assert pre.recovery is not None and not pre.recovery.suspended
    assert eng.as_router(preemptible=True).recovery is not None


def test_serve_cli_devices_mode_on_cpu(capsys):
    from repro_torch.launch import serve
    args = ["--reduced", "--device", "cpu", "--devices", "hbm:1,cxl:2",
            "--requests", "6", "--prompt-len", "24", "--gen-len", "6",
            "--max-len", "64", "--block-size", "8", "--hot-window", "16"]
    summ = serve.main(args)
    assert summ["finished"] == 6 and summ["total_tokens"] == 36
    assert sorted(summ["devices"]) == ["cxl0", "cxl1", "hbm0"]
    assert summ["makespan_s"] > 0 and summ["rejected"] == 0
    assert '"makespan_s"' in capsys.readouterr().out
    wall = serve.main(args + ["--system", "wallclock", "--requests", "2"])
    assert wall["finished"] == 2
    with pytest.raises(ValueError, match="paged KV pools require a GQA"):
        serve.main(args + ["--arch", "deepseek-v2-lite-16b", "--shard",
                           "2"])
    chaos = serve.main(args + ["--chaos", "kill:cxl1@5"])
    assert chaos["finished"] == 6
    assert chaos["devices"]["cxl1"]["state"] == "dead"
    assert chaos["fault_tolerance"]["kills_detected"] == 1
