"""The port's perf model, telemetry and construction specs against the
JAX package's.

* Latency models of every device class (and 2-device replica groups)
  and of every ``SystemKind``, ``step_time_prior``, ``pool_blocks``,
  ``parse_devices``, ``replica_group_class`` and the simulations: equal
  to the reference's, exactly, over a grid of step-stats dicts.
* The same sequence of metrics-registry and trace-collector calls gives
  identical Prometheus renders, snapshots and trace JSON.
* ``EngineSpec`` / ``ClusterSpec``: the CLI round trips and actionable
  errors of the reference's ``tests/test_spec_api.py``; sharding raises
  naming its ROADMAP item, and the fault-tolerance options build the
  reference's recovery wiring.

Pure Python on both sides except the engine build (reduced qwen3-0.6b,
fp32, on the CPU).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import build_model  # noqa: E402

from repro.cluster import ClusterSpec as JClusterSpec  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.perfmodel import devices as jdev  # noqa: E402
from repro.perfmodel import latency as jlat  # noqa: E402
from repro.perfmodel import model as jmodel  # noqa: E402
from repro_torch.cluster import BalancerConfig, ClusterRouter  # noqa: E402
from repro_torch.cluster import FaultInjector, RecoveryConfig  # noqa: E402
from repro_torch.cluster import RecoveryManager  # noqa: E402
from repro_torch.cluster import ClusterSpec, ReplicaGroup  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.perfmodel import devices as tdev  # noqa: E402
from repro_torch.perfmodel import latency as tlat  # noqa: E402
from repro_torch.perfmodel import model as tmodel  # noqa: E402
from repro_torch.serving import (EngineSpec, PAMManagerConfig,  # noqa: E402
                                 ServingConfig)

CLASSES = ("hbm", "cxl", "ddr")


def _stats_grid():
    """Step-stats dicts as engines produce them: idle, prefill only,
    decode with tier reads (and moves), decode without (batch mean)."""
    rng = np.random.default_rng(0)
    out = [{"prefill_tokens": 0, "active": 0,
            "tier_reads": np.zeros(3, np.int64), "moved_tokens": 0,
            "batch_lengths": np.zeros(4, np.int32)},
           {"prefill_tokens": 1, "active": 0},
           {"prefill_tokens": 37, "active": 0,
            "tier_reads": np.zeros(3, np.int64), "moved_tokens": 0,
            "batch_lengths": np.array([0, 21, 0, 0], np.int32)}]
    for i in range(12):
        b = int(rng.integers(1, 9))
        lens = rng.integers(1, 2048, b).astype(np.int32)
        reads = (rng.integers(0, 600, 3) * (i % 3 != 0)).astype(np.int64)
        out.append({"prefill_tokens": int(rng.integers(0, 3)) * 64,
                    "active": b, "tier_reads": reads,
                    "moved_tokens": int(rng.integers(0, 9)),
                    "hit_rate": float(rng.random()),
                    "batch_lengths": lens})
    return out


def _group(mod, name, g):
    return mod.replica_group_class(mod.get_device_class(name), g)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("name", CLASSES)
def test_device_latency_models_equal_reference(name, group):
    jdc, tdc = _group(jdev, name, group), _group(tdev, name, group)
    assert dataclasses.asdict(tdc) == dataclasses.asdict(jdc)
    jl = jdev.make_device_latency_model(jdc)
    tl = tdev.make_device_latency_model(tdc)
    for stats in _stats_grid():
        assert tl(dict(stats)) == jl(dict(stats)), stats
    for kw in ({}, {"batch": 1}, {"batch": 8, "context_tokens": 2048},
               {"compression": 1}):
        assert tdev.step_time_prior(tdc, **kw) == jdev.step_time_prior(
            jdc, **kw)
    for max_len, bs in ((64, 8), (2048, 16), (128, 16)):
        assert tdc.pool_blocks(max_len, bs) == jdc.pool_blocks(max_len, bs)


@pytest.mark.parametrize("kind", [k.value for k in jmodel.SystemKind])
def test_system_latency_models_and_simulations_equal_reference(kind):
    jl = jlat.make_latency_model(jmodel.make_system(kind),
                                 jmodel.PAM_LLAMA_7B, context_scale=4)
    tl = tlat.make_latency_model(tmodel.make_system(kind),
                                 tmodel.PAM_LLAMA_7B, context_scale=4)
    for stats in _stats_grid():
        assert tl(dict(stats)) == jl(dict(stats)), stats
    for md in ("QWEN25_32B", "LLAMA3_70B", "OPT_175B", "PAM_LLAMA_7B"):
        jm, tm = getattr(jmodel, md), getattr(tmodel, md)
        js, ts = jmodel.make_system(kind), tmodel.make_system(kind)
        assert tm.kv_bytes_per_token() == jm.kv_bytes_per_token()
        for b, ctx in ((1, 512), (64, 4096), (1024, 32768)):
            assert (tmodel.simulate_decode_step(
                ts, tmodel.StepWorkload(tm, b, ctx))
                == jmodel.simulate_decode_step(
                    js, jmodel.StepWorkload(jm, b, ctx)))
            assert (tmodel.simulate_offline(ts, tm, batch=b, context=ctx)
                    == jmodel.simulate_offline(js, jm, batch=b,
                                               context=ctx))
        assert (tmodel.simulate_online(ts, tm, avg_context=4096,
                                       slo_s=0.05)
                == jmodel.simulate_online(js, jm, avg_context=4096,
                                          slo_s=0.05))


def test_parse_devices_equals_reference():
    for spec in ("hbm:1,cxl:2", "ddr", " hbm:2 , ddr:1 ,", "cxl:3"):
        assert ([d.name for d in tdev.parse_devices(spec)]
                == [d.name for d in jdev.parse_devices(spec)])
    for bad in ("warp:1", "hbm:0", "", "hbm:-2"):
        for mod in (jdev, tdev):
            with pytest.raises(ValueError):
                mod.parse_devices(bad)
    assert tdev.get_device_class("hbm") is tdev.HBM_CLASS
    assert tdev.DeviceClass("t", max_batch=2,
                            pool_scale=0.5).pool_blocks(64, 8) == 8


# --------------------------------------------------------------- telemetry
def _registry_script(m):
    """One fixed sequence of registry calls; returns (render, snapshot,
    get)."""
    reg = m.MetricsRegistry()
    c = reg.counter("pam_x_total", "x things", ("device",))
    c.labels(device="hbm0").inc()
    c.labels(device="cxl0").inc(3)
    c.labels(device="hbm0").inc(2.5)
    g = reg.gauge("pam_q", "queue")
    g.set(7)
    g.inc(-2)
    h = reg.histogram("pam_step_seconds", "step", ("device",))
    rng = np.random.default_rng(1)
    for v in rng.exponential(0.003, 200):
        h.labels(device="hbm0").observe(float(v))
    h.labels(device="cxl0").observe(0.0)
    hb = reg.histogram("pam_bytes", "b", buckets=m.BYTES_BUCKETS)
    for v in (1, 10, 1e6, 3.3e9):
        hb.observe(v)
    reg.counter("pam_x_total", "x things", ("device",))   # idempotent
    with pytest.raises(ValueError):
        reg.gauge("pam_x_total")
    off = m.MetricsRegistry(enabled=False)
    off.counter("pam_off").inc()
    return (reg.render(), reg.snapshot(), reg.get('pam_x_total{device="hbm0"}'),
            off.snapshot(), h.labels(device="hbm0").summary())


def _trace_script(m):
    coll = m.TraceCollector(capacity=64)
    coll.begin(1, "queued", 0.0, device="hbm0", prompt=16)
    coll.begin(1, "decode", 0.001, device="hbm0")
    coll.begin(1, "decode", 0.0011)              # open: dropped
    coll.slice("hbm0", "step", 0.001, 0.0005, active=1, prefill_tokens=16)
    coll.counter("hbm0", "occupancy", 0.0015, active=1, queue=0, pool=0.25)
    coll.mark(1, "migrate_out", 0.002, src="hbm0")
    coll.begin(1, "suspended", 0.002)
    coll.mark(1, "migrate_in", 0.0019, dst="cxl0")   # clamped monotone
    coll.begin(1, "decode", 0.0019, device="cxl0")
    coll.end(2, "decode", 0.003)                  # nothing open: dropped
    coll.instant("router", "tick", 0.004)
    for i in range(80):                           # overflow the ring
        coll.counter("router", "shared_queue", 0.004 + i * 1e-4, depth=i)
    coll.close_open()
    exported = coll.export()
    return json.dumps(exported, sort_keys=True), coll.dropped, \
        m.validate(exported) if coll.dropped == 0 else None


def test_metrics_registry_renders_equal_reference():
    assert _registry_script(tmetrics) == _registry_script(jmetrics)
    assert tmetrics.LATENCY_BUCKETS == jmetrics.LATENCY_BUCKETS
    assert tmetrics.TOKENS_BUCKETS == jmetrics.TOKENS_BUCKETS
    assert not tmetrics.get_registry().enabled     # off by default


def test_trace_collector_json_equals_reference():
    got, want = _trace_script(ttrace), _trace_script(jtrace)
    assert got == want
    assert got[1] > 0                             # the ring dropped some
    assert ttrace.COLLECTOR is None               # off by default
    small = ttrace.TraceCollector()
    small.begin(5, "queued", 0.0)
    small.begin(5, "decode", 0.5)
    small.close_open()
    assert ttrace.validate(small.export()) == jtrace.validate(
        _jax_small_trace())


def _jax_small_trace():
    small = jtrace.TraceCollector()
    small.begin(5, "queued", 0.0)
    small.begin(5, "decode", 0.5)
    small.close_open()
    return small.export()


# -------------------------------------------------------------- the specs
_TCF = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))


def _pam():
    return PAMManagerConfig(max_tokens=64, hot_capacity=8, warm_capacity=16,
                            compression=4, recency_window=4,
                            schedule_interval=2)


def _scfg(**kw):
    base = dict(max_batch=2, max_len=64, pam=_pam(), block_size=8,
                pool_blocks=23, hot_window=16)
    base.update(kw)
    return ServingConfig(**base)


def test_cluster_spec_cli_round_trips_like_reference():
    jcfg, _ = build_model("qwen3-0.6b")
    for devices, shard in (("hbm:1,cxl:2", 1), ("hbm:1,cxl:2", 2),
                           ("cxl:4,hbm:2", 2), ("ddr:1,hbm:1,ddr:1", 2)):
        spec = ClusterSpec.from_cli(devices, model=_TCF, serving=_scfg(),
                                    shard=shard)
        jspec = JClusterSpec.from_cli(devices, model=jcfg, serving=None,
                                      shard=shard)
        assert ([(g.cls.name, g.devices) for g in spec.groups]
                == [(g.cls.name, g.devices) for g in jspec.groups])
        assert spec.cli() == jspec.cli()
        assert spec.physical_devices == jspec.physical_devices
        assert ClusterSpec.from_cli(spec.cli(), model=_TCF, serving=_scfg(),
                                    shard=shard).groups == spec.groups
    spec = ClusterSpec.of(_TCF, [tdev.HBM_CLASS, tdev.CXL_CLASS,
                                 tdev.HBM_CLASS], serving=_scfg(), shard=2)
    assert [g.devices for g in spec.groups] == [1, 1, 1]
    assert spec.cli() == "hbm:1,cxl:1,hbm:1"


def test_spec_errors_name_the_fix():
    with pytest.raises(ValueError):
        ClusterSpec.from_cli("warp:2", model=_TCF, serving=_scfg())
    with pytest.raises(ValueError, match=r"hbm:4|shard that divides"):
        ClusterSpec.of(_TCF, [tdev.HBM_CLASS] * 3, serving=_scfg(), shard=2)
    with pytest.raises(ValueError, match="at least one replica group"):
        ClusterSpec(model=_TCF, groups=(), serving=_scfg())
    with pytest.raises(ValueError, match=">= 1 device"):
        ReplicaGroup(tdev.HBM_CLASS, devices=0)
    dense = ServingConfig(max_batch=2, max_len=64)
    with pytest.raises(ValueError, match="paged path"):
        EngineSpec(model=_TCF, serving=dense, shard=2).validate()
    with pytest.raises(ValueError, match="hot_window"):
        EngineSpec(model=_TCF, serving=_scfg(hot_window=18),
                   shard=4).validate()
    with pytest.raises(ValueError, match="pool_blocks=27"):
        EngineSpec(model=_TCF, serving=_scfg(pool_blocks=24),
                   shard=4).validate()
    with pytest.raises(ValueError, match=">= 1"):
        EngineSpec(model=_TCF, serving=_scfg(), shard=0).validate()
    EngineSpec(model=_TCF, serving=_scfg(), shard=4).validate()
    assert EngineSpec(model=_TCF, serving=_scfg()).total_pool_blocks() == 24


def test_specs_are_frozen_and_hashable():
    spec = EngineSpec(model=_TCF, serving=_scfg(), name="a")
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.shard = 2
    assert spec == EngineSpec(model=_TCF, serving=_scfg(), name="a")
    hash(spec)
    hash(ClusterSpec.from_cli("hbm:1", model=_TCF, serving=_scfg()))


def test_unported_options_raise_naming_their_items():
    """A sharded spec of a family whose cache the paged pools cannot hold
    (MLA) raises the reference's ``ValueError`` from its cache, as an
    engine and as a replica group. The fault-tolerance options (item
    8, ported) build the reference's wiring: a spec's ``RecoveryConfig``
    becomes a manager with the injector; a bare injector implies a
    default manager; a passed manager is used as it is."""
    mla = tcfg.reduced(tcfg.get_config("deepseek-v2-lite-16b"))
    with pytest.raises(ValueError, match="paged KV pools require a GQA"):
        EngineSpec(model=mla, serving=_scfg(), shard=2).build(
            None, device="cpu")
    with pytest.raises(ValueError, match="paged KV pools require a GQA"):
        ClusterSpec.from_cli("cxl:2", model=mla, serving=_scfg(),
                             shard=2).build(None, device="cpu")
    from repro_torch.models import transformer as ttf
    params = ttf.init_params(_TCF, 0, device="cpu")
    cfg = RecoveryConfig(heartbeat_timeout_s=0.5)
    inj = FaultInjector.from_spec("kill:hbm0@5")
    router = ClusterSpec.from_cli("hbm:1", model=_TCF, serving=_scfg(),
                                  recovery=cfg).build(
        params, device="cpu", faults=inj)
    assert router.recovery.cfg is cfg and router.recovery.injector is inj
    assert router.faults is inj
    assert router.devices[0].base_latency is router.devices[0].engine \
        .latency_model
    router = ClusterSpec.from_cli("hbm:1", model=_TCF, serving=_scfg()).build(
        params, device="cpu", faults=inj)
    assert router.recovery.cfg == RecoveryConfig()
    assert router.recovery.injector is inj
    rec = RecoveryManager()
    router = ClusterSpec.from_cli("hbm:1", model=_TCF, serving=_scfg(),
                                  recovery=cfg).build(
        params, device="cpu", recovery=rec)
    assert router.recovery is rec and router.faults is None
    assert "fault_tolerance" in router.summary()
    with pytest.raises(ValueError, match="at least one device"):
        ClusterRouter([], recovery=rec)


def test_cluster_build_shares_one_copy_of_the_params():
    """Every engine of a built fleet holds the caller's params tensors
    (no per-engine copy), with its class's batch and pool and the
    perf model's latency; the balancer charges the modeled bytes per
    token."""
    from repro_torch.models import transformer as ttf
    params = ttf.init_params(_TCF, 0, device="cpu")
    router = ClusterSpec.from_cli(
        "hbm:1,cxl:2", model=_TCF, serving=_scfg(),
        balancer=BalancerConfig()).build(params, device="cpu")
    assert [d.name for d in router.devices] == ["hbm0", "cxl0", "cxl1"]
    for d in router.devices:
        eng = d.engine
        assert eng.params is params
        assert eng.scfg.max_batch == d.cls.max_batch
        assert eng.scfg.pool_blocks == d.cls.pool_blocks(64, 8)
        assert d.step_prior == tdev.step_time_prior(d.cls)
        assert eng.latency_model is not None
        assert d.prefill_tok_prior == eng.latency_model(
            {"prefill_tokens": 1, "active": 0})
    assert (router.balancer.token_bytes
            == tmodel.PAM_LLAMA_7B.kv_bytes_per_token())
    wall = ClusterSpec.from_cli("hbm:1", model=_TCF, serving=_scfg(),
                                wallclock=True).build(params, device="cpu")
    assert wall.devices[0].engine.latency_model is None
