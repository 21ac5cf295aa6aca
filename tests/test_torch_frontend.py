"""The port's serving front end against the JAX package's.

* ``make_trace`` gives the reference's trace (arrivals, prompts, budgets)
  for all three kinds, and refuses the same bad configs; ``score`` and
  ``stream_integrity`` give the reference's scorecards.
* ``AsyncServer`` over one engine on the ``pam`` latency model streams
  the JAX server's tokens at the JAX server's modeled times (records,
  summary, metrics snapshot), through ``serve_trace``, a live
  ``StreamHandle`` and the NDJSON endpoint on port 0.
* ``SLOAdmission`` sheds and force-preempts exactly where the
  reference's does (the same records, counts and router summary), and
  disarms shedding in wall-clock mode; ``ClusterRouter.shed`` /
  ``force_preempt`` touch only what their contracts say.
* The serve CLI's ``--chaos``, ``--serve``, ``--serve --port 0``,
  ``--trace-out`` and ``--metrics-interval`` on the CPU: the modeled
  fields equal the JAX CLI's on the same weights.

Reduced qwen3-0.6b (fp32), weights from the JAX package's
``init_params`` through ``repro_torch.bridge``; traces from fixed seeds;
engines on the CPU. The cases are the reference's
``tests/test_frontend.py``.
"""

import asyncio
import contextlib
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import build_model, make_pam  # noqa: E402

from repro.frontend import admission as jadm  # noqa: E402
from repro.frontend import loadgen as jlg  # noqa: E402
from repro.frontend import server as jsrv  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.perfmodel import make_latency_model as jlatency  # noqa: E402
from repro.perfmodel.model import PAM_LLAMA_7B as JDESC  # noqa: E402
from repro.perfmodel.model import make_system as jsystem  # noqa: E402
from repro.serving import EngineSpec as JSpec  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.serving import ServingConfig as JSC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.frontend import admission as tadm  # noqa: E402
from repro_torch.frontend import loadgen as tlg  # noqa: E402
from repro_torch.frontend import server as tsrv  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.perfmodel import PAM_LLAMA_7B as TDESC  # noqa: E402
from repro_torch.perfmodel import make_latency_model as tlatency  # noqa: E402
from repro_torch.perfmodel import make_system as tsystem  # noqa: E402
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


@dataclasses.dataclass
class _Pkg:
    name: str
    lg: object
    adm: object
    srv: object
    metrics: object
    trace: object
    R: type


PKGS = {"jax": _Pkg("jax", jlg, jadm, jsrv, jmetrics, jtrace, JReq),
        "port": _Pkg("port", tlg, tadm, tsrv, tmetrics, ttrace, TReq)}


def _engine(pkg, max_batch=4, max_len=96, chunk=8, latency="model"):
    """The reference test's engine: PAM (hot 12, warm 24), paged, chunked
    prefill, the ``pam`` system's latency model."""
    jpam = make_pam(max_len=max_len, hot=12, warm=24)
    kw = dict(max_batch=max_batch, max_len=max_len, block_size=8,
              prefill_chunk=chunk)
    if pkg == "jax":
        lat = (jlatency(jsystem("pam"), JDESC) if latency == "model"
               else None)
        return JSpec(model=JCFG, serving=JSC(pam=jpam, **kw),
                     name="dev").build(JPARAMS, latency_model=lat)
    tpam = PAMManagerConfig(
        max_tokens=jpam.max_tokens, hot_capacity=jpam.hot_capacity,
        warm_capacity=jpam.warm_capacity, compression=jpam.compression,
        recency_window=jpam.recency_window,
        schedule_interval=jpam.schedule_interval)
    lat = tlatency(tsystem("pam"), TDESC) if latency == "model" else None
    return TSpec(model=TCF, serving=TSC(pam=tpam, **kw), name="dev").build(
        TPARAMS, latency_model=lat, device="cpu")


def _trace_cfg(pkg, **kw):
    return PKGS[pkg].lg.TraceConfig(vocab=JCFG.vocab, **kw)


def _record(rec):
    return (rec.rid, rec.arrival, rec.prompt_len, rec.max_new, rec.tokens,
            rec.times, rec.indices, rec.done, rec.rejected)


def _serve(pkg, tkw, admission=None, telemetry=False, **engine_kw):
    """A trace through ``AsyncServer`` (admission optional) under a fresh
    registry; returns (records, server summary, metrics snapshot,
    admission summary)."""
    p = PKGS[pkg]
    reg = p.metrics.MetricsRegistry(enabled=telemetry)
    with p.metrics.use(reg):
        adm = (p.adm.SLOAdmission(p.adm.SLOSpec(**admission))
               if admission is not None else None)
        srv = p.srv.AsyncServer(_engine(pkg, **engine_kw), admission=adm)
        records = asyncio.run(srv.serve_trace(
            p.lg.make_trace(_trace_cfg(pkg, **tkw))))
        snap = reg.snapshot()
    return ({rid: _record(r) for rid, r in records.items()}, srv.summary(),
            snap, adm.summary() if adm else None, records)


def _both(tkw, **kw):
    got, want = _serve("port", tkw, **kw), _serve("jax", tkw, **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    return got


# ------------------------------------------------------------------ loadgen
@pytest.mark.parametrize("kind", ["poisson", "gamma", "onoff"])
def test_trace_equals_reference(kind):
    kw = dict(kind=kind, n_requests=64, rate_rps=100.0, prompt_len=(4, 20),
              max_new=(2, 9), seed=5, first_id=10)
    got = tlg.make_trace(_trace_cfg("port", **kw))
    want = jlg.make_trace(_trace_cfg("jax", **kw))
    assert [r.id for r in got] == list(range(10, 74))
    for g, w in zip(got, want):
        assert (g.id, g.arrival, g.max_new_tokens) == (
            w.id, w.arrival, w.max_new_tokens)
        assert g.prompt.dtype == w.prompt.dtype
        assert np.array_equal(g.prompt, w.prompt)
    arr = [r.arrival for r in got]
    assert arr == sorted(arr) and arr[0] > 0
    assert tlg.TRACE_KINDS == jlg.TRACE_KINDS


def test_trace_validation_errors_match_reference():
    for bad in (dict(kind="weibull"), dict(rate_rps=0.0),
                dict(kind="gamma", burstiness=-1.0),
                dict(kind="onoff", duty_cycle=1.5),
                dict(prompt_len=(9, 4)), dict(max_new=(0, 4))):
        for lg in (tlg, jlg):
            with pytest.raises(ValueError):
                lg.make_trace(lg.TraceConfig(**bad))


def _recs(srv_mod):
    def rec(rid, arrival, times, indices=None, done=True, rejected=False):
        times = list(times)
        return srv_mod.StreamRecord(
            rid=rid, arrival=arrival, prompt_len=8, max_new=len(times),
            tokens=[100 + i for i in range(len(times))], times=times,
            indices=list(indices if indices is not None
                         else range(len(times))),
            done=done, rejected=rejected)
    return [rec(0, 0.0, [0.1, 0.2, 0.3]),
            rec(1, 0.0, [], rejected=True),
            rec(2, 0.0, [0.9, 1.0, 1.1], indices=[0, 2, 3]),  # lost idx 1
            rec(3, 0.0, [0.9, 1.0, 1.1], indices=[0, 1, 1]),  # dup idx 1
            rec(4, 0.0, [0.05], done=False),
            rec(5, 0.3, [0.35, 0.36, 0.5, 0.52])]


def test_score_and_integrity_equal_reference():
    got, want = _recs(tsrv), _recs(jsrv)
    assert tlg.stream_integrity(got) == jlg.stream_integrity(want) == (1, 1)
    for slo in ((0.15, 0.15), (1.0, 0.05), (1e-3, 1e-3)):
        sc = tlg.score(got, ttft_slo_s=slo[0], tpot_slo_s=slo[1])
        assert sc == jlg.score(want, ttft_slo_s=slo[0], tpot_slo_s=slo[1])
    sc = tlg.score(got, ttft_slo_s=0.15, tpot_slo_s=0.15)
    assert sc["n"] == 6 and sc["finished"] == 4 and sc["rejected"] == 1
    assert tlg.score([], ttft_slo_s=1.0, tpot_slo_s=1.0) == jlg.score(
        [], ttft_slo_s=1.0, tpot_slo_s=1.0)


# ------------------------------------------------------------------- server
SERVER_TRACE = dict(kind="poisson", n_requests=8, rate_rps=200.0,
                    prompt_len=(6, 40), max_new=(3, 10), seed=7)


def test_server_streams_equal_jax_server():
    got = _both(SERVER_TRACE, telemetry=True)
    records = got[4]
    assert len(records) == 8
    for rec in records.values():
        assert rec.done and not rec.rejected
        assert rec.indices == list(range(len(rec.tokens)))
        assert rec.times == sorted(rec.times) and rec.times[0] >= rec.arrival
    assert tlg.stream_integrity(records.values()) == (0, 0)
    assert got[2]["counters"]["pam_frontend_finished_total"] == 8


def test_stream_handle_iterates_live_events():
    out = {}
    for pkg, p in PKGS.items():
        srv = p.srv.AsyncServer(_engine(pkg), ticks_per_yield=1)

        async def run():
            rng = np.random.default_rng(0)
            h = srv.submit(rng.integers(0, JCFG.vocab, 12), 6)

            async def collect():
                return [ev async for ev in h]

            evs, _ = await asyncio.gather(collect(), srv.drain())
            return h.record, evs

        rec, evs = asyncio.run(run())
        assert [ev.token for ev in evs] == rec.tokens and len(evs) == 6
        assert evs[-1].done and not any(ev.rejected for ev in evs)
        out[pkg] = [(e.time, e.token, e.index, e.done) for e in evs]
    assert out["port"] == out["jax"]


def test_duplicate_and_unserviceable_submissions():
    out = {}
    for pkg, p in PKGS.items():
        srv = p.srv.AsyncServer(_engine(pkg, max_len=64))
        srv.submit([1, 2, 3], 2, rid=5)
        with pytest.raises(ValueError):
            srv.submit([4, 5, 6], 2, rid=5)
        h = srv.submit(np.zeros(200, np.int32), 4)   # window 204 > 64

        async def collect():
            return [ev async for ev in h]

        evs = asyncio.run(collect())                 # no pump needed
        assert len(evs) == 1 and evs[0].rejected and evs[0].done
        assert h.record.rejected and h.record.tokens == []
        out[pkg] = (srv.summary()["rejected"], _record(h.record))
    assert out["port"] == out["jax"] and out["port"][0] == 1


def test_ndjson_endpoint_streams_exactly():
    reqs = tlg.make_trace(_trace_cfg(
        "port", kind="poisson", n_requests=4, rate_rps=500.0,
        prompt_len=(6, 24), max_new=(3, 8), seed=9))
    twin = _engine("port")
    for r in reqs:
        twin.submit(TReq(id=r.id, prompt=r.prompt,
                         max_new_tokens=r.max_new_tokens))
    twin.run()
    srv = tsrv.AsyncServer(_engine("port"), ticks_per_yield=1)

    async def client(port, req):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(json.dumps({
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": req.max_new_tokens,
            "id": req.id}).encode() + b"\n")
        await writer.drain()
        evs = []
        while True:
            line = await reader.readline()
            if not line:
                break
            evs.append(json.loads(line))
            if evs[-1]["done"]:
                break
        writer.close()
        return evs

    async def metrics_line(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b'{"op": "metrics"}\n')
        await writer.drain()
        line = await reader.readline()
        writer.close()
        return json.loads(line)

    async def run():
        server, port, pump = await srv.serve_endpoint()
        try:
            assert port > 0
            streams = await asyncio.gather(*(client(port, r) for r in reqs))
            return streams, await metrics_line(port)
        finally:
            pump.cancel()
            server.close()
            await server.wait_closed()

    streams, met = asyncio.run(run())
    for req, evs in zip(reqs, streams):
        assert [ev["token"] for ev in evs] == twin.requests[req.id].outputs
        assert [ev["index"] for ev in evs] == list(range(len(evs)))
        assert evs[-1]["done"] and not any(ev["rejected"] for ev in evs)
    assert met["op"] == "metrics" and "metrics" in met


# ---------------------------------------------------------- SLO admission
def test_slospec_validation():
    for bad in (dict(ttft_s=0.0), dict(tpot_s=-1.0),
                dict(starvation_frac=0.0), dict(starvation_frac=1.0)):
        for adm in (tadm, jadm):
            with pytest.raises(ValueError):
                adm.SLOSpec(**bad)


def test_slo_admission_sheds_like_reference():
    """A gamma burst far beyond a batch of 2 with a tight TTFT budget:
    the same requests are shed, the survivors stream the same tokens at
    the same modeled times."""
    tkw = dict(kind="gamma", n_requests=24, rate_rps=5000.0,
               prompt_len=(16, 48), max_new=(4, 10), seed=3, burstiness=6.0)
    got = _both(tkw, admission=dict(ttft_s=0.02, tpot_s=0.05),
                telemetry=True, max_batch=2)
    assert got[3]["shed"] > 0
    sc = tlg.score(got[4].values(), ttft_slo_s=0.02, tpot_slo_s=0.05)
    assert sc["rejected"] == got[3]["shed"]
    assert sc["finished"] + sc["rejected"] == 24
    assert sc["lost_tokens"] == 0 and sc["dup_tokens"] == 0


def test_slo_admission_force_preempts_like_reference():
    tkw = dict(kind="poisson", n_requests=12, rate_rps=2000.0,
               prompt_len=(12, 40), max_new=(6, 14), seed=4)
    got = _both(tkw, admission=dict(ttft_s=10.0, tpot_s=1.0,
                                    starvation_frac=0.001,
                                    preempt_cooldown_ticks=4),
                telemetry=True, max_batch=2)
    assert got[3]["forced_preemptions"] > 0 and got[3]["shed"] == 0
    assert all(r.done and not r.rejected for r in got[4].values())
    ft = got[1]["backend"]["fault_tolerance"]
    assert ft["preemptions"] == got[3]["forced_preemptions"]
    assert ft["resumes"] >= 1 and ft["suspended_now"] == 0


def test_wallclock_mode_disarms_shedding():
    eng = _engine("port", latency=None)   # no model: no provable bound
    router = tsrv.single_device_router(eng)
    adm = tadm.SLOAdmission(tadm.SLOSpec(ttft_s=1e-9, tpot_s=1.0))
    rng = np.random.default_rng(0)
    for i in range(6):
        router.submit(TReq(id=i, prompt=rng.integers(0, JCFG.vocab, 8),
                           max_new_tokens=2, arrival=0.0))
    router.tick()
    assert adm._prefill_floor(router) == 0.0
    queued = len(router.queue)
    assert queued > 0
    adm.control(router)
    assert adm.shed == 0 and len(router.queue) == queued
    assert adm.forced_preemptions == 0    # no RecoveryManager: refused
    while router.tick():
        pass
    assert router.summary()["rejected"] == 0


# ------------------------------------------------------------ router hooks
def test_router_shed_hits_queued_requests_only():
    out = {}
    for pkg, p in PKGS.items():
        router = p.srv.single_device_router(_engine(pkg, max_batch=2))
        rng = np.random.default_rng(1)
        for i in range(5):
            router.submit(p.R(id=i, prompt=rng.integers(0, JCFG.vocab, 8),
                              max_new_tokens=3, arrival=0.0))
        router.tick()                      # 2 admitted, 3 queued
        router.drain_events()
        queued = [r.id for r in router.queue]
        running = [i for i in range(5) if i not in queued]
        assert len(queued) == 3 and len(running) == 2
        assert router.shed(queued[0]) is True
        evs = router.drain_events()
        assert [ev.request_id for ev in evs if ev.rejected] == [queued[0]]
        assert router.shed(running[0]) is False     # past admission
        assert router.shed(999) is False            # unknown
        while router.tick():
            pass
        out[pkg] = (queued, router.summary())
    assert out["port"] == out["jax"]
    assert out["port"][1]["finished"] == 4
    assert out["port"][1]["rejected"] == 1


def test_force_preempt_suspends_victim_and_stays_exact():
    out = {}
    for pkg, p in PKGS.items():
        eng = _engine(pkg, max_batch=1, max_len=64)
        router = p.srv.single_device_router(eng, preemptible=True)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, JCFG.vocab, 10) for _ in range(2)]
        for i, pr in enumerate(prompts):
            router.submit(p.R(id=i, prompt=pr, max_new_tokens=10,
                              arrival=0.0))
        while not router.finished and not eng.requests.get(0, None):
            router.tick()
        while 0 in eng.slots and len(eng.requests[0].outputs) < 2:
            router.tick()
        assert router.force_preempt(999) is False   # unknown rid
        assert router.force_preempt(1) is True      # suspends rid 0
        assert [snap.request.id
                for snap, _ in router.recovery.suspended] == [0]
        evs = []
        while router.tick():
            evs += router.drain_events()
        evs += router.drain_events()
        assert router.summary()["finished"] == 2
        out[pkg] = ([(e.time, e.request_id, e.token, e.index, e.done)
                     for e in evs], router.summary())
    assert out["port"] == out["jax"]
    # resume after preemption is exact: the twin of one plain engine
    twin = _engine("port", max_batch=1, max_len=64)
    rng = np.random.default_rng(2)
    for i in range(2):
        twin.submit(TReq(id=i, prompt=rng.integers(0, JCFG.vocab, 10),
                         max_new_tokens=10))
    twin.run()
    for i in range(2):
        assert [e[2] for e in out["port"][0] if e[1] == i] == \
            twin.requests[i].outputs


def test_force_preempt_requires_recovery_manager():
    router = tsrv.single_device_router(_engine("port", max_batch=1))
    router.submit(TReq(id=0, prompt=np.zeros(8, np.int32),
                       max_new_tokens=2, arrival=0.0))
    assert router.recovery is None
    assert router.force_preempt(0) is False


# --------------------------------------------------------------------- CLI
@contextlib.contextmanager
def _scoped_telemetry():
    """The CLIs install telemetry process-wide: restore both packages'
    registries and collectors afterwards."""
    saved = [(m, m.get_registry()) for m in (jmetrics, tmetrics)]
    traces = [(t, t.COLLECTOR) for t in (jtrace, ttrace)]
    try:
        yield
    finally:
        for m, reg in saved:
            m.install(reg)
        for t, coll in traces:
            t.COLLECTOR = coll


def _json_objects(text):
    """Every JSON object that starts a line of ``text``, in order."""
    dec, out, i = json.JSONDecoder(), [], 0
    while True:
        j = text.find("{", i)
        if j < 0:
            return out
        if j == 0 or text[j - 1] == "\n":
            obj, i = dec.raw_decode(text, j)
            out.append(obj)
        else:
            i = j + 1


def _cli(pkg, args, capsys, monkeypatch):
    """Run one package's serve CLI on the reduced model with the JAX
    package's seed-0 weights; returns the JSON objects it printed."""
    if pkg == "jax":
        from repro.launch import serve
    else:
        from repro_torch.launch import serve
        monkeypatch.setattr(serve.tfm, "init_params",
                            lambda cfg, seed, device=None: TPARAMS)
        args = args + ["--device", "cpu"]
    capsys.readouterr()
    with _scoped_telemetry():
        serve.main(["--reduced"] + args)
    return _json_objects(capsys.readouterr().out)


CLI_LAYOUT = ["--max-len", "64", "--max-batch", "4", "--block-size", "8",
              "--prompt-len", "16", "--gen-len", "6"]


def test_cli_chaos_equals_jax_cli(capsys, monkeypatch):
    args = CLI_LAYOUT + ["--devices", "hbm:1,cxl:2", "--requests", "8",
                         "--hot-window", "16",
                         "--chaos", "kill:cxl0@6,corrupt@4,stall:hbm0@2x8",
                         "--chaos-seed", "3"]
    got = _cli("port", args, capsys, monkeypatch)[-1]
    want = _cli("jax", args, capsys, monkeypatch)[-1]
    got.pop("slo_attainment")
    assert got == want
    assert got["finished"] == 8 and "fault_tolerance" in got


def test_cli_serve_equals_jax_cli(capsys, monkeypatch, tmp_path):
    args = CLI_LAYOUT + ["--serve", "--requests", "10", "--trace", "onoff",
                         "--rate", "400", "--prefill-chunk", "8",
                         "--slo-ttft-ms", "30", "--trace-seed", "2"]
    got = _cli("port", args, capsys, monkeypatch)[-1]
    want = _cli("jax", args, capsys, monkeypatch)[-1]
    assert got == want
    assert got["mode"] == "serve" and got["port"] is None
    assert got["score"]["finished"] + got["score"]["rejected"] == 10
    assert got["score"]["lost_tokens"] == got["score"]["dup_tokens"] == 0
    # over the socket: the same streams (arrivals are when connections
    # land, so the modeled times may differ)
    wire = _cli("port", args + ["--port", "0"], capsys, monkeypatch)[-1]
    assert wire["port"] > 0
    assert wire["score"]["lost_tokens"] == wire["score"]["dup_tokens"] == 0
    assert wire["score"]["finished"] + wire["score"]["rejected"] == 10


def test_cli_trace_out_and_metrics_interval_equal_jax_cli(
        capsys, monkeypatch, tmp_path):
    out = {}
    for pkg in ("port", "jax"):
        path = tmp_path / f"{pkg}.json"
        args = CLI_LAYOUT + ["--devices", "hbm:1,cxl:1", "--requests", "6",
                             "--chaos", "kill:cxl0@5",
                             "--trace-out", str(path),
                             "--metrics-interval", "3"]
        objs = _cli(pkg, args, capsys, monkeypatch)
        live = [o for o in objs if o.get("op") == "metrics"
                and "tick" in o]
        final = [o for o in objs if o.get("final")]
        out[pkg] = (live, final, json.loads(path.read_text()))
    assert out["port"] == out["jax"]
    live, final, trace = out["port"]
    assert len(live) >= 2 and [o["tick"] for o in live][:2] == [3, 6]
    assert len(final) == 1 and trace["traceEvents"]
    serve_args = CLI_LAYOUT + ["--serve", "--requests", "6",
                               "--metrics-interval", "5"]
    got = _cli("port", serve_args, capsys, monkeypatch)
    want = _cli("jax", serve_args, capsys, monkeypatch)
    assert got == want and got[0]["tick"] == 5
