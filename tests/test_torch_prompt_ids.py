"""Prompt ids outside ``[0, vocab)`` are refused at every submit path of
the port, and the rest of the batch still streams the JAX engine's
tokens.

The reference's XLA gather clamps such an id and serves a different
prompt without a word; the port's embedding lookup would raise on the
CPU and fail a device-side assert on CUDA (poisoning the context every
fleet engine shares), so it rejects the request at submission:
``ValueError`` from ``ServingEngine.submit``, ``ClusterRouter.submit`` /
``submit_to`` and ``AsyncServer.submit``, and an error line from the
NDJSON endpoint, which keeps serving.

Reduced qwen3-0.6b (fp32), weights from the JAX package's
``init_params`` through ``repro_torch.bridge``; prompts from a fixed
numpy seed.
"""

import asyncio
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import build_model, make_engine, make_pam, make_requests  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.frontend import server as tsrv  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

N_REQ, PLEN, MAX_NEW, BAD = 5, 16, 8, 2      # request BAD is refused
ENGINE_KW = dict(max_batch=3, max_len=64, block_size=8)
PAM_KW = dict(max_len=64, hot=8, warm=16)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module, restored afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def model():
    cfg, params = build_model("qwen3-0.6b")
    tcf = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    return cfg, params, tcf, bridge.params_from_jax(tcf, _np_tree(params),
                                                    device="cpu")


@pytest.fixture(scope="module")
def jax_streams(model):
    """The JAX engine's streams of the requests the port accepts."""
    cfg, params, _, _ = model
    eng = make_engine(cfg, params, pam=make_pam(**PAM_KW), **ENGINE_KW)
    reqs = [r for r in make_requests(N_REQ, cfg.vocab, PLEN, MAX_NEW)
            if r.id != BAD]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {r.id: list(eng.requests[r.id].outputs) for r in reqs}


def _engine(tcf, tparams):
    j = make_pam(**PAM_KW)
    pam = tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval)
    return teng.ServingEngine(tcf, tparams,
                              teng.ServingConfig(pam=pam, **ENGINE_KW),
                              device="cpu")


def _batch(vocab, bad_id):
    """The test batch: request BAD carries ``bad_id`` mid-prompt."""
    out = []
    for r in make_requests(N_REQ, vocab, PLEN, MAX_NEW):
        prompt = np.asarray(r.prompt).copy()
        if r.id == BAD:
            prompt[PLEN // 2] = bad_id
        out.append(teng.Request(id=r.id, prompt=prompt,
                                max_new_tokens=r.max_new_tokens))
    return out


def _submit_all(submit, reqs):
    """Submit every request; the refused one must raise ValueError."""
    for r in reqs:
        if r.id == BAD:
            with pytest.raises(ValueError, match=r"\[0, 256\)"):
                submit(r)
        else:
            submit(r)


def _via_engine(eng, reqs):
    _submit_all(eng.submit, reqs)
    assert BAD not in eng.requests and list(eng.waiting) == [0, 1, 3, 4]
    eng.run()
    return {rid: list(rs.outputs) for rid, rs in eng.requests.items()}


def _via_router(eng, reqs, pinned):
    router = eng.as_router()
    name = router.devices[0].name
    if pinned:
        _submit_all(lambda r: router.submit_to(r, name), reqs)
    else:
        _submit_all(router.submit, reqs)
    assert BAD not in router._requests and router.rejected == 0
    out: dict = {}
    for ev in router.serve():
        assert not ev.rejected
        out.setdefault(ev.request_id, []).append(ev.token)
    return out


def _via_server(eng, reqs):
    srv = tsrv.AsyncServer(eng)
    _submit_all(lambda r: srv.submit(r.prompt, r.max_new_tokens, rid=r.id),
                reqs)
    assert BAD not in srv.records
    asyncio.run(srv.drain())
    assert srv.summary()["rejected"] == 0
    return {rid: rec.tokens for rid, rec in srv.records.items()}


PATHS = {"engine": _via_engine,
         "router_submit": lambda e, r: _via_router(e, r, pinned=False),
         "router_submit_to": lambda e, r: _via_router(e, r, pinned=True),
         "server": _via_server}


@pytest.mark.parametrize("path,bad_id", [
    ("engine", 256), ("engine", -1), ("router_submit", 256),
    ("router_submit_to", 10 ** 6), ("server", 2 ** 32 + 5)])
def test_refused_prompt_leaves_batch_streaming_jax_tokens(
        model, jax_streams, path, bad_id):
    """The refused request registers nothing; the others stream exactly
    the JAX engine's tokens. (2**32 + 5 would wrap to the valid id 5
    under an int32 cast: the check runs before any narrowing.)"""
    _, _, tcf, tparams = model
    got = PATHS[path](_engine(tcf, tparams), _batch(tcf.vocab, bad_id))
    assert got == jax_streams


def test_check_prompt_ids_bounds():
    teng.check_prompt_ids(np.array([0, 255], np.int32), 256)
    teng.check_prompt_ids(np.zeros(0, np.int32), 256)
    for bad in ([256], [-1, 3], [0, 1 << 40]):
        with pytest.raises(ValueError, match=r"\[0, 256\)"):
            teng.check_prompt_ids(np.array(bad), 256)


def test_ndjson_endpoint_answers_error_line_and_keeps_serving(
        model, jax_streams):
    """A refused request gets one ``{"rid", "error"}`` line; the
    requests around it, one sent after it on a new connection too,
    stream the JAX engine's tokens."""
    _, _, tcf, tparams = model
    reqs = _batch(tcf.vocab, tcf.vocab)
    srv = tsrv.AsyncServer(_engine(tcf, tparams), ticks_per_yield=1)

    async def client(port, req):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(json.dumps({
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": req.max_new_tokens,
            "id": req.id}).encode() + b"\n")
        await writer.drain()
        lines = []
        while True:
            line = await reader.readline()
            if not line:
                break
            lines.append(json.loads(line))
            if lines[-1].get("done"):
                break
        writer.close()
        return lines

    async def run():
        server, port, pump = await srv.serve_endpoint()
        try:
            first = await asyncio.gather(*(client(port, r)
                                           for r in reqs[:BAD + 1]))
            rest = await asyncio.gather(*(client(port, r)
                                          for r in reqs[BAD + 1:]))
            return first + rest
        finally:
            pump.cancel()
            server.close()
            await server.wait_closed()

    streams = asyncio.run(run())
    refused = streams[BAD]
    assert len(refused) == 1 and refused[0]["rid"] == BAD
    assert "[0, 256)" in refused[0]["error"]
    assert BAD not in srv.records
    for req, lines in zip(reqs, streams):
        if req.id != BAD:
            assert [ln["token"] for ln in lines] == jax_streams[req.id]
            assert lines[-1]["done"] and not any(ln["rejected"]
                                                 for ln in lines)
