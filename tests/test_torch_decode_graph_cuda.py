"""The engine's CUDA-graph decode dispatch on the card, held to the eager
in-place body.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_decode_graph_cuda.py

A graph replays the kernels the eager body launches, on the same
inputs, so token streams and every ``StepBufs`` field must be equal and
the caches bit-equal; logits of one captured ``decode_step`` are held to
the eager call at rtol 1e-4 / atol 1e-4 (fp32, TF32 off), the decode
kernels' tolerance against their plain versions.
"""

import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MODES = {
    "paged_ring": ("qwen3-0.6b", True, dict(block_size=8, hot_window=16)),
    "paged": ("qwen3-0.6b", True, dict(block_size=8)),
    "dense_pam": ("qwen3-0.6b", True, {}),
    "no_pam": ("qwen3-0.6b", False, {}),
    "ssm": ("mamba2-780m", True, {}),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pam():
    return tpm.PAMManagerConfig(max_tokens=64, hot_capacity=8,
                                warm_capacity=8, compression=2,
                                recency_window=4, schedule_interval=2)


def _engine(mode, dev, params=None, eager=False, **extra):
    """A reduced engine of ``mode`` recording each dispatch's StepBufs;
    ``eager`` binds the eager body (the twin)."""
    arch, pam, layout = MODES[mode]
    cfg = tcfg.reduced(tcfg.get_config(arch))
    if params is None:
        params = ttf.init_params(cfg, 0, device=dev)
    eng = teng.ServingEngine(cfg, params, teng.ServingConfig(
        max_batch=3, max_len=64, pam=_pam() if pam else None, **layout,
        **extra), device=dev)
    if eager:
        eng._dispatch = eng._dispatch_eager
    eng.log = []
    decode = eng._decode

    def recorded(k, active):
        out = decode(k, active)
        eng.log.append(out)
        return out
    eng._decode = recorded
    return eng


def _serve(eng, n=8, new=12, seed=0):
    """``n`` requests through three slots: at ``micro_steps`` 8 the
    third admission wave replays the first wave's keys."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        eng.submit(teng.Request(i, rng.integers(
            0, eng.cfg.vocab, int(rng.integers(9, 34))), new))
    return eng.run()


@pytest.mark.cuda
@pytest.mark.parametrize("micro, eos", [(1, False), (4, True), (8, False)])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_graph_replay_equals_eager_twin(cuda, mode, micro, eos):
    """Replayed graphs give the eager twin's streams, StepBufs, caches
    and PAM state; every key was captured once and replayed."""
    probe = _engine(mode, cuda)
    _serve(probe, n=1)
    extra = dict(micro_steps=micro,
                 eos_token=probe.requests[0].outputs[5] if eos else -1)
    g = _engine(mode, cuda, **extra)
    e = _engine(mode, cuda, params=g.params, eager=True, **extra)
    keys = []
    dispatch = g._dispatch

    def keyed(key, bufs):
        keys.append(key)
        return dispatch(key, bufs)
    g._dispatch = keyed
    for eng in (g, e):
        _serve(eng)
    assert ({i: r.outputs for i, r in g.requests.items()}
            == {i: r.outputs for i, r in e.requests.items()})
    assert len(g.log) == len(e.log)
    for n, (a, b) in enumerate(zip(g.log, e.log)):
        for f in a:
            np.testing.assert_array_equal(a[f], b[f],
                                          err_msg=f"dispatch {n} {f}")
    for a, b in zip(list(g.cache) + list(g.pam_state),
                    list(e.cache) + list(e.pam_state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    assert set(g._graphs) == set(keys)
    assert len(keys) > len(g._graphs)                      # replays
    assert e._graphs == {} and g.capture_seconds > 0


@pytest.mark.cuda
def test_captured_decode_step_logits_match_eager(cuda):
    """One ``decode_step`` through the merged decode kernel, captured and
    replayed from the same cache state: logits within the tolerance of
    the eager call."""
    cfg = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    params = ttf.init_params(cfg, 0, device=cuda)
    B, S = 3, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    cache = ttf.init_decode_cache(cfg, B, S, device=cuda)
    for t in (cache.k, cache.v):
        t.copy_(torch.randn(t.shape, generator=gen, device=cuda))
    cache.lengths.copy_(torch.tensor([10, 33, 57], dtype=torch.int32))
    tokens = torch.tensor([1, 2, 3], dtype=torch.int32, device=cuda)
    live = torch.arange(S, device=cuda)[None, :] <= cache.lengths[:, None]
    d_fn = tpm.make_masked_decode_attn(live)
    saved = [t.clone() for t in cache]

    def restore():
        for t, s in zip(cache, saved):
            t.copy_(s)

    want = ttf.decode_step(cfg, params, tokens, cache, decode_attn_fn=d_fn)[0]
    restore()
    out = torch.empty_like(want)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out.copy_(ttf.decode_step(cfg, params, tokens, cache,
                                  decode_attn_fn=d_fn)[0])
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    restore()
    graph.replay()
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_failed_capture_raises_naming_the_key(cuda):
    """No fallback: a body that fails while it is recorded makes the
    dispatch raise, naming its key, and the engine keeps its graph
    dispatcher."""
    eng = _engine("paged_ring", cuda)
    body = eng._decode_body_

    def failing(i, bufs, schedule):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("not capturable")
        return body(i, bufs, schedule)
    eng._decode_body_ = failing
    with pytest.raises(RuntimeError, match=r"capture of the decode "
                       r"dispatch \(1, 0\)"):
        _serve(eng)
    assert eng._graphs == {} and eng._dispatch == eng._dispatch_graph


@pytest.mark.cuda
def test_launch_counts_under_replay(cuda):
    """A replay calls no kernel wrapper: each merged decode wrapper is
    called n_layers x the micro-steps whose body ran on the host (each
    key's eager dispatch and its recording), and the stacked ones never.
    On the card, torch.profiler counts each merged decode kernel n_layers
    x steps over replayed steps. A released engine holds no graph."""
    from torch.profiler import ProfilerActivity, profile
    eng = _engine("paged_ring", cuda, micro_steps=4)
    fns = (tfd.flash_decode_merged, tfd.flash_decode_paged_merged,
           tfd.flash_decode, tfd.flash_decode_paged)
    n0 = [f.launches for f in fns]
    summ = _serve(eng)
    ran = [f.launches - n for f, n in zip(fns, n0)]
    body = eng.decode_body_steps
    assert ran == [eng.cfg.n_layers * body] * 2 + [0, 0]
    assert 0 < body < summ["decode_device_steps"]
    assert summ["decode_dispatches"] > len(eng._graphs) > 0
    eng.release_graphs()
    assert eng._graphs == {} and eng._graph_pool is None

    # replayed single steps: three requests decode through the window
    eng = _engine("paged_ring", cuda)
    rng = np.random.default_rng(1)
    for i in range(3):
        eng.submit(teng.Request(i, rng.integers(0, eng.cfg.vocab, 12), 40))
    keys = {(1, p) for p in range(_pam().schedule_interval)}
    while not keys <= set(eng._graphs):
        eng.step()
    n0 = [f.launches for f in fns]
    steps = eng.decode_device_steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(6):
            eng.step()
        torch.cuda.synchronize()
    steps = eng.decode_device_steps - steps
    assert steps == 6
    assert [f.launches - n for f, n in zip(fns, n0)] == [0] * 4
    ran = {name: sum(ev.count for ev in prof.key_averages()
                     if name in ev.key)
           for name in ("pam::flash_decode_kernel",
                        "pam::flash_decode_paged_kernel")}
    assert ran == dict.fromkeys(ran, eng.cfg.n_layers * steps), ran


@pytest.mark.cuda
def test_capture_holds_off_the_cycle_collector(cuda):
    """A dropped engine that holds graphs sits in reference cycles, so
    only the cycle collector frees it. Here the last reference to such
    an engine goes while another engine records its first graph, and the
    collector is set to run at the next allocation: the capture holds it
    off, the streams equal the eager twin's, and the dropped engine is
    freed after the capture."""
    thresholds = gc.get_threshold()
    gc.collect()
    # no automatic collection until the capture below: the dropped
    # engine's objects stay in the youngest generation
    gc.set_threshold(10 ** 9)
    try:
        old = _engine("paged_ring", cuda)
        _serve(old, n=2)
        assert old._graphs
        held = [old]
        del old
        g = _engine("paged_ring", cuda)
        e = _engine("paged_ring", cuda, params=g.params, eager=True)
        eager = g._dispatch_eager
        dropped = []

        def dropping(key, bufs):
            if held and torch.cuda.is_current_stream_capturing():
                dropped.append(weakref.ref(held.pop()))
                gc.set_threshold(1, 10 ** 9, 10 ** 9)
            return eager(key, bufs)
        g._dispatch_eager = dropping
        for eng in (g, e):
            _serve(eng)
    finally:
        gc.set_threshold(*thresholds)
    gc.collect()
    assert dropped and dropped[0]() is None
    assert ({i: r.outputs for i, r in g.requests.items()}
            == {i: r.outputs for i, r in e.requests.items()})
