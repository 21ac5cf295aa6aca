"""The port's decode dispatch against the JAX engine's fused dispatch.

``ServingEngine._decode`` runs ``k`` micro-steps of the in-place body
(``_decode_body_``) over the engine's own tensors and reads back one
``StepBufs``; on CUDA the same body is captured as one graph per key
``(k, Alg. 2 phase)`` and replayed (the card's half is
``tests/test_torch_decode_graph_cuda.py``). On the CPU, at reduced
qwen3-0.6b and mamba2-780m in fp32, with every prompt from a fixed numpy
seed:

* every dispatch's ``StepBufs`` (tokens, tier reads, hit rate, Alg. 2
  moves, lengths, pages) equal the JAX engine's dispatch by dispatch,
  and the token streams equal its streams: dense PAM, paged, paged +
  ring, no PAM and the Mamba-2 family, ``micro_steps`` 1 and 8; with
  on-device EOS at ``micro_steps`` 4; sampled through the prefix cache
  and chunked prefill; and across a migration export / import and a
  suspend / resume between dispatches. Tokens, counts and lengths
  exactly, the hit rate bit for bit; the fields keep the reference's
  dtypes;
* no state tensor changes its storage across admission, decode, export,
  import, suspend / resume and EOS teardown;
* a dispatch reads no device value on the host, and the body a graph
  captures consumes no value lifted from the host;
* the dispatch keys are ``(k, phase)``: at most one per power of two up
  to ``micro_steps`` and phase of ``schedule_interval``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from conftest import build_model, make_engine, make_pam  # noqa: E402

from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

MAX_LEN = 64
PAM_KW = dict(hot=8, warm=8, compression=2)      # every tier read, Alg. 2
MODES = {
    "dense_pam": ("qwen3-0.6b", True, dict()),
    "paged": ("qwen3-0.6b", True, dict(block_size=8)),
    "paged_ring": ("qwen3-0.6b", True, dict(block_size=8, hot_window=16)),
    "no_pam": ("qwen3-0.6b", False, dict()),
    "ssm": ("mamba2-780m", True, dict()),
}
SAMPLED = dict(temperature=0.8, top_k=8, sample_seed=3)
REF_DTYPES = dict(tokens=np.int32, tier_reads=np.int32,
                  hit_rate=np.float32, moved=np.int32, lengths=np.int32,
                  blocks=np.int32)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


_TORCH_PARAMS: dict = {}


def _models(arch):
    """(JAX cfg, JAX params, port cfg, port params): the same weights."""
    cfg, params = build_model(arch)
    if arch not in _TORCH_PARAMS:
        tcf = tcfg.reduced(tcfg.get_config(arch))
        _TORCH_PARAMS[arch] = (tcf, bridge.params_from_jax(
            tcf, _np_tree(params), device="cpu"))
    return (cfg, params) + _TORCH_PARAMS[arch]


def _port_pam():
    j = make_pam(max_len=MAX_LEN, **PAM_KW)
    return tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval)


def _port_engine(mode, name="dev", **extra):
    """The port's engine of ``mode``, recording its dispatches'
    ``StepBufs`` (numpy) in ``.log``."""
    arch, pam, layout = MODES[mode]
    _, _, tcf, tparams = _models(arch)
    eng = teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=_port_pam() if pam else None, max_batch=3, max_len=MAX_LEN,
        **layout, **extra), name=name, device="cpu")
    _record_port(eng)
    return eng


def _engines(mode, name="dev", **extra):
    """(JAX engine, port engine) of ``mode`` on the same weights, each
    recording its dispatches' ``StepBufs`` (numpy) in ``.log``."""
    arch, pam, layout = MODES[mode]
    cfg, params = _models(arch)[:2]
    jeng = make_engine(cfg, params, name=name,
                       pam=make_pam(max_len=MAX_LEN, **PAM_KW) if pam
                       else None, max_batch=3, max_len=MAX_LEN, **layout,
                       **extra)
    _record_jax(jeng)
    return jeng, _port_engine(mode, name, **extra)


def _record_jax(eng):
    eng.log = []
    get = eng._get_micro

    def recorded(k):
        fn = get(k)

        def run(*args):
            out = fn(*args)
            eng.log.append({f: np.asarray(getattr(out[3], f))
                            for f in out[3]._fields})
            return out
        return run
    eng._get_micro = recorded


def _record_port(eng):
    eng.log = []
    decode = eng._decode

    def recorded(k, active):
        out = decode(k, active)
        eng.log.append(dict(out))
        return out
    eng._decode = recorded


def _prompts(vocab, n=5, seed=0, lens=(20, 26, 9, 33, 14)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, lens[i % len(lens)]).astype(np.int32)
            for i in range(n)]


def _submit(jeng, peng, prompts, new, first=0):
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(id=first + i, prompt=p, max_new_tokens=new))
        peng.submit(teng.Request(id=first + i, prompt=p, max_new_tokens=new))


def _outputs(eng):
    return {rid: list(rs.outputs) for rid, rs in eng.requests.items()}


def _assert_bufs_equal(jeng, peng):
    """Dispatch by dispatch, every ``StepBufs`` field equal."""
    assert len(peng.log) == len(jeng.log) > 0
    for n, (want, got) in enumerate(zip(jeng.log, peng.log)):
        for f, dtype in REF_DTYPES.items():
            assert want[f].dtype == dtype, (f, want[f].dtype)
            np.testing.assert_array_equal(
                got[f], want[f], err_msg=f"dispatch {n}, field {f}")


def _assert_ref_dtypes(peng):
    for rb in peng._readbacks.values():
        for f, dtype in REF_DTYPES.items():
            assert getattr(rb.bufs, f).dtype == torch.from_numpy(
                np.zeros(1, dtype)).dtype, f


@pytest.mark.parametrize("micro", [1, 8])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_stepbufs_equal_jax_engine(mode, micro):
    """Five requests through three slots (later admissions reuse freed
    slots), greedy: every dispatch's StepBufs and the streams equal the
    JAX engine's."""
    jeng, peng = _engines(mode, micro_steps=micro)
    _submit(jeng, peng, _prompts(peng.cfg.vocab), new=12)
    jeng.run()
    peng.run()
    assert _outputs(peng) == _outputs(jeng)
    _assert_bufs_equal(jeng, peng)
    _assert_ref_dtypes(peng)
    if MODES[mode][1]:
        assert sum(peng.summary()["tier_reads"]) > 0


@pytest.mark.parametrize("mode", ["dense_pam", "paged_ring", "ssm"])
def test_stepbufs_equal_jax_engine_with_eos(mode):
    """On-device EOS at micro_steps 4: a slot that samples EOS freezes
    inside the dispatch; StepBufs and streams equal the JAX engine's."""
    probe = _port_engine(mode)
    prompts = _prompts(probe.cfg.vocab, n=3)
    for i, p in enumerate(prompts):
        probe.submit(teng.Request(id=i, prompt=p, max_new_tokens=12))
    probe.run()
    eos = probe.requests[0].outputs[5]
    jeng, peng = _engines(mode, micro_steps=4, eos_token=eos)
    _submit(jeng, peng, prompts, new=12)
    jeng.run()
    peng.run()
    got = _outputs(peng)
    assert got == _outputs(jeng)
    assert got[0][-1] == eos and len(got[0]) <= 6
    _assert_bufs_equal(jeng, peng)


def _shared_prompts(vocab, seed=7):
    """Three requests share a 20-token prefix (mid-block hits: CoW), one
    repeats another, one is unrelated and long (chunked)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 20)
    p = [np.concatenate([shared, rng.integers(0, vocab, n)])
         for n in (6, 7, 9)]
    p.append(p[0].copy())
    p.append(rng.integers(0, vocab, 30))
    return [x.astype(np.int32) for x in p]


def test_sampled_prefix_cache_chunked_stepbufs_equal_jax_engine():
    """Sampled (temperature 0.8, top-8), prefix cache, 8-token chunks,
    paged + ring: prefix hits, copies-on-write and chunk slices land
    between dispatches; StepBufs and streams equal the JAX engine's."""
    jeng, peng = _engines("paged_ring", prefix_cache=True, prefill_chunk=8,
                          **SAMPLED)
    prompts = _shared_prompts(peng.cfg.vocab)
    _submit(jeng, peng, prompts[:1], new=10)
    while peng.requests[0].status != teng.RUNNING:   # its slices fill
        jeng.step()
        peng.step()
    _submit(jeng, peng, prompts[1:], new=10, first=1)
    jeng.run()
    peng.run()
    assert _outputs(peng) == _outputs(jeng)
    _assert_bufs_equal(jeng, peng)
    s = peng.summary()
    assert s["prefix_hits"] >= 3 and s["cow_copies"] >= 1
    assert s["chunked_admissions"] >= 1


def _migrate(src, dst, rid):
    dst.import_request(src.export_request(rid))


def test_migration_and_suspend_between_dispatches_equal_jax_engine():
    """Request 0 migrates from one engine to another, request 1 is
    suspended and resumed on its engine, between dispatches; both
    engines' StepBufs and the streams equal the JAX fleet's."""
    ja, pa = _engines("paged_ring", name="a")
    jb, pb = _engines("paged_ring", name="b")
    _submit(ja, pa, _prompts(pa.cfg.vocab, n=3), new=12)
    for _ in range(4):
        ja.step()
        pa.step()
    _migrate(ja, jb, 0)
    _migrate(pa, pb, 0)
    ja.step()
    pa.step()
    jsnap, psnap = ja.suspend_request(1), pa.suspend_request(1)
    ja.step()
    pa.step()
    ja.resume_request(jsnap)
    pa.resume_request(psnap)
    for j, p in ((ja, pa), (jb, pb)):
        j.run()
        p.run()
        assert _outputs(p) == _outputs(j)
        _assert_bufs_equal(j, p)
    assert len(pb.requests[0].outputs) == 12


# ----------------------------------------------------- storage and host
def _state_ptrs(eng):
    """Every tensor a captured dispatch reads or writes, by name."""
    out = {f"cache.{f}": t.data_ptr() for f, t in eng.cache._asdict().items()
           if isinstance(t, torch.Tensor) and t.numel()}
    out.update({f"pam.{f}": t.data_ptr()
                for f, t in eng.pam_state._asdict().items()
                if isinstance(t, torch.Tensor) and t.numel()})
    out.update(tokens=eng.tokens_dev.data_ptr(),
               rids=eng.rids_dev.data_ptr(), active=eng._active.data_ptr())
    out.update({f"bufs{k}": rb.flat.data_ptr()
                for k, rb in eng._readbacks.items()})
    return out


@pytest.mark.parametrize("mode", ["paged_ring", "dense_pam", "ssm"])
def test_state_storage_never_moves(mode):
    """Admission (with the prefix cache, copies-on-write and chunk
    slices where the layout has a pool), decode, export, import, suspend
    / resume and EOS teardown all write in place."""
    arch, _, layout = MODES[mode]
    _, _, tcf, tparams = _models(arch)
    pooled = bool(layout.get("block_size"))
    extra = dict(prefix_cache=True, prefill_chunk=8) if pooled else {}
    probe = teng.ServingEngine(tcf, tparams, teng.ServingConfig(
        pam=_port_pam(), max_batch=3, max_len=MAX_LEN, **layout, **extra),
        device="cpu")
    prompts = _shared_prompts(tcf.vocab)
    probe.submit(teng.Request(0, prompts[0], 12))
    probe.run()
    eos = probe.requests[0].outputs[4]

    def engine():
        return teng.ServingEngine(tcf, tparams, teng.ServingConfig(
            pam=_port_pam(), max_batch=3, max_len=MAX_LEN, micro_steps=2,
            eos_token=eos, **layout, **extra), device="cpu")

    a, b = engine(), engine()
    for eng in (a, b):
        eng._readback(1), eng._readback(2)
    ptrs = {"a": _state_ptrs(a), "b": _state_ptrs(b)}

    def same():
        assert _state_ptrs(a) == ptrs["a"]
        assert _state_ptrs(b) == ptrs["b"]

    for i, p in enumerate(prompts[:3]):
        a.submit(teng.Request(i, p, 12))
    a.step()                                       # admission + decode
    same()

    def live():
        return [rid for rid, rs in a.requests.items()
                if rs.status == teng.RUNNING]
    while len(live()) < 2:                         # chunk slices fill
        a.step()
    same()
    if tcf.family != "ssm":                        # KV migration: GQA
        live = live()
        _migrate(a, b, live[0])
        same()
        snap = a.suspend_request(live[1])
        a.step()
        a.resume_request(snap)
        same()
    for i, p in enumerate(prompts[3:], start=3):
        a.submit(teng.Request(i, p, 12))
    a.run()
    b.run()
    same()
    done = [rs for eng in (a, b) for rs in eng.requests.values()]
    assert all(rs.status == teng.DONE for rs in done)
    assert any(rs.outputs[-1] == eos and len(rs.outputs) < 12
               for rs in done)                     # an EOS teardown


_HOST_READS = ("_local_scalar_dense", "nonzero", "masked_select", "unique")


class _NoHostReads(TorchDispatchMode):
    """Raises on any aten op that reads a tensor's values on the host;
    with ``lifted``, also on a Python value lifted to a tensor (``t[idx]
    = 2``, ``torch.tensor(...)``) that an op other than ``fill_``
    consumes: on the card that is a copy from the host, which a graph
    cannot hold (the dispatch's own copy of the active mask, before the
    graph, is one)."""

    def __init__(self, lifted: bool = False):
        super().__init__()
        self.check_lifted = lifted
        self.lifted: dict[int, torch.Tensor] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(op in func.__name__ for op in _HOST_READS):
            raise AssertionError(f"a dispatch read a device value: {func}")
        if self.check_lifted and func is not torch.ops.aten.fill_.Tensor:
            flat = [x for a in args
                    for x in (a if isinstance(a, (list, tuple)) else (a,))]
            if any(isinstance(x, torch.Tensor) and id(x) in self.lifted
                   and self.lifted[id(x)] is x for x in flat):
                raise AssertionError(f"{func} consumes a host value")
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.lift_fresh.default:
            self.lifted[id(out)] = out
        return out


@pytest.mark.parametrize("mode, extra", [
    ("paged_ring", dict(SAMPLED, prefix_cache=True, prefill_chunk=8,
                        micro_steps=4, eos_token=5)),
    ("paged", dict(micro_steps=2)),
    ("dense_pam", {}),
    ("no_pam", dict(SAMPLED)),
    ("ssm", dict(micro_steps=4)),
])
def test_dispatch_reads_no_device_value(mode, extra):
    peng = _port_engine(mode, **extra)
    decode, dispatch = peng._decode, peng._dispatch

    def guarded(k, active):
        with _NoHostReads():
            return decode(k, active)

    def captured(key, bufs):        # what a graph holds on the card
        with _NoHostReads(lifted=True):
            return dispatch(key, bufs)
    peng._decode, peng._dispatch = guarded, captured
    _submit_port(peng, _shared_prompts(peng.cfg.vocab), new=10)
    peng.run()
    assert peng.decode_dispatches > 0
    assert all(rs.status == teng.DONE for rs in peng.requests.values())


def _submit_port(eng, prompts, new):
    for i, p in enumerate(prompts):
        eng.submit(teng.Request(id=i, prompt=p, max_new_tokens=new))


@pytest.mark.parametrize("micro", [1, 8])
@pytest.mark.parametrize("mode", ["paged_ring", "no_pam"])
def test_dispatch_keys_are_micro_steps_and_phase(mode, micro):
    """A long run with staggered budgets: each dispatch's key is (k, the
    PAM step count at its start modulo schedule_interval), k a power of
    two up to micro_steps; at most one key per (k, phase). Without PAM
    Alg. 2 never runs and the phase is 0. The key fixes where Alg. 2
    runs inside the dispatch."""
    peng = _port_engine(mode, micro_steps=micro)
    interval = _port_pam().schedule_interval
    seen = []
    dispatch = peng._dispatch

    def keyed(key, bufs):
        seen.append((key, peng.pam_state.step))
        return dispatch(key, bufs)
    peng._dispatch = keyed
    rng = np.random.default_rng(3)
    for i in range(9):
        peng.submit(teng.Request(i, rng.integers(0, peng.cfg.vocab, 10),
                                 int(rng.integers(3, 30))))
    peng.run()
    ks = [2 ** e for e in range(micro.bit_length()) if 2 ** e <= micro]
    phases = range(interval) if mode != "no_pam" else (0,)
    assert len(seen) == peng.decode_dispatches > 10
    for (k, phase), step in seen:
        assert k in ks and phase in phases
        if mode != "no_pam":
            assert phase == step % interval
            assert peng._schedule_flags((k, phase)) == [
                tpm.runs_schedule(peng.pam_cfg, step + i) for i in range(k)]
    keys = {key for key, _ in seen}
    assert len(keys) <= len(ks) * len(phases)
    if micro == 1 and mode != "no_pam":
        assert keys == {(1, p) for p in range(interval)}


def test_cpu_engine_dispatches_eagerly():
    """A CPU engine runs the body op by op: no graph, no pool, and the
    body runs on the host for every decode step."""
    peng = _port_engine("paged_ring")
    _submit_port(peng, _prompts(peng.cfg.vocab, n=2), new=4)
    peng.run()
    assert peng._dispatch == peng._dispatch_eager
    assert peng.decode_body_steps == peng.decode_device_steps > 0
    assert peng._graphs == {} and peng._graph_pool is None
    peng.release_graphs()
    assert peng.capture_seconds == 0.0
