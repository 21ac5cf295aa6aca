"""The port's serving engine against the JAX engine: identical greedy
token streams on ``make_requests`` in dense-PAM and paged + hot-ring
modes, with ``micro_steps`` 1 and 8 and with on-device EOS; plus the
port's import hygiene (no ``jax``, ``repro`` or ``ml_dtypes``) and
device selection (every entry point, the cluster's included, wants
CUDA unless told otherwise).

The JAX streams are computed once per mode (its compile is the cost);
the JAX engine's own suite pins its micro-step and EOS streams to its
single-step ones, so the port's variants are held to those.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import build_model, make_engine, make_pam, make_requests  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

torch.set_num_threads(2)

MODES = {
    "dense_pam": dict(max_batch=3, max_len=64),
    "paged_ring": dict(max_batch=3, max_len=64, block_size=8,
                       hot_window=16),
}
N_REQ, PLEN, MAX_NEW = 5, 40, 16
# a policy that reads every tier and makes Alg. 2 move tokens
PAM_KW = dict(hot=8, warm=8, compression=2)


def _torch_pam(max_len):
    j = make_pam(max_len=max_len, **PAM_KW)
    return tpm.PAMManagerConfig(
        max_tokens=j.max_tokens, hot_capacity=j.hot_capacity,
        warm_capacity=j.warm_capacity, compression=j.compression,
        recency_window=j.recency_window,
        schedule_interval=j.schedule_interval)


def _streams(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {r.id: list(eng.requests[r.id].outputs) for r in reqs}


@pytest.fixture(scope="module")
def model():
    cfg, params = build_model("qwen3-0.6b")
    tcf = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    tparams = bridge.params_from_jax(
        tcf, _np_tree(params), device="cpu")
    return cfg, params, tcf, tparams


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def jax_streams(model):
    cfg, params, _, _ = model
    out = {}
    for mode, kw in MODES.items():
        eng = make_engine(cfg, params,
                          pam=make_pam(max_len=kw["max_len"], **PAM_KW), **kw)
        out[mode] = _streams(eng, make_requests(N_REQ, cfg.vocab, PLEN,
                                                MAX_NEW))
    return out


def _torch_engine(model, mode, **extra):
    _, _, tcf, tparams = model
    kw = dict(MODES[mode], **extra)
    scfg = teng.ServingConfig(pam=_torch_pam(kw["max_len"]), **kw)
    return teng.ServingEngine(tcf, tparams, scfg, device="cpu")


def _reqs(vocab):
    return [teng.Request(id=r.id, prompt=r.prompt,
                         max_new_tokens=r.max_new_tokens)
            for r in make_requests(N_REQ, vocab, PLEN, MAX_NEW)]


@pytest.mark.parametrize("micro", [1, 8])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_streams_equal_jax_engine(model, jax_streams, mode, micro):
    tcf = model[2]
    got = _streams(_torch_engine(model, mode, micro_steps=micro),
                   _reqs(tcf.vocab))
    assert got == jax_streams[mode]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_streams_equal_jax_engine_with_eos(model, jax_streams, mode):
    """On-device EOS (micro_steps 4): each stream is the EOS-free JAX
    stream cut after its first EOS. All requests are admitted at once
    (max_batch >= requests), so early finishes move no admission."""
    tcf = model[2]
    ref = jax_streams[mode]
    eos = ref[0][5]
    eng = _torch_engine(model, mode, micro_steps=4, eos_token=eos,
                        max_batch=N_REQ)
    got = _streams(eng, _reqs(tcf.vocab))
    for rid, stream in ref.items():
        cut = stream.index(eos) + 1 if eos in stream else len(stream)
        assert got[rid] == stream[:cut], rid
    assert len(got[0]) == 6


def test_engine_counts_and_summary(model):
    tcf = model[2]
    eng = _torch_engine(model, "paged_ring")
    summ = _streams(eng, _reqs(tcf.vocab)) and eng.summary()
    assert summ["finished"] == N_REQ
    assert summ["total_tokens"] == N_REQ * MAX_NEW
    assert summ["hot_window"] == 16
    assert summ["blocks_touched_per_step"] <= summ["blocks_window_per_step"]
    assert min(summ["tier_reads"]) > 0          # every tier is read
    assert summ["moved_tokens"] > 0             # Alg. 2 moved tokens
    assert summ["blocks_touched_per_step"] > 0  # the paged partial ran
    assert eng.cache.k.shape[3] == 16          # the hot buffer is a ring
    assert eng.allocator.free_blocks == eng.allocator.num_blocks


_IMPORT_CHECK = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n in ("jax", "repro", "ml_dtypes")
             or n.startswith(("jax.", "repro.", "ml_dtypes.")))
assert not bad, bad
# the fault-tolerance layer, the front end, the paper's core library and
# the training grid's modules are among those walked
want = {"repro_torch.distributed.elastic", "repro_torch.cluster.faults",
        "repro_torch.cluster.recovery", "repro_torch.frontend.loadgen",
        "repro_torch.frontend.admission", "repro_torch.frontend.server",
        "repro_torch.core.pam_attention", "repro_torch.core.sparsity",
        "repro_torch.core.mapping", "repro_torch.launch.mesh",
        "repro_torch.models.perf_flags", "repro_torch.distributed.pipeline"}
assert want <= set(sys.modules), sorted(want - set(sys.modules))
print("clean", len([n for n in sys.modules if n.startswith("repro_torch")]))
"""


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    tcf = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    from repro_torch.models import transformer as ttf
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttf.init_params(tcf, 0)
    params = ttf.init_params(tcf, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teng.ServingEngine(tcf, params, teng.ServingConfig())
    from repro_torch.launch import train as train_cli
    from repro_torch.training import train_step as tts
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tts.init_train_state(tcf, tts.TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--reduced", "--steps", "1"])
    from repro_torch.cluster import ClusterSpec
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving import EngineSpec
    scfg = teng.ServingConfig(max_len=64, block_size=8,
                              pam=tpm.PAMManagerConfig(64, 8, 16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineSpec(model=tcf, serving=scfg).build(params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterSpec.from_cli("hbm:1,cxl:2", model=tcf,
                             serving=scfg).build(params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--reduced", "--devices", "hbm:1,cxl:2",
                        "--block-size", "8", "--max-len", "64"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--reduced", "--devices", "hbm:1,cxl:2",
                        "--block-size", "8", "--max-len", "64",
                        "--chaos", "kill:cxl1@5"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--reduced", "--serve", "--block-size", "8",
                        "--max-len", "64"])
