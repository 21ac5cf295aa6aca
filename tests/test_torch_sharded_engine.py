"""The sharded serving engine against the JAX package's checks.

The reference's ``tests/sharded_engine_checks.py`` (its ``CFG``, ``PAM``,
``SCFG``: pool 23 blocks, ring 16; its requests) on the port's engine at
2 and 4 sites, on the CPU:

1. greedy streams at shard 2 and 4 equal the JAX unsharded engine's (run
   in this process) and the port's shard 1, one dispatch a device step,
   ``summary()["shard"]`` and the sites, a site's parameter bytes;
2. sampled streams (temperature 1.0) equal;
3. ``micro_steps=8`` streams equal (held to the JAX engine's
   ``micro_steps=1`` streams, as the port's other micro-step tests);
4. a sampled request migrated mid-decode from a shard-2 engine to a
   shard-4 engine continues exactly, the stay-behind too; prefix-cache
   hits, copies on write and chunked admissions give the JAX engine's
   sampled streams;
5. a 2-way replica group holds <= 0.6x a full copy's parameter bytes a
   site, its cluster streams are exact, ``from_cli("hbm:1,cxl:2",
   shard=2)`` forms groups [1, 2], and ``--shard 2`` serves on the CLI.

A family whose cache the paged pools cannot hold (MLA, hybrid, SSM)
raises the JAX engine's ``ValueError`` at any shard; the MoE and vlm
families shard in ``tests/test_torch_sharded_families.py``. Reduced
qwen3-0.6b (fp32), the JAX package's weights through
``repro_torch.bridge``; engines on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import build_model  # noqa: E402

from repro.serving import EngineSpec as JSpec  # noqa: E402
from repro.serving import PAMManagerConfig as JPAMConfig  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.serving import ServingConfig as JSC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.cluster import ClusterSpec, KVSnapshot  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.perfmodel.devices import HBM_CLASS  # noqa: E402
from repro_torch.serving import EngineSpec, PAMManagerConfig  # noqa: E402
from repro_torch.serving import Request, ServingConfig  # noqa: E402

PAM = dict(max_tokens=64, hot_capacity=8, warm_capacity=16, compression=4,
           recency_window=4, schedule_interval=2)
SCFG = dict(max_batch=2, max_len=64, block_size=8, pool_blocks=23,
            hot_window=16)
SAMPLED = dict(temperature=1.0, sample_seed=11)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params)."""
    jcfg, jparams = build_model("qwen3-0.6b")
    tcf = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    return jcfg, jparams, tcf, bridge.params_from_jax(
        tcf, _np(jparams), device="cpu")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _reqs(R, vocab, n=3, plen=20, max_new=10, seed=7):
    rng = np.random.default_rng(seed)
    return [R(id=i + 1, prompt=rng.integers(1, vocab, plen),
              max_new_tokens=max_new) for i in range(n)]


def _scfg(**kw):
    return ServingConfig(pam=PAMManagerConfig(**PAM), **{**SCFG, **kw})


def _port(model, shard, n=3, **kw):
    *_, tcf, tparams = model
    eng = EngineSpec(model=tcf, serving=_scfg(**kw), shard=shard,
                     name=f"s{shard}").build(tparams, device="cpu")
    for r in _reqs(Request, tcf.vocab, n):
        eng.submit(r)
    eng.run()
    return {rid: rs.outputs for rid, rs in eng.requests.items()}, eng


@pytest.fixture(scope="module")
def jax_streams(model):
    """The JAX unsharded engine's streams by serving variant."""
    jcfg, jparams, *_ = model
    cache = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            eng = JSpec(model=jcfg, serving=JSC(
                pam=JPAMConfig(**PAM), **{**SCFG, **kw})).build(jparams)
            for r in _reqs(JReq, jcfg.vocab):
                eng.submit(r)
            eng.run()
            cache[key] = {rid: rs.outputs
                          for rid, rs in eng.requests.items()}
        return cache[key]
    return get


@pytest.fixture(scope="module")
def full_bytes(model):
    return _port(model, 1, n=1)[1].params_bytes_per_device()


@pytest.mark.parametrize("shard", [2, 4])
def test_greedy_streams_equal_the_unsharded_engines(model, jax_streams,
                                                    full_bytes, shard):
    base = jax_streams()
    assert _port(model, 1)[0] == base
    got, eng = _port(model, shard)
    assert got == base
    assert eng.decode_dispatches == eng.decode_device_steps
    assert eng.shard == shard and eng.sites.size == shard
    summ = eng.summary()
    assert summ["shard"] == shard and summ["sites"] == ["cpu"] * shard
    assert summ["param_bytes_per_device"] == eng.params_bytes_per_device()
    assert eng.params_bytes_per_device() <= 0.6 * full_bytes / (shard // 2)
    # the cache stays one tensor a field; the weights are views
    assert eng.cache_specs.k == (None, None, None, "model", None)
    assert eng.cache_specs.pk == (None, "model", None, None, None)
    wq = eng.params["layers"]["attn"]["wq"]
    assert wq.axis == -1 and len(wq.parts) == shard
    assert all(p.data_ptr() >= model[3]["layers"]["attn"]["wq"].data_ptr()
               for p in wq.parts)


@pytest.mark.parametrize("shard", [2, 4])
def test_sampled_streams_equal_the_unsharded_engines(model, jax_streams,
                                                     shard):
    base = jax_streams(**SAMPLED)
    assert _port(model, 1, **SAMPLED)[0] == base
    assert _port(model, shard, **SAMPLED)[0] == base


@pytest.mark.parametrize("shard", [2, 4])
def test_micro_step_streams_equal_the_unsharded_engines(model, jax_streams,
                                                        shard):
    base = jax_streams()
    assert _port(model, 1, micro_steps=8)[0] == base
    got, eng = _port(model, shard, micro_steps=8)
    assert got == base
    # several device steps a dispatch (the last may run fewer than 8)
    assert eng.decode_device_steps > eng.decode_dispatches


@pytest.mark.parametrize("shard", [2, 4])
def test_prefix_cache_and_chunks_streams_equal(model, shard):
    """Admissions that adopt cached prefix blocks, copy a shared tail block
    on write and prefill in 8-token slices write the one cache in global
    coordinates: sampled streams at shard 2 and 4 equal the JAX
    unsharded engine's."""
    jcfg, jparams, tcf, tparams = model
    kw = dict(prefix_cache=True, prefill_chunk=8, temperature=1.0,
              sample_seed=3)
    rng = np.random.default_rng(4)
    common = rng.integers(1, tcf.vocab, 20)
    prompts = [np.concatenate([common, rng.integers(1, tcf.vocab, n)])
               for n in (3, 9, 14, 6)]

    def run(eng, R):
        for i, p in enumerate(prompts):
            eng.submit(R(id=i + 1, prompt=p, max_new_tokens=8))
        eng.run()
        return eng, {rid: rs.outputs for rid, rs in eng.requests.items()}
    want = run(JSpec(model=jcfg, serving=JSC(
        pam=JPAMConfig(**PAM), **{**SCFG, **kw})).build(jparams), JReq)[1]
    eng, got = run(EngineSpec(model=tcf, serving=_scfg(**kw),
                              shard=shard).build(tparams, device="cpu"),
                   Request)
    assert got == want
    summ = eng.summary()
    assert summ["prefix_hits"] >= 2 and summ["chunk_slices"] > 0
    assert summ["cow_copies"] > 0


def test_mid_decode_migration_from_shard_2_to_shard_4(model, jax_streams):
    *_, tcf, tparams = model
    scfg = _scfg(temperature=1.0, sample_seed=5)
    base = jax_streams(temperature=1.0, sample_seed=5)
    src = EngineSpec(model=tcf, serving=scfg, shard=2,
                     name="src").build(tparams, device="cpu")
    dst = EngineSpec(model=tcf, serving=scfg, shard=4,
                     name="dst").build(tparams, device="cpu")
    for r in _reqs(Request, tcf.vocab, 2):
        src.submit(r)
    for _ in range(4):                        # both mid-decode
        src.step()
    snap = KVSnapshot.export(src, 1)
    assert snap.src_shard == 2 and snap.verify()
    snap.commit(dst)                          # 2-way ring -> 4-way ring
    src.run()
    dst.run()
    assert dst.requests[1].outputs == base[1]
    assert src.requests[2].outputs == base[2]


def test_replica_group_and_cli(model, jax_streams, full_bytes, capsys):
    *_, tcf, tparams = model
    base = jax_streams()
    spec = ClusterSpec.of(tcf, [HBM_CLASS, HBM_CLASS], serving=_scfg(),
                          shard=2)
    assert len(spec.groups) == 1 and spec.groups[0].devices == 2
    assert spec.physical_devices == 2
    router = spec.build(tparams, device="cpu")
    assert len(router.devices) == 1          # one engine a group
    eng = router.devices[0].engine
    assert eng.shard == 2
    assert eng.params_bytes_per_device() <= 0.6 * full_bytes
    for r in _reqs(Request, tcf.vocab):
        router.submit(r)
    assert router.run()["finished"] == 3
    for rid, rs in router.finished.items():
        assert rs.outputs == base[rid], rid
    spec = ClusterSpec.from_cli("hbm:1,cxl:2", model=tcf, serving=_scfg(),
                                shard=2)
    assert [g.devices for g in spec.groups] == [1, 2]
    assert spec.cli() == "hbm:1,cxl:2"
    from repro_torch.launch import serve
    args = ["--reduced", "--device", "cpu", "--requests", "3",
            "--prompt-len", "20", "--gen-len", "6", "--max-len", "64",
            "--block-size", "8", "--hot-window", "16", "--pool-blocks",
            "23", "--shard", "2"]
    summ = serve.main(args)
    assert summ["finished"] == 3 and summ["shard"] == 2
    fleet = serve.main(args + ["--devices", "hbm:1,cxl:2"])
    assert fleet["finished"] == 3 and sorted(fleet["devices"]) == [
        "cxl0", "hbm0"]
    assert '"shard": 2' in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-7b",
                                  "mamba2-780m"])
@pytest.mark.parametrize("shard", [2, 4])
def test_other_families_refuse_sharding(arch, shard):
    """A family whose cache the paged pools cannot hold (MLA's latent
    cache, the hybrid's and the SSM's state) raises from its cache, as the
    JAX engine built from the same spec in this process does: the same
    type and message, before any shard check."""
    from repro.models.config import get_config as jget
    from repro.models.config import reduced as jreduced
    with pytest.raises(ValueError) as want:
        JSpec(model=jreduced(jget(arch)), serving=JSC(
            pam=JPAMConfig(**PAM), **SCFG), shard=shard).build(None)
    assert "paged KV pools require a GQA" in str(want.value)
    cfg = tcfg.reduced(tcfg.get_config(arch))
    with pytest.raises(type(want.value)) as got:
        EngineSpec(model=cfg, serving=_scfg(), shard=shard).build(
            None, device="cpu")
    assert str(got.value) == str(want.value)


def test_validate_refuses_what_does_not_split(model):
    *_, tcf, _ = model
    with pytest.raises(ValueError, match="paged path"):
        EngineSpec(model=tcf, serving=ServingConfig(max_len=64),
                   shard=2).validate()
    with pytest.raises(ValueError, match="hot ring"):
        EngineSpec(model=tcf, serving=_scfg(hot_window=12),
                   shard=8).validate()
    with pytest.raises(ValueError, match="pool_blocks=23"):
        EngineSpec(model=tcf, serving=_scfg(pool_blocks=20),
                   shard=4).validate()
