"""The sharded serving engine of the GQA mixture-of-experts and vlm
families against the JAX package, on the CPU.

The reference's sharded-engine config (``tests/sharded_engine_checks.py``:
max_batch 2, max_len 64, block 8, pool 23 blocks, ring 16; its requests)
on the port's engine at 2 and 4 sites, for reduced qwen3-moe-235b-a22b
(4 experts of 32, top-2, capacity 1.25), reduced internvl2-1b (vocab
256: the vocab-parallel embedding and tied head), and reduced
internvl2-1b at vocabulary 255 in both packages (an odd vocabulary, as
the published 151,655: the d-parallel embedding, and the tied head as a
row-parallel product whose per-site partial logits are summed):

1. greedy, sampled (temperature 1.0) and ``micro_steps=8`` streams equal
   the JAX unsharded engine's (run in this process; ``micro_steps=1``
   for the pipelined case, as the port's other micro-step tests);
2. the MoE: prefix-cache hits and chunked prefill at shard 2, a sampled
   request migrated mid-decode from a shard-2 to a shard-4 engine, a
   2-way replica group holding <= 0.6x a full copy's parameter bytes a
   site, ``from_cli("hbm:1,cxl:2", shard=2)`` and ``--shard 2`` on the
   serve CLI;
3. units: a sharded MoE tree's layers, the size-0 shared-expert
   placeholders kept whole, the per-site expert product against the
   three ``torch.bmm``s (fp32, atol 1e-6), and the MoE's capacity drops
   at prefill and decode equal at shard 1 and 2.

Weights are the reference's ``init_params`` at seed 0 through
``repro_torch.bridge``; prompts are fixed-seed numpy draws; fp32.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import build_model  # noqa: E402

from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import get_config as jget  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro.serving import EngineSpec as JSpec  # noqa: E402
from repro.serving import PAMManagerConfig as JPAMConfig  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.serving import ServingConfig as JSC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.cluster import ClusterSpec, KVSnapshot  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.perfmodel.devices import HBM_CLASS  # noqa: E402
from repro_torch.serving import EngineSpec, PAMManagerConfig  # noqa: E402
from repro_torch.serving import Request, ServingConfig  # noqa: E402

PAM = dict(max_tokens=64, hot_capacity=8, warm_capacity=16, compression=4,
           recency_window=4, schedule_interval=2)
SCFG = dict(max_batch=2, max_len=64, block_size=8, pool_blocks=23,
            hot_window=16)
SAMPLED = dict(temperature=1.0, sample_seed=11)
MOE = "qwen3-moe-235b-a22b"
VLM = "internvl2-1b"
# model key -> (arch, config overrides in both packages)
MODELS = {"moe": (MOE, {}), "vlm": (VLM, {}),
          "vlm_vocab255": (VLM, {"vocab": 255})}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params) by model key, made
    once."""
    cache = {}

    def get(key):
        if key not in cache:
            arch, kw = MODELS[key]
            if kw:
                jcfg = dataclasses.replace(jreduced(jget(arch)), **kw)
                jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
            else:
                jcfg, jparams = build_model(arch)
            tcf = dataclasses.replace(tcfg.reduced(tcfg.get_config(arch)),
                                      **kw)
            cache[key] = (jcfg, jparams, tcf, bridge.params_from_jax(
                tcf, _np(jparams), device="cpu"))
        return cache[key]
    return get


def _reqs(R, vocab, n=3, plen=20, max_new=10, seed=7):
    rng = np.random.default_rng(seed)
    return [R(id=i + 1, prompt=rng.integers(1, vocab, plen),
              max_new_tokens=max_new) for i in range(n)]


def _scfg(**kw):
    return ServingConfig(pam=PAMManagerConfig(**PAM), **{**SCFG, **kw})


def _outputs(eng):
    return {rid: rs.outputs for rid, rs in eng.requests.items()}


def _port(model, shard, n=3, **kw):
    *_, tcf, tparams = model
    eng = EngineSpec(model=tcf, serving=_scfg(**kw), shard=shard,
                     name=f"s{shard}").build(tparams, device="cpu")
    for r in _reqs(Request, tcf.vocab, n):
        eng.submit(r)
    eng.run()
    return _outputs(eng), eng


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX unsharded engine's streams by model key and serving
    variant."""
    cache = {}

    def get(key, **kw):
        k = (key, tuple(sorted(kw.items())))
        if k not in cache:
            jcfg, jparams, *_ = models(key)
            eng = JSpec(model=jcfg, serving=JSC(
                pam=JPAMConfig(**PAM), **{**SCFG, **kw})).build(jparams)
            for r in _reqs(JReq, jcfg.vocab):
                eng.submit(r)
            eng.run()
            cache[k] = _outputs(eng)
        return cache[k]
    return get


@pytest.mark.parametrize("shard", [2, 4])
@pytest.mark.parametrize("key", sorted(MODELS))
def test_greedy_streams_equal_the_unsharded_engines(models, jax_streams,
                                                    key, shard):
    model = models(key)
    base = jax_streams(key)
    assert _port(model, 1)[0] == base
    got, eng = _port(model, shard)
    assert got == base
    assert eng.decode_dispatches == eng.decode_device_steps
    assert eng.sites.size == shard and eng.summary()["shard"] == shard
    full = tp.site_nbytes(model[3])
    assert eng.params_bytes_per_device() <= 0.6 * full / (shard // 2)
    embed, head = eng.params["embed"], ttf._head(model[2], eng.params)
    if key == "vlm_vocab255":        # d-parallel lookup, row-parallel head
        assert (embed.axis, head.axis) == (-1, -2)
    elif key == "vlm":               # vocab-parallel, the head by columns
        assert (embed.axis, head.axis) == (-2, -1)
    else:                            # each site a slice of the experts' ffn
        w = eng.params["layers"]["moe"]
        assert (w["w_gate"].axis, w["w_up"].axis, w["w_down"].axis) == (
            -1, -1, -2)
        f = model[2].moe.d_expert
        assert w["w_gate"].parts[0].shape[-1] == f // shard
        assert not isinstance(w["router"], tp.SiteSplit)


@pytest.mark.parametrize("shard", [2, 4])
@pytest.mark.parametrize("key", sorted(MODELS))
def test_sampled_streams_equal_the_unsharded_engines(models, jax_streams,
                                                     key, shard):
    base = jax_streams(key, **SAMPLED)
    assert _port(models(key), shard, **SAMPLED)[0] == base


@pytest.mark.parametrize("shard", [2, 4])
@pytest.mark.parametrize("key", sorted(MODELS))
def test_micro_step_streams_equal_the_unsharded_engines(models, jax_streams,
                                                        key, shard):
    got, eng = _port(models(key), shard, micro_steps=8)
    assert got == jax_streams(key)
    assert eng.decode_device_steps > eng.decode_dispatches


def test_moe_prefix_cache_and_chunks_streams_equal(models):
    """Admissions that adopt cached prefix blocks, copy a shared tail block
    on write and prefill in 8-token slices hand the experts the
    reference's shapes: sampled streams at shard 2 equal the JAX
    unsharded engine's."""
    jcfg, jparams, tcf, tparams = models("moe")
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
        return eng, _outputs(eng)
    want = run(JSpec(model=jcfg, serving=JSC(
        pam=JPAMConfig(**PAM), **{**SCFG, **kw})).build(jparams), JReq)[1]
    eng, got = run(EngineSpec(model=tcf, serving=_scfg(**kw),
                              shard=2).build(tparams, device="cpu"),
                   Request)
    assert got == want
    summ = eng.summary()
    assert summ["prefix_hits"] >= 2 and summ["chunk_slices"] > 0
    assert summ["cow_copies"] > 0


def test_moe_mid_decode_migration_from_shard_2_to_shard_4(models,
                                                          jax_streams):
    *_, tcf, tparams = models("moe")
    scfg = _scfg(temperature=1.0, sample_seed=5)
    base = jax_streams("moe", temperature=1.0, sample_seed=5)
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


def test_moe_replica_group_and_cli(models, capsys):
    """A 2-way replica group of the MoE serves from <= 0.6x a full copy's
    bytes a site, with streams equal to the JAX unsharded engine's on the
    group's serving config (its class's batch and pool: capacity couples
    the rows of a batch); the CLI forms and serves such groups."""
    jcfg, jparams, tcf, tparams = models("moe")
    full = tp.site_nbytes(tparams)
    spec = ClusterSpec.of(tcf, [HBM_CLASS, HBM_CLASS], serving=_scfg(),
                          shard=2)
    assert len(spec.groups) == 1 and spec.groups[0].devices == 2
    router = spec.build(tparams, device="cpu")
    assert len(router.devices) == 1          # one engine a group
    eng = router.devices[0].engine
    assert eng.shard == 2
    assert eng.params_bytes_per_device() <= 0.6 * full
    for r in _reqs(Request, tcf.vocab):
        router.submit(r)
    assert router.run()["finished"] == 3
    s = eng.scfg
    jeng = JSpec(model=jcfg, serving=JSC(
        pam=JPAMConfig(**PAM), **{**SCFG, "max_batch": s.max_batch,
                                  "pool_blocks": s.pool_blocks})).build(
        jparams)
    for r in _reqs(JReq, jcfg.vocab):
        jeng.submit(r)
    jeng.run()
    want = _outputs(jeng)
    for rid, rs in router.finished.items():
        assert rs.outputs == want[rid], rid
    spec = ClusterSpec.from_cli("hbm:1,cxl:2", model=tcf, serving=_scfg(),
                                shard=2)
    assert [g.devices for g in spec.groups] == [1, 2]
    assert spec.cli() == "hbm:1,cxl:2"
    from repro_torch.launch import serve
    args = ["--reduced", "--device", "cpu", "--arch", MOE, "--requests",
            "3", "--prompt-len", "20", "--gen-len", "6", "--max-len", "64",
            "--block-size", "8", "--hot-window", "16", "--pool-blocks",
            "23", "--shard", "2"]
    summ = serve.main(args)
    assert summ["finished"] == 3 and summ["shard"] == 2
    fleet = serve.main(args + ["--devices", "hbm:1,cxl:2"])
    assert fleet["finished"] == 3 and sorted(fleet["devices"]) == [
        "cxl0", "hbm0"]
    assert '"shard": 2' in capsys.readouterr().out


# ------------------------------------------------------------ units
@pytest.mark.parametrize("shard", [2, 4])
def test_sharded_moe_tree_keeps_its_layers(models, shard):
    """The absent shared experts' (L, 0) placeholders, whose reference
    spec names the stacked layer axis for ``shared_down``, stay whole:
    ``_layers`` gives n_layers layer dicts, each with no shared expert
    and per-site expert slices."""
    *_, tcf, tparams = models("moe")
    specs = tshd.param_specs(tcf, shard, tparams)
    # the reference's rule: row-parallel on dim 0, where it divides (2
    # layers over 2 sites)
    assert specs["layers.moe.shared_down"] == (("model", None) if shard == 2
                                               else (None, None))
    sharded = tp.shard_params(tparams, specs, shard)
    moe = sharded["layers"]["moe"]
    for f in ("shared_gate", "shared_up", "shared_down"):
        assert moe[f] is tparams["layers"]["moe"][f]
    layers = ttf._layers(sharded)
    assert len(layers) == tcf.n_layers
    for lp in layers:
        p = ttf._moe_params(lp)
        assert p.shared_gate is p.shared_up is p.shared_down is None
        assert len(p.w_gate.parts) == shard
        assert p.w_down.shape == (tcf.moe.num_experts, tcf.moe.d_expert,
                                  tcf.d_model)


@pytest.mark.parametrize("shard", [1, 2, 4])
def test_expert_ffn_per_site_equals_bmm(models, shard):
    """The reduced MoE's first-layer experts on a seeded (E, C, d) batch:
    the per-site product equals the three ``torch.bmm``s within atol 1e-6
    (fp32; the sites' partials sum in another order), and the unsharded
    call is exactly them."""
    *_, tcf, tparams = models("moe")
    w = {f: tparams["layers"]["moe"][f][0]
         for f in ("w_gate", "w_up", "w_down")}
    rng = np.random.default_rng(shard)
    xe = torch.from_numpy(rng.standard_normal(
        (tcf.moe.num_experts, 5, tcf.d_model), np.float32))
    want = torch.bmm(torch.nn.functional.silu(torch.bmm(xe, w["w_gate"]))
                     * torch.bmm(xe, w["w_up"]), w["w_down"])
    if shard == 1:
        assert torch.equal(tp.expert_ffn(xe, *w.values()), want)
        return
    got = tp.expert_ffn(xe, tp.split(w["w_gate"], 2, shard),
                        tp.split(w["w_up"], 2, shard),
                        tp.split(w["w_down"], 1, shard))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def _count_drops(monkeypatch, batch):
    """(assignments, dropped) of the MoE's routing at prefill and at
    decode (a call of ``batch`` rows), counted around ``moe.route``."""
    acc = {"prefill": [0, 0], "decode": [0, 0]}
    route = tmoe.route

    def counted(p, xf, cfg):
        r = route(p, xf, cfg)
        a = acc["decode" if xf.shape[0] == batch else "prefill"]
        a[0] += r.keep.numel()
        a[1] += int(torch.sum(~r.keep))
        return r
    monkeypatch.setattr(tmoe, "route", counted)
    return acc


def test_moe_drops_equal_at_shard_1_and_2(models, monkeypatch):
    """The router is replicated: each site sees the same routing, so the
    (token, expert) assignments dropped at capacity, at prefill and at
    decode, are the unsharded engine's. Four requests of 20 tokens in a
    batch of 8 slots, 10 new: the routing drops some at both stages."""
    counts = {}
    for shard in (1, 2):
        acc = _count_drops(monkeypatch, 8)
        _port(models("moe"), shard, n=4, max_batch=8)
        counts[shard] = acc
        monkeypatch.undo()
    assert counts[1] == counts[2]
    assert counts[1]["decode"][1] > 0 and counts[1]["prefill"][1] > 0


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("H,Hkv", [(32, 2), (14, 2)], ids=["g16", "g7"])
def test_sharded_attention_at_wide_groups_equals_unsharded(g, H, Hkv):
    """One layer's sharded attention at GQA groups 16 and 7 (the MoE's and
    the vlm's; the kernels' plain versions here): ``out`` and the mass on
    absolute coordinates (each site's scores under the global (m*, l),
    the hot mask's max across sites) equal the unsharded call's within
    atol / rtol 1e-5, fp32. Ragged lengths, a wrapped ring, dead blocks
    and a row with no live token."""
    from repro_torch.distributed import pam_shard as tps
    from repro_torch.serving import pam_manager as tpm
    rng = np.random.default_rng(H + g)
    B, d, W, smax, bs, nb1 = 3, 16, 16, 64, 8, 24
    nb = smax // bs
    lens = np.array([45, 60, 0], np.int32)
    pos = np.arange(smax)[None]
    live = (rng.random((B, smax)) < 0.6) & (pos < lens[:, None])
    hot = live & (pos >= lens[:, None] - W) & (rng.random((B, smax)) < 0.7)
    pgd = live & ~hot
    blive = pgd.reshape(B, nb, bs).any(-1)
    table = np.stack([rng.permutation(nb1 - 1)[:nb] for _ in range(B)])
    table = np.where(blive, table, nb1 - 1).astype(np.int32)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    args = (f(B, H, d), f(B, Hkv, W, d), f(B, Hkv, W, d),
            f(nb1, bs, Hkv, d), f(nb1, bs, Hkv, d), torch.from_numpy(lens))
    masks = [torch.from_numpy(a) for a in (hot, pgd, table, blive)]
    out, mass = tps.make_sharded_paged_decode_attn(
        tps.decode_sites(g, "cpu"), *masks)(*args)
    out1, mass1 = tpm.make_paged_decode_attn(*masks)(*args)
    torch.testing.assert_close(out, out1, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(mass, mass1, atol=1e-5, rtol=1e-5)
    assert float(mass[2].abs().max()) == 0.0 and float(mass[0].sum()) > 0
