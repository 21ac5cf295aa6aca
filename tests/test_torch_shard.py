"""The sharded engine's layout and attention against the JAX package.

* ``paged_kv.shard_block_ranges`` and ``pam_shard.merge_collective_bytes``
  equal the reference's, the range error included.
* ``sharding.param_specs``: the split of every leaf of reduced and full
  qwen3-0.6b, minicpm-2b (its 122,753 vocab takes the d-split embedding
  and the row-parallel head) and internvl2-1b at 2 and 4 sites equals
  the reference's ``param_specs`` on a stand-in mesh whose ``shape`` is
  ``{"model": g}`` (all it reads); ``decode_cache_specs`` likewise, per
  family; ``serving_cache_shardings`` splits the ring on W and the pool
  on NB+1 and nothing else.
* The decode attentions: the reference's ``shard_map`` functions run at
  2 and 4 sites on 8 fake CPU devices in a subprocess (the device-count
  flag must precede the JAX import), jitted as the reference's engine
  calls them, on seeded inputs with ragged lengths, a wrapped ring, dead
  blocks and a row with no live token; the port's ``make_sharded_paged_decode_attn`` (through the kernels' plain
  versions), ``make_sequence_sharded_decode_attn`` and
  ``make_gather_based_decode_attn`` match their ``out`` and ``mass``
  within atol 1e-5, rtol 1e-5 (fp32), and the sharded paged attention
  matches the unsharded one to the same tolerance.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.distributed import pam_shard as jps  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models.config import get_config as jget  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro.serving import paged_kv as jpkv  # noqa: E402
from repro_torch.distributed import pam_shard as tps  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402
from repro_torch.serving import paged_kv as tpkv  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("qwen3-0.6b", "minicpm-2b", "internvl2-1b", "qwen3-moe-235b-a22b")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stand_in(g):
    """All the reference's spec rules read of a mesh."""
    return types.SimpleNamespace(shape={"model": g}, axis_names=("model",))


@pytest.mark.parametrize("total,shard", [(24, 2), (24, 4), (1024, 4),
                                         (64, 8), (8, 1)])
def test_shard_block_ranges_equal_the_reference(total, shard):
    assert (tpkv.shard_block_ranges(total, shard)
            == jpkv.shard_block_ranges(total, shard))


def test_shard_block_ranges_refuse_an_uneven_pool():
    for mod in (tpkv, jpkv):
        with pytest.raises(ValueError, match="do not split"):
            mod.shard_block_ranges(65, 2)


@pytest.mark.parametrize("args,smax", [((28, 16, 128, 8), 2048),
                                       ((2, 4, 16, 2), 64),
                                       ((40, 40, 128, 8), 0)])
def test_merge_collective_bytes_equal_the_reference(args, smax):
    assert (tps.merge_collective_bytes(*args, smax=smax)
            == jps.merge_collective_bytes(*args, smax=smax))


def _jax_specs(cfg, g):
    specs = jshd.param_specs(cfg, _stand_in(g))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {".".join(str(k.key) for k in path): tuple(spec)
            for path, spec in flat[0]}


@pytest.fixture(scope="module")
def port_shapes():
    """Port parameter shapes by config (fake tensors), made once."""
    cache = {}

    def get(arch, small):
        key = (arch, small)
        if key not in cache:
            cfg = tcfg.get_config(arch)
            cache[key] = tshd.param_shapes(tcfg.reduced(cfg) if small
                                           else cfg)
        return cache[key]
    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("small", [True, False], ids=["reduced", "full"])
def test_param_specs_split_every_leaf_as_the_reference(port_shapes, arch,
                                                       small):
    jcfg = jreduced(jget(arch)) if small else jget(arch)
    shapes = port_shapes(arch, small)
    for g in (2, 4):
        want = _jax_specs(jcfg, g)
        got = {p: tshd.leaf_spec(p.split(".")[-1],
                                 (p.split(".")[-2] if "." in p else ""),
                                 s, g) for p, s in shapes.items()}
        assert got == want, (arch, g)
    if arch == "minicpm-2b" and not small:
        # an odd vocabulary: the embedding splits d, the head its rows
        assert want["embed"] == (None, "model")
        assert want["lm_head"] == ("model", None)


def test_param_specs_of_a_tree_read_its_shapes():
    cfg = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    params = ttf.init_params(cfg, 0, device="cpu")
    specs = tshd.param_specs(cfg, 4, params)
    assert specs == tshd.param_specs(cfg, 4)
    assert specs["layers.attn.wk"] == (None, None, "model")  # 32 columns
    assert specs["layers.attn.wo"] == (None, "model", None)
    assert specs["embed"] == ("model", None)                 # vocab 256
    assert specs["layers.ln1"] == (None, None)


def _norm(spec):
    return tuple(None if e == () else e for e in spec)


@pytest.mark.parametrize("arch", ARCHS + ("mamba2-780m", "zamba2-7b",
                                          "deepseek-v2-lite-16b"))
def test_decode_cache_specs_equal_the_reference(arch):
    jcfg, tcf = jreduced(jget(arch)), tcfg.reduced(tcfg.get_config(arch))
    for g in (2, 4):
        want = jshd.decode_cache_specs(jcfg, 8, _stand_in(g))
        got = tshd.decode_cache_specs(tcf, g)
        for f in got._fields:
            assert _norm(getattr(got, f)) == _norm(getattr(want, f)), (
                arch, g, f)


def test_serving_cache_shardings_split_ring_and_pool():
    cfg = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    cache = ttf.init_decode_cache(cfg, 2, 64, paged_blocks=23, block_size=8,
                                  hot_window=16, device="cpu")
    got = tshd.serving_cache_shardings(cache, 4)
    assert got.k == got.v == (None, None, None, "model", None)
    assert got.pk == got.pv == (None, "model", None, None, None)
    assert got.lengths == got.conv == got.state == got.ckv == ()
    dense = ttf.init_decode_cache(cfg, 2, 64, device="cpu")
    assert tshd.serving_cache_shardings(dense, 3).k == ()   # 64 % 3


# ------------------------------------------------------------ attention
B, H, HKV, D = 3, 4, 2, 16
W, SMAX, BS, NB1 = 16, 64, 8, 24          # ring slots, window, pool


def _paged_inputs(seed):
    """One layer's ring and pool with the engine's tier split: ragged
    lengths (row 1 wraps the ring, row 2 has no live token), the hot
    mask inside the window, dead table entries on the sentinel."""
    rng = np.random.default_rng(seed)
    nb = SMAX // BS
    lens = np.array([45, 60, 0], np.int32)
    pos = np.arange(SMAX)[None]
    live = (rng.random((B, SMAX)) < 0.6) & (pos < lens[:, None])
    in_win = pos >= lens[:, None] - W
    hot = live & in_win & (rng.random((B, SMAX)) < 0.7)
    pgd = live & ~hot
    block_live = pgd.reshape(B, nb, BS).any(-1)
    table = np.stack([rng.permutation(NB1 - 1)[:nb] for _ in range(B)])
    table = np.where(block_live, table, NB1 - 1).astype(np.int32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(q=f(B, H, D), kc=f(B, HKV, W, D), vc=f(B, HKV, W, D),
                pk=f(NB1, BS, HKV, D), pv=f(NB1, BS, HKV, D),
                lens=lens, hot=hot, pgd=pgd, block_live=block_live,
                table=table)


def _dense_inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(q=f(B, H, D), k=f(B, HKV, SMAX, D), v=f(B, HKV, SMAX, D),
                lens=np.array([37, 64, 0], np.int32))


_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
import jax
import jax.numpy as jnp
import numpy as np
jax.config.update("jax_platform_name", "cpu")
from repro.distributed import pam_shard as psh
assert jax.device_count() == 8
src, dst = sys.argv[1], sys.argv[2]
x = dict(np.load(src))
out = {}
for g in (2, 4):
    mesh = psh.decode_mesh(g)
    for seed in (0, 1):
        p = {k[len(f"p{seed}_"):]: jnp.asarray(v) for k, v in x.items()
             if k.startswith(f"p{seed}_")}
        fn = jax.jit(psh.make_sharded_paged_decode_attn(
            mesh, p["hot"], p["pgd"], p["table"], p["block_live"]))
        o, m = fn(p["q"], p["kc"], p["vc"], p["pk"], p["pv"], p["lens"])
        out[f"paged_g{g}_s{seed}_out"], out[f"paged_g{g}_s{seed}_mass"] = o, m
    d = {k[2:]: jnp.asarray(v) for k, v in x.items() if k.startswith("d_")}
    for name, make in (("seq", psh.make_sequence_sharded_decode_attn),
                       ("gather", psh.make_gather_based_decode_attn)):
        o, m = jax.jit(make(mesh))(d["q"], d["k"], d["v"], d["lens"])
        out[f"{name}_g{g}_out"], out[f"{name}_g{g}_mass"] = o, m
np.savez(dst, **{k: np.asarray(v) for k, v in out.items()})
print("REFERENCE DONE")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded attentions at 2 and 4 sites, run once in
    a subprocess on 8 fake CPU devices: (inputs, outputs)."""
    tmp = tmp_path_factory.mktemp("shard_ref")
    inputs = {}
    for seed in (0, 1):
        inputs.update({f"p{seed}_{k}": v
                       for k, v in _paged_inputs(seed).items()})
    inputs.update({f"d_{k}": v for k, v in _dense_inputs(2).items()})
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(src),
                          str(dst)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, f"{run.stdout}\n{run.stderr}"
    assert "REFERENCE DONE" in run.stdout
    return inputs, dict(np.load(dst))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_paged_attention_matches_the_reference(reference, g, seed):
    inputs, want = reference
    p = {k[len(f"p{seed}_"):]: _t(v) for k, v in inputs.items()
         if k.startswith(f"p{seed}_")}
    fn = tps.make_sharded_paged_decode_attn(
        tps.decode_sites(g, "cpu"), p["hot"], p["pgd"], p["table"],
        p["block_live"])
    out, mass = fn(p["q"], p["kc"], p["vc"], p["pk"], p["pv"], p["lens"])
    np.testing.assert_allclose(out.numpy(), want[f"paged_g{g}_s{seed}_out"],
                               **TOL)
    np.testing.assert_allclose(mass.numpy(),
                               want[f"paged_g{g}_s{seed}_mass"], **TOL)
    assert float(mass[2].abs().max()) == 0.0       # no live token
    # the unsharded attention over the same tiers: the same numbers
    one = tpm.make_paged_decode_attn(p["hot"], p["pgd"], p["table"],
                                     p["block_live"])
    out1, mass1 = one(p["q"], p["kc"], p["vc"], p["pk"], p["pv"],
                      p["lens"])
    torch.testing.assert_close(out, out1, **TOL)
    torch.testing.assert_close(mass, mass1, **TOL)


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("name", ["seq", "gather"])
def test_sequence_and_gather_attention_match_the_reference(reference, g,
                                                           name):
    inputs, want = reference
    d = {k[2:]: _t(v) for k, v in inputs.items() if k.startswith("d_")}
    make = {"seq": tps.make_sequence_sharded_decode_attn,
            "gather": tps.make_gather_based_decode_attn}[name]
    out, mass = make(tps.decode_sites(g, "cpu"))(d["q"], d["k"], d["v"],
                                                 d["lens"])
    np.testing.assert_allclose(out.numpy(), want[f"{name}_g{g}_out"], **TOL)
    np.testing.assert_allclose(mass.numpy(), want[f"{name}_g{g}_mass"],
                               **TOL)


def test_site_all_reduce_orders_and_refuses():
    xs = [torch.tensor([1.0, 5.0]), torch.tensor([3.0, 2.0]),
          torch.tensor([-1.0, 4.0])]
    assert tps.site_all_reduce(xs, "max").tolist() == [3.0, 5.0]
    assert tps.site_all_reduce(xs).tolist() == [3.0, 11.0]
    with pytest.raises(ValueError, match="op"):
        tps.site_all_reduce(xs, "min")
    sites = tps.decode_sites(4, "cpu")
    assert sites.size == 4 and set(sites.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError):
        tps.decode_sites(0, "cpu")
