"""The pipeline, the fused decode update and the elastic restore against
the JAX package's multi-device checks (``tests/distributed_checks.py``).

One subprocess runs the reference on 8 fake CPU devices (the device-count
flag must precede the JAX import), once for the module, on inputs drawn
here from fixed numpy seeds at that file's shapes:

* ``fused_update_decode`` (B 2, H 8, Hkv 4, S 64, dh 16, lengths 37 and
  5: different sites own the write) on an 8-site ``("model",)`` mesh:
  the port's under an 8-site grid matches ``out`` within 2e-5 and
  ``mass`` within rtol 2e-4 / atol 2e-5, and its in-place caches within
  1e-6;
* ``pipeline_apply`` over 8 stages of one tanh layer, 4 microbatches of
  2 x 16: the port's within 1e-5;
* the elastic restore: the reference saves reduced qwen3-0.6b's params
  from a (2, 4) mesh; after ``plan_recovery`` drops a host, the port
  restores them onto its (1, 4) grid bit-equal, and restores its own
  save on (2, 4) onto (1, 4) too.

``plan_recovery`` and ``rescale_batch`` equal the reference's on the
cases of ``tests/test_distributed.py``, the ``RuntimeError`` included.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed import elastic as jel  # noqa: E402
from repro_torch.checkpoint import restore_pytree, save_pytree  # noqa: E402
from repro_torch.distributed import elastic as tel  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.distributed.pam_shard import fused_update_decode  # noqa: E402
from repro_torch.distributed.pipeline import (  # noqa: E402
    pipeline_apply, stages_from_layers)
from repro_torch.launch.mesh import grid_from_sites, make_grid  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import perf_flags  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, HKV, S, DH = 2, 8, 4, 64, 16
L, D, M, MB = 8, 16, 4, 2

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
jax.config.update("jax_platform_name", "cpu")
from repro import compat  # noqa: F401  (backfills jax.set_mesh)
from repro.checkpoint import save_pytree
from repro.distributed import sharding as shd
from repro.distributed.pam_shard import fused_update_decode
from repro.distributed.pipeline import pipeline_apply, stages_from_layers
from repro.models import transformer as tf
from repro.models.config import get_config, reduced
assert jax.device_count() == 8
src, dst, ckpt = sys.argv[1], sys.argv[2], sys.argv[3]
x = {k: jnp.asarray(v) for k, v in np.load(src).items()}
out = {}
mesh = jax.make_mesh((8,), ("model",))
with jax.set_mesh(mesh):
    o, m, kc, vc = jax.jit(lambda *a: fused_update_decode(*a))(
        x["q"], x["k"], x["v"], x["kn"], x["vn"], x["lens"])
out.update(out=o, mass=m, kc=kc, vc=vc)
stage_mesh = jax.make_mesh((8,), ("stage",))

def stage_fn(params, h):
    def body(h, w):
        return jnp.tanh(h @ w), None
    return jax.lax.scan(body, h, params["w"])[0]
with jax.set_mesh(stage_mesh):
    out["pipeline"] = pipeline_apply(stage_mesh, stage_fn, 8)(
        stages_from_layers({"w": x["ws"]}, 8), x["xs"])
cfg = reduced(get_config("qwen3-0.6b"))
params = tf.init_params(cfg, jax.random.PRNGKey(7))
mesh_a = jax.make_mesh((2, 4), ("data", "model"))
specs = shd.param_specs(cfg, mesh_a)
save_pytree(jax.tree.map(
    lambda a, s: jax.device_put(a, NamedSharding(mesh_a, s)), params, specs,
    is_leaf=lambda a: isinstance(a, P)), ckpt)
out.update({f"param_{i:03d}": a for i, a in
            enumerate(jax.tree.leaves(params))})
np.savez(dst, **{k: np.asarray(v) for k, v in out.items()})
print("REFERENCE DONE")
"""


def _inputs():
    rng = np.random.default_rng(4)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    return dict(q=f(B, H, DH), k=f(B, HKV, S, DH), v=f(B, HKV, S, DH),
                kn=f(B, HKV, DH), vn=f(B, HKV, DH),
                lens=np.array([37, 5], np.int32),
                ws=f(L, D, D) * 0.3, xs=f(M, MB, D))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_ref")
    inputs = _inputs()
    src, dst, ckpt = tmp / "in.npz", tmp / "out.npz", tmp / "ckpt"
    np.savez(src, **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(src),
                          str(dst), str(ckpt)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, f"{run.stdout}\n{run.stderr}"
    assert "REFERENCE DONE" in run.stdout
    return inputs, dict(np.load(dst)), str(ckpt)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_fused_update_decode_matches_the_reference(reference):
    x, want, _ = reference
    kc, vc = _t(x["k"]).clone(), _t(x["v"]).clone()
    with perf_flags.use_grid(make_grid((8,), ("model",), device="cpu")):
        out, mass, k2, v2 = fused_update_decode(
            _t(x["q"]), kc, vc, _t(x["kn"]), _t(x["vn"]), _t(x["lens"]))
    np.testing.assert_allclose(out.numpy(), want["out"], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(mass.numpy(), want["mass"], rtol=2e-4,
                               atol=2e-5)
    assert k2 is kc and v2 is vc                 # the write is in place
    np.testing.assert_allclose(kc.numpy(), want["kc"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vc.numpy(), want["vc"], rtol=1e-6, atol=1e-6)


def test_pipeline_matches_the_reference(reference):
    x, want, _ = reference

    def stage_fn(params, h):
        for w in params["w"]:
            h = torch.tanh(h @ w)
        return h
    stacked = stages_from_layers({"w": _t(x["ws"])}, 8)
    assert stacked["w"].shape == (8, 1, D, D)
    got = pipeline_apply(make_grid((8,), ("stage",), device="cpu"),
                         stage_fn, 8)(stacked, _t(x["xs"]))
    np.testing.assert_allclose(got.numpy(), want["pipeline"], rtol=1e-5,
                               atol=1e-5)
    # 2 stages of 4 layers: the same sequential result
    two = pipeline_apply(make_grid((2,), ("stage",), device="cpu"),
                         stage_fn, 2)(stages_from_layers(
                             {"w": _t(x["ws"])}, 2), _t(x["xs"]))
    np.testing.assert_allclose(two.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="stage"):
        pipeline_apply(make_grid((4,), ("stage",), device="cpu"),
                       stage_fn, 8)


def test_elastic_restore_onto_a_smaller_grid(reference, tmp_path):
    _, want, ckpt = reference
    cfg = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    template = ttf.init_params(cfg, 0, device="cpu")
    params = [_t(want[k]) for k in sorted(want) if k.startswith("param_")]
    assert len(params) == len(leaves(template))
    kept, info = tel.plan_recovery(list(range(8)), failed_hosts={1},
                                   model_parallel=4, devices_per_host=4)
    assert info["new_dp"] == 1 and kept == [0, 1, 2, 3]
    grid_b = grid_from_sites(len(kept), 4, device="cpu")
    assert grid_b.shape == {"data": 1, "model": 4}
    shardings = tshd.param_shardings(cfg, grid_b)
    got = restore_pytree(template, ckpt, shardings=shardings)
    for (path, a), c in zip(leaves_with_paths(got), params):
        assert torch.equal(a, c), path
    # the port's own save from a (2, 4) grid restores onto (1, 4) the same
    on_a = restore_pytree(template, ckpt, shardings=tshd.param_shardings(
        cfg, make_grid((2, 4), device="cpu")))
    own = str(tmp_path / "own")
    save_pytree(on_a, own)
    again = restore_pytree(template, own, shardings=shardings)
    for (path, a), c in zip(leaves_with_paths(again), params):
        assert torch.equal(a, c), path
    bad = {"embed": tshd.GridSharding(make_grid((1, 3), device="cpu"),
                                      ("model", None))}
    with pytest.raises(ValueError, match="does not split"):
        restore_pytree(template, ckpt, shardings=bad)


def test_plan_recovery_and_rescale_batch_equal_the_reference():
    cases = [(list(range(32)), {3}, 16, 8), (list(range(8)), {1}, 4, 4),
             (list(range(24)), {0, 2}, 4, 8)]
    for devices, failed, mp, per_host in cases:
        assert (tel.plan_recovery(devices, failed, mp, per_host)
                == jel.plan_recovery(devices, failed, mp, per_host))
    kept, info = tel.plan_recovery(list(range(32)), {3}, 16, 8)
    assert len(kept) == 16 and info == {"lost_devices": 8,
                                        "idle_devices": 8, "new_dp": 1,
                                        "model_parallel": 16}
    for mod in (tel, jel):
        with pytest.raises(RuntimeError):
            mod.plan_recovery(list(range(8)), {0}, 16, 8)
    for args in ((256, 16, 8), (256, 16, 8, False), (96, 8, 3),
                 (64, 4, 8)):
        assert tel.rescale_batch(*args) == jel.rescale_batch(*args)
    assert tel.rescale_batch(256, 16, 8) == (16, 2)
