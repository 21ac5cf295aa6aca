"""The dense family's training on a (data, model) site grid against the
JAX package on the CPU.

* Specs: ``param_specs`` (``fsdp`` off and on), ``opt_state_specs``,
  ``batch_specs`` and ``batch_dp_spec`` equal the reference's for every
  registered config on stand-in ``("data", "model")`` meshes (1, 2),
  (2, 2), (1, 4), (2, 4) and (4, 2), batches 4 and 1 (the reference
  reads only a mesh's ``shape`` and ``axis_names``; its ``jax.eval_shape``
  of each config's init is memoized per config, which fixes no spec).
  ``PartitionSpec`` folds a one-name tuple entry to the name, so the
  comparison does too. ``make_batch_specs`` gives the reference's shapes
  and dtypes for the text, vlm and audio families.
* The sharded train step: reduced qwen3-0.6b and pam-llama-7b from the
  reference's initial state (``bridge.train_state_from_jax``) on grids
  (2, 4), (1, 4) and (2, 2) with ZeRO-1, (2, 2) with FSDP, (1, 4) with
  ``activation_spec`` and (2, 2) with 2 microbatches: the first loss
  within rtol 1e-4 of the JAX unsharded ``build_train_step`` (the
  reference's own bound in ``tests/distributed_checks.py``); the loss of
  3 steps, every gradient leaf and the parameters and moments after 3
  steps within 1e-6 (rtol and atol) of the port's one-site step. The
  steps run AdamW at the reference check's lr 1e-3 with eps 1e-3: the
  split sums each product in another order, and at the default eps 1e-8
  the update ``m / (sqrt(v) + eps)`` of an entry whose gradient is fp32
  noise (near 1e-7) is an lr-sized step whose size the summation order
  picks (entries of reduced qwen3-0.6b's embedding and pam-llama-7b's
  ``down`` moved 3.5e-6 to 3.8e-6 apart in 3 steps, at lr 1e-3 and
  1e-4 alike); at eps 1e-3 the update moves at most lr / eps times a
  gradient's difference.
* The split: the attention runs one kernel call a site on its heads when
  they divide, and one joined call when they do not; the other families
  refuse a grid of more than one site naming ROADMAP Queue 1 item 10.
* The train CLI with ``--shard 2``: the loss trajectory of ``--shard 1``
  within 1e-6, and a resume onto the grid.
fp32 throughout; the attention through the kernels' plain versions.
"""

import json
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.data import pipeline as jdata  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models.config import get_config as jget  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.data import SyntheticLM, make_batch_specs  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import dp_axes, dp_size, make_grid  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

GRIDS = ((1, 2), (2, 2), (1, 4), (2, 4), (4, 2))
CONFIGS = sorted(tcfg.all_configs())
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
B, S, STEPS, LR, EPS = 4, 24, 3, 1e-3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stand_in(data, model):
    return types.SimpleNamespace(shape={"data": data, "model": model},
                                 axis_names=("data", "model"))


class _MemoJax:
    """``jax`` with ``eval_shape`` of the reference's init closures
    memoized per config (the closure's one cell)."""

    def __init__(self):
        self._memo = {}

    def __getattr__(self, name):
        return getattr(jax, name)

    def eval_shape(self, fn, *args):
        cells = fn.__closure__ or ()
        if args or len(cells) != 1:
            return jax.eval_shape(fn, *args)
        key = cells[0].cell_contents
        if key not in self._memo:
            self._memo[key] = jax.eval_shape(fn)
        return self._memo[key]


@pytest.fixture(scope="module")
def memo_jax():
    mp = pytest.MonkeyPatch()
    mp.setattr(jshd, "jax", _MemoJax())
    yield
    mp.undo()


def _fold(entry):
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _fold_spec(spec):
    return tuple(_fold(e) for e in spec)


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {".".join(str(k.key) for k in path): tuple(spec)
            for path, spec in flat}


def _port(specs):
    return {p: _fold_spec(s) for p, s in specs.items()}


@pytest.mark.parametrize("arch", CONFIGS)
def test_specs_equal_the_reference(memo_jax, arch):
    jcfg, cfg = jget(arch), tcfg.get_config(arch)
    for data, model in GRIDS:
        mesh = _stand_in(data, model)
        for fsdp in (False, True):
            want = _jax_specs(jshd.param_specs(jcfg, mesh, fsdp=fsdp))
            assert _port(tshd.param_specs(cfg, mesh, fsdp=fsdp)) == want, (
                arch, data, model, fsdp)
            want = _jax_specs(jshd.opt_state_specs(jcfg, mesh, fsdp=fsdp))
            assert _port(tshd.opt_state_specs(cfg, mesh, fsdp=fsdp)) == want
        for batch in (4, 1):
            want = {k: tuple(v) for k, v in
                    jshd.batch_specs(jcfg, batch, mesh).items()}
            assert _port(tshd.batch_specs(cfg, batch, mesh)) == want
            assert (tshd.batch_dp_spec(batch, mesh)
                    == jshd.batch_dp_spec(batch, mesh))


def test_specs_split_data_where_the_rules_say():
    """The rules' data entries on a (2, 4) grid: ZeRO-1 on the first
    free axis that divides, FSDP on every >= 2-D weight, MoE experts
    over data, a one-row batch replicated."""
    mesh = _stand_in(2, 4)
    cfg = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    ps, os_ = tshd.param_specs(cfg, mesh), tshd.opt_state_specs(cfg, mesh)
    assert ps["layers.attn.wq"] == (None, None, "model")
    assert os_["layers.attn.wq"] == ("data", None, "model")   # L = 2
    assert ps["layers.ln1"] == (None, None)
    assert tshd.param_specs(cfg, mesh, fsdp=True)["embed"] == ("model",
                                                              "data")
    moe = tcfg.reduced(tcfg.get_config("qwen3-moe-235b-a22b"))
    assert tshd.param_specs(moe, mesh)["layers.moe.w_down"] == (
        None, "data", "model", None)
    assert tshd.batch_dp_spec(1, mesh) is None
    assert tshd.batch_dp_spec(4, mesh) == ("data",)
    assert tshd.param_specs(cfg, 4) == tshd.param_specs(
        cfg, _stand_in(1, 4))          # a serving site count: ("model",)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "internvl2-1b",
                                  "hubert-xlarge"])
def test_make_batch_specs_equal_the_reference(arch):
    jcfg, cfg = jget(arch), tcfg.get_config(arch)
    want = jdata.make_batch_specs(jcfg, 4, 2048)
    got = make_batch_specs(cfg, 4, 2048)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert tuple(t.shape) == tuple(want[k].shape), (arch, k)
        assert str(t.dtype).replace("torch.", "") == str(want[k].dtype)
        assert t.device.type == "meta"


def test_sharded_zeros_and_grid_helpers():
    grid = make_grid((2, 4), device="cpu")
    assert dp_axes(grid) == ("data",) and dp_size(grid) == 2
    assert grid.size == 8
    cfg = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    shapes = {"a": torch.empty((4, 8), device="meta"),
              "b": torch.empty((3,), dtype=torch.int32, device="meta")}
    z = tshd.make_sharded_zeros({"a": ("data", "model"), "b": (None,)},
                                shapes, grid)
    assert z["a"].shape == (4, 8) and not z["a"].any()
    assert z["b"].dtype == torch.int32
    with pytest.raises(ValueError, match="does not split"):
        tshd.make_sharded_zeros({"a": (None, "model")},
                                {"a": torch.empty((4, 6), device="meta")},
                                grid)
    sh = tshd.param_shardings(cfg, grid)["layers.attn.wq"]
    assert sh.shard_shape((2, 64, 64)) == (2, 64, 16)
    blocks = tp.site_blocks((2, 64, 64), ("data", None, "model"), grid)
    assert len(blocks) == 8 and blocks[5] == (slice(1, 2), slice(None),
                                              slice(16, 32))


# ------------------------------------------------------------ train step
CASES = {"zero1_2x4": ((2, 4), {}), "zero1_1x4": ((1, 4), {}),
         "zero1_2x2": ((2, 2), {}), "fsdp_2x2": ((2, 2), {"fsdp": True}),
         "activation_spec_1x4": ((1, 4), {"activation_spec": (
             "data", "model", None)}),
         "microbatches_2x2": ((2, 2), {"microbatches": 2})}


def _jb(vocab):
    return SyntheticLM(vocab=vocab, seq_len=S, batch=B, seed=0).batch_at(0)


def _tcfg(**kw):
    return tts.TrainConfig(adamw=toptim.AdamWConfig(lr=LR, eps=EPS),
                           use_kernel=True, **kw)


def _batch(b, microbatches=1):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    if microbatches > 1:
        out = {k: v.reshape((microbatches, B // microbatches) + v.shape[1:])
               for k, v in out.items()}
    return out


def _run(cfg, state, tcfg_, b, grid=None, fsdp=False):
    """(first grads, losses of STEPS steps, final state)."""
    _, grads = tts.build_grad_fn(cfg, tcfg_, grid=grid, fsdp=fsdp)(
        state.params, b)
    step = tts.build_train_step(cfg, tcfg_, grid=grid, fsdp=fsdp)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return grads, losses, state


@pytest.fixture(scope="module", params=["qwen3-0.6b", "pam-llama-7b"])
def reference(request):
    """The JAX unsharded step's first loss, the reference's initial
    state in the port, and the port's one-site run (plain and 2
    microbatches)."""
    arch = request.param
    jcfg = jreduced(jget(arch))
    jt = jts.TrainConfig(adamw=joptim.AdamWConfig(lr=LR, eps=EPS))
    jstate = jts.init_train_state(jcfg, jt, jax.random.PRNGKey(0))
    b = _jb(jcfg.vocab)
    _, m = jax.jit(jts.build_train_step(jcfg, jt))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    cfg = tcfg.reduced(tcfg.get_config(arch))
    state = bridge.train_state_from_jax(
        cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    one = {mb: _run(cfg, state, _tcfg(microbatches=mb), _batch(b, mb))
           for mb in (1, 2)}
    return cfg, float(m["loss"]), state, b, one


def _close_trees(got, want):
    for (path, a), c in zip(leaves_with_paths(got), leaves(want)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), err_msg=path,
                                   **STEP_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_one_site_and_the_reference(reference, case):
    cfg, jloss, state, b, one = reference
    sizes, kw = CASES[case]
    mb = kw.get("microbatches", 1)
    grads1, losses1, state1 = one[mb]
    tcfg_ = _tcfg(**{k: v for k, v in kw.items() if k != "fsdp"})
    grads, losses, new = _run(cfg, state, tcfg_, _batch(b, mb),
                              make_grid(sizes, device="cpu"),
                              kw.get("fsdp", False))
    np.testing.assert_allclose(losses[0], jloss, rtol=1e-4)
    np.testing.assert_allclose(losses, losses1, **STEP_TOL)
    _close_trees(grads, grads1)
    _close_trees(new.params, state1.params)
    _close_trees(new.opt.mu, state1.opt.mu)
    _close_trees(new.opt.nu, state1.opt.nu)
    assert int(new.opt.step) == STEPS
    # the input state is untouched (no donation)
    assert not any(p.requires_grad for p in leaves(new.params))


@pytest.mark.parametrize("sizes,calls", [((1, 2), [(2, 1)] * 2),
                                         ((1, 4), [(4, 2)]),
                                         ((2, 2), [(2, 1)] * 4)])
def test_attention_runs_a_kernel_call_a_site_when_heads_divide(
        monkeypatch, sizes, calls):
    """Reduced qwen3-0.6b (4 / 2 heads): at 2 model sites each site runs
    its 2 / 1 heads; at 4 the kv heads do not divide, so the projections
    are joined and one call runs all 4 / 2 (the reference's own check
    splits inside a head there). Each data replica runs its own calls."""
    seen = []
    fused = kops.fused_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1]))
        return fused(q, k, v, **kw)
    monkeypatch.setattr(kops, "fused_attention", spy)
    cfg = tcfg.reduced(tcfg.get_config("qwen3-0.6b"))
    from repro_torch.models import transformer as ttf
    params = ttf.init_params(cfg, 0, device="cpu")
    tts.build_grad_fn(cfg, _tcfg(), grid=make_grid(sizes, device="cpu"))(
        params, _batch(_jb(cfg.vocab)))
    assert seen == calls * cfg.n_layers


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen3-moe-235b-a22b",
                                  "internvl2-1b"])
def test_other_families_refuse_a_grid(arch):
    cfg = tcfg.reduced(tcfg.get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
        tts.build_train_step(cfg, _tcfg(), grid=make_grid((1, 2),
                                                          device="cpu"))
    # one site is today's step
    tts.build_train_step(cfg, _tcfg(), grid=make_grid((1, 1), device="cpu"))


def test_train_cli_shard_2_matches_shard_1_and_resumes(tmp_path, capsys):
    base = ["--reduced", "--steps", "4", "--batch", "4", "--seq", "16",
            "--device", "cpu", "--lr", "1e-3"]
    one = train_cli.main(base)
    two = train_cli.main(base + ["--shard", "2"])
    np.testing.assert_allclose(two["losses"], one["losses"], **STEP_TOL)
    assert two["start_step"] == 0
    ck = tmp_path / "ck"
    train_cli.main(base + ["--shard", "2", "--ckpt-dir", str(ck),
                           "--ckpt-every", "2"])
    shutil.rmtree(ck / "step_00000004")     # resume from step 2
    resumed = train_cli.main(base + ["--shard", "2", "--ckpt-dir", str(ck)])
    assert resumed["start_step"] == 2
    np.testing.assert_allclose(resumed["losses"], one["losses"][2:],
                               **STEP_TOL)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["shard"] == 2 and last["start_step"] == 2
