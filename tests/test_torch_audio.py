"""The port's audio family (``hubert-xlarge``: a bidirectional encoder whose
frames go through a linear front end in place of token embeddings, with
no decode step) against the JAX reference, on the CPU.

- the copied config, full and reduced, field for field, its parameter
  count and ``has_decode`` False;
- ``init_params``' layout (``frontend`` beside ``embed``, ``final_norm``
  and ``lm_head``, as the reference keeps them);
- the bidirectional ``forward`` with frames: logits against the
  reference at ``use_kernel=False``, and through the port's plain
  ``flash_attention`` against the Pallas kernel in ``interpret=True``,
  at the reduced heads (4 q / 2 kv of 16) and at 4 / 4 heads of 80
  (hubert-xlarge's head dim, the built forward pair (80, 1));
- ``loss_fn`` and its gradients against ``jax.grad`` of the reference
  loss at ``use_kernel=False``;
- the refusals: ``init_decode_cache``, ``prefill`` and ``decode_step``
  raise the reference's ``ValueError``, the engine and the serve CLI
  its ``AssertionError``;
- the attention kernels' built lists: ``flash_attention.BUILT`` and
  ``BUILT_BWD`` equal ``PAM_ATTN_FWD_BUILT`` / ``PAM_ATTN_BWD_BUILT`` in
  ``csrc/attention_common.cuh`` and each other, and the backward's pair
  check passes the vlm and audio pairs, as the forward's does.

Inputs are fixed-seed numpy draws, fp32. Tolerances: logits rtol / atol
1e-4, loss and gradients 1e-5.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import make_engine  # noqa: E402

from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import get_config, reduced  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402

ARCH = "hubert-xlarge"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# the reduced config (4 q / 2 kv heads of 16), and hubert-xlarge's head
# dim at its group 1 (4 / 4 heads of 80)
VARIANTS = {"reduced": {},
            "d80": dict(n_heads=4, n_kv_heads=4, d_head=80)}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


_MODELS: dict = {}


def _models(variant="reduced"):
    """(JAX cfg, JAX params, port cfg, port params) of a reduced
    variant: the same ``dataclasses.replace`` on both sides, the same
    weights (the reference's ``init_params`` at seed 0)."""
    if variant not in _MODELS:
        cfg = dataclasses.replace(reduced(get_config(ARCH)),
                                  **VARIANTS[variant])
        params = jtf.init_params(cfg, jax.random.PRNGKey(0))
        tcf = dataclasses.replace(tcfg.reduced(tcfg.get_config(ARCH)),
                                  **VARIANTS[variant])
        _MODELS[variant] = (cfg, params, tcf, bridge.params_from_jax(
            tcf, _np_tree(params), device="cpu"))
    return _MODELS[variant]


def _batch(cfg, seed, B=2, S=70):
    """Frames (B, S, frontend_dim) and labels (some ignored); S past one
    64-row tile, so the last tile is ragged."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, -5:] = -1
    return {"frames": rng.standard_normal(
                (B, S, cfg.frontend_dim)).astype(np.float32),
            "labels": labels}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


# ------------------------------------------------------------ the config
def test_config_and_param_count_match_reference():
    """The copied config, full and reduced, field for field, its
    parameter count (1.26 B: 2.52 GB of bf16 at full size), and no
    decode step."""
    for own, ref in ((tcfg.get_config(ARCH), get_config(ARCH)),
                     (tcfg.reduced(tcfg.get_config(ARCH)),
                      reduced(get_config(ARCH)))):
        assert dataclasses.asdict(own) == dataclasses.asdict(ref)
        assert own.param_count() == ref.param_count()
        assert own.has_decode is ref.has_decode is False
        assert own.sub_quadratic is ref.sub_quadratic is False
        assert own.causal is False
    full = tcfg.get_config(ARCH)
    assert (full.head_dim, full.n_heads // full.n_kv_heads) in tfa.BUILT


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_init_params_layout_matches_reference():
    """Keys, shapes and dtypes of ``tf.init_params`` against the
    reference's tree, bf16 and fp32: the encoder keeps ``embed``,
    ``final_norm`` and ``lm_head`` beside its ``frontend``."""
    cfg, _, tcf, _ = _models()
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        ref = _leaves(jax.tree.map(
            lambda a: np.zeros(a.shape, a.dtype),
            jax.eval_shape(lambda: jtf.init_params(
                c, jax.random.PRNGKey(0)))))
        own = _leaves(ttf.init_params(dataclasses.replace(tcf, dtype=dtype),
                                      0, device="cpu"))
        assert sorted(own) == sorted(ref)
        for name, a in ref.items():
            assert tuple(own[name].shape) == a.shape, name
            got = str(own[name].dtype).split(".")[-1]
            assert got == a.dtype.name, (name, got, a.dtype)
    assert {"/frontend", "/embed", "/lm_head", "/final_norm"} <= set(own)


# ------------------------------------------------------------ forward
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["chunked", "flash_attention"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bidirectional_forward_matches_reference(variant, use_kernel):
    """Logits of 70 frames: the port's chunked attention against the
    reference's ``use_kernel=False``, and the port's ``flash_attention``
    (its plain version on the CPU, non-causal) against the Pallas kernel
    in ``interpret=True``; a frame attends the frames after it (the
    first position's logits move when the last frame changes)."""
    cfg, params, tcf, tparams = _models(variant)
    b = _batch(cfg, seed=1)
    jl, _ = jtf.forward(cfg, params, _jb(b), use_kernel=use_kernel)
    tl, aux = ttf.forward(tcf, tparams, _tb(b), use_kernel=use_kernel)
    assert tuple(tl.shape) == (2, 70, cfg.vocab) == jl.shape
    _close(tl, jl, **LOGIT_TOL)
    assert float(aux) == 0.0
    b["frames"][:, -1] += 1.0
    moved, _ = ttf.forward(tcf, tparams, _tb(b), use_kernel=use_kernel)
    assert float((moved[:, 0] - tl[:, 0]).abs().max()) > 1e-6


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match_jax_grad(variant):
    """``loss_fn`` (ignored labels included) and every leaf's gradient,
    the front end's among them and the unused embedding's zero, with the
    port's ``flash_attention`` autograd Function, against ``jax.grad``
    of the reference loss with ``use_kernel=False``."""
    from repro_torch.training import train_step as tts
    from repro_torch.tree import leaves
    cfg, params, tcf, tparams = _models(variant)
    b = _batch(cfg, seed=2, S=40)
    jl, jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(cfg, p, _jb(b), use_kernel=False))(params)
    tl, tg = tts.build_grad_fn(tcf, tts.TrainConfig(use_kernel=True))(
        tparams, _tb(b))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(leaves(tg)) == len(jleaves)
    for g, w in zip(leaves(tg), jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert float(tg["frontend"].abs().max()) > 0
    assert float(tg["embed"].abs().max()) == 0


# ------------------------------------------------------------ refusals
def test_decode_refusals_match_reference():
    """No decode cache, no prefill, no decode step: each raises the
    reference's ``ValueError``."""
    cfg, params, tcf, tparams = _models()
    with pytest.raises(ValueError, match="family audio has no decode step"):
        jtf.init_decode_cache(cfg, 2, 16)
    with pytest.raises(ValueError, match="family audio has no decode step"):
        ttf.init_decode_cache(tcf, 2, 16, device="cpu")
    toks = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match="family audio has no decode step"):
        jtf.prefill(cfg, params, jnp.asarray(toks), 16)
    with pytest.raises(ValueError, match="family audio has no decode step"):
        ttf.prefill(tcf, tparams, torch.from_numpy(toks), 16)
    with pytest.raises(ValueError, match="is encoder-only"):
        jtf.decode_step(cfg, params, jnp.zeros((2,), jnp.int32), None)
    with pytest.raises(ValueError, match="is encoder-only"):
        ttf.decode_step(tcf, tparams, torch.zeros(2, dtype=torch.int32),
                        None)


def test_engine_and_serve_cli_refuse_as_reference():
    """The engine asserts a decode step, as the reference's does; the
    serve CLI builds no PAM config for an encoder and fails there too."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    cfg, params, tcf, tparams = _models()
    with pytest.raises(AssertionError, match="is encoder-only"):
        make_engine(cfg, params, max_batch=2, max_len=32)
    with pytest.raises(AssertionError, match="is encoder-only"):
        teng.ServingEngine(tcf, tparams, teng.ServingConfig(
            max_batch=2, max_len=32), device="cpu")
    args = ["--arch", ARCH, "--reduced", "--requests", "2",
            "--prompt-len", "8", "--gen-len", "2", "--max-len", "32"]
    with pytest.raises(AssertionError, match="is encoder-only"):
        jserve.main(args)
    with pytest.raises(AssertionError, match="is encoder-only"):
        tserve.main(args + ["--device", "cpu"])


# ------------------------------------------------------------ built lists
def _pairs(macro: str) -> tuple:
    src = (Path(tfa.__file__).parent / "csrc" / "attention_common.cuh"
           ).read_text()
    body = re.search(rf"#define {macro}\(X\)((?:.*\\\n)*.*)", src).group(1)
    return tuple((int(d), int(r))
                 for d, r in re.findall(r"X\((\d+),\s*(\d+)\)", body))


def test_attention_built_lists_match_the_cuda_dispatch():
    """``BUILT`` / ``BUILT_BWD`` are the (head dim, group) pairs the CUDA
    dispatch instantiates for the forward and the backward: one list,
    no forward-only pair (internvl2-1b's (64, 7) and hubert-xlarge's
    (80, 1) train on the card)."""
    assert _pairs("PAM_ATTN_FWD_BUILT") == tfa.BUILT
    assert _pairs("PAM_ATTN_BWD_BUILT") == tfa.BUILT_BWD
    assert set(tfa.BUILT) - set(tfa.BUILT_BWD) == set()
    assert tfa.BUILT == tfa.BUILT_BWD


@pytest.mark.parametrize("d,rep", [(64, 7), (80, 1)])
def test_backward_pair_check_passes_the_vlm_and_audio_pairs(d, rep):
    """The backward's pair check passes (64, 7) and (80, 1) and stops at
    the operands (here CPU tensors), as the forward's does."""
    B, Hkv, S = 1, 1, 8
    q = torch.zeros((B, rep * Hkv, S, d))
    k = v = torch.zeros((B, Hkv, S, d))
    lse = torch.zeros((B, rep * Hkv, S))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa._bwd_cuda(q, k, v, q, lse, q, False, 0.5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa._fwd_cuda(q, k, v, False, 0.5)
