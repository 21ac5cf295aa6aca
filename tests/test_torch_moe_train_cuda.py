"""The mixture-of-experts families' train path on the card:
``flash_attention`` at qwen3-moe-235b-a22b's (head dim, group) = (128,
16), both directions, and one train step of a narrowed GQA MoE and of
the reduced MLA MoE, card against CPU.

bf16 runs the wgmma kernels (``csrc/flash_attention_sm90.cu``,
``csrc/flash_attention_bwd_sm90.cu``), fp32 the 3xTF32 tensor-core ones
(``csrc/flash_attention_tf32x3.cu``, ``csrc/flash_attention_bwd_tf32x3.cu``); every
call's launches are counted by variant, and each kernel is held to its
plain version on the same inputs. The MLA model's attention is the plain
chunked one of ``mla_train`` (no counted launch), as in the reference.
Every test needs an NVIDIA GPU and skips without one; the file imports
neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_moe_train_cuda.py

Tolerances, as ``tests/test_torch_attention_train_cuda.py``: bf16
outputs and gradients rtol / atol 2e-2, the fp32 log-sum-exp rtol 1e-4 /
atol 1e-3; fp32 outputs rtol 1e-4 / atol 1e-3 and gradients rtol / atol
1e-3; TF32 off. The train steps, card (fp32) against CPU: the loss to
1e-5 relative and each gradient leaf within 1e-3 of its largest entry,
as ``chip_smoke.py``'s train parity phases, after the routing of every
layer is held equal (a flipped expert moves a whole token's gradient).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from repro_torch.tree import (leaves, leaves_with_paths,  # noqa: E402
                               unflatten)

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FP32_TOL = dict(rtol=1e-4, atol=1e-3)
FP32_BWD_TOL = dict(rtol=1e-3, atol=1e-3)
D, REP = 128, 16        # qwen3-moe-235b-a22b: 64 query heads over 4 KV


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, B, Hkv, S, dtype, device):
    """q, k, v, dO at group 16: q and dO (B, 16 Hkv, S, 128), k and v
    (B, Hkv, S, 128)."""
    rng = np.random.default_rng(seed)
    H = REP * Hkv
    return [torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
            .to(device) for s in ((B, H, S, D), (B, Hkv, S, D),
                                  (B, Hkv, S, D), (B, H, S, D))]


def _close(got, ref, tol):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().float().cpu().numpy(),
                                   r.detach().float().cpu().numpy(), **tol)


def _counts():
    return (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches,
            tfa.flash_attention.wgmma_launches,
            tfa.flash_attention_bwd.wgmma_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hkv,S", [(2, 1, 200), (1, 2, 130),
                                     (1, 4, 500)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_g16_matches_plain(cuda, dtype, B, Hkv, S):
    """``flash_attention``'s autograd Function at (128, 16), causal, over
    sequences ending in a ragged tile, against the plain versions: one
    forward and one backward launch a call, both wgmma ones in bf16,
    none in fp32; bf16 also against ``_bwd_rounded``, the plain model of
    the wgmma backward's roundings."""
    q, k, v, do = _inputs(S + Hkv, B, Hkv, S, dtype, cuda)
    scale = D ** -0.5
    wgmma = dtype == torch.bfloat16
    assert tfa._variant(dtype, D) == tfa._variant(dtype, D, backward=True)
    qc, kc, vc = (t.detach().requires_grad_() for t in (q, k, v))
    n0 = _counts()
    out = tfa.flash_attention(qc, kc, vc, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(n0, _counts())) == (
        1, 1, int(wgmma), int(wgmma))
    ref_o, ref_lse = tfa._fwd_plain(q, k, v, True, scale)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    _close([lse], [ref_lse], FP32_TOL)
    _close([out, o], [ref_o, ref_o], BF16_TOL if wgmma else FP32_TOL)
    grads = (qc.grad, kc.grad, vc.grad)
    ref_g = tfa._bwd_plain(q, k, v, o, lse, do, True, scale)
    _close(grads, ref_g, BF16_TOL if wgmma else FP32_BWD_TOL)
    if wgmma:
        _close(grads, tfa._bwd_rounded(q, k, v, o, lse, do, True, scale),
               BF16_TOL)


@pytest.mark.cuda
def test_flash_attention_g16_wgmma_at_train_length(cuda):
    """The bf16 wgmma forward and backward over qwen3-moe-235b-a22b's
    train length (S 2048, causal, 1 of its 4 KV heads and its 16 query
    heads): one wgmma launch each, against the plain versions; the dK /
    dV CTA walks all 16 heads of the group."""
    q, k, v, do = _inputs(2048, 1, 1, 2048, torch.bfloat16, cuda)
    scale = D ** -0.5
    n0 = _counts()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(n0, _counts())) == (1, 1, 1, 1)
    ref_o, ref_lse = tfa._fwd_plain(q, k, v, True, scale)
    _close([o], [ref_o], BF16_TOL)
    _close([lse], [ref_lse], FP32_TOL)
    _close(grads, tfa._bwd_plain(q, k, v, o, lse, do, True, scale),
           BF16_TOL)


# ------------------------------------------------------------ train steps
def _narrowed(case):
    """The reduced qwen3-moe-235b-a22b at the card's pair, 16 query heads
    over 1 KV head of 128 (4 experts top-2), or the reduced
    deepseek-v2-lite-16b (MLA, 4 experts top-2 and a shared expert)."""
    if case == "mla":
        return tcfg.reduced(tcfg.get_config("deepseek-v2-lite-16b"))
    return dataclasses.replace(
        tcfg.reduced(tcfg.get_config("qwen3-moe-235b-a22b")), n_heads=16,
        n_kv_heads=1, d_head=D)


def _to(tree_, device):
    return unflatten(tree_, [t.to(device) for t in leaves(tree_)])


def _routed(cfg, tc, params, batch):
    """(loss, grads, every layer's expert ids) of one gradient call."""
    ids, route = [], tmoe.route

    def recorded(p, xf, mcfg):
        r = route(p, xf, mcfg)
        ids.append(r.expert_ids.cpu())
        return r
    tmoe.route = recorded
    try:
        loss, grads = tts.build_grad_fn(cfg, tc)(params, batch)
    finally:
        tmoe.route = route
    return loss, grads, ids


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["g16", "mla"])
def test_moe_train_step_card_equals_cpu(cuda, case):
    """The model's loss and gradients (fp32: the GQA model through the
    tf32x3 attention kernels, 1 forward and 1 backward launch a
    layer; the MLA model through no counted kernel) and one train step
    on the card against the same on the CPU from one state (drawn on the
    CPU, copied to the card): every layer's expert ids equal, then the
    loss, each gradient leaf (the fp32 router included) and the
    parameters after the step."""
    cfg = _narrowed(case)
    tc = tts.TrainConfig(use_kernel=True)
    state = tts.init_train_state(cfg, tc, 0, device="cpu")
    cstate = tts.TrainState(
        params=_to(state.params, cuda),
        opt=state.opt._replace(step=state.opt.step.to(cuda),
                               mu=_to(state.opt.mu, cuda),
                               nu=_to(state.opt.nu, cuda)),
        error_feedback=None)
    rng = np.random.default_rng(0)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 300)))
         for k in ("tokens", "labels")}
    cb = _to(b, cuda)
    n0 = _counts()
    kl, kg, kids = _routed(cfg, tc, cstate.params, cb)
    torch.cuda.synchronize()
    attn = 0 if cfg.mla is not None else cfg.n_layers
    assert tuple(b - a for a, b in zip(n0, _counts())) == (attn, attn, 0, 0)
    pl, pg, pids = _routed(cfg, tc, state.params, b)
    assert len(kids) == len(pids) == cfg.n_layers
    for a, c in zip(kids, pids):
        assert torch.equal(a, c)
    assert abs(float(kl) - float(pl)) <= 1e-5 * abs(float(pl))
    assert kg["layers"]["moe"]["router"].dtype == torch.float32
    for (name, g), r in zip(leaves_with_paths(kg), leaves(pg)):
        if r.numel():
            scale = float(r.abs().max())
            assert float((g.cpu() - r).abs().max()) <= 1e-3 * scale, name
    state, m = tts.build_train_step(cfg, tc)(state, b)
    cstate, cm = tts.build_train_step(cfg, tc)(cstate, cb)
    assert abs(float(cm["loss"]) - float(m["loss"])) <= 1e-5 * abs(
        float(m["loss"]))
    for (name, a), c in zip(leaves_with_paths(state.params),
                            leaves(cstate.params)):
        if a.numel():            # not the empty shared or norm leaves
            assert float((c.cpu() - a).abs().max()) <= 1e-3, name
