"""The kernels of the hybrid family's train path on the card: ``ssd_scan``
at zamba2-7b's (d_state, head dim) = (64, 64) and ``flash_attention`` at
its shared block's (head dim, group) = (112, 1), both directions, and the
narrowed hybrid's train step, card against CPU.

bf16 runs the wgmma kernels (``csrc/ssd_scan_sm90.cu``,
``csrc/ssd_scan_bwd_sm90.cu``, ``csrc/flash_attention_sm90.cu``,
``csrc/flash_attention_bwd_sm90.cu``), fp32 the 3xTF32 tensor-core SSD
kernels (``csrc/ssd_scan_tf32x3.cu``, ``csrc/ssd_scan_bwd_tf32x3.cu``) and
attention ones; every
call's launches are counted by variant. Each kernel is held to its plain
version on the same inputs. The head dim 112 products read the second
swizzle atom of their MN-major operand in part (m64n112k16); they are also
held to the head dim 128 kernels on the same operands zero-padded to 128
columns, whose products read two whole atoms. Every test needs an NVIDIA
GPU and skips without one; the file imports neither JAX nor the
reference package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_hybrid_train_cuda.py

Tolerances, as ``tests/test_torch_cuda.py`` and
``tests/test_torch_attention_train_cuda.py``: bf16 outputs and gradients
rtol / atol 2e-2 (the SSD gradients' atol scaled by each leaf's largest
entry); fp32 SSD outputs rtol 1e-4 / atol 1e-3 and gradients within 1e-3
of each leaf's largest entry; fp32 attention outputs rtol 1e-4 / atol
1e-3 and gradients rtol / atol 1e-3; the log-sum-exp rtol 1e-4 / atol
1e-3. Head dim 112 against zero-padded 128: equal (the padded columns add
exact zeros to every product, and the per-column sums run in the same
order). The train step, card (fp32, TF32 off) against CPU: the loss to
1e-5 relative and each gradient leaf within 1e-3 of its largest entry,
as ``chip_smoke.py``'s train parity phases.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ssd_scan as tss  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from repro_torch.tree import (leaves, leaves_with_paths,  # noqa: E402
                               unflatten)

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FP32_TOL = dict(rtol=1e-4, atol=1e-3)
FP32_BWD_TOL = dict(rtol=1e-3, atol=1e-3)
N, P = 64, 64           # zamba2-7b's SSD shape
D = 112                 # zamba2-7b's head dim


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ------------------------------------------------------------ ssd_scan
def _ssd_case(seed, B, L, H, G, view, dtype):
    """SSD operands at (N, P) = (64, 64) with the model's decay rates (a =
    -exp(a_log), a_log from log 1 to log 16); with ``view`` x, b and c
    are column slices of one conv-output-like tensor, as ssm_forward
    passes them."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal(
        (B, L, H * P + 2 * G * N), np.float32) * 0.5).to(dtype)
    parts = (xbc[..., :H * P].reshape(B, L, H, P),
             xbc[..., H * P:H * P + G * N].reshape(B, L, G, N),
             xbc[..., H * P + G * N:].reshape(B, L, G, N))
    x, b, c = parts if view else (t.contiguous() for t in parts)
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((B, L, H), np.float32)))
    a = -torch.exp(torch.linspace(0.0, float(np.log(16.0)), H))
    d = torch.from_numpy(rng.standard_normal(H, np.float32))
    dy = torch.from_numpy(rng.standard_normal((B, L, H, P),
                                              np.float32)).to(dtype)
    return x, dt, a, b, c, d, dy


def _ssd_close(got, ref, dtype, grad=False):
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    if dtype == torch.bfloat16:
        tol = dict(rtol=2e-2, atol=2e-2 * max(1.0, np.abs(ref).max())
                   if grad else 2e-2)
    elif grad:
        tol = dict(rtol=0, atol=1e-3 * max(np.abs(ref).max(), 1e-30))
    else:
        tol = dict(rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,G,chunk,view", [
    (2, 300, 8, 1, 128, True),     # three chunks, ragged tail, 2 blocks of 4
    (1, 100, 4, 1, 128, True),     # one short chunk (Q = L = 100)
    (2, 257, 8, 2, 64, True),      # chunk 64, two groups
    (1, 2047, 4, 1, 128, False),   # sixteen chunks, one token short
    (1, 512, 112, 1, 128, True),   # zamba2-7b's 112 heads: 28 blocks of 4
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_n64_kernels_match_plain(cuda, dtype, B, L, H, G, chunk,
                                          view):
    """The forward (y and the chunk-start states) and the six gradients
    of ``ssd_scan`` at d_state 64 against the plain versions; one launch
    of each direction a call, wgmma in bf16 and tf32x3 in fp32."""
    x, dt, a, b, c, d, dy = _ssd_case(L + H, B, L, H, G, view, dtype)
    wgmma = dtype == torch.bfloat16
    assert tss._variant(dtype, N, P) == ("wgmma" if wgmma else "tf32x3")
    ref_y, ref_st = tss.ssd_scan_fwd(x, dt, a, b, c, d, chunk=chunk)
    ref_g = tss.ssd_scan_bwd(x, dt, a, b, c, d, ref_st, dy, chunk=chunk)
    n0 = (tss.ssd_scan.launches, tss.ssd_scan_bwd.launches,
          tss.ssd_scan.wgmma_launches, tss.ssd_scan_bwd.wgmma_launches,
          tss.ssd_scan.tf32x3_launches, tss.ssd_scan_bwd.tf32x3_launches)
    xc, dtc, ac, bc, cc, dc = (t.to(cuda).requires_grad_()
                               for t in (x, dt, a, b, c, d))
    y, st = tss.ssd_scan_fwd(xc.detach(), dtc.detach(), ac.detach(),
                             bc.detach(), cc.detach(), dc.detach(),
                             chunk=chunk)
    out = tss.ssd_scan(xc, dtc, ac, bc, cc, dc, chunk=chunk)
    out.backward(dy.to(cuda))
    torch.cuda.synchronize()
    n1 = (tss.ssd_scan.launches, tss.ssd_scan_bwd.launches,
          tss.ssd_scan.wgmma_launches, tss.ssd_scan_bwd.wgmma_launches,
          tss.ssd_scan.tf32x3_launches, tss.ssd_scan_bwd.tf32x3_launches)
    assert tuple(v - u for u, v in zip(n0, n1)) == (
        2, 1, 2 * wgmma, int(wgmma), 2 * (not wgmma), int(not wgmma))
    assert st.shape == (B, H, -(-L // min(chunk, L)), N, P)
    _ssd_close(y, ref_y, dtype)
    _ssd_close(out.detach(), ref_y, dtype)
    _ssd_close(st, ref_st, torch.float32, grad=True)
    for got, ref in zip((xc.grad, dtc.grad, ac.grad, bc.grad, cc.grad,
                         dc.grad), ref_g):
        _ssd_close(got, ref, dtype, grad=True)


@pytest.mark.cuda
def test_ssd_scan_n64_wgmma_matches_rounded_model(cuda):
    """The bf16 wgmma kernels at d_state 64 against ``_fwd_rounded`` /
    ``_bwd_rounded``, the plain model of their decomposition and bf16
    roundings, fed the kernel forward's states."""
    x, dt, a, b, c, d, dy = _ssd_case(5, 2, 384, 8, 1, True,
                                      torch.bfloat16)
    ins = [t.to(cuda) for t in (x, dt, a, b, c, d)]
    y, st = tss.ssd_scan_fwd(*ins, chunk=128)
    grads = tss.ssd_scan_bwd(*ins, st, dy.to(cuda), chunk=128)
    rnd_y, rnd_st = tss._fwd_rounded(*ins, 128)
    _ssd_close(y, rnd_y, torch.bfloat16)
    _ssd_close(st, rnd_st, torch.float32, grad=True)
    for got, ref in zip(grads, tss._bwd_rounded(*ins, st, dy.to(cuda), 128)):
        _ssd_close(got, ref, torch.bfloat16, grad=True)


# ------------------------------------------------------------ attention
def _attn_inputs(seed, B, H, S, dtype, device, d=D):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
            .to(device) for s in ((B, H, S, d), (B, H, S, d), (B, H, S, d),
                                  (B, H, S, d))]


def _close(got, ref, tol):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().float().cpu().numpy(),
                                   r.detach().float().cpu().numpy(), **tol)


def _counts():
    return (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches,
            tfa.flash_attention.wgmma_launches,
            tfa.flash_attention_bwd.wgmma_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [200, 130])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_d112_matches_plain(cuda, dtype, causal, S):
    """``flash_attention``'s autograd Function at (112, 1) against the
    plain versions on the same inputs: one forward and one backward
    launch a call, both wgmma ones in bf16, tf32x3 ones in fp32; bf16 also
    against ``_bwd_rounded``, the plain model of the wgmma backward's
    roundings."""
    q, k, v, do = _attn_inputs(S + 7, 2, 4, S, dtype, cuda)
    scale = D ** -0.5
    wgmma = dtype == torch.bfloat16
    qc, kc, vc = (t.detach().requires_grad_() for t in (q, k, v))
    n0 = _counts()
    out = tfa.flash_attention(qc, kc, vc, causal=causal)
    out.backward(do)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(n0, _counts())) == (
        1, 1, int(wgmma), int(wgmma))
    ref_o, ref_lse = tfa._fwd_plain(q, k, v, causal, scale)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    _close([lse], [ref_lse], FP32_TOL)
    _close([out, o], [ref_o, ref_o], BF16_TOL if wgmma else FP32_TOL)
    grads = (qc.grad, kc.grad, vc.grad)
    ref_g = tfa._bwd_plain(q, k, v, o, lse, do, causal, scale)
    _close(grads, ref_g, BF16_TOL if wgmma else FP32_BWD_TOL)
    if wgmma:
        _close(grads, tfa._bwd_rounded(q, k, v, o, lse, do, causal, scale),
               BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_n112_equals_n128_over_whole_atoms(cuda, causal):
    """The wgmma kernels at head dim 112, whose m64n112k16 products read
    the second swizzle atom in part, against the head dim 128 kernels
    (two whole atoms) on the same operands zero-padded to 128 columns
    and the same scale: o, the LSE and dQ, dK, dV equal in their 112
    columns, the padded columns of o and of the gradients zero."""
    B, H, S = 2, 4, 320
    q, k, v, do = _attn_inputs(11, B, H, S, torch.bfloat16, cuda)
    scale = D ** -0.5

    def pad(t):
        return torch.nn.functional.pad(t, (0, 128 - D)).contiguous()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    o2, lse2 = tfa.flash_attention_fwd(pad(q), pad(k), pad(v),
                                       causal=causal, scale=scale)
    g = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                scale=scale)
    g2 = tfa.flash_attention_bwd(pad(q), pad(k), pad(v), o2, lse2, pad(do),
                                 causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(lse, lse2)
    for a, b in zip((o,) + tuple(g), (o2,) + tuple(g2)):
        assert torch.equal(a, b[..., :D])
        assert not bool(b[..., D:].any())


@pytest.mark.cuda
def test_flash_attention_d112_wgmma_at_train_length(cuda):
    """The bf16 wgmma forward and backward over zamba2-7b's train length
    (S 2048, causal, 8 of its 32 heads): one wgmma launch each, against
    the plain versions."""
    q, k, v, do = _attn_inputs(2048, 1, 8, 2048, torch.bfloat16, cuda)
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


# ------------------------------------------------------------ train step
def _narrowed():
    """zamba2-7b's reduced config with its card pairs: the shared block
    at 4 / 4 heads of 112 and Mamba-2 at d_state 64, head dim 64 (the
    reduced config's own (16, 8) SSD shape is built for no kernel)."""
    return dataclasses.replace(
        tcfg.reduced(tcfg.get_config("zamba2-7b")), n_heads=4, n_kv_heads=4,
        d_head=D, ssm=tcfg.SSMConfig(d_state=N, head_dim=P, expand=2,
                                     n_groups=1, conv_kernel=4, chunk=128))


def _to(tree_, device):
    return unflatten(tree_, [t.to(device) for t in leaves(tree_)])


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_narrowed_hybrid_train_step_card_equals_cpu(cuda, remat):
    """The narrowed hybrid's loss and gradients (fp32: the tf32x3 SSD
    kernels in 3 Mamba-2 layers, the tf32x3 attention kernels in the
    shared block at 2 sites) and one
    train step on the card against the same on the CPU from one state
    (drawn on the CPU, copied to the card); with remat each forward
    kernel runs twice."""
    cfg = _narrowed()
    tc = tts.TrainConfig(use_kernel=True, remat=remat)
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
    n0 = (tss.ssd_scan.launches, tss.ssd_scan_bwd.launches,
          tfa.flash_attention.launches, tfa.flash_attention_bwd.launches,
          tss.ssd_scan.wgmma_launches, tfa.flash_attention.wgmma_launches)
    kl, kg = tts.build_grad_fn(cfg, tc)(cstate.params, cb)
    torch.cuda.synchronize()
    n1 = (tss.ssd_scan.launches, tss.ssd_scan_bwd.launches,
          tfa.flash_attention.launches, tfa.flash_attention_bwd.launches,
          tss.ssd_scan.wgmma_launches, tfa.flash_attention.wgmma_launches)
    fwd = 2 if remat else 1
    assert tuple(v - u for u, v in zip(n0, n1)) == (3 * fwd, 3, 2 * fwd, 2,
                                                    0, 0)
    pl, pg = tts.build_grad_fn(cfg, tc)(state.params, b)
    assert abs(float(kl) - float(pl)) <= 1e-5 * abs(float(pl))
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
        if a.numel():            # not the empty q_norm / k_norm leaves
            assert float((c.cpu() - a).abs().max()) <= 1e-3, name
