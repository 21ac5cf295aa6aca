#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero without the
final ``ok`` line:

  env       torch / CUDA versions, the card and its power limit
  build     nvcc builds of the CUDA kernels (sm_90a), seconds taken;
            registers and spills of the main-path kernels from the
            ``-Xptxas -v`` logs; the four wgmma libraries (attention and
            SSD scan) must hold HGMMA instructions in their SASS
            (``cuobjdump -sass``) and their kernels must not spill
  kernels   each kernel against its plain PyTorch version on the card at
            main-path shapes (decode: B=8, H=16, Hkv=8, d=128, bf16
            storage, each kernel under the reference's stacked contract
            and merged with its scores, the serving path's; attention:
            the train shape in bf16 through the wgmma
            kernels, also S 1000 non-causal, and the CUDA-core kernels in
            fp32 at train_parity's B 2, S 500; ssd_scan: the wgmma kernels
            in bf16 at mamba2-780m's train shape B 4, L 2048, H 48, P 64,
            N 128, chunk 128, x / B / C as views of the conv output, and
            the CUDA-core kernels in fp32 at train_parity_ssm's B 2, L
            500), with its time, the plain version's time, the bound and,
            where one PyTorch call computes the same function, that call's
            time (for attention also SDPA's own error against the same
            plain versions; for both the kernel's TFLOP/s and its share of
            the bound; for the SSD scan the device time of each of its
            kernels, the FLOPs the wgmma kernels execute beside those the
            bound counts, each gradient's error, and the errors against
            ``_fwd_rounded`` / ``_bwd_rounded``, the plain model of the
            wgmma kernels' bf16 roundings)
  engine_paged_ring   full-width qwen3-0.6b (random weights, bf16) served
            in paged + hot-ring mode; each merged decode kernel must
            launch n_layers x decode steps times, the stacked ones never
  engine_paged_ring_full   the same with retrieval sparsity off, so
            every token past the ring is read through
            flash_decode_paged_merged
  engine_dense_pam    the same model in dense PAM mode
            (flash_decode_merged through masked_decode_attention)
  profile   torch.profiler over 4 steady paged + ring decode steps: device
            time by kernel, launches per step (matmul, gather / scatter
            and copy kernels apart), the device's idle share, the steps'
            peak memory, and the calls of the pool gather and grouped
            QK^T that the union mass no longer needs
  train     full-width qwen3-0.6b (random weights from seed 0, bf16)
            trained 10 steps on SyntheticLM batches of 4 x 2048 through
            the train CLI's step builder (attention through the
            flash_attention kernels, forward and backward); each of the
            two must launch n_layers x steps times, every launch a wgmma
            one, and the loss must fall
  profile_train   torch.profiler over 2 train steps: device time by
            kernel, the attention kernels' and the SSD kernels' shares,
            PyTorch's elementwise kernels' share (where gradient
            accumulation shows), the device's idle share
  train_parity    full-width qwen3-0.6b in fp32 (TF32 off), B 2, S 500:
            loss and gradients through the kernels (the CUDA-core
            variant: no wgmma launch) vs through the plain chunked
            attention
  parity    full-width qwen3-0.6b in fp32: teacher-forced decode steps
            through the engine's kernel-backed attention vs attention
            built from plain tensor code, logits compared
  train_ssm full-width mamba2-780m (48 layers, random weights from seed 0,
            bf16) trained 10 steps on SyntheticLM batches of 4 x 2048
            through the train CLI's step builder at peak lr 1e-3 (the SSD
            scan through the ssd_scan kernels, forward and backward); each
            must launch n_layers x steps times, every launch a wgmma one,
            and the loss must fall
  profile_train_ssm   torch.profiler over 2 of those train steps
  train_parity_ssm    full-width mamba2-780m in fp32 (TF32 off), B 2,
            S 500: loss and gradients through the ssd_scan kernels (the
            CUDA-core variant: no wgmma launch) vs through the plain
            chunked scan
  engine_ssm  the same model served by the PAM engine (dense cache, greedy,
            PAM on): 8 requests of 512-1024 prompt tokens, each prefilled
            at its exact length, 64 new tokens through the recurrent state
  profile_ssm torch.profiler over 4 steady decode steps of that engine

Tolerances (each kernel against its plain version on the same inputs):
  flash_decode, flash_decode_paged and their merged entry points (fp32
      partials and scores from bf16 K/V): rtol 1e-4, atol 1e-3 (summation
      order, and the kernels' exp, ex2.approx, within 2^-21 relative)
  flash_attention forward and backward, bf16 operands (wgmma kernels):
      rtol 2e-2, atol 2e-2 on the bf16 outputs (both sides compute in fp32
      and round the outputs to bf16, so they may differ by one bf16 step,
      2^-8 relative; the kernels also round P and dS to bf16 as
      tensor-core operands, whose effect tests/test_torch_flash_attention_
      sm90.py bounds on the CPU); the forward's fp32 log-sum-exp at rtol
      1e-4, atol 1e-3; fp32 operands (CUDA-core kernels): the forward at
      rtol 1e-4, atol 1e-3, the backward at rtol / atol 1e-3 (sums over
      up to S products in another order)
  ssd_scan forward and backward: bf16 operands at rtol / atol 2e-2 (one
      bf16 rounding of the outputs, and the wgmma kernels' bf16 operands,
      whose effect tests/test_torch_ssd_scan_sm90.py bounds on the CPU;
      the forward's fp32 states at the fp32 tolerance below); fp32 at
      rtol 1e-4, atol 1e-3 (the
      order of sums and of the in-chunk prefix sum of dt a, whose rounding
      moves each exp(s_t - s_u) by a few ulp of |s|); for gradients the
      atol is scaled by max(1, the leaf's largest entry)
  train_parity (both models): loss relative difference <= 1e-5, and per
      gradient leaf max |kernel - plain| / max |plain| <= 1e-3
  parity: max |dlogit| / max(1, max |logit|) <= 1e-3

Bounds: bytes over 3.35 TB/s (HBM3), and operations over 67 TFLOP/s
(fp32, CUDA cores) for the decode kernels and the fp32 attention rows,
or 989 TFLOP/s (bf16 dense tensor cores) for bf16 flash_attention and
ssd_scan, whose bf16 work a tensor-core kernel can do; NVIDIA's H100 SXM
data sheet.

Imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM bf16 dense tensor cores
KERNEL_TOL = dict(rtol=1e-4, atol=1e-3)
ATTN_BF16_TOL = dict(rtol=2e-2, atol=2e-2)
ATTN_FP32_BWD_TOL = dict(rtol=1e-3, atol=1e-3)
PARITY_TOL = 1e-3                # max |dlogit| / max(1, max |logit|)
TRAIN_LOSS_TOL = 1e-5            # relative loss difference
TRAIN_GRAD_TOL = 1e-3            # per leaf: max |diff| / max |plain|
TRAIN_STEPS, TRAIN_B, TRAIN_S = 10, 4, 2048
PARITY_B, PARITY_S = 2, 500      # the fp32 train_parity batch
SSM_ARCH = "mamba2-780m"
SSM_LR = 1e-3                    # peak lr of the mamba2-780m train phase
SSD_FP32_TOL = dict(rtol=1e-4, atol=1e-3)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


# ---------------------------------------------------------------- timing
def _time_ms(fn, iters: int = 20, flush_bytes: int = 64 << 20) -> float:
    """Mean ms per call on the card: CUDA events around each call, the
    50 MB L2 flushed before each (the engine's 28 layers never find
    their KV in L2)."""
    import torch
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _device_ms_by_kernel(fn, iters: int = 20,
                         flush_bytes: int = 64 << 20) -> dict:
    """Mean device time (ms) per call of each of the port's own CUDA
    kernels (symbols in namespace ``pam``) launched by ``fn``, by kernel
    name, from torch.profiler; L2 flushed before each call as in
    ``_time_ms``. The wrapper's argument preparation is not counted."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            scratch.zero_()
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.key_averages():
        if "pam::" in ev.key:
            m = re.search(r"pam::(?:\w+::)*(\w+)", ev.key)
            name = m.group(1) if m else ev.key[:60]
            out[name] = (out.get(name, 0.0)
                         + ev.self_device_time_total / iters / 1e3)
    return out


def _device_ms(fn, iters: int = 20, flush_bytes: int = 64 << 20) -> float:
    """Mean device time (ms) per call of the port's own CUDA kernels
    launched by ``fn`` (the sum of ``_device_ms_by_kernel``)."""
    return sum(_device_ms_by_kernel(fn, iters, flush_bytes).values())


def _bound_ms(nbytes: float, flops: float,
              peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def _compare(got, ref, tol=KERNEL_TOL) -> tuple[float, bool]:
    import torch
    err, ok = 0.0, True
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        err = max(err, float((g - r).abs().max()))
        ok = ok and bool(torch.allclose(g, r, **tol))
    return err, ok


# ---------------------------------------------------------------- phases
def phase_env() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return dict(torch=torch.__version__, cuda=torch.version.cuda,
                python=sys.version.split()[0],
                device=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(),
                nvidia_smi=smi[0] if smi else "")


SM90_LIBS = ("flash_attention_sm90", "flash_attention_bwd_sm90",
             "ssd_scan_sm90", "ssd_scan_bwd_sm90")
SSD_WGMMA_KERNELS = {"ssd90_chunk_state_kernel<true>", "ssd90_out_kernel",
                     "ssd90_chunk_state_kernel<false>", "ssd90_bwd_t_kernel",
                     "ssd90_bwd_u_kernel"}


def _sass_count(name: str, op: str = "HGMMA") -> int:
    """Occurrences of ``op`` in the SASS of kernel library ``name``
    (``cuobjdump -sass``)."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(build._target(name))],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        raise RuntimeError(f"cuobjdump failed for {name}: {sass.stderr}")
    return sass.stdout.count(op)


def phase_build() -> dict:
    """Builds every kernel library, then reads each main-path kernel's
    registers and spills from its ``-Xptxas -v`` log and checks that the
    wgmma libraries' SASS holds tensor-core instructions (``HGMMA``) and
    that their kernels do not spill."""
    import re
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    per = build.build_all()
    regs = {}      # bf16: head dim 128 / group 2, and the SSD kernels
    for name in build.SOURCES:
        lines = build.build_log(name).splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and (
                    ("bfloat16" in line and "Li128E" in line
                     and "Li1E" not in line)
                    or ("sm90" in line and "Li2E" in line)
                    or "ssd90" in line):
                kern = re.search(
                    r"\d+((?:flash_|ssd90_)[a-z0-9_]*?_kernel)", line)
                key = kern.group(1) if kern else name
                if "ssd90" in key and ("Lb1E" in line or "Lb0E" in line):
                    key += "<true>" if "Lb1E" in line else "<false>"
                info = []
                for x in lines[i + 1:]:
                    if "Compiling entry" in x:
                        break
                    if "Used" in x or "spill" in x:
                        info.append(x.split(":", 1)[-1].strip())
                regs[key] = "; ".join(info)
    hgmma = {name: _sass_count(name) for name in SM90_LIBS}
    assert all(n > 0 for n in hgmma.values()), f"no HGMMA in {hgmma}"
    spills = {k: v for k, v in regs.items() if ("sm90" in k or "ssd90" in k)
              and re.search(r"[1-9]\d* bytes spill (stores|loads)", v)}
    assert not spills, f"wgmma kernels spill: {spills}"
    assert sum("sm90" in k for k in regs) == 3, sorted(regs)
    assert SSD_WGMMA_KERNELS <= set(regs), sorted(regs)
    return dict(build_s=time.perf_counter() - t0, per_library=per,
                libraries=sorted(build.SOURCES), registers=regs,
                hgmma_in_sass=hgmma)


def _dense_case(S, seed, dead_split):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, Hkv, d = 8, 16, 8, 128
    q = torch.randn((B, H, d), generator=g, device="cuda")
    k = torch.randn((B, Hkv, S, d), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, Hkv, S, d), generator=g, device="cuda").bfloat16()
    mask = torch.rand((B, S), generator=g, device="cuda") < 0.5
    if dead_split:
        mask[0, 512:1024] = False                 # one split of row 0
    lens = torch.randint(S // 4, S + 1, (B,), generator=g, device="cuda")
    lens[-1] = 0                                  # an all-dead row
    return q, k, v, mask, lens


def _sdpa_ms(q, k, v, mask, lens) -> float:
    """One PyTorch call computing the same attention (the yardstick
    ``library_ms``; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    S = k.shape[2]
    qq = q.bfloat16()[:, :, None]
    am = (mask & (torch.arange(S, device="cuda")[None] < lens[:, None]))
    am = am[:, None, None, :]
    return _time_ms(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=am, enable_gqa=True))


def _decode_row(name, call, plain, nbytes, flops, **case) -> dict:
    """One decode kernel row: the wrapper ``call`` against its plain
    version on the same inputs, times, and the bound of ``nbytes`` /
    ``flops``."""
    import torch
    got = call()
    ref = plain()
    torch.cuda.synchronize()
    err, ok = _compare(got, ref)
    del got, ref
    bound, by = _bound_ms(nbytes, flops)
    dev = _device_ms(call)
    return dict(case, name=name, ok=ok, max_abs_err=err, tol=KERNEL_TOL,
                ms=_time_ms(call), kernel_device_ms=dev,
                pct_of_bound=100.0 * bound / dev, plain_ms=_time_ms(plain),
                bound_ms=bound, bound_by=by, bytes=nbytes)


def kernel_flash_decode(S: int, merged: bool = False) -> dict:
    """The dense kernel at B 8, H 16, Hkv 8, d 128, bf16 K/V: stacked over
    the reference's 512-token splits, or merged (``flash_decode_merged``:
    the split from ``split_len``, the merge in the kernel, and the
    scores, whose (B, H, S) fp32 write the bound counts)."""
    from repro_torch.kernels import flash_decode as fd
    q, k, v, mask, lens = _dense_case(S, seed=S, dead_split=S > 512)
    B, H, d = q.shape
    Hkv = k.shape[1]
    scale = 1.0 / d ** 0.5
    live = fd._dense_live(mask, S, lens, B, S, q.device)
    block_s = min(fd.DEFAULT_BLOCK_S, max(S, 8))
    n_live = int(live.sum())
    nbytes = n_live * Hkv * d * 2 * 2 + q.numel() * 4 + mask.numel() + B * 4
    if merged:
        split = fd.split_len(B, Hkv, S, fd._sm_count(q.device))
        nbytes += B * H * (d + 2) * 4 + B * H * S * 4     # o, m, l, scores
        row = _decode_row(
            "flash_decode_merged",
            lambda: fd.flash_decode_merged(q, k, v, mask, kv_lens=lens,
                                           scores=True),
            lambda: fd._merged_plain(*fd._flash_decode_plain(
                q, k, v, live, scale, block_s)),
            nbytes, n_live * H * d * 4, S=S, split=split,
            nsplit=-(-S // split), grid_blocks=-(-S // split) * Hkv * B)
    else:
        nsplit = -(-S // block_s)
        nbytes += B * H * nsplit * (d + 2) * 4
        row = _decode_row(
            "flash_decode",
            lambda: fd.flash_decode(q, k, v, mask, kv_lens=lens),
            lambda: fd._flash_decode_plain(q, k, v, live, scale,
                                           block_s)[:3],
            nbytes, n_live * H * d * 4, S=S, nsplit=nsplit,
            grid_blocks=nsplit * Hkv * B)
    return dict(row, live_tokens=n_live,
                library_ms=_sdpa_ms(q, k, v, mask, lens))


def _paged_case():
    """The paged kernels' inputs: B 8, H 16, Hkv 8, d 128, bs 16, nb 128 (a
    2048-token window), bf16 pools of 1,024 blocks, a quarter of the first
    100 table entries live, 60 % of their tokens participating."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(7)
    B, H, Hkv, d, bs, nb, NB = 8, 16, 8, 128, 16, 128, 1024
    q = torch.randn((B, H, d), generator=g, device="cuda")
    kp = torch.randn((NB + 1, bs, Hkv, d), generator=g,
                     device="cuda").bfloat16()
    vp = torch.randn((NB + 1, bs, Hkv, d), generator=g,
                     device="cuda").bfloat16()
    table = torch.randperm(NB, generator=g, device="cuda")[:B * nb]
    table = table.reshape(B, nb).to(torch.int32)
    table[:, 100:] = NB                          # unmapped -> sentinel
    live_blk = torch.rand((B, nb), generator=g, device="cuda") < 0.25
    live_blk[:, 100:] = False
    mask = (torch.rand((B, nb * bs), generator=g, device="cuda") < 0.6)
    mask = mask & live_blk.repeat_interleave(bs, 1)
    return q, kp, vp, table, mask, live_blk


def kernel_flash_decode_paged(merged: bool = False) -> dict:
    """The paged kernel on ``_paged_case``'s inputs: stacked (one partial
    per logical block, the reference's contract) or
    merged (``flash_decode_paged_merged``: runs from ``split_len``, the
    merge in the kernel, and the scores). No single PyTorch call computes
    paged attention, so ``library_ms`` is null."""
    from repro_torch.kernels import flash_decode as fd
    q, kp, vp, table, mask, live_blk = _paged_case()
    B, H, d = q.shape
    bs, Hkv = kp.shape[1], kp.shape[2]
    nb = table.shape[1]
    scale = 1.0 / d ** 0.5
    n_live = int(mask.sum())
    nbytes = (n_live * Hkv * d * 2 * 2 + q.numel() * 4 + mask.numel()
              + table.numel() * 4 + live_blk.numel())
    case = dict(live_tokens=n_live, live_blocks=int(live_blk.sum()),
                library_ms=None)
    if merged:
        split = fd.split_len(B, Hkv, nb * bs, fd._sm_count(q.device),
                             block=bs)
        nbytes += B * H * (d + 2) * 4 + B * H * nb * bs * 4
        return _decode_row(
            "flash_decode_paged_merged",
            lambda: fd.flash_decode_paged_merged(
                q, kp, vp, table, mask, block_live=live_blk, scores=True),
            lambda: fd._merged_plain(*fd._flash_decode_paged_plain(
                q, kp, vp, table, live_blk, mask, None, scale)),
            nbytes, n_live * H * d * 4, split=split,
            runs=-(-nb // (split // bs)),
            grid_blocks=-(-nb // (split // bs)) * Hkv * B, **case)
    nbytes += B * H * nb * (d + 2) * 4           # the stacked partials
    return _decode_row(
        "flash_decode_paged",
        lambda: fd.flash_decode_paged(q, kp, vp, table, mask,
                                      block_live=live_blk),
        lambda: fd._flash_decode_paged_plain(q, kp, vp, table, live_blk,
                                             mask, None, scale)[:3],
        nbytes, n_live * H * d * 4, grid_blocks=nb * Hkv * B, **case)


def _attn_case(S: int, causal: bool, seed: int, B: int = TRAIN_B,
               dtype: str = "bfloat16"):
    """q, k, v, dO at the training path's heads (H 16, Hkv 8, d 128),
    batch ``B`` and sequence ``S``, in ``dtype``."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, Hkv, d = 16, 8, 128
    return [torch.randn(shape, generator=g, device="cuda").to(
                getattr(torch, dtype))
            for shape in ((B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d),
                          (B, H, S, d))]


def _attn_work(q, k, causal: bool) -> tuple[int, int]:
    """(live (query, key) pairs over all heads, head dim): a causal row
    attends qpos + 1 keys."""
    B, H, S, d = q.shape
    Sk = k.shape[2]
    pairs = S * (S + 1) // 2 if causal else S * Sk
    return B * H * pairs, d


def kernel_flash_attention(S: int, causal: bool, B: int = TRAIN_B,
                           dtype: str = "bfloat16") -> dict:
    """Forward and backward kernels against their plain versions on the
    same inputs (the backward fed the kernel forward's o and lse), with
    their times, bounds and the SDPA yardstick, whose own error against
    the same plain versions is reported beside the kernels'. bf16 runs
    the wgmma kernels (also held to ``_fwd_rounded`` / ``_bwd_rounded``,
    the plain model of their bf16 roundings), fp32 the CUDA-core ones."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _attn_case(S, causal, seed=S, B=B, dtype=dtype)
    scale = 1.0 / q.shape[-1] ** 0.5
    variant = fa._variant(q.dtype, q.shape[-1])
    bf16 = q.dtype == torch.bfloat16
    fwd_tol = ATTN_BF16_TOL if bf16 else KERNEL_TOL
    bwd_tol = ATTN_BF16_TOL if bf16 else ATTN_FP32_BWD_TOL
    n0 = (fa.flash_attention.wgmma_launches,
          fa.flash_attention_bwd.wgmma_launches)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ref_o, ref_lse = fa._fwd_plain(q, k, v, causal, scale)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    ref_g = fa._bwd_plain(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    ran = (fa.flash_attention.wgmma_launches - n0[0],
           fa.flash_attention_bwd.wgmma_launches - n0[1])
    assert ran == ((1, 1) if variant == "wgmma" else (0, 0)), (variant, ran)
    err_o, ok_o = _compare([o], [ref_o], fwd_tol)
    err_l, ok_l = _compare([lse], [ref_lse])
    err_g, ok_g = _compare(grads, ref_g, bwd_tol)
    extra_f, extra_b = {}, {}
    if bf16:
        rnd_o, _ = fa._fwd_rounded(q, k, v, causal, scale)
        extra_f["max_abs_err_vs_rounded"] = _compare([o], [rnd_o])[0]
        del rnd_o
        rnd_g = fa._bwd_rounded(q, k, v, o, lse, do, causal, scale)
        extra_b["max_abs_err_vs_rounded"] = _compare(grads, rnd_g)[0]
        del rnd_g
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal,
                                              enable_gqa=True)

    def sdpa_fb():
        sdpa().backward(do)

    so = sdpa()
    sg = torch.autograd.grad(so, (qr, kr, vr), do)
    sdpa_err_o = _compare([so.detach()], [ref_o])[0]
    sdpa_err_g = _compare(sg, ref_g)[0]
    del ref_o, ref_lse, ref_g, so, sg
    pairs, d = _attn_work(q, k, causal)
    el = q.element_size()
    peak = BF16_FLOPS if bf16 else FP32_FLOPS
    fwd_bytes = (q.numel() * 2 + k.numel() * 2) * el + lse.numel() * 4
    bwd_bytes = ((q.numel() * 3 + k.numel() * 2) * el + lse.numel() * 4
                 + (q.numel() + k.numel() * 2) * el)
    fwd_flops, bwd_flops = 4 * d * pairs, 10 * d * pairs
    fwd_bound, fwd_by = _bound_ms(fwd_bytes, fwd_flops, peak)
    bwd_bound, bwd_by = _bound_ms(bwd_bytes, bwd_flops, peak)
    with torch.no_grad():
        sdpa_fwd_ms = _time_ms(sdpa, iters=10)
    sdpa_fb_ms = _time_ms(sdpa_fb, iters=10)
    case = dict(S=S, causal=causal, B=q.shape[0], H=q.shape[1],
                Hkv=k.shape[1], d=d, dtype=dtype, variant=variant,
                live_pairs=pairs)

    def timed(fn, flops, bound):
        dev = _device_ms(fn, iters=10)
        return dict(ms=_time_ms(fn, iters=10), kernel_device_ms=dev,
                    tflops=flops / (dev * 1e-3) / 1e12,
                    pct_of_bound=100.0 * bound / dev)
    fwd = dict(case, name="flash_attention", ok=ok_o and ok_l,
               max_abs_err=max(err_o, err_l), max_abs_err_o=err_o,
               max_abs_err_lse=err_l, tol=fwd_tol,
               sdpa_max_abs_err=sdpa_err_o, **extra_f,
               **timed(lambda: fa.flash_attention_fwd(
                   q, k, v, causal=causal), fwd_flops, fwd_bound),
               plain_ms=_time_ms(lambda: fa._fwd_plain(q, k, v, causal,
                                                       scale), iters=5),
               bound_ms=fwd_bound, bound_by=fwd_by, bytes=fwd_bytes,
               flops=fwd_flops, library_ms=sdpa_fwd_ms)
    bwd = dict(case, name="flash_attention_bwd", ok=ok_g,
               max_abs_err=err_g, tol=bwd_tol, sdpa_max_abs_err=sdpa_err_g,
               **extra_b,
               **timed(lambda: fa.flash_attention_bwd(
                   q, k, v, o, lse, do, causal=causal), bwd_flops,
                   bwd_bound),
               plain_ms=_time_ms(lambda: fa._bwd_plain(
                   q, k, v, o, lse, do, causal, scale), iters=5),
               bound_ms=bwd_bound, bound_by=bwd_by, bytes=bwd_bytes,
               flops=bwd_flops,
               library_ms=max(sdpa_fb_ms - sdpa_fwd_ms, 0.0))
    return dict(fwd=fwd, bwd=bwd)


def _ssd_case(dtype, seed: int = 0, B: int = TRAIN_B, L: int = TRAIN_S):
    """ssd_scan operands at mamba2-780m's head shape (H 48, G 1, N 128, P
    64), batch ``B`` and length ``L``: x, B and C as column views of one
    conv-output-like (B, L, 3328) tensor, as ssm_forward passes them; dt =
    softplus(N(0, 1)), the model's initial decay rates a = -linspace(1,
    16) and D = 1; and an output gradient."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, G, N, P = 48, 1, 128, 64
    xbc = (torch.randn((B, L, H * P + 2 * G * N), generator=g,
                       device="cuda") * 0.5).to(dtype)
    x = xbc[..., :H * P].reshape(B, L, H, P)
    b = xbc[..., H * P:H * P + G * N].reshape(B, L, G, N)
    c = xbc[..., H * P + G * N:].reshape(B, L, G, N)
    dt = F.softplus(torch.randn((B, L, H), generator=g, device="cuda"))
    a = -torch.linspace(1.0, 16.0, H, device="cuda")
    d = torch.ones(H, device="cuda")
    dy = torch.randn((B, L, H, P), generator=g, device="cuda").to(dtype)
    return (x, dt, a, b, c, d), dy


def _ssd_work(x, b, chunk: int) -> tuple[int, int]:
    """FLOPs of the SSD scan forward and backward as the TPU kernel's
    function needs them (the yardstick of the bound): per (batch, head,
    chunk) the forward's 2Q^2N + 2Q^2P + 4QNP (C B^T, the masked product
    with x, C h_in, the state update) and the backward's 6Q^2N + 4Q^2P +
    10QNP (C B^T and g x^T again, dx, dC and dB inside the chunk; C^T g,
    B dh, C h_in, g h_in^T, x dh^T)."""
    B, L, H, P = x.shape
    N = b.shape[3]
    Q = min(chunk, max(L, 8))
    n = B * H * -(-L // Q)
    return (n * (2 * Q * Q * N + 2 * Q * Q * P + 4 * Q * N * P),
            n * (6 * Q * Q * N + 4 * Q * Q * P + 10 * Q * N * P))


def _ssd_executed(x, b, chunk: int, hb: int) -> tuple[int, int]:
    """FLOPs the wgmma kernels execute (tiles of 128 rows): C B^T once per
    block of ``hb`` heads; per head the forward's B^T (w x), C h_in and M x
    twice each (hi / lo bf16 pairs), and the backward's C^T (exp(s) g), C
    h_in, g h_in^T, g x^T, Pb B (t-side), x g^T, Pb^T C, B dh, the dx
    product and (w x) dh^T (u-side), with C B^T on each side."""
    B, L, H, P = x.shape
    N = b.shape[3]
    Q = 128
    n = B * H * -(-L // min(chunk, max(L, 8)))
    qnp, qqp, qqn = Q * N * P, Q * Q * P, Q * Q * N
    return (n * (2 * qqn // hb + 4 * qnp + 4 * qnp + 4 * qqp),
            n * (4 * qqn // hb + 10 * qnp + 6 * qqp + 4 * qqn))


def _grad_compare(got, ref, tol) -> tuple[float, bool]:
    """Each gradient leaf at rtol, and atol scaled by max(1, its largest
    entry)."""
    import torch
    err, ok = 0.0, True
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        scale = max(1.0, float(r.abs().max()))
        err = max(err, float((g - r).abs().max()))
        ok = ok and bool(torch.allclose(g, r, rtol=tol["rtol"],
                                        atol=tol["atol"] * scale))
    return err, ok


SSD_GRADS = ("dx", "ddt", "da", "db", "dc", "dd")


def _ssd_variant(dtype, B: int, L: int, chunk: int) -> dict:
    """One variant of the ssd_scan kernels against the plain versions (and,
    for bf16, the plain model of the wgmma kernels' roundings) on the same
    inputs, the backward fed the kernel forward's chunk-start states; the
    wgmma launch counts of the calls; times, the per-kernel device time of
    each pass, and the bounds."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    bf16 = dtype == torch.bfloat16
    tol = ATTN_BF16_TOL if bf16 else SSD_FP32_TOL
    ins, dy = _ssd_case(dtype, B=B, L=L)
    x, dt, a, b, c, d = ins
    variant = ss._variant(x.dtype, b.shape[3], x.shape[3])
    n0 = (ss.ssd_scan.wgmma_launches, ss.ssd_scan_bwd.wgmma_launches)
    y, st = ss.ssd_scan_fwd(*ins, chunk=chunk)
    grads = ss.ssd_scan_bwd(*ins, st, dy, chunk=chunk)
    torch.cuda.synchronize()
    ran = (ss.ssd_scan.wgmma_launches - n0[0],
           ss.ssd_scan_bwd.wgmma_launches - n0[1])
    assert ran == ((1, 1) if variant == "wgmma" else (0, 0)), (variant, ran)
    ref_y, ref_st, _ = ss.ssd_chunked_states(*ins, chunk)
    err_y, ok_y = _compare([y], [ref_y], tol)
    err_s, ok_s = _grad_compare([st], [ref_st], SSD_FP32_TOL)
    del ref_y, ref_st
    ref_g = ss._bwd_plain(*ins, st, dy, chunk)
    err_g, ok_g = _grad_compare(grads, ref_g, tol)
    per_leaf = {n: _grad_compare([g], [r], tol)[0]
                for n, g, r in zip(SSD_GRADS, grads, ref_g)}
    del ref_g
    out = dict(variant=variant, dtype=str(dtype).split(".")[-1], B=B, L=L,
               ok_fwd=ok_y and ok_s, ok_bwd=ok_g, max_abs_err_y=err_y,
               max_abs_err_states=err_s, max_abs_err_grads=err_g,
               max_abs_err_per_grad=per_leaf, tol=tol)
    if bf16:
        rnd_y, rnd_st = ss._fwd_rounded(*ins, chunk)
        out["max_abs_err_y_vs_rounded"] = _compare([y], [rnd_y])[0]
        out["max_abs_err_states_vs_rounded"] = _compare([st], [rnd_st])[0]
        del rnd_y, rnd_st
        rnd_g = ss._bwd_rounded(*ins, st, dy, chunk)
        out["max_abs_err_per_grad_vs_rounded"] = {
            n: _compare([g], [r])[0]
            for n, g, r in zip(SSD_GRADS, grads, rnd_g)}
        del rnd_g
    del grads

    def fwd():
        return ss.ssd_scan_fwd(*ins, chunk=chunk)

    def bwd():
        return ss.ssd_scan_bwd(*ins, st, dy, chunk=chunk)
    el = x.element_size()
    fwd_flops, bwd_flops = _ssd_work(x, b, chunk)
    io = (x.numel() * el + dt.numel() * 4 + 2 * b.numel() * el
          + 2 * a.numel() * 4)                   # x, dt, b, c, a, D
    # The forward's bound is y's own work: the chunk-start states it also
    # writes are the port's choice (the backward could recompute them) and
    # are reported apart. The backward's counts the states it reads; not
    # reading them would add their recompute (2QNP a chunk) and leave it
    # bound by operations all the same.
    fwd_bytes = io + x.numel() * el                          # + y
    state_bytes = st.numel() * 4
    bwd_bytes = (io + state_bytes + dy.numel() * el         # + states, dy
                 + io)                           # the six gradients
    peak = BF16_FLOPS if bf16 else FP32_FLOPS
    fwd_bound, fwd_by = _bound_ms(fwd_bytes, fwd_flops, peak)
    bwd_bound, bwd_by = _bound_ms(bwd_bytes, bwd_flops, peak)
    if variant == "wgmma":
        ex = _ssd_executed(x, b, chunk, ss._head_block(x.shape[2]
                                                       // b.shape[2]))
    else:
        ex = (fwd_flops, bwd_flops)
    for tag, fn, flops, exe, bound, by, nbytes in (
            ("fwd", fwd, fwd_flops, ex[0], fwd_bound, fwd_by, fwd_bytes),
            ("bwd", bwd, bwd_flops, ex[1], bwd_bound, bwd_by, bwd_bytes)):
        per = _device_ms_by_kernel(fn, iters=10)
        dev = sum(per.values())
        out[tag] = dict(ms=_time_ms(fn, iters=10), kernel_device_ms=dev,
                        per_launch_ms=per, flops=flops, executed_flops=exe,
                        tflops=flops / (dev * 1e-3) / 1e12,
                        executed_tflops=exe / (dev * 1e-3) / 1e12,
                        pct_of_bound=100.0 * bound / dev, bound_ms=bound,
                        bound_by=by, bytes=nbytes)
    out["fwd"]["state_bytes"] = state_bytes
    out["fwd"]["state_write_bound_ms"] = state_bytes / HBM_BYTES_PER_S * 1e3
    out["fwd"]["plain_ms"] = _time_ms(
        lambda: ss.ssd_chunked_states(*ins, chunk), iters=3)
    out["bwd"]["plain_ms"] = _time_ms(
        lambda: ss._bwd_plain(*ins, st, dy, chunk), iters=3)
    return out


def kernel_ssd_scan() -> dict:
    """Both variants of the ssd_scan kernels at their main paths' shapes:
    wgmma in bf16 at the train shape (train_ssm), CUDA cores in fp32 at
    train_parity_ssm's B 2, L 500; one row for each kernel."""
    import torch
    chunk = 128
    rows = {}
    for key, dtype, B, L in (("", torch.bfloat16, TRAIN_B, TRAIN_S),
                             ("_fp32_500", torch.float32, PARITY_B,
                              PARITY_S)):
        r = _ssd_variant(dtype, B, L, chunk)
        case = dict(B=B, L=L, H=48, P=64, G=1, N=128, chunk=chunk,
                    dtype=r["dtype"], variant=r["variant"],
                    x_bc="views of a (B, L, 3328) tensor")
        common = {k: r[k] for k in r if k.startswith("max_abs_err_per")}
        rows["ssd_scan" + key] = dict(
            case, name="ssd_scan", ok=r["ok_fwd"],
            max_abs_err=r["max_abs_err_y"],
            max_abs_err_states=r["max_abs_err_states"], tol=r["tol"],
            library_ms=None, **r["fwd"],
            **{k: r[k] for k in ("max_abs_err_y_vs_rounded",
                                 "max_abs_err_states_vs_rounded") if k in r})
        rows["ssd_scan_bwd" + key] = dict(
            case, name="ssd_scan_bwd", ok=r["ok_bwd"],
            max_abs_err=r["max_abs_err_grads"], tol=r["tol"],
            library_ms=None, **r["bwd"], **common)
        torch.cuda.empty_cache()
    return rows


def _model(dtype: str, arch: str = "qwen3-0.6b"):
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import get_config
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    return cfg, tf.init_params(cfg, 0, device="cuda")


def _pam(max_len: int, **kw):
    from repro_torch.serving import PAMManagerConfig
    return PAMManagerConfig(max_tokens=max_len, hot_capacity=256,
                            warm_capacity=768, compression=8,
                            recency_window=32, schedule_interval=4, **kw)


def _engine(cfg, params, n_req: int, new: int, pam_kw=None, **scfg_kw):
    """An engine with ``n_req`` requests of 512-1024 prompt tokens (seeded
    numpy draws) submitted."""
    import numpy as np
    from repro_torch.serving import Request, ServingConfig, ServingEngine
    scfg = ServingConfig(pam=_pam(scfg_kw["max_len"], **(pam_kw or {})),
                         **scfg_kw)
    eng = ServingEngine(cfg, params, scfg, device="cuda")
    rng = np.random.default_rng(0)
    for i in range(n_req):
        plen = int(rng.integers(512, 1025))
        eng.submit(Request(i, rng.integers(0, cfg.vocab, plen), new))
    return eng


def run_engine(cfg, params, *, n_req: int, new: int, pam_kw=None,
               **scfg_kw) -> dict:
    import torch
    eng = _engine(cfg, params, n_req, new, pam_kw, **scfg_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()                       # counts of this run only
    summ = eng.run()
    launches = _launches()
    lens = [len(eng.requests[i].outputs) for i in range(n_req)]
    assert lens == [new] * n_req, f"outputs per request {lens}"
    return dict(summary=summ, launches=launches,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)


DECODE_KERNELS = ("flash_decode_merged", "flash_decode_paged_merged",
                  "flash_decode", "flash_decode_paged")


def _assert_decode_launches(launches: dict, want: dict) -> None:
    """Each decode entry point launched as often as ``want`` says (the
    merged ones n_layers x decode steps, the stacked ones never)."""
    for name in DECODE_KERNELS:
        n, w = launches[name], want.get(name, 0)
        assert n == w, f"{name}: {n} launches, want {w}"


def phase_engine_paged(cfg, params) -> dict:
    r = run_engine(cfg, params, n_req=8, new=64, max_batch=8,
                   max_len=2048, block_size=16, hot_window=256)
    steps = r["summary"]["decode_device_steps"]
    want = cfg.n_layers * steps
    _assert_decode_launches(r["launches"], dict.fromkeys(DECODE_KERNELS[:2],
                                                         want))
    return _engine_line(r, want)


def phase_engine_paged_full(cfg, params) -> dict:
    """Paged + ring with retrieval sparsity off: every token outside the
    256-slot ring is read from the pool, so ``flash_decode_paged`` walks
    live blocks on every step (with sparsity on, the working set stays
    inside the ring and the pool partial is all identity)."""
    r = run_engine(cfg, params, n_req=8, new=16, max_batch=8,
                   max_len=2048, block_size=16, hot_window=256,
                   pam_kw=dict(use_sparsity=False))
    s = r["summary"]
    want = cfg.n_layers * s["decode_device_steps"]
    _assert_decode_launches(r["launches"], dict.fromkeys(DECODE_KERNELS[:2],
                                                         want))
    assert s["blocks_touched_per_step"] > 0, s
    assert s["tier_reads"][1] + s["tier_reads"][2] > 0, s["tier_reads"]
    return _engine_line(r, want)


PAGED_RING = dict(block_size=16, hot_window=256)
HOST_SYNCS = ("aten::_local_scalar_dense", "cudaStreamSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpyAsync")


# kernel-name classes of the profile phase: the union-mass reconstruction
# of PR 11-16 showed as pool gathers, copies and grouped-score products
KERNEL_CLASSES = {"matmul": ("gemm", "gemv", "cutlass", "cublas"),
                  "gather_scatter": ("index", "gather", "scatter"),
                  "copy": ("copy", "Copy")}


def _count_calls(module, name: str, counts: dict):
    """Wrap ``module.name`` to count its calls in ``counts``; returns the
    original, for restoring."""
    orig = getattr(module, name)

    def counted(*a, **kw):
        counts[name] += 1
        return orig(*a, **kw)
    counts[name] = 0
    setattr(module, name, counted)
    return orig


def phase_profile(cfg, params, layout=PAGED_RING) -> dict:
    """Where a decode step's time goes: torch.profiler over 4 steady
    decode steps of an engine at batch 8 (the paged + ring main path, or
    ``layout={}`` for the dense cache): device time by kernel name, kernel
    launches per step by class (matmul, gather / scatter, copy), the
    device's busy share of the window's wall time, the peak device memory
    the steps allocate above what the engine holds, the decode kernels'
    launches, the calls of the union-mass reconstruction's pool gather
    (``paged_gather_logical``) and grouped QK^T (``ops._grouped_scores``),
    and the host events that wait on the device or copy (readbacks)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import pam_interface
    from repro_torch.kernels import ops
    eng = _engine(cfg, params, 8, 16, max_batch=8, max_len=2048, **layout)
    for _ in range(3):                       # admission + warm decode
        eng.step()
    torch.cuda.synchronize()
    calls: dict = {}
    saved = [(m, n, _count_calls(m, n, calls)) for m, n in (
        (pam_interface, "paged_gather_logical"), (ops, "_grouped_scores"))]
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for m, n, orig in saved:
            setattr(m, n, orig)
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 2**30
    launches = {k: v for k, v in _launches().items() if k in DECODE_KERNELS}
    rows = []                   # device-side events only (kernels, copies)
    syncs = {}
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            rows.append((ev.self_device_time_total, ev.key, ev.count))
        elif ev.key in HOST_SYNCS:
            syncs[ev.key] = ev.count
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    if not rows:
        return dict(steps=4, wall_s=wall, device_time="not measured")
    classes = {}
    for cls, keys in KERNEL_CLASSES.items():
        sel = [r for r in rows if any(k in r[1] for k in keys)]
        classes[cls] = dict(launches_per_step=sum(r[2] for r in sel) / 4,
                            device_ms_per_step=sum(r[0] for r in sel) / 4e3)
    return dict(steps=4, wall_s=wall, step_ms=wall / 4 * 1e3,
                host_sync_events=syncs,
                device_busy_s=busy_s, device_idle_share=1 - busy_s / wall,
                kernel_launches=sum(r[2] for r in rows),
                launches_per_step=sum(r[2] for r in rows) / 4,
                kernel_classes=classes, decode_launches=launches,
                union_mass_calls=calls, peak_step_mem_gb=peak_gb,
                top=[dict(name=k[:80], device_ms=us / 1e3, count=n,
                          us_per_launch=us / max(n, 1))
                     for us, k, n in rows[:12]],
                ported=[dict(name=k[:80], device_ms=us / 1e3, count=n,
                             us_per_launch=us / max(n, 1))
                        for us, k, n in rows if "pam::" in k])


def phase_engine_dense(cfg, params) -> dict:
    r = run_engine(cfg, params, n_req=4, new=32, max_batch=4,
                   max_len=2048)
    steps = r["summary"]["decode_device_steps"]
    want = cfg.n_layers * steps
    _assert_decode_launches(r["launches"], {"flash_decode_merged": want})
    return _engine_line(r, want)


def phase_engine_ssm(cfg, params) -> dict:
    """mamba2-780m served greedily with PAM on (dense cache: the reference
    refuses paged pools for SSM): 8 requests of 512-1024 prompt tokens,
    each prefilled at its exact length, 64 new tokens each through the
    recurrent state. Serving runs the plain chunked scan (prefill) and the
    one-token recurrence, as the reference does, so no kernel launches."""
    r = run_engine(cfg, params, n_req=8, new=64, max_batch=8, max_len=2048)
    s = r["summary"]
    assert s["finished"] == 8 and s["total_tokens"] == 8 * 64, s
    assert s["prefill_dispatches"] == 8, s   # eight exact lengths
    assert not any(r["launches"].values()), r["launches"]
    di, H = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.n_heads(cfg.d_model)
    state_bytes = (cfg.n_layers * 8 * H * cfg.ssm.d_state
                   * cfg.ssm.head_dim * 4)
    return dict(_engine_line(r, 0), arch=cfg.name,
                prefill_dispatches=s["prefill_dispatches"],
                recurrent_state_bytes=state_bytes, d_inner=di)


def _engine_line(r: dict, want: int) -> dict:
    s = r["summary"]
    keep = ("finished", "total_tokens", "steps", "decode_device_steps",
            "decode_time_s", "decode_tok_s", "wall_time_s",
            "p50_tpot_s", "p99_tpot_s", "tier_reads", "moved_tokens",
            "blocks_touched_per_step", "blocks_window_per_step",
            "pool_occupancy_peak", "hot_bytes_per_slot")
    return dict({k: s[k] for k in keep if k in s}, launches=r["launches"],
                launches_expected=want, peak_mem_gb=r["peak_mem_gb"])


def _plain_paged_attn(hot_m, pgd_m, table, scale):
    """Decode attention of the paged + ring layout from plain tensor code
    (the reference's non-kernel formulation): grouped scores over the
    ring and over the pool's logical gather, merged exactly."""
    import torch
    from repro_torch.core import online_softmax as osm
    from repro_torch.core.pam_interface import paged_gather_logical
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import (ring_gather_mask,
                                                  ring_position_map)

    def d_fn(q, kc, vc, pk, pv, kv_lens):
        smax = hot_m.shape[1]
        live = torch.arange(smax, device=q.device)[None] < kv_lens[:, None]
        ring_pos, valid = ring_position_map(kv_lens, kc.shape[2])
        hot_ring = ring_gather_mask(hot_m & live, ring_pos, valid)
        part_h = ops._grouped_partial_from_scores(
            ops._grouped_scores(q, kc, scale), vc, hot_ring)
        part_p = ops._grouped_partial_from_scores(
            ops._grouped_scores(q, paged_gather_logical(pk, table), scale),
            paged_gather_logical(pv, table), pgd_m & live)
        out = osm.finalize(osm.merge_partials(part_h, part_p), q.dtype)
        return out, torch.zeros(q.shape[0], smax, device=q.device)

    return d_fn


def phase_parity() -> dict:
    import numpy as np
    import torch
    from repro_torch.core.tiers import clamp_hot_to_window
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (Request, ServingConfig, ServingEngine,
                                     pam_manager as pm)
    cfg, params = _model("float32")
    W, bs, smax = 256, 16, 1024
    # retrieval sparsity off: every token past the ring is a pool read,
    # so both partials of the merge carry work
    eng = ServingEngine(cfg, params, ServingConfig(
        max_batch=2, max_len=smax, block_size=bs, hot_window=W,
        pam=_pam(smax, use_sparsity=False)), device="cuda")
    rng = np.random.default_rng(1)
    for i, plen in enumerate((700, 333)):
        eng.submit(Request(i, rng.integers(0, cfg.vocab, plen), 16))
    eng.step()                             # admission + one decode step
    cache, st = eng.cache, eng.pam_state
    tokens = eng.tokens_dev.clone()
    scale = 1.0 / cfg.head_dim ** 0.5
    worst = 0.0
    for _ in range(3):                     # teacher-forced steps
        lengths = cache.lengths + 1
        part = pm.participation_mask(eng.pam_cfg, st.importance, lengths)
        tier = clamp_hot_to_window(st.tier, lengths, W)
        hot_m, pgd_m, live = pm.paged_participation_split(
            part, tier, lengths, bs, W)
        assert bool(live.any()), "no pool block read"
        table = torch.where(live, st.block_table,
                            torch.full_like(st.block_table, eng.sentinel))
        pos = cache.lengths
        dst = st.block_table[torch.arange(2, device="cuda"),
                             (pos // bs).long()]
        append = (dst.to(torch.int32), (pos % bs).to(torch.int32))
        outs = []
        for d_fn in (pm.make_paged_decode_attn(hot_m, pgd_m, table, live),
                     _plain_paged_attn(hot_m, pgd_m, table, scale)):
            c = tf.DecodeCache(*(t.clone() for t in cache))
            logits, c2, _ = tf.decode_step(cfg, params, tokens, c,
                                           decode_attn_fn=d_fn,
                                           paged_append=append)
            outs.append((logits, c2))
        (lk, ck), (lp, _) = outs
        assert lk.shape == (2, cfg.vocab) and bool(torch.isfinite(lk).all())
        rel = float((lk - lp).abs().max()) / max(1.0, float(lp.abs().max()))
        worst = max(worst, rel)
        assert rel <= PARITY_TOL, f"logits differ: {rel}"
        tokens = torch.argmax(lk, dim=-1).to(torch.int32)
        cache = ck
    return dict(steps=3, max_rel_logit_diff=worst, tol=PARITY_TOL,
                dtype="float32", tf32=False)


def _counted():
    """Every kernel wrapper that counts its launches, by name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd_scan as ss
    return {"flash_decode_merged": fd.flash_decode_merged,
            "flash_decode_paged_merged": fd.flash_decode_paged_merged,
            "flash_decode": fd.flash_decode,
            "flash_decode_paged": fd.flash_decode_paged,
            "flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "ssd_scan": ss.ssd_scan, "ssd_scan_bwd": ss.ssd_scan_bwd}


def _reset_launches() -> None:
    for fn in _counted().values():
        fn.launches = 0
    for fn in _wgmma_counted().values():
        fn.wgmma_launches = 0


def _launches() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


def _wgmma_counted():
    """The wrappers that also count their wgmma launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "ssd_scan": ss.ssd_scan, "ssd_scan_bwd": ss.ssd_scan_bwd}


def _wgmma_launches() -> dict:
    return {name: fn.wgmma_launches for name, fn in _wgmma_counted().items()}


# the kernels each train path must launch n_layers times a step
TRAIN_KERNELS = {"qwen3-0.6b": ("flash_attention", "flash_attention_bwd"),
                 SSM_ARCH: ("ssd_scan", "ssd_scan_bwd")}


def _train_model(arch: str = "qwen3-0.6b"):
    from repro_torch.launch import train as train_cli
    from repro_torch.models.config import get_config
    cfg = get_config(arch)
    if arch == SSM_ARCH:
        return cfg, train_cli.train_config(steps=TRAIN_STEPS, lr=SSM_LR)
    return cfg, train_cli.train_config(steps=TRAIN_STEPS)


def phase_train(arch: str = "qwen3-0.6b") -> dict:
    """A training main path: ``repro_torch.launch.train.run`` (the CLI's
    loop) at full width, bf16, batch 4 x 2048, 10 steps."""
    import math
    import statistics
    import torch
    from repro_torch.launch import train as train_cli
    cfg, tcfg = _train_model(arch)
    assert tcfg.use_kernel and not tcfg.remat
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    out = train_cli.run(cfg, tcfg, steps=TRAIN_STEPS, batch=TRAIN_B,
                        seq=TRAIN_S, device="cuda", log=lambda _: None)
    launches = _launches()
    wgmma = _wgmma_launches()
    losses = out["losses"]
    want = cfg.n_layers * TRAIN_STEPS
    assert all(math.isfinite(x) for x in losses), losses
    assert sum(losses[-3:]) / 3 < losses[0], losses
    for name, n in launches.items():
        expect = want if name in TRAIN_KERNELS[arch] else 0
        assert n == expect, f"{name}: {launches}, want {expect}"
    for name, n in wgmma.items():      # bf16 at full width: all wgmma
        expect = want if name in TRAIN_KERNELS[arch] else 0
        assert n == expect, f"{name}: wgmma {wgmma}, want {expect}"
    steady = out["step_s"][1:]
    step_ms = statistics.median(steady) * 1e3
    return dict(arch=arch, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                dtype=cfg.dtype, peak_lr=tcfg.adamw.lr(
                    torch.tensor(10, device="cuda")).item(),
                losses=losses, grad_norms=out["grad_norms"],
                first_step_ms=out["step_s"][0] * 1e3, step_ms=step_ms,
                tokens_per_s=TRAIN_B * TRAIN_S / (step_ms / 1e3),
                tokens_per_s_all_steps=out["tokens_per_s"],
                launches=launches, wgmma_launches=wgmma,
                launches_expected=want,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)


def phase_profile_train(arch: str = "qwen3-0.6b") -> dict:
    """Where a train step's time goes: torch.profiler over 2 steady steps
    of the train phase's configuration (after one warm step). The
    ``attention_*`` keys sum the flash_attention kernels, the ``ssd_*``
    keys the ssd_scan kernels and the ``elementwise_*`` keys PyTorch's
    elementwise kernels; ``*_device_ms`` and ``elementwise_launches`` are
    totals over the two steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.training.train_step import (build_train_step,
                                                 init_train_state)
    cfg, tcfg = _train_model(arch)
    state = init_train_state(cfg, tcfg, 0, device="cuda")
    step_fn = build_train_step(cfg, tcfg)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_S, batch=TRAIN_B)
    dev = torch.device("cuda")
    state, m = step_fn(state, train_cli.device_batch(ds, 0, 1, dev))
    float(m["loss"])
    batches = [train_cli.device_batch(ds, s, 1, dev) for s in (1, 2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, m = step_fn(state, b)
            float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del state
    rows = []
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    if not rows:
        return dict(steps=2, wall_s=wall, device_time="not measured")
    busy_s = sum(r[0] for r in rows) / 1e6

    def fmt(sel):
        return [dict(name=k[:80], device_ms=us / 1e3, count=n,
                     share=us / 1e6 / busy_s) for us, k, n in sel]
    attn = [r for r in rows if "pam::flash_attention" in r[1]]
    ssd = [r for r in rows if "pam::ssd" in r[1]]
    # PyTorch's elementwise kernels (fills, adds, casts, AdamW's
    # arithmetic): where gradient accumulation into the stacked leaves
    # would show
    elem = [r for r in rows if "elementwise_kernel" in r[1]]
    return dict(steps=2, wall_s=wall, step_ms=wall / 2 * 1e3,
                device_busy_s=busy_s, device_idle_share=1 - busy_s / wall,
                kernel_launches=sum(r[2] for r in rows),
                attention_device_ms=sum(r[0] for r in attn) / 1e3,
                attention_share=sum(r[0] for r in attn) / 1e6 / busy_s,
                ssd_device_ms=sum(r[0] for r in ssd) / 1e3,
                ssd_share=sum(r[0] for r in ssd) / 1e6 / busy_s,
                elementwise_device_ms=sum(r[0] for r in elem) / 1e3,
                elementwise_share=sum(r[0] for r in elem) / 1e6 / busy_s,
                elementwise_launches=sum(r[2] for r in elem),
                top=fmt(rows[:12]),
                ported=fmt([r for r in rows if "pam::" in r[1]]))


def phase_train_parity(arch: str = "qwen3-0.6b") -> dict:
    """Full-width fp32 loss and gradients through the train path's kernels
    (flash_attention, or ssd_scan) against the plain chunked attention or
    chunked scan (TF32 off)."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch import tree
    from repro_torch.launch import train as train_cli
    from repro_torch.training.train_step import TrainConfig, build_grad_fn
    cfg, params = _model("float32", arch)
    b = train_cli.device_batch(
        SyntheticLM(vocab=cfg.vocab, seq_len=PARITY_S, batch=PARITY_B,
                    seed=1), 0, 1,
        torch.device("cuda"))
    _reset_launches()
    lk, gk = build_grad_fn(cfg, TrainConfig(use_kernel=True))(params, b)
    launches = _launches()
    wgmma = _wgmma_launches()          # fp32: the CUDA-core kernels
    assert not any(wgmma.values()), f"fp32 ran wgmma kernels: {wgmma}"
    lp, gp = build_grad_fn(cfg, TrainConfig(use_kernel=False))(params, b)
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    worst, worst_leaf = 0.0, ""
    for (name, a), r in zip(tree.leaves_with_paths(gk), tree.leaves(gp)):
        scale = float(r.abs().max())
        rel = float((a - r).abs().max()) / scale if scale > 0 else 0.0
        if rel > worst:
            worst, worst_leaf = rel, name
    for name, n in launches.items():
        expect = cfg.n_layers if name in TRAIN_KERNELS[arch] else 0
        assert n == expect, f"{name}: {launches}, want {expect}"
    assert loss_rel <= TRAIN_LOSS_TOL, f"loss differs: {loss_rel}"
    assert worst <= TRAIN_GRAD_TOL, f"grads differ: {worst} at {worst_leaf}"
    return dict(arch=arch, B=PARITY_B, S=PARITY_S, dtype="float32",
                tf32=False,
                loss_kernel=float(lk), loss_plain=float(lp),
                loss_rel_diff=loss_rel, loss_tol=TRAIN_LOSS_TOL,
                max_grad_rel_diff=worst, worst_leaf=worst_leaf,
                grad_tol=TRAIN_GRAD_TOL, launches=launches,
                wgmma_launches=wgmma)


def phase_kernels() -> dict:
    out = dict(flash_decode_ring=kernel_flash_decode(256),
               flash_decode_2048=kernel_flash_decode(2048),
               flash_decode_paged=kernel_flash_decode_paged(),
               flash_decode_merged_ring=kernel_flash_decode(256, True),
               flash_decode_merged_2048=kernel_flash_decode(2048, True),
               flash_decode_paged_merged=kernel_flash_decode_paged(True))
    for S, causal in ((TRAIN_S, True), (1000, False)):
        r = kernel_flash_attention(S, causal)
        tag = "2048" if causal else "ragged_1000_noncausal"
        out[f"flash_attention_{tag}"] = r["fwd"]
        out[f"flash_attention_bwd_{tag}"] = r["bwd"]
    # the CUDA-core variant at its main path's shape (train_parity: fp32,
    # B 2, S 500, causal)
    r = kernel_flash_attention(PARITY_S, True, B=PARITY_B, dtype="float32")
    out["flash_attention_fp32_500"] = r["fwd"]
    out["flash_attention_bwd_fp32_500"] = r["bwd"]
    out.update(kernel_ssd_scan())
    return out


# the stacked (reference-contract) rows of the kernels phase, by the
# merged row that launches the same CUDA kernel on the serving path
STACKED_ROWS = {"flash_decode_merged_ring": "flash_decode_ring",
                "flash_decode_merged_2048": "flash_decode_2048",
                "flash_decode_paged_merged": "flash_decode_paged"}


# ------------------------------------------------------------------ main
def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    failed: list[str] = []
    results: dict = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        try:
            res = fn(*args)
            results[name] = res
            emit(name, ok=True, seconds=time.perf_counter() - t0, **res)
            return res
        except Exception as exc:           # report the phase, go on
            failed.append(name)
            emit(name, ok=False, error=repr(exc),
                 trace=traceback.format_exc()[-2000:])
            return None

    env = run("env", phase_env)
    run("build", phase_build)
    kernels = run("kernels", phase_kernels)
    if kernels is not None:
        bad = [k for k, v in kernels.items() if not v["ok"]]
        if bad:
            failed.append("kernels")
            emit("kernels", ok=False, error=f"outside tolerance: {bad}")
    model = None
    try:
        model = _model("bfloat16")
    except Exception as exc:
        failed.append("model")
        emit("model", ok=False, error=repr(exc))
    if model is not None:
        run("engine_paged_ring", phase_engine_paged, *model)
        run("engine_paged_ring_full", phase_engine_paged_full, *model)
        run("engine_dense_pam", phase_engine_dense, *model)
        run("profile", phase_profile, *model)
        del model
    torch.cuda.empty_cache()
    run("train", phase_train)
    torch.cuda.empty_cache()
    run("profile_train", phase_profile_train)
    torch.cuda.empty_cache()
    run("train_parity", phase_train_parity)
    torch.cuda.empty_cache()
    run("parity", phase_parity)
    torch.cuda.empty_cache()
    run("train_ssm", phase_train, SSM_ARCH)
    torch.cuda.empty_cache()
    run("profile_train_ssm", phase_profile_train, SSM_ARCH)
    torch.cuda.empty_cache()
    run("train_parity_ssm", phase_train_parity, SSM_ARCH)
    torch.cuda.empty_cache()
    ssm = None
    try:
        ssm = _model("bfloat16", SSM_ARCH)
    except Exception as exc:
        failed.append("model_ssm")
        emit("model_ssm", ok=False, error=repr(exc))
    if ssm is not None:
        run("engine_ssm", phase_engine_ssm, *ssm)
        run("profile_ssm", phase_profile, *ssm, {})
        del ssm

    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    paged_run = results["engine_paged_ring"]["launches"]
    dense_run = results["engine_dense_pam"]["launches"]
    train_run = results["train"]["launches"]
    fp32_run = results["train_parity"]["launches"]
    ssm_run = results["train_ssm"]["launches"]
    ssm_fp32_run = results["train_parity_ssm"]["launches"]
    rows = []
    for key, src, replaces, launches in (
            ("flash_decode_merged_ring", "flash_decode.cu",
             "flash_decode.py:98", paged_run["flash_decode_merged"]),
            ("flash_decode_merged_2048", "flash_decode.cu",
             "flash_decode.py:98", dense_run["flash_decode_merged"]),
            ("flash_decode_paged_merged", "flash_decode_paged.cu",
             "flash_decode.py:202", paged_run["flash_decode_paged_merged"]),
            ("flash_attention_2048", "flash_attention_sm90.cu",
             "flash_attention.py:31", train_run["flash_attention"]),
            ("flash_attention_bwd_2048", "flash_attention_bwd_sm90.cu",
             "flash_attention.py:31", train_run["flash_attention_bwd"]),
            ("flash_attention_fp32_500", "flash_attention.cu",
             "flash_attention.py:31", fp32_run["flash_attention"]),
            ("flash_attention_bwd_fp32_500", "flash_attention_bwd.cu",
             "flash_attention.py:31", fp32_run["flash_attention_bwd"]),
            ("ssd_scan", "ssd_scan_sm90.cu", "ssd_scan.py:36",
             ssm_run["ssd_scan"]),
            ("ssd_scan_bwd", "ssd_scan_bwd_sm90.cu", "ssd_scan.py:36",
             ssm_run["ssd_scan_bwd"]),
            ("ssd_scan_fp32_500", "ssd_scan.cu", "ssd_scan.py:36",
             ssm_fp32_run["ssd_scan"]),
            ("ssd_scan_bwd_fp32_500", "ssd_scan_bwd.cu", "ssd_scan.py:36",
             ssm_fp32_run["ssd_scan_bwd"])):
        k = kernels[key]
        rows.append(dict(
            name=k["name"], route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/{replaces}",
            launches=launches, max_abs_err=k["max_abs_err"],
            ms=k["ms"], kernel_device_ms=k["kernel_device_ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"]))
        for extra in ("S", "split", "variant", "dtype", "tflops",
                      "pct_of_bound", "executed_tflops", "sdpa_max_abs_err"):
            if extra in k:
                rows[-1][extra] = k[extra]
        stacked = STACKED_ROWS.get(key)
        if stacked:             # the same CUDA kernel, reference contract
            rows[-1]["stacked"] = {
                f: kernels[stacked][f] for f in (
                    "max_abs_err", "ms", "kernel_device_ms", "bound_ms",
                    "pct_of_bound")}
    rows[1]["launches_in"] = "engine_dense_pam"
    for row in rows:
        if row["name"].endswith("_bwd"):
            row["note"] = (f"gradient of {row['name'][:-4]}; the TPU "
                           f"package has no backward kernel (JAX cannot "
                           f"differentiate the Pallas call)")
    print(env["nvidia_smi"])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
