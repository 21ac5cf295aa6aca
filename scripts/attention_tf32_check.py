"""The fp32 ``flash_attention`` kernels on the tensor cores (3xTF32, the
``tf32x3`` variant) at every built (head dim, group) pair, on one GPU.

    python3 scripts/attention_tf32_check.py

Builds ``flash_attention_tf32x3`` and ``flash_attention_bwd_tf32x3``
(``nvcc``, into the git-ignored ``build/kernels``) and prints each
kernel's registers and spills from the ``-Xptxas -v`` log and the HMMA
count of each library's SASS. Then, at every pair of ``BUILT`` (B 2, 2 kv
heads, S 150, causal and bidirectional, fp32 from a seeded generator,
TF32 off), one JSON line: the forward's and the backward's max abs error
against the plain versions (``_fwd_plain`` / ``_bwd_plain``, held to
chip_smoke's fp32 tolerances: rtol 1e-4 / atol 1e-3 forward, rtol / atol
1e-3 backward) and against the plain model of the split (``_fwd_tf32x3``
/ ``_bwd_tf32x3``), the launches counted, and whether two backward calls
give equal bits. Last, at the ``train_parity_*`` shapes (B 2, S 500) of
the eight train pairs, the forward's and the backward's device ms
(torch.profiler, 10 calls, L2 flushed; the backward also by kernel) beside
SDPA's forward and forward + backward − forward (CUDA events, 10 calls).
Ends with the card's name and power limit; exits 1 if a pair is outside
tolerance or not bit-equal. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

LIBS = ("flash_attention_tf32x3", "flash_attention_bwd_tf32x3")
FWD_TOL = dict(rtol=1e-4, atol=1e-3)
BWD_TOL = dict(rtol=1e-3, atol=1e-3)
# train_parity_* shapes: (H, Hkv, d, causal)
ROWS = {"(128, 2) qwen3-0.6b": (16, 8, 128, True),
        "(128, 16) qwen3-moe-235b-a22b": (64, 4, 128, True),
        "(128, 8) deepseek-67b": (64, 8, 128, True),
        "(112, 1) zamba2-7b": (32, 32, 112, True),
        "(128, 5) qwen3-14b": (40, 8, 128, True),
        "(64, 1) minicpm-2b": (36, 36, 64, True),
        "(80, 1) hubert-xlarge": (16, 16, 80, False),
        "(64, 7) internvl2-1b": (14, 2, 64, True)}


def _err(got, ref) -> float:
    return max(float((g.float() - r.float()).abs().max())
               for g, r in zip(got, ref))


def _ok(got, ref, tol) -> bool:
    import torch
    return all(bool(torch.allclose(g.float(), r.float(), **tol))
               for g, r in zip(got, ref))


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("attention_tf32_check: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"build_s": build.build_all(list(LIBS))}), flush=True)
    tool = Path(build._nvcc()).parent / "cuobjdump"
    for name in LIBS:
        lines = build.build_log(name).splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"(flash_attention_\w+?_kernel)I?L?i?(\d*)E?L?i?"
                          r"(\d*)", line)
            if "Compiling entry" not in line or m is None:
                continue
            info = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "Used" in x or "spill" in x]
            print(name, m.group(1), m.group(2), m.group(3), "|",
                  "; ".join(info))
        sass = subprocess.run([str(tool), "-sass", str(build._target(name))],
                              capture_output=True, text=True).stdout
        print(json.dumps({"library": name, "hmma": sass.count("HMMA")}))

    bad = []
    for d, rep in fa.BUILT:
        for causal in (True, False):
            H, Hkv, B, S = 2 * rep, 2, 2, 150
            g = torch.Generator(device="cuda").manual_seed(d + rep + S)
            q, k, v, do = (torch.randn(s, generator=g, device="cuda")
                           for s in ((B, H, S, d), (B, Hkv, S, d),
                                     (B, Hkv, S, d), (B, H, S, d)))
            scale = d ** -0.5
            n0 = (fa.flash_attention.tf32x3_launches,
                  fa.flash_attention_bwd.tf32x3_launches)
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            grads = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal)
            torch.cuda.synchronize()
            ref_f = fa._fwd_plain(q, k, v, causal, scale)
            ref_b = fa._bwd_plain(q, k, v, o, lse, do, causal, scale)
            rec = dict(
                d=d, rep=rep, causal=causal,
                tf32x3_launches=[fa.flash_attention.tf32x3_launches - n0[0],
                                 fa.flash_attention_bwd.tf32x3_launches
                                 - n0[1]],
                fwd_err=_err([o, lse], ref_f),
                fwd_err_model=_err([o, lse], fa._fwd_tf32x3(
                    q, k, v, causal, scale)),
                fwd_ok=_ok([o, lse], ref_f, FWD_TOL),
                bwd_err=_err(grads, ref_b),
                bwd_err_model=_err(grads, fa._bwd_tf32x3(
                    q, k, v, o, lse, do, causal, scale)),
                bwd_ok=_ok(grads, ref_b, BWD_TOL),
                bit_equal=all(bool(torch.equal(a, b))
                              for a, b in zip(grads, again)))
            print(json.dumps(rec), flush=True)
            if not (rec["fwd_ok"] and rec["bwd_ok"] and rec["bit_equal"]):
                bad.append((d, rep, causal))

    for name, (H, Hkv, d, causal) in ROWS.items():
        B, S = 2, 500
        g = torch.Generator(device="cuda").manual_seed(S + d + H)
        q, k, v, do = (torch.randn(s, generator=g, device="cuda")
                       for s in ((B, H, S, d), (B, Hkv, S, d),
                                 (B, Hkv, S, d), (B, H, S, d)))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)

        def bwd():
            fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

        def sdpa_fb():
            F.scaled_dot_product_attention(
                qr, kr, vr, is_causal=causal, enable_gqa=True).backward(do)
        with torch.no_grad():
            sdpa_fwd = cs._time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), iters=10)
        print(json.dumps(dict(
            row=name,
            fwd_device_ms=cs._device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=causal), iters=10),
            bwd_device_ms=cs._device_ms(bwd, iters=10),
            bwd_device_ms_by_kernel=cs._device_ms_by_kernel(bwd, iters=10),
            sdpa_fwd_ms=sdpa_fwd,
            sdpa_bwd_ms=cs._time_ms(sdpa_fb, iters=10) - sdpa_fwd)),
            flush=True)
    print(json.dumps({"card": cs._card(), "outside_tolerance": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
