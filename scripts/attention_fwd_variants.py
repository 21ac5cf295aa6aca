"""Variants of the wgmma ``flash_attention`` forward at head dims 64, 80
and 112, built and timed against each other on one GPU.

    python3 scripts/attention_fwd_variants.py

Builds copies of ``csrc/flash_attention_sm90.cu`` into
``build/attention_fwd_variants/`` (git-ignored), each with two lines set
by text: the kernel's ``__launch_bounds__`` (one CTA an SM asked for, or
two at head dim 64, which caps a thread at 128 registers) and
``Shape::kN``, the N of the P V product at head dims 80 and 112 (the head
dim: the second swizzle atom of V read in part; or 128: two whole atoms,
48 or 16 columns of TMA's zero fill). Prints each build's registers and spills
for the (64, 7), (80, 1) and (112, 1) kernels and says which variant is the
source as it stands. Then runs every variant at ``chip_smoke.py``'s three rows
of these builds, internvl2-1b's (B 4, 14 / 2 heads of 64, S 2048, causal),
hubert-xlarge's (B 8, 16 / 16 heads of 80, S 1500, bidirectional) and
zamba2-7b's shared block (B 2, 32 / 32 heads of 112, S 2048, causal), bf16 from
seed 0: o against the plain version ``_fwd_plain`` at rtol / atol 2e-2 and the
LSE at rtol 1e-4 / atol 1e-3 (``chip_smoke.py``'s tolerances), o also against
``_fwd_rounded``; then times them in turns (each variant, then the same in
reverse order), 20 calls a turn by CUDA events with the L2 flushed before each.
Prints one JSON line with the card's name and power limit; exits 1 if a variant
is outside tolerance. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "attention_fwd_variants"
BOUNDS = re.compile(r"__launch_bounds__\(sm90::kThreads, [^)]*\)")
PV_N = re.compile(r"static constexpr int kN = [^;]*;")
# name: (min CTAs an SM in __launch_bounds__, Shape::kN); each differs
# from the first in one line
VARIANTS = {"one_cta_pv_at_d": ("1", "D"),
            "d64_two_ctas": ("D == 64 ? 2 : 1", "D"),
            "pv_n128": ("1", "kCols")}
# row: (B, H, Hkv, S, d, causal)
ROWS = {"flash_attention_vlm_2048": (4, 14, 2, 2048, 64, True),
        "flash_attention_audio_1500_noncausal": (8, 16, 16, 1500, 80, False),
        "flash_attention_train_d112": (2, 32, 32, 2048, 112, True)}


def _variant_source(src: str, ctas: str, n: str) -> str:
    assert len(BOUNDS.findall(src)) == 1 and len(PV_N.findall(src)) == 1
    src = BOUNDS.sub(f"__launch_bounds__(sm90::kThreads, {ctas})", src)
    return PV_N.sub(f"static constexpr int kN = {n};", src)


def _ptxas(log: str) -> dict:
    """Registers and spills of the (64, 7), (80, 1) and (112, 1)
    kernels."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"flash_attention_fwd_sm90_kernelILi(\d+)ELi(\d+)E",
                      line)
        if "Compiling entry" not in line or m is None \
                or m.group(1) not in ("64", "80", "112"):
            continue
        info = []
        for x in lines[i + 1:]:
            if "Compiling entry" in x:
                break
            if "Used" in x or "spill" in x:
                info.append(x.split(":", 1)[-1].strip())
        out[f"({m.group(1)}, {m.group(2)})"] = "; ".join(info)
    return out


def _build_all() -> dict:
    """Every variant's build at once: {name: (C function, ptxas, is the
    source as it stands)}."""
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    src = build.SOURCES["flash_attention_sm90"].read_text()
    procs = {}
    for name, (ctas, n) in VARIANTS.items():
        lib, cu = OUT / f"{name}.so", OUT / f"{name}.cu"
        text = _variant_source(src, ctas, n)
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(lib), str(cu)]
        procs[name] = (lib, text == src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (lib, current, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({name}):\n{log}")
        fn = ctypes.CDLL(str(lib)).pam_flash_attention_fwd_sm90
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        out[name] = (fn, _ptxas(log), current)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_fwd_variants: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_decode import _ptr, _stream
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _build_all()
    res = {name: dict(ptxas=p, source_as_it_stands=cur, rows={})
           for name, (_, p, cur) in libs.items()}
    ok = True
    for row, (B, H, Hkv, S, d, causal) in ROWS.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn((B, H, S, d), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((B, Hkv, S, d), generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        scale = d ** -0.5
        o = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")

        def call(name):
            rc = libs[name][0](_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse),
                               B, H, Hkv, S, S, d, int(causal), scale,
                               _stream(q.device))
            if rc != 0:
                raise RuntimeError(f"launch failed ({name}, code {rc})")

        ref_o, ref_lse = fa._fwd_plain(q, k, v, causal, scale)
        rnd_o, _ = fa._fwd_rounded(q, k, v, causal, scale)
        pairs, _ = cs._attn_work(q, k, causal)
        flops = 4 * d * pairs
        for name in VARIANTS:
            call(name)
            torch.cuda.synchronize()
            err_o, ok_o = cs._compare([o], [ref_o], cs.ATTN_BF16_TOL)
            err_l, ok_l = cs._compare([lse], [ref_lse])
            ok = ok and ok_o and ok_l
            res[name]["rows"][row] = dict(
                ok=ok_o and ok_l, max_abs_err_o=err_o, max_abs_err_lse=err_l,
                max_abs_err_vs_rounded=cs._compare([o], [rnd_o])[0], ms=[],
                flops=flops)
        del ref_o, ref_lse, rnd_o
        order = list(VARIANTS)
        for name in order + order[::-1]:
            res[name]["rows"][row]["ms"].append(
                cs._time_ms(lambda: call(name), iters=20))
        for name in order:
            r = res[name]["rows"][row]
            r["tflops"] = [flops / (t * 1e-3) / 1e12 for t in r["ms"]]
    print(json.dumps(dict(card=cs._card(), variants=res)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
