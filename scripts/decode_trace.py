"""Per-block timeline of the port's merged decode kernels on one GPU.

    python3 scripts/decode_trace.py

Builds a traced copy of ``csrc/flash_decode.cu`` and
``csrc/flash_decode_paged.cu`` into ``build/decode_trace/`` (git-ignored):
thread 0 of every CUDA block stamps ``clock64`` at the phase boundaries
of ``attend_run`` (``decode_common.cuh``), which the copy inserts by
text. It then runs the merged kernels at ``chip_smoke.py``'s kernels-phase
shapes (ring S 256, dense S 2048, the paged pool) with the L2 flushed
first ("cold") and right after an identical call ("warm"), and two
variants of the dense S 2048 kernel: the tile loop without its
arithmetic, and without it and the next tile's loads. It prints one JSON
line: per case, the p50 / p90 / max cycles of each phase over the
blocks. Phases: prologue (q and participation loads, compaction),
first_tile (the first tile's cp.async trip), tiles (the tile loop), push
(the run's partial into rank 0), arrive (the remote arrival), merge
(rank 0: waiting for the other runs, then the merge). Imports nothing of
JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAX_BLOCKS, SLOTS = 8192, 8

PROBE = ('{ if (threadIdx.x == 0) { int cta = blockIdx.x + gridDim.x * '
         '(blockIdx.y + gridDim.y * blockIdx.z); if (cta < %d) '
         'g_trace[cta * %d + (I)] = clock64(); } }\n' % (MAX_BLOCKS, SLOTS))
MARKS = (  # (text in decode_common.cuh, phase index, where)
    ("  int* list = reinterpret_cast<int*>(dyn);", 0, "before"),
    ("  // 2. staging: tile i of the list into stage i % 2", 1, "before"),
    ("    // a short tile spreads over the warps (latency); a longer one "
     "fills", 2, "first_tile"),
    ("  // the run's partial: merge the warps' partials in warp order", 3,
     "before"),
    ("  if constexpr (MERGED) {\n    mbar_arrive_rank0", 4, "before"),
    ("    if (run != 0) return;", 5, "before"))
END = "      out.o[(row0 + r) * D + e] = o;\n    }\n  }\n}\n"
PHASES = ("prologue", "first_tile", "tiles", "push", "arrive", "merge")
VARIANTS = {
    "no_arithmetic": [("    if (nw > 0) {      // warp-uniform",
                       "    if (nw < 0) {      // warp-uniform")],
    "no_arithmetic_no_prefetch": [
        ("    if (nw > 0) {      // warp-uniform",
         "    if (nw < 0) {      // warp-uniform"),
        ("    if (i + 2 < ntiles) issue(i + 2);", "")],
}
READ = ('\nextern "C" int pam_trace_read(void* dst, int n) {\n'
        '  return (int)cudaMemcpyFromSymbol(dst, pam::g_trace, '
        '(size_t)n * 8);\n}\n'
        'extern "C" int pam_trace_clear() {\n'
        '  void* p;\n'
        '  cudaGetSymbolAddress(&p, pam::g_trace);\n'
        '  return (int)cudaMemset(p, 0, sizeof(pam::g_trace));\n}\n')


def _traced_header(subs=()) -> str:
    from repro_torch.kernels import build
    h = (build.CSRC / "decode_common.cuh").read_text()
    h = h.replace("namespace pam {\n", "namespace pam {\n__device__ unsigned "
                  f"long long g_trace[{MAX_BLOCKS * SLOTS}];\n", 1)
    for text, i, where in MARKS:
        assert h.count(text) == 1, text
        probe = PROBE.replace("(I)", f"({i})")
        if where == "first_tile":
            probe = f"    if (i == 0) {probe.strip()}\n"
        h = h.replace(text, probe + text)
    assert h.count(END) == 1
    h = h.replace(END, END[:-6] + PROBE.replace("(I)", "(6)") + "  }\n}\n")
    for a, b in subs:
        assert h.count(a) == 1, a
        h = h.replace(a, b)
    return h


def _build(tag: str, name: str, subs=()):
    """Start nvcc on a traced copy of kernel library ``name``."""
    from repro_torch.kernels import build
    out = ROOT / "build" / "decode_trace" / tag
    out.mkdir(parents=True, exist_ok=True)
    (out / "decode_common.cuh").write_text(_traced_header(subs))
    (out / f"{name}.cu").write_text(
        (build.CSRC / f"{name}.cu").read_text() + READ)
    so = out / f"{name}.so"
    proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(out), "-o", str(so),
         str(out / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, so


def _timeline(lib, name: str, fn, blocks: int, cold: bool) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import build
    build._LIBS[name] = lib
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    if cold:
        scratch.zero_()               # flush the 50 MB L2
    else:
        fn()
    lib.pam_trace_clear()
    fn()
    torch.cuda.synchronize()
    buf = np.zeros(MAX_BLOCKS * SLOTS, np.uint64)
    lib.pam_trace_read(buf.ctypes.data_as(ctypes.c_void_p), buf.size)
    t = buf.reshape(MAX_BLOCKS, SLOTS)[:blocks].astype(np.int64)
    out = {}
    for i, phase in enumerate(PHASES):
        ok = (t[:, i] > 0) & (t[:, i + 1] > 0)
        if ok.any():
            d = t[ok, i + 1] - t[ok, i]
            out[phase] = [int(np.median(d)), int(np.percentile(d, 90)),
                          int(d.max())]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_trace: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    jobs = {(tag, name): _build(tag, name, subs)
            for tag, name, subs in (
                ("base", "flash_decode", ()),
                ("base", "flash_decode_paged", ()),
                *((t, "flash_decode", s) for t, s in VARIANTS.items()))}
    libs = {}
    for key, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(so))
    res = {"device": torch.cuda.get_device_name(0)}
    for S in (256, 2048):
        q, k, v, mask, lens = cs._dense_case(S, seed=S, dead_split=S > 512)
        blocks = -(-S // fd.split_len(8, 8, S, fd._sm_count(q.device))) * 64

        def call():
            return fd.flash_decode_merged(q, k, v, mask, kv_lens=lens,
                                          scores=True)
        for cold in (True, False):
            res[f"dense_{S}_{'cold' if cold else 'warm'}"] = _timeline(
                libs[("base", "flash_decode")], "flash_decode", call,
                blocks, cold)
        if S == 2048:
            for tag in VARIANTS:
                res[f"dense_2048_{tag}_cold"] = _timeline(
                    libs[(tag, "flash_decode")], "flash_decode", call,
                    blocks, True)
    qp, kp, vp, table, pmask, live = cs._paged_case()

    def paged():
        return fd.flash_decode_paged_merged(qp, kp, vp, table, pmask,
                                            block_live=live, scores=True)
    for cold in (True, False):
        res[f"paged_{'cold' if cold else 'warm'}"] = _timeline(
            libs[("base", "flash_decode_paged")], "flash_decode_paged",
            paged, 512, cold)
    build._LIBS.clear()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
