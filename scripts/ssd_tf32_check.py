"""Device ms of the fp32 ``ssd_scan`` kernels (the ``tf32x3`` variant),
forward and backward, at the ``train_parity_*`` rows (B 2, L 500, chunk
128: (128, 64) at H 48, (64, 64) at H 112), on one GPU.

    python3 scripts/ssd_tf32_check.py [--against TREE]

torch.profiler, mean of 10 calls, L2 flushed, also by kernel. With
``--against TREE`` (another checkout, such as the parent commit unpacked
under ``build/``) the same rows of TREE's package are timed in turns,
TREE, this, this, TREE, each in a process of its own, so that two
versions are compared within one call. Ends with the card's name and
power limit. The kernels' correctness is ``chip_smoke.py``'s kernels
phase and ``tests/test_torch_ssd_scan_tf32x3_cuda.py``. Imports nothing
of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the train_parity_* rows: name -> (H, N)
ROWS = {"(128, 64) mamba2-780m": (48, 128), "(64, 64) zamba2-7b": (112, 64)}


def _time_rows() -> dict:
    """Device ms of both directions at the ROWS shapes, with the package
    on sys.path (this tree's, or --against's)."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan as ss
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, (H, N) in ROWS.items():
        ins, dy = cs._ssd_case(torch.float32, B=2, L=500, H=H, N=N)
        _, st = ss.ssd_scan_fwd(*ins, chunk=128)

        def fwd():
            ss.ssd_scan_fwd(*ins, chunk=128)

        def bwd():
            ss.ssd_scan_bwd(*ins, st, dy, chunk=128)
        per_f = cs._device_ms_by_kernel(fwd, iters=10)
        per_b = cs._device_ms_by_kernel(bwd, iters=10)
        out[name] = dict(variant=ss._variant(torch.float32, N, 64),
                         fwd_device_ms=sum(per_f.values()),
                         bwd_device_ms=sum(per_b.values()),
                         fwd_by_kernel=per_f, bwd_by_kernel=per_b)
    return out


def _time_tree(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    run = subprocess.run([sys.executable, __file__, "--time-only"],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    if run.returncode != 0:
        raise RuntimeError(f"timing {tree} failed:\n{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main() -> int:
    if "--time-only" in sys.argv:
        print(json.dumps(_time_rows()))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ssd_tf32_check: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    tree = None
    if "--against" in sys.argv:
        tree = Path(sys.argv[sys.argv.index("--against") + 1]).resolve()
    turns = ([("against", tree), ("this", ROOT), ("this", ROOT),
              ("against", tree)] if tree else [("this", ROOT)])
    for tag, where in turns:
        print(json.dumps({"timed": tag, "tree": str(where),
                          "rows": _time_tree(where)}), flush=True)
    print(json.dumps({"card": cs._card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
