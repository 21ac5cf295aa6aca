"""``chip_smoke.py``'s serving profile phase on a given checkout's package,
for comparing two trees on one GPU in one call.

    python3 scripts/profile_tree.py TREE TAG

Runs ``phase_profile`` of this checkout's ``chip_smoke.py`` (four steady
paged + ring decode steps of full-width qwen3-0.6b at batch 8) with
``TREE/src`` first on ``sys.path``, building that tree's kernels into
``TREE/build/``, and prints one JSON line tagged ``TAG``: step time,
device busy and idle share, kernel launches a step by class, the decode
kernels' launches, the union-mass reconstruction's calls, the steps'
peak memory, the heaviest kernels. A tree whose decode wrappers predate
``flash_decode_merged`` is counted through its stacked wrappers. To
compare a parent commit, unpack it with ``git archive`` under the
git-ignored ``build/`` and run parent, change, change, parent, one
process each.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    tree, tag = os.path.abspath(argv[0]), argv[1]
    sys.path[:0] = [os.path.join(tree, "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("profile_tree: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    assert os.path.abspath(repro_torch.__file__).startswith(tree)
    if not hasattr(fd, "flash_decode_merged"):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ssd_scan as ss
        cs._counted = lambda: {
            "flash_decode": fd.flash_decode,
            "flash_decode_paged": fd.flash_decode_paged,
            "flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "ssd_scan": ss.ssd_scan, "ssd_scan_bwd": ss.ssd_scan_bwd}
        cs.DECODE_KERNELS = ("flash_decode", "flash_decode_paged")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    r = cs.phase_profile(*cs._model("bfloat16"))
    keep = ("step_ms", "device_busy_s", "device_idle_share",
            "kernel_launches", "launches_per_step", "kernel_classes",
            "decode_launches", "decode_kernels_on_device",
            "union_mass_calls", "peak_step_mem_gb",
            "host_sync_events", "graph_launches_per_step",
            "kernel_nodes_per_step")
    print(json.dumps({"tree": tag, "device": torch.cuda.get_device_name(0),
                      **{k: r.get(k) for k in keep},
                      "top": r.get("top", [])[:8]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
