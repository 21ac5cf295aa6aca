"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. Builds happen at first use into ``build/kernels/`` at the
root of the checkout (git-ignored), keyed by a hash of the sources and
flags, so a fresh checkout builds once and later processes reuse the
libraries. ``build_all`` starts one ``nvcc`` per source at once and
waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "flash_decode": CSRC / "flash_decode.cu",
    "flash_decode_paged": CSRC / "flash_decode_paged.cu",
    "flash_attention": CSRC / "flash_attention.cu",
    "flash_attention_bwd": CSRC / "flash_attention_bwd.cu",
    "flash_attention_sm90": CSRC / "flash_attention_sm90.cu",
    "flash_attention_bwd_sm90": CSRC / "flash_attention_bwd_sm90.cu",
    "flash_attention_tf32x3": CSRC / "flash_attention_tf32x3.cu",
    "flash_attention_bwd_tf32x3": CSRC / "flash_attention_bwd_tf32x3.cu",
    "ssd_scan_sm90": CSRC / "ssd_scan_sm90.cu",
    "ssd_scan_bwd_sm90": CSRC / "ssd_scan_bwd_sm90.cu",
    "ssd_scan_tf32x3": CSRC / "ssd_scan_tf32x3.cu",
    "ssd_scan_bwd_tf32x3": CSRC / "ssd_scan_bwd_tf32x3.cu",
}
HEADERS = (CSRC / "decode_common.cuh", CSRC / "attention_common.cuh",
           CSRC / "attention_sm90.cuh", CSRC / "tf32_common.cuh",
           CSRC / "attention_tf32.cuh", CSRC / "ssd_sm90.cuh",
           CSRC / "ssd_tf32.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/kernels`` at the root of the checkout (``src/..``)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in (SOURCES[name],) + HEADERS:
        h.update(p.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every named kernel library that is not built yet, all
    ``nvcc`` processes at once. Returns seconds per library built (an
    empty dict when everything was already there); the ``-Xptxas -v``
    report of each build is kept beside its library as ``.log``."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    secs, errors = {}, []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        _target(n).with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n} (rc {proc.returncode}):\n"
                          f"{log}")
            continue
        os.replace(tmp, _target(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def build_log(name: str) -> str:
    """The compiler's report (registers, shared memory, spills) of the
    current build of ``name``, or '' if it was built by another run."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]
