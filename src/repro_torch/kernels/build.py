"""Build the port's CUDA kernels from the repo's sources at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into its own shared library, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  Libraries land in ``build/repro_torch_kernels/``
at the repo root, named by a hash of source and flags, so an unchanged
source is never rebuilt; :func:`build_all` starts one ``nvcc`` per source
at once and waits for all of them.

Nothing here runs at import time: this module is imported on machines that
have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: every kernel source of the port, by name (``csrc/<name>.cu``)
KERNELS = ("conv2d_rows", "swa_attention", "ssd_scan", "dwconv_wgrad",
           "dwconv2d")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (no CUDA toolkit): the port's "
                           "CUDA kernels cannot be built on this machine")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source started
    together.  Returns ``{name: {"path", "built", "ptxas"}}``; ``ptxas`` is
    the compiler's register/shared-memory report for a fresh build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, out = {}, {}
    for name in names:
        target = _target(name)
        out[name] = {"path": str(target), "built": False, "ptxas": ""}
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)  # atomic: concurrent builds agree
        out[name].update(built=True, ptxas=log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if it is missing."""
    return ctypes.CDLL(build_all((name,))[name]["path"])
