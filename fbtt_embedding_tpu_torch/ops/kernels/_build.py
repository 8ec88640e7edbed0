"""Build the package's CUDA kernels on first use and load them.

Every ``csrc/*.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into its
own shared library with a plain C interface, loaded with ``ctypes``. The
sources build in parallel, one ``nvcc`` process each, into
``build/fbtt_torch_kernels/<hash>/`` beside the package, keyed by a hash of
the sources and flags, so a changed source never loads a stale library.

There is no fallback: a missing ``nvcc`` or a failed compile raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "fbtt_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of fbtt_embedding_tpu_torch cannot be built")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no library yet, all at once;
    returns ``{stem: library path}``. The compiler's ``-Xptxas -v`` report
    is kept beside each library as ``<stem>.log``."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: (src, out_dir / f"lib{src.stem}.so")
            for src in sorted(CSRC.glob("*.cu"))}
    todo = {stem: v for stem, v in libs.items() if not v[1].exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for stem, (src, lib) in todo.items():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            procs[stem] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, lib)
        failed = []
        for stem, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            lib.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"--- {stem} (exit {proc.returncode}) ---\n{log}")
            else:
                os.replace(tmp, lib)  # atomic against concurrent builders
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {stem: lib for stem, (_, lib) in libs.items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first
    use, together with every other source)."""
    with _LOCK:
        if stem not in _LIBS:
            path = build_all()[stem]
            _LIBS[stem] = ctypes.CDLL(str(path))
        return _LIBS[stem]
