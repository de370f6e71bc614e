"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under a kernel's ``csrc/`` has a plain C interface and is
compiled on its own into a shared library, at first use, into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``).
The library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import time: this module is imported on hosts that
have no ``nvcc`` and no card, where only the kernels' plain versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float          # nvcc wall time; 0.0 when an earlier build was reused
    log: str                # nvcc's stderr (ptxas register / spill report)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME "
                       f"={cuda_home}); the CUDA kernels cannot be built")


def load(source: Path) -> Built:
    """Build ``source`` unless a build of this content exists, and load it.
    Callers keep the result: this touches the file system."""
    source = Path(source).resolve()
    text = source.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"{source.stem}-{digest[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source.name} ({proc.returncode}):\n{log}")
        os.replace(tmp, out)          # atomic: concurrent builders agree
    return Built(ctypes.CDLL(str(out)), out, seconds, log)
