"""Build the CUDA kernels with ``nvcc`` into a shared library, at first use.

The library has a plain C interface and is loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  It goes to ``build/kernels/``
at the root of the checkout (git-ignored; ``REPRO_TORCH_BUILD_DIR``
overrides it), named by a hash of the source and the flags, so a changed
source is rebuilt and an unchanged one is reused.

Flags: ``sm_90a`` (Hopper), no ``--use_fast_math`` (IEEE ``logf``/``cosf``/
``sqrtf``, no flush to zero) and ``-fmad=false`` (no multiply-add
contraction), so the kernels round as their plain PyTorch versions do.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"zo_direction": CSRC / "zo_direction.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME  # PyTorch's own toolkit lookup

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME); the CUDA kernels "
                       "can only be built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str = "zo_direction", verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library already exists;
    returns the library's path.  Raises with nvcc's output on failure."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    if verbose:
        print(f"# built {out.name} in {time.perf_counter() - t0:.1f} s")
        print(proc.stderr.strip())
    return out
