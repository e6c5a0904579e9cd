"""Build the CUDA kernels with ``nvcc`` into shared libraries, at first use.

One library per source in ``SOURCES``.  Each has a plain C interface and is
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).  It
goes to ``build/kernels/`` at the root of the checkout (git-ignored;
``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the source and
the flags, so a changed source is rebuilt and an unchanged one is reused.

Flags: ``sm_90a`` (Hopper), no ``--use_fast_math`` (IEEE ``logf``/``cosf``/
``sqrtf``, no flush to zero) and ``-fmad=false`` (no multiply-add
contraction), so the kernels round as their plain PyTorch versions do
(flash attention asks for its multiply-adds with ``fmaf``).  ``-Xptxas -v``
reports each kernel's registers and spills; the report is kept beside the
library (``<library>.log``) and read by ``ptxas_usage``.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"zo_direction": CSRC / "zo_direction.cu",
           "flash_attention": CSRC / "flash_attention.cu",
           "selective_scan": CSRC / "selective_scan.cu",
           "rmsnorm": CSRC / "rmsnorm.cu"}
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
    out.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, out)
    if verbose:
        print(f"# built {out.name} in {time.perf_counter() - t0:.1f} s")
        print(proc.stderr.strip())
    return out


def ptxas_usage(name: str) -> dict:
    """{mangled kernel: {"registers", "stack", "spill_stores", "spill_loads"}}
    from ``-Xptxas -v``'s report of the library ``name`` (built first)."""
    text = build(name).with_suffix(".log").read_text()
    usage, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = usage.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return usage
