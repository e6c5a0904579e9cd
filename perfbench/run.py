"""Run one cell of the port's benchmark once, on the machine this is started on.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``).  The
last line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last); the last lines of standard error give each number the run
compared, beside its limit.  With ``--trace 0`` the metrics are the cell's
end-to-end ones, with ``--trace 1`` its per-layer ones, read under the
profiler.  The run exits non-zero and prints no result without a CUDA device,
with fewer devices than the cell asks for, without the port, or when JAX or
the JAX package was loaded.  Every cache the program builds (its CUDA
libraries under ``build/kernels``, Triton's, PyTorch's extensions) stays in
the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _fail(code: int, why: str):
    print(f"perfbench: {why}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        _fail(2, f"the port (src/repro_torch) is not in {ROOT}")
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    sys.path[:0] = [str(HERE), str(ROOT / "src")]

    import torch

    from harness import manifest, runner

    cell = manifest.cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        _fail(3, "no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < cell.chips:
        _fail(3, f"{args.workload} needs {cell.chips} devices, "
                 f"{torch.cuda.device_count()} present")
    result, checks = runner.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                                "cuda", T_START)
    found = runner.forbidden_modules()
    if found:
        _fail(4, f"JAX or the JAX package was loaded: {', '.join(found)}")
    for name, value, limit in checks:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
