"""Training metrics: CSV logging + communication/compute meters.

A copy of ``CSVLogger``, ``MeterRegistry`` and ``comm_report`` from
``repro.metrics.logging`` (pure Python; the ledger is
``repro_torch.dist.CommLedger``).

The meters track the *analytic* per-method cost model (Method.comm_scalars
etc.) alongside measured losses, so the Table-1 benchmark can print measured
convergence against modeled communication/computation load.
"""
from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional


class CSVLogger:
    def __init__(self, path: Optional[str], fields):
        self.path = path
        self.fields = list(fields)
        self._writer = None
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "w", newline="")
            self._writer = csv.DictWriter(self._fh, fieldnames=self.fields)
            self._writer.writeheader()

    def log(self, **row):
        unknown = set(row) - set(self.fields)
        if unknown:
            raise ValueError(
                f"CSVLogger: unknown keys {sorted(unknown)}; declared fields "
                f"are {self.fields}")
        if self._writer:
            self._writer.writerow({k: row.get(k, "") for k in self.fields})
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = self._writer = None

    # context-manager support: the training drivers hold the file open for
    # the whole run, so an exception mid-loop must still release the handle
    def __enter__(self) -> "CSVLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


class MeterRegistry:
    """Accumulates per-method cost counters over a run."""

    def __init__(self, d: int):
        self.d = d
        self.scalars_sent = 0.0      # per worker
        self.fevals = 0.0
        self.gevals = 0.0
        self.t0 = time.perf_counter()

    def tick(self, method, iters: int = 1):
        self.scalars_sent += method.comm_scalars(self.d) * iters
        self.fevals += method.fevals(self.d) * iters
        self.gevals += method.gevals(self.d) * iters

    def summary(self) -> Dict[str, float]:
        return {
            "scalars_sent_per_worker": self.scalars_sent,
            "fevals_per_worker": self.fevals,
            "gevals_per_worker": self.gevals,
            "wall_s": time.perf_counter() - self.t0,
        }


def comm_report(ledger, d: int, m: int, tau: int,
                scalar_bytes: int = 4, codec=None, leaf_dims=None,
                grad_bytes: int = None) -> list:
    """Measured-vs-analytic communication lines (paper Table 1, in bytes).

    ``ledger`` is a ``repro_torch.dist.CommLedger`` whose FO/ZO steps were
    wrapped under the names ``"fo"``/``"zo"``.  Analytic model per worker per
    iteration (ledger convention: bytes received): FO moves the d-dim
    gradient, ZO gathers one scalar from each of the m workers; amortized
    over the ledger's actual FO/ZO step counts.  ``codec`` (a
    ``dist.compress.Compressor``) with ``leaf_dims`` prices the FO column by
    its per-leaf wire model; ``grad_bytes`` is the dense gradient's
    per-scalar width (the ZO coefficients stay ``scalar_bytes``).
    """
    fo_b = ledger.bytes_per_step("fo")
    zo_b = ledger.bytes_per_step("zo")
    n_fo = ledger.steps.get("fo", 0)
    n_zo = ledger.steps.get("zo", 0)
    iters = n_fo + n_zo
    if codec is None:
        fo_analytic = (grad_bytes or scalar_bytes) * d
    else:
        fo_analytic = sum(codec.nbytes(n) for n in (leaf_dims or [d]))
    tag = f"[{codec.name}]" if codec is not None else ""
    lines = [
        "# communication (bytes/worker): measured (CommLedger) vs analytic",
        f"comm/fo_bytes_per_step{tag},measured={fo_b},analytic={fo_analytic}",
        f"comm/zo_bytes_per_step,measured={zo_b},analytic={scalar_bytes * m}",
    ]
    if iters:
        measured = ledger.total_bytes() / iters
        analytic = (n_fo * fo_analytic + n_zo * scalar_bytes * m) / iters
        lines.append(
            f"comm/amortized_bytes_per_iter,measured={measured:.1f},"
            f"analytic={analytic:.1f},steps={iters}")
    return lines
