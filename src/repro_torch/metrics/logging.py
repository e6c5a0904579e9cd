"""Training metrics: CSV logging + communication/compute meters.

A copy of ``CSVLogger`` and ``MeterRegistry`` from ``repro.metrics.logging``
(pure Python); ``comm_report`` waits for the port of the comm ledger.

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
