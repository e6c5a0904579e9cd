"""libsvm-format multiclass dataset loader (for the paper's §5.2 datasets).

The container is offline; when the real SENSORLESS/ACOUSTIC/COVTYPE/SEISMIC
files are placed under ``data_dir`` this loader uses them, otherwise callers
fall back to ``repro_torch.data.synthetic.make_classification``.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def parse_libsvm(path: str, n_features: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    xs, ys = [], []
    max_f = n_features or 0
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            ys.append(float(parts[0]))
            feats = {}
            for tok in parts[1:]:
                i, v = tok.split(":")
                feats[int(i)] = float(v)
                max_f = max(max_f, int(i))
            rows.append(feats)
    x = np.zeros((len(rows), max_f), np.float32)
    for r, feats in enumerate(rows):
        for i, v in feats.items():
            x[r, i - 1] = v  # libsvm is 1-indexed
    y = np.asarray(ys)
    # labels may be 1-indexed or arbitrary ints; remap to 0..C-1
    uniq = np.unique(y)
    remap = {v: i for i, v in enumerate(uniq)}
    y = np.asarray([remap[v] for v in y], np.int32)
    return x, y


def try_load(name: str, data_dir: str = "data"):
    """Returns a Dataset if real files exist, else None."""
    from repro_torch.data.synthetic import Dataset

    train = os.path.join(data_dir, f"{name}.train")
    test = os.path.join(data_dir, f"{name}.test")
    if not (os.path.exists(train) and os.path.exists(test)):
        return None
    xtr, ytr = parse_libsvm(train)
    xte, yte = parse_libsvm(test, n_features=xtr.shape[1])
    mu, sd = xtr.mean(0), xtr.std(0) + 1e-6
    return Dataset(name, (xtr - mu) / sd, ytr, (xte - mu) / sd, yte)
