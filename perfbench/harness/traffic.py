"""One generator for every traffic mix: a mix is a data file of parameters.

``kind: "train"`` mixes give the batches of a training job, ``kind:
"serve"`` mixes the requests of a serving job.  Everything is drawn from the
run's seed alone (numpy's PCG64 under a SeedSequence), so the same seed gives
the same inputs.  Token ids follow ``zipf_a`` over the whole vocabulary, the
rule of ``repro_torch.data.synthetic.token_batches`` (copied: probability of
rank r proportional to r**-a, labels the next token and -1 on the last
position).

Serving sizes are the same on every seed, in another order, with other
tokens: each block of ``strata`` requests holds one prompt length from each of
``strata`` equal slices of the distribution (log-uniform or uniform between
``lo`` and ``hi``), the length at the slice's centre, and the output length
at the centre of slice ``k * pair_step mod strata`` of its own distribution
for prompt slice ``k``.  Within a block the slices come in the golden ratio's
low-discrepancy order, rotated by a seeded offset, so that any run of
consecutive requests (the ones a window admits) spans the slices evenly.
With ``aligned_every`` set, each run of that many requests holds exactly one
prompt whose length is a multiple of ``align``: the request of the middle
prompt slice among the run's first ``strata`` is moved to the head of the
run and given the multiple of ``align`` nearest its slice's centre, the same
length on every seed, so that a window that admits a given number of
requests serves the same kernel prefills on every seed;
every other length that falls on a multiple is moved one token off it.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np


def load(path) -> Dict:
    return json.loads(Path(path).read_text())


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), stream]))


def zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def train_batches(mix: Dict, vocab: int, seed: int) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches of ``sequences`` x ``seq_len`` tokens with next-token labels."""
    rng = _rng(seed, 0)
    probs = zipf_probs(vocab, mix["zipf_a"])
    shape = (mix["sequences"], mix["seq_len"])
    while True:
        toks = rng.choice(vocab, size=shape, p=probs).astype(np.int64)
        labels = np.full(shape, -1, np.int64)
        labels[:, :-1] = toks[:, 1:]
        yield {"tokens": toks, "labels": labels}


def spread_order(n: int) -> np.ndarray:
    """Slices ``0 .. n-1`` in the golden ratio's low-discrepancy order."""
    return np.argsort(np.argsort((np.arange(n) * 0.6180339887498949) % 1.0))


def _quantile(spec: Dict, q):
    lo, hi = spec["lo"], spec["hi"]
    if spec["dist"] == "loguniform":
        return lo * (hi / lo) ** q
    if spec["dist"] == "uniform":
        return lo + q * (hi - lo + 1)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def _slices(rng, n: int, strata: int) -> np.ndarray:
    """The slice of each of ``n`` requests: each block of ``strata`` takes every
    slice once, in the low-discrepancy order rotated by a seeded offset."""
    base = spread_order(strata)
    return np.concatenate([np.roll(base, int(rng.integers(strata)))
                           for _ in range(0, n, strata)])[:n]


def _centres(spec: Dict, where: np.ndarray, strata: int) -> np.ndarray:
    """The length at the centre of each request's slice."""
    q = (where + 0.5) / strata
    return np.clip(np.floor(_quantile(spec, q)), spec["lo"], spec["hi"]).astype(np.int64)


def serve_requests(mix: Dict, vocab: int, seed: int) -> List[Tuple[List[int], int]]:
    """``[(prompt token ids, tokens to generate)]`` in arrival order."""
    rng = _rng(seed, 1)
    n, strata = mix["requests"], mix["strata"]
    spec = mix["prompt_len"]
    where = _slices(rng, n, strata)
    plen = _centres(spec, where, strata)
    olen = _centres(mix["output_len"], (where * mix["pair_step"]) % strata, strata)
    every, align = mix.get("aligned_every"), mix.get("align", 64)
    if every:
        mid = strata // 2
        at = align * max(1, int(round(_quantile(spec, (mid + 0.5) / strata) / align)))
        for b in range(0, n, every):
            pick = b
            run = range(b, min(b + strata, n))
            j = min(run, key=lambda i: abs(where[i] - mid))
            for x in (plen, olen, where):       # the request moves whole, its pair kept
                x[[pick, j]] = x[[j, pick]]
            for i in range(b, min(b + every, n)):
                if i == pick:
                    plen[i] = at
                elif plen[i] % align == 0:
                    plen[i] += 1 if plen[i] < spec["hi"] else -1
    probs = zipf_probs(vocab, mix["zipf_a"])
    toks = rng.choice(vocab, size=int(plen.sum()), p=probs)
    cuts = np.cumsum(plen)[:-1]
    return [(p.tolist(), int(o)) for p, o in zip(np.split(toks, cuts), olen)]
