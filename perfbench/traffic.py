"""The one generator of the benchmark's traffic: it reads a mix's data file
(`traffic/<mix>.json`) and makes the request stream of a run from its
seed.

A mix names its `kind` (the entry it drives, `kinds/<kind>.py`) and
describes each request by two kinds of fields:

* `cycle`: {field: [values, ...]}. The requests run through every
  combination of the listed values, one cycle after another, each cycle
  in its own order drawn from the seed, so every seed gives every
  combination equally often.
* `draw`: {field: [lo, hi]}. Drawn uniformly and afresh for each request
  from the seed.

Request i depends only on (seed, i), so a closed loop that stops at any
point has sent the same requests as any other run of that seed.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    with open(ROOT / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _order(seed: int, stream: int, cycle: int, n: int) -> np.ndarray:
    """The order of the combinations in one cycle."""
    return np.random.default_rng([seed, stream, cycle]).permutation(n)


def _draw(ranges: dict, rng: np.random.Generator) -> dict:
    return {k: float(rng.uniform(lo, hi))
            for k, (lo, hi) in sorted(ranges.items())}


class Stream:
    """Request fields by index for one run: `fields(i)`."""

    def __init__(self, mix: dict, seed: int):
        if seed < 0:
            raise ValueError(f"seed must be >= 0, got {seed}")
        self.seed = int(seed)
        cycle = mix.get("cycle", {})
        keys = sorted(cycle)
        self.combos = [dict(zip(keys, vals)) for vals in
                       itertools.product(*(cycle[k] for k in keys))] or [{}]
        self.ranges = mix.get("draw", {})

    def fields(self, i: int) -> dict:
        c, r = divmod(i, len(self.combos))
        out = dict(self.combos[_order(self.seed, 1, c, len(self.combos))[r]])
        out.update(_draw(self.ranges,
                         np.random.default_rng([self.seed, 2, i])))
        return out

    def warm(self) -> list:
        """One request of each combination the mix cycles through, its
        draws made apart from the timed requests'."""
        return [{**combo, **_draw(self.ranges, np.random.default_rng(
            [self.seed, 4, j]))} for j, combo in enumerate(self.combos)]

    def sample(self, n_done: int, k: int, stream: int = 3) -> list:
        """k request indices of the first n_done, drawn from the seed, in
        ascending order (all of them when k >= n_done)."""
        if k >= n_done:
            return list(range(n_done))
        rng = np.random.default_rng([self.seed, stream, n_done])
        return sorted(int(x) for x in rng.choice(n_done, k, replace=False))
