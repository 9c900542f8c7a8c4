"""The benchmark's traffic generator: one general generator that every
traffic file under ``bench/traffic/`` parameterises.

A frozen copy of the port's ``serving/workload.py::generate`` idea (Zipf
adapter popularity, BurstGPT-shaped lognormal prompt and output lengths),
changed in one way: every seed gets the same work. A
run's spread is measured across seeds, so the seed must not change how
much work a window holds. The sizes are therefore the midpoints of equal
strata of each distribution, the same for every seed, and the seed only
deals them out:

  - lengths: ``strata`` quantile midpoints of the clipped lognormal; each
    consecutive block of ``strata`` requests holds every midpoint once, in
    an order drawn from the seed (prompt and output lengths independently);
  - adapters: the Zipf share of each popularity rank fixed per block by
    largest remainder; which adapter id holds which popularity rank is a
    permutation drawn from the seed;
  - arrivals: ``"arrivals": "<process>"`` names the module
    ``bench/arrivals/<process>.py``, which gives the run's request count
    and each request's due time (``backlog``: every request at t = 0);
  - prompt token ids: uniform over the vocabulary, from the seed.

Nothing here imports the program or the JAX package.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib
from statistics import NormalDist
from typing import Dict, List, Sequence

import numpy as np

TRAFFIC_DIR = pathlib.Path(__file__).resolve().parent / "traffic"


@dataclasses.dataclass
class Req:
    """One generated request: ``due`` seconds after the window opens."""
    idx: int
    adapter: int
    due: float
    prompt: np.ndarray        # int64 token ids
    output_len: int


def load_traffic(name: str) -> Dict:
    """The parameters of ``bench/traffic/<name>.json``."""
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic file {path}")
    spec = json.loads(path.read_text())
    spec.setdefault("name", name)
    return spec


def zipf_popularity(n: int, s: float) -> np.ndarray:
    """Zipf(s) shares of popularity ranks 0..n-1 (the port's formula)."""
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


def lognormal_strata(median: float, sigma: float, lo: int, hi: int,
                     strata: int) -> np.ndarray:
    """The midpoints of ``strata`` equal-probability strata of a lognormal
    (median, sigma), clipped to [lo, hi] and rounded: the same sizes for
    every seed."""
    nd = NormalDist()
    q = [nd.inv_cdf((i + 0.5) / strata) for i in range(strata)]
    vals = np.exp(np.log(median) + sigma * np.asarray(q))
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def dealt(values: np.ndarray, n: int, rng) -> np.ndarray:
    """``n`` values: consecutive blocks of len(values), each a seeded
    permutation of ``values`` (the last block cut short)."""
    blocks = -(-n // len(values))
    return np.concatenate([rng.permutation(values)
                           for _ in range(blocks)])[:n]


def _adapter_block(n_adapters: int, s: float, block: int) -> np.ndarray:
    """Popularity ranks of one block of ``block`` requests: rank k appears
    its Zipf share of the block, by largest remainder."""
    share = zipf_popularity(n_adapters, s) * block
    count = np.floor(share).astype(np.int64)
    rest = block - int(count.sum())
    count[np.argsort(-(share - count), kind="stable")[:rest]] += 1
    return np.repeat(np.arange(n_adapters), count)


def arrivals(spec: Dict):
    """The arrival process the traffic file names: the module
    ``bench/arrivals/<name>.py``, with ``count(spec, seconds)`` (how many
    requests a run of ``seconds`` needs) and ``due(spec, n, rng, strata)``
    (their due times in seconds from the window's opening, ascending)."""
    name = spec["arrivals"]
    if not str(name).isidentifier():
        raise ValueError(f"arrivals {name!r} is no module name")
    return importlib.import_module(f"bench.arrivals.{name}")


def generate(spec: Dict, n_adapters: int, vocab: int, seed: int,
             seconds: float) -> List[Req]:
    """The run's requests from ``seed``, in due order."""
    rng = np.random.default_rng(seed)
    strata = int(spec.get("strata", 64))
    process = arrivals(spec)
    n = int(process.count(spec, seconds))
    p = spec["prompt"]
    o = spec["output"]
    prompts = dealt(lognormal_strata(p["median"], p["sigma"], p["min"],
                                     p["max"], strata), n, rng)
    outputs = dealt(lognormal_strata(o["median"], o["sigma"], o["min"],
                                     o["max"], strata), n, rng)
    holder = popularity_holders(n_adapters, seed)
    ranks = dealt(_adapter_block(n_adapters, float(spec["zipf_s"]), strata),
                  n, rng)
    due = np.asarray(process.due(spec, n, rng, strata), np.float64)
    out = []
    for i in range(n):
        toks = rng.integers(0, vocab, int(prompts[i]), dtype=np.int64)
        out.append(Req(i, int(holder[ranks[i]]), float(due[i]), toks,
                       int(outputs[i])))
    return out


def popularity_holders(n_adapters: int, seed: int) -> np.ndarray:
    """The adapter id holding each popularity rank, drawn from the seed
    (a stream of its own, shared by ``generate`` and ``adapter_ranks``)."""
    return np.random.default_rng([seed, 1]).permutation(n_adapters)


def adapter_ranks(n_adapters: int, cycle: Sequence[int], seed: int
                  ) -> List[int]:
    """Each adapter id's true rank: the ``cycle`` repeated over the
    popularity ranks, so that the mix of ranks by popularity is the same
    for every seed; the seed picks which id holds which popularity rank,
    as ``generate`` does."""
    out = [0] * n_adapters
    for k, aid in enumerate(popularity_holders(n_adapters, seed)):
        out[int(aid)] = int(cycle[k % len(cycle)])
    return out


def warmup_wave(buckets: Sequence[int], n_adapters: int, vocab: int,
                prompt_len: int, seed: int) -> List[Req]:
    """Requests that, admitted together, pass the decode batch through
    each of ``buckets`` (powers of two) once and bring every adapter onto
    the card: max(buckets) requests (at least one per adapter), with output
    lengths such that the number still decoding at step s falls through
    the buckets."""
    top = max(buckets)
    n = max(top, n_adapters)
    rng = np.random.default_rng(seed ^ 0x5EED)
    # decode step j (1-based) runs with len(alive) rows; a request of
    # output length L is alive for steps 1..L
    outs = np.ones(n, np.int64)
    step = 1
    for b in sorted(buckets, reverse=True):
        step += 1
        outs[:b] = step
    out = []
    for i in range(n):
        toks = rng.integers(0, vocab, prompt_len, dtype=np.int64)
        out.append(Req(-1 - i, i % n_adapters, 0.0, toks, int(outs[i])))
    return out
