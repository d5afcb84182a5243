"""The one general generator: it reads a traffic mix's parameters
(``benchmark/traffic/<mix>.json``) and makes the run's inputs from the
seed.

Every seed gets the same work.  The sizes and the gaps between arrivals
are stratified quantiles of the mix's distributions, put in an order
drawn from the mix's own ``order_seed``: one schedule for every run.
The run's seed draws the token ids (and, for training, the rows).  The
order is the mix's and not the run's because under an open loop it is
part of the work: which long prompts land together sets the queue, and
measured runs of one schedule agreed where schedules in different orders
spread by 20-30%.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The seed's generator for one purpose (``stream``): token ids,
    orders and samples each draw from their own."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def quantiles(dist: Dict, n: int) -> List[int]:
    """``n`` stratified quantiles (at (i + 0.5) / n) of a length
    distribution, rounded and clipped to its ``min``/``max``.  Kinds:
    ``lognormal`` (``median``, ``sigma``) and ``fixed`` (``value``)."""
    kind = dist["kind"]
    if kind == "fixed":
        return [int(dist["value"])] * n
    if kind != "lognormal":
        raise ValueError(f"unknown length distribution {kind!r}")
    mu, sigma = math.log(dist["median"]), float(dist["sigma"])
    z = NormalDist()
    out = [math.exp(mu + sigma * z.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return [int(min(max(round(x), dist["min"]), dist["max"])) for x in out]


def gaps(arrivals: Dict, n: int) -> List[float]:
    """``n`` gaps between arrivals, in seconds, as stratified quantiles.
    Kinds: ``poisson`` (exponential gaps at ``rate_per_s``)."""
    if arrivals["kind"] != "poisson":
        raise ValueError(f"unknown arrival process {arrivals['kind']!r}")
    rate = float(arrivals["rate_per_s"])
    return [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]


@dataclasses.dataclass
class Request:
    due_s: float          # seconds after the window opens
    prompt: List[int]
    max_new_tokens: int


def serve_stream(mix: Dict, seed: int, seconds: float, vocab: int,
                 rate_per_s: float = None) -> List[Request]:
    """The open-loop stream of one run: ``rate x seconds`` requests, the
    arrivals that fall inside the window.  ``rate_per_s`` overrides the
    mix's rate (the rate sweep)."""
    arrivals = dict(mix["arrivals"])
    if rate_per_s is not None:
        arrivals["rate_per_s"] = rate_per_s
    n = max(1, int(round(arrivals["rate_per_s"] * seconds)))
    order = rng(mix["order_seed"], 1)
    prompt_lens = order.permutation(quantiles(mix["prompt_tokens"], n))
    out_lens = order.permutation(quantiles(mix["output_tokens"], n))
    due = np.cumsum(order.permutation(gaps(arrivals, n)))
    # The first request is due when the window opens.
    due = due - due[0]
    ids = rng(seed, 2)
    lo = int(mix.get("token_min", 0))
    reqs = []
    for i in range(n):
        if due[i] >= seconds:
            break
        prompt = ids.integers(lo, vocab, int(prompt_lens[i])).tolist()
        reqs.append(Request(float(due[i]), prompt, int(out_lens[i])))
    return reqs


def train_rows(seed: int, n_rows: int, seq: int, vocab: int) -> np.ndarray:
    """``n_rows`` token rows of ``seq`` ids, uniform over the vocabulary;
    rows differ from one another."""
    return rng(seed, 3).integers(0, vocab, (n_rows, seq), dtype=np.int64)


def sample(seed: int, n_items: int, k: int, must: int = None) -> List[int]:
    """``k`` indices of ``n_items`` drawn from the seed, ``must`` among
    them if given (the requests the correctness check compares)."""
    pool = [i for i in range(n_items) if i != must]
    picked = rng(seed, 4).permutation(pool)[:max(0, k - (must is not None))]
    out = ([must] if must is not None else []) + [int(i) for i in picked]
    return sorted(out)
