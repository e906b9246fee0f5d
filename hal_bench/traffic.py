"""The benchmark's one traffic generator.  A traffic mix is a JSON file
hal_bench/traffic/<name>.json of parameters; the drivers read their inputs
from here, so that every input is a function of (seed, request index) and
the reference can make the same input again after the window.

Every seed gets the same sizes: the same number of intervals or columns a
request, lengths from the same range, the same kinds of lines.  The seed
moves where they fall, and the alignment's content (hal_bench.gen).
"""

from __future__ import annotations

import numpy as np

# keeps the request streams of one seed apart from its pools
_POOL, _REQUEST, _SAMPLE = 1, 2, 3


def rng_for(seed: int, *key: int) -> np.random.Generator:
    """A generator for (seed, key...): any whole seed, request indices
    below zero (warm-up) included."""
    words = [int(seed) % (1 << 64)] + [int(k) % (1 << 64) for k in key]
    return np.random.default_rng(words)


def request_rng(seed: int, k: int) -> np.random.Generator:
    return rng_for(seed, _REQUEST, k)


def sample_rng(seed: int) -> np.random.Generator:
    return rng_for(seed, _SAMPLE)


def deepest_leaf_pair(model) -> tuple[str, str]:
    """bench.py's pick_pair: the leaf pair with the longest tree path, the
    first found in genome-name order."""
    tree = model.tree
    leaves = [n for n in model.genome_names() if tree.is_leaf(n)
              and model.open_genome(n).length > 0]
    best = (0, leaves[0], leaves[0])
    for a in leaves:
        for b in leaves:
            if a != b:
                d = len(tree.path(a, b))
                if d > best[0]:
                    best = (d, a, b)
    return best[1], best[2]


def longest_leaf(model) -> str:
    """The MAF reference: the longest leaf, the first in genome-name order
    among equals."""
    leaves = [n for n in model.genome_names() if model.tree.is_leaf(n)]
    return max(leaves, key=lambda n: int(model.open_genome(n).length))


def interval_pool(seed: int, genome_length: int, traffic: dict):
    """traffic["pool"] intervals [lo, hi) uniform over a genome, lengths
    uniform in [min_len, max_len]."""
    rng = rng_for(seed, _POOL)
    n = int(traffic["pool"])
    ln = rng.integers(int(traffic["min_len"]), int(traffic["max_len"]) + 1, n)
    lo = rng.integers(0, genome_length - ln + 1)
    return lo.astype(np.int64), (lo + ln).astype(np.int64)


def bed_fields(seed: int, n: int):
    """Names, scores and strands of n BED6 lines."""
    rng = rng_for(seed, _POOL, 1)
    names = ["r%07d" % v for v in rng.integers(0, 10 ** 7, n)]
    scores = rng.integers(0, 1001, n)
    strands = np.array(["+", "-"])[rng.integers(0, 2, n)]
    return names, scores, strands


def pool_slice(seed: int, k: int, pool: int, n: int) -> slice:
    """Request k's n consecutive entries of a pool, from a seeded offset."""
    o = int(request_rng(seed, k).integers(0, pool - n + 1))
    return slice(o, o + n)


def window_start(seed: int, k: int, length: int, width: int) -> int:
    """Request k's window start, uniform over [0, length - width]."""
    return int(request_rng(seed, k).integers(0, length - width + 1))
