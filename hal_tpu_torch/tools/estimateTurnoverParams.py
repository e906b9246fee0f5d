"""Port copy of hal_tpu/tools/estimateTurnoverParams.py (numpy only; the same
code, imports pointing at hal_tpu_torch).

estimateTurnoverParams — fit the two-state constraint-turnover CTMC to
halTreeNITurnover output (reference
analysis/neutralIndel/estimateTurnoverParams.py)."""

from __future__ import annotations

import math
import random
import sys
from collections import deque

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.analysis.turnover_model import (compute_p_matrix,
                                             compute_stationary_dist,
                                             estimate_params_from_list)
from hal_tpu_torch.tools import add_storage_options, make_parser, tool_main


def read_turnover_file(aln, path):
    """Map halTreeNITurnover output lines to ([pi0,pi1], P, t) observations
    (estimateTurnoverParams.py:36-67); t includes the parent branch."""
    result = {}
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 13 or not toks[0].endswith(":"):
                continue
            genome = toks[0].rstrip(":")
            cons, ucons = float(toks[2]), float(toks[4])
            gain, loss = float(toks[6]), float(toks[9])
            total = cons + ucons + gain + loss
            if total <= 0 or cons < 0 or ucons < 0:
                sys.stderr.write("Warning, skipping %s\n" % genome)
                continue
            pi0 = (ucons + loss) / total
            pi1 = (cons + gain) / total
            pg = gain / (ucons + gain) if ucons + gain > 0 else 0.0
            pl = loss / (cons + loss) if cons + loss > 0 else 0.0
            t = float(toks[12])
            if genome != aln.root_name:
                parent = aln.tree.parent(genome)
                if parent and parent != aln.root_name:
                    t += aln.get_branch_length(parent)
            result[genome] = ([pi0, pi1], [[1.0 - pg, pg], [pl, 1.0 - pl]], t)
    return result


def values_below(aln, root_name, observations):
    queue = deque([root_name])
    out = []
    while queue:
        node = queue.popleft()
        if node != root_name:
            if node in observations:
                out.append(observations[node])
            else:
                sys.stderr.write("Warning, no observation for %s\n" % node)
        queue.extend(aln.tree.children(node))
    return out


def print_comparison(obs_vals, observations, result):
    loss_rate, gain_rate = result[0], result[1]
    scope = set(str(x) for x in obs_vals)
    if observations:
        print("Genome, t, piObs0, piObs1, piEst0, piEst1, PLossObs, PGainObs,"
              " PLossEst, PGainEst, AvgDiff")
    for name, obs in observations.items():
        if str(obs) not in scope:
            continue
        t = obs[2]
        pi = compute_stationary_dist(loss_rate, gain_rate, t)
        P = compute_p_matrix(loss_rate, gain_rate, t)
        print("  %s, %f, %.2f, %.2f, %.2f, %.2f, %.3f, %.3f, %.3f, %.3f, %.3f" % (
            name, t, obs[0][0], obs[0][1], pi[0], pi[1],
            obs[1][0][1], obs[1][1][0], P[0][1], P[1][0],
            0.25 * (math.fabs(obs[0][0] - pi[0]) + math.fabs(obs[0][1] - pi[1]) +
                    math.fabs(obs[1][0][1] - P[0][1]) +
                    math.fabs(obs[1][1][0] - P[1][0]))))


def run(argv=None):
    p = make_parser("estimateTurnoverParams",
                    "Estimate constraint turnover parameters")
    p.add_argument("halFile")
    p.add_argument("NITurnoverFile")
    p.add_argument("--maxIt", type=int, default=100000)
    p.add_argument("--step", type=float, default=0.0001)
    p.add_argument("--retries", type=int, default=5)
    p.add_argument("--root", default=None)
    p.add_argument("--allInternals", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=None,
                   help="RNG seed for the multi-start descent")
    add_storage_options(p)
    o = p.parse_args(argv)
    assert o.maxIt > 0 and o.step > 0 and o.retries > 1

    aln = open_alignment(o.halFile)
    root = o.root or aln.root_name
    rng = random.Random(o.seed)
    observations = read_turnover_file(aln, o.NITurnoverFile)

    queue = deque([root])
    while queue:
        node = queue.popleft()
        children = aln.tree.children(node)
        if node == root or (o.allInternals and children):
            obs_vals = values_below(aln, node, observations)
            if obs_vals:
                result = estimate_params_from_list(obs_vals, o.maxIt, o.step,
                                                   o.retries, rng)
                print("%s: lr=%f gr=%f dsq=%f" % (node, result[0], result[1],
                                                  result[2]))
                print_comparison(obs_vals, observations, result)
        queue.extend(children)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
