"""Port copy of hal_tpu/analysis/turnover_model.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

Two-state constraint-turnover CTMC (reference
analysis/constraintTurnover/turnoverModel.py).

States: 0 = unconstrained, 1 = constrained; rates gain (0->1) and loss
(1->0).  P(t) and the stationary distribution have the closed forms of
turnoverModel.py:26-53; parameters are fit by the same randomized
coordinate-descent (gradDescent, turnoverModel.py:91-161), made reproducible
via an explicit `random.Random`.
"""

from __future__ import annotations

import math
import random as _random

__all__ = ["compute_p_matrix", "compute_stationary_dist", "diff_one_point",
           "diff_sq_many_points", "grad_descent", "generate_data",
           "estimate_params_from_list"]


def compute_p_matrix(loss_rate: float, gain_rate: float, t: float):
    assert t >= 0 and loss_rate >= 0 and gain_rate >= 0
    x = gain_rate / loss_rate
    y = gain_rate + loss_rate
    eyt = math.exp(-y * t)
    c = 1.0 / (x + 1.0)
    P = [[c * (1.0 + x * eyt), c * (x - x * eyt)],
         [c * (1.0 - eyt), c * (x + eyt)]]
    assert abs(P[0][0] + P[0][1] - 1.0) < 1e-5
    assert abs(P[1][0] + P[1][1] - 1.0) < 1e-5
    return P


def compute_stationary_dist(loss_rate: float, gain_rate: float, t: float):
    assert t >= 0 and loss_rate >= 0 and gain_rate >= 0
    x = gain_rate / loss_rate
    y = gain_rate + loss_rate
    eyt = math.exp(-y * t)
    pi0 = (eyt - 1.0) / (x * eyt + eyt - x - 1.0)
    pi1 = 1.0 - pi0
    assert 0.0 <= pi0 <= 1.0 and 0.0 <= pi1 <= 1.0
    return [pi0, pi1]


def diff_one_point(loss_rate, gain_rate, pi_est, p_est, t):
    P = compute_p_matrix(loss_rate, gain_rate, t)
    pi = compute_stationary_dist(loss_rate, gain_rate, t)
    return (abs(pi[0] - pi_est[0]) + abs(pi[1] - pi_est[1]) +
            abs(P[0][0] - p_est[0][0]) + abs(P[0][1] - p_est[0][1]) +
            abs(P[1][0] - p_est[1][0]) + abs(P[1][1] - p_est[1][1]))


def diff_sq_many_points(loss_rate, gain_rate, est_vals):
    tot = 0.0
    for pi_est, p_est, t in est_vals:
        d = diff_one_point(loss_rate, gain_rate, pi_est, p_est, t)
        tot += d * d
    return tot


def grad_descent(lr_start, gr_start, est_vals, max_it, delta, rng=None):
    """Randomized coordinate descent over (lossRate, gainRate)
    (turnoverModel.py:91-161), with the same 10x-boost escape hatch."""
    rng = rng or _random
    best_diff = diff_sq_many_points(lr_start, gr_start, est_vals)
    best_lr, best_gr = lr_start, gr_start
    last_change = 0
    for i in range(max_it):
        lr, gr = best_lr, best_gr
        rval = rng.randint(0, 3)
        if rval == 0:
            d = diff_sq_many_points(lr + delta, gr, est_vals)
            if d < best_diff:
                best_diff, best_lr, best_gr, last_change = d, lr + delta, gr, i
        elif rval == 1:
            d = diff_sq_many_points(lr, gr + delta, est_vals)
            if d < best_diff:
                best_diff, best_lr, best_gr, last_change = d, lr, gr + delta, i
        elif rval == 2 and lr > delta:
            d = diff_sq_many_points(lr - delta, gr, est_vals)
            if d < best_diff:
                best_diff, best_lr, best_gr, last_change = d, lr - delta, gr, i
        elif rval == 3 and gr > delta:
            d = diff_sq_many_points(lr, gr - delta, est_vals)
            if d < best_diff:
                best_diff, best_lr, best_gr, last_change = d, lr, gr - delta, i
        if i == last_change + 8:
            boost = delta * 10.0
            for dl, dg in ((boost, 0.0), (0.0, boost), (-boost, 0.0), (0.0, -boost)):
                if lr + dl <= 0 or gr + dg <= 0:
                    continue
                d = diff_sq_many_points(lr + dl, gr + dg, est_vals)
                if d < best_diff:
                    best_diff, best_lr, best_gr, last_change = d, lr + dl, gr + dg, i
        elif i > last_change + 8:
            break
    return (best_lr, best_gr, best_diff)


def generate_data(n, t_range, loss_rate, gain_rate, max_noise, rng=None):
    """Simulated (pi, P, t) observations with optional uniform noise
    (turnoverModel.py:177-185)."""
    rng = rng or _random
    vals = []
    for _ in range(n):
        t = rng.uniform(t_range[0], t_range[1])
        P = compute_p_matrix(loss_rate, gain_rate, t)
        pi = compute_stationary_dist(loss_rate, gain_rate, t)
        if max_noise:
            d = rng.uniform(-max_noise, max_noise)
            P[0][0] += d
            P[0][1] -= d
            d = rng.uniform(-max_noise, max_noise)
            P[1][0] += d
            P[1][1] -= d
            d = rng.uniform(-max_noise, max_noise)
            pi[0] += d
            pi[1] -= d
        vals.append((pi, P, t))
    return vals


def estimate_params_from_list(obs_vals, max_it, step, retries, rng=None):
    """Multi-start wrapper (estimateTurnoverParams.py:90-106)."""
    rng = rng or _random
    assert len(obs_vals) > 0
    best = (0.0, 0.0, 1e6)
    for retry in range(retries):
        if retry == 0:
            lr0 = gr0 = step
        else:
            lr0 = rng.uniform(0.0, step * max_it)
            gr0 = rng.uniform(0.0, step * max_it)
        lr, gr, diff = grad_descent(lr0, gr0, obs_vals, max_it, step, rng)
        if diff < best[2]:
            best = (lr, gr, diff)
    return list(best)
