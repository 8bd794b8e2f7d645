"""One-factor trinomial tree calibrated to the forward curve.

Replaces ``Cmdty.Core.Trees.OneFactorTrinomialTree.CreateTree`` (consumed at
reference ``TreeStorageValuationExtensions.cs:93-118``) with an array-based
recombining lattice designed for array backward induction:

* The lattice discretises the *dimensionless* OU state x (unit instantaneous
  vol, mean reversion a): x_{k+1} = e^{-aΔ}·x_k + ε, Var(ε) = (1-e^{-2aΔ})/(2a).
  The spot for period k is S = exp(θ_k + σ_k·x) with σ_k from the spot vol
  curve and θ_k a per-period shift calibrating Σ_j q_{k,j}·S_{k,j} = F(0,k)
  exactly.  Building on the dimensionless state makes the tree represent the
  same process as the 1-factor OU Monte Carlo model (``models/multi_factor.py``),
  which is what gives the LSMC-vs-tree agreement oracle
  (LsmcStorageValuationTest.cs:425-481) meaning.
* Branching is the standard Hull-White trinomial with the node index clamped
  at j_max = ceil(0.184/(a·Δ)) (inward edge branching), refined with
  ``num_substeps`` internal time steps per period for lattice convergence.
* Instead of per-node destination gathers, each period's transition is the
  dense [M, M] matrix product of its substep transitions — backward induction
  becomes ``EV = T_k @ V_next``, one dense matmul.
"""
from __future__ import annotations

import math
import typing as tp

import numpy as np


class TrinomialTree(tp.NamedTuple):
    """Lattice over P periods with M node levels.

    ``transition[k]`` maps node values at period k+1 to expectations at period
    k: EV_k = transition[k] @ V_{k+1}.  ``q[k]`` are node probabilities,
    ``spot[k]`` calibrated spot prices, ``theta[k]`` the calibration shifts.
    """

    x: np.ndarray  # [M] dimensionless OU node values
    spot: np.ndarray  # [P, M]
    q: np.ndarray  # [P, M]
    transition: np.ndarray  # [P-1, M, M]
    theta: np.ndarray  # [P]
    dest_centre: np.ndarray  # [M] centre destination level after one period


def _substep_transition(decay: float, step_var: float, dx: float, j_max: int) -> np.ndarray:
    """One Hull-White trinomial substep as a dense [M, M] row-stochastic matrix."""
    m = 2 * j_max + 1
    x = (np.arange(m) - j_max) * dx
    centre = np.clip(np.round(x * decay / dx).astype(np.int64) + j_max, 1, m - 2)
    alpha = (x * decay - (centre - j_max) * dx) / dx
    eta = step_var / (dx * dx)
    pu = 0.5 * (eta + alpha * alpha + alpha)
    pd = 0.5 * (eta + alpha * alpha - alpha)
    pm = 1.0 - pu - pd
    probs = np.stack([pd, pm, pu], axis=-1)
    if np.any(probs < -1e-12):
        raise ValueError("Negative branch probability in trinomial tree.")
    probs = np.clip(probs, 0.0, 1.0)
    probs /= probs.sum(axis=-1, keepdims=True)
    t = np.zeros((m, m))
    rows = np.arange(m)
    for b, off in enumerate((-1, 0, 1)):
        t[rows, centre + off] += probs[:, b]
    return t


def build_tree(
    forward_prices: np.ndarray,  # [P]
    spot_vols: np.ndarray,  # [P]
    mean_reversion: float,
    time_step: float,
    num_substeps: int = 4,
    max_levels: int = 401,
) -> TrinomialTree:
    p = len(forward_prices)
    a = float(mean_reversion)
    dt = float(time_step)
    if dt <= 0:
        raise ValueError("time_step must be positive.")
    nsub = max(1, int(num_substeps))
    sub_dt = dt / nsub

    if a > 0:
        step_var = (1.0 - math.exp(-2.0 * a * sub_dt)) / (2.0 * a)
        decay = math.exp(-a * sub_dt)
        j_max = max(1, math.ceil(0.184 / (a * sub_dt)))
    else:
        step_var = sub_dt
        decay = 1.0
        j_max = p * nsub  # random walk: grows one level per substep
    j_max = min(j_max, (max_levels - 1) // 2)
    m = 2 * j_max + 1
    dx = math.sqrt(3.0 * step_var)
    x = (np.arange(m) - j_max) * dx

    sub_t = _substep_transition(decay, step_var, dx, j_max)
    period_t = np.linalg.matrix_power(sub_t, nsub)  # [M, M], time-homogeneous

    transition = np.broadcast_to(period_t, (max(p - 1, 0), m, m)).copy()

    q = np.zeros((p, m))
    q[0, j_max] = 1.0
    for k in range(p - 1):
        q[k + 1] = q[k] @ period_t

    theta = np.empty(p)
    spot = np.empty((p, m))
    for k in range(p):
        expected = float(q[k] @ np.exp(spot_vols[k] * x))
        theta[k] = math.log(forward_prices[k]) - math.log(expected)
        spot[k] = np.exp(theta[k] + spot_vols[k] * x)
    # Centre destination after one full period of mean reversion (for the
    # decision simulator's branch-path semantics).
    period_decay = math.exp(-a * dt) if a > 0 else 1.0
    dest_centre = np.clip(
        np.round(x * period_decay / dx).astype(np.int64) + j_max, 1, m - 2
    ) if m > 2 else np.zeros(m, dtype=np.int64)
    return TrinomialTree(x=x, spot=spot, q=q, transition=transition, theta=theta,
                         dest_centre=dest_centre)


def build_intrinsic_tree(forward_prices: np.ndarray) -> TrinomialTree:
    """Degenerate single-node tree: spot = forward with certainty
    (reference ``WithIntrinsicTree``, TreeStorageValuationExtensions.cs:104-124)."""
    p = len(forward_prices)
    spot = np.asarray(forward_prices, dtype=np.float64)[:, None]
    return TrinomialTree(
        x=np.zeros(1),
        spot=spot,
        q=np.ones((p, 1)),
        transition=np.ones((max(p - 1, 0), 1, 1)),
        theta=np.log(spot[:, 0]),
        dest_centre=np.zeros(1, dtype=np.int64),
    )
