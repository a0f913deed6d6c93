"""Thresholded rectangular linear assignment, copied from
``deft_tpu/tracking/assignment.py``: scipy by default, the C++
Jonker-Volgenant solver of ``deft_tpu_torch/native`` under
``DEFT_USE_NATIVE=1`` (both give the same optimal objective; on ties they
may pick different pairs).  The variable is read at each call; a native
build that fails raises (``native/__init__.py``).

Replaces ``lap.lapjv(cost, extend_cost=True, cost_limit=thresh)``
(the reference DEFT's ``src/lib/utils/matching.py:40-55``) with scipy's
Jonker-Volgenant solver plus the standard cost-limit augmentation: pad the
cost matrix to (n+m) x (n+m) with ``cost_limit`` on the dummy diagonal blocks,
so any real pair costing more than the limit loses to its dummy.  This
reproduces lapjv's extend_cost/cost_limit semantics exactly (same optimal
objective), and stays on host -- the only non-jitted stage of the per-frame
pipeline, per the BASELINE design.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def linear_assignment(cost: np.ndarray, thresh: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (matches [K, 2], unmatched_rows, unmatched_cols)."""
    if os.environ.get("DEFT_USE_NATIVE", "0") == "1":
        from deft_tpu_torch import native

        return native.lapjv(np.asarray(cost, np.float64), thresh)
    cost = np.asarray(cost, dtype=np.float64)
    if cost.size == 0:
        return (
            np.empty((0, 2), dtype=int),
            np.arange(cost.shape[0]),
            np.arange(cost.shape[1]),
        )
    # EXACT pre-reduction: a row (or column) whose every cost exceeds the
    # limit can only take its own dummy in the padded formulation (dummies
    # are diagonal -- no other row can use them), so removing it leaves the
    # rest of the problem untouched.  Gated cascades at high track counts
    # make most rows infeasible (every cost inf), which otherwise inflates
    # the padded solve to (n+m)^2 on mostly-1e9 entries -- measured 30+ ms
    # per 397x100 call at bench max-load vs ~1 ms after reduction.
    feas_r = (cost <= thresh).any(axis=1)
    feas_c = (cost <= thresh).any(axis=0)
    if not (feas_r.all() and feas_c.all()):
        rows_idx = np.where(feas_r)[0]
        cols_idx = np.where(feas_c)[0]
        sub = cost[np.ix_(rows_idx, cols_idx)]
        smatches, sur, suc = linear_assignment(sub, thresh)
        matches = np.stack(
            [rows_idx[smatches[:, 0]], cols_idx[smatches[:, 1]]], axis=1
        ) if len(smatches) else np.empty((0, 2), dtype=int)
        unmatched_r = np.sort(np.concatenate(
            [np.where(~feas_r)[0], rows_idx[sur]])).astype(int)
        unmatched_c = np.sort(np.concatenate(
            [np.where(~feas_c)[0], cols_idx[suc]])).astype(int)
        return matches, unmatched_r, unmatched_c
    n, m = cost.shape
    # lap.lapjv's extension charges cost_limit/2 per dummy assignment, so an
    # unmatched (row, col) pair totals cost_limit and a real pair wins iff its
    # cost <= cost_limit.  The classic padded-square encoding is
    # (n+m) x (n+m); an EXACTLY equivalent rectangular encoding is n x (m+n)
    # with each row's private dummy column at cost `thresh`:
    #   square objective over a real-pair set M (|M| = k):
    #     c(M) + (n-k)*thr/2 + (m-k)*thr/2  =  c(M) - k*thr + const
    #   rectangular objective with dummy diag d:
    #     c(M) + (n-k)*d                    =  c(M) - k*d   + const
    # so d = thresh yields the same argmin over matchings, at ~(n+m)/n x
    # fewer LSAP rows (measured ~2-4x faster at the cascade's 100x100-400x100
    # shapes).  Solve with the smaller side as rows.
    transpose = m < n
    if transpose:
        cost = cost.T
        n, m = m, n
    # gating writes np.inf into cost rows (matching.py:331 etc.); lapjv
    # accepts inf, scipy does not -- cap to an unassignable finite value
    rect = np.full((n, m + n), 1e9)
    rect[:, :m] = np.minimum(np.nan_to_num(cost, nan=1e9, posinf=1e9), 1e9)
    idx = np.arange(n)
    rect[idx, m + idx] = thresh
    rows, cols = linear_sum_assignment(rect)

    matched_r = np.zeros(n, dtype=bool)
    matched_c = np.zeros(m, dtype=bool)
    real = cols < m
    rr, cc = rows[real], cols[real]
    matched_r[rr] = True
    matched_c[cc] = True
    matches = np.stack([rr, cc], axis=1).astype(int)
    if transpose:
        matches = matches[:, ::-1]
        matched_r, matched_c = matched_c, matched_r
    return (
        matches.reshape(-1, 2),
        np.where(~matched_r)[0],
        np.where(~matched_c)[0],
    )
