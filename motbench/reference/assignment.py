"""Plain auction and greedy solvers (``fastmot_tpu_torch/ops/assignment.py``).

Frozen copy of the plain (CPU) version in the port at the commit
that added the benchmark, with the kernel dispatch taken out; it
imports nothing of the port, so later changes to the port cannot
move the yardstick.
"""
from __future__ import annotations

import torch

CHI_SQ_INV_95 = 9.4877  # 0.95 quantile of chi-square distribution (4 dof)


INF_COST = 1e5


FORBID = 4.5


_UNROLL = 8


def _bias_noise(n: int, device) -> torch.Tensor:
    """The JAX auction's uint32 hash ``(i * 2654435761 + j * 40503) mod
    65536 / 65536`` (only the low 16 bits matter, so int64 math is exact)."""
    ii = torch.arange(n, device=device, dtype=torch.int64)[:, None]
    jj = torch.arange(n, device=device, dtype=torch.int64)[None, :]
    h = (ii * 2654435761 + jj * 40503) % 65536
    return h.to(torch.float32) / 65536.0


def auction_lap_reference(cost: torch.Tensor,
                row_valid: torch.Tensor | None = None,
                col_valid: torch.Tensor | None = None,
                eps_final: float = 1e-3,
                max_iters: int = 10000,
                forbid: float = FORBID):
    """The plain version of ``auction_lap``: the same arguments and
    results, the eps phases and bidding rounds a Python loop over tensor
    ops, one host sync per 8 rounds. A batch ``[B, r, c]`` is solved by one
    bidding loop: a problem whose rows are all assigned bids no more, so
    each gets what it would get alone (``jax.vmap`` of the JAX solver)."""
    if cost.dim() == 2:
        r4c, c4r = auction_lap_reference(
            cost[None], None if row_valid is None else row_valid[None],
            None if col_valid is None else col_valid[None], eps_final,
            max_iters, forbid)
        return r4c[0], c4r[0]
    device = cost.device
    b, r, c = cost.shape
    n = max(r, c, 1)
    if row_valid is None:
        row_valid = torch.ones((b, r), dtype=torch.bool, device=device)
    if col_valid is None:
        col_valid = torch.ones((b, c), dtype=torch.bool, device=device)

    cost_f = torch.clamp(cost.to(torch.float32), max=forbid)
    cost_f = torch.where(row_valid[:, :, None] & col_valid[:, None, :],
                         cost_f, torch.full_like(cost_f, forbid))
    sq = torch.full((b, n, n), forbid, dtype=torch.float32, device=device)
    sq[:, :r, :c] = cost_f
    bias = min(1e-4, 0.25 * eps_final)
    assert eps_final > bias, 'pre-assignment eps-CS needs eps > bias'
    benefit = -sq + bias * _bias_noise(n, device)
    idx = torch.arange(n, device=device)
    jj = idx[None, None, :]
    rows = idx.expand(b, n)

    def scatter_rows(dst):
        """``out[dst[j]] = j`` where ``dst[j] >= 0``, else -1."""
        out = torch.full((b, n + 1), -1, dtype=torch.int64, device=device)
        return out.scatter(1, torch.where(dst >= 0, dst, n), rows)[:, :n]

    # dead rows pre-assigned one-to-one onto dead columns (see the JAX
    # version for why); the dead columns ascending by a stable sort
    finite = sq < forbid
    row_live = torch.any(finite, dim=2)
    col_live = torch.any(finite, dim=1)
    r_rank = torch.cumsum((~row_live).to(torch.int64), 1) - 1
    n_free = (~col_live).sum(1, keepdim=True)
    free_cols = torch.argsort(col_live.to(torch.uint8), dim=1, stable=True)
    free_cols = torch.where(idx[None] < n_free, free_cols,
                            torch.full_like(free_cols, n))
    pre_col = torch.where(~row_live & (r_rank < n_free),
                          free_cols.gather(1, torch.clamp(r_rank, 0, n - 1)),
                          torch.full_like(r_rank, -1))
    owner = scatter_rows(pre_col)
    neg_inf = torch.tensor(-float('inf'), device=device)

    def one_round(owner, price):
        assigned = torch.zeros((b, n + 1), dtype=torch.bool, device=device)
        assigned = assigned.scatter(1, torch.where(owner >= 0, owner, n),
                                    True)
        unassigned = ~assigned[:, :n]
        value = benefit - price[:, None, :]
        v1, top1 = torch.max(value, dim=2)
        value2 = torch.where(jj == top1[:, :, None], neg_inf, value)
        v2 = torch.max(value2, dim=2).values
        v2 = torch.where(torch.isfinite(v2), v2, v1)
        bid_amt = price.gather(1, top1) + (v1 - v2) + eps
        bids = torch.where(unassigned[:, :, None] & (top1[:, :, None] == jj),
                           bid_amt[:, :, None], neg_inf)
        best_bid, best_bidder = torch.max(bids, dim=1)
        won = best_bid > -float('inf')
        return (torch.where(won, best_bidder, owner),
                torch.where(won, best_bid, price))

    eps = 0.5
    while eps >= eps_final:
        # per-phase price reset (see the JAX version)
        price = torch.zeros((b, n), dtype=torch.float32, device=device)
        value = benefit - price[:, None, :]
        vmax = torch.max(value, dim=2).values
        has = owner >= 0
        row_j = torch.where(has, owner, torch.zeros_like(owner))
        pair = value.gather(1, row_j[:, None, :])[:, 0]
        keep = has & (pair >= vmax.gather(1, row_j) - eps)
        owner = torch.where(keep, owner, torch.full_like(owner, -1))
        it = 0
        while it < max_iters and bool(torch.any(owner < 0)):
            for _ in range(_UNROLL):
                owner, price = one_round(owner, price)
            it += _UNROLL
        eps = eps / 8.0

    row4col = owner
    col4row = scatter_rows(row4col)
    pair_col = sq.gather(1, torch.where(row4col >= 0, row4col,
                                        0)[:, None])[:, 0]
    row4col = torch.where((row4col >= 0) & (pair_col < forbid), row4col,
                          torch.full_like(row4col, -1))
    pair_row = sq.gather(2, torch.where(col4row >= 0, col4row, 0)[:, :, None])
    col4row = torch.where((col4row >= 0) & (pair_row[:, :, 0] < forbid),
                          col4row, torch.full_like(col4row, -1))
    return (row4col[:, :c].to(torch.int32),
            col4row[:, :r].to(torch.int32))


def greedy_match_reference(cost: torch.Tensor, row_valid: torch.Tensor,
                           col_valid: torch.Tensor, max_cost: float):
    """The plain version of ``greedy_match_arrays``: one host sync per
    round for the whole batch; a problem whose minimum is above
    ``max_cost`` stops taking matches while the others go on."""
    if cost.dim() == 2:
        r4c, c4r = greedy_match_reference(cost[None], row_valid[None],
                                          col_valid[None], max_cost)
        return r4c[0], c4r[0]
    device = cost.device
    b, r, c = cost.shape
    cost_f = cost.to(torch.float32)
    live = row_valid[:, :, None] & col_valid[:, None, :]
    row4col = torch.full((b, c), -1, dtype=torch.int32, device=device)
    col4row = torch.full((b, r), -1, dtype=torch.int32, device=device)
    ri = torch.arange(r, device=device)
    ci = torch.arange(c, device=device)
    inf = torch.tensor(float('inf'), device=device)
    while True:
        masked = torch.where(live, cost_f, inf).reshape(b, r * c)
        flat = torch.argmin(masked, dim=1)
        ok = masked.gather(1, flat[:, None])[:, 0] <= max_cost
        if not bool(ok.any()):
            break
        i, j = flat // c, flat % c
        row4col = torch.where(ok[:, None] & (ci == j[:, None]),
                              i[:, None].to(torch.int32), row4col)
        col4row = torch.where(ok[:, None] & (ri == i[:, None]),
                              j[:, None].to(torch.int32), col4row)
        live = live & ~(ok[:, None, None]
                        & ((ri[:, None] == i[:, None, None])
                           | (ci[None, :] == j[:, None, None])))
    return row4col, col4row


def eps_phases(eps_final: float) -> int:
    """The eps phases of an auction: 0.5, 0.0625, ... while eps >=
    ``eps_final``."""
    eps, n = 0.5, 0
    while eps >= eps_final:
        n += 1
        eps = eps / 8.0
    return n


def round_cap(max_iters: int) -> int:
    """The bidding rounds a phase runs at most: the plain loop checks
    convergence every 8 rounds while fewer than ``max_iters`` ran."""
    return max(0, -(-int(max_iters) // _UNROLL) * _UNROLL)


def _taken(n: int, idx: torch.Tensor) -> torch.Tensor:
    """[..., n] mask of the entries of ``idx`` [..., m] in [0, n)."""
    idx = torch.where((idx >= 0) & (idx < n), idx,
                      torch.full_like(idx, n)).long()
    out = torch.zeros(idx.shape[:-1] + (n + 1,), dtype=torch.bool,
                      device=idx.device)
    return out.scatter(-1, idx, True)[..., :n]


def cascade_reference(costs, masks, cost_of, exclude, u_det, col4row,
                      eps_final: float = 1e-2, max_iters: int = 10000,
                      forbid: float = FORBID):
    """The plain version of ``cascade_auction``: each stage's
    ``auction_lap_reference`` in turn, its matches absorbed before the
    next."""
    for mask, k, excl in zip(masks, cost_of, exclude):
        row_valid = mask & (col4row < 0) if excl else mask
        _, c4r = auction_lap_reference(costs[k], row_valid, u_det,
                                       eps_final, max_iters, forbid)
        matched = (c4r >= 0) & row_valid
        col4row = torch.where(matched, c4r, col4row)
        u_det = u_det & ~_taken(u_det.shape[-1],
                                torch.where(matched, c4r, -1))
    return u_det, col4row


def fuse_motion(cost: torch.Tensor, m_dist: torch.Tensor,
                m_weight: float) -> torch.Tensor:
    """Blend appearance cost with the chi-square-normalised Mahalanobis
    distance and gate at the 0.95 quantile."""
    fused = (1.0 - m_weight) * cost + m_weight * (m_dist / CHI_SQ_INV_95)
    return torch.where(m_dist > CHI_SQ_INV_95,
                       torch.full_like(fused, INF_COST), fused)


def gate_cost(cost: torch.Tensor, row_labels: torch.Tensor,
              col_labels: torch.Tensor,
              max_cost: float | None = None) -> torch.Tensor:
    """Forbid label mismatches and (optionally) entries above
    ``max_cost``."""
    bad = row_labels[:, None] != col_labels[None, :]
    if max_cost is not None:
        bad = bad | (cost > max_cost)
    return torch.where(bad, torch.full_like(cost, INF_COST), cost)


def greedy_match(problems):
    """Each ``(cost, row_valid, col_valid, max_cost)`` problem's
    ``(row4col, col4row)``."""
    return [greedy_match_reference(*p) for p in problems]


def cascade_auction(costs, masks, cost_of, exclude, u_det, col4row,
                    eps_final: float = 1e-2, max_iters: int = 10000,
                    forbid: float = FORBID):
    return cascade_reference(costs, masks, cost_of, exclude, u_det,
                             col4row, eps_final, max_iters, forbid)
