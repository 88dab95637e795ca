"""Data-association solvers on torch tensors (port of
``fastmot_tpu/ops/assignment.py``).

``auction_lap`` is the same epsilon-scaling Bertsekas auction: square
padding, forbidden entries clamped to ``forbid`` (4.5), the deterministic
micro-bias, the pre-assignment of dead rows onto dead columns, prices
reset at every phase, and the bidding rounds of each phase until every row
is assigned. ``cascade_auction`` runs a list of such auctions in order, as
the tracker's cascade stages do, each stage absorbing its matches before
the next; ``greedy_match`` runs several greedy global-minimum matchings.
All take a leading batch axis (one problem per stream).

On CUDA tensors the three run the hand-written kernels of
``csrc/assoc_solvers.cu`` (built at first use): the whole cascade of a
call in one launch (``auction_lap`` is a cascade of one stage), all the
greedy problems of a call in another, with no host sync. On CPU tensors
they run the plain versions, ``auction_lap_reference``,
``cascade_reference`` and ``greedy_match_reference``, whose data-dependent
loops run in Python over tensor ops (one host sync per 8 bidding rounds,
and per greedy match); any other device raises. The two agree bit for bit
(tests/test_torch_assoc_solvers.py). ``greedy_finals`` is the tracker's
finals on the card (``tracker.finals_core``): their masks, the rectify
cost and both greedy matches in one launch of the greedy kernel.
``cascade_auction.launches`` and ``greedy_match.launches`` count the two
kernels' launches (the greedy kernel's through either entry);
``greedy_finals.launches`` counts those of the finals entry alone.
"""
from __future__ import annotations

import ctypes
import functools

import torch

CHI_SQ_INV_95 = 9.4877  # 0.95 quantile of chi-square distribution (4 dof)
INF_COST = 1e5
FORBID = 4.5
_UNROLL = 8
KERNEL_MAX_N = 128         # kMaxN in csrc/assoc_solvers.cu
KERNEL_MAX_STAGES = 64     # kMaxStages
KERNEL_MAX_PHASES = 40     # kMaxPhases
KERNEL_MAX_GREEDY = 4096   # kMaxGreedy: a greedy problem's rows or columns
KERNEL_MAX_PROBLEMS = 4    # kMaxProblems

# the two entries' C signature
FORWARD_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]


@functools.cache
def assoc_solvers_library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared once."""
    from .cuda_build import load
    lib = load('assoc_solvers')
    for entry in (lib.cascade_auction_forward, lib.greedy_match_forward,
                  lib.finals_forward):
        entry.argtypes = FORWARD_ARGTYPES
        entry.restype = ctypes.c_int
    lib.assoc_solvers_error_string.argtypes = [ctypes.c_int]
    lib.assoc_solvers_error_string.restype = ctypes.c_char_p
    return lib


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


def _fault(msg):
    raise ValueError(f'assoc_solvers: {msg}')


def _check(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        _fault(f'{name} is not a tensor')
    if t.dtype != dtype:
        _fault(f'{name} is {t.dtype}, expected {dtype}')
    if tuple(t.shape) != shape:
        _fault(f'{name} is {tuple(t.shape)}, expected {shape}')
    if t.device != device:
        _fault(f'{name} is on {t.device}, the costs on {device}')
    return t if t.is_contiguous() else t.contiguous()


def _stream(device):
    return torch._C._cuda_getCurrentRawStream(device.index) \
        if device.type == 'cuda' else None


def cascade_launch_args(costs, masks, cost_of, exclude, u_det, col4row,
                        eps_final: float = 1e-2, max_iters: int = 10000,
                        forbid: float = FORBID, row4col: bool = False,
                        rounds: bool = False):
    """One kernel call as ``cascade_auction_forward`` takes it: ``(outputs,
    args, keep)``. ``costs`` holds one or two cost tensors [S, r, c]
    (float32), ``masks`` a row mask [S, r] (bool) a stage or None (every
    row), ``cost_of`` and ``exclude`` a cost index and a flag a stage;
    ``u_det`` [S, c] (bool) or None (every column), ``col4row`` [S, r]
    (int32) or None (all -1). The outputs are (u_det, col4row, row4col,
    rounds, bids): ``u_det`` only without ``row4col``, ``row4col`` [S, c]
    where asked, and ``rounds`` and ``bids`` [S, K, phases] (the bidding
    rounds of each stage and phase, and the bids made in them) where
    ``rounds`` is asked, else None. On the current CUDA stream for CUDA tensors.
    Raises ValueError on a wrong dtype, shape or device or sizes the kernel
    does not take. ``keep`` holds the inputs the arguments point at (made
    contiguous where they were not): keep it alive while the call runs."""
    if not 1 <= len(costs) <= 2:
        _fault(f'{len(costs)} costs: the kernel takes 1 or 2')
    c0 = costs[0]
    if not isinstance(c0, torch.Tensor) or c0.dim() != 3:
        _fault('costs must be [S, r, c] tensors')
    n_streams, rows, cols = (int(d) for d in c0.shape)
    device = c0.device
    n_stages = len(masks)
    if not (len(cost_of) == len(exclude) == n_stages):
        _fault(f'{n_stages} masks, {len(cost_of)} costs and '
               f'{len(exclude)} exclude flags')
    if not 1 <= n_stages <= KERNEL_MAX_STAGES:
        _fault(f'{n_stages} stages: the kernel takes 1 to '
               f'{KERNEL_MAX_STAGES}')
    if n_streams < 1 or rows < 1 or cols < 1 or \
            max(rows, cols) > KERNEL_MAX_N:
        _fault(f'costs {tuple(c0.shape)}: the kernel takes 1 to '
               f'{KERNEL_MAX_N} rows and columns and a stream at least')
    if any(k not in range(len(costs)) for k in cost_of):
        _fault(f'stage costs {tuple(cost_of)} outside the {len(costs)} '
               'costs')
    bias = min(1e-4, 0.25 * eps_final)
    if not eps_final > bias:
        _fault(f'eps_final {eps_final}: the pre-assignment needs it above '
               f'the micro-bias {bias}')
    n_phases = eps_phases(eps_final)
    if n_phases > KERNEL_MAX_PHASES:
        _fault(f'eps_final {eps_final}: {n_phases} phases, the kernel '
               f'takes {KERNEL_MAX_PHASES}')
    rc, r_only, c_only = (n_streams, rows, cols), (n_streams, rows), \
        (n_streams, cols)
    keep = [_check(c, f'costs[{k}]', torch.float32, rc, device)
            for k, c in enumerate(costs)]
    keep += [None if m is None else
             _check(m, f'masks[{k}]', torch.bool, r_only, device)
             for k, m in enumerate(masks)]
    keep.append(None if u_det is None else
                _check(u_det, 'u_det', torch.bool, c_only, device))
    keep.append(None if col4row is None else
                _check(col4row, 'col4row', torch.int32, r_only, device))
    u_out = None if row4col else torch.empty(c_only, dtype=torch.bool,
                                             device=device)
    c4r_out = torch.empty(r_only, dtype=torch.int32, device=device)
    r4c_out = torch.empty(c_only, dtype=torch.int32, device=device) \
        if row4col else None
    rounds_out, bids_out = (torch.empty(
        (n_streams, n_stages, n_phases), dtype=torch.int32, device=device)
        if rounds else None for _ in range(2))

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    ptrs = [ptr(keep[0]), ptr(keep[1]) if len(costs) == 2 else 0,
            ptr(keep[-2]), ptr(keep[-1]), ptr(u_out), ptr(c4r_out),
            ptr(r4c_out), ptr(rounds_out), ptr(bids_out)]
    ptrs += [ptr(m) for m in keep[len(costs):len(costs) + n_stages]]
    ints = [n_streams, rows, cols, n_stages, n_phases,
            min(round_cap(max_iters), 2 ** 31 - 1),
            *(int(k) for k in cost_of), *(int(bool(e)) for e in exclude)]
    args = ((ctypes.c_uint64 * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * 2)(bias, forbid), _stream(device))
    return (u_out, c4r_out, r4c_out, rounds_out, bids_out), args, keep


def _launch_cascade(args):
    lib = assoc_solvers_library()
    code = lib.cascade_auction_forward(*args)
    if code:
        raise RuntimeError('cascade_auction kernel: '
                           + lib.assoc_solvers_error_string(code).decode())
    cascade_auction.launches += 1


def _device_of(t, name):
    device = t.device
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: unsupported device {device}')
    return device


def cascade_auction(costs, masks, cost_of, exclude, u_det, col4row,
                    eps_final: float = 1e-2, max_iters: int = 10000,
                    forbid: float = FORBID):
    """The auction stages of a cascade in order: stage k solves
    ``auction_lap(costs[cost_of[k]], rows, u_det)`` over the rows of
    ``masks[k]`` (less those already matched where ``exclude[k]``), then
    its matches go into ``col4row`` and their columns leave ``u_det``.
    Returns the new ``(u_det, col4row)``; the inputs are left as they are.

    The costs are [S, r, c] (or [r, c], one stream), a mask [S, r], u_det
    [S, c] bool, col4row [S, r] int32. On CUDA tensors one launch of
    ``csrc/assoc_solvers.cu``'s ``cascade_auction_forward`` for all
    streams and stages (``cascade_launch_args``' checks apply); on CPU
    tensors ``cascade_reference``; any other device raises."""
    device = _device_of(costs[0], 'cascade_auction')
    if device.type == 'cpu':
        return cascade_reference(costs, masks, cost_of, exclude, u_det,
                                 col4row, eps_final, max_iters, forbid)
    if costs[0].dim() == 2:
        u, c = cascade_auction(
            tuple(c[None] for c in costs),
            tuple(None if m is None else m[None] for m in masks), cost_of,
            exclude, u_det[None], col4row[None], eps_final, max_iters,
            forbid)
        return u[0], c[0]
    outputs, args, keep = cascade_launch_args(
        costs, masks, cost_of, exclude, u_det, col4row, eps_final,
        max_iters, forbid)
    _launch_cascade(args)
    return outputs[0], outputs[1]


cascade_auction.launches = 0


def auction_lap(cost: torch.Tensor,
                row_valid: torch.Tensor | None = None,
                col_valid: torch.Tensor | None = None,
                eps_final: float = 1e-3,
                max_iters: int = 10000,
                forbid: float = FORBID):
    """Min-cost rectangular assignment. Returns ``(row4col, col4row)``
    int32 index tensors, -1 where unmatched or matched only through a
    forbidden/padded entry.

    ``cost`` is ``[r, c]`` or a batch ``[B, r, c]`` of independent
    problems (masks ``[B, r]``, ``[B, c]``), each getting what it would get
    alone (``jax.vmap`` of the JAX solver). On CUDA tensors one launch of
    the cascade kernel with one stage; on CPU tensors
    ``auction_lap_reference``; any other device raises."""
    device = _device_of(cost, 'auction_lap')
    if device.type == 'cpu':
        return auction_lap_reference(cost, row_valid, col_valid, eps_final,
                                     max_iters, forbid)
    if cost.dim() == 2:
        r4c, c4r = auction_lap(
            cost[None], None if row_valid is None else row_valid[None],
            None if col_valid is None else col_valid[None], eps_final,
            max_iters, forbid)
        return r4c[0], c4r[0]
    outputs, args, keep = cascade_launch_args(
        (cost.to(torch.float32),), (row_valid,), (0,), (False,), col_valid,
        None, eps_final, max_iters, forbid, row4col=True)
    _launch_cascade(args)
    return outputs[2], outputs[1]


def greedy_launch_args(problems):
    """One kernel call as ``greedy_match_forward`` takes it: ``(outputs,
    args, keep)``. ``problems`` holds up to four ``(cost [S, r, c]
    float32, row_valid [S, r] bool, col_valid [S, c] bool, max_cost)``
    with one S; the outputs are each problem's ``(row4col [S, c], col4row
    [S, r])`` int32. On the current CUDA stream for CUDA tensors. Raises
    ValueError on a wrong dtype, shape or device or sizes the kernel does
    not take; ``keep`` as ``cascade_launch_args``'."""
    if not 1 <= len(problems) <= KERNEL_MAX_PROBLEMS:
        _fault(f'{len(problems)} greedy problems: the kernel takes 1 to '
               f'{KERNEL_MAX_PROBLEMS}')
    device = problems[0][0].device
    n_streams = int(problems[0][0].shape[0])
    ptrs, ints, floats, keep, outputs = [], [n_streams, len(problems)], \
        [], [], []
    for k, (cost, rv, cv, max_cost) in enumerate(problems):
        if not isinstance(cost, torch.Tensor) or cost.dim() != 3 \
                or int(cost.shape[0]) != n_streams:
            _fault(f'problem {k}: cost must be [{n_streams}, r, c]')
        _, rows, cols = (int(d) for d in cost.shape)
        if n_streams < 1 or not (1 <= rows <= KERNEL_MAX_GREEDY
                                 and 1 <= cols <= KERNEL_MAX_GREEDY):
            _fault(f'problem {k}: cost {tuple(cost.shape)}, the kernel '
                   f'takes 1 to {KERNEL_MAX_GREEDY} rows and columns')
        ins = (_check(cost, f'problem {k} cost', torch.float32,
                      (n_streams, rows, cols), device),
               _check(rv, f'problem {k} row_valid', torch.bool,
                      (n_streams, rows), device),
               _check(cv, f'problem {k} col_valid', torch.bool,
                      (n_streams, cols), device))
        outs = (torch.empty((n_streams, cols), dtype=torch.int32,
                            device=device),
                torch.empty((n_streams, rows), dtype=torch.int32,
                            device=device))
        keep += ins
        outputs.append(outs)
        ptrs += [t.data_ptr() for t in ins + outs]
        ints += [rows, cols]
        floats.append(max_cost)
    args = ((ctypes.c_uint64 * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats), _stream(device))
    return outputs, args, keep


def greedy_match(problems):
    """Several greedy matchings at once: ``problems`` holds ``(cost,
    row_valid, col_valid, max_cost)`` tuples as ``greedy_match_arrays``
    takes them, all with a leading stream axis of one size or all without.
    Returns each problem's ``(row4col, col4row)``. On CUDA tensors one
    launch of ``csrc/assoc_solvers.cu``'s ``greedy_match_forward`` for all
    of them (``greedy_launch_args``' checks apply); on CPU tensors
    ``greedy_match_reference`` for each; any other device raises."""
    device = _device_of(problems[0][0], 'greedy_match')
    if device.type == 'cpu':
        return [greedy_match_reference(*p) for p in problems]
    if problems[0][0].dim() == 2:
        return [(r4c[0], c4r[0]) for r4c, c4r in greedy_match(
            [(c[None], rv[None], cv[None], m) for c, rv, cv, m in problems])]
    outputs, args, keep = greedy_launch_args(
        [(c.to(torch.float32), rv, cv, m) for c, rv, cv, m in problems])
    lib = assoc_solvers_library()
    code = lib.greedy_match_forward(*args)
    if code:
        raise RuntimeError('greedy_match kernel: '
                           + lib.assoc_solvers_error_string(code).decode())
    greedy_match.launches += 1
    return outputs


greedy_match.launches = 0


def greedy_match_arrays(cost: torch.Tensor, row_valid: torch.Tensor,
                        col_valid: torch.Tensor, max_cost: float):
    """Greedy global-minimum matching until the cost exceeds ``max_cost``;
    ties go to the smallest flat index. Returns ``(row4col, col4row)``.

    ``cost`` is ``[r, c]`` or a batch ``[B, r, c]``: a problem whose
    minimum is above ``max_cost`` stops taking matches while the others go
    on. ``greedy_match`` of the one problem: the kernel on CUDA tensors,
    ``greedy_match_reference`` on CPU tensors."""
    return greedy_match([(cost, row_valid, col_valid, max_cost)])[0]


def finals_launch_args(conf_thresh: float, max_reid_cost: float,
                       dup_gate: float, confirm_hits: int, tlbrs, t_valid,
                       ages, hits, d_tlbrs, d_conf, reid_cost, h_reid_ok,
                       occluded, u_det, col4row_final):
    """One call of the finals as ``finals_forward`` takes it: ``(outputs,
    args, keep)``. The arguments are ``tracker.finals_reference``'s with a
    leading stream axis S: boxes [S, T, 4] and [S, D, 4] float32, t_valid
    [S, T] bool, ages and hits [S, T] int32, d_conf [S, D] float32,
    reid_cost [S, H, D] float32, h_reid_ok [S, H] bool, occluded and u_det
    [S, D] bool, col4row_final [S, T] int32. The outputs are (u_det_conf [S,
    D] bool, reid_c4r [S, H] int32, rect_c4r [S, T] int32). On the current
    CUDA stream for CUDA tensors. Raises ValueError on a wrong dtype, shape
    or device or sizes the kernel does not take (T <= ``KERNEL_MAX_N``,
    D and H <= ``KERNEL_MAX_GREEDY``); ``keep`` as
    ``cascade_launch_args``'."""
    if not isinstance(tlbrs, torch.Tensor) or tlbrs.dim() != 3:
        _fault('finals: tlbrs must be [S, T, 4]')
    if not isinstance(reid_cost, torch.Tensor) or reid_cost.dim() != 3:
        _fault('finals: reid_cost must be [S, H, D]')
    device = tlbrs.device
    n_streams, t_cap = (int(d) for d in tlbrs.shape[:2])
    h_cap, d_cap = (int(d) for d in reid_cost.shape[1:])
    if n_streams < 1 or not 1 <= t_cap <= KERNEL_MAX_N or \
            not 1 <= d_cap <= KERNEL_MAX_GREEDY or \
            not 1 <= h_cap <= KERNEL_MAX_GREEDY:
        _fault(f'finals: {t_cap} tracks, {d_cap} detections and {h_cap} '
               f'history rows: the kernel takes 1 to {KERNEL_MAX_N} tracks '
               f'and 1 to {KERNEL_MAX_GREEDY} of the others')
    st, sd = (n_streams, t_cap), (n_streams, d_cap)
    keep = [_check(t, name, dtype, shape, device) for t, name, dtype, shape in (
        (tlbrs, 'tlbrs', torch.float32, st + (4,)),
        (t_valid, 't_valid', torch.bool, st),
        (ages, 'ages', torch.int32, st), (hits, 'hits', torch.int32, st),
        (d_tlbrs, 'd_tlbrs', torch.float32, sd + (4,)),
        (d_conf, 'd_conf', torch.float32, sd),
        (reid_cost, 'reid_cost', torch.float32, (n_streams, h_cap, d_cap)),
        (h_reid_ok, 'h_reid_ok', torch.bool, (n_streams, h_cap)),
        (occluded, 'occluded', torch.bool, sd),
        (u_det, 'u_det', torch.bool, sd),
        (col4row_final, 'col4row_final', torch.int32, st))]
    outputs = (torch.empty(sd, dtype=torch.bool, device=device),
               torch.empty((n_streams, h_cap), dtype=torch.int32,
                           device=device),
               torch.empty(st, dtype=torch.int32, device=device))
    ptrs = [t.data_ptr() for t in keep + list(outputs)]
    ints = [n_streams, t_cap, d_cap, h_cap, int(confirm_hits)]
    args = ((ctypes.c_uint64 * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * 3)(conf_thresh, max_reid_cost, dup_gate),
            _stream(device))
    return outputs, args, keep


def greedy_finals(conf_thresh: float, max_reid_cost: float, dup_gate: float,
                  confirm_hits: int, tlbrs, t_valid, ages, hits, d_tlbrs,
                  d_conf, reid_cost, h_reid_ok, occluded, u_det,
                  col4row_final):
    """``tracker.finals_reference`` on CUDA tensors, with or without a
    leading stream axis: the masks, the rectify cost (1 - IoU of each track's
    box and each matched track's detection) and both greedy matches in one
    launch of ``csrc/assoc_solvers.cu``'s greedy kernel (``finals_forward``,
    a block a stream and problem, behind the launch before it by a
    programmatic dependent launch). Returns (u_det_conf, reid_c4r,
    rect_c4r). Raises on CPU tensors (the caller takes the plain version
    there) and on anything ``finals_launch_args`` refuses."""
    if tlbrs.device.type != 'cuda':
        raise ValueError(f'greedy_finals: the kernel takes CUDA tensors, '
                         f'not {tlbrs.device}')
    tensors = (tlbrs, t_valid, ages, hits, d_tlbrs, d_conf, reid_cost,
               h_reid_ok, occluded, u_det, col4row_final)
    one = tlbrs.dim() == 2
    if one:
        tensors = tuple(t[None] for t in tensors)
    outputs, args, keep = finals_launch_args(
        conf_thresh, max_reid_cost, dup_gate, confirm_hits, *tensors)
    lib = assoc_solvers_library()
    code = lib.finals_forward(*args)
    if code:
        raise RuntimeError('greedy finals kernel: '
                           + lib.assoc_solvers_error_string(code).decode())
    greedy_match.launches += 1
    greedy_finals.launches += 1
    return tuple(o[0] for o in outputs) if one else outputs


greedy_finals.launches = 0


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
