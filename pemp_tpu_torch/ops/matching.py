"""The matchers of the training labels (counterpart of
pemp_tpu.ops.matching's ``auction_assignment`` and ``greedy_assignment``),
batched over a leading problem axis.

``auction_assignment(sim)`` takes similarities ``sim (P, R, C)``: P
independent problems (the trainer stacks the B images times the two passes
of label method 6), rows = GT joints, columns = detections, entries <= 0
forbidden. It returns ``col_of_row (P, R)`` int64 with -1 for unmatched
rows, lane for lane what the JAX function gives under ``vmap``.
``greedy_assignment`` takes and gives the same (``TPU.MATCHER: greedy``).

The JAX function is one ``lax.while_loop`` per problem; under ``vmap`` the
loop runs while any lane's condition holds and each lane keeps its state
once its own condition fails. The port does the same: every iteration
updates only the lanes whose condition still holds. Converged lanes are
no-ops by design (terminal phases never transition, pemp_tpu/ops/
matching.py:145-147), so running extra iterations changes nothing, and the
loop asks the device whether any lane is still running only every
:data:`CHECK_EVERY` iterations.
"""

from __future__ import annotations

import torch

from pemp_tpu_torch.ops.detection import total_order_key

NEG = -1e9

# Iterations between host checks of convergence. Each check waits for the
# device; between checks the launches stay queued. OKS instances converge
# in a handful of rounds in the quick phase, so 8 wastes at most 7 no-op
# rounds (a few small kernels each) while syncing 8x less often than a
# check every round; exactness does not depend on the interval.
CHECK_EVERY = 8


def greedy_assignment(sim: torch.Tensor) -> torch.Tensor:
    """For each problem of ``sim (P, R, C)``: pick the globally best
    (row, column) pair, remove its row and column, R times
    (pemp_tpu.ops.matching.greedy_assignment). Ties go to the first pair in
    row-major order, as ``jnp.argmax`` of the flattened matrix. Once no
    lane has a positive entry left the remaining rounds change nothing, so
    the loop asks the device every :data:`CHECK_EVERY` rounds and stops."""
    p, r, c = sim.shape
    dev = sim.device
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    s = torch.where(sim > 0, sim.float(), neg)
    col_of_row = torch.full((p, r), -1, dtype=torch.int64, device=dev)
    lanes = torch.arange(p, device=dev)
    for it in range(r):
        if it % CHECK_EVERY == 0 and not bool((s > 0).any()):
            break
        flat = s.reshape(p, r * c).argmax(dim=1)
        i, j = flat // c, flat % c
        good = s[lanes, i, j] > 0
        col_of_row[lanes, i] = torch.where(good, j, col_of_row[lanes, i])
        row_hit = (torch.arange(r, device=dev)[None, :] == i[:, None]) & good[:, None]
        col_hit = (torch.arange(c, device=dev)[None, :] == j[:, None]) & good[:, None]
        s = torch.where(row_hit[:, :, None] | col_hit[:, None, :], neg, s)
    return col_of_row


def _col_of_row_from(row_of_col: torch.Tensor, r: int) -> torch.Tensor:
    """(P, C) owner row of each column -> (P, R) column of each row (-1)."""
    p, c = row_of_col.shape
    owner = torch.where(row_of_col >= 0, row_of_col, torch.full_like(row_of_col, r))
    cols = torch.arange(c, device=row_of_col.device).expand(p, c)
    out = torch.full((p, r + 1), -1, dtype=torch.int64, device=row_of_col.device)
    out.scatter_(1, owner, cols)     # each row owns at most one column
    return out[:, :r]


def _top2(values: torch.Tensor):
    """``lax.top_k(values, 2)`` over the last axis: largest first, equal
    values by lower index (IEEE total order)."""
    keys = total_order_key(values)
    c = values.shape[-1]
    iota = torch.arange(c, device=values.device)
    big = torch.full_like(keys, c, dtype=torch.int64)
    k1 = keys.amax(-1, keepdim=True)
    i1 = torch.where(keys == k1, iota, big).amin(-1, keepdim=True)
    keys2 = keys.scatter(-1, i1, torch.iinfo(torch.int32).min)
    k2 = keys2.amax(-1, keepdim=True)
    i2 = torch.where(keys2 == k2, iota, big).amin(-1, keepdim=True)
    return torch.gather(values, -1, i1)[..., 0], torch.gather(values, -1, i2)[..., 0], i1[..., 0]


def auction_assignment(sim: torch.Tensor, eps: float = 1e-5, max_iters: int = 20000,
                       scaling_phases: int = 8, scaling_factor: float = 8.0) -> torch.Tensor:
    """Jacobi auction with adaptive epsilon scaling, as
    pemp_tpu.ops.matching.auction_assignment (see its docstring), for each
    of the P problems of ``sim (P, R, C)``."""
    p, r, c = sim.shape
    if c < 2:
        raise ValueError("auction_assignment: needs at least 2 columns")
    dev = sim.device
    f32 = torch.float32
    neg = torch.tensor(NEG, dtype=f32, device=dev)
    s = torch.where(sim > 0, sim, neg).to(f32)
    feasible_row = torch.any(s > NEG / 2, dim=2)                          # (P, R)
    row_ids = torch.arange(r, device=dev)
    eps0 = torch.clamp(s.amax(dim=(1, 2)), min=0.0)                     # (P,)
    n_eff = min(r, c)
    quick_budget = min(max_iters, 200)
    last_phase = scaling_phases            # phase 0 = quick, 1..P = scaled

    def eps_of(phase):
        scaled = torch.clamp(eps0 / (scaling_factor ** phase.to(f32)), min=eps)
        terminal = (phase == 0) | (phase >= last_phase)
        return torch.where(terminal, torch.tensor(eps, dtype=f32, device=dev), scaled)

    total_it = torch.zeros(p, dtype=torch.int32, device=dev)
    itp = torch.zeros(p, dtype=torch.int32, device=dev)
    phase = torch.zeros(p, dtype=torch.int32, device=dev)
    prices = torch.zeros((p, c), dtype=f32, device=dev)
    row_of_col = torch.full((p, c), -1, dtype=torch.int64, device=dev)

    it = 0
    while True:
        col_of_row = _col_of_row_from(row_of_col, r)
        best_profit = (s - prices[:, None, :]).amax(dim=2)
        active = (col_of_row < 0) & feasible_row & (best_profit > 0)      # (P, R)
        any_active = active.any(dim=1)
        terminal = (phase == 0) | (phase >= last_phase)
        running = (total_it < max_iters) & (any_active | ~terminal)
        if it % CHECK_EVERY == 0 and not bool(running.any()):
            break
        it += 1

        transition = ((phase == 0) & (itp >= quick_budget) & any_active) | (
            ~any_active & (phase >= 1) & (phase < last_phase))
        phase_eps = eps_of(phase)

        # transition: restart the assignment, keep the prices deflated
        t_prices = torch.clamp(prices - n_eff * phase_eps[:, None] - eps, min=0.0)

        # bid: each active row bids on its best column
        values = s - prices[:, None, :]
        top1, top2, best_j = _top2(values)
        # the outside option (profit 0) caps how far a row will bid
        second = torch.clamp(top2, min=0.0)
        bid = torch.gather(prices, 1, best_j) + (top1 - second) + phase_eps[:, None]
        bid = torch.where(active, bid, neg)
        best_bid = torch.full((p, c), float("-inf"), dtype=f32, device=dev)
        best_bid = best_bid.scatter_reduce(1, best_j, bid, "amax", include_self=True)
        is_winner = active & (bid >= torch.gather(best_bid, 1, best_j) - 1e-12)
        winner_rank = torch.where(is_winner, row_ids, torch.full_like(row_ids, r + 1))
        win_row = torch.full((p, c), torch.iinfo(torch.int64).max, dtype=torch.int64,
                             device=dev)
        win_row = win_row.scatter_reduce(1, best_j, winner_rank.expand(p, r), "amin",
                                         include_self=True)
        col_has_bid = (best_bid > NEG / 2) & (win_row <= r)
        b_row_of_col = torch.where(col_has_bid, win_row, row_of_col)
        b_prices = torch.where(col_has_bid, best_bid, prices)

        # per lane: the transition or the bid, and only while the lane runs
        tr = transition[:, None]
        new_prices = torch.where(tr, t_prices, b_prices)
        new_row_of_col = torch.where(tr, torch.full_like(row_of_col, -1), b_row_of_col)
        run = running[:, None]
        prices = torch.where(run, new_prices, prices)
        row_of_col = torch.where(run, new_row_of_col, row_of_col)
        phase = torch.where(running & transition, phase + 1, phase)
        itp = torch.where(running, torch.where(transition, torch.zeros_like(itp), itp + 1), itp)
        total_it = torch.where(running, total_it + 1, total_it)

    col_of_row = _col_of_row_from(row_of_col, r)
    got = col_of_row >= 0
    simval = torch.gather(sim, 2, torch.clamp(col_of_row, 0, c - 1)[:, :, None])[:, :, 0]
    return torch.where(got & (simval > 0), col_of_row, torch.full_like(col_of_row, -1))
