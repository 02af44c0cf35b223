"""Plain PyTorch versions of the WC-oracle kernels (twin of
``repro/kernels/wc_oracle/ref.py::wc_step_ref`` and of the trip loop
``_run_trips`` in ``repro/core/sim_jax.py``).

``wc_step_ref``: one trip's running-table step.  Each episode's (R, 6)
running table (columns: end, start trip, ready time, key, task, free):

  1. write the work-conserving start rows (a one-hot masked max-combine
     over the ≤K candidate rows; ``ridx == -1`` drops a row),
  2. pop the earliest completion via the lexicographic
     (end, start trip, ready time, key) argmin, first matching row,
  3. clear the popped row's end time (only if the episode is alive).

The CUDA kernel ``wc_step`` must match this bit for bit on ``run_out`` and
``e1``; ``rho`` only where ``isfinite(e1)``.

``wc_trips_ref``: the whole trip loop, from a batch's initial state to its
makespans (the plain version of the kernel ``wc_trips``).  One trip is one
serial heap pop per episode: the start pass over the candidate resources,
the table step above, then the readiness the completion triggers.  JAX
drops out-of-range scatter updates and clamps out-of-range gathers; torch
raises, so every buffer the reference scatters out of range gets one
trash row: ``tkn`` row N (written by ``_readiness``: ``i_task == N`` for
dead entries, ``link_idx == N`` for no link), ``hdtl`` row R (written by
``_start_pass`` for ``ridx == R`` and ``_readiness`` for dead ``i_res``)
and ``need`` slot n (untriggered out-edges).  Reads the reference clamps
are clamped explicitly.
"""
from __future__ import annotations

import torch

F_BIG = float(2**31 - 1)         # rounds to 2**31 in f32, as in the reference
CHECK_EVERY = 16                 # trips between host checks of the exit


def wc_step_ref(run: torch.Tensor, rows: torch.Tensor, ridx: torch.Tensor):
    """run: (B, R, 6) f32; rows: (B, K, 6) f32; ridx: (B, K) int, -1 drops.
    Returns (run_out (B, R, 6), rho (B,) int32, e1 (B,) f32)."""
    B, R, _ = run.shape
    lane = torch.arange(R, device=run.device)
    hit = ridx[:, :, None].long() == lane[None, None, :]          # (B, K, R)
    written = hit.any(dim=1)                                      # (B, R)
    # duplicate candidates carry identical rows, so max-combine is exact
    val = torch.where(hit[..., None], rows[:, :, None, :],
                      torch.tensor(-torch.inf, device=run.device)
                      ).amax(dim=1)
    run1 = torch.where(written[..., None], val, run)

    end, strip, rdy, key = run1.unbind(-1)[:4]
    e1 = end.amin(dim=1)
    mk = end == e1[:, None]
    s1 = torch.where(mk, strip, F_BIG).amin(dim=1)
    mk &= strip == s1[:, None]
    r1 = torch.where(mk, rdy, torch.inf).amin(dim=1)
    mk &= rdy == r1[:, None]
    k1 = torch.where(mk, key, F_BIG).amin(dim=1)
    mk &= key == k1[:, None]
    # first matching row (0 if none, as the reference's argmax)
    first = torch.where(mk, lane, R).amin(dim=1)
    rho = torch.where(first < R, first, 0).to(torch.int32)
    alive = torch.isfinite(e1)

    clear = alive[:, None] & (lane[None, :] == rho[:, None])
    run_out = run1.clone()
    run_out[..., 0] = torch.where(clear, torch.inf, end)
    return run_out, rho, e1


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-episode gather x[b, idx[b, ...]] for x (B, L, *tail)."""
    B = x.shape[0]
    bi = torch.arange(B, device=x.device).view(B, *([1] * (idx.dim() - 1)))
    return x[bi, idx]


def _start_pass(sg, dur, tkn, hdtl, run, cand, t, ftrip: float):
    """Work-conserving start pass over the candidate resources: a free
    resource starts its queue head (duplicate candidates are idempotent).
    Returns ``ridx`` (``R`` drops the row) and ``rows``; applies the
    queue-head pops to ``hdtl`` in place."""
    R = sg.R
    cc = cand.clamp(max=R - 1)
    crow = _rows(run, cc)                                   # (B, K, 6)
    h = torch.where(cand < R, _rows(hdtl, cc)[..., 0], -1)  # head or -1
    # a resource whose task ends exactly at t counts as free in the serial
    # engine before its completion pops; its slot is still occupied here,
    # so that start waits one trip (same start time, same schedule)
    go = (h >= 0) & (crow[..., 5] <= t[:, None]) & ~torch.isfinite(
        crow[..., 0])
    hh = h.clamp(min=0)
    end_c = t[:, None] + _rows(dur, hh)
    ridx = torch.where(go, cc, R)
    hrow = _rows(tkn, hh)                                   # (B, K, 3)
    rows = torch.stack([end_c, torch.full_like(end_c, ftrip), hrow[..., 1],
                        hrow[..., 0], hh.float(), end_c], dim=2)
    hn = hrow[..., 2].long()
    new_hdtl = torch.stack(
        [hn, torch.where(hn < 0, -1, _rows(hdtl, cc)[..., 1])], dim=2)
    B = cand.shape[0]
    bi = torch.arange(B, device=cand.device)[:, None]
    hdtl[bi, ridx] = new_hdtl                               # R: trash row
    return ridx, rows


def _readiness(sg, is_canon, req, res_of, tkn, hdtl, need, t,
               trip_idx: int, c, c_is_exec, alive):
    """Readiness triggered by completion ``c``, in the completed producer's
    out-edge row (≤C entries), in the serial emission order.  Updates
    ``tkn``, ``hdtl`` and ``need`` in place; returns ``i_res`` (B, C)."""
    n, C, R = sg.n, sg.C, sg.R
    mm = sg.esrc.shape[0]
    N = n + mm
    B = c.shape[0]
    dev = c.device
    bi = torch.arange(B, device=dev)[:, None]
    cpos = torch.arange(C, device=dev)
    cx = (c - n).clamp(0, mm - 1)
    p = torch.where(c_is_exec, c, sg.esrc[cx])              # (B,)
    prow = sg.out_row[p.clamp(0, n - 1)]                    # (B, C)
    pe = prow.clamp(min=0)
    pvalid = (prow >= 0) & alive[:, None]
    ptrig = pvalid & (_rows(req, pe) == c[:, None])
    pdst = sg.edst[pe]
    need.scatter_add_(1, torch.where(ptrig, pdst, n), -ptrig.long())
    # last decrement wins the emission slot: max triggered succ position
    # per destination vertex; parallel edges collapse onto that slot
    samew = pdst[:, :, None] == pdst[:, None, :]
    maxpos = torch.where(samew & ptrig[:, None, :], cpos, -1).amax(2)
    nw = ptrig & (_rows(need, pdst) == 0) & (cpos == maxpos)
    nx = pvalid & c_is_exec[:, None] & _rows(is_canon, pe)
    i_live = nw | nx
    base = n + trip_idx * sg.seqw
    i_task = torch.where(nw, pdst, torch.where(nx, n + pe, N))
    i_key = torch.where(nw, base + maxpos, sg.koff + base + C + cpos)
    i_res = torch.where(i_live, _rows(res_of, i_task.clamp(max=N - 1)), R)
    # within-trip chaining: link each entry to the next entry bound for
    # the same resource; execs and transfers target disjoint resources
    samer = (i_res[:, :, None] == i_res[:, None, :]) & i_live[:, None, :]
    after = samer & (cpos[None, None, :] > cpos[None, :, None])
    succ_k = torch.where(after, cpos, C).amin(2)
    has_succ = succ_k < C
    succ_task = torch.gather(i_task, 1, succ_k.clamp(max=C - 1))
    is_first = ~(samer & (cpos[None, None, :] < cpos[None, :, None])
                 ).any(2) & i_live
    is_last = ~has_succ & i_live
    # one combined row scatter: (key, ready, chain-next) for the new
    # entries plus the tail-append link from each queue's old tail;
    # both sets are disjoint and deduped, dead entries go to trash row N
    rtl = _rows(hdtl, i_res.clamp(max=R - 1))[..., 1]
    link_idx = torch.where(is_first & (rtl >= 0), rtl.clamp(min=0), N)
    link_row = _rows(tkn, link_idx)
    new_rows = torch.stack([
        torch.cat([i_key.float(), link_row[..., 0]], 1),
        torch.cat([t[:, None].expand(B, C), link_row[..., 1]], 1),
        torch.cat([torch.where(has_succ, succ_task, -1).float(),
                   i_task.float()], 1)], dim=2)
    tkn[bi, torch.cat([i_task, link_idx], 1)] = new_rows
    # every live entry writes its resource's FINAL (head, tail) row, so
    # duplicate indices carry identical values; dead ones go to row R
    fst = torch.where(samer & is_first[:, None, :], i_task[:, None, :],
                      -1).amax(2)
    lst = torch.where(samer & is_last[:, None, :], i_task[:, None, :],
                      -1).amax(2)
    old_hd = _rows(hdtl, i_res.clamp(max=R - 1))[..., 0]
    hdtl[bi, torch.where(i_live, i_res, R)] = torch.stack(
        [torch.where(rtl < 0, fst, old_hd), lst], dim=2)
    return i_res


def _next_cand(sg, i_res, rho, alive):
    """Next trip's candidates: resources whose queue gained a task plus the
    resource freed by the pop, padded with R to K."""
    R, K, C = sg.R, sg.K, sg.C
    cand = torch.cat([i_res, torch.where(alive, rho, R)[:, None]], 1)
    if K > C + 1:
        cand = torch.cat([cand, cand.new_full((cand.shape[0], K - C - 1),
                                              R)], 1)
    return cand


def wc_trips_ref(sg, dur, res_of, req, is_canon, tkn, hdtl, run, need,
                 cand):
    """The trip loop: a batch of episodes from its initial state to its
    makespans.  ``sg`` carries the static graph (``esrc``, ``edst``,
    ``out_row``) and the scalars ``n``, ``C``, ``R``, ``K``, ``seqw``,
    ``koff``, ``n_compute``, ``n_trips`` (a ``SimGraph``).  Per episode:
    dur (B, N) f32, res_of (B, N), req (B, mm), is_canon (B, mm); the
    initial tkn (B, N + 1, 3) f32, hdtl (B, R + 1, 2), run (B, R, 6) f32,
    need (B, n + 1) and cand (B, K).  The inputs are not modified.
    Returns (ms (B,) f32, n_done (B,) int32).

    The loop tests its exit every ``CHECK_EVERY`` trips and stops at
    ``n_trips + 1``; trips past an episode's completion (or past a drained
    heap) are no-ops, so the result is decision-exact."""
    n = sg.n
    res_of, req, is_canon = res_of.long(), req.long(), is_canon.bool()
    # the loop updates tkn, hdtl and need in place
    tkn = tkn.clone()
    hdtl, need = (x.to(torch.long, copy=True) for x in (hdtl, need))
    cand = cand.long()
    B = dur.shape[0]
    t = torch.zeros(B, device=dur.device)
    ms = torch.zeros(B, device=dur.device)
    n_done = torch.zeros(B, dtype=torch.long, device=dur.device)
    for trip in range(sg.n_trips + 1):
        if trip % CHECK_EVERY == 0 and not bool(
                (n_done < sg.n_compute).any()):
            break
        ridx, rows = _start_pass(sg, dur, tkn, hdtl, run, cand, t,
                                 float(trip))
        # the table step's drop sentinel is -1, not R
        run, rho, e1 = wc_step_ref(run, rows, torch.where(ridx < sg.R, ridx,
                                                          -1))
        rho = rho.long()
        alive = torch.isfinite(e1)
        c = torch.where(alive, _rows(run, rho[:, None])[:, 0, 4].long(), -1)
        c_is_exec = alive & (c < n)
        t = torch.where(alive, e1, t)
        ms = torch.where(alive, e1, ms)
        n_done = n_done + c_is_exec.long()
        i_res = _readiness(sg, is_canon, req, res_of, tkn, hdtl, need, t,
                           trip, c, c_is_exec, alive)
        cand = _next_cand(sg, i_res, rho, alive)
    return ms, n_done.to(torch.int32)
