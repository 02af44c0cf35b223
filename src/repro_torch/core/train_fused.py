"""Device-resident fused Stage II and Stage I (twin of
``repro/core/train_fused.py``): one training update is one CUDA graph
replay.

The reference's module docstring explains the engine: a recorded sampler
that draws nothing inside its loop, the WC oracle scoring the batch on
the device, a scan-free policy gradient (the candidate masks and device
features are recorded, so every step's log-prob is recomputed in
parallel over steps), and AdamW with the running reward statistics kept
on the device.  The reference traces the update into one ``jit`` and
``lax.scan``s U of them per dispatch.  Here:

* **One update is one function that reads and writes static buffers in
  place** (:class:`FusedStage2`, :class:`FusedStage1`): the parameters,
  AdamW's moments and int32 step, the reward statistics, the episode
  counter, the draw tables and the outputs.  The same function runs
  eagerly (on the CPU, and for the plain twin on the card) and, on the
  card, is captured once as a CUDA graph (``torch.cuda.CUDAGraph``) and
  replayed: nothing inside it reads a value back to the host, and the
  lr, eps and bias corrections are computed on the device from the
  episode counter and the step (``train/optim.py``).  A failed capture
  or replay raises; nothing falls back to eager mode.
* **A dispatch is U replays and one wait**: before each replay the host
  fills the draw buffer (injected step-major tables, the layout of the
  reference's ``_episode_rng_tables``, or fresh draws from the trainer's
  ``torch.Generator``: four calls, no sync) and after it clones the
  outputs; the trainer waits for the device once a dispatch, to read
  the validity flags, makespans and best assignments.  Each dispatch
  copies the trainer's state into the static buffers and clones it back
  out, so the trainer's tensors are never updated in place and a
  dispatch that fails is discarded, as in the reference.
* **Capture**: the first dispatch runs the update once eagerly on a side
  stream (building the kernels' libraries, setting up autograd), then
  captures it; the state is then loaded again, so the warm-up's writes
  are overwritten.  The kernel wrappers count a launch when it is
  recorded, so ``_Graphed.captured`` holds one update's launches and a
  replay launches as many again.
* ``vmap`` over episodes is a written-out batch axis, ``lax.scan`` over
  steps a Python loop (captured whole), ``stop_gradient`` is
  ``detach``.
* **Data parallel** (``n_devices``, the reference's ``shard_map`` /
  ``pmap``): one process a device over the default ``torch.distributed``
  group.  Each rank samples and scores its ``K / N`` episodes of the
  global draw tables, combines the batch moments of the advantages with
  one all-reduce, and the gradient, loss and reward sums with one fused
  all-reduce (a mean) before the same AdamW step on every rank; a
  dispatch ends with one all-gather of its outputs.  With NCCL the
  update's collectives are captured in its CUDA graph.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from ..kernels.gnn_mp import ops as gnn_ops
from ..kernels.wc_oracle import ops as wc_ops
from ..train.optim import AdamState, adamw_update_
from .assign import (BIG, GraphData, _device_features, _etf_update, _gumbel,
                     _State, encode)
from .nn import (apply_mlp, argmax_first, argmin_first, leaky_relu,
                 masked_log_softmax, tree_leaves, tree_map)
from .policies import plc_logits
from .sim_torch import SimGraph, makespan_fifo_batch
from .training import _value_and_grad


@dataclasses.dataclass
class RewardStats:
    """Device twin of DopplerTrainer's running reward statistics: float32
    sums and an int32 count (0-d tensors), updated in place."""
    r_sum: torch.Tensor
    r_sqsum: torch.Tensor
    r_count: torch.Tensor

    @classmethod
    def make(cls, r_sum=0.0, r_sqsum=0.0, r_count=0,
             device: torch.device | str = "cpu") -> "RewardStats":
        def full(x, dtype):
            return torch.full((), x, dtype=dtype, device=device)
        return cls(full(r_sum, torch.float32), full(r_sqsum, torch.float32),
                   full(r_count, torch.int32))

    def tensors(self) -> tuple:
        return self.r_sum, self.r_sqsum, self.r_count

    def baseline(self):
        """(mean, std) with the trainer's exact (0, 1) empty-stats case."""
        cnt = torch.clamp(self.r_count, min=1).float()
        mean = self.r_sum / cnt
        var = torch.clamp(self.r_sqsum / cnt - mean * mean, min=1e-12)
        has = self.r_count > 0
        return (torch.where(has, mean, 0.0),
                torch.where(has, torch.sqrt(var), 1.0))

    def update(self, rs: torch.Tensor) -> None:
        """Add a batch of rewards, in place."""
        self.r_sum.add_(rs.sum())
        self.r_sqsum.add_((rs * rs).sum())
        self.r_count.add_(rs.shape[0])


def kernel_launches() -> dict:
    """The path's kernel wrappers' launch counters."""
    return {"gnn_mp_pair": gnn_ops.pair_launches,
            "wc_oracle_trips": wc_ops.trip_launches}


# ------------------------------------------------- phase 1: record sample
def _sample_scan(params, gd: GraphData, draws, eps, sel_mode: str,
                 plc_mode: str, enc, record: str):
    """Recorded sampling of K episodes on the step-major draw tables
    ``draws = (g_sel (n, K, n), g_plc (n, K, nd), u_sel (n, K), u_plc
    (n, K))``; the picks are ``rollout_batch``'s, so at any eps the
    actions are the reference's on the same tables.  ``enc`` is the
    precomputed ``encode`` output; ``record`` selects the recordings:

    * ``"full"``: per-step SEL softmax rows ``sel_p`` (K, S, n),
      ``sel_lse`` / ``sel_ex`` (K, S) and device features ``x_dev``
      (K, S, nd, F), for :func:`fused_pg_loss`;
    * ``"reduced"``: their sufficient statistics summed over steps,
      ``sel_P`` / ``sel_Q`` (K, n), ``sel_lse_sum`` / ``sel_ex_sum`` (K,),
      and only the episode-dynamic feature columns ``x_dyn``
      (K, S, nd, 5), for :func:`fused_pg_loss_reduced`.
    """
    n, nd = gd.n, gd.nd
    g_sel, g_plc, u_sel, u_plc = draws
    K = g_sel.shape[1]
    H, sel_logits, z_plc = enc
    k = torch.arange(K, device=H.device)
    st = _State.initial(gd, K, H.shape[1])
    dmask = torch.ones(K, nd, dtype=torch.bool, device=H.device)
    n_fleet = gd.dev_x.shape[1]
    steps = {key: [] for key in ("v", "d", "x", "p", "lse", "ex")}
    if record == "reduced":
        sel_P = torch.zeros(K, n, device=H.device)
        sel_Q = torch.zeros(K, n, device=H.device)
        lse_sum = torch.zeros(K, device=H.device)
        ex_sum = torch.zeros(K, device=H.device)
    for s in range(n):
        gs, gp, us, up = g_sel[s], g_plc[s], u_sel[s], u_plc[s]
        cand = ~st.placed & (st.unassigned_preds[:, :n] == 0)
        logp_v = masked_log_softmax(sel_logits.expand(K, n), cand)
        if sel_mode == "cp":
            v = argmax_first(torch.where(cand, gd.t_level, -BIG))
        else:
            # the eps-branch reuses the policy draw's gumbel row
            v = torch.where(us < eps,
                            argmax_first(torch.where(cand, gs, -torch.inf)),
                            argmax_first(logp_v + gs))
        x_dev, ready = _device_features(gd, v, st.placed, st.assigned,
                                        st.est_end, st.device_avail,
                                        st.dev_comp)
        if plc_mode == "etf":
            d = argmin_first(torch.maximum(st.device_avail, ready)
                             + gd.exec_time[v])
        else:
            h_dev = st.dev_hsum / torch.clamp(st.dev_cnt[..., None], min=1.0)
            logp_d = masked_log_softmax(
                plc_logits(params, H[v], h_dev, x_dev, z_plc[v]), dmask)
            d = torch.where(up < eps, argmax_first(gp),
                            argmax_first(logp_d + gp))
        _etf_update(gd, v, d, ready[k, d], st)
        st.dev_hsum[k, d] += H[v]
        st.dev_cnt[k, d] += 1.0
        # the SEL softmax row and scalars that make the SEL loss term
        # linear in sel_logits (see fused_pg_loss)
        p_row = torch.exp(logp_v)
        lse = sel_logits[v] - logp_v[k, v]
        ex = (p_row * torch.where(cand, sel_logits, 0.0)).sum(-1)
        steps["v"].append(v)
        steps["d"].append(d)
        if record == "full":
            steps["x"].append(x_dev)
            steps["p"].append(p_row)
            steps["lse"].append(lse)
            steps["ex"].append(ex)
        else:
            # the trailing fleet columns are gd.dev_x, re-concatenated by
            # the loss
            steps["x"].append(x_dev[..., :-n_fleet])
            sel_P += p_row
            sel_Q += p_row * ex[:, None]
            lse_sum += lse
            ex_sum += ex
    rec = {"actions": torch.stack([torch.stack(steps["v"], 1),
                                   torch.stack(steps["d"], 1)], 2),
           "assignment": st.assigned}
    if record == "full":
        rec.update(x_dev=torch.stack(steps["x"], 1),
                   sel_p=torch.stack(steps["p"], 1),
                   sel_lse=torch.stack(steps["lse"], 1),
                   sel_ex=torch.stack(steps["ex"], 1))
    else:
        rec.update(x_dyn=torch.stack(steps["x"], 1), sel_P=sel_P,
                   sel_Q=sel_Q, sel_lse_sum=lse_sum, sel_ex_sum=ex_sum)
    return rec


@torch.no_grad()
def sample_episodes(params, gd: GraphData, draws, eps,
                    sel_mode: str = "learned", plc_mode: str = "learned",
                    encoder_backend: str = "torch"):
    """K recorded sampling episodes on the step-major ``draws``; returns
    ``actions`` (K, n, 2), ``assignment`` (K, n) and the "full"
    recordings of :func:`_sample_scan`.  ``eps`` is a float or a float32
    tensor."""
    enc = encode(params, gd, encoder_backend)
    return _sample_scan(params, gd, draws, eps, sel_mode, plc_mode, enc,
                        record="full")


# ------------------------------------------- phase 2: parallel log-probs
def _plc_step_logps(params, H, z_plc, nd: int, x_devs, v, d):
    """Per-step PLC log-probs and entropies (K, S), parallel over steps.

    PLC head1 on [H_v || h_dev || y || z_v] is evaluated as split
    matmuls: the H_v / z_v blocks are (n, hid) products gathered per step,
    and the h_dev block commutes with the exclusive prefix sum (the
    product is linear), so the (K, S, nd, 2dh+dy+dz) concat is never
    built.  Shared by the fused REINFORCE and imitation losses."""
    w1 = params["plc_head1"]["layers"][0]
    dh = H.shape[1]
    dy = params["plc_y"]["layers"][-1]["b"].shape[0]
    w = w1["w"]
    w_h, w_hd, w_y, w_z = (w[:dh], w[dh:2 * dh], w[2 * dh:2 * dh + dy],
                           w[2 * dh + dy:])
    GH = H @ w_h + z_plc @ w_z + w1["b"]                # (n, hid)
    GD = H @ w_hd                                       # (n, hid)
    onehot = (d[..., None] == torch.arange(nd, device=d.device)).float()
    contrib = onehot[..., None] * GD[v][:, :, None, :]  # (K, S, nd, hid)
    gsum = torch.cumsum(contrib, 1) - contrib           # exclusive
    cnt = torch.cumsum(onehot, 1) - onehot
    y = apply_mlp(params["plc_y"], x_devs)              # (K, S, nd, dy)
    hid = leaky_relu(GH[v][:, :, None, :]
                     + gsum / torch.clamp(cnt[..., None], min=1.0)
                     + y @ w_y)
    logits_d = apply_mlp(params["plc_head2"], hid)[..., 0]  # (K, S, nd)
    pl = torch.log_softmax(logits_d, -1)
    plc_logp = pl.gather(-1, d[..., None])[..., 0]
    plc_ent = -(torch.exp(pl) * pl).sum(-1)
    return plc_logp, plc_ent


def _parallel_step_logps(params, gd: GraphData, masks, x_devs, actions,
                         sel: bool = True, plc: bool = True,
                         encoder_backend: str = "torch"):
    """Per-step SEL / PLC log-probs and entropies (K, S) of recorded
    episodes (candidate ``masks`` (K, S, n), device features ``x_devs``),
    in parallel over steps; None for a policy left out."""
    H, sel_logits, z_plc = encode(params, gd, encoder_backend)
    v, d = actions[..., 0], actions[..., 1]
    sel_logp = sel_ent = plc_logp = plc_ent = None
    if sel:
        # one masked softmax pass yields the chosen log-prob and the
        # entropy: H(p) = lse - E_p[logits] over the candidate set
        z = torch.where(masks, sel_logits, torch.finfo(sel_logits.dtype).min)
        zmax = z.amax(-1)
        ez = torch.exp(z - zmax[..., None])
        sez = ez.sum(-1)
        lse = torch.log(sez) + zmax
        sel_logp = z.gather(-1, v[..., None])[..., 0] - lse
        sel_ent = lse - torch.where(masks, ez * z, 0.0).sum(-1) / sez
    if plc:
        plc_logp, plc_ent = _plc_step_logps(params, H, z_plc, gd.nd,
                                            x_devs, v, d)
    return sel_logp, sel_ent, plc_logp, plc_ent


def _pg_surrogate(params, gd: GraphData, actions, sel_stats, x_devs, advs,
                  entropy_w, sel_learned: bool, plc_learned: bool,
                  encoder_backend: str):
    """The batch REINFORCE surrogate ``mean(-(adv * logp + w * ent))``
    from recordings.  SEL is linear in the episode-static ``sel_logits``
    x: with the softmax rows recorded at the sampling parameters, its
    summed log-prob is ``x[v].sum - Σ lse - P · dx`` and its mean entropy
    ``ent0 + coeff · dx``, where ``dx = x - x.detach()`` is 0 (exact
    value) with the identity as gradient (exact gradient: ``onehot - p``
    and ``-p (x - E_p[x])``).  ``sel_stats()`` -> (P, Q, Σ_s lse, ent0);
    ``x_devs()`` -> the (K, S, nd, F) device features."""
    H, sel_logits, z_plc = encode(params, gd, encoder_backend)
    v, d = actions[..., 0], actions[..., 1]
    S = v.shape[1]
    logp = ent = 0.0
    if sel_learned:
        P, Q, lse_sum, ent0 = sel_stats()
        x = sel_logits
        x0 = x.detach()
        dx = x - x0                                         # 0-valued
        logp = logp + (x[v].sum(-1) - lse_sum - (P * dx[None, :]).sum(-1))
        coeff = -(P * x0[None, :] - Q) / S
        ent = ent + ent0 + (coeff * dx[None, :]).sum(-1)
    if plc_learned:
        plc_logp, plc_ent = _plc_step_logps(params, H, z_plc, gd.nd,
                                            x_devs(), v, d)
        logp = logp + plc_logp.sum(-1)
        ent = ent + plc_ent.mean(-1)
    return (-(advs * logp + entropy_w * ent)).mean()


def fused_pg_loss(params, gd: GraphData, rec, advs, entropy_w,
                  sel_learned: bool = True, plc_learned: bool = True,
                  encoder_backend: str = "torch"):
    """Batch REINFORCE surrogate on the "full" recordings, all steps in
    parallel: the math of ``training._pg_loss_and_grad_batch``'s forced
    replay without a second |V|-step loop (see :func:`_pg_surrogate`)."""
    def sel_stats():
        p = rec["sel_p"].detach()                           # (K, S, n)
        lse0, ex0 = rec["sel_lse"].detach(), rec["sel_ex"].detach()
        return (p.sum(1), torch.einsum("ksn,ks->kn", p, ex0),
                lse0.sum(-1), (lse0 - ex0).mean(-1))
    return _pg_surrogate(params, gd, rec["actions"], sel_stats,
                         lambda: rec["x_dev"], advs, entropy_w, sel_learned,
                         plc_learned, encoder_backend)


def fused_pg_loss_reduced(params, gd: GraphData, rec, advs, entropy_w,
                          sel_learned: bool = True,
                          plc_learned: bool = True,
                          encoder_backend: str = "torch"):
    """:func:`fused_pg_loss` on the "reduced" recordings: the same math,
    up to float summation order; the device features are rebuilt bit for
    bit from ``x_dyn`` and the fleet columns ``gd.dev_x``."""
    S = rec["actions"].shape[1]

    def sel_stats():
        lse_sum = rec["sel_lse_sum"].detach()
        return (rec["sel_P"].detach(), rec["sel_Q"].detach(), lse_sum,
                (lse_sum - rec["sel_ex_sum"].detach()) / S)

    def x_devs():
        x_dyn = rec["x_dyn"]
        return torch.cat([x_dyn, gd.dev_x.expand(*x_dyn.shape[:3], -1)], -1)
    return _pg_surrogate(params, gd, rec["actions"], sel_stats, x_devs, advs,
                         entropy_w, sel_learned, plc_learned,
                         encoder_backend)


# ----------------------------------------------------------- the runner
class _Graphed:
    """``fn`` (an update on static buffers, in place), run eagerly or, with
    ``capture``, as one CUDA graph.  :meth:`prepare` warms ``fn`` up once
    on a side stream and captures it; the buffers then hold the warm-up's
    writes, which the caller overwrites.  ``captured``: the kernel
    launches the capture recorded, which every replay launches again;
    ``seconds``: the warm-up's and the capture's wall time."""

    def __init__(self, fn, device: torch.device, capture: bool):
        if capture and device.type != "cuda":
            raise ValueError(f"CUDA graph capture needs a CUDA device, not "
                             f"{device}")
        self.fn, self.device, self.capture = fn, device, capture
        self.graph: torch.cuda.CUDAGraph | None = None
        self.captured: dict = {}
        self.replays = 0
        self.seconds: dict = {}

    @property
    def pending(self) -> bool:
        return self.capture and self.graph is None

    def prepare(self) -> None:
        dev = self.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = kernel_launches()
        with torch.cuda.graph(graph):
            self.fn()
        self.captured = {k: v - before[k]
                         for k, v in kernel_launches().items()}
        torch.cuda.synchronize(dev)
        self.graph = graph
        self.seconds = {"warmup": t1 - t0,
                        "capture": time.perf_counter() - t1}

    def __call__(self) -> None:
        if self.capture:
            self.graph.replay()
            self.replays += 1
        else:
            self.fn()


def _copy_tree_(dst, src) -> None:
    for a, b in zip(tree_leaves(dst), tree_leaves(src)):
        a.copy_(b)


def _clone(tree):
    return tree_map(torch.clone, tree)


class _Engine:
    """What both fused engines share: the static parameter / AdamW /
    episode buffers, the graph, and the copies in and out of a dispatch."""

    def __init__(self, gd: GraphData, lr_sched, capture: bool):
        self.gd, self.lr_sched = gd, lr_sched
        self.device = gd.x.device
        self.graphed = _Graphed(self._update, self.device, capture)
        self.params = None

    def _alloc(self, params) -> None:
        """Static buffers shaped like ``params`` (once)."""
        if self.params is not None:
            return
        zeros = tree_map(torch.zeros_like, params)
        self.params, self.mu, self.nu, self.grads = (
            zeros, _clone(zeros), _clone(zeros), _clone(zeros))
        self.step = torch.zeros((), dtype=torch.int32, device=self.device)
        self.episode = torch.zeros((), dtype=torch.int32, device=self.device)
        self.loss = torch.zeros((), device=self.device)
        self._alloc_more()

    def _load(self, params, opt_state: AdamState, episode: int) -> None:
        _copy_tree_(self.params, params)
        _copy_tree_(self.mu, opt_state.mu)
        _copy_tree_(self.nu, opt_state.nu)
        self.step.fill_(int(opt_state.step))
        self.episode.fill_(int(episode))

    def _adamw(self, grads, loss, lr) -> None:
        adamw_update_(grads, AdamState(self.step, self.mu, self.nu),
                      self.params, lr)
        _copy_tree_(self.grads, grads)
        self.loss.copy_(loss)

    def _run(self, load, fill, u: int, keep) -> tuple[list, dict]:
        """``load()`` the state, then ``u`` updates, ``fill(i)`` filling
        update i's inputs before it; -> (``keep()`` after each update,
        the warm-up and capture seconds of this call)."""
        seconds = {}
        if self.graphed.pending:
            load()
            self.graphed.prepare()
            seconds = dict(self.graphed.seconds)
        load()
        kept = []
        for i in range(u):
            fill(i)
            self.graphed()
            kept.append(keep())
        return kept, seconds

    def _state_out(self, opt_state: AdamState, u: int) -> dict:
        return {"params": _clone(self.params),
                "opt_state": AdamState(int(opt_state.step) + u,
                                       _clone(self.mu), _clone(self.nu)),
                "grads": _clone(self.grads)}


# --------------------------------------------------------- fused updates
@dataclasses.dataclass(frozen=True)
class FusedStage2Config:
    """Static configuration of one fused Stage II dispatch.

    ``encoder_backend`` routes the GNN aggregation and ``oracle_backend``
    the reward oracle's trip loop ("torch": the plain versions; "cuda":
    the ``gnn_mp`` pair and ``wc_trips`` kernels).  ``chunk_size`` bounds
    the working set at large batch: the batch is sampled and scored in
    micro-chunks of this size (None auto-chunks above AUTO_CHUNK
    episodes, chunks of at most AUTO_CHUNK_CAP; 0 forces the monolithic
    engine); ``grad_chunk_size`` is the gradient-accumulation micro-chunk
    (None: auto, at most 64), which equals the monolithic gradient up to
    float summation order.  ``updates`` is the length of a dispatch; a
    graph holds one update, so configurations that differ only in
    ``updates`` share it (:meth:`graph_key`)."""
    batch_size: int
    updates: int
    sel_mode: str = "learned"
    plc_mode: str = "learned"
    sel_learned: bool = True
    plc_learned: bool = True
    normalize_adv: bool = True
    entropy_weight: float = 1e-2
    encoder_backend: str = "torch"
    oracle_backend: str = "torch"
    chunk_size: int | None = None
    grad_chunk_size: int | None = None

    def graph_key(self) -> "FusedStage2Config":
        return dataclasses.replace(self, updates=0)


def _largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (>= 1)."""
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


# auto-chunk threshold: batches up to AUTO_CHUNK episodes stay on the
# monolithic engine; larger ones switch to the reduced recordings, sampled
# and scored in micro-chunks of at most AUTO_CHUNK_CAP episodes
AUTO_CHUNK = 64
AUTO_CHUNK_CAP = 128


class FusedStage2(_Engine):
    """The fused Stage II engine of one configuration (what
    :func:`build_fused_stage2` returns).  Calling it runs one dispatch;
    ``graphed`` is its CUDA graph (or its eager runner)."""

    def __init__(self, cfg: FusedStage2Config, gd: GraphData, sg: SimGraph,
                 lr_sched, eps_sched, capture: bool, group=None):
        super().__init__(gd, lr_sched, capture)
        self.cfg, self.sg, self.eps_sched = cfg, sg, eps_sched
        # data parallel: this rank's block of the batch (its episodes of
        # the global draw tables), or the whole batch on one device
        self.group = group
        self.n_ranks = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        kb = self.kb = cfg.batch_size // self.n_ranks
        self.shard = slice(rank * kb, (rank + 1) * kb)
        if cfg.chunk_size is None:
            sc = _largest_divisor(kb, AUTO_CHUNK_CAP) if kb > AUTO_CHUNK \
                else None
        elif cfg.chunk_size <= 0:
            sc = None
        else:
            if kb % cfg.chunk_size:
                raise ValueError(f"chunk_size {cfg.chunk_size} does not "
                                 f"divide the per-device batch {kb}")
            sc = cfg.chunk_size
        gc = None
        if sc is not None:
            gc = cfg.grad_chunk_size or _largest_divisor(kb, min(sc, 64))
            if kb % gc:
                raise ValueError(f"grad_chunk_size {gc} does not divide "
                                 f"the per-device batch {kb}")
        self.sample_chunk, self.grad_chunk = sc, gc

    def _alloc_more(self) -> None:
        n, nd, K, dev = self.gd.n, self.gd.nd, self.kb, self.device
        self.rstats = RewardStats.make(device=dev)
        self.n_ranks_t = torch.full((), float(self.n_ranks), device=dev)
        self.draws = (torch.zeros(n, K, n, device=dev),
                      torch.zeros(n, K, nd, device=dev),
                      torch.zeros(n, K, device=dev),
                      torch.zeros(n, K, device=dev))
        self.out = {"makespans": torch.zeros(K, device=dev),
                    "oracle_ok": torch.zeros(K, dtype=torch.bool, device=dev),
                    "best_assignment": torch.zeros(n, dtype=torch.long,
                                                   device=dev),
                    "actions": torch.zeros(K, n, 2, dtype=torch.long,
                                           device=dev),
                    "advantages": torch.zeros(K, device=dev)}

    # ---- the update: static buffers in, static buffers out
    def _advantages(self, rs):
        """Running-baseline advantages (the batch mean while the stats are
        empty), normalised by max(running std, batch population std).
        Over ranks the batch's mean and mean square are each the mean of
        the ranks' (one all-reduce), its std sqrt(max(E[r^2] - E[r]^2,
        0)), as the reference's sharded update takes them."""
        mean, std = self.rstats.baseline()
        if self.n_ranks > 1:
            moments = torch.stack([rs.mean(), (rs * rs).mean()])
            dist.all_reduce(moments, group=self.group)
            batch_mean, batch_sq = moments / self.n_ranks_t
            batch_std = torch.sqrt(torch.clamp(
                batch_sq - batch_mean * batch_mean, min=0.0))
        else:
            batch_mean, batch_std = rs.mean(), rs.std(correction=0)
        advs = rs - torch.where(self.rstats.r_count > 0, mean, batch_mean)
        if self.cfg.normalize_adv:
            advs = advs / (torch.maximum(std, batch_std) + 1e-9)
        return advs

    def _all_reduce(self, grads, loss, rs):
        """The group's mean of the gradient, the loss and the reward sums
        in ONE all-reduce; the reward statistics take the global batch's
        sums and count -> (grads, loss)."""
        leaves = tree_leaves(grads)
        flat = torch.cat([g.reshape(-1) for g in leaves]
                         + [torch.stack([loss, rs.sum(), (rs * rs).sum()])])
        dist.all_reduce(flat, group=self.group)
        flat = flat / self.n_ranks_t
        pieces = dict(zip(map(id, leaves), torch.split(
            flat[:-3], [g.numel() for g in leaves])))
        st = self.rstats
        st.r_sum.add_(flat[-2] * self.n_ranks_t)
        st.r_sqsum.add_(flat[-1] * self.n_ranks_t)
        st.r_count.add_(self.cfg.batch_size)
        return tree_map(lambda g: pieces[id(g)].view_as(g), grads), flat[-3]

    def _score(self, rec):
        """-> makespans, ok, masked rewards of a recorded batch."""
        ms, ok = makespan_fifo_batch(self.sg, rec["assignment"],
                                     self.cfg.oracle_backend)
        return ms, ok, torch.where(ok, -ms, 0.0)

    def _loss(self, fn, rec, advs):
        cfg = self.cfg
        return _value_and_grad(
            lambda p: fn(p, self.gd, rec, advs, cfg.entropy_weight,
                         cfg.sel_learned, cfg.plc_learned,
                         cfg.encoder_backend), self.params)

    def _update(self) -> None:
        cfg, gd = self.cfg, self.gd
        eps = self.eps_sched(self.episode)
        lr = self.lr_sched(self.episode)
        with torch.no_grad():
            enc = encode(self.params, gd, cfg.encoder_backend)
            if self.sample_chunk is None:
                rec = _sample_scan(self.params, gd, self.draws, eps,
                                   cfg.sel_mode, cfg.plc_mode, enc, "full")
                ms, ok, rs = self._score(rec)
            else:
                sc = self.sample_chunk
                parts = []
                for c in range(self.kb // sc):
                    sl = slice(c * sc, (c + 1) * sc)
                    r = _sample_scan(self.params, gd,
                                     [t[:, sl] for t in self.draws], eps,
                                     cfg.sel_mode, cfg.plc_mode, enc,
                                     "reduced")
                    parts.append((r, *self._score(r)))
                rec = {key: torch.cat([p[0][key] for p in parts])
                       for key in parts[0][0]}
                ms, ok, rs = (torch.cat([p[i] for p in parts])
                              for i in (1, 2, 3))
            advs = torch.where(ok, self._advantages(rs), 0.0)
        if self.sample_chunk is None:
            loss, grads = self._loss(fused_pg_loss, rec, advs)
        else:
            gc = self.grad_chunk
            ngc = self.kb // gc
            gsum = lsum = None
            for c in range(ngc):
                sl = slice(c * gc, (c + 1) * gc)
                loss_c, g_c = self._loss(
                    fused_pg_loss_reduced,
                    {key: val[sl] for key, val in rec.items()}, advs[sl])
                gsum = g_c if gsum is None else tree_map(torch.add, gsum,
                                                         g_c)
                lsum = loss_c if lsum is None else lsum + loss_c
            # equal chunk sizes: the mean of chunk means is the batch mean
            grads = tree_map(lambda g: g / ngc, gsum)
            loss = lsum / ngc
        if self.group is None:
            self.rstats.update(rs)
        else:
            grads, loss = self._all_reduce(grads, loss, rs)
        self._adamw(grads, loss, lr)
        self.episode.add_(cfg.batch_size)
        best = argmin_first(torch.where(ok, ms, torch.inf))
        out = self.out
        out["makespans"].copy_(ms)
        out["oracle_ok"].copy_(ok)
        out["best_assignment"].copy_(
            rec["assignment"].index_select(0, best.reshape(1))[0])
        out["actions"].copy_(rec["actions"])
        out["advantages"].copy_(advs)

    # ---- a dispatch
    def _fill_draws(self, src, pinned: list) -> None:
        """The draw buffer from ``src``: injected tables, or fresh draws
        from a ``torch.Generator`` (gumbel = -log(-log U)); both are the
        global batch's, of which a rank takes its episodes' columns."""
        if isinstance(src, torch.Generator):
            for buf, gumbel in zip(self.draws, (True, True, False, False)):
                shape = buf.shape[:1] + (self.cfg.batch_size,) + \
                    buf.shape[2:]
                t = _gumbel(src, shape) if gumbel else torch.empty(
                    shape, device=buf.device).uniform_(generator=src)
                buf.copy_(t[:, self.shard])
            return
        for buf, x in zip(self.draws, src):
            t = torch.as_tensor(x)[:, self.shard]
            if t.device.type == "cpu" and buf.device.type == "cuda":
                # an asynchronous copy, kept alive
                t = t.contiguous().pin_memory()
                pinned.append(t)
            buf.copy_(t, non_blocking=True)

    def __call__(self, params, opt_state: AdamState, rstats: RewardStats,
                 episode: int, draws, updates: int | None = None) -> dict:
        """``updates`` (default ``cfg.updates``) fused updates from
        (params, opt_state, rstats, episode); ``draws``: one set of
        step-major tables per update, or a ``torch.Generator``.  Returns
        device tensors, nothing waited for: the new state (clones),
        ``makespans`` / ``oracle_ok`` (U, K),
        ``best_assignments`` (U, n), ``losses`` (U,), the last update's
        ``actions``, ``advantages`` and ``grads``, and ``seconds`` (the
        warm-up and capture of a first call on the card)."""
        u = self.cfg.updates if updates is None else updates
        self._alloc(params)
        pinned: list = []
        self._staged = pinned           # alive until the caller's wait

        def load():
            self._load(params, opt_state, episode)
            for a, b in zip(self.rstats.tensors(), rstats.tensors()):
                a.copy_(b)

        def fill(i):
            self._fill_draws(draws if isinstance(draws, torch.Generator)
                             else draws[i], pinned)

        def keep():
            o = self.out
            return (o["makespans"].clone(), o["oracle_ok"].clone(),
                    o["best_assignment"].clone(), self.loss.clone())

        kept, seconds = self._run(load, fill, u, keep)
        ms, ok, best, losses = (torch.stack(x) for x in zip(*kept))
        actions, advs = (self.out[k].clone() for k in ("actions",
                                                       "advantages"))
        if self.group is not None:
            ms, ok, best, actions, advs = self._gather(ms, ok, best,
                                                       actions, advs)
        return {**self._state_out(opt_state, u),
                "rstats": RewardStats(*(t.clone()
                                        for t in self.rstats.tensors())),
                "makespans": ms, "oracle_ok": ok, "best_assignments": best,
                "losses": losses, "actions": actions, "advantages": advs,
                "seconds": seconds}

    def _gather(self, ms, ok, best, actions, advs):
        """The ranks' outputs of a dispatch in ONE all-gather (packed in
        float64, exact for all of them): makespans and flags (U, K) and
        the last update's actions and advantages (K, ...), the ranks'
        blocks in rank order; each update's best assignment the one of
        the rank whose own best valid makespan is lowest (ties to the
        lower rank), as the reference's sharded dispatch returns them."""
        U, kb, N = ms.shape[0], self.kb, self.n_ranks
        parts = (ms, ok, best, actions, advs)
        packed = torch.cat([t.reshape(-1).double() for t in parts])
        got = [torch.empty_like(packed) for _ in range(N)]
        dist.all_gather(got, packed, group=self.group)
        sizes = [t.numel() for t in parts]
        cols = [torch.stack(x) for x in zip(*(torch.split(g, sizes)
                                              for g in got))]
        ms_r = cols[0].view(N, U, kb).float()
        ok_r = cols[1].view(N, U, kb).bool()
        best_r = cols[2].view(N, U, -1).long()
        own = torch.where(ok_r, ms_r, torch.inf).amin(2)      # (N, U)
        win = argmin_first(own.T)                              # (U,)
        return (ms_r.permute(1, 0, 2).reshape(U, N * kb),
                ok_r.permute(1, 0, 2).reshape(U, N * kb),
                best_r[win, torch.arange(U, device=win.device)],
                cols[3].view((N * kb,) + actions.shape[1:]).long(),
                cols[4].view(N * kb).float())


def build_fused_stage2(cfg: FusedStage2Config, gd: GraphData, sg: SimGraph,
                       lr_sched, eps_sched, n_devices: int | None = None,
                       capture: bool = False,
                       spmd: str = "shard_map") -> FusedStage2:
    """The fused Stage II engine: each update replays the reference
    path's bookkeeping exactly (eps and lr at the episode counter from
    before the update; the running baseline, or the batch mean while the
    statistics are empty; the ``max(running std, batch std) + 1e-9``
    normaliser; advantages masked to 0 where the oracle did not converge;
    the statistics updated after the gradient; the best valid assignment
    chosen on the device).  ``capture``: replay each update as one CUDA
    graph.  With ``chunk_size`` the batch is sampled and scored in
    micro-chunks (reduced recordings, one ``wc_trips`` launch each), the
    advantages taken over the whole batch, and the gradient accumulated
    over ``grad_chunk_size`` chunks; the sampled episodes are the
    monolithic engine's.

    ``n_devices`` N runs the reference's data-parallel semantics over the
    default ``torch.distributed`` process group, which the caller
    initializes with world size N (one process a device): each rank
    takes episodes [r K/N, (r + 1) K/N) of the global draws, and every
    rank returns the same result.  None, or 1 without a group, is the
    single-device engine; 1 over a group of one rank runs the
    collectives on their own (a mean over one rank: the same bits).
    ``spmd`` ("shard_map" or "pmap", the reference's two lowerings) is
    validated as the reference does; both run the same code here."""
    if spmd not in ("shard_map", "pmap"):
        raise ValueError(f"unknown spmd mode {spmd!r}")
    if capture and cfg.oracle_backend != "cuda":
        raise ValueError("capture needs oracle_backend='cuda': the plain "
                         "trip loop checks its exit on the host")
    group = None
    if n_devices is not None:
        if n_devices < 1 or cfg.batch_size % n_devices:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible "
                             f"by {n_devices} devices")
        if dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
            if dist.get_world_size(group) != n_devices:
                raise ValueError(
                    f"n_devices {n_devices} over a process group of "
                    f"{dist.get_world_size(group)} ranks")
        elif n_devices > 1:
            raise ValueError(
                f"n_devices {n_devices} needs the default torch.distributed "
                f"process group initialized with world size {n_devices}")
        if group is not None and capture \
                and dist.get_backend(group) != "nccl":
            raise ValueError(
                f"capture needs collectives a CUDA graph can hold (nccl), "
                f"not {dist.get_backend(group)!r}")
    return FusedStage2(cfg, gd, sg, lr_sched, eps_sched, capture, group)


# ----------------------------------------------------- fused imitation
class FusedStage1(_Engine):
    """The fused Stage I engine (what :func:`build_fused_stage1`
    returns): :meth:`replay_dynamics` derives the teacher episodes'
    parameter-free candidate masks and device features once, eagerly;
    each update is the step-parallel NLL of ``batch_size`` of them plus
    the device AdamW, replayed as one CUDA graph with ``capture``."""

    def __init__(self, gd: GraphData, lr_sched, batch_size: int,
                 encoder_backend: str, capture: bool):
        super().__init__(gd, lr_sched, capture)
        self.batch_size, self.encoder_backend = batch_size, encoder_backend

    def _alloc_more(self) -> None:
        gd, B = self.gd, self.batch_size
        F = gd.dev_x.shape[1] + 5
        self.masks = torch.zeros(B, gd.n, gd.n, dtype=torch.bool,
                                 device=self.device)
        self.x_devs = torch.zeros(B, gd.n, gd.nd, F, device=self.device)
        self.actions = torch.zeros(B, gd.n, 2, dtype=torch.long,
                                   device=self.device)

    @torch.no_grad()
    def replay_dynamics(self, actions: torch.Tensor):
        """(E, n, 2) teacher actions -> candidate masks (E, n, n) and
        device features x_dev (E, n, nd, F), step by step."""
        gd = self.gd
        E, n = actions.shape[0], gd.n
        k = torch.arange(E, device=self.device)
        st = _State.initial(gd, E, 1)
        masks, x_devs = [], []
        for s in range(n):
            v, d = actions[:, s, 0], actions[:, s, 1]
            masks.append(~st.placed & (st.unassigned_preds[:, :n] == 0))
            x_dev, ready = _device_features(gd, v, st.placed, st.assigned,
                                            st.est_end, st.device_avail,
                                            st.dev_comp)
            x_devs.append(x_dev)
            _etf_update(gd, v, d, ready[k, d], st)
        return torch.stack(masks, 1), torch.stack(x_devs, 1)

    def _update(self) -> None:
        lr = self.lr_sched(self.episode)

        def imitation_loss(p):
            # -(mean SEL log-prob + mean PLC log-prob): the step-parallel
            # twin of _imitation_loss_and_grad
            sel_logp, _, plc_logp, _ = _parallel_step_logps(
                p, self.gd, self.masks, self.x_devs, self.actions,
                encoder_backend=self.encoder_backend)
            return -(sel_logp.mean() + plc_logp.mean())

        loss, grads = _value_and_grad(imitation_loss, self.params)
        self._adamw(grads, loss, lr)
        self.episode.add_(self.batch_size)

    def __call__(self, params, opt_state: AdamState, episode: int, masks,
                 x_devs, actions) -> dict:
        """Imitation updates over E = U * batch_size teacher episodes
        (``replay_dynamics``'s outputs and the (E, n, 2) actions), update
        i on episodes [i B, (i + 1) B).  Returns device tensors, nothing
        waited for: the new state (clones), ``losses`` (U,), the last
        update's ``grads``, ``seconds`` (warm-up and capture)."""
        B = self.batch_size
        u = actions.shape[0] // B
        self._alloc(params)

        def fill(i):
            sl = slice(i * B, (i + 1) * B)
            self.masks.copy_(masks[sl])
            self.x_devs.copy_(x_devs[sl])
            self.actions.copy_(actions[sl])

        kept, seconds = self._run(
            lambda: self._load(params, opt_state, episode), fill, u,
            self.loss.clone)
        return {**self._state_out(opt_state, u), "losses": torch.stack(kept),
                "seconds": seconds}


def build_fused_stage1(gd: GraphData, lr_sched, batch_size: int,
                       encoder_backend: str = "torch",
                       capture: bool = False) -> FusedStage1:
    """The fused Stage I engine: ``batch_size`` teacher episodes an
    update.  The reference's ``updates`` (its scan length) is the number
    of episodes given over ``batch_size``; its ``fori_loop`` over keys
    has no counterpart (the port's trainer has no key)."""
    return FusedStage1(gd, lr_sched, batch_size, encoder_backend, capture)
