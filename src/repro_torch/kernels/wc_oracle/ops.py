"""Public wrappers of the WC-oracle kernels (``csrc/wc_oracle.cu``).

``wc_trips(sg, dur, res_of, req, is_canon, tkn, hdtl, run, need, cand)``
runs every trip of a batch of episodes in one launch of the CUDA kernel
``wc_trips`` on CUDA tensors, and its plain version ``wc_trips_ref`` (the
trip loop in PyTorch ops, ref.py) on CPU tensors or when
``backend="torch"``.  It is the oracle's trip loop
(``repro/core/sim_jax.py::_run_trips``).

``wc_step(run, rows, ridx)`` is one trip's running-table step, the twin
of ``repro/kernels/wc_oracle/ops.py::wc_step``: the CUDA kernel
``wc_step`` on CUDA tensors, ``wc_step_ref`` on CPU tensors.  It takes the
(B, R, 6) table as it is: the reference wrapper's transpose to (B, 8, Rp)
and lane padding to 128 are TPU tiling.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import wc_step_ref, wc_trips_ref

BACKENDS = ("torch", "cuda")

# kernel launches in this process (read and reset by chip_smoke.py)
launches = 0           # wc_step
trip_launches = 0      # wc_trips


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown wc_oracle backend {backend!r}; expected "
                         f"one of {BACKENDS}")


def _check(device, specs) -> None:
    """Raise unless each (name, tensor, dtype, shape) is a contiguous
    tensor of that dtype and shape on ``device``."""
    for name, t, dtype, shape in specs:
        if (t.device != device or t.dtype != dtype
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"wc_oracle: {name} must be contiguous {dtype} "
                             f"{shape} on {device}")


def _launch(run, rows, ridx):
    global launches
    B, R, _ = run.shape
    K = ridx.shape[1]
    _check(run.device, (("run", run, torch.float32, (B, R, 6)),
                        ("rows", rows, torch.float32, (B, K, 6)),
                        ("ridx", ridx, torch.int32, (B, K))))
    out = torch.empty_like(run)
    rho = torch.empty(B, dtype=torch.int32, device=run.device)
    e1 = torch.empty(B, dtype=torch.float32, device=run.device)
    if B == 0:
        return out, rho, e1
    if R == 0:
        raise ValueError("wc_oracle: the running table needs R >= 1 rows")
    lib = _build.load("wc_oracle")
    stream = torch.cuda.current_stream(run.device).cuda_stream
    rc = lib.wc_oracle_step(run.data_ptr(), rows.data_ptr(), ridx.data_ptr(),
                            out.data_ptr(), rho.data_ptr(), e1.data_ptr(),
                            B, R, K, stream)
    _build.check("wc_oracle", rc)
    launches += 1
    return out, rho, e1


def wc_step(run: torch.Tensor, rows: torch.Tensor, ridx: torch.Tensor,
            backend: str = "cuda"):
    """run: (B, R, 6) f32 running table; rows: (B, K, 6) f32 start rows;
    ridx: (B, K) int32 target row per start row, -1 drops.
    Returns (run_out (B, R, 6), rho (B,) int32, e1 (B,) f32)."""
    _check_backend(backend)
    if backend == "torch" or run.device.type == "cpu":
        return wc_step_ref(run, rows, ridx)
    if run.device.type != "cuda":
        raise ValueError(f"wc_oracle: unsupported device {run.device}")
    return _launch(run, rows, ridx)


def episode_bytes(n: int, mm: int, R: int, K: int) -> int:
    """Bytes of one episode's state in ``wc_trips`` (its ``carve``): the
    running table, heads, tails and stamps (9 R words), per task key,
    ready time, next, duration and resource (5 N, N = n + mm), per vertex
    indegree and last position (2 n), per edge requirement (mm), the
    candidate list (K), then one byte per edge (canonical flag); rounded
    up to 16."""
    words = 9 * R + 5 * (n + mm) + 2 * n + mm + K
    return -(-(4 * words + mm) // 16) * 16


def placement(nbytes: int, device: torch.device) -> str:
    """Where ``wc_trips`` keeps an episode's state: "shared" when it fits
    the shared memory one block may use on ``device``, else "global" (a
    scratch the wrapper allocates)."""
    limit = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    return "shared" if nbytes <= limit else "global"


def _launch_trips(sg, dur, res_of, req, is_canon, tkn, hdtl, run, need,
                  cand, where):
    global trip_launches
    dev = dur.device
    B, N = dur.shape
    n, R, C, K = sg.n, sg.R, sg.C, sg.K
    mm = N - n

    def i32(t):
        if t.is_floating_point() or t.is_complex():
            raise ValueError(f"wc_oracle: index tensors must be integer, "
                             f"got {t.dtype}")
        return t.to(torch.int32).contiguous()
    res_of, req, is_canon, hdtl, need, cand = map(
        i32, (res_of, req, is_canon, hdtl, need, cand))
    esrc, edst, out_row = map(i32, (sg.esrc, sg.edst, sg.out_row))
    _check(dev, (("dur", dur, torch.float32, (B, N)),
                 ("res_of", res_of, torch.int32, (B, N)),
                 ("req", req, torch.int32, (B, mm)),
                 ("is_canon", is_canon, torch.int32, (B, mm)),
                 ("tkn", tkn, torch.float32, (B, N + 1, 3)),
                 ("hdtl", hdtl, torch.int32, (B, R + 1, 2)),
                 ("run", run, torch.float32, (B, R, 6)),
                 ("need", need, torch.int32, (B, n + 1)),
                 ("cand", cand, torch.int32, (B, K)),
                 ("esrc", esrc, torch.int32, (mm,)),
                 ("edst", edst, torch.int32, (mm,)),
                 ("out_row", out_row, torch.int32, (n, C))))
    ms = torch.empty(B, dtype=torch.float32, device=dev)
    n_done = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return ms, n_done
    nbytes = episode_bytes(n, mm, R, K)
    auto = placement(nbytes, dev)
    where = where or auto
    if where not in ("shared", "global") or (where, auto) == ("shared",
                                                             "global"):
        raise ValueError(f"wc_oracle: cannot place {nbytes} bytes of state "
                         f"per episode in {where!r} memory")
    scratch = torch.empty(B * nbytes if where == "global" else 0,
                          dtype=torch.uint8, device=dev)
    lib = _build.load("wc_oracle")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.wc_oracle_trips(
        dur.data_ptr(), res_of.data_ptr(), req.data_ptr(),
        is_canon.data_ptr(), tkn.data_ptr(), hdtl.data_ptr(), run.data_ptr(),
        need.data_ptr(), cand.data_ptr(), esrc.data_ptr(), edst.data_ptr(),
        out_row.data_ptr(), scratch.data_ptr(), ms.data_ptr(),
        n_done.data_ptr(), B, n, R, C, K, mm, sg.seqw, sg.koff, sg.n_compute,
        sg.n_trips, nbytes, int(where == "global"), stream)
    _build.check("wc_oracle", rc)
    trip_launches += 1
    return ms, n_done


def wc_trips(sg, dur, res_of, req, is_canon, tkn, hdtl, run, need, cand,
             backend: str = "cuda", where: str | None = None):
    """Every trip of the WC oracle for a batch of B episodes.  ``sg`` (a
    ``SimGraph``) carries the static graph and the scalars; per episode:
    dur (B, N) f32, res_of (B, N), req (B, mm), is_canon (B, mm), and the
    initial tkn (B, N + 1, 3) f32, hdtl (B, R + 1, 2), run (B, R, 6) f32,
    need (B, n + 1), cand (B, K); indices of any integer type (the kernel
    takes them as int32).  Returns (ms (B,) f32, n_done (B,) int32).
    ``where`` ("shared" | "global") overrides the kernel's placement of
    the state, which by default follows ``episode_bytes``; "shared" raises
    when the state does not fit."""
    _check_backend(backend)
    if backend == "torch" or dur.device.type == "cpu":
        return wc_trips_ref(sg, dur, res_of, req, is_canon, tkn, hdtl, run,
                            need, cand)
    if dur.device.type != "cuda":
        raise ValueError(f"wc_oracle: unsupported device {dur.device}")
    return _launch_trips(sg, dur, res_of, req, is_canon, tkn, hdtl, run,
                         need, cand, where)
