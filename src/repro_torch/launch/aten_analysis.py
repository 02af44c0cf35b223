"""Collective-byte accounting and roofline terms (twin of
``repro/launch/hlo_analysis.py``).

The reference parses the post-SPMD HLO text for its collectives; here the
collectives are the functional collectives (``_c10d_functional.*``,
``_dtensor.shard_dim_alltoall``) that a trace on a device mesh records
(``aten_static.py``), each with its output's bytes and its group's size
(the walker's ring-model traffic is its own: ``Cost.coll_by_kind``).
``roofline_terms`` and ``model_flops`` are the reference's formulas.
"""
from __future__ import annotations

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


def collective_bytes(records) -> dict:
    """Sum of OUTPUT bytes per collective kind over ``records`` (each a
    mapping with ``kind``, ``out_bytes``, its group's ``group_size`` and
    optionally a ``weight``, the times it ran: one device's collectives,
    as the reference's per-device module), with counts."""
    out = {k: 0.0 for k in COLLECTIVE_OPS}
    counts = {k: 0 for k in COLLECTIVE_OPS}
    for r in records:
        w = r.get("weight", 1)
        out[r["kind"]] += w * float(r["out_bytes"])
        counts[r["kind"]] += w
    return {"bytes": out, "counts": counts,
            "total_bytes": float(sum(out.values()))}


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float, n_chips: int,
                   peak_flops: float = 197e12, hbm_bw: float = 819e9,
                   ici_bw: float = 50e9, per_device: bool = True) -> dict:
    """Three roofline terms in seconds.  If ``per_device``, the inputs are
    already per device and are NOT divided by n_chips.  (The defaults are
    the reference's; the dry-run passes ``mesh.HW_H100``'s.)"""
    div = 1.0 if per_device else float(n_chips)
    t_compute = flops / div / peak_flops
    t_memory = bytes_accessed / div / hbm_bw
    t_collective = coll_bytes / div / ici_bw
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_collective), key=lambda kv: kv[1])[0]
    return {"t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_collective, "dominant": dominant,
            "bound_s": max(t_compute, t_memory, t_collective)}


def model_flops(cfg, n_tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for training;
    2*N*D for a forward-only step (prefill/decode)."""
    n = cfg.active_params_per_token()
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * n_tokens
