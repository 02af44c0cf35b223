"""Copy of ``src/repro/core/trace.py`` (the port imports nothing of ``repro``).

Schedule visualization: export a WC-engine schedule as a Chrome/
Perfetto trace (the paper's Appendix-A utilization plots, as a loadable
artifact instead of a figure).

Usage:
    res = WCSimulator(g, dev).run(assignment, record=True)
    write_chrome_trace("trace.json", res, g)
Open in https://ui.perfetto.dev or chrome://tracing.  Device compute
streams are rows; transfer channels appear as '<src>->< dst>' rows.
"""
from __future__ import annotations

import json

from .graph import DataflowGraph
from .simulator import SimResult


def schedule_to_events(res: SimResult, g: DataflowGraph) -> list[dict]:
    out = []
    for ev in res.events:
        task = ev.task
        if task[0] == "exec":
            _, v, d = task
            vert = g.vertices[v]
            out.append({
                "name": vert.label or f"{vert.kind}#{v}",
                "cat": vert.kind,
                "ph": "X",
                "ts": ev.beg * 1e6,
                "dur": max((ev.end - ev.beg) * 1e6, 0.01),
                "pid": 0,
                "tid": int(d),
                "args": {"vertex": int(v), "flops": float(vert.flops),
                         "meta_op": int(vert.meta_op)},
            })
        else:
            _, v, s, d = task
            vert = g.vertices[v]
            out.append({
                "name": f"xfer {vert.label or v}",
                "cat": "transfer",
                "ph": "X",
                "ts": ev.beg * 1e6,
                "dur": max((ev.end - ev.beg) * 1e6, 0.01),
                "pid": 1,
                "tid": int(s) * 100 + int(d),
                "args": {"vertex": int(v), "bytes": float(vert.out_bytes),
                         "src": int(s), "dst": int(d)},
            })
    return out


def write_chrome_trace(path: str, res: SimResult, g: DataflowGraph) -> None:
    events = schedule_to_events(res, g)
    meta = [
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "device compute"}},
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "transfer channels"}},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events,
                   "displayTimeUnit": "ms"}, f)


def utilization_ascii(res: SimResult, width: int = 60) -> str:
    """Terminal-friendly per-device occupancy bars (Appendix-A style)."""
    lines = []
    util = res.utilization()
    for d, u in enumerate(util):
        bar = "#" * int(round(u * width))
        lines.append(f"dev{d:02d} |{bar:<{width}}| {u*100:5.1f}%")
    lines.append(f"makespan {res.makespan*1e3:.3f} ms, "
                 f"{res.transfer_count} transfers, "
                 f"{res.bytes_moved/1e6:.1f} MB moved")
    return "\n".join(lines)
