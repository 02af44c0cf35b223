"""Copy of ``src/repro/core/graph.py`` (the port imports nothing of ``repro``).

Dataflow-graph IR for DOPPLER.

A :class:`DataflowGraph` is the static graph G = (V, E) of §2 of the paper:
vertices are computations (kernel calls), directed edges are data
dependencies.  Each vertex carries a compute cost (FLOPs) and the byte size
of its output tensor; each edge's communication cost is the producer's
output bytes (times a calibration factor, applied in features.py).

Vertices are additionally tagged with a *meta-op* id and a role
('shard' | 'reduce' | 'input') so that the EnumerativeOptimizer baseline
(Appendix B) can recover the sharded-op structure.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

# Vertex kinds from Appendix A.1 of the paper.
VERTEX_KINDS = (
    "input",
    "matmul",
    "input_elemwise",
    "straight_elemwise",
    "bcast_elemwise",
    "max_reduction",
    "min_reduction",
    "sum_reduction",
    "product_reduction",
    "formation",
    "complexer",
    "fill",
    "squeezer",
    "select",
)


@dataclasses.dataclass
class Vertex:
    vid: int
    kind: str
    flops: float            # floating point ops to execute this vertex
    out_bytes: float        # bytes of the output tensor
    meta_op: int = -1       # meta-op group (EnumOpt); -1 = ungrouped
    role: str = "shard"     # 'shard' | 'reduce' | 'input'
    label: str = ""
    out_shape: tuple = ()   # concrete output shape (real executor payloads)

    def __post_init__(self):
        if self.kind not in VERTEX_KINDS:
            raise ValueError(f"unknown vertex kind {self.kind!r}")
        if self.kind == "input":
            self.role = "input"


class DataflowGraph:
    """Immutable-after-freeze DAG with cached adjacency and topo order."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.vertices: list[Vertex] = []
        self.edges: list[tuple[int, int]] = []
        # Designated output vertices (e.g. the jaxpr outvars) — what a
        # downstream consumer of this graph's result reads.  Optional:
        # builders that know their outputs populate it; structural tools
        # (graphs/partition.py tiling) require it to chain repetitions.
        self.outputs: list[int] = []
        self._frozen = False

    # ------------------------------------------------------------- build
    def add_vertex(self, kind: str, flops: float = 0.0, out_bytes: float = 0.0,
                   meta_op: int = -1, role: str = "shard", label: str = "",
                   out_shape: tuple = ()) -> int:
        assert not self._frozen, "graph is frozen"
        vid = len(self.vertices)
        self.vertices.append(Vertex(vid, kind, float(flops), float(out_bytes),
                                    meta_op, role, label, tuple(out_shape)))
        return vid

    def add_edge(self, src: int, dst: int) -> None:
        assert not self._frozen, "graph is frozen"
        assert 0 <= src < len(self.vertices) and 0 <= dst < len(self.vertices)
        self.edges.append((src, dst))

    def freeze(self) -> "DataflowGraph":
        """Validate the DAG and build adjacency / topological caches."""
        n = len(self.vertices)
        self.preds: list[list[int]] = [[] for _ in range(n)]
        self.succs: list[list[int]] = [[] for _ in range(n)]
        seen = set()
        dedup = []
        for (s, d) in self.edges:
            if (s, d) in seen or s == d:
                continue
            seen.add((s, d))
            dedup.append((s, d))
            self.preds[d].append(s)
            self.succs[s].append(d)
        self.edges = dedup
        return self._finalize()

    def _finalize(self) -> "DataflowGraph":
        """Topological order + entry/exit caches over built adjacency.

        The stack-based Kahn traversal is shared by :meth:`freeze` and
        :meth:`from_arrays` so both construction paths produce the same
        deterministic ``topo_order`` for the same adjacency."""
        n = len(self.vertices)
        indeg = np.array([len(self.preds[v]) for v in range(n)])
        frontier = [v for v in range(n) if indeg[v] == 0]
        topo: list[int] = []
        indeg_work = indeg.copy()
        while frontier:
            v = frontier.pop()
            topo.append(v)
            for w in self.succs[v]:
                indeg_work[w] -= 1
                if indeg_work[w] == 0:
                    frontier.append(w)
        if len(topo) != n:
            raise ValueError(f"{self.name}: dataflow graph has a cycle")
        self.topo_order = topo
        self.entry_nodes = [v for v in range(n) if not self.preds[v]]
        self.exit_nodes = [v for v in range(n) if not self.succs[v]]
        self._frozen = True
        return self

    @classmethod
    def from_arrays(cls, name: str, kinds: Sequence[str], flops, out_bytes,
                    *, meta_op=None, roles: Sequence[str] | None = None,
                    labels: Sequence[str] | None = None,
                    out_shapes: Sequence[tuple] | None = None,
                    edges=None, outputs: Iterable[int] = ()
                    ) -> "DataflowGraph":
        """Bulk-construct a *frozen* graph from parallel per-vertex arrays.

        The streaming-import path for 100k+-vertex graphs: instead of n
        ``add_vertex`` + m ``add_edge`` calls and a per-edge dedup loop,
        vertices come in as parallel columns and ``edges`` as an (m, 2)
        int array.  Adjacency is built by CSR-style grouped sorts and the
        edge list is deduplicated vectorized, preserving first-occurrence
        order — the result is indistinguishable from building the same
        graph incrementally and calling :meth:`freeze` (same ``edges``
        order, same ``preds``/``succs`` order, same ``topo_order``).
        """
        g = cls(name)
        n = len(kinds)
        fl = np.asarray(flops, dtype=np.float64)
        ob = np.asarray(out_bytes, dtype=np.float64)
        meta = (np.full(n, -1, dtype=np.int64) if meta_op is None
                else np.asarray(meta_op, dtype=np.int64))
        if not (len(fl) == len(ob) == len(meta) == n):
            raise ValueError("per-vertex columns disagree on length")
        g.vertices = [
            Vertex(i, kinds[i], float(fl[i]), float(ob[i]), int(meta[i]),
                   roles[i] if roles is not None else "shard",
                   labels[i] if labels is not None else "",
                   tuple(out_shapes[i]) if out_shapes is not None else ())
            for i in range(n)]
        E = (np.zeros((0, 2), dtype=np.int64) if edges is None
             else np.asarray(edges, dtype=np.int64).reshape(-1, 2))
        g.preds = [[] for _ in range(n)]
        g.succs = [[] for _ in range(n)]
        if len(E):
            if E.min() < 0 or E.max() >= n:
                raise ValueError(f"{name}: edge endpoint outside [0, {n})")
            E = E[E[:, 0] != E[:, 1]]                      # self-loops
            _, first = np.unique(E[:, 0] * n + E[:, 1], return_index=True)
            E = E[np.sort(first)]                          # stable dedup
            s, d = E[:, 0], E[:, 1]
            succ_split = np.split(d[np.argsort(s, kind="stable")],
                                  np.cumsum(np.bincount(s, minlength=n))[:-1])
            pred_split = np.split(s[np.argsort(d, kind="stable")],
                                  np.cumsum(np.bincount(d, minlength=n))[:-1])
            g.succs = [x.tolist() for x in succ_split]
            g.preds = [x.tolist() for x in pred_split]
        g.edges = list(zip(E[:, 0].tolist(), E[:, 1].tolist()))
        g.outputs = [int(v) for v in outputs]
        return g._finalize()

    # ------------------------------------------------------------ access
    @property
    def n(self) -> int:
        return len(self.vertices)

    @property
    def m(self) -> int:
        return len(self.edges)

    def is_input(self, v: int) -> bool:
        return self.vertices[v].kind == "input"

    def edge_bytes(self, src: int) -> float:
        return self.vertices[src].out_bytes

    def flops_array(self) -> np.ndarray:
        return np.array([v.flops for v in self.vertices], dtype=np.float64)

    def out_bytes_array(self) -> np.ndarray:
        return np.array([v.out_bytes for v in self.vertices], dtype=np.float64)

    def input_mask(self) -> np.ndarray:
        return np.array([self.is_input(v) for v in range(self.n)], dtype=bool)

    def edge_array(self) -> np.ndarray:
        """(m, 2) int array of (src, dst)."""
        if not self.edges:
            return np.zeros((0, 2), dtype=np.int32)
        return np.asarray(self.edges, dtype=np.int32)

    # --------------------------------------------------------- meta-ops
    def meta_ops(self) -> list[dict]:
        """Topologically-ordered meta-op list for EnumerativeOptimizer.

        Returns [{'id', 'shard_ops': [vid...], 'reduce_ops': [vid...]}] in an
        order such that no vertex of a later meta-op reaches an earlier one.
        """
        groups: dict[int, dict] = {}
        for v in self.vertices:
            if v.meta_op < 0 or v.kind == "input":
                continue
            g = groups.setdefault(v.meta_op, {"id": v.meta_op,
                                              "shard_ops": [], "reduce_ops": []})
            (g["shard_ops"] if v.role == "shard" else g["reduce_ops"]).append(v.vid)
        # order groups by the earliest topo position of their vertices
        pos = {v: i for i, v in enumerate(self.topo_order)}
        ordered = sorted(groups.values(),
                         key=lambda g: min(pos[v] for v in
                                           g["shard_ops"] + g["reduce_ops"]))
        return ordered

    # ------------------------------------------------------------ misc
    def critical_path_lower_bound(self, flops_per_sec) -> float:
        """Longest pure-compute path (seconds) — a makespan lower bound.

        `flops_per_sec` may be a scalar rate or a per-device array
        (heterogeneous fleet), in which case each vertex optimistically
        runs on the fastest device — still a valid lower bound."""
        rate = float(np.max(flops_per_sec))
        n = self.n
        dp = np.zeros(n)
        for v in reversed(self.topo_order):
            t = self.vertices[v].flops / rate
            best = 0.0
            for w in self.succs[v]:
                best = max(best, dp[w])
            dp[v] = t + best
        return float(dp.max(initial=0.0))

    def bytes_per_device(self, assignment: Sequence[int], n_devices: int
                         ) -> np.ndarray:
        """(n_devices,) bytes resident per device under `assignment`: the
        sum of output-tensor sizes of the vertices placed there — the
        memory profile checked against ``DeviceModel.mem_bytes``."""
        a = np.asarray(assignment)
        out = np.zeros(n_devices)
        np.add.at(out, a, self.out_bytes_array())
        return out

    def total_flops(self) -> float:
        return float(sum(v.flops for v in self.vertices))

    def nbytes_estimate(self) -> int:
        """Approximate resident size of this graph in bytes.

        Budget key for the model-zoo byte-budgeted cache: a Vertex object
        with its boxed floats/label plus the edge tuple and two adjacency
        entries dominate; the constants below were measured against
        ``tracemalloc`` on tiled full-model graphs (within ~20%)."""
        label_bytes = sum(len(v.label) for v in self.vertices)
        return int(360 * self.n + 160 * self.m + label_bytes)

    def __repr__(self):
        return (f"DataflowGraph({self.name!r}, n={self.n}, m={self.m}, "
                f"meta_ops={len({v.meta_op for v in self.vertices if v.meta_op >= 0})})")


def topo_hash(g: DataflowGraph) -> str:
    """Structural fingerprint: kinds + exact costs + edges, labels
    excluded (cosmetic relabeling must not change the hash).  This is the
    golden-test fingerprint (tests/test_goldens.py) and the serving-cache
    key (launch/place_server.py): two graphs with the same hash are
    placement-equivalent, so a cached placement can be replayed."""
    import hashlib
    h = hashlib.sha256()
    for v in g.vertices:
        h.update(f"{v.kind}|{float(v.flops).hex()}|"
                 f"{float(v.out_bytes).hex()}\n".encode())
    for (s, d) in g.edges:
        h.update(f"{s}>{d}\n".encode())
    return h.hexdigest()


def validate_assignment(graph: DataflowGraph, assignment: Sequence[int],
                        n_devices: int) -> None:
    a = np.asarray(assignment)
    if a.shape != (graph.n,):
        raise ValueError(f"assignment shape {a.shape} != ({graph.n},)")
    if (a < 0).any() or (a >= n_devices).any():
        raise ValueError("assignment maps a vertex outside the device range")
