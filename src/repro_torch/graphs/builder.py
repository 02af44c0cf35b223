"""Copy of ``src/repro/graphs/builder.py`` (the port imports nothing of ``repro``).

Sharded-tensor dataflow-graph builder.

The paper's graphs come from sharding a declarative tensor computation
(EinDecomp/Alpa-style): each logical tensor is partitioned into a block
grid, each logical op becomes a *meta-op* — a set of per-block kernel calls
(`shardOps`) plus the aggregations recombining them (`reduceOps`)
(Appendix B).  This module is that decomposer: a tiny sharded linear
algebra whose ops emit DataflowGraph vertices with FLOP/byte costs and
meta-op/role tags, so EnumerativeOptimizer and the WC engine both work on
the result.

Costs: matmul block (m,k)x(k,n): 2mkn FLOPs; elementwise: ~size FLOPs;
bytes: fp32 (= the paper's engine precision).
"""
from __future__ import annotations

import dataclasses

from ..core.graph import DataflowGraph

F32 = 4  # bytes per element


@dataclasses.dataclass
class ShardedTensor:
    """A logical (R x C) matrix split into a (p x q) grid of blocks."""
    blocks: list            # p x q nested list of vertex ids
    block_shape: tuple      # (rows, cols) of ONE block

    @property
    def grid(self):
        return (len(self.blocks), len(self.blocks[0]))

    @property
    def shape(self):
        p, q = self.grid
        return (p * self.block_shape[0], q * self.block_shape[1])


class GraphBuilder:
    def __init__(self, name: str):
        self.g = DataflowGraph(name)
        self._meta = 0

    def _next_meta(self) -> int:
        m = self._meta
        self._meta += 1
        return m

    def finish(self) -> DataflowGraph:
        return self.g.freeze()

    # -------------------------------------------------------------- input
    def input_matrix(self, name: str, shape: tuple, grid: tuple
                     ) -> ShardedTensor:
        p, q = grid
        br, bc = shape[0] // p, shape[1] // q
        blocks = [[self.g.add_vertex("input", out_bytes=br * bc * F32,
                                     label=f"{name}[{i},{j}]",
                                     out_shape=(br, bc))
                   for j in range(q)] for i in range(p)]
        return ShardedTensor(blocks, (br, bc))

    # ------------------------------------------------------------- matmul
    def matmul(self, x: ShardedTensor, y: ShardedTensor, label: str = "mm"
               ) -> ShardedTensor:
        """Blocked matmul: p x q x k partial multiplies (shardOps) + per
        (i,j) pairwise-add reduction + formation (reduceOps)."""
        p, k = x.grid
        k2, q = y.grid
        assert k == k2, f"grid mismatch {x.grid} x {y.grid}"
        m, kk = x.block_shape
        kk2, n = y.block_shape
        assert kk == kk2, f"block mismatch {x.block_shape} x {y.block_shape}"
        meta = self._next_meta()
        out_blocks = []
        for i in range(p):
            row = []
            for j in range(q):
                partials = []
                for l in range(k):
                    v = self.g.add_vertex(
                        "matmul", flops=2.0 * m * kk * n,
                        out_bytes=m * n * F32, meta_op=meta, role="shard",
                        label=f"{label}.mul[{i},{j},{l}]", out_shape=(m, n))
                    self.g.add_edge(x.blocks[i][l], v)
                    self.g.add_edge(y.blocks[l][j], v)
                    partials.append(v)
                acc = partials[0]
                for l in range(1, k):
                    a = self.g.add_vertex(
                        "straight_elemwise", flops=float(m * n),
                        out_bytes=m * n * F32, meta_op=meta, role="reduce",
                        label=f"{label}.add[{i},{j},{l}]", out_shape=(m, n))
                    self.g.add_edge(acc, a)
                    self.g.add_edge(partials[l], a)
                    acc = a
                if k > 1:
                    f = self.g.add_vertex(
                        "formation", flops=0.0, out_bytes=m * n * F32,
                        meta_op=meta, role="reduce",
                        label=f"{label}.form[{i},{j}]", out_shape=(m, n))
                    self.g.add_edge(acc, f)
                    acc = f
                row.append(acc)
            out_blocks.append(row)
        return ShardedTensor(out_blocks, (m, n))

    # --------------------------------------------------------- elementwise
    def elemwise(self, x: ShardedTensor, op: str = "relu", label: str = ""
                 ) -> ShardedTensor:
        meta = self._next_meta()
        m, n = x.block_shape
        p, q = x.grid
        out = [[self._ew1(x.blocks[i][j], m, n, meta,
                          f"{label or op}[{i},{j}]")
                for j in range(q)] for i in range(p)]
        return ShardedTensor(out, (m, n))

    def _ew1(self, src, m, n, meta, label):
        v = self.g.add_vertex("input_elemwise", flops=float(m * n),
                              out_bytes=m * n * F32, meta_op=meta,
                              role="shard", label=label, out_shape=(m, n))
        self.g.add_edge(src, v)
        return v

    def add(self, x: ShardedTensor, y: ShardedTensor, label: str = "add"
            ) -> ShardedTensor:
        assert x.grid == y.grid and x.block_shape == y.block_shape
        meta = self._next_meta()
        m, n = x.block_shape
        p, q = x.grid
        out = []
        for i in range(p):
            row = []
            for j in range(q):
                v = self.g.add_vertex("straight_elemwise", flops=float(m * n),
                                      out_bytes=m * n * F32, meta_op=meta,
                                      role="shard",
                                      label=f"{label}[{i},{j}]",
                                      out_shape=(m, n))
                self.g.add_edge(x.blocks[i][j], v)
                self.g.add_edge(y.blocks[i][j], v)
                row.append(v)
            out.append(row)
        return ShardedTensor(out, (m, n))

    def bcast_add(self, x: ShardedTensor, vec: ShardedTensor,
                  label: str = "bias") -> ShardedTensor:
        """x (p x q blocks) + row-vector vec (1 x q blocks)."""
        assert vec.grid[0] == 1 and vec.grid[1] == x.grid[1]
        meta = self._next_meta()
        m, n = x.block_shape
        p, q = x.grid
        out = []
        for i in range(p):
            row = []
            for j in range(q):
                v = self.g.add_vertex("bcast_elemwise", flops=float(m * n),
                                      out_bytes=m * n * F32, meta_op=meta,
                                      role="shard",
                                      label=f"{label}[{i},{j}]",
                                      out_shape=(m, n))
                self.g.add_edge(x.blocks[i][j], v)
                self.g.add_edge(vec.blocks[0][j], v)
                row.append(v)
            out.append(row)
        return ShardedTensor(out, (m, n))

    def mul(self, x: ShardedTensor, y: ShardedTensor, label: str = "mul"
            ) -> ShardedTensor:
        return self.add(x, y, label=label)  # same cost structure

    # ----------------------------------------------------------- rowwise
    def row_reduce(self, x: ShardedTensor, kind: str = "max",
                   label: str = "") -> ShardedTensor:
        """Reduce along columns -> (p x 1)-grid column vector.  Per row-panel:
        q partial reductions (shardOps) + a combine chain (reduceOps)."""
        meta = self._next_meta()
        m, n = x.block_shape
        p, q = x.grid
        kindop = f"{kind}_reduction"
        out = []
        for i in range(p):
            partials = []
            for j in range(q):
                v = self.g.add_vertex(kindop, flops=float(m * n),
                                      out_bytes=m * F32, meta_op=meta,
                                      role="shard",
                                      label=f"{label or kind}[{i},{j}]",
                                      out_shape=(m, 1))
                self.g.add_edge(x.blocks[i][j], v)
                partials.append(v)
            acc = partials[0]
            for j in range(1, q):
                a = self.g.add_vertex("straight_elemwise", flops=float(m),
                                      out_bytes=m * F32, meta_op=meta,
                                      role="reduce",
                                      label=f"{label or kind}.comb[{i},{j}]",
                                      out_shape=(m, 1))
                self.g.add_edge(acc, a)
                self.g.add_edge(partials[j], a)
                acc = a
            out.append([acc])
        return ShardedTensor(out, (m, 1))

    def bcast_col_op(self, x: ShardedTensor, col: ShardedTensor,
                     label: str = "colop") -> ShardedTensor:
        """x op col-vector (p x 1 blocks), e.g. subtract row-max, divide by
        row-sum."""
        assert col.grid == (x.grid[0], 1)
        meta = self._next_meta()
        m, n = x.block_shape
        p, q = x.grid
        out = []
        for i in range(p):
            row = []
            for j in range(q):
                v = self.g.add_vertex("bcast_elemwise", flops=float(m * n),
                                      out_bytes=m * n * F32, meta_op=meta,
                                      role="shard",
                                      label=f"{label}[{i},{j}]",
                                      out_shape=(m, n))
                self.g.add_edge(x.blocks[i][j], v)
                self.g.add_edge(col.blocks[i][0], v)
                row.append(v)
            out.append(row)
        return ShardedTensor(out, (m, n))

    # ---------------------------------------------------------- compound
    def softmax_rows(self, x: ShardedTensor, label: str = "softmax"
                     ) -> ShardedTensor:
        mx = self.row_reduce(x, "max", label=f"{label}.max")
        sh = self.bcast_col_op(x, mx, label=f"{label}.sub")
        ex = self.elemwise(sh, "exp", label=f"{label}.exp")
        sm = self.row_reduce(ex, "sum", label=f"{label}.sum")
        return self.bcast_col_op(ex, sm, label=f"{label}.div")

    def rmsnorm_rows(self, x: ShardedTensor, label: str = "rms"
                     ) -> ShardedTensor:
        sq = self.elemwise(x, "square", label=f"{label}.sq")
        ss = self.row_reduce(sq, "sum", label=f"{label}.ss")
        return self.bcast_col_op(x, ss, label=f"{label}.scale")
