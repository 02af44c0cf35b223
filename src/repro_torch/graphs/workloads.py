"""Copy of ``src/repro/graphs/workloads.py`` (the port imports nothing of ``repro``).

The paper's four experiment graphs (Appendix D), built by the sharded
decomposer, plus scalable synthetic families for the Fig.-6 scalability
study.

Sizes reproduce Appendix D:
  CHAINMM      (A x B) + (C x (D x E)),  A..E in R^{10000x10000}, 4-way shards
  FFNN         X(2^15 x 2^5) -> ReLU(XW1+b1)(2^16) -> Softmax(HW2+b2)(2^5)
  LLAMA-BLOCK  one 7B-config attention block (d=4096, seq=4096, batch 1)
  LLAMA-LAYER  attention + SwiGLU FFN (full transformer layer)

Our decomposition yields graph sizes close to (not byte-identical with)
the paper's EinDecomp output (112/192/215 nodes); exact counts are
reported by the benchmarks.
"""
from __future__ import annotations

from ..core.graph import DataflowGraph
from .builder import GraphBuilder


def chainmm(n: int = 10000, grid: int = 2) -> DataflowGraph:
    """(A x B) + (C x (D x E)) with every matrix sharded grid x grid."""
    b = GraphBuilder("chainmm")
    g2 = (grid, grid)
    A = b.input_matrix("A", (n, n), g2)
    B = b.input_matrix("B", (n, n), g2)
    C = b.input_matrix("C", (n, n), g2)
    D = b.input_matrix("D", (n, n), g2)
    E = b.input_matrix("E", (n, n), g2)
    AB = b.matmul(A, B, "AB")
    DE = b.matmul(D, E, "DE")
    CDE = b.matmul(C, DE, "CDE")
    b.add(AB, CDE, "final")
    return b.finish()


def ffnn(batch_log2: int = 15, in_log2: int = 5, hidden_log2: int = 16,
         grid: int = 4) -> DataflowGraph:
    """Two-layer FFNN of Appendix D.2: hidden ReLU layer 2^16 wide, softmax
    output.  X is row-sharded, weights col-sharded (so layer matmuls have a
    contraction to reduce over when the activation is re-blocked)."""
    b = GraphBuilder("ffnn")
    bs, din, dh = 2 ** batch_log2, 2 ** in_log2, 2 ** hidden_log2
    X = b.input_matrix("X", (bs, din), (grid, 1))
    W1 = b.input_matrix("W1", (din, dh), (1, grid))
    b1 = b.input_matrix("b1", (1, dh), (1, grid))
    W2 = b.input_matrix("W2", (dh, din), (grid, 1))
    b2 = b.input_matrix("b2", (1, din), (1, 1))
    XW1 = b.matmul(X, W1, "l1")                  # (grid x grid) blocks
    H = b.elemwise(b.bcast_add(XW1, b1, "b1"), "relu", "relu")
    HW2 = b.matmul(H, W2, "l2")                  # contraction over grid
    logits = b.bcast_add(HW2, b2, "b2")
    b.softmax_rows(logits, "softmax")
    return b.finish()


def llama_block(d_model: int = 4096, seq: int = 4096, grid: int = 2
                ) -> DataflowGraph:
    """One Llama-7B attention block (pre-norm attention + residual)."""
    b = GraphBuilder("llama_block")
    _attention(b, d_model, seq, grid)
    return b.finish()


def llama_layer(d_model: int = 4096, seq: int = 4096, d_ff: int = 11008,
                grid: int = 2) -> DataflowGraph:
    """Full Llama-7B transformer layer: attention + SwiGLU FFN."""
    b = GraphBuilder("llama_layer")
    h = _attention(b, d_model, seq, grid)
    # FFN sub-block
    n1 = b.rmsnorm_rows(h, "ffn_norm")
    Wg = b.input_matrix("Wg", (d_model, d_ff), (grid, grid))
    Wu = b.input_matrix("Wu", (d_model, d_ff), (grid, grid))
    Wd = b.input_matrix("Wd", (d_ff, d_model), (grid, grid))
    gate = b.elemwise(b.matmul(n1, Wg, "gate"), "silu", "silu")
    up = b.matmul(n1, Wu, "up")
    prod = b.mul(gate, up, "gateup")
    down = b.matmul(prod, Wd, "down")
    b.add(h, down, "resid2")
    return b.finish()


def _attention(b: GraphBuilder, d_model: int, seq: int, grid: int):
    X = b.input_matrix("X", (seq, d_model), (grid, grid))
    Wq = b.input_matrix("Wq", (d_model, d_model), (grid, grid))
    Wk = b.input_matrix("Wk", (d_model, d_model), (grid, grid))
    Wv = b.input_matrix("Wv", (d_model, d_model), (grid, grid))
    Wo = b.input_matrix("Wo", (d_model, d_model), (grid, grid))
    n = b.rmsnorm_rows(X, "attn_norm")
    Q = b.elemwise(b.matmul(n, Wq, "q"), "rope", "rope_q")
    K = b.elemwise(b.matmul(n, Wk, "k"), "rope", "rope_k")
    V = b.matmul(n, Wv, "v")
    # scores = Q K^T: contract over d_model -> (seq x seq) blocks
    KT = ShardedTranspose(K)
    S = b.matmul(Q, KT, "qk")
    P = b.softmax_rows(S, "attn_softmax")
    O = b.matmul(P, V, "pv")
    out = b.matmul(O, Wo, "o")
    return b.add(X, out, "resid1")


def ShardedTranspose(x):
    """Block-transpose view (no data movement: relabel the grid)."""
    from .builder import ShardedTensor
    p, q = x.grid
    blocks = [[x.blocks[i][j] for i in range(p)] for j in range(q)]
    return ShardedTensor(blocks, (x.block_shape[1], x.block_shape[0]))


# ------------------------------------------------------- scalable family
def synthetic_layered(n_layers: int, width: int, fan_in: int = 2,
                      flops: float = 1e9, nbytes: float = 1e6,
                      seed: int = 0) -> DataflowGraph:
    """Layered DAG of configurable size for the Fig.-6 scalability study."""
    import numpy as np
    rng = np.random.default_rng(seed)
    g = DataflowGraph(f"synth_L{n_layers}_W{width}")
    prev = [g.add_vertex("input", out_bytes=nbytes) for _ in range(width)]
    meta = 0
    for layer in range(n_layers):
        cur = []
        for w in range(width):
            v = g.add_vertex("matmul", flops=flops * rng.uniform(0.5, 1.5),
                             out_bytes=nbytes, meta_op=meta, role="shard")
            for p in rng.choice(prev, size=min(fan_in, len(prev)),
                                replace=False):
                g.add_edge(int(p), v)
            cur.append(v)
        meta += 1
        prev = cur
    f = g.add_vertex("sum_reduction", flops=flops * 0.01, out_bytes=nbytes,
                     meta_op=meta, role="reduce")
    for p in prev:
        g.add_edge(p, f)
    return g.freeze()


WORKLOADS = {
    "chainmm": chainmm,
    "ffnn": ffnn,
    "llama_block": llama_block,
    "llama_layer": llama_layer,
}

MODEL_PREFIX = "model:"


def list_workloads() -> list[str]:
    """All addressable workload names: the four Appendix-D synthetic
    graphs.  (The ``model:<arch>`` zoo entries need the model importer,
    which the port does not have yet.)"""
    return sorted(WORKLOADS)


def get_workload(name: str, **kwargs) -> DataflowGraph:
    """Resolve a workload by name.

    ``model:<arch>`` names raise: importing a registry architecture into
    a graph is ROADMAP item A11, not ported yet."""
    if name.startswith(MODEL_PREFIX):
        raise NotImplementedError(
            f"{name!r}: the model-zoo importer is not ported to repro_torch "
            f"yet (ROADMAP item A11)")
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; have {sorted(WORKLOADS)}")
    return WORKLOADS[name](**kwargs)
