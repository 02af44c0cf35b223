"""The port's graph importer (``graphs/fx_import.py``) against the
reference's ``jaxpr_import`` on the same functions:

* the reference's three importer cases (``tests/test_model_zoo.py``):
  fusion keeps labels and conserves flops, argument labels, dtype-aware
  bytes;
* ``_fuse_cheap`` on the reference's own unfused zoo graphs, carried
  across as arrays: the reference's fused graph exactly;
* the port-side rewriting that reaches the reference's grain: aliases and
  views contracted, host constants as ``const{i}`` inputs, ``jnp.einsum``'s
  lowering (opt_einsum's path, one ``dot_general`` a pair), and the three
  loops the reference runs as one ``lax.scan`` (one vertex forward and one
  backward, at the reference's scan cost);
* the marked loops leave the numbers as they were.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.configs.registry import ARCH_IDS
from repro.graphs import model_zoo as jax_zoo
from repro.graphs.jaxpr_import import _fuse_cheap as jax_fuse_cheap
from repro.graphs.jaxpr_import import jaxpr_to_graph
from repro.models import attention as jax_attention
from repro.models import ssm as jax_ssm
from repro.models.config import SSMConfig as JaxSSMConfig
from repro_torch.core.graph import DataflowGraph
from repro_torch.graphs.fx_import import _fuse_cheap, fx_to_graph
from repro_torch.kernels.mamba2_scan.ref import _chunk_gla, chunked_gla
from repro_torch.models import ssm
from repro_torch.models.attention import chunked_attention
from repro_torch.models.config import SSMConfig

F32 = jnp.float32


def spec(*shape, dtype=F32):
    return jax.ShapeDtypeStruct(shape, dtype)


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def by_label(g):
    out = {}
    for v in g.vertices:
        out.setdefault(v.label, []).append(v)
    return out


def jax_vjp(f):
    """The reference's training-step form: outputs and the vjp of them."""
    def unit(*args):
        y, vjp = jax.vjp(f, *args)
        return y, vjp(y)
    return unit


def torch_grad(f):
    """The port's: outputs and ``autograd.grad`` of them."""
    def unit(*args):
        with torch.enable_grad():
            ys = f(*args)
            ys = ys if isinstance(ys, tuple) else (ys,)
            wrt = [t for t in tree_leaves(args) if t.requires_grad]
            grads = torch.autograd.grad(ys, wrt, [y.detach() for y in ys])
        return ys, grads
    return unit


# -------------------------------------------------- the reference's cases
def test_fuse_preserves_labels_and_flops():
    f = lambda x, w: torch.tanh(x @ w).sum()
    args = meta(64, 32), meta(32, 128)
    g = fx_to_graph(f, *args, name="tiny", fuse_cheap=False)
    gf = fx_to_graph(f, *args, name="tiny", fuse_cheap=True, cheap_flops=1e9)
    ref = jaxpr_to_graph(lambda x, w: jnp.tanh(x @ w).sum(),
                         spec(64, 32), spec(32, 128), name="tiny",
                         fuse_cheap=False)
    assert gf.name == "tiny"
    assert gf.n < g.n
    assert all(v.label for v in gf.vertices)
    # fused roots absorb the collapsed vertices' flops: totals conserved,
    # and the reference's totals (a product, tanh, a sum)
    assert gf.total_flops() == pytest.approx(g.total_flops())
    assert g.total_flops() == ref.total_flops()
    assert g.n == ref.n


def test_arg_labels_applied():
    g = fx_to_graph(lambda x, w: x @ w, meta(8, 8), meta(8, 8),
                    arg_labels=["acts", "weights"])
    ref = jaxpr_to_graph(lambda x, w: x @ w, spec(8, 8), spec(8, 8),
                         arg_labels=["acts", "weights"])
    inputs = [v.label for v in g.vertices if v.kind == "input"]
    assert inputs == [v.label for v in ref.vertices if v.kind == "input"] \
        == ["acts", "weights"]


def test_out_bytes_non_float_dtypes():
    def f(x):
        idx = x.argmax(-1)                            # int output
        flags = x > 0.0                               # bool output
        return x[idx].sum() + flags.sum()

    def f_ref(x):
        idx = jnp.argmax(x, axis=-1)
        flags = x > 0.0
        return x[idx].sum() + flags.sum()

    g = by_label(fx_to_graph(f, meta(16, 16), fuse_cheap=False))
    ref = by_label(jaxpr_to_graph(f_ref, spec(16, 16), fuse_cheap=False))
    assert g["argmax"][0].out_bytes >= 16 * 4          # int64 indices
    assert ref["argmax"][0].out_bytes >= 16 * 4        # int32 there
    assert g["gt"][0].out_bytes == ref["gt"][0].out_bytes == 16 * 16 * 1


# ------------------------------------------------------------ _fuse_cheap
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fuse_cheap_reproduces_the_reference(arch):
    """The reference's unfused layer graph, carried across as arrays,
    fuses into the reference's fused graph exactly."""
    fn, args, labels = jax_zoo.layer_spec(jax_zoo.get_config(arch), seq=64)
    raw = jaxpr_to_graph(fn, *args, arg_labels=labels, fuse_cheap=False)
    want = jax_fuse_cheap(raw, 1e4)
    port = DataflowGraph.from_arrays(
        raw.name, [v.kind for v in raw.vertices], raw.flops_array(),
        raw.out_bytes_array(), meta_op=[v.meta_op for v in raw.vertices],
        roles=[v.role for v in raw.vertices],
        labels=[v.label for v in raw.vertices],
        out_shapes=[v.out_shape for v in raw.vertices],
        edges=raw.edge_array(), outputs=list(raw.outputs))
    got = _fuse_cheap(port, 1e4)
    assert got.n == want.n and got.outputs == want.outputs
    assert np.array_equal(got.flops_array(), want.flops_array())
    assert np.array_equal(got.out_bytes_array(), want.out_bytes_array())
    assert np.array_equal(got.edge_array(), want.edge_array())
    assert got.topo_order == want.topo_order
    for a, b in zip(got.vertices, want.vertices):
        assert (a.kind, a.label, a.meta_op, a.role, a.out_shape) == \
            (b.kind, b.label, b.meta_op, b.role, b.out_shape)


# ------------------------------------------------- aliases, views, consts
def test_views_feeding_a_product_make_no_vertex():
    """The reshape of a 3-D operand and the product's reshape back are
    dot_general's own dimension numbers, as are ``t`` and ``detach``."""
    g = fx_to_graph(lambda x, w: (x @ w.t()).detach(), meta(2, 8, 16),
                    meta(32, 16), fuse_cheap=False)
    ref = jaxpr_to_graph(lambda x, w: x @ w, spec(2, 8, 16), spec(16, 32),
                         fuse_cheap=False)
    assert [v.label for v in g.vertices] == ["arg0", "arg1", "mm"]
    assert [v.label for v in ref.vertices] == ["arg0", "arg1",
                                               "dot_general"]
    assert g.total_flops() == ref.total_flops() == 2 * 2 * 8 * 32 * 16
    assert g.vertices[g.outputs[0]].out_shape == (16, 32)


def test_a_chain_of_views_is_one_vertex():
    def f(x):
        y = x.reshape(4, 2, 8).permute(1, 0, 2)      # one transpose
        a, b = x.split(4, dim=1)                     # one split, 2 outputs
        return y + 1.0, a * b

    g = by_label(fx_to_graph(f, meta(8, 8), fuse_cheap=False))
    assert len(g["permute"]) == 1 and len(g["split"]) == 1
    assert g["split"][0].out_bytes == 8 * 8 * 4      # both halves
    assert "view" not in g


def test_host_constants_are_inputs_and_scalars_literals():
    host = np.arange(6, dtype=np.float64)

    def f(x):
        c = torch.as_tensor(host, dtype=torch.float32, device=x.device)
        return x * c + torch.tensor(2.0, device=x.device)

    g = fx_to_graph(f, meta(3, 6), fuse_cheap=False)
    inputs = {v.label: v.out_bytes for v in g.vertices if v.kind == "input"}
    # the conversion is made on the host: a float32 input, no vertex
    assert inputs == {"arg0": 3 * 6 * 4, "const0": 6 * 4}
    assert [v.label for v in g.vertices if v.kind != "input"] == ["mul",
                                                                  "add"]


def test_in_place_writes_version_the_buffer():
    def f(x):
        buf = x.new_empty(4, 9)
        buf[:, :8] = x * 2.0
        buf[:, 8] = x.sum(-1)
        return buf + 1.0

    g = fx_to_graph(f, meta(4, 8), fuse_cheap=False)
    out = g.outputs[0]
    seen, st = set(), [out]
    while st:
        v = st.pop()
        if v not in seen:
            seen.add(v)
            st.extend(g.preds[v])
    labels = {g.vertices[v].label for v in seen}
    assert {"mul", "sum", "arg0"} <= labels          # both writes read


# ----------------------------------------------------------------- einsum
EINSUMS = [("blhn,bmhn->blmh", [(1, 6, 2, 4), (1, 6, 2, 4)]),
           ("blmh,bmhp->blhp", [(1, 6, 6, 2), (1, 6, 2, 3)]),
           ("blhn,bhpn,blh->blhp", [(1, 6, 2, 4), (1, 2, 3, 4), (1, 6, 2)]),
           ("blh,blhp,blhn->bhpn", [(1, 6, 2), (1, 6, 2, 3), (1, 6, 2, 4)]),
           ("bckgh,btkh->bkgct", [(1, 6, 2, 3, 4), (1, 5, 2, 4)]),
           ("ij,jk,kl->il", [(5, 40), (40, 3), (3, 30)])]


def _products(g):
    return sorted((v.flops, v.out_shape) for v in g.vertices
                  if v.kind == "matmul")


@pytest.mark.parametrize("eq,shapes", EINSUMS)
def test_einsum_lowers_as_jnp_einsum(eq, shapes):
    """opt_einsum's order and one dot_general a pair (a product without a
    contracted name included), and the same again under the gradient."""
    g = fx_to_graph(lambda *a: torch.einsum(eq, *a),
                    *[meta(*s) for s in shapes], fuse_cheap=False)
    ref = jaxpr_to_graph(lambda *a: jnp.einsum(eq, *a),
                         *[spec(*s) for s in shapes], fuse_cheap=False)
    assert _products(g) == _products(ref)
    assert len(by_label(g).get("permute", [])) == \
        len(by_label(ref).get("transpose", []))
    gu = fx_to_graph(torch_grad(lambda *a: torch.einsum(eq, *a)),
                     *[meta(*s, grad=True) for s in shapes], fuse_cheap=False)
    ru = jaxpr_to_graph(jax_vjp(lambda *a: jnp.einsum(eq, *a)),
                        *[spec(*s) for s in shapes], fuse_cheap=False)
    assert sorted(v.flops for v in gu.vertices if v.kind == "matmul") == \
        sorted(v.flops for v in ru.vertices if v.kind == "matmul")


# ------------------------------------------------------------------ scans
def _scans(g):
    return [v for v in g.vertices if v.label == "scan"]


B, L, H, N, P, CH = 1, 32, 2, 8, 4, 8


def test_chunked_gla_loop_is_one_scan():
    """S > chunk: one vertex forward at the reference's cost (the carried
    state's elements; bytes the state and y); under the gradient one more,
    its first output the state's cotangent (the reference's transposed
    scan's, whose jaxpr the reference's importer cannot read)."""
    ref = _scans(jaxpr_to_graph(
        lambda q, k, v, a: jax_ssm.chunked_gla(q, k, v, a, CH),
        spec(B, L, H, N), spec(B, L, H, N), spec(B, L, H, P), spec(B, L, H),
        fuse_cheap=False))
    args = [meta(B, L, H, N), meta(B, L, H, N), meta(B, L, H, P),
            meta(B, L, H)]
    got = _scans(fx_to_graph(lambda q, k, v, a: chunked_gla(q, k, v, a, CH),
                             *args, fuse_cheap=False))
    assert [(v.flops, v.out_bytes) for v in got] == \
        [(v.flops, v.out_bytes) for v in ref] == [(B * H * P * N,
                                                   4 * (B * H * P * N
                                                        + B * L * H * P))]
    unit = fx_to_graph(torch_grad(lambda q, k, v, a: chunked_gla(
        q, k, v, a, CH)[0]), *[t.requires_grad_() for t in args],
        fuse_cheap=False)
    fwd, bwd = _scans(unit)
    assert fwd.flops == bwd.flops == B * H * P * N
    assert bwd.out_shape == (B, H, P, N) and unit.preds[bwd.vid].count(
        fwd.vid) == 1


def test_chunked_attention_loop_is_one_scan():
    Hq, Hk, hd, S, c = 4, 2, 8, 32, 8
    ref = _scans(jaxpr_to_graph(jax_vjp(
        lambda q, k, v: jax_attention.chunked_attention(q, k, v, chunk=c)),
        spec(1, S, Hq, hd), spec(1, S, Hk, hd), spec(1, S, Hk, hd),
        fuse_cheap=False))
    got = _scans(fx_to_graph(torch_grad(
        lambda q, k, v: chunked_attention(q, k, v, chunk=c)),
        meta(1, S, Hq, hd, grad=True), meta(1, S, Hk, hd, grad=True),
        meta(1, S, Hk, hd, grad=True), fuse_cheap=False))
    assert [v.flops for v in got] == [v.flops for v in ref] == \
        [S * Hq * hd, S * Hk * hd]
    # forward: out and the residuals (the reference's stacked ones: each
    # chunk's probabilities, exp, mask and queries); backward: k, v and q's
    # cotangents
    assert [v.out_bytes for v in got] == [v.out_bytes for v in ref]
    assert got[0].out_bytes > 4 * S * Hq * hd


def test_slstm_loop_is_one_scan():
    D, Hs, S = 16, 2, 8
    jp = {"w_gates": spec(D, 4 * D), "r_gates": spec(Hs, D // Hs,
                                                     4 * D // Hs),
          "w_out": spec(D, D)}
    cfg_j, cfg_p = JaxSSMConfig(n_heads=Hs), SSMConfig(n_heads=Hs)
    ref = jaxpr_to_graph(jax_vjp(
        lambda p, x: jax_ssm.slstm_forward(p, x, cfg_j)[0]), jp,
        spec(1, S, D), fuse_cheap=False)
    pp = {k: meta(*v.shape, grad=True) for k, v in jp.items()}
    got = fx_to_graph(torch_grad(
        lambda p, x: ssm.slstm_forward(p, x, cfg_p)[0]), pp,
        meta(1, S, D, grad=True), fuse_cheap=False)
    # forward: the carried c (B, H, P); backward: r_gates' cotangent
    assert [v.flops for v in _scans(got)] == \
        [v.flops for v in _scans(ref)] == [D, Hs * (D // Hs) * 4 * D // Hs]
    assert _scans(got)[1].out_bytes == _scans(ref)[1].out_bytes
    # the forward's residuals: what autograd saves for each step, beside
    # the reference's stacked ones (not the same tensors)
    outs = 4 * (4 * Hs * (D // Hs) + S * D)          # c, n, m, h and hs
    assert outs < _scans(got)[0].out_bytes <= _scans(ref)[0].out_bytes
    # the products around the loop are the reference's (the recurrent
    # ones inside it are not counted, as in the reference)
    assert [f for f, _ in _products(got)] == sorted(
        v.flops for v in ref.vertices if v.kind == "matmul")


def test_marked_loops_compute_what_they_did():
    """Outside the importer the marks call the loops: chunked_gla over
    chunks equals the chunks run one by one, and chunked_attention equals
    the full attention."""
    gen = torch.Generator().manual_seed(0)
    q, k = (torch.randn(B, L, H, N, generator=gen) for _ in range(2))
    v = torch.randn(B, L, H, P, generator=gen)
    a = -torch.rand(B, L, H, generator=gen)
    y, st = chunked_gla(q, k, v, a, CH)
    st0 = torch.zeros(B, H, P, N)
    ys = []
    for c0 in range(0, L, CH):
        yc, st0 = _chunk_gla(q[:, c0:c0 + CH], k[:, c0:c0 + CH],
                             v[:, c0:c0 + CH], a[:, c0:c0 + CH], st0)
        ys.append(yc)
    assert torch.equal(y, torch.cat(ys, 1)) and torch.equal(st, st0)
    from repro_torch.models.attention import gqa_attention
    qa = torch.randn(1, 32, 4, 8, generator=gen)
    ka, va = (torch.randn(1, 32, 2, 8, generator=gen) for _ in range(2))
    torch.testing.assert_close(chunked_attention(qa, ka, va, chunk=8),
                               gqa_attention(qa, ka, va), rtol=1e-6,
                               atol=1e-6)
