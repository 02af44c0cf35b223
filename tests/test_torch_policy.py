"""Port policy networks vs the JAX reference on carried-over parameters.

Bars: the parameter round trip is bit-equal; encodings (H, sel_logits,
z_plc) and PLC logits are within 1e-5 of ``repro.core.policies`` (XLA
and Pallas encoder backends) and of the numpy twin ``repro.core.zero_shot``
— the reference's own twin-to-twin bar (tests/test_serving.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assign as jax_assign
from repro.core import policies as jax_policies
from repro.core.devices import get_device_model as jax_fleet
from repro.core.features import EpisodeState
from repro.core.zero_shot import encode_graph, plc_logits_np, to_numpy_params
from repro.graphs import workloads as jax_workloads
from repro_torch.core import assign, policies
from repro_torch.core.devices import get_device_model
from repro_torch.core.nn import tree_leaves, tree_size
from repro_torch.graphs import workloads

ATOL = 1e-5
CASES = [("synthetic_layered", (3, 4), "p100x4", 16),
         ("chainmm", (), "mixed_gen4", 32),
         ("ffnn", (), "p100x4", 64)]


def _jax_params(d_hidden, seed=0):
    return jax_policies.init_policies(jax.random.PRNGKey(seed),
                                      d_hidden=d_hidden)


def test_params_round_trip_bit_equal():
    tree = to_numpy_params(_jax_params(64))
    params = policies.params_from_jax(tree)
    # the reference's defaults: 40 leaves, 110,978 floats
    assert len(tree_leaves(params)) == 40 and tree_size(params) == 110_978
    back = policies.params_to_numpy(params)
    flat_ref = jax.tree_util.tree_leaves(tree)
    flat_back = jax.tree_util.tree_leaves(back)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(back)
    assert len(flat_ref) == len(flat_back) == 40
    for a, b in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)
    # leaf order follows jax.tree_util's flatten order
    for a, b in zip(flat_ref, tree_leaves(params)):
        assert np.array_equal(a, b.numpy())


def test_fresh_init_matches_reference_shapes_and_scale():
    ours = policies.init_policies(torch.Generator().manual_seed(0))
    ref = to_numpy_params(_jax_params(64))
    assert [tuple(x.shape) for x in tree_leaves(ours)] == \
        [x.shape for x in jax.tree_util.tree_leaves(ref)]
    w = ours["gnn"]["layers"][0]["psi_fwd"]["layers"][0]["w"]
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.05
    assert not ours["sel_head"]["layers"][0]["b"].any()


@pytest.mark.parametrize("gname,args,fleet,d_hidden", CASES)
def test_encodings_and_plc_logits_match(gname, args, fleet, d_hidden):
    gj = getattr(jax_workloads, gname)(*args)
    g = getattr(workloads, gname)(*args)
    devj, dev = jax_fleet(fleet), get_device_model(fleet)
    jparams = _jax_params(d_hidden)
    npp = to_numpy_params(jparams)
    params = policies.params_from_jax(npp)
    gdj = jax_assign.build_graph_data(gj, devj)
    gd = assign.build_graph_data(g, dev, device="cpu")
    H, sel, z = assign.encode(params, gd, backend="torch")
    refs = [jax_policies.episode_encodings(
        jparams, gdj.x, gdj.edges, gdj.edge_feat, gdj.b_path, gdj.t_path,
        backend=b) for b in ("xla", "pallas")]
    refs.append(encode_graph(npp, gj))
    for Hr, selr, zr in refs:
        np.testing.assert_allclose(H.numpy(), np.asarray(Hr), atol=ATOL)
        np.testing.assert_allclose(sel.numpy(), np.asarray(selr), atol=ATOL)
        np.testing.assert_allclose(z.numpy(), np.asarray(zr), atol=ATOL)

    # PLC logits mid-episode: a few vertices placed, nonzero h_dev
    st = EpisodeState(gj, devj)
    rng = np.random.default_rng(0)
    for _ in range(min(5, gj.n - 1)):
        v = int(st.candidates()[0])
        st.step(v, int(rng.integers(dev.n)))
    v = int(st.candidates()[0])
    x_dev = st.device_features(v).astype(np.float32)
    h_dev = rng.standard_normal((dev.n, H.shape[1])).astype(np.float32)
    Hj, _, zj = refs[0]
    lj = jax_policies.plc_logits(jparams, Hj[v], jnp.asarray(h_dev),
                                 jnp.asarray(x_dev), zj[v])
    ln = plc_logits_np(npp, np.asarray(Hj)[v], h_dev, x_dev,
                       np.asarray(zj)[v])
    lt = policies.plc_logits(params, H[v], torch.from_numpy(h_dev),
                             torch.from_numpy(x_dev), z[v])
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    np.testing.assert_allclose(lt.numpy(), ln, atol=ATOL)
    # batched call == per-row calls
    lb = policies.plc_logits(params, H[[v, v]], torch.from_numpy(h_dev)[None]
                             .expand(2, -1, -1), torch.from_numpy(x_dev)[None]
                             .expand(2, -1, -1), z[[v, v]])
    assert torch.equal(lb[0], lt) and torch.equal(lb[1], lt)


def test_encoder_backends_agree_on_cpu():
    """backend="cuda" on CPU tensors takes the plain segment-sum: the
    encodings are identical to backend="torch"."""
    g = workloads.chainmm()
    gd = assign.build_graph_data(g, get_device_model("p100x4"), device="cpu")
    params = policies.init_policies(torch.Generator().manual_seed(1),
                                    d_hidden=16)
    for a, b in zip(assign.encode(params, gd, "torch"),
                    assign.encode(params, gd, "cuda")):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        assign.encode(params, gd, "xla")
