"""Port parity for the hybrid tier: dispatch/combine, HybridServer with a
switch artifact and a backend carried across from the reference, table
updates, and the serve launcher at a reduced size on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hybrid as jhybrid  # noqa: E402
from repro.serving.hybrid_serving import HybridServer as JaxServer  # noqa: E402
from repro_torch.core import hybrid as thybrid  # noqa: E402
from repro_torch.serving.hybrid_serving import (HybridServer,  # noqa: E402
                                                HybridStats)
from test_torch_parity import (assert_bit_equal, port_artifact,  # noqa: E402
                               port_ensemble)


@pytest.fixture(scope="module")
def setup(anomaly_data):
    from repro.core.mapping import map_tree_ensemble
    from repro.ml.trees import fit_random_forest, fit_xgboost
    xtr, ytr, xte, yte = anomaly_data
    small = fit_random_forest(xtr, ytr, n_classes=2, n_trees=6, max_depth=4,
                              seed=0)
    big = fit_xgboost(xtr, ytr, n_trees=8, max_depth=4)
    return map_tree_ensemble(small, 5), big, xte, yte


@pytest.mark.parametrize("capacity", [40, 61, 100])
def test_dispatch_combine_match_reference(capacity):
    """Forwarded rows below, at and above capacity (61 are forwarded):
    the same stable order, the same dropped rows, the same scatter."""
    rng = np.random.default_rng(capacity)
    x = rng.normal(size=(200, 5)).astype(np.float32)
    mask = np.zeros(200, bool)
    mask[rng.choice(200, 61, replace=False)] = True
    sw = rng.integers(0, 2, 200).astype(np.int32)
    bj, ij, vj = jhybrid.dispatch(jnp.asarray(x), jnp.asarray(mask), capacity)
    bt, it, vt = thybrid.dispatch(torch.from_numpy(x), torch.from_numpy(mask),
                                  capacity)
    assert_bit_equal(bj, bt)
    assert_bit_equal(ij, it)
    assert_bit_equal(vj, vt)
    assert int(vt.sum()) == min(61, capacity)
    be = rng.integers(0, 2, capacity).astype(np.int32)
    cj = jhybrid.combine(jnp.asarray(sw), jnp.asarray(be), ij, vj)
    sw_t = torch.from_numpy(sw)
    ct = thybrid.combine(sw_t, torch.from_numpy(be), it, vt)
    assert_bit_equal(cj, ct)
    assert_bit_equal(sw, sw_t)                     # combine leaves its input


@pytest.mark.parametrize("tau,capacity", [(0.7, 64), (0.9, 16)])
def test_hybrid_server_matches_reference(tau, capacity, setup):
    art, big, xte, _ = setup
    from repro.ml.trees import predict_margin_xgboost as jax_margin
    from repro_torch.ml.trees import predict_margin_xgboost
    jserver = JaxServer(art, lambda rows: (jax_margin(big, rows) > 0)
                        .astype(jnp.int32), threshold=tau, capacity=capacity)
    tbig = port_ensemble(big)
    tserver = HybridServer(port_artifact(art),
                           lambda rows: (predict_margin_xgboost(tbig, rows) > 0)
                           .to(torch.int32),
                           threshold=tau, capacity=capacity, device="cpu")
    for lo in (0, 256):
        x = xte[lo:lo + 256]
        pj, sj = jserver.classify(x)
        pt, st = tserver.classify(x)
        assert_bit_equal(pj, pt)
        assert sj.fraction_handled == st.fraction_handled
        assert sj.backend_rows == st.backend_rows
        assert st.capacity == capacity


def test_hybrid_stats_are_lazy_tensors(setup):
    art, _, xte, _ = setup
    server = HybridServer(port_artifact(art),
                          lambda rows: torch.zeros(rows.shape[0],
                                                   dtype=torch.int32),
                          capacity=32, device="cpu")
    _, stats = server.classify(torch.from_numpy(xte[:100]))
    frac, rows = stats.as_tensors()
    assert isinstance(frac, torch.Tensor) and isinstance(rows, torch.Tensor)
    assert all(a is b for a, b in zip(stats.as_arrays(), (frac, rows)))
    assert isinstance(stats.fraction_handled, float)
    assert 0 <= stats.backend_rows <= 32
    assert "HybridStats(" in repr(stats)
    assert isinstance(stats, HybridStats)


def test_hybrid_predict_and_serve_match_reference(setup):
    art, _, xte, _ = setup
    x = xte[:300]
    fn_j = lambda rows: (rows[:, 1] > 100).astype(jnp.int32)     # noqa: E731
    fn_t = lambda rows: (rows[:, 1] > 100).to(torch.int32)       # noqa: E731
    rj = jhybrid.hybrid_predict(art, fn_j, x, 0.8)
    rt = thybrid.hybrid_predict(port_artifact(art), fn_t, x, 0.8)
    assert_bit_equal(rj.pred, rt.pred)
    assert_bit_equal(rj.handled, rt.handled)
    assert float(rj.fraction_handled) == float(rt.fraction_handled)
    pj, fj = jhybrid.hybrid_serve(art, fn_j, x, 0.8, 32)
    pt, ft = thybrid.hybrid_serve(port_artifact(art), fn_t, x, 0.8, 32)
    assert_bit_equal(pj, pt)
    assert float(fj) == float(ft)


def test_update_tables_rejects_shape_change(setup, anomaly_data):
    from repro.core.mapping import map_tree_ensemble
    from repro.ml.trees import fit_random_forest
    art, _, xte, _ = setup
    xtr, ytr, _, _ = anomaly_data
    server = HybridServer(port_artifact(art), lambda r: torch.zeros(
        r.shape[0], dtype=torch.int32), device="cpu")
    server.update_tables(port_artifact(art))               # same shapes: fine
    other = fit_random_forest(xtr, ytr, n_classes=2, n_trees=3, max_depth=4,
                              seed=1)
    with pytest.raises(ValueError, match="table shapes changed"):
        server.update_tables(port_artifact(map_tree_ensemble(other, 5)))


def test_server_needs_a_card_unless_told_cpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    art, _, _, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridServer(port_artifact(art), lambda r: r[:, 0])
    with pytest.raises(ValueError, match="use_kernel=True"):
        HybridServer(port_artifact(art), lambda r: r[:, 0], device="cpu",
                     use_kernel=True)
    from repro_torch.kernels.ops import fused_classify
    with pytest.raises(RuntimeError):
        fused_classify(port_artifact(art), np.zeros((2, 5), np.float32))


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--device", "cpu", "--n-samples", "3000",
                      "--backend-trees", "4", "--backend-depth", "4",
                      "--switch-trees", "4", "--switch-depth", "4",
                      "--batch", "256", "--capacity", "64"])
    out = capsys.readouterr().out
    assert "use_case=anomaly backend=ensemble tau=0.7" in out
    assert "acc=" in out and "f1=" in out
    assert "handled_at_switch=" in out and "backend_rows/batch=" in out
    assert res["batches"] == 600 // 256
    assert res["pred"].shape == (512,)
    assert 0.5 < res["acc"] <= 1.0


@pytest.mark.parametrize("n", [200, 256])
def test_loop_tiles_server_matches_reference(n, setup):
    """The server on the per-feature-loop realization (B7's plain version
    here) against the reference's server on its interpret-mode loop kernel:
    a ragged and an aligned batch."""
    from repro.kernels.tuning import TileConfig as JTileConfig
    from repro.ml.trees import predict_margin_xgboost as jax_margin
    from repro_torch.kernels.tuning import TileConfig
    from repro_torch.ml.trees import predict_margin_xgboost
    art, big, xte, _ = setup
    jserver = JaxServer(art, lambda rows: (jax_margin(big, rows) > 0)
                        .astype(jnp.int32), threshold=0.7, capacity=64,
                        use_pallas=True, tiles=JTileConfig(impl="loop"))
    tbig = port_ensemble(big)
    tserver = HybridServer(port_artifact(art),
                           lambda rows: (predict_margin_xgboost(tbig, rows) > 0)
                           .to(torch.int32),
                           threshold=0.7, capacity=64, device="cpu",
                           tiles=TileConfig(impl="loop"))
    assert tserver.tiles.impl == "loop"
    pj, sj = jserver.classify(xte[:n])
    pt, st = tserver.classify(xte[:n])
    assert_bit_equal(pj, pt)
    assert sj.fraction_handled == st.fraction_handled
    assert sj.backend_rows == st.backend_rows


def _flipped(jart):
    """The same tables with every leaf class flipped (0 <-> 1): equal shape
    signature, other contents."""
    import dataclasses
    ta = port_artifact(jart)
    return dataclasses.replace(ta, dtable_class=1 - ta.dtable_class,
                               ftable_flat=None, dtable_flat=None,
                               dtable_pad=None)


def _tensors(art):
    out = [getattr(art, k) for k in ("edges", "ftable", "strides",
                                      "dtable_class", "ftable_flat",
                                      "dtable_flat", "dtable_pad")]
    return out + [art.dtable_value.q, art.dtable_value.scale]


def test_update_tables_copies_in_place(setup):
    """update_tables writes the new contents into the served tensors (a
    captured graph reads those addresses) and serves the new artifact; the
    server owns its tables, so the caller's artifact is left as it was."""
    art, _, xte, _ = setup
    mine = port_artifact(art)
    kept = [t.clone() for t in _tensors(mine)]

    def backend(rows):
        return torch.zeros(rows.shape[0], dtype=torch.int32)

    server = HybridServer(mine, backend, threshold=0.7, capacity=32,
                          device="cpu")
    ptrs = [t.data_ptr() for t in _tensors(server.artifact)]
    assert all(t.data_ptr() != m.data_ptr()
               for t, m in zip(_tensors(server.artifact), _tensors(mine)))
    x = np.asarray(xte[:300], np.float32)
    before, _ = server.classify(x)
    new = _flipped(art)
    server.update_tables(new)
    assert [t.data_ptr() for t in _tensors(server.artifact)] == ptrs
    fresh = HybridServer(new, backend, threshold=0.7, capacity=32,
                         device="cpu")
    after, stats = server.classify(x)
    want, want_stats = fresh.classify(x)
    assert_bit_equal(want, after)
    assert stats.fraction_handled == want_stats.fraction_handled
    assert not torch.equal(before, after)
    for k, t in zip(kept, _tensors(mine)):
        assert torch.equal(k, t)


def test_fuse_does_nothing_on_a_cpu_server(setup):
    art, _, xte, _ = setup

    def backend(rows):
        return (rows[:, 0] > 0).to(torch.int32)

    x = np.asarray(xte[:128], np.float32)
    preds = []
    for fuse in (None, True, False):
        server = HybridServer(port_artifact(art), backend, capacity=32,
                              fuse=fuse, device="cpu")
        assert server._fused_ok is False
        preds.append(server.classify(x)[0])
        assert server._fused_ok is False and not server._graphs
    assert_bit_equal(preds[0], preds[1])
    assert_bit_equal(preds[0], preds[2])
