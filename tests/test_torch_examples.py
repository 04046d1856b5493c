"""Port parity for the quickstart and anomaly-hybrid examples
(``repro_torch.examples.quickstart``, ``repro_torch.examples.anomaly_hybrid``)
against the reference's ``examples/quickstart.py`` and
``examples/anomaly_hybrid.py`` on the CPU, at a reduced size.

The reference scripts run at import, so the same reduced-size pipeline goes
through the reference's functions directly here. The reference's fitted
forests are carried across (``ml.trees.ensemble_from_arrays``) and handed
to the port's ``main(models=...)``, so the two packages' random draws
(ROADMAP C3) cannot differ. Every number compared is bit for bit: the
predictions, accuracy, precision / recall / F1, the fraction handled at the
switch, the backend's rows and the flagged count.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parity import port_ensemble, to_np  # noqa: E402

QUICK = dict(n=3000, switch=(10, 5), backend=(8, 6))
ANOMALY = dict(n=3000, n_flows=600, n_buckets=4096, capacity=64,
               switch=(10, 5), backend=(8, 6))
TAU, TRACE_SEED = 0.7, 42       # the reference scripts' constants


def _argv(cfg, **extra):
    argv = ["--device", "cpu", "--n-samples", str(cfg["n"]),
            "--switch-trees", str(cfg["switch"][0]),
            "--switch-depth", str(cfg["switch"][1]),
            "--backend-trees", str(cfg["backend"][0]),
            "--backend-depth", str(cfg["backend"][1])]
    for k, v in extra.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv


def _reference_models(n, switch, backend):
    """The reference's data and forests, seeded as its examples seed them."""
    from repro.data.unsw_like import make_unsw_like, train_test_split
    from repro.ml.trees import fit_random_forest
    x, y = make_unsw_like(n, n_features=5, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y)
    sw = fit_random_forest(xtr, ytr, n_classes=2, n_trees=switch[0],
                           max_depth=switch[1], seed=0)
    be = fit_random_forest(xtr, ytr, n_classes=2, n_trees=backend[0],
                           max_depth=backend[1], seed=1, max_features=5)
    return sw, be, xte, yte


@pytest.fixture(scope="module")
def quickstart_ref():
    """The reference quickstart's steps 1-5 at ``QUICK``."""
    from repro.core.hybrid import hybrid_predict
    from repro.core.inference import table_predict
    from repro.core.mapping import map_tree_ensemble
    from repro.core.resources import artifact_resources
    from repro.ml.metrics import accuracy, precision_recall_f1
    from repro.ml.trees import predict_tree_ensemble
    c = QUICK
    sw, be, xte, yte = _reference_models(c["n"], c["switch"], c["backend"])
    art = map_tree_ensemble(sw, n_features=5)
    pred, _ = table_predict(art, xte)
    res = hybrid_predict(art, lambda rows: predict_tree_ensemble(be, rows),
                         xte, threshold=TAU)
    return dict(models=(sw, be), row=artifact_resources(art).row(),
                pred=np.asarray(pred), switch_acc=accuracy(yte, pred),
                switch_prf=precision_recall_f1(yte, pred),
                hybrid_pred=np.asarray(res.pred),
                hybrid_acc=accuracy(yte, res.pred),
                hybrid_prf=precision_recall_f1(yte, res.pred),
                frac=float(res.fraction_handled))


def test_quickstart_equals_reference(quickstart_ref, capsys):
    from repro_torch.examples import quickstart
    ref = quickstart_ref
    got = quickstart.main(_argv(QUICK),
                          models=[port_ensemble(m) for m in ref["models"]])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"switch artifact: {ref['row']}"
    assert out[1].startswith("switch-only accuracy: ")
    assert out[2].startswith("hybrid accuracy:      ")
    assert "% handled at the switch)" in out[2]
    np.testing.assert_array_equal(to_np(got["pred"]), ref["pred"])
    np.testing.assert_array_equal(to_np(got["hybrid"].pred),
                                  ref["hybrid_pred"])
    assert got["switch_acc"] == float(ref["switch_acc"])
    assert got["hybrid_acc"] == float(ref["hybrid_acc"])
    assert got["switch_prf"] == tuple(float(v) for v in ref["switch_prf"])
    assert got["hybrid_prf"] == tuple(float(v) for v in ref["hybrid_prf"])
    assert got["fraction_handled"] == ref["frac"]
    assert 0.0 < got["fraction_handled"] < 1.0      # both tiers answered


def test_quickstart_fits_its_own_models_on_cpu(capsys):
    from repro_torch.examples import quickstart
    got = quickstart.main(["--device", "cpu", "--n-samples", "1500",
                           "--switch-trees", "3", "--switch-depth", "3",
                           "--backend-trees", "4", "--backend-depth", "4"])
    assert "switch-only accuracy" in capsys.readouterr().out
    assert got["artifact"].device.type == "cpu"
    assert got["models"][0].n_trees == 3 and got["models"][1].n_trees == 4
    assert 0.5 < got["hybrid_acc"] <= 1.0


@pytest.fixture(scope="module")
def anomaly_ref():
    """The reference anomaly example's pipeline at ``ANOMALY``."""
    import jax.numpy as jnp
    from repro.core.mapping import map_tree_ensemble
    from repro.ml.metrics import accuracy, precision_recall_f1
    from repro.ml.trees import predict_tree_ensemble
    from repro.netsim.features import flow_features, packet_features
    from repro.netsim.packets import synth_trace
    from repro.serving.hybrid_serving import HybridServer
    c = ANOMALY
    sw, be, _, _ = _reference_models(c["n"], c["switch"], c["backend"])
    server = HybridServer(map_tree_ensemble(sw, n_features=5),
                          backend_fn=lambda r: predict_tree_ensemble(be, r),
                          threshold=TAU, capacity=c["capacity"])
    trace = synth_trace(n_flows=c["n_flows"], seed=TRACE_SEED)
    pkt = packet_features(trace)
    _, table = flow_features(trace, n_buckets=c["n_buckets"])
    first = np.unique(np.asarray(trace.flow_id), return_index=True)[1]
    rows = np.stack([
        np.asarray(trace.sport, np.float32)[first],
        np.asarray(trace.dport, np.float32)[first],
        np.asarray(trace.proto, np.float32)[first],
        np.minimum(np.asarray(trace.dport, np.float32)[first] % 13, 12),
        (np.asarray(trace.sport)[first] ==
         np.asarray(trace.dport)[first]).astype(np.float32)], axis=1)
    pred, stats = server.classify(jnp.asarray(rows))
    labels = trace.flow_label
    return dict(models=(sw, be), rows=rows, pred=np.asarray(pred),
                pkt=np.asarray(pkt), table=np.asarray(table),
                frac=stats.fraction_handled, backend_rows=stats.backend_rows,
                acc=accuracy(labels, pred),
                prf=precision_recall_f1(labels, pred),
                flagged=int((np.asarray(pred) == 1).sum()),
                n_packets=trace.n_packets)


def test_anomaly_hybrid_equals_reference(anomaly_ref, capsys):
    from repro_torch.examples import anomaly_hybrid
    ref, c = anomaly_ref, ANOMALY
    got = anomaly_hybrid.main(
        _argv(c, n_flows=c["n_flows"],
              n_buckets=c["n_buckets"], capacity=c["capacity"]),
        models=[port_ensemble(m) for m in ref["models"]])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"trace: {ref['n_packets']} packets, {c['n_flows']} flows"
    assert out[1].startswith("handled at switch: ")
    assert f"(backend saw {ref['backend_rows']}/{c['n_flows']} flows)" \
        in out[1]
    assert out[2].startswith(f"accuracy {ref['acc']:.4f}  P/R/F1 ")
    assert out[3] == ("anomalous flows dropped at line rate; "
                      f"{ref['flagged']} flows flagged")
    np.testing.assert_array_equal(got["rows"], ref["rows"])
    np.testing.assert_array_equal(to_np(got["packet_features"]), ref["pkt"])
    np.testing.assert_array_equal(to_np(got["flow_table"]), ref["table"])
    np.testing.assert_array_equal(to_np(got["pred"]), ref["pred"])
    assert got["fraction_handled"] == ref["frac"]
    assert got["backend_rows"] == ref["backend_rows"]
    assert 0 < got["backend_rows"] <= c["capacity"]
    assert got["accuracy"] == float(ref["acc"])
    assert got["prf"] == tuple(float(v) for v in ref["prf"])
    assert got["flagged"] == ref["flagged"]
