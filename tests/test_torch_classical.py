"""Port parity for the classical switch models (SVM, naive Bayes, K-Means)
and the isolation forest: training, mapping to tables, classification
through every path up to HybridServer, and the resource/fit accounting —
the same inputs through ``repro`` and ``repro_torch`` on the CPU.

Tolerances, from the arithmetic:
- NB fit: closed form, but its per-class sums (``y1h.T @ x``) associate in
  another order: mu rtol 1e-6, var rtol 1e-4 (var = E[x^2] - mu^2 cancels),
  log priors exact.
- SVM fit: 300 subgradient steps whose matrix-vector products associate in
  another order: weights and bias within atol 5e-4 (measured ~7e-5),
  standardization rtol 1e-6.
- K-Means with the reference's k-means++ centers injected: centers within
  atol 1e-6; the isolation forest with the reference's draws injected:
  trees bit-identical.
- Mapping converted models: artifacts bit-equal. Classification:
  predictions exact, confidence within 2 ulps (test_torch_parity).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import mapping as jmap  # noqa: E402
from repro.core import resources as jres  # noqa: E402
from repro.core.artifact import finalize_artifact as jax_finalize  # noqa: E402
from repro.core.inference import table_predict as jax_table_predict  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.ml import kmeans as jkm  # noqa: E402
from repro.ml import naive_bayes as jnb  # noqa: E402
from repro.ml import svm as jsvm  # noqa: E402
from repro.ml import trees as jtrees  # noqa: E402
from repro.serving.hybrid_serving import HybridServer as JaxServer  # noqa: E402
from repro_torch.core import mapping as tmap  # noqa: E402
from repro_torch.core import resources as tres  # noqa: E402
from repro_torch.core.artifact import TableArtifact, finalize_artifact  # noqa: E402
from repro_torch.core.inference import table_predict  # noqa: E402
from repro_torch.kernels import classical_lookup as tck  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.ml import kmeans as tkm  # noqa: E402
from repro_torch.ml import naive_bayes as tnb  # noqa: E402
from repro_torch.ml import svm as tsvm  # noqa: E402
from repro_torch.ml import trees as ttrees  # noqa: E402
from repro_torch.serving.hybrid_serving import HybridServer  # noqa: E402
from test_torch_parity import (assert_bit_equal, assert_conf_parity,  # noqa: E402
                               port_artifact, port_ensemble, port_kmeans,
                               port_nb, port_svm)

SWITCH_MODELS = ("SVM", "Bayes", "KMeans", "IForest")


@pytest.fixture(scope="module")
def data(anomaly_data):
    xtr, ytr, xte, yte = anomaly_data
    return xtr[:3000], ytr[:3000], xte[:600], yte[:600]


def _edges(xtr):
    return np.array(jtrees.quantile_bin_edges(jnp.asarray(xtr), 64))


def _jax_iforest_draws(n, n_feat, n_trees, depth, sub, seed):
    """The reference's isolation-forest draws (trees.py:320-362): per tree
    a row subsample, then per level the split features and positions, laid
    out in heap order."""
    idx, feat, pos = [], [], []
    for key in jax.random.split(jax.random.PRNGKey(seed), n_trees):
        k_s, key = jax.random.split(key)
        idx.append(np.array(jax.random.choice(k_s, n, (sub,), replace=False)))
        f, u = [], []
        for level in range(depth):
            key, k_f, k_b = jax.random.split(key, 3)
            f.append(np.array(jax.random.randint(k_f, (1 << level,), 0,
                                                 n_feat)))
            u.append(np.array(jax.random.uniform(k_b, (1 << level,))))
        feat.append(np.concatenate(f))
        pos.append(np.concatenate(u))
    return np.stack(idx), np.stack(feat), np.stack(pos)


def _jax_kmeans_init(xtr, k, seed):
    """The reference's k-means++ centers (kmeans.py:19-35), jitted as its
    fit runs them."""
    x = jnp.asarray(xtr, jnp.float32)
    xs = (x - x.mean(0)) / jnp.maximum(x.std(0), 1e-6)
    return np.array(jax.jit(lambda key: jkm._plusplus_init(xs, k, key))(
        jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def jax_models(data):
    xtr, ytr, _, _ = data
    return {
        "SVM": jsvm.fit_linear_svm(xtr, ytr, n_classes=2),
        "Bayes": jnb.fit_gaussian_nb(xtr, ytr, n_classes=2),
        "KMeans": jkm.fit_kmeans(xtr, k=2, seed=0),
        "IForest": jtrees.fit_isolation_forest(xtr, n_trees=6, max_depth=4,
                                               seed=0),
    }


def _jax_artifact(model, jm, xtr):
    if model == "SVM":
        return jmap.map_svm(jm, xtr)
    if model == "Bayes":
        return jmap.map_naive_bayes(jm, xtr)
    if model == "KMeans":
        return jmap.map_kmeans(jm, xtr)
    return jmap.map_tree_ensemble(jm, xtr.shape[1])


@pytest.fixture(scope="module")
def jax_artifacts(jax_models, data):
    xtr = data[0]
    return {m: _jax_artifact(m, jax_models[m], xtr) for m in SWITCH_MODELS}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_gaussian_nb_fit_matches_reference(data, jax_models):
    xtr, ytr, xte, _ = data
    jm = jax_models["Bayes"]
    tm = tnb.fit_gaussian_nb(xtr, ytr, n_classes=2, device="cpu")
    np.testing.assert_allclose(tm.mu.numpy(), np.asarray(jm.mu), rtol=1e-6)
    np.testing.assert_allclose(tm.var.numpy(), np.asarray(jm.var), rtol=1e-4)
    assert_bit_equal(jm.log_prior, tm.log_prior)
    assert_bit_equal(jnb.predict_nb(jm, xte), tnb.predict_nb(tm, xte))
    conv = port_nb(jm)
    np.testing.assert_allclose(tnb.nb_log_likelihood(conv, xte).numpy(),
                               np.asarray(jnb.nb_log_likelihood(jm, xte)),
                               rtol=1e-6)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_linear_svm_fit_matches_reference(n_classes, data):
    xtr, ytr, xte, _ = data
    y = ytr if n_classes == 2 else (
        ytr + (xtr[:, 0] > np.median(xtr[:, 0]))).astype(np.int32)
    jm = jsvm.fit_linear_svm(xtr, y, n_classes=n_classes, epochs=150)
    tm = tsvm.fit_linear_svm(xtr, y, n_classes=n_classes, epochs=150,
                             device="cpu")
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(tm.bias.numpy(), np.asarray(jm.bias),
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(tm.mean.numpy(), np.asarray(jm.mean),
                               rtol=1e-6)
    np.testing.assert_allclose(tm.scale.numpy(), np.asarray(jm.scale),
                               rtol=1e-6)
    assert_bit_equal(jm.pairs, tm.pairs)
    assert_bit_equal(jsvm.predict_svm(jm, xte), tsvm.predict_svm(tm, xte))
    conv = port_svm(jm)
    np.testing.assert_allclose(tsvm.svm_decision_values(conv, xte).numpy(),
                               np.asarray(jsvm.svm_decision_values(jm, xte)),
                               rtol=1e-5, atol=1e-5)
    assert_bit_equal(jsvm.predict_svm(jm, xte), tsvm.predict_svm(conv, xte))


def test_kmeans_matches_reference_with_its_init(data, jax_models):
    xtr, _, xte, _ = data
    jm = jax_models["KMeans"]
    tm = tkm.fit_kmeans(xtr, k=2, init=_jax_kmeans_init(xtr, 2, 0),
                        device="cpu")
    np.testing.assert_allclose(tm.centers.numpy(), np.asarray(jm.centers),
                               rtol=0, atol=1e-6)
    assert_bit_equal(jkm.predict_kmeans(jm, xte), tkm.predict_kmeans(tm, xte))
    conv = port_kmeans(jm)
    np.testing.assert_allclose(tkm.kmeans_sq_dists(conv, xte).numpy(),
                               np.asarray(jkm.kmeans_sq_dists(jm, xte)),
                               rtol=1e-5, atol=1e-5)


def test_kmeans_seeded_init(data):
    xtr = data[0]
    a = tkm.fit_kmeans(xtr, k=3, seed=5, iters=5, device="cpu")
    b = tkm.fit_kmeans(xtr, k=3, seed=5, iters=5, device="cpu")
    assert_bit_equal(a.centers, b.centers)
    assert a.centers.shape == (3, 5)
    gen = torch.Generator().manual_seed(0)
    xs = torch.from_numpy(np.array(xtr[:50], np.float32))
    init = tkm._plusplus_init(xs, 4, gen)
    # every center is a data row, and the four are distinct rows
    assert all(bool((xs == c).all(dim=1).any()) for c in init)
    assert torch.unique(init, dim=0).shape[0] == 4


def test_isolation_forest_bit_exact_with_reference_draws(data):
    xtr, _, xte, _ = data
    edges = _edges(xtr)
    jm = jtrees.fit_isolation_forest(xtr, n_trees=5, max_depth=5,
                                     subsample=200, seed=3,
                                     edges=jnp.asarray(edges))
    draws = _jax_iforest_draws(len(xtr), 5, 5, 5, 200, 3)
    tm = ttrees.fit_isolation_forest(xtr, n_trees=5, max_depth=5,
                                     subsample=200, edges=edges, draws=draws,
                                     device="cpu")
    for name in ("feat", "thresh", "leaf"):
        assert_bit_equal(getattr(jm, name), getattr(tm, name))
    assert (tm.kind, tm.n_classes) == ("iforest", 2)
    assert_bit_equal(jtrees.predict_tree_ensemble(jm, xte),
                     ttrees.predict_tree_ensemble(tm, xte))
    assert_conf_parity("iforest", jtrees.predict_iforest_score(jm, xte),
                       ttrees.predict_iforest_score(tm, xte))


def test_isolation_forest_seeded_draws(data):
    xtr = data[0]
    a = ttrees.fit_isolation_forest(xtr, n_trees=3, max_depth=3, seed=1,
                                    device="cpu")
    b = ttrees.fit_isolation_forest(xtr, n_trees=3, max_depth=3, seed=1,
                                    device="cpu")
    for name in ("feat", "thresh", "leaf"):
        assert_bit_equal(getattr(a, name), getattr(b, name))
    assert a.leaf.shape == (3, 8, 1)
    assert float(a.leaf.sum()) == 3 * 256     # every subsampled row lands
    gen = torch.Generator().manual_seed(0)
    idx, feat, pos = ttrees.isolation_forest_draws(50, 5, 2, 3, 20, gen)
    assert idx.shape == (2, 20) and feat.shape == pos.shape == (2, 7)
    assert all(len(set(r.tolist())) == 20 for r in idx)   # no replacement
    assert int(feat.max()) < 5 and 0.0 <= float(pos.min()) < 1.0


def test_entry_points_run_on_cuda_unless_told_cpu(data, jax_models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for convert, jm in ((port_svm, jax_models["SVM"]),
                        (port_nb, jax_models["Bayes"]),
                        (port_kmeans, jax_models["KMeans"]),
                        (port_ensemble, jax_models["IForest"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert(jm, device=None)
        assert convert(jm).to("cpu") is not None
    xtr, ytr, _, _ = data
    for fit in (lambda: tsvm.fit_linear_svm(xtr, ytr, n_classes=2),
                lambda: tnb.fit_gaussian_nb(xtr, ytr, n_classes=2),
                lambda: tkm.fit_kmeans(xtr, k=2),
                lambda: ttrees.fit_isolation_forest(xtr),
                lambda: tops.bucketize(xtr, np.zeros((5, 3), np.float32))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fit()


# ---------------------------------------------------------------------------
# mapping
# ---------------------------------------------------------------------------

def _port_model(model, jm):
    return {"SVM": port_svm, "Bayes": port_nb, "KMeans": port_kmeans,
            "IForest": port_ensemble}[model](jm)


def _port_map(model, tm, xtr):
    if model == "SVM":
        return tmap.map_svm(tm, xtr)
    if model == "Bayes":
        return tmap.map_naive_bayes(tm, xtr)
    if model == "KMeans":
        return tmap.map_kmeans(tm, xtr)
    return tmap.map_tree_ensemble(tm, xtr.shape[1])


@pytest.mark.parametrize("model", SWITCH_MODELS)
def test_mapping_gives_equal_artifacts(model, data, jax_models, jax_artifacts):
    xtr = data[0]
    ja = jax_artifacts[model]
    ta = _port_map(model, _port_model(model, jax_models[model]), xtr)
    for f in dataclasses.fields(ja):
        v, w = getattr(ja, f.name), getattr(ta, f.name)
        if v is None:
            assert w is None, f.name
        elif hasattr(v, "q"):
            assert_bit_equal(v.q, w.q)
            assert_bit_equal(v.scale, w.scale)
            assert v.bits == w.bits
        elif isinstance(v, (str, int, float)):
            assert v == w, f.name
        else:
            assert_bit_equal(v, w)
    if model == "KMeans":
        assert tmap.map_kmeans(port_kmeans(jax_models[model]), xtr,
                               n_classes=2).n_classes == 2


def test_classical_mapping_takes_tensors(data, jax_models):
    """Training data and models on a device map the same as numpy input."""
    xtr = data[0]
    jm = jax_models["SVM"]
    a = tmap.map_svm(port_svm(jm), xtr)
    b = tmap.map_svm(port_svm(jm), torch.from_numpy(np.array(xtr)))
    assert_bit_equal(a.vtable_flat, b.vtable_flat)
    assert_bit_equal(a.edges, b.edges)


# ---------------------------------------------------------------------------
# classification: table_predict, fused_classify, HybridServer
# ---------------------------------------------------------------------------

def _tau_off_conf(conf) -> float:
    """A threshold inside the widest gap between neighbouring confidences
    in their middle half, so no confidence sits on it in either package."""
    c = np.unique(np.asarray(conf, np.float64))
    lo, hi = len(c) // 4, max(len(c) // 4 + 1, 3 * len(c) // 4)
    gaps = np.diff(c[lo:hi + 1])
    i = lo + int(np.argmax(gaps))
    assert c[i + 1] - c[i] > 1e-5
    return float((c[i] + c[i + 1]) / 2)


@pytest.mark.parametrize("model", SWITCH_MODELS)
def test_table_predict_and_fused_classify_match_reference(model, data,
                                                          jax_artifacts):
    _, _, xte, _ = data
    ja = jax_artifacts[model]
    ta = port_artifact(ja)
    pj, cj = jax_table_predict(ja, xte)
    pt, ct = table_predict(ta, xte)
    assert_bit_equal(pj, pt)
    assert_conf_parity(ja.agg, cj, ct)
    for n in (1, 300):
        pk, ck = jops.fused_classify(ja, xte[:n], use_pallas=True,
                                     interpret=True)
        before = dict(tck.LAUNCHES)
        pf, cf = tops.fused_classify(ta, xte[:n], device="cpu")
        assert tck.LAUNCHES == before            # a CPU tensor never launches
        assert_bit_equal(pk, pf)
        assert_conf_parity(ja.agg, ck, cf)
    # the plain gather realization agrees with the flat-table one
    pr, cr = tops.fused_classify(ta, xte, device="cpu",
                                 tiles=tops.TileConfig(impl="ref"))
    pf, cf = tops.fused_classify(ta, xte, device="cpu")
    assert_bit_equal(pr, pf)
    assert_bit_equal(cr, cf)


@pytest.mark.parametrize("capacity", [32, 128])
@pytest.mark.parametrize("model", SWITCH_MODELS)
def test_hybrid_server_matches_reference(model, capacity, data, jax_artifacts):
    _, _, xte, _ = data
    ja = jax_artifacts[model]
    tau = _tau_off_conf(jax_table_predict(ja, xte)[1])
    jserver = JaxServer(ja, lambda rows: (rows[:, 1] > 100).astype(jnp.int32),
                        threshold=tau, capacity=capacity)
    tserver = HybridServer(port_artifact(ja),
                           lambda rows: (rows[:, 1] > 100).to(torch.int32),
                           threshold=tau, capacity=capacity, device="cpu")
    for lo in (0, 256):
        x = xte[lo:lo + 256]
        pj, sj = jserver.classify(x)
        pt, st = tserver.classify(x)
        assert_bit_equal(pj, pt)
        assert sj.fraction_handled == st.fraction_handled
        assert sj.backend_rows == st.backend_rows


def test_server_serves_kmeans_cluster_ids_unflipped(data, jax_artifacts):
    """The server answers K-Means cluster ids; mapping them to classes is
    the caller's (as the reference's model zoo does outside its server)."""
    _, _, xte, _ = data
    ta = port_artifact(jax_artifacts["KMeans"])
    server = HybridServer(ta, lambda rows: torch.full(
        (rows.shape[0],), 7, dtype=torch.int32), threshold=0.0, device="cpu")
    pred, stats = server.classify(xte[:200])
    assert_bit_equal(table_predict(ta, xte[:200])[0], pred)
    assert stats.fraction_handled == 1.0


# ---------------------------------------------------------------------------
# resources and the deploy guard
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree_artifacts(data):
    from benchmarks.common import fit_and_map
    xtr, ytr, _, _ = data
    return {m: fit_and_map(m, xtr, ytr, n_trees=3, max_depth=3)[1]
            for m in ("DT", "RF", "XGB")}


@pytest.mark.parametrize("model", ("DT", "RF", "XGB") + SWITCH_MODELS)
def test_resources_and_fit_match_reference(model, jax_artifacts,
                                           tree_artifacts):
    ja = {**jax_artifacts, **tree_artifacts}[model]
    ta = port_artifact(ja)
    rj, rt = jres.artifact_resources(ja), tres.artifact_resources(ta)
    assert dataclasses.asdict(rj) == dataclasses.asdict(rt)
    assert rt.row() == rj.row() and rt.kib == rj.kib
    for name, profile in tres.PROFILES.items():
        fj = jres.check_fit(ja, jres.PROFILES[name])
        ft = tres.check_fit(ta, profile)
        assert dataclasses.asdict(fj) == dataclasses.asdict(ft)
        assert ft.row() == fj.row()
        assert tres.check_fit(rt, profile).fits == ft.fits


def test_deploy_guard_raises_where_the_reference_does(data):
    """A 12-tree isolation forest needs 5 + 12 + 1 = 18 tables: it fits the
    Tofino-like budget (32) and not the NIC-like one (16)."""
    xtr = data[0]
    jm = jtrees.fit_isolation_forest(xtr, n_trees=12, max_depth=3, seed=0)
    ja = jmap.map_tree_ensemble(jm, 5)
    ta = port_artifact(ja)
    bare = TableArtifact(edges=ta.edges, agg=ta.agg, n_classes=ta.n_classes,
                         ftable=ta.ftable, strides=ta.strides,
                         dtable_class=ta.dtable_class,
                         dtable_value=ta.dtable_value)
    with pytest.raises(jres.FitError):
        jax_finalize(ja, profile=jres.NIC_LIKE)
    with pytest.raises(tres.FitError) as err:
        finalize_artifact(bare, profile=tres.NIC_LIKE)
    assert "tables: 18 > budget 16" in str(err.value)
    assert err.value.report.fits is False
    ok = finalize_artifact(bare, profile=tres.TOFINO_LIKE)
    jax_finalize(ja, profile=jres.TOFINO_LIKE)
    assert_bit_equal(ja.dtable_flat, ok.dtable_flat)
    assert tres.DEFAULT_PROFILE is tres.TOFINO_LIKE
    assert tres.NIC_LIKE.budgets() == jres.NIC_LIKE.budgets()
