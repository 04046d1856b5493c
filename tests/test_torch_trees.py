"""Port parity for the tree learners, prediction and the mapping tool: the
same data through ``repro.ml.trees`` and ``repro_torch.ml.trees``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.mapping import map_tree_ensemble as jax_map  # noqa: E402
from repro.ml import metrics as jmetrics  # noqa: E402
from repro.ml import trees as jtrees  # noqa: E402
from repro_torch.core.mapping import map_tree_ensemble  # noqa: E402
from repro_torch.ml import metrics as tmetrics  # noqa: E402
from repro_torch.ml import trees as ttrees  # noqa: E402
from test_torch_parity import (assert_bit_equal, port_ensemble,  # noqa: E402
                               ulp_distance)


@pytest.fixture(scope="module")
def data(anomaly_data):
    xtr, ytr, xte, yte = anomaly_data
    return xtr[:2000], ytr[:2000], xte[:500], yte[:500]


def _edges(xtr):
    return np.array(jtrees.quantile_bin_edges(jnp.asarray(xtr), 64))


def _assert_same_trees(jens, tens):
    assert_bit_equal(jens.feat, tens.feat)
    assert_bit_equal(jens.thresh, tens.thresh)
    assert_bit_equal(jens.leaf, tens.leaf)


def test_quantile_bin_edges_within_one_ulp(data):
    xtr = data[0]
    ej = jtrees.quantile_bin_edges(jnp.asarray(xtr), 64)
    et = ttrees.quantile_bin_edges(torch.from_numpy(xtr), 64)
    assert et.shape == (5, 63)
    assert int(ulp_distance(ej, et).max()) <= 1


def test_decision_tree_bit_exact(data):
    xtr, ytr, _, _ = data
    edges = _edges(xtr)
    jens = jtrees.fit_decision_tree(xtr, ytr, n_classes=2, max_depth=5,
                                    edges=jnp.asarray(edges))
    tens = ttrees.fit_decision_tree(xtr, ytr, n_classes=2, max_depth=5,
                                    edges=edges, device="cpu")
    _assert_same_trees(jens, tens)
    assert tens.kind == "dt"


def _jax_rf_draws(n, n_feat, n_trees, max_features, seed):
    """The reference's bootstrap rows and feature masks (trees.py:228-236)."""
    idx, masks = [], []
    for key in jax.random.split(jax.random.PRNGKey(seed), n_trees):
        k_boot, k_feat = jax.random.split(key)
        idx.append(np.array(jax.random.randint(k_boot, (n,), 0, n)))
        perm = jax.random.permutation(k_feat, n_feat)
        masks.append(np.array(jnp.zeros((n_feat,), bool)
                              .at[perm[:max_features]].set(True)))
    return np.stack(idx), np.stack(masks)


def test_random_forest_bit_exact_with_reference_draws(data):
    xtr, ytr, _, _ = data
    edges = _edges(xtr)
    jens = jtrees.fit_random_forest(xtr, ytr, n_classes=2, n_trees=4,
                                    max_depth=4, seed=3,
                                    edges=jnp.asarray(edges))
    draws = _jax_rf_draws(len(xtr), 5, 4, 2, 3)
    tens = ttrees.fit_random_forest(xtr, ytr, n_classes=2, n_trees=4,
                                    max_depth=4, edges=edges, draws=draws,
                                    device="cpu")
    _assert_same_trees(jens, tens)


def test_random_forest_seeded_draws(data):
    xtr, ytr, _, _ = data
    a = ttrees.fit_random_forest(xtr, ytr, n_classes=2, n_trees=3,
                                 max_depth=3, seed=7, device="cpu")
    b = ttrees.fit_random_forest(xtr, ytr, n_classes=2, n_trees=3,
                                 max_depth=3, seed=7, device="cpu")
    _assert_same_trees(a, b)
    gen = torch.Generator().manual_seed(0)
    idx, masks = ttrees.random_forest_draws(10, 5, 3, 2, gen)
    assert idx.shape == (3, 10) and int(idx.max()) < 10
    assert masks.sum(dim=1).tolist() == [2, 2, 2]


def test_xgboost_same_splits_leaves_close(data):
    """g/h histograms are real sums taken in another order, so the leaves
    agree to rtol 1e-5 and the splits (feature, threshold) exactly."""
    xtr, ytr, _, _ = data
    edges = _edges(xtr)
    jens = jtrees.fit_xgboost(xtr, ytr, n_trees=8, max_depth=4,
                              edges=jnp.asarray(edges))
    tens = ttrees.fit_xgboost(xtr, ytr, n_trees=8, max_depth=4, edges=edges,
                              device="cpu")
    assert_bit_equal(jens.feat, tens.feat)
    assert_bit_equal(jens.thresh, tens.thresh)
    np.testing.assert_allclose(np.asarray(jens.leaf), tens.leaf.numpy(),
                               rtol=1e-5, atol=0)
    assert (tens.kind, tens.base_score, tens.learning_rate) == \
        ("xgb", jens.base_score, jens.learning_rate)


@pytest.fixture(scope="module")
def jax_models(data):
    xtr, ytr, _, _ = data
    rf = jtrees.fit_random_forest(xtr, ytr, n_classes=2, n_trees=5,
                                  max_depth=4, seed=0)
    xgb = jtrees.fit_xgboost(xtr, ytr, n_trees=6, max_depth=4)
    return {"rf": rf, "xgb": xgb}


@pytest.mark.parametrize("kind", ["rf", "xgb"])
def test_map_tree_ensemble_equal_arrays(kind, jax_models):
    jens = jax_models[kind]
    ja = jax_map(jens, 5)
    ta = map_tree_ensemble(port_ensemble(jens), 5)
    for name in ("edges", "ftable", "strides", "dtable_class", "ftable_flat",
                 "dtable_flat", "dtable_pad"):
        assert_bit_equal(getattr(ja, name), getattr(ta, name))
    assert_bit_equal(ja.dtable_value.q, ta.dtable_value.q)
    assert_bit_equal(ja.dtable_value.scale, ta.dtable_value.scale)
    assert (ta.agg, ta.n_classes, ta.base_score, ta.learning_rate) == \
        (ja.agg, ja.n_classes, ja.base_score, ja.learning_rate)


@pytest.mark.parametrize("kind", ["rf", "xgb"])
def test_predictions_equal(kind, jax_models, data):
    _, _, xte, _ = data
    jens = jax_models[kind]
    tens = port_ensemble(jens)
    assert_bit_equal(jtrees.tree_leaf_indices(jens, xte),
                     ttrees.tree_leaf_indices(tens, xte))
    assert_bit_equal(jtrees.predict_tree_ensemble(jens, xte),
                     ttrees.predict_tree_ensemble(tens, xte))
    if kind == "rf":
        assert_bit_equal(jtrees.predict_proba_tree_ensemble(jens, xte),
                         ttrees.predict_proba_tree_ensemble(tens, xte))
    else:
        assert_bit_equal(jtrees.predict_margin_xgboost(jens, xte),
                         ttrees.predict_margin_xgboost(tens, xte))


def test_metrics_match_reference(data):
    _, _, _, yte = data
    pred = np.random.default_rng(0).integers(0, 2, len(yte)).astype(np.int32)
    assert tmetrics.accuracy(yte, pred) == jmetrics.accuracy(yte, pred)
    assert tmetrics.precision_recall_f1(yte, pred) == \
        jmetrics.precision_recall_f1(yte, pred)
    assert tmetrics.accuracy(torch.from_numpy(yte), torch.from_numpy(pred)) \
        == jmetrics.accuracy(yte, pred)


@pytest.mark.parametrize("n_trees,max_depth", [(6, 4), (7, 3)])
def test_tree_vote_predict_matches_reference_and_table(data, n_trees,
                                                       max_depth):
    """The direct per-tree vote (``core.inference.tree_vote_predict``)
    equals the reference's bit for bit and the mapped table's predictions
    (the reference's ``test_rf_vote_equivalence``)."""
    from repro.core.inference import tree_vote_predict as jax_vote
    from repro_torch.core.inference import table_predict, tree_vote_predict
    xtr, ytr, xte, _ = data
    jens = jtrees.fit_random_forest(xtr, ytr, n_classes=2, n_trees=n_trees,
                                    max_depth=max_depth)
    tens = port_ensemble(jens)
    pj, cj = jax_vote(jens, xte)
    pt, ct = tree_vote_predict(tens, torch.from_numpy(xte))
    assert_bit_equal(pj, pt)
    assert_bit_equal(cj, ct)
    p_tab, _ = table_predict(map_tree_ensemble(tens, xtr.shape[1]),
                             torch.from_numpy(xte))
    assert torch.equal(p_tab, pt)

