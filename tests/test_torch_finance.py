"""Port parity for the finance use case and the paper's baselines: the
Jane-Street-like data, the aggregate-level and file-level (CSV payload)
features, the SwitchTree / pForest / Clustreams resource estimators, the
finance serving step with its index side channel, the launcher's
``--use-case finance`` and the finance example, on the CPU, against the
reference package (``tests/test_features_netsim.py`` and the reference's
launcher).

Tolerances: every comparison with the reference is bit for bit (the CSV
parse included: the port rounds ``val * 10 + d`` and ``val + d *
frac_scale`` once each, as the reference's compiled scan does). The round trips through the ASCII format
hold the reference's own tolerances (the format keeps 3 decimals).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.netsim import features as jfeat  # noqa: E402
from repro.netsim import packets as jpackets  # noqa: E402
from repro_torch.netsim import features as tfeat  # noqa: E402
from test_torch_parity import (assert_bit_equal, port_artifact,  # noqa: E402
                               port_ensemble)

SWITCH_FEATURES = [42, 43, 45, 124, 126]


@pytest.fixture(scope="module")
def finance_rows():
    """The reference's finance data at a reduced size (4000 rows, 80/20)."""
    from repro.data.janestreet_like import (make_janestreet_like,
                                            train_test_split)
    x, y = make_janestreet_like(4000, seed=0)
    return train_test_split(x, y)


# -- the data -------------------------------------------------------------------

def test_janestreet_like_matches_reference():
    from repro.data import janestreet_like as jd
    from repro_torch.data import janestreet_like as td
    from repro_torch.launch.serve import build_usecase
    assert td.SWITCH_FEATURES == jd.SWITCH_FEATURES == SWITCH_FEATURES
    assert (td.N_FEATURES, td.N_CLASSES) == (jd.N_FEATURES, jd.N_CLASSES)
    for n, seed in ((1000, 0), (777, 3)):
        xj, yj = jd.make_janestreet_like(n, seed=seed)
        xt, yt = td.make_janestreet_like(n, seed=seed)
        assert xt.dtype == xj.dtype and yt.dtype == yj.dtype
        np.testing.assert_array_equal(xj, xt)
        np.testing.assert_array_equal(yj, yt)
        for a, b in zip(jd.train_test_split(xj, yj, seed=seed),
                        td.train_test_split(xt, yt, seed=seed)):
            np.testing.assert_array_equal(a, b)
    ref = jd.train_test_split(*jd.make_janestreet_like(1500, seed=0))
    for a, b in zip(ref, build_usecase("finance", n=1500)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        build_usecase("weather")


# -- aggregate-level features (§5.2) -------------------------------------------

@pytest.mark.parametrize("key", ["dport", "sport", "proto"])
@pytest.mark.parametrize("epoch", [0.0, 1.7e9])
def test_aggregate_features_match_reference(key, epoch):
    tr = jpackets.synth_trace(n_flows=150, seed=4)
    tr.ts = tr.ts + epoch
    jg, jt = jfeat.aggregate_features(tr, key=key, n_buckets=1024)
    tg, tt = tfeat.aggregate_features(tr, key=key, n_buckets=1024,
                                      device="cpu")
    assert tg.dtype == torch.int32 and tt.dtype == torch.float32
    assert_bit_equal(jg, tg)
    assert_bit_equal(jt, tt)
    assert (tt[:, 2] > 0).any()                     # rates survived


def test_aggregate_features_epoch_scale_rate():
    """Rates rebase before the f32 cast, so an epoch-scale offset moves
    them only by rounding (the reference's case)."""
    tr = jpackets.synth_trace(n_flows=150, seed=4)
    _, base = tfeat.aggregate_features(tr, key="dport", n_buckets=1024,
                                       device="cpu")
    tr.ts = tr.ts + 1.7e9
    _, offset = tfeat.aggregate_features(tr, key="dport", n_buckets=1024,
                                         device="cpu")
    np.testing.assert_allclose(offset[:, 2].numpy(), base[:, 2].numpy(),
                               rtol=1e-3, atol=1e-3)


def test_aggregate_features_group_sums():
    tr = jpackets.synth_trace(n_flows=100, seed=2)
    g, agg = tfeat.aggregate_features(tr, key="dport", n_buckets=1024,
                                      device="cpu")
    assert float(agg[:, 0].sum()) == tr.n_packets
    assert float(agg[:, 1].sum()) == float(tr.length.sum())
    assert bool(((g >= 0) & (g < 1024)).all())


# -- file-level features (§5.3) -------------------------------------------------

def _parse_both(payload, cols, width=8):
    ref = jfeat.file_features_csv(jnp.asarray(payload), cols, width=width)
    got = tfeat.file_features_csv(payload, cols, width=width, device="cpu")
    assert got.dtype == torch.float32
    assert_bit_equal(ref, got)
    return got.numpy()


def test_csv_parse_roundtrip():
    vals = np.asarray([[1.25, -3.5, 42.0, 0.001],
                       [-123.4, 7.0, 0.25, 999.9]], np.float32)
    payload = tfeat.encode_csv_payload(vals, width=8)
    np.testing.assert_array_equal(payload,
                                  jfeat.encode_csv_payload(vals, width=8))
    out = _parse_both(payload, [0, 1, 2, 3])
    np.testing.assert_allclose(out, vals, rtol=2e-3, atol=2e-3)


def test_csv_encode_wide_values_roundtrip():
    """Values wider than the field drop fractional digits instead of being
    right-truncated to a different number ("12345.678" -> "12345.68")."""
    vals = np.asarray([[12345.678, -9999.995, 1234567.0, 0.125],
                       [-123456.7, 99999.99, -1.0, 8888.888]], np.float32)
    payload = tfeat.encode_csv_payload(vals, width=8)
    np.testing.assert_array_equal(payload,
                                  jfeat.encode_csv_payload(vals, width=8))
    out = _parse_both(payload, [0, 1, 2, 3])
    np.testing.assert_allclose(out, vals, rtol=1e-3)
    assert payload[0, :8].tobytes().decode("ascii").strip() == "12345.68"


def test_csv_encode_overflow_raises():
    with pytest.raises(ValueError):
        tfeat.encode_csv_payload(np.asarray([[123456789.0]], np.float32),
                                 width=8)


@pytest.mark.parametrize("width", [8, 9])
def test_csv_parse_bit_equals_reference_on_finance_rows(finance_rows, width):
    """The switch columns and every fifth other column of 512 test trades,
    and draws over seven decades, parse to the reference's bits (the
    fraction step rounds once)."""
    xte = finance_rows[2]
    _parse_both(tfeat.encode_csv_payload(xte[:512], width=width),
                SWITCH_FEATURES + list(range(0, 130, 5)), width=width)
    rng = np.random.default_rng(width)
    wide = (rng.normal(size=(600, 12))
            * 10.0 ** rng.integers(-3, 4, (600, 12))).astype(np.float32)
    _parse_both(tfeat.encode_csv_payload(wide, width=width), list(range(12)),
                width=width)


@pytest.mark.parametrize("width", [8, 9, 12, 16])
def test_csv_parse_integer_parts_past_2_24_bit_equal_reference(width):
    """Integer parts drawn from [2^24, 10^8): the integer step rounds once,
    as the reference's fused multiply-add does, so every field parses to
    the reference's bits, and a pure integer to its own nearest f32 (two
    roundings missed about 18% of such fields). Negative at widths past 8
    (the sign needs the ninth character); at widths 12 and 16 with a
    3-digit fraction."""
    rng = np.random.default_rng(width)
    ints = rng.integers(1 << 24, 10 ** 8, (2000, 3)).astype(np.float64)
    if width > 8:
        ints *= np.where(rng.random(ints.shape) < 0.3, -1.0, 1.0)
    vals = ints
    if width >= 12:
        vals = ints + np.sign(ints) * rng.integers(0, 1000, ints.shape) / 1e3
    payload = tfeat.encode_csv_payload(vals, width=width)
    np.testing.assert_array_equal(payload,
                                  jfeat.encode_csv_payload(vals, width=width))
    out = _parse_both(payload, [0, 1, 2], width=width)
    if width < 12:
        np.testing.assert_array_equal(out, ints.astype(np.float32))


def test_split_payload_stitch():
    """A field split across two packets parses after stitching (the
    reference's case), bit for bit."""
    vals = np.asarray([[12.5, -42.25]], np.float32)
    payload = tfeat.encode_csv_payload(vals, width=8)      # (1, 16) bytes
    first, second = payload[:, :11], payload[:, 11:]
    jw = jfeat.stitch_split_payload(jnp.asarray(first), jnp.asarray(second))
    tw = tfeat.stitch_split_payload(first, second, device="cpu")
    assert tw.dtype == torch.uint8
    assert_bit_equal(jw, tw)
    out = tfeat.file_features_csv(tw, [0, 1], width=8)
    assert_bit_equal(jfeat.file_features_csv(jw, [0, 1], width=8), out)
    np.testing.assert_allclose(out.numpy(), vals, rtol=2e-3, atol=2e-3)


def test_split_at_byte_700_stitches_the_finance_rows(finance_rows):
    """The example's wire format: 512 trades of 130 columns, every row
    split at byte 700 (inside column 87); the stitched payload is the
    original and parses the switch columns as the reference does."""
    xte = finance_rows[2][:512]
    payload = tfeat.encode_csv_payload(xte, width=8)
    first = torch.from_numpy(payload[:, :700])
    second = torch.from_numpy(payload[:, 700:])
    whole = tfeat.stitch_split_payload(first, second)
    assert_bit_equal(payload, whole)
    got = tfeat.file_features_csv(whole, SWITCH_FEATURES + [87])
    ref = jfeat.file_features_csv(
        jfeat.stitch_split_payload(jnp.asarray(payload[:, :700]),
                                   jnp.asarray(payload[:, 700:])),
        SWITCH_FEATURES + [87])
    assert_bit_equal(ref, got)
    np.testing.assert_allclose(got.numpy(), xte[:, SWITCH_FEATURES + [87]],
                               atol=6e-4)


# -- the paper's baselines (Figs 6-7) -------------------------------------------

def test_naive_estimators_match_reference(finance_data):
    """SwitchTree, pForest and Clustreams reports on the reference's fits at
    ``benchmarks/baseline_comparison.py``'s shapes (a depth-10 DT at 16
    bins; RFs of 3x4, 5x10 and 10x8), carried across."""
    from repro.core import naive_mappings as jn
    from repro.ml.trees import fit_decision_tree, fit_random_forest
    from repro_torch.core import naive_mappings as tn
    from repro_torch.core.resources import ResourceReport
    xtr, ytr = finance_data[0], finance_data[1]
    f = xtr.shape[1]
    fits = [fit_decision_tree(xtr, ytr, n_classes=2, max_depth=10,
                              n_bins=16)]
    fits += [fit_random_forest(xtr, ytr, n_classes=2, n_trees=t,
                               max_depth=d, seed=0,
                               n_bins=16 if d >= 8 else 64)
             for t, d in ((3, 4), (5, 10), (10, 8))]
    for ens in fits:
        tens = port_ensemble(ens)
        for name in ("switchtree_resources", "pforest_resources"):
            ref = getattr(jn, name)(ens, f)
            got = getattr(tn, name)(tens, f)
            assert isinstance(got, ResourceReport)
            assert dataclasses.asdict(ref) == dataclasses.asdict(got), name
            assert ref.row() == got.row()
    for k, bins in ((2, 64), (4, 16)):
        ref = jn.clustreams_resources(k, f, bins)
        got = tn.clustreams_resources(k, f, bins)
        assert dataclasses.asdict(ref) == dataclasses.asdict(got)


# -- serving: the side channel ------------------------------------------------------

@pytest.fixture(scope="module")
def finance_models(finance_rows):
    """The reference launcher's models at a reduced size: an RF 10x5 switch
    on the five switch features, an XGB backend (8x4) on all 130."""
    from repro.core.mapping import map_tree_ensemble
    from repro.ml.trees import fit_random_forest, fit_xgboost
    xtr, ytr, _, _ = finance_rows
    small = fit_random_forest(xtr[:, SWITCH_FEATURES], ytr, n_classes=2,
                              n_trees=10, max_depth=5, seed=0)
    big = fit_xgboost(xtr, ytr, n_trees=8, max_depth=4)
    return map_tree_ensemble(small, len(SWITCH_FEATURES)), big


@pytest.mark.parametrize("tau,capacity", [(0.7, 64), (0.9, 16)])
def test_finance_serving_matches_reference_launcher(finance_rows,
                                                    finance_models, tau,
                                                    capacity):
    """The port's launcher loop (``serve_batches`` with the side channel)
    against the reference's ``HybridServer`` driven as its launcher drives
    it: the index side channel recomputed per batch with the server's own
    switch realization, ``fuse=False``. Predictions and per-batch stats
    bit for bit."""
    from repro.core.hybrid import dispatch as jdispatch
    from repro.kernels.ops import fused_classify as jclassify
    from repro.ml.trees import predict_margin_xgboost as jmargin
    from repro.serving.hybrid_serving import HybridServer as JaxServer
    from repro_torch.launch import serve
    from repro_torch.serving.hybrid_serving import HybridServer
    _, _, xte, _ = finance_rows
    art, big = finance_models
    batch = 256

    def jbackend(rows_sw):
        idx = jbackend.idx
        return (jmargin(big, jbackend.full_rows[idx]) > 0).astype(jnp.int32)

    jsrv = JaxServer(art, jbackend, threshold=tau, capacity=capacity,
                     fuse=False)
    tbackend = serve.side_channel_backend(port_ensemble(big))
    tsrv = HybridServer(port_artifact(art), tbackend, threshold=tau,
                        capacity=capacity, fuse=False, device="cpu")
    x_sw = xte[:, SWITCH_FEATURES]
    preds, _ = serve.serve_batches(tsrv, torch.from_numpy(x_sw), batch,
                                   x_full=torch.from_numpy(xte))
    assert len(preds) == len(xte) // batch
    n_fwd = 0
    for i, tp in enumerate(preds):
        lo = i * batch
        rows = x_sw[lo:lo + batch]
        jbackend.full_rows = jnp.asarray(xte[lo:lo + batch])
        _, conf = jclassify(art, rows, use_pallas=False)
        fwd = conf < tau
        n_fwd += int(fwd.sum())
        jbackend.idx = jdispatch(jnp.asarray(rows, jnp.float32), fwd,
                                 capacity)[1]
        jp, js = jsrv.classify(rows)
        assert_bit_equal(jp, tp)
    assert_bit_equal(jbackend.idx, tbackend.idx)       # the last batch's
    assert n_fwd > 0


def test_launcher_finance_on_cpu(capsys):
    """``--use-case finance --device cpu`` end to end at a reduced size.
    With capacity = batch every forwarded trade reaches the backend, so the
    served predictions must equal the dense hybrid: the switch's answer
    where it is confident, the backend's on the FULL 130-feature row
    elsewhere; a side channel pointing at the wrong rows would break it."""
    from repro_torch.core.inference import table_predict
    from repro_torch.launch import serve
    from repro_torch.ml.trees import predict_margin_xgboost
    res = serve.main(["--use-case", "finance", "--device", "cpu",
                      "--n-samples", "3000", "--backend-trees", "4",
                      "--backend-depth", "4", "--batch", "256",
                      "--capacity", "256"])
    out = capsys.readouterr().out
    assert "use_case=finance backend=ensemble tau=0.7 device=cpu" in out
    assert "acc=" in out and "f1=" in out and "handled_at_switch=" in out
    assert "route=two-phase fused_ok=False" in out
    assert res["batches"] == 600 // 256
    m = res["pred"].shape[0]
    assert m == 512 and res["x_test"].shape[1] == 5
    assert res["x_full"].shape[1] == 130
    sw, conf = table_predict(res["artifact"], res["x_test"][:m])
    be = (predict_margin_xgboost(res["backend_model"], res["x_full"][:m])
          > 0).to(sw.dtype)
    assert_bit_equal(torch.where(conf >= 0.7, sw, be), res["pred"])
    assert bool((conf < 0.7).any())
    assert 0.5 < res["acc"] <= 1.0


def test_finance_example_on_cpu(capsys):
    from repro_torch.examples import finance_lowlatency as ex
    res = ex.main(["--device", "cpu", "--n-samples", "3000",
                   "--backend-trees", "4", "--backend-depth", "4"])
    out = capsys.readouterr().out
    assert "512 trades parsed from raw csv bytes + classified" in out
    assert "fast-pathed" in out and "tag precision" in out
    assert "switch acc" in out
    assert res["whole"].shape == (512, 130 * 8)
    assert_bit_equal(res["payload"], res["whole"])
    assert_bit_equal(jfeat.file_features_csv(jnp.asarray(res["payload"]),
                                             SWITCH_FEATURES), res["feats"])
    np.testing.assert_allclose(res["feats"].numpy(),
                               res["x_test"][:, SWITCH_FEATURES], atol=6e-4)
    assert res["pred"].shape == (512,)
    assert res["pred"].device == res["feats"].device == res["whole"].device
    assert res["artifact"].device.type == "cpu"
    assert 0.0 <= res["tag_precision"] <= 1.0
    assert 0.5 < res["switch_acc"] <= 1.0
