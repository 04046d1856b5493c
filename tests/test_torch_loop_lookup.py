"""Port parity for the per-feature-loop tree lookup (B7) on the CPU: the
port's plain version (``ensemble_lookup_loop_ref``, and the wrapper on a CPU
tensor) against the reference's Pallas ``_loop_kernel`` in interpret mode at
atol=0, and ``fused_classify(impl='loop')`` against the reference's
``fused_classify(tiles=TileConfig(impl='loop'))``. The CUDA kernel itself
runs only on the card (test_torch_cuda.py and chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ensemble_lookup as jek  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.tuning import TileConfig as JTileConfig  # noqa: E402
from repro_torch.kernels import ensemble_lookup as tek  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import ensemble_lookup_loop_ref  # noqa: E402
from repro_torch.kernels.tuning import TileConfig  # noqa: E402
from test_torch_ensemble_lookup import _grouped_count, _merge_lanes  # noqa: E402
from test_torch_parity import (assert_bit_equal, assert_conf_parity,  # noqa: E402
                               hand_built, port_artifact)


@pytest.fixture(scope="module")
def artifacts(anomaly_data):
    from benchmarks.common import fit_and_map
    from repro.core.mapping import map_tree_ensemble
    from repro.ml.trees import fit_isolation_forest
    xtr, ytr, xte, _ = anomaly_data
    out = {}
    for model in ("DT", "RF", "XGB", "SVM"):
        _, art, _ = fit_and_map(model, xtr, ytr, n_trees=4, max_depth=4)
        out[model] = art
    out["IForest"] = map_tree_ensemble(
        fit_isolation_forest(xtr, n_trees=6, max_depth=4, seed=0), 5)
    return out, xte


def _jax_loop(art, x, vote):
    """The reference's interpret-mode loop kernel on a batch padded to its
    tile (it asserts N % TILE_N == 0), sliced back to N."""
    xp, n = jops._pad_batch(jnp.asarray(x, jnp.float32), jek.TILE_N)
    dtable = art.dtable_class if vote else art.dtable_value.q
    return np.asarray(jek.ensemble_lookup_pallas_loop(
        xp, art.edges, art.ftable, art.strides, dtable.astype(jnp.float32),
        n_classes=art.n_classes, vote=vote, interpret=True))[:n]


def _port_loop(art, x, vote):
    ta = port_artifact(art)
    dtable = (ta.dtable_class if vote else ta.dtable_value.q).to(torch.float32)
    return (torch.from_numpy(np.asarray(x, np.float32)), ta.edges, ta.ftable,
            ta.strides, dtable), dict(n_classes=ta.n_classes, vote=vote)


@pytest.mark.parametrize("n", [1, 37, 200])
@pytest.mark.parametrize("model,vote", [("RF", True), ("XGB", False)])
def test_loop_ref_matches_reference_kernel(model, vote, n, artifacts):
    arts, xte = artifacts
    args, kw = _port_loop(arts[model], xte[:n], vote)
    before = dict(tek.LAUNCHES)
    got = tek.ensemble_lookup_loop(*args, **kw)     # a CPU tensor: the plain
    assert tek.LAUNCHES == before                   # version, no launch
    want = _jax_loop(arts[model], xte[:n], vote)
    assert_bit_equal(want, ensemble_lookup_loop_ref(*args, **kw))
    assert_bit_equal(want, got)


@pytest.mark.parametrize("vote", [True, False])
def test_loop_ref_key_past_s_reads_leaf_zero(vote):
    art = hand_built(vote)
    x = np.random.default_rng(1).normal(size=(256, 4)).astype(np.float32)
    args, kw = _port_loop(art, x, vote)
    got = ensemble_lookup_loop_ref(*args, **kw)
    assert_bit_equal(_jax_loop(art, x, vote), got)
    # the case is real: some (row, tree) keys fall outside [0, S)
    from repro_torch.kernels.ref import bucketize_ref
    ta = port_artifact(art)
    bins = bucketize_ref(args[0], ta.edges).long()
    codes = ta.ftable[torch.arange(4)[None, :], bins]        # (N, F, T)
    keys = (codes * ta.strides.t()[None]).sum(dim=1)
    assert int((keys >= 60).sum()) > 0
    if vote:
        assert float(got.sum()) == 256 * 7                   # every tree votes


@pytest.mark.parametrize("n", [1, 37, 200])
@pytest.mark.parametrize("model", ["DT", "RF", "XGB", "IForest"])
def test_fused_classify_loop_matches_reference(model, n, artifacts):
    arts, xte = artifacts
    ja = arts[model]
    assert jops.fits_vmem(ja)       # the reference then runs its loop kernel
    pj, cj = jops.fused_classify(ja, xte[:n], use_pallas=True,
                                 interpret=True,
                                 tiles=JTileConfig(impl="loop"))
    before = dict(tek.LAUNCHES)
    pt, ct = tops.fused_classify(port_artifact(ja), xte[:n], device="cpu",
                                 tiles=TileConfig(impl="loop"))
    assert tek.LAUNCHES == before
    assert_bit_equal(pj, pt)
    assert_conf_parity(ja.agg, cj, ct)
    assert tops.classify_batch_rows(port_artifact(ja), n,
                                    tiles=TileConfig(impl="loop")) == n


def test_loop_impl_rejects_classical_artifacts(artifacts):
    arts, xte = artifacts
    with pytest.raises(ValueError, match="classical"):
        tops.fused_classify(port_artifact(arts["SVM"]), xte[:8], device="cpu",
                            tiles=TileConfig(impl="loop"))
    with pytest.raises(ValueError):
        jops.fused_classify(arts["SVM"], xte[:8], use_pallas=True,
                            interpret=True, tiles=JTileConfig(impl="loop"))


def test_loop_smem_fit_check(artifacts):
    arts, _ = artifacts
    ta = port_artifact(arts["RF"])
    f, u = ta.edges.shape
    t, s = ta.dtable_class.shape
    head = _up4(2 * f * -(-u // 8)) + 2 * _up4(f * 128)
    expect = 4 * (head + _up4(f * u) + _up4(f * (u + 1) * t) + _up4(t * f)
                  + t * s)
    assert tek.loop_smem_bytes(f, u, t, s, True, 128) == expect
    assert tek.loop_smem_bytes(f, u, t, s, False, 128) == 4 * head
    assert tops.fits_smem(ta, TileConfig(impl="loop"))
    # the mapped 60-tree XGB backend's tables (S = 5712) do not fit: the
    # kernel reads them from global memory
    assert not tek.loop_fits_smem(5, 62, 60, 5712, 128)
    assert tek.loop_fits_smem(5, 62, 10, 136, 128)


def _up4(words):
    return -(-words // 4) * 4


# -- B7's decomposition on the card, modelled in numpy --------------------------

def _loop_model(x, edges, ftable, strides, dtable, n_classes, vote, tile_n):
    """B7 (csrc/ensemble_loop.cu ensemble_loop_kernel) in numpy, in its own
    order: the grouped range match; each tree's key summed in f32 feature
    by feature, every product and sum rounded to f32 (the kernel's
    __fmul_rn / __fadd_rn); a key outside [0, S) reading leaf 0; a row's
    trees split over its lanes, whole trees a lane (tree t to lane
    t % lanes); the lanes' votes or sums met by xor shuffles."""
    n, f = x.shape
    u = edges.shape[1]
    t, s = dtable.shape
    cout = n_classes if vote else 1
    lanes = tek.loop_launch_plan(n, f, u, t, s, True, tile_n)["lanes"]
    bins = _grouped_count(x, edges)
    acc = np.zeros((n, lanes, cout), np.float32)
    for tree in range(t):
        key = np.zeros(n, np.float32)
        for j in range(f):
            code = ftable[j, bins[:, j], tree].astype(np.float32)
            key = key + code * np.float32(strides[tree, j])
        assert key.dtype == np.float32
        key = key.astype(np.int32)
        inside = (key >= 0) & (key < s)
        leaf = np.where(inside, dtable[tree, np.where(inside, key, 0)],
                        np.float32(0))
        add = ((leaf[:, None] == np.arange(cout, dtype=np.float32))
               .astype(np.float32) if vote else leaf[:, None])
        acc[:, tree % lanes] = acc[:, tree % lanes] + add
    return _merge_lanes(acc, cout)


@pytest.mark.parametrize("tile_n", [1, 16, 128, 512])
@pytest.mark.parametrize("model,vote", [("RF", True), ("XGB", False),
                                        ("IForest", False),
                                        ("hand_built", True),
                                        ("hand_built", False)])
def test_loop_decomposition_equals_plain(model, vote, tile_n, artifacts):
    """B7's split of a row's trees over its lanes, its f32 feature-order
    keys and the shuffle merge give ``ensemble_lookup_loop_ref``'s bits,
    with rows on the edges, NaN / +-inf, and (hand-built) keys past S."""
    arts, xte = artifacts
    art = hand_built(vote) if model == "hand_built" else arts[model]
    f = art.edges.shape[0]
    rng = np.random.default_rng(tile_n + f)
    x = (rng.normal(size=(300, f)) * 1.5).astype(np.float32)
    if model != "hand_built":
        x[:150] = np.asarray(xte[:150], np.float32)
    edges = np.asarray(art.edges)
    pick = rng.integers(0, edges.shape[1], (60, f))
    x[150:210] = edges[np.arange(f)[None], pick]
    x[210, 0], x[211, -1], x[212, 0] = np.nan, np.inf, -np.inf
    args, kw = _port_loop(art, x, vote)
    want = ensemble_lookup_loop_ref(*args, **kw)
    got = _loop_model(x, *(a.numpy() for a in args[1:]), kw["n_classes"],
                      vote, tile_n)
    assert_bit_equal(want, got)


@pytest.mark.parametrize("case", ["serve", "serve_512", "xgb", "one_row"])
def test_loop_launch_plan(case):
    """B7's plan: the fused lookup's lanes a row (4 at 128 rows of 10
    trees, 1 at 512), its own shared memory; the XGB 60x6 backend's tables
    are past the budget and stay in global memory."""
    (n, f, u, t, s), tile_n, staged, lanes, threads = {
        "serve": ((2048, 5, 39, 10, 130), 128, True, 4, 512),
        "serve_512": ((2048, 5, 39, 10, 130), 512, True, 1, 512),
        "xgb": ((2048, 5, 62, 60, 5712), 128, False, 4, 512),
        "one_row": ((1, 5, 39, 10, 130), 1, True, 16, 32),
    }[case]
    assert tek.loop_fits_smem(f, u, t, s, tile_n) == staged
    plan = tek.loop_launch_plan(n, f, u, t, s, staged, tile_n)
    assert plan == {"blocks": -(-n // tile_n), "threads": threads,
                    "lanes": lanes,
                    "smem": tek.loop_smem_bytes(f, u, t, s, staged, tile_n)}
    assert plan["smem"] <= tek.SMEM_BUDGET_BYTES
