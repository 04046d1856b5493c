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
from test_torch_parity import (assert_bit_equal, assert_conf_parity,  # noqa: E402
                               port_artifact)


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


def _hand_built(vote: bool, seed: int = 0):
    """A reference artifact whose strides let keys run past S: codes in
    [0, 3) with strides 3^f reach 3^4 - 1 = 80 > S = 60, so a fifth of the
    key space reads leaf 0 in the loop kernel (vote: a vote for class 0)."""
    from repro.core.artifact import TableArtifact
    from repro.core.quantize import quantize_fixed
    rng = np.random.default_rng(seed)
    f, u, t, s, c = 4, 10, 7, 60, 3
    dvals = rng.integers(-900, 900, (t, s)).astype(np.float32)
    return TableArtifact(
        edges=jnp.asarray(np.sort(rng.normal(size=(f, u)), axis=1)
                          .astype(np.float32)),
        agg="vote" if vote else "wsum_sigmoid", n_classes=c if vote else 2,
        ftable=jnp.asarray(rng.integers(0, 3, (f, u + 1, t)).astype(np.int32)),
        strides=jnp.asarray(np.array([[1, 3, 9, 27]] * t, np.int32)),
        dtable_class=jnp.asarray(rng.integers(0, c, (t, s)).astype(np.int32)),
        dtable_value=quantize_fixed(dvals, 16))


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
    art = _hand_built(vote)
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
    expect = 4 * (f * 128 + f * u + f * (u + 1) * t + t * f + t * s)
    assert tek.loop_smem_bytes(f, u, t, s, True, 128) == expect
    assert tek.loop_smem_bytes(f, u, t, s, False, 128) == 4 * f * 128
    assert tops.fits_smem(ta, TileConfig(impl="loop"))
    # the mapped 60-tree XGB backend's tables (S = 5712) do not fit: the
    # kernel reads them from global memory
    assert not tek.loop_fits_smem(5, 62, 60, 5712, 128)
    assert tek.loop_fits_smem(5, 62, 10, 136, 128)
