"""Port parity for the fused tree lookup and fused classify on the CPU: the
port's plain path against the reference's Pallas kernels in interpret mode,
atol=0. The CUDA kernel itself runs only on the card (test_torch_cuda.py
and chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ensemble_lookup as jek  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import tuning as jtuning  # noqa: E402
from repro_torch.kernels import ensemble_lookup as tek  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import tuning as ttuning  # noqa: E402
from test_torch_parity import (assert_bit_equal, assert_conf_parity,  # noqa: E402
                               port_artifact)


@pytest.fixture(scope="module")
def artifacts(anomaly_data):
    from benchmarks.common import fit_and_map
    xtr, ytr, xte, _ = anomaly_data
    out = {}
    for model in ("RF", "XGB", "SVM"):
        _, art, _ = fit_and_map(model, xtr, ytr, n_trees=4, max_depth=4)
        out[model] = art
    return out, xte


def _synthetic_vote(t=40, s=300, c=3, f=4, u=12, seed=0):
    """Reference artifact past the select crossover (T*Sp*Co > 8192)."""
    from repro.core.artifact import TableArtifact, finalize_artifact
    from repro.core.quantize import quantize_fixed
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.normal(size=(f, u)), axis=1).astype(np.float32)
    strides = np.array([[3 ** (f - 1 - j) for j in range(f)]] * t, np.int32)
    dtable = rng.integers(0, c, (t, s)).astype(np.int32)
    art = TableArtifact(
        edges=jnp.asarray(edges), agg="vote", n_classes=c,
        ftable=jnp.asarray(rng.integers(0, 3, (f, u + 1, t)).astype(np.int32)),
        strides=jnp.asarray(strides), dtable_class=jnp.asarray(dtable),
        dtable_value=quantize_fixed(np.zeros((t, s), np.float32), 16))
    return finalize_artifact(art, lane=8)


def _jax_fused(art, x, select):
    """Reference interpret-mode kernel on a batch padded to its tile."""
    xp, n = jops._pad_batch(jnp.asarray(x, jnp.float32), jek.TILE_N)
    return np.asarray(jek.ensemble_lookup_fused(
        xp, art.edges, art.ftable_flat, art.dtable_flat, art.dtable_pad,
        interpret=True, select=select))[:n]


@pytest.mark.parametrize("n", [1, 300])
@pytest.mark.parametrize("select", ["matmul", "compare", "auto"])
@pytest.mark.parametrize("model", ["RF", "XGB"])
def test_fused_lookup_matches_reference_kernel(model, select, n, artifacts):
    arts, xte = artifacts
    ja = arts[model]
    ta = port_artifact(ja)
    x = torch.from_numpy(np.array(xte[:n], np.float32))
    before = dict(tek.LAUNCHES)
    out = tek.ensemble_lookup_fused(x, ta.edges, ta.ftable_flat,
                                    ta.dtable_flat, ta.dtable_pad,
                                    select=select)
    assert tek.LAUNCHES == before               # a CPU tensor never launches
    assert_bit_equal(_jax_fused(ja, xte[:n], select), out)


def test_auto_select_routes_like_the_reference(artifacts):
    arts, xte = artifacts
    big = _synthetic_vote()
    for ja, expect in ((arts["RF"], "matmul"), (big, "compare")):
        cout, t, s_pad = ja.dtable_flat.shape
        ref_pick = ("matmul" if t * s_pad * cout <= jek.SELECT_MATMUL_MAX
                    else "compare")
        assert ref_pick == expect
        assert tek.resolve_select("auto", t, s_pad, cout) == expect
    x = np.random.default_rng(1).normal(size=(130, 4)).astype(np.float32)
    ta = port_artifact(big)
    out = tek.ensemble_lookup_fused(torch.from_numpy(x), ta.edges,
                                    ta.ftable_flat, ta.dtable_flat,
                                    ta.dtable_pad)
    assert_bit_equal(_jax_fused(big, x, "auto"), out)


@pytest.mark.parametrize("vote", [True, False])
def test_compat_entry_matches_reference(vote, artifacts):
    arts, xte = artifacts
    ja = arts["RF" if vote else "XGB"]
    dtable = ja.dtable_class if vote else ja.dtable_value.q
    x = np.array(xte[:128], np.float32)
    expect = jek.ensemble_lookup_pallas(
        jnp.asarray(x), ja.edges, ja.ftable, ja.strides,
        dtable.astype(jnp.float32), n_classes=ja.n_classes, vote=vote,
        interpret=True)
    ta = port_artifact(ja)
    tdt = ta.dtable_class if vote else ta.dtable_value.q
    out = tek.ensemble_lookup(torch.from_numpy(x), ta.edges, ta.ftable,
                              ta.strides, tdt.to(torch.float32),
                              n_classes=ta.n_classes, vote=vote)
    assert_bit_equal(expect, out)
    gather = tref.ensemble_lookup_ref(torch.from_numpy(x), ta.edges,
                                      ta.ftable, ta.strides,
                                      tdt.to(torch.float32),
                                      n_classes=ta.n_classes, vote=vote)
    assert_bit_equal(expect, gather)


@pytest.mark.parametrize("n", [1, 300])
@pytest.mark.parametrize("model", ["RF", "XGB", "SVM"])
def test_fused_classify_matches_reference(model, n, artifacts):
    arts, xte = artifacts
    ja = arts[model]
    pj, cj = jops.fused_classify(ja, xte[:n], use_pallas=True, interpret=True)
    pt, ct = tops.fused_classify(port_artifact(ja), xte[:n], device="cpu")
    assert_bit_equal(pj, pt)
    assert_conf_parity(ja.agg, cj, ct)


@pytest.mark.parametrize("impl", ["ref", "loop"])
def test_fused_classify_impls_agree_on_cpu(impl, artifacts):
    arts, xte = artifacts
    ta = port_artifact(arts["RF"])
    p0, c0 = tops.fused_classify(ta, xte[:200], device="cpu")
    p1, c1 = tops.fused_classify(ta, xte[:200], device="cpu",
                                 tiles=ttuning.TileConfig(impl=impl))
    assert_bit_equal(p0, p1)
    assert_bit_equal(c0, c1)
    with pytest.raises(ValueError):
        tops.fused_classify(ta, xte[:4], device="cpu",
                            tiles=ttuning.TileConfig(impl="nope"))


def test_kernel_routing_rule():
    from repro_torch.device import on_kernel_path
    assert on_kernel_path(torch.zeros(2)) is False
    with pytest.raises(ValueError):
        on_kernel_path(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        tek.resolve_select("gather", 1, 8, 1)


def test_smem_fit_check(artifacts):
    arts, _ = artifacts
    ta = port_artifact(arts["RF"])
    f, u = ta.edges.shape
    fb, t_pad = ta.ftable_flat.shape
    cout, t, s_pad = ta.dtable_flat.shape
    expect = 4 * (f * 128 + f * u + fb * t_pad + cout * t * s_pad)
    assert tops.tree_tables_smem_bytes(ta) == expect
    assert tops.fits_smem(ta)
    big = tek.smem_bytes(5, 62, 64, 64, 60, 5712, 1, "compare", True, 128)
    assert big > tek.SMEM_BUDGET_BYTES
    assert not tek.fits_smem(5, 62, 64, 64, 60, 5712, 1, "compare", 128)
    svm = port_artifact(arts["SVM"])
    f, u = svm.edges.shape
    fb, m_pad = svm.vtable_flat.shape
    assert tops.classical_tables_smem_bytes(svm) == 4 * (f * u + fb * m_pad)
    assert tops.fits_smem(svm)


def test_pad_batch_replicates_last_row():
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    xj, nj = jops._pad_batch(jnp.asarray(x), 8)
    xt, nt = tops._pad_batch(torch.from_numpy(x), 8)
    assert nj == nt == 5
    assert_bit_equal(xj, xt)
    same, n = tops._pad_batch(torch.from_numpy(x), 5)
    assert same.shape == (5, 3) and n == 5
    assert tops.classify_batch_rows(None, 300) == 300


def test_tuning_helpers_match_reference():
    assert ttuning.padded_rows(300, 128) == jtuning.padded_rows(300, 128)
    assert dataclasses.asdict(ttuning.DEFAULT_TILES)["select"] == \
        jtuning.DEFAULT_TILES.select
    costs = {"a": 3.0, "b": 1.0, "boom": None}

    def time_one(c):
        if costs[c] is None:
            raise RuntimeError("unsupported")
        return costs[c]

    for mod in (jtuning, ttuning):
        best, timings = mod.sweep_best(["a", "b", "boom"], time_one,
                                       default="a")
        assert best == "b" and set(timings) == {"a", "b"}
    calls = []
    assert ttuning.measure_min(lambda: calls.append(1), reps=3) >= 0.0
    assert len(calls) == 4
