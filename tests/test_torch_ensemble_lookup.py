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
    assert tek.resolve_select("auto", t, s_pad, cout) == "matmul"
    expect = 4 * (_up4(2 * f * -(-u // 8)) + 2 * _up4(f * 128) + _up4(f * u)
                  + fb * _row_stride(t) + cout * t * s_pad)
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


def _up4(words):
    return -(-words // 4) * 4


def _row_stride(t):
    """The staged feature table's row stride in the matmul kernel
    (csrc/ensemble_lookup.cu mm_layout): T rounded up to 4, plus 4 when
    that is a multiple of 8."""
    return _up4(t) + (0 if _up4(t) % 8 else 4)


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


# -- B1's decomposition on the card, modelled in numpy --------------------------

def _grouped_count(x, edges):
    """csrc/range_match.cuh range_match_grouped in numpy: groups of
    RM_GROUP edges (the last one short, no pads), a (min, max) per group
    ((-inf, +inf) for a group holding a NaN); an element above a group's max
    counts the group whole, one at or below its min nothing; inside exactly
    one group it compares that group edge by edge, inside several the whole
    row."""
    n, f = x.shape
    u = edges.shape[1]
    g = tek.RM_GROUP
    n_groups = -(-u // g)
    out = np.zeros((n, f), np.int32)
    for j in range(f):
        row = edges[j]
        padded = np.full(n_groups * g, np.nan, np.float32)  # NaN: never above
        padded[:u] = row
        groups = padded.reshape(n_groups, g)
        real = [row[k:k + g] for k in range(0, u, g)]
        nan = np.array([np.isnan(r).any() for r in real], bool)
        lo = np.array([-np.inf if m else r.min() for r, m in zip(real, nan)])
        hi = np.array([np.inf if m else r.max() for r, m in zip(real, nan)])
        size = np.array([len(r) for r in real])
        v = x[:, j:j + 1]
        above = v > hi[None]
        inside = ~above & ~(v <= lo[None])
        whole = (above * size[None]).sum(axis=1)
        n_open = inside.sum(axis=1)
        which = inside.argmax(axis=1) if n_groups else np.zeros(n, int)
        part = ((v > groups[which]).sum(axis=1) if n_groups
                else np.zeros(n, int))
        full = (v > row[None]).sum(axis=1)
        out[:, j] = np.where(n_open > 1, full,
                             whole + np.where(n_open == 1, part, 0))
    return out


def _edge_case(case, rng, f=4, u=39):
    """An edge table and rows for one range-match case: rows on the edges,
    on the group boundaries, and NaN / +-inf elements."""
    edges = np.sort(rng.normal(size=(f, u)), axis=1).astype(np.float32)
    if case == "unsorted":
        edges = rng.permuted(edges, axis=1)
    elif case == "nan_edges":
        edges[0, 9] = np.nan
        edges[1, 32:] = np.nan
    elif case == "inf_padded":
        edges[:, :5] = -np.inf
        edges[:, u - 13:] = np.inf
    elif case == "duplicates":
        edges[:, 6:26] = edges[:, 6:7]
    elif case == "no_edges":
        edges = np.zeros((f, 0), np.float32)
    elif case == "one_edge":
        edges = edges[:, :1]
    x = (rng.normal(size=(500, f)) * 1.5).astype(np.float32)
    if edges.shape[1]:
        x[:200] = edges[np.arange(f)[None],
                        rng.integers(0, edges.shape[1], (200, f))]
        x[200:210] = edges[:, min(7, edges.shape[1] - 1)][None]
        x[210:220] = edges[:, min(8, edges.shape[1] - 1)][None]
    x[220:223, 0] = [np.nan, np.inf, -np.inf]
    return edges, x


@pytest.mark.parametrize("case", ["sorted", "unsorted", "nan_edges",
                                  "inf_padded", "duplicates", "no_edges",
                                  "one_edge"])
def test_grouped_range_match_equals_plain(case):
    """B1's range match, counted from group summaries, is the plain count on
    any row: sorted or not, NaN edges, +-inf pads, duplicates, values on an
    edge and on a group boundary, NaN and +-inf elements."""
    edges, x = _edge_case(case, np.random.default_rng(len(case)))
    want = tref.bucketize_ref(torch.from_numpy(x), torch.from_numpy(edges))
    assert_bit_equal(want, _grouped_count(x, edges))


def _matmul_model(x, edges, ftable_flat, dtable_flat, tile_n):
    """B1 (csrc/ensemble_lookup.cu ensemble_matmul_kernel) in numpy, in its
    own f32 order: the grouped range match, each tree's key summed feature
    by feature, a row's trees split over ``lanes`` threads (tree t to lane
    t % lanes, each lane summing its trees in order), the lanes' sums met by
    xor shuffles, and class c written by lane c % lanes."""
    n, f = x.shape
    u = edges.shape[1]
    fb, t_pad = ftable_flat.shape
    cout, t, s_pad = dtable_flat.shape
    lanes = tek.launch_plan(n, f, u, fb // f, t_pad, t, s_pad, cout,
                            "matmul", True, tile_n)["lanes"]
    bins = _grouped_count(x, edges)
    rows = bins + np.arange(f)[None] * (fb // f)
    acc = np.zeros((n, lanes, cout), np.float32)
    for tree in range(t):
        key = np.zeros(n, np.float32)
        for j in range(f):
            key = key + ftable_flat[rows[:, j], tree]
        key = key.astype(np.int64)
        lane = tree % lanes
        acc[:, lane] = acc[:, lane] + dtable_flat[:, tree, key].T
    o = lanes // 2
    while o:
        acc = acc + acc[:, np.arange(lanes) ^ o]
        o //= 2
    return acc[:, np.arange(cout) % lanes, np.arange(cout)]


@pytest.mark.parametrize("tile_n", [1, 16, 128, 512])
@pytest.mark.parametrize("model", ["RF", "XGB", "synthetic"])
def test_matmul_decomposition_equals_plain(model, tile_n, artifacts):
    """B1's split of a row's trees over its lanes and the shuffle merge give
    the plain version's bits, with x on the edges and at NaN / +-inf."""
    arts, xte = artifacts
    ta = port_artifact(arts[model] if model != "synthetic"
                       else _synthetic_vote())
    edges = ta.edges.numpy()
    rng = np.random.default_rng(tile_n)
    x = (rng.normal(size=(300, edges.shape[0])) * 1.5).astype(np.float32)
    if model != "synthetic":
        x[:150] = np.asarray(xte[:150], np.float32)
    finite = np.isfinite(edges)
    pick = rng.integers(0, edges.shape[1], (60, edges.shape[0]))
    on = edges[np.arange(edges.shape[0])[None], pick]
    x[150:210] = np.where(finite[np.arange(edges.shape[0])[None], pick], on,
                          x[150:210])
    x[210, 0], x[211, -1], x[212, 0] = np.nan, np.inf, -np.inf
    want = tek.ensemble_lookup_fused_ref(
        torch.from_numpy(x), ta.edges, ta.ftable_flat, ta.dtable_flat,
        ta.dtable_pad, select="matmul")
    got = _matmul_model(x, edges, ta.ftable_flat.numpy(),
                        ta.dtable_flat.numpy(), tile_n)
    assert_bit_equal(want, got)


@pytest.mark.parametrize("case", ["serve_128", "serve_512", "unstaged",
                                  "compare"])
def test_matmul_launch_plan(case):
    """The launch plan at the serve default's shape (RF 10x5 switch: F=5,
    U=39, Bp=40, Tp=16, T=10, Sp=136, Co=2, N=2048) at tile_n 128 and 512,
    for the mapped XGB 60x6 tables forced to the matmul select (too large to
    stage), and the compare select's plan, which is its first design's."""
    serve = (2048, 5, 39, 40, 16, 10, 136, 2)
    xgb = (2048, 5, 62, 64, 64, 60, 5712, 1)
    shape, select, staged, tile_n, want = {
        "serve_128": (serve, "matmul", True, 128,
                      {"blocks": 16, "threads": 512, "lanes": 4,
                       "smem": 4 * (52 + 2 * 640 + 196 + 200 * 12 + 2720)}),
        "serve_512": (serve, "matmul", True, 512,
                      {"blocks": 4, "threads": 512, "lanes": 1,
                       "smem": 4 * (52 + 2 * 2560 + 196 + 200 * 12 + 2720)}),
        "unstaged": (xgb, "matmul", False, 128,
                     {"blocks": 16, "threads": 512, "lanes": 4,
                      "smem": 4 * (80 + 2 * 640)}),
        "compare": (serve, "compare", True, 128,
                    {"blocks": 16, "threads": 128, "lanes": 1,
                     "smem": 4 * (5 * 128 + 195 + 200 * 16 + 1360)}),
    }[case]
    n, f, u, b_pad, t_pad, t, s_pad, cout = shape
    plan = tek.launch_plan(n, f, u, b_pad, t_pad, t, s_pad, cout, select,
                           staged, tile_n)
    assert plan == want
    assert plan["smem"] == tek.smem_bytes(f, u, b_pad, t_pad, t, s_pad, cout,
                                          select, staged, tile_n)
    assert tek.fits_smem(f, u, b_pad, t_pad, t, s_pad, cout, select,
                         tile_n) == (case != "unstaged")


@pytest.mark.parametrize("t", [1, 4, 10, 33, 60, 500])
def test_matmul_launch_plan_is_one_the_kernel_takes(t):
    """Every matmul plan is one the CUDA launcher accepts: whole warps, at
    most MATMUL_THREADS, a power-of-two lane count no larger than the trees
    need, and a block's lanes covering its rows."""
    for tile_n in (1, 2, 16, 31, 128, 512, 1000):
        plan = tek.launch_plan(4096, 5, 39, 40, 16, t, 136, 2, "matmul",
                               False, tile_n)
        lanes, threads = plan["lanes"], plan["threads"]
        assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
        assert lanes <= max(1, 1 << (t - 1).bit_length())
        assert threads % 32 == 0 and 32 <= threads <= tek.MATMUL_THREADS
        assert threads % lanes == 0
        assert plan["blocks"] * tile_n >= 4096 > (plan["blocks"] - 1) * tile_n
