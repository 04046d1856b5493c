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
from repro.kernels.tuning import TileConfig as JTileConfig  # noqa: E402
from repro_torch.core.artifact import round_up_to_lane  # noqa: E402
from test_torch_parity import (assert_bit_equal, assert_conf_parity,  # noqa: E402
                               hand_built, port_artifact)


@pytest.fixture(scope="module")
def artifacts(anomaly_data):
    from benchmarks.common import fit_and_map
    from repro.core.mapping import map_tree_ensemble
    from repro.ml.trees import fit_isolation_forest
    xtr, ytr, xte, _ = anomaly_data
    out = {}
    for model in ("RF", "XGB", "SVM"):
        _, art, _ = fit_and_map(model, xtr, ytr, n_trees=4, max_depth=4)
        out[model] = art
    out["IForest"] = map_tree_ensemble(
        fit_isolation_forest(xtr, n_trees=6, max_depth=4, seed=0), 5)
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


# -- keys outside [0, Sp): the reference's one-hot match, not an index -------------

PAST_SP = {"hand_built": (7, 60), "wide": (70, 40)}   # (T, S)


def _past_sp_case(shape, vote):
    """A hand-built artifact whose keys reach past Sp and rows drawn over
    its edges; 'wide' (T=70, S=40) puts the vote case past the select
    crossover, so 'auto' takes the compare select there."""
    t, s = PAST_SP[shape]
    ja = hand_built(vote, seed=len(shape), t=t, s=s)
    x = (np.random.default_rng(t).normal(size=(256, 4)) * 1.2).astype(
        np.float32)
    return ja, x


def _assert_keys_past(ja, x, s_pad):
    """The case is real: some (row, tree) keys fall at or past Sp."""
    ta = port_artifact(ja)
    keys = tref.tree_keys(torch.from_numpy(x), ta.edges, ta.ftable,
                          ta.strides)
    assert int((keys >= s_pad).sum()) > 0
    assert int((keys < s_pad).sum()) > 0


@pytest.mark.parametrize("select", ["matmul", "compare", "auto"])
@pytest.mark.parametrize("vote", [True, False])
@pytest.mark.parametrize("shape", sorted(PAST_SP))
def test_key_past_sp_matches_reference(shape, vote, select):
    """A key at or past Sp matches no decision entry, as in the reference's
    one-hot match: the port's lookup equals the reference's interpret-mode
    kernel bit for bit (it indexed out of range before)."""
    ja, x = _past_sp_case(shape, vote)
    dtable = ja.dtable_class if vote else ja.dtable_value.q
    expect = jek.ensemble_lookup_pallas(
        jnp.asarray(x), ja.edges, ja.ftable, ja.strides,
        dtable.astype(jnp.float32), n_classes=ja.n_classes, vote=vote,
        interpret=True, select=select)
    _assert_keys_past(ja, x, round_up_to_lane(PAST_SP[shape][1]))
    ta = port_artifact(ja)
    tdt = ta.dtable_class if vote else ta.dtable_value.q
    out = tek.ensemble_lookup(torch.from_numpy(x), ta.edges, ta.ftable,
                              ta.strides, tdt.to(torch.float32),
                              n_classes=ta.n_classes, vote=vote,
                              select=select)
    assert_bit_equal(expect, out)


@pytest.mark.parametrize("select", ["matmul", "compare", "auto"])
@pytest.mark.parametrize("vote", [True, False])
@pytest.mark.parametrize("shape", sorted(PAST_SP))
def test_fused_classify_key_past_sp_matches_reference(shape, vote, select):
    """fused_classify on a finalized artifact whose keys reach past Sp:
    predictions bit-equal to the reference's, confidence by the parity
    rule."""
    from repro.core.artifact import finalize_artifact
    ja, x = _past_sp_case(shape, vote)
    ja = finalize_artifact(ja, lane=8)
    assert jops.fits_vmem(ja)           # the reference runs its Pallas kernel
    _assert_keys_past(ja, x, ja.dtable_pad.shape[1])
    tiles = dict(select=select)
    pj, cj = jops.fused_classify(ja, x, use_pallas=True, interpret=True,
                                 tiles=JTileConfig(**tiles))
    pt, ct = tops.fused_classify(port_artifact(ja), x, device="cpu",
                                 tiles=ttuning.TileConfig(**tiles))
    assert_bit_equal(pj, pt)
    assert_conf_parity(ja.agg, cj, ct)


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
    # the compare select stages the (T, Sp) table, not the (Co, T, Sp) one
    compare = ttuning.TileConfig(select="compare")
    assert tops.tree_tables_smem_bytes(ta, compare) == \
        expect - 4 * (cout - 1) * t * s_pad
    assert tops.fits_smem(ta, compare)
    big = tek.smem_bytes(5, 62, 64, 64, 60, 5712, 1, "compare", "all", 128)
    assert big > tek.SMEM_BUDGET_BYTES
    assert tek.stage_mode(5, 62, 64, 64, 60, 5712, 1, "compare", 128) != "all"
    # ... and its edges and feature table still fit: staged='keys'
    keys = tek.smem_bytes(5, 62, 64, 64, 60, 5712, 1, "compare", "keys", 128)
    assert keys == big - 4 * 60 * 5712 <= tek.SMEM_BUDGET_BYTES
    assert tek.stage_mode(5, 62, 64, 64, 60, 5712, 1, "compare", 128) == "keys"
    svm = port_artifact(arts["SVM"])
    f, u = svm.edges.shape
    fb = svm.vtable_flat.shape[0]
    m = svm.vtable.q.shape[2]
    # the lane head, the edges and the value table's M live columns
    assert tops.classical_tables_smem_bytes(svm) == 4 * (
        _up4(2 * f * -(-u // 8)) + 2 * _up4(f * 128) + _up4(f * u) + fb * m)
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


def _merge_lanes(acc, cout):
    """The lanes' partial outputs (N, lanes, Co) met by xor shuffles, as
    csrc/lane_lookup.cuh lanes_merge_store does, and column c read from
    lane c % lanes (the lane that writes it)."""
    lanes = acc.shape[1]
    o = lanes // 2
    while o:
        acc = acc + acc[:, np.arange(lanes) ^ o]
        o //= 2
    return acc[:, np.arange(cout) % lanes, np.arange(cout)]


def _lookup_model(x, edges, ftable_flat, dtable_flat, dtable_pad, select,
                  tile_n):
    """B1 and B2 (csrc/ensemble_lookup.cu ensemble_lookup_kernel) in numpy,
    in the kernel's own f32 order: the grouped range match, each tree's key
    summed feature by feature, a key outside [0, Sp) matching no entry (the
    matmul select adds nothing, the compare select reads leaf 0), a row's
    trees split over ``lanes`` threads (tree t to lane t % lanes, each lane
    summing its trees in order), the compare epilogue (a vote per class
    when Co > 1, else the leaf summed), and the lanes met by shuffles."""
    n, f = x.shape
    u = edges.shape[1]
    fb, t_pad = ftable_flat.shape
    cout, t, s_pad = dtable_flat.shape
    lanes = tek.launch_plan(n, f, u, fb // f, t_pad, t, s_pad, cout,
                            select, "all", tile_n)["lanes"]
    bins = _grouped_count(x, edges)
    rows = bins + np.arange(f)[None] * (fb // f)
    acc = np.zeros((n, lanes, cout), np.float32)
    zero = np.float32(0)
    for tree in range(t):
        key = np.zeros(n, np.float32)
        for j in range(f):
            key = key + ftable_flat[rows[:, j], tree]
        key = key.astype(np.int64)
        inside = (key >= 0) & (key < s_pad)
        k = np.where(inside, key, 0)
        if select == "matmul":
            add = np.where(inside[None], dtable_flat[:, tree, k], zero).T
        else:
            leaf = np.where(inside, dtable_pad[tree, k], zero)
            add = ((leaf[:, None] == np.arange(cout, dtype=np.float32))
                   .astype(np.float32) if cout > 1 else leaf[:, None])
        lane = tree % lanes
        acc[:, lane] = acc[:, lane] + add
    return _merge_lanes(acc, cout)


def _model_case(model, tile_n, artifacts):
    """(port artifact, rows) for the numpy models: test rows, rows on the
    edges, NaN and +-inf; the hand-built artifact's keys run past Sp."""
    arts, xte = artifacts
    if model == "synthetic":
        ja = _synthetic_vote()
    elif model == "hand_built":
        from repro.core.artifact import finalize_artifact
        ja = finalize_artifact(hand_built(True), lane=8)
    else:
        ja = arts[model]
    ta = port_artifact(ja)
    edges = ta.edges.numpy()
    rng = np.random.default_rng(tile_n)
    x = (rng.normal(size=(300, edges.shape[0])) * 1.5).astype(np.float32)
    if model in arts:
        x[:150] = np.asarray(xte[:150], np.float32)
    finite = np.isfinite(edges)
    pick = rng.integers(0, edges.shape[1], (60, edges.shape[0]))
    on = edges[np.arange(edges.shape[0])[None], pick]
    x[150:210] = np.where(finite[np.arange(edges.shape[0])[None], pick], on,
                          x[150:210])
    x[210, 0], x[211, -1], x[212, 0] = np.nan, np.inf, -np.inf
    return ta, x


def _check_model(select, model, tile_n, artifacts):
    ta, x = _model_case(model, tile_n, artifacts)
    want = tek.ensemble_lookup_fused_ref(
        torch.from_numpy(x), ta.edges, ta.ftable_flat, ta.dtable_flat,
        ta.dtable_pad, select=select)
    got = _lookup_model(x, ta.edges.numpy(), ta.ftable_flat.numpy(),
                        ta.dtable_flat.numpy(), ta.dtable_pad.numpy(), select,
                        tile_n)
    assert_bit_equal(want, got)


@pytest.mark.parametrize("tile_n", [1, 16, 128, 512])
@pytest.mark.parametrize("model", ["RF", "XGB", "synthetic", "IForest",
                                   "hand_built"])
def test_matmul_decomposition_equals_plain(model, tile_n, artifacts):
    """B1's split of a row's trees over its lanes and the shuffle merge give
    the plain version's bits, with x on the edges and at NaN / +-inf, and
    keys past Sp adding nothing."""
    _check_model("matmul", model, tile_n, artifacts)


@pytest.mark.parametrize("tile_n", [1, 16, 128, 512])
@pytest.mark.parametrize("model", ["RF", "XGB", "synthetic", "IForest",
                                   "hand_built"])
def test_compare_decomposition_equals_plain(model, tile_n, artifacts):
    """B2: the same split and merge with the compare epilogue (votes for
    RF, the synthetic Co=3 artifact and the hand-built one, sums for XGB and
    the isolation forest) give the plain version's bits; keys past Sp read
    leaf 0."""
    _check_model("compare", model, tile_n, artifacts)


SERVE = (2048, 5, 39, 40, 16, 10, 136, 2)     # N, F, U, Bp, Tp, T, Sp, Co
XGB = (2048, 5, 62, 64, 64, 60, 5712, 1)
IFOREST = (2048, 5, 63, 64, 32, 32, 7488, 1)
SYNTHETIC = (2048, 5, 40, 48, 40, 40, 304, 3)


@pytest.mark.parametrize("case", ["serve_128", "serve_512", "unstaged",
                                  "compare"])
def test_matmul_launch_plan(case):
    """The launch plan at the serve default's shape (RF 10x5 switch: F=5,
    U=39, Bp=40, Tp=16, T=10, Sp=136, Co=2, N=2048) at tile_n 128 and 512,
    for the mapped XGB 60x6 tables forced to the matmul select with nothing
    staged, and the compare select's plan at the serve shape: the matmul
    select's lanes, with the (T, Sp) decision table staged in place of the
    (Co, T, Sp) one."""
    shape, select, staged, tile_n, want = {
        "serve_128": (SERVE, "matmul", "all", 128,
                      {"blocks": 16, "threads": 512, "lanes": 4, "stage": 2,
                       "smem": 4 * (52 + 2 * 640 + 196 + 200 * 12 + 2720)}),
        "serve_512": (SERVE, "matmul", "all", 512,
                      {"blocks": 4, "threads": 512, "lanes": 1, "stage": 2,
                       "smem": 4 * (52 + 2 * 2560 + 196 + 200 * 12 + 2720)}),
        "unstaged": (XGB, "matmul", "none", 128,
                     {"blocks": 16, "threads": 512, "lanes": 4, "stage": 0,
                      "smem": 4 * (80 + 2 * 640)}),
        "compare": (SERVE, "compare", "all", 128,
                    {"blocks": 16, "threads": 512, "lanes": 4, "stage": 2,
                     "smem": 4 * (52 + 2 * 640 + 196 + 200 * 12 + 1360)}),
    }[case]
    n, f, u, b_pad, t_pad, t, s_pad, cout = shape
    plan = tek.launch_plan(n, f, u, b_pad, t_pad, t, s_pad, cout, select,
                           staged, tile_n)
    assert plan == want
    assert plan["smem"] == tek.smem_bytes(f, u, b_pad, t_pad, t, s_pad, cout,
                                          select, staged, tile_n)
    assert (tek.stage_mode(f, u, b_pad, t_pad, t, s_pad, cout, select,
                           tile_n) == "all") == (case != "unstaged")


@pytest.mark.parametrize("case", ["iforest", "xgb_compare", "xgb_matmul",
                                  "synthetic_compare", "synthetic_matmul",
                                  "serve_compare_512"])
def test_compare_launch_plan(case):
    """The staging mode the fit check picks, and the plan it gives: the
    isolation forest's 32 x 7488 decision table (958 KB) and the XGB
    backend's 60 x 5712 are past the budget, so only the edges and the
    feature table (its T columns in rows of 36 or 60 words) are staged; the
    synthetic Co=3 vote artifact (T=40, Sp=304) stages every table with
    either select."""
    shape, select, tile_n, mode, lanes, tables = {
        "iforest": (IFOREST, "compare", 128, "keys", 4, 316 + 320 * 36),
        "xgb_compare": (XGB, "compare", 128, "keys", 4, 312 + 320 * 60),
        "xgb_matmul": (XGB, "matmul", 128, "keys", 4, 312 + 320 * 60),
        "synthetic_compare": (SYNTHETIC, "compare", 128, "all", 4,
                              200 + 240 * 44 + 40 * 304),
        "synthetic_matmul": (SYNTHETIC, "matmul", 128, "all", 4,
                             200 + 240 * 44 + 3 * 40 * 304),
        "serve_compare_512": (SERVE, "compare", 512, "all", 1,
                              196 + 200 * 12 + 1360),
    }[case]
    n, f, u, b_pad, t_pad, t, s_pad, cout = shape
    assert tek.stage_mode(f, u, b_pad, t_pad, t, s_pad, cout, select,
                          tile_n) == mode
    plan = tek.launch_plan(n, f, u, b_pad, t_pad, t, s_pad, cout, select,
                           mode, tile_n)
    head = _up4(2 * f * -(-u // 8)) + 2 * _up4(f * tile_n)
    assert plan == {"blocks": -(-n // tile_n), "threads": 512,
                    "lanes": lanes, "stage": tek.STAGE_MODES[mode],
                    "smem": 4 * (head + tables)}
    assert plan["smem"] <= tek.SMEM_BUDGET_BYTES
    for bad in ("some", True, False):                 # mode names only
        with pytest.raises(ValueError):
            tek.launch_plan(n, f, u, b_pad, t_pad, t, s_pad, cout, select,
                            bad, tile_n)


@pytest.mark.parametrize("t", [1, 4, 10, 33, 60, 500])
def test_matmul_launch_plan_is_one_the_kernel_takes(t):
    """Every plan, of either select, is one the CUDA launcher accepts: whole
    warps, at most BLOCK_THREADS, a power-of-two lane count no larger than
    the trees need, and a block's lanes covering its rows."""
    for select in ("matmul", "compare"):
        for tile_n in (1, 2, 16, 31, 128, 512, 1000):
            plan = tek.launch_plan(4096, 5, 39, 40, 16, t, 136, 2, select,
                                   "none", tile_n)
            lanes, threads = plan["lanes"], plan["threads"]
            assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
            assert lanes <= max(1, 1 << (t - 1).bit_length())
            assert threads % 32 == 0 and 32 <= threads <= tek.BLOCK_THREADS
            assert threads % lanes == 0
            assert plan["blocks"] * tile_n >= 4096 > (plan["blocks"] - 1) * tile_n
