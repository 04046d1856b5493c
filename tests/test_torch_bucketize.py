"""The standalone range match (B4) on the CPU: the port's plain version
against the reference's at the finance fit's width (F=130) on sorted and
shuffled edge rows, bit for bit, and the kernel's geometry in Python: the
launch plan covers every (row, feature) once, the staged table fits the
shared memory (a table past it takes the serial walk, a narrow one the
per-feature route), the feature slots keep a warp's reads on distinct
banks, and a numpy model of the kernel's count (binary lifting on sorted
rows, group summaries on the rest) equals the plain version. The CUDA
kernel itself runs only on the card (test_torch_cuda.py and
chip_smoke.py)."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import bucketize_ref as jax_bucketize_ref  # noqa: E402
from repro_torch.kernels import bucketize as tbk  # noqa: E402
from repro_torch.kernels.ref import bucketize_ref  # noqa: E402
from test_torch_parity import assert_bit_equal  # noqa: E402

# the package re-exports a function named bucketize over the module's name
jbk = importlib.import_module("repro.kernels.bucketize")

H100_SMS = 132


def _finance_edges(rng, f, u, order):
    """Quantile-like edge rows with ragged +inf pads; 'shuffled' permutes
    each row (the count's semantics, not a search's)."""
    e = np.sort(rng.normal(0, 3, (f, u)), axis=1).astype(np.float32)
    for i in range(f):
        e[i, u - (i % 9):] = np.inf
    if order == "shuffled":
        e = rng.permuted(e, axis=1)
    return e


def _hard_rows(rng, edges, n):
    """Rows around the edges, a quarter exactly on one, and +-inf, NaN."""
    f, u = edges.shape
    x = rng.normal(0, 4, (n, f)).astype(np.float32)
    on = rng.random((n, f)) < 0.25
    pick = edges[np.arange(f)[None, :], rng.integers(0, u, (n, f))]
    x[on & np.isfinite(pick)] = pick[on & np.isfinite(pick)]
    x[:3, 0] = [np.inf, -np.inf, np.nan]
    return x


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("n", [256, 512])
def test_plain_matches_jax_at_finance_width(n, order):
    """F=130, U=63 (the finance fit's shape): the port's plain version
    equals the reference's oracle and its Pallas kernel (interpret mode)
    bit for bit, edge rows sorted and shuffled."""
    rng = np.random.default_rng(n)
    edges = _finance_edges(rng, 130, 63, order)
    x = _hard_rows(rng, edges, n)
    out = bucketize_ref(torch.from_numpy(x), torch.from_numpy(edges))
    assert out.dtype == torch.int32
    assert_bit_equal(np.asarray(jax_bucketize_ref(jnp.asarray(x),
                                                  jnp.asarray(edges))), out)
    assert_bit_equal(np.asarray(jbk.bucketize_pallas(
        jnp.asarray(x), jnp.asarray(edges), interpret=True)), out)
    before = dict(tbk.LAUNCHES)
    assert torch.equal(tbk.bucketize(torch.from_numpy(x),
                                     torch.from_numpy(edges)), out)
    assert tbk.LAUNCHES == before               # a CPU tensor never launches


# (N, F, U): the tree fits' and finance fit's shapes, ragged N, one
# feature, one edge, no edge, a wide table, one past the budget
PLAN_SHAPES = [(16000, 5, 63), (16000, 130, 63), (2048, 130, 63),
               (2049, 130, 63), (1, 130, 63), (777, 1, 63), (300, 7, 1),
               (100, 2, 0), (5000, 3, 3000), (1000, 300, 200)]


@pytest.mark.parametrize("n,f,u", PLAN_SHAPES)
def test_launch_plan_covers_every_element_once(n, f, u):
    """A staged plan's blocks take every flat (row, feature) element of x
    exactly once, with a table that fits a block's 227 KB and a grid of at
    most a block an SM; a narrow table goes a block per (rows, feature); a
    table past the budget takes the serial walk (one element a thread,
    every element covered)."""
    plan = tbk.launch_plan(n, f, u, sms=H100_SMS)
    total = n * f
    geo = plan["table"]
    if plan["route"] == "columns":
        # a block per (COLUMN_BLOCK rows, feature): every element once
        assert f <= tbk.NARROW_F and plan["smem"] <= 48 * 1024
        blocks, feats = plan["grid"]
        assert feats == f and (blocks - 1) * tbk.COLUMN_BLOCK < n \
            <= blocks * tbk.COLUMN_BLOCK
        return
    if geo["bytes"] > tbk.SMEM_BUDGET:
        assert plan["route"] == "serial" and plan["smem"] == 0
        assert plan["grid"] * plan["threads"] >= total
        assert (plan["grid"] - 1) * plan["threads"] < total
        return
    assert plan["route"] == "staged"
    assert plan["smem"] == geo["bytes"] <= tbk.SMEM_BUDGET
    assert 1 <= plan["grid"] <= H100_SMS
    assert tbk.MIN_THREADS <= plan["threads"] <= tbk.THREADS
    assert plan["threads"] % 32 == 0
    assert plan["tile"] == 4 * plan["threads"]
    assert plan["tiles"] * plan["tile"] >= total
    seen = np.zeros(total, np.int32)
    for block in range(plan["grid"]):
        idx = np.fromiter(tbk.tile_elements(plan, block, total), np.int64)
        np.add.at(seen, idx, 1)
    assert (seen == 1).all()


def test_tables_past_the_budget_take_the_serial_walk():
    """The largest U whose table fits at F=130 stages; the next multiple of
    8 does not; F=1 stages a few thousand edges (past the per-feature
    route's 48 KB)."""
    fits = [u for u in range(8, 600, 8)
            if tbk.table_geometry(130, u)["bytes"] <= tbk.SMEM_BUDGET]
    u_max = max(fits)
    assert tbk.launch_plan(16000, 130, u_max, sms=H100_SMS)["route"] == \
        "staged"
    assert tbk.launch_plan(16000, 130, u_max + 8, sms=H100_SMS)["route"] == \
        "serial"
    assert tbk.launch_plan(16000, 1, 5000, sms=H100_SMS)["route"] == "staged"
    # the tree fits' F=5 keeps the per-feature route; the finance fit's F=130
    # stages whole rows
    assert tbk.launch_plan(16000, 5, 63, sms=H100_SMS)["route"] == "columns"
    assert tbk.launch_plan(16000, 130, 63, sms=H100_SMS)["route"] == "staged"


@pytest.mark.parametrize("f", [1, 4, 5, 7, 130, 257])
def test_feature_slots_spread_a_warp_over_the_banks(f):
    """Each feature has its own row slot, a row holds the power of two
    above U (its last entry a +inf pad) and U padded to a multiple of 8,
    the strides are odd (rows in words, summaries in 8-byte units), and the
    32 lanes of a warp reading element j of their 4 (features f0 + 4l + j)
    at one offset hit 32 distinct banks (their summaries: the 16 lanes of a
    half-warp, 16 distinct 8-byte pairs) whenever their features do not
    wrap."""
    for u in (1, 8, 63, 64, 255):
        geo = tbk.table_geometry(f, u)
        q = geo["quarter"]
        slots = [tbk.feature_slot(i, q) for i in range(f)]
        assert len(set(slots)) == f and max(slots) < geo["slots"]
        assert geo["p"] > u and geo["p"] & (geo["p"] - 1) == 0
        assert geo["len"] >= max(geo["p"], geo["up"])
        assert geo["rs"] % 2 == 1 and geo["ss"] % 2 == 1
        assert geo["ss"] >= geo["groups"]
        for f0 in range(max(1, f - 127)):
            for j in range(4):
                feats = [f0 + 4 * lane + j for lane in range(32)]
                if feats[-1] >= f:
                    continue
                banks = {tbk.feature_slot(x, q) * geo["rs"] % 32
                         for x in feats}
                sums = {tbk.feature_slot(x, q) * geo["ss"] % 16
                        for x in feats[:16]}
                assert len(banks) == 32 and len(sums) == 16


def _model_count(x, edges):
    """numpy model of the kernel's count: the row padded with +inf to
    ``len`` entries; a row in order (non-decreasing, no NaN) counts the
    edges below x by binary lifting over its first p entries; any other
    row keeps a (min, max) per group of 8 ((-inf, +inf) with a NaN edge),
    whole groups from the summaries, the one open group edge by edge, the
    whole row when several are open."""
    f, u = edges.shape
    geo = tbk.table_geometry(f, u)
    up = geo["up"]
    rows = np.full((f, geo["len"]), np.inf, np.float32)
    rows[:, :u] = edges
    with np.errstate(invalid="ignore"):
        in_order = (rows[:, :up][:, :-1] <= rows[:, :up][:, 1:]).all(axis=1) \
            if up > 1 else np.ones(f, bool)
    grp = rows[:, :up].reshape(f, up // 8, 8)
    nan = np.isnan(grp).any(axis=2)
    lo = np.where(nan, -np.inf, np.nanmin(np.where(np.isnan(grp), np.inf,
                                                   grp), axis=2))
    hi = np.where(nan, np.inf, np.nanmax(np.where(np.isnan(grp), -np.inf,
                                                  grp), axis=2))
    out = np.zeros(x.shape, np.int32)
    for n in range(x.shape[0]):
        for i in range(f):
            v = x[n, i]
            if in_order[i]:
                c, step = 0, geo["p"] // 2
                while step:
                    c += step if rows[i, c + step - 1] < v else 0
                    step //= 2
                out[n, i] = c
                continue
            with np.errstate(invalid="ignore"):
                above = v > hi[i]
                inside = ~above & ~(v <= lo[i])
            count = 8 * int(above.sum())
            if inside.sum() == 1:
                k = int(np.flatnonzero(inside)[0])
                count += int((v > grp[i, k]).sum())
            elif inside.sum() > 1:
                count = int((v > rows[i, :up]).sum())
            out[n, i] = count
    return out


@pytest.mark.parametrize("case", ["sorted", "shuffled", "nan_edges",
                                  "dup_edges", "inf_edges", "no_edges"])
def test_count_model_equals_plain(case):
    """The count the kernel makes (binary lifting on a sorted row, the group
    summaries on any other) equals the plain version on every kind of row,
    unsorted and NaN included."""
    rng = np.random.default_rng(3)
    f, u = 6, 70
    edges = _finance_edges(rng, f, u, "shuffled" if case == "shuffled"
                           else "sorted")
    if case == "nan_edges":
        edges[0, 9] = np.nan
        edges[1, 64:] = np.nan
    elif case == "dup_edges":
        edges[:, 8:24] = edges[:, 8:9]
    elif case == "inf_edges":
        edges[:, :11] = -np.inf
    elif case == "no_edges":
        edges = np.zeros((f, 0), np.float32)
    x = _hard_rows(rng, edges, 300) if edges.shape[1] else \
        rng.normal(size=(300, f)).astype(np.float32)
    if edges.shape[1] >= 16:
        x[100:110] = edges[:, 7][None]
        x[110:120] = edges[:, 8][None]
    want = bucketize_ref(torch.from_numpy(x), torch.from_numpy(edges))
    assert_bit_equal(_model_count(x, edges), want)
