"""Port parity for the classical lookup (B3) and the standalone range match
(B4) on the CPU: the port's plain versions against the reference's Pallas
kernels in interpret mode, atol=0, at the reference's own test cases
(tests/test_kernels.py), plus the flat value-table layout, the
shared-memory fit check and the build's source digest. The CUDA kernels run
only on the card (test_torch_cuda.py and chip_smoke.py)."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import artifact as jart  # noqa: E402
from repro_torch.core import artifact as tart  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bucketize as tbk  # noqa: E402
from repro_torch.kernels import classical_lookup as tck  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_parity import assert_bit_equal  # noqa: E402

# the package re-exports a function named bucketize over the module's name
jbk = importlib.import_module("repro.kernels.bucketize")
jck = importlib.import_module("repro.kernels.classical_lookup")

# tests/test_kernels.py:29 and :95 — (n, f, u) and (n, f, u, m)
BUCKETIZE_CASES = [(256, 1, 1), (256, 5, 7), (512, 3, 33), (256, 8, 64),
                   (512, 16, 128)]
CLASSICAL_CASES = [(128, 1, 4, 1), (128, 5, 32, 2), (256, 8, 64, 5)]

# values exactly on an edge, between edges, past the last one, +-inf, NaN
EDGE_ROW = np.array([[1.0, 2.0, 3.0, np.inf]], np.float32)
EDGE_VALUES = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 99.0, -1e30,
                        np.nextafter(np.float32(3.0), np.float32(4.0)),
                        np.inf, -np.inf, np.nan], np.float32)


def _edges(rng, f, u, pad_frac=0.3):
    """The reference test's ragged edge table (+inf pads)."""
    e = np.sort(rng.normal(0, 10, (f, u)).astype(np.float32), axis=1)
    for i in range(f):
        k = rng.integers(0, max(1, int(u * pad_frac)) + 1)
        if k:
            e[i, u - k:] = np.inf
    return e


def _jax_bucketize(x, edges):
    """Reference interpret-mode kernel on a batch padded to its tile."""
    n = x.shape[0]
    pad = (-n) % jbk.TILE_N
    xp = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)]) if pad else x
    return np.asarray(jbk.bucketize_pallas(jnp.asarray(xp), jnp.asarray(edges),
                                           interpret=True))[:n]


@pytest.mark.parametrize("n,f,u", BUCKETIZE_CASES + [(300, 5, 63)])
def test_bucketize_matches_reference_kernel(n, f, u):
    rng = np.random.default_rng(n + f + u)
    x = rng.normal(0, 12, (n, f)).astype(np.float32)
    edges = _edges(rng, f, u)
    before = dict(tbk.LAUNCHES)
    out = tbk.bucketize(torch.from_numpy(x), torch.from_numpy(edges))
    assert tbk.LAUNCHES == before               # a CPU tensor never launches
    assert out.dtype == torch.int32
    assert_bit_equal(_jax_bucketize(x, edges), out)
    assert_bit_equal(out, tops.bucketize(x, edges, device="cpu"))


def test_bucketize_edge_values_exact():
    """x > e: a value on an edge stays below it, NaN lands in bin 0, +inf
    above every finite edge and never above a +inf pad."""
    x = np.tile(EDGE_VALUES[:, None], (24, 1))
    out = tbk.bucketize(torch.from_numpy(x), torch.from_numpy(EDGE_ROW))
    assert_bit_equal(_jax_bucketize(x, EDGE_ROW), out)
    assert out[:11, 0].tolist() == [0, 0, 1, 1, 2, 3, 0, 3, 3, 0, 0]


@pytest.mark.parametrize("n,f,u,m", CLASSICAL_CASES)
def test_classical_lookup_matches_reference_kernel(n, f, u, m):
    rng = np.random.default_rng(n + f + u + m)
    x = rng.normal(0, 5, (n, f)).astype(np.float32)
    edges = _edges(rng, f, u)
    vtable = rng.integers(-1000, 1000, (f, u + 1, m)).astype(np.float32)
    expect = np.asarray(jck.classical_lookup_pallas(
        jnp.asarray(x), jnp.asarray(edges), jnp.asarray(vtable),
        interpret=True))
    xt, et = torch.from_numpy(x), torch.from_numpy(edges)
    before = dict(tck.LAUNCHES)
    out = tck.classical_lookup(xt, et, torch.from_numpy(vtable))
    assert tck.LAUNCHES == before
    assert out.shape == (n, m)
    assert_bit_equal(expect, out)
    assert_bit_equal(expect, tref.classical_lookup_ref(
        xt, et, torch.from_numpy(vtable)))
    # the flat-table entry the server uses, on a ragged batch
    flat = tart.flatten_vtable(torch.from_numpy(vtable))
    jflat = jart.flatten_vtable(jnp.asarray(vtable), 8)
    assert_bit_equal(jflat, flat)
    k = n - 27
    jout = np.asarray(jck.classical_lookup_fused(
        jnp.asarray(x[:n // 2]), jnp.asarray(edges), jflat, interpret=True,
        tile_n=n // 2))
    assert jout.shape[1] == flat.shape[1]
    assert_bit_equal(jout[:, :m], tck.classical_lookup_fused(
        xt[:n // 2], et, flat, m))
    assert_bit_equal(expect[:k], tck.classical_lookup_fused_ref(
        xt[:k], et, flat, m))


def test_classical_lookup_edge_values_exact():
    x = np.tile(EDGE_VALUES[:, None], (24, 1))
    vtable = np.array([[[1.0, -7.0], [10.0, 70.0], [100.0, -700.0],
                        [1000.0, 7000.0], [9.0, 9.0]]], np.float32)
    expect = np.asarray(jck.classical_lookup_pallas(
        jnp.asarray(x[:256]), jnp.asarray(EDGE_ROW), jnp.asarray(vtable),
        interpret=True))
    out = tck.classical_lookup(torch.from_numpy(x), torch.from_numpy(EDGE_ROW),
                               torch.from_numpy(vtable))
    assert_bit_equal(expect, out[:256])
    assert out[:11, 0].tolist() == [1, 1, 10, 10, 100, 1000, 1, 1000, 1000,
                                    1, 1]


def test_classical_smem_fit_check():
    """smem_bytes mirrors cl_layout: the lane head (a (min, max) per group
    of 8 edges, the block's rows of x and their offsets), the edges, and
    the value table's M live columns, packed."""
    head = 4 * (80 + 2 * 640)            # F=5, U=63 (8 groups), 128 rows
    # the served shape (F=5, 64 bins, M=2 of Mp=8): ~9 KB staged
    assert tck.smem_bytes(5, 63, 64, 2, "all", 128) == \
        head + 4 * (316 + 5 * 64 * 2)
    assert tck.smem_bytes(5, 63, 64, 2, "edges", 128) == head + 4 * 316
    assert tck.smem_bytes(5, 63, 64, 2, "none", 128) == head
    assert tck.fits_smem(5, 63, 64, 2)
    assert tck.stage_mode(5, 63, 64, 2, 128) == "all"
    # a 5-class SVM at 128 bins (M=10): past 48 KB, so staged through the
    # opt-in
    opt_in = tck.smem_bytes(8, 127, 128, 10, "all", 128)
    assert 48 * 1024 < opt_in <= tck.SMEM_BUDGET_BYTES
    # a table past the budget: the edges alone are staged
    assert not tck.fits_smem(64, 255, 256, 16)
    assert tck.stage_mode(64, 255, 256, 16, 128) == "edges"
    assert tck.stage_mode(2048, 255, 256, 1, 128) == "none"
    with pytest.raises(ValueError):
        tck.smem_bytes(5, 63, 64, 2, "keys", 128)


def test_wrappers_route_by_device():
    x = torch.zeros((4, 3))
    edges = torch.zeros((3, 7))
    flat = torch.zeros((3 * 8, 8))
    assert tck.classical_lookup_fused(x, edges, flat, 2).shape == (4, 2)
    assert tbk.bucketize(x, edges).shape == (4, 3)
    with pytest.raises(ValueError):
        tck.classical_lookup_fused(x.to("meta"), edges, flat, 2)


def test_library_digest_covers_shared_headers(tmp_path, monkeypatch):
    """An edited header gives a new library name, so a stale build of a
    source that includes it is never loaded."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("k.")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)
    assert _build.sources() == ["k"]


def test_every_kernel_source_includes_the_shared_range_match():
    """Every kernel source that range-matches calls a device function of
    range_match.cuh: the plain count, its grouped form, or (the lane-split
    tree lookups B1/B2/B7) lane_lookup.cuh's lane_range_match, which runs
    the grouped form; the streaming kernels (stream_update, evict) do no
    range match and leave the header out."""
    texts = {name: (_build.CSRC_DIR / f"{name}.cu").read_text()
             for name in _build.sources()}
    calls = ("range_match<", "range_match_grouped<", "lane_range_match<")
    users = {name for name, text in texts.items()
             if any(call in text for call in calls)}
    assert users == {"bucketize", "classical_lookup", "ensemble_lookup",
                     "ensemble_loop"}
    for name, text in texts.items():
        assert ('#include "range_match.cuh"' in text) == (name in users), name


def _group_count(x, edges):
    """The card's B4 count (csrc/bucketize.cu) in numpy: each row padded
    with +inf to a multiple of 8, a (min, max) per group of 8 edges
    ((-inf, +inf) for a group holding a NaN); an element above a group's
    max takes 8, at or below its min 0; inside exactly one group it
    compares that group, inside several the whole row."""
    n, f = x.shape
    u = edges.shape[1]
    up = -(-u // 8) * 8
    if up == 0:
        return np.zeros((n, f), np.int32)
    rows = np.full((f, up), np.inf, np.float32)
    rows[:, :u] = edges
    groups = rows.reshape(f, up // 8, 8)
    nan = np.isnan(groups).any(axis=2)
    lo = np.where(nan, -np.inf, np.nanmin(np.where(nan[..., None], 0, groups),
                                          axis=2))
    hi = np.where(nan, np.inf, np.nanmax(np.where(nan[..., None], 0, groups),
                                         axis=2))
    out = np.zeros((n, f), np.int32)
    for j in range(f):
        v = x[:, j:j + 1]
        above = v > hi[j][None]
        inside = ~above & ~(v <= lo[j][None])
        whole = 8 * above.sum(axis=1)
        one = inside.sum(axis=1) == 1
        which = inside.argmax(axis=1)
        part = (v > groups[j][which]).sum(axis=1)
        full = (v > rows[j][None]).sum(axis=1)
        out[:, j] = np.where(inside.sum(axis=1) > 1, full,
                             whole + np.where(one, part, 0))
    return out


@pytest.mark.parametrize("case", ["sorted", "nan_edges", "dup_edges",
                                  "inf_edges", "out_of_order", "no_edges"])
def test_group_summary_count_equals_plain(case):
    """The card's two-level count is the plain count on any row: whole
    groups from their (min, max), open groups edge by edge; NaN edges and
    elements, duplicates, +-inf and rows out of order included."""
    rng = np.random.default_rng(11)
    f, u = 4, 70
    edges = np.sort(rng.normal(size=(f, u)), axis=1).astype(np.float32)
    if case == "nan_edges":
        edges[0, 9] = np.nan
        edges[1, 64:] = np.nan
    elif case == "dup_edges":
        edges[:, 8:24] = edges[:, 8:9]
    elif case == "inf_edges":
        edges[:, :11] = -np.inf
        edges[:, 60:] = np.inf
    elif case == "out_of_order":
        edges[2] = rng.permuted(edges[2])
    elif case == "no_edges":
        edges = np.zeros((f, 0), np.float32)
    x = (rng.normal(size=(600, f)) * 1.5).astype(np.float32)
    if edges.shape[1]:
        x[:200] = edges[np.arange(f)[None],
                        rng.integers(0, edges.shape[1], (200, f))]
        x[200:210] = edges[:, 7][None]
        x[210:220] = edges[:, 8][None]
    x[220:223, 0] = [np.nan, np.inf, -np.inf]
    want = tref.bucketize_ref(torch.from_numpy(x),
                              torch.from_numpy(edges)).numpy()
    assert_bit_equal(want, _group_count(x, edges))


# -- B3's plan on the card, modelled in numpy ------------------------------------

def _classical_model(x, edges, flat, m, tile_n=128):
    """B3 (csrc/classical_lookup.cu classical_lookup_kernel) in numpy, in the
    kernel's own f32 order: the grouped range match, the value table's M
    live columns staged packed (M words a row) with each (row, feature)'s
    offset into them, a row's features split over ``lanes`` threads
    (feature f to lane f % lanes, each lane adding its features in order),
    and the lanes met by xor shuffles, column c read from lane c % lanes."""
    from test_torch_ensemble_lookup import _grouped_count, _merge_lanes
    n, f = x.shape
    fb = flat.shape[0]
    b_pad = fb // f
    lanes = tck.launch_plan(n, f, edges.shape[1], b_pad, m, "all",
                            tile_n)["lanes"]
    staged = np.ascontiguousarray(flat[:, :m]).reshape(-1)
    off = (np.arange(f)[None] * b_pad + _grouped_count(x, edges)) * m
    acc = np.zeros((n, lanes, m), np.float32)
    for j in range(f):
        acc[:, j % lanes] += staged[off[:, j, None] + np.arange(m)[None]]
    return _merge_lanes(acc, m)


@pytest.mark.parametrize("m", [1, 2, 10])
@pytest.mark.parametrize("f", [1, 5, 8, 12])
def test_classical_kernel_plan_equals_plain_and_reference(f, m):
    """The card's plan for B3 gives the plain version's bits and the
    reference's interpret-mode kernel's, on ragged +inf-padded edges with
    rows on the edges, NaN and +-inf: the lanes a row takes (F=1 one lane,
    F=12 more features than lanes at 128 rows a block), the grouped range
    match, the packed live columns (M of Mp=8 or 16) and the shuffles."""
    rng = np.random.default_rng(10 * f + m)
    n, u = 256, 63
    edges = _edges(rng, f, u)
    x = rng.normal(0, 12, (n, f)).astype(np.float32)
    on = rng.random((n, f)) < 0.3
    pick = edges[np.arange(f)[None], rng.integers(0, u, (n, f))]
    x[on & np.isfinite(pick)] = pick[on & np.isfinite(pick)]
    x[0, 0], x[1, 0], x[2, f - 1] = np.nan, np.inf, -np.inf
    q = rng.integers(-32767, 32768, (f, u + 1, m)).astype(np.float32)
    flat = tart.flatten_vtable(torch.from_numpy(q))
    plain = tck.classical_lookup_fused_ref(torch.from_numpy(x),
                                           torch.from_numpy(edges), flat, m)
    jflat = jart.flatten_vtable(jnp.asarray(q), 8)
    jout = np.asarray(jck.classical_lookup_fused(
        jnp.asarray(x), jnp.asarray(edges), jflat, interpret=True,
        tile_n=128))[:, :m]
    model = _classical_model(x, edges, flat.numpy(), m)
    assert_bit_equal(jout, plain)
    assert_bit_equal(plain, model)
    plan = tck.launch_plan(n, f, u, flat.shape[0] // f, m, "all", 128)
    assert plan["lanes"] == min(32, 1 << (f - 1).bit_length(), 4)
    assert plan["threads"] <= 512 and plan["blocks"] == 2
