"""The CUDA kernel against its plain version, on the card. Every test here
needs a CUDA device and skips without one (decided inside the fixture).
This file imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.artifact import (build_dtable_flat, flatten_ftable,  # noqa: E402
                                       pad_dtable)
from repro_torch.kernels import ensemble_lookup as ek  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tables(rng, f, u, t, s, c, vote, dev, past=False):
    """Flat tables for the fused lookup. Codes in [0, radix) with strides
    radix^j: radix 2 keeps every key below S; past=True takes radix 3, so
    keys run to 3^f - 1, past S and Sp."""
    edges = np.sort(rng.normal(size=(f, u)), axis=1).astype(np.float32)
    edges[:, u - u // 4:] = np.inf                    # +inf pads never match
    radix = 3 if past else 2
    ftable = rng.integers(0, radix, (f, u + 1, t)).astype(np.int32)
    strides = np.array([[radix ** (f - 1 - j) for j in range(f)]] * t,
                       np.int32)
    assert past or radix ** f <= s
    dtable = (rng.integers(0, c, (t, s)) if vote
              else rng.integers(-2000, 2000, (t, s))).astype(np.int32)
    d = torch.from_numpy(dtable).to(dev)
    return (torch.from_numpy(edges).to(dev),
            flatten_ftable(torch.from_numpy(ftable), torch.from_numpy(strides)).to(dev),
            build_dtable_flat(d, c if vote else 1, vote),
            pad_dtable(d))


def _fits(tabs, select, staged, tile_n=128):
    f = tabs[0].shape[0]
    cout, t, s_pad = tabs[2].shape
    return ek.smem_bytes(f, tabs[0].shape[1], tabs[1].shape[0] // f,
                         tabs[1].shape[1], t, s_pad, cout, select, staged,
                         tile_n) <= ek.SMEM_BUDGET_BYTES


def _check_fused(x, tabs, select, staged, tile_n=None):
    before = ek.LAUNCHES[select]
    out = ek.ensemble_lookup_fused(x, *tabs, select=select, staged=staged,
                                   tile_n=tile_n)
    torch.cuda.synchronize()
    assert ek.LAUNCHES[select] == before + 1
    assert torch.equal(out, ek.ensemble_lookup_fused_ref(x, *tabs,
                                                         select=select))


@pytest.mark.parametrize("staged", ["all", "none", "keys"])
@pytest.mark.parametrize("select", ["matmul", "compare"])
@pytest.mark.parametrize("f,u,t,s,c,vote", [
    (5, 34, 10, 81, 2, True), (3, 9, 7, 16, 4, True), (5, 62, 60, 600, 1, False),
    (8, 20, 33, 300, 32, True), (5, 40, 40, 300, 3, True),
    (10, 12, 9, 1100, 3, True)])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 2048, 2049, 16000])
def test_kernel_equals_plain(cuda, n, f, u, t, s, c, vote, select, staged):
    """Both selects at every staging mode (every table, the edges and
    feature table only, none), Co 1 to 32, F up to 10 (past the 8 whose
    offsets a thread keeps in registers), rows on the edges and at NaN /
    +-inf."""
    rng = np.random.default_rng(n + f + t)
    tabs = _tables(rng, f, u, t, s, c, vote, cuda)
    if not _fits(tabs, select, staged):
        pytest.skip("tables do not fit one block's shared memory")
    x = torch.from_numpy(_lookup_rows(rng, tabs[0].cpu().numpy(), n)).to(cuda)
    _check_fused(x, tabs, select, staged)


@pytest.mark.parametrize("staged", ["all", "none", "keys"])
@pytest.mark.parametrize("select", ["matmul", "compare"])
@pytest.mark.parametrize("f,u,t,s,c,vote", [
    (4, 10, 7, 60, 3, True), (4, 10, 7, 60, 1, False),
    (5, 34, 70, 40, 3, True), (5, 34, 70, 40, 32, True)])
@pytest.mark.parametrize("n", [1, 129, 2049])
def test_kernel_keys_past_sp_equals_plain(cuda, n, f, u, t, s, c, vote,
                                          select, staged):
    """Keys at and past Sp (codes in [0, 3), strides 3^j): the matmul
    select adds nothing for such a tree, the compare select reads leaf 0,
    in every staging mode, as the plain version does."""
    rng = np.random.default_rng(n + t + c)
    tabs = _tables(rng, f, u, t, s, c, vote, cuda, past=True)
    if not _fits(tabs, select, staged):
        pytest.skip("tables do not fit one block's shared memory")
    x = torch.from_numpy(_lookup_rows(rng, tabs[0].cpu().numpy(), n)).to(cuda)
    if n > 1:                                 # the case is real
        keys = ek.decision_keys(x, tabs[0], tabs[1], t)
        assert bool((keys >= tabs[2].shape[2]).any())
        assert bool((keys < s).any())
    _check_fused(x, tabs, select, staged)


def _lookup_rows(rng, edges, n):
    """Rows for the tree lookup: normal values, a quarter of them exactly
    on an edge, and NaN, +inf and -inf in the first rows."""
    f = edges.shape[0]
    x = rng.normal(size=(n, f)).astype(np.float32)
    finite = np.isfinite(edges).sum(axis=1)
    col = (rng.random((n, f)) * finite[None, :]).astype(np.int64)
    on = rng.random((n, f)) < 0.25
    x[on] = edges[np.arange(f)[None, :], col][on]
    for i, v in enumerate((np.nan, np.inf, -np.inf)):
        if i < n:
            x[i, i % f] = v
    return x


@pytest.mark.parametrize("staged", ["all", "none"])
@pytest.mark.parametrize("tile_n", [1, 16, 32, 256, 512, 1000])
def test_matmul_kernel_tiles(cuda, tile_n, staged):
    """The matmul kernel at block sizes other than the default: one lane a
    row (512 rows and more, rows looped in rounds), many lanes a row (one
    and 16 rows), a ragged last block."""
    rng = np.random.default_rng(tile_n)
    tabs = _tables(rng, 5, 39, 10, 130, 2, True, cuda)
    x = torch.from_numpy(_lookup_rows(rng, tabs[0].cpu().numpy(), 3001)).to(cuda)
    before = ek.LAUNCHES["matmul"]
    out = ek.ensemble_lookup_fused(x, *tabs, select="matmul", staged=staged,
                                   tile_n=tile_n)
    torch.cuda.synchronize()
    assert ek.LAUNCHES["matmul"] == before + 1
    assert torch.equal(out, ek.ensemble_lookup_fused_ref(x, *tabs,
                                                         select="matmul"))


@pytest.mark.parametrize("staged", ["all", "none", "keys"])
@pytest.mark.parametrize("tile_n", [1, 16, 32, 256, 512, 1000])
def test_compare_kernel_tiles(cuda, tile_n, staged):
    """The compare kernel at block sizes other than the default, as the
    matmul kernel's: one lane a row (512 rows and more, rows looped in
    rounds), many lanes a row, a ragged last block; votes and sums."""
    rng = np.random.default_rng(tile_n + 1)
    for c, vote in ((2, True), (1, False)):
        tabs = _tables(rng, 5, 39, 10, 130, c, vote, cuda)
        x = torch.from_numpy(_lookup_rows(rng, tabs[0].cpu().numpy(),
                                          3001)).to(cuda)
        _check_fused(x, tabs, "compare", staged, tile_n)


def _never_plain(monkeypatch, name):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(ek, name, refuse)


def test_compare_cuda_never_takes_plain(cuda, monkeypatch):
    """A CUDA tensor launches B2 or raises: the plain version is never
    called for it, and bad operands raise instead of falling back."""
    rng = np.random.default_rng(6)
    tabs = _tables(rng, 5, 34, 10, 81, 2, True, cuda)
    x = torch.from_numpy(_lookup_rows(rng, tabs[0].cpu().numpy(), 2048)).to(cuda)
    want = ek.ensemble_lookup_fused_ref(x, *tabs, select="compare")
    _never_plain(monkeypatch, "ensemble_lookup_fused_ref")
    before = ek.LAUNCHES["compare"]
    got = ek.ensemble_lookup_fused(x, *tabs, select="compare")
    torch.cuda.synchronize()
    assert ek.LAUNCHES["compare"] == before + 1
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        ek.ensemble_lookup_fused(x.double(), *tabs, select="compare")
    with pytest.raises(ValueError):                   # a table on the CPU
        ek.ensemble_lookup_fused(x, tabs[0], tabs[1], tabs[2], tabs[3].cpu(),
                                 select="compare")
    with pytest.raises(ValueError):                   # no such staging mode
        ek.ensemble_lookup_fused(x, *tabs, select="compare", staged="half")
    assert ek.LAUNCHES["compare"] == before + 1


def test_loop_cuda_never_takes_plain(cuda, monkeypatch):
    """A CUDA tensor launches B7 or raises: the plain version is never
    called for it, and bad operands raise instead of falling back."""
    rng = np.random.default_rng(7)
    edges, ftable, strides, dtable = _loop_tables(rng, 5, 39, 10, 136, 2,
                                                  True, cuda)
    x = torch.from_numpy(_hard_rows(rng, edges.cpu().numpy(), 2048)).to(cuda)
    kw = dict(n_classes=2, vote=True)
    want = ek.ensemble_lookup_loop_ref(x, edges, ftable, strides, dtable, **kw)
    _never_plain(monkeypatch, "ensemble_lookup_loop_ref")
    before = ek.LAUNCHES["loop"]
    got = ek.ensemble_lookup_loop(x, edges, ftable, strides, dtable, **kw)
    torch.cuda.synchronize()
    assert ek.LAUNCHES["loop"] == before + 1
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        ek.ensemble_lookup_loop(x.double(), edges, ftable, strides, dtable,
                                **kw)
    with pytest.raises(ValueError):                   # a table on the CPU
        ek.ensemble_lookup_loop(x, edges, ftable, strides, dtable.cpu(), **kw)
    assert ek.LAUNCHES["loop"] == before + 1


def test_matmul_cuda_never_takes_plain(cuda, monkeypatch):
    """A CUDA tensor launches B1 or raises: the plain version is never
    called for it, and bad operands raise instead of falling back."""
    rng = np.random.default_rng(5)
    tabs = _tables(rng, 5, 34, 10, 81, 2, True, cuda)
    x = torch.from_numpy(_lookup_rows(rng, tabs[0].cpu().numpy(), 2048)).to(cuda)
    want = ek.ensemble_lookup_fused_ref(x, *tabs, select="matmul")

    def refuse(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(ek, "ensemble_lookup_fused_ref", refuse)
    before = ek.LAUNCHES["matmul"]
    got = ek.ensemble_lookup_fused(x, *tabs, select="matmul")
    torch.cuda.synchronize()
    assert ek.LAUNCHES["matmul"] == before + 1
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        ek.ensemble_lookup_fused(x.double(), *tabs, select="matmul")
    with pytest.raises(ValueError):                   # a table on the CPU
        ek.ensemble_lookup_fused(x, tabs[0], tabs[1], tabs[2].cpu(), tabs[3],
                                 select="matmul")
    with pytest.raises(ValueError):                   # not contiguous
        ek.ensemble_lookup_fused(x.t().contiguous().t(), *tabs,
                                 select="matmul")
    assert ek.LAUNCHES["matmul"] == before + 1


def test_kernel_rejects_bad_operands(cuda):
    rng = np.random.default_rng(0)
    tabs = _tables(rng, 5, 34, 10, 81, 2, True, cuda)
    x = torch.zeros((4, 5), device=cuda)
    with pytest.raises(TypeError):
        ek.ensemble_lookup_fused(x.double(), *tabs)
    with pytest.raises(ValueError):
        ek.ensemble_lookup_fused(torch.zeros((8, 5), device=cuda)[::2], *tabs)
    with pytest.raises(ValueError):
        ek.ensemble_lookup_fused(x, tabs[0].cpu(), *tabs[1:])
    assert ek.ensemble_lookup_fused(x[:0], *tabs).shape == (0, 2)


def test_fused_classify_on_card_equals_cpu(cuda):
    from repro_torch.core.artifact import TableArtifact, finalize_artifact
    from repro_torch.core.quantize import quantize_fixed
    from repro_torch.kernels.ops import fused_classify
    rng = np.random.default_rng(3)
    t, s = 10, 81
    art = finalize_artifact(TableArtifact(
        edges=torch.from_numpy(np.sort(rng.normal(size=(4, 6)), axis=1)
                               .astype(np.float32)),
        agg="vote", n_classes=2,
        ftable=torch.from_numpy(rng.integers(0, 3, (4, 7, t)).astype(np.int32)),
        strides=torch.tensor([[27, 9, 3, 1]] * t, dtype=torch.int32),
        dtable_class=torch.from_numpy(rng.integers(0, 2, (t, s)).astype(np.int32)),
        dtable_value=quantize_fixed(np.zeros((t, s), np.float32), 16)))
    x = rng.normal(size=(300, 4)).astype(np.float32)
    p_gpu, c_gpu = fused_classify(art, x)                 # device=None: cuda
    p_cpu, c_cpu = fused_classify(art, x, device="cpu")
    assert p_gpu.is_cuda
    assert torch.equal(p_gpu.cpu(), p_cpu) and torch.equal(c_gpu.cpu(), c_cpu)


# -- B4: the standalone range match --------------------------------------------

def _ragged_edges(rng, f, u):
    edges = np.sort(rng.normal(size=(f, u)), axis=1).astype(np.float32)
    edges[:, u - u // 4:] = np.inf                    # +inf pads never match
    return edges


def _hard_rows(rng, edges, n):
    """Rows drawn around the edges, a quarter of them exactly on an edge,
    and a few at +-inf and NaN."""
    f, u = edges.shape
    x = (rng.normal(size=(n, f)) * 1.5).astype(np.float32)
    on = rng.random((n, f)) < 0.25
    pick = edges[np.arange(f)[None, :], rng.integers(0, u - u // 4, (n, f))]
    x[on] = pick[on]
    specials = np.array([np.inf, -np.inf, np.nan], np.float32)
    x[:min(n, 3), 0] = specials[:min(n, 3)]
    return x


def _unsorted_edges(rng, f, u):
    """Edge rows in no order, each with its own number of +inf pads, at
    their own places: the count semantics, not a search's."""
    edges = rng.normal(size=(f, u)).astype(np.float32)
    for i in range(f):
        edges[i, u - (i + 1) * u // (2 * f):] = np.inf
    return rng.permuted(edges, axis=1)


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("f,u", [(5, 63), (8, 255), (16, 128), (1, 1)])
@pytest.mark.parametrize("n", [1, 300, 2048, 16000])
def test_bucketize_kernel_equals_plain(cuda, n, f, u, order):
    from repro_torch.kernels import bucketize as bk
    rng = np.random.default_rng(n + f + u)
    edges = _ragged_edges(rng, f, u) if u > 1 else np.zeros((f, u), np.float32)
    if order == "unsorted":
        edges = _unsorted_edges(rng, f, u)
    x = torch.from_numpy(_hard_rows(rng, edges, n)).to(cuda)
    e = torch.from_numpy(edges).to(cuda)
    before = bk.LAUNCHES["bucketize"]
    out = bk.bucketize(x, e)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["bucketize"] == before + 1
    assert out.dtype == torch.int32
    assert torch.equal(out, bk.bucketize_ref(x, e))


def _group_case(rng, case):
    """Edge rows that stress the kernel's (min, max) summaries of groups
    of 8 edges, and rows on their bounds."""
    f, u = 4, 70
    edges = np.sort(rng.normal(size=(f, u)), axis=1).astype(np.float32)
    if case == "nan_edges":
        edges[0, 9] = np.nan                          # inside group 1
        edges[1, 64:] = np.nan                        # the last group
    elif case == "dup_edges":
        edges[:, 8:24] = edges[:, 8:9]                # two groups of one value
    elif case == "inf_edges":
        edges[:, :11] = -np.inf
        edges[:, 60:] = np.inf
    elif case == "out_of_order":
        edges[2] = rng.permuted(edges[2])
    elif case == "long_row":                          # past the staging budget
        edges = np.sort(rng.normal(size=(2, 3000)), axis=1).astype(np.float32)
    elif case == "no_edges":
        edges = np.zeros((3, 0), np.float32)
    f, u = edges.shape
    x = _hard_rows(rng, edges, 4096) if u else rng.normal(
        size=(4096, f)).astype(np.float32)
    if u >= 16:                                       # on group bounds
        x[100:110] = edges[:, 7][None]
        x[110:120] = edges[:, 8][None]
        x[120:130] = edges[:, 15][None]
    return x, edges


@pytest.mark.parametrize("case", ["nan_edges", "dup_edges", "inf_edges",
                                  "out_of_order", "long_row", "no_edges"])
def test_bucketize_group_summaries(cuda, case):
    from repro_torch.kernels import bucketize as bk
    x, edges = _group_case(np.random.default_rng(7), case)
    xt = torch.from_numpy(x).to(cuda)
    e = torch.from_numpy(edges).to(cuda)
    before = bk.LAUNCHES["bucketize"]
    out = bk.bucketize(xt, e)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["bucketize"] == before + 1
    assert torch.equal(out, bk.bucketize_ref(xt, e))


def test_bucketize_cuda_never_takes_plain(cuda, monkeypatch):
    """A CUDA tensor launches the kernel or raises: the plain version is
    never called for it, and bad operands raise instead of falling back."""
    from repro_torch.kernels import bucketize as bk
    from repro_torch.kernels import ops
    rng = np.random.default_rng(4)
    edges = _unsorted_edges(rng, 5, 63)
    x = torch.from_numpy(_hard_rows(rng, edges, 2048)).to(cuda)
    e = torch.from_numpy(edges).to(cuda)
    want = bk.bucketize_ref(x, e)

    def refuse(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(bk, "bucketize_ref", refuse)
    before = bk.LAUNCHES["bucketize"]
    got = ops.bucketize(x, e)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["bucketize"] == before + 1
    assert torch.equal(got, want)
    # the wrapper itself (ops.bucketize casts and moves its inputs first)
    with pytest.raises(TypeError):
        bk.bucketize(x.double(), e)
    with pytest.raises(ValueError):                   # edges on the CPU
        bk.bucketize(x, e.cpu())
    with pytest.raises(ValueError):                   # not contiguous
        bk.bucketize(x.t().contiguous().t(), e)
    assert bk.LAUNCHES["bucketize"] == before + 1


# -- B3: the classical lookup ---------------------------------------------------

@pytest.mark.parametrize("staged", ["all", "edges", "none"])
@pytest.mark.parametrize("f,u,m", [(5, 63, 1), (5, 63, 2), (8, 127, 10),
                                   (3, 20, 17), (12, 30, 2), (1, 7, 8)])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 2048, 2049])
def test_classical_kernel_equals_plain(cuda, n, f, u, m, staged):
    """B3 in every staging mode: M of 1, 2 (a quarter of Mp=8 staged), 10
    and 17 (past one chunk of 16 columns), 8 (the whole table), F from 1 (one
    lane a row) to 12 (more features than lanes), rows on the edges and at
    NaN / +-inf, N around the 128-row block."""
    from repro_torch.core.artifact import flatten_vtable
    from repro_torch.kernels import classical_lookup as ck
    rng = np.random.default_rng(n + f + u + m)
    edges = _ragged_edges(rng, f, u)
    q = rng.integers(-32767, 32768, (f, u + 1, m)).astype(np.int32)
    flat = flatten_vtable(torch.from_numpy(q)).to(cuda)
    e = torch.from_numpy(edges).to(cuda)
    x = torch.from_numpy(_hard_rows(rng, edges, n)).to(cuda)
    before = ck.LAUNCHES["classical"]
    out = ck.classical_lookup_fused(x, e, flat, m, staged=staged)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["classical"] == before + 1
    assert out.shape == (n, m)
    assert torch.equal(out, ck.classical_lookup_fused_ref(x, e, flat, m))


@pytest.mark.parametrize("staged", ["all", "none"])
@pytest.mark.parametrize("tile_n", [1, 16, 64, 512, 1000])
def test_classical_kernel_tiles(cuda, tile_n, staged):
    """B3 at other rows a block (the autotune's tile_n): fewer lanes a row
    when the rows fill the block's threads, a block looping over its rows
    when they outnumber its threads."""
    from repro_torch.core.artifact import flatten_vtable
    from repro_torch.kernels import classical_lookup as ck
    rng = np.random.default_rng(tile_n)
    edges = _ragged_edges(rng, 5, 63)
    flat = flatten_vtable(torch.from_numpy(
        rng.integers(-32767, 32768, (5, 64, 2)).astype(np.int32))).to(cuda)
    e = torch.from_numpy(edges).to(cuda)
    x = torch.from_numpy(_hard_rows(rng, edges, 2049)).to(cuda)
    out = ck.classical_lookup_fused(x, e, flat, 2, staged=staged,
                                    tile_n=tile_n)
    assert torch.equal(out, ck.classical_lookup_fused_ref(x, e, flat, 2))


def test_b3_b4_reject_bad_operands(cuda):
    from repro_torch.kernels import bucketize as bk
    from repro_torch.kernels import classical_lookup as ck
    x = torch.zeros((4, 3), device=cuda)
    e = torch.zeros((3, 7), device=cuda)
    flat = torch.zeros((3 * 8, 8), device=cuda)
    with pytest.raises(TypeError):
        bk.bucketize(x.double(), e)
    with pytest.raises(ValueError):
        bk.bucketize(x, e[:2])
    with pytest.raises(TypeError):
        ck.classical_lookup_fused(x, e, flat.double(), 2)
    with pytest.raises(ValueError):
        ck.classical_lookup_fused(x, e, flat, 9)          # m > Mp
    with pytest.raises(ValueError):
        ck.classical_lookup_fused(x, e.cpu(), flat, 2)
    with pytest.raises(ValueError):
        ck.classical_lookup_fused(x, e, flat, 2, staged="keys")
    with pytest.raises(ValueError):                   # x not contiguous
        ck.classical_lookup_fused(x.t().contiguous().t(), e, flat, 2)
    assert ck.classical_lookup_fused(x[:0], e, flat, 2).shape == (0, 2)
    assert bk.bucketize(x[:0], e).shape == (0, 3)


def _classical_artifact(rng, agg, f=5, u=20, m=2):
    from repro_torch.core.artifact import TableArtifact, finalize_artifact
    from repro_torch.core.quantize import quantize_fixed
    if agg == "svm_ovo":
        pairs = torch.tensor([[0, 1]], dtype=torch.int32)
        consts, n_classes, m = torch.tensor([0.3]), 2, 1
    else:
        pairs, consts, n_classes = None, torch.tensor([-0.7, -0.2] if
                                                      agg == "nb_log" else
                                                      [0.0, 0.0]), 2
    v = rng.normal(size=(f, u + 1, m)).astype(np.float32)
    if agg == "kmeans":
        v = v * v
    return finalize_artifact(TableArtifact(
        edges=torch.from_numpy(np.sort(rng.normal(size=(f, u)), axis=1)
                               .astype(np.float32)),
        agg=agg, n_classes=n_classes, vtable=quantize_fixed(v, 16),
        consts=consts.to(torch.float32), pairs=pairs))


@pytest.mark.parametrize("agg", ["svm_ovo", "nb_log", "kmeans"])
def test_classical_classify_on_card_equals_cpu(cuda, agg):
    from repro_torch.core.inference import table_predict
    from repro_torch.kernels import classical_lookup as ck
    from repro_torch.kernels.ops import fused_classify
    from repro_torch.serving.hybrid_serving import HybridServer
    from test_torch_parity import assert_conf_parity
    rng = np.random.default_rng(7)
    art = _classical_artifact(rng, agg)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    before = ck.LAUNCHES["classical"]
    p_gpu, c_gpu = fused_classify(art, x)                 # device=None: cuda
    assert ck.LAUNCHES["classical"] == before + 1
    p_cpu, c_cpu = table_predict(art, x)
    assert torch.equal(p_gpu.cpu(), p_cpu)
    assert_conf_parity(agg, c_cpu, c_gpu)
    server = HybridServer(art, lambda rows: torch.zeros(
        rows.shape[0], dtype=torch.int64, device=rows.device), capacity=64)
    plain = HybridServer(art, server.backend_fn, capacity=64,
                         use_kernel=False, device="cuda")
    xd = torch.from_numpy(x).to(cuda)
    server.classify(xd)                 # probes the step under sync errors
    assert server._fused_ok is True     # so the eager step did not sync
    server.classify(xd)                 # captures the step for this shape
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pred, _ = server.classify(xd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(pred, plain.classify(xd)[0])


# -- B5: the streaming register scatter / readout ---------------------------------

def _stream_case(rng, n, w, dev, *, hot=False, base=0.0, outside=False):
    """A register file with the +-inf identities on untouched columns and
    integer counts from ``base``, and a window with negative timestamps,
    invalid lanes and (optionally) every lane on bucket 0 or a few bucket
    ids outside [0, N)."""
    regs = np.zeros((8, n), np.float32)
    regs[2], regs[3] = np.inf, -np.inf
    occ = rng.random(n) < 0.4
    k = int(occ.sum())
    cnt = rng.integers(1, 60, k).astype(np.float32)
    for r in (0, 1, 4, 5, 6, 7):
        regs[r, occ] = base + cnt * (700 if r in (1, 6, 7) else 1)
    regs[2, occ] = rng.uniform(-40, 0, k)
    regs[3, occ] = regs[2, occ] + rng.uniform(0, 5, k)
    bucket = (np.zeros(w, np.int32) if hot
              else rng.integers(0, n, w).astype(np.int32))
    if outside and w >= 4:
        bucket[:4] = [-1, -n - 5, n, n + 9]
    cols = (bucket, rng.uniform(-30, 30, w).astype(np.float32),
            rng.integers(40, 1500, w).astype(np.float32),
            rng.integers(0, 2, w).astype(np.float32), rng.random(w) > 0.2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(regs), tuple(t(c) for c in cols)


@pytest.mark.parametrize("limit", [None, 1000.0, float(1 << 24)])
@pytest.mark.parametrize("n,w,kind", [
    (600, 96, "random"), (8192, 1024, "random"), (8192, 1, "random"),
    (257, 4096, "hot"), (8209, 1024, "random"), (8192, 1024, "invalid"),
    (8192, 1024, "neg_zero"), (8192, 0, "random"), (300, 5000, "random"),
    (1 << 20, 4096, "random")])
def test_stream_update_kernel_equals_plain(cuda, n, w, kind, limit):
    """B5 against its plain version: N not a multiple of the tile (8209,
    600, 257, 300), every lane on one bucket (its sums cross 2^24 under the
    clamp), a window with no valid lane, -0.0 count registers on the columns
    the window does not name, an empty window, a window longer than N and
    longer than a block's list."""
    from repro_torch.kernels import stream_update as su
    rng = np.random.default_rng(n + w)
    base = float(1 << 24) - 60000.0 if limit == float(1 << 24) else 0.0
    regs, cols = _stream_case(rng, n, w, cuda, hot=kind == "hot", base=base,
                              outside=kind != "hot")
    if kind == "hot":                   # bucket 0 holds a flow from `base`
        regs[[0, 1, 4, 5, 6, 7], 0] = base + 1.0
        regs[2, 0], regs[3, 0] = -3.0, -1.0
    if kind == "invalid":
        cols = cols[:4] + (torch.zeros_like(cols[4]),)
    elif kind == "neg_zero":
        untouched = torch.ones(n, dtype=torch.bool, device=cuda)
        b = cols[0].long()
        untouched[b[(b >= 0) & (b < n)]] = False
        regs[[0, 1, 4, 5, 6, 7]] = torch.where(untouched, -0.0,
                                               regs[[0, 1, 4, 5, 6, 7]])
    want_regs, want_rows = su.stream_update_ref(regs, *cols, limit=limit)
    before = su.LAUNCHES["stream_update"]
    got_regs, got_rows = su.stream_update(regs, *cols, limit=limit)
    torch.cuda.synchronize()
    assert su.LAUNCHES["stream_update"] == before + 1
    assert got_regs.data_ptr() == regs.data_ptr()       # updated in place
    assert torch.equal(got_regs, want_regs)
    assert torch.equal(got_rows, want_rows)
    if kind == "hot" and limit == float(1 << 24):     # crossed mid-window
        assert (got_regs[[1, 6, 7], 0] == limit).any()


def test_stream_update_cuda_never_takes_plain(cuda, monkeypatch):
    """A CUDA tensor launches B5 (one launch, in place) or raises: the plain
    version is never called for it, and bad operands raise instead of
    falling back."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import stream_update as su
    rng = np.random.default_rng(6)
    regs, cols = _stream_case(rng, 8192, 1024, cuda, outside=True)
    want = su.stream_update_ref(regs, *cols, limit=float(1 << 24))

    def refuse(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(su, "stream_update_ref", refuse)
    before = su.LAUNCHES["stream_update"]
    got = ops.stream_update(regs, *cols, limit=float(1 << 24))
    torch.cuda.synchronize()
    assert su.LAUNCHES["stream_update"] == before + 1
    assert got[0].data_ptr() == regs.data_ptr()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(TypeError):
        ops.stream_update(regs, cols[0].long(), *cols[1:])
    with pytest.raises(ValueError):                   # ts on the CPU
        ops.stream_update(regs, cols[0], cols[1].cpu(), *cols[2:])
    assert su.LAUNCHES["stream_update"] == before + 1


def test_stream_update_kernel_rejects_bad_operands(cuda):
    from repro_torch.kernels import stream_update as su
    rng = np.random.default_rng(0)
    regs, cols = _stream_case(rng, 64, 16, cuda)
    with pytest.raises(TypeError):
        su.stream_update(regs.double(), *cols)
    with pytest.raises(TypeError):
        su.stream_update(regs, cols[0].long(), *cols[1:])
    with pytest.raises(TypeError):
        su.stream_update(regs, *cols[:4], cols[4].to(torch.int32))
    with pytest.raises(ValueError):
        su.stream_update(regs[:7], *cols)
    with pytest.raises(ValueError):
        su.stream_update(regs, cols[0][:8], *cols[1:])
    with pytest.raises(ValueError):
        su.stream_update(torch.zeros((8, 128), device=cuda)[:, ::2], *cols)
    with pytest.raises(ValueError):
        su.stream_update(regs, cols[0].cpu(), *cols[1:])


# -- B6: the eviction fill ---------------------------------------------------------

@pytest.mark.parametrize("mask_kind", ["random", "all", "none", "offset"])
@pytest.mark.parametrize("n", [1, 600, 8192, 8209, 1 << 20])
def test_evict_fill_kernel_equals_plain(cuda, n, mask_kind):
    """The mask-taking entry: 16-byte rows where N % 4 == 0, 4-byte
    accesses at N=8209 and on a register file that starts one float past
    an aligned address ('offset')."""
    from repro_torch.kernels import evict as ev
    g = torch.Generator(device=cuda)
    g.manual_seed(n)
    regs = torch.randn((8, n), generator=g, device=cuda)
    if mask_kind == "offset":
        regs = torch.cat([regs.new_zeros(1), regs.reshape(-1)])[1:].view(8, n)
        mask_kind = "random"
    mask = {"random": torch.rand(n, generator=g, device=cuda) < 0.3,
            "all": torch.ones(n, dtype=torch.bool, device=cuda),
            "none": torch.zeros(n, dtype=torch.bool, device=cuda)}[mask_kind]
    fills = torch.tensor([0.0, 0.0, float("inf"), float("-inf"), 0, 0, 0, 0],
                         device=cuda)
    before = ev.LAUNCHES["evict_fill"]
    out = ev.evict_fill(regs, mask, fills)
    torch.cuda.synchronize()
    assert ev.LAUNCHES["evict_fill"] == before + 1
    assert torch.equal(out, ev.evict_fill_ref(regs, mask, fills))


def test_evict_fill_kernel_rejects_bad_operands(cuda):
    from repro_torch.kernels import evict as ev
    regs = torch.zeros((8, 32), device=cuda)
    mask = torch.zeros(32, dtype=torch.bool, device=cuda)
    fills = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError):
        ev.evict_fill(regs, mask.to(torch.int32), fills)
    with pytest.raises(TypeError):
        ev.evict_fill(regs, mask, fills.double())
    with pytest.raises(ValueError):
        ev.evict_fill(regs, mask[:16], fills)
    with pytest.raises(ValueError):
        ev.evict_fill(regs, mask, fills.cpu())
    with pytest.raises(ValueError):
        ev.evict_fill(torch.zeros((8, 64), device=cuda)[:, ::2], mask, fills)


def _sweep_case(dev, n, w, case):
    """A register file (half the columns occupied, last seen in [-20, 15],
    one NaN t_max) and a window (timestamps in [10, 12], a fifth of the
    lanes invalid) for one timeout-sweep case."""
    g = torch.Generator(device=dev)
    g.manual_seed(n + w)
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)
    occ = (u(n) < 0.5) | (case == "all")
    regs = torch.zeros((8, n), device=dev)
    for r in (0, 1, 4, 5, 6, 7):
        regs[r] = torch.where(occ, torch.floor(u(n) * 50.0) + 1.0, 0.0)
    t0 = u(n) * 30.0 - 20.0
    regs[2] = torch.where(occ, t0, float("inf"))
    regs[3] = torch.where(occ, t0 + 5.0 * u(n), float("-inf"))
    if case != "all":
        regs[3, 0] = float("nan")
    ts = 10.0 + 2.0 * u(w)
    valid = u(w) > 0.2
    valid[0] = True
    if case == "no_valid":
        valid[:] = False
    elif case == "nan_ts":
        ts[0] = float("nan")
    elif case == "all":
        ts += 90.0
    elif case == "none":
        ts -= 60.0
    elif case == "at_cutoff":
        from repro_torch.kernels.evict import evict_cutoff
        cut = evict_cutoff(ts, valid, 5.0)
        regs[3, 1::3] = torch.where(regs[0, 1::3] > 0, cut, regs[3, 1::3])
    return regs, ts, valid


@pytest.mark.parametrize("case", ["random", "no_valid", "nan_ts",
                                  "at_cutoff", "all", "none"])
@pytest.mark.parametrize("n,w", [(1, 1), (600, 96), (8192, 1024),
                                 (8209, 1024), (8192, 4096)])
def test_timeout_sweep_kernel_equals_plain(cuda, n, w, case):
    """The timeout sweep in one launch against its plain composition on a
    copy of the same register file: updated in place (the same tensor comes
    back), the count an i32 scalar equal to the plain count; a second sweep
    of the same window evicts nothing (the launch's count starts from 0)."""
    from repro_torch.kernels import evict as ev
    from repro_torch.netsim.stream import evict_fills
    regs, ts, valid = _sweep_case(cuda, n, w, case)
    fills = evict_fills(cuda)
    want, want_n = ev.timeout_sweep_ref(regs, ts, valid, 5.0, fills)
    before = ev.LAUNCHES["evict_fill"]
    got, n_ev = ev.timeout_sweep(regs, ts, valid, 5.0, fills)
    torch.cuda.synchronize()
    assert ev.LAUNCHES["evict_fill"] == before + 1
    assert got is regs
    assert n_ev.dtype == torch.int32 and n_ev.shape == ()
    assert _same_bits(got, want) and int(n_ev) == int(want_n)
    if case in ("no_valid", "nan_ts", "none"):
        assert int(n_ev) == 0
    elif case == "all":
        assert int(n_ev) == n
    again, n_again = ev.timeout_sweep(regs, ts, valid, 5.0, fills)
    assert _same_bits(again, want) and int(n_again) == 0


def _same_bits(a, b):
    """Bit for bit (a NaN register included, which torch.equal rejects)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_timeout_sweep_replays_in_a_graph(cuda):
    """Captured in a CUDA graph, the sweep counts afresh at every replay."""
    from repro_torch.kernels import evict as ev
    from repro_torch.netsim.stream import evict_fills
    regs, ts, valid = _sweep_case(cuda, 8192, 1024, "random")
    fills = evict_fills(cuda)
    src = regs.clone()
    want, want_n = ev.timeout_sweep_ref(src, ts, valid, 5.0, fills)
    assert int(want_n) > 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ev.timeout_sweep(regs, ts, valid, 5.0, fills)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, n_ev = ev.timeout_sweep(regs, ts, valid, 5.0, fills)
    for _ in range(3):
        regs.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(regs, want) and int(n_ev) == int(want_n)


def test_timeout_sweep_rejects_bad_operands(cuda):
    from repro_torch.kernels import evict as ev
    regs = torch.zeros((8, 32), device=cuda)
    ts = torch.zeros(16, device=cuda)
    valid = torch.ones(16, dtype=torch.bool, device=cuda)
    fills = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError):
        ev.timeout_sweep(regs, ts.double(), valid, 5.0, fills)
    with pytest.raises(TypeError):
        ev.timeout_sweep(regs, ts, valid.to(torch.int32), 5.0, fills)
    with pytest.raises(ValueError):
        ev.timeout_sweep(regs, ts, valid[:8], 5.0, fills)
    with pytest.raises(ValueError):
        ev.timeout_sweep(regs, ts[:0], valid[:0], 5.0, fills)
    with pytest.raises(ValueError):
        ev.timeout_sweep(regs[:4], ts, valid, 5.0, fills[:4])
    with pytest.raises(ValueError):
        ev.timeout_sweep(regs, ts.cpu(), valid, 5.0, fills)
    with pytest.raises(ValueError):
        ev.timeout_sweep(torch.zeros((8, 64), device=cuda)[:, ::2], ts,
                         valid, 5.0, fills)


# -- the streaming server on the card ---------------------------------------------

@pytest.mark.parametrize("evict_policy", [None, "timeout", "approx_lru"])
def test_streaming_server_on_card_equals_cpu(cuda, evict_policy):
    """A small trace served by the streaming server on the card (B5, B6, B1)
    and on the CPU (their plain versions): the same predictions, counters
    and flow table; one step does not sync the host."""
    from repro_torch.core.mapping import map_tree_ensemble
    from repro_torch.kernels import evict as ev
    from repro_torch.kernels import stream_update as su
    from repro_torch.ml.trees import fit_random_forest, predict_tree_ensemble
    from repro_torch.netsim.features import flow_features
    from repro_torch.netsim.packets import synth_trace
    from repro_torch.netsim.stream import iter_windows
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace = synth_trace(n_flows=400, seed=3)
    n_buckets = 256 if evict_policy == "approx_lru" else 4096
    b, table = flow_features(trace, n_buckets=n_buckets, device="cpu")
    first = np.unique(trace.flow_id, return_index=True)[1]
    rows = table[b[first].long()]
    small = fit_random_forest(rows, trace.flow_label, n_classes=2, n_trees=4,
                              max_depth=3, seed=0, device="cpu")
    big = fit_random_forest(rows, trace.flow_label, n_classes=2, n_trees=12,
                            max_depth=5, seed=1, device="cpu")
    art = map_tree_ensemble(small, 8)
    kw = dict(n_buckets=n_buckets, window=256, threshold=0.9, capacity=32)
    if evict_policy is not None:
        kw.update(evict_age=2.0, evict_policy=evict_policy)
    big_dev = big.to(cuda)
    # the eager route, whose launches are counted step by step (the graph
    # routes are held to it in test_chunked_server_on_card_equals_cpu)
    card = StreamingHybridServer(
        art, lambda r: predict_tree_ensemble(big_dev, r), fuse=False, **kw)
    host = StreamingHybridServer(
        art, lambda r: predict_tree_ensemble(big, r), device="cpu", **kw)
    su_before, ev_before = su.LAUNCHES["stream_update"], ev.LAUNCHES["evict_fill"]
    p_card, s_card = card.serve_trace(trace)
    p_host, s_host = host.serve_trace(trace)
    n_win = s_card.n_windows
    assert su.LAUNCHES["stream_update"] - su_before == n_win
    assert ev.LAUNCHES["evict_fill"] - ev_before == (
        0 if evict_policy is None else n_win)
    assert torch.equal(p_card.cpu(), p_host)
    assert torch.equal(card.flow_table().cpu(), host.flow_table())
    d_card, d_host = s_card.as_dict(), s_host.as_dict()
    for k in d_card:
        if k not in ("conf_sum", "mean_conf"):
            assert d_card[k] == d_host[k], k
    np.testing.assert_allclose(d_card["conf_sum"], d_host["conf_sum"],
                               rtol=1e-5)
    w = next(iter(iter_windows(trace, 256, n_buckets)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card.step(w)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# -- chunked streaming and the step graphs on the card ---------------------------

@pytest.fixture(scope="module")
def stream_served():
    """A 400-flow trace, a 4x3 RF switch and a 12x5 RF backend trained on
    the CPU (the backend also on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.mapping import map_tree_ensemble
    from repro_torch.ml.trees import fit_random_forest
    from repro_torch.netsim.features import flow_features
    from repro_torch.netsim.packets import synth_trace
    trace = synth_trace(n_flows=400, seed=3)
    b, table = flow_features(trace, n_buckets=4096, device="cpu")
    first = np.unique(trace.flow_id, return_index=True)[1]
    rows = table[b[first].long()]
    small = fit_random_forest(rows, trace.flow_label, n_classes=2, n_trees=4,
                              max_depth=3, seed=0, device="cpu")
    big = fit_random_forest(rows, trace.flow_label, n_classes=2, n_trees=12,
                            max_depth=5, seed=1, device="cpu")
    return trace, map_tree_ensemble(small, 8), big, big.to("cuda")


def _stream_kw(evict):
    kw = dict(n_buckets=4096, window=256, threshold=0.9, capacity=32)
    if evict:
        kw["evict_age"] = 1.0
    return kw


def _rf_backend(big):
    from repro_torch.ml.trees import predict_tree_ensemble
    return lambda r: predict_tree_ensemble(big, r)


def _same_stats(a, b, *, flushes=True):
    da_, db_ = a.as_dict(), b.as_dict()
    for k in da_:
        if k in ("conf_sum", "mean_conf") or (k == "flushes" and not flushes):
            continue
        assert da_[k] == db_[k], k
    np.testing.assert_allclose(da_["conf_sum"], db_["conf_sum"], rtol=1e-5)


@pytest.mark.parametrize("evict", [False, True])
@pytest.mark.parametrize("k", [1, 8])
def test_chunked_server_on_card_equals_cpu(stream_served, k, evict):
    """Chunked serving on the card, eager (launches counted: K B5, one B1
    and K sweeps a chunk) and through its CUDA graph, against the CPU's
    chunked and per-window servers: predictions, flow table, counters."""
    from repro_torch.kernels import evict as ev
    from repro_torch.kernels import stream_update as su
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, big, big_dev = stream_served
    kw = _stream_kw(evict)
    host = StreamingHybridServer(art, _rf_backend(big), chunk_windows=k,
                                 device="cpu", **kw)
    p_host, s_host = host.serve_trace(trace)
    per_window = StreamingHybridServer(art, _rf_backend(big), device="cpu",
                                       **kw)
    p_win, s_win = per_window.serve_trace(trace)
    eager = StreamingHybridServer(art, _rf_backend(big_dev), chunk_windows=k,
                                  fuse=False, **kw)
    select = ek.resolve_select("auto", eager.artifact.n_trees,
                               eager.artifact.dtable_flat.shape[2],
                               eager.artifact.dtable_flat.shape[0])
    before = (su.LAUNCHES["stream_update"], ek.LAUNCHES[select],
              ev.LAUNCHES["evict_fill"])
    p_eager, s_eager = eager.serve_trace(trace)
    n_chunks = s_eager.n_flushes
    assert n_chunks == -(-s_eager.n_windows // k)
    assert (su.LAUNCHES["stream_update"] - before[0],
            ek.LAUNCHES[select] - before[1],
            ev.LAUNCHES["evict_fill"] - before[2]) == (
        k * n_chunks, n_chunks, k * n_chunks if evict else 0)
    graph = StreamingHybridServer(art, _rf_backend(big_dev), chunk_windows=k,
                                  **kw)
    p_graph, s_graph = graph.serve_trace(trace)
    assert graph._fused_ok is True
    assert set(graph._step_graphs) == {("chunk", (k, 256))}
    for p, s, srv in ((p_eager, s_eager, eager), (p_graph, s_graph, graph)):
        assert torch.equal(p.cpu(), p_host) and torch.equal(p.cpu(), p_win)
        assert torch.equal(srv.flow_table().cpu(), host.flow_table())
        _same_stats(s, s_host)
        _same_stats(s, s_win, flushes=False)
    if evict:
        assert s_graph.n_evicted > 0


@pytest.mark.parametrize("k", [1, 8])
def test_chunk_graph_counts_evictions_in_every_replay(stream_served, k):
    """Chunk by chunk with eviction, the graph route's running counters
    (evictions included, from B6's sweep replayed K times a chunk) and
    predictions equal the eager route's after every chunk; one replayed
    step_chunk does not sync the host."""
    from repro_torch.netsim.stream import iter_chunks
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, _, big_dev = stream_served
    kw = _stream_kw(True)
    eager = StreamingHybridServer(art, _rf_backend(big_dev), chunk_windows=k,
                                  fuse=False, **kw)
    graph = StreamingHybridServer(art, _rf_backend(big_dev), chunk_windows=k,
                                  **kw)
    for c in iter_chunks(trace, 256, k, 4096):
        pe, he = eager.step_chunk(c)
        pg, hg = graph.step_chunk(c)
        assert torch.equal(pe, pg)
        assert torch.equal(he.as_tensors()[1], hg.as_tensors()[1])
        _same_stats(eager.stats, graph.stats)
    assert graph.stats.n_evicted > 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.step_chunk(c)
        eager.step_chunk(c)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_reset_under_captured_graphs(stream_served):
    """``reset`` refills the carries in place: the captured graphs stay
    valid and serve the trace again to the same answers, no re-capture."""
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, _, big_dev = stream_served
    srv = StreamingHybridServer(art, _rf_backend(big_dev), chunk_windows=8,
                                **_stream_kw(True))
    p1, s1 = srv.serve_trace(trace)
    graphs = dict(srv._step_graphs)
    ptrs = (srv.state.regs.data_ptr(), srv._stats.windows.data_ptr())
    srv.reset()
    assert srv.stats.n_windows == 0 and float(srv.state.regs[0].sum()) == 0
    p2, s2 = srv.serve_trace(trace)
    assert srv._step_graphs == graphs
    assert (srv.state.regs.data_ptr(), srv._stats.windows.data_ptr()) == ptrs
    assert torch.equal(p1, p2)
    _same_stats(s1, s2)


def test_window_graph_equals_eager_and_mixes_with_chunks(stream_served):
    """The per-window step as a CUDA graph equals the eager step; windows
    and chunks served in turns on one graph server give the per-window
    answers (both graphs share the carries)."""
    from repro_torch.netsim.stream import iter_chunks
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, _, big_dev = stream_served
    kw = _stream_kw(True)
    eager = StreamingHybridServer(art, _rf_backend(big_dev), fuse=False, **kw)
    p_ref, s_ref = eager.serve_trace(trace)
    graph = StreamingHybridServer(art, _rf_backend(big_dev), **kw)
    p_g, s_g = graph.serve_trace(trace)
    assert set(graph._step_graphs) == {("window", (256,))}
    assert torch.equal(p_ref, p_g)
    _same_stats(s_ref, s_g)
    assert torch.equal(eager.flow_table(), graph.flow_table())
    mixed = StreamingHybridServer(art, _rf_backend(big_dev), chunk_windows=2,
                                  **kw)
    preds = []
    for i, c in enumerate(iter_chunks(trace, 256, 2, 4096)):
        if i % 2:
            preds.append(mixed.step_chunk(c)[0].reshape(-1))
        else:
            preds += [mixed.step(c.window_at(j))[0] for j in range(2)
                      if bool(c.valid[j].any())]
    assert set(mixed._step_graphs) == {("window", (256,)),
                                       ("chunk", (2, 256))}
    assert torch.equal(p_ref, torch.cat(preds)[:trace.n_packets])
    _same_stats(s_ref, mixed.stats, flushes=False)
    assert torch.equal(eager.flow_table(), mixed.flow_table())


def test_syncing_backend_serves_chunks_eagerly(stream_served):
    from repro_torch.ml.trees import predict_tree_ensemble
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, _, big_dev = stream_served
    kw = _stream_kw(True)

    def np_backend(r):                         # a host round trip
        return predict_tree_ensemble(big_dev, r).cpu().numpy()

    ref = StreamingHybridServer(art, _rf_backend(big_dev), chunk_windows=8,
                                fuse=False, **kw)
    p_ref, s_ref = ref.serve_trace(trace)
    srv = StreamingHybridServer(art, np_backend, chunk_windows=8, **kw)
    p, s = srv.serve_trace(trace)
    assert srv._fused_ok is False and not srv._step_graphs
    assert torch.equal(p_ref, p)
    _same_stats(s_ref, s)


# -- cross-window deferral and the fault guard on the card ---------------------------

@pytest.mark.parametrize("evict", [False, True])
@pytest.mark.parametrize("k", [2, 8])
def test_deferred_graphs_equal_eager_and_cpu(stream_served, k, evict):
    """flush_every=k on the card through the deferred step's graph and the
    flush graph (fuse=None), and eagerly (fuse=False: B5, B1 and the sweep
    once a window), against the CPU's deferred and per-window servers:
    predictions, flow table, counters. The cycle slot advances across
    replays of one captured graph (two graphs for the whole trace)."""
    from repro_torch.kernels import evict as ev
    from repro_torch.kernels import stream_update as su
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, big, big_dev = stream_served
    kw = dict(_stream_kw(evict), flush_every=k)
    host = StreamingHybridServer(art, _rf_backend(big), device="cpu", **kw)
    p_host, s_host = host.serve_trace(trace)
    p_win, s_win = StreamingHybridServer(
        art, _rf_backend(big), device="cpu",
        **_stream_kw(evict)).serve_trace(trace)
    eager = StreamingHybridServer(art, _rf_backend(big_dev), fuse=False, **kw)
    select = ek.resolve_select("auto", eager.artifact.n_trees,
                               eager.artifact.dtable_flat.shape[2],
                               eager.artifact.dtable_flat.shape[0])
    before = (su.LAUNCHES["stream_update"], ek.LAUNCHES[select],
              ev.LAUNCHES["evict_fill"])
    p_eager, s_eager = eager.serve_trace(trace)
    n_win = s_eager.n_windows
    assert (su.LAUNCHES["stream_update"] - before[0],
            ek.LAUNCHES[select] - before[1],
            ev.LAUNCHES["evict_fill"] - before[2]) == (
        n_win, n_win, n_win if evict else 0)
    graph = StreamingHybridServer(art, _rf_backend(big_dev), **kw)
    before = su.LAUNCHES["stream_update"]
    p_graph, s_graph = graph.serve_trace(trace)
    assert su.LAUNCHES["stream_update"] - before == 2   # warm-up + capture
    assert graph._fused_ok is True
    assert set(graph._step_graphs) == {("defer", (256,)),
                                       ("flush", (k * 32, 8))}
    for p, s, srv in ((p_eager, s_eager, eager), (p_graph, s_graph, graph)):
        assert torch.equal(p.cpu(), p_host) and torch.equal(p.cpu(), p_win)
        assert torch.equal(srv.flow_table().cpu(), host.flow_table())
        _same_stats(s, s_host)
        _same_stats(s, s_win, flushes=False)
    assert s_graph.n_flushes == -(-n_win // k)
    if evict:
        assert s_graph.n_evicted > 0


def test_deferred_graph_steps_provisional_and_flush_patches(stream_served):
    """Manual stepping through the graphs: each replay writes its own cycle
    slot (the provisional predictions and the patched flush equal the
    eager route's), a partial cycle flushes by hand, one step does not
    sync the host, and reset() mid-cycle leaves the graphs valid."""
    from repro_torch.netsim.stream import iter_windows
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, _, big_dev = stream_served
    kw = dict(_stream_kw(True), flush_every=4)
    eager = StreamingHybridServer(art, _rf_backend(big_dev), fuse=False, **kw)
    graph = StreamingHybridServer(art, _rf_backend(big_dev), **kw)
    ws = list(iter_windows(trace, 256, 4096))[:7]
    for w in ws:
        pe, he = eager.step(w)
        pg, hg = graph.step(w)
        assert torch.equal(pe, pg)
        assert torch.equal(he.as_tensors()[1], hg.as_tensors()[1])
        assert graph.pending_windows == eager.pending_windows
        fe, fg = eager.consume_flush(), graph.consume_flush()
        assert (fe is None) == (fg is None)
        if fe is not None:
            assert fe[0] == fg[0] == 4 and torch.equal(fe[1], fg[1])
    ne, fe = eager.flush()
    ng, fg = graph.flush()
    assert ne == ng == 3 and torch.equal(fe, fg)
    _same_stats(eager.stats, graph.stats)
    graphs = dict(graph._step_graphs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.step(ws[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    graph.step(ws[1])
    graph.reset()                                 # mid-cycle
    assert graph.pending_windows == 0 and graph.flush() is None
    eager.reset()
    p_e, s_e = eager.serve_trace(trace)
    p_g, s_g = graph.serve_trace(trace)
    assert graph._step_graphs == graphs
    assert torch.equal(p_e, p_g)
    _same_stats(s_e, s_g)


def test_syncing_backend_flushes_two_phase(stream_served):
    """A backend that syncs the host is found at the first flush (the
    backend's first call): the deferred step stays a graph, the flush runs
    two-phase from then on, and the answers equal the eager route's."""
    from repro_torch.ml.trees import predict_tree_ensemble
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, _, big_dev = stream_served
    kw = dict(_stream_kw(True), flush_every=4)

    def np_backend(r):                         # a host round trip
        return predict_tree_ensemble(big_dev, r).cpu().numpy()

    ref = StreamingHybridServer(art, _rf_backend(big_dev), fuse=False, **kw)
    p_ref, s_ref = ref.serve_trace(trace)
    srv = StreamingHybridServer(art, np_backend, **kw)
    p, s = srv.serve_trace(trace)
    assert srv._fused_ok is False
    assert set(srv._step_graphs) == {("defer", (256,))}
    assert torch.equal(p_ref, p)
    _same_stats(s_ref, s)


@pytest.mark.parametrize("path_kw", [dict(), dict(flush_every=4),
                                     dict(chunk_windows=4)],
                         ids=["per_window", "deferred", "chunked"])
def test_guarded_server_on_card_equals_cpu(stream_served, path_kw):
    """Under a fault policy (eager on the card) and the same seeded
    FaultyBackend, the card's predictions, counters and guard telemetry
    equal the CPU's; degraded rows exist and the accounting balances."""
    from repro_torch.serving.faults import FaultPolicy, FaultyBackend
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, big, big_dev = stream_served
    policy = FaultPolicy(max_retries=1, backoff_base_s=0.0,
                         breaker_threshold=3, breaker_cooldown=2)
    kw = dict(_stream_kw(True), fault_policy=policy, **path_kw)
    fkw = dict(error_rate=0.4, seed=9, outages=range(0, 4))
    card = StreamingHybridServer(art, FaultyBackend(_rf_backend(big_dev),
                                                    **fkw), **kw)
    host = StreamingHybridServer(art, FaultyBackend(_rf_backend(big), **fkw),
                                 device="cpu", **kw)
    p_card, s_card = card.serve_trace(trace)
    p_host, s_host = host.serve_trace(trace)
    assert card._fused_ok is False and not card._step_graphs
    assert s_card.n_degraded > 0
    assert torch.equal(p_card.cpu(), p_host)
    _same_stats(s_card, s_host)
    assert card.fault_stats.as_dict() == host.fault_stats.as_dict()


def test_guard_worker_runs_on_the_callers_stream(cuda):
    """Under a timeout the backend runs on a worker thread, on the stream
    that was current where the guard was called, so its kernels follow the
    rows' producer and precede the patch without a host sync."""
    from repro_torch.serving.faults import FaultPolicy, GuardedBackend
    seen = []

    def backend(rows):
        seen.append(torch.cuda.current_stream(rows.device).cuda_stream)
        return rows.sum(dim=1)

    g = GuardedBackend(backend, FaultPolicy(timeout_s=30.0, max_retries=0,
                                            breaker_threshold=0))
    side = torch.cuda.Stream(cuda)
    rows = torch.ones((64, 8), device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        out = g(rows * 2.0)
        got = (out + 1.0).cpu()
    assert seen == [side.cuda_stream]
    assert torch.equal(got, torch.full((64,), 17.0))


def test_csv_parse_on_card_equals_cpu(cuda):
    from repro_torch.data.janestreet_like import make_janestreet_like
    from repro_torch.netsim.features import (encode_csv_payload,
                                             file_features_csv,
                                             stitch_split_payload)
    x, _ = make_janestreet_like(600, seed=0)
    payload = encode_csv_payload(x[:512], width=8)
    host = file_features_csv(payload, list(range(130)), device="cpu")
    whole = stitch_split_payload(payload[:, :700], payload[:, 700:],
                                 device=cuda)
    assert whole.device.type == "cuda"
    card = file_features_csv(whole, list(range(130)))
    assert torch.equal(card.cpu(), host)
    rng = np.random.default_rng(0)
    ints = rng.integers(1 << 24, 10 ** 8, (4096, 3)).astype(np.float64)
    big = encode_csv_payload(ints, width=8)       # integer parts past 2^24
    card = file_features_csv(torch.as_tensor(big, device=cuda), [0, 1, 2])
    assert torch.equal(card.cpu(), torch.from_numpy(ints.astype(np.float32)))


def test_finance_launcher_on_card_equals_plain(cuda):
    """``--use-case finance`` on the card at a reduced size, against a
    plain server over the same models and the same side channel."""
    from repro_torch.launch import serve
    from repro_torch.serving.hybrid_serving import HybridServer
    res = serve.main(["--use-case", "finance", "--device", "cuda",
                      "--n-samples", "4000", "--backend-trees", "8",
                      "--batch", "256", "--capacity", "64"])
    plain = HybridServer(res["artifact"],
                         serve.side_channel_backend(res["backend_model"]),
                         capacity=64, use_kernel=False, fuse=False)
    preds, _ = serve.serve_batches(plain, res["x_test"], 256,
                                   x_full=res["x_full"])
    assert torch.equal(res["pred"], torch.cat(preds))


# -- open-ended ingest on the card: pinned staging, the side stream, the ring --------

def _delay_staging(monkeypatch, cycles=2_000_000):
    """Make every staged copy wait behind a spin kernel on the side stream,
    so a step that reads a chunk without waiting on its copy, or a host
    that refills a pinned buffer still being copied, gives wrong answers."""
    from repro_torch.netsim import ingest
    stage = ingest.PinnedStaging.stage

    def slow(self, cut):
        with torch.cuda.stream(self.stream):
            torch.cuda._sleep(cycles)
        return stage(self, cut)
    monkeypatch.setattr(ingest.PinnedStaging, "stage", slow)


def test_pinned_staging_round_robin_waits_for_its_copies(cuda, monkeypatch):
    """More cuts than buffer sets through one staging, each copy delayed:
    every chunk, once awaited, holds its own cut's columns (a buffer is
    refilled only after its copy completed); the chunks were allocated on
    the side stream and are safe to read on the current one."""
    import dataclasses
    from repro_torch.netsim import ingest
    from repro_torch.netsim.packets import synth_trace
    _delay_staging(monkeypatch)
    trace = synth_trace(n_flows=200, seed=5)
    ring = ingest.PacketRingBuffer(64, 4, 2048)
    cuts = list(ingest.cut_stream(ring, ingest.replay_source(trace, 300)))
    assert len(cuts) > 6
    staging = ingest.PinnedStaging(4, 64, device=cuda, slots=2)
    staged = [staging.stage(c) for c in cuts]
    for c, (chunk, ready) in zip(cuts, staged):
        ingest.await_chunk(chunk, ready)
        want = c.to_chunk(device="cpu")
        for f in ("bucket", "ts", "length", "is_fwd", "valid"):
            assert torch.equal(getattr(chunk, f).cpu(), getattr(want, f)), f
    with pytest.raises(ValueError):
        staging.stage(dataclasses.replace(cuts[0], rows=2))


@pytest.mark.parametrize("route", ["graph", "eager"])
def test_prefetch_bit_identical_over_repeats(stream_served, monkeypatch,
                                             route):
    """20 repeats of serve_stream with prefetch on (pinned staging, copies
    on the side stream, each delayed behind a spin kernel) against
    prefetch off, the consumer slowed by a sleep on every other repeat:
    the same predictions, counters and flow table each time."""
    import time
    from repro_torch.netsim.ingest import replay_source
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, _, big_dev = stream_served
    _delay_staging(monkeypatch)
    kw = dict(_stream_kw(True), chunk_windows=4,
              fuse=None if route == "graph" else False)
    fast = _rf_backend(big_dev)
    state = {"slow": False}

    def backend(rows):
        if state["slow"] and route == "eager":
            time.sleep(0.002)
        return fast(rows)

    ref = StreamingHybridServer(art, backend, **kw)
    p_ref, s_ref = ref.serve_stream(replay_source(trace, batch=700),
                                    prefetch=False)
    srv = StreamingHybridServer(art, backend, **kw)
    for i in range(20):
        state["slow"] = bool(i % 2)
        srv.reset()
        p, s = srv.serve_stream(replay_source(trace, batch=700),
                                prefetch=True, prefetch_depth=1 + i % 3)
        assert torch.equal(p, p_ref), i
        _same_stats(s, s_ref)
        assert torch.equal(srv.flow_table(), ref.flow_table())
    if route == "graph":
        assert set(srv._step_graphs) == {("chunk", (4, 256))}


@pytest.mark.parametrize("evict", [False, True])
def test_prefetch_stages_during_the_first_capture(stream_served, monkeypatch,
                                                  evict):
    """serve_stream at its defaults (prefetch on, the chunk step's graph)
    on a live source that sleeps between one-chunk batches, gated so that
    the prefetch thread stages a cut while the serving thread is inside the
    chunk step's first capture (held open until it has): the stage reuses
    a buffer (waiting on its copy's event) and allocates a block that no
    cache holds on its side stream, as a cut of a larger geometry would
    just after the capture's empty_cache. The capture holds, and the
    predictions, counters and flow table equal prefetch off."""
    import threading
    import time
    from repro_torch.netsim import ingest
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, _, big_dev = stream_served
    kw = dict(_stream_kw(evict), chunk_windows=4)
    batch = 4 * 256
    assert trace.n_packets > 4 * batch
    capturing, staged_inside = threading.Event(), threading.Event()
    begin = torch.cuda.CUDAGraph.capture_begin
    stage = ingest.PinnedStaging.stage

    def capture_begin(self, *a, **k):
        begin(self, *a, **k)
        capturing.set()
        staged_inside.wait(timeout=10.0)   # hold the capture open

    def staged(self, cut):
        out = stage(self, cut)
        if capturing.is_set() and not staged_inside.is_set():
            with torch.cuda.stream(self.stream):
                torch.empty(64 << 20, dtype=torch.uint8, device=self.device)
            staged_inside.set()
        return out

    def live(gate):
        for i, lo in enumerate(range(0, trace.n_packets, batch)):
            if gate and i == 3:       # the fourth cut waits for the capture
                capturing.wait(timeout=10.0)
            time.sleep(0.001)
            yield ingest.slice_trace(trace, lo, min(lo + batch,
                                                    trace.n_packets))

    ref = StreamingHybridServer(art, _rf_backend(big_dev), **kw)
    p_ref, s_ref = ref.serve_stream(live(False), prefetch=False)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", capture_begin)
    monkeypatch.setattr(ingest.PinnedStaging, "stage", staged)
    srv = StreamingHybridServer(art, _rf_backend(big_dev), **kw)
    # one queue slot, three buffers: the fourth cut reuses the first's
    p, s = srv.serve_stream(live(True), prefetch_depth=1)
    assert staged_inside.is_set()
    assert set(srv._step_graphs) == {("chunk", (4, 256))}
    assert torch.equal(p, p_ref)
    _same_stats(s, s_ref)
    assert torch.equal(srv.flow_table(), ref.flow_table())


@pytest.mark.parametrize("path_kw", [dict(chunk_windows=4),
                                     dict(chunk_windows=4, evict_age=1.0),
                                     dict(), dict(flush_every=3)],
                         ids=["chunked", "chunked_evict", "per_window",
                              "deferred"])
def test_serve_stream_under_graphs_equals_cpu(stream_served, path_kw):
    """serve_stream on the card through the step graphs (fuse=None), on a
    paced source with deadline cuts under a fake clock, against the CPU
    port on the same source: predictions, counters, flow table and
    IngestStats; and serve_trace through the ring against the manual
    loop on the card."""
    from repro_torch.netsim import ingest
    from repro_torch.netsim.stream import iter_chunks, iter_windows
    from repro_torch.serving.stream_serving import StreamingHybridServer, \
        _patch
    trace, art, big, big_dev = stream_served
    kw = dict(_stream_kw(False), **path_kw)

    def clock_():
        state = {"t": 0.0}

        def clock():
            state["t"] += 3.0
            return state["t"]
        return clock

    call = dict(deadline=1.0)
    card = StreamingHybridServer(art, _rf_backend(big_dev), **kw)
    p, s = card.serve_stream(ingest.replay_source(trace, batch=500),
                             clock=clock_(), **call)
    host = StreamingHybridServer(art, _rf_backend(big), device="cpu", **kw)
    p_h, s_h = host.serve_stream(ingest.replay_source(trace, batch=500),
                                 clock=clock_(), **call)
    assert card._fused_ok is True and card._step_graphs
    assert torch.equal(p.cpu(), p_h)
    _same_stats(s, s_h)
    assert torch.equal(card.flow_table().cpu(), host.flow_table())
    assert card.ingest_stats.as_dict() == host.ingest_stats.as_dict()
    if "chunk_windows" in path_kw:
        assert card.ingest_stats.deadline_cuts > 0
    card.reset()
    p_t, s_t = card.serve_trace(trace)
    manual = StreamingHybridServer(art, _rf_backend(big_dev), **kw)
    if "chunk_windows" in path_kw:
        preds = [manual.step_chunk(c)[0].reshape(-1)
                 for c in iter_chunks(trace, 256, 4, 4096)]
    else:
        preds = []
        for w in iter_windows(trace, 256, 4096):
            preds.append(manual.step(w)[0])
            _patch(preds, manual.consume_flush())
        _patch(preds, manual.flush())
    assert torch.equal(p_t, torch.cat(preds)[:trace.n_packets])
    _same_stats(s_t, manual.stats)


@pytest.mark.parametrize("chunked", [True, False])
def test_record_latency_syncs_only_on_its_events(stream_served, chunked):
    """With record_latency on, the warm graph server's loop runs under
    torch.cuda.set_sync_debug_mode('error'): the latency path waits on
    events (which the mode allows), and nothing else in the loop syncs —
    not the pinned staging, not the side stream, not the steps. The mode
    is on while the source runs and off before the drain and the closing
    stats.check()."""
    from repro_torch.netsim.ingest import slice_trace
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, _, big_dev = stream_served
    kw = dict(_stream_kw(True), **(dict(chunk_windows=4) if chunked else {}))
    srv = StreamingHybridServer(art, _rf_backend(big_dev), **kw)
    p_ref, s_ref = srv.serve_trace(trace)          # probe and capture
    for samples in (None, 64):
        def source():
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for lo in range(0, trace.n_packets, 1000):
                    yield slice_trace(trace, lo, min(lo + 1000,
                                                     trace.n_packets))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        srv.reset()
        try:
            p, s = srv.serve_stream(source(), record_latency=True,
                                    latency_samples=samples)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(p, p_ref)
        _same_stats(s, s_ref)
        summ = srv.latency.summary()
        assert summ["n"] == trace.n_packets
        assert 0.0 < summ["p50_ms"] <= summ["p99_ms"] <= summ["max_ms"]
        if samples:
            assert srv.latency.latencies().size == samples


def test_obs_on_card_equals_obs_off(stream_served, tmp_path):
    """An Observability on the card, chunked through the graph and per
    window deferred: the same predictions as without, a valid event log,
    closed rollups (their class counts from the card) matching the
    served predictions."""
    from repro_torch.obs import Observability, validate_event_log
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, _, big_dev = stream_served
    for path_kw in (dict(chunk_windows=8), dict(flush_every=4)):
        kw = dict(_stream_kw(True), **path_kw)
        p_ref, _ = StreamingHybridServer(art, _rf_backend(big_dev),
                                         **kw).serve_trace(trace)
        log = str(tmp_path / "events.jsonl")
        obs = Observability(events_path=log, rollup_every=3)
        srv = StreamingHybridServer(art, _rf_backend(big_dev), obs=obs, **kw)
        p, s = srv.serve_trace(trace)
        obs.close()
        assert torch.equal(p, p_ref)
        assert validate_event_log(log) == obs.events.emitted
        rows = list(obs.rollups.rows)
        assert rows and sum(r["sums"]["packets"] for r in rows) == s.n_packets
        counts = np.sum([r["sums"]["class_counts"] for r in rows], axis=0)
        want = torch.bincount(p.cpu(), minlength=2).numpy()
        if "flush_every" not in path_kw:      # deferred rows: provisional
            assert counts.tolist() == want.tolist()


# -- the sharded tier on one NCCL rank ----------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(stream_served):
    """The one-device ('shard', 'data') mesh on the card: with no group
    yet, ``flow_shard_mesh`` starts a one-rank NCCL group."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import flow_shard_mesh
    started = not dist.is_initialized()
    mesh = flow_shard_mesh(device="cuda")
    assert dist.get_world_size() == 1 and "nccl" in dist.get_backend()
    yield mesh
    if started:
        dist.destroy_process_group()


def _stream_launches():
    from repro_torch.kernels import evict as ev
    from repro_torch.kernels import stream_update as su
    return dict(ek.LAUNCHES, **su.LAUNCHES, **ev.LAUNCHES)


@pytest.mark.parametrize("path_kw", [{}, dict(chunk_windows=8),
                                     dict(flush_every=4)])
def test_sharded_graphs_equal_single_device(stream_served, nccl_mesh,
                                            path_kw):
    """The sharded window step, chunk step and deferred step (with its
    flush) through their CUDA graphs, collectives captured inside, against
    the single-device server's graphs on the same card: predictions,
    counters, flow table, epoch 0, the same kernel launches; a replayed
    step does not sync the host."""
    from repro_torch.netsim.stream import iter_windows
    from repro_torch.serving.shard_serving import ShardedStreamingServer
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, _, big_dev = stream_served
    kw = dict(_stream_kw(True), **path_kw)
    ref = StreamingHybridServer(art, _rf_backend(big_dev), **kw)
    before = _stream_launches()
    p_ref, s_ref = ref.serve_trace(trace)
    torch.cuda.synchronize()
    mid = _stream_launches()
    srv = ShardedStreamingServer(art, _rf_backend(big_dev), mesh=nccl_mesh,
                                 **kw)
    p, s = srv.serve_trace(trace)
    torch.cuda.synchronize()
    after = _stream_launches()
    assert srv._fused_ok is True and set(srv._step_graphs) \
        == set(ref._step_graphs)
    assert {k: after[k] - mid[k] for k in after} \
        == {k: mid[k] - before[k] for k in after}
    assert torch.equal(p, p_ref)
    _same_stats(s, s_ref)
    assert s.n_evicted > 0
    assert torch.equal(srv.flow_table(), ref.flow_table())
    assert srv.epoch == 0.0
    if not path_kw:
        w = next(iter(iter_windows(trace, 256, 4096)))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            srv.step(w)
        finally:
            torch.cuda.set_sync_debug_mode(0)


def test_sharded_reset_under_graphs(stream_served, nccl_mesh):
    """``reset`` refills this rank's block and epoch in place: the captured
    graphs (collectives inside) serve the trace again to the same answers,
    with no new capture."""
    from repro_torch.serving.shard_serving import ShardedStreamingServer
    trace, art, _, big_dev = stream_served
    srv = ShardedStreamingServer(art, _rf_backend(big_dev), mesh=nccl_mesh,
                                 chunk_windows=8, **_stream_kw(True))
    p1, s1 = srv.serve_trace(trace)
    graphs = dict(srv._step_graphs)
    ptrs = (srv.state.regs.data_ptr(), srv.state.epoch.data_ptr())
    srv.reset()
    assert srv.stats.n_windows == 0 and srv.epoch == 0.0
    assert float(srv.state.epoch) == float("inf")
    p2, s2 = srv.serve_trace(trace)
    assert srv._step_graphs == graphs
    assert (srv.state.regs.data_ptr(), srv.state.epoch.data_ptr()) == ptrs
    assert torch.equal(p1, p2)
    _same_stats(s1, s2)


def test_sharded_syncing_backend_served_eagerly(stream_served, nccl_mesh):
    """A backend that syncs the host: rank 0's probe says so, every rank
    serves two-phase (rank 0's answers broadcast), equal to the eager
    single-device server."""
    from repro_torch.ml.trees import predict_tree_ensemble
    from repro_torch.serving.shard_serving import ShardedStreamingServer
    from repro_torch.serving.stream_serving import StreamingHybridServer
    trace, art, _, big_dev = stream_served
    kw = dict(_stream_kw(True), chunk_windows=8)

    def np_backend(r):                         # a host round trip
        return predict_tree_ensemble(big_dev, r).cpu().numpy()

    p_ref, s_ref = StreamingHybridServer(art, _rf_backend(big_dev),
                                         fuse=False, **kw).serve_trace(trace)
    srv = ShardedStreamingServer(art, np_backend, mesh=nccl_mesh, **kw)
    p, s = srv.serve_trace(trace)
    assert srv._fused_ok is False and not srv._step_graphs
    assert torch.equal(p_ref, p)
    _same_stats(s_ref, s)


# -- B7: the per-feature-loop lookup ------------------------------------------------

def _loop_tables(rng, f, u, t, s, c, vote, dev):
    """Unflattened tables: codes in [0, 3) with strides 3^j, so wherever
    3^f > s some keys fall past S (leaf 0 in the loop kernel)."""
    edges = _ragged_edges(rng, f, u)
    ftable = rng.integers(0, 3, (f, u + 1, t)).astype(np.int32)
    strides = np.array([[3 ** j for j in range(f)]] * t, np.int32)
    dtable = (rng.integers(0, c, (t, s)) if vote
              else rng.integers(-2000, 2000, (t, s))).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (edges, ftable, strides, dtable))


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("f,u,t,s,c,vote", [
    (5, 39, 10, 136, 2, True), (5, 34, 10, 200, 3, True),
    (3, 9, 33, 20, 32, True), (5, 39, 10, 136, 1, False),
    (5, 62, 60, 5712, 1, False)])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 2048, 2049, 16000])
def test_loop_kernel_equals_plain(cuda, n, f, u, t, s, c, vote, staged):
    rng = np.random.default_rng(n + f + t + s)
    edges, ftable, strides, dtable = _loop_tables(rng, f, u, t, s, c, vote,
                                                  cuda)
    if staged and not ek.loop_fits_smem(f, u, t, s, 128):
        pytest.skip("tables do not fit one block's shared memory")
    x = torch.from_numpy(_hard_rows(rng, edges.cpu().numpy(), n)).to(cuda)
    kw = dict(n_classes=c, vote=vote)
    before = ek.LAUNCHES["loop"]
    out = ek.ensemble_lookup_loop(x, edges, ftable, strides, dtable,
                                  staged=staged, **kw)
    torch.cuda.synchronize()
    assert ek.LAUNCHES["loop"] == before + 1
    assert out.shape == (n, c if vote else 1)
    assert torch.equal(out, ek.ensemble_lookup_loop_ref(
        x, edges, ftable, strides, dtable, **kw))


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("tile_n", [1, 16, 32, 256, 512, 1000])
def test_loop_kernel_tiles(cuda, tile_n, staged):
    """B7 at block sizes other than the default: one lane a row (512 rows
    and more, rows looped in rounds), many lanes a row, a ragged last
    block; votes (keys past S among them) and sums."""
    rng = np.random.default_rng(tile_n + 2)
    for c, vote in ((3, True), (1, False)):
        edges, ftable, strides, dtable = _loop_tables(rng, 5, 39, 10, 200, c,
                                                      vote, cuda)
        x = torch.from_numpy(_hard_rows(rng, edges.cpu().numpy(),
                                        3001)).to(cuda)
        kw = dict(n_classes=c, vote=vote)
        before = ek.LAUNCHES["loop"]
        out = ek.ensemble_lookup_loop(x, edges, ftable, strides, dtable,
                                      staged=staged, tile_n=tile_n, **kw)
        torch.cuda.synchronize()
        assert ek.LAUNCHES["loop"] == before + 1
        assert torch.equal(out, ek.ensemble_lookup_loop_ref(
            x, edges, ftable, strides, dtable, **kw))


def test_loop_kernel_rejects_bad_operands(cuda):
    rng = np.random.default_rng(0)
    edges, ftable, strides, dtable = _loop_tables(rng, 5, 20, 10, 100, 2,
                                                  True, cuda)
    x = torch.zeros((4, 5), device=cuda)
    kw = dict(n_classes=2, vote=True)
    with pytest.raises(TypeError):
        ek.ensemble_lookup_loop(x, edges, ftable.float(), strides, dtable, **kw)
    with pytest.raises(TypeError):
        ek.ensemble_lookup_loop(x, edges, ftable, strides, dtable.int(), **kw)
    with pytest.raises(ValueError):
        ek.ensemble_lookup_loop(x, edges, ftable, strides[:, :4].contiguous(),
                                dtable, **kw)
    with pytest.raises(ValueError):
        ek.ensemble_lookup_loop(x, edges, ftable.cpu(), strides, dtable, **kw)
    with pytest.raises(ValueError):
        ek.ensemble_lookup_loop(x, edges, ftable, strides, dtable,
                                n_classes=33, vote=True)
    assert ek.ensemble_lookup_loop(x[:0], edges, ftable, strides, dtable,
                                   **kw).shape == (0, 2)


# -- HybridServer on the card: loop tiles, the fused step, autotune ------------------

@pytest.fixture(scope="module")
def served():
    """A small RF switch artifact and an XGB backend trained on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.mapping import map_tree_ensemble
    from repro_torch.data.unsw_like import make_unsw_like, train_test_split
    from repro_torch.ml.trees import fit_random_forest, fit_xgboost
    x, y = make_unsw_like(4000, seed=0, n_features=5)
    xtr, ytr, xte, _ = train_test_split(x, y)
    small = fit_random_forest(xtr, ytr, n_classes=2, n_trees=6, max_depth=4,
                              seed=0, device="cpu")
    big = fit_xgboost(xtr, ytr, n_trees=8, max_depth=4, device="cpu")
    return (map_tree_ensemble(small, 5), big.to("cuda"),
            torch.from_numpy(xte).to("cuda"))


def _xgb_backend(big):
    from repro_torch.ml.trees import predict_margin_xgboost
    return lambda rows: (predict_margin_xgboost(big, rows) > 0).to(torch.int32)


CALLS = ((0, 300), (300, 257), (500, 300))        # (first row, rows): 800


def _serve(server, x, calls=CALLS):
    out = []
    for lo, n in calls:
        pred, stats = server.classify(x[lo:lo + n])
        out.append((pred, stats.as_tensors()))
    return out


def _same(a, b):
    return all(torch.equal(pa, pb) and torch.equal(fa, fb)
               and torch.equal(ra, rb)
               for (pa, (fa, ra)), (pb, (fb, rb)) in zip(a, b))


def test_loop_tiles_server_equals_plain(served):
    from repro_torch.kernels.tuning import TileConfig
    from repro_torch.serving.hybrid_serving import HybridServer
    art, big, x = served
    backend = _xgb_backend(big)
    loop = HybridServer(art, backend, capacity=64, fuse=False,
                        tiles=TileConfig(impl="loop"))
    plain = HybridServer(art, backend, capacity=64, fuse=False,
                         use_kernel=False)
    counts = dict(ek.LAUNCHES)
    got = _serve(loop, x)
    torch.cuda.synchronize()
    assert ek.LAUNCHES["loop"] == counts["loop"] + 3
    assert ek.LAUNCHES["matmul"] == counts["matmul"]
    assert ek.LAUNCHES["compare"] == counts["compare"]
    assert _same(got, _serve(plain, x))


@pytest.mark.parametrize("impl", ["fused", "loop"])
def test_fused_server_equals_eager(served, impl):
    """The captured step against the eager one, bit for bit in preds, frac
    and rows, over two shapes and a tau change (tau is not baked in); the
    outputs of earlier calls stay valid after later replays."""
    from repro_torch.kernels.tuning import TileConfig
    from repro_torch.serving.hybrid_serving import HybridServer
    art, big, x = served
    backend = _xgb_backend(big)
    tiles = TileConfig(impl=impl)
    fused = HybridServer(art, backend, capacity=64, tiles=tiles)
    eager = HybridServer(art, backend, capacity=64, tiles=tiles, fuse=False)
    first = _serve(fused, x)
    assert fused._fused_ok is True
    assert set(fused._graphs) == {(257, 5), (300, 5)}
    kept = [(p.clone(), (f.clone(), r.clone())) for p, (f, r) in first]
    more = CALLS + ((100, 300), (543, 257))
    assert _same(_serve(fused, x, more), _serve(eager, x, more))
    assert _same(first, kept)
    assert _same(first, _serve(eager, x))
    for tau in (0.55, 0.95):
        fused.threshold = eager.threshold = tau
        assert _same(_serve(fused, x), _serve(eager, x))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused.classify(x[:300])
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_syncing_backend_falls_back_to_eager(served):
    from repro_torch.serving.hybrid_serving import HybridServer
    art, big, x = served
    backend = _xgb_backend(big)

    def np_backend(rows):                  # a host round trip: syncs
        return backend(rows).cpu().numpy()

    srv = HybridServer(art, np_backend, capacity=64)
    eager = HybridServer(art, backend, capacity=64, fuse=False)
    got = _serve(srv, x)
    assert srv._fused_ok is False and not srv._graphs
    assert torch.cuda.get_sync_debug_mode() == 0      # the probe restored it
    assert _same(got, _serve(eager, x))


def test_update_tables_under_a_captured_graph(served):
    import dataclasses
    from repro_torch.serving.hybrid_serving import HybridServer
    art, big, x = served
    backend = _xgb_backend(big)
    fused = HybridServer(art, backend, capacity=64)
    _serve(fused, x)                        # probe, then capture two shapes
    graphs = dict(fused._graphs)
    flipped = dataclasses.replace(art, dtable_class=1 - art.dtable_class,
                                  ftable_flat=None, dtable_flat=None,
                                  dtable_pad=None)
    fused.update_tables(flipped)
    assert fused._graphs == graphs          # no re-capture
    want = _serve(HybridServer(flipped, backend, capacity=64, fuse=False), x)
    got = _serve(fused, x)
    assert _same(got, want)
    assert not torch.equal(got[0][0], _serve(
        HybridServer(art, backend, capacity=64, fuse=False), x)[0][0])


def test_autotune_times_every_tree_candidate(served):
    from repro_torch.kernels import tuning
    from repro_torch.serving.hybrid_serving import HybridServer
    art, big, x = served
    tuning.clear_tile_cache()
    before = ek.LAUNCHES["loop"]
    srv = HybridServer(art, _xgb_backend(big), capacity=64, autotune=True)
    assert ek.LAUNCHES["loop"] > before
    timings = tuning.sweep_timings(srv.artifact)
    assert set(timings) == set(tuning.candidate_tiles(2048)) | {
        tuning.DEFAULT_TILES}
    assert all(0.0 < t < 1.0 for t in timings.values())
    assert srv.tiles == min(timings, key=timings.get)
    plain = HybridServer(art, srv.backend_fn, capacity=64, use_kernel=False,
                         fuse=False)
    assert _same(_serve(srv, x), _serve(plain, x))
    assert HybridServer(art, srv.backend_fn, autotune=True,
                        use_kernel=False).tiles.impl == "ref"


# -- B8: the int8-KV decode attention, and the LM decode step on the card -------

def _b8_args(dev, b, s, g, m, hd, seed, mask):
    """A synthetic int8 cache (normal K/V of std 2, absmax/127 scales,
    rounded codes), a seeded q and a live mask: every slot, a ring with
    holes (each row live up to its own length, a fifth of those dead), or
    none."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, g, m, hd), dtype=np.float32)
    out = [torch.from_numpy(q)]
    for _ in range(2):
        f = rng.standard_normal((b, s, g, hd), dtype=np.float32) * 2
        sc = (np.abs(f).max(axis=-1, keepdims=True) / 127.0
              + 1e-8).astype(np.float32)
        out += [torch.from_numpy(np.rint(f / sc).astype(np.int8)),
                torch.from_numpy(sc)]
    if mask == "all":
        valid = np.ones((b, s), np.float32)
    elif mask == "dead":
        valid = np.zeros((b, s), np.float32)
    else:
        lengths = rng.integers(1, s + 1, (b, 1))
        valid = ((np.arange(s)[None] < lengths)
                 & (rng.random((b, s)) >= 0.2)).astype(np.float32)
    q, kq, ks, vq, vs = out
    return [a.to(dev) for a in (q, kq, ks, vq, vs, torch.from_numpy(valid))]


def _b8_check(da, args):
    """One launch, within rtol 2e-4 / atol 2e-5 of the plain version (the
    reference's own Pallas-against-oracle tolerance)."""
    scale = float(1.0 / np.sqrt(np.float32(args[0].shape[-1])))
    before = da.LAUNCHES["decode_attention"]
    out = da.decode_attention_int8(*args, scale=scale)
    torch.cuda.synchronize()
    assert da.LAUNCHES["decode_attention"] == before + 1
    ref = da.decode_attention_int8_ref(*args, scale=scale)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, rtol=da.RTOL, atol=da.ATOL)


# the served shapes of qwen3-4b (S=32768, hd=128) and of h2o-danube's
# 4096-slot ring (hd=80: 10 lanes of a 16-lane slot group hold dims), ragged
# S, then M x hd at B=2, G=2
B8_SHAPES = [(8, 32768, 8, 4, 128), (8, 4096, 8, 4, 80), (2, 1, 2, 4, 128),
             (2, 700, 2, 4, 128), (2, 1000, 2, 4, 128)] + [
    (2, 1000, 2, m, hd) for m in (1, 4, 8) for hd in (16, 64, 80, 128)] + [
    # M past 8 (query groups over the grid), and the served shapes of
    # recurrentgemma (M=10, hd=256, its 2048-slot window), arctic (M=7)
    # and phi-3 (M=1, hd=96)
    (2, 1000, 1, 10, 256), (2, 1000, 2, 16, 64), (2, 1000, 2, 9, 128),
    (8, 2048, 1, 10, 256), (8, 2048, 8, 7, 128), (8, 2048, 32, 1, 96)]


@pytest.mark.parametrize("mask", ["all", "ring", "dead"])
@pytest.mark.parametrize("b,s,g,m,hd", B8_SHAPES)
def test_decode_attention_kernel_matches_plain(cuda, b, s, g, m, hd, mask):
    from repro_torch.kernels import decode_attention as da
    _b8_check(da, _b8_args(cuda, b, s, g, m, hd, seed=s + m + hd, mask=mask))


def _split_case(dev, case):
    """B8's operands at the split's edges (B=8, G=8, M=4, hd=128): S one
    below, at and one above a chunk boundary of the split the wrapper picks
    on this card, the middle chunk entirely dead beside live ones, and one
    row all dead."""
    from repro_torch.kernels import decode_attention as da
    want = {"below": -1, "at": 0, "above": 1}.get(case, 0)
    for s in range(3000, 20000):
        plan = da.plan_for(torch.zeros(8, 8, 4, 128, device=dev),
                           torch.zeros(8, s, 8, 128, dtype=torch.int8,
                                       device=dev),
                           torch.zeros(8, s, 8, 128, dtype=torch.int8,
                                       device=dev))
        rest = s - (plan["n_split"] - 1) * plan["chunk"]
        if plan["n_split"] > 2 and (rest - plan["chunk"] if want < 1
                                    else rest) == want:
            break
    args = _b8_args(dev, 8, s, 8, 4, 128, seed=s, mask="all")
    chunk = plan["chunk"]
    if case == "dead_chunk":
        args[5][:, chunk:2 * chunk] = 0.0
    elif case == "dead_row":
        args[5][3] = 0.0
    return args, plan


@pytest.mark.parametrize("case", ["below", "at", "above", "dead_chunk",
                                  "dead_row"])
def test_decode_attention_split_edges(cuda, case):
    from repro_torch.kernels import decode_attention as da
    args, plan = _split_case(cuda, case)
    s = args[1].shape[1]
    assert (plan["n_split"] - 1) * plan["chunk"] < s
    _b8_check(da, args)


def test_decode_attention_reads_strided_views(cuda):
    """The served path's operands: one layer's view of a stacked cache and
    an (S,) mask broadcast over B (stride 0)."""
    from repro_torch.kernels import decode_attention as da
    q, kq, ks, vq, vs, _ = _b8_args(cuda, 2, 600, 2, 4, 64, seed=3,
                                    mask="all")
    stack = [torch.stack([a.roll(1, 0), a]) for a in (kq, ks, vq, vs)]
    live = (torch.arange(600, device=cuda) < 411).to(torch.float32)
    args = [q] + [t[1] for t in stack] + [live[None].expand(2, 600)]
    assert not args[1].is_contiguous() or args[1].storage_offset() > 0
    _b8_check(da, args)


def test_decode_attention_cuda_never_takes_plain(cuda, monkeypatch):
    """A CUDA tensor launches the kernel or raises: the plain version is
    never called for it, and bad operands raise instead of falling back."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    args = _b8_args(cuda, 2, 300, 2, 4, 32, seed=0, mask="ring")
    want = da.decode_attention_int8_ref(*args, scale=0.2)

    def refuse(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(da, "decode_attention_int8_ref", refuse)
    before = da.LAUNCHES["decode_attention"]
    got = ops.decode_attention_int8(*args, scale=0.2)
    torch.cuda.synchronize()
    assert da.LAUNCHES["decode_attention"] == before + 1
    torch.testing.assert_close(got, want, rtol=da.RTOL, atol=da.ATOL)
    with pytest.raises(ValueError):                   # M = 0
        ops.decode_attention_int8(torch.zeros(2, 2, 0, 32, device=cuda),
                                  *args[1:], scale=0.2)
    with pytest.raises(ValueError):                   # k_q on the CPU
        ops.decode_attention_int8(args[0], args[1].cpu(), *args[2:],
                                  scale=0.2)
    with pytest.raises(TypeError):
        ops.decode_attention_int8(*args[:5], args[5].double(), scale=0.2)
    assert da.LAUNCHES["decode_attention"] == before + 1


def fill_quantized(dst, src):
    """Quantize the prefill K/V through the port's _q8 into the leading
    slots of an int8 decode cache, in place (the reference's
    tests/test_int8_kv.py helper; tests/test_torch_lm.py and
    tests/test_torch_archs.py use it too); every other cache leaf (a float
    K/V, an MLA latent, a recurrent state, Whisper's cross K/V) takes the
    prefill's values in its leading slots."""
    from repro_torch.models.attention import _q8
    from repro_torch.serving.engine import _place_prefill_into_decode
    if isinstance(dst, dict) and "k_scale" in dst:
        for key in ("k", "v"):
            q, sc = _q8(src[key])
            dst[key][tuple(slice(0, x) for x in q.shape)] = q
            dst[key + "_scale"][tuple(slice(0, x) for x in sc.shape)] = sc
        dst["pos"][..., :src["pos"].shape[-1]] = src["pos"]
        return dst
    if isinstance(dst, dict):
        return {k: fill_quantized(dst[k], src[k]) for k in dst}
    if isinstance(dst, (list, tuple)):
        return type(dst)(fill_quantized(d, s) for d, s in zip(dst, src))
    return _place_prefill_into_decode(dst, src)


# h2o-danube's smoke config has hd=16; "hd80" widens it to its published
# head dim of 80 (d_model 320 over 4 heads)
@pytest.mark.parametrize("arch", ["qwen3-4b", "h2o-danube-1.8b",
                                  "h2o-danube-1.8b@hd80"])
def test_int8_decode_step_on_card_equals_cpu(cuda, arch):
    """A smoke-size int8 decode step on the card (B8 once per layer)
    against the same step on the CPU (the plain version), within
    1e-3 * max|logits|: the kernel's softmax order, the card's f32 matmuls,
    and an int8 code that a one-ulp k can move by one."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import model as M
    from repro_torch.models.transformer import tree_map
    name, _, width = arch.partition("@")
    cfg = get_smoke_config(name)
    if width == "hd80":
        cfg = cfg.scaled(d_model=320)
        assert cfg.head_dim == 80
    params = M.init_model(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a, dev=dev: a.to(dev), params)
        _, pc = M.prefill(p, cfg, {"tokens": toks[:, :19].to(dev)})
        caches = fill_quantized(M.init_decode_cache(cfg, 2, 24, quantize_kv=True,
                                              device=dev), pc)
        before = da.LAUNCHES["decode_attention"]
        logits, _ = M.decode_step(p, cfg, toks[:, 19].to(dev), 19, caches)
        launched = da.LAUNCHES["decode_attention"] - before
        out[dev] = (logits.cpu(), launched)
    assert out["cpu"][1] == 0 and out["cuda"][1] == cfg.n_layers
    ref, got = out["cpu"][0], out["cuda"][0]
    assert float((ref - got).abs().max()) <= 1e-3 * float(ref.abs().max())
    assert torch.equal(ref.argmax(-1), got.argmax(-1))


ALL_ARCHS = ["deepseek-v3-671b", "arctic-480b", "xlstm-1.3b", "qwen3-4b",
             "qwen2.5-32b", "h2o-danube-1.8b", "yi-6b", "whisper-base",
             "phi-3-vision-4.2b", "recurrentgemma-2b"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_graph_equals_eager_bit_for_bit(cuda, arch):
    """Every family at smoke size: four greedy steps through the engine's
    decode graph (the first step eager as its warm-up, then the capture,
    then replays) against four eager ``decode_step`` calls from the same
    prefill, on an
    int8 cache wherever there are GQA layers: the same tokens, logits and
    caches bit for bit, every cache tensor where it was (its
    ``data_ptr()``), and B8 launched once per GQA layer per eager step but
    only at the warm-up and the capture on the graph route."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import model as M
    from repro_torch.models.transformer import _layer_spec, tree_leaves
    from repro_torch.serving.engine import ServeEngine
    cfg = get_smoke_config(arch)
    params = M.init_model(cfg, 0, device=cuda)
    rng = np.random.default_rng(0)
    s, steps = 10, 4
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, s)).astype(np.int32)).to(cuda)}
    front = (2, cfg.n_frontend_tokens, cfg.frontend_dim)
    if cfg.encdec:
        batch["frames"] = torch.from_numpy(
            0.1 * rng.standard_normal(front).astype(np.float32)).to(cuda)
    n_front = 0
    if cfg.frontend == "image_patches":
        batch["patch_embeds"] = torch.from_numpy(
            0.1 * rng.standard_normal(front).astype(np.float32)).to(cuda)
        n_front = cfg.n_frontend_tokens
    n_gqa = 0 if cfg.encdec else sum(
        _layer_spec(cfg, i)[0] in ("attn", "local_attn")
        for i in range(cfg.n_layers))
    logits0, pcache = M.prefill(params, cfg, batch)
    eng = ServeEngine(cfg, params, batch=2, max_len=s + n_front + 8)
    assert eng.graph
    runs = {}
    for route in ("eager", "graph"):
        step = eng.decode if route == "graph" else (
            lambda tok, pos, c: M.decode_step(params, cfg, tok, pos, c))
        caches = fill_quantized(M.init_decode_cache(
            cfg, 2, s + n_front + 8, dtype=torch.float32,
            quantize_kv=n_gqa > 0, device=cuda), pcache)
        ptrs = [t.data_ptr() for t in tree_leaves(caches)]
        logits, toks, logs = logits0, [], []
        before = da.LAUNCHES["decode_attention"]
        for i in range(steps):
            nxt = logits.argmax(-1).to(torch.int32)
            logits, caches = step(nxt, s + n_front + i, caches)
            toks.append(nxt)
            logs.append(logits)
        torch.cuda.synchronize()
        launched = da.LAUNCHES["decode_attention"] - before
        assert [t.data_ptr() for t in tree_leaves(caches)] == ptrs
        runs[route] = (toks, logs, tree_leaves(caches), launched)
    for a, b in zip(runs["eager"][0] + runs["eager"][1]
                    + runs["eager"][2], runs["graph"][0] + runs["graph"][1]
                    + runs["graph"][2]):
        assert torch.equal(a, b)
    assert runs["eager"][3] == n_gqa * steps
    assert runs["graph"][3] == n_gqa * 2


def test_analysis_hotpath_on_the_card(cuda):
    """The hot-path audit at its probe geometry on the card: every
    contracted body eagerly under the op recorder and the sync debug mode,
    then through its CUDA graph (the capture and two replays), with no
    finding; each streaming body launches B5, B6's sweep and B1."""
    from repro_torch.analysis import hotpath
    recs = hotpath.audit(device="cuda")
    found = []
    for check in (hotpath.donation_findings, hotpath.zero_sync_findings,
                  hotpath.dtype_findings, hotpath.collective_findings):
        found += [f.format() for f in check(recs)]
    assert not found, "\n".join(found)
    for r in recs:
        assert r.graph == bool(r.row.get("graph")), r.label
        if r.row["probe"] in ("window", "defer"):
            assert r.launches.get("stream_update") == 1, r.label
            assert r.launches.get("evict_fill") == 1, r.label
