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


def _tables(rng, f, u, t, s, c, vote, dev):
    edges = np.sort(rng.normal(size=(f, u)), axis=1).astype(np.float32)
    edges[:, u - u // 4:] = np.inf                    # +inf pads never match
    radix = 2
    ftable = rng.integers(0, radix, (f, u + 1, t)).astype(np.int32)
    strides = np.array([[radix ** (f - 1 - j) for j in range(f)]] * t,
                       np.int32)
    assert radix ** f <= s
    dtable = (rng.integers(0, c, (t, s)) if vote
              else rng.integers(-2000, 2000, (t, s))).astype(np.int32)
    d = torch.from_numpy(dtable).to(dev)
    return (torch.from_numpy(edges).to(dev),
            flatten_ftable(torch.from_numpy(ftable), torch.from_numpy(strides)).to(dev),
            build_dtable_flat(d, c if vote else 1, vote),
            pad_dtable(d))


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("select", ["matmul", "compare"])
@pytest.mark.parametrize("f,u,t,s,c,vote", [
    (5, 34, 10, 81, 2, True), (3, 9, 7, 16, 4, True), (5, 62, 60, 600, 1, False),
    (8, 20, 33, 300, 32, True)])
@pytest.mark.parametrize("n", [1, 127, 129, 2048])
def test_kernel_equals_plain(cuda, n, f, u, t, s, c, vote, select, staged):
    rng = np.random.default_rng(n + f + t)
    tabs = _tables(rng, f, u, t, s, c, vote, cuda)
    cout, _, s_pad = tabs[2].shape
    b_pad, t_pad = tabs[1].shape[0] // f, tabs[1].shape[1]
    if staged and not ek.fits_smem(f, u, b_pad, t_pad, t, s_pad, cout,
                                   select, 128):
        pytest.skip("tables do not fit one block's shared memory")
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(cuda)
    before = ek.LAUNCHES[select]
    out = ek.ensemble_lookup_fused(x, *tabs, select=select, staged=staged)
    torch.cuda.synchronize()
    assert ek.LAUNCHES[select] == before + 1
    assert torch.equal(out, ek.ensemble_lookup_fused_ref(x, *tabs,
                                                         select=select))


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


@pytest.mark.parametrize("f,u", [(5, 63), (8, 255), (16, 128), (1, 1)])
@pytest.mark.parametrize("n", [1, 300, 2048])
def test_bucketize_kernel_equals_plain(cuda, n, f, u):
    from repro_torch.kernels import bucketize as bk
    rng = np.random.default_rng(n + f + u)
    edges = _ragged_edges(rng, f, u) if u > 1 else np.zeros((f, u), np.float32)
    x = torch.from_numpy(_hard_rows(rng, edges, n)).to(cuda)
    e = torch.from_numpy(edges).to(cuda)
    before = bk.LAUNCHES["bucketize"]
    out = bk.bucketize(x, e)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["bucketize"] == before + 1
    assert out.dtype == torch.int32
    assert torch.equal(out, bk.bucketize_ref(x, e))


# -- B3: the classical lookup ---------------------------------------------------

@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("f,u,m", [(5, 63, 1), (5, 63, 2), (8, 127, 10),
                                   (3, 20, 17)])
@pytest.mark.parametrize("n", [1, 127, 129, 2048])
def test_classical_kernel_equals_plain(cuda, n, f, u, m, staged):
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
    server.classify(xd)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pred, _ = server.classify(xd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(pred, plain.classify(xd)[0])
