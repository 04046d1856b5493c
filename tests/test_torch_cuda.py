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
