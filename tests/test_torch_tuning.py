"""The port's tile autotune on the CPU: the candidate set (fused and loop
candidates, no plain-version candidate), the cache key against the
reference's, the sweep's argmin, cache and synthetic rows with the device
timer replaced by a fake, and ``HybridServer(autotune=True)`` doing nothing
on a CPU server. The device timer itself runs on the card only
(test_torch_cuda.py and chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import tuning as jtuning  # noqa: E402
from repro_torch.kernels import tuning as ttuning  # noqa: E402
from repro_torch.kernels.tuning import DEFAULT_TILES, TileConfig  # noqa: E402
from test_torch_parity import port_artifact  # noqa: E402


@pytest.fixture(scope="module")
def artifacts(anomaly_data):
    from benchmarks.common import fit_and_map
    xtr, ytr, xte, _ = anomaly_data
    out = {m: fit_and_map(m, xtr, ytr, n_trees=4, max_depth=4)[1]
           for m in ("RF", "SVM")}
    return out, xte


@pytest.fixture
def clean_cache():
    ttuning.clear_tile_cache()
    yield
    ttuning.clear_tile_cache()


@pytest.mark.parametrize("batch", [2048, 256, 64])
def test_candidate_tiles_match_reference_without_ref(batch):
    got = ttuning.candidate_tiles(batch)
    assert all(c.impl != "ref" for c in got)
    assert TileConfig(impl="loop") in got
    fused = {(c.tile_n, c.select) for c in got if c.impl == "fused"}
    ref_fused = {(c.tile_n, c.select) for c in jtuning.candidate_tiles(batch)
                 if c.impl == "fused"}
    if batch >= 128:
        assert fused == ref_fused
        assert fused == {(n, s) for n in (128, 512) if n <= batch
                         for s in ("matmul", "compare")}
        assert len(got) == len(fused) + 1
    else:                                  # below every block size
        assert got == [DEFAULT_TILES, TileConfig(impl="loop")]
    assert {c.impl for c in jtuning.candidate_tiles(batch)} - \
        {c.impl for c in got} == {"ref"}


def test_artifact_key_matches_reference(artifacts):
    arts, _ = artifacts
    for art in arts.values():
        assert ttuning._artifact_key(port_artifact(art)) == \
            jtuning._artifact_key(art)


def test_time_config_needs_a_card(artifacts):
    arts, xte = artifacts
    ta = port_artifact(arts["RF"])
    with pytest.raises(ValueError, match="CUDA"):
        ttuning._time_config(ta, torch.from_numpy(xte[:8]), DEFAULT_TILES, 1)


def test_autotune_sweeps_once_and_takes_the_argmin(artifacts, clean_cache,
                                                   monkeypatch):
    arts, _ = artifacts
    ta = port_artifact(arts["RF"])
    calls, rows = [], []
    cost = {TileConfig(tile_n=512, select="compare"): 1.0,
            TileConfig(impl="loop"): 2.0}

    def fake_time(art, x, tiles, reps):
        calls.append(tiles)
        rows.append(x)
        if tiles == TileConfig(tile_n=512, select="matmul"):
            raise RuntimeError("launch refused")
        return cost.get(tiles, 3.0)

    monkeypatch.setattr(ttuning, "_time_config", fake_time)
    assert ttuning.sweep_timings(ta) is None
    best = ttuning.autotune_tiles(ta, batch=2048, seed=3)
    assert best == TileConfig(tile_n=512, select="compare")
    # every candidate plus the default was tried; the raising one is missing
    assert calls == ttuning.candidate_tiles(2048) + [DEFAULT_TILES]
    timings = ttuning.sweep_timings(ta)
    assert set(timings) == set(calls) - {TileConfig(tile_n=512,
                                                    select="matmul")}
    assert timings[TileConfig(impl="loop")] == 2.0
    # cached per (artifact shape, device, batch): no second sweep
    assert ttuning.autotune_tiles(ta, batch=2048, seed=3) == best
    assert len(calls) == 6
    assert ttuning.sweep_timings(ta, batch=256) is None
    # the synthetic rows: seeded, on the artifact's device, around the edges
    x = rows[0]
    assert x.shape == (2048, 5) and x.dtype == torch.float32
    assert x.device == ta.device
    assert all(torch.equal(x, r) for r in rows)
    e = ta.edges[torch.isfinite(ta.edges)]
    lo, hi = float(e.min()), float(e.max())
    span = max(hi - lo, 1.0)
    assert float(x.min()) >= lo - 0.1 * span - 1e-3 * span
    assert float(x.max()) <= hi + 0.1 * span + 1e-3 * span
    ttuning.clear_tile_cache()
    ttuning.autotune_tiles(ta, batch=2048, seed=3)
    assert torch.equal(rows[-1], x)                  # same seed, same rows
    ttuning.clear_tile_cache()
    ttuning.autotune_tiles(ta, batch=2048, seed=4)
    assert not torch.equal(rows[-1], x)


def test_autotune_default_wins_when_every_candidate_fails(artifacts,
                                                          clean_cache,
                                                          monkeypatch):
    arts, _ = artifacts

    def refuse(art, x, tiles, reps):
        raise RuntimeError("no card")

    monkeypatch.setattr(ttuning, "_time_config", refuse)
    assert ttuning.autotune_tiles(port_artifact(arts["SVM"])) == DEFAULT_TILES
    assert ttuning.sweep_timings(port_artifact(arts["SVM"])) == {}


def test_autotune_on_a_cpu_server_is_a_no_op(artifacts, clean_cache,
                                             monkeypatch):
    from repro_torch.serving.hybrid_serving import HybridServer
    arts, xte = artifacts

    def never(*a, **k):
        raise AssertionError("a CPU server must not sweep")

    monkeypatch.setattr(ttuning, "autotune_tiles", never)
    monkeypatch.setattr(ttuning, "_time_config", never)
    import repro_torch.serving.hybrid_serving as hs
    monkeypatch.setattr(hs, "autotune_tiles", never)

    def backend(rows):
        return torch.zeros(rows.shape[0], dtype=torch.int32)

    srv = HybridServer(port_artifact(arts["RF"]), backend, autotune=True,
                       device="cpu")
    assert srv.tiles == DEFAULT_TILES
    plain = HybridServer(port_artifact(arts["RF"]), backend, device="cpu")
    x = np.asarray(xte[:100], np.float32)
    assert torch.equal(srv.classify(x)[0], plain.classify(x)[0])
    loop = TileConfig(impl="loop")
    assert HybridServer(port_artifact(arts["RF"]), backend, autotune=True,
                        tiles=loop, device="cpu").tiles == loop
