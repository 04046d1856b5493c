"""Port parity for the streaming kernels' plain versions: the register
scatter/readout (B5, ``ops.stream_update``) and the eviction fill (B6,
``ops.evict_fill``) against the reference's oracle and its Pallas kernels in
interpret mode, ``ops.pad_window`` against its reference, and a replay of
the CUDA kernel's algorithm (per-lane atomics in any order, the sign-aware
integer min/max, the settle pass) in numpy. The kernels themselves run in
``tests/test_torch_cuda.py`` on a card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import stream_update_ref as jax_stream_update_ref  # noqa: E402
from repro_torch.kernels import evict as tev  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import stream_update as tsu  # noqa: E402
from repro_torch.netsim.stream import EVICT_FILLS, OVERFLOW_LIMIT  # noqa: E402
from test_torch_parity import assert_bit_equal  # noqa: E402


def _regs(n, rng, occupied=0.3, base=0.0):
    """A register file: untouched columns at the identities, occupied ones
    with integer counts (from ``base``) and timestamps around zero."""
    regs = np.zeros((8, n), np.float32)
    regs[2] = np.inf
    regs[3] = -np.inf
    occ = rng.random(n) < occupied
    k = int(occ.sum())
    cnt = rng.integers(1, 50, k).astype(np.float32)
    fwd = np.floor(cnt * rng.random(k)).astype(np.float32)
    byt = (cnt * 700).astype(np.float32)
    regs[0, occ] = base + cnt
    regs[1, occ] = base + byt
    regs[4, occ], regs[5, occ] = base + fwd, base + cnt - fwd
    regs[6, occ] = base + np.floor(byt * 0.4)
    regs[7, occ] = base + byt - np.floor(byt * 0.4)
    t0 = rng.uniform(-20, 10, k).astype(np.float32)
    regs[2, occ] = t0
    regs[3, occ] = t0 + rng.uniform(0, 5, k).astype(np.float32)
    return regs


def _window(w, n, rng, *, hot=False, outside=False):
    bucket = (np.zeros(w, np.int32) if hot
              else rng.integers(0, n, w).astype(np.int32))
    if outside and w >= 4:
        bucket[:4] = [-1, -n - 3, n, n + 7]
    return (bucket, rng.uniform(-30, 30, w).astype(np.float32),
            rng.integers(40, 1500, w).astype(np.float32),
            rng.integers(0, 2, w).astype(np.float32),
            rng.random(w) > 0.2)


def _port(regs, cols):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(regs),) + tuple(t(c) for c in cols)


def _jax(regs, cols):
    return (jnp.asarray(regs),) + tuple(jnp.asarray(c) for c in cols)


@pytest.mark.parametrize("limit", [None, 1000.0])
def test_stream_update_matches_reference_and_pallas(limit):
    """The reference's own case (tests/test_chunked_stream.py): n=600 (not a
    tile multiple), w=96, pad lanes, untouched-bucket +-inf identities —
    the port's plain version equals the oracle and the Pallas kernel."""
    rng = np.random.default_rng(0)
    n, w = 600, 96
    regs = np.zeros((8, n), np.float32)
    regs[2] = np.inf
    regs[3] = -np.inf
    regs[0, 5], regs[1, 5], regs[2, 5], regs[3, 5] = 3.0, 300.0, 0.5, 1.5
    cols = (rng.integers(0, n, w).astype(np.int32),
            rng.uniform(0, 10, w).astype(np.float32),
            rng.integers(40, 1500, w).astype(np.float32),
            rng.integers(0, 2, w).astype(np.float32),
            rng.random(w) > 0.2)
    before = tsu.LAUNCHES["stream_update"]
    t_regs, t_rows = tops.stream_update(*_port(regs, cols), limit=limit)
    assert tsu.LAUNCHES["stream_update"] == before     # CPU: plain version
    j_regs, j_rows = jax_stream_update_ref(*_jax(regs, cols), limit=limit)
    p_regs, p_rows = jops.stream_update(*_jax(regs, cols), limit=limit,
                                        use_pallas=True, interpret=True)
    for ref in (j_regs, p_regs):
        assert_bit_equal(ref, t_regs)
    for ref in (j_rows, p_rows):
        assert_bit_equal(ref, t_rows)


@pytest.mark.parametrize("case", ["negative_ts", "hot_spot", "outside",
                                  "one_lane", "limit_2_24", "neg_zero"])
def test_stream_update_edge_cases_match_reference(case):
    """Negative timestamps, every lane on bucket 0, bucket ids outside
    [0, N) (dropped from the update, read the way the reference's gather
    reads them), a one-lane window, sums that cross the 2^24 clamp, and
    -0.0 count registers (which regs + sums turns into +0.0)."""
    rng = np.random.default_rng(len(case))
    n, w, limit = 257, 96, None
    regs = _regs(n, rng)
    kw = {}
    if case == "hot_spot":
        kw["hot"] = True
    if case == "outside":
        kw["outside"] = True
    if case == "one_lane":
        w = 1
    if case == "limit_2_24":
        regs = _regs(n, rng, occupied=0.9, base=OVERFLOW_LIMIT - 30000.0)
        limit = OVERFLOW_LIMIT
    if case == "neg_zero":
        regs[[0, 1, 4, 5, 6, 7], :40] = -0.0
        limit = 1000.0
    cols = _window(w, n, rng, **kw)
    t_regs, t_rows = tops.stream_update(*_port(regs, cols), limit=limit)
    j_regs, j_rows = jax_stream_update_ref(*_jax(regs, cols), limit=limit)
    assert_bit_equal(j_regs, t_regs)
    assert_bit_equal(j_rows, t_rows)
    if case == "neg_zero":
        assert not np.signbit(t_regs.numpy()[[0, 1, 4, 5, 6, 7], :40]).any()
    if case == "limit_2_24":
        assert (t_regs.numpy()[[1, 6, 7]] == OVERFLOW_LIMIT).any()


def _replay_kernel(regs, bucket, ts, length, is_fwd, valid, limit, order):
    """The CUDA kernel's algorithm in numpy, lanes taken in ``order``:
    float adds into the registers one lane at a time, t_min/t_max through
    the integer views (int min/max for a clear sign bit, unsigned max/min
    for a set one), then the settle pass (+0.0, the clamp) and the gather."""
    regs = regs.copy()
    n = regs.shape[1]
    ints, uints = regs.view(np.int32), regs.view(np.uint32)
    f32 = np.float32
    for i in order:
        b = int(bucket[i])
        if not valid[i] or not 0 <= b < n:
            continue
        ln, fw = f32(length[i]), f32(is_fwd[i])
        rv = f32(f32(1.0) - fw)
        for r, c in ((0, f32(1.0)), (1, ln), (4, fw), (5, rv),
                     (6, f32(ln * fw)), (7, f32(ln * rv))):
            regs[r, b] = f32(regs[r, b] + c)
        t = f32(ts[i])
        ti, tu = np.array([t]).view(np.int32)[0], np.array([t]).view(np.uint32)[0]
        if tu >> 31 == 0:
            ints[2, b] = min(ints[2, b], ti)
            ints[3, b] = max(ints[3, b], ti)
        else:
            uints[2, b] = max(uints[2, b], tu)
            uints[3, b] = min(uints[3, b], tu)
    for r in (0, 1, 4, 5, 6, 7):
        regs[r] = regs[r] + f32(0.0)
        if limit is not None:
            regs[r] = np.minimum(regs[r], f32(limit))
    g = np.where(bucket < 0, bucket + n, bucket).clip(0, n - 1)
    return regs, regs[:, g]


@pytest.mark.parametrize("limit", [None, 1000.0, OVERFLOW_LIMIT])
def test_kernel_algorithm_is_order_free(limit):
    """Whatever order the atomics land in, the kernel's algorithm gives the
    plain version's bits: below the envelope without a clamp, and with the
    clamp at 1000 and at 2^24 (sums crossing it)."""
    rng = np.random.default_rng(7)
    n, w = 61, 200
    base = OVERFLOW_LIMIT - 40000.0 if limit == OVERFLOW_LIMIT else 0.0
    regs = _regs(n, rng, occupied=0.5, base=base)
    cols = _window(w, n, rng, outside=True)
    cols[0][10:60] = 3                           # a hot bucket
    plain = tops.stream_update(*_port(regs, cols), limit=limit)
    for seed in range(4):
        order = np.random.default_rng(seed).permutation(w)
        got = _replay_kernel(regs, *cols, limit, order)
        assert_bit_equal(plain[0], got[0])
        assert_bit_equal(plain[1], got[1])


@pytest.mark.parametrize("n", [600, 2048])
@pytest.mark.parametrize("mask_kind", ["random", "all", "none"])
def test_evict_fill_matches_reference_and_pallas(n, mask_kind):
    rng = np.random.default_rng(n)
    regs = _regs(n, rng)
    mask = {"random": rng.random(n) < 0.3, "all": np.ones(n, bool),
            "none": np.zeros(n, bool)}[mask_kind]
    fills = np.asarray(EVICT_FILLS, np.float32)
    before = tev.LAUNCHES["evict_fill"]
    got = tops.evict_fill(torch.from_numpy(regs), torch.from_numpy(mask),
                          torch.from_numpy(fills))
    assert tev.LAUNCHES["evict_fill"] == before
    args = (jnp.asarray(regs), jnp.asarray(mask), jnp.asarray(fills))
    assert_bit_equal(jops.evict_fill(*args, use_pallas=False), got)
    assert_bit_equal(jops.evict_fill(*args, use_pallas=True, interpret=True),
                     got)
    plain = tops.evict_fill(torch.from_numpy(regs), torch.from_numpy(mask),
                            torch.from_numpy(fills), use_kernel=False)
    assert_bit_equal(got, plain)


@pytest.mark.parametrize("n,tile", [(5, 8), (8, 8), (1, 4), (13, 4)])
def test_pad_window_matches_reference(n, tile):
    rng = np.random.default_rng(n)
    cols = {"bucket": rng.integers(0, 100, n).astype(np.int32),
            "ts": rng.random(n).astype(np.float32)}
    j_cols, j_valid, j_n = jops.pad_window(
        {k: jnp.asarray(v) for k, v in cols.items()}, tile)
    t_cols, t_valid, t_n = tops.pad_window(
        {k: torch.from_numpy(v) for k, v in cols.items()}, tile)
    assert j_n == t_n == n
    assert_bit_equal(j_valid, t_valid)
    for k in cols:
        assert_bit_equal(j_cols[k], t_cols[k])
    t_tup, t_valid2, _ = tops.pad_window(
        tuple(torch.from_numpy(v) for v in cols.values()), tile)
    assert isinstance(t_tup, tuple)
    assert_bit_equal(t_tup[1], t_cols["ts"])
    assert_bit_equal(t_valid2, t_valid)
