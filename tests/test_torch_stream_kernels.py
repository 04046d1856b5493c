"""Port parity for the streaming kernels' plain versions: the register
scatter/readout (B5, ``ops.stream_update``), the eviction fill (B6,
``ops.evict_fill``) and the timeout sweep (B6's second entry,
``ops.timeout_sweep``) against the reference's oracle, its Pallas kernels in
interpret mode and its ``evict_cutoff`` / ``age_out``,
``ops.pad_window`` against its reference, and a replay of
the CUDA kernel's algorithm in numpy (a block per tile of bucket columns,
its lanes listed in any order and folded by each column's threads, their
partial folds merged by shuffles, the per-tile settle, each lane's row
written by the tile that owns its gather column). The kernels themselves
run in ``tests/test_torch_cuda.py`` on a card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import stream_update_ref as jax_stream_update_ref  # noqa: E402
from repro.netsim import stream as jstream  # noqa: E402
from repro_torch.kernels import evict as tev  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import stream_update as tsu  # noqa: E402
from repro_torch.netsim import stream as tstream  # noqa: E402
from repro_torch.netsim.stream import EVICT_FILLS, OVERFLOW_LIMIT  # noqa: E402
from test_torch_parity import assert_bit_equal, port_flow_table  # noqa: E402


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


K_BLOCK = 256      # threads of a B5 block (csrc/stream_update.cu kBlock)


def _order_key(v):
    """The kernel's total order of the floats (order_key): the int bits,
    the magnitude bits flipped where the sign bit is set."""
    b = np.asarray(v, np.float32).view(np.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _ordered(a, b, pick_min):
    ka, kb = _order_key(a), _order_key(b)
    take_b = kb < ka if pick_min else kb > ka
    return np.where(take_b, b, a).astype(np.float32)


def _replay_kernel(regs, bucket, ts, length, is_fwd, valid, limit, order,
                   sms=132):
    """The CUDA kernel's algorithm (csrc/stream_update.cu) in numpy, block
    by block. A block owns ``tile_columns(N, sms)`` columns; it lists the
    valid lanes whose bucket lies in its tile (in ``order``, as warps append
    in any order); a column's q = K_BLOCK / tile threads each fold the
    listed entries e = k, k + q, ... of its column from +0.0 (t_min/t_max
    from +-inf, in the order of _order_key); the q partial folds meet in
    xor-shuffle order; the column settles (regs + fold, the clamp; the
    ordered min/max of register and fold); and the block writes the row of
    every lane whose gather column it owns. -> (regs, rows, writes, over,
    feats): writes counting the times each lane's row was written, over the
    feature-row mode's count (with a limit: count slots of every column of
    every tile settled at or above it from below), feats its (W, 8) rows
    (duration and mean IAT derived once a column as it settles, each lane
    given its column's row)."""
    regs = regs.copy()
    n = regs.shape[1]
    w = bucket.shape[0]
    f32 = np.float32
    tile = tsu.tile_columns(n, sms)
    q = K_BLOCK // tile
    rows = np.full((8, w), np.nan, np.float32)
    feats = np.full((w, 8), np.nan, np.float32)
    writes = np.zeros(w, int)
    over = 0
    g = np.where(bucket < 0, bucket + n, bucket).clip(0, n - 1)
    for c0 in range(0, n, tile):
        cols = min(tile, n - c0)
        listed = [i for i in order
                  if valid[i] and c0 <= bucket[i] < c0 + cols]
        settled = np.zeros((8, cols), np.float32)
        featured = np.zeros((cols, 8), np.float32)
        for c in range(cols):
            part = np.zeros((q, 8), np.float32)
            part[:, 2], part[:, 3] = np.inf, -np.inf
            for k in range(q):
                for i in listed[k::q]:
                    if bucket[i] != c0 + c:
                        continue
                    ln, fw = f32(length[i]), f32(is_fwd[i])
                    rv = f32(f32(1.0) - fw)
                    for r, v in ((0, f32(1.0)), (1, ln), (4, fw), (5, rv),
                                 (6, f32(ln * fw)), (7, f32(ln * rv))):
                        part[k, r] = f32(part[k, r] + v)
                    part[k, 2] = _ordered(part[k, 2], f32(ts[i]), True)
                    part[k, 3] = _ordered(part[k, 3], f32(ts[i]), False)
            o = q // 2
            while o:
                other = part[np.arange(q) ^ o]
                for r in range(8):
                    part[:, r] = (_ordered(part[:, r], other[:, r], r == 2)
                                  if r in (2, 3) else part[:, r] + other[:, r])
                o //= 2
            for r in range(8):
                fold, reg = part[r % q, r], regs[r, c0 + c]
                if r in (2, 3):
                    v = _ordered(reg, fold, r == 2)
                else:
                    v = f32(reg + fold)
                    if limit is not None and v > f32(limit):
                        v = f32(limit)
                    if limit is not None:
                        over += int(v >= f32(limit) and reg < f32(limit))
                regs[r, c0 + c] = v
                settled[r, c] = v
            cnt, col = settled[0, c], settled[:, c]
            dur = f32(col[3] - col[2]) if cnt > 0 else f32(0.0)
            iat = (f32(dur / max(f32(cnt - f32(1.0)), f32(1.0)))
                   if cnt > 1 else f32(0.0))
            featured[c] = (cnt, col[1], dur, iat, *col[4:])
        for i in range(w):
            if c0 <= g[i] < c0 + cols:
                rows[:, i] = settled[:, g[i] - c0]
                feats[i] = featured[g[i] - c0]
                writes[i] += 1
    return regs, rows, writes, over, feats


@pytest.mark.parametrize("limit", [None, 1000.0, OVERFLOW_LIMIT])
def test_kernel_algorithm_is_order_free(limit):
    """Whatever order a block lists its lanes in, the kernel's algorithm
    gives the plain version's bits, and writes each lane's row once: below the envelope without a clamp, and with the
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
        assert (got[2] == 1).all()


@pytest.mark.parametrize("case", ["crossing", "at_limit_unnamed",
                                  "above_limit_unnamed", "invalid_at_limit",
                                  "small_counts"])
def test_kernel_feature_rows_and_count_equal_plain(case):
    """The feature-row mode's algorithm: the count taken over every column
    of every tile equals ``saturate_counts(prev=)``'s count over the file
    (columns already at or above the limit that no valid lane names count
    0), and each lane's feature row is ``table_from_registers`` of its
    plain row, bit for bit (untouched columns, counts 0, 1 and 2, pad
    lanes)."""
    from repro_torch.netsim.features import table_from_registers
    rng = np.random.default_rng(11)
    n, w, sms, limit = 257, 96, 8, OVERFLOW_LIMIT
    regs = _regs(n, rng, occupied=0.5)
    cols = _window(w, n, rng)
    counts = [0, 1, 4, 5, 6, 7]
    if case == "crossing":
        regs[np.ix_(counts, [3, 40, 200])] = limit - 2.0
        cols[0][:12] = np.repeat([3, 40, 200], 4)
        cols[4][:12] = True
    elif case == "at_limit_unnamed":
        named = np.zeros(n, bool)
        named[cols[0][cols[4]]] = True
        regs[np.ix_(counts, np.flatnonzero(~named)[:20])] = limit
        regs[np.ix_(counts, [3])] = limit - 1.0
        cols[0][:2], cols[4][:2] = 3, True
    elif case == "above_limit_unnamed":
        named = np.zeros(n, bool)
        named[cols[0][cols[4]]] = True
        regs[np.ix_(counts, np.flatnonzero(~named)[:20])] = limit + 2.0
    elif case == "invalid_at_limit":
        regs[np.ix_(counts, [7])] = limit
        cols[0][:10], cols[4][:10] = 7, False
        cols[4][cols[0] == 7] = False
    else:                    # columns that end at counts 0, 1 and 2
        regs = _regs(n, rng, occupied=0.0)
        cols[0][:] = rng.integers(0, 8, w)
        cols[4][:] = False
        cols[4][[0, 1, 2]] = True
        cols[0][[0, 1, 2]] = [1, 2, 2]
        cols[0][3:] = np.where(cols[0][3:] < 3, 3, cols[0][3:])
    plain_regs, plain_rows = tops.stream_update(*_port(regs, cols),
                                                limit=limit)
    _, n_new = tstream.saturate_counts(
        tstream.update_flow_table(tstream.FlowTableState(_port(regs, cols)[0]),
                                  tstream.PacketWindow(*_port(regs, cols)[1:])),
        prev=tstream.FlowTableState(_port(regs, cols)[0]))
    got = _replay_kernel(regs, *cols, limit, rng.permutation(w), sms=sms)
    assert_bit_equal(plain_regs, got[0])
    assert got[3] == int(n_new)
    assert_bit_equal(table_from_registers(*plain_rows), got[4])
    if case == "crossing":
        assert got[3] > 0
    if case == "small_counts":
        assert sorted(set(got[4][:, 0].tolist())) == [0.0, 1.0, 2.0]


@pytest.mark.parametrize("n,sms,tile", [(8192, 132, 32), (600, 132, 32),
                                        (1, 132, 32), (1000, 8, 64),
                                        (8192, 8, 256), (1 << 20, 132, 256),
                                        (9000, 33, 256)])
def test_tile_columns(n, sms, tile):
    """B5's tile: N over twice the SM count, up to a power of two, within
    [MIN_TILE, MAX_TILE] (what the launcher takes)."""
    got = tsu.tile_columns(n, sms)
    assert got == tile
    assert got & (got - 1) == 0 and tsu.MIN_TILE <= got <= tsu.MAX_TILE


@pytest.mark.parametrize("case", ["outside", "ragged_tile", "empty_window",
                                  "wide_window", "above_limit", "neg_zero",
                                  "all_invalid"])
def test_tile_decomposition_equals_plain(case):
    """Every lane's row is written by exactly one tile, and the tiles'
    folds and per-tile settle give the plain version's bits: bucket ids
    -1, -N-5, N and N+9, N not a multiple of the tile, an empty window, a
    window wider than N, counts above the limit, -0.0 count registers on
    columns the window does not name, a window with no valid lane."""
    rng = np.random.default_rng(len(case))
    n, w, sms, limit = 257, 96, 132, None
    kw = {"outside": True}
    if case == "ragged_tile":
        n, sms = 1000, 8                                # tiles of 64
    elif case == "empty_window":
        w, limit = 0, 1000.0
    elif case == "wide_window":
        n, w = 40, 300
    regs = _regs(n, rng, occupied=0.5)
    cols = _window(w, n, rng, **kw)
    if case == "above_limit":
        limit = 1000.0
        regs[[0, 1, 4, 5, 6, 7], ::3] = 5000.0
    elif case == "neg_zero":
        limit = 1000.0
        named = np.zeros(n, bool)
        named[cols[0][(cols[0] >= 0) & (cols[0] < n)]] = True
        regs[np.ix_([0, 1, 4, 5, 6, 7], np.flatnonzero(~named))] = -0.0
    elif case == "all_invalid":
        cols = cols[:4] + (np.zeros(w, bool),)
    if case == "ragged_tile":
        assert n % tsu.tile_columns(n, sms)
    plain = tops.stream_update(*_port(regs, cols), limit=limit)
    got = _replay_kernel(regs, *cols, limit, rng.permutation(w), sms=sms)
    assert (got[2] == 1).all()
    assert_bit_equal(plain[0], got[0])
    assert_bit_equal(plain[1], got[1])
    if case == "neg_zero":
        assert not np.signbit(got[0][[0, 1, 4, 5, 6, 7]]).any()


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


SWEEP_CASES = ["random", "no_valid", "nan_ts", "at_cutoff", "all", "none"]


def _sweep_case(case, n=600, w=96):
    """A register file and a window for one timeout-sweep case: occupied
    columns last seen in [-20, 15] (one with a NaN t_max, which is never
    evicted, one at -0.0 counts), the window's timestamps in [10, 12] and
    an invalid lane holding NaN; then the case's change."""
    rng = np.random.default_rng(SWEEP_CASES.index(case))
    regs = _regs(n, rng, occupied=1.0 if case == "all" else 0.5)
    occ = np.flatnonzero(regs[0] > 0)
    regs[3, occ[0]] = np.nan
    regs[[0, 1, 4, 5, 6, 7], occ[1]] = -0.0
    ts = rng.uniform(10.0, 12.0, w).astype(np.float32)
    valid = rng.random(w) > 0.2
    valid[3] = False
    ts[3] = np.nan
    age = 5.0
    if case == "no_valid":
        valid[:] = False
    elif case == "nan_ts":
        valid[7], ts[7] = True, np.nan
    elif case == "all":
        regs[3, occ[0]] = 0.0
        ts = ts + np.float32(90.0)
    elif case == "none":
        ts = ts - np.float32(60.0)
    cut = np.float32(min(np.float32(ts[valid].max() - np.float32(age)),
                         ts[valid].min())) if valid.any() else None
    if case == "at_cutoff":
        regs[3, occ[2:40]] = cut                  # not before it: survive
        regs[3, occ[40:80]] = np.nextafter(cut, np.float32(-np.inf))
    return regs, ts, valid, age


@pytest.mark.parametrize("case", SWEEP_CASES)
def test_timeout_sweep_matches_reference(case):
    """The timeout sweep's plain version (the composition the CUDA entry
    does in one launch) against the reference's ``evict_cutoff`` then
    ``age_out``, bit for bit: the register file and the count. A window
    with no valid lane (cutoff -inf) and a NaN timestamp on a valid lane
    (cutoff NaN) evict nothing, a column last seen exactly at the cutoff
    survives, and a NaN t_max is never evicted."""
    regs, ts, valid, age = _sweep_case(case)
    fills = np.asarray(EVICT_FILLS, np.float32)
    jcut = jstream.evict_cutoff(jnp.asarray(ts), jnp.asarray(valid), age)
    jstate, jn = jstream.age_out(
        jstream.FlowTableState(*[jnp.asarray(r) for r in regs]), jcut)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    before = tev.LAUNCHES["evict_fill"]
    got, n_ev = tops.timeout_sweep(t(regs), t(ts), t(valid), age, t(fills))
    assert tev.LAUNCHES["evict_fill"] == before      # CPU: plain version
    assert n_ev.dtype == torch.int32 and n_ev.shape == ()
    assert_bit_equal(port_flow_table(jstate).regs, got)
    assert int(jn) == int(n_ev)
    cut = tev.evict_cutoff(t(ts), t(valid), age)
    assert_bit_equal(jcut, cut)
    swept, n_age = tstream.age_out(tstream.FlowTableState(t(regs)), cut)
    assert_bit_equal(swept.regs, got)
    assert int(n_age) == int(n_ev)
    n_occ = int((regs[0] > 0).sum())
    expect = {"no_valid": 0, "nan_ts": 0, "none": 0, "all": n_occ}
    if case in expect:
        assert int(n_ev) == expect[case]
    else:
        assert 0 < int(n_ev) < n_occ
    if case == "at_cutoff":
        assert bool(np.isfinite(float(cut)))
        assert (got.numpy()[0, np.flatnonzero(regs[3] == float(cut))] > 0).all()


@pytest.mark.parametrize("n,sms,fill,sweep", [
    (8192, 132, (64, 32), (256, 8)), (600, 132, (64, 3), (256, 1)),
    (8209, 132, (64, 33), (256, 9)), (1 << 20, 132, (256, 1024), (256, 264)),
    (1 << 16, 132, (128, 128), (256, 64)), (1, 8, (64, 1), (256, 1))])
def test_evict_plans(n, sms, fill, sweep):
    """B6's grids: evict_fill's quads over the SMs (blocks of 64-256
    threads), the sweep's blocks of 256 at most two an SM."""
    assert tuple(tev.fill_plan(n, sms).values()) == fill
    assert tuple(tev.sweep_plan(n, sms).values()) == sweep


def test_evict_fills_built_once_per_device():
    """The fills are built once per device and shared by every step."""
    a = tstream.evict_fills("cpu")
    assert a is tstream.evict_fills(torch.device("cpu"))
    assert_bit_equal(np.asarray(EVICT_FILLS, np.float32), a)
