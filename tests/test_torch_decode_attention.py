"""The plain int8-KV decode attention (B8's plain version) and ``_q8`` of the
PyTorch port against the JAX package: the dense oracle
``decode_attention_int8_ref`` and the Pallas kernel in interpret mode, on
the same numpy inputs.

Tolerance: rtol 2e-4 / atol 2e-5, the reference's own Pallas-against-oracle
tolerance (tests/test_decode_attention_kernel.py): the kernels' online
softmax sums over slot blocks in another order than a dense softmax, so no
bitwise contract exists, and the port's plain version is held to the same
bound against both. ``_q8`` is bit-equal to eager JAX.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import decode_attention_int8_ref as jax_ref
from repro.models.attention import _q8 as jax_q8
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops
from repro_torch.kernels.ref import decode_attention_int8_ref
from repro_torch.models.attention import _q8

jda = importlib.import_module("repro.kernels.decode_attention")

RTOL, ATOL = 2e-4, 2e-5


def _setup(b, s, g, m, hd, seed=0, n_valid=None):
    """numpy inputs as the reference's kernel test makes them."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, g, m, hd)).astype(np.float32)
    kf = rng.normal(0, 2, (b, s, g, hd)).astype(np.float32)
    vf = rng.normal(0, 2, (b, s, g, hd)).astype(np.float32)
    ks = (np.max(np.abs(kf), axis=-1, keepdims=True) / 127.0 + 1e-8)
    vs = (np.max(np.abs(vf), axis=-1, keepdims=True) / 127.0 + 1e-8)
    kq = np.round(kf / ks).astype(np.int8)
    vq = np.round(vf / vs).astype(np.int8)
    n_valid = n_valid if n_valid is not None else s
    valid = (np.arange(s)[None, :] < n_valid).astype(np.float32)
    valid = np.broadcast_to(valid, (b, s)).copy()
    return (q, kq, ks.astype(np.float32), vq, vs.astype(np.float32), valid)


def _port(args, scale):
    return decode_attention_int8_ref(*map(torch.from_numpy, args),
                                     scale=scale).numpy()


def _oracle(args, scale, which):
    jargs = [jnp.asarray(a) for a in args]
    if which == "ref":
        return np.asarray(jax_ref(*jargs, scale=scale))
    return np.asarray(jda.decode_attention_int8_pallas(*jargs, scale=scale,
                                                        interpret=True))


@pytest.mark.parametrize("which", ["ref", "pallas"])
@pytest.mark.parametrize("b,s,g,m,hd", [
    (2, 64, 2, 4, 32), (1, 700, 1, 8, 64), (2, 1024, 4, 2, 16),
    (2, 300, 1, 10, 256),           # recurrentgemma's local attention
])
def test_plain_matches_jax(b, s, g, m, hd, which):
    args = _setup(b, s, g, m, hd)
    scale = 1.0 / np.sqrt(hd)
    np.testing.assert_allclose(_port(args, scale), _oracle(args, scale, which),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["ref", "pallas"])
@pytest.mark.parametrize("n_valid", [40, 0])
def test_plain_masks_like_jax(n_valid, which):
    """A ring with dead slots, and every slot dead (the uniform mean of V
    over all S slots, in both packages)."""
    args = _setup(2, 128, 2, 4, 32, n_valid=n_valid)
    scale = 1.0 / np.sqrt(32)
    out = _port(args, scale)
    np.testing.assert_allclose(out, _oracle(args, scale, which),
                               rtol=RTOL, atol=ATOL)
    if n_valid == 0:
        q, kq, ks, vq, vs, valid = args
        mean_v = (vq.astype(np.float32) * vs).mean(axis=1)    # (B, G, hd)
        np.testing.assert_allclose(
            out, np.broadcast_to(mean_v[:, :, None], out.shape),
            rtol=RTOL, atol=ATOL)


def test_plain_ignores_dead_slots():
    """Changing a dead slot's K/V leaves the output as it was, bit for bit."""
    args = _setup(2, 128, 2, 4, 32, n_valid=40)
    scale = 1.0 / np.sqrt(32)
    out = _port(args, scale)
    kq2 = args[1].copy()
    kq2[:, 100] = 127
    out2 = _port((args[0], kq2) + args[2:], scale)
    np.testing.assert_array_equal(out, out2)


def test_ops_routes_cpu_to_plain():
    """A CPU tensor takes the plain version and counts no launch."""
    args = [torch.from_numpy(a) for a in _setup(2, 64, 2, 4, 32)]
    before = dict(tda.LAUNCHES)
    out = ops.decode_attention_int8(*args, scale=0.25)
    assert tda.LAUNCHES == before
    assert torch.equal(out, decode_attention_int8_ref(*args, scale=0.25))


def test_kernel_operand_checks():
    """What the kernel would refuse, the wrapper refuses first (checked
    here without a card: the checks are plain Python)."""
    q, kq, ks, vq, vs, valid = [torch.from_numpy(a)
                                for a in _setup(2, 64, 2, 4, 32)]
    tda.check_operands(q, kq, ks, vq, vs, valid)
    tda.check_operands(q, kq, ks, vq, vs, valid[:1].expand(2, 64))
    with pytest.raises(TypeError):
        tda.check_operands(q.double(), kq, ks, vq, vs, valid)
    with pytest.raises(TypeError):
        tda.check_operands(q, kq.to(torch.int16), ks, vq, vs, valid)
    with pytest.raises(ValueError):
        tda.check_operands(q, kq[:, :32], ks, vq, vs, valid)
    with pytest.raises(ValueError):          # M = 0
        tda.check_operands(torch.zeros(2, 2, 0, 32), kq, ks, vq, vs, valid)
    for m in (9, 10, 16, 33):                # any M: groups of at most 8
        tda.check_operands(torch.zeros(2, 2, m, 32), kq, ks, vq, vs, valid)
    big = [a[:1].expand((40000,) + tuple(a.shape[1:]))
           for a in (kq, ks, vq, vs, valid)]
    tda.check_operands(torch.zeros(40000, 2, 8, 32), *big)
    with pytest.raises(ValueError):          # B x query groups past the grid
        tda.check_operands(torch.zeros(40000, 2, 9, 32), *big)
    tda.check_operands(torch.zeros(2, 2, 4, 24), kq[..., :24].contiguous(),
                       ks, vq[..., :24].contiguous(), vs, valid)
    with pytest.raises(ValueError):          # head dim 20: not a multiple of 8
        tda.check_operands(torch.zeros(2, 2, 4, 20), kq[..., :20],
                           ks, vq[..., :20], vs, valid)
    with pytest.raises(ValueError):          # head dim 264 > 256
        tda.check_operands(torch.zeros(2, 2, 4, 264), *_wide(kq, ks, vq, vs,
                                                             264), valid)
    with pytest.raises(ValueError):          # head dim not contiguous
        tda.check_operands(q, kq.transpose(1, 3).contiguous().transpose(1, 3),
                           ks, vq, vs, valid)


def _wide(kq, ks, vq, vs, hd):
    """The cache operands with the head dim widened to ``hd``."""
    pad = torch.zeros(*kq.shape[:3], hd, dtype=torch.int8)
    return pad, ks, pad.clone(), vs


@pytest.mark.parametrize("arch", ["qwen3-4b", "yi-6b", "qwen2.5-32b",
                                  "h2o-danube-1.8b", "arctic-480b",
                                  "phi-3-vision-4.2b", "recurrentgemma-2b"])
def test_kernel_takes_every_served_config(arch):
    """Each GQA config of the registry, at its published width, gives the
    kernel operands it takes: its head dim (80 for h2o-danube, 96 for
    phi-3, 256 for recurrentgemma) and its query heads per kv head (10 for
    recurrentgemma's local attention)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    g, hd = cfg.n_kv_heads, cfg.head_dim
    m = cfg.n_heads // g
    kq = torch.zeros(1, 3, g, hd, dtype=torch.int8)
    sc = torch.ones(1, 3, g, 1)
    tda.check_operands(torch.zeros(1, g, m, hd), kq, sc, kq.clone(), sc,
                       torch.ones(3)[None])


@pytest.mark.parametrize("kind", ["normal", "zero_rows", "wide"])
def test_q8_bit_equal_to_eager_jax(kind):
    """The port's _q8 divides by 127 and by the scale as eager JAX does:
    codes and scales bit-equal."""
    rng = np.random.default_rng(1)
    v = rng.normal(0, 3, (4, 9, 2, 16)).astype(np.float32)
    if kind == "zero_rows":
        v[:, ::3] = 0.0
    elif kind == "wide":
        v *= np.exp(rng.normal(0, 4, (4, 9, 2, 1))).astype(np.float32)
    q_j, s_j = jax_q8(jnp.asarray(v))
    q_t, s_t = _q8(torch.from_numpy(v))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_q8_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(0, 3, (4, 8, 2, 16)).astype(np.float32))
    q, s = _q8(v)
    err = (q.to(torch.float32) * s - v).abs().amax(dim=-1)
    bound = v.abs().amax(dim=-1) / 127.0
    assert bool(torch.all(err <= bound * 1.001))


def _split_merge(args, scale, chunk):
    """B8's two passes in numpy, float32: per chunk of ``chunk`` slots an
    online softmax state (max m, sum l, acc[hd]) with dead slots at -1e30
    (the last chunk ragged, no slot past S), then the combine over chunks:
    weights exp(m_c - max_c m_c), out = sum w acc / max(sum w l, 1e-30)."""
    q, kq, ks, vq, vs, valid = args
    s = kq.shape[1]
    k = kq.astype(np.float32) * ks                    # (B, S, G, hd)
    v = vq.astype(np.float32) * vs
    ms, ls, accs = [], [], []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(s, c0 + chunk))
        sc = np.einsum("bgmd,bsgd->bgms", q, k[:, sl]) * np.float32(scale)
        sc = np.where(valid[:, None, None, sl] > 0.5, sc, np.float32(-1e30))
        m = sc.max(axis=-1)                            # (B, G, M)
        p = np.exp(sc - m[..., None])
        ms.append(m)
        ls.append(p.sum(axis=-1))
        accs.append(np.einsum("bgms,bsgd->bgmd", p, v[:, sl]))
    m_all = np.stack(ms)                               # (n_split, B, G, M)
    w = np.exp(m_all - m_all.max(axis=0))
    den = (w * np.stack(ls)).sum(axis=0)
    num = (w[..., None] * np.stack(accs)).sum(axis=0)
    return (num / np.maximum(den, np.float32(1e-30))[..., None]).astype(
        np.float32)


@pytest.mark.parametrize("which", ["port", "ref", "pallas"])
@pytest.mark.parametrize("case", ["all_dead", "dead_chunk", "ragged_last"])
def test_split_merge_matches_dense(case, which):
    """The split-S algebra the card's kernel keeps (per-chunk softmax
    states, then a combine): every slot dead (each chunk at m = -1e30, the
    merge gives the uniform mean of V), one chunk entirely dead beside live
    ones (it weighs exp(-1e30 - m_live) = 0), and a ragged last chunk. It
    agrees with the port's plain version and the JAX package's oracle and
    Pallas kernel within rtol 2e-4 / atol 2e-5."""
    b, s, g, m, hd, chunk = 2, 300, 2, 4, 32, 64
    if case == "ragged_last":
        s = 301                                        # last chunk: 45 slots
    args = _setup(b, s, g, m, hd, seed=5)
    valid = args[5]
    if case == "all_dead":
        valid[:] = 0.0
    elif case == "dead_chunk":
        valid[:, chunk:2 * chunk] = 0.0
        valid[1, :chunk] = 0.0                         # row 1: two dead chunks
    scale = 1.0 / np.sqrt(hd)
    got = _split_merge(args, scale, chunk)
    want = (_port(args, scale) if which == "port"
            else _oracle(args, scale, which))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if case == "all_dead":
        mean_v = (args[3].astype(np.float32) * args[4]).mean(axis=1)
        np.testing.assert_allclose(
            got, np.broadcast_to(mean_v[:, :, None], got.shape),
            rtol=RTOL, atol=ATOL)


# the served shapes (qwen3-4b, h2o-danube, recurrentgemma, arctic, phi-3),
# ragged S, hd 72 (zero-padded to the MMA's depth), M past 8
PLAN_SHAPES = [(8, 32768, 8, 4, 128), (8, 4096, 8, 4, 80), (2, 1, 2, 4, 128),
               (2, 1000, 2, 8, 80), (1, 64, 64, 8, 256), (8, 2048, 1, 10, 256),
               (8, 2048, 8, 7, 128), (8, 2048, 32, 1, 96), (2, 700, 2, 3, 72),
               (2, 3001, 3, 5, 8)] + [(2, 1000, 2, m, 64)
                                      for m in range(9, 17)]


@pytest.mark.parametrize("b,s,g,m,hd", PLAN_SHAPES)
def test_launch_plan_covers_every_slot(b, s, g, m, hd):
    """The split the wrapper asks for: chunks of whole sweeps (a CTA's 8 /
    hpc phases of 16-slot tiles, at least MIN_TILES a warp) that cover S
    with none empty, every kv head in one CTA's group of hpc (a power of
    two up to 8), every query head in one group of at most 8 (groups as
    equal as may be), 16-byte copies only where 16 divides hd, a ring of
    two stages or more within the CTA's 227 KB, and at the served shape a
    grid within one (batch row, head group) of WAVES waves of an H100's 132
    SMs."""
    plan = tda.launch_plan(b, s, g, m, hd, wide=True, sms=132)
    chunk, n_split, hpc = plan["chunk"], plan["n_split"], plan["hpc"]
    assert (n_split - 1) * chunk < s <= n_split * chunk
    assert hpc in (1, 2, 4, 8) and hpc <= g and (hpc == 8 or 2 * hpc > g)
    sweep = tda.WARPS // hpc * tda.TILE
    assert chunk % sweep == 0 and chunk >= tda.MIN_TILES * sweep
    mg, groups = plan["m_group"], plan["m_groups"]
    assert 1 <= mg <= tda.GROUP_M and (groups - 1) * mg < m <= groups * mg
    assert groups == -(-m // tda.GROUP_M)
    assert plan["vec"] == (16 if hd % 16 == 0 else 8)
    assert plan["grid"] == (n_split, -(-g // hpc), b * groups)
    assert plan["threads"] == 32 * tda.WARPS
    assert 2 <= plan["stages"] <= 4
    # the static shared arrays (1 KB) beside the dynamic, within 227 KB
    assert plan["smem"] <= tda.CTA_SMEM and plan["smem"] + 1024 <= 232448
    assert 16 * plan["nk"] >= hd and plan["row_bytes"] >= 16 * plan["nk"]
    assert plan["row_bytes"] == 32 * plan["nv"] >= hd
    if (b, s) == (8, 32768):
        units = plan["grid"][1] * plan["grid"][2]
        assert 132 - units < n_split * units <= 132 * tda.WAVES
    narrow = tda.launch_plan(b, s, g, m, hd, wide=False, sms=132)
    assert narrow["vec"] == 8 and narrow["chunk"] == chunk


@pytest.mark.parametrize("b,s,g,m,hd", PLAN_SHAPES[:10])
def test_launch_plan_tiles_cover_every_slot_once(b, s, g, m, hd):
    """The CTA of chunk c walks slots [c * chunk, min(S, (c + 1) * chunk)),
    the warp of phase p of each of its kv heads the tiles p, p + 8 / hpc,
    ... of 16 slots (a tile's slots past the chunk are zero-filled and
    score -inf): for each kv head every slot of S falls in exactly one
    warp's tile, and no warp runs past its chunk's tiles."""
    plan = tda.launch_plan(b, s, g, m, hd, wide=True, sms=132)
    chunk, hpc = plan["chunk"], plan["hpc"]
    phases = tda.WARPS // hpc
    seen = np.zeros((plan["grid"][1] * hpc, s), np.int32)
    for c in range(plan["n_split"]):
        c0, c1 = c * chunk, min(s, (c + 1) * chunk)
        n_tiles = -(-(c1 - c0) // tda.TILE)
        for y in range(plan["grid"][1]):
            for w in range(tda.WARPS):
                head, phase = y * hpc + w % hpc, w // hpc
                mine = max(0, -(-(n_tiles - phase) // phases))
                for it in range(mine):
                    s0 = c0 + tda.TILE * (phase + phases * it)
                    assert s0 < c1
                    seen[head, s0:min(c1, s0 + tda.TILE)] += 1
    assert (seen[:g] == 1).all()


@pytest.mark.parametrize("hd", [8, 16, 72, 80, 96, 128, 200, 256])
def test_ring_reads_hit_distinct_banks(hd):
    """The fragment reads from a warp's ring: at q.k step i lane (g, t)
    reads the 4-byte word at byte 16 i + 4 t of slot rows g and 8 + g; at
    p.v word i lane (g, t) reads byte 4 (g + 8 i) of slot rows 2 t, 2 t +
    1, 2 t + 8, 2 t + 9. With the row stride odd in 16-byte units, each
    read's 32 lanes hit 32 distinct banks; the ring holds two to four
    stages within the CTA's budget, and the merge fits in it."""
    ring = tda.ring_geometry(hd)
    stride = ring["stride"]
    assert (stride // 16) % 2 == 1 and stride % 16 == 0
    assert 2 <= ring["stages"] <= 4 and ring["smem"] <= tda.CTA_SMEM
    assert tda.WARPS * 8 * (ring["row_bytes"] + 2) * 4 <= \
        tda.WARPS * ring["stages"] * ring["stage_bytes"]
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for i in range(ring["nk"]):
        for row in (0, 8):
            banks = {((row + g) * stride + 16 * i + 4 * t) // 4 % 32
                     for g, t in lanes}
            assert len(banks) == 32
    for i in range(ring["nv"]):
        for extra in (0, 1, 8, 9):
            banks = {((2 * t + extra) * stride + 4 * (g + 8 * i)) // 4 % 32
                     for g, t in lanes}
            assert len(banks) == 32


# -- the kernel's split-term arithmetic, emulated ------------------------------

def _split16(x, terms=2):
    """x (f32) as two f16 terms rounded to nearest (hi = f16(x), lo =
    f16(x - hi)), returned in f32; one term drops lo."""
    hi = x.to(torch.float16).to(torch.float32)
    lo = (x - hi).to(torch.float16).to(torch.float32)
    return hi, lo * (terms == 2)


def _emulate(args, scale, terms=2):
    """B8's arithmetic on the CPU: q scaled per head by 2^e (max |q| 2^e in
    [2^14, 2^15)), split into f16 terms, each term's products with the int8
    codes (exact in f16) summed in f32; scores q.k * 2^-e * k_s * scale, -1e30
    where dead; the weights p * v_s scaled by 2^(14 - cap) with v_s below
    2^cap, split the same way, their products with V's codes summed in f32,
    the scale taken back out, divided by max(l, 1e-30)."""
    q, kq, ks, vq, vs, valid = (torch.from_numpy(np.ascontiguousarray(a))
                                for a in args)
    amax = q.abs().amax(-1)                                    # (B, G, M)
    fin = torch.isfinite(amax) & (amax > 0)
    e = torch.where(fin, (14 - (torch.frexp(amax).exponent - 1)).clamp(
        -126, 126), 0).to(torch.float32)
    hi, lo = _split16(q * torch.exp2(e)[..., None], terms)
    kf = kq.to(torch.float32)
    dot = (torch.einsum("bgmd,bsgd->bgms", hi, kf)
           + torch.einsum("bgmd,bsgd->bgms", lo, kf))
    sc = (dot * torch.exp2(-e)[..., None]
          * ks[..., 0].permute(0, 2, 1)[:, :, None, :] * np.float32(scale))
    sc = torch.where(valid[:, None, None, :] > 0.5, sc, -1e30)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    den = p.sum(-1).clamp_min(1e-30)
    vmax = vs[..., 0].abs().amax(1)                            # (B, G)
    cap = (torch.frexp(vmax).exponent).clamp(-100, 110).to(torch.float32)
    w = p * (vs[..., 0].permute(0, 2, 1)[:, :, None, :]
             * torch.exp2(14 - cap)[:, :, None, None])
    whi, wlo = _split16(w, terms)
    vf = vq.to(torch.float32)
    num = (torch.einsum("bgms,bsgd->bgmd", whi, vf)
           + torch.einsum("bgms,bsgd->bgmd", wlo, vf))
    return (num * torch.exp2(cap - 14)[:, :, None, None]
            / den[..., None]).numpy()


def _hard(case, m, hd, seed):
    """B=2, S=300, G=2 inputs: large scores (q x 3; past x 4 the f32 plain
    version and the JAX oracle part at hd=256 themselves), one dominant
    slot (its K the sign of q at full scale), every slot dead, or a ring
    with holes."""
    b, s, g = 2, 300, 2
    args = list(_setup(b, s, g, m, hd, seed=seed))
    if case == "large":
        args[0] = args[0] * np.float32(3.0)
    elif case == "dominant":
        args[1][:, 77] = (np.sign(args[0][:, :, 0]) * 127).astype(np.int8)
    elif case == "all_dead":
        args[5][:] = 0.0
    elif case == "part_dead":
        args[5][:, 150:] = 0.0
        args[5][0, ::3] = 0.0
    return tuple(args)


# M from 1 to 10 against hd in {72, 80, 96, 128, 256}
M_HD = [(1, 72), (2, 80), (3, 96), (4, 128), (5, 256), (6, 72), (7, 80),
        (8, 96), (9, 128), (10, 256)]


@pytest.mark.parametrize("m,hd", M_HD)
@pytest.mark.parametrize("case", ["large", "dominant", "all_dead",
                                  "part_dead"])
def test_split_terms_match_plain_and_jax(case, m, hd):
    """Two f16 terms a side keep B8 within rtol 2e-4 / atol 2e-5 of the
    port's plain version and of the JAX package's oracle on hard inputs."""
    args = _hard(case, m, hd, seed=m * 1000 + hd)
    scale = 1.0 / np.sqrt(hd)
    got = _emulate(args, scale)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _port(args, scale), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _oracle(args, scale, "ref"), rtol=RTOL,
                               atol=ATOL)


def test_one_f16_term_misses_the_tolerance():
    """The same arithmetic with a single f16 term a side (lo dropped) falls
    outside rtol 2e-4 / atol 2e-5 on large scores: the split is needed, and
    the emulation above can fail."""
    args = _hard("large", 4, 128, seed=4128)
    scale = 1.0 / np.sqrt(128)
    want = _port(args, scale)
    one = _emulate(args, scale, terms=1)
    excess = np.abs(one - want) - (ATOL + RTOL * np.abs(want))
    assert excess.max() > 0
    two = _emulate(args, scale, terms=2)
    assert (np.abs(two - want) <= ATOL + RTOL * np.abs(want)).all()
