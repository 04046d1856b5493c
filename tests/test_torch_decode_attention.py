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
    with pytest.raises(ValueError):          # M = 9 > 8
        tda.check_operands(torch.zeros(2, 2, 9, 32), kq, ks, vq, vs, valid)
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
                                  "h2o-danube-1.8b"])
def test_kernel_takes_every_served_config(arch):
    """Each dense GQA config of the slice, at its published width, gives
    the kernel operands it takes: its head dim (80 for h2o-danube) and its
    query heads per kv head."""
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


@pytest.mark.parametrize("b,s,g,m,hd", [(8, 32768, 8, 4, 128),
                                        (8, 4096, 8, 4, 80),
                                        (2, 1, 2, 4, 128),
                                        (2, 1000, 2, 8, 80),
                                        (1, 64, 64, 8, 256)])
def test_launch_plan_covers_every_slot(b, s, g, m, hd):
    """The split the wrapper asks for: chunks of whole sweeps that cover S
    with none empty, every head in some CTA, 16-byte loads only for M <= 4,
    and at the served shape a grid of at least two CTAs per SM of an H100
    (132 SMs)."""
    plan = tda.launch_plan(b, s, g, m, hd, wide=True, sms=132)
    chunk, n_split = plan["chunk"], plan["n_split"]
    assert (n_split - 1) * chunk < s <= n_split * chunk
    assert chunk % (plan["rows"] * tda.SLOTS_PER_STAGE) == 0
    assert plan["kd"] == (16 if m <= tda.WIDE_MAX_M else 8)
    lanes = plan["lanes_per_head"]
    assert lanes >= hd // plan["kd"] and lanes & (lanes - 1) == 0
    hgroups = plan["grid"][1]
    assert plan["heads_per_cta"] * hgroups >= g
    assert plan["rows"] * plan["heads_per_cta"] * lanes <= tda.THREADS
    assert plan["grid"] == (n_split, hgroups, b)
    if (b, s) == (8, 32768):
        assert n_split * hgroups * b >= 2 * 132
    narrow = tda.launch_plan(b, s, g, m, hd, wide=False, sms=132)
    assert narrow["kd"] == 8
