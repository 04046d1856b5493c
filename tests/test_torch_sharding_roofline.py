"""The port's LM sharding rules, cell shapes, analytic model and roofline
helpers against the JAX package, the resharding restore, and the mesh
train step on one device.

Held to the reference wherever it has the function:
- ``param_specs`` / ``opt_state_specs`` leaf for leaf (same path strings)
  for every arch, on the 16 x 16 and 2 x 16 x 16 meshes, serve off and on;
  ``batch_specs`` (with and without ``seq_shard``) on every cell's batch
  and ``cache_specs`` on every arch's ``decode_32k`` cache, int8 or not;
- ``input_specs`` shapes and dtypes and ``cell_supported`` for every cell;
- the analytic FLOP and byte model ``==`` for every supported cell at 256
  and 512 chips, remat on and off;
- ``model_flops``, ``roofline_terms`` (each side with its own hardware
  table), ``collective_bytes_from_ops`` against ``collective_bytes_from_hlo``
  on HLO lines written for the same collectives, and ``render`` line for
  line apart from its header;
- the reference's own ``tests/test_sharding_roofline.py`` cases and
  ``tests/test_training.py::test_checkpoint_restore_with_sharding_tree``.

The mesh train step on a one-rank gloo group is bit-equal to ``mesh=None``
for every family's smoke config over two steps. Every test that starts a
default process group destroys it; the last test fails if one is left.
"""

import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_config
from repro.distributed import sharding as JS
from repro.launch import shapes as JSH
from repro.models import model as JM
from repro.roofline import analysis as JA
from repro.roofline import analytic as JAN
from repro.roofline import report as JR
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed import sharding as S
from repro_torch.launch import shapes as SH
from repro_torch.models import model as M
from repro_torch.roofline import analysis as A
from repro_torch.roofline import analytic as AN
from repro_torch.roofline import report as R
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optim import tree_flatten

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """Just enough of jax.sharding.Mesh for the spec rules (the reference
    tests' stand-in), which the port's rules take as well."""

    def __init__(self, shape):
        self.shape = shape

    @property
    def axis_names(self):
        return tuple(self.shape)


def _jax_specs(tree):
    """{path: tuple(spec)} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {JS._path_str(p): tuple(s) for p, s in flat}


def _port_specs(tree):
    return {"/".join(map(str, p)): tuple(s) for p, s in tree_flatten(tree)}


@pytest.fixture(scope="module")
def jax_shapes():
    """The reference's param shape trees (``eval_shape``), by arch."""
    return {a: JM.model_param_shapes(jax_config(a)) for a in ARCH_IDS}


# ---------------------------------------------------------------------------
# the spec rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh, serve, jax_shapes):
    fm = FakeMesh(MESHES[mesh])
    want = _jax_specs(JS.param_specs(jax_shapes[arch], fm, serve=serve))
    got = _port_specs(S.param_specs(M.model_param_shapes(get_config(arch)),
                                    fm, serve=serve))
    assert got == want
    if not serve:
        jo = _jax_specs(JS.opt_state_specs(jax_shapes[arch], fm))
        po = _port_specs(S.opt_state_specs(
            M.model_param_shapes(get_config(arch)), MESHES[mesh]))
        assert po == jo


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh):
    fm = FakeMesh(MESHES[mesh])
    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape in ("train_4k", "prefill_32k"):
        got_b = SH.input_specs(cfg, shape)["batch"]
        jb = JSH.input_specs(jcfg, shape)["batch"]
        for seq_shard in (False, True):
            assert _port_specs(S.batch_specs(fm, got_b,
                                             seq_shard=seq_shard)) == \
                _jax_specs(JS.batch_specs(fm, jb, seq_shard=seq_shard))
    b = SH.SHAPES["decode_32k"]["global_batch"]
    for int8 in (False, True):
        got_c = SH.input_specs(cfg, "decode_32k", int8_kv=int8)["caches"]
        jc = JSH.input_specs(jcfg, "decode_32k", int8_kv=int8)["caches"]
        assert _port_specs(S.cache_specs(fm, got_c, b)) == \
            _jax_specs(JS.cache_specs(fm, jc, b))


# the reference's tests/test_sharding_roofline.py cases, carried over
PARAM_CASES = [
    ("segments/0/ffn/gate", (7168, 2048), ("data", "model")),
    ("segments/0/ffn/gate", (7167, 2049), (None, None)),
    ("embed", (129280, 7168), ("model", "data")),
    ("segments/1/ffn/w_gate", (58, 256, 7168, 2048),
     (None, "model", "data", None)),
    ("final_norm/w", (7168,), ()),
]


@pytest.mark.parametrize("path, shape, want", PARAM_CASES)
def test_param_spec_rules(path, shape, want):
    for mesh in (FakeMesh({"data": 16, "model": 16}),
                 {"data": 16, "model": 16}):
        assert S.spec_for_param(path, shape, mesh) == S.P(*want)


def test_cache_spec_batch_by_size():
    mesh = FakeMesh({"data": 16, "model": 16})
    shapes = {"k": torch.Size((64, 128, 32768, 8, 128)),
              "h": torch.Size((128, 4096)),
              "pos": torch.Size((64, 32768))}
    specs = S.cache_specs(mesh, shapes, batch=128)
    assert specs["k"] == S.P(None, "data", "model", None, None)
    assert specs["h"] == S.P("data", "model")
    assert specs["pos"] == S.P(None, "model")


def test_cache_spec_batch_one_replicates_batch():
    mesh = FakeMesh({"data": 16, "model": 16})
    specs = S.cache_specs(mesh, {"C": torch.Size((1, 4, 1024, 1024))},
                          batch=1)
    assert specs["C"][0] is None            # batch not sharded


def test_placements_are_pod_major():
    """A tuple entry shards its dim over its axes in mesh order; an axis
    the mesh lacks is an error; a one-device mesh dim replicates."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

        def __init__(self, sizes):
            self.sizes = sizes

        def size(self, j):
            return self.sizes[j]

    spec = S.P(("pod", "data"), None, "model")
    dm = Mesh((2, 16, 16))
    assert S.placements(dm, spec) == (Shard(0), Shard(0), Shard(2))
    assert S.placements(dm, S.P()) == (Replicate(),) * 3
    # a mesh dim of one device splits nothing
    assert S.placements(Mesh((1, 16, 1)), spec) == (Replicate(), Shard(0),
                                                    Replicate())
    with pytest.raises(ValueError, match="expert"):
        S.placements(dm, S.P("expert"))


def test_hints_are_identity_on_plain_tensors():
    x = torch.randn(4, 6, 8, 2)
    for got in (S.shard_hint(x, "data", None, "model", None),
                S.hint_batch_heads(x), S.hint_batch(x), S.settle(x),
                S.replicate_dim(x, 0), S.gather_data({"w": x})["w"]):
        assert got is x
    w = torch.randn(2, 5)
    assert torch.equal(S.dense(x, w), x @ w)
    assert torch.equal(S.reshape(x, 4, 6, 16), x.reshape(4, 6, 16))
    assert torch.equal(S.per_shard(lambda a: a * 2, x), x * 2)


# ---------------------------------------------------------------------------
# cell shapes
# ---------------------------------------------------------------------------

_DT = {torch.int32: "int32", torch.float32: "float32",
       torch.bfloat16: "bfloat16", torch.int8: "int8"}


def _port_leaves(tree):
    return {"/".join(map(str, p)): (tuple(t.shape), _DT[t.dtype])
            for p, t in tree_flatten(tree)}


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {JS._path_str(p): (tuple(t.shape), str(t.dtype)) for p, t in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape in SH.SHAPES:
        assert SH.cell_supported(arch, shape) == \
            JSH.cell_supported(arch, shape)
        for int8 in ((False, True) if SH.SHAPES[shape]["kind"] == "decode"
                     else (False,)):
            got = SH.input_specs(cfg, shape, int8_kv=int8)
            assert all(t.device.type == "meta"
                       for _, t in tree_flatten(got))
            assert _port_leaves(got) == _jax_leaves(
                JSH.input_specs(jcfg, shape, int8_kv=int8))
    assert SH.SHAPES == JSH.SHAPES and SH.LONG_OK == JSH.LONG_OK


def test_input_specs_cells():
    cfg = get_config("qwen3-4b")
    assert SH.input_specs(cfg, "train_4k")["batch"]["tokens"].shape == \
        (256, 4096)
    assert SH.input_specs(cfg, "prefill_32k")["batch"]["tokens"].shape == \
        (32, 32768)
    assert SH.input_specs(cfg, "decode_32k")["token"].shape == (128,)
    assert not SH.cell_supported("qwen3-4b", "long_500k")
    assert SH.cell_supported("xlstm-1.3b", "long_500k")
    assert SH.cell_supported("recurrentgemma-2b", "long_500k")


def test_vlm_input_specs_include_patches():
    tr = SH.input_specs(get_config("phi-3-vision-4.2b"), "train_4k")
    assert tr["batch"]["patch_embeds"].shape == (256, 576, 1024)
    tr2 = SH.input_specs(get_config("whisper-base"), "train_4k")
    assert tr2["batch"]["frames"].shape == (256, 1500, 512)


# ---------------------------------------------------------------------------
# the analytic model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_model_equals_the_reference(arch, jax_shapes):
    cfg, jcfg = get_config(arch), jax_config(arch)
    n = M.count_params(M.model_param_shapes(cfg))
    assert n == JM.count_params(jax_shapes[arch])
    for shape, spec in SH.SHAPES.items():
        if not SH.cell_supported(arch, shape):
            continue
        b, s = spec["global_batch"], spec["seq_len"]
        assert AN.forward_flops(cfg, s, b) == JAN.forward_flops(jcfg, s, b)
        cache = {}
        if spec["kind"] == "decode":
            assert AN.forward_flops(cfg, s, b, kv_len=s, decode=True) == \
                JAN.forward_flops(jcfg, s, b, kv_len=s, decode=True)
            for int8 in (False, True):
                cache[int8] = AN.decode_cache_bytes(cfg, shape, int8_kv=int8)
                assert cache[int8] == JAN.decode_cache_bytes(
                    jcfg, shape, int8_kv=int8)
        for chips in (256, 512):
            for remat in (False, True):
                assert AN.cell_flops_per_device(cfg, shape, chips,
                                                remat=remat) == \
                    JAN.cell_flops_per_device(jcfg, shape, chips,
                                              remat=remat)
                for cb in cache.values() or [0]:
                    assert AN.cell_hbm_bytes_per_device(
                        cfg, shape, chips, n, cb, remat=remat) == \
                        JAN.cell_hbm_bytes_per_device(
                            jcfg, shape, chips, n, cb, remat=remat)


# ---------------------------------------------------------------------------
# roofline helpers
# ---------------------------------------------------------------------------

def _port_hw(jhw):
    return {"peak_flops": jhw["peak_flops"], "hbm_bw": jhw["hbm_bw"],
            "link_bw": jhw["ici_bw"]}


@pytest.mark.parametrize("seed", range(4))
def test_roofline_terms_and_model_flops_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    cost = {"flops": float(rng.uniform(1e9, 1e15)),
            "bytes accessed": float(rng.uniform(1e6, 1e12))}
    coll = {"total": float(rng.uniform(0, 1e11))}
    want = JA.roofline_terms(cost, coll)
    got = A.roofline_terms(cost, coll, hw=_port_hw(JA.HW))
    want["link_bytes_per_dev"] = want.pop("ici_bytes_per_dev")
    assert got == want
    # the port's own table: the H100's rates, the same arithmetic
    h = A.roofline_terms(cost, coll)
    assert h["compute_s"] == cost["flops"] / 67e12
    assert h["memory_s"] == cost["bytes accessed"] / 3.35e12
    assert h["collective_s"] == coll["total"] / 50e9

    class Cfg:
        moe = None
    n, act = int(rng.integers(1e6, 1e10)), int(rng.integers(1e6, 1e9))
    for kind in ("train", "prefill", "decode"):
        assert A.model_flops(Cfg, n, act, kind, 4096, 256) == \
            JA.model_flops(Cfg, n, act, kind, 4096, 256)


_HLO_DT = {"f32": 4, "bf16": 2, "s32": 4, "s8": 1, "pred": 1}
_HLO_OP = {"all-gather": "all-gather", "all-reduce": "all-reduce",
           "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
           "collective-permute": "collective-permute"}


def _hlo_line(i, op, results, g):
    """An HLO collective line: a result tuple of (dtype, shape), over one
    replica group of size ``g``."""
    res = ", ".join(f"{dt}[{','.join(map(str, sh))}]{{0}}"
                    for dt, sh in results)
    if len(results) > 1:
        res = f"({res})"
    groups = "{{" + ",".join(map(str, range(g))) + "}}"
    attr = (f"source_target_pairs={{{{0,1}}}}" if op == "collective-permute"
            else f"replica_groups={groups}")
    return f"  %c{i} = {res} {op}(%p{i}), {attr}"


@pytest.mark.parametrize("seed", range(3))
def test_collective_bytes_from_ops_equal_the_hlo_parse(seed):
    rng = np.random.default_rng(seed)
    lines, calls = [], []
    for i in range(40):
        op = list(_HLO_OP)[rng.integers(len(_HLO_OP))]
        g = int(rng.choice([1, 2, 4, 16]))
        results = [(list(_HLO_DT)[rng.integers(len(_HLO_DT))],
                    tuple(int(d) for d in rng.integers(1, 300, 2)))
                   for _ in range(int(rng.integers(1, 3)))]
        lines.append(_hlo_line(i, op, results, g))
        calls.append((op, sum(_HLO_DT[dt] * math.prod(sh)
                              for dt, sh in results), g))
    want = JA.collective_bytes_from_hlo("\n".join(lines))
    assert A.collective_bytes_from_ops(calls) == want


# the reference's tests/test_sharding_roofline.py HLO_SAMPLE
HLO_SAMPLE = """
  %ag = bf16[16,512,7168]{2,1,0} all-gather(%p0), channel_id=1, replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[1024]{0} all-reduce(%x), replica_groups=[32,16]<=[512], to_apply=%add
  %rs = f32[64,128]{1,0} reduce-scatter(%y), replica_groups={{0,1}}, dimensions={0}
  %cp = f32[8,8]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
  %ags = (bf16[4,4]{1,0}, bf16[4,4]{1,0}) all-gather-start(%q), replica_groups={{0,1,2,3}}
  %agd = bf16[4,4]{1,0} all-gather-done(%ags)
"""


def test_collective_parse_sample():
    """The reference's ``HLO_SAMPLE``, as the recorded collectives."""
    calls = [("all-gather", 16 * 512 * 7168 * 2, 4),
             ("all-reduce", 1024 * 4, 16),
             ("reduce-scatter", 64 * 128 * 4, 2),
             ("collective-permute", 8 * 8 * 4, 2),
             ("all-gather", 2 * 4 * 4 * 2, 4)]
    got = A.collective_bytes_from_ops(calls)
    assert got == JA.collective_bytes_from_hlo(HLO_SAMPLE)
    assert got["count"] == 5


def test_roofline_terms_dominant():
    hw = {"peak_flops": 197e12, "hbm_bw": 819e9, "link_bw": 50e9}
    r = A.roofline_terms({"flops": 197e12, "bytes accessed": 819e9 * 2},
                         {"total": 50e9 * 0.5}, hw=hw)
    assert abs(r["compute_s"] - 1.0) < 1e-9
    assert abs(r["memory_s"] - 2.0) < 1e-9
    assert abs(r["collective_s"] - 0.5) < 1e-9
    assert r["dominant"] == "memory_s"


def test_model_flops_kinds():
    class Cfg:
        moe = None
    n = 1_000_000
    assert A.model_flops(Cfg, n, n, "train", 128, 4) == 6 * n * 128 * 4
    assert A.model_flops(Cfg, n, n, "prefill", 128, 4) == 2 * n * 128 * 4
    assert A.model_flops(Cfg, n, n, "decode", 128, 4) == 2 * n * 4


def _records():
    recs = {}
    kinds = {"train_4k": "train", "prefill_32k": "prefill",
             "decode_32k": "decode"}
    for i, (shape, kind) in enumerate(kinds.items()):
        for dom in ("compute_s", "memory_s", "collective_s"):
            for mesh in ("16x16", "2x16x16"):
                roof = {"compute_s": 0.1 * (i + 1), "memory_s": 0.02 * i,
                        "collective_s": 3.3e-3, "dominant": dom,
                        "overlap_roofline_frac": 0.5}
                recs[f"a{i}{dom}__{shape}__{mesh}"] = {
                    "arch": f"a{i}{dom}", "shape": shape, "kind": kind,
                    "roofline": roof,
                    "memory": {"peak_per_device": (i + 1) * 7e8 * 10 ** i},
                    "useful_flops_ratio": 0.37 + 0.1 * i}
    recs["z__long_500k__16x16"] = {"arch": "z", "shape": "long_500k",
                                   "skipped": "full-attention arch"}
    return recs


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_render_equals_the_reference_but_its_header(mesh):
    got = R.render(_records(), mesh).splitlines()
    want = JR.render(_records(), mesh).splitlines()
    assert len(got) == len(want)
    assert got[1].startswith("### Roofline table") and "H100" in got[1]
    assert "67 TFLOP/s f32, 3350 GB/s HBM, 50 GB/s link" in got[1]
    assert got[:1] + got[2:] == want[:1] + want[2:]


def test_load_records_refreshes_with_the_ports_model(tmp_path):
    """``load_records`` recomputes the analytic terms with the port's model
    and ``HW``, and leaves a skipped record alone."""
    import json
    cfg = get_config("h2o-danube-1.8b")
    n = M.count_params(M.model_param_shapes(cfg))
    rec = {"arch": "h2o-danube-1.8b", "shape": "train_4k", "kind": "train",
           "chips": 256, "params_total": n, "remat": True,
           "collective_bytes_corrected": 5e10}
    (tmp_path / "a.json").write_text(json.dumps(rec))
    (tmp_path / "b.json").write_text(json.dumps({"skipped": "x"}))
    recs = R.load_records(str(tmp_path))
    fl = AN.cell_flops_per_device(cfg, "train_4k", 256)
    assert recs["a"]["analytic"]["flops_per_dev"] == fl
    assert recs["a"]["roofline"]["compute_s"] == fl / A.HW["peak_flops"]
    assert recs["a"]["roofline"]["collective_s"] == 5e10 / A.HW["link_bw"]
    assert recs["b"] == {"skipped": "x"}


# ---------------------------------------------------------------------------
# the resharding restore and the mesh train step on one device
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_mesh():
    """The (1, 1) host mesh on a one-rank gloo group, destroyed after."""
    from repro_torch.launch.mesh import make_host_mesh
    if dist.is_initialized():
        pytest.fail("a default process group is already running")
    mesh = make_host_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_checkpoint_restore_with_sharding_tree(tmp_path, one_rank_mesh):
    """Elastic path: restore onto explicit shardings (the reference's test,
    on a (1, 1) mesh)."""
    from torch.distributed.tensor import DTensor
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    sh = S.named_sharding_tree(one_rank_mesh, {"w": S.P("data", "model")})
    restored, _ = ckpt.restore_checkpoint(str(tmp_path), tree, shardings=sh)
    assert isinstance(restored["w"], DTensor)
    np.testing.assert_array_equal(restored["w"].full_tensor().numpy(),
                                  tree["w"].numpy())


def _smoke_batch(cfg, seed, b=2, s=12):
    rng = np.random.default_rng(seed)
    out = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                               .astype(np.int32))
           for k in ("tokens", "labels")}
    stub = (b, cfg.n_frontend_tokens, cfg.frontend_dim)
    if cfg.encdec:
        out["frames"] = torch.from_numpy(
            (0.1 * rng.standard_normal(stub)).astype(np.float32))
    if cfg.frontend == "image_patches":
        out["patch_embeds"] = torch.from_numpy(
            (0.1 * rng.standard_normal(stub)).astype(np.float32))
    return out


def test_mesh_train_step_on_one_device_is_bit_equal(one_rank_mesh):
    """Every family's smoke config: two steps through
    ``make_train_step(mesh=)`` on the (1, 1) mesh give the losses and
    params of ``mesh=None`` bit for bit; a DTensor checkpoint written from
    the mesh restores onto no mesh and onto the mesh, bit-equal."""
    from torch.distributed.tensor import DTensor
    from repro_torch.training.loop import TrainConfig, make_train_step
    from repro_torch.training.optim import (AdamWConfig, init_opt_state,
                                            tree_leaves)
    for i, arch in enumerate(ARCH_IDS):
        cfg = get_smoke_config(arch)
        tcfg = TrainConfig(seq_len=12, global_batch=2, opt=AdamWConfig(
            lr_peak=2e-3, warmup_steps=1))
        runs = []
        for mesh in (None, one_rank_mesh):
            params = M.init_model(cfg, i, device="cpu")
            state = init_opt_state(params)
            step = make_train_step(cfg, tcfg, mesh=mesh)
            losses = []
            for k in range(2):
                params, state, _, met = step(params, state, None,
                                             _smoke_batch(cfg, 10 * i + k))
                loss = met["loss_total"]
                losses.append(float(loss.full_tensor() if isinstance(
                    loss, DTensor) else loss))
            runs.append((losses, params, state))
        (l0, p0, _), (l1, p1, s1) = runs
        assert l0 == l1, arch
        assert all(isinstance(t, DTensor) for t in tree_leaves(p1))
        for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
            assert torch.equal(a.detach(), b.full_tensor().detach()), arch
    # the last family's step-2 state: saved from the mesh, restored both ways
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 2, (p1, s1))
        like = M.init_model(cfg, device="meta")
        like = (like, init_opt_state(like))
        plain, _ = ckpt.restore_checkpoint(d, like, device="cpu")
        shapes = M.model_param_shapes(cfg)
        sh = S.named_sharding_tree(one_rank_mesh, (
            S.param_specs(shapes, one_rank_mesh),
            S.opt_state_specs(shapes, one_rank_mesh)))
        placed, _ = ckpt.restore_checkpoint(d, like, shardings=sh)
        for a, b in zip(tree_leaves(plain), tree_leaves(placed)):
            assert torch.equal(a, b.full_tensor())


def test_no_default_group_is_left_running():
    """The file's last test: every test above that started a default
    process group destroyed it (a group left here would reach the next
    file this worker runs)."""
    assert not dist.is_initialized()
