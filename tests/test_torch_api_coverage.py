"""The port covers ``repro``'s public API, name by name and keyword by
keyword, but for an explicit table of departures.

For each module file under ``src/repro/`` (one case each), read with
``ast`` (nothing is imported): every public function and method (a name
without a leading ``_``, plus ``__init__``; methods of classes defined
anywhere in the module, nested ones too) must have a counterpart of the
same name in the matching module under ``src/repro_torch/``, and the
counterpart must accept every keyword of the reference's signature. A def
counts, and so does an alias at module or class level (``as_arrays =
as_tensors``), checked through the def it names. A counterpart with
``**kwargs`` accepts any keyword.

The departures below are exempt, each with its reason (ROADMAP C3 lists
the same). The table is exact: an entry that no longer departs (the port
gained the name, or the reference lost it) fails its module's case.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "src", "repro")
PORT = os.path.join(REPO, "src", "repro_torch")

# module files with no counterpart of the same path
MODULES = {
    "analysis/jaxpr_utils.py":
        "replaced by analysis/dispatch_utils.py: the hot-path audit records "
        "aten ops under a TorchDispatchMode, where the reference reads "
        "jaxprs and compiled HLO",
}

# (module, public name) with no counterpart
NAMES = {
    ("analysis/lint.py", "Visitor.visit_Call"):
        "the host-sync rule visits every node of a captured body "
        "(_walk_captured's generic_visit), not each call of a jitted one",
    ("core/artifact.py", "default_lane"):
        "TPU lanes: the port's tables are not padded to 128 lanes",
    ("kernels/ops.py", "fits_vmem"): "TPU VMEM budget",
    ("kernels/ops.py", "tree_tables_vmem_bytes"): "TPU VMEM budget",
    ("kernels/tuning.py", "resolve_interpret"):
        "Pallas interpret mode: a wrapper takes its plain version on a CPU "
        "tensor",
    ("distributed/sharding.py", "flow_table_sharding"):
        "the per-rank sharded tier: each rank holds only its own register "
        "block, so no global array is laid out",
    ("netsim/shard_stream.py", "ShardedFlowTable.n_shards"):
        "the per-rank sharded tier: a rank's table is its one shard",
    ("netsim/stream.py", "evict_cutoff"): "moved to kernels/evict.py",
    ("roofline/analysis.py", "collective_bytes_from_hlo"):
        "no HLO: StepRecorder counts the collectives below DTensor's "
        "dispatch",
}
PALLAS_REASON = ("a Pallas entry point: the port's CUDA wrapper has its own "
                 "name in the same module")

# keywords no port function takes
KEYWORDS = {
    "use_pallas": "the kernel route follows the tensor's device",
    "interpret": "Pallas interpret mode: a CPU tensor takes the plain version",
    "edge_chunk": "a Pallas VMEM tiling knob",
    "dtable_chunk": "a Pallas VMEM tiling knob",
}

KEY_REASON = ("RNG: a jax.random key is replaced by an explicit "
              "torch.Generator (gen / generator)")
SHARD_REASON = ("the per-rank sharded tier: one process per device holds its "
                "own shard")
# (module, function, keyword) a counterpart does not take
SIGNATURES = {
    **{(mod, fn, "key"): KEY_REASON for mod, fn in (
        ("models/attention.py", "gqa_params"),
        ("models/attention.py", "mla_params"),
        ("models/attention.py", "cross_attn_params"),
        ("models/layers.py", "dense_init"),
        ("models/layers.py", "swiglu_params"),
        ("models/layers.py", "gelu_mlp_params"),
        ("models/model.py", "init_model"),
        ("models/moe.py", "moe_params"),
        ("models/recurrent.py", "conv1d_params"),
        ("models/recurrent.py", "rglru_params"),
        ("models/recurrent.py", "mlstm_params"),
        ("models/recurrent.py", "slstm_params"),
        ("models/transformer.py", "init_params"),
        ("models/whisper.py", "init_params"),
        ("serving/engine.py", "greedy_generate"))},
    ("serving/hybrid_serving.py", "HybridServer.__init__", "donate"):
        "no donation: the server's tables and carries are written in place",
    ("core/hybrid.py", "init_deferred", "n_shards"):
        SHARD_REASON + ", so the buffer has no shard dim",
    ("netsim/shard_stream.py", "localize_window", "shard_idx"):
        SHARD_REASON + ": its index is the int `shard`",
    ("netsim/shard_stream.py", "shard_window_update", "regs"):
        SHARD_REASON + ": its block is `state`",
    ("netsim/shard_stream.py", "shard_window_update", "shard_idx"):
        SHARD_REASON + ": its index is the int `shard`",
    ("netsim/shard_stream.py", "shard_window_update", "readout"):
        SHARD_REASON + ": the readout is always returned",
    ("netsim/shard_stream.py", "scatter_lane_slab", "n_shards"):
        SHARD_REASON + ": the mesh gives the counts",
    ("netsim/shard_stream.py", "scatter_lane_slab", "n_data"):
        SHARD_REASON + ": the mesh gives the counts",
    ("ml/trees.py", "fit_random_forest", "tree_chunk"):
        "the port fits tree by tree (ml/trees.py), not in vmapped chunks",
    ("ml/svm.py", "fit_linear_svm", "seed"):
        "the reference passes a key that _fit_binary never reads",
}


def _signature(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names, a.kwarg is not None


def _api(path):
    """{name: (keywords, takes **kwargs)} or {name: ("alias", target)} for
    a module's top-level defs and aliases and every class's methods and
    class-level aliases (``Class.name``)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}

    def alias(node, prefix):
        for target in node.targets:
            if isinstance(target, ast.Name) and isinstance(node.value,
                                                           ast.Name):
                out.setdefault(prefix + target.id,
                               ("alias", prefix + node.value.id))

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _signature(node)
        elif isinstance(node, ast.Assign):
            alias(node, "")
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = _signature(sub)
                elif isinstance(sub, ast.Assign):
                    alias(sub, node.name + ".")
    return out


def _public(name):
    parts = name.split(".")
    return (not any(p.startswith("_") for p in parts[:-1])
            and (not parts[-1].startswith("_") or parts[-1] == "__init__"))


def _resolve(api, entry):
    seen = set()
    while entry[0] == "alias" and entry[1] not in seen:
        seen.add(entry[1])
        entry = api.get(entry[1], ([], True))
    return entry


def _gaps(rel):
    """The module's departures from the reference, as table keys: (rel,
    name) for a missing name, (rel, name, keyword) for a keyword the
    counterpart does not take."""
    ref = _api(os.path.join(REF, rel))
    port = _api(os.path.join(PORT, rel))
    gaps = set()
    for name, entry in ref.items():
        if not _public(name):
            continue
        if name not in port:
            gaps.add((rel, name))
            continue
        if entry[0] == "alias":
            continue
        names, _ = entry
        got, any_kw = _resolve(port, port[name])
        if any_kw:
            continue
        for kw in names:
            if kw not in ("self", "cls") and kw not in got:
                gaps.add((rel, name, kw))
    return gaps


def _exempt(gap):
    if len(gap) == 2:
        return gap in NAMES or "_pallas" in gap[1]
    return gap[2] in KEYWORDS or gap in SIGNATURES


REF_MODULES = sorted(
    os.path.relpath(os.path.join(root, f), REF).replace(os.sep, "/")
    for root, _, files in os.walk(REF) for f in files if f.endswith(".py"))


def test_the_module_list_is_the_references():
    assert len(REF_MODULES) > 80
    assert set(MODULES) <= set(REF_MODULES)


@pytest.mark.parametrize("rel", REF_MODULES)
def test_port_covers_the_reference_module(rel):
    if rel in MODULES:
        assert not os.path.exists(os.path.join(PORT, rel)), (
            f"{rel} now has a port: take it out of MODULES")
        return
    assert os.path.exists(os.path.join(PORT, rel)), f"no port of {rel}"
    gaps = _gaps(rel)
    missing = sorted(g for g in gaps if not _exempt(g))
    assert not missing, f"the port lacks: {missing}"
    listed = {g for g in list(NAMES) + list(SIGNATURES) if g[0] == rel}
    stale = sorted(listed - gaps)
    assert not stale, f"listed departures that no longer depart: {stale}"


def test_every_listed_departure_is_found_and_has_a_reason():
    """The keyword and Pallas-name exemptions each match a real gap, and
    every entry carries its one-line reason."""
    gaps = set().union(*(_gaps(rel) for rel in REF_MODULES
                         if rel not in MODULES))
    for kw in KEYWORDS:
        assert any(len(g) == 3 and g[2] == kw for g in gaps), kw
    assert any(len(g) == 2 and "_pallas" in g[1] for g in gaps)
    for key in list(NAMES) + list(SIGNATURES):
        assert key in gaps, key
    for reason in (list(MODULES.values()) + list(NAMES.values())
                   + list(KEYWORDS.values()) + list(SIGNATURES.values())
                   + [PALLAS_REASON]):
        assert reason and "\n" not in reason
