"""Multi-pod dry run: run every (arch x shape) cell's step once on the
production mesh, over ``meta`` tensors, and emit a JSON record a cell with
its per-device memory, FLOPs and collective bytes and the roofline.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell on 512 placeholder host devices and reads XLA's memory and cost
analyses and the compiled HLO. Here the mesh is a ``DeviceMesh`` over a
fake process group of 256 or 512 ranks in one process
(``launch.mesh.fake_group``), the params, optimizer state, batch, caches
and error state are ``DTensor`` s over ``meta`` tensors placed by the
ported specs (``distributed.sharding``), and the cell's step runs once:
``loss_fn`` + ``torch.autograd.grad`` + ``adamw_update`` for train,
``prefill``, or ``decode_step``. Rank 0's view of that run is recorded
below DTensor's dispatch (``StepRecorder``), where every op runs on one
device's shard:
  * FLOPs per device: each local op's count (``torch.utils.flop_counter``'s
    registry: matmuls, convolutions, attention) on the local shapes;
  * bytes: the operands each local op reads and the results it writes
    (views excluded), XLA's unfused "bytes accessed";
  * collectives: each ``_c10d_functional`` op DTensor issues (kind, the
    local result's bytes, the group's size), summed by
    ``roofline.collective_bytes_from_ops``;
  * memory: the local shards of the arguments plus the live bytes of every
    storage the step allocates, freed as Python frees them; its peak.

PyTorch runs every layer, so the reference's scan correction (XLA counts a
scan body once) has nothing to correct: ``correct_scans`` still measures a
base of two periods a scanned segment and one variant a scanned segment
with a period more, and the record's ``collective_bytes_corrected`` (base
+ (n-2) x marginal) shows it equal to the measured total. The reduced
configs' params are placed as the full config's layers are, so a period
costs the same in all three.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
  python -m repro_torch.launch.dryrun --all --both-meshes  # 16x16, 2x16x16

--all runs one subprocess a cell (a failure stays in its cell).

Per-cell variants:
  --remat {none,full}       activation checkpointing policy for train cells
  --compress {none,int8,topk}  DP-gradient compression inside the step
  --seq-shard               shard prefill activations' sequence dim (SP)
  --no-cache-seq-shard      no sequence sharding of decode caches
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import (P, batch_specs, cache_specs,
                                              distribute_tree, map_with_path,
                                              named_sharding_tree,
                                              param_specs)
from repro_torch.launch.mesh import fake_group, make_production_mesh
from repro_torch.launch.shapes import SHAPES, cell_supported, input_specs
from repro_torch.models import model as M
from repro_torch.models.transformer import layer_plan, tree_leaves, tree_map
from repro_torch.roofline.analysis import (collective_bytes_from_ops,
                                           model_flops, roofline_terms)
from repro_torch.training import grad_compress as gc
from repro_torch.training.loop import value_and_grad
from repro_torch.training.optim import (AdamWConfig, adamw_update,
                                        init_opt_state)

F32 = torch.float32
BF16 = torch.bfloat16

# the collectives DTensor issues, by ``_c10d_functional`` op name, as the
# reference's HLO names them
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _tensors(obj):
    """The tensors in an op's arguments or results (nested lists, tuples and
    dicts)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


class _Meta(tuple):
    """A tensor's (shape, stride, dtype) in a signature."""


def _sig(obj):
    """A hashable signature of an op's arguments (tensors by metadata) or
    results."""
    if isinstance(obj, torch.Tensor):
        return _Meta((tuple(obj.shape), obj.stride(), obj.dtype))
    if isinstance(obj, (list, tuple)):
        return (type(obj), tuple(_sig(x) for x in obj))
    if isinstance(obj, dict):
        return (dict, tuple((k, _sig(v)) for k, v in obj.items()))
    return (type(obj), repr(obj))


def _rebuild(sig):
    """Fresh ``meta`` tensors in the structure of a results signature."""
    if isinstance(sig, _Meta):
        shape, stride, dtype = sig
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    kind, body = sig
    if kind in (list, tuple):
        return kind(_rebuild(x) for x in body)
    return body if kind is not dict else {k: _rebuild(v) for k, v in body}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepRecorder(TorchDispatchMode):
    """Records one device's share of a step, below DTensor's dispatch: a
    ``DTensor`` op is handed back (``NotImplemented``) so that DTensor runs
    it, and the local ops and collectives it issues come back here on plain
    tensors (one rank's shards).

    ``flops``: each local op's FLOPs (the flop counter's registry) on the
    local shapes. ``bytes``: operands read and results written by each
    local op that is not a view. ``calls``: (kind, result bytes, group
    size) a collective. Memory: ``track`` registers argument storages;
    every storage an op creates is live from then until Python frees it;
    ``peak`` is the most live bytes at once, the arguments included."""

    def __init__(self):
        super().__init__()
        self._shape_prop = 0
        self._metas = {}
        self.flops = 0
        self.bytes = 0
        self.calls = []
        self._live = {}
        self.live = 0
        self.peak = 0

    def _free(self, key):
        self.live -= self._live.pop(key, 0)

    def _hold(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def track(self, tree):
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._hold(t.to_local() if isinstance(t, DTensor) else t)

    def __enter__(self):
        # DTensor derives an op's global output shape by running the op on
        # fake tensors of the global shapes; those ops are not the step's
        prop = DTensor._op_dispatcher.sharding_propagator
        run = prop._propagate_tensor_meta_non_cached

        def counted(*a, **k):
            self._shape_prop += 1
            try:
                return run(*a, **k)
            finally:
                self._shape_prop -= 1
        prop._propagate_tensor_meta_non_cached = counted
        return super().__enter__()

    def __exit__(self, *exc):
        prop = DTensor._op_dispatcher.sharding_propagator
        del prop._propagate_tensor_meta_non_cached
        return super().__exit__(*exc)

    def _run(self, func, args, kwargs):
        """``func`` on meta tensors. A functional op (no view, no write, no
        collective) whose inputs' metadata has been seen returns fresh
        ``meta`` tensors of its cached output metadata, without running the
        op's meta kernel again (a loop over blocks or time steps repeats
        the same ops)."""
        if (func.is_view or func._schema.is_mutable
                or func.namespace == "_c10d_functional"
                or any(t.device.type != "meta"
                       for t in _tensors((args, kwargs)))):
            return func(*args, **kwargs)
        key = (func, _sig(args), _sig(kwargs))
        meta = self._metas.get(key)
        if meta is None:
            out = func(*args, **kwargs)
            if all(t.device.type == "meta" for t in _tensors(out)):
                self._metas[key] = _sig(out)
            return out
        return _rebuild(meta)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._shape_prop:
            return func(*args, **kwargs)
        out = self._run(func, args, kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = list(_tensors(out))
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVES.get(packet.__name__)
            if kind is not None:
                self.calls.append((kind, _nbytes(outs[0]),
                                   _group_size(args[-1])))
        elif not func.is_view:
            ins = list(_tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._hold(t)
        return out


def _local_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's local shards."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = (t.to_local() if isinstance(t, DTensor) else t
                  ).untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def build_step(cfg, kind, *, remat=True, compress="none",
               bf16_params=False):
    """The function each cell runs.

    bf16_params: cast f32 master weights to bf16 before the forward."""
    def maybe_cast(params):
        if not bf16_params:
            return params
        return tree_map(lambda p: p.to(BF16) if p.dtype == F32 else p,
                        params)

    if kind == "train":
        ocfg = AdamWConfig()

        def train_step(params, opt_state, batch, err):
            (loss, _), grads = value_and_grad(
                lambda p, b: M.loss_fn(maybe_cast(p), cfg, b, remat=remat),
                params, batch)
            if compress == "topk":
                grads, err = gc.topk_compress(grads, err)
            elif compress == "int8":
                grads, err = gc.int8_compress(grads, err)
            params, opt_state, _ = adamw_update(ocfg, params, grads,
                                                opt_state)
            return params, opt_state, err, loss

        return train_step
    if kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                return M.prefill(maybe_cast(params), cfg, batch)

        return prefill_step

    def decode_step(params, token, pos, caches):
        with torch.no_grad():
            return M.decode_step(maybe_cast(params), cfg, token, pos, caches)

    return decode_step


def _reduced_cfgs(cfg):
    """Depth-reduced configs for the scan correction.

    Returns (base_cfg, [(seg_idx, n_periods_full, variant_cfg), ...]) where
    base has TWO periods in each scanned segment (one in an unrolled one)
    and each variant adds one period to a single scanned segment.
    cost(variant) - cost(base) = one period's collectives; the full-depth
    value is base + sum_seg (n_periods - 2) * marginal_seg. (The
    reference's base has one period; a segment of one period runs
    unrolled, without remat, so here a period is read between two and
    three.)
    """
    if cfg.encdec:
        ne, nd = min(cfg.n_encoder_layers, 2), min(cfg.n_layers, 2)
        base = dataclasses.replace(cfg, n_encoder_layers=ne, n_layers=nd)
        return base, [
            (0, cfg.n_encoder_layers,
             dataclasses.replace(cfg, n_encoder_layers=ne + 1, n_layers=nd)),
            (1, cfg.n_layers,
             dataclasses.replace(cfg, n_encoder_layers=ne, n_layers=nd + 1)),
        ]
    plan = layer_plan(cfg)
    period_lens = [len(s["specs"]) for s in plan]
    n_dense = cfg.moe.n_dense_layers if cfg.moe else 0

    def build(periods):
        n_layers = sum(p * n for p, n in zip(periods, period_lens))
        new = dataclasses.replace(cfg, n_layers=n_layers)
        if cfg.moe and n_dense:
            # the dense prefix segment is segment 0
            nd = periods[0] * period_lens[0]
            new = dataclasses.replace(new, moe=dataclasses.replace(
                cfg.moe, n_dense_layers=nd))
        return new

    base_periods = [min(seg["n_periods"], 2) for seg in plan]
    base = build(base_periods)
    variants = []
    for i, seg in enumerate(plan):
        if seg["n_periods"] <= 1:
            continue                      # unrolled: counted exactly in base
        pp = list(base_periods)
        pp[i] += 1
        variants.append((i, seg["n_periods"], build(pp)))
    return base, variants


def _entry_divides(entry, n, mesh) -> bool:
    axes = [a for a in (entry if isinstance(entry, tuple) else (entry,))
            if a is not None]
    size = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)
    return n % size == 0


def _specs_like(params, full_specs, full_shapes, mesh, serve):
    """Specs for a depth-reduced config's params that place each layer as
    the full config places it: a leaf one period shorter than the full
    stack (a segment cut to one period, unstacked) takes the full spec
    without its leading entry; a stack of another depth keeps the full
    spec, its leading entry only where it divides the shorter stack."""
    def one(path, leaf, fallback):
        node_s, node_f = full_specs, full_shapes
        for k in path:
            if isinstance(node_s, dict) and k not in node_s:
                return fallback
            node_s, node_f = node_s[k], node_f[k]
        shape, fshape = tuple(leaf.shape), tuple(node_f)
        if len(shape) == len(fshape) - 1 and shape == fshape[1:]:
            return P(*tuple(node_s)[1:])
        if len(shape) == len(fshape) and shape[1:] == fshape[1:]:
            entries = list(node_s) + [None] * (len(shape) - len(node_s))
            if entries[0] is not None and not _entry_divides(
                    entries[0], shape[0], mesh):
                entries[0] = None
            return P(*entries)
        return fallback

    own = param_specs(params, mesh, serve=serve)
    return map_with_path(one, params, own)


def _measure(cfg, kind, shape, mesh, *, remat, compress, seq_shard,
             cache_seq_shard, serve_params=False, bf16_params=False,
             int8_kv=False, layout_of=None):
    """Place one config's inputs on ``mesh`` and run its step once under
    ``StepRecorder`` -> stats dict. ``layout_of``: a (full) config whose
    layers' placements the params take (the scan correction's reduced
    configs)."""
    spec = SHAPES[shape]
    t0 = time.time()
    ins = input_specs(cfg, shape, int8_kv=int8_kv)
    params = M.init_model(cfg, device="meta")
    if bf16_params:
        # STORED bf16 weights (the f32 Adam moments stay)
        params = tree_map(lambda p: p.to(BF16) if p.dtype == F32 else p,
                          params)
    if layout_of is None:
        pspecs = param_specs(params, mesh, serve=serve_params)
    else:
        full = M.model_param_shapes(layout_of)
        pspecs = _specs_like(params, param_specs(full, mesh,
                                                 serve=serve_params),
                             full, mesh, serve_params)
    psh = named_sharding_tree(mesh, pspecs)
    step = build_step(cfg, kind, remat=remat, compress=compress,
                      bf16_params=bf16_params)
    if kind == "train":
        opt_state = distribute_tree(
            init_opt_state(params), named_sharding_tree(mesh, {
                "m": pspecs, "v": pspecs, "step": P()}))
        err = (distribute_tree(gc.init_error_state(params), psh)
               if compress != "none" else None)
        params = distribute_tree(params, psh)
        batch = distribute_tree(ins["batch"], named_sharding_tree(
            mesh, batch_specs(mesh, ins["batch"], seq_shard=False)))
        args = (params, opt_state, batch, err)
        aliased = (params, opt_state, err)
    elif kind == "prefill":
        params = distribute_tree(params, psh)
        batch = distribute_tree(ins["batch"], named_sharding_tree(
            mesh, batch_specs(mesh, ins["batch"], seq_shard=seq_shard)))
        args = (params, batch)
        aliased = ()
    else:
        cspecs = cache_specs(mesh, ins["caches"], spec["global_batch"])
        if not cache_seq_shard:
            cspecs = map_with_path(lambda _, s: P(*[a if a != "model" else None
                                                    for a in s]), cspecs)
        params = distribute_tree(params, psh)
        caches = distribute_tree(ins["caches"],
                                 named_sharding_tree(mesh, cspecs))
        token = distribute_tree(ins["token"], named_sharding_tree(
            mesh, batch_specs(mesh, ins["token"])))
        pos = distribute_tree(ins["pos"], named_sharding_tree(mesh, P()))
        args = (params, token, pos, caches)
        aliased = (caches,)
    t_place = time.time() - t0
    rec = StepRecorder()
    arg_bytes = _local_bytes(args)
    alias_bytes = _local_bytes(aliased)
    rec.track(args)
    with rec:
        t0 = time.time()
        with implicit_replication():
            out = step(*args)
        t_run = time.time() - t0
    arg_keys = {(t.to_local() if isinstance(t, DTensor) else t
                 ).untyped_storage()._cdata
                for t in tree_leaves(args) if isinstance(t, torch.Tensor)}
    new_out = {}
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor):
            st = (t.to_local() if isinstance(t, DTensor) else t
                  ).untyped_storage()
            if st._cdata not in arg_keys:
                new_out[st._cdata] = st.nbytes()
    out_bytes = alias_bytes + sum(new_out.values())
    temp = max(0, rec.peak - arg_bytes - sum(new_out.values()))
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "temp_bytes": temp, "alias_bytes": alias_bytes,
           "peak_per_device": arg_bytes + out_bytes + temp - alias_bytes}
    return {"mem": mem, "flops": rec.flops, "bytes": rec.bytes,
            "coll": collective_bytes_from_ops(rec.calls),
            "t_place": t_place, "t_run": t_run}


def run_cell(arch: str, shape: str, *, multi_pod: bool, remat=True,
             compress="none", seq_shard=False, cache_seq_shard=True,
             serve_params=False, bf16_params=False, int8_kv=False,
             correct_scans=None, verbose=True):
    """One cell's record. The default group must have the mesh's ranks
    (``main`` starts a fake one)."""
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    spec = SHAPES[shape]
    kind = spec["kind"]
    if correct_scans is None:
        correct_scans = not multi_pod     # roofline table is single-pod

    kw = dict(remat=remat, compress=compress, seq_shard=seq_shard,
              cache_seq_shard=cache_seq_shard, serve_params=serve_params,
              bf16_params=bf16_params, int8_kv=int8_kv)
    full = _measure(cfg, kind, shape, mesh, **kw)

    # --- the scan correction, which here corrects nothing (see above) -----
    coll_corrected = None
    if correct_scans:
        base_cfg, variants = _reduced_cfgs(cfg)
        base = (full if base_cfg == cfg else
                _measure(base_cfg, kind, shape, mesh, layout_of=cfg, **kw))
        total = base["coll"]["total"]
        for _, n_periods, vcfg in variants:
            var = _measure(vcfg, kind, shape, mesh, layout_of=cfg, **kw)
            marginal = max(var["coll"]["total"] - base["coll"]["total"], 0.0)
            total += (n_periods - 2) * marginal
        coll_corrected = total

    # --- analytic exact flops / streaming bytes ---------------------------
    from repro_torch.roofline.analytic import (cell_flops_per_device,
                                               cell_hbm_bytes_per_device,
                                               decode_cache_bytes)
    n_total = M.count_params(M.model_param_shapes(cfg))
    n_active = M.active_params(cfg, n_total)
    an_flops = cell_flops_per_device(cfg, shape, n_chips, remat=remat)
    cache_b = (decode_cache_bytes(cfg, shape, int8_kv=int8_kv)
               if kind == "decode" else 0)
    an_bytes = cell_hbm_bytes_per_device(cfg, shape, n_chips, n_total,
                                         cache_b, remat=remat)
    coll_best = (coll_corrected if coll_corrected is not None
                 else full["coll"]["total"])
    roof = roofline_terms({"flops": an_flops, "bytes accessed": an_bytes},
                          {"total": coll_best})
    measured_roof = roofline_terms(
        {"flops": full["flops"], "bytes accessed": full["bytes"]},
        full["coll"])

    mf = model_flops(cfg, n_total, n_active, kind,
                     spec["seq_len"], spec["global_batch"])
    record = {
        "arch": arch, "shape": shape, "kind": kind,
        "mesh": list(mesh.shape), "chips": n_chips,
        "multi_pod": multi_pod,
        "remat": remat, "compress": compress, "seq_shard": seq_shard,
        "cache_seq_shard": cache_seq_shard,
        "serve_params": serve_params, "bf16_params": bf16_params,
        "int8_kv": int8_kv,
        "params_total": n_total, "params_active": n_active,
        "place_s": round(full["t_place"], 1),
        "run_s": round(full["t_run"], 1),
        "memory": full["mem"],
        "cost_measured": {
            "flops_per_dev": measured_roof["flops_per_dev"],
            "hbm_bytes_per_dev": measured_roof["hbm_bytes_per_dev"],
            "note": "rank 0's local ops, every layer run; bytes unfused"},
        "analytic": {"flops_per_dev": an_flops,
                     "hbm_bytes_per_dev": an_bytes,
                     "decode_cache_bytes_total": cache_b},
        "collectives": full["coll"],
        "collective_bytes_corrected": coll_corrected,
        "roofline": {k: roof[k] for k in
                     ("compute_s", "memory_s", "collective_s", "dominant",
                      "overlap_roofline_frac")},
        "roofline_measured": {k: measured_roof[k] for k in
                              ("compute_s", "memory_s", "collective_s",
                               "dominant")},
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / (an_flops * n_chips)
                               if an_flops else 0.0),
    }
    if verbose:
        print(json.dumps(record, indent=1))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--remat", default="full", choices=["full", "none"])
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--no-cache-seq-shard", action="store_true")
    ap.add_argument("--serve-params", action="store_true",
                    help="TP-only weights (no FSDP) for serve steps")
    ap.add_argument("--bf16-params", action="store_true",
                    help="store weights in bf16 (halves gathers)")
    ap.add_argument("--int8-kv", action="store_true",
                    help="int8 KV cache with per-slot scales (decode)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)

    if args.all:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        failures = []
        for mp in meshes:
            for arch in ARCH_IDS:
                for shape in SHAPES:
                    if not cell_supported(arch, shape):
                        _write(args.out, arch, shape, mp, args.tag,
                               {"arch": arch, "shape": shape,
                                "multi_pod": mp, "skipped":
                                "full-attention arch at 500k decode"})
                        continue
                    name = _cell_name(arch, shape, mp, args.tag)
                    path = os.path.join(args.out, name + ".json")
                    if args.skip_existing and os.path.exists(path):
                        print("skip", name)
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape,
                           "--out", args.out, "--tag", args.tag,
                           "--remat", args.remat,
                           "--compress", args.compress]
                    if mp:
                        cmd.append("--multi-pod")
                    if args.seq_shard:
                        cmd.append("--seq-shard")
                    if args.no_cache_seq_shard:
                        cmd.append("--no-cache-seq-shard")
                    print(">>", name, flush=True)
                    r = subprocess.run(cmd, capture_output=True, text=True)
                    if r.returncode != 0:
                        failures.append(name)
                        print("FAIL", name, "\n", r.stdout[-2000:],
                              r.stderr[-4000:], flush=True)
                    else:
                        print(r.stdout.strip().splitlines()[-1], flush=True)
        print(f"\ndry-run sweep done; {len(failures)} failures")
        for f in failures:
            print("  FAILED:", f)
        sys.exit(1 if failures else 0)

    with fake_group(512 if args.multi_pod else 256):
        record = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                          remat=args.remat == "full", compress=args.compress,
                          seq_shard=args.seq_shard,
                          cache_seq_shard=not args.no_cache_seq_shard,
                          serve_params=args.serve_params,
                          bf16_params=args.bf16_params,
                          int8_kv=args.int8_kv,
                          verbose=False)
    _write(args.out, args.arch, args.shape, args.multi_pod, args.tag, record)
    roof = record.get("roofline", {})
    print(json.dumps({
        "cell": _cell_name(args.arch, args.shape, args.multi_pod, args.tag),
        "peak_bytes_per_dev": record["memory"]["peak_per_device"],
        "dominant": roof.get("dominant"),
        "compute_s": round(roof.get("compute_s", 0), 6),
        "memory_s": round(roof.get("memory_s", 0), 6),
        "collective_s": round(roof.get("collective_s", 0), 6),
        "collective_bytes": record["collectives"]["total"],
        "collective_bytes_corrected": record["collective_bytes_corrected"],
        "run_s": record["run_s"]}))


def _cell_name(arch, shape, multi_pod, tag):
    mesh = "2x16x16" if multi_pod else "16x16"
    return f"{arch}__{shape}__{mesh}" + (f"__{tag}" if tag else "")


def _write(out, arch, shape, multi_pod, tag, record):
    path = os.path.join(out, _cell_name(arch, shape, multi_pod, tag) + ".json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
