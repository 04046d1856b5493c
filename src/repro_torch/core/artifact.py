"""TableArtifact — the deployable output of IIsy's mapping tool.

Port of ``repro/core/artifact.py``. The artifact is what the control plane
would load into switch tables; every table is a tensor passed to the
classify step, so retraining swaps tables without rebuilding anything — the
paper's "model updates by table updates only" property (§4.4).

Two families share the container:

Tree ensembles (dt / rf / xgb / iforest):
  edges   (F, U)      union of the ensemble's thresholds per feature (+inf pad)
  ftable  (F, U+1, T) per-union-bin, per-tree code (tree-local bin rank)
  strides (T, F)      mixed-radix strides turning codes into a decision key
  dtable_class (T, S) leaf class id per key              (vote aggregation)
  dtable_value (T, S) quantized leaf payload per key     (weight / path len)

Classical (svm / nb / kmeans):
  edges   (F, U)      quantile bin edges (+inf pad)
  vtable  (F, U+1, M) quantized per-bin partial terms
  consts  (M,)        intercept sums / log priors / zeros

Fused-kernel layout (built once, control-plane side, by ``finalize_artifact``):

  ftable_flat (F*Bp, Tp)   f32  flat[f*Bp + b, t] = ftable[f, b, t] * strides[t, f]
  vtable_flat (F*Bp, Mp)   f32  flattened quantized partial terms
  dtable_flat (Co, T, Sp)  f32  Co = n_classes (vote: one-hot of the leaf
                                class) or 1 (sum aggs: quantized payload)
  dtable_pad  (T, Sp)      f32  padded raw decision table (class ids or
                                payloads) for the compare-select strategy

Bp/Tp/Mp/Sp are U+1/T/M/S rounded up to ``LANE``. The reference picks its
lane from the JAX backend (128 on a TPU, 8 elsewhere); the port uses 8 on
every device, so its flat tables equal the reference's CPU tables array for
array, and the CUDA kernel takes the logical sizes as arguments. Padded
entries are zero and can never be selected (bins <= U, keys < S).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.quantize import FixedPoint

LANE = 8     # pad-to width on every device (the reference's off-TPU lane)

_TENSOR_FIELDS = ("edges", "ftable", "strides", "dtable_class", "consts",
                  "pairs", "ftable_flat", "vtable_flat", "dtable_flat",
                  "dtable_pad")
_FIXED_FIELDS = ("dtable_value", "vtable")
_STATIC_FIELDS = ("agg", "n_classes", "base_score", "learning_rate",
                  "iforest_subsample")


def round_up_to_lane(n: int, lane: int = LANE) -> int:
    return -(-n // lane) * lane


@dataclasses.dataclass
class TableArtifact:
    # shared
    edges: torch.Tensor
    agg: str    # 'vote' | 'wsum_sigmoid' | 'iforest' | 'svm_ovo' | 'nb_log' | 'kmeans'
    n_classes: int

    # tree family
    ftable: Optional[torch.Tensor] = None
    strides: Optional[torch.Tensor] = None
    dtable_class: Optional[torch.Tensor] = None
    dtable_value: Optional[FixedPoint] = None

    # classical family
    vtable: Optional[FixedPoint] = None
    consts: Optional[torch.Tensor] = None

    # svm extras
    pairs: Optional[torch.Tensor] = None          # (m, 2) class pairs

    # fused-kernel layout (see finalize_artifact)
    ftable_flat: Optional[torch.Tensor] = None    # (F*Bp, Tp) f32
    vtable_flat: Optional[torch.Tensor] = None    # (F*Bp, Mp) f32
    dtable_flat: Optional[torch.Tensor] = None    # (Co, T, Sp) f32
    dtable_pad: Optional[torch.Tensor] = None     # (T, Sp) f32

    # scalars used by aggregation
    base_score: float = 0.0
    learning_rate: float = 1.0
    iforest_subsample: float = 256.0

    @property
    def n_features(self) -> int:
        return self.edges.shape[0]

    @property
    def n_trees(self) -> int:
        return 0 if self.ftable is None else self.ftable.shape[2]

    @property
    def n_bins(self) -> int:
        """Logical bins per feature (union edge count + 1)."""
        return self.edges.shape[1] + 1

    @property
    def device(self) -> torch.device:
        return self.edges.device

    @property
    def pad_meta(self) -> dict:
        """Padded vs logical shapes — how to slice the logical view back out."""
        meta = {"b": self.n_bins}
        if self.ftable_flat is not None:
            meta.update(b_pad=self.ftable_flat.shape[0] // self.n_features,
                        t=self.n_trees, t_pad=self.ftable_flat.shape[1],
                        s=self.dtable_class.shape[1],
                        s_pad=self.dtable_flat.shape[2])
        if self.vtable_flat is not None:
            meta.update(b_pad=self.vtable_flat.shape[0] // self.n_features,
                        m=self.vtable.q.shape[2],
                        m_pad=self.vtable_flat.shape[1])
        return meta

    def to(self, device, copy: bool = False) -> "TableArtifact":
        """Every table on ``device`` (the same tensors when already there,
        unless ``copy``: then every table is a new tensor)."""
        moved = {k: getattr(self, k).to(device, copy=copy)
                 for k in _TENSOR_FIELDS + _FIXED_FIELDS
                 if getattr(self, k) is not None}
        return dataclasses.replace(self, **moved)

    def copy_(self, other: "TableArtifact") -> "TableArtifact":
        """Copy ``other``'s table contents into this artifact's tensors in
        place (from any device): every tensor keeps its storage, so a CUDA
        graph captured over them serves the new contents. The shape
        signatures (static fields included) must be equal."""
        if other.shape_signature() != self.shape_signature():
            raise ValueError("table shapes changed: constraints violated "
                             "(paper §4.4 requires fixed model constraints)")
        for k in _TENSOR_FIELDS:
            if getattr(self, k) is not None:
                getattr(self, k).copy_(getattr(other, k))
        for k in _FIXED_FIELDS:
            if getattr(self, k) is not None:
                getattr(self, k).q.copy_(getattr(other, k).q)
                getattr(self, k).scale.copy_(getattr(other, k).scale)
        return self

    def shape_signature(self) -> tuple:
        """Static fields plus every table's shape (None where absent): two
        artifacts with equal signatures are interchangeable in a server."""
        sig = [getattr(self, k) for k in _STATIC_FIELDS]
        for k in _TENSOR_FIELDS:
            v = getattr(self, k)
            sig.append(None if v is None else tuple(v.shape))
        for k in _FIXED_FIELDS:
            v = getattr(self, k)
            sig.append(None if v is None
                       else (tuple(v.q.shape), tuple(v.scale.shape), v.bits))
        return tuple(sig)


def artifact_from_arrays(fields: dict) -> TableArtifact:
    """Build an artifact from plain arrays — how tables cross over from the
    reference package (or from disk).

    ``fields`` maps field names to numpy arrays (or anything ``np.array``
    takes; they are copied), with ``dtable_value``/``vtable`` given as
    ``{"q": ..., "scale": ..., "bits": ...}`` and the static fields
    (``agg``, ``n_classes``, ``base_score``, ...) as Python values. Missing
    or None fields stay None. The tensors land on the CPU.
    """
    def tensor(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype=dtype, copy=True))

    kw = {k: fields[k] for k in _STATIC_FIELDS if k in fields}
    for k in _TENSOR_FIELDS:
        if fields.get(k) is not None:
            kw[k] = tensor(fields[k])
    for k in _FIXED_FIELDS:
        fp = fields.get(k)
        if fp is not None:
            kw[k] = FixedPoint(q=tensor(fp["q"], np.int32),
                               scale=tensor(fp["scale"], np.float32),
                               bits=int(fp["bits"]))
    return TableArtifact(**kw)


# ---------------------------------------------------------------------------
# fused-kernel table layout
# ---------------------------------------------------------------------------

def flatten_ftable(ftable, strides, lane: int = LANE) -> torch.Tensor:
    """(F, B, T) codes + (T, F) strides -> (F*Bp, Tp) f32, stride-premultiplied.

    Folding the mixed-radix stride into the table turns the whole key
    computation into one sum over features: key[t] = sum_f flat[f*Bp + bin_f, t].
    code * stride < S <= 2^24, so the product is exact in f32.
    """
    f, b, t = ftable.shape
    b_pad = round_up_to_lane(b, lane)
    t_pad = round_up_to_lane(t, lane)
    prod = (ftable.to(torch.float32)
            * strides.t().to(torch.float32)[:, None, :])          # (F,B,T)
    flat = torch.zeros((f, b_pad, t_pad), dtype=torch.float32,
                       device=ftable.device)
    flat[:, :b, :t] = prod
    return flat.reshape(f * b_pad, t_pad)


def flatten_vtable(q, lane: int = LANE) -> torch.Tensor:
    """(F, B, M) quantized terms -> (F*Bp, Mp) f32 (exact integer payloads)."""
    f, b, m = q.shape
    b_pad = round_up_to_lane(b, lane)
    m_pad = round_up_to_lane(m, lane)
    flat = torch.zeros((f, b_pad, m_pad), dtype=torch.float32, device=q.device)
    flat[:, :b, :m] = q.to(torch.float32)
    return flat.reshape(f * b_pad, m_pad)


def build_dtable_flat(dtable, n_classes: int, vote: bool,
                      lane: int = LANE) -> torch.Tensor:
    """(T, S) decision table -> (Co, T, Sp) f32 decision+aggregation table.

    vote: Co = n_classes and flat[c, t, s] = (dtable[t, s] == c), so summing
    flat[c, t, key_t] over trees counts per-class votes.
    sums: Co = 1 and flat[0, t, s] = dtable[t, s], so the same sum totals
    the matched payloads. Pad entries sit at key indices >= S, which no
    decision key can take.
    """
    t, s = dtable.shape
    s_pad = round_up_to_lane(s, lane)
    d = dtable.to(torch.float32)
    if vote:
        c_iota = torch.arange(n_classes, dtype=torch.float32,
                              device=dtable.device)
        flat = (d[None, :, :] == c_iota[:, None, None]).to(torch.float32)
    else:
        flat = d[None, :, :]
    out = torch.zeros((flat.shape[0], t, s_pad), dtype=torch.float32,
                      device=dtable.device)
    out[:, :, :s] = flat
    return out


def pad_dtable(dtable, lane: int = LANE) -> torch.Tensor:
    """(T, S) -> (T, Sp) f32 for the compare-select strategy. A mapped
    artifact's keys stay below S, so no pad entry is read. The lookups
    still accept a key at or past S, as the reference does: a key in
    [S, Sp) reads a pad entry, which is 0, and one outside [0, Sp) reads
    leaf 0 (``kernels/ensemble_lookup.py``), so every key outside [0, S)
    reads leaf 0."""
    t, s = dtable.shape
    s_pad = round_up_to_lane(s, lane)
    out = torch.zeros((t, s_pad), dtype=torch.float32, device=dtable.device)
    out[:, :s] = dtable.to(torch.float32)
    return out


def finalize_artifact(art: TableArtifact, lane: int = LANE,
                      profile=None) -> TableArtifact:
    """Attach the fused-kernel layout (idempotent). Runs control-plane side,
    once per table load.

    profile: optional ``core.resources.DeviceProfile`` deploy guard — the
    artifact is checked against the device budget *before* any layout work
    and a ``FitError`` aborts the load if it cannot deploy (see
    ``core.resources.check_fit``). None (default) keeps finalization
    unconditional.
    """
    if profile is not None:
        # local import: resources imports this module for TableArtifact
        from repro_torch.core.resources import check_fit
        check_fit(art, profile, strict=True)
    if art.ftable is not None:
        if art.ftable_flat is not None:
            return art
        vote = art.agg == "vote"
        dtable = art.dtable_class if vote else art.dtable_value.q
        return dataclasses.replace(
            art,
            ftable_flat=flatten_ftable(art.ftable, art.strides, lane),
            dtable_flat=build_dtable_flat(dtable, art.n_classes, vote, lane),
            dtable_pad=pad_dtable(dtable, lane))
    if art.vtable is not None:
        if art.vtable_flat is not None:
            return art
        return dataclasses.replace(
            art, vtable_flat=flatten_vtable(art.vtable.q, lane))
    return art
