"""Carry objects between the JAX package and this one, through numpy.

The JAX package's NamedTuples (``GenomeState``, ``SubFragTable``,
``RippeParams``, ``HiCParams``, ``NeighbourTable``, ``JumpTable``,
``SparseObs``) are passed here as numpy-convertible
fields (``obj._asdict()`` of the JAX object works, since ``np.asarray``
reads a JAX array); the result is the port's object on ``device``.
:func:`to_numpy` goes the other way. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from graal_tpu_torch.core.mcmc import NeighbourTable
from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.model_hic import HiCParams
from graal_tpu_torch.core.mtm import JumpTable
from graal_tpu_torch.core.sparse import SparseObs
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable


def _fields(obj) -> dict:
    return dict(obj._asdict()) if hasattr(obj, "_asdict") else dict(obj)


def state_from_numpy(d, device=None) -> GenomeState:
    """GenomeState of int32 tensors from a mapping of the 11 fields (any
    leading batch shape)."""
    d = _fields(d)
    return GenomeState(*[torch.as_tensor(np.asarray(d[f]).astype(np.int32),
                                         device=device)
                         for f in GenomeState._fields])


def table_from_numpy(d, device=None) -> SubFragTable:
    """SubFragTable from a mapping of its fields."""
    d = _fields(d)
    i32 = ("owner", "data_id")

    def t(f):
        dt = np.int32 if f in i32 else np.float32
        return torch.as_tensor(np.asarray(d[f]).astype(dt), device=device)

    return SubFragTable(
        owner=t("owner"), data_id=t("data_id"), len_kb=t("len_kb"),
        accu=t("accu"), prefix_kb=t("prefix_kb"), suffix_kb=t("suffix_kb"),
        n_data_sub=int(d["n_data_sub"]),
        n_frags_per_bins=float(d["n_frags_per_bins"]),
        has_repeats=bool(d["has_repeats"]))


def params_from_numpy(d, device=None) -> RippeParams:
    """RippeParams of 0-d f32 tensors from a mapping of its 8 fields."""
    d = _fields(d)
    return RippeParams(*[torch.tensor(np.float32(np.asarray(d[f])), device=device)
                         for f in RippeParams._fields])


def hic_params_from_numpy(d, device=None) -> HiCParams:
    """HiCParams of 0-d f32 tensors from a mapping of its 8 fields."""
    d = _fields(d)
    return HiCParams(*[torch.tensor(np.float32(np.asarray(d[f])), device=device)
                       for f in HiCParams._fields])


def jump_table_from_numpy(d, device=None) -> JumpTable:
    """JumpTable from a mapping of its fields (``frags``, ``delta``)."""
    d = _fields(d)
    return JumpTable(frags=torch.as_tensor(np.asarray(d["frags"]).astype(np.int32),
                                           device=device),
                     delta=int(d["delta"]))


def neighbour_table_from_numpy(d, device=None) -> NeighbourTable:
    """NeighbourTable from a mapping of its fields."""
    d = _fields(d)
    return NeighbourTable(
        xk=torch.as_tensor(np.asarray(d["xk"]).astype(np.int32), device=device),
        pk=torch.as_tensor(np.asarray(d["pk"]).astype(np.float32), device=device),
        dispatcher=torch.as_tensor(np.asarray(d["dispatcher"]).astype(np.int32),
                                   device=device),
        blacklist=torch.as_tensor(np.asarray(d["blacklist"]).astype(bool),
                                  device=device),
        n_bins=int(d["n_bins"]), max_copies=int(d["max_copies"]))


def sparse_from_numpy(d, device=None) -> SparseObs:
    """SparseObs from a mapping of the JAX ``SparseObs`` fields; its
    TPU-only ``packed`` window storage is dropped."""
    d = _fields(d)

    def t(f, dt):
        return torch.as_tensor(np.asarray(d[f]).astype(dt), device=device)

    return SparseObs(rows=t("rows", np.int32), cols=t("cols", np.int32),
                     vals=t("vals", np.float32), row_start=t("row_start", np.int64),
                     row_cap=int(d["row_cap"]), n=int(d["n"]),
                     logfact_const=float(d["logfact_const"]))


def to_numpy(obj) -> dict:
    """A NamedTuple of tensors -> a dict of its fields as numpy arrays
    (non-tensor fields pass through)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in _fields(obj).items()}
