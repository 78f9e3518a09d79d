"""Genome-state checkpointing.

Counterpart of ``graal_tpu.utils.checkpoint``: one npz per save, written
by atomic rename, holding ``state_<field>`` (the 11 int32 arrays),
``params`` (the 8 model floats, of either contact model), ``cycle`` and ``extra_<name>`` entries.
Where the JAX package stores its random key, the port stores the state of
the run's ``torch.Generator`` (``generator``), so a resumed run continues
the same random stream and equals the uninterrupted run bit for bit.

A run's metric history travels in the extras as one numeric array per
series (:func:`metrics_extra` / :func:`metrics_from_extra`), which keeps
every value's type and exact float.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.state import GenomeState


def save_checkpoint(path: str, state: GenomeState, params: RippeParams,
                    cycle: int, gen: torch.Generator, extra: dict | None = None):
    arrays = {f"state_{f}": v for f, v in state.to_numpy().items()}
    arrays["params"] = np.asarray([float(x) for x in params], np.float64)
    arrays["cycle"] = np.asarray(cycle, np.int64)
    arrays["generator"] = gen.get_state().numpy()
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"   # np.savez appends .npz unless already present
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, device=None, params_cls=RippeParams):
    """-> (state, params, cycle, generator_state, extra); the state and
    params (a ``params_cls``, RippeParams or HiCParams) on ``device``, the
    generator state as ``gen.set_state`` takes it."""
    with np.load(path) as data:
        state = GenomeState(*[torch.as_tensor(data[f"state_{f}"], device=device)
                              for f in GenomeState._fields])
        params = params_cls(*[torch.tensor(np.float32(x), device=device)
                              for x in data["params"]])
        cycle = int(data["cycle"])
        gen_state = torch.from_numpy(data["generator"].copy())
        extra = {k[len("extra_"):]: data[k] for k in data.files if k.startswith("extra_")}
    return state, params, cycle, gen_state, extra


def metrics_extra(metrics: dict) -> dict:
    """Checkpoint extras ``m_<name>`` holding each metric list as a numeric
    array (bool, int64 or float64, as its values are); a list of lists is
    stored flat, beside its lengths (``mlen_<name>``)."""
    out = {}
    for k, v in metrics.items():
        if v and all(isinstance(x, (list, tuple)) for x in v):
            out[f"mlen_{k}"] = np.asarray([len(x) for x in v], np.int64)
            v = [y for x in v for y in x]
        out[f"m_{k}"] = np.asarray(v)
    return out


def metrics_from_extra(extra: dict) -> dict:
    """The metric lists :func:`metrics_extra` stored."""
    out = {}
    for k, v in extra.items():
        if not k.startswith("m_"):
            continue
        vals = np.asarray(v).tolist()
        lens = extra.get(f"mlen_{k[2:]}")
        if lens is not None:
            ends = np.cumsum(lens).tolist()
            vals = [vals[e - n:e] for n, e in zip(np.asarray(lens).tolist(), ends)]
        out[k[2:]] = vals
    return out
