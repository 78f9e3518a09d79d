"""The scalar and control work of a sampler step: hand-written CUDA kernels
for Hopper.

D1 is the nuisance move (``core.mcmc.nuisance_propose`` and
``nuisance_accept``, the port of ``graal_tpu/core/mcmc.py``
``make_nuisance_proposer`` / ``nuisance_accept``), D2 the neighbour draw
(``core.mcmc.sample_neighbours``), D3 the selection and commit of the dense
step (``core.mcmc.select_commit_dense``) and of the delta step
(``core.delta.select_commit_delta``). The JAX package has no Pallas kernel
for them: XLA fuses their jnp code inside the jitted step. They run as
three kernels of ``graal_tpu_torch/csrc/step.cu``, whose header says what
bounds them on the card and how the design answers that: the step's head
(:meth:`StepKernels.step_head`: D2's draw with D1's proposal beside it,
either part on its own too), D3, and the step's tail
(:meth:`StepKernels.step_tail`: D1's Metropolis test with the dense cycle
bodies' l_t select and metrics, each part optional). Each call is one
launch on the current stream, with no synchronisation and no host read,
into fresh outputs (the delta commit writes the state it is given), so a
captured step (``core.graphs.Scan``) captures it. Every kernel adds one to
its launch key's counter itself (D3 is a thread block cluster a chain,
:func:`select_cluster`).

:data:`STEP` is the one wrapper: the public functions send tensors on a
card to it and any others to their plain versions; the wrapper itself
refuses tensors that are not on a card. Its ``check_*`` functions are what
each kernel takes, checked without touching the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
import numbers

import numpy as np
import torch

from graal_tpu_torch.ops import build
from graal_tpu_torch.ops.counts import Counted, LaunchCount

N_PARAMS = 8          # RippeParams
N_ROW = 10            # the dense scorers' parameter row (likelihood_cuda.params_vector)
N_FIELDS = 11         # GenomeState
N_OPS = 13            # candidates a neighbour slot
MUTABLE = ("pos", "id_c", "start_bp", "circ", "l_cont", "l_cont_bp", "ori", "activ")
# the launch keys, and the kernels of the kernels line they make up
KINDS = ("step_head", "step_tail", "select_dense", "select_delta")
GROUPS = {"step_head": KINDS[:1], "step_tail": KINDS[1:2], "select_commit": KINDS[2:]}
# solve_d_max's bracket and step as the plain version holds them in f32
SOLVE_WIDTH = 64
LLO0 = float(np.float32(np.log(1e-2)))
LHI0 = float(np.float32(np.log(1e6)))
INV_W = float(np.float32(1.0) / np.float32(SOLVE_WIDTH - 1))
SELECT_THREADS = 256      # D3's block: a thread a fragment (dense) or a row (delta) of a chunk
MAX_SELECT_CLUSTER = 8    # D3's blocks a chain: the portable cluster size
ROWS_AHEAD = 4            # D3's delta commit: rows a thread loads before it stores

_P, _I64, _F32, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int


class ProposeArgs(ctypes.Structure):
    _fields_ = [("p", _P * N_PARAMS), ("ps", _I64 * N_PARAMS), ("idm", _P), ("idm_s", _I64),
                ("eps", _P), ("eps_s", _I64), ("log_nfpb", _P), ("out", _P), ("ok", _P),
                ("row", _P), ("cap", _F32), ("has_cap", _I32), ("llo0", _F32), ("lhi0", _F32),
                ("inv_w", _F32), ("C", _I32)]


class AcceptArgs(ctypes.Structure):
    _fields_ = [("test", _P * N_PARAMS), ("ts", _I64 * N_PARAMS), ("par", _P * N_PARAMS),
                ("ps", _I64 * N_PARAMS), ("u", _P), ("us", _I64), ("l_star", _P), ("lss", _I64),
                ("l_t", _P), ("lts", _I64), ("ok", _P), ("oks", _I64), ("ft", _P), ("fts", _I64),
                ("ft_inv", _F32), ("out", _P), ("l_out", _P), ("accept", _P), ("C", _I32)]


class NeighbourArgs(ctypes.Structure):
    _fields_ = [("u", _P), ("u_rs", _I64), ("u_cs", _I64), ("fa", _P), ("fa_s", _I64),
                ("id_d", _P), ("idd_rs", _I64), ("idd_cs", _I64), ("rep", _P), ("rep_rs", _I64),
                ("rep_cs", _I64), ("pk", _P), ("xk", _P), ("disp", _P), ("blacklist", _P),
                ("ids", _P), ("valid", _P), ("n_top", _I32), ("mc", _I32), ("d_eff", _I32),
                ("m", _I32), ("C", _I32)]


class HeadArgs(ctypes.Structure):
    _fields_ = [("nb", NeighbourArgs), ("pr", ProposeArgs), ("counter", _P)]


class TailArgs(ctypes.Structure):
    _fields_ = [("acc", AcceptArgs), ("score", _P), ("sc_s", _I64), ("pos", _P),
                ("pos_rs", _I64), ("pos_cs", _I64), ("activ", _P), ("act_rs", _I64),
                ("act_cs", _I64), ("len_bp", _P), ("len_rs", _I64), ("len_cs", _I64),
                ("n_contigs", _P), ("mean_len", _P), ("counter", _P), ("n", _I32)]


class SelectArgs(ctypes.Structure):
    _fields_ = [("score", _P), ("gumbel", _P), ("g_rs", _I64), ("valid_nb", _P),
                ("overflow", _P), ("ft", _P), ("fts", _I64), ("ft_inv", _F32), ("thresh", _F32),
                ("blacklist", _P), ("fa", _P), ("fa_s", _I64), ("ids", _P), ("sel", _P),
                ("score_out", _P), ("op", _P), ("fb", _P), ("counter", _P), ("C", _I32),
                ("m", _I32), ("cluster", _I32)]


class DenseArgs(ctypes.Structure):
    _fields_ = [("s", SelectArgs), ("cand", _P * N_FIELDS), ("cs_c", _I64 * N_FIELDS),
                ("cs_k", _I64 * N_FIELDS), ("cs_i", _I64 * N_FIELDS), ("state", _P * N_FIELDS),
                ("ss_c", _I64 * N_FIELDS), ("ss_i", _I64 * N_FIELDS), ("out", _P), ("n", _I32)]


class DeltaArgs(ctypes.Structure):
    _fields_ = [("s", SelectArgs), ("cand", _P * len(MUTABLE)), ("cs_c", _I64 * len(MUTABLE)),
                ("cs_j", _I64 * len(MUTABLE)), ("cs_o", _I64 * len(MUTABLE)),
                ("cs_i", _I64 * len(MUTABLE)), ("dst", _P * len(MUTABLE)),
                ("ds_c", _I64 * len(MUTABLE)), ("ds_i", _I64 * len(MUTABLE)), ("rows", _P),
                ("rows_valid", _P), ("n_over", _P), ("f_max", _I32)]


ARGS = (ProposeArgs, AcceptArgs, NeighbourArgs, DenseArgs, DeltaArgs, HeadArgs, TailArgs)


@functools.cache
def load_library():
    """The kernel library (built at first use), its C functions typed and
    its argument blocks checked against their ctypes mirrors."""
    lib = build.load("step")
    lib.step_args_size.argtypes = [_I32]
    lib.step_args_size.restype = _I32
    for k, cls in enumerate(ARGS):
        if lib.step_args_size(k) != ctypes.sizeof(cls):
            raise RuntimeError(f"step.cu and ops/step_cuda.py disagree on {cls.__name__}: "
                               f"{lib.step_args_size(k)} != {ctypes.sizeof(cls)} bytes")
    for name in ("step_head", "step_tail", "select_commit_dense", "select_commit_delta"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P]
        fn.restype = _I32
    return lib


def select_cluster(size: int) -> int:
    """K, the blocks of D3's cluster a chain: a block a chunk of
    SELECT_THREADS of what it commits (``size``: the dense path's n
    fragments, a thread a fragment's 11 fields; the delta path's f_max
    rows of the chosen slot), at least 1 and at most MAX_SELECT_CLUSTER.
    Thread t of block r commits the fragments (rows) r x SELECT_THREADS +
    t, stepping by K x SELECT_THREADS (the delta commit's rows ROWS_AHEAD
    at a time)."""
    return max(1, min(MAX_SELECT_CLUSTER, -(-size // SELECT_THREADS)))


# ---- argument checks (pure functions: no launch, any device) -----------------

def _per_chain(x, name: str, c: int, dtype, dev):
    """(flat tensor, stride) of a tensor on ``dev`` of ``dtype`` holding one
    value (stride 0) or one a chain (``c``; read at its own stride)."""
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"{name}: need a tensor, got {type(x).__name__}")
    if x.device != dev or x.dtype != dtype:
        raise ValueError(f"{name}: need {dtype} on {dev}, got {x.dtype} on {x.device}")
    if x.numel() not in (1, c):
        raise ValueError(f"{name}: need one value or {c}, got shape {tuple(x.shape)}")
    flat = x.reshape(-1)
    return flat, (flat.stride(0) if flat.numel() > 1 else 0)


def _temperature(f_t, c: int, dev):
    """(flat tensor or None, stride, reciprocal) of the temperature: a
    Python / numpy number is divided by as a product with its f32
    reciprocal (as torch divides by a CPU scalar on the card), an f32 tensor
    on ``dev`` of one value or one a chain by an IEEE division."""
    if isinstance(f_t, torch.Tensor):
        flat, stride = _per_chain(f_t, "f_t", c, torch.float32, dev)
        return flat, stride, 0.0
    if isinstance(f_t, numbers.Real) and not isinstance(f_t, bool):
        return None, 0, float(np.float32(1.0) / np.float32(f_t))
    raise ValueError(f"f_t: need a number or a tensor, got {type(f_t).__name__}")


def _params(params, name: str, c: int, dev):
    if len(params) != N_PARAMS:
        raise ValueError(f"{name}: need {N_PARAMS} parameters, got {len(params)}")
    return [_per_chain(x, f"{name}[{k}]", c, torch.float32, dev) for k, x in enumerate(params)]


def check_propose(id_modif, eps, params, d_max_cap=None, log_nfpb=None):
    """What ``nuisance_propose`` takes: ``id_modif`` int64 and ``eps`` f32 of
    one shape (() or (C,)) on one device, the 8 f32 parameters with one
    value or one a chain, ``d_max_cap`` None or a number, ``log_nfpb`` None
    or an f32 tensor of one value. Returns (C, id_modif, eps, params as
    (flat, stride) pairs); raises ValueError on anything else."""
    if not isinstance(id_modif, torch.Tensor) or id_modif.dtype != torch.int64 \
            or id_modif.dim() > 1:
        raise ValueError("id_modif: need an int64 tensor of shape () or (C,)")
    dev = id_modif.device
    c = id_modif.numel()
    if c < 1:
        raise ValueError("id_modif: no chain")
    if not isinstance(eps, torch.Tensor) or eps.shape != id_modif.shape:
        raise ValueError(f"eps: need the shape of id_modif, {tuple(id_modif.shape)}")
    if d_max_cap is not None and not (isinstance(d_max_cap, numbers.Real)
                                      and not isinstance(d_max_cap, bool)):
        raise ValueError(f"d_max_cap: need None or a number, got {type(d_max_cap).__name__}")
    if log_nfpb is not None:
        _per_chain(log_nfpb, "log_nfpb", 1, torch.float32, dev)
    return (c, _per_chain(id_modif, "id_modif", c, torch.int64, dev),
            _per_chain(eps, "eps", c, torch.float32, dev), _params(params, "params", c, dev))


def check_accept(u, test, params, l_star, l_t, f_t, in_support):
    """What ``nuisance_accept`` takes: f32 tensors on one device (bool
    ``in_support``), each of one value or one a chain, whose shapes
    broadcast; ``f_t`` as :func:`_temperature` takes it. Returns (C, the
    accept shape, each field's shape, the flat inputs); raises ValueError on
    anything else."""
    if not isinstance(u, torch.Tensor):
        raise ValueError("u: need a tensor")
    dev = u.device
    named = [("u", u), ("l_star", l_star), ("l_t", l_t), ("in_support", in_support)]
    if isinstance(f_t, torch.Tensor):
        named.append(("f_t", f_t))
    for name, x in named:
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"{name}: need a tensor, got {type(x).__name__}")
    if len(test) != N_PARAMS or len(params) != N_PARAMS:
        raise ValueError(f"test / params: need {N_PARAMS} parameters each")
    try:
        acc_shape = torch.broadcast_shapes(*[x.shape for _, x in named])
        shapes = [torch.broadcast_shapes(acc_shape, a.shape, b.shape)
                  for a, b in zip(test, params)]
        whole = torch.broadcast_shapes(acc_shape, *shapes)
    except RuntimeError as e:
        raise ValueError(f"shapes do not broadcast: {e}") from None
    c = max(math.prod(whole), 1)
    flat = dict(u=_per_chain(u, "u", c, torch.float32, dev),
                l_star=_per_chain(l_star, "l_star", c, torch.float32, dev),
                l_t=_per_chain(l_t, "l_t", c, torch.float32, dev),
                ok=_per_chain(in_support, "in_support", c, torch.bool, dev),
                ft=_temperature(f_t, c, dev), test=_params(test, "test", c, dev),
                par=_params(params, "params", c, dev))
    return c, acc_shape, shapes, flat


def check_neighbours(u, f_a, id_d, rep, nb, delta: int):
    """What ``neighbours`` takes: ``f_a`` int64, () for one genome or (C,)
    for a chains axis; ``u`` f32 (n_top,) (shared by the chains) or (C,
    n_top); ``id_d`` and ``rep`` int32 (n,) or (C, n) at any strides; the
    neighbour table's ``pk`` f32, ``xk`` int32 (n_bins, n_top) and
    ``dispatcher`` int32 (n_bins, max_copies), contiguous, and ``blacklist``
    bool (n,), all on one device; ``delta`` >= 1. Returns (C, m, d_eff,
    the (tensor, strides) of u, f_a, id_d and rep); raises ValueError on
    anything else."""
    if not isinstance(f_a, torch.Tensor) or f_a.dtype != torch.int64 or f_a.dim() > 1:
        raise ValueError("f_a: need an int64 tensor of shape () or (C,)")
    dev = f_a.device
    single = f_a.dim() == 0
    c = 1 if single else f_a.shape[0]
    if c < 1:
        raise ValueError("f_a: no chain")
    pk, xk, disp, bl = nb.pk, nb.xk, nb.dispatcher, nb.blacklist
    for name, x, dt in (("pk", pk, torch.float32), ("xk", xk, torch.int32),
                        ("dispatcher", disp, torch.int32), ("blacklist", bl, torch.bool)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"nb.{name}: need contiguous {dt} on {dev}, "
                             f"got {x.dtype} on {x.device}")
    if pk.dim() != 2 or xk.shape != pk.shape or disp.dim() != 2 or disp.shape[0] != pk.shape[0]:
        raise ValueError("nb: need pk / xk (n_bins, n_top) and dispatcher (n_bins, max_copies)")
    n_top, mc = pk.shape[1], disp.shape[1]
    if n_top < 1 or mc < 1:
        raise ValueError("nb: no partner or no copy column")
    if not isinstance(delta, numbers.Integral) or delta < 1:
        raise ValueError(f"delta: need an integer >= 1, got {delta!r}")
    if not isinstance(u, torch.Tensor) or u.device != dev or u.dtype != torch.float32 \
            or u.shape[-1:] != (n_top,) or u.dim() > (1 if single else 2) \
            or (u.dim() == 2 and u.shape[0] != c):
        raise ValueError(f"u: need f32 ({n_top},) or ({c}, {n_top}) on {dev}")
    u_rs = u.stride(0) if u.dim() == 2 else 0
    fields = []
    for name, x in (("id_d", id_d), ("rep", rep)):
        if x.device != dev or x.dtype != torch.int32 or x.dim() != (1 if single else 2) \
                or (not single and x.shape[0] != c):
            raise ValueError(f"state.{name}: need int32 {'(n,)' if single else f'({c}, n)'} "
                             f"on {dev}, got {tuple(x.shape)} {x.dtype} on {x.device}")
        if bl.shape != x.shape[-1:]:
            raise ValueError(f"nb.blacklist: need shape ({x.shape[-1]},), got {tuple(bl.shape)}")
        fields.append((x, 0 if single else x.stride(0), x.stride(-1)))
    d_eff = min(int(delta), n_top)
    return c, (d_eff + 1) * mc, d_eff, (u, u_rs, u.stride(-1)), (f_a, int(not single)), \
        fields[0], fields[1]


def check_tail(l_t, score=None, accept=None, metrics=None):
    """What the step's tail takes: ``l_t`` f32; ``score`` None or f32;
    ``accept`` None or (u, test, params, l_star, f_t, in_support) as
    :func:`check_accept` takes them with ``l_t``; ``metrics`` None or the
    state's (pos, activ, len_bp), int32 of one shape, (n,) or (C, n) at any
    strides; all on one device, each per-chain input one value or one a
    chain, their shapes broadcasting. Returns (C, the shape of l_t, accept
    and the metrics out, each accepted parameter's shape or None, the flat
    inputs); raises ValueError on anything else."""
    if not isinstance(l_t, torch.Tensor):
        raise ValueError("l_t: need a tensor")
    dev = l_t.device
    shapes, c_acc, par_shapes = [l_t.shape], 1, None
    if score is not None:
        if not isinstance(score, torch.Tensor):
            raise ValueError("score: need a tensor")
        shapes.append(score.shape)
    if accept is not None:
        if len(accept) != 6:
            raise ValueError("accept: need (u, test, params, l_star, f_t, in_support)")
        u, test, params, l_star, f_t, ok = accept
        c_acc, acc_shape, par_shapes, _ = check_accept(u, test, params, l_star, l_t, f_t, ok)
        shapes.append(acc_shape)
    if metrics is not None:
        if len(metrics) != 3:
            raise ValueError("metrics: need (pos, activ, len_bp)")
        for name, x in zip(("pos", "activ", "len_bp"), metrics):
            if not isinstance(x, torch.Tensor) or x.device != dev or x.dtype != torch.int32 \
                    or x.dim() not in (1, 2) or x.shape != metrics[0].shape or x.shape[-1] < 1:
                raise ValueError(f"state.{name}: need int32 (n,) or (C, n) on {dev}, one "
                                 "shape for pos, activ and len_bp")
        shapes.append(metrics[0].shape[:-1])
    try:
        out_shape = torch.broadcast_shapes(*shapes)
        if par_shapes is not None:
            par_shapes = [torch.broadcast_shapes(x, out_shape) for x in par_shapes]
    except RuntimeError as e:
        raise ValueError(f"shapes do not broadcast: {e}") from None
    c = max(math.prod(out_shape), c_acc, 1)
    flat = dict(l_t=_per_chain(l_t, "l_t", c, torch.float32, dev))
    if score is not None:
        flat["score"] = _per_chain(score, "score", c, torch.float32, dev)
    if accept is not None:
        flat.update(u=_per_chain(u, "u", c, torch.float32, dev),
                    l_star=_per_chain(l_star, "l_star", c, torch.float32, dev),
                    ok=_per_chain(ok, "in_support", c, torch.bool, dev),
                    ft=_temperature(f_t, c, dev), test=_params(test, "test", c, dev),
                    par=_params(params, "params", c, dev))
    if metrics is not None:
        flat["metrics"] = [(x, x.stride(0) if x.dim() == 2 else 0, x.stride(-1))
                           for x in metrics]
    return c, out_shape, par_shapes, flat


def check_select(score, ids, valid, f_a, gumbel, f_t, blacklist, overflow=None):
    """What the selection of ``select_commit_*`` takes, on a chains axis:
    ``score`` f32 (C, m, 13), ``ids`` int32 and ``valid`` bool (C, m),
    ``f_a`` int64 (C,), ``gumbel`` f32 (C, m x 13) or (m x 13,) (shared),
    ``f_t`` as :func:`_temperature` takes it, ``blacklist`` bool (n,),
    ``overflow`` None or bool (C, m), all on one device. Returns (C, m,
    gumbel's row stride, the temperature); raises ValueError on anything
    else."""
    if not isinstance(score, torch.Tensor) or score.dim() != 3 or score.shape[2] != N_OPS:
        raise ValueError(f"score: need a (C, m, {N_OPS}) tensor")
    dev = score.device
    c, m = score.shape[:2]
    if c < 1 or m < 1:
        raise ValueError("score: no chain or no neighbour slot")
    named = [("score", score, torch.float32, (c, m, N_OPS)), ("ids", ids, torch.int32, (c, m)),
             ("valid", valid, torch.bool, (c, m)), ("f_a", f_a, torch.int64, (c,))]
    if overflow is not None:
        named.append(("overflow", overflow, torch.bool, (c, m)))
    for name, x, dt, shape in named:
        if not isinstance(x, torch.Tensor) or x.device != dev or x.dtype != dt \
                or tuple(x.shape) != shape:
            raise ValueError(f"{name}: need {dt} {shape} on {dev}")
    if not isinstance(gumbel, torch.Tensor) or gumbel.device != dev \
            or gumbel.dtype != torch.float32 or gumbel.shape[-1:] != (m * N_OPS,) \
            or gumbel.dim() > 2 or (gumbel.dim() == 2 and gumbel.shape[0] != c) \
            or gumbel.stride(-1) != 1:
        raise ValueError(f"gumbel: need f32 ({m * N_OPS},) or ({c}, {m * N_OPS}) on {dev}, "
                         "unit stride along the slots")
    if not isinstance(blacklist, torch.Tensor) or blacklist.device != dev \
            or blacklist.dtype != torch.bool or blacklist.dim() != 1:
        raise ValueError(f"blacklist: need a bool (n,) tensor on {dev}")
    return c, m, (gumbel.stride(0) if gumbel.dim() == 2 else 0), _temperature(f_t, c, dev)


def check_dense(state, cands, c: int, m: int):
    """What the dense commit takes besides the selection: ``state``'s 11
    int32 fields (C, n) and ``cands``' 11 int32 fields (C, m x 13, n), at
    any strides, on the selection's device. Returns n; raises ValueError on
    anything else."""
    if len(state) != N_FIELDS or len(cands) != N_FIELDS:
        raise ValueError(f"state / cands: need {N_FIELDS} fields each")
    n = state[0].shape[-1] if state[0].dim() == 2 else 0
    if n < 1:
        raise ValueError("state: need (C, n) fields with n >= 1")
    dev = state[0].device
    for k, (x, y) in enumerate(zip(state, cands)):
        if x.device != dev or x.dtype != torch.int32 or tuple(x.shape) != (c, n):
            raise ValueError(f"state field {k}: need int32 ({c}, {n}) on {dev}")
        if y.device != dev or y.dtype != torch.int32 or tuple(y.shape) != (c, m * N_OPS, n):
            raise ValueError(f"candidate field {k}: need int32 ({c}, {m * N_OPS}, {n}) on {dev}")
    return n


def check_delta(dst, minis, rows, rows_valid, c: int, m: int):
    """What the delta commit takes besides the selection: ``dst``'s 8
    mutable int32 fields (C, n), written in place, and ``minis``' 8 int32
    fields (C, m, 13, f_max), at any strides; ``rows`` int64 and
    ``rows_valid`` bool (C, m, f_max), contiguous. Fields are given by name
    (``MUTABLE``). Returns f_max; raises ValueError on anything else."""
    if not isinstance(rows, torch.Tensor) or rows.dim() != 3 or tuple(rows.shape[:2]) != (c, m):
        raise ValueError(f"rows: need a ({c}, {m}, f_max) tensor")
    dev, f_max = rows.device, rows.shape[2]
    if f_max < 1:
        raise ValueError("rows: f_max < 1")
    for name, x, dt in (("rows", rows, torch.int64), ("rows_valid", rows_valid, torch.bool)):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != (c, m, f_max) \
                or not x.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dt} ({c}, {m}, {f_max}) on {dev}")
    for name in MUTABLE:
        x, y = dst[name], minis[name]
        if x.device != dev or x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != c:
            raise ValueError(f"state field {name}: need int32 ({c}, n) on {dev}")
        if y.device != dev or y.dtype != torch.int32 or tuple(y.shape) != (c, m, N_OPS, f_max):
            raise ValueError(f"candidate field {name}: need int32 ({c}, {m}, {N_OPS}, {f_max}) "
                             f"on {dev}")
    return f_max


def _ptr(x):
    return None if x is None else x.data_ptr()


def _select_args(score, ids, valid, f_a, gumbel, f_t, blacklist, thresh, overflow, outs,
                 counter, cluster):
    c, m, g_rs, (ft, fts, ft_inv) = check_select(score, ids, valid, f_a, gumbel, f_t, blacklist,
                                                  overflow)
    # contiguous copies (when they are copies) live until the launch is queued
    score, ids, valid = score.contiguous(), ids.contiguous(), valid.contiguous()
    overflow = None if overflow is None else overflow.contiguous()
    keep = [score, ids, valid, f_a, gumbel, ft, overflow]
    sel, score_out, op, fb = outs
    return keep, SelectArgs(
        score=score.data_ptr(), gumbel=gumbel.data_ptr(), g_rs=g_rs, valid_nb=valid.data_ptr(),
        overflow=_ptr(overflow), ft=_ptr(ft), fts=fts,
        ft_inv=ft_inv, thresh=float(np.float32(thresh)), blacklist=blacklist.data_ptr(),
        fa=f_a.data_ptr(), fa_s=f_a.stride(0), ids=ids.data_ptr(), sel=sel.data_ptr(),
        score_out=score_out.data_ptr(), op=op.data_ptr(), fb=fb.data_ptr(),
        counter=counter.data_ptr(), C=c, m=m, cluster=cluster)


class StepKernels(Counted):
    """The step kernels on a card (the head, D3, the tail); see the module
    docstring. ``n_launches`` counts the launches on the card, by kind
    (``KINDS``, ``ops.counts``): every kernel adds one to its kind's counter
    itself, and nothing is counted beside a launch."""

    def __init__(self):
        self.launches = LaunchCount()

    @staticmethod
    def _device(x):
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA step kernels need tensors on a card, not on {dev}")
        return dev

    @staticmethod
    def _refused(kind, rc):
        if rc != 0:
            raise RuntimeError(f"{kind} launch failed: cudaError {rc}")

    def step_head(self, draw=None, propose=None):
        """The step's head, one launch: ``draw`` None or the neighbour
        draw's (u, f_a, id_d, rep, nb, delta) as :func:`check_neighbours`
        takes them; ``propose`` None or the nuisance proposal's (id_modif,
        eps, params, d_max_cap, log_nfpb) as :func:`check_propose` takes
        them; at least one, on one card. Returns (the draw's (ids int32,
        valid bool), (m,) for a 0-d ``f_a`` or (C, m), or None; the
        proposal's (test c1, slope, d_max, fact, v_inter each of
        ``id_modif``'s shape, in_support, the test set's (..., 10)
        parameter row or None without ``log_nfpb``), or None)."""
        if draw is None and propose is None:
            raise ValueError("step_head: neither a draw nor a proposal")
        dev = self._device(draw[1] if draw is not None else propose[0])
        nb_args, pr_args = NeighbourArgs(C=0), ProposeArgs(C=0)
        drawn = proposed = None
        if draw is not None:
            u, f_a, id_d, rep, nb, delta = draw
            c, m, d_eff, (u, u_rs, u_cs), (fa, fa_s), (idd, idd_rs, idd_cs), \
                (rp, rep_rs, rep_cs) = check_neighbours(u, f_a, id_d, rep, nb, delta)
            ids = torch.empty((c, m), dtype=torch.int32, device=dev)
            valid = torch.empty((c, m), dtype=torch.bool, device=dev)
            nb_args = NeighbourArgs(
                u=u.data_ptr(), u_rs=u_rs, u_cs=u_cs, fa=fa.data_ptr(), fa_s=fa_s,
                id_d=idd.data_ptr(), idd_rs=idd_rs, idd_cs=idd_cs, rep=rp.data_ptr(),
                rep_rs=rep_rs, rep_cs=rep_cs, pk=nb.pk.data_ptr(), xk=nb.xk.data_ptr(),
                disp=nb.dispatcher.data_ptr(), blacklist=nb.blacklist.data_ptr(),
                ids=ids.data_ptr(), valid=valid.data_ptr(), n_top=nb.pk.shape[1],
                mc=nb.dispatcher.shape[1], d_eff=d_eff, m=m, C=c)
            drawn = (ids[0], valid[0]) if f_a.dim() == 0 else (ids, valid)
        if propose is not None:
            id_modif, eps, params, d_max_cap, log_nfpb = propose
            if id_modif.device != dev:
                raise ValueError(f"id_modif: need a tensor on {dev}, got {id_modif.device}")
            c, (idm, idm_s), (eps_f, eps_s), par = check_propose(id_modif, eps, params,
                                                                 d_max_cap, log_nfpb)
            out = torch.empty((5, c), dtype=torch.float32, device=dev)
            ok = torch.empty(c, dtype=torch.bool, device=dev)
            row = None if log_nfpb is None else torch.empty((c, N_ROW), dtype=torch.float32,
                                                            device=dev)
            pr_args = ProposeArgs(
                p=(_P * N_PARAMS)(*[x.data_ptr() for x, _ in par]),
                ps=(_I64 * N_PARAMS)(*[s for _, s in par]), idm=idm.data_ptr(), idm_s=idm_s,
                eps=eps_f.data_ptr(), eps_s=eps_s, log_nfpb=_ptr(log_nfpb),
                out=out.data_ptr(), ok=ok.data_ptr(), row=_ptr(row),
                cap=float(np.float32(d_max_cap)) if d_max_cap is not None else 0.0,
                has_cap=int(d_max_cap is not None), llo0=LLO0, lhi0=LHI0, inv_w=INV_W, C=c)
            shape = id_modif.shape
            proposed = (tuple(x.reshape(shape) for x in out.unbind(0)), ok.reshape(shape),
                        None if row is None else row.reshape(tuple(shape) + (N_ROW,)))
        lib = load_library()
        a = HeadArgs(nb=nb_args, pr=pr_args,
                     counter=self.launches.counter(dev, "step_head").data_ptr())
        self._refused("step_head", lib.step_head(ctypes.byref(a),
                                                 torch.cuda.current_stream(dev).cuda_stream))
        return drawn, proposed

    def neighbours(self, u, f_a, id_d, rep, nb, delta: int):
        """D2 alone (the head with no proposal): (ids int32, valid bool),
        (m,) for a 0-d ``f_a`` or (C, m)."""
        return self.step_head(draw=(u, f_a, id_d, rep, nb, delta))[0]

    def nuisance_propose(self, id_modif, eps, params, d_max_cap=None, log_nfpb=None):
        """D1's proposal alone (the head with no draw): (test c1, slope,
        d_max, fact, v_inter each of ``id_modif``'s shape, in_support, the
        test set's (..., 10) parameter row or None without ``log_nfpb``)."""
        return self.step_head(propose=(id_modif, eps, params, d_max_cap, log_nfpb))[1]

    def step_tail(self, l_t, score=None, accept=None, metrics=None):
        """The step's tail, one launch, as :func:`check_tail` takes its
        arguments: l_t <- ``score`` where it is finite; with ``accept`` the
        Metropolis test and its selects; with ``metrics`` each chain's
        n_contigs and mean_len. Returns (the 8 parameters, each of its
        broadcast shape, or None without ``accept``; l_out; accepted (true
        without ``accept``); n_contigs int64 and mean_len f32, or None
        without ``metrics``), l_out and the rest of the broadcast shape of
        l_t, score, the acceptance and the metrics' chains."""
        dev = self._device(l_t)
        c, shape, par_shapes, f = check_tail(l_t, score, accept, metrics)
        l_out = torch.empty(c, dtype=torch.float32, device=dev)
        acc = torch.empty(c, dtype=torch.bool, device=dev)
        out = None if accept is None else torch.empty((N_PARAMS, c), dtype=torch.float32,
                                                      device=dev)
        n_contigs = mean_len = None
        if metrics is not None:
            n_contigs = torch.empty(c, dtype=torch.int64, device=dev)
            mean_len = torch.empty(c, dtype=torch.float32, device=dev)
        acc_args = AcceptArgs(l_t=f["l_t"][0].data_ptr(), lts=f["l_t"][1], l_out=l_out.data_ptr(),
                              accept=acc.data_ptr(), C=c)
        if accept is not None:
            ft, fts, ft_inv = f["ft"]
            acc_args = AcceptArgs(
                test=(_P * N_PARAMS)(*[x.data_ptr() for x, _ in f["test"]]),
                ts=(_I64 * N_PARAMS)(*[s for _, s in f["test"]]),
                par=(_P * N_PARAMS)(*[x.data_ptr() for x, _ in f["par"]]),
                ps=(_I64 * N_PARAMS)(*[s for _, s in f["par"]]),
                u=f["u"][0].data_ptr(), us=f["u"][1], l_star=f["l_star"][0].data_ptr(),
                lss=f["l_star"][1], l_t=f["l_t"][0].data_ptr(), lts=f["l_t"][1],
                ok=f["ok"][0].data_ptr(), oks=f["ok"][1], ft=_ptr(ft), fts=fts, ft_inv=ft_inv,
                out=out.data_ptr(), l_out=l_out.data_ptr(), accept=acc.data_ptr(), C=c)
        a = TailArgs(acc=acc_args, counter=self.launches.counter(dev, "step_tail").data_ptr())
        if score is not None:
            a.score, a.sc_s = f["score"][0].data_ptr(), f["score"][1]
        if metrics is not None:
            (pos, a.pos_rs, a.pos_cs), (act, a.act_rs, a.act_cs), (lbp, a.len_rs, a.len_cs) = \
                f["metrics"]
            a.pos, a.activ, a.len_bp = pos.data_ptr(), act.data_ptr(), lbp.data_ptr()
            a.n_contigs, a.mean_len, a.n = n_contigs.data_ptr(), mean_len.data_ptr(), \
                pos.shape[-1]
        lib = load_library()
        self._refused("step_tail", lib.step_tail(ctypes.byref(a),
                                                 torch.cuda.current_stream(dev).cuda_stream))

        def shaped(x, to):
            return (x if x.numel() == math.prod(to) else x[:1]).reshape(to)

        fields = None if out is None else tuple(shaped(x, s)
                                                for x, s in zip(out.unbind(0), par_shapes))
        return (fields, shaped(l_out, shape), shaped(acc, shape),
                None if n_contigs is None else shaped(n_contigs, shape),
                None if mean_len is None else shaped(mean_len, shape))

    def nuisance_accept(self, u, test, params, l_star, l_t, f_t, in_support):
        """D1's Metropolis test alone (the tail with no score and no
        metrics): (the 8 parameters, each of its broadcast shape, l_out,
        accept)."""
        fields, l_out, acc, _, _ = self.step_tail(l_t, accept=(u, test, params, l_star, f_t,
                                                               in_support))
        return fields, l_out, acc

    def select_dense(self, state, cands, score, ids, valid, f_a, gumbel, f_t, blacklist,
                     thresh):
        """D3 on the dense step, chains axis: (the new state's 11 fields (C,
        n), score (C,) f32, op (C,) int64, fb (C,) int64, sel (C,) int64)."""
        dev = self._device(score)
        c, m = score.shape[:2]
        outs = (torch.empty(c, dtype=torch.int64, device=dev),
                torch.empty(c, dtype=torch.float32, device=dev),
                torch.empty(c, dtype=torch.int64, device=dev),
                torch.empty(c, dtype=torch.int64, device=dev))
        n = check_dense(state, cands, c, m)
        keep, s = _select_args(score, ids, valid, f_a, gumbel, f_t, blacklist, thresh, None,
                               outs, self.launches.counter(dev, "select_dense"),
                               select_cluster(n))
        lib = load_library()
        out = torch.empty((N_FIELDS, c, n), dtype=torch.int32, device=dev)
        a = DenseArgs(s=s, cand=(_P * N_FIELDS)(*[x.data_ptr() for x in cands]),
                      cs_c=(_I64 * N_FIELDS)(*[x.stride(0) for x in cands]),
                      cs_k=(_I64 * N_FIELDS)(*[x.stride(1) for x in cands]),
                      cs_i=(_I64 * N_FIELDS)(*[x.stride(2) for x in cands]),
                      state=(_P * N_FIELDS)(*[x.data_ptr() for x in state]),
                      ss_c=(_I64 * N_FIELDS)(*[x.stride(0) for x in state]),
                      ss_i=(_I64 * N_FIELDS)(*[x.stride(1) for x in state]),
                      out=out.data_ptr(), n=n)
        self._refused("select_dense", lib.select_commit_dense(
            ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream))
        del keep
        sel, score_out, op, fb = outs
        return out.unbind(0), score_out, op, fb, sel

    def select_delta(self, dst, minis, rows, rows_valid, score, ids, valid, overflow, f_a,
                     gumbel, f_t, blacklist, thresh):
        """D3 on the delta step, chains axis: writes the chosen mini-state's
        valid rows into ``dst`` (the 8 mutable fields by name, (C, n), in
        place) unless the step is a no-op; returns (d_sel (C,) f32, op (C,)
        int64, fb (C,) int64, n_over (C,) int64, sel (C,) int64)."""
        dev = self._device(score)
        c, m = score.shape[:2]
        outs = (torch.empty(c, dtype=torch.int64, device=dev),
                torch.empty(c, dtype=torch.float32, device=dev),
                torch.empty(c, dtype=torch.int64, device=dev),
                torch.empty(c, dtype=torch.int64, device=dev))
        n_over = torch.empty(c, dtype=torch.int64, device=dev)
        f_max = check_delta(dst, minis, rows, rows_valid, c, m)
        keep, s = _select_args(score, ids, valid, f_a, gumbel, f_t, blacklist, thresh, overflow,
                               outs, self.launches.counter(dev, "select_delta"),
                               select_cluster(f_max))
        lib = load_library()
        cand = [minis[f] for f in MUTABLE]
        out = [dst[f] for f in MUTABLE]
        a = DeltaArgs(s=s, cand=(_P * len(MUTABLE))(*[x.data_ptr() for x in cand]),
                      cs_c=(_I64 * len(MUTABLE))(*[x.stride(0) for x in cand]),
                      cs_j=(_I64 * len(MUTABLE))(*[x.stride(1) for x in cand]),
                      cs_o=(_I64 * len(MUTABLE))(*[x.stride(2) for x in cand]),
                      cs_i=(_I64 * len(MUTABLE))(*[x.stride(3) for x in cand]),
                      dst=(_P * len(MUTABLE))(*[x.data_ptr() for x in out]),
                      ds_c=(_I64 * len(MUTABLE))(*[x.stride(0) for x in out]),
                      ds_i=(_I64 * len(MUTABLE))(*[x.stride(1) for x in out]),
                      rows=rows.data_ptr(), rows_valid=rows_valid.data_ptr(),
                      n_over=n_over.data_ptr(), f_max=f_max)
        self._refused("select_delta", lib.select_commit_delta(
            ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream))
        del keep
        sel, d_sel, op, fb = outs
        return d_sel, op, fb, n_over, sel


STEP = StepKernels()
