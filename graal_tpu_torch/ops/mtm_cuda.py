"""The control work of an MTM / MH refinement step: hand-written CUDA
kernels for Hopper.

E1 is the neighbour set of a pivot with its (m, 13) discard mask, the
genome's largest contig id and its contig count (``core.mtm.move_set``,
the port of ``graal_tpu/core/mtm.py`` ``_prev_next`` / ``_neighbour_set`` /
``_impossibility_mask``); E2 the forward weights, the slot draw and the
proposal (``core.mtm.forward_dense`` / ``forward_delta``); E3 the backward
weights, the acceptance and the commit (``core.mtm.accept_dense`` /
``accept_delta``). The JAX package has no Pallas kernel for them: XLA
fuses their jnp code inside the jitted step. The kernel source is
``graal_tpu_torch/csrc/mtm.cu``; its header says what bounds them on the
card and how the design answers that. Each call is one launch on the
current stream, with no synchronisation and no host read, into fresh
outputs (E2's delta entry writes the state it is given, E3's restores it),
so a captured step (``core.graphs.Scan``) captures it.

:data:`MOVE` is the one wrapper: the public functions send tensors on a
card to it and any others to their plain versions; the wrapper itself
refuses tensors that are not on a card. Its ``check_*`` functions are what
each kernel takes, checked without touching the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graal_tpu_torch.core.state import MUTABLE_FIELDS
from graal_tpu_torch.ops import build
from graal_tpu_torch.ops.counts import Counted, LaunchCount
from graal_tpu_torch.ops.step_cuda import _temperature

N_FIELDS = 11         # GenomeState
N_OPS = 13            # candidates a neighbour slot
MAX_M = 64            # neighbour slots (delta + 2)
N_MUTABLE = len(MUTABLE_FIELDS)   # the fields a delta step writes
MTM_THRESH_OVERFLOW = 600.0   # step_mtm (cuda_lib_gl.py:2974)
MH_THRESH_OVERFLOW = 10.0     # step_metropolis_hastings_s_a (:2871)
SET_FIELDS = ("pos", "id_c", "circ", "l_cont")
KINDS = ("set", "draw", "accept")    # E1, E2, E3: the launch keys

_P, _I64, _F32, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int


class SetArgs(ctypes.Structure):
    _fields_ = [("field", _P * 4), ("stride", _I64 * 4), ("frags", _P), ("fa", _P), ("mp", _P),
                ("ids_in", _P), ("valid_in", _P), ("ids", _P), ("valid", _P), ("discard", _P),
                ("max_id", _P), ("n_contigs", _P), ("n", _I32), ("delta", _I32), ("m", _I32)]


class Slots(ctypes.Structure):
    _fields_ = [("score", _P), ("base", _P), ("discard", _P), ("overflow", _P), ("ft", _P),
                ("ft_inv", _F32), ("thresh", _F32), ("mh", _I32), ("S", _I32)]


class DrawArgs(ctypes.Structure):
    _fields_ = [("s", Slots), ("gumbel", _P), ("ids", _P), ("omega", _P), ("f_star", _P),
                ("ll_star", _P), ("p_fwd", _P), ("sw", _P), ("mx", _P), ("ok", _P),
                ("cand", _P * N_FIELDS), ("cs_k", _I64 * N_FIELDS), ("cs_i", _I64 * N_FIELDS),
                ("g_star", _P), ("n", _I32), ("mini", _P * N_MUTABLE),
                ("ms_j", _I64 * N_MUTABLE), ("ms_o", _I64 * N_MUTABLE),
                ("ms_i", _I64 * N_MUTABLE), ("dst", _P * N_MUTABLE),
                ("ds_i", _I64 * N_MUTABLE), ("rows", _P), ("rows_valid", _P), ("undo", _P),
                ("f_max", _I32), ("m", _I32)]


class AcceptArgs(ctypes.Structure):
    _fields_ = [("s", Slots), ("l_t", _P), ("u", _P), ("omega", _P), ("ll_star", _P),
                ("p_fwd", _P), ("sw", _P), ("mx", _P), ("ok", _P), ("corrected", _I32),
                ("l_out", _P), ("accepted", _P), ("n_contigs", _P), ("ratio", _P),
                ("gs", _P * N_FIELDS), ("gs_i", _I64 * N_FIELDS), ("st", _P * N_FIELDS),
                ("st_i", _I64 * N_FIELDS), ("out", _P), ("n", _I32),
                ("dst", _P * N_MUTABLE), ("ds_i", _I64 * N_MUTABLE), ("rows", _P),
                ("rows_valid", _P), ("undo", _P), ("n_in", _P), ("f_max", _I32)]


ARGS = (SetArgs, DrawArgs, AcceptArgs)


@functools.cache
def load_library():
    """The kernel library (built at first use), its C functions typed and
    its argument blocks checked against their ctypes mirrors."""
    lib = build.load("mtm")
    lib.mtm_args_size.argtypes = [_I32]
    lib.mtm_args_size.restype = _I32
    for k, cls in enumerate(ARGS):
        if lib.mtm_args_size(k) != ctypes.sizeof(cls):
            raise RuntimeError(f"mtm.cu and ops/mtm_cuda.py disagree on {cls.__name__}: "
                               f"{lib.mtm_args_size(k)} != {ctypes.sizeof(cls)} bytes")
    for name in ("mtm_set", "mtm_draw", "mtm_accept"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P]
        fn.restype = _I32
    return lib


# ---- argument checks (pure functions: no launch, any device) -----------------

def _tensor(x, name: str, dtype, shape, dev, contiguous=False):
    if not isinstance(x, torch.Tensor) or x.device != dev or x.dtype != dtype \
            or tuple(x.shape) != tuple(shape) or (contiguous and not x.is_contiguous()):
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}" if isinstance(x, torch.Tensor)
               else type(x).__name__)
        raise ValueError(f"{name}: need {'contiguous ' if contiguous else ''}{dtype} "
                         f"{tuple(shape)} on {dev}, got {got}")
    return x


def check_set(fields, f_a, frags, mask_pivot, given=None):
    """What E1 takes: ``fields`` the genome's pos, id_c, circ and l_cont
    (``SET_FIELDS``, by name), int32 (n,) on one device at any strides; the
    jump table ``frags`` contiguous int32 (n, delta); ``mask_pivot`` an int64
    0-d tensor; and either ``f_a`` an int64 0-d tensor (the full mode) or
    ``given`` = (ids int64 (m,), valid bool (m,)), contiguous (the mask-only
    mode, ``f_a`` None), m = delta + 2 <= MAX_M. Returns (n, delta, m);
    raises ValueError on anything else."""
    pos = fields["pos"]
    if not isinstance(pos, torch.Tensor) or pos.dim() != 1 or pos.shape[0] < 1:
        raise ValueError("state.pos: need an (n,) tensor, n >= 1")
    dev, n = pos.device, pos.shape[0]
    for name in SET_FIELDS:
        _tensor(fields[name], f"state.{name}", torch.int32, (n,), dev)
    if not isinstance(frags, torch.Tensor) or frags.dim() != 2:
        raise ValueError("jump.frags: need an (n, delta) tensor")
    delta = frags.shape[1]
    _tensor(frags, "jump.frags", torch.int32, (n, delta), dev, contiguous=True)
    m = delta + 2
    if not 1 <= delta or m > MAX_M:
        raise ValueError(f"jump.frags: need 1 <= delta <= {MAX_M - 2}, got {delta}")
    _tensor(mask_pivot, "mask_pivot", torch.int64, (), dev)
    if (f_a is None) == (given is None):
        raise ValueError("need f_a (the full mode) or given (the mask-only mode), not both")
    if f_a is not None:
        _tensor(f_a, "f_a", torch.int64, (), dev)
    else:
        _tensor(given[0], "ids", torch.int64, (m,), dev, contiguous=True)
        _tensor(given[1], "valid", torch.bool, (m,), dev, contiguous=True)
    return n, delta, m


def check_slots(score, discard, f_t, base=None, overflow=None):
    """What E2 and E3 take of a pass: ``score`` f32 (m, 13) (log-likelihoods,
    or with ``base`` deltas), ``discard`` bool (m, 13), ``f_t`` a number or an
    f32 tensor of one value, ``base`` None or an f32 0-d tensor, ``overflow``
    None or bool (m,), all on one device. Returns (m, the temperature as
    ``step_cuda._temperature`` gives it); raises ValueError on anything
    else."""
    if not isinstance(score, torch.Tensor) or score.dim() != 2 or score.shape[1] != N_OPS:
        raise ValueError(f"score: need an (m, {N_OPS}) tensor")
    dev, m = score.device, score.shape[0]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"score: need 1 to {MAX_M} neighbour slots, got {m}")
    _tensor(score, "score", torch.float32, (m, N_OPS), dev)
    _tensor(discard, "discard", torch.bool, (m, N_OPS), dev)
    if base is not None:
        _tensor(base, "l_t", torch.float32, (), dev)
    if overflow is not None:
        _tensor(overflow, "overflow", torch.bool, (m,), dev)
    return m, _temperature(f_t, 1, dev)


def check_draw(score, discard, gumbel, ids, f_t, base=None, overflow=None):
    """What E2 takes: a pass as :func:`check_slots` takes it, ``gumbel`` f32
    (m x 13,) at unit stride and ``ids`` int64 (m,) contiguous on its
    device. Returns (m, the temperature)."""
    m, temp = check_slots(score, discard, f_t, base, overflow)
    dev = score.device
    _tensor(gumbel, "gumbel", torch.float32, (m * N_OPS,), dev, contiguous=True)
    _tensor(ids, "ids", torch.int64, (m,), dev, contiguous=True)
    return m, temp


def check_catalogue(cands, m: int, dev):
    """What E2's dense entry copies the proposal from: the flat catalogue's
    11 int32 fields (m x 13, n) on ``dev`` at any strides. Returns n."""
    if len(cands) != N_FIELDS:
        raise ValueError(f"cands: need {N_FIELDS} fields, got {len(cands)}")
    n = cands[0].shape[-1] if cands[0].dim() == 2 else 0
    if n < 1:
        raise ValueError("cands: need (m x 13, n) fields with n >= 1")
    for k, x in enumerate(cands):
        _tensor(x, f"candidate field {k}", torch.int32, (m * N_OPS, n), dev)
    return n


def _check_rows(dst, rows, rows_valid, m: int, dev):
    """The state's mutable fields and the member rows E2 and E3 take
    (:func:`check_write`). Returns f_max."""
    if not isinstance(rows, torch.Tensor) or rows.dim() != 2 or rows.shape[0] != m \
            or rows.shape[1] < 1:
        raise ValueError(f"rows: need an ({m}, f_max) tensor, f_max >= 1")
    f_max = rows.shape[1]
    _tensor(rows, "rows", torch.int64, (m, f_max), dev, contiguous=True)
    _tensor(rows_valid, "rows_valid", torch.bool, (m, f_max), dev, contiguous=True)
    pos = dst["pos"]
    n = pos.shape[0] if isinstance(pos, torch.Tensor) and pos.dim() == 1 else 0
    if n < 1:
        raise ValueError("state: need (n,) fields with n >= 1")
    for name in MUTABLE_FIELDS:
        _tensor(dst[name], f"state.{name}", torch.int32, (n,), dev)
    return f_max


def check_commit(state, g_star, dev):
    """What E3's dense entry selects between: ``state``'s and ``g_star``'s
    11 int32 fields (n,) on ``dev``, at any strides. Returns n."""
    if len(state) != N_FIELDS or len(g_star) != N_FIELDS:
        raise ValueError(f"state / g_star: need {N_FIELDS} fields each")
    n = state[0].shape[0] if state[0].dim() == 1 else 0
    if n < 1:
        raise ValueError("state: need (n,) fields with n >= 1")
    for k, (x, y) in enumerate(zip(state, g_star)):
        _tensor(x, f"state field {k}", torch.int32, (n,), dev)
        _tensor(y, f"g_star field {k}", torch.int32, (n,), dev)
    return n


def check_write(dst, minis, rows, rows_valid, m: int, dev):
    """What E2's delta entry writes: ``dst`` the state's 8 mutable int32
    fields (n,) by name (``MUTABLE_FIELDS``), at any strides; ``minis`` the
    candidates' 8 fields (m, 13, f_max) int32 at any strides; ``rows`` int64
    and ``rows_valid`` bool (m, f_max), contiguous; all on ``dev``. Returns
    f_max."""
    f_max = _check_rows(dst, rows, rows_valid, m, dev)
    for name in MUTABLE_FIELDS:
        _tensor(minis[name], f"candidate field {name}", torch.int32, (m, N_OPS, f_max), dev)
    return f_max


def check_restore(dst, rows, rows_valid, undo, n_in, m: int, dev):
    """What E3's delta entry restores: ``dst``, ``rows`` and ``rows_valid``
    as :func:`check_write` takes them, ``undo`` contiguous int32 (8, f_max)
    (E2's saved values) and ``n_in`` an int64 0-d tensor (E1's contig count
    before the move). Returns f_max."""
    f_max = _check_rows(dst, rows, rows_valid, m, dev)
    _tensor(undo, "undo", torch.int32, (N_MUTABLE, f_max), dev, contiguous=True)
    _tensor(n_in, "n_in", torch.int64, (), dev)
    return f_max


def check_forward(fwd, dev, delta: bool):
    """E2's outputs as E3 takes them: ``omega`` int64, ``ll_star``,
    ``p_fwd``, ``sw`` and ``mx`` f32, and on the delta path ``ok`` bool, each
    a 0-d tensor on ``dev``."""
    _tensor(fwd.omega, "omega", torch.int64, (), dev)
    for name in ("ll_star", "p_fwd", "sw", "mx"):
        _tensor(getattr(fwd, name), name, torch.float32, (), dev)
    if delta:
        _tensor(fwd.ok, "ok", torch.bool, (), dev)


def check_accept(score, discard, fwd, l_t, u, f_t, overflow=None):
    """What E3 takes: the backward pass as :func:`check_slots` takes it
    (with ``overflow``: the delta path, whose base is E2's ``ll_star``), E2's
    outputs (:func:`check_forward`), and ``l_t`` and ``u`` f32 0-d tensors on
    its device. Returns (m, the temperature)."""
    delta = overflow is not None
    m, temp = check_slots(score, discard, f_t, fwd.ll_star if delta else None, overflow)
    dev = score.device
    check_forward(fwd, dev, delta)
    _tensor(l_t, "l_t", torch.float32, (), dev)
    _tensor(u, "u", torch.float32, (), dev)
    return m, temp


def _ptr(x):
    return None if x is None else x.data_ptr()


def _slots(score, discard, temp, variant, base=None, overflow=None):
    """(keep, Slots) of a checked pass: contiguous copies (when they are
    copies) live in ``keep`` until the launch is queued."""
    if variant not in ("mtm", "mh"):
        raise ValueError(f"variant: need 'mtm' or 'mh', got {variant!r}")
    score, discard = score.contiguous(), discard.contiguous()
    overflow = None if overflow is None else overflow.contiguous()
    ft, _, ft_inv = temp
    thresh = MH_THRESH_OVERFLOW if variant == "mh" else MTM_THRESH_OVERFLOW
    keep = [score, discard, overflow, ft]
    return keep, Slots(score=score.data_ptr(), base=_ptr(base), discard=discard.data_ptr(),
                       overflow=_ptr(overflow), ft=_ptr(ft), ft_inv=ft_inv, thresh=thresh,
                       mh=int(variant == "mh"), S=score.numel())


class MoveKernels(Counted):
    """The MTM / MH step kernels E1-E3 on a card; see the module docstring.
    ``n_launches`` counts the launches on the card, by kind (``KINDS``,
    ``ops.counts``)."""

    def __init__(self):
        self.launches = LaunchCount()

    @staticmethod
    def _device(x):
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA MTM kernels need tensors on a card, not on {dev}")
        return dev

    def _launch(self, kind, dev, rc):
        if rc != 0:
            raise RuntimeError(f"mtm {kind} launch failed: cudaError {rc}")
        self.launches.add(dev, kind)

    @staticmethod
    def _stream(dev):
        return torch.cuda.current_stream(dev).cuda_stream

    def set(self, fields, f_a, frags, mask_pivot, given=None):
        """E1: (ids int64 (m,), valid bool (m,), discard bool (m, 13), max_id
        int32 (), n_contigs int64 ()); in the mask-only mode (``given``) the
        ids and validity are ``given``'s."""
        dev = self._device(fields["pos"])
        n, delta, m = check_set(fields, f_a, frags, mask_pivot, given)
        lib = load_library()
        full = given is None
        ids = torch.empty(m, dtype=torch.int64, device=dev) if full else given[0]
        valid = torch.empty(m, dtype=torch.bool, device=dev) if full else given[1]
        discard = torch.empty((m, N_OPS), dtype=torch.bool, device=dev)
        max_id = torch.empty((), dtype=torch.int32, device=dev)
        n_contigs = torch.empty((), dtype=torch.int64, device=dev)
        a = SetArgs(field=(_P * 4)(*[fields[f].data_ptr() for f in SET_FIELDS]),
                    stride=(_I64 * 4)(*[fields[f].stride(0) for f in SET_FIELDS]),
                    frags=frags.data_ptr(), fa=_ptr(f_a), mp=mask_pivot.data_ptr(),
                    ids_in=None if full else ids.data_ptr(),
                    valid_in=None if full else valid.data_ptr(),
                    ids=ids.data_ptr() if full else None, valid=valid.data_ptr() if full else None,
                    discard=discard.data_ptr(), max_id=max_id.data_ptr(),
                    n_contigs=n_contigs.data_ptr(), n=n, delta=delta, m=m)
        self._launch("set", dev, lib.mtm_set(ctypes.byref(a), self._stream(dev)))
        return ids, valid, discard, max_id, n_contigs

    def _draw(self, variant, score, discard, gumbel, ids, f_t, base, overflow, fill):
        """E2 with the entry's own fields filled in by ``fill(args)``:
        (omega, f_star, ll_star, p_fwd, sw, mx, ok or None)."""
        dev = self._device(score)
        m, temp = check_draw(score, discard, gumbel, ids, f_t, base, overflow)
        keep, slots = _slots(score, discard, temp, variant, base, overflow)
        idx = torch.empty(2, dtype=torch.int64, device=dev)
        fl = torch.empty(4, dtype=torch.float32, device=dev)
        ok = None if base is None else torch.empty((), dtype=torch.bool, device=dev)
        a = DrawArgs(s=slots, gumbel=gumbel.data_ptr(), ids=ids.data_ptr(),
                     omega=idx[0].data_ptr(), f_star=idx[1].data_ptr(),
                     ll_star=fl[0].data_ptr(), p_fwd=fl[1].data_ptr(), sw=fl[2].data_ptr(),
                     mx=fl[3].data_ptr(), ok=_ptr(ok), m=m)
        fill(a)
        lib = load_library()
        self._launch("draw", dev, lib.mtm_draw(ctypes.byref(a), self._stream(dev)))
        del keep
        return idx[0], idx[1], fl[0], fl[1], fl[2], fl[3], ok

    def draw_dense(self, variant, score, discard, gumbel, ids, f_t, cands):
        """E2 on the dense step: (g* as 11 fields (n,), views of one (11, n)
        buffer; omega, f_star, ll_star, p_fwd, sw, mx)."""
        dev = self._device(score)
        n = check_catalogue(cands, score.shape[0] if score.dim() == 2 else 0, dev)
        g_star = torch.empty((N_FIELDS, n), dtype=torch.int32, device=dev)

        def fill(a):
            a.cand = (_P * N_FIELDS)(*[x.data_ptr() for x in cands])
            a.cs_k = (_I64 * N_FIELDS)(*[x.stride(0) for x in cands])
            a.cs_i = (_I64 * N_FIELDS)(*[x.stride(1) for x in cands])
            a.g_star = g_star.data_ptr()
            a.n = n

        out = self._draw(variant, score, discard, gumbel, ids, f_t, None, None, fill)
        return (g_star.unbind(0),) + out[:6]

    def draw_delta(self, variant, score, l_t, overflow, discard, gumbel, ids, f_t, minis, rows,
                   rows_valid, dst):
        """E2 on the delta step: writes the chosen mini-state's valid rows
        into ``dst`` (the 8 mutable fields by name, (n,), in place); returns
        (undo (8, f_max) int32: the values overwritten, at the rows' slots;
        omega, f_star, ll_star, p_fwd, sw, mx, ok)."""
        dev = self._device(score)
        m = score.shape[0] if score.dim() == 2 else 0
        f_max = check_write(dst, minis, rows, rows_valid, m, dev)
        undo = torch.empty((N_MUTABLE, f_max), dtype=torch.int32, device=dev)

        def fill(a):
            cand = [minis[f] for f in MUTABLE_FIELDS]
            a.mini = (_P * N_MUTABLE)(*[x.data_ptr() for x in cand])
            a.ms_j = (_I64 * N_MUTABLE)(*[x.stride(0) for x in cand])
            a.ms_o = (_I64 * N_MUTABLE)(*[x.stride(1) for x in cand])
            a.ms_i = (_I64 * N_MUTABLE)(*[x.stride(2) for x in cand])
            a.dst = (_P * N_MUTABLE)(*[dst[f].data_ptr() for f in MUTABLE_FIELDS])
            a.ds_i = (_I64 * N_MUTABLE)(*[dst[f].stride(0) for f in MUTABLE_FIELDS])
            a.rows, a.rows_valid, a.undo = rows.data_ptr(), rows_valid.data_ptr(), undo.data_ptr()
            a.f_max = f_max

        out = self._draw(variant, score, discard, gumbel, ids, f_t, l_t, overflow, fill)
        return (undo,) + out

    def _accept(self, variant, score, discard, fwd, l_t, u, f_t, corrected, overflow, fill):
        """E3 with the entry's own fields filled in by ``fill(args)``:
        (l_out, accepted, n_contigs, ratio)."""
        dev = self._device(score)
        _, temp = check_accept(score, discard, fwd, l_t, u, f_t, overflow)
        delta = overflow is not None
        keep, slots = _slots(score, discard, temp, variant, fwd.ll_star if delta else None,
                             overflow)
        fl = torch.empty(2, dtype=torch.float32, device=dev)
        accepted = torch.empty((), dtype=torch.bool, device=dev)
        n_contigs = torch.empty((), dtype=torch.int64, device=dev)
        a = AcceptArgs(s=slots, l_t=l_t.data_ptr(), u=u.data_ptr(), omega=fwd.omega.data_ptr(),
                       ll_star=fwd.ll_star.data_ptr(), p_fwd=fwd.p_fwd.data_ptr(),
                       sw=fwd.sw.data_ptr(), mx=fwd.mx.data_ptr(),
                       ok=fwd.ok.data_ptr() if delta else None, corrected=int(bool(corrected)),
                       l_out=fl[0].data_ptr(), accepted=accepted.data_ptr(),
                       n_contigs=n_contigs.data_ptr(), ratio=fl[1].data_ptr())
        fill(a)
        lib = load_library()
        self._launch("accept", dev, lib.mtm_accept(ctypes.byref(a), self._stream(dev)))
        del keep
        return fl[0], accepted, n_contigs, fl[1]

    def accept_dense(self, variant, score, discard, fwd, g_star, state, l_t, u, f_t, corrected):
        """E3 on the dense step: (the new state as 11 fields (n,), views of
        one (11, n) buffer: g* where accepted, else ``state``; l_out,
        accepted, n_contigs, ratio)."""
        dev = self._device(score)
        n = check_commit(state, g_star, dev)
        out = torch.empty((N_FIELDS, n), dtype=torch.int32, device=dev)

        def fill(a):
            a.gs = (_P * N_FIELDS)(*[x.data_ptr() for x in g_star])
            a.gs_i = (_I64 * N_FIELDS)(*[x.stride(0) for x in g_star])
            a.st = (_P * N_FIELDS)(*[x.data_ptr() for x in state])
            a.st_i = (_I64 * N_FIELDS)(*[x.stride(0) for x in state])
            a.out, a.n = out.data_ptr(), n

        got = self._accept(variant, score, discard, fwd, l_t, u, f_t, corrected, None, fill)
        return (out.unbind(0),) + got

    def accept_delta(self, variant, score, overflow, discard, fwd, dst, rows, rows_valid, undo,
                     n_in, l_t, u, f_t, corrected):
        """E3 on the delta step: restores ``undo`` into ``dst`` (as E2 wrote
        it, the 8 mutable fields by name) at the chosen neighbour's valid
        rows when the step is rejected; returns (l_out, accepted, n_contigs
        from ``n_in``, ratio)."""
        dev = self._device(score)
        m = score.shape[0] if score.dim() == 2 else 0
        f_max = check_restore(dst, rows, rows_valid, undo, n_in, m, dev)

        def fill(a):
            a.dst = (_P * N_MUTABLE)(*[dst[f].data_ptr() for f in MUTABLE_FIELDS])
            a.ds_i = (_I64 * N_MUTABLE)(*[dst[f].stride(0) for f in MUTABLE_FIELDS])
            a.rows, a.rows_valid, a.undo = rows.data_ptr(), rows_valid.data_ptr(), undo.data_ptr()
            a.n_in, a.f_max = n_in.data_ptr(), f_max

        return self._accept(variant, score, discard, fwd, l_t, u, f_t, corrected, overflow, fill)


MOVE = MoveKernels()
