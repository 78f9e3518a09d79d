"""A captured cycle's per-step inputs, outputs and carry: hand-written CUDA
kernels for Hopper.

A ``core.graphs.Scan`` step's body reads its per-step inputs from fixed
slots and returns its outputs and new carry. H2 (``load``) copies row
``idx`` of every per-step input buffer into its slot: once a call, before
the call's first step. H3 (``step``) then runs once a step, after the
body: it writes every per-step output into row ``idx`` of its buffer,
copies every new carry leaf that is not its buffer into it, copies row
``idx + 1`` of every per-step input into its slot (while that row is below
the buffers' capacity), and sets ``idx += 1``. So a captured step is the
body and one launch. They are the port of what ``lax.scan`` does inside
the JAX package's cycles (slice, stack, alias), for which the JAX package
has no Pallas kernel. The kernel source is
``graal_tpu_torch/csrc/scan_io.cu``; its header says what bounds them on
the card, how the design answers that, and how the step index advances
(the block that finishes last writes it).

The plain versions, :func:`scan_load_plain` and :func:`scan_store_plain`,
are the scan's step as it was: one ``index_select`` an input, one
``index_copy_`` an output, one ``copy_`` a new carry leaf. A step of the
card's route equals ``scan_store_plain`` followed by ``scan_load_plain``
of the next row. Unlike ``copy_``, the kernels convert no dtype: a new
carry leaf must have its buffer's dtype on a card.

Each copy is an entry of a table of (source, destination, bytes) built from
the tensors' addresses (:func:`load_tables`, :func:`step_tables`): once at
a capture, each step when the body runs eagerly. A launch takes its table
by value; :func:`table` cuts each entry into warp units of UNIT_WORDS
words, at most MAX_WARPS units a block (a launch as few blocks as hold
them, :func:`blocks`, :func:`warps`), and a warp finds its entry by a
binary search of the table's ``first`` column. An output or new carry leaf that lies in
a per-step slot (the dense EM body returns its f_a slot as a metric) is
read from the slot's input buffer at row ``idx`` instead, which nothing in
the launch writes. Where one entry touches bytes another writes, the plain
version's order decides the result, so the table is cut there into
launches that run in order (:func:`segments`). Every launch adds one to its
kind's counter on the card itself.

:data:`SCAN` is the one wrapper: ``core.graphs.Scan`` sends a card's steps
to it and a CPU's to the plain versions; the wrapper itself refuses tensors
that are not on a card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from graal_tpu_torch.ops import build
from graal_tpu_torch.ops.counts import Counted, LaunchCount

MAX_ENTRIES = 64      # entries of one launch's table (scan_io.cu)
UNIT_WORDS = 128      # words a warp copies, at most (scan_io.cu)
MAX_WARPS = 32        # warps (units) a block, at most (scan_io.cu)
NO_ENTRY = 2**31 - 1  # the first column past the table's entries
KINDS = ("load", "store")   # H2 (a call's first load), H3 (a step): the launch keys

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class Entry(ctypes.Structure):
    _fields_ = [("src", _P), ("dst", _P), ("src_step", _I64), ("dst_step", _I64),
                ("outer_stride", _I64), ("inner", _I64), ("outer", _I32), ("log_w", _I32)]


class Table(ctypes.Structure):
    _fields_ = [("step_in", _P), ("step_out", _P), ("ticket", _P), ("load_last", _I64),
                ("counter", _P), ("n", _I32), ("n_units", _I32), ("first_load", _I32),
                ("pad", _I32), ("first", _I32 * MAX_ENTRIES), ("e", Entry * MAX_ENTRIES)]


@functools.cache
def load_library():
    """The kernel library (built at first use), its C functions typed and
    its table checked against the ctypes mirror."""
    lib = build.load("scan_io")
    for name, want in (("scan_table_size", ctypes.sizeof(Table)),
                       ("scan_max_entries", MAX_ENTRIES), ("scan_unit_words", UNIT_WORDS),
                       ("scan_max_warps", MAX_WARPS)):
        fn = getattr(lib, name)
        fn.restype = _I32
        if fn() != want:
            raise RuntimeError(f"scan_io.cu and ops/scan_cuda.py disagree on {name}: "
                               f"{fn()} != {want}")
    for name in ("scan_load", "scan_store"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P]
        fn.restype = _I32
    return lib


# ---- the plain versions ----------------------------------------------------

def scan_load_plain(x_bufs, idx):
    """Row ``idx`` (a (1,) int64 tensor) of every per-step input buffer, as
    new tensors."""
    return [b.index_select(0, idx)[0] for b in x_bufs]


def scan_store_plain(y_bufs, ys, carry_bufs, new, idx):
    """Write every output ``ys`` into row ``idx`` of its buffer, copy every
    new carry leaf that is not its buffer into it (in order, converting its
    dtype), then ``idx += 1``."""
    for b, v in zip(y_bufs, ys):
        b.index_copy_(0, idx, v.reshape((1,) + tuple(b.shape[1:])))
    for b, v in zip(carry_bufs, new):
        if v is not b:
            b.copy_(v)
    idx.add_(1)


# ---- tables (pure functions: no launch, any device) ------------------------

def runs(x: torch.Tensor):
    """A tensor's bytes as (outer, outer_stride, inner): ``outer`` runs of
    ``inner`` contiguous bytes, ``outer_stride`` bytes apart, in the
    tensor's element order. Raises ValueError for a layout that needs more
    than two levels."""
    el = x.element_size()
    dims = []   # (size, stride) from the innermost, size-1 dims dropped, contiguous ones merged
    for size, stride in reversed(list(zip(x.shape, x.stride()))):
        if size == 1:
            continue
        if dims and dims[-1][1] * dims[-1][0] == stride:
            dims[-1] = (dims[-1][0] * size, dims[-1][1])
        else:
            dims.append((size, stride))
    if not dims:
        return 1, 0, el
    if dims[0][1] == 1:
        inner, rest = dims[0][0] * el, dims[1:]
    else:
        inner, rest = el, dims
    if len(rest) > 1:
        raise ValueError(f"a scan leaf of shape {tuple(x.shape)} and strides {x.stride()} "
                         "is not two levels of runs")
    return (rest[0][0], rest[0][1] * el, inner) if rest else (1, 0, inner)


def _span(ptr, outer, outer_stride, inner):
    return ptr, ptr + (outer - 1) * outer_stride + inner


def _overlap(a, b):
    return a[0] < b[1] and b[0] < a[1]


def entry(src: torch.Tensor, dst: torch.Tensor, src_step=0, src_rows=1, dst_step=0,
          dst_rows=1, src_at=None):
    """One copy of ``src``'s elements (any layout :func:`runs` takes) into
    the contiguous bytes at ``dst`` (a contiguous tensor; with ``dst_step``
    its rows of ``dst_step`` bytes, ``dst_rows`` of them, one written a
    step), with ``src`` advanced ``src_step`` bytes a step (``src_rows``
    rows of them). ``src_at``: (address, (first, end)) to read ``src``'s
    layout from another address, and the bytes those reads may touch (a
    slot's bytes read from its input buffer). Returns a dict with the
    entry's fields and the bytes it may read and write, or None when it
    copies nothing."""
    outer, ostride, inner = runs(src)
    n = outer * inner
    if n == 0:
        return None
    if outer > NO_ENTRY:
        raise ValueError(f"a scan leaf of {outer} runs: the kernels take at most {NO_ENTRY}")
    sp, dp = src.data_ptr(), dst.data_ptr()
    if src_at is not None:
        sp, read = src_at
    elif src_step:
        read = (sp, sp + src_rows * src_step)
    else:
        read = _span(sp, outer, ostride, inner)
    parts = [sp, dp, inner, src_step, dst_step] + ([ostride] if outer > 1 else [])
    w = 16
    while w > 1 and any(p % w for p in parts):
        w //= 2
    write = (dp, dp + dst_rows * dst_step) if dst_step else (dp, dp + n)
    return dict(src=sp, dst=dp, src_step=src_step, dst_step=dst_step, outer=outer,
                outer_stride=ostride, inner=inner, log_w=int(math.log2(w)), words=n // w,
                read=read, write=write, load=False)


def segments(entries):
    """Cut ``entries`` (in the plain version's order) into runs whose
    entries touch disjoint bytes (no entry reads or writes what another of
    its run writes) and that fit one table: launched in order, they give
    the plain version's sequential result. An entry whose source overlaps
    its own destination raises ValueError."""
    out, cur = [], []
    for e in entries:
        if _overlap(e["read"], e["write"]):
            raise ValueError("a scan copy reads bytes it writes: its source overlaps its "
                             "destination")
        clash = any(_overlap(e["write"], o["read"]) or _overlap(e["read"], o["write"])
                    or _overlap(e["write"], o["write"]) for o in cur)
        if cur and (clash or len(cur) == MAX_ENTRIES):
            out.append(cur)
            cur = []
        cur.append(e)
    if cur or not out:
        out.append(cur)
    return out


def table(entries, step_in: torch.Tensor, step_out=None, ticket=None, load_last=-1) -> Table:
    """The kernel's table of one launch: its entries' warp units laid out
    in order, UNIT_WORDS words a unit, each entry's first unit in the
    ``first`` column (NO_ENTRY past the entries); the launch has
    :func:`blocks` blocks of :func:`warps` units. Load entries (the last
    of the launch) copy only at a step <= ``load_last``. ``step_out``: the
    cell set to ``*step_in + 1`` once every block has read it (in a launch
    of more blocks than one by the block that finishes last, counting the
    finished blocks in ``ticket``). The counter is set at launch."""
    if step_out is not None and ticket is None:
        raise ValueError("a table that advances the step needs its ticket cell")
    loads = [e["load"] for e in entries]
    first_load = loads.index(True) if True in loads else len(entries)
    if not all(loads[first_load:]):
        raise ValueError("a table's load entries must come after its other entries")
    t = Table(step_in=step_in.data_ptr(),
              step_out=None if step_out is None else step_out.data_ptr(),
              ticket=None if ticket is None else ticket.data_ptr(), load_last=load_last,
              n=len(entries), first_load=first_load)
    unit = 0
    for j, e in enumerate(entries):
        t.e[j] = Entry(src=e["src"], dst=e["dst"], src_step=e["src_step"],
                       dst_step=e["dst_step"], outer_stride=e["outer_stride"], inner=e["inner"],
                       outer=e["outer"], log_w=e["log_w"])
        t.first[j] = unit
        unit += -(-e["words"] // UNIT_WORDS)
    for j in range(len(entries), MAX_ENTRIES):
        t.first[j] = NO_ENTRY
    t.n_units = unit
    return t


def blocks(t: Table) -> int:
    """The blocks of a launch of ``t`` (scan_io.cu ``launch_blocks``): as
    few as hold its units at MAX_WARPS a block, one for none."""
    return max(-(-t.n_units // MAX_WARPS), 1)


def warps(t: Table) -> int:
    """The warps a block of a launch of ``t`` (``launch_warps``): its units
    spread evenly over :func:`blocks`, one for none."""
    return max(-(-t.n_units // blocks(t)), 1)


def check_same(label, b: torch.Tensor, v):
    if not isinstance(v, torch.Tensor):
        raise ValueError(f"{label}: need a tensor, got {type(v).__name__}")
    if v.device != b.device or v.dtype != b.dtype:
        raise ValueError(f"{label}: need {b.dtype} on {b.device} (the kernels convert no "
                         f"dtype), got {v.dtype} on {v.device}")


def _row_bytes(b: torch.Tensor) -> int:
    return b.stride(0) * b.element_size()


def load_entries(x_bufs, slots, shift):
    """Row ``idx + shift`` of each per-step input buffer (contiguous,
    (capacity, ...)) into its slot (contiguous, one row's shape)."""
    entries = []
    for b, s in zip(x_bufs, slots):
        check_same("per-step slot", b, s)
        if not (b.is_contiguous() and s.is_contiguous()) or b[0].numel() != s.numel():
            raise ValueError("per-step buffers and slots must be contiguous, a slot one row")
        row = _row_bytes(b)
        base = b.data_ptr()
        e = entry(b[0], s, src_step=row,
                  src_at=(base + shift * row, (base, base + b.shape[0] * row)))
        if e is not None:
            entries.append(dict(e, load=True))
    return entries


def _source(v: torch.Tensor, x_bufs, slots):
    """``entry``'s source arguments for a store of ``v``: where v's bytes lie
    in a per-step slot, the same bytes in the slot's input buffer at row
    ``idx`` (row 0's address plus v's offset in the slot, a row a step, the
    whole buffer read); else v itself."""
    if v.numel():
        outer, ostride, inner = runs(v)
        first, end = _span(v.data_ptr(), outer, ostride, inner)
        for b, s in zip(x_bufs, slots):
            lo = s.data_ptr()
            if lo <= first and end <= lo + s.numel() * s.element_size():
                base, row = b.data_ptr(), _row_bytes(b)
                return dict(src_step=row, src_at=(base + first - lo,
                                                  (base, base + b.shape[0] * row)))
    return {}


def load_tables(x_bufs, slots, idx):
    """H2's tables: row ``idx`` of each per-step input buffer into its slot
    (a call's first step: idx is 0). One launch but past MAX_ENTRIES
    inputs."""
    cap = x_bufs[0].shape[0] if x_bufs else 0
    return [table(seg, idx, load_last=cap - 1) for seg in segments(load_entries(x_bufs, slots, 0))]


def step_tables(y_bufs, ys, carry_bufs, new, x_bufs, slots, idx, ticket):
    """H3's tables of one step, in the plain sequence's order: each output
    into row ``idx`` of its buffer, each new carry leaf that is not its
    buffer into it (a source that lies in a per-step slot read from the
    slot's input buffer at row ``idx``), then row ``idx + 1`` of each
    per-step input into its slot while ``idx + 1`` is below the buffers'
    capacity; the last launch sets idx += 1 (see :func:`table`). One launch
    where no copies touch each other's bytes and the entries fit one
    table."""
    entries = []
    for b, v in zip(y_bufs, ys):
        check_same("per-step output", b, v)
        if not b.is_contiguous() or v.numel() != b[0].numel():
            raise ValueError(f"a per-step output of {v.numel()} elements for rows of "
                             f"{b[0].numel()}")
        e = entry(v, b, dst_step=_row_bytes(b), dst_rows=b.shape[0],
                  **_source(v, x_bufs, slots))
        if e is not None:
            entries.append(e)
    for b, v in zip(carry_bufs, new):
        if v is b:
            continue
        check_same("new carry leaf", b, v)
        if not b.is_contiguous() or v.shape != b.shape:
            raise ValueError("carry buffers must be contiguous and keep their shapes")
        e = entry(v, b, **_source(v, x_bufs, slots))
        if e is not None and not (e["read"] == e["write"] and v.is_contiguous()):
            entries.append(e)
    segs = segments(entries + load_entries(x_bufs, slots, 1))
    cap = x_bufs[0].shape[0] if x_bufs else 0
    return [table(seg, idx, idx if k == len(segs) - 1 else None,
                  ticket if k == len(segs) - 1 else None, cap - 2)
            for k, seg in enumerate(segs)]


class ScanKernels(Counted):
    """The captured cycle's load and step kernels H2 / H3 on a card; see
    the module docstring. ``n_launches`` counts the launches on the card,
    by kind (``KINDS``, ``ops.counts``): each kernel adds one to its kind's
    counter itself."""

    def __init__(self):
        self.launches = LaunchCount()

    @staticmethod
    def _card(dev):
        if dev.type != "cuda":
            raise ValueError(f"the CUDA scan kernels need tensors on a card, not on {dev}")

    def _launch(self, kind, dev, t: Table):
        lib = load_library()
        fn = lib.scan_load if kind == "load" else lib.scan_store
        t.counter = self.launches.counter(dev, kind).data_ptr()
        rc = fn(ctypes.byref(t), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"scan {kind} launch failed: cudaError {rc}")

    def load(self, x_bufs, slots, idx, tables=None):
        """H2 (see :func:`load_tables`): a call's first load, one launch
        (more only past MAX_ENTRIES inputs). ``tables``: this load's tables
        built before (a Scan builds them once for its buffers), else built
        here."""
        self._card(idx.device)
        for t in load_tables(x_bufs, slots, idx) if tables is None else tables:
            self._launch("load", idx.device, t)

    def step(self, y_bufs, ys, carry_bufs, new, x_bufs, slots, idx, ticket):
        """H3 (see :func:`step_tables`): a step's stores and the next step's
        loads, one launch, more where copies overlap or past MAX_ENTRIES
        entries. The tensors must stay alive until the launches run (the
        scan's buffers, and the body's outputs, which the caller holds)."""
        self._card(idx.device)
        for t in step_tables(y_bufs, ys, carry_bufs, new, x_bufs, slots, idx, ticket):
            self._launch("store", idx.device, t)


SCAN = ScanKernels()
