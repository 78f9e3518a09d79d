"""The delta engine's member rows and mini-states: hand-written CUDA kernels
for Hopper.

G1 (the counts) and G2 (the ordered write) compute what
``core.delta.extract_rows_each_plain`` (mode "each") and
``extract_rows_union_plain`` (mode "union") compute, with each chain's
largest contig id beside them; G3 computes ``gather_mini_plain``. They are
the port of ``graal_tpu/core/delta.py`` ``extract_rows``,
``extract_rows_union`` and ``gather_mini``, for which the JAX package has
no Pallas kernel: XLA fuses their jnp code (its ``top_k``s lowered to
sorts) inside the jitted step. The kernel source is
``graal_tpu_torch/csrc/rows.cu``; its header says what bounds them on the
card and how the design answers that. An extraction is two launches and a
gather one, on the current stream, with no synchronisation and no host
read, into fresh outputs and scratch, so a captured step
(``core.graphs.Scan``) captures them. Each kernel counts its own launches
on its key's counter.

:data:`ROWS` is the one wrapper: ``core.delta`` sends tensors on a card to
it and any others to the plain versions; the wrapper itself refuses
tensors that are not on a card. :func:`check_extract` and
:func:`check_gather` are what the kernels take, checked without touching
the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
import numbers

import torch

from graal_tpu_torch.ops import build
from graal_tpu_torch.ops.counts import Counted, LaunchCount

THREADS = 256
CHUNK = 2048          # genome rows a G1 / G2 block walks, at least
MAX_CHUNKS = 128      # ... and more once the genome would need more chunks
MAX_KEYS = 4096       # m + 1 contig keys a chain, fA's and one a neighbour slot (D2 takes
                      # at most 4,095 slots, E1 64)
N_FIELDS = 11
MAX_GRID_YZ = 65535
KINDS = ("counts", "write", "gather")   # G1, G2, G3: the launch keys

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class RowsArgs(ctypes.Structure):
    _fields_ = [("id_c", _P), ("f_a", _P), ("ids", _P), ("counts", _P), ("cmax", _P),
                ("skeys", _P), ("rows", _P), ("valid", _P), ("overflow", _P), ("max_id", _P),
                ("counts_counter", _P), ("write_counter", _P),
                ("id_cs", _I64), ("id_is", _I64), ("fa_s", _I64),
                ("C", _I32), ("m", _I32), ("n", _I32), ("f_max", _I32), ("chunk", _I32),
                ("n_chunks", _I32), ("union_mode", _I32), ("pad", _I32)]


class GatherArgs(ctypes.Structure):
    _fields_ = [("st", _P * N_FIELDS), ("st_cs", _I64 * N_FIELDS), ("st_is", _I64 * N_FIELDS),
                ("rows", _P), ("valid", _P), ("out", _P), ("counter", _P), ("C", _I32),
                ("m", _I32), ("f_max", _I32), ("pad", _I32)]


@functools.cache
def load_library():
    """The kernel library (built at first use), its C functions typed and
    its argument blocks checked against their ctypes mirrors."""
    lib = build.load("rows")
    for name, mirror in (("rows_args_size", RowsArgs), ("rows_gather_args_size", GatherArgs)):
        fn = getattr(lib, name)
        fn.restype = _I32
        if fn() != ctypes.sizeof(mirror):
            raise RuntimeError(f"rows.cu and ops/rows_cuda.py disagree on {mirror.__name__}: "
                               f"{fn()} != {ctypes.sizeof(mirror)} bytes")
    for name in ("rows_counts", "rows_write", "rows_gather"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P]
        fn.restype = _I32
    lib.rows_write_smem.argtypes = [_P]
    lib.rows_write_smem.restype = _I64
    lib.rows_init.argtypes = []
    lib.rows_init.restype = _I64
    return lib


SUMS_ALL = 2048      # G2 sums every place's counts where m + 1 places x n_chunks is at most this


def write_smem(m: int, union: bool, n_chunks: int) -> int:
    """G2's dynamic shared memory (bytes, csrc/rows.cu ``write_smem``): the
    sorted keys; with every place's three sums in union mode or where (m +
    1) n_chunks <= SUMS_ALL; in union mode a byte a place."""
    n_keys = m + 1
    every = union or n_keys * n_chunks <= SUMS_ALL
    return 4 * (n_keys + (3 * n_keys if every else 0)) + (n_keys if union else 0)


def chunk_size(n: int) -> int:
    """Genome rows a G1 / G2 block walks: CHUNK, or more (a multiple of
    THREADS) so that a genome takes at most MAX_CHUNKS chunks."""
    per = -(-n // MAX_CHUNKS)
    return max(CHUNK, -(-per // THREADS) * THREADS)


# ---- argument checks (pure functions: no launch, any device) -----------------

def _need(x, name, dtype, shape, dev):
    if not isinstance(x, torch.Tensor) or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != dev:
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}" if isinstance(x, torch.Tensor)
               else type(x).__name__)
        raise ValueError(f"{name}: need {dtype} {tuple(shape)} on {dev}, got {got}")


def check_extract(id_c, f_a, ids, f_max):
    """What G1 / G2 take: ``id_c`` int32 (C, n) at any strides, ``f_a``
    int64 (C,), ``ids`` int64 (C, m), all on one device, 1 <= f_max <= n,
    m + 1 <= MAX_KEYS, C and m at most 65,535; every index a row of the
    genome and no contig id -1 (not checked: that would read the card).
    Returns (C, m, n); raises ValueError on anything else."""
    if not isinstance(id_c, torch.Tensor) or id_c.dim() != 2:
        raise ValueError("id_c: need a (C, n) tensor")
    dev = id_c.device
    c, n = id_c.shape
    if not isinstance(ids, torch.Tensor) or ids.dim() != 2:
        raise ValueError("ids: need a (C, m) tensor")
    m = ids.shape[1]
    _need(id_c, "id_c", torch.int32, (c, n), dev)
    _need(f_a, "f_a", torch.int64, (c,), dev)
    _need(ids, "ids", torch.int64, (c, m), dev)
    if not 1 <= c <= MAX_GRID_YZ or not 1 <= m <= min(MAX_GRID_YZ, MAX_KEYS - 1):
        raise ValueError(f"need 1 <= C <= {MAX_GRID_YZ} and 1 <= m <= {MAX_KEYS - 1}, got C = "
                         f"{c}, m = {m}")
    if isinstance(f_max, bool) or not isinstance(f_max, numbers.Integral) \
            or not 1 <= f_max <= n:
        raise ValueError(f"f_max: need an int in [1, n = {n}], got {f_max!r}")
    return c, m, n


def check_gather(state, rows, valid):
    """What G3 takes: ``state``'s 11 fields (a GenomeState or a sequence in
    its order) int32 (C, n) at any strides, ``rows`` int64 (C, ..., f_max)
    (every entry a row of the genome, not checked) and ``valid`` bool of
    its shape, all on one device. Returns (C, slots, f_max) with slots the
    product of the middle axes; raises ValueError on anything else."""
    if not isinstance(rows, torch.Tensor) or rows.dim() < 2:
        raise ValueError("rows: need a (C, ..., f_max) tensor")
    dev = rows.device
    _need(rows, "rows", torch.int64, rows.shape, dev)
    _need(valid, "valid", torch.bool, rows.shape, dev)
    c, f_max = rows.shape[0], rows.shape[-1]
    slots = math.prod(rows.shape[1:-1])
    if len(state) != N_FIELDS:
        raise ValueError(f"state: need {N_FIELDS} fields, got {len(state)}")
    n = state[0].shape[-1] if isinstance(state[0], torch.Tensor) else 0
    for k, x in enumerate(state):
        _need(x, f"state field {k}", torch.int32, (c, n), dev)
    if c < 1 or slots < 1 or f_max < 1 or n < 1:
        raise ValueError(f"need C, slots, f_max, n >= 1, got {c}, {slots}, {f_max}, {n}")
    return c, slots, f_max


def extract_args(id_c, f_a, ids, f_max, union: bool, counters=None):
    """The argument block of one extraction (see :func:`check_extract`),
    the tensors it points into (kept alive until the launches are queued)
    and the outputs (rows (C, m, f_max) int64, valid (C, m, f_max) bool,
    overflow (C, m) bool, max_id (C,) int32), allocated on the call's
    device. The kernels take any chunk of at least one row;
    :func:`chunk_size` picks it. ``counters``: the int64s G1 and G2 add
    one to a launch (null without them: a launch refuses it)."""
    c, m, n = check_extract(id_c, f_a, ids, f_max)
    f_max = int(f_max)
    dev = id_c.device
    ids = ids.contiguous()
    chunk = chunk_size(n)
    n_chunks = -(-n // chunk)
    scratch = (torch.empty((c, m + 1, n_chunks), dtype=torch.int32, device=dev),
               torch.empty((c, n_chunks), dtype=torch.int32, device=dev),
               torch.empty((c, m + 1), dtype=torch.int32, device=dev))
    out = (torch.empty((c, m, f_max), dtype=torch.int64, device=dev),
           torch.empty((c, m, f_max), dtype=torch.bool, device=dev),
           torch.empty((c, m), dtype=torch.bool, device=dev),
           torch.empty((c,), dtype=torch.int32, device=dev))
    a = RowsArgs(id_c=id_c.data_ptr(), f_a=f_a.data_ptr(), ids=ids.data_ptr(),
                 counts=scratch[0].data_ptr(), cmax=scratch[1].data_ptr(),
                 skeys=scratch[2].data_ptr(),
                 rows=out[0].data_ptr(), valid=out[1].data_ptr(), overflow=out[2].data_ptr(),
                 max_id=out[3].data_ptr(),
                 counts_counter=None if counters is None else counters[0].data_ptr(),
                 write_counter=None if counters is None else counters[1].data_ptr(),
                 id_cs=id_c.stride(0), id_is=id_c.stride(1),
                 fa_s=f_a.stride(0), C=c, m=m, n=n, f_max=f_max, chunk=chunk,
                 n_chunks=n_chunks, union_mode=int(union), pad=0)
    return a, (id_c, f_a, ids, scratch, counters), out


def gather_args(state, rows, valid, counter=None):
    """The argument block of one gather (see :func:`check_gather`), the
    tensors it points into and the output (11, C, slots, f_max) int32;
    ``counter`` the int64 G3 adds one to a launch."""
    c, slots, f_max = check_gather(state, rows, valid)
    rows, valid = rows.contiguous(), valid.contiguous()
    out = torch.empty((N_FIELDS, c, slots, f_max), dtype=torch.int32, device=rows.device)
    fields = list(state)
    g = GatherArgs(st=(_P * N_FIELDS)(*[x.data_ptr() for x in fields]),
                   st_cs=(_I64 * N_FIELDS)(*[x.stride(0) for x in fields]),
                   st_is=(_I64 * N_FIELDS)(*[x.stride(1) for x in fields]),
                   rows=rows.data_ptr(), valid=valid.data_ptr(), out=out.data_ptr(),
                   counter=None if counter is None else counter.data_ptr(), C=c, m=slots,
                   f_max=f_max, pad=0)
    return g, (fields, rows, valid, counter), out


class RowKernels(Counted):
    """The member-row and mini-state kernels G1-G3 on a card; see the
    module docstring. ``n_launches`` counts the launches on the card, by
    kind (``KINDS``, ``ops.counts``): each kernel adds one to its kind's
    counter itself."""

    def __init__(self):
        self.launches = LaunchCount()

    @staticmethod
    def _launched(kind, rc):
        if rc != 0:
            raise RuntimeError(f"rows {kind} launch failed: cudaError {rc}")

    @staticmethod
    def _card(dev):
        if dev.type != "cuda":
            raise ValueError(f"the CUDA member-row kernels need tensors on a card, not on {dev}")

    def extract(self, id_c, f_a, ids, f_max: int, union: bool):
        """G1 then G2 (see :func:`check_extract`): each chain's neighbour
        slots' member rows in mode "union" (``extract_rows_union_plain``)
        or "each" (``extract_rows_each_plain``), and the chain's largest
        contig id: (rows (C, m, f_max) int64, valid (C, m, f_max) bool,
        overflow (C, m) bool, max_id (C,) int32)."""
        dev = id_c.device
        self._card(dev)
        a, keep, out = extract_args(id_c, f_a, ids, f_max, union,
                                    [self.launches.counter(dev, k) for k in KINDS[:2]])
        lib = load_library()
        need = lib.rows_write_smem(ctypes.byref(a))
        most = build.opted_in("rows", lib.rows_init, dev)
        if need > most:
            raise RuntimeError(f"G2 asks {need} bytes of shared memory, the device allows {most}")
        stream = torch.cuda.current_stream(dev).cuda_stream
        self._launched("counts", lib.rows_counts(ctypes.byref(a), stream))
        self._launched("write", lib.rows_write(ctypes.byref(a), stream))
        del keep
        return out

    def gather(self, state, rows, valid):
        """G3 (see :func:`check_gather`): the (11, C, slots, f_max) int32
        mini-state fields at ``rows``, padding rows inert singletons
        (``gather_mini_plain``'s values bit for bit)."""
        dev = rows.device
        self._card(dev)
        g, keep, out = gather_args(state, rows, valid, self.launches.counter(dev, "gather"))
        lib = load_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        self._launched("gather", lib.rows_gather(ctypes.byref(g), stream))
        del keep
        return out


ROWS = RowKernels()
