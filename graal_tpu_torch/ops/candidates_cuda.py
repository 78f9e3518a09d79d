"""The 13-candidate catalogues: a hand-written CUDA kernel for Hopper.

C1 builds the EM catalogue (``core.candidates.build_candidates``, the port
of ``graal_tpu/core/candidates.py`` ``build_candidates``) and C2 the
Metropolis-Hastings / MTM one (``mh_candidates``). The JAX package has no
Pallas kernel for them: XLA fuses their primitives inside the jitted step.
The kernel source is ``graal_tpu_torch/csrc/candidates.cu``; its header
says what bounds it on the card and how the design answers that. One call
is one launch (a thread block cluster a genome, :func:`plan`'s K blocks) on
the current stream, with no synchronisation and no host read, so a
captured step (``core.graphs.Scan``) captures it; the kernel adds one to
its launch key's counter itself.

:data:`CATALOGUE` is the one wrapper: ``core.candidates`` sends a CUDA
state to it and any other state to the plain versions beside the
catalogues; the wrapper itself refuses tensors that are not on a card.
"""

from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from graal_tpu_torch.ops import build
from graal_tpu_torch.ops.counts import Counted, LaunchCount

N_CANDIDATES = 13
N_FIELDS = 11
KINDS = ("em", "mh")      # C1, C2: the launch keys
MAX_GENOMES = 65535
MAX_CLUSTER = 8           # blocks a genome: the portable cluster size
THREADS = 256             # a block's threads, one a fragment of its chunk


@functools.cache
def load_library():
    """The kernel library (built at first use), its C functions typed."""
    lib = build.load("candidates")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.catalogue.argtypes = [i32, ptr, ptr, ptr, i32, i32, i32,  # mh, fields, strides, n, B, rows
                              ptr, i64, i64, i32,                  # f_a
                              ptr, i32,                            # f_b
                              ptr, i64, i64, i32, i32,             # max_id
                              ptr, ptr, i32,                       # counter, out, slots
                              i32, ptr]                            # cluster, stream
    lib.catalogue.restype = i32
    return lib


def plan(n: int) -> int:
    """K, the blocks of a genome's cluster for a state of ``n`` fragments:
    one block of THREADS a chunk of THREADS fragments, at most MAX_CLUSTER
    blocks; block r owns the chunks r, r + K, r + 2K, ..."""
    return min(MAX_CLUSTER, -(-n // THREADS))


def _index(x, name: str, b: int, dev):
    """(tensor, value, stride, is64) of an index or maximum given as a
    Python / numpy integer (no tensor: the value) or an int32 / int64
    tensor on ``dev`` holding one value (stride 0) or one a genome (the
    1-d tensor returned, read at its own stride)."""
    if isinstance(x, torch.Tensor):
        if x.device != dev:
            raise ValueError(f"{name}: need a tensor on {dev}, got one on {x.device}")
        if x.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{name}: need int32 or int64, got {x.dtype}")
        if x.numel() not in (1, b):
            raise ValueError(f"{name}: need one value or {b}, got shape {tuple(x.shape)}")
        flat = x.reshape(-1)
        stride = flat.stride(0) if flat.numel() > 1 else 0
        return flat, 0, stride, int(x.dtype == torch.int64)
    if isinstance(x, numbers.Integral) and not isinstance(x, bool):
        return None, int(x), 0, 0
    raise ValueError(f"{name}: need an integer or an integer tensor, got {type(x).__name__}")


def check_args(kind: str, state, f_a, f_b, max_id):
    """What the kernel takes, checked without touching the card: ``kind``
    "em" or "mh"; 11 int32 state fields on one device, each (n,) or (B, n)
    with B = 1 or m, at any strides; ``f_b`` a contiguous int32 /
    int64 (m,) tensor on that device; ``f_a`` and ``max_id`` (None allowed)
    as :func:`_index` takes them. Returns (n, m, state rows, (row strides,
    fragment strides), f_a, max_id) with the indices as :func:`_index`
    gives them; raises ValueError on anything else."""
    if kind not in KINDS:
        raise ValueError(f"kind: need one of {KINDS}, got {kind!r}")
    if len(state) != N_FIELDS:
        raise ValueError(f"state: need {N_FIELDS} fields, got {len(state)}")
    if not isinstance(f_b, torch.Tensor) or f_b.dim() != 1:
        raise ValueError("f_b: need a 1-d tensor of neighbour indices")
    m = f_b.shape[0]
    if not 1 <= m <= MAX_GENOMES:
        raise ValueError(f"f_b: need 1 to {MAX_GENOMES} neighbours, got {m}")
    dev = state[0].device
    n = state[0].shape[-1] if state[0].dim() else 0
    if n < 1:
        raise ValueError("state: no fragment")
    strides, steps = [], []
    for k, x in enumerate(state):
        if x.device != dev or x.dtype != torch.int32:
            raise ValueError(f"state field {k}: need int32 on {dev}, got {x.dtype} on {x.device}")
        if x.dim() not in (1, 2) or x.shape[-1] != n or (x.dim() == 2 and
                                                         x.shape[0] not in (1, m)):
            raise ValueError(f"state field {k}: need ({n},) or (B, {n}) with B in (1, {m}), "
                             f"got {tuple(x.shape)}")
        strides.append(x.stride(0) if x.dim() == 2 and x.shape[0] > 1 else 0)
        steps.append(x.stride(-1))
    rows = m if any(strides) else 1
    if f_b.device != dev or f_b.dtype not in (torch.int32, torch.int64) \
            or not f_b.is_contiguous():
        raise ValueError(f"f_b: need contiguous int32 or int64 on {dev}, "
                         f"got {f_b.dtype} on {f_b.device}")
    fa = _index(f_a, "f_a", m, dev)
    if fa[0] is None and not 0 <= fa[1] < n:
        raise ValueError(f"f_a: {fa[1]} is not a fragment of {n}")
    mx = (None, 0, 0, 0) if max_id is None else _index(max_id, "max_id", m, dev)
    return n, m, rows, (strides, steps), fa, mx


class Catalogue(Counted):
    """``CATALOGUE(kind, state, f_a, f_b, max_id=None, with_base=False)``:
    the 13-candidate catalogue ``kind`` ("em": C1, "mh": C2) of the m
    genomes of ``state`` (fields (n,) broadcast or (m, n), int32, read in
    place at their strides) for
    ``f_a`` (an integer, or an int32 / int64 tensor of one value or m) and
    ``f_b`` (int32 / int64 (m,)), with the fresh-id maximum ``max_id`` (as
    ``f_a``; None: the state's own maximum). Returns 11 tensors of shape
    (m, 13, n) int32, views of one (11, m, 13, n) buffer, each contiguous;
    with ``with_base``, (m, 14, n) with the base genome in slot 0. Indices
    must lie in [0, n).

    ``n_launches`` counts the calls (one launch each) on the card, by kind
    (``ops.counts``): the kernel adds one to its kind's counter itself."""

    def __init__(self):
        self.launches = LaunchCount()

    @staticmethod
    def _card(dev):
        if dev.type != "cuda":
            raise ValueError(f"the CUDA catalogue needs a state on a card, not on {dev}")

    def __call__(self, kind: str, state, f_a, f_b, max_id=None, with_base: bool = False):
        dev = state[0].device
        self._card(dev)
        n, m, rows, strides, fa, mx = check_args(kind, state, f_a, f_b, max_id)
        lib = load_library()
        slots = N_CANDIDATES + bool(with_base)
        out = torch.empty((N_FIELDS, m, slots, n), dtype=torch.int32, device=dev)
        counter = self.launches.counter(dev, kind)
        fields = (ctypes.c_void_p * N_FIELDS)(*[x.data_ptr() for x in state])
        row_strides = (ctypes.c_longlong * N_FIELDS)(*strides[0])
        col_strides = (ctypes.c_longlong * N_FIELDS)(*strides[1])
        def ptr(x):
            return None if x is None else x.data_ptr()

        rc = lib.catalogue(KINDS.index(kind), fields, row_strides, col_strides, n, m, rows,
                           ptr(fa[0]), *fa[1:], f_b.data_ptr(), int(f_b.dtype == torch.int64),
                           ptr(mx[0]), *mx[1:], int(max_id is None),
                           counter.data_ptr(), out.data_ptr(), slots, plan(n),
                           torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{kind} catalogue launch failed: cudaError {rc}")
        return out.unbind(0)


CATALOGUE = Catalogue()
