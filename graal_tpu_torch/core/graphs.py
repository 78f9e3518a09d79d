"""A cycle as one captured device program.

PyTorch counterpart of ``jax.jit`` + ``lax.scan`` in the JAX package's
cycles (``core/mcmc.py`` ``make_em_cycle``, ``core/delta.py``
``make_delta_em_cycle``, ``parallel/tempering.py`` ``make_tempered_cycle``,
``core/mtm.py`` ``make_mtm_cycle`` and the delta MTM / MH cycle of
``scale.py``) and of its jitted once-a-cycle anchor and nuisance step: the
JAX package compiles a step into one device program and runs a cycle as
one scan over it, so the host neither decides nor launches anything inside
a cycle. :class:`Scan` does the same with a CUDA graph. Its step body reads
everything from static buffers the scan owns and writes its results back
into them in place:

- the carry (the genome, the parameters, the carried likelihood): read
  and overwritten every step;
- the constants of a call (parameters the step only reads, ``f_t``);
- the per-step inputs (the draws and the fragment order) as (capacity,
  ...) tensors, row ``idx`` copied into fixed per-step slots at a device
  step index (a body may have none: the runners' cycle end is one step of
  its scan);
- the per-step outputs (the metrics) as (capacity, ...) tensors, written
  at row ``idx``; then ``idx += 1`` on the device.

On a card a step is the body and one launch of kernel H3
(``ops.scan_cuda.SCAN``): the step's stores (the outputs, the new carry),
the next step's loads (row ``idx + 1`` into the slots) and the index. A
call's first step finds its inputs loaded by one launch of kernel H2
before it (none for a body without per-step inputs). The eager route on a
card (``capture=False``, and the first step before a capture) takes the
same launches. On the CPU the plain versions (``scan_load_plain``,
``scan_store_plain``) gather before the body and index-copy and copy leaf
by leaf after it.

On a CUDA device the first step of the first call runs eagerly on a side
stream: the kernel libraries' builds, occupancy queries, launch plans,
ticket counters and launch counters come into being then, outside any
graph. Then the body is captured, on that stream, into a
``torch.cuda.CUDAGraph``, which replays the cycle's other steps, once a
step. A later call copies its inputs into the buffers, replays the graph
once a step and clones the carry and the outputs out. A capture that
fails raises; nothing falls back. ``capture=False`` runs the same body
eagerly, step by step: the path on the CPU, and on the card the reference
that a graph is held to. Either way every step runs once: the eager first
step is the cycle's step 0, so the kernels' launch counts, which the
wrappers keep on the card (``ops.counts``) and a replay advances, are
those of the eager loop.

A scan's graph holds its memory pool (the step's peak: at M = 20, R =
16,384 the 21.5 GB grid) for as long as it lives, and eager code cannot
use it. So a runner releases its scans' graphs (:meth:`Scan.release`) when
a run ends or leaves a bucket (``scale.ScaleRunner``): a released pool goes
back to the allocator, which frees it when an allocation needs the room.
The first step's blocks do not stay beside a pool either:
``torch.cuda.graph`` empties the allocator's cache before it captures.
"""

from __future__ import annotations

import torch

from graal_tpu_torch.ops.scan_cuda import SCAN, load_tables, scan_load_plain, scan_store_plain

# per CUDA device, the side stream every first step and capture runs on (a
# device resource of the process, like the kernel libraries ops.build loads
# once): the launches of every graph share its ticket counters, which stay
# valid because every replay runs in order on the caller's stream
_SIDE = {}


def _side_stream(device: torch.device):
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


# ---------------------------------------------------------------------------
# Trees of tensors: nested tuples and NamedTuples with tensor, number and
# None leaves (GenomeState, RippeParams, StepDraws, ChainDraws)
# ---------------------------------------------------------------------------

def _spec(tree):
    """A hashable description of a tree: its structure and each leaf's
    shape and dtype (a Python number is a 0-d float32 or int64 leaf)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree), tuple(_spec(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, (bool, int, float)):
        return (), torch.float32 if isinstance(tree, float) else torch.int64
    raise TypeError(f"a scan carries tensors and numbers, not {type(tree).__name__}")


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _build(spec, it):
    """The tree of ``spec`` with its leaves taken in order from ``it``."""
    if spec is None:
        return None
    kind, parts = spec
    if isinstance(kind, type) and issubclass(kind, tuple):
        vals = [_build(p, it) for p in parts]
        return kind(*vals) if hasattr(kind, "_fields") else kind(vals)
    return next(it)


def _load(buf: torch.Tensor, x):
    if isinstance(x, torch.Tensor):
        buf.copy_(x)
    else:
        buf.fill_(x)


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------

class Scan:
    """``scan(carry, consts, xs) -> (carry, ys)``: ``body(carry, consts, x)
    -> (carry, y)`` once a step over the leading axis of ``xs`` (the
    counterpart of ``lax.scan`` with the constants closed over). ``ys`` is
    each step's ``y`` stacked on a leading axis. The carry keeps the shapes
    and dtypes it comes in with (its buffers' own), as ``lax.scan``'s does.

    ``device``: where the scan runs. ``capture``: replay the body as a
    CUDA graph (the default on a CUDA device); True elsewhere raises, False
    runs the body eagerly, step by step.

    The buffers are built, and the graph captured, at the first call and
    again when a call's trees differ in structure, shape or dtype, or hold
    more steps than the buffers (the capacity grows to the longest cycle
    seen). Returned tensors are the scan's own copies.
    """

    def __init__(self, body, device, capture=None):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if capture is None:
            capture = device.type == "cuda"
        if capture and device.type != "cuda":
            raise ValueError(f"capture needs a CUDA device, not {device}: pass capture=False")
        self.body = body
        self.device = device
        self.capture = capture
        self.key = None
        self.cap = 0
        self.graph = None

    def release(self):
        """Drop the graph and buffers: the graph's memory pool goes back to
        the allocator, and the next call builds and captures anew."""
        self.key = None
        self.cap = 0
        self.graph = None
        self.carry_bufs = self.const_bufs = self.x_bufs = self.x_slots = self.y_bufs = None
        self.preload_tables = None

    # ---- buffers ------------------------------------------------------------
    def _alloc(self, carry, consts, x_spec, xs, cap):
        def empty(x, lead=()):
            if isinstance(x, torch.Tensor):
                return torch.empty(lead + tuple(x.shape[len(lead):]), dtype=x.dtype,
                                   device=self.device)
            return torch.empty(lead, dtype=_spec(x)[1], device=self.device)

        self.cap = cap
        self.carry_spec, self.const_spec, self.x_spec = _spec(carry), _spec(consts), x_spec
        self.carry_bufs = [empty(x) for x in _leaves(carry)]
        self.const_bufs = [empty(x) for x in _leaves(consts)]
        self.x_bufs = [empty(x, (cap,)) for x in _leaves(xs)]
        self.x_slots = [empty(x[0]) for x in _leaves(xs)]
        self.y_bufs = None
        self.y_spec = None
        self.idx = torch.zeros(1, dtype=torch.int64, device=self.device)
        # H3's count of the blocks done with idx (0 between launches)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.preload_tables = None   # H2's tables for these buffers, built at the first call
        self.graph = None

    # ---- the step body ------------------------------------------------------
    def _step(self):
        """One step on the buffers: the step's per-step inputs, the body,
        then the outputs stored at row idx, the new carry, the next step's
        inputs and idx += 1 (:meth:`_load`, :meth:`_store`). The first step
        allocates the output buffers from what it returns."""
        x = _build(self.x_spec, iter(self._load()))
        carry = _build(self.carry_spec, iter(self.carry_bufs))
        consts = _build(self.const_spec, iter(self.const_bufs))
        new, y = self.body(carry, consts, x)
        if self.y_bufs is None:
            self.y_spec = _spec(y)
            self.y_bufs = [torch.empty((self.cap,) + tuple(v.shape), dtype=v.dtype,
                                       device=self.device) for v in _leaves(y)]
        new = _leaves(new)
        if len(new) != len(self.carry_bufs):
            raise ValueError("the step changed the structure of its carry")
        for b, v in zip(self.carry_bufs, new):
            if v.shape != b.shape:
                raise ValueError(f"the step changed a carry leaf's shape: {tuple(b.shape)} "
                                 f"-> {tuple(v.shape)}")
        self._store(_leaves(y), new)

    def _preload(self):
        """Before a call's first step: on a card H2 copies row idx (0) of the
        per-step inputs into the slots; the CPU gathers in :meth:`_load`."""
        if self.device.type == "cuda":
            self._preload_on_card()

    def _preload_on_card(self):
        if self.x_bufs:
            if self.preload_tables is None:
                self.preload_tables = load_tables(self.x_bufs, self.x_slots, self.idx)
            SCAN.load(self.x_bufs, self.x_slots, self.idx, self.preload_tables)

    def _load(self):
        """The step's per-step inputs: on a card the slots, which the call's
        H2 or the previous step's H3 loaded; on the CPU the plain gathers."""
        if self.device.type == "cuda":
            return self._load_on_card()
        return scan_load_plain(self.x_bufs, self.idx)

    def _load_on_card(self):
        return self.x_slots

    def _store(self, ys, new):
        """Write the outputs and the new carry, then idx += 1: on a card one
        H3 launch, which also loads the next step's inputs into the slots;
        on the CPU the plain copies."""
        if self.device.type == "cuda":
            return self._store_on_card(ys, new)
        scan_store_plain(self.y_bufs, ys, self.carry_bufs, new, self.idx)

    def _store_on_card(self, ys, new):
        SCAN.step(self.y_bufs, ys, self.carry_bufs, new, self.x_bufs, self.x_slots, self.idx,
                  self.ticket)

    # ---- the graph ------------------------------------------------------------
    def _first_step(self):
        """Run one step of the cycle eagerly on the side stream every
        capture uses, outside any graph: whatever a kernel does at its first
        launch happens here, not in a capture."""
        cur = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._step()
        cur.wait_stream(side)

    def _capture(self):
        """Capture one step into a graph with its own memory pool. Capture
        records the step and runs nothing. It needs a device synchronisation
        (``torch.cuda.graph`` makes one), so the sync debug mode is off for
        its duration only: the first step ran the same body under the
        caller's mode."""
        graph = torch.cuda.CUDAGraph()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            with torch.cuda.graph(graph, stream=_side_stream(self.device)):
                self._step()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        self.graph = graph

    # ---- a call ---------------------------------------------------------------
    def __call__(self, carry, consts, xs, n_steps=None):
        """``n_steps``: the number of steps of a body with no per-step
        inputs (``xs`` None), which gets ``x = None`` every step."""
        x_leaves = _leaves(xs)
        n = x_leaves[0].shape[0] if x_leaves else n_steps
        if not n or n < 1:
            raise ValueError("a scan needs at least one step")
        if any(x.shape[0] != n for x in x_leaves):
            raise ValueError("the per-step inputs disagree on the number of steps")
        # one step's slice of the per-step inputs fixes the step's shapes
        x_spec = _spec(_build(_spec(xs), iter([x[0] for x in x_leaves])))
        key = (_spec(carry), _spec(consts), x_spec)
        if key != self.key or n > self.cap:
            self._alloc(carry, consts, x_spec, xs, max(n, self.cap if key == self.key else 0))
            self.key = key
        for b, x in zip(self.carry_bufs, _leaves(carry)):
            _load(b, x)
        for b, x in zip(self.const_bufs, _leaves(consts)):
            _load(b, x)
        for b, x in zip(self.x_bufs, x_leaves):
            b[:n].copy_(x)
        self.idx.zero_()
        self._preload()
        done = 0
        if self.capture and self.graph is None:
            self._first_step()
            self._capture()
            done = 1
        for _ in range(done, n):
            if self.capture:
                self.graph.replay()
            else:
                self._step()
        out = _build(self.carry_spec, iter([b.clone() for b in self.carry_bufs]))
        ys = _build(self.y_spec, iter([b[:n].clone() for b in self.y_bufs]))
        return out, ys
