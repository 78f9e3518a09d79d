"""A captured cycle's per-step loads and stores (kernels H2 / H3,
graal_tpu_torch/csrc/scan_io.cu, wrapper ops/scan_cuda.py) on the CPU.

- The plain versions (``scan_load_plain``, ``scan_store_plain``), which
  ``core.graphs.Scan`` runs on the CPU, equal the scan's step as it was
  before them (:func:`old_step`, kept here verbatim) on random trees:
  int32, int64, f32 and bool leaves, 0-d leaves, a chains axis, a body with
  no per-step inputs, capacity growth, a carry leaf that is another carry
  buffer, an output that is a carry buffer overwritten after it, leaves at
  other strides, an output that is a per-step slot (as the dense EM body's
  ``id_f_a``), a new carry leaf that views a slot, and calls whose steps
  fill the buffers' capacity, on one scan.
- The card's route, the wrapper itself launching the tables it builds into
  a stand-in library that runs :func:`run_table` (a transcription of the
  kernels: every block's warps look their entries up by a binary search,
  every source of a launch read before any destination is written, as the
  kernels' parallel blocks may, the load entries skipped past the
  capacity, the step index advanced by the launch's last block, and the
  launch counted on the counter the wrapper hands it), gives the same
  results bit for bit as the plain store-then-load sequence, the slots
  included after every step (the last too), with one H2 launch a call (a
  call's first load) and one H3 launch a step (its stores and the next
  step's loads) where nothing aliases, and the store cut into ordered
  launches where it does; no torch add counts a launch.
  ``tests/test_torch_step_cycles.py`` runs an EM and a delta cycle through
  the same route against the JAX package's ``lax.scan`` cycles.
- The block / warp layout on random tables (1 to MAX_ENTRIES entries, 1
  byte to a few MB, every word width, two-level strides) and on the dense
  EM step's 31 store and 6 load entries: every word of every entry copied
  exactly once, equal to the plain versions.
- The tables: layouts, word widths, the cuts, the slot sources, the
  capacity guard, the checks, and the ctypes mirrors parsed from the .cu.
"""

import ctypes
import re
import types
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

import tests.test_torch_state  # noqa: F401  (one torch thread per worker)
from graal_tpu_torch.core import graphs
from graal_tpu_torch.ops import scan_cuda as scu
from graal_tpu_torch.ops.counts import LaunchCount

CSRC = Path(__file__).resolve().parents[1] / "graal_tpu_torch" / "csrc"


def _bytes(ptr, count):
    return np.ctypeslib.as_array((ctypes.c_ubyte * count).from_address(ptr))


def bump(counter):
    """What block 0's thread 0 does: one more launch on the key's counter."""
    c = ctypes.c_int64.from_address(counter)
    c.value += 1


def entry_of(t: scu.Table, unit):
    """A warp's lookup, as the kernels make it: a binary search of the
    ``first`` column for the last entry that starts at or before the
    warp's unit."""
    j, hi = 0, t.n - 1
    while j < hi:
        mid = (j + hi + 1) // 2
        if t.first[mid] <= unit:
            j = mid
        else:
            hi = mid - 1
    return j


def unit_words(t: scu.Table):
    """The table's layout as the kernels walk it: for every block, every
    warp's unit, its entry and the words its lanes copy (lane l the words
    q0 + l + 32 i, i < LANE_WORDS, below the entry's words). Returns, per
    entry, the words in the order the units copy them."""
    lane_words = (scu.UNIT_WORDS // 32)
    offs = (np.arange(32)[:, None] + 32 * np.arange(lane_words)[None, :]).reshape(-1)
    out = [[] for _ in range(t.n)]
    for block in range(scu.blocks(t)):
        for warp in range(scu.warps(t)):
            unit = block * scu.warps(t) + warp
            if unit >= t.n_units:
                continue
            j = entry_of(t, unit)
            e = t.e[j]
            words = e.outer * e.inner >> e.log_w
            q = (unit - t.first[j]) * scu.UNIT_WORDS + offs
            out[j].append(q[q < words])
    return [np.concatenate(q) if q else np.zeros(0, np.int64) for q in out]


def run_table(t: scu.Table):
    """One launch of H2 / H3 on CPU memory, from its table: every warp's
    unit looked up and its words read first (a load entry's only while the
    step is at most ``load_last``), then every destination written (the
    kernels' blocks run in no order), then, where the table advances the
    step, the index (its ticket cell 0 before and after), and the launch's
    counter. Holds each entry's word width to its addresses and the layout
    to copy every word of every entry exactly once."""
    step = ctypes.c_longlong.from_address(t.step_in).value
    assert t.n <= scu.MAX_ENTRIES and list(t.first[t.n:]) == [scu.NO_ENTRY] * (
        scu.MAX_ENTRIES - t.n)
    assert 0 <= t.first_load <= t.n
    reads = []
    for j, q in enumerate(unit_words(t)):
        e = t.e[j]
        w = 1 << e.log_w
        assert e.inner % w == 0 and e.src % w == 0 and e.dst % w == 0 \
            and e.src_step % w == 0 and e.dst_step % w == 0
        assert e.outer == 1 or e.outer_stride % w == 0
        words = e.outer * e.inner // w
        assert t.first[j] == (0 if j == 0 else t.first[j - 1] + -(-(
            t.e[j - 1].outer * t.e[j - 1].inner >> t.e[j - 1].log_w) // scu.UNIT_WORDS))
        assert np.array_equal(np.bincount(q, minlength=words), np.ones(words, np.int64))
        if j >= t.first_load and step > t.load_last:
            continue
        per_run = e.inner // w
        r = q // per_run
        at = r * e.outer_stride + (q - r * per_run) * w
        src = _bytes(e.src + step * e.src_step, (e.outer - 1) * e.outer_stride + e.inner)
        reads.append((j, q, src[at[:, None] + np.arange(w)[None, :]]))
    for j, q, data in reads:
        e = t.e[j]
        w = 1 << e.log_w
        dst = _bytes(e.dst + step * e.dst_step, e.outer * e.inner)
        dst[(q * w)[:, None] + np.arange(w)[None, :]] = data
    if t.step_out:
        assert t.ticket and ctypes.c_uint32.from_address(t.ticket).value == 0
        ctypes.c_longlong.from_address(t.step_out).value = step + 1
    bump(t.counter)


class StandInLibrary:
    """The scan library's entry points run as :func:`run_table`, each
    launch counted on the counter the wrapper handed it, as block 0's
    thread 0 does."""

    def __init__(self):
        self.tables = []

    def _run(self, kind, ref):
        t = ref._obj
        self.tables.append((kind, t.n))
        assert t.counter, "a launch without its counter"
        run_table(t)
        return 0

    def scan_load(self, ref, stream):
        return self._run("load", ref)

    def scan_store(self, ref, stream):
        return self._run("store", ref)


class StandIn(scu.ScanKernels):
    """The wrapper itself, its tables on CPU tensors, launching into a
    :class:`StandInLibrary`."""

    def __init__(self, lib):
        super().__init__()
        self.lib = lib

    @property
    def tables(self):
        return self.lib.tables

    @staticmethod
    def _card(dev):
        pass


def no_torch_add(monkeypatch):
    def refuse(self, device, key=None):
        raise AssertionError(f"a torch add counted {key} beside a self-counting kernel")

    monkeypatch.setattr(LaunchCount, "add", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))


def route_to_card(monkeypatch):
    """Send every scan's loads and stores through their card branches and
    a stand-in wrapper; returns the stand-in."""
    lib = StandInLibrary()
    spy = StandIn(lib)
    no_torch_add(monkeypatch)
    monkeypatch.setattr(scu, "load_library", lambda: lib)
    monkeypatch.setattr(graphs, "SCAN", spy)
    monkeypatch.setattr(graphs.Scan, "_preload", graphs.Scan._preload_on_card)
    monkeypatch.setattr(graphs.Scan, "_load", graphs.Scan._load_on_card)
    monkeypatch.setattr(graphs.Scan, "_store", graphs.Scan._store_on_card)
    return spy


def old_step(self):
    """``core.graphs.Scan._step`` before the load / store kernels,
    verbatim."""
    idx = self.idx
    x = graphs._build(self.x_spec, iter([b.index_select(0, idx)[0] for b in self.x_bufs]))
    carry = graphs._build(self.carry_spec, iter(self.carry_bufs))
    consts = graphs._build(self.const_spec, iter(self.const_bufs))
    new, y = self.body(carry, consts, x)
    if self.y_bufs is None:
        self.y_spec = graphs._spec(y)
        self.y_bufs = [torch.empty((self.cap,) + tuple(v.shape), dtype=v.dtype,
                                   device=self.device) for v in graphs._leaves(y)]
    for b, v in zip(self.y_bufs, graphs._leaves(y)):
        b.index_copy_(0, idx, v.reshape((1,) + tuple(b.shape[1:])))
    new = graphs._leaves(new)
    if len(new) != len(self.carry_bufs):
        raise ValueError("the step changed the structure of its carry")
    for b, v in zip(self.carry_bufs, new):
        if v.shape != b.shape:
            raise ValueError(f"the step changed a carry leaf's shape: {tuple(b.shape)} "
                             f"-> {tuple(v.shape)}")
        if v is not b:
            b.copy_(v)
    idx.add_(1)


# ---------------------------------------------------------------------------
# Random trees: each case is (body, calls), a call (carry, consts, xs,
# n_steps); the carry threads from one call to the next when None
# ---------------------------------------------------------------------------

C = 3


class Part(NamedTuple):
    a: torch.Tensor     # (C, 5) int32
    b: torch.Tensor     # (C,) f32


def _rng_tensor(rng, shape, dtype):
    if dtype == torch.bool:
        return torch.as_tensor(rng.random(shape) < 0.5)
    if dtype == torch.float32:
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    return torch.as_tensor(rng.integers(-50, 50, shape), dtype=dtype)


def mixed_case(rng):
    """Every dtype, 0-d leaves, a chains axis, named and plain tuples."""
    def body(carry, consts, x):
        part, cnt, flag = carry
        scale, offs = consts
        xi, xf, xb, xs = x
        a2 = (part.a * 3 + offs[:, None] + xs.sum()) % 1000
        b2 = part.b * scale + xf.sum(-1)
        cnt2 = cnt + xi
        flag2 = flag ^ xb
        y = (b2.sum(), flag2, a2[:, :2].long(), cnt2.int(), (xb.float() * b2).sum())
        return (Part(a2.int(), b2), cnt2, flag2), y

    def carry():
        return (Part(_rng_tensor(rng, (C, 5), torch.int32), _rng_tensor(rng, (C,), torch.float32)),
                torch.tensor(7), _rng_tensor(rng, (C,), torch.bool))

    def xs(n):
        return (_rng_tensor(rng, (n,), torch.int64), _rng_tensor(rng, (n, C, 3), torch.float32),
                _rng_tensor(rng, (n, C), torch.bool), _rng_tensor(rng, (n, 2), torch.int32))

    consts = (torch.tensor(np.float32(0.75)), _rng_tensor(rng, (C,), torch.int32))
    return body, [(carry(), consts, xs(5), None), (None, consts, xs(9), None),
                  (carry(), (torch.tensor(np.float32(1.5)), consts[1]), xs(4), None)]


def no_xs_case(rng):
    """A body with no per-step inputs (``n_steps``), as the runners' cycle
    end; one of its outputs is a carry buffer that the store overwrites."""
    def body(carry, consts, x):
        assert x is None
        a, b = carry
        return (a + consts, b * 2.0), (a.sum(), b)

    def carry():
        return (_rng_tensor(rng, (4,), torch.int64), _rng_tensor(rng, (2, 2), torch.float32))

    return body, [(carry(), torch.tensor(3), None, 3), (None, torch.tensor(-1), None, 6)]


def alias_case(rng):
    """A carry leaf that is another carry buffer (the two swap), and an
    output that is a carry buffer the store overwrites after it: the plain
    copies' order decides both."""
    def body(carry, consts, x):
        p, q, r = carry
        return (q, p, r + x), (p, r * consts)

    def carry():
        return (_rng_tensor(rng, (6,), torch.int32), _rng_tensor(rng, (6,), torch.int32),
                _rng_tensor(rng, (C,), torch.float32))

    return body, [(carry(), torch.tensor(np.float32(2.0)), _rng_tensor(rng, (4, C),
                                                                       torch.float32), None)]


def strided_case(rng):
    """Outputs and carry leaves at other strides: a broadcast row, a column
    of a matrix, a step of two."""
    def body(carry, consts, x):
        m, v = carry
        big = m.float()[:, :, None] * x[None, None, :]
        new = ((m[0] * 2 + v.sum()).expand(C, -1), (m * 3)[:, 1])
        return new, (big[:, 1, 0], (v + 1).expand(2, -1), big[::2, 1, :])

    def carry():
        return (_rng_tensor(rng, (C, 4), torch.int32), _rng_tensor(rng, (C,), torch.int32))

    return body, [(carry(), None, _rng_tensor(rng, (5, 2), torch.float32), None)]


def slot_output_case(rng):
    """Outputs that lie in per-step slots: a slot itself (as the dense EM
    body returns its f_a slot as the metric ``id_f_a``) and a column of one,
    which the card's route reads from the inputs' rows while it loads the
    next step's into the slots."""
    def body(carry, consts, x):
        (a,) = carry
        f_a, m = x
        return (a + f_a * consts,), (f_a, m[:, 1], (a * 2).sum(), m)

    def xs(n):
        return (_rng_tensor(rng, (n,), torch.int64), _rng_tensor(rng, (n, C, 3), torch.float32))

    return body, [((_rng_tensor(rng, (C,), torch.int64),), torch.tensor(3), xs(6), None),
                  (None, torch.tensor(-2), xs(4), None)]


def slot_carry_case(rng):
    """New carry leaves that are a per-step slot and a view of one (a row
    of a (2, 2) slot)."""
    def body(carry, consts, x):
        v, w = carry
        xv, xw = x
        return (xv, xw[1]), (v.sum(), w.sum(), xw[0, 1])

    def carry():
        return (_rng_tensor(rng, (C,), torch.float32), _rng_tensor(rng, (2,), torch.int32))

    def xs(n):
        return (_rng_tensor(rng, (n, C), torch.float32), _rng_tensor(rng, (n, 2, 2), torch.int32))

    return body, [(carry(), None, xs(5), None), (None, None, xs(5), None)]


def full_capacity_case(rng):
    """Calls whose steps fill the buffers' capacity (the first call's, and a
    second call of as many steps on the same scan: its last step loads no
    row past the buffers), then a shorter one."""
    def body(carry, consts, x):
        a, b = carry
        xi, xf = x
        return (a * 2 + xi, b + xf), (xi + a.sum(), xf.sum(), b.sum())

    def xs(n):
        return (_rng_tensor(rng, (n, C), torch.int64), _rng_tensor(rng, (n, 4), torch.float32))

    init = (_rng_tensor(rng, (C,), torch.int64), _rng_tensor(rng, (4,), torch.float32))
    return body, [(init, None, xs(6), None), (None, None, xs(6), None), (None, None, xs(3), None)]


CASES = {"mixed": mixed_case, "no_xs": no_xs_case, "alias": alias_case, "strided": strided_case,
         "slot_output": slot_output_case, "slot_carry": slot_carry_case,
         "full_capacity": full_capacity_case}


def run_case(name, seed=0):
    """Every call of a case through one Scan; the returned trees."""
    body, calls = CASES[name](np.random.default_rng(seed))
    scan = graphs.Scan(body, "cpu")
    out, carry = [], None
    for init, consts, xs, n_steps in calls:
        carry, ys = scan(init if init is not None else carry, consts, xs, n_steps=n_steps)
        out.append((carry, ys))
    return out


def leaves(tree):
    return graphs._leaves(tuple(tree) if isinstance(tree, list) else tree)


def assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("name", tuple(CASES))
def test_plain_versions_equal_the_old_step(name, monkeypatch):
    want = None
    with monkeypatch.context() as m:
        m.setattr(graphs.Scan, "_step", old_step)
        want = run_case(name)
    assert_trees_equal(run_case(name), want)


def raw(b):
    """A copy of ``b``'s bytes (a typed ``clone`` would turn unwritten bool
    bytes into 0 / 1, and NaN bits compare unequal)."""
    return b.reshape(-1).view(torch.uint8).clone()


def typed(r, b):
    """The bytes ``r`` (from :func:`raw`) as a tensor of ``b``'s dtype and shape."""
    return r.view(b.dtype).reshape(b.shape)


def same_bytes(got, want):
    return all(torch.equal(raw(g), w) for g, w in zip(got, want))


def checked_steps(monkeypatch):
    """Hold every card-route step to the plain sequence: the plain store
    into copies of the buffers and the index, then the plain load of row
    idx (while below the capacity; else the slots unchanged); after the
    step's launches, the buffers, the index and the slots equal the copies
    byte for byte. Returns the list of steps checked."""
    seen = []
    orig = graphs.Scan._store_on_card

    def store(self, ys, new):
        y_c, c_c, i_c = [raw(b) for b in self.y_bufs], [raw(b) for b in self.carry_bufs], \
            self.idx.clone()
        c_t = [typed(c, b) for b, c in zip(self.carry_bufs, c_c)]
        copy_of = {id(b): c for b, c in zip(self.carry_bufs, c_t)}
        mapped = [copy_of.get(id(v), v) for v in new]
        scu.scan_store_plain([typed(c, b) for b, c in zip(self.y_bufs, y_c)], ys, c_t, mapped,
                             i_c)
        s_c = [raw(s) for s in (scu.scan_load_plain(self.x_bufs, i_c) if int(i_c) < self.cap
                                else self.x_slots)]
        orig(self, ys, new)
        assert same_bytes(self.y_bufs, y_c) and same_bytes(self.carry_bufs, c_c)
        assert torch.equal(self.idx, i_c) and same_bytes(self.x_slots, s_c)
        seen.append((int(i_c), self.cap))

    monkeypatch.setattr(graphs.Scan, "_store", store)
    return seen


@pytest.mark.parametrize("name", tuple(CASES))
def test_card_route_equals_plain(name, monkeypatch):
    """The wrapper's tables, run as the kernels run them, give the plain
    results, and after every step the plain store-then-load sequence's
    buffers, index and slots byte for byte (the last step of a call that
    fills the capacity loads nothing); one H2 launch a call with per-step
    inputs and one H3 launch a step where nothing aliases."""
    want = run_case(name)
    spy = route_to_card(monkeypatch)
    seen = checked_steps(monkeypatch)
    got = run_case(name)
    assert_trees_equal(got, want)
    _, calls = CASES[name](np.random.default_rng(0))
    steps = sum(ys_leaf.shape[0] for _, ys in got for ys_leaf in leaves(ys)[:1])
    assert len(seen) == steps
    loads = [n for kind, n in spy.tables if kind == "load"]
    stores = [n for kind, n in spy.tables if kind == "store"]
    assert len(loads) == sum(xs is not None for _, _, xs, _ in calls)
    assert spy.launches.by_key() == {"store": len(stores)} | ({"load": len(loads)} if loads
                                                               else {})
    if name == "alias":
        # the outputs (one reads p), then p <- q, then q <- p, r and the next row's load
        assert stores == [2, 1, 3] * steps
    elif name == "no_xs":
        # an output is the carry buffer b, which the last copy overwrites
        assert stores == [3, 1] * steps
    else:
        assert len(stores) == steps and len(set(stores)) == 1
    if name == "full_capacity":
        # both full calls end at the capacity, the short one below it
        assert [s for s in seen if s[0] == s[1]] == [(6, 6), (6, 6)]


def test_slot_sources_read_the_inputs_rows():
    """A store entry whose source lies in a slot reads the slot's input
    buffer at row idx (the slot's offset kept), a row a step; the load
    entries read row idx + 1, last in the table, guarded at capacity - 2,
    and one launch takes them all: nothing reads what another writes."""
    cap = 5
    xb, xm = torch.zeros((cap, 4), dtype=torch.int64), torch.zeros((cap, 2, 3))
    slots = [torch.zeros(4, dtype=torch.int64), torch.zeros((2, 3))]
    y_bufs = [torch.zeros((cap, 4), dtype=torch.int64), torch.zeros((cap, 2))]
    carry = [torch.zeros(3)]
    idx, ticket = torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int32)
    (t,) = scu.step_tables(y_bufs, [slots[0], slots[1][:, 1]], carry, [slots[1][1]],
                           [xb, xm], slots, idx, ticket)
    assert t.n == 5 and t.first_load == 3 and t.load_last == cap - 2
    assert t.step_out == idx.data_ptr() and t.ticket == ticket.data_ptr()
    e = t.e
    assert (e[0].src, e[0].src_step) == (xb.data_ptr(), 32)
    assert (e[1].src, e[1].src_step, e[1].outer, e[1].outer_stride) == (
        xm.data_ptr() + 4, 24, 2, 12)
    assert (e[2].src, e[2].src_step) == (xm.data_ptr() + 12, 24)
    assert (e[3].src, e[3].src_step, e[3].dst) == (xb.data_ptr() + 32, 32, slots[0].data_ptr())
    assert (e[4].src, e[4].src_step, e[4].dst) == (xm.data_ptr() + 24, 24, slots[1].data_ptr())
    (t0,) = scu.load_tables([xb, xm], slots, idx)
    assert t0.n == 2 and t0.first_load == 0 and t0.load_last == cap - 1 and not t0.step_out
    assert (t0.e[0].src, t0.e[1].src) == (xb.data_ptr(), xm.data_ptr())
    with pytest.raises(ValueError, match="ticket"):
        scu.table([], idx, idx)


def test_runs_and_word_widths():
    x = torch.zeros((4, 6), dtype=torch.int32)
    assert scu.runs(x) == (1, 0, 96)
    assert scu.runs(torch.tensor(3.0)) == (1, 0, 4)
    assert scu.runs(x[:, 1:4]) == (4, 24, 12)
    assert scu.runs(x[:, 2]) == (4, 24, 4)
    assert scu.runs(torch.zeros(6).expand(4, 6)) == (4, 0, 24)
    assert scu.runs(x[None, :, None, :]) == (1, 0, 96)
    with pytest.raises(ValueError, match="two levels"):
        scu.runs(torch.zeros((2, 3, 4))[:, ::2, ::2])
    with pytest.raises(ValueError, match="two levels"):
        scu.runs(torch.zeros((5, 3)).T)
    big = torch.zeros(64, dtype=torch.uint8)
    assert scu.entry(big[:32], big[32:])["log_w"] == 4
    assert scu.entry(big[1:9], big[40:48])["log_w"] == 0
    assert scu.entry(big[4:12], big[40:48])["log_w"] == 2
    assert scu.entry(big[:0], big[40:40]) is None


def _entries(n):
    bufs = [torch.zeros(4) for _ in range(2 * n)]
    return [scu.entry(bufs[2 * k], bufs[2 * k + 1]) for k in range(n)]


def test_segments_cut_where_copies_touch():
    a, b, c = torch.zeros(8), torch.zeros(8), torch.zeros(8)
    e1, e2, e3 = scu.entry(a, b), scu.entry(b, c), scu.entry(a[:4], c[4:])
    assert [len(s) for s in scu.segments([e1, scu.entry(a, c)])] == [2]   # reads share
    assert [len(s) for s in scu.segments([e1, e2])] == [1, 1]             # reads what e1 writes
    assert [len(s) for s in scu.segments([e2, e1])] == [1, 1]             # writes what e2 reads
    assert [len(s) for s in scu.segments([e2, e3])] == [1, 1]             # both write c
    assert [len(s) for s in scu.segments(_entries(scu.MAX_ENTRIES + 1))] == [scu.MAX_ENTRIES, 1]
    assert scu.segments([]) == [[]]
    with pytest.raises(ValueError, match="overlaps"):
        scu.segments([scu.entry(a[:6], a[2:])])


def test_store_tables_check_what_the_kernels_take():
    idx, ticket = torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int32)
    ybuf, buf = torch.zeros((4, 3)), torch.zeros(5, dtype=torch.int32)

    def tables(y_bufs, ys, carry_bufs, new, x_bufs=(), slots=()):
        return scu.step_tables(y_bufs, ys, carry_bufs, new, list(x_bufs), list(slots), idx,
                               ticket)

    ts = tables([ybuf], [torch.ones(3)], [buf], [torch.ones(5, dtype=torch.int32)])
    assert len(ts) == 1 and ts[0].n == 2 and ts[0].step_out == idx.data_ptr()
    assert ts[0].step_in == idx.data_ptr() and ts[0].ticket == ticket.data_ptr()
    assert ts[0].first_load == 2
    # a leaf that is its buffer, or the same bytes, is no copy
    assert tables([], [], [buf], [buf])[0].n == 0
    assert tables([], [], [buf], [buf[:]])[0].n == 0
    with pytest.raises(ValueError, match="convert no dtype"):
        tables([], [], [buf], [torch.ones(5, dtype=torch.int64)])
    with pytest.raises(ValueError, match="elements"):
        tables([ybuf], [torch.ones(4)], [], [])
    with pytest.raises(ValueError, match="two levels"):
        tables([], [], [torch.zeros((3, 5))], [torch.zeros((5, 3)).T])
    xb, slot = torch.zeros((6, 2, 2)), torch.zeros((2, 2))
    (t,) = scu.load_tables([xb], [slot], idx)
    assert t.n == 1 and t.e[0].src_step == 16 and not t.step_out and t.load_last == 5
    (t,) = tables([], [], [], [], [xb], [slot])
    assert t.n == 1 and t.first_load == 0 and t.e[0].src == xb.data_ptr() + 16 \
        and t.load_last == 4
    (t,) = scu.load_tables([], [], idx)
    assert t.n == 0 and t.n_units == 0 and scu.blocks(t) == 1
    with pytest.raises(ValueError, match="slot one row"):
        scu.load_tables([xb], [torch.zeros(3)], idx)
    with pytest.raises(ValueError, match="on a card"):
        scu.SCAN.load([xb], [slot], idx)
    with pytest.raises(ValueError, match="on a card"):
        scu.SCAN.step([], [], [buf], [buf], [], [], idx, ticket)
    assert scu.SCAN.n_launches == 0


def _struct_fields(src, name):
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    out = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        if decl.strip():
            out.append(re.sub(r"\[.*?\]", "", decl).replace("*", " ").split()[-1])
    return out


def test_ctypes_mirrors_follow_the_source():
    src = (CSRC / "scan_io.cu").read_text()
    assert _struct_fields(src, "Entry") == [f for f, _ in scu.Entry._fields_]
    assert _struct_fields(src, "Table") == [f for f, _ in scu.Table._fields_]
    const = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(const["MAX_ENTRIES"]) == scu.MAX_ENTRIES
    assert int(const["MAX_WARPS"]) == scu.MAX_WARPS
    assert const["UNIT_WORDS"] == "32 * LANE_WORDS" \
        and 32 * int(const["LANE_WORDS"]) == scu.UNIT_WORDS
    assert ctypes.sizeof(scu.Table) == 3896 <= 4096   # by value: the kernel-parameter limit


# ---------------------------------------------------------------------------
# The block / warp layout on random tables
# ---------------------------------------------------------------------------

DTYPES = (torch.uint8, torch.int16, torch.int32, torch.float32, torch.int64, torch.float64)


def _leaf(rng, nbytes, dtype):
    """A tensor of about ``nbytes`` bytes of ``dtype``: contiguous, at an odd
    offset of a byte pool (uint8), or a two-level view (a column block or a
    column of a matrix)."""
    el = torch.empty((), dtype=dtype).element_size()
    n = max(1, nbytes // el)
    form = rng.integers(0, 3) if n > 1 else 0
    if dtype == torch.uint8 and form == 0:
        off = int(rng.integers(0, 16))
        pool = torch.as_tensor(rng.integers(0, 256, n + 16, dtype=np.uint8))
        return pool[off:off + n]
    if form == 0:
        return _rng_tensor(rng, (n,), dtype) if dtype != torch.uint8 else \
            torch.as_tensor(rng.integers(0, 256, n, dtype=np.uint8))
    rows = int(rng.integers(2, 9))
    cols = max(1, n // rows)
    wide = torch.as_tensor(rng.integers(-100, 100, (rows, cols + 3))).to(dtype)
    return wide[:, 1:cols + 1] if form == 1 else wide[:, 2]


def _size(rng, big):
    """Bytes of a leaf: mostly 1 byte to a few KB, a few MB when ``big``."""
    if big:
        return int(rng.integers(1 << 20, 3 << 20))
    return int(rng.choice([1, 2, 4, 8, 16, 48, 1536, int(rng.integers(1, 5000))]))


def random_store_tree(rng, n_entries, big=False):
    """``n_entries`` copies of a store: outputs (a row of a (cap, ...) buffer
    each) and new carry leaves, of every width, two-level views among them;
    one leaf of a few MB when ``big``."""
    cap = 3
    y_bufs, ys, carry_bufs, new = [], [], [], []
    for k in range(n_entries):
        dtype = DTYPES[int(rng.integers(0, len(DTYPES)))]
        v = _leaf(rng, _size(rng, big and k == 0), dtype)
        if rng.random() < 0.4:
            y_bufs.append(torch.zeros((cap,) + tuple(v.shape), dtype=dtype))
            ys.append(v)
        else:
            carry_bufs.append(torch.zeros(tuple(v.shape), dtype=dtype))
            new.append(v)
    return y_bufs, ys, carry_bufs, new


def random_load_tree(rng, n_entries, big=False):
    """``n_entries`` per-step input buffers (cap rows each) and their slots."""
    cap = 4
    x_bufs, slots = [], []
    for k in range(n_entries):
        dtype = DTYPES[int(rng.integers(0, len(DTYPES)))]
        el = torch.empty((), dtype=dtype).element_size()
        n = max(1, _size(rng, big and k == 0) // el)
        x_bufs.append(_rng_tensor(rng, (cap, n), dtype) if dtype != torch.uint8 else
                      torch.as_tensor(rng.integers(0, 256, (cap, n), dtype=np.uint8)))
        slots.append(torch.zeros(n, dtype=dtype))
    return x_bufs, slots


def dense_em_store_tree(rng, n=384):
    """The dense EM store's 31 entries: the step's 11 metrics (scalars) into
    their rows, and 20 carry leaves (the genome's 11 (n,) int32 fields, the
    8 parameters and l_t)."""
    cap = 8
    ys = [torch.tensor(float(rng.normal()), dtype=torch.float32) for _ in range(6)] \
        + [torch.tensor(int(rng.integers(0, 99)), dtype=torch.int32) for _ in range(3)] \
        + [torch.tensor(bool(rng.random() < 0.5)), torch.tensor(7, dtype=torch.int64)]
    y_bufs = [torch.zeros((cap,), dtype=v.dtype) for v in ys]
    new = [_rng_tensor(rng, (n,), torch.int32) for _ in range(11)] \
        + [torch.tensor(float(rng.normal()), dtype=torch.float32) for _ in range(9)]
    carry_bufs = [torch.zeros_like(v) for v in new]
    return y_bufs, ys, carry_bufs, new


def clone_raw(bufs):
    return [b.clone() for b in bufs]


def store_both_ways(y_bufs, ys, carry_bufs, new, row, x_bufs=(), slots=()):
    """A step's plain store then plain load of the next row into copies of
    the buffers, then the step's tables run as the kernels run them into
    other copies and ``slots`` themselves (an output may be a slot, read
    before it is loaded); returns (kernel, plain) buffers and slots, and
    the tables."""
    yp, cp = clone_raw(y_bufs), clone_raw(carry_bufs)
    ip = torch.tensor([row])
    scu.scan_store_plain(yp, ys, cp, new, ip)
    sp = scu.scan_load_plain(list(x_bufs), ip) if x_bufs and row + 1 < x_bufs[0].shape[0] \
        else clone_raw(slots)
    yk, ck = clone_raw(y_bufs), clone_raw(carry_bufs)
    idx, ticket = torch.tensor([row]), torch.zeros(1, dtype=torch.int32)
    tables = scu.step_tables(yk, ys, ck, new, list(x_bufs), list(slots), idx, ticket)
    counter = torch.zeros((), dtype=torch.int64)
    for t in tables:
        t.counter = counter.data_ptr()
        run_table(t)
    assert int(idx) == row + 1 and int(counter) == len(tables) and int(ticket) == 0
    return yk + ck + list(slots), yp + cp + sp, tables


@pytest.mark.parametrize("n_entries,big,seed", [(1, False, 0), (1, True, 1), (2, False, 2),
                                                (7, True, 3), (31, False, 4), (40, False, 5),
                                                (63, False, 6), (64, True, 7), (64, False, 8)])
def test_layout_copies_every_word_once(n_entries, big, seed):
    """Random stores and loads of 1 to MAX_ENTRIES entries, 1 byte to a few
    MB, every word width and two-level strides: every warp unit finds its
    entry by the binary search, the units of every entry copy each of its
    words exactly once (:func:`run_table`), and the results equal
    ``scan_store_plain`` / ``scan_load_plain`` bit for bit."""
    rng = np.random.default_rng(seed)
    tree = random_store_tree(rng, n_entries, big)
    got, want, tables = store_both_ways(*tree, row=int(rng.integers(0, 3)))
    assert len(tables) == 1 and tables[0].n == n_entries
    assert_trees_equal(got, want)
    widths = {tables[0].e[j].log_w for j in range(n_entries)}
    if n_entries >= 31:
        assert widths == {0, 1, 2, 3, 4} and any(tables[0].e[j].outer > 1
                                                 for j in range(n_entries))
    x_bufs, slots = random_load_tree(rng, n_entries, big)
    row = int(rng.integers(0, 4))
    idx = torch.tensor([row])
    (t,) = scu.load_tables(x_bufs, slots, idx)
    counter = torch.zeros((), dtype=torch.int64)
    t.counter = counter.data_ptr()
    run_table(t)
    assert int(idx) == row and int(counter) == 1
    assert_trees_equal(slots, scu.scan_load_plain(x_bufs, idx))
    # the next row's loads in a step's table, the last step at the capacity included
    for row in (int(rng.integers(0, 3)), 3):
        got, want, tables = store_both_ways([], [], [], [], row, x_bufs, slots)
        assert len(tables) == 1 and tables[0].first_load == 0
        assert_trees_equal(got, want)


def test_dense_em_store_packs_its_scalars_into_shared_blocks():
    """The dense EM store's 31 entries take 31 warp units, so one block of
    31 warps, and equal the plain store; with the step's 6 per-step inputs
    (the next row's loads, one a slot read back as the metric ``id_f_a``)
    37 entries, two blocks of 19 warps, one launch, equal to the plain
    store then load."""
    rng = np.random.default_rng(11)
    got, want, tables = store_both_ways(*dense_em_store_tree(rng), row=5)
    (t,) = tables
    assert t.n == 31 and t.n_units == 31 and (scu.blocks(t), scu.warps(t)) == (1, 31)
    assert list(t.first[:31]) == list(range(31))
    assert_trees_equal(got, want)
    y_bufs, ys, carry_bufs, new = dense_em_store_tree(rng)
    cap = y_bufs[0].shape[0]
    x_bufs = [_rng_tensor(rng, (cap,), torch.int64), _rng_tensor(rng, (cap, 4), torch.float32),
              _rng_tensor(rng, (cap, 13), torch.float32), _rng_tensor(rng, (cap,), torch.float32),
              _rng_tensor(rng, (cap,), torch.float32), _rng_tensor(rng, (cap, 2), torch.float32)]
    slots = [b[0].clone() for b in x_bufs]
    ys[-1] = slots[0]   # id_f_a: the step's f_a slot itself
    for row in (5, cap - 1):
        for s, b in zip(slots, x_bufs):   # what the step found in its slots
            s.copy_(b[row])
        got, want, tables = store_both_ways(y_bufs, ys, carry_bufs, new, row, x_bufs, slots)
        (t,) = tables
        assert t.n == 37 and t.first_load == 31 and (scu.blocks(t), scu.warps(t)) == (2, 19)
        assert t.e[10].src_step == 8 and t.e[10].src == x_bufs[0].data_ptr()
        assert_trees_equal(got, want)


def test_launch_shape_spreads_the_units():
    """A launch takes as few blocks as hold its units at MAX_WARPS a block
    and spreads the units evenly over them: every unit has a warp, no block
    is a warp short of another by more than one unit, and up to MAX_WARPS
    units are one block (its index written without a ticket)."""
    for n_units in (0, 1, 13, 31, 32, 33, 37, 64, 65, 260, 5000):
        t = scu.Table(n_units=n_units)
        b, w = scu.blocks(t), scu.warps(t)
        assert w <= scu.MAX_WARPS and b * w >= n_units and (b == 1) == (n_units <= scu.MAX_WARPS)
        assert n_units == 0 or (b - 1) * w < n_units
    src = (CSRC / "scan_io.cu").read_text()
    assert "return t->n_units > 0 ? (t->n_units + MAX_WARPS - 1) / MAX_WARPS : 1;" in src
    assert "return t->n_units > 0 ? (t->n_units + b - 1) / b : 1;" in src


def test_lookup_finds_each_units_entry():
    """The binary search gives the entry whose units hold the warp's, for
    every unit of tables of 1 to MAX_ENTRIES entries of 1 to 300 units."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 31, 32, 33, 63, 64):
        units = rng.integers(1, 300, n)
        t = scu.Table(n=n, n_units=int(units.sum()))
        first = np.concatenate([[0], np.cumsum(units)[:-1]])
        t.first[:] = list(first) + [scu.NO_ENTRY] * (scu.MAX_ENTRIES - n)
        for u in range(t.n_units):
            assert entry_of(t, u) == int(np.searchsorted(first, u, side="right")) - 1


def test_wrapper_counts_in_the_kernel_not_beside_it(monkeypatch):
    """Neither kernel's wrapper calls ``LaunchCount.add``: each launch, a
    cut one too, adds one to its kind's counter in the kernel (the stand-in
    library as block 0's thread 0), and ``n_launches`` equals the launches
    made: a step of MAX_ENTRIES + 6 leaves (two launches), a step whose
    leaves are each other's buffers (cut into ordered launches, the plain
    store's result), and a load; only a step's last launch advances the
    index."""
    lib = StandInLibrary()
    spy = StandIn(lib)
    no_torch_add(monkeypatch)
    monkeypatch.setattr(scu, "load_library", lambda: lib)
    rng = np.random.default_rng(5)
    idx, ticket = torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int32)
    n = scu.MAX_ENTRIES + 6
    bufs = [torch.zeros(3, dtype=torch.int32) for _ in range(n)]
    spy.step([], [], bufs, [_rng_tensor(rng, (3,), torch.int32) for _ in range(n)], [], [], idx,
             ticket)
    assert int(idx) == 1
    p, q = _rng_tensor(rng, (4,), torch.int32), _rng_tensor(rng, (4,), torch.int32)
    wp, wq = p.clone(), q.clone()
    scu.scan_store_plain([], [], [wp, wq], [wq, wp], torch.zeros(1, dtype=torch.int64))
    spy.step([], [], [p, q], [q, p], [], [], idx, ticket)
    x_bufs, slots = random_load_tree(rng, 5)
    spy.load(x_bufs, slots, idx)
    assert [k for k, _ in lib.tables] == ["store", "store", "store", "store", "load"]
    assert spy.launches.by_key() == {"store": 4, "load": 1} and spy.n_launches == 5
    assert torch.equal(p, wp) and torch.equal(q, wq) and int(idx) == 2 and int(ticket) == 0
