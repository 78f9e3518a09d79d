"""A captured cycle's per-step loads and stores (kernels H2 / H3,
graal_tpu_torch/csrc/scan_io.cu, wrapper ops/scan_cuda.py) on the CPU.

- The plain versions (``scan_load_plain``, ``scan_store_plain``), which
  ``core.graphs.Scan`` runs on the CPU, equal the scan's step as it was
  before them (:func:`old_step`, kept here verbatim) on random trees:
  int32, int64, f32 and bool leaves, 0-d leaves, a chains axis, a body with
  no per-step inputs, capacity growth, a carry leaf that is another carry
  buffer, an output that is a carry buffer overwritten after it, and
  leaves at other strides.
- The card's route, the wrapper itself launching the tables it builds into
  a stand-in library that runs :func:`run_table` (a transcription of the
  kernels: every block's warps look their entries up by a binary search,
  every source of a launch read before any destination is written, as the
  kernels' parallel blocks may, and the launch counted on the counter the
  wrapper hands it), gives the same results bit for bit, with one H2 and
  one H3 launch a step where nothing aliases and the store cut into
  ordered launches where it does; no torch add counts a launch.
  ``tests/test_torch_step_cycles.py`` runs an EM and a delta cycle through
  the same route against the JAX package's ``lax.scan`` cycles.
- The block / warp layout on random tables (1 to MAX_ENTRIES entries, 1
  byte to a few MB, every word width, two-level strides) and on the dense
  EM store's 31 entries: every word of every entry copied exactly once,
  equal to the plain versions.
- The tables: layouts, word widths, the cuts, the checks, and the ctypes
  mirrors parsed from the .cu.
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
        for warp in range(scu.WARPS):
            unit = block * scu.WARPS + warp
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
    unit looked up and its words read first, then every destination written
    (the kernels' blocks run in no order), then the step cell and the
    launch's counter. Holds each entry's word width to its addresses and
    the layout to copy every word of every entry exactly once."""
    step = ctypes.c_longlong.from_address(t.step_in).value
    assert t.n <= scu.MAX_ENTRIES and list(t.first[t.n:]) == [scu.NO_ENTRY] * (
        scu.MAX_ENTRIES - t.n)
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
        per_run = e.inner // w
        r = q // per_run
        at = r * e.outer_stride + (q - r * per_run) * w
        src = _bytes(e.src + step * e.src_step, (e.outer - 1) * e.outer_stride + e.inner)
        reads.append((q, src[at[:, None] + np.arange(w)[None, :]]))
    for j, (q, data) in enumerate(reads):
        e = t.e[j]
        w = 1 << e.log_w
        dst = _bytes(e.dst + step * e.dst_step, e.outer * e.inner)
        dst[(q * w)[:, None] + np.arange(w)[None, :]] = data
    if t.step_out:
        ctypes.c_longlong.from_address(t.step_out).value = step + t.step_add
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


CASES = {"mixed": mixed_case, "no_xs": no_xs_case, "alias": alias_case, "strided": strided_case}


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


@pytest.mark.parametrize("name", tuple(CASES))
def test_card_route_equals_plain(name, monkeypatch):
    """The wrapper's tables, run as the kernels run them, give the plain
    results; one load and one store a step where nothing aliases."""
    want = run_case(name)
    spy = route_to_card(monkeypatch)
    got = run_case(name)
    assert_trees_equal(got, want)
    steps = sum(ys_leaf.shape[0] for _, ys in got for ys_leaf in leaves(ys)[:1])
    loads = [n for kind, n in spy.tables if kind == "load"]
    stores = [n for kind, n in spy.tables if kind == "store"]
    assert len(loads) == steps
    assert spy.launches.by_key() == {"load": steps, "store": len(stores)}
    if name == "alias":
        # the outputs (one reads p), then p <- q, then q <- p and r: three launches
        assert stores == [2, 1, 2] * steps
    elif name == "no_xs":
        # an output is the carry buffer b, which the last copy overwrites
        assert stores == [3, 1] * steps
    else:
        assert len(stores) == steps and len(set(stores)) == 1


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
    idx, step = torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64)
    ybuf, buf = torch.zeros((4, 3)), torch.zeros(5, dtype=torch.int32)
    ts = scu.store_tables([ybuf], [torch.ones(3)], [buf], [torch.ones(5, dtype=torch.int32)],
                          idx, step)
    assert len(ts) == 1 and ts[0].n == 2 and ts[0].step_out == idx.data_ptr()
    assert ts[0].step_add == 1 and ts[0].step_in == step.data_ptr()
    # a leaf that is its buffer, or the same bytes, is no copy
    assert scu.store_tables([], [], [buf], [buf], idx, step)[0].n == 0
    assert scu.store_tables([], [], [buf], [buf[:]], idx, step)[0].n == 0
    with pytest.raises(ValueError, match="convert no dtype"):
        scu.store_tables([], [], [buf], [torch.ones(5, dtype=torch.int64)], idx, step)
    with pytest.raises(ValueError, match="elements"):
        scu.store_tables([ybuf], [torch.ones(4)], [], [], idx, step)
    with pytest.raises(ValueError, match="two levels"):
        scu.store_tables([], [], [torch.zeros((3, 5))], [torch.zeros((5, 3)).T], idx, step)
    xb, slot = torch.zeros((6, 2, 2)), torch.zeros((2, 2))
    (t,) = scu.load_tables([xb], [slot], idx, step)
    assert t.n == 1 and t.e[0].src_step == 16 and t.step_out == step.data_ptr() \
        and t.step_add == 0
    (t,) = scu.load_tables([], [], idx, step)
    assert t.n == 0 and t.n_units == 0 and scu.blocks(t) == 1
    with pytest.raises(ValueError, match="on a card"):
        scu.SCAN.load([xb], [slot], idx, step)
    with pytest.raises(ValueError, match="on a card"):
        scu.SCAN.store([], [], [buf], [buf], idx, step)
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
    assert const["WARPS"] == "THREADS / 32" and int(const["THREADS"]) // 32 == scu.WARPS
    assert const["UNIT_WORDS"] == "32 * LANE_WORDS" \
        and 32 * int(const["LANE_WORDS"]) == scu.UNIT_WORDS
    assert ctypes.sizeof(scu.Table) == 3880 <= 4096   # by value: the kernel-parameter limit


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


def store_both_ways(y_bufs, ys, carry_bufs, new, row):
    """The store's tables run as the kernels run them, and the plain store,
    each into its own copies of the buffers; returns (kernel, plain) buffers
    and the tables."""
    yk, ck = clone_raw(y_bufs), clone_raw(carry_bufs)
    yp, cp = clone_raw(y_bufs), clone_raw(carry_bufs)
    step, idx = torch.tensor([row]), torch.tensor([row])
    tables = scu.store_tables(yk, ys, ck, new, idx, step)
    counter = torch.zeros((), dtype=torch.int64)
    for t in tables:
        t.counter = counter.data_ptr()
        run_table(t)
    scu.scan_store_plain(yp, ys, cp, new, torch.tensor([row]))
    assert int(idx) == row + 1 and int(counter) == len(tables)
    return yk + ck, yp + cp, tables


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
    idx, step = torch.tensor([row]), torch.tensor([-1])
    (t,) = scu.load_tables(x_bufs, slots, idx, step)
    counter = torch.zeros((), dtype=torch.int64)
    t.counter = counter.data_ptr()
    run_table(t)
    assert int(step) == row and int(counter) == 1
    assert_trees_equal(slots, scu.scan_load_plain(x_bufs, idx))


def test_dense_em_store_packs_its_scalars_into_shared_blocks():
    """The dense EM store's 31 entries take 31 warp units, so 4 blocks of 8
    warps (one block an entry before), and equal the plain store."""
    rng = np.random.default_rng(11)
    got, want, tables = store_both_ways(*dense_em_store_tree(rng), row=5)
    (t,) = tables
    assert t.n == 31 and t.n_units == 31 and scu.blocks(t) == 4
    assert list(t.first[:31]) == list(range(31))
    assert_trees_equal(got, want)


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
    made: a store of MAX_ENTRIES + 6 leaves (two launches), a store whose
    leaves are each other's buffers (cut into ordered launches, the plain
    store's result), and a load."""
    lib = StandInLibrary()
    spy = StandIn(lib)
    no_torch_add(monkeypatch)
    monkeypatch.setattr(scu, "load_library", lambda: lib)
    rng = np.random.default_rng(5)
    idx, step = torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64)
    n = scu.MAX_ENTRIES + 6
    bufs = [torch.zeros(3, dtype=torch.int32) for _ in range(n)]
    spy.store([], [], bufs, [_rng_tensor(rng, (3,), torch.int32) for _ in range(n)], idx, step)
    p, q = _rng_tensor(rng, (4,), torch.int32), _rng_tensor(rng, (4,), torch.int32)
    wp, wq = p.clone(), q.clone()
    scu.scan_store_plain([], [], [wp, wq], [wq, wp], torch.zeros(1, dtype=torch.int64))
    spy.store([], [], [p, q], [q, p], idx, step)
    x_bufs, slots = random_load_tree(rng, 5)
    spy.load(x_bufs, slots, idx, step)
    assert [k for k, _ in lib.tables] == ["store", "store", "store", "store", "load"]
    assert spy.launches.by_key() == {"store": 4, "load": 1} and spy.n_launches == 5
    assert torch.equal(p, wp) and torch.equal(q, wq) and int(idx) == int(step) == 1
