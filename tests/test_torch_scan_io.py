"""A captured cycle's per-step loads and stores (kernels H2 / H3,
graal_tpu_torch/csrc/scan_io.cu, wrapper ops/scan_cuda.py) on the CPU.

- The plain versions (``scan_load_plain``, ``scan_store_plain``), which
  ``core.graphs.Scan`` runs on the CPU, equal the scan's step as it was
  before them (:func:`old_step`, kept here verbatim) on random trees:
  int32, int64, f32 and bool leaves, 0-d leaves, a chains axis, a body with
  no per-step inputs, capacity growth, a carry leaf that is another carry
  buffer, an output that is a carry buffer overwritten after it, and
  leaves at other strides.
- The card's route, the wrapper's own tables run by :func:`run_table` (a
  transcription of the kernels: every source of a launch read before any
  destination is written, as the kernels' parallel blocks may), gives the
  same results bit for bit, with one H2 and one H3 launch a step where
  nothing aliases and the store cut into ordered launches where it does.
  ``tests/test_torch_step_cycles.py`` runs an EM and a delta cycle through
  the same route against the JAX package's ``lax.scan`` cycles.
- The tables: layouts, word widths, the cuts, the checks, and the ctypes
  mirrors parsed from the .cu.
"""

import ctypes
import re
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

import tests.test_torch_state  # noqa: F401  (one torch thread per worker)
from graal_tpu_torch.core import graphs
from graal_tpu_torch.ops import scan_cuda as scu

CSRC = Path(__file__).resolve().parents[1] / "graal_tpu_torch" / "csrc"


def _bytes(ptr, count):
    return (ctypes.c_ubyte * count).from_address(ptr)


def run_table(t: scu.Table):
    """One launch of H2 / H3 on CPU memory, from its table: every entry's
    source read first, then every destination written (the kernels' blocks
    run in no order), then the step cell. Holds each entry's word width to
    its addresses and the blocks to its words."""
    step = ctypes.c_longlong.from_address(t.step_in).value
    reads = []
    block = 0
    for j in range(t.n):
        e = t.e[j]
        w = 1 << e.log_w
        assert e.first_block == block and e.inner % w == 0 and e.src % w == 0 \
            and e.dst % w == 0 and e.src_step % w == 0 and e.dst_step % w == 0
        assert e.outer == 1 or e.outer_stride % w == 0
        block += -(-(e.outer * e.inner // w) // scu.CHUNK_WORDS)
        src = e.src + step * e.src_step
        reads.append(b"".join(bytes(_bytes(src + r * e.outer_stride, e.inner))
                              for r in range(e.outer)))
    assert t.n_blocks == max(block, 1)
    for j, data in enumerate(reads):
        e = t.e[j]
        ctypes.memmove(e.dst + step * e.dst_step, data, len(data))
    if t.step_out:
        ctypes.c_longlong.from_address(t.step_out).value = step + t.step_add


class StandIn(scu.ScanKernels):
    """The wrapper with its launch replaced by :func:`run_table`: the
    tables are the wrapper's own, on CPU tensors."""

    def __init__(self):
        super().__init__()
        self.tables = []

    @staticmethod
    def _card(dev):
        pass

    def _launch(self, kind, dev, t):
        self.tables.append((kind, t.n))
        run_table(t)
        self.launches.add(dev, kind)


def route_to_card(monkeypatch):
    """Send every scan's loads and stores through their card branches and
    a stand-in wrapper; returns the stand-in."""
    spy = StandIn()
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
    assert t.n == 0 and t.n_blocks == 1
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
    assert const["CHUNK_WORDS"] == "4 * THREADS" and 4 * int(const["THREADS"]) == scu.CHUNK_WORDS
    assert ctypes.sizeof(scu.Table) <= 4096   # passed by value: the kernel-parameter limit
