"""C1 / C2 and D3 as thread block clusters, held on the CPU.

The catalogue kernels (``csrc/candidates.cu``, C1 and C2) and the
selection and commit (``csrc/step.cu``, D3) are one launch a call: a
cluster of K blocks a genome or chain that counts its own launch. The
kernels run only on a card (``chip_smoke.py`` phases 3c and 3d hold them
to the plain versions there); here their parts are transcribed in numpy
and held to the plain versions and the JAX package on inputs made from
numpy seeds:

- the partition: K from n (``candidates_cuda.plan``) and from the rows to
  commit (``step_cuda.select_cluster``), each block's chunks, every
  fragment or row reduced and written exactly once;
- C1's scalars: each block's partial maxima folded over the cluster equal
  the kernels' former one-block pass, ``amax`` and the maxima the plain
  catalogue and ``graal_tpu.core.ops`` take (the popped and split
  states'), at n = 1 to 16,384, one genome broadcast or one a row, max_id
  given or not;
- D3's selection in one warp in its stated summation order: the drawn slot
  equals ``select_commit_*_plain``'s except where the two best keys lie
  within ``chip_smoke.SLOT_ULPS`` ulps (the smoke's margin rule);
- ``LaunchCount.counter``: the int64 a kernel adds one to counts one a
  call by key, as ``add`` does;
- the wrappers' card branches through a stand-in library (the plain
  version behind a C function's signature): the key's counter is handed
  to the kernel and no torch add counts beside it.
"""

import ctypes
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import ops as jops
from graal_tpu.core.state import GenomeState as JState
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core import ops as tops
from graal_tpu_torch.core.candidates import build_candidates_plain, mh_candidates_plain
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.ops import candidates_cuda as cc
from graal_tpu_torch.ops import step_cuda as sc
from graal_tpu_torch.ops.counts import Counted, LaunchCount
from tests.test_torch_catalogue import random_soa
from tests.test_torch_state import to_port  # noqa: F401  (one torch thread a worker)

SLOT_ULPS = 4          # chip_smoke.SLOT_ULPS: the drawn slot's margin
INT_MIN = np.iinfo(np.int32).min
THRESH = tm.THRESH_OVERFLOW
N_OPS = 13


# ---- the partition ------------------------------------------------------------

def c1_fragments(n, rank, k):
    """The fragments block ``rank`` of a K-block cluster reduces and writes
    (csrc/candidates.cu: chunks rank, rank + K, ... of THREADS)."""
    t = cc.THREADS
    return sorted(first + j * k * t for first in range(rank * t, rank * t + t)
                  for j in range(-(-n // (k * t))) if first + j * k * t < n)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 384, 2048, 2049, 16384])
def test_c1_partition_covers_every_fragment_once(n):
    k = cc.plan(n)
    assert 1 <= k <= cc.MAX_CLUSTER
    assert k == min(cc.MAX_CLUSTER, -(-n // cc.THREADS))
    seen = np.zeros(n, np.int64)
    for rank in range(k):
        got = c1_fragments(n, rank, k)
        # a block's fragments are whole chunks of neighbouring fragments
        assert all(i // cc.THREADS % k == rank for i in got)
        np.add.at(seen, got, 1)
    assert (seen == 1).all()
    # every block but the last of a short genome holds a fragment
    assert k == 1 or len(c1_fragments(n, k - 1, k)) >= 1


def d3_items(size, kind):
    """(K, the items block r thread t commits) of D3: fragments (dense) or
    rows of f_max (delta), r x 256 + t stepping by K x 256, the delta
    commit's rows ROWS_AHEAD at a time."""
    k = sc.select_cluster(size)
    t_n, step = sc.SELECT_THREADS, k * sc.SELECT_THREADS
    items = {}
    for r in range(k):
        for t in range(t_n):
            got = []
            i0 = r * t_n + t
            while i0 < size:
                ahead = 1 if kind == "select_dense" else sc.ROWS_AHEAD
                got += [i0 + u * step for u in range(ahead) if i0 + u * step < size]
                i0 += ahead * step
            items[r, t] = got
    return k, items


@pytest.mark.parametrize("kind,size", [("select_dense", n) for n in (1, 257, 384, 2049, 4096)]
                         + [("select_delta", f) for f in (1, 64, 1024, 1025, 4096, 16384)])
def test_d3_commit_covers_every_word_once(kind, size):
    k, items = d3_items(size, kind)
    per = sc.SELECT_THREADS
    assert k == max(1, min(sc.MAX_SELECT_CLUSTER, -(-size // per)))
    seen = np.zeros(size, np.int64)
    for got in items.values():
        np.add.at(seen, got, 1)
    assert (seen == 1).all()
    # up to the cluster's cap a thread commits one fragment or row
    if -(-size // per) <= sc.MAX_SELECT_CLUSTER:
        assert max(len(g) for g in items.values()) == 1


# ---- C1's scalars: partials folded over the cluster ----------------------------

def right_of(id_c, pos, a, up):
    """Fragments a split at f_a (``a``: its id_c and pos) moves to the right
    part (csrc/candidates.cu split_right)."""
    bound = a["pos"] if up else a["pos"] + 1
    return (id_c == a["id_c"]) & (pos >= bound)


def f_a_of(x, row, fa):
    """(f_a's id_c and pos, popping: it leaves a contig, cutting: a split
    at it moves fragments) of row ``row`` of the fields ``x`` (rows, n)."""
    a = dict(id_c=x["id_c"][row, fa], pos=x["pos"][row, fa])
    popping = x["l_cont"][row, fa] > 1
    cutting = x["activ"][row, fa] == 1 and popping and x["circ"][row, fa] == 0
    return a, popping, cutting


def c1_scalars(x, b, fa, mx_given, mh):
    """The kernel's (mx, m2, [m1[0], m1[1]]) for genome ``b`` of the fields
    ``x`` (rows, n) int32 (rows 1: broadcast): each block's partials (the
    ids the popped and split states keep, whether some fragment takes the
    fresh id, the state's ids when max_id is not given), folded over the
    cluster as integer maxima."""
    ids, pos = x["id_c"], x["pos"]
    rows, n = ids.shape
    row = 0 if rows == 1 else b
    a, popping, cutting = f_a_of(x, row, fa)
    k = cc.plan(n)
    parts = []
    for rank in range(k):
        mine = np.asarray(c1_fragments(n, rank, k), np.int64)
        c, p = ids[row, mine], pos[row, mine]
        part = dict(mx=INT_MIN, pop=INT_MIN, t1=[INT_MIN, INT_MIN], right=[0, 0])
        if mx_given is None:
            if rows == 1:
                part["mx"] = int(c.max(initial=INT_MIN))
            else:    # the whole state's cells, shared out over the cluster
                cells = np.arange(rank * cc.THREADS, rows * n, k * cc.THREADS)
                cells = (cells[:, None] + np.arange(cc.THREADS)).ravel()
                cells = cells[(cells < rows * n) & (cells // cc.THREADS % k == rank)]
                part["mx"] = int(ids.reshape(-1)[cells].max(initial=INT_MIN))
        keep = ~((mine == fa) & popping)
        part["pop"] = int(c[keep].max(initial=INT_MIN))
        for u in range(2):
            moved = right_of(c, p, a, u) & cutting
            part["t1"][u] = int(c[~moved].max(initial=INT_MIN))
            part["right"][u] = int(moved.any())
        parts.append(part)
    mx = max(q["mx"] for q in parts) if mx_given is None else mx_given
    m2 = max(max(q["pop"] for q in parts), mx + 1 if popping else INT_MIN, mx)
    m1 = []
    for u in range(2):
        m = max(max(q["t1"][u] for q in parts), mx + 1 if any(q["right"][u] for q in parts)
                else INT_MIN)
        m1.append(m if mh else max(m, mx))
    return mx, m2, m1


def one_block_scalars(x, b, fa, mx_given, mh):
    """The same scalars as the kernels' former one-block pass (a) computed
    them: each fragment's id, or mx + 1 where it takes the fresh id."""
    ids, pos = x["id_c"], x["pos"]
    rows, n = ids.shape
    row = 0 if rows == 1 else b
    a, popping, cutting = f_a_of(x, row, fa)
    mx = int(ids.max()) if mx_given is None else mx_given
    c, p = ids[row].astype(np.int64), pos[row]
    m2 = max(int(np.where((np.arange(n) == fa) & popping, mx + 1, c).max()), mx)
    m1 = []
    for u in range(2):
        t = int(np.where(right_of(c, p, a, u) & cutting, mx + 1, c).max())
        m1.append(t if mh else max(t, mx))
    return mx, m2, m1


def mini_view(rng, soa, m):
    """A delta mini-state: ``m`` fragments of a genome taken in order (a
    contig's run cut at the view's edge), their fields as they are."""
    n = len(soa["pos"])
    keep = np.sort(rng.choice(n, min(m, n), replace=False))
    return {k: v[keep] for k, v in soa.items()}


@pytest.mark.parametrize("max_given", [True, False])
@pytest.mark.parametrize("per_genome", [False, True])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 384, 16384])
def test_c1_folded_maxima(n, per_genome, max_given):
    """The cluster's folded maxima equal the one-block pass, ``amax``, and
    the maxima the plain catalogue (and the JAX package's ops) take."""
    rng = np.random.default_rng(n * 4 + 2 * per_genome + max_given)
    n_rows = 3 if per_genome else 1
    soas = []
    for r in range(n_rows):
        big = random_soa(rng, n=n + (r % 2) * (n // 2), n_contigs=max(1, min(n, 7)),
                         circ=True, repeats=True)
        soas.append(mini_view(rng, big, n) if r % 2 else big)
    fields = {k: np.stack([s[k] for s in soas]).astype(np.int32) for k in soas[0]}
    ids = fields["id_c"]
    state = TState(*[torch.as_tensor(fields[k] if per_genome else fields[k][0])
                     for k in TState._fields])
    top = int(ids.max())
    for b in range(n_rows):
        row = b if per_genome else 0
        for fa in {0, n - 1, int(rng.integers(0, n))}:
            given = top + int(rng.integers(0, 5)) if max_given else None
            for mh in (False, True):
                got = c1_scalars(fields, b, fa, given, mh)
                assert got == one_block_scalars(fields, b, fa, given, mh)
            mx, m2, m1 = c1_scalars(fields, b, fa, given, False)
            if not max_given:
                assert mx == top == int(state.id_c.amax())
            # the plain catalogue's maxima on this genome (core/candidates.py)
            one = TState(*[torch.as_tensor(fields[k][row])[None] for k in TState._fields])
            t_fa = torch.tensor([fa])
            t_mx = torch.tensor([mx], dtype=torch.int32)
            assert m2 == int(torch.maximum(tops.pop_out(one, t_fa, t_mx).id_c.amax(-1), t_mx))
            js = JState(**{k: jnp.asarray(fields[k][row]) for k in TState._fields})
            assert m2 == max(int(jops.pop_out(js, fa, mx).id_c.max()), mx)
            for u in range(2):
                plain = torch.maximum(tops.split(one, t_fa, u, t_mx).id_c.amax(-1), t_mx)
                assert m1[u] == int(plain)
                assert m1[u] == max(int(jops.split(js, fa, u, mx).id_c.max()), mx)
                # C2's translocations take the split state's own maximum
                assert c1_scalars(fields, b, fa, given, True)[2][u] == int(
                    tops.split(one, t_fa, u, t_mx).id_c.amax(-1))


# ---- D3's selection in one warp -------------------------------------------------

def f32(x):
    return np.float32(x)


def warp_select(score, gumbel, valid_nb, overflow, f_t, thresh=THRESH):
    """csrc/step.cu ``select_warp`` for one chain, in f32 and in its order:
    lanes take the slots lane-strided; minima, maxima, counts and argmaxes
    exact; the normaliser lane l's slots summed left to right from 0, then
    the 32 lane sums folded as s[l] += s[l + o], o = 16, 8, 4, 2, 1.
    Returns (the drawn slot, the keys, the count inside the window)."""
    m = valid_nb.shape[0]
    s_n = m * N_OPS
    k = np.arange(s_n)
    nb, op = k // N_OPS, k % N_OPS
    ok = ~((op < 2) & (nb > 0)) & (valid_nb[nb] | ((nb == 0) & (op < 2)))
    if overflow is not None:
        ok &= ~overflow[nb]
    flat = score.reshape(-1).astype(np.float32)
    lo = flat[ok].min() if ok.any() else np.float32(np.inf)
    best = int(np.argmax(np.where(ok, flat, -np.inf)))
    hi = np.where(ok, flat - lo, f32(0)).max()
    base = f32(hi - f32(thresh))
    x = np.where(ok, (flat - lo) - base, f32(0)).astype(np.float32)
    filtered = np.where(x < 0, f32(0), x).astype(np.float32)
    lanes = np.zeros(32, np.float32)
    for lane in range(32):
        for kk in range(lane, s_n, 32):
            lanes[lane] = f32(lanes[lane] + filtered[kk])
    o = 16
    while o:
        lanes[:o] = (lanes[:o] + lanes[o:2 * o]).astype(np.float32)
        o //= 2
    total = lanes[0]
    n_pos = int((filtered > 0).sum())
    with np.errstate(divide="ignore", invalid="ignore"):
        pr = (filtered / total).astype(np.float32)
        logp = np.log(pr).astype(np.float32)
    if isinstance(f_t, float):
        lw = (logp * f32(np.float32(1.0) / np.float32(f_t))).astype(np.float32)
    else:
        lw = (logp / f32(f_t)).astype(np.float32)
    lw = np.where(pr > 0, lw, -np.inf).astype(np.float32)
    keys = (lw + gumbel.astype(np.float32)).astype(np.float32)
    cat = int(np.argmax(keys))
    return (best if n_pos <= 1 else cat), keys, n_pos


def margin_ok(sel_k, sel_p, keys, n_pos):
    """chip_smoke.slot_margin's rule for one draw: equal slots, or a draw
    the categorical decides whose two best keys lie within SLOT_ULPS ulps
    of the best, the kernel's slot one of them. Returns (ok, close)."""
    order = np.argsort(-keys, kind="stable")
    best, second = keys[order[0]], keys[order[1]]
    ulp = np.spacing(np.abs(best))
    close = n_pos > 1 and np.isfinite(best) and best - second <= SLOT_ULPS * ulp
    return sel_k == sel_p or (close and sel_k in order[:2]), close


@pytest.mark.parametrize("path", ["dense", "delta"])
@pytest.mark.parametrize("m", [5, 10, 20, 80])
def test_d3_selection_order(m, path):
    """The warp's draw against select_commit_*_plain's over 300 draws a
    case: random scores (a spread about the 30-window), masks, noise, a
    temperature as a number or a tensor; the delta path with overflowing
    slots and the all-overflow no-op."""
    rng = np.random.default_rng(100 * m + (path == "delta"))
    n_draws, c = 300, 1
    close_n = 0
    for d in range(n_draws):
        spread = (2.0, 8.0, 40.0)[d % 3]
        score = rng.normal(-1000.0, spread, (c, m, N_OPS)).astype(np.float32)
        valid = rng.random((c, m)) < 0.8
        gum = rng.gumbel(size=(c, m * N_OPS)).astype(np.float32)
        f_t = (1.0, 0.8, 2.5)[d % 3] if d % 2 == 0 else np.float32(0.3 + 3.7 * rng.random())
        f_t_port = f_t if isinstance(f_t, float) else torch.tensor([f_t])
        ids = torch.as_tensor(rng.integers(0, 50, (c, m)).astype(np.int32))
        f_a = torch.tensor([3])
        blacklist = torch.zeros(50, dtype=torch.bool)
        if path == "dense":
            over = None
            n = 4
            st = TState(*[torch.zeros((c, n), dtype=torch.int32) for _ in TState._fields])
            cands = TState(*[torch.zeros((c * m * N_OPS, n), dtype=torch.int32)
                             for _ in TState._fields])
            _, _, w_sel = tm.select_commit_dense_plain(
                st, cands, torch.as_tensor(score), ids, torch.as_tensor(valid), f_a,
                torch.as_tensor(gum), f_t_port, blacklist, THRESH)
        else:
            over = rng.random((c, m)) < (1.0 if d % 10 == 9 else 0.2)
            f_max, n = 4, 8
            st = TState(*[torch.zeros((c, n), dtype=torch.int32) for _ in TState._fields])
            minis = TState(*[torch.zeros((c, m, N_OPS, f_max), dtype=torch.int32)
                             for _ in TState._fields])
            rows = torch.zeros((c, m, f_max), dtype=torch.int64)
            _, _, _, w_sel = td.select_commit_delta_plain(
                st, minis, rows, torch.zeros((c, m, f_max), dtype=torch.bool),
                torch.as_tensor(score), ids, torch.as_tensor(valid), torch.as_tensor(over), f_a,
                torch.as_tensor(gum), f_t_port, blacklist, THRESH)
        sel, keys, n_pos = warp_select(score[0], gum[0], valid[0],
                                       None if over is None else over[0], f_t)
        # the draw's keys as the plain version holds them, under the margin rule
        p_keys, p_pos, _ = tm.slot_keys(
            torch.as_tensor(gum), torch.as_tensor(score), torch.as_tensor(valid), f_t_port,
            slot_valid=None if over is None else
            (~torch.as_tensor(over))[..., None].expand(c, m, N_OPS))
        assert int(p_pos[0]) == n_pos
        ok, close = margin_ok(sel, int(w_sel[0]), p_keys[0].numpy(), n_pos)
        assert ok, (d, sel, int(w_sel[0]))
        close_n += close
    assert close_n <= n_draws // 50


# ---- LaunchCount: the counter a kernel adds to ---------------------------------

def bump(counter):
    """What a kernel's block 0, thread 0 does: add one to the int64 at the
    pointer it was handed."""
    ctypes.c_int64.from_address(counter.data_ptr()).value += 1


def test_counter_is_the_key_int64():
    lc = LaunchCount()
    dev = torch.device("cpu")
    a, b = lc.counter(dev, "em"), lc.counter(dev, "mh")
    assert a.dtype == torch.int64 and a.dim() == 0 and a.data_ptr() != b.data_ptr()
    assert lc.counter(dev, "em") is a          # one counter a key, made once
    for _ in range(3):
        bump(a)
    bump(b)
    assert lc.by_key() == {"em": 3, "mh": 1}


def test_counter_and_add_count_alike():
    """Counts a kernel keeps through the pointer and counts the wrapper adds
    read, reset and sum the same way; the pointer outlives a reset (a
    captured launch keeps it)."""
    class W(Counted):
        def __init__(self):
            self.launches = LaunchCount()

    dev = torch.device("cpu")
    kernel, wrapper = W(), W()
    for key in ("select_dense", "select_delta", "select_dense"):
        bump(kernel.launches.counter(dev, key))
        wrapper.launches.add(dev, key)
    assert kernel.launches.by_key() == wrapper.launches.by_key() == {"select_dense": 2,
                                                                      "select_delta": 1}
    assert kernel.n_launches == wrapper.n_launches == 3
    ptr = kernel.launches.counter(dev, "select_dense").data_ptr()
    kernel.n_launches = 0
    assert kernel.launches.by_key() == {}
    assert kernel.launches.counter(dev, "select_dense").data_ptr() == ptr
    bump(kernel.launches.counter(dev, "select_dense"))
    assert kernel.launches.by_key() == {"select_dense": 1}


# ---- the card branches through a stand-in library ------------------------------

def no_torch_add(monkeypatch):
    """Make a counting add beside a launch fail the test."""
    def refuse(self, device, key=None):
        raise AssertionError(f"a torch add counted {key} beside a self-counting kernel")

    monkeypatch.setattr(LaunchCount, "add", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))


def copy_into(ptr, x):
    x = x.contiguous()
    ctypes.memmove(ptr, x.data_ptr(), x.numel() * x.element_size())


@pytest.mark.parametrize("kind", ["em", "mh"])
def test_catalogue_card_branch_counts_in_the_kernel(kind, monkeypatch):
    """C1 / C2's wrapper hands the kernel its kind's counter and K =
    plan(n), one launch a call, and adds nothing itself."""
    no_torch_add(monkeypatch)
    rng = np.random.default_rng(11)
    soa = random_soa(rng, n=300, n_contigs=6, circ=True, repeats=True)
    state = TState(*[torch.as_tensor(soa[k]) for k in TState._fields])
    fb = torch.as_tensor(rng.integers(0, 300, 5))
    plain = {"em": build_candidates_plain, "mh": mh_candidates_plain}[kind]
    wrapper = cc.Catalogue()
    calls = []

    def catalogue(mh, fields, row_strides, col_strides, n, b, rows, fa, fa_value, fa_stride,
                  fa_is64, fb_ptr, fb_is64, mx, mx_value, mx_stride, mx_is64, mx_none, counter,
                  out, slots, cluster, stream):
        calls.append(cluster)
        assert (mh, n, b, slots) == (cc.KINDS.index(kind), 300, 5, 14)
        assert counter == wrapper.launches.counter(torch.device("cpu"), kind).data_ptr()
        ctypes.c_int64.from_address(counter).value += 1      # the kernel's own count
        copy_into(out, torch.stack(tuple(plain(state, 7, fb, None, True))))
        return 0

    monkeypatch.setattr(cc, "load_library", lambda: types.SimpleNamespace(catalogue=catalogue))
    monkeypatch.setattr(cc.Catalogue, "_card", staticmethod(lambda dev: None))
    for _ in range(2):
        got = wrapper(kind, state, 7, fb, None, True)
        assert all(torch.equal(a, b) for a, b in zip(got, plain(state, 7, fb, None, True)))
    assert calls == [cc.plan(300)] * 2 == [2, 2]
    assert wrapper.launches.by_key() == {kind: 2}


def select_inputs(rng, c=2, m=5, n=40, f_max=8):
    st = TState(*[torch.as_tensor(rng.integers(0, 9, (c, n)).astype(np.int32))
                  for _ in TState._fields])
    score = torch.as_tensor(rng.normal(-1000.0, 5.0, (c, m, N_OPS)).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, n, (c, m)).astype(np.int32))
    valid = torch.as_tensor(rng.random((c, m)) < 0.8)
    gum = torch.as_tensor(rng.gumbel(size=(c, m * N_OPS)).astype(np.float32))
    f_a = torch.as_tensor(rng.integers(0, n, c))
    blacklist = torch.zeros(n, dtype=torch.bool)
    cands = TState(*[torch.as_tensor(rng.integers(0, 9, (c, m * N_OPS, n)).astype(np.int32))
                     for _ in TState._fields])
    perm = np.stack([rng.permutation(n)[:f_max] for _ in range(c * m)]).reshape(c, m, f_max)
    minis = TState(*[torch.as_tensor(rng.integers(0, 9, (c, m, N_OPS, f_max)).astype(np.int32))
                     for _ in TState._fields])
    return dict(st=st, score=score, ids=ids, valid=valid, gum=gum, f_a=f_a, bl=blacklist,
                cands=cands, rows=torch.as_tensor(perm),
                rows_valid=torch.as_tensor(rng.random((c, m, f_max)) < 0.7),
                overflow=torch.as_tensor(rng.random((c, m)) < 0.2), minis=minis)


@pytest.mark.parametrize("path", ["dense", "delta"])
def test_select_card_branch_counts_in_the_kernel(path, monkeypatch):
    """D3's wrapper hands the kernel its kind's counter and K =
    select_cluster(...) in the argument block, one launch a call, and adds
    nothing itself (no step kernel is counted beside its launch any more)."""
    rng = np.random.default_rng(12)
    x = select_inputs(rng)
    step = sc.StepKernels()
    dev = torch.device("cpu")
    kind = "select_" + path
    blocks = []

    def dense(args, stream):
        a = args._obj
        blocks.append(a.s.cluster)
        assert a.s.counter == step.launches.counter(dev, kind).data_ptr()
        ctypes.c_int64.from_address(a.s.counter).value += 1
        new, (s, op, fb), sel = tm.select_commit_dense_plain(
            x["st"], TState(*[v.reshape(-1, v.shape[-1]) for v in x["cands"]]), x["score"],
            x["ids"], x["valid"], x["f_a"], x["gum"], 0.7, x["bl"], THRESH)
        copy_into(a.out, torch.stack(tuple(new)))
        for ptr, v in ((a.s.sel, sel), (a.s.score_out, s), (a.s.op, op), (a.s.fb, fb)):
            copy_into(ptr, v)
        return 0

    def delta(args, stream):
        a = args._obj
        blocks.append(a.s.cluster)
        assert a.s.counter == step.launches.counter(dev, kind).data_ptr()
        ctypes.c_int64.from_address(a.s.counter).value += 1
        new, d_sel, (op, fb, n_over), sel = td.select_commit_delta_plain(
            x["st"], x["minis"], x["rows"], x["rows_valid"], x["score"], x["ids"], x["valid"],
            x["overflow"], x["f_a"], x["gum"], 0.7, x["bl"], THRESH)
        for f, ptr in zip(sc.MUTABLE, a.dst):
            copy_into(ptr, getattr(new, f))
        for ptr, v in ((a.s.sel, sel), (a.s.score_out, d_sel), (a.s.op, op), (a.s.fb, fb),
                       (a.n_over, n_over)):
            copy_into(ptr, v)
        return 0

    no_torch_add(monkeypatch)
    monkeypatch.setattr(sc, "load_library", lambda: types.SimpleNamespace(
        select_commit_dense=dense, select_commit_delta=delta))
    monkeypatch.setattr(sc.StepKernels, "_device", staticmethod(lambda t: t.device))
    for _ in range(3):
        if path == "dense":
            fields, s, op, fb, sel = step.select_dense(
                x["st"], x["cands"], x["score"], x["ids"], x["valid"], x["f_a"], x["gum"], 0.7,
                x["bl"], THRESH)
            want = tm.select_commit_dense_plain(
                x["st"], TState(*[v.reshape(-1, v.shape[-1]) for v in x["cands"]]),
                x["score"], x["ids"], x["valid"], x["f_a"], x["gum"], 0.7, x["bl"], THRESH)
            assert all(torch.equal(a, b) for a, b in zip(fields, want[0]))
            assert torch.equal(sel, want[2]) and torch.equal(op, want[1][1])
        else:
            dst = {f: v.clone() for f, v in x["st"]._asdict().items()}
            d_sel, op, fb, n_over, sel = step.select_delta(
                dst, x["minis"]._asdict(), x["rows"], x["rows_valid"], x["score"], x["ids"],
                x["valid"], x["overflow"], x["f_a"], x["gum"], 0.7, x["bl"], THRESH)
            want = td.select_commit_delta_plain(
                x["st"], x["minis"], x["rows"], x["rows_valid"], x["score"], x["ids"],
                x["valid"], x["overflow"], x["f_a"], x["gum"], 0.7, x["bl"], THRESH)
            assert all(torch.equal(dst[f], getattr(want[0], f)) for f in sc.MUTABLE)
            assert torch.equal(sel, want[3]) and torch.equal(n_over, want[2][2])
    size = x["st"].pos.shape[1] if path == "dense" else x["rows"].shape[2]
    assert blocks == [sc.select_cluster(size)] * 3
    assert step.launches.by_key() == {kind: 3}
