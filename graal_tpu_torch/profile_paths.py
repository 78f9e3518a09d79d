"""Where a step's time goes on the card, for each main path of the port.

Run from the repository root on a GPU:

    python -m graal_tpu_torch.profile_paths [PATH ...] [--warm 64] [--steps 48]
        [--modes graph,eager] [--table-dir DIR]

PATH is any of ``dense`` (the flagship dense EM path, nuisance sampling on),
``dense_repeat`` (the same on ``entry.repeat_problem``), ``delta`` (the
100k chr1-class delta path, ``ScaleRunner.cycle_for(1024, 4)``),
``delta_repeat`` (the 20k chr1-scale repeat delta path, 200 duplicated
bins), and ``chains`` / ``chains_repeat`` (the same two problems' tempered
chains path, ``ScaleRunner.chains_cycle_for(1024, 4)``: 4 chains from
distinct shuffles, each with its own parameters, on a ladder up to
T = 4, one B2 and one B4 launch a step for all of them); ``tempered`` (4
tempered chains of the flagship dense problem, ``parallel.tempering``'s
cycle, one B1 launch at B = 260 a step for all of them), ``mtm`` and
``mh`` (the flagship's dense MTM / MH cycles, ``core.mtm.make_mtm_cycle``
with the jump table of ``entry.problem_jump_table``: two B1 launches at B
= 91 a step), ``delta_mtm`` (the 100k problem's delta MTM cycle at
f_max 1,024 as ``ScaleRunner.run_mtm`` builds it: B4 and B2 twice a step,
M = 7) and ``delta_repeat_mh`` (the 20k repeat problem's delta MH cycle,
the same way: the repeat engine v2, B4, B2 and the copy corrections F1 /
F2 twice a step); all eleven by default. Each path runs in each of ``--modes``: ``graph``, its cycle as
the captured CUDA graph the entry points run (``core.graphs.Scan``,
replayed once a step), and ``eager``, the same step body run eagerly
(``capture=False``). Each run takes ``--warm`` steps (the graph's first
step and capture among them), then a window of ``--steps`` steps timed on
the host clock (after a device sync), then another window of ``--steps``
steps under ``torch.profiler`` (a chains step is a step of every chain).

Prints one JSON line per path and mode (``mode``: graph or eager):

- ``wall_ms_per_step``: the unprofiled window's host time per step;
- ``device_ms_per_step``: the profiled window's device time per step, the
  sum of the self device times of the device-side events (kernels,
  memcpy, memset; user annotations left out). The rows of host operators
  (``aten::...``) also carry the device time of the kernels they launched;
  they are not added, or every kernel would count twice. This is the
  "Self CUDA time total" of the profiler's table;
- ``device_busy``: device_ms_per_step / wall_ms_per_step, so the device's
  idle share is 1 - device_busy;
- ``device_event_ms_per_step`` (graph rows): a third window's time between
  CUDA events, the window queued behind a spin kernel that outlasts its
  enqueue (a replay is one launch a step), so that no host time is in it:
  the device's timeline from the first kernel to the last, the gaps
  between kernels included (``device_ms_per_step`` sums the kernels);
- ``aten_calls_per_step``: host operator calls per step, views included
  (a graphed step makes none: its calls are the cycle's copies in and
  out, spread over the window's steps);
- ``kernels``: the device-side rows summed by class, {class: [ms per
  step, calls per step]}: ``catalogue`` (C1 / C2, the candidate
  catalogues), ``mtm`` (E1-E3: the MTM / MH step's neighbour set, draw
  and acceptance), ``corr`` (F1 / F2: the repeat engine's copy
  corrections), ``rows`` (G1-G3: the delta steps' member rows and
  mini-states), ``delta_inputs`` (I1 / I2: the delta scoring call's slot
  scalars, parameter rows, sub-row vectors and window keys), ``vectors``
  (H1: the dense scorers' sub-fragment vectors and parameter row),
  ``scan_io`` (H2 / H3: the captured cycle's per-step
  loads and stores), ``step`` (the step's head, the selection and commit
  D3, the step's tail; an earlier tree's nuisance move and neighbour draw
  D1 / D2 class here too), ``scorers`` (B1-B4), ``gather`` (gathers, scatters and
  index kernels), ``elementwise`` (torch's elementwise kernels),
  ``reduce``, ``copy`` (memcpy, memset) and ``other``; a step's count of
  each is its calls per step;
- ``top``: the largest device-side rows, (name, ms per step, calls per
  step).

``--table-dir`` also writes each path's ``key_averages`` table there.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from graal_tpu_torch.entry import DELTA

F_MAX = 1024
PATHS = ("dense", "dense_repeat", "delta", "delta_repeat", "chains", "chains_repeat",
         "tempered", "mtm", "mh", "delta_mtm", "delta_repeat_mh")
N_CHAINS = 4
MTM_DELTA = 5     # the refinement stages' jump-table partners
SPIN_HZ = 2.0e9   # torch.cuda._sleep cycles a second: above any H100 SM clock


def dense_runner(device, repeat: bool, capture: bool):
    """``run(order) -> None``: EM steps of the flagship dense problem (or
    its repeat twin) from the exploded start, scored by the dense kernel."""
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem, repeat_problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

    state, table, params, obs, nb = (repeat_problem if repeat else problem)(device=device)
    scorer = make_dense_scorer(table, obs, device)
    cycle = mcmc.make_em_cycle(table, obs, nb, DELTA, sample_param=True, scorer=scorer,
                               capture=capture)
    gen = torch.Generator(device=device).manual_seed(0)
    cur = mcmc.explode_genome(state)
    carry = dict(state=cur, params=params,
                 l_t=scorer(GenomeState(*[x[None] for x in cur]), params)[0])

    def run(order):
        carry["state"], carry["params"], carry["l_t"], _ = cycle(
            carry["state"], gen, carry["params"], order, carry["l_t"], 1.0)

    return run, torch.randperm(state.n_frags, generator=gen, device=device)


def tempered_runner(device, capture: bool):
    """``run(orders) -> None``: steps of ``N_CHAINS`` tempered chains of the
    flagship dense problem from its exploded start, on a ladder up to T =
    4, scored by the dense kernel."""
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer
    from graal_tpu_torch.parallel.tempering import make_tempered_cycle, temperature_ladder

    state, table, params, obs, nb = problem(device=device)
    scorer = make_dense_scorer(table, obs, device)
    cycle = make_tempered_cycle(table, obs, nb, DELTA, scorer=scorer, capture=capture)
    gen = torch.Generator(device=device).manual_seed(0)
    start = mcmc.explode_genome(state)
    l0 = scorer(GenomeState(*[x[None] for x in start]), params)[0]
    ladder = torch.as_tensor(temperature_ladder(N_CHAINS, t_max=4.0), device=device)
    carry = dict(states=GenomeState(*[x.expand(N_CHAINS, -1).clone() for x in start]),
                 l_ts=l0.expand(N_CHAINS).clone())

    def run(orders):
        carry["states"], carry["l_ts"], _ = cycle(carry["states"], gen, params, orders,
                                                  carry["l_ts"], ladder)

    return run, torch.stack([torch.randperm(state.n_frags, generator=gen, device=device)
                             for _ in range(N_CHAINS)])


def mtm_runner(device, variant: str, capture: bool):
    """``run(order) -> None``: dense MTM (or MH) steps of the flagship
    problem from its exploded start, both passes of a step scored by the
    dense kernel."""
    from graal_tpu_torch.core import mcmc, mtm
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem, problem_jump_table
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

    state, table, params, obs, _ = problem(device=device)
    scorer = make_dense_scorer(table, obs, device)
    cycle = mtm.make_mtm_cycle(table, obs, problem_jump_table(state, table, obs, MTM_DELTA),
                               variant=variant, scorer=scorer, capture=capture)
    gen = torch.Generator(device=device).manual_seed(0)
    cur = mcmc.explode_genome(state)
    carry = dict(state=cur, l_t=scorer(GenomeState(*[x[None] for x in cur]), params)[0])

    def run(order):
        carry["state"], carry["l_t"], _ = cycle(carry["state"], gen, params, order,
                                                carry["l_t"], 1.0)

    return run, torch.randperm(state.n_frags, generator=gen, device=device)


def problem_and_runner(device, repeat: bool):
    """(truth, shuffled, table, params, sobs, runner): the chr1-class
    problem, or with ``repeat`` the 20k repeat problem, and its
    ScaleRunner."""
    from graal_tpu_torch.entry import scale_problem, scale_repeat_problem
    from graal_tpu_torch.scale import ScaleRunner

    if repeat:
        truth, shuf, table, params, sobs, id_d = scale_repeat_problem(device=device)
        return truth, shuf, table, params, sobs, ScaleRunner(table, sobs, params, id_d=id_d)
    truth, shuf, table, params, sobs = scale_problem(device=device)
    return truth, shuf, table, params, sobs, ScaleRunner(table, sobs, params)


def delta_mtm_runner(device, capture: bool, problem: str = "scale", variant: str = "mtm"):
    """``run(order) -> None``: delta MTM (``variant`` "mtm") or MH ("mh")
    steps from the shuffled start of the chr1-class problem (``problem``
    "scale") or the 20k repeat problem ("repeat": the repeat engine v2,
    its copy corrections by F1 / F2), at f_max 1,024
    (``ScaleRunner.run_mtm``'s cycle: the MH catalogue through the
    runner's B4 and B2)."""
    from graal_tpu_torch.core.mtm import make_delta_mtm_cycle

    repeat = {"scale": False, "repeat": True}[problem]
    _, shuf, table, params, sobs, runner = problem_and_runner(device, repeat)
    cycle = make_delta_mtm_cycle(table, runner.jump_table(MTM_DELTA, shuf.n_frags), F_MAX,
                                 sobs, variant=variant, band_w=runner.w,
                                 obs_grid=runner.obs_grid, mini_grid=runner.mini_grid,
                                 rep=shuf.rep, capture=capture)
    gen = torch.Generator(device=device).manual_seed(0)
    carry = dict(state=shuf, l_t=runner.anchor_fn()(shuf, params))

    def run(order):
        carry["state"], carry["l_t"], _ = cycle(carry["state"], gen, params, order,
                                                carry["l_t"], 1.0)

    return run, torch.randperm(shuf.n_frags, generator=gen, device=device)


def runner_cycle(runner, rep, capture: bool):
    """The cycle ``ScaleRunner.cycle_for(1024, 4)`` and ``chains_cycle_for``
    build (no re-anchor, the runner's kernel wrappers), with ``capture``."""
    from graal_tpu_torch.core import delta as delta_mod

    return delta_mod.make_delta_em_cycle(runner.table, None, runner.nb, DELTA, F_MAX,
                                         sobs=runner.sobs, anchor_fn=False, band_w=runner.w,
                                         obs_grid=runner.obs_grid, mini_grid=runner.mini_grid,
                                         rep=rep, capture=capture)


def delta_runner(device, repeat: bool, capture: bool):
    """``run(order) -> None``: delta steps of cycle_for(1024, 4) from the
    shuffled start of the chr1-class problem (or the 20k repeat problem)."""
    _, shuf, table, params, sobs, runner = problem_and_runner(device, repeat)
    cycle = runner_cycle(runner, shuf.rep, capture)
    gen = torch.Generator(device=device).manual_seed(0)
    carry = dict(state=shuf, l_t=runner.anchor_fn()(shuf, params))

    def run(order):
        carry["state"], carry["l_t"], _ = cycle(carry["state"], gen, params, order,
                                                carry["l_t"], 1.0)

    return run, torch.randperm(shuf.n_frags, generator=gen, device=device)


def chains_runner(device, repeat: bool, capture: bool):
    """``run(orders) -> None``: steps of ``N_CHAINS`` tempered chains of
    chains_cycle_for(1024, 4) from distinct shuffles of the chr1-class
    problem (or the 20k repeat problem), each chain with its own
    parameters (the problem's scaled by 1 + 0.01 c)."""
    from graal_tpu_torch.core.model import RippeParams
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.parallel.tempering import temperature_ladder
    from graal_tpu_torch.utils.synthetic_sparse import shuffle_genome

    truth, shuf, table, params, sobs, runner = problem_and_runner(device, repeat)
    pieces = int(shuf.n_contigs())
    starts = [shuf] + [shuffle_genome(truth, pieces, seed=100 + c) for c in range(N_CHAINS - 1)]
    states = GenomeState(*[torch.stack(xs) for xs in zip(*starts)])
    params_c = RippeParams(*[torch.stack([x * (1.0 + 0.01 * c) for c in range(N_CHAINS)])
                             for x in params])
    ladder = torch.as_tensor(temperature_ladder(N_CHAINS, t_max=4.0), device=device)
    cycle = runner_cycle(runner, shuf.rep, capture)
    gen = torch.Generator(device=device).manual_seed(0)
    carry = dict(states=states, l_ts=runner.chains_anchor_fn()(states, params_c))

    def run(orders):
        carry["states"], carry["l_ts"], _ = cycle(carry["states"], gen, params_c, orders,
                                                  carry["l_ts"], ladder)

    return run, torch.stack([torch.randperm(shuf.n_frags, generator=gen, device=device)
                             for _ in range(N_CHAINS)])


# the classes of ``kernels``, matched in this order on the lower-cased name
KERNEL_CLASSES = (("catalogue", ("catalogue",)),
                  ("mtm", ("mtm_set_kernel", "mtm_draw_kernel", "mtm_accept_kernel")),
                  ("corr", ("corr_frozen_kernel", "corr_sums_kernel")),
                  ("rows", ("rows_counts_kernel", "rows_write_kernel", "rows_gather_kernel")),
                  # before "vectors": delta_vectors_kernel holds its key
                  ("delta_inputs", ("delta_slots_kernel", "delta_vectors_kernel")),
                  ("vectors", ("vectors_kernel",)),
                  ("scan_io", ("scan_load_kernel", "scan_store_kernel")),
                  # the step's head and tail, D3; and the kernels the head and tail
                  # replaced, so that an earlier tree's rows class the same way
                  ("step", ("step_head_kernel", "step_tail_kernel", "select_commit_",
                            "nuisance_propose_kernel", "nuisance_accept_kernel",
                            "neighbours_kernel")),
                  ("scorers", ("ll_dense", "ll_mini", "ll_repeat", "obsgrid")),
                  ("gather", ("gather", "scatter", "index")),
                  ("elementwise", ("elementwise_kernel",)),
                  ("reduce", ("reduce_kernel",)),
                  ("copy", ("memcpy", "memset")))


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def by_class(rows, steps: int) -> dict:
    """Device-side rows summed by :func:`kernel_class`: {class: [ms per
    step, calls per step]}."""
    out = {}
    for e in rows:
        acc = out.setdefault(kernel_class(e.key), [0.0, 0.0])
        acc[0] += self_device_us(e) / 1e3 / steps
        acc[1] += e.count / steps
    return {k: [round(ms, 4), round(calls, 2)] for k, (ms, calls) in sorted(out.items())}


def device_rows(averages):
    """The device-side rows of ``key_averages()``: kernels, memcpy and
    memset, without user annotations."""
    from torch.autograd import DeviceType

    return [e for e in averages
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def self_device_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return float(e.self_cuda_time_total if t is None else t)


def profile_path(name: str, device, warm: int, steps: int, table_dir: Path | None,
                 mode: str = "graph"):
    from torch.profiler import ProfilerActivity, profile

    capture = mode == "graph"
    if name in ("mtm", "mh"):
        run, order = mtm_runner(device, name, capture)
    elif name in ("tempered", "delta_mtm"):
        run, order = {"tempered": tempered_runner, "delta_mtm": delta_mtm_runner}[name](
            device, capture)
    elif name == "delta_repeat_mh":
        run, order = delta_mtm_runner(device, capture, problem="repeat", variant="mh")
    else:
        make = {"delta": delta_runner, "chains": chains_runner}.get(name.split("_")[0],
                                                                     dense_runner)
        run, order = make(device, name.endswith("_repeat"), capture)
    if warm + 3 * steps > order.shape[-1]:
        raise ValueError(f"{name}: warm + 3 x steps exceeds the {order.shape[-1]} fragments")
    run(order[..., :warm])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(order[..., warm:warm + steps])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(order[..., warm + steps:warm + 2 * steps])
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    dev_rows = device_rows(avgs)
    # None when the profiler traced no device activity
    device_ms = sum(self_device_us(e) for e in dev_rows) / 1e3 / steps if dev_rows else None
    aten = sum(e.count for e in avgs if e.key.startswith("aten::")) / steps
    top = sorted(dev_rows, key=self_device_us, reverse=True)[:15]
    event_ms = None
    if mode == "graph":
        # a third window queued behind a spin kernel that outlasts its
        # enqueue, so that the events time the device's timeline alone
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4.0 * wall_ms * steps * 1e-3 * SPIN_HZ))
        start.record()
        run(order[..., warm + 2 * steps:warm + 3 * steps])
        stop.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(stop) / steps
    if table_dir is not None:
        table_dir.mkdir(parents=True, exist_ok=True)
        key = "self_device_time_total" if hasattr(avgs[0], "self_device_time_total") \
            else "self_cuda_time_total"
        (table_dir / f"profile_{name}_{mode}.txt").write_text(
            avgs.table(sort_by=key, row_limit=60, max_name_column_width=60))
    return {"path": name, "mode": mode, "steps": steps, "wall_ms_per_step": round(wall_ms, 4),
            "device_ms_per_step": device_ms and round(device_ms, 4),
            "device_busy": device_ms and round(device_ms / wall_ms, 4),
            "device_event_ms_per_step": event_ms and round(event_ms, 4),
            "aten_calls_per_step": round(aten, 1),
            "kernels": by_class(dev_rows, steps),
            "top": [[e.key[:70], round(self_device_us(e) / 1e3 / steps, 4),
                     round(e.count / steps, 2)] for e in top]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", metavar="PATH", help=f"any of {', '.join(PATHS)}")
    ap.add_argument("--warm", type=int, default=64)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--modes", default="graph,eager",
                    help="comma-separated: graph (captured, as the entry points run), eager")
    ap.add_argument("--table-dir", type=Path, default=None)
    args = ap.parse_args(argv)
    unknown = sorted(set(args.paths) - set(PATHS))
    if unknown:
        ap.error(f"unknown path(s) {unknown}: choose from {PATHS}")
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: profiling needs a GPU")
    device = torch.device("cuda", 0)
    modes = [m for m in args.modes.split(",") if m]
    if set(modes) - {"graph", "eager"}:
        ap.error(f"unknown mode(s) in {args.modes!r}: choose graph, eager")
    for name in args.paths or PATHS:
        for mode in modes:
            print(json.dumps(profile_path(name, device, args.warm, args.steps, args.table_dir,
                                          mode)), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
