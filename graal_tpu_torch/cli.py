"""Command-line interface of the PyTorch port.

Counterpart of ``graal_tpu.cli``. Usage:

    python -m graal_tpu_torch.cli simulate OUT_DIR [--bins 120 --contigs 4]
    python -m graal_tpu_torch.cli pyramid  DATASET_DIR [--size 4 --factor 3]
    python -m graal_tpu_torch.cli run      DATASET_DIR --fasta GENOME.FA [options]
    python -m graal_tpu_torch.cli replay   DATASET_DIR MUTATION_LOG [options]
    python -m graal_tpu_torch.cli scale    DATASET_DIR [options]
    python -m graal_tpu_torch.cli probe    DATASET_DIR FRAGMENT [options]

Every command that samples runs on ``--device`` (default ``cuda``): without
a card it exits with a message unless ``--device cpu`` is given.

Across cards, under a launcher (``torchrun --nproc-per-node N -m
graal_tpu_torch.cli ...``), every rank joins the process group the
launcher describes (NCCL, each rank on ``cuda:LOCAL_RANK``; gloo with
``--device cpu``): ``scale --chains`` splits its chains over the ranks,
the scale anchor its sums, ``run --sampler tempered`` its chains, and
rank 0 writes the outputs. Without a launcher the world is one rank.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _check_device(args):
    """The run's device: under a launcher's environment, this rank's
    (joining the process group); else ``--device``. Exits without a card
    when one is asked for."""
    from graal_tpu_torch.config import resolve_device
    from graal_tpu_torch.parallel.sharding import init_from_env

    try:
        dev = resolve_device(args.device)
        return resolve_device(init_from_env(str(dev)))
    except RuntimeError as e:
        raise SystemExit(f"graal_tpu_torch: {e}") from None


def _add_run_opts(p):
    p.add_argument("--size", type=int, default=4, help="pyramid levels")
    p.add_argument("--factor", type=int, default=3)
    p.add_argument("--ref-quirks", action="store_true",
                   help="replicate two upstream pyramid-build defects so "
                        "COO triplets diff bit-exact against a reference-"
                        "built pyramid (parity runs only)")
    p.add_argument("--level", type=int, default=None,
                   help="sampling level (default: size-1)")
    p.add_argument("--to-level", type=int, default=None,
                   help="multilevel refinement: assemble at --level, then refine "
                        "level by level down to this level")
    p.add_argument("--cycles", type=int, default=10)
    p.add_argument("--neighbours", type=int, default=4)
    p.add_argument("--no-sample-param", action="store_true")
    p.add_argument("--no-scramble", action="store_true")
    p.add_argument("--allow-repeats", action="store_true")
    p.add_argument("--blacklist", type=int, nargs="*", default=[])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--t0", type=float, default=1.0)
    p.add_argument("--tf", type=float, default=1.0)
    p.add_argument("--resume", action="store_true",
                   help="resume the EM stage from <out>/checkpoint.npz")
    p.add_argument("--sub-sample", type=float, default=0.0,
                   help="Poisson sub-sampling factor in (0,1] for coverage-"
                        "robustness experiments")
    p.add_argument("--snapshots", action="store_true",
                   help="save reordered matrix snapshots before / after")
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="also snapshot every N EM cycles (animate with "
                        "python -m graal_tpu_torch.utils.plots OUT_DIR)")
    p.add_argument("--watch", action="store_true",
                   help="refresh <out>/live.html each cycle (headless live view)")
    p.add_argument("--polish", action="store_true",
                   help="resolve unorientable-fragment orientations by "
                        "neighbourhood consensus before the FASTA export")
    p.add_argument("--model", default="rippe", choices=["rippe", "hic"],
                   help="contact model: Rippe polymer (default) or the "
                        "3-segment broken power law")
    p.add_argument("--sampler", default="em",
                   help="comma-separated stages: em, tempered, mtm, mh "
                        "(e.g. 'em,mtm' = EM then MTM refinement)")
    p.add_argument("--chains", type=int, default=4,
                   help="chain count of the 'tempered' stage (batched on one device, "
                        "split over the ranks under torchrun)")
    p.add_argument("--t-max", type=float, default=4.0,
                   help="hottest ladder temperature of 'tempered'")
    p.add_argument("--out", default="graal_out")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default cuda; cpu on request)")
    p.add_argument("--config", default="", help="TOML config file")
    p.add_argument("--profile", action="store_true",
                   help="trace one EM cycle with torch.profiler into <out>/profile "
                        "and print per-stage timing and the scorer's bandwidth")
    p.add_argument("--scoring", default="auto", choices=["auto", "full", "delta"],
                   help="candidate scoring: full-matrix, incremental "
                        "(delta, the chr1-scale engine), or auto by size")


SAMPLER_STAGES = ("em", "tempered", "mtm", "mh")


def _check_stages(args):
    for stage in args.sampler.split(","):
        if stage not in SAMPLER_STAGES:
            raise SystemExit(f"unknown sampler stage: {stage!r} (expected em, "
                             "tempered, mtm or mh)")


def _config_from_args(args):
    from graal_tpu_torch.config import RunConfig

    cfg = RunConfig.from_toml(args.config) if args.config else RunConfig()
    cfg.dataset_dir = args.dataset
    cfg.output_dir = args.out
    cfg.device = args.device
    cfg.pyramid.size = args.size
    cfg.pyramid.factor = args.factor
    cfg.pyramid.ref_quirks = args.ref_quirks
    cfg.sampler.level = args.level if args.level is not None else args.size - 1
    cfg.sampler.n_cycles = args.cycles
    cfg.sampler.n_neighbours = args.neighbours
    cfg.sampler.sample_param = not args.no_sample_param
    cfg.sampler.scrambled = not args.no_scramble
    cfg.sampler.allow_repeats = args.allow_repeats
    cfg.sampler.blacklist_contigs = tuple(args.blacklist)
    cfg.sampler.seed = args.seed
    cfg.sampler.t0 = args.t0
    cfg.sampler.tf = args.tf
    cfg.sampler.sub_sample_factor = args.sub_sample
    cfg.sampler.scoring = args.scoring
    cfg.sampler.snapshot_every = args.snapshot_every
    cfg.sampler.watch = args.watch
    cfg.model.use_rippe = args.model != "hic"
    return cfg


def _checked_config(args):
    """The run configuration of a run / replay / probe command, after the
    checks, on this rank's device."""
    _check_stages(args)
    cfg = _config_from_args(args)
    cfg.device = str(_check_device(args))
    return cfg


def _runner(args):
    """The Runner of a run / replay / probe command, after the checks."""
    from graal_tpu_torch.pipeline import Runner

    return Runner(_checked_config(args))


def cmd_pyramid(args):
    from graal_tpu_torch.io.pyramid import build_and_filter

    p = build_and_filter(args.dataset, args.size, args.factor, ref_quirks=args.ref_quirks)
    for lv in range(args.size):
        level = p.get_level(lv)
        print(f"level {lv}: {level.n_frags} fragments, {level.sparse.nnz} non-zero contacts")
    print(f"pyramid at {p.folder}")
    return p


def cmd_run(args):
    """Full assembly run: the ``--sampler`` stages in order, or with
    ``--to-level`` the multilevel refinement. Returns (runner, assembly);
    ``runner.stages`` lists each stage's name, assembly, carried
    likelihood, wall seconds and the scorer's launches so far."""
    import time

    import torch

    from graal_tpu_torch.parallel.sharding import is_writer
    from graal_tpu_torch.pipeline import Runner, chrom_index
    from graal_tpu_torch.utils.plots import plot_genome_layout

    cfg = _checked_config(args)
    if args.to_level is not None and args.to_level < cfg.sampler.level:
        from graal_tpu_torch.multilevel import run_multilevel

        runner, assembly = run_multilevel(cfg, cfg.sampler.level, args.to_level,
                                          fasta=args.fasta)
        runner.save_behaviour(assembly)
        if is_writer():
            plot_genome_layout(assembly.state, chrom_index(runner.level), cfg.output_dir)
        print(f"outputs in {cfg.output_dir}")
        return runner, assembly
    runner = Runner(cfg)
    print(f"level {runner.level.level}: {runner.level.n_frags} bins, "
          f"{runner.state.n_frags} fragments ({len(runner.duplications)} repeated) "
          f"on {runner.device}")
    print("fitted params:", json.dumps({k: float(v) for k, v in zip(
        runner.params._fields, runner.params)}))
    if args.snapshots:
        runner.save_matrix_snapshot("pre_assembly")
    profile_dir = os.path.join(cfg.output_dir, "profile") if args.profile else None
    assembly = None
    merged = {}
    runner.stages = []
    for stage in args.sampler.split(","):
        t0 = time.perf_counter()
        if stage == "em":
            assembly = runner.run_em(resume=args.resume, scoring=cfg.sampler.scoring,
                                     profile_dir=profile_dir)
        elif stage == "tempered":
            assembly = runner.run_tempered_em(n_chains=args.chains, t_max=args.t_max)
        else:
            assembly = runner.run_mtm(variant=stage, assembly=assembly)
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)
        runner.stages.append(dict(name=stage, assembly=assembly, l_t=runner.l_t,
                                  seconds=time.perf_counter() - t0,
                                  launches=getattr(runner.scorer, "n_launches", None)))
        for k, v in assembly.metrics.items():
            merged.setdefault(k, []).extend(v)
    assembly.metrics = merged
    runner.save_behaviour(assembly)
    if args.snapshots:
        runner.save_matrix_snapshot("post_assembly", assembly.state)
        if is_writer():
            plot_genome_layout(assembly.state, chrom_index(runner.level), cfg.output_dir)
    if args.fasta and is_writer():
        if args.polish:
            assembly.state = runner.polish_orientations(assembly.state)
        contigs = runner.export_fasta(assembly, args.fasta)
        print(f"wrote {len(contigs)} contigs to "
              f"{os.path.join(cfg.output_dir, 'genome.fasta')}")
    print(f"outputs in {cfg.output_dir}")
    return runner, assembly


def cmd_simulate(args):
    """Generate a synthetic ground-truth dataset in reference format."""
    from graal_tpu_torch.utils.dataset import write_synthetic_dataset

    info = write_synthetic_dataset(args.out, n_bins=args.bins, n_contigs=args.contigs,
                                   seed=args.seed)
    print(json.dumps(info))
    return info


def cmd_probe(args):
    """Likelihood landscape of one fragment: all 13 ops against every
    neighbour (test_model / new_test_model, main_gl.py:414-661). Returns
    (runner, ids, valid, scores)."""
    from graal_tpu_torch.core.candidates import MODIFICATION_STR

    runner = _runner(args)
    ids, valid, ll = runner.probe_fragment(args.fragment)
    best = ll.reshape(-1).argmax()
    print(f"fragment {args.fragment}: {int(valid.sum())} valid neighbours")
    for k, fb in enumerate(ids):
        if not valid[k]:
            continue
        print(f"  vs {int(fb):5d}: " + " ".join(f"{x:9.1f}" for x in ll[k]))
    print(f"best slot: neighbour {int(ids[best // 13])}, op {int(best % 13)} "
          f"({MODIFICATION_STR[best % 13]}), score {float(ll.reshape(-1)[best]):.1f}")
    return runner, ids, valid, ll


def cmd_scale(args):
    """Chr1-scale sparse assembly: pyramid level -> ScaleRunner without
    densifying the observed matrix; with ``--chains N`` > 1, N
    parallel-tempered chains up to ``--t-max`` (``ScaleRunner.run_chains``,
    the outputs from the best chain). Returns (runner, final state,
    metrics)."""
    from graal_tpu_torch import scale as scale_mod
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.io import fasta as fasta_io
    from graal_tpu_torch.parallel.sharding import is_writer
    from graal_tpu_torch.pipeline import chrom_index
    from graal_tpu_torch.utils import profiling
    from graal_tpu_torch.utils.plots import plot_genome_layout

    dev = _check_device(args)
    if args.to_level is not None:
        return _scale_multilevel(args, dev)
    runner, state0, lev, _ = scale_mod.from_dataset(
        args.dataset, args.size, args.factor, level=args.level,
        max_fit_bins=args.max_fit_bins, allow_repeats=args.allow_repeats,
        sub_sample=args.sub_sample, sub_sample_seed=args.seed,
        ref_quirks=args.ref_quirks, device=dev)
    state = state0 if args.no_scramble else mcmc.explode_genome(state0)
    os.makedirs(args.out, exist_ok=True)
    chrom_idx = chrom_index(lev)
    if args.chains > 1:
        final, best_ll, m_chains = runner.run_chains(
            state, n_chains=args.chains, n_cycles=args.cycles, delta=args.neighbours,
            steps_per_cycle=args.steps_per_cycle, f_max_min=args.f_max_min, f_t=args.t0,
            t_max=args.t_max, sample_param=not args.no_sample_param, seed=args.seed,
            checkpoint_path=os.path.join(args.out, "chains_checkpoint.npz"),
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            snapshot_every=args.snapshot_every, snapshot_dir=args.out, chrom_of_bin=chrom_idx,
            watch=args.watch)
        metrics = {"likelihood": m_chains["best"], "n_contigs": [int(final.n_contigs())],
                   "dist_init_genome": [], "overflow": [], "f_max": m_chains["f_max"],
                   "cycle_s": [], "chains": m_chains}
    else:
        final, params, metrics = runner.run(
            state, n_cycles=args.cycles, delta=args.neighbours,
            steps_per_cycle=args.steps_per_cycle, f_max_min=args.f_max_min, f_t=args.t0,
            sample_param=not args.no_sample_param, seed=args.seed, init_truth=state0,
            checkpoint_path=os.path.join(args.out, "checkpoint.npz"),
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            order_mode=args.order, snapshot_every=args.snapshot_every,
            snapshot_dir=args.out, chrom_of_bin=chrom_idx, watch=args.watch)
    if args.mtm_cycles > 0:
        final, _, m_mtm = runner.run_mtm(final, n_cycles=args.mtm_cycles,
                                         f_max_min=args.f_max_min, f_t=args.t0,
                                         seed=args.seed + 7)
        for k in ("likelihood", "n_contigs", "f_max"):
            metrics[k].extend(m_mtm[k])
        metrics["mtm"] = m_mtm
    if args.profile:
        # one more cycle of the single-chain sampler from the final genome,
        # traced (its ll_mini / obsgrid launches name the kernels)
        with profiling.trace(os.path.join(args.out, "profile")):
            final, params, _ = runner.run(
                final, n_cycles=1, delta=args.neighbours, f_max_min=args.f_max_min,
                f_t=args.t0, sample_param=not args.no_sample_param, seed=args.seed + 1,
                steps_per_cycle=args.steps_per_cycle)
    if not is_writer():
        return runner, final, metrics
    for name, key in (("list_likelihood", "likelihood"), ("list_n_contigs", "n_contigs"),
                      ("list_dist_init_genome", "dist_init_genome"),
                      ("list_overflow", "overflow"), ("list_f_max", "f_max"),
                      ("list_fact", "fact"), ("list_slope", "slope"),
                      ("list_d_max", "d_max"), ("list_d_nuc", "v_inter")):
        with open(os.path.join(args.out, f"0{name}.txt"), "w") as fh:
            for v in metrics.get(key, []):
                fh.write(f"{v}\n")
    if args.fasta:
        f = lev.frags
        contigs = fasta_io.export_assembly(
            final, f.chrom, f.start_pos, f.end_pos, fasta_io.load_fasta(args.fasta),
            os.path.join(args.out, "genome.fasta"), os.path.join(args.out, "info_frags.txt"))
        print(f"wrote {len(contigs)} contigs to {os.path.join(args.out, 'genome.fasta')}")
    plot_genome_layout(final, chrom_idx, args.out)
    print(json.dumps({
        "final_loglik": metrics["likelihood"][-1],
        "n_contigs": metrics["n_contigs"][-1],
        "dist_init_genome": (metrics["dist_init_genome"] or [None])[-1],
        "cycle_s": metrics["cycle_s"],
    }))
    print(f"outputs in {args.out}")
    return runner, final, metrics


def _scale_multilevel(args, dev):
    """``scale --to-level``: coarse-to-fine sparse assembly from --level
    down to --to-level. Returns (runner of the last level, final state,
    per-level metrics)."""
    from graal_tpu_torch import scale as scale_mod
    from graal_tpu_torch.io import fasta as fasta_io

    start = args.level if args.level is not None else args.size - 1
    final, runner, lev, per_level = scale_mod.run_multilevel(
        args.dataset, args.size, start, args.to_level, n_cycles=args.cycles,
        factor=args.factor, delta=args.neighbours, f_max_min=args.f_max_min, f_t=args.t0,
        sample_param=not args.no_sample_param, seed=args.seed,
        max_fit_bins=args.max_fit_bins, device=dev)
    from graal_tpu_torch.parallel.sharding import is_writer

    os.makedirs(args.out, exist_ok=True)
    if args.fasta and is_writer():
        f = lev.frags
        contigs = fasta_io.export_assembly(
            final, f.chrom, f.start_pos, f.end_pos, fasta_io.load_fasta(args.fasta),
            os.path.join(args.out, "genome.fasta"), os.path.join(args.out, "info_frags.txt"))
        print(f"wrote {len(contigs)} contigs")
    print(json.dumps({"levels": [
        {"level": m["level"], "final_loglik": m["likelihood"][-1],
         "n_contigs": m["n_contigs"][-1],
         "dist_init_genome": (m["dist_init_genome"] or [None])[-1]}
        for m in per_level]}))
    print(f"outputs in {args.out}")
    return runner, final, per_level


def cmd_replay(args):
    """Re-apply a recorded mutation log (replay_simu, main_gl.py:140-207)
    to the exploded genome. Returns (runner, state, log-likelihood)."""
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.pipeline import Assembly

    runner = _runner(args)
    muts = np.loadtxt(args.log, dtype=np.int64, skiprows=1, ndmin=2)
    state = mcmc.explode_genome(runner.state)
    for fa, fb, op in muts:
        if op < 0:
            continue
        state = mcmc.apply_mutation(state, int(fa), int(fb), int(op))
    ll = runner._initial_likelihood(state, runner.params)
    print(f"replayed {len(muts)} mutations, final loglik = {float(ll):.2f}")
    runner.state = state
    if args.fasta:
        assembly = Assembly(state=state, params=runner.params, table=runner.table,
                            obs=runner.obs, metrics={}, level=runner.level)
        runner.export_fasta(assembly, args.fasta)
    return runner, state, ll


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="graal_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pyramid", help="build the contact-map pyramid")
    p.add_argument("dataset")
    p.add_argument("--size", type=int, default=4)
    p.add_argument("--factor", type=int, default=3)
    p.add_argument("--ref-quirks", action="store_true",
                   help="replicate two upstream pyramid-build defects so "
                        "COO triplets diff bit-exact against a reference-"
                        "built pyramid (parity runs only)")
    p.set_defaults(fn=cmd_pyramid)

    p = sub.add_parser("run", help="full assembly run")
    p.add_argument("dataset")
    p.add_argument("--fasta", default="", help="reference genome FASTA")
    _add_run_opts(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("simulate", help="write a synthetic dataset")
    p.add_argument("out")
    p.add_argument("--bins", type=int, default=120)
    p.add_argument("--contigs", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("probe", help="likelihood landscape of one fragment")
    p.add_argument("dataset")
    p.add_argument("fragment", type=int)
    _add_run_opts(p)
    p.set_defaults(fn=cmd_probe)

    p = sub.add_parser("scale", help="chr1-scale sparse assembly "
                                     "(never densifies the contact matrix)")
    p.add_argument("dataset")
    p.add_argument("--fasta", default="", help="reference genome FASTA")
    p.add_argument("--size", type=int, default=4)
    p.add_argument("--factor", type=int, default=3)
    p.add_argument("--level", type=int, default=None)
    p.add_argument("--to-level", type=int, default=None,
                   help="multilevel refinement: assemble at --level, then refine "
                        "level by level down to this level")
    p.add_argument("--cycles", type=int, default=10)
    p.add_argument("--neighbours", type=int, default=4)
    p.add_argument("--f-max-min", type=int, default=256,
                   help="small-tier contig capacity bucket")
    p.add_argument("--max-fit-bins", type=int, default=2048,
                   help="cap on the Rippe fit window, in distance bins")
    p.add_argument("--allow-repeats", action="store_true",
                   help="duplicate coverage-outlier bins (copy-expanded "
                        "geometry; routes to the repeat-aware scorer)")
    p.add_argument("--ref-quirks", action="store_true",
                   help="replicate two upstream pyramid-build defects (parity runs only)")
    p.add_argument("--chains", type=int, default=1,
                   help="parallel-tempered chains with adjacent-pair replica-exchange "
                        "swaps: batched on one device (one B2 and one B4 launch a "
                        "step for all chains), split over the ranks under torchrun")
    p.add_argument("--t-max", type=float, default=4.0,
                   help="hottest chain temperature of the PT ladder")
    p.add_argument("--mtm-cycles", type=int, default=0,
                   help="delta-scored MTM refinement cycles after the assembly")
    p.add_argument("--no-sample-param", action="store_true")
    p.add_argument("--no-scramble", action="store_true")
    p.add_argument("--steps-per-cycle", type=int, default=None,
                   help="cap fragment steps per cycle (default: every fragment once)")
    p.add_argument("--order", default="random", choices=("random", "extremity"),
                   help="subsampled-cycle schedule: random truncated sweep, or "
                        "contig extremities first")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--t0", type=float, default=1.0)
    p.add_argument("--sub-sample", type=float, default=0.0,
                   help="Poisson-resample contacts by this factor")
    p.add_argument("--resume", action="store_true",
                   help="resume from <out>/checkpoint.npz if present")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="checkpoint every N cycles (0 disables)")
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="genome-layout painting every N cycles (where matplotlib is "
                        "installed)")
    p.add_argument("--watch", action="store_true",
                   help="refresh <out>/live.html each cycle (headless live view)")
    p.add_argument("--profile", action="store_true",
                   help="run one extra cycle under torch.profiler into <out>/profile")
    p.add_argument("--out", default="graal_scale_out")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default cuda; cpu on request)")
    p.set_defaults(fn=cmd_scale)

    p = sub.add_parser("replay", help="re-apply a recorded mutation log")
    p.add_argument("dataset")
    p.add_argument("log")
    p.add_argument("--fasta", default="")
    _add_run_opts(p)
    p.set_defaults(fn=cmd_replay)
    return ap


def execute(argv=None):
    """Parse ``argv`` and run its command; returns what the command drove
    (the runner and its results: see each ``cmd_*``)."""
    args = parser().parse_args(argv)
    return args.fn(args)


def main(argv=None) -> int:
    execute(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
