"""End-to-end assembly pipeline: dataset -> pyramid -> sampler -> FASTA.

PyTorch counterpart of ``graal_tpu.pipeline``: the :class:`Runner` wires a
pyramid level to the sampler (repeat detection and copy extension,
contig blacklisting, the Rippe fit, the EM cycles with optional nuisance
sampling and a checkpoint every cycle), the sampler stages that follow
or replace EM (parallel-tempered chains, MTM / MH refinement), writes the
reference's output series (9 txt files, the mutation log and
``params.json``) and exports the assembled genome.

The run lives on ``cfg.device``, the card unless the caller asks for the
CPU. On a CUDA device every candidate is scored by the dense kernel
(``ops.likelihood_cuda.make_dense_scorer``: B1, or B3 for a
copy-expanded table); on the CPU by the plain dense likelihood, as the
JAX package does there. Under the broken-power-law contact model
(``cfg.model.use_rippe = False``) every stage scores through
``core.model_hic.make_hic_scorer`` on the run's device (the JAX package
has no kernel for that model either), and nuisance sampling is off. The
delta path (``run_em(scoring="delta")``) builds one ``MiniGridScorer``
(B2) and one ``WindowObsGrid`` (B4) per run and anchors with the same
dense scorer. Randomness comes from one
``torch.Generator`` on the device, seeded with ``cfg.sampler.seed``; the
checkpoint keeps its state, the carried likelihood and the metric
history, so a resumed run equals the uninterrupted one bit for bit. A
cycle's metrics and state reach the host in one copy.

The dense EM stage can also write reordered-matrix snapshots
(:meth:`Runner.save_matrix_snapshot`), refresh the live page
(``utils.live``) and trace its second cycle with ``torch.profiler``
(``utils.profiling.trace``). Under ``torch.distributed`` the tempered
stage splits its chains over the ranks of a ``parallel.sharding.Mesh``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from graal_tpu_torch.config import RunConfig, resolve_device, temperature_schedule
from graal_tpu_torch.core import mcmc
from graal_tpu_torch.core import mtm as mtm_mod
from graal_tpu_torch.core.candidates import N_CANDIDATES, build_candidates
from graal_tpu_torch.core.likelihood import log_likelihood
from graal_tpu_torch.core.model import RippeParams, fit_rippe_from_matrix
from graal_tpu_torch.core.model_hic import HiCParams, fit_hic_from_matrix, make_hic_scorer
from graal_tpu_torch.core.state import (GenomeState, check_invariants,
                                        derive_prev_next, dist_inter_genome)
from graal_tpu_torch.core.subfrags import SubFragTable, table_from_level
from graal_tpu_torch.io import fasta as fasta_io
from graal_tpu_torch.io import pyramid as pyramid_io
from graal_tpu_torch.parallel import sharding
from graal_tpu_torch.utils import checkpoint as ckpt_io
from graal_tpu_torch.utils import live, profiling
from graal_tpu_torch.utils.profiling import StageTimer


def detect_repeats_coverage(coverage: np.ndarray, allow_repeats: bool):
    """Coverage-outlier repeat detection: bins with coverage above
    mean + 3 sd are repeats with max(1, round(cov / threshold) - 1) extra
    copies. Scale-invariant in ``coverage``, so any proportional coverage
    vector works. Returns [(bin, n_extra_copies), ...]."""
    if not allow_repeats:
        return []
    coverage = np.asarray(coverage, np.float64)
    thresh = coverage.mean() + 3 * coverage.std()
    out = []
    for b in np.nonzero(coverage > thresh)[0]:
        n_dup = int(max(1, round(coverage[b] / thresh) - 1))
        out.append((int(b), n_dup))
    return out


def detect_repeats(bin_matrix: np.ndarray, allow_repeats: bool):
    """Dense entry point: coverage = column sums + row sums."""
    if not allow_repeats:
        return []
    return detect_repeats_coverage(
        bin_matrix.sum(axis=0) + bin_matrix.sum(axis=1), allow_repeats)


def extend_with_repeats(soa: dict, duplications):
    """Append the repeat copies of ``duplications`` ([(bin, n_copies)])
    as fresh singleton contigs, and flag the originals of duplicated bins
    as repeats too. ``soa`` holds the genome fields plus ``n_accu``."""
    if not duplications:
        return soa
    soa = {k: np.asarray(v) for k, v in soa.items()}
    bins = np.repeat([b for b, _ in duplications],
                     [d for _, d in duplications]).astype(np.int64)
    m = len(bins)
    max_c = int(soa["id_c"].max()) + 1
    ext = {
        "pos": np.zeros(m, np.int64),
        "id_c": max_c + np.arange(m, dtype=np.int64),
        "start_bp": np.zeros(m, np.int64),
        "len_bp": soa["len_bp"][bins],
        "circ": np.zeros(m, np.int64),
        "l_cont": np.ones(m, np.int64),
        "l_cont_bp": soa["len_bp"][bins],
        "n_accu": soa["n_accu"][bins],
        "ori": np.ones(m, np.int64),
        "rep": np.ones(m, np.int64),
        "activ": np.ones(m, np.int64),
        "id_d": bins,
    }
    out = {k: np.concatenate([soa[k], np.asarray(ext[k], soa[k].dtype)])
           for k in soa}
    out["rep"][np.asarray([b for b, _ in duplications])] = 1
    return out


def chrom_index(level) -> np.ndarray:
    """Source-chromosome index of each bin of a pyramid level (the colour of
    the layout painting and the live view)."""
    return np.unique(np.asarray(level.frags.chrom), return_inverse=True)[1]


def host_copy(*tensors):
    """The tensors as numpy arrays of their own dtypes and shapes, brought
    to the host in one copy (every value is exact in f64)."""
    flat = torch.cat([torch.as_tensor(t).reshape(-1).double() for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        t = torch.as_tensor(t)
        k = t.numel()
        dt = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(flat[i:i + k].astype(dt).reshape(tuple(t.shape)))
        i += k
    return out


def host_state(arrays) -> GenomeState:
    """A CPU GenomeState from the 11 host arrays of :func:`host_copy`."""
    return GenomeState(*[torch.from_numpy(a) for a in arrays])


@dataclasses.dataclass
class Assembly:
    state: GenomeState
    params: RippeParams
    table: SubFragTable
    obs: np.ndarray
    metrics: dict
    level: "pyramid_io.Level"


# series of the dense EM path, in CycleMetrics order, plus the distance
DENSE_SERIES = ("likelihood", "n_contigs", "mean_len", "op_sampled", "id_f_sampled",
                "id_f_a", "fact", "slope", "d_max", "v_inter", "success")


class Runner:
    """One configured assembly run on ``cfg.device``."""

    def __init__(self, cfg: RunConfig, pyramid: "pyramid_io.Pyramid | None" = None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        os.makedirs(cfg.output_dir, exist_ok=True)
        self.pyramid = pyramid or pyramid_io.build_and_filter(
            cfg.dataset_dir, cfg.pyramid.size, cfg.pyramid.factor,
            cfg.pyramid.min_bin_per_contig, ref_quirks=cfg.pyramid.ref_quirks)
        self._setup_level()
        self._setup_matrices()
        self._setup_state()
        self._estimate_parameters()
        self.scorer = self._make_scorer()
        self.obs_grid = self.mini_grid = None    # the delta path's kernels, per run
        self.delta_buckets = []                  # the buckets the delta path ran
        self._obs_t = None
        self.l_t = None    # the carried likelihood of the last stage's genome

    # ---- setup ------------------------------------------------------------
    def _setup_level(self):
        self.level, self.sub_level, self.bin_to_subs = self.pyramid.sampling_level(
            min(self.cfg.sampler.level, self.cfg.pyramid.size - 1))
        self.sub_soa = self.sub_level.genome_soa()

    def _setup_matrices(self):
        self.bin_matrix = self.level.dense_matrix()
        np.fill_diagonal(self.bin_matrix, 0.0)
        self.obs = self.sub_level.dense_matrix()
        np.fill_diagonal(self.obs, 0.0)
        self.mean_value_trans = self.sub_level.mean_value_trans()
        # Poisson sub-sampling robustness knob: resample every cell with
        # mean fact * obs
        fact = self.cfg.sampler.sub_sample_factor
        if 0.0 < fact <= 1.0:
            rng = np.random.default_rng(self.cfg.sampler.seed)
            sub = rng.poisson(np.maximum(np.triu(self.obs, 1) * fact, 0.0))
            self.obs = (sub + sub.T).astype(np.float32)
            binsub = rng.poisson(np.maximum(np.triu(self.bin_matrix, 1) * fact, 0.0))
            self.bin_matrix = (binsub + binsub.T).astype(np.float32)

    def _setup_state(self):
        cfg = self.cfg
        dev = self.device
        soa = self.level.genome_soa()
        self.n_bins = self.level.n_frags

        # contig blacklisting (blacklist_contig, simulation_loader.py:129-163)
        blacklisted = []
        for cid in cfg.sampler.blacklist_contigs:
            blacklisted.extend(np.nonzero(soa["id_c"] == cid)[0].tolist())

        self.duplications = detect_repeats(self.bin_matrix, cfg.sampler.allow_repeats)
        soa = extend_with_repeats(soa, self.duplications)
        self.state = GenomeState.from_soa(soa, device=dev)

        # blacklist rows: bin level zeroed, data level set to the mean trans
        # value (cuda_lib_gl.py:161-172)
        for f in blacklisted:
            b = int(soa["id_d"][f])
            self.bin_matrix[b, :] = 0.0
            self.bin_matrix[:, b] = 0.0
            lo, hi = self.bin_to_subs[b]
            self.obs[lo:hi + 1, :] = self.mean_value_trans
            self.obs[:, lo:hi + 1] = self.mean_value_trans

        self.blacklisted = blacklisted
        self.table = table_from_level(
            self.level.genome_soa(),
            {"len_bp": self.sub_soa["len_bp"], "n_accu": self.sub_soa["n_accu"]},
            self.bin_to_subs, id_d=soa["id_d"], device=dev)
        n = len(soa["id_d"])
        self.nb = mcmc.build_neighbour_table(
            self.bin_matrix, soa["id_d"], n, blacklisted=blacklisted,
            n_top=cfg.sampler.n_neighbours_cap, device=dev)

        # initial-genome references for the distance metric
        self.init_prev, self.init_next = derive_prev_next(self.state)
        self.init_ori = np.ones(n, np.int64)
        widths = self.bin_to_subs[:, 1] - self.bin_to_subs[:, 0] + 1
        id_d = np.asarray(soa["id_d"])
        self.orientable = widths[id_d] > 1
        skip = np.isin(id_d, [b for b, _ in self.duplications])
        skip[blacklisted] = True
        self.dist_skip = skip

    def _estimate_parameters(self):
        """Model fit on the observed data (estimate_parameters,
        cuda_lib_gl.py:1229-1294; estimate_parameters_rv :1296-1352 for the
        broken power law): fit window = mean contig length (kb), bin width
        = mean bin length (kb)."""
        soa = self.sub_soa
        mean_dist_kb = float(np.mean(soa["l_cont_bp"][soa["pos"] == 0])) / 1000.0
        size_bin_kb = float(np.mean(soa["len_bp"])) / 1000.0
        max_dist_kb = mean_dist_kb * self.cfg.model.max_dist_bins_factor
        if self.cfg.model.use_rippe:
            self.params, self.fit_bins, self.fit_contacts, self.fit_estim = \
                fit_rippe_from_matrix(self.obs, soa, self.mean_value_trans, max_dist_kb,
                                      size_bin_kb, device=self.device)
        else:
            self.params = fit_hic_from_matrix(self.obs, soa, self.mean_value_trans,
                                              max_dist_kb, size_bin_kb, device=self.device)
            self.fit_bins = self.fit_contacts = self.fit_estim = None

    @property
    def is_hic(self) -> bool:
        return isinstance(self.params, HiCParams)

    @property
    def sample_param(self) -> bool:
        """Nuisance sampling: as configured, but always off under the HiC
        model (its moves are Rippe-specific)."""
        return self.cfg.sampler.sample_param and not self.is_hic

    def _make_scorer(self):
        """The batched scorer ``(states (B, n), params) -> (B,)``: the HiC
        model's on any device; for the Rippe model the dense kernel on a
        CUDA device (B1, or B3 for a repeat table), None on the CPU (the
        plain dense likelihood)."""
        if self.is_hic:
            return make_hic_scorer(self.table, self.obs)
        if self.device.type == "cuda":
            from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

            return make_dense_scorer(self.table, self.obs, self.device)
        return None

    def score(self, states: GenomeState, params: RippeParams) -> torch.Tensor:
        """Log-likelihoods (B,) of a batch of genomes (B, n): the run's
        scorer, or on the CPU the plain dense likelihood."""
        if self.scorer is not None:
            return self.scorer(states, params)
        if self._obs_t is None:
            self._obs_t = torch.as_tensor(self.obs, dtype=torch.float32, device=self.device)
        return log_likelihood(states, self.table, self._obs_t, params)

    def _initial_likelihood(self, state, params):
        return self.score(GenomeState(*[x[None] for x in state]), params)[0]

    # ---- run --------------------------------------------------------------
    def _resume(self, resume: bool, state, params, gen, collected, progress=True):
        """Load ``<out>/checkpoint.npz`` when ``resume`` and it exists:
        restores the generator in place and the metric history into
        ``collected``. Returns (state, params, start_cycle, l_t or None)."""
        path = os.path.join(self.cfg.output_dir, "checkpoint.npz")
        if not (resume and os.path.exists(path)):
            return state, params, 0, None
        state, params, start, gen_state, extra = ckpt_io.load_checkpoint(
            path, self.device, params_cls=type(params))
        gen.set_state(gen_state)
        collected.update(ckpt_io.metrics_from_extra(extra))
        l_t = torch.tensor(extra["l_t"], device=self.device)
        if progress:
            print(f"resumed from {path} at cycle {start}", flush=True)
        return state, params, start, l_t

    def _checkpoint(self, cycle, state, params, l_t, gen, collected):
        if not sharding.is_writer():
            return
        ckpt_io.save_checkpoint(os.path.join(self.cfg.output_dir, "checkpoint.npz"),
                                state, params, cycle, gen,
                                extra={"l_t": l_t, **ckpt_io.metrics_extra(collected)})

    def _dist(self, state: GenomeState) -> float:
        return dist_inter_genome(state, self.init_prev, self.init_next, self.init_ori,
                                 self.orientable, self.dist_skip)

    def run_em(self, n_cycles=None, progress=True, resume=False, checkpoint_every=1,
               scoring: str = "auto", profile_dir: str | None = None) -> Assembly:
        """EM cycles from the (scrambled) initial genome.

        ``scoring``: 'full' scores every candidate with the full-matrix
        likelihood, 'delta' with the incremental mini-state engine (the
        chr1-scale path), 'auto' picks delta above 6,000 sub-fragments.
        ``resume``: continue from ``<out>/checkpoint.npz`` when it exists
        (written every ``checkpoint_every`` cycles).

        ``profile_dir`` (full scoring): the second cycle of the call runs
        under ``utils.profiling.trace`` into that directory, and the stage
        times and the dense scorer's achieved bandwidth are printed at the
        end. ``cfg.sampler.snapshot_every``: a reordered-matrix snapshot
        (:meth:`save_matrix_snapshot`) every that many cycles;
        ``cfg.sampler.watch``: the live page (``utils.live``) refreshed
        every cycle."""
        if scoring == "auto":
            scoring = "delta" if self.table.n_subs > 6000 else "full"
        if scoring == "delta":
            return self._run_em_delta(n_cycles=n_cycles, progress=progress,
                                      resume=resume, checkpoint_every=checkpoint_every)
        if scoring != "full":
            raise ValueError(f"unknown scoring {scoring!r}")

        cfg = self.cfg
        dev = self.device
        n_cycles = n_cycles or cfg.sampler.n_cycles
        cycle = mcmc.make_em_cycle(self.table, self.obs, self.nb,
                                   delta=cfg.sampler.n_neighbours,
                                   sample_param=self.sample_param,
                                   scorer=self.scorer,
                                   thresh_overflow=cfg.sampler.thresh_overflow)
        state = self.state
        if cfg.sampler.scrambled:
            state = mcmc.explode_genome(state)
        params = self.params
        gen = torch.Generator(device=dev).manual_seed(cfg.sampler.seed)
        collected = {k: [] for k in DENSE_SERIES + ("dist_init_genome",)}
        state, params, start_cycle, l_t = self._resume(resume, state, params, gen, collected,
                                                              progress)
        if l_t is None:
            l_t = self._initial_likelihood(state, params)

        n = state.n_frags
        timer = StageTimer()
        cycle_times = []
        t0 = time.time()
        for j in range(start_cycle, n_cycles):
            order = torch.randperm(n, generator=gen, device=dev)
            f_t = temperature_schedule(cfg.sampler, j, n_cycles)
            tc = time.time()
            traced = profile_dir is not None and j == start_cycle + 1
            with profiling.trace(profile_dir) if traced else contextlib.nullcontext():
                with timer.stage("em_cycle"):
                    state, params, l_t, m = cycle(state, gen, params, order, l_t, f_t)
                    # one host copy a cycle: the metrics, the state, params, l_t
                    host = host_copy(*m, *state, *params, l_t)
            cycle_times.append(time.time() - tc)
            with timer.stage("metrics_host"):
                for k, v in zip(DENSE_SERIES, host):
                    collected[k].extend(v.tolist())
                hstate = host_state(host[len(DENSE_SERIES):len(DENSE_SERIES) + 11])
                hparams = type(params)(*[torch.from_numpy(x) for x in host[-9:-1]])
                l_host = host[-1]
                dist = self._dist(hstate)
                collected["dist_init_genome"].extend([dist] * n)
            if progress:
                print(f"cycle {j}: loglik={float(l_host):.1f} "
                      f"n_contigs={int(host[1][-1])} dist={dist:.3f} T={f_t:.2f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
            if checkpoint_every and (j + 1) % checkpoint_every == 0:
                with timer.stage("checkpoint"):
                    self._checkpoint(j + 1, hstate, hparams, l_host, gen, collected)
            snap_every = cfg.sampler.snapshot_every
            if snap_every and (j + 1) % snap_every == 0:
                self.save_matrix_snapshot(f"snapshot_{j + 1:04d}", hstate)
            if cfg.sampler.watch:
                live.refresh(cfg.output_dir, j, hstate, chrom_index(self.level),
                             {"cycle": j, "loglik": float(l_host),
                              "n_contigs": int(host[1][-1]), "dist": dist, "T": round(f_t, 2)},
                             collected["likelihood"][::max(1, n // 4)], watch=True)
        if profile_dir is not None and cycle_times:
            timer.print_report("EM profiling")
            steady = cycle_times[1:] or cycle_times
            bw = profiling.bandwidth_report(
                self.table.n_subs,
                N_CANDIDATES * (cfg.sampler.n_neighbours * self.nb.max_copies
                                + self.nb.max_copies),
                n, float(np.mean(steady)))
            print("bandwidth:", json.dumps(bw), flush=True)
        check_invariants(state)
        self.state = state
        self.params = params
        self.l_t = l_t
        self.timer = timer
        return Assembly(state=state, params=params, table=self.table, obs=self.obs,
                        metrics=collected, level=self.level)

    def _run_em_delta(self, n_cycles=None, progress=True, resume=False,
                      checkpoint_every=1) -> Assembly:
        """EM with incremental (delta) candidate scoring: the chr1-scale
        engine at any size. Each cycle runs at the contig-capacity bucket
        its largest contig needs and ends with a full re-anchor (the run's
        dense scorer); nuisance sampling runs once per cycle on the
        re-anchored likelihood. The metrics add ``anchor``, each cycle's
        re-anchored likelihood (before the nuisance step)."""
        from graal_tpu_torch.core import delta as delta_mod
        from graal_tpu_torch.core import sparse
        from graal_tpu_torch.ops.mini_grid_cuda import MiniGridScorer
        from graal_tpu_torch.ops.obsgrid_cuda import WindowObsGrid
        from graal_tpu_torch.scale import _next_pow2, max_contig_subs

        if self.is_hic:
            raise ValueError("delta scoring under the HiC contact model: the delta "
                             "engine scores the Rippe model only (use --scoring full)")
        cfg = self.cfg
        dev = self.device
        n_cycles = n_cycles or cfg.sampler.n_cycles
        sobs = sparse.sparse_from_dense(self.obs, device=dev)
        state = self.state
        if cfg.sampler.scrambled:
            state = mcmc.explode_genome(state)
        params = self.params

        def anchor(s, p):
            return self._initial_likelihood(s, p)

        nuis = mcmc.make_nuisance_step(self.table, self.obs, scorer=self.scorer) \
            if cfg.sampler.sample_param else None
        self.obs_grid, self.mini_grid = WindowObsGrid(), MiniGridScorer()
        gen = torch.Generator(device=dev).manual_seed(cfg.sampler.seed)
        series = ("likelihood", "op_sampled", "id_f_sampled", "overflow", "n_contigs")
        collected = {k: [] for k in series + ("dist_init_genome", "fact", "slope",
                                              "d_max", "v_inter", "anchor")}
        state, params, start_cycle, l_t = self._resume(resume, state, params, gen, collected,
                                                              progress)
        if l_t is None:
            l_t = anchor(state, params)
        s_max = delta_mod.build_mini_table(self.table, allow_repeats=True).s_max
        rep = state.rep.cpu().numpy()    # no move changes rep
        n = state.n_frags
        cycles = {}
        timer = StageTimer()
        t0 = time.time()
        for j in range(start_cycle, n_cycles):
            bucket = _next_pow2(2 * max_contig_subs(state, self.table) + 2 * s_max)
            bucket = min(max(bucket, 64), _next_pow2(n))
            if bucket not in cycles:
                cycles[bucket] = delta_mod.make_delta_em_cycle(
                    self.table, self.obs, self.nb, delta=cfg.sampler.n_neighbours,
                    f_max=bucket, sobs=sobs, anchor_fn=anchor,
                    thresh_overflow=cfg.sampler.thresh_overflow,
                    obs_grid=self.obs_grid, mini_grid=self.mini_grid, rep=rep)
            order = torch.randperm(n, generator=gen, device=dev)
            f_t = temperature_schedule(cfg.sampler, j, n_cycles)
            with timer.stage("em_cycle"):
                state, l_t, outs = cycles[bucket](state, gen, params, order, l_t, f_t)
                l_anchor = l_t
                if nuis is not None:
                    params, l_t, _ = nuis(state, gen, params, l_t, f_t)
                host = host_copy(*outs, *state, *params, l_t, l_anchor)
            for k, v in zip(series, host):
                collected[k].extend(v.tolist())
            hstate = host_state(host[5:16])
            hparams = RippeParams(*[torch.from_numpy(x) for x in host[16:24]])
            l_host = host[24]
            dist = self._dist(hstate)
            collected["dist_init_genome"].extend([dist] * n)
            for k in ("fact", "slope", "d_max", "v_inter"):
                collected[k].extend([float(getattr(hparams, k))] * n)
            collected["anchor"].append(float(host[25]))
            if progress:
                print(f"cycle {j} (delta, f_max={bucket}): loglik={float(l_host):.1f} "
                      f"n_contigs={int(host[4][-1])} dist={dist:.3f} "
                      f"overflow={int(host[3].sum())} ({time.time() - t0:.1f}s)",
                      flush=True)
            if checkpoint_every and (j + 1) % checkpoint_every == 0:
                with timer.stage("checkpoint"):
                    self._checkpoint(j + 1, hstate, hparams, l_host, gen, collected)
        check_invariants(state)
        self.state = state
        self.params = params
        self.l_t = l_t
        self.timer = timer
        self.delta_buckets = sorted(cycles)
        return Assembly(state=state, params=params, table=self.table, obs=self.obs,
                        metrics=collected, level=self.level)

    def run_tempered_em(self, n_chains=None, n_cycles=None, t_max=4.0, exchange_every=2,
                        progress=True, mesh=None) -> Assembly:
        """Parallel-tempered EM: ``n_chains`` chains (default
        ``cfg.n_chains``) on a geometric ladder up to ``t_max``, batched on
        the run's device (one scorer call a step for all chains; a cycle is
        one captured graph replayed once a step on the card,
        ``parallel.tempering.make_tempered_cycle``), with
        replica-exchange swaps every ``exchange_every`` cycles and a final
        best-genome consolidation. No nuisance sampling (as in the JAX
        package). ``self.chain_states`` keeps every chain's final genome.

        ``mesh``: a ``parallel.sharding.Mesh`` to split the chains over;
        by default, under ``torch.distributed`` with a rank count that
        the chains divide into (the JAX package's device-count test), one
        chain block per rank group; otherwise the chains stay on the run's
        device."""
        from graal_tpu_torch.parallel.tempering import run_tempered

        cfg = self.cfg
        n_chains = n_chains or max(cfg.n_chains, 1)
        n_cycles = n_cycles or cfg.sampler.n_cycles
        n_dev = sharding.world_size()
        if mesh is None and n_chains > 1 and n_dev > 1 and n_dev >= n_chains \
                and n_dev % n_chains == 0:
            mesh = sharding.make_mesh(n_chains=n_chains, n_rows=n_dev // n_chains)
        state = self.state
        if cfg.sampler.scrambled:
            state = mcmc.explode_genome(state)
        timer = StageTimer()
        with timer.stage("tempered_cycles"):
            final, l_cold, pt = run_tempered(
                self.table, self.obs, self.nb, state, self.params, n_chains=n_chains,
                n_cycles=n_cycles, delta=cfg.sampler.n_neighbours, t_max=t_max,
                exchange_every=exchange_every, seed=cfg.sampler.seed, scorer=self.scorer,
                progress=progress, mesh=mesh)
        check_invariants(final)
        self.state = final
        self.l_t = l_cold
        self.chain_states = pt["chain_states"]
        self.timer = timer
        metrics = {"likelihood": pt["trace"][:, 0].tolist(),
                   "likelihood_all_chains": pt["trace"].tolist(),
                   "swap_accepts": list(pt["swaps"]),
                   "n_contigs": pt["n_contigs"][:, 0].tolist(),
                   "dist_init_genome": [self._dist(final)]}
        return Assembly(state=final, params=self.params, table=self.table, obs=self.obs,
                        metrics=metrics, level=self.level)

    def jump_table(self, delta: int) -> "mtm_mod.JumpTable":
        """The MTM jumping distributions of this level: ``bin_matrix``
        normalised by each bin's accu mass (n_accu summed over its subs)."""
        n_accu = np.asarray(self.sub_soa["n_accu"], np.float64)
        norm = np.array([n_accu[lo:hi + 1].sum() for lo, hi in self.bin_to_subs])
        return mtm_mod.build_jump_table(self.bin_matrix, norm, self.state.id_d.cpu().numpy(),
                                        self.state.n_frags, delta, device=self.device)

    def run_mtm(self, n_cycles=None, variant="mtm", delta=5, progress=True,
                assembly: Assembly | None = None) -> Assembly:
        """MTM (or plain MH, ``variant='mh'``) refinement cycles (start_MTM,
        main_gl.py:344-399), usually after EM on its ``assembly``: every
        pass of a step scores its (delta + 2) x 13 candidates in one call of
        the run's scorer. A cycle is one captured graph replayed once a step
        on the card (``core.mtm.make_mtm_cycle``); each cycle's f_t (the
        sampler's temperature schedule) is reloaded into the graph's 0-d
        buffer, so the card divides by it as the eager body does. The
        generator is seeded with ``seed + 1``."""
        cfg = self.cfg
        dev = self.device
        n_cycles = n_cycles or cfg.sampler.n_cycles
        cycle = mtm_mod.make_mtm_cycle(self.table, self.obs, self.jump_table(delta),
                                       variant=variant, scorer=self.scorer)
        state = assembly.state if assembly else self.state
        params = assembly.params if assembly else self.params
        gen = torch.Generator(device=dev).manual_seed(cfg.sampler.seed + 1)
        l_t = self._initial_likelihood(state, params)
        collected = {"likelihood": [], "n_contigs": [], "accepts": [], "dist_init_genome": []}
        n = state.n_frags
        timer = StageTimer()
        t0 = time.time()
        for j in range(n_cycles):
            order = torch.randperm(n, generator=gen, device=dev)
            f_t = temperature_schedule(cfg.sampler, j, n_cycles)
            with timer.stage(f"{variant}_cycle"):
                state, l_t, (lls, accepts, ncs) = cycle(state, gen, params, order, l_t, f_t)
                host = host_copy(lls, accepts, ncs, *state)
            collected["likelihood"].extend(host[0].tolist())
            collected["accepts"].extend(host[1].tolist())
            collected["n_contigs"].extend(host[2].tolist())
            dist = self._dist(host_state(host[3:]))
            collected["dist_init_genome"].extend([dist] * n)
            if progress:
                print(f"{variant} cycle {j}: loglik={float(host[0][-1]):.1f} "
                      f"accepts={int(host[1].sum())}/{n} n_contigs={int(host[2][-1])} "
                      f"dist={dist:.3f} ({time.time() - t0:.1f}s)", flush=True)
        check_invariants(state)
        self.state = state
        self.l_t = l_t
        self.timer = timer
        return Assembly(state=state, params=params, table=self.table, obs=self.obs,
                        metrics=collected, level=self.level)

    # ---- outputs ----------------------------------------------------------
    def save_behaviour(self, assembly: Assembly):
        """The reference's 9 txt series + mutation log
        (save_behaviour_to_txt, main_gl.py:321-342) and params.json; on
        rank 0 only under ``torch.distributed``."""
        if not sharding.is_writer():
            return
        out = self.cfg.output_dir
        m = assembly.metrics
        series = {
            "list_likelihood.txt": m.get("likelihood", []),
            "list_n_contigs.txt": m.get("n_contigs", []),
            "list_dist_init_genome.txt": m.get("dist_init_genome", []),
            "list_fact.txt": m.get("fact", []),
            "list_slope.txt": m.get("slope", []),
            "list_d_max.txt": m.get("d_max", []),
            "list_d_nuc.txt": m.get("v_inter", []),
            "list_success.txt": m.get("success", []),
            "list_mean_len.txt": m.get("mean_len", []),
        }
        for name, vals in series.items():
            with open(os.path.join(out, "0" + name), "w") as fh:
                for v in vals:
                    if isinstance(v, (bool, np.bool_)):
                        v = int(v)   # 0/1 like the reference series
                    fh.write(f"{v}\n")
        with open(os.path.join(out, "0list_mutations.txt"), "w") as fh:
            fh.write("id_fA\tid_fB\tid_mutation\n")
            for fa, fb, op in zip(m.get("id_f_a", []), m.get("id_f_sampled", []),
                                  m.get("op_sampled", [])):
                fh.write(f"{fa}\t{fb}\t{op}\n")
        # the JAX package writes any model's 8 parameters under the Rippe
        # names, the HiC model's included
        with open(os.path.join(out, "params.json"), "w") as fh:
            json.dump({k: float(v) for k, v in zip(RippeParams._fields, assembly.params)},
                      fh, indent=2)

    def save_matrix_snapshot(self, name: str, state: GenomeState | None = None):
        """Observed bin matrix reordered by the current genome
        (display_current_matrix, cuda_lib_gl.py:1581-1624): rows and
        columns sorted by (contig, position), contigs with an inactive
        fragment skipped. Saves ``<out>/<name>.npy`` (byte for byte the
        JAX package's for the same genome) and, where matplotlib is
        installed, ``<name>.png``; on rank 0 only under
        ``torch.distributed``. Returns the path without extension."""
        state = state if state is not None else self.state
        out = os.path.join(self.cfg.output_dir, name)
        if not sharding.is_writer():
            return out
        id_c, pos, activ, id_d = (x.cpu().numpy() for x in
                                  (state.id_c, state.pos, state.activ, state.id_d))
        order = []
        for c in np.unique(id_c):
            members = np.nonzero(id_c == c)[0]
            if not np.all(activ[members] == 1):
                continue
            order.extend(id_d[members[np.argsort(pos[members])]].tolist())
        m = self.bin_matrix[np.ix_(order, order)]
        np.save(out + ".npy", m)
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return out
        vmax = np.percentile(m[m > 0], 98) if (m > 0).any() else 1.0
        plt.figure(figsize=(6, 6), dpi=120)
        plt.imshow(m, vmin=0, vmax=vmax, cmap="afmhot_r", interpolation="nearest")
        plt.title(name)
        plt.colorbar(shrink=0.7)
        plt.savefig(out + ".png", bbox_inches="tight")
        plt.close()
        return out

    def probe_fragment(self, f_a: int, delta: int | None = None, u=None):
        """Likelihood-landscape probe: score all 13 ops against every
        neighbour of ``f_a`` (main_gl.py:414-661). ``u``: the uniforms of
        the neighbour draw, or a Generator (default: one seeded 0 on the
        run's device). Returns (neighbour ids, valid mask, (M, 13)
        scores), on the host."""
        delta = delta or self.cfg.sampler.n_neighbours
        if u is None:
            u = torch.Generator(device=self.device).manual_seed(0)
        elif not isinstance(u, torch.Generator):
            u = torch.tensor(np.asarray(u, np.float32), device=self.device)
        f_a = torch.tensor(f_a, device=self.device)
        ids, valid = mcmc.sample_neighbours(u, f_a, self.state, self.nb, delta)
        cands = build_candidates(self.state, f_a, ids)
        m, n = ids.shape[0], self.state.n_frags
        flat = GenomeState(*[x.reshape(m * N_CANDIDATES, n).contiguous() for x in cands])
        ll = self.score(flat, self.params).reshape(m, N_CANDIDATES)
        ids, valid, ll = host_copy(ids, valid, ll)
        return ids, valid, ll

    def polish_orientations(self, state: GenomeState | None = None) -> GenomeState:
        """Resolve unorientable fragments by neighbourhood consensus: every
        fragment without an orientation signal (one sub-fragment) takes the
        orientation of its nearest orientable neighbour in the contig (ties
        upstream), for locally consistent strandedness in the FASTA."""
        state = state if state is not None else self.state
        s = state.to_numpy()
        ori = s["ori"].copy()
        orientable = self.orientable
        for c in np.unique(s["id_c"]):
            members = np.nonzero(s["id_c"] == c)[0]
            order = members[np.argsort(s["pos"][members])]
            flags = orientable[order]
            if not flags.any():
                continue
            idx_orientable = np.nonzero(flags)[0]
            for k, f in enumerate(order):
                if not flags[k]:
                    nearest = idx_orientable[np.argmin(np.abs(idx_orientable - k))]
                    ori[f] = ori[order[nearest]]
        return state._replace(ori=torch.as_tensor(ori, dtype=torch.int32,
                                                  device=state.ori.device))

    def scan_parameter(self, name: str, values) -> np.ndarray:
        """Likelihood of the current genome over a grid of one model
        parameter (the reference's d_space / alpha_space scans). c1 is
        re-derived for slope / kuhn / lm scans."""
        if name not in RippeParams._fields:
            raise ValueError(f"unknown parameter {name!r}; one of {RippeParams._fields}")
        one = GenomeState(*[x[None] for x in self.state])
        out = []
        for v in np.asarray(values, np.float32):
            p = self.params._replace(**{name: torch.tensor(v, device=self.device)})
            if name in ("slope", "kuhn", "lm"):
                p = p._replace(c1=0.53 * torch.pow(p.lm / p.kuhn, p.slope)
                               * torch.pow(p.kuhn, -3.0))
            out.append(self.score(one, p)[0])
        return torch.stack(out).cpu().numpy()

    def export_fasta(self, assembly: Assembly, genome_fasta: str):
        """Assembled genome FASTA + info_frags.txt + assembly_stats.json
        (export_new_fasta, simulation_loader.py:781-783)."""
        seqs = fasta_io.load_fasta(genome_fasta)
        f = self.level.frags
        return fasta_io.export_assembly(
            assembly.state, f.chrom, f.start_pos, f.end_pos, seqs,
            os.path.join(self.cfg.output_dir, "genome.fasta"),
            os.path.join(self.cfg.output_dir, "info_frags.txt"))
