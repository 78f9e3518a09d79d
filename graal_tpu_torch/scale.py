"""Chr1-scale assembly: sparse observed contacts and delta scoring end to end.

PyTorch counterpart of ``graal_tpu.scale`` (``ScaleRunner.run`` and its
compiled pieces). The observed map stays a :class:`core.sparse.SparseObs`;
candidates are scored by the mini-state delta engine (:mod:`core.delta`)
at a contig-capacity bucket ``f_max`` chosen per step from a ladder of
tiers; the carried likelihood is re-anchored once per cycle by the sparse
banded full evaluation, which also scores the optional per-cycle
nuisance-parameter step. Every cycle is a scan of steps and every cycle end
(the re-anchor and the nuisance step, :meth:`ScaleRunner.cycle_end`) one
step of a scan (:mod:`core.graphs`): on the card captured graphs, which a
run releases when it ends (``run_chains`` and ``run_mtm`` also when they
leave a bucket).

The device work of a chunk of steps is enqueued without a host read; the
host reads the chunk's operations and overflow counts only between chunks.
One :class:`WindowObsGrid` and one :class:`MiniGridScorer` serve every
bucket, so their launch counts cover the whole run.

Repeat (copy-expanded) tables run the same loop: the delta step routes
them to the repeat engine (:mod:`core.delta_repeats`) and the anchor to the
copy-summing sparse likelihood; the runner then needs ``id_d`` (the data
bin of each copy-fragment, for the neighbour tables). The repeat engine's
exactness contract is checked against the repeat flags of the genome a
cycle runs on (``run``'s ``state0``, ``cycle_for``'s ``rep``).

``run`` checkpoints every few cycles (state, params, the generator's
state and the metric history: ``utils.checkpoint``) and resumes from the
file bit for bit. :func:`from_dataset` builds a runner straight from a
dataset directory without ever densifying the map.

``run_mtm`` refines an assembly with the delta-scored MTM / MH samplers
(``core.mtm``, the MH catalogue through B4 + B2), and
:func:`run_multilevel` assembles coarse-to-fine over pyramid levels.

``run_chains`` runs N parallel-tempered chains. On one device the chains
are a leading axis of every tensor of one delta step (``core.delta``):
each step scores every chain's neighbour slots in one B4 and one B2
launch, the chains' sparse re-anchor is one chains-axis evaluation, and
each chain carries its own nuisance parameters. Under ``torch.distributed``
(more than one rank) the chains split over the ranks of a
``parallel.sharding`` mesh and the anchor's sums over its rows; ``run``'s
anchor and nuisance scorer then take the row-sharded anchor too.
``run`` can paint the genome layout every few cycles and refresh the live
page (``utils.plots``, ``utils.live``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from graal_tpu_torch.core import delta as delta_mod
from graal_tpu_torch.core import mcmc, sparse
from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.state import (GenomeState, check_invariants,
                                        derive_prev_next, dist_inter_genome)
from graal_tpu_torch.core.subfrags import SubFragTable
from graal_tpu_torch.ops.mini_grid_cuda import MiniGridScorer
from graal_tpu_torch.ops.obsgrid_cuda import WindowObsGrid
from graal_tpu_torch.parallel.sharding import is_writer
from graal_tpu_torch.utils import checkpoint as ckpt_io
from graal_tpu_torch.utils import live


def _next_pow2(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


def max_contig_subs(state: GenomeState, table: SubFragTable) -> int:
    """Largest contig size measured in sub-fragments (host)."""
    id_c = state.id_c.cpu().numpy()
    counts = delta_mod.build_mini_table(table, allow_repeats=True).sub_count.cpu().numpy()
    _, inv = np.unique(id_c, return_inverse=True)
    return int(np.bincount(inv, weights=counts.astype(np.float64)).max())


def contig_frags_per_frag(state: GenomeState) -> np.ndarray:
    """(n,) fragment count of each fragment's contig (host)."""
    _, inv = np.unique(state.id_c.cpu().numpy(), return_inverse=True)
    return np.bincount(inv)[inv]


class ScaleRunner:
    """One configured chr1-scale assembly run on the device of ``table``
    (``sobs`` and ``params`` live there too). A repeat table needs ``id_d``
    (see the module docstring); ``sobs`` then lies on the data grid.
    ``bin_csr`` / ``bin_norm``: the bin-grid contact matrix and per-bin
    accu normaliser of the MTM jump tables (:meth:`run_mtm`); they default
    to the data grid, valid when the two grids coincide (one sub per
    bin)."""

    def __init__(self, table: SubFragTable, sobs: sparse.SparseObs,
                 params: RippeParams, nb: mcmc.NeighbourTable | None = None,
                 band_margin: float = 2.0, id_d=None, bin_csr=None, bin_norm=None):
        import scipy.sparse as sp

        if table.has_repeats and id_d is None and nb is None:
            raise ValueError("a repeat table needs id_d (the data bin of each "
                             "copy-fragment) for its neighbour tables")
        self.table = table
        self.sobs = sobs
        self.params = params
        self.device = table.owner.device
        self.id_d = None if id_d is None else np.asarray(id_d)
        if nb is None:
            n = sobs.n
            m = sp.coo_matrix((sobs.vals.cpu().numpy(),
                               (sobs.rows.cpu().numpy(), sobs.cols.cpu().numpy())),
                              shape=(n, n)).tocsr()
            id_d = np.arange(n) if id_d is None else np.asarray(id_d)
            nb = mcmc.build_neighbour_table(m, id_d, len(id_d), device=self.device)
        self.nb = nb
        self.w = sparse.band_width(table.len_kb, float(params.d_max), margin=band_margin)
        # nuisance d_max proposals must stay inside the band coverage; when
        # the band spans every pair the banded evaluation is exact for any
        # d_max
        if self.w >= table.n_subs - 1:
            self.max_covered_d_max = float("inf")
        else:
            self.max_covered_d_max = float(
                np.sort(table.len_kb.cpu().numpy())[: self.w].sum())
        self.bin_csr = bin_csr
        self.bin_norm = bin_norm
        self.obs_grid = WindowObsGrid()
        self.mini_grid = MiniGridScorer()
        self._anchor = None
        self._chains_anchor = None
        self._cycles = {}      # every scan of the runner: its cycles and cycle ends

    # ---- pieces ------------------------------------------------------------
    def chains_anchor_fn(self):
        """The chains' sparse likelihood ``fn(states (C, n), params) -> (C,)``
        (params shared or one set per chain): with more than one rank, the
        row-sharded anchor over all ranks
        (``parallel.sharding.make_sharded_sparse_anchor``), else one
        chains-axis evaluation on this device."""
        if self._chains_anchor is None:
            from graal_tpu_torch.parallel import sharding

            n = sharding.world_size()
            if n > 1:
                self._chains_anchor = sharding.make_sharded_sparse_anchor(
                    sharding.make_mesh(n_chains=1, n_rows=n),
                    self.table, self.sobs, self.w)
            else:
                self._chains_anchor = sparse.make_sparse_loglik(self.table, self.sobs, self.w)
        return self._chains_anchor

    def anchor_fn(self):
        """Full sparse likelihood ``fn(state, params) -> 0-d f32`` (row-sharded
        with more than one rank, see :meth:`chains_anchor_fn`)."""
        if self._anchor is None:
            batched = self.chains_anchor_fn()

            def anchor(state: GenomeState, params: RippeParams):
                return batched(GenomeState(*[x[None] for x in state]), params)[0]

            self._anchor = anchor
        return self._anchor

    def _check_rep(self, rep):
        """On a repeat table, check the repeat engine's exactness contract
        against ``rep``, the repeat flags of the genome a cycle will run on
        (host): a cycle is built once and may run on several genomes."""
        if self.table.has_repeats:
            from graal_tpu_torch.core.delta_repeats import check_exactness_contract

            if rep is None:
                raise ValueError("a repeat table's cycle needs the genome's rep flags")
            check_exactness_contract(self.table, rep)

    def cycle_for(self, f_max: int, delta: int, rep=None):
        """The delta cycle of bucket ``f_max``, without an internal re-anchor
        (the runner anchors once per cycle). On a repeat table ``rep``, the
        repeat flags of the genome the cycle will run on, is required: the
        repeat engine's exactness contract is checked against it (host)
        on every call, the cycle itself built once."""
        self._check_rep(rep)
        if (f_max, delta) not in self._cycles:
            self._cycles[(f_max, delta)] = delta_mod.make_delta_em_cycle(
                self.table, None, self.nb, delta=delta, f_max=f_max, sobs=self.sobs,
                anchor_fn=False, band_w=self.w, obs_grid=self.obs_grid,
                mini_grid=self.mini_grid, rep=rep)
        return self._cycles[(f_max, delta)]

    def release_graphs(self, *keep):
        """Release the captured graphs of this runner's scans (its cycles
        and cycle ends), all but ``keep``'s
        (:meth:`core.graphs.Scan.release`): their memory goes back to the
        allocator, and a scan called again captures anew. A run releases
        every scan's when it ends, and ``run_chains`` and ``run_mtm`` the
        buckets they leave, so a run holds graph memory only for the bucket
        it steps in (and, in ``run``, the tiers of its cycles), and none
        once it returns."""
        for cycle in self._cycles.values():
            if all(cycle is not k for k in keep):
                cycle.scan.release()

    def cycle_end(self, sample_param: bool, chains: bool = False, capture=None):
        """The end of every cycle of :meth:`run` (one genome) or
        :meth:`run_chains` (``chains``: a chains axis, each chain with its
        own parameters and temperature): the re-anchor under the current
        parameters and, with ``sample_param``, the nuisance-parameter
        Metropolis step, its test parameters scored by the same anchor.
        The JAX package jits each; here both are one step of a
        :class:`core.graphs.Scan`, a captured graph replayed once a cycle
        on the card (``capture``: as the scan takes it; False runs eagerly).
        With more than one rank the anchor is row-sharded (an
        ``all_reduce``) and the end runs eagerly.

        Returns ``end(states, params, f_t, draws) -> (params, l_anchor,
        l_t)``: ``draws`` the step's :class:`core.mcmc.NuisanceDraws` (None
        without ``sample_param``), drawn by the caller from the run's
        generator outside the graph; ``l_anchor`` the re-anchor, ``l_t``
        the likelihood after the nuisance step."""
        from graal_tpu_torch.core import graphs
        from graal_tpu_torch.parallel import sharding

        if sharding.world_size() > 1:
            capture = False
        key = ("end", sample_param, chains, capture)
        if key not in self._cycles:
            anchor = self.chains_anchor_fn() if chains else self.anchor_fn()
            cap = self.max_covered_d_max

            def body(params, consts, draws):
                states, f_t = consts
                l_anchor = anchor(states, params)
                if not sample_param:
                    return params, (l_anchor, l_anchor)
                test, ok, _ = mcmc.nuisance_propose(draws.id_modif, draws.eps, params, cap)
                params, l_t, _ = mcmc.nuisance_accept(draws.u_acc, test, params,
                                                      anchor(states, test), l_anchor, f_t, ok)
                return params, (l_anchor, l_t)

            scan = graphs.Scan(body, self.device, capture=capture)

            def end(states, params, f_t, draws):
                draws = None if draws is None else type(draws)(*[x[None] for x in draws])
                params, (l_anchor, l_t) = scan(params, (states, f_t), draws, n_steps=1)
                return params, l_anchor[0], l_t[0]

            end.scan = scan
            self._cycles[key] = end
        return self._cycles[key]

    # ---- run ---------------------------------------------------------------
    def run(self, state0: GenomeState, n_cycles: int, delta: int = 4,
            steps_per_cycle: int | None = None, f_max_min: int = 256,
            f_max_cap: int = 1 << 14, f_t: float = 1.0,
            sample_param: bool = False, seed: int = 1, progress: bool = True,
            init_truth: GenomeState | None = None, chunk_steps: int = 512,
            order_mode: str = "random", checkpoint_path: str | None = None,
            checkpoint_every: int = 1, resume: bool = False, snapshot_every: int = 0,
            snapshot_dir: str | None = None, chrom_of_bin=None, watch: bool = False):
        """Assemble from ``state0``; returns (state, params, metrics).

        ``steps_per_cycle`` caps the fragment steps per cycle (default every
        fragment once); ``init_truth`` enables the dist_init_genome series.
        ``order_mode``: which fragments a subsampled cycle visits, "random"
        (a shuffled sweep truncated) or "extremity" (contig extremities
        first, shuffled, then interior fragments): repairs happen at
        extremities.

        Steps run on a ladder of capacity tiers per cycle (f_max_min,
        2 f_max_min, ... up to the bucket of the biggest contig): each step
        pays the bucket its own contig needs, and a step that overflowed its
        tier (the partner's contig was bigger) retries at the top tier.
        ``chunk_steps`` bounds the steps enqueued between two host reads;
        the last chunk of a tier wraps around its fragment order.

        Randomness comes from one ``torch.Generator`` seeded with ``seed``
        on the runner's device: the same seed gives the same run.

        ``checkpoint_path``: npz checkpoint written every
        ``checkpoint_every`` cycles (state, params, cycle, the generator's
        state, the metric history); with ``resume`` the run picks up from
        the file, when it exists, bit for bit.

        ``snapshot_every`` + ``chrom_of_bin`` (the source chromosome of each
        bin): a genome-layout painting (``utils.plots.plot_genome_layout``,
        the chr1-scale stand-in for the dense path's matrix snapshots) every
        that many cycles into ``snapshot_dir``, where matplotlib is
        installed. ``watch``: refresh ``<snapshot_dir>/live.html`` every
        cycle (``utils.live``)."""
        if order_mode not in ("random", "extremity"):
            raise ValueError(f"unknown order_mode {order_mode!r}")
        n = state0.n_frags
        rep = state0.rep.cpu().numpy()   # fixed for the run: no move changes rep
        dev = self.device
        steps = steps_per_cycle or n
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = state0
        params = self.params
        start_cycle = 0
        metrics = {"likelihood": [], "n_contigs": [], "overflow": [],
                   "dist_init_genome": [], "f_max": [], "tiers": [], "cycle_s": [],
                   "fact": [], "slope": [], "d_max": [], "v_inter": []}
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            state, params, start_cycle, gen_state, extra = ckpt_io.load_checkpoint(
                checkpoint_path, dev)
            gen.set_state(gen_state)
            metrics.update(ckpt_io.metrics_from_extra(extra))
            if progress:
                print(f"resumed from {checkpoint_path} at cycle {start_cycle}", flush=True)
        anchor = self.anchor_fn()
        l_t = anchor(state, params)
        mt = delta_mod.build_mini_table(self.table, allow_repeats=True)
        s_max = mt.s_max

        dist_ref = None
        if init_truth is not None:
            ip, inx = derive_prev_next(init_truth)
            id_d = init_truth.id_d.cpu().numpy()
            ip = np.where(ip != -1, id_d[np.clip(ip, 0, None)], -1)
            inx = np.where(inx != -1, id_d[np.clip(inx, 0, None)], -1)
            # single-sub bins carry no orientation signal -> unorientable
            orientable = mt.sub_count.cpu().numpy() > 1
            dist_ref = (ip, inx, init_truth.ori.cpu().numpy(), orientable,
                        np.zeros(n, bool))

        ladder = sorted({c for c in (chunk_steps, 128, 32) if c <= chunk_steps},
                        reverse=True)

        def run_tier(state, l_t, bucket, order_np):
            """``order_np`` steps at one bucket, in chunks of the ladder."""
            cycle = self.cycle_for(bucket, delta, rep)
            outs = []
            i = 0
            while i < len(order_np):
                rem = len(order_np) - i
                chunk = next((c for c in ladder if c <= rem), ladder[-1])
                seg = order_np[i:i + chunk]
                if len(seg) < chunk:   # wrap-pad the tail
                    seg = np.concatenate([seg, order_np[: chunk - len(seg)]])
                state, l_t, out = cycle(state, gen, params,
                                        torch.as_tensor(seg, device=dev), l_t, f_t)
                outs.append([x.cpu().numpy() for x in out])   # host read between chunks
                i += chunk
            return state, l_t, outs

        t0 = time.time()
        for j in range(start_cycle, n_cycles):
            big_bucket = _next_pow2(2 * max_contig_subs(state, self.table) + 2 * s_max)
            big_bucket = int(np.clip(big_bucket, f_max_min, f_max_cap))
            big_bucket = min(big_bucket, _next_pow2(n))
            small_bucket = min(f_max_min, big_bucket)
            perm = torch.randperm(n, generator=gen, device=dev).cpu().numpy()
            if order_mode == "extremity" and steps < n:
                pos_np = state.pos.cpu().numpy()
                lc_np = state.l_cont.cpu().numpy()
                ext = (state.activ.cpu().numpy() == 1) & (
                    (pos_np == 0) | (pos_np == lc_np - 1))
                order = np.concatenate([perm[ext[perm]], perm[~ext[perm]]])[:steps]
            else:
                order = perm[:steps]
            tc = time.time()
            cfrag = contig_frags_per_frag(state)
            # per-step tier: the bucket the step's own contig needs (the
            # partner's contig is budgeted by the same doubling; a true
            # overflow retries at the top tier below)
            need = np.clip(2 * cfrag[order] + 2 * s_max + 2, small_bucket, big_bucket)
            tier_of = np.minimum(
                np.left_shift(1, np.ceil(np.log2(need)).astype(np.int64)), big_bucket)
            tiers = sorted(set(tier_of.tolist()))
            outs = []
            retry = np.zeros(0, order.dtype)
            for t_ix, tier in enumerate(tiers):
                tier_order = order[tier_of == tier]
                if t_ix == len(tiers) - 1:   # top tier absorbs retries
                    tier_order = np.concatenate([tier_order, retry])
                    retry = np.zeros(0, order.dtype)
                if not len(tier_order):
                    continue
                state, l_t, outs_t = run_tier(state, l_t, int(tier), tier_order)
                outs.extend(outs_t)
                # fully-overflowed steps (op == -1 with overflow counted) go
                # around again at the top tier
                ops_t = np.concatenate([o[1] for o in outs_t])
                overs_t = np.concatenate([o[3] for o in outs_t])
                src = tier_order if len(ops_t) == len(tier_order) else \
                    np.concatenate([tier_order, tier_order[: len(ops_t) - len(tier_order)]])
                retry = np.concatenate([retry, src[(ops_t == -1) & (overs_t > 0)]])
            if len(retry):   # retries from the top tier itself
                state, l_t, outs_r = run_tier(state, l_t, big_bucket, retry)
                outs.extend(outs_r)
            overs = np.concatenate([o[3] for o in outs])
            ncs = np.concatenate([o[4] for o in outs])
            # one re-anchor (and nuisance step) per cycle
            draws = mcmc.draw_nuisance_inputs(gen) if sample_param else None
            params, _, l_t = self.cycle_end(sample_param)(state, params, f_t, draws)
            l_t_host = float(l_t)
            cycle_s = time.time() - tc
            n_over = int(overs.sum())
            nc = int(ncs[-1])
            metrics["likelihood"].append(l_t_host)
            metrics["n_contigs"].append(nc)
            metrics["overflow"].append(n_over)
            metrics["f_max"].append(big_bucket)
            metrics["tiers"].append([int(t) for t in tiers])
            metrics["cycle_s"].append(cycle_s)
            for pname in ("fact", "slope", "d_max", "v_inter"):
                metrics[pname].append(float(getattr(params, pname)))
            dist = None
            if dist_ref is not None:
                dist = dist_inter_genome(state, *dist_ref)
                metrics["dist_init_genome"].append(dist)
            if progress:
                msg = (f"scale cycle {j}: loglik={l_t_host:.1f} n_contigs={nc} "
                       f"f_max={big_bucket} tiers={tiers} overflow={n_over} "
                       f"({cycle_s:.1f}s, total {time.time() - t0:.1f}s)")
                if dist is not None:
                    msg += f" dist={dist:.3f}"
                print(msg, flush=True)
            if not is_writer():   # under torch.distributed rank 0 writes
                continue
            if checkpoint_path and checkpoint_every and (j + 1) % checkpoint_every == 0:
                ckpt_io.save_checkpoint(checkpoint_path, state, params, j + 1, gen,
                                        extra=ckpt_io.metrics_extra(metrics))
            stats = {"cycle": j, "loglik": l_t_host, "n_contigs": nc, "f_max": big_bucket,
                     "cycle_s": round(cycle_s, 1)}
            if dist is not None:
                stats["dist"] = dist
            live.refresh(snapshot_dir or ".", j, state, chrom_of_bin, stats,
                         metrics["likelihood"], snapshot_every, watch)
        self.release_graphs()
        check_invariants(state)
        self.params = params
        return state, params, metrics

    # ---- tempered chains ----------------------------------------------------
    def chains_cycle_for(self, f_max: int, delta: int, mesh=None, rep=None):
        """The chains' delta cycle of bucket ``f_max`` (no internal
        re-anchor): ``cycle(states, rng, params_c, orders, l_ts, f_ts) ->
        (states, l_ts, ...)`` over a chains axis, each chain with its own
        parameters; with a ``mesh`` the chains split over its ranks
        (``parallel.sharding.make_sharded_delta_cycle``). Every bucket
        launches through the runner's one B4 and one B2 wrapper. ``rep``:
        as :meth:`cycle_for` takes it."""
        self._check_rep(rep)
        key = (f_max, delta, "chains", id(mesh))
        if key not in self._cycles:
            if mesh is None:
                self._cycles[key] = delta_mod.make_delta_em_cycle(
                    self.table, None, self.nb, delta=delta, f_max=f_max, sobs=self.sobs,
                    anchor_fn=False, band_w=self.w, obs_grid=self.obs_grid,
                    mini_grid=self.mini_grid, rep=rep)
            else:
                from graal_tpu_torch.parallel.sharding import make_sharded_delta_cycle

                self._cycles[key] = make_sharded_delta_cycle(
                    mesh, self.table, self.nb, delta=delta, f_max=f_max, sobs=self.sobs,
                    band_w=self.w, per_chain_params=True, obs_grid=self.obs_grid,
                    mini_grid=self.mini_grid, rep=rep)
        return self._cycles[key]

    def run_chains(self, state0: GenomeState, n_chains: int, n_cycles: int, delta: int = 4,
                   steps_per_cycle: int | None = None, f_max_min: int = 256,
                   f_max_cap: int = 1 << 14, f_t: float = 1.0, t_max: float = 4.0,
                   exchange_every: int = 2, seed: int = 1, sample_param: bool = False,
                   chunk_steps: int = 512, checkpoint_path: str | None = None,
                   checkpoint_every: int = 1, resume: bool = False, progress: bool = True,
                   snapshot_every: int = 0, snapshot_dir: str | None = None,
                   chrom_of_bin=None, watch: bool = False):
        """N parallel-tempered chains from ``state0``; returns (best_state,
        best_ll, metrics).

        Chain c runs at temperature ``ladder[c]``, geometric from ``f_t`` up
        to ``t_max`` (chain 0 is the cold chain). A cycle runs every
        chain's ``steps_per_cycle`` steps (default every fragment once, in
        each chain's own shuffled order) at one contig-capacity bucket,
        sized for the largest contig across the chains, in chunks of
        ``chunk_steps`` steps enqueued without a host read; each step of
        all chains launches B4 and B2 once. Each chain is then re-anchored
        under its own parameters (the chains' sparse anchor, one
        evaluation), takes its nuisance-parameter Metropolis step at its
        own temperature when ``sample_param`` (each chain carries its own
        parameters; the test parameters' likelihoods are one chains'
        anchor call), and every ``exchange_every`` cycles one round of
        adjacent-pair replica-exchange swaps
        (``parallel.tempering.pt_swap``) moves (genome, params, likelihood)
        as a unit. The result is the argmax-likelihood chain, whose
        parameters come under ``metrics["params"]`` when ``sample_param``.
        Metrics: every chain's likelihood per cycle (``likelihood``), the
        best, the bucket (``f_max``), the accepted swaps, each chain's
        |carried - re-anchored| likelihood before the re-anchor
        (``drift``), ``cycle_s``.

        Randomness comes from one ``torch.Generator`` seeded with ``seed``.
        ``checkpoint_path``: an npz of the whole ensemble (every chain's
        genome, parameters and likelihood, the cycle, the swap parity, the
        generator's state, the metrics) written by atomic rename every
        ``checkpoint_every`` cycles; ``resume`` continues from it bit for
        bit. Under ``torch.distributed`` the chains split over a
        ``parallel.sharding.chain_mesh`` (every rank holds the whole
        ensemble between chunks, and only rank 0 writes the checkpoint).

        ``snapshot_every`` / ``watch``: as :meth:`run` takes them, drawn
        from the best chain of the cycle (the live page's series is the
        best likelihood). The JAX package's ``run_chains`` has neither."""
        from graal_tpu_torch.parallel import sharding
        from graal_tpu_torch.parallel.tempering import pt_swap, temperature_ladder

        n = state0.n_frags
        dev = self.device
        steps = steps_per_cycle or n
        rep = state0.rep.cpu().numpy()   # no move changes rep
        mesh = sharding.chain_mesh(n_chains) if sharding.world_size() > 1 else None
        states = GenomeState(*[x.expand(n_chains, n).clone() for x in state0])
        params_c = RippeParams(*[torch.as_tensor(x, device=dev).expand(n_chains).clone()
                                 for x in self.params])
        l_ts = self.anchor_fn()(state0, self.params).expand(n_chains).clone()
        ladder = torch.as_tensor(temperature_ladder(n_chains, t_min=f_t,
                                                    t_max=max(t_max, f_t)), device=dev)
        end = self.cycle_end(sample_param, chains=True)
        s_max = delta_mod.build_mini_table(self.table, allow_repeats=True).s_max
        gen = torch.Generator(device=dev).manual_seed(seed)
        metrics = {"likelihood": [], "best": [], "f_max": [], "swaps": [], "drift": [],
                   "cycle_s": []}
        swap_round = 0
        start_cycle = 0
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            (states, params_c, l_ts, start_cycle, swap_round,
             gen_state, resumed) = load_chains_checkpoint(checkpoint_path, dev)
            gen.set_state(gen_state)
            metrics.update(resumed)
            if progress:
                print(f"resumed tempered ensemble from {checkpoint_path} at cycle "
                      f"{start_cycle}", flush=True)
        t0 = time.time()
        for j in range(start_cycle, n_cycles):
            tc = time.time()
            big = max(max_contig_subs(GenomeState(*[x[c] for x in states]), self.table)
                      for c in range(n_chains))
            bucket = int(np.clip(_next_pow2(2 * big + 2 * s_max), f_max_min,
                                 min(f_max_cap, _next_pow2(n))))
            cycle = self.chains_cycle_for(bucket, delta, mesh=mesh, rep=rep)
            self.release_graphs(cycle, end)
            order = torch.stack([torch.randperm(n, generator=gen, device=dev)[:steps]
                                 for _ in range(n_chains)])
            for i in range(0, steps, chunk_steps):
                states, l_ts, *_ = cycle(states, gen, params_c, order[:, i:i + chunk_steps],
                                         l_ts, ladder)
            # re-anchor each chain under its own params (f32 drift control),
            # then its nuisance step at its own temperature
            draws = mcmc.draw_nuisance_inputs(gen, (n_chains,)) if sample_param else None
            carried = l_ts
            params_c, l_anchor, l_ts = end(states, params_c, ladder, draws)
            metrics["drift"].append((carried - l_anchor).abs().tolist())
            n_swaps = 0
            if exchange_every and (j + 1) % exchange_every == 0 and n_chains > 1:
                (states, params_c), l_ts, acc = pt_swap((states, params_c), l_ts, ladder, gen,
                                                        parity=swap_round % 2)
                swap_round += 1
                n_swaps = int(acc.sum())
            lls = l_ts.cpu().numpy()
            metrics["likelihood"].append(lls.tolist())
            metrics["best"].append(float(lls.max()))
            metrics["f_max"].append(bucket)
            metrics["swaps"].append(n_swaps)
            metrics["cycle_s"].append(time.time() - tc)
            if progress:
                print(f"chains cycle {j}: best={lls.max():.1f} "
                      f"spread={lls.max() - lls.min():.1f} swaps={n_swaps} f_max={bucket} "
                      f"({time.time() - t0:.1f}s)", flush=True)
            if not is_writer():   # under torch.distributed rank 0 writes
                continue
            if checkpoint_path and checkpoint_every and (j + 1) % checkpoint_every == 0:
                save_chains_checkpoint(checkpoint_path, states, params_c, l_ts, j + 1,
                                       swap_round, gen, metrics)
            if watch or snapshot_every:
                best_state = GenomeState(*[x[int(lls.argmax())] for x in states])
                stats = {"cycle": j, "loglik": float(lls.max()),
                         "n_contigs": int(best_state.n_contigs()), "f_max": bucket,
                         "chains": n_chains, "swaps": n_swaps,
                         "cycle_s": round(metrics["cycle_s"][-1], 1)}
                live.refresh(snapshot_dir or ".", j, best_state, chrom_of_bin, stats,
                             metrics["best"], snapshot_every, watch)
        self.release_graphs()
        best = int(torch.argmax(l_ts))
        final = GenomeState(*[x[best].clone() for x in states])
        check_invariants(final)
        if sample_param:
            metrics["params"] = RippeParams(*[x[best].clone() for x in params_c])
        self.chain_states = states
        return final, float(l_ts[best]), metrics

    def jump_table(self, delta: int, n_frags: int):
        """The MTM jumping distributions on the bin grid (``bin_csr`` /
        ``bin_norm``), or on the data grid when they were not given (one
        sub per bin; a repeat table reads each bin's accu through any of its
        copies)."""
        import scipy.sparse as sp

        from graal_tpu_torch.core.mtm import build_jump_table

        n = n_frags
        if self.bin_csr is not None:
            bin_m, norm = self.bin_csr, self.bin_norm
        else:
            nd = self.sobs.n
            data_id = self.table.data_id.cpu().numpy()
            accu = self.table.accu.cpu().numpy()
            owner = self.table.owner.cpu().numpy()
            if self.table.has_repeats:
                if self.table.n_data_sub != nd:
                    raise ValueError("pass bin_csr / bin_norm when the bin and data grids "
                                     "differ")
                norm = np.zeros(nd, np.float64)
                norm[data_id] = accu
            else:
                if self.table.n_data_sub != n or not np.array_equal(owner, data_id):
                    raise ValueError("pass bin_csr / bin_norm when the bin and data grids "
                                     "differ")
                norm = np.bincount(owner, weights=accu, minlength=nd)
            bin_m = sp.coo_matrix((self.sobs.vals.cpu().numpy(),
                                   (self.sobs.rows.cpu().numpy(),
                                    self.sobs.cols.cpu().numpy())), shape=(nd, nd)).tocsr()
        id_d = self.id_d if self.id_d is not None else np.arange(n)
        return build_jump_table(bin_m, norm, id_d, n, delta, device=self.device)

    def run_mtm(self, state0: GenomeState, n_cycles: int, delta: int = 5,
                steps_per_cycle: int | None = None, f_max_min: int = 256,
                f_max_cap: int = 1 << 14, f_t: float = 1.0, seed: int = 1,
                corrected: bool = False, chunk_steps: int = 512, variant: str = "mtm",
                progress: bool = True):
        """MTM (or plain MH, ``variant='mh'``) refinement at chr1 scale,
        delta-scored with the MH catalogue (start_MTM's role,
        main_gl.py:344-399), usually on :meth:`run`'s output. A repeat table
        goes to the repeat engine v2. Each cycle runs at the bucket of its
        largest contig, in chunks of ``chunk_steps`` steps enqueued without
        a host read, and is re-anchored by the full sparse likelihood. A
        bucket's cycle is a scan of steps (:func:`core.mtm.make_delta_mtm_cycle`:
        a captured graph on the card), whose graph is released when the run
        leaves the bucket and when it ends (:meth:`release_graphs`).
        Randomness comes from a ``torch.Generator`` seeded with ``seed``.
        Returns (state, l_t, metrics); ``metrics["launches"]`` counts the
        kernel launches of the refinement (ll_mini, obsgrid), read from the
        wrappers' counts on the card after the run."""
        from graal_tpu_torch.core.mtm import make_delta_mtm_cycle

        n = state0.n_frags
        dev = self.device
        steps = steps_per_cycle or n
        jump = self.jump_table(delta, n)
        rep = state0.rep.cpu().numpy()   # no move changes rep
        self._check_rep(rep)
        end = self.cycle_end(False)
        params = self.params
        state = state0
        l_t = self.anchor_fn()(state, params)
        s_max = delta_mod.build_mini_table(self.table, allow_repeats=True).s_max
        gen = torch.Generator(device=dev).manual_seed(seed)
        metrics = {"likelihood": [], "accept_rate": [], "n_contigs": [], "f_max": [],
                   "cycle_s": []}
        launches0 = (self.mini_grid.n_launches, self.obs_grid.n_launches)
        t0 = time.time()
        for j in range(n_cycles):
            bucket = _next_pow2(2 * max_contig_subs(state, self.table) + 2 * s_max)
            bucket = int(np.clip(bucket, f_max_min, min(f_max_cap, _next_pow2(n))))
            # the jump table is a function of the runner's maps and delta, so
            # a cycle built by an earlier call serves this one too
            key = ("mtm", bucket, delta, variant, corrected)
            if key not in self._cycles:
                self._cycles[key] = make_delta_mtm_cycle(
                    self.table, jump, bucket, self.sobs, variant=variant, band_w=self.w,
                    corrected=corrected, obs_grid=self.obs_grid, mini_grid=self.mini_grid,
                    rep=rep)
            cycle = self._cycles[key]
            self.release_graphs(cycle, end)
            tc = time.time()
            order = torch.randperm(n, generator=gen, device=dev)[:steps]
            accs = []
            for i in range(0, steps, chunk_steps):
                state, l_t, (_, acc, ncs) = cycle(state, gen, params, order[i:i + chunk_steps],
                                                  l_t, f_t)
                accs.append(acc.cpu().numpy())   # host read between chunks
            _, _, l_t = end(state, params, f_t, None)   # re-anchor per cycle
            acc_rate = float(np.mean(np.concatenate(accs)))
            nc = int(ncs[-1])
            metrics["likelihood"].append(float(l_t))
            metrics["accept_rate"].append(acc_rate)
            metrics["n_contigs"].append(nc)
            metrics["f_max"].append(bucket)
            metrics["cycle_s"].append(time.time() - tc)
            if progress:
                print(f"scale {variant} cycle {j}: loglik={float(l_t):.1f} "
                      f"accept={acc_rate:.2f} n_contigs={nc} f_max={bucket} "
                      f"({time.time() - t0:.1f}s)", flush=True)
        self.release_graphs()
        check_invariants(state)
        metrics["launches"] = {"ll_mini": self.mini_grid.n_launches - launches0[0],
                               "obsgrid": self.obs_grid.n_launches - launches0[1]}
        return state, float(l_t), metrics


def save_chains_checkpoint(path: str, states: GenomeState, params_c: RippeParams, l_ts,
                           cycle: int, swap_round: int, gen: torch.Generator, metrics: dict):
    """The tempered ensemble as one npz, written by atomic rename: every
    chain's genome (``s_<field>``, (C, n)), parameters (``params_c``, (C,
    8)) and likelihood (``l_ts``), the cycle, the swap parity, the
    generator's state and the metric history (the ``m_`` / ``mlen_``
    entries of ``utils.checkpoint.metrics_extra``)."""
    arrays = {f"s_{f}": getattr(states, f).cpu().numpy() for f in GenomeState._fields}
    arrays["params_c"] = np.stack([x.cpu().numpy() for x in params_c], axis=1)
    arrays["l_ts"] = l_ts.cpu().numpy()
    arrays["cycle"] = np.asarray(cycle, np.int64)
    arrays["swap_round"] = np.asarray(swap_round, np.int64)
    arrays["generator"] = gen.get_state().numpy()
    arrays.update(ckpt_io.metrics_extra({k: v for k, v in metrics.items() if len(v)}))
    tmp = path + ".tmp.npz"   # np.savez appends .npz unless already present
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_chains_checkpoint(path: str, device=None):
    """-> (states, params_c, l_ts, cycle, swap_round, generator state,
    metrics) of :func:`save_chains_checkpoint`, the tensors on ``device``."""
    with np.load(path) as data:
        states = GenomeState(*[torch.as_tensor(data[f"s_{f}"], device=device)
                               for f in GenomeState._fields])
        params_c = RippeParams(*[torch.as_tensor(np.ascontiguousarray(x), device=device)
                                 for x in data["params_c"].T])
        l_ts = torch.as_tensor(data["l_ts"], device=device)
        gen_state = torch.from_numpy(data["generator"].copy())
        metrics = ckpt_io.metrics_from_extra({k: data[k] for k in data.files})
        return (states, params_c, l_ts, int(data["cycle"]), int(data["swap_round"]),
                gen_state, metrics)


def from_dataset(dataset_dir: str, size: int, factor: int = 3,
                 level: int | None = None, min_bin_per_contig: int = 1,
                 max_fit_bins: int = 2048, max_dist_bins_factor: float = 1.0,
                 allow_repeats: bool = False, sub_sample: float = 0.0,
                 sub_sample_seed: int = 0, progress: bool = True,
                 ref_quirks: bool = False, device="cuda"):
    """Build a :class:`ScaleRunner` on ``device`` straight from a
    reference-format dataset directory, never densifying the map:

    - observed contacts: the sub-level's COO triplets -> SparseObs,
    - Rippe fit: ``model.fit_rippe_from_coo`` on the same triplets, window
      = mean source-contig length * ``max_dist_bins_factor``, capped at
      ``max_fit_bins`` distance bins,
    - v_inter: ``model.mean_value_trans_from_coo``,
    - ``allow_repeats``: coverage-outlier bins are duplicated into
      copy-expanded geometry (sparse coverage; the delta engine routes the
      table to the repeat engine),
    - neighbour proposals on the bin grid (the level matrix).

    Returns (runner, state0, level_handle, extras) where ``state0`` is the
    file-order genome and ``extras`` carries the fit curve."""
    import scipy.sparse as spsp

    from graal_tpu_torch.config import resolve_device
    from graal_tpu_torch.core.model import fit_rippe_from_coo, mean_value_trans_from_coo
    from graal_tpu_torch.core.subfrags import table_from_level
    from graal_tpu_torch.io import pyramid as pyramid_io
    from graal_tpu_torch.pipeline import detect_repeats_coverage, extend_with_repeats

    dev = resolve_device(device)
    pyr = pyramid_io.build_and_filter(dataset_dir, size, factor, min_bin_per_contig,
                                      ref_quirks=ref_quirks)
    lev, sub, bin_to_subs = pyr.sampling_level(level)
    lvl = lev.level
    soa = lev.genome_soa()
    sub_soa = sub.genome_soa()

    # repeat detection from sparse coverage (scale-invariant, so the raw
    # one-orientation row + column sums work)
    duplications = []
    if allow_repeats:
        raw = lev.sparse
        cov = (np.asarray(raw.sum(axis=0)).ravel() + np.asarray(raw.sum(axis=1)).ravel()
               - 2.0 * raw.diagonal())
        duplications = detect_repeats_coverage(cov, True)
        soa = extend_with_repeats(soa, duplications)
        if progress and duplications:
            print(f"{len(duplications)} repeated bins, "
                  f"{sum(d for _, d in duplications)} extra copies", flush=True)
    table = table_from_level(
        soa, {"len_bp": sub_soa["len_bp"], "n_accu": sub_soa["n_accu"]},
        bin_to_subs, id_d=soa["id_d"], device=dev)

    coo = sub.sparse.tocoo()
    sobs = sparse.sparse_from_coo(coo.row, coo.col, coo.data, sub.n_frags, device=dev)
    if 0.0 < sub_sample <= 1.0:
        # Poisson sub-sampling before the fit, so the parameters are
        # estimated from what is scored
        sobs = sparse.subsample_sparse(sobs, sub_sample, sub_sample_seed)
        if progress:
            print(f"sub-sampled contacts by {sub_sample}: "
                  f"{sobs.vals.shape[0]} symmetric nnz", flush=True)
    sr, sc, sv = (x.cpu().numpy() for x in (sobs.rows, sobs.cols, sobs.vals))

    v_inter = mean_value_trans_from_coo(sr, sc, sv, np.asarray(sub.frags.chrom))
    starts = sub_soa["pos"] == 0
    mean_dist_kb = float(np.mean(sub_soa["l_cont_bp"][starts])) / 1000.0
    size_bin_kb = float(np.mean(sub_soa["len_bp"])) / 1000.0
    max_dist_kb = min(mean_dist_kb * max_dist_bins_factor, max_fit_bins * size_bin_kb)
    if progress:
        print(f"scale level {lvl}: {lev.n_frags} bins, {sub.n_frags} data subs, "
              f"{sv.shape[0]} symmetric nnz; fitting over {max_dist_kb:.0f} kb in "
              f"{size_bin_kb:.1f} kb bins", flush=True)
    params, bins, mean_contacts, y_estim = fit_rippe_from_coo(
        sr, sc, sv, sub_soa, v_inter, max_dist_kb, size_bin_kb, device=dev)
    if progress:
        print("fitted params:", {f: round(float(getattr(params, f)), 5)
                                 for f in params._fields}, flush=True)

    state0 = GenomeState.from_soa(soa, device=dev)
    # neighbour proposals live on the bin grid (the level matrix), not on
    # the data grid; the two coincide only with one sub-fragment per bin
    m_bin = (lev.sparse + lev.sparse.T).tocsr()
    m_bin.setdiag(0)
    m_bin.eliminate_zeros()
    if 0.0 < sub_sample <= 1.0:
        up = spsp.triu(m_bin, k=1).tocoo()
        rng = np.random.default_rng(sub_sample_seed + 1)
        drawn = rng.poisson(np.maximum(up.data * sub_sample, 0.0))
        half = spsp.coo_matrix((drawn.astype(np.float64), (up.row, up.col)),
                               shape=m_bin.shape)
        m_bin = (half + half.T).tocsr()
        m_bin.eliminate_zeros()
    nb = mcmc.build_neighbour_table(m_bin, soa["id_d"], len(soa["id_d"]), device=dev)
    # MTM jump-table normaliser: per-bin accu mass summed over the bin's
    # data subs
    cs = np.concatenate([[0.0], np.cumsum(np.asarray(sub_soa["n_accu"], np.float64))])
    bin_norm = cs[bin_to_subs[:, 1] + 1] - cs[bin_to_subs[:, 0]]
    runner = ScaleRunner(table, sobs, params, nb=nb, id_d=soa["id_d"],
                         bin_csr=m_bin, bin_norm=bin_norm)
    extras = {"fit_bins": bins, "fit_contacts": mean_contacts, "fit_estim": y_estim,
              "v_inter": v_inter, "duplications": duplications, "pyramid": pyr,
              "level_soa": soa}
    return runner, state0, lev, extras


def run_multilevel(dataset_dir: str, size: int, from_level: int, to_level: int,
                   n_cycles: int, factor: int = 3, delta: int = 4, f_max_min: int = 256,
                   f_t: float = 1.0, sample_param: bool = False, seed: int = 1,
                   max_fit_bins: int = 2048, progress: bool = True, device="cuda"):
    """Coarse-to-fine sparse assembly: assemble at ``from_level`` from a
    scrambled start, then refine level by level down to ``to_level`` from
    orientation-aware projected warm starts
    (``multilevel.project_state_to_sub``), never densifying.

    Returns (final_state, last_runner, last_level_handle,
    metrics_per_level); each level's metrics carry its ``level`` and the
    ``launches`` of its runner's kernels (ll_mini, obsgrid)."""
    from graal_tpu_torch.multilevel import project_state_to_sub

    if not from_level >= to_level >= 0:
        raise ValueError(f"need from_level {from_level} >= to_level {to_level} >= 0")
    prev_final = None
    all_metrics = []
    runner = lev = None
    for lvl in range(from_level, to_level - 1, -1):
        runner, state0, lev, extras = from_dataset(
            dataset_dir, size, factor, level=lvl, max_fit_bins=max_fit_bins,
            progress=progress, device=device)
        if prev_final is None:
            state = mcmc.explode_genome(state0)
        else:
            soa = project_state_to_sub(prev_final, extras["pyramid"].sub_ranges(lvl + 1),
                                       np.asarray(extras["level_soa"]["len_bp"]))
            soa["id_d"] = np.arange(len(soa["pos"]))
            state = GenomeState.from_soa(soa, device=runner.device)
        final, _, metrics = runner.run(
            state, n_cycles=n_cycles, delta=delta, f_max_min=f_max_min, f_t=f_t,
            sample_param=sample_param, seed=seed + lvl, init_truth=state0, progress=progress)
        all_metrics.append({"level": lvl, **metrics,
                            "launches": {"ll_mini": runner.mini_grid.n_launches,
                                         "obsgrid": runner.obs_grid.n_launches}})
        prev_final = final
    return prev_final, runner, lev, all_metrics
