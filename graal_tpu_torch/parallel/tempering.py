"""Parallel-tempered multi-chain assembly, the chains batched on one device.

PyTorch counterpart of ``graal_tpu.parallel.tempering``. N chains each run
a full EM cycle at their own temperature; adjacent-temperature pairs swap
states with the Metropolis probability

    min(1, exp((1/T_i - 1/T_j) * (L_j - L_i)))

alternating even / odd pairings each round (canonical parallel
tempering); an optional final consolidation broadcasts the best chain.

Where the JAX package vmaps the EM step over chains, the chains here are
a leading axis of every tensor of the one EM step, ``core.mcmc.make_em_step``:
it draws the neighbours and score slots of all chains at once (each chain
as it would alone) and scores the candidates of all chains in one scorer
call a step, B = chains x slots. Given a ``parallel.sharding.Mesh`` (the
JAX package's ``mesh=``) the chains split over its chains axis: each rank
steps its share batched and the ensemble is gathered after the cycle. A
cycle is a scan of steps (:mod:`graal_tpu_torch.core.graphs`: a captured
CUDA graph on the card); the swaps run between cycles.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from graal_tpu_torch.core import graphs, mcmc
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.parallel.sharding import gather_chains


def temperature_ladder(n_chains: int, t_min: float = 1.0, t_max: float = 4.0) -> np.ndarray:
    """Geometric ladder; chain 0 is the cold chain."""
    if n_chains == 1:
        return np.asarray([t_min], np.float32)
    return np.asarray(t_min * (t_max / t_min) ** (np.arange(n_chains) / (n_chains - 1)),
                      np.float32)


class ChainDraws(NamedTuple):
    """The random inputs of one step of every chain (leading axis chains);
    a further leading axis holds the steps of a cycle."""

    u_nb: torch.Tensor     # (..., C, n_top) uniforms of the Gumbel top-k
    gumbel: torch.Tensor   # (..., C, n_slots) Gumbel noise of the slot draw


def draw_chain_inputs(gen: torch.Generator, nb: mcmc.NeighbourTable, delta: int,
                      n_chains: int, shape=()) -> ChainDraws:
    d = mcmc.draw_step_inputs(gen, nb, delta, tuple(shape) + (n_chains,))
    return ChainDraws(d.u_nb, d.gumbel)


def make_tempered_cycle(table, obs, nb: mcmc.NeighbourTable, delta: int, scorer=None,
                        mesh=None, capture=None):
    """Build cycle(states, rng, params, frag_orders, l_ts, f_ts) ->
    (states, l_ts, n_contigs), chains on the leading axis of every
    argument (``frag_orders`` (C, steps)); ``rng`` is a Generator or
    :class:`ChainDraws` with leading axes (steps, C). Each step is
    :func:`core.mcmc.make_em_step` on the chains axis: one scorer call
    scores every chain's candidates. With a ``mesh`` each rank steps the
    chains of its chain block (drawing the whole ensemble's inputs, so the
    split equals the one-process cycle) and the outputs are the whole
    ensemble's, gathered over the chains axis after the steps.

    The steps are a :class:`graal_tpu_torch.core.graphs.Scan` (the JAX
    package's jitted ``lax.scan``): on a CUDA table one captured graph
    replayed once a step, elsewhere the same body step by step; carry
    (states, l_ts), constants (params, f_ts), per-step inputs (the draws,
    each chain's fragment). ``capture``: as the scan takes it (False runs
    eagerly on the card)."""
    step = mcmc.make_em_step(table, obs, nb, delta, scorer=scorer)

    def body(carry, consts, x):
        states, l_ts = carry
        params, f_ts = consts
        draws, f_a = x
        states, (score, _, _) = step(states, draws, params, f_a, f_ts)
        tail = mcmc.step_tail(l_ts, score, state=states)   # l_ts and the contig counts
        return (states, tail.l_t), tail.n_contigs

    scan = graphs.Scan(body, table.owner.device, capture=capture)

    def cycle(states: GenomeState, rng, params, frag_orders, l_ts, f_ts):
        dev = states.pos.device
        frag_orders = torch.as_tensor(frag_orders, device=dev).long()
        c, n_steps = frag_orders.shape
        f_ts = torch.as_tensor(f_ts, dtype=torch.float32, device=dev)
        if isinstance(rng, torch.Generator):
            rng = draw_chain_inputs(rng, nb, delta, c, (n_steps,))
        lo, hi = (0, c) if mesh is None else mesh.chain_span(c)
        (states, l_ts), ncs = scan(
            (GenomeState(*[x[lo:hi] for x in states]), l_ts[lo:hi]), (params, f_ts[lo:hi]),
            (ChainDraws(*[x[:, lo:hi] for x in rng]), frag_orders[lo:hi].T))
        out = (states, l_ts, ncs[-1])
        return out if mesh is None else gather_chains(out, c, mesh)

    cycle.scan = scan
    return cycle


def _gather(tree, src):
    """``x[src]`` of every tensor of a tensor, a named tuple or a plain
    tuple of them (nested)."""
    if isinstance(tree, torch.Tensor):
        return tree[src]
    items = [_gather(x, src) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def exchange_best(states, l_ts):
    """Broadcast the best chain's genome to all chains (the final
    consolidation; the mid-run exchange is :func:`pt_swap`)."""
    src = torch.argmax(l_ts).expand(l_ts.shape[0])
    return _gather(states, src), l_ts[src]


def pt_swap(states, l_ts, ladder, u, parity: int):
    """One round of adjacent-pair replica-exchange swaps.

    Pairs (i, i+1) with i % 2 == parity exchange states with probability
    exp((beta_i - beta_{i+1}) (L_{i+1} - L_i)), tested against the
    uniforms ``u`` ((n_chains - 1,), or a Generator to draw them).
    Temperatures stay with the chain slots; states and their likelihoods
    move. ``states`` may be any tuple of chain-leading tensors (a
    GenomeState, or (states, per-chain params)).

    Returns (states, l_ts, accept (n_chains - 1,))."""
    n = l_ts.shape[0]
    dev = l_ts.device
    if isinstance(u, torch.Generator):
        u = torch.rand(n - 1, generator=u, device=dev)
    idx = torch.arange(n, device=dev)
    ladder = torch.as_tensor(ladder, dtype=torch.float32, device=dev)
    beta = 1.0 / ladder
    log_ratio = (beta[:-1] - beta[1:]) * (l_ts[1:] - l_ts[:-1])
    accept = (torch.log(u) < log_ratio) & (idx[:-1] % 2 == parity)
    acc_lo = torch.cat([accept, torch.zeros(1, dtype=torch.bool, device=dev)])
    acc_hi = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), accept])
    src = torch.where(acc_lo, idx + 1, torch.where(acc_hi, idx - 1, idx))
    return _gather(states, src), l_ts[src], accept


def run_tempered(table, obs, nb: mcmc.NeighbourTable, state0: GenomeState, params,
                 n_chains: int, n_cycles: int, delta: int = 4, t_max: float = 4.0,
                 exchange_every: int = 1, seed: int = 1, scorer=None,
                 consolidate: bool = True, progress=True, mesh=None):
    """A tempered run from one start genome: per-cycle replica-exchange
    swaps, optional final best-genome consolidation. Randomness comes from
    one ``torch.Generator`` seeded with ``seed`` on the genome's device.
    Returns (cold state, cold likelihood (0-d tensor), metrics) with every
    chain's likelihood per cycle (``trace``), the swap counts and the
    contig counts, and every chain's final state before the consolidation
    (``chain_states``, (C, n)). ``mesh``: split the chains over the ranks
    of a ``parallel.sharding.Mesh`` (every rank holds the whole ensemble
    between cycles, so the swaps are computed alike on every rank)."""
    dev = state0.pos.device
    if scorer is None:   # B1 / B3 on a CUDA table
        scorer = mcmc._default_scorer(table, obs, torch.float32)
    cycle = make_tempered_cycle(table, obs, nb, delta, scorer=scorer, mesh=mesh)
    n = state0.n_frags
    states = GenomeState(*[x.expand(n_chains, n).clone() for x in state0])
    l0 = scorer(GenomeState(*[x[None] for x in state0]), params)[0]
    l_ts = l0.expand(n_chains).clone()
    ladder = torch.as_tensor(temperature_ladder(n_chains, t_max=t_max), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    trace, swap_counts, contig_trace = [], [], []
    t0 = time.time()
    for j in range(n_cycles):
        orders = torch.stack([torch.randperm(n, generator=gen, device=dev)
                              for _ in range(n_chains)])
        states, l_ts, ncs = cycle(states, gen, params, orders, l_ts, ladder)
        n_swaps = 0
        if exchange_every and (j + 1) % exchange_every == 0 and n_chains > 1:
            states, l_ts, acc = pt_swap(states, l_ts, ladder, gen, parity=j % 2)
            n_swaps = int(acc.sum())
        trace.append(l_ts.cpu().numpy().copy())
        swap_counts.append(n_swaps)
        contig_trace.append(ncs.cpu().numpy().copy())
        if progress:
            print(f"tempered cycle {j}: best={float(trace[-1].max()):.1f} "
                  f"cold={float(trace[-1][0]):.1f} swaps={n_swaps} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    metrics = {"trace": np.asarray(trace), "swaps": swap_counts,
               "n_contigs": np.asarray(contig_trace), "chain_states": states}
    if consolidate and n_chains > 1:
        states, l_ts = exchange_best(states, l_ts)
    return GenomeState(*[x[0] for x in states]), l_ts[0], metrics
