"""Multi-device scale-out on ``torch.distributed``: a (chains, rows) mesh
of ranks, the row-sharded likelihood, chains over ranks, the sharded
sparse anchor.

PyTorch counterpart of ``graal_tpu.parallel.sharding``. The reference is
single-GPU; its author marked the fan-out point in the per-neighbour loop
(cuda_lib_gl.py:1886). The decomposition is the JAX package's:

- ``rows``: the pair grid of the likelihood is split by data rows; every
  rank of a rows group scores every candidate on its row block and the
  partial sums are all-reduced over the group. Sampling decisions are
  computed redundantly within the group (they are O(candidates), the grid
  O(K^2)).
- ``chains``: independent (tempered) chains split over the chains groups,
  each rank running its share of the chains batched on its device.

A :class:`Mesh` lays the ranks of the default process group out as
(chains, rows): rank = chain_block * n_rows + row_block. Each rank runs on
the device of the tensors it is given (``cuda:LOCAL_RANK`` under a
launcher, the CPU when asked: :func:`init_from_env`). Every collective is an ``all_reduce`` (sums of partials, and the
gathering of every chain block into the whole ensemble through a
zero-padded buffer) or a ``broadcast``, so NCCL and gloo, on CPU or CUDA
tensors, all carry them. The functions take and return the whole
ensemble (leading axis of all chains) on every rank, as the JAX package's
``shard_map``-ed functions take and return global arrays; every rank draws
the whole ensemble's random inputs from an identically seeded generator
and keeps its chains' share, so the chains split over ranks equal the
chains batched in one process bit for bit.

Without a process group (no launcher) the world is one rank and every
collective is the identity: the one-device path.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from graal_tpu_torch.core import mcmc
from graal_tpu_torch.core.model import poisson_loglik, rippe_contacts, rippe_contacts_circ
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_writer() -> bool:
    """True on the rank that writes a run's outputs (rank 0)."""
    return rank() == 0


def init_from_env(device: str = "cuda") -> torch.device:
    """Join the process group a launcher describes (``torchrun``: the
    environment's ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``), NCCL on the card, gloo on the CPU. Returns the rank's
    device: ``cuda:LOCAL_RANK``, or the CPU when ``device`` asks for it.
    Without a launcher's environment nothing is joined and ``device`` is
    returned as it is."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return torch.device(device)
    cpu = torch.device(device).type == "cpu"
    dist.init_process_group("gloo" if cpu else "nccl")
    if cpu:
        return torch.device("cpu")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(dev)
    return dev


class Mesh:
    """(chains, rows) layout of the default process group's ranks, with one
    process group per rows group (the ranks of one chain block) and per
    chains group (the ranks of one row block). Every rank must build the
    same meshes in the same order (``dist.new_group`` is collective).
    Without a process group the mesh is 1 x 1 and its groups are None."""

    def __init__(self, n_chains: int, n_rows: int):
        world = world_size()
        if n_chains * n_rows != world:
            raise ValueError(f"{n_chains} x {n_rows} != {world} ranks")
        self.shape = {"chains": n_chains, "rows": n_rows}
        self.rank = rank()
        self.chain_index, self.row_index = divmod(self.rank, n_rows)
        self.rows_group = self.chains_group = None
        if dist.is_available() and dist.is_initialized():
            for c in range(n_chains):
                g = dist.new_group([c * n_rows + r for r in range(n_rows)])
                if c == self.chain_index:
                    self.rows_group = g
            for r in range(n_rows):
                g = dist.new_group([c * n_rows + r for c in range(n_chains)])
                if r == self.row_index:
                    self.chains_group = g

    def chain_span(self, n_chains: int) -> tuple[int, int]:
        """The chains [lo, hi) of this rank's chain block."""
        n_blocks = self.shape["chains"]
        if n_chains % n_blocks:
            raise ValueError(f"{n_chains} chains do not split over {n_blocks} chain blocks")
        per = n_chains // n_blocks
        return self.chain_index * per, (self.chain_index + 1) * per


def make_mesh(n_chains: int = 1, n_rows: int | None = None) -> Mesh:
    """A (chains, rows) mesh over the ranks of the default process group
    (one rank without one)."""
    world = world_size()
    if n_rows is None:
        n_rows = world // n_chains
    return Mesh(n_chains, n_rows)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (in place; the identity without one)."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def gather_chains(local, n_chains: int, mesh: Mesh):
    """Every chain block's rows of ``local`` (a tensor or a tuple of tensors
    with the block's chains leading) as the whole ensemble's (n_chains,
    ...), on every rank: each block writes its rows into a zero buffer and
    the buffers are all-reduced over the chains group (adding zeros is
    exact). Bool tensors travel as int32."""
    if not isinstance(local, torch.Tensor):
        return _rebuild(local, [gather_chains(x, n_chains, mesh) for x in local])
    if mesh.chains_group is None:
        return local
    lo, hi = mesh.chain_span(n_chains)
    dt = torch.int32 if local.dtype == torch.bool else local.dtype
    buf = torch.zeros((n_chains,) + tuple(local.shape[1:]), dtype=dt, device=local.device)
    buf[lo:hi] = local
    all_reduce_sum(buf, mesh.chains_group)
    return buf.bool() if local.dtype == torch.bool else buf


def _local(x, lo: int, hi: int):
    """Rows [lo, hi) of a chain-leading tensor or tuple; 0-d tensors and
    floats (shared across chains) pass through."""
    if isinstance(x, torch.Tensor):
        return x[lo:hi] if x.dim() else x
    if isinstance(x, tuple):
        return _rebuild(x, [_local(y, lo, hi) for y in x])
    return x


def _rebuild(like: tuple, items: list):
    """A tuple of ``like``'s type (named or plain) holding ``items``."""
    return type(like)(*items) if hasattr(like, "_fields") else type(like)(items)


def _pad_rows(obs: np.ndarray, n_rows: int):
    """Pad the observed matrix's rows to a multiple of the rows axis."""
    s = obs.shape[0]
    pad = (-s) % n_rows
    if pad:
        obs = np.pad(obs, ((0, pad), (0, 0)))
    return obs, s + pad


def _copy_tables(table: SubFragTable):
    """(S, mc) copy-slot index / valid tables of the data grid (the
    dispatcher's spans), on the table's device."""
    data_id = table.data_id.cpu().numpy()
    s = table.n_data_sub
    order = np.argsort(data_id, kind="stable")
    counts = np.bincount(data_id, minlength=s)
    mc = int(counts.max()) if len(counts) else 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slots = np.full((s, mc), -1, np.int64)
    pos = np.arange(len(order)) - starts[data_id[order]]
    slots[data_id[order], pos] = order
    dev = table.owner.device
    return (torch.as_tensor(np.where(slots < 0, 0, slots), device=dev),
            torch.as_tensor(slots >= 0, device=dev), mc)


def _geometry(states: GenomeState, table: SubFragTable):
    own = table.owner.long()
    mid = states.start_bp[:, own].float() / 1000.0 \
        + torch.where(states.ori[:, own] == 1, table.prefix_kb, table.suffix_kb) \
        + table.len_kb * 0.5
    return own, mid


def _block_log_likelihood_repeats(states: GenomeState, table: SubFragTable, obs_block,
                                  params, row_start: int, copy_tabs):
    """Repeat-aware row block on the DATA grid: expected counts summed over
    active copy pairs before the pmf (kernels3.cu:2895-2929). (B,) f64."""
    slots, valid, mc = copy_tabs
    b = obs_block.shape[0]
    s_dim = table.n_data_sub
    own, mid = _geometry(states, table)
    dev = mid.device
    idc = states.id_c[:, own]
    act = states.activ[:, own] == 1
    circ = states.circ[:, own]
    stot = states.l_cont_bp[:, own].float() / 1000.0
    accu = table.accu
    nfpb = float(np.float32(table.n_frags_per_bins))
    rows = (row_start + torch.arange(b, device=dev)).clamp(0, s_dim - 1)
    e_total = torch.zeros((states.pos.shape[0], b, s_dim), dtype=torch.float32, device=dev)
    for a in range(mc):
        u = slots[rows, a]
        uv = valid[rows, a]
        for b2 in range(mc):
            v = slots[:, b2]
            vv = valid[:, b2]
            s = torch.abs(mid[:, u][:, :, None] - mid[:, v][:, None, :])
            same = idc[:, u][:, :, None] == idc[:, v][:, None, :]
            na = accu[u][:, None] * accu[v][None, :] / nfpb
            cis = torch.where((circ[:, u] == 1)[:, :, None],
                              rippe_contacts_circ(s, stot[:, u][:, :, None], params),
                              rippe_contacts(s, params))
            e = torch.where(same, cis, params.v_inter) * na
            ok = (uv & act[:, u])[:, :, None] & (vv & act[:, v])[:, None, :]
            e_total = e_total + torch.where(ok, e, 0.0)
    ll = poisson_loglik(e_total, obs_block)
    col = torch.arange(s_dim, device=dev)[None, :]
    grow = (row_start + torch.arange(b, device=dev))[:, None]
    mask = (col > grow) & (grow < s_dim)
    return torch.where(mask, ll, 0.0).sum(dim=(1, 2), dtype=torch.float64)


def _block_log_likelihood(state: GenomeState, table: SubFragTable, obs_block, params,
                          row_start: int, copy_tabs=None):
    """Log-likelihood restricted to data rows [row_start, row_start + B),
    the strict upper triangle taken in global coordinates, summed in f64.
    ``state`` is one genome (-> 0-d) or a batch (fields (B, n) -> (B,));
    params are shared. Repeat-carrying tables use the copy-summing
    data-grid form. The whole grid is ``row_start = 0`` with every row."""
    single = state.pos.dim() == 1
    states = GenomeState(*[x[None] for x in state]) if single else state
    if table.has_repeats:
        out = _block_log_likelihood_repeats(states, table, obs_block, params, row_start,
                                            copy_tabs or _copy_tables(table))
        return out[0] if single else out
    b = obs_block.shape[0]
    k = table.n_subs
    own, mid = _geometry(states, table)
    dev = mid.device
    nfpb = float(np.float32(table.n_frags_per_bins))
    rows = (row_start + torch.arange(b, device=dev)).clamp(0, k - 1)
    own_r = own[rows]
    s = torch.abs(mid[:, rows][:, :, None] - mid[:, None, :])
    same = states.id_c[:, own_r][:, :, None] == states.id_c[:, own][:, None, :]
    act = (states.activ[:, own_r] == 1)[:, :, None] & (states.activ[:, own] == 1)[:, None, :]
    norm_accu = table.accu[rows][:, None] * table.accu[None, :] / nfpb
    s_tot = states.l_cont_bp[:, own_r].float()[:, :, None] / 1000.0
    cis = torch.where((states.circ[:, own_r] == 1)[:, :, None],
                      rippe_contacts_circ(s, s_tot, params), rippe_contacts(s, params))
    e = torch.where(same, cis, params.v_inter) * norm_accu
    e = torch.where(act, e, 0.0)
    ll = poisson_loglik(e, obs_block)
    col = torch.arange(k, device=dev)[None, :]
    grow = (row_start + torch.arange(b, device=dev))[:, None]
    mask = (col > grow) & (grow < k)
    out = torch.where(mask, ll, 0.0).sum(dim=(1, 2), dtype=torch.float64)
    return out[0] if single else out


def _row_block(mesh: Mesh, table: SubFragTable, obs):
    """This rank's (row_start, obs rows block on its device, copy tables)."""
    n_rows = mesh.shape["rows"]
    obs_p, total = _pad_rows(np.asarray(obs, np.float32), n_rows)
    block = total // n_rows
    row_start = mesh.row_index * block
    obs_block = torch.as_tensor(obs_p[row_start:row_start + block], device=table.owner.device)
    return row_start, obs_block, (_copy_tables(table) if table.has_repeats else None)


def sharded_log_likelihood(mesh: Mesh, table: SubFragTable, obs):
    """``fn(state, params) -> f32`` (0-d, or (B,) for a batch of genomes)
    with the pair grid's rows split over the mesh's rows axis: each rank
    sums its row block in f64 and the partials are all-reduced over its
    rows group. On a one-rank mesh this is
    ``_block_log_likelihood(state, table, obs, params, 0)`` bit for bit."""
    row_start, obs_block, copy_tabs = _row_block(mesh, table, obs)

    def fn(state: GenomeState, params):
        part = _block_log_likelihood(state, table, obs_block, params, row_start, copy_tabs)
        return all_reduce_sum(part, mesh.rows_group).float()

    return fn


def make_sharded_em_step(mesh: Mesh, table: SubFragTable, obs, nb: mcmc.NeighbourTable,
                         delta: int):
    """Sharded EM step: chains split over the chains axis, each candidate
    scored on row blocks of the pair grid all-reduced over the rows axis
    (one all-reduce a step for all of a rank's candidates), decisions
    replicated within a rows group.

    Returns ``step(states, rng, params, f_as, f_t) -> (states, (score, op,
    fb))`` over the whole ensemble (leading axis C): ``rng`` a Generator
    (every rank draws the whole ensemble's inputs from it) or draws with
    the chains axis leading (:class:`parallel.tempering.ChainDraws`);
    ``f_t`` a float or (C,). Each rank steps its chains with
    :func:`core.mcmc.make_em_step` on the chains axis."""
    from graal_tpu_torch.parallel.tempering import draw_chain_inputs

    score_all = sharded_log_likelihood(mesh, table, obs)
    step = mcmc.make_em_step(table, obs, nb, delta, scorer=score_all)

    def sharded(states: GenomeState, rng, params, f_as, f_t):
        c = states.pos.shape[0]
        lo, hi = mesh.chain_span(c)
        if isinstance(rng, torch.Generator):
            rng = draw_chain_inputs(rng, nb, delta, c)
        new, outs = step(_local(states, lo, hi), _local(rng, lo, hi), params,
                         _local(f_as, lo, hi), _local(f_t, lo, hi))
        return gather_chains(new, c, mesh), gather_chains(outs, c, mesh)

    return sharded


def make_sharded_delta_cycle(mesh: Mesh, table: SubFragTable, nb, delta: int, f_max: int,
                             obs=None, sobs=None, band_w: int | None = None,
                             per_chain_params: bool = False, obs_grid=None, mini_grid=None,
                             rep=None):
    """Chains-sharded chr1-scale cycle: each rank runs its chains through
    the chains-axis delta EM cycle (``core.delta.make_delta_em_cycle``, no
    internal re-anchor), so one B2 and one B4 launch a step serve all of a
    rank's chains; the observed map is replicated (the sparse triplets are
    O(nnz), small next to a dense grid).

    Returns ``cycle(states, rng, params, orders, l_ts, f_ts) -> (states,
    l_ts)`` over the whole ensemble: ``orders`` (C, steps); ``rng`` a
    Generator (every rank draws the whole ensemble's step inputs, as the
    one-process cycle does) or draws with leading axes (steps, C); params
    shared, or one set per chain (fields (C,)) with ``per_chain_params``;
    ``f_ts`` a float or (C,). ``rep``: a repeat table's genome repeat
    flags."""
    from graal_tpu_torch.core import delta as delta_mod
    from graal_tpu_torch.parallel.tempering import draw_chain_inputs

    cycle = delta_mod.make_delta_em_cycle(table, obs, nb, delta, f_max, sobs=sobs,
                                          anchor_fn=False, band_w=band_w, obs_grid=obs_grid,
                                          mini_grid=mini_grid, rep=rep)

    def sharded(states: GenomeState, rng, params, orders, l_ts, f_ts):
        c, n_steps = orders.shape
        lo, hi = mesh.chain_span(c)
        if isinstance(rng, torch.Generator):
            rng = draw_chain_inputs(rng, nb, delta, c, (n_steps,))
        rng = type(rng)(*[None if x is None else x[:, lo:hi] for x in rng])
        p_loc = _local(params, lo, hi) if per_chain_params else params
        st, l_loc, _ = cycle(_local(states, lo, hi), rng, p_loc, orders[lo:hi],
                             l_ts[lo:hi], _local(f_ts, lo, hi))
        return gather_chains(st, c, mesh), gather_chains(l_loc, c, mesh)

    sharded.scan = cycle.scan
    return sharded


def make_sharded_sparse_anchor(mesh: Mesh, table: SubFragTable, sobs, w: int,
                               max_cells: int = 1 << 24):
    """Rows-sharded chr1-scale sparse full-likelihood re-anchor.

    The two sums that grow with the map (``core.sparse.sparse_loglik_parts``)
    are split over the rows axis: the observed-pair sum over contiguous
    spans of the nnz entries, the banded cis correction over contiguous
    spans of the genome-sorted band left ends. The f64 partials are
    all-reduced over the rows group, then the analytic trans mass and the
    constant are added once (``finish``). Chains split over the chains
    axis. Copy-expanded (repeat) tables take the copy-summing form, whose
    activity-dependent trans mass is evaluated outside the reduction.

    Returns ``fn(states, params_b) -> (C,) f32`` over the whole ensemble
    (params shared or one set per chain). On a one-rank mesh it equals
    ``core.sparse.make_sparse_loglik``'s chains-axis result bit for bit."""
    from graal_tpu_torch.core import sparse

    n_rows, r = mesh.shape["rows"], mesh.row_index
    per_e = -(-sobs.vals.shape[0] // n_rows)
    per_k = -(-table.n_subs // n_rows)
    parts, finish = sparse.sparse_loglik_parts(
        table, sobs, w, max_cells, entries=(r * per_e, (r + 1) * per_e),
        left_ends=(r * per_k, (r + 1) * per_k))

    def fn(states: GenomeState, params_b):
        c = states.pos.shape[0]
        lo, hi = mesh.chain_span(c)
        st, p = _local(states, lo, hi), _local(params_b, lo, hi)
        red = all_reduce_sum(torch.stack(parts(st, p)), mesh.rows_group)
        return gather_chains(finish(st, p, red[0], red[1]), c, mesh)

    return fn


def chain_mesh(n_chains: int) -> Mesh:
    """The mesh of ``n_chains`` chains over the world: the largest chains
    axis that divides both the chain count and the rank count, the rest
    rows (``graal_tpu.scale._chain_mesh``); 1 x 1 on one rank."""
    n = world_size()
    ax = next(d for d in range(min(n_chains, n), 0, -1) if n_chains % d == 0 and n % d == 0)
    return make_mesh(n_chains=ax, n_rows=n // ax)
