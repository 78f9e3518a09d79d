"""Batched dense candidate scorer: a hand-written CUDA kernel for Hopper.

The port of the Pallas candidate scorer ``make_pallas_scorer``
(``_ll_kernel`` / ``_tile_body``, graal_tpu/ops/likelihood_pallas.py):
score a batch of candidate genomes against the observed contact matrix,
with the same log-space Rippe math and the genome-independent
``-sum log(ob!)`` folded into a host constant. The kernel source is
``graal_tpu_torch/csrc/ll_dense.cu``; its header comment says what bounds
it on the card and how the design answers that.

Build: at first use, ``nvcc`` compiles the source for ``sm_90a`` and it is
loaded with ``ctypes`` (:mod:`graal_tpu_torch.ops.build`). A missing
``nvcc`` or a failed build raises. The kernel's persistent grid is sized
once per process (:mod:`graal_tpu_torch.ops.persistent`); each launch plans
its candidate chunk from the shapes alone. A scorer computes once what does
not depend on the genome: the accumulation factors and the pure-trans sums
of every half tile (:func:`trans_constants`).

Dispatch: :func:`make_dense_scorer` returns a :class:`DenseScorer` for a
repeat-free table and the copy-summing
:class:`graal_tpu_torch.ops.repeat_cuda.RepeatScorer` for a repeat table.
On CUDA tensors a scorer launches its kernel (or raises); on CPU tensors
it runs its plain version (here :func:`score_dense_plain`, the same
per-cell math in plain torch).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable
from graal_tpu_torch.ops import build, persistent
from graal_tpu_torch.ops.counts import Counted, LaunchCount
from graal_tpu_torch.ops.vectors_cuda import VECTORS, SubRows

N_PARAMS = 10
ROWS = persistent.TILE // persistent.HALVES   # rows of a half tile


def obs_constant(obs) -> float:
    """Setup-time constant: -sum_{s<t} log(ob!) with the reference's branch
    structure (exact factorial < 10, Stirling >= 10, Stirling expansion
    >= 15), in f64."""
    obs = np.asarray(obs, np.float64)
    iu, ju = np.triu_indices(obs.shape[0], k=1)
    ob = obs[iu, ju]
    out = np.zeros_like(ob)
    big = ob >= 15
    out[big] = -(ob[big] * np.log(ob[big]) - ob[big]
                 + np.log(np.sqrt(ob[big] * 2 * np.pi)))
    mid = (ob >= 10) & ~big
    n = np.floor(ob[mid])
    out[mid] = -(n * np.log(n) - n + 0.5 * np.log(2 * np.pi * n))
    small = (ob > 0) & (ob < 10)
    out[small] = -np.array([math.lgamma(math.floor(x) + 1) for x in ob[small]])
    return float(out.sum())


def band_tiles(n_rb: int):
    """The upper-triangle tiles (bi, bj) of an n_rb x n_rb tile grid in the
    kernel's order (``band_coords``): by diagonal offset bj - bi, then by
    row."""
    return [(i, i + d) for d in range(n_rb) for i in range(n_rb - d)]


def trans_constants(obs, accu, nfpb: float) -> np.ndarray:
    """The pure-trans sums of every half tile, (n_tiles(K) * SLOTS, 3) f64,
    in the kernel's slot order (tile * SLOTS + half, tiles as
    :func:`band_tiles` orders them): over the cells s < t < K of the half
    tile, [sum ob, sum ob (la_s + la_t - log nfpb), sum accu_s accu_t /
    nfpb], summed in f64 as ``make_pallas_scorer`` sums its per-tile ``tc``
    (likelihood_pallas.py:232-254). A half tile with no same-contig pair
    then contributes log_v tc0 + tc1 - v_inter tc2."""
    obs = host_obs(obs)
    k = obs.shape[0]
    tile = persistent.TILE
    n_rb = -(-k // tile)
    kp = n_rb * tile
    acc = np.zeros(kp, np.float64)
    acc[:k] = np.asarray(accu, np.float64)
    la = np.zeros(kp, np.float64)
    la[:k] = np.log(acc[:k])
    cols = np.arange(kp)
    sums = np.zeros((n_rb, persistent.HALVES, n_rb, 3))   # (bi, half, bj, term)
    for bi in range(n_rb):
        for half in range(persistent.HALVES):
            i0 = bi * tile + half * ROWS
            rows = np.arange(i0, i0 + ROWS)
            ob = np.zeros((ROWS, kp), np.float64)
            nr = max(0, min(ROWS, k - i0))
            ob[:nr, :k] = obs[i0:i0 + nr]
            m = (cols[None, :] > rows[:, None]) & (rows < k)[:, None] & (cols < k)[None, :]
            lap = la[rows][:, None] + la[None, :] - np.log(nfpb)
            prod = acc[rows][:, None] * acc[None, :] / nfpb
            for term, x in enumerate((ob * m, ob * np.where(m, lap, 0.0), prod * m)):
                sums[bi, half, :, term] = x.reshape(ROWS, n_rb, tile).sum(axis=(0, 2))
    return np.concatenate([sums[bi, :, bj] for bi, bj in band_tiles(n_rb)])


@functools.cache
def load_library():
    """The kernel library (built at first use), its C functions typed."""
    lib = build.load("ll_dense")
    ptr = ctypes.c_void_p
    for fn, args in ((lib.ll_dense_n_tiles, [ctypes.c_int]), (lib.ll_dense_slots, []),
                     (lib.ll_dense_max_chunk, []),
                     (lib.ll_dense_configure, [ctypes.POINTER(ctypes.c_int)])):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.ll_dense_score.argtypes = [ptr] * 13 + [ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                                ctypes.c_int, ctypes.c_int, ptr]
    lib.ll_dense_score.restype = ctypes.c_int
    if lib.ll_dense_slots() != persistent.SLOTS:
        raise RuntimeError("ll_dense.cu and ops/persistent.py disagree on SLOTS")
    return lib


@functools.cache
def resident_blocks(device) -> int:
    """Persistent blocks of the kernel on ``device``, asked once per process."""
    return persistent.resident_blocks(load_library().ll_dense_configure, device)


def params_vector(p: RippeParams, log_nfpb: torch.Tensor) -> torch.Tensor:
    """The kernel's 10 f32 parameters, computed on the device: [log_c1fact,
    slope, d, d_max, lm/kuhn, log_v_inter, v_inter, log_norm_circ,
    log_k3fact, log_nfpb]. Parameters with a leading shape (one set per
    chain) give one row per set, (..., 10)."""
    log_c1fact = torch.log(p.c1 * p.fact)
    log_k3fact = torch.log(torch.pow(p.kuhn, -3.0) * p.fact)
    nmax = p.lm / p.kuhn
    log_norm_circ = (log_k3fact + p.slope * torch.log(nmax)
                     + (p.d - 2.0) / (nmax * nmax + p.d))
    return torch.stack(torch.broadcast_tensors(
        log_c1fact, p.slope, p.d, p.d_max, p.lm / p.kuhn,
        torch.log(p.v_inter), p.v_inter, log_norm_circ, log_k3fact,
        log_nfpb), dim=-1).float()


def score_dense_plain(mid, idc, circ, stot, la, obs, pvec, obs_const,
                      max_cells=1 << 24):
    """Plain torch version of the kernel: the same per-cell math over the
    full K x K grid, masked to s < t, each candidate's sum taken in f64.
    Candidates are processed in chunks of about ``max_cells`` cells so that
    memory stays bounded at K ~ 6,000. Returns (B,) f32."""
    B, K = mid.shape
    (log_c1fact, slope, d, d_max, lmk, log_v, _v_inter, log_norm_circ,
     log_k3fact, log_nfpb) = pvec.unbind()
    mask = torch.ones((K, K), dtype=torch.bool, device=mid.device).triu(1)
    la_pair = (la[:, None] + la[None, :]) - log_nfpb
    chunk = max(1, max_cells // (K * K))
    out = []
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        s = torch.abs(mid[sl, :, None] - mid[sl, None, :])
        same = idc[sl, :, None] == idc[sl, None, :]
        safe_s = torch.clamp_min(s, 1e-9)
        n_lin = safe_s * lmk
        log_lin = log_c1fact + slope * torch.log(safe_s) + (d - 2.0) / (n_lin * n_lin + d)
        in_range = (s > 0.0) & (s < d_max)
        st = stot[sl, :, None]
        n_circ = lmk * safe_s * torch.clamp_min(st - s, 1e-9) / torch.clamp_min(st, 1e-9)
        log_val_circ = log_k3fact + slope * torch.log(n_circ) + (d - 2.0) / (n_circ * n_circ + d)
        log_norm_lin = torch.where(in_range, torch.maximum(log_lin, log_v), log_v)
        log_circ = log_val_circ + log_norm_lin - log_norm_circ
        log_cis = torch.where(circ[sl, :, None] == 1, log_circ, log_lin)
        log_cis = torch.where(in_range, log_cis, -math.inf)
        log_cis = torch.maximum(log_cis, log_v)
        log_e = torch.where(same, log_cis, log_v) + la_pair
        contrib = obs * log_e - torch.exp(log_e)
        out.append(torch.where(mask, contrib, 0.0).sum(dim=(1, 2), dtype=torch.float64))
    return (torch.cat(out) + obs_const).float()


def scorer_device(device) -> torch.device:
    """``device`` with a CUDA index filled in (the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def host_obs(obs) -> np.ndarray:
    """The observed matrix as a host f32 array."""
    if isinstance(obs, torch.Tensor):
        obs = obs.detach().cpu().numpy()
    return np.asarray(obs, np.float32)


def check_states(states: GenomeState, device):
    """Raise ValueError unless every field of ``states`` is a (B, n) int32
    tensor on ``device``."""
    for name, x in zip(states._fields, states):
        if x.device != device:
            raise ValueError(f"state field {name} on {x.device}, scorer on {device}")
        if x.dtype != torch.int32 or x.dim() != 2:
            raise ValueError(f"state field {name} must be (B, n) int32, "
                             f"got {tuple(x.shape)} {x.dtype}")


class CopyRowScorer(Counted):
    """What the dense scorers share: per-candidate vectors of the table's
    sub rows (in the order ``rows``, default table order), the checks of a
    kernel launch's arguments, and the dispatch of ``score(states (B, n),
    params) -> (B,) f32``: on a CUDA scorer :meth:`launch`, on a CPU one
    :meth:`plain`, both over the vectors and parameter row :meth:`vectors`
    returns (on a card kernel H1, ``ops.vectors_cuda``; on the CPU
    :meth:`vectors_plain` and :func:`params_vector`).

    ``n_launches`` counts the kernel's launches, and ``launch_shapes`` the
    same launches by their (B, K), on the card (``ops.counts``).
    """

    VECTORS = ("mid", "idc", "circ", "stot")

    def __init__(self, table: SubFragTable, obs, device, rows=None):
        device = scorer_device(device)
        self.table = table
        self.device = device
        self.obs = torch.as_tensor(host_obs(obs), device=device).contiguous()
        self.k = table.n_subs
        rows = torch.arange(self.k) if rows is None else torch.as_tensor(rows)
        rows = rows.to(device)
        self.owner = table.owner.to(device).long()[rows]
        self.prefix = table.prefix_kb.to(device)[rows]
        self.suffix = table.suffix_kb.to(device)[rows]
        self.len_half = table.len_kb.to(device)[rows] * 0.5
        self.log_nfpb = torch.tensor(np.float32(np.log(table.n_frags_per_bins)),
                                     device=device)
        self.launches = LaunchCount()
        self.accu_rows = None   # B3's copy-order accu: its `a` column

    @property
    def launch_shapes(self):
        return self.launches.by_key()

    def geometry(self, states: GenomeState):
        """Per-candidate O(K) vectors (mid, idc, circ, stot), shape (B, K)."""
        own = self.owner
        start_kb = states.start_bp[:, own].float() / 1000.0
        ori = states.ori[:, own]
        mid = start_kb + torch.where(ori == 1, self.prefix, self.suffix) + self.len_half
        idc = states.id_c[:, own]
        circ = states.circ[:, own].float()
        stot = states.l_cont_bp[:, own].float() / 1000.0
        return mid, idc, circ, stot

    def vectors_plain(self, states: GenomeState):
        """The plain version of H1's vectors (named by ``VECTORS``)."""
        return self.geometry(states)

    @functools.cached_property
    def sub_rows(self) -> SubRows:
        """The per-sub-row vectors H1 reads (int32 owner), made once."""
        return SubRows(self.owner.int().contiguous(), self.prefix.contiguous(),
                       self.suffix.contiguous(), self.len_half.contiguous(),
                       None if self.accu_rows is None else self.accu_rows.contiguous())

    def vectors(self, states: GenomeState, params: RippeParams | None = None):
        """(the vectors named by ``VECTORS``, each (B, K); the parameter row
        of ``params``, or None without them): on a card one H1 launch
        (``ops.vectors_cuda.VECTORS``, no fallback), on the CPU
        :meth:`vectors_plain` and :func:`params_vector`."""
        if self.device.type == "cuda":
            return self._vectors_on_card(states, params)
        return (self.vectors_plain(states),
                None if params is None else params_vector(params, self.log_nfpb))

    def _vectors_on_card(self, states: GenomeState, params: RippeParams | None = None):
        return VECTORS(states, self.sub_rows, params, None if params is None else self.log_nfpb)

    def sub_vectors(self, states: GenomeState):
        """The vectors of :meth:`vectors`, without a row."""
        return self.vectors(states)[0]

    def check_launch(self, vecs, pvec) -> int:
        """Raise ValueError unless this scorer lies on a card and ``vecs``
        (named by ``VECTORS``) and ``pvec`` are what its kernel reads;
        returns B."""
        if self.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs a CUDA scorer, not {self.device}")
        B, K = vecs[0].shape
        if K != self.k:
            raise ValueError(f"vectors have K={K}, table has K={self.k}")
        named = list(zip(self.VECTORS, vecs)) + [("pvec", pvec)]
        for name, x in named:
            dt = torch.int32 if name == "idc" else torch.float32
            if x.device != self.device or x.dtype != dt or not x.is_contiguous():
                raise ValueError(f"{name}: need contiguous {dt} on {self.device}, "
                                 f"got {x.dtype} on {x.device}")
            if name != "pvec" and tuple(x.shape) != (B, K):
                raise ValueError(f"{name}: need shape {(B, K)}, got {tuple(x.shape)}")
        if pvec.shape != (N_PARAMS,):
            raise ValueError(f"pvec: need shape ({N_PARAMS},), got {tuple(pvec.shape)}")
        return B

    def __call__(self, states: GenomeState, params: RippeParams, pvec=None) -> torch.Tensor:
        """``pvec``: the kernel's parameter row of ``params`` when the caller
        has it (the nuisance proposal writes it, ``core.mcmc``); else
        :meth:`vectors` computes it with the vectors."""
        check_states(states, self.device)
        vecs, row = self.vectors(states, params if pvec is None else None)
        if pvec is None:
            pvec = row
        if self.device.type == "cuda":
            return self.launch(*vecs, pvec)
        return self.plain(*vecs, pvec)


class DenseScorer(CopyRowScorer):
    """``score(states (B, n), params) -> (B,) f32`` log-likelihoods of a
    repeat-free table, the counterpart of ``make_pallas_scorer``. A repeat
    table raises ValueError: its scorer is ``RepeatScorer``, which
    :func:`make_dense_scorer` picks.
    """

    def __init__(self, table: SubFragTable, obs, device):
        if table.has_repeats:
            raise ValueError("a repeat table needs the copy-summing scorer "
                             "(ops.repeat_cuda.RepeatScorer)")
        obs = host_obs(obs)
        super().__init__(table, obs, device)
        self.obs_const = obs_constant(obs)
        accu = table.accu.to(self.device)
        self.la = torch.log(accu).contiguous()
        # the kernel's genome-independent factors: a trans cell's E is
        # (v_inter accu_u / nfpb) accu_v, and a half tile with no
        # same-contig pair is the affine form over its sums tc
        self.ra = torch.exp(self.la - self.log_nfpb).contiguous()
        self.accu = torch.exp(self.la).contiguous()
        self.tc = torch.as_tensor(trans_constants(obs, table.accu.cpu().numpy(),
                                                  float(table.n_frags_per_bins)),
                                  device=self.device)
        self.tickets = persistent.Tickets()

    def launch(self, mid, idc, circ, stot, pvec) -> torch.Tensor:
        """Launch the kernel on the vectors of B candidates; (B,) f32."""
        B = self.check_launch((mid, idc, circ, stot), pvec)
        lib = load_library()
        n_tri = lib.ll_dense_n_tiles(self.k)
        cs, grid, _ = persistent.plan(n_tri, B, 1, resident_blocks(self.device),
                                      lib.ll_dense_max_chunk())
        stream = torch.cuda.current_stream(self.device).cuda_stream
        partial = torch.empty((B, n_tri * persistent.SLOTS), dtype=torch.float32,
                              device=self.device)
        out = torch.empty(B, dtype=torch.float32, device=self.device)
        rc = lib.ll_dense_score(
            mid.data_ptr(), idc.data_ptr(), circ.data_ptr(), stot.data_ptr(),
            self.la.data_ptr(), self.ra.data_ptr(), self.accu.data_ptr(), self.tc.data_ptr(),
            self.obs.data_ptr(), pvec.data_ptr(), partial.data_ptr(), out.data_ptr(),
            self.tickets.get(self.device, stream).data_ptr(), B, self.k, self.obs_const, cs,
            grid, stream)
        if rc != 0:
            raise RuntimeError(f"ll_dense_score launch failed: cudaError {rc}")
        self.launches.add(self.device, (B, self.k))
        return out

    def plain(self, mid, idc, circ, stot, pvec) -> torch.Tensor:
        """The plain torch version on the same vectors; (B,) f32."""
        return score_dense_plain(mid, idc, circ, stot, self.la, self.obs,
                                 pvec, self.obs_const)


def make_dense_scorer(table: SubFragTable, obs, device):
    """Build ``score(states_batch, params) -> (B,)`` on ``device``: a
    :class:`DenseScorer`, or for a repeat table the copy-summing
    ``RepeatScorer`` (kernel B3), as ``make_pallas_scorer`` dispatches."""
    if table.has_repeats:
        from graal_tpu_torch.ops.repeat_cuda import RepeatScorer

        return RepeatScorer(table, obs, device)
    return DenseScorer(table, obs, device)
