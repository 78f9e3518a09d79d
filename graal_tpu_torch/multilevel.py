"""Hierarchical (multilevel) assembly: coarse-to-fine refinement.

PyTorch counterpart of ``graal_tpu.multilevel``. A run assembles at a
coarse pyramid level, where the genome has few bins, then refines level by
level: each coarse bin expands to its sub-bins in placement order,
orientation-aware (a reversed bin contributes its sub-bins reversed and
flipped), so the finer level starts warm instead of scrambled.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from graal_tpu_torch.config import RunConfig
from graal_tpu_torch.core.state import GenomeState, check_invariants
from graal_tpu_torch.pipeline import Runner


def project_state_to_sub(state: GenomeState, bin_to_subs: np.ndarray,
                         sub_len_bp: np.ndarray) -> dict:
    """Project an assembled level-L genome onto level L-1.

    ``bin_to_subs``: (n_bins, 2) inclusive [lo, hi] sub-bin ranges per bin
    (``Pyramid.sub_ranges``). Returns a struct-of-arrays dict for the finer
    level. Repeat copies are not projected (the genome must hold one
    fragment per bin)."""
    s = state.to_numpy()
    id_c, pos, ori, circ, id_d = s["id_c"], s["pos"], s["ori"], s["circ"], s["id_d"]
    n_bins = bin_to_subs.shape[0]
    if len(id_c) != n_bins:
        raise ValueError("multilevel projection needs one fragment per bin (no repeats)")

    n_sub = int(bin_to_subs[:, 1].max()) + 1
    sub_len_bp = np.asarray(sub_len_bp)
    out = dict(pos=np.zeros(n_sub, np.int64), id_c=np.zeros(n_sub, np.int64),
               start_bp=np.zeros(n_sub, np.int64), len_bp=sub_len_bp.copy(),
               circ=np.zeros(n_sub, np.int64), l_cont=np.zeros(n_sub, np.int64),
               l_cont_bp=np.zeros(n_sub, np.int64), ori=np.ones(n_sub, np.int64),
               rep=np.zeros(n_sub, np.int64), activ=np.ones(n_sub, np.int64),
               id_d=np.arange(n_sub, dtype=np.int64))

    for c in np.unique(id_c):
        members = np.nonzero(id_c == c)[0]
        ordered_bins = members[np.argsort(pos[members])]
        subs = []
        for b in ordered_bins:
            lo, hi = bin_to_subs[id_d[b]]
            if ori[b] == 1:
                subs.extend([(t, 1) for t in range(lo, hi + 1)])
            else:
                subs.extend([(t, -1) for t in range(hi, lo - 1, -1)])
        off = 0
        for p, (t, o) in enumerate(subs):
            out["pos"][t] = p
            out["id_c"][t] = c
            out["start_bp"][t] = off
            out["ori"][t] = o
            out["circ"][t] = circ[ordered_bins[0]]
            off += int(sub_len_bp[t])
        for t, _ in subs:
            out["l_cont"][t] = len(subs)
            out["l_cont_bp"][t] = off
    return out


def run_multilevel(cfg: RunConfig, from_level: int, to_level: int, fasta: str = "",
                   progress=True):
    """Assemble at ``from_level`` (scrambled start), then refine level by
    level down to ``to_level`` from projected warm starts, each level an EM
    run of the port's :class:`Runner` on ``cfg.device``. Returns the final
    Runner and Assembly; ``runner.levels`` lists each level's (level,
    runner, assembly, warm start or None)."""
    if not from_level >= to_level >= 1:
        raise ValueError("refinement needs a sub level below it: "
                         f"from_level {from_level} >= to_level {to_level} >= 1")
    runner = assembly = prev_state = prev_runner = None
    levels = []
    for level in range(from_level, to_level - 1, -1):
        lcfg = dataclasses.replace(cfg)
        lcfg.sampler = dataclasses.replace(cfg.sampler)
        lcfg.sampler.level = level
        lcfg.sampler.allow_repeats = False
        if level != from_level:
            lcfg.sampler.scrambled = False
        runner = Runner(lcfg, pyramid=runner.pyramid if runner else None)
        warm = None
        if prev_state is not None:
            soa = project_state_to_sub(prev_state, prev_runner.pyramid.sub_ranges(level + 1),
                                       runner.state.len_bp.cpu().numpy())
            warm = GenomeState.from_soa(soa, device=runner.device)
            check_invariants(warm)
            runner.state = warm
        if progress:
            print(f"--- level {level}: {runner.level.n_frags} bins "
                  f"({'warm start' if warm is not None else 'scrambled'})", flush=True)
        assembly = runner.run_em(progress=progress)
        levels.append((level, runner, assembly, warm))
        prev_state = assembly.state
        prev_runner = runner
    runner.levels = levels
    if fasta:
        runner.export_fasta(assembly, fasta)
    return runner, assembly
