"""FASTA import and assembled-genome export.

Counterpart of ``graal_tpu.io.fasta``; :func:`export_assembly` takes a
torch ``GenomeState`` on any device (each field is copied to the host
once). Mirrors the reference's sequence handling: reference-genome loading
(pyramid.load_reference_sequence, pyramid_sparse.py:1148-1174), per-bin
sequence extraction (level.build_seq_per_bin :1411-1428) and the final
orientation-aware export of the reassembled genome with its companion
``info_frags.txt`` table (level.generate_new_fasta :1430-1488).
"""

from __future__ import annotations

import json
import os

import numpy as np

_COMPLEMENT = str.maketrans("TAGCtagc", "ATCGatcg")


def load_fasta(path: str) -> dict:
    """contig name -> sequence (full header line after '>' is the name)."""
    seqs = {}
    name = None
    chunks = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(chunks)
                name = line[1:]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        seqs[name] = "".join(chunks)
    return seqs


def reverse_complement(seq: str) -> str:
    return seq[::-1].translate(_COMPLEMENT)


def write_fasta(path: str, contigs: dict, line_len: int = 60):
    with open(path, "w") as fh:
        for header, seq in contigs.items():
            fh.write(f">{header}\n")
            for i in range(0, len(seq), line_len):
                fh.write(seq[i:i + line_len] + "\n")


def export_assembly(state, frag_chrom, frag_start, frag_end, sequences,
                    fasta_path: str, info_path: str):
    """Write the reassembled genome.

    - ``state``: final GenomeState, on any device.
    - ``frag_chrom`` / ``frag_start`` / ``frag_end``: per *data-bin* source
      coordinates (the sampling level's fragments).
    - ``sequences``: dict of source contig name -> sequence.

    Contigs are emitted ordered by (id_c, pos); fragments with ori == -1 are
    reverse-complemented; contigs containing any inactive fragment are
    skipped (repeat copies switched off), matching generate_new_fasta
    (pyramid_sparse.py:1430-1488). ``info_frags.txt`` lists
    (init_contig, id_frag, orientation, start, end) per fragment.
    """
    s = state.to_numpy()
    id_c, pos, ori, activ, id_d = (s[f] for f in ("id_c", "pos", "ori", "activ", "id_d"))

    out_contigs = {}
    with open(info_path, "w") as info:
        for c in np.unique(id_c):
            members = np.nonzero(id_c == c)[0]
            if not np.all(activ[members] == 1):
                continue
            header = f"3C-assembly|contig_{c}"
            info.write(f">{header}\n")
            info.write("init_contig\tid_frag\torientation\tstart\tend\n")
            ordered = members[np.argsort(pos[members])]
            seq_parts = []
            for f in ordered:
                b = int(id_d[f])
                chrom = frag_chrom[b]
                start, end = int(frag_start[b]), int(frag_end[b])
                piece = sequences[chrom][start:end]
                if ori[f] == -1:
                    piece = reverse_complement(piece)
                seq_parts.append(piece)
                info.write(f"{chrom}\t{b}\t{int(ori[f])}\t{start}\t{end}\n")
            out_contigs[header] = "".join(seq_parts)
    write_fasta(fasta_path, out_contigs, line_len=60)
    stats = assembly_stats([len(s) for s in out_contigs.values()])
    stats_path = os.path.join(os.path.dirname(os.path.abspath(fasta_path)),
                              "assembly_stats.json")
    with open(stats_path, "w") as fh:
        json.dump(stats, fh, indent=1)
    return out_contigs


def assembly_stats(lengths) -> dict:
    """Standard scaffold statistics of an assembly (no reference
    equivalent — the reference reports only contig count/mean length,
    main_gl.py:98-113): total/largest length, N50/L50, N90/L90.

    N50 = length of the shortest contig in the smallest set of longest
    contigs covering >= 50% of the assembly; L50 = that set's size.
    """
    ls = sorted((int(x) for x in lengths), reverse=True)
    total = int(sum(ls))
    out = {"n_contigs": len(ls), "total_bp": total,
           "largest_bp": ls[0] if ls else 0,
           "mean_bp": round(total / len(ls), 1) if ls else 0.0}
    for frac, name in ((0.5, "50"), (0.9, "90")):
        acc = 0
        nxx, lxx = 0, 0
        for i, x in enumerate(ls):
            acc += x
            if acc >= frac * total:
                nxx, lxx = x, i + 1
                break
        out[f"N{name}_bp"] = nxx
        out[f"L{name}"] = lxx
    return out
