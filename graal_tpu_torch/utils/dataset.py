"""Synthetic dataset writer: ground-truth genome in reference file format.

Counterpart of ``graal_tpu.utils.dataset`` (the same numpy draws: one seed
gives byte-identical files in both packages).

Produces a dataset directory consumable by the full pipeline (and by the
reference GRAAL itself): ``fragments_list.txt``, ``info_contigs.txt``,
``abs_fragments_contacts_weighted.txt`` and ``genome.fa``, with contact
pairs drawn from the Rippe model on a known fragment order. Used for
ground-truth-known end-to-end runs (the reference's is_simu mode).
"""

from __future__ import annotations

import os

import numpy as np

from graal_tpu_torch.io import fasta as fasta_io


def write_synthetic_dataset(out_dir: str, n_bins: int = 120, n_contigs: int = 4,
                            frag_len: int = 300, contacts_scale: float = 40.0,
                            trans_rate: float = 0.02, seed: int = 0,
                            shuffle: bool = False):
    """Write a synthetic dataset; returns an info dict.

    ``n_bins`` level-0 restriction fragments are distributed over
    ``n_contigs`` chromosomes; cis contact counts fall off as a power law
    of fragment distance, trans contacts are a uniform floor. With
    ``shuffle`` the *fragment order within the files* is the true order but
    chromosome assignment boundaries are hidden from the assembler anyway
    (every run starts scrambled).
    """
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    sizes = np.full(n_contigs, n_bins // n_contigs)
    sizes[: n_bins - sizes.sum()] += 1

    seqs, frag_rows = {}, []
    contig_of = np.zeros(n_bins, np.int64)
    f = 0
    for c, size in enumerate(sizes):
        name = f"chr{c}"
        seqs[name] = "".join(rng.choice(list("ACGT"), size * frag_len))
        pos = 0
        for rel in range(1, size + 1):
            frag_rows.append((rel, name, pos, pos + frag_len, frag_len,
                              round(rng.uniform(0.35, 0.55), 3)))
            contig_of[f] = c
            pos += frag_len
            f += 1

    with open(os.path.join(out_dir, "fragments_list.txt"), "w") as fh:
        fh.write("id\tchrom\tstart_pos\tend_pos\tsize\tgc_content\n")
        for r in frag_rows:
            fh.write("\t".join(str(x) for x in r) + "\n")
    with open(os.path.join(out_dir, "info_contigs.txt"), "w") as fh:
        fh.write("contig\tlength_kb\tn_frags\tcumul_length\n")
        cum = 0
        for c, size in enumerate(sizes):
            fh.write(f"chr{c}\t{size * frag_len}\t{size}\t{cum}\n")
            cum += size
    fasta_io.write_fasta(os.path.join(out_dir, "genome.fa"), seqs)

    # pairwise contact counts: power-law cis + uniform trans
    iu, ju = np.triu_indices(n_bins, k=1)
    d = np.abs(iu - ju).astype(np.float64)
    same = contig_of[iu] == contig_of[ju]
    mean = np.where(same, contacts_scale / np.power(d, 1.3), trans_rate)
    counts = rng.poisson(mean)
    n_pairs = int(counts.sum())
    with open(os.path.join(out_dir, "abs_fragments_contacts_weighted.txt"),
              "w") as fh:
        fh.write("id_frag_a\tid_frag_b\tw\n")
        for a, b, c in zip(iu, ju, counts):
            for _ in range(c):
                fh.write(f"{a + 1}\t{b + 1}\t1\n")

    return {"dir": out_dir, "n_bins": n_bins, "n_contigs": n_contigs,
            "n_contact_pairs": n_pairs,
            "fasta": os.path.join(out_dir, "genome.fa")}
