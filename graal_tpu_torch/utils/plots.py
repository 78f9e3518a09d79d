"""Post-hoc run analysis: summary figures from an output directory.

Counterpart of ``graal_tpu.utils.plots``. The reference ships a separate
analyzer that reads its 8 txt series and plots figures
(plot_results_simu.py, simulation_loader.plot_info_simu :722-758). This
module renders one summary panel per run directory, a GIF of the matrix
snapshot series and the genome-layout painting. Headless (Agg backend)
and optional: where matplotlib is not installed each function returns
None, as the JAX package's do. Usage: ``python -m
graal_tpu_torch.utils.plots OUTPUT_DIR [...]``.
"""

from __future__ import annotations

import os

import numpy as np

SERIES = [
    ("0list_likelihood.txt", "log-likelihood"),
    ("0list_n_contigs.txt", "n contigs"),
    ("0list_dist_init_genome.txt", "distance to initial genome"),
    ("0list_mean_len.txt", "mean contig length (bp)"),
    ("0list_fact.txt", "scale factor"),
    ("0list_slope.txt", "slope"),
    ("0list_d_max.txt", "max cis distance (kb)"),
    ("0list_d_nuc.txt", "v_inter"),
]


def _load(path):
    import warnings

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # empty series files are fine
            data = np.loadtxt(path)
        return data if data.size else None
    except (OSError, ValueError):
        return None


def summarize_run(output_dir: str, out_name: str = "summary.png") -> str | None:
    """Render the run-summary panel; returns the written path or None."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        print("matplotlib unavailable; skipping summary plot")
        return None

    loaded = [(title, _load(os.path.join(output_dir, name)))
              for name, title in SERIES]
    loaded = [(t, d) for t, d in loaded if d is not None and np.ndim(d) > 0
              and len(d) > 1]
    if not loaded:
        print(f"no series found in {output_dir}")
        return None

    ncols = 2
    nrows = (len(loaded) + 1) // 2
    fig, axes = plt.subplots(nrows, ncols, figsize=(11, 2.6 * nrows),
                             dpi=110, squeeze=False)
    for ax, (title, data) in zip(axes.reshape(-1), loaded):
        ax.plot(data, lw=0.8)
        ax.set_title(title, fontsize=9)
        ax.tick_params(labelsize=7)
        ax.grid(alpha=0.3)
    for ax in axes.reshape(-1)[len(loaded):]:
        ax.axis("off")
    fig.suptitle(os.path.basename(os.path.abspath(output_dir)))
    fig.tight_layout()
    out = os.path.join(output_dir, out_name)
    fig.savefig(out)
    plt.close(fig)
    return out


def animate_snapshots(output_dir: str, out_name: str = "assembly.gif",
                      fps: int = 2) -> str | None:
    """Animate the snapshot_NNNN matrix series (pipeline
    ``snapshot_every``) into a GIF — the headless stand-in for the
    reference's live GL matrix view (reorder_tex, kernels3.cu:3777-3822).
    Returns the written path, or None without matplotlib/snapshots."""
    import glob

    files = sorted(glob.glob(os.path.join(output_dir, "snapshot_*.npy")))
    if not files:
        return None
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.animation as animation
        import matplotlib.pyplot as plt
    except Exception:
        return None
    mats = [np.load(f) for f in files]
    vmax = max(np.percentile(m[m > 0], 98) if (m > 0).any() else 1.0
               for m in mats)
    fig, ax = plt.subplots(figsize=(6, 6), dpi=100)
    im = ax.imshow(mats[0], vmin=0, vmax=vmax, cmap="afmhot_r",
                   interpolation="nearest")
    title = ax.set_title(os.path.basename(files[0]))
    ax.set_xticks([]), ax.set_yticks([])

    def update(i):
        im.set_data(mats[i])
        title.set_text(os.path.basename(files[i]))
        return [im, title]

    anim = animation.FuncAnimation(fig, update, frames=len(mats))
    out = os.path.join(output_dir, out_name)
    anim.save(out, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out


def plot_genome_layout(state, chrom_of_bin, output_dir: str,
                       out_name: str = "genome_layout.png",
                       max_contigs: int = 64) -> str | None:
    """Assembly structure painting — the headless stand-in for the
    reference's 3D particle view (gl_update_pos, kernels3.cu:3824-3973):
    each assembled contig is one horizontal track of fragments in
    position order, colored by SOURCE chromosome, orientation drawn as
    marker direction. A correct assembly shows single-colored tracks with
    uniform arrowheads; chimeric joins and misorientations are visible as
    color/direction breaks.

    ``chrom_of_bin``: (n_bins,) array mapping data bins to source
    chromosome indices (e.g. pd-factorized Level.frags.chrom).
    """
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    id_c, pos, ori, activ, id_d = (
        x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
        for x in (state.id_c, state.pos, state.ori, state.activ, state.id_d))
    chrom_of_bin = np.asarray(chrom_of_bin)
    cids, counts = np.unique(id_c[activ == 1], return_counts=True)
    order = np.argsort(-counts)[:max_contigs]
    n_chrom = int(chrom_of_bin.max()) + 1
    cmap = plt.get_cmap("tab20", max(n_chrom, 2))
    fig, ax = plt.subplots(
        figsize=(10, max(2, 0.3 * len(order))), dpi=100)
    for track, k in enumerate(order):
        members = np.nonzero((id_c == cids[k]) & (activ == 1))[0]
        members = members[np.argsort(pos[members])]
        x = np.arange(len(members))
        colors = cmap(chrom_of_bin[id_d[members]] % cmap.N)
        flipped = ori[members] == -1
        fwd = ~flipped
        if fwd.any():
            ax.scatter(x[fwd], np.full(fwd.sum(), track), c=colors[fwd],
                       s=14, marker=">", linewidths=0)
        if flipped.any():
            ax.scatter(x[flipped], np.full(flipped.sum(), track),
                       c=colors[flipped], s=14, marker="<", linewidths=0)
    ax.set_yticks(range(len(order)))
    ax.set_yticklabels([f"contig {cids[k]} ({counts[k]})" for k in order],
                       fontsize=7)
    ax.set_xlabel("position in contig (bins)")
    ax.set_title("assembled contigs, colored by source chromosome")
    ax.invert_yaxis()
    fig.tight_layout()
    out = os.path.join(output_dir, out_name)
    fig.savefig(out)
    plt.close(fig)
    return out


def main(argv=None):
    import sys

    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: python -m graal_tpu_torch.utils.plots OUTPUT_DIR [...]")
        return 1
    for d in args:
        out = summarize_run(d)
        if out:
            print(f"wrote {out}")
        gif = animate_snapshots(d)
        if gif:
            print(f"wrote {gif}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
