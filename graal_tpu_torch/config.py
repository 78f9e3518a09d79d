"""Configuration: typed dataclasses + TOML loading.

PyTorch counterpart of ``graal_tpu.config``: the same sections, knobs and
defaults, except that the JAX platform override is replaced by the torch
``device`` the run lives on, which defaults to the card. A run on the CPU
must ask for it (``device = "cpu"``): :func:`resolve_device` refuses a CUDA
device that does not exist instead of running on the CPU. The JAX
package's ``n_row_shards``, which nothing there reads, is not a field
here (a run's rows split by the ranks of its ``torch.distributed``
world), so a TOML file that sets it is refused.
"""

from __future__ import annotations

import dataclasses
import tomllib

import torch


@dataclasses.dataclass
class PyramidConfig:
    size: int = 4                  # pyramid levels
    factor: int = 3                # collinear fragments per bin
    min_bin_per_contig: int = 1
    ref_quirks: bool = False       # opt-in: replicate two upstream pyramid
                                   # defects (see io.pyramid) so COO triplets
                                   # diff bit-exact against the reference


@dataclasses.dataclass
class ModelConfig:
    use_rippe: bool = True         # False = the 3-segment broken power law
    kuhn: float = 1.0              # fit initial values
    lm: float = 9.6
    slope: float = -1.5
    d: float = 3.0                 # fixed exponent
    max_dist_bins_factor: float = 1.0  # fit window = mean contig length


@dataclasses.dataclass
class SamplerConfig:
    level: int = 3                 # sampling level (default size - 1)
    n_cycles: int = 10             # EM cycles
    n_neighbours: int = 4          # delta: sampled partners per step
    n_neighbours_cap: int = 10     # top-k of the proposal distribution
    thresh_overflow: float = 30.0  # score window below the best candidate
    sample_param: bool = True      # nuisance sampling at every step
    allow_repeats: bool = False    # duplicate coverage-outlier bins
    scrambled: bool = True         # explode the genome before sampling
    scoring: str = "auto"          # candidate scoring: auto | full | delta
    snapshot_every: int = 0        # a reordered-matrix snapshot every N cycles
                                   # (0 = only on request); animate the series
                                   # with utils.plots.animate_snapshots
    watch: bool = False            # refresh <out>/live.html each cycle (utils.live)
    blacklist_contigs: tuple = ()  # contig ids to freeze
    sub_sample_factor: float = 0.0 # Poisson coverage sub-sampling in (0, 1]
    seed: int = 1                  # seed of the run's torch.Generator
    t0: float = 1.0                # temperature schedule (constant when
    tf: float = 1.0                # t0 == tf)
    limit_rejection: float = 0.5


@dataclasses.dataclass
class RunConfig:
    dataset_dir: str = ""
    output_dir: str = "graal_out"
    fasta: str = ""
    pyramid: PyramidConfig = dataclasses.field(default_factory=PyramidConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    n_chains: int = 1              # chains of the tempered stage (one device)
    device: str = "cuda"           # torch device of the run; "cpu" on request

    @staticmethod
    def from_toml(path: str) -> "RunConfig":
        with open(path, "rb") as fh:
            raw = tomllib.load(fh)
        cfg = RunConfig()
        for section, cls in (("pyramid", PyramidConfig), ("model", ModelConfig),
                             ("sampler", SamplerConfig)):
            if section in raw:
                setattr(cfg, section, cls(**raw.pop(section)))
        for k, v in raw.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown config key: {k}")
            setattr(cfg, k, v)
        return cfg


def temperature_schedule(cfg: SamplerConfig, t: float, n_step: float) -> float:
    """Geometric annealing from t0 to tf over the first limit_rejection of
    the run; constant T when t0 == tf."""
    if cfg.t0 == cfg.tf:
        return float(cfg.t0)
    frac = min(t / (n_step * cfg.limit_rejection), 1.0)
    return float(cfg.t0 * (cfg.tf / cfg.t0) ** frac)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises RuntimeError for a CUDA device
    when torch sees no card (a run never moves to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda.is_available() "
                           "is false; pass device 'cpu' to run on the CPU")
    return device
