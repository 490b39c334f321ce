"""Configuration of the PyTorch Persistent Sampler.

Counterpart of tempest_tpu/config.py:36-327: the algorithm constants
(:20-33) are copied as they are, and `SamplerConfig` keeps the same
keywords, defaults and validation messages. Two fields are new here:
`dtype` is a torch dtype (float32 or float64) and `device` names the torch
device every tensor lives on.

`mesh` is a 1-D `torch.distributed.device_mesh.DeviceMesh` from
`parallel.make_particle_mesh`, of the device type of `device`, and
`particle_axis` names its dimension, as in JAX; with a CUDA mesh the
sampler runs on the rank's own card. Dtypes other than float32 and float64
raise NotImplementedError naming the ROADMAP.md item. The TPU-only knobs
of ROADMAP.md queue 1, item 12 (`on_device_dispatch_budget_s`,
`donate_state`, `fused`) are not part of this package.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, List, Optional, Union

import torch

# ---------------------------------------------------------------------------
# Algorithm constants (tempest_tpu/config.py:20-33)
# ---------------------------------------------------------------------------
BETA_TOLERANCE: float = 1e-4  # Absolute tolerance on beta interval (scaled)
BETA_RTOL: float = 1e-8  # Relative tolerance on beta interval
ESS_TOLERANCE: float = 0.01  # Relative tolerance on metric target
METRIC_ATOL: float = 0.5  # Absolute metric-convergence floor (ESS mode)
METRIC_ATOL_CV: float = 0.01  # Absolute metric-convergence floor (CV mode)
DOF_FALLBACK: float = 1e6  # Student-t dof fallback when EM returns non-finite
TRIM_ESS: float = 0.99  # ESS fraction preserved by weight trimming
TRIM_BINS: int = 1000  # Percentile grid size for weight trimming
MAX_BISECTION_ITERATIONS: int = 200  # Hard cap on metric bisection loop
N_PROPOSAL_CANDIDATES: int = 8  # Batched i.i.d. candidates per walker per MCMC step

DEFAULT_HISTORY_CAPACITY: int = 16  # Initial T_max; grows geometrically
DEFAULT_K_MAX: int = 16  # Padded max number of clusters for fixed shapes


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tempest_tpu_torch yet (ROADMAP.md {item}); "
        "use tempest_tpu for it"
    )


@dataclass(frozen=True)
class SamplerConfig:
    """Immutable, validated configuration (tempest_tpu/config.py:36-173)."""

    # Required
    prior_transform: Callable
    log_likelihood: Callable
    n_dim: int

    # Sampling parameters
    n_particles: Optional[int] = None  # default: 2 * n_dim
    ess_ratio: float = 2.0
    volume_variation: Optional[float] = None  # None disables dynamic mode

    # Likelihood configuration
    log_likelihood_args: Optional[list] = None
    log_likelihood_kwargs: Optional[dict] = None
    vectorize: bool = False  # True: fns already accept (N, d) batches
    blobs_dtype: Optional[Any] = None
    blob_size: Optional[int] = None

    # Boundary conditions (indices into [0, n_dim))
    periodic: Optional[List[int]] = None
    reflective: Optional[List[int]] = None

    pool: Optional[Union[int, Any]] = None

    # Clustering
    clustering: bool = True
    normalize: bool = True
    cluster_every: int = 1
    split_threshold: float = 1.0
    n_max_clusters: Optional[int] = None

    # Algorithm parameters
    sample: str = "tpcn"  # "tpcn" | "rwm"
    n_steps: Optional[int] = None  # base MCMC steps/dim; default 1
    n_max_steps: Optional[int] = None  # max MCMC steps/dim; default 20*n_steps
    resample: str = "mult"  # "mult" | "syst"

    # Output
    output_dir: Optional[Path] = None
    output_label: Optional[str] = None

    # Random seed
    random_state: Optional[int] = None

    # ---- device and buffers -------------------------------------------
    dtype: Any = torch.float32
    device: Any = "cuda"
    host_likelihood: bool = False
    mesh: Any = None  # a DeviceMesh over the particle axis; None = one device
    particle_axis: str = "particles"  # the mesh dimension name of the particle axis
    history_capacity: int = DEFAULT_HISTORY_CAPACITY
    auto_capacity: bool = True
    k_max: int = DEFAULT_K_MAX
    n_candidates: int = N_PROPOSAL_CANDIDATES
    # None = auto (max(4096, 4*n_particles)); 0 disables subsampling.
    train_max_points: Optional[int] = None
    leaf_fit_points: Optional[int] = None
    # Draw with the Philox kernels of ops/cuda_prng.py under the seed's own
    # key (`draws.HardwareDraws`), on every device in float32: a different,
    # equally valid stream. Ignored in float64, as in
    # tempest_tpu/config.py:156-163: the draws are then those of
    # hardware_prng=False (keyed on the card, the generator's on the CPU).
    hardware_prng: bool = False
    split_all: bool = True

    def __post_init__(self) -> None:
        if not isinstance(self.n_dim, int):
            raise ValueError(f"n_dim must be int, got {type(self.n_dim).__name__}")

        if self.output_dir is None:
            object.__setattr__(self, "output_dir", Path("states"))
        elif isinstance(self.output_dir, str):
            object.__setattr__(self, "output_dir", Path(self.output_dir))

        if self.output_label is None:
            object.__setattr__(self, "output_label", "ps")

        if self.n_particles is None:
            object.__setattr__(self, "n_particles", 2 * self.n_dim)

        if self.n_steps is None or self.n_steps <= 0:
            object.__setattr__(self, "n_steps", 1)
        if self.n_max_steps is None or self.n_max_steps <= 0:
            object.__setattr__(self, "n_max_steps", 20 * self.n_steps)

        if self.n_max_clusters is not None:
            object.__setattr__(self, "k_max", max(1, int(self.n_max_clusters)))

        if self.train_max_points is None:
            object.__setattr__(
                self, "train_max_points", max(4096, 4 * self.n_particles)
            )

        if self.leaf_fit_points is None:
            object.__setattr__(
                self,
                "leaf_fit_points",
                self.train_max_points // 2 if self.train_max_points else 0,
            )

        object.__setattr__(self, "device", torch.device(self.device))

        self.validate()
        self._check_ported()
        self._check_mesh()

        if self.pool is not None and not self.host_likelihood:
            warnings.warn(
                "pool is ignored for torch likelihoods: parallelism comes from "
                "sharding the particle axis over the device mesh (pass mesh=...). "
                "It IS honored together with host_likelihood=True.",
                UserWarning,
                stacklevel=2,
            )

        if self.volume_variation is not None and self.n_particles < self.n_dim + 1:
            warnings.warn(
                f"For dynamic mode, n_particles ({self.n_particles}) should be "
                f">= n_dim + 1 ({self.n_dim + 1}) for reliable results.",
                UserWarning,
                stacklevel=2,
            )

    def validate(self) -> None:
        """Check every field; collect all problems and raise once.

        The rules and messages of tempest_tpu/config.py:229-321.
        """
        problems: List[str] = []

        def need(ok: bool, msg: str) -> bool:
            if not ok:
                problems.append(msg)
            return ok

        need(callable(self.prior_transform), "prior_transform is not callable")
        need(callable(self.log_likelihood), "log_likelihood is not callable")
        need(
            isinstance(self.n_dim, int) and self.n_dim > 0,
            f"n_dim should be a positive integer (got {self.n_dim!r})",
        )

        if need(
            isinstance(self.n_particles, int),
            f"n_particles should be an integer (got {type(self.n_particles).__name__})",
        ):
            need(
                self.n_particles > 0,
                f"n_particles should be > 0 (got {self.n_particles})",
            )

        if need(
            isinstance(self.ess_ratio, (int, float)),
            f"ess_ratio should be a number (got {type(self.ess_ratio).__name__})",
        ):
            need(self.ess_ratio > 0, f"ess_ratio should be > 0 (got {self.ess_ratio})")

        if self.volume_variation is not None:
            if need(
                isinstance(self.volume_variation, (int, float)),
                "volume_variation should be a number or None "
                f"(got {type(self.volume_variation).__name__})",
            ):
                need(
                    self.volume_variation > 0,
                    f"volume_variation should be > 0 (got {self.volume_variation})",
                )

        need(
            self.sample in ("tpcn", "rwm"),
            f"unknown sample kernel {self.sample!r} — choose 'tpcn' or 'rwm'",
        )
        need(
            self.resample in ("mult", "syst"),
            f"unknown resample scheme {self.resample!r} — choose 'mult' or 'syst'",
        )
        need(
            not (self.vectorize and self.blobs_dtype is not None),
            "blobs require per-particle likelihood calls; drop vectorize=True "
            "or blobs_dtype",
        )

        if self.periodic is not None and self.reflective is not None:
            shared = sorted(set(self.periodic) & set(self.reflective))
            need(
                not shared,
                f"dimensions {shared} appear as both periodic and reflective — "
                "each index may use at most one boundary type",
            )

        for kind in ("periodic", "reflective"):
            idx = getattr(self, kind)
            if idx is None:
                continue
            bad = [i for i in idx if not (isinstance(i, int) and 0 <= i < self.n_dim)]
            need(
                not bad,
                f"{kind} contains out-of-range or non-integer entries {bad}; "
                f"valid dimension indices are 0..{self.n_dim - 1}",
            )

        need(
            isinstance(self.output_dir, Path),
            f"output_dir should be a Path (got {type(self.output_dir).__name__})",
        )
        need(
            self.output_label is None or isinstance(self.output_label, str),
            f"output_label should be a string (got {type(self.output_label).__name__})",
        )

        if problems:
            listing = "\n".join(f"  * {p}" for p in problems)
            raise ValueError(f"Invalid SamplerConfig ({len(problems)} problem(s)):\n{listing}")

    def _check_ported(self) -> None:
        """Refuse, by name, every option this package does not run."""
        if self.dtype not in (torch.float32, torch.float64):
            raise not_ported(f"dtype={self.dtype} (only torch.float32 and torch.float64)",
                             "queue 1, item 11")

    def _check_mesh(self) -> None:
        """A mesh must be a 1-D DeviceMesh over `particle_axis`, of the
        device type the sampler runs on; a CUDA sampler then runs on the
        rank's current card."""
        if self.mesh is None:
            return
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(self.mesh, DeviceMesh):
            raise TypeError(
                "mesh must be a torch.distributed.device_mesh.DeviceMesh from "
                "tempest_tpu_torch.parallel.make_particle_mesh(), got "
                f"{type(self.mesh).__name__}")
        if self.mesh.ndim != 1 or self.mesh.mesh_dim_names != (self.particle_axis,):
            raise ValueError(
                f"mesh must be 1-D with the dimension {self.particle_axis!r}, got "
                f"dimensions {self.mesh.mesh_dim_names}")
        if self.mesh.device_type != self.device.type:
            raise ValueError(
                f"mesh of device type {self.mesh.device_type!r} for a sampler on {self.device}")
        if self.device.type == "cuda" and self.device.index is None:
            object.__setattr__(self, "device",
                               torch.device("cuda", torch.cuda.current_device()))

    def get_target_metric(self) -> float:
        """Target metric: CV in dynamic mode, else ess_ratio * n_particles."""
        if self.volume_variation is not None:
            return self.volume_variation
        return self.ess_ratio * self.n_particles
