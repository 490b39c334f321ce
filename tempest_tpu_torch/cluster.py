"""Weighted Gaussian-mixture EM and hierarchical BIC-gated clustering.

Counterpart of tempest_tpu/cluster.py, with its four covariance types
("full", "tied", "diag", "spherical") and best-of-`n_init` EM restarts:

- `_log_gauss` (:49-74) with the identity fallback where the Cholesky
  factor is not finite (`cholesky_ex`'s info, never a `try`);
- the k-means++ start `_kmeanspp_init` (:77-120), which takes its uniforms
  as an argument;
- `_m_step` for every type (:123-151; "tied" normalised by the total
  responsibility mass, as JAX deviates from the reference there, and
  every type stored as full (K, d, d) matrices), `_e_step`,
  `_mixture_scores`, `_gmm_fit_scores` with its restarts (:197-280), the
  K = 1 closed form and `_bic_from_lik` with the per-type parameter
  counts (:309-400);
- the public `gmm_fit`, `gmm_predict`, `gmm_bic` (:283-306, :403-445),
  `cluster_predict` and `cluster_predict_proba` (:648-674);
- `ClusterModel`, `single_cluster_model`, `_predict_scores` (:553-645);
- `_split_round` (:678-804), `hgm_fit` with the `split_all` doubling
  prefix (:814-984) and `_final_refit` (:988-1021);
- the facades `GaussianMixture` (:448-546) and
  `HierarchicalGaussianMixture` (:1024-1137), whose results are numpy
  arrays, as in JAX.

JAX vmaps the leaf fits and the restarts; here every function takes a
leading batch axis B of leaves, and the n_init restarts of each leaf are
laid out on that same axis (B * n_init fits) before the best lower bound
of each leaf is taken. The vmapped EM `while_loop` (:256) becomes, on CPU
tensors, the device loop "gmm_em" (`loops.run_loop`) over the whole batch
with a `done` flag per fit: a fit that is done (or at `max_iter`) keeps its
parameters while the others iterate, as under vmap, and the loop reads
`any(active)` once a chunk of EM iterations. On CUDA tensors the whole
loop is one launch of a kernel (`ops.cuda_em.gmm_em`) that reads nothing.
A split round (:943-948) carries the leaf count and `go` as device
tensors; its stretch before the EM ("split_head"), the EM and the stretch
after it ("split_tail") are each one graph replay when graphs are on, and
the host reads `go` and the leaf count once a round.

A fit's only randomness is one k-means++ uniform per component and start,
from its key; `utils/threefry.py` computes them as `jax.random` does, in
the dtype of the data (a float64 uniform takes 64 random bits, as JAX's
does under x64), so with the same data the fits agree with JAX value for
value.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .loops import Loops, run_loop
from .ops import cuda_em
from .ops.tools import logsumexp
from .utils import threefry

_EPS = 1e-10
_LOG2PI = math.log(2.0 * math.pi)
_REG_COVAR = 1e-6
FIT_SEED = 42  # tempest_tpu/fused.py:134, the reference's np.random.seed(42)
COVARIANCE_TYPES = ("full", "tied", "diag", "spherical")


class GMMParams(NamedTuple):
    weights: torch.Tensor  # (B, K) mixture weights
    means: torch.Tensor  # (B, K, d)
    covariances: torch.Tensor  # (B, K, d, d)
    lower_bound: torch.Tensor  # (B,)
    n_iter: torch.Tensor  # (B,) int32


def _uniform_bits(dtype) -> int:
    return 64 if dtype == torch.float64 else 32


def fit_uniforms(
    k_max: int, seed: int = FIT_SEED, device=None, dtype=torch.float32, n_init: int = 1
) -> torch.Tensor:
    """The k-means++ uniforms of leaf slots 0..k_max-1 in `dtype`: with one
    EM start, (k_max, 2) = uniform(split(split(PRNGKey(seed), k_max)[i],
    2)[j]) (cluster.py:86, :738); with n_init > 1, (k_max, n_init, 2), start
    r of leaf i from split(leaf_i, n_init)[r] (:274)."""
    bits = _uniform_bits(dtype)
    leaves = threefry.split(threefry.prng_key(seed), k_max)
    vals = [threefry.kmeanspp_uniforms(leaf, n_init, 2, bits) for leaf in leaves]
    out = torch.tensor(vals, dtype=dtype, device=device)  # (k_max, n_init, 2)
    return out[:, 0] if n_init <= 1 else out


# ---------------------------------------------------------------------------
# Weighted Gaussian mixture EM, batched over leaves (B) and components (K)
# ---------------------------------------------------------------------------
def _chol_inv_logdet(cov: torch.Tensor, reg_covar: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L^-1, log|cov + reg I|) of (..., d, d) covariances, with the factor
    sqrt(reg) I where the Cholesky factor fails (cluster.py:582-592)."""
    d = cov.shape[-1]
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    L, info = torch.linalg.cholesky_ex(cov + eye * reg_covar)
    ok = (info == 0) & torch.isfinite(L).all(dim=(-2, -1))
    L_safe = torch.where(ok[..., None, None], L, math.sqrt(reg_covar) * eye)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L_safe, dim1=-2, dim2=-1)), dim=-1)
    L_inv = torch.linalg.solve_triangular(L_safe, eye.expand_as(L_safe), upper=False)
    return L_inv, logdet


def _log_gauss(X, mean, cov, reg_covar: float) -> torch.Tensor:
    """log N(X | mean, cov + reg I): X (..., n, d), mean (..., d),
    cov (..., d, d) -> (..., n) (cluster.py:49-74)."""
    d = X.shape[-1]
    L_inv, logdet = _chol_inv_logdet(cov, reg_covar)
    sol = (X - mean[..., None, :]) @ L_inv.transpose(-1, -2)  # rows L^-1 (x - mean)
    maha = torch.sum(sol * sol, dim=-1)
    return -0.5 * (d * _LOG2PI + logdet[..., None] + maha)


def _searchsorted_rows(cumsum: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per row, the first index with cumsum >= r (jnp.searchsorted, side
    'left'), clipped into the row."""
    idx = torch.searchsorted(cumsum, r[:, None], right=False)[:, 0]
    return torch.clamp(idx, 0, cumsum.shape[1] - 1)


def _kmeanspp_init(X, sample_weight, n_components: int, uniforms) -> torch.Tensor:
    """Weighted k-means++ seeding and the initial soft responsibilities
    (cluster.py:77-120). X (B, n, d), sample_weight (B, n), uniforms
    (B, n_components): the draw that picks center k of each leaf.
    Returns resp (B, n, n_components)."""
    B, n, d = X.shape
    rows = torch.arange(B, device=X.device)
    cumsum = torch.cumsum(sample_weight, dim=1)
    first = _searchsorted_rows(cumsum, uniforms[:, 0] * cumsum[:, -1])
    means = torch.zeros((B, n_components, d), dtype=X.dtype, device=X.device)
    means[:, 0] = X[rows, first]
    col_ids = torch.arange(n_components, device=X.device)
    for k in range(1, n_components):
        d2 = torch.sum((X[:, :, None, :] - means[:, None, :, :]) ** 2, dim=-1)  # (B, n, K)
        d2 = torch.where(col_ids < k, d2, torch.full_like(d2, float("inf")))
        probs = torch.amin(d2, dim=2) * sample_weight
        probs = probs / torch.clamp(torch.sum(probs, dim=1, keepdim=True), min=_EPS)
        cumsum = torch.cumsum(probs, dim=1)
        means[:, k] = X[rows, _searchsorted_rows(cumsum, uniforms[:, k] * cumsum[:, -1])]

    # Bandwidth: the weighted mean squared distance to the nearest center
    # (cluster.py:103-112).
    d2 = torch.sum((X[:, :, None, :] - means[:, None, :, :]) ** 2, dim=-1)
    d2_min = torch.amin(d2, dim=2)
    h2 = torch.sum(sample_weight * d2_min, dim=1) / torch.clamp(
        torch.sum(sample_weight, dim=1), min=_EPS
    )
    h2 = torch.clamp(h2, min=_EPS)
    resp = torch.exp(-0.5 * (d2 - d2_min[..., None]) / h2[:, None, None])
    return resp / torch.clamp(torch.sum(resp, dim=2, keepdim=True), min=_EPS)


def _m_step(X, resp, sample_weight, covariance_type: str = "full"):
    """Weighted M-step (cluster.py:123-151), covariances as full (B, K, d, d)
    matrices of every type. X (B, n, d), resp (B, n, K), sample_weight (B, n)."""
    d = X.shape[-1]
    wresp = resp * sample_weight[..., None]  # (B, n, K)
    nk = torch.sum(wresp, dim=1)  # (B, K)
    pi = nk / torch.clamp(torch.sum(nk, dim=1, keepdim=True), min=_EPS)
    means = (wresp.transpose(1, 2) @ X) / (nk[..., None] + _EPS)
    diff = X[:, :, None, :] - means[:, None, :, :]  # (B, n, K, d)
    if covariance_type == "full":
        covs = torch.einsum("bnk,bnki,bnkj->bkij", wresp, diff, diff)
        return pi, means, covs / (nk[..., None, None] + _EPS)
    if covariance_type == "tied":
        # JAX's deviation from the reference (:135-142): the pooled scatter
        # over the total responsibility mass.
        tied = torch.einsum("bnk,bnki,bnkj->bij", wresp, diff, diff)
        tied = tied / torch.clamp(torch.sum(nk, dim=1), min=_EPS)[:, None, None]
        return pi, means, tied[:, None].expand(-1, means.shape[1], d, d)
    if covariance_type == "diag":
        var = torch.einsum("bnk,bnki->bki", wresp, diff * diff) / (nk[..., None] + _EPS)
        return pi, means, torch.diag_embed(var)
    if covariance_type == "spherical":
        s = torch.einsum("bnk,bnki->bk", wresp, diff * diff) / (nk * d + _EPS)
        return pi, means, s[..., None, None] * torch.eye(d, dtype=X.dtype, device=X.device)
    raise ValueError(f"Unknown covariance_type {covariance_type}")


def _mixture_scores(X, pi, means, covs, reg_covar: float):
    """(log_probs (B, K, n), lik (B, n)): the unweighted component
    log-densities and the mixture likelihood (cluster.py:173-188)."""
    log_probs = _log_gauss(X[:, None], means, covs, reg_covar)
    lik = torch.sum(pi[..., None] * torch.exp(log_probs), dim=1)
    return log_probs, lik


def _e_step(X, pi, means, covs, reg_covar: float, sample_weight):
    """Responsibilities (B, n, K) and the weighted lower bound (B,) at these
    parameters (cluster.py:154-170)."""
    log_probs = _log_gauss(X[:, None], means, covs, reg_covar)
    probs = pi[..., None] * torch.exp(log_probs)  # (B, K, n)
    lik = torch.sum(probs, dim=1)
    resp = probs.transpose(1, 2) / (lik[..., None] + _EPS)
    return resp, torch.sum(sample_weight * torch.log(lik + _EPS), dim=1)


def _normalized(sample_weight):
    return sample_weight / torch.clamp(torch.sum(sample_weight, dim=1, keepdim=True), min=_EPS)


def _gmm_start(X, sample_weight, n_components: int, uniforms, max_iter: int,
               covariance_type: str = "full"):
    """The batch of fits (the n_init starts of each leaf laid out on the
    batch axis) and their EM carry at the k-means++ start: (X (B', n, d),
    normalized weights (B', n), carry)."""
    if uniforms.dim() == 3:
        B, starts, n, d = X.shape[0], uniforms.shape[1], X.shape[1], X.shape[2]
        X = X[:, None].expand(B, starts, n, d).reshape(B * starts, n, d)
        sample_weight = sample_weight[:, None].expand(B, starts, n).reshape(B * starts, n)
        uniforms = uniforms.reshape(B * starts, -1)
    B = X.shape[0]
    sw = _normalized(sample_weight)
    resp = _kmeanspp_init(X, sw, n_components, uniforms)
    pi, means, covs = _m_step(X, resp, sw, covariance_type)
    carry = dict(
        pi=pi, means=means, covs=covs,
        lb=torch.full((B,), float("-inf"), dtype=X.dtype, device=X.device),
        n_iter=torch.zeros((B,), dtype=torch.int32, device=X.device),
        done=torch.zeros((B,), dtype=torch.bool, device=X.device),
        go=torch.full((), max_iter > 0, dtype=torch.bool, device=X.device),
    )
    return X, sw, carry


def _gmm_em_body(c, k, covariance_type: str, reg_covar: float):
    """One EM iteration of every fit still active; a fit that is done (or
    at max_iter) keeps its parameters, as under vmap (cluster.py:243-262)."""
    X, sw = k["X"], k["sw"]
    active = ~c["done"] & (c["n_iter"] < k["max_iter"])
    resp, new_lb = _e_step(X, c["pi"], c["means"], c["covs"], reg_covar, sw)
    new_done = (new_lb - c["lb"]) < k["tol"]
    pi2, means2, covs2 = _m_step(X, resp, sw, covariance_type)
    keep = new_done | ~active
    done = torch.where(active, new_done, c["done"])
    n_iter = c["n_iter"] + active.to(torch.int32)
    return dict(
        pi=torch.where(keep[:, None], c["pi"], pi2),
        means=torch.where(keep[:, None, None], c["means"], means2),
        covs=torch.where(keep[:, None, None, None], c["covs"], covs2),
        lb=torch.where(keep, c["lb"], new_lb),
        n_iter=n_iter, done=done,
        go=torch.any(~done & (n_iter < k["max_iter"])),
    )


def _gmm_em_kernel(k, covariance_type: str, reg_covar: float):
    """The "gmm_em" loop as one launch of `ops.cuda_em.gmm_em`."""
    carry = {e: k[e].contiguous() for e in ("pi", "means", "covs", "lb", "n_iter", "done")}
    return cuda_em.gmm_em(k["X"].contiguous(), k["sw"].contiguous(), carry, k["tol"],
                          k["max_iter"], reg_covar, covariance_type)


def _gmm_consts(X, max_iter: int, tol: float, **tensors):
    return dict(tensors, X=X, tol=torch.full((), tol, dtype=X.dtype, device=X.device),
                max_iter=torch.full((), max_iter, dtype=torch.int32, device=X.device))


def _gmm_em_plain(X, sw, carry, max_iter: int, tol: float, reg_covar: float,
                  covariance_type: str, loops: Optional[Loops]):
    """The plain "gmm_em" loop: a read a chunk of bodies. The CPU route, and
    on the card the kernel's yardstick."""
    body = functools.partial(_gmm_em_body, covariance_type=covariance_type, reg_covar=reg_covar)
    return run_loop(loops, "gmm_em", body, carry, _gmm_consts(X, max_iter, tol, sw=sw),
                    static=(covariance_type, reg_covar))


def _gmm_em(X, sw, carry, max_iter: int, tol: float, reg_covar: float, covariance_type: str,
            loops: Optional[Loops]):
    """The EM loop (cluster.py:256), "gmm_em", run until no fit is active: on
    CPU tensors the plain loop, on CUDA tensors one launch of the kernel
    (`ops.cuda_em`; through `loops.once`, a graph replay when graphs are
    on), which reads nothing."""
    if not cuda_em.kernel_route(X, sw):
        return _gmm_em_plain(X, sw, carry, max_iter, tol, reg_covar, covariance_type, loops)
    fn = functools.partial(_gmm_em_kernel, covariance_type=covariance_type, reg_covar=reg_covar)
    inputs = _gmm_consts(X, max_iter, tol, sw=sw, **{e: v for e, v in carry.items() if e != "go"})
    return (loops or Loops(X.device)).once("gmm_em", fn, inputs, (covariance_type, reg_covar))


def _gmm_finish(X, sw, carry, B: int, reg_covar: float):
    """(params, log_probs (B, K, n), lik (B, n)) at the final parameters; with
    several starts a leaf keeps the best lower bound,
    argmax(nan_to_num(lb, nan=-inf)) as JAX takes it."""
    pi, means, covs = carry["pi"], carry["means"], carry["covs"]
    log_probs, lik = _mixture_scores(X, pi, means, covs, reg_covar)
    final_lb = torch.sum(sw * torch.log(lik + _EPS), dim=1)
    fit = GMMParams(pi, means, covs, final_lb, carry["n_iter"]), log_probs, lik
    starts = X.shape[0] // B
    if starts == 1:
        return fit
    # jnp.nan_to_num(lb, nan=-inf) also maps -inf to the lowest float
    lb = final_lb.reshape(B, starts)
    best = torch.argmax(torch.nan_to_num(lb, nan=torch.finfo(lb.dtype).min), dim=1)
    rows = torch.arange(B, device=X.device)

    def pick(a):
        return a.reshape((B, starts) + a.shape[1:])[rows, best]

    return GMMParams(*(pick(a) for a in fit[0])), pick(log_probs), pick(lik)


def _gmm_fit_scores(
    X,
    sample_weight,
    n_components: int,
    uniforms,
    max_iter: int = 1000,
    tol: float = 1e-3,
    reg_covar: float = _REG_COVAR,
    covariance_type: str = "full",
    loops: Optional[Loops] = None,
):
    """Weighted EM of each leaf, best of its starts (cluster.py:197-280).

    `uniforms` are (B, K) for one start per leaf, or (B, n_init, K) for
    n_init starts; the starts run as B * n_init fits of one batch, and each
    leaf keeps the start with the best lower bound.
    Returns (params, log_probs (B, K, n), lik (B, n)) at the final
    parameters. Convergence compares the bound at the current parameters
    with the previous one; a converged fit keeps its pre-M-step parameters
    (PARITY.md deviation 5), as in JAX.
    """
    B = X.shape[0]
    Xb, sw, carry = _gmm_start(X, sample_weight, n_components, uniforms, max_iter,
                               covariance_type)
    carry = _gmm_em(Xb, sw, carry, max_iter, tol, reg_covar, covariance_type, loops)
    return _gmm_finish(Xb, sw, carry, B, reg_covar)


def _single_component_params(X, sample_weight, covariance_type: str = "full") -> GMMParams:
    """K = 1 closed-form M-step without the density pass (cluster.py:349-370);
    lower_bound is 0 and must not be read."""
    B, n, _ = X.shape
    resp = torch.ones((B, n, 1), dtype=X.dtype, device=X.device)
    pi, means, covs = _m_step(X, resp, _normalized(sample_weight), covariance_type)
    zeros = torch.zeros((B,), dtype=X.dtype, device=X.device)
    return GMMParams(pi, means, covs, zeros, torch.ones((B,), dtype=torch.int32, device=X.device))


def _n_parameters(n_components: int, n_features: int, covariance_type: str) -> float:
    """Free parameters of a mixture of this type (cluster.py:386-397)."""
    d, K = n_features, n_components
    cov_params = {
        "full": K * d * (d + 1) / 2,
        "tied": d * (d + 1) / 2,
        "diag": K * d,
        "spherical": K,
    }
    if covariance_type not in cov_params:
        raise ValueError(f"Unknown covariance_type {covariance_type}")
    return (K - 1) + K * d + cov_params[covariance_type]


def _bic_from_lik(
    lik, mask, n_components: int, n_features: int, covariance_type: str = "full"
) -> torch.Tensor:
    """BIC from a per-point mixture likelihood (cluster.py:373-400).
    lik, mask: (B, n)."""
    n_parameters = _n_parameters(n_components, n_features, covariance_type)
    n_leaf = torch.sum(mask, dim=-1).to(lik.dtype)
    ll = torch.sum(torch.where(mask, torch.log(lik + _EPS), torch.zeros_like(lik)), dim=-1)
    return -2.0 * ll + n_parameters * torch.log(torch.clamp(n_leaf, min=1.0))


# ---------------------------------------------------------------------------
# The public mixture functions, on one (n, d) data set
# ---------------------------------------------------------------------------
def gmm_fit(
    key: threefry.Key,
    X: torch.Tensor,
    sample_weight: torch.Tensor,
    n_components: int,
    covariance_type: str = "full",
    max_iter: int = 1000,
    tol: float = 1e-3,
    reg_covar: float = _REG_COVAR,
    n_init: int = 1,
) -> GMMParams:
    """Fit a weighted GMM by EM; zero-weight samples are ignored
    (cluster.py:283-306). `key` is a JAX key's two words
    (`threefry.prng_key(seed)`); n_init > 1 keeps the best of that many
    starts. Returns unbatched parameters (K,), (K, d), (K, d, d)."""
    uniforms = threefry.kmeanspp_uniforms(key, n_init, n_components, _uniform_bits(X.dtype))
    u = torch.tensor([uniforms], dtype=X.dtype, device=X.device)  # (1, starts, K)
    p, _, _ = _gmm_fit_scores(X[None], sample_weight.to(X.dtype)[None], n_components, u,
                              max_iter, tol, reg_covar, covariance_type)
    return GMMParams(*(a[0] for a in p))


def gmm_predict(params: GMMParams, X: torch.Tensor, reg_covar: float = _REG_COVAR) -> torch.Tensor:
    """Hard labels (n,) int32 by max posterior (cluster.py:403-409)."""
    log_probs = _log_gauss(X[None], params.means, params.covariances, reg_covar)  # (K, n)
    scores = torch.log(params.weights + _EPS)[:, None] + log_probs
    return torch.argmax(scores, dim=0).to(torch.int32)


def gmm_bic(
    params: GMMParams,
    X: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    covariance_type: str = "full",
    reg_covar: float = _REG_COVAR,
) -> torch.Tensor:
    """BIC with the per-type parameter counts, on the rows of `mask` with
    uniform weights (cluster.py:412-445)."""
    n, d = X.shape
    n_parameters = _n_parameters(params.means.shape[0], d, covariance_type)
    if mask is None:
        n_leaf = torch.tensor(float(n), dtype=X.dtype, device=X.device)
        uw = torch.full((n,), 1.0 / n, dtype=X.dtype, device=X.device)
    else:
        n_leaf = torch.sum(mask).to(X.dtype)
        uw = torch.where(mask, 1.0 / torch.clamp(n_leaf, min=1.0), torch.zeros_like(n_leaf))
    _, lik = _mixture_scores(X[None], params.weights[None], params.means[None],
                             params.covariances[None], reg_covar)
    ll = torch.sum(uw * torch.log(lik[0] + _EPS)) * n_leaf
    return -2.0 * ll + n_parameters * torch.log(torch.clamp(n_leaf, min=1.0))


# ---------------------------------------------------------------------------
# The fitted model and prediction
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ClusterModel:
    """Fitted hierarchical clustering (cluster.py:552-579).

    `chol_inv`/`logdet` are the scoring factors of the regularized
    covariances in prediction space (normalized coordinates when
    `normalize`), computed once at fit time.
    """

    centers: torch.Tensor  # (K_max, d) in original coordinates
    covariances: torch.Tensor  # (K_max, d, d) in original coordinates
    weights: torch.Tensor  # (K_max,) cluster weight fractions
    k_mask: torch.Tensor  # (K_max,) valid-cluster mask
    data_min: torch.Tensor  # (d,) normalization bounds
    data_max: torch.Tensor  # (d,)
    chol_inv: torch.Tensor  # (K_max, d, d)
    logdet: torch.Tensor  # (K_max,)
    normalize: bool = False
    # A real fit (False for the placeholder of single_cluster_model): the
    # `fitted` flag JAX carries beside the model (fused.py:155-157).
    fitted: bool = True

    @property
    def k_max(self) -> int:
        return self.centers.shape[0]

    def n_clusters(self) -> torch.Tensor:
        return torch.sum(self.k_mask)


def single_cluster_model(
    n_dim: int, k_max: int, dtype=torch.float32, normalize: bool = False, device=None
) -> ClusterModel:
    """The one-cluster model of an unfitted run (cluster.py:595-616)."""
    eye = torch.eye(n_dim, dtype=dtype, device=device).expand(k_max, n_dim, n_dim).clone()
    chol_inv, logdet = _chol_inv_logdet(eye, _REG_COVAR)
    first = torch.arange(k_max, device=device) < 1
    return ClusterModel(
        centers=torch.zeros((k_max, n_dim), dtype=dtype, device=device),
        covariances=eye,
        weights=first.to(dtype),
        k_mask=first,
        data_min=torch.zeros((n_dim,), dtype=dtype, device=device),
        data_max=torch.ones((n_dim,), dtype=dtype, device=device),
        chol_inv=chol_inv,
        logdet=logdet,
        normalize=normalize,
        fitted=False,
    )


def _predict_scores(model: ClusterModel, X: torch.Tensor):
    """(scores (K, n), Xn, centers_n) from the fit-time factors (cluster.py:619-645)."""
    scale = model.data_max - model.data_min + _EPS
    if model.normalize:
        Xn = (X - model.data_min) / scale
        centers = (model.centers - model.data_min) / scale
    else:
        Xn, centers = X, model.centers
    d = X.shape[1]
    sol = (Xn[None] - centers[:, None, :]) @ model.chol_inv.transpose(-1, -2)  # (K, n, d)
    maha = torch.sum(sol * sol, dim=-1)
    lp = -0.5 * (d * _LOG2PI + model.logdet[:, None] + maha) + torch.log(
        model.weights + _EPS
    )[:, None]
    scores = torch.where(model.k_mask[:, None], lp, torch.full_like(lp, float("-inf")))
    return scores, Xn, centers


def cluster_predict(model: ClusterModel, X: torch.Tensor) -> torch.Tensor:
    """Mixture-posterior labels (n,) int32, nearest center where the best
    score is not finite (cluster.py:648-664)."""
    scores, Xn, centers = _predict_scores(model, X)
    best = torch.argmax(scores, dim=0)
    d2 = torch.sum((Xn[:, None, :] - centers[None, :, :]) ** 2, dim=-1)  # (n, K)
    d2 = torch.where(model.k_mask[None, :], d2, torch.full_like(d2, float("inf")))
    nearest = torch.argmin(d2, dim=1)
    bad = ~torch.isfinite(torch.amax(scores, dim=0))
    return torch.where(bad, nearest, best).to(torch.int32)


def cluster_predict_proba(model: ClusterModel, X: torch.Tensor) -> torch.Tensor:
    """Mixture posterior probabilities (n, K_max) (cluster.py:667-671)."""
    scores, _, _ = _predict_scores(model, X)
    return torch.exp(scores - logsumexp(scores, dim=0, keepdim=True)).T


# ---------------------------------------------------------------------------
# Hierarchical (bisecting) clustering with the BIC gate
# ---------------------------------------------------------------------------
def _top_k_rows(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` per row: the k largest, ties to the lower index."""
    vals, idx = torch.sort(values, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


_EM_KEYS = ("pi", "means", "covs", "lb", "n_iter", "done", "go")


def _round_head(k, k_slots: int, n_sub: Optional[int], covariance_type: str):
    """A split round up to its EM (cluster.py:700-760): each leaf slot's
    members and weights, its EM set (the top `n_sub` members by weight when
    `n_sub` caps it), the K = 1 fit and the K = 2 fits' start."""
    Xw, sw, labels = k["Xw"], k["sw"], k["labels"]
    n, d = Xw.shape
    leaf_ids = torch.arange(k_slots, device=Xw.device)
    members = labels[None, :] == leaf_ids[:, None]  # (k_slots, n)
    leaf_w = torch.where(members, sw[None, :], torch.zeros_like(sw[None, :]))
    if n_sub is not None and n_sub < n:
        w_fit, sub_idx = _top_k_rows(leaf_w, n_sub)
        X_fit = Xw[sub_idx]  # (k_slots, n_sub, d)
    else:
        X_fit, w_fit = Xw.expand(k_slots, n, d), leaf_w
    p1 = _single_component_params(X_fit, w_fit, covariance_type)
    Xb, swb, carry = _gmm_start(X_fit, w_fit, 2, k["uniforms"][:k_slots], 1000, covariance_type)
    return dict(members=members, leaf_w=leaf_w, p1_weights=p1.weights, p1_means=p1.means,
                p1_covs=p1.covariances, Xb=Xb, swb=swb, **carry)


def _round_tail(k, k_slots: int, min_points: int, threshold_modifier: float,
                covariance_type: str) -> Dict[str, torch.Tensor]:
    """A split round after its EM (cluster.py:760-804): the BIC test of every
    leaf slot on its full membership, the children and the eligibility."""
    Xw, members, leaf_w = k["Xw"], k["members"], k["leaf_w"]
    n, d = Xw.shape
    dtype, dev = Xw.dtype, Xw.device
    w_tot = torch.sum(leaf_w, dim=1)
    n_members = torch.sum(members, dim=1)

    # threshold = modifier * n_params * log(N_eff) (cluster.py:732-736)
    w_norm = leaf_w / torch.clamp(w_tot, min=_EPS)[:, None]
    n_eff = 1.0 / torch.clamp(torch.sum(w_norm**2, dim=1), min=_EPS)
    n_params = d + d * (d + 1) / 2 + 1
    modifier = torch.full((), threshold_modifier, dtype=dtype, device=dev)
    thresholds = modifier * n_params * torch.log(torch.clamp(n_eff, min=1.0))

    X_all = Xw.expand(k_slots, n, d)
    p2 = _gmm_finish(k["Xb"], k["swb"], k, k_slots, _REG_COVAR)[0]
    _, lik1 = _mixture_scores(X_all, k["p1_weights"], k["p1_means"], k["p1_covs"], _REG_COVAR)
    scores2, lik2 = _mixture_scores(X_all, p2.weights, p2.means, p2.covariances, _REG_COVAR)
    improvement = (_bic_from_lik(lik1, members, 1, d, covariance_type)
                   - _bic_from_lik(lik2, members, 2, d, covariance_type))

    # Hard assignment by max posterior, from the fit's scores (cluster.py:784-790)
    child = torch.argmax(torch.log(p2.weights + _EPS)[:, :, None] + scores2, dim=1)
    c0 = torch.sum(members & (child == 0), dim=1)
    c1 = torch.sum(members & (child == 1), dim=1)
    eligible = (
        (torch.arange(k_slots, device=dev) < k["n_leaves"])
        & (n_members >= min_points)
        & (w_tot > 0.0)
        & (improvement > thresholds)
        & (c0 >= min_points)
        & (c1 >= min_points)
    )
    return {
        "improvement": torch.where(eligible, improvement, torch.full_like(improvement, -math.inf)),
        "child": child.to(torch.int8),
        "eligible": eligible,
    }


def _split_round(
    uniforms: torch.Tensor,
    Xw: torch.Tensor,
    sample_weight: torch.Tensor,
    labels: torch.Tensor,
    n_leaves,
    min_points: int,
    threshold_modifier: float,
    k_max: int,
    n_sub: Optional[int] = None,
    k_slots: Optional[int] = None,
    covariance_type: str = "full",
    loops: Optional[Loops] = None,
    go=True,
    split_all: bool = False,
) -> Dict[str, torch.Tensor]:
    """One split round: the K = 1 against K = 2 test of every leaf slot <
    k_slots (cluster.py:678-804), then its splits (`_round_step`).
    `uniforms` (k_max, 2), or (k_max, n_init, 2), are the leaves' k-means++
    draws (`fit_uniforms`); `n_sub` caps each leaf's EM set to its top
    members by weight, while the BIC gate and the child labels use the full
    membership. `loops` runs the head ("split_head"), the EM loop and the
    tail ("split_tail"). Returns the test's improvement, child and
    eligible per slot, and labels, n_leaves and go after the round; a round
    entered with `go` False changes nothing."""
    dev = Xw.device
    k_slots = k_max if k_slots is None else k_slots
    loops = loops or Loops(dev)
    static = (k_slots, n_sub, covariance_type)
    head = loops.once("split_head", functools.partial(
        _round_head, k_slots=k_slots, n_sub=n_sub, covariance_type=covariance_type),
        dict(Xw=Xw, sw=sample_weight, labels=labels, uniforms=uniforms), static)
    em = _gmm_em(head["Xb"], head["swb"], {e: head[e] for e in _EM_KEYS}, 1000, 1e-3,
                 _REG_COVAR, covariance_type, loops)
    inputs = {k: head[k] for k in ("members", "leaf_w", "p1_weights", "p1_means", "p1_covs",
                                   "Xb", "swb")}
    inputs.update({e: em[e] for e in ("pi", "means", "covs", "n_iter")}, Xw=Xw, labels=labels,
                  n_leaves=torch.as_tensor(n_leaves, dtype=torch.int32, device=dev),
                  go=torch.as_tensor(go, dtype=torch.bool, device=dev))
    return loops.once("split_tail", functools.partial(
        _round_step, k_slots=k_slots, k_max=k_max, min_points=min_points,
        threshold_modifier=threshold_modifier, covariance_type=covariance_type,
        split_all=split_all), inputs, static + (k_max, min_points, threshold_modifier,
                                                 split_all))


def _round_step(k, k_slots: int, k_max: int, min_points: int, threshold_modifier: float,
                covariance_type: str, split_all: bool) -> Dict[str, torch.Tensor]:
    """The round's tail and its splits, on device counts (cluster.py:880-948):
    the tail's outputs, and labels, n_leaves and go after the round. A
    round entered with go False changes nothing."""
    out = _round_tail(k, k_slots, min_points, threshold_modifier, covariance_type)
    labels, n_leaves, go = k["labels"], k["n_leaves"], k["go"]
    elig = out["eligible"] & go
    n = labels.shape[0]
    if split_all:
        # Every eligible leaf splits; new slots in leaf-id order, and those
        # that would pass k_max wait for the next round.
        rank = torch.cumsum(elig.to(torch.int32), dim=0, dtype=torch.int32) - 1
        new_ids = n_leaves + rank
        can = elig & (new_ids < k_max)
        safe = torch.clamp(labels, 0, k_slots - 1).long()
        sample_child = out["child"].to(torch.int32)[safe, torch.arange(n, device=labels.device)]
        move = (labels >= 0) & (labels < k_slots) & can[safe] & (sample_child == 1)
        n_split = torch.sum(can, dtype=torch.int32)
        return dict(out, labels=torch.where(move, new_ids[safe], labels).to(torch.int32),
                    n_leaves=n_leaves + n_split, go=n_split > 0)
    # Child 0 keeps the parent's slot, child 1 takes the next free one.
    split = torch.any(elig)
    leaf = torch.argmax(out["improvement"]).reshape(1)  # indexing with a 0-d tensor syncs
    moved = (labels == leaf) & (out["child"].index_select(0, leaf)[0].to(torch.int32) == 1) & split
    return dict(out, labels=torch.where(moved, n_leaves, labels).to(torch.int32),
                n_leaves=n_leaves + split.to(torch.int32), go=split)


def _final_refit(Xw, sample_weight, labels, k_max: int, covariance_type: str = "full"):
    """Per-leaf K = 1 refits for centers and covariances (cluster.py:987-1021)."""
    n, d = Xw.shape
    members = labels[None, :] == torch.arange(k_max, device=Xw.device)[:, None]
    leaf_w = torch.where(members, sample_weight[None, :], torch.zeros_like(sample_weight[None, :]))
    p = _single_component_params(Xw.expand(k_max, n, d), leaf_w, covariance_type)
    n_members = torch.sum(members, dim=1)
    # Tiny leaves (< d members): plain mean and the identity covariance.
    mean_small = torch.sum(
        torch.where(members[:, :, None], Xw[None], torch.zeros_like(Xw[None])), dim=1
    ) / torch.clamp(n_members, min=1)[:, None]
    big = n_members >= d
    centers = torch.where(big[:, None], p.means[:, 0], mean_small)
    eye = torch.eye(d, dtype=Xw.dtype, device=Xw.device)
    covs = torch.where(big[:, None, None], p.covariances[:, 0], eye)
    cweights = torch.sum(leaf_w, dim=1) / torch.clamp(torch.sum(sample_weight), min=_EPS)
    return centers, covs, cweights


def hgm_fit(
    X: torch.Tensor,
    sample_weight: torch.Tensor,
    mask: torch.Tensor,
    min_points: int,
    threshold_modifier: float,
    k_max: int,
    max_rounds: int,
    normalize: bool,
    split_all: bool = False,
    leaf_fit_points: Optional[int] = None,
    uniforms: Optional[torch.Tensor] = None,
    covariance_type: str = "full",
    n_init: int = 1,
    loops: Optional[Loops] = None,
) -> Tuple[ClusterModel, torch.Tensor, int]:
    """The whole hierarchical fit (cluster.py:814-984).

    Each round tests every leaf for a K = 2 split and splits the best
    eligible one (or, with `split_all`, every eligible one, with the
    doubling prefix of leaf-slot widths 1, 2, 4, ...), until nothing is
    eligible, k_max leaves exist or `max_rounds` rounds ran. `uniforms`
    (k_max, 2), or (k_max, n_init, 2), default to those of the fixed fit
    key with `n_init` starts (`fit_uniforms` in X's dtype). The leaf
    count and `go` stay on the device through a round; `loops` runs each
    round's head, its EM loop and its tail, and reads them once a round.
    Returns (model, labels (n,) int32 with -1 on masked rows, n_leaves).
    """
    n, d = X.shape
    dtype, dev = X.dtype, X.device
    if uniforms is None:
        uniforms = fit_uniforms(k_max, device=dev, dtype=dtype, n_init=n_init)
    uniforms = uniforms.to(device=dev, dtype=dtype)
    sw = torch.where(mask, sample_weight, torch.zeros_like(sample_weight))

    if normalize:  # bounds over valid rows (cluster.py:849-854)
        inf = torch.full_like(X, float("inf"))
        data_min = torch.amin(torch.where(mask[:, None], X, inf), dim=0)
        data_max = torch.amax(torch.where(mask[:, None], X, -inf), dim=0)
        Xw = (X - data_min) / (data_max - data_min + _EPS)
    else:
        data_min = torch.zeros((d,), dtype=dtype, device=dev)
        data_max = torch.ones((d,), dtype=dtype, device=dev)
        Xw = X

    loops = loops or Loops(dev)
    labels = torch.where(mask, 0, -1).to(torch.int32)
    n_leaves_t = torch.ones((), dtype=torch.int32, device=dev)
    go_t = torch.ones((), dtype=torch.bool, device=dev)
    n_leaves, go, rounds = 1, True, 0

    def round_step(k_slots):
        """One round, then one read of go and the leaf count ("split_round")."""
        nonlocal labels, n_leaves_t, go_t, n_leaves, go, rounds
        out = _split_round(uniforms, Xw, sw, labels, n_leaves_t, min_points, threshold_modifier,
                           k_max, leaf_fit_points, k_slots, covariance_type, loops, go_t,
                           split_all)
        labels, n_leaves_t, go_t = out["labels"], out["n_leaves"], out["go"]
        go_h, n_h = loops.read("split_round", go_t, n_leaves_t)
        go, n_leaves = bool(go_h), int(n_h)
        rounds += 1

    n_prefix = 0
    if split_all:
        # Round r holds at most 2^r leaves, so it tests only 2^r slots.
        while (1 << n_prefix) < k_max and n_prefix < max_rounds:
            if go and n_leaves < k_max:
                round_step(1 << n_prefix)
            n_prefix += 1
    if max_rounds > n_prefix or not split_all:
        while go and n_leaves < k_max and rounds < max_rounds:
            round_step(k_max)

    centers, covs, cweights = _final_refit(Xw, sw, labels, k_max, covariance_type)
    k_mask = torch.arange(k_max, device=dev) < n_leaves
    eye = torch.eye(d, dtype=dtype, device=dev)
    chol_inv, logdet = _chol_inv_logdet(torch.where(k_mask[:, None, None], covs, eye), _REG_COVAR)
    if normalize:
        scale = data_max - data_min + _EPS
        centers = centers * scale[None, :] + data_min[None, :]
        covs = covs * (scale[:, None] * scale[None, :])[None]
    model = ClusterModel(
        centers=torch.where(k_mask[:, None], centers, torch.zeros_like(centers)),
        covariances=torch.where(k_mask[:, None, None], covs, eye),
        weights=torch.where(k_mask, cweights, torch.zeros_like(cweights)),
        k_mask=k_mask,
        data_min=data_min,
        data_max=data_max,
        chol_inv=chol_inv,
        logdet=logdet,
        normalize=normalize,
    )
    return model, labels, n_leaves


# ---------------------------------------------------------------------------
# The public facades (cluster.py:448-546, 1024-1137)
# ---------------------------------------------------------------------------
def _as_tensor(X, dtype, device) -> torch.Tensor:
    """X on `device`: a floating torch tensor keeps its dtype, anything else
    becomes float32 (as `jnp.asarray` does without x64); `dtype`, when
    given, applies to both."""
    if isinstance(X, torch.Tensor):
        return X.to(device=device, dtype=dtype or (X.dtype if X.is_floating_point() else torch.float32))
    return torch.as_tensor(np.asarray(X), dtype=dtype or torch.float32, device=device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class GaussianMixture:
    """Weighted-GMM facade over `gmm_fit`/`gmm_predict`/`gmm_bic`
    (cluster.py:448-546): the JAX class's keywords, defaults, fitted
    attributes (`weights_`, `means_`, `covariances_`, `converged_`,
    `n_iter_`, `lower_bound_`, numpy arrays and Python numbers) and
    messages. `covariances_` are full (K, d, d) matrices of every type, and
    `bic()` counts the type's free parameters, as in JAX.

    The port's own keywords: `device` (default "cuda", as the Sampler's),
    and `dtype` (default None: a floating torch tensor keeps its dtype, a
    numpy array becomes float32; `torch.float64` fits in double).
    """

    def __init__(
        self,
        n_components: int = 1,
        covariance_type: str = "full",
        max_iter: int = 1000,
        n_init: int = 1,
        tol: float = 1e-3,
        reg_covar: float = 1e-6,
        random_state: Optional[int] = None,
        device="cuda",
        dtype=None,
    ):
        if covariance_type not in COVARIANCE_TYPES:
            raise ValueError(
                "covariance_type must be one of 'full', 'tied', 'diag', "
                f"'spherical'; got {covariance_type!r}"
            )
        self.n_components = int(n_components)
        self.covariance_type = covariance_type
        self.max_iter = int(max_iter)
        self.n_init = int(n_init)
        self.tol = float(tol)
        self.reg_covar = float(reg_covar)
        self.random_state = random_state
        self.device = torch.device(device)
        self.dtype = dtype

        self.weights_ = None
        self.means_ = None
        self.covariances_ = None
        self.converged_ = False
        self.n_iter_ = 0
        self.lower_bound_ = None
        self._params: Optional[GMMParams] = None

    def fit(self, X, sample_weight=None) -> "GaussianMixture":
        """Fit the weighted GMM; returns self."""
        X = _as_tensor(X, self.dtype, self.device)
        if sample_weight is None:
            sample_weight = torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)
        else:
            sample_weight = _as_tensor(sample_weight, X.dtype, X.device)
        key = threefry.prng_key(0 if self.random_state is None else self.random_state)
        params = gmm_fit(key, X, sample_weight, self.n_components,
                         covariance_type=self.covariance_type, max_iter=self.max_iter,
                         tol=self.tol, reg_covar=self.reg_covar, n_init=self.n_init)
        self._params = params
        self.weights_ = _numpy(params.weights)
        self.means_ = _numpy(params.means)
        self.covariances_ = _numpy(params.covariances)
        self.n_iter_ = int(params.n_iter)
        self.converged_ = self.n_iter_ < self.max_iter
        self.lower_bound_ = float(params.lower_bound)
        return self

    def _require_fitted(self):
        if self._params is None:
            raise ValueError("GaussianMixture is not fitted; call fit() first.")

    def _data(self, X) -> torch.Tensor:
        return _as_tensor(X, self._params.means.dtype, self.device)

    def predict(self, X) -> np.ndarray:
        """Hard labels by max posterior."""
        self._require_fitted()
        return _numpy(gmm_predict(self._params, self._data(X), reg_covar=self.reg_covar))

    def bic(self, X) -> float:
        """BIC with per-type free-parameter counts."""
        self._require_fitted()
        return float(gmm_bic(self._params, self._data(X), covariance_type=self.covariance_type,
                             reg_covar=self.reg_covar))


class HierarchicalGaussianMixture:
    """Top-down bisecting clusterer over `hgm_fit` (cluster.py:1024-1137):
    the JAX class's keywords, defaults, messages, `labels_`, `n_clusters_`,
    `predict`, `predict_proba` and `_bic_tolerance`; results are numpy
    arrays. The leaf fits' k-means++ uniforms come from `PRNGKey(seed)`
    (`fit_uniforms`). `device` and `dtype` as for `GaussianMixture`.
    """

    def __init__(
        self,
        n_init: int = 1,
        max_iterations: int = 1000,
        min_points: Optional[int] = None,
        threshold_modifier: float = 1.0,
        covariance_type: str = "full",
        verbose: bool = False,
        normalize: bool = False,
        k_max: int = 16,
        seed: int = 42,
        split_all: bool = False,
        leaf_fit_points: Optional[int] = None,
        device="cuda",
        dtype=None,
    ):
        if threshold_modifier <= 0:
            raise ValueError("threshold_modifier must be positive.")
        self.n_init = n_init
        self.max_iterations = max_iterations
        self.min_points = min_points
        self.threshold_modifier = float(threshold_modifier)
        self.covariance_type = covariance_type
        self.verbose = verbose
        self.normalize = normalize
        self.k_max = k_max
        self.seed = seed
        self.split_all = split_all
        self.leaf_fit_points = leaf_fit_points
        self.device = torch.device(device)
        self.dtype = dtype
        self.model: Optional[ClusterModel] = None
        self._labels: Optional[torch.Tensor] = None
        self._n_leaves = 0

    @property
    def labels_(self) -> Optional[np.ndarray]:
        return None if self._labels is None else _numpy(self._labels)

    @property
    def n_clusters_(self) -> int:
        return int(self._n_leaves)

    @staticmethod
    def _bic_tolerance(n_features: int, weights: np.ndarray) -> float:
        """n_params * log(N_eff) gate (cluster.py:1077-1084)."""
        w = weights / np.sum(weights)
        n_eff = 1.0 / np.sum(w * w)
        d = n_features
        n_params = d + d * (d + 1) / 2 + 1
        return float(n_params * np.log(n_eff))

    def fit(self, X, sample_weight=None, mask=None) -> "HierarchicalGaussianMixture":
        """Fit on (n, d) data; `mask` marks the valid rows."""
        X = _as_tensor(X, self.dtype, self.device)
        n, d = X.shape
        if sample_weight is None:
            sample_weight = torch.ones((n,), dtype=X.dtype, device=X.device)
        else:
            sample_weight = _as_tensor(sample_weight, X.dtype, X.device)
        if mask is None:
            mask = torch.ones((n,), dtype=torch.bool, device=X.device)
        elif isinstance(mask, torch.Tensor):
            mask = mask.to(device=X.device, dtype=torch.bool)
        else:
            mask = torch.as_tensor(np.asarray(mask, dtype=bool), device=X.device)
        min_points = self.min_points if self.min_points is not None else 2 * d
        self.model, self._labels, self._n_leaves = hgm_fit(
            X, sample_weight, mask, min_points, self.threshold_modifier, self.k_max,
            max_rounds=min(self.max_iterations, self.k_max - 1), normalize=self.normalize,
            split_all=self.split_all, leaf_fit_points=self.leaf_fit_points,
            uniforms=fit_uniforms(self.k_max, self.seed, X.device, X.dtype, self.n_init),
            covariance_type=self.covariance_type,
        )
        if self.verbose:
            print(f"HGM fit: {self.n_clusters_} leaves")
        return self

    def _data(self, X) -> torch.Tensor:
        if self.model is None:
            raise ValueError("The model has not been fitted yet.")
        return _as_tensor(X, self.model.centers.dtype, self.device)

    def predict(self, X) -> np.ndarray:
        return _numpy(cluster_predict(self.model, self._data(X)))

    def predict_proba(self, X) -> np.ndarray:
        proba = _numpy(cluster_predict_proba(self.model, self._data(X)))
        return proba[:, : self.n_clusters_]
