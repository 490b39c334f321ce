"""Weighted Gaussian-mixture EM and hierarchical BIC-gated clustering.

Counterpart of tempest_tpu/cluster.py for the covariance type "full", the
one the sampler uses (tempest_tpu/fused.py:141); the other types wait for
the `GaussianMixture` facades (ROADMAP queue 1, item 11). The parts:

- `_log_gauss` (:49-74) with the identity fallback where the Cholesky
  factor is not finite (`cholesky_ex`'s info, never a `try`);
- the k-means++ start `_kmeanspp_init` (:77-120), which takes its uniforms
  as an argument;
- `_m_step`, `_e_step`, `_mixture_scores` and `_gmm_fit_scores`
  (:123-280), the K = 1 closed forms and `_bic_from_lik` (:309-400);
- `ClusterModel`, `single_cluster_model`, `_predict_scores` and
  `cluster_predict` (:553-664);
- `_split_round` (:678-804), `hgm_fit` with the `split_all` doubling
  prefix (:814-984) and `_final_refit` (:988-1021).

JAX vmaps the leaf fits; here every function takes a leading batch axis B
of leaves. The vmapped EM `while_loop` becomes a Python loop over the whole
batch with a `done` flag per leaf: a leaf that is done (or at `max_iter`)
keeps its parameters while the others iterate, as under vmap; the loop
reads one boolean from the device per EM iteration. The split rounds read
the leaf count once per round.

The clustering's only randomness is two k-means++ uniforms per leaf slot,
from the fixed fit key; `fit_uniforms` computes them as `jax.random` does,
so with the same data the fit agrees with JAX value for value.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .utils import threefry

_EPS = 1e-10
_LOG2PI = math.log(2.0 * math.pi)
_REG_COVAR = 1e-6
FIT_SEED = 42  # tempest_tpu/fused.py:134, the reference's np.random.seed(42)


class GMMParams(NamedTuple):
    weights: torch.Tensor  # (B, K) mixture weights
    means: torch.Tensor  # (B, K, d)
    covariances: torch.Tensor  # (B, K, d, d)
    lower_bound: torch.Tensor  # (B,)
    n_iter: torch.Tensor  # (B,) int32


def fit_uniforms(k_max: int, seed: int = FIT_SEED, device=None) -> torch.Tensor:
    """(k_max, 2) float32 k-means++ uniforms of leaf slots 0..k_max-1:
    uniform(split(split(PRNGKey(seed), k_max)[i], 2)[j]) (cluster.py:86,
    :738; one EM start per leaf)."""
    leaves = threefry.split(threefry.prng_key(seed), k_max)
    vals = [[threefry.uniform(k) for k in threefry.split(leaf, 2)] for leaf in leaves]
    return torch.tensor(vals, dtype=torch.float32, device=device)


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


def _m_step(X, resp, sample_weight):
    """Weighted M-step, full covariances (cluster.py:123-133, 151).
    X (B, n, d), resp (B, n, K), sample_weight (B, n)."""
    wresp = resp * sample_weight[..., None]  # (B, n, K)
    nk = torch.sum(wresp, dim=1)  # (B, K)
    pi = nk / torch.clamp(torch.sum(nk, dim=1, keepdim=True), min=_EPS)
    means = (wresp.transpose(1, 2) @ X) / (nk[..., None] + _EPS)
    diff = X[:, :, None, :] - means[:, None, :, :]  # (B, n, K, d)
    covs = torch.einsum("bnk,bnki,bnkj->bkij", wresp, diff, diff)
    return pi, means, covs / (nk[..., None, None] + _EPS)


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


def _gmm_fit_scores(
    X,
    sample_weight,
    n_components: int,
    uniforms,
    max_iter: int = 1000,
    tol: float = 1e-3,
    reg_covar: float = _REG_COVAR,
):
    """Weighted EM with one start per leaf (cluster.py:197-270, n_init=1).

    Returns (params, log_probs (B, K, n), lik (B, n)) at the final
    parameters. Convergence compares the bound at the current parameters
    with the previous one; a converged leaf keeps its pre-M-step
    parameters (PARITY.md deviation 5), as in JAX.
    """
    B = X.shape[0]
    sw = _normalized(sample_weight)
    resp = _kmeanspp_init(X, sw, n_components, uniforms)
    pi, means, covs = _m_step(X, resp, sw)
    lb = torch.full((B,), float("-inf"), dtype=X.dtype, device=X.device)
    n_iter = torch.zeros((B,), dtype=torch.int32, device=X.device)
    done = torch.zeros((B,), dtype=torch.bool, device=X.device)
    while True:
        active = ~done & (n_iter < max_iter)
        if not bool(torch.any(active)):  # one host sync per EM iteration
            break
        resp, new_lb = _e_step(X, pi, means, covs, reg_covar, sw)
        new_done = (new_lb - lb) < tol
        pi2, means2, covs2 = _m_step(X, resp, sw)
        keep = new_done | ~active
        pi = torch.where(keep[:, None], pi, pi2)
        means = torch.where(keep[:, None, None], means, means2)
        covs = torch.where(keep[:, None, None, None], covs, covs2)
        lb = torch.where(keep, lb, new_lb)
        n_iter = n_iter + active.to(torch.int32)
        done = torch.where(active, new_done, done)
    log_probs, lik = _mixture_scores(X, pi, means, covs, reg_covar)
    final_lb = torch.sum(sw * torch.log(lik + _EPS), dim=1)
    return GMMParams(pi, means, covs, final_lb, n_iter), log_probs, lik


def _single_component_params(X, sample_weight) -> GMMParams:
    """K = 1 closed-form M-step without the density pass (cluster.py:349-370);
    lower_bound is 0 and must not be read."""
    B, n, _ = X.shape
    resp = torch.ones((B, n, 1), dtype=X.dtype, device=X.device)
    pi, means, covs = _m_step(X, resp, _normalized(sample_weight))
    zeros = torch.zeros((B,), dtype=X.dtype, device=X.device)
    return GMMParams(pi, means, covs, zeros, torch.ones((B,), dtype=torch.int32, device=X.device))


def _single_component_fit_scores(X, sample_weight, reg_covar: float = _REG_COVAR):
    """Exact K = 1 fit and its per-point likelihood (B, n) (cluster.py:309-337)."""
    p = _single_component_params(X, sample_weight)
    _, lik = _mixture_scores(X, p.weights, p.means, p.covariances, reg_covar)
    lb = torch.sum(_normalized(sample_weight) * torch.log(lik + _EPS), dim=1)
    return p._replace(lower_bound=lb), lik


def _bic_from_lik(lik, mask, n_components: int, n_features: int) -> torch.Tensor:
    """BIC from a per-point mixture likelihood, full covariances
    (cluster.py:373-400). lik, mask: (B, n)."""
    d, K = n_features, n_components
    n_parameters = (K - 1) + K * d + K * d * (d + 1) / 2
    n_leaf = torch.sum(mask, dim=-1).to(lik.dtype)
    ll = torch.sum(torch.where(mask, torch.log(lik + _EPS), torch.zeros_like(lik)), dim=-1)
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


# ---------------------------------------------------------------------------
# Hierarchical (bisecting) clustering with the BIC gate
# ---------------------------------------------------------------------------
def _top_k_rows(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` per row: the k largest, ties to the lower index."""
    vals, idx = torch.sort(values, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _split_round(
    uniforms: torch.Tensor,
    Xw: torch.Tensor,
    sample_weight: torch.Tensor,
    labels: torch.Tensor,
    n_leaves: int,
    min_points: int,
    threshold_modifier: float,
    k_max: int,
    n_sub: Optional[int] = None,
    k_slots: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """The K = 1 against K = 2 split test of every leaf slot < k_slots
    (cluster.py:678-804). `uniforms` (k_max, 2) are the leaves' k-means++
    draws; `n_sub` caps each leaf's EM set to its top members by weight,
    while the BIC gate and the child labels use the full membership."""
    n, d = Xw.shape
    k_slots = k_max if k_slots is None else k_slots
    dtype, dev = Xw.dtype, Xw.device
    leaf_ids = torch.arange(k_slots, device=dev)
    members = labels[None, :] == leaf_ids[:, None]  # (k_slots, n)
    leaf_w = torch.where(members, sample_weight[None, :], torch.zeros((), dtype=dtype, device=dev))
    w_tot = torch.sum(leaf_w, dim=1)
    n_members = torch.sum(members, dim=1)

    # threshold = modifier * n_params * log(N_eff) (cluster.py:732-736)
    w_norm = leaf_w / torch.clamp(w_tot, min=_EPS)[:, None]
    n_eff = 1.0 / torch.clamp(torch.sum(w_norm**2, dim=1), min=_EPS)
    n_params = d + d * (d + 1) / 2 + 1
    modifier = torch.tensor(threshold_modifier, dtype=dtype, device=dev)
    thresholds = modifier * n_params * torch.log(torch.clamp(n_eff, min=1.0))

    u = uniforms[:k_slots]
    X_all = Xw.expand(k_slots, n, d)
    if n_sub is not None and n_sub < n:
        w_sub, sub_idx = _top_k_rows(leaf_w, n_sub)
        X_sub = Xw[sub_idx]  # (k_slots, n_sub, d)
        p1 = _single_component_params(X_sub, w_sub)
        p2 = _gmm_fit_scores(X_sub, w_sub, 2, u)[0]
        _, lik1 = _mixture_scores(X_all, p1.weights, p1.means, p1.covariances, _REG_COVAR)
        scores2, lik2 = _mixture_scores(X_all, p2.weights, p2.means, p2.covariances, _REG_COVAR)
    else:
        p1, lik1 = _single_component_fit_scores(X_all, leaf_w)
        p2, scores2, lik2 = _gmm_fit_scores(X_all, leaf_w, 2, u)
    improvement = _bic_from_lik(lik1, members, 1, d) - _bic_from_lik(lik2, members, 2, d)

    # Hard assignment by max posterior, from the fit's scores (cluster.py:784-790)
    child = torch.argmax(torch.log(p2.weights + _EPS)[:, :, None] + scores2, dim=1)
    c0 = torch.sum(members & (child == 0), dim=1)
    c1 = torch.sum(members & (child == 1), dim=1)
    eligible = (
        (leaf_ids < n_leaves)
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


def _final_refit(Xw, sample_weight, labels, k_max: int):
    """Per-leaf K = 1 refits for centers and covariances (cluster.py:987-1021)."""
    n, d = Xw.shape
    members = labels[None, :] == torch.arange(k_max, device=Xw.device)[:, None]
    leaf_w = torch.where(members, sample_weight[None, :], torch.zeros_like(sample_weight[None, :]))
    p = _single_component_params(Xw.expand(k_max, n, d), leaf_w)
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
) -> Tuple[ClusterModel, torch.Tensor, int]:
    """The whole hierarchical fit, covariance type "full" (cluster.py:814-984).

    Each round tests every leaf for a K = 2 split and splits the best
    eligible one (or, with `split_all`, every eligible one, with the
    doubling prefix of leaf-slot widths 1, 2, 4, ...), until nothing is
    eligible, k_max leaves exist or `max_rounds` rounds ran. `uniforms`
    (k_max, 2) default to those of the fixed fit key (`fit_uniforms`).
    Returns (model, labels (n,) int32 with -1 on masked rows, n_leaves).
    """
    n, d = X.shape
    dtype, dev = X.dtype, X.device
    if uniforms is None:
        uniforms = fit_uniforms(k_max, device=dev)
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

    labels = torch.where(mask, 0, -1).to(torch.int32)
    n_leaves, go, rounds = 1, True, 0

    def round_step(labels, n_leaves, k_slots):
        out = _split_round(
            uniforms, Xw, sw, labels, n_leaves, min_points, threshold_modifier, k_max,
            leaf_fit_points, k_slots,
        )
        if split_all:
            # Every eligible leaf splits; new slots in leaf-id order, and
            # those that would pass k_max wait for the next round.
            elig = out["eligible"]
            rank = torch.cumsum(elig.to(torch.int32), dim=0, dtype=torch.int32) - 1
            new_ids = n_leaves + rank
            can = elig & (new_ids < k_max)
            safe = torch.clamp(labels, 0, k_slots - 1).long()
            sample_child = out["child"].to(torch.int32)[safe, torch.arange(n, device=dev)]
            move = (labels >= 0) & (labels < k_slots) & can[safe] & (sample_child == 1)
            labels = torch.where(move, new_ids[safe], labels)
            n_split = int(torch.sum(can))  # one host sync per round
            return labels, n_leaves + n_split, n_split > 0
        if not bool(torch.any(out["eligible"])):
            return labels, n_leaves, False
        # Child 0 keeps the parent's slot, child 1 takes the next free one.
        leaf = torch.argmax(out["improvement"])
        child_row = out["child"][leaf].to(torch.int32)
        moved = (labels == leaf) & (child_row == 1)
        return torch.where(moved, n_leaves, labels).to(torch.int32), n_leaves + 1, True

    n_prefix = 0
    if split_all:
        # Round r holds at most 2^r leaves, so it tests only 2^r slots.
        while (1 << n_prefix) < k_max and n_prefix < max_rounds:
            if go and n_leaves < k_max:
                labels, n_leaves, go = round_step(labels, n_leaves, 1 << n_prefix)
                rounds += 1
            n_prefix += 1
    if max_rounds > n_prefix or not split_all:
        while go and n_leaves < k_max and rounds < max_rounds:
            labels, n_leaves, go = round_step(labels, n_leaves, k_max)
            rounds += 1

    centers, covs, cweights = _final_refit(Xw, sw, labels, k_max)
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
