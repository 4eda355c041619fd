"""Generic IRLS Gauss-Newton / Levenberg-Marquardt engine — port of
``sdvo_tpu.optim.optimizer``: ``LMSettings``, ``OptimizerStatus``,
``tukey_weights``, ``robust_sigma``, ``_solve_damped``, ``optimize_lm`` (the
three damping methods, the normalized gain ratio, the abort gates, the
relative-decrease exit) and ``optimize_gn``.

The JAX package runs the solve as one ``lax.while_loop`` with select-based
rollback; here it is a Python loop that reads ``done`` each iteration. The
per-frame host path that calls it synchronises with the host at every stage
anyway. The state update is the same select (``torch.where`` on ``accept``),
so the iterates match the reference's step for step.

``params`` is any nested tuple / NamedTuple of tensors (``SE3``, a point
block); the caller supplies the retraction ``update_fn(params, dx)``.

The D ≤ 8 solve is the reference's unrolled Cholesky with its relative ridge
and one strong-ridge retry: those ridges are part of the numbers the solve
returns, so no library factorisation stands in for it.

``LMSettings.visualize`` emits the post-solve diagnostics (residuals,
weights, visibility and JᵀWJ at the final iterate, as numpy arrays: a host
read, taken only then) to the sink installed with ``set_diagnostics_sink``,
e.g. ``viz.diagnostics.FileDiagnosticsSink``: the reference's
Optimizer::visualize.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, NamedTuple, Tuple

import torch

from sdvo_tpu_torch.geometry.robust import masked_mad, masked_mad_hist

# the sink of the post-solve diagnostics, fn(tag, residuals, weights,
# visible, H) on numpy arrays, or None (set_diagnostics_sink)
_DIAGNOSTICS_SINK = None


class LevenbergMethod(enum.Enum):
    MARQUARDT = "marquardt"  # H += lambda * diag(H); lambda /9 or *11
    QUADRATIC = "quadratic"  # line-fit damping: alpha rescales the accepted step
    NIELSEN = "nielsen"  # H += lambda * I; Nielsen's nu schedule


class OptimizerStatus:
    SUCCESS = 0
    NON_SUFF_POINTS = 1
    MAX_COFF_DX = 2
    NON_FINITE_DX = 3
    SMALL_STEP = 4
    LAMBDA_BOUND = 5
    FAILED = 6


class LMSettings(NamedTuple):
    max_iterations: int = 20
    min_chi2: float = 1e-1
    min_step: float = 1e-16
    max_dx: float = 1e3
    init_lambda: float = 1e-2
    lambda_min: float = 1e-14
    lambda_max: float = 1e14
    method: str = "nielsen"
    estimator: str = "tukey"  # any key of estimators.MESTIMATORS
    mad: str = "exact"  # "exact": sort-based MAD; "hist": histogram-CDF MAD
    min_rel_decrease: float = 0.0  # 0 = run to max_iterations
    freeze_sigma: bool = False  # robust scale once, from the initial residuals
    visualize: bool = False  # emit post-solve diagnostics to the sink (set_diagnostics_sink)
    viz_tag: str = ""


def set_diagnostics_sink(fn) -> None:
    """Install fn(tag, residuals, weights, visible, H) — numpy arrays — or None."""
    global _DIAGNOSTICS_SINK
    _DIAGNOSTICS_SINK = fn


def _dispatch_diagnostics(tag: str, r, w, vis, H) -> None:
    """Hand one solve's diagnostics to the sink, as numpy arrays."""
    if _DIAGNOSTICS_SINK is not None:
        _DIAGNOSTICS_SINK(tag, *(x.detach().cpu().numpy() for x in (r, w, vis, H)))


def tukey_weights(residuals: torch.Tensor, visible: torch.Tensor, mad: str = "exact",
                  sigma=None) -> torch.Tensor:
    """sigma = 1.4826·MAD over visible residuals, c = 4.6851σ, zero outside."""
    if sigma is None:
        sigma = robust_sigma(residuals, visible, mad)
    sigma = torch.clamp(sigma, min=torch.finfo(residuals.dtype).eps)
    c = 4.6851 * sigma
    w = (1.0 - (residuals * residuals) / (c * c)) ** 2
    w = torch.where(torch.abs(residuals) <= c, w, torch.zeros_like(w))
    return torch.where(visible, w, torch.zeros_like(w))


def robust_sigma(residuals: torch.Tensor, visible: torch.Tensor, mad: str = "exact") -> torch.Tensor:
    mad_fn = masked_mad_hist if mad == "hist" else masked_mad
    return 1.4826 * mad_fn(residuals, visible)


def _weights_for(estimator: str, residuals, visible, mad: str = "exact", sigma=None):
    if estimator == "tukey":
        return tukey_weights(residuals, visible, mad, sigma)
    from sdvo_tpu_torch.optim.estimators import mestimator_weights

    return mestimator_weights(residuals, estimator, visible)


def _chi2(residuals, weights, visible):
    r2 = residuals * residuals * weights
    return torch.where(visible, r2, torch.zeros_like(r2)).sum()


_UNROLL_MAX_D = 8


def _chol_solve_unrolled(A: torch.Tensor, g: torch.Tensor):
    """Cholesky factor and solve, unrolled in scalar operations, in the
    reference's order. Returns (dx, ok): ok = every pivot positive and dx
    finite."""
    D = A.shape[0]
    tiny = torch.finfo(A.dtype).tiny
    L = [[None] * D for _ in range(D)]
    ok = torch.ones((), dtype=torch.bool, device=A.device)
    for i in range(D):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                ok = ok & (s > 0.0)
                L[i][j] = torch.sqrt(torch.clamp(s, min=tiny))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * D
    for i in range(D):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * D
    for i in reversed(range(D)):
        s = y[i]
        for k in range(i + 1, D):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    dx = torch.stack(x)
    return dx, ok & torch.isfinite(dx).all()


def _chol_solve_library(A: torch.Tensor, g: torch.Tensor):
    L, info = torch.linalg.cholesky_ex(A)
    ok = (info == 0) & torch.isfinite(L).all()
    L = torch.where(ok, L, torch.eye(A.shape[0], dtype=A.dtype, device=A.device))
    dx = torch.cholesky_solve(g[:, None], L)[:, 0]
    return dx, ok & torch.isfinite(dx).all()


def _solve_damped(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H dx = g by Cholesky with a diagonal fall-back.

    D ≤ 8: a relative ridge ``1e-7·diag(H)`` first; where that system is
    indefinite, one retry with the strong ridge ``1e-3·max|diag|``; where
    that fails too, dx = 0. Larger D: plain Cholesky, then ``1e-6·trace`` on
    the diagonal."""
    dtype = H.dtype
    if H.shape[0] <= _UNROLL_MAX_D:
        # on the host the unrolled chain is ~150 scalar operations; a device
        # tensor would pay a launch for each, so the 6×6 system crosses once
        dev = H.device
        Hc, gc = H.cpu(), g.cpu()
        diagH = torch.diagonal(Hc)
        ridge = 1e-7 * diagH + torch.finfo(dtype).tiny
        dx0, ok0 = _chol_solve_unrolled(Hc + torch.diag(ridge), gc)
        strong = 1e-3 * torch.abs(diagH).max() + 1e-12
        dx1, ok1 = _chol_solve_unrolled(Hc + torch.diag(ridge + strong), gc)
        dx = torch.where(ok0, dx0, torch.where(ok1, dx1, torch.zeros_like(dx1)))
        return dx.to(dev)
    eye = torch.eye(H.shape[0], dtype=dtype, device=H.device)
    dx0, ok0 = _chol_solve_library(H, g)
    dx1, _ = _chol_solve_library(H + 1e-6 * torch.trace(H) * eye, g)
    return torch.where(ok0, dx0, dx1)


def tree_where(cond: torch.Tensor, a, b):
    """``torch.where(cond, a, b)`` over matching nested tuples / NamedTuples
    of tensors; a leaf that is no tensor is taken from ``a``."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    if isinstance(a, tuple):
        vals = [tree_where(cond, x, y) for x, y in zip(a, b)]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    return a


def optimize_lm(params0: Any, residual_fn: Callable[[Any], Tuple[torch.Tensor, torch.Tensor]],
                jacobian_fn: Callable[[Any], torch.Tensor],
                update_fn: Callable[[Any, torch.Tensor], Any],
                settings: LMSettings = LMSettings()) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt with IRLS robust weights.

    ``residual_fn``: params → (residuals (N,), visible (N,) bool);
    ``jacobian_fn``: params → J (N, D); ``update_fn``: the retraction with
    its sign convention. Returns (params, rmse, status); a failed or aborted
    step leaves the last accepted iterate."""
    method = settings.method if isinstance(settings.method, LevenbergMethod) \
        else LevenbergMethod(settings.method)
    use_marquardt = method == LevenbergMethod.MARQUARDT
    use_quadratic = method == LevenbergMethod.QUADRATIC

    r, vis = residual_fn(params0)
    dtype, dev = r.dtype, r.device
    tiny = torch.finfo(dtype).tiny
    sigma0 = (robust_sigma(r, vis, settings.mad)
              if (settings.freeze_sigma and settings.estimator == "tukey") else None)

    def weights(res, visible):
        return _weights_for(settings.estimator, res, visible, settings.mad, sigma0)

    w = weights(r, vis)
    chi = _chi2(r, w, vis)
    params = params0
    lam = torch.tensor(settings.init_lambda, dtype=dtype, device=dev)
    nu = torch.tensor(2.0, dtype=dtype, device=dev)
    status = torch.tensor(OptimizerStatus.SUCCESS, dtype=torch.int32, device=dev)

    def code(value):
        return torch.full_like(status, value)

    for iteration in range(settings.max_iterations):
        J = jacobian_fn(params)
        D = J.shape[-1]
        wv = torch.where(vis, w, torch.zeros_like(w))
        Jw = J * wv[:, None]
        H = J.T @ Jw
        g = Jw.T @ r
        diagH = torch.diagonal(H)
        if not use_marquardt and iteration == 0:
            lam = lam * diagH.max()
        if use_marquardt:
            H_damped = H + torch.diag(lam * diagH)
        else:
            H_damped = H + lam * torch.eye(D, dtype=dtype, device=dev)
        dx = _solve_damped(H_damped, g)

        bad_dx = dx.max() > settings.max_dx
        nonfinite = ~torch.isfinite(dx).all()
        small_step = (dx * dx).sum() < settings.min_step
        lam_bound = (lam >= settings.lambda_max) | (lam <= settings.lambda_min)

        new_params = update_fn(params, dx)
        r_new, vis_new = residual_fn(new_params)
        w_new = weights(r_new, vis_new)
        chi_new = _chi2(r_new, w_new, vis_new)

        if use_quadratic:
            gTdx = (g * dx).sum()
            diff = chi - chi_new
            denom_a = 0.5 * diff + 2.0 * gTdx
            alpha = torch.where(torch.abs(denom_a) > tiny, gTdx / denom_a, torch.ones_like(gTdx))
            alpha = torch.where(torch.isfinite(alpha) & (alpha > 0.0), alpha, torch.ones_like(alpha))
            new_params = update_fn(params, alpha * dx)
            r_new, vis_new = residual_fn(new_params)
            w_new = weights(r_new, vis_new)
            chi_new = _chi2(r_new, w_new, vis_new)

        if use_marquardt:
            pred = (dx * (lam * diagH * dx + g)).sum()
        else:
            pred = (dx * (lam * dx + g)).sum()
        rho = (chi - chi_new) / torch.clamp(pred, min=tiny)
        success = (chi - chi_new) > 0.0

        if use_marquardt:
            lam_next = torch.where(success, torch.clamp(lam / 9.0, min=1e-7),
                                   torch.clamp(lam * 11.0, max=1e7))
            nu_next = nu
        elif use_quadratic:
            lam_next = torch.where(success, torch.clamp(lam / (1.0 + alpha), min=1e-7),
                                   lam + torch.abs(diff) / torch.clamp(2.0 * alpha, min=tiny))
            nu_next = nu
        else:
            lam_next = torch.where(
                success, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0), lam * nu)
            nu_next = torch.where(success, torch.full_like(nu, 2.0), nu * 2.0)

        abort = bad_dx | nonfinite | small_step | lam_bound
        accept = success & ~abort
        if settings.min_rel_decrease > 0.0:
            chi_ref = torch.clamp(chi, min=tiny)
            rel_dec = (chi - chi_new) / chi_ref
            rel_pred = pred / chi_ref
            abort = abort | (accept & (rel_dec < settings.min_rel_decrease)) | (
                rel_pred < 0.1 * settings.min_rel_decrease)

        params = tree_where(accept, new_params, params)
        status = torch.where(bad_dx, code(OptimizerStatus.MAX_COFF_DX), status)
        status = torch.where(nonfinite, code(OptimizerStatus.NON_FINITE_DX), status)
        status = torch.where(small_step, code(OptimizerStatus.SMALL_STEP), status)
        status = torch.where(lam_bound & ~small_step, code(OptimizerStatus.LAMBDA_BOUND), status)
        r = torch.where(accept, r_new, r)
        w = torch.where(accept, w_new, w)
        vis = torch.where(accept, vis_new, vis)
        chi = torch.where(accept, chi_new, chi)
        lam, nu = lam_next, nu_next
        if bool(abort):
            break

    n_vis = torch.clamp(vis.to(dtype).sum(), min=1.0)
    if settings.visualize:
        # post-solve diagnostics at the final iterate
        J_f = jacobian_fn(params)
        H_f = J_f.T @ (J_f * torch.where(vis, w, torch.zeros_like(w))[:, None])
        _dispatch_diagnostics(settings.viz_tag, r, w, vis, H_f)
    return params, torch.sqrt(chi / n_vis), status


def optimize_gn(params0: Any, residual_fn, jacobian_fn, update_fn,
                settings: LMSettings = LMSettings()) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """Plain Gauss-Newton: ``max_iterations`` steps, no damping, no rollback.
    The rmse is that of the residuals the last step started from."""
    r0, _ = residual_fn(params0)
    dtype, dev = r0.dtype, r0.device
    params = params0
    chi2 = torch.zeros((), dtype=dtype, device=dev)
    nvis = torch.ones((), dtype=dtype, device=dev)
    for _ in range(settings.max_iterations):
        r, vis = residual_fn(params)
        w = _weights_for(settings.estimator, r, vis, settings.mad)
        J = jacobian_fn(params)
        Jw = J * torch.where(vis, w, torch.zeros_like(w))[:, None]
        dx = _solve_damped(J.T @ Jw, Jw.T @ r)
        params = update_fn(params, dx)
        chi2, nvis = _chi2(r, w, vis), vis.to(dtype).sum()
    rmse = torch.sqrt(chi2 / torch.clamp(nvis, min=1.0))
    return params, rmse, torch.tensor(OptimizerStatus.SUCCESS, dtype=torch.int32, device=dev)
