"""LBFGS / OWL-QN over lanes of independent problems (port of
photon_ml_tpu/optim/lbfgs.py).

The reference wraps Breeze's LBFGS/OWLQN (optimization/LBFGS.scala:41-140:
OWL-QN when the objective carries an L1 term; defaults m=10 / 80 iterations /
tol 1e-7). The JAX package runs the solve as one ``lax.while_loop``; here it
is a Python loop over device tensors with the same arithmetic:

  * curvature pairs (S, Y, rho) in ``(L, m, D)`` ring buffers, newest-first
    two-loop recursion;
  * a backtracking Armijo line search on the step actually taken;
  * L1 handled orthant-wise (pseudo-gradient + orthant projection), enabled
    by ``l1_weight > 0``.

Every state tensor carries a leading lane axis ``L``: a lane is one problem,
and lanes that have converged are masked no-ops while the others advance.
The fixed-effect GLM solve is one lane; the random-effect coordinate can
batch entities as lanes. The loop tests convergence on the host once per
iteration and once per line-search step.

``value_and_grad_fn`` maps ``(L, D)`` coefficients to ``((L,), (L, D))``
smooth values and gradients, with L2 already folded in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from photon_ml_tpu_torch.optim.common import OptimizerConfig, OptResult
from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor
LaneFn = Callable[[Tensor], Tuple[Tensor, Tensor]]

_EPS = 1e-10
_C1 = 1e-4  # Armijo sufficient-decrease constant


def _pseudo_gradient(w: Tensor, g: Tensor, l1: Tensor) -> Tensor:
    """OWL-QN pseudo-gradient of f(w) + l1*||w||_1 (= g when l1 == 0)."""
    zero = torch.zeros_like(g)
    at_zero = torch.where(g > l1, g - l1, torch.where(g < -l1, g + l1, zero))
    return torch.where(w != 0.0, g + l1 * torch.sign(w), at_zero)


def _gather(buf: Tensor, pos: Tensor) -> Tensor:
    """``buf[lane, pos[lane]]`` for every lane."""
    return buf[torch.arange(buf.shape[0], device=buf.device), pos]


def _two_loop_direction(pg: Tensor, S: Tensor, Y: Tensor, rho: Tensor,
                        k: Tensor, m: int, depth: int) -> Tensor:
    """Limited-memory two-loop recursion over the ring buffers.

    ``depth`` (<= m) is a host-side bound on the pairs any lane holds; the
    recursion positions beyond a lane's own count are masked, so the loops
    may stop at ``depth`` with the same result as running all m.
    """
    n_valid = torch.clamp(k, max=m)
    q = pg
    alphas = []
    for j in range(depth):
        pos = torch.remainder(k - 1 - j, m)
        valid = j < n_valid
        a = torch.where(valid, _gather(rho, pos) * torch.sum(_gather(S, pos) * q, -1),
                        torch.zeros_like(n_valid, dtype=pg.dtype))
        q = q - a[:, None] * _gather(Y, pos)
        alphas.append(a)

    newest = torch.remainder(k - 1, m)
    s_new, y_new = _gather(S, newest), _gather(Y, newest)
    sy = torch.sum(s_new * y_new, -1)
    yy = torch.sum(y_new * y_new, -1)
    gamma = torch.where(k > 0, sy / torch.clamp_min(yy, _EPS), torch.ones_like(sy))
    r = gamma[:, None] * q
    for j in reversed(range(depth)):
        pos = torch.remainder(k - 1 - j, m)
        valid = j < n_valid
        b = _gather(rho, pos) * torch.sum(_gather(Y, pos) * r, -1)
        coef = torch.where(valid, alphas[j] - b, torch.zeros_like(b))
        r = r + coef[:, None] * _gather(S, pos)
    return -r


@dataclasses.dataclass
class LBFGSState:
    """Carried solve state; every field has the leading lane axis. ``F0``
    and ``pg0_norm`` (the convergence references fixed at init) ride in the
    state so a paused state resumes exactly."""

    w: Tensor  # (L, D)
    f: Tensor  # (L,) smooth value
    g: Tensor  # (L, D) smooth gradient
    F: Tensor  # (L,) f + l1*||w||_1
    pg_norm: Tensor  # (L,)
    S: Tensor  # (L, m, D)
    Y: Tensor  # (L, m, D)
    rho: Tensor  # (L, m)
    k: Tensor  # (L,) int64 — curvature pairs ever stored
    iteration: Tensor  # (L,) int64
    reason: Tensor  # (L,) int64 ConvergenceReason
    value_history: Tensor  # (L, max_iter + 1)
    grad_norm_history: Tensor  # (L, max_iter + 1)
    w_history: Optional[Tensor]  # (L, max_iter + 1, D) if tracking
    F0: Tensor  # (L,)
    pg0_norm: Tensor  # (L,)


def _problem_fns(l1: Tensor):
    def F_of(w, f):
        return f + l1[:, 0] * torch.sum(torch.abs(w), -1)

    def reduced_pg(w, g):
        return _pseudo_gradient(w, g, l1)

    return F_of, reduced_pg


def _lane_l1(l1_weight, lanes: int, like: Tensor) -> Tensor:
    l1 = torch.as_tensor(l1_weight, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(l1.reshape(-1, 1), (lanes, 1))


def lbfgs_init_(value_and_grad_fn: LaneFn, w0: Tensor, config: OptimizerConfig,
                l1_weight=0.0, track_coefficients: bool = False) -> LBFGSState:
    """Fresh solve state at ``w0`` (L, D) — one objective evaluation."""
    m, max_iter = config.num_corrections, config.max_iterations
    lanes, dim = w0.shape
    opts = dict(dtype=w0.dtype, device=w0.device)
    l1 = _lane_l1(l1_weight, lanes, w0)
    F_of, reduced_pg = _problem_fns(l1)

    f0, g0 = value_and_grad_fn(w0)
    F0 = F_of(w0, f0)
    pg0_norm = torch.linalg.vector_norm(reduced_pg(w0, g0), dim=-1)

    hist = torch.full((lanes, max_iter + 1), float("nan"), **opts)
    value_history = hist.clone()
    value_history[:, 0] = F0
    grad_norm_history = hist
    grad_norm_history[:, 0] = pg0_norm
    w_history = None
    if track_coefficients:
        w_history = torch.zeros((lanes, max_iter + 1, dim), **opts)
        w_history[:, 0] = w0
    long = dict(dtype=torch.int64, device=w0.device)
    reason = torch.where(
        pg0_norm == 0.0,
        torch.full((lanes,), int(ConvergenceReason.GRADIENT_CONVERGED), **long),
        torch.zeros((lanes,), **long),
    )
    return LBFGSState(
        w=w0, f=f0, g=g0, F=F0, pg_norm=pg0_norm,
        S=torch.zeros((lanes, m, dim), **opts),
        Y=torch.zeros((lanes, m, dim), **opts),
        rho=torch.zeros((lanes, m), **opts),
        k=torch.zeros((lanes,), **long),
        iteration=torch.zeros((lanes,), **long),
        reason=reason,
        value_history=value_history,
        grad_norm_history=grad_norm_history,
        w_history=w_history,
        F0=F0, pg0_norm=pg0_norm,
    )


def _where(mask: Tensor, new: Tensor, old: Tensor) -> Tensor:
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def lbfgs_advance_(value_and_grad_fn: LaneFn, state: LBFGSState,
                   config: OptimizerConfig, l1_weight=0.0,
                   iteration_limit: Optional[int] = None) -> LBFGSState:
    """Iterate every lane until it converges or reaches the absolute
    ``iteration_limit`` (None = config.max_iterations)."""
    m, max_iter, tol = config.num_corrections, config.max_iterations, config.tolerance
    limit = max_iter if iteration_limit is None else iteration_limit
    s = state
    lanes = s.w.shape[0]
    l1 = _lane_l1(l1_weight, lanes, s.w)
    F_of, reduced_pg = _problem_fns(l1)
    use_l1 = l1 > 0.0
    lane_idx = torch.arange(lanes, device=s.w.device)
    zero_w = torch.zeros_like(s.w)
    # host-side bound on the curvature pairs any lane holds (k <= iteration)
    depth = min(m, int(s.iteration.max()))

    def orthant_project(w_trial, xi):
        projected = torch.where(w_trial * xi > 0.0, w_trial, zero_w)
        return torch.where(use_l1, projected, w_trial)

    while True:
        active = (s.reason == 0) & (s.iteration < limit)
        if not bool(active.any()):
            return s
        pg = reduced_pg(s.w, s.g)
        d = _two_loop_direction(pg, s.S, s.Y, s.rho, s.k, m, depth)
        # OWL-QN: constrain the direction to the descent orthant of -pg
        d = torch.where(use_l1, torch.where(d * pg < 0.0, d, zero_w), d)
        # safeguard: steepest descent when d is not a descent direction
        bad = torch.sum(pg * d, -1) >= 0.0
        d = _where(bad, -pg, d)

        xi = torch.where(s.w != 0.0, torch.sign(s.w), torch.sign(-pg))
        d_norm = torch.linalg.vector_norm(d, dim=-1)
        t = torch.where(s.k == 0, 1.0 / torch.clamp_min(d_norm, 1.0), torch.ones_like(d_norm))

        # backtracking Armijo line search, lanes masked once they accept
        w_n, f_n, g_n, F_n = s.w, s.f, s.g, s.F
        ok = torch.zeros_like(active)
        steps = 0
        searching = active
        while steps < config.max_line_search_steps and bool(searching.any()):
            w_t = orthant_project(s.w + t[:, None] * d, xi)
            f_t, g_t = value_and_grad_fn(w_t)
            F_t = F_of(w_t, f_t)
            # Armijo on the step actually taken (pg . (w_t - w)): right when
            # the orthant projection removes part of the direction
            ok_t = F_t <= s.F + _C1 * torch.sum(pg * (w_t - s.w), -1)
            w_n = _where(searching, w_t, w_n)
            f_n = _where(searching, f_t, f_n)
            g_n = _where(searching, g_t, g_n)
            F_n = _where(searching, F_t, F_n)
            ok = torch.where(searching, ok_t, ok)
            t = torch.where(searching & ~ok_t, t * 0.5, t)
            searching = searching & ~ok_t
            steps += 1

        # divergence guard: a non-finite trial point is rejected like a
        # failed line search, so the state stays at the last good iterate
        finite = (
            torch.isfinite(F_n)
            & torch.all(torch.isfinite(w_n), -1)
            & torch.all(torch.isfinite(g_n), -1)
        )
        ls_ok = ok & finite

        # curvature pair update
        sv = w_n - s.w
        yv = g_n - s.g
        sy = torch.sum(sv * yv, -1)
        store = active & ls_ok & (sy > _EPS)
        pos = torch.remainder(s.k, m)
        S, Y, rho = s.S.clone(), s.Y.clone(), s.rho.clone()
        S[lane_idx, pos] = _where(store, sv, S[lane_idx, pos])
        Y[lane_idx, pos] = _where(store, yv, Y[lane_idx, pos])
        rho[lane_idx, pos] = torch.where(store, 1.0 / torch.clamp_min(sy, _EPS), rho[lane_idx, pos])
        k = torch.where(store, s.k + 1, s.k)

        w_out = _where(ls_ok, w_n, s.w)
        f_out = torch.where(ls_ok, f_n, s.f)
        g_out = _where(ls_ok, g_n, s.g)
        F_out = torch.where(ls_ok, F_n, s.F)
        pg_norm = torch.linalg.vector_norm(reduced_pg(w_out, g_out), dim=-1)
        it = s.iteration + 1

        grad_ok = pg_norm <= tol * torch.clamp_min(s.pg0_norm, _EPS)
        func_ok = torch.abs(s.F - F_out) <= tol * torch.clamp_min(torch.abs(s.F0), _EPS)
        code = lambda r: torch.full_like(s.reason, int(r))
        reason = torch.where(
            grad_ok, code(ConvergenceReason.GRADIENT_CONVERGED),
            torch.where(
                ~ls_ok, code(ConvergenceReason.OBJECTIVE_NOT_IMPROVING),
                torch.where(
                    func_ok, code(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
                    torch.where(it >= max_iter, code(ConvergenceReason.MAX_ITERATIONS),
                                code(ConvergenceReason.NOT_CONVERGED)),
                ),
            ),
        )

        slot = torch.clamp(it, max=max_iter)
        value_history = s.value_history.clone()
        value_history[lane_idx, slot] = torch.where(active, F_out, value_history[lane_idx, slot])
        grad_norm_history = s.grad_norm_history.clone()
        grad_norm_history[lane_idx, slot] = torch.where(
            active, pg_norm, grad_norm_history[lane_idx, slot]
        )
        w_history = s.w_history
        if w_history is not None:
            w_history = w_history.clone()
            w_history[lane_idx, slot] = _where(active, w_out, w_history[lane_idx, slot])

        s = LBFGSState(
            w=_where(active, w_out, s.w),
            f=torch.where(active, f_out, s.f),
            g=_where(active, g_out, s.g),
            F=torch.where(active, F_out, s.F),
            pg_norm=torch.where(active, pg_norm, s.pg_norm),
            S=S, Y=Y, rho=rho, k=k,
            iteration=torch.where(active, it, s.iteration),
            reason=torch.where(active, reason, s.reason),
            value_history=value_history,
            grad_norm_history=grad_norm_history,
            w_history=w_history,
            F0=s.F0, pg0_norm=s.pg0_norm,
        )
        depth = min(m, depth + 1)


def lbfgs_result(state: LBFGSState) -> OptResult:
    """OptResult view of a (possibly paused) lane-batched state."""
    return OptResult(
        coefficients=state.w,
        value=state.F,
        grad_norm=state.pg_norm,
        iterations=state.iteration,
        reason=state.reason,
        value_history=state.value_history,
        grad_norm_history=state.grad_norm_history,
        coefficient_history=state.w_history,
    )


def lbfgs_minimize_lanes(value_and_grad_fn: LaneFn, w0: Tensor,
                         config: OptimizerConfig, l1_weight=0.0,
                         track_coefficients: bool = False) -> OptResult:
    """Minimize f_l(w_l) + l1_l * ||w_l||_1 for every lane l of ``w0`` (L, D)."""
    state = lbfgs_init_(value_and_grad_fn, w0, config, l1_weight, track_coefficients)
    final = lbfgs_advance_(value_and_grad_fn, state, config, l1_weight,
                           iteration_limit=config.max_iterations)
    return lbfgs_result(final)


def lbfgs_minimize(value_and_grad_fn: Callable[[Tensor], Tuple[Tensor, Tensor]],
                   w0: Tensor, config: OptimizerConfig = OptimizerConfig.lbfgs_default(),
                   l1_weight: float = 0.0, track_coefficients: bool = False) -> OptResult:
    """One problem: ``value_and_grad_fn`` maps (D,) -> ((), (D,)); solved as a
    single lane, and the result is returned without the lane axis."""

    def lane_fn(w):
        v, g = value_and_grad_fn(w[0])
        return v.reshape(1), g.reshape(1, -1)

    res = lbfgs_minimize_lanes(lane_fn, w0[None], config, l1_weight, track_coefficients)
    return OptResult(*(None if f is None else f[0] for f in res))
