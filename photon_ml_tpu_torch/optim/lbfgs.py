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
    by ``l1_weight > 0``;
  * box constraints (``bounds``, a ``(lower, upper)`` pair of ``(D,)``
    tensors shared by every lane): ``w0`` is clipped, bound-blocked
    components of the pseudo-gradient are zeroed, and each trial point is
    clipped after the orthant projection (LBFGS.scala:94-97 via
    OptimizationUtils.projectCoefficientsToHypercube).

Every state tensor carries a leading lane axis ``L``: a lane is one problem,
and lanes that have converged are masked no-ops while the others advance.
The fixed-effect GLM solve is one lane; the random-effect coordinate can
batch entities as lanes. The loop tests convergence on the host once per
iteration and once per line-search step; ``lbfgs_chunk_`` runs the same
iteration with fixed trip counts and no host test, for a captured CUDA
graph (optim/fused_schedule.py).

``value_and_grad_fn`` maps ``(L, D)`` coefficients to ``((L,), (L, D))``
smooth values and gradients, with L2 already folded in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from photon_ml_tpu_torch.optim.common import (
    LIBRARY_SUMS,
    FixedTrips,
    HostReads,
    LaneSums,
    OptimizerConfig,
    OptResult,
)
from photon_ml_tpu_torch.optim.constraints import Bounds, as_bounds
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
                        k: Tensor, m: int, depth: int, dot) -> Tensor:
    """Limited-memory two-loop recursion over the ring buffers.

    ``depth`` (<= m) is a host-side bound on the pairs any lane holds; the
    recursion positions beyond a lane's own count are masked exactly, so
    the loops may stop at any ``depth`` that covers them with the same bits
    as running all m.
    """
    n_valid = torch.clamp(k, max=m)
    q = pg
    alphas = []
    for j in range(depth):
        pos = torch.remainder(k - 1 - j, m)
        valid = j < n_valid
        a = torch.where(valid, _gather(rho, pos) * dot(_gather(S, pos), q),
                        torch.zeros_like(n_valid, dtype=pg.dtype))
        q = q - a[:, None] * _gather(Y, pos)
        alphas.append(a)

    newest = torch.remainder(k - 1, m)
    s_new, y_new = _gather(S, newest), _gather(Y, newest)
    sy = dot(s_new, y_new)
    yy = dot(y_new, y_new)
    gamma = torch.where(k > 0, sy / torch.clamp_min(yy, _EPS), torch.ones_like(sy))
    r = gamma[:, None] * q
    for j in reversed(range(depth)):
        pos = torch.remainder(k - 1 - j, m)
        valid = j < n_valid
        b = _gather(rho, pos) * dot(_gather(Y, pos), r)
        coef = torch.where(valid, alphas[j] - b, torch.zeros_like(b))
        # a masked position leaves r as it is, the sign of a zero included
        # (r + 0 * 0 would turn -0.0 into +0.0): the depth may exceed a
        # lane's pairs by any amount without touching its bits
        r = _where(valid, r + coef[:, None] * _gather(S, pos), r)
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




def _problem_fns(l1: Tensor, bounds: Bounds, sums: LaneSums):
    def F_of(w, f):
        return f + l1[:, 0] * sums.sum(torch.abs(w))

    def reduced_pg(w, g):
        """(Pseudo-)gradient with bound-blocked components zeroed: at an
        active bound whose descent direction (-pg) points outward the
        coordinate cannot move, so it steers neither the direction nor the
        convergence test."""
        pg = _pseudo_gradient(w, g, l1)
        if bounds is not None:
            blocked = ((w >= bounds[1]) & (pg < 0.0)) | ((w <= bounds[0]) & (pg > 0.0))
            pg = torch.where(blocked, torch.zeros_like(pg), pg)
        return pg

    return F_of, reduced_pg


def _lane_l1(l1_weight, lanes: int, like: Tensor) -> Tensor:
    # a Python number is filled on the device (no copy from the host, so a
    # CUDA-graph capture can make it)
    if isinstance(l1_weight, (int, float)):
        l1 = torch.full((), float(l1_weight), dtype=like.dtype, device=like.device)
    else:
        l1 = torch.as_tensor(l1_weight, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(l1.reshape(-1, 1), (lanes, 1))


def lbfgs_init_(value_and_grad_fn: LaneFn, w0: Tensor, config: OptimizerConfig,
                l1_weight=0.0, bounds: Bounds = None,
                track_coefficients: bool = False, sums: LaneSums = LIBRARY_SUMS) -> LBFGSState:
    """Fresh solve state at ``w0`` (L, D) — one objective evaluation.
    ``sums``: the reductions over each lane's coefficients, the same for
    every call of one solve (``common.FIXED_SUMS`` where the lanes change
    batches)."""
    m, max_iter = config.num_corrections, config.max_iterations
    lanes, dim = w0.shape
    opts = dict(dtype=w0.dtype, device=w0.device)
    l1 = _lane_l1(l1_weight, lanes, w0)
    bounds = as_bounds(bounds, w0)
    F_of, reduced_pg = _problem_fns(l1, bounds, sums)
    if bounds is not None:
        w0 = torch.clamp(w0, bounds[0], bounds[1])

    f0, g0 = value_and_grad_fn(w0)
    F0 = F_of(w0, f0)
    pg0_norm = sums.norm(reduced_pg(w0, g0))

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


class _Iteration:
    """One LBFGS/OWL-QN iteration over lanes, shared by the host loop
    (``lbfgs_advance_``) and the fixed-trip chunk (``lbfgs_chunk_``): the
    same tensor ops in the same order, so both give every lane the same
    bits."""

    def __init__(self, state: LBFGSState, config: OptimizerConfig, l1_weight, bounds: Bounds,
                 sums: LaneSums):
        self.config = config
        self.sums = sums
        lanes = state.w.shape[0]
        l1 = _lane_l1(l1_weight, lanes, state.w)
        self.bounds = as_bounds(bounds, state.w)
        self.F_of, self.reduced_pg = _problem_fns(l1, self.bounds, sums)
        self.use_l1 = l1 > 0.0
        self.lane_idx = torch.arange(lanes, device=state.w.device)
        self.zero_w = torch.zeros_like(state.w)

    def orthant_project(self, w_trial, xi):
        projected = torch.where(w_trial * xi > 0.0, w_trial, self.zero_w)
        w_trial = torch.where(self.use_l1, projected, w_trial)
        # then the box, as the JAX package: with L1 and a box that excludes
        # 0 the clip can move an orthant-zeroed coordinate onto a bound
        if self.bounds is not None:
            w_trial = torch.clamp(w_trial, self.bounds[0], self.bounds[1])
        return w_trial

    def __call__(self, value_and_grad_fn: LaneFn, s: LBFGSState, active: Tensor, depth: int,
                 fixed: bool) -> LBFGSState:
        """Advance the lanes of ``active`` one iteration (every other lane
        is left as it is, bit for bit). ``fixed``: the line search runs all
        its steps, testing nothing on the host (a masked step is exact)."""
        config = self.config
        m, max_iter, tol = config.num_corrections, config.max_iterations, config.tolerance
        F_of, reduced_pg, use_l1, zero_w = self.F_of, self.reduced_pg, self.use_l1, self.zero_w
        lane_idx = self.lane_idx
        pg = reduced_pg(s.w, s.g)
        dot = self.sums.dot
        d = _two_loop_direction(pg, s.S, s.Y, s.rho, s.k, m, depth, dot)
        # OWL-QN: constrain the direction to the descent orthant of -pg
        d = torch.where(use_l1, torch.where(d * pg < 0.0, d, zero_w), d)
        # safeguard: steepest descent when d is not a descent direction
        bad = dot(pg, d) >= 0.0
        d = _where(bad, -pg, d)

        xi = torch.where(s.w != 0.0, torch.sign(s.w), torch.sign(-pg))
        d_norm = self.sums.norm(d)
        t = torch.where(s.k == 0, 1.0 / torch.clamp_min(d_norm, 1.0), torch.ones_like(d_norm))

        # backtracking Armijo line search, lanes masked once they accept
        w_n, f_n, g_n, F_n = s.w, s.f, s.g, s.F
        ok = torch.zeros_like(active)
        steps = 0
        searching = active
        while steps < config.max_line_search_steps and (fixed or HostReads.read(searching.any())):
            w_t = self.orthant_project(s.w + t[:, None] * d, xi)
            f_t, g_t = value_and_grad_fn(w_t)
            F_t = F_of(w_t, f_t)
            # Armijo on the step actually taken (pg . (w_t - w)): right when
            # the orthant or box projection removes part of the direction
            ok_t = F_t <= s.F + _C1 * dot(pg, w_t - s.w)
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
        sy = dot(sv, yv)
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
        pg_norm = self.sums.norm(reduced_pg(w_out, g_out))
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

        return LBFGSState(
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


def lbfgs_advance_(value_and_grad_fn: LaneFn, state: LBFGSState,
                   config: OptimizerConfig, l1_weight=0.0, bounds: Bounds = None,
                   iteration_limit: Optional[int] = None,
                   sums: LaneSums = LIBRARY_SUMS) -> LBFGSState:
    """Iterate every lane until it converges or reaches the absolute
    ``iteration_limit`` (None = config.max_iterations)."""
    limit = config.max_iterations if iteration_limit is None else iteration_limit
    s = state
    step = _Iteration(s, config, l1_weight, bounds, sums)
    # host-side bound on the curvature pairs any lane holds (k <= iteration)
    depth = min(config.num_corrections, HostReads.read(s.iteration.max()))
    while True:
        active = (s.reason == 0) & (s.iteration < limit)
        if not HostReads.read(active.any()):
            return s
        s = step(value_and_grad_fn, s, active, depth, fixed=False)
        depth = min(config.num_corrections, depth + 1)


def lbfgs_chunk_(value_and_grad_fn: LaneFn, state: LBFGSState, config: OptimizerConfig,
                 limit: Tensor, trips: int, l1_weight=0.0, bounds: Bounds = None,
                 sums: LaneSums = LIBRARY_SUMS) -> LBFGSState:
    """``trips`` iterations toward the absolute iteration bound ``limit``
    (a 0-dim tensor on the lanes' device) with no host sync: every trip
    runs the whole two-loop depth and every line-search step, masked where
    a lane has nothing to do. A masked step is exact, so each lane ends
    bitwise where ``lbfgs_advance_(..., iteration_limit=limit)`` leaves it
    when ``trips`` covers the iterations it still has to the bound: the
    body of a captured CUDA graph."""
    s = state
    step = _Iteration(s, config, l1_weight, bounds, sums)
    for _ in range(trips):
        active = (s.reason == 0) & (s.iteration < limit)
        s = step(value_and_grad_fn, s, active, config.num_corrections, fixed=True)
    return s


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
                         config: OptimizerConfig, l1_weight=0.0, bounds: Bounds = None,
                         track_coefficients: bool = False,
                         sums: LaneSums = LIBRARY_SUMS) -> OptResult:
    """Minimize f_l(w_l) + l1_l * ||w_l||_1 for every lane l of ``w0`` (L, D),
    within ``bounds`` when given. Under ``common.fixed_trip_solves`` the
    iterations run as one fixed-trip chunk to ``max_iterations``, with no
    host test and the same bits."""
    state = lbfgs_init_(value_and_grad_fn, w0, config, l1_weight, bounds, track_coefficients,
                        sums)
    if FixedTrips.on:
        limit = torch.full((), config.max_iterations, dtype=torch.int64, device=w0.device)
        final = lbfgs_chunk_(value_and_grad_fn, state, config, limit, FixedTrips.count(config),
                             l1_weight, bounds, sums)
    else:
        final = lbfgs_advance_(value_and_grad_fn, state, config, l1_weight, bounds,
                               iteration_limit=config.max_iterations, sums=sums)
    return lbfgs_result(final)


def lbfgs_minimize(value_and_grad_fn: Callable[[Tensor], Tuple[Tensor, Tensor]],
                   w0: Tensor, config: OptimizerConfig = OptimizerConfig.lbfgs_default(),
                   l1_weight: float = 0.0, bounds: Bounds = None,
                   track_coefficients: bool = False) -> OptResult:
    """One problem: ``value_and_grad_fn`` maps (D,) -> ((), (D,)); solved as a
    single lane, and the result is returned without the lane axis."""

    def lane_fn(w):
        v, g = value_and_grad_fn(w[0])
        return v.reshape(1), g.reshape(1, -1)

    res = lbfgs_minimize_lanes(lane_fn, w0[None], config, l1_weight, bounds, track_coefficients)
    return OptResult(*(None if f is None else f[0] for f in res))
