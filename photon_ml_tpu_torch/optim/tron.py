"""TRON — trust-region Newton — over lanes of independent problems (port of
photon_ml_tpu/optim/tron.py).

The standard trust-region Newton algorithm (Lin & Moré 1999, as in
LIBLINEAR and the reference's optimization/TRON.scala:78-316): a truncated
Steihaug conjugate-gradient inner loop of at most ``max_cg_iterations``
steps, LIBLINEAR's radius-update rules, at most ``max_improvement_failures``
rejected steps in a row; defaults 15 outer iterations / tol 1e-5.

The JAX package runs one ``lax.while_loop`` per problem, vmapped over the
random effect's entities. Here every state tensor carries a leading lane
axis ``L`` (as in ``optim/lbfgs.py``): each lane has its own trust radius,
failure count and ``ConvergenceReason``; lanes that have stopped are masked
no-ops while the others advance. The CG loops of all lanes run in lockstep
under a per-lane active mask, so every CG step is one Hessian-vector call
for all lanes — on a fused slab, one launch of the HVP kernel. The loops
test convergence on the host once per outer iteration and once per CG step;
``tron_chunk_`` runs the same iteration with fixed trip counts and no host
test, for a captured CUDA graph (optim/fused_schedule.py).

``value_and_grad_fn`` maps ``(L, D)`` coefficients to ``((L,), (L, D))``
and ``hvp_fn(w, v)`` maps two ``(L, D)`` tensors to ``(L, D)``, with L2
already folded in. Box constraints (``bounds``, a ``(lower, upper)`` pair
of ``(D,)`` tensors shared by every lane) clip ``w0`` and each trial point
before it is evaluated, and zero the bound-blocked gradient components the
CG subproblem and the convergence test see, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from photon_ml_tpu_torch.optim.common import (
    LIBRARY_SUMS,
    HostReads,
    LaneSums,
    OptimizerConfig,
    OptResult,
)
from photon_ml_tpu_torch.optim.constraints import Bounds, as_bounds
from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor
LaneFn = Callable[[Tensor], Tuple[Tensor, Tensor]]
LaneHvp = Callable[[Tensor, Tensor], Tensor]

_EPS = 1e-10
# trust-region update constants (Lin & Moré / LIBLINEAR standard values)
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0
_CG_TOL = 0.1  # inner CG solves to ||r|| <= 0.1 * ||g||




def _reduced_grad(w: Tensor, g: Tensor, bounds: Bounds) -> Tensor:
    """Gradient with bound-blocked components zeroed (a coordinate at an
    active bound whose descent direction points outward cannot move)."""
    if bounds is None:
        return g
    blocked = ((w >= bounds[1]) & (g < 0.0)) | ((w <= bounds[0]) & (g > 0.0))
    return torch.where(blocked, torch.zeros_like(g), g)


def _where(mask: Tensor, new: Tensor, old: Tensor) -> Tensor:
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def _truncated_cg(hvp: Callable[[Tensor], Tensor], g: Tensor, delta: Tensor,
                  max_cg_iter: int, live: Tensor, fixed: bool = False,
                  sums: LaneSums = LIBRARY_SUMS) -> Tuple[Tensor, Tensor]:
    """Steihaug truncated CG per lane: approximately solve H s = -g with
    ||s|| <= delta. Lanes outside ``live`` start done. Returns (s, r) with r
    the final residual -g - H s. ``fixed``: all ``max_cg_iter`` steps run,
    testing nothing on the host (a step of a done lane is exact)."""
    dot, norm = sums.dot, sums.norm
    gnorm = norm(g)
    s = torch.zeros_like(g)
    r = -g
    d = -g
    rtr = dot(g, g)
    done = (gnorm == 0.0) | ~live
    for _ in range(max_cg_iter):
        if not fixed and not HostReads.read((~done).any()):
            break
        hd = hvp(d)
        dhd = dot(d, hd)
        alpha = rtr / torch.clamp_min(dhd, _EPS)
        s_try = s + alpha[:, None] * d
        # negative curvature or a step leaving the region: walk to the
        # boundary along d and stop
        hit = (dhd <= 0.0) | (norm(s_try) >= delta)
        sd = dot(s, d)
        dd = torch.clamp_min(dot(d, d), _EPS)
        ss = dot(s, s)
        rad = torch.sqrt(torch.clamp_min(sd * sd + dd * (delta * delta - ss), 0.0))
        tau = (-sd + rad) / dd
        s_new = torch.where(hit[:, None], s + tau[:, None] * d, s_try)
        r_new = r - torch.where(hit, tau, alpha)[:, None] * hd
        rtr_new = dot(r_new, r_new)
        small = torch.sqrt(rtr_new) <= _CG_TOL * gnorm
        beta = rtr_new / torch.clamp_min(rtr, _EPS)
        d_new = r_new + beta[:, None] * d
        step = ~done
        s = _where(step, s_new, s)
        r = _where(step, r_new, r)
        d = _where(step, d_new, d)
        rtr = torch.where(step, rtr_new, rtr)
        done = done | (step & (hit | small))
    return s, r


@dataclasses.dataclass
class TRONState:
    """Carried solve state; every field has the leading lane axis. ``f0``
    and ``g0_norm`` (the convergence references fixed at init) ride in the
    state so a paused state resumes exactly."""

    w: Tensor  # (L, D)
    f: Tensor  # (L,)
    g: Tensor  # (L, D)
    delta: Tensor  # (L,) trust radius
    iteration: Tensor  # (L,) int64
    failures: Tensor  # (L,) int64 — rejected steps in a row
    reason: Tensor  # (L,) int64 ConvergenceReason
    value_history: Tensor  # (L, max_iter + 1)
    grad_norm_history: Tensor  # (L, max_iter + 1)
    w_history: Optional[Tensor]  # (L, max_iter + 1, D) if tracking
    f0: Tensor  # (L,)
    g0_norm: Tensor  # (L,)


def tron_init_(value_and_grad_fn: LaneFn, w0: Tensor, config: OptimizerConfig,
               bounds: Bounds = None, track_coefficients: bool = False,
               sums: LaneSums = LIBRARY_SUMS) -> TRONState:
    """Fresh solve state at ``w0`` (L, D) — one objective evaluation.
    ``sums``: the reductions over each lane's coefficients, the same for
    every call of one solve (``common.FIXED_SUMS`` where the lanes change
    batches)."""
    lanes, dim = w0.shape
    opts = dict(dtype=w0.dtype, device=w0.device)
    long = dict(dtype=torch.int64, device=w0.device)
    bounds = as_bounds(bounds, w0)
    if bounds is not None:
        w0 = torch.clamp(w0, bounds[0], bounds[1])
    f0, g0 = value_and_grad_fn(w0)
    g0_norm = sums.norm(_reduced_grad(w0, g0, bounds))
    hist = torch.full((lanes, config.max_iterations + 1), float("nan"), **opts)
    value_history = hist.clone()
    value_history[:, 0] = f0
    hist[:, 0] = g0_norm
    w_history = None
    if track_coefficients:
        w_history = torch.zeros((lanes, config.max_iterations + 1, dim), **opts)
        w_history[:, 0] = w0
    reason = torch.where(
        g0_norm == 0.0,
        torch.full((lanes,), int(ConvergenceReason.GRADIENT_CONVERGED), **long),
        torch.zeros((lanes,), **long),
    )
    return TRONState(
        w=w0, f=f0, g=g0, delta=g0_norm,
        iteration=torch.zeros((lanes,), **long),
        failures=torch.zeros((lanes,), **long),
        reason=reason,
        value_history=value_history, grad_norm_history=hist, w_history=w_history,
        f0=f0, g0_norm=g0_norm,
    )


def _tron_iteration(value_and_grad_fn: LaneFn, hvp_fn: LaneHvp, s: TRONState, active: Tensor,
                    config: OptimizerConfig, bounds: Bounds, fixed: bool,
                    sums: LaneSums) -> TRONState:
    """Advance the lanes of ``active`` one trust-region iteration (every
    other lane is left as it is, bit for bit); shared by the host loop
    (``tron_advance_``) and the fixed-trip chunk (``tron_chunk_``), so both
    give every lane the same bits. ``fixed``: the CG loop runs all its
    steps."""
    max_iter, tol = config.max_iterations, config.tolerance
    dot, norm = sums.dot, sums.norm
    lane_idx = torch.arange(s.w.shape[0], device=s.w.device)
    code = lambda r: torch.full_like(s.reason, int(r))
    step, r = _truncated_cg(lambda v: hvp_fn(s.w, v), _reduced_grad(s.w, s.g, bounds),
                            s.delta, config.max_cg_iterations, active, fixed, sums)
    w_trial = s.w + step
    if bounds is not None:
        # clip before evaluating, and measure the quadratic model and
        # the radius update on the step actually taken (the clipped one)
        w_trial = torch.clamp(w_trial, bounds[0], bounds[1])
        step = w_trial - s.w
        snorm = norm(step)
        gs = dot(s.g, step)
        prered = -(gs + 0.5 * dot(step, hvp_fn(s.w, step)))
    else:
        snorm = norm(step)
        gs = dot(s.g, step)
        # r = -g - H s  =>  -0.5 (g.s - s.r) = -(g.s + 0.5 s.H.s)
        prered = -0.5 * (gs - dot(step, r))
    f_new, g_new = value_and_grad_fn(w_trial)
    actred = s.f - f_new

    # first iteration: shrink the initial radius to the first step length
    delta = torch.where(s.iteration == 0, torch.minimum(s.delta, snorm), s.delta)
    # radius update (interpolated step-length alpha, LIBLINEAR rules)
    denom = f_new - s.f - gs
    alpha = torch.where(denom <= 0.0, torch.full_like(denom, _SIGMA3),
                        torch.clamp_min(-0.5 * (gs / denom), _SIGMA1))
    asn = alpha * snorm
    delta = torch.where(
        actred < _ETA0 * prered,
        torch.minimum(torch.maximum(asn, _SIGMA1 * snorm), _SIGMA2 * delta),
        torch.where(
            actred < _ETA1 * prered,
            torch.maximum(_SIGMA1 * delta, torch.minimum(asn, _SIGMA2 * delta)),
            torch.where(
                actred < _ETA2 * prered,
                torch.maximum(_SIGMA1 * delta, torch.minimum(asn, _SIGMA3 * delta)),
                torch.maximum(delta, torch.minimum(asn, _SIGMA3 * delta)),
            ),
        ),
    )
    # divergence guard: a non-finite trial point is never accepted; it
    # counts as an improvement failure and the region shrinks
    finite = (
        torch.isfinite(f_new)
        & torch.all(torch.isfinite(w_trial), -1)
        & torch.all(torch.isfinite(g_new), -1)
    )
    accept = (actred > _ETA0 * prered) & finite
    w_out = _where(accept, w_trial, s.w)
    f_out = torch.where(accept, f_new, s.f)
    g_out = _where(accept, g_new, s.g)
    failures = torch.where(accept, torch.zeros_like(s.failures), s.failures + 1)
    # a NaN objective poisons the interpolated radius: restore a finite,
    # shrunken one (from the step length, else from the last radius)
    eps = torch.full_like(delta, _EPS)
    delta = torch.where(
        torch.isfinite(delta), delta,
        torch.where(torch.isfinite(snorm), torch.maximum(_SIGMA1 * snorm, eps),
                    torch.maximum(_SIGMA1 * s.delta, eps)),
    )

    g_norm = norm(_reduced_grad(w_out, g_out, bounds))
    it = s.iteration + 1
    grad_ok = g_norm <= tol * torch.clamp_min(s.g0_norm, _EPS)
    func_ok = accept & (torch.abs(actred) <= tol * torch.clamp_min(torch.abs(s.f0), _EPS))
    reason = torch.where(
        grad_ok, code(ConvergenceReason.GRADIENT_CONVERGED),
        torch.where(
            failures >= config.max_improvement_failures,
            code(ConvergenceReason.OBJECTIVE_NOT_IMPROVING),
            torch.where(
                func_ok, code(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
                torch.where(it >= max_iter, code(ConvergenceReason.MAX_ITERATIONS),
                            code(ConvergenceReason.NOT_CONVERGED)),
            ),
        ),
    )

    slot = torch.clamp(it, max=max_iter)
    value_history = s.value_history.clone()
    value_history[lane_idx, slot] = torch.where(active, f_out, value_history[lane_idx, slot])
    grad_norm_history = s.grad_norm_history.clone()
    grad_norm_history[lane_idx, slot] = torch.where(
        active, g_norm, grad_norm_history[lane_idx, slot]
    )
    w_history = s.w_history
    if w_history is not None:
        w_history = w_history.clone()
        w_history[lane_idx, slot] = _where(active, w_out, w_history[lane_idx, slot])

    return TRONState(
        w=_where(active, w_out, s.w),
        f=torch.where(active, f_out, s.f),
        g=_where(active, g_out, s.g),
        delta=torch.where(active, delta, s.delta),
        iteration=torch.where(active, it, s.iteration),
        failures=torch.where(active, failures, s.failures),
        reason=torch.where(active, reason, s.reason),
        value_history=value_history,
        grad_norm_history=grad_norm_history,
        w_history=w_history,
        f0=s.f0, g0_norm=s.g0_norm,
    )


def tron_advance_(value_and_grad_fn: LaneFn, hvp_fn: LaneHvp, state: TRONState,
                  config: OptimizerConfig, bounds: Bounds = None,
                  iteration_limit: Optional[int] = None,
                  sums: LaneSums = LIBRARY_SUMS) -> TRONState:
    """Iterate every lane until it converges or reaches the absolute
    ``iteration_limit`` (None = config.max_iterations)."""
    bounds = as_bounds(bounds, state.w)
    limit = config.max_iterations if iteration_limit is None else iteration_limit
    s = state
    while True:
        active = (s.reason == 0) & (s.iteration < limit)
        if not HostReads.read(active.any()):
            return s
        s = _tron_iteration(value_and_grad_fn, hvp_fn, s, active, config, bounds, fixed=False,
                            sums=sums)


def tron_chunk_(value_and_grad_fn: LaneFn, hvp_fn: LaneHvp, state: TRONState,
                config: OptimizerConfig, limit: Tensor, trips: int,
                bounds: Bounds = None, sums: LaneSums = LIBRARY_SUMS) -> TRONState:
    """``trips`` iterations toward the absolute iteration bound ``limit``
    (a 0-dim tensor on the lanes' device) with no host sync: every trip
    runs every CG step, masked where a lane has nothing to do. Each lane
    ends bitwise where ``tron_advance_(..., iteration_limit=limit)`` leaves
    it when ``trips`` covers its remaining iterations: the body of a
    captured CUDA graph."""
    bounds = as_bounds(bounds, state.w)
    s = state
    for _ in range(trips):
        active = (s.reason == 0) & (s.iteration < limit)
        s = _tron_iteration(value_and_grad_fn, hvp_fn, s, active, config, bounds, fixed=True,
                            sums=sums)
    return s


def tron_result(state: TRONState, bounds: Bounds = None,
                sums: LaneSums = LIBRARY_SUMS) -> OptResult:
    """OptResult view of a (possibly paused) lane-batched state; the final
    gradient norm is the reduced gradient's under ``bounds``."""
    bounds = as_bounds(bounds, state.w)
    return OptResult(
        coefficients=state.w,
        value=state.f,
        grad_norm=sums.norm(_reduced_grad(state.w, state.g, bounds)),
        iterations=state.iteration,
        reason=state.reason,
        value_history=state.value_history,
        grad_norm_history=state.grad_norm_history,
        coefficient_history=state.w_history,
    )


def tron_minimize_lanes(value_and_grad_fn: LaneFn, hvp_fn: LaneHvp, w0: Tensor,
                        config: OptimizerConfig, bounds: Bounds = None,
                        track_coefficients: bool = False,
                        sums: LaneSums = LIBRARY_SUMS) -> OptResult:
    """Minimize f_l(w_l) for every lane l of ``w0`` (L, D), within ``bounds``
    when given."""
    state = tron_init_(value_and_grad_fn, w0, config, bounds, track_coefficients, sums)
    final = tron_advance_(value_and_grad_fn, hvp_fn, state, config, bounds,
                          iteration_limit=config.max_iterations, sums=sums)
    return tron_result(final, bounds, sums)


def tron_minimize_(value_and_grad_fn: Callable[[Tensor], Tuple[Tensor, Tensor]],
                   hvp_fn: Callable[[Tensor, Tensor], Tensor], w0: Tensor,
                   config: OptimizerConfig = OptimizerConfig.tron_default(),
                   bounds: Bounds = None, track_coefficients: bool = False) -> OptResult:
    """One problem: ``value_and_grad_fn`` maps (D,) -> ((), (D,)) and
    ``hvp_fn(w, v)`` (D,) x (D,) -> (D,); solved as a single lane, and the
    result is returned without the lane axis."""

    def lane_vg(w):
        v, g = value_and_grad_fn(w[0])
        return v.reshape(1), g.reshape(1, -1)

    def lane_hvp(w, v):
        return hvp_fn(w[0], v[0]).reshape(1, -1)

    res = tron_minimize_lanes(lane_vg, lane_hvp, w0[None], config, bounds, track_coefficients)
    return OptResult(*(None if f is None else f[0] for f in res))
