"""Deterministic, seedable fault injection for chaos testing (port of
photon_ml_tpu/resilience/faults.py).

Production code calls :func:`inject` / :func:`corrupt` / :func:`flag` at
named sites (registered in :data:`photon_ml_tpu_torch.resilience.sites.
FAULT_SITES`); they are no-ops unless a :class:`FaultPlan` is active —
installed with :func:`fault_scope` or through the ``PHOTON_FAULTS``
environment variable. ``preempt.signal`` FLAGS a preemption request instead
of raising (see :func:`flag`).

``PHOTON_FAULTS`` grammar (';'-separated site specs, ','-separated options)::

    PHOTON_FAULTS="io.checkpoint_write:rate=0.3,seed=7;optim.step:at=3,kind=nan"

Options: ``rate`` (per-hit probability), ``at`` (fire on exactly the N-th
hit, 1-based), ``times`` (max fires, default 1 for ``at`` else unlimited),
``kind`` (``io`` -> retryable :class:`InjectedIOError`, ``fatal`` ->
:class:`InjectedFatalError`, ``nan`` -> NaN tensors at ``corrupt`` sites),
``seed`` (per-site RNG seed). Every draw comes from a per-site
``random.Random``, so a plan gives the same fault sequence on every run.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from photon_ml_tpu_torch.resilience.sites import FAULT_SITES as KNOWN_SITES

__all__ = [
    "KNOWN_SITES",
    "InjectedIOError",
    "InjectedFatalError",
    "FaultSpec",
    "FaultPlan",
    "fault_scope",
    "install",
    "clear",
    "active_plan",
    "inject",
    "corrupt",
    "flag",
    "parse_fault_env",
]


class InjectedIOError(OSError):
    """A retryable injected I/O failure (an OSError, so the default retry
    policies treat it exactly like a real transient read error)."""


class InjectedFatalError(RuntimeError):
    """A non-retryable injected failure (process-kill analogue)."""


_KINDS = ("io", "fatal", "nan")


@dataclasses.dataclass
class FaultSpec:
    """One site's fault behavior."""

    site: str
    rate: float = 0.0
    at: Optional[int] = None  # fire on exactly the at-th hit (1-based)
    times: Optional[int] = None  # max fires; None = unlimited (1 when `at` set)
    kind: str = "io"
    seed: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"fault kind {self.kind!r} for site {self.site!r} not in {_KINDS}"
            )
        if self.at is not None and self.at < 1:
            raise ValueError(f"fault 'at' must be >= 1 (1-based hit count), got {self.at}")
        if not (self.at is not None or self.rate > 0.0):
            raise ValueError(f"fault spec for {self.site!r} needs rate>0 or at=N")
        if self.times is None:
            self.times = 1 if self.at is not None else None


class FaultPlan:
    """Active fault registry: per-site hit counters + seeded RNG streams."""

    def __init__(self, specs: List[FaultSpec]):
        self._specs: Dict[str, FaultSpec] = {}
        for s in specs:
            if s.site in self._specs:
                raise ValueError(f"duplicate fault spec for site {s.site!r}")
            self._specs[s.site] = s
        self._hits: Dict[str, int] = {s: 0 for s in self._specs}
        self._fires: Dict[str, int] = {s: 0 for s in self._specs}
        self._rngs: Dict[str, random.Random] = {
            s: random.Random(spec.seed) for s, spec in self._specs.items()
        }
        self._lock = threading.Lock()
        self.events: List[Tuple[str, Dict[str, Any]]] = []

    def spec(self, site: str) -> Optional[FaultSpec]:
        return self._specs.get(site)

    def hits(self, site: str) -> int:
        return self._hits.get(site, 0)

    def fire_count(self, site: str) -> int:
        return self._fires.get(site, 0)

    def should_fire(self, site: str, **context: Any) -> Optional[FaultSpec]:
        """Count a hit at ``site``; return the spec when this hit faults."""
        spec = self._specs.get(site)
        if spec is None:
            return None
        with self._lock:
            self._hits[site] += 1
            hit = self._hits[site]
            if spec.times is not None and self._fires[site] >= spec.times:
                return None
            if spec.at is not None:
                fire = hit == spec.at
            else:
                fire = self._rngs[site].random() < spec.rate
            if not fire:
                return None
            self._fires[site] += 1
            self.events.append((site, dict(context, hit=hit)))
            return spec


# ---------------------------------------------------------------------------
# active-plan management: explicit install/scope wins over PHOTON_FAULTS
# ---------------------------------------------------------------------------

FAULT_ENV = "PHOTON_FAULTS"

_installed: Optional[FaultPlan] = None
_env_cache: Tuple[Optional[str], Optional[FaultPlan]] = (None, None)


def parse_fault_env(value: str) -> FaultPlan:
    """Parse the ``PHOTON_FAULTS`` grammar into a plan."""
    specs: List[FaultSpec] = []
    for chunk in value.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        site, _, opts = chunk.partition(":")
        kwargs: Dict[str, Any] = {}
        for opt in opts.split(","):
            opt = opt.strip()
            if not opt:
                continue
            key, _, val = opt.partition("=")
            key = key.strip()
            val = val.strip()
            if key in ("rate",):
                kwargs[key] = float(val)
            elif key in ("at", "times", "seed"):
                kwargs[key] = int(val)
            elif key == "kind":
                kwargs[key] = val
            else:
                raise ValueError(
                    f"unknown {FAULT_ENV} option {key!r} in {chunk!r} "
                    "(expected rate/at/times/kind/seed)"
                )
        specs.append(FaultSpec(site=site.strip(), **kwargs))
    return FaultPlan(specs)


def install(plan: Optional[FaultPlan]) -> None:
    """Install (or with None, remove) the process-wide fault plan."""
    global _installed
    _installed = plan


def clear() -> None:
    install(None)


def active_plan() -> Optional[FaultPlan]:
    """The explicitly installed plan, else a plan parsed from PHOTON_FAULTS
    (cached per env value), else None."""
    global _env_cache
    if _installed is not None:
        return _installed
    env = os.environ.get(FAULT_ENV)
    if not env:
        return None
    if _env_cache[0] != env:
        _env_cache = (env, parse_fault_env(env))
    return _env_cache[1]


class fault_scope:
    """``with fault_scope(plan):`` — install for the duration of the block."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        global _installed
        self._prev = _installed
        _installed = self.plan
        return self.plan

    def __exit__(self, *exc) -> None:
        install(self._prev)
        return None


# ---------------------------------------------------------------------------
# injection points called from production code
# ---------------------------------------------------------------------------


def _raise_fault(spec: FaultSpec, site: str, context: Dict[str, Any]) -> None:
    detail = ", ".join(f"{k}={v}" for k, v in sorted(context.items()))
    msg = f"injected {spec.kind} fault at {site}" + (f" ({detail})" if detail else "")
    if spec.kind == "fatal":
        raise InjectedFatalError(msg)
    raise InjectedIOError(msg)


def inject(site: str, **context: Any) -> None:
    """Raise an injected error at ``site`` if the active plan says so.

    ``kind="io"`` raises :class:`InjectedIOError` (retryable OSError);
    ``kind="fatal"`` raises :class:`InjectedFatalError`. A ``nan`` spec at a
    raising site is ignored (NaNs are injected via :func:`corrupt`).
    """
    plan = active_plan()
    if plan is None:
        return
    spec = plan.should_fire(site, **context)
    if spec is None or spec.kind == "nan":
        return
    _raise_fault(spec, site, context)


def flag(site: str, **context: Any) -> bool:
    """Count a hit at ``site``; return True when the plan fires — WITHOUT
    raising, whatever the spec's kind. For sites where a fault is a signal
    to act on (``preempt.signal``), not an error to propagate."""
    plan = active_plan()
    if plan is None:
        return False
    return plan.should_fire(site, **context) is not None


def corrupt(site: str, tree: Any, **context: Any) -> Any:
    """Return ``tree`` with NaNs poured into its first array leaf if a
    ``kind="nan"`` fault fires at ``site``; otherwise ``tree`` unchanged.
    Non-nan kinds raise, exactly like :func:`inject`."""
    plan = active_plan()
    if plan is None:
        return tree
    spec = plan.should_fire(site, **context)
    if spec is None:
        return tree
    if spec.kind != "nan":
        _raise_fault(spec, site, context)

    return _nan_first_leaf(tree)


def _nan_first_leaf(tree: Any) -> Any:
    """``tree`` (a tensor, or dicts/lists/tuples of them; dict keys in
    sorted order, as a JAX pytree orders them) with its first tensor leaf
    replaced by NaNs."""
    if isinstance(tree, torch.Tensor):
        return torch.full_like(tree, float("nan"))
    if isinstance(tree, dict):
        out = dict(tree)
        for k in sorted(out):
            new = _nan_first_leaf(out[k])
            if new is not out[k]:
                out[k] = new
                return out
        return tree
    if isinstance(tree, (list, tuple)):
        items = list(tree)
        for i, v in enumerate(items):
            new = _nan_first_leaf(v)
            if new is not v:
                items[i] = new
                return type(tree)(items)
        return tree
    return tree
