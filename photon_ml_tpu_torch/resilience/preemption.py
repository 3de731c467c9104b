"""Cooperative preemption: signal -> flag -> drain-to-boundary -> resume
(port of photon_ml_tpu/resilience/preemption.py).

  1. **flag** — :func:`signal_scope` turns SIGTERM/SIGINT into a
     process-wide preemption flag; nothing is interrupted mid-kernel.
  2. **poll** — coordinate descent calls :func:`check` between updates
     (site ``"cycle"``).
  3. **drain + raise** — the loop that sees the flag makes its finished
     steps durable in an emergency checkpoint and unwinds with
     :class:`Preempted`.
  4. **exit / restart** — the training driver turns an unhandled
     :class:`Preempted` into :data:`PREEMPT_EXIT_CODE` (75, EX_TEMPFAIL), or
     relaunches in-process through :func:`run_with_restarts`
     (``--max-restarts``).

Testability: ``PHOTON_PREEMPT_AT="cycle:2"`` requests preemption at the
2nd poll of the ``cycle`` site (';'-separated specs; each fires once per
process), and a ``preempt.signal`` spec in ``PHOTON_FAULTS`` flags the same
request through the seeded fault registry.
"""

from __future__ import annotations

import logging
import os
import signal as _signal
import threading
from typing import Any, Callable, Dict, Optional, Tuple, TypeVar

from photon_ml_tpu_torch.resilience import faults
from photon_ml_tpu_torch.resilience.sites import PREEMPT_SITES

__all__ = [
    "PREEMPT_ENV",
    "PREEMPT_EXIT_CODE",
    "Preempted",
    "check",
    "clear",
    "install_plan",
    "install_signal_handlers",
    "parse_preempt_env",
    "reason",
    "request",
    "requested",
    "reset",
    "run_with_restarts",
    "signal_scope",
]

logger = logging.getLogger(__name__)

#: Distinct process exit code for a cooperative preemption exit (75 =
#: EX_TEMPFAIL: "try again later" — exactly the supervisor contract).
PREEMPT_EXIT_CODE = 75

PREEMPT_ENV = "PHOTON_PREEMPT_AT"

#: Poll sites wired through the port (the safe drain boundaries).
SITES = PREEMPT_SITES


class Preempted(RuntimeError):
    """Raised at a safe boundary after a preemption request.

    ``partial`` is the JAX package's mid-coordinate payload; no poll site
    of the port sets it (the port's only site lies between updates).
    ``checkpoint_path`` is set once the emergency checkpoint landed.
    """

    def __init__(
        self,
        message: str,
        site: str = "",
        partial: Optional[Dict[str, Any]] = None,
        checkpoint_path: Optional[str] = None,
    ):
        super().__init__(message)
        self.site = site
        self.partial = partial
        self.checkpoint_path = checkpoint_path


# ---------------------------------------------------------------------------
# the process-wide flag
# ---------------------------------------------------------------------------

_flag = threading.Event()
_reason: Optional[str] = None
_lock = threading.Lock()

# poll bookkeeping for PHOTON_PREEMPT_AT / install_plan: per-site poll
# counters survive clear() so an at=N spec fires exactly once per process —
# an in-process supervised restart must not be re-preempted by the same spec
_counts: Dict[str, int] = {}
_installed_plan: Optional[Dict[str, int]] = None
_env_cache: Tuple[Optional[str], Optional[Dict[str, int]]] = (None, None)


def request(why: str) -> None:
    """Set the preemption flag (signal-handler-safe: one Event.set)."""
    global _reason
    with _lock:
        if _reason is None:
            _reason = why
    _flag.set()


def requested() -> bool:
    return _flag.is_set()


def reason() -> Optional[str]:
    return _reason


def clear() -> None:
    """Drop the flag (the restart supervisor calls this between attempts).
    Poll counters are kept: an ``at=N`` spec fires once per process."""
    global _reason
    _flag.clear()
    with _lock:
        _reason = None


def reset() -> None:
    """Full reset incl. poll counters and the installed plan (tests)."""
    global _installed_plan, _env_cache
    clear()
    with _lock:
        _counts.clear()
    _installed_plan = None
    _env_cache = (None, None)


def parse_preempt_env(value: str) -> Dict[str, int]:
    """``"site:N[;site2:M]"`` -> {site: N} (N = 1-based poll count; a bare
    ``site`` means its first poll)."""
    plan: Dict[str, int] = {}
    for chunk in value.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        site, _, at = chunk.partition(":")
        site = site.strip()
        if site not in SITES:
            raise ValueError(
                f"unknown {PREEMPT_ENV} site {site!r} in {chunk!r} "
                f"(expected one of {SITES})"
            )
        try:
            n = int(at) if at.strip() else 1
        except ValueError as e:
            raise ValueError(
                f"bad {PREEMPT_ENV} count in {chunk!r} (want site:N): {e}"
            ) from e
        if n < 1:
            raise ValueError(f"{PREEMPT_ENV} count must be >= 1, got {n}")
        plan[site] = n
    return plan


def install_plan(plan: Optional[Dict[str, int]]) -> None:
    """Install (or with None, remove) an explicit {site: fire-at-poll-N}
    plan; wins over ``PHOTON_PREEMPT_AT``. Resets poll counters."""
    global _installed_plan
    _installed_plan = dict(plan) if plan is not None else None
    with _lock:
        _counts.clear()


def _active_plan() -> Optional[Dict[str, int]]:
    global _env_cache
    if _installed_plan is not None:
        return _installed_plan
    env = os.environ.get(PREEMPT_ENV)
    if not env:
        return None
    if _env_cache[0] != env:
        _env_cache = (env, parse_preempt_env(env))
        with _lock:
            _counts.clear()  # a new spec starts its own poll numbering
    return _env_cache[1]


def check(site: str, **context: Any) -> bool:
    """Poll for preemption at ``site``; True when the loop should drain.

    Counts the poll against the active ``PHOTON_PREEMPT_AT`` plan (the
    N-th poll of a planned site sets the flag, once per process) and gives
    the seeded fault registry its shot via the ``preempt.signal`` site —
    then reports the flag, however it was raised (signal, injection, or an
    explicit :func:`request`).
    """
    plan = _active_plan()
    if plan is not None and site in plan:
        with _lock:
            _counts[site] = _counts.get(site, 0) + 1
            hit = _counts[site]
        if hit == plan[site]:
            request(f"{PREEMPT_ENV} fired at {site} poll {hit}")
    if faults.flag("preempt.signal", poll_site=site, **context):
        request(f"injected preempt.signal at {site}")
    return _flag.is_set()


# ---------------------------------------------------------------------------
# signal handling
# ---------------------------------------------------------------------------

SIGNALS = (_signal.SIGTERM, _signal.SIGINT)


def install_signal_handlers():
    """Route ``SIGNALS`` to :func:`request`; returns {signum: previous
    handler} for restoration. Outside the main thread (where Python forbids
    signal registration) this is a logged no-op returning {}."""

    def _handler(signum, frame):
        # async-signal-safe: set the flag, nothing else — the training loop
        # drains at its next safe boundary
        request(f"signal {_signal.Signals(signum).name}")

    prev = {}
    for sig in SIGNALS:
        try:
            prev[sig] = _signal.signal(sig, _handler)
        except ValueError:
            # not the main thread (e.g. a driver invoked from a test
            # worker): cooperative preemption still works via check()/
            # request(), only OS signals cannot be routed from here
            logger.warning(
                "cannot install handler for %s outside the main thread; "
                "relying on PHOTON_PREEMPT_AT / explicit request()", sig
            )
    return prev


class signal_scope:
    """``with signal_scope():`` — SIGTERM/SIGINT set the preemption flag
    for the duration; previous handlers restored on exit."""

    def __init__(self):
        self._prev = {}

    def __enter__(self) -> "signal_scope":
        self._prev = install_signal_handlers()
        return self

    def __exit__(self, *exc) -> None:
        for sig, handler in self._prev.items():
            try:
                _signal.signal(sig, handler)
            except ValueError:
                pass  # thread changed between enter and exit; nothing held
        return None


# ---------------------------------------------------------------------------
# restart supervision (in-process)
# ---------------------------------------------------------------------------

T = TypeVar("T")


def run_with_restarts(
    run_once: Callable[[int], T],
    max_restarts: int,
    on_restart: Optional[Callable[[int, Preempted], None]] = None,
) -> T:
    """Call ``run_once(attempt)``; on :class:`Preempted`, clear the flag and
    relaunch up to ``max_restarts`` times (attempt numbers 0..max_restarts).
    The relaunched attempt resumes from the latest checkpoint through the
    caller's normal restore path — this helper only supervises. The final
    attempt's :class:`Preempted` propagates (the driver turns it into
    :data:`PREEMPT_EXIT_CODE`).
    """
    attempt = 0
    while True:
        try:
            return run_once(attempt)
        except Preempted as e:
            if attempt >= max_restarts:
                raise
            attempt += 1
            if on_restart is not None:
                on_restart(attempt, e)
            # keep the poll counters: the PHOTON_PREEMPT_AT spec that fired
            # must not re-fire and re-kill every restarted attempt
            clear()
