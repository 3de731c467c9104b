"""Run the port on several ranks of a gloo process group on the CPU, each
rank its own Python process, joined under a deadline (a test fails, it
never hangs).

    run_ranks("torch_rank_jobs:job", world, tmp_path, payload)

runs ``job(mh, payload)`` on every rank (``mh`` the rank's
``MultihostContext``) and returns the ranks' return values in rank order;
``launch(argvs, tmp_path)`` runs one command line per rank (the multihost
drivers). The group comes up through a ``file://`` store under
``tmp_path``, so no port is ever raced for.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import time
import uuid
from typing import List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# collectives give up after this long, so a dead peer fails the test fast
COLLECTIVE_TIMEOUT_S = "60"


def _env(extra: Optional[dict] = None) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join([REPO, HERE, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env.setdefault("PHOTON_COLLECTIVE_TIMEOUT", COLLECTIVE_TIMEOUT_S)
    # one intra-op thread per rank: the ranks share the machine's cores
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update(extra or {})
    return env


def init_url(tmp_path) -> str:
    return f"file://{os.path.join(str(tmp_path), 'pg-' + uuid.uuid4().hex)}"


def _join(procs, timeout: float) -> List[subprocess.CompletedProcess]:
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
            outs.append(subprocess.CompletedProcess(p.args, p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"ranks did not finish within {timeout:g} s")
    return outs


def launch(argvs: Sequence[Sequence[str]], timeout: float = 240.0,
           env: Optional[dict] = None, check: bool = True,
           rank_envs: Optional[Sequence[dict]] = None) -> List[subprocess.CompletedProcess]:
    """One process per command line, started together, joined under a
    deadline; with ``check`` every rank must exit 0. ``rank_envs[r]`` adds
    to rank ``r``'s environment only."""
    procs = [subprocess.Popen([sys.executable] + list(a), cwd=REPO,
                              env=_env({**(env or {}), **(rank_envs[r] if rank_envs else {})}),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r, a in enumerate(argvs)]
    outs = _join(procs, timeout)
    if check:
        for r, o in enumerate(outs):
            assert o.returncode == 0, f"rank {r} exited {o.returncode}:\n{o.stdout}\n{o.stderr}"
    return outs


def run_ranks(target: str, world: int, tmp_path, payload=None, timeout: float = 180.0,
              env: Optional[dict] = None, device: str = "cpu", check: bool = True,
              rank_envs: Optional[Sequence[dict]] = None) -> list:
    """``target`` ("module:function") on ``world`` ranks, each on
    ``device`` (every rank on the card is ``cuda:0`` there); their
    results. Without ``check`` a rank that exits non-zero gives its
    ``CompletedProcess`` in place of a result."""
    tag = uuid.uuid4().hex
    inp = os.path.join(str(tmp_path), f"ranks-{tag}.in")
    with open(inp, "wb") as f:
        pickle.dump(payload, f)
    init = init_url(tmp_path)
    outs = [os.path.join(str(tmp_path), f"ranks-{tag}-{r}.out") for r in range(world)]
    done = launch([[__file__, target, str(r), str(world), init, inp, outs[r], device]
                   for r in range(world)], timeout=timeout, env=env, check=check,
                  rank_envs=rank_envs)
    results = []
    for path, proc in zip(outs, done):
        if proc.returncode != 0:
            results.append(proc)
            continue
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def _rank_main(target, rank, world, init, inp, out, device) -> None:
    from photon_ml_tpu_torch.device import enable_determinism
    from photon_ml_tpu_torch.parallel import multihost

    enable_determinism()  # before any CUDA work, as the drivers do

    mod, fn = target.split(":")
    job = getattr(importlib.import_module(mod), fn)
    with open(inp, "rb") as f:
        payload = pickle.load(f)
    mh = multihost.initialize(init, int(world), int(rank), device=device)
    try:
        result = job(mh, payload)
    finally:
        multihost.shutdown()
    with open(out, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
