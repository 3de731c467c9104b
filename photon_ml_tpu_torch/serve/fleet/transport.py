"""Fleet wire protocol: JSON-lines over TCP, plus an in-process client (port
of photon_ml_tpu/serve/fleet/transport.py).

One message dispatch function (:func:`dispatch`) serves both transports,
so the in-process path and the TCP path run the identical replica code:

  * :class:`LocalReplicaClient` — direct in-process calls against a
    :class:`~photon_ml_tpu_torch.serve.fleet.replica.ReplicaEngine` (no
    sockets; contribution arrays pass through as float lists the same way
    the wire carries them).
  * :class:`ReplicaServer` / :class:`TcpReplicaClient` — a threaded TCP
    server speaking one JSON object per line (the serve driver's framing),
    and a pooled client. No network framework — the deployment fronts this
    with whatever transport it has, like the serve driver's stdin/stdout
    loop. Every client call carries a timeout.

JSON float round trip: contributions are f32 widened to f64 for the wire;
Python's ``repr``-based JSON floats round-trip f64 exactly, so the router's
f32 narrowing is bitwise the replica's device output.
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import socketserver
import threading
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch.serve.fleet.replica import ReplicaEngine, StaleGenerationError

logger = logging.getLogger(__name__)


class ReplicaUnavailableError(OSError):
    """The replica could not be reached or failed the call — the router's
    cue to retry, reroute (fixed parts), or degrade (random parts)."""


def _np_to_wire(contribs: Dict[str, np.ndarray]) -> Dict[str, List[float]]:
    return {k: [float(x) for x in v] for k, v in contribs.items()}


def dispatch(engine: ReplicaEngine, msg: dict) -> dict:
    """One protocol message -> one response dict (shared by both
    transports). Every response carries ``ok``; failures are structured
    (``stale_generation`` lets the router re-score at the current epoch
    instead of degrading)."""
    cmd = msg.get("cmd")
    try:
        if cmd == "contribs":
            contribs = engine.contribs(
                msg.get("rows") or [],
                want_fixed=bool(msg.get("fixed")),
                want_random=list(msg.get("random") or []),
                epoch=msg.get("epoch"),
            )
            return {
                "ok": True,
                "epoch": engine.epoch,
                "contribs": _np_to_wire(contribs),
            }
        if cmd == "score":
            scores = engine.score_rows(msg.get("rows") or [])
            return {"ok": True, "scores": [float(s) for s in scores]}
        if cmd == "prepare":
            report = engine.prepare(
                msg.get("store_dir", ""), int(msg.get("epoch", -1))
            )
            return {"ok": True, **report}
        if cmd == "commit":
            return {"ok": True, **engine.commit(int(msg.get("epoch", -1)))}
        if cmd == "abandon":
            return {"ok": True, **engine.abandon()}
        if cmd == "ping":
            return {
                "ok": True,
                "replica": engine.replica_id,
                "epoch": engine.epoch,
            }
        if cmd == "stats":
            return {
                "ok": True,
                "stats": engine.stats.snapshot(),
                "new_request_compiles": engine.new_request_compiles(),
            }
        return {"ok": False, "error": f"unknown cmd {cmd!r}"}
    except StaleGenerationError as e:
        # the replica's CURRENT epoch rides along so the router can fast-
        # forward a stale dispatch generation (e.g. a freshly started
        # router joining a fleet that already swapped)
        return {
            "ok": False,
            "stale_generation": True,
            "epoch": engine.epoch,
            "error": str(e),
        }
    except Exception as e:  # noqa: BLE001 — protocol fence: a bad message must fail ITS caller, not kill the replica loop
        logger.warning("replica %d %s failed: %s", engine.replica_id, cmd, e)
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


# ---------------------------------------------------------------------------
# in-process client
# ---------------------------------------------------------------------------


class LocalReplicaClient:
    """Direct calls against an in-process engine. ``fail_mode`` simulates a
    lost replica for chaos tests: once set, every call raises the same
    connection error a dead TCP peer produces."""

    def __init__(self, engine: ReplicaEngine):
        self.engine = engine
        self.fail_mode: Optional[str] = None

    def call(self, msg: dict, timeout: Optional[float] = None) -> dict:
        if self.fail_mode:
            raise ReplicaUnavailableError(
                f"replica {self.engine.replica_id} unavailable "
                f"({self.fail_mode})"
            )
        return dispatch(self.engine, msg)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# TCP transport
# ---------------------------------------------------------------------------


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        engine = self.server.engine  # type: ignore[attr-defined]
        for raw in self.rfile:
            line = raw.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError as e:
                resp = {"ok": False, "error": f"bad JSON: {e}"}
            else:
                if msg.get("cmd") == "shutdown":
                    self.wfile.write(b'{"ok": true}\n')
                    self.server.shutdown_requested.set()  # type: ignore[attr-defined]
                    return
                resp = dispatch(engine, msg)
            self.wfile.write((json.dumps(resp) + "\n").encode("utf-8"))
            self.wfile.flush()


class ReplicaServer(socketserver.ThreadingTCPServer):
    """Threaded JSON-lines TCP front for one ReplicaEngine. Bind with
    port 0 to get an ephemeral port (``server_address[1]``)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, engine: ReplicaEngine, host: str = "127.0.0.1",
                 port: int = 0):
        super().__init__((host, port), _Handler)
        self.engine = engine
        self.shutdown_requested = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> "ReplicaServer":
        self._thread = threading.Thread(
            target=self.serve_forever,
            name=f"photon-fleet-replica-{self.engine.replica_id}",
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_until_shutdown(self, poll_s: float = 0.2) -> None:
        """Blocking variant for the CLI replica process: serve until a
        ``shutdown`` message arrives."""
        self.start()
        while not self.shutdown_requested.wait(poll_s):
            pass
        self.stop()

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class TcpReplicaClient:
    """Pooled JSON-lines client: one persistent connection per concurrent
    call (connections return to the pool on success, drop on failure so a
    dead peer never poisons the pool)."""

    def __init__(self, address: str, connect_timeout_s: float = 5.0):
        host, _, port = address.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.connect_timeout_s = connect_timeout_s
        self._pool: "queue.Queue[socket.socket]" = queue.Queue()
        self._closed = False

    def _connect(self) -> socket.socket:
        try:
            return socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout_s
            )
        except OSError as e:
            raise ReplicaUnavailableError(
                f"cannot connect to replica at {self.host}:{self.port}: {e}"
            ) from e

    def call(self, msg: dict, timeout: Optional[float] = None) -> dict:
        if self._closed:
            raise ReplicaUnavailableError("client closed")
        try:
            conn = self._pool.get_nowait()
        except queue.Empty:
            conn = self._connect()
        try:
            conn.settimeout(timeout)
            conn.sendall((json.dumps(msg) + "\n").encode("utf-8"))
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = conn.recv(1 << 16)
                if not chunk:
                    raise ReplicaUnavailableError(
                        f"replica at {self.host}:{self.port} closed the "
                        "connection mid-call"
                    )
                buf += chunk
        except ReplicaUnavailableError:
            conn.close()
            raise
        except (OSError, ValueError) as e:
            conn.close()
            raise ReplicaUnavailableError(
                f"call to replica at {self.host}:{self.port} failed: {e}"
            ) from e
        self._pool.put(conn)
        return json.loads(buf.decode("utf-8"))

    def close(self) -> None:
        self._closed = True
        while True:
            try:
                self._pool.get_nowait().close()
            except queue.Empty:
                return
