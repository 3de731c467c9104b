"""Run logger: writes a local log file, copied to the output dir on close.

Reference spec: util/PhotonLogger.scala:38-520 — an slf4j-style logger that
writes to a local tmp file and uploads it to HDFS on close; level constants
DEBUG/INFO/WARN/ERROR. Here the "HDFS upload" is a file copy into the run's
output directory (works for local paths and fsspec-style mounts).
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile
from typing import Optional

LEVEL_DEBUG = 10
LEVEL_INFO = 20
LEVEL_WARN = 30
LEVEL_ERROR = 40

_LEVEL_NAMES = {10: "DEBUG", 20: "INFO", 30: "WARN", 40: "ERROR"}


class PhotonLogger:
    """File + stderr logger with a copy-to-output-dir close step."""

    def __init__(self, output_path: Optional[str] = None, level: int = LEVEL_INFO,
                 echo: bool = True):
        self.output_path = output_path
        self.level = level
        self.echo = echo
        fd, self._tmp_path = tempfile.mkstemp(prefix="photon-log-", suffix=".txt")
        self._file = os.fdopen(fd, "w")
        self._closed = False

    def _log(self, level: int, msg: str) -> None:
        if level < self.level or self._closed:
            return
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        line = f"{ts} [{_LEVEL_NAMES[level]}] {msg}"
        self._file.write(line + "\n")
        self._file.flush()
        if self.echo:
            print(line, file=sys.stderr)

    def debug(self, msg: str) -> None:
        self._log(LEVEL_DEBUG, msg)

    def info(self, msg: str) -> None:
        self._log(LEVEL_INFO, msg)

    def warn(self, msg: str) -> None:
        self._log(LEVEL_WARN, msg)

    def error(self, msg: str) -> None:
        self._log(LEVEL_ERROR, msg)

    def close(self) -> None:
        """Flush and copy the log to the output path (PhotonLogger:72-88)."""
        if self._closed:
            return
        self._file.close()
        self._closed = True
        if self.output_path:
            os.makedirs(os.path.dirname(self.output_path) or ".", exist_ok=True)
            shutil.copyfile(self._tmp_path, self.output_path)
        os.unlink(self._tmp_path)

    def __enter__(self) -> "PhotonLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
