"""Thread-safe severity logging.

Re-design of the reference's ``Log`` component
(reference: src/engine/log.cppm:28-108): three severities where Info routes to
an "out" stream (std::clog analogue) and Warning/Error route to an "error"
stream (std::cerr analogue), each log line prefixed with a ``[file:line]``
source-location preamble, all writes serialized by a mutex.

The reference exposes an ostream proxy (``log(severity) << x << y``); here the
idiomatic Python surface is ``log.info/warn/error(*parts)`` plus a ``print``
escape hatch mirroring ``Log::Print`` (log.cppm:156-172).
"""

from __future__ import annotations

import enum
import inspect
import os
import sys
import threading
from typing import IO, Any


class Severity(enum.Enum):
    """Log severity levels (reference: src/engine/log.cppm:31-38)."""

    INFO = "INFO"
    WARNING = "WARNING"
    ERROR = "ERROR"


class Log:
    """A thread-safe logger routing severities to caller-supplied streams.

    Reference semantics (src/engine/log.cppm:76-108): Info goes to the
    "output" stream, Warning and Error to the "error" stream; each line is
    prefixed ``[basename:line]``; a mutex guarantees whole-line atomicity.
    """

    def __init__(self, out_stream: IO[str] | None = None, err_stream: IO[str] | None = None):
        self._out = out_stream if out_stream is not None else sys.stderr
        self._err = err_stream if err_stream is not None else sys.stderr
        self._mutex = threading.Lock()

    # -- stream selection (log.cppm:118-127) --------------------------------
    def stream_for(self, severity: Severity) -> IO[str]:
        return self._out if severity is Severity.INFO else self._err

    # -- core write ----------------------------------------------------------
    def write(self, severity: Severity, *parts: Any, _stacklevel: int = 1) -> None:
        """Write one atomic log line with a ``[file:line]`` preamble.

        `_stacklevel` counts frames from this function to the user call site
        (1 = direct caller of ``write``).
        """
        frame = inspect.currentframe()
        for _ in range(_stacklevel):
            if frame is not None and frame.f_back is not None:
                frame = frame.f_back
        if frame is not None:
            filename = os.path.basename(frame.f_code.co_filename)
            lineno = frame.f_lineno
            preamble = f"[{filename}:{lineno}]"
        else:  # pragma: no cover - interpreter without frame introspection
            preamble = "[?:?]"
        message = " ".join(str(part) for part in parts)
        line = f"{preamble} {severity.value}: {message}\n"
        stream = self.stream_for(severity)
        with self._mutex:
            stream.write(line)
            stream.flush()

    # -- public severity helpers --------------------------------------------
    def info(self, *parts: Any) -> None:
        self.write(Severity.INFO, *parts, _stacklevel=2)

    def warn(self, *parts: Any) -> None:
        self.write(Severity.WARNING, *parts, _stacklevel=2)

    def error(self, *parts: Any) -> None:
        self.write(Severity.ERROR, *parts, _stacklevel=2)

    def print(self, severity: Severity, *parts: Any) -> None:
        """Explicit-severity write (reference: Log::Print, log.cppm:156-172)."""
        self.write(severity, *parts, _stacklevel=2)


_default_lock = threading.Lock()
_default_log: Log | None = None


def default_log() -> Log:
    """Process-wide default logger (reference: Log::Default, log.cppm:50-53)."""
    global _default_log
    with _default_lock:
        if _default_log is None:
            _default_log = Log()
        return _default_log
