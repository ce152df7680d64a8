"""Logger: verbosity-filtered logging with pluggable reporters and
last-log retrieval (reference: band/logger.{h,cc} — singleton with
reporter callbacks for embedding in host applications)."""

from __future__ import annotations

import enum
import sys
import threading
import time
from typing import Callable, List, Optional, Tuple


class LogSeverity(enum.IntEnum):
    INTERNAL = 0
    DEBUG = 1
    INFO = 2
    WARNING = 3
    ERROR = 4


Reporter = Callable[[LogSeverity, str], None]


class Logger:
    """Process-wide logger (reference: band/logger.h:43-97)."""

    _instance: Optional["Logger"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._verbosity = LogSeverity.INFO
        self._reporters: List[Reporter] = []
        self._last: Optional[Tuple[LogSeverity, str]] = None
        self._lock = threading.Lock()
        self._once_keys: set = set()

    @classmethod
    def get(cls) -> "Logger":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Logger()
            return cls._instance

    def set_verbosity(self, severity: LogSeverity) -> None:
        self._verbosity = severity

    def add_reporter(self, reporter: Reporter) -> int:
        with self._lock:
            self._reporters.append(reporter)
            return len(self._reporters) - 1

    def remove_reporter(self, handle: int) -> None:
        with self._lock:
            if 0 <= handle < len(self._reporters):
                self._reporters[handle] = lambda s, m: None

    def get_last_log(self) -> Optional[Tuple[LogSeverity, str]]:
        return self._last

    def log(self, severity: LogSeverity, fmt: str, *args) -> None:
        msg = fmt % args if args else fmt
        self._last = (severity, msg)
        if severity < self._verbosity:
            return
        stamp = time.strftime("%H:%M:%S")
        line = f"[band-tpu {severity.name} {stamp}] {msg}"
        with self._lock:
            reporters = list(self._reporters)
        if reporters:
            for r in reporters:
                try:
                    r(severity, msg)
                except Exception:
                    # a broken user reporter must not take down the
                    # runtime thread that happened to log
                    print(line, file=sys.stderr)
        else:
            print(line, file=sys.stderr)

    def log_once(self, key: str, severity: LogSeverity, fmt: str, *args) -> None:
        with self._lock:
            if key in self._once_keys:
                return
            self._once_keys.add(key)
        self.log(severity, fmt, *args)


def log_debug(fmt: str, *args) -> None:
    Logger.get().log(LogSeverity.DEBUG, fmt, *args)


def log_info(fmt: str, *args) -> None:
    Logger.get().log(LogSeverity.INFO, fmt, *args)


def log_warning(fmt: str, *args) -> None:
    Logger.get().log(LogSeverity.WARNING, fmt, *args)


def log_error(fmt: str, *args) -> None:
    Logger.get().log(LogSeverity.ERROR, fmt, *args)
