"""Child-process registry with guaranteed teardown.

Parity with backend/tools/process_manager.py:14-128: a singleton registry of
spawned worker processes; ``terminate_all`` runs on interpreter exit (atexit)
and escalates terminate -> kill for stragglers.

A copy of ``vsr_tpu/utils/process_manager.py``.
"""

from __future__ import annotations

import atexit
import os
import signal
import threading
from typing import Dict, List


class ProcessManager:
    _instance = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._processes: List = []
        self._pids: List[int] = []
        self._registered = False

    @classmethod
    def instance(cls) -> "ProcessManager":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
        return cls._instance

    def _ensure_atexit(self) -> None:
        if not self._registered:
            atexit.register(self.terminate_all)
            self._registered = True

    def add_process(self, process) -> None:
        """Register a multiprocessing.Process / subprocess.Popen-like object."""
        self._ensure_atexit()
        self._processes.append(process)

    def add_pid(self, pid: int) -> None:
        self._ensure_atexit()
        self._pids.append(pid)

    def remove_process(self, process) -> None:
        if process in self._processes:
            self._processes.remove(process)

    def alive_count(self) -> int:
        return sum(1 for p in self._processes if self._is_alive(p))

    @staticmethod
    def _is_alive(process) -> bool:
        if hasattr(process, "is_alive"):
            return process.is_alive()
        if hasattr(process, "poll"):
            return process.poll() is None
        return False

    def terminate_all(self, timeout: float = 3.0) -> None:
        for p in self._processes:
            if not self._is_alive(p):
                continue
            try:
                p.terminate()
            except Exception:
                pass
        for p in self._processes:
            try:
                if hasattr(p, "join"):
                    p.join(timeout)
                elif hasattr(p, "wait"):
                    p.wait(timeout)
            except Exception:
                pass
        for p in self._processes:
            if self._is_alive(p):
                try:
                    p.kill()
                except Exception:
                    pass
        for pid in self._pids:
            try:
                os.kill(pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        self._processes.clear()
        self._pids.clear()
