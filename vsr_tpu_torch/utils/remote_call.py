"""Cross-process command channel for parent <-> worker communication.

Parity with backend/tools/subtitle_remover_remote_call.py:5-75: the worker
subprocess pushes typed commands (progress / log / preview / finish / error)
onto a multiprocessing.Queue; the parent side runs a consumer thread that
dispatches to registered callbacks. This replaces the reference's GUI<->worker
RPC without any Qt dependency — callbacks are plain callables.

A copy of ``vsr_tpu/utils/remote_call.py``, except that the consumer
drains what was queued before stop() (F5 in ROADMAP.md).
"""

from __future__ import annotations

import enum
import multiprocessing
import threading
from typing import Any, Callable, Dict, Optional


class Command(enum.Enum):
    FINISH = "finish"
    PROGRESS = "progress"
    LOG = "log"
    MANAGE_PROCESS = "manage_process"
    ERROR = "error"
    UPDATE_PREVIEW = "update_preview"


class RemoteCallChannel:
    """Parent-side endpoint: owns the queue and the consumer thread."""

    def __init__(self, ctx: str = "spawn") -> None:
        # spawn context: workers are spawned (never forked) so device state
        # and threads don't leak into children (ref uses spawn too, main.py:474)
        self.queue = multiprocessing.get_context(ctx).Queue()
        self._callbacks: Dict[Command, Callable[[Any], None]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    def register(self, command: Command, callback: Callable[[Any], None]) -> None:
        self._callbacks[command] = callback

    def start(self) -> None:
        self._thread = threading.Thread(target=self._consume, daemon=True)
        self._thread.start()

    def _consume(self) -> None:
        # after stop() the queue is still drained: a worker's last message
        # (its ERROR or FINISH) may sit behind the stop sentinel's
        # predecessor, and dropping it would report a failed task as done
        while True:
            try:
                item = self.queue.get(timeout=0.5)
            except Exception:
                if self._stopped.is_set():
                    return
                continue
            if item is None:
                return
            command, payload = item
            cb = self._callbacks.get(Command(command))
            if cb is not None:
                try:
                    cb(payload)
                except Exception:
                    pass
            if Command(command) in (Command.FINISH, Command.ERROR):
                return

    def stop(self) -> None:
        self._stopped.set()
        try:
            self.queue.put_nowait(None)
        except Exception:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)


class RemoteCallClient:
    """Worker-side endpoint: serializes commands onto the shared queue."""

    def __init__(self, queue: multiprocessing.Queue) -> None:
        self.queue = queue

    def _put(self, command: Command, payload: Any = None) -> None:
        try:
            self.queue.put((command.value, payload))
        except Exception:
            pass

    def progress(self, percent: int, finished: bool = False) -> None:
        self._put(Command.PROGRESS, {"percent": percent, "finished": finished})

    def log(self, message: str, level: str = "info") -> None:
        self._put(Command.LOG, {"message": message, "level": level})

    def error(self, message: str) -> None:
        self._put(Command.ERROR, {"message": message})

    def finish(self, output_path: str) -> None:
        self._put(Command.FINISH, {"output": output_path})

    def manage_process(self, pid: int) -> None:
        self._put(Command.MANAGE_PROCESS, {"pid": pid})
