"""GUI task manager: async batch execution with progress/log/preview state.

The port's counterpart of ``vsr_tpu/gui/manager.py``, with the device a
worker runs on passed down to it. The web equivalent of the reference's
HomeInterface worker loop (ui/home_interface.py:312-470): a single background thread takes pending
tasks one at a time (one device, one task), spawns a worker subprocess per
task, and mirrors its queue commands (progress / log / preview / finish /
error) into state the HTTP layer serves. Stop semantics match the GUI's
close/kill path (ProcessManager terminate, home_interface.py:378-384).
This process touches no device: each task's worker resolves its own.
"""

from __future__ import annotations

import collections
import multiprocessing
import os
import threading
import time
from typing import Any, Dict, List, Optional

from vsr_tpu_torch.config import Config
from vsr_tpu_torch.tasks import Task, TaskOptions, TaskStatus, open_remover
from vsr_tpu_torch.utils.process_manager import ProcessManager
from vsr_tpu_torch.utils.remote_call import Command, RemoteCallChannel, RemoteCallClient

MAX_LOG_LINES = 500
PREVIEW_MIN_INTERVAL_S = 0.5
PREVIEW_HEIGHT = 270


def _gui_worker(path, output, options: TaskOptions, config_json, device, queue):
    """Subprocess entry: tasks._worker plus throttled JPEG preview frames
    (the reference's update_preview_with_comp stream, main.py:244,331)."""
    client = RemoteCallClient(queue)
    try:
        client.manage_process(os.getpid())
        import cv2
        import numpy as np

        remover = open_remover(path, output, options, config_json, device, client)

        last = [0.0]

        def preview(original: np.ndarray, inpainted: np.ndarray) -> None:
            now = time.time()
            if now - last[0] < PREVIEW_MIN_INTERVAL_S:
                return
            last[0] = now
            pair = cv2.hconcat([original, inpainted])
            scale = PREVIEW_HEIGHT / pair.shape[0]
            pair = cv2.resize(pair, (int(pair.shape[1] * scale),
                                     PREVIEW_HEIGHT))
            ok, buf = cv2.imencode(".jpg", pair,
                                   [cv2.IMWRITE_JPEG_QUALITY, 80])
            if ok:
                client._put(Command.UPDATE_PREVIEW, {"jpeg": buf.tobytes()})

        remover.preview_cb = preview
        remover.run()
        client.finish(remover.video_out_path)
    except Exception as e:
        import traceback

        client.error(f"{e}\n{traceback.format_exc()}")


class GuiTaskManager:
    """Thread-safe task queue + one-at-a-time background executor."""

    def __init__(self, config: Optional[Config] = None, device: str = "cuda"):
        self.config = config or Config()
        self.device = str(device)
        self.tasks: List[Task] = []
        self._previews: Dict[int, bytes] = {}  # task uid -> latest jpeg
        # (keyed by Task.uid, not list index: removing a lower-index task
        # shifts indices mid-run and would attach previews to the wrong task)
        self._logs: collections.deque = collections.deque(maxlen=MAX_LOG_LINES)
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._current_proc: Optional[multiprocessing.process.BaseProcess] = None

    # ---- queue management (task_list_component semantics) ----
    def add(self, path: str, options: Optional[TaskOptions] = None,
            output_path: Optional[str] = None) -> int:
        with self._lock:
            task = Task(path=path, options=options or TaskOptions(),
                        output_path=output_path)
            self.tasks.append(task)
            return len(self.tasks) - 1

    def remove(self, index: int) -> bool:
        with self._lock:
            if not (0 <= index < len(self.tasks)):
                return False
            if self.tasks[index].status == TaskStatus.PROCESSING:
                return False  # reference disables removal of the active task
            task = self.tasks.pop(index)
            self._previews.pop(task.uid, None)
            return True

    def set_options(self, index: int,
                    sub_areas: Optional[List] = None,
                    ab_sections: Optional[List] = None,
                    output_path: Optional[str] = None) -> bool:
        """Per-task options, the GUI-subprocess handoff dict
        (home_interface.py:424-425)."""
        with self._lock:
            if not (0 <= index < len(self.tasks)):
                return False
            task = self.tasks[index]
            if sub_areas is not None:
                task.options.sub_areas = [tuple(a) for a in sub_areas]
            if ab_sections is not None:
                task.options.ab_sections = (
                    [range(a, b) for a, b in ab_sections] or None)
            if output_path is not None:
                task.output_path = output_path or None
            return True

    # ---- execution ----
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> bool:
        with self._lock:
            if self.running:
                return False
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
            return True

    def stop(self) -> None:
        """Abort: no new tasks start; the active worker is terminated."""
        self._stop.set()
        proc = self._current_proc
        if proc is not None and proc.is_alive():
            proc.terminate()

    def join(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                task = next((t for t in self.tasks
                             if t.status == TaskStatus.PENDING), None)
                if task is not None:
                    # claim it inside the lock so a concurrent remove() can't
                    # pull it out from under the executor (it refuses to
                    # remove PROCESSING tasks)
                    task.status = TaskStatus.PROCESSING
                    task.progress = 0
            if task is None:
                break
            self._run_one(task)

    def effective_config(self, task: Task) -> Config:
        """Per-task config: image tasks are locked to LAMA, mirroring the
        reference GUI (ui/home_interface.py:619-631 _lock_inpaint_mode_to_lama
        — images have no temporal context, so STTN/ProPainter don't apply)."""
        from vsr_tpu_torch.config import InpaintMode

        if task.is_image and self.config.inpaint_mode != InpaintMode.LAMA:
            cfg = Config.from_json(self.config.to_json())
            cfg.inpaint_mode = InpaintMode.LAMA
            return cfg
        return self.config

    def _spawn(self, task: Task, output: str, queue):
        """Overridable for tests: start the worker process."""
        ctx = multiprocessing.get_context("spawn")
        proc = ctx.Process(
            target=_gui_worker,
            args=(task.path, output, task.options,
                  self.effective_config(task).to_json(), self.device, queue),
        )
        proc.start()
        return proc

    def _run_one(self, task: Task) -> None:
        task.status = TaskStatus.PROCESSING
        task.progress = 0
        if task.is_image and self.effective_config(task) is not self.config:
            self._log(task, "image task: inpaint mode locked to lama "
                            "(images have no temporal context)", "info")
        output = task.output_path or task.default_output_path()
        channel = RemoteCallChannel()

        channel.register(Command.PROGRESS,
                         lambda p: setattr(task, "progress", int(p["percent"])))
        channel.register(Command.LOG, lambda p: self._log(
            task, p.get("message", ""), p.get("level", "info")))
        channel.register(Command.ERROR,
                         lambda p: setattr(task, "error", p["message"]))
        channel.register(
            Command.FINISH,
            lambda p: setattr(task, "output_path", p["output"]))
        channel.register(
            Command.UPDATE_PREVIEW,
            lambda p: self._previews.__setitem__(task.uid, p["jpeg"]))
        channel.start()

        proc = self._spawn(task, output, channel.queue)
        self._current_proc = proc
        ProcessManager.instance().add_process(proc)
        proc.join()
        self._current_proc = None
        channel.stop()
        ProcessManager.instance().remove_process(proc)

        if self._stop.is_set() and proc.exitcode not in (0,):
            task.status = TaskStatus.FAILED
            task.error = task.error or "stopped"
        elif task.error or proc.exitcode != 0:
            task.status = TaskStatus.FAILED
            if not task.error:
                task.error = f"worker exited with code {proc.exitcode}"
            self._log(task, task.error.splitlines()[0], "error")
        else:
            task.status = TaskStatus.COMPLETED
            task.progress = 100
            self._log(task, f"finished: {task.output_path}", "success")

    # ---- state for the HTTP layer ----
    def _log(self, task: Optional[Task], message: str, level: str) -> None:
        self._logs.append({"t": time.time(), "level": level,
                           "task": task.name if task else None,
                           "message": message})

    def preview_jpeg(self, index: int) -> Optional[bytes]:
        with self._lock:
            if not (0 <= index < len(self.tasks)):
                return None
            return self._previews.get(self.tasks[index].uid)

    def state(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "running": self.running,
                "tasks": [
                    {
                        "index": i,
                        "path": t.path,
                        "name": t.name,
                        "status": t.status.value,
                        "progress": t.progress,
                        "error": t.error,
                        "output_path": t.output_path
                        or t.default_output_path(),
                        "is_image": t.is_image,
                        # image tasks are locked to lama (reference
                        # home_interface.py:619-631); the UI disables the
                        # mode select and shows this value while an image
                        # task is selected
                        "inpaint_mode":
                            self.effective_config(t).inpaint_mode.value,
                        "sub_areas": [list(a) for a in t.options.sub_areas],
                        "ab_sections": [
                            [r.start, r.stop] for r in t.options.ab_sections
                        ] if t.options.ab_sections else [],
                        "has_preview": t.uid in self._previews,
                    }
                    for i, t in enumerate(self.tasks)
                ],
                "logs": list(self._logs),
            }
