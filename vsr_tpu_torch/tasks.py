"""Headless batch task queue: the port's counterpart of ``vsr_tpu/tasks.py``
(the reference GUI's multi-file processing,
ui/component/task_list_component.py:17-60 Task model +
ui/home_interface.py:312-470 worker loop), without Qt.

Each task runs a SubtitleRemover in a spawned subprocess (isolating device
state and crashes, as the reference does), reporting progress/log/finish over
a RemoteCallChannel. Workers are spawned, never forked: the parent may hold a
CUDA context, which a forked child cannot use. The worker resolves its device
itself and names it in its first log line; a worker that cannot (no card, a
kernel library that does not build) ends its task FAILED with the error and
never falls back to the CPU. Output-path policy matches the reference:
``<stem>_no_sub.mp4`` next to the input (images go to ``no_sub/<name>``).

This module imports no torch: the process that queues tasks (the GUI
server) touches no device, only its workers do.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import multiprocessing
import os
from pathlib import Path
from typing import Callable, List, Optional, Tuple

from vsr_tpu_torch.config import Config
from vsr_tpu_torch.utils.process_manager import ProcessManager
from vsr_tpu_torch.utils.remote_call import Command, RemoteCallChannel, RemoteCallClient

_task_uid = itertools.count()

IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


class TaskStatus(enum.Enum):
    PENDING = "pending"
    PROCESSING = "processing"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclasses.dataclass
class TaskOptions:
    sub_areas: List[Tuple[int, int, int, int]] = dataclasses.field(default_factory=list)
    ab_sections: Optional[List[range]] = None


@dataclasses.dataclass
class Task:
    path: str
    options: TaskOptions = dataclasses.field(default_factory=TaskOptions)
    output_path: Optional[str] = None
    status: TaskStatus = TaskStatus.PENDING
    progress: int = 0
    error: Optional[str] = None
    # stable identity independent of queue position (list indices shift when
    # lower-index tasks are removed mid-run)
    uid: int = dataclasses.field(default_factory=lambda: next(_task_uid))

    @property
    def name(self) -> str:
        return Path(self.path).name

    @property
    def is_image(self) -> bool:
        return os.path.splitext(self.path)[-1].lower() in IMAGE_EXTENSIONS

    def default_output_path(self) -> str:
        stem = Path(self.path).stem
        ext = os.path.splitext(self.path)[-1].lower()
        if ext in IMAGE_EXTENSIONS:
            return os.path.join(os.path.dirname(self.path), "no_sub",
                                f"{stem}{ext}")
        return os.path.join(os.path.dirname(self.path), f"{stem}_no_sub.mp4")


def open_remover(path, output, options: TaskOptions, config_json, device,
                 client: RemoteCallClient):
    """In a worker: resolve ``device``, log it as the first line, and build
    the SubtitleRemover with its log and progress going to ``client``."""
    import torch

    from vsr_tpu_torch.pipeline import SubtitleRemover
    from vsr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host CPU"
    client.log(f"device: {dev} ({name})")
    remover = SubtitleRemover(
        path, output_path=output, sub_areas=options.sub_areas,
        config=Config.from_json(config_json), device=device)
    remover.ab_sections = options.ab_sections
    remover.append_output = lambda *a: client.log(" ".join(str(x) for x in a))
    remover.add_progress_listener(lambda pct, done: client.progress(pct, done))
    return remover


def _worker(path, output, options: TaskOptions, config_json, device, queue):
    """Subprocess entry: run the remover, streaming progress to the queue."""
    client = RemoteCallClient(queue)
    try:
        client.manage_process(os.getpid())
        remover = open_remover(path, output, options, config_json, device, client)
        remover.run()
        client.finish(remover.video_out_path)
    except Exception as e:  # surfaced as task failure, not a crash
        import traceback

        client.error(f"{e}\n{traceback.format_exc()}")


class TaskRunner:
    """Sequential task executor (one device, one task at a time — matching
    the reference's single worker thread)."""

    def __init__(self, config: Optional[Config] = None,
                 on_log: Optional[Callable[[str], None]] = None,
                 on_progress: Optional[Callable[[Task], None]] = None,
                 device: str = "cuda"):
        self.config = config or Config()
        self.device = str(device)
        self.tasks: List[Task] = []
        self.on_log = on_log or (lambda msg: None)
        self.on_progress = on_progress or (lambda task: None)

    def add(self, path: str, options: Optional[TaskOptions] = None,
            output_path: Optional[str] = None) -> Task:
        task = Task(path=path, options=options or TaskOptions(),
                    output_path=output_path)
        self.tasks.append(task)
        return task

    def run_all(self) -> List[Task]:
        for task in self.tasks:
            if task.status == TaskStatus.PENDING:
                self._run_one(task)
        return self.tasks

    def _run_one(self, task: Task) -> None:
        task.status = TaskStatus.PROCESSING
        output = task.output_path or task.default_output_path()
        channel = RemoteCallChannel()

        def on_progress(payload):
            task.progress = int(payload["percent"])
            self.on_progress(task)

        def on_log(payload):
            self.on_log(payload["message"])

        def on_error(payload):
            task.error = payload["message"]

        def on_finish(payload):
            task.output_path = payload["output"]

        channel.register(Command.PROGRESS, on_progress)
        channel.register(Command.LOG, on_log)
        channel.register(Command.ERROR, on_error)
        channel.register(Command.FINISH, on_finish)
        channel.start()

        ctx = multiprocessing.get_context("spawn")
        proc = ctx.Process(
            target=_worker,
            args=(task.path, output, task.options,
                  self.config.to_json(), self.device, channel.queue),
        )
        proc.start()
        ProcessManager.instance().add_process(proc)
        proc.join()
        channel.stop()
        ProcessManager.instance().remove_process(proc)

        if task.error or proc.exitcode != 0:
            task.status = TaskStatus.FAILED
            if not task.error:
                task.error = f"worker exited with code {proc.exitcode}"
        else:
            task.status = TaskStatus.COMPLETED
            task.progress = 100
