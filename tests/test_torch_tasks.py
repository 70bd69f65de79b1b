"""The port's task queue and its auxiliaries (vsr_tpu_torch/tasks.py,
utils/{tracing,process_manager,remote_call}.py): the port's copies of
tests/test_aux.py's StageTimer, device_trace, process-manager, remote-call
and task-queue cases, a device_trace that writes a torch.profiler trace,
and spawned TaskRunner workers: one end to end on the CPU, one asked for a
card where there is none (FAILED, no fallback)."""

import json
import os
import subprocess
import sys
import time

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import cv2
import numpy as np
import pytest

from vsr_tpu_torch import tasks
from vsr_tpu_torch.config import Config, InpaintMode
from vsr_tpu_torch.tasks import Task, TaskOptions, TaskRunner, TaskStatus
from vsr_tpu_torch.utils.process_manager import ProcessManager
from vsr_tpu_torch.utils.remote_call import Command, RemoteCallChannel, RemoteCallClient
from vsr_tpu_torch.utils.tracing import StageTimer, device_trace

from tests.torch_narrow import narrow_sttn_worker


class TestStageTimer:
    def test_spans_accumulate(self):
        timer = StageTimer()
        with timer.span("work"):
            time.sleep(0.01)
        with timer.span("work"):
            time.sleep(0.01)
        s = timer.summary()
        assert s["work"]["count"] == 2
        assert s["work"]["total_s"] >= 0.02
        assert "work" in timer.report()

    def test_device_trace_noop_without_env(self, monkeypatch, tmp_path):
        monkeypatch.delenv("VSR_TRACE_DIR", raising=False)
        monkeypatch.chdir(tmp_path)
        with device_trace("x"):
            pass  # must not require a profiler or a trace dir
        assert os.listdir(tmp_path) == []

    def test_device_trace_writes_chrome_trace(self, monkeypatch, tmp_path):
        """With VSR_TRACE_DIR set, the region is profiled (torch.profiler)
        and a Chrome trace holding its ops lands in VSR_TRACE_DIR/<label>."""
        import torch

        monkeypatch.setenv("VSR_TRACE_DIR", str(tmp_path))
        with device_trace("band"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with open(tmp_path / "band" / "trace.json") as f:
            events = json.load(f)["traceEvents"]
        assert any("aten::mm" in str(e.get("name")) for e in events)


class TestProcessManager:
    def test_terminate_subprocess(self):
        pm = ProcessManager.instance()
        proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
        pm.add_process(proc)
        assert pm.alive_count() >= 1
        pm.terminate_all(timeout=2)
        assert proc.poll() is not None
        assert pm.alive_count() == 0


class TestRemoteCall:
    def test_round_trip(self):
        channel = RemoteCallChannel()
        got = {}
        channel.register(Command.PROGRESS, lambda p: got.update(progress=p))
        channel.register(Command.LOG, lambda p: got.update(log=p))
        channel.register(Command.FINISH, lambda p: got.update(finish=p))
        channel.start()
        client = RemoteCallClient(channel.queue)
        client.progress(42)
        client.log("hello")
        client.finish("/tmp/out.mp4")
        time.sleep(0.5)
        channel.stop()
        assert got["progress"]["percent"] == 42
        assert got["log"]["message"] == "hello"
        assert got["finish"]["output"] == "/tmp/out.mp4"

    def test_stop_delivers_the_last_message(self):
        """A worker's ERROR queued just before stop() reaches its callback
        even while the consumer is busy with an earlier message (vsr_tpu's
        copy drops it, and a failed task reads as completed)."""
        channel = RemoteCallChannel()
        got = []
        channel.register(Command.PROGRESS, lambda p: time.sleep(0.3))
        channel.register(Command.ERROR, got.append)
        channel.start()
        client = RemoteCallClient(channel.queue)
        client.progress(1)
        client.error("boom")
        time.sleep(0.1)  # the consumer is inside the PROGRESS callback
        channel.stop()
        assert got == [{"message": "boom"}]


def _video(path, n=12):
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (96, 80))
    for i in range(n):
        w.write(np.full((80, 96, 3), 100 + i, np.uint8))
    w.release()
    return path


class TestTaskModel:
    def test_default_output_paths(self):
        t = Task(path="/data/movie.mp4")
        assert t.default_output_path() == "/data/movie_no_sub.mp4"
        t2 = Task(path="/data/pic.png")
        assert t2.default_output_path() == "/data/no_sub/pic.png"

    def test_task_runner_end_to_end(self, tmp_path, monkeypatch):
        """A spawned worker on the CPU, tiny video through the zero-area
        passthrough: completed, progress 100, the output written, and the
        worker's first log line names its device. The worker builds the
        narrow STTN (tests/torch_narrow.py)."""
        monkeypatch.setattr(tasks, "_worker", narrow_sttn_worker)
        video = _video(str(tmp_path / "v.mp4"))
        cfg = Config()
        cfg.inpaint_mode = InpaintMode.STTN_AUTO
        cfg.compute_dtype = "float32"
        cfg.sttn_max_load_num = 6
        cfg.sttn_reference_length = 3
        cfg.sttn_neighbor_stride = 2
        logs = []
        runner = TaskRunner(config=cfg, on_log=logs.append, device="cpu")
        out = str(tmp_path / "out.mp4")
        task = runner.add(video, TaskOptions(sub_areas=[(0, 0, 0, 0)]), output_path=out)
        runner.run_all()
        assert task.status == TaskStatus.COMPLETED, task.error
        assert task.progress == 100
        assert os.path.exists(out)
        assert logs[0] == "device: cpu (host CPU)"
        assert any(line.startswith("processing time:") for line in logs)

    def test_task_runner_without_card_fails(self, tmp_path):
        """A spawned worker asked for "cuda" where there is none: the task
        ends FAILED with the error, and nothing is written."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        runner = TaskRunner(config=Config(), device="cuda")
        out = str(tmp_path / "out.mp4")
        task = runner.add(_video(str(tmp_path / "v.mp4"), 2), output_path=out)
        runner.run_all()
        assert task.status == TaskStatus.FAILED
        assert "CUDA is not available" in task.error
        assert not os.path.exists(out)
