"""The benchmark's engine: it finds a cell's configuration, traffic, driver
and metrics by name, sets the program up, measures one closed-loop window,
reads the trace, checks the outputs against the plain reference and builds
the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

* ``BENCHMARK.json`` (the checkout's root): the cells and the metrics;
* a configuration's ``file`` (``perfbench/configs/``), whose ``"driver"``
  names ``perfbench/drivers/<driver>.py``;
* ``perfbench/traffic/<traffic>.json``, read by ``perfbench/generator.py``;
* ``perfbench/e2e/<metric>.py`` and ``perfbench/metrics/<metric>.py``: a
  ``read(ctx)`` that returns the metric, or None where it finds nothing.

A driver module holds a ``Driver(cfg, mix, seed, device)`` that builds the
program and the traffic, and has ``pool``, ``frame_shape``, ``unit_of``,
``warm()``, ``window(reader, writer)``, ``launches()``, ``host_spans()`` (the program's host steps the traced run labels),
``chunk_work(raw)`` (the work the window's return value stands for, worked
out after the window closed, in the form the family's static methods take;
STTN's: a ``(frames, chunk length, bands)`` per chunk),
``free()``, a state dict ``netg`` (the seeded weights both sides run),
and these static methods, which hold all that is particular to the
configuration's model family:

* ``reference_unit(cfg, mix, seed, pool, model, first, length, taken,
  device)``: the reference's frames and mask for a sampled unit, or None
  where the reference's schedule forms no such unit;
* ``reference_model(cfg, quant="float32")``: the plain reference module
  (one module holding every network of the family), into which ``netg``
  loads strictly;
* ``expected_launches(cfg, work)``: the launches of the family's
  hand-written kernels that the schedule of ``work`` (``chunk_work``'s
  value) needs on a card;
* ``model_flops(cfg, work)``: the useful model FLOPs of ``work``, from
  shapes alone, or None.

A new family is a new driver file with its own reference and counts beside
it in the benchmark's folder; the harness reads no key of a configuration
but ``driver``, ``limits`` and what it hands to these methods.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from perfbench import generator

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# top-level module names that no run may hold (compared whole: the port's
# own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "vsr_tpu")

WINDOW_SPAN = "perfbench.window"


def forbidden_modules(modules=None) -> List[str]:
    """The FORBIDDEN top-level names among ``modules`` (default sys.modules)."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """A module from a file of the benchmark, by its path."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    name = "perfbench_" + re.sub(r"\W", "_", os.path.relpath(path, BENCH_DIR))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell(SimpleNamespace):
    """A workload of BENCHMARK.json with everything it names, loaded."""


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    work = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    cfg = load_json(os.path.join(root, entry["file"]))
    bench_dir = os.path.join(root, "perfbench")
    return Cell(
        name=name, workload=work, cfg=cfg, bench=bench, bench_dir=bench_dir,
        mix=generator.load_mix(work["traffic"], os.path.join(bench_dir, "traffic")),
        driver=load_module(os.path.join(bench_dir, "drivers", f"{cfg['driver']}.py")),
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def metric_reader(cell: Cell, metric: dict, per_layer: bool):
    folder = "metrics" if per_layer else "e2e"
    return load_module(os.path.join(cell.bench_dir, folder, f"{metric['name']}.py"))


def process_age_s() -> Optional[float]:
    """Seconds since this process started (Linux /proc), or None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


# ---- the closed loop ----

class Reader:
    """Hands out copies of the pool's frames in stream order, as a decoder
    would. ``read()`` stops at the deadline; ``take()`` does not (a unit
    already begun is finished)."""

    def __init__(self, pool, deadline: Optional[float] = None, limit: Optional[int] = None):
        self.pool, self.deadline, self.limit, self.taken = pool, deadline, limit, 0

    def expired(self) -> bool:
        if self.limit is not None:
            return self.taken >= self.limit
        return self.deadline is not None and time.perf_counter() >= self.deadline

    def take(self) -> np.ndarray:
        frame = self.pool[self.taken % len(self.pool)].copy()
        self.taken += 1
        return frame

    def read(self):
        if self.expired():
            return False, None
        return True, self.take()


class Unit:
    __slots__ = ("key", "first", "frames", "length")

    def __init__(self, key, first):
        self.key, self.first, self.frames, self.length = key, first, [], 0


class Writer:
    """Takes the program's frames in stream order: counts them, counts the
    malformed, and keeps the frames of the sampled units.

    A unit is what the reference recomputes on its own (a chunk, a batch);
    its key comes from ``unit_of(index)`` or from ``begin_unit(key)``, and
    None marks frames outside any unit. The sample: ``k`` units drawn from
    the seed (reservoir sampling over the units in order), the longest unit
    and the last one."""

    def __init__(self, shape, k: int, seed: int, unit_of=None):
        self.shape, self.k, self.unit_of = tuple(shape), k, unit_of
        self.rng = np.random.default_rng(seed)
        self.returned = self.malformed = 0
        self.seen = 0
        self.reservoir: List[Unit] = []
        self.current: Optional[Unit] = None
        self.longest: Optional[Unit] = None
        self._key = None

    def begin_unit(self, key) -> None:
        self._key = key

    def _start(self, key) -> None:
        self._finish()
        unit = Unit(key, self.returned)
        self.current = unit
        if key is None:
            return
        if self.seen < self.k:
            self.reservoir.append(unit)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.reservoir[j] = unit
        self.seen += 1

    def _finish(self) -> None:
        unit = self.current
        if unit is None or unit.key is None:
            return
        if self.longest is None or unit.length > self.longest.length:
            self.longest = unit

    def write(self, frame) -> None:
        key = self.unit_of(self.returned) if self.unit_of else self._key
        if self.current is None or key != self.current.key:
            self._start(key)
        ok = isinstance(frame, np.ndarray) and frame.shape == self.shape and frame.dtype == np.uint8
        self.malformed += not ok
        self.current.frames.append(frame)
        self.current.length += 1
        self.returned += 1
        if self.current.key is None:
            self.current.frames.clear()  # frames outside any unit are not kept

    def sample(self) -> List[Unit]:
        self._finish()
        units = list(self.reservoir)
        for extra in (self.longest, self.current):
            if extra is not None and extra.key is not None and all(
                    u.key != extra.key for u in units):
                units.append(extra)
        return units


# ---- the trace ----

def short_kernel_name(name: str) -> str:
    """A device op's name without its return type, namespaces, template and
    parameters, for the breakdown."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    head = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    head = re.sub(r"<.*", "", head.split("(")[0])
    return head.split("::")[-1] or name[:80]


def reduce_trace(events, labels=()) -> SimpleNamespace:
    """Device intervals, kernel times and the longest idle gaps in the window
    span, from the profiler's kineto events. The card's work is its kernels,
    copies and fills; the profiler's copies of the host's spans on the
    card's timeline (user annotations, and events named as one of the
    harness's ``labels``) are left out."""
    from torch.autograd import DeviceType

    window = None
    device, annotations = [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if dur > 0 and not e.is_user_annotation() and e.name() not in labels:
                device.append((start, start + dur, e.name()))
        elif e.name() == WINDOW_SPAN:
            window = (start, start + dur)
        elif e.is_user_annotation():
            annotations.append((start, start + dur, e.name()))
    if window is None:
        raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
    w0, w1 = window
    inside = sorted((max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1)
    merged: List[List[int]] = []
    for s, e, _ in inside:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps, cursor = [], w0
    for s, e in merged + [[w1, w1]]:
        if s > cursor:
            gaps.append((s - cursor, cursor, s))
        cursor = max(cursor, e)
    gaps.sort(reverse=True)
    by_kernel: Dict[str, float] = {}
    for s, e, n in inside:
        by_kernel[n] = by_kernel.get(n, 0.0) + (e - s) / 1e9

    def host_at(t):
        covering = [a for a in annotations if a[0] <= t <= a[1]]
        return max(covering)[2] if covering else "no harness span"

    idle = [[host_at((a + b) // 2), g / 1e9] for g, a, b in gaps[:10]]
    ops: Dict[str, float] = {}
    for n, secs in by_kernel.items():
        short = short_kernel_name(n)
        ops[short] = ops.get(short, 0.0) + secs
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return SimpleNamespace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, by_kernel=by_kernel,
                           breakdown={"device_ops": [[n, s] for n, s in top], "idle_gaps": idle})


def kernel_seconds(trace, names) -> float:
    """Device seconds of the kernels whose own name is one of ``names``."""
    return sum(s for n, s in trace.by_kernel.items() if short_kernel_name(n) in names)


class CallRecorder:
    """Wraps ``obj.attr`` for the traced window: each call is recorded by
    ``record(*args)`` and, with a ``label``, runs inside a profiler span."""

    def __init__(self, obj, attr: str, label: Optional[str] = None, record=None):
        self.obj, self.attr, self.label, self.record = obj, attr, label, record
        self.calls: list = []
        self.original = getattr(obj, attr)
        self.own = attr in vars(obj)

    def __enter__(self):
        import torch

        fn, label, record, calls = self.original, self.label, self.record, self.calls

        def wrapper(*args, **kwargs):
            if record is not None:
                calls.append(record(*args, **kwargs))
            if label is None:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)

        setattr(self.obj, self.attr, wrapper)
        return self

    def __exit__(self, *exc):
        if self.own:
            setattr(self.obj, self.attr, self.original)
        else:
            delattr(self.obj, self.attr)


# ---- the run ----

def card_of(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def power_limit_w() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             root: str = ROOT, before_window=None) -> dict:
    """One run of a cell: set-up, one window, the trace's metrics when
    ``trace``, the reference check; returns the result line's object.
    ``before_window``: a callable given the driver after the warm-up (the
    control puts the reference in the program's place with it)."""
    import torch

    cell = load_cell(name, root)
    device = torch.device(device or "cuda:0")
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    driver = cell.driver.Driver(cell.cfg, cell.mix, seed, device)
    if cuda:
        # the peak is the program's: the harness's own set-up (seeded weights,
        # their calibration through the reference) is left out of it
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    driver.warm()
    if before_window is not None:
        before_window(driver)
    writer = Writer(driver.frame_shape, cell.mix["sample_units"], seed, driver.unit_of)
    sync()
    recorders = []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        spans = driver.host_spans() + [(Reader, "take", "reader.take", None),
                                        (Writer, "write", "writer.write", None)]
        recorders = [CallRecorder(o, a, label, record) for o, a, label, record in spans]
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities, record_shapes=False, with_stack=False)
        for r in recorders:
            r.__enter__()
        prof.start()
    t_start = time.perf_counter()
    setup_s = process_age_s()
    reader = Reader(driver.pool, t_start + seconds)
    if trace:
        with torch.profiler.record_function(WINDOW_SPAN):
            raw = driver.window(reader, writer)
            sync()
    else:
        raw = driver.window(reader, writer)
        sync()
    t_end = time.perf_counter()
    work = driver.chunk_work(raw)
    if trace:
        prof.stop()
        for r in recorders:
            r.__exit__()
    window_s = t_end - t_start
    log(f"window {window_s:.3f} s: {writer.returned} of {reader.taken} frames returned, "
        f"{len(work)} chunks")
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    launches = driver.launches()
    pool, netg = driver.pool, driver.netg
    driver.free()
    if cuda:
        torch.cuda.empty_cache()

    family = cell.driver.Driver
    ctx = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, setup_s=setup_s, window_s=window_s,
                          frames=writer.returned,
                          model_flops=family.model_flops(cell.cfg, work), device=device,
                          card=card_of(device), recorders={r.attr: r for r in recorders})
    metrics = {}
    breakdown = None
    if trace:
        t0 = time.perf_counter()
        labels = {WINDOW_SPAN} | {r.label for r in recorders if r.label}
        red = reduce_trace(prof.profiler.kineto_results.events(), labels)
        prof = None
        ctx.trace = red
        breakdown = red.breakdown
        log(f"trace read in {time.perf_counter() - t0:.1f} s: traced window "
            f"{red.window_s:.3f} s, device busy {red.busy_s:.3f} s")
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(cell, m, trace).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks, correct = check_outputs(cell, writer, reader.taken, pool, netg, seed, device)
    failed = reader.taken - writer.returned + writer.malformed
    correct = correct and failed == 0 and writer.returned > 0
    dev = dict(ctx.card, memory_peak_bytes=peak)
    if trace:
        dev.update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
    # the route's count, logged beside the schedule's and left out of
    # `correct`: a kernel replayed from a captured graph, or merged into
    # another hand-written one, is not counted by the port's counter
    expected = family.expected_launches(cell.cfg, work) if cuda else 0
    log(f"card {power_limit_w() or dev['kind']}; hand-kernel launches {launches}, "
        f"{expected} by the schedule" + ("" if launches == expected else " (they differ)"))
    result = {"correct": bool(correct), "attempted": reader.taken, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["kernel_launches"] = {"counted": launches, "expected": expected}
    result["checks"] = checks
    return result


def check_outputs(cell: Cell, writer: Writer, taken: int, pool, netg, seed: int, device):
    """The sampled units against the plain reference (float32, TF32 off, on
    the weights ``netg``) on ``device``: {check: {"value", "limit"}} and
    whether every check holds. TF32 is switched back as it was afterwards,
    so that a later run in the same process computes as a fresh one would."""
    import torch

    cfg, units = cell.cfg, writer.sample()
    driver = cell.driver.Driver
    model = driver.reference_model(cfg).to(device).eval()
    model.load_state_dict(netg, strict=True)
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        readings = compare_units(units, lambda u: driver.reference_unit(
            cfg, cell.mix, seed, pool, model, u.first, u.length, taken, device), device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    log(f"reference over {sum(u.length for u in units)} frames of {len(units)} units in "
        f"{time.perf_counter() - t0:.1f} s")
    limits = cfg.get("limits", {})
    for k in sorted(set(readings) - set(limits)):
        log(f"{k}: {readings[k]} (no limit in the configuration; not compared)")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items() if k in limits}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    for k, c in checks.items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    return checks, correct


def compare_units(units: List[Unit], reference, device) -> Dict[str, float]:
    """Over ``units``: the widest and the mean uint8 gap between the
    program's frames and the reference's inside the mask, the share (in %)
    of the values inside it whose gap exceeds 2, pixels changed outside it,
    and units the reference's schedule does not form.
    ``reference(unit)`` gives (frames [n, H, W, 3] uint8 on ``device``, mask)
    or None."""
    import torch

    widest, gap_sum, over2, gap_n, outside, mismatched = 0, 0, 0, 0, 0, 0
    for unit in units:
        ref = reference(unit)
        if ref is None:
            mismatched += 1
            continue
        want, mask = ref
        got = torch.from_numpy(np.stack(unit.frames)).to(device)
        inside = torch.from_numpy(mask > 0).to(device)
        diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
        widest = max(widest, int(diff.max()))
        outside += int(((diff > 0).any(dim=-1) & ~inside).sum())
        gap_sum += int(diff[:, inside].sum())
        over2 += int((diff[:, inside] > 2).sum())
        gap_n += int(inside.sum()) * diff.shape[0] * diff.shape[-1]
    return {"max_gap_u8": widest, "mean_gap_u8": gap_sum / max(gap_n, 1),
            "gap_over2_pct": 100.0 * over2 / max(gap_n, 1),
            "outside_changed_px": outside, "unit_mismatch": mismatched}
