"""BENCHMARK.json against the contract's names and units, the harness
finding a new configuration, traffic mix or metric by name with no edit to
an existing file, and the import guard."""

import ast
import glob
import json
import os
import re
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT, copy_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_FILE = os.path.join(ROOT, "BENCHMARK.json")


def bench():
    with open(BENCH_FILE) as f:
        return json.load(f)


def test_benchmark_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(BENCH_FILE) <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    for key, allowed in (("configs", {"name", "source", "file", "reduced", "why"}),
                         ("workloads", {"name", "config", "traffic", "chips", "why"}),
                         ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                         ("per_layer", {"name", "unit", "better", "source", "layer",
                                        "moves", "workloads"})):
        names = [e["name"] for e in b[key]]
        assert len(names) == len(set(names))
        for e in b[key]:
            assert set(e) <= allowed, (key, e)
            assert NAME.match(e["name"]), e["name"]
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells and m.get("workloads", cells)
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)


def test_every_file_the_benchmark_names_exists():
    b = bench()
    for c in b["configs"]:
        assert c["file"].startswith("perfbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(ROOT, "perfbench", "drivers", f"{cfg['driver']}.py"))
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "perfbench", "traffic", f"{w['traffic']}.json"))
    for m in b["end_to_end"]:
        assert harness.load_module(os.path.join(ROOT, "perfbench", "e2e", f"{m['name']}.py")).UNIT \
            == m["unit"]
    for m in b["per_layer"]:
        mod = harness.load_module(os.path.join(ROOT, "perfbench", "metrics", f"{m['name']}.py"))
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])


def test_new_files_are_found_by_name(tmp_path):
    """A cell, a configuration, a traffic mix and a per-layer metric added
    as new files, with entries appended to BENCHMARK.json: the harness finds
    them, and no file that was there changes."""
    root = copy_benchmark(str(tmp_path))
    before = {p: open(p, "rb").read() for p in glob.glob(os.path.join(root, "perfbench", "**",
                                                                     "*"), recursive=True)
              if os.path.isfile(p)}
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "configs", "sttn-auto.json")) as f:
        cfg = dict(json.load(f), name="sttn-auto-stride10", neighbor_stride=10)
    with open(os.path.join(pb, "configs", "sttn-auto-stride10.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "band_720p.json"), "w") as f:
        json.dump({"generator": "band_stream", "width": 1280, "height": 720}, f)
    with open(os.path.join(pb, "metrics", "frames_seen.py"), "w") as f:
        f.write("LAYER = 'device'\nUNIT = 'frames'\nMOVES = 'fps'\n\n\n"
                "def read(ctx):\n    return ctx.frames\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "sttn-auto-stride10", "source": "s",
                         "file": "perfbench/configs/sttn-auto-stride10.json", "reduced": [],
                         "why": "w"})
    b["workloads"].append({"name": "sttn_auto.stride10_band_720p",
                           "config": "sttn-auto-stride10", "traffic": "band_720p", "chips": 1,
                           "why": "w"})
    b["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                           "source": "program_counter", "layer": "device", "moves": "fps"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    cell = harness.load_cell("sttn_auto.stride10_band_720p", root)
    assert cell.cfg["neighbor_stride"] == 10 and cell.mix["width"] == 1280
    assert hasattr(cell.driver, "Driver")
    assert [m["name"] for m in cell.per_layer][-1] == "frames_seen"
    reader = harness.metric_reader(cell, cell.per_layer[-1], True)
    assert reader.read(type("Ctx", (), {"frames": 7})) == 7
    old = harness.load_cell("sttn_auto.band_1080p", root)
    assert [m["name"] for m in old.per_layer][-1] == "frames_seen"
    for path, data in before.items():
        assert open(path, "rb").read() == data, path


@pytest.mark.parametrize("modules,found", [
    (["vsr_tpu_torch", "vsr_tpu_torch.ops", "numpy"], []),
    (["vsr_tpu_torch", "vsr_tpu.ops.x"], ["vsr_tpu"]),
    (["jax", "jaxlib.xla", "flax.linen", "jaxtyping", "flaxen"], ["flax", "jax", "jaxlib"]),
])
def test_forbidden_modules_compare_whole_names(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "perfbench", "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("vsr_tpu_torch", "vsr_tpu", "jax", "jaxlib",
                                               "flax"), (path, n)


def test_a_run_loads_no_jax():
    """Importing what a run imports (the harness, both drivers and the port
    modules they reach) leaves no forbidden module in a fresh process."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench import harness, control, generator, counts, weights\n"
            "for n in ('sttn_auto', 'sttn_det'):\n"
            "    harness.load_module(%r + '/perfbench/drivers/' + n + '.py')\n"
            "import vsr_tpu_torch.inpaint.sttn_auto, vsr_tpu_torch.inpaint.sttn_det\n"
            "import vsr_tpu_torch.masks.intervals, vsr_tpu_torch.masks.solver\n"
            "import vsr_tpu_torch.ops.token_attention, vsr_tpu_torch.convert.torch_sttn\n"
            "print(harness.forbidden_modules())\n") % (ROOT, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and perfbench/, and no card,
    run.py exits non-zero and prints nothing on standard output."""
    root = copy_benchmark(str(tmp_path))
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "sttn_auto.band_1080p", "--seed", "1", "--seconds", "1", "--trace",
                           "0"], cwd=root, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
