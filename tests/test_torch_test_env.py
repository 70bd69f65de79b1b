"""The port's test files cap torch's threads (tests/torch_test_env.py).

An ``ast`` scan holds every ``tests/test_torch_*.py`` to importing the
helper at its top level; a planted file shows the scan catches one that
does not. In an xdist worker torch's thread count and ``OMP_NUM_THREADS``
are the helper's. Also scripts/junit_times.py, which reads where a run's
time went from its JUnit report.
"""

import ast
import os
from pathlib import Path

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import pytest
import torch

HELPER = "torch_test_env"
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent


def helper_import_fault(path):
    """None when ``path`` imports the helper at its top level; else what is
    wrong, naming the file."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] + [a.name for a in node.names]
        else:
            continue
        if any(name.split(".")[-1] == HELPER for name in names):
            return None
    return (f"{path} never imports tests/{HELPER}.py at its top level "
            f"(add `from tests import {HELPER}`)")


def test_every_port_test_file_imports_the_helper():
    files = sorted(TESTS.glob("test_torch_*.py"))
    assert len(files) >= 34, files
    faults = [f for f in map(helper_import_fault, files) if f]
    assert not faults, "\n".join(faults)


@pytest.mark.parametrize("body, ok", [
    ("import os\nfrom tests import torch_test_env\nimport torch\n", True),
    ("import os\nimport torch\n\ndef f():\n    from tests import torch_test_env\n", False),
], ids=["imports-it", "never-at-top-level"])
def test_scan_catches_a_planted_file(tmp_path, body, ok):
    path = tmp_path / "test_torch_planted.py"
    path.write_text(body)
    fault = helper_import_fault(path)
    if ok:
        assert fault is None, fault
    else:
        assert fault is not None and str(path) in fault


def test_torch_threads_are_the_helpers():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        pytest.skip("the helper caps torch only in an xdist worker (-n N)")
    assert torch_test_env.THREADS == max(1, os.cpu_count() // int(workers))
    assert torch.get_num_threads() == torch_test_env.THREADS
    assert os.environ["OMP_NUM_THREADS"]
    assert os.environ["MKL_NUM_THREADS"]


def test_junit_times_sums_and_lists_the_port_cases(tmp_path, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "junit_times", REPO / "scripts" / "junit_times.py")
    junit_times = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(junit_times)
    report = tmp_path / "r.xml"
    report.write_text(
        '<testsuites><testsuite name="pytest" tests="4">'
        '<testcase classname="tests.test_torch_a" name="test_x[1]" time="70.5"/>'
        '<testcase classname="tests.test_torch_a.TestK" name="test_y" time="2.0"/>'
        '<testcase classname="tests.test_torch_b" name="test_z" time="10"/>'
        '<testcase classname="tests.test_io" name="test_w" time="100"/>'
        '</testsuite></testsuites>')
    assert junit_times.main(str(report)) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["cases 4, summed 182.5 s", "port cases 3, summed 82.5 s"]
    assert out[2].split() == ["72.5", "tests/test_torch_a.py"]
    assert out[3].split() == ["10.0", "tests/test_torch_b.py"]
    assert out[4:] == ["port cases over 60 s:", "      70.5  tests/test_torch_a.py::test_x[1]"]
