"""Where a pytest run's time went, from its JUnit report.

    python3 scripts/junit_times.py REPORT.xml

Prints the count of cases and their summed seconds, the same for the
port's tests (``tests/test_torch_*.py``), the port's files by summed
seconds, and every port case that took longer than a minute. A case's
time is pytest's: set-up, call and teardown together. Under ``-n`` the
sum exceeds the wall time, since workers run side by side. Reads the
report the tier-1 command writes (``--junitxml``).
"""

from __future__ import annotations

import sys
import xml.etree.ElementTree as ET
from collections import defaultdict

PORT_PREFIX = "test_torch_"
OVER_S = 60.0  # the limit a port case is held to in the gate's run (ROADMAP.md)


def case_times(path):
    """[(file stem, case id, seconds)] for every case in the report."""
    out = []
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = (case.get("classname") or "").split(".")
        stem = parts[1] if len(parts) > 1 and parts[0] == "tests" else parts[0]
        name = "::".join(parts[2:] + [case.get("name", "")])
        out.append((stem, name, float(case.get("time") or 0.0)))
    return out


def main(report) -> int:
    cases = case_times(report)
    port = [c for c in cases if c[0].startswith(PORT_PREFIX)]
    print(f"cases {len(cases)}, summed {sum(c[2] for c in cases):.1f} s")
    print(f"port cases {len(port)}, summed {sum(c[2] for c in port):.1f} s")
    by_file = defaultdict(float)
    for stem, _, seconds in port:
        by_file[stem] += seconds
    for stem, seconds in sorted(by_file.items(), key=lambda kv: -kv[1]):
        print(f"  {seconds:8.1f}  tests/{stem}.py")
    print(f"port cases over {OVER_S:g} s:")
    for stem, name, seconds in sorted(port, key=lambda c: -c[2]):
        if seconds <= OVER_S:
            break
        print(f"  {seconds:8.1f}  tests/{stem}.py::{name}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
