#!/usr/bin/env python3
"""Run one card test many times, to count how often it fails.

    python3 scripts/gpu_repeat.py --times 20 --fresh \\
        tests/test_torch_fused.py::test_gpu_fused_engine_matches_cpu
    python3 scripts/gpu_repeat.py --times 5 --after "tests/test_torch_*.py" \\
        tests/test_torch_fused.py::test_gpu_fused_engine_matches_cpu

``--fresh``: each run in a process of its own (pytest on the test
alone).  Otherwise one pytest process runs the card (``-m gpu``) tests of
the ``--after`` modules first and then the test ``--times`` times in a
row, as cases of one parametrised test.  Prints one JSON line with the
passes and failures of the repeated test.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class _Repeat:
    """pytest plugin: parametrise ``func`` over ``times`` copies, and
    record each copy's outcome."""

    def __init__(self, func: str, times: int):
        self.func, self.times, self.outcomes = func, times, []

    def pytest_generate_tests(self, metafunc):
        if metafunc.function.__name__ == self.func:
            metafunc.fixturenames.append("_repeat")
            metafunc.parametrize("_repeat", range(self.times))

    def pytest_runtest_logreport(self, report):
        if self.func in report.nodeid and report.when == "call":
            self.outcomes.append(report.outcome)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("node", help="path::test_name")
    ap.add_argument("--times", type=int, default=20)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--after", default=None,
                    help="glob of test modules whose -m gpu tests run first")
    args = ap.parse_args()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    if args.fresh:
        outcomes = []
        for _ in range(args.times):
            rc = subprocess.run(
                [sys.executable, "-m", "pytest", "-q", "-p",
                 "no:cacheprovider", "-m", "gpu", args.node], cwd=ROOT,
                env=env).returncode
            outcomes.append("passed" if rc == 0 else f"rc={rc}")
    else:
        import pytest

        sys.path.insert(0, str(ROOT / "src"))
        os.environ.update(env)
        path, func = args.node.split("::")
        mods = sorted(set(glob.glob(str(ROOT / args.after))) -
                      {str(ROOT / path)}) if args.after else []
        plugin = _Repeat(func, args.times)
        pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu", *mods,
                     str(ROOT / path)], plugins=[plugin])
        outcomes = plugin.outcomes
    print(json.dumps({"test": args.node, "fresh": args.fresh,
                      "after": args.after, "runs": len(outcomes),
                      "passed": outcomes.count("passed"),
                      "outcomes": outcomes}))
    return 0 if outcomes and set(outcomes) == {"passed"} else 1


if __name__ == "__main__":
    sys.exit(main())
