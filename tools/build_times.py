"""Wall time of each source's ``nvcc`` in a cold build of the kernels.

Builds every ``csrc/*.cu`` of a source tree's ``repro_torch`` the way
``kernels/build.py::build_all`` does (one ``nvcc`` a source, or a part of
one in ``build.PARTS``, all started together), into a fresh directory
under ``build/`` so that nothing already built is reused, and records
when each source's compilers have all exited (its link follows).
``--src`` names the tree (default: this checkout's), so two versions
compare in one call:

    python tools/build_times.py --src /path/to/other/src
    python tools/build_times.py

Prints one JSON object: the card (``nvidia-smi`` name and power limit),
the build's seconds, and each source's seconds, in the order they
finished.  Needs ``nvcc``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    build = importlib.import_module("repro_torch.kernels.build")
    (ROOT / "build").mkdir(exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="build_times_", dir=ROOT / "build"))
    build.BUILD_DIR = out
    try:
        t0 = time.perf_counter()
        started = {n: build._start(n) for n in build.sources()}

        def procs(s):
            return s[0] if isinstance(s[0], list) else [s[0]]

        done: dict[str, float] = {}
        while len(done) < len(started):
            for n, s in started.items():
                if n not in done and all(p.poll() is not None
                                         for p in procs(s)):
                    done[n] = time.perf_counter() - t0
            time.sleep(0.05)
        for n, s in started.items():
            build._finish(n, s)
        total = time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps({"card": card(), "src": args.src,
                      "build_s": round(total, 2),
                      "sources_s": {n: round(t, 2) for n, t in sorted(
                          done.items(), key=lambda kv: kv[1])}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
