"""What each of ``chip_smoke.py``'s cuts saves, phase by phase.

``chip_smoke.py`` stays inside its time limit by cutting what some of its
phases run.  ``CUTS`` names the constants a cut may set (the eager
reruns' greedy tokens, phase 38's greedy tokens, phase 39's xLSTM train
length) and their values before any cut.  This script runs the smoke
with them at those values ("old": the constants set, then
``chip_smoke.main()``) and as it stands ("new": ``python chip_smoke.py``),
old, new, new, old, each in its own process on the card, so both are
timed in one call on one host.  Each run's output goes to
``<out>/smoke_cuts_<i>_<old|new>.log`` (``--out``, by default this
checkout's ``chiprun_out/``); the script prints each
phase's seconds in every run, the old and new means and their
difference, the card's name and power limit, then one JSON object of the
same.  Exits non-zero if a run fails.

    python tools/smoke_cuts.py              # the four runs
    python tools/smoke_cuts.py --out DIR    # their logs in DIR
    python tools/smoke_cuts.py --run old    # one run, the cuts undone
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# each constant of chip_smoke.py a cut may set, at its value before any cut
CUTS = {"EAGER_NEW": 16, "SHARDED_NEW": 16, "xLSTM train S": 1024}
TIME = re.compile(r"^\[time\] (.+): ([0-9.]+) s$")


def undo_cuts(smoke) -> None:
    """Set ``smoke``'s cut constants back to their values in ``CUTS``
    (phase 38's ranks take theirs from the ``sizes`` the phase passes)."""
    smoke.EAGER_NEW = CUTS["EAGER_NEW"]
    smoke.SHARDED_NEW = CUTS["SHARDED_NEW"]
    label, name, widths, layers, layouts, (n, b, _) = smoke.WIDE_MODELS[-1]
    smoke.WIDE_MODELS[-1] = (label, name, widths, layers, layouts,
                             (n, b, CUTS["xLSTM train S"]))


def run_old() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    undo_cuts(chip_smoke)
    return chip_smoke.main()


def phase_times(log: str) -> dict:
    return {m.group(1): float(m.group(2)) for m in
            map(TIME.match, log.splitlines()) if m}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", choices=("old",))
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out")
    args = ap.parse_args()
    if args.run == "old":
        return run_old()
    args.out.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, which in enumerate(("old", "new", "new", "old")):
        cmd = ([sys.executable, str(Path(__file__).resolve()), "--run", "old"]
               if which == "old" else [sys.executable, "chip_smoke.py"])
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        (args.out / f"smoke_cuts_{i}_{which}.log").write_text(res.stdout
                                                          + res.stderr)
        times = phase_times(res.stdout)
        runs.append({"which": which, "rc": res.returncode, "wall_s": wall,
                     "phases": times})
        print(f"run {i} ({which}): rc {res.returncode}, {wall:.1f} s, "
              f"phases {json.dumps(times)}", flush=True)
        if res.returncode:
            print(res.stderr[-4000:], flush=True)
            return 1
    names = list(runs[1]["phases"])
    table = {}
    for name in names:
        got = {w: [r["phases"].get(name) for r in runs if r["which"] == w]
               for w in ("old", "new")}
        if any(v is None for vs in got.values() for v in vs):
            continue
        mean = {w: sum(v) / len(v) for w, v in got.items()}
        table[name] = {"runs": [r["phases"][name] for r in runs], **mean,
                       "saved": mean["old"] - mean["new"]}
        print(f"{name}: " + " / ".join(f"{t:.1f}" for t in
                                       table[name]["runs"])
              + f" s; old {mean['old']:.1f}, new {mean['new']:.1f}, saved "
              f"{table[name]['saved']:.1f}", flush=True)
    print(card(), flush=True)
    print(json.dumps({"cuts": CUTS, "order": [r["which"] for r in runs],
                      "wall_s": [r["wall_s"] for r in runs],
                      "phases": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
