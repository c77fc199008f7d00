"""Run ``chip_smoke.py`` in one or more checkouts, one after another, and
time each of its phases.

Each argument is ``LABEL=DIR``: ``python3 -u chip_smoke.py`` runs from
``DIR`` (a checkout of the repo), its standard output is read line by line
and every line is stamped with the seconds since that run started. The gap
before a JSON line that names a ``phase`` is put down to that phase (the
``env`` phase's first line also carries the kernels' build); any other
line's gap goes to ``(other)``. To compare two commits, give them in the
order parent, change, change, parent::

    python3 smoke_timeline.py --out chiprun_out/ab \\
        parent=.archive_check/parent change=.archive_check/final \\
        change=.archive_check/final parent=.archive_check/parent

Writes ``<out>/<label>_<i>.jsonl`` (each line as ``{"t": s, "line": ...}``),
``<out>/<label>_<i>.err`` (standard error) and ``<out>/timeline.json``, and
prints one JSON line per run: its exit code, its seconds and its seconds by
phase. Exits with the first nonzero exit code of the runs."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from collections import defaultdict


def phase_seconds(stamped: list) -> dict:
    """{phase: seconds} from [(t, line), ...], each gap put down to the
    phase of the line that ends it."""
    seconds: dict = defaultdict(float)
    last = 0.0
    for t, line in stamped:
        try:
            phase = json.loads(line).get("phase") or "(other)"
        except (ValueError, AttributeError):
            phase = "(other)"
        seconds[phase] += t - last
        last = t
    return dict(seconds)


def run_one(label: str, directory: str, out: str, index: int, timeout: float) -> dict:
    stem = os.path.join(out, f"{label}_{index}")
    start = time.perf_counter()
    stamped = []
    with open(stem + ".err", "w") as err, open(stem + ".jsonl", "w") as log:
        proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=directory,
                                stdout=subprocess.PIPE, stderr=err, text=True)
        timer = threading.Timer(timeout, proc.kill)  # a run past its time is killed
        timer.start()
        try:
            for line in proc.stdout:
                t = time.perf_counter() - start
                line = line.rstrip("\n")
                stamped.append((t, line))
                log.write(json.dumps({"t": t, "line": line}) + "\n")
                log.flush()
            rc = proc.wait()
        finally:
            timer.cancel()
    seconds = time.perf_counter() - start
    by_phase = phase_seconds(stamped)
    by_phase["(after the last line)"] = seconds - (stamped[-1][0] if stamped else 0.0)
    return {"label": label, "run": index, "dir": directory, "rc": rc, "seconds": seconds,
            "phases": by_phase}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("runs", nargs="+", metavar="LABEL=DIR")
    parser.add_argument("--out", required=True, help="directory for the stamped logs")
    parser.add_argument("--timeout", type=float, default=1200.0, help="seconds a run")
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    results = []
    for index, spec in enumerate(args.runs):
        label, _, directory = spec.partition("=")
        result = run_one(label, directory, args.out, index, args.timeout)
        print(json.dumps(result), flush=True)
        results.append(result)
    with open(os.path.join(args.out, "timeline.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    return next((r["rc"] for r in results if r["rc"] != 0), 0)


if __name__ == "__main__":
    sys.exit(main())
