#!/usr/bin/env python3
"""The PyTorch port's dry run over every (architecture x shape) cell, each
cell its own ``python -m repro_torch.launch.dryrun --arch A --shape S``
process (a fake world is one process's default group), ``--jobs`` at a
time, each cut after ``--limit`` seconds. Records append to ``--out``
(default ``build/dryrun/grid_<tag>.jsonl``); each process's output goes
to ``<out>.logs/``. Prints one line a cell (ok, failed or cut, seconds)
and ``done: k/N``, k the cells that wrote a record without an error.

  PYTHONPATH=src python3 scripts/dryrun_grid.py [--multi-pod] [--jobs 4] \\
      [--limit 1800] [--cells ARCH:SHAPE ...]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import cells

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--limit", type=float, default=1800.0)
    ap.add_argument("--cells", nargs="*", default=None,
                    help="ARCH:SHAPE cells to run (default: all)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tag = "multipod" if args.multi_pod else "singlepod"
    # Absolute: the cells' processes run from the repository's root.
    out = Path(args.out or ROOT / "build" / "dryrun" /
               f"grid_{tag}.jsonl").resolve()
    logs = Path(str(out) + ".logs")
    logs.mkdir(parents=True, exist_ok=True)
    pick = {tuple(c.split(":")) for c in args.cells or ()}
    todo = [c for c in cells() if not pick or c in pick]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    pending, running, results = list(todo), {}, {}
    while pending or running:
        while pending and len(running) < args.jobs:
            arch, shape = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out", str(out)]
            if args.multi_pod:
                cmd.append("--multi-pod")
            log = open(logs / f"{arch}_{shape}.log", "w")
            running[(arch, shape)] = (subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=ROOT), time.monotonic(), log)
        time.sleep(1.0)
        for key, (p, t0, log) in list(running.items()):
            dt = time.monotonic() - t0
            if p.poll() is None and dt < args.limit:
                continue
            if p.poll() is None:
                p.kill()
                p.wait()
                state = "cut"
            else:
                state = "ok" if p.returncode == 0 else "failed"
            log.close()
            results[key] = (state, dt)
            print(f"{state:6s} {key[0]} x {key[1]} {dt:.1f} s", flush=True)
            del running[key]
    done = set()
    if out.exists():
        for line in out.read_text().splitlines():
            rec = json.loads(line)
            key = (rec["arch"], rec["shape"])
            if "error" not in rec and results.get(key, ("",))[0] == "ok":
                done.add(key)
    ok = len(done)
    print(f"done: {ok}/{len(todo)} cells OK ({tag}) -> {out}")
    return 0 if ok == len(todo) else 1


if __name__ == "__main__":
    sys.exit(main())
