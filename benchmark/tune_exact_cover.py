#!/usr/bin/env python3
"""Offline exact-cover engine tuning sweep (VERDICT r4: the last refute).

scpnre1/scpnre3 each end ONE refutation short of an optimality proof at
300 s (refute-28 over 401 columns / refute-26 over ~700): this harness
replays those exact probes against the native DFS so engine knobs can be
graded in minutes without a device run in the loop.

Faces come from benchmark/face_make.py (CPU HiGHS duals — slightly harder
than in-run faces, the right direction for tuning).  Usage:

  python benchmark/face_make.py scpnre1 29 /tmp/faces/nre1_b29.npz
  python benchmark/face_make.py scpnre3 27 /tmp/faces/nre3_b27.npz
  python benchmark/tune_exact_cover.py /tmp/faces/nre1_b29.npz --budget 28 \
      [--deadline 420] [--env SYPHA_EC_PROBE=1 ...]

Each run reports verdict + wall + the SYPHA_EC_STATS counters (dfs calls,
ascent visits, dominance pairs) so a knob's effect is attributable.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def run_one(face: str, budget: float, deadline: float, env_overrides):
    env = dict(os.environ)
    env["SYPHA_EC_STATS"] = "1"
    for kv in env_overrides:
        k, _, v = kv.partition("=")
        env[k] = v
    t0 = time.monotonic()
    p = subprocess.run(
        [
            sys.executable,
            os.path.join(HERE, "face_replay.py"),
            face,
            "--budget",
            str(budget),
            "--deadline",
            str(deadline),
        ],
        capture_output=True,
        text=True,
        env=env,
        cwd=os.path.join(HERE, ".."),
    )
    wall = time.monotonic() - t0
    stats = [
        ln for ln in p.stderr.splitlines() if ln.startswith("[ec]")
    ]
    return p.stdout.strip(), wall, stats, p.returncode


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("face")
    ap.add_argument("--budget", type=float, required=True)
    ap.add_argument("--deadline", type=float, default=420.0)
    ap.add_argument(
        "--env",
        nargs="*",
        default=[],
        help="engine env overrides, e.g. SYPHA_EC_PROBE=0",
    )
    ap.add_argument(
        "--grid",
        action="store_true",
        help="sweep SYPHA_EC_SWEEPS x SYPHA_EC_DOM (PROBE on), best-first "
        "report; single --env run otherwise",
    )
    args = ap.parse_args()
    if not args.grid:
        out, wall, stats, rc = run_one(
            args.face, args.budget, args.deadline, args.env
        )
        print(out)
        for ln in stats[-4:]:
            print(ln)
        print(f"wall={wall:.1f}s rc={rc}")
        return

    results = []
    for sweeps in (1, 2, 4, 8):
        for dom in (16, 64, 256, 2048):
            env = [f"SYPHA_EC_SWEEPS={sweeps}", f"SYPHA_EC_DOM={dom}"]
            out, wall, stats, rc = run_one(
                args.face, args.budget, args.deadline, env
            )
            verdict = out.splitlines()[-1] if out else "?"
            tag = f"sweeps={sweeps} dom={dom}"
            print(f"{tag:24s} wall={wall:7.1f}s  {verdict}")
            sys.stdout.flush()
            results.append((wall, tag, verdict))
    results.sort()
    print("\n=== fastest ===")
    for wall, tag, verdict in results[:5]:
        print(f"{wall:7.1f}s  {tag}  {verdict}")


if __name__ == "__main__":
    main()
