"""Seeded set-covering instances at the published OR-Library shapes.

Beasley's OR-Library describes each SCP family by its shape and density
(J.E. Beasley, "An algorithm for set covering problem", EJOR 31 (1987)
85-93, sets 4 and 5; Beasley and Jornsten, EJOR 58 (1992) 293-300, sets
NRE-NRH).  Instances here follow those descriptions, not the published
files: the matrix is random with the stated density, every column covers
at least one row, every row is covered by at least two columns, and column
costs are uniform integers.  They are test and benchmark input for the
solver at real sizes where the OR-Library files are not at hand.

    python -m sypha.io.generate --family scp4 --seed 0 --out scp4_s0.txt
"""

from __future__ import annotations

import argparse
import zlib
from dataclasses import dataclass

import numpy as np

from sypha.core.problem import ScpModel


@dataclass(frozen=True)
class Family:
    nrows: int
    ncols: int
    density: float  # nonzeros / (nrows * ncols)
    cost_range: tuple  # inclusive integer range of column costs


FAMILIES = {
    # Beasley (1987), sets 4 and 5: costs in [1, 100]
    "scp4": Family(200, 1000, 0.02, (1, 100)),
    "scp5": Family(200, 2000, 0.02, (1, 100)),
    # Beasley and Jornsten (1992), sets NRE and NRG; the cost range
    # [1, 100] is assumed (the OR-Library description gives none for them)
    "scpnre": Family(500, 5000, 0.10, (1, 100)),
    "scpnrg": Family(1000, 10000, 0.02, (1, 100)),
}


def generate_scp(family: str, seed: int) -> ScpModel:
    """A random instance of ``family`` (a key of FAMILIES); equal seeds give
    equal instances."""
    f = FAMILIES[family]
    return random_scp(f.nrows, f.ncols, f.density, f.cost_range,
                      seed=[int(seed), zlib.crc32(family.encode())],
                      name=f"{family}_s{seed}")


def random_scp(nrows: int, ncols: int, density: float, cost_range=(1, 100),
               seed=0, name: str = "") -> ScpModel:
    """A random covering matrix of the given shape and density (every row
    covered by at least two columns, every column covering at least one
    row) with uniform integer costs in ``cost_range``."""
    m, n = nrows, ncols
    rng = np.random.default_rng(seed)
    A = np.zeros((m, n), dtype=bool)
    # every row covered by at least two distinct columns
    for i in range(m):
        A[i, rng.choice(n, size=2, replace=False)] = True
    # every column covers at least one row
    bare = np.flatnonzero(~A.any(axis=0))
    A[rng.integers(0, m, size=bare.size), bare] = True
    # fill uniformly at random up to the density
    need = int(round(density * m * n)) - int(A.sum())
    if need > 0:
        free = np.flatnonzero(~A.ravel())
        A.ravel()[rng.choice(free, size=need, replace=False)] = True
    lo, hi = cost_range
    costs = rng.integers(lo, hi + 1, size=n).astype(np.float64)
    rows = [np.flatnonzero(A[i]).astype(np.int32) for i in range(m)]
    return ScpModel(nrows=m, ncols=n, costs=costs, rows=rows, name=name)


def write_scp_file(model: ScpModel, path: str, per_line: int = 12) -> None:
    """Write ``model`` in the OR-Library text format (what io.scp_reader
    parses): ``nrows ncols``, the column costs, then for each row its count
    and its 1-based column indices, ``per_line`` numbers to a line."""

    def wrap(values):
        return [
            " " + " ".join(str(v) for v in values[k : k + per_line])
            for k in range(0, len(values), per_line)
        ]

    lines = [f" {model.nrows} {model.ncols}"]
    lines += wrap([int(c) if float(c).is_integer() else float(c)
                   for c in model.costs])
    for cols in model.rows:
        lines.append(f" {len(cols)}")
        lines += wrap([int(j) + 1 for j in cols])
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m sypha.io.generate",
        description="write a seeded OR-Library-shape SCP instance",
    )
    p.add_argument("--family", required=True, choices=sorted(FAMILIES))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True, help="output file path")
    args = p.parse_args(argv)
    write_scp_file(generate_scp(args.family, args.seed), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
