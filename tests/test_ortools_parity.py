"""LP parity against the reference's committed OR-Tools GLOP results
(benchmark/results/benchmark_results_with_ip.csv — the cross-solver parity
strategy of SURVEY §4.2, tolerance 0.1% rel / 0.01 abs like
benchmark/test_cuda_solver.py:142-153), over instance families beyond the
golden tables (scpa/scpb, clr, cyc, demos)."""

import csv

import numpy as np
import pytest

REL_TOL = 0.001
ABS_TOL = 0.01

CSV_PATH = "/root/reference/benchmark/results/benchmark_results_with_ip.csv"


def _ortools_lp_table():
    try:
        with open(CSV_PATH, newline="") as f:
            rows = list(csv.DictReader(f))
    except OSError:
        pytest.skip("reference benchmark CSV not available")
    return {
        r["instance"].replace(".txt", ""): float(r["lp_objective"])
        for r in rows
        if r.get("lp_status") == "OPTIMAL" and r.get("lp_objective")
    }


FAMILIES = {
    "scpa": [f"scpa{i}" for i in range(1, 6)],
    "scpb": [f"scpb{i}" for i in range(1, 6)],
    "scpclr": ["scpclr10", "scpclr11"],
    "scpcyc": ["scpcyc06", "scpcyc07"],
    "demo": ["scp_demo_tiny01", "scp_demo_tiny02", "demo00"],
}


@pytest.mark.parametrize("family", ["scpclr", "scpcyc", "demo"])
def test_ortools_lp_parity_small(family, data_dir):
    _run_family(family, data_dir)


@pytest.mark.slow
@pytest.mark.parametrize("family", ["scpa", "scpb"])
def test_ortools_lp_parity_large(family, data_dir):
    _run_family(family, data_dir)


def _run_family(family, data_dir):
    import jax

    from sypha import pad_lp, read_scp_file, solve_lp
    from sypha.config import IpmOptions
    from sypha.core.status import IpmStatus

    table = _ortools_lp_table()
    checked = 0
    for name in FAMILIES[family]:
        ref = table.get(name)
        path = data_dir / f"{name}.txt"
        if ref is None or not path.exists():
            continue
        model = read_scp_file(str(path))
        res = solve_lp(pad_lp(model), IpmOptions())
        tol = max(ABS_TOL, REL_TOL * abs(ref))
        assert res.status == IpmStatus.CONVERGED, (name, res.status)
        assert abs(res.primal_objective - ref) <= tol, (
            name, res.primal_objective, ref,
        )
        assert abs(res.dual_objective - ref) <= tol, (name, res.dual_objective, ref)
        checked += 1
    assert checked > 0, f"no instances checked for family {family}"
