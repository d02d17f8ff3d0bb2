"""Seeded OR-Library-shape instances (sypha.io.generate): shapes, density,
coverage, costs, the text format round trip, and an LP solve against
scipy's HiGHS."""

import numpy as np
import pytest

from sypha.io.generate import (
    FAMILIES,
    generate_scp,
    main,
    random_scp,
    write_scp_file,
)
from sypha.io.scp_reader import read_scp_file


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generate_scp_family(family):
    f = FAMILIES[family]
    m = generate_scp(family, 3)
    again = generate_scp(family, 3)
    other = generate_scp(family, 4)
    # seed-determinism
    np.testing.assert_array_equal(m.costs, again.costs)
    assert all(np.array_equal(a, b) for a, b in zip(m.rows, again.rows))
    assert not np.array_equal(m.costs, other.costs)
    # published shape and density (+-10%)
    assert (m.nrows, m.ncols) == (f.nrows, f.ncols)
    density = m.nnz / (m.nrows * m.ncols)
    assert abs(density - f.density) <= 0.1 * f.density
    # every row covered by >= 2 columns, every column covers >= 1 row
    assert min(len(r) for r in m.rows) >= 2
    covered = np.zeros(m.ncols, dtype=bool)
    for r in m.rows:
        assert len(np.unique(r)) == len(r)
        covered[r] = True
    assert covered.all()
    # integer costs in the family's range
    lo, hi = f.cost_range
    assert np.all(m.costs == np.round(m.costs))
    assert m.costs.min() >= lo and m.costs.max() <= hi


def test_write_read_round_trip(tmp_path):
    m = random_scp(30, 90, 0.1, seed=7, name="rt")
    path = tmp_path / "rt.txt"
    write_scp_file(m, str(path))
    r = read_scp_file(str(path))
    assert (r.nrows, r.ncols) == (m.nrows, m.ncols)
    np.testing.assert_array_equal(r.costs, m.costs)
    for a, b in zip(r.rows, m.rows):
        np.testing.assert_array_equal(a, b)


def test_generate_command_line(tmp_path):
    out = tmp_path / "scp4.txt"
    assert main(["--family", "scp4", "--seed", "1", "--out", str(out)]) == 0
    r = read_scp_file(str(out))
    m = generate_scp("scp4", 1)
    assert (r.nrows, r.ncols, r.nnz) == (m.nrows, m.ncols, m.nnz)
    np.testing.assert_array_equal(r.costs, m.costs)


def test_solve_lp_matches_highs():
    """solve_lp on a generated 50x250 instance agrees with HiGHS (rel 1e-6:
    the IPM's 1e-8 gap plus HiGHS's own 1e-7 feasibility tolerance)."""
    from sypha.testing import highs_lp
    from sypha import IpmStatus, pad_lp, solve_lp

    m = random_scp(50, 250, 0.05, seed=11)
    res = solve_lp(pad_lp(m))
    ref = highs_lp(m)
    assert res.status == IpmStatus.CONVERGED
    assert abs(res.primal_objective - ref) / max(1.0, abs(ref)) <= 1e-6
