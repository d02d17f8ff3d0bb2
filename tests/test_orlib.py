"""OR-Library-style parser view (reference benchmark/scp_parser.py:11-72)."""

import numpy as np

from sypha.io.orlib import orlib_to_model, parse_scp_file
from sypha.io.scp_reader import read_scp_file


def test_orlib_roundtrip(data_dir):
    path = str(data_dir / "scp41.txt")
    d = parse_scp_file(path)
    assert d["num_elements"] == 200 and d["num_sets"] == 1000
    assert len(d["sets"]) == 1000 and len(d["costs"]) == 1000
    # set-wise view inverts back to the row-wise model exactly
    m0 = read_scp_file(path)
    m1 = orlib_to_model(d)
    assert m1.nrows == m0.nrows and m1.ncols == m0.ncols and m1.nnz == m0.nnz
    np.testing.assert_array_equal(m1.costs, m0.costs)
    for a, b in zip(m1.rows, m0.rows):
        np.testing.assert_array_equal(a, b)


def test_orlib_elements_one_based(data_dir):
    d = parse_scp_file(str(data_dir / "scp41.txt"))
    all_elems = sorted({e for s in d["sets"] for e in s})
    assert all_elems[0] >= 1 and all_elems[-1] <= d["num_elements"]
