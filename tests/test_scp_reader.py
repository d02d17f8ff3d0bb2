import numpy as np
import pytest

from sypha import parse_scp_text, read_scp_file, scp_standard_form, pad_lp


TINY = """3 4
2 3 4 5
2 1 2
2 2 3
3 1 3 4
"""


def test_parse_tiny():
    m = parse_scp_text(TINY, name="tiny")
    assert m.nrows == 3 and m.ncols == 4
    np.testing.assert_allclose(m.costs, [2, 3, 4, 5])
    assert [list(r) for r in m.rows] == [[0, 1], [1, 2], [0, 2, 3]]
    assert m.nnz == 7


def test_standard_form_tiny():
    m = parse_scp_text(TINY)
    A, b, c = scp_standard_form(m)
    assert A.shape == (3, 7)
    # surplus columns: -I block
    np.testing.assert_allclose(A[:, 4:], -np.eye(3))
    np.testing.assert_allclose(b, np.ones(3))
    np.testing.assert_allclose(c, [2, 3, 4, 5, 0, 0, 0])
    # covering entries
    assert A[0, 0] == 1 and A[0, 1] == 1 and A[0, 2] == 0
    assert A[2, 3] == 1


def test_pad_lp_shapes():
    m = parse_scp_text(TINY)
    lp = pad_lp(m)
    assert lp.m_pad % 8 == 0 and lp.n_pad % 128 == 0
    assert int(lp.m_real) == 3 and int(lp.n_real) == 7 and int(lp.n_struct) == 4
    # pad rows flagged, real rows not
    rp = np.asarray(lp.row_pad)
    assert rp[:3].sum() == 0 and rp[3:].sum() == lp.m_pad - 3
    # pad columns all-zero in A, cost 1
    A = np.asarray(lp.A)
    assert np.all(A[:, 7:] == 0)
    assert np.all(np.asarray(lp.c)[7:] == 1.0)


def test_parse_multiline_tokens():
    # same instance with tokens split arbitrarily across lines
    text = "3 4\n2 3\n4 5\n2\n1 2 2 2 3\n3 1\n3 4\n"
    m = parse_scp_text(text)
    assert [list(r) for r in m.rows] == [[0, 1], [1, 2], [0, 2, 3]]


def test_parse_rejects_bad_index():
    with pytest.raises(ValueError):
        parse_scp_text("1 2\n1 1\n1 5\n")


def test_read_beasley_instance(data_dir):
    m = read_scp_file(str(data_dir / "scp41.txt"))
    assert m.nrows == 200 and m.ncols == 1000
    assert m.nnz > 0
    # every row must be coverable
    assert all(len(r) > 0 for r in m.rows)


def test_read_demo_tiny(data_dir):
    m = read_scp_file(str(data_dir / "scp_demo_tiny00.txt"))
    assert m.nrows == 5 and m.ncols == 15
