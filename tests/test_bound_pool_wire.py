"""BoundPool wire-format + fold-robustness unit tests (single process).

ADVICE r3 (high): numpy scalars reach sync/finalize (heuristics return
np.float64 costs) and repr(np.float64(x)) is unparseable under numpy>=2 —
the encode must cast.  VERDICT r3 weak #7: stale/out-of-order reads must
never regress the pooled view, and wire corruption must raise instead of
masquerading as an unpublished peer.
"""

import numpy as np
import pytest

from sypha.parallel.distributed import BoundPool, PooledBounds


def test_encode_accepts_numpy_scalars():
    s = BoundPool._encode(
        np.int64(3), np.float64(429.0), np.float32(417.5), np.bool_(True), 0,
        None,
    )
    seq, inc, db, stop, dep, sol = BoundPool._decode(s)
    assert seq == 3
    assert inc == 429.0
    assert db == 417.5
    assert stop is True
    assert dep is False
    assert sol is None


def test_encode_roundtrips_full_float_precision():
    v = 429.0000001234567
    s = BoundPool._encode(1, v, -v, False, True, None)
    _, inc, db, stop, dep, _ = BoundPool._decode(s)
    assert inc == v and db == -v
    assert stop is False and dep is True


def test_solution_bits_roundtrip():
    x = np.zeros(37)
    x[[0, 5, 11, 36]] = 1.0
    s = BoundPool._encode(2, 4.0, 3.0, False, False, x)
    *_, sol = BoundPool._decode(s)
    # unpackbits pads to a byte multiple; the prefix must match exactly
    assert sol is not None and sol.shape[0] >= 37
    np.testing.assert_array_equal(sol[:37], x)
    assert not sol[37:].any()


def test_solution_bits_accept_numpy_float_solution():
    x = np.asarray([1.0, 0.0, 1.0], dtype=np.float64)
    s = BoundPool._encode(1, np.float64(2.0), np.float64(1.0), 0, 0, x)
    *_, sol = BoundPool._decode(s)
    np.testing.assert_array_equal(sol[:3], x)


def test_decode_raises_on_corrupt_value():
    with pytest.raises(ValueError):
        BoundPool._decode("1,np.float64(429.0),417.5,0,0,")


def _mk_pool():
    """A pool with the distributed client stubbed out (n_processes faked)."""
    pool = BoundPool.__new__(BoundPool)
    pool.n_processes = 2
    pool.pid = 0
    pool._seq = 0
    pool._peer_cache = {}
    pool._ns = "test_ns"
    pool._client = None
    return pool


def test_fold_peer_is_monotone_in_seq():
    pool = _mk_pool()
    pool._fold_peer(1, (5, 420.0, 410.0, False, False, None))
    # an out-of-order (stale) read must not overwrite the newer row
    pool._fold_peer(1, (3, 500.0, 300.0, True, False, None))
    assert pool._peer_cache[1][0] == 5
    assert pool._peer_cache[1][1] == 420.0
    # a newer row does
    pool._fold_peer(1, (6, 415.0, 410.0, False, True, None))
    assert pool._peer_cache[1][0] == 6
    assert pool._peer_cache[1][4] is True
    # a miss (None) leaves the cache untouched
    pool._fold_peer(1, None)
    assert pool._peer_cache[1][0] == 6


def test_read_peer_reraises_non_miss_errors():
    pool = _mk_pool()

    class _Client:
        def key_value_try_get(self, key):
            raise RuntimeError("DEADLINE_EXCEEDED: coordination service")

    pool._client = _Client()
    with pytest.raises(RuntimeError):
        pool._read_peer(1)

    class _Miss:
        def key_value_try_get(self, key):
            raise RuntimeError("NOT_FOUND: key test_ns/1")

    pool._client = _Miss()
    assert pool._read_peer(1) is None


def test_single_process_sync_casts_numpy():
    pool = BoundPool.__new__(BoundPool)
    pool.n_processes = 1
    pool.pid = 0
    pool._seq = 0
    pool._peer_cache = {}
    pool._client = None
    out = pool.sync(np.float64(429.0), np.float64(417.0), np.bool_(False))
    assert isinstance(out, PooledBounds)
    assert isinstance(out.incumbent, float) and out.incumbent == 429.0
    assert isinstance(out.stop, bool)
