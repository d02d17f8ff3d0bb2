"""B&B checkpoint/resume + telemetry utilities."""

import numpy as np

from sypha.config import BnbOptions, SolverConfig
from sypha.core.status import MilpStatus
from sypha.io.scp_reader import read_scp_file
from sypha.milp.bnb import branch_and_bound


def test_checkpoint_resume(tmp_path, data_dir):
    """Interrupt scp42 after a tiny time budget, then resume from the
    checkpoint and finish: final objective must match an uninterrupted run
    (golden MILP incumbent 512, reference sypha_results.csv)."""
    ckpt = str(tmp_path / "bnb.ckpt")
    cfg_short = SolverConfig(
        verbosity=0,
        bnb=BnbOptions(
            checkpoint_path=ckpt,
            checkpoint_interval_sec=0.0,  # save at every loop head
            hard_time_limit_sec=3.0,
        ),
    )
    m = read_scp_file(str(data_dir / "scp42.txt"))
    r1 = branch_and_bound(m, cfg_short)

    cfg_resume = SolverConfig(
        verbosity=0,
        bnb=BnbOptions(checkpoint_path=ckpt, checkpoint_interval_sec=30.0),
    )
    r2 = branch_and_bound(m, cfg_resume)
    assert r2.status == MilpStatus.OPTIMAL
    assert abs(r2.objective - 512.0) < 1e-9


def test_memory_stats_graceful():
    from sypha.utils.telemetry import MemorySampler, device_memory_stats

    # CPU backend exposes no memory stats: must return None, not raise
    stats = device_memory_stats()
    with MemorySampler(enabled=True) as ms:
        pass
    assert isinstance(ms.report(), str)
    if stats is not None:
        assert stats.bytes_limit >= 0
