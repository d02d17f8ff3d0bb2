"""Logging/watchdog/timers — the reference's L0 infra (SyphaLogger,
phase timers)."""

import io
import time

from sypha.utils.logging import Logger
from sypha.utils.timers import PhaseTimers


def test_logger_levels_and_format():
    buf = io.StringIO()
    log = Logger(verbosity=3, stream=buf, color=False)
    log.info("hello")
    log.debug("hidden")  # verbosity 3 = INFO
    log.error("bad")
    out = buf.getvalue().splitlines()
    assert len(out) == 2
    assert "[INFO " in out[0] and out[0].endswith("hello")
    assert "[ERROR]" in out[1]
    # elapsed-seconds stamp
    assert out[0].startswith("[")


def test_watchdog():
    log = Logger(verbosity=0, hard_time_limit_sec=0.05)
    assert not log.is_stop_requested()
    time.sleep(0.06)
    assert log.is_stop_requested()
    assert not Logger(verbosity=0).is_stop_requested()


def test_phase_timers():
    t = PhaseTimers()
    t.start("pre")
    time.sleep(0.01)
    t.stop("pre")
    t.start("solver")
    t.stop("solver")
    assert t.elapsed_ms["pre"] >= 10.0
    rep = t.report()
    assert "TIME PRE" in rep and "TIME SOLVER" in rep


def test_request_stop_flag():
    from sypha.utils.logging import Logger

    log = Logger(verbosity=0)
    assert not log.is_stop_requested()
    log.request_stop()
    assert log.is_stop_requested()
