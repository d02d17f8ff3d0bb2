"""Device telemetry + profiler hooks.

Counterpart of the reference's GPU-memory sampling around every linear
solve (src/sypha_solver.cpp:209-216, :322-340, :805-817 — free-before /
after-setup / min-during / peak reporting) and of its per-phase TRACE
logging; the profiler hook is the batched build's upgrade (jax.profiler traces
are viewable in TensorBoard / Perfetto).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, Optional

import jax


@dataclass
class DeviceMemoryStats:
    bytes_in_use: int = 0
    peak_bytes_in_use: int = 0
    bytes_limit: int = 0

    @property
    def free_bytes(self) -> int:
        return max(0, self.bytes_limit - self.bytes_in_use)

    def __str__(self) -> str:
        gb = 1 << 30
        return (
            f"in_use={self.bytes_in_use / gb:.3f}GiB "
            f"peak={self.peak_bytes_in_use / gb:.3f}GiB "
            f"limit={self.bytes_limit / gb:.3f}GiB"
        )


def device_memory_stats(device=None) -> Optional[DeviceMemoryStats]:
    """Memory stats of a device (default: first local device); None when
    the backend does not expose them (e.g. CPU)."""
    dev = device or jax.local_devices()[0]
    try:
        stats = dev.memory_stats()
    except (RuntimeError, AttributeError):
        return None
    if not stats:
        return None
    return DeviceMemoryStats(
        bytes_in_use=int(stats.get("bytes_in_use", 0)),
        peak_bytes_in_use=int(stats.get("peak_bytes_in_use", 0)),
        bytes_limit=int(stats.get("bytes_limit", 0)),
    )


class MemorySampler:
    """Before/after/peak sampling around a solver phase (the reference's
    GpuMemorySampling, skippable per B&B node via
    SolverExecutionConfig.skipGpuMemorySampling)."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = device
        self.before: Optional[DeviceMemoryStats] = None
        self.after: Optional[DeviceMemoryStats] = None

    def __enter__(self) -> "MemorySampler":
        if self.enabled:
            self.before = device_memory_stats(self.device)
        return self

    def __exit__(self, *exc) -> None:
        if self.enabled:
            self.after = device_memory_stats(self.device)

    def report(self) -> str:
        if not self.enabled or self.before is None or self.after is None:
            return "memory sampling unavailable"
        return f"before: {self.before} | after: {self.after}"


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """jax.profiler trace around a solve (TensorBoard/Perfetto viewable)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
