"""Multi-host coordination for the distributed B&B.

The reference keeps the cross-worker state (incumbent objective, global
dual bound, stop flag) in plain host variables of its single process
(src/sypha_solver_bnb_driver.cpp:256-261, :1048-1079 — SURVEY §2.3 item 4).
Across processes those become the ONLY cross-host traffic: tiny scalar publishes on a
cadence.

Transport: the jax.distributed coordination-service KEY-VALUE store, not a
collective.  A collective (process_allgather) forces every host to reach
the same call site in lockstep — measured here, a host paying a 45 s XLA
precompile stalls its peer's whole search loop, and a host that exits a
phase early trips the Gloo/coordination barrier timeouts.  B&B hosts are
*asynchronous by nature* (different tree shapes, different compile
ladders), and the pooled quantities are monotone (incumbents only
decrease, proven bounds only increase, stop is sticky), so an async
read of a peer's LAST PUBLISHED value is always sound — staleness only
delays propagation, never corrupts it.

Single-process runs degrade to a no-op pool so the B&B driver can call
``sync()`` unconditionally.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

import jax


def initialize_distributed(
    coordinator_address=None,
    num_processes=None,
    process_id=None,
    local_device_ids=None,
) -> int:
    """Bring up the jax.distributed runtime (multi-process).  Returns the
    process count (1 when unconfigured — single-process mode).

    A process sees every local GPU unless ``local_device_ids`` says
    otherwise.  With several processes on one host, give each its own
    card (``local_device_ids=[process_id]``, or ``CUDA_VISIBLE_DEVICES``
    per process): a JAX process reserves most of a card's memory when it
    first uses it, so a second process on the same card fails."""
    if coordinator_address is None:
        return jax.process_count()
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return jax.process_count()


@dataclass
class PooledBounds:
    incumbent: float
    dual_bound: float
    stop: bool
    # every process has announced departure (finished its own search):
    # the finalize() drain loop may end
    all_departed: bool = False
    # 0/1 column-selection bits of the process owning the pooled incumbent
    # (None when that process did not publish a solution) — ships the
    # incumbent COVER with its objective so adopters never pair a remote
    # objective with a stale local solution vector
    incumbent_solution: np.ndarray | None = None


class BoundPool:
    """Scalar bound pooling across hosts over the coordination-service KV
    store.

    Each process owns one key and overwrites it with
    ``seq,incumbent,dual_bound,stop,departed``; ``sync()`` publishes ours
    and folds whatever peer values are currently visible (non-blocking by
    default).  ``finalize()`` marks this host departed and polls until
    every process has departed, so all processes exit near-simultaneously
    and the jax.distributed shutdown barrier never times out on a
    fast-finishing host.

    Namespacing: each construction bumps a per-process counter so
    back-to-back solves in one process pair never read the previous run's
    keys.  All processes must construct their BoundPools in the same order
    (they run the same program), mirroring collective-style usage.
    """

    _instance_counter = 0

    def __init__(self):
        self.n_processes = jax.process_count()
        self.pid = jax.process_index()
        self._seq = 0
        # Per-peer cache of the highest-seq row ever read.  Each publisher
        # only ever increases its seq, but the cache makes the fold robust
        # even if a read returns an out-of-order value: a row with
        # seq <= cached seq is ignored, so pooled views never regress.
        self._peer_cache = {}
        BoundPool._instance_counter += 1
        self._ns = f"sypha_bound_pool/{BoundPool._instance_counter}"
        self._client = None
        if self.n_processes > 1:
            from jax._src import distributed

            self._client = distributed.global_state.client

    # ---- wire format ----

    @staticmethod
    def _encode(seq, incumbent, dual_bound, stop, departed, solution) -> str:
        # float() casts matter: numpy scalars DO reach sync/finalize
        # (heuristics return np.float64 costs), and repr(np.float64(429.0))
        # is 'np.float64(429.0)' under numpy>=2 — unparseable by _decode.
        # The solution ships as hex-packed bits (n=10000 cols -> 2.5 KB),
        # so adopters get the cover WITH its objective.
        bits = ""
        if solution is not None:
            bits = np.packbits(
                np.asarray(solution).ravel() > 0.5
            ).tobytes().hex()
        return (
            f"{int(seq)},{float(incumbent)!r},{float(dual_bound)!r},"
            f"{int(stop)},{int(departed)},{bits}"
        )

    @staticmethod
    def _decode(v: str):
        seq, inc, db, stop, dep, bits = v.split(",")
        sol = None
        if bits:
            sol = np.unpackbits(
                np.frombuffer(bytes.fromhex(bits), dtype=np.uint8)
            ).astype(np.float64)
        return int(seq), float(inc), float(db), stop == "1", dep == "1", sol

    def _publish(self, incumbent, dual_bound, stop, departed, solution):
        self._seq += 1
        self._client.key_value_set(
            f"{self._ns}/{self.pid}",
            self._encode(
                self._seq, incumbent, dual_bound, stop, departed, solution
            ),
            allow_overwrite=True,
        )

    def _read_peer(self, pid):
        # Only a KV-store miss means "peer has not published yet"; a value
        # that EXISTS but fails to parse is wire corruption and must raise —
        # swallowing it would silently disable pooling (and deadlock
        # finalize's departure drain, which waits on all_departed).
        try:
            raw = self._client.key_value_try_get(f"{self._ns}/{pid}")
        except Exception as e:  # XlaRuntimeError NOT_FOUND on a miss
            if "NOT_FOUND" in str(e) or "not found" in str(e).lower():
                return None
            raise
        return self._decode(raw)

    # ---- pooling ----

    def sync(
        self,
        incumbent: float,
        dual_bound: float,
        stop: bool,
        departed: bool = False,
        wait: bool = False,
        wait_timeout_sec: float = 600.0,
        solution=None,
    ) -> PooledBounds:
        """Publish our scalars (plus the optional incumbent cover bits),
        fold the peers' latest.

        ``wait=False`` (the B&B cadence): non-blocking — peers that have
        not published yet simply do not contribute this round.
        ``wait=True``: block until every peer has published at least as
        many rounds as we have (synchronous gather semantics, used by
        tests and one-shot exchanges)."""
        if self.n_processes <= 1:
            return PooledBounds(
                float(incumbent), float(dual_bound), bool(stop), departed
            )
        self._publish(incumbent, dual_bound, stop, departed, solution)
        if wait:
            # double barrier: everyone has published round `seq` before
            # anyone reads, and everyone has read before anyone may
            # overwrite with round seq+1
            tmo = int(wait_timeout_sec * 1000)
            self._client.wait_at_barrier(f"{self._ns}/pub{self._seq}", tmo)
            for pid in range(self.n_processes):
                if pid != self.pid:
                    self._fold_peer(pid, self._read_peer(pid))
            self._client.wait_at_barrier(f"{self._ns}/read{self._seq}", tmo)
        else:
            for pid in range(self.n_processes):
                if pid != self.pid:
                    self._fold_peer(pid, self._read_peer(pid))
        mine = (
            self._seq,
            float(incumbent),
            float(dual_bound),
            stop,
            departed,
            None if solution is None else np.asarray(solution, np.float64),
        )
        rows = [mine] + list(self._peer_cache.values())
        best = min(rows, key=lambda r: r[1])
        return PooledBounds(
            incumbent=float(best[1]),
            dual_bound=float(min(r[2] for r in rows)),
            stop=bool(any(r[3] for r in rows)),
            all_departed=(
                len(rows) == self.n_processes and all(r[4] for r in rows)
            ),
            incumbent_solution=best[5],
        )

    def _fold_peer(self, pid, row):
        """Keep the highest-seq row per peer (monotone: stale reads or
        out-of-order arrivals can never regress the pooled view)."""
        if row is None:
            return
        cached = self._peer_cache.get(pid)
        if cached is None or row[0] > cached[0]:
            self._peer_cache[pid] = row

    def finalize(
        self,
        incumbent: float,
        dual_bound: float,
        stop_peers: bool,
        poll_sec: float = 0.2,
        drain_timeout_sec: float | None = None,
        solution=None,
    ) -> PooledBounds:
        """Drain loop for a host whose search ended: announce departure
        (with our final incumbent/bound) and poll until every process has
        departed.

        ``stop_peers`` — True when this host CLOSED the shared search
        (optimality proven / infeasible): peers working on the same
        instance should stop at their next sync.  False on a local
        time/node limit: peers with budget left keep searching; we merely
        donate our final incumbent/bound and wait for them.  Returns the
        last pooled view (the globally agreed incumbent).

        A crashed peer never departs.  By default
        (``drain_timeout_sec=None``) the drain polls indefinitely and the
        coordination service's missed-heartbeat detection errors out the
        surviving process — no local timeout races against it.  Pass a
        finite ``drain_timeout_sec`` to instead give up after that many
        seconds and return the last pooled view with
        ``all_departed=False`` (the caller decides whether that is fatal);
        useful when the caller runs its own peer-liveness policy."""
        deadline = (
            None
            if drain_timeout_sec is None
            else time.monotonic() + drain_timeout_sec
        )
        out = self.sync(
            incumbent, dual_bound, stop_peers, departed=True,
            solution=solution,
        )
        while self.n_processes > 1 and not out.all_departed:
            if deadline is not None and time.monotonic() > deadline:
                break
            time.sleep(poll_sec)
            out = self.sync(
                incumbent, dual_bound, stop_peers, departed=True,
                solution=solution,
            )
        return out
