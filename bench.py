"""Batched LP IPM throughput on scp4-shape instances, on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "solves/s/chip", ...}

Ten seeded scp4-shape instances (sypha.io.generate: 200 rows x 1000
columns at 2% density, seeds 0-9) are solved to a 1e-8 relative duality
gap, each replicated across the lanes of the shared-matrix batched IPM (one
A per instance group, vmapped over groups — the same layout the B&B node
solver uses); the line reports aggregate solves/s and the warm single-LP
latency.  It refuses to run without a GPU: a CPU number is not a device
number.
"""

import json
import sys
import time


def main():
    import jax
    import numpy as np

    from sypha import IpmStatus, pad_lp
    from sypha.config import IpmOptions
    from sypha.io.generate import generate_scp
    from sypha.ipm.shared import make_shared_batch, mehrotra_solve_shared

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX platform {dev.platform!r})")

    models = [generate_scp("scp4", seed) for seed in range(10)]

    # One bucket for the whole family.
    mp = max(m.nrows for m in models)
    np_ = max(m.nrows + m.ncols for m in models)
    mp += (-mp) % 8
    np_ += (-np_) % 128

    lanes = 128  # lanes per instance group
    batches = [
        make_shared_batch(pad_lp(m, m_pad=mp, n_pad=np_), lanes) for m in models
    ]
    grouped = jax.tree.map(lambda *xs: jax.numpy.stack(xs), *batches)
    G = len(batches)
    B = G * lanes
    opts = IpmOptions()

    solve = jax.jit(jax.vmap(lambda g: mehrotra_solve_shared(g, opts)))
    jax.block_until_ready(solve(grouped))  # compile + warm up

    t0 = time.perf_counter()
    st = jax.block_until_ready(solve(grouped))
    dt = time.perf_counter() - t0

    gaps = np.asarray(st.gap)
    status = np.asarray(st.status)
    n_conv = int((status == IpmStatus.CONVERGED).sum())
    if n_conv != B:
        print(
            f"WARNING: only {n_conv}/{B} lanes converged "
            f"(worst gap {gaps.max():.2e})",
            file=sys.stderr,
        )

    # single-LP warm latency: ONE lane of the first instance start-to-1e-8;
    # host-clock noise makes one sample unreliable, so report min + median
    single = jax.jit(lambda g: mehrotra_solve_shared(g, opts))
    one = make_shared_batch(pad_lp(models[0], m_pad=mp, n_pad=np_), 1)
    jax.block_until_ready(single(one))  # compile + warm
    lat = []
    for _ in range(7):
        t1 = time.perf_counter()
        jax.block_until_ready(single(one))
        lat.append(time.perf_counter() - t1)
    lat.sort()

    print(
        json.dumps(
            {
                "metric": "batched scp4-shape LP IPM throughput (1e-8 gap)",
                "value": B / dt,
                "unit": "solves/s/chip",
                "single_lp_latency_s": lat[len(lat) // 2],
                "single_lp_latency_min_s": lat[0],
                "lanes_converged": n_conv,
                "lanes": B,
                "ipm_iters_total": int(np.asarray(st.iterations).sum()),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "methodology": (
                    f"{G} generated scp4-shape instances (seeds 0-{G - 1}) x "
                    f"{lanes} replicated lanes per group (the B&B node-window "
                    "layout: one shared A per group, lanes differ only in "
                    "masks/rhs); every lane is a full independent IPM solve "
                    "to 1e-8; warm, compile excluded; latency = 1 lane of "
                    "seed 0 warm, median of 7"
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
