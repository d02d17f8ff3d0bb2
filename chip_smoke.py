#!/usr/bin/env python3
"""End-to-end smoke check of sypha on one NVIDIA GPU.

Drives the solver's main paths once, in this one process, at OR-Library
sizes on seeded instances (sypha.io.generate), and checks every answer
against scipy's HiGHS:

  0. device: a GPU or nothing (no CPU fallback); card name and power limit
  1. single LP through the CLI (``--disable-bnb``: solve_lp / ipm.dense)
  2. shared-matrix batched LP, 10 scp4-shape groups x 128 lanes
     (vmapped mehrotra_solve_shared, the B&B node-window layout)
  3. padded-ELL sparse operator on a 1000 x 10000 scpnrg-shape LP, 8 lanes
  4. MILP branch-and-bound through the CLI (presolve, cuts, heuristics,
     node windows, exact closure), 300 s limit, against HiGHS's MILP

Every phase prints one line with its numbers and its compile seconds.  The
last line of standard output is the JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
a failed phase exits non-zero without it.

    python chip_smoke.py            # phases 0-4 on one GPU
    python chip_smoke.py --gpus 4   # only the four-GPU mesh path, against
                                    # the one-GPU run and HiGHS
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REL_TOL = 1e-6  # objective vs HiGHS: the IPM's 1e-8 gap + HiGHS's 1e-7 feasibility
GAP_TOL = 1e-8  # the IPM's own convergence target


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _run_cli(argv):
    """sypha.cli.main in process; returns (wall seconds, parsed output)."""
    from sypha import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    dt = time.perf_counter() - t0
    text = buf.getvalue()
    _check(rc == 0, f"cli exited {rc}:\n{text[-2000:]}")
    out = dict(re.findall(r"^([A-Z][A-Z ]*[A-Z]):\s*(.*)$", text, re.M))
    sel = re.search(r"^SELECTED COLUMNS \(\d+\): \[(.*)\]$", text, re.M)
    if sel:
        out["SELECTED"] = [int(v) for v in sel.group(1).split(",") if v.strip()]
    return dt, out


def phase_device():
    import jax

    import sypha  # noqa: F401  (package-wide JAX settings)
    from sypha import native

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        sys.exit(2)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"unavailable ({e})"
    print(f"[0] device: {devs[0].device_kind} x{len(devs)} | nvidia-smi: {smi}")
    print(f"[0] compile cache: {jax.config.jax_compilation_cache_dir} | "
          f"native host library loaded: {native.available()}")
    return devs


def phase_single_lp(workdir: str, seed: int = 0) -> None:
    from sypha.testing import highs_lp
    from sypha.io.generate import generate_scp, write_scp_file

    model = generate_scp("scp4", seed)
    path = os.path.join(workdir, f"{model.name}.txt")
    write_scp_file(model, path)
    argv = ["--input-file", path, "--disable-bnb", "--verbosity", "1"]
    t_cold, _ = _run_cli(argv)
    t_warm, out = _run_cli(argv)
    ref = highs_lp(model)
    obj, gap = float(out["PRIMAL"]), float(out["GAP"])
    print(f"[1] single LP (cli, {model.name} {model.nrows}x{model.ncols}): "
          f"{out['STATUS']} obj={obj:.10g} HiGHS={ref:.10g} "
          f"rel={_rel(obj, ref):.2e} gap={gap:.2e} iters={out['ITERATIONS']} "
          f"warm={t_warm:.3f}s compile~{t_cold - t_warm:.1f}s")
    _check(out["STATUS"] == "CONVERGED", f"single LP status {out['STATUS']}")
    _check(gap <= GAP_TOL, f"single LP gap {gap}")
    _check(_rel(obj, ref) <= REL_TOL, f"single LP objective {obj} vs {ref}")


def _lane_objectives(batch, st):
    import jax.numpy as jnp

    return np.asarray(jnp.sum(batch.c * st.x, axis=-1) + batch.obj_offset)


def phase_batched(seed: int = 0, groups: int = 10, lanes: int = 128) -> None:
    import jax

    from sypha.testing import highs_lp
    from sypha import IpmStatus, pad_lp
    from sypha.config import IpmOptions
    from sypha.io.generate import generate_scp
    from sypha.ipm.shared import make_shared_batch, mehrotra_solve_shared

    models = [generate_scp("scp4", seed + g) for g in range(groups)]
    mp = max(m.nrows for m in models)
    np_ = max(m.nrows + m.ncols for m in models)
    mp += (-mp) % 8
    np_ += (-np_) % 128
    batches = [make_shared_batch(pad_lp(m, m_pad=mp, n_pad=np_), lanes)
               for m in models]
    grouped = jax.tree.map(lambda *xs: jax.numpy.stack(xs), *batches)
    opts = IpmOptions()
    solve = jax.jit(jax.vmap(lambda g: mehrotra_solve_shared(g, opts)))
    t0 = time.perf_counter()
    jax.block_until_ready(solve(grouped))
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = jax.block_until_ready(solve(grouped))
    t_warm = time.perf_counter() - t0
    status = np.asarray(st.status)
    obj = np.stack([_lane_objectives(batches[g], jax.tree.map(lambda a: a[g], st))
                    for g in range(groups)])
    refs = np.asarray([highs_lp(m) for m in models])
    err = np.abs(obj - refs[:, None]) / np.maximum(1.0, np.abs(refs))[:, None]
    n_conv = int((status == IpmStatus.CONVERGED).sum())
    B = groups * lanes
    print(f"[2] shared-matrix batch ({groups} scp4-shape groups x {lanes} lanes, "
          f"{mp}x{np_} padded): {n_conv}/{B} CONVERGED, max rel vs HiGHS "
          f"{err.max():.2e}, worst gap {float(np.asarray(st.gap).max()):.2e}, "
          f"iters max {int(np.asarray(st.iterations).max())}; "
          f"smoke reading (not a benchmark): {B / t_warm:.1f} solves/s "
          f"({t_warm:.3f}s warm); compile~{t_cold - t_warm:.1f}s")
    _check(n_conv == B, f"batched LP: {B - n_conv} lanes not CONVERGED")
    _check(float(err.max()) <= REL_TOL, f"batched LP objective rel {err.max()}")


def phase_sparse(seed: int = 0, lanes: int = 8) -> None:
    import jax

    from sypha.testing import highs_lp
    from sypha import IpmStatus
    from sypha.config import IpmOptions
    from sypha.io.generate import generate_scp
    from sypha.ipm.shared import make_shared_batch_sparse, mehrotra_solve_shared

    model = generate_scp("scpnrg", seed)
    batch = make_shared_batch_sparse(model, lanes)
    opts = IpmOptions()
    solve = jax.jit(lambda b: mehrotra_solve_shared(b, opts))
    t0 = time.perf_counter()
    jax.block_until_ready(solve(batch))
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = jax.block_until_ready(solve(batch))
    t_warm = time.perf_counter() - t0
    obj = _lane_objectives(batch, st)
    ref = highs_lp(model)
    err = float(np.max(np.abs(obj - ref)) / max(1.0, abs(ref)))
    status = [IpmStatus(int(s)).name for s in np.asarray(st.status)]
    print(f"[3] padded-ELL sparse ({model.name} {model.nrows}x{model.ncols}, "
          f"{batch.m_pad}x{batch.n_pad} padded, {lanes} lanes): "
          f"obj={obj[0]:.10g} HiGHS={ref:.10g} max rel={err:.2e} "
          f"status={sorted(set(status))} iters={int(np.asarray(st.iterations).max())} "
          f"warm={t_warm:.3f}s compile~{t_cold - t_warm:.1f}s")
    _check(err <= REL_TOL, f"sparse LP objective rel {err}")


def phase_milp(workdir: str, seed: int = 5, time_limit: float = 300.0) -> None:
    # seed 5 has a root gap (LP 519.625 vs optimum 525): closing it takes
    # the search's reductions, cuts, heuristics or closure, not the root LP
    from sypha.testing import highs_milp
    from sypha.io.generate import generate_scp, write_scp_file

    model = generate_scp("scp4", seed)
    path = os.path.join(workdir, f"{model.name}.txt")
    write_scp_file(model, path)
    wall, out = _run_cli(["--input-file", path, "--time-limit", str(time_limit),
                          "--verbosity", "1", "--show-solution"])
    h_status, h_inc, h_bound = highs_milp(model, time_limit)
    inc, bound = float(out["PRIMAL"]), float(out["DUAL"])
    x = np.zeros(model.ncols)
    x[out.get("SELECTED", [])] = 1.0
    tol = 1e-6 * max(1.0, abs(h_inc))
    print(f"[4] MILP B&B (cli, {model.name}, {time_limit:g}s limit): "
          f"{out['STATUS']} incumbent={inc:g} bound={bound:g} | HiGHS "
          f"{'OPTIMAL' if h_status == 0 else f'status {h_status}'} "
          f"incumbent={h_inc:g} bound={h_bound:g} | nodes={out['NODES']} "
          f"lp_iters={out['ITERATIONS']} wall={wall:.1f}s "
          f"compile={float(out['TIME COMPILE']) / 1e3:.1f}s")
    _check(all(np.any(x[r] > 0.5) for r in model.rows),
           "MILP incumbent is not a cover")
    _check(abs(float(model.costs @ x) - inc) <= tol,
           f"MILP incumbent cost {model.costs @ x} != reported {inc}")
    if out["STATUS"] == "OPTIMAL" and h_status == 0:
        _check(abs(inc - h_inc) <= tol, f"MILP optimum {inc} vs HiGHS {h_inc}")
    else:
        _check(inc >= h_bound - tol, f"MILP incumbent {inc} < HiGHS bound {h_bound}")
        _check(bound <= h_inc + tol, f"MILP bound {bound} > HiGHS incumbent {h_inc}")


def phase_multi_gpu(n: int) -> None:
    from __graft_entry__ import dryrun_multichip

    t0 = time.perf_counter()
    multi = dryrun_multichip(n)
    t_multi = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = dryrun_multichip(1)
    t_single = time.perf_counter() - t0
    for leg, obj in multi.items():
        if leg == "bnb":
            continue
        err = float(np.max(np.abs(obj - single[leg]) / np.maximum(1.0, np.abs(single[leg]))))
        print(f"[mesh] {leg}: {n} GPUs vs 1 GPU max rel {err:.2e} (both match HiGHS)")
        _check(err <= REL_TOL, f"{leg}: {n}-GPU vs 1-GPU objectives differ by {err}")
    (s_n, inc_n, bd_n), (s_1, inc_1, bd_1) = multi["bnb"], single["bnb"]
    print(f"[mesh] B&B: {n} GPUs {s_n} {inc_n:g}/{bd_n:g}, 1 GPU {s_1} "
          f"{inc_1:g}/{bd_1:g} (incumbent/bound; both checked against HiGHS); "
          f"wall {t_multi:.1f}s vs {t_single:.1f}s, compile included")
    if s_n == s_1 == "OPTIMAL":
        _check(inc_n == inc_1, f"B&B optimum {inc_n} on {n} GPUs vs {inc_1} on 1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gpus", type=int, default=1,
                    help="1: phases 0-4; >1: only the multi-GPU mesh path")
    args = ap.parse_args(argv)

    devs = phase_device()
    if args.gpus > 1:
        _check(len(devs) >= args.gpus, f"need {args.gpus} GPUs, have {len(devs)}")
        phase_multi_gpu(args.gpus)
    else:
        with tempfile.TemporaryDirectory(prefix="sypha_smoke_") as workdir:
            phase_single_lp(workdir)
            phase_batched()
            phase_sparse()
            phase_milp(workdir)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
