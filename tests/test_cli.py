"""CLI: flag parity with the reference table and end-to-end solve output."""

import subprocess
import sys

import pytest

from sypha.cli import build_parser, config_from_args

REFERENCE_FLAGS = [
    # src/sypha_environment.cpp:111-149 (sans --help, added by argparse)
    "--unit-tests", "--unit-tests-rep", "--input-file", "--model", "--sparse",
    "--time-limit", "--seed", "--thread", "--tol", "--verbosity", "--debug",
    "--show-solution", "--mehrotra-max-iter", "--dense-memory-threshold",
    "--linear-solver", "--krylov-max-cg-iter", "--krylov-cg-tol-initial",
    "--krylov-cg-tol-final", "--krylov-cg-tol-decay", "--disable-bnb",
    "--bnb-auto-fallback-lp", "--bnb-max-nodes", "--bnb-device-queue",
    "--bnb-gap-stall-iters", "--bnb-gap-stall-pct", "--bnb-int-tol",
    "--bnb-var-select", "--bnb-int-heur-every", "--bnb-int-heuristics",
    "--bnb-log-interval-sec", "--bnb-hard-time-limit-sec",
    "--bnb-gap-stagnation-window", "--bnb-cuts", "--bnb-cut-rounds-root",
    "--bnb-max-cuts-per-round", "--preprocess-columns",
    "--preprocess-time-limit-sec",
]


def test_every_reference_flag_exists():
    parser = build_parser()
    known = set()
    for action in parser._actions:
        known.update(action.option_strings)
    missing = [f for f in REFERENCE_FLAGS if f not in known]
    assert not missing, f"missing reference flags: {missing}"


def test_defaults_match_reference():
    """Defaults from src/sypha_environment_defaults.h."""
    args = build_parser().parse_args([])
    cfg = config_from_args(args)
    assert cfg.bnb.max_nodes == 100000
    assert cfg.bnb.gap_stall_branch_iters == 5
    assert cfg.bnb.gap_stall_min_improv_pct == 1.0
    assert cfg.bnb.integrality_tol == 1e-6
    assert cfg.bnb.heuristic_every_n_nodes == 1
    assert cfg.bnb.log_interval_sec == 5.0
    assert cfg.bnb.gap_stagnation_window == 50
    assert cfg.bnb.cuts_enabled is True
    assert cfg.bnb.cut_rounds_root == 5
    assert cfg.bnb.max_cuts_per_round == 50
    assert cfg.bnb.var_selection == "most_fractional"
    assert cfg.bnb.int_heuristics == "nearest_integer_fixing,dual_guided_cover_repair"
    assert cfg.cg.max_cg_iter == 500
    assert cfg.cg.tol_initial == 1e-2
    assert cfg.cg.tol_final == 1e-8
    assert cfg.cg.tol_decay_rate == 0.5
    assert cfg.preprocess_time_limit_sec == 5.0
    assert cfg.preprocess_column_strategies == (
        "single_column_dominance,two_column_dominance"
    )
    assert cfg.linear_solver == "auto"


def test_cli_lp_solve_end_to_end(tmp_path, data_dir):
    """Run the CLI in-process on a tiny instance (LP-only) and check the
    grep-compatible output lines the reference harness expects."""
    import io
    from contextlib import redirect_stdout

    from sypha.cli import main

    tiny = tmp_path / "tiny.txt"
    tiny.write_text("3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(
            [
                "--model", "SCP",
                "--input-file", str(tiny),
                "--disable-bnb",
                "--verbosity", "1",
            ]
        )
    out = buf.getvalue()
    assert rc == 0
    primal = [l for l in out.splitlines() if l.startswith("PRIMAL:")]
    dual = [l for l in out.splitlines() if l.startswith("DUAL:")]
    assert primal and dual
    assert abs(float(primal[0].split(":")[1]) - 4.5) < 1e-6  # LP relax of tiny
    assert abs(float(dual[0].split(":")[1]) - 4.5) < 1e-6
    assert any(l.startswith("ITERATIONS:") for l in out.splitlines())


def test_cli_milp_solve_end_to_end(tmp_path):
    import io
    from contextlib import redirect_stdout

    from sypha.cli import main

    tiny = tmp_path / "tiny.txt"
    tiny.write_text("3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(
            [
                "--model", "SCP",
                "--input-file", str(tiny),
                "--verbosity", "0",
                "--show-solution",
            ]
        )
    out = buf.getvalue()
    assert rc == 0
    primal = [l for l in out.splitlines() if l.startswith("PRIMAL:")][0]
    assert abs(float(primal.split(":")[1]) - 5.0) < 1e-9
    assert any(l.startswith("SELECTED COLUMNS") for l in out.splitlines())


def test_cli_missing_input_file():
    from sypha.cli import main

    assert main(["--model", "SCP"]) == -1
