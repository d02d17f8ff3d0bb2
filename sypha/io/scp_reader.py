"""SCP instance reader (OR-Library / sypha text format).

Format (reference src/model_reader.cpp:90-174 and benchmark/scp_parser.py):
  token 1, 2: nrows ncols
  next ncols tokens: column costs
  then per row: a count k followed by k 1-based column indices.
Tokens may be split across lines arbitrarily; we parse a flat token stream.
"""

from __future__ import annotations

import os

import numpy as np

from sypha.core.problem import ScpModel


def parse_scp_text(text: str, name: str = "") -> ScpModel:
    it = iter(text.split())

    def tok() -> str:
        try:
            return next(it)
        except StopIteration:
            raise ValueError(f"SCP parse error in '{name}': unexpected end of file")

    nrows = int(tok())
    ncols = int(tok())
    if nrows <= 0 or ncols <= 0:
        raise ValueError(f"SCP parse error in '{name}': bad dimensions {nrows}x{ncols}")

    costs = np.empty(ncols, dtype=np.float64)
    for j in range(ncols):
        costs[j] = float(tok())

    rows = []
    for i in range(nrows):
        k = int(tok())
        idx = np.empty(k, dtype=np.int32)
        for t in range(k):
            v = int(tok()) - 1  # on-disk indices are 1-based
            if not 0 <= v < ncols:
                raise ValueError(
                    f"SCP parse error in '{name}': row {i} column index {v + 1} "
                    f"out of range 1..{ncols}"
                )
            idx[t] = v
        rows.append(np.unique(idx))  # dedupe + sort; duplicates would double coefficients

    return ScpModel(nrows=nrows, ncols=ncols, costs=costs, rows=rows, name=name)


def read_scp_file(path: str) -> ScpModel:
    name = os.path.splitext(os.path.basename(path))[0]

    # native C++ reader (csrc/sypha_host.cpp, the counterpart of reference
    # src/model_reader.cpp); falls back to the Python tokenizer
    from sypha import native

    parsed = native.read_scp_file_native(path)
    if parsed is not None:
        costs, row_ptr, row_idx, nrows, ncols = parsed
        rows = [
            np.unique(row_idx[row_ptr[i] : row_ptr[i + 1]])
            for i in range(nrows)
        ]
        return ScpModel(nrows=nrows, ncols=ncols, costs=costs, rows=rows, name=name)

    with open(path, "r") as f:
        text = f.read()
    return parse_scp_text(text, name=name)
