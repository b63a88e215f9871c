"""Read the numbers that decide ``correct`` in a cell of driver ``job_sr``
over many seeds in one process, for the program, its two controls and the
planted faults, at the cell's own size.

    python3 -m benchmark.calibrate_sr --workload <cell> --seeds 11,12,13 \\
        [--control 11,12,13] [--faults unchanged,half_batch] [--out FILE]

As ``benchmark.calibrate`` reads cells of driver ``job``: for each seed it
sets the cell up, runs the program once (one job), on the seeds of
``--control`` the two controls (the program with ``rounding="nearest"``,
and the reference with its contraction operands at 3 mantissa bits) and
each fault of ``--faults`` on the first three seeds, works the
stochastic-rounding reference out once, and prints one JSON line per
reading: {"cell", "seed", "variant", numbers}. Beside the check's numbers
each line holds the quantiles of the rows' L1 gaps (``row_q50`` ...
``row_max``), the share of rows past a few thresholds (``rows_over_<t>``)
and the least gap of the rows that ``few_rows`` alters (``rows_100_min``,
every hundredth row): what ``row_off`` is set from. The benchmark's own
runs never run this; the limits in the cell's file come from its readings
(``PERF.md``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from .calibrate import _emit, _seeds

#: row thresholds whose shares of rows past them each reading prints
THRESHOLDS = (0.25, 0.5, 0.75, 1.0, 1.25, 1.5)


def _rows(ref, output, device) -> dict:
    """The spread of the rows' L1 gaps to the reference's rows."""
    X = torch.as_tensor(output[0], device=device)
    rows = (X - ref.mapping).abs().sum(dim=1).double()
    q = torch.quantile(rows.cpu(), torch.tensor([0.5, 0.9, 0.99, 0.999], dtype=torch.float64))
    out = {f"row_q{n}": float(v) for n, v in zip((50, 90, 99, 999), q)}
    out["row_max"] = float(rows.max())
    out.update({f"rows_over_{t}": float((rows > t).double().mean()) for t in THRESHOLDS})
    out["rows_100_min"] = float(rows[::100].min())
    return out


def _job(cell, seed, device, control, faults, out):
    from .drivers import job, job_sr
    from .faults import FAULTS

    sr = job_sr.setup(cell, seed, device, "program")
    state = sr.job
    runs = [("program", job._run_program(state))]
    for name in faults:
        with FAULTS[name]():
            runs.append((name, job._run_program(state)))
    if control:
        nearest = dataclasses.replace(state, kwargs=dict(state.kwargs, rounding="nearest"))
        runs.append(("control_nearest", job._run_program(nearest)))
        runs.append(("control_e4m3", job_sr.run_control_e4m3(state)))
    t0 = time.perf_counter()
    ref = job_sr.reference(state)
    for variant, output in runs:
        numbers = job_sr.gaps(ref, output, device, sr.row_off)
        _emit(out, cell.name, seed, variant,
              dict(numbers, **_rows(ref, output, device), reference_s=time.perf_counter() - t0))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate_sr")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from .harness import load_cell

    if not torch.cuda.is_available():
        print("calibrate_sr: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    if cell.workload["driver"] != "job_sr":
        print(f"calibrate_sr: reads cells of the job_sr driver, not {cell.workload['driver']}",
              file=sys.stderr)
        return 2
    control = set(_seeds(args.control))
    faults = [f for f in args.faults.split(",") if f]
    for i, seed in enumerate(_seeds(args.seeds)):
        _job(cell, seed, device, seed in control, faults if i < 3 else [], args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
