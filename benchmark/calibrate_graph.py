"""Read the numbers that decide ``correct`` in a cell of driver
``job_graph`` over many seeds in one process, for the program, its
control and the planted graph faults, at the cell's own size.

    python3 -m benchmark.calibrate_graph --workload <cell> --seeds 11,12,13 \\
        [--control 11,12] [--faults five_nn,geary_gradient] [--heads 10,20]
        [--whole 0] [--out FILE]

As ``benchmark.calibrate`` reads cells of driver ``job``: for each seed it
sets the cell up, runs the program once (one job), the control on the
seeds of ``--control`` (the graph-term reference with its contraction
operands in TF32, in the program's place) and each fault of ``--faults``
(``benchmark/faults_graph.py``) on the first three seeds, works the
reference out once, and prints one JSON line per reading: {"cell", "seed",
"variant", numbers}: beside the check's numbers the quantiles of the rows'
L1 gaps, the share of rows past a few thresholds, and the worst gap of the
loss and of each graph term in a few windows of epochs. The short jobs'
numbers (``head_gaps``) are read at each of ``--heads`` epochs, named
``h<epochs>_<number>``; ``--whole 0`` reads them alone. The benchmark's
own runs never run this; the limits in the cell's file come from its
readings (``PERF.md``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .calibrate import _emit, _seeds

#: row thresholds whose shares of rows past them each reading prints
THRESHOLDS = (0.02, 0.05, 0.1, 0.25, 0.5, 1.0)


def _rows(ref, output, device) -> dict:
    """The spread of the rows' L1 gaps to the reference's rows: quantiles
    and the share of rows past each of :data:`THRESHOLDS`."""
    rows = (torch.as_tensor(output[0], device=device) - ref.mapping).abs().sum(dim=1).double()
    q = torch.quantile(rows.cpu(), torch.tensor([0.5, 0.9, 0.99, 0.999], dtype=torch.float64))
    out = {f"row_q{n}": float(v) for n, v in zip((50, 90, 99, 999), q)}
    out.update({f"rows_over_{t}": float((rows > t).double().mean()) for t in THRESHOLDS})
    return out


#: epoch windows whose worst loss and term gaps each reading prints
WINDOWS = ((0, 30), (30, 100), (100, 300), (300, 1000))


def _windows(ref, output) -> dict:
    """The worst gap of the loss and of each graph term in each of
    :data:`WINDOWS`, over the whole history's mean |value|."""
    import numpy as np

    from .reference.spatial import GRAPH_KEYS

    out = {}
    pairs = [("loss", output[2], ref.total_loss)]
    pairs += [(k, output[3].get(k), ref.terms[k]) for k in GRAPH_KEYS]
    for name, got, want in pairs:
        if got is None or got.shape != want.shape:
            continue
        gap = np.abs(got - want) / max(float(np.abs(want).mean()), 1e-30)
        for a, b in WINDOWS:
            if a < len(gap):
                out[f"w.{name}.{a}"] = float(gap[a:b].max())
    return out


def _job(cell, seed, device, control, faults, heads, whole, out):
    import contextlib
    import dataclasses

    from .drivers import job_graph
    from .faults_graph import FAULTS

    state = job_graph.setup(cell, seed, device, "program")
    variants = [("program", state, contextlib.nullcontext)]
    variants += [(name, state, FAULTS[name]) for name in faults]
    if control:
        variants.append(("control", dataclasses.replace(
            state, job=dataclasses.replace(state.job, variant="control")), contextlib.nullcontext))
    head_refs = {h: job_graph.reference(job_graph.head(state, h)) for h in heads}
    readings = {}
    for variant, st, planted in variants:
        numbers = readings.setdefault(variant, {})
        with planted():
            for h in heads:
                numbers.update({f"h{h}{k[4:]}": v for k, v in
                                job_graph.head_gaps(st, h, head_refs[h]).items()})
            if whole:
                numbers["output"] = job_graph.run(st)
    del head_refs
    ref = job_graph.reference(state) if whole else None
    for variant, numbers in readings.items():
        output = numbers.pop("output", None)
        if output is not None:
            numbers.update(job_graph.gaps(ref, output, device), **_rows(ref, output, device),
                           **_windows(ref, output))
        _emit(out, cell.name, seed, variant, numbers)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate_graph")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--heads", default="",
                   help="epochs of the check's short jobs to read (default: the driver's)")
    p.add_argument("--whole", type=int, default=1,
                   help="0: read the short jobs alone, not the cell's whole jobs")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from .harness import load_cell

    if not torch.cuda.is_available():
        print("calibrate_graph: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    if cell.workload["driver"] != "job_graph":
        print(f"calibrate_graph: reads cells of the job_graph driver, not "
              f"{cell.workload['driver']}", file=sys.stderr)
        return 2
    control = set(_seeds(args.control))
    faults = [f for f in args.faults.split(",") if f]
    from .drivers.job_graph import HEAD_EPOCHS

    heads = _seeds(args.heads) or [HEAD_EPOCHS]
    for i, seed in enumerate(_seeds(args.seeds)):
        _job(cell, seed, device, seed in control, faults if i < 3 else [], heads,
             bool(args.whole), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
