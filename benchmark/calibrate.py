"""Read the numbers that decide ``correct`` over many seeds in one process,
for the program, the control and the planted faults, at a cell's own size.

    python3 -m benchmark.calibrate --workload <cell> --seeds 11,12,13 \\
        [--control 11,12,13] [--faults half_batch,answer] [--out FILE]

For each seed it sets the cell up, runs the program once (one job), the
controls on the seeds of ``--control`` (the reference with its
contractions in TF32 in place of a job, and the program on its own bf16
path) and each fault of ``--faults`` on the first three seeds, works the
reference out once in the configuration's storage, and prints one JSON
line per reading: {"cell", "seed", "variant",
numbers}. The benchmark's own runs never run this; the limits in each
cell's file come from its readings (``PERF.md``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def _emit(out, cell, seed, variant, numbers):
    line = json.dumps({"cell": cell, "seed": seed, "variant": variant, **numbers})
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def _job(cell, seed, device, control, faults, out):
    from .drivers import job
    from .faults import FAULTS

    state = job.setup(cell, seed, device, "program")
    runs = [("program", job._run_program(state))]
    for name in faults:
        with FAULTS[name]():
            runs.append((name, job._run_program(state)))
    if control:
        runs.append(("control", job._run_control(state)))
        bf16 = job.setup(cell, seed, device, "control_bf16")
        runs.append(("control_bf16", job._run_program(bf16)))
    t0 = time.perf_counter()
    ref = job._reference(state, state.reference)
    for variant, output in runs:
        _emit(out, cell.name, seed, variant,
              dict(job._gaps(ref, output, device), reference_s=time.perf_counter() - t0))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    from .harness import load_cell

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    control = set(_seeds(args.control))
    faults = [f for f in args.faults.split(",") if f]
    if cell.workload["driver"] != "job":
        print(f"calibrate: reads cells of the job driver, not {cell.workload['driver']}",
              file=sys.stderr)
        return 2
    for i, seed in enumerate(_seeds(args.seeds)):
        _job(cell, seed, device, seed in control, faults if i < 3 else [], args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
