"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line on standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit); the numbers compared are also the last lines on standard
error. Without a CUDA card, or with fewer than the cell asks for, it exits
with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .harness import ROOT, forbidden_modules, load_cell, measure  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(message: str, code: int = 2) -> int:
    print(f"benchmark: {message}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    args = parse_args(argv)
    # the card's JIT cache inside the checkout, at a fixed path
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark measures the card and does not fall back to the CPU")
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{cell.name} needs {cell.chips} CUDA devices, "
                     f"{torch.cuda.device_count()} are visible")
    outcome = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      T_START)
    found = forbidden_modules()
    if found:
        return _fail(f"modules of JAX or the JAX package were loaded: {found}", 3)
    for line in outcome.notes:
        print(line, file=sys.stderr)
    for name, (value, limit) in outcome.checks.items():
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(outcome.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
