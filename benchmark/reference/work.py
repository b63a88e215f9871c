"""The work of one optimizer step, fixed by a cell's shapes and storage,
and the card's published peaks.

The arithmetic follows ``chip_smoke.py::kernel_work`` / ``bound_ms`` as of
the commit that added this benchmark, with one change of unit: it counts
the **step's** work (what any implementation of one Adam step of the
mapping must read, write and multiply), not the work of the kernels that
implement it today, so that a change that fuses or splits kernels leaves
the denominator as it was.

Bytes: each input of the step read once and each output written once: the
logits M and Adam's two moments read and written, the contraction operand
A = S (cells × genes) in the operand storage, the cell weights w, the
spatial expression G (spots × genes, f32) and the density d.

Operations: the two contractions of a step, the forward projection
Pᵀ[A | w] and the dP tile [A | w][dY | dq]ᵀ, 2·c·s·(k + 1) flops each.
With f32 operands the whole product runs at the f32 contraction peak (the
faster of the FMA pipes and three TF32 passes on the tensor cores, which
keep f32 accuracy). With bf16 operands the A·dY part runs at the bf16
tensor-core peak and the rank-one w parts (4·c·s) on the f32 FMA pipes.
Pipes run side by side, so the least time of the operations is the largest
of their times per pipe.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["PEAKS", "BYTES_PER", "StepWork", "step_work"]

#: NVIDIA's published H100 SXM figures (dense, at the full 700 W power
#: limit): HBM bytes/s and flop/s per pipe
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_fma_flops": 67e12,
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
}
#: an f32 contraction at f32 accuracy: the faster of the FMA pipes and
#: three TF32 tensor-core passes
F32_CONTRACTION_FLOPS = max(PEAKS["f32_fma_flops"], PEAKS["tf32_flops"] / 3)

BYTES_PER = {"float32": 4, "bfloat16": 2}


@dataclass(frozen=True)
class StepWork:
    bytes: int
    flops: dict  # pipe -> flops of one step on it
    seconds_bytes: float  # bytes at the HBM peak
    seconds_flops: float  # the slowest pipe at its peak

    @property
    def seconds(self) -> float:
        """The step's roofline time: the larger of its two bounds."""
        return max(self.seconds_bytes, self.seconds_flops)


PIPE_PEAK = {"f32_contraction": F32_CONTRACTION_FLOPS, "bf16_tensor": PEAKS["bf16_flops"],
             "f32_fma": PEAKS["f32_fma_flops"]}


def step_work(cells: int, spots: int, genes: int, param: str = "float32",
              moments: str = "float32", operands: str = "float32") -> StepWork:
    """One Adam step of a (cells × spots) mapping over ``genes`` genes, M
    stored in ``param``, mu and nu in ``moments``, A and dY in
    ``operands``."""
    c, s, k = int(cells), int(spots), int(genes)
    e_m, e_mom, e_op = BYTES_PER[param], BYTES_PER[moments], BYTES_PER[operands]
    cs = c * s
    nbytes = 2 * cs * (e_m + 2 * e_mom) + c * k * e_op + 4 * c + 4 * s * k + 4 * s
    if e_op == 4:
        flops = {"f32_contraction": 4 * cs * (k + 1)}
    else:
        flops = {"bf16_tensor": 4 * cs * k, "f32_fma": 4 * cs}
    t_flops = max(n / PIPE_PEAK[pipe] for pipe, n in flops.items())
    return StepWork(bytes=nbytes, flops=flops,
                    seconds_bytes=nbytes / PEAKS["hbm_bytes_per_s"], seconds_flops=t_flops)
