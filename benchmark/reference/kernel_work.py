"""The work of each kernel role of the Adam step, fixed by a cell's shapes
and storage, for per-kernel roofline shares.

A role is what one launch of the program's step must do, whatever kernels
carry it out: ``project`` forms Y = Pᵀ[A | w] from the logits M; ``rbar``
forms the dP tile [A | w][dY | dq]ᵀ and reduces P ⊙ dP per cell; ``dm_adam``
forms the dP tile again and updates M and Adam's two moments. The names are
the program's launch counters (``.bf16`` on bf16 storage).

Bytes: the (cells × spots) arrays each role must move: ``project`` and
``rbar`` read M, ``dm_adam`` reads and writes M, mu and nu. The operands A,
w, dY, dq and the outputs (under 1% of M at the benchmark's shapes) are
left out, so a bound is never above what the role must move.

Operations: each role forms one contraction of 2·c·s·(k + 1) flops, priced
per pipe as :mod:`.work` prices the step's two: with f32 operands at the
f32 contraction peak, with bf16 operands the A·dY part at the bf16
tensor-core peak and the rank-one w part (2·c·s) on the f32 FMA pipes.

A role's bound is the larger of its bytes at the HBM peak and its slowest
pipe at that pipe's peak (:data:`.work.PEAKS`).
"""

from __future__ import annotations

from dataclasses import dataclass

from .work import BYTES_PER, PEAKS, PIPE_PEAK

__all__ = ["ROLES", "RoleWork", "role_work", "launch_key"]

ROLES = ("project", "rbar", "dm_adam")


@dataclass(frozen=True)
class RoleWork:
    bytes: int
    flops: dict  # pipe -> flops of one launch on it
    seconds_bytes: float  # bytes at the HBM peak
    seconds_flops: float  # the slowest pipe at its peak

    @property
    def seconds(self) -> float:
        """The role's roofline time: the larger of its two bounds."""
        return max(self.seconds_bytes, self.seconds_flops)


def _stored(role: str, param: str, moments: str, operands: str) -> list:
    """The storage types that decide whether a launch of ``role`` counts
    as bf16 in the program's counters: M, and A for ``project``, mu and nu
    for ``dm_adam``."""
    return {"project": [param, operands], "rbar": [param],
            "dm_adam": [param, moments]}[role]


def launch_key(role: str, param: str = "float32", moments: str = "float32",
               operands: str = "float32") -> str:
    """The program's counter of ``role`` in this storage: ``role``, or
    ``role.bf16`` when any storage it counts by is bf16."""
    bf16 = "bfloat16" in _stored(role, param, moments, operands)
    return f"{role}.bf16" if bf16 else role


def role_work(role: str, cells: int, spots: int, genes: int, param: str = "float32",
              moments: str = "float32", operands: str = "float32") -> RoleWork:
    """One launch of ``role`` on a (cells × spots) mapping over ``genes``
    genes, M stored in ``param``, mu and nu in ``moments``, A and dY in
    ``operands``."""
    if role not in ROLES:
        raise ValueError(f"unknown role {role!r}; expected one of {ROLES}")
    c, s, k = int(cells), int(spots), int(genes)
    cs = c * s
    e_m, e_mom, e_op = BYTES_PER[param], BYTES_PER[moments], BYTES_PER[operands]
    nbytes = 2 * cs * (e_m + 2 * e_mom) if role == "dm_adam" else cs * e_m
    if e_op == 4:
        flops = {"f32_contraction": 2 * cs * (k + 1)}
    else:
        flops = {"bf16_tensor": 2 * cs * k, "f32_fma": 2 * cs}
    t_flops = max(n / PIPE_PEAK[pipe] for pipe, n in flops.items())
    return RoleWork(bytes=nbytes, flops=flops,
                    seconds_bytes=nbytes / PEAKS["hbm_bytes_per_s"], seconds_flops=t_flops)
