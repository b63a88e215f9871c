"""Plain Tangram in bf16 storage with stochastic rounding: the reference
of a job that keeps its training state in bf16.

The same job as :func:`.tangram.run_job` (preprocessing, prior, the numpy
start cast to bf16, every Adam step, the mapping and the training scores),
in plain PyTorch and NumPy, importing nothing of the program. The one
difference in the training: after each step M, mu and nu are stored in
bf16 by **stochastic rounding** (:func:`sr_bf16`): the f32 bit pattern plus
an independent uniform 16-bit integer below the bf16 mantissa, truncated,
so that E[stored] = value. The contraction operands (P and A = S in the
projection, A and dY in the dP tile) are rounded to the nearest bf16, as
``Precision(operands="bfloat16")`` rounds them; every sum accumulates in
f32 with TF32 off.

Departures from the program, by design or by necessity:

* the random bits come from a ``torch.Generator`` seeded with the job's
  ``random_state`` (or ``bits``), drawn for M, mu and nu in turn at each step; the
  program keys its bits by a hash of the step, the cell row and the array.
  The two runs round independently, so they agree in law, not bit for bit;
* sums run in PyTorch's block order, not the kernels' tile order;
* the training scores take the f32 softmax and f32 S, as the program's
  gene report does after training, not the bf16 operands of the steps.

``rounding="nearest"`` stores to the nearest bf16 instead and then
reproduces :func:`.tangram.run_job` in ``Precision("bfloat16",
"bfloat16", "bfloat16")`` bit for bit in the mapping and the losses.
``operands="e4m3"`` rounds every contraction operand (the scores' too) to
3 explicit mantissa bits with f32's exponent range (:func:`e4m3_round`):
FP8 E4M3's precision, a precision below the deployment's, for a control.
"""

from __future__ import annotations

import numpy as np
import torch

from .tangram import (
    BETA1,
    BETA2,
    EPS,
    JobResult,
    Precision,
    Trainer,
    _cosine_columns,
    cluster_aggregate,
    loss,
    numpy_init,
    preprocess,
    softmax_rows,
)

__all__ = ["BF16", "ROUNDINGS", "OPERANDS", "sr_bf16", "e4m3_round", "SrTrainer",
           "gene_scores", "run_job"]

#: the deployment's storage: M, mu and nu in bf16, the operands rounded to bf16
BF16 = Precision("bfloat16", "bfloat16", "bfloat16")
ROUNDINGS = ("stochastic", "nearest")


def sr_bf16(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """f32 → bf16 by stochastic rounding: a uniform 16-bit integer from
    ``generator`` added to each value's f32 bit pattern below the bf16
    mantissa, then the low 16 bits cut off. A value lands on one of its two
    bf16 neighbours with probabilities that make the cast unbiased."""
    i = x.float().contiguous().view(torch.int32)
    bits = torch.randint(0, 1 << 16, i.shape, generator=generator, dtype=torch.int32,
                         device=i.device)
    return ((i + bits) & -0x10000).view(torch.float32).to(torch.bfloat16)


def e4m3_round(x: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest value with 3 explicit mantissa bits (ties to
    even), f32's exponent range kept, held in f32."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 20) & 1
    return ((i + 0x7FFFF + lsb) & -0x100000).view(torch.float32)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


#: the rounding of the contraction operands
OPERANDS = {"bfloat16": _bf16_round, "e4m3": e4m3_round}


class SrTrainer(Trainer):
    """:class:`.tangram.Trainer` in bf16 storage, its stores rounded as
    ``rounding`` says (stochastically with bits from ``generator``) and
    its contraction operands as ``operands`` says."""

    def __init__(self, M, S, G, d, w, lr: float, generator: torch.Generator,
                 rounding: str = "stochastic", operands: str = "bfloat16"):
        if rounding not in ROUNDINGS:
            raise ValueError(f"rounding {rounding!r}; expected one of {ROUNDINGS}")
        super().__init__(M, S, G, d, w, lr, BF16)
        self.rnd = OPERANDS[operands]
        self.rounding = rounding
        self.generator = generator

    def _store(self, x: torch.Tensor) -> torch.Tensor:
        if self.rounding == "nearest":
            return x.to(torch.bfloat16)
        return sr_bf16(x, self.generator)

    def step(self):
        """One Adam step, as :meth:`.tangram.Trainer.step` with M, mu and
        nu stored by :meth:`_store`. Returns (total, main) of the loss
        before the step as floats."""
        Y = torch.zeros(self.G.shape, dtype=self.cdt, device=self.M.device)
        q = torch.zeros(self.G.shape[0], dtype=self.cdt, device=self.M.device)
        blocks = list(self._blocks())
        for b in blocks:
            P = softmax_rows(self.M[b])
            Y += self.rnd(P).T @ self.rnd(self.S[b])
            q += self.w[b] @ P
        with torch.enable_grad():
            Yv, qv = Y.requires_grad_(), q.requires_grad_()
            total, main = loss(Yv, qv, self.G, self.d)
            dY, dq = torch.autograd.grad(total, (Yv, qv))
        dY = self.rnd(dY)
        self.t += 1
        bc1, bc2 = 1.0 - BETA1 ** self.t, 1.0 - BETA2 ** self.t
        for b in blocks:
            P = P if len(blocks) == 1 else softmax_rows(self.M[b])
            dP = (self.rnd(self.S[b]) @ dY.T).addr_(self.w[b], dq)
            g = dP.sub_((P * dP).sum(dim=1, keepdim=True)).mul_(P)
            M, mu, nu = (x[b].to(self.cdt) for x in (self.M, self.mu, self.nu))
            mu.mul_(BETA1).add_(g, alpha=1.0 - BETA1)
            nu.mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
            M.addcdiv_(mu, nu.div(bc2).sqrt_().add_(EPS), value=-self.lr / bc1)
            for store, x in ((self.M, M), (self.mu, mu), (self.nu, nu)):
                store[b] = self._store(x)
        return float(total.detach()), float(main.detach())


def gene_scores(P: torch.Tensor, S: torch.Tensor, G: torch.Tensor, rnd=None) -> np.ndarray:
    """Each gene's training score: the cosine, in float64, between Pᵀ S (an
    f32 product; its operands rounded by ``rnd`` when given) and G."""
    if rnd is not None:
        P, S = rnd(P), rnd(S)
    return _cosine_columns((P.T @ S).double(), G.double()).cpu().numpy()


def run_job(markers, genes_sc, X_sc, labels, genes_sp, X_sp, mode: str, density_prior: str,
            epochs: int, lr: float, random_state: int, device, rounding: str = "stochastic",
            operands: str = "bfloat16", bits: int | None = None) -> JobResult:
    """One whole Tangram mapping, as :func:`.tangram.run_job`, with M, mu
    and nu in bf16 stored by ``rounding`` (the bits of stochastic rounding
    from a generator seeded with ``bits``, by default ``random_state``)
    and the contraction operands rounded as ``operands`` says. The training
    scores take f32 operands, or e4m3 ones for ``operands="e4m3"``."""
    genes, S, G, density = preprocess(markers, genes_sc, X_sc, genes_sp, X_sp)
    if mode == "clusters":
        S, w = cluster_aggregate(S, labels)
    elif mode == "cells":
        w = np.full(S.shape[0], 1.0 / S.shape[0])
    else:
        raise ValueError(f"mode {mode!r}")
    if density_prior == "rna_count_based":
        d = density
    elif density_prior == "uniform":
        d = np.full(G.shape[0], 1.0 / G.shape[0])
    else:
        raise ValueError(f"density_prior {density_prior!r}")

    def dev(x):
        return torch.tensor(np.asarray(x), device=device, dtype=torch.float32)

    generator = torch.Generator(device=device)
    generator.manual_seed(int(random_state if bits is None else bits))
    S_t, G_t = dev(S), dev(G)
    M = dev(numpy_init(S.shape[0], G.shape[0], random_state))
    trainer = SrTrainer(M, S_t, G_t, dev(d), dev(w), lr, generator, rounding, operands)
    total = np.array([trainer.step()[0] for _ in range(int(epochs))])
    P = trainer.mapping()
    scores = gene_scores(P, S_t, G_t, e4m3_round if operands == "e4m3" else None)
    return JobResult(mapping=P, scores=dict(zip(genes, scores)), total_loss=total)
