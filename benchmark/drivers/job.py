"""Driver ``job``: whole mappings through the public entry, back to back.

Set-up makes the cell's single-cell / spatial pair from the seed
(``generators.tutorial_pair``: sparse counts as wide as the configuration
says), wraps it in the program's AnnData, runs ``pp_adatas`` on the
configuration's marker genes and warms up with a few epochs of the same
call, its start drawn on the card (so set-up does not pay the host's init
draw). The window calls
``map_cells_to_space`` with the cell's arguments, one caller in a closed
loop, until ``seconds`` have passed, and lets the job in progress finish:
``job_s`` is the time from the first job's start to the last job's end
over the jobs completed. Every job has the same inputs; each one's mapping,
training scores and loss history are kept and held to one run of the
plain reference after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import pandas as pd
import scipy.sparse
import torch

from ..harness import Window
from ..reference import generators
from ..reference.tangram import Precision, run_job

__all__ = ["setup", "window", "check", "random_state_of", "ROW_OFF"]

#: a row of the mapping is off when its L1 gap to the reference's row
#: passes this: several times the widest gap of a sound run's rows (PERF.md)
ROW_OFF = 0.05

#: the second control: the program's own bf16 storage (logits, moments and
#: the contractions' operands), stochastically rounded
BF16_STORAGE = dict(param_dtype="bfloat16", moment_dtype="bfloat16",
                    compute_dtype="bfloat16", rounding="stochastic")


def random_state_of(seed: int) -> int:
    """The job's ``random_state``: a nonzero seed numpy accepts (a zero
    one would leave numpy's stream unseeded)."""
    return 1 + int(seed) % (2**32 - 1)


@dataclass
class State:
    pair: generators.TutorialPair
    labels: pd.Categorical
    ad_sc: object
    ad_sp: object
    kwargs: dict
    device: torch.device
    variant: str
    reference: Precision  # the configuration's storage
    outputs: list = field(default_factory=list)


def _pair(cell, seed, device):
    cfg = cell.config
    return generators.tutorial_pair(
        cfg["cells"], cfg["spots"], cfg["genes_sc"], cfg["genes_sp"], cfg["markers"],
        cfg["genes"], cfg["types"], int(seed), cfg["sc_detected"], cfg["sp_detected"],
        device=device)


def _csr(X: generators.Csr):
    return scipy.sparse.csr_matrix((X.data, X.indices, X.indptr), shape=X.shape)


def setup(cell, seed, device, variant="program"):
    import tangram_tpu_torch as tgt

    cfg, call = cell.config, cell.workload["call"]
    pair = _pair(cell, seed, device)
    labels = pd.Categorical([pair.types[t] for t in pair.labels])
    ad_sc = tgt.AnnData(X=_csr(pair.X_sc), obs=pd.DataFrame(
        {"subclass_label": labels}, index=[f"cell{i}" for i in range(len(labels))]),
        var=pd.DataFrame(index=pair.genes_sc))
    ad_sp = tgt.AnnData(X=_csr(pair.X_sp), obs=pd.DataFrame(
        index=[f"voxel{i}" for i in range(pair.X_sp.shape[0])]),
        var=pd.DataFrame(index=pair.genes_sp))
    ad_sp.obsm["spatial"] = pair.coords
    tgt.pp_adatas(ad_sc, ad_sp, genes=pair.markers)
    kwargs = dict(call, density_prior=cfg["density_prior"], num_epochs=cfg["num_epochs"],
                  learning_rate=cfg["learning_rate"], random_state=random_state_of(seed))
    if device.type == "cpu":
        # the fused loop on the kernels' plain twins
        kwargs.update(device="cpu", impl="fused")
    if variant == "control_bf16":
        kwargs.update(BF16_STORAGE)
    state = State(pair=pair, labels=labels, ad_sc=ad_sc, ad_sp=ad_sp, kwargs=kwargs,
                  device=device, variant=variant, reference=Precision(**cfg["storage"]))
    if variant != "control":
        warm = dict(kwargs, num_epochs=cell.workload["warmup_epochs"], init_method="jax")
        with contextlib.redirect_stdout(sys.stderr):
            tgt.map_cells_to_space(ad_sc, ad_sp, **warm)
    return state


def _run_program(state):
    import tangram_tpu_torch as tgt

    ad_map = tgt.map_cells_to_space(state.ad_sc, state.ad_sp, **state.kwargs)
    scores = ad_map.uns["train_genes_df"]["train_score"]
    return (np.asarray(ad_map.X, dtype=np.float32), dict(zip(scores.index, scores.to_numpy())),
            np.asarray(ad_map.uns["training_history"]["total_loss"], dtype=np.float64))


def _reference(state, precision):
    kw = state.kwargs
    p = state.pair
    return run_job(p.markers, p.genes_sc, p.X_sc, state.labels, p.genes_sp, p.X_sp, kw["mode"],
                   kw["density_prior"], kw["num_epochs"], kw["learning_rate"],
                   kw["random_state"], state.device, precision)


def _run_control(state):
    """The control: the reference in the configuration's storage with its
    f32 contractions in TF32."""
    out = _reference(state, dataclasses.replace(state.reference, operands="tf32"))
    return out.mapping.cpu().numpy(), out.scores, out.total_loss


def window(state, seconds, spans):
    run = _run_control if state.variant == "control" else _run_program
    start = time.perf_counter_ns()
    deadline = start + int(seconds * 1e9)
    with contextlib.redirect_stdout(sys.stderr):
        while True:
            with spans("job"):
                state.outputs.append(run(state))
            end = time.perf_counter_ns()
            if end >= deadline:
                break
    n = len(state.outputs)
    return Window(start_ns=start, end_ns=end, values={"job_s": (end - start) / 1e9 / n},
                  epochs=n * state.kwargs["num_epochs"], attempted=n, jobs=n)


def _gaps(ref, output, device):
    """The numbers of one job's output against the reference: the cell's
    ``limits`` name those compared; the others are printed beside them."""
    X, scores, total = output
    # over the history's mean size: a loss that passes through 0 would
    # make a gap relative to its own step's value unbounded
    rel = np.abs(total - ref.total_loss) / np.abs(ref.total_loss).mean()
    rows = (torch.as_tensor(X, device=device) - ref.mapping).abs().sum(dim=1)
    genes = list(ref.scores)
    return {
        "map_row_l1_median": float(rows.median()),
        "map_row_l1_mean": float(rows.mean()),
        "map_row_l1_max": float(rows.max()),
        "map_rows_off": float((rows > ROW_OFF).double().mean()),
        "loss_first3": float(rel[:3].max()),
        "loss_max": float(rel.max()),
        "score_max": float(max(abs(scores[g] - ref.scores[g]) for g in genes))
        if set(scores) == set(genes) else float("inf"),
    }


def check(state, window):
    t0 = time.perf_counter()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = _reference(state, state.reference)
    numbers = {}
    for output in state.outputs:
        for k, v in _gaps(ref, output, state.device).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    numbers["reference_s"] = time.perf_counter() - t0
    return numbers
