"""Checkpoint / resume for mapping runs.

Counterpart of ``tangram_tpu/checkpoint.py`` on ``torch.save`` /
``torch.load`` in place of Orbax. :func:`train_checkpointed` trains in
chunks with the optimizer state carried across and persists
``(params, opt_state, epoch, history)`` after each chunk as
``<dir>/ckpt_<epoch>``; :func:`restore` resumes from the latest one with the
same Adam moments and step count (the bias correction and the stochastic
rounding keys depend on the step), so a resumed run repeats an unbroken one
bit for bit.

A checkpoint holds tensors, Python numbers, tuples, lists and dicts only,
and is read with ``torch.load(weights_only=True)``: the history is stored
as tensors, not numpy arrays, which that loader refuses.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .models.mapper import _lr_slice, fit_mapping
from .ops.core import unported
from .ops.schedules import resolve_lr

__all__ = ["save", "restore", "latest_epoch", "train_checkpointed"]


def _tree_map(fn, tree):
    """``fn`` applied to every tensor of a nest of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def save(directory, epoch: int, params, opt_state, history=None) -> None:
    """Persist one checkpoint at ``directory/ckpt_<epoch>``, written to a
    temporary name first and renamed, so that a run killed mid-write leaves
    the previous checkpoint as the latest."""
    directory = os.path.abspath(os.fspath(directory))
    os.makedirs(directory, exist_ok=True)
    payload = {"epoch": int(epoch), "params": params, "opt_state": opt_state}
    if history is not None:
        payload["history"] = {k: torch.as_tensor(np.asarray(v)) for k, v in history.items()}
    path = os.path.join(directory, f"ckpt_{epoch}")
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


def latest_epoch(directory) -> Optional[int]:
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return None
    epochs = [
        int(name.split("_", 1)[1])
        for name in os.listdir(directory)
        if name.startswith("ckpt_") and name.split("_", 1)[1].isdigit()
    ]
    return max(epochs) if epochs else None


def restore(directory, epoch: Optional[int] = None, opt_state_template=None):
    """Load ``(epoch, params, opt_state, history)`` from a checkpoint dir
    (the latest checkpoint when ``epoch`` is None; ``FileNotFoundError``
    when there is none). ``torch.save`` keeps the optimizer state's tuple
    structure; ``opt_state_template``, when given, places each of its
    tensors on the device of the template's tensor in the same position.
    ``history`` maps each key to a numpy array, or is None."""
    if epoch is None:
        epoch = latest_epoch(directory)
        if epoch is None:
            raise FileNotFoundError(f"No checkpoints under {directory!r}")
    path = os.path.join(os.path.abspath(os.fspath(directory)), f"ckpt_{epoch}")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    opt_state = payload["opt_state"]
    if opt_state_template is not None:
        devices = []
        _tree_map(lambda t: devices.append(t.device), opt_state_template)
        it = iter(devices)
        opt_state = _tree_map(lambda t: t.to(next(it)), opt_state)
    history = payload.get("history")
    if history is not None:
        history = {k: v.numpy() for k, v in history.items()}
    return payload["epoch"], payload["params"], opt_state, history


def train_checkpointed(
    params,
    data,
    lw,
    num_epochs: int,
    learning_rate,
    checkpoint_dir,
    checkpoint_every: int = 100,
    constrained: bool = False,
    impl: str = "auto",
    resume: bool = True,
    mesh=None,
):
    """Train with Adam and a checkpoint every ``checkpoint_every`` epochs;
    resume from the latest one in ``checkpoint_dir``.

    ``params`` is M, or ``(M, F)`` with ``constrained``, on the device to
    train on; a restored checkpoint is moved there. ``learning_rate`` is a
    constant or a per-epoch schedule (vector or callable,
    ``ops/schedules.py``); a resumed run continues the schedule from the
    restored epoch. Like ``fit_mapping``, training updates ``params`` in
    place. Returns ``(params, history)``: history (numpy arrays per key)
    covers the epochs run in this call plus any restored prefix.
    """
    if mesh is not None:
        raise unported("mesh", "queue A11 (multi-GPU)")
    num_epochs = int(num_epochs)
    learning_rate = resolve_lr(learning_rate, num_epochs)
    device = (params[0] if constrained else params).device

    start_epoch = 0
    opt_state = None
    histories = []
    if resume and latest_epoch(checkpoint_dir) is not None:
        start_epoch, params, opt_state, prefix = restore(checkpoint_dir)
        params, opt_state = _tree_map(lambda t: t.to(device), (params, opt_state))
        if prefix is not None:
            histories.append(prefix)

    def merged_history():
        return {k: np.concatenate([np.atleast_1d(h[k]) for h in histories if k in h])
                for k in (histories[-1] if histories else {})}

    epoch = start_epoch
    while epoch < num_epochs:
        chunk = min(int(checkpoint_every), num_epochs - epoch)
        params, opt_state, history = fit_mapping(
            params, data, lw, num_epochs=chunk,
            learning_rate=_lr_slice(learning_rate, epoch, epoch + chunk),
            constrained=constrained, impl=impl, opt_state=opt_state,
            return_opt_state=True,
        )
        histories.append({k: v.cpu().numpy() for k, v in history.items()})
        epoch += chunk
        # the CUMULATIVE history, so that a resumed run returns the record
        # from epoch 0, not only its own chunks
        save(checkpoint_dir, epoch, params, opt_state, merged_history())

    return params, merged_history()
