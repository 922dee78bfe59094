"""Checkpoints of the port: best-model snapshots and the A/B resume slots.

Counterpart of ``vlp3d/train/checkpoint.py`` (the reference's snapshot
taxonomy, solver_3dvlp.py:1137-1245 / train_3dvlp.py:160-171), written
with ``torch.save``:

* :func:`save_params` / :func:`load_params`: a snapshot ``<root>/<name>.pth``
  (``model``, ``ground_model``, ``model_last``, ...) holding the model's
  reference-layout state dict, BatchNorm statistics included, as the
  reference's ``model.state_dict()`` files do, so it loads with
  ``load_state_dict(..., strict=True)``; :func:`load_params_partial` is
  the ``--pretrain`` warm start (strict=False); :func:`load_params_into`
  loads a snapshot into a model that may carry other heads (the
  visualizers' and the validation runbook's ``--model_dir``).
* :func:`save_checkpoint` / :func:`load_checkpoint`: the resume
  checkpoint (model, optimizer, its step count, the epoch and the best
  metrics). Each save goes to the slot that ``checkpoint_meta.json`` does
  not name (``checkpoint_a`` / ``checkpoint_b``), and the meta file flips
  to it only after the slot is on disk, each through a temporary file and
  ``os.replace``: a run killed at any instant leaves the previous meta
  and its slot intact.

Orbax needs JAX, so a JAX checkpoint crosses over only through
:func:`vlp3d_torch.convert.jax_to_torch_state_dict`, run where JAX is,
and :func:`save_params`.
"""

from __future__ import annotations

import json
import os

import torch

META = "checkpoint_meta.json"
SLOT_FILE = "state.pt"


def _cpu(state_dict: dict) -> dict:
    return {k: v.detach().cpu() if torch.is_tensor(v) else v
            for k, v in state_dict.items()}


def _save(obj, path: str) -> None:
    """torch.save through a temporary file and os.replace."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def params_path(root: str, name: str) -> str:
    return os.path.join(os.path.abspath(root), f"{name}.pth")


def save_params(root: str, name: str, state_dict: dict) -> str:
    """Best-model snapshot of a state dict (``model.state_dict()``);
    returns its path."""
    path = params_path(root, name)
    _save(_cpu(state_dict), path)
    return path


def load_params(root: str, name: str) -> dict:
    """The state dict a :func:`save_params` snapshot holds, on the CPU."""
    return _load(params_path(root, name))


def load_params_into(model, root: str, name: str) -> dict:
    """A :func:`save_params` snapshot into ``model`` as far as it goes:
    every entry the model has is taken (a shape that differs raises), the
    model's entries the snapshot lacks (a head it was not trained with)
    keep their values, and the snapshot's entries the model lacks are
    ignored. Returns the counts: ``restored``, ``fresh``, ``ignored``."""
    missing, unexpected = model.load_state_dict(load_params(root, name),
                                                strict=False)
    return {"restored": len(model.state_dict()) - len(missing),
            "fresh": len(missing), "ignored": len(unexpected)}


def load_params_partial(path: str, template: dict):
    """strict=False warm start (train_3dvlp.py:115-121): every entry of
    the snapshot at ``path`` (a ``.pth`` file) whose key is in
    ``template`` (a state dict) with the same shape and dtype replaces the
    template's; every other entry keeps its value. Returns (merged,
    n_restored, n_skipped)."""
    saved = _load(path)
    merged, restored, skipped = {}, 0, 0
    for key, value in template.items():
        got = saved.get(key)
        if (torch.is_tensor(got) and torch.is_tensor(value)
                and got.shape == value.shape and got.dtype == value.dtype):
            merged[key] = got.to(value.device)
            restored += 1
        else:
            merged[key] = value
            skipped += 1
    return merged, restored, skipped


def _floats(tree):
    if isinstance(tree, dict):
        return {k: _floats(v) for k, v in tree.items()}
    return float(tree)


def _live_slot(root: str) -> str:
    """The slot that checkpoint_meta.json names, or "checkpoint"."""
    path = os.path.join(root, META)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f).get("dir", "checkpoint")
    return "checkpoint"


def _write_slot(root: str, slot: str, payload: dict) -> None:
    _save(payload, os.path.join(root, slot, SLOT_FILE))


def _write_meta(root: str, meta: dict) -> None:
    tmp = os.path.join(root, META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(root, META))


def save_checkpoint(root: str, model, optimizer, best: dict,
                    epoch: int) -> str:
    """Resume checkpoint into the slot the meta file does not name, then
    the meta file naming it; returns the slot. ``model`` and ``optimizer``
    are the objects or their state dicts (a tensor-parallel or ZeRO-1
    state dict is a collective, so the trainer takes it on every rank and
    rank 0 passes it here)."""
    target = ("checkpoint_b" if _live_slot(root) == "checkpoint_a"
              else "checkpoint_a")
    if not isinstance(model, dict):
        model = model.state_dict()
    if optimizer is not None and not isinstance(optimizer, dict):
        optimizer = optimizer.state_dict()
    payload = {"model": _cpu(model), "optimizer": optimizer}
    _write_slot(root, target, payload)
    _write_meta(root, {"epoch": epoch, "best": _floats(best),
                       "dir": target})
    return target


def load_checkpoint(root: str, model, optimizer=None) -> dict:
    """Restore the checkpoint that the meta file names into ``model``
    (strictly) and ``optimizer``; returns the meta dict (epoch, best,
    dir)."""
    with open(os.path.join(root, META)) as f:
        meta = json.load(f)
    payload = _load(os.path.join(root, meta.get("dir", "checkpoint"),
                                 SLOT_FILE))
    model.load_state_dict(payload["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    return meta
