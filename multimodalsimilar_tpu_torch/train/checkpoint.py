"""Checkpoints of the training state (counterpart of
multimodalsimilar_tpu/train/checkpoint.py).

A checkpoint is one ``torch.save`` file per step, ``step_{step:09d}.pt``,
holding the Trainer's state: ``{step, model, optimizer, schedulers,
margin}`` (state dicts and plain numbers). The file is written under a
temporary name and renamed, so a reader never sees half a checkpoint;
the oldest files beyond ``max_to_keep`` are deleted.

The async contract is the JAX package's:

* ``save()`` blocks only for the copy of the state to the host — the
  optimizer updates the parameters in place, so the copy must be taken
  before the next step;
* with ``async_save=True`` the write runs on a thread, and ``wait()``
  (which ``save``, ``restore`` and ``clear`` call first) joins it and
  re-raises a failed write;
* a step counts as saved only after its write succeeded, so a retry of
  the same step after a failure does write; ``force=True`` rewrites a
  step that was already saved (the end-of-fit save after the epoch-end
  margin update).

A checkpoint is always in the one-card layout. A run that cuts
parameters over the mesh's model axis (class-sharded ArcFace heads under
``--model_parallel``, the tower's blocks under ``--tensor_parallel``)
gathers each of them, along the dimension it was cut on, with its
optimizer moments and its gradient so far before rank 0 writes
(``gather_shards``), and cuts them to each rank's block again on resume
(``shard_state``): such a checkpoint serves, embeds and exports on one
card unchanged, as an orbax global array does in JAX.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, List, Optional

import torch

from multimodalsimilar_tpu_torch.parallel.mesh import MODEL_AXIS

_NAME = re.compile(r"^step_(\d+)\.pt$")


def to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to host memory (copied
    even when it is already there, so later in-place updates cannot reach
    it)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        os.makedirs(self.directory, exist_ok=True)
        self._last_saved = -1
        self._inflight: Optional[threading.Thread] = None
        self._bg_error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        """Block until any in-flight async save is on disk; re-raise the
        error of a failed one."""
        t, self._inflight = self._inflight, None
        if t is not None:
            t.join()
        err, self._bg_error = self._bg_error, None
        if err is not None:
            raise err

    def _write(self, step: int, host_state: Any) -> None:
        path = self._path(step)
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save(host_state, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))
        self._last_saved = step

    def save(self, step: int, state: Any, force: bool = False):
        self.wait()          # one write at a time; surfaces a failed one
        if step == self._last_saved and not force:
            return
        host_state = to_host(state)
        if not self.async_save:
            self._write(step, host_state)
            return

        def run():
            try:
                self._write(step, host_state)
            except BaseException as e:   # surfaced on the next wait()
                self._bg_error = e

        t = threading.Thread(target=run, daemon=True, name="ckpt-save")
        t.start()
        self._inflight = t

    def clear(self):
        """Delete every stored step (the Trainer's ``overwrite=True``)."""
        self.wait()
        for s in self.all_steps():
            os.unlink(self._path(s))
        self._last_saved = -1

    def restore(self, step: Optional[int] = None) -> Optional[Any]:
        """The state saved at ``step`` (default: the latest), on the host;
        None when there is none."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)


def _sharded_entries(state: dict, shards: dict, optimizer):
    """(section, key, parameter name) of every tensor of ``state`` that
    holds a sharded parameter's block: its weight, its gradient so far
    and its optimizer moments (torch numbers a parameter by its position
    over the optimizer's groups)."""
    position = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    out = []
    for name, (param, _, _) in shards.items():
        out.append(("model", name, name))
        if name in state.get("accum_grads", {}):
            out.append(("accum_grads", name, name))
        moments = state["optimizer"]["state"].get(position[id(param)], {})
        out += [(("optimizer", position[id(param)]), k, name)
                for k, v in moments.items()
                if torch.is_tensor(v) and v.dim() == param.dim()]
    return out


def _section(state: dict, where):
    if isinstance(where, tuple):
        return state[where[0]]["state"][where[1]]
    return state[where]


def _rebuilt(state: dict) -> dict:
    """``state`` with fresh dicts down to the tensors (the tensors shared),
    so the caller's state dicts are never edited."""
    out = dict(state)
    out["model"] = dict(state["model"])
    out["accum_grads"] = dict(state.get("accum_grads", {}))
    opt = dict(state["optimizer"])
    opt["state"] = {k: dict(v) for k, v in opt["state"].items()}
    out["optimizer"] = opt
    return out


def gather_shard(t: torch.Tensor, shard, mesh) -> torch.Tensor:
    """A tensor of ``shard``'s layout (the parameter, its gradient or a
    moment) gathered over the model group along the cut dimension."""
    return mesh.all_gather_dim(t, shard.dim, MODEL_AXIS)


def gather_shards(state: dict, shards: dict, optimizer, mesh) -> dict:
    """``state`` (the Trainer's, with ``shards``: name -> ``Shard`` of
    each parameter cut over the model group) in the one-card layout: each
    sharded tensor all-gathered over the model group along its cut
    dimension. Every rank calls it."""
    out = _rebuilt(state)
    for where, key, name in _sharded_entries(out, shards, optimizer):
        sec = _section(out, where)
        sec[key] = gather_shard(sec[key], shards[name], mesh)
    return out


def shard_state(state: dict, shards: dict, optimizer, mesh) -> dict:
    """A one-card ``state`` cut to this rank's block of each sharded
    parameter: the mesh shape must be the one the Trainer shards for."""
    out = _rebuilt(state)
    for where, key, name in _sharded_entries(out, shards, optimizer):
        sec = _section(out, where)
        _, dim, full = shards[name]
        if sec[key].shape[dim] != full:
            raise ValueError(f"{name}: the checkpoint holds "
                             f"{sec[key].shape[dim]} rows along dim {dim}, "
                             f"the model {full}")
        size = full // mesh.model
        sec[key] = sec[key].narrow(dim, mesh.model_index * size,
                                   size).clone()
    return out
