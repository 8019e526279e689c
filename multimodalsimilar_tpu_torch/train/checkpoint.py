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
card unchanged, as an orbax global array does in JAX. Under pipeline
parallelism each rank holds its stage's layers (``parallel/pp.py``): the
layers of every stage, their optimizer moments and their gradients so
far are gathered by name before rank 0 writes (``gather_stages``; the
optimizer state renumbered to the one-card parameter order), and on
resume each rank keeps its own (``stage_state``). The port never writes
the JAX package's stacked ``pp_layers`` tree.
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


# -- pipeline stages ----------------------------------------------------------

def _stage_blocks(stages: dict) -> list:
    """(name prefix of the layers, held global indices, layer count) of
    each pipeline-parallel encoder; ``stages``: module name -> encoder."""
    return [(f"{name}.encoder.layer." if name else "encoder.layer.",
             enc.pp.layers, enc.config.num_layers)
            for name, enc in stages.items()]


def _one_card_order(names: list, blocks: list) -> list:
    """``names`` (this stage's, in order) with each encoder's held layers
    replaced, where the first of them stands, by every layer's names in
    the one-card order."""
    out, done = [], set()
    for n in names:
        block = next((b for b in blocks if n.startswith(b[0])), None)
        if block is None:
            out.append(n)
            continue
        prefix, held, total = block
        if prefix in done:
            continue
        done.add(prefix)
        suffixes = [m[len(prefix):].split(".", 1)[1] for m in names
                    if m.startswith(f"{prefix}{held.start}.")]
        out += [f"{prefix}{i}.{sfx}" for i in range(total)
                for sfx in suffixes]
    return out


def _layer_suffixes(names, prefix: str, first: int) -> list:
    return [n[len(prefix):].split(".", 1)[1] for n in names
            if n.startswith(f"{prefix}{first}.")]


def _gather_layers(local: torch.Tensor, mesh) -> torch.Tensor:
    """[every stage's layers, ...] from this stage's stacked ``local``, on
    the host: one tensor at a time reaches the card, so the whole stack
    never stands on any rank's device (the memory a stage saves)."""
    return mesh.all_gather_dim(local, 0, MODEL_AXIS).cpu()


def gather_stage_tensors(tensors: dict, stages: dict, mesh) -> dict:
    """A name -> tensor dict of this stage (parameters, gradients) in the
    one-card layout: every stage's layers all-gathered over the model
    group, on the host. Every rank calls it."""
    blocks = _stage_blocks(stages)
    out = dict(tensors)
    for prefix, held, total in blocks:
        for sfx in _layer_suffixes(list(tensors), prefix, held.start):
            local = torch.stack([tensors[f"{prefix}{i}.{sfx}"]
                                 for i in held])
            every = _gather_layers(local, mesh)
            out.update({f"{prefix}{i}.{sfx}": every[i]
                        for i in range(total)})
    return {n: out[n] for n in _one_card_order(list(tensors), blocks)}


def _renumbered(param_groups: list, groups: list) -> list:
    """``param_groups`` numbering the parameters of ``groups`` (name lists)
    in order."""
    out, start = [], 0
    for pg, names in zip(param_groups, groups):
        out.append(dict(pg, params=list(range(start, start + len(names)))))
        start += len(names)
    return out


def _optimizer_names(optimizer, model) -> list:
    """The parameter names in the optimizer's numbering."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [[names[id(p)] for p in g["params"]]
            for g in optimizer.param_groups]


def gather_stages(state: dict, stages: dict, model, optimizer,
                  mesh) -> dict:
    """``state`` (the Trainer's, its class blocks already gathered) in the
    one-card layout: the model's and the accumulated gradients' layers
    gathered by name, and the optimizer's moments of every layer
    gathered and renumbered to the one-card parameter order (a
    non-tensor or scalar entry, the step count, is this stage's first
    layer's for every layer: the stages step together). Every rank
    calls it."""
    out = _rebuilt(state)
    out["model"] = gather_stage_tensors(state["model"], stages, mesh)
    if out["accum_grads"]:
        out["accum_grads"] = gather_stage_tensors(out["accum_grads"],
                                                  stages, mesh)
    groups = _optimizer_names(optimizer, model)
    stage_names = [n for g in groups for n in g]
    opt = out["optimizer"]
    by_name = {n: opt["state"][i] for i, n in enumerate(stage_names)
               if i in opt["state"]}
    blocks = _stage_blocks(stages)
    for prefix, held, total in blocks:
        first = f"{prefix}{held.start}."
        for sfx in _layer_suffixes(stage_names, prefix, held.start):
            entry = by_name.get(first + sfx, {})
            merged = [dict(entry) for _ in range(total)]
            for key, v in entry.items():
                if not torch.is_tensor(v) or v.dim() == 0:
                    continue
                local = torch.stack([by_name[f"{prefix}{i}.{sfx}"][key]
                                     for i in held])
                every = _gather_layers(local, mesh)
                for i in range(total):
                    merged[i][key] = every[i]
            by_name.update({f"{prefix}{i}.{sfx}": merged[i]
                            for i in range(total) if merged[i]})
    order = [_one_card_order(g, blocks) for g in groups]
    flat = [n for g in order for n in g]
    opt["state"] = {i: by_name[n] for i, n in enumerate(flat)
                    if n in by_name}
    opt["param_groups"] = _renumbered(opt["param_groups"], order)
    return out


def stage_state(state: dict, stages: dict, model, optimizer) -> dict:
    """A one-card ``state`` with only this rank's layers of each
    pipeline-parallel encoder, its optimizer state renumbered to this
    stage's parameter order."""
    blocks = _stage_blocks(stages)
    keep = set(model.state_dict())

    def own(d):
        return {k: v for k, v in d.items()
                if k in keep or not any(k.startswith(b[0]) for b in blocks)}

    out = _rebuilt(state)
    out["model"] = own(out["model"])
    out["accum_grads"] = own(out["accum_grads"])
    groups = _optimizer_names(optimizer, model)
    one_card = {n: i for i, n in enumerate(
        n for g in groups for n in _one_card_order(g, blocks))}
    opt = out["optimizer"]
    stage_names = [n for g in groups for n in g]
    opt["state"] = {i: opt["state"][one_card[n]]
                    for i, n in enumerate(stage_names)
                    if one_card[n] in opt["state"]}
    opt["param_groups"] = _renumbered(opt["param_groups"], groups)
    return out
