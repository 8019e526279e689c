"""Tensor parallelism of the BERT text tower (counterpart of
multimodalsimilar_tpu/parallel/tp.py), Megatron's layout over the mesh's
model group.

JAX ``tp_partition_spec`` (``tp.py:48-99``) places the tower's leaves;
the port cuts the same tensors, under their HF names, to this rank's
block (``tensor_parallel``), as ``ArcFaceHead.shard`` cuts a head:

=========================================  ===============================
JAX leaf                                    port parameter, cut
=========================================  ===============================
``query``/``key``/``value`` [H, nh, hd]     ``attention.self.{q,k,v}``:
and bias; fused ``qkv`` [H, 3, nh, hd]      weight rows and bias by heads
                                            (column-parallel)
attention ``out`` [nh, hd, H]               ``attention.output.dense``:
                                            weight columns by heads
                                            (row-parallel), bias whole
``intermediate`` [H, I] and bias            ``intermediate.dense``: weight
                                            rows and bias (column-parallel)
``output`` [I, H]                           ``output.dense``: weight
                                            columns (row-parallel), bias
                                            whole
``word_embeddings`` [V, H]                  rows of the vocabulary
LayerNorms, position and type tables,       whole
pooler
=========================================  ===============================

A block whose dimension does not divide by the model axis (the heads,
the intermediate width, the vocabulary) stays whole with a notice, and
when nothing divides the cut raises, with the JAX Trainer's messages
(``trainer.py:641-671``). The collectives are the explicit autograd
functions of ``parallel/mesh.py``, called through each module's
``TensorParallel`` layout (``models/bert.py``): the input of a
column-parallel block enters through ``copy_to_group`` (identity, the
gradient all-reduced), the output of a row-parallel block leaves through
``reduce_from_group`` (all-reduced, the gradient passed through), and
the vocabulary-sharded lookup is a masked local gather followed by the
same all-reduce. Under sequence parallelism (``parallel/sp.py``) those
become the all-gather and the reduce-scatter along the sequence. It
composes with the class-sharded heads over the same model group.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodalsimilar_tpu_torch.parallel import sp
from multimodalsimilar_tpu_torch.parallel.mesh import (Shard, copy_to_group,
                                                       reduce_from_group)


class TensorParallel:
    """One encoder's layout on this rank: which blocks are cut over the
    model group (``attention``: by heads, ``mlp``: by the intermediate
    width, ``vocab``: the word table's rows) and whether the residual
    stream is in sequence blocks (``sequence``)."""

    def __init__(self, mesh, attention: bool, mlp: bool, vocab: bool,
                 vocab_rows: slice, sequence: bool):
        self.mesh = mesh
        self.n, self.index = mesh.model, mesh.model_index
        self.attention, self.mlp, self.vocab = attention, mlp, vocab
        self.vocab_rows = vocab_rows
        self.sequence = sequence

    def enter(self, h: torch.Tensor, sharded: bool, S: int) -> torch.Tensor:
        """The whole [B, S, H] input of a block from the residual stream
        ``h``; ``sharded``: the block is cut (its gradient of the input is
        partial on each rank)."""
        if self.sequence:
            return sp.from_sequence(h, self.mesh, sharded, S)
        return copy_to_group(h, self.mesh) if sharded else h

    def leave(self, y: torch.Tensor, sharded: bool) -> torch.Tensor:
        """A block's [B, S, H] output back into the residual stream:
        ``sharded``, it is this rank's partial sum."""
        if self.sequence:
            return sp.to_sequence(y, self.mesh, sharded)
        return reduce_from_group(y, self.mesh) if sharded else y

    def seq_block(self, t: torch.Tensor, S: int) -> torch.Tensor:
        return sp.seq_block(t, self.mesh, S)

    def embed(self, table: nn.Embedding, ids: torch.Tensor,
              pos: torch.Tensor, typ: torch.Tensor) -> torch.Tensor:
        """word + position + type embeddings into the residual stream; a
        vocabulary-sharded table looks up the ids of its rows (zero for
        the rest) and the partial sums leave as a row-parallel product
        does."""
        ids = ids.long()
        if not self.vocab:
            word = table(ids)
            if not self.sequence:
                return word + pos + typ
            return self.leave(word + pos + typ, False)
        rows = self.vocab_rows
        local = ids - rows.start
        inside = (local >= 0) & (local < rows.stop - rows.start)
        word = F.embedding(torch.where(inside, local, 0), table.weight)
        word = self.leave(torch.where(inside[..., None], word, 0.0), True)
        if not self.sequence:
            return word + pos + typ
        return (word + self.leave(pos.expand_as(typ), False)
                + self.leave(typ, False))

    def gather(self, h: torch.Tensor, S: int) -> torch.Tensor:
        """The encoder's output, whole on every rank."""
        if not self.sequence:
            return h
        return sp.from_sequence(h, self.mesh, False, S)


def _rows(lin: nn.Linear, rows: slice) -> None:
    """Keep output features ``rows`` of ``lin`` (weight rows and bias)."""
    lin.weight = nn.Parameter(lin.weight.detach()[rows].clone())
    lin.bias = nn.Parameter(lin.bias.detach()[rows].clone())


def _columns(lin: nn.Linear, cols: slice) -> None:
    """Keep input features ``cols`` of ``lin`` (its bias stays whole)."""
    lin.weight = nn.Parameter(lin.weight.detach()[:, cols].clone())


def _encoders(model: nn.Module):
    from multimodalsimilar_tpu_torch.models.bert import BertEncoderModel
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, BertEncoderModel)]


def tensor_parallel(model: nn.Module, mesh, sequence_parallel: bool = False
                    ) -> Tuple[Dict[str, Shard], List[str]]:
    """Cut every BERT encoder of ``model`` to this rank's blocks over the
    mesh's model group and hand its modules the layout; with
    ``sequence_parallel``, encoders built with
    ``BertConfig.sequence_parallel`` run their residual stream in sequence
    blocks. Returns (name -> ``Shard`` of every cut parameter, the names
    of the parameters whose gradients are partial over the model group
    under sequence parallelism)."""
    n, i = mesh.model, mesh.model_index
    block = lambda size: slice(i * (size // n), (i + 1) * (size // n))  # noqa
    shards: Dict[str, Shard] = {}
    skipped = []
    partial: List[str] = []
    applied = 0
    for name, enc in _encoders(model):
        prefix = f"{name}." if name else ""
        cfg = enc.config
        nh, inter, vocab = (cfg.num_heads, cfg.intermediate_size,
                            cfg.vocab_size)
        attention, mlp, vocab_ok = (nh % n == 0, inter % n == 0,
                                    vocab % n == 0)
        sequence = sequence_parallel and cfg.sequence_parallel
        applied += sequence
        for ok, size, what in ((attention, nh, "attention"),
                               (mlp, inter, "intermediate"),
                               (vocab_ok, vocab, "word_embeddings")):
            if not ok:
                skipped.append((f"{prefix}{what}", size))
        if vocab_ok:
            table = enc.embeddings.word_embeddings
            table.weight = nn.Parameter(
                table.weight.detach()[block(vocab)].clone())
            key = f"{prefix}embeddings.word_embeddings.weight"
            shards[key] = Shard(table.weight, 0, vocab)
        layout = TensorParallel(mesh, attention, mlp, vocab_ok,
                                block(vocab), sequence)
        enc.tp = layout
        for j, layer in enumerate(enc.encoder.layer):
            layer.tp = layout
            at = f"{prefix}encoder.layer.{j}."
            H = cfg.hidden_size
            if attention:
                heads = block(nh)
                feats = slice(heads.start * layer.head_dim,
                              heads.stop * layer.head_dim)
                for proj in ("query", "key", "value"):
                    lin = getattr(layer.attention.self, proj)
                    _rows(lin, feats)
                    base = f"{at}attention.self.{proj}."
                    shards[base + "weight"] = Shard(lin.weight, 0, H)
                    shards[base + "bias"] = Shard(lin.bias, 0, H)
                out = layer.attention.output.dense
                _columns(out, feats)
                shards[f"{at}attention.output.dense.weight"] = Shard(
                    out.weight, 1, H)
                layer.num_heads = nh // n
            if mlp:
                cols = block(inter)
                _rows(layer.intermediate.dense, cols)
                _columns(layer.output.dense, cols)
                shards[f"{at}intermediate.dense.weight"] = Shard(
                    layer.intermediate.dense.weight, 0, inter)
                shards[f"{at}intermediate.dense.bias"] = Shard(
                    layer.intermediate.dense.bias, 0, inter)
                shards[f"{at}output.dense.weight"] = Shard(
                    layer.output.dense.weight, 1, inter)
        if sequence:
            partial += sp.sequence_partial(enc, prefix)
    if not shards:
        detail = "; ".join(f"{k} (dim={d}, {d} % {n} != 0)"
                           for k, d in sorted(set(skipped))[:6]) \
            or "no BERT-tower weights found (tp rules cover the text " \
               "tower only — parallel/tp.py)"
        raise ValueError(
            f"tensor_parallel={n} shards nothing: {detail}. "
            f"Pick an axis size dividing num_heads/intermediate_size, "
            f"or drop --tensor_parallel.")
    if skipped:
        names = ", ".join(sorted({k for k, _ in skipped}))
        print(f"tensor_parallel={n}: replicating indivisible tower leaves "
              f"{names} (sharded "
              f"{len({tuple(s.param.shape) for s in shards.values()})} "
              f"weight shapes)", flush=True)
    if sequence_parallel and not applied:
        raise ValueError(
            "TrainerConfig.sequence_parallel is on but the model applied "
            "no sequence_parallel behavior — build the model with "
            "sequence_parallel=True in its BertConfig (cli does this "
            "automatically)")
    return shards, partial
