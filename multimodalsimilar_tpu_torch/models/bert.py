"""BERT/RoBERTa encoder in PyTorch — the text tower backbone.

Counterpart of ``multimodalsimilar_tpu/models/bert.py`` (``BertEncoderModel``):

* word + position + token-type embeddings, then LayerNorm (eps 1e-12);
* post-LN layers with the exact-erf GELU (HF ``gelu``);
* attention scores and softmax in ``reduce_dtype``, with the additive mask
  ``finfo(reduce_dtype).min``; the tanh pooler in ``reduce_dtype``.

Attention is plain ``torch.matmul``, softmax and ``torch.matmul``, as the
JAX package leaves it to XLA. Dropout sits at the JAX module's four sites
(after the embeddings LayerNorm, on the attention probabilities, on the
attention output and on the MLP output). It acts only in ``train()``
mode, and its masks come from the ``torch.Generator`` handed to
``set_dropout_generator`` (the trainer owns it), never from the global
RNG. The encoder is built in ``eval()`` mode, like the JAX module's
``deterministic=True`` default. Casts follow the JAX module's dtype policy
point for point: linear layers run in ``compute_dtype``, LayerNorm in
``reduce_dtype``, and the residual stream is kept in ``compute_dtype``.
Parameter names follow HF ``BertModel``, so
``multimodalsimilar_tpu/models/hf_import.py:bert_params_from_torch`` loads
this module's ``state_dict`` into the JAX model. The port's layers always
hold three q/k/v projections: a JAX ``fused_qkv`` tree carries over split
(``models/convert.py``).

``BertConfig.remat`` rematerializes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant), as the JAX module's
per-layer ``nn.remat``: ``remat_policy="full"`` keeps only the layer's
input, ``"dots"`` (JAX's ``dots_with_no_batch_dims_saveable``) also keeps
the outputs of the weight products (the ``addmm``/``mm`` behind the
``nn.Linear``s) and recomputes the rest, the attention's batched products
included; ``remat_skip=K`` leaves every layer with ``i % K == 0`` out. The
recompute draws the forward's dropout masks again: the dropout
generator's state is put back around it.

``parallel/tp.py:tensor_parallel`` cuts a built encoder to this rank's
blocks and hands each module its ``TensorParallel`` layout (``self.tp``,
None on one device): the column-parallel products take their input
through the layout's ``enter``, the row-parallel ones return through its
``leave`` before their (replicated) bias, the word table looks up its
block of the vocabulary, and with ``BertConfig.sequence_parallel`` and a
sequence-parallel layout the residual stream between those points is
this rank's block of the sequence (``parallel/sp.py``). Each dropout
then draws the whole tensor's mask and keeps this rank's block, so N
ranks draw the masks one device draws.

``BertConfig.pipeline_parallel`` (with ``pp_microbatches`` = M): an
encoder built inside ``parallel/pp.py:building(mesh)`` holds only its
stage's layers, ``encoder.layer.{i}`` for its global indices i (so a
checkpoint gathers them by name), and runs them through the GPipe
schedule (``pp.gpipe``); built outside a scope it holds every layer and
runs them in turn, as the JAX module's mesh-less scan. Its init draws,
for each layer another stage holds, that layer's weights and drops
them, so every stage's layers get the weights one process draws. Its
dropout draws each layer's mask for the whole local batch and keeps the
microbatch's rows; a stage first draws (and drops) the masks of the
layers before it and, after the schedule, those after it, so the
generator moves as in one process and the masks are one process's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 21128              # bert-base-chinese / roberta-wwm vocab
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    # rematerialize each layer in the backward (see the module docstring)
    remat: bool = False
    remat_policy: str = "full"        # or "dots"
    remat_skip: int = 0               # layers i % K == 0 keep everything
    # the residual stream in sequence blocks under a sequence-parallel
    # Trainer (a no-op otherwise, as in the JAX module)
    sequence_parallel: bool = False
    # GPipe stages over the model group when built under pp.building,
    # with this many microbatches (see the module docstring)
    pipeline_parallel: bool = False
    pp_microbatches: int = 1

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        """Small config for tests."""
        base = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                    intermediate_size=128, max_position_embeddings=64)
        base.update(kw)
        return cls(**base)

    @classmethod
    def roberta_wwm_ext(cls, **kw) -> "BertConfig":
        """hfl/chinese-roberta-wwm-ext (base, 768-d)."""
        return cls(**kw)

    @classmethod
    def roberta_wwm_ext_large(cls, **kw) -> "BertConfig":
        """hfl/chinese-roberta-wwm-ext-large."""
        return cls(hidden_size=1024, num_layers=24, num_heads=16,
                   intermediate_size=4096, **kw)


def _linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype):
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype):
    return F.layer_norm(x.to(dtype), ln.normalized_shape,
                        ln.weight.to(dtype), ln.bias.to(dtype), ln.eps)


def flax_layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype
                    ) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=dtype)``: statistics, normalization and
    scale in f32 whatever ``x``'s dtype, the result cast to ``dtype``
    (the ViT, ConvNeXt and int8 towers)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dtype)


class _Module(nn.Module):
    """Attribute holder, so parameter paths read like HF's."""


class Dropout(nn.Module):
    """Inverted dropout (Flax ``nn.Dropout``: kept values scaled by
    1/(1-p)) whose masks come from ``self.generator``. Off in ``eval()``
    mode and at p = 0; in ``train()`` mode with p > 0 it raises without a
    generator rather than draw from the global RNG."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def mask_shape(self, x: torch.Tensor) -> tuple:
        return x.shape

    def forward(self, x: torch.Tensor, full_shape: Optional[tuple] = None,
                take: Optional[Callable] = None) -> torch.Tensor:
        """``full_shape`` and ``take``: draw the mask of the whole tensor
        (``full_shape``) and keep ``take(mask)``, ``x``'s block of it."""
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in train() mode needs a generator: "
                               "call set_dropout_generator first")
        keep = self._keep(full_shape or self.mask_shape(x), x.device)
        if take is not None:
            keep = take(keep)
        return torch.where(keep > 0, x / (1.0 - self.p), 0.0).to(x.dtype)

    def _keep(self, shape: tuple, device) -> torch.Tensor:
        keep = torch.empty(shape, dtype=torch.float32, device=device)
        return keep.bernoulli_(1.0 - self.p, generator=self.generator)

    def skip(self, shape: tuple, device) -> None:
        """Draw and drop the mask of a tensor of ``shape``: the generator
        moves as ``forward`` moves it."""
        if self.training and self.p > 0.0:
            self._keep(shape, device)


def _drawing_generators(module: nn.Module) -> list:
    """The generators the dropouts under ``module`` draw masks from."""
    return list({id(m.generator): m.generator for m in module.modules()
                 if isinstance(m, Dropout) and m.generator is not None
                 and m.training and m.p > 0}.values())


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Hand ``generator`` to every ``Dropout`` under ``module``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, policy: DTypePolicy):
        super().__init__()
        H, inter = cfg.hidden_size, cfg.intermediate_size
        # heads on this rank (all of them unless a tensor-parallel layout
        # cut the attention), of head_dim each
        self.num_heads = cfg.num_heads
        self.head_dim = H // cfg.num_heads
        self.policy = policy
        self.tp = None
        kw = dict(dtype=policy.param_dtype)
        self.attention = _Module()
        self.attention.self = _Module()
        for name in ("query", "key", "value"):
            setattr(self.attention.self, name, nn.Linear(H, H, **kw))
        self.attention.output = _Module()
        self.attention.output.dense = nn.Linear(H, H, **kw)
        self.attention.output.LayerNorm = nn.LayerNorm(
            H, eps=cfg.layer_norm_eps, **kw)
        self.intermediate = _Module()
        self.intermediate.dense = nn.Linear(H, inter, **kw)
        self.output = _Module()
        self.output.dense = nn.Linear(inter, H, **kw)
        self.output.LayerNorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps, **kw)
        self.attention.self.dropout = Dropout(cfg.attention_dropout)
        self.attention.output.dropout = Dropout(cfg.hidden_dropout)
        self.output.dropout = Dropout(cfg.hidden_dropout)

    def _enter(self, h: torch.Tensor, sharded: bool, S: int):
        return h if self.tp is None else self.tp.enter(h, sharded, S)

    def _row(self, x: torch.Tensor, lin: nn.Linear, sharded: bool):
        """``lin`` on ``x``, back into the residual stream: a row-parallel
        block's partial product leaves through the layout before the
        bias."""
        cd = self.policy.compute_dtype
        if self.tp is None:
            return _linear(x, lin, cd)
        if not sharded:
            return self.tp.leave(_linear(x, lin, cd), False)
        y = self.tp.leave(F.linear(x.to(cd), lin.weight.to(cd)), True)
        return y + lin.bias.to(cd)

    def _hidden_dropout(self, drop: Dropout, x: torch.Tensor, S: int,
                        rows=None):
        if rows is not None:       # a microbatch: its rows of the batch's
            return drop(x, (rows[0],) + tuple(x.shape[1:]),
                        lambda keep: keep[rows[1]])
        if self.tp is None or not self.tp.sequence:
            return drop(x)
        return drop(x, (x.shape[0], S, x.shape[2]),
                    functools.partial(self.tp.seq_block, S=S))

    def _attention(self, h: torch.Tensor, mask_bias: torch.Tensor, rows):
        cd, rd = self.policy.compute_dtype, self.policy.reduce_dtype
        S = mask_bias.shape[-1]
        sharded = self.tp is not None and self.tp.attention
        x = self._enter(h, sharded, S)
        B = x.shape[0]
        nh, hd = self.num_heads, self.head_dim
        sa = self.attention.self

        def heads(lin):   # [B, S, nh * hd] -> [B, nh, S, hd]
            return _linear(x, lin, cd).view(B, S, nh, hd).transpose(1, 2)

        q, k, v = heads(sa.query), heads(sa.key), heads(sa.value)
        scores = torch.matmul(q.to(rd), k.to(rd).transpose(-1, -2))
        # sqrt(hd) made on the device: a tensor copied from the host
        # (``torch.tensor(hd, device=...)``) waits for the stream to drain
        scores = scores / torch.full((), hd, dtype=rd,
                                     device=x.device).sqrt()
        probs = torch.softmax(scores + mask_bias, dim=-1)
        if sharded:    # the mask of every head, this rank's heads of it
            first = self.tp.index * nh
            probs = sa.dropout(probs, (B, nh * self.tp.n, S, S),
                               lambda keep: keep[:, first:first + nh])
        elif rows is not None:
            probs = sa.dropout(probs, (rows[0], nh, S, S),
                               lambda keep: keep[rows[1]])
        else:
            probs = sa.dropout(probs)
        ctx = torch.matmul(probs.to(cd).to(rd), v.to(rd))
        ctx = ctx.transpose(1, 2).reshape(B, S, nh * hd)
        return self._row(ctx.to(cd), self.attention.output.dense, sharded)

    def forward(self, h: torch.Tensor, mask_bias: torch.Tensor,
                rows: Optional[tuple] = None):
        """``rows`` = (B, slice): ``h`` is those rows of a batch of B, whose
        dropout masks are drawn whole (a pipeline microbatch)."""
        cd, rd = self.policy.compute_dtype, self.policy.reduce_dtype
        S = mask_bias.shape[-1]
        attn = self._hidden_dropout(self.attention.output.dropout,
                                    self._attention(h, mask_bias, rows), S,
                                    rows)
        h = _layer_norm(h + attn, self.attention.output.LayerNorm, rd).to(cd)
        sharded = self.tp is not None and self.tp.mlp
        mlp = F.gelu(_linear(self._enter(h, sharded, S),
                             self.intermediate.dense, cd))  # erf form
        mlp = self._hidden_dropout(
            self.output.dropout, self._row(mlp, self.output.dense, sharded),
            S, rows)
        return _layer_norm(h + mlp, self.output.LayerNorm, rd).to(cd)

    def skip_masks(self, B: int, S: int, device) -> None:
        """Draw and drop the masks ``forward`` draws for B rows of S
        tokens (a layer another pipeline stage holds)."""
        H = self.output.dense.out_features
        self.attention.self.dropout.skip((B, self.num_heads, S, S), device)
        self.attention.output.dropout.skip((B, S, H), device)
        self.output.dropout.skip((B, S, H), device)


# the products "dots" saves: the weight products behind nn.Linear (addmm
# with a bias, mm without); the attention's bmm has batch dimensions
_SAVED_PRODUCTS = frozenset({torch.ops.aten.addmm.default,
                             torch.ops.aten.mm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(layer: nn.Module, h: torch.Tensor, mask_bias: torch.Tensor,
          policy: str = "full", rows: Optional[tuple] = None
          ) -> torch.Tensor:
    """``layer(h, mask_bias, rows)`` rematerialized in the backward under
    ``policy`` (``full`` or ``dots``). The recompute runs with the dropout
    generators' states of the forward and puts back the states it found,
    so it draws the forward's masks and moves nothing else."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    gens = _drawing_generators(layer)
    start = [g.get_state() for g in gens]
    ran = []

    def run(h, mask_bias):
        if not ran:
            ran.append(True)
            return layer(h, mask_bias, rows)
        found = [g.get_state() for g in gens]
        for g, state in zip(gens, start):
            g.set_state(state)
        try:
            return layer(h, mask_bias, rows)
        finally:
            for g, state in zip(gens, found):
                g.set_state(state)

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    # the masks come from the generators above, never the global RNG
    return checkpoint(run, h, mask_bias, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _embedding(n: int, dim: int, **kw) -> nn.Embedding:
    """``nn.Embedding(n, dim)``; built on the ``meta`` device (to be
    loaded) it skips its own normal init, whose meta kernel imports the
    compiler stack (seconds, once a process)."""
    if torch.empty(0).is_meta:
        return nn.Embedding(n, dim, _weight=torch.empty((n, dim), **kw))
    return nn.Embedding(n, dim, **kw)


class BertEncoderModel(nn.Module):
    """Embeddings + transformer stack + tanh pooler (= HF BertModel)."""

    def __init__(self, config: BertConfig,
                 policy: DTypePolicy = DTypePolicy()):
        super().__init__()
        cfg = self.config = config
        self.policy = policy
        kw = dict(dtype=policy.param_dtype)
        H = cfg.hidden_size
        self.embeddings = _Module()
        self.embeddings.word_embeddings = _embedding(cfg.vocab_size, H, **kw)
        self.embeddings.position_embeddings = _embedding(
            cfg.max_position_embeddings, H, **kw)
        self.embeddings.token_type_embeddings = _embedding(
            cfg.type_vocab_size, H, **kw)
        self.embeddings.LayerNorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps,
                                                 **kw)
        self.embeddings.dropout = Dropout(cfg.hidden_dropout)
        self.encoder = _Module()
        self.pp = None
        if cfg.pipeline_parallel:
            if cfg.remat_skip:
                raise ValueError(
                    "remat_skip requires the standard encoder: the pipeline-"
                    "parallel stack runs one uniform scan body per layer, so "
                    "per-layer remat choices cannot apply (use remat_policy "
                    "or drop --pipeline_parallel)")
            from multimodalsimilar_tpu_torch.parallel import pp
            mesh = pp.building_mesh()
            if mesh is not None:
                self.pp = pp.stage_of(cfg.num_layers, mesh)
        if self.pp is None:
            self.encoder.layer = nn.ModuleList(
                BertLayer(cfg, policy) for _ in range(cfg.num_layers))
        else:
            self.encoder.layer = StageLayers(
                {str(i): BertLayer(cfg, policy) for i in self.pp.layers},
                cfg.num_layers)
        self.pooler = _Module()
        self.pooler.dense = nn.Linear(H, H, **kw)
        if cfg.remat and cfg.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', "
                             f"got {cfg.remat_policy!r}")
        self.tp = None
        self.eval()

    def layers(self) -> list:
        """(global index, layer) of every layer this encoder holds."""
        if self.pp is None:
            return list(enumerate(self.encoder.layer))
        return [(int(i), layer) for i, layer in self.encoder.layer.items()]

    def _layer(self, i: int, layer: BertLayer, h: torch.Tensor,
               mask_bias: torch.Tensor, rows=None) -> torch.Tensor:
        cfg = self.config
        if not cfg.remat or not torch.is_grad_enabled() or (
                cfg.remat_skip and i % cfg.remat_skip == 0):
            return layer(h, mask_bias, rows)
        return remat(layer, h, mask_bias, cfg.remat_policy, rows)

    def _pipeline(self, h: torch.Tensor, mask_bias: torch.Tensor
                  ) -> torch.Tensor:
        """This stage's layers in the GPipe schedule, the dropout
        generator moved past the other stages' layers (module
        docstring)."""
        from multimodalsimilar_tpu_torch.parallel import pp
        held = self.layers()
        B, S = h.shape[0], mask_bias.shape[-1]
        gens = _drawing_generators(self.encoder.layer)

        def skip(n):
            for _ in range(n):
                held[0][1].skip_masks(B, S, h.device)

        skip(self.pp.layers.start)
        start = [g.get_state() for g in gens]

        def run(x, mb, rows):
            for g, state in zip(gens, start):
                g.set_state(state)
            for i, layer in held:
                x = self._layer(i, layer, x, mb, (B, rows))
            return x

        out = pp.gpipe(run, h, mask_bias, self.pp.mesh,
                       self.config.pp_microbatches)
        skip(self.config.num_layers - self.pp.layers.stop)
        return out

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        cd, rd = self.policy.compute_dtype, self.policy.reduce_dtype
        B, S = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int32, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros((B, S), dtype=torch.int32,
                                         device=dev)
        emb = self.embeddings
        tp = self.tp
        pos = emb.position_embeddings(torch.arange(S, device=dev))[None]
        typ = emb.token_type_embeddings(token_type_ids.long())
        if tp is None:
            h = emb.word_embeddings(input_ids.long()) + pos + typ
            h = emb.dropout(_layer_norm(h, emb.LayerNorm, rd)).to(cd)
        else:
            h = _layer_norm(tp.embed(emb.word_embeddings, input_ids, pos,
                                     typ), emb.LayerNorm, rd)
            if tp.sequence:
                h = emb.dropout(h, (B, S, h.shape[2]),
                                functools.partial(tp.seq_block, S=S))
            else:
                h = emb.dropout(h)
            h = h.to(cd)

        # additive attention bias: 0 for attended, big-negative for padding
        mask_bias = torch.where(attention_mask[:, None, None, :] > 0,
                                torch.zeros((), dtype=rd, device=dev),
                                torch.full((), torch.finfo(rd).min,
                                           dtype=rd, device=dev))
        if self.pp is not None:
            h = self._pipeline(h, mask_bias)
        else:
            for i, layer in self.layers():
                h = self._layer(i, layer, h, mask_bias)
        if tp is not None:
            h = tp.gather(h, S)
        pooled = _linear(h[:, 0], self.pooler.dense, cd)
        pooled = torch.tanh(pooled.to(rd))
        return {"last_hidden_state": h, "pooler_output": pooled}


class StageLayers(nn.ModuleDict):
    """A pipeline stage's layers keyed by their global index, of an
    encoder of ``num_layers``."""

    def __init__(self, layers: Dict[str, nn.Module], num_layers: int):
        super().__init__(layers)
        self.num_layers = num_layers


def _draw_order(module: nn.Module, keep: bool = True):
    """(module, keep) in ``module.modules()`` order; a stage's layers
    stand in the order of the whole encoder, each layer the stage does
    not hold as a held layer with ``keep=False``."""
    if not isinstance(module, StageLayers):
        yield module, keep
        for child in module.children():
            yield from _draw_order(child, keep)
        return
    yield module, keep
    held = dict(module.items())
    template = next(iter(held.values()))
    for i in range(module.num_layers):
        yield from _draw_order(held.get(str(i), template),
                               keep and str(i) in held)


def init_bert_weights(module: nn.Module, generator: torch.Generator
                      ) -> None:
    """HF BertModel's init (initializer_range 0.02), drawn from
    ``generator``: normal(0, 0.02) weights and embeddings, zero biases,
    unit LayerNorm scales. A pipeline stage draws, and drops, the weights
    of the layers it does not hold. A module on the ``meta`` device
    (built to be loaded) draws nothing."""
    if any(p.is_meta for p in module.parameters()):
        return
    with torch.no_grad():
        for m, keep in _draw_order(module):
            if isinstance(m, (nn.Linear, nn.Embedding)):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                w.normal_(0.0, 0.02, generator=generator)
                if not keep:
                    continue
                m.weight.copy_(w)
                if isinstance(m, nn.Linear) and m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm) and keep:
                m.weight.fill_(1.0)
                m.bias.zero_()

