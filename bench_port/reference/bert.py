"""A plain post-LN BERT encoder with its tanh pooler (Hugging Face
``BertModel`` semantics, exact-erf GELU), in float32, as a function of a
``{name: tensor}`` dict with Hugging Face's parameter names; and a
character tokenizer (one token per non-space character between [CLS]
and [SEP], as BERT's Chinese WordPiece treats CJK titles)."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchlib.weights import Spec

SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def vocab(chars: Sequence[str]) -> List[str]:
    """The token list: the specials, then the characters in sorted order
    (one per line of a BERT vocab.txt)."""
    return list(SPECIALS) + sorted(set(chars))


def tokenize(texts: Sequence[str], tokens: Sequence[str], max_length: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """(input_ids, attention_mask), int32 [B, max_length]."""
    index = {t: i for i, t in enumerate(tokens)}
    ids = np.full((len(texts), max_length), index["[PAD]"], np.int32)
    mask = np.zeros((len(texts), max_length), np.int32)
    for b, text in enumerate(texts):
        chars = [c for c in text if not c.isspace()][:max_length - 2]
        row = ([index["[CLS]"]] + [index.get(c, index["[UNK]"])
                                   for c in chars] + [index["[SEP]"]])
        ids[b, :len(row)] = row
        mask[b, :len(row)] = 1
    return ids, mask


def param_specs(cfg: dict, bias_std: float = 0.02,
                ln_std: float = 0.1) -> List[Spec]:
    """Every tensor of the encoder: weights and embeddings normal(0,
    ``initializer_range``), biases normal(0, ``bias_std``), LayerNorm
    scales 1 + normal(0, ``ln_std``) (drawn as a normal around 0, the
    one added by ``finish``) and shifts normal(0, ``bias_std``), so a bias
    or a scale the program dropped would show."""
    H, inter = cfg["hidden_size"], cfg["intermediate_size"]
    std = cfg["initializer_range"]
    specs = [
        Spec("embeddings.word_embeddings.weight", (cfg["vocab_size"], H),
             "normal", std),
        Spec("embeddings.position_embeddings.weight",
             (cfg["max_position_embeddings"], H), "normal", std),
        Spec("embeddings.token_type_embeddings.weight",
             (cfg["type_vocab_size"], H), "normal", std)]
    specs += _ln("embeddings.LayerNorm", H, bias_std, ln_std)
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            specs += _linear(p + name, H, H, std, bias_std)
        specs += _ln(p + "attention.output.LayerNorm", H, bias_std, ln_std)
        specs += _linear(p + "intermediate.dense", H, inter, std, bias_std)
        specs += _linear(p + "output.dense", inter, H, std, bias_std)
        specs += _ln(p + "output.LayerNorm", H, bias_std, ln_std)
    specs += _linear("pooler.dense", H, H, std, bias_std)
    return specs


def _linear(name, fan_in, fan_out, std, bias_std):
    return [Spec(name + ".weight", (fan_out, fan_in), "normal", std),
            Spec(name + ".bias", (fan_out,), "normal", bias_std)]


def _ln(name, H, bias_std, ln_std):
    return [Spec(name + ".weight", (H,), "normal", ln_std),
            Spec(name + ".bias", (H,), "normal", bias_std)]


def finish(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Add 1 to every LayerNorm scale (drawn around 0 by ``param_specs``)."""
    return {k: (v + 1.0 if "LayerNorm.weight" in k else v)
            for k, v in params.items()}


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude to 448), back in float32: the operands of a
    product one precision step below bfloat16. The rounding passes the
    gradient straight through."""
    with torch.no_grad():
        scale = x.abs().amax().clamp_min(1e-12) / 448.0
        rounded = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (rounded - x).detach()


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _ln_apply(x, params, name, eps):
    return F.layer_norm(x, (x.shape[-1],), params[name + ".weight"],
                        params[name + ".bias"], eps)


def _lin(x, params, name, q=_same):
    return F.linear(q(x), q(params[name + ".weight"]), params[name + ".bias"])


def encode(params: Dict[str, torch.Tensor], cfg: dict,
           input_ids: torch.Tensor, attention_mask: torch.Tensor,
           quant: str = None) -> torch.Tensor:
    """The tanh pooler output [B, H] of the [CLS] token, in float32;
    ``quant="fp8"`` rounds the operands of every product with ``fp8``
    (the comparison's control)."""
    q = fp8 if quant == "fp8" else _same
    B, S = input_ids.shape
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, eps = H // nh, cfg["layer_norm_eps"]
    dev = input_ids.device
    h = (params["embeddings.word_embeddings.weight"][input_ids.long()]
         + params["embeddings.position_embeddings.weight"][
             torch.arange(S, device=dev)][None]
         + params["embeddings.token_type_embeddings.weight"][0])
    h = _ln_apply(h, params, "embeddings.LayerNorm", eps)
    bias = torch.where(attention_mask[:, None, None, :] > 0,
                       torch.zeros((), device=dev),
                       torch.full((), torch.finfo(torch.float32).min,
                                  device=dev))
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."

        def heads(name):
            return _lin(h, params, p + name, q).view(B, S, nh, hd) \
                .transpose(1, 2)

        qh, kh, vh = (heads("attention.self.query"),
                      heads("attention.self.key"),
                      heads("attention.self.value"))
        scores = q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(hd)
        probs = torch.softmax(scores + bias, dim=-1)
        ctx = (q(probs) @ q(vh)).transpose(1, 2).reshape(B, S, H)
        h = _ln_apply(h + _lin(ctx, params, p + "attention.output.dense", q),
                      params, p + "attention.output.LayerNorm", eps)
        mlp = F.gelu(_lin(h, params, p + "intermediate.dense", q))
        h = _ln_apply(h + _lin(mlp, params, p + "output.dense", q), params,
                      p + "output.LayerNorm", eps)
    return torch.tanh(_lin(h[:, 0], params, "pooler.dense", q))


def embed(params, cfg, texts: Sequence[str], tokens: Sequence[str],
          max_length: int, device, batch: int = 64,
          quant: str = None) -> np.ndarray:
    """f32 [N, H] embeddings of ``texts``, in the order given, computed in
    batches of titles of about one length, each cut to its longest row
    (padding is masked, so it changes nothing)."""
    order = np.argsort([len(t) for t in texts], kind="stable")
    out = []
    for s in range(0, len(texts), batch):
        ids, mask = tokenize([texts[i] for i in order[s:s + batch]], tokens,
                             max_length)
        width = int(mask.sum(1).max())
        ids_t = torch.from_numpy(ids[:, :width]).to(device)
        mask_t = torch.from_numpy(mask[:, :width]).to(device)
        with torch.no_grad():
            out.append(encode(params, cfg, ids_t, mask_t, quant).cpu())
    emb = torch.cat(out).numpy() if out else np.zeros(
        (0, cfg["hidden_size"]), np.float32)
    result = np.empty_like(emb)
    result[order] = emb
    return result
