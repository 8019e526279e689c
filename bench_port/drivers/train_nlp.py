"""``train nlp`` at the reference's multi-GPU recipe on one card:
RoBERTa-wwm-ext-base + ArcFace over 10,205 classes, global batch 1,024
in one step.

Set-up gives torch's own thread pool the traffic's ``pool_threads``,
draws the table (product titles from ``benchlib/gen.py``, Zipf labels
with the last class present), parses the recipe's flags with the port's
own parser (``cli/parser.py``) and builds what
``cli/train.py:cmd_train_nlp`` builds: the char tokenizer of the table's
titles (``cli/common.py:_tokenizer``), the ``TextClassificationSource``
with the recipe's seq buckets, an ``NlpTextClassifier`` built on the
``meta`` device and loaded with the benchmark's weights from the seed
(the encoder as ``reference/bert.py:param_specs`` draws it, the head
normal), the text ArcFace task and, through ``cli/train.py:_trainer``,
the Trainer with AdamW on both groups and the linear schedule.
``Trainer.fit`` then runs once with the class-balanced sampler of
``cli/train.py:_sampler_fn``, as ``drivers/train_cv.py`` runs it: the
first ``warmup_steps`` steps are set-up (the first ``compared_steps`` of
them are the ones the reference follows), the window opens with a
synchronise before the next step and closes at the first step boundary
after ``--seconds``, with a synchronise.

After the window, with the program's state freed, the plain reference
(``reference/bert_train.py``: float32, TF32 off, the Trainer's dropout
masks drawn again from its seeds; ``reference/efficientnet.py``'s ArcFace
loss and AdamW) follows the first ``compared_steps`` steps from the same
weights on the same batches. It compares the rows' labels and token ids
with the sampler's draw and the reference tokenizer worked out again,
each leaf's first-gradient norm (the program's worked out from AdamW's
first moment after one step) and each leaf's change after the compared
steps (``drivers/train_cv.py:compare``'s median-leaf gaps), and reports
each step's loss.
"""

from __future__ import annotations

import gc
import os
import shutil
import statistics
import tempfile
import time

import numpy as np

from benchlib import flops, gen, peaks
from benchlib.trace import DeviceTrace, Spans
from benchlib.weights import Spec, draw
from drivers import train_cv as cv
from reference import bert as ref_bert
from reference import bert_train as ref_train
from reference import efficientnet as ref_cv

TABLE = 21          # rng_for purpose


class Source:
    """The program's source in ``fit``'s hands: keeps the first batches
    for the reference and each batch's real tokens for the operation
    count."""

    def __init__(self, inner, keep: int):
        self.inner, self.keep = inner, keep
        self.kept, self.tokens = [], []

    def __len__(self):
        return len(self.inner)

    def batches(self, *args, **kwargs):
        for batch in self.inner.batches(*args, **kwargs):
            if len(self.kept) < self.keep:
                self.kept.append({k: v.copy() for k, v in batch.items()})
            self.tokens.append(batch["attention_mask"].sum(axis=1))
            yield batch


def write_table(traffic: dict, recipe: dict, seed: int) -> dict:
    rng = gen.rng_for(seed, TABLE)
    lo, hi = traffic["title_len"]
    titles = gen.make_titles(traffic["rows"], rng, lo, hi,
                             traffic["dup_every"])
    labels = gen.zipf_with_last(traffic["rows"], recipe["num_classes"], rng,
                                traffic["zipf_exponent"])
    flags = recipe["flags"]
    return {flags["text_col"]: titles, flags["label_col"]: labels.tolist()}


def param_specs(model: dict, num_classes: int):
    """The encoder's tensors under the classifier's names, and the head's
    [C, H] weight, normal(0, 0.02) (it is normalised before use)."""
    specs = [Spec("tower.encoder." + s.name, s.shape, s.kind, s.scale)
             for s in ref_bert.param_specs(model)]
    return specs + [Spec("head.weight", (num_classes, model["hidden_size"]),
                         "normal", 0.02)]


def weights(model: dict, num_classes: int, seed: int, device) -> dict:
    return ref_bert.finish(draw(param_specs(model, num_classes), seed,
                                device))


def build(cell, opts, table, out_dir):
    """(trainer, program source, sampler_fn, args, tokens):
    ``cmd_train_nlp``'s objects over the benchmark's weights."""
    import torch
    from multimodalsimilar_tpu_torch.cli.common import _tokenizer
    from multimodalsimilar_tpu_torch.cli.parser import build_parser
    from multimodalsimilar_tpu_torch.cli.train import (
        _sampler_fn, _text_config, _trainer)
    from multimodalsimilar_tpu_torch.data.datasets import (
        TextClassificationSource)
    from multimodalsimilar_tpu_torch.models.classifiers import (
        NlpTextClassifier)
    from multimodalsimilar_tpu_torch.ops.arcface import ArcFaceParams
    from multimodalsimilar_tpu_torch.train.tasks import text_arcface_task
    recipe = cell.traffic["recipe"]
    if opts.full_precision:
        raise ValueError("train nlp has no full-precision witness here")
    args = build_parser().parse_args(
        ["train", "nlp", "--data", "(the benchmark's table)",
         "--output", out_dir, "--seed", str(opts.seed)]
        + cv.flag_argv(recipe["flags"]))
    tok = _tokenizer(args, df=table, save_dir=args.output)
    src = TextClassificationSource(
        table, tok, args.text_col, args.label_col, args.max_length,
        clean=not args.no_clean, seq_buckets=args.seq_buckets)
    labels = table[args.label_col]
    num_labels = int(max(labels)) + 1
    with torch.device("meta"):
        model = NlpTextClassifier(
            _text_config(args), pool=getattr(args, "pool", "cls"),
            num_labels=num_labels, arcface=ArcFaceParams(m=args.margin))
    model.load_state_dict(weights(cell.config, num_labels, opts.seed,
                                  opts.device), strict=True, assign=True)
    trainer = _trainer(text_arcface_task(model, fused_loss=args.fused_loss),
                       args, max(len(src) // args.batch_size, 1),
                       opts.device)
    tokens = ref_bert.vocab({c for t in table[args.text_col] for c in t
                             if not c.isspace()})
    return trainer, src, _sampler_fn(args, table, args.label_col), args, \
        tokens


def run(cell, opts) -> dict:
    import torch
    traffic, recipe = cell.traffic, cell.traffic["recipe"]
    cv.pool_threads(traffic["pool_threads"])
    work = tempfile.mkdtemp(prefix="bench_train_nlp_")
    try:
        opts.log("set-up: program imported")
        table = write_table(traffic, recipe, opts.seed)
        opts.log("set-up: table drawn")
        trainer, src, sampler_fn, args, tokens = build(
            cell, opts, table, os.path.join(work, "output"))
        opts.log("set-up: Trainer built")
        sync = torch.cuda.synchronize if opts.device.type == "cuda" \
            else (lambda: None)
        return _fit(cell, opts, trainer, src, sampler_fn, args, table,
                    tokens, Spans(opts.trace), sync)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _fit(cell, opts, trainer, src, sampler_fn, args, table, tokens, spans,
         sync):
    import torch
    from multimodalsimilar_tpu_torch.ops import arcface as A
    traffic, recipe = cell.traffic, cell.traffic["recipe"]
    warm, compared = traffic["warmup_steps"], traffic["compared_steps"]
    source = Source(src, compared)
    model = trainer.model
    named = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in named.items()}
    inner = trainer.train_step
    if opts.fault == "unchanged":
        trainer.optimizer.step = lambda *a, **k: None
    elif opts.fault not in (None, "half_batch"):
        raise ValueError(f"unknown fault {opts.fault!r}")
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    state = {"n": 0, "t0": None, "starts": []}
    trace = DeviceTrace() if opts.trace else None

    def step(batch):
        n = state["n"] = state["n"] + 1
        if n == warm + 1:
            sync()
            if trace:
                trace.start()
            opts.log(f"set-up: {warm} warm-up steps run; window opens")
            state["window"] = spans.begin("window")
            state["launches"] = A.LAUNCHES["arcface"]
            state["t0"] = time.perf_counter()
        elif n > warm + 1 and \
                time.perf_counter() - state["t0"] >= opts.seconds:
            sync()
            state["t_end"] = time.perf_counter()
            spans.end(state["window"])
            raise cv.WindowClosed
        if n > warm:
            state["starts"].append(time.perf_counter())
        if opts.fault == "half_batch":
            half = batch["labels"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        with spans.span("step"):
            out = inner(batch)
        if n == 1:
            opt_state = trainer.optimizer.state
            state["grad_norms"] = {
                name: (opt_state[p]["exp_avg"].norm() / (1.0 - beta1)
                       if p in opt_state else torch.zeros((), device=p.device))
                for name, p in named.items()}
        if n <= compared:
            state.setdefault("losses", []).append(out["loss"])
        if n == compared:
            state["change_norms"] = {name: (p.detach() - start[name]).norm()
                                     for name, p in named.items()}
        return out

    trainer.train_step = step
    try:
        trainer.fit(source, args.epochs, args.batch_size, None,
                    sampler_fn=sampler_fn)
        raise RuntimeError("fit ended before the window closed: give the "
                           "table more rows")
    except cv.WindowClosed:
        opts.log(f"window closed after {len(state['starts'])} steps")
    if trace:
        trace.stop()
    window_s = state["t_end"] - state["t0"]
    steps = len(state["starts"])
    launches = A.LAUNCHES["arcface"] - state["launches"]
    memory_peak = torch.cuda.max_memory_allocated(opts.device) \
        if opts.device.type == "cuda" else 0
    program = {"losses": [float(x) for x in state["losses"]],
               "grads": {k: float(v) for k, v in state["grad_norms"].items()},
               "changes": {k: float(v)
                           for k, v in state["change_norms"].items()}}
    kept = source.kept
    window_tokens = source.tokens[warm:warm + steps]
    del start, named, model, state["grad_norms"], state["change_norms"]
    trainer.optimizer.state.clear()
    trainer.model.zero_grad(set_to_none=True)
    trainer.model.to("cpu")
    del trainer
    gc.collect()
    if opts.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(cell, opts, program, kept, table, args, tokens)
    opts.log("reference compared")

    model_cfg, C = cell.config, recipe["num_classes"]
    H = model_cfg["hidden_size"]
    fwd = sum(flops.bert_job_flops(t.tolist(), H,
                                   model_cfg["num_hidden_layers"],
                                   model_cfg["intermediate_size"])
              + flops.arcface_flops(len(t), C, H) for t in window_tokens)
    batch = args.batch_size
    intervals = np.diff(state["starts"] + [state["t_end"]])
    obs = {"window_s": window_s, "steps": steps,
           "model_flops": 3.0 * fwd,
           "step_p50_s": float(statistics.median(intervals)),
           "arcface_launches": launches,
           "arcface_bound_s": peaks.roofline_s(
               flops.arcface_flops(batch, C, H),
               flops.arcface_bytes(batch, C, H))}
    if trace:
        obs["device"] = trace.summary(spans)
    return {"e2e": {"train_examples_per_s": batch * steps / window_s,
                    "setup_s": state["t0"] - opts.t_start},
            "attempted": batch * steps, "failed": 0, "checks": checks,
            "memory_peak_bytes": memory_peak, "obs": obs}


def linear_lr(lr: float, total: int, count: int) -> float:
    """``train/optim.py:linear_schedule_with_warmup`` without warm-up at
    optimizer step ``count``, in float32 as it computes."""
    f32 = np.float32
    return float(f32(lr) * f32(max(f32(0.0), (f32(total) - f32(count))
                                   / f32(max(total, 1)))))


def expected_rows(table: dict, args, n: int) -> np.ndarray:
    """The first ``n`` rows the class-balanced sampler draws in epoch 0
    (``drivers/train_cv.py:expected_labels``'s draw)."""
    labels = np.asarray(table[args.label_col])
    _, inverse, counts = np.unique(labels, return_inverse=True,
                                   return_counts=True)
    p = np.asarray((1.0 / counts)[inverse], np.float64)
    p = p / p.sum()
    return np.random.default_rng(args.seed).choice(
        len(p), size=len(p), replace=True, p=p)[:n]


def trajectory(P, cfg, args, total, batches, seed, s, device, q):
    """The reference's losses, first-gradient norms and changes over
    ``batches``, from ``P`` (the classifier's names), at the margin,
    learning rates and weight decays of ``args``."""
    import torch
    names = list(P)
    opt = ref_cv.AdamW(names)
    start = {n: P[n].detach().clone() for n in names}
    gen_ = torch.Generator(device=device)
    head = {n: n.startswith("head.") for n in names}
    wd = {n: args.head_weight_decay if head[n] else args.weight_decay
          for n in names}
    losses, grads = [], None
    for t, batch in enumerate(batches):
        gen_.manual_seed(cv.mask_seed(seed, t))
        for n in names:
            P[n].requires_grad_(True)
        ids = torch.from_numpy(batch["input_ids"]).to(device)
        mask = torch.from_numpy(batch["attention_mask"]).to(device)
        labels = torch.from_numpy(batch["labels"]).to(device)
        enc = {n[len("tower.encoder."):]: P[n] for n in names
               if not head[n]}
        emb = ref_train.encode(enc, cfg, ids, mask, ref_cv.Masks(gen_), q)
        loss = ref_cv.arcface_loss(emb, P["head.weight"], labels,
                                   args.margin, s, q)
        g = torch.autograd.grad(loss, [P[n] for n in names])
        losses.append(float(loss.detach()))
        if t == 0:
            grads = {n: float(x.norm()) for n, x in zip(names, g)}
        for n in names:
            P[n] = P[n].detach()
        lr = {n: linear_lr(args.head_lr if head[n] else args.tower_lr,
                           total, t) for n in names}
        opt.step(P, dict(zip(names, g)), lr, wd)
    changes = {n: float((P[n] - start[n]).norm()) for n in names}
    return {"losses": losses, "grads": grads, "changes": changes}


def judge(cell, opts, program, kept, table, args, tokens) -> list:
    import torch
    from reference.bert import fp8
    recipe, limits = cell.traffic["recipe"], cell.traffic["limits"]
    steps_per_epoch = max(len(table[args.label_col]) // args.batch_size, 1)
    total = args.epochs * steps_per_epoch
    rows = expected_rows(table, args, sum(len(b["labels"]) for b in kept))
    got_labels = np.concatenate([b["labels"] for b in kept])
    label_rows = int((got_labels != np.asarray(
        table[args.label_col])[rows]).sum())
    got_ids = [b["input_ids"] for b in kept]
    want_ids, _ = ref_bert.tokenize([table[args.text_col][i] for i in rows],
                                    tokens, args.max_length)
    at, ids_rows = 0, 0
    for g in got_ids:
        w = want_ids[at:at + len(g)]
        ids_rows += int(((w[:, :g.shape[1]] != g).any(1)
                         | (w[:, g.shape[1]:] != 0).any(1)).sum())
        at += len(g)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        num_labels = int(max(table[args.label_col])) + 1

        def follow(q):
            return trajectory(weights(cell.config, num_labels, opts.seed,
                                      opts.device), cell.config, args,
                              total, kept, opts.seed, recipe["arcface_s"],
                              opts.device, q)

        want = follow(lambda t: t)
        if opts.control == "fp8":
            program = follow(fp8)
        elif opts.control is not None:
            raise ValueError(f"unknown control {opts.control!r}")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    _report(program, want)
    grad_gap, change_gap = leaf_gaps(program, want)
    return [{"name": "label_rows_differing", "value": float(label_rows),
             "limit": 0.0},
            {"name": "token_ids_rows_differing", "value": float(ids_rows),
             "limit": 0.0},
            {"name": "first_gradient_gap", "value": grad_gap,
             "limit": limits["first_gradient_gap"]},
            {"name": "change_gap", "value": change_gap,
             "limit": limits["change_gap"]}]


def leaf_gaps(program: dict, want: dict) -> tuple:
    """(first gradient gap, change gap), the median leaf's, as
    ``drivers/train_cv.py:compare`` takes them: a leaf's gap of norms
    over the larger of the reference's norm of that leaf and of the
    median leaf's; leaves whose reference first gradient is under a
    thousandth of the median leaf's are left out of the change."""
    g_med = statistics.median(want["grads"].values())
    grad_gap = statistics.median(
        abs(program["grads"].get(n, 0.0) - g) / max(g, g_med)
        for n, g in want["grads"].items())
    moved = [n for n, g in want["grads"].items() if g >= 1e-3 * g_med]
    c_med = statistics.median(want["changes"][n] for n in moved)
    change_gap = statistics.median(
        abs(program["changes"].get(n, 0.0) - want["changes"][n])
        / max(want["changes"][n], c_med) for n in moved)
    return grad_gap, change_gap


def _report(program: dict, want: dict, n: int = 5) -> None:
    """The losses and the leaves with the widest gaps, on standard
    error."""
    import sys
    print(f"losses program {program['losses']} reference {want['losses']}",
          file=sys.stderr)
    for key in ("grads", "changes"):
        med = statistics.median(want[key].values())
        rows = sorted(((abs(program[key].get(k, 0.0) - v) / max(v, med), k,
                        program[key].get(k, 0.0), v)
                       for k, v in want[key].items()), reverse=True)[:n]
        for gap, k, got, ref_ in rows:
            print(f"{key} {k}: program {got:.6g} reference {ref_:.6g} "
                  f"gap {gap:.4g} (median leaf {med:.6g})", file=sys.stderr)
