"""``train cv`` at the daodian recipe: EfficientNet + fc/BN neck + ArcFace.

Set-up first gives torch's and OpenCV's own thread pools the traffic's
``pool_threads`` threads (``pool_threads``), then writes the cell's
synthetic product photos as JPEGs under the
run's temporary directory (a thread pool), builds the table (Zipf labels
with the last class present, each row one of the photos), parses the
recipe's flags with the port's own parser (``cli/parser.py``) and builds
what ``cli/train.py:cmd_train_cv`` builds: the ``ImageClassificationSource``
with the recipe's augmentation, a ``CvImageClassifier`` (drawn on the
device, then loaded with the benchmark's weights from the seed), the cv
task and, through ``cli/train.py:_trainer``, the Trainer with AdamW and
cosine warm restarts. ``Trainer.fit`` then runs once, with the
class-balanced sampler of ``cli/train.py:_sampler_fn``: its first
``warmup_steps`` steps are set-up (the first ``compared_steps`` of them
are the ones the reference follows), the window starts with a
synchronise before the next step and closes at the first step boundary
after ``--seconds``, with a synchronise; the benchmark then ends ``fit``
from its own wrapper of the Trainer's step.

After the window, with the program's state freed, the plain reference
(``reference/efficientnet.py``, float32, TF32 off) follows the first
``compared_steps`` steps from the same weights, the same batches (the
ones the program's source produced, decoded and augmented: the data stage
is followed, and only its labels are checked, against the sampler's draw
worked out again) and the same dropout and drop-path masks (the Trainer's
generator seeded as the Trainer seeds it). It compares the first batch's
BatchNorm statistics after the stem and after the configuration's
``statistics_stage`` (the program's read from the running statistics
after one step), each leaf's first-gradient norm (the program's worked
out from AdamW's first moment after one step) and each leaf's change
after the compared steps, and reports each step's loss.
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
from benchlib.weights import draw
from reference import efficientnet as ref

TABLE, JPEG = 11, 12        # rng_for purposes
# the stem's BatchNorm, whose first-batch statistics are compared (as are
# those of the last BatchNorm of the configuration's ``statistics_stage``)
STEM = "backbone.bn1"
RUNNING = ".running_mean"


class WindowClosed(Exception):
    """Raised from the step wrapper to end ``fit`` when the window is up."""


class Source:
    """The program's source, handed to ``fit`` in its place: it keeps the
    first batches for the reference and times each batch it produces."""

    def __init__(self, inner, spans: Spans, keep: int):
        self.inner, self.spans, self.keep = inner, spans, keep
        self.kept = []

    def __len__(self):
        return len(self.inner)

    def batches(self, *args, **kwargs):
        it = self.inner.batches(*args, **kwargs)
        try:
            while True:
                with self.spans.span("source"):
                    batch = next(it, None)
                if batch is None:
                    return
                if len(self.kept) < self.keep:
                    self.kept.append({k: v.copy() for k, v in batch.items()})
                yield batch
        finally:
            it.close()


def write_inputs(traffic: dict, recipe: dict, seed: int, root: str) -> dict:
    """The table; its JPEGs written under ``root``."""
    rng = gen.rng_for(seed, TABLE)
    n_rows, n_img = traffic["rows"], traffic["images"]
    labels = gen.zipf_with_last(n_rows, recipe["num_classes"], rng,
                                traffic["zipf_exponent"])
    lo, hi = traffic["image_px"]
    sizes = rng.integers(lo, hi + 1, size=n_img)
    names = [f"img{i:05d}" for i in range(n_img)]
    gen.write_jpegs(root, names, sizes, (seed, JPEG),
                    workers=traffic["writer_threads"],
                    quality=traffic["jpeg_quality"])
    flags = recipe["flags"]
    return {flags["key_col"]: [names[i % n_img] for i in range(n_rows)],
            flags["label_col"]: labels.tolist()}


def flag_argv(flags: dict) -> list:
    """The recipe's flags as command-line tokens (``true`` as a bare
    flag), as ``--config`` would inject them."""
    out = []
    for k, v in flags.items():
        if isinstance(v, bool):
            if v:
                out.append(f"--{k}")
        else:
            out.append(f"--{k}={v}")
    return out


def build(cell, opts, table, img_root, out_dir):
    """(trainer, program source, sampler_fn, args): ``cmd_train_cv``'s
    objects over the benchmark's weights."""
    import torch
    from multimodalsimilar_tpu_torch.cli.parser import build_parser
    from multimodalsimilar_tpu_torch.cli.train import _sampler_fn, _trainer
    from multimodalsimilar_tpu_torch.data.datasets import (
        ImageClassificationSource)
    from multimodalsimilar_tpu_torch.models.vision import (CvImageClassifier,
                                                           backbone_config)
    from multimodalsimilar_tpu_torch.ops.arcface import ArcFaceParams
    from multimodalsimilar_tpu_torch.train.tasks import cv_arcface_task
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
    cfg, recipe = cell.config, cell.config["recipe"]
    policy = DTypePolicy()
    if opts.full_precision:
        policy = DTypePolicy.full_precision()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    args = build_parser().parse_args(
        ["train", "cv", "--data", "(the benchmark's table)",
         "--img_root", img_root, "--output", out_dir,
         "--seed", str(opts.seed)] + flag_argv(recipe["flags"]))
    labels = table[args.label_col]
    steps_per_epoch = max(len(labels) // args.batch_size, 1)
    if args.eval_every is None:
        args.eval_every = steps_per_epoch
    if args.save_every is None:
        args.save_every = steps_per_epoch
    src = ImageClassificationSource(
        table, args.img_root, args.key_col, args.label_col, args.image_size,
        train_aug=True, decode_cache=args.decode_cache)
    with torch.device(opts.device):
        model = CvImageClassifier(
            backbone_config(args.backbone, image_size=args.image_size),
            num_labels=int(max(labels)) + 1, fc_dim=args.fc_dim,
            arcface=ArcFaceParams(m=args.margin), policy=policy,
            generator=torch.Generator(device=opts.device))
    weights = ref.finish(draw(ref.param_specs(cfg, recipe["num_classes"]),
                              opts.seed, opts.device))
    model.load_state_dict(weights, strict=True)
    del weights
    model = model.to(memory_format=torch.channels_last)
    trainer = _trainer(cv_arcface_task(model, None), args, steps_per_epoch,
                       opts.device)
    return trainer, src, _sampler_fn(args, table, args.label_col), args


def pool_threads(n: int) -> None:
    """Give torch's and OpenCV's own thread pools ``n`` threads each (the
    recipe's decode threads stay as they are): spare threads of those
    pools crowd the one thread that dispatches the step, and the rate
    follows how busy the host's cores are (PERF.md)."""
    import cv2
    import torch
    torch.set_num_threads(n)
    cv2.setNumThreads(n)


def run(cell, opts) -> dict:
    import torch
    from multimodalsimilar_tpu_torch.ops import arcface as A

    cfg, recipe, traffic = cell.config, cell.config["recipe"], cell.traffic
    pool_threads(traffic["pool_threads"])
    cuda = opts.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spans = Spans(opts.trace)
    work = tempfile.mkdtemp(prefix="bench_train_cv_")
    try:
        opts.log("set-up: program imported")
        table = write_inputs(traffic, recipe, opts.seed,
                             os.path.join(work, "images"))
        opts.log("set-up: JPEGs written")
        trainer, src, sampler_fn, args = build(
            cell, opts, table, os.path.join(work, "images"),
            os.path.join(work, "output"))
        opts.log("set-up: Trainer built")
        return _fit(cell, opts, trainer, src, sampler_fn, args, table,
                    spans, sync, A)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _fit(cell, opts, trainer, src, sampler_fn, args, table, spans, sync, A):
    import torch
    cfg, recipe, traffic = cell.config, cell.config["recipe"], cell.traffic
    warm, compared = traffic["warmup_steps"], traffic["compared_steps"]
    source = Source(src, spans, compared)
    model = trainer.model
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    start = {n: p.detach().clone() for n, p in named.items()}
    inner = trainer.train_step
    if opts.fault == "unchanged":
        trainer.optimizer.step = lambda *a, **k: None
    elif opts.fault not in (None, "half_batch"):
        raise ValueError(f"unknown fault {opts.fault!r}")
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    state = {"n": 0, "t0": None, "starts": [], "losses": [],
             "grad_norms": None, "change_norms": None, "between": None}
    trace = DeviceTrace() if opts.trace else None

    def step(batch):
        n = state["n"] = state["n"] + 1
        if state["between"] is not None:
            spans.end(state["between"])
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
            raise WindowClosed
        if n > warm:
            state["starts"].append(time.perf_counter())
        if opts.fault == "half_batch":
            half = batch["labels"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        with spans.span("step"):
            out = inner(batch)
        if n <= compared:
            state["losses"].append(out["loss"])
        if n == 1:
            state["stats"] = {
                name[:-len(RUNNING)]: (t.clone(), buffers[
                    name[:-len(RUNNING)] + ".running_var"].clone())
                for name, t in buffers.items() if name.endswith(RUNNING)}
            opt_state = trainer.optimizer.state
            state["grad_norms"] = {
                name: (opt_state[p]["exp_avg"].norm() / (1.0 - beta1)
                       if p in opt_state else torch.zeros((), device=p.device))
                for name, p in named.items()}
        if n == compared:
            state["change_norms"] = {name: (p.detach() - start[name]).norm()
                                     for name, p in named.items()}
        state["between"] = spans.begin("fit")
        return out

    trainer.train_step = step
    try:
        trainer.fit(source, args.epochs, args.batch_size, None,
                    sampler_fn=sampler_fn)
        raise RuntimeError("fit ended before the window closed: give the "
                           "table more rows")
    except WindowClosed:
        opts.log(f"window closed after {len(state['starts'])} steps")
    if trace:
        trace.stop()
    window_s = state["t_end"] - state["t0"]
    steps = len(state["starts"])
    launches = A.LAUNCHES["arcface"] - state["launches"]
    memory_peak = torch.cuda.max_memory_allocated(opts.device) \
        if opts.device.type == "cuda" else 0
    mom = cfg["bn_momentum"]
    program = {"stats": {name: (rm.double().cpu() / mom,
                                (rv.double().cpu() - (1.0 - mom)) / mom)
                         for name, (rm, rv) in state["stats"].items()},
               "losses": [float(x) for x in state["losses"]],
               "grads": {k: float(v) for k, v in state["grad_norms"].items()},
               "changes": {k: float(v)
                           for k, v in state["change_norms"].items()}}
    kept = source.kept
    del start, named, buffers, model, state["grad_norms"], \
        state["change_norms"], state["stats"]
    trainer.optimizer.state.clear()
    trainer.model.zero_grad(set_to_none=True)
    trainer.model.to("cpu")
    del trainer
    gc.collect()
    if opts.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(cell, opts, program, kept, table, args)
    opts.log("reference compared")

    batch = args.batch_size
    fwd = flops.efficientnet_forward_flops(
        ref.block_table(cfg),
        ref.make_divisible(cfg["stem_channels"] * cfg["width_mult"]),
        cfg["num_features"], recipe["flags"]["image_size"], cfg["se_ratio"])
    fwd += 2.0 * cfg["num_features"] * cfg["fc_dim"] \
        + flops.arcface_flops(1, recipe["num_classes"], cfg["fc_dim"])
    intervals = np.diff(state["starts"] + [state["t_end"]])
    obs = {"window_s": window_s, "steps": steps,
           "model_flops": 3.0 * fwd * batch * steps,
           "step_p50_s": float(statistics.median(intervals)),
           "arcface_launches": launches,
           "arcface_bound_s": peaks.roofline_s(
               flops.arcface_flops(batch, recipe["num_classes"],
                                   cfg["fc_dim"]),
               flops.arcface_bytes(batch, recipe["num_classes"],
                                   cfg["fc_dim"]))}
    if trace:
        obs["device"] = trace.summary(spans)
    return {"e2e": {"train_examples_per_s": batch * steps / window_s,
                    "setup_s": state["t0"] - opts.t_start},
            "attempted": batch * steps, "failed": 0, "checks": checks,
            "memory_peak_bytes": memory_peak, "obs": obs}


def cosine_lr(lr: float, t0_epochs: int, steps_per_epoch: int,
              count: int) -> float:
    """Cosine annealing with warm restarts every ``t0_epochs`` epochs,
    to 0, at optimizer step ``count``."""
    t0 = t0_epochs * steps_per_epoch
    return 0.5 * lr * (1.0 + np.cos(np.pi * (count % t0) / t0))


def mask_seed(seed: int, step: int) -> int:
    """The Trainer's dropout seed of a micro-step on one device: (seed,
    step) packed in 64 bits."""
    return ((int(seed) << 32) + step) & (2**64 - 1)


def expected_labels(table: dict, args, n: int) -> np.ndarray:
    """The first ``n`` labels the class-balanced sampler draws in epoch
    0: weights 1 / count(label), normalised, drawn with replacement by
    ``numpy.random.default_rng(seed)``."""
    labels = np.asarray(table[args.label_col])
    _, inverse, counts = np.unique(labels, return_inverse=True,
                                   return_counts=True)
    p = np.asarray((1.0 / counts)[inverse], np.float64)
    p = p / p.sum()
    order = np.random.default_rng(args.seed).choice(len(p), size=len(p),
                                                    replace=True, p=p)
    return labels[order[:n]]


def trajectory(P, cfg, recipe, steps_per_epoch, batches, seed, device, q):
    """The reference's first-batch statistics of every BatchNorm, losses,
    first-gradient norms and changes."""
    import torch
    names = ref.trainable(P)
    flags = recipe["flags"]
    wd = {n: 0.0 for n in names}
    opt = ref.AdamW(names)
    start = {n: P[n].detach().clone() for n in names}
    gen_ = torch.Generator(device=device)
    losses, grads = [], None
    stats = {}
    for t, batch in enumerate(batches):
        gen_.manual_seed(mask_seed(seed, t))
        for n in names:
            P[n].requires_grad_(True)
        images = torch.from_numpy(batch["images"]).to(device)
        labels = torch.from_numpy(batch["labels"]).to(device)
        emb = ref.forward(P, cfg, images, ref.Masks(gen_), q,
                          stats if t == 0 else None)
        loss = ref.arcface_loss(emb, P["head.weight"], labels,
                                flags["margin"], recipe["arcface_s"], q)
        g = torch.autograd.grad(loss, [P[n] for n in names])
        losses.append(float(loss.detach()))
        if t == 0:
            grads = {n: float(x.norm()) for n, x in zip(names, g)}
        for n in names:
            P[n] = P[n].detach()
        lr = {n: cosine_lr(flags["head_lr"] if n.startswith("head.")
                           else flags["tower_lr"], flags["t0_epochs"],
                           steps_per_epoch, t) for n in names}
        opt.step(P, dict(zip(names, g)), lr, wd)
    changes = {n: float((P[n] - start[n]).norm()) for n in names}
    stats = {name: tuple(x.double().cpu() for x in v)
             for name, v in stats.items()}
    return {"stats": stats, "losses": losses, "grads": grads,
            "changes": changes}


def judge(cell, opts, program, kept, table, args) -> list:
    import torch
    from reference.bert import fp8
    cfg, recipe = cell.config, cell.config["recipe"]
    limits = cfg["limits"]
    steps_per_epoch = max(len(table[args.label_col]) // args.batch_size, 1)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        specs = ref.param_specs(cfg, recipe["num_classes"])
        want = trajectory(ref.finish(draw(specs, opts.seed, opts.device)),
                          cfg, recipe, steps_per_epoch, kept, opts.seed,
                          opts.device, lambda t: t)
        if opts.control == "fp8":
            program = trajectory(ref.finish(draw(specs, opts.seed,
                                                 opts.device)),
                                 cfg, recipe, steps_per_epoch, kept,
                                 opts.seed, opts.device, fp8)
        elif opts.control is not None:
            raise ValueError(f"unknown control {opts.control!r}")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    got_labels = np.concatenate([b["labels"] for b in kept])
    label_rows = int((got_labels != expected_labels(
        table, args, len(got_labels))).sum())
    report_leaves(program, want)
    return [{"name": "label_rows_differing", "value": float(label_rows),
             "limit": 0.0}] + compare(
        program, want, limits, stage_end(cfg, cfg["statistics_stage"]))


def report_leaves(program: dict, want: dict, n: int = 5) -> None:
    """The losses and the leaves with the widest gaps, on standard
    error."""
    import sys
    gaps = [abs(a - b) / abs(b)
            for a, b in zip(program["losses"], want["losses"])]
    print(f"losses program {program['losses']} reference {want['losses']} "
          f"relative gaps {gaps}", file=sys.stderr)
    last = {}          # the stem, each stage's last BatchNorm, head, neck
    for name in want["stats"]:
        last[name.split(".")[2] if ".blocks." in name else name] = name
    for name in last.values():
        got, ref_ = program["stats"][name], want["stats"][name]
        print(f"statistics {name}: largest {statistics_gap(got, ref_)} "
              f"median {statistics_gap(got, ref_, statistics.median)}",
              file=sys.stderr)
    for key in ("grads", "changes"):
        med = statistics.median(want[key].values())
        rows = sorted(((abs(program[key].get(k, 0.0) - v) / max(v, med), k,
                        program[key].get(k, 0.0), v)
                       for k, v in want[key].items()), reverse=True)[:n]
        for gap, k, got, ref_ in rows:
            print(f"{key} {k}: program {got:.6g} reference {ref_:.6g} "
                  f"gap {gap:.4g} (median leaf {med:.6g})", file=sys.stderr)


def statistics_gap(got: tuple, want: tuple, over=max) -> float:
    """Over the channels (``over``: the largest or the median), the gap
    of a channel's batch mean over the reference's standard deviation or
    of its variance over the reference's variance, whichever is
    larger."""
    import torch
    (pm, pv), (wm, wv) = got, want
    gaps = torch.maximum((pm - wm).abs() / wv.sqrt(), (pv - wv).abs() / wv)
    return float(over(gaps.tolist()))


def stage_end(cfg: dict, stage: int) -> str:
    """The name of the last BatchNorm of ``stage``'s last block."""
    last = [b for b in ref.blocks(cfg) if b["stage"] == stage][-1]
    bn = "bn2" if last["expand"] == 1 else "bn3"
    return f"backbone.blocks.{stage}.{last['index']}.{bn}"


def compare(program: dict, want: dict, limits: dict, stage: str) -> list:
    """The statistics gaps of the first batch, read from the running
    statistics after one step, before backpropagation amplifies rounding
    (``statistics_gap``): the largest channel's of the stem convolution,
    which the first BatchNorm normalises by, and the median channel's of
    the last BatchNorm of ``stage`` (``stage_end``), the deepest the
    forward reaches before it amplifies bf16 rounding as far as fp8's
    (PERF.md); then the first gradient gap and the change gap. A leaf's gap is the gap of its norms over the larger
    of the reference's norm of that leaf and of the median leaf; the number compared is the median leaf's
    gap, since the widest leaf's swings from seed to seed with bf16
    rounding that the network amplifies (PERF.md). Leaves whose
    reference first gradient is under a thousandth of the median leaf's
    are left out of the change, since Adam moves them by round-off
    alone. The steps' losses are reported (``report_leaves``) and not
    compared: no control or fault reads three times their gap (PERF.md).
    """
    stem_gap = statistics_gap(program["stats"][STEM], want["stats"][STEM])
    blocks_gap = statistics_gap(program["stats"][stage],
                                want["stats"][stage], statistics.median)
    g_med = statistics.median(want["grads"].values())
    grad_gap = statistics.median(
        abs(program["grads"].get(n, 0.0) - g) / max(g, g_med)
        for n, g in want["grads"].items())
    moved = [n for n, g in want["grads"].items() if g >= 1e-3 * g_med]
    c_med = statistics.median(want["changes"][n] for n in moved)
    change_gap = statistics.median(
        abs(program["changes"].get(n, 0.0) - want["changes"][n])
        / max(want["changes"][n], c_med) for n in moved)
    return [{"name": "stem_statistics_gap", "value": stem_gap,
             "limit": limits["stem_statistics_gap"]},
            {"name": "blocks_statistics_gap", "value": blocks_gap,
             "limit": limits["blocks_statistics_gap"]},
            {"name": "first_gradient_gap", "value": grad_gap,
             "limit": limits["first_gradient_gap"]},
            {"name": "change_gap", "value": change_gap,
             "limit": limits["change_gap"]}]
