"""Argument parser + entry point (counterpart of
multimodalsimilar_tpu/cli/parser.py): one subcommand tree with every
subcommand, flag and default of the JAX parser, and ``--config`` YAML
preloading read by ``cli/config.py`` (no PyYAML).

``main(argv=None, device="cuda")`` runs a command on the card; the CPU
is asked for with ``main(argv, device="cpu")``, as the tests do (there is
no ``--device`` flag, since the JAX parser has none). Under ``torchrun``
(``WORLD_SIZE`` > 1) ``main`` first joins the process group
(``parallel.mesh.init_distributed``: NCCL with one card a rank, gloo on
the CPU), so ``torchrun --nproc_per_node N -m
multimodalsimilar_tpu_torch.cli train nlp --config
configs/train_nlp_v2_dist.yaml ...`` trains data-parallel over N cards,
and ``train nlp --config configs/train_nlp_large_tp.yaml`` under
``torchrun --nproc_per_node 4`` tensor- and sequence-parallel with
remat, ``configs/train_nlp_large_pp.yaml`` under ``torchrun
--nproc_per_node 2`` pipeline-parallel. ``--pallas_topk`` parses as in
JAX and raises in the commands (the device runs one exact search).
The text embedder's subcommands add the port's own flags ``PORT_ONLY``
(the JAX package has no DeepSeek-V2 tower), whose defaults run the JAX
command.
"""

from __future__ import annotations

import argparse
import os
import sys

from multimodalsimilar_tpu_torch.cli.ckpt import (cmd_eval,
                                                  cmd_export_checkpoint,
                                                  cmd_import_checkpoint)
from multimodalsimilar_tpu_torch.cli.common import _apply_yaml_config
from multimodalsimilar_tpu_torch.cli.embed import (cmd_embed_bulk,
                                                   cmd_embed_incremental)
from multimodalsimilar_tpu_torch.cli.ops import cmd_copy_kv, cmd_download
from multimodalsimilar_tpu_torch.cli.serve import cmd_serve
from multimodalsimilar_tpu_torch.cli.similar import (cmd_similar_daodian,
                                                     cmd_similar_multimodal,
                                                     cmd_similar_nlp)
from multimodalsimilar_tpu_torch.cli.train import (
    cmd_train_cv, cmd_train_fasttext, cmd_train_multilabel,
    cmd_train_multimodal, cmd_train_nlp, cmd_train_pair)

_SEQ_BUCKETS = ("comma list of shorter seq buckets, e.g. 32,48,64 — trim "
                "each batch to the smallest bucket covering its longest row")
_LENGTH_BUCKETS = ("comma list of shorter seq buckets, e.g. 24,48 — sorts "
                   "rows by token length and runs each batch at the "
                   "shortest bucket that fits it. Unset, the float towers "
                   "already cut each sorted batch to its longest row; "
                   "a ladder then only bounds the shapes, and it is what "
                   "gives --int8 short batches")
_EMB_CACHE = ("packed embedding cache directory (pipelines/embcache.py): "
              "one data.bin instead of per-SKU emb.txt files")
# flags of the port alone (dest -> default), on the subcommands that take
# the text embedder's flags: ``similar nlp``, ``embed incremental|bulk``
PORT_ONLY = {"text_tower": "bert", "deepseek_preset": "lite"}

_NOT_PORTED_SEARCH = ("refused: the port has one search, exact on the "
                      "device (csrc/topk.cu)")
_APPROX = ("target recall of the JAX package's approximate TPU search, "
           "0 < R <= 1; the search here is exact, as JAX runs it off a "
           "TPU")


def _add_common_train_flags(p):
    p.add_argument("--config", help="YAML file preloading flags")
    p.add_argument("--data", required=True, help="train csv/parquet")
    p.add_argument("--eval_data", help="eval csv/parquet")
    p.add_argument("--output", default="./output", help="checkpoint dir")
    p.add_argument("--tokenizer",
                   help="vocab.txt of a previous run, or an HF tokenizer "
                        "directory")
    p.add_argument("--text_col", default="spu_name")
    p.add_argument("--label_col", default="labels")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--max_length", type=int, default=128)
    p.add_argument("--tower_lr", type=float, default=5e-5)
    p.add_argument("--head_lr", type=float, default=1e-2)
    p.add_argument("--head_warmup_frac", type=float, default=0.15)
    p.add_argument("--tower_warmup_frac", type=float, default=0.0,
                   help="linear-scheduler warmup fraction for the tower "
                        "group")
    p.add_argument("--optimizer", choices=["adamw", "adamp"],
                   default="adamw",
                   help="adamp = timm recipe (cv_classifier_train.py:68)")
    p.add_argument("--scheduler",
                   choices=["linear", "timm_cosine", "cosine_warm_restarts"],
                   default="linear")
    p.add_argument("--t0_epochs", type=int, default=7,
                   help="cosine_warm_restarts restart period")
    p.add_argument("--warmup_epochs", type=int, default=5,
                   help="timm_cosine warmup_t")
    p.add_argument("--warmup_lr_init", type=float, default=1e-3)
    p.add_argument("--lr_min", type=float, default=0.0)
    p.add_argument("--cooldown_epochs", type=int, default=0,
                   help="epochs past t_initial held at lr_min")
    p.add_argument("--weight_decay", type=float, default=0.0,
                   help="tower group weight decay")
    p.add_argument("--head_weight_decay", type=float, default=0.0)
    p.add_argument("--eval_every", type=int, default=100)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--weighted_sampling", action="store_true")
    p.add_argument("--no_clean", action="store_true",
                   help="tokenize raw titles without preprocess_for_infer "
                        "(the v2/v3 recipes)")
    p.add_argument("--margin", type=float, default=0.4)
    p.add_argument("--margin_delta_per_epoch", type=float, default=0.0)
    p.add_argument("--bert_preset", default="tiny",
                   choices=["tiny", "base", "large"])
    p.add_argument("--fused_loss", action="store_true",
                   help="stream ArcFace+CE over class tiles (wide heads)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize transformer layers in the backward "
                        "pass (torch.utils.checkpoint per layer)")
    p.add_argument("--remat_policy", default="full",
                   choices=["full", "dots"],
                   help="with --remat: 'dots' saves the weight products' "
                        "outputs and recomputes the rest (the attention's "
                        "batched products included)")
    p.add_argument("--remat_skip", type=int, default=0, metavar="K",
                   help="with --remat: leave every K-th transformer layer "
                        "un-rematerialized (0 = remat all)")
    p.add_argument("--async_save", action="store_true",
                   help="periodic checkpoint writes overlap the next steps")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in --output")
    p.add_argument("--overwrite", action="store_true",
                   help="discard existing checkpoints in --output")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="torch.profiler trace of a few steady-state steps "
                        "to DIR")
    p.add_argument("--model_parallel", type=int, default=1, metavar="N",
                   help="shard the ArcFace class weights over N ranks of "
                        "the mesh's model axis (classes padded to a "
                        "multiple of N and masked); the ranks come from "
                        "torchrun")
    p.add_argument("--tensor_parallel", action="store_true",
                   help="Megatron tensor parallelism of the BERT tower over "
                        "the --model_parallel ranks (column-parallel QKV "
                        "and MLP-in, row-parallel attention-out and "
                        "MLP-out, vocab-sharded word table); requires "
                        "--model_parallel N > 1")
    p.add_argument("--sequence_parallel", action="store_true",
                   help="with --tensor_parallel: the tower's residual "
                        "stream in sequence blocks over the model ranks "
                        "(reduce-scatter and all-gather in place of the "
                        "all-reduces)")
    p.add_argument("--pipeline_parallel", type=int, default=0, metavar="M",
                   help="GPipe pipeline parallelism of the BERT tower over "
                        "the --model_parallel axis with M microbatches per "
                        "step (bubble (P-1)/(M+P-1)): each rank builds and "
                        "holds num_layers/N layers' params + Adam moments. "
                        "Alternative to --tensor_parallel (mutually "
                        "exclusive); requires --model_parallel N > 1 "
                        "dividing num_layers; the per-chip batch must "
                        "divide by M. Checkpoints are in the one-card "
                        "layout")
    p.add_argument("--grad_accum", type=int, default=1, metavar="K",
                   help="accumulate grads over K micro-batches before each "
                        "optimizer step")
    p.add_argument("--bf16_grads", action="store_true",
                   help="all-reduce data-parallel gradients in bfloat16 "
                        "(per-shard BatchNorm statistics); not with "
                        "--model_parallel")
    p.add_argument("--seed", type=int, default=0)


def _add_text_embedder_flags(p, max_length: int):
    """The text tower flags of the embed and similar jobs."""
    p.add_argument("--tokenizer")
    p.add_argument("--checkpoint")
    p.add_argument("--bert_preset", default="tiny")
    p.add_argument("--num_labels", type=int, default=2)
    p.add_argument("--pool", default="cls", choices=["cls", "mean"],
                   help="must match the trained model")
    p.add_argument("--max_length", type=int, default=max_length)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--length_buckets", default=None, help=_LENGTH_BUCKETS)
    p.add_argument("--text_tower", default=PORT_ONLY["text_tower"],
                   choices=["bert", "deepseek_v2_lite"],
                   help="bert: the BERT/RoBERTa tower of --bert_preset; "
                        "deepseek_v2_lite: the DeepSeek-V2 decoder "
                        "(models/deepseek_v2.py) of --deepseek_preset or of "
                        "the published checkpoint directory --checkpoint, "
                        "bfloat16 weights, masked-mean pooling (--pool is "
                        "not read)")
    p.add_argument("--deepseek_preset", default=PORT_ONLY["deepseek_preset"],
                   choices=["lite", "tiny"],
                   help="the DeepSeek-V2 tower's size without --checkpoint "
                        "(seed-0 weights): lite = DeepSeek-V2-Lite, tiny "
                        "for tests")


def _add_image_flags(p, image_size: int = 512):
    p.add_argument("--img_root", default="./goodssku_image_2")
    p.add_argument("--backbone", default="efficientnet_b4")
    p.add_argument("--fc_dim", type=int, default=512)
    p.add_argument("--image_size", type=int, default=image_size)


def _add_int8(p):
    p.add_argument("--int8", action="store_true",
                   help="int8 weight + dynamic-activation PTQ for the text "
                        "tower (models/quant.py): int8 products through "
                        "torch._int_mm on the card; its speed against the "
                        "bf16 default is in PERF.md")


def _add_kv_flags(p, exp_seconds=7 * 24 * 3600, exp_help=None):
    p.add_argument("--redis_host", default=None)
    p.add_argument("--redis_port", type=int, default=6379)
    p.add_argument("--redis_db", type=int, default=15)
    p.add_argument("--redis_password", default=None)
    p.add_argument("--exp_seconds", type=int, default=exp_seconds,
                   help=exp_help)


def _add_search_flags(p):
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="torch.profiler trace of the job to DIR")
    p.add_argument("--pallas_topk", action="store_true",
                   help=_NOT_PORTED_SEARCH)
    p.add_argument("--approx_recall", type=float, default=None,
                   metavar="R", help=_APPROX)


def _add_train(sub):
    train = sub.add_parser("train", allow_abbrev=False).add_subparsers(
        dest="model", required=True)
    t_nlp = train.add_parser("nlp", allow_abbrev=False)
    _add_common_train_flags(t_nlp)
    t_nlp.add_argument("--pool", default="cls", choices=["cls", "mean"],
                       help="cls = TransformerEmb pooler; mean = "
                            "TransformerSeqEmb masked mean")
    t_nlp.add_argument("--seq_buckets", default=None, help=_SEQ_BUCKETS)
    t_nlp.set_defaults(fn=cmd_train_nlp)

    t_ml = train.add_parser("multilabel", allow_abbrev=False)
    _add_common_train_flags(t_ml)
    t_ml.add_argument("--lv1_col", default="lv1_category_id")
    t_ml.add_argument("--seq_buckets", default=None, help=_SEQ_BUCKETS)
    t_ml.add_argument("--lv2_col", default="lv2_category_id")
    t_ml.add_argument("--tag_col", default="tag_new_id")
    t_ml.add_argument("--lv1_weight", type=float, default=10.0)
    t_ml.add_argument("--lv2_weight", type=float, default=5.0)
    t_ml.add_argument("--tag_weight", type=float, default=1.0)
    t_ml.set_defaults(fn=cmd_train_multilabel)

    t_cv = train.add_parser("cv", allow_abbrev=False)
    _add_common_train_flags(t_cv)
    # the cv daodian reference evaluates and checkpoints once per EPOCH
    # (cv_classifier_train_daodian.py:283,298-306)
    t_cv.set_defaults(eval_every=None, save_every=None)
    t_cv.add_argument("--img_root", required=True)
    t_cv.add_argument("--key_col", default="goods_sku")
    t_cv.add_argument("--image_size", type=int, default=512)
    t_cv.add_argument("--fc_dim", type=int, default=512)
    t_cv.add_argument("--backbone", default="efficientnet_b4")
    t_cv.add_argument("--decode_cache", default=None,
                      help="directory for a resized-uint8 decode cache")
    t_cv.set_defaults(fn=cmd_train_cv, margin=0.2,
                      margin_delta_per_epoch=0.04, label_col="tag_new_id")

    t_pair = train.add_parser("pair", allow_abbrev=False)
    _add_common_train_flags(t_pair)
    t_pair.add_argument("--seq_buckets", default=None,
                        help="shared seq buckets for both pair sides")
    # one AdamW at 1e-3 over all params, warmup 0.25 of the run
    # (nlp_st_train_daodian.py:152-156)
    t_pair.set_defaults(fn=cmd_train_pair, tower_lr=1e-3, head_lr=1e-3,
                        tower_warmup_frac=0.25, head_warmup_frac=0.25)

    t_mm = train.add_parser("multimodal", allow_abbrev=False)
    _add_common_train_flags(t_mm)
    t_mm.add_argument("--img_root", required=True)
    t_mm.add_argument("--key_col", default="spu_sn")
    t_mm.add_argument("--image_size", type=int, default=380)
    t_mm.add_argument("--fc_dim", type=int, default=512)
    t_mm.add_argument("--backbone", default="efficientnet_b4")
    t_mm.add_argument("--decode_cache", default=None,
                      help="directory for a resized-uint8 decode cache")
    t_mm.add_argument("--seq_buckets", default=None,
                      help="comma list of shorter text seq buckets")
    t_mm.set_defaults(fn=cmd_train_multimodal, batch_size=48, margin=0.5)

    t_ft = train.add_parser("fasttext", allow_abbrev=False)
    t_ft.add_argument("--config")
    t_ft.add_argument("--data", required=True)
    t_ft.add_argument("--eval_data")
    t_ft.add_argument("--output", default="./output")
    t_ft.add_argument("--text_col", default="text")
    t_ft.add_argument("--label_col", default="label")
    t_ft.add_argument("--dim", type=int, default=100)
    t_ft.add_argument("--lr", type=float, default=0.1)
    t_ft.add_argument("--epochs", type=int, default=5)
    t_ft.add_argument("--chain_steps", type=int, default=None, metavar="K",
                      help="the JAX package's steps per compiled program; "
                           "the port takes one step per iteration")
    t_ft.set_defaults(fn=cmd_train_fasttext)


def _add_embed(sub):
    emb = sub.add_parser("embed", allow_abbrev=False).add_subparsers(
        dest="mode", required=True)
    e_inc = emb.add_parser("incremental", allow_abbrev=False)
    e_inc.add_argument("--config")
    e_inc.add_argument("--kind", default="text",
                       choices=["text", "cv", "fasttext"])
    e_inc.add_argument("--fasttext_model",
                       help="fastText model saved by train fasttext "
                            "(kind=fasttext)")
    e_inc.add_argument("--data", required=True)
    e_inc.add_argument("--table", required=True,
                       help="parquet table path, or hive://db.table on a "
                            "cluster host (Spark INSERT OVERWRITE)")
    e_inc.add_argument("--dt", default=None)
    e_inc.add_argument("--key_col", default="goods_sku")
    e_inc.add_argument("--text_col", default="spu_name")
    _add_text_embedder_flags(e_inc, 80)
    _add_image_flags(e_inc)
    _add_int8(e_inc)
    e_inc.add_argument("--emb_cache", default=None, metavar="DIR",
                       help=_EMB_CACHE)
    e_inc.set_defaults(fn=cmd_embed_incremental)

    e_bulk = emb.add_parser("bulk", allow_abbrev=False)
    e_bulk.add_argument("--config")
    e_bulk.add_argument("--data", required=True)
    e_bulk.add_argument("--table", required=True)
    e_bulk.add_argument("--key_col", default="goods_sku")
    e_bulk.add_argument("--text_col", default="spu_name")
    _add_text_embedder_flags(e_bulk, 80)
    e_bulk.add_argument("--kinds", default="bert",
                        help="comma list: bert,fasttext,cv")
    e_bulk.add_argument("--fasttext_model",
                        help="fastText model saved by train fasttext "
                             "(kind=fasttext)")
    _add_image_flags(e_bulk)
    _add_int8(e_bulk)
    e_bulk.set_defaults(fn=cmd_embed_bulk)


def _add_similar(sub):
    sim = sub.add_parser("similar", allow_abbrev=False).add_subparsers(
        dest="mode", required=True)
    s_nlp = sim.add_parser("nlp", allow_abbrev=False)
    s_nlp.add_argument("--config")
    s_nlp.add_argument("--data", required=True)
    s_nlp.add_argument("--dt", default=None)
    s_nlp.add_argument("--key_col", default="spu_sn")
    s_nlp.add_argument("--text_col", default="spu_name")
    _add_text_embedder_flags(s_nlp, 128)
    s_nlp.add_argument("--k", type=int, default=13)
    s_nlp.add_argument("--score_th", type=float, default=0.9)
    _add_kv_flags(s_nlp)
    _add_search_flags(s_nlp)
    _add_int8(s_nlp)
    s_nlp.set_defaults(fn=cmd_similar_nlp)

    s_mm = sim.add_parser("multimodal", allow_abbrev=False)
    s_mm.add_argument("--config")
    s_mm.add_argument("--data", required=True,
                      help="table with spu_sn + fused embedding strings")
    s_mm.add_argument("--embedding_col", default="multimodal_emb")
    s_mm.add_argument("--checkpoint",
                      help="multimodal checkpoint: compute fused "
                           "embeddings in-process (multimodal_infer.py "
                           "pattern)")
    s_mm.add_argument("--tokenizer")
    s_mm.add_argument("--text_col", default="spu_name")
    _add_image_flags(s_mm, 380)
    s_mm.add_argument("--bert_preset", default="tiny")
    s_mm.add_argument("--num_labels", type=int, default=2)
    s_mm.add_argument("--max_length", type=int, default=128)
    s_mm.add_argument("--batch_size", type=int, default=48)
    s_mm.add_argument("--key_col", default="spu_sn")
    s_mm.add_argument("--k", type=int, default=13)
    _add_kv_flags(s_mm)
    _add_search_flags(s_mm)
    s_mm.set_defaults(fn=cmd_similar_multimodal)

    s_dd = sim.add_parser("daodian", allow_abbrev=False)
    s_dd.add_argument("--config")
    s_dd.add_argument("--data", required=True)
    s_dd.add_argument("--dt", default=None)
    s_dd.add_argument("--date_keyed", action="store_true",
                      help="v2 semantics: write {yyyymmdd}:{spu_sn} keys")
    s_dd.add_argument("--dt_col", default=None,
                      help="v2_recent_days: column holding each row's dt; "
                           "with --date_keyed, only neighbors whose dt "
                           "equals --dt survive and retrieval depth scales "
                           "to len(area)/recent_days")
    s_dd.add_argument("--recent_days", type=int, default=7,
                      help="v2 history window length (days of corpus)")
    s_dd.add_argument("--text_only", action="store_true",
                      help="explicitly run without the CV side")
    s_dd.add_argument("--fasttext_model", required=True,
                      help="fastText model saved by train fasttext")
    s_dd.add_argument("--cv_checkpoint", default=None)
    s_dd.add_argument("--cv_num_labels", type=int, default=4181)
    s_dd.add_argument("--backbone", default="efficientnet_b4")
    s_dd.add_argument("--fc_dim", type=int, default=512)
    s_dd.add_argument("--image_size", type=int, default=512)
    s_dd.add_argument("--img_root", default="./goodssku_image_2")
    s_dd.add_argument("--key_col", default="spu_sn")
    s_dd.add_argument("--sku_col", default="sku")
    _add_kv_flags(s_dd, None, "KV TTL; default 7d for v1 keys, 1.5d when "
                              "--date_keyed (daodian_infer_v2_*.py:342)")
    _add_search_flags(s_dd)
    s_dd.add_argument("--emb_cache", default=None, metavar="DIR",
                      help=_EMB_CACHE)
    s_dd.set_defaults(fn=cmd_similar_daodian)


def _add_serve(sub):
    srv = sub.add_parser("serve", allow_abbrev=False)
    srv.add_argument("--config")
    srv.add_argument("--tower", default="bert",
                     choices=["bert", "cv", "multimodal", "fasttext",
                              "daodian"],
                     help="bert: text queries; cv: image queries; "
                          "multimodal: text+image pairs, un-normalized L2; "
                          "fasttext: the daodian text arm; daodian: both "
                          "daodian arms, merged per key")
    srv.add_argument("--data", required=True,
                     help="corpus table (csv/parquet/hive://db.table)")
    srv.add_argument("--key_col", default="spu_sn")
    srv.add_argument("--text_col", default="spu_name")
    srv.add_argument("--category_col", default=None,
                     help="corpus category column: requests passing "
                          "'category' keep only same-category neighbors")
    srv.add_argument("--tokenizer")
    srv.add_argument("--checkpoint")
    srv.add_argument("--bert_preset", default="tiny")
    srv.add_argument("--num_labels", type=int, default=2)
    srv.add_argument("--pool", default="cls", choices=["cls", "mean"],
                     help="must match the trained model")
    srv.add_argument("--max_length", type=int, default=128)
    srv.add_argument("--batch_size", type=int, default=64,
                     help="device batch the micro-batches pad to")
    srv.add_argument("--length_buckets", default=None,
                     help=_LENGTH_BUCKETS)
    srv.add_argument("--k", type=int, default=13)
    srv.add_argument("--score_th", type=float, default=None,
                     help="default score threshold (requests may override "
                          "with 'score_th', null disables). Unset, each "
                          "tower uses its reference job's operating "
                          "point: bert 0.9, cv 0.15, fasttext -0.6, "
                          "multimodal none")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8476,
                     help="0 picks a free port (printed on the ready line)")
    srv.add_argument("--max_batch", type=int, default=64,
                     help="max requests coalesced into one device call")
    srv.add_argument("--emb_table", default=None,
                     help="warm-start the corpus from a precomputed "
                          "embedding table (key_col + '[x,y,...]' "
                          "strings; csv/parquet/hive://db.table)")
    srv.add_argument("--emb_col", default="embedding",
                     help="embedding column in --emb_table")
    srv.add_argument("--emb_table_cache", default=None, metavar="DIR",
                     help="restart cache for --emb_table (an npy mirror, "
                          "mtime-validated)")
    srv.add_argument("--max_wait_ms", type=float, default=5.0,
                     help="how long the device worker waits for more "
                          "requests after the first")
    srv.add_argument("--pallas_topk", action="store_true",
                     help=_NOT_PORTED_SEARCH)
    srv.add_argument("--approx_recall", type=float, default=None,
                     metavar="R", help=_APPROX)
    _add_int8(srv)
    _add_image_flags(srv)
    srv.add_argument("--emb_cache", default=None, metavar="DIR",
                     help=_EMB_CACHE)
    srv.add_argument("--fasttext_model",
                     help="fastText model saved by train fasttext "
                          "(--tower fasttext and daodian)")
    srv.add_argument("--area_col", default="area_id",
                     help="daodian: per-area retrieval column")
    srv.add_argument("--sku_col", default="sku",
                     help="daodian: goods_sku column naming the image "
                          "folder for the CV arm")
    srv.add_argument("--cv_checkpoint", default=None,
                     help="daodian: checkpoint of the CV arm's tower")
    srv.add_argument("--cv_num_labels", type=int, default=4181,
                     help="daodian: CV checkpoint head width")
    srv.add_argument("--text_only", action="store_true",
                     help="daodian: explicitly serve without the CV arm")
    srv.add_argument("--nlp_score_th", type=float, default=-0.6,
                     help="daodian: text-arm score threshold")
    srv.add_argument("--cv_score_th", type=float, default=0.15,
                     help="daodian: CV-arm score threshold")
    srv.add_argument("--ann_cnt_nlp", type=int, default=100,
                     help="daodian: text-arm retrieval depth")
    srv.add_argument("--ann_cnt_cv", type=int, default=26,
                     help="daodian: CV-arm retrieval depth")
    srv.set_defaults(fn=cmd_serve)


def _add_ops_and_checkpoints(sub):
    ckv = sub.add_parser("copy-kv", allow_abbrev=False)
    ckv.add_argument("--config")
    ckv.add_argument("--src_host", required=True)
    ckv.add_argument("--src_port", type=int, default=6379)
    ckv.add_argument("--src_db", type=int, default=0)
    ckv.add_argument("--dst_host", required=True)
    ckv.add_argument("--dst_port", type=int, default=6379)
    ckv.add_argument("--dst_db", type=int, default=0)
    ckv.add_argument("--redis_password", default=None)
    ckv.add_argument("--pattern", default="*")
    ckv.add_argument("--exp_seconds", type=int, default=7 * 24 * 3600)
    ckv.set_defaults(fn=cmd_copy_kv)

    ev = sub.add_parser("eval", allow_abbrev=False)
    ev.add_argument("--config")
    ev.add_argument("--data", required=True)
    ev.add_argument("--checkpoint")
    ev.add_argument("--tokenizer")
    ev.add_argument("--text_col", default="spu_name")
    ev.add_argument("--label_col", default="labels")
    ev.add_argument("--max_length", type=int, default=128)
    ev.add_argument("--batch_size", type=int, default=256)
    ev.add_argument("--num_labels", type=int, default=None,
                    help="the TRAINING class count, for a head padded past "
                         "it (pad classes are masked like the in-loop "
                         "eval). Default: derived from this split")
    ev.add_argument("--pool", default="cls", choices=["cls", "mean"],
                    help="must match the trained model")
    ev.add_argument("--seq_buckets", default=None,
                    help="comma list of shorter seq buckets, e.g. 48,64")
    ev.add_argument("--bert_preset", default="tiny")
    ev.set_defaults(fn=cmd_eval)

    kinds = ["nlp", "multilabel", "siamese", "cv", "multimodal"]
    imp = sub.add_parser("import-checkpoint", allow_abbrev=False)
    imp.add_argument("--config")
    imp.add_argument("--kind", required=True, choices=kinds)
    imp.add_argument("--state_dict", required=True,
                     help="torch state_dict .pt file")
    imp.add_argument("--out", required=True, help="checkpoint dir")
    imp.add_argument("--bert_preset", default="base")
    imp.add_argument("--backbone", default="efficientnet_b4")
    imp.add_argument("--overwrite", action="store_true",
                     help="clear an already-populated --out dir")
    imp.add_argument("--pipeline_parallel", type=int, default=0,
                     metavar="M",
                     help="accepted for the text kinds for symmetry with "
                          "the JAX command: the checkpoint is in the "
                          "one-card layout, which `train ... "
                          "--pipeline_parallel` runs load as it is (any "
                          "value > 0)")
    imp.set_defaults(fn=cmd_import_checkpoint)

    exp = sub.add_parser("export-checkpoint", allow_abbrev=False)
    exp.add_argument("--config")
    exp.add_argument("--kind", required=True, choices=kinds)
    exp.add_argument("--checkpoint", required=True, help="checkpoint dir")
    exp.add_argument("--out", required=True,
                     help="output torch state_dict .pt file")
    exp.add_argument("--bert_preset", default="base")
    exp.add_argument("--backbone", default="efficientnet_b4")
    exp.set_defaults(fn=cmd_export_checkpoint)

    dl = sub.add_parser("download", allow_abbrev=False)
    dl.add_argument("--config")
    dl.add_argument("--manifest", required=True,
                    help="csv with key/img_id/url columns")
    dl.add_argument("--out_root", required=True)
    dl.add_argument("--key_col", default="goods_sku")
    dl.add_argument("--img_id_col", default="img_id")
    dl.add_argument("--url_col", default="url")
    dl.add_argument("--threads", type=int, default=20)
    dl.set_defaults(fn=cmd_download)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("multimodalsimilar_tpu_torch",
                                allow_abbrev=False)
    sub = p.add_subparsers(dest="cmd", required=True)
    _add_train(sub)
    _add_embed(sub)
    _add_similar(sub)
    _add_serve(sub)
    _add_ops_and_checkpoints(sub)
    return p


def _subparser_for(parser, argv):
    """The (possibly nested — ``train nlp``) subparser the leading
    positional tokens select; None if the path is absent or unknown
    (argparse will produce its own error for those)."""
    node = parser
    for tok in argv:
        if tok.startswith("-"):
            break                       # flags end the command path
        nxt = None
        for action in node._actions:
            if isinstance(action, argparse._SubParsersAction):
                nxt = action.choices.get(tok)
                break
        if nxt is None:
            return None
        node = nxt
    return node if node is not parser else None


def _inject_yaml_argv(argv, parser):
    """Expand ``--config file.yaml`` into argv tokens BEFORE parsing, so a
    YAML file can satisfy required flags (--data, --table, ...). Explicit
    flags still win: keys already present in argv are not injected.

    Keys are validated against the selected subcommand's known flags
    first (a mistyped key dies with the unknown-flags error, not
    argparse's 'unrecognized arguments'); values inject in ``--key=value``
    form so a string value starting with '-' is not read as a flag; a
    ``true`` injects the bare flag and a list its comma form."""
    cfg_path = None
    for i, tok in enumerate(argv):
        if tok == "--config" and i + 1 < len(argv):
            cfg_path = argv[i + 1]
        elif tok.startswith("--config="):
            cfg_path = tok.split("=", 1)[1]
    if not cfg_path:
        return argv
    from multimodalsimilar_tpu_torch.cli.config import load_config
    cfg = load_config(cfg_path)
    sub = _subparser_for(parser, argv)
    if sub is not None:
        known = sub._option_string_actions
        unknown = [k for k in cfg if f"--{k}" not in known]
        if unknown:
            raise SystemExit(f"--config {cfg_path}: unknown flags "
                             f"{unknown}")
    extra = []
    for k, v in cfg.items():
        explicit = any(t == f"--{k}" or t.startswith(f"--{k}=")
                       for t in argv)
        if explicit or v is None or k == "config":
            continue
        if isinstance(v, bool):
            if v:
                extra.append(f"--{k}")
        elif isinstance(v, (list, tuple)):
            extra.append(f"--{k}=" + ",".join(str(x) for x in v))
        else:
            extra.append(f"--{k}={v}")
    return list(argv) + extra


def main(argv=None, device="cuda"):
    """Parse ``argv`` (default ``sys.argv[1:]``) and run its command on
    ``device``; a bad-input error (``InputError``) ends as one line.
    ``--profile DIR`` traces a whole non-train command with
    ``torch.profiler`` (the train commands trace a steady-state window
    themselves). Returns what the command returns."""
    from multimodalsimilar_tpu_torch.data.datasets import InputError
    argv = argv if argv is not None else sys.argv[1:]
    parser = build_parser()
    argv = _inject_yaml_argv(argv, parser)
    args = parser.parse_args(argv)
    _apply_yaml_config(args, argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from multimodalsimilar_tpu_torch.parallel.mesh import (
            init_distributed)
        init_distributed(device)
    profile = getattr(args, "profile", None)
    try:
        if profile and not args.fn.__name__.startswith("cmd_train"):
            from multimodalsimilar_tpu_torch.utils.profiling import trace
            with trace(profile):
                return args.fn(args, device=device)
        return args.fn(args, device=device)
    except InputError as e:
        # narrow on purpose: only bad-input errors collapse to one line —
        # anything else keeps its traceback for debugging
        raise SystemExit(f"error: {e}")
