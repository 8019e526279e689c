"""Command-line interface of the port (counterpart of
multimodalsimilar_tpu/cli): one entry point, subcommands per job family,
the JAX package's subcommands and flags.

    python -m multimodalsimilar_tpu_torch.cli train nlp --data train.csv ...
    python -m multimodalsimilar_tpu_torch.cli similar nlp \\
        --config configs/similar_nlp.yaml --data titles.csv ...
    python -m multimodalsimilar_tpu_torch.cli serve --config configs/serve.yaml

Commands run on the CUDA card; ``main(argv, device="cpu")`` runs them on
the CPU. YAML config files preload any subcommand's flags (``--config``,
read without PyYAML). Importing the package imports no pandas, PyYAML,
redis, pyspark or transformers: each is imported by the command that
needs it. Functions resolve their helpers through their own submodule's
globals, so tests monkeypatch the submodule (``cli.similar._kv_sink``),
not this package namespace.
"""

from multimodalsimilar_tpu_torch.cli.ckpt import (cmd_eval,
                                                  cmd_export_checkpoint,
                                                  cmd_import_checkpoint)
from multimodalsimilar_tpu_torch.cli.embed import (cmd_embed_bulk,
                                                   cmd_embed_incremental)
from multimodalsimilar_tpu_torch.cli.ops import cmd_copy_kv, cmd_download
from multimodalsimilar_tpu_torch.cli.parser import build_parser, main
from multimodalsimilar_tpu_torch.cli.serve import cmd_serve
from multimodalsimilar_tpu_torch.cli.similar import (cmd_similar_daodian,
                                                     cmd_similar_multimodal,
                                                     cmd_similar_nlp)
from multimodalsimilar_tpu_torch.cli.train import (
    cmd_train_cv, cmd_train_fasttext, cmd_train_multilabel,
    cmd_train_multimodal, cmd_train_nlp, cmd_train_pair)

__all__ = ["build_parser", "main", "cmd_copy_kv", "cmd_download",
           "cmd_embed_bulk", "cmd_embed_incremental", "cmd_eval",
           "cmd_export_checkpoint", "cmd_import_checkpoint", "cmd_serve",
           "cmd_similar_daodian", "cmd_similar_multimodal",
           "cmd_similar_nlp", "cmd_train_cv", "cmd_train_fasttext",
           "cmd_train_multilabel", "cmd_train_multimodal", "cmd_train_nlp",
           "cmd_train_pair"]
