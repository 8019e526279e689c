"""``serve --tower bert|cv|multimodal|fasttext|daodian`` — the online
similarity daemons (counterpart of multimodalsimilar_tpu/cli/serve.py):
build the hot service, warm every path a request can take, bind the HTTP
server. With the ``--emb_table`` corpus warm start from the nightly
embedding export.

* bert: the text tower; inner product on normalized rows.
* cv: the folded image tower over the reference's image layout
  ({img_root}/{key}/0..7.jpg, averaged; emb.txt and ``--emb_cache``
  respected); queries are decoded uint8 images (ImageQueryParser).
* multimodal: the checkpointed fused tower over (text_col,
  {img_root}/{key}.jpg) rows; search is UN-normalized squared L2
  (multimodal_infer.py:140-145 IndexFlatL2), so scores ascend and a
  request's score_th is a max distance.
* fasttext: the daodian job's text arm online — ``--fasttext_model``
  sentence vectors (d=100), inner product on normalized rows; corpus
  titles from text_col, or ``gen_title`` when the column is absent.
* daodian: both daodian arms hot in one ``DaodianService``
  (``_build_daodian_service``, ``_serve_daodian``): a key's answer is the
  nightly v1 job's merged list, an ad-hoc query gets the same rules.

``_service_from_corpus`` is the tail every tower shares: the engine, the
fused tower -> normalize -> top-k path and its fallbacks, the
``SimilarityService``; callers that embed the corpus themselves build the
service through it too.

As in ``cli/train.py``, the functions take the ``argparse.Namespace`` the
JAX package's ``serve`` parser builds (``configs/serve*.yaml``'s values);
the port's own parser comes with its CLI (ROADMAP A15).
``--pallas_topk`` raises ``NotImplementedError``; ``--approx_recall``
serves the exact search after a notice (``cli/common.py``). pandas and pyarrow
are imported only by the ``--emb_table`` functions and ``read_table``:
pass ``table=`` to build a service without them.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from multimodalsimilar_tpu_torch.cli.common import (_emb_cache,
                                                    _knn_backend_mesh,
                                                    _load_fasttext)
from multimodalsimilar_tpu_torch.cli.embedders import (
    _build_text_embedder, _cv_embedder, _embed_fn_from_embedder,
    _fused_embeddings, _image_paths, _load_cv_tower, _multimodal_embedder,
    _no_readable_images, fused_embeddings_by_block)
from multimodalsimilar_tpu_torch.cli.similar import _gen_titles, _sku_to_spusn
from multimodalsimilar_tpu_torch.data.datasets import column
from multimodalsimilar_tpu_torch.pipelines.similar import (
    embed_keys_sharded, embed_sharded, table_columns)
from multimodalsimilar_tpu_torch.utils.devices import resolve_device

# Per-tower default thresholds = the reference jobs' own operating points:
# bert 0.9 (nlp_infer.py:152,163), cv 0.15 / fasttext -0.6
# (daodian_infer.py:79-82), multimodal None (multimodal_infer.py:147-159
# applies no threshold to its L2 top-13).
_SERVE_SCORE_TH = {"bert": 0.9, "cv": 0.15, "fasttext": -0.6,
                   "multimodal": None}


def _serve_score_th(args):
    if args.score_th is None:   # flag unset -> the tower's reference point
        return _SERVE_SCORE_TH[args.tower]
    return args.score_th


def _serve_warm_payload(args):
    """The one warm query of ``args.tower`` — used by the pre-traffic
    warm-up ladder AND the fused-path rebuild (service._warm_payload), so
    the two can never drift on payload shape: a title, a zero uint8
    [S, S, 3] image, or a (title, image) pair."""
    if args.tower in ("cv", "multimodal"):
        warm = np.zeros((args.image_size, args.image_size, 3), np.uint8)
        return warm if args.tower == "cv" else ("warmup", warm)
    return "warmup"


def _world() -> tuple:
    """(this process's rank, the ranks) of the process group; (0, 1)
    without one."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _columns(table) -> list:
    return list(table.columns) if hasattr(table, "columns") else list(table)


def _build_serve_service(args, table=None, device="cuda"):
    """(SimilarityService, corpus_rows) for ``serve --tower
    bert|cv|multimodal|fasttext`` on ``device``. ``table`` (a DataFrame
    or a ``{column: list}`` mapping) replaces reading ``args.data``.

    Over several ranks (``torchrun``) every rank calls it with the same
    table: the engine holds this rank's block of the corpus, each rank
    embeds its own block of rows (fastText embeds every row on every
    rank), and global rank 0 gets the service while every other rank gets
    a ``Follower`` in its place (``pipelines/sharded_serving.py``)."""
    dev = resolve_device(device)
    if args.tower == "daodian":
        raise ValueError("serve --tower daodian has its own service: "
                         "_build_daodian_service")
    mesh = _knn_backend_mesh(args)
    if table is None:
        from multimodalsimilar_tpu_torch.data.datasets import read_table
        table = read_table(args.data)
    cols = _columns(table)
    need = ([args.key_col] if args.tower in ("cv", "fasttext")
            else [args.text_col, args.key_col])
    for col in need:
        if col not in cols:
            raise SystemExit(f"column {col!r} not in {args.data} "
                             f"(has: {cols})")
    if not len(column(table, args.key_col)):
        raise SystemExit("--data table is empty — nothing to serve")
    cats = None
    if args.category_col:
        if args.category_col not in cols:
            raise SystemExit(f"--category_col {args.category_col!r} not in "
                             f"{args.data} (has: {cols})")
        cats = column(table, args.category_col)
    t0 = time.perf_counter()
    metric, normalize, parser = "ip", True, None
    if args.tower == "cv":
        (embed_queries, parser, keys, emb, cats,
         embedder) = _serve_cv_corpus(args, table, cats, dev, mesh)
    elif args.tower == "multimodal":
        (embed_queries, parser, keys, emb, cats,
         embedder) = _serve_multimodal_corpus(args, table, cats, dev,
                                              mesh)
        # the fused job searches UN-normalized squared L2
        # (multimodal_infer.py:140-145 IndexFlatL2) — scores ascend, and
        # a request's score_th means "max distance"
        metric, normalize = "l2", False
    elif args.tower == "fasttext":
        embed_queries, keys, emb = _serve_fasttext_corpus(args, table, dev)
        embedder = None
    else:
        embedder = _build_text_embedder(args, df=table, device=dev)
        embed_queries = _embed_fn_from_embedder(embedder)
        keys = [str(k) for k in column(table, args.key_col)]
        texts = [str(t) for t in column(table, args.text_col)]

        def embed_bulk(tt):
            # the corpus pass at a bulk batch, not the serving micro-batch
            bulk = max(args.batch_size, 512)
            if len(tt) >= 4 * bulk and bulk != embedder.batch_size:
                serve_bs = embedder.batch_size
                embedder.batch_size = bulk
                try:
                    return embed_queries(tt)
                finally:
                    embedder.batch_size = serve_bs
            return embed_queries(tt)

        def embed_corpus(tt):
            return embed_sharded(mesh, len(tt), lambda rows: embed_bulk(
                [tt[i] for i in rows]), dev)

        emb = _corpus_with_emb_table(args, keys, texts, embed_corpus)
    print(f"corpus embedded: {len(keys)} rows in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    service = _service_from_corpus(args, emb, keys, cats, embed_queries,
                                   embedder, parser=parser, metric=metric,
                                   normalize=normalize, device=dev,
                                   mesh=mesh)
    return service, len(keys)


def _service_from_corpus(args, emb, keys, cats, embed_queries, embedder,
                         parser=None, metric="ip", normalize=True,
                         device="cuda", mesh=None):
    """The ``SimilarityService`` over an embedded corpus (``emb`` rows
    follow ``keys`` and ``cats``): the engine on ``device``, and, when a
    device ``embedder`` is given and ``--max_batch`` fits its batch, the
    best path — the whole request (tower(s) [+ norm-concat fusion] ->
    normalize -> exact top-k) chained on the worker's stream per pow2
    bucket — with ``embedder.embed_device`` as its two-step fallback.
    Without one (fasttext, whose embed returns host vectors) requests
    take the host path.

    With a ``mesh`` of several ranks the engine holds this rank's block
    of the corpus (its data axis above 1): global rank 0's engine is a
    ``LockstepEngine``, and the service takes the two-step chain, since
    a sharded corpus has no fused one; every other rank gets a
    ``Follower`` instead of a service."""
    from multimodalsimilar_tpu_torch.pipelines.serving import (
        SimilarityService)
    from multimodalsimilar_tpu_torch.pipelines.sharded_serving import (
        Follower, LockstepEngine)
    from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine

    engine = SimilarityEngine(emb, keys, categories=cats, metric=metric,
                              normalize=normalize, device=device, mesh=mesh)
    if _world()[0] != 0:
        return Follower(engine, mesh)
    if engine.sharded:
        engine = LockstepEngine(engine, mesh)
    embed_device = fused = fused_factory = None
    if embedder is not None and args.max_batch <= args.batch_size:
        fused = embedder.fused_similar_fn(engine, args.k)
        embed_device = embedder.embed_device
        fused_factory = lambda: embedder.fused_similar_fn(engine, args.k)  # noqa: E731
    return SimilarityService(embed_queries, engine, k=args.k,
                             score_th=_serve_score_th(args),
                             max_batch=args.max_batch,
                             max_wait_ms=args.max_wait_ms,
                             query_parser=parser,
                             embed_queries_device=embed_device,
                             fused_similar=fused,
                             fused_factory=fused_factory,
                             warm_payload=_serve_warm_payload(args))


def _serve_cv_corpus(args, table, cats, device="cuda", mesh=None):
    """(embed_queries, parser, keys, emb, cats, embedder) for ``serve
    --tower cv``: the corpus is embedded from the reference's image
    layout ({img_root}/{key}/0..7.jpg mean, emb.txt and the packed cache
    respected — daodian_infer.py:259-285), each rank its own block of
    keys under a sharded ``mesh``; queries arrive as decoded uint8 images
    from ImageQueryParser and run ImageEmbedder's batches."""
    from multimodalsimilar_tpu_torch.pipelines.serving import ImageQueryParser

    embedder = _cv_embedder(args, device=device)
    keys_all = [str(k) for k in column(table, args.key_col)]
    paths_for_key = _image_paths(args)

    def embed_keys(kk):
        return embed_keys_sharded(mesh, kk, lambda part: embedder.embed_keys(
            part, paths_for_key), device)

    if args.emb_table:
        # warm-start from the nightly cv job's own table
        # (goodssku_emb_cv_di layout): hit keys need NO image on disk
        emb, live = _corpus_rows_from_table(args, keys_all, embed_keys,
                                            dim_hint=embedder.emb_dim)
    else:
        emb_map = embed_keys(keys_all)
        # keys without a single readable image drop out of the corpus —
        # and the category list must stay row-aligned with the survivors
        live = [i for i, k in enumerate(keys_all) if k in emb_map]
        if not live:
            raise SystemExit(f"no readable images under {args.img_root} "
                             "for any corpus row — check "
                             "--img_root/--key_col")
        if len(live) < len(keys_all):
            print(f"serve: {len(keys_all) - len(live)} of {len(keys_all)} "
                  f"corpus keys have no readable image and were dropped",
                  file=sys.stderr)
        emb = np.stack([emb_map[keys_all[i]] for i in live])
    keys = [keys_all[i] for i in live]
    if cats is not None:
        cats = [cats[i] for i in live]

    def embed_queries(images):
        return embedder.embed_batch(np.stack(list(images)))

    return (embed_queries, ImageQueryParser(args.image_size), keys, emb,
            cats, embedder)


def _serve_multimodal_corpus(args, table, cats, device="cuda", mesh=None):
    """(embed_queries, parser, keys, emb, cats, embedder) for ``serve
    --tower multimodal``: corpus rows are (text_col, {img_root}/{key}.jpg)
    pairs fused through the checkpointed tower (the multimodal_infer.py
    input layout), each rank its own block of rows under a sharded
    ``mesh``; queries arrive as (text, image) pairs from
    MultimodalQueryParser and run the same fused tower."""
    from multimodalsimilar_tpu_torch.pipelines.serving import (
        MultimodalQueryParser)

    if not args.checkpoint:
        raise SystemExit("serve --tower multimodal requires --checkpoint "
                         "(a trained fused model)")
    embedder = _multimodal_embedder(args, table, device=device)
    keys_all = [str(k) for k in column(table, args.key_col)]
    if args.emb_table:
        # warm-start from the nightly fused-embedding table: hit keys
        # need NO image on disk; the rest run the fused tower pass
        texts_all = column(table, args.text_col)

        def embed_missing(mk):
            want = set(mk)
            rows = [i for i, k in enumerate(keys_all) if k in want]
            sub = {args.key_col: [keys_all[i] for i in rows],
                   args.text_col: [texts_all[i] for i in rows]}
            semb, skeep = _fused_embeddings(args, sub, embedder=embedder,
                                            require_rows=False)
            return {sub[args.key_col][j]: semb[i]
                    for i, j in enumerate(skeep)}

        def embed_missing_by_block(mk):
            # a rank's block may hold no readable image: the check that
            # some key does runs on what every rank gathered
            got = embed_keys_sharded(mesh, mk, embed_missing, device)
            if not got:
                raise _no_readable_images(args)
            return got

        emb, keep = _corpus_rows_from_table(args, keys_all,
                                            embed_missing_by_block)
    else:
        emb, keep = fused_embeddings_by_block(args, table, mesh, embedder,
                                              device)
        if len(keep) < len(keys_all):
            print(f"serve: {len(keys_all) - len(keep)} of {len(keys_all)} "
                  f"corpus keys have no readable image and were dropped",
                  file=sys.stderr)
    keys = [keys_all[i] for i in keep]
    if cats is not None:
        cats = [cats[i] for i in keep]

    def embed_queries(pairs):
        pairs = list(pairs)
        return embedder(np.stack([img for _, img in pairs]),
                        [text for text, _ in pairs])

    return (embed_queries, MultimodalQueryParser(args.image_size), keys,
            emb, cats, embedder)


def _serve_fasttext_corpus(args, table, device="cuda"):
    """(embed_queries, keys, emb) for ``serve --tower fasttext``: the
    daodian text arm online — ``--fasttext_model`` sentence vectors
    (d=100) searched by inner product on normalized rows
    (daodian_infer.py:204-247). Corpus titles come from text_col, or
    ``gen_title`` when the column is absent (the batch job's own
    fallback)."""
    ft = _load_fasttext(args, device=device)
    if args.text_col in _columns(table):
        texts = [str(t) for t in column(table, args.text_col)]
    else:
        try:
            texts = _gen_titles(table)
        except (KeyError, AttributeError):
            raise SystemExit(
                f"column {args.text_col!r} not in {args.data} and the "
                "gen_title fallback needs the daodian columns "
                "(first/second_level_category_name, product_name, "
                "product_title) — pass --text_col")
        print(f"serve: {args.text_col!r} not in table — corpus titles "
              "built with gen_title (the daodian batch job's layout)",
              file=sys.stderr)
    keys = [str(k) for k in column(table, args.key_col)]

    def embed_queries(qtexts):
        return ft.get_sentence_vector(list(qtexts))

    return embed_queries, keys, _corpus_with_emb_table(args, keys, texts,
                                                       embed_queries)


def _build_daodian_service(args, table=None, device="cuda"):
    """DaodianService for ``serve --tower daodian`` on ``device``: BOTH
    production arms hot (fastText sentence vectors + the CV tower's cached
    embeddings) so one request returns the nightly job's merged per-key
    answer online (daodian_infer.py:361-392). ``table`` replaces reading
    ``args.data``. Without ``--cv_checkpoint`` it refuses unless
    ``--text_only`` says to serve the fastText arm alone.

    The per-area engines are small and built without a mesh, as in the
    JAX package (its ``_build_daodian_service`` keeps them on one chip):
    under a launch of several ranks it refuses, so the daemon starts as
    one process."""
    from multimodalsimilar_tpu_torch.pipelines.daodian_serving import (
        DaodianService)
    from multimodalsimilar_tpu_torch.pipelines.embedders import ImageEmbedder
    from multimodalsimilar_tpu_torch.pipelines.similar import n_rows

    dev = resolve_device(device)
    _knn_backend_mesh(args)
    if _world()[1] > 1:
        raise SystemExit(
            f"serve --tower daodian over {_world()[1]} ranks: its per-area "
            "engines are small and live on one card, as in the JAX "
            "package; start the daemon as one process (without torchrun)")
    if table is None:
        from multimodalsimilar_tpu_torch.data.datasets import read_table
        table = read_table(args.data)
    cols = table_columns(table)
    if not n_rows(cols):
        raise SystemExit("--data table is empty — nothing to serve")
    if "title" not in cols:
        cols["title"] = _gen_titles(cols)
    ft = _load_fasttext(args, device=dev)

    def embed_titles(titles):
        return ft.get_sentence_vector(list(titles))

    embed_query_images = None
    if args.cv_checkpoint:
        emb = ImageEmbedder(
            _load_cv_tower(args, args.cv_checkpoint, args.cv_num_labels),
            image_size=args.image_size,
            cache_path_for_key=lambda k: os.path.join(
                args.img_root, str(k), "emb.txt"),
            cache=_emb_cache(args), emb_dim=args.fc_dim, device=dev)

        def embed_skus(area):
            return _sku_to_spusn(area, emb, args)

        def embed_query_images(images):
            # one tower call per coalesced batch (uniform shapes — the
            # HTTP parser resizes)
            return emb.embed_batch(np.stack([np.asarray(im)
                                             for im in images]))
    else:
        # the production job merges both arms: degrading to text only
        # must be the operator's explicit choice
        if not args.text_only:
            raise SystemExit(
                "serve --tower daodian: no --cv_checkpoint given. The "
                "production job merges CV and text neighbors; pass "
                "--text_only to deliberately serve the fastText side "
                "alone.")
        print("serve daodian: --text_only — CV arm disabled",
              file=sys.stderr)

        def embed_skus(area):
            return {}

    return DaodianService(
        cols, embed_titles, embed_skus,
        embed_query_images=embed_query_images,
        area_col=args.area_col, key_col=args.key_col,
        nlp_score_th=args.nlp_score_th, cv_score_th=args.cv_score_th,
        ann_cnt_nlp=args.ann_cnt_nlp, ann_cnt_cv=args.ann_cnt_cv,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms, device=dev)


def _serve_daodian(args, device="cuda"):
    """Build and warm the daodian service (every area's index and merged
    map, the ad-hoc buckets), then serve HTTP until interrupted."""
    from multimodalsimilar_tpu_torch.pipelines.daodian_serving import (
        make_daodian_server)
    t0 = time.perf_counter()
    service = _build_daodian_service(args, device=device)
    try:
        service.warm()
        service.warm_query_buckets(args.image_size)
        print(f"daodian indexes warm: {service.n} rows, "
              f"{len(service.areas)} areas in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
        httpd = make_daodian_server(service, args.host, args.port,
                                    image_size=args.image_size)
    except BaseException:
        service.close()
        raise
    host, port = httpd.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}",
                      "corpus": service.n,
                      "areas": len(service.areas)}), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()


def _emb_table_key_col(args, columns):
    if args.key_col in columns:
        return args.key_col
    # the embed jobs key by goods_sku while serve defaults to spu_sn;
    # a table with exactly one plausible key column is unambiguous
    cands = [c for c in columns if c not in (args.emb_col, "dt")]
    if len(cands) != 1:
        raise SystemExit(
            f"--emb_table {args.emb_table} has no {args.key_col!r} "
            f"column and several candidates ({cands}) — rename or "
            "pass --key_col matching the table")
    print(f"serve: --emb_table keyed by {cands[0]!r} "
          f"(no {args.key_col!r} column)", file=sys.stderr)
    return cands[0]


def _emb_table_cache_load(cache_dir, args):
    """(keys, emb) from the restart cache, or None on any mismatch.
    Validated against the SOURCE table's (mtime, size): a nightly rewrite
    invalidates the cache, so the batch layout stays the authority."""
    meta_p = os.path.join(cache_dir, "meta.json")
    if not os.path.exists(meta_p):
        return None
    try:
        with open(meta_p) as f:
            meta = json.load(f)
        st = os.stat(args.emb_table)
        if (meta.get("source") != os.path.abspath(args.emb_table)
                or meta.get("mtime") != st.st_mtime
                or meta.get("size") != st.st_size
                or meta.get("emb_col") != args.emb_col
                # key_col participates: a restart with a different
                # --key_col must re-resolve against the table, not serve
                # keys cached from the previously-selected column
                or meta.get("key_col") != args.key_col):
            return None
        emb = np.load(os.path.join(cache_dir, "emb.npy"), mmap_mode="r")
        keys = np.load(os.path.join(cache_dir, "keys.npy"),
                       allow_pickle=False)
        if emb.shape[0] != len(keys) or emb.shape != tuple(meta["shape"]):
            return None
    except (OSError, ValueError, KeyError):
        return None
    print(f"serve: --emb_table loaded from restart cache {cache_dir}",
          file=sys.stderr)
    return keys.astype(object), emb


def _emb_table_cache_store(cache_dir, keys, emb, args):
    os.makedirs(cache_dir, exist_ok=True)
    st = os.stat(args.emb_table)
    # data first, meta last, all atomic renames: a crashed writer leaves
    # either the old cache or no meta (= miss), never a torn read
    for name, arr in (("emb.npy", np.asarray(emb, np.float32)),
                      ("keys.npy", np.asarray(keys, str))):
        tmp = os.path.join(cache_dir, "tmp_" + name)  # keeps .npy suffix
        np.save(tmp, arr)                             # (np.save appends
        os.replace(tmp, os.path.join(cache_dir, name))  # it otherwise)
    meta = {"source": os.path.abspath(args.emb_table),
            "mtime": st.st_mtime, "size": st.st_size,
            "emb_col": args.emb_col, "key_col": args.key_col,
            "shape": list(emb.shape)}
    tmp = os.path.join(cache_dir, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(cache_dir, "meta.json"))
    print(f"serve: --emb_table restart cache written to {cache_dir}",
          file=sys.stderr)


def _load_emb_table(args):
    """(keys [N] str ndarray, emb [N, D] float32) from ``--emb_table`` —
    the nightly embedding jobs' own output layout (key column +
    '[x,y,...]' strings, goodssku_emb_bert_di.py:84-87; the bulk job's
    raw unbracketed 'x,y,...' parses too). A parquet whose embedding
    column holds float LISTS loads via pyarrow as one flat reshape.
    ``--emb_table_cache DIR`` keeps an mtime-validated npy mirror so
    daemon restarts mmap the matrix instead of decoding the table."""
    import pandas as pd

    path = args.emb_table
    cache_dir = getattr(args, "emb_table_cache", None)
    if cache_dir:
        if not os.path.exists(path):
            raise SystemExit(
                f"--emb_table_cache needs a local --emb_table file to "
                f"validate against (mtime/size); {path} is not one — "
                "drop the cache flag for warehouse-direct sources")
        hit = _emb_table_cache_load(cache_dir, args)
        if hit is not None:
            return hit
    keys = emb = None
    if str(path).endswith((".parquet", ".pq")) and os.path.exists(path):
        import pyarrow as pa
        import pyarrow.parquet as pq
        tbl = pq.read_table(path)
        if args.emb_col not in tbl.column_names:
            raise SystemExit(f"--emb_col {args.emb_col!r} not in "
                             f"{path} (has: {tbl.column_names})")
        key_col = _emb_table_key_col(args, tbl.column_names)
        keys = pd.Series(tbl.column(key_col).to_pandas()).astype(str)
        col = tbl.column(args.emb_col).combine_chunks()
        if pa.types.is_fixed_size_list(col.type):
            flat = col.flatten().to_numpy(zero_copy_only=False)
            emb = np.asarray(flat, np.float32).reshape(
                len(col), col.type.list_size)
        elif pa.types.is_list(col.type) or pa.types.is_large_list(col.type):
            widths = np.diff(col.offsets.to_numpy())
            if len(widths) and (widths != widths[0]).any():
                raise SystemExit(f"--emb_table {path}: ragged "
                                 f"{args.emb_col!r} column")
            flat = col.flatten().to_numpy(zero_copy_only=False)
            emb = np.asarray(flat, np.float32).reshape(len(col), -1)
        else:
            keys = None   # string-serialized — the pandas path parses it
    if keys is None:
        from multimodalsimilar_tpu_torch.data.datasets import read_table
        t = pd.DataFrame(read_table(path))
        if args.emb_col not in t.columns:
            raise SystemExit(f"--emb_col {args.emb_col!r} not in "
                             f"{path} (has: {list(t.columns)})")
        key_col = _emb_table_key_col(args, list(t.columns))
        keys = t[key_col].astype(str)
        col = t[args.emb_col]
        first = col.iloc[0] if len(col) else ""
        if isinstance(first, str):
            emb = None
        else:   # array-typed rows that arrived through pandas anyway
            try:
                emb = np.asarray(np.stack(col.to_numpy()), np.float32)
            except ValueError as e:
                raise SystemExit(f"--emb_table {path}: ragged or "
                                 f"non-numeric {args.emb_col!r} "
                                 f"column ({e})")
            if emb.ndim != 2:
                raise SystemExit(f"--emb_table {path}: {args.emb_col!r} "
                                 "rows are not 1-d vectors")
        if emb is None:
            from multimodalsimilar_tpu_torch.pipelines.embed import (
                parse_embeddings)
            emb = parse_embeddings(col.astype(str).tolist())
    # a key recurring across appends (shouldn't happen — incremental
    # skips existing keys — but a hand-built table might): last wins
    dup = keys.duplicated(keep="last").to_numpy()
    if dup.any():
        emb = emb[~dup]
        keys = keys[~dup]
    keys = keys.to_numpy()
    if cache_dir:
        _emb_table_cache_store(cache_dir, keys, emb, args)
    return keys, emb


def _corpus_with_emb_table(args, keys, texts, embed_bulk):
    """Corpus embeddings, preferring ``--emb_table`` precomputed rows.

    Loading the nightly jobs' table replaces the startup tower pass over
    the rows it holds. Keys missing from the table (intraday additions)
    embed fresh through the tower; a dimension mismatch between table and
    tower fails fast (queries embed through the TOWER at request time, so
    a stale table from a different model would otherwise serve garbage
    scores indistinguishable from real ones)."""
    if not args.emb_table:
        return embed_bulk(texts)
    import pandas as pd
    pre_keys, pre_emb = _load_emb_table(args)
    # vectorized key->row mapping: per-key dict lookups over a
    # warehouse-scale corpus are minutes of host time
    pos = pd.Index(pre_keys).get_indexer(pd.Index(np.asarray(keys,
                                                             object)))
    hit_mask = pos >= 0
    n_miss = int((~hit_mask).sum())
    if not hit_mask.any():
        raise SystemExit(
            f"--emb_table {args.emb_table}: no overlap with the corpus "
            f"keys — wrong table or wrong --key_col?")
    if n_miss:
        miss = np.nonzero(~hit_mask)[0]
        fresh = np.asarray(embed_bulk([texts[i] for i in miss]),
                           np.float32)
    else:
        # no missing rows to reveal the tower's dim — probe one so a
        # stale table still fails fast here
        fresh = np.asarray(embed_bulk([texts[0]]), np.float32)
    if fresh.shape[1] != pre_emb.shape[1]:
        raise SystemExit(
            f"--emb_table dim {pre_emb.shape[1]} != tower dim "
            f"{fresh.shape[1]} — the table was built by a different "
            "model; rebuild it or drop --emb_table")
    if n_miss == 0 and len(pre_keys) == len(keys) \
            and (pos == np.arange(len(keys))).all():
        # table already row-aligned with the corpus: skip the full-size
        # fancy gather
        emb = np.ascontiguousarray(pre_emb, np.float32)
    else:
        emb = np.empty((len(keys), pre_emb.shape[1]), np.float32)
        emb[hit_mask] = pre_emb[pos[hit_mask]]
        if n_miss:
            emb[~hit_mask] = fresh
    print(f"serve: corpus {int(hit_mask.sum())} rows from --emb_table, "
          f"{n_miss} embedded fresh", file=sys.stderr)
    return emb


def _corpus_rows_from_table(args, keys, embed_missing, dim_hint=None):
    """(emb [L, D], live row indices) — the image-side towers' analogue
    of _corpus_with_emb_table (cv / multimodal, whose embed step can FAIL
    per key). Corpus keys found in the nightly job's table take its
    vectors — they need NO image on disk; the rest embed fresh through
    ``embed_missing(miss_keys) -> {key: vec}``, and keys it cannot embed
    (no readable image) drop exactly like the no-table path.
    ``dim_hint`` (the tower's known output dim, when available) fails a
    stale table fast even with zero misses."""
    import pandas as pd

    pre_keys, pre_emb = _load_emb_table(args)

    def _dim_check(got_dim, what):
        if got_dim != pre_emb.shape[1]:
            raise SystemExit(
                f"--emb_table dim {pre_emb.shape[1]} != {what} "
                f"{got_dim} — the table was built by a different model; "
                "rebuild it or drop --emb_table")

    if dim_hint is not None:
        _dim_check(dim_hint, "tower dim")
    pos = pd.Index(pre_keys).get_indexer(pd.Index(np.asarray(keys,
                                                             object)))
    hit = pos >= 0
    if not hit.any():
        raise SystemExit(
            f"--emb_table {args.emb_table}: no overlap with the corpus "
            f"keys — wrong table or wrong --key_col?")
    miss = [keys[i] for i in np.nonzero(~hit)[0]]
    fresh = embed_missing(miss) if miss else {}
    if fresh:
        _dim_check(int(next(iter(fresh.values())).shape[-1]), "tower dim")
    live, rows = [], []
    for i, k in enumerate(keys):
        if hit[i]:
            live.append(i)
            rows.append(pre_emb[pos[i]])
        elif k in fresh:
            live.append(i)
            rows.append(np.asarray(fresh[k], np.float32).reshape(-1))
    dropped = len(keys) - len(live)
    print(f"serve: corpus {int(hit.sum())} rows from --emb_table, "
          f"{len(live) - int(hit.sum())} embedded fresh"
          + (f", {dropped} dropped (no table row or readable image)"
             if dropped else ""), file=sys.stderr)
    return np.stack(rows).astype(np.float32), live


def _warm_serve_service(service, args):
    """Run every path a request can take BEFORE accepting traffic, so no
    request pays a first-use cost (the kernels build at their first
    launch): one end-to-end similar, then the real device path at every
    pow2 bucket up to --max_batch, the two-step fallback's tower at every
    bucket, the host path's tower, and the host path's search at every
    bucket. Runs before traffic, so driving the engine from this thread
    doesn't race the device worker."""
    wp = service._warm_payload   # _serve_warm_payload(args), via _build
    service.similar(wp, k=1)
    # the exact bucket set _bucket_size quantizes to, INCLUDING bucket 1
    # (the c=1 operating point)
    ladder = service._bucket_ladder()
    if service._fused_similar is not None \
            or service._embed_queries_device is not None:
        for m in ladder:
            service._run_batch([{"op": "similar", "query": wp}] * m)
        if service._fused_similar is not None \
                and service._embed_queries_device is not None:
            # with a fused path the loop above never runs the fallback
            # chain's tower shapes
            if service._dev_accepts_pad:
                for m in ladder:
                    service._embed_queries_device([wp], pad_to=m)
            else:
                service._embed_queries_device([wp])
        # mixed/update batches run the HOST path: its tower must not pay
        # first-use costs on the first update
        service.embed([wp])
    d = service.engine._emb.shape[1]
    for m in ladder:
        service.engine.search(service.k,
                              queries=np.zeros((m, d), np.float32))


def cmd_serve(args, device="cuda"):
    """Online similarity daemon — the capability the reference's
    precomputed Redis KV can't give (a query NOT in last night's batch).
    Micro-batched HTTP serving; see pipelines/serving.py.

    Under ``torchrun`` the corpus is sharded over the ranks' data axis:
    global rank 0 warms, binds HTTP and prints the ``serving`` line, and
    every other rank replays its engine calls until rank 0's service
    closes (``pipelines/sharded_serving.py``), then returns what it
    replayed."""
    from multimodalsimilar_tpu_torch.pipelines.serving import make_server
    from multimodalsimilar_tpu_torch.pipelines.sharded_serving import Follower
    if args.tower == "daodian":
        # the merged tower has two thresholds and two depths: the generic
        # single-value knobs would be silently ignored, so refuse them
        if args.score_th is not None:
            raise SystemExit(
                "serve --tower daodian: --score_th is not read by the "
                "merged tower (it has TWO thresholds) — use "
                "--nlp_score_th / --cv_score_th")
        if args.k != 13:
            raise SystemExit(
                "serve --tower daodian: --k is not read by the merged "
                "tower (it has TWO retrieval depths) — use "
                "--ann_cnt_nlp / --ann_cnt_cv")
        return _serve_daodian(args, device=device)
    service, n = _build_serve_service(args, device=device)
    if isinstance(service, Follower):
        return service.run()
    try:
        _warm_serve_service(service, args)
        httpd = make_server(service, args.host, args.port)
    except BaseException:
        service.close()
        raise
    host, port = httpd.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}", "corpus": n,
                      "k": service.k}), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
