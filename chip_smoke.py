#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every kernel under ``multimodalsimilar_tpu_torch/csrc`` (the
   ``.cu`` files: ``topk.cu`` and ``arcface.cu`` share ``tf32x3.cuh``;
   ``topk_select.cu``) with nvcc for sm_90a, one process each, all
   started together.
2. Phase 1 holds the streaming top-k kernel (``csrc/topk.cu``) against its
   plain PyTorch version on the card, at the text job's shapes: a
   262,144 x 768 f32 corpus, 4,096 queries, k in {13, 26, 101}, ip and l2;
   the serving daemon's 64 queries against that corpus; the job's own
   search (32,768 queries against the engine's 65,536-row padded corpus,
   ``true_n`` = 50,000); k = 128 (the largest lists); one query; d = 100
   (not a multiple of the 32-deep slice); the image paths' shapes (the cv
   daemon's 64 queries at d = 512 against its 100,000-row corpus padded
   to 131,072, and phase 7's un-normalized l2 at d = 1,280 over 4,096
   fused rows of norm sqrt(2): the daemon's 48 queries and the job's
   self-search); the daodian shapes on this kernel (the v1 job's cv arm,
   8,134 photo rows padded to 8,192 at d = 512 and k = 26 searched by
   themselves, and ``serve --tower fasttext``, one request against
   99,600 titles padded to 131,072 at d = 100 and k = 100, both timed);
   a ragged corpus (N not a
   multiple of the 128-row chunk), a padded corpus with ``true_n < N``
   (including the l2 pad fill of 1e18, whose square overflows f32), a
   split-free launch, and small-integer data with duplicate rows where
   every score is exact and ties must go to the lowest index. Scores must
   agree within atol=1e-4, rtol=1e-5 (3xTF32 products are f32-accurate
   and summation order differs); indices must be equal wherever the plain
   version's neighbouring scores differ by more than 1e-5, and everywhere
   in the exact-arithmetic tie cases. It times the kernel, the plain
   version and ``torch.topk(q @ x.T)`` (a yardstick the port never calls)
   with CUDA events, beside the bound at the card's f32-accurate
   tensor-core rate and the older CUDA-core bound. It then holds the
   large-k route (the f32 products, then ``csrc/topk_select.cu``) against
   the plain version with the same tolerances at the daodian shapes: one
   8,300-row area at d = 100 searched by itself at k = N // 7 (the v2
   job's depth; the kernels line's main shape) and k = N, one lv1 group
   of 276 rows at k = N (the v1 text arm), the cv arm's 8,134 rows at
   d = 512 and k = N // 7, 1 and 16
   ad-hoc queries at k = N, 256 queries over 30,000 rows at k = N (longer
   than the 16,384 columns one block holds: chunks merged), a padded
   corpus with ``true_n`` < N (ip zeros and the l2 1e18 fill), small-integer
   duplicate rows and {-1, 0, 1} rows with exact zero scores (-0.0 ties
   with +0.0; exact equality), and l2 at d = 512, k = 300 over 50,000
   rows; with the route, the plain version, ``torch.sort`` of the same
   product (the library yardstick) and ``T.bound_ms`` timed or computed.
3. Phase 2 runs the text similarity job (``nlp_similar_job``) on 50,000
   synthetic product titles through the full-width ``roberta_wwm_ext``
   tower (12 layers, 768 hidden, vocab 21128; random weights from a seed,
   bf16 inference policy), ``TextEmbedder`` (max_length 128, batch 256),
   the engine's exact top-k (k=13) and the 0.9 threshold into an in-memory
   KV sink. The top-k launch count is set to 0 just before the job and read
   just after; it must have risen. Embeddings must be finite, keys must be
   written, and 512 sampled queries' scores must match the plain version
   on the same device corpus.
4. Phase 3 holds the ArcFace kernel (``csrc/arcface.cu``) against its
   plain version at the training slice's shape (B=128, C=10,205, D=768,
   m=0.4, s=64) and at edge cases: easy_margin, m=0.1, a ragged B=100,
   rows with label -1, x rows equal to a W row, to its negation and to
   zero, C=37, and D = 100 and 17 (not a multiple of the slice, nor of
   the 16-byte copy). Non-target logits, and target logits where
   1 - cos^2 >= 1e-4, must agree within atol=2e-4, rtol=1e-5 (a 768-term
   f32 sum in another order moves cos by about 2e-6, times s=64). Target
   logits where 1 - cos^2 < 1e-4 sit where the sine's slope is unbounded;
   sqrt is 1/2-Hoelder, so they must agree within s*(d + sin(m)*sqrt(2d))
   with d = 4e-6, the cosine difference the first tolerance allows.
   Gradients of one CE loss through ``ArcFaceLogits`` must match plain
   autograd within rtol=1e-3 and 1e-3 of the largest gradient (the
   logits agree to 2e-4, so the softmax does to about 2e-4 relative). It
   times with CUDA events, L2 flushed before each call (a training step
   finds the head cold, after the optimizer has streamed every
   parameter): the kernel, the plain version, the plain backward
   recompute, and as a product-only yardstick that the port never calls,
   ``torch.matmul(x_hat, W_hat.T)`` on inputs normalized beforehand
   (cuBLAS SGEMM, TF32 off; no single PyTorch call computes the whole
   function), and under ``torch.profiler`` the device time of each
   kernel the call launches. It then holds the kernel, forward and
   gradients, at the training recipes' heads with Zipf labels that reach
   class C - 1: cv 24 x 4,181 x 512 (m 0.2), multimodal 48 x 796 x 1,280
   (m 0.5) and the multilabel heads 256 x {10,205, 590, 38} x 768 (m 0.1,
   0.2, 0.4), each timed beside its bound and the yardstick.
5. Phase 4 trains the text ArcFace slice at full width: the
   ``roberta_wwm_ext`` tower (dropout 0.1) with a 10,205-class head at the
   ``configs/train_nlp_v2.yaml`` recipe (batch 128, max_length 128, seq
   buckets 48/64/96, AdamW at 1e-3 with weight decay 0.01 on both groups,
   linear schedule, margin 0.4, s=64, class-balanced sampling, the
   default training policy) on 4,096 synthetic titles with Zipf-like
   labels, for 1 epoch (32 steps; 2 before a cut for time) with eval and
   checkpoints at 32 steps. The ArcFace launch count is set to 0 just before ``fit`` and
   must equal the step count just after. Logged losses must be finite,
   tower and head must have moved, the last checkpoint must restore to
   equal parameters, and on one batch with dropout off the kernel path's
   loss and gradients must match the plain path's.
6. Phase 5 serves ``serve --tower bert`` at ``configs/serve.yaml`` (the
   ``base`` preset at full ``roberta_wwm_ext`` width, random weights from
   seed 0; max_length 80, batch 64, k 13, score_th 0.9, max_batch 64,
   max_wait 5 ms) over 100,000 synthetic titles with a 40-value category
   column, built and warmed through the port's ``_build_serve_service``
   and ``_warm_serve_service``. It holds 512 queries (256 corpus titles,
   256 novel ones) through the fused path at buckets 1, 8 and 64 against
   ``embed_device`` at the same bucket and the plain top-k on the same
   device corpus (phase 1's tolerances), and ``similar(score_th=None)``
   against the same keys; one all-zero query goes through the host path.
   With the top-k launch count set to 0 it then drives ``make_server``
   over HTTP with closed-loop ``urllib`` clients at concurrency 1, 16, 64
   and 128 (every response must be 200; at 128 clients a full batch
   launches while the last one's read-back is pending) and the same
   levels in-process; the count must equal the micro-batches run. It checks /update (64 new
   keys, each then found by its own title at score >= 0.999, and 64
   re-embedded ones), /healthz and /embed, and splits a request's time at
   buckets 1 and 64 with CUDA events.
7. Phase 6 serves ``serve --tower cv`` at ``configs/serve_cv.yaml``
   (EfficientNet-B4 at 512 px, fc 512, 4,181 labels, batch and max_batch
   64, k 13, score_th 0.15): seed-0 weights with seeded BatchNorm
   statistics, saved as a port checkpoint, loaded and BN-folded by
   ``cli/embedders.py:_load_cv_tower``, bf16 inference policy. It checks
   the folded tower against the unfolded one in full precision on 64
   images (max abs error <= 1e-4 of the largest output), embeds 4,096
   synthetic uint8 images through ``ImageEmbedder.embed_batch`` (made
   from the seed 1,024 at a time), stores them with 95,904 seeded unit
   vectors in a packed ``EmbeddingCache`` (a 100,000-key corpus with a
   40-value category column), builds the service through
   ``_build_serve_service(args, table=...)`` with ``--emb_cache`` (no key
   decodes an image) and warms it. Fused answers at buckets 1, 8 and 64
   must equal ``embed_device`` + the plain top-k; each of 64 corpus
   images must find its own key first at score >= 0.999, and the same
   64 embedded alone against their batch of 64 give the cosine behind
   that score, in bf16 and under the full-precision policy (there >=
   0.9999: what separates a query from its corpus row is bf16's
   rounding); in-process
   closed-loop load at c = 1, 16, 64 must launch the top-k once per
   micro-batch; the first 32 of them as base64 JPEGs (``cv2.imencode``)
   go to ``/similar`` over HTTP (``make_server`` on a free local port) at
   c = 1 and 16, top-k launches equal to micro-batches, each answer held
   against the in-process answer to its decoded JPEG at the bucket it
   was served at (``http_images``; HTTP p50/p99 and qps print beside the
   in-process level's, with the card's name and power limit, and the
   top-k kernel is timed at each bucket the requests ran at);
   64 images are added by ``update`` and found first by
   themselves; ``embed``; a CUDA-event split of a request at buckets 1
   and 64, and the tower's kernels per call under ``torch.profiler``
   (launches, device ms, the heaviest kernels; phases 5 and 7 too). Each
   ``torch.profiler`` window of this script traces device activity only,
   so a busy share is device time over the window's wall time without
   the CPU tracer's overhead.
8. Phase 7 serves ``serve --tower multimodal`` at
   ``configs/serve_multimodal.yaml`` (B4 at 380 px fused with the
   ``roberta_wwm_ext`` tower, max_length 128, 1,280-d, batch and
   max_batch 48, k 13, un-normalized squared L2, no threshold) and runs
   ``multimodal_similar_job``: seed-0 weights saved as a port checkpoint
   and restored by ``_multimodal_embedder``. It embeds 4,096 synthetic
   (title, image) pairs through ``MultimodalEmbedder``, runs the job into
   an in-memory KV sink (the top-k launch count must rise; 256 sampled
   rows must equal the plain l2 top-k), builds the service from the same
   vectors through ``cli/serve.py:_service_from_corpus`` (the card can
   neither decode ``{img_root}/{key}.jpg`` nor read an ``--emb_table``)
   and holds it as phase 6 does, at buckets 1, 8, 48 and c = 1, 16, 48,
   with scores ascending and each corpus pair's own key first at
   distance <= 1e-3, and serves 32 (title, JPEG) pairs over HTTP as
   phase 6 does. OpenCV encodes the JPEGs (the card machine has it).
9. Phase 8 runs the daodian slice from seeds. fastText
   (``configs/train_fasttext.yaml``: dim 100, 5 epochs, word bigrams,
   bucket 200,000, batch 256) trains on the card over 100,000 synthetic
   titles (words of 2-3 CJK characters, half from each of 30 labels'
   topic words) twice: at lr 0.1, the JAX defaults, and at lr 25.6 (0.1
   per title, fastText's own step), whose model the jobs use; tokens/s,
   the loss and held-out accuracy are reported, and the second must
   halve its loss and pass 90%. The v2 recent-days job
   (``configs/similar_daodian_v2_recent_days.yaml``) runs over 12 areas
   of 8,300 rows with dts over 7 days and both arms: the cv vectors come
   from a packed ``--emb_cache`` holding 2,048 synthetic photos embedded
   by B4 at 512 px (seed-0 weights, seeded BN statistics, folded, bf16)
   and seeded 512-d unit vectors by lv2 for the rest (1 row in 50 has
   none). ``LAUNCHES["topk_select"]`` must rise, every neighbour must
   share its key's area and carry the target dt, keys are date-keyed
   with the 1.5-day TTL, 256 sampled rows of each arm's self-search
   equal the plain top-k, and the time splits into embed (text, cv),
   search, filters, sink and other. The v1 job over 2 of those areas:
   the text arm takes the grouped path (one selection launch per lv1
   group above 128 rows, ``csrc/topk.cu`` for the rest and the cv arm
   at k = 26), and for one area the grouped map must equal the full
   [n, n] search + filter. ``serve --tower daodian``
   (``configs/serve_daodian.yaml``) over the same 2 areas through
   ``_build_daodian_service``: 256 sampled ``similar_key`` answers equal
   the v1 job's map; ad-hoc ``similar_query`` (k = len(area), one
   selection launch each) under closed-loop load at c = 1 and 16; an
   ``update`` found by its own key; HTTP /healthz, a key, an ad-hoc
   query with ``image_b64`` (one ``csrc/topk.cu`` launch for its cv arm)
   and /update. ``serve --tower fasttext`` (``configs/serve_fasttext.yaml``,
   k = 100) over all 99,600 rows answers 16 requests through
   ``csrc/topk.cu``, scores equal to the plain top-k.
10. Phase 9 trains the other recipes through ``cli/train.py``'s
   ``cmd_train_*`` (a table each, the JAX parser's defaults and the
   config's values written out, random weights from the seed, two short
   epochs, ``log_every`` 1, eval and save cadence left long), with the
   ArcFace launch count set to 0 before each and read after: ``train cv``
   at ``configs/train_cv_daodian.yaml`` (B4 at 512 px, batch 24, fc 512,
   4,181 Zipf classes, 192 synthetic JPEGs written by cv2 (96 rows) and read
   through ``ImageClassificationSource`` as uint8, AdamW under
   ``cosine_warm_restarts``, class-balanced sampling, margin 0.2 + 0.04
   an epoch: the margin must reach 0.24, launches equal steps and every
   BN's running statistics move) and at ``configs/train_cv_timm.yaml``
   (380 px, batch 96, dual AdamP under ``timm_cosine``, cooldown cut to 0
   with the epochs); ``train multilabel`` at
   ``configs/train_multilabel_v3.yaml`` (base tower, batch 256 x
   ``--grad_accum 8``, buckets 48/64/96, heads 38/590/10,205) with the
   plain heads (3 launches a micro-step) and with ``--fused_loss`` (none):
   the first logged losses agree within 1e-3 relative; ``train
   multimodal`` at ``configs/train_multimodal.yaml`` (B4 at 380 px + the
   base tower, batch 48, 796 classes at D = 1,280); ``train pair`` at
   ``configs/train_pair.yaml`` with the base tower (the width users train;
   the config leaves the CLI's tiny default), batch 128, max_length 64,
   with ``--profile`` (the trace's files are counted). Each reports
   examples/s at the median step, step p50 and p95 and peak memory;
   ``train cv`` at ``train_cv_daodian.yaml`` and ``train multilabel``
   also the device's busy share from a short ``torch.profiler`` window
   (the other recipes' windows were cut for time).
11. Phase 10 drives the command line in process, through
   ``multimodalsimilar_tpu_torch.cli.main(argv)`` on its default device
   (the card), with the repo's ``configs/*.yaml`` (read by
   ``cli/config.py``: the card machine has no PyYAML) and CSV tables the
   phase writes with the stdlib and ``read_table`` reads without pandas;
   random weights from the seed, full widths, only the data cut. Every
   launch count is set to 0 before each command and read after it.
   ``train nlp --config configs/train_nlp_v2.yaml`` (base tower, batch
   128, 4,096 titles over 10,205 Zipf classes, one epoch: ArcFace
   launches must equal the 32 steps); ``eval`` of that checkpoint with
   its ``vocab.txt`` (finite metrics, the printed line equal to the
   result); ``similar nlp --config configs/similar_nlp.yaml`` over
   25,000 titles with that checkpoint and vocab (top-k launched; its KV
   writes must equal ``nlp_similar_job`` called directly on the vectors
   the command embedded), and the same command once as a subprocess of
   ``python -m multimodalsimilar_tpu_torch.cli`` over the first 5,000
   titles (``{"written": N}`` equal to the job's on the vectors the
   in-process command embedded for them); the text embedder's build from
   that checkpoint timed through ``_build_text_embedder`` (the tower
   built on the meta device) and as it was built before (a random init
   on the host, then the checkpoint's tower), the vectors of 512 titles
   equal; ``similar multimodal`` over 4,096 1,280-d ``[x,y,...]``
   strings (its writes equal ``multimodal_similar_job`` on the same
   array); ``train fasttext --config
   configs/train_fasttext.yaml`` on 20,000 titles, then ``similar
   daodian --config configs/similar_daodian_v2_recent_days.yaml
   --text_only --dt 2026-08-16`` over 2 areas of 8,300 rows with that
   model (``csrc/topk_select.cu`` launched; the writes equal
   ``daodian_similar_job`` called directly). The wall seconds and
   launches of each command go on one line; each kernel's entry of the
   kernels line gets ``launches_cli``.
12. Phase 11 drives the ViT and ConvNeXt image towers and the int8 text
   tower, random weights from the seed at the published widths. (a)
   ``serve --tower cv --backbone vit_base --image_size 224`` at
   ``configs/serve_cv.yaml`` otherwise (timm ``vit_base_patch16_224``:
   hidden 768, 12 layers, 12 heads, MLP 3,072, 197 tokens; the neck's
   BatchNorm statistics measured on 64 images; no BN to fold, which
   ``_load_cv_tower`` must leave as it is) through phase 6's own code
   with 4,096 corpus images: the same checks, with each of 64 corpus
   images its own key first at >= 0.996 (its bf16 cosine to its corpus
   row; under the full-precision policy that cosine must reach 0.9999).
   (b) ``train cv`` through
   ``cmd_train_cv`` with ``convnext_tiny`` (depths 3/3/9/3, dims 96-768)
   at ``configs/train_cv_daodian.yaml`` (batch 24, 96 rows) and
   ``vit_base`` at ``configs/train_cv_timm.yaml`` (batch 96, 192 rows,
   AdamP, ``timm_cosine``), both at 224 px for two epochs: ArcFace
   launches equal the steps, the kernel path's loss and gradients match
   the plain head's on one batch (phase 4's tolerances), the checkpoint
   restores and serves through ``_load_cv_tower`` unchanged, with step
   p50/p95, examples/s, peak memory and a profiled step. (c) ``similar
   nlp`` at ``configs/similar_nlp.yaml`` over 8,192 titles, bf16 and
   ``--int8``, through ``cli.main``: both launch the top-k; the int8
   embeddings' cosine to the f32 tower's (2,048 rows, TF32 off) must be
   >= 1 - 1e-3, the JAX package's budget, and the cosine to bf16 and the
   neighbour-list overlap are reported; ``torch._int_mm`` equals the exact
   product (f64 on the card) at the tower's shapes, one row, and K = 3,072
   with every product at 127^2, timed beside the bf16 product; ``serve
   --tower bert --int8`` at ``configs/serve.yaml`` over the first 10,000
   of phase 5's titles (the corpus pass through the int8 tower), held as
   phase 5's fused path, top-k launches equal to micro-batches,
   the int8 and bf16 towers timed at buckets 1 and 64. The kernels line
   gets the new paths' launch counts.
13. Phase 12 runs the multi-GPU layouts (``parallel/mesh.py``) in ranks
   started by ``parallel/spawn.py`` (a time limit each: a hung collective
   fails the phase): first one rank over NCCL (world 1, every collective
   still through NCCL), the reference; on a machine with more than one
   card, one rank per card over NCCL, held against it; then two ranks on
   ``cuda:0`` over gloo, whose CUDA collectives stage through the host
   (two shards meet on the card; their times are not scaling numbers).
   The reference spawn draws the base tower once on the host and saves
   its state dict, a port checkpoint of it and the titles' vocab in the
   work directory; every later spawn builds the tower on the meta device
   and loads them. In each rank: (a) ``train nlp`` at
   ``configs/train_nlp_v2_dist.yaml`` (the base tower with dropout off,
   a 10,205-class head, global batch 1,024 over 4,096 synthetic titles
   with Zipf labels, 4 steps, class-balanced sampling) through
   ``cli/train.py:_trainer`` over ``_mesh(args)``: f32 data-parallel,
   ``--bf16_grads``, and with two ranks ``--model_parallel 2`` (10,206
   classes, 5,103 a rank, the pad class masked). The loss and the
   gradients of one global batch (reduced as a step reduces them, the
   head gathered) and the per-step losses of every run of more than one
   rank must match the one-rank f32 run's (losses within phase 4's kernel-path loss
   tolerance; gradients within 1e-3 of each tensor's largest entry at the
   head, 1e-2 under bf16, and 2e-2 in the bf16-computed tower; the pad
   class without gradient); ArcFace launches equal the steps on every
   rank, each on its own class block; the model-parallel checkpoint holds
   the gathered head. Step p50, examples/s, peak memory and the
   gradient all-reduce's time and share of the step are reported. (b)
   ``similar nlp --config configs/similar_nlp.yaml`` over the first
   25,000 of phase 2's titles through ``cli.main`` (``--checkpoint`` and
   ``--tokenizer`` of the saved base tower): each rank embeds its own rows, the
   engine searches its block of the corpus, rank 0 writes; the two-rank
   run's KV items must equal the one-rank run's exactly, top-k launches
   counted per rank; after the job each rank holds the kernel against
   its plain version on the inputs of its first launch there (its block
   of the 32,768-row padded corpus, ``true_n`` masked, and the query
   chunk), as phase 1 holds it. (c) ``sharded_knn_search`` at phase 1's shapes
   (4,096 queries against 262,144 x 768 rows, in blocks of 131,072, with
   duplicate rows across the block boundary), ip and l2: equal to the
   one-block ``knn_search`` exactly, the tie to the lower index; each
   rank then holds the kernel against its plain version on its own block
   (ip and l2, k = 13), as phase 1 holds it. (e) the sharded daemon and
   daodian job: ``serve --config configs/serve.yaml`` over 100,000
   synthetic titles with a 40-value category through
   ``_build_serve_service``, every rank warm-started from an
   ``--emb_table`` that the reference rank writes first (the corpus
   through the serving tower at the bulk batch, as a parquet of float
   lists; the runs then hold the same corpus bit for bit). Over two
   ranks each holds 65,536 rows of the 131,072-row padded corpus (rank 1
   34,464 real ones), rank 0 serves and rank 1 replays its engine calls
   (``pipelines/sharded_serving.py``). Rank 0 warms, then sends the same
   192 novel titles to ``/similar`` over HTTP at c = 1 (96 requests)
   and c = 16 (192), recording the bucket each was served at; a query's
   bf16 embedding depends on its bucket's shapes and not on the other
   queries, so the reference tabulates every title's answer at every
   bucket of the ladder, and every answer of every run must equal the
   table's at its bucket (indices equal where neighbouring scores differ
   by more than 1e-5, scores within phase 1's tolerances). Then one
   ``/update`` appends a title whose ``/similar`` must find it first
   (score >= 0.999) and equal the reference's answer. Top-k launches and
   search dispatches are counted on every rank from the built daemon on
   and must be equal; the corpus re-cuts (the first search, and the one
   after the update, which uploads each block again) are timed; each
   rank holds the kernel against its plain version on its first launch's
   inputs. Then ``similar daodian --text_only`` at
   ``configs/similar_daodian_v2_recent_days.yaml`` through ``cli.main``
   over two areas of 8,300 and 9,000 rows (a fastText model trained on
   their titles on the card): each area pads to 16,384 rows, so rank 1
   holds 108 real rows of the first (its local search, k = 108, takes
   ``csrc/topk.cu``) and 808 of the second (k = 808, the selection
   kernel), while rank 0 takes the selection kernel on both. Every rank
   must launch the selection kernel, one launch a rank for each area's
   text search, and holds it against its plain version on its first
   launch's inputs; the two-rank job's KV items must equal the one-rank
   job's exactly. The parent then times the top-k kernel on one block
   beside its bound, the plain version and ``torch.topk``, the ArcFace
   kernel on one class block (5,103 x 768 at B = 128 and 1,024, as phase
   3's recipe heads), and (e)'s per-rank blocks: the serving search (64
   queries against 65,536 x 768 rows, all real and 34,464 real) and the
   daodian text arm's (8,300 queries against rank 0's 8,192 rows at k =
   1,185; 9,000 against rank 1's 808 at k = 808). (f) ``train cv
   --config configs/train_cv_daodian.yaml`` (B4, fc 512, batch 24, 4,181
   Zipf classes over 96 synthetic JPEGs at 256 px, 4 steps of one epoch,
   dropout and drop-path off, every model in full precision with TF32
   off) through ``cli/train.py:cmd_train_cv``, its mesh from the process
   group: f32 (global BatchNorm statistics), ``--bf16_grads`` (each
   shard's own statistics, the gradients meaned in bf16) and
   ``--model_parallel 2`` (4,182 classes, 2,091 a rank) on the two ranks;
   f32 and, for ``--bf16_grads``, ``two_shard_step`` (each half of the
   batch alone, the gradients meaned in bf16) on the reference rank.
   Every step's loss must match the reference's within ``DIST_LOSS_TOL``,
   the first step's gradients (BN scales and biases and the head) within
   ``DIST_GRAD_TOL`` (those the reference holds below ``DIST_GRAD_NOISE``
   of its largest are float noise there and must stay below it), and the
   first and last BN's running statistics after the steps within
   ``DIST_BN_RTOL`` relative (the neck's ``fc.bias`` part taken out:
   ``neck_bias_part``);
   each rank's head block must be its rows of the gathered head; ArcFace
   launches equal the steps on every rank. Step p50, peak memory and
   the CUDA-event time of the BN all-reduces, the gradient all-reduce
   and the rest are reported a rank. (g) ``similar multimodal
   --checkpoint`` over 2,048 (title, JPEG) rows at 380 px, every 97th
   without a JPEG (in both blocks), through ``cli.main``
   (``serve_multimodal.yaml``'s model): each rank embeds only its own
   block, rank 0's KV items must equal the one-rank job's exactly, and
   each rank holds its first top-k launch (l2, d = 1,280) against the
   plain version. The parent then times the ArcFace kernel on one cv
   class block (24 x 2,091 x 512) and the top-k kernel on each rank's
   block of (g). ``python3 chip_smoke.py --phases 12`` runs the builds
   and phase 12 alone and prints no kernels or result line.

14. Phase 13 trains ``configs/train_nlp_large_tp.yaml`` at full width
   (``roberta_wwm_ext_large``: 24 layers, hidden 1,024, 16 heads, MLP
   4,096, vocab 21,128; the 10,205-class head; global batch 256, titles
   of at most 46 characters so every batch is in the 48-token bucket,
   dropout off, the default training policy), seeded weights drawn on
   the card, 3 steps through ``cli/train.py:_trainer``: (a) one NCCL
   rank with ``--remat`` and no tensor parallelism, the reference, which
   saves its weights' per-tensor sums in the work directory; (b) four
   gloo ranks on ``cuda:0`` (data 1 x model 4: ``--tensor_parallel
   --sequence_parallel --remat`` and the head padded to 10,208 classes,
   2,552 a rank, through ``csrc/arcface.cu``), each drawing the same
   weights from the same seeded generator (checked against those sums),
   building the model on the meta device and loading them; (c) the
   reference rank without ``--remat``;
   and on the reference rank the first batch's gradients in full
   precision. The first step's gradients (reduced as the step reduces
   them, gathered to the one-card layout) are captured before the
   optimizer takes them. (b)'s per-step losses must match (a)'s within
   2e-3 relative; each of its first gradients must lie within twice (a)'s
   distance to the full-precision gradients plus 2e-3, as shares of the
   tensor's largest entry (bf16 products round otherwise split over four
   ranks; (a)'s own bf16 gradients lie up to 5% of a tensor's largest
   entry from f32's), and the pad classes have no gradient; (c)'s losses
   must equal (a)'s within 1e-5 relative and its peak memory exceed
   (a)'s; ArcFace launches equal the steps on every rank, and each rank
   holds the kernel against its plain version on its first launch's
   inputs (its 256 x 2,552 x 1,024 block), as phase 3 does; (b)'s
   checkpoint must be in the one-card layout with 10,208 head rows. It
   reports each run's step p50 (steps after the first, each between two
   synchronizations), examples/s and peak memory, and the share of (b)'s
   steps spent inside the collectives (each bracketed by
   ``torch.cuda.synchronize``), and times the kernel on one class block
   beside its bound, the plain version and SGEMM. With four cards it
   also runs (b) over NCCL, one card a rank, held the same way. (d) runs
   ``configs/train_nlp_large_pp.yaml`` on two gloo ranks on ``cuda:0``
   (data 1 x model 2, ``--pipeline_parallel 2 --remat``: two
   microbatches of 128 titles, each rank the 12 layers of its stage and
   their moments, the head padded to 10,206 classes, 5,103 a rank, one
   masked pad class), the same weights (each rank copies only its
   stage's tensors to the card): its per-step losses must match (a)'s
   within 2e-3 relative (masked pad classes leave the loss as it is),
   each rank must hold 12 x 16 encoder-layer tensors of layers [12 s,
   12 s + 12) and peak below (a), ArcFace launches equal the steps on
   both ranks and each holds the kernel against its plain version on
   its 256 x 5,103 x 1,024 block, and rank 0's checkpoint must be the
   one-card layout (392 tensors, 10,206 head rows), which the one-rank
   model loads. It reports (d)'s step p50, examples/s, peak memory, the
   stage hand-offs' bytes and their share of the step, and times the
   kernel on one of its class blocks. With two cards it also runs (d)
   over NCCL, one card a rank. The gloo ranks share one card and stage
   every collective through the host: their times are not scaling
   numbers.

Prints the card's name and power limit, one JSON line per phase, the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without a CUDA device or when any
check fails.
"""

from __future__ import annotations

import argparse
import base64
import collections
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from multimodalsimilar_tpu_torch.cli.common import _on_meta
from multimodalsimilar_tpu_torch.cli.embedders import (_cv_embedder,
                                                       _multimodal_embedder)
from multimodalsimilar_tpu_torch.cli.serve import (_build_serve_service,
                                                   _service_from_corpus,
                                                   _warm_serve_service)
from multimodalsimilar_tpu_torch.cli.train import _sampler_fn, _trainer
from multimodalsimilar_tpu_torch.data.datasets import TextClassificationSource
from multimodalsimilar_tpu_torch.data.prefetch import to_device
from multimodalsimilar_tpu_torch.data.tokenizer import (TextTokenizer,
                                                        build_char_vocab)
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models import efficientnet as E
from multimodalsimilar_tpu_torch.models.classifiers import NlpTextClassifier
from multimodalsimilar_tpu_torch.models.fold_bn import fold_cv_classifier
from multimodalsimilar_tpu_torch.models.multimodal import MultimodalClassifier
from multimodalsimilar_tpu_torch.models.vision import (CvImageClassifier,
                                                       backbone_config,
                                                       device_normalize,
                                                       to_nchw)
from multimodalsimilar_tpu_torch.ops import _build
from multimodalsimilar_tpu_torch.ops import arcface as A
from multimodalsimilar_tpu_torch.ops import topk as T
from multimodalsimilar_tpu_torch.pipelines.embcache import EmbeddingCache
from multimodalsimilar_tpu_torch.pipelines.embedders import (ImageEmbedder,
                                                          TextEmbedder)
from multimodalsimilar_tpu_torch.pipelines.serving import (
    MultimodalQueryParser, _read_back_later, make_server)
from multimodalsimilar_tpu_torch.pipelines.similar import (
    daodian_similar_job, multimodal_similar_job, nlp_similar_job)
from multimodalsimilar_tpu_torch.pipelines.sinks import InMemoryKVSink
from multimodalsimilar_tpu_torch.retrieval.engine import (SimilarityEngine,
                                                          _normalize_rows)
from multimodalsimilar_tpu_torch.retrieval.knn import knn_search, next_pow2
from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager
from multimodalsimilar_tpu_torch.train.tasks import text_arcface_task
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

SEED = 0
ATOL, RTOL, GAP = 1e-4, 1e-5, 1e-5
N_CORPUS, N_QUERY, DIM = 262_144, 4_096, 768
N_TITLES = 50_000
AF_B, AF_C, AF_D = 128, 10_205, 768          # the training slice's head
AF_ATOL, AF_RTOL, AF_DCOS = 2e-4, 1e-5, 4e-6
# (recipe, B, C, D, m) of the training recipes' ArcFace heads
RECIPE_HEADS = (("cv", 24, 4_181, 512, 0.2),
                ("multimodal", 48, 796, 1_280, 0.5),
                ("multilabel_tag", 256, 10_205, 768, 0.1),
                ("multilabel_lv2", 256, 590, 768, 0.2),
                ("multilabel_lv1", 256, 38, 768, 0.4))
N_TRAIN, N_EVAL = 4_096, 1_024
N_SERVE, N_CATEGORIES = 100_000, 40    # benchmarks/serving_load.py's corpus
SERVE_LEVELS = (1, 16, 64, 128)
BACKBONE, CV_SIZE, MM_SIZE = "efficientnet_b4", 512, 380
CV_DIM, MM_DIM, CV_LABELS, MM_LABELS = 512, 512 + 768, 4_181, 796
# 4,096 corpus images (8,192 before a cut for time)
N_CV_IMAGES, CV_CHUNK, N_CV_CORPUS = 4_096, 1_024, 100_000
N_MM = 4_096
CV_LEVELS, MM_LEVELS = (1, 16, 64), (1, 16, 48)
# image_b64 over HTTP (phases 6-7): the first 32 novel images, each once
# a level
HTTP_IMAGE_LEVELS, N_HTTP_IMAGES = (1, 16), 32
FOLD_RTOL = 1e-4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` with the 50 MB L2 flushed before each
    call (a 256 MB write between the timed events)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def unit_rows(rng, n, d, dev):
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    x = x.to(dev)
    return x / x.norm(dim=1, keepdim=True)


def fused_rows(rng, n, dev):
    """Rows shaped like the multimodal tower's output: a unit 512-d image
    half and a unit 768-d text half, norm sqrt(2), un-normalized."""
    return torch.cat([unit_rows(rng, n, CV_DIM, dev),
                      unit_rows(rng, n, MM_DIM - CV_DIM, dev)], dim=1)


def make_images(rng, n: int, size: int) -> np.ndarray:
    """``n`` synthetic uint8 [size, size, 3] photos: a random 16 x 16 grid
    of colours, each cell a flat block, so pooled features differ
    between images as they do between products."""
    grid = rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)
    cell = -(-size // 16)
    x = np.repeat(np.repeat(grid, cell, axis=1), cell, axis=2)
    return np.ascontiguousarray(x[:, :size, :size])


def check_case(name, got, want, k, exact=False) -> float:
    """Kernel (got) vs plain (want, computed with k + 1 columns where the
    corpus allows, so the k-th score's gap to the next one is known)."""
    gv, gi = got
    pv, pi = want
    if gv.shape[1] != k or pv.shape[1] < k:
        raise AssertionError(f"{name}: shapes {tuple(gv.shape)} vs "
                             f"{tuple(pv.shape)} at k={k}")
    wv, wi = pv[:, :k], pi[:, :k]
    err = float((gv - wv).abs().max())
    if not torch.isfinite(gv).all():
        raise AssertionError(f"{name}: non-finite kernel scores")
    if not torch.allclose(gv, wv, atol=ATOL, rtol=RTOL):
        raise AssertionError(f"{name}: scores differ, max abs err {err}")
    if exact:
        if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
            bad = int((gi != wi).sum())
            raise AssertionError(f"{name}: {bad} indices differ on exact "
                                 f"(tie) data")
        return err
    inf = torch.full((pv.shape[0], 1), float("inf"), device=pv.device)
    d = (pv[:, 1:] - pv[:, :-1]).abs()
    prev = torch.cat([inf, d], 1)[:, :k]
    nxt = torch.cat([d, inf], 1)[:, :k]
    sep = (prev > GAP) & (nxt > GAP)
    bad = int(((gi != wi) & sep).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} indices differ where the "
                             f"neighbouring scores are > {GAP} apart")
    return err


TOPK_LIBRARY = ("torch.topk(q @ x.T, k) for ip; torch.topk(|q|^2 - 2 q @ x.T "
                "+ |x|^2, k, largest=False) for l2; in 1,024-query chunks "
                "(cuBLAS SGEMM, TF32 off)")


def topk_library(corpus, queries, k, metric):
    """One library computation of the top-k's function
    (``TOPK_LIBRARY``); the port never calls it."""
    xn = (corpus * corpus).sum(1) if metric == "l2" else None
    for s in range(0, queries.shape[0], 1024):
        qs = queries[s: s + 1024]
        sc = qs @ corpus.T
        if metric == "ip":
            torch.topk(sc, k, dim=1)
        else:
            d = (qs * qs).sum(1, keepdim=True) - 2.0 * sc + xn[None, :]
            torch.topk(d, k, dim=1, largest=False)


def phase1(dev) -> dict:
    rng = np.random.default_rng(SEED)
    x = unit_rows(rng, N_CORPUS, DIM, dev)
    q = unit_rows(rng, N_QUERY, DIM, dev)
    cases, max_err = [], 0.0

    def run(name, corpus, queries, k, metric, true_n=None, exact=False,
            timed=False):
        nonlocal max_err
        got = T.topk_cuda(corpus, queries, k, metric, true_n)
        want = T.topk_plain(corpus, queries, k + 1, metric, true_n)
        torch.cuda.synchronize()
        if true_n is not None and int(got[1].max()) >= true_n:
            raise AssertionError(f"{name}: a pad row came back")
        max_err = max(max_err, check_case(name, got, want, k, exact))
        row = {"case": name, "q": queries.shape[0], "n": corpus.shape[0],
               "true_n": true_n or corpus.shape[0], "d": queries.shape[1],
               "k": k, "metric": metric}
        if timed:
            real = corpus[:true_n] if true_n else corpus
            row["ms"] = cuda_ms(lambda: T.topk_cuda(corpus, queries, k,
                                                    metric, true_n))
            row["plain_ms"] = cuda_ms(lambda: T.topk_plain(
                corpus, queries, k, metric, true_n), reps=1)
            row["library_ms"] = cuda_ms(lambda: topk_library(
                real, queries, k, metric))
            shape = (queries.shape[0], real.shape[0], queries.shape[1], k,
                     metric)
            row["bound_ms"], row["bound_by"] = T.bound_ms(*shape)
            row["cuda_core_bound_ms"] = T.bound_ms(
                *shape, flops_rate=T.H100_F32_FLOPS)[0]
        cases.append(row)
        return row

    main = None
    for metric in ("ip", "l2"):
        for k in (13, 26, 101):
            row = run(f"{metric}_k{k}", x, q, k, metric, timed=True)
            if metric == "ip" and k == 13:
                main = row

    # the serving daemon's shape: few queries, bound by reading the corpus
    run("serving_ip_k13", x, q[:64], 13, "ip", timed=True)
    # the job's own search: one QUERY_CHUNK of the corpus against the
    # engine's zero-padded corpus (50,000 real rows of 65,536)
    job = torch.cat([x[:N_TITLES], torch.zeros(65_536 - N_TITLES, DIM,
                                               device=dev)])
    run("job_ip_k13", job, x[:32_768], 13, "ip", true_n=N_TITLES,
        timed=True)

    # the redesign's corners: at k = 128 the lists leave room for one
    # consumer warpgroup only; d = 100 is not a multiple of the 32-deep
    # slice; Q = 1 fills one tile of 128
    for metric in ("ip", "l2"):
        run(f"{metric}_k128", x, q[:1024], 128, metric)
        run(f"q1_{metric}_k13", x, q[:1], 13, metric)
    x100 = unit_rows(rng, 65_536, 100, dev)
    q100 = unit_rows(rng, 1024, 100, dev)
    run("d100_ip_k13", x100, q100, 13, "ip")
    run("d100_l2_k101", x100, q100, 101, "l2")

    # N - 1234 rows: not a multiple of the 128-row chunk
    ragged = x[: N_CORPUS - 1234]
    run("ragged_ip_k13", ragged, q[:1024], 13, "ip")
    for metric, fill in (("ip", 0.0), ("l2", 1e18)):
        pad = torch.full((1234, DIM), fill, device=dev)
        padded = torch.cat([ragged, pad])
        run(f"padded_{metric}_k101", padded, q[:1024], 101, metric,
            true_n=ragged.shape[0])
    # enough query tiles that the corpus is not split (no merge pass)
    run("unsplit_l2_k26", x[: 32_768 - 100], unit_rows(rng, 20_000, DIM, dev),
        26, "l2")

    # the image paths: the cv daemon's 64 queries against its 100,000-row
    # corpus at d=512 (the engine pads it to 131,072 rows), and the fused
    # tower's un-normalized l2 at d=1,280 over phase 7's 4,096 pairs: the
    # daemon's 48 queries and the job's self-search
    cv = torch.cat([unit_rows(rng, N_CV_CORPUS, CV_DIM, dev),
                    torch.zeros(131_072 - N_CV_CORPUS, CV_DIM, device=dev)])
    run("cv_serving_ip_k13", cv, unit_rows(rng, 64, CV_DIM, dev), 13, "ip",
        true_n=N_CV_CORPUS, timed=True)
    mm = fused_rows(rng, N_MM, dev)
    run("mm_serving_l2_k13", mm, fused_rows(rng, 48, dev), 13, "l2",
        timed=True)
    run("mm_job_l2_k13", mm, mm, 13, "l2", timed=True)

    ints = torch.from_numpy(rng.integers(-3, 4, size=(N_CORPUS, DIM))
                            .astype(np.float32)).to(dev)
    ints[1000:2000] = ints[0:1000]          # duplicate rows: exact ties
    ints[N_CORPUS - 1] = ints[5]
    qi = torch.cat([ints[:16], torch.from_numpy(
        rng.integers(-3, 4, size=(1008, DIM)).astype(np.float32)).to(dev)])
    for metric in ("ip", "l2"):
        run(f"ties_{metric}_k101", ints, qi, 101, metric, exact=True)

    # the daodian paths on this kernel: the v1 job's cv arm, an area's
    # photo rows against themselves at d = 512 and k = 26 (the engine pads
    # 8,134 rows to 8,192), and serve --tower fasttext, one request
    # against all areas' titles at d = 100 and k = 100 (99,600 rows, padded
    # to 131,072)
    n_cv = AREA_ROWS - AREA_ROWS // 50
    cva = torch.cat([unit_rows(rng, n_cv, CV_DIM, dev),
                     torch.zeros(8_192 - n_cv, CV_DIM, device=dev)])
    run("daodian_v1_cv_ip_k26", cva, cva[:n_cv], 26, "ip", true_n=n_cv,
        timed=True)
    n_ft = N_AREAS * AREA_ROWS
    ft = torch.cat([unit_rows(rng, n_ft, FT_DIM, dev),
                    torch.zeros(131_072 - n_ft, FT_DIM, device=dev)])
    run("fasttext_serving_ip_k100", ft, unit_rows(rng, 1, FT_DIM, dev), 100,
        "ip", true_n=n_ft, timed=True)
    del x, q, ints, qi, job, cv, mm, x100, q100, ragged, cva, ft
    torch.cuda.empty_cache()
    return {"cases": cases, "main": main, "max_abs_err": max_err,
            "select": select_cases(dev)}


def make_titles(n: int, rng) -> list:
    """Synthetic product titles: CJK characters and digits, 8-40 chars; one
    in ten is a near-duplicate of an earlier title (a digit changed)."""
    pool = np.array([chr(0x4E00 + i) for i in range(3000)]
                    + list("0123456789"))
    lens = rng.integers(8, 41, size=n)
    titles = ["".join(pool[rng.integers(0, len(pool), size=m)])
              for m in lens]
    for i in range(n // 10, n, 10):
        src = titles[int(rng.integers(0, i))]
        titles[i] = src[:-1] + str(int(rng.integers(0, 10)))
    return titles


def phase2(dev) -> dict:
    rng = np.random.default_rng(SEED + 1)
    titles = make_titles(N_TITLES, rng)
    keys = [f"spu{i:06d}" for i in range(N_TITLES)]
    tok = TextTokenizer.from_corpus(titles)
    config = BertConfig.roberta_wwm_ext()
    model = NlpTextClassifier(config, policy=DTypePolicy.inference(),
                              generator=torch.Generator().manual_seed(SEED))
    embedder = TextEmbedder(model, tok, max_length=128, batch_size=256,
                            device=dev)
    embedder(titles[:512])                       # warm-up, not timed
    torch.cuda.synchronize()
    seen = {}

    def embed(texts):
        t0 = time.perf_counter()
        seen["emb"] = embedder(texts)
        seen["embed_s"] = time.perf_counter() - t0
        return seen["emb"]

    sink = InMemoryKVSink()
    T.LAUNCHES["topk"] = 0
    t0 = time.perf_counter()
    written = nlp_similar_job({"spu_name": titles, "spu_sn": keys}, embed,
                              sink, k=13, score_th=0.9, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = T.LAUNCHES["topk"]
    if launches < 1:
        raise AssertionError("the job never launched the top-k kernel")

    emb = seen["emb"]
    if emb.shape != (N_TITLES, config.hidden_size):
        raise AssertionError(f"embeddings shape {emb.shape}")
    if not np.isfinite(emb).all():
        raise AssertionError("non-finite embeddings")
    if written <= 0:
        raise AssertionError("the job wrote no keys")
    known = set(keys)
    for key in sink.keys()[:2000]:
        spu = key.removeprefix("dj_similar:")
        nbrs = sink.get(key).split(",")
        if spu not in known or spu in nbrs or not set(nbrs) <= known \
                or len(nbrs) > 12:
            raise AssertionError(f"bad KV item {key} -> {nbrs[:5]}")

    engine = SimilarityEngine(emb, keys, device=dev)
    t0 = time.perf_counter()
    scores, _ = engine.search(13)
    search_s = time.perf_counter() - t0
    corpus_dev, true_n, _ = engine._corpus_dev
    rows = np.sort(rng.choice(N_TITLES, size=512, replace=False))
    qd = torch.from_numpy(engine._emb[rows]).to(dev)
    pv, _ = T.topk_plain(corpus_dev, qd, 13, "ip", true_n)
    got = torch.from_numpy(scores[rows]).to(dev)
    if not torch.allclose(got, pv, atol=ATOL, rtol=RTOL):
        raise AssertionError(f"engine scores differ from the plain version: "
                             f"{float((got - pv).abs().max())}")
    return {"titles": N_TITLES, "written": written, "topk_launches": launches,
            "embeddings_per_s": N_TITLES / seen["embed_s"],
            "embed_s": seen["embed_s"], "search_s": search_s,
            "job_wall_s": wall, "tokenizer_backend": tok.backend,
            "sample_max_abs_err": float((got - pv).abs().max()),
            "config": "roberta_wwm_ext", "policy": "inference (bf16)"}


def af_tolerance(want, cos, label, m):
    """Allowed |kernel - plain| per logit (see the module docstring)."""
    s = 64.0
    allow = AF_ATOL + AF_RTOL * want.abs()
    cols = torch.arange(want.shape[1], device=want.device)
    target = cols[None, :] == label.long()[:, None]
    steep = target & (1.0 - cos * cos < 1e-4)
    edge = s * (AF_DCOS + math.sin(m) * math.sqrt(2.0 * AF_DCOS))
    return torch.where(steep, torch.full_like(allow, edge), allow), steep


def phase3(dev) -> dict:
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.standard_normal((AF_B, AF_D), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((AF_C, AF_D), dtype=np.float32))
    label = torch.from_numpy(rng.integers(0, AF_C, AF_B).astype(np.int32))
    x, w, label = x.to(dev), w.to(dev) * 0.02, label.to(dev)
    edge_x = x.clone()
    edge_x[0] = 3.0 * w[label[0]]             # cos = +1 on the target
    edge_x[1] = -w[label[1]]                  # cos = -1 on the target
    edge_x[2] = 0.0                           # zero row: the eps
    no_target = label.clone()
    no_target[::5] = -1
    cases, max_err, edge_err = [], 0.0, 0.0

    def run(name, xs, ws, ls, m=0.4, easy=False):
        nonlocal max_err, edge_err
        got = A.arcface_logits_cuda(xs, ws, ls, m, 64.0, easy)
        want = A.arcface_logits(xs, ws, ls, m, 64.0, easy)
        cos = A.cosine_logits(xs, ws)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"arcface {name}: shape {tuple(got.shape)} "
                                 f"or non-finite logits")
        err = (got - want).abs()
        allow, steep = af_tolerance(want, cos, ls, m)
        if (err > allow).any():
            raise AssertionError(
                f"arcface {name}: {int((err > allow).sum())} logits beyond "
                f"tolerance, max abs err {float(err.max())}")
        max_err = max(max_err, float(err[~steep].max()))
        if steep.any():
            edge_err = max(edge_err, float(err[steep].max()))
        cases.append({"case": name, "b": xs.shape[0], "c": ws.shape[0],
                      "d": xs.shape[1], "m": m, "easy_margin": easy,
                      "max_abs_err": float(err.max()),
                      "steep_targets": int(steep.sum())})

    run("main", x, w, label)
    run("easy_margin", x, w, label, easy=True)
    run("m0.1", x, w, label, m=0.1)
    run("ragged_b100", x[:100], w, label[:100])
    run("label_minus1", x, w, no_target)
    run("edge_rows", edge_x, w, label)
    run("edge_rows_easy", edge_x, w, label, easy=True)
    run("c37", x, w[:37].contiguous(), label % 37)
    # D not a multiple of the 32-deep slice; d = 17 not of the 16-byte copy
    for dd in (100, 17):
        run(f"ragged_d{dd}", edge_x[:, :dd].contiguous(),
            w[:, :dd].contiguous(), label)
    if cases[5]["steep_targets"] < 2:
        raise AssertionError("the cos = +-1 rows did not reach the sine's "
                             "steep region")

    # gradients of one CE loss: kernel forward + plain backward vs plain
    grad_err = grads_vs_plain(x, w, label, 0.4)
    heads = [recipe_head(dev, *shape) for shape in RECIPE_HEADS]
    max_err = max([max_err] + [h["max_abs_err"] for h in heads])

    xn, wn = A.l2_normalize(x), A.l2_normalize(w)
    xr = x.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    g = torch.randn(AF_B, AF_C, device=dev)

    def backward():
        out = A.arcface_logits(xr, wr, label, 0.4, 64.0, False)
        torch.autograd.grad(out, (xr, wr), g)

    bound, bound_by = A.bound_ms(AF_B, AF_C, AF_D)
    main = {"ms": cuda_ms_cold(lambda: A.arcface_logits_cuda(
                x, w, label, 0.4, 64.0)),
            "plain_ms": cuda_ms_cold(lambda: A.arcface_logits(
                x, w, label, 0.4, 64.0)),
            "yardstick_ms": cuda_ms_cold(lambda: torch.matmul(xn, wn.T)),
            "backward_plain_ms": cuda_ms_cold(backward),
            "bound_ms": bound, "bound_by": bound_by,
            "cuda_core_bound_ms": A.bound_ms(
                AF_B, AF_C, AF_D, flops_rate=A.H100_F32_FLOPS)[0],
            "device_ms_by_kernel": kernel_split(
                lambda: A.arcface_logits_cuda(x, w, label, 0.4, 64.0),
                ("arcface_kernel",))}
    return {"cases": cases, "main": main, "recipe_heads": heads,
            "max_abs_err": max_err, "steep_target_max_abs_err": edge_err,
            "grad_max_rel_err": grad_err}


def grads_vs_plain(x, w, label, m) -> float:
    """dx and dW of one CE loss through ``ArcFaceLogits`` (kernel forward,
    plain backward) against plain autograd: within rtol 1e-3 and 1e-3 of
    the largest gradient (the logits agree to 2e-4). Returns the largest
    error relative to that gradient."""
    def grads(fn):
        xr = x.clone().requires_grad_(True)
        wr = w.clone().requires_grad_(True)
        loss = torch.nn.functional.cross_entropy(
            fn(xr, wr, label, m, 64.0, False), label.long())
        return torch.autograd.grad(loss, (xr, wr))

    worst = 0.0
    for got, want in zip(grads(A.arcface_logits_fused),
                         grads(A.arcface_logits)):
        top = float(want.abs().max())
        if not torch.allclose(got, want, rtol=1e-3, atol=1e-3 * top):
            raise AssertionError(f"arcface gradients differ at "
                                 f"{tuple(x.shape)} x {tuple(w.shape)}: max "
                                 f"abs err {float((got - want).abs().max())}")
        worst = max(worst, float((got - want).abs().max()) / top)
    return worst


def recipe_head(dev, name, b, c, d, m) -> dict:
    """The kernel at one training recipe's head: Zipf labels over C
    classes with C - 1 present (the head has exactly C rows), the forward
    against the plain version (``af_tolerance``), the gradients
    (``grads_vs_plain``), and cold-L2 times of the kernel, the plain
    version and the product-only yardstick beside the bound."""
    rng = np.random.default_rng(SEED + c)
    x = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((c, d), dtype=np.float32))
    labels = zipf_labels(b, c, rng)
    labels[-1] = c - 1
    x, w = x.to(dev), w.to(dev) * 0.02
    label = torch.from_numpy(labels.astype(np.int32)).to(dev)
    got = A.arcface_logits_cuda(x, w, label, m, 64.0)
    want = A.arcface_logits(x, w, label, m, 64.0)
    cos = A.cosine_logits(x, w)
    torch.cuda.synchronize()
    err = (got - want).abs()
    allow, _ = af_tolerance(want, cos, label, m)
    if got.shape != (b, c) or not torch.isfinite(got).all() \
            or (err > allow).any():
        raise AssertionError(f"arcface at the {name} head: "
                             f"{int((err > allow).sum())} logits beyond "
                             f"tolerance, max abs err {float(err.max())}")
    xn, wn = A.l2_normalize(x), A.l2_normalize(w)
    bound, bound_by = A.bound_ms(b, c, d)
    return {"head": name, "b": b, "c": c, "d": d, "m": m,
            "max_abs_err": float(err.max()),
            "grad_max_rel_err": grads_vs_plain(x, w, label, m),
            "ms": cuda_ms_cold(lambda: A.arcface_logits_cuda(
                x, w, label, m, 64.0)),
            "plain_ms": cuda_ms_cold(lambda: A.arcface_logits(
                x, w, label, m, 64.0)),
            "yardstick_ms": cuda_ms_cold(lambda: torch.matmul(xn, wn.T)),
            "bound_ms": bound, "bound_by": bound_by,
            "device_ms": kernel_split(lambda: A.arcface_logits_cuda(
                x, w, label, m, 64.0), ("arcface_kernel",))}


def kernel_split(fn, names, n: int = 20) -> dict:
    """Device ms per call of each kernel in ``names`` that ``fn`` launches
    (``n`` calls under ``torch.profiler``, L2 flushed before each): the
    kernel's own time, without the host's enqueue that CUDA events around
    a short call also measure."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / n
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and any(t in e.key for t in names)}


def zipf_labels(n: int, n_cls: int, rng) -> np.ndarray:
    """Class ids with P(k) proportional to 1 / (k + 1)^1.1."""
    p = 1.0 / np.arange(1, n_cls + 1) ** 1.1
    return rng.choice(n_cls, size=n, p=p / p.sum()).astype(np.int64)


def train_args(output: str) -> argparse.Namespace:
    """configs/train_nlp_v2.yaml written out, with the run cut to 1 epoch
    (32 steps; 2 before a cut for time) and the eval/save cadence to 32
    steps."""
    return argparse.Namespace(
        text_col="spu_name", label_col="tag_new_id", bert_preset="base",
        batch_size=128, max_length=128, epochs=1, tower_lr=1e-3,
        head_lr=1e-3, head_warmup_frac=0.0, tower_warmup_frac=0.0,
        weighted_sampling=True, eval_every=32, save_every=32, log_every=8,
        weight_decay=0.01, head_weight_decay=0.01, seq_buckets="48,64,96",
        no_clean=True, margin=0.4, margin_delta_per_epoch=0.0,
        optimizer="adamw", scheduler="linear", grad_accum=1,
        fused_loss=False, async_save=False, overwrite=False, seed=SEED,
        output=output)


def phase4(dev, arcface_ms: float) -> dict:
    rng = np.random.default_rng(SEED + 3)
    titles = make_titles(N_TRAIN + N_EVAL, rng)
    labels = zipf_labels(N_TRAIN + N_EVAL, AF_C, rng)
    train = {"spu_name": titles[:N_TRAIN], "tag_new_id": labels[:N_TRAIN]}
    held = {"spu_name": titles[N_TRAIN:], "tag_new_id": labels[N_TRAIN:]}
    out = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        args = train_args(out)
        tok = TextTokenizer.from_corpus(train["spu_name"])

        def source(table):
            return TextClassificationSource(
                table, tok, args.text_col, args.label_col, args.max_length,
                clean=not args.no_clean, seq_buckets=args.seq_buckets)

        src, eval_src = source(train), source(held)
        model = NlpTextClassifier(
            BertConfig.roberta_wwm_ext(), num_labels=AF_C,
            arcface=A.ArcFaceParams(m=args.margin),
            generator=torch.Generator().manual_seed(SEED))
        steps_per_epoch = len(src) // args.batch_size
        trainer = _trainer(text_arcface_task(model), args, steps_per_epoch,
                           device=dev)
        before = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.LAUNCHES["arcface"] = 0
        t0 = time.perf_counter()
        trainer.fit(src, args.epochs, args.batch_size, eval_src,
                    sampler_fn=_sampler_fn(args, train, args.label_col))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = A.LAUNCHES["arcface"]
        peak = torch.cuda.max_memory_allocated()
        steps = trainer.step
        if steps != args.epochs * steps_per_epoch or launches != steps:
            raise AssertionError(f"{steps} steps, {launches} ArcFace "
                                 f"launches; want {args.epochs} x "
                                 f"{steps_per_epoch} of each")

        lines = [json.loads(ln) for ln in open(
            os.path.join(out, "metrics.jsonl"), encoding="utf-8")]
        losses = [ln["train/loss"] for ln in lines if "train/loss" in ln]
        evals = [ln for ln in lines if "eval/acc" in ln]
        if len(losses) != steps // args.log_every \
                or len(evals) != steps // args.eval_every \
                or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"metrics: losses {losses}, evals {evals}")
        moved = {k: not torch.equal(v, before[k])
                 for k, v in model.state_dict().items()}
        if not moved["head.weight"] or not any(
                v for k, v in moved.items() if k.startswith("tower.")):
            raise AssertionError("the head or the tower did not move")
        restored = trainer.ckpt.restore()
        if restored["step"] != steps or not all(
                torch.equal(v.cpu(), restored["model"][k])
                for k, v in model.state_dict().items()):
            raise AssertionError("the last checkpoint does not restore the "
                                 "trained parameters")
        summary = trainer.timer.summary(args.batch_size)
        kernel_vs_plain = head_paths(model, src, dev, args.margin)
        profiled = profile_steps(trainer, src)
        return {"steps": steps, "fit_s": fit_s,
                "examples_per_s": summary["examples_per_sec"],
                "step_ms_p50": summary["p50_ms"],
                "step_ms_p95": summary["p95_ms"],
                "max_memory_allocated": peak, "arcface_launches": launches,
                "head_share": arcface_ms / summary["p50_ms"],
                "first_loss": losses[0], "last_loss": losses[-1],
                "eval_acc": [e["eval/acc"] for e in evals],
                "tower_params_moved": sum(moved.values()) - 1,
                **kernel_vs_plain, "profile": profiled,
                "config": "roberta_wwm_ext + 10205-class "
                "ArcFace head, configs/train_nlp_v2.yaml",
                "policy": "default training (f32 params, bf16 compute)"}
    finally:
        shutil.rmtree(out, ignore_errors=True)


def profile_steps(trainer, src, batch_size: int = 128, n: int = 6) -> dict:
    """Where a training step's device time goes: ``n`` (micro-)steps under
    ``torch.profiler`` (device activity only) on batches copied
    beforehand (so the loader is out of the window), kernel time by kind
    per step, and the device's busy share of the window's wall time (the
    profiler's own overhead makes the wall time longer than an unprofiled
    step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batches = [to_device(b, trainer.device) for b, _ in zip(
        src.batches(batch_size, seed=SEED + 9), range(n + 1))]
    trainer.train_step(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            trainer.train_step(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {"arcface kernel": ("arcface_kernel", "inv_norms_kernel"),
             "convolution (cuDNN)": ("fprop", "dgrad", "wgrad", "convolve",
                                     "conv2d", "depthwise"),
             "matmul (cuBLAS)": ("gemm", "nvjet", "sm90_", "cutlass",
                                 "xmma"),
             "optimizer": ("multi_tensor_apply",),
             "dtype casts and copies": ("copy_kernel",),
             "reductions (BN statistics, means)": ("reduce_kernel",),
             "elementwise": ("elementwise_kernel", "Functor")}
    by_kind = dict.fromkeys(list(kinds) + ["other"], 0.0)
    top = []
    for e in prof.key_averages():
        # kernels only: a user annotation (the optimizer's step range)
        # spans kernels that are counted themselves
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        ms = e.self_device_time_total / 1e3 / n
        kind = next((k for k, keys in kinds.items()
                     if any(t in e.key for t in keys)), "other")
        by_kind[kind] += ms
        top.append((ms, e.key[:80]))
    busy = sum(by_kind.values())
    return {"profiled_steps": n, "profiled_step_ms": wall_ms / n,
            "device_busy_ms_per_step": busy,
            "device_busy_share": busy * n / wall_ms,
            "device_ms_per_step_by_kind": by_kind,
            "top_kernels_ms_per_step": sorted(top, reverse=True)[:8]}


def head_paths(model, src, dev, m: float, batch_size: int = 128,
               embed=None) -> dict:
    """One batch with dropout off: the loss and every parameter gradient
    through the kernel path against the plain path. The loss is a CE over
    logits that agree within phase 3's tolerances, so it may differ by
    2 x the largest of them. The head's gradient (f32 throughout) must
    agree within 1e-3 of its largest entry (phase 3's reason). The tower's
    backward runs in bf16, where a gradient that enters it changed by
    1e-5 relative can flip roundings (one bf16 ulp is 2^-8 = 3.9e-3), so
    each tower gradient must agree within 2e-2 of its largest entry. A
    tensor whose gradient is nearly zero carries only rounding noise (the
    attention key biases, which softmax ignores, and the attention weights
    of saturated heads), so the scale of each comparison is at least 1e-4
    of the model's largest gradient. ``embed(batch)`` gives the
    embeddings (default: a text classifier's ``predict_emb`` of the
    batch's tokens)."""
    model.eval()
    batch = to_device(next(src.batches(batch_size, shuffle=False)), dev)
    if embed is None:
        def embed(b):
            return model.predict_emb(**{k: b[k] for k in (
                "input_ids", "attention_mask", "token_type_ids")})
    names, params = zip(*[(n, p) for n, p in model.named_parameters()
                          if p.requires_grad])
    af = model.head.params_af

    def loss_and_grads(head):
        emb = embed(batch)
        logits = head(emb, model.head.weight, batch["labels"], m, af.s,
                      af.easy_margin)
        loss = torch.nn.functional.cross_entropy(logits,
                                                 batch["labels"].long())
        return loss.detach(), torch.autograd.grad(loss, params)

    lk, gk = loss_and_grads(A.arcface_logits_fused)
    lp, gp = loss_and_grads(A.arcface_logits)
    edge = 64.0 * (AF_DCOS + math.sin(m) * math.sqrt(2.0 * AF_DCOS))
    loss_err = float((lk - lp).abs())
    if loss_err > 2.0 * edge:
        raise AssertionError(f"kernel-path loss {float(lk)} vs plain "
                             f"{float(lp)}")
    worst = {"head": 0.0, "tower": 0.0}
    top = max(float(b.abs().max()) for b in gp)
    for name, a, b in zip(names, gk, gp):
        group = "head" if name.startswith("head.") else "tower"
        scale = max(float(b.abs().max()), 1e-4 * top)
        rel = float((a - b).abs().max()) / scale
        if rel > (1e-3 if group == "head" else 2e-2):
            raise AssertionError(f"kernel-path gradient of {name} differs "
                                 f"by {rel} of its largest entry {scale}")
        worst[group] = max(worst[group], rel)
    return {"kernel_vs_plain_loss_abs_err": loss_err,
            "kernel_vs_plain_head_grad_rel_err": worst["head"],
            "kernel_vs_plain_tower_grad_rel_err": worst["tower"]}


def serve_args() -> argparse.Namespace:
    """configs/serve.yaml written out (the card machine has no YAML
    reader), with port 0 and the corpus passed as a table."""
    return argparse.Namespace(
        tower="bert", data="synthetic corpus (table=)", text_col="spu_name",
        key_col="spu_sn", category_col="first_level_category_id",
        tokenizer=None, checkpoint=None, bert_preset="base", num_labels=2,
        pool="cls", max_length=80, batch_size=64, length_buckets=None,
        k=13, score_th=0.9, host="127.0.0.1", port=0, max_batch=64,
        max_wait_ms=5.0, emb_table=None, emb_col="embedding",
        emb_table_cache=None, pallas_topk=False, approx_recall=None,
        int8=False)


def _ms_stats(lat) -> dict:
    p = np.percentile(np.asarray(lat) * 1e3, [50, 95, 99])
    return {"p50_ms": float(p[0]), "p95_ms": float(p[1]),
            "p99_ms": float(p[2])}


def serve_vs_plain(service, queries, dev, buckets=(1, 8, 64)) -> dict:
    """The fused path at each bucket against ``embed_device`` at the same
    bucket and the plain top-k (the engine's metric) on the same device
    corpus; then ``similar(score_th=None)`` (bucket 1) against the
    bucket-1 keys, in the metric's order."""
    embedder = service._embed_queries_device.__self__
    engine = service.engine
    corpus_dev, true_n, _ = engine._corpus_dev
    k, keys, metric = service.k, engine.keys, engine.metric
    errs, plain_b1 = {}, []
    for b in buckets:
        err = 0.0
        for s in range(0, len(queries), b):
            chunk = queries[s: s + b]
            got = service._run_batch([{"op": "similar", "query": t}
                                      for t in chunk])
            gv = torch.from_numpy(np.stack([g[0] for g in got])).to(dev)
            gi = torch.from_numpy(np.stack([g[1] for g in got])).to(dev)
            q = embedder.embed_device(chunk, pad_to=b).float()
            if engine._normalized:
                q = _normalize_rows(q)
            want = T.topk_plain(corpus_dev, q, k + 1, metric, true_n)
            want = (want[0][: len(chunk)], want[1][: len(chunk)])
            err = max(err, check_case(f"serve_b{b}", (gv, gi), want, k))
            if b == 1:
                plain_b1.append((want[0][0].cpu().numpy(),
                                 want[1][0].cpu().numpy()))
        errs[f"bucket_{b}"] = err
    for j, (pv, pi) in enumerate(plain_b1):
        got = service.similar(queries[j], score_th=None)
        gs = np.array([g["score"] for g in got])
        if len(got) != k or not np.allclose(gs, pv[:k], atol=ATOL,
                                            rtol=RTOL):
            raise AssertionError(f"similar(query {j}) scores {gs} vs plain "
                                 f"{pv[:k]}")
        order = np.diff(gs) if metric == "l2" else -np.diff(gs)
        if (order < 0).any():
            raise AssertionError(f"similar(query {j}): scores out of "
                                 f"{metric} order: {gs}")
        gap = np.abs(np.diff(pv))
        for r in range(k):
            if (r == 0 or gap[r - 1] > GAP) and gap[r] > GAP \
                    and got[r]["key"] != keys[pi[r]]:
                raise AssertionError(f"similar(query {j}) rank {r}: "
                                     f"{got[r]['key']} vs {keys[pi[r]]}")
    out = {"queries": len(queries), "max_abs_err_by_bucket": errs,
           "similar_checked": len(plain_b1)}
    if metric == "ip":
        d = engine._emb.shape[1]
        zs, zi = service._search_bucketed(np.zeros((1, d), np.float32), 1)
        if zs.any() or not (zi[0] == np.arange(k)).all():
            raise AssertionError(f"zero query: scores {zs[0]}, ids {zi[0]}")
        out["zero_query_ids"] = zi[0][:4].tolist()
    return out


def closed_loop(call, texts, c: int, n_req: int = None) -> dict:
    """``n_req`` (default max(96, 12 c)) calls from ``c`` threads, each
    starting its next call when the last returns; per-call latency on the
    host clock."""
    n_req = n_req or max(96, 12 * c)
    lat, failures, lock, nxt = [], [], threading.Lock(), [0]

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= n_req:
                return
            t0 = time.perf_counter()
            try:
                call(texts[i % len(texts)])
            except Exception as e:      # counted, and the level fails
                failures.append(repr(e))
                continue
            lat.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=client) for _ in range(c)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if failures:
        raise AssertionError(f"c={c}: {len(failures)} of {n_req} calls "
                             f"failed, first {failures[0]}")
    return {"c": c, "requests": n_req, "qps": n_req / wall, **_ms_stats(lat)}


def drive_levels(service, call, texts, levels=SERVE_LEVELS) -> list:
    rows = []
    for c in levels:
        service._batcher.stats["max_batch_seen"] = 0
        b0 = service.stats["batches"]
        row = closed_loop(call, texts, c)
        row["batches"] = service.stats["batches"] - b0
        row["max_batch_seen"] = service.stats["max_batch_seen"]
        rows.append(row)
    return rows


def _post(url, payload, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return json.loads(r.read())


def check_update_embed(base, titles, cats, rng) -> dict:
    """/update 64 new keys (titles with a unique suffix) and 64 existing
    ones; each new title then finds its own key at score >= 0.999."""
    new = [{"key": f"new{i:03d}", "text": titles[j] + f"新品{i:03d}",
            "category": cats[j]}
           for i, j in enumerate(rng.choice(len(titles), 64, replace=False))]
    old = [{"key": f"spu{j:06d}", "text": titles[j] + "改",
            "category": cats[j]}
           for j in rng.choice(len(titles), 64, replace=False)]
    res = _post(base + "/update", {"items": new + old})
    if res["corpus"] != N_SERVE + 64 or res["updated"] != 128:
        raise AssertionError(f"/update: {res}")
    own = []
    for it in new:
        got = _post(base + "/similar", {"text": it["text"],
                                        "score_th": None})["neighbors"]
        hit = [(r, g["score"]) for r, g in enumerate(got)
               if g["key"] == it["key"]]
        if not hit or hit[0][1] < 0.999:
            raise AssertionError(f"/similar after /update: {it['key']} "
                                 f"not found at >= 0.999 in {got[:3]}")
        own.append(hit[0])
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    if health["corpus"] != N_SERVE + 64:
        raise AssertionError(f"/healthz: {health}")
    emb = np.asarray(_post(base + "/embed", {"texts": titles[:8]})
                     ["embeddings"], np.float32)
    if emb.shape != (8, DIM) or not np.isfinite(emb).all():
        raise AssertionError(f"/embed: shape {emb.shape}")
    return {"updated": res["updated"], "corpus": health["corpus"],
            "own_rank_max": max(r for r, _ in own),
            "own_score_min": min(s for _, s in own),
            "embed_shape": list(emb.shape)}


def request_split(service, payloads, buckets=(1, 64), reps: int = 30,
                  first: str = "tokenize_upload") -> dict:
    """Median ms of each stage of one similar-only micro-batch at each
    bucket, by CUDA events on the worker's stream: host prep and upload
    (``first``: tokenize and/or the pinned uint8 copy, and its host
    time), tower, normalize + top-k, read-back into pinned memory, and
    the host wall of the whole request."""
    embedder = service._embed_queries_device.__self__
    engine = service.engine
    corpus_dev, true_n, _ = engine._corpus_dev
    out = {}
    for b in buckets:
        rows = []
        for r in range(reps):
            chunk = [payloads[(r * b + j) % len(payloads)]
                     for j in range(b)]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            inputs = embedder._inputs(chunk, b)
            t_prep = time.perf_counter() - t0
            ev[1].record()
            with torch.inference_mode():
                emb = embedder.tower_fn(*inputs)
                ev[2].record()
                q = emb.float()
                if engine._normalized:
                    q = _normalize_rows(q)
                v, i = knn_search(corpus_dev, q, service.k, engine.metric,
                                  true_n=true_n)
            ev[3].record()
            deferred = _read_back_later(v, i, b)
            ev[4].record()
            deferred.finish()
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            rows.append([t_prep * 1e3] + [ev[j].elapsed_time(ev[j + 1])
                                          for j in range(4)] + [wall * 1e3])
        med = np.median(np.asarray(rows), axis=0)
        out[f"bucket_{b}"] = dict(zip(
            (f"{first}_host_ms", f"{first}_ms", "tower_ms",
             "normalize_topk_ms", "readback_ms", "request_host_ms"),
            med.tolist()))
    return out


def profile_tower(service, payloads, buckets, n: int = 5) -> dict:
    """The tower's device work per call at each bucket: ``n`` calls under
    ``torch.profiler`` (device activity only) on inputs uploaded
    beforehand, the kernels launched per call, their device ms per call
    (the busy share of the window beside it) and the heaviest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    embedder = service._embed_queries_device.__self__
    out = {}
    for b in buckets:
        inputs = embedder._inputs(
            [payloads[j % len(payloads)] for j in range(b)], b)
        with torch.inference_mode():
            embedder.tower_fn(*inputs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.inference_mode():
                for _ in range(n):
                    embedder.tower_fn(*inputs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
        top = sorted(((e.self_device_time_total / 1e3 / n, e.count // n,
                       e.key[:90]) for e in kernels), reverse=True)[:8]
        out[f"bucket_{b}"] = {
            "kernel_launches_per_call": sum(e.count for e in kernels) // n,
            "device_ms_per_call": busy,
            "device_busy_share": busy * n / wall_ms,
            "top_kernels_ms_count": top}
    return out


def phase5(dev) -> dict:
    rng = np.random.default_rng(SEED + 5)
    titles = make_titles(N_SERVE, rng)
    cats = [int(c) for c in rng.integers(0, N_CATEGORIES, N_SERVE)]
    table = {"spu_sn": [f"spu{i:06d}" for i in range(N_SERVE)],
             "spu_name": titles, "first_level_category_id": cats}
    novel = make_titles(2048, np.random.default_rng(SEED + 6))
    args = serve_args()
    t0 = time.perf_counter()
    service, n = _build_serve_service(args, table=table, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        _warm_serve_service(service, args)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(json.dumps({"phase5_startup": {
            "corpus": n, "corpus_embed_s": build_s, "warm_s": warm_s}}),
            flush=True)
        picked = rng.choice(N_SERVE, 256, replace=False)
        checked = serve_vs_plain(
            service, [titles[i] for i in picked] + novel[:256], dev)

        # the main path: similar-only traffic over HTTP, then in-process
        httpd = make_server(service, args.host, args.port)
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        base = f"http://{args.host}:{httpd.server_address[1]}"
        try:
            T.LAUNCHES["topk"] = 0
            b0 = service.stats["batches"]
            http_rows = drive_levels(
                service, lambda t: _post(base + "/similar", {"text": t}),
                novel)
            inproc_rows = drive_levels(service, service.similar, novel)
            launches = T.LAUNCHES["topk"]
            batches = service.stats["batches"] - b0
            if launches != batches:
                raise AssertionError(f"{launches} top-k launches for "
                                     f"{batches} similar-only batches")
            updated = check_update_embed(base, titles, cats, rng)
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join(timeout=30)
        split = request_split(service, novel)
        tower = profile_tower(service, novel, (1, 64))
    finally:
        service.close()
    return {"corpus": n, "corpus_embed_s": build_s, "warm_s": warm_s,
            "fused_vs_plain": checked, "topk_launches": launches,
            "similar_batches": batches, "http": http_rows,
            "in_process": inproc_rows, "update": updated,
            "request_split": split, "tower_profile": tower,
            "config": "configs/serve.yaml: roberta_wwm_ext (base), "
                      "max_length 80, batch 64, k 13, score_th 0.9, "
                      "max_batch 64, max_wait 5 ms",
            "policy": "inference (bf16)"}


def seed_bn_statistics(model, seed: int, images, dev) -> None:
    """Backbone BatchNorm statistics as training leaves them, for a
    ``CvImageClassifier`` with random weights: variances and scales drawn
    around 1 from ``seed``, and each BN's mean measured on what reaches it
    from one batch of ``images``. A fresh init's 0 and 1 would make the
    fold nearly the identity; drawn means (or shifts) would swamp a
    random tower's activations, which shrink with depth, and collapse
    every image onto one embedding."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_var.copy_(torch.empty(n).uniform_(0.5, 2.0,
                                                            generator=g))
                m.weight.copy_(torch.empty(n).uniform_(0.8, 1.2,
                                                       generator=g))
    real = E.batch_norm

    def measuring(x, bn, dtype):
        if isinstance(bn, torch.nn.BatchNorm2d):
            bn.running_mean.copy_(x.float().mean(dim=(0, 2, 3)))
        return real(x, bn, dtype)

    model.to(dev)
    E.batch_norm = measuring
    try:
        with torch.no_grad():
            model.predict_emb(to_nchw(device_normalize(
                torch.from_numpy(images).to(dev))))
    finally:
        E.batch_norm = real
        model.cpu()


def seed_neck_statistics(model, images, dev) -> None:
    """The neck BatchNorm's running mean and (biased) variance measured on
    ``images``, as training leaves them, for a ``CvImageClassifier``
    with random weights (a fresh init's 0 and 1 keep the part every
    image's features share)."""
    model.to(dev)
    bn, model.bn = model.bn, None
    try:
        with torch.no_grad():
            fc = model.predict_emb(to_nchw(device_normalize(
                torch.from_numpy(images).to(dev)))).float()
            bn.running_mean.copy_(fc.mean(0))
            bn.running_var.copy_(fc.var(0, unbiased=False))
    finally:
        model.bn = bn
        model.cpu()


def cv_args(work: str) -> argparse.Namespace:
    """configs/serve_cv.yaml written out, with port 0, the corpus as a
    table, and the checkpoint, the packed cache (``--emb_cache``) and an
    empty image root under ``work``."""
    return argparse.Namespace(
        tower="cv", data="synthetic corpus (table=)", key_col="spu_sn",
        text_col="spu_name", category_col="first_level_category_id",
        backbone=BACKBONE, image_size=CV_SIZE, fc_dim=CV_DIM,
        img_root=os.path.join(work, "images"), num_labels=CV_LABELS,
        batch_size=64, k=13, score_th=0.15, host="127.0.0.1", port=0,
        max_batch=64, max_wait_ms=5.0,
        checkpoint=os.path.join(work, "ckpt"),
        emb_cache=os.path.join(work, "emb_cache"), emb_table=None,
        emb_col="embedding", emb_table_cache=None, pallas_topk=False,
        approx_recall=None)


def fold_check(state_dict, images, dev) -> dict:
    """The folded tower against the unfolded one under the full-precision
    policy (TF32 off) on ``images``. Folding is exact math, so they may
    differ by f32 rounding only: max |a - b| <= FOLD_RTOL * max |b|."""
    cfg = backbone_config(BACKBONE)
    pol = DTypePolicy.full_precision()
    plain = CvImageClassifier(cfg, CV_LABELS, fc_dim=CV_DIM, policy=pol)
    plain.load_state_dict(state_dict)
    fcfg, fsd = fold_cv_classifier(state_dict, cfg)
    folded = CvImageClassifier(fcfg, CV_LABELS, fc_dim=CV_DIM, policy=pol)
    folded.load_state_dict(fsd)
    x = to_nchw(device_normalize(torch.from_numpy(images).to(dev)))
    outs = []
    for m in (plain, folded):
        m = m.to(dev, memory_format=torch.channels_last)
        with torch.inference_mode():
            outs.append(m.predict_emb(x))
    err = float((outs[0] - outs[1]).abs().max())
    scale = float(outs[0].abs().max())
    if not err <= FOLD_RTOL * scale:
        raise AssertionError(f"folded vs unfolded: max abs err {err}, "
                             f"largest |emb| {scale}")
    return {"images": len(images), "max_abs_err": err, "max_abs": scale,
            "tolerance": f"{FOLD_RTOL} x max |emb|, f32, TF32 off"}


def own_first(service, payloads, keys, ok) -> dict:
    """Each payload, queried alone, finds its own key first with a score
    that ``ok`` accepts."""
    worst = None
    for p, key in zip(payloads, keys):
        top = service.similar(p, score_th=None)[0]
        if top["key"] != key or not ok(top["score"]):
            raise AssertionError(f"{key}: first neighbour {top}")
        s = top["score"]
        worst = s if worst is None else (min(worst, s)
                                         if service.engine.metric == "ip"
                                         else max(worst, s))
    return {"checked": len(keys), "worst_own_score": worst}


def load_and_launches(service, payloads, levels) -> dict:
    """In-process closed-loop load at ``levels``; the top-k launches,
    counted from 0, must equal the micro-batches run."""
    T.LAUNCHES["topk"] = 0
    b0 = service.stats["batches"]
    rows = drive_levels(service, service.similar, payloads, levels)
    launches = T.LAUNCHES["topk"]
    batches = service.stats["batches"] - b0
    if launches != batches:
        raise AssertionError(f"{launches} top-k launches for {batches} "
                             f"similar-only batches")
    return {"in_process": rows, "topk_launches": launches,
            "similar_batches": batches}


def update_and_embed(service, payloads, keys, cats, ok, dim) -> dict:
    """``update`` new keys, each then found first by itself; ``embed``."""
    n0 = service.engine.n
    n = service.update(payloads, keys, categories=cats)
    if n != n0 + len(keys):
        raise AssertionError(f"update: corpus {n}, want {n0 + len(keys)}")
    found = own_first(service, payloads, keys, ok)
    emb = service.embed(payloads[:8])
    if emb.shape != (8, dim) or not np.isfinite(emb).all():
        raise AssertionError(f"embed: shape {emb.shape}")
    return {"updated": len(keys), "corpus": n, **found,
            "embed_shape": list(emb.shape)}


def jpeg_payloads(images, titles=None) -> list:
    """``/similar`` bodies of ``images`` (RGB uint8) as base64 JPEGs that
    ``cv2.imencode`` makes at its default quality, each with its title
    when ``titles`` is given (the fused tower's pairs), no threshold."""
    import cv2
    out = []
    for i, img in enumerate(images):
        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        if not ok:
            raise AssertionError("cv2 could not encode a JPEG")
        body = {"image_b64": base64.b64encode(buf.tobytes()).decode(),
                "score_th": None}
        if titles is not None:
            body["text"] = titles[i]
        out.append(body)
    return out


def _query_id(query) -> tuple:
    """A parsed image query (an array, or a (title, array) pair) as a
    hashable id."""
    import hashlib
    text, img = query if isinstance(query, tuple) else (None, query)
    return text, hashlib.sha1(np.ascontiguousarray(img).tobytes()).digest()


def http_images(service, args, payloads) -> dict:
    """An image daemon over HTTP (``image_b64``): ``make_server`` on a free
    local port, ``payloads`` sent to ``/similar`` by closed-loop clients
    at c = 1 and 16, each payload once a level, with the top-k launch
    count set to 0 just before and held equal to the micro-batches just
    after, and the bucket each request ran at recorded. Every answer is
    held against the in-process answer to the same decoded query (what
    the handler parses, ``service.parser.one``) at the bucket it was
    served at (``same_answer``, phase 1's tolerances): a query's bf16
    embedding depends on its bucket's shapes, not on the other queries.
    The JPEG round trip moves pixels, so the raw arrays are not what an
    answer is held against."""
    t0 = time.perf_counter()
    decoded = [service.parser.one(p) for p in payloads]
    ids = {_query_id(q): i for i, q in enumerate(decoded)}
    buckets, level = {}, [None]
    try_batch = service._try_device_batch

    def recorded(queries, n):
        for q in queries:
            buckets.setdefault(level[0], {})[ids[_query_id(q)]] = \
                service._bucket_size(n)
        return try_batch(queries, n)

    service._try_device_batch = recorded
    httpd = make_server(service, args.host, args.port)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://{args.host}:{httpd.server_address[1]}"
    answers, rows = {}, []
    try:
        T.LAUNCHES["topk"] = 0
        b0 = service.stats["batches"]
        for c in HTTP_IMAGE_LEVELS:
            level[0] = c
            got = answers.setdefault(c, {})

            def call(i, got=got):
                got[i] = _post(base + "/similar", payloads[i])["neighbors"]

            b1 = service.stats["batches"]
            row = closed_loop(call, list(range(len(payloads))), c,
                              n_req=len(payloads))
            row["batches"] = service.stats["batches"] - b1
            row["buckets"] = dict(collections.Counter(buckets[c].values()))
            rows.append(row)
        launches = T.LAUNCHES["topk"]
        batches = service.stats["batches"] - b0
    finally:
        service._try_device_batch = try_batch
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    if launches != batches:
        raise AssertionError(f"image HTTP: {launches} top-k launches for "
                             f"{batches} similar-only batches")
    wall = {"http_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    keys, k = service.engine.keys, service.k

    def answer(queries, b):
        """In-process answers to ``queries`` at bucket ``b`` (the batch
        filled to ``b`` with the first query)."""
        fill = list(queries) + [queries[0]] * (b - len(queries))
        got = service._run_batch([{"op": "similar", "query": q}
                                  for q in fill])
        return [[{"key": str(keys[j]), "score": float(v)}
                 for v, j in zip(sc[:k], ix[:k])]
                for sc, ix in got[:len(queries)]]

    need = collections.defaultdict(set)     # bucket -> requests served at it
    for served_at in buckets.values():
        for i, b in served_at.items():
            need[b].add(i)
    table = {}
    for b, served in need.items():
        served = sorted(served)
        for s in range(0, len(served), b):
            chunk = served[s: s + b]
            for j, ans in zip(chunk, answer([decoded[j] for j in chunk],
                                            b)):
                table[(j, b)] = ans
    held = 0
    for c, got in answers.items():
        for i, ans in got.items():
            same_answer(f"image HTTP c={c} request {i}", ans,
                        table[(i, buckets[c][i])])
            held += 1
    wall["held_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    corpus, true_n, _ = service.engine._corpus_dev
    blocks = [timed_search(corpus, corpus[:b].clone(), k,
                           service.engine.metric, true_n)
              for b in sorted(need)]
    wall["blocks_s"] = time.perf_counter() - t0
    return {"levels": rows, "answers_held": held, "topk_launches": launches,
            "blocks": blocks, "similar_batches": batches, "wall_s": wall,
            "tolerance": "each answer against the in-process answer to its "
                         "decoded JPEG at its bucket: keys equal where "
                         "neighbouring scores differ by more than 1e-5, "
                         "scores within atol 1e-4, rtol 1e-5"}


def print_image_http(tower, http, load) -> None:
    """One line: the image daemon's HTTP levels beside the in-process
    ones at the same concurrency, with the card's name and power
    limit."""
    print(json.dumps({"image_http": {
        "tower": tower, "card": card_line(), "http": http["levels"],
        "in_process": [r for r in load["in_process"]
                       if r["c"] in HTTP_IMAGE_LEVELS]}}), flush=True)


WITNESS_COS = 0.9999      # alone vs in its batch, full precision


def full_precision_copy(model):
    """A copy of ``model`` whose every policy is the full-precision one."""
    model = copy.deepcopy(model)
    for m in model.modules():
        if hasattr(m, "policy"):
            m.policy = DTypePolicy.full_precision()
    return model


def precision_witness(embedder, images) -> dict:
    """Each of ``images`` embedded alone (bucket 1) against its row of
    their batch, as the serving policy computes them and as a
    full-precision copy of the tower does (TF32 off): the least cosine of
    each. In full precision the two must agree to ``WITNESS_COS``, so
    what parts a query from its corpus row under the serving policy is
    that policy's rounding, not the batch it ran in."""
    f32 = ImageEmbedder(full_precision_copy(embedder.model),
                        embedder.image_size, embedder.batch_size,
                        device=embedder.device)
    out = {"images": len(images)}
    for name, emb in (("serving", embedder), ("full_precision", f32)):
        batch = emb.embed_device(list(images), pad_to=len(images)).float()
        alone = torch.cat([emb.embed_device([im], pad_to=1)
                           for im in images]).float()
        out[f"{name}_cos_min"] = float(torch.nn.functional.cosine_similarity(
            alone, batch, dim=1).min())
    if not out["full_precision_cos_min"] >= WITNESS_COS:
        raise AssertionError(f"alone vs batch in full precision: {out}")
    return out


def phase6(dev, backbone=BACKBONE, size=CV_SIZE, n_images=N_CV_IMAGES,
           seed=SEED, own_score=0.999, http=True) -> dict:
    """``serve --tower cv`` at configs/serve_cv.yaml with ``backbone`` at
    ``size`` px (see the docstring): an EfficientNet gets seeded backbone
    BN statistics and is checked folded against unfolded; a ViT or
    ConvNeXt, which has no backbone BN, gets its neck's statistics
    measured. Each corpus image must find its own key first at
    ``own_score``. ``http``: the 64 novel images as ``image_b64`` requests
    over HTTP too (``http_images``)."""
    work = tempfile.mkdtemp(prefix="chip_smoke_cv_")
    try:
        args = cv_args(work)
        args.backbone, args.image_size = backbone, size
        cfg = backbone_config(backbone, image_size=size)
        model = CvImageClassifier(cfg, CV_LABELS, fc_dim=CV_DIM,
                                  generator=torch.Generator().manual_seed(
                                      seed))
        rng = np.random.default_rng(seed + 7)
        probe = make_images(np.random.default_rng(seed + 8), 64, size)
        folds = isinstance(cfg, E.EfficientNetConfig)
        if folds:
            seed_bn_statistics(model, seed + 7, probe[:8], dev)
        else:
            seed_neck_statistics(model, probe, dev)
        CheckpointManager(args.checkpoint).save(0, {"model":
                                                    model.state_dict()})
        fold = fold_check(model.state_dict(), probe, dev) if folds else None
        del model
        torch.cuda.empty_cache()

        # 1. the corpus pass, through the tower the service will load
        embedder = _cv_embedder(args, device=dev)
        tower = embedder.model
        if type(tower.backbone).__name__ != type(cfg).__name__[:-6] \
                or any(isinstance(m, torch.nn.BatchNorm2d)
                       for m in tower.modules()) \
                or (hasattr(cfg, "num_tokens")
                    and tower.backbone.pos_embed.shape[1] != cfg.num_tokens):
            raise AssertionError(f"_load_cv_tower: not the {backbone} "
                                 f"tower at {size} px with no backbone BN")
        del tower
        embedder.embed_batch(probe)                  # warm-up, not timed
        parts, embed_s, first = [], 0.0, None
        for _ in range(n_images // CV_CHUNK):
            imgs = make_images(rng, CV_CHUNK, size)
            if first is None:
                first = imgs[:64].copy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts.append(embedder.embed_batch(imgs))
            embed_s += time.perf_counter() - t0
        img_emb = np.concatenate(parts)
        if img_emb.shape != (n_images, CV_DIM) \
                or not np.isfinite(img_emb).all():
            raise AssertionError(f"corpus embeddings {img_emb.shape}")
        witness = precision_witness(embedder, first)
        del embedder, parts
        torch.cuda.empty_cache()

        # 2. the corpus: those vectors and seeded unit vectors in the
        # packed cache, so no key decodes an image
        keys = ([f"img{i:05d}" for i in range(n_images)]
                + [f"syn{i:06d}" for i in range(N_CV_CORPUS - n_images)])
        syn = rng.standard_normal((N_CV_CORPUS - n_images, CV_DIM),
                                  dtype=np.float32)
        syn /= np.linalg.norm(syn, axis=1, keepdims=True)
        cache = EmbeddingCache.open(args.emb_cache, CV_DIM)
        cache.put_many(dict(zip(keys, np.concatenate([img_emb, syn]))))
        cats = [int(c) for c in rng.integers(0, N_CATEGORIES, N_CV_CORPUS)]
        table = {"spu_sn": keys, "first_level_category_id": cats}

        # 3. build and warm
        t0 = time.perf_counter()
        service, n = _build_serve_service(args, table=table, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            _warm_serve_service(service, args)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            print(json.dumps({"serve_cv_startup": {
                "backbone": backbone, "corpus": n,
                "corpus_images_per_s": n_images / embed_s,
                "build_s": build_s, "warm_s": warm_s, "fold": fold,
                "precision_witness": witness}}), flush=True)
            # 4. checks
            novel = make_images(np.random.default_rng(seed + 9), 64, size)
            checked = serve_vs_plain(service, list(first[:32])
                                     + list(novel[:32]), dev)
            own = own_first(service, list(first), keys[:64],
                            lambda s: s >= own_score)
            load = load_and_launches(service, list(novel), CV_LEVELS)
            image_http = http_images(service, args, jpeg_payloads(
                novel[:N_HTTP_IMAGES])) if http else None
            if http:
                print_image_http(f"cv ({backbone} at {size} px)",
                                 image_http, load)
            new = make_images(np.random.default_rng(seed + 10), 64, size)
            updated = update_and_embed(
                service, list(new), [f"new{i:03d}" for i in range(64)],
                [int(c) for c in rng.integers(0, N_CATEGORIES, 64)],
                lambda s: s >= own_score, CV_DIM)
            split = request_split(service, list(novel), first="upload")
            prof = profile_tower(service, list(novel), (1, 64))
        finally:
            service.close()
        cache.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"corpus": n, "corpus_images": n_images,
            "corpus_images_per_s": n_images / embed_s,
            "corpus_embed_s": embed_s, "build_s": build_s, "warm_s": warm_s,
            "fold": fold, "precision_witness": witness,
            "fused_vs_plain": checked, "own_first": own,
            "own_score_limit": own_score, **load, "image_http": image_http,
            "update": updated, "request_split": split,
            "tower_profile": prof,
            "config": f"configs/serve_cv.yaml with --backbone {backbone} "
                      f"--image_size {size}: fc 512, 4181 labels, batch "
                      f"64, k 13, score_th 0.15, max_batch 64, max_wait 5 "
                      f"ms, " + ("BN folded" if folds else
                                 "neck BN statistics measured"),
            "policy": "inference (bf16)"}


def mm_args(work: str) -> argparse.Namespace:
    """configs/serve_multimodal.yaml written out (``bert_preset:
    roberta_wwm_ext`` is the ``base`` preset), with port 0, the corpus as
    a table, and the checkpoint and vocab under ``work``."""
    return argparse.Namespace(
        tower="multimodal", data="synthetic pairs (table=)",
        key_col="spu_sn", text_col="spu_name", category_col=None,
        backbone=BACKBONE, bert_preset="base", image_size=MM_SIZE,
        fc_dim=CV_DIM, num_labels=MM_LABELS, max_length=128,
        img_root=os.path.join(work, "images"), batch_size=48, k=13,
        score_th=None, host="127.0.0.1", port=0, max_batch=48,
        max_wait_ms=5.0, checkpoint=os.path.join(work, "ckpt"),
        tokenizer=os.path.join(work, "vocab.txt"), emb_table=None,
        emb_col="embedding", emb_table_cache=None, pallas_topk=False,
        approx_recall=None)


def phase7(dev) -> dict:
    """``serve --tower multimodal`` and ``multimodal_similar_job`` (see
    the docstring)."""
    work = tempfile.mkdtemp(prefix="chip_smoke_mm_")
    rng = np.random.default_rng(SEED + 11)
    try:
        args = mm_args(work)
        titles = make_titles(N_MM + 96, rng)
        keys = [f"spu{i:06d}" for i in range(N_MM)]
        table = {"spu_sn": keys, "spu_name": titles[:N_MM]}
        build_char_vocab(titles, out_path=args.tokenizer)
        model = MultimodalClassifier(
            BertConfig.roberta_wwm_ext(), backbone_config(BACKBONE),
            num_labels=MM_LABELS, fc_dim=CV_DIM,
            generator=torch.Generator().manual_seed(SEED))
        seed_bn_statistics(model.cv, SEED + 12, make_images(
            np.random.default_rng(SEED + 12), 8, MM_SIZE), dev)
        CheckpointManager(args.checkpoint).save(0, {"model":
                                                    model.state_dict()})
        del model
        embedder = _multimodal_embedder(args, table, device=dev)

        # 1. embed the pairs, in _fused_embeddings' chunks of 8 batches
        chunk = 8 * args.batch_size
        embedder(make_images(np.random.default_rng(SEED + 13), 48, MM_SIZE),
                 titles[:48])                        # warm-up, not timed
        parts, embed_s, first = [], 0.0, None
        for s in range(0, N_MM, chunk):
            n = min(chunk, N_MM - s)
            imgs = make_images(rng, n, MM_SIZE)
            if first is None:
                first = imgs[:48].copy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts.append(embedder(imgs, titles[s: s + n]))
            embed_s += time.perf_counter() - t0
        emb = np.concatenate(parts)
        halves = np.linalg.norm(emb[:, :CV_DIM], axis=1), np.linalg.norm(
            emb[:, CV_DIM:], axis=1)
        if emb.shape != (N_MM, MM_DIM) or not np.isfinite(emb).all() \
                or max(float(np.abs(h - 1).max()) for h in halves) > 1e-2:
            raise AssertionError(f"fused embeddings {emb.shape}, halves' "
                                 "norms not 1")

        # 2. the job, into an in-memory KV sink
        sink = InMemoryKVSink()
        T.LAUNCHES["topk"] = 0
        t0 = time.perf_counter()
        written = multimodal_similar_job(table, emb, sink, k=13, device=dev)
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        job_launches = T.LAUNCHES["topk"]
        if job_launches < 1 or written <= 0:
            raise AssertionError(f"job: {job_launches} launches, "
                                 f"{written} keys written")
        known = set(keys)
        for key in sink.keys()[:2000]:
            spu = key.removeprefix("dj_similar:")
            nbrs = sink.get(key).split(",")
            if spu not in known or spu in nbrs or not set(nbrs) <= known \
                    or len(nbrs) > 12:
                raise AssertionError(f"bad KV item {key} -> {nbrs[:5]}")
        engine = SimilarityEngine(emb, keys, metric="l2", normalize=False,
                                  device=dev)
        scores, idx = engine.search(13)
        corpus_dev, true_n, _ = engine._corpus_dev
        rows = np.sort(rng.choice(N_MM, size=min(256, N_MM), replace=False))
        want = T.topk_plain(corpus_dev, torch.from_numpy(emb[rows]).to(dev),
                            14, "l2", true_n)
        job_err = check_case("mm_job", (
            torch.from_numpy(scores[rows]).to(dev),
            torch.from_numpy(idx[rows]).to(dev)), want, 13)

        # 3. the service from the same vectors, through the helper
        # _build_serve_service ends in
        def embed_queries(pairs):
            pairs = list(pairs)
            return embedder(np.stack([img for _, img in pairs]),
                            [text for text, _ in pairs])

        t0 = time.perf_counter()
        service = _service_from_corpus(
            args, emb, keys, None, embed_queries, embedder,
            parser=MultimodalQueryParser(args.image_size), metric="l2",
            normalize=False, device=dev)
        _warm_serve_service(service, args)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        try:
            print(json.dumps({"phase7_startup": {
                "pairs": N_MM, "pairs_per_s": N_MM / embed_s,
                "job_s": job_s, "job_topk_launches": job_launches,
                "warm_s": warm_s}}), flush=True)
            pairs = list(zip(titles[:48], first))
            novel_imgs = make_images(np.random.default_rng(SEED + 14), 48,
                                     MM_SIZE)
            novel = list(zip(titles[N_MM: N_MM + 48], novel_imgs))
            checked = serve_vs_plain(service, pairs[:24] + novel[:24], dev,
                                     buckets=(1, 8, 48))
            own = own_first(service, pairs, keys[:48], lambda s: s <= 1e-3)
            load = load_and_launches(service, novel, MM_LEVELS)
            image_http = http_images(service, args, jpeg_payloads(
                novel_imgs[:N_HTTP_IMAGES],
                titles[N_MM: N_MM + N_HTTP_IMAGES]))
            print_image_http("multimodal (efficientnet_b4 at 380 px + "
                             "roberta_wwm_ext)", image_http, load)
            new_imgs = make_images(np.random.default_rng(SEED + 15), 48,
                                   MM_SIZE)
            updated = update_and_embed(
                service, list(zip(titles[N_MM + 48: N_MM + 96], new_imgs)),
                [f"new{i:03d}" for i in range(48)], None,
                lambda s: s <= 1e-3, MM_DIM)
            split = request_split(service, novel, buckets=(1, 48))
            tower = profile_tower(service, novel, (1, 48))
        finally:
            service.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"pairs": N_MM, "pairs_per_s": N_MM / embed_s,
            "embed_s": embed_s, "job_written": written, "job_s": job_s,
            "job_topk_launches": job_launches,
            "job_sample_max_abs_err": job_err, "warm_s": warm_s,
            "fused_vs_plain": checked, "own_first": own, **load,
            "image_http": image_http, "update": updated,
            "request_split": split, "tower_profile": tower,
            "config": "configs/serve_multimodal.yaml: efficientnet_b4 at "
                      "380 px + roberta_wwm_ext (base), max_length 128, "
                      "fused 1280-d, 796 labels, batch and max_batch 48, "
                      "k 13, un-normalized l2, no threshold",
            "policy": "inference (bf16)"}


# -- the large-k route (phase 1) --------------------------------------------

AREA_ROWS, FT_DIM = 8_300, 100          # one daodian area, fastText width
SELECT_LIBRARY = ("torch.sort(q @ x.T, descending=True, stable=True), first "
                  "k columns (l2: |q|^2 - 2 q @ x.T + |x|^2 ascending; "
                  "cuBLAS SGEMM, TF32 off)")


def select_library(corpus, queries, k, metric, true_n=None):
    """One library computation of the large-k route's function
    (``SELECT_LIBRARY``); the port never calls it."""
    real = corpus[:true_n] if true_n else corpus
    s = queries @ real.T
    if metric == "l2":
        s = (queries * queries).sum(1, keepdim=True) - 2.0 * s \
            + (real * real).sum(1)[None, :]
        v, i = torch.sort(s, dim=1, stable=True)
    else:
        v, i = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def select_cases(dev) -> dict:
    """The large-k route (products, then ``csrc/topk_select.cu``) against
    the plain version at the daodian shapes, with phase 1's tolerances."""
    rng = np.random.default_rng(SEED + 20)
    cases, max_err = [], 0.0

    def run(name, corpus, queries, k, metric="ip", true_n=None,
            exact=False, timed=True):
        nonlocal max_err
        n_real = true_n or corpus.shape[0]
        got = T.topk_select_cuda(corpus, queries, k, metric, true_n)
        want = T.topk_plain(corpus, queries, k + 1, metric, true_n)
        torch.cuda.synchronize()
        if int(got[1].max()) >= n_real or int(got[1].min()) < 0:
            raise AssertionError(f"{name}: a pad row came back")
        max_err = max(max_err, check_case(name, got, want, min(k, n_real),
                                          exact))
        del got, want
        row = {"case": name, "q": queries.shape[0], "n": corpus.shape[0],
               "true_n": n_real, "d": queries.shape[1], "k": min(k, n_real),
               "metric": metric}
        if timed:
            row["ms"] = cuda_ms(lambda: T.topk_select_cuda(
                corpus, queries, k, metric, true_n))
            row["plain_ms"] = cuda_ms(lambda: T.topk_plain(
                corpus, queries, k, metric, true_n), reps=1)
            row["library_ms"] = cuda_ms(lambda: select_library(
                corpus, queries, k, metric, true_n))
            row["bound_ms"], row["bound_by"] = T.bound_ms(
                queries.shape[0], n_real, queries.shape[1], min(k, n_real),
                metric)
        cases.append(row)
        torch.cuda.empty_cache()
        return row

    area = unit_rows(rng, AREA_ROWS, FT_DIM, dev)
    main = run("area_self_k_n7", area, area, AREA_ROWS // 7)
    run("area_self_k_n", area, area, AREA_ROWS)
    # the v1 text arm ranks each lv1 group by itself (30 groups an area);
    # the v2 cv arm searches the area's rows with a photo at d = 512
    group = area[: AREA_ROWS // 30]
    run("lv1_group_k_n", group, group, group.shape[0])
    n_cv = AREA_ROWS - AREA_ROWS // 50
    cv_area = unit_rows(rng, n_cv, CV_DIM, dev)
    run("cv_area_self_k_n7", cv_area, cv_area, n_cv // 7)
    del cv_area
    run("adhoc_q1_k_n", area, area[:1], AREA_ROWS)
    run("adhoc_q16_k_n", area, unit_rows(rng, 16, FT_DIM, dev), AREA_ROWS)
    long = unit_rows(rng, 30_000, FT_DIM, dev)
    run("long_n30000_k_n", long, long[:256], 30_000)
    del long
    for metric, fill in (("ip", 0.0), ("l2", 1e18)):
        padded = torch.cat([area, torch.full((16_384 - AREA_ROWS, FT_DIM),
                                             fill, device=dev)])
        run(f"padded_{metric}_k_true_n", padded, area[:512], 16_384, metric,
            true_n=AREA_ROWS, timed=False)
    ints = torch.from_numpy(rng.integers(-3, 4, size=(AREA_ROWS, FT_DIM))
                            .astype(np.float32)).to(dev)
    ints[4000:4500] = ints[:500]            # duplicate rows: exact ties
    for metric in ("ip", "l2"):
        run(f"ties_{metric}_k_n", ints, ints[:512], AREA_ROWS, metric,
            exact=True, timed=False)
    zeros = torch.from_numpy(rng.integers(-1, 2, size=(AREA_ROWS, 4))
                             .astype(np.float32)).to(dev)
    run("zero_scores_k_n", zeros, -zeros[:256], AREA_ROWS, exact=True,
        timed=False)
    x512 = unit_rows(rng, 50_000, CV_DIM, dev)
    run("l2_d512_k300", x512, unit_rows(rng, 256, CV_DIM, dev), 300, "l2")
    return {"cases": cases, "main": main, "max_abs_err": max_err}


# -- phase 8: the daodian slice ---------------------------------------------

N_FT_TITLES, FT_LABELS, FT_WORDS = 100_000, 30, 4_000
N_AREAS, RECENT_DAYS, N_DD_PHOTOS = 12, 7, 2_048
DD_DAYS = [f"2026-08-{d:02d}" for d in range(10, 17)]
DD_LEVELS = (1, 16)


def title_words(seed: int = SEED + 30) -> tuple:
    """(shared words, per-label topic words): 2-3 CJK characters each."""
    rng = np.random.default_rng(seed)
    chars = np.array([chr(0x4E00 + i) for i in range(3000)])
    n = FT_WORDS + FT_LABELS * 120
    words = ["".join(chars[rng.integers(0, 3000, m)])
             for m in rng.integers(2, 4, n)]
    return words[:FT_WORDS], [words[FT_WORDS + 120 * c:
                                    FT_WORDS + 120 * (c + 1)]
                              for c in range(FT_LABELS)]


def daodian_titles(rng, labels, words) -> list:
    """Space-separated titles of 4-10 words, half from the label's 120
    topic words, half from the 4,000 shared ones; one in ten repeats an
    earlier title of its label (a relisted product)."""
    shared, topic = words
    out, last = [], {}
    for lab in labels:
        lab = int(lab)
        if lab in last and rng.random() < 0.1:
            out.append(last[lab])
            continue
        m = int(rng.integers(4, 11))
        t = " ".join([topic[lab][j] for j in rng.integers(0, 120, m // 2)]
                     + [shared[j] for j in
                        rng.integers(0, FT_WORDS, m - m // 2)])
        last[lab] = t
        out.append(t)
    return out


def daodian_table(rng, words, n_areas: int = N_AREAS, rows=None) -> dict:
    """``n_areas`` areas (12 by default) of 8,300 rows (``rows``: the
    size of each): title, lv1 (30 labels) and lv2 (4 under each), a sku
    per row and dts over the 7 days of the window."""
    rows = list(rows or [AREA_ROWS] * n_areas)
    n = sum(rows)
    lv1 = rng.integers(0, FT_LABELS, n)
    return {"area_id": [int(a) for a in np.repeat(np.arange(len(rows)),
                                                  rows)],
            "spu_sn": [f"dd{i:06d}" for i in range(n)],
            "sku": [f"{700000 + i}" for i in range(n)],
            "title": daodian_titles(rng, lv1, words),
            "first_level_category_id": [int(v) for v in lv1],
            "second_level_category_id": [int(v) for v in
                                         lv1 * 10 + rng.integers(0, 4, n)],
            "dt": [DD_DAYS[int(j)] for j in rng.integers(0, RECENT_DAYS, n)]}


def dd_args(work: str) -> argparse.Namespace:
    """configs/serve_daodian.yaml written out (the JAX parser's defaults
    for the rest), with port 0 and the checkpoint, fastText model, packed
    cache and an empty image root under ``work``; ``checkpoint`` and
    ``num_labels`` also name the cv tower for ``_cv_embedder``."""
    ckpt = os.path.join(work, "cv_ckpt")
    return argparse.Namespace(
        tower="daodian", data="synthetic areas (table=)",
        fasttext_model=os.path.join(work, "fasttext.pt"),
        cv_checkpoint=ckpt, checkpoint=ckpt, cv_num_labels=CV_LABELS,
        num_labels=CV_LABELS, backbone=BACKBONE, fc_dim=CV_DIM,
        image_size=CV_SIZE, img_root=os.path.join(work, "images"),
        key_col="spu_sn", area_col="area_id", sku_col="sku",
        emb_cache=os.path.join(work, "emb_cache"), host="127.0.0.1",
        port=0, batch_size=64, max_batch=64, max_wait_ms=5.0,
        text_only=False, nlp_score_th=-0.6, cv_score_th=0.15,
        ann_cnt_nlp=100, ann_cnt_cv=26, score_th=None, k=13,
        pallas_topk=False, approx_recall=None)


class _Split:
    """Host seconds spent in wrapped callables, by stage; a call inside a
    call of the same stage is not counted twice. ``sync`` waits for the
    card before the clock stops (device searches return early)."""

    def __init__(self):
        self.s = {}
        self._active = set()

    def wrap(self, stage, fn, sync=False):
        def timed(*a, **kw):
            if stage in self._active:
                return fn(*a, **kw)
            self._active.add(stage)
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                self._active.discard(stage)
                self.s[stage] = self.s.get(stage, 0.0) \
                    + time.perf_counter() - t0
        return timed


def _timed_job(table, embed_titles, embed_skus, dev, **kw) -> tuple:
    """``daodian_similar_job`` with its stages timed: embed (text, cv),
    search (``SimilarityEngine.search`` and ``knn_search``, read-backs
    included), filters (``filter_neighbors``), sink (``set_many``); and
    the first text and cv self-searches kept for the plain check."""
    import multimodalsimilar_tpu_torch.retrieval.engine as engine_mod
    split, kept = _Split(), {}
    sink = InMemoryKVSink()
    orig = (SimilarityEngine.search, engine_mod.knn_search,
            engine_mod.filter_neighbors)

    def search(self, k, queries=None):
        out = orig[0](self, k, queries)
        if queries is None:
            kept.setdefault(self.dim, (self, k, out))
        return out

    SimilarityEngine.search = split.wrap("search", search)
    engine_mod.knn_search = split.wrap("search", orig[1], sync=True)
    engine_mod.filter_neighbors = split.wrap("filters", orig[2])
    sink.set_many = split.wrap("sink", sink.set_many)
    try:
        t0 = time.perf_counter()
        merged = daodian_similar_job(
            table, split.wrap("embed_text", embed_titles),
            split.wrap("embed_cv", embed_skus), sink, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        (SimilarityEngine.search, engine_mod.knn_search,
         engine_mod.filter_neighbors) = orig
    split.s["other"] = wall - sum(split.s.values())
    return merged, sink, wall, split.s, kept


def _check_kept(kept, dev, rng, n=256) -> float:
    """Sampled rows of each kept self-search against the plain top-k on
    the same device corpus."""
    err = 0.0
    for dim, (eng, k, (scores, idx)) in kept.items():
        corpus_dev, true_n, _ = eng._corpus_dev
        rows = np.sort(rng.choice(eng.n, size=min(n, eng.n), replace=False))
        want = T.topk_plain(corpus_dev, corpus_dev[torch.from_numpy(rows)
                                                   .to(dev)],
                            k + 1, "ip", true_n)
        err = max(err, check_case(f"daodian_d{dim}_k{k}", (
            torch.from_numpy(scores[rows]).to(dev),
            torch.from_numpy(idx[rows]).to(dev)), want, min(k, eng.n)))
    return err


def phase8(dev) -> dict:
    """The daodian slice (see the docstring)."""
    from multimodalsimilar_tpu_torch.cli.serve import (
        _build_daodian_service, _load_fasttext)
    from multimodalsimilar_tpu_torch.cli.similar import _sku_to_spusn
    from multimodalsimilar_tpu_torch.models.fasttext import train_supervised
    from multimodalsimilar_tpu_torch.pipelines.daodian_serving import (
        make_daodian_server)
    from multimodalsimilar_tpu_torch.pipelines.similar import (
        build_area_index, split_areas)
    from multimodalsimilar_tpu_torch.retrieval.filters import (
        filter_neighbors)

    work = tempfile.mkdtemp(prefix="chip_smoke_dd_")
    rng = np.random.default_rng(SEED + 31)
    out = {}
    try:
        args = dd_args(work)
        words = title_words()
        # 1. fastText on the card: configs/train_fasttext.yaml with the
        # JAX defaults (batch 256 on the batch-mean loss), then the same
        # at lr 0.1 x 256, fastText's per-example step, whose model the
        # jobs use (at lr 0.1 the batch mean moves each title 256x less
        # than fastText's SGD does, and 1,950 steps barely move the loss)
        labels = rng.integers(0, FT_LABELS, N_FT_TITLES)
        titles = daodian_titles(rng, labels, words)
        held_lab = rng.integers(0, FT_LABELS, 2048)
        held = daodian_titles(rng, held_lab, words)
        out["fasttext"] = {}
        for name, lr in (("defaults_lr0.1", 0.1), ("lr25.6", 25.6)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ft = train_supervised(titles, [int(v) for v in labels],
                                  dim=FT_DIM, lr=lr, epochs=5,
                                  word_ngrams=2, device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            _, mask = ft.vocab.encode_batch(titles, ft.max_tokens,
                                            ft.word_ngrams)
            # tokens the steps read: batches of 256 titles, mean length
            loss = ft.train_losses
            tokens = len(loss) * 256 * float(mask.sum(1).mean())
            _, acc, _ = ft.test(held, [int(v) for v in held_lab])
            first, last = float(loss[:50].mean()), float(loss[-50:].mean())
            if not (np.isfinite(loss).all() and last < first):
                raise AssertionError(f"fastText {name}: loss {first} -> "
                                     f"{last}")
            out["fasttext"][name] = {
                "titles": N_FT_TITLES, "labels": FT_LABELS, "dim": FT_DIM,
                "lr": lr, "epochs": 5, "batch": 256, "steps": len(loss),
                "train_s": train_s, "tokens_per_s": tokens / train_s,
                "loss_first50": first, "loss_last50": last,
                "heldout_accuracy": acc, "vocab": ft.vocab.size}
        if not (last < 0.5 * first and acc > 0.9):
            raise AssertionError(f"fastText at lr 25.6: loss {first} -> "
                                 f"{last}, held-out accuracy {acc}")
        ft.save(args.fasttext_model)
        print(json.dumps({"phase8_fasttext": out["fasttext"]}), flush=True)
        del ft, mask
        ft = _load_fasttext(args, device=dev)

        # 2. the cv arm's corpus: B4 photos + seeded vectors in the cache
        model = CvImageClassifier(backbone_config(BACKBONE), CV_LABELS,
                                  fc_dim=CV_DIM,
                                  generator=torch.Generator().manual_seed(
                                      SEED))
        seed_bn_statistics(model, SEED + 32, make_images(
            np.random.default_rng(SEED + 33), 8, CV_SIZE), dev)
        CheckpointManager(args.checkpoint).save(0, {"model":
                                                    model.state_dict()})
        del model
        table = daodian_table(rng, words)
        n = len(table["spu_sn"])
        embedder = _cv_embedder(args, device=dev)
        photo_rows = np.arange(0, n, n // N_DD_PHOTOS)[:N_DD_PHOTOS]
        photos = make_images(rng, N_DD_PHOTOS, CV_SIZE)
        embedder.embed_batch(photos[:64])             # warm-up, not timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        photo_emb = np.concatenate([embedder.embed_batch(photos[s: s + 256])
                                    for s in range(0, N_DD_PHOTOS, 256)])
        photo_s = time.perf_counter() - t0
        base = rng.standard_normal((FT_LABELS * 10, CV_DIM)).astype(
            np.float32)
        base /= np.linalg.norm(base, axis=1, keepdims=True)
        noise = rng.standard_normal((n, CV_DIM)).astype(np.float32)
        noise *= 0.9 / np.linalg.norm(noise, axis=1, keepdims=True)
        vecs = base[np.asarray(table["second_level_category_id"])] + noise
        vecs[photo_rows] = photo_emb
        has = np.ones(n, bool)
        has[rng.choice(n, n // 50, replace=False)] = False   # no image
        has[photo_rows] = True
        cache = EmbeddingCache.open(args.emb_cache, CV_DIM)
        cache.put_many({table["sku"][i]: vecs[i] for i in np.nonzero(has)[0]})
        cache.close()
        del embedder, photos, vecs, noise
        torch.cuda.empty_cache()
        embedder = _cv_embedder(args, device=dev)

        def embed_skus(area):
            return _sku_to_spusn(area, embedder, args)

        embed_titles = ft.get_sentence_vector
        out["cv_corpus"] = {"photos": N_DD_PHOTOS,
                            "photos_per_s": N_DD_PHOTOS / photo_s,
                            "cached": int(has.sum()), "rows": n,
                            "config": "B4 at 512 px, fc 512, BN folded, "
                                      "bf16; seeded unit vectors by lv2"}

        # 3. the v2 recent-days job over 12 areas
        T.LAUNCHES["topk_select"] = T.LAUNCHES["topk"] = 0
        merged, sink, wall, split, kept = _timed_job(
            table, embed_titles, embed_skus, dev, date_key="20260816",
            dt_col="dt", target_dt=DD_DAYS[-1], recent_days=RECENT_DAYS)
        v2_select, v2_topk = T.LAUNCHES["topk_select"], T.LAUNCHES["topk"]
        if v2_select < 2 * N_AREAS or len(sink.data) == 0:
            raise AssertionError(f"v2 job: {v2_select} selection launches, "
                                 f"{len(sink.data)} keys written")
        area_of = dict(zip(table["spu_sn"], table["area_id"]))
        dt_of = dict(zip(table["spu_sn"], table["dt"]))
        for key, nbrs in list(merged.items())[::97]:
            if any(area_of[x] != area_of[key] or dt_of[x] != DD_DAYS[-1]
                   for x in nbrs) or len(nbrs) > 27 + 101:
                raise AssertionError(f"v2 job: bad list for {key}")
        ttl = sink.ttl(next(iter(sink.data)))
        if not all(k.startswith("20260816:") for k in sink.data) \
                or not 0 < ttl <= 1.5 * 86400:
            raise AssertionError("v2 job: keys or TTL")
        v2_err = _check_kept(kept, dev, rng)
        out["v2_job"] = {
            "areas": N_AREAS, "rows": n, "keys_written": len(sink.data),
            "wall_s": wall, "split_s": split,
            "topk_select_launches": v2_select, "topk_launches": v2_topk,
            "sample_max_abs_err": v2_err,
            "mean_list": float(np.mean([len(v) for v in merged.values()])),
            "config": "configs/similar_daodian_v2_recent_days.yaml: "
                      "recent_days 7, date-keyed, TTL 1.5 d"}
        print(json.dumps({"phase8_v2_job": out["v2_job"]}), flush=True)
        del merged, sink, kept

        # 4. the v1 job over 2 areas: text grouped, cv at k = 26
        two = {c: v[: 2 * AREA_ROWS] for c, v in table.items()}
        T.LAUNCHES["topk_select"] = T.LAUNCHES["topk"] = 0
        v1_map, sink, v1_wall, v1_split, kept = _timed_job(
            two, embed_titles, embed_skus, dev)
        v1_select, v1_topk = T.LAUNCHES["topk_select"], T.LAUNCHES["topk"]
        # one search per lv1 group: groups above MAX_K rows take the
        # selection kernel, the rest and each area's cv arm csrc/topk.cu
        sizes = collections.Counter(zip(two["area_id"],
                                        two["first_level_category_id"]))
        big = sum(v > T.MAX_K for v in sizes.values())
        if big == 0 or v1_select != big \
                or v1_topk != len(sizes) - big + 2:
            raise AssertionError(f"v1 job: {v1_select} selection and "
                                 f"{v1_topk} top-k launches for {big} of "
                                 f"{len(sizes)} groups above {T.MAX_K}")
        v1_err = _check_kept(kept, dev, rng)
        area0 = next(iter(split_areas(two, "area_id").values()))
        idx = build_area_index(area0, embed_titles, embed_skus(area0),
                               device=dev)
        eng = idx.text_engine
        grouped = eng.similar_map(idx.k_text, idx.text_rules)
        scores, nbr = eng.search(eng.n)
        full = filter_neighbors(scores, nbr, eng.keys, eng.categories,
                                idx.text_rules, dts=eng.dts)
        if grouped != full:
            bad = sum(grouped[k] != full[k] for k in full)
            raise AssertionError(f"v1: grouped map differs from the full "
                                 f"search on {bad} keys")
        del scores, nbr, full
        out["v1_job"] = {
            "areas": 2, "rows": 2 * AREA_ROWS, "keys_written": len(sink.data),
            "wall_s": v1_wall, "split_s": v1_split,
            "topk_select_launches": v1_select, "topk_launches": v1_topk,
            "lv1_groups": len(sizes), "groups_above_max_k": big,
            "cv_sample_max_abs_err": v1_err,
            "grouped_equals_full_keys": len(grouped),
            "config": "configs/similar_daodian_v1.yaml: text k = "
                      "len(area) per lv1 group, cv k = 26, TTL 7 d"}
        print(json.dumps({"phase8_v1_job": out["v1_job"]}), flush=True)

        # 5. serve --tower daodian over the same 2 areas
        t0 = time.perf_counter()
        svc = _build_daodian_service(args, table=two, device=dev)
        try:
            svc.warm()
            svc.warm_query_buckets(args.image_size)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            for key in rng.choice(two["spu_sn"], 256, replace=False):
                got = svc.similar_key(str(key))["neighbors"]
                if got != [str(x) for x in v1_map.get(key, [])]:
                    raise AssertionError(f"similar_key({key}) differs from "
                                         "the v1 job")
            queries = [(t, int(a), int(b), str(ar)) for t, a, b, ar in zip(
                daodian_titles(rng, rng.integers(0, FT_LABELS, 512), words),
                rng.integers(0, FT_LABELS, 512),
                rng.integers(0, FT_LABELS * 10, 512),
                rng.choice(two["area_id"], 512))]
            T.LAUNCHES["topk_select"] = 0
            load = [closed_loop(lambda p: svc.similar_query(*p), queries, c)
                    for c in DD_LEVELS]
            adhoc_select = T.LAUNCHES["topk_select"]
            if adhoc_select != sum(r["requests"] for r in load):
                raise AssertionError(f"{adhoc_select} selection launches "
                                     f"for {sum(r['requests'] for r in load)}"
                                     " ad-hoc queries")
            j = int(rng.integers(0, 2 * AREA_ROWS))
            item = {c: two[c][j] for c in two}
            item.update(spu_sn="ddnew0", sku="ddnew0")
            res = svc.update([item])
            nb = svc.similar_key("ddnew0")["neighbors"]
            if two["spu_sn"][j] not in nb[:20]:
                raise AssertionError(f"after /update: {two['spu_sn'][j]} "
                                     f"not among {nb[:20]}")
            httpd = make_daodian_server(svc, args.host, 0,
                                        image_size=args.image_size)
            server = threading.Thread(target=httpd.serve_forever,
                                      daemon=True)
            server.start()
            url = f"http://{args.host}:{httpd.server_address[1]}"
            try:
                import cv2
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=60) as r:
                    health = json.loads(r.read())
                k0 = two["spu_sn"][5]
                by_key = _post(url + "/similar", {"key": k0})
                ok, buf = cv2.imencode(".jpg", make_images(rng, 1,
                                                           CV_SIZE)[0])
                T.LAUNCHES["topk"] = 0
                q = queries[0]
                img = _post(url + "/similar", {
                    "title": q[0], "lv1": q[1], "lv2": q[2],
                    "area_id": q[3],
                    "image_b64": base64.b64encode(buf.tobytes()).decode()})
                img_topk = T.LAUNCHES["topk"]       # the cv arm's k = 26
                upd = _post(url + "/update", {"items": [dict(
                    item, spu_sn="ddnew1")]})
                if health["corpus"] != 2 * AREA_ROWS + 1 \
                        or by_key["neighbors"] != svc.similar_key(
                            k0)["neighbors"] \
                        or img_topk != 1 \
                        or upd["corpus"] != 2 * AREA_ROWS + 2:
                    raise AssertionError(
                        f"HTTP: {health}, {upd}, {img_topk} top-k launches "
                        f"for one image query, key {k0}: "
                        f"{by_key['neighbors'][:5]}")
            finally:
                httpd.shutdown()
                httpd.server_close()
                server.join(timeout=30)
        finally:
            svc.close()
        out["daemon"] = {
            "areas": 2, "corpus": 2 * AREA_ROWS, "warm_s": warm_s,
            "keys_checked": 256, "adhoc": load,
            "adhoc_topk_select_launches": adhoc_select,
            "update": res, "http_image_cv_neighbors": img["cv_neighbors"],
            "http_image_text_neighbors": img["text_neighbors"],
            "config": "configs/serve_daodian.yaml: both arms, B4 at 512 "
                      "px, max_batch 64"}
        print(json.dumps({"phase8_daemon": out["daemon"]}), flush=True)

        # 6. serve --tower fasttext over all 12 areas, k = 100
        fargs = argparse.Namespace(**{**vars(serve_args()), **dict(
            tower="fasttext", fasttext_model=args.fasttext_model,
            text_col="title", k=100, score_th=-0.6, max_batch=256,
            max_wait_ms=2.0, batch_size=64)})
        fsvc, fn = _build_serve_service(fargs, table=table, device=dev)
        try:
            _warm_serve_service(fsvc, fargs)
            T.LAUNCHES["topk"] = 0
            corpus_dev, true_n, _ = fsvc.engine._corpus_dev
            f_err = 0.0
            for t in queries[:16]:
                got = fsvc.similar(t[0], score_th=None)
                q = _normalize_rows(torch.from_numpy(
                    ft.get_sentence_vector([t[0]])).to(dev))
                pv, pi = T.topk_plain(corpus_dev, q, 101, "ip", true_n)
                gs = np.array([g["score"] for g in got])
                f_err = max(f_err, float(np.abs(
                    gs - pv[0, :100].cpu().numpy()).max()))
                if len(got) != 100 or not np.allclose(
                        gs, pv[0, :100].cpu().numpy(), atol=ATOL,
                        rtol=RTOL):
                    raise AssertionError(f"fasttext serve: {gs[:4]}")
            f_launches = T.LAUNCHES["topk"]
            if f_launches < 16:
                raise AssertionError(f"fasttext serve: {f_launches} top-k "
                                     "launches for 16 requests")
        finally:
            fsvc.close()
        out["fasttext_serve"] = {"corpus": fn, "k": 100, "requests": 16,
                                 "topk_launches": f_launches,
                                 "max_abs_err": f_err,
                                 "config": "configs/serve_fasttext.yaml"}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# -- phase 9: the training recipes -------------------------------------------

RECIPE_EPOCHS = 2
# rows of the image recipes: 4 steps an epoch at train_cv_daodian.yaml's
# batch 24, 2 at train_cv_timm.yaml's 96 and train_multimodal.yaml's 48
# (6, 3 and 3 before a cut for time)
N_CV_ROWS, N_TIMM_ROWS, TIMM_BATCH, TIMM_ACCUM = 96, 192, 96, 1
# 2,048 multilabel rows (4,096 before a cut for time)
N_ML_ROWS, ML_LABELS = 2_048, (38, 590, 10_205)
N_MMT_ROWS, N_PAIR_ROWS = 96, 384


def train_flags(output: str, **values) -> argparse.Namespace:
    """The JAX parser's common ``train`` flags at their defaults, then
    ``values`` (a subcommand's defaults, a config's values and the run's
    cuts; the card machine has no YAML reader)."""
    flags = dict(
        data="synthetic table (table=)", eval_data=None, output=output,
        tokenizer=None, text_col="spu_name", label_col="labels",
        batch_size=256, epochs=30, max_length=128, tower_lr=5e-5,
        head_lr=1e-2, head_warmup_frac=0.15, tower_warmup_frac=0.0,
        optimizer="adamw", scheduler="linear", t0_epochs=7,
        warmup_epochs=5, warmup_lr_init=1e-3, lr_min=0.0,
        cooldown_epochs=0, weight_decay=0.0, head_weight_decay=0.0,
        eval_every=100, save_every=1000, log_every=20,
        weighted_sampling=False, no_clean=False, margin=0.4,
        margin_delta_per_epoch=0.0, bert_preset="tiny", fused_loss=False,
        remat=False, remat_policy="full", remat_skip=0, async_save=False,
        resume=False, overwrite=False, profile=None, model_parallel=1,
        tensor_parallel=False, sequence_parallel=False,
        pipeline_parallel=0, grad_accum=1, bf16_grads=False, seed=SEED,
        seq_buckets=None)
    flags.update(values)
    return argparse.Namespace(**flags)


def cv_flags(output, img_root, **values):
    """``train cv``'s defaults (eval and save once an epoch) and
    ``values``."""
    flags = dict(eval_every=None, save_every=None, img_root=img_root,
                 key_col="goods_sku", image_size=512, fc_dim=512,
                 backbone=BACKBONE, decode_cache=None, margin=0.2,
                 margin_delta_per_epoch=0.04, label_col="tag_new_id")
    flags.update(values)
    return train_flags(output, **flags)


def zipf_with_last(n, n_cls, rng) -> np.ndarray:
    """Zipf labels over ``n_cls`` classes with class n_cls - 1 present, so
    the head built from the labels has exactly ``n_cls`` rows."""
    labels = zipf_labels(n, n_cls, rng)
    labels[-1] = n_cls - 1
    return labels


def write_jpegs(root: str, keys, size: int, rng) -> None:
    """Synthetic photos (``make_images``) as {root}/{key}.jpg, by cv2."""
    import cv2
    os.makedirs(root, exist_ok=True)
    for i in range(0, len(keys), 64):
        chunk = keys[i:i + 64]
        for key, img in zip(chunk, make_images(rng, len(chunk), size)):
            if not cv2.imwrite(os.path.join(root, f"{key}.jpg"), img):
                raise AssertionError(f"cv2 could not write {key}.jpg")


def run_recipe(name, cmd, args, table, dev, batch_size) -> tuple:
    """``cmd(args, table=table, device=dev)`` with the ArcFace launch
    count set to 0 just before and read just after; its wall seconds,
    peak memory, the Trainer's step times and the logged metrics. Fails
    on a non-finite or missing loss."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    A.LAUNCHES["arcface"] = 0
    t0 = time.perf_counter()
    trainer = cmd(args, table=table, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = A.LAUNCHES["arcface"]
    lines = [json.loads(ln) for ln in open(
        os.path.join(args.output, "metrics.jsonl"), encoding="utf-8")]
    losses = [ln["train/loss"] for ln in lines if "train/loss" in ln]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: losses {losses}")
    summary = trainer.timer.summary(batch_size)
    return trainer, lines, {
        "recipe": name, "micro_steps": trainer.step,
        "optimizer_steps": trainer.schedules.count, "fit_s": fit_s,
        "batch_size": batch_size, "grad_accum": args.grad_accum,
        "examples_per_s": summary["examples_per_sec"],
        "step_ms_p50": summary["p50_ms"], "step_ms_p95": summary["p95_ms"],
        "timed_steps": summary["steps"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "arcface_launches": launches, "first_loss": losses[0],
        "last_loss": losses[-1]}


def bn_moved(model) -> bool:
    """Did every BatchNorm's running statistics leave the init's 0 and
    1?"""
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    return bool(bns) and all(
        bool((m.running_mean != 0).any()) and bool((m.running_var != 1).any())
        for m in bns)


def release(trainer) -> None:
    """Free a finished recipe's device memory for the next one."""
    trainer.optimizer.state.clear()
    trainer.model.zero_grad(set_to_none=True)
    trainer.model.cpu()
    torch.cuda.empty_cache()


def phase9(dev) -> dict:
    """The training recipes (see the docstring)."""
    from multimodalsimilar_tpu_torch.cli import train as CT
    from multimodalsimilar_tpu_torch.data.datasets import (
        ImageClassificationSource)

    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    rng = np.random.default_rng(SEED + 41)
    out = {}
    try:
        img_root = os.path.join(work, "images")
        n_img = max(N_CV_ROWS, N_TIMM_ROWS, N_MMT_ROWS)
        keys = [f"sku{i:05d}" for i in range(n_img)]
        t0 = time.perf_counter()
        write_jpegs(img_root, keys, CV_SIZE, rng)
        out["jpeg_write_s"] = time.perf_counter() - t0

        # 1. train cv at configs/train_cv_daodian.yaml: B4 at 512 px
        cv_table = {"goods_sku": keys[:N_CV_ROWS],
                    "tag_new_id": zipf_with_last(N_CV_ROWS, CV_LABELS, rng)}
        args = cv_flags(os.path.join(work, "cv"), img_root,
                        image_size=CV_SIZE, fc_dim=CV_DIM, batch_size=24,
                        epochs=RECIPE_EPOCHS, optimizer="adamw",
                        scheduler="cosine_warm_restarts", t0_epochs=7,
                        tower_lr=1e-4, head_lr=1e-4, weighted_sampling=True,
                        log_every=1)
        trainer, lines, r = run_recipe("cv (train_cv_daodian.yaml)",
                                       CT.cmd_train_cv, args, cv_table, dev,
                                       24)
        margins = [ln["train/margin"] for ln in lines
                   if "train/margin" in ln]
        if not any(abs(m - 0.24) < 1e-6 for m in margins) \
                or r["arcface_launches"] != trainer.step \
                or not bn_moved(trainer.model):
            raise AssertionError(f"cv: margins {margins}, "
                                 f"{r['arcface_launches']} launches in "
                                 f"{trainer.step} steps, or BN still")
        r["margins"] = sorted(set(margins))
        r["profile"] = profile_steps(trainer, ImageClassificationSource(
            cv_table, img_root, "goods_sku", "tag_new_id", CV_SIZE,
            train_aug=True), 24, n=2)
        out["cv_daodian"] = r
        release(trainer)

        # 2. train cv at configs/train_cv_timm.yaml: B4 at 380 px, AdamP
        timm_table = {"goods_sku": keys[:N_TIMM_ROWS],
                      "tag_new_id": zipf_with_last(N_TIMM_ROWS, CV_LABELS,
                                                   rng)}
        args = cv_flags(os.path.join(work, "timm"), img_root,
                        image_size=MM_SIZE, fc_dim=CV_DIM,
                        batch_size=TIMM_BATCH, grad_accum=TIMM_ACCUM,
                        epochs=RECIPE_EPOCHS, cooldown_epochs=0,
                        optimizer="adamp", scheduler="timm_cosine",
                        warmup_epochs=5, warmup_lr_init=1e-3, tower_lr=1e-4,
                        head_lr=1e-4, weight_decay=1e-5,
                        head_weight_decay=0.0, margin=0.2,
                        margin_delta_per_epoch=0.0, save_every=1000,
                        eval_every=1000, log_every=1)
        trainer, _, r = run_recipe("cv (train_cv_timm.yaml)",
                                   CT.cmd_train_cv, args, timm_table, dev,
                                   TIMM_BATCH)
        if type(trainer.optimizer).__name__ != "AdamP" \
                or r["arcface_launches"] != trainer.step:
            raise AssertionError(f"timm: {type(trainer.optimizer)}, "
                                 f"{r['arcface_launches']} launches")
        out["cv_timm"] = r
        release(trainer)

        # 3. train multilabel at configs/train_multilabel_v3.yaml, plain
        # heads and --fused_loss, 2,048 examples an optimizer step
        ml_table = {"spu_name": make_titles(N_ML_ROWS, rng)}
        for col, n_cls in zip(("lv1_category_id", "lv2_category_id",
                               "tag_new_id"), ML_LABELS):
            ml_table[col] = zipf_with_last(N_ML_ROWS, n_cls, rng)
        first = {}
        for fused in (False, True):
            args = train_flags(
                os.path.join(work, f"ml{int(fused)}"),
                lv1_col="lv1_category_id", lv2_col="lv2_category_id",
                tag_col="tag_new_id", lv1_weight=10.0, lv2_weight=5.0,
                tag_weight=1.0, bert_preset="base", batch_size=256,
                max_length=128, epochs=RECIPE_EPOCHS, tower_lr=5e-5,
                head_lr=5e-5, weighted_sampling=True, eval_every=1000,
                save_every=1000, weight_decay=0.01, head_weight_decay=0.01,
                seq_buckets="48,64,96", no_clean=True, grad_accum=8,
                fused_loss=fused, log_every=1)
            name = "multilabel_fused" if fused else "multilabel"
            trainer, _, r = run_recipe(
                f"{name} (train_multilabel_v3.yaml)",
                CT.cmd_train_multilabel, args, ml_table, dev, 256)
            want = 0 if fused else 3 * trainer.step
            if r["arcface_launches"] != want \
                    or [h.weight.shape[0] for h in (
                        trainer.model.lv1_head, trainer.model.lv2_head,
                        trainer.model.tag_head)] != list(ML_LABELS):
                raise AssertionError(f"{name}: {r['arcface_launches']} "
                                     f"launches, want {want}")
            first[fused] = r["first_loss"]
            src = CT._Renamed(TextClassificationSource(
                ml_table, TextTokenizer.from_vocab_file(
                    os.path.join(args.output, "vocab.txt")),
                args.text_col, [args.lv1_col, args.lv2_col, args.tag_col],
                args.max_length, clean=False, seq_buckets=args.seq_buckets),
                [args.lv1_col, args.lv2_col, args.tag_col])
            if not fused:    # the fused run: PERF.md §5 has its window
                r["profile"] = profile_steps(trainer, src, 256, n=4)
            out[name] = r
            release(trainer)
        rel = abs(first[True] - first[False]) / abs(first[False])
        if rel > 1e-3:
            raise AssertionError(f"multilabel first-step losses: plain "
                                 f"{first[False]}, fused {first[True]}")
        out["multilabel_fused"]["first_loss_rel_diff_vs_plain"] = rel

        # 4. train multimodal at configs/train_multimodal.yaml
        mm_table = {"spu_sn": keys[:N_MMT_ROWS],
                    "spu_name": make_titles(N_MMT_ROWS, rng),
                    "cateid": zipf_with_last(N_MMT_ROWS, MM_LABELS, rng)}
        args = train_flags(
            os.path.join(work, "mm"), img_root=img_root, key_col="spu_sn",
            label_col="cateid", image_size=MM_SIZE, fc_dim=CV_DIM,
            backbone=BACKBONE, decode_cache=None, batch_size=48,
            max_length=128, epochs=RECIPE_EPOCHS, tower_lr=5e-5,
            head_lr=1e-2, head_warmup_frac=0.15, margin=0.5,
            eval_every=1000, save_every=1000, weight_decay=0.01,
            head_weight_decay=0.01, bert_preset="base", log_every=1)
        trainer, _, r = run_recipe("multimodal (train_multimodal.yaml)",
                                   CT.cmd_train_multimodal, args, mm_table,
                                   dev, 48)
        if r["arcface_launches"] != trainer.step \
                or trainer.model.head.weight.shape != (MM_LABELS, MM_DIM) \
                or not bn_moved(trainer.model.cv):
            raise AssertionError(f"multimodal: {r['arcface_launches']} "
                                 f"launches in {trainer.step} steps")
        out["multimodal"] = r
        release(trainer)

        # 5. train pair at configs/train_pair.yaml with the base tower,
        # and --profile
        titles = make_titles(N_PAIR_ROWS, rng)
        lv1 = rng.integers(0, 8, N_PAIR_ROWS)
        lv2 = lv1 * 10 + rng.integers(0, 5, N_PAIR_ROWS)
        pair_table = {"title": titles,
                      "sku_sn_name": [f"s{i // 2}" for i in
                                      range(N_PAIR_ROWS)],
                      "tag_id": (lv2 * 10 + rng.integers(0, 4, N_PAIR_ROWS)
                                 ).tolist(),
                      "lv2_category_id": lv2.tolist(),
                      "lv1_category_id": lv1.tolist()}
        trace_dir = os.path.join(work, "trace")
        args = train_flags(
            os.path.join(work, "pair"), batch_size=128, max_length=64,
            epochs=RECIPE_EPOCHS, tower_lr=1e-3, head_lr=1e-3,
            tower_warmup_frac=0.25, head_warmup_frac=0.25,
            weighted_sampling=True, save_every=1000, weight_decay=0.01,
            head_weight_decay=0.01, bert_preset="base", log_every=1,
            profile=trace_dir)
        trainer, _, r = run_recipe("pair (train_pair.yaml)",
                                   CT.cmd_train_pair, args, pair_table, dev,
                                   128)
        traces = [f for f in os.listdir(trace_dir)
                  if f.endswith(".pt.trace.json")]
        if not traces:
            raise AssertionError("--profile wrote no trace")
        r["profile_trace_files"] = len(traces)
        out["pair"] = r
        release(trainer)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# similar nlp over 25,000 titles (50,000 before a cut for time)
N_CLI_TITLES, N_CLI_FT, N_CLI_SUB = 25_000, 20_000, 5_000
ROOT = os.path.dirname(os.path.abspath(__file__))


def config_path(name: str) -> str:
    return os.path.join(ROOT, "configs", name)


def write_csv(path: str, table: dict) -> None:
    """A ``{column: list}`` table as a CSV file (the stdlib writer)."""
    import csv
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(list(table))
        w.writerows(zip(*table.values()))


def run_cli(argv) -> tuple:
    """``cli.main(argv)`` on the card, with every launch count set to 0
    just before and read just after: (what the command returns, its last
    stdout line as JSON or None, wall seconds, launches by kernel)."""
    import contextlib
    import io
    from multimodalsimilar_tpu_torch.cli import main as cli_main
    for name in T.LAUNCHES:
        T.LAUNCHES[name] = 0
    A.LAUNCHES["arcface"] = 0
    torch.cuda.synchronize()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = cli_main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"topk": T.LAUNCHES["topk"],
                "topk_select": T.LAUNCHES["topk_select"],
                "arcface": A.LAUNCHES["arcface"]}
    lines = buf.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return result, last, wall, launches


def kv_items(sink) -> dict:
    return {k: v for k, (v, _) in sink.data.items()}


def cli_args(argv) -> argparse.Namespace:
    """``argv`` as the port's command line parses it, ``--config``
    applied."""
    from multimodalsimilar_tpu_torch.cli.common import _apply_yaml_config
    from multimodalsimilar_tpu_torch.cli.parser import (_inject_yaml_argv,
                                                        build_parser)
    parser = build_parser()
    argv = _inject_yaml_argv(list(argv), parser)
    args = parser.parse_args(argv)
    _apply_yaml_config(args, argv)
    return args


def embedder_startup(argv, titles, dev) -> dict:
    """Seconds to build ``similar nlp``'s text embedder from its
    checkpoint: through ``_build_text_embedder`` (the tower built on the
    meta device and loaded with ``assign=True``), and as it was built before
    (the seed-0 tower drawn on the host, then overwritten by the
    checkpoint's), meta first (it reads the checkpoint from the disk
    first); both embedders must embed ``titles`` to the same vectors."""
    from multimodalsimilar_tpu_torch.cli.common import (_bert_config,
                                                        _restore_required)
    from multimodalsimilar_tpu_torch.cli.embedders import (
        _build_text_embedder)
    args = cli_args(argv)
    out, vectors = {}, {}

    def random_then_load():
        from multimodalsimilar_tpu_torch.utils.buckets import parse_buckets
        model = NlpTextClassifier(_bert_config(args.bert_preset),
                                  pool=getattr(args, "pool", "cls"),
                                  policy=DTypePolicy.inference(),
                                  num_labels=args.num_labels)
        state = _restore_required(args.checkpoint)
        model.tower.load_state_dict(
            {k[len("tower."):]: v for k, v in state["model"].items()
             if k.startswith("tower.")})
        return TextEmbedder(
            model, TextTokenizer.from_vocab_file(args.tokenizer),
            args.max_length, args.batch_size, length_buckets=parse_buckets(
                getattr(args, "length_buckets", None)), device=dev)

    for name, build in (("meta_s", lambda: _build_text_embedder(
            args, device=dev)), ("random_init_then_load_s",
                                 random_then_load)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embedder = build()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        vectors[name] = np.asarray(embedder(titles))
        del embedder
        torch.cuda.empty_cache()
    if not all(np.array_equal(v, vectors["meta_s"])
               for v in vectors.values()):
        raise AssertionError("the meta-built embedder embeds otherwise "
                             "than the randomly initialized one")
    out["same_vectors"] = len(titles)
    return out


def phase10(dev) -> dict:
    """The command line (see the docstring)."""
    from multimodalsimilar_tpu_torch.cli import similar as cli_similar
    from multimodalsimilar_tpu_torch.models.fasttext import (
        FastTextClassifier)

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    rng = np.random.default_rng(SEED + 50)
    walls, launches, out = {}, {}, {}
    saved = (cli_similar._kv_sink, cli_similar._embed_fn_from_embedder)
    try:
        # 1. train nlp at configs/train_nlp_v2.yaml, one epoch
        train_csv = os.path.join(work, "train.csv")
        write_csv(train_csv, {
            "spu_name": make_titles(N_TRAIN, rng),
            "tag_new_id": [int(v) for v in zipf_with_last(N_TRAIN, AF_C,
                                                          rng)]})
        nlp_out = os.path.join(work, "nlp")
        trainer, _, walls["train_nlp"], launches["train_nlp"] = run_cli(
            ["train", "nlp", "--config", config_path("train_nlp_v2.yaml"),
             "--data", train_csv, "--output", nlp_out, "--epochs", "1",
             "--eval_every", "1000000", "--save_every", "1000000",
             "--log_every", "8"])
        steps = trainer.step
        if trainer.model.head.weight.shape[0] != AF_C \
                or steps != N_TRAIN // 128 \
                or launches["train_nlp"]["arcface"] != steps:
            raise AssertionError(f"train nlp: {steps} steps, "
                                 f"{launches['train_nlp']} launches")
        summary = trainer.timer.summary(128)
        out.update(train_steps=steps, train_step_ms_p50=summary["p50_ms"],
                   train_examples_per_s=summary["examples_per_sec"])
        release(trainer)
        vocab = os.path.join(nlp_out, "vocab.txt")
        ckpt = os.path.join(nlp_out, "ckpt")

        # 2. eval of that checkpoint
        metrics, line, walls["eval"], launches["eval"] = run_cli(
            ["eval", "--data", train_csv, "--tokenizer", vocab,
             "--checkpoint", ckpt, "--bert_preset", "base", "--label_col",
             "tag_new_id", "--num_labels", str(AF_C)])
        if line != metrics or set(line) != {"acc", "loss"} or not all(
                math.isfinite(v) for v in line.values()):
            raise AssertionError(f"eval: {line}")
        out["eval"] = line

        # 3. similar nlp at configs/similar_nlp.yaml over 25,000 titles
        titles = make_titles(N_CLI_TITLES, rng)
        keys = [f"spu{i:06d}" for i in range(N_CLI_TITLES)]
        sim_csv = os.path.join(work, "titles.csv")
        write_csv(sim_csv, {"spu_sn": keys, "spu_name": titles})
        sink, recorded = InMemoryKVSink(), {}

        def recording(embedder):
            embed = saved[1](embedder)

            def call(texts):
                recorded["emb"] = embed(texts)
                return recorded["emb"]
            return call

        cli_similar._kv_sink = lambda args: sink
        cli_similar._embed_fn_from_embedder = recording
        argv = ["similar", "nlp", "--config",
                config_path("similar_nlp.yaml"), "--data", sim_csv,
                "--tokenizer", vocab, "--checkpoint", ckpt]
        _, line, walls["similar_nlp"], launches["similar_nlp"] = run_cli(
            argv)
        cli_similar._kv_sink, cli_similar._embed_fn_from_embedder = saved
        direct = InMemoryKVSink()
        n = nlp_similar_job({"spu_name": titles, "spu_sn": keys},
                            lambda texts: recorded["emb"], direct, k=13,
                            score_th=0.9, ttl_seconds=604800, device=dev)
        if line != {"written": n} or not n \
                or kv_items(sink) != kv_items(direct) \
                or launches["similar_nlp"]["topk"] < 1:
            raise AssertionError(f"similar nlp: {line}, direct {n}, "
                                 f"{launches['similar_nlp']}")
        out["similar_nlp_written"] = n

        # the text embedder's startup: the earlier way (a random init on the
        # host, then the checkpoint's tower) against the meta build
        out["startup"] = embedder_startup(argv, titles[:512], dev)

        # 4. the same command as a subprocess, on the card by default, over
        # the first N_CLI_SUB titles; its writes are the job's on the
        # vectors the in-process command embedded for them
        sub_csv = os.path.join(work, "titles_sub.csv")
        write_csv(sub_csv, {"spu_sn": keys[:N_CLI_SUB],
                            "spu_name": titles[:N_CLI_SUB]})
        want_sub = {"written": nlp_similar_job(
            {"spu_name": titles[:N_CLI_SUB], "spu_sn": keys[:N_CLI_SUB]},
            lambda texts: recorded["emb"][:N_CLI_SUB], InMemoryKVSink(),
            k=13, score_th=0.9, ttl_seconds=604800, device=dev)}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "multimodalsimilar_tpu_torch.cli",
             *argv[:5], sub_csv, *argv[6:]], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        walls["similar_nlp_subprocess"] = time.perf_counter() - t0
        last = proc.stdout.strip().splitlines()[-1:] or [""]
        if proc.returncode != 0 or json.loads(last[0] or "{}") != want_sub:
            raise AssertionError(f"python -m ...cli similar nlp: rc "
                                 f"{proc.returncode}, {last}, "
                                 f"{proc.stderr[-2000:]}")

        # 5. similar multimodal --embedding_col over 4,096 fused rows
        ints = rng.integers(-64, 65, size=(N_MM, MM_DIM))
        lut = {k: repr(k / 8) for k in range(-64, 65)}
        mm_csv = os.path.join(work, "fused.csv")
        mm_keys = [f"mm{i:05d}" for i in range(N_MM)]
        write_csv(mm_csv, {"spu_sn": mm_keys, "multimodal_emb": [
            "[" + ",".join(lut[k] for k in row) + "]"
            for row in ints.tolist()]})
        sink = InMemoryKVSink()
        cli_similar._kv_sink = lambda args: sink
        _, line, walls["similar_multimodal"], \
            launches["similar_multimodal"] = run_cli(
                ["similar", "multimodal", "--data", mm_csv])
        cli_similar._kv_sink = saved[0]
        direct = InMemoryKVSink()
        n = multimodal_similar_job({"spu_sn": mm_keys},
                                   (ints / 8).astype(np.float32), direct,
                                   k=13, device=dev)
        if line != {"written": n} or kv_items(sink) != kv_items(direct) \
                or launches["similar_multimodal"]["topk"] < 1:
            raise AssertionError(f"similar multimodal: {line}, direct {n}, "
                                 f"{launches['similar_multimodal']}")

        # 6. train fasttext, then similar daodian (v2 recent days)
        words = title_words()
        ft_labels = rng.integers(0, FT_LABELS, N_CLI_FT)
        ft_csv = os.path.join(work, "ft.csv")
        write_csv(ft_csv, {"text": daodian_titles(rng, ft_labels, words),
                           "label": [int(v) for v in ft_labels]})
        ft_out = os.path.join(work, "ft")
        model, _, walls["train_fasttext"], launches["train_fasttext"] = \
            run_cli(["train", "fasttext", "--config",
                     config_path("train_fasttext.yaml"), "--data", ft_csv,
                     "--output", ft_out])
        if not np.isfinite(model.train_losses).all():
            raise AssertionError("train fasttext: non-finite losses")
        table = daodian_table(rng, words, n_areas=2)
        dd_csv = os.path.join(work, "areas.csv")
        write_csv(dd_csv, table)
        sink = InMemoryKVSink()
        cli_similar._kv_sink = lambda args: sink
        ft_path = os.path.join(ft_out, "fasttext.pkl")
        _, line, walls["similar_daodian"], launches["similar_daodian"] = \
            run_cli(["similar", "daodian", "--config",
                     config_path("similar_daodian_v2_recent_days.yaml"),
                     "--data", dd_csv, "--fasttext_model", ft_path,
                     "--text_only", "--dt", DD_DAYS[-1]])
        cli_similar._kv_sink = saved[0]
        ft = FastTextClassifier.load(ft_path, device=dev)
        direct = InMemoryKVSink()
        merged = daodian_similar_job(
            table, ft.get_sentence_vector, lambda area: {}, direct,
            ttl_seconds=129_600, date_key=DD_DAYS[-1].replace("-", ""),
            dt_col="dt", target_dt=DD_DAYS[-1], recent_days=RECENT_DAYS,
            device=dev)
        if line != {"skus": len(merged)} or not kv_items(sink) \
                or kv_items(sink) != kv_items(direct) \
                or launches["similar_daodian"]["topk_select"] < 1:
            raise AssertionError(f"similar daodian: {line}, direct "
                                 f"{len(merged)}, "
                                 f"{launches['similar_daodian']}")
        out["daodian_keys_written"] = len(sink.data)
    finally:
        cli_similar._kv_sink, cli_similar._embed_fn_from_embedder = saved
        shutil.rmtree(work, ignore_errors=True)
    return {"wall_s": walls, "launches": launches, **out}


# phase 11: the ViT and ConvNeXt towers and the int8 text tower
VIT, CONVNEXT, NEW_SIZE = "vit_base", "convnext_tiny", 224
N_VIT_IMAGES = 4_096
# a corpus image queried alone (bucket 1) against its row from a batch
# of 64: bf16 rounds the two apart (their cosine 0.9983 on an H100 80GB
# HBM3; 0.9999998 under the full-precision policy, which phase 6's
# precision_witness holds at WITNESS_COS)
VIT_OWN_SCORE = 0.996
# 96 and 192 rows (144 and 288 before a cut for time)
N_NEW_CV_ROWS, N_NEW_TIMM_ROWS = 96, 192
# 4,096 titles (16,384, then 8,192, before cuts for time)
N_INT8_TITLES, N_INT8_F32 = 4_096, 2_048
# the int8 daemon's corpus: phase 5's first 5,000 titles (all 100,000,
# then 20,000 and 10,000, before cuts for time: the corpus pass of
# 100,000 took 31.2 s of phase 11)
N_INT8_SERVE = 5_000
INT8_COS = 1e-3            # JAX's int8 budget against f32 (test_quant.py)
# (rows, K, N) of int8 products: one row, 16 and 17 rows (the pad to
# torch._int_mm's floor), a bucket-64 x 80-token request's QKV, and the
# job's 256 x 128-token FFN output projection (timed)
INT8_SHAPES = ((1, 768, 768), (16, 768, 3072), (17, 3072, 768),
               (64 * 80, 768, 3072), (256 * 128, 3072, 768))


def phase11_train(dev) -> dict:
    """``train cv`` with ``convnext_tiny`` at train_cv_daodian.yaml and
    ``vit_base`` at train_cv_timm.yaml, both at 224 px."""
    from multimodalsimilar_tpu_torch.cli import train as CT
    from multimodalsimilar_tpu_torch.cli.embedders import _load_cv_tower
    from multimodalsimilar_tpu_torch.data.datasets import (
        ImageClassificationSource)
    work = tempfile.mkdtemp(prefix="chip_smoke_newtrain_")
    rng = np.random.default_rng(SEED + 64)
    out = {}
    try:
        img_root = os.path.join(work, "images")
        keys = [f"sku{i:05d}" for i in range(N_NEW_TIMM_ROWS)]
        write_jpegs(img_root, keys, NEW_SIZE, rng)
        runs = (
            ("convnext", "convnext_tiny (train_cv_daodian.yaml)", CONVNEXT,
             N_NEW_CV_ROWS, 24,
             dict(optimizer="adamw", scheduler="cosine_warm_restarts",
                  t0_epochs=7, tower_lr=1e-4, head_lr=1e-4,
                  weighted_sampling=True)),
            ("vit", "vit_base (train_cv_timm.yaml)", VIT, N_NEW_TIMM_ROWS,
             TIMM_BATCH,
             dict(cooldown_epochs=0, optimizer="adamp",
                  scheduler="timm_cosine", warmup_epochs=5,
                  warmup_lr_init=1e-3, tower_lr=1e-4, head_lr=1e-4,
                  weight_decay=1e-5, head_weight_decay=0.0,
                  margin_delta_per_epoch=0.0, save_every=1000,
                  eval_every=1000)))
        for tag, name, backbone, n_rows, batch, values in runs:
            table = {"goods_sku": keys[:n_rows],
                     "tag_new_id": zipf_with_last(n_rows, CV_LABELS, rng)}
            args = cv_flags(os.path.join(work, tag), img_root,
                            backbone=backbone, image_size=NEW_SIZE,
                            fc_dim=CV_DIM, batch_size=batch,
                            epochs=RECIPE_EPOCHS, log_every=1, **values)
            trainer, _, r = run_recipe(name, CT.cmd_train_cv, args, table,
                                       dev, batch)
            model = trainer.model
            if r["arcface_launches"] != trainer.step or any(
                    isinstance(m, torch.nn.BatchNorm2d)
                    for m in model.modules()):
                raise AssertionError(f"{name}: {r['arcface_launches']} "
                                     f"launches in {trainer.step} steps")
            if tag == "vit" and (
                    type(trainer.optimizer).__name__ != "AdamP"
                    or model.backbone.pos_embed.shape[1] != backbone_config(
                        VIT, image_size=NEW_SIZE).num_tokens):
                raise AssertionError(f"{name}: {type(trainer.optimizer)}")
            state = trainer.ckpt.restore()
            if state["step"] != trainer.step or not all(
                    torch.equal(v.cpu(), state["model"][k])
                    for k, v in model.state_dict().items()):
                raise AssertionError(f"{name}: the checkpoint does not "
                                     f"restore the trained parameters")
            sargs = cv_args(work)
            sargs.backbone, sargs.image_size = backbone, NEW_SIZE
            served = _load_cv_tower(sargs, os.path.join(args.output, "ckpt"),
                                    CV_LABELS)
            if not all(torch.equal(v, state["model"][k])
                       for k, v in served.state_dict().items()
                       if k != "head.weight"):
                raise AssertionError(f"{name}: _load_cv_tower changed the "
                                     f"trained weights")
            del served
            src = ImageClassificationSource(table, img_root, "goods_sku",
                                            "tag_new_id", NEW_SIZE)
            r.update(head_paths(model, src, dev, args.margin,
                                batch_size=batch,
                                embed=lambda b: model.predict_emb(to_nchw(
                                    device_normalize(b["images"])))))
            r["profile"] = profile_steps(trainer, ImageClassificationSource(
                table, img_root, "goods_sku", "tag_new_id", NEW_SIZE,
                train_aug=True), batch, n=3)
            out[tag] = r
            release(trainer)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def int8_products(dev) -> dict:
    """``torch._int_mm`` (the int8 tower's product on the card) against
    the exact product (f64 on the card: |sum| <= 127^2 K < 2^53) at the
    tower's shapes, a single row and K = 3,072 with every product at
    127^2; and its time beside the bf16 product at the FFN's shape."""
    from multimodalsimilar_tpu_torch.models import quant as Q
    g = torch.Generator(device=dev).manual_seed(SEED + 71)
    rows = []
    for m, k, n in INT8_SHAPES:
        x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev,
                          generator=g)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev,
                          generator=g)
        rows.append((m, k, n, x, w))
    ext_x = torch.full((32, 3072), 127, dtype=torch.int8, device=dev)
    ext_w = torch.full((768, 3072), -127, dtype=torch.int8, device=dev)
    rows.append((32, 3072, 768, ext_x, ext_w))
    checked = []
    for m, k, n, x, w in rows:
        got = Q.int8_matmul(x, w)
        want = x.double() @ w.double().t()
        if got.dtype != torch.int32 or not torch.equal(got.double(), want):
            raise AssertionError(f"_int_mm {m}x{k}x{n} differs from the "
                                 f"exact product")
        checked.append([m, k, n])
    m, k, n, x, w = rows[-2]
    xb, wb = x.bfloat16(), w.bfloat16()
    return {"exact_shapes": checked,
            "largest_abs": int(127 * 127 * 3072),
            "int_mm_ms": cuda_ms(lambda: Q.int8_matmul(x, w), reps=20),
            "bf16_mm_ms": cuda_ms(lambda: xb @ wb.t(), reps=20),
            "timed_shape": [m, k, n]}


def phase11_int8(dev) -> dict:
    """``similar nlp --int8`` at configs/similar_nlp.yaml over 50,000
    titles against the bf16 command, ``serve --tower bert --int8`` at
    configs/serve.yaml, and the int8 product."""
    from multimodalsimilar_tpu_torch.cli import similar as cli_similar
    from multimodalsimilar_tpu_torch.cli.common import _bert_config
    from multimodalsimilar_tpu_torch.models.quant import QuantTextEmbModel
    work = tempfile.mkdtemp(prefix="chip_smoke_int8_")
    rng = np.random.default_rng(SEED + 72)
    saved = (cli_similar._kv_sink, cli_similar._embed_fn_from_embedder)
    out, runs = {"products": int8_products(dev)}, {}
    try:
        # phase 5's corpus size; the job runs on its first N_INT8_TITLES
        titles = make_titles(N_SERVE, rng)
        keys = [f"spu{i:06d}" for i in range(N_SERVE)]
        csv_path = os.path.join(work, "titles.csv")
        write_csv(csv_path, {"spu_sn": keys[:N_INT8_TITLES],
                             "spu_name": titles[:N_INT8_TITLES]})
        for tag, extra in (("bf16", []), ("int8", ["--int8"])):
            sink, rec = InMemoryKVSink(), {}

            def recording(embedder, rec=rec):
                rec["embedder"] = embedder
                embed = saved[1](embedder)

                def call(texts):
                    t0 = time.perf_counter()
                    rec["emb"] = embed(texts)
                    rec["embed_s"] = time.perf_counter() - t0
                    return rec["emb"]
                return call

            cli_similar._kv_sink = lambda args, sink=sink: sink
            cli_similar._embed_fn_from_embedder = recording
            _, line, wall, launches = run_cli(
                ["similar", "nlp", "--config",
                 config_path("similar_nlp.yaml"), "--data", csv_path]
                + extra)
            cli_similar._kv_sink, cli_similar._embed_fn_from_embedder = saved
            emb = rec["emb"]
            width = _bert_config("base").hidden_size
            if not line or line["written"] <= 0 or launches["topk"] < 1 \
                    or emb.shape != (N_INT8_TITLES, width) \
                    or not np.isfinite(emb).all():
                raise AssertionError(f"similar nlp {extra}: {line}, "
                                     f"{launches}, {emb.shape}")
            runs[tag] = {"written": line["written"], "wall_s": wall,
                         "embed_s": rec["embed_s"],
                         "embeddings_per_s": N_INT8_TITLES / rec["embed_s"],
                         "topk_launches": launches["topk"],
                         "items": kv_items(sink), "emb": emb,
                         "embedder": rec["embedder"]}
        if not isinstance(runs["int8"]["embedder"].model, QuantTextEmbModel):
            raise AssertionError("--int8 did not build the int8 tower")
        # the embeddings against bf16, and both against f32 on a sample
        a, b = runs["int8"]["emb"], runs["bf16"]["emb"]
        cos_ib = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                   * np.linalg.norm(b, axis=1))
        bf16_model = runs["bf16"]["embedder"].model
        f32_model = full_precision_copy(bf16_model)
        f32 = TextEmbedder(f32_model, runs["bf16"]["embedder"].tokenizer,
                           max_length=128, batch_size=256,
                           device=dev)(titles[:N_INT8_F32])

        def cos(x, y):
            return (x * y).sum(1) / (np.linalg.norm(x, axis=1)
                                     * np.linalg.norm(y, axis=1))

        cos_if = cos(a[:N_INT8_F32], f32)
        cos_bf = cos(b[:N_INT8_F32], f32)
        if cos_if.min() < 1 - INT8_COS:
            raise AssertionError(f"int8 vs f32 cosine {cos_if.min()} below "
                                 f"1 - {INT8_COS}")
        del f32_model
        bi, ii = runs["bf16"]["items"], runs["int8"]["items"]
        common = set(bi) & set(ii)
        overlap = [len(set(bi[k].split(",")) & set(ii[k].split(",")))
                   / len(bi[k].split(",")) for k in common]
        out["similar_nlp"] = {
            tag: {k: v for k, v in r.items()
                  if k not in ("items", "emb", "embedder")}
            for tag, r in runs.items()}
        out["embeddings"] = {
            "int8_vs_bf16_cos_min": float(cos_ib.min()),
            "int8_vs_bf16_cos_mean": float(cos_ib.mean()),
            "int8_vs_f32_cos_min": float(cos_if.min()),
            "int8_vs_f32_cos_mean": float(cos_if.mean()),
            "bf16_vs_f32_cos_min": float(cos_bf.min()),
            "f32_sample_rows": N_INT8_F32,
            "budget": f"int8 vs f32 cosine >= 1 - {INT8_COS}"}
        out["neighbour_lists"] = {
            "keys_bf16": len(bi), "keys_int8": len(ii),
            "keys_both": len(common),
            "mean_overlap": float(np.mean(overlap)) if overlap else None,
            "identical_lists": sum(bi[k] == ii[k] for k in common)}
        runs.clear()
        torch.cuda.empty_cache()

        # serve --tower bert --int8 at configs/serve.yaml
        cats = [int(c) for c in rng.integers(0, N_CATEGORIES,
                                             N_INT8_SERVE)]
        table = {"spu_sn": keys[:N_INT8_SERVE],
                 "spu_name": titles[:N_INT8_SERVE],
                 "first_level_category_id": cats}
        novel = make_titles(256, np.random.default_rng(SEED + 73))
        args = serve_args()
        args.int8 = True
        t0 = time.perf_counter()
        service, n = _build_serve_service(args, table=table, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        try:
            _warm_serve_service(service, args)
            int8_emb = service._embed_queries_device.__self__
            if not isinstance(int8_emb.model, QuantTextEmbModel):
                raise AssertionError("serve --int8 did not serve the int8 "
                                     "tower")
            checked = serve_vs_plain(service, titles[:32] + novel[:32], dev)
            load = load_and_launches(service, novel, CV_LEVELS)
            prof = profile_tower(service, novel, (1, 64))
            # the command's bf16 tower (the same seed-0 weights) at the
            # daemon's max_length and batch
            bf16_emb = TextEmbedder(bf16_model, int8_emb.tokenizer,
                                    max_length=args.max_length,
                                    batch_size=args.batch_size, device=dev)
            tower_ms = {}
            for b in (1, 64):
                for tag, emb in (("int8", int8_emb), ("bf16", bf16_emb)):
                    inputs = emb._inputs(novel[:b], b)
                    tower_ms[f"{tag}_bucket_{b}"] = cuda_ms(
                        lambda: emb._run(*inputs), reps=20)
            del bf16_emb, bf16_model
        finally:
            service.close()
        out["serve"] = {"corpus": n, "corpus_embed_s": build_s,
                        "fused_vs_plain": checked, **load,
                        "tower_profile": prof, "tower_ms": tower_ms,
                        "config": "configs/serve.yaml --int8: base, "
                                  "max_length 80, batch 64, k 13, "
                                  "max_batch 64"}
    finally:
        cli_similar._kv_sink, cli_similar._embed_fn_from_embedder = saved
        shutil.rmtree(work, ignore_errors=True)
    return out


def phase11(dev) -> dict:
    """The ViT and ConvNeXt towers and the int8 text tower (see the
    docstring)."""
    return {"vit_serving": phase6(dev, VIT, NEW_SIZE, N_VIT_IMAGES,
                                  SEED + 60, VIT_OWN_SCORE, http=False),
            "train": phase11_train(dev), "int8": phase11_int8(dev)}

# -- phase 12: multi-GPU training and the corpus-sharded search --------------

# train_nlp_v2_dist.yaml's batch; 4 steps (6 before a cut for time)
DIST_BATCH, DIST_STEPS = 1_024, 4
# (b)'s catalog: the first 25,000 of phase 2's titles (all 50,000 before
# a cut for time)
N_DIST_TITLES = 25_000
DIST_TIMEOUT = 600                      # a rank that hangs fails the phase
# the loss of world 2 against world 1 on the same global batches: the
# kernel path's loss tolerance of phase 4 (head_paths)
DIST_LOSS_TOL = 2.0 * 64.0 * (AF_DCOS + math.sin(0.4) * math.sqrt(
    2.0 * AF_DCOS))
# gradients against world 1's f32 gradients, as a share of each tensor's
# largest entry: phase 4's (head 1e-3, tower 2e-2); bf16 adds its rounding
# of the mean (2^-8 of the largest shard gradient) to the head
DIST_GRAD_TOL = {"f32": (1e-3, 2e-2), "bf16": (1e-2, 2e-2),
                 "model_parallel": (1e-3, 2e-2)}


def dist_args(output: str, *extra) -> argparse.Namespace:
    """``train nlp --config configs/train_nlp_v2_dist.yaml`` as the command
    line parses it (global batch 1,024, lr 5e-5 on both groups,
    ``--bf16_grads``, class-balanced sampling), one epoch, logged every
    step."""
    from multimodalsimilar_tpu_torch.cli.common import _apply_yaml_config
    from multimodalsimilar_tpu_torch.cli.parser import (_inject_yaml_argv,
                                                        build_parser)
    argv = ["train", "nlp", "--config",
            config_path("train_nlp_v2_dist.yaml"), "--data", "unused",
            "--output", output, "--epochs", "1", "--log_every", "1",
            "--batch_size", str(DIST_BATCH), *extra]
    parser = build_parser()
    argv = _inject_yaml_argv(argv, parser)
    args = parser.parse_args(argv)
    _apply_yaml_config(args, argv)
    return args


def dist_first_grads(trainer, batch, dev) -> tuple:
    """The loss and the gradients of one global batch on this rank's
    block, reduced as a step reduces them, the class-sharded heads
    gathered; the gradients are then cleared."""
    from multimodalsimilar_tpu_torch.parallel.mesh import shard_batch
    from multimodalsimilar_tpu_torch.train.checkpoint import gather_shard
    mesh = trainer.mesh
    trainer.model.train()
    trainer.generator.manual_seed(trainer._mask_seed())
    loss, _ = trainer.task.train_loss(
        to_device(shard_batch(mesh, batch), dev), trainer.margin)
    loss.backward()
    trainer._reduce_gradients()
    loss = float(mesh.all_reduce(loss.detach().reshape(1), op="mean")[0])
    grads = {}
    for name, p in trainer.model.named_parameters():
        g = p.grad
        if name in trainer.shards:
            g = gather_shard(g, trainer.shards[name], mesh)
        grads[name] = g
    trainer.optimizer.zero_grad(set_to_none=True)
    return loss, grads


def dist_grad_errors(grads: dict, ref: dict, tol: tuple) -> dict:
    """Each gradient against world 1's, as a share of the tensor's largest
    entry (at least 1e-4 of the model's largest gradient, as phase 4);
    the head's pad rows must have no gradient."""
    top = max(float(v.abs().max()) for v in ref.values())
    worst = {"head": 0.0, "tower": 0.0}
    for name, want in ref.items():
        got = grads[name]
        if got.shape[0] > want.shape[0]:           # the padded head
            if float(got[want.shape[0]:].abs().max()) != 0.0:
                raise AssertionError(f"{name}: a pad class has a gradient")
            got = got[:want.shape[0]]
        want = want.to(got.device)
        group = "head" if name.startswith("head.") else "tower"
        scale = max(float(want.abs().max()), 1e-4 * top)
        rel = float((got - want).abs().max()) / scale
        if rel > tol[group == "tower"]:
            raise AssertionError(f"{name}: gradient differs from world 1's "
                                 f"by {rel} of its largest entry {scale}")
        worst[group] = max(worst[group], rel)
    return worst


def dist_train(dev, ref: bool, work: str) -> dict:
    """(a): ``train nlp`` at ``train_nlp_v2_dist.yaml`` on this rank, f32
    and ``--bf16_grads`` data-parallel, and ``--model_parallel 2`` where
    the world divides by 2; dropout off. The reference world writes its
    f32 gradients and losses; the other holds its own against them."""
    import torch.distributed as dist
    from multimodalsimilar_tpu_torch.cli.train import _pad_for_model_parallel
    table = json.load(open(os.path.join(work, "train.json"),
                           encoding="utf-8"))
    tok = TextTokenizer.from_corpus(table["spu_name"])
    world, rank = dist.get_world_size(), dist.get_rank()

    def make():
        return NlpTextClassifier(
            BertConfig.roberta_wwm_ext(hidden_dropout=0.0,
                                       attention_dropout=0.0),
            num_labels=AF_C, arcface=A.ArcFaceParams(m=0.4),
            generator=torch.Generator().manual_seed(SEED))

    base = os.path.join(work, "base_state.pt")
    t0 = time.perf_counter()
    if ref:
        # the one random init on the host; every other spawn loads it
        model = make()
        save_base(model, base, work)
    else:
        model = _on_meta(make)
        model.load_state_dict(torch.load(base, mmap=True,
                                         weights_only=True), assign=True)
    build_s = time.perf_counter() - t0
    init = {k: v.clone() for k, v in model.state_dict().items()}
    configs = ["f32", "bf16"] + (["model_parallel"] if world % 2 == 0
                                 else [])
    out = {}
    for name in configs:
        flags = ["--model_parallel", "2"] if name == "model_parallel" else []
        args = dist_args(os.path.join(work, f"train_{name}_{world}"), *flags)
        args.bf16_grads = name == "bf16"
        src = TextClassificationSource(
            table, tok, args.text_col, args.label_col, args.max_length,
            clean=not args.no_clean, seq_buckets=args.seq_buckets)
        num_labels, num_valid = _pad_for_model_parallel(AF_C, args)
        model.load_state_dict(init)
        if num_labels != AF_C:     # the pad row: masked, never a target
            model.head.weight = torch.nn.Parameter(torch.cat(
                [init["head.weight"], init["head.weight"][:1]]))
            model.num_labels = num_labels
        trainer = _trainer(text_arcface_task(model, num_valid=num_valid),
                           args, DIST_STEPS, device=dev)
        if name != "model_parallel":
            trainer.ckpt = None      # phase 4 holds the one-card save
        batch = next(src.batches(DIST_BATCH, shuffle=False))
        first_loss, grads = dist_first_grads(trainer, batch, dev)
        ref_path = os.path.join(work, "grads_f32.pt")
        row = {"first_loss": first_loss, "model_build_s": build_s,
               "head_rows_on_rank": trainer.model.head.weight.shape[0]}
        if ref and name == "f32" and rank == 0:
            torch.save({k: v.cpu() for k, v in grads.items()}, ref_path)
        elif not ref and rank == 0:
            want = torch.load(ref_path, weights_only=True)
            row["grad_rel_err"] = dist_grad_errors(grads, want,
                                                   DIST_GRAD_TOL[name])
        del grads
        timed = []
        reduce = trainer._reduce_gradients

        def timed_reduce(reduce=reduce):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            reduce()
            end.record()
            timed.append((start, end))

        trainer._reduce_gradients = timed_reduce
        A.LAUNCHES["arcface"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.fit(src, args.epochs, args.batch_size,
                    sampler_fn=_sampler_fn(args, table, args.label_col))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = A.LAUNCHES["arcface"]
        if trainer.step != DIST_STEPS or launches != DIST_STEPS:
            raise AssertionError(f"{name}: {trainer.step} steps, "
                                 f"{launches} ArcFace launches on rank "
                                 f"{rank}; want {DIST_STEPS} of each")
        summary = trainer.timer.summary(args.batch_size)
        reduce_ms = sum(a.elapsed_time(b) for a, b in timed) / len(timed)
        row.update(steps=trainer.step, arcface_launches=launches,
                   fit_s=fit_s, step_ms_p50=summary["p50_ms"],
                   examples_per_s=summary["examples_per_sec"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   all_reduce_ms_per_step=reduce_ms,
                   all_reduce_share=reduce_ms / summary["p50_ms"])
        if rank == 0:
            losses = [ln["train/loss"] for ln in map(json.loads, open(
                os.path.join(args.output, "metrics.jsonl"),
                encoding="utf-8")) if "train/loss" in ln]
            row["losses"] = losses
            path = os.path.join(work, f"losses_{name}.json")
            if ref:
                json.dump([first_loss] + losses, open(path, "w"))
            else:
                want = json.load(open(os.path.join(
                    work, "losses_f32.json" if name == "model_parallel"
                    else f"losses_{name}.json")))
                err = max(abs(a - b) for a, b in zip([first_loss] + losses,
                                                      want))
                if len(want) != len(losses) + 1 or err > DIST_LOSS_TOL:
                    raise AssertionError(f"{name}: losses {losses} vs "
                                         f"world 1's {want[1:]}")
                row["loss_abs_err"] = err
        full = trainer.full_state()
        if name == "model_parallel" and rank == 0:
            # the checkpoint is in the one-card layout
            saved = trainer.ckpt.restore()["model"]["head.weight"]
            if saved.shape != (num_labels, AF_D) or not torch.equal(
                    saved, full["model"]["head.weight"].cpu()):
                raise AssertionError("the model-parallel checkpoint does "
                                     "not hold the gathered head")
            row["checkpoint_head_rows"] = saved.shape[0]
        del full
        release(trainer)
        model.head.weight = torch.nn.Parameter(init["head.weight"].clone())
        model.head.mesh, model.head.column_offset = None, 0
        model.num_labels = AF_C
        out[name] = row
        torch.cuda.empty_cache()
    return out


def save_base(model, path: str, work: str) -> None:
    """The reference spawn's random base tower for every later spawn: its
    state dict, and a port checkpoint of it with the vocab of phase 12's
    titles, which ``similar nlp`` loads with ``--checkpoint`` and
    ``--tokenizer`` (the seed-0 tower and the corpus vocab the command
    would draw and derive itself)."""
    torch.save(model.state_dict(), path)
    CheckpointManager(os.path.join(work, "base_ckpt")).save(
        0, {"step": 0, "model": model.state_dict()})
    titles = [row[1] for row in csv_rows(os.path.join(work, "titles.csv"))]
    TextTokenizer.from_corpus(titles, save_vocab_path=os.path.join(
        work, "vocab.txt"))


def csv_rows(path: str) -> list:
    import csv
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.reader(f))[1:]


def dist_job(name: str, argv, ref: bool, work: str) -> dict:
    """A ``similar`` command through ``cli.main`` on this rank into an
    in-memory sink, its first top-k launch recorded and, after the job,
    held against the plain version (``check_launch``). The reference world
    writes rank 0's KV items; the other's rank 0 must write the same."""
    import torch.distributed as dist
    from multimodalsimilar_tpu_torch.cli import similar as cli_similar
    sink = InMemoryKVSink()
    saved = cli_similar._kv_sink
    cli_similar._kv_sink = lambda args: sink
    launch = T.topk_cuda
    first = []

    def recorded(corpus, queries, k, metric="ip", true_n=None):
        if not first:                  # copies: the job may reuse them
            first.append((corpus.clone(), queries.clone(), k, metric,
                          true_n))
        return launch(corpus, queries, k, metric, true_n)

    T.topk_cuda = recorded
    try:
        _, _, wall, launches = run_cli(argv)
    finally:
        cli_similar._kv_sink = saved
        T.topk_cuda = launch
    if launches["topk"] < 1:
        raise AssertionError(f"{name} never launched the top-k kernel")
    row = {"wall_s": wall, "topk_launches": launches["topk"],
           "kernel_vs_plain": check_launch(f"{name} rank "
                                           f"{dist.get_rank()}", *first[0])}
    del first
    if dist.get_rank() == 0:
        items = kv_items(sink)
        path = os.path.join(work, name.replace(" ", "_") + "_items.json")
        if ref:
            json.dump(items, open(path, "w", encoding="utf-8"))
        else:
            want = json.load(open(path, encoding="utf-8"))
            if items != want:
                bad = sum(items.get(k) != v for k, v in want.items())
                raise AssertionError(f"sharded {name}: {bad} of "
                                     f"{len(want)} KV items differ from "
                                     f"the one-rank job's")
        row["written"] = len(items)
    return row


def dist_similar(ref: bool, work: str) -> dict:
    """(b): ``similar nlp --config configs/similar_nlp.yaml`` over phase
    2's first 25,000 titles, the reference spawn's base tower loaded from
    its checkpoint (``dist_job``)."""
    return dist_job("similar nlp", [
        "similar", "nlp", "--config", config_path("similar_nlp.yaml"),
        "--data", os.path.join(work, "titles.csv"), "--checkpoint",
        os.path.join(work, "base_ckpt"), "--tokenizer",
        os.path.join(work, "vocab.txt")], ref, work)


def check_launch(name, corpus, queries, k, metric, true_n=None,
                 kernel=None) -> dict:
    """The top-k kernel (or ``kernel``: the selection route) against its
    plain version (k + 1 columns) on one block's inputs, as phase 1's
    ``run`` holds it."""
    got = (kernel or T.topk_cuda)(corpus, queries, k, metric, true_n)
    want = T.topk_plain(corpus, queries, k + 1, metric, true_n)
    torch.cuda.synchronize()
    if true_n is not None and int(got[1].max()) >= true_n:
        raise AssertionError(f"{name}: a masked row came back")
    err = check_case(name, got, want, k)
    return {"q": queries.shape[0], "n": corpus.shape[0],
            "true_n": corpus.shape[0] if true_n is None else true_n,
            "d": corpus.shape[1], "k": k, "metric": metric,
            "max_abs_err": err}


def dist_search(dev) -> dict:
    """(c): ``sharded_knn_search`` at phase 1's shapes, 4,096 queries
    against 262,144 x 768 rows in blocks over the data axis, with
    duplicate rows on both sides of the block boundary: it must equal the
    one-block answer (``knn_search`` on this rank) exactly; then the
    kernel on this rank's block against its plain version."""
    from multimodalsimilar_tpu_torch.parallel.mesh import (MeshRules,
                                                           create_mesh)
    from multimodalsimilar_tpu_torch.retrieval.knn import sharded_knn_search
    mesh = create_mesh()
    rng = np.random.default_rng(SEED + 120)
    x = unit_rows(rng, N_CORPUS, DIM, dev)
    half = N_CORPUS // 2
    tied = [half - 1, 3, half - 2]
    for a, b in zip(tied, (half, half + 7, N_CORPUS - 1)):
        x[b] = x[a]                        # ties across the boundary
    q = unit_rows(rng, N_QUERY, DIM, dev)
    q[:3] = x[tied]
    block = x[MeshRules(mesh).corpus_sharded(N_CORPUS)].contiguous()
    out = {}
    for metric in ("ip", "l2"):
        T.LAUNCHES["topk"] = 0
        v, i = sharded_knn_search(mesh, block, q, 13, metric)
        torch.cuda.synchronize()
        launches = T.LAUNCHES["topk"]
        rv, ri = knn_search(x, q, 13, metric)
        if not (torch.equal(v, rv) and torch.equal(i, ri)):
            raise AssertionError(
                f"sharded search ({metric}): {int((i != ri).sum())} "
                f"indices and max score err {float((v - rv).abs().max())} "
                f"against the one-block answer")
        if i[0, :2].tolist() != [half - 1, half]:
            raise AssertionError(f"{metric}: the tie across the boundary "
                                 f"went to {i[0, :2].tolist()}")
        out[metric] = {"topk_launches": launches, "exact": True,
                       "kernel_vs_plain": check_launch(
                           f"search block {mesh.rank} ({metric})", block, q,
                           13, metric)}
    return out


# (e): the daodian areas of the two-rank job. 8,300 rows pad to 16,384, so
# rank 1's block holds 108 real rows and its local search (k = 108) takes
# csrc/topk.cu; at 9,000 rows it holds 808 (k = 808) and takes the
# selection kernel, as rank 0 does on both areas.
DIST_DD_ROWS = (AREA_ROWS, 9_000)
N_DIST_TEXTS = 192                      # the c = 16 level's requests


def serve_e_args(work: str) -> argparse.Namespace:
    """(e)'s ``serve --config configs/serve.yaml``: the saved base tower
    and vocab, warm-started from the reference rank's ``--emb_table``,
    port 0."""
    return cli_args(["serve", "--config", config_path("serve.yaml"),
                     "--data", "synthetic corpus (table=)", "--checkpoint",
                     os.path.join(work, "base_ckpt"), "--tokenizer",
                     os.path.join(work, "vocab.txt"), "--emb_table",
                     os.path.join(work, "serve_emb.parquet"), "--port",
                     "0"])


def write_emb_table(args, table, dev) -> float:
    """The nightly export that (e)'s daemons warm-start from: the corpus
    through the serving tower at the daemon's bulk batch (512), written as
    keys and float lists (the layout ``--emb_table`` reads with one flat
    reshape). Returns its seconds."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from multimodalsimilar_tpu_torch.cli.embedders import (
        _build_text_embedder)
    t0 = time.perf_counter()
    embedder = _build_text_embedder(args, df=table, device=dev)
    embedder.batch_size = 512
    emb = embedder([str(t) for t in table[args.text_col]])
    flat = pa.array(np.ascontiguousarray(emb, np.float32).reshape(-1))
    pq.write_table(pa.table({
        args.key_col: table[args.key_col],
        args.emb_col: pa.FixedSizeListArray.from_arrays(flat,
                                                        emb.shape[1])}),
        args.emb_table)
    del embedder
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def same_answer(name, got, want) -> None:
    """Neighbour lists of two daemons: scores within phase 1's
    tolerances, keys equal wherever ``want``'s neighbouring scores differ
    by more than GAP (the last one by score alone)."""
    gs = np.array([g["score"] for g in got])
    ws = np.array([w["score"] for w in want])
    if gs.shape != ws.shape or not np.allclose(gs, ws, atol=ATOL,
                                               rtol=RTOL):
        raise AssertionError(f"{name}: scores {gs} vs {ws}")
    gap = np.abs(np.diff(ws))
    for r in range(len(ws) - 1):
        if (r == 0 or gap[r - 1] > GAP) and gap[r] > GAP \
                and got[r]["key"] != want[r]["key"]:
            raise AssertionError(f"{name} rank {r}: {got[r]['key']} vs "
                                 f"{want[r]['key']}")


def serve_rank0(service, args, texts, ref: bool, work: str) -> dict:
    """(e) on the serving rank: the warm-up, the same ``/similar``
    requests at c = 1 and c = 16 over HTTP, one ``/update`` and its own
    title; the service closes at the end (a sharded engine then stops its
    followers). Each request's bucket is recorded: a query's bf16
    embedding depends on its bucket's shapes, not on the other queries,
    so the reference tabulates every query's answer at every bucket and
    the two-rank run's answers are held against the entry of the bucket
    each was served at."""
    out = {}
    path = os.path.join(work, "serve_answers.json")
    t0 = time.perf_counter()
    _warm_serve_service(service, args)
    torch.cuda.synchronize()
    out["warm_s"] = time.perf_counter() - t0
    buckets, level = {}, [None]
    try_batch = service._try_device_batch

    def recorded(queries, n):
        for q in queries:
            buckets.setdefault(level[0], {})[q] = service._bucket_size(n)
        return try_batch(queries, n)

    service._try_device_batch = recorded
    httpd = make_server(service, args.host, args.port)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://{args.host}:{httpd.server_address[1]}"
    answers, rows = {}, []
    try:
        for c in (1, 16):
            level[0] = c
            got = answers.setdefault(c, {})

            def call(t, got=got):
                got[t] = _post(base + "/similar", {"text": t,
                                                   "score_th": None}
                               )["neighbors"]

            b0 = service.stats["batches"]
            row = closed_loop(call, texts, c)
            row["batches"] = service.stats["batches"] - b0
            row["buckets"] = dict(collections.Counter(
                buckets[c].values()))
            rows.append(row)
        service._try_device_batch = try_batch
        keys, k = service.engine.keys, service.k
        if ref:
            # at most 16 requests in flight: buckets up to 16; bucket 1's
            # answers for the c = 1 texts are those of the c = 1 level
            table = {t: {"1": got} for t, got in answers[1].items()}
            for b in (1, 2, 4, 8, 16):
                for i in range(0, len(texts), b):
                    if b == 1 and texts[i] in table:
                        continue
                    chunk = texts[i: i + b]
                    got = service._run_batch([{"op": "similar", "query": t}
                                              for t in chunk])
                    for t, (sc, ix) in zip(chunk, got):
                        table.setdefault(t, {})[str(b)] = [
                            {"key": str(keys[j]), "score": float(v)}
                            for v, j in zip(sc[:k], ix[:k])]
        else:
            table = json.load(open(path, encoding="utf-8"))["table"]
        held = 0
        for c in (1, 16):
            for t, got in answers[c].items():
                same_answer(f"c={c} {t!r}", got,
                            table[t][str(buckets[c][t])])
                held += 1
        # /update: a new key whose title then finds it first
        new = texts[0] + "新品上架"
        res = _post(base + "/update", {"items": [
            {"key": "new_e", "text": new, "category": 7}]})
        t0 = time.perf_counter()
        own = _post(base + "/similar", {"text": new, "score_th": None}
                    )["neighbors"]
        first_ms = (time.perf_counter() - t0) * 1e3
        if res["corpus"] != N_SERVE + 1 or own[0]["key"] != "new_e" \
                or own[0]["score"] < 0.999:
            raise AssertionError(f"/update: {res}, then {own[:2]}")
        if ref:
            json.dump({"table": table, "own": own},
                      open(path, "w", encoding="utf-8"))
        else:
            same_answer("after /update", own, json.load(open(
                path, encoding="utf-8"))["own"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
        service.close()
    out.update(levels=rows, answers_held=held,
               similar_after_update_ms=first_ms,
               own_score=own[0]["score"])
    return out


def dist_serve(dev, ref: bool, work: str) -> dict:
    """(e): ``serve --config configs/serve.yaml`` over 100,000 titles on
    this rank, through ``_build_serve_service`` (sharded over the ranks'
    data axis: rank 0 serves, the others follow) and ``serve_rank0``.
    Top-k launches and search dispatches are counted on every rank from
    the built daemon on and must be equal; the corpus re-cuts are
    timed; each rank then holds the kernel against its plain version on
    its first launch's inputs."""
    import torch.distributed as dist

    import multimodalsimilar_tpu_torch.retrieval.engine as engine_mod
    from multimodalsimilar_tpu_torch.pipelines.sharded_serving import (
        Follower)
    table = json.load(open(os.path.join(work, "serve.json"),
                           encoding="utf-8"))
    args = serve_e_args(work)
    rank = dist.get_rank()
    out = {}
    if ref and rank == 0:
        out["emb_table_s"] = write_emb_table(args, table, dev)
    counts = collections.Counter()
    saved = (engine_mod.knn_search, engine_mod.sharded_knn_search,
             SimilarityEngine._ensure_corpus_dev, T.topk_cuda)
    first, recuts = [], []

    def counted(name):
        def fn(*a, **kw):
            counts["dispatches"] += 1
            return saved[name](*a, **kw)
        return fn

    def ensure(self):
        if self._corpus_dev is not None:
            return saved[2](self)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = saved[2](self)
        torch.cuda.synchronize()
        recuts.append((time.perf_counter() - t0) * 1e3)
        return got

    def recorded(corpus, queries, k, metric="ip", true_n=None):
        if not first:
            first.append((corpus.clone(), queries.clone(), k, metric,
                          true_n))
        return saved[3](corpus, queries, k, metric, true_n)

    engine_mod.knn_search, engine_mod.sharded_knn_search = (counted(0),
                                                            counted(1))
    SimilarityEngine._ensure_corpus_dev = ensure
    T.topk_cuda = recorded
    try:
        t0 = time.perf_counter()
        service, n = _build_serve_service(args, table=table, device=dev)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        T.LAUNCHES["topk"] = 0
        counts.clear()
        if isinstance(service, Follower):
            out["followed"] = service.run()
        else:
            out.update(serve_rank0(service, args,
                                   make_titles(N_DIST_TEXTS,
                                               np.random.default_rng(
                                                   SEED + 131)),
                                   ref, work))
        torch.cuda.synchronize()
        launches = T.LAUNCHES["topk"]
    finally:
        (engine_mod.knn_search, engine_mod.sharded_knn_search,
         SimilarityEngine._ensure_corpus_dev, T.topk_cuda) = saved
    if not launches or launches != counts["dispatches"]:
        raise AssertionError(f"serve rank {rank}: {launches} top-k launches "
                             f"for {counts['dispatches']} search dispatches")
    out.update(corpus=n, topk_launches=launches,
               dispatches=counts["dispatches"], recut_ms=recuts,
               kernel_vs_plain=check_launch(f"serve rank {rank}",
                                            *first[0]))
    del first
    torch.cuda.empty_cache()
    return out


def dist_daodian(ref: bool, work: str) -> dict:
    """(e): ``similar daodian --text_only`` at
    ``configs/similar_daodian_v2_recent_days.yaml`` over the two areas
    through ``cli.main`` on this rank. Every rank must launch the
    selection kernel, one top-k kernel or selection launch a rank for
    each area's text search, and holds the selection kernel against its
    plain version on its first launch's inputs; the two-rank run's KV
    items must equal the one-rank run's exactly."""
    import torch.distributed as dist
    from multimodalsimilar_tpu_torch.cli import similar as cli_similar
    sink = InMemoryKVSink()
    saved = (cli_similar._kv_sink, T.topk_select_cuda)
    first = []

    def recorded(corpus, queries, k, metric="ip", true_n=None):
        if not first:
            first.append((corpus.clone(), queries.clone(), k, metric,
                          true_n))
        return saved[1](corpus, queries, k, metric, true_n)

    cli_similar._kv_sink = lambda args: sink
    T.topk_select_cuda = recorded
    try:
        _, _, wall, launches = run_cli([
            "similar", "daodian", "--config",
            config_path("similar_daodian_v2_recent_days.yaml"), "--data",
            os.path.join(work, "areas.csv"), "--text_only",
            "--fasttext_model", os.path.join(work, "fasttext.pt"), "--dt",
            DD_DAYS[-1]])
    finally:
        cli_similar._kv_sink, T.topk_select_cuda = saved
    rank = dist.get_rank()
    searches = launches["topk_select"] + launches["topk"]
    if not launches["topk_select"] or searches != len(DIST_DD_ROWS):
        raise AssertionError(f"daodian rank {rank}: launches {launches} "
                             f"for {len(DIST_DD_ROWS)} text searches")
    row = {"wall_s": wall, "topk_select_launches": launches["topk_select"],
           "topk_launches": launches["topk"],
           "kernel_vs_plain": check_launch(
               f"daodian rank {rank}", *first[0],
               kernel=T.topk_select_cuda)}
    del first
    if rank == 0:
        items = kv_items(sink)
        path = os.path.join(work, "daodian_items.json")
        if ref:
            json.dump(items, open(path, "w", encoding="utf-8"))
        elif items != json.load(open(path, encoding="utf-8")):
            raise AssertionError("sharded similar daodian: the KV items "
                                 "differ from the one-rank job's")
        row["written"] = len(items)
    return row


# (f): train cv at configs/train_cv_daodian.yaml's width (B4, fc 512, 4,181
# classes, batch 24), 4 steps of one epoch (the step timer skips the first
# 3 intervals: one timed step, as (a)), every world in full precision (f32
# products, TF32 off), at 256 px (512 before a cut: two ranks of
# --model_parallel 2 share the card and each holds the whole batch's f32
# activations)
DIST_CV_BATCH, DIST_CV_STEPS, DIST_CV_SIZE = 24, 4, 256
# the running statistics of the first and last BatchNorm after the steps
# against world 1's, as a share of each tensor's largest entry (f32 sums
# in another order)
DIST_BN_RTOL = 1e-4
# a first gradient whose largest entry in world 1 is below this share of
# world 1's largest gradient is float noise (a bias whose output reaches
# the loss only through a train()-mode BatchNorm that takes its mean out
# is zero in exact arithmetic): it is held to stay below that share
DIST_GRAD_NOISE = 1e-4
# (g): similar multimodal --checkpoint over 2,048 rows (B4 at 380 px + the
# base tower); rows i with i % 97 == 5 have no JPEG, in both blocks
N_DIST_MM, DIST_MM_GAP = 2_048, 97


def dist_f_inputs(work: str, dev) -> None:
    """(f)'s and (g)'s inputs in the work directory: 96 JPEGs at 256 px
    with Zipf labels over 4,181 classes that reach the last; (g)'s 2,048
    titles with JPEGs at 380 px (but every 97th), their vocab, and a
    seed-0 multimodal checkpoint whose backbone BN statistics are seeded
    as phase 7 seeds them."""
    rng = np.random.default_rng(SEED + 140)
    n = DIST_CV_BATCH * DIST_CV_STEPS
    keys = [f"cvd{i:04d}" for i in range(n)]
    write_jpegs(os.path.join(work, "cv_images"), keys, DIST_CV_SIZE, rng)
    json.dump({"goods_sku": keys, "tag_new_id": [
        int(v) for v in zipf_with_last(n, CV_LABELS, rng)]},
        open(os.path.join(work, "cv_train.json"), "w", encoding="utf-8"))
    keys = [f"mmd{i:05d}" for i in range(N_DIST_MM)]
    titles = make_titles(N_DIST_MM, rng)
    write_jpegs(os.path.join(work, "mm_images"),
                [k for i, k in enumerate(keys) if i % DIST_MM_GAP != 5],
                MM_SIZE, rng)
    write_csv(os.path.join(work, "mm.csv"),
              {"spu_sn": keys, "spu_name": titles})
    build_char_vocab(titles, out_path=os.path.join(work, "mm_vocab.txt"))
    model = MultimodalClassifier(
        BertConfig.roberta_wwm_ext(), backbone_config(BACKBONE),
        num_labels=MM_LABELS, fc_dim=CV_DIM,
        generator=torch.Generator().manual_seed(SEED))
    seed_bn_statistics(model.cv, SEED + 12, make_images(
        np.random.default_rng(SEED + 12), 8, MM_SIZE), dev)
    CheckpointManager(os.path.join(work, "mm_ckpt")).save(
        0, {"model": model.state_dict()})


def first_last_bn(trainer) -> dict:
    """The running statistics of the model's first and last BatchNorm
    (the stem's and the neck's), on the host."""
    bns = trainer._batch_norms()
    return {f"{tag}.{b}": getattr(m, b).detach().float().cpu().clone()
            for tag, m in (("first", bns[0]), ("last", bns[-1]))
            for b in ("running_mean", "running_var")}


def neck_bias_part(trainer):
    """From here on, records the neck's ``fc.bias`` as each step's forward
    reads it; returns the function that gives its part of the last
    BatchNorm's running mean, m sum_t (1 - m)^(T - t) b_t (the running
    mean is linear in the batch means, and each batch mean holds b_t
    whole). That bias has no gradient in exact arithmetic (the BatchNorm
    after it takes its mean out), so AdamW steps each world's float noise
    in it by up to about lr either way, apart in each world: the running
    mean is held without that part, which is reported."""
    model, bn = trainer.model, trainer._batch_norms()[-1]
    seen = {}

    def record(module, inputs):
        if module.training:
            seen.setdefault(trainer.step,
                            module.fc.bias.detach().float().cpu().clone())

    model.register_forward_pre_hook(record)

    def part():
        out = torch.zeros_like(bn.running_mean, dtype=torch.float32,
                               device="cpu")
        for step in sorted(seen):
            out = (1 - bn.momentum) * out + bn.momentum * seen[step]
        return out

    return part


def bn_rel_err(got: dict, want: dict) -> float:
    """The largest difference of two ``first_last_bn`` results, as a share
    of each tensor's largest entry."""
    return max(float((got[k] - w).abs().max() / w.abs().max().clamp_min(
        1e-30)) for k, w in want.items())


def cv_grad_errors(grads: dict, ref: dict, tol: tuple) -> dict:
    """``dist_grad_errors`` on each gradient that world 1 holds above
    ``DIST_GRAD_NOISE`` of its largest; the others are float noise there
    (zero in exact arithmetic) and must stay below that share here. The
    noise tensors are counted, with the largest share read on either
    side."""
    top = max(float(v.abs().max()) for v in ref.values())
    noise = {n for n, v in ref.items()
             if float(v.abs().max()) < DIST_GRAD_NOISE * top}
    worst = 0.0
    for name in noise:
        got = float(grads[name].abs().max()) / top
        if got >= DIST_GRAD_NOISE:
            raise AssertionError(f"{name}: gradient {got} of the largest "
                                 f"where world 1's is below "
                                 f"{DIST_GRAD_NOISE} of it")
        worst = max(worst, got, float(ref[name].abs().max()) / top)
    out = dist_grad_errors(grads, {n: v for n, v in ref.items()
                                   if n not in noise}, tol)
    return {**out, "held": len(ref) - len(noise), "noise": len(noise),
            "noise_max": worst}


def capture_first_grads(trainer, names: set, into: dict) -> None:
    """From here on the trainer's first ``_reduce_gradients`` also copies
    the reduced gradients of ``names`` to the host (the class blocks
    gathered) into ``into``."""
    from multimodalsimilar_tpu_torch.train.checkpoint import gather_shard
    reduce = trainer._reduce_gradients

    def capture():
        reduce()
        if into:
            return
        for name, p in trainer.model.named_parameters():
            if name in names:
                g = p.grad
                if name in trainer.shards:
                    g = gather_shard(g, trainer.shards[name], trainer.mesh)
                into[name] = g.detach().float().cpu()

    trainer._reduce_gradients = capture


def two_shard_step(trainer):
    """World 1's counterpart of two ``--bf16_grads`` ranks, as its
    ``train_step``: each half of the batch from the same weights and
    running statistics (each half normalized with its own statistics, as
    each rank normalizes its shard), the halves' gradients rounded to
    bf16, added and halved in bf16 (the two ranks' all-reduce mean), their
    running statistics and metrics meaned, then the optimizer step."""
    model = trainer.model
    bns = trainer._batch_norms()

    def step(batch):
        half = next(iter(batch.values())).shape[0] // 2
        start = [(m.running_mean.clone(), m.running_var.clone())
                 for m in bns]
        grads, stats, metrics = [], [], []
        model.train()
        for s in (0, half):
            for m, (mean, var) in zip(bns, start):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
            loss, got = trainer.task.train_loss(
                {k: v[s:s + half] for k, v in batch.items()}, trainer.margin)
            loss.backward()
            grads.append({n: p.grad.to(torch.bfloat16)
                          for n, p in model.named_parameters()
                          if p.grad is not None})
            trainer.optimizer.zero_grad(set_to_none=True)
            stats.append([(m.running_mean.clone(), m.running_var.clone())
                          for m in bns])
            metrics.append(got)
        for n, p in model.named_parameters():
            if n in grads[0]:
                p.grad = ((grads[0][n] + grads[1][n]) / 2).float()
        for m, a, b in zip(bns, *stats):
            m.running_mean.copy_((a[0] + b[0]) / 2)
            m.running_var.copy_((a[1] + b[1]) / 2)
        trainer.step += 1
        trainer._reduce_gradients()
        trainer.optimizer.step()
        trainer.optimizer.zero_grad(set_to_none=True)
        trainer.schedules.step()
        return {k: (metrics[0][k] + metrics[1][k]) / 2 for k in metrics[0]}

    return step


def timed_collectives(trainer) -> dict:
    """CUDA-event spans of every ``torch.distributed.all_reduce`` from here
    on, sorted into the gradient all-reduce (inside
    ``_reduce_gradients``), the BatchNorm ones (the statistics of each
    train()-mode BN, forward and backward, and the running statistics'
    mean under ``--bf16_grads``) and the rest (metrics); returns the
    lists and a function that puts ``all_reduce`` back."""
    import torch.distributed as dist
    spans = {"grad": [], "bn": [], "other": []}
    where = [None]
    real = dist.all_reduce

    def all_reduce(tensor, *a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        work = real(tensor, *a, **kw)
        end.record()
        kind = where[0] or ("bn" if tensor.dim() == 2
                            and tensor.shape[0] == 2 else "other")
        spans[kind].append((start, end))
        return work

    for method, kind in (("_reduce_gradients", "grad"),
                         ("_mean_batch_norm_statistics", "bn")):
        def inside(fn=getattr(trainer, method), kind=kind):
            where[0] = kind
            try:
                fn()
            finally:
                where[0] = None
        setattr(trainer, method, inside)
    dist.all_reduce = all_reduce

    def restore():
        dist.all_reduce = real
    return spans, restore


def dist_cv_train(dev, ref: bool, work: str) -> dict:
    """(f): ``train cv --config configs/train_cv_daodian.yaml`` through
    ``cli/train.py:cmd_train_cv`` on this rank, its mesh from the process
    group as under ``torchrun``, at 256 px, every model in full precision
    (``DTypePolicy.full_precision()``, TF32 off), dropout and drop-path
    off (each world would draw its masks apart): f32 data-parallel (global
    BN statistics) and, over two ranks, ``--bf16_grads`` (each shard's own
    statistics, the gradients meaned in bf16) and ``--model_parallel 2``
    (4,182 classes, 2,091 a rank). World 1 runs f32 and, for
    ``--bf16_grads``, ``two_shard_step``; it writes their losses, first
    gradients (the BatchNorm scales and biases and the head) and the first
    and last BatchNorm's running statistics after the steps. The other
    world holds its own against them: every step's loss within
    ``DIST_LOSS_TOL``, the first gradients within ``DIST_GRAD_TOL``
    (``cv_grad_errors``), the running statistics within ``DIST_BN_RTOL``,
    and each rank's head block against the gathered head's rows that
    ``ArcFaceHead.shard`` gives it."""
    import torch.distributed as dist
    from multimodalsimilar_tpu_torch.cli import train as CT
    from multimodalsimilar_tpu_torch.models.bert import Dropout
    from multimodalsimilar_tpu_torch.parallel.mesh import MeshRules
    table = json.load(open(os.path.join(work, "cv_train.json"),
                           encoding="utf-8"))
    world, rank = dist.get_world_size(), dist.get_rank()
    configs = ["f32", "bf16"] + (["model_parallel"]
                                 if not ref and world % 2 == 0 else [])
    want = None if ref else torch.load(os.path.join(work, "cv_ref.pt"),
                                       weights_only=True)
    fit, out, saved = CT._fit, {}, {}
    for name in configs:
        flags = {"bf16": ["--bf16_grads"],
                 "model_parallel": ["--model_parallel", "2"]}.get(name, [])
        args = cli_args([
            "train", "cv", "--config", config_path("train_cv_daodian.yaml"),
            "--data", "synthetic table (table=)", "--output",
            os.path.join(work, f"cv_{name}_{world}"), "--img_root",
            os.path.join(work, "cv_images"), "--key_col", "goods_sku",
            "--image_size", str(DIST_CV_SIZE), "--epochs", "1",
            "--log_every", "1", *flags])
        row, spans, first = {}, {}, {}
        t_config = time.perf_counter()

        def full_precision_fit(trainer, args, src, *rest, row=row,
                               spans=spans, first=first, name=name):
            model = trainer.model
            for m in model.modules():
                if isinstance(m, Dropout):
                    m.p = 0.0
                if hasattr(m, "policy"):
                    m.policy = DTypePolicy.full_precision()
            if ref and name == "bf16":
                trainer.train_step = two_shard_step(trainer)
            if name != "model_parallel":
                trainer.ckpt = None   # phase 9's train cv writes its save
            row["neck_bias_part"] = neck_bias_part(trainer)
            capture_first_grads(trainer, {
                f"{n}.{p}" for n, m in model.named_modules()
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                for p in ("weight", "bias")} | {"head.weight"}, first)
            got, restore = timed_collectives(trainer)
            spans.update(got)
            A.LAUNCHES["arcface"] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                return fit(trainer, args, src, *rest)
            finally:
                torch.cuda.synchronize()
                restore()
                row["fit_s"] = time.perf_counter() - t0

        CT._fit = full_precision_fit
        try:
            trainer = CT.cmd_train_cv(args, table=table, device=dev)
        finally:
            CT._fit = fit
        launches = A.LAUNCHES["arcface"]
        if trainer.step != DIST_CV_STEPS or launches != DIST_CV_STEPS * (
                2 if ref and name == "bf16" else 1):
            raise AssertionError(f"cv {name}: {trainer.step} steps, "
                                 f"{launches} ArcFace launches on rank "
                                 f"{rank}; want {DIST_CV_STEPS} steps")
        summary = trainer.timer.summary(DIST_CV_BATCH)
        per_step = {k: sum(a.elapsed_time(b) for a, b in v) / trainer.step
                    for k, v in spans.items()}
        res = {"steps": trainer.step, "arcface_launches": launches,
               "fit_s": row["fit_s"], "step_ms_p50": summary["p50_ms"],
               "examples_per_s": summary["examples_per_sec"],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "all_reduces_per_step": {k: len(v) / trainer.step
                                        for k, v in spans.items()},
               "all_reduce_ms_per_step": per_step,
               "all_reduce_share": {k: v / summary["p50_ms"]
                                    for k, v in per_step.items()},
               "bn_layers": len(trainer._batch_norms()),
               "bn_stats_mesh": sum(getattr(m, "stats_mesh", None)
                                    is not None
                                    for m in trainer._batch_norms())}
        losses = None
        if rank == 0:
            losses = [ln["train/loss"] for ln in map(json.loads, open(
                os.path.join(args.output, "metrics.jsonl"),
                encoding="utf-8")) if "train/loss" in ln]
            if len(losses) != DIST_CV_STEPS or not all(
                    math.isfinite(v) for v in losses):
                raise AssertionError(f"cv {name}: losses {losses}")
            res["losses"] = losses
        bn_after = first_last_bn(trainer)
        bias_part = row["neck_bias_part"]()
        bn_after["last.running_mean"] -= bias_part
        if ref:
            saved[name] = {"losses": losses, "grads": first,
                           "bn_after": bn_after, "bias_part": bias_part}
        else:
            base = want["f32" if name == "model_parallel" else name]
            res["bn_after_rel_err"] = bn_rel_err(bn_after, base["bn_after"])
            res["neck_bias_part_abs_err"] = float(
                (bias_part - base["bias_part"]).abs().max())
            if res["bn_after_rel_err"] > DIST_BN_RTOL:
                raise AssertionError(f"cv {name} rank {rank}: running "
                                     f"statistics after the steps differ "
                                     f"by {res['bn_after_rel_err']}")
            if rank == 0:
                res["loss_abs_err"] = max(abs(a - b) for a, b in zip(
                    losses, base["losses"]))
                if res["loss_abs_err"] > DIST_LOSS_TOL:
                    raise AssertionError(f"cv {name}: losses {losses} vs "
                                         f"world 1's {base['losses']}")
                res["grad_rel_err"] = cv_grad_errors(
                    first, base["grads"], DIST_GRAD_TOL[name])
        if name == "model_parallel":
            whole = trainer.full_state()["model"]["head.weight"]
            rows = MeshRules(trainer.mesh).class_sharded(whole.shape[0])
            block = trainer.model.head.weight.detach()
            if block.shape[0] != (CV_LABELS + 1) // 2 or not torch.equal(
                    block, whole[rows].to(block.device)):
                raise AssertionError(f"cv model_parallel rank {rank}: head "
                                     f"block {tuple(block.shape)} is not "
                                     f"rows {rows} of the gathered head")
            res["head_rows_on_rank"] = block.shape[0]
        release(trainer)
        res["config_s"] = time.perf_counter() - t_config
        out[name] = res
        del trainer
        torch.cuda.empty_cache()
    if ref and rank == 0:
        torch.save(saved, os.path.join(work, "cv_ref.pt"))
    return out


def dist_similar_mm(ref: bool, work: str) -> dict:
    """(g): ``similar multimodal --checkpoint`` over the 2,048 rows of
    ``dist_f_inputs`` at ``configs/serve_multimodal.yaml``'s model (B4 at
    380 px + the base tower, fc 512, 796 labels, batch 48, k 13), through
    ``cli.main`` (``dist_job``): each rank embeds its own block of rows,
    counted here, and must embed no other."""
    from multimodalsimilar_tpu_torch.cli import embedders as cli_embedders
    fused, embedded = cli_embedders._fused_embeddings, []

    def counted(args, df, *a, **kw):
        embedded.append(len(df["spu_sn"]))
        return fused(args, df, *a, **kw)

    cli_embedders._fused_embeddings = counted
    try:
        row = dist_job("similar multimodal", [
            "similar", "multimodal", "--data", os.path.join(work, "mm.csv"),
            "--checkpoint", os.path.join(work, "mm_ckpt"), "--tokenizer",
            os.path.join(work, "mm_vocab.txt"), "--img_root",
            os.path.join(work, "mm_images"), "--bert_preset", "base",
            "--num_labels", str(MM_LABELS)], ref, work)
    finally:
        cli_embedders._fused_embeddings = fused
    import torch.distributed as dist
    world = dist.get_world_size()
    if sum(embedded) != -(-N_DIST_MM // world):
        raise AssertionError(f"similar multimodal: rank "
                             f"{dist.get_rank()} embedded {embedded} rows "
                             f"of {N_DIST_MM} over {world} ranks")
    row["rows_embedded"] = sum(embedded)
    return row


def phase12_rank(ref: bool, work: str) -> dict:
    """What every rank of phase 12 runs: (a) to (g) of the docstring, its
    prints swallowed (rank 0's trainer logs every step), each part's wall
    seconds in ``wall_s``."""
    import contextlib
    import io

    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    out, wall = {}, {}
    with contextlib.redirect_stdout(io.StringIO()):
        for key, fn, args in (
                ("train", dist_train, (dev, ref, work)),
                ("similar", dist_similar, (ref, work)),
                ("serve", dist_serve, (dev, ref, work)),
                ("daodian", dist_daodian, (ref, work)),
                ("train_cv", dist_cv_train, (dev, ref, work)),
                ("similar_multimodal", dist_similar_mm, (ref, work)),
                ("search", dist_search, (dev,))):
            t0 = time.perf_counter()
            out[key] = fn(*args)
            wall[key] = time.perf_counter() - t0
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend(), "wall_s": wall, **out}


def dist_e_inputs(work: str) -> None:
    """(e)'s inputs in the work directory: the 100,000-title corpus with a
    40-value category (phase 5's layout), the two daodian areas and a
    fastText model trained on their titles on the card."""
    from multimodalsimilar_tpu_torch.models.fasttext import train_supervised
    rng = np.random.default_rng(SEED + 130)
    json.dump({"spu_sn": [f"spu{i:06d}" for i in range(N_SERVE)],
               "spu_name": make_titles(N_SERVE, rng),
               "first_level_category_id": [int(c) for c in rng.integers(
                   0, N_CATEGORIES, N_SERVE)]},
              open(os.path.join(work, "serve.json"), "w", encoding="utf-8"))
    areas = daodian_table(rng, title_words(), rows=DIST_DD_ROWS)
    write_csv(os.path.join(work, "areas.csv"), areas)
    train_supervised(areas["title"], areas["first_level_category_id"],
                     dim=FT_DIM, lr=25.6, epochs=2, word_ngrams=2,
                     device="cuda").save(os.path.join(work, "fasttext.pt"))


def timed_search(corpus, q, k, metric, true_n=None, select=False,
                 reps=20) -> dict:
    """One search timed alone on the card: the top-k kernel (the selection
    route with ``select``), its plain version and the library call on the
    same inputs, beside ``T.bound_ms`` for this shape."""
    n = corpus.shape[0] if true_n is None else true_n
    kernel = T.topk_select_cuda if select else T.topk_cuda
    library = select_library if select else topk_library
    row = {"q": q.shape[0], "n": corpus.shape[0], "true_n": n,
           "d": corpus.shape[1], "k": k, "metric": metric,
           "ms": cuda_ms(lambda: kernel(corpus, q, k, metric, true_n),
                         reps=reps),
           "plain_ms": cuda_ms(lambda: T.topk_plain(corpus, q, k, metric,
                                                    true_n), reps=1),
           "library_ms": cuda_ms(lambda: library(corpus, q, k, metric,
                                                 true_n) if select else
                                 library(corpus[:n], q, k, metric),
                                 reps=reps)}
    row["bound_ms"], row["bound_by"] = T.bound_ms(q.shape[0], n,
                                                  corpus.shape[1], k, metric)
    return row


def dist_e_blocks(dev) -> dict:
    """(e)'s per-rank searches alone (``timed_search``): the serving block
    (64 queries against 65,536 x 768 rows: rank 0's all real, rank 1's
    34,464) through the top-k kernel, and the daodian text arm's blocks
    through the selection kernel (8,300 queries of d = 100 against rank
    0's 8,192 rows at k = 1,185; 9,000 against rank 1's 808 real rows of
    the 9,000-row area at k = 808)."""
    rng = np.random.default_rng(SEED + 132)
    rows = next_pow2(N_SERVE, 512) // 2
    block, q = unit_rows(rng, rows, DIM, dev), unit_rows(rng, 64, DIM, dev)
    out = {"serve_blocks": [timed_search(block, q, 13, "ip", true_n)
                            for true_n in (rows, N_SERVE - rows)],
           "daodian_blocks": []}
    del block, q
    small, big = DIST_DD_ROWS
    rows = next_pow2(small, 512) // 2
    for n_q, true_n, k in ((small, rows, small // RECENT_DAYS),
                           (big, big - rows,
                            min(big // RECENT_DAYS, big - rows))):
        x = unit_rows(rng, rows, FT_DIM, dev)
        q = unit_rows(rng, n_q, FT_DIM, dev)
        out["daodian_blocks"].append(timed_search(x, q, k, "ip", true_n,
                                                  select=True, reps=3))
        del x, q
    torch.cuda.empty_cache()
    return out


def dist_f_blocks(dev, gloo) -> dict:
    """(f)'s and (g)'s per-rank kernels alone: the ArcFace kernel on one
    class block of ``--model_parallel 2`` at the cv recipe (24 rows x
    2,091 classes x 512, m 0.2, as phase 3's recipe heads), and the top-k
    kernel on each rank's block of the two-rank multimodal job, at the
    shape of that rank's first launch (fused rows of norm sqrt(2), l2,
    d = 1,280; ``timed_search``)."""
    rng = np.random.default_rng(SEED + 142)
    out = {"arcface_cv_block": recipe_head(
        dev, "cv model_parallel block, B=24", DIST_CV_BATCH,
        (CV_LABELS + 1) // 2, CV_DIM, 0.2), "mm_job_blocks": []}
    for r in gloo:
        shape = r["similar_multimodal"]["kernel_vs_plain"]
        corpus = fused_rows(rng, shape["n"], dev)
        q = fused_rows(rng, shape["q"], dev)
        out["mm_job_blocks"].append(timed_search(
            corpus, q, shape["k"], shape["metric"], shape["true_n"]))
        del corpus, q
    torch.cuda.empty_cache()
    return out


def print_dist_fg(runs: dict) -> None:
    """One line: (f)'s step p50, peak memory and all-reduce shares a rank
    by world and configuration, and (g)'s rows embedded and job wall a
    rank, with the card's name and power limit."""
    print(json.dumps({"phase12_fg": {"card": card_line(), **{
        world: {"train_cv": {name: [{k: r["train_cv"][name][k] for k in (
            "step_ms_p50", "peak_gb", "all_reduce_ms_per_step",
            "all_reduce_share", "all_reduces_per_step", "config_s")}
            for r in ranks] for name in ranks[0]["train_cv"]},
            "similar_multimodal": [{k: r["similar_multimodal"][k] for k in (
                "rows_embedded", "wall_s", "topk_launches")}
                for r in ranks]}
        for world, ranks in runs.items()}}}), flush=True)


def phase12(dev) -> dict:
    """Multi-GPU training and the corpus-sharded search (see the
    docstring): one rank over NCCL (the reference), one rank per card
    over NCCL where there are several, then two ranks on ``cuda:0`` over
    gloo, each spawn with a time limit."""
    from multimodalsimilar_tpu_torch.parallel.spawn import spawn
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        rng = np.random.default_rng(SEED + 110)
        n = DIST_BATCH * DIST_STEPS
        json.dump({"spu_name": make_titles(n, rng),
                   "tag_new_id": [int(v) for v in
                                  zipf_with_last(n, AF_C, rng)]},
                  open(os.path.join(work, "train.json"), "w",
                       encoding="utf-8"))
        titles = make_titles(N_DIST_TITLES, np.random.default_rng(SEED + 1))
        write_csv(os.path.join(work, "titles.csv"),
                  {"spu_sn": [f"spu{i:06d}" for i in range(N_DIST_TITLES)],
                   "spu_name": titles})
        dist_e_inputs(work)
        t0 = time.perf_counter()
        dist_f_inputs(work, dev)
        inputs_f_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        n_cards = torch.cuda.device_count()
        wall = {}

        def run(name, world, ref, backend):
            t0 = time.perf_counter()
            ranks = spawn(phase12_rank, world, (ref, work), device="cuda",
                          backend=backend, timeout=DIST_TIMEOUT,
                          threads=None)
            wall[name] = time.perf_counter() - t0
            for r in ranks:
                mp = r["train"].get("model_parallel")
                if mp and mp["head_rows_on_rank"] != (AF_C + 1) // 2:
                    raise AssertionError(f"{name} rank {r['rank']} holds "
                                         f"{mp['head_rows_on_rank']} "
                                         f"classes")
            return ranks

        nccl = run("nccl", 1, True, "nccl")
        every_card = (run("nccl_every_card", n_cards, False, "nccl")
                      if n_cards > 1 else None)
        gloo = run("gloo_on_one_card", 2, False, "gloo")
        print_dist_fg({"nccl": nccl, "gloo_on_one_card": gloo})
        # the kernel on one block of (c), alone, beside its bound and
        # torch.topk of the same block
        rng = np.random.default_rng(SEED + 121)
        block = unit_rows(rng, N_CORPUS // 2, DIM, dev)
        q = unit_rows(rng, N_QUERY, DIM, dev)
        shard = {"q": N_QUERY, "n": N_CORPUS // 2, "d": DIM, "k": 13,
                 "metric": "ip",
                 "ms": cuda_ms(lambda: T.topk_cuda(block, q, 13, "ip")),
                 "plain_ms": cuda_ms(lambda: T.topk_plain(block, q, 13,
                                                          "ip"), reps=1),
                 "library_ms": cuda_ms(lambda: topk_library(block, q, 13,
                                                            "ip"))}
        shard["bound_ms"], shard["bound_by"] = T.bound_ms(
            N_QUERY, N_CORPUS // 2, DIM, 13, "ip")
        del block, q
        torch.cuda.empty_cache()
        # the kernel on one class block of --model_parallel 2 (5,103 of
        # 10,206 classes): a rank's 1,024 rows here, and a micro-batch of
        # 128 (the batch a rank takes when the data axis splits it 8 ways)
        blocks = [recipe_head(dev, f"model_parallel block, B={b}", b,
                              (AF_C + 1) // 2, AF_D, 0.4)
                  for b in (128, DIST_BATCH)]
        return {"nccl": nccl, "nccl_every_card": every_card,
                "gloo_on_one_card": gloo, "arcface_blocks": blocks,
                "spawn_wall_s": wall, "inputs_f_s": inputs_f_s,
                "gloo_times": "two ranks share one card and their "
                              "collectives stage through the host: not a "
                              "scaling number",
                "search_shard": shard, **dist_e_blocks(dev),
                **dist_f_blocks(dev, gloo)}
    finally:
        shutil.rmtree(work, ignore_errors=True)

# -- phase 13: tensor- and sequence-parallel training of the large tower ------

# train_nlp_large_tp.yaml's batch; 2 steps (3 before a cut for time)
P13_BATCH, P13_STEPS = 256, 2
P13_CHARS = 46                         # + [CLS], [SEP]: the 48 bucket
P13_CLASSES = -(-AF_C // 4) * 4        # 10,208: the head padded for model 4
P13_LOSS_RTOL = 2e-3                   # four ranks against one, per step
P13_REMAT_RTOL = 1e-5                  # remat against none, one rank
# first gradients: four ranks' distance to one rank's f32 gradients, at
# most this many times one rank's bf16 distance plus this slack (shares
# of each tensor's largest entry; see p13_grad_errors)
P13_F32_FACTOR, P13_F32_SLACK = 2.0, 2e-3
P13_TIMEOUT = 900
P13_PP_CLASSES = -(-AF_C // 2) * 2     # 10,206: the head padded for model 2
P13_PP_TIMEOUT = 300                   # (d)'s spawn


def p13_args(output: str, ranks: int, remat: bool,
             config: str = "train_nlp_large_tp.yaml") -> argparse.Namespace:
    """``train nlp --config configs/train_nlp_large_tp.yaml`` as the
    command line parses it (model 4, ``--tensor_parallel
    --sequence_parallel --remat``, batch 256, buckets 48/64/96), or
    ``train_nlp_large_pp.yaml`` (model 2, ``--pipeline_parallel 2
    --remat``), one epoch logged every step; one rank takes
    ``--model_parallel 1`` without the layouts."""
    args = cli_args(["train", "nlp", "--config",
                     config_path(config), "--data",
                     "unused", "--output", output, "--epochs", "1",
                     "--log_every", "1", "--batch_size", str(P13_BATCH)])
    if ranks == 1:
        args.model_parallel = 1
        args.tensor_parallel = args.sequence_parallel = False
        args.pipeline_parallel = 0
    args.remat = remat
    return args


def p13_state(dev) -> dict:
    """Seeded weights of the large classifier (roberta-wwm-ext-large with
    the 10,205-class head), drawn on the card: normal(0, 0.02) weights and
    tables, zero biases, unit LayerNorm scales (HF's init) and the
    xavier-uniform head."""
    model = _on_meta(lambda: NlpTextClassifier(
        BertConfig.roberta_wwm_ext_large(), num_labels=AF_C))
    gen = torch.Generator(device=dev).manual_seed(SEED + 130)
    state = {}
    for name, p in model.state_dict().items():
        if name == "head.weight":
            bound = math.sqrt(6.0 / sum(p.shape))
            t = torch.empty(p.shape, device=dev).uniform_(
                -bound, bound, generator=gen)
        elif "LayerNorm.weight" in name:
            t = torch.ones(p.shape, device=dev)
        elif name.endswith("bias"):
            t = torch.zeros(p.shape, device=dev)
        else:
            t = torch.empty(p.shape, device=dev).normal_(0.0, 0.02,
                                                         generator=gen)
        state[name] = t
    return state


class CollectiveClock:
    """Seconds inside the mesh's collectives while on, each outermost call
    bracketed by ``torch.cuda.synchronize`` (gloo stages CUDA tensors
    through the host, so a collective's time is the host's; a composed
    collective calling another counts once)."""

    NAMES = ("all_reduce", "reduce_scatter", "all_gather_dim",
             "all_gather", "shift", "broadcast")

    def __init__(self):
        from multimodalsimilar_tpu_torch.parallel.mesh import Mesh
        self.mesh_cls, self.saved = Mesh, {}
        self.seconds, self.calls, self.depth = 0.0, 0, 0
        # the pipeline's stage hand-offs: seconds and bytes handed on
        self.shift_s, self.shift_bytes = 0.0, 0

    def __enter__(self):
        for name in self.NAMES:
            fn = self.saved[name] = getattr(self.mesh_cls, name)

            def timed(*a, fn=fn, name=name, **kw):
                if self.depth:
                    return fn(*a, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                self.depth += 1
                try:
                    out = fn(*a, **kw)
                finally:
                    self.depth -= 1
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                self.seconds += dt
                self.calls += 1
                if name == "shift":
                    self.shift_s += dt
                    self.shift_bytes += a[1].numel() * a[1].element_size()
                return out

            setattr(self.mesh_cls, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mesh_cls, name, fn)


def check_arcface_launch(name, x, w, label, m) -> dict:
    """The ArcFace kernel against its plain version on one launch's
    inputs, as phase 3 holds it (``af_tolerance``)."""
    got = A.arcface_logits_cuda(x, w, label, m, 64.0)
    want = A.arcface_logits(x, w, label, m, 64.0)
    cos = A.cosine_logits(x, w)
    torch.cuda.synchronize()
    err = (got - want).abs()
    allow, _ = af_tolerance(want, cos, label, m)
    if not torch.isfinite(got).all() or (err > allow).any():
        raise AssertionError(f"{name}: {int((err > allow).sum())} logits "
                             f"beyond tolerance, max abs err "
                             f"{float(err.max())}")
    return {"b": x.shape[0], "c": w.shape[0], "d": x.shape[1],
            "max_abs_err": float(err.max())}


def p13_grad_errors(grads: dict, one: dict, f32: dict) -> dict:
    """Four ranks' first gradients (``grads``) against one rank's in the
    same bf16 policy (``one``) and both against one rank's in full
    precision (``f32``), each as a share of the f32 tensor's largest
    entry (at least 1e-4 of the model's largest f32 gradient). The check:
    every tensor of the four ranks lies within ``P13_F32_FACTOR`` times
    one rank's distance to f32, plus ``P13_F32_SLACK`` (the bf16 products
    round differently split over four ranks, but no farther from the f32
    gradients than by that); the head's pad rows have no gradient.
    Returns the worst shares by group and the eight tensors of largest
    ratio."""
    top = max(float(v.abs().max()) for v in f32.values())
    rows, worst = {}, {"head": [0.0, 0.0, 0.0], "tower": [0.0, 0.0, 0.0]}
    for name, truth in f32.items():
        got = grads[name]
        if got.shape[0] > truth.shape[0]:          # the padded head
            if float(got[truth.shape[0]:].abs().max()) != 0.0:
                raise AssertionError(f"{name}: a pad class has a gradient")
            got = got[:truth.shape[0]]
        truth = truth.to(got.device)
        scale = max(float(truth.abs().max()), 1e-4 * top)
        ref = one[name].to(got.device)
        e = (float((got - ref).abs().max()) / scale,
             float((got - truth).abs().max()) / scale,
             float((ref - truth).abs().max()) / scale)
        rows[name] = e
        group = worst["head" if name.startswith("head.") else "tower"]
        for i in range(3):
            group[i] = max(group[i], e[i])
    bad = [(n, e) for n, e in rows.items()
           if e[1] > P13_F32_FACTOR * e[2] + P13_F32_SLACK]
    if bad:
        raise AssertionError(f"four ranks' gradients farther from f32 than "
                             f"one rank's: {bad[:8]}")
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][1] / max(
        kv[1][2], 1e-12))[:8]
    return {"worst": {g: dict(zip(("vs_one_rank", "tp_vs_f32",
                                   "one_rank_vs_f32"), v))
                      for g, v in worst.items()},
            "largest_ratio": [(n, *e) for n, e in ranked]}


def p13_run(name, args, state, table, tok, dev, work) -> dict:
    """One run of (a), (b) or (c) over ``P13_STEPS`` steps, the gradients
    of the first step (reduced as the step reduces them, gathered to the
    one-card layout) captured before the optimizer takes them, and the
    collectives timed inside the steps; ``name="f32"``: only the
    gradients of that first batch, in full precision."""
    import torch.distributed as dist
    from multimodalsimilar_tpu_torch.cli.train import (_layout,
                                                       _pad_for_model_parallel)
    from multimodalsimilar_tpu_torch.train.checkpoint import gather_shard
    rank = dist.get_rank()
    num_labels, num_valid = _pad_for_model_parallel(AF_C, args)
    cfg = BertConfig.roberta_wwm_ext_large(
        hidden_dropout=0.0, attention_dropout=0.0, remat=args.remat,
        sequence_parallel=args.sequence_parallel,
        pipeline_parallel=args.pipeline_parallel > 0,
        pp_microbatches=max(args.pipeline_parallel, 1))
    policy = (DTypePolicy.full_precision() if name == "f32"
              else DTypePolicy())
    mesh, scope = _layout(args)
    with scope:                      # a pipeline rank builds its stage
        model = _on_meta(lambda: NlpTextClassifier(
            cfg, policy=policy, num_labels=num_labels,
            arcface=A.ArcFaceParams(m=args.margin)))
    sd = {k: state[k].to(dev, copy=True) for k in model.state_dict()}
    if num_labels != AF_C:           # pad rows: masked, never a target
        head = sd["head.weight"]
        sd["head.weight"] = torch.cat([head, head[:num_labels - AF_C]])
    model.load_state_dict(sd, assign=True)
    del sd
    src = TextClassificationSource(
        table, tok, args.text_col, args.label_col, args.max_length,
        clean=not args.no_clean, seq_buckets=args.seq_buckets)
    trainer = _trainer(text_arcface_task(model, num_valid=num_valid),
                       args, P13_STEPS, device=dev, mesh=mesh)
    if name not in ("tp", "pp"):
        trainer.ckpt = None
    # fit's first batch (shuffled by the seed, no sampler)
    first_batch = next(src.batches(P13_BATCH, shuffle=True, seed=args.seed,
                                   epoch=0))
    if first_batch["input_ids"].shape[1] != 48:
        raise AssertionError(f"batch of {first_batch['input_ids'].shape[1]}"
                             f" tokens, want the 48 bucket")
    first, grads = [], {}
    launch, reduce = A.arcface_logits_cuda, trainer._reduce_gradients

    def recorded(x, w, label, m, s=64.0, easy_margin=False):
        if not first:
            first.append((x.detach().clone(), w.detach().clone(),
                          label.clone(), m))
        return launch(x, w, label, m, s, easy_margin)

    def captured():
        reduce()
        if not grads and name != "pp":
            for n, p in trainer.model.named_parameters():
                g = p.grad
                grads[n] = (gather_shard(g, trainer.shards[n], trainer.mesh)
                            if n in trainer.shards else g.clone())

    A.arcface_logits_cuda = recorded
    trainer._reduce_gradients = captured
    clock = CollectiveClock()
    steps, handoffs = [], []
    train_step = trainer.train_step

    def timed_step(batch):
        torch.cuda.synchronize()
        t0, c0, h0 = time.perf_counter(), clock.seconds, clock.shift_s
        out = train_step(batch)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0, clock.seconds - c0))
        handoffs.append(clock.shift_s - h0)
        return out

    trainer.train_step = timed_step
    A.LAUNCHES["arcface"] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        if name == "f32":
            dist_first_grads(trainer, first_batch, dev)
        else:
            with clock:
                trainer.fit(src, args.epochs, args.batch_size)
    finally:
        A.arcface_logits_cuda = launch
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = A.LAUNCHES["arcface"]
    layer_tensors = [n for n, _ in trainer.model.named_parameters()
                     if ".encoder.layer." in n]
    row = {"mesh": dict(trainer.mesh.shape),
           "head_rows_on_rank": trainer.model.head.weight.shape[0],
           "cut_parameters": len(trainer.shards),
           "sequence_partial": len(trainer.sequence_partial),
           "layer_tensors": len(layer_tensors),
           "layers": sorted({int(n.split(".encoder.layer.")[1]
                                 .split(".")[0]) for n in layer_tensors}),
           "kernel_vs_plain": check_arcface_launch(
               f"phase 13 {name} rank {rank}", *first[0])}
    del first
    path = os.path.join(work, "p13_grads_{}.pt")
    if name in ("remat", "f32") and rank == 0:
        torch.save({k: v.cpu() for k, v in grads.items()},
                   path.format(name))
    elif name == "tp" and rank == 0:
        row["grad_errors"] = p13_grad_errors(grads, *(
            torch.load(path.format(n), weights_only=True, mmap=True)
            for n in ("remat", "f32")))
    grads.clear()
    if name == "f32":
        release(trainer)
        return row
    if trainer.step != P13_STEPS or launches != P13_STEPS:
        raise AssertionError(f"phase 13 {name}: {trainer.step} steps, "
                             f"{launches} ArcFace launches on rank {rank}")
    # steps after the first (which gathers the captured gradients), each
    # between two synchronizations
    p50 = float(np.median([t for t, _ in steps[1:]]))
    step_s = sum(t for t, _ in steps[1:])
    row.update(steps=trainer.step, arcface_launches=launches, fit_s=fit_s,
               step_ms_p50=1e3 * p50, examples_per_s=P13_BATCH / p50,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               step_s=[t for t, _ in steps],
               collective_s=[c for _, c in steps],
               collective_share=sum(c for _, c in steps[1:]) / step_s)
    if name == "pp":   # the stage hand-offs (waits for the peer included)
        row.update(handoff_s=handoffs,
                   handoff_mb_per_step=clock.shift_bytes / P13_STEPS / 1e6,
                   handoff_share=sum(handoffs[1:]) / step_s)
    if rank == 0:
        row["losses"] = [
            ln["train/loss"] for ln in map(json.loads, open(os.path.join(
                args.output, "metrics.jsonl"), encoding="utf-8"))
            if "train/loss" in ln]
    if name in ("tp", "pp") and rank == 0:   # the model's part, mapped
        saved = torch.load(trainer.ckpt._path(trainer.ckpt.latest_step()),
                           mmap=True, weights_only=True)["model"]
        bad = [k for k, v in state.items() if k != "head.weight"
               and tuple(saved[k].shape) != tuple(v.shape)]
        if bad or len(saved) != len(state) or saved["head.weight"].shape != (
                num_labels, state["head.weight"].shape[1]):
            raise AssertionError(f"the {name} checkpoint is not in the "
                                 f"one-card layout: {bad[:4]}, "
                                 f"{len(saved)} tensors, head "
                                 f"{tuple(saved['head.weight'].shape)}")
        if name == "pp":             # the one-rank model loads it
            one = _on_meta(lambda: NlpTextClassifier(
                BertConfig.roberta_wwm_ext_large(), num_labels=num_labels))
            one.load_state_dict(saved, assign=True)
            del one
        row["checkpoint_head_rows"] = saved["head.weight"].shape[0]
        row["checkpoint_tensors"] = len(saved)
        del saved
    release(trainer)
    return row


def phase13_rank(kind: str, work: str) -> dict:
    """(a), (c) and the f32 gradients on the reference rank
    (``kind="ref"``, which saves its weights' per-tensor sums in
    ``work``), (b) on each of the tensor-parallel ranks (``kind="tp"``)
    or (d) on each of the pipeline ranks (``kind="pp"``). Every rank draws the reference's weights from the
    same seeded CUDA generator (a 1.3 GB state dict is not written to the
    disk and read four times) and checks them against those sums; the
    model is built on the meta device and loads them."""
    import contextlib
    import io

    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    table = json.load(open(os.path.join(work, "p13.json"),
                           encoding="utf-8"))
    tok = TextTokenizer.from_corpus(table["spu_name"])
    path = os.path.join(work, "p13_state_sums.json")
    t0 = time.perf_counter()
    state = p13_state(dev)
    sums = {k: float(v.double().sum()) for k, v in state.items()}
    if kind == "ref":
        json.dump(sums, open(path, "w"))
    elif sums != json.load(open(path)):
        raise AssertionError("phase 13: this rank drew other weights than "
                             "the reference rank")
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.get_backend(),
           "weights_s": time.perf_counter() - t0}
    runs = ([("remat", 1, True), ("f32", 1, True), ("no_remat", 1, False)]
            if kind == "ref"
            else [(kind, dist.get_world_size(), True)])
    with contextlib.redirect_stdout(io.StringIO()):
        for name, ranks, remat in runs:
            args = p13_args(os.path.join(work, f"{name}_{out['backend']}"),
                            ranks, remat, f"train_nlp_large_{name}.yaml"
                            if name in ("tp", "pp") else
                            "train_nlp_large_tp.yaml")
            out[name] = p13_run(name, args, state, table, tok, dev, work)
            torch.cuda.empty_cache()
    return out


def phase13(dev) -> dict:
    """Tensor- and sequence-parallel training of the large text tower at
    ``configs/train_nlp_large_tp.yaml`` and pipeline-parallel training
    at ``configs/train_nlp_large_pp.yaml`` (see the docstring): (a) and
    (c) on one NCCL rank, (b) on four gloo ranks on ``cuda:0`` (and over
    NCCL on four cards where the machine has them), (d) on two gloo ranks
    on ``cuda:0`` (and over NCCL on two cards where the machine has
    them); each spawn with a time limit."""
    from multimodalsimilar_tpu_torch.parallel.spawn import spawn
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        rng = np.random.default_rng(SEED + 131)
        n = P13_BATCH * P13_STEPS
        titles = [t[:P13_CHARS] for t in make_titles(n, rng)]
        json.dump({"spu_name": titles,
                   "tag_new_id": [int(v) for v in
                                  zipf_with_last(n, AF_C, rng)]},
                  open(os.path.join(work, "p13.json"), "w",
                       encoding="utf-8"))
        wall = {}

        def run(name, world, kind, backend):
            t0 = time.perf_counter()
            ranks = spawn(phase13_rank, world, (kind, work), device="cuda",
                          backend=backend, timeout=P13_PP_TIMEOUT
                          if kind == "pp" else P13_TIMEOUT, threads=None)
            wall[name] = time.perf_counter() - t0
            return ranks

        ref = run("reference_nccl", 1, "ref", "nccl")[0]
        a, c = ref["remat"], ref["no_remat"]
        err = max(abs(x - y) / abs(y) for x, y in zip(c["losses"],
                                                      a["losses"]))
        if len(c["losses"]) != len(a["losses"]) or err > P13_REMAT_RTOL \
                or not a["peak_gb"] < c["peak_gb"]:
            raise AssertionError(f"remat: losses {a['losses']} vs "
                                 f"{c['losses']}, peak {a['peak_gb']} vs "
                                 f"{c['peak_gb']} GB")
        out = {"reference": ref, "remat_loss_rel_err": err}
        runs = [("gloo_on_one_card", 4, "gloo")]
        if torch.cuda.device_count() >= 4:
            runs.append(("nccl_four_cards", 4, "nccl"))
        for name, world, backend in runs:
            ranks = run(name, world, "tp", backend)
            got = ranks[0]["tp"]
            err = max(abs(x - y) / abs(y) for x, y in zip(got["losses"],
                                                          a["losses"]))
            if len(got["losses"]) != len(a["losses"]) \
                    or err > P13_LOSS_RTOL:
                raise AssertionError(f"{name}: losses {got['losses']} vs "
                                     f"one rank's {a['losses']}")
            for r in ranks:
                if r["tp"]["head_rows_on_rank"] != P13_CLASSES // 4:
                    raise AssertionError(f"{name} rank {r['rank']} holds "
                                         f"{r['tp']['head_rows_on_rank']} "
                                         f"classes")
            out[name] = {"ranks": ranks, "loss_rel_err": err}
        runs = [("pp_gloo_on_one_card", 2, "gloo")]
        if torch.cuda.device_count() >= 2:
            runs.append(("pp_nccl_two_cards", 2, "nccl"))
        for name, world, backend in runs:
            ranks = run(name, world, "pp", backend)
            got = ranks[0]["pp"]
            err = max(abs(x - y) / abs(y) for x, y in zip(got["losses"],
                                                          a["losses"]))
            if len(got["losses"]) != len(a["losses"]) \
                    or err > P13_LOSS_RTOL:
                raise AssertionError(f"{name}: losses {got['losses']} vs "
                                     f"one rank's {a['losses']}")
            half = BertConfig.roberta_wwm_ext_large().num_layers // 2
            for r in ranks:
                s, held = r["rank"], r["pp"]
                if held["layers"] != list(range(half * s, half * s + half)) \
                        or held["layer_tensors"] != half * 16 \
                        or held["head_rows_on_rank"] != P13_PP_CLASSES // 2 \
                        or not held["peak_gb"] < a["peak_gb"]:
                    raise AssertionError(
                        f"{name} rank {s}: layers {held['layers']}, "
                        f"{held['layer_tensors']} layer tensors, "
                        f"{held['head_rows_on_rank']} classes, peak "
                        f"{held['peak_gb']} GB against one rank's "
                        f"{a['peak_gb']}")
            out[name] = {"ranks": ranks, "loss_rel_err": err}
        # the kernel on one rank's class block, alone, beside its bound and
        # SGEMM of the same product
        out["arcface_block"] = recipe_head(
            dev, "tensor-parallel block, B=256", P13_BATCH,
            P13_CLASSES // 4, 1024, 0.4)
        out["arcface_block_pp"] = recipe_head(
            dev, "pipeline-parallel block, B=256", P13_BATCH,
            P13_PP_CLASSES // 2, 1024, 0.4)
        out["spawn_wall_s"] = wall
        out["gloo_times"] = ("the gloo ranks share one card and their "
                             "collectives stage through the host: not a "
                             "scaling number")
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=None, metavar="N,M",
                        help="run only these phases (a rehearsal: no "
                             "kernels line and no result line)")
    only = parser.parse_args(argv).phases
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    t0 = t0_all = time.perf_counter()
    names = _build.build_all()
    print(json.dumps({"built": names,
                      "build_s": time.perf_counter() - t0}), flush=True)
    for name, log in _build.build_logs.items():
        print(f"[nvcc {name}]\n{log.strip()}", flush=True)

    phase_s = {}

    def run(name, fn, *a):
        t0 = time.perf_counter()
        result = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        print(json.dumps({"phase_wall_s": {name: phase_s[name]}}),
              flush=True)
        return result

    if only:
        for n in only.split(","):
            fn = globals()[f"phase{int(n)}"]
            args = (dev, 0.05) if int(n) == 4 else (dev,)
            print(json.dumps({f"phase{n}": run(f"phase{n}", fn, *args)},
                             default=str), flush=True)
        print(json.dumps({"phase_s": phase_s}), flush=True)
        return
    p1 = run("phase1", phase1, dev)
    print(json.dumps({"phase1": p1["cases"]}), flush=True)
    print(json.dumps({"phase1_select": p1["select"]["cases"]}), flush=True)
    p2 = run("phase2", phase2, dev)
    print(json.dumps({"phase2": p2}), flush=True)
    p3 = run("phase3", phase3, dev)
    print(json.dumps({"phase3": p3}), flush=True)
    p4 = run("phase4", phase4, dev, p3["main"]["ms"])
    print(json.dumps({"phase4": p4}), flush=True)
    p5 = run("phase5", phase5, dev)
    print(json.dumps({"phase5": p5}), flush=True)
    p6 = run("phase6", phase6, dev)
    print(json.dumps({"phase6": p6}), flush=True)
    p7 = run("phase7", phase7, dev)
    print(json.dumps({"phase7": p7}), flush=True)
    p8 = run("phase8", phase8, dev)
    print(json.dumps({"phase8": p8}), flush=True)
    p9 = run("phase9", phase9, dev)
    print(json.dumps({"phase9": p9}), flush=True)
    p10 = run("phase10", phase10, dev)
    print(json.dumps({"phase10": p10}), flush=True)
    p11 = run("phase11", phase11, dev)
    print(json.dumps({"phase11": p11}), flush=True)
    p12 = run("phase12", phase12, dev)
    print(json.dumps({"phase12": p12}), flush=True)
    p13 = run("phase13", phase13, dev)
    print(json.dumps({"phase13": p13}), flush=True)
    print(json.dumps({"phase_s": phase_s,
                      "total_s": time.perf_counter() - t0_all}), flush=True)
    cli_launches = p10["launches"]
    m = p1["main"]
    case = {c["case"]: c for c in p1["cases"]}
    sv = case["serving_ip_k13"]
    image_paths = {}
    for name in ("cv_serving_ip_k13", "mm_serving_l2_k13", "mm_job_l2_k13",
                 "daodian_v1_cv_ip_k26", "fasttext_serving_ip_k100"):
        c = case[name]
        tag = name.rsplit("_", 2)[0]
        image_paths.update({f"{tag}_ms": c["ms"], f"{tag}_plain_ms":
                            c["plain_ms"], f"{tag}_bound_ms": c["bound_ms"],
                            f"{tag}_bound_by": c["bound_by"],
                            f"{tag}_library_ms": c["library_ms"],
                            f"{tag}_shape": {k: c[k] for k in (
                                "q", "n", "true_n", "d", "k", "metric")}})
    topk = {"name": "topk", "route": "cuda",
            "source": "multimodalsimilar_tpu_torch/csrc/topk.cu",
            "replaces": "multimodalsimilar_tpu/ops/topk.py:56",
            "launches": p2["topk_launches"],
            "launches_serving": p5["topk_launches"],
            "launches_cv": p6["topk_launches"],
            "launches_multimodal": p7["topk_launches"],
            "launches_mm_job": p7["job_topk_launches"],
            "max_abs_err": p1["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "library_call": TOPK_LIBRARY,
            "cuda_core_bound_ms": m["cuda_core_bound_ms"],
            "shape": {k: m[k] for k in ("q", "n", "d", "k", "metric")},
            "serving_ms": sv["ms"], "serving_bound_ms": sv["bound_ms"],
            "serving_library_ms": sv["library_ms"],
            "serving_shape": {k: sv[k] for k in ("q", "n", "d", "k")},
            **image_paths}
    a = p3["main"]
    arcface = {"name": "arcface", "route": "cuda",
               "source": "multimodalsimilar_tpu_torch/csrc/arcface.cu",
               "replaces": "multimodalsimilar_tpu/ops/arcface.py:143",
               "launches": p4["arcface_launches"],
               "max_abs_err": p3["max_abs_err"],
               "ms": a["ms"], "plain_ms": a["plain_ms"],
               "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
               "library_ms": None,
               "cuda_core_bound_ms": a["cuda_core_bound_ms"],
               "yardstick_ms": a["yardstick_ms"],
               "yardstick": "torch.matmul(x_hat, W_hat.T) on inputs "
                            "normalized beforehand, product only (cuBLAS "
                            "SGEMM, TF32 off); no PyTorch call computes "
                            "the whole function",
               "backward_plain_ms": a["backward_plain_ms"],
               "shape": {"b": AF_B, "c": AF_C, "d": AF_D, "m": 0.4,
                         "s": 64.0},
               "launches_cv": p9["cv_daodian"]["arcface_launches"],
               "launches_cv_timm": p9["cv_timm"]["arcface_launches"],
               "launches_multilabel": p9["multilabel"]["arcface_launches"],
               "launches_multimodal": p9["multimodal"]["arcface_launches"],
               "recipe_shapes": [{k: h[k] for k in (
                   "head", "b", "c", "d", "m", "max_abs_err", "ms",
                   "plain_ms", "yardstick_ms", "bound_ms", "bound_by")}
                   for h in p3["recipe_heads"]]}
    sel = p1["select"]
    sm = sel["main"]
    extra = {}
    for c in sel["cases"]:
        if "ms" in c and c is not sm:
            extra[c["case"]] = {key: c[key] for key in (
                "q", "n", "d", "k", "metric", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
    topk_select = {
        "name": "topk_select", "route": "cuda",
        "source": "multimodalsimilar_tpu_torch/csrc/topk_select.cu",
        "replaces": "multimodalsimilar_tpu/retrieval/knn.py:483 (XLA "
                    "_scan_topk, the large-k route beside "
                    "multimodalsimilar_tpu/ops/topk.py:56)",
        "launches": p8["v2_job"]["topk_select_launches"],
        "launches_v1_job": p8["v1_job"]["topk_select_launches"],
        "launches_daemon_adhoc": p8["daemon"]["adhoc_topk_select_launches"],
        "max_abs_err": sel["max_abs_err"],
        "ms": sm["ms"], "plain_ms": sm["plain_ms"],
        "bound_ms": sm["bound_ms"], "bound_by": sm["bound_by"],
        "library_ms": sm["library_ms"], "library_call": SELECT_LIBRARY,
        "shape": {key: sm[key] for key in ("q", "n", "d", "k", "metric")},
        "other_shapes": extra}
    topk["launches_cli"] = (cli_launches["similar_nlp"]["topk"]
                            + cli_launches["similar_multimodal"]["topk"])
    arcface["launches_cli"] = (cli_launches["train_nlp"]["arcface"]
                               + cli_launches["eval"]["arcface"])
    topk_select["launches_cli"] = \
        cli_launches["similar_daodian"]["topk_select"]
    topk["launches_daodian_v1_cv"] = p8["v1_job"]["topk_launches"]
    topk["launches_fasttext_serve"] = p8["fasttext_serve"]["topk_launches"]
    topk["launches_vit_serving"] = p11["vit_serving"]["topk_launches"]
    topk["launches_int8_similar_nlp"] = \
        p11["int8"]["similar_nlp"]["int8"]["topk_launches"]
    topk["launches_int8_serving"] = p11["int8"]["serve"]["topk_launches"]
    arcface["launches_cv_convnext"] = \
        p11["train"]["convnext"]["arcface_launches"]
    arcface["launches_cv_vit"] = p11["train"]["vit"]["arcface_launches"]
    gloo = p12["gloo_on_one_card"]
    # phase 12: launches on each rank of the two-rank run (gloo, one card)
    arcface["launches_model_parallel"] = [
        r["train"]["model_parallel"]["arcface_launches"] for r in gloo]
    arcface["launches_data_parallel"] = {
        name: [r["train"][name]["arcface_launches"] for r in gloo]
        for name in ("f32", "bf16")}
    arcface["launches_nccl"] = [r["train"]["f32"]["arcface_launches"]
                                for r in p12["nccl"]]
    topk["launches_sharded_search"] = [r["search"]["ip"]["topk_launches"]
                                       for r in gloo]
    topk["launches_sharded_similar_nlp"] = [
        r["similar"]["topk_launches"] for r in gloo]
    topk["sharded_search_shard"] = p12["search_shard"]
    if p12["nccl_every_card"]:
        arcface["launches_nccl_every_card"] = [
            r["train"]["f32"]["arcface_launches"]
            for r in p12["nccl_every_card"]]
    # phase 12 (e): the sharded daemon's and daodian job's launches on
    # each rank of the two-rank run, and their per-rank blocks timed alone
    topk["launches_sharded_serving"] = [r["serve"]["topk_launches"]
                                        for r in gloo]
    topk["launches_serving_one_rank"] = [r["serve"]["topk_launches"]
                                         for r in p12["nccl"]]
    topk["launches_sharded_daodian"] = [r["daodian"]["topk_launches"]
                                        for r in gloo]
    topk["sharded_serving_blocks"] = p12["serve_blocks"]
    topk_select["launches_sharded_daodian"] = [
        r["daodian"]["topk_select_launches"] for r in gloo]
    # phase 12 (f), (g): train cv over ranks through the ArcFace kernel
    # (class blocks under --model_parallel 2), and the two-rank similar
    # multimodal job's search through the top-k kernel's l2 path
    arcface["launches_cv_over_ranks"] = {
        name: [r["train_cv"][name]["arcface_launches"] for r in gloo]
        for name in gloo[0]["train_cv"]}
    arcface["cv_model_parallel_shape"] = {k: p12["arcface_cv_block"][k]
                                          for k in (
        "head", "b", "c", "d", "m", "max_abs_err", "ms", "plain_ms",
        "yardstick_ms", "bound_ms", "bound_by")}
    topk["launches_sharded_similar_multimodal"] = [
        r["similar_multimodal"]["topk_launches"] for r in gloo]
    topk["sharded_mm_job_blocks"] = p12["mm_job_blocks"]
    topk["image_http_launches"] = {
        "cv": p6["image_http"]["topk_launches"],
        "multimodal": p7["image_http"]["topk_launches"]}
    topk["image_http_blocks"] = {"cv": p6["image_http"]["blocks"],
                                 "multimodal": p7["image_http"]["blocks"]}
    topk_select["sharded_daodian_blocks"] = p12["daodian_blocks"]
    # phase 12's checks of the kernels against their plain versions on the
    # sharded paths' blocks, every rank of every run
    runs12 = p12["nccl"] + gloo + (p12["nccl_every_card"] or [])
    shard_checks = [c for r in runs12 for c in [
        r["similar"]["kernel_vs_plain"], r["serve"]["kernel_vs_plain"],
        r["similar_multimodal"]["kernel_vs_plain"]] + [
            r["search"][m]["kernel_vs_plain"] for m in ("ip", "l2")]]
    topk_select["max_abs_err"] = max(
        [topk_select["max_abs_err"]]
        + [r["daodian"]["kernel_vs_plain"]["max_abs_err"] for r in runs12])
    topk["sharded_blocks_max_abs_err"] = max(c["max_abs_err"]
                                             for c in shard_checks)
    topk["max_abs_err"] = max(topk["max_abs_err"],
                              topk["sharded_blocks_max_abs_err"])
    arcface["model_parallel_shapes"] = [{k: h[k] for k in (
        "head", "b", "c", "d", "m", "max_abs_err", "ms", "plain_ms",
        "yardstick_ms", "bound_ms", "bound_by")}
        for h in p12["arcface_blocks"]]
    # phase 13: each tensor-parallel rank's launches on its class block,
    # the block's check on every rank and the block timed alone
    tp_runs = [r["tp"] for key in ("gloo_on_one_card", "nccl_four_cards")
               if key in p13 for r in p13[key]["ranks"]]
    pp_runs = [r["pp"] for key in ("pp_gloo_on_one_card",
                                   "pp_nccl_two_cards")
               if key in p13 for r in p13[key]["ranks"]]
    arcface["launches_tensor_parallel"] = [
        r["tp"]["arcface_launches"] for r in p13["gloo_on_one_card"]["ranks"]]
    arcface["launches_large_one_rank"] = \
        p13["reference"]["remat"]["arcface_launches"]
    arcface["tensor_parallel_blocks_max_abs_err"] = max(
        r["kernel_vs_plain"]["max_abs_err"] for r in tp_runs)
    arcface["launches_pipeline_parallel"] = [
        r["pp"]["arcface_launches"]
        for r in p13["pp_gloo_on_one_card"]["ranks"]]
    arcface["pipeline_parallel_blocks_max_abs_err"] = max(
        r["kernel_vs_plain"]["max_abs_err"] for r in pp_runs)
    arcface["max_abs_err"] = max(
        arcface["max_abs_err"], arcface["tensor_parallel_blocks_max_abs_err"],
        arcface["pipeline_parallel_blocks_max_abs_err"])
    for key, block in (("tensor_parallel_shape", "arcface_block"),
                       ("pipeline_parallel_shape", "arcface_block_pp")):
        tb = p13[block]
        arcface[key] = {k: tb[k] for k in (
            "head", "b", "c", "d", "m", "max_abs_err", "ms", "plain_ms",
            "yardstick_ms", "bound_ms", "bound_by")}
    print(json.dumps({"kernels": [topk, arcface, topk_select]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
