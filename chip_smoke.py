#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (h2o_kubernetes_tpu_torch): the
scorer-replica serving path (and the multi-tenant replica with the H2O
REST API), binomial GBM training, DRF and multinomial
GBM training, the other GBM distributions, checkpoint continuation, the
train -> export -> registry -> replica loop, XGBoost-hist (pointwise and
LambdaMART ranking), GLM, Exclusive Feature Bundling, GOSS,
out-of-core boosting, DeepLearning, Word2Vec, the Frame from a CSV
file through munging to a GBM's holdout metrics, cross-validated
AutoML with stacked ensembles and grid search, and KMeans, PCA, GLRM,
naive Bayes, isolation forest, CoxPH, the aggregator and target
encoding on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, in order; any failure exits non-zero:

1. device  — require CUDA; print the card (nvidia-smi name, power
   limit) and switch TF32 off for matmuls and cuDNN;
2. build   — compile every CUDA kernel from this checkout's sources, one
   nvcc per source, all started together; print ptxas registers/spills;
3. model   — a seeded full-width binomial GBM (28 features, 20 trees
   grown out to depth 5) as MOJO-v2 artifact bytes, HIGGS-shaped rows
   (normals, ~1% NaN), and margins checked against a float64 numpy
   descent;
4. kernels — shap_tab against its plain torch version at every depth
   group of the serving model, at the rows the serving path hands it
   (the 100,000-row batch, whole, and 1, 127, 128 and 4,096 rows):
   bitwise equal, the launch variant per group (staged / unstaged
   ctab, phi on chip / in device memory), and median times (CUDA
   events, from a flushed L2) against the bound;
5. serve   — the serving main path: start_server on the card, load the
   artifact over REST, POST predictions and contributions requests,
   check them (additivity of contributions against logit(p1)), and
   count the kernel launches the path made;
6. direct  — score_numpy and contrib_numpy on 100,000 rows, warm, as
   rows/s; contrib_numpy must launch shap_tab once per depth group per
   call (the whole batch, unchunked);
7. train   — the training main path: bench.py's workload (1,000,000
   rows, 10 features, GBM ntrees=10 max_depth=5 learn_rate=0.2
   bernoulli) on the card, a warm-up train then five timed ones:
   rows·trees/s at their median (and their spread), train AUC and
   logloss, histogram launches per train;
8. deep    — the same frame at max_depth=10, ntrees=2: the deep levels
   (64, 128 and 256 nodes, B2's) take the histogram kernel's
   partitioned regime (the row partition kernels, then the histogram
   over each tile's sorted rows);
9. hist    — the histogram kernel against its plain version and against
   one index_add_ at every level input the two trains gave it (depth 5:
   levels 0-4, the root at 2 channels, the AUC's 4096 int16 bins; depth
   10: levels 0-9): each cell's distance from the float64 sum, relative
   to the cell's Σ|v|, at most 1e-4, and exactly 0 difference on dyadic
   values; a control (the kernel fed bf16-rounded values) must exceed
   that limit; median times (CUDA events, from a flushed L2) and the
   bound; per train, the kernel's summed time against the summed bound
   over its launches; the row partition kernels against their plain
   version (a stable sort) at the 256-node level, bitwise;
10. parity — one tree grown from dyadic gradients at 1,000,000 rows on
   the card and on the CPU, bitwise equal; a 65,536-row slice trained
   on both, train AUC and logloss within 1e-4;
11. serve trained — score_numpy and contrib_numpy of the trained model
   on 100,000 rows (shap_tab on trees the port grew, one launch per
   group), additivity against logit(p1) ≤ 1e-4, and shap_tab held and
   timed at its groups as in phase 4; model_performance on the
   1,000,000-row frame, whose AUC and threshold table (pr_auc, F1, ...)
   share one histogram-kernel launch on the card;
12. drf — drf_higgs's shape (tools/bench_suite.py:225-232): 1,000,000
   HIGGS-shaped rows, DRF ntrees=10 max_depth=8 seed=1 (64 bins, mtries
   5, sample_rate 0.632: one batched histogram launch per level for all
   10 trees, streamed at the shallow levels, partitioned at the deep
   ones); a first train, five warm ones
   (median and spread, rows·trees/s), train AUC, launches by mode; the
   forests grown on the card and on the CPU from the frame's first
   25,000 rows must be equal bitwise in structure (leaves ≤ 1e-6); the
   1,000,000-row forest serves through score_numpy
   and contrib_numpy, Σφ = p1 ≤ 1e-4, one shap_tab launch per group,
   and shap_tab is held and timed at its groups as in phase 4 (its
   depth-8 group reads ctab through the read-only path);
13. multinomial — gbm_multinomial's shape (tools/bench_suite.py:
   243-265): 500,000 rows x 10 features, 4 classes, GBM ntrees=5
   max_depth=5 learn_rate=0.2; warm trains as rows·classtrees/s, train
   logloss, model_performance (one AUC launch per class); card vs CPU
   train logloss ≤ 1e-4 at 65,536 rows;
14. B3 — the batched kernel against its plain version and one
   index_add_ at every level input the two trains gave it (DRF: levels
   0-7, 10 to 640 tree·nodes, C=2; multinomial: levels 0-4, 4 to 32
   tree·nodes, C=3), held as in phase 9, with the per-train sums; the
   row partition at the DRF's deepest level;
15. distributions — poisson, gamma and tweedie on a positive response
   and laplace, quantile and huber on a heavy-tailed one, derived from
   the bench frame (1,000,000 rows, ntrees=10 max_depth=5
   learn_rate=0.2): a warm-up train and five timed ones each, as
   rows·trees/s at the median (and the spread; a bernoulli train on the
   same frame is timed first as the control), with the histogram
   launches by regime and channel count (C=2 for laplace, quantile and
   huber, C=3 for the others); card vs CPU at 65,536 rows: split
   structure equal up to float64 near-ties, train RMSE within 1e-4;
   B1's two-channel levels 0-4 held as in phase 9 at the inputs the
   huber train gave them, then a bf16 control over all compared levels
   must exceed the limit; huber's δ over 20,000,000 float32 values on
   the card bitwise equal to a numpy transcription of jnp.nanquantile;
16. checkpoint — on the bench frame, 5 trees then a continuation to 10
   on the card: the first 5 trees bitwise the checkpoint's, warm
   continuation time; card vs CPU at 65,536 rows (structure up to
   near-ties, train AUC and logloss within 1e-4); a DRF continuation at
   drf_higgs's shape (5 to 10 trees, B3's batched launches);
17. registry — the phase-7 binomial GBM and the phase-15 poisson GBM
   published into a ModelRegistry on a file root under build/registry,
   pushed (path + sha256) to start_server on the card: predictions over
   REST bitwise equal to score_numpy, the binomial model's contributions
   one shap_tab launch per depth group per request and additive to
   logit(p1) within 1e-4, single-request latencies, a tampered digest
   answered 409, and MojoModel on the fetched bytes within 1e-6 of
   score_numpy on 4,096 rows (relative where a prediction passes 1);
18. xgboost — xgboost_hist's shape (tools/bench_suite.py:234-241): the
   HIGGS frame of phase 12, XGBoost ntrees=10 max_depth=6
   learn_rate=0.2 (reg_lambda 1, min_child_weight 1): a warm-up train
   then five timed ones as rows·trees/s (median and spread), B1 launches
   per train (6 levels a tree and the train AUC); card vs CPU at 65,536
   rows (structure up to float64 near-ties of the regularized gain,
   train AUC and logloss within 1e-4); multi:softprob on phase 13's
   frame (B3, 25 batched launches a train); the model published to a
   ModelRegistry and pushed to start_server: REST predictions bitwise
   score_numpy, contributions one shap_tab launch per depth group,
   MojoModel within 1e-6; then shap_tab held bitwise to its plain
   version at the model's depth groups (as in phase 11) and B1 at the
   six levels and the AUC of the warm-up train (as in phase 9);
19. lambdarank — xgboost_lambdarank's shape (tools/bench_suite.py:
   267-279): tools/datasets.mslr_arrays(200,000, seed=4,
   n_features=20), XGBoost rank:ndcg ntrees=10 max_depth=6: warm
   rows·trees/s and ndcg@10; one round at the trained margins with its
   lambda gradients, its tree and the whole round each timed on its
   own, and the setup and host ndcg@10 outside the rounds; B1 at the
   six levels of one train held as in
   phase 9 (Σ|v| limit, dyadic bitwise, bf16 control), and one
   rank:pairwise train;
20. glm — glm_binomial_irlsm's shape (tools/bench_suite.py:206-222): the
   HIGGS frame, GLM binomial IRLSM λ=0, 50 iterations (epsilons 0):
   warm iterations/s, model_performance's AUC (one B1 launch of 4096
   bins); L_BFGS, COORDINATE_DESCENT, an elastic-net λ (ADMM) and the
   multinomial family (phase 13's frame) once each; card vs CPU
   coefficients at 65,536 rows within 1e-4 of the largest; the exported
   artifact in MojoModel within 1e-6 of score_numpy;
21. efb — gbm_wide_sparse (tools/bench_suite.py:612-687) at 1,000,000
   rows: tools/datasets.wide_sparse_arrays(n_groups=40, group_card=25,
   seed=9), F = 1,005; GBM ntrees=5 max_depth=5 learn_rate=0.2 seed=1
   unbundled (H2O_TPU_EFB=0) then bundled (=1) on the same frame: warm
   train seconds both ways, planning seconds, F -> Fb, binned MB both
   ways, varimp top-3; bundled card vs CPU at 65,536 rows through the
   near-tie walker; DRF ntrees=5 max_depth=8 bundled against unbundled,
   bitwise (its sums are counts); B1 held at the bundled train's levels
   and the unbundled root, B3 at the bundled forest's, B4 at the bundled
   model's depth groups and one contributions call additive to 1e-4;
22. goss — gbm_goss_10m (:689-765): airlines_arrays at 10,000,000 rows,
   GBM ntrees=10 max_depth=5 learn_rate=0.2 unsampled then with
   H2O_TPU_GOSS=1, a = b = 0.1: warm per-tree seconds, histogram rows
   per level (10,000,000 against the 2,500,064 cap), rows dropped (0),
   the train AUC delta (recorded against the suite's 0.002, not gated);
   B1 held at the compacted levels; multi:softprob with GOSS on phase
   13's frame, B3 held at its levels;
23. ooc — gbm_higgs_10m (:790-815): higgs_arrays at 10,000,000 rows,
   GBM ntrees=5 max_depth=6 out of core at the reference's chunk rule
   (9,464,100 rows, 2 chunks) and at 1,048,576 rows (10 chunks), and in
   device memory: warm seconds and rows·trees/s, the upload rate from
   pinned memory against a pageable control, the overlap ratio; a
   gaussian round on an exactly-half response streamed = resident = in
   memory, bitwise; the bernoulli models against in memory through the
   near-tie walker (train AUC within 1e-4); EFB + out-of-core on phase
   21's frame bitwise to bundled in memory; GOSS + out-of-core
   compacting the in-memory GOSS weights bitwise; one chunked depth-10
   tree (B2's partitioned regime on chunk rows, held at level 9); B1
   held at both chunk grids' levels;
24. deeplearning — deeplearning_mlp (tools/bench_suite.py:282-291):
   higgs_arrays(200,000, seed=2), DeepLearning(hidden=[64, 64],
   epochs=1, seed=1), 6,250 Adam steps of 32 rows: a warm-up and two
   timed trains as rows/s (median and spread), train AUC and logloss
   (past 65,536 rows the AUC's score histogram is B1's: its launches
   counted around that call, B1 held and timed at its input); the
   device events of one step and the device-busy share, from two short
   trains (200 and 400 steps) under torch.profiler; the estimator's
   default width (200, 200) once and an autoencoder (16,), both on the
   first 50,000 rows: anomaly and
   deepfeatures shapes, reconstruction MSE; card vs CPU on 5,000 rows,
   each trained on its own device: train AUC and logloss within 1e-5,
   predictions within 1e-5; the artifact in MojoModel within 1e-5 of
   predict;
25. word2vec — word2vec_skipgram (:293-302): text8_like_tokens(200,000,
   vocab_size=5,000, seed=5), Word2Vec(vec_size=32, epochs=1,
   min_word_freq=2, seed=1): a warm-up and three timed trains as
   tokens/s; one step and its gradient scatter (index_add_) timed on
   their own; find_synonyms; the artifact's word vectors bitwise; card
   vs CPU on 20,000 tokens (embeddings within 1e-4 of the largest); the
   estimator's defaults on a text8-sized corpus (17,005,207 tokens,
   71,290 words) once, as tokens/s;
26. frame — BASELINE config #1 from the file (tools/bench_suite.py's
   ingest_airlines_csv at its on-chip size, :157-158 and :189-203):
   tools/datasets.airlines_csv at 1,000,000 rows (27 columns, 5 enums)
   written under build/frame (kept for phase 29), import_file on the
   card (median of 2) as rows/s, MB/s
   and cells/s with the CSV path taken (pyarrow's reader or the
   pure-Python one), card = CPU bitwise; split_frame, two sorts,
   group_by, merge (a 1,000,000-row left join), impute, table,
   quantile, a filter, asfactor and rbind, each a synchronized median
   of 2 on the card, held against the CPU's (bitwise; the group sums
   within 1e-6 of each group's Σ|x|); GBM ntrees=10 max_depth=5 seed=1
   on the 0.8 split part, model_performance on the 0.2 part: warm train
   s, rows·trees/s, train and holdout AUC and logloss, B1's launches on
   that path, card vs CPU on 25,000 of the train rows (structure up to
   float64 near-ties, holdout AUC within 1e-4), B1 held at the train's
   five levels and its two AUC inputs (train, holdout); save_frame -> load_frame bitwise, export_file ->
   import_file equal to the frame as %g text writes it, and a
   1,000,000-value time column's as_float and to_numpy card = CPU;
27. automl — cross-validation, stacked ensembles, AutoML on its
   pipelined executor and grid search on airlines rows
   (tools/datasets.airlines_arrays, response IsDepDelayed):
   automl_wall_100k (tools/bench_suite.py:428-470: 100,000 rows,
   nfolds=3, GLM and GBM, max_models=2) cold and warm, each step's
   seconds, the scheduler's busy seconds and a profiled run's
   device-busy share; BASELINE config #5 at 1,000,000 rows (cut from
   10,000,000; nfolds 3, not 5; DeepLearning left out): the default
   plan's eleven other steps and both ensembles, the leaderboard, the
   wall, B1/B2/B3 launches by regime (each required), B1 held at
   GBM_1's first fold train's levels and a 333,333-row holdout AUC, B2
   at GBM_5's deepest partitioned level, B3 at DRF_1's levels; card vs
   CPU on the whole default plan (max_models=12: DeepLearning_1 and
   both ensembles included) at 5,000 rows (cut from 20,000: the CPU's
   depth-12 forests take ~110 s a step at any row count), its CPU leg
   a process of its own started before phase 3, whose saved steps the
   phase resumes: fold ids bitwise, the same model ids, the resumed
   CPU leaderboard equal to the leg's (its retrained ensembles within
   1e-4), every GBM/XGBoost main and fold model walked card against
   CPU up to its first tree with a float64 near-tie (every differing
   decision a near-tie; compared leaves' gaps reported), every metric
   of the GLM, DRF, XRT and tie-free boosted
   rows within 1e-4 and their order the same (adjacent rows within
   1e-4 may swap), each card ensemble restacked on the CPU from the
   same base models' holdout predictions within 1e-4, DeepLearning_1's
   gaps reported, and a 2 x 2
   Cartesian GBM grid (nfolds=3) in the same order on both;
28. learners — the eight other learners at tools/torch_learners.py's
   shapes (1,000,000 rows: KMeans k=8, isolation forest 50 trees,
   GLRM k=2 with 5% NaN cells and the aggregator on HIGGS-shaped rows;
   PCA k=3 over every airlines predictor, naive Bayes and target
   encoding of Origin and Dest (k_fold, blending) on airlines rows;
   CoxPH Efron on a seeded survival table of 10 covariates): first and
   warm train s (synchronized median of 3), rows/s (CoxPH: Newton
   iterations/s), each artifact in MojoModel against predict on
   20,000 rows within 1e-6, card vs CPU on each at 100,000 rows at the
   parity tests' tolerances, B1-B4 launches on these paths (none), and
   the airlines columns' rollups card = CPU bitwise in float32 (mean,
   sigma);
29. serving remainder — the multi-tenant replica and the H2O REST
   API through start_server() on the card: four base GBMs of the
   serving model's shape pushed to 100 tenant keys
   (push_many(require=True)), a quarter of their device-state charge as
   H2O_TPU_SCORER_CACHE_BYTES, tools/score_load.run_load_zipf (Zipf 1.1,
   concurrency 6, 16 rows, 10 s: p50/p99, per-decile p99, rows/s, 5xx,
   shed, every /3/Stats sample within the budget), a 5 s explain leg
   (contributions through B4 and promotions), evict -> promote
   bitwise, the storm fair and unfair (tools/score_load._storm_leg,
   its clients in a process of their own; the fair tail's SLO gated;
   the server-side spans of both models' requests), then /3/ImportFiles of phase 26's CSV,
   /3/ModelBuilders/gbm at phase 26's parameters against an in-process
   train on the same frame, the frame predictions route,
   contributions of 1,000 rows, /3/Parse and /3/AutoML at
   automl_wall_100k's shape against the in-process leaderboard,
   /3/Stats and a timed /metrics; B1-B4 launches per leg;
30. fleet — the operator's fleet on the card (tools/bench_suite.py
   config #5d's layout at the serving model's width): three of phase
   29's base GBMs published to a ModelRegistry on s3:// (a local fake
   object store this script starts: persist_cloud on the path) for 120
   tenant keys; a ShardedPool of 3 shards x 1 port pod
   (``python -m h2o_kubernetes_tpu_torch.operator.pod``, each a REST
   replica on the card), the first 8 tenants on every shard, each pod
   under a quarter of the catalog's measured charge; the front-door
   router as a process of its own
   (``python -m h2o_kubernetes_tpu_torch.operator.router --store --pool``)
   off the store's routing table. a. tools/score_load.run_load_zipf
   through the router (Zipf 1.1, concurrency 6, 16 rows, 10 s): rows/s,
   p50/p99, head and tail decile p99, 5xx (gated 0), every pod's
   /3/Stats resident_bytes within its budget; b. the same load straight
   at 3 pods that each hold the whole catalog under the same budget
   (head_p99_ratio against a, the reference's 1.3x line beside it);
   c. 8 tenants, head and tail, through the router: predictions bitwise
   to the in-process card scorer of the same artifact, contributions
   (B4 in the pods, counted through each pod's /3/Kernels) against
   in-process contrib_numpy at the same rows, every pod's build.device
   the card; d. one shard's pod SIGKILLed mid-storm (router-shard-kill's
   gates: no 5xx on the head, no client error, retries token-backed,
   the victim's tenants served again and the pod replaced; the router
   at the reference's settings, its forward timeout 30 s as the load
   generator's; the router's and the pods' routes and requests slower
   than 5 s are reported from their logs); e. profile() around
   one contrib_numpy (the trace names shap_tab), device_memory() and
   cluster_status(), in a process of its own (``--fleet-surfaces``:
   after phases 1-29 this process's profiler sessions record no device
   activity, and profile() raises there);
31. report — one JSON line of kernel records (B4 with its variants,
   B1, B2, B3, each histogram record with the regimes it ran in, and the
   row partition; the launches of phases 15-23 beside each, B1's levels
   including the xgboost_hist, lambdarank, bundled, compacted and chunk
   trains', DeepLearning's AUC and the airlines train's, B4's models
   the XGBoost and the bundled one), one JSON line of phases 24-25's
   learner numbers, one of phase 26's, one of phase 27's and one of
   phase 28's (they add no kernel; phase 27's B1-B3 launches also stand
   in the records), one of phase 29's (its B1-B4 launches per leg also
   stand in the records), one of phase 30's (the pods' B4 launches per
   contributions request stand in B4's record), the card line, and as the last line
   {"ok": true, "device": {...}}.

``--profile`` adds torch.profiler breakdowns of one warm score_numpy,
contrib_numpy, GBM train, DRF train and multinomial train call, of one
train of each family in phase 15 (and of its bernoulli control), and of
one XGBoost, lambdarank (and its lambda gradients) and GLM train, and
of one deeplearning_mlp train.
"""

from __future__ import annotations

import argparse
import atexit
import base64
import io
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and
# non-tensor-core fp32 operations/s
_HBM_BYTES_PER_S = 3.35e12
_FP32_OPS_PER_S = 67e12
# per (row, real path slot) in the TreeSHAP kernel: two compares, the
# NA test, the OR, the pattern bit, and the f32 add into phi
_SHAP_OPS_PER_SLOT = 6
# the serving bench's batch (tools/bench_suite.py:346-349) and the
# number of warm timed calls per median
_ROWS = 100_000
_REPEATS = 5
_L2_FLUSH_BYTES = 128 << 20     # > the H100's 50 MB L2
# bench.py's on-chip training shape (bench.py:134-151) and the row count
# up to which the AUC and the bin edges take their exact paths
_TRAIN_ROWS = 1_000_000
_TRAIN_TREES = 10
_PARITY_ROWS = 65_536
# drf_higgs (tools/bench_suite.py:225-232): DRF on HIGGS, 10 trees of
# depth 8; gbm_multinomial (tools/bench_suite.py:243-265): 500,000 rows,
# 10 features, 4 classes, 5 rounds of depth 5
_DRF_ROWS = 1_000_000
# card vs CPU of the forest on the frame's first rows: the CPU's train
# of all 1,000,000 takes ~110-140 s (25,000 until phase 30 was added)
_DRF_PARITY_ROWS = 10_000
_DRF_TREES = 10
_DRF_DEPTH = 8
_MN_ROWS = 500_000
_MN_TREES = 5
# timed warm trains; the median is reported (5 until phase 30 was added)
_WARM_TRAINS = 3
# xgboost_hist (tools/bench_suite.py:234-241): 10 trees of depth 6 on the
# HIGGS frame; xgboost_lambdarank (:267-279): mslr_arrays(200,000,
# seed=4, n_features=20) with the same trees; requests of this many rows
_XGB_TREES = 10
_XGB_DEPTH = 6
_RANK_ROWS = 200_000
_REQ_ROWS = 4096
# huber's delta is held to jnp.nanquantile's arithmetic at this many
# values, past where torch.nanquantile refuses its input
_HUBER_ROWS = 20_000_000
# gbm_wide_sparse (tools/bench_suite.py:612-687) at the card's rows:
# 1,000,000 x (40 one-hot groups of 25 + 5 dense), 5 trees of depth 5,
# and the forest check's depth; gbm_goss_10m (:689-765): 10,000,000
# airlines rows, 10 trees; gbm_higgs_10m (:790-815): 10,000,000 HIGGS
# rows, 5 trees of depth 6, the small chunk grid and the deep tree; warm
# trains per leg in phases 21-23
_WS_ROWS = 1_000_000
_WS_GROUPS = 40
_WS_CARD = 25
_WS_TREES = 5
_WS_DEPTH = 5
_WS_DRF_DEPTH = 8
_WS_WARM = 2
_GOSS_ROWS = 10_000_000
_GOSS_TREES = 10
_OOC_ROWS = 10_000_000
_OOC_TREES = 5
_OOC_DEPTH = 6
_OOC_SMALL_CHUNK = 1_048_576
_OOC_DEEP = 10
# phase 24, deeplearning_mlp (tools/bench_suite.py:282-291): HIGGS rows
# (seed 2), DeepLearning(hidden=[64, 64], epochs=1, seed=1); card vs CPU
# on its first rows; a short train of each step count gives the
# launches per step; two warm trains (three until phase 29 was added:
# a warm train is 9.5-20 s of host-bound steps), the default width and
# the autoencoder on the first _DL_SIDE_ROWS rows (200,000 until then);
# one warm train since phase 30 was added
_DL_ROWS = 200_000
_DL_HIDDEN = [64, 64]
_DL_WARM = 1
_DL_SIDE_ROWS = 50_000
_DL_PARITY_ROWS = 5_000
_DL_PROBE_STEPS = (200, 400)
# card vs CPU at _DL_PARITY_ROWS: train AUC and logloss, predictions
_DL_METRIC_LIMIT = 1e-5
_DL_PRED_LIMIT = 1e-5
# phase 25, word2vec_skipgram (:293-302): text8_like_tokens(200,000,
# vocab_size=5,000, seed=5), Word2Vec(vec_size=32, epochs=1,
# min_word_freq=2, seed=1); the estimator's defaults on a text8-sized
# corpus (text8: 17,005,207 tokens, 71,290 words of at least 5)
_W2V_TOKENS = 200_000
_W2V_VOCAB = 5_000
_W2V_WARM = 2                   # 3 until phase 30 was added
_W2V_PARITY_TOKENS = 20_000
_TEXT8_TOKENS = 17_005_207
_TEXT8_VOCAB = 71_290
# a histogram cell may be this far from the float64 sum, relative to
# its Σ|v|: above the kernel's float32 rounding at 1,000,000 rows, below
# what bf16-rounded values give
_HIST_REL_LIMIT = 1e-4
# phase 26, the airlines CSV (tools/bench_suite.py's ingest_airlines_csv
# at its on-chip size, :157-158 and :189-203) -> split -> GBM
_FRAME_ROWS = 1_000_000
_FRAME_REPEATS = 3
_FRAME_TREES = 10
_FRAME_DEPTH = 5
_FRAME_WARM = 3
_GROUP_SUM_LIMIT = 1e-6
_HOLDOUT_AUC_LIMIT = 1e-4
_FRAME_PARITY_ROWS = 25_000
# phase 27: AutoML on airlines (tools/datasets.airlines_arrays, response
# IsDepDelayed): automl_wall_100k's run (tools/bench_suite.py:428-470),
# BASELINE config #5 cut from 10,000,000 rows and 5 folds, and card vs
# CPU on the whole default plan at 5,000 rows (cut from 20,000: the
# CPU's depth-12 forests cost ~110 s a step at any row count), the CPU
# leg in a process of its own on _AML_CPU_THREADS threads, its steps
# saved under _AML_LEG_DIR
_AML_WALL_ROWS = 100_000
_AML_ROWS = 1_000_000
_AML_NFOLDS = 3
_AML_PARITY_ROWS = 5_000
_AML_LIMIT = 1e-4
_AML_CPU_THREADS = 3
_AML_LEG_DIR = Path(__file__).resolve().parent / "build" / "automl_cpu"
_AML_LEG_TIMEOUT = 900


# phase 28: the eight other learners (tools/torch_learners.py); card vs
# CPU on the first _LEARNER_PARITY_ROWS rows of each table (100,000 and
# three warm trains until phase 30 was added)
_LEARNER_ROWS = 1_000_000
_LEARNER_PARITY_ROWS = 50_000
_LEARNER_WARM = 2
_LEARNER_MOJO_ROWS = 20_000
_LEARNER_MOJO_LIMIT = 1e-6

# phase 29: the multi-tenant replica at the reference bench's settings
# (tools/bench_suite.py:513-530, tools/score_load.py:814-849): 4 base
# models of the serving model's shape (28 features, 20 trees of depth
# 5, trained on one frame of _SR_TRAIN_ROWS HIGGS-shaped rows) pushed
# to 100 tenant keys, a quarter of their device-state charge as the byte budget, Zipf
# s = 1.1 at concurrency 6 and 16 rows a request for 10 s, an explain
# leg of 4 workers for 5 s, the storm at 6 s a leg; the REST API on
# phase 26's CSV (a GBM at phase 26's parameters) and AutoML at
# automl_wall_100k's shape on its first 100,000 rows
_SR_BASES = 4
_SR_TENANTS = 100
_SR_TRAIN_ROWS = 100_000
_SR_ZIPF_S = 1.1
_SR_CONCURRENCY = 6
_SR_REQ_ROWS = 16
_SR_SWEEP_S = 10.0
_SR_EXPLAIN_WORKERS = 4
_SR_EXPLAIN_S = 5.0
_SR_STORM_S = 6.0
# where the storm's clients run: "process" (one process of their own, as
# a replica's clients do) or "threads" (in this process, beside the
# server; tools/torch_rehearse_phases.py --storm-clients threads)
_SR_STORM_CLIENTS = "process"
_SR_CONTRIB_ROWS = 1_000
_SR_AML_ROWS = 100_000
_SR_GBM_LIMIT = 1e-4

# phase 30: the fleet at config #5d's layout (tools/bench_suite.py:571-603,
# tools/score_load.py:897-970): 120 tenants over 3 of phase 29's base
# models, 3 shards x 1 pod, the first 8 tenants on every shard, a
# quarter of the catalog's charge as each pod's budget, the sweep's
# load for 10 s a leg; the drill's storm runs until its checks end
_FL_TENANTS = 120
_FL_BASES = 3
_FL_SHARDS = 3
_FL_HEAD = 8
_FL_LEG_S = 10.0
_FL_CHECK_KEYS = 4            # head and tail tenants each in leg c
_FL_STARTUP_S = 300.0         # H2O_TPU_POOL_STARTUP_DEADLINE of the pods
_FL_CONVERGE_S = 240.0
_FL_HEAD_P99_LINE = 1.3       # the reference bench's acceptance line

_T0 = time.perf_counter()


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, repeats: int, flush=None, warm: int = 1,
             lead_cycles: int = 0) -> float:
    """Median milliseconds of fn() on the current stream after ``warm``
    untimed calls; with a ``flush`` buffer larger than the L2 cache, that
    buffer is rewritten before each timed call, so fn() finds its inputs
    in device memory. ``lead_cycles`` keeps the card spinning that long
    before the start event, so that the wrapper's host work is done
    before the card reaches it and the time is the kernel's alone."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _host_s(fn, repeats: int) -> float:
    """Median seconds of fn() (which returns host data, so synced)."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _profile(torch, name: str, fn, top: int = 6) -> None:
    """One warm call of fn under torch.profiler: wall time, the device
    time summed over device-side events (kernels and copies on one
    stream, so the busy time), the top of them by device time, and the
    top host-side ops by their own host time (where a host-bound call
    spends its wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):      # profiler start-up, not timed
        torch.ones(1, device="cuda").sum().item()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0
           and e.key != "Activity Buffer Request"]
    dev_us = sum(e.self_device_time_total for e in dev)
    _log(f"[profile] {name}: wall {wall_us / 1e3:.3f} ms (profiled), "
         f"device busy {dev_us / 1e3:.3f} ms = "
         f"{dev_us / wall_us:.1%} of wall")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        _log(f"[profile] {name}:   {e.key[:70]}: "
             f"{e.self_device_time_total / 1e3:.3f} ms over {e.count} "
             "calls")
    host = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:top]:
        _log(f"[profile] {name}:   host {e.key[:64]}: "
             f"{e.self_cpu_time_total / 1e3:.3f} ms own over {e.count} "
             "calls")


def _numpy_margin(arrays: dict, X: np.ndarray, levels: int) -> np.ndarray:
    """float64 numpy descent of a K=1 flat ensemble: the reference the
    device margins are checked against."""
    sf, th = arrays["flat_split_feat"], arrays["flat_thresh"]
    lf, nl = arrays["flat_left"], arrays["flat_na_left"]
    val = arrays["flat_value"]
    em = arrays["enum_mask"].astype(bool)
    Xc = np.where(em[None, :] & (X < 0), np.nan, X)
    rows = np.arange(X.shape[0])
    total = np.zeros(X.shape[0])
    for t in range(sf.shape[0]):
        node = np.zeros(X.shape[0], dtype=np.int64)
        for _ in range(levels):
            f = sf[t][node]
            x = Xc[rows, np.maximum(f, 0)]
            with np.errstate(invalid="ignore"):
                go_r = np.where(np.isnan(x), ~nl[t][node],
                                x >= th[t][node])
            node = np.where(f >= 0, lf[t][node] + go_r, node)
        total += val[t][node]
    return total + float(arrays["init_score"].ravel()[0])


def _post(port: int, path: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _json_rows(X: np.ndarray) -> list:
    return [[None if np.isnan(v) else float(v) for v in row] for row in X]


def _bench_cols(rows: int, seed: int) -> dict:
    """bench.py's training table (bench.py:137-146): 8 normal columns,
    an 8-level enum c1, dep_delay ~ exponential(10), and the label."""
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(8)}
    X["c1"] = np.array(list("abcdefgh"))[rng.integers(0, 8, size=rows)]
    X["dep_delay"] = rng.exponential(10.0, size=rows).astype(np.float32)
    logit = (1.2 * X["x0"] - 0.8 * X["x1"] + 0.05 * X["dep_delay"]
             - 1.0 + rng.normal(scale=0.5, size=rows))
    X["y"] = np.where(logit > 0, "late", "ontime")
    return X


def _higgs_cols(rows: int, seed: int) -> tuple[dict, dict]:
    """HIGGS shape (tools/datasets.py:159-170): 28 standard-normal
    features and a binary response from nonlinear combinations."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 28)).astype(np.float32)
    logit = (0.8 * X[:, 0] - 0.6 * X[:, 1] * X[:, 2]
             + 0.5 * np.abs(X[:, 3]) - 0.4 * (X[:, 4] ** 2)
             + rng.normal(scale=0.7, size=rows))
    cols = {f"f{i}": X[:, i] for i in range(28)}
    cols["y"] = (logit > 0).astype(np.float32)
    return cols, {"y": ["b", "s"]}


def _multinomial_cols(rows: int, seed: int) -> dict:
    """gbm_multinomial's table (tools/bench_suite.py:248-256): 10 normal
    columns, classes a/b by a score's tails, c/d by a third column."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 10)).astype(np.float32)
    score = X[:, 0] + 0.5 * X[:, 1]
    y = np.where(score > 0.6, "a", np.where(
        score < -0.6, "b", np.where(X[:, 2] > 0, "c", "d")))
    cols = {f"f{i}": X[:, i] for i in range(10)}
    cols["y"] = y
    return cols


def _dist_responses(cols: dict, seed: int) -> dict:
    """Responses for the other GBM families, derived from the bench
    frame's columns: ``ypos`` (positive: a log-linear mean times gamma
    noise) and ``yheavy`` (a linear signal plus Student-t(2) noise)."""
    rng = np.random.default_rng(seed + 77)
    rows = cols["x0"].shape[0]
    lin = 0.4 * cols["x0"] - 0.3 * cols["x1"] + 0.01 * cols["dep_delay"]
    return {"ypos": (np.exp(lin) * rng.gamma(2.0, 0.5, rows)
                     ).astype(np.float32),
            "yheavy": (2.0 * lin + rng.standard_t(2, rows)
                       ).astype(np.float32)}


class _LaunchesByC:
    """Counts the histogram kernel's launches by regime and channel
    count (C=2 under unit hess, 3 otherwise) while active: it wraps the
    module's launch (which still counts its own launches)."""

    def __init__(self, hist_op):
        self.op, self.launch, self.n = hist_op, hist_op._launch, {}

    def __enter__(self):
        def launch(binned, rel, vals, out, plan):
            key = f"{plan.regime} C={plan.C}"
            self.n[key] = self.n.get(key, 0) + 1
            return self.launch(binned, rel, vals, out, plan)

        self.op._launch = launch
        return self

    def __exit__(self, *exc):
        self.op._launch = self.launch


def _near_ties(tm, other, frame, y, kw, n_old=0, lam=0.0, rel=1e-6,
               until_tie=False):
    """Walk ``tm``'s trees against ``other``'s (tools/torch_tree_parity:
    a differing decision must be a float64 near-tie within ``rel`` of
    the node's G²/H, or this raises; ``lam`` the gain's reg_lambda;
    ``until_tie`` stops after the first tree with a tie); returns
    (nodes compared, ties, the largest gap of a compared leaf relative
    to its tree's largest |leaf|)."""
    from tools.torch_tree_parity import round_stats, walk

    stats, binned = round_stats(tm, frame, y, kw, n_old=n_old)
    try:
        compared, ties, gaps = walk(tm, other, stats, binned, n_old=n_old,
                                    lam=lam, rel=rel, until_tie=until_tie)
    except AssertionError as e:
        raise RuntimeError(f"a split differs beyond a near-tie: {e}")
    return compared, ties, float(gaps.max()) if gaps.size else 0.0


class _HistRecorder:
    """Keeps the first (binned, rel, vals) the training path hands the
    histogram kernel at each level, and counts the calls per level, so
    the kernel can be compared and timed at exactly those inputs and
    weighted by its launches. A level is keyed (K, n_bins, C, code
    dtype, depth): after the root only left children are histogrammed,
    so depth d >= 1 has max(1, 2**(d-1)) nodes and a one-node call
    right after a root is depth 1. It wraps the batched wrapper (the
    single-tree wrapper is its K=1 call), which still counts its own
    launches."""

    def __init__(self, hist_op):
        self.op, self.kernel, self.seen = hist_op, \
            hist_op.build_histogram_batched, {}
        self.calls, self.last = {}, {}

    def __enter__(self):
        def record(binned, rel, vals, n_nodes, n_bins):
            kind = (rel.shape[0], n_bins, vals.shape[2], binned.dtype)
            if n_nodes > 1:
                depth = n_nodes.bit_length()
            else:
                depth = 1 if self.last.get(kind) == 0 else 0
            self.last[kind] = depth
            key = kind + (depth,)
            self.seen.setdefault(key, (binned, rel, vals, n_nodes))
            self.calls[key] = self.calls.get(key, 0) + 1
            return self.kernel(binned, rel, vals, n_nodes, n_bins)

        self.op.build_histogram_batched = record
        return self

    def __exit__(self, *exc):
        self.op.build_histogram_batched = self.kernel

    def levels(self, K, n_bins, C, dtype):
        """[(depth, inputs, calls)] of one kind, by depth."""
        return sorted((k[4], v, self.calls[k]) for k, v in self.seen.items()
                      if k[:4] == (K, n_bins, C, dtype))


def _hist_compare(torch, hist_op, binned, rel, vals, n, B,
                  repeats: int) -> dict:
    """The histogram kernel (over K trees: rel [K, rows], vals [K, rows,
    C]) against its plain version (general values, then dyadic ones)
    and one index_add_ at these inputs: errors, median CUDA-event times
    and the bound.

    Errors are per cell, relative to the cell's Σ|v|, against the
    float64 sum (the plain version on float64 values). A cell of a
    1,000,000-row root level sums up to ~125,000 rows, and a float32
    running sum of that many equal hessians drifts by up to ~1e-3 of the
    sum, so float32 results are held to the float64 sum, not to each
    other. The control is the kernel fed the values rounded to bf16
    (what a kernel that accumulated in bf16 would at best give); it
    tells nothing where bf16 keeps the values (0/1 weights, DRF's
    integer targets), and is then left out."""
    kern, plain = hist_op.build_histogram_batched, \
        hist_op.histogram_batched_plain
    F, rows = binned.shape
    K, C = rel.shape[0], vals.shape[2]
    before = dict(hist_op.LAUNCHES)
    out_k = kern(binned, rel, vals, n, B)
    ran = {m: c - before[m] for m, c in hist_op.LAUNCHES.items()
           if c != before[m]}
    if list(ran.values()) != [1]:
        raise RuntimeError(f"histogram {K}x{n}x{B}x{C}: one launch "
                           f"expected, counted {ran}")
    out_p = plain(binned, rel, vals, n, B)
    exact = plain(binned, rel, vals.double(), n, B)
    scale = plain(binned, rel, vals.abs().double(), n, B)
    torch.cuda.synchronize()
    if not (torch.isfinite(out_k).all()
            and out_k.shape == (K, n, F, B, C)):
        raise RuntimeError(f"histogram {K}x{n}x{B}x{C}: bad output")
    if bool(((scale == 0) & (out_k != 0)).any()):
        raise RuntimeError(f"histogram {K}x{n}x{B}x{C}: mass in an empty "
                           "cell")

    def rel_err(out):
        return float(((out.double() - exact).abs()
                      / scale.clamp(min=1e-300)).max())
    g = torch.Generator(device=vals.device).manual_seed(K * n * B + C)
    dy = torch.randint(-2, 3, vals.shape, generator=g, device=vals.device
                       ).float() * 0.5
    dy = torch.where(rel[..., None] >= 0, dy, 0.0)
    dyadic_equal = torch.equal(kern(binned, rel, dy, n, B),
                               plain(binned, rel, dy, n, B))
    v16 = vals.bfloat16().float()
    control_rel_err = rel_err(kern(binned, rel, v16, n, B))
    # the library call: one index_add_ into [(K·n+1)·F·B, C] on a flat
    # index computed once (dead rows into the junk node K·n)
    kn = (torch.arange(K, device=rel.device)[:, None] * n + rel).long()
    seg = torch.where(rel >= 0, kn, K * n).reshape(-1)       # [K·rows]
    idx = ((seg[None, :] * F + torch.arange(F, device=seg.device)[:, None])
           * B + binned.long().repeat(1, K)).reshape(-1)
    src = vals.reshape(K * rows, C).repeat(F, 1)
    acc = torch.zeros(((K * n + 1) * F * B, C), device=vals.device)

    def library():
        acc.zero_()
        acc.index_add_(0, idx, src)

    library()
    lib_err = rel_err(acc[: K * n * F * B].view(K, n, F, B, C))
    # a level's codes, rel and vals fit the 50 MB L2 at the smaller
    # shapes: every timing starts from a flushed cache
    flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=vals.device)
    ms = _cuda_ms(torch, lambda: kern(binned, rel, vals, n, B), repeats,
                  flush)
    plain_ms = _cuda_ms(torch, lambda: plain(binned, rel, vals, n, B), 3,
                        flush)
    library_ms = _cuda_ms(torch, library, repeats, flush)
    live = int((rel >= 0).sum())
    nbytes = (F * rows * binned.element_size() + 4 * K * rows
              + 4 * K * C * rows + 4 * K * n * F * B * C)
    ops = F * C * live
    bytes_ms = nbytes / _HBM_BYTES_PER_S * 1e3
    ops_ms = ops / _FP32_OPS_PER_S * 1e3
    return {"K": K, "n_nodes": n, "n_bins": B, "C": C, "F": F,
            "rows": rows, "live_rows": live,
            "codes": str(binned.dtype).split(".")[-1],
            "mode": next(iter(ran)),
            "max_abs_err": float((out_k - out_p).abs().max()),
            "max_rel_err": rel_err(out_k), "plain_rel_err": rel_err(out_p),
            "library_rel_err": lib_err, "dyadic_equal": dyadic_equal,
            "control_rel_err": control_rel_err,
            "bf16_changes_vals": not torch.equal(v16, vals),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def _log_hist(name: str, res: dict, card: str) -> None:
    _log(f"[hist] {name}: {res['mode']} mode, K={res['K']} x "
         f"{res['n_nodes']} nodes x {res['n_bins']} bins x C={res['C']}, "
         f"F={res['F']}, {res['rows']} rows ({res['live_rows']} live "
         f"tree·rows), {res['codes']} codes: kernel {res['ms']:.4f} ms, "
         f"plain {res['plain_ms']:.4f} ms, index_add_ "
         f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by "
         f"{res['bound_by']}; max |kernel - plain| {res['max_abs_err']:.3e}"
         f"; max |x - float64 sum| / cell sum|v|: kernel "
         f"{res['max_rel_err']:.3e}, plain {res['plain_rel_err']:.3e}, "
         f"index_add_ {res['library_rel_err']:.3e}, control (kernel on "
         f"bf16 values) {res['control_rel_err']:.3e}; dyadic bitwise "
         f"{res['dyadic_equal']} [{card}]")
    if res["max_rel_err"] > _HIST_REL_LIMIT or not res["dyadic_equal"]:
        raise RuntimeError(f"histogram kernel disagrees at {name}")


def _partition_compare(torch, hist_op, binned, rel, vals, n, repeats: int,
                       name: str, card: str) -> dict:
    """The row partition kernels (count, scan, scatter) against their
    plain version (a stable sort) at a level's inputs: bitwise equal,
    median times from a flushed L2, and the byte bound (rel and codes
    read once, the live pairs' vals read once; the sorted codes, vals
    and segment starts written once)."""
    F, rows = binned.shape
    K, C = rel.shape[0], vals.shape[2]
    stride = 16 * -(-F * binned.element_size() // 16)
    def kern():
        return hist_op.row_partition(binned, rel, vals, n, stride)

    def plain():
        return hist_op.row_partition_plain(binned, rel, vals, n, stride)

    got, want = kern(), plain()
    live = int(want[0][-1])
    equal = (torch.equal(got[0], want[0]) and torch.equal(got[1][:live],
                                                          want[1])
             and torch.equal(got[2][:live], want[2]))
    flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=vals.device)
    ms = _cuda_ms(torch, kern, repeats, flush)
    plain_ms = _cuda_ms(torch, plain, 3, flush)
    nbytes = (4 * K * rows + F * rows * binned.element_size()
              + live * (4 * C + stride + 4 * C) + 4 * (K * n + 1))
    res = {"K": K, "n_nodes": n, "F": F, "rows": rows, "live_pairs": live,
           "equal": equal, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": nbytes / _HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "max_abs_err": 0.0 if equal else float("nan"), "bytes": nbytes}
    _log(f"[hist] row partition at {name}: K={K} x {n} nodes, F={F}, "
         f"{rows} rows ({live} live pairs): kernels {ms:.4f} ms, plain "
         f"{plain_ms:.4f} ms, bound {res['bound_ms']:.4f} ms by bytes; "
         f"bitwise equal to the plain version {equal} [{card}]")
    if not equal:
        raise RuntimeError(f"the row partition disagrees at {name}")
    return res


def _log_sums(sums: dict, names, card: str) -> None:
    """Per train: its histogram launches, the kernel's time summed over
    them (each level's median times its launches) against the summed
    bound — the launches x gap that orders the kernel work."""
    for name in names:
        calls, ms, bound = sums[name]
        _log(f"[hist] {name} train: {calls} launches per train, kernel "
             f"{ms:.4f} ms against a bound of {bound:.4f} ms (gap "
             f"{ms - bound:.4f} ms) [{card}]")


class _LevelBook:
    """Every level of a train that the histogram kernel was held and
    timed at (``levels``: name -> ``_hist_compare``'s result with its
    ``calls_per_train``), and per train its launches and their summed
    kernel and bound times (``sums``: train -> [launches, ms, bound
    ms])."""

    def __init__(self, torch, hist_op, card: str, repeats: int):
        self.torch, self.hist_op, self.card = torch, hist_op, card
        self.repeats = repeats
        self.levels, self.sums = {}, {}

    def compare(self, train_name, rec, K, B, C, dtype, label, extra=()):
        """Every level of one kind ``rec`` saw (none when ``rec`` is
        None), plus ``extra`` (name, inputs, n_bins, calls) cases, each
        held and timed; the train's calls x times are summed into
        ``sums``."""
        cases = [] if rec is None else [
            (f"{label} level {d}", inp, B, calls)
            for d, inp, calls in rec.levels(K, B, C, dtype)]
        tot = self.sums.setdefault(train_name, [0, 0.0, 0.0])
        for name, (b, r, v, n), nb, calls in cases + list(extra):
            res = _hist_compare(self.torch, self.hist_op, b, r, v, n, nb,
                                self.repeats)
            res["calls_per_train"] = calls
            self.levels[name] = res
            _log_hist(name, res, self.card)
            tot[0] += calls
            tot[1] += calls * res["ms"]
            tot[2] += calls * res["bound_ms"]


def _auc_case(rec, label: str, dtype) -> tuple:
    """The score histogram's launches (4096 bins, ``dtype`` codes) as
    one ``_LevelBook.compare`` extra case, held at the first."""
    lv = rec.levels(1, 4096, 3, dtype)
    return (f"auc ({label})", lv[0][1], 4096, sum(c for _, _, c in lv))


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` rounded once, in numpy: the float64 product
    is exact, the float64 sum is made round-to-odd (TwoSum's exact error
    moves an inexact sum with an even last bit one ulp toward the exact
    value), and a round-to-odd float64 rounds to float32 as the exact
    value would."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    fix = ((s.view(np.int64) & 1) == 0) & (e != 0) & np.isfinite(e)
    return np.where(fix, np.nextafter(s, np.copysign(np.inf, e)),
                    s).astype(np.float32)


def _xla_nanquantile(x: np.ndarray, q: float) -> np.float32:
    """``jnp.nanquantile(x, q)`` of float32 ``x`` as XLA computes it,
    transcribed in numpy with no JAX: a stable sort (NaN last), the live
    count in float32, the position ``q * (count - 1)``, floor/ceil,
    weights ``hw = pos - floor`` and ``lw = 1 - hw`` in float32, and
    XLA's contraction ``fma(hi, hw, lo * lw)`` rounded once."""
    f32 = np.float32
    s = np.sort(x, kind="stable")                   # NaN last
    count = f32(np.count_nonzero(~np.isnan(x)))
    pos = f32(q) * (count - f32(1))
    hw = f32(pos - np.floor(pos))
    lw = f32(1) - hw
    last = count - f32(1)
    lo = s[int(max(min(np.floor(pos), last), 0))]
    hi = s[int(max(min(np.ceil(pos), last), 0))]
    return f32(_fma32(hi, hw, f32(lo * lw)))


def _shap_compare(torch, shap_kernel, model, X: np.ndarray, label: str,
                  card: str) -> dict:
    """shap_tab against its plain version at every depth group of
    ``model``: bitwise equal at the whole batch and at 1, 127, 128 and
    4,096 rows, median times from a flushed L2 at the batch, and the
    bound — the bytes of X and phi (each read or written once) plus the
    tables over 3.35 TB/s, or the _SHAP_OPS_PER_SLOT operations per (row,
    real slot) and one per (row, tree) over 67 TFLOP/s, the larger; per
    group and over all groups."""
    kern, plain = (shap_kernel.flat_shap_tab_kernel,
                   shap_kernel.flat_shap_tab_plain)
    groups, ctabs, _ = model._contrib_prepare()
    em = model._contrib_enum_mask()
    Xd = torch.as_tensor(X, device=model.device)
    rows, F = Xd.shape
    flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=model.device)
    res = {"groups": [], "ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
    bytes_moved, ops = 0, 0
    for gi, (g, ct, sl) in enumerate(zip(groups, ctabs, model._shap_slots)):
        if ct is None:
            raise RuntimeError(f"{label} group {gi} has no pattern table")
        T, L, D = g.feat.shape
        plan = shap_kernel.shap_plan(F, T, L, D, rows)
        equal, d = True, 0.0
        for n in (rows, 1, 127, 128, 4096):
            Xn = Xd[:n]
            out_k = kern(g, ct, Xn, em, slots=sl)
            out_p = plain(g, ct, Xn, em)
            torch.cuda.synchronize()
            if not (out_k.shape == (min(n, rows), F + 1)
                    and torch.isfinite(out_k).all()
                    and torch.isfinite(out_p).all()):
                raise RuntimeError(f"{label} group {gi}: bad output at "
                                   f"{n} rows")
            equal &= torch.equal(out_k, out_p)
            d = max(d, float((out_k - out_p).abs().max()))
        # ten warm calls: the plain version's small launches before this
        # leave the card's clocks low; the wrapper's host work (checks,
        # plan) is hidden behind a spin of ~0.5 ms
        gk = _cuda_ms(torch, lambda: kern(g, ct, Xd, em, slots=sl),
                      _REPEATS * 2, flush, warm=10, lead_cycles=1_000_000)
        gp = _cuda_ms(torch, lambda: plain(g, ct, Xd, em), 2, flush)
        slots = int((g.feat >= 0).sum())
        tab_bytes = sum(t.numel() * t.element_size() for t in
                        (g.feat, g.lo, g.hi, g.na_ok, g.bias, ct))
        g_bytes = rows * (2 * F + 1) * 4 + tab_bytes
        g_ops = rows * (slots * _SHAP_OPS_PER_SLOT + T)
        bytes_moved += g_bytes
        ops += g_ops
        g_bound = max(g_bytes / _HBM_BYTES_PER_S, g_ops / _FP32_OPS_PER_S) \
            * 1e3
        _log(f"[kernels] shap_tab {label} group {gi}: T={T} L={L} D={D} "
             f"real slots={slots}; {plan.variant} (rows/block "
             f"{plan.threads}, {plan.stages} ctab stages, "
             f"{plan.smem_bytes} B shared, {plan.blocks_per_sm} blocks/SM); "
             f"bitwise {equal}; kernel {gk:.4f} ms plain {gp:.4f} ms bound "
             f"{g_bound:.4f} ms = {gk / g_bound:.1f}x [{card}]")
        if not equal:
            raise RuntimeError(f"shap_tab differs from its plain version at "
                               f"{label} group {gi} by {d}")
        res["groups"].append({"T": T, "L": L, "D": D, "variant": plan.variant,
                              "threads": plan.threads, "stages": plan.stages,
                              "ms": gk, "plain_ms": gp, "bound_ms": g_bound})
        res["ms"] += gk
        res["plain_ms"] += gp
        res["max_abs_err"] = max(res["max_abs_err"], d)
    bytes_ms = bytes_moved / _HBM_BYTES_PER_S * 1e3
    ops_ms = ops / _FP32_OPS_PER_S * 1e3
    res.update(rows=rows, bound_ms=max(bytes_ms, ops_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               bytes=bytes_moved, ops=ops,
               variants=sorted({g["variant"] for g in res["groups"]}))
    _log(f"[kernels] shap_tab {label}, all {len(groups)} groups at {rows} "
         f"rows: kernel {res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms; "
         f"bound {res['bound_ms']:.4f} ms by {res['bound_by']} "
         f"({bytes_moved} bytes, {ops} ops) = "
         f"{res['ms'] / res['bound_ms']:.1f}x; variants {res['variants']} "
         f"[{card}]")
    return res


def _warm_trains(fit, n: int) -> tuple[list[float], object]:
    """Wall seconds of n trains (each ends on host data: its metrics)."""
    times, model = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        model = fit()
        times.append(time.perf_counter() - t0)
    return times, model


def _sync_s(torch, fn, repeats: int) -> float:
    """Median wall seconds of fn() up to the end of its device work
    (a synchronize after each call), after one untimed call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _hold_levels(c, train: str, rec, label: str, extra=()) -> dict:
    """B1 at the _XGB_DEPTH levels (256 bins, C=3, uint8 codes) one
    train of phases 18-19 handed it, plus ``extra`` cases, held and
    timed in ``c.book`` as phase 9 holds its own; returns the largest
    error and bf16 control over those levels."""
    book = c.book
    book.compare(train, rec, 1, 256, 3, c.torch.uint8, label, extra)
    held = [k for k in book.levels if k.startswith(f"{label} level")]
    if len(held) != _XGB_DEPTH:
        raise RuntimeError(f"{train}: B1 held at {held}, not its "
                           f"{_XGB_DEPTH} levels")
    _log_sums(book.sums, (train,), c.card)
    err = max(book.levels[k]["max_rel_err"] for k in held)
    ctl = max(book.levels[k]["control_rel_err"] for k in held)
    _log(f"[{train}] B1 at the train's levels: kernel at most {err:.3e} "
         f"of Σ|v| (limit {_HIST_REL_LIMIT:.0e}), bf16 control at most "
         f"{ctl:.3e}")
    return {"levels_max_rel_err": err, "levels_control_max": ctl}


def _phase_xgboost(c) -> dict:
    """18. xgboost: xgboost_hist's train at its shape (B1 at every level
    and the train AUC), card vs CPU at 65,536 rows, multi:softprob on
    gbm_multinomial's frame (B3), the model through the registry to a
    replica (REST bitwise to score_numpy, contributions through B4), then
    B4 held at the model's depth groups and B1 at the train's six levels
    and its AUC, as phases 9 and 11 hold them.
    ``c`` holds main's frames and modules; returns the phase's numbers
    (launches each counted from zero around its own run)."""
    import os
    import shutil

    from h2o_kubernetes_tpu_torch import (Frame, ModelRegistry, MojoModel,
                                          XGBoost)

    torch, hist_op, card = c.torch, c.hist_op, c.card
    hk, bk = hist_op.LAUNCHES, hist_op.BATCHED_LAUNCHES
    kern = c.shap_kernel.flat_shap_tab_kernel
    rows = c.hframe.nrows

    def fit(fr):
        return XGBoost(ntrees=_XGB_TREES, max_depth=_XGB_DEPTH,
                       learn_rate=0.2, seed=1).train(y="y",
                                                     training_frame=fr)

    with _HistRecorder(hist_op) as rec:
        t0 = time.perf_counter()
        fit(c.hframe)                      # warm-up: the frame's bins,
        first_s = time.perf_counter() - t0  # its levels kept
    hist_op.reset_launches()
    times, xgb = _warm_trains(lambda: fit(c.hframe), _WARM_TRAINS)
    launches = dict(hk)
    med = statistics.median(times)
    hist = xgb.scoring_history[-1]
    per_train = _XGB_DEPTH * _XGB_TREES + 1        # levels + the train AUC
    _log(f"[xgboost] XGBoost ntrees={_XGB_TREES} max_depth={_XGB_DEPTH} "
         f"learn_rate=0.2 (reg_lambda 1, min_child_weight 1) on {rows} "
         f"HIGGS rows: first train {first_s:.3f}s; {_WARM_TRAINS} warm "
         f"trains {[round(t, 4) for t in times]} s, median {med:.4f}s (min "
         f"{min(times):.4f}, max {max(times):.4f}) = rows·trees/s "
         f"{rows * _XGB_TREES / med:.0f} at the median; train_auc "
         f"{hist['train_auc']:.6f} train_logloss "
         f"{hist['train_logloss']:.6f}; histogram launches {launches} over "
         f"{_WARM_TRAINS} trains [{card}]")
    if not (0.5 < hist["train_auc"] <= 1
            and sum(launches.values()) == per_train * _WARM_TRAINS):
        raise RuntimeError(f"xgboost: bad metrics {hist} or histogram "
                           f"launches {launches} (want {per_train} a train)")
    if c.profile:
        _profile(torch, "xgboost train", lambda: fit(c.hframe), top=12)
    small = {k: v[:_PARITY_ROWS] for k, v in c.hcols.items()}
    s_card = Frame.from_arrays(small, domains=c.hdom)
    m_card = fit(s_card)
    m_cpu = fit(Frame.from_arrays(small, domains=c.hdom, device="cpu"))
    compared, ties, leaf_gap = _near_ties(m_card, m_cpu, s_card, "y", {},
                                          lam=1.0)
    gaps = {k: abs(m_card.scoring_history[-1][k]
                   - m_cpu.scoring_history[-1][k])
            for k in ("train_auc", "train_logloss")}
    _log(f"[xgboost] card vs CPU at {_PARITY_ROWS} rows: {compared} nodes "
         f"equal, {len(ties)} near-ties {ties}, compared leaves within "
         f"{leaf_gap:.3e} of the tree's largest |leaf|, metric gaps {gaps}")
    if max(gaps.values()) > 1e-4:
        raise RuntimeError("xgboost: card and CPU training disagree")

    def fit_mn(fr):
        return XGBoost(objective="multi:softprob", ntrees=_MN_TREES,
                       max_depth=5, learn_rate=0.2, seed=1).train(
            y="y", training_frame=fr)

    fit_mn(c.mframe)                       # warm-up
    hist_op.reset_launches()
    mn_times, mnx = _warm_trains(lambda: fit_mn(c.mframe), _WARM_TRAINS)
    mn_launches, mn_batched = dict(hk), dict(bk)
    mn_ll = mnx.scoring_history[-1]["train_logloss"]
    K = mnx.nclasses
    _log(f"[xgboost] multi:softprob ntrees={_MN_TREES} max_depth=5 K={K} "
         f"on {c.mframe.nrows} rows: {_WARM_TRAINS} warm trains "
         f"{[round(t, 4) for t in mn_times]} s, median "
         f"{statistics.median(mn_times):.4f}s = rows·classtrees/s "
         f"{c.mframe.nrows * _MN_TREES * K / statistics.median(mn_times):.0f}"
         f"; train_logloss {mn_ll:.6f}; batched histogram launches "
         f"{mn_batched} over {_WARM_TRAINS} trains [{card}]")
    if not (0 < mn_ll < np.log(K)
            and sum(mn_batched.values()) == 5 * _MN_TREES * _WARM_TRAINS
            and mn_launches == mn_batched):
        raise RuntimeError(f"multi:softprob: bad logloss {mn_ll} or "
                           f"launches {mn_launches} / {mn_batched}")

    reg_root = os.path.join("build", "registry", f"smoke-xgb-{os.getpid()}")
    reg = ModelRegistry(reg_root)
    Xq = xgb._design_matrix(c.hframe)[:_REQ_ROWS].cpu().numpy()
    body = {"rows": _json_rows(Xq), "columns": list(xgb.feature_names)}
    pos = xgb.response_domain[1]
    n_groups = len(xgb._contrib_prepare()[0])
    c.rest.BATCHER.reset()
    srv = c.start_server(port=0)
    port = srv.server_address[1]
    try:
        v = reg.publish(xgb, "higgs_xgb")
        pushed = reg.push(f"http://127.0.0.1:{port}", "higgs_xgb", v,
                          "higgs_xgb", warm_buckets=[128, _REQ_ROWS])
        code, pr = _post(port, "/3/Predictions/models/higgs_xgb", body)
        c.shap_kernel.reset_launches()
        code2, cr = _post(port,
                          "/3/Predictions/models/higgs_xgb/contributions",
                          body)
        reg_launches = kern.launches
        if code != 200 or code2 != 200:
            raise RuntimeError(f"xgboost REST: {code} {pr} / {code2} {cr}")
        same = np.array_equal(np.asarray(pr[f"p{pos}"], np.float32),
                              xgb.score_numpy(Xq)[:, 1])
        phi = np.asarray(cr["contributions"], np.float64)
        p1 = np.asarray(pr[f"p{pos}"], np.float64)
        add = float(np.abs(phi.sum(axis=1) - np.log(p1 / (1 - p1))).max())
        mm = MojoModel(io.BytesIO(reg.fetch("higgs_xgb", v)))
        mojo_err = float(np.abs(mm.predict(Xq)
                                - xgb.score_numpy(Xq).astype(np.float64)
                                ).max())
    finally:
        srv.shutdown()
        srv.server_close()
        c.rest.BATCHER.stop(timeout=5.0)
        shutil.rmtree(reg_root, ignore_errors=True)
    _log(f"[xgboost] registry: published v{v}, pushed {pushed}; "
         f"{_REQ_ROWS}-row REST predictions bitwise score_numpy {same}; "
         f"contributions additivity {add:.3e}, shap_tab launches "
         f"{reg_launches} for the request over {n_groups} groups; "
         f"MojoModel vs score_numpy {mojo_err:.3e} [{card}]")
    if not (same and add <= 1e-4 and reg_launches == n_groups
            and mojo_err <= 1e-6):
        raise RuntimeError("the pushed XGBoost model served wrong results")
    # B4 at the model's depth groups, B1 at the train's six levels and
    # its AUC
    shap_res = _shap_compare(torch, c.shap_kernel, xgb, Xq, "xgboost", card)
    held = _hold_levels(c, "xgboost_hist", rec, "xgb d6",
                        [_auc_case(rec, "xgb", torch.int16)])
    return {"train_s": times, "median_s": med, "first_s": first_s,
            "rows_trees_per_s": rows * _XGB_TREES / med,
            "launches_per_train": {k: v // _WARM_TRAINS
                                   for k, v in launches.items() if v},
            "train_auc": hist["train_auc"], "parity_nodes": compared,
            "parity_ties": len(ties), "parity_leaf_gap": leaf_gap,
            "parity_metric_gaps": gaps, "softprob_train_s": mn_times,
            "softprob_batched_launches_per_train": {
                k: v // _WARM_TRAINS for k, v in mn_batched.items() if v},
            "registry_shap_launches_per_request": reg_launches,
            "shap": shap_res, **held}


def _phase_lambdarank(c) -> dict:
    """19. lambdarank: xgboost_lambdarank's shape (mslr_arrays(200,000,
    seed=4, n_features=20), rank:ndcg, 10 trees of depth 6): warm
    rows·trees/s, ndcg@10, one round's lambda gradients, tree and whole
    round each timed on its own, the setup and host NDCG outside the
    rounds, one train's B1 levels held as phase 9 holds its own, and one
    rank:pairwise train."""
    from h2o_kubernetes_tpu_torch import Frame, XGBoost
    from h2o_kubernetes_tpu_torch import metrics as M
    from h2o_kubernetes_tpu_torch.models import xgboost as xgb_mod
    from h2o_kubernetes_tpu_torch.models.tree.binning import fused_fit_bins
    from h2o_kubernetes_tpu_torch.models.tree.core import _grow_trees
    from tools.datasets import mslr_arrays

    torch, hist_op, card = c.torch, c.hist_op, c.card
    hk = hist_op.LAUNCHES
    rcols = mslr_arrays(_RANK_ROWS, seed=4, n_features=20)
    rframe = Frame.from_arrays(rcols)
    rows = rframe.nrows

    def fit(objective="rank:ndcg"):
        return XGBoost(ntrees=_XGB_TREES, max_depth=_XGB_DEPTH,
                       objective=objective, seed=1).train(
            y="rel", training_frame=rframe, group_column="qid")

    with _HistRecorder(hist_op) as rec:
        t0 = time.perf_counter()
        fit()                              # warm-up, its levels kept
        first_s = time.perf_counter() - t0
    hist_op.reset_launches()
    times, rk = _warm_trains(fit, _WARM_TRAINS)
    launches = dict(hk)
    med = statistics.median(times)
    ndcg = rk.model_performance(rframe, "rel")["ndcg@10"]
    # one round timed on its own at the trained model's margins, and
    # the train's work outside its rounds: the setup (group layout,
    # bins from the frame's cache, lambda batches) and the host NDCG of
    # its scoring history
    p = rk.params
    qid = rcols["qid"].astype(np.int64)
    yv = rframe.vec("rel").as_float()

    def setup():
        layout = xgb_mod._GroupLayout(qid, rows)
        binned = fused_fit_bins(rframe, rk.feature_names, p.nbins)[1]
        return layout, binned, xgb_mod._RankBatches(layout, yv, min(
            16, layout.n_groups))         # the default ndcg_group_batch

    setup_s = _sync_s(torch, setup, _REPEATS)
    layout, binned, rb = setup()
    tp = xgb_mod._rank_tree_params(p)
    w = torch.ones(rows, device=rframe.device)
    margin = rk._predict_device(rframe).float()
    grad_s = _sync_s(torch, lambda: rb.grads(margin, True), _REPEATS)
    g, h = rb.grads(margin, True)
    tree_s = _sync_s(torch, lambda: _grow_trees(binned, g, h, w, tp),
                     _REPEATS)
    round_s = _sync_s(torch, lambda: xgb_mod._rank_round(
        binned, margin, rb, w, None, tp, True, p.learn_rate, 1.0, 1.0),
        _REPEATS)
    yt = yv.cpu().numpy()
    ndcg_s = _host_s(lambda: M.ndcg(yt, margin.cpu().numpy(), qid, k=10),
                     _REPEATS)
    outside_s = med - _XGB_TREES * round_s
    widths = [bw for _, _, bw in rb.batches]
    _log(f"[lambdarank] rank:ndcg ntrees={_XGB_TREES} max_depth="
         f"{_XGB_DEPTH} on {rows} rows, {layout.n_groups} query groups "
         f"(up to {layout.max_docs} documents), 20 features: first train "
         f"{first_s:.3f}s; {_WARM_TRAINS} warm trains "
         f"{[round(t, 4) for t in times]} s, median {med:.4f}s (min "
         f"{min(times):.4f}, max {max(times):.4f}) = rows·trees/s "
         f"{rows * _XGB_TREES / med:.0f} at the median; ndcg@10 "
         f"{ndcg:.6f} (train history "
         f"{rk.scoring_history[-1]['train_ndcg@10']:.6f}); histogram "
         f"launches {launches} over {_WARM_TRAINS} trains [{card}]")
    _log(f"[lambdarank] one round at the trained margins, each timed on "
         f"its own (median of {_REPEATS}): lambda gradients "
         f"{grad_s * 1e3:.3f} ms ({len(widths)} batches, widths "
         f"{widths[0]}..{widths[-1]}), the tree {tree_s * 1e3:.3f} ms, "
         f"the round {round_s * 1e3:.3f} ms (gradients "
         f"{grad_s / round_s:.1%} of it); outside the rounds: setup "
         f"{setup_s * 1e3:.3f} ms, one host ndcg@10 {ndcg_s * 1e3:.3f} ms; "
         f"train median - {_XGB_TREES} rounds = {outside_s * 1e3:.3f} ms "
         f"[{card}]")
    if not (0 < ndcg <= 1 and sum(launches.values())
            == _XGB_DEPTH * _XGB_TREES * _WARM_TRAINS):
        raise RuntimeError(f"lambdarank: bad ndcg {ndcg} or histogram "
                           f"launches {launches}")
    if c.profile:
        _profile(torch, "lambdarank train", fit, top=12)
        _profile(torch, "lambda gradients", lambda: rb.grads(margin, True))
    t0 = time.perf_counter()
    pw = fit("rank:pairwise")
    pw_s = time.perf_counter() - t0
    pw_ndcg = pw.scoring_history[-1]["train_ndcg@10"]
    _log(f"[lambdarank] rank:pairwise: {pw_s:.3f}s, train ndcg@10 "
         f"{pw_ndcg:.6f} [{card}]")
    if not 0 < pw_ndcg <= 1:
        raise RuntimeError(f"rank:pairwise: bad ndcg {pw_ndcg}")
    # B1 at the six levels of the lambda gradients' train
    held = _hold_levels(c, "lambdarank", rec, "rank d6")
    return {"train_s": times, "median_s": med, "first_s": first_s,
            "rows_trees_per_s": rows * _XGB_TREES / med, "ndcg@10": ndcg,
            "groups": layout.n_groups, "max_docs": layout.max_docs,
            "grad_ms_per_round": grad_s * 1e3,
            "tree_ms_per_round": tree_s * 1e3, "round_ms": round_s * 1e3,
            "grad_share": grad_s / round_s, "setup_ms": setup_s * 1e3,
            "ndcg_host_ms": ndcg_s * 1e3, "outside_rounds_ms": outside_s * 1e3,
            "lambda_batches": len(widths),
            "launches_per_train": {k: v // _WARM_TRAINS
                                   for k, v in launches.items() if v},
            "pairwise_s": pw_s, "pairwise_ndcg@10": pw_ndcg, **held}


def _phase_glm(c) -> dict:
    """20. glm: glm_binomial_irlsm's shape (HIGGS, 1,000,000 rows, IRLSM
    λ = 0, 50 iterations with the epsilons at 0): warm iterations/s and
    the AUC (B1's 4096-bin histogram); L_BFGS, COORDINATE_DESCENT, an
    elastic-net λ (ADMM) and the multinomial family once each; card vs
    CPU coefficients at 65,536 rows; the artifact in MojoModel."""
    from h2o_kubernetes_tpu_torch import GLM, Frame, MojoModel, export_mojo

    torch, hist_op, card = c.torch, c.hist_op, c.card
    hk = hist_op.LAUNCHES
    bench = dict(family="binomial", solver="IRLSM", lambda_=0.0,
                 max_iterations=50, objective_epsilon=0.0, beta_epsilon=0.0,
                 seed=1)
    rows = c.hframe.nrows

    def fit(fr, **kw):
        return GLM(**(kw or bench)).train(y="y", training_frame=fr)

    t0 = time.perf_counter()
    fit(c.hframe)
    first_s = time.perf_counter() - t0
    times, glm = _warm_trains(lambda: fit(c.hframe), _WARM_TRAINS)
    med = statistics.median(times)
    its = glm.n_iterations
    hist_op.reset_launches()
    perf = glm.model_performance(c.hframe, "y")
    perf_launches = dict(hk)
    _log(f"[glm] binomial IRLSM λ=0 on {rows} HIGGS rows, P="
         f"{glm.dinfo.n_expanded}: first train {first_s:.3f}s; "
         f"{_WARM_TRAINS} warm trains {[round(t, 4) for t in times]} s of "
         f"{its} iterations, median {med:.4f}s (min {min(times):.4f}, max "
         f"{max(times):.4f}) = {its / med:.1f} iterations/s at the median; "
         f"residual deviance {glm.residual_deviance:.3f} (null "
         f"{glm.null_deviance:.3f}); model_performance auc "
         f"{perf['auc']:.6f} logloss {perf['logloss']:.6f}, histogram "
         f"launches {perf_launches} [{card}]")
    if not (its == 50 and 0.5 < perf["auc"] <= 1
            and glm.residual_deviance < glm.null_deviance
            and sum(perf_launches.values()) == 1):
        raise RuntimeError("glm: bad iterations, AUC, deviance or AUC "
                           "launches")
    if c.profile:
        _profile(torch, "glm train", lambda: fit(c.hframe), top=12)
    others = {}
    for name, fr, kw in (
            ("L_BFGS", c.hframe, dict(family="binomial", solver="L_BFGS")),
            ("COORDINATE_DESCENT", c.hframe,
             dict(family="binomial", solver="COORDINATE_DESCENT")),
            ("elastic net (ADMM)", c.hframe,
             dict(family="binomial", lambda_=1e-3, alpha=0.5)),
            ("multinomial", c.mframe, dict(family="multinomial"))):
        t0 = time.perf_counter()
        m = fit(fr, **kw)
        secs = time.perf_counter() - t0
        others[name] = {"s": secs, "iterations": m.n_iterations,
                        "residual_deviance": m.residual_deviance,
                        "null_deviance": m.null_deviance}
        _log(f"[glm] {name} on {fr.nrows} rows: {secs:.3f}s, "
             f"{m.n_iterations} iterations, residual deviance "
             f"{m.residual_deviance:.3f} (null {m.null_deviance:.3f}) "
             f"[{card}]")
        if not (np.isfinite(m.residual_deviance)
                and m.residual_deviance < m.null_deviance):
            raise RuntimeError(f"glm {name}: the fit did not improve on "
                               "the null model")
    small = {k: v[:_PARITY_ROWS] for k, v in c.hcols.items()}
    g_card = fit(Frame.from_arrays(small, domains=c.hdom))
    g_cpu = fit(Frame.from_arrays(small, domains=c.hdom, device="cpu"))
    b_cpu = g_cpu.beta.double().numpy()
    coef_rel = float(np.abs(g_card.beta.cpu().double().numpy() - b_cpu
                            ).max() / np.abs(b_cpu).max())
    Xq = glm._design_matrix(c.hframe)[:_REQ_ROWS].cpu().numpy()
    buf = io.BytesIO()
    export_mojo(glm, buf)
    mojo_err = float(np.abs(MojoModel(io.BytesIO(buf.getvalue())).predict(
        Xq) - glm.score_numpy(Xq).astype(np.float64)).max())
    _log(f"[glm] card vs CPU at {_PARITY_ROWS} rows: coefficients within "
         f"{coef_rel:.3e} of the largest; the artifact ({len(buf.getvalue())}"
         f" bytes) in MojoModel within {mojo_err:.3e} of score_numpy on "
         f"{_REQ_ROWS} rows")
    if coef_rel > 1e-4 or mojo_err > 1e-6:
        raise RuntimeError("glm: card vs CPU or the artifact disagrees")
    return {"train_s": times, "median_s": med, "first_s": first_s,
            "iterations": its, "iterations_per_s": its / med,
            "auc": perf["auc"], "auc_launches": perf_launches,
            "others": others, "parity_coef_rel": coef_rel,
            "mojo_err": mojo_err}


class _env:
    """Environment variables set for a block and restored after it (the
    training knobs are read at train time)."""

    def __init__(self, **kv):
        self.kv = {k: str(v) for k, v in kv.items()}

    def __enter__(self):
        import os

        self.old = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)
        return self

    def __exit__(self, *exc):
        import os

        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _ChunkRecorder:
    """Keeps the first (binned, rel, vals) an out-of-core train's first
    tree hands the histogram kernel at each level (chunk 0's) and counts
    the calls per level over the whole train: the chunked grower calls
    the kernel once per chunk per level, chunk by chunk, so call i of a
    tree is level (i // n_chunks) % levels."""

    def __init__(self, hist_op, n_chunks: int, levels: int):
        self.op, self.kernel = hist_op, hist_op.build_histogram_batched
        self.n_chunks, self.levels_per_tree = n_chunks, levels
        self.seen, self.calls, self.i = {}, {}, 0

    def __enter__(self):
        def record(binned, rel, vals, n_nodes, n_bins):
            if n_bins == 4096:                 # the train AUC's histogram
                return self.kernel(binned, rel, vals, n_nodes, n_bins)
            d = (self.i // self.n_chunks) % self.levels_per_tree
            self.i += 1
            self.seen.setdefault(d, (binned, rel, vals, n_nodes))
            self.calls[d] = self.calls.get(d, 0) + 1
            return self.kernel(binned, rel, vals, n_nodes, n_bins)

        self.op.build_histogram_batched = record
        return self

    def __exit__(self, *exc):
        self.op.build_histogram_batched = self.kernel

    def levels(self, K, n_bins, C, dtype):
        return sorted((d, v, self.calls[d]) for d, v in self.seen.items())


def _masked_equal(torch, a, b) -> bool:
    """Trees bitwise equal, split_feat/split_bin/na_left compared where
    a node splits (elsewhere a bundled argmax leaves another unused
    bin)."""
    isp = a.is_split
    if not torch.equal(isp.cpu(), b.is_split.cpu()):
        return False
    return all(torch.equal(getattr(a, f)[isp].cpu(),
                           getattr(b, f)[b.is_split].cpu())
               for f in ("split_feat", "split_bin", "na_left")) and all(
        torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
        for f in ("value", "gain", "cover"))


def _mirror_walk(a, b) -> tuple[int, int, int]:
    """Walk two stacked forests from each root while their decisions
    agree. Where they differ, both must split on one feature into the
    same two row sets: at another empty bin (children equal: cover and
    leaf value; the walk goes on below) or mirrored (children swapped;
    the subtrees are not compared, a per-node mtries draw follows the
    child's position). Returns (nodes equal, other-bin cuts, mirrored
    ties); raises on any other difference."""
    f = {k: getattr(a, k).cpu().numpy() for k in a._fields}
    g = {k: getattr(b, k).cpu().numpy() for k in b._fields}
    equal = moved = ties = 0
    T, N = f["is_split"].shape
    for t in range(T):
        todo = [0]
        while todo:
            i = todo.pop()
            fa = (f["is_split"][t, i], f["split_feat"][t, i],
                  f["split_bin"][t, i], f["na_left"][t, i])
            fb = (g["is_split"][t, i], g["split_feat"][t, i],
                  g["split_bin"][t, i], g["na_left"][t, i])
            if not fa[0] and not fb[0]:
                equal += int(f["value"][t, i] == g["value"][t, i])
                continue
            lo, hi = 2 * i + 1, 2 * i + 2
            if fa == fb:
                equal += 1
                todo += [lo, hi]
                continue
            same = fa[0] and fb[0] and fa[1] == fb[1]
            if same and all(f[k][t, j] == g[k][t, j] for k in ("cover",
                            "value") for j in (lo, hi)):
                moved += 1
                todo += [lo, hi]
                continue
            if not (same and all(f[k][t, lo] == g[k][t, hi]
                                 and f[k][t, hi] == g[k][t, lo]
                                 for k in ("cover", "value"))):
                raise RuntimeError(f"tree {t} node {i}: {fa} against {fb} "
                                   "splits other rows")
            ties += 1
    return equal, moved, ties


def _phase_efb(c) -> dict:
    """21. efb: gbm_wide_sparse (tools/bench_suite.py:612-687) at
    _WS_ROWS rows, F = 1,005 (40 one-hot groups of 25, Zipf-skewed, and
    5 dense columns): GBM unbundled then bundled, warm train seconds,
    the plan and its width; card vs CPU bundled at 65,536 rows; DRF
    bundled against unbundled (counts: bitwise); B1 held at the bundled
    train's levels and the unbundled root, B3 at the bundled forest's
    levels, B4 at the bundled model's depth groups. Returns the phase's
    numbers and keeps the frame in ``c.wframe`` for phase 23."""
    from h2o_kubernetes_tpu_torch import DRF, GBM, Frame
    from h2o_kubernetes_tpu_torch.models.tree import core as tree_core
    from h2o_kubernetes_tpu_torch.models.tree import efb as efb_mod
    from tools.datasets import wide_sparse_arrays

    torch, hist_op, card, book = c.torch, c.hist_op, c.card, c.book
    hk, bk = hist_op.LAUNCHES, hist_op.BATCHED_LAUNCHES
    u8 = torch.uint8
    t0 = time.perf_counter()
    cols, dom = wide_sparse_arrays(_WS_ROWS, n_groups=_WS_GROUPS,
                                   group_card=_WS_CARD, seed=9)
    # exactly half ones: a gaussian round on it has ±0.5 gradients, and
    # every histogram sum is exact (phase 23's EFB + out-of-core check)
    yh = np.zeros(_WS_ROWS, dtype=np.float32)
    yh[np.random.default_rng(9).permutation(_WS_ROWS)[: _WS_ROWS // 2]] = 1
    cols["yh"] = yh
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame = Frame.from_arrays(cols, domains=dom)
    names = [n for n in cols if n not in ("y", "yh")]
    F, rows = len(names), frame.nrows
    small = {k: v[:_PARITY_ROWS].copy() for k, v in cols.items()}
    del cols
    _log(f"[efb] wide sparse frame {rows} rows x {F} features "
         f"({_WS_GROUPS} one-hot groups of {_WS_CARD} + dense) generated "
         f"in {gen_s:.2f}s, on {frame.device} in "
         f"{time.perf_counter() - t0:.2f}s")

    def fit(fr, mode, ooc="0"):
        with _env(H2O_TPU_EFB=mode, H2O_TPU_OOC=ooc):
            return GBM(ntrees=_WS_TREES, max_depth=_WS_DEPTH, learn_rate=0.2,
                       seed=1).train(y="y", training_frame=fr,
                                     ignored_columns=["yh"])

    # both legs in device memory (H2O_TPU_OOC=0): under the default
    # "auto" the unbundled 1,005 MB matrix passes the ~826 MB headroom
    # the budget leaves and streams out of core (the third leg)
    legs = {}
    for mode, ooc, label in (("0", "0", "unbundled"), ("1", "0", "bundled"),
                             ("0", "auto", "unbundled, defaults")):
        plan_s = None
        if mode == "1":
            with _env(H2O_TPU_EFB="1"):
                t0 = time.perf_counter()
                _, plan = efb_mod.fit_plan_cached(frame, names, 256)
                plan_s = time.perf_counter() - t0
        with _HistRecorder(hist_op) as rec:
            t0 = time.perf_counter()
            fit(frame, mode, ooc)
            cold = time.perf_counter() - t0
        hist_op.reset_launches()
        times, m = _warm_trains(lambda: fit(frame, mode, ooc),
                                _WS_WARM if ooc == "0" else 1)
        legs[label] = dict(model=m, rec=rec, cold_s=cold, warm_s=times,
                           median_s=statistics.median(times),
                           launches=dict(hk), plan_s=plan_s,
                           ooc=m.ooc_stats)
    d = legs.pop("unbundled, defaults")
    st = d["ooc"]
    _log(f"[efb] unbundled under the defaults (H2O_TPU_OOC=auto): out of "
         f"core {st is not None}, {st and st['chunks']} chunks of "
         f"{st and st['chunk_rows']} rows; first train {d['cold_s']:.3f}s, "
         f"one more {d['warm_s'][0]:.3f}s (the host chunks are re-binned "
         f"each train); upload {st and st['upload_gb_per_s']} GB/s, overlap "
         f"{st and st['overlap_ratio']} [{card}]")
    if st is None:
        raise RuntimeError("efb: the unbundled frame did not go out of core "
                           "under the defaults")
    del d["rec"]
    Fb = plan.fb
    mb = {"unbundled": rows * F / 2 ** 20, "bundled": rows * Fb / 2 ** 20}
    top = {k: sorted(v["model"].varimp(), key=v["model"].varimp().get)[-3:]
           for k, v in legs.items()}
    aucs = {k: v["model"].scoring_history[-1]["train_auc"]
            for k, v in legs.items()}
    bundles = sum(1 for kind, _ in plan.cols if kind == "bundle")
    u, b = legs["unbundled"], legs["bundled"]
    _log(f"[efb] GBM ntrees={_WS_TREES} max_depth={_WS_DEPTH}: unbundled "
         f"first train {u['cold_s']:.3f}s, {_WS_WARM} warm "
         f"{[round(t, 4) for t in u['warm_s']]} s (median "
         f"{u['median_s']:.4f}s); bundled first train {b['cold_s']:.3f}s "
         f"after planning {b['plan_s']:.3f}s, {_WS_WARM} warm "
         f"{[round(t, 4) for t in b['warm_s']]} s (median "
         f"{b['median_s']:.4f}s) = {u['median_s'] / b['median_s']:.2f}x; "
         f"F {F} -> Fb {Fb} ({bundles} bundles, {plan.conflicts} conflicts, "
         f"{len(plan.demoted)} demoted); binned {mb['unbundled']:.1f} MB -> "
         f"{mb['bundled']:.1f} MB; train_auc {aucs}; varimp top-3 agree "
         f"{top['unbundled'] == top['bundled']}; histogram launches per "
         f"{_WS_WARM} trains: unbundled {u['launches']}, bundled "
         f"{b['launches']} [{card}]")
    want = _WS_WARM * (_WS_DEPTH * _WS_TREES + 1)
    if sum(b["launches"].values()) != want or \
            sum(u["launches"].values()) != want or not 0.5 < aucs[
                "bundled"] <= 1 or abs(aucs["bundled"] - aucs[
                    "unbundled"]) > 1e-3:
        raise RuntimeError(f"efb: launches {u['launches']} / "
                           f"{b['launches']} (want {want}) or AUCs {aucs}")

    sf_card = Frame.from_arrays(small, domains=dom)
    sf_cpu = Frame.from_arrays(small, domains=dom, device="cpu")
    m_card, m_cpu = fit(sf_card, "1"), fit(sf_cpu, "1")
    compared, ties, leaf_gap = _near_ties(m_card, m_cpu, sf_card, "y",
                                          {"ignored_columns": ["yh"]})
    gaps = {k: abs(m_card.scoring_history[-1][k]
                   - m_cpu.scoring_history[-1][k])
            for k in ("train_auc", "train_logloss")}
    # a bundled member's default side is its node's total minus the
    # member's slots, so a small child's sums carry the f32 rounding of
    # the node total, which the card's atomics order differently: the
    # leaves are read, the metrics held (as for the other families)
    _log(f"[efb] bundled card vs CPU at {_PARITY_ROWS} rows: {compared} "
         f"nodes equal, {len(ties)} near-ties {ties}, compared leaves "
         f"within {leaf_gap:.3e} of the tree's largest |leaf|, metric "
         f"gaps {gaps}")
    if max(gaps.values()) > 1e-4:
        raise RuntimeError("efb: card and CPU bundled training disagree")

    def fit_drf(mode):
        with _env(H2O_TPU_EFB=mode):
            return DRF(ntrees=_WS_TREES, max_depth=_WS_DRF_DEPTH,
                       seed=1).train(y="y", training_frame=frame,
                                     ignored_columns=["yh"])

    hist_op.reset_launches()
    with _HistRecorder(hist_op) as rec_drf:
        t0 = time.perf_counter()
        d_b = fit_drf("1")
        drf_b_s = time.perf_counter() - t0
    drf_batched = dict(bk)
    t0 = time.perf_counter()
    d_u = fit_drf("0")
    drf_u_s = time.perf_counter() - t0
    # a bundle's candidates are its members' used slots, so where the
    # unbundled argmax picks "NA alone left" (a cut at an empty bin
    # below the default), the bundled one picks its mirror "every body
    # bin left, NA right": the same partition, children swapped (the
    # JAX package's EFB does the same). Below it the per-node mtries
    # draws follow the swapped positions, so the walk stops there.
    drf_same = _masked_equal(torch, d_b.trees, d_u.trees)
    drf_equal, drf_moved, mirrored = _mirror_walk(d_b.trees, d_u.trees)
    G = tree_core.drf_group_size(_WS_TREES, tree_core.TreeParams(
        max_depth=_WS_DRF_DEPTH, n_bins=64, unit_hess=True), Fb)[0]
    _log(f"[efb] DRF ntrees={_WS_TREES} max_depth={_WS_DRF_DEPTH} "
         f"mtries={d_b.params.mtries}: bundled {drf_b_s:.3f}s (G={G} trees "
         f"per launch, batched launches {drf_batched}), unbundled "
         f"{drf_u_s:.3f}s; bundled against unbundled: trees bitwise "
         f"{drf_same}; {drf_equal} nodes equal from the roots, "
         f"{drf_moved} the same rows at another empty bin, {mirrored} "
         f"mirrored (same rows, children swapped), no other difference "
         f"({int(d_b.trees.is_split.sum())} splits) "
         f"[{card}]")

    book.compare("efb gbm", b["rec"], 1, 256, 3, u8, "efb d5")
    (_, root, calls), = [lv for lv in u["rec"].levels(1, 256, 3, u8)
                         if lv[0] == 0]
    book.compare("wide gbm root", None, 1, 256, 3, u8, "wide d5",
                 [("wide d5 level 0", root, 256, calls)])
    book.compare("efb drf", rec_drf, G, 64, 2, u8, "efb drf")
    _log_sums(book.sums, ("efb gbm", "wide gbm root", "efb drf"), card)
    del root, u["rec"], b["rec"], rec_drf
    torch.cuda.empty_cache()

    mb_ = b["model"]
    X = mb_._design_matrix(frame)[:_ROWS].cpu().numpy()
    kern = c.shap_kernel.flat_shap_tab_kernel
    before = kern.launches
    p1 = mb_.score_numpy(X)[:, 1].astype(np.float64)
    phi = mb_.contrib_numpy(X)
    shap_launches = kern.launches - before
    add = float(np.abs(phi.astype(np.float64).sum(axis=1)
                       - np.log(p1 / (1.0 - p1))).max())
    shap = _shap_compare(torch, c.shap_kernel, mb_, X, "efb gbm", card)
    # the [rows, F+1] outputs at F = 1,005 cap a dispatch's rows
    per = mb_._contrib_dispatch()[0]
    n_disp = -(-X.shape[0] // per)
    _log(f"[efb] serve the bundled model: {X.shape[0]} rows x {F} "
         f"features, additivity max |sum(phi) - logit(p1)| = {add:.3e}, "
         f"shap_tab launches {shap_launches} over "
         f"{len(shap['groups'])} groups in {n_disp} dispatches of at most "
         f"{per} rows [{card}]")
    if add > 1e-4 or shap_launches != n_disp * len(shap["groups"]) or \
            phi.shape != (X.shape[0], F + 1):
        raise RuntimeError("efb: serving the bundled model failed")
    c.wframe, c.wnames = frame, names
    return {"rows": rows, "features": F, "bundled_width": Fb,
            "bundles": bundles, "conflicts": plan.conflicts,
            "demoted": len(plan.demoted), "plan_s": b["plan_s"],
            "binned_mb": mb, "cold_s": {k: v["cold_s"]
                                        for k, v in legs.items()},
            "warm_train_s": {k: v["warm_s"] for k, v in legs.items()},
            "launches_per_train": {k: {r: n // _WS_WARM for r, n in
                                       v["launches"].items()}
                                   for k, v in legs.items()},
            "train_auc": aucs,
            "unbundled_defaults": {"cold_s": d["cold_s"],
                                   "train_s": d["warm_s"], "ooc": st},
            "varimp_top3_agree": top["unbundled"] == top["bundled"],
            "parity_nodes": compared, "parity_ties": len(ties),
            "parity_leaf_gap": leaf_gap, "parity_metric_gaps": gaps,
            "drf_s": {"bundled": drf_b_s, "unbundled": drf_u_s},
            "drf_trees_bitwise": drf_same, "drf_nodes_equal": drf_equal,
            "drf_other_bin_cuts": drf_moved, "drf_mirrored_ties": mirrored,
            "drf_batched_launches": drf_batched, "drf_group": G,
            "shap_launches_per_contrib_call": shap_launches,
            "additivity": add, "shap": shap}


def _phase_goss(c) -> dict:
    """22. goss: gbm_goss_10m (tools/bench_suite.py:689-765):
    airlines_arrays at _GOSS_ROWS rows (2,000,000-row chunks, seeds
    10+k, as airlines_frame builds it), GBM ntrees=10 max_depth=5
    learn_rate=0.2 unsampled then with GOSS a = b = 0.1: warm per-tree
    seconds, the histogram rows per level, the rows dropped, the train
    AUC delta (recorded); B1 held at the compacted levels;
    multi:softprob with GOSS on phase 13's frame (B3 held at its
    levels)."""
    from h2o_kubernetes_tpu_torch import GBM, Frame, XGBoost
    from h2o_kubernetes_tpu_torch.models.tree import core as tree_core
    from h2o_kubernetes_tpu_torch.models.tree.core import goss_cap_rows
    from h2o_kubernetes_tpu_torch.runtime import prng
    from tools.datasets import _chunked_arrays, airlines_arrays

    torch, hist_op, card, book = c.torch, c.hist_op, c.card, c.book
    hk, bk = hist_op.LAUNCHES, hist_op.BATCHED_LAUNCHES
    u8 = torch.uint8
    t0 = time.perf_counter()
    cols, dom = _chunked_arrays(airlines_arrays, _GOSS_ROWS, 2_000_000,
                                seed=10)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame = Frame.from_arrays(cols, domains=dom)
    rows, F = frame.nrows, len(cols) - 1
    del cols
    _log(f"[goss] airlines frame {rows} rows x {F} features generated in "
         f"{gen_s:.2f}s, on {frame.device} in "
         f"{time.perf_counter() - t0:.2f}s")
    knobs = dict(H2O_TPU_GOSS_TOP_A="0.1", H2O_TPU_GOSS_RAND_B="0.1")

    def fit(on):
        with _env(H2O_TPU_GOSS="1" if on else "0", **knobs):
            return GBM(ntrees=_GOSS_TREES, max_depth=5, learn_rate=0.2,
                       seed=1).train(y="IsDepDelayed", training_frame=frame)

    legs = {}
    for on, label in ((False, "unsampled"), (True, "goss")):
        with _HistRecorder(hist_op) as rec:
            t0 = time.perf_counter()
            fit(on)
            cold = time.perf_counter() - t0
        hist_op.reset_launches()
        times, m = _warm_trains(lambda: fit(on), _WS_WARM)
        legs[label] = dict(model=m, rec=rec, cold_s=cold, warm_s=times,
                           per_tree_s=statistics.median(times)
                           / _GOSS_TREES, launches=dict(hk),
                           auc=m.scoring_history[-1]["train_auc"])
    cap = goss_cap_rows(rows, 0.1, 0.1)
    lv_rows = {k: sorted({v[0].shape[1] for _, v, _ in
                          legs[k]["rec"].levels(1, 256, 3, u8)})
               for k in legs}
    g, un = legs["goss"], legs["unsampled"]
    dropped = g["model"].goss_dropped
    delta = abs(g["auc"] - un["auc"])
    _log(f"[goss] GBM ntrees={_GOSS_TREES} max_depth=5 at {rows} rows: "
         f"unsampled first {un['cold_s']:.3f}s, warm "
         f"{[round(t, 4) for t in un['warm_s']]} s = "
         f"{un['per_tree_s']:.4f} s/tree; GOSS a=b=0.1 first "
         f"{g['cold_s']:.3f}s, warm {[round(t, 4) for t in g['warm_s']]} s "
         f"= {g['per_tree_s']:.4f} s/tree "
         f"({un['per_tree_s'] / g['per_tree_s']:.2f}x); histogram rows per "
         f"level {lv_rows} (cap {cap}); dropped {dropped}; train_auc "
         f"unsampled {un['auc']:.6f} GOSS {g['auc']:.6f}, delta "
         f"{delta:.6f} (the suite's acceptance 0.002, recorded); launches "
         f"per {_WS_WARM} trains {g['launches']} [{card}]")
    if dropped != 0 or lv_rows["goss"] != [cap] or \
            lv_rows["unsampled"] != [rows] or \
            sum(g["launches"].values()) != _WS_WARM * (5 * _GOSS_TREES + 1):
        raise RuntimeError(f"goss: dropped {dropped}, level rows {lv_rows}, "
                           f"launches {g['launches']}")
    book.compare("goss gbm", g["rec"], 1, 256, 3, u8, "goss d5")
    del un["rec"], g["rec"]
    # a round's GOSS work on its own, each synced: the amplified weights
    # (the global stats and two threefry draws a row), the compaction,
    # and the full-row re-descent of the grown tree
    binned = frame.binned(g["model"].bin_spec)
    gen = torch.Generator(device=binned.device).manual_seed(0)
    gr = torch.randn(rows, device=binned.device, generator=gen)
    ones = torch.ones_like(gr)
    bp = tree_core.BoostParams(goss_a=0.1, goss_b=0.1)
    kg = tree_core.goss_round_keys(prng.key(1, binned.device), 1)[0]
    w_amp = tree_core.goss_amplified_w(gr, ones, kg, bp)
    tree0 = tree_core.Tree(*(a[:1] for a in g["model"].trees))
    part_ms = {
        "amplified_w": _sync_s(torch, lambda: tree_core.goss_amplified_w(
            gr, ones, kg, bp), 3) * 1e3,
        "compact": _sync_s(torch, lambda: tree_core.goss_compact(
            binned, gr, ones, w_amp, cap), 3) * 1e3,
        "redescent": _sync_s(torch, lambda: tree_core.descend_trees(
            tree0, binned, 5, 256), 3) * 1e3}
    _log(f"[goss] one round's GOSS work at {rows} rows, each alone: "
         f"{ {k: round(v, 3) for k, v in part_ms.items()} } ms, against "
         f"{(g['per_tree_s'] - un['per_tree_s']) * 1e3:.3f} ms a tree "
         f"more than unsampled [{card}]")
    del binned, gr, ones, w_amp

    def fit_sp():
        with _env(H2O_TPU_GOSS="1", **knobs):
            return XGBoost(objective="multi:softprob", ntrees=_MN_TREES,
                           max_depth=5, learn_rate=0.2, seed=1).train(
                y="y", training_frame=c.mframe)

    hist_op.reset_launches()
    with _HistRecorder(hist_op) as rec_sp:
        t0 = time.perf_counter()
        sp = fit_sp()
        sp_s = time.perf_counter() - t0
    sp_batched = dict(bk)
    K = sp.nclasses
    sp_ll = sp.scoring_history[-1]["train_logloss"]
    _log(f"[goss] multi:softprob with GOSS on {c.mframe.nrows} rows, K={K}: "
         f"{sp_s:.3f}s (first train), train_logloss {sp_ll:.6f}, batched "
         f"launches {sp_batched}, dropped {sp.goss_dropped} [{card}]")
    if sum(sp_batched.values()) != 5 * _MN_TREES or sp.goss_dropped != 0 \
            or not 0 < sp_ll < np.log(K):
        raise RuntimeError(f"goss softprob: launches {sp_batched}, "
                           f"logloss {sp_ll}")
    book.compare("goss softprob", rec_sp, K, 256, 3, u8, "goss softprob")
    _log_sums(book.sums, ("goss gbm", "goss softprob"), card)
    del rec_sp, frame
    torch.cuda.empty_cache()
    return {"rows": rows, "features": F, "cap_rows": cap,
            "hist_rows_per_level": lv_rows, "dropped": dropped,
            "cold_s": {k: v["cold_s"] for k, v in legs.items()},
            "warm_train_s": {k: v["warm_s"] for k, v in legs.items()},
            "per_tree_s": {k: v["per_tree_s"] for k, v in legs.items()},
            "train_auc": {k: v["auc"] for k, v in legs.items()},
            "auc_delta": delta,
            "launches_per_train": {k: {r: n // _WS_WARM for r, n in
                                       v["launches"].items()}
                                   for k, v in legs.items()},
            "goss_round_parts_ms": part_ms,
            "softprob_s": sp_s, "softprob_batched_launches": sp_batched}


def _upload_gbs(torch, nbytes: int) -> dict:
    """Host-to-device copy rate of ``nbytes`` from pinned memory (the
    chunk stream's) and from pageable memory (the control), CUDA events
    around each copy, the median of three."""
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = {}
    for label, pin in (("pinned", True), ("pageable", False)):
        src = torch.ones(nbytes, dtype=torch.uint8, pin_memory=pin)
        ms = _cuda_ms(torch, lambda: dst.copy_(src, non_blocking=True), 3)
        out[label] = nbytes / ms / 1e6
    return out


def _phase_ooc(c) -> dict:
    """23. ooc: gbm_higgs_10m (tools/bench_suite.py:790-815):
    higgs_arrays at _OOC_ROWS rows (2,000,000-row chunks, seeds 8+k),
    GBM ntrees=5 max_depth=6 out of core at the reference's chunk rule
    (2 chunks) and at 1,048,576 rows a chunk (10), and in device memory:
    warm seconds, rows·trees/s, the upload rate (pinned, and a pageable
    control) and the overlap ratio; a gaussian round on an exactly-half
    response streamed = resident = in memory, bitwise; the bernoulli
    models against the in-memory one through the near-tie walker, train
    AUC within 1e-4; EFB + out-of-core on phase 21's frame bitwise to
    bundled in memory; GOSS + out-of-core selecting the in-memory GOSS
    rows; one chunked depth-10 tree (B2's partitioned regime on chunk
    rows); B1 held at both chunk grids' levels."""
    from h2o_kubernetes_tpu_torch import GBM, Frame
    from h2o_kubernetes_tpu_torch.models.tree import core as tree_core
    from h2o_kubernetes_tpu_torch.models.tree import ooc as ooc_mod
    from tools.datasets import _chunked_arrays, higgs_arrays

    torch, hist_op, card, book = c.torch, c.hist_op, c.card, c.book
    u8 = torch.uint8
    t0 = time.perf_counter()
    cols, dom = _chunked_arrays(higgs_arrays, _OOC_ROWS, 2_000_000, seed=8)
    rows = cols["y"].shape[0]
    yh = np.zeros(rows, dtype=np.float32)
    yh[np.random.default_rng(8).permutation(rows)[: rows // 2]] = 1.0
    cols["yh"] = yh
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame = Frame.from_arrays(cols, domains=dom)
    F = len(cols) - 2
    del cols, yh
    _log(f"[ooc] HIGGS frame {rows} rows x {F} features generated in "
         f"{gen_s:.2f}s, on {frame.device} in "
         f"{time.perf_counter() - t0:.2f}s; binned matrix "
         f"{rows * F / 1e6:.0f} MB")

    def fit(knobs, y="y", **kw):
        args = dict(ntrees=_OOC_TREES, max_depth=_OOC_DEPTH, seed=1)
        args.update(kw)
        with _env(**knobs):
            return GBM(**args).train(
                y=y, training_frame=frame,
                ignored_columns=[n for n in ("y", "yh") if n != y])

    rule = {"H2O_TPU_OOC": "1"}
    small = {"H2O_TPU_OOC": "1", "H2O_TPU_OOC_CHUNK_ROWS": _OOC_SMALL_CHUNK}
    legs = {}
    for label, knobs in (("ooc rule", rule), ("ooc 1M", small),
                         ("in memory", {"H2O_TPU_OOC": "0"})):
        n_chunks = None
        if label != "in memory":
            tp = tree_core.TreeParams(max_depth=_OOC_DEPTH, n_bins=256)
            with _env(**knobs):
                cr = ooc_mod.chunk_rows_for(rows, F, 2 ** 30,
                                            tree_core.level_hist_bytes(tp, F))
            n_chunks = -(-rows // cr)
            rec = _ChunkRecorder(hist_op, n_chunks, _OOC_DEPTH)
        else:
            cr, rec = None, _HistRecorder(hist_op)
        with rec:
            t0 = time.perf_counter()
            fit(knobs)
            cold = time.perf_counter() - t0
        times, m = _warm_trains(lambda: fit(knobs), _WS_WARM)
        med = statistics.median(times)
        legs[label] = dict(model=m, rec=rec, cold_s=cold, warm_s=times,
                           rate=rows * _OOC_TREES / med, chunk_rows=cr,
                           chunks=n_chunks, stats=m.ooc_stats,
                           auc=m.scoring_history[-1]["train_auc"])
        st = m.ooc_stats
        _log(f"[ooc] {label}: chunk rows {cr} ({n_chunks} chunks); first "
             f"train {cold:.3f}s, warm {[round(t, 4) for t in times]} s = "
             f"{legs[label]['rate']:.0f} rows·trees/s at the median; "
             f"train_auc {legs[label]['auc']:.6f}; stream "
             f"{st if st is None else {k: st[k] for k in ('passes', 'upload_ms', 'compute_ms', 'wall_ms', 'upload_gb_per_s', 'overlap_ratio')}}"
             f" [{card}]")
        if (st is None) != (label == "in memory") or (
                st is not None and (st["chunks"] != n_chunks
                                    or not st["streamed"])):
            raise RuntimeError(f"ooc {label}: the stream did not run as "
                               f"set: {st}")
    up = _upload_gbs(torch, F * legs["ooc 1M"]["chunk_rows"])
    _log(f"[ooc] upload of one {F} x {_OOC_SMALL_CHUNK} chunk: pinned "
         f"{up['pinned']:.2f} GB/s, pageable {up['pageable']:.2f} GB/s "
         f"[{card}]")
    hbm = legs["in memory"]["model"]
    walks = {}
    for label in ("ooc rule", "ooc 1M"):
        m = legs[label]["model"]
        # at 10,000,000 rows a histogram cell sums up to ~10^6 float32
        # values, whose rounding is ~1e-5 of a node's G²/H, and a split's
        # gain is the small difference of three such terms: ties are
        # held at 1e-4 of G²/H (1e-6 at the 65,536-row parity slices)
        compared, ties, leaf_gap = _near_ties(m, hbm, frame, "y",
                                              {"ignored_columns": ["yh"]},
                                              rel=1e-4)
        gap = abs(legs[label]["auc"] - legs["in memory"]["auc"])
        walks[label] = {"nodes": compared, "ties": len(ties),
                        "leaf_gap": leaf_gap, "auc_gap": gap}
        # the card's f32 atomics sum 10,000,000 rows in another order
        # than the chunks' sum of partial sums: leaves are read, the
        # structure and the AUC held
        _log(f"[ooc] {label} vs in memory: {compared} nodes equal, "
             f"{len(ties)} near-ties {ties}, compared leaves within "
             f"{leaf_gap:.3e} of the tree's largest |leaf|, train_auc gap "
             f"{gap:.3e}")
        if gap > 1e-4:
            raise RuntimeError(f"ooc {label}: differs from in memory")

    exact = dict(ntrees=1, distribution="gaussian")
    t_s = fit(small, "yh", **exact).trees
    t_r = fit(dict(small, H2O_TPU_OOC_RESIDENT="1"), "yh", **exact).trees
    t_m = fit({"H2O_TPU_OOC": "0"}, "yh", **exact).trees
    same = [all(torch.equal(a, b) for a, b in zip(t_s, t)) for t in
            (t_r, t_m)]
    def fit_wide(knobs):
        with _env(H2O_TPU_EFB="1", **knobs):
            return GBM(ntrees=1, max_depth=_WS_DEPTH,
                       distribution="gaussian", seed=1).train(
                y="yh", training_frame=c.wframe, ignored_columns=["y"])

    e_ooc = fit_wide({"H2O_TPU_OOC": "1", "H2O_TPU_OOC_CHUNK_ROWS":
                      -(-c.wframe.nrows // 4)})
    e_hbm = fit_wide({"H2O_TPU_OOC": "0"})
    efb_same = all(torch.equal(a, b) for a, b in zip(e_ooc.trees,
                                                     e_hbm.trees))
    seen = {"in memory": [], "ooc": []}
    spies = []
    for mod, key in ((tree_core, "in memory"), (ooc_mod, "ooc")):
        real = mod.goss_compact

        def compact(binned, g, h, w_amp, cap, _real=real, _key=key):
            seen[_key].append(w_amp.clone())
            return _real(binned, g, h, w_amp, cap)
        spies.append((mod, real))
        mod.goss_compact = compact
    try:
        goss = dict(H2O_TPU_GOSS="1", H2O_TPU_GOSS_TOP_A="0.1",
                    H2O_TPU_GOSS_RAND_B="0.1")
        fit(dict(goss, H2O_TPU_OOC="0"), ntrees=1)
        fit(dict(goss, **small), ntrees=1)
    finally:
        for mod, real in spies:
            mod.goss_compact = real
    w_m, w_o = seen["in memory"][0], torch.cat(seen["ooc"])[:rows]
    goss_same = torch.equal(w_m, w_o)
    kept = float((w_m > 0).float().mean())
    del seen, w_m, w_o
    _log(f"[ooc] exact gaussian round (yh, ±0.5 gradients): streamed == "
         f"resident {same[0]}, == in memory {same[1]}; EFB + out-of-core "
         f"on the wide frame == bundled in memory {efb_same} "
         f"({e_ooc.ooc_stats['chunks']} chunks of Fb columns); GOSS + "
         f"out-of-core amplified weights == in-memory GOSS {goss_same} "
         f"({kept:.4f} of the rows kept) [{card}]")
    if not (all(same) and efb_same and goss_same):
        raise RuntimeError("ooc: a bitwise check failed")

    hist_op.reset_launches()
    n_small = legs["ooc 1M"]["chunks"]
    with _ChunkRecorder(hist_op, n_small, _OOC_DEEP) as rec_deep:
        t0 = time.perf_counter()
        deep = fit(small, ntrees=1, max_depth=_OOC_DEEP)
        deep_s = time.perf_counter() - t0
    deep_launches = dict(hist_op.LAUNCHES)
    deep_parts = hist_op.PARTITION_LAUNCHES["row_partition"]
    _log(f"[ooc] chunked depth-{_OOC_DEEP} tree over {n_small} chunks: "
         f"{deep_s:.3f}s, launches {deep_launches}, row partitions "
         f"{deep_parts} [{card}]")
    if deep_launches["partitioned"] <= 0 or deep_parts <= 0:
        raise RuntimeError("ooc: the chunked depth-10 tree took no "
                           "partitioned launch")
    _, lv9, calls9 = [lv for lv in rec_deep.levels(1, 256, 3, u8)
                      if lv[0] == _OOC_DEEP - 1][0]
    book.compare("ooc deep", None, 1, 256, 3, u8, "ooc d10",
                 [(f"ooc d10 level {_OOC_DEEP - 1}", lv9, 256, calls9)])
    book.compare("ooc rule", legs["ooc rule"]["rec"], 1, 256, 3, u8,
                 "ooc rule d6")
    book.compare("ooc 1M", legs["ooc 1M"]["rec"], 1, 256, 3, u8,
                 "ooc 1M d6")
    _log_sums(book.sums, ("ooc rule", "ooc 1M", "ooc deep"), card)
    res = {"rows": rows, "features": F, "upload_gb_per_s": up,
           "walks": walks, "exact_bitwise": same, "efb_ooc_bitwise":
           efb_same, "goss_ooc_same_rows": goss_same, "goss_kept": kept,
           "deep_s": deep_s, "deep_launches": deep_launches,
           "deep_partitions": deep_parts,
           "deep_partitioned_launches": deep_launches["partitioned"]}
    for label, v in legs.items():
        res[label] = {k: v[k] for k in ("cold_s", "warm_s", "rate",
                                        "chunk_rows", "chunks", "stats",
                                        "auc")}
    del legs, frame, c.wframe, rec_deep, lv9
    torch.cuda.empty_cache()
    return res


def _profile_counts(torch, fn) -> tuple[int, float, float]:
    """(device events, device-busy microseconds, wall microseconds) of
    one call of fn under torch.profiler: every kernel, copy and memset
    on the card counts as a launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0
           and e.key != "Activity Buffer Request"]
    return (sum(e.count for e in dev),
            sum(e.self_device_time_total for e in dev), wall_us)


def _phase_deeplearning(c) -> dict:
    """24. deeplearning: deeplearning_mlp's shape (200,000 HIGGS rows,
    hidden [64, 64], one epoch: 6,250 Adam steps of 32 rows): a warm-up
    and three timed trains as rows/s, train AUC and logloss; the
    launches of one step and the device-busy share from two short
    trains (200 and 400 steps) under torch.profiler; the estimator's
    default width (200, 200) once and an autoencoder (16,) on the first
    _DL_SIDE_ROWS rows; card vs CPU on
    5,000 rows; the artifact in MojoModel; B1 held at the train AUC's
    score histogram, its launches counted around that call."""
    from tools.datasets import higgs_arrays

    from h2o_kubernetes_tpu_torch import (DeepLearning, Frame, MojoModel,
                                          export_mojo)

    torch, card = c.torch, c.card
    cols, dom = higgs_arrays(_DL_ROWS, seed=2)
    frame = Frame.from_arrays(cols, domains=dom)
    rows = frame.nrows

    def fit(fr=frame, **kw):
        kw = dict(dict(hidden=_DL_HIDDEN, epochs=1, seed=1), **kw)
        m = DeepLearning(**kw).train(y="y", training_frame=fr)
        torch.cuda.synchronize()
        return m

    t0 = time.perf_counter()
    fit()
    first_s = time.perf_counter() - t0
    times, model = _warm_trains(fit, _DL_WARM)
    med = statistics.median(times)
    steps = rows // 32
    # the train's metrics: past 65,536 rows the AUC's 4096-bin score
    # histogram is B1's, its inputs kept and its launches counted from
    # zero around this call
    hist_op = c.hist_op
    hist_op.reset_launches()
    with _HistRecorder(hist_op) as rec:
        perf = model.model_performance(frame, "y")
    auc_launches = dict(hist_op.LAUNCHES)
    _log(f"[deeplearning] deeplearning_mlp: {rows} HIGGS rows, hidden "
         f"{_DL_HIDDEN}, 1 epoch = {steps} Adam steps of 32 rows: first "
         f"train {first_s:.3f}s; {_DL_WARM} warm trains "
         f"{[round(t, 4) for t in times]} s, median {med:.4f}s (min "
         f"{min(times):.4f}, max {max(times):.4f}) = {rows / med:.1f} "
         f"rows/s ({steps / med:.1f} steps/s); train auc "
         f"{perf['auc']:.6f} logloss {perf['logloss']:.6f} [{card}]")
    if not (0.6 < perf["auc"] <= 1 and np.isfinite(perf["logloss"])):
        raise RuntimeError("deeplearning: the MLP did not learn")
    if sum(auc_launches.values()) != 1:
        raise RuntimeError(f"deeplearning: the train AUC made histogram "
                           f"launches {auc_launches}, not one")
    # launches per step: two trains of one iteration each, 200 and 400
    # steps (train_samples_per_iteration = steps * 32), differenced
    probe = {}
    for n in _DL_PROBE_STEPS:
        probe[n] = c.profile_counts(torch, lambda n=n: fit(
            train_samples_per_iteration=n * 32, epochs=n * 32 / rows))
    (k0, _, _), (k1, busy, wall) = (probe[n] for n in _DL_PROBE_STEPS)
    per_step = (k1 - k0) / (_DL_PROBE_STEPS[1] - _DL_PROBE_STEPS[0])
    busy_share = busy / wall
    _log(f"[deeplearning] device events per step {per_step:.2f} (trains "
         f"of {_DL_PROBE_STEPS[0]} / {_DL_PROBE_STEPS[1]} steps: {k0} / "
         f"{k1}); the {_DL_PROBE_STEPS[1]}-step train: device busy "
         f"{busy / 1e3:.3f} ms of {wall / 1e3:.3f} ms wall = "
         f"{busy_share:.1%} (profiled) [{card}]")
    if c.profile:
        _profile(torch, "deeplearning train", fit, top=12)
    # the default width and the autoencoder on the frame's first
    # _DL_SIDE_ROWS rows (a step's cost does not depend on the rows)
    n_side = min(_DL_SIDE_ROWS, frame.nrows)
    side = frame.select_rows(np.arange(n_side))
    t0 = time.perf_counter()
    wide = DeepLearning(epochs=1, seed=1).train(y="y", training_frame=side)
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    wide_auc = wide.model_performance(side, "y")["auc"]
    _log(f"[deeplearning] the estimator's default width {wide.params.hidden}"
         f", 1 epoch on {n_side} rows: {wide_s:.3f}s = "
         f"{n_side / wide_s:.1f} rows/s, train auc {wide_auc:.6f} "
         f"[{card}]")
    feats = [n for n in cols if n != "y"]
    t0 = time.perf_counter()
    ae = DeepLearning(hidden=(16,), epochs=1, seed=1, autoencoder=True
                      ).train(training_frame=side, ignored_columns=["y"])
    torch.cuda.synchronize()
    ae_s = time.perf_counter() - t0
    an, df = ae.anomaly(side), ae.deepfeatures(side, 0)
    ae_mse = ae.model_performance(side)["mse"]
    _log(f"[deeplearning] autoencoder (16,) on the {len(feats)} features, "
         f"{n_side} rows: {ae_s:.3f}s; anomaly {an.shape}, "
         f"deepfeatures {df.shape}, reconstruction mse {ae_mse:.6f} "
         f"[{card}]")
    if not (an.shape == (n_side,) and df.shape == (n_side, 16)
            and np.isfinite(an).all() and 0 < ae_mse < 1):
        raise RuntimeError("deeplearning: bad autoencoder outputs")
    # card vs CPU on the first rows, each trained on its own device; the
    # limits are set from the measured gaps (9.8e-08 in the metrics,
    # 1.520e-06 in the predictions on an H100). The CPU's tiny ops run
    # on one thread.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    small = {k: v[:_DL_PARITY_ROWS] for k, v in cols.items()}
    f_card = Frame.from_arrays(small, domains=dom)
    f_cpu = Frame.from_arrays(small, domains=dom, device="cpu")
    m_card, m_cpu = fit(f_card), fit(f_cpu)
    torch.set_num_threads(threads)
    hc, hp = m_card.scoring_history[-1], m_cpu.scoring_history[-1]
    metric_gap = max(abs(hc[k] - hp[k]) for k in ("train_auc",
                                                  "train_logloss"))
    Xs = m_cpu._design_matrix(f_cpu).numpy()
    pred_gap = float(np.abs(m_card.score_numpy(Xs) - m_cpu.score_numpy(Xs)
                            ).max())
    w_gap = max(float(np.abs(a["w"] - b["w"]).max() / np.abs(b["w"]).max())
                for a, b in zip(m_card.net_numpy(), m_cpu.net_numpy()))
    _log(f"[deeplearning] card vs CPU at {_DL_PARITY_ROWS} rows: train auc "
         f"{hc['train_auc']:.6f} / {hp['train_auc']:.6f}, logloss "
         f"{hc['train_logloss']:.6f} / {hp['train_logloss']:.6f} (largest "
         f"gap {metric_gap:.3e}, limit {_DL_METRIC_LIMIT:.0e}), largest "
         f"prediction gap {pred_gap:.3e} (limit {_DL_PRED_LIMIT:.0e}), "
         f"weights within {w_gap:.3e} of each layer's largest [{card}]")
    if metric_gap > _DL_METRIC_LIMIT or pred_gap > _DL_PRED_LIMIT:
        raise RuntimeError("deeplearning: card vs CPU disagree")
    buf = io.BytesIO()
    export_mojo(model, buf)
    Xq = model._design_matrix(frame)[:_REQ_ROWS].cpu().numpy()
    mojo_err = float(np.abs(MojoModel(io.BytesIO(buf.getvalue())).predict(
        Xq) - model.score_numpy(Xq).astype(np.float64)).max())
    _log(f"[deeplearning] the artifact ({len(buf.getvalue())} bytes) in "
         f"MojoModel within {mojo_err:.3e} of predict on {_REQ_ROWS} rows "
         f"[{card}]")
    if mojo_err > 1e-5:
        raise RuntimeError("deeplearning: the artifact disagrees")
    # B1 at the train AUC's score histogram, held and timed as phase 18
    # holds xgboost_hist's
    c.book.compare("deeplearning_mlp", None, 1, 4096, 3, torch.int16, "dl",
                   [_auc_case(rec, "dl", torch.int16)])
    _log_sums(c.book.sums, ("deeplearning_mlp",), card)
    auc_err = c.book.levels["auc (dl)"]["max_rel_err"]
    return {"rows": rows, "hidden": _DL_HIDDEN, "steps": steps,
            "train_s": times, "median_s": med, "first_s": first_s,
            "rows_per_s": rows / med, "auc": perf["auc"],
            "logloss": perf["logloss"], "events_per_step": per_step,
            "busy_share": busy_share, "default_width_s": wide_s,
            "default_width_rows_per_s": n_side / wide_s,
            "side_rows": n_side,
            "autoencoder_s": ae_s, "autoencoder_mse": ae_mse,
            "parity_metric_gap": metric_gap, "parity_pred_gap": pred_gap,
            "parity_weight_rel": w_gap, "mojo_err": mojo_err,
            "auc_launches": auc_launches, "auc_max_rel_err": auc_err}


def _phase_word2vec(c) -> dict:
    """25. word2vec: word2vec_skipgram's shape (200,000 Zipf tokens over
    5,000 words, vec_size 32, one epoch: 244 steps of 8,192 pairs) as
    tokens/s over a warm-up and three timed trains; one step and its
    gradient scatter timed on their own; the estimator's defaults on a
    text8-sized corpus once; card vs CPU on 20,000 tokens; synonyms and
    the artifact's word vectors."""
    from tools.datasets import text8_like_tokens

    from h2o_kubernetes_tpu_torch import Frame, MojoModel, Word2Vec, \
        export_mojo
    from h2o_kubernetes_tpu_torch.models import word2vec as W2V
    from h2o_kubernetes_tpu_torch.runtime import prng

    torch, card = c.torch, c.card
    toks = text8_like_tokens(_W2V_TOKENS, vocab_size=_W2V_VOCAB, seed=5)
    frame = Frame.from_arrays({"words": toks})
    kw = dict(vec_size=32, epochs=1, min_word_freq=2, seed=1)

    def fit(fr=frame, **extra):
        return Word2Vec(**dict(kw, **extra)).train(fr)

    t0 = time.perf_counter()
    fit()
    first_s = time.perf_counter() - t0
    times, model = _warm_trains(fit, _W2V_WARM)
    med = statistics.median(times)
    V, n = len(model.vocab), len(toks)
    batch = min(8192, max(512, n))
    steps = n * 2 * 5 // batch
    _log(f"[word2vec] word2vec_skipgram: {n} tokens, {V} words, vec_size "
         f"32, 1 epoch = {steps} steps of {batch} pairs: first train "
         f"{first_s:.3f}s; {_W2V_WARM} warm trains "
         f"{[round(t, 4) for t in times]} s, median {med:.4f}s (min "
         f"{min(times):.4f}, max {max(times):.4f}) = {n / med:.1f} tokens/s "
         f"[{card}]")
    # one step at this shape, and its scatter (the three index_add_ into
    # zeroed [V, D] buffers) on its own
    col = frame.vec("words")
    _, _, corpus, sent_id, cdf = W2V.build_vocab(
        col.to_numpy(), list(col.domain), 2)
    dev = frame.device
    corp = torch.as_tensor(corpus.astype(np.int64), device=dev)
    sent = torch.as_tensor(sent_id, device=dev)
    cdf_d = torch.as_tensor(cdf, device=dev)
    ci, off, sign, u = (a[0] for a in next(W2V.epoch_draws(
        prng.key(3, device=dev), 1, batch, n, 5, 5, 1)))
    Win = torch.as_tensor(model.W, device=dev)
    Wout = Win.clone()
    G = tuple(torch.empty_like(Win) for _ in range(3))
    step_ms = _cuda_ms(torch, lambda: W2V._sgd_step(
        Win, Wout, corp, sent, cdf_d, ci, off, sign, u, 1e-3, n, G),
        _REPEATS)
    cc, oo, _ = W2V.pairs(corp, sent, ci, off, sign, n)
    negs = torch.searchsorted(cdf_d, u).reshape(-1)
    gv = torch.randn((batch, 32), device=dev)
    gn = torch.randn((batch * 5, 32), device=dev)

    def scatter():
        for g in G:
            g.zero_()
        G[0].index_add_(0, cc, gv)
        G[1].index_add_(0, oo, gv)
        G[2].index_add_(0, negs, gn)

    scatter_ms = _cuda_ms(torch, scatter, _REPEATS)
    _log(f"[word2vec] one step at this shape {step_ms:.4f} ms (median of "
         f"{_REPEATS}, CUDA events); its scatter (3 zeroed [{V}, 32] "
         f"buffers, {batch}·7 rows index_add_) {scatter_ms:.4f} ms [{card}]")
    syn = model.find_synonyms(model.vocab[1], 5)
    buf = io.BytesIO()
    export_mojo(model, buf)
    mm = MojoModel(io.BytesIO(buf.getvalue()))
    same = all(np.array_equal(mm.word_vector(w), model.W[i])
               for i, w in enumerate(model.vocab))
    _log(f"[word2vec] find_synonyms({model.vocab[1]!r}) -> {syn}; the "
         f"artifact ({len(buf.getvalue())} bytes) round-trips every "
         f"word_vector bitwise: {same} [{card}]")
    if not (len(syn) == 5 and same and np.isfinite(model.W).all()):
        raise RuntimeError("word2vec: bad synonyms or artifact")
    small = toks[:_W2V_PARITY_TOKENS]
    a = fit(Frame.from_arrays({"words": small}))
    b = fit(Frame.from_arrays({"words": small}, device="cpu"))
    w_rel = float(np.abs(a.W - b.W).max() / np.abs(b.W).max())
    _log(f"[word2vec] card vs CPU at {_W2V_PARITY_TOKENS} tokens: "
         f"embeddings within {w_rel:.3e} of the largest [{card}]")
    if a.vocab != b.vocab or w_rel > 1e-4:
        raise RuntimeError("word2vec: card vs CPU disagree")
    t0 = time.perf_counter()
    big = text8_like_tokens(_TEXT8_TOKENS, vocab_size=_TEXT8_VOCAB, seed=5)
    bframe = Frame.from_arrays({"words": big})
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tm = Word2Vec(epochs=1, seed=1).train(bframe)
    text8_s = time.perf_counter() - t0
    tb = min(8192, max(512, len(big)))
    _log(f"[word2vec] the estimator's defaults (vec_size 100, window 5, 5 "
         f"negatives, min_word_freq 5) on {len(big)} tokens "
         f"(frame built in {build_s:.2f}s): {len(tm.vocab)} words, "
         f"{len(big) * 10 // tb} steps of {tb} pairs in {text8_s:.3f}s = "
         f"{len(big) / text8_s:.1f} tokens/s [{card}]")
    if not np.isfinite(tm.W).all() or len(tm.find_synonyms(
            tm.vocab[0], 5)) != 5:
        raise RuntimeError("word2vec: bad text8-sized model")
    return {"tokens": n, "vocab": V, "steps": steps, "batch": batch,
            "train_s": times, "median_s": med, "first_s": first_s,
            "tokens_per_s": n / med, "step_ms": step_ms,
            "scatter_ms": scatter_ms, "parity_w_rel": w_rel,
            "text8_tokens": len(big), "text8_vocab": len(tm.vocab),
            "text8_build_s": build_s, "text8_s": text8_s,
            "text8_tokens_per_s": len(big) / text8_s}


def _tensors_equal(torch, x, y) -> bool:
    """Bitwise, NaN-aware: equal dtypes, NaN positions equal, every
    other value bit for bit (a NaN's payload is not a value); ``y``
    copied to ``x``'s device."""
    y = y.to(x.device)
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.is_floating_point():
        nx, ny = torch.isnan(x), torch.isnan(y)
        if not torch.equal(nx, ny):
            return False
        bits = torch.int32 if x.element_size() == 4 else torch.int64
        x, y = (torch.where(nx, 0.0, x).view(bits),
                torch.where(ny, 0.0, y).view(bits))
    return torch.equal(x, y)


def _frames_equal(torch, a, b) -> bool:
    """Names, kinds, domains and time origins equal, and every column
    bitwise (``_tensors_equal``)."""
    if a.names != b.names or a.nrows != b.nrows:
        return False
    for n in a.names:
        u, v = a[n], b[n]
        if (u.kind, u.domain) != (v.kind, v.domain) or (
                u.kind == "time" and u.origin != v.origin
                and not (np.isnan(u.origin) and np.isnan(v.origin))):
            return False
        if not _tensors_equal(torch, u.data, v.data):
            return False
    return True


def _group_scale(src, keys, col, out) -> tuple[np.ndarray, np.ndarray]:
    """Per row of a group_by result ``out``: the group's Σ|x| of column
    ``col`` of the source frame ``src`` (float64, on the host) and its
    live count — the yardstick of the float32 segment sums."""
    def key_matrix(f):
        return np.stack([np.where(np.isnan(f[k].to_numpy().astype(
            np.float64)), np.inf, f[k].to_numpy()) for k in keys], 1)
    ks = key_matrix(src)
    uniq, inv = np.unique(ks, axis=0, return_inverse=True)
    x = src[col].as_float().cpu().numpy().astype(np.float64)
    ok = ~np.isnan(x)
    scale = np.bincount(inv.ravel()[ok], np.abs(x[ok]), len(uniq))
    cnt = np.bincount(inv.ravel()[ok], minlength=len(uniq))
    ko = key_matrix(out)
    pos = {tuple(r): i for i, r in enumerate(uniq)}
    idx = np.array([pos[tuple(r)] for r in ko])
    return scale[idx], cnt[idx]


def _automl_cpu_leg(out: str, rows: int) -> int:
    """Phase 27c's CPU leg (``chip_smoke.py --automl-cpu-leg DIR ROWS``,
    a process of its own that main() starts before phase 3, so the
    card's phases overlap the CPU's minutes): the whole default plan on
    the CPU at ``rows`` airlines rows, every step saved under
    ``DIR/steps`` (AutoML's checkpoint_dir, which phase 27 resumes).
    Writes ``DIR/leg.json``. (DeepLearning_1's own sensitivity to a
    one-ulp change of its column statistics is measured in both
    packages by tools/dl_sigma_ulp.py: C7.)"""
    import torch

    # below the card phases' host work in the scheduler's order: it has
    # ~100 s of slack before phase 27c reads it
    os.nice(10)
    torch.set_num_threads(_AML_CPU_THREADS)
    from h2o_kubernetes_tpu_torch import AutoML, Frame
    from tools.datasets import airlines_arrays

    out = Path(out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cols, dom = airlines_arrays(rows, seed=0)
    t0 = time.perf_counter()
    aml = AutoML(max_models=12, nfolds=_AML_NFOLDS, seed=1,
                 project_name="parity", verbosity=None,
                 checkpoint_dir=str(out / "steps")).train(
        y="IsDepDelayed", training_frame=Frame.from_arrays(
            cols, domains=dom, device="cpu"))
    secs = time.perf_counter() - t0
    (out / "leg.json").write_text(json.dumps({
        "rows": rows, "threads": _AML_CPU_THREADS, "seconds": secs,
        "leaderboard": aml.leaderboard.as_list()}))
    return 0


def _start_automl_cpu_leg():
    """Start phase 27c's CPU leg (``_automl_cpu_leg``) with the card
    hidden from it; the process is stopped at exit if still running.
    Returns (process, its directory, its log)."""
    _AML_LEG_DIR.parent.mkdir(parents=True, exist_ok=True)
    log = _AML_LEG_DIR.parent / "automl_cpu_leg.log"
    fh = open(log, "w")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--automl-cpu-leg",
         str(_AML_LEG_DIR), str(_AML_PARITY_ROWS)],
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        stdout=fh, stderr=subprocess.STDOUT)
    fh.close()

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    # a SIGTERM exits through atexit too, so the leg never outlives us
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    return proc, _AML_LEG_DIR, log


def _lb_rows(aml) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "training_time_s"}
            for r in aml.leaderboard.as_list()]


def _same_leaderboard(got, want, metric: str) -> tuple[bool, dict]:
    """(the same model ids with the same metric keys in the same order,
    up to swaps of adjacent rows whose sort metrics lie within
    _AML_LIMIT; per model, each metric's gap)."""
    ids_g = [r["model_id"] for r in got]
    ids_w = [r["model_id"] for r in want]
    ok = sorted(ids_g) == sorted(ids_w)
    gaps = {}
    if ok:
        for i, (a, b) in enumerate(zip(ids_g, ids_w)):
            if a != b:
                j = ids_w.index(a)
                ok &= abs(j - i) == 1 and abs(
                    want[i][metric] - want[j][metric]) <= _AML_LIMIT
        by_id = {r["model_id"]: r for r in want}
        for r in got:
            w = by_id[r["model_id"]]
            ok &= set(r) == set(w)
            gaps[r["model_id"]] = {k: abs(r[k] - w[k]) for k in
                                   set(r) & set(w) - {"model_id"}}
    return ok, gaps


def _phase_automl(c) -> dict:
    """27. automl: cross-validation, stacked ensembles, AutoML, its
    scheduler and grid search on airlines rows (tools/datasets.
    airlines_arrays, response IsDepDelayed, as tools/automl_scale.py).
    a. automl_wall_100k (tools/bench_suite.py:428-470): 100,000 rows,
    nfolds=3, GLM and GBM, max_models=2: cold and warm wall seconds,
    each step's training_time_s, the scheduler's device and host busy
    seconds, the leaderboard, and the device-busy share of one more
    warm run under torch.profiler. b. BASELINE config #5 at _AML_ROWS
    rows: AutoML(max_models=11, nfolds=3, exclude_algos=["deeplearning"],
    seed=1) trains the default plan's eleven other steps and both
    ensembles (GLM metalearner, metalearner_nfolds=3): the leaderboard
    with each step's seconds, the wall time, the histogram launches by
    regime (B1, B2's partitioned, B3's batched; each counted from zero
    around the run and required), B1 held at GBM_1's first fold train's
    levels and at a holdout AUC's 4096 bins, B2 at GBM_5's deepest
    partitioned level, B3 at DRF_1's levels (as phase 9 holds them).
    c. card vs CPU at _AML_PARITY_ROWS rows: AutoML(max_models=12,
    nfolds=3, seed=1), the whole default plan and both ensembles, on the
    card here and on the CPU in the leg ``c.aml_cpu_leg`` started
    (``_start_automl_cpu_leg``; started here when absent), whose saved
    steps a CPU AutoML resumes (its base rows equal to the leg's, its
    retrained ensembles within _AML_LIMIT).
    Gated: fold ids bitwise and the same model ids; every GBM/XGBoost
    main and fold model walked card against CPU up to its first tree
    with a near-tie (_near_ties: every differing decision a float64
    near-tie; the compared leaves' gaps reported); every metric within
    _AML_LIMIT for GLM_1, DRF_1, XRT_1 and the boosted steps whose
    walks met no tie, and those rows in the same order (adjacent rows
    within _AML_LIMIT may swap); each card ensemble restacked on the
    CPU from its base models' holdout predictions within _AML_LIMIT of
    its row; a Cartesian GridSearch on GBM (max_depth 3 or 5 x
    learn_rate 0.05 or 0.1, nfolds=3) gives the same four models in
    the same order on both devices. Reported: the boosted rows past a
    tie and DeepLearning_1 (a chaotic train in both packages: PERF.md,
    ROADMAP C7)."""
    torch, hist_op, card, book = c.torch, c.hist_op, c.card, c.book
    from h2o_kubernetes_tpu_torch import (GBM, AutoML, Frame, GridSearch,
                                          StackedEnsemble)
    from tools.datasets import airlines_arrays

    y = "IsDepDelayed"
    u8, i16 = torch.uint8, torch.int16

    # -- a. automl_wall_100k ---------------------------------------------
    cols, dom = airlines_arrays(_AML_WALL_ROWS, seed=0)
    fr = Frame.from_arrays(cols, domains=dom)

    def wall_run(tag):
        t0 = time.perf_counter()
        a = AutoML(max_models=2, nfolds=3, include_algos=["glm", "gbm"],
                   seed=1, project_name=tag, verbosity=None).train(
            y=y, training_frame=fr)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, a
    cold_s, _ = wall_run("wall_cold")
    warm_s, aml = wall_run("wall_warm")
    steps = {r["model_id"]: r["training_time_s"]
             for r in aml.leaderboard.as_list()}
    events, busy_us, wall_us = c.profile_counts(
        torch, lambda: wall_run("wall_profiled"))
    wall = {"rows": _AML_WALL_ROWS, "cold_s": cold_s, "warm_s": warm_s,
            "step_training_time_s": steps,
            "scheduler": aml.scheduler_stats,
            "leaderboard": _lb_rows(aml),
            "profiled": {"device_events": events,
                         "device_busy_s": busy_us / 1e6,
                         "wall_s": wall_us / 1e6,
                         "device_busy_share": busy_us / wall_us}}
    _log(f"[automl] automl_wall_100k ({_AML_WALL_ROWS} rows, nfolds=3, "
         f"GLM + GBM, max_models=2): cold {cold_s:.3f}s, warm "
         f"{warm_s:.3f}s; steps {steps}; scheduler {aml.scheduler_stats}; "
         f"profiled warm run: {events} device events, busy "
         f"{busy_us / 1e6:.3f}s of {wall_us / 1e6:.3f}s "
         f"({100 * busy_us / wall_us:.1f}%); leader "
         f"{aml.leaderboard.rows[0]['model_id']} auc "
         f"{aml.leaderboard.rows[0]['auc']:.6f} [{card}]")
    del fr, aml

    # -- b. config #5 ----------------------------------------------------
    cols, dom = airlines_arrays(_AML_ROWS, seed=0)
    fr = Frame.from_arrays(cols, domains=dom)
    del cols
    hist_op.reset_launches()
    with _HistRecorder(hist_op) as rec:
        t0 = time.perf_counter()
        aml = AutoML(max_models=11, nfolds=_AML_NFOLDS,
                     exclude_algos=["deeplearning"], seed=1,
                     project_name="config5", verbosity=None).train(
            y=y, training_frame=fr)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = dict(hist_op.LAUNCHES)
    batched = dict(hist_op.BATCHED_LAUNCHES)
    parts = hist_op.PARTITION_LAUNCHES["row_partition"]
    b3 = sum(batched.values())
    b2 = launches["partitioned"] - batched["partitioned"]
    b1 = sum(launches.values()) - b3 - b2
    board = aml.leaderboard.as_list()
    ids = [r["model_id"] for r in board]
    want = {f"{n}_AutoML_config5" for n in (
        "GLM_1", "DRF_1", "XRT_1", "GBM_1", "GBM_2", "GBM_3", "GBM_4",
        "GBM_5", "XGBoost_1", "XGBoost_2", "XGBoost_3",
        "StackedEnsemble_BestOfFamily", "StackedEnsemble_AllModels")}
    _log(f"[automl] config #5: {_AML_ROWS} airlines rows, nfolds="
         f"{_AML_NFOLDS}, {len(board)} models in {run_s:.3f}s; histogram "
         f"launches {launches} (batched {batched}, row partitions {parts}): "
         f"B1 {b1}, B2 {b2}, B3 {b3}; scheduler {aml.scheduler_stats} "
         f"[{card}]")
    for r in board:
        _log(f"[automl]   {r['model_id']}: auc {r['auc']:.6f} logloss "
             f"{r['logloss']:.6f} training_time_s "
             f"{r.get('training_time_s', float('nan')):.3f}")
    if set(ids) != want:
        raise RuntimeError(f"config #5 leaderboard {ids}")
    if min(b1, b2, b3) <= 0:
        raise RuntimeError(f"config #5: B1 {b1}, B2 {b2}, B3 {b3} launches")
    if not all(np.isfinite(r["auc"]) and 0.5 < r["auc"] <= 1.0
               for r in board):
        raise RuntimeError("config #5: a model's CV auc is not sane")
    # B1 at GBM_1's first fold train (the run's first 256-bin single-tree
    # levels) and a holdout AUC's score histogram; B2 at GBM_5's deepest
    # partitioned level (its 64-bin levels); B3 at DRF_1's levels
    # (a holdout past 65,536 rows takes the AUC's histogram path; a
    # rehearsal at fewer rows has none)
    auc = [_auc_case(rec, "automl holdout", i16)] \
        if _AML_ROWS // _AML_NFOLDS > 65_536 else []
    # GBM_1's depth-6 tree histograms levels 0-5 (the deeper 256-bin
    # levels the recorder kept are GBM_2's and GBM_3's)
    gbm1 = [(f"aml gbm1 d6 level {d}", inp, 256, calls)
            for d, inp, calls in rec.levels(1, 256, 3, u8) if d < 6]
    book.compare("automl config5 b1", None, 1, 256, 3, u8, "aml gbm1 d6",
                 gbm1 + auc)
    b2_levels = rec.levels(1, 64, 3, u8)
    deep = []
    for d, inp, calls in sorted(b2_levels, reverse=True):
        if hist_op.hist_mode(1, inp[3], inp[0].shape[0], 64, 3, 1,
                             inp[0].shape[1]) == "partitioned":
            deep = [(f"aml gbm5 d10 level {d}", inp, 64, calls)]
            break
    if not deep:
        raise RuntimeError("config #5: no partitioned 64-bin level")
    book.compare("automl config5 b2", None, 1, 64, 3, u8, "aml gbm5 d10",
                 deep)
    if book.levels[deep[0][0]]["mode"] != "partitioned":
        raise RuntimeError(f"config #5: {deep[0][0]} launched "
                           f"{book.levels[deep[0][0]]['mode']}")
    drf_k = sorted({k[0] for k in rec.seen if k[0] > 1 and k[1] == 64})
    book.compare("automl config5 b3", rec, drf_k[0], 64, 2, u8,
                 "aml drf d12")
    _log_sums(book.sums, ("automl config5 b1", "automl config5 b2",
                          "automl config5 b3"), card)
    held = {k: v for k, v in book.levels.items() if k.startswith("aml ")}
    config5 = {"rows": _AML_ROWS, "nfolds": _AML_NFOLDS, "wall_s": run_s,
               "leaderboard": board, "launches": launches,
               "batched_launches": batched, "row_partitions": parts,
               "b1_launches": b1, "b2_launches": b2, "b3_launches": b3,
               "scheduler": aml.scheduler_stats,
               "held_max_rel_err": max(v["max_rel_err"]
                                       for v in held.values())}
    del fr, aml, rec

    # -- c. card vs CPU --------------------------------------------------
    if getattr(c, "aml_cpu_leg", None) is None:
        c.aml_cpu_leg = _start_automl_cpu_leg()
    leg, leg_dir, leg_log = c.aml_cpu_leg
    cols, dom = airlines_arrays(_AML_PARITY_ROWS, seed=0)
    f_card = Frame.from_arrays(cols, domains=dom)
    f_cpu = Frame.from_arrays(cols, domains=dom, device="cpu")

    def plan(**kw):
        return AutoML(max_models=12, nfolds=_AML_NFOLDS, seed=1,
                      project_name="parity", verbosity=None, **kw)
    t0 = time.perf_counter()
    card_aml = plan().train(y=y, training_frame=f_card)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    grids = {dev: GridSearch(
        GBM(ntrees=20, seed=1, nfolds=_AML_NFOLDS, fold_assignment="modulo"),
        {"max_depth": [3, 5], "learn_rate": [0.05, 0.1]},
        grid_id="parity_grid").train(y=y, training_frame=f)
        for dev, f in (("card", f_card), ("cpu", f_cpu))}
    t0 = time.perf_counter()
    try:
        rc = leg.wait(timeout=_AML_LEG_TIMEOUT)
    except subprocess.TimeoutExpired:
        leg.kill()
        rc = "killed"
    waited_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"automl: the CPU leg ended with {rc}: "
                           + leg_log.read_text()[-3000:])
    legj = json.loads((leg_dir / "leg.json").read_text())
    cpu_aml = plan(checkpoint_dir=str(leg_dir / "steps")).train(
        y=y, training_frame=f_cpu)
    lb_card, lb_cpu = _lb_rows(card_aml), _lb_rows(cpu_aml)
    # the resumed base rows are the leg's bitwise; its ensembles are
    # retrained here, on this process's CPU threads
    lb_leg = [{k: v for k, v in r.items() if k != "training_time_s"}
              for r in legj["leaderboard"]]
    resumed, resume_gap = _same_leaderboard(lb_cpu, lb_leg, "auc")
    resumed &= all(not g or (max(g.values()) <= _AML_LIMIT if
                             m.startswith("StackedEnsemble") else
                             max(g.values()) == 0.0)
                   for m, g in resume_gap.items())
    models = {"card": card_aml.leaderboard.models,
              "cpu": cpu_aml.leaderboard.models}
    ids = [r["model_id"] for r in lb_card]
    ids_same = sorted(ids) == sorted(r["model_id"] for r in lb_cpu) \
        and len(ids) == 14
    fails = [] if ids_same else [f"model ids {ids} / "
                                 f"{[r['model_id'] for r in lb_cpu]}"]
    if not resumed:
        fails.append("the resumed CPU leaderboard is not the leg's")
    folds_equal = ids_same and all(np.array_equal(
        models["card"][m].cv.fold_ids, models["cpu"][m].cv.fold_ids)
        for m in ids)
    if not folds_equal:
        fails.append("fold ids")
    gaps = {}
    if ids_same:
        by_id = {r["model_id"]: r for r in lb_cpu}
        gaps = {r["model_id"]: {k: abs(r[k] - by_id[r["model_id"]][k])
                                for k in r if k != "model_id"}
                for r in lb_card}
    # the boosted steps: main and fold models walked up to the first tie
    walks, exact = {}, set()
    for mid in ids if ids_same else []:
        fam = mid.split("_")[0]
        if fam in ("GLM", "DRF", "XRT"):
            exact.add(mid)
        if fam not in ("GBM", "XGBoost"):
            continue
        mc, mp = models["card"][mid], models["cpu"][mid]
        lam = mc.params.reg_lambda      # 0 for GBM
        pairs = [("main", mc, mp, f_card)] + [
            (f"fold {k}", a, b, f_card.select_rows(mc.cv.fold_ids != k))
            for k, (a, b) in enumerate(zip(mc.cv.models, mp.cv.models))]
        w = {}
        for tag, a, b, fr in pairs:
            compared, ties, leaf_gap = _near_ties(a, b, fr, y, {}, lam=lam,
                                                  until_tie=True)
            # the compared leaves' gaps are reported, as phases 9-26 do:
            # a one-row leaf (min_rows=1) carries the f32 rounding of
            # the sibling subtractions from its 3,333-row root
            w[tag] = {"compared": compared, "ties": ties,
                      "leaf_gap": leaf_gap}
        walks[mid] = w
        if not any(v["ties"] for v in w.values()):
            exact.add(mid)
    for mid in sorted(exact):
        if max(gaps[mid].values()) > _AML_LIMIT:
            fails.append(f"{mid}: metrics {gaps[mid]}")
    order_same, _ = _same_leaderboard(
        [r for r in lb_card if r["model_id"] in exact],
        [r for r in lb_cpu if r["model_id"] in exact], "auc")
    if not order_same:
        fails.append("the order of the gated rows")
    # each card ensemble restacked on the CPU from the same base models'
    # holdout predictions (StackedEnsemble moves them to the frame)
    restack = {}
    for mid in ids if ids_same else []:
        if mid.startswith("StackedEnsemble"):
            se = StackedEnsemble(
                models["card"][mid].base_models,
                metalearner_nfolds=_AML_NFOLDS).train(y=y,
                                                      training_frame=f_cpu)
            row = next(r for r in lb_card if r["model_id"] == mid)
            restack[mid] = max(abs(se.cv.metrics[k] - row[k])
                               for k in se.cv.metrics)
            if restack[mid] > _AML_LIMIT:
                fails.append(f"{mid} restacked on the CPU "
                             f"{restack[mid]:.3e} apart")
    g_rows = {d: [(r["model_id"], r["max_depth"], r["learn_rate"])
                  for r in g.get_grid()] for d, g in grids.items()}
    if g_rows["card"] != g_rows["cpu"] or len(g_rows["card"]) != 4:
        fails.append(f"grid {g_rows}")
    step_s = {d: {r["model_id"]: r.get("training_time_s") for r in lb}
              for d, lb in (("card", card_aml.leaderboard.as_list()),
                            ("cpu", legj["leaderboard"]))}
    for mid in ids:
        tag = "gated" if mid in exact else "restacked" \
            if mid in restack else "reported"
        ties = {t: v["ties"] for t, v in walks.get(mid, {}).items()
                if v["ties"]}
        _log(f"[automl]   card vs CPU {mid} ({tag}; {step_s['card'][mid]}"
             f" s / {step_s['cpu'].get(mid)} s): largest metric gap "
             f"{max(gaps[mid].values()):.2e}" + (
                 f", walked {sum(v['compared'] for v in walks[mid].values())}"
                 f" nodes, ties {ties}, largest compared leaf gap "
                 f"{max(v['leaf_gap'] for v in walks[mid].values()):.2e}"
                 if mid in walks else "") + (
                 f", restacked on the CPU {restack[mid]:.2e}"
                 if mid in restack else ""))
    dl_id = "DeepLearning_1_AutoML_parity"
    resume_se = max((max(g.values()) for m, g in resume_gap.items()
                     if g and m.startswith("StackedEnsemble")), default=0.0)
    same_all, _ = _same_leaderboard(lb_card, lb_cpu, "auc")
    _log(f"[automl] card vs CPU at {_AML_PARITY_ROWS} rows, the whole plan "
         f"({len(lb_card)} models; card {card_s:.1f}s, CPU leg "
         f"{legj['seconds']:.1f}s on {legj['threads']} threads, waited "
         f"{waited_s:.1f}s): ids {ids} / {[r['model_id'] for r in lb_cpu]}"
         f"; fold ids bitwise {folds_equal}; resumed = leg {resumed} "
         f"(ensembles within {resume_se:.2e}); gated "
         f"rows {sorted(exact)} in the same order {order_same}; the whole "
         f"order the same {same_all}; {dl_id} gaps "
         f"{ {k: f'{v:.2e}' for k, v in gaps.get(dl_id, {}).items()} }; "
         f"grid "
         f"{g_rows['card']} / {g_rows['cpu']} [{card}]")
    if fails:
        raise RuntimeError("automl: card and CPU disagree: "
                           + "; ".join(fails))
    return {"wall_100k": wall, "config5": config5,
            "parity": {"rows": _AML_PARITY_ROWS, "card_s": card_s,
                       "cpu_leg_s": legj["seconds"],
                       "cpu_leg_threads": legj["threads"],
                       "cpu_leg_waited_s": waited_s,
                       "fold_ids_bitwise": folds_equal,
                       "resumed_equal": resumed,
                       "resumed_ensemble_gap": resume_se,
                       "gated": sorted(exact),
                       "gated_order_same": order_same,
                       "whole_order_same": same_all, "metric_gaps": gaps,
                       "walks": {m: {t: {**v, "ties": [list(x) for x in
                                                       v["ties"]]}
                                     for t, v in w.items()}
                                 for m, w in walks.items()},
                       "restacked_gaps": restack,
                       "grid": g_rows["card"],
                       "leaderboard_card": lb_card,
                       "leaderboard_cpu": lb_cpu}}


def _phase_frame(c) -> dict:
    """26. frame: BASELINE config #1 from the file. ``import_file`` of a
    1,000,000-row airlines CSV (tools/datasets.airlines_csv, 27 columns,
    5 enums; tools/bench_suite.py's ingest_airlines_csv at its on-chip
    size) on the card against the same call on the CPU (bitwise), as
    rows/s, MB/s and cells/s, with the CSV path taken; eleven Frame
    calls on the card, each a synchronized median of 2 held against the CPU's
    (bitwise; the group sums within 1e-6 of each group's Σ|x|);
    ``split_frame([0.8], seed=42)`` -> GBM(ntrees=10, max_depth=5,
    seed=1) on the 0.8 part -> ``model_performance`` on the 0.2 part:
    warm train s, rows·trees/s, train and holdout AUC and logloss, B1's
    launches on that path, card vs CPU on 200,000 train rows (structure
    up to float64 near-ties, holdout AUC within 1e-4), B1 held at the
    train's levels and its two AUC inputs; ``save_frame``/``load_frame`` and
    ``export_file``/``import_file`` round trips; a 1,000,000-value time
    column's ``as_float`` and ``to_numpy`` card = CPU. Its files are
    written under ``c.frame_work``, which main() removes after phase 29
    has imported the CSV over REST."""
    return _frame_body(c, c.frame_work)


def _frame_body(c, work: str) -> dict:
    import os

    from tools.datasets import airlines_csv

    from h2o_kubernetes_tpu_torch import (GBM, Frame, export_file,
                                          import_file, load_frame,
                                          save_frame)
    from h2o_kubernetes_tpu_torch.runtime import backend

    torch, card = c.torch, c.card
    try:
        import pyarrow  # noqa: F401
        arrow = True
    except ImportError:
        arrow = False
    dev = backend.resolve_device()          # the card
    path = os.path.join(work, "airlines.csv")
    t0 = time.perf_counter()
    airlines_csv(path, _FRAME_ROWS, seed=0)
    write_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    fr = import_file(path)
    torch.cuda.synchronize()
    first_import_s = time.perf_counter() - t0
    import_s = _sync_s(torch, lambda: import_file(path), _FRAME_REPEATS)
    card_path = fr.csv_path
    t0 = time.perf_counter()
    cpu = import_file(path, device="cpu")
    cpu_import_s = time.perf_counter() - t0
    rows, cells = fr.nrows, fr.nrows * fr.ncols
    same = _frames_equal(torch, fr, cpu)
    enums = [n for n in fr.names if fr[n].is_enum()]
    _log(f"[frame] airlines.csv: {rows} rows x {fr.ncols} columns "
         f"({len(enums)} enums: {enums}), {mb:.1f} MB written in "
         f"{write_s:.2f}s; import_file on the card: first "
         f"{first_import_s:.3f}s, then {import_s:.3f}s (median of "
         f"{_FRAME_REPEATS}) = "
         f"{rows / import_s:.1f} rows/s, {mb / import_s:.2f} MB/s, "
         f"{cells / import_s:.1f} cells/s through the {card_path} CSV "
         f"path (pyarrow importable: {arrow}); on the CPU {cpu_import_s:.3f}"
         f"s ({cpu.csv_path}); card = CPU (names, kinds, domains, "
         f"values bitwise) {same} [{card}]")
    if not (same and rows == _FRAME_ROWS and fr.device == dev):
        raise RuntimeError("frame: the card's import differs from the CPU's")

    # -- eleven Frame calls, card against CPU ------------------------------
    parts, cparts = fr.split_frame([0.8], seed=42), \
        cpu.split_frame([0.8], seed=42)
    gkeys = ["UniqueCarrier", "Month"]

    def group(f):
        return f.group_by(gkeys).mean("Distance").sd("AirTime").min(
            "TaxiOut").count().get_frame()
    gcpu = group(cpu)

    def imputed(f):
        g = f[f.names]
        g.impute("DepTime", "mean")
        return g

    calls = {
        "split_frame": lambda f, p: f.split_frame([0.8], seed=42),
        "sort": lambda f, p: f.sort(["Origin", "DepTime"]),
        "sort descending": lambda f, p: f.sort(["Origin", "DepTime"],
                                               ascending=False),
        "group_by": lambda f, p: group(f),
        # both sides join the CPU's group table, so the join is exact
        "merge": lambda f, p: f.merge(gcpu._to(f.device), all_x=True),
        "impute": lambda f, p: imputed(f),
        "table": lambda f, p: f.table("UniqueCarrier", "CancellationCode"),
        "quantile": lambda f, p: f.quantile(),
        "filter": lambda f, p: f[(f["Distance"] > 500)
                                 & (f["Cancelled"] == 0)],
        "asfactor": lambda f, p: Frame({"Month": f["Month"].asfactor()}),
        "rbind": lambda f, p: p[0].rbind(p[1]),
    }
    munge = {}
    for name, fn in calls.items():
        s = _sync_s(torch, lambda: fn(fr, parts), _FRAME_REPEATS)
        t0 = time.perf_counter()
        want = fn(cpu, cparts)
        cpu_s = time.perf_counter() - t0
        got = fn(fr, parts)
        if name == "split_frame":
            ok = all(_frames_equal(torch, a, b) for a, b in zip(got, want))
            out_rows = [p.nrows for p in got]
        elif name == "group_by":
            exact = ["UniqueCarrier", "Month", "min_TaxiOut", "nrow"]
            ok = _frames_equal(torch, got[exact], want[exact])
            gaps = {}
            for col, src in (("mean_Distance", "Distance"),
                             ("sd_AirTime", "AirTime")):
                scale, cnt = _group_scale(cpu, gkeys, src, want)
                a = got[col].to_numpy().astype(np.float64)
                b = want[col].to_numpy().astype(np.float64)
                ok &= bool(np.array_equal(np.isnan(a), np.isnan(b)))
                live = ~np.isnan(b)
                lim = scale / (np.maximum(cnt, 1) if col.startswith("mean")
                               else 1)
                gaps[col] = float((np.abs(a - b)[live]
                                   / np.maximum(lim[live], 1e-300)).max())
                ok &= gaps[col] <= _GROUP_SUM_LIMIT
            out_rows = got.nrows
        else:
            ok = _frames_equal(torch, got, want)
            out_rows = got.nrows
        munge[name] = {"card_s": s, "cpu_s": cpu_s, "rows_out": out_rows,
                       "equal": bool(ok)}
        if name == "group_by":
            munge[name]["rel_gap_of_group_abs_sum"] = gaps
        _log(f"[frame] {name}: card {s * 1e3:.3f} ms (median of "
             f"{_FRAME_REPEATS}, synchronized), CPU {cpu_s * 1e3:.3f} ms, "
             f"{out_rows} rows out; card = CPU {ok}"
             + (f" (group sums: largest gap / group Σ|x| {gaps}, limit "
                f"{_GROUP_SUM_LIMIT:.0e})" if name == "group_by" else "")
             + f" [{card}]")
        if not ok:
            raise RuntimeError(f"frame: {name} on the card differs from the "
                               "CPU's")
    if munge["merge"]["rows_out"] != rows:
        raise RuntimeError("frame: the left join lost or grew rows")

    # -- split -> GBM -> holdout metrics ------------------------------------
    train, test = parts
    y = "IsDepDelayed"
    kw = dict(ntrees=_FRAME_TREES, max_depth=_FRAME_DEPTH, seed=1)

    def fit(f=train):
        m = GBM(**kw).train(y=y, training_frame=f)
        torch.cuda.synchronize()
        return m

    t0 = time.perf_counter()
    fit()
    first_s = time.perf_counter() - t0
    times, _ = _warm_trains(fit, _FRAME_WARM)
    med = statistics.median(times)
    hist_op = c.hist_op
    hist_op.reset_launches()
    with _HistRecorder(hist_op) as rec:
        model = fit()
        perf = model.model_performance(test, y)
    launches = dict(hist_op.LAUNCHES)
    hist = model.scoring_history[-1]
    # card vs CPU: each device trains on the first _FRAME_PARITY_ROWS
    # rows of its 0.8 part (a CPU train of all 800,000 takes ~50 s) and
    # scores the whole 0.2 part; the CPU's plain histograms sum in
    # float64 and round each cell once, so CancellationCode's NA bin
    # (98.5% of the rows) does not drift
    sub = np.arange(min(_FRAME_PARITY_ROWS, train.nrows))
    s_card, s_cpu = train.select_rows(sub), cparts[0].select_rows(sub)
    m_card = GBM(**kw).train(y=y, training_frame=s_card)
    m_cpu = GBM(**kw).train(y=y, training_frame=s_cpu)
    auc_card = m_card.model_performance(test, y)["auc"]
    auc_cpu = m_cpu.model_performance(cparts[1], y)["auc"]
    compared, ties, leaf_gap = _near_ties(m_card, m_cpu, s_card, y, {})
    auc_gap = abs(auc_card - auc_cpu)
    n_launch = sum(launches.values())
    _log(f"[frame] GBM ntrees={_FRAME_TREES} max_depth={_FRAME_DEPTH} on "
         f"the 0.8 part ({train.nrows} rows, {len(model.feature_names)} "
         f"features): first train {first_s:.3f}s, warm "
         f"{[round(t, 4) for t in times]} s, median {med:.4f}s = "
         f"{train.nrows * _FRAME_TREES / med:.1f} rows·trees/s; train auc "
         f"{hist['train_auc']:.6f} logloss {hist['train_logloss']:.6f}; "
         f"holdout ({test.nrows} rows) auc {perf['auc']:.6f} logloss "
         f"{perf['logloss']:.6f}; B1 launches on the path (a train and the "
         f"holdout metrics) {launches}; card vs CPU trained on "
         f"{len(sub)} rows: {compared} nodes compared, near-ties {ties}, "
         f"largest leaf gap {leaf_gap:.3e}, holdout auc {auc_card:.6f} / "
         f"{auc_cpu:.6f} (gap {auc_gap:.3e}, limit "
         f"{_HOLDOUT_AUC_LIMIT:.0e}) [{card}]")
    if n_launch != _FRAME_TREES * _FRAME_DEPTH + 2:
        raise RuntimeError(f"frame: {n_launch} B1 launches, not "
                           f"{_FRAME_TREES * _FRAME_DEPTH} levels + 2 AUCs")
    # the card's f32 atomics sum each node in another order than the
    # CPU's float64 sums, and past the first near-tie a tree's later
    # margins differ: leaves are read, the structure (the walker raises
    # past a near-tie) and the holdout AUC held, as phases 18, 21, 23 do
    if auc_gap > _HOLDOUT_AUC_LIMIT or not 0.5 < perf["auc"] < 1:
        raise RuntimeError("frame: the card's GBM disagrees with the CPU's")
    # B1 at this train's five levels and at the holdout AUC's input
    book = c.book
    # the train AUC's score histogram, then the holdout's
    aucs = rec.levels(1, 4096, 3, torch.int16)
    book.compare("airlines gbm", rec, 1, 256, 3, torch.uint8, "air d5",
                 [(f"auc (air {lab})", inp, 4096, calls) for lab, (
                     _, inp, calls) in zip(("train", "holdout"), aucs)])
    held = [k for k in book.levels if k.startswith("air d5 level")]
    if len(held) != _FRAME_DEPTH:
        raise RuntimeError(f"frame: B1 held at {held}")
    _log_sums(book.sums, ("airlines gbm",), card)

    # -- round trips ----------------------------------------------------------
    fpath = os.path.join(work, "airlines.frame")
    t0 = time.perf_counter()
    save_frame(fr, fpath)
    back = load_frame(fpath)
    torch.cuda.synchronize()
    frame_file_s = time.perf_counter() - t0
    file_equal = _frames_equal(torch, back, fr) and back.device == dev
    cpath = os.path.join(work, "holdout.csv")
    t0 = time.perf_counter()
    export_file(test, cpath)
    export_s = time.perf_counter() - t0
    again = import_file(cpath)
    csv_equal = True
    for n in test.names:
        u, v = test[n], again[n]
        if u.is_enum():
            lab = np.array(list(u.domain) + [""], dtype=object)
            lab2 = np.array(list(v.domain or []) + [""], dtype=object)
            a, b = u.to_numpy(), v.to_numpy()
            csv_equal &= bool((lab[a] == lab2[b]).all()) if v.is_enum() \
                else False
        else:
            x = u.to_numpy()
            want = np.where(np.isnan(x), np.nan, np.char.mod(
                "%g", np.nan_to_num(x)).astype(np.float64)
            ).astype(np.float32)
            got = v.to_numpy()
            csv_equal &= bool(np.array_equal(np.isnan(got), np.isnan(want))
                              and (got[~np.isnan(got)]
                                   == want[~np.isnan(want)]).all())
    rng = np.random.default_rng(26)
    ms = (1_262_304_000_000 + rng.integers(0, 4 * 10 ** 11, _FRAME_ROWS)
          ).astype("datetime64[ms]")
    ms[::97] = np.datetime64("NaT")
    tv = Frame.from_arrays({"t": ms})["t"]
    tc = Frame.from_arrays({"t": ms}, device="cpu")["t"]
    time_equal = (tv.kind == tc.kind == "time" and tv.origin == tc.origin
                  and tv.device == dev
                  and _tensors_equal(torch, tv.as_float(), tc.as_float())
                  and _tensors_equal(torch, torch.from_numpy(tv.to_numpy()),
                                     torch.from_numpy(tc.to_numpy())))
    _log(f"[frame] save_frame -> load_frame on the card {frame_file_s:.3f}s,"
         f" bitwise {file_equal}; export_file of the {test.nrows}-row "
         f"holdout {export_s:.3f}s, import_file back equal to the frame as "
         f"%g text writes it {csv_equal}; a {_FRAME_ROWS}-value time column"
         f" (origin {tv.origin}): as_float and to_numpy card = CPU "
         f"{time_equal} [{card}]")
    if not (file_equal and csv_equal and time_equal):
        raise RuntimeError("frame: a round trip or the time column differs")
    return {"rows": rows, "columns": fr.ncols, "mb": mb,
            "write_s": write_s, "first_import_s": first_import_s,
            "import_s": import_s,
            "rows_per_s": rows / import_s, "mb_per_s": mb / import_s,
            "cells_per_s": cells / import_s, "csv_path": card_path,
            "pyarrow": arrow, "cpu_import_s": cpu_import_s,
            "munge": munge, "gbm": {
                "train_rows": train.nrows, "test_rows": test.nrows,
                "first_s": first_s, "warm_s": times, "median_s": med,
                "rows_trees_per_s": train.nrows * _FRAME_TREES / med,
                "train_auc": hist["train_auc"],
                "train_logloss": hist["train_logloss"],
                "holdout_auc": perf["auc"],
                "holdout_logloss": perf["logloss"],
                "parity_rows": len(sub), "parity_holdout_auc": [
                    auc_card, auc_cpu], "auc_gap": auc_gap,
                "nodes_compared": compared, "near_ties": len(ties),
                "leaf_gap": leaf_gap, "b1_launches": launches},
            "frame_file_s": frame_file_s, "export_s": export_s}


def _learner_sane(name: str, model, out, fr) -> bool:
    """What a train at phase 28's shapes must give, whatever the
    device."""
    if name == "kmeans":
        return int(model.size.sum()) == fr["higgs"].nrows and \
            np.isfinite(model.tot_withinss)
    if name == "pca":
        ev = model.eigenvalues.cpu().numpy()
        return bool((ev > 0).all() and (np.diff(ev) <= 0).all())
    if name == "glrm":
        return 0 < model.objective < 1
    if name == "naivebayes":
        return bool(np.isfinite(model.priors.cpu().numpy()).all()
                    and np.isfinite(model.num_sd.cpu().numpy()).all())
    if name == "isolationforest":
        return bool(model.trees.is_split[:, 0].all())
    if name == "coxph":
        return model.loglik > model.loglik_null
    if name == "aggregator":
        return 50 <= model.num_exemplars() <= 150 and \
            int(model._counts.sum()) == fr["higgs"].nrows
    te = np.stack([out[f"{c}_te"].to_numpy() for c in model.columns])
    return bool(np.isfinite(te).all())


def _phase_learners(c) -> dict:
    """28. KMeans, PCA, GLRM, naive Bayes, isolation forest, CoxPH, the
    aggregator and target encoding at tools/torch_learners.py's shapes on
    the card, their artifacts, card vs CPU, and the column statistics
    card = CPU. Their hot ops are matmuls, segment sums and torch.linalg
    (none reaches pl.pallas_call in the JAX package), so no kernel of the
    port runs on these paths: B1-B4's counts are set to 0 before and
    read after, and must stay 0."""
    torch = c.torch
    from h2o_kubernetes_tpu_torch import Frame
    from tools import torch_learners as L

    t0 = time.perf_counter()
    tables = L.arrays(_LEARNER_ROWS)
    fc = L.frames(tables, "cuda")
    make_s = time.perf_counter() - t0
    ties = L.max_tied_events(tables["surv"][0])
    _log(f"[learners] tables at {_LEARNER_ROWS} rows made and on the card "
         f"in {make_s:.2f}s; survival times on a grid of {L.SURV_GRID}: "
         f"at most {ties} events share a time (Efron's cap 32), "
         f"{1 - tables['surv'][0]['e'].mean():.3f} censored")
    if ties > 32:
        raise RuntimeError("learners: the survival grid ties too many")
    # C8: the column statistics are float64 two-pass sums rounded once,
    # so the card and the CPU give the same float32 mean and sigma
    air_cpu = Frame.from_arrays(tables["airlines"][0],
                                domains=tables["airlines"][1],
                                device="cpu")
    stats_apart = []
    n_stats = 0
    for n in air_cpu.names:
        if air_cpu.vec(n).is_enum():
            continue
        rc, rh = fc["airlines"].vec(n).rollups(), air_cpu.vec(n).rollups()
        n_stats += 1
        for k in ("mean", "sigma"):
            if np.float32(rc[k]).tobytes() != np.float32(rh[k]).tobytes():
                stats_apart.append((n, k, rc[k], rh[k]))
    _log(f"[learners] rollups of {n_stats} numeric airlines columns at "
         f"{_LEARNER_ROWS} rows, card vs CPU: float32 mean and sigma "
         f"bitwise {not stats_apart} {stats_apart[:3]}")
    if stats_apart:
        raise RuntimeError("learners: column statistics differ between "
                           "card and CPU")
    c.hist_op.reset_launches()
    c.shap_kernel.reset_launches()
    out = {"rows": _LEARNER_ROWS, "parity_rows": _LEARNER_PARITY_ROWS,
           "tables_s": make_s, "max_tied_events": ties,
           "rollups_bitwise_columns": n_stats}
    for name in L.NAMES:
        t = time.perf_counter()
        model, tr = L.train(name, fc)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        times = []
        for _ in range(_LEARNER_WARM):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model, tr = L.train(name, fc)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        med = statistics.median(times)
        work, unit = L.units(name, model, _LEARNER_ROWS)
        mojo = None if name == "aggregator" else \
            L.artifact_gap(name, model, fc, _LEARNER_MOJO_ROWS)
        sane = _learner_sane(name, model, tr, fc)
        _log(f"[learners] {name}: first {first_s:.3f}s, warm "
             f"{[round(x, 4) for x in times]} s, median {med:.4f}s = "
             f"{work / med:.1f} {unit}/s; artifact vs predict "
             f"{'-' if mojo is None else f'{mojo:.3e}'} (limit "
             f"{_LEARNER_MOJO_LIMIT:.0e}); outputs sane {sane} [{c.card}]")
        if not sane or (mojo is not None and mojo > _LEARNER_MOJO_LIMIT):
            raise RuntimeError(f"learners: {name} gave wrong outputs")
        out[name] = {"first_s": first_s, "train_s": times,
                     "median_s": med, "per_s": work / med, "unit": unit,
                     "mojo_gap": mojo}
    hist_n = sum(c.hist_op.LAUNCHES.values())
    shap_n = c.shap_kernel.flat_shap_tab_kernel.launches
    _log(f"[learners] B1-B3 launches on these paths {hist_n}, B4 {shap_n} "
         "(no kernel of the port runs here)")
    if hist_n or shap_n:
        raise RuntimeError("learners: a kernel ran on a learner's path")
    # card vs CPU, each device training on the first rows of each table
    small = L.head(tables, _LEARNER_PARITY_ROWS)
    sc, sh = L.frames(small, "cuda"), L.frames(small, "cpu")
    for name in L.NAMES:
        mc, tc = L.train(name, sc)
        t = time.perf_counter()
        mh, th = L.train(name, sh)
        cpu_s = time.perf_counter() - t
        res = L.compare(name, mc, mh, sc, sh, tc, th)
        gaps = {k: f"{v['gap']:.3e} (limit {v['limit']:.0e})"
                for k, v in res["gaps"].items()}
        _log(f"[learners] {name} card vs CPU at {_LEARNER_PARITY_ROWS} "
             f"rows (CPU train {cpu_s:.2f}s): bitwise {res['exact']}, "
             f"gaps {gaps}, ok {res['ok']}")
        if not res["ok"]:
            raise RuntimeError(f"learners: {name} differs between card "
                               "and CPU")
        out[name]["parity"] = dict(res, cpu_s=cpu_s)
    return out


def _launch_counts(hist_op, shap_kernel) -> dict:
    """B1-B4 launches since the counts were last set to 0: B1 the
    single-tree histograms outside the partitioned regime, B2 the
    partitioned single-tree ones, B3 every launch over K > 1 trees, B4
    the TreeSHAP kernel."""
    lau, bat = hist_op.LAUNCHES, hist_op.BATCHED_LAUNCHES
    return {"b1": sum(lau[r] - bat[r] for r in lau if r != "partitioned"),
            "b2": lau["partitioned"] - bat["partitioned"],
            "b3": sum(bat.values()),
            "b4": shap_kernel.flat_shap_tab_kernel.launches}


def _reset_counts(hist_op, shap_kernel) -> None:
    hist_op.reset_launches()
    shap_kernel.reset_launches()


def _stats_poller(url: str, budget: int, stop):
    """Samples GET /3/Stats every 0.5 s until ``stop``; returns
    (thread, record of samples and the samples over the budget)."""
    from tools.score_load import _get_json

    rec = {"samples": 0, "over_budget": 0, "max_resident_bytes": 0}

    def run():
        while not stop.is_set():
            st = _get_json(url + "/3/Stats", timeout=5.0)
            if st:
                rb = int(st["scorer_cache"]["resident_bytes"])
                rec["samples"] += 1
                rec["max_resident_bytes"] = max(rec["max_resident_bytes"],
                                                rb)
                rec["over_budget"] += rb > budget
            stop.wait(0.5)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, rec


def _explain_leg(url: str, keys: list, columns: list, seconds: float,
                 workers: int, seed: int) -> dict:
    """Closed-loop contributions traffic: ``workers`` threads, each
    request ``X-H2O-SLO: explain``, _SR_REQ_ROWS rows, its tenant drawn
    Zipf(_SR_ZIPF_S) over ``keys``."""
    from tools.datasets import zipf_probs
    from tools.score_load import (_make_bodies, _percentile_ms,
                                  _post_json)

    probs = zipf_probs(len(keys), _SR_ZIPF_S)
    bodies = _make_bodies(columns, _SR_REQ_ROWS, seed + 2)
    lock = threading.Lock()
    out = {"requests": 0, "fivexx": 0, "shed": 0, "fourxx": 0,
           "errors": 0, "bad_shape": 0}
    lat: list[float] = []
    deadline = time.perf_counter() + seconds

    def worker(w):
        rng = np.random.default_rng(seed * 100 + w)
        i = w
        while time.perf_counter() < deadline:
            key = keys[int(rng.choice(len(keys), p=probs))]
            t0 = time.perf_counter()
            try:
                r = _post_json(f"{url}/3/Predictions/models/{key}/"
                               "contributions", bodies[i % len(bodies)],
                               timeout=60.0,
                               headers={"X-H2O-SLO": "explain"})
                ok = len(r["contributions"]) == _SR_REQ_ROWS and \
                    len(r["contributions"][0]) == len(columns) + 1
                with lock:
                    out["requests"] += 1
                    out["bad_shape"] += not ok
                    lat.append(time.perf_counter() - t0)
            except urllib.error.HTTPError as e:
                e.read()
                with lock:
                    out["requests"] += 1
                    if e.code >= 500:
                        out["fivexx"] += 1
                    elif e.code == 429:
                        out["shed"] += 1
                    else:
                        out["fourxx"] += 1
            except Exception:  # noqa: BLE001 — counted, the leg goes on
                with lock:
                    out["errors"] += 1
            i += 1

    ts = [threading.Thread(target=worker, args=(w,), daemon=True)
          for w in range(workers)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    out.update(wall_s=wall, p50_ms=_percentile_ms(lat, 0.5),
               p99_ms=_percentile_ms(lat, 0.99),
               rows_per_s=len(lat) * _SR_REQ_ROWS / wall)
    return out


def _rest_rows(model, X: np.ndarray) -> list:
    """A [n, F] design matrix as JSON rows in the model's feature order:
    enum codes as their training labels, NaN as null."""
    doms = model.feature_domains
    rows = []
    for r in X:
        row = []
        for name, v in zip(model.feature_names, r):
            if np.isnan(v):
                row.append(None)
            elif name in doms:
                row.append(doms[name][int(v)])
            else:
                row.append(float(v))
        rows.append(row)
    return rows


def _serving_bases(n: int) -> list:
    """``n`` GBMs of the serving model's shape (28 features, 20 trees of
    depth 5, sample_rate 0.8, seeds 1..n) on one frame of _SR_TRAIN_ROWS
    HIGGS-shaped rows (its bins fit once, a row sample per seed)."""
    from h2o_kubernetes_tpu_torch import GBM, Frame

    cols, dom = _higgs_cols(_SR_TRAIN_ROWS, 290)
    bframe = Frame.from_arrays(cols, domains=dom)
    return [GBM(ntrees=20, max_depth=5, sample_rate=0.8, seed=b + 1).train(
        y="y", training_frame=bframe) for b in range(n)]


def _storm(url: str, hot_key: str, tail_key: str, columns: list,
           fair: bool, seed: int) -> dict:
    """One ``tools/score_load._storm_leg`` (_SR_STORM_S long) against the
    replica at ``url``, its clients where _SR_STORM_CLIENTS says, with
    the server-side spans of its admitted requests from the trace ring
    (``_storm_spans``). The leg's 17 client threads in the server's own
    interpreter contend with its batcher for the GIL, which stretches
    the dispatch the tail's deadline waits on (ROADMAP C11); a replica's
    clients never share its interpreter, so by default they run in a
    process of their own. The leg sets its admission knobs in the
    process it runs in: they are set here too, in the server's, to the
    values it sets."""
    from h2o_kubernetes_tpu_torch.runtime import telemetry
    from tools import score_load

    kw = dict(url=url, hot_key=hot_key, tail_key=tail_key,
              columns=columns, fair=fair, seconds=_SR_STORM_S, seed=seed)
    telemetry.TRACER.clear()
    if _SR_STORM_CLIENTS == "threads":
        res = score_load._storm_leg(**kw)
    else:
        os.environ.update(H2O_TPU_SCORE_FAIRNESS="1" if fair else "0",
                          H2O_TPU_SCORE_QUEUE_MAX="8",
                          H2O_TPU_SCORE_BATCH_US="20000")
        code = ("import json, sys; from tools import score_load; "
                "print(json.dumps(score_load._storm_leg("
                "**json.loads(sys.argv[1]))))")
        r = subprocess.run(
            [sys.executable, "-c", code, json.dumps(kw)],
            cwd=str(Path(__file__).resolve().parent), capture_output=True,
            text=True, timeout=_SR_STORM_S + 120)
        if r.returncode:
            raise RuntimeError(f"the storm's client process exited "
                               f"{r.returncode}: {r.stderr[-2000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
    res["clients"] = _SR_STORM_CLIENTS
    res["spans"] = _storm_spans(telemetry.TRACER.records(),
                                {"hot": hot_key, "tail": tail_key})
    return res


def _storm_spans(records: list, models: dict) -> dict:
    """Per role in ``models`` (role -> model key), the count of that
    model's requests in ``records`` that were admitted (not shed: 504s
    count) and each of their server-side spans (admission, queue,
    assemble, dispatch, total) as [median, max] ms."""
    out = {}
    for role, key in models.items():
        spans: dict = {}
        admitted = [rec for rec in records if rec.get("model") == key
                    and rec.get("outcome") != "QueueFullError"]
        for rec in admitted:
            for s in rec["spans"]:
                spans.setdefault(s["name"], []).append(s["ms"])
        out[role] = {"admitted": len(admitted), **{
            name: [round(statistics.median(v), 3), max(v)]
            for name, v in spans.items()}}
    return out


def _phase_serving_remainder(c) -> dict:
    """29. serving remainder (ROADMAP item 7b-2): the multi-tenant
    replica and the H2O REST API on the card, through ``start_server()``.
    a. four base GBMs of the serving model's shape trained here on one
    frame of HIGGS-shaped rows (a row sample each), published to a registry and pushed to 100 tenant
    keys (``push_many(require=True)``, warm bucket 128); every tenant
    scored once (predictions and contributions), then
    H2O_TPU_SCORER_CACHE_BYTES set to a quarter of the tenants' charge
    and ``tools/score_load.run_load_zipf`` driven at the reference
    bench's settings (stdlib and numpy only: checked that it reaches
    nothing of the JAX package); b. an explain leg; c. one tenant
    evicted and scored again, bitwise; d. ``tools/score_load._storm_leg``
    with fairness on, then off (``_storm``: its clients in a process of
    their own); e. ``/3/ImportFiles`` + ``/3/Parse`` of
    phase 26's CSV, ``/3/ModelBuilders/gbm`` at phase 26's parameters
    polled through ``/3/Jobs`` and held against an in-process train on
    the same frame (metrics within _SR_GBM_LIMIT, trees up to float64
    near-ties), the frame predictions route, contributions of
    _SR_CONTRIB_ROWS rows, ``/3/AutoML`` at automl_wall_100k's shape
    against the in-process run's leaderboard, ``/3/Stats`` and one timed
    ``/metrics``. B1-B4 launches counted from 0 per leg: the tenants'
    push, warm-up and first scores (the base trains are set-up), the
    sweep, the explain leg, the storm, and each REST build, prediction
    and contributions call around its own request (the in-process
    reference runs count in no leg).
    Gated: every /3/Stats sample within the budget, evictions and
    promotions > 0, no 5xx in the sweep and the explain leg, evict ->
    promote bitwise, the fair storm's tail SLO met, the REST GBM and the
    AutoML leaderboard as stated, B4 > 0 on the explain leg and B1 > 0
    on the REST builds. The unfair storm is reported."""
    import shutil

    from tools import score_load

    from h2o_kubernetes_tpu_torch import GBM, AutoML, ModelRegistry
    from h2o_kubernetes_tpu_torch.models.base import (evict_scorer_cache,
                                                      scorer_cache_stats)

    torch, card, rest = c.torch, c.card, c.rest
    hist_op, shap_kernel = c.hist_op, c.shap_kernel
    knobs = ("H2O_TPU_SCORER_CACHE_BYTES", "H2O_TPU_SCORE_FAIRNESS",
             "H2O_TPU_SCORE_QUEUE_MAX", "H2O_TPU_SCORE_BATCH_US")
    saved = {k: os.environ.get(k) for k in knobs}
    work = Path(c.frame_work)
    regdir = work / "registry"
    t_phase = time.perf_counter()
    legs: dict = {}
    launches: dict = {}
    out: dict = {}
    evict_scorer_cache()            # the earlier phases' models leave
    rest.BATCHER.reset()            # phase 17 stopped it
    srv = c.start_server(port=0)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        # -- a. the tenants and the Zipf sweep ------------------------------
        t0 = time.perf_counter()
        reg = ModelRegistry(str(regdir))
        c.sr_bases = _serving_bases(_SR_BASES)    # phase 30 serves them too
        for b, m in enumerate(c.sr_bases):
            reg.publish(m, f"base{b}")
        columns = list(m.feature_names)
        keys = [f"m{i:03d}" for i in range(_SR_TENANTS)]
        legs["train_bases_s"] = time.perf_counter() - t0
        # the base trains are set-up: the tenants' leg counts from here
        _reset_counts(hist_op, shap_kernel)
        t0 = time.perf_counter()
        loaded = reg.push_many(url, [(f"base{i % _SR_BASES}", 1, k)
                                     for i, k in enumerate(keys)],
                               warm_buckets=[128])
        legs["push_s"] = time.perf_counter() - t0
        ready = score_load._get_json(url + "/readyz")
        if len(loaded) != _SR_TENANTS or not all(
                o["contributions"] for o in loaded) or not ready:
            raise RuntimeError("serving remainder: the tenant push failed")
        rest.install_pool_replica_gate()
        t0 = time.perf_counter()
        body = score_load._make_bodies(columns, _SR_REQ_ROWS, 29, pool=1)[0]
        for k in keys:
            for route in ("", "/contributions"):
                code, r = _post(srv.server_address[1],
                                f"/3/Predictions/models/{k}{route}", body)
                if code != 200:
                    raise RuntimeError(f"tenant {k}{route}: {code} {r}")
        legs["score_all_s"] = time.perf_counter() - t0
        launches["a_tenants"] = _launch_counts(hist_op, shap_kernel)
        charge = sum(rest.MODELS[k]._serving_resident_bytes() for k in keys)
        # each base's charge (tenant b serves base b), for phase 30
        c.sr_base_charge = [rest.MODELS[keys[b]]._serving_resident_bytes()
                            for b in range(_SR_BASES)]
        budget = charge // 4
        os.environ["H2O_TPU_SCORER_CACHE_BYTES"] = str(budget)
        # the lowered budget holds from the next call on
        rest.MODELS[keys[0]].score_numpy(
            np.zeros((_SR_REQ_ROWS, len(columns)), np.float32))
        s0 = scorer_cache_stats()
        _log(f"[serving] {_SR_BASES} base GBMs (28 features, 20 trees of "
             f"depth 5, sample_rate 0.8 of {_SR_TRAIN_ROWS} HIGGS-shaped "
             f"rows) trained in "
             f"{legs['train_bases_s']:.2f}s; pushed to {_SR_TENANTS} tenant "
             f"keys with push_many(require=True) in {legs['push_s']:.2f}s; "
             f"every tenant scored and explained once in "
             f"{legs['score_all_s']:.2f}s; the tenants' device-state "
             f"charge {charge} bytes, budget {budget} bytes (a quarter); "
             f"resident now {s0['resident']} models, "
             f"{s0['resident_bytes']} bytes [{card}]")
        if s0["resident_bytes"] > budget:
            raise RuntimeError("serving remainder: the budget did not hold")
        _reset_counts(hist_op, shap_kernel)
        scrape_before = score_load._metrics_scrape(url)
        sweep = score_load.run_load_zipf(
            url, keys, columns, concurrency=_SR_CONCURRENCY,
            rows_per_request=_SR_REQ_ROWS, seconds=_SR_SWEEP_S,
            zipf_s=_SR_ZIPF_S, seed=c.seed)
        launches["a_sweep"] = _launch_counts(hist_op, shap_kernel)
        reached = sorted(m for m in sys.modules
                         if m == "jax" or m.startswith(("jax.",
                                                        "h2o_kubernetes_tpu.")))
        reached += [m for m in ("h2o_kubernetes_tpu",) if m in sys.modules]
        s1 = scorer_cache_stats()
        res = sweep["residency"]
        _log(f"[serving] Zipf sweep (s={_SR_ZIPF_S}, {_SR_TENANTS} tenants, "
             f"concurrency {_SR_CONCURRENCY}, {_SR_REQ_ROWS} rows, "
             f"{_SR_SWEEP_S:g}s): {sweep['value']} rows/s, "
             f"{sweep['requests']} requests, p50 {sweep['p50_ms']} ms, p99 "
             f"{sweep['p99_ms']} ms; p99 by popularity decile "
             f"{[d['p99_ms'] for d in sweep['deciles']]} ms; 5xx "
             f"{sweep['fivexx']}, shed {sweep['shed']}, errors "
             f"{sweep['errors']}; residency {res}; scorer cache evictions "
             f"{s1['evictions'] - s0['evictions']}, promotions "
             f"{s1['promotions'] - s0['promotions']} "
             f"({s1['promotion_s'] - s0['promotion_s']:.4f}s of device "
             f"rebuilds); launches {launches['a_sweep']}; modules of the "
             f"JAX package or jax loaded: {reached} [{card}]")
        if reached:
            raise RuntimeError(f"run_load_zipf reached {reached}")
        if sweep["fivexx"] or sweep["errors"] or not res["samples"] or \
                res["budget_exceeded"] or res["max_resident_bytes"] > budget:
            raise RuntimeError("serving remainder: the sweep served 5xx or "
                               "exceeded the byte budget")

        # -- b. contributions under the explain class -----------------------
        _reset_counts(hist_op, shap_kernel)
        stop = threading.Event()
        poll, polled = _stats_poller(url, budget, stop)
        try:
            explain = _explain_leg(url, keys, columns, _SR_EXPLAIN_S,
                                   _SR_EXPLAIN_WORKERS, c.seed)
        finally:
            stop.set()
            poll.join(10)
        launches["b_explain"] = _launch_counts(hist_op, shap_kernel)
        s2 = scorer_cache_stats()
        explain.update(polled, promotions=s2["promotions"] - s1["promotions"],
                       evictions=s2["evictions"] - s1["evictions"])
        _log(f"[serving] explain leg ({_SR_EXPLAIN_WORKERS} workers, "
             f"X-H2O-SLO: explain, {_SR_REQ_ROWS} rows, Zipf "
             f"{_SR_ZIPF_S}, {_SR_EXPLAIN_S:g}s): {explain}; launches "
             f"{launches['b_explain']} [{card}]")
        if explain["fivexx"] or explain["errors"] or explain["bad_shape"] \
                or explain["over_budget"] or not explain["samples"] or \
                launches["b_explain"]["b4"] <= 0:
            raise RuntimeError("serving remainder: the explain leg failed")
        if s2["evictions"] <= s0["evictions"] or \
                s2["promotions"] <= s0["promotions"]:
            raise RuntimeError("serving remainder: no eviction churn")

        # -- c. evict -> promote ----------------------------------------------
        probe = rest.MODELS[keys[-1]]
        Xp = np.random.default_rng(c.seed + 7).normal(
            size=(64, len(columns))).astype(np.float32)
        p_before, c_before = probe.score_numpy(Xp), probe.contrib_numpy(Xp)
        evict_scorer_cache(probe)
        p_after, c_after = probe.score_numpy(Xp), probe.contrib_numpy(Xp)
        bitwise = bool(np.array_equal(p_before, p_after)
                       and np.array_equal(c_before, c_after))
        _log(f"[serving] evict -> promote of {keys[-1]}: scores and "
             f"contributions bitwise {bitwise}")
        if not bitwise:
            raise RuntimeError("serving remainder: a promotion changed bits")

        # -- d. the storm, fair then unfair ------------------------------------
        _reset_counts(hist_op, shap_kernel)
        storm = {}
        for fair in (True, False):
            storm["fair" if fair else "unfair"] = _storm(
                url, keys[0], keys[-1], columns, fair, c.seed)
        for k in knobs[1:]:                  # the storm leaves them set
            if saved[k] is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = saved[k]
        launches["d_storm"] = _launch_counts(hist_op, shap_kernel)
        for leg, r in storm.items():
            _log(f"[serving] storm {leg} (clients: {r['clients']}): hot "
                 f"{r['hot']}, tail {r['tail']}, tail SLO met "
                 f"{r['tail_slo_met']}; server-side spans [median, max] ms "
                 f"{r['spans']} [{card}]")
        if not storm["fair"]["tail_slo_met"]:
            raise RuntimeError("serving remainder: the fair storm missed "
                               "the tail's SLO")

        # -- e. the REST API: each route's launches counted from 0 around
        # its own call; the in-process reference runs are counted nowhere
        y = "IsDepDelayed"
        csv = str(work / "airlines.csv")
        port = srv.server_address[1]
        t0 = time.perf_counter()
        code, fr_schema = _post(port, "/3/ImportFiles",
                                {"path": csv, "destination_frame": "air"})
        legs["import_s"] = time.perf_counter() - t0
        if code != 200 or fr_schema["rows"] != _FRAME_ROWS:
            raise RuntimeError(f"ImportFiles: {code} {fr_schema}")
        kw = dict(ntrees=_FRAME_TREES, max_depth=_FRAME_DEPTH, seed=1)
        _reset_counts(hist_op, shap_kernel)
        t0 = time.perf_counter()
        code, built = _post(port, "/3/ModelBuilders/gbm", {
            "training_frame": "air", "response_column": y,
            "model_id": "air_gbm", **kw})
        legs["rest_gbm_s"] = time.perf_counter() - t0
        gbm_launches = _launch_counts(hist_op, shap_kernel)
        launches["e_rest_gbm"] = gbm_launches
        jobs = score_load._get_json(url + "/3/Jobs") or {"jobs": []}
        done = [j["status"] for j in jobs["jobs"] if j["dest"] == "air_gbm"]
        if code != 200 or done != ["DONE"]:
            raise RuntimeError(f"ModelBuilders/gbm: {code} {built} {done}")
        frame = rest.FRAMES["air"]
        m_rest = rest.MODELS["air_gbm"]
        t0 = time.perf_counter()
        m_local = GBM(**kw).train(y=y, training_frame=frame)
        torch.cuda.synchronize()
        legs["local_gbm_s"] = time.perf_counter() - t0
        h_rest = m_rest.scoring_history[-1]
        h_local = m_local.scoring_history[-1]
        gaps = {k: abs(h_rest[k] - h_local[k])
                for k in ("train_auc", "train_logloss")}
        compared, ties, leaf_gap = _near_ties(m_rest, m_local, frame, y, {})
        _reset_counts(hist_op, shap_kernel)
        t0 = time.perf_counter()
        code, pred = _post(port, "/3/Predictions/models/air_gbm/frames/air",
                           {})
        legs["predict_frame_s"] = time.perf_counter() - t0
        launches["e_rest_predict_frame"] = _launch_counts(hist_op,
                                                          shap_kernel)
        pf = rest.FRAMES[pred["predictions_frame"]["name"]]
        p_direct = m_rest.predict_raw(frame)
        pred_equal = pf.nrows == _FRAME_ROWS and bool(np.array_equal(
            pf[f"p{m_rest.response_domain[1]}"].to_numpy(), p_direct[:, 1]))
        X = m_rest._design_matrix(frame)[:_SR_CONTRIB_ROWS].cpu().numpy()
        rows = _rest_rows(m_rest, X)
        body = {"rows": rows, "columns": list(m_rest.feature_names)}
        _reset_counts(hist_op, shap_kernel)
        code, cr = _post(port, "/3/Predictions/models/air_gbm/contributions",
                         body)
        launches["e_rest_contrib"] = _launch_counts(hist_op, shap_kernel)
        contrib_b4 = launches["e_rest_contrib"]["b4"]
        _reset_counts(hist_op, shap_kernel)
        code_p, pr = _post(port, "/3/Predictions/models/air_gbm", body)
        launches["e_rest_predict_rows"] = _launch_counts(hist_op,
                                                         shap_kernel)
        if code != 200 or code_p != 200:
            raise RuntimeError(f"REST contributions/predictions: {code} "
                               f"{code_p}")
        phi = np.asarray(cr["contributions"], dtype=np.float64)
        p1 = np.asarray(pr[f"p{m_rest.response_domain[1]}"],
                        dtype=np.float64)
        add = float(np.abs(phi.sum(axis=1) - np.log(p1 / (1 - p1))).max())
        phi_equal = bool(np.array_equal(np.float32(phi),
                                        m_rest.contrib_numpy(X)))
        rest_gbm = {"rows": frame.nrows, "features": len(columns),
                    "import_s": legs["import_s"],
                    "rest_build_s": legs["rest_gbm_s"],
                    "local_train_s": legs["local_gbm_s"],
                    "metrics_rest": {k: h_rest[k] for k in gaps},
                    "metrics_local": {k: h_local[k] for k in gaps},
                    "gaps": gaps, "nodes_compared": compared,
                    "near_ties": len(ties), "leaf_gap": leaf_gap,
                    "predict_frame_s": legs["predict_frame_s"],
                    "predictions_equal": pred_equal,
                    "contrib_rows": len(rows), "contrib_b4": contrib_b4,
                    "contrib_equal_direct": phi_equal,
                    "additivity": add, "launches": gbm_launches}
        _log(f"[serving] REST API: ImportFiles of phase 26's "
             f"{_FRAME_ROWS}-row CSV {legs['import_s']:.3f}s; ModelBuilders/"
             f"gbm ({kw}) {legs['rest_gbm_s']:.3f}s (job DONE in /3/Jobs), "
             f"in-process train on the same frame {legs['local_gbm_s']:.3f}s;"
             f" train auc/logloss REST {h_rest['train_auc']:.6f}/"
             f"{h_rest['train_logloss']:.6f} against "
             f"{h_local['train_auc']:.6f}/{h_local['train_logloss']:.6f} "
             f"(gaps {gaps}, limit {_SR_GBM_LIMIT:.0e}); {compared} nodes "
             f"compared, near-ties {ties}, largest leaf gap {leaf_gap:.3e}; "
             f"frame predictions {legs['predict_frame_s']:.3f}s, equal to "
             f"predict_raw {pred_equal}; contributions of {len(rows)} rows: "
             f"{contrib_b4} B4 launches, equal to contrib_numpy {phi_equal},"
             f" additivity {add:.3e}; launches around the build "
             f"{gbm_launches} [{card}]")
        if max(gaps.values()) > _SR_GBM_LIMIT or not pred_equal or \
                not phi_equal or add > 1e-4 or gbm_launches["b1"] <= 0 or \
                contrib_b4 <= 0:
            raise RuntimeError("serving remainder: the REST GBM disagrees")
        # AutoML at automl_wall_100k's shape on the CSV's first rows
        aml_csv = str(work / "airlines_100k.csv")
        with open(csv) as src, open(aml_csv, "w") as dst:
            for i, line in enumerate(src):
                if i > _SR_AML_ROWS:
                    break
                dst.write(line)
        code, parsed = _post(port, "/3/Parse", {
            "source_frames": [aml_csv], "destination_frame": "air100k"})
        if code != 200 or parsed["rows"] != _SR_AML_ROWS:
            raise RuntimeError(f"Parse: {code} {parsed}")
        aml_kw = {"max_models": 2, "nfolds": 3,
                  "include_algos": ["glm", "gbm"], "seed": 1}
        _reset_counts(hist_op, shap_kernel)
        t0 = time.perf_counter()
        code2, job = _post(port, "/3/AutoML", {
            "training_frame": "air100k", "response_column": y,
            "project_name": "aml_rest", **aml_kw})
        legs["rest_automl_s"] = time.perf_counter() - t0
        aml_launches = _launch_counts(hist_op, shap_kernel)
        launches["e_rest_automl"] = aml_launches
        lb = score_load._get_json(url + "/3/AutoML/aml_rest") or {}
        if code2 != 200 or job["job"]["status"] != "DONE":
            raise RuntimeError(f"AutoML over REST: {code2} {job}")
        t0 = time.perf_counter()
        local = AutoML(project_name="aml_rest", verbosity=None,
                       **aml_kw).train(y=y,
                                       training_frame=rest.FRAMES["air100k"])
        legs["local_automl_s"] = time.perf_counter() - t0
        ids_rest = [r["model_id"] for r in lb.get("leaderboard", [])]
        ids_local = [r["model_id"] for r in local.leaderboard.as_list()]
        automl = {"rows": _SR_AML_ROWS, **aml_kw,
                  "rest_s": legs["rest_automl_s"],
                  "local_s": legs["local_automl_s"],
                  "leaderboard_rest": lb.get("leaderboard"),
                  "leaderboard_local": local.leaderboard.as_list(),
                  "same_ids_and_order": ids_rest == ids_local,
                  "launches": aml_launches}
        _log(f"[serving] AutoML over REST ({_SR_AML_ROWS} rows, {aml_kw}): "
             f"{legs['rest_automl_s']:.3f}s, leaderboard {ids_rest}; "
             f"in-process on the same frame {legs['local_automl_s']:.3f}s, "
             f"{ids_local}; same ids and order {ids_rest == ids_local}; "
             f"launches around the REST run {aml_launches} [{card}]")
        if ids_rest != ids_local or not ids_rest or aml_launches["b1"] <= 0:
            raise RuntimeError("serving remainder: the AutoML leaderboards "
                               "differ")
        stats = score_load._get_json(url + "/3/Stats") or {}
        scrape_after = score_load._metrics_scrape(url)
        _log(f"[serving] /3/Stats scorer_cache {stats.get('scorer_cache')}, "
             f"batcher {stats.get('batcher')}, counters "
             f"{stats.get('counters')}; GET /metrics before the sweep "
             f"{scrape_before}, after {scrape_after} [{card}]")
        if not (scrape_after["ok"] and stats.get("scorer_cache")):
            raise RuntimeError("serving remainder: /3/Stats or /metrics")
        total = {k: sum(v[k] for v in launches.values())
                 for k in ("b1", "b2", "b3", "b4")}
        out = {"tenants": _SR_TENANTS, "bases": _SR_BASES,
               "charge_bytes": charge, "budget_bytes": budget,
               "sweep": {k: sweep[k] for k in (
                   "value", "requests", "p50_ms", "p95_ms", "p99_ms",
                   "fivexx", "shed", "errors", "deciles", "residency")},
               "explain": explain, "evict_promote_bitwise": bitwise,
               "storm": storm, "rest_gbm": rest_gbm, "automl": automl,
               "scorer_cache": stats.get("scorer_cache"),
               "metrics_scrape": {"before": scrape_before,
                                  "after": scrape_after},
               "legs_s": legs, "launches": launches,
               "launches_total": total}
    finally:
        rest.stop_server(srv)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        rest.READINESS_GATES.clear()
        rest.REQUIRED_MODEL_IDS.clear()
        for store in (rest.MODELS, rest.REGISTRY_MODELS, rest.FRAMES,
                      rest.AUTOML, rest.MODEL_STATS):
            store.clear()
        shutil.rmtree(regdir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"[serving] phase 29 {out['phase_s']:.1f}s; B1-B4 launches by leg "
         f"{launches}, total {out['launches_total']} [{card}]")
    return out


def _sigv4_expected(method: str, path_qs: str, headers, payload: bytes,
                    secret: str) -> str:
    """The SigV4 signature recomputed from a request as a server sees
    it (what minio and localstack verify), from the AWS specification."""
    import hashlib
    import hmac

    auth = headers.get("Authorization", "")
    cred = auth.split("Credential=")[1].split(",")[0]
    signed = auth.split("SignedHeaders=")[1].split(",")[0]
    _akid, datestamp, region, service, _term = cred.split("/")
    path, _, query = path_qs.partition("?")
    canon = "".join(f"{h}:{headers.get(h).strip()}\n"
                    for h in signed.split(";"))
    canonical = "\n".join([method, path, query, canon, signed,
                           hashlib.sha256(payload).hexdigest()])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", headers["x-amz-date"], scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])

    def _k(key, msg):
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _k(_k(_k(_k(b"AWS4" + secret.encode(), datestamp), region),
               service), "aws4_request")
    return hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()


def _fake_s3(secret: str):
    """A local S3 (path-style GET and PUT) that verifies every request's
    SigV4 signature, as the persist tests' fake does: (server, url,
    counts of verified and refused requests). No network."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    objects: dict = {}
    counts = {"verified": 0, "refused": 0, "get": 0, "put": 0}
    lock = threading.Lock()

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _signed(self, payload: bytes) -> bool:
            auth = self.headers.get("Authorization", "")
            ok = auth.startswith("AWS4-HMAC-SHA256") and _sigv4_expected(
                self.command, self.path, self.headers, payload,
                secret) == auth.split("Signature=")[1]
            with lock:
                counts["verified" if ok else "refused"] += 1
            return ok

        def do_GET(self):
            key = self.path.split("?", 1)[0]
            if not self._signed(b""):
                self.send_response(403)
                self.end_headers()
                return
            with lock:
                body = objects.get(key)
                counts["get"] += 1
            if body is None:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_PUT(self):
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))
            ok = self._signed(body)
            if ok:
                with lock:
                    objects[self.path.split("?", 1)[0]] = body
                    counts["put"] += 1
            self.send_response(200 if ok else 403)
            self.end_headers()

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}", counts


def _pod_urls(pool) -> list:
    """The READY replicas' URLs of every shard of ``pool``."""
    urls = []
    for rec in pool.recs.values():
        with rec._lock:
            urls.extend(r.url for r in rec.replicas if r.state == "READY")
    return urls


def _pods_kernels(urls: list, reset: bool = False) -> dict:
    """B1-B4 launches summed over the pods at ``urls`` (each pod's
    ``/3/Kernels``; ``reset`` sets them to 0 first)."""
    from tools.score_load import _get_json

    tot = {"b1": 0, "b2": 0, "b3": 0, "b4": 0, "pods": 0}
    for u in urls:
        if reset:
            code, out = _post(int(u.rsplit(":", 1)[1]), "/3/Kernels/reset",
                              {})
            out = out if code == 200 else None
        else:
            out = _get_json(u + "/3/Kernels", timeout=10.0)
        if out is None:
            raise RuntimeError(f"fleet: {u}/3/Kernels unreachable")
        for k in ("b1", "b2", "b3", "b4"):
            tot[k] += int(out["launches"][k])
        tot["pods"] += 1
    return tot


def _pods_poller(urls_fn, budget: int, stop):
    """Samples every pod's GET /3/Stats each 0.5 s until ``stop``:
    (thread, record of samples, the largest resident_bytes and the
    samples over ``budget``)."""
    from tools.score_load import _get_json

    rec = {"samples": 0, "over_budget": 0, "max_resident_bytes": 0,
           "evictions": {}, "promotions": {}}

    def run():
        while not stop.is_set():
            for u in urls_fn():
                st = _get_json(u + "/3/Stats", timeout=5.0)
                if not st:
                    continue
                sc = st["scorer_cache"]
                rb = int(sc["resident_bytes"])
                rec["samples"] += 1
                rec["max_resident_bytes"] = max(rec["max_resident_bytes"],
                                                rb)
                rec["over_budget"] += rb > budget
                rec["evictions"][u] = sc["evictions"]
                rec["promotions"][u] = sc["promotions"]
            stop.wait(0.5)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, rec


def _zipf_leg(targets, keys, columns, seconds, seed, router, stop=None):
    """tools/score_load.run_load_zipf at the sweep's settings, reduced
    to the figures phase 30 reports."""
    from tools.score_load import run_load_zipf

    out = run_load_zipf(targets, keys, columns, concurrency=_SR_CONCURRENCY,
                        rows_per_request=_SR_REQ_ROWS, seconds=seconds,
                        zipf_s=_SR_ZIPF_S, seed=seed, router=router,
                        stop_event=stop)
    dec = out.get("deciles") or [{}]
    return {"rows_per_s": out["value"], "requests": out["requests"],
            "p50_ms": out["p50_ms"], "p99_ms": out["p99_ms"],
            "head_p99_ms": dec[0].get("p99_ms"),
            "tail_p99_ms": dec[-1].get("p99_ms"),
            "fivexx": out["fivexx"], "fivexx_sample": out["fivexx_sample"],
            "errors": out["errors"], "error_sample": out["error_sample"],
            "degraded": out.get("degraded", 0), "shed": out.get("shed", 0),
            "target_failovers": out.get("target_failovers", 0),
            "by_model": out["by_model"]}


def _route_post(url: str, key: str, body: dict, route: str = "",
                attempts: int = 60, sleep: float = 0.25):
    """POST one request through the router, retrying a typed 503 or a
    transport error (a re-placement may still be landing): (status,
    JSON)."""
    import urllib.error
    import urllib.request

    code, out = None, None
    for _ in range(attempts):
        req = urllib.request.Request(
            f"{url}/3/Predictions/models/{key}{route}",
            data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            code, out = e.code, e.read()
            if code != 503:
                return code, out
        except OSError as e:
            code, out = -1, repr(e)
        time.sleep(sleep)
    return code, out


def _phase_fleet(c) -> dict:
    """30. the fleet (ROADMAP item 13): the operator, the sharded pool and
    the front-door router over port pods that serve B4 on the card
    (``c.fleet_device``: None, the card; the CPU rehearsal passes "cpu").
    See the module docstring's phase 30 for the legs and their gates.
    The pods and the router are processes of their own, so none shares
    the load generator's interpreter; their kernels are counted through
    each pod's ``/3/Kernels``, set to 0 just before a leg and read just
    after it. Every pod, the router and the fake object store are
    stopped before the phase returns."""
    import re

    from h2o_kubernetes_tpu_torch import ModelRegistry
    from h2o_kubernetes_tpu_torch.models.base import evict_scorer_cache
    from h2o_kubernetes_tpu_torch.operator import (DurablePoolStore,
                                                   ScorerPoolSpec,
                                                   ShardedPool, load_artifact)
    from tools.score_load import _get_json, _make_bodies

    torch, card = c.torch, c.card
    hist_op, shap_kernel = c.hist_op, c.shap_kernel
    device = getattr(c, "fleet_device", None)
    on_card = device is None or str(device).startswith("cuda")
    repo = Path(__file__).resolve().parent
    work = repo / "build" / "fleet"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    legs_s: dict = {}
    secret = "fleet-secret"
    s3, s3_url, s3_counts = _fake_s3(secret)
    knobs = {"AWS_ENDPOINT_URL": s3_url, "AWS_ACCESS_KEY_ID": "AKIDFLEET",
             "AWS_SECRET_ACCESS_KEY": secret, "AWS_REGION": "us-east-1",
             "H2O_TPU_POOL_STARTUP_DEADLINE": str(_FL_STARTUP_S)}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    pools: dict = {}
    runs: list = []
    router = None
    out: dict = {}
    evict_scorer_cache()
    if on_card:
        torch.cuda.empty_cache()    # the earlier phases' cached blocks
    try:
        # -- the catalog on s3://, its charge measured on the device ------
        t0 = time.perf_counter()
        bases = (getattr(c, "sr_bases", None) or
                 _serving_bases(_FL_BASES))[:_FL_BASES]
        reg = ModelRegistry("s3://fleet/registry")
        for b, m in enumerate(bases):
            reg.publish(m, f"base{b}")
        columns = list(bases[0].feature_names)
        keys = [f"m{i:03d}" for i in range(_FL_TENANTS)]
        entries = [(f"base{i % _FL_BASES}", 1, k) for i, k in
                   enumerate(keys)]
        served = {}

        def serve_bases(bases=range(_FL_BASES)):
            """Each base in-process on the device, warmed as a pod's push
            warms it and scored once: the reference of leg c."""
            for b in bases:
                if f"base{b}" in served:
                    continue
                m = load_artifact(reg.fetch(f"base{b}", 1), device=device)
                m.warm_up([128], contributions=True)
                m.score_numpy(np.zeros((_SR_REQ_ROWS, len(columns)),
                                       np.float32))
                served[f"base{b}"] = m

        # a base's charge: phase 29 measured it on its replica (tenant b
        # served base b there), else it is measured here
        per = list(getattr(c, "sr_base_charge", None) or [])[:_FL_BASES]
        if len(per) < _FL_BASES:
            serve_bases()
            per = [served[f"base{b}"]._serving_resident_bytes()
                   for b in range(_FL_BASES)]
        charge = sum(per[i % _FL_BASES] for i in range(_FL_TENANTS))
        budget = charge // 4
        legs_s["catalog_s"] = time.perf_counter() - t0

        # -- e. profile, device memory, cluster status: in a process of
        # its own (started now, read after leg d), since this long-lived
        # process's later torch.profiler sessions record no device
        # activity (PERF.md §7) -------------------------------------------
        t0 = time.perf_counter()
        dev_name = torch.cuda.get_device_name(0) if on_card else "cpu"
        X = np.random.default_rng(c.seed + 30).normal(
            size=(_SR_REQ_ROWS, len(columns))).astype(np.float32)
        np.save(work / "surfaces_x.npy", X)
        surf_proc = subprocess.Popen(
            [sys.executable, str(repo / "chip_smoke.py"), "--fleet-surfaces",
             str(work), "cuda" if on_card else "cpu"],
            cwd=str(repo), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        legs_s["surfaces_start_s"] = time.perf_counter() - t0

        # -- the sharded fleet, the direct pool and the router ------------
        t0 = time.perf_counter()
        store = DurablePoolStore(str(work / "store"))
        env = {"H2O_TPU_SCORER_CACHE_BYTES": str(budget)}
        for name, shards, replicas, head in (
                ("fleet", _FL_SHARDS, 1, _FL_HEAD),
                ("direct", 1, _FL_SHARDS, 1)):
            store.apply(ScorerPoolSpec(
                name=name, artifact="base0", version=1, model_key=keys[0],
                replicas=replicas, shards=shards, head_models=head,
                tail_replicas=1, warm_buckets=(128,),
                extra_artifacts=tuple(entries[1:]), env=env))
            pool = ShardedPool(store, reg, name, device=device,
                               workdir=str(work / "pods" / name),
                               log_dir=str(work / "logs" / name))
            stop = threading.Event()
            th = threading.Thread(target=pool.run, args=(stop,),
                                  kwargs={"interval": 0.25}, daemon=True)
            th.start()
            pools[name] = pool
            runs.append((pool, stop, th))
        rlog = work / "router.log"
        with open(rlog, "ab") as lf:
            router = subprocess.Popen(
                [sys.executable, "-m",
                 "h2o_kubernetes_tpu_torch.operator.router",
                 "--store", str(work / "store"), "--pool", "fleet",
                 "--port", "0"], cwd=str(repo), stdout=lf,
                stderr=subprocess.STDOUT, start_new_session=True,
                env=dict(os.environ, H2O_TPU_ROUTER_RETRY_BUDGET="20",
                         H2O_TPU_ROUTER_HEALTH_INTERVAL="0.25",
                         H2O_TPU_ROUTER_TABLE_INTERVAL="0.25"))
        serve_bases()                    # while the pods start
        for name, pool in pools.items():
            if not pool.wait_converged(timeout=_FL_CONVERGE_S):
                raise RuntimeError(f"fleet: pool {name} never converged: "
                                   f"{store.get_status(name)}")
        url = None
        deadline = time.monotonic() + 60
        while url is None and time.monotonic() < deadline:
            mm = re.search(r"ROUTER_UP port=(\d+)", rlog.read_text())
            if mm:
                url = f"http://127.0.0.1:{mm.group(1)}"
            elif router.poll() is not None:
                raise RuntimeError(f"fleet: the router exited: "
                                   f"{rlog.read_text()[-400:]}")
            else:
                time.sleep(0.2)
        body = _make_bodies(columns, _SR_REQ_ROWS, 30, pool=1)[0]
        code, _ = _route_post(url, keys[0], body)
        if code != 200:
            raise RuntimeError(f"fleet: the router does not serve "
                               f"{keys[0]}: {code}")
        fleet_urls = _pod_urls(pools["fleet"])
        direct_urls = _pod_urls(pools["direct"])
        legs_s["converge_s"] = time.perf_counter() - t0
        _log(f"[fleet] {_FL_TENANTS} tenants over {_FL_BASES} bases "
             f"(28 features, 20 trees of depth 5) on s3:// (fake store: "
             f"{s3_counts}); charge {charge} bytes ({per} a base), budget "
             f"{budget} bytes a pod; {_FL_SHARDS} shards x 1 pod + "
             f"{_FL_SHARDS} direct pods converged and the router ({url}) "
             f"serving in {legs_s['converge_s']:.1f}s [{card}]")

        # -- a. routed ------------------------------------------------------
        t0 = time.perf_counter()
        stop = threading.Event()
        poll, resid = _pods_poller(lambda: _pod_urls(pools["fleet"]),
                                   budget, stop)
        _pods_kernels(fleet_urls, reset=True)
        _reset_counts(hist_op, shap_kernel)
        routed = _zipf_leg([url], keys, columns, _FL_LEG_S, c.seed, True)
        routed["pod_launches"] = _pods_kernels(fleet_urls)
        routed["local_launches"] = _launch_counts(hist_op, shap_kernel)
        routed["router_stats"] = (_get_json(url + "/3/Stats") or
                                  {}).get("stats")
        stop.set()
        poll.join(10)
        routed["residency"] = resid
        routed.pop("by_model")
        # -- b. direct --------------------------------------------------------
        stop = threading.Event()
        poll, dresid = _pods_poller(lambda: direct_urls, budget, stop)
        direct = _zipf_leg(direct_urls, keys, columns, _FL_LEG_S, c.seed,
                           False)
        stop.set()
        poll.join(10)
        direct["residency"] = dresid
        direct.pop("by_model")
        legs_s["routed_direct_s"] = time.perf_counter() - t0
        ratio = None
        if routed["head_p99_ms"] and direct["head_p99_ms"]:
            ratio = routed["head_p99_ms"] / direct["head_p99_ms"]
        _log(f"[fleet] a. routed: {json.dumps(routed)} [{card}]")
        _log(f"[fleet] b. direct: {json.dumps(direct)}; head_p99_ratio "
             f"{ratio} (the reference's line {_FL_HEAD_P99_LINE}x) "
             f"[{card}]")
        if routed["fivexx"] or routed["errors"] or not resid["samples"] \
                or resid["over_budget"] or \
                resid["max_resident_bytes"] > budget:
            raise RuntimeError("fleet: the routed leg served 5xx or a pod "
                               "exceeded its byte budget")

        # -- c. correctness through the router ------------------------------
        t0 = time.perf_counter()
        check = keys[:_FL_CHECK_KEYS] + keys[-_FL_CHECK_KEYS:]
        rows = {"rows": _json_rows(X), "columns": columns}
        pred_equal, phi_bitwise, phi_gap = True, True, 0.0
        _pods_kernels(fleet_urls, reset=True)
        _reset_counts(hist_op, shap_kernel)
        for k in check:
            m = served[entries[keys.index(k)][0]]
            code, pr = _route_post(url, k, rows)
            code2, cr = _route_post(url, k, rows, "/contributions")
            if code != 200 or code2 != 200:
                raise RuntimeError(f"fleet: {k} through the router: "
                                   f"{code} {code2}")
            want = m.score_numpy(X)
            p1 = np.asarray(pr[f"p{m.response_domain[1]}"], np.float32)
            pred_equal &= bool(np.array_equal(p1, want[:, 1]))
            phi = np.asarray(cr["contributions"], np.float32)
            mine = m.contrib_numpy(X)
            phi_bitwise &= bool(np.array_equal(phi, mine))
            phi_gap = max(phi_gap, float(np.max(
                np.abs(phi - mine) - 1e-5 * np.abs(mine))))
        pod_b4 = _pods_kernels(fleet_urls)
        local_b4 = _launch_counts(hist_op, shap_kernel)["b4"]
        devices = {u: ((_get_json(u + "/3/Stats") or {}).get("build") or
                       {}).get("device") for u in fleet_urls}
        correct = {"tenants": check, "predictions_bitwise": pred_equal,
                   "contributions_bitwise": phi_bitwise,
                   "contributions_excess_over_rtol": phi_gap,
                   "pod_launches": pod_b4, "local_b4": local_b4,
                   "b4_per_contrib_request": pod_b4["b4"] / len(check),
                   "pod_devices": devices}
        legs_s["correct_s"] = time.perf_counter() - t0
        _log(f"[fleet] c. {json.dumps(correct)} [{card}]")
        if not pred_equal or not (phi_bitwise or phi_gap <= 1e-6) or \
                any(dev_name not in str(d) for d in devices.values()) or \
                (on_card and not 0 < pod_b4["b4"] == local_b4):
            raise RuntimeError("fleet: routed answers disagree with the "
                               "in-process scorer, or a pod is off the "
                               "card, or the pods' B4 launches are not "
                               "the in-process calls'")

        # -- d. a shard's pod SIGKILLed mid-storm ---------------------------
        t0 = time.perf_counter()
        fpool = pools["fleet"]
        head = set(keys[:_FL_HEAD])
        victim = next(sid for sid in sorted(fpool.recs)
                      if set(fpool.plan.keys_for(sid)) - head)
        orphans = sorted(set(fpool.plan.keys_for(victim)) - head)
        storm_stop, storm = threading.Event(), {}
        th = threading.Thread(target=lambda: storm.update(_zipf_leg(
            [url], keys, columns, 600.0, c.seed + 1, True, storm_stop)),
            daemon=True)
        th.start()
        time.sleep(0.5)                  # the storm under way
        with fpool.recs[victim]._lock:
            vpids = [r.pid() for r in fpool.recs[victim].replicas
                     if r.pid()]
        for pid in vpids:
            os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 30
        while fpool.shard_healthy(victim) and time.monotonic() < deadline:
            time.sleep(0.05)             # the death observed
        failed = []
        for k in orphans:
            code, _ = _route_post(url, k, body)
            if code != 200:
                failed.append((k, code))
        replaced = fpool.wait_converged(timeout=_FL_CONVERGE_S)
        storm_stop.set()
        th.join(60)
        rst = _get_json(url + "/3/Stats") or {}
        head_5xx = sum(storm["by_model"][k]["fivexx"] for k in head)
        kinds = [e["kind"] for e in store.events("fleet")]
        new_pids = [r.pid() for r in fpool.recs[victim].replicas
                    if r.state == "READY"]
        drill = {"victim": victim, "killed_pids": vpids,
                 "replacement_pids": new_pids, "orphans": len(orphans),
                 "orphans_not_served": failed, "replaced": replaced,
                 "head_5xx": head_5xx, "fivexx": storm["fivexx"],
                 "fivexx_sample": storm["fivexx_sample"][:3],
                 "errors": storm["errors"],
                 "error_sample": storm["error_sample"][:3],
                 "degraded": storm["degraded"],
                 "requests": storm["requests"],
                 "p99_ms": storm["p99_ms"],
                 "router_stats": rst.get("stats"),
                 "retry_budget": rst.get("retry_budget"),
                 "events": sorted(set(kinds) & {
                     "shard_down", "tenant_replaced", "shard_recovered",
                     "replica_died", "replica_ready"}),
                 "seconds": time.perf_counter() - t0}
        # the router's and the pods' slow routes and requests (>= 5 s) of
        # the whole phase, with the hops, attempts and spans they logged
        slow = [ln for f in [rlog, *sorted((work / "logs").rglob("*.log"))]
                for ln in f.read_text(errors="replace").splitlines()
                if "slow route:" in ln or "slow request:" in ln]
        drill["slow_logged"] = len(slow)
        drill["slow_sample"] = [ln[:600] for ln in slow[:6]]
        _log(f"[fleet] d. shard kill: {json.dumps(drill)} [{card}]")
        rs = rst.get("stats") or {}
        if failed or not replaced or head_5xx or storm["errors"] or \
                not new_pids or set(new_pids) & set(vpids) or \
                rs.get("retries") != (rst.get("retry_budget") or
                                      {}).get("granted"):
            raise RuntimeError("fleet: the shard-kill drill failed")

        t0 = time.perf_counter()
        sout, serr = surf_proc.communicate(timeout=120)
        if surf_proc.returncode != 0:
            raise RuntimeError(f"fleet: the surfaces process failed: "
                               f"{serr[-600:]}")
        surfaces = json.loads(sout.strip().splitlines()[-1])
        legs_s["surfaces_wait_s"] = time.perf_counter() - t0
        _log(f"[fleet] e. {json.dumps(surfaces)} [{card}]")
        mem, status = surfaces["device_memory"], surfaces["cluster_status"]
        if on_card and (not surfaces["trace_names_shap_tab"]
                        or not mem[0]["bytes_in_use"]
                        or not mem[0]["bytes_limit"]
                        or status["cloud_size"] != 1
                        or dev_name not in status["devices"][0]):
            raise RuntimeError("fleet: profile, device_memory or "
                               "cluster_status")
        out = {"tenants": _FL_TENANTS, "bases": _FL_BASES,
               "shards": _FL_SHARDS, "head": _FL_HEAD,
               "charge_bytes": charge, "budget_bytes": budget,
               "routed": routed, "direct": direct,
               "head_p99_ratio": ratio,
               "head_p99_line": _FL_HEAD_P99_LINE,
               "correct": correct, "drill": drill, "surfaces": surfaces,
               "s3": dict(s3_counts), "legs_s": legs_s}
    finally:
        t0 = time.perf_counter()
        surf = locals().get("surf_proc")
        if surf is not None and surf.poll() is None:
            surf.kill()
            surf.wait(15)
        if router is not None:
            router.terminate()
        for pool, stop, th in runs:
            stop.set()
        for pool, stop, th in runs:
            th.join(30)
        downs = [threading.Thread(target=pool.shutdown,
                                  kwargs={"timeout": 60})
                 for pool, _, _ in runs]
        for t in downs:
            t.start()
        for t in downs:
            t.join(90)
        if router is not None:
            try:
                router.wait(15)
            except subprocess.TimeoutExpired:
                router.kill()
                router.wait(15)
        _reap_pods(str(work))
        s3.shutdown()
        s3.server_close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for m in locals().get("served", {}).values():
            m._serving_evict()
        shutil.rmtree(work, ignore_errors=True)
        legs_s["teardown_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"[fleet] phase 30 {out['phase_s']:.1f}s [{card}]")
    return out


def _surfaces(model, X, logdir, device) -> dict:
    """Leg e: ``profile(logdir)`` around one ``contrib_numpy`` (the
    trace's size, whether it names the TreeSHAP kernel, its first
    device-side keys), then ``device_memory()`` and ``cluster_status()``."""
    from torch.autograd import DeviceType

    from h2o_kubernetes_tpu_torch import (cluster_status, device_memory,
                                          profile)

    with profile(str(logdir), device=device) as prof:
        model.contrib_numpy(X)
    trace = (Path(logdir) / "trace.json").read_text()
    dev_keys = sorted({a.key[:60] for a in prof.key_averages()
                       if a.device_type == DeviceType.CUDA})
    return {"trace_bytes": len(trace),
            "trace_names_shap_tab": "shap_tab" in trace,
            "device_keys": dev_keys[:6],
            "device_memory": device_memory(device),
            "cluster_status": cluster_status(device)}


def _fleet_surfaces(work: str, device: str) -> int:
    """Phase 30e in a process of its own (``chip_smoke.py
    --fleet-surfaces DIR DEVICE``): base0 from the fleet's s3:// registry
    (the fake store's address and keys come in the environment) on
    ``device``, contributions warmed once, then ``_surfaces`` on phase
    30's rows; prints one JSON line."""
    from h2o_kubernetes_tpu_torch import ModelRegistry, load_artifact

    X = np.load(Path(work) / "surfaces_x.npy")
    dev = None if device == "cuda" else device
    m = load_artifact(ModelRegistry("s3://fleet/registry").fetch("base0", 1),
                      device=dev)
    m.contrib_numpy(X)
    out = _surfaces(m, X, Path(work) / "profile", dev)
    print(json.dumps(out), flush=True)
    return 0


def _reap_pods(workdir: str) -> list:
    """SIGKILL every pod process whose command line names ``workdir``
    (a pool whose shutdown failed leaves them in sessions of their own);
    returns their pids."""
    killed = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if "operator.pod" in cmd and workdir in cmd:
            try:
                os.killpg(int(d), signal.SIGKILL)
                killed.append(int(d))
            except OSError:
                pass
    return killed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm score_numpy, contrib_numpy "
                         "and train call of each kind with torch.profiler "
                         "and print where the device time goes")
    ap.add_argument("--automl-cpu-leg", nargs=2, metavar=("DIR", "ROWS"),
                    help="run phase 27c's CPU leg alone (main() starts it "
                         "in a process of its own)")
    ap.add_argument("--fleet-surfaces", nargs=2, metavar=("DIR", "DEVICE"),
                    help="run phase 30e alone (phase 30 starts it in a "
                         "process of its own)")
    args = ap.parse_args()
    if args.automl_cpu_leg:
        return _automl_cpu_leg(args.automl_cpu_leg[0],
                               int(args.automl_cpu_leg[1]))
    if args.fleet_surfaces:
        return _fleet_surfaces(*args.fleet_surfaces)

    import torch

    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — nothing to run",
              file=sys.stderr)
        return 2
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"[device] nvidia-smi: {card}")
    _log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {kind} count {torch.cuda.device_count()}")
    _log(f"[device] matmul.allow_tf32="
         f"{torch.backends.cuda.matmul.allow_tf32} "
         f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    from h2o_kubernetes_tpu_torch import load_artifact, rest, start_server
    from h2o_kubernetes_tpu_torch.mojo import read_mojo_parts
    from h2o_kubernetes_tpu_torch.models.tree.synthetic import (
        random_rows, random_tree_artifact)
    from h2o_kubernetes_tpu_torch.ops import shap_kernel

    # phase 27c's CPU leg runs beside phases 2-27 (minutes of CPU trains)
    aml_cpu_leg = _start_automl_cpu_leg()

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 2 starts")
    # -- 2. build ------------------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    from h2o_kubernetes_tpu_torch.ops import histogram as hist_op

    libs = (shap_kernel.LIB, hist_op.LIB)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:     # one nvcc per source
        build_s = list(pool.map(lambda lib: lib.build(), libs))
    _log(f"[build] all kernels in {time.perf_counter() - t0:.2f}s")
    for lib, secs in zip(libs, build_s):
        _log(f"[build] {lib.source.name} built+loaded in {secs:.2f}s")
        for line in lib.build_log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                _log(f"[build] {lib.source.name} ptxas: {line.strip()}")

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 3 starts")
    # -- 3. model ------------------------------------------------------------
    F, NTREES, DEPTH = 28, 20, 5
    # p_leaf=0: every branch grows to depth 5, as a GBM trained on
    # 100k HIGGS rows does (~32 leaves per tree)
    blob = random_tree_artifact(args.seed, n_features=F, ntrees=NTREES,
                                max_depth=DEPTH, p_leaf=0.0)
    _, arrays, _ = read_mojo_parts(io.BytesIO(blob))
    X = random_rows(args.seed + 1000, _ROWS, F, nan_frac=0.01)
    model = load_artifact(blob)
    dev = model.device
    _log(f"[model] binomial GBM F={F} ntrees={NTREES} depth={DEPTH} "
         f"artifact {len(blob)} bytes; rows {X.shape} on {dev}")
    n0 = min(4096, X.shape[0])
    p_small = model.score_numpy(X[:n0])
    want = _numpy_margin(arrays, X[:n0], DEPTH)
    got = np.log(p_small[:, 1].astype(np.float64)
                 / (1.0 - p_small[:, 1].astype(np.float64)))
    err = float(np.abs(got - want).max())
    _log(f"[model] margins vs float64 numpy descent: max abs {err:.3e}")
    if not (p_small.shape == (n0, 2) and np.isfinite(p_small).all()
            and err <= 1e-4):
        raise RuntimeError("device margins disagree with the reference")

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 4 starts")
    # -- 4. kernels vs plain -------------------------------------------------
    kern = shap_kernel.flat_shap_tab_kernel
    shap = {"serving": _shap_compare(torch, shap_kernel, model, X,
                                     "serving", card)}
    rows = X.shape[0]
    n_groups = len(shap["serving"]["groups"])

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 5 starts")
    # -- 5. main path through REST -------------------------------------------
    shap_kernel.reset_launches()
    srv = start_server(port=0)
    port = srv.server_address[1]
    try:
        code, resp = _post(port, "/3/ModelRegistry/load", {
            "model_id": "higgs_gbm",
            "artifact_b64": base64.b64encode(blob).decode(),
            "warm_buckets": [128, 4096]})
        if code != 200 or not resp.get("contributions"):
            raise RuntimeError(f"registry load failed: {code} {resp}")
        _log(f"[serve] loaded on {resp['device']}, warmed "
             f"{resp['warmed_buckets']}")
        cols = [f"x{i}" for i in range(F)]
        launches_contrib = 0
        served = []
        for n in (min(n, rows) for n in (128, 1000, 4096)):
            body = {"rows": _json_rows(X[:n]), "columns": cols}
            code, pr = _post(port, "/3/Predictions/models/higgs_gbm", body)
            if code != 200:
                raise RuntimeError(f"predictions {n}: {code} {pr}")
            before = kern.launches
            code, cr = _post(
                port, "/3/Predictions/models/higgs_gbm/contributions", body)
            if code != 200:
                raise RuntimeError(f"contributions {n}: {code} {cr}")
            launches_contrib += kern.launches - before
            served.append((n, np.asarray(pr["p1"], dtype=np.float64),
                           np.asarray(cr["contributions"],
                                      dtype=np.float64)))
        main_launches = kern.launches
        main_variants = dict(shap_kernel.LAUNCHES)
    finally:
        srv.shutdown()
        srv.server_close()
    worst_add, worst_p, worst_c = 0.0, 0.0, 0.0
    for n, p1, phi in served:
        if phi.shape != (n, F + 1) or not np.isfinite(phi).all():
            raise RuntimeError(f"contributions {n}: bad shape/values")
        logit = np.log(p1 / (1.0 - p1))
        worst_add = max(worst_add,
                        float(np.abs(phi.sum(axis=1) - logit).max()))
        worst_p = max(worst_p, float(np.abs(
            p1 - model.score_numpy(X[:n])[:, 1]).max()))
        worst_c = max(worst_c, float(np.abs(
            phi - model.contrib_numpy(X[:n])).max()))
    _log(f"[serve] additivity max |sum(phi) - logit(p1)| = {worst_add:.3e}"
         f"; REST vs direct: p1 {worst_p:.3e}, phi {worst_c:.3e}")
    _log(f"[serve] shap_tab launches: {main_launches} on the main path "
         f"({main_variants}), {launches_contrib} during the contributions "
         "requests")
    if worst_add > 1e-4 or worst_p > 1e-6 or worst_c > 1e-6:
        raise RuntimeError("served results are wrong")
    if launches_contrib != len(served) * n_groups or main_launches <= 0:
        raise RuntimeError(f"the {len(served)} contributions requests made "
                           f"{launches_contrib} shap_tab launches, not one "
                           f"per group ({n_groups}) each")

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 6 starts")
    # -- 6. full width, direct -----------------------------------------------
    score_s = _host_s(lambda: model.score_numpy(X), _REPEATS)
    before = kern.launches
    contrib_s = _host_s(lambda: model.contrib_numpy(X), _REPEATS)
    launched = kern.launches - before
    per_call = launched // (_REPEATS + 1)
    _log(f"[direct] score_numpy {rows} rows: {score_s * 1e3:.3f} ms "
         f"= {rows / score_s:.0f} rows/s [{card}]")
    _log(f"[direct] contrib_numpy {rows} rows: {contrib_s * 1e3:.3f} ms "
         f"= {rows / contrib_s:.0f} rows/s, {per_call} shap_tab launches "
         f"per call over {n_groups} groups; dispatch (rows, padded) "
         f"{model._contrib_dispatch()} [{card}]")
    if launched != (_REPEATS + 1) * n_groups:
        raise RuntimeError(f"contrib_numpy made {launched} shap_tab launches "
                           f"in {_REPEATS + 1} calls, not one per group "
                           f"({n_groups}) per call")
    if args.profile:
        _profile(torch, "score_numpy", lambda: model.score_numpy(X))
        _profile(torch, "contrib_numpy", lambda: model.contrib_numpy(X))
    rest.BATCHER.stop(timeout=5.0)

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 7 starts")
    # -- 7. train: the training main path ------------------------------------
    from h2o_kubernetes_tpu_torch import GBM, Frame
    from h2o_kubernetes_tpu_torch.models.tree import core as tree_core

    hk = hist_op.LAUNCHES                  # histogram launches by regime
    cols = _bench_cols(_TRAIN_ROWS, args.seed)
    t0 = time.perf_counter()
    frame = Frame.from_arrays(cols)
    _log(f"[train] bench frame {_TRAIN_ROWS} rows x {len(cols) - 1} "
         f"features on {frame.device} in {time.perf_counter() - t0:.2f}s")

    def train(frame, depth=5, ntrees=_TRAIN_TREES):
        return GBM(ntrees=ntrees, max_depth=depth, learn_rate=0.2,
                   seed=1).train(y="y", training_frame=frame)

    with _HistRecorder(hist_op) as rec5:
        t0 = time.perf_counter()
        train(frame)                       # warm-up: bins and caches them
        warm_s = time.perf_counter() - t0
    hist_op.reset_launches()
    train_times, gbm = _warm_trains(lambda: train(frame), _WARM_TRAINS)
    train_launches = dict(hk)
    train_s = statistics.median(train_times)
    hist = gbm.scoring_history[-1]
    rate = _TRAIN_ROWS * _TRAIN_TREES / train_s
    _log(f"[train] GBM ntrees={_TRAIN_TREES} max_depth=5 bernoulli: first "
         f"train {warm_s:.3f}s (binning included); {_WARM_TRAINS} warm "
         f"trains {[round(t, 4) for t in train_times]} s, median "
         f"{train_s:.4f}s (min {min(train_times):.4f}, max "
         f"{max(train_times):.4f}) = gbm_boosted_rows_per_sec_per_chip "
         f"{rate:.0f} at the median; train_auc {hist['train_auc']:.6f} "
         f"train_logloss {hist['train_logloss']:.6f}; histogram launches "
         f"{train_launches} over {_WARM_TRAINS} trains [{card}]")
    if not (np.isfinite(hist["train_auc"]) and 0.5 < hist["train_auc"] <= 1
            and np.isfinite(hist["train_logloss"])):
        raise RuntimeError(f"bad training metrics {hist}")
    per_train = 5 * _TRAIN_TREES + 1
    if sum(train_launches.values()) != _WARM_TRAINS * per_train:
        raise RuntimeError(f"expected {per_train} histogram launches per "
                           f"train, got {train_launches} over "
                           f"{_WARM_TRAINS} trains")

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 8 starts")
    # -- 8. deep: B2's levels on the same path -------------------------------
    hist_op.reset_launches()
    with _HistRecorder(hist_op) as rec10:
        t0 = time.perf_counter()
        deep = train(frame, depth=10, ntrees=2)
        deep_s = time.perf_counter() - t0
    deep_launches = dict(hk)
    _log(f"[deep] GBM ntrees=2 max_depth=10: {deep_s:.3f}s, train_auc "
         f"{deep.scoring_history[-1]['train_auc']:.6f}; histogram launches "
         f"{deep_launches}, row partitions "
         f"{hist_op.PARTITION_LAUNCHES['row_partition']} [{card}]")
    deep_parts = hist_op.PARTITION_LAUNCHES["row_partition"]
    if deep_launches["partitioned"] <= 0 or deep_parts <= 0 or \
            sum(deep_launches.values()) != 10 * 2 + 1:
        raise RuntimeError("the depth-10 train did not launch 21 histograms"
                           f" with partitioned ones among them: "
                           f"{deep_launches}, {deep_parts} partitions")

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 9 starts")
    # -- 9. hist: kernel vs plain vs index_add_ at the path's inputs ---------
    u8, i16 = torch.uint8, torch.int16
    book = _LevelBook(torch, hist_op, card, _REPEATS * 2)
    levels, sums, compare = book.levels, book.sums, book.compare

    def auc(rec, label):
        return _auc_case(rec, label, i16)

    b, r, v, n = rec5.levels(1, 256, 3, u8)[0][1]
    compare("gbm depth 5", rec5, 1, 256, 3, u8, "gbm d5", [
        ("gbm d5 level 0 C=2", (b, r, v[..., [0, 2]].contiguous(), n), 256,
         0), auc(rec5, "gbm d5")])
    compare("gbm depth 10", rec10, 1, 256, 3, u8, "gbm d10",
            [auc(rec10, "gbm d10")])
    (_, (b, r, v, n), _), = [lv for lv in rec10.levels(1, 256, 3, u8)
                             if lv[0] == 9]
    parts = {"gbm d10 level 9": _partition_compare(
        torch, hist_op, b, r, v, n, _REPEATS * 2, "gbm d10 level 9", card)}
    _log_sums(sums, ("gbm depth 5", "gbm depth 10"), card)
    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 10 starts")
    # -- 10. parity: the card against the CPU --------------------------------
    binned = frame.binned(gbm.bin_spec)
    yv = frame.vec("y").as_float()
    g = torch.where(yv > 0, 0.5, -0.5)
    h = torch.full_like(g, 0.25)
    w = torch.ones_like(g)
    tp = tree_core.TreeParams(max_depth=5, n_bins=256)
    t_card = tree_core.grow_tree(binned, g, h, w, tp)
    t_cpu = tree_core.grow_tree(binned.cpu(), g.cpu(), h.cpu(), w.cpu(), tp)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(t_card, t_cpu))
    _log(f"[parity] dyadic tree at {_TRAIN_ROWS} rows: card == CPU bitwise "
         f"{same} ({int(t_cpu.is_split.sum())} splits)")
    if not same:
        raise RuntimeError("the dyadic tree differs between card and CPU")
    n_s = _PARITY_ROWS
    small = {k: v[:n_s] for k, v in cols.items()}
    m_card = train(Frame.from_arrays(small)).scoring_history[-1]
    m_cpu = train(Frame.from_arrays(small, device="cpu")).scoring_history[-1]
    gaps = {k: abs(m_card[k] - m_cpu[k]) for k in ("train_auc",
                                                    "train_logloss")}
    _log(f"[parity] {n_s}-row train: card {m_card}, CPU {m_cpu}, "
         f"gaps {gaps}")
    if max(gaps.values()) > 1e-4:
        raise RuntimeError("card and CPU training disagree")

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 11 starts")
    # -- 11. serve the trained model -----------------------------------------
    Xt = gbm._design_matrix(frame)[:_ROWS].cpu().numpy()
    shap_kernel.reset_launches()
    p_t = gbm.score_numpy(Xt)
    phi_t = gbm.contrib_numpy(Xt)
    trained_launches = kern.launches
    add_t = float(np.abs(phi_t.astype(np.float64).sum(axis=1) - np.log(
        p_t[:, 1].astype(np.float64) / (1.0 - p_t[:, 1]))).max())
    serve_s = _host_s(lambda: gbm.contrib_numpy(Xt), 2)
    _log(f"[serve trained] {Xt.shape[0]} rows: additivity max "
         f"|sum(phi) - logit(p1)| = {add_t:.3e}; shap_tab launches "
         f"{trained_launches}; contrib_numpy {serve_s * 1e3:.3f} ms [{card}]")
    if not (np.isfinite(phi_t).all() and phi_t.shape == (_ROWS, 11)
            and add_t <= 1e-4):
        raise RuntimeError("serving the trained model failed")
    shap["trained gbm"] = _shap_compare(torch, shap_kernel, gbm, Xt,
                                        "trained gbm", card)
    if trained_launches != len(shap["trained gbm"]["groups"]):
        raise RuntimeError(f"contrib_numpy of the trained model made "
                           f"{trained_launches} shap_tab launches, not one "
                           "per group")
    hist_op.reset_launches()
    perf = gbm.model_performance(frame, y="y")
    perf_launches = dict(hk)
    _log(f"[serve trained] model_performance on {_TRAIN_ROWS} rows: "
         f"{perf}; histogram launches {perf_launches} (train_auc "
         f"{hist['train_auc']:.6f})")
    # one launch for the AUC and the threshold table
    if sum(perf_launches.values()) != 1 \
            or abs(perf["auc"] - hist["train_auc"]) > 1e-4 \
            or not 0 < perf["f1"] <= 1:
        raise RuntimeError("model_performance did not take the card's "
                           "histogram AUC and threshold table, or "
                           "disagrees with the train AUC")
    if args.profile:
        _profile(torch, "train", lambda: train(frame), top=12)

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 12 starts")
    # -- 12. drf: a random forest at drf_higgs's shape ------------------------
    from h2o_kubernetes_tpu_torch import DRF

    bk = hist_op.BATCHED_LAUNCHES          # launches over K > 1 trees
    hcols, hdom = _higgs_cols(_DRF_ROWS, args.seed)
    t0 = time.perf_counter()
    hframe = Frame.from_arrays(hcols, domains=hdom)
    _log(f"[drf] HIGGS-shaped frame {_DRF_ROWS} rows x 28 features on "
         f"{hframe.device} in {time.perf_counter() - t0:.2f}s")

    def fit_drf(fr):
        return DRF(ntrees=_DRF_TREES, max_depth=_DRF_DEPTH, seed=1).train(
            y="y", training_frame=fr)

    with _HistRecorder(hist_op) as rec_drf:
        t0 = time.perf_counter()
        fit_drf(hframe)                    # first: bins and caches them
        drf_first_s = time.perf_counter() - t0
    hist_op.reset_launches()
    drf_times, drf = _warm_trains(lambda: fit_drf(hframe), _WARM_TRAINS)
    drf_launches, drf_batched = dict(hk), dict(bk)
    drf_parts = hist_op.PARTITION_LAUNCHES["row_partition"]
    drf_s = statistics.median(drf_times)
    dh = drf.scoring_history[-1]
    drf_G = tree_core.drf_group_size(
        _DRF_TREES, tree_core.TreeParams(max_depth=_DRF_DEPTH, n_bins=64,
                                         unit_hess=True), 28)[0]
    _log(f"[drf] DRF ntrees={_DRF_TREES} max_depth={_DRF_DEPTH} nbins="
         f"{drf.params.nbins} mtries={drf.params.mtries} sample_rate="
         f"{drf.params.sample_rate}: G={drf_G} trees per launch; "
         f"first train {drf_first_s:.3f}s (binning included); "
         f"{_WARM_TRAINS} warm trains {[round(t, 4) for t in drf_times]} s,"
         f" median {drf_s:.4f}s (min {min(drf_times):.4f}, max "
         f"{max(drf_times):.4f}) = drf rows·trees/s "
         f"{_DRF_ROWS * _DRF_TREES / drf_s:.0f} at the median; train_auc "
         f"{dh['train_auc']:.6f} train_logloss {dh['train_logloss']:.6f}; "
         f"histogram launches {drf_launches} ({drf_batched} over 10 trees) "
         f"and {drf_parts} row partitions over {_WARM_TRAINS} trains "
         f"[{card}]")
    if not (np.isfinite(dh["train_auc"]) and 0.5 < dh["train_auc"] <= 1):
        raise RuntimeError(f"bad DRF training metrics {dh}")
    if args.profile:
        _profile(torch, "drf train", lambda: fit_drf(hframe), top=12)
    # per train: the 8 histogrammed levels of one group of 10 trees (the
    # deeper ones partitioned) and the train metrics' one launch (the
    # AUC and the threshold table)
    if sum(drf_batched.values()) != 8 * _WARM_TRAINS \
            or drf_batched["partitioned"] <= 0 or drf_parts <= 0 \
            or sum(drf_launches.values()) != 9 * _WARM_TRAINS:
        raise RuntimeError(f"unexpected DRF histogram launches "
                           f"{drf_launches} / batched {drf_batched}")
    sub = {k: v[:_DRF_PARITY_ROWS] for k, v in hcols.items()}
    drf_card = fit_drf(Frame.from_arrays(sub, domains=hdom))
    t0 = time.perf_counter()
    drf_cpu = fit_drf(Frame.from_arrays(sub, domains=hdom, device="cpu"))
    cpu_s = time.perf_counter() - t0
    struct = all(torch.equal(getattr(drf_card.trees, f).cpu(),
                             getattr(drf_cpu.trees, f))
                 for f in ("split_feat", "split_bin", "na_left", "is_split"))
    leaf_gap = float((drf_card.trees.value.cpu() - drf_cpu.trees.value)
                     .abs().max())
    _log(f"[drf] card vs CPU at {_DRF_PARITY_ROWS} rows: split structure "
         f"bitwise "
         f"{struct} ({int(drf_cpu.trees.is_split.sum())} splits), max leaf "
         f"gap {leaf_gap:.3e} (CPU train {cpu_s:.1f}s)")
    if not struct or leaf_gap > 1e-6:
        raise RuntimeError("the forest differs between card and CPU")
    Xh = drf._design_matrix(hframe)[:_ROWS].cpu().numpy()
    shap_kernel.reset_launches()
    p_h = drf.score_numpy(Xh)
    phi_h = drf.contrib_numpy(Xh)
    drf_shap_launches = kern.launches
    add_h = float(np.abs(phi_h.astype(np.float64).sum(axis=1)
                         - p_h[:, 1]).max())
    _log(f"[drf] serve {Xh.shape[0]} rows: additivity max |sum(phi) - p1| "
         f"= {add_h:.3e}; shap_tab launches {drf_shap_launches}")
    if not (np.isfinite(phi_h).all() and phi_h.shape == (_ROWS, 29)
            and add_h <= 1e-4):
        raise RuntimeError("serving the forest failed")
    shap["drf"] = _shap_compare(torch, shap_kernel, drf, Xh, "drf", card)
    if drf_shap_launches != len(shap["drf"]["groups"]):
        raise RuntimeError(f"contrib_numpy of the forest made "
                           f"{drf_shap_launches} shap_tab launches, not one "
                           "per group")
    held = {g["variant"] for r in shap.values() for g in r["groups"]}
    if not {"staged", "unstaged"} <= held:
        raise RuntimeError(f"shap_tab was held in variants {held}: both "
                           "ctab variants must run")

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 13 starts")
    # -- 13. multinomial: GBM at gbm_multinomial's shape --------------------
    mcols = _multinomial_cols(_MN_ROWS, args.seed)
    mframe = Frame.from_arrays(mcols)

    def fit_mn(fr):
        return GBM(ntrees=_MN_TREES, max_depth=5, learn_rate=0.2,
                   seed=1).train(y="y", training_frame=fr)

    with _HistRecorder(hist_op) as rec_mn:
        t0 = time.perf_counter()
        fit_mn(mframe)
        mn_first_s = time.perf_counter() - t0
    hist_op.reset_launches()
    mn_times, mn = _warm_trains(lambda: fit_mn(mframe), _WARM_TRAINS)
    mn_launches, mn_batched = dict(hk), dict(bk)
    mn_parts = hist_op.PARTITION_LAUNCHES["row_partition"]
    mn_s = statistics.median(mn_times)
    K = mn.nclasses
    mn_ll = mn.scoring_history[-1]["train_logloss"]
    _log(f"[multinomial] GBM ntrees={_MN_TREES} max_depth=5 K={K}: first "
         f"train {mn_first_s:.3f}s (binning included); {_WARM_TRAINS} warm "
         f"trains {[round(t, 4) for t in mn_times]} s, median {mn_s:.4f}s "
         f"(min {min(mn_times):.4f}, max {max(mn_times):.4f}) = "
         f"rows·classtrees/s {_MN_ROWS * _MN_TREES * K / mn_s:.0f} at the "
         f"median; train_logloss {mn_ll:.6f}; histogram launches "
         f"{mn_launches} ({mn_batched} over {K} trees) and {mn_parts} row "
         f"partitions over {_WARM_TRAINS} trains [{card}]")
    if not (K == 4 and np.isfinite(mn_ll) and 0 < mn_ll < np.log(4)):
        raise RuntimeError(f"bad multinomial training metrics {mn_ll}")
    if args.profile:
        _profile(torch, "multinomial train", lambda: fit_mn(mframe),
                 top=12)
    if sum(mn_batched.values()) != 5 * _MN_TREES * _WARM_TRAINS \
            or mn_launches != mn_batched:
        raise RuntimeError(f"unexpected multinomial histogram launches "
                           f"{mn_launches} / batched {mn_batched}")
    hist_op.reset_launches()
    mperf = mn.model_performance(mframe, y="y")
    mperf_launches = dict(hk)
    _log(f"[multinomial] model_performance on {_MN_ROWS} rows: {mperf}; "
         f"histogram launches {mperf_launches} (one AUC per class)")
    if sum(mperf_launches.values()) != K or not (
            0.5 < mperf["auc"] <= 1 and abs(mperf["logloss"] - mn_ll)
            <= 1e-4):
        raise RuntimeError("multinomial model_performance is wrong")
    small = {k: v[:_PARITY_ROWS] for k, v in mcols.items()}
    ll_card = fit_mn(Frame.from_arrays(small)).scoring_history[-1]
    ll_cpu = fit_mn(Frame.from_arrays(small, device="cpu")
                    ).scoring_history[-1]
    gap = abs(ll_card["train_logloss"] - ll_cpu["train_logloss"])
    _log(f"[multinomial] {_PARITY_ROWS}-row train: card {ll_card}, CPU "
         f"{ll_cpu}, gap {gap:.3e}")
    if gap > 1e-4:
        raise RuntimeError("card and CPU multinomial training disagree")

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 14 starts")
    # -- 14. B3: the batched launches at the two trains' inputs --------------
    compare("drf", rec_drf, _DRF_TREES, 64, 2, u8, "drf",
            [auc(rec_drf, "drf")])
    compare("multinomial", rec_mn, K, 256, 3, u8, "multinomial")
    (_, (b, r, v, n), _), = [lv for lv in rec_drf.levels(_DRF_TREES, 64, 2, u8)
                             if lv[0] == _DRF_DEPTH - 1]
    parts["drf level 7"] = _partition_compare(
        torch, hist_op, b, r, v, n, _REPEATS * 2, "drf level 7", card)
    _log_sums(sums, ("drf", "multinomial"), card)
    b3 = {k: v for k, v in levels.items() if v["K"] > 1}
    b3_modes = {r["mode"] for r in b3.values()}
    if len(b3) != _DRF_DEPTH + 5 or "partitioned" not in b3_modes or \
            not b3_modes & {"grouped", "replicated"} or \
            {r["C"] for r in b3.values()} != {2, 3}:
        raise RuntimeError("B3 was not compared at every level, in both "
                           f"regime families and widths: {b3_modes}")

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 15 starts")
    # -- 15. distributions: the other GBM families at bench.py's shape ------
    from h2o_kubernetes_tpu_torch.models.tree.core import huber_delta

    resp = {"poisson": "ypos", "gamma": "ypos", "tweedie": "ypos",
            "laplace": "yheavy", "quantile": "yheavy", "huber": "yheavy"}
    dcols = {**cols, **_dist_responses(cols, args.seed)}
    t0 = time.perf_counter()
    dframe = Frame.from_arrays(dcols)
    _log(f"[distributions] bench frame + ypos, yheavy on {dframe.device} "
         f"in {time.perf_counter() - t0:.2f}s")

    def fit_dist(fr, dist, ntrees=_TRAIN_TREES):
        y = resp[dist]
        return GBM(ntrees=ntrees, max_depth=5, learn_rate=0.2, seed=1,
                   distribution=dist).train(
            y=y, training_frame=fr,
            ignored_columns=[c for c in ("y", "ypos", "yheavy") if c != y])

    def fit_bern(fr):
        return GBM(ntrees=_TRAIN_TREES, max_depth=5, learn_rate=0.2,
                   seed=1).train(y="y", training_frame=fr,
                                 ignored_columns=["ypos", "yheavy"])

    # bernoulli on the same frame, in the same minute: the control the
    # six families' times are read against
    fit_bern(dframe)
    bern_times, _ = _warm_trains(lambda: fit_bern(dframe), _WARM_TRAINS)
    _log(f"[distributions] control: bernoulli on this frame, "
         f"{_WARM_TRAINS} warm trains {[round(t, 4) for t in bern_times]} "
         f"s, median {statistics.median(bern_times):.4f}s [{card}]")
    if args.profile:
        _profile(torch, "bernoulli train (control)",
                 lambda: fit_bern(dframe), top=12)
    dists, dist_models = {}, {}
    for dist in resp:
        if dist == "huber":
            with _HistRecorder(hist_op) as rec_hub:
                fit_dist(dframe, dist)         # warm-up, its levels kept
        else:
            fit_dist(dframe, dist)             # warm-up
        with _LaunchesByC(hist_op) as byc:
            times, dm = _warm_trains(lambda: fit_dist(dframe, dist),
                                     _WARM_TRAINS)
        med = statistics.median(times)
        rmse = dm.scoring_history[-1]["train_rmse"]
        want_c = 2 if dist in ("laplace", "quantile", "huber") else 3
        per_train = {k: v // _WARM_TRAINS for k, v in byc.n.items()}
        dists[dist] = {"median_s": med, "min_s": min(times),
                       "max_s": max(times), "train_s": times,
                       "rows_trees_per_s": _TRAIN_ROWS * _TRAIN_TREES / med,
                       "launches_per_train": per_train, "train_rmse": rmse}
        dist_models[dist] = dm
        if args.profile:
            _profile(torch, f"{dist} train", lambda: fit_dist(dframe, dist),
                     top=12)
        _log(f"[distributions] {dist} ({resp[dist]}): {_WARM_TRAINS} warm "
             f"trains {[round(t, 4) for t in times]} s, median {med:.4f}s "
             f"(min {min(times):.4f}, max {max(times):.4f}) = rows·trees/s "
             f"{_TRAIN_ROWS * _TRAIN_TREES / med:.0f} at the median; "
             f"train_rmse {rmse:.6f}; histogram launches per train "
             f"{per_train} [{card}]")
        if not (np.isfinite(rmse) and sum(per_train.values()) == 50
                and all(k.endswith(f"C={want_c}") for k in per_train)):
            raise RuntimeError(f"{dist}: bad metric {rmse} or histogram "
                               f"launches {byc.n} (want 50 per train at "
                               f"C={want_c})")
    small = {k: v[:_PARITY_ROWS] for k, v in dcols.items()}
    sf_card, sf_cpu = Frame.from_arrays(small), \
        Frame.from_arrays(small, device="cpu")
    for dist in resp:
        m_card, m_cpu = fit_dist(sf_card, dist), fit_dist(sf_cpu, dist)
        y = resp[dist]
        kw = {"ignored_columns": [c for c in ("y", "ypos", "yheavy")
                                  if c != y]}
        compared, ties, leaf_gap = _near_ties(m_card, m_cpu, sf_card, y,
                                              kw)
        gap = abs(m_card.scoring_history[-1]["train_rmse"]
                  - m_cpu.scoring_history[-1]["train_rmse"])
        dists[dist].update(parity_nodes=compared, parity_ties=len(ties),
                           parity_leaf_gap=leaf_gap, parity_rmse_gap=gap)
        _log(f"[distributions] {dist} card vs CPU at {_PARITY_ROWS} rows: "
             f"{compared} nodes equal, {len(ties)} near-ties {ties}, "
             f"compared leaves within {leaf_gap:.3e} of the tree's largest "
             f"|leaf|, train_rmse gap {gap:.3e}")
        if gap > 1e-4:
            raise RuntimeError(f"{dist}: card and CPU training disagree")
    # B1's two-channel levels at the inputs the huber train gave them
    compare("huber depth 5", rec_hub, 1, 256, 2, u8, "huber d5")
    if len(rec_hub.levels(1, 256, 2, u8)) != 5:
        raise RuntimeError("the huber train did not hand B1 five C=2 levels")
    _log_sums(sums, ("huber depth 5",), card)
    controls = [r["control_rel_err"] for r in levels.values()
                if r["bf16_changes_vals"]]
    _log(f"[hist] limit {_HIST_REL_LIMIT:.0e}: kernel at most "
         f"{max(r['max_rel_err'] for r in levels.values()):.3e}, control "
         f"at most {max(controls, default=0.0):.3e}")
    if max(controls, default=0.0) <= _HIST_REL_LIMIT:
        raise RuntimeError("the bf16 control stays within the histogram "
                           "limit: the check cannot tell f32 from bf16")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    r20 = torch.randn(_HUBER_ROWS, device=dev, generator=gen) * 3.0
    w20 = (torch.rand(_HUBER_ROWS, device=dev, generator=gen) > 0.05
           ).float()
    d_card = huber_delta(r20, w20, 0.9)
    d_ms = _cuda_ms(torch, lambda: huber_delta(r20, w20, 0.9), _REPEATS)
    absr = np.where(w20.cpu().numpy() > 0, np.abs(r20.cpu().numpy()),
                    np.nan).astype(np.float32)
    d_ref = _xla_nanquantile(absr, 0.9)
    same = d_card.cpu().numpy().tobytes() == d_ref.tobytes()
    _log(f"[distributions] huber delta over {_HUBER_ROWS} float32 values: "
         f"card {float(d_card)!r}, jnp.nanquantile's arithmetic in numpy "
         f"{float(d_ref)!r}, bitwise {same}; {d_ms:.3f} ms on the card "
         f"[{card}]")
    if not same:
        raise RuntimeError("huber's delta differs from jnp.nanquantile's "
                           "arithmetic")

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 16 starts")
    # -- 16. checkpoint: continue a GBM and a forest on the card ------------
    def fit_ck(fr, n, ck=None):
        return GBM(ntrees=n, max_depth=5, learn_rate=0.2, seed=1,
                   checkpoint=ck).train(y="y", training_frame=fr)

    ck5 = fit_ck(frame, 5)
    fit_ck(frame, 10, ck5)                     # warm-up
    hist_op.reset_launches()
    ck_times, cont = _warm_trains(lambda: fit_ck(frame, 10, ck5),
                                  _WARM_TRAINS)
    ck_launches = dict(hk)
    kept = all(torch.equal(a[:5], b) for a, b in zip(cont.trees, ck5.trees))
    ck_s = statistics.median(ck_times)
    ch = cont.scoring_history[-1]
    _log(f"[checkpoint] GBM 5 -> 10 trees at {_TRAIN_ROWS} rows: first 5 "
         f"trees bitwise the checkpoint's {kept}; {_WARM_TRAINS} warm "
         f"continuations {[round(t, 4) for t in ck_times]} s, median "
         f"{ck_s:.4f}s (min {min(ck_times):.4f}, max {max(ck_times):.4f}) "
         f"= {_TRAIN_ROWS * 5 / ck_s:.0f} new rows·trees/s; train_auc "
         f"{ch['train_auc']:.6f} (checkpoint "
         f"{ck5.scoring_history[-1]['train_auc']:.6f}); histogram launches "
         f"{ck_launches} over {_WARM_TRAINS} continuations [{card}]")
    if not kept or sum(ck_launches.values()) != _WARM_TRAINS * (5 * 5 + 1) \
            or not ch["train_auc"] > ck5.scoring_history[-1]["train_auc"]:
        raise RuntimeError("the continuation did not keep the checkpoint's "
                           "trees, improve on it, or launch 26 histograms")
    small = {k: v[:_PARITY_ROWS] for k, v in cols.items()}
    sc_card, sc_cpu = Frame.from_arrays(small), \
        Frame.from_arrays(small, device="cpu")
    c_card = fit_ck(sc_card, 10, fit_ck(sc_card, 5))
    c_cpu = fit_ck(sc_cpu, 10, fit_ck(sc_cpu, 5))
    compared, ties, leaf_gap = _near_ties(c_card, c_cpu, sc_card, "y", {})
    gaps = {k: abs(c_card.scoring_history[-1][k]
                   - c_cpu.scoring_history[-1][k])
            for k in ("train_auc", "train_logloss")}
    _log(f"[checkpoint] card vs CPU at {_PARITY_ROWS} rows: {compared} nodes "
         f"equal, {len(ties)} near-ties, compared leaves within "
         f"{leaf_gap:.3e}, metric gaps {gaps}")
    if max(gaps.values()) > 1e-4:
        raise RuntimeError("card and CPU continuations disagree")
    drf5 = DRF(ntrees=5, max_depth=_DRF_DEPTH, seed=1).train(
        y="y", training_frame=hframe)
    hist_op.reset_launches()
    t0 = time.perf_counter()
    drf10 = DRF(ntrees=_DRF_TREES, max_depth=_DRF_DEPTH, seed=1,
                checkpoint=drf5).train(y="y", training_frame=hframe)
    drf_ck_s = time.perf_counter() - t0
    drf_ck_batched = dict(bk)
    drf_kept = all(torch.equal(a[:5], b)
                   for a, b in zip(drf10.trees, drf5.trees))
    _log(f"[checkpoint] DRF 5 -> {_DRF_TREES} trees at drf_higgs's shape: "
         f"first 5 bitwise {drf_kept}, {drf_ck_s:.4f}s, batched launches "
         f"{drf_ck_batched}, train_auc "
         f"{drf10.scoring_history[-1]['train_auc']:.6f} [{card}]")
    if not drf_kept or sum(drf_ck_batched.values()) != _DRF_DEPTH:
        raise RuntimeError("the forest continuation did not keep its trees "
                           "or grow its 5 new trees in one batched launch "
                           "per level")

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 17 starts")
    # -- 17. registry: train -> export -> registry -> replica ----------------
    import hashlib
    import os
    import shutil

    from h2o_kubernetes_tpu_torch import ModelRegistry, MojoModel

    pois = dist_models["poisson"]
    reg_root = os.path.join("build", "registry", f"smoke-{os.getpid()}")
    reg = ModelRegistry(reg_root)
    n_req = 4096
    Xg = gbm._design_matrix(frame)[:n_req].cpu().numpy()
    Xp = pois._design_matrix(dframe)[:n_req].cpu().numpy()
    rcols = list(gbm.feature_names)
    rows_req = [[dcols[c][i] if c == "c1" else float(dcols[c][i])
                 for c in rcols] for i in range(n_req)]
    body = {"rows": rows_req, "columns": rcols}
    rest.BATCHER.reset()                       # phase 6 stopped it
    srv = start_server(port=0)
    port = srv.server_address[1]
    url = f"http://127.0.0.1:{port}"
    lat = {}
    try:
        versions = {"bench_gbm": reg.publish(gbm, "bench_gbm"),
                    "bench_poisson": reg.publish(pois, "bench_poisson")}
        pushed = {name: reg.push(url, name, v, name,
                                 warm_buckets=[128, n_req])
                  for name, v in versions.items()}
        _log(f"[registry] published {versions} under {reg_root}; pushed "
             f"by path + sha256: {pushed}")
        code, pg = _post(port, "/3/Predictions/models/bench_gbm", body)
        code2, pp = _post(port, "/3/Predictions/models/bench_poisson", body)
        if code != 200 or code2 != 200:
            raise RuntimeError(f"predictions: {code} {pg} / {code2} {pp}")
        pos = gbm.response_domain[1]
        same_g = np.array_equal(np.asarray(pg[f"p{pos}"], np.float32),
                                gbm.score_numpy(Xg)[:, 1])
        same_p = np.array_equal(np.asarray(pp["predict"], np.float32),
                                pois.score_numpy(Xp))
        n_groups_g = len(gbm._contrib_prepare()[0])
        before = kern.launches
        code, cg = _post(port, "/3/Predictions/models/bench_gbm/contributions",
                         body)
        reg_launches = kern.launches - before
        if code != 200:
            raise RuntimeError(f"contributions: {code} {cg}")
        phi = np.asarray(cg["contributions"], np.float64)
        p1 = np.asarray(pg[f"p{pos}"], np.float64)
        add = float(np.abs(phi.sum(axis=1) - np.log(p1 / (1 - p1))).max())
        for name, path in (("predictions", "/3/Predictions/models/bench_gbm"),
                           ("contributions", "/3/Predictions/models/"
                            "bench_gbm/contributions")):
            ts = []
            for _ in range(_REPEATS):
                t0 = time.perf_counter()
                _post(port, path, body)
                ts.append(time.perf_counter() - t0)
            lat[name] = statistics.median(ts) * 1e3
        tamper, _ = _post(port, "/3/ModelRegistry/load", {
            "model_id": "tampered",
            "path": reg.artifact_path("bench_gbm", versions["bench_gbm"]),
            "sha256": hashlib.sha256(b"not the artifact").hexdigest()})
        mojo_err = {}
        for name, model, Xm in (("bench_gbm", gbm, Xg),
                                ("bench_poisson", pois, Xp)):
            mm = MojoModel(io.BytesIO(reg.fetch(name, versions[name])))
            want = model.score_numpy(Xm).astype(np.float64)
            # relative past 1: the poisson means reach ~10, where float32
            # itself resolves ~1e-6
            mojo_err[name] = float((np.abs(mm.predict(Xm) - want)
                                    / np.maximum(1.0, np.abs(want))).max())
    finally:
        srv.shutdown()
        srv.server_close()
        rest.BATCHER.stop(timeout=5.0)
        shutil.rmtree(reg_root, ignore_errors=True)
    _log(f"[registry] {n_req}-row requests over REST: predictions bitwise "
         f"score_numpy {same_g} (binomial) {same_p} (poisson); "
         f"contributions additivity {add:.3e}, shap_tab launches "
         f"{reg_launches} per request over {n_groups_g} groups; latency "
         f"(median of {_REPEATS} single requests) predictions "
         f"{lat['predictions']:.3f} ms, contributions "
         f"{lat['contributions']:.3f} ms; tampered digest -> {tamper}; "
         f"MojoModel vs score_numpy (relative past 1) {mojo_err} "
         f"[{card}]")
    if not (same_g and same_p and add <= 1e-4 and tamper == 409
            and reg_launches == n_groups_g
            and max(mojo_err.values()) <= 1e-6):
        raise RuntimeError("the registry loop served wrong results")

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 18-20 starts")
    # -- 18-20. xgboost, lambdarank, glm -------------------------------------
    from types import SimpleNamespace

    ctx = SimpleNamespace(
        torch=torch, hist_op=hist_op, shap_kernel=shap_kernel, rest=rest,
        start_server=start_server, card=card, profile=args.profile,
        hframe=hframe, hcols=hcols, hdom=hdom, mframe=mframe, book=book,
        aml_cpu_leg=aml_cpu_leg)
    xgb_res = _phase_xgboost(ctx)
    rank_res = _phase_lambdarank(ctx)
    glm_res = _phase_glm(ctx)
    shap["xgboost"] = xgb_res.pop("shap")

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 21-23 starts")
    # -- 21-23. efb, goss, out-of-core ---------------------------------------
    efb_res = _phase_efb(ctx)
    shap["efb gbm"] = efb_res.pop("shap")
    goss_res = _phase_goss(ctx)
    ooc_res = _phase_ooc(ctx)

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 24-25 starts")
    # -- 24-25. deeplearning, word2vec ----------------------------------------
    ctx.profile_counts = _profile_counts
    dl_res = _phase_deeplearning(ctx)
    w2v_res = _phase_word2vec(ctx)

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 26 starts")
    # -- 26. frame: airlines.csv -> split -> GBM -> holdout metrics -----------
    # its CSV stays for phase 29's REST import (build/ is gitignored)
    ctx.frame_work = str(Path(__file__).resolve().parent / "build" / "frame")
    os.makedirs(ctx.frame_work, exist_ok=True)
    atexit.register(shutil.rmtree, ctx.frame_work, True)
    frame_res = _phase_frame(ctx)

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 27 starts")
    # -- 27. automl: CV, ensembles, AutoML, scheduler, grid ------------------
    aml_res = _phase_automl(ctx)

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 28 starts")
    # -- 28. the other learners ----------------------------------------------
    learn_res = _phase_learners(ctx)

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 29 starts")
    # -- 29. serving remainder: the multi-tenant replica, the REST API -------
    ctx.seed = args.seed
    sr_res = _phase_serving_remainder(ctx)
    shutil.rmtree(ctx.frame_work, ignore_errors=True)

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 30 starts")
    # -- 30. the fleet: operator, sharded pool, router over pods on the card -
    fleet_res = _phase_fleet(ctx)

    _log(f"[time] {time.perf_counter() - _T0:.1f}s: phase 31 starts")
    # -- 31. report ----------------------------------------------------------
    sv = shap["serving"]
    record = {
        "name": "shap_tab", "route": "cuda",
        "source": "h2o_kubernetes_tpu_torch/csrc/shap_tab.cu",
        "replaces": "h2o_kubernetes_tpu/ops/shap_kernel.py:120 "
                    "(_shap_tab_kernel)",
        "launches": main_launches, "variants": main_variants,
        "max_abs_err": max(r["max_abs_err"] for r in shap.values()),
        "ms": sv["ms"], "plain_ms": sv["plain_ms"],
        "bound_ms": sv["bound_ms"], "bound_by": sv["bound_by"],
        "library_ms": None, "rows": rows,
        "launches_per_contrib_call": {"serving": per_call,
                                      "trained gbm": trained_launches,
                                      "drf": drf_shap_launches},
        "models": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "variants", "groups")}
                   for k, r in shap.items()},
    }
    records = [record]
    # the histogram kernel by the TPU kernel each level replaces: B1 the
    # depth-5 train (its root timed), B2 the depth-10 train's partitioned
    # levels (64 nodes and more; 256 timed), B3 the launches over K > 1
    # trees of the DRF and multinomial trains (DRF level 7 timed); each
    # with the regimes its launches ran in, every level it was held at,
    # and the per-train sums
    # the depth-10 train's partitioned launches are its calls at the
    # levels held in the partitioned regime (its deepest ones)
    deep_levels = {f"gbm d10 level {d}": c
                   for d, _, c in rec10.levels(1, 256, 3, u8)
                   if levels[f"gbm d10 level {d}"]["mode"] == "partitioned"}
    if deep_launches["partitioned"] != sum(deep_levels.values()) or \
            "gbm d10 level 9" not in deep_levels:
        raise RuntimeError(f"{deep_launches['partitioned']} partitioned "
                           "launches in the depth-10 train, calls at its "
                           f"partitioned levels {deep_levels}")
    fields = ("mode", "K", "n_nodes", "n_bins", "C", "calls_per_train",
              "ms", "plain_ms", "library_ms", "bound_ms", "max_rel_err",
              "plain_rel_err", "control_rel_err")
    for name, level, launches, regimes, replaces, trains, keep in (
            ("histogram", "gbm d5 level 0", sum(train_launches.values()),
             train_launches,
             "h2o_kubernetes_tpu/ops/histogram.py:141 (_hist_fact_kernel)",
             ("gbm depth 5", "huber depth 5", "xgboost_hist",
              "lambdarank", "efb gbm", "wide gbm root", "goss gbm",
              "ooc rule", "ooc 1M", "deeplearning_mlp", "airlines gbm",
              "automl config5 b1"),
             lambda k, v: k.startswith(("gbm d5", "huber d5", "auc",
                                        "xgb d6", "rank d6", "efb d5",
                                        "wide d5", "goss d5", "ooc rule d6",
                                        "ooc 1M d6", "air d5",
                                        "aml gbm1 d6"))),
            ("histogram_deep", "gbm d10 level 9",
             deep_launches["partitioned"],
             {"partitioned": deep_launches["partitioned"]},
             "h2o_kubernetes_tpu/ops/histogram.py:300 (_hist_kernel)",
             ("gbm depth 10", "ooc deep", "automl config5 b2"),
             lambda k, v: k in deep_levels or k == "ooc d10 level 9"
             or k.startswith("aml gbm5 d10")),
            ("histogram_batched", "drf level 7",
             sum(drf_batched.values()) + sum(mn_batched.values()),
             {r: drf_batched[r] + mn_batched[r] for r in drf_batched},
             "h2o_kubernetes_tpu/ops/histogram.py:399 (_hist_vmappable)",
             ("drf", "multinomial", "efb drf", "goss softprob",
              "automl config5 b3"),
             lambda k, v: v["K"] > 1)):
        res = levels[level]
        held = {k: v for k, v in levels.items() if keep(k, v)}
        records.append({
            "name": name, "route": "cuda",
            "source": "h2o_kubernetes_tpu_torch/csrc/histogram.cu",
            "replaces": replaces, "launches": launches, "regimes": regimes,
            "max_abs_err": max(v["max_abs_err"] for v in held.values()),
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["library_ms"], "level": level,
            "max_rel_err": max(v["max_rel_err"] for v in held.values()),
            "rel_limit": _HIST_REL_LIMIT,
            "train_sums": {t: dict(zip(("launches", "ms", "bound_ms"),
                                       sums[t])) for t in trains},
            "levels": {k: {f: v[f] for f in fields}
                       for k, v in held.items()}})
    res = parts["drf level 7"]
    records.append({
        "name": "row_partition", "route": "cuda",
        "source": "h2o_kubernetes_tpu_torch/csrc/histogram.cu",
        "replaces": "h2o_kubernetes_tpu/ops/histogram.py:300 (_hist_kernel: "
                    "its node·bin blocking of the deep levels)",
        "launches": deep_parts + drf_parts + mn_parts,
        "max_abs_err": max(v["max_abs_err"] for v in parts.values()),
        "ms": res["ms"], "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
        "library_ms": None, "level": "drf level 7", "levels": parts})
    records[1]["warm_train_s"] = train_times
    records[3]["drf_warm_train_s"] = drf_times
    records[3]["multinomial_warm_train_s"] = mn_times
    # the launches of phases 15-17, each counted from zero around its run
    records[0]["registry_launches_per_request"] = reg_launches
    records[0]["registry_latency_ms"] = lat
    records[1]["distributions"] = dists
    records[1]["distributions_control_bernoulli_s"] = bern_times
    records[1]["checkpoint_launches"] = ck_launches
    records[1]["checkpoint_warm_s"] = ck_times
    records[3]["drf_checkpoint_launches"] = drf_ck_batched
    records[3]["drf_checkpoint_s"] = drf_ck_s
    # phases 18-20, each path's launches counted from zero around its run
    records[0]["xgboost_registry_launches_per_request"] = \
        xgb_res["registry_shap_launches_per_request"]
    records[1]["xgboost"] = {k: v for k, v in xgb_res.items()
                             if not k.startswith(("softprob", "registry"))}
    records[1]["lambdarank"] = rank_res
    records[1]["glm"] = glm_res
    records[3]["xgboost_softprob"] = {
        "train_s": xgb_res["softprob_train_s"],
        "batched_launches_per_train":
            xgb_res["softprob_batched_launches_per_train"]}
    # phases 21-23, each path's launches counted from zero around its run
    records[0]["launches_per_contrib_call"]["efb gbm"] = \
        efb_res["shap_launches_per_contrib_call"]
    records[1]["efb"] = {k: v for k, v in efb_res.items()
                         if not k.startswith("drf")}
    records[1]["goss"] = {k: v for k, v in goss_res.items()
                          if not k.startswith("softprob")}
    records[1]["ooc"] = {k: v for k, v in ooc_res.items()
                         if not k.startswith("deep")}
    records[2]["ooc_deep"] = {k: v for k, v in ooc_res.items()
                              if k.startswith("deep")}
    records[3]["efb_drf"] = {k: v for k, v in efb_res.items()
                             if k.startswith("drf")}
    records[3]["goss_softprob"] = {k: v for k, v in goss_res.items()
                                   if k.startswith("softprob")}
    # phases 24-25 add no kernel; DeepLearning's train AUC launches B1
    # (counted from zero around that call), Word2Vec none. The learners'
    # own numbers are a line of their own.
    records[1]["deeplearning_auc_launches"] = dl_res.pop("auc_launches")
    _log(json.dumps({"learners": {"deeplearning": dl_res,
                                  "word2vec": w2v_res}}))
    # phase 26 adds no kernel; its path's B1 launches (a train and the
    # holdout metrics, counted from zero) are in its own line
    _log(json.dumps({"frame": frame_res}))
    # phase 27's config #5 run, its launches counted from zero around it
    for i, k in ((1, "b1_launches"), (2, "b2_launches"),
                 (3, "b3_launches")):
        records[i]["automl_config5_launches"] = aml_res["config5"][k]
    _log(json.dumps({"automl": aml_res}))
    # phase 28 adds no kernel (B1-B4 launch 0 times on its paths)
    _log(json.dumps({"other_learners": learn_res}))
    # phase 29 adds no kernel; B4 (contributions, promotions) and B1/B3
    # (the REST builds) run on its routes, counted from 0 per leg
    for i, k in ((0, "b4"), (1, "b1"), (2, "b2"), (3, "b3")):
        records[i]["serving_remainder_launches"] = {
            leg: n[k] for leg, n in sr_res["launches"].items()}
    _log(json.dumps({"serving_remainder": sr_res}))
    # phase 30 adds no kernel; B4 runs in the pods (counted through each
    # pod's /3/Kernels around leg c's contributions requests)
    records[0]["fleet_pod_launches"] = {
        "routed_leg": fleet_res["routed"]["pod_launches"],
        "correctness_leg": fleet_res["correct"]["pod_launches"],
        "b4_per_contrib_request":
            fleet_res["correct"]["b4_per_contrib_request"]}
    _log(json.dumps({"fleet": fleet_res}))
    _log(json.dumps({"kernels": records}))
    _log(f"[time] {time.perf_counter() - _T0:.1f}s: the whole run")
    _log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
