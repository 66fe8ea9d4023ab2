"""Drive the PyTorch + CUDA port (torchrec_tpu_torch) on one GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases, each failing the run with a non-zero exit when it fails:

1. Identify the card (name, count, power limit); TF32 is switched off.
2. Build the kernels with nvcc for sm_90a, one nvcc per source, started
   together: K1, K1h and K1j (csrc/tbe_lookup.cu), K2-K7, K3h and K4h
   (csrc/fused_update.cu), K8 with the routed gather
   (csrc/gather_rows.cu), Kq (csrc/quant_lookup.cu) and the DLRM's dot
   interaction (csrc/dot_interaction.cu).
3. Serve the DLRM that bench.py and bench_config.py describe, at full
   width, through the port's DistributedModelParallel.make_eval_fn:
   26 fp32 tables of 100,000 x 128 (ROW_WISE on one device), dense arch
   13 -> 512-256-128, over arch 1024-1024-512-256-1, one id per feature.
   Requests at B=8192 (the bench batch) and B=256 (the serving example's
   default), made from a seed with numpy. Each request must launch K1
   exactly once; logits must be finite and, for one B=256 request, equal
   the same model's logits on the CPU.
4. Hold K1 against its plain PyTorch version on the card, on the served
   model's table at the main path's shape (bit-exact at L=1) and at L=20
   with MEAN / per-sample coefficients and out-of-range ids (rtol 1e-6),
   and time the kernel, the plain version and F.embedding_bag.
5. Train the same model wrapped in DLRMTrain through make_train_step, as
   bench.py trains it (fused lr 0.1, dense SGD at 0.05), for EXACT_SGD,
   ROWWISE_ADAGRAD, ADAGRAD and ADAM: 3 warm-up and 10 timed steps at
   B=8192 on seeded batches. Every loss must be finite and every step must
   launch exactly K1 and K3 once (EXACT_SGD), K1 and K4 once
   (ROWWISE_ADAGRAD: the fused kernel, which does K5's work too, so K5
   never), K1 and K6 once (ADAGRAD) or K1 and K7 once (ADAM), and no other
   kernel. After each of the last three, hold its update kernels against
   their plain versions on the card, on the trained table and momenta and
   one real batch's run totals and dedup output (real sentinel patterns):
   K2, K3, the fused K4 (at weight decay 0 and 0.01), K5 and K4's scaled
   RMW after ROWWISE_ADAGRAD, K6 after ADAGRAD, K7 after ADAM. Bit-exact,
   since neither side contracts a multiply-add, both round sqrt and divide
   per IEEE and both sum g^2 in row_mean_sq's order. Time each kernel, its
   plain version and its library yardstick, and the fused K4 in turns with
   the unfused composition it replaced (K5 and the scaled RMW with the
   torch ops between them).
6. One step on each other route of the update: fused_params
   w_impl="write" must launch K5 and K2 once (ROWWISE_ADAGRAD), K2 twice
   (ADAGRAD) or three times (ADAM) and K4 / K6 / K7 never;
   mom_impl="xla" (ROWWISE_ADAGRAD) the scaled RMW once and K4 / K5
   never.
7. For EXACT_SGD, ROWWISE_ADAGRAD, ADAGRAD, ADAM and the four optimizers
   without a kernel (PARTIAL_ROWWISE_ADAM, LAMB, PARTIAL_ROWWISE_LAMB,
   LARS_SGD), copy a fresh card DMP to a CPU DMP with load_state_dict and
   take 2 steps at B=256 on both, from seeded momenta at step 5: the
   losses, the dense parameters and the table rows and momenta the
   batches touched must agree (rtol 1e-4, atol 1e-5: GEMM and gradient
   sums run in another order), and every other row must be unchanged on
   both.
8. The position-weighted DLRM: the same model with its EBC (weighted,
   L=20) in a FeatureProcessedEmbeddingBagCollection whose
   PositionWeightedModule learns 20 weights per feature, through the
   DMP's feature-processor branch. Multi-hot requests, lengths uniform in
   1..20, ids uniform over each table's rows. 3 requests at B=8192, K1
   once each; K1 then held against its plain version on the last
   request's ids and coefficients (rtol = atol = 1e-6) and timed beside
   F.embedding_bag. Then 1 warm-up and 3 timed steps at B=8192 under
   EXACT_SGD and under ROWWISE_ADAGRAD (dense SGD at 0.05), each
   launching K1, K8 (the rows of K1's d_coeff) and K3 or the fused K4
   once and no other kernel, and building no dense table gradient; the
   position weights must take each dense step to within an ulp, stay
   finite and move (under EXACT_SGD at B=8192 the steps stay under half
   an ulp of 1.0, so they move under ROWWISE_ADAGRAD). After EXACT_SGD, K8 is
   held bit-exact against its plain version and index_select on the
   d_coeff gather's table and 4.26 M ids, and timed. After each, its
   update kernel is held bit-exact against its plain version on clones of
   the trained table (and momentum) with the last step's 4.26 M ids and
   row gradients, as in 5 (K3 at weight decay 0 and 0.01, beside
   index_add_; the fused K4 at both, in turns with the unfused
   composition, and K5), and timed; 2 more steps are profiled with
   torch.profiler (device time per kernel name, busy share, each label's
   span and host time). Then a CPU
   copy of the trained DMP and the card agree on one B=256 request's
   logits and over 2 steps at B=256 (losses, position weights, dense
   parameters, touched rows and momenta within rtol 1e-4 / atol 1e-5;
   untouched rows equal; the last step's position weight gradients
   within 1e-3 in norm). The CPU's sparse side (K1's VJP, the table's
   update) takes the card's pooled cotangent, held within 0.1 of the
   CPU's own in norm: where the two sides' ReLUs disagree on a
   pre-activation within rounding of zero, one sample's cotangent
   differs by a finite amount (check_pw_cotangent.py repeats this). For
   the same reason each CPU ReLU whose pre-activation lies within 1e-5
   (the logits' atol) of zero takes the card's branch in those steps; the
   units whose branch that changed are counted and printed.
9. Serve examples/bert4rec_main.py's BERT4Rec (--synthetic_ml1m defaults:
   vocab 3,708 = 3,706 items + pad 0 + MASK, L=64, D=64, 2 heads, 2
   blocks, dropout 0) through make_eval_fn, its item table ROW_WISE in a
   ShardedEmbeddingCollection: 3 requests at B=32 (the example's batch)
   and 3 at B=1024 (a larger ranking request), masked as make_eval_batch
   masks them. Each request must launch the routed gather (K8 redesigned:
   route, owned mask and row gather in one kernel) once and nothing else
   of the port, the plain K8 never; the logits [B, 64, 3708] must be
   finite, and one B=32 request's must equal the CPU run's (rtol 1e-4,
   atol 1e-5).
10. Train it through make_train_step (ROWWISE_ADAGRAD at 0.01, dense
   torch.optim.Adam at 1e-3): 3 warm-up and 10 timed steps at B=32 on
   batches masked as make_train_batch masks them, each launching the
   routed gather once in the forward, its route-only mode once in the
   update and the fused K4 once, and nothing else (the plain K8 never).
   Then copy the card DMP to a CPU DMP, the
   dense Adam state included (nonzero moments), and take 2 steps on both:
   losses, dense parameters and the touched table rows and momenta agree
   (rtol 1e-4, atol 1e-5), untouched rows are unchanged on both. The
   attention key biases are the exception: their gradient is zero up to
   rounding, which Adam scales up to steps of order lr, so they are held
   within Adam's reach (2 x 3.2 x lr x steps) instead.
11. Hold the fused K4 (weight decay 0 and 0.01), K5 and the scaled RMW
   against their plain versions, bit-exact, on the trained [3712, 64]
   shard and momentum with one batch's dedup output, and time them as in
   5. Hold the routed gather against its plain version by value (a masked
   token is +0.0 on both) on the same shard: the B=32 path's 2,048
   tokens, a B=1024 request's 65,536, a batch of three features with
   negative, out-of-range and padded ids, a rank that owns none of them
   (all zeros) and a width of 63 (the scalar path); its route-only mode
   bit-exact against the strategy's `_route`. Time it at both path
   shapes in turns with the composition it replaced (the route's torch
   ops, K8 and the mask multiply), beside its plain version, and each
   wrapper's host time per call. Hold the plain K8 against its plain
   version and torch.index_select, bit-exact, at the unsharded EC's
   shape (2,048 ids of the [3712, 64] shard), at K1's backward's (40,960
   ids of a 100,000 x 128 table) and at a bytes-bound one (W 2,600,064 x
   128, 212,992 ids with negative and out-of-range ones), and time all
   three.
12. Gradients through the unsharded EmbeddingBagCollection (weighted,
   L=20, SUM and MEAN, D=128) and EmbeddingCollection on the card against
   the CPU: the EBC's d_W and the per-sample weights' gradient (rtol
   1e-5, atol 1e-6), the EC's d_W bit for bit. K1 launches once in the
   EBC's forward and K8 once in its backward. The EC takes histories at
   their own lengths, so padding is masked, and cotangents on a 1/64 grid,
   which sum exactly in any order: a popular item's hundred-token sum
   otherwise depends on the order of the card's atomic adds by more than
   1e-5 of its value.
13. The bf16 DLRM: bench.py's DLRM with DataType.BF16 tables, as its
   headline_bf16 suite runs it (one 2,600,064 x 128 bf16 shard; fused lr
   0.1 with stochastic rounding on, dense SGD at 0.05). 3 requests at
   B=8192 and 3 at B=256, each launching K1h once and K1 never, logits
   finite, one B=256 request equal to a CPU copy's (rtol 1e-4, atol
   1e-5). K1h held against its plain version on the served table at the
   path's shape (bit-exact) and at L=20 with MEAN / per-sample
   coefficients and ids >= R (rtol 1e-6), and on an fp16 copy, and timed
   beside F.embedding_bag. Trained under EXACT_SGD and ROWWISE_ADAGRAD: 3
   warm-up and 10 timed steps at B=8192, each launching K1h and K3h or
   K4h once and no f32 kernel, losses finite. K3h and K4h held bit-exact
   against their plain versions on the trained table with the last
   step's run totals / dedup output at the step the run reached, under
   both epilogues (stochastic rounding and to nearest), also on an fp16
   copy, and K4h at BERT4Rec's shape (the trained [3712, 64] shard in
   bf16, 2,048 tokens of a B=32 batch; run in 11); each timed, K3h also
   to nearest and beside index_add_ of its rounded update. Stochastic
   rounding shown on the card: 300 K3h steps of lr * g = 1e-4 on a bf16
   table of ones drift the mean by 0.5-1.5x of 0.03 with it and not at
   all without it. Card against CPU: a fresh card bf16 DMP and its CPU
   copy take 2 steps at B=256 under EXACT_SGD, ROWWISE_ADAGRAD (both with
   stochastic rounding) and ADAM: touched rows within one bf16 ulp, at
   most 1 in 1,000 touched elements differing at all (the same SR bits on
   both sides), momenta within rtol 1e-4 / atol 1e-5, untouched rows
   equal.

14. SimpleDeepFMNN over bench.py's 26 tables (ROW_WISE, one id per
   feature, 13 dense features) with 400-unit hidden layers, the DeepFM
   paper's Criteo setting: dense arch 13 -> 400 -> 128, the deep part and
   the FM over 128 + 26 x 128 = 3,456 columns, over arch 529 -> 1 and a
   sigmoid. The fused lr comes from the ported warmup schedule (LINEAR to
   step 8 from 0.1, then CONSTANT 0.5 to step 100; base 0.1), the dense
   optimizer is the warmup of a NORM clip at 1.0 of Adam at 1e-3. 3
   requests at B=8192 and 3 at B=256, K1 once each, probabilities finite
   in [0, 1]; one B=256 request's FM scalar and probabilities equal a CPU
   copy's within 1e-5 of (sum x)^2 + sum x^2 per row (the FM cancels).
   Trained under EXACT_SGD and ROWWISE_ADAGRAD, 3 + 10 steps at B=8192,
   each launching K1 and K3 or the fused K4 once and nothing else; the lr
   each update kernel got equals the stages' formula, the warmup's count
   the steps taken; the steps whose dense gradient norm reached the clip
   are counted; 2 more steps profiled. Then, per optimizer, a fresh card
   DMP at step 5 (mid-ramp, seeded fused momenta and Adam moments) hands
   its KeyedOptimizer and CombinedOptimizer state_dicts to a CPU copy (a
   load missing a key raises), and both take 2 steps at B=256: losses,
   dense parameters, Adam's moments, touched rows and momenta within rtol
   1e-4 / atol 1e-5, untouched rows equal. Last, the four cross nets at
   N=3,456, B=8,192, 3 layers (low rank 64, 4 experts), forward and
   backward on the card against the CPU, each timed.
15. Quantized serving. csrc/serving_queue.cpp is built with g++. bench.py's
   DLRM (DLRMTrain) takes 3 EXACT_SGD steps at B=8192 (K1 and K3 once
   each) and serves 3 requests at B=8192 and 3 at B=256 in f32 (K1 once
   each; its peak memory is the f32 server's). quantize_embeddings makes
   an int8 and an int4 PredictModule from it; their pooled values lie
   within each row's bound of the f32 ones (half a step of the fp16
   scale, plus the fp16 rounding of the shift and of the range), each is
   saved to a temporary package, and Kq is held against its plain version
   on the sharded form's packed group at the path's shape (B=8192, L=1,
   pooled and unpooled: bit-exact) and timed beside its plain version,
   PyTorch's quantized embedding bag on the group repacked into its fused
   rows (embedding_bag_byte / _4bit_rowwise_offsets, held within rtol =
   atol = 1e-6 of the plain version first) and K1 on the f32 table at the
   same ids; off the path at L=20 with MEAN
   and per-sample coefficients, zero lengths and ids outside [0, R), at
   8, 4 and 2 bits and D = 128, 96, 64 and 66 (rtol 1e-6; unpooled
   bit-exact). The f32 model is freed; each package is loaded with a
   DMP on `meta` as scaffolding (its predictions equal the saved
   module's bit for bit) and serves the same 6 requests through
   PredictModule (26 Kq launches each, K1 never; one B=256 request
   against a CPU load of the package within rtol 1e-4 / atol 1e-5; each
   logit within 2x its first-order bound of the f32 logit, the sum over
   its pooled elements of |d logit / d pooled| times the row's bound)
   and through shard_quantized (1 Kq launch each, bit-exact with the
   unsharded module). The int8 module also serves 64 ragged requests of
   1..64 examples from 4 client threads through BatchingPredictServer and
   NativePredictServer (server batch 256, the native one pipelined) and
   8 of them over TCP through PredictClient: every result within rtol
   1e-5 of a direct predict, 26 Kq launches per predict call, stop()
   returning. Peak device memory of each quantized server, unsharded and
   sharded, must lie at least 90 % of its tables' saving below the f32
   server's.
16. The flat sharding strategies inside an NCCL process group of one rank
   (its store a file in a temporary directory; the env from
   ShardingEnv.from_process_group on the card), so every collective is a
   real NCCL call (parallel/comm.py). bench.py's DLRM under a mixed plan,
   tables 0-6 DATA_PARALLEL, 7-12 TABLE_WISE (rank 0), 13-19 COLUMN_WISE
   and 20-25 ROW_WISE (four groups), from the same seed as the group-less
   all-ROW_WISE DMP, which runs first (one DMP on the card at a time): 3
   requests at B=8192 and 3 at B=256, each launching K1 exactly 4 times
   (once) and making 3 all_gathers, 1 reduce_scatter and 2 all_to_alls
   (none), logits equal bit for bit; 3 steps at B=8192 under EXACT_SGD and
   ROWWISE_ADAGRAD (fused lr 0.1, dense SGD 0.05), each launching K1 and
   K3 / the fused K4 exactly 4 times (once) and making 9 all_gathers, 1
   reduce_scatter, 4 all_to_alls and 1 all_reduce of the dense gradients;
   tables, optimizer state and dense parameters within rtol 1e-4 / atol
   1e-5 of the ROW_WISE run's, untouched rows equal. Each group's calls
   per forward and update are counted alone, and the COLUMN_WISE group
   runs once without and once with the group: the same [1, R, 128]
   layout and pooled values, bit for bit. Then BERT4Rec's item table
   DATA_PARALLEL and TABLE_WISE inside the group against the group-less
   ROW_WISE DMP: 3 requests at B=32 and 3 at B=1024, one routed gather
   each (shard sizes that hold whole tables), logits equal as values; 3
   steps at B=32 under ROWWISE_ADAGRAD, one routed gather and one fused K4
   each, the table and momentum within rtol 1e-4 / atol 1e-5, the dense
   parameters as phase 11 holds them. Request and step times are printed
   beside the ROW_WISE runs'.
17. The hierarchical strategies inside an NCCL group of one rank, its env
   of one host of one rank (H = 1, Lc = 1), whose intra- and cross-host
   subgroups are NCCL communicators of their own. bench.py's DLRM with
   tables 0-12 TABLE_ROW_WISE and 13-25 TABLE_COLUMN_WISE on host 0 under
   input_routing="a2a" (two groups) against the group-less ROW_WISE DMP
   from the same seed: 3 requests at B=8192 and 3 at B=256, each
   launching K1 exactly twice and making 5 all_to_alls, 2 all_gathers and
   1 reduce_scatter, logits equal bit for bit; 3 steps at B=8192 under
   EXACT_SGD and ROWWISE_ADAGRAD, each launching K1 and K3 / the fused K4
   twice and making 10 all_to_alls, 5 all_gathers, 1 reduce_scatter and 1
   all_reduce, the trained state within rtol 1e-4 / atol 1e-5, untouched
   rows equal; then the same ROWWISE_ADAGRAD steps through
   make_prefetched_train_step and through SparseDistPipeline (from pinned
   host batches, copied on its side stream): the same state within the
   bound, and each step 2 all_to_alls and 2 all_gathers fewer (each
   group's dist made once a step, for the next batch). BERT4Rec's item
   table TABLE_ROW_WISE (sequence) against the ROW_WISE DMP: requests at
   B=32 and 1024, one routed gather each, logits equal as values; 3 steps
   at B=32, one routed gather, one route-only launch and one fused K4
   each. The position-weighted DLRM (phase 8's, ROW_WISE with one
   TABLE_WISE table) 3 EXACT_SGD steps at B=8192 against the group-less
   ROW_WISE run, each launching K1, K8 (K1's d_coeff) and K3 twice, one
   per group: its lookup's collectives differentiable in the position
   weights, the position weights, dense parameters and tables within the
   bound. Quantized serving: bench.py's DLRM at int8 through
   `shard_quantized` over `ShardingEnv.from_local(1)` with explicit table
   ranks, one Kq launch and one all_gather a request, logits equal bit
   for bit to phase 15's group-less sharded module's.
18. The sharding planner, embedding towers and variable batches. First
   bench.py's tables are planned on 1, 2, 4 and 8 H100s (one host, the
   bench batch split over them) under the card's cost model, and under it
   with a whole-shard stream term added to the update, and the plans
   printed. (a) bench.py's DLRM (DLRMTrain) given no plan: the plan (each
   table's type, kernel, ranks and estimates) and the planner's wall
   time are printed, the DMP's plan must be the planner's; 3 requests at
   B=8192 and 3 at B=256 and 3 steps at B=8192 under EXACT_SGD and
   ROWWISE_ADAGRAD beside the ROW_WISE DMP from the same seed: one lookup
   a request, one lookup and K3 / the fused K4 once a step, the lookup K1
   on the ROW_WISE DMP and K1j on the planned one (its one DATA_PARALLEL
   group, group-less, takes a KeyedJaggedTensor's jagged route), logits
   and trained state within rtol 1e-4 / atol 1e-5 (whether bit for bit is
   printed). (c) The planned DLRM under a masked_bce_with_logits wrapper
   takes one EXACT_SGD step on a VariableBatch of 6,000 real rows padded
   to 8,192 (K1 on its PaddedSparseBatch): its loss and state equal the
   step on the 6,000 rows alone (K1j on their KeyedJaggedTensor) within
   the bound; the pad rows pool to zeros and their pooled values take a
   gradient of exactly 0. Inside an NCCL group of one rank: (b) the tower
   DLRM, tests/test_tower_dmp.py's TowerModel over bench.py's tables
   (two towers of 13 tables, each interaction an MLP 1,664 -> 512 -> 256,
   a Dense(1) head, BCE), given no plan (the planner with one dependency
   tag per tower), group-less and in the group: 3 + 3 requests (K1 once;
   1 all_gather and 1 all_to_all in the group; logits equal bit for bit)
   and 3 steps at B=8192 under EXACT_SGD and ROWWISE_ADAGRAD (K1 and K3 /
   the fused K4 once; 1 all_gather, 2 all_to_alls, 1 all_reduce of the
   interactions' gradients and 1 of the dense ones in the group), states
   within the bound; a CPU copy of the group-less EXACT_SGD run agrees on
   a B=256 request and 2 steps at B=256. (d) shard_quantized over
   from_local(1) without table_ranks: the planner's placement (every
   table on rank 0), 1 Kq and 1 all_gather a request, logits equal the
   explicit placement's bit for bit. Last, the planner's H100 costs are
   re-measured and printed (held to nothing): K1's device time per slot
   at B=8192, and the whole of apply_fused_update under ROWWISE_ADAGRAD
   and EXACT_SGD at B=8192 and B=1024 of bench.py's features: a per-row
   cost from its device time at the two sizes and a fixed cost, its host
   time per call (planner/constants.py holds the numbers).
19. Host-resident (FUSED_UVM_CACHING) tables and reshardable checkpoints.
   (a) The reference's MLPerf DLRM at full width: 26 tables at D=128
   (MLPERF_CARDINALITIES, 97.36 GiB), bench.py's dense arches; its five
   40,000,000-row tables in pinned host memory, each with an 8,000,000-row
   cache on the card, the other 21 ROW_WISE on the card. When
   MemAvailable is under 1.25 x the host tables' bytes (with momenta and
   directories) the five are cut evenly to fit, and the log says
   "reduced" and why. Built (host tables allocated and pinned) and drawn
   (1 GiB chunks from the card), each part timed; 3 requests at B=8192 of
   uniform ids, then 1 + 5 steps under ROWWISE_ADAGRAD, then a new DMP
   and the same under EXACT_SGD (fused lr 0.1, dense SGD 0.05). Every
   request launches K1 6 times (the device group and one per UVM
   feature) and K2 5 times (the misses staged into each cache), every
   step also K3 or the fused K4 6 times; a flush K8 once a table, and
   once more a momentum. The UVM columns of the last request equal the
   host rows of its ids bit for bit; after one step, each UVM table's
   touched rows and momenta equal the plain apply_fused_update on the CPU
   over copies taken before the step, with the step's cotangent (rtol
   1e-6, and 1e-6 of the tensor's scale near zero), and 100,000 seeded
   untouched rows a table are unchanged. Times, cache stats and the peak
   device memory beside the tables' bytes are printed. (b) bench.py's DLRM with tables 13-25 in host memory
   (20,000-row caches) beside the all-device ROW_WISE DMP with the same
   weights: 3 requests at B=8192 (logits bit for bit) and 10 steps under
   ROWWISE_ADAGRAD and EXACT_SGD (losses, tables and momenta within rtol
   1e-6; whether bit for bit is printed), both runs under
   torch.use_deterministic_algorithms (atomic sums of duplicate ids round
   apart, and a ReLU within rounding of zero then moves a row far); the cache stats and every
   request's and step's K2 and K8 launches equal a replay of the
   directories on the CPU. Then save_reshardable from the UVM plan,
   load_reshardable into the all-device ROW_WISE plan and into the
   planner's default (all DATA_PARALLEL on one card, whose steps take the
   jagged route: K1j), and 2 steps on each equal 2 more steps of the saved
   DMP; save_state / restore_state
   resumes bit for bit. The file sizes and save and load times are
   printed.
20. The port's examples through their main(argv) (torchrec_tpu_torch/
   examples/), every train step, eval call and predict call held to its
   launches, the counters' total to their sum. The model is the examples'
   DLRM (D=64, dense 13 -> 512-256-64, over 512-512-256-1,
   ROWWISE_ADAGRAD) over the 26 Criteo Kaggle tables uncapped
   (33,762,577 rows, 8.64 GB of fp32), drawn on the card by the DMP's
   init, at B=8192. (1) A 100,000-line Criteo TSV from seeded numpy,
   parsed by the native parser (csrc/criteo_parser.cpp, g++) and its
   plain version (equal arrays, both rates printed), both preproc CLIs
   run on it; 1,204,224 SyntheticCriteoDataset rows (the ground truth's
   labels) written as three day_* npy triples; the in-memory loader's
   batches/s through the C++ stager (csrc/batch_stager.cpp) into pinned
   tensors and through the numpy route. (2) dlrm_main
   --in_memory_binary_criteo_path over the days under --train_pipeline
   base and sparse_dist: each step one K1 and one fused K4 per sharding
   group of the planner's plan, each eval batch one K1 per group; the
   validation AUROC above the same model's untrained (same seed, same
   validation batches); examples/s and the peak device memory. (3)
   dlrm_main --synthetic_criteo, generated on the card, 50 timed steps
   after a warm-up, examples/s, with (4) --save_dir and --package_dir
   (int8), then dlrm_predict over the package, B=256: direct,
   --serve_batching and --serve_native (one Kq a request); the last
   direct request's logits within 2x the first-order int8 bound of the
   f32 model's, that model loaded from the checkpoint. (5)
   bert4rec_main --synthetic_ml1m in --mode dmp (a step launches the
   routed gather, its route-only mode and K4 once each, an eval batch the
   routed gather) and --mode dp (the routed gather and K4). (6)
   device_latent_score on the card bit for bit with numpy's on edge and
   1 M random ids, the card-made RandomRecDataset and
   SyntheticCriteoDataset batches in range. Each step's seconds and the
   numbers are printed ("examples numbers: {...}").
21. Every table width. (1) The update kernels against their plain
   versions, every one bit for bit, on 4,096-row tables with 3,072 tokens
   (hot rows repeated, 15 % invalid) at D = 1, 3, 10, 130, 516, 1030 and
   4096, and on two unaligned views (an odd row of a D=10 block; a D=128
   table one element into its storage), weight decay 0.01: K2, K3, K4's
   scaled RMW, the fused K4 (its wide path past 512 columns), K5 on the
   unfused route, K6 and K7 on f32 tables, K3h and K4h on bf16 and fp16
   ones under both epilogues; the rowwise routes' momenta bit for bit
   with each other, their rows bit for bit within a momentum route. (2)
   The main path, its launches counted from 0: SimpleDeepFMNN over the 26
   Criteo Kaggle tables at D=10 (33,762,577 rows, 1.35 GB of fp32; BARS'
   Criteo_x1 DeepFM, FuxiCTR's embedding size), dense arch 13 -> 400 ->
   10, deep width 400, fused lr 0.1, dense Adam 1e-3, B=8192. Served
   given no plan (the planner's), under a ROW_WISE plan and with bf16
   tables given no plan: 3 requests at B=8192 and 3 at B=256, one lookup
   each on its narrow path (eight bags a warp at D=10, phase 22): K1j
   under the planner's plan (its DATA_PARALLEL group takes the
   KeyedJaggedTensor's jagged route, f32 and bf16 tables alike), K1 under
   the ROW_WISE plan. Trained given no plan under EXACT_SGD (K3),
   ROWWISE_ADAGRAD on its default route (the fused K4), with mom_impl=
   "xla" (the scaled RMW) and with w_impl="write" (K5 and K2), ADAGRAD
   (K6), ADAM (K7), and with bf16 tables under EXACT_SGD (K3h) and
   ROWWISE_ADAGRAD (K4h), and under the ROW_WISE plan for EXACT_SGD and
   ROWWISE_ADAGRAD: 3 warm-up and 10 timed steps, each launching one
   lookup (K1j given no plan, K1 under the ROW_WISE plan) and its route's
   update and nothing else, losses finite, then one step held against the
   plain versions (the lookup's pooled output against K1's plain version
   over the rows it read, K1j's bags padded to its cap; the touched rows
   and momenta against apply_fused_update on
   the CPU at their own row ids, f32 within EX_RTOL, half rows within one
   ulp; untouched rows equal). The counters must equal the requests' and
   steps' sum. The same f32 model (seeded) quantized to int8 and to int4
   by quantize_embeddings and sharded by shard_quantized (its pooled
   values within their rows' error bounds of the f32 ones, checked
   before the counters start), then served: 3 requests at B=8192 and 3 at
   B=256 a type, each launching exactly one Kq (its narrow path) and no
   K1, every probability within 2x its first-order bound of the f32
   model's. (3) Each default route's kernel held bit-exact and timed
   on its held step's ids and gradients (K3, the fused K4 in turns with
   the unfused composition, K5, K6, K7, K3h and K4h with fp16 copies);
   K1 and K1h at D=10 on a [33,762,577, 10] table and one batch of the
   Kaggle features; the wide rowwise path at D=1030 (100,000 rows, 65,536
   ids) in f32, in turns with the unfused composition, and as K4h in
   bf16 and fp16.
22. Narrow rows. K1 / K1h, the row kernel of K2, K3, K3h and K4's scaled
   RMW, the fused K4 / K4h, K6 / K7, K8, the routed gather and Kq give a
   row of D columns G lanes, the smallest power of two covering its
   ceil(D / 4) quads (ops/lane_groups.py), so a warp holds 32 / G rows
   (bags, tokens) at D <= 64. (1)
   Every lane group held against the plain versions on 4,096-row tables
   at D = 1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 17, 18, 32, 33, 34, 63, 64 and
   128, aligned and one element into their storage (whole quads, pairs
   and single elements): K1 (f32) and K1h (bf16, fp16) over 3,001 bags,
   bit for bit at L=1 and within rtol = atol = 1e-6 at L=20 (MEAN and
   per-sample coefficients, padded slots, ids below 0 and past R); K2, K3
   (weight decay 0 and 0.01), K3h (bf16 and fp16; stochastic rounding
   from row 0 and from row 3 R, and to nearest; weight decay 0 and 0.01),
   the scaled RMW, the fused K4 (weight decay 0 and 0.01), K4h (bf16 and
   fp16; stochastic rounding from row 0 and from row 3 R, and to
   nearest), K6 and K7 (weight decay 0 and 0.01) over 3,001 tokens' run
   totals and dedup output, bit for bit at every slot count a warp of
   each kernel; K8 over 3,001 ids (below 0 and past R) bit for bit; the
   routed gather over [7, 13, 33] tokens (three shard sizes, rank 1,
   padded tokens, ids below 0 and past every shard) by value, +0.0 under
   every masked token, its route-only mode bit for bit; Kq at 8 bits
   (every D), 4 (an even D) and 2 (D % 4 == 0), the packed rows one byte
   into their storage in the offset case, pooled over 3,001 bags at L=20
   and unpooled with and without coefficients, bit for bit. (2) At D=10
   and D=64 on the 26 Criteo Kaggle tables and one B=8192 batch (212,992
   bags and slots): K1, K1h, K8, the routed gather (and its route-only
   mode), Kq at 8 and 4 bits (pooled and unpooled), K3, K2, the scaled
   RMW, the fused K4, K4h and K3h (bf16, fp16), K6 and K7 held bit-exact
   (the routed gather by value)
   (K4, K6 and K7, whose tables are too large to clone, on the rows they
   update and on 4,096 seeded rows of the table and, at D=64, 4,096 more
   past element 2^31) and timed beside their bounds, plain versions and
   PyTorch calls (F.embedding_bag, index_select, the quantized embedding
   bag of phase 15, index_add_, index_copy_, index_add_ of the pre-scaled
   rows, index_add_ of K3h's rounded update, held within one ulp of K3h
   to nearest; the fused K4 in turns with the unfused composition it
   replaced; none for the routed gather, K4h, K6 and K7); K8, the routed
   gather and Kq also beside a sector bound (every 32-byte sector their
   distinct rows, and Kq's scales and shifts, touch).
23. The DLRM's dot interaction (ops/dot_interaction.py, one kernel a
   direction in place of the cat, Gram bmm, upper-triangle gather and cat,
   and their backward). Held against its plain version at the Criteo
   Kaggle DLRM's shape (B = 65,536, n = 27, D = 64), at bench.py's D = 128,
   at D = 63 and 66 (the element access) and at n = 64, one launch each
   way: the forward bit for
   bit (but the one example of a 65,536 batch that cuBLAS sums with
   another kernel) and within D * 2^-24 of the float64 products' scale,
   the backward within 1e-5 of its scale. Timed at the Kaggle shape,
   forward, backward and both, in turns with the plain version, the
   composition it replaced (its backward the gather's sorted index_put_
   and the bmm's two products) and the index_select composition as the
   library yardstick, beside the bytes bound (0.168 ms forward, 0.303 ms
   backward); the kernel must beat the yardstick. bench.py's DLRM then
   takes 2 steps and 2 requests at B=8192: each step launches the
   forward and the backward once (counters `dot_interaction`,
   `dot_interaction_bwd`), each request the forward once.
24. K1j, the offsets form of the pooled lookup (a bag pools
   ids[offsets[b]:offsets[b + 1]], at most a cap of them), at MLPerf
   DLRM-DCNv2's lookup on one card: the 26 tables of one GPU's share of
   the 8-GPU deployment (MLPERF_CARDINALITIES, each table over 100,000
   rows cut to its row-wise eighth; 25,629,123 x 128 f32), 8,192
   examples of 214 ids in the published per-feature lengths (one feature
   of 100), Zipf(1.05) ids over each table. Held at cap 100 without
   coefficients, and at cap 17 with MEAN-and-weight coefficients: equal
   bit for bit to K1 on the same bags padded to the cap, and within
   2^-20 of each bag's sum of |c| |w| of its plain version (a multiply,
   then torch's sum); a sign flipped, a row or a bag's last id dropped
   moves a sum by far more. Timed beside its bytes bound (each distinct
   row read once, the ids, offsets and output once), its plain version,
   F.embedding_bag with offsets and K1 on the bags padded to 100.

Kernel times are device times from torch.profiler (the kernel's own for a
kernel, all device activity of the call for the plain version and the
library call); the log gives each wrapper call's CUDA-event time beside
it, which includes the host's time to make the call where that is longer.

The line before the last is a JSON object with every kernel's numbers
(K1h, K3h and K4h with an "fp16" sub-entry, K4h with "bert4rec_shape",
Kq with "int4" and K1's time at the same ids, K1j with phase 24's
"mlperf_dcn_shape" and the launches of phases 18, 19 and 21's
KeyedJaggedTensor paths; phase 21's under
"widths", "d10_shape" and "wide_d1030", phase 22's under "narrow",
"narrow_d10" and "narrow_d64", the scaled RMW's under K4's
"scaled_rmw"; phase 23's as a last entry, "dot_interaction", with the
launches that bench.py's DLRM counted in its steps and requests);
the last line is {"ok": true, "device": {...}}. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# bench_config.py's DLRM (copied, not imported: the port reads nothing of
# the JAX package's files)
NUM_TABLES = 26
ROWS = 100_000
DIM = 128
DENSE_IN = 13
DENSE_ARCH = (512, 256, DIM)
OVER_ARCH = (1024, 1024, 512, 256, 1)
L = 1
BENCH_BATCH = 8192  # bench_config.B
SERVE_BATCH = 256  # examples/dlrm_predict.py --batch_size default
REQUESTS_PER_BATCH = 3
SEED = 0

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
MODULE_KEY = "sparse_arch/embedding_bag_collection"
TRAIN_KEY = "dlrm/" + MODULE_KEY  # the same EBC inside DLRMTrain
FUSED_LR = 0.1  # bench.py: fused_params={"learning_rate": 0.1}
DENSE_LR = 0.05  # bench.py: dense_optimizer=optax.sgd(0.05)
WARMUP_STEPS, TIMED_STEPS, CPU_STEPS = 3, 10, 2
START_STEP = 5  # the optimizer step the card-against-CPU runs start at
DEVICE = "cuda"

# examples/bert4rec_main.py --synthetic_ml1m with its defaults (copied)
B4R_ITEMS = 3706  # ML-1M's movies
B4R_VOCAB = B4R_ITEMS + 2  # + pad id 0 + MASK
B4R_MASK = B4R_VOCAB - 1
B4R_LEN, B4R_DIM, B4R_HEADS, B4R_LAYERS = 64, 64, 2, 2
B4R_BATCH = 32  # --batch_size
B4R_RANK_BATCH = 1024  # a larger ranking request
B4R_MASK_PROB = 0.2
B4R_EMB_LR, B4R_DENSE_LR = 0.01, 1e-3  # --emb_lr, optax.adam(--lr)
B4R_USERS = 512  # sequences drawn for the batches (ML-1M has 6040)
B4R_KEY = "model/ec"
# K8 at a bytes-bound shape: slice 2's packed DLRM shard and one B=8192
# batch's ids
K8_ROWS, K8_DIM, K8_IDS = 2_600_064, 128, 212_992
# K8 in K1's backward as check_backward drives it: B=2048 bags of L=20
K1_BWD_IDS = 2048 * 20
# the position-weighted DLRM: multi-hot, lengths uniform in 1..PW_LEN
PW_LEN = 20
PW_WARMUP_STEPS, PW_TIMED_STEPS, PW_PROFILED_STEPS = 1, 3, 2
# how far the card's pooled cotangent may lie from the CPU's in norm when
# the two sides' ReLUs disagree on a pre-activation within rounding of
# zero (check_pw_cotangent.py on an H100: at most 7.9e-3 over 106
# repetitions); a fault in the dense backward moves it by O(1)
COTANGENT_REL = 0.1
# the forward's tolerance: a ReLU pre-activation within it of zero takes
# the card's branch on the CPU in check_pw_against_cpu
FWD_ATOL = 1e-5

# the fused rowwise kernels' names as the profiler prints them: rows of up
# to 64 columns (rowwise_adagrad_narrow_kernel), up to 512
# (rowwise_adagrad_kernel) and wider (..._wide_kernel)
ROWWISE_KERNELS = "rowwise_adagrad_"
# K6's and K7's kernel (moment_update_kernel)
MOMENT_KERNELS = "moment_"
# the row kernel of K2, K3, K3h and K4's scaled RMW
ROW_KERNEL = "row_update_kernel"
# K1's and K1h's kernels as the profiler prints them: rows of up to 64
# columns (tbe_lookup_narrow_kernel) and wider (tbe_lookup_pooled_kernel);
# K1j's (tbe_lookup_jagged_kernel)
K1_KERNELS = "tbe_lookup_"
# K8's (gather_rows_narrow_kernel, gather_rows_kernel), the routed gather's
# (routed_gather_narrow_kernel, routed_gather_kernel) and Kq's
# (quant_lookup_narrow_kernel, quant_lookup_kernel), the same way
K8_KERNELS = "gather_rows_"
ROUTED_KERNELS = "routed_gather_"
KQ_KERNELS = "quant_lookup_"
# kernel -> (wrapper name, source, the Pallas function it replaces)
KERNELS = {
    "K1": ("tbe_lookup_pooled", "torchrec_tpu_torch/csrc/tbe_lookup.cu",
           "torchrec_tpu/ops/pallas_embedding.py:298"),
    "K2": ("scatter_rows_write", "torchrec_tpu_torch/csrc/fused_update.cu",
           "torchrec_tpu/ops/pallas_embedding.py:189"),
    "K3": ("fused_update_sgd", "torchrec_tpu_torch/csrc/fused_update.cu",
           "torchrec_tpu/ops/pallas_embedding.py:577"),
    "K4": ("fused_update_rowwise_adagrad",
           "torchrec_tpu_torch/csrc/fused_update.cu",
           "torchrec_tpu/ops/pallas_embedding.py:617"),
    "K5": ("rowwise_momentum_stream",
           "torchrec_tpu_torch/csrc/fused_update.cu",
           "torchrec_tpu/ops/pallas_embedding.py:902"),
    "K6": ("fused_update_adagrad", "torchrec_tpu_torch/csrc/fused_update.cu",
           "torchrec_tpu/ops/pallas_embedding.py:1033"),
    "K7": ("fused_update_adam", "torchrec_tpu_torch/csrc/fused_update.cu",
           "torchrec_tpu/ops/pallas_embedding.py:1089"),
    "K8": ("gather_rows", "torchrec_tpu_torch/csrc/gather_rows.cu",
           "torchrec_tpu/ops/pallas_embedding.py:91"),
    # K8 redesigned for the sharded sequence path: the route of
    # torchrec_tpu/parallel/strategies.py:829 and the mask multiply fused in
    "K8r": ("routed_gather_rows", "torchrec_tpu_torch/csrc/gather_rows.cu",
            "torchrec_tpu/ops/pallas_embedding.py:91"),
    # the half-table forms of K1, K3 and the fused K4, in place of what the
    # JAX package runs in XLA for bf16 / fp16 tables (its Pallas kernels
    # take f32 only): the gather + einsum pooling, and the SGD / rowwise
    # Adagrad branches of apply_fused_update's XLA route
    "K1h": ("tbe_lookup_pooled_half", "torchrec_tpu_torch/csrc/tbe_lookup.cu",
            "torchrec_tpu/ops/embedding.py:103"),
    "K3h": ("fused_update_sgd_half", "torchrec_tpu_torch/csrc/fused_update.cu",
            "torchrec_tpu/ops/fused_update.py:534"),
    "K4h": ("fused_update_rowwise_adagrad_half",
            "torchrec_tpu_torch/csrc/fused_update.cu",
            "torchrec_tpu/ops/fused_update.py:647"),
    # the offsets form of K1 for a jagged batch, where the JAX package
    # pads the batch to [F, B, L] first (KeyedJaggedTensor.to_padded)
    "K1j": ("tbe_lookup_jagged_forward",
            "torchrec_tpu_torch/csrc/tbe_lookup.cu",
            "torchrec_tpu/sparse/jagged.py:356"),
    # the int-N dequantizing pooled lookup, in place of the XLA gather,
    # unpack, dequantize and einsum of the quantized lookup
    "Kq": ("quant_lookup_pooled", "torchrec_tpu_torch/csrc/quant_lookup.cu",
           "torchrec_tpu/ops/quant.py:87"),
}
# launch counters beside the kernels': K4's scaled RMW, which the rowwise
# routes other than the fused one launch, and the routed gather's
# route-only mode, which the sharded EC's update launches
SCALED = "scaled_row_update"
ROUTE = "route_tokens"
QROWS = "quant_lookup_rows"  # Kq's unpooled mode
# the kernels of each optimizer's train step, beside K1 (once each)
STEP_KERNELS = {"EXACT_SGD": ("K3",), "ROWWISE_ADAGRAD": ("K4",),
                "ADAGRAD": ("K6",), "ADAM": ("K7",)}
# one step on each other route of the update: (optimizer, fused_params,
# the launches of the step beside K1's one)
ROUTE_STEPS = [
    ("ROWWISE_ADAGRAD", {"w_impl": "write"}, {"K2": 1, "K5": 1}),
    ("ROWWISE_ADAGRAD", {"mom_impl": "xla"}, {SCALED: 1}),
    ("ADAGRAD", {"w_impl": "write"}, {"K2": 2}),
    ("ADAM", {"w_impl": "write"}, {"K2": 3}),
]


def log(*args) -> None:
    print(*args, flush=True)


def identify() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"device: {name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"name": name, "smi": smi}


def build_kernels(libraries) -> None:
    """Build every library from its source, one nvcc each, all at once."""
    with ThreadPoolExecutor(len(libraries)) as pool:
        futures = [pool.submit(lib.build, True) for lib in libraries]
    for fut in futures:
        info = fut.result()
        log(f"built {info['path']} in {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  " + line.strip())


def expected(**launches) -> dict:
    """Launches per counter: those given, 0 for every other one."""
    return {k: launches.get(k, 0) for k in (*KERNELS, SCALED, ROUTE, QROWS)}


# the registry's counter (utils/tracing.py) of each kernel of KERNELS whose
# counter has another name than its wrapper
COUNTERS = {"K1": "tbe_lookup", "K1h": "tbe_lookup_half",
            "K1j": "tbe_lookup_jagged", "Kq": "quant_lookup"}
_counted_from: dict = {}


def counts() -> dict:
    """Launches per kernel since the last `reset_counts`."""
    from torchrec_tpu_torch.utils import tracing

    now = tracing.counts()
    names = {k: COUNTERS.get(k, name) for k, (name, _, _) in KERNELS.items()}
    names.update({c: c for c in (SCALED, ROUTE, QROWS)})
    return {k: now.get(n, 0) - _counted_from.get(n, 0)
            for k, n in names.items()}


def reset_counts() -> None:
    from torchrec_tpu_torch.utils import tracing

    _counted_from.clear()
    _counted_from.update(tracing.counts())


def kjt_lookups(dmp, key: str) -> dict:
    """The lookup launches of one forward of `dmp`'s sharded EBC `key` on a
    KeyedJaggedTensor, by ShardedEmbeddingBagCollection's route rule: K1j
    for each group that takes the jagged route (DATA_PARALLEL without a
    process group), K1 (K1h on half tables) for each other group."""
    out: dict = {}
    for strat in dmp.sharded_ebcs[key].strategies:
        k = ("K1j" if strat.supports_jagged
             else "K1" if strat.weights.dtype == torch.float32 else "K1h")
        out[k] = out.get(k, 0) + 1
    return out


def make_dmp(device: str, train: bool = False, optim=None,
             fused_params=None, position_weighted: bool = False,
             data_type=None, env=None, plan_types=None, wrap=None):
    """bench.py's DLRM (DLRMTrain when `train`) on `device`; `optim`
    defaults to the DMP's (ROWWISE_ADAGRAD). `position_weighted` wraps
    its EBC (weighted, L=PW_LEN) in a FeatureProcessedEmbeddingBagCollection
    with a PositionWeightedModule of PW_LEN positions per feature.
    `data_type` is the tables' DataType (default FP32). `env` (default:
    one device, no process group) and `plan_types`, the ShardingType name
    of each table (default every table ROW_WISE; a TABLE_WISE one on rank
    0), or "planned": no plan, the DMP's planner places the tables.
    `wrap` (train only) builds the trained module from the DLRM in place
    of DLRMTrain."""
    from torchrec_tpu_torch.models import DLRM, DLRMTrain
    from torchrec_tpu_torch.modules import (
        EmbeddingBagCollection,
        EmbeddingBagConfig,
        FeatureProcessedEmbeddingBagCollection,
        PositionWeightedModule,
    )
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )

    from torchrec_tpu_torch.modules.embedding_configs import DataType

    tables = [
        EmbeddingBagConfig(num_embeddings=ROWS, embedding_dim=DIM,
                           name=f"t{i}", feature_names=[f"f{i}"],
                           data_type=data_type or DataType.FP32)
        for i in range(NUM_TABLES)
    ]
    if position_weighted:
        sparse = FeatureProcessedEmbeddingBagCollection(
            EmbeddingBagCollection(tables, is_weighted=True,
                                   max_feature_length=PW_LEN, device="meta"),
            PositionWeightedModule({t.feature_names[0]: PW_LEN
                                    for t in tables}, device="meta"))
    else:
        sparse = EmbeddingBagCollection(tables, max_feature_length=L,
                                        device="meta")
    model = DLRM(sparse, DENSE_IN, DENSE_ARCH, OVER_ARCH, device="meta")
    if train:
        model = (wrap or DLRMTrain)(model)
    types = plan_types or ("ROW_WISE",) * NUM_TABLES
    plan = None if types == "planned" else ShardingPlan({
        TRAIN_KEY if train else MODULE_KEY: {
            t.name: ParameterSharding(
                ShardingType[st], ranks=[0] if st == "TABLE_WISE" else None)
            for t, st in zip(tables, types)}})
    return DistributedModelParallel(
        model, env=env, plan=plan, device=device,
        fused_optim=optim or EmbOptimType.ROWWISE_ADAGRAD,
        fused_params={"learning_rate": FUSED_LR, **(fused_params or {})},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=DENSE_LR))


def make_request(rng: np.random.RandomState, batch: int):
    """(dense [B, 13] f32, KeyedJaggedTensor of 26 features x B x 1)."""
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    ids = rng.randint(0, ROWS, size=NUM_TABLES * batch).astype(np.int32)
    lengths = np.ones(NUM_TABLES * batch, np.int32)
    dense = rng.randn(batch, DENSE_IN).astype(np.float32)
    kjt = KeyedJaggedTensor.from_lengths(
        [f"f{i}" for i in range(NUM_TABLES)], ids, lengths)
    return torch.from_numpy(dense), kjt


def make_batch(rng: np.random.RandomState, batch: int):
    """(dense, KeyedJaggedTensor, labels [B] in {0, 1}) on the CPU."""
    dense, kjt = make_request(rng, batch)
    labels = rng.randint(0, 2, size=batch).astype(np.float32)
    return dense, kjt, torch.from_numpy(labels)


def to_device(batch):
    dense, kjt, labels = batch
    return dense.to(DEVICE), kjt.to(DEVICE), labels.to(DEVICE)


def serve(dmp) -> dict:
    """The serving path: requests through make_eval_fn, K1 counted."""
    eval_fn = dmp.make_eval_fn()
    rng = np.random.RandomState(SEED)
    requests = [(b, *make_request(rng, b))
                for b in [BENCH_BATCH] * REQUESTS_PER_BATCH
                + [SERVE_BATCH] * REQUESTS_PER_BATCH]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    latencies = {BENCH_BATCH: [], SERVE_BATCH: []}
    last = None
    for batch, dense, kjt in requests:
        t0 = time.perf_counter()
        logits = eval_fn(dense.to(DEVICE), kjt.to(DEVICE)).cpu()
        latencies[batch].append((time.perf_counter() - t0) * 1e3)
        if logits.shape != (batch, 1) or not torch.isfinite(logits).all():
            raise AssertionError(
                f"bad logits at B={batch}: {tuple(logits.shape)}")
        last = (dense, kjt, logits)
    launches = counts()
    if launches != expected(K1=len(requests)):
        raise AssertionError(
            f"{len(requests)} requests launched {launches}")
    launches = launches["K1"]
    peak = torch.cuda.max_memory_allocated()
    for batch, ms in latencies.items():
        log(f"serve B={batch}: request ms (host clock, H2D + forward + "
            f"D2H, first includes warm-up) {ms}")
    log(f"serve: {len(requests)} requests, K1 launches {launches}, "
        f"max_memory_allocated {peak} B")

    # forward alone on device-resident inputs, after the warm-up above
    fwd = {}
    for batch in (BENCH_BATCH, SERVE_BATCH):
        dense, kjt = make_request(rng, batch)
        dense, kjt = dense.to(DEVICE), kjt.to(DEVICE)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eval_fn(dense, kjt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        fwd[batch] = times
        log(f"serve B={batch}: forward ms (host clock, synchronized) "
            f"{times}")
    return {"launches": launches, "last": last, "peak_bytes": peak,
            "request_ms": latencies, "forward_ms": fwd}


def check_against_cpu(dmp, last, data_type=None) -> None:
    dense, kjt, logits = last
    cpu = make_dmp("cpu", data_type=data_type)
    cpu.load_state_dict(dmp.state_dict())
    ref = cpu.make_eval_fn()(dense, kjt.to("cpu"))
    torch.testing.assert_close(logits, ref, rtol=1e-4, atol=1e-5)
    log(f"serve B={dense.shape[0]}: GPU logits match the CPU run, max abs "
        f"diff {(logits - ref).abs().max().item():.3e}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Stream time per call between CUDA events around `iters` calls: the
    device time, or the host's time to make a call where that is longer."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str = "", bound_ms: float = 0.0, iters: int = 20,
              warmup: int = 3, attempts: int = 6) -> float:
    """Device time per call from torch.profiler over `iters` calls: the
    summed duration of every device activity (kernels, copies) in the
    window over `iters`; only kernels whose name contains `kernel` when it
    is given.

    The profiler loses events: with tracing started at the window, the
    first few launches went missing (17 of 20 was common). So the window
    follows one profiler warm-up step of `iters` calls, whose events are
    dropped, and a window is whole only when every name's event count is
    a multiple of `iters`, it has events, and its time is at least a
    quarter of `bound_ms` (no cache of the card serves bytes four times as
    fast as its memory). Anything else is profiled again, up to `attempts`
    times: a partial window is never rounded up. When no attempt gives a
    whole window (a card's profiler has lost events in every attempt), the
    time is taken by CUDA events instead (queued_ms): all of a call's
    device work, not only the kernels named `kernel`, so never less than
    the profiler's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(warmup):
        fn()
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        durations = {}
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA and not e.is_user_annotation
                    and kernel in e.name):
                durations.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        ms = sum(sum(d) for d in durations.values()) / iters / 1e3
        counted = {n: len(d) for n, d in durations.items()}
        whole = not any(c % iters for c in counted.values())
        if durations and whole and ms >= bound_ms / 4:
            return ms
        log(f"device_ms: {ms:.5f} ms from events {counted} for {kernel!r} "
            f"over {iters} calls, bound {bound_ms:.5f} ms (attempt "
            f"{attempt + 1} of {attempts}): not a whole window")
    ms = queued_ms(fn, iters)
    log(f"device_ms: no whole profiler window for {kernel!r} in {attempts} "
        f"attempts; {ms:.5f} ms per call from CUDA events around {iters} "
        f"queued calls (all of the call's device work) used instead")
    return ms


def queued_ms(fn, iters: int = 20, warmup: int = 3,
              spin_cycles: int = 100_000_000) -> float:
    """Device time per call from CUDA events around `iters` calls that the
    host queues while the card spins (torch.cuda._sleep, about 50 ms), so
    that the card runs them back to back and the host's launch time does
    not count, unless a call waits for the card."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timings(kernel_fn, kernel: str, bound_ms: float, plain_fn,
            library_fn=None) -> dict:
    """The kernel's own device time, its wrapper call's stream time, and
    the device times of the plain version and the library call, each of
    which computes the same function and so is held to the same bound."""
    return {
        "ms": device_ms(kernel_fn, kernel, bound_ms),
        "call_ms": cuda_ms(kernel_fn, 20),
        "plain_ms": device_ms(plain_fn, bound_ms=bound_ms),
        "library_ms": (None if library_fn is None
                       else device_ms(library_fn, bound_ms=bound_ms)),
    }


def bound(weights, ids, coeff) -> dict:
    """Least time for the lookup: bytes (each input read once, each output
    written once; only the distinct rows that a nonzero coefficient
    reads) over HBM rate, against 2 flops per pooled element over the fp32
    rate."""
    R, D = weights.shape
    NB, Lk = ids.shape
    live = ids.clamp(0, R - 1)[coeff != 0]
    rows = int(torch.unique(live).numel())
    nbytes = (rows * D * weights.element_size() + ids.numel() * 4
              + coeff.numel() * 4 + NB * D * 4)
    flops = 2 * int(live.numel()) * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {"bytes": nbytes, "rows": rows, "flops": flops,
            "ms": max(t_bytes, t_ops) * 1e3,
            "by": "bytes" if t_bytes >= t_ops else "operations"}


def jagged_bound(weights, ids, offsets) -> dict:
    """`bound` for K1j over every id of its bags: the distinct rows, the
    ids, the offsets and the output, against 2 flops an id's element."""
    R, D = weights.shape
    rows = int(torch.unique(ids.clamp(0, R - 1)).numel())
    NB = offsets.shape[0] - 1
    nbytes = (rows * D * weights.element_size() + ids.numel() * 4
              + offsets.numel() * 4 + NB * D * 4)
    flops = 2 * ids.numel() * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {"bytes": nbytes, "rows": rows, "flops": flops,
            "ms": max(t_bytes, t_ops) * 1e3,
            "by": "bytes" if t_bytes >= t_ops else "operations"}


def lookup_inputs(strat) -> tuple:
    """The served table's lookups as the main path makes them (one id per
    bag, coefficient 1) and at L=20: per-sample weights, MEAN rows,
    zero-padded slots, ids >= R. (ids, coeff, ids20, coeff20) on the
    card."""
    R = strat.weights.shape[1]
    rng = np.random.RandomState(SEED + 1)
    NB = NUM_TABLES * BENCH_BATCH
    offs = np.repeat(strat.local_offsets.astype(np.int32), BENCH_BATCH)
    ids = torch.from_numpy(
        (rng.randint(0, ROWS, size=NB).astype(np.int32) + offs)[:, None]
    ).to(DEVICE)
    coeff = torch.ones((NB, 1), device=DEVICE)
    L20 = 20
    ids20 = torch.from_numpy(
        rng.randint(0, R + 1000, size=(NB, L20)).astype(np.int32)).to(DEVICE)
    lengths = torch.from_numpy(rng.randint(0, L20 + 1, size=NB)).to(DEVICE)
    mask = (torch.arange(L20, device=DEVICE)[None, :] < lengths[:, None])
    psw = torch.from_numpy(rng.rand(NB, L20).astype(np.float32)).to(DEVICE)
    mean = mask / lengths.clamp(min=1)[:, None]
    coeff20 = torch.where(
        torch.arange(NB, device=DEVICE)[:, None] % 2 == 0,
        mean, mask * psw).float().contiguous()
    return ids, coeff, ids20, coeff20


def check_kernel(dmp, tl) -> dict:
    """K1 on the served table: main-path shape, then L=20."""
    import torch.nn.functional as F

    strat = dmp.sharded_ebcs[MODULE_KEY].strategies[0]
    W = strat.weights[0]  # [2,600,064, 128]: 26 x 100,000 padded to 128
    D = W.shape[1]
    ids, coeff, ids20, coeff20 = lookup_inputs(strat)
    NB = ids.shape[0]
    out = tl.tbe_lookup_pooled(W, ids, coeff)
    ref = tl.tbe_lookup_pooled_reference(W, ids, coeff)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("K1 at L=1 is not bit-exact with its plain "
                             "version")
    err = (out - ref).abs().max().item()
    log(f"K1 L=1 NB={NB} D={D}: bit-exact with the plain version")

    out20 = tl.tbe_lookup_pooled(W, ids20, coeff20)
    ref20 = tl.tbe_lookup_pooled_reference(W, ids20, coeff20)
    torch.testing.assert_close(out20, ref20, rtol=1e-6, atol=1e-6)
    err20 = (out20 - ref20).abs().max().item()
    log(f"K1 L=20: within rtol=atol=1e-6 of the plain version, max abs "
        f"err {err20:.3e}")
    del ref20

    b = bound(W, ids, coeff)
    t = timings(lambda: tl.tbe_lookup_pooled(W, ids, coeff),
                K1_KERNELS, b["ms"],
                lambda: tl.tbe_lookup_pooled_reference(W, ids, coeff),
                lambda: F.embedding_bag(ids, W, mode="sum",
                                        per_sample_weights=coeff))
    log(f"K1 L=1: {t['ms']:.4f} ms on the device (call {t['call_ms']:.4f} "
        f"ms); plain {t['plain_ms']:.4f} ms; F.embedding_bag "
        f"{t['library_ms']:.4f} ms; bound {b['ms']:.4f} ms ({b['by']}: "
        f"{b['bytes']} B with {b['rows']} distinct rows); kernel at "
        f"{100 * b['ms'] / t['ms']:.1f}% of the bound")
    b20 = bound(W, ids20, coeff20)
    ms20 = device_ms(lambda: tl.tbe_lookup_pooled(W, ids20, coeff20),
                     K1_KERNELS, b20["ms"])
    log(f"K1 L=20: {ms20:.4f} ms; bound {b20['ms']:.4f} ms ({b20['by']}); "
        f"kernel at {100 * b20['ms'] / ms20:.1f}% of the bound")
    return {"max_abs_err": max(err, err20), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
            "bound_ms": b["ms"], "bound_by": b["by"]}


def train(optim) -> dict:
    """The training path: WARMUP_STEPS + TIMED_STEPS train steps at
    B=8192, each launching exactly the kernels of `optim`'s update."""
    name = optim.name
    dmp = make_dmp(DEVICE, train=True, optim=optim).init(SEED)
    step = dmp.make_train_step()
    rng = np.random.RandomState(SEED + 2)
    batches = [to_device(make_batch(rng, BENCH_BATCH))
               for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    per_step = expected(K1=1, **{k: 1 for k in STEP_KERNELS[name]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, losses = [], []
    for batch in batches:
        before = counts()
        t0 = time.perf_counter()
        loss, _ = step(*batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        after = counts()
        launched = {k: after[k] - before[k] for k in after}
        if launched != per_step:
            raise AssertionError(f"{name} step {len(ms)} launched "
                                 f"{launched}, expected {per_step}")
        losses.append(loss.item())
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"{name} step {len(ms)}: loss {losses[-1]}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    timed = ms[WARMUP_STEPS:]
    ex_per_s = TIMED_STEPS * BENCH_BATCH / (sum(timed) / 1e3)
    log(f"train {name} B={BENCH_BATCH}: losses {losses}")
    log(f"train {name}: warm-up step ms {ms[:WARMUP_STEPS]}; timed step ms "
        f"(host clock, synchronized) {timed}; min {min(timed):.4f} max "
        f"{max(timed):.4f} median {sorted(timed)[TIMED_STEPS // 2]:.4f}; "
        f"{ex_per_s:.1f} examples/s over the {TIMED_STEPS} timed steps")
    log(f"train {name}: launches per step {per_step}, in all {launches}; "
        f"max_memory_allocated {peak} B")
    return {"dmp": dmp, "launches": launches, "ms": timed,
            "ex_per_s": ex_per_s, "peak_bytes": peak}


def route_step(name: str, params: dict, launches: dict) -> dict:
    """One step of optimizer `name` with `params` in its fused_params,
    which must launch K1 once and `launches`."""
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType

    dmp = make_dmp(DEVICE, train=True, optim=EmbOptimType[name],
                   fused_params=params).init(SEED)
    step = dmp.make_train_step()
    batch = to_device(make_batch(np.random.RandomState(SEED + 6),
                                 BENCH_BATCH))
    torch.cuda.synchronize()
    reset_counts()
    loss, _ = step(*batch)
    got = counts()
    expect = expected(K1=1, **launches)
    if got != expect or not math.isfinite(loss.item()):
        raise AssertionError(f"{name} {params} step launched {got} "
                             f"(expected {expect}), loss {loss.item()}")
    log(f"train {name} {params}: one step launched {got}")
    return got


def _touched(strat, batches) -> torch.Tensor:
    """[rows_loc] bool: the packed rows the batches' ids address."""
    off = torch.as_tensor(strat.local_offsets, dtype=torch.int64)
    mask = torch.zeros(strat.rows_loc, dtype=torch.bool)
    for _, kjt, _ in batches:
        feature = torch.repeat_interleave(torch.arange(NUM_TABLES),
                                          kjt.length_per_key().long())
        mask[kjt.values.long() + off[feature]] = True
    return mask


def check_train_against_cpu(optim) -> None:
    """CPU_STEPS steps at B=256 of a fresh card DMP and its CPU copy.

    The optimizer state starts at step START_STEP with momenta drawn from
    U(0, 0.01), as the CPU tests start the JAX and port DMPs. From zero
    momenta the first ADAGRAD / ADAM / LAMB step is lr * g / (|g| + eps)
    per element, which turns the last-bit differences of a gradient
    element near eps (GEMM sums in another order) into differences of
    order lr: that would compare summation orders, not the update."""
    name = optim.name
    gpu = make_dmp(DEVICE, train=True, optim=optim).init(SEED + 3)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    for strat in gpu.sharded_ebcs[TRAIN_KEY].strategies:
        for m in (strat.momentum1, strat.momentum2):
            if m is not None:
                m.uniform_(0.0, 0.01, generator=gen)
        strat.step.fill_(START_STEP)
    cpu = make_dmp("cpu", train=True, optim=optim)
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.RandomState(SEED + 4)
    batches = [make_batch(rng, SERVE_BATCH) for _ in range(CPU_STEPS)]
    step_g, step_c = gpu.make_train_step(), cpu.make_train_step()
    for i, batch in enumerate(batches):
        loss_g, _ = step_g(*to_device(batch))
        loss_c, _ = step_c(*batch)
        torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-4,
                                   atol=1e-5)
        log(f"train {name} B={SERVE_BATCH} step {i}: card loss "
            f"{loss_g.item():.9g}, CPU loss {loss_c.item():.9g}")
    pg = dict(gpu.module.named_parameters())
    for pname, p in cpu.module.named_parameters():
        torch.testing.assert_close(pg[pname].detach().cpu(), p.detach(),
                                   rtol=1e-4, atol=1e-5)
    sg = gpu.sharded_ebcs[TRAIN_KEY].strategies[0]
    sc = cpu.sharded_ebcs[TRAIN_KEY].strategies[0]
    touched = _touched(sc, batches)
    pairs = [("table", sg.weights[0].cpu(), sc.weights[0])]
    for what in ("momentum1", "momentum2"):
        if getattr(sc, what) is not None:
            pairs.append((what, getattr(sg, what)[0].cpu(),
                          getattr(sc, what)[0]))
    for what, a, b in pairs:
        torch.testing.assert_close(a[touched], b[touched], rtol=1e-4,
                                   atol=1e-5)
        if not torch.equal(a[~touched], b[~touched]):
            raise AssertionError(f"{name}: untouched {what} rows differ")
        err = (a[touched] - b[touched]).abs().max().item()
        log(f"train {name}: {int(touched.sum())} touched {what} rows within "
            f"rtol 1e-4 / atol 1e-5 of the CPU run (max abs diff "
            f"{err:.3e}), the rest equal")
    log(f"train {name}: dense parameters match the CPU run")


def rows_bound(N: int, n_real: int, D: int, rows_moved: int,
               extra_bytes: int = 0, flops_per_elem: int = 2,
               row_bytes: int = 4) -> dict:
    """Least time for a row kernel: the N ids, `rows_moved` rows of D
    elements of `row_bytes` (f32 by default) per real slot (sentinel slots
    move only their id) and `extra_bytes` over HBM rate, against
    `flops_per_elem` per moved element over the fp32 rate."""
    nbytes = N * 4 + n_real * D * row_bytes * rows_moved + extra_bytes
    flops = n_real * D * flops_per_elem
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {"bytes": nbytes, "ms": max(t_bytes, t_ops) * 1e3,
            "by": "bytes" if t_bytes >= t_ops else "operations"}


def _hold(name: str, pairs) -> float:
    """Bit-exact comparison of (kernel, plain) outputs; max abs error."""
    torch.cuda.synchronize()
    err = 0.0
    for a, b in pairs:
        if not torch.equal(a, b):
            diff = (a - b).abs().max().item()
            raise AssertionError(f"{name} is not bit-exact with its plain "
                                 f"version: max abs diff {diff:.3e}")
        err = max(err, (a - b).abs().max().item())
    return err


def batch_grads(strat):
    """One real batch's packed ids, validity and per-token row gradients
    [N, D] for the strategy's table (cotangents drawn at 1e-3)."""
    from torchrec_tpu_torch.ops import fused_update as fu

    D = strat.weights.shape[-1]
    rng = np.random.RandomState(SEED + 5)
    _, kjt, _ = make_batch(rng, BENCH_BATCH)
    sb = kjt.to(DEVICE).to_padded(L)
    off = torch.as_tensor(strat.local_offsets, dtype=torch.int32,
                          device=DEVICE)
    flat = (sb.ids + off[:, None, None]).reshape(-1)
    valid = sb.mask().reshape(-1)
    d_pooled = torch.from_numpy(
        (rng.randn(NUM_TABLES, BENCH_BATCH, D) * 1e-3).astype(np.float32)
    ).to(DEVICE)
    row_grads = fu.pooled_grad_to_row_grads(
        d_pooled, sb.lengths, L).reshape(-1, D)
    return flat, valid, row_grads


def check_sgd(fk, W, u_rt, g_rt, lr) -> dict:
    """K3 on clones of a table and one batch's run totals: bit-exact with
    its plain version at weight decay 0 and 0.01, then timed beside
    index_add_ on the real slots."""
    R, D = W.shape
    real = u_rt < R
    ids_real, g_real = u_rt[real].long(), g_rt[real]
    errs = []
    for wd in (0.0, 0.01):
        W1, W2 = W.clone(), W.clone()
        fk.fused_update_sgd(W1, u_rt, g_rt, lr, weight_decay=wd)
        fk.fused_update_sgd_reference(W2, u_rt, g_rt, lr, weight_decay=wd)
        errs.append(_hold("K3", [(W1, W2)]))
    b = rows_bound(int(u_rt.numel()), int(real.sum()), D, rows_moved=3)
    return {"K3": {
        "max_abs_err": max(errs), "bound": b,
        **timings(lambda: fk.fused_update_sgd(W1, u_rt, g_rt, lr),
                  ROW_KERNEL, b["ms"],
                  lambda: fk.fused_update_sgd_reference(W2, u_rt, g_rt, lr),
                  lambda: W2.index_add_(0, ids_real, g_real, alpha=-lr)),
    }}


def check_update_kernels(dmp, fk) -> dict:
    """K2-K5 and K4's scaled RMW against their plain versions on the
    trained table."""
    from torchrec_tpu_torch.ops import fused_update as fu

    strat = dmp.sharded_ebcs[TRAIN_KEY].strategies[0]
    W, M = strat.weights[0], strat.momentum1[0]
    R, D = W.shape
    lr = FUSED_LR
    flat, valid, row_grads = batch_grads(strat)
    u_rt, g_rt = fu.run_total_row_grads(flat, row_grads, valid, R)
    u_dd, g_dd = fu.dedup_row_grads(flat, row_grads, valid, R)
    N = int(flat.numel())
    n_real = int((u_rt < R).sum())
    log(f"update kernels: N={N} slots, {n_real} distinct rows, "
        f"{int((u_rt == fu.RUN_SENTINEL).sum())} run sentinels, "
        f"{int((u_dd >= R).sum())} dedup sentinels; W {tuple(W.shape)}")
    out = check_sgd(fk, W, u_rt, g_rt, lr)
    out.update(check_k2(fk, W, u_rt, g_rt, lr))
    out.update(check_rowwise(fk, W, M, u_dd, g_dd, lr))
    return report(out)


def check_k2(fk, W, u_rt, g_rt, lr) -> dict:
    """K2 on clones of a table, writing the rows of the write form of the
    SGD update at one batch's run totals: bit-exact with its plain version,
    then timed beside index_copy_ on the real slots."""
    R, D = W.shape
    real = u_rt < R
    rows = W[u_rt.clamp(max=R - 1).long()] - lr * g_rt
    W1, W2 = W.clone(), W.clone()
    fk.scatter_rows_write(W1, u_rt, rows)
    fk.scatter_rows_write_reference(W2, u_rt, rows)
    ids_real, rows_real = u_rt[real].long(), rows[real]
    b = rows_bound(int(u_rt.numel()), int(real.sum()), D, rows_moved=2,
                   flops_per_elem=0)
    return {"K2": {
        "max_abs_err": _hold("K2", [(W1, W2)]), "bound": b,
        **timings(lambda: fk.scatter_rows_write(W1, u_rt, rows),
                  ROW_KERNEL, b["ms"],
                  lambda: fk.scatter_rows_write_reference(W2, u_rt, rows),
                  lambda: W2.index_copy_(0, ids_real, rows_real)),
    }}


def k5_bound(N: int, n_uniq: int) -> dict:
    """K5's least time: the ids, the real slots' g_sq and the N inverse
    scales are contiguous; each distinct row's momentum word is read and
    written once, at a random place (payload; `sectors` counts a 32-byte
    sector per scattered access)."""
    payload = N * 4 + n_uniq * 4 + N * 4 + 2 * n_uniq * 4
    t_bytes, t_ops = payload / HBM_BYTES_PER_S, 4 * n_uniq / FP32_FLOPS
    return {"bytes": payload, "ms": max(t_bytes, t_ops) * 1e3,
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "sectors": N * 4 + n_uniq * 4 + N * 4 + 2 * n_uniq * 32}


def check_rowwise(fk, W, M, u_dd, g_dd, lr, what: str = "DLRM") -> dict:
    """The rowwise-Adagrad kernels on a trained table and momentum and one
    batch's dedup output: the fused K4 against its plain version at weight
    decay 0 and 0.01, K5 and the scaled RMW against theirs, all bit-exact;
    then the fused K4 timed in turns with the unfused composition it
    replaced (the route's torch ops over K5 and the scaled RMW), and K5
    timed alone."""
    R, D = W.shape
    N = int(u_dd.numel())
    real = u_dd < R
    n_uniq = int(real.sum())
    log(f"rowwise {what}: N={N} slots, {n_uniq} distinct rows, "
        f"{N - n_uniq} dedup sentinels; W {tuple(W.shape)}")
    errs = []
    for wd in (0.0, 0.01):
        W1, W2, M1, M2 = W.clone(), W.clone(), M.clone(), M.clone()
        fk.fused_update_rowwise_adagrad(W1, M1, u_dd, g_dd, lr,
                                        weight_decay=wd, momentum_stream=True)
        fk.fused_update_rowwise_adagrad_reference(
            W2, M2, u_dd, g_dd, lr, weight_decay=wd, momentum_stream=True)
        errs.append(_hold(f"K4 at weight decay {wd}", [(W1, W2), (M1, M2)]))
    # K5 on the route's g_sq, the scaled RMW on K5's scale
    g_sq = fk.row_mean_sq(g_dd) * real.to(torch.float32)
    M3, M4 = M.clone(), M.clone()
    _, inv1, ovf = fk.rowwise_momentum_stream(M3, u_dd, g_sq)
    _, inv2, _ = fk.rowwise_momentum_stream_reference(M4, u_dd, g_sq)
    if bool(ovf):
        raise AssertionError("K5 reported an overflow")
    err5 = _hold("K5", [(M3, M4), (inv1, inv2)])
    scale = lr * inv2
    W3, W4 = W.clone(), W.clone()
    fk.scaled_row_update(W3, u_dd, g_dd, scale)
    fk.scaled_row_update_reference(W4, u_dd, g_dd, scale)
    errs.append(_hold("K4's scaled RMW", [(W3, W4)]))

    # read g and W, write W (three rows), read and write the momentum word
    b4 = rows_bound(N, n_uniq, D, rows_moved=3, extra_bytes=2 * n_uniq * 4,
                    flops_per_elem=7)

    def fused():
        fk.fused_update_rowwise_adagrad(W1, M1, u_dd, g_dd, lr,
                                        momentum_stream=True)

    def unfused():
        fk.rowwise_adagrad_unfused(W3, M3, u_dd, g_dd, lr)

    k4 = {"max_abs_err": max(errs), "bound": b4,
          **timings(fused, ROWWISE_KERNELS, b4["ms"],
                    lambda: fk.fused_update_rowwise_adagrad_reference(
                        W2, M2, u_dd, g_dd, lr, momentum_stream=True))}
    # in turns: fused (above), unfused, unfused, fused
    unfused_ms = [device_ms(unfused, bound_ms=b4["ms"]) for _ in range(2)]
    fused_ms = [k4["ms"], device_ms(fused, ROWWISE_KERNELS,
                                    b4["ms"])]
    k4["ms"] = sum(fused_ms) / 2
    k4["unfused_ms"] = sum(unfused_ms) / 2
    log(f"rowwise {what}: fused K4 {fused_ms[0]:.5f} / {fused_ms[1]:.5f} "
        f"ms, unfused composition {unfused_ms[0]:.5f} / {unfused_ms[1]:.5f} "
        f"ms (device time, in turns: fused, unfused, unfused, fused)")
    b5 = k5_bound(N, n_uniq)
    k5 = {"max_abs_err": err5, "bound": b5,
          **timings(lambda: fk.rowwise_momentum_stream(M3, u_dd, g_sq),
                    "rowwise_momentum_kernel", b5["ms"],
                    lambda: fk.rowwise_momentum_stream_reference(
                        M4, u_dd, g_sq))}
    log(f"K5 {what} bound: {b5['bytes']} B of payload ({b5['ms']:.5f} ms, "
        f"used for the share); {b5['sectors']} B counting a 32-byte sector "
        f"per scattered momentum read and write "
        f"({1e3 * b5['sectors'] / HBM_BYTES_PER_S:.5f} ms)")
    return {"K4": k4, "K5": k5}


def report(out: dict, what: str = "") -> dict:
    """Log each checked kernel's numbers; the JSON line's fields."""
    for k, r in out.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        unfused = ("" if "unfused_ms" not in r
                   else f"; unfused composition {r['unfused_ms']:.5f} ms")
        label = f"{k} {KERNELS[k][0]}" if k in KERNELS else k
        log(f"{label}{what}: bit-exact with its plain version; "
            f"{r['ms']:.5f} ms on the device (call {r['call_ms']:.4f} ms); "
            f"plain {r['plain_ms']:.4f} ms; library "
            f"{lib}{unfused}; bound {r['bound']['ms']:.5f} ms "
            f"({r['bound']['by']}: {r['bound']['bytes']} B); kernel at "
            f"{100 * r['bound']['ms'] / r['ms']:.1f}% of the bound")
    return {k: {"max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                "bound_ms": r["bound"]["ms"], "bound_by": r["bound"]["by"]}
            for k, r in out.items()}


def check_moment_kernels(dmp, fk) -> dict:
    """K6 (ADAGRAD) or K7 (ADAM) against its plain version on the trained
    table and momenta, at the next step, with and without weight decay.
    No single PyTorch call applies Adagrad or Adam to scattered rows, so
    there is no library yardstick."""
    from torchrec_tpu_torch.ops import fused_update as fu

    strat = dmp.sharded_ebcs[TRAIN_KEY].strategies[0]
    adam = strat.optim is fu.EmbOptimType.ADAM
    state = [strat.weights[0], strat.momentum1[0]] + (
        [strat.momentum2[0]] if adam else [])
    flat, valid, row_grads = batch_grads(strat)
    u_rt, g_rt = fu.run_total_row_grads(flat, row_grads, valid,
                                        state[0].shape[0])
    del flat, valid, row_grads
    return report(hold_moments(fk, "K7" if adam else "K6", state, u_rt,
                               g_rt, FUSED_LR, strat.step + 1))


def hold_moments(fk, k: str, state, u_rt, g_rt, lr: float, step,
                 what: str = "") -> dict:
    """K6 (state [W, m]) or K7 ([W, m1, m2]) against its plain version on
    clones of the state with these run totals at this step, bit-exact at
    weight decay 0 and 0.01, then timed; `report`'s input."""
    adam = k == "K7"
    R, D = state[0].shape
    N, n_real = int(u_rt.numel()), int((u_rt < R).sum())
    log(f"{k}{what}: N={N} slots, {n_real} distinct rows, step {int(step)}; "
        f"{len(state)} tensors of {tuple(state[0].shape)}")

    def kernel(ts, wd=0.0):
        if adam:
            return fk.fused_update_adam(*ts, u_rt, g_rt, lr, step,
                                        weight_decay=wd)
        return fk.fused_update_adagrad(*ts, u_rt, g_rt, lr, weight_decay=wd)

    def plain(ts, wd=0.0):
        if adam:
            return fk.fused_update_adam_reference(*ts, u_rt, g_rt, lr, step,
                                                  weight_decay=wd)
        return fk.fused_update_adagrad_reference(*ts, u_rt, g_rt, lr,
                                                 weight_decay=wd)

    errs = []
    for wd in (0.0, 0.01):
        a, b = [t.clone() for t in state], [t.clone() for t in state]
        kernel(a, wd)
        plain(b, wd)
        errs.append(_hold(KERNELS[k][0], list(zip(a, b))))
    # read W, the momenta and g, write W and the momenta: 5 or 7 rows
    bound_ = rows_bound(N, n_real, D, rows_moved=2 * len(state) + 1,
                        flops_per_elem=14 if adam else 7)
    return {k: {"max_abs_err": max(errs), "bound": bound_,
                **timings(lambda: kernel(a), MOMENT_KERNELS,
                          bound_["ms"],
                          lambda: plain(b))}}

# -- BERT4Rec ----------------------------------------------------------------


def make_b4r_dmp(device: str, env=None, sharding: str = "ROW_WISE"):
    """The example's BERT4Rec through the DMP: the item table in a sharded
    EmbeddingCollection (ROW_WISE, or `sharding`, TABLE_WISE on rank 0),
    ROWWISE_ADAGRAD at lr 0.01, dense Adam at 1e-3, dropout 0.0, on `env`
    (default: one device, no process group)."""
    from torchrec_tpu_torch.models import (
        BERT4Rec,
        BERT4RecTrain,
        make_item_embedding_collection,
    )
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )

    model = BERT4RecTrain(BERT4Rec(
        B4R_VOCAB, B4R_LEN, B4R_DIM, B4R_HEADS, B4R_LAYERS, dropout=0.0,
        ec=make_item_embedding_collection(B4R_VOCAB, B4R_DIM, B4R_LEN,
                                          device="meta"),
        device="meta"))
    return DistributedModelParallel(
        model, env=env, plan=ShardingPlan({B4R_KEY: {
            "item_embedding": ParameterSharding(
                ShardingType[sharding],
                ranks=[0] if sharding == "TABLE_WISE" else None)}}),
        fused_params={"learning_rate": B4R_EMB_LR},
        dense_optimizer=lambda p: torch.optim.Adam(p, lr=B4R_DENSE_LR),
        device=device)


def b4r_sequences(rng: np.random.RandomState) -> list:
    """Item histories shaped as the example's ML-1M stand-in: lengths from
    its log-normal (min 20, mean about 165), Zipf-popular items 1..3706."""
    seqs = []
    for _ in range(B4R_USERS):
        n = int(np.clip(rng.lognormal(4.56, 0.95), 20, 1000))
        seqs.append((rng.zipf(1.05, size=n) - 1) % B4R_ITEMS + 1)
    return seqs


def _pad(seq) -> np.ndarray:
    s = np.asarray(seq[-B4R_LEN:], np.int32)
    return np.concatenate([np.zeros(B4R_LEN - len(s), np.int32), s])


def _b4r_kjt(ids: np.ndarray):
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    return KeyedJaggedTensor.from_lengths(
        ["item"], ids.reshape(-1), np.full(len(ids), B4R_LEN, np.int32))


def b4r_train_batch(rng, seqs, batch: int):
    """make_train_batch: a user's history but its last item, each real
    item masked with probability 0.2 (at least the last one). Returns
    (KeyedJaggedTensor, labels [B, L] int32) on the CPU."""
    rows, labels = [], []
    for _ in range(batch):
        s = _pad(seqs[rng.randint(len(seqs))][:-1])
        m = (rng.rand(B4R_LEN) < B4R_MASK_PROB) & (s > 0)
        if not m.any():
            m[np.where(s > 0)[0][-1]] = True
        labels.append(np.where(m, s, 0).astype(np.int32))
        rows.append(np.where(m, B4R_MASK, s).astype(np.int32))
    return _b4r_kjt(np.stack(rows)), torch.from_numpy(np.stack(labels))


def b4r_eval_batch(rng, seqs, batch: int):
    """make_eval_batch: the whole history with its last item masked, and
    zero labels, as the example serves it."""
    rows = []
    for i in rng.randint(len(seqs), size=batch):
        s = _pad(seqs[i])
        s[np.where(s > 0)[0][-1]] = B4R_MASK
        rows.append(s)
    return (_b4r_kjt(np.stack(rows)),
            torch.zeros((batch, B4R_LEN), dtype=torch.int32))


def b4r_serve(seqs) -> dict:
    """Requests through make_eval_fn at B=32 and B=1024, the routed
    gather once each."""
    dmp = make_b4r_dmp(DEVICE).init(SEED)
    eval_fn = dmp.make_eval_fn()
    rng = np.random.RandomState(SEED + 10)
    requests = [b4r_eval_batch(rng, seqs, b)
                for b in [B4R_BATCH] * REQUESTS_PER_BATCH
                + [B4R_RANK_BATCH] * REQUESTS_PER_BATCH]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    latencies = {B4R_BATCH: [], B4R_RANK_BATCH: []}
    last = None
    for kjt, labels in requests:
        batch = labels.shape[0]
        before = counts()
        t0 = time.perf_counter()
        _, (_, logits) = eval_fn(kjt.to(DEVICE), labels.to(DEVICE))
        torch.cuda.synchronize()
        latencies[batch].append((time.perf_counter() - t0) * 1e3)
        after = counts()
        launched = {k: after[k] - before[k] for k in after}
        if launched != expected(K8r=1):
            raise AssertionError(f"a B={batch} BERT4Rec request launched "
                                 f"{launched}")
        if (logits.shape != (batch, B4R_LEN, B4R_VOCAB)
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError(f"bad BERT4Rec logits at B={batch}: "
                                 f"{tuple(logits.shape)}")
        if batch == B4R_BATCH:
            last = (kjt, labels, logits.cpu())
    launches = counts()["K8r"]
    peak = torch.cuda.max_memory_allocated()
    for batch, ms in latencies.items():
        log(f"bert4rec serve B={batch}: request ms (host clock, H2D + "
            f"forward, synchronized; first includes warm-up) {ms}")
    log(f"bert4rec serve: {len(requests)} requests, routed gather launches "
        f"{launches}, "
        f"max_memory_allocated {peak} B")
    fwd = {}
    for batch in (B4R_BATCH, B4R_RANK_BATCH):
        kjt, labels = b4r_eval_batch(rng, seqs, batch)
        kjt, labels = kjt.to(DEVICE), labels.to(DEVICE)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eval_fn(kjt, labels)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        fwd[batch] = times
        log(f"bert4rec serve B={batch}: forward ms (host clock, "
            f"synchronized) {times}")

    kjt, labels, logits = last
    cpu = make_b4r_dmp("cpu")
    cpu.load_state_dict(dmp.state_dict())
    _, (_, ref) = cpu.make_eval_fn()(kjt, labels)
    torch.testing.assert_close(logits, ref, rtol=1e-4, atol=1e-5)
    log(f"bert4rec serve B={B4R_BATCH}: card logits match the CPU run, max "
        f"abs diff {(logits - ref).abs().max().item():.3e}")
    return {"launches": launches, "request_ms": latencies,
            "forward_ms": fwd, "peak_bytes": peak}


def _b4r_dense(dmp) -> dict:
    """{name: (value, gradient)} of the dense parameters, on the CPU."""
    return {name: (p.detach().cpu(), p.grad.detach().cpu())
            for name, p in dmp.module.named_parameters()}


def hold_b4r_dense(got: dict, ref: dict, steps: int, what: str) -> None:
    """Two BERT4Rec runs' dense parameters after `steps` equal Adam steps
    (`_b4r_dense` of each) within rtol 1e-4 / atol 1e-5, but a parameter
    whose gradient is zero up to rounding on both sides (the attention key
    bias: softmax ignores a constant added to a query's logits), which
    Adam moves by steps of order lr whichever way the noise points, each
    run within Adam's reach: about (1 - b1) / sqrt(1 - b2) * lr = 3.2 * lr
    per step."""
    adam_reach = 3.2 * B4R_DENSE_LR * steps
    for name, (a, ga) in got.items():
        b, gb = ref[name]
        if max(ga.abs().max().item(), gb.abs().max().item()) < 1e-6:
            diff = (a - b).abs().max().item()
            if diff > 2 * adam_reach:
                raise AssertionError(f"{name}: {what} differ by {diff}")
            log(f"bert4rec train: {name} has a zero gradient up to "
                f"rounding; {what} differ by {diff:.3e}, within Adam's "
                f"reach {2 * adam_reach:.3e}")
            continue
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _b4r_state(dmp) -> dict:
    strat = dmp.sharded_ebcs[B4R_KEY].strategies[0]
    return {"table": strat.weights[0].detach().cpu(),
            "momentum1": strat.momentum1[0].detach().cpu()}


def b4r_train(seqs) -> dict:
    """WARMUP_STEPS + TIMED_STEPS train steps at B=32, each launching the
    routed gather, its route-only mode and the fused K4 once; then the
    card DMP and a CPU copy (dense Adam state included) take CPU_STEPS more
    steps and must agree."""
    dmp = make_b4r_dmp(DEVICE).init(SEED)
    step = dmp.make_train_step()
    rng = np.random.RandomState(SEED + 11)
    batches = [b4r_train_batch(rng, seqs, B4R_BATCH)
               for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    batches = [(kjt.to(DEVICE), labels.to(DEVICE))
               for kjt, labels in batches]
    per_step = expected(K8r=1, K4=1, **{ROUTE: 1})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, losses = [], []
    for kjt, labels in batches:
        before = counts()
        t0 = time.perf_counter()
        loss, _ = step(kjt, labels)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        after = counts()
        launched = {k: after[k] - before[k] for k in after}
        if launched != per_step:
            raise AssertionError(f"BERT4Rec step {len(ms)} launched "
                                 f"{launched}, expected {per_step}")
        losses.append(loss.item())
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"BERT4Rec step {len(ms)}: loss "
                                 f"{losses[-1]}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    timed = ms[WARMUP_STEPS:]
    median = sorted(timed)[TIMED_STEPS // 2]
    seq_per_s = TIMED_STEPS * B4R_BATCH / (sum(timed) / 1e3)
    log(f"bert4rec train B={B4R_BATCH}: losses {losses}")
    log(f"bert4rec train: warm-up step ms {ms[:WARMUP_STEPS]}; timed step "
        f"ms (host clock, synchronized) {timed}; min {min(timed):.4f} max "
        f"{max(timed):.4f} median {median:.4f}; {seq_per_s:.1f} sequences/s "
        f"over the {TIMED_STEPS} timed steps")
    log(f"bert4rec train: launches per step {per_step}, in all {launches}; "
        f"max_memory_allocated {peak} B")

    # the card against the CPU, from the trained state: nonzero Adam
    # moments, so a step is not lr * sign(g) per element
    cpu = make_b4r_dmp("cpu")
    cpu.load_state_dict(dmp.state_dict())
    # a copy: load_state_dict keeps tensors already on the target device
    cpu.dense_optimizer.load_state_dict(
        copy.deepcopy(dmp.dense_optimizer.state_dict()))
    start = _b4r_state(cpu)
    step_c = cpu.make_train_step()
    extra = [b4r_train_batch(rng, seqs, B4R_BATCH) for _ in range(CPU_STEPS)]
    touched = torch.zeros(start["table"].shape[0], dtype=torch.bool)
    for i, (kjt, labels) in enumerate(extra):
        touched[kjt.values.long()] = True
        loss_g, _ = step(kjt.to(DEVICE), labels.to(DEVICE))
        loss_c, _ = step_c(kjt, labels)
        torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-4,
                                   atol=1e-5)
        log(f"bert4rec train B={B4R_BATCH} card-against-CPU step {i}: card "
            f"loss {loss_g.item():.9g}, CPU loss {loss_c.item():.9g}")
    hold_b4r_dense(_b4r_dense(dmp), _b4r_dense(cpu), CPU_STEPS,
                   "card and CPU")
    sg, sc = _b4r_state(dmp), _b4r_state(cpu)
    for what in ("table", "momentum1"):
        a, b = sg[what], sc[what]
        torch.testing.assert_close(a[touched], b[touched], rtol=1e-4,
                                   atol=1e-5)
        if not (torch.equal(a[~touched], start[what][~touched])
                and torch.equal(b[~touched], start[what][~touched])):
            raise AssertionError(f"BERT4Rec: untouched {what} rows changed")
        log(f"bert4rec train: {int(touched.sum())} touched {what} rows "
            f"within rtol 1e-4 / atol 1e-5 of the CPU run (max abs diff "
            f"{(a[touched] - b[touched]).abs().max().item():.3e}), the "
            f"others unchanged on both")
    log("bert4rec train: the other dense parameters match the CPU run")
    return {"dmp": dmp, "launches": launches, "ms": timed,
            "median_ms": median, "seq_per_s": seq_per_s, "peak_bytes": peak,
            "batch": batches[0][0], "batch_ids": batches[0][0].values}


def check_b4r_rowwise(fk, trained, batch_ids) -> None:
    """The rowwise kernels at BERT4Rec's shape: the trained [3712, 64]
    shard and momentum, and one batch's 2,048 tokens (every one is
    updated, pads included, as the path updates them) with cotangents
    drawn at 1e-3, deduplicated as the update deduplicates them."""
    from torchrec_tpu_torch.ops import fused_update as fu

    strat = trained.sharded_ebcs[B4R_KEY].strategies[0]
    W, M = strat.weights[0], strat.momentum1[0]
    R, D = W.shape
    ids = batch_ids.to(DEVICE, torch.int32).contiguous()
    rng = np.random.RandomState(SEED + 17)
    grads = torch.from_numpy(
        (rng.randn(ids.numel(), D) * 1e-3).astype(np.float32)).to(DEVICE)
    u_dd, g_dd = fu.dedup_row_grads(
        ids, grads, torch.ones_like(ids, dtype=torch.bool), R)
    report(check_rowwise(fk, W, M, u_dd, g_dd, B4R_EMB_LR, "BERT4Rec"),
           " at BERT4Rec's shape")


def gather_bound(N: int, distinct: int, D: int) -> dict:
    """Least time for K8: the N ids and each distinct row read once, the
    N output rows written once, over the HBM rate (no arithmetic)."""
    nbytes = N * 4 + distinct * D * 4 + N * D * 4
    return {"bytes": nbytes, "ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "by": "bytes"}


def check_gather(W: torch.Tensor, ids: torch.Tensor, what: str) -> dict:
    """K8 against its plain version (bit-exact) and torch.index_select,
    timed beside both."""
    from torchrec_tpu_torch.ops import gather_rows as gr

    R, D = W.shape
    N = int(ids.numel())
    out = gr.gather_rows(W, ids)
    ref = gr.gather_rows_reference(W, ids)
    safe = ids.clamp(0, R - 1).long()  # index_select takes no id outside
    lib = torch.index_select(W, 0, safe)
    err = _hold("K8", [(out, ref), (out, lib)])
    distinct = int(torch.unique(safe).numel())
    b = gather_bound(N, distinct, D)
    per_id = (N * 4 + 2 * N * D * 4) / HBM_BYTES_PER_S * 1e3
    t = timings(lambda: gr.gather_rows(W, ids), K8_KERNELS,
                b["ms"], lambda: gr.gather_rows_reference(W, ids),
                lambda: torch.index_select(W, 0, safe))
    log(f"K8 {what}: W {tuple(W.shape)}, {N} ids ({distinct} distinct "
        f"rows, {int(((ids < 0) | (ids >= R)).sum())} out of range): "
        f"bit-exact with its plain version and index_select; "
        f"{t['ms']:.4f} ms on the device (call {t['call_ms']:.4f} ms); "
        f"plain {t['plain_ms']:.4f} ms; index_select "
        f"{t['library_ms']:.4f} ms; bound {b['ms']:.5f} ms (bytes: "
        f"{b['bytes']} B; {per_id:.5f} ms reading one row per id); kernel "
        f"at {100 * b['ms'] / t['ms']:.1f}% of the bound")
    return {"max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"], "bound_ms": b["ms"],
            "bound_by": b["by"], "call_ms": t["call_ms"]}


def check_gather_kernel(trained, batch_ids) -> dict:
    """The plain K8 at the unsharded EC's shape (one batch's 2,048 ids of
    the trained [3712, 64] shard), at K1's backward's (40,960 ids of a
    100,000 x 128 table, as check_backward drives it) and at a bytes-bound
    one (W 2,600,064 x 128, 212,992 ids including negative and
    out-of-range ones)."""
    strat = trained.sharded_ebcs[B4R_KEY].strategies[0]
    ec = check_gather(strat.weights[0],
                      batch_ids.to(DEVICE, torch.int32).contiguous(),
                      "unsharded EC shape")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    rng = np.random.RandomState(SEED + 13)
    W = torch.rand((ROWS, DIM), device=DEVICE, generator=gen)
    ids = torch.from_numpy(rng.randint(0, ROWS, size=K1_BWD_IDS).astype(
        np.int32)).to(DEVICE)
    k1_bwd = check_gather(W, ids, "K1 backward shape")
    W = torch.rand((K8_ROWS, K8_DIM), device=DEVICE, generator=gen)
    ids = torch.from_numpy(rng.randint(
        -1000, K8_ROWS + 1000, size=K8_IDS).astype(np.int32)).to(DEVICE)
    big = check_gather(W, ids, "bytes-bound")
    del W
    return {"ec": ec, "k1_bwd": k1_bwd, "big": big}


def host_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Host time per call: the host clock around `iters` calls that are
    not waited for (the card runs behind), after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def routed_bound(ids: torch.Tensor, lengths: torch.Tensor,
                 local: torch.Tensor, owned: torch.Tensor, D: int) -> dict:
    """Least time for the routed gather: the ids, lengths and the two
    per-feature vectors read once, each distinct owned row read once and
    every output row written once, over the HBM rate (no arithmetic on the
    values)."""
    N, F = ids.numel(), ids.shape[0]
    distinct = int(torch.unique(local[owned]).numel())
    nbytes = N * 4 + lengths.numel() * 4 + 2 * F * 4 + distinct * D * 4 \
        + N * D * 4
    return {"bytes": nbytes, "rows": distinct,
            "ms": nbytes / HBM_BYTES_PER_S * 1e3, "by": "bytes"}


def check_routed_gather(trained, seqs, train_kjt) -> dict:
    """The routed gather and its route-only mode on the trained [3712, 64]
    shard against their plain versions: rows by value (+0.0 under a
    masked token on both), `local` and `owned` bit for bit. At the B=32
    path shape (one train batch, 2,048 tokens), at the B=1024 serving
    shape (65,536 tokens), on three features with their own shard rows
    and offsets and negative, out-of-range and padded ids, with a rank
    that owns none of the ids, and at D=63 (the scalar path). Then both
    path shapes timed: the kernel in turns with the composition it
    replaced (the route's torch ops, K8 through `lookup_rows`, the mask
    multiply), the plain version, and each wrapper's host time."""
    from torchrec_tpu_torch.ops import gather_rows as gr
    from torchrec_tpu_torch.ops.embedding import lookup_rows

    strat = trained.sharded_ebcs[B4R_KEY].strategies[0]
    W = strat.weights[0]
    R, D = W.shape
    rank = trained.env.rank
    sr, off = strat.feat_shard_rows, strat.feat_local_off
    rng = np.random.RandomState(SEED + 18)
    serve_kjt, _ = b4r_eval_batch(rng, seqs, B4R_RANK_BATCH)
    shapes = {}
    for what, kjt in (("B=32 path", train_kjt),
                      ("B=1024 serving", serve_kjt.to(DEVICE))):
        sb = kjt.to_padded(B4R_LEN)
        shapes[what] = (sb.ids, sb.lengths)
    # three features: negative ids, ids >= n x shard rows, random lengths
    F3 = 3
    adv = (torch.from_numpy(rng.randint(-5000, 2 * R, size=(
               F3, B4R_BATCH, B4R_LEN)).astype(np.int32)).to(DEVICE),
           torch.from_numpy(rng.randint(0, B4R_LEN + 1, size=(
               F3, B4R_BATCH)).astype(np.int32)).to(DEVICE))
    sr3 = torch.tensor([B4R_VOCAB, 1000, 500], dtype=torch.int32,
                       device=DEVICE)
    off3 = torch.tensor([0, 1200, 3000], dtype=torch.int32, device=DEVICE)

    cases = [(what, W, ids, lengths, sr, off, rank)
             for what, (ids, lengths) in shapes.items()]
    cases += [("adversarial", W, *adv, sr3, off3, rank),
              ("a rank owning none", W, *shapes["B=32 path"], sr, off,
               rank + 7),
              ("D=63", W[:, :63].contiguous(), *adv, sr3, off3, rank)]
    err = 0.0
    with torch.no_grad():
        for what, w, ids, lengths, s_, o_, r_ in cases:
            out = gr.routed_gather_rows(w, ids, lengths, s_, o_, r_)
            ref = gr.routed_gather_rows_reference(w, ids, lengths, s_, o_,
                                                  r_)
            local, owned = gr.route_tokens(ids, lengths, s_, o_, r_)
            ref_local, ref_owned = gr.route_tokens_reference(
                ids, lengths, s_, o_, r_)
            err = max(err, _hold(f"the routed gather ({what})",
                                 [(out, ref)]))
            if not (torch.equal(local, ref_local)
                    and torch.equal(owned, ref_owned)):
                raise AssertionError(f"the route-only mode ({what}) is not "
                                     f"bit-exact with the plain route")
            n_owned = int(owned.sum())
            if what == "a rank owning none" and (n_owned or out.any()):
                raise AssertionError("a rank owning no id got rows")
            log(f"routed gather {what}: ids {tuple(ids.shape)}, W "
                f"{tuple(w.shape)}, {n_owned} owned tokens, "
                f"{int((ids < 0).sum())} negative ids: equal to its plain "
                f"version, route-only mode bit-exact with the route")

        timed = {}
        for what, (ids, lengths) in shapes.items():
            local, owned = gr.route_tokens_reference(ids, lengths, sr, off,
                                                     rank)
            b = routed_bound(ids, lengths, local, owned, D)

            def kernel():
                return gr.routed_gather_rows(W, ids, lengths, sr, off, rank)

            def composition():
                loc, own = strat._route(ids, lengths, rank)
                rows = lookup_rows(W, loc.reshape(-1)).reshape(
                    *loc.shape, D)
                return rows * own.to(rows.dtype)[..., None]

            # in turns: kernel, composition, composition, kernel
            k_ms = [device_ms(kernel, ROUTED_KERNELS, b["ms"])]
            c_ms = [device_ms(composition, bound_ms=b["ms"])
                    for _ in range(2)]
            k_ms.append(device_ms(kernel, ROUTED_KERNELS, b["ms"]))
            t = {"ms": sum(k_ms) / 2, "composition_ms": sum(c_ms) / 2,
                 "plain_ms": device_ms(
                     lambda: gr.routed_gather_rows_reference(
                         W, ids, lengths, sr, off, rank), bound_ms=b["ms"]),
                 "route_ms": device_ms(
                     lambda: gr.route_tokens(ids, lengths, sr, off, rank),
                     ROUTED_KERNELS),
                 "route_plain_ms": device_ms(
                     lambda: strat._route(ids, lengths, rank)),
                 "host_ms": host_ms(kernel),
                 "route_host_ms": host_ms(
                     lambda: gr.route_tokens(ids, lengths, sr, off, rank)),
                 "k8_host_ms": host_ms(
                     lambda: lookup_rows(W, ids.reshape(-1))),
                 "composition_host_ms": host_ms(composition),
                 "route_plain_host_ms": host_ms(
                     lambda: strat._route(ids, lengths, rank)),
                 "bound": b}
            timed[what] = t
            log(f"routed gather {what}: {k_ms[0]:.5f} / {k_ms[1]:.5f} ms "
                f"on the device, the composition it replaced "
                f"{c_ms[0]:.5f} / {c_ms[1]:.5f} ms (in turns: kernel, "
                f"composition, composition, kernel); plain "
                f"{t['plain_ms']:.5f} ms; bound {b['ms']:.5f} ms (bytes: "
                f"{b['bytes']} B, {b['rows']} distinct owned rows); kernel "
                f"at {100 * b['ms'] / t['ms']:.1f}% of the bound. "
                f"Route-only mode {t['route_ms']:.5f} ms against the "
                f"route's torch ops {t['route_plain_ms']:.5f} ms. Host ms "
                f"per call: routed gather {t['host_ms']:.5f}, route-only "
                f"{t['route_host_ms']:.5f}, plain K8 through lookup_rows "
                f"{t['k8_host_ms']:.5f}, the composition "
                f"{t['composition_host_ms']:.5f}, the route's torch ops "
                f"{t['route_plain_host_ms']:.5f}")
    path = timed["B=32 path"]
    return {"max_abs_err": err, "ms": path["ms"],
            "plain_ms": path["plain_ms"], "library_ms": None,
            "bound_ms": path["bound"]["ms"], "bound_by": path["bound"]["by"],
            "composition_ms": path["composition_ms"],
            "host_ms": path["host_ms"], "timed": timed}


def check_backward() -> None:
    """Gradients through the unsharded EBC (weighted, L=20, SUM and MEAN,
    D=128) and EC on the card against the CPU: the EBC's d_W and d_coeff
    (the per-sample weights' gradient) within rtol 1e-5 / atol 1e-6
    (scatter-adds and dot products sum in another order), the EC's d_W
    bit for bit (its cotangents sum exactly). K1 launches once in the
    EBC's forward and K8 once in its backward; the EC launches K8 once in
    its forward and nothing in its backward. Returns the K8 launches of
    these paths."""
    from torchrec_tpu_torch.models import make_item_embedding_collection
    from torchrec_tpu_torch.modules import (
        EmbeddingBagCollection,
        EmbeddingBagConfig,
        PoolingType,
    )
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    rng = np.random.RandomState(SEED + 14)
    L20, B = 20, 2048
    k8 = 0
    for pooling in ("SUM", "MEAN"):
        lengths = rng.randint(0, L20 + 1, size=B).astype(np.int32)
        ids = rng.randint(0, ROWS, size=int(lengths.sum())).astype(np.int32)
        psw = rng.rand(ids.shape[0]).astype(np.float32)
        cot = torch.from_numpy(rng.randn(B, DIM).astype(np.float32))
        grads = {}
        for device in (DEVICE, "cpu"):
            ebc = EmbeddingBagCollection(
                [EmbeddingBagConfig(num_embeddings=ROWS, embedding_dim=DIM,
                                    name="t", feature_names=["f"],
                                    pooling=PoolingType[pooling])],
                is_weighted=True, max_feature_length=L20, device=device)
            if device == DEVICE:
                ebc.reset_parameters(torch.Generator(device).manual_seed(
                    SEED + 15))
                weights = ebc.state_dict()
            else:
                ebc.load_state_dict(weights)
            w = torch.tensor(psw, device=device, requires_grad=True)
            kjt = KeyedJaggedTensor.from_lengths(["f"], ids, lengths,
                                                 w).to(device)
            reset_counts()
            out = ebc(kjt)
            fwd = counts()
            (out.values * cot.to(device)).sum().backward()
            bwd = counts()
            if device == DEVICE and (fwd != expected(K1=1)
                                     or bwd != expected(K1=1, K8=1)):
                raise AssertionError(f"EBC {pooling} gradient launched "
                                     f"{fwd} forward, {bwd} in all")
            if device == DEVICE:
                k8 += bwd["K8"]
            grads[device] = (ebc.embedding_bags["t"].grad.cpu(), w.grad.cpu())
        for what, a, b in zip(("d_W", "d_coeff"), grads[DEVICE],
                              grads["cpu"]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            log(f"backward EBC {pooling} L={L20}: card {what} within rtol "
                f"1e-5 / atol 1e-6 of the CPU (max abs diff "
                f"{(a - b).abs().max().item():.3e})")
    log("backward EBC: K1 once in each forward, K8 once in each backward")

    # B=32 histories at their own lengths (at most L), so the padding is
    # masked and no row sums hundreds of pad tokens' cotangents. A popular
    # item still sums about a hundred (115 for item 1), whose f32 sum
    # depends on the order of the card's atomic adds by more than 1e-5 of
    # its value; cotangents on a 1/64 grid sum exactly in any order, so the
    # card's d_W must equal the CPU's bit for bit
    seqs = b4r_sequences(np.random.RandomState(SEED + 16))
    hist = [np.asarray(seqs[i][-B4R_LEN:], np.int32)
            for i in rng.randint(len(seqs), size=B4R_BATCH)]
    kjt = KeyedJaggedTensor.from_lengths(
        ["item"], np.concatenate(hist), [len(h) for h in hist])
    cot = torch.from_numpy(np.round(
        rng.randn(B4R_BATCH, B4R_LEN, B4R_DIM) * 64).astype(np.float32) / 64)
    grads = {}
    for device in (DEVICE, "cpu"):
        ec = make_item_embedding_collection(B4R_VOCAB, B4R_DIM, B4R_LEN,
                                            device=device)
        if device == DEVICE:
            ec.reset_parameters(torch.Generator(device).manual_seed(SEED))
            weights = ec.state_dict()
        else:
            ec.load_state_dict(weights)
        reset_counts()
        out = ec(kjt.to(device))["item"]
        fwd = counts()
        (out * cot.to(device)).sum().backward()
        if device == DEVICE:
            if fwd != expected(K8=1) or counts() != fwd:
                raise AssertionError(f"EC gradient launched {fwd} forward, "
                                     f"{counts()} in all")
            k8 += fwd["K8"]
        grads[device] = ec.embeddings["item_embedding"].grad.cpu()
    if not torch.equal(grads[DEVICE], grads["cpu"]):
        raise AssertionError(
            f"backward EC: card d_W differs from the CPU's by up to "
            f"{(grads[DEVICE] - grads['cpu']).abs().max().item():.3e}")
    log("backward EC: K8 once in the forward, nothing in the backward; "
        "card d_W equal to the CPU's")
    return k8


# -- the position-weighted DLRM ----------------------------------------------


@contextlib.contextmanager
def capturing(module, name: str, seen: dict):
    """While open, `module.name` keeps the positional arguments of its last
    call in seen[name] and counts its calls in seen[name + "_calls"]; the
    callers look the name up in the module at each call."""
    orig = getattr(module, name)
    seen.setdefault(name + "_calls", 0)

    def wrapper(*args, **kwargs):
        seen[name] = args
        seen[name + "_calls"] += 1
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def card_cotangent(tl, sebc, seen: dict, replace: bool = False):
    """The pooled cotangent of a position-weighted train step goes two
    ways: through K1's VJP into the position weights and through `sebc`'s
    update into the table. While open, both keep the cotangent of their
    call in seen["vjp"] / seen["update"] (on the CPU) or, with `replace`,
    keep their own in seen["own_vjp"] / seen["own_update"] and run on the
    kept ones instead."""
    fn = tl.TbeLookupPooled
    orig = fn.backward

    def swap(what, d):
        if replace:
            seen["own_" + what] = d.detach().cpu()
            return seen[what].to(d.device)
        seen[what] = d.detach().cpu()
        return d

    def backward(ctx, d_out):
        return orig(ctx, swap("vjp", d_out))

    def update(features, d_values, *args, **kwargs):
        return type(sebc).update(sebc, features, swap("update", d_values),
                                 *args, **kwargs)

    fn.backward = staticmethod(backward)
    sebc.update = update
    try:
        yield
    finally:
        fn.backward = staticmethod(orig)
        del sebc.update


@contextlib.contextmanager
def card_relu_branches(gpu, cpu, seen: dict):
    """While open, each ReLU Perceptron of the card DMP `gpu` keeps, per
    call, which of its pre-activations were positive, and the same
    Perceptron of the CPU DMP `cpu` takes the card's branch wherever its
    own pre-activation lies within FWD_ATOL of zero (elsewhere its own),
    in value and gradient. The card's step must come first. The card and
    the CPU sum the GEMM in different orders, so a pre-activation within
    rounding of zero may pass on one side only, and then one sample's
    gradient differs by a finite amount; seen["flips"] counts the units
    whose branch the card's mask changed, seen["near"] those within
    FWD_ATOL of zero."""
    from torchrec_tpu_torch.modules.mlp import Perceptron

    seen.setdefault("flips", 0)
    seen.setdefault("near", 0)
    masks: dict = {}

    def card(name):
        def act(z):
            masks.setdefault(name, []).append((z > 0).cpu())
            return torch.relu(z)
        return act

    def host(name):
        def act(z):
            mine, near = z > 0, z.abs() <= FWD_ATOL
            pos = torch.where(near, masks[name].pop(0), mine)
            seen["flips"] += int((pos != mine).sum())
            seen["near"] += int(near.sum())
            return torch.where(pos, z, torch.zeros_like(z))
        return act

    patched = []
    for dmp, wrap in ((gpu, card), (cpu, host)):
        for name, m in dmp.module.named_modules():
            if isinstance(m, Perceptron) and m.activation is torch.relu:
                m.activation = wrap(name)
                patched.append(m)
    try:
        yield
    finally:
        for m in patched:
            m.activation = torch.relu


def profile_steps(step, batches, title: str) -> None:
    """One train step per batch under torch.profiler: the device time per
    kernel name, the busy share of the kernel span and each label's
    device span and host time, as the profilers print them."""
    from torch.profiler import ProfilerActivity, profile

    # profile_serving imports this file as `chip_smoke`; run as a script,
    # that is a second copy, of which only the summary is used
    from profile_serving import summarize

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log(f"{title}:")
    summarize(prof, len(batches), "step", wall_ms)
    sys.stdout.flush()


def make_pw_batch(rng: np.random.RandomState, batch: int):
    """(dense [B, 13], KeyedJaggedTensor of 26 features x B rows of 1..20
    ids uniform over each table's rows, labels [B]) on the CPU."""
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    lengths = rng.randint(1, PW_LEN + 1, size=NUM_TABLES * batch).astype(
        np.int32)
    ids = rng.randint(0, ROWS, size=int(lengths.sum())).astype(np.int32)
    dense = rng.randn(batch, DENSE_IN).astype(np.float32)
    labels = rng.randint(0, 2, size=batch).astype(np.float32)
    kjt = KeyedJaggedTensor.from_lengths(
        [f"f{i}" for i in range(NUM_TABLES)], ids, lengths)
    return torch.from_numpy(dense), kjt, torch.from_numpy(labels)


def _position_weights(dmp, grad: bool = False) -> torch.Tensor:
    """A DLRMTrain DMP's position weights (or their gradients, zeros where
    none), stacked [26, PW_LEN], on the CPU."""
    fp = dmp.module.dlrm.sparse_arch.embedding_bag_collection
    ps = list(fp.feature_processor.parameters())
    if grad:
        return torch.stack([torch.zeros_like(p).cpu() if p.grad is None
                            else p.grad.cpu() for p in ps])
    return torch.stack([p.detach().cpu() for p in ps])


def _check_pw_step(before: torch.Tensor, after: torch.Tensor,
                   g: torch.Tensor, what: str) -> float:
    """The dense SGD step moved every position weight by -lr * g to within
    one ulp of its value (a step under half an ulp leaves it in place),
    from a finite, nonzero gradient. Returns lr * max |g|."""
    if not (bool(torch.isfinite(g).all()) and g.abs().max().item() > 0):
        raise AssertionError(f"{what}: position weight gradient "
                             f"{g.abs().max().item()}")
    ulp = torch.nextafter(before, torch.full_like(before, math.inf)) - before
    if not bool((((after - before) + DENSE_LR * g).abs() <= ulp).all()):
        raise AssertionError(f"{what}: the position weights did not take "
                             f"the step -lr * g")
    return DENSE_LR * g.abs().max().item()


def pw_serve(tl) -> dict:
    """REQUESTS_PER_BATCH requests at B=8192 through make_eval_fn, K1 once
    each; K1 then held against its plain version on the last request's
    table, ids and coefficients (position weights x mask), and timed."""
    import torch.nn.functional as F

    dmp = make_dmp(DEVICE, position_weighted=True).init(SEED)
    eval_fn = dmp.make_eval_fn()
    rng = np.random.RandomState(SEED + 20)
    requests = [make_pw_batch(rng, BENCH_BATCH)[:2]
                for _ in range(REQUESTS_PER_BATCH)]
    seen: dict = {}
    torch.cuda.synchronize()
    reset_counts()
    ms = []
    with capturing(tl, "tbe_lookup_pooled_forward", seen):
        for dense, kjt in requests:
            before = counts()
            t0 = time.perf_counter()
            logits = eval_fn(dense.to(DEVICE), kjt.to(DEVICE)).cpu()
            ms.append((time.perf_counter() - t0) * 1e3)
            after = counts()
            launched = {k: after[k] - before[k] for k in after}
            if launched != expected(K1=1):
                raise AssertionError(f"a position-weighted request launched "
                                     f"{launched}")
            if (logits.shape != (BENCH_BATCH, 1)
                    or not bool(torch.isfinite(logits).all())):
                raise AssertionError("bad position-weighted logits")
    launches = counts()["K1"]
    log(f"pw serve B={BENCH_BATCH} L<={PW_LEN}: request ms (host clock, H2D "
        f"+ forward + D2H, first includes warm-up) {ms}; K1 launches "
        f"{launches}")

    W, ids, coeff = seen["tbe_lookup_pooled_forward"]
    out = tl.tbe_lookup_pooled_forward(W, ids, coeff)
    ref = tl.tbe_lookup_pooled_reference(W, ids, coeff)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    err = (out - ref).abs().max().item()
    del out, ref
    b = bound(W, ids, coeff)
    t = timings(lambda: tl.tbe_lookup_pooled(W, ids, coeff),
                K1_KERNELS, b["ms"],
                lambda: tl.tbe_lookup_pooled_reference(W, ids, coeff),
                lambda: F.embedding_bag(ids, W, mode="sum",
                                        per_sample_weights=coeff))
    log(f"K1 position-weighted path: W {tuple(W.shape)}, ids "
        f"{tuple(ids.shape)} ({int((coeff != 0).sum())} live slots): within "
        f"rtol=atol=1e-6 of the plain version (max abs err {err:.3e}); "
        f"{t['ms']:.4f} ms on the device (call {t['call_ms']:.4f} ms); "
        f"plain {t['plain_ms']:.4f} ms; F.embedding_bag "
        f"{t['library_ms']:.4f} ms; bound {b['ms']:.4f} ms ({b['by']}: "
        f"{b['bytes']} B with {b['rows']} distinct rows); kernel at "
        f"{100 * b['ms'] / t['ms']:.1f}% of the bound")
    return {"launches": launches, "k1": {
        "max_abs_err": err, "bound_ms": b["ms"],
        **{k: t[k] for k in ("ms", "plain_ms", "library_ms")}}}


def check_pw_against_cpu(tl, gpu, name: str) -> None:
    """The trained card DMP and a CPU copy of its weights and optimizer
    state: logits of one B=256 request, then CPU_STEPS steps at B=256.
    Losses, position weights, dense parameters and touched rows and
    momenta within rtol 1e-4 / atol 1e-5, untouched rows equal, the last
    step's position weight gradients within 1e-3 of the CPU's in norm.
    The CPU's sparse side (K1's VJP, the table's update) takes the card's
    pooled cotangent at each step, which must lie within COTANGENT_REL of
    the CPU's own in norm: the cotangent is not continuous in the inputs,
    since a ReLU pre-activation within rounding of zero (card and CPU sum
    in different orders) passes on one side only, and then one sample's
    cotangent differs by a finite amount, which the rowwise update's
    normalised step carries into its rows. The same jump reaches the
    dense gradients, so in the steps each CPU ReLU whose pre-activation
    lies within FWD_ATOL of zero takes the card's branch
    (card_relu_branches), and the units it changed are counted."""
    cpu = make_dmp("cpu", train=True, optim=gpu.fused_optim,
                   position_weighted=True)
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.RandomState(SEED + 21)
    batches = [make_pw_batch(rng, SERVE_BATCH) for _ in range(CPU_STEPS + 1)]
    _, (_, logits_g, _) = gpu.make_eval_fn()(*to_device(batches[0]))
    _, (_, logits_c, _) = cpu.make_eval_fn()(*batches[0])
    torch.testing.assert_close(logits_g.cpu(), logits_c, rtol=1e-4,
                               atol=1e-5)
    log(f"pw {name} B={SERVE_BATCH}: card logits match the CPU run, max abs "
        f"diff {(logits_g.cpu() - logits_c).abs().max().item():.3e}")
    step_g, step_c = gpu.make_train_step(), cpu.make_train_step()
    sebc_g, sebc_c = gpu.sharded_ebcs[TRAIN_KEY], cpu.sharded_ebcs[TRAIN_KEY]
    branches: dict = {}
    for i, batch in enumerate(batches[1:]):
        seen: dict = {}
        with card_relu_branches(gpu, cpu, branches):
            with card_cotangent(tl, sebc_g, seen):
                loss_g, _ = step_g(*to_device(batch))
            with card_cotangent(tl, sebc_c, seen, replace=True):
                loss_c, _ = step_c(*batch)
        torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-4,
                                   atol=1e-5)
        rels = {w: ((seen[w] - seen["own_" + w]).norm()
                    / seen["own_" + w].norm()).item()
                for w in ("vjp", "update")}
        if not max(rels.values()) <= COTANGENT_REL:
            raise AssertionError(f"pw {name} step {i}: the card's pooled "
                                 f"cotangents differ from the CPU's by "
                                 f"{rels} of their norm")
        log(f"pw {name} B={SERVE_BATCH} step {i}: card loss "
            f"{loss_g.item():.9g}, CPU loss {loss_c.item():.9g}; the card's "
            f"pooled cotangents within {rels['vjp']:.3e} (K1's VJP) and "
            f"{rels['update']:.3e} (the update) of the CPU's own in norm")
    log(f"pw {name}: the CPU took the card's ReLU branch at "
        f"{branches['flips']} of the {branches['near']} pre-activations "
        f"within {FWD_ATOL} of zero in its {CPU_STEPS} steps")
    pg = dict(gpu.module.named_parameters())
    for pname, p in cpu.module.named_parameters():
        torch.testing.assert_close(pg[pname].detach().cpu(), p.detach(),
                                   rtol=1e-4, atol=1e-5)
    pw_g = _position_weights(gpu)
    pw_c = _position_weights(cpu)
    g_g, g_c = _position_weights(gpu, grad=True), _position_weights(
        cpu, grad=True)
    rel = ((g_g - g_c).norm() / g_c.norm()).item()
    if not rel <= 1e-3:
        raise AssertionError(f"pw {name}: the last step's position weight "
                             f"gradients differ from the CPU's by {rel:.3e} "
                             f"of their norm")
    log(f"pw {name}: position weights and dense parameters match the CPU "
        f"run (position weights max abs diff "
        f"{(pw_g - pw_c).abs().max().item():.3e}; the last step's position "
        f"weight gradients within {rel:.3e} of the CPU's in norm, max "
        f"|g| {g_c.abs().max().item():.3e})")
    sg = gpu.sharded_ebcs[TRAIN_KEY].strategies[0]
    sc = cpu.sharded_ebcs[TRAIN_KEY].strategies[0]
    touched = _touched(sc, batches[1:])
    for what in ("weights", "momentum1"):
        if getattr(sc, what) is None:
            continue
        a, b = getattr(sg, what)[0].cpu(), getattr(sc, what)[0]
        torch.testing.assert_close(a[touched], b[touched], rtol=1e-4,
                                   atol=1e-5)
        if not torch.equal(a[~touched], b[~touched]):
            raise AssertionError(f"pw {name}: untouched {what} rows differ")
        log(f"pw {name}: {int(touched.sum())} touched {what} rows within "
            f"rtol 1e-4 / atol 1e-5 of the CPU run (max abs diff "
            f"{(a[touched] - b[touched]).abs().max().item():.3e}), the rest "
            f"equal")


def pw_train(tl, fk, optim) -> dict:
    """PW_WARMUP_STEPS + PW_TIMED_STEPS train steps at B=8192, each
    launching K1 (the forward, its coefficient differentiable in the
    position weights), K8 (the rows of d_coeff in K1's backward) and the
    update's kernel (K3 or the fused K4) once, and building no dense table
    gradient. The position weights must take each dense step (-lr * g, to
    within an ulp), move where a step reaches an ulp of 1.0 and stay
    finite. Then the update's kernel is held and timed on the trained
    table with the last step's ids and row gradients, PW_PROFILED_STEPS
    more steps are profiled, and the card is held against the CPU.
    Returns the launches, how far the weights moved, the update kernel's
    numbers and, after EXACT_SGD, K8 held and timed at the shape of
    d_coeff's gather."""
    name = optim.name
    update = KERNELS[STEP_KERNELS[name][0]][0]
    dmp = make_dmp(DEVICE, train=True, optim=optim,
                   position_weighted=True).init(SEED)
    step = dmp.make_train_step()
    rng = np.random.RandomState(SEED + 22)
    batches = [to_device(make_pw_batch(rng, BENCH_BATCH))
               for _ in range(PW_WARMUP_STEPS + PW_TIMED_STEPS)]
    per_step = expected(K1=1, K8=1, **{k: 1 for k in STEP_KERNELS[name]})
    pw0 = _position_weights(dmp)
    seen: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, losses = [], []
    steps = []
    with capturing(tl, "gather_rows_forward", seen), \
            capturing(tl, "scatter_add_rows", seen):
        for i, batch in enumerate(batches):
            pw_before = _position_weights(dmp)
            before = counts()
            # the update's inputs of the last step only: holding a step's
            # row gradients into the next would raise the peak
            last = i == len(batches) - 1
            t0 = time.perf_counter()
            with (capturing(fk, update, seen) if last
                  else contextlib.nullcontext()):
                loss, _ = step(*batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            after = counts()
            steps.append(_check_pw_step(
                pw_before, _position_weights(dmp),
                _position_weights(dmp, grad=True), f"pw {name} step "
                f"{len(ms)}"))
            launched = {k: after[k] - before[k] for k in after}
            if launched != per_step:
                raise AssertionError(f"pw {name} step {len(ms)} launched "
                                     f"{launched}, expected {per_step}")
            losses.append(loss.item())
            if not math.isfinite(losses[-1]):
                raise AssertionError(f"pw {name} step {len(ms)}: loss "
                                     f"{losses[-1]}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    sebc = dmp.sharded_ebcs[TRAIN_KEY]
    if seen["scatter_add_rows_calls"] or any(
            b.requires_grad or b.grad is not None for b in sebc.buffers()):
        raise AssertionError(f"pw {name}: a dense table gradient was built")
    pw1 = _position_weights(dmp)
    moved = (pw1 - pw0).abs().max().item()
    if not bool(torch.isfinite(pw1).all()):
        raise AssertionError(f"pw {name}: position weights not finite")
    # a step of an ulp of 1.0 or more (the weights start at ones) must show
    if max(steps) > torch.finfo(torch.float32).eps and not moved > 0:
        raise AssertionError(f"pw {name}: position weights moved {moved}")
    timed = ms[PW_WARMUP_STEPS:]
    log(f"pw train {name} B={BENCH_BATCH}: losses {losses}")
    log(f"pw train {name}: warm-up step ms {ms[:PW_WARMUP_STEPS]}; timed "
        f"step ms (host clock, synchronized) {timed}; launches per step "
        f"{per_step}, in all {launches}; no dense table gradient; each "
        f"step moved the position weights by -lr * g to within an ulp, "
        f"lr * max |g| per step {steps}; they moved by up to {moved:.3e} "
        f"from the start (fp32 keeps no step under half an ulp), all "
        f"finite; max_memory_allocated {peak} B")
    out = {"launches": launches, "ms": timed, "peak_bytes": peak,
           "moved": moved}
    if optim.name == "EXACT_SGD":
        W, ids = seen["gather_rows_forward"]
        out["k8"] = check_gather(W, ids, "d_coeff shape")
        held = check_sgd(fk, *seen.pop(update))
    else:
        held = check_rowwise(fk, *seen.pop(update), "position-weighted")
    out["update"] = report(held, " at the position-weighted shape")
    del held, seen
    profile_steps(step, batches[-PW_PROFILED_STEPS:],
                  f"pw train {name} B={BENCH_BATCH}, profiled")
    check_pw_against_cpu(tl, dmp, name)
    return out


# -- the bf16 DLRM ------------------------------------------------------------

# the update kernel of each optimizer's bf16 train step, beside K1h
HALF_STEP_KERNELS = {"EXACT_SGD": "K3h", "ROWWISE_ADAGRAD": "K4h"}
# the card-against-CPU runs of the bf16 DLRM: two with stochastic rounding,
# one whose rows round to nearest
HALF_CPU_OPTIMS = ("EXACT_SGD", "ROWWISE_ADAGRAD", "ADAM")
# test_low_precision.py's drift test at width: SR_STEPS K3h steps of
# lr * g = 1e-4 on a [SR_ROWS, 128] bf16 table of ones
SR_ROWS, SR_STEPS, SR_LR, SR_G = 4096, 300, 0.01, 0.01


def _bf16():
    from torchrec_tpu_torch.modules.embedding_configs import DataType

    return DataType.BF16


def bf16_serve(tl) -> dict:
    """bench.py's DLRM with bf16 tables (one 2,600,064 x 128 bf16 shard)
    served: REQUESTS_PER_BATCH requests at B=8192 and at B=256 through
    make_eval_fn, each launching K1h once and K1 never; the logits finite
    and one B=256 request's equal to a CPU copy's. Then K1h is held and
    timed on the served table (check_half_lookup)."""
    dmp = make_dmp(DEVICE, data_type=_bf16()).init(SEED)
    strat = dmp.sharded_ebcs[MODULE_KEY].strategies[0]
    if strat.weights.dtype != torch.bfloat16:
        raise AssertionError(f"the bf16 DLRM's table is {strat.weights.dtype}")
    eval_fn = dmp.make_eval_fn()
    rng = np.random.RandomState(SEED + 30)
    requests = [(b, *make_request(rng, b))
                for b in [BENCH_BATCH] * REQUESTS_PER_BATCH
                + [SERVE_BATCH] * REQUESTS_PER_BATCH]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    latencies = {BENCH_BATCH: [], SERVE_BATCH: []}
    last = None
    for batch, dense, kjt in requests:
        before = counts()
        t0 = time.perf_counter()
        logits = eval_fn(dense.to(DEVICE), kjt.to(DEVICE)).cpu()
        latencies[batch].append((time.perf_counter() - t0) * 1e3)
        after = counts()
        launched = {k: after[k] - before[k] for k in after}
        if launched != expected(K1h=1):
            raise AssertionError(f"a bf16 request launched {launched}")
        if logits.shape != (batch, 1) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad bf16 logits at B={batch}")
        last = (dense, kjt, logits)
    launches = counts()["K1h"]
    peak = torch.cuda.max_memory_allocated()
    for batch, ms in latencies.items():
        log(f"bf16 serve B={batch}: request ms (host clock, H2D + forward + "
            f"D2H, first includes warm-up) {ms}")
    log(f"bf16 serve: {len(requests)} requests, K1h launches {launches}, K1 "
        f"none; max_memory_allocated {peak} B")
    check_against_cpu(dmp, last, data_type=_bf16())
    k1h = check_half_lookup(tl, strat)
    return {"launches": launches, "request_ms": latencies,
            "peak_bytes": peak, "k1h": k1h}


def check_half_lookup(tl, strat) -> dict:
    """K1h against its plain version on the served bf16 table and on an
    fp16 copy of it: at the main path's shape (one id per bag), bit-exact,
    and at L=20 with MEAN / per-sample coefficients (rounded to the
    table's dtype, as pooled_lookup rounds them) and ids >= R within
    rtol 1e-6; timed beside F.embedding_bag (sum, per-sample weights) on
    the same table."""
    import torch.nn.functional as F

    ids, coeff, ids20, coeff20 = lookup_inputs(strat)
    out = {}
    for W in (strat.weights[0], strat.weights[0].half()):
        tag = "bf16" if W.dtype == torch.bfloat16 else "fp16"
        c1 = coeff.to(W.dtype).float()
        c20 = coeff20.to(W.dtype).float()
        got = tl.tbe_lookup_pooled(W, ids, c1)
        ref = tl.tbe_lookup_pooled_reference(W, ids, c1)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K1h ({tag}) at L=1 is not bit-exact with "
                                 f"its plain version")
        got20 = tl.tbe_lookup_pooled(W, ids20, c20)
        ref20 = tl.tbe_lookup_pooled_reference(W, ids20, c20)
        torch.testing.assert_close(got20, ref20, rtol=1e-6, atol=1e-6)
        err = (got20 - ref20).abs().max().item()
        del got, ref, got20, ref20
        b = bound(W, ids, c1)
        psw = c1.to(W.dtype)
        t = timings(lambda: tl.tbe_lookup_pooled(W, ids, c1),
                    K1_KERNELS, b["ms"],
                    lambda: tl.tbe_lookup_pooled_reference(W, ids, c1),
                    lambda: F.embedding_bag(ids, W, mode="sum",
                                            per_sample_weights=psw))
        log(f"K1h {tag} L=1: bit-exact; L=20 within rtol=atol=1e-6 (max abs "
            f"err {err:.3e}); {t['ms']:.5f} ms on the device (call "
            f"{t['call_ms']:.4f} ms); plain {t['plain_ms']:.4f} ms; "
            f"F.embedding_bag {t['library_ms']:.4f} ms; bound "
            f"{b['ms']:.5f} ms ({b['by']}: {b['bytes']} B with {b['rows']} "
            f"distinct rows); kernel at {100 * b['ms'] / t['ms']:.1f}% of "
            f"the bound")
        out[tag] = {"max_abs_err": err, "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
                    "bound_ms": b["ms"], "bound_by": b["by"]}
        del W
    return {**out["bf16"], "max_abs_err": max(r["max_abs_err"]
                                              for r in out.values()),
            "fp16": out["fp16"]}


def bf16_train(fk, optim) -> dict:
    """The bf16 DLRM trained as bench.py's headline_bf16 trains it (fused
    lr 0.1, stochastic rounding on, dense SGD at 0.05): WARMUP_STEPS +
    TIMED_STEPS steps at B=8192, each launching K1h once and K3h
    (EXACT_SGD) or K4h (ROWWISE_ADAGRAD) once and no fp32 kernel, losses
    finite. The last step's update inputs are captured, and the update
    kernel held and timed on them (check_half_update)."""
    name = optim.name
    k = HALF_STEP_KERNELS[name]
    update = KERNELS[k][0]
    dmp = make_dmp(DEVICE, train=True, optim=optim,
                   data_type=_bf16()).init(SEED)
    step = dmp.make_train_step()
    rng = np.random.RandomState(SEED + 31)
    batches = [to_device(make_batch(rng, BENCH_BATCH))
               for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    per_step = expected(K1h=1, **{k: 1})
    seen: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, losses = [], []
    for i, batch in enumerate(batches):
        before = counts()
        t0 = time.perf_counter()
        with (capturing(fk, update, seen) if i == len(batches) - 1
              else contextlib.nullcontext()):
            loss, _ = step(*batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        after = counts()
        launched = {c: after[c] - before[c] for c in after}
        if launched != per_step:
            raise AssertionError(f"bf16 {name} step {len(ms)} launched "
                                 f"{launched}, expected {per_step}")
        losses.append(loss.item())
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"bf16 {name} step {len(ms)}: loss "
                                 f"{losses[-1]}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    strat = dmp.sharded_ebcs[TRAIN_KEY].strategies[0]
    if strat.weights.dtype != torch.bfloat16 or any(
            p.dtype != torch.float32 for g in dmp.dense_optimizer.param_groups
            for p in g["params"]):
        raise AssertionError("the bf16 table changed dtype or reached the "
                             "dense optimizer")
    timed = ms[WARMUP_STEPS:]
    log(f"bf16 train {name} B={BENCH_BATCH}: losses {losses}")
    log(f"bf16 train {name}: warm-up step ms {ms[:WARMUP_STEPS]}; timed step "
        f"ms (host clock, synchronized) {timed}; min {min(timed):.4f} max "
        f"{max(timed):.4f} median {sorted(timed)[TIMED_STEPS // 2]:.4f}; "
        f"launches per step {per_step}, in all {launches}; "
        f"max_memory_allocated {peak} B")
    held = check_half_update(fk, k, seen.pop(update), "the bf16 DLRM")
    return {"launches": launches, "ms": timed, "peak_bytes": peak,
            "held": held}


def check_half_update(fk, k, args, what: str) -> dict:
    """K3h (args: weights, uids, g, lr, step) or K4h (weights, momentum,
    uids, g, lr, step) against its plain version, bit for bit, on clones
    of the table (and momentum) with these ids and gradients at this step,
    under both epilogues (stochastic rounding, its bits keyed from row 0
    and from row 3 R as rank 3 of a ROW_WISE group keys them, and to
    nearest), for the table and an fp16 copy of it; then each timed with
    stochastic rounding. K3h's epilogue to nearest at weight decay 0 is one
    PyTorch call, JAX's `weights.at[uids].add((-lr * g).astype(dtype))`:
    W.index_add_ of the real slots' (-lr * g) in the table's type (made
    outside the timing), held within one ulp of the kernel's result to
    nearest and timed as K3h's library yardstick, beside the kernel to
    nearest (`rne_ms`). No single PyTorch call applies K4h's update, so it
    has no library yardstick."""
    if k == "K3h":
        W, uids, g, lr, step = args
        moms = []

        def kernel(ts, sr, base=0):
            fk.fused_update_sgd_half(ts[0], uids, g, lr, step,
                                     stochastic_rounding=sr, row_base=base)

        def plain(ts, sr, base=0):
            fk.fused_update_sgd_half_reference(ts[0], uids, g, lr, step,
                                               stochastic_rounding=sr,
                                               row_base=base)
    else:
        W, M, uids, g, lr, step = args
        moms = [M]

        def kernel(ts, sr, base=0):
            fk.fused_update_rowwise_adagrad_half(ts[0], ts[1], uids, g, lr,
                                                 step, stochastic_rounding=sr,
                                                 row_base=base)

        def plain(ts, sr, base=0):
            fk.fused_update_rowwise_adagrad_half_reference(
                ts[0], ts[1], uids, g, lr, step, stochastic_rounding=sr,
                row_base=base)
    name = ROW_KERNEL if k == "K3h" else ROWWISE_KERNELS
    R, D = W.shape
    N, n_real = int(uids.numel()), int((uids < R).sum())
    # a 2-byte row read and written, a 4-byte g row read (and K4h's
    # momentum word read and written) per real slot
    b = rows_bound(N, n_real, D, rows_moved=2, row_bytes=2,
                   extra_bytes=n_real * D * 4 + len(moms) * 2 * n_real * 4,
                   flops_per_elem=7 if moms else 4)
    log(f"{k} {what}: N={N} slots, {n_real} distinct rows, step "
        f"{int(step)}, W {tuple(W.shape)} {W.dtype}")
    out = {}
    for dtype in (W.dtype, torch.float16):
        tag = "bf16" if dtype == torch.bfloat16 else "fp16"
        base = [W.to(dtype)] + moms
        errs = []
        # the bits of rank 3's block at 3 R rows across the group as well;
        # the last run, to nearest, stays in `a`
        for sr, row_base in ((True, 0), (True, 3 * R), (False, 0)):
            a = [t.clone() for t in base]
            p = [t.clone() for t in base]
            kernel(a, sr, row_base)
            plain(p, sr, row_base)
            errs.append(_hold(f"{k} ({tag}, stochastic_rounding={sr}, "
                              f"row_base={row_base})", list(zip(a, p))))
        library = None
        if k == "K3h":
            real = uids < R
            ids_real = uids[real].long()
            upd = (-lr * g[real]).to(dtype)
            lib = base[0].clone()
            lib.index_add_(0, ids_real, upd)
            lib_err = _within_ulp(f"K3h ({tag}) against index_add_", lib,
                                  a[0])

            def library():
                lib.index_add_(0, ids_real, upd)
        t = timings(lambda: kernel(a, True), name, b["ms"],
                    lambda: plain(p, True), library)
        row = {"max_abs_err": max(errs), "ms": t["ms"],
               "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
               "bound_ms": b["ms"], "bound_by": b["by"]}
        lib_text = "none"
        if k == "K3h":
            row["rne_ms"] = device_ms(lambda: kernel(a, False), name,
                                      b["ms"])
            row["library_max_abs_err"] = lib_err
            lib_text = (f"index_add_ {t['library_ms']:.5f} ms (within one "
                        f"ulp of the kernel to nearest, max abs "
                        f"{lib_err:.3e}; the kernel to nearest "
                        f"{row['rne_ms']:.5f} ms)")
            del lib, upd
        log(f"{k} {tag} {what}: bit-exact with its plain version under both "
            f"epilogues; {t['ms']:.5f} ms on the device (call "
            f"{t['call_ms']:.4f} ms); plain {t['plain_ms']:.4f} ms; library "
            f"{lib_text}; bound {b['ms']:.5f} ms ({b['by']}: {b['bytes']} "
            f"B); kernel at {100 * b['ms'] / t['ms']:.1f}% of the bound")
        out[tag] = row
        del a, p, base
    return {**out["bf16"], "max_abs_err": max(r["max_abs_err"]
                                              for r in out.values()),
            "fp16": out["fp16"]}


def _within_ulp(what: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """got within one ulp of ref (a half tensor) at every element; returns
    the largest absolute difference."""
    up = torch.nextafter(ref, torch.full_like(ref, float("inf")))
    ulp = (up.float() - ref.float()).abs()
    diff = (got.float() - ref.float()).abs()
    if not bool((diff <= ulp).all()):
        raise AssertionError(f"{what}: {int((diff > ulp).sum())} elements "
                             f"more than one ulp apart (max abs diff "
                             f"{diff.max().item():.3e})")
    return diff.max().item()


def check_k4h_b4r(fk, trained, batch_ids) -> dict:
    """K4h at BERT4Rec's shape: the trained [3712, 64] shard in bf16, its
    momentum, and one batch's 2,048 tokens deduplicated with cotangents
    drawn at 1e-3, as check_b4r_rowwise holds the fused K4."""
    from torchrec_tpu_torch.ops import fused_update as fu

    strat = trained.sharded_ebcs[B4R_KEY].strategies[0]
    W, M = strat.weights[0].to(torch.bfloat16), strat.momentum1[0]
    R, D = W.shape
    ids = batch_ids.to(DEVICE, torch.int32).contiguous()
    rng = np.random.RandomState(SEED + 32)
    grads = torch.from_numpy(
        (rng.randn(ids.numel(), D) * 1e-3).astype(np.float32)).to(DEVICE)
    u_dd, g_dd = fu.dedup_row_grads(
        ids, grads, torch.ones_like(ids, dtype=torch.bool), R)
    step = torch.full((), START_STEP, dtype=torch.int32, device=DEVICE)
    return check_half_update(fk, "K4h", (W, M, u_dd, g_dd, B4R_EMB_LR, step),
                             "at BERT4Rec's shape")


def check_sr_drift(fk) -> dict:
    """test_low_precision.py's drift test at width on the card: SR_STEPS
    K3h steps of lr * g = 1e-4, far below bf16's ulp at 1.0, on a bf16
    table of ones, every row touched each step, the step tensor advancing
    on the card. With stochastic rounding the mean drift must be within
    0.5-1.5x of SR_STEPS * lr * g = 0.03; rounding to nearest keeps the
    table at ones."""
    ids = torch.arange(SR_ROWS, dtype=torch.int32, device=DEVICE)
    g = torch.full((SR_ROWS, DIM), SR_G, device=DEVICE)
    drift = {}
    for sr in (True, False):
        w = torch.ones((SR_ROWS, DIM), dtype=torch.bfloat16, device=DEVICE)
        step = torch.zeros((), dtype=torch.int32, device=DEVICE)
        for _ in range(SR_STEPS):
            fk.fused_update_sgd_half(w, ids, g, SR_LR, step,
                                     stochastic_rounding=sr)
            step.add_(1)
        drift[sr] = 1.0 - w.float().mean().item()
    want = SR_STEPS * SR_LR * SR_G
    if not 0.5 * want < drift[True] < 1.5 * want or drift[False] != 0.0:
        raise AssertionError(f"SR drift {drift[True]} (want about {want}), "
                             f"to nearest {drift[False]} (want 0)")
    log(f"SR drift on the card: {SR_STEPS} K3h steps of lr * g = "
        f"{SR_LR * SR_G:g} on a [{SR_ROWS}, {DIM}] bf16 table of ones: mean "
        f"drift {drift[True]:.6f} with stochastic rounding (expected "
        f"{want:g}), {drift[False]} to nearest")
    return {"sr": drift[True], "nearest": drift[False], "expected": want}


def check_half_train_against_cpu(optim) -> None:
    """CPU_STEPS steps at B=256 of a fresh card bf16 DMP and its CPU copy,
    from seeded momenta at step START_STEP, as check_train_against_cpu.
    The f32 run totals are summed in another order on the two sides, so a
    rounding may flip: touched rows agree within one bf16 ulp, and at most
    one in 1,000 touched elements differs at all (with stochastic rounding
    this shows that both sides drew the same bits); momenta within rtol
    1e-4 / atol 1e-5; untouched rows equal."""
    name = optim.name
    gpu = make_dmp(DEVICE, train=True, optim=optim,
                   data_type=_bf16()).init(SEED + 3)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    for strat in gpu.sharded_ebcs[TRAIN_KEY].strategies:
        for m in (strat.momentum1, strat.momentum2):
            if m is not None:
                m.uniform_(0.0, 0.01, generator=gen)
        strat.step.fill_(START_STEP)
    cpu = make_dmp("cpu", train=True, optim=optim, data_type=_bf16())
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.RandomState(SEED + 33)
    batches = [make_batch(rng, SERVE_BATCH) for _ in range(CPU_STEPS)]
    step_g, step_c = gpu.make_train_step(), cpu.make_train_step()
    for i, batch in enumerate(batches):
        loss_g, _ = step_g(*to_device(batch))
        loss_c, _ = step_c(*batch)
        torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-4,
                                   atol=1e-5)
        log(f"bf16 train {name} B={SERVE_BATCH} step {i}: card loss "
            f"{loss_g.item():.9g}, CPU loss {loss_c.item():.9g}")
    pg = dict(gpu.module.named_parameters())
    for pname, p in cpu.module.named_parameters():
        torch.testing.assert_close(pg[pname].detach().cpu(), p.detach(),
                                   rtol=1e-4, atol=1e-5)
    sg = gpu.sharded_ebcs[TRAIN_KEY].strategies[0]
    sc = cpu.sharded_ebcs[TRAIN_KEY].strategies[0]
    touched = _touched(sc, batches)
    a, b = sg.weights[0].cpu(), sc.weights[0]
    if not torch.equal(a[~touched], b[~touched]):
        raise AssertionError(f"bf16 {name}: untouched rows differ")
    a, b = a[touched].float(), b[touched].float()
    mag = torch.maximum(a.abs(), b.abs()).to(torch.bfloat16)
    ulp = (torch.nextafter(mag, torch.full_like(mag, math.inf)).float()
           - mag.float())
    diff = (a - b).abs()
    differ = int((diff > 0).sum())
    if not bool((diff <= ulp).all()) or differ * 1000 > diff.numel():
        raise AssertionError(f"bf16 {name}: {differ} of {diff.numel()} "
                             f"touched elements differ from the CPU run, "
                             f"max {float((diff / ulp).max())} ulps")
    log(f"bf16 train {name}: {int(touched.sum())} touched rows within one "
        f"bf16 ulp of the CPU run, {differ} of {diff.numel()} elements "
        f"differ at all; the rest equal")
    for what in ("momentum1", "momentum2"):
        if getattr(sc, what) is None:
            continue
        ma, mb = getattr(sg, what)[0].cpu(), getattr(sc, what)[0]
        torch.testing.assert_close(ma[touched], mb[touched], rtol=1e-4,
                                   atol=1e-5)
        if not torch.equal(ma[~touched], mb[~touched]):
            raise AssertionError(f"bf16 {name}: untouched {what} differ")
        log(f"bf16 train {name}: touched {what} within rtol 1e-4 / atol "
            f"1e-5 of the CPU run (max abs diff "
            f"{(ma[touched] - mb[touched]).abs().max().item():.3e})")
    log(f"bf16 train {name}: dense parameters match the CPU run")


def bf16_dlrm(tl, fk) -> dict:
    """The bf16 DLRM phase: served, trained under EXACT_SGD and
    ROWWISE_ADAGRAD with stochastic rounding, its kernels held and timed,
    SR's drift shown, and card against CPU. Returns the launches of its
    main paths and each kernel's numbers."""
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType

    served = bf16_serve(tl)
    trained = {o: bf16_train(fk, EmbOptimType[o]) for o in HALF_STEP_KERNELS}
    drift = check_sr_drift(fk)
    for o in HALF_CPU_OPTIMS:
        check_half_train_against_cpu(EmbOptimType[o])
    launches = {
        "K1h": served["launches"] + sum(t["launches"]["K1h"]
                                        for t in trained.values()),
        **{k: trained[o]["launches"][k]
           for o, k in HALF_STEP_KERNELS.items()}}
    log(f"bf16 DLRM: launches on its paths {launches} (K1h: "
        f"{served['launches']} requests and "
        f"{2 * (WARMUP_STEPS + TIMED_STEPS)} train steps)")
    return {"launches": launches, "drift": drift,
            "results": {"K1h": served["k1h"],
                        **{k: trained[o]["held"]
                           for o, k in HALF_STEP_KERNELS.items()}}}


# -- SimpleDeepFMNN -----------------------------------------------------------

# SimpleDeepFMNN over bench.py's tables: 400-unit hidden layers, the DeepFM
# paper's Criteo setting (Guo et al., IJCAI 2017, section 3.1), since the
# JAX package publishes no DeepFM configuration of its own
DFM_HIDDEN = DFM_DEEP = 400
DFM_KEY = "sparse_arch/embedding_bag_collection"
DFM_TRAIN_KEY = "m/" + DFM_KEY  # the same EBC inside DeepFMTrain
DFM_DENSE_LR, DFM_CLIP = 1e-3, 1.0
DFM_STAGES = (("LINEAR", 8, 0.1), ("CONSTANT", 100, 0.5))
DFM_EPS = 1e-7  # the BCE's clip of the probabilities
DFM_PROFILED_STEPS = 2
# the FM's tolerance: relative to (sum x)^2 + sum x^2 of its row
FM_RTOL = 1e-5
# the cross nets at the DeepFM's interaction width (this phase's choice:
# no JAX model uses a cross net)
CROSS_N = DIM + NUM_TABLES * DIM  # 3,456
CROSS_LAYERS, CROSS_RANK, CROSS_EXPERTS = 3, 64, 4


class DeepFMTrain(torch.nn.Module):
    """SimpleDeepFMNN + a BCE on its probabilities clipped to [DFM_EPS,
    1 - DFM_EPS], as the CPU tests train it (the JAX package has no DeepFM
    train module)."""

    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, dense, sparse, labels):
        p = self.m(dense, sparse)[:, 0]
        pc = p.clamp(DFM_EPS, 1.0 - DFM_EPS)
        loss = -torch.mean(labels * torch.log(pc)
                           + (1.0 - labels) * torch.log1p(-pc))
        return loss, (loss, p)


def _dfm_stages():
    from torchrec_tpu_torch.optim import WarmupPolicy, WarmupStage

    return [WarmupStage(WarmupPolicy[p], m, v) for p, m, v in DFM_STAGES]


def dfm_fused_lr(step: int) -> float:
    """The fused lr of train step `step` from the stages' formulas in
    float64, apart from the port's schedule: a ramp from 0.1 to 1 of the
    base lr over steps 0..8, then half of it up to step 100."""
    if step <= 8:
        return FUSED_LR * (0.1 + 0.9 * step / 8)
    return FUSED_LR * (0.5 if step <= 100 else 1.0)


def make_dfm_dmp(device: str, train: bool = False, optim=None):
    """SimpleDeepFMNN over bench.py's 26 tables (DeepFMTrain when `train`)
    on `device`: fused lr from the warmup schedule (base 0.1), dense
    optimizer warmup(clip NORM 1.0 (Adam 1e-3)) under the same stages;
    `optim` defaults to ROWWISE_ADAGRAD."""
    from torchrec_tpu_torch.models import SimpleDeepFMNN
    from torchrec_tpu_torch.modules import (
        EmbeddingBagCollection,
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.optim import (
        GradientClipping,
        gradient_clipping,
        make_warmup_schedule,
        warmup_optimizer,
    )
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )

    tables = [EmbeddingBagConfig(num_embeddings=ROWS, embedding_dim=DIM,
                                 name=f"t{i}", feature_names=[f"f{i}"])
              for i in range(NUM_TABLES)]
    model = SimpleDeepFMNN(
        DENSE_IN, EmbeddingBagCollection(tables, max_feature_length=L,
                                         device="meta"),
        DFM_HIDDEN, DFM_DEEP, device="meta")
    if train:
        model = DeepFMTrain(model)
    plan = ShardingPlan({DFM_TRAIN_KEY if train else DFM_KEY: {
        t.name: ParameterSharding(ShardingType.ROW_WISE) for t in tables}})
    return DistributedModelParallel(
        model, plan=plan, device=device,
        fused_optim=optim or EmbOptimType.ROWWISE_ADAGRAD,
        fused_params={"learning_rate": FUSED_LR,
                      "lr_schedule": make_warmup_schedule(_dfm_stages(),
                                                          FUSED_LR)},
        dense_optimizer=warmup_optimizer(gradient_clipping(
            lambda p: torch.optim.Adam(p, lr=DFM_DENSE_LR),
            GradientClipping.NORM, DFM_CLIP), _dfm_stages()))


def _fm_inputs(model, seen: dict):
    """A forward hook keeping the FM's output and its rows' (sum x)^2 +
    sum x^2 (float64, on the CPU) in `seen`."""

    def hook(module, args, out):
        x = torch.cat([t.reshape(t.shape[0], -1) for t in args[0]],
                      dim=1).double().cpu()
        seen["fm"] = out.detach().cpu()
        seen["size"] = x.sum(1, keepdim=True) ** 2 + (x * x).sum(
            1, keepdim=True)

    return model.inter_arch.fm.register_forward_hook(hook)


def _hold_fm(what: str, got: torch.Tensor, ref: torch.Tensor,
             size: torch.Tensor) -> float:
    """|got - ref| <= FM_RTOL * ((sum x)^2 + sum x^2) per row; returns the
    largest ratio of the difference to that size."""
    diff = (got.double() - ref.double()).abs()
    if not bool((diff <= FM_RTOL * size).all()):
        raise AssertionError(f"{what}: card and CPU differ by "
                             f"{diff.max().item():.3e}, over {FM_RTOL} of "
                             f"(sum x)^2 + sum x^2")
    return (diff / size).max().item()


def dfm_serve() -> dict:
    """REQUESTS_PER_BATCH requests at B=8192 and at B=256 through
    make_eval_fn, each launching K1 once and nothing else of the port;
    probabilities finite and in [0, 1]; one B=256 request's FM scalar and
    probabilities equal to a CPU copy's within FM_RTOL of the FM's
    (sum x)^2 + sum x^2 (the FM cancels: a tolerance relative to the
    result would test the cancellation, not the port)."""
    dmp = make_dfm_dmp(DEVICE).init(SEED)
    eval_fn = dmp.make_eval_fn()
    rng = np.random.RandomState(SEED + 40)
    requests = [(b, *make_request(rng, b))
                for b in [BENCH_BATCH] * REQUESTS_PER_BATCH
                + [SERVE_BATCH] * REQUESTS_PER_BATCH]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    latencies = {BENCH_BATCH: [], SERVE_BATCH: []}
    for batch, dense, kjt in requests:
        before = counts()
        t0 = time.perf_counter()
        p = eval_fn(dense.to(DEVICE), kjt.to(DEVICE)).cpu()
        latencies[batch].append((time.perf_counter() - t0) * 1e3)
        after = counts()
        launched = {k: after[k] - before[k] for k in after}
        if launched != expected(K1=1):
            raise AssertionError(f"a DeepFM request launched {launched}")
        if (p.shape != (batch, 1) or not bool(torch.isfinite(p).all())
                or not bool(((p >= 0) & (p <= 1)).all())):
            raise AssertionError(f"bad DeepFM probabilities at B={batch}")
    launches = counts()["K1"]
    peak = torch.cuda.max_memory_allocated()
    for batch, ms in latencies.items():
        log(f"deepfm serve B={batch}: request ms (host clock, H2D + forward "
            f"+ D2H, first includes warm-up) {ms}")
    log(f"deepfm serve: {len(requests)} requests, K1 launches {launches}; "
        f"max_memory_allocated {peak} B")
    fwd = {}
    for batch in (BENCH_BATCH, SERVE_BATCH):
        dense, kjt = make_request(rng, batch)
        dense, kjt = dense.to(DEVICE), kjt.to(DEVICE)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eval_fn(dense, kjt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        fwd[batch] = times
        log(f"deepfm serve B={batch}: forward ms (host clock, synchronized) "
            f"{times}")

    # one more B=256 request on the card and on a CPU copy, the FM's
    # inputs and output kept by a hook (not on the timed requests: it
    # copies the [B, 3456] input to the host)
    dense, kjt = make_request(rng, SERVE_BATCH)
    seen: dict = {}
    hook = _fm_inputs(dmp.module, seen)
    p = eval_fn(dense.to(DEVICE), kjt.to(DEVICE)).cpu()
    hook.remove()
    fm = seen["fm"]
    cpu = make_dfm_dmp("cpu")
    cpu.load_state_dict(dmp.state_dict())
    hook = _fm_inputs(cpu.module, seen)
    ref = cpu.make_eval_fn()(dense, kjt)
    hook.remove()
    size = seen["size"]
    r_fm = _hold_fm("deepfm FM scalar", fm, seen["fm"], size)
    r_p = _hold_fm("deepfm probabilities", p, ref, size)
    log(f"deepfm serve B={SERVE_BATCH}: card against CPU, FM scalar within "
        f"{r_fm:.3e} and probabilities within {r_p:.3e} of (sum x)^2 + sum "
        f"x^2 (allowed {FM_RTOL}; size {size.min().item():.4g}.."
        f"{size.max().item():.4g}); probabilities max abs diff "
        f"{(p - ref).abs().max().item():.3e}")
    return {"launches": launches, "request_ms": latencies,
            "forward_ms": fwd, "peak_bytes": peak}


def dfm_train(optim) -> dict:
    """WARMUP_STEPS + TIMED_STEPS train steps at B=8192, each launching K1
    and K3 (EXACT_SGD) or the fused K4 (ROWWISE_ADAGRAD) once and nothing
    else; the lr each update kernel got equals the stages' formula for the
    step (dfm_fused_lr, rtol 1e-6) and the port's schedule exactly; the
    warmup's count equals the steps taken; losses finite. Counts the steps
    whose gradient norm reached the clip. Then DFM_PROFILED_STEPS steps
    are profiled."""
    from torchrec_tpu_torch.ops import fused_update_kernels as fk

    name = optim.name
    update = KERNELS[STEP_KERNELS[name][0]][0]
    lr_arg = 3 if name == "EXACT_SGD" else 4  # lr's place in its arguments
    dmp = make_dfm_dmp(DEVICE, train=True, optim=optim).init(SEED)
    opt = dmp.dense_optimizer
    step = dmp.make_train_step()
    rng = np.random.RandomState(SEED + 41)
    batches = [to_device(make_batch(rng, BENCH_BATCH))
               for _ in range(WARMUP_STEPS + TIMED_STEPS
                              + DFM_PROFILED_STEPS)]
    per_step = expected(K1=1, **{k: 1 for k in STEP_KERNELS[name]})
    seen: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, losses, lrs, norms = [], [], [], []
    with capturing(fk, update, seen):
        for i, batch in enumerate(batches[:WARMUP_STEPS + TIMED_STEPS]):
            before = counts()
            t0 = time.perf_counter()
            loss, _ = step(*batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            after = counts()
            launched = {k: after[k] - before[k] for k in after}
            if launched != per_step:
                raise AssertionError(f"deepfm {name} step {i} launched "
                                     f"{launched}, expected {per_step}")
            lr = float(seen.pop(update)[lr_arg])
            if (lr != dmp.fused_lr_schedule(i)
                    or not math.isclose(lr, dfm_fused_lr(i), rel_tol=1e-6)):
                raise AssertionError(f"deepfm {name} step {i}: fused lr {lr}"
                                     f", expected {dfm_fused_lr(i)}")
            if opt.count != i + 1 or dmp.step != i + 1:
                raise AssertionError(f"deepfm {name} step {i}: warmup count "
                                     f"{opt.count}, DMP step {dmp.step}")
            lrs.append(lr)
            norms.append(opt.inner.last_norm.item())
            losses.append(loss.item())
            if not math.isfinite(losses[-1]):
                raise AssertionError(f"deepfm {name} step {i}: loss "
                                     f"{losses[-1]}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    timed = ms[WARMUP_STEPS:]
    median = sorted(timed)[TIMED_STEPS // 2]
    ex_per_s = TIMED_STEPS * BENCH_BATCH / (sum(timed) / 1e3)
    clipped = sum(n >= DFM_CLIP for n in norms)
    log(f"deepfm train {name} B={BENCH_BATCH}: losses {losses}")
    log(f"deepfm train {name}: fused lr per step {lrs}; warmup count "
        f"{opt.count}; dense gradient norms {norms}, the clip at "
        f"{DFM_CLIP} engaged on {clipped} of {len(norms)} steps")
    log(f"deepfm train {name}: warm-up step ms {ms[:WARMUP_STEPS]}; timed "
        f"step ms (host clock, synchronized) {timed}; min {min(timed):.4f} "
        f"max {max(timed):.4f} median {median:.4f}; {ex_per_s:.1f} "
        f"examples/s; launches per step {per_step}, in all {launches}; "
        f"max_memory_allocated {peak} B")
    profile_steps(step, batches[-DFM_PROFILED_STEPS:],
                  f"deepfm train {name} B={BENCH_BATCH}, profiled")
    return {"launches": launches, "ms": timed, "median_ms": median,
            "peak_bytes": peak, "clipped": clipped}


def _keyed(dmp):
    from torchrec_tpu_torch.optim import KeyedOptimizer

    return KeyedOptimizer(dmp.dense_optimizer,
                          dict(dmp.module.named_parameters()))


def dfm_against_cpu(optim, strict_check: bool = False) -> None:
    """A fresh card DeepFMTrain DMP at step START_STEP (fused momenta and
    the dense Adam's moments drawn from U(0, 0.01), every count and step at
    START_STEP: mid-ramp), its KeyedOptimizer and CombinedOptimizer
    state_dicts taken on the card and loaded into a CPU copy (which must
    then give the same CombinedOptimizer state_dict); with
    `strict_check`, a load missing one key must raise KeyError. Then
    CPU_STEPS steps at B=256 on both: losses, dense parameters, Adam's
    moments and counts, and the touched rows and momenta within rtol
    1e-4 / atol 1e-5, untouched rows equal."""
    from torchrec_tpu_torch.optim import CombinedOptimizer

    name = optim.name
    gpu = make_dfm_dmp(DEVICE, train=True, optim=optim).init(SEED + 3)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    sebc = gpu.sharded_ebcs[DFM_TRAIN_KEY]
    for strat in sebc.strategies:
        for m in (strat.momentum1, strat.momentum2):
            if m is not None:
                m.uniform_(0.0, 0.01, generator=gen)
        strat.step.fill_(START_STEP)
    keyed = _keyed(gpu)
    for key, t in keyed.state_dict().items():
        if key.endswith(("/exp_avg", "/exp_avg_sq")):
            t.uniform_(0.0, 0.01, generator=gen)
        else:  # Adam's steps and the warmup's count
            t.fill_(START_STEP)
    gpu.step = START_STEP
    combined = CombinedOptimizer([("dense", keyed),
                                  ("ebc", sebc)]).state_dict()

    cpu = make_dfm_dmp("cpu", train=True, optim=optim)
    cpu.load_state_dict(gpu.state_dict())
    cpu.step = gpu.step
    keyed_c = _keyed(cpu)
    dense_sd = {k[len("dense/"):]: v for k, v in combined.items()
                if k.startswith("dense/")}
    if strict_check:
        partial = dict(dense_sd)
        partial.pop(next(iter(partial)))
        try:
            keyed_c.load_state_dict(partial)
        except KeyError as e:
            log(f"deepfm: a strict load missing a key raised KeyError {e}")
        else:
            raise AssertionError("a load missing a key did not raise")
    keyed_c.load_state_dict(dense_sd)
    combined_c = CombinedOptimizer(
        [("dense", keyed_c), ("ebc", cpu.sharded_ebcs[DFM_TRAIN_KEY])]
    ).state_dict()
    if combined_c.keys() != combined.keys() or not all(
            torch.equal(combined_c[k], v.cpu()) for k, v in combined.items()):
        raise AssertionError("the CPU copy's CombinedOptimizer state differs")
    if cpu.dense_optimizer.count != START_STEP:
        raise AssertionError("the CPU copy's warmup count did not load")
    fused = sorted(k for k in combined if not k.startswith("dense/"))
    log(f"deepfm {name}: {len(combined)} CombinedOptimizer entries taken on "
        f"the card ({fused} and {len(dense_sd)} dense ones) loaded into a "
        f"CPU copy, equal")

    rng = np.random.RandomState(SEED + 42)
    batches = [make_batch(rng, SERVE_BATCH) for _ in range(CPU_STEPS)]
    step_g, step_c = gpu.make_train_step(), cpu.make_train_step()
    for i, batch in enumerate(batches):
        loss_g, _ = step_g(*to_device(batch))
        loss_c, _ = step_c(*batch)
        torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-4,
                                   atol=1e-5)
        log(f"deepfm {name} B={SERVE_BATCH} step {START_STEP + i}: card loss "
            f"{loss_g.item():.9g}, CPU loss {loss_c.item():.9g}")
    pg = dict(gpu.module.named_parameters())
    for pname, p in cpu.module.named_parameters():
        torch.testing.assert_close(pg[pname].detach().cpu(), p.detach(),
                                   rtol=1e-4, atol=1e-5)
    sd_g, sd_c = _keyed(gpu).state_dict(), keyed_c.state_dict()
    for key, t in sd_c.items():
        torch.testing.assert_close(sd_g[key].cpu(), t, rtol=1e-4, atol=1e-5)
    if not (gpu.dense_optimizer.count == cpu.dense_optimizer.count
            == START_STEP + CPU_STEPS):
        raise AssertionError("deepfm: the warmup counts differ")
    sg, sc = sebc.strategies[0], cpu.sharded_ebcs[DFM_TRAIN_KEY].strategies[0]
    touched = _touched(sc, batches)
    pairs = [("table", sg.weights[0].cpu(), sc.weights[0])]
    if sc.momentum1 is not None:
        pairs.append(("momentum1", sg.momentum1[0].cpu(), sc.momentum1[0]))
    for what, a, b in pairs:
        torch.testing.assert_close(a[touched], b[touched], rtol=1e-4,
                                   atol=1e-5)
        if not torch.equal(a[~touched], b[~touched]):
            raise AssertionError(f"deepfm {name}: untouched {what} differ")
        log(f"deepfm {name}: {int(touched.sum())} touched {what} rows within "
            f"rtol 1e-4 / atol 1e-5 of the CPU run (max abs diff "
            f"{(a[touched] - b[touched]).abs().max().item():.3e}), the rest "
            f"equal")
    log(f"deepfm {name}: dense parameters and Adam's moments match the CPU "
        f"run; warmup count {START_STEP + CPU_STEPS} on both")


def check_cross_nets() -> dict:
    """The four cross nets at N=3,456, B=8,192, 3 layers (low rank 64, 4
    experts): forward and backward on the card against a CPU copy, each
    timed on the card. The output and the input gradient hold to rtol
    1e-4 and an atol of 1e-5 of their largest element, each parameter
    gradient to 1e-4 of its largest element: each element is a sum of
    3,456 (8,192 for a parameter) products run in another order, whose
    rounding follows the size of the products, not of the sum."""
    from torchrec_tpu_torch.modules import (
        CrossNet,
        LowRankCrossNet,
        LowRankMixtureCrossNet,
        VectorCrossNet,
    )

    makers = {
        "CrossNet": lambda d: CrossNet(CROSS_N, CROSS_LAYERS, d),
        "LowRankCrossNet": lambda d: LowRankCrossNet(
            CROSS_N, CROSS_LAYERS, CROSS_RANK, d),
        "VectorCrossNet": lambda d: VectorCrossNet(CROSS_N, CROSS_LAYERS, d),
        "LowRankMixtureCrossNet": lambda d: LowRankMixtureCrossNet(
            CROSS_N, CROSS_LAYERS, CROSS_EXPERTS, CROSS_RANK, d),
    }
    rng = np.random.RandomState(SEED + 43)
    x0 = torch.from_numpy(
        (0.5 * rng.randn(BENCH_BATCH, CROSS_N)).astype(np.float32))
    cot = torch.from_numpy(rng.randn(BENCH_BATCH, CROSS_N).astype(np.float32))
    out = {}
    for name, make in makers.items():
        gpu = make(DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 44)
        for m in gpu.modules():
            reset = getattr(m, "reset_parameters", None)
            if reset is not None:
                reset(generator=gen)
        cpu = make("cpu")
        cpu.load_state_dict(gpu.state_dict())
        results = {}
        for side, mod, dev in (("card", gpu, DEVICE), ("cpu", cpu, "cpu")):
            # copies: x0 itself stays a constant, and no result aliases a
            # gradient that the timing below accumulates into
            x = x0.to(dev, copy=True).requires_grad_(True)
            y = mod(x)
            y.backward(cot.to(dev))
            results[side] = (y.detach().cpu(), x.grad.cpu().clone(),
                             {n: p.grad.cpu().clone()
                              for n, p in mod.named_parameters()})
        (yg, dxg, pgg), (yc, dxc, pgc) = results["card"], results["cpu"]
        for a, b in ((yg, yc), (dxg, dxc)):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-5 * b.abs().max().item())
        worst = 0.0
        for pname, gc in pgc.items():
            ratio = ((pgg[pname] - gc).abs().max()
                     / gc.abs().max().clamp(min=1e-30)).item()
            if ratio > 1e-4:
                raise AssertionError(f"{name} {pname}: gradient off by "
                                     f"{ratio:.3e} of its largest element")
            worst = max(worst, ratio)
        x = x0.to(DEVICE, copy=True).requires_grad_(True)
        c = cot.to(DEVICE)

        def fwd_bwd():
            gpu.zero_grad(set_to_none=True)
            gpu(x).backward(c)

        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: gpu(x), iters=10, warmup=2)
        both_ms = cuda_ms(fwd_bwd, iters=10, warmup=2)
        n_params = sum(p.numel() for p in gpu.parameters())
        log(f"cross net {name} N={CROSS_N} B={BENCH_BATCH} layers "
            f"{CROSS_LAYERS}: {n_params} parameters; card against CPU: "
            f"output max abs diff {(yg - yc).abs().max().item():.3e} (max "
            f"{yc.abs().max().item():.3e}), input gradient "
            f"{(dxg - dxc).abs().max().item():.3e} (max "
            f"{dxc.abs().max().item():.3e}), parameter "
            f"gradients within {worst:.3e} of their largest elements; "
            f"forward {fwd_ms:.4f} ms, forward + backward {both_ms:.4f} ms "
            f"on the card (CUDA events)")
        out[name] = {"fwd_ms": fwd_ms, "fwd_bwd_ms": both_ms}
        del gpu, cpu, results, x, c
    return out


def deepfm() -> dict:
    """The DeepFM phase: served, trained under EXACT_SGD and
    ROWWISE_ADAGRAD with the warmup schedule and the clipped dense Adam,
    the optimizer state carried card to CPU and both trained on, and the
    cross nets. Returns the launches of its main paths."""
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType

    served = dfm_serve()
    trained = {o: dfm_train(EmbOptimType[o])
               for o in ("EXACT_SGD", "ROWWISE_ADAGRAD")}
    for i, o in enumerate(trained):
        dfm_against_cpu(EmbOptimType[o], strict_check=i == 0)
    cross = check_cross_nets()
    launches = {"K1": served["launches"] + sum(t["launches"]["K1"]
                                               for t in trained.values()),
                "K3": trained["EXACT_SGD"]["launches"]["K3"],
                "K4": trained["ROWWISE_ADAGRAD"]["launches"]["K4"]}
    log(f"deepfm: launches on its paths {launches} (K1: "
        f"{served['launches']} requests and "
        f"{2 * (WARMUP_STEPS + TIMED_STEPS)} train steps)")
    return {"launches": launches, "cross": cross}


# -- quantized serving --------------------------------------------------------

# the quantized types served (bits), and the request stream of the batching
# servers: Q_CLIENT_REQUESTS ragged requests of 1..Q_MAX_EXAMPLES examples
# from Q_CLIENTS threads, Q_TCP_REQUESTS of them also over TCP
QUANT_TYPES = {"INT8": 8, "INT4": 4}
Q_SERVER_BATCH = 256
Q_CLIENT_REQUESTS, Q_MAX_EXAMPLES, Q_CLIENTS, Q_TCP_REQUESTS = 64, 64, 4, 8
Q_TIMEOUT_S = 120.0  # every future and TCP answer, and stop()
Q_TRAIN_STEPS = 3
QUANT_KEYS = tuple(f"f{i}" for i in range(NUM_TABLES))
# the logit distance from f32 is held within this multiple of its
# first-order bound (see quant_bounds)
Q_SLACK = 2.0
FP16_REL = 2.0 ** -11  # fp16's relative rounding step (to nearest)


def quant_requests(rng: np.random.RandomState) -> list:
    """(batch, dense [B, 13] f32, ids [26, B, 1] i32) as numpy: 3 at
    B=8192, then 3 at B=256."""
    out = []
    for b in ([BENCH_BATCH] * REQUESTS_PER_BATCH
              + [SERVE_BATCH] * REQUESTS_PER_BATCH):
        out.append((b, rng.randn(b, DENSE_IN).astype(np.float32),
                    rng.randint(0, ROWS, size=(NUM_TABLES, b, L)).astype(
                        np.int32)))
    return out


def quant_args(dense, ids, device=None):
    """The predict module's (dense, PaddedSparseBatch, labels) for one
    request, built by the servers' DLRM collate."""
    from torchrec_tpu_torch.inference import make_dlrm_collate

    return make_dlrm_collate(QUANT_KEYS, device or DEVICE)(
        [(dense, ids)], dense.shape[0])


def logits_of(out) -> torch.Tensor:
    """DLRMTrain's (loss, (loss, logits, labels)) -> logits."""
    return out[1][1]


def quant_serve(predict, requests, what: str, per_request: dict) -> dict:
    """`requests` through `predict`, each launching exactly
    `per_request`; host-clock latency (copies in and out), logits on the
    CPU, peak memory from a reset just before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    logits, ms = [], {BENCH_BATCH: [], SERVE_BATCH: []}
    for batch, dense, ids in requests:
        before = counts()
        t0 = time.perf_counter()
        out = logits_of(predict(*quant_args(dense, ids))).cpu()
        ms[batch].append((time.perf_counter() - t0) * 1e3)
        after = counts()
        launched = {k: after[k] - before[k] for k in after}
        if launched != expected(**per_request):
            raise AssertionError(f"{what} B={batch}: launched {launched}")
        if out.shape != (batch,) or not torch.isfinite(out).all():
            raise AssertionError(f"{what}: bad logits {tuple(out.shape)}")
        logits.append(out)
    peak = torch.cuda.max_memory_allocated()
    for batch, t in ms.items():
        log(f"{what} B={batch}: request ms (host clock, collate + H2D + "
            f"predict + D2H, first includes warm-up) {t}")
    log(f"{what}: {len(requests)} requests, launches {counts()}, "
        f"max_memory_allocated {peak} B")
    return {"logits": logits, "ms": ms, "peak_bytes": peak,
            "launches": counts()}


def quant_train():
    """bench.py's DLRM trained Q_TRAIN_STEPS steps at B=8192 under
    EXACT_SGD, each launching K1 and K3 once."""
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType

    dmp = make_dmp(DEVICE, train=True,
                   optim=EmbOptimType.EXACT_SGD).init(SEED)
    step = dmp.make_train_step()
    rng = np.random.RandomState(SEED + 20)
    reset_counts()
    losses = []
    for _ in range(Q_TRAIN_STEPS):
        loss, _ = step(*to_device(make_batch(rng, BENCH_BATCH)))
        losses.append(loss.item())
    if counts() != expected(K1=Q_TRAIN_STEPS, K3=Q_TRAIN_STEPS):
        raise AssertionError(f"quantized phase's training launched "
                             f"{counts()}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"quantized phase's training: losses {losses}")
    dmp.dense_optimizer.zero_grad(set_to_none=True)
    log(f"quant: trained {Q_TRAIN_STEPS} EXACT_SGD steps at B={BENCH_BATCH},"
        f" losses {losses}, launches {counts()}")
    return dmp


def row_error_bound(tables: dict, bits: int) -> dict:
    """Per table, each row's bound on |dequantized - f32| (any element):
    half a step of the fp16-rounded scale, plus the shift's fp16 rounding
    (at most |lo| 2^-11, or half fp16's smallest subnormal) and what a
    scale rounded down loses at the top of the range, clipped to qmax:
    qmax times the scale's fp16 rounding, at most (hi - lo) 2^-11 for a
    normal scale and qmax 2^-25 for a subnormal one (a row whose range is
    below qmax 2^-14, as in the Kaggle tables' largest at their initial
    U(-b, b), b = sqrt(1 / rows))."""
    qmax = (1 << bits) - 1
    out = {}
    for name, w in tables.items():
        lo, hi = w.amin(1), w.amax(1)
        scale = ((hi - lo) / qmax).half().float()
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        top = ((hi - lo) * FP16_REL).clamp(min=qmax * 2.0 ** -25)
        out[name] = scale / 2 + lo.abs() * FP16_REL + top + 2.0 ** -25
    return out


def quant_bounds(dmp, requests) -> dict:
    """For the B=256 requests and each quantized type: each example's
    first-order bound on its logit's distance from the f32 model, the sum
    over its pooled elements of |d logit / d pooled| times the row's error
    bound; and the f32 pooled values with each element's bound, for the
    embeddings' own check."""
    sebc = dmp.sharded_ebcs[TRAIN_KEY]
    tables = sebc.unshard_tables()
    per_row = {name: row_error_bound(tables, bits)
               for name, bits in QUANT_TYPES.items()}
    out = {name: [] for name in QUANT_TYPES}
    for batch, dense, ids in requests:
        if batch != SERVE_BATCH:
            continue
        args = quant_args(dense, ids)
        with torch.no_grad():
            pooled = sebc(args[1])
        leaf = pooled.values.detach().clone().requires_grad_(True)
        sebc.injected = dataclasses.replace(pooled, values=leaf)
        try:
            logits_of(dmp.module(*args)).sum().backward()
        finally:
            sebc.injected = None
        g = leaf.grad.reshape(batch, NUM_TABLES, DIM).abs().sum(-1)
        rows = torch.from_numpy(ids[:, :, 0].T).to(DEVICE).long()  # [B, 26]
        for name, bnd in per_row.items():
            eps = torch.stack([bnd[f"t{i}"][rows[:, i]]
                               for i in range(NUM_TABLES)], 1)
            out[name].append({"logit": (g * eps).sum(1).cpu(),
                              "pooled": pooled.values.detach(),
                              "eps": eps.repeat_interleave(DIM, 1)})
    dmp.dense_optimizer.zero_grad(set_to_none=True)
    return out


def quant_bound(bits: int, D: int, ids: torch.Tensor,
                coeff: torch.Tensor) -> dict:
    """Least time for Kq: each distinct row that a nonzero coefficient
    reads once (its packed bytes, scale and shift), ids and coefficients
    once, the output once, over the HBM rate; against 4 flops per live
    slot and column (dequantize, scale, add) over the fp32 rate."""
    live = ids[coeff != 0]
    rows = int(torch.unique(live).numel())
    NB = ids.shape[0]
    nbytes = (rows * (D * bits // 8 + 8) + ids.numel() * 4
              + coeff.numel() * 4 + NB * D * 4)
    flops = 4 * int(live.numel()) * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {"bytes": nbytes, "rows": rows, "ms": max(t_bytes, t_ops) * 1e3,
            "by": "bytes" if t_bytes >= t_ops else "operations"}


def library_quant_lookup(sq, ids: torch.Tensor):
    """PyTorch's own int-N pooled lookup over the same rows: the group
    repacked once into its fused rows (the packed bytes, then scale and
    shift inline: f32 for the byte op, fp16 for the 4-bit one, which holds
    the fp16-rounded values exactly), one bag per id, SUM. The CUDA ops
    take whole groups of columns only (the byte op D % 4 == 0, the 4-bit
    one D % 8 == 0), so a narrower row is padded with zero codes to the
    next such width and the call returns the first D columns (a view).
    Returns the call; it is timed here and used nowhere in the port."""
    R, D = sq.data.shape[0], sq.data.shape[1] * 8 // sq.bits
    ty = torch.float32 if sq.bits == 8 else torch.float16
    pad = -D % (4 if sq.bits == 8 else 8) * sq.bits // 8  # bytes
    fused = torch.cat([sq.data, sq.data.new_zeros((R, pad))] + [
        v.to(ty).view(torch.uint8).reshape(R, -1)
        for v in (sq.scale, sq.shift)], dim=1).contiguous()
    op = (torch.ops.quantized.embedding_bag_byte_rowwise_offsets
          if sq.bits == 8 else
          torch.ops.quantized.embedding_bag_4bit_rowwise_offsets)
    idx = ids.reshape(-1)
    offsets = torch.arange(idx.numel() + 1, dtype=idx.dtype,
                           device=idx.device)
    return lambda: op(fused, idx, offsets, False, 0, False, None, None,
                      True)[:, :D]


def check_quant_kernel(ql, tl, sq, W, ids, what: str) -> dict:
    """Kq on the sharded group `sq` at the path's shape (ids [NB, 1]
    rebased, coefficient 1): bit-exact with its plain version, pooled and
    unpooled; timed beside the plain version and K1 on the f32 table W
    at the same ids."""
    coeff = torch.ones(ids.shape, device=DEVICE)
    args = (sq.data, sq.scale, sq.shift, ids, coeff, sq.bits)
    out = ql.quant_lookup_pooled(*args)
    ref = ql.quant_lookup_pooled_reference(*args)
    rows = ql.quant_lookup_rows(*args[:3], ids.reshape(-1), sq.bits)
    rows_ref = ql.quant_lookup_rows_reference(*args[:3], ids.reshape(-1),
                                              sq.bits)
    torch.cuda.synchronize()
    if not (torch.equal(out, ref) and torch.equal(rows, rows_ref)):
        raise AssertionError(f"Kq {what} at the path's shape is not "
                             "bit-exact with its plain version")
    b = quant_bound(sq.bits, sq.dim, ids, coeff)
    lib = library_quant_lookup(sq, ids)
    got = lib()
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    lib_err = (got - ref).abs().max().item()
    t = timings(lambda: ql.quant_lookup_pooled(*args), KQ_KERNELS,
                b["ms"], lambda: ql.quant_lookup_pooled_reference(*args),
                lib)
    kb = bound(W, ids, coeff)
    k1 = device_ms(lambda: tl.tbe_lookup_pooled(W, ids, coeff),
                   K1_KERNELS, kb["ms"])
    log(f"Kq {what} L=1 NB={ids.shape[0]} D={sq.dim}: bit-exact with the "
        f"plain version (pooled and unpooled); {t['ms']:.5f} ms on the "
        f"device (call {t['call_ms']:.5f} ms); plain {t['plain_ms']:.4f} ms;"
        f" PyTorch's quantized embedding bag {t['library_ms']:.5f} ms "
        f"(within rtol=atol=1e-6 of the plain version, max abs err "
        f"{lib_err:.3e});"
        f" K1 on the f32 table at the same ids {k1:.5f} ms (bound "
        f"{kb['ms']:.5f}); bound {b['ms']:.5f} ms ({b['by']}: {b['bytes']} B"
        f" with {b['rows']} distinct rows); kernel at "
        f"{100 * b['ms'] / t['ms']:.1f}% of the bound")
    return {"max_abs_err": (out - ref).abs().max().item(), "ms": t["ms"],
            "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": b["ms"], "bound_by": b["by"],
            "library_ms": t["library_ms"], "library_max_abs_err": lib_err,
            "k1_same_ids_ms": k1, "k1_bound_ms": kb["ms"]}


def check_quant_kernel_cases(ql) -> float:
    """Kq against its plain version off the path: L=20 with MEAN and
    per-sample coefficients, zero lengths, ids >= R and negative ids, at
    8, 4 and 2 bits and D = 128, 96, 64 (and 66, the scalar path at 8
    bits): rtol 1e-6; the unpooled mode with a coefficient bit for bit."""
    from torchrec_tpu_torch.ops.quant import quantize_rowwise

    rng = np.random.RandomState(SEED + 21)
    R, NB, L20 = 50_000, 8192, 20
    worst = 0.0
    for bits, D in ((8, 128), (4, 128), (2, 128), (8, 96), (4, 96),
                    (2, 64), (8, 66)):
        w = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(DEVICE)
        q = quantize_rowwise(w, bits)
        ids = torch.from_numpy(rng.randint(-50, R + 50, size=(NB, L20)
                                           ).astype(np.int32)).to(DEVICE)
        lengths = torch.from_numpy(rng.randint(0, L20 + 1, size=NB)).to(
            DEVICE)
        mask = (torch.arange(L20, device=DEVICE)[None, :]
                < lengths[:, None]).float()
        psw = torch.from_numpy(rng.rand(NB, L20).astype(np.float32)).to(
            DEVICE)
        coeff = torch.where(
            torch.arange(NB, device=DEVICE)[:, None] % 2 == 0,
            mask / lengths.clamp(min=1)[:, None], mask * psw).contiguous()
        args = (q.data, q.scale, q.shift, ids, coeff, bits)
        out = ql.quant_lookup_pooled(*args)
        ref = ql.quant_lookup_pooled_reference(*args)
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
        flat, c = ids.reshape(-1), coeff.reshape(-1)
        rows = ql.quant_lookup_rows(q.data, q.scale, q.shift, flat, bits, c)
        rows_ref = ql.quant_lookup_rows_reference(q.data, q.scale, q.shift,
                                                  flat, bits, c)
        torch.cuda.synchronize()
        if not torch.equal(rows, rows_ref):
            raise AssertionError(f"Kq unpooled at {bits} bits, D={D}: not "
                                 "bit-exact")
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        log(f"Kq {bits} bits D={D} L={L20} (MEAN / weighted, ids in "
            f"[-50, R+50)): within rtol=atol=1e-6, max abs err {err:.3e}, "
            f"bit-exact {torch.equal(out, ref)}; unpooled bit-exact")
    return worst


def quant_servers(pm, reqs) -> dict:
    """The batching servers at server batch Q_SERVER_BATCH over `pm`: the
    Python BatchingPredictServer and the native NativePredictServer
    (pipeline on) with Q_CLIENT_REQUESTS ragged requests from Q_CLIENTS
    threads, Q_TCP_REQUESTS of them also over TCP; every result against
    a direct predict (rtol 1e-5: another server batch can give the
    GEMMs another cuBLAS algorithm) and the native server's against the
    Python one's. Kq launches 26 per predict call, K1 never."""
    from torchrec_tpu_torch.inference import (
        BatchingPredictServer,
        NativePredictServer,
        PredictClient,
        make_dlrm_collate,
    )
    from torchrec_tpu_torch.sparse import PaddedSparseBatch

    B = Q_SERVER_BATCH
    collate = make_dlrm_collate(QUANT_KEYS, DEVICE)
    calls = {"n": 0}

    def py_predict(*args):
        calls["n"] += 1
        return logits_of(pm.predict(*args))

    lengths = torch.ones((NUM_TABLES, B), dtype=torch.int32, device=DEVICE)
    labels = torch.zeros((B,), device=DEVICE)

    def native_predict(dense, ids):
        # numpy buffers of the server's: pageable, so each copy has read
        # its source when .to() returns and the buffer may be refilled
        calls["n"] += 1
        sb = PaddedSparseBatch(ids=torch.from_numpy(ids).to(DEVICE),
                               lengths=lengths, keys=QUANT_KEYS)
        return pm.predict(torch.from_numpy(dense).to(DEVICE), sb, labels)

    def drive(submit) -> list:
        results = [None] * len(reqs)
        errors = []

        def client(k):
            try:
                for i in range(k, len(reqs), Q_CLIENTS):
                    results[i] = submit(reqs[i]).result(Q_TIMEOUT_S)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append((k, repr(e)))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(Q_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(Q_TIMEOUT_S)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"clients failed: {errors}")
        return results

    def window(name, fn):
        calls["n"] = 0
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        sec = time.perf_counter() - t0
        want = expected(Kq=NUM_TABLES * calls["n"])
        if counts() != want:
            raise AssertionError(f"{name}: launched {counts()} for "
                                 f"{calls['n']} predict calls")
        log(f"quant server {name}: {len(reqs)} requests in {sec:.3f} s, "
            f"{calls['n']} predict calls, launches {counts()}")
        return out, calls["n"]

    py = BatchingPredictServer(py_predict, collate, B,
                               n_examples=lambda r: r[0].shape[0],
                               max_latency_s=0.005)
    try:
        py_out, py_calls = window("python", lambda: drive(py.submit))
    finally:
        py.stop()
    nat = NativePredictServer(native_predict, B, DENSE_IN, NUM_TABLES, L,
                              max_latency_s=0.005, device=DEVICE)
    if nat._pipeline != (torch.device(DEVICE).type == "cuda"):
        raise AssertionError("the native server's pipeline is not on "
                             "exactly on a CUDA device")
    try:
        nat_out, nat_calls = window(
            "native", lambda: drive(lambda r: nat.submit(*r)))
        port = nat.serve_tcp(0)

        def tcp():
            cli = PredictClient(port, timeout_s=Q_TIMEOUT_S)
            try:
                return [cli.predict(*reqs[i]) for i in range(Q_TCP_REQUESTS)]
            finally:
                cli.close()

        tcp_out, tcp_calls = window("tcp", tcp)
    finally:
        t0 = time.perf_counter()
        nat.stop()
        stop_s = time.perf_counter() - t0
    if stop_s > Q_TIMEOUT_S or nat._exec.is_alive() or nat._drain.is_alive():
        raise AssertionError(f"native server stop() took {stop_s:.3f} s")
    # direct predicts, one request at a time through the same collate
    worst = 0.0
    for i, (dense, ids) in enumerate(reqs):
        n = dense.shape[0]
        want = logits_of(pm.predict(*collate([(dense, ids)], B)))[:n].cpu()
        got = torch.as_tensor(py_out[i])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        nat_i = torch.from_numpy(nat_out[i]).reshape(-1)
        torch.testing.assert_close(nat_i, got, rtol=1e-5, atol=1e-6)
        if i < Q_TCP_REQUESTS:
            torch.testing.assert_close(
                torch.from_numpy(np.array(tcp_out[i])).reshape(-1), got,
                rtol=1e-5,
                atol=1e-6)
        worst = max(worst, (got - want).abs().max().item(),
                    (nat_i - got).abs().max().item())
    log(f"quant servers: every result within rtol 1e-5 of a direct predict "
        f"(largest difference {worst:.3e}); native stop() {stop_s:.4f} s")
    return {"launches": NUM_TABLES * (py_calls + nat_calls + tcp_calls),
            "worst": worst, "stop_s": stop_s}


def quant_serving(ql, tl) -> dict:
    """The quantized serving phase: bench.py's DLRM trained, quantized to
    int8 and int4, packaged, loaded and served (see the module
    docstring). Returns Kq's numbers and its launches on the phase's
    paths, and the K1 / K3 launches of its training and f32 serving."""
    import shutil
    import tempfile

    from torchrec_tpu_torch.inference import (
        PredictModule,
        quantize_embeddings,
        shard_quantized,
    )
    from torchrec_tpu_torch.modules.embedding_configs import DataType
    from torchrec_tpu_torch.utils.native import build_native_lib

    t0 = time.perf_counter()
    build_native_lib("serving_queue.cpp", force=True)
    log(f"built csrc/serving_queue.cpp with g++ in "
        f"{time.perf_counter() - t0:.2f} s")
    requests = quant_requests(np.random.RandomState(SEED + 22))
    dmp = quant_train()
    trained_launches = counts()

    # the f32 server: the trained DMP alone on the card
    gc_cuda()
    f32 = quant_serve(dmp.make_eval_fn(), requests, "f32 server",
                      {"K1": 1})
    bounds = quant_bounds(dmp, requests)

    tmp = tempfile.mkdtemp(prefix="quant_pkg_")
    results, saved = {}, {}
    try:
        b256 = next(r for r in requests if r[0] == SERVE_BATCH)
        W = dmp.sharded_ebcs[TRAIN_KEY].strategies[0].weights[0]
        offs = np.repeat(np.arange(NUM_TABLES, dtype=np.int32) * ROWS,
                         BENCH_BATCH)
        path_ids = torch.from_numpy(
            (requests[0][2][:, :, 0].reshape(-1) + offs)[:, None]).to(DEVICE)
        for name, bits in QUANT_TYPES.items():
            pm = quantize_embeddings(dmp, DataType[name], DEVICE)
            pm.save(os.path.join(tmp, name))
            saved[name] = logits_of(pm.predict(*quant_args(*b256[1:]))).cpu()
            # the pooled values against the f32 ones, element by element
            qebc = pm._quant_ebcs[TRAIN_KEY]
            for r, bnd in zip((r for r in requests
                               if r[0] == SERVE_BATCH), bounds[name]):
                qv = qebc(quant_args(*r[1:])[1]).values
                over = ((qv - bnd["pooled"]).abs() - bnd["eps"]).max().item()
                if over > 0:
                    raise AssertionError(f"{name} pooled values beyond their "
                                         f"bound by {over:.3e}")
            sq = shard_quantized(pm)._sharded[TRAIN_KEY]
            results[name] = check_quant_kernel(ql, tl, sq, W, path_ids, name)
            del pm, sq, qebc
        results["cases_max_abs_err"] = check_quant_kernel_cases(ql)
        f32_bytes = 4 * NUM_TABLES * ROWS * DIM
        del dmp, W
        gc_cuda()

        served = {}
        for name, bits in QUANT_TYPES.items():
            scaffold = make_dmp("meta", train=True)
            path = os.path.join(tmp, name)
            pm = PredictModule.load(path, scaffold, DEVICE)
            got = logits_of(pm.predict(*quant_args(*b256[1:]))).cpu()
            if not torch.equal(got, saved[name]):
                raise AssertionError(f"{name}: the loaded package predicts "
                                     "otherwise than the saved module")
            gc_cuda()
            un = quant_serve(pm.predict, requests, f"{name} PredictModule",
                             {"Kq": NUM_TABLES})
            cpu = PredictModule.load(path, scaffold, "cpu")
            ref = logits_of(cpu.predict(*quant_args(*b256[1:], "cpu")))
            torch.testing.assert_close(un["logits"][REQUESTS_PER_BATCH], ref,
                                       rtol=1e-4, atol=1e-5)
            log(f"{name}: B={SERVE_BATCH} logits match the CPU run of the "
                f"package, max abs diff "
                f"{(un['logits'][REQUESTS_PER_BATCH] - ref).abs().max():.3e}")
            del cpu
            # distance from the f32 model, per example against its bound
            dist = []
            for i, bnd in zip(range(REQUESTS_PER_BATCH, len(requests)),
                              bounds[name]):
                d = (un["logits"][i] - f32["logits"][i]).abs()
                over = (d - Q_SLACK * bnd["logit"] - 1e-6).max().item()
                if over > 0:
                    raise AssertionError(f"{name}: logits beyond "
                                         f"{Q_SLACK} x their bound by {over}")
                dist.append((d.max().item(), bnd["logit"].max().item(),
                             (d / bnd["logit"]).max().item()))
            big = [(un["logits"][i] - f32["logits"][i]).abs().max().item()
                   for i in range(REQUESTS_PER_BATCH)]
            log(f"{name}: |logit - f32 logit| at B={SERVE_BATCH} (max, its "
                f"first-order bound's max, largest ratio) {dist}; at "
                f"B={BENCH_BATCH} max {big}")
            servers = (quant_servers(pm, quant_server_requests())
                       if name == "INT8" else None)
            spm = shard_quantized(pm)
            del pm
            gc_cuda()
            sh = quant_serve(spm.predict, requests,
                             f"{name} ShardedPredictModule",
                             {"Kq": 1})
            for a, b in zip(sh["logits"], un["logits"]):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name}: sharded and unsharded "
                                         "modules differ")
            log(f"{name}: sharded logits equal the unsharded ones bit for "
                f"bit")
            del spm
            table_bytes = NUM_TABLES * ROWS * (DIM * bits // 8 + 8)
            saving = f32_bytes - table_bytes
            for form, r in (("unsharded", un), ("sharded", sh)):
                below = f32["peak_bytes"] - r["peak_bytes"]
                log(f"{name}: {form} serving peak {r['peak_bytes']} B "
                    f"against the f32 server's {f32['peak_bytes']} B: "
                    f"{below} B below it, {100 * below / saving:.1f}% of "
                    f"the tables' saving {saving} B")
                if below < 0.9 * saving:
                    raise AssertionError(f"{name}: the {form} quantized "
                                         f"server saves {below} B of the "
                                         f"tables' {saving}")
            served[name] = {"unsharded": un, "sharded": sh,
                            "servers": servers, "distance": dist}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {"Kq": sum(s[k]["launches"]["Kq"] for s in served.values()
                          for k in ("unsharded", "sharded"))
                + served["INT8"]["servers"]["launches"],
                "K1": trained_launches["K1"] + f32["launches"]["K1"],
                "K3": trained_launches["K3"]}
    log(f"quant: launches on its paths {launches} (Kq: "
        f"{2 * len(requests)} PredictModule requests x {NUM_TABLES}, "
        f"{2 * len(requests)} sharded requests x 1 and the servers' "
        f"{served['INT8']['servers']['launches']}; K1 / K3 the "
        f"{Q_TRAIN_STEPS} steps and {len(requests)} f32 requests)")
    k = dict(results["INT8"])
    k["int4"] = results["INT4"]
    k["max_abs_err"] = max(results["INT8"]["max_abs_err"],
                           results["INT4"]["max_abs_err"],
                           results["cases_max_abs_err"])
    return {"launches": launches, "Kq": k,
            "peaks": {"f32": f32["peak_bytes"],
                      **{n: s["unsharded"]["peak_bytes"]
                         for n, s in served.items()}}}


def quant_server_requests() -> list:
    """The servers' ragged requests: 1..Q_MAX_EXAMPLES examples each."""
    rng = np.random.RandomState(SEED + 23)
    out = []
    for _ in range(Q_CLIENT_REQUESTS):
        n = int(rng.randint(1, Q_MAX_EXAMPLES + 1))
        out.append((rng.randn(n, DENSE_IN).astype(np.float32),
                    rng.randint(0, ROWS, size=(NUM_TABLES, n, L)).astype(
                        np.int32)))
    return out


# -- the flat strategies inside a process group -------------------------------

# bench.py's 26 tables under four strategies, four groups
MIXED_PLAN = (("DATA_PARALLEL",) * 7 + ("TABLE_WISE",) * 6
              + ("COLUMN_WISE",) * 7 + ("ROW_WISE",) * 6)
MIXED_STEPS = 3
# collective calls of one unweighted group per forward and per update
# (parallel/comm.py): the ids and lengths travel in one all_gather
GROUP_CALLS = {
    "DATA_PARALLEL": ({}, {"all_gather": 2}),
    "ROW_WISE": ({"all_gather": 1, "reduce_scatter": 1}, {"all_gather": 2}),
    "TABLE_WISE": ({"all_gather": 1, "all_to_all": 1},
                   {"all_gather": 1, "all_to_all": 1}),
    "COLUMN_WISE": ({"all_gather": 1, "all_to_all": 1},
                    {"all_gather": 1, "all_to_all": 1}),
}
# the sequence strategies of BERT4Rec's item table
SEQ_CALLS = {
    "DATA_PARALLEL": ({}, {"all_gather": 2}),
    "TABLE_WISE": ({"all_gather": 1, "all_to_all": 1},
                   {"all_gather": 1, "all_to_all": 1}),
    "TABLE_ROW_WISE": ({"all_gather": 1, "reduce_scatter": 1,
                        "all_to_all": 1},
                       {"all_gather": 2, "all_to_all": 1}),
}


def _add_calls(*parts: dict) -> dict:
    out: dict = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0) + v
    return out


def step_calls(groups) -> tuple:
    """(calls per request, calls per train step) of a DMP whose groups are
    sharded as `groups` (GROUP_CALLS or SEQ_CALLS entries): each group's
    forward per request; its forward and update, and the dense gradients'
    one all_reduce, per step."""
    return (_add_calls(*(g[0] for g in groups)),
            _add_calls(*(g[0] for g in groups), *(g[1] for g in groups),
                       {"all_reduce_mean": 1}))


def comm_calls() -> dict:
    """Calls per collective so far (`comm.<name>` in the registry)."""
    from torchrec_tpu_torch.utils import tracing

    return {k[len("comm."):]: v for k, v in tracing.counts().items()
            if k.startswith("comm.")}


def _moved(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


@contextlib.contextmanager
def process_group_of_one():
    """An env over a process group of one rank on the card: NCCL, its
    store a file in a temporary directory. Destroyed on leaving."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from torchrec_tpu_torch.parallel import ShardingEnv

    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(
            "nccl" if DEVICE == "cuda" else "gloo", store=store, rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            env = ShardingEnv.from_process_group(dist.group.WORLD, DEVICE)
            log(f"process group: {dist.get_backend()} of "
                f"{env.world_size} rank on {env.device}")
            yield env
        finally:
            dist.destroy_process_group()


def run_requests(dmp, requests, launches: dict, calls: dict, what: str,
                 logits_of=lambda out: out) -> dict:
    """Serve `requests`, (batch, arguments on the CPU) each, through
    make_eval_fn, each launching exactly `launches` and making exactly
    `calls`: the logits (`logits_of` the output, on the card) and the
    request times."""
    eval_fn = dmp.make_eval_fn()
    logits, ms = [], {}
    torch.cuda.synchronize()
    for batch, args in requests:
        before, c0 = counts(), comm_calls()
        t0 = time.perf_counter()
        out = logits_of(eval_fn(*(a.to(DEVICE) for a in args)))
        torch.cuda.synchronize()
        ms.setdefault(batch, []).append((time.perf_counter() - t0) * 1e3)
        launched, made = _moved(counts(), before), _moved(comm_calls(), c0)
        if launched != _moved(expected(**launches), expected()) or \
                made != calls:
            raise AssertionError(f"{what}: a B={batch} request launched "
                                 f"{launched} and made {made}, expected "
                                 f"{launches} and {calls}")
        if out.shape[0] != batch or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{what}: bad output at B={batch}")
        logits.append(out)
    return {"logits": logits, "ms": ms}


def run_steps(dmp, batches, launches: dict, calls: dict, what: str) -> dict:
    """Train steps on `batches`, each launching exactly `launches` and
    making exactly `calls`: losses and step times."""
    step = dmp.make_train_step()
    losses, ms = [], []
    torch.cuda.synchronize()
    for batch in batches:
        before, c0 = counts(), comm_calls()
        t0 = time.perf_counter()
        loss, _ = step(*batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launched, made = _moved(counts(), before), _moved(comm_calls(), c0)
        if launched != _moved(expected(**launches), expected()) or \
                made != calls:
            raise AssertionError(f"{what}: step {len(ms)} launched "
                                 f"{launched} and made {made}, expected "
                                 f"{launches} and {calls}")
        losses.append(loss.item())
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"{what}: step {len(ms)} loss {losses[-1]}")
    return {"losses": losses, "ms": ms}


def _snapshot(dmp, key: str) -> dict:
    """Tables (clones on the card), fused optimizer state and dense
    parameters of a trained DMP."""
    sebc = dmp.sharded_ebcs[key]
    return {"tables": {n: t.detach().clone()
                       for n, t in sebc.unshard_tables().items()},
            "opt": sebc.unshard_opt_to_tables(),
            "dense": {n: p.detach().clone()
                      for n, p in dmp.module.named_parameters()}}


def hold_trained(got: dict, ref: dict, touched: dict, what: str,
                 dense: bool = True,
                 ref_name: str = "the group-less ROW_WISE run") -> None:
    """Two runs' tables, optimizer state (and dense parameters) within
    rtol 1e-4 / atol 1e-5, the bound of the other train phases (the
    segment sum's atomics reorder additions); the rows no batch touched
    equal."""
    worst = 0.0
    for name, ref_t in ref["tables"].items():
        a, t = got["tables"][name], touched[name]
        torch.testing.assert_close(a[t], ref_t[t], rtol=1e-4, atol=1e-5)
        if not torch.equal(a[~t], ref_t[~t]):
            raise AssertionError(f"{what}: untouched rows of {name} differ")
        worst = max(worst, (a[t] - ref_t[t]).abs().max().item())
        for tag, v in ref["opt"][name].items():
            # COLUMN_WISE keeps JAX's [1, R] rowwise form at n = 1
            np.testing.assert_allclose(
                np.reshape(got["opt"][name][tag], np.shape(v)), v,
                rtol=1e-4, atol=1e-5, err_msg=f"{name} {tag}")
    if dense:
        for name, p in ref["dense"].items():
            torch.testing.assert_close(got["dense"][name], p, rtol=1e-4,
                                       atol=1e-5)
    log(f"{what}: tables ({sum(int(t.sum()) for t in touched.values())} "
        f"touched rows, max abs diff {worst:.3e}) and optimizer state"
        f"{' and dense parameters' if dense else ''} within rtol 1e-4 / "
        f"atol 1e-5 of {ref_name}; untouched rows equal")


def _dlrm_touched(batches) -> dict:
    """{table: [ROWS] bool} the batches' ids address (L=1)."""
    out = {f"t{i}": torch.zeros(ROWS, dtype=torch.bool, device=DEVICE)
           for i in range(NUM_TABLES)}
    for _, kjt, _ in batches:
        ids = kjt.values.reshape(NUM_TABLES, -1).long()
        for i in range(NUM_TABLES):
            out[f"t{i}"][ids[i]] = True
    return out


def probe_group_calls(sebc, kjt, lr: float) -> tuple:
    """Each group's collective calls for one forward and one update of a
    zero cotangent (a step of zero on SGD rows), by sharding type, and the
    kernel launches the probe made."""
    from torchrec_tpu_torch.modules.embedding_modules import as_padded

    sb = as_padded(kjt, sebc.max_feature_length)
    out, before = {}, counts()
    for gi, (strat, group) in enumerate(zip(sebc.strategies, sebc.groups)):
        sbg = sebc._group_batch(sb, gi)
        c0 = comm_calls()
        pooled = strat(sbg)
        c1 = comm_calls()
        with torch.no_grad():
            strat.update(sbg, torch.zeros_like(pooled), lr)
        out[group.sharding_type.name] = (_moved(c1, c0),
                                         _moved(comm_calls(), c1))
    return out, _moved(counts(), before)


def check_column_split(sebc, kjt) -> dict:
    """The DLRM's COLUMN_WISE group through the group-less path and through
    the group: the same [n, R, D/n] layout at n = 1, the same pooled
    values, bit for bit. The 4-rank split is the CPU tests' to check.
    Returns the kernel launches the check made."""
    from torchrec_tpu_torch.modules.embedding_modules import as_padded
    from torchrec_tpu_torch.parallel import ShardingEnv
    from torchrec_tpu_torch.parallel.strategies import (
        create_sharding_strategy,
    )

    gi = [g.sharding_type.name for g in sebc.groups].index("COLUMN_WISE")
    grouped = sebc.strategies[gi]
    plain = create_sharding_strategy(ShardingEnv(DEVICE), sebc.groups[gi],
                                     grouped.optim, grouped.optim_kwargs)
    plain.weights = plain.shard_from_dense(
        grouped.unshard_tensors(grouped.weights))
    if not (torch.equal(plain.weights, grouped.weights)
            and tuple(plain.weights.shape) == plain.local_shape()
            == (1, grouped.total_rows, DIM)):
        raise AssertionError("COLUMN_WISE layouts differ with and without "
                             "the group")
    sb = sebc._group_batch(as_padded(kjt, sebc.max_feature_length), gi)
    before = counts()
    a, b = plain(sb), grouped(sb)
    launched = _moved(counts(), before)
    if not torch.equal(a, b):
        raise AssertionError("COLUMN_WISE forwards differ with and without "
                             "the group")
    log(f"COLUMN_WISE group ({len(sebc.groups[gi].tables)} tables): layout "
        f"{tuple(grouped.weights.shape)} and pooled {tuple(a.shape)} equal "
        f"bit for bit with and without the group")
    return launched


def mixed_dlrm(env) -> dict:
    """bench.py's DLRM under MIXED_PLAN inside the group, against the
    group-less all-ROW_WISE DMP from the same seed: 3 + 3 requests (B=8192,
    B=256), 4 K1 launches each and logits equal bit for bit; MIXED_STEPS
    steps at B=8192 under EXACT_SGD and ROWWISE_ADAGRAD, 4 K1 and 4 K3 /
    4 fused K4 launches each, the trained state within the train phases'
    bound. One DMP on the card at a time."""
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType

    per_req, per_step = step_calls([GROUP_CALLS[t] for t in (
        "DATA_PARALLEL", "TABLE_WISE", "COLUMN_WISE", "ROW_WISE")])
    rng = np.random.RandomState(SEED + 40)
    requests = [(b, make_request(rng, b))
                for b in [BENCH_BATCH] * REQUESTS_PER_BATCH
                + [SERVE_BATCH] * REQUESTS_PER_BATCH]
    served = {}
    for tag, kw, k1, calls in (
            ("ROW_WISE", {}, 1, {}),
            ("mixed", {"env": env, "plan_types": MIXED_PLAN}, 4, per_req)):
        dmp = make_dmp(DEVICE, **kw).init(SEED)
        if tag == "mixed":
            groups = [g.sharding_type.name
                      for g in dmp.sharded_ebcs[MODULE_KEY].groups]
            if groups != ["DATA_PARALLEL", "TABLE_WISE", "COLUMN_WISE",
                          "ROW_WISE"]:
                raise AssertionError(f"mixed plan groups {groups}")
        served[tag] = run_requests(dmp, requests, {"K1": k1}, calls,
                                   f"mixed-plan phase, {tag} DLRM")
        del dmp
        gc_cuda()
    for a, b in zip(served["mixed"]["logits"], served["ROW_WISE"]["logits"]):
        if not torch.equal(a, b):
            raise AssertionError(
                "the mixed plan's logits differ from the ROW_WISE run's by "
                f"{(a - b).abs().max().item()}")
    for b in (BENCH_BATCH, SERVE_BATCH):
        log(f"mixed-plan DLRM serve B={b}: request ms (host clock, H2D + "
            f"forward, synchronized; first includes warm-up) "
            f"{served['mixed']['ms'][b]} beside the group-less ROW_WISE "
            f"run's {served['ROW_WISE']['ms'][b]}")
    log(f"mixed-plan DLRM: {len(requests)} requests, 4 K1 launches and "
        f"{per_req} collective calls each; logits equal the ROW_WISE run's "
        f"bit for bit")

    out = {"serve_ms": {t: r["ms"] for t, r in served.items()},
           "launches": {"K1": 5 * len(requests), "K3": 0, "K4": 0},
           "check_launches": {}}
    rng = np.random.RandomState(SEED + 41)
    batches = [to_device(make_batch(rng, BENCH_BATCH))
               for _ in range(MIXED_STEPS)]
    touched = _dlrm_touched(batches)
    for optim in (EmbOptimType.EXACT_SGD, EmbOptimType.ROWWISE_ADAGRAD):
        k = STEP_KERNELS[optim.name][0]
        runs = {}
        for tag, kw, n, calls in (
                ("ROW_WISE", {}, 1, {}),
                ("mixed", {"env": env, "plan_types": MIXED_PLAN}, 4,
                 per_step)):
            dmp = make_dmp(DEVICE, train=True, optim=optim, **kw).init(SEED)
            runs[tag] = run_steps(dmp, batches, {"K1": n, k: n}, calls,
                                  f"mixed-plan phase, {tag} {optim.name}")
            runs[tag].update(_snapshot(dmp, TRAIN_KEY))
            if tag == "mixed" and optim is EmbOptimType.EXACT_SGD:
                sebc = dmp.sharded_ebcs[TRAIN_KEY]
                probe, probed = probe_group_calls(sebc, batches[0][1],
                                                  FUSED_LR)
                if probe != GROUP_CALLS:
                    raise AssertionError(f"collective calls per group "
                                         f"{probe}, expected {GROUP_CALLS}")
                log(f"mixed-plan DLRM: collective calls per group (forward, "
                    f"update) {probe}")
                out["check_launches"] = _add_calls(
                    probed, check_column_split(sebc, batches[0][1]))
            del dmp
            gc_cuda()
        log(f"mixed-plan DLRM train {optim.name} B={BENCH_BATCH}: losses "
            f"{runs['mixed']['losses']} (ROW_WISE run "
            f"{runs['ROW_WISE']['losses']}); step ms (host clock, "
            f"synchronized, first includes warm-up) {runs['mixed']['ms']} "
            f"beside the ROW_WISE run's {runs['ROW_WISE']['ms']}; 4 K1 and "
            f"4 {k} launches and {per_step} collective calls per step")
        hold_trained(runs["mixed"], runs["ROW_WISE"], touched,
                     f"mixed-plan DLRM {optim.name}")
        out["launches"]["K1"] += 5 * MIXED_STEPS
        out["launches"][k] += 5 * MIXED_STEPS
        out[f"step_ms_{optim.name}"] = {t: r["ms"] for t, r in runs.items()}
        del runs
    return out


def mixed_b4r(env, seqs, strategies=("DATA_PARALLEL", "TABLE_WISE")) -> dict:
    """BERT4Rec's item table under `strategies` inside the group (default
    DATA_PARALLEL and TABLE_WISE) against the group-less ROW_WISE DMP from
    the same seed: 3 + 3 requests (B=32, B=1024), one routed gather each,
    logits equal (as values); MIXED_STEPS steps at B=32 under
    ROWWISE_ADAGRAD, one routed gather and one fused K4 each (and one
    route-only launch where the update routes), the trained state within
    the train phases' bound."""
    rng = np.random.RandomState(SEED + 42)
    requests = [(b, b4r_eval_batch(rng, seqs, b))
                for b in [B4R_BATCH] * REQUESTS_PER_BATCH
                + [B4R_RANK_BATCH] * REQUESTS_PER_BATCH]
    batches = [b4r_train_batch(rng, seqs, B4R_BATCH)
               for _ in range(MIXED_STEPS)]
    batches = [(kjt.to(DEVICE), labels.to(DEVICE)) for kjt, labels in batches]
    touched = torch.zeros(B4R_VOCAB, dtype=torch.bool, device=DEVICE)
    for kjt, _ in batches:
        touched[kjt.values.long()] = True
    runs, out = {}, {"launches": {"K8r": 0, "K4": 0, ROUTE: 0}}
    for st in ("ROW_WISE", *strategies):
        kw = {} if st == "ROW_WISE" else {"env": env, "sharding": st}
        per_req, per_step = ({}, {}) if st == "ROW_WISE" else \
            step_calls([SEQ_CALLS[st]])
        dmp = make_b4r_dmp(DEVICE, **kw).init(SEED)
        served = run_requests(dmp, requests, {"K8r": 1}, per_req,
                              f"BERT4Rec {st}", lambda out: out[1][1])
        route = {ROUTE: 1} if st in ("ROW_WISE", "TABLE_ROW_WISE") else {}
        trained = run_steps(dmp, batches, {"K8r": 1, "K4": 1, **route},
                            per_step, f"BERT4Rec {st}")
        runs[st] = {"logits": served["logits"], "serve_ms": served["ms"],
                    **trained, **_snapshot(dmp, B4R_KEY),
                    "grads": _b4r_dense(dmp)}
        out["launches"]["K8r"] += len(requests) + MIXED_STEPS
        out["launches"]["K4"] += MIXED_STEPS
        out["launches"][ROUTE] += MIXED_STEPS if route else 0
        del dmp
        gc_cuda()
        if st == "ROW_WISE":
            continue
        ref = runs["ROW_WISE"]
        for a, b in zip(runs[st]["logits"], ref["logits"]):
            # +0.0 and -0.0 are equal as values
            if not bool((a == b).all()):
                raise AssertionError(
                    f"BERT4Rec {st}: logits differ from the ROW_WISE run's "
                    f"by {(a - b).abs().max().item()}")
        hold_trained(runs[st], ref, {"item_embedding": touched},
                     f"BERT4Rec {st}", dense=False)
        hold_b4r_dense(runs[st]["grads"], ref["grads"], MIXED_STEPS,
                       f"BERT4Rec {st} and ROW_WISE")
        for b in (B4R_BATCH, B4R_RANK_BATCH):
            log(f"BERT4Rec {st} serve B={b}: request ms (host clock, H2D + "
                f"forward, synchronized; first includes warm-up) "
                f"{runs[st]['serve_ms'][b]} beside the ROW_WISE run's "
                f"{ref['serve_ms'][b]}")
        log(f"BERT4Rec {st}: logits equal the ROW_WISE run's; {per_req} "
            f"collective calls per request, {per_step} per step; train "
            f"B={B4R_BATCH} losses {runs[st]['losses']} (ROW_WISE "
            f"{ref['losses']}), step ms (host clock, synchronized) "
            f"{runs[st]['ms']} beside {ref['ms']}")
    out["step_ms"] = {st: r["ms"] for st, r in runs.items()}
    return out


def flat_strategies(seqs) -> dict:
    """Phase 16: bench.py's DLRM under a mixed plan and BERT4Rec under
    DATA_PARALLEL and TABLE_WISE, inside an NCCL process group of one
    rank, against the group-less ROW_WISE runs (see the module
    docstring). Returns the launches per kernel of the phase's requests
    and steps, read from the counters: set to 0 before the phase and read
    after it, less the launches of its checks, after checking that this
    equals the sum of every request's and step's asserted launches."""
    t0 = time.perf_counter()
    reset_counts()
    with process_group_of_one() as env:
        dlrm = mixed_dlrm(env)
        b4r = mixed_b4r(env, seqs)
    moved = {k: v for k, v in counts().items() if v}
    checks = dlrm["check_launches"]
    launches = {k: v - checks.get(k, 0) for k, v in moved.items()}
    want = _add_calls(dlrm["launches"], b4r["launches"])
    if {k: v for k, v in launches.items() if v} != \
            {k: v for k, v in want.items() if v}:
        raise AssertionError(
            f"flat-strategies phase: the counters moved {moved}, the checks "
            f"{checks}; the requests and steps asserted {want}")
    log(f"flat-strategies phase: {time.perf_counter() - t0:.2f} s; "
        f"launches {launches} (the counters), besides {checks} in its "
        f"checks")
    return launches


# -- the hierarchical strategies inside a process group -----------------------

# bench.py's 26 tables: two groups on host 0
HIER_PLAN = ("TABLE_ROW_WISE",) * 13 + ("TABLE_COLUMN_WISE",) * 13
HIER_PARAMS = {"input_routing": "a2a"}
# collective calls of one unweighted group under the a2a input dist, per
# forward and per update: the dist (an all_to_all over the cross-host
# group, an all_gather over the intra-host group) and the group's tail
HIER_DIST = {"all_to_all": 1, "all_gather": 1}
HIER_CALLS = {
    "TABLE_ROW_WISE": ({"all_to_all": 2, "all_gather": 1,
                        "reduce_scatter": 1},
                       {"all_to_all": 2, "all_gather": 2}),
    "TABLE_COLUMN_WISE": ({"all_to_all": 3, "all_gather": 1},
                          {"all_to_all": 3, "all_gather": 1}),
}
# the position-weighted DLRM inside the group: 25 ROW_WISE tables and one
# TABLE_WISE, per-sample weights travelling in calls of their own; the
# processor's backward runs the transposes of the forward's float
# collectives (reduce_scatter <- all_gather, all_gather <- reduce_scatter,
# all_to_all <- all_to_all)
PW_PLAN = ("ROW_WISE",) * (NUM_TABLES - 1) + ("TABLE_WISE",)
PW_GROUP_STEP_CALLS = {"all_gather": 10, "reduce_scatter": 3,
                       "all_to_all": 3, "all_reduce_mean": 1}


def _less(a: dict, b: dict) -> dict:
    return {k: v - b.get(k, 0) for k, v in a.items() if v - b.get(k, 0)}


def _pinned(batch):
    """A host batch with every tensor in pinned memory."""
    from torchrec_tpu_torch.parallel.train_pipeline import _map_tensors

    if DEVICE != "cuda":
        return batch
    return _map_tensors(batch, lambda t: t.pin_memory())


def run_driven(dmp, batches, launches: dict, calls: list, what: str,
               driver: str) -> dict:
    """Train steps on `batches` through the prefetched step (its dists
    primed before the first step) or SparseDistPipeline (host batches,
    primed inside its first step), step i launching exactly `launches` and
    making exactly calls[i]: losses and step times."""
    from torchrec_tpu_torch.parallel.train_pipeline import SparseDistPipeline

    if driver == "prefetched":
        step = dmp.make_prefetched_train_step()
        dists = [dmp.input_dist(batches[0][1])]

        def run(i):
            loss, _, dists[0] = step(
                dists[0], batches[min(i + 1, len(batches) - 1)][1],
                *batches[i])
            return loss
    else:
        pipe = SparseDistPipeline(dmp, device=DEVICE)
        it = iter(batches)

        def run(i):
            return pipe.progress(it)[0]
    losses, ms = [], []
    torch.cuda.synchronize()
    for i in range(len(batches)):
        before, c0 = counts(), comm_calls()
        t0 = time.perf_counter()
        loss = run(i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launched, made = _moved(counts(), before), _moved(comm_calls(), c0)
        if launched != _moved(expected(**launches), expected()) or \
                made != calls[i]:
            raise AssertionError(f"{what}: step {i + 1} launched {launched}"
                                 f" and made {made}, expected {launches} "
                                 f"and {calls[i]}")
        losses.append(loss.item())
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"{what}: step {i + 1} loss {losses[-1]}")
    return {"losses": losses, "ms": ms}


def hier_dlrm(env) -> dict:
    """bench.py's DLRM under HIER_PLAN inside the group against the
    group-less ROW_WISE DMP from the same seed (see the module
    docstring)."""
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType

    groups = [HIER_CALLS[t] for t in ("TABLE_ROW_WISE", "TABLE_COLUMN_WISE")]
    per_req, per_step = step_calls(groups)
    dists = _add_calls(HIER_DIST, HIER_DIST)
    prefetched_step = _less(per_step, dists)
    hier = {"env": env, "plan_types": HIER_PLAN, "fused_params": HIER_PARAMS}
    rng = np.random.RandomState(SEED + 50)
    requests = [(b, make_request(rng, b))
                for b in [BENCH_BATCH] * REQUESTS_PER_BATCH
                + [SERVE_BATCH] * REQUESTS_PER_BATCH]
    served = {}
    for tag, kw, k1, calls in (("ROW_WISE", {}, 1, {}),
                               ("hierarchical", hier, 2, per_req)):
        dmp = make_dmp(DEVICE, **kw).init(SEED)
        if tag != "ROW_WISE":
            strats = dmp.sharded_ebcs[MODULE_KEY].strategies
            got = [(type(s).__name__, s.input_routing, s.H, s.Lc)
                   for s in strats]
            if got != [("TwRwEmbeddingSharding", "a2a", 1, 1),
                       ("TwCwEmbeddingSharding", "a2a", 1, 1)]:
                raise AssertionError(f"hierarchical plan groups {got}")
        served[tag] = run_requests(dmp, requests, {"K1": k1}, calls,
                                   f"hierarchical phase, {tag} DLRM")
        del dmp
        gc_cuda()
    for a, b in zip(served["hierarchical"]["logits"],
                    served["ROW_WISE"]["logits"]):
        if not torch.equal(a, b):
            raise AssertionError(
                "the hierarchical plan's logits differ from the ROW_WISE "
                f"run's by {(a - b).abs().max().item()}")
    for b in (BENCH_BATCH, SERVE_BATCH):
        log(f"hierarchical DLRM serve B={b}: request ms (host clock, H2D + "
            f"forward, synchronized; first includes warm-up) "
            f"{served['hierarchical']['ms'][b]} beside the group-less "
            f"ROW_WISE run's {served['ROW_WISE']['ms'][b]}")
    log(f"hierarchical DLRM: {len(requests)} requests, 2 K1 launches and "
        f"{per_req} collective calls each; logits equal the ROW_WISE run's "
        f"bit for bit")
    out = {"launches": {"K1": 3 * len(requests), "K3": 0, "K4": 0},
           "serve_ms": {t: r["ms"] for t, r in served.items()}}
    rng = np.random.RandomState(SEED + 51)
    host = [make_batch(rng, BENCH_BATCH) for _ in range(MIXED_STEPS)]
    batches = [to_device(b) for b in host]
    touched = _dlrm_touched(batches)
    for optim in (EmbOptimType.EXACT_SGD, EmbOptimType.ROWWISE_ADAGRAD):
        k = STEP_KERNELS[optim.name][0]
        runs = {}
        for tag, kw, n in (("ROW_WISE", {}, 1), ("hierarchical", hier, 2)):
            dmp = make_dmp(DEVICE, train=True, optim=optim, **kw).init(SEED)
            runs[tag] = run_steps(dmp, batches, {"K1": n, k: n},
                                  per_step if n == 2 else {},
                                  f"hierarchical phase, {tag} {optim.name}")
            runs[tag].update(_snapshot(dmp, TRAIN_KEY))
            del dmp
            gc_cuda()
        hold_trained(runs["hierarchical"], runs["ROW_WISE"], touched,
                     f"hierarchical DLRM {optim.name}")
        out["launches"]["K1"] += 3 * MIXED_STEPS
        out["launches"][k] += 3 * MIXED_STEPS
        log(f"hierarchical DLRM train {optim.name} B={BENCH_BATCH}: losses "
            f"{runs['hierarchical']['losses']} (ROW_WISE run "
            f"{runs['ROW_WISE']['losses']}); step ms (host clock, "
            f"synchronized, first includes warm-up) "
            f"{runs['hierarchical']['ms']} beside the ROW_WISE run's "
            f"{runs['ROW_WISE']['ms']}; 2 K1 and 2 {k} launches and "
            f"{per_step} collective calls per step")
        out[f"step_ms_{optim.name}"] = {t: r["ms"] for t, r in runs.items()}
        if optim is not EmbOptimType.ROWWISE_ADAGRAD:
            continue
        # the same steps with each batch's dist made once, ahead
        # the pipeline primes the first batch's dist inside its first step
        for driver, data, first in (
                ("prefetched", batches, prefetched_step),
                ("pipeline", [_pinned(b) for b in host],
                 _add_calls(prefetched_step, dists))):
            dmp = make_dmp(DEVICE, train=True, optim=optim,
                           **hier).init(SEED)
            run = run_driven(dmp, data, {"K1": 2, k: 2},
                             [first] + [prefetched_step] * (len(data) - 1),
                             f"hierarchical phase, {driver}", driver)
            run.update(_snapshot(dmp, TRAIN_KEY))
            del dmp
            gc_cuda()
            hold_trained(run, runs["hierarchical"], touched,
                         f"hierarchical DLRM {driver} step",
                         ref_name="make_train_step's run")
            out["launches"]["K1"] += 2 * MIXED_STEPS
            out["launches"][k] += 2 * MIXED_STEPS
            log(f"hierarchical DLRM {driver} B={BENCH_BATCH}: losses "
                f"{run['losses']}; step ms (host clock, synchronized) "
                f"{run['ms']}; {prefetched_step} collective calls per step "
                f"(make_train_step's less {dists}, each group's dist made "
                f"once a step); first step {first}")
            out[f"step_ms_{driver}"] = run["ms"]
        del runs
    return out


def _pw_touched(batches) -> dict:
    """{table: [ROWS] bool} the position-weighted batches' ids address."""
    out = {f"t{i}": torch.zeros(ROWS, dtype=torch.bool, device=DEVICE)
           for i in range(NUM_TABLES)}
    for _, kjt, _ in batches:
        per = kjt.lengths.reshape(NUM_TABLES, -1).sum(1).tolist()
        for i, ids in enumerate(torch.split(kjt.values.long(), per)):
            out[f"t{i}"][ids] = True
    return out


def pw_group(env) -> dict:
    """The position-weighted DLRM under PW_PLAN inside the group against
    the group-less ROW_WISE run: MIXED_STEPS EXACT_SGD steps at B=8192, K1,
    K8 (d_coeff) and K3 once per group each; position weights, dense
    parameters and tables within the train phases' bound."""
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType

    rng = np.random.RandomState(SEED + 52)
    batches = [to_device(make_pw_batch(rng, BENCH_BATCH))
               for _ in range(MIXED_STEPS)]
    runs = {}
    for tag, kw, n, calls in (
            ("ROW_WISE", {}, 1, {}),
            ("grouped", {"env": env, "plan_types": PW_PLAN}, 2,
             PW_GROUP_STEP_CALLS)):
        dmp = make_dmp(DEVICE, train=True, optim=EmbOptimType.EXACT_SGD,
                       position_weighted=True, **kw).init(SEED)
        runs[tag] = run_steps(dmp, batches, {"K1": n, "K8": n, "K3": n},
                              calls, f"position-weighted phase 17, {tag}")
        runs[tag].update(_snapshot(dmp, TRAIN_KEY))
        # the last step's position-weight gradient: through the
        # collectives' transposes in the group
        runs[tag]["grad"] = _position_weights(dmp, grad=True)
        del dmp
        gc_cuda()
    hold_trained(runs["grouped"], runs["ROW_WISE"], _pw_touched(batches),
                 "position-weighted DLRM, ROW_WISE + TABLE_WISE in the group")
    g, ref = runs["grouped"]["grad"], runs["ROW_WISE"]["grad"]
    scale = ref.abs().max().item()
    if not (bool(torch.isfinite(g).all()) and scale > 0):
        raise AssertionError(f"position-weight gradient {scale}")
    # relative to the gradient's scale: its steps fall under an ulp of the
    # weights (ones), so the weights themselves may not move
    torch.testing.assert_close(g, ref, rtol=1e-4, atol=1e-4 * scale)
    log(f"position-weighted DLRM in the group B={BENCH_BATCH}: losses "
        f"{runs['grouped']['losses']} (group-less {runs['ROW_WISE']['losses']}"
        f"); step ms (host clock, synchronized) {runs['grouped']['ms']} "
        f"beside {runs['ROW_WISE']['ms']}; {PW_GROUP_STEP_CALLS} collective "
        f"calls per step; the last step's position-weight gradient (max "
        f"{scale:.3e}) within rtol 1e-4 / atol 1e-4 x its max of the "
        f"group-less run's, max abs diff {(g - ref).abs().max().item():.3e}")
    return {"launches": {"K1": 3 * MIXED_STEPS, "K8": 3 * MIXED_STEPS,
                         "K3": 3 * MIXED_STEPS}}


def quant_group() -> dict:
    """bench.py's DLRM at int8 through shard_quantized over
    ShardingEnv.from_local(1) (the group) with explicit table ranks,
    against phase 15's group-less sharded module: one Kq launch and one
    all_gather a request, logits bit for bit."""
    from torchrec_tpu_torch.inference import (
        quantize_embeddings,
        shard_quantized,
    )
    from torchrec_tpu_torch.modules.embedding_configs import DataType
    from torchrec_tpu_torch.parallel import ShardingEnv

    dmp = make_dmp(DEVICE, train=True).init(SEED)
    pm = quantize_embeddings(dmp, DataType.INT8, DEVICE)
    del dmp
    gc_cuda()
    env = ShardingEnv.from_local(1, DEVICE)
    ranks = {TRAIN_KEY: {f"t{i}": 0 for i in range(NUM_TABLES)}}
    modules = {"group-less": (shard_quantized(pm), {}),
               "from_local(1)": (shard_quantized(pm, env, ranks),
                                 {"all_gather": 1})}
    del pm
    requests = quant_requests(np.random.RandomState(SEED + 53))
    logits, ms = {}, {}
    for tag, (spm, calls) in modules.items():
        logits[tag], ms[tag] = [], {BENCH_BATCH: [], SERVE_BATCH: []}
        for batch, dense, ids in requests:
            before, c0 = counts(), comm_calls()
            t0 = time.perf_counter()
            out = logits_of(spm.predict(*quant_args(dense, ids)))
            torch.cuda.synchronize()
            ms[tag][batch].append((time.perf_counter() - t0) * 1e3)
            launched, made = _moved(counts(), before), _moved(comm_calls(),
                                                                c0)
            if launched != {"Kq": 1} or made != calls:
                raise AssertionError(f"quantized {tag}: a B={batch} request "
                                     f"launched {launched} and made {made}")
            logits[tag].append(out)
    for a, b in zip(logits["from_local(1)"], logits["group-less"]):
        if not torch.equal(a, b):
            raise AssertionError("the quantized module over from_local(1) "
                                 "differs from the group-less one")
    log(f"quantized int8 over from_local(1): {len(requests)} requests, 1 Kq "
        f"launch and 1 all_gather each, logits equal the group-less sharded "
        f"module's bit for bit; request ms (host clock, collate + H2D + "
        f"predict) {ms['from_local(1)']} beside {ms['group-less']}")
    return {"launches": {"Kq": 2 * len(requests)}}


def hierarchical(seqs) -> dict:
    """Phase 17: the hierarchical strategies, the prefetched step and its
    pipeline, the feature processor and quantized serving inside an NCCL
    process group of one rank (see the module docstring). Returns the
    launches per kernel of the phase's requests and steps, read from the
    counters (set to 0 before the phase), after checking that they equal
    the sum of every request's and step's asserted launches."""
    t0 = time.perf_counter()
    reset_counts()
    with process_group_of_one() as env:
        intra, cross = env.subgroups()
        if (env.local_size, env.num_hosts, intra.size(), cross.size()) != \
                (1, 1, 1, 1):
            raise AssertionError("the group's env is not one host of one "
                                 "rank with subgroups of one")
        dlrm = hier_dlrm(env)
        b4r = mixed_b4r(env, seqs, ("TABLE_ROW_WISE",))
        pw = pw_group(env)
        quant = quant_group()
    launches = {k: v for k, v in counts().items() if v}
    want = _add_calls(dlrm["launches"], b4r["launches"], pw["launches"],
                      quant["launches"])
    if launches != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"hierarchical phase: the counters moved "
                             f"{launches}; the requests and steps asserted "
                             f"{want}")
    log(f"hierarchical phase: {time.perf_counter() - t0:.2f} s; launches "
        f"{launches} (the counters)")
    return launches


# -- phase 18: the planner, embedding towers and variable batches -----------

TOWER_KEY = "etc"
TOWER_SPLIT = 13  # tower 0 takes features 0-12, tower 1 features 13-25
TOWER_LAYERS = (512, 256)  # bench.py's dense widths
# collective calls of the tower collection (both towers on rank 0) per
# request, and per step with the dense gradients' all_reduce; the update
# reuses the forward's pooled rows, so its ids all_gather is the forward's
TOWER_REQ_CALLS = {"all_gather": 1, "all_to_all": 1}
TOWER_STEP_CALLS = {"all_gather": 1, "all_to_all": 2, "all_reduce_sum": 1,
                    "all_reduce_mean": 1}
VB_REAL = 6000  # real rows of the variable batch, padded to BENCH_BATCH
PLAN_WORLDS = (1, 2, 4, 8)
# the planner's update cost is measured at one B=8192 and one B=1024
# batch of bench.py's 26 features
COST_BATCHES = (BENCH_BATCH, 1024)


def bench_tables():
    from torchrec_tpu_torch.modules import EmbeddingBagConfig

    return [EmbeddingBagConfig(num_embeddings=ROWS, embedding_dim=DIM,
                               name=f"t{i}", feature_names=[f"f{i}"])
            for i in range(NUM_TABLES)]


def plan_directly(tables, sharder, dependencies=None, world_size=1,
                  local=None, **topology):
    """The sharding planner as the DMP calls it for a module given no
    plan: (the planner, its plan, its wall time in s)."""
    from torchrec_tpu_torch.planner import (
        EmbeddingShardingPlanner,
        ParameterConstraints,
        Topology,
    )

    planner = EmbeddingShardingPlanner(
        Topology(world_size, local_world_size=local, **topology),
        constraints={t.name: ParameterConstraints(
            sharding_types=sharder.sharding_types(),
            dependency=(dependencies or {}).get(t.name)) for t in tables})
    t0 = time.perf_counter()
    plan = planner.plan(tables, module_path="m").plan["m"]
    return planner, plan, time.perf_counter() - t0


def log_plan(what: str, planner, seconds: float) -> None:
    """Each table's sharding type, kernel and ranks, and each shard's
    estimated time and device bytes."""
    log(f"{what}: planned in {seconds * 1e3:.3f} ms (host clock); "
        f"{planner.last_stats.splitlines()[0]}")
    for opt in planner.last_plan:
        log(f"  {opt.name}: {opt.sharding_type.name} "
            f"{opt.compute_kernel.name} ranks "
            f"{[s.rank for s in opt.shards]} perf "
            f"{[s.perf for s in opt.shards]} s hbm "
            f"{[s.storage.hbm for s in opt.shards]} B")


def bench_plans() -> None:
    """bench.py's tables planned on 1, 2, 4 and 8 cards (one host, the
    bench's global batch split over them) under the card's cost model, and
    under the same model with a whole-shard stream term (2 x the shard's
    bytes at the HBM rate) added to the update, as the JAX planner's
    scatter model has one."""
    import collections

    from torchrec_tpu_torch.parallel.sharders import (
        EmbeddingBagCollectionSharder,
    )
    from torchrec_tpu_torch.planner import constants as pc

    def streamed(rows, shard_bytes):
        return (pc.h100_update_s(rows, shard_bytes)
                + 2.0 * shard_bytes / pc.H100_SXM.hbm_bw)

    for tag, cost in (("card", pc.H100_COSTS), ("card + stream term",
                      dataclasses.replace(pc.H100_COSTS,
                                          update_s=streamed))):
        for n in PLAN_WORLDS:
            planner, plan, secs = plan_directly(
                bench_tables(), EmbeddingBagCollectionSharder(),
                world_size=n, local=min(n, 8),
                batch_size=BENCH_BATCH // n, cost_model=cost)
            kinds = collections.Counter(
                f"{p.sharding_type.name} {p.compute_kernel.name} ranks "
                f"{p.ranks}" for p in plan.values())
            log(f"bench.py's tables on {n} H100s ({tag}): {dict(kinds)}; "
                f"{planner.last_stats.splitlines()[0]}; "
                f"{secs * 1e3:.3f} ms")


def planned_dlrm() -> dict:
    """Phase 18 (a): bench.py's DLRM given no plan against the group-less
    ROW_WISE DMP from the same seed: 3 + 3 requests, 3 steps under
    EXACT_SGD and ROWWISE_ADAGRAD."""
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel.sharders import (
        EmbeddingBagCollectionSharder,
    )

    planner, want, secs = plan_directly(bench_tables(),
                                        EmbeddingBagCollectionSharder())
    log_plan("bench.py's DLRM on one H100, no plan given", planner, secs)
    rng = np.random.RandomState(SEED + 60)
    requests = [(b, make_batch(rng, b))
                for b in [BENCH_BATCH] * REQUESTS_PER_BATCH
                + [SERVE_BATCH] * REQUESTS_PER_BATCH]
    batches = [to_device(make_batch(rng, BENCH_BATCH))
               for _ in range(MIXED_STEPS)]
    touched = _dlrm_touched(batches)
    out = {"launches": {"K1": 0, "K1j": 0, "K3": 0, "K4": 0}}
    for optim in (EmbOptimType.EXACT_SGD, EmbOptimType.ROWWISE_ADAGRAD):
        k = STEP_KERNELS[optim.name][0]
        runs = {}
        # the planner's one DATA_PARALLEL group takes the batches'
        # KeyedJaggedTensors on the jagged route (K1j)
        for tag, types, lookup in (("ROW_WISE", None, "K1"),
                                   ("planned", "planned", "K1j")):
            dmp = make_dmp(DEVICE, train=True, optim=optim,
                           plan_types=types).init(SEED)
            if tag == "planned" and dmp.plan.plan[TRAIN_KEY] != want:
                raise AssertionError(f"the DMP's plan {dmp.plan} is not the "
                                     f"planner's {want}")
            runs[tag] = {}
            if optim is EmbOptimType.EXACT_SGD:
                runs[tag]["served"] = run_requests(
                    dmp, requests, {lookup: 1}, {},
                    f"planned phase, {tag} DLRM", logits_of)
                out["launches"][lookup] += len(requests)
            runs[tag].update(run_steps(dmp, batches, {lookup: 1, k: 1}, {},
                                       f"planned phase, {tag} {optim.name}"))
            runs[tag].update(_snapshot(dmp, TRAIN_KEY))
            out["launches"][lookup] += MIXED_STEPS
            out["launches"][k] += MIXED_STEPS
            del dmp
            gc_cuda()
        if optim is EmbOptimType.EXACT_SGD:
            same = [torch.equal(a, b) for a, b in zip(
                runs["planned"]["served"]["logits"],
                runs["ROW_WISE"]["served"]["logits"])]
            for a, b in zip(runs["planned"]["served"]["logits"],
                            runs["ROW_WISE"]["served"]["logits"]):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
            for b in (BENCH_BATCH, SERVE_BATCH):
                log(f"planned DLRM serve B={b}: request ms (host clock, H2D "
                    f"+ forward, synchronized; first includes warm-up) "
                    f"{runs['planned']['served']['ms'][b]} beside the "
                    f"ROW_WISE run's {runs['ROW_WISE']['served']['ms'][b]}")
            log(f"planned DLRM: logits within rtol 1e-4 / atol 1e-5 of the "
                f"ROW_WISE run's; bit for bit: {all(same)}")
            out["serve_ms"] = {t: r["served"]["ms"] for t, r in runs.items()}
        hold_trained(runs["planned"], runs["ROW_WISE"], touched,
                     f"planned DLRM {optim.name}")
        bitwise = all(torch.equal(runs["planned"]["tables"][t],
                                  runs["ROW_WISE"]["tables"][t])
                      for t in runs["ROW_WISE"]["tables"])
        log(f"planned DLRM train {optim.name} B={BENCH_BATCH}: losses "
            f"{runs['planned']['losses']} (ROW_WISE {runs['ROW_WISE']['losses']}"
            f"); step ms (host clock, synchronized, first includes warm-up) "
            f"{runs['planned']['ms']} beside the ROW_WISE run's "
            f"{runs['ROW_WISE']['ms']}; tables bit for bit: {bitwise}")
        out[f"step_ms_{optim.name}"] = {t: r["ms"] for t, r in runs.items()}
    return out


class TowerDLRM(torch.nn.Module):
    """tests/test_tower_dmp.py's TowerModel: the towers' outputs, a
    Dense(1) head and the mean BCE with logits; (loss, (loss, logits,
    labels)) as DLRMTrain."""

    def __init__(self, etc, head):
        super().__init__()
        self.etc = etc
        self.head = head

    def forward(self, sparse, labels):
        logits = self.head(self.etc(sparse))[:, 0]
        labels = labels.to(logits.dtype)
        loss = torch.mean(torch.clamp(logits, min=0) - logits * labels
                          + torch.log1p(torch.exp(-torch.abs(logits))))
        return loss, (loss, logits, labels)


def make_tower_dmp(device: str, optim, env=None):
    """bench.py's tables in two towers (features 0-12 and 13-25, L=1),
    each interaction an MLP 1,664 -> 512 -> 256, then TowerDLRM's head;
    no plan given."""
    from torchrec_tpu_torch.modules import MLP, Dense, EmbeddingBagCollection
    from torchrec_tpu_torch.modules.embedding_tower import (
        EmbeddingTower,
        EmbeddingTowerCollection,
    )
    from torchrec_tpu_torch.parallel import DistributedModelParallel

    tables = bench_tables()
    towers = [EmbeddingTower(
        EmbeddingBagCollection(tables[lo:hi], max_feature_length=L,
                               device="meta"),
        MLP((hi - lo) * DIM, TOWER_LAYERS, device="meta"))
        for lo, hi in ((0, TOWER_SPLIT), (TOWER_SPLIT, NUM_TABLES))]
    model = TowerDLRM(EmbeddingTowerCollection(towers),
                      Dense(2 * TOWER_LAYERS[-1], 1, device="meta"))
    return DistributedModelParallel(
        model, env=env, device=device, fused_optim=optim,
        fused_params={"learning_rate": FUSED_LR},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=DENSE_LR))


def tower_batch(rng: np.random.RandomState, batch: int):
    """(KeyedJaggedTensor of 26 features x B x 1, labels) on the CPU."""
    _, kjt, labels = make_batch(rng, batch)
    return kjt, labels


def _cpu(snapshot: dict) -> dict:
    return {"tables": {k: v.cpu() for k, v in snapshot["tables"].items()},
            "opt": snapshot["opt"],
            "dense": {k: v.cpu() for k, v in snapshot["dense"].items()}}


def tower_against_cpu(dmp, optim) -> int:
    """The tower DMP's state copied into a CPU DMP: one B=256 request and
    CPU_STEPS steps at B=256 on both within the bound of the other train
    phases. Returns the card's K1 launches."""
    cpu = make_tower_dmp("cpu", optim)
    cpu.load_state_dict(dmp.state_dict())
    rng = np.random.RandomState(SEED + 63)
    kjt, labels = tower_batch(rng, SERVE_BATCH)
    got = logits_of(dmp.make_eval_fn()(kjt.to(DEVICE), labels.to(DEVICE)))
    ref = logits_of(cpu.make_eval_fn()(kjt, labels))
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-5)
    batches = [tower_batch(rng, SERVE_BATCH) for _ in range(CPU_STEPS)]
    on_card = [(k.to(DEVICE), y.to(DEVICE)) for k, y in batches]
    gstep, cstep = dmp.make_train_step(), cpu.make_train_step()
    for (kc, yc), (kg, yg) in zip(batches, on_card):
        lc, lg = cstep(kc, yc)[0], gstep(kg, yg)[0]
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-5)
    touched = {f"t{i}": torch.zeros(ROWS, dtype=torch.bool)
               for i in range(NUM_TABLES)}
    for kjt, _ in batches:
        ids = kjt.values.reshape(NUM_TABLES, -1).long()
        for i in range(NUM_TABLES):
            touched[f"t{i}"][ids[i]] = True
    hold_trained(_cpu(_snapshot(dmp, TOWER_KEY)), _snapshot(cpu, TOWER_KEY),
                 touched, f"tower DLRM {optim.name} card against the CPU",
                 ref_name="the CPU run")
    log(f"tower DLRM: a B={SERVE_BATCH} request's logits and {CPU_STEPS} "
        f"steps at B={SERVE_BATCH} equal a CPU copy's within rtol 1e-4 / "
        f"atol 1e-5")
    return 1 + CPU_STEPS


def tower_dlrm(env) -> dict:
    """Phase 18 (b): the tower DLRM given no plan, group-less and inside
    the group of one rank."""
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel.sharders import (
        EmbeddingTowerCollectionSharder,
    )

    tables = bench_tables()
    deps = {t.name: f"tower_{int(i >= TOWER_SPLIT)}"
            for i, t in enumerate(tables)}
    planner, want, secs = plan_directly(
        tables, EmbeddingTowerCollectionSharder(), deps)
    log_plan("the tower DLRM on one H100, no plan given", planner, secs)
    rng = np.random.RandomState(SEED + 61)
    requests = [(b, tower_batch(rng, b))
                for b in [BENCH_BATCH] * REQUESTS_PER_BATCH
                + [SERVE_BATCH] * REQUESTS_PER_BATCH]
    batches = [tuple(t.to(DEVICE) for t in tower_batch(rng, BENCH_BATCH))
               for _ in range(MIXED_STEPS)]
    touched = _dlrm_touched([(None, k, y) for k, y in batches])
    out = {"launches": {"K1": 0, "K3": 0, "K4": 0}}
    for optim in (EmbOptimType.EXACT_SGD, EmbOptimType.ROWWISE_ADAGRAD):
        k = STEP_KERNELS[optim.name][0]
        runs = {}
        for tag, e, req_calls, step_calls_ in (
                ("group-less", None, {}, {}),
                ("group", env, TOWER_REQ_CALLS, TOWER_STEP_CALLS)):
            dmp = make_tower_dmp(DEVICE, optim, e).init(SEED)
            if dmp.plan.plan[TOWER_KEY] != want:
                raise AssertionError(f"the tower DMP's plan {dmp.plan} is "
                                     f"not the planner's {want}")
            tc = dmp.sharded_ebcs[TOWER_KEY]
            if tag == "group-less" and optim is EmbOptimType.EXACT_SGD:
                log(f"tower DLRM: its tables' block {tuple(tc.weights.shape)}"
                    f" f32, {tc.weights.numel() * 4} B on the card")
            runs[tag] = {}
            if optim is EmbOptimType.EXACT_SGD:
                runs[tag]["served"] = run_requests(
                    dmp, requests, {"K1": 1}, req_calls,
                    f"tower phase, {tag}", logits_of)
                out["launches"]["K1"] += len(requests)
            runs[tag].update(run_steps(dmp, batches, {"K1": 1, k: 1},
                                       step_calls_,
                                       f"tower phase, {tag} {optim.name}"))
            runs[tag].update(_snapshot(dmp, TOWER_KEY))
            out["launches"]["K1"] += MIXED_STEPS
            out["launches"][k] += MIXED_STEPS
            if tag == "group-less" and optim is EmbOptimType.EXACT_SGD:
                n = tower_against_cpu(dmp, optim)
                out["launches"]["K1"] += n
                out["launches"][k] += CPU_STEPS
            del dmp
            gc_cuda()
        if optim is EmbOptimType.EXACT_SGD:
            for a, b in zip(runs["group"]["served"]["logits"],
                            runs["group-less"]["served"]["logits"]):
                if not torch.equal(a, b):
                    raise AssertionError(
                        "the tower DLRM's logits in the group differ from "
                        f"the group-less run's by {(a - b).abs().max()}")
            for b in (BENCH_BATCH, SERVE_BATCH):
                log(f"tower DLRM serve B={b}: request ms (host clock, H2D + "
                    f"forward, synchronized; first includes warm-up) "
                    f"group-less {runs['group-less']['served']['ms'][b]}, in "
                    f"the group {runs['group']['served']['ms'][b]}")
            log(f"tower DLRM: {len(requests)} requests, 1 K1 launch and "
                f"{TOWER_REQ_CALLS} collective calls each in the group; "
                f"logits equal the group-less run's bit for bit")
            out["serve_ms"] = {t: r["served"]["ms"] for t, r in runs.items()}
        hold_trained(runs["group"], runs["group-less"], touched,
                     f"tower DLRM {optim.name} in the group",
                     ref_name="the group-less run")
        bitwise = all(torch.equal(runs["group"]["tables"][t],
                                  runs["group-less"]["tables"][t])
                      for t in runs["group"]["tables"])
        log(f"tower DLRM train {optim.name} B={BENCH_BATCH}: losses "
            f"{runs['group-less']['losses']} (group {runs['group']['losses']}"
            f"); step ms (host clock, synchronized, first includes warm-up) "
            f"group-less {runs['group-less']['ms']}, in the group "
            f"{runs['group']['ms']}; 1 K1 and 1 {k} a step, "
            f"{TOWER_STEP_CALLS} collective calls a step in the group; "
            f"tables bit for bit: {bitwise}")
        out[f"step_ms_{optim.name}"] = {t: r["ms"] for t, r in runs.items()}
    return out


class MaskedDLRM(torch.nn.Module):
    """bench.py's DLRM under masked_bce_with_logits: the variable-batch
    loss."""

    def __init__(self, dlrm):
        super().__init__()
        self.dlrm = dlrm

    def forward(self, dense, sparse, labels, example_mask):
        from torchrec_tpu_torch.parallel.variable_batch import (
            masked_bce_with_logits,
        )

        logits = self.dlrm(dense, sparse).squeeze(-1)
        loss = masked_bce_with_logits(logits, labels, example_mask)
        return loss, (loss, logits, labels)


@contextlib.contextmanager
def returning(module, name: str, seen: dict):
    """While open, `module.name` keeps the value of its last call in
    seen[name]."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        seen[name] = orig(*args, **kwargs)
        return seen[name]

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, orig)


def variable_batch_step() -> dict:
    """Phase 18 (c): the planned DLRM under MaskedDLRM, one EXACT_SGD step
    on a VariableBatch of VB_REAL rows padded to BENCH_BATCH against one
    on the VB_REAL rows alone."""
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel.variable_batch import VariableBatch

    rng = np.random.RandomState(SEED + 62)
    dense, kjt, labels = make_batch(rng, VB_REAL)
    vb = VariableBatch.from_ragged([kjt.to_padded(L)], [dense], [labels],
                                   batch_size=BENCH_BATCH, device=DEVICE)
    if (int(vb.example_mask.sum()), vb.example_mask.shape[0]) != (
            VB_REAL, BENCH_BATCH):
        raise AssertionError("the variable batch's mask")
    runs = {}
    # the padded batch takes K1, the 6,000 rows' KeyedJaggedTensor the
    # planned DATA_PARALLEL group's jagged route (K1j)
    for tag, lookup, args in (
            ("padded", "K1", (vb.dense, vb.sparse, vb.labels,
                              vb.example_mask)),
            ("unpadded", "K1j", (dense.to(DEVICE), kjt.to(DEVICE),
                                 labels.to(DEVICE),
                                 torch.ones(VB_REAL, device=DEVICE)))):
        dmp = make_dmp(DEVICE, train=True, optim=EmbOptimType.EXACT_SGD,
                       plan_types="planned", wrap=MaskedDLRM).init(SEED)
        sebc, seen = dmp.sharded_ebcs[TRAIN_KEY], {}
        with returning(sebc, "forward", seen), \
                capturing(sebc, "update", seen):
            runs[tag] = run_steps(dmp, [args], {lookup: 1, "K3": 1}, {},
                                  f"variable batch, {tag}")
        runs[tag].update(_snapshot(dmp, TRAIN_KEY))
        runs[tag]["pooled"] = seen["forward"].values
        runs[tag]["d_pooled"] = seen["update"][1]
        del dmp
        gc_cuda()
    pad = runs["padded"]
    if pad["pooled"][VB_REAL:].abs().max().item() != 0.0:
        raise AssertionError("a pad row pooled to something")
    if pad["d_pooled"][VB_REAL:].abs().max().item() != 0.0:
        raise AssertionError("a pad row's pooled values took a gradient")
    np.testing.assert_allclose(pad["losses"], runs["unpadded"]["losses"],
                               rtol=1e-4, atol=1e-5)
    touched = _dlrm_touched([(None, kjt.to(DEVICE), None)])
    hold_trained(pad, runs["unpadded"], touched,
                 f"variable batch ({VB_REAL} rows padded to {BENCH_BATCH})",
                 ref_name=f"the {VB_REAL}-row step")
    log(f"variable batch: loss {pad['losses']} against "
        f"{runs['unpadded']['losses']} unpadded; the {BENCH_BATCH - VB_REAL} "
        f"pad rows pool to zeros and their pooled values' gradient is "
        f"exactly 0; step ms {pad['ms']} (padded), "
        f"{runs['unpadded']['ms']} (unpadded)")
    return {"launches": {"K1": 1, "K1j": 1, "K3": 2}}


def planned_quant(env) -> dict:
    """Phase 18 (d): shard_quantized over `ShardingEnv.from_local(1)`
    inside the group without table_ranks (the planner's placement) against
    the explicit placement: one Kq and one all_gather a request, logits
    bit for bit."""
    from torchrec_tpu_torch.inference import (
        quantize_embeddings,
        shard_quantized,
    )
    from torchrec_tpu_torch.modules.embedding_configs import DataType
    from torchrec_tpu_torch.parallel import ShardingEnv

    dmp = make_dmp(DEVICE, train=True).init(SEED)
    pm = quantize_embeddings(dmp, DataType.INT8, DEVICE)
    del dmp
    gc_cuda()
    local = ShardingEnv.from_local(1, DEVICE)
    ranks = {TRAIN_KEY: {f"t{i}": 0 for i in range(NUM_TABLES)}}
    modules = {"explicit": shard_quantized(pm, local, ranks),
               "planned": shard_quantized(pm, local)}
    del pm
    planned = {k: dict(m.table_ranks)
               for k, m in modules["planned"]._sharded.items()}
    if planned != ranks:
        raise AssertionError(f"the planned placement {planned}")
    requests = quant_requests(np.random.RandomState(SEED + 64))
    logits = {}
    for tag, spm in modules.items():
        logits[tag] = []
        for batch, dense, ids in requests:
            before, c0 = counts(), comm_calls()
            out = logits_of(spm.predict(*quant_args(dense, ids)))
            torch.cuda.synchronize()
            launched, made = _moved(counts(), before), _moved(comm_calls(),
                                                                c0)
            if launched != {"Kq": 1} or made != {"all_gather": 1}:
                raise AssertionError(f"planned quantized {tag}: a B={batch} "
                                     f"request launched {launched} and made "
                                     f"{made}")
            logits[tag].append(out)
    for a, b in zip(logits["planned"], logits["explicit"]):
        if not torch.equal(a, b):
            raise AssertionError("the planned quantized placement's logits "
                                 "differ from the explicit one's")
    log(f"planned quantized int8 over from_local(1): every table on rank 0 "
        f"as planned; {len(requests)} requests, 1 Kq and 1 all_gather each, "
        f"logits equal the explicit placement's bit for bit")
    return {"launches": {"Kq": 2 * len(requests)}}


def measure_costs() -> dict:
    """The H100 costs of the planner's cost model (planner/constants.py),
    re-measured on bench.py's packed tables (the planned DLRM's
    DATA_PARALLEL group, 2,600,064 x 128): K1's device time per slot over
    one B=8192 batch, and the whole of apply_fused_update (sort, segment
    sum and kernel) under ROWWISE_ADAGRAD and EXACT_SGD at COST_BATCHES:
    its device time (torch.profiler, every kernel of the call) at the two
    sizes gives a cost per row, and its host time per call at the smaller
    one the fixed cost each call adds. Printed only."""
    from torchrec_tpu_torch.ops.embedding import pooled_lookup
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        apply_fused_update,
        init_fused_optimizer_state,
    )

    dmp = make_dmp(DEVICE, train=True, plan_types="planned").init(SEED)
    (strat,) = dmp.sharded_ebcs[TRAIN_KEY].strategies
    W = strat.weights
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 65)
    offsets = torch.arange(NUM_TABLES, device=DEVICE, dtype=torch.int32) \
        * ROWS
    out, dev, host = {}, {}, {}
    for b in COST_BATCHES:
        ids = (torch.randint(0, ROWS, (NUM_TABLES, b, L), generator=gen,
                             device=DEVICE, dtype=torch.int32)
               + offsets[:, None, None])
        n = ids.numel()
        if b == BENCH_BATCH:
            coeff = torch.ones(ids.shape, device=DEVICE)
            ms = device_ms(lambda: pooled_lookup(W, ids, coeff))
            out["lookup_ns_per_slot"] = ms * 1e6 / n
            log(f"planner costs: K1 over {n} slots {ms:.5f} ms (device), "
                f"{out['lookup_ns_per_slot']:.5f} ns a slot")
        grads = torch.randn((n, DIM), generator=gen, device=DEVICE) * 1e-3
        valid = torch.ones(n, dtype=torch.bool, device=DEVICE)
        flat = ids.reshape(-1)
        for optim in (EmbOptimType.ROWWISE_ADAGRAD, EmbOptimType.EXACT_SGD):
            opt = init_fused_optimizer_state(W.shape[0], DIM, optim,
                                             device=DEVICE)

            def update():
                apply_fused_update(W, opt, flat, grads, valid, FUSED_LR)

            dev[optim.name, n] = device_ms(update)
            host[optim.name, n] = host_ms(update, iters=50)
    n1, n2 = sorted({k[1] for k in dev}, reverse=True)
    for optim in ("ROWWISE_ADAGRAD", "EXACT_SGD"):
        per_row = (dev[optim, n1] - dev[optim, n2]) / (n1 - n2) * 1e6
        out[optim] = {"device_ms": {n1: dev[optim, n1], n2: dev[optim, n2]},
                      "host_ms": {n1: host[optim, n1], n2: host[optim, n2]},
                      "ns_per_row": per_row,
                      "fixed_s": host[optim, n2] * 1e-3}
        log(f"planner costs: apply_fused_update {optim}: device "
            f"{dev[optim, n1]:.5f} ms at {n1} slots, {dev[optim, n2]:.5f} "
            f"ms at {n2}: {per_row:.5f} ns a row (device); host "
            f"{host[optim, n1]:.5f} / {host[optim, n2]:.5f} ms a call")
    del dmp, W
    gc_cuda()
    return out


def planner_towers() -> dict:
    """Phase 18: the planner, embedding towers, a variable batch and the
    planned quantized placement (see the module docstring). Returns the
    launches per kernel of the phase's requests and steps, read from the
    counters (set to 0 before them), after checking that they equal the
    sum of every request's and step's asserted launches."""
    t0 = time.perf_counter()
    bench_plans()
    reset_counts()
    planned = planned_dlrm()
    vb = variable_batch_step()
    with process_group_of_one() as env:
        towers = tower_dlrm(env)
        quant = planned_quant(env)
    launches = {k: v for k, v in counts().items() if v}
    want = _add_calls(planned["launches"], vb["launches"],
                      towers["launches"], quant["launches"])
    if launches != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"planner phase: the counters moved {launches};"
                             f" the requests and steps asserted {want}")
    log(f"planner phase: {time.perf_counter() - t0:.2f} s; launches "
        f"{launches} (the counters)")
    measure_costs()
    return launches


# -- phase 19: host-resident (UVM) tables and reshardable checkpoints -------

# the reference's MLPerf DLRM (bench_config.MLPERF_CARDINALITIES, copied):
# 26 tables at D=128, 97.36 GiB of fp32
MLPERF_CARDINALITIES = (
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
    40000000, 40000000, 590152, 12973, 108, 36,
)
MLPERF_BIG = 40_000_000  # its five largest tables go to host memory
MLPERF_REQUESTS, MLPERF_WARMUP, MLPERF_STEPS = 3, 1, 5
UVM_SAMPLE = 100_000  # untouched rows checked a table after a step
# host memory a UVM table row takes beyond its weights: the momentum and
# the directory (slot_of int32), and a cache slot's (row_in_slot and
# last_use int64, dirty bool) at a cache of 0.2 R
UVM_ROW_EXTRA = 4 + 4 + 0.2 * 17
UVM_HOST_MARGIN = 1.25  # MemAvailable over the UVM part's bytes
UVM_BENCH_SPLIT = 13  # bench.py's tables 13-25 in host memory
UVM_BENCH_REQUESTS, UVM_BENCH_STEPS, UVM_CKPT_STEPS = 3, 10, 2
UVM_RTOL = 1e-6


def mem_available() -> int:
    """/proc/meminfo's MemAvailable, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def make_uvm_dmp(rows, uvm: set, optim, device=None):
    """DLRMTrain over tables of `rows` x DIM (bench.py's dense arches), the
    tables in `uvm` FUSED_UVM_CACHING (TABLE_WISE on rank 0, in host
    memory), the others ROW_WISE on the card."""
    from torchrec_tpu_torch.models import DLRM, DLRMTrain
    from torchrec_tpu_torch.modules import (
        EmbeddingBagCollection,
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.parallel import (
        ComputeKernel,
        DistributedModelParallel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )

    tables = [EmbeddingBagConfig(num_embeddings=int(r), embedding_dim=DIM,
                                 name=f"t{i}", feature_names=[f"f{i}"])
              for i, r in enumerate(rows)]
    model = DLRMTrain(DLRM(EmbeddingBagCollection(
        tables, max_feature_length=L, device="meta"), DENSE_IN, DENSE_ARCH,
        OVER_ARCH, device="meta"))
    plan = ShardingPlan({TRAIN_KEY: {t.name: (ParameterSharding(
        ShardingType.TABLE_WISE, ranks=[0],
        compute_kernel=ComputeKernel.FUSED_UVM_CACHING) if i in uvm
        else ParameterSharding(ShardingType.ROW_WISE))
        for i, t in enumerate(tables)}})
    return DistributedModelParallel(
        model, plan=plan, device=device or DEVICE, fused_optim=optim,
        fused_params={"learning_rate": FUSED_LR},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=DENSE_LR))


def uvm_batch(rng: np.random.RandomState, rows, batch: int):
    """(dense, KeyedJaggedTensor, labels) on the CPU, one id per feature,
    uniform over each table's rows."""
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    ids = np.concatenate([rng.randint(0, r, size=batch)
                          for r in rows]).astype(np.int32)
    kjt = KeyedJaggedTensor.from_lengths(
        [f"f{i}" for i in range(len(rows))], ids,
        np.ones(len(rows) * batch, np.int32))
    dense = rng.randn(batch, DENSE_IN).astype(np.float32)
    labels = rng.randint(0, 2, size=batch).astype(np.float32)
    return torch.from_numpy(dense), kjt, torch.from_numpy(labels)


class Ops:
    """Runs the phase's operations, each with its launches read from the
    counters and held to a prediction where one is given; `total` sums
    them."""

    def __init__(self):
        self.total: dict = {}

    def __call__(self, what: str, fn, want: dict = None):
        before = counts()
        t0 = time.perf_counter()
        out = fn()
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = _moved(counts(), before)
        if want is not None and got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{what}: launched {got}, predicted {want}")
        self.total = _add_calls(self.total, got)
        return out, ms, got


def uvm_split(dmp):
    return dmp.sharded_ebcs[TRAIN_KEY]


def watch_uvm(dmp, seen: dict) -> None:
    """Record the UVM collection's last forward values and ids and the
    last cotangent its update took."""
    coll = uvm_split(dmp).uvm
    fwd, upd = coll.forward, coll.update

    def forward(sb, host=None):
        out = fwd(sb, host)
        seen["values"], seen["ids"] = out.values, host[0]
        return out

    def update(sb, d_values, lr, host=None):
        seen["d"], seen["update_ids"] = d_values.cpu(), host[0]
        return upd(sb, d_values, lr, host)

    coll.forward, coll.update = forward, update


def check_uvm_serving(dmp, seen: dict) -> None:
    """The UVM columns of the last request equal the host rows of its ids
    (a flush first: there is nothing dirty to write while serving)."""
    coll = uvm_split(dmp).uvm
    coll.flush()
    vals = seen["values"].cpu()
    for j, t in enumerate(coll.tables):
        host = coll._uvm[t.name].table
        want = host[torch.from_numpy(seen["ids"][j, :, 0]).long()]
        got = vals[:, j * DIM:(j + 1) * DIM]
        if not torch.equal(got, want):
            raise AssertionError(f"UVM table {t.name}: pooled values differ "
                                 f"from its host rows by "
                                 f"{(got - want).abs().max().item():.3e}")
    log(f"uvm serving: the {len(coll.tables)} UVM tables' pooled values "
        "equal their host rows bit for bit")


def uvm_rows_before(dmp, ids: np.ndarray, seed: int) -> dict:
    """Copies of each UVM table's rows (and momentum) the step's `ids`
    touch, and of UVM_SAMPLE seeded rows it does not, after a flush."""
    coll = uvm_split(dmp).uvm
    coll.flush()
    rng = np.random.RandomState(seed)
    out = {}
    for j, t in enumerate(coll.tables):
        c = coll._uvm[t.name]
        touched = np.unique(ids[j])
        sample = rng.randint(0, c.R, size=UVM_SAMPLE)
        sample = np.setdiff1d(sample, touched)
        out[t.name] = {
            "touched": touched, "sample": sample,
            "rows": c.table[torch.from_numpy(touched).long()].clone(),
            "m1": None if c.host_momentum1 is None else
            c.host_momentum1[torch.from_numpy(touched).long()].clone(),
            "sample_rows": c.table[torch.from_numpy(sample).long()].clone(),
            "step": int(c.step)}
    return out


def check_uvm_step(dmp, before: dict, seen: dict, optim) -> float:
    """After one step: each UVM table's touched rows and momenta equal the
    plain apply_fused_update on the CPU over the copies taken before it,
    with the step's cotangent (rtol UVM_RTOL, and UVM_RTOL of the tensor's
    scale near zero); the sampled untouched rows
    are unchanged. Returns the largest difference."""
    from torchrec_tpu_torch.ops.fused_update import (
        FusedOptimizerState,
        apply_fused_update,
    )

    coll = uvm_split(dmp).uvm
    coll.flush()
    worst = 0.0
    for j, t in enumerate(coll.tables):
        b, c = before[t.name], coll._uvm[t.name]
        ids = seen["update_ids"][j].reshape(-1)
        slot = torch.from_numpy(np.searchsorted(b["touched"], ids)
                                .astype(np.int32))
        w, m1 = b["rows"].clone(), None if b["m1"] is None else b["m1"].clone()
        apply_fused_update(
            w, FusedOptimizerState(
                momentum1=m1, momentum2=None,
                step=torch.tensor(b["step"], dtype=torch.int32), optim=optim),
            slot, seen["d"][:, j * DIM:(j + 1) * DIM].contiguous(),
            torch.ones(len(ids), dtype=torch.bool), dmp.learning_rate)
        idx = torch.from_numpy(b["touched"]).long()
        # rtol UVM_RTOL of each tensor's scale: near zero an element's own
        # scale is below an ulp of the row's (the init bound for rows)
        torch.testing.assert_close(c.table[idx], w, rtol=UVM_RTOL,
                                   atol=UVM_RTOL * t.get_weight_init_max())
        worst = max(worst, (c.table[idx] - w).abs().max().item())
        if m1 is not None:
            torch.testing.assert_close(
                c.host_momentum1[idx], m1, rtol=UVM_RTOL,
                atol=UVM_RTOL * m1.abs().max().item())
            worst = max(worst, (c.host_momentum1[idx] - m1).abs().max().item())
        if not torch.equal(c.table[torch.from_numpy(b["sample"]).long()],
                           b["sample_rows"]):
            raise AssertionError(f"UVM table {t.name}: an untouched row moved")
    return worst


def mlperf_rows() -> tuple:
    """MLPERF_CARDINALITIES, the big tables cut evenly where the host
    cannot hold UVM_HOST_MARGIN times their bytes (with their momenta and
    directories), and the reason."""
    avail = mem_available()
    n_big = MLPERF_CARDINALITIES.count(MLPERF_BIG)
    per_row = DIM * 4 + UVM_ROW_EXTRA
    need = n_big * MLPERF_BIG * per_row
    rows = MLPERF_BIG
    reason = None
    if UVM_HOST_MARGIN * need > avail:
        rows = int(avail / UVM_HOST_MARGIN / (n_big * per_row))
        reason = (f"reduced: MemAvailable {avail} B < {UVM_HOST_MARGIN} x "
                  f"{need:.0f} B of the {n_big} host tables at "
                  f"{MLPERF_BIG} rows, so each keeps {rows} rows")
    log(f"mlperf: MemAvailable {avail} B; host tables {n_big} x {rows} rows "
        f"x {DIM} ({n_big * rows * DIM * 4} B of weights); "
        f"{reason or 'full size'}")
    return tuple(rows if r == MLPERF_BIG else r
                 for r in MLPERF_CARDINALITIES), reason


def mlperf_dlrm(ops: Ops, optim, rows) -> None:
    """The MLPerf DLRM with its big tables in host memory: built (host
    tables allocated and pinned), drawn (1 GiB chunks from the card),
    served and trained, every request and step's launches predicted and
    the UVM rows checked against plain versions."""
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        fused_state_shapes,
    )

    uvm = {i for i, r in enumerate(MLPERF_CARDINALITIES) if r == MLPERF_BIG}
    n_uvm = len(uvm)
    upd = STEP_KERNELS[optim.name][0]
    moms = sum(k != "none" for k in fused_state_shapes(optim))
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dmp = make_uvm_dmp(rows, uvm, optim)
    pin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dmp.init(SEED)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    coll = uvm_split(dmp).uvm
    log(f"mlperf {optim.name}: DMP built (host tables allocated and pinned) "
        f"in {pin_s:.2f} s, drawn (1 GiB chunks from the card) in "
        f"{fill_s:.2f} s; caches "
        f"{[c.C for c in coll._uvm.values()]} rows")
    seen: dict = {}
    watch_uvm(dmp, seen)
    rng = np.random.RandomState(SEED + 19)
    eval_fn = dmp.make_eval_fn()
    per_request = expected(K1=1 + n_uvm, K2=n_uvm)
    req_ms = []
    for _ in range(MLPERF_REQUESTS):
        dense, kjt, labels = uvm_batch(rng, rows, BENCH_BATCH)
        (loss, (_, logits, _)), ms, _ = ops(
            "mlperf request", lambda: eval_fn(dense.to(DEVICE),
                                              kjt.to(DEVICE),
                                              labels.to(DEVICE)),
            per_request)
        if logits.shape != (BENCH_BATCH,) or not torch.isfinite(
                logits).all():
            raise AssertionError("mlperf: bad logits")
        req_ms.append(ms)
    check_uvm_serving(dmp, seen)
    step = dmp.make_train_step()
    per_step = expected(K1=1 + n_uvm, K2=n_uvm, **{upd: 1 + n_uvm})
    flush = expected(K8=n_uvm * (1 + moms))
    step_ms, worst = [], 0.0
    for s in range(MLPERF_WARMUP + MLPERF_STEPS):
        batch = [x.to(DEVICE) for x in uvm_batch(rng, rows, BENCH_BATCH)]
        check = s == MLPERF_WARMUP
        if check:
            host_ids = batch[1].to_padded(L).ids.cpu().numpy()[sorted(uvm)]
            before, _, _ = ops("mlperf flush", lambda: uvm_rows_before(
                dmp, host_ids, SEED + s), flush if s else None)
        (loss, _), ms, _ = ops("mlperf step", lambda: step(*batch), per_step)
        if not torch.isfinite(loss):
            raise AssertionError("mlperf: non-finite loss")
        step_ms.append(ms)
        if check:
            worst, _, _ = ops("mlperf flush", lambda: check_uvm_step(
                dmp, before, seen, optim), flush)
    stats = coll.cache_stats()
    peak = torch.cuda.max_memory_allocated()
    table_bytes = sum(r * DIM * 4 for r in rows)
    host_bytes = sum(rows[i] * DIM * 4 for i in uvm)
    card = torch.cuda.get_device_properties(0).total_memory
    for c in coll._uvm.values():  # no row was ever evicted
        if c._next_free >= c.C:
            raise AssertionError("mlperf: a cache filled up")
    log(f"mlperf {optim.name}: request ms (host clock, first includes "
        f"warm-up) {req_ms}; step ms {step_ms}; cache_stats {stats}; "
        f"max_memory_allocated {peak} B beside {table_bytes} B of tables "
        f"({host_bytes} B in host memory) and the card's {card} B; the "
        f"checked step's UVM rows within {worst:.3e} of the plain update "
        f"on the CPU, {UVM_SAMPLE} sampled untouched rows a table "
        f"unchanged")
    del dmp, coll, eval_fn, step
    gc_cuda()


class CacheReplay:
    """The caches' directories replayed on the CPU (D=4 host tables of
    zeros, the same ids): their cache_stats, and the K2 and K8 launches
    the card's prepares and flushes make (one K2 a prepare that misses,
    one K8 for the rows and one a momentum a write-back of dirty rows)."""

    def __init__(self, coll, moms: int):
        from torchrec_tpu_torch.ops.fused_update import EmbOptimType
        from torchrec_tpu_torch.ops.uvm_cache import UvmCachedEmbedding

        self.moms = moms
        self.k2 = self.k8 = 0
        self.caches = []
        for t in coll.tables:
            c = UvmCachedEmbedding(np.zeros((t.num_embeddings, 4), np.float32),
                                   coll._uvm[t.name].C,
                                   optim=EmbOptimType.EXACT_SGD,
                                   device="cpu")
            stage, back = c._stage_rows, c._sync_back

            def staged(rows, slots, stage=stage):
                self.k2 += 1
                stage(rows, slots)

            def synced(slots, back=back):
                self.k8 += 1 + self.moms
                back(slots)

            c._stage_rows, c._sync_back = staged, synced
            self.caches.append(c)

    def launches(self, fn) -> dict:
        k2, k8 = self.k2, self.k8
        fn()
        return {"K2": self.k2 - k2, "K8": self.k8 - k8}

    def prepare(self, ids: np.ndarray, update: bool = False) -> dict:
        """A forward's prepare (and with `update`, the update's prepare
        and dirty marks) of the UVM features' ids [T, B, L]."""
        def run():
            for c, x in zip(self.caches, ids):
                slots = c.prepare(x)
                if update:
                    slots = c.prepare(x)
                    c.dirty[np.unique(slots)] = True
        return self.launches(run)

    def flush(self) -> dict:
        return self.launches(lambda: [c.flush() for c in self.caches])

    def stats(self) -> dict:
        return {f"t{UVM_BENCH_SPLIT + j}": {"hits": c.hits,
                                            "misses": c.misses}
                for j, c in enumerate(self.caches)}


def bench_uvm(ops: Ops, optim, tmp: str) -> None:
    """bench.py's DLRM with tables 13-25 in host memory (20,000-row caches)
    beside the all-device ROW_WISE DMP with the same weights: requests and
    steps against it, the cache stats and the K2 / K8 launches against a
    replay of the directories; then (ROWWISE_ADAGRAD) the reshardable
    checkpoint loaded into the all-device and the planned plans and 2 more
    steps each, and the exact resume."""
    from torchrec_tpu_torch.ops.fused_update import fused_state_shapes
    from torchrec_tpu_torch.parallel.uvm_ebc import (
        UvmSplitEmbeddingBagCollection,
    )
    from torchrec_tpu_torch.utils.checkpoint import (
        load_dense,
        load_reshardable,
        restore_state,
        save_reshardable,
        save_state,
    )
    from torchrec_tpu_torch.utils.jax_bridge import fused_optimizer_state

    rows = (ROWS,) * NUM_TABLES
    uvm = set(range(UVM_BENCH_SPLIT, NUM_TABLES))
    n_uvm = len(uvm)
    upd = STEP_KERNELS[optim.name][0]
    moms = sum(k != "none" for k in fused_state_shapes(optim))
    dmp = make_uvm_dmp(rows, uvm, optim).init(SEED)
    ref = make_dmp(DEVICE, train=True, optim=optim)
    sd = dmp.unsharded_state_dict()
    load_dense(ref, {k: v.numpy() for k, v in sd["dense"].items()})
    ref.load_tables({TRAIN_KEY: sd[f"embeddings/{TRAIN_KEY}"]})
    replay = CacheReplay(uvm_split(dmp).uvm, moms)
    rng = np.random.RandomState(SEED + 190)

    def uvm_ids(kjt):
        return kjt.to_padded(L).ids.cpu().numpy()[sorted(uvm)]

    req_ms = []
    for _ in range(UVM_BENCH_REQUESTS):
        dense, kjt, labels = [x.to(DEVICE) for x in
                              uvm_batch(rng, rows, BENCH_BATCH)]
        want = expected(K1=1 + n_uvm, **replay.prepare(uvm_ids(kjt)))
        (_, (_, logits, _)), ms, _ = ops(
            "bench uvm request",
            lambda: dmp.make_eval_fn()(dense, kjt, labels), want)
        (_, (_, ref_logits, _)), _, _ = ops(
            "bench request", lambda: ref.make_eval_fn()(dense, kjt, labels),
            expected(K1=1))
        if not torch.equal(logits, ref_logits):
            raise AssertionError("bench uvm: logits differ from the "
                                 "all-device run's")
        req_ms.append(ms)
    log(f"bench uvm {optim.name}: {UVM_BENCH_REQUESTS} requests at "
        f"B={BENCH_BATCH}, logits equal the all-device run's bit for bit; "
        f"request ms {req_ms}")

    def steps(batches, dmps, what, replay=None):
        """Each batch's step on each DMP: [(losses, ms)] a batch. With a
        replay, the launches of every step are predicted: the UVM DMP's
        from the replay's directories, the all-device DMPs' lookup (K1, or
        K1j on the planner's DATA_PARALLEL group) and the update once."""
        out = []
        fns = [d.make_train_step() for d in dmps]
        for batch in batches:
            losses, times = [], []
            for d, fn in zip(dmps, fns):
                want = None
                if replay is not None and isinstance(
                        uvm_split(d), UvmSplitEmbeddingBagCollection):
                    want = expected(K1=1 + n_uvm, **{upd: 1 + n_uvm},
                                    **replay.prepare(uvm_ids(batch[1]), True))
                elif replay is not None:
                    want = expected(**kjt_lookups(d, TRAIN_KEY), **{upd: 1})
                (loss, _), ms, _ = ops(what, lambda: fn(*batch), want)
                losses.append(loss)
                times.append(ms)
            out.append((losses, times))
        return out

    def batches(n):
        return [[x.to(DEVICE) for x in uvm_batch(rng, rows, BENCH_BATCH)]
                for _ in range(n)]

    def held(a, b, what) -> float:
        sa, sb = a.unsharded_state_dict(), b.unsharded_state_dict()
        worst = 0.0
        for name, w in sa[f"embeddings/{TRAIN_KEY}"].items():
            wb = sb[f"embeddings/{TRAIN_KEY}"][name]
            np.testing.assert_allclose(w, wb, rtol=UVM_RTOL, atol=1e-12,
                                       err_msg=f"{what} {name}")
            worst = max(worst, float(np.abs(w - wb).max()))
        oa, ob = fused_optimizer_state(a), fused_optimizer_state(b)
        for name, entry in oa.items():
            for tag, v in entry.items():
                np.testing.assert_allclose(v, ob[name][tag], rtol=UVM_RTOL,
                                           atol=1e-12,
                                           err_msg=f"{what} {name} {tag}")
                worst = max(worst, float(np.abs(v - ob[name][tag]).max()))
        return worst

    ran = steps(batches(UVM_BENCH_STEPS), [dmp, ref], "bench uvm step",
                replay)
    for s, (losses, _) in enumerate(ran):
        torch.testing.assert_close(losses[0], losses[1], rtol=UVM_RTOL,
                                   atol=0)
    bitwise = all(torch.equal(*ls) for ls, _ in ran)
    ops("bench uvm flush", lambda: uvm_split(dmp).uvm.flush(),
        expected(**replay.flush()))
    worst = held(dmp, ref, "bench uvm against the all-device run")
    if uvm_split(dmp).cache_stats() != replay.stats():
        raise AssertionError(f"cache_stats {uvm_split(dmp).cache_stats()} "
                             f"differ from the replay's {replay.stats()}")
    log(f"bench uvm {optim.name}: {UVM_BENCH_STEPS} steps, losses equal the "
        f"all-device run's {'bit for bit' if bitwise else 'within rtol'}, "
        f"tables and momenta within {worst:.3e}; step ms "
        f"{[t[0] for _, t in ran]} (all-device {[t[1] for _, t in ran]}); "
        f"cache_stats {uvm_split(dmp).cache_stats()} equal the CPU replay's")
    del ref
    if optim.name != "ROWWISE_ADAGRAD":
        del dmp
        gc_cuda()
        return

    # the reshardable checkpoint into the all-device and the planned plans
    path = os.path.join(tmp, "uvm_dlrm.npz")
    _, save_ms, _ = ops("save_reshardable", lambda: save_reshardable(
        path, dmp), expected(**replay.flush()))
    loaded = {}
    for what, types in (("all-device ROW_WISE", None),
                        ("planned", "planned")):
        d = make_dmp(DEVICE, train=True, optim=optim, plan_types=types)
        d.init(SEED + 1)
        _, load_ms, _ = ops(f"load_reshardable ({what})",
                            lambda: load_reshardable(path, d))
        loaded[what] = (d, load_ms)
    planned = loaded["planned"][0].plan.plan[TRAIN_KEY]
    log(f"checkpoint: {os.path.getsize(path)} B written in {save_ms:.1f} ms,"
        f" loaded in {[round(v[1], 1) for v in loaded.values()]} ms; the "
        f"planned plan is "
        f"{sorted({p.sharding_type.name for p in planned.values()})}")
    ran = steps(batches(UVM_CKPT_STEPS),
                [dmp, *[d for d, _ in loaded.values()]], "checkpoint step",
                replay)
    for losses, _ in ran:
        for other in losses[1:]:
            torch.testing.assert_close(other, losses[0], rtol=UVM_RTOL,
                                       atol=0)
    ops("bench uvm flush", lambda: uvm_split(dmp).uvm.flush(),
        expected(**replay.flush()))
    ck_worst = max(held(dmp, d, f"checkpoint into {what}")
                   for what, (d, _) in loaded.items())
    log(f"checkpoint: {UVM_CKPT_STEPS} steps on each plan equal the saved "
        f"DMP's within {ck_worst:.3e} (losses rtol {UVM_RTOL})")
    del loaded

    # the exact resume
    spath = os.path.join(tmp, "uvm_dlrm.pt")
    _, ssave_ms, _ = ops("save_state", lambda: save_state(spath, dmp))
    resume = batches(UVM_CKPT_STEPS)
    golden = steps(resume, [dmp], "resume step")
    again = make_uvm_dmp(rows, uvm, optim).init(SEED + 2)
    _, sload_ms, _ = ops("restore_state", lambda: restore_state(spath,
                                                                again))
    # the restored caches start cold, so their K2 / K8 differ: the
    # launches are counted, not predicted
    resumed = steps(resume, [again], "resume step")
    if not all(torch.equal(g[0][0], r[0][0])
               for g, r in zip(golden, resumed)):
        raise AssertionError("restore_state: the resumed losses differ")
    (sa, sb), _, _ = ops("flush (resume)", lambda: (
        dmp.unsharded_state_dict(), again.unsharded_state_dict()))
    for name, w in sa[f"embeddings/{TRAIN_KEY}"].items():
        if not np.array_equal(w, sb[f"embeddings/{TRAIN_KEY}"][name]):
            raise AssertionError(f"restore_state: table {name} differs")
    log(f"exact resume: {os.path.getsize(spath)} B saved in {ssave_ms:.1f} "
        f"ms, restored in {sload_ms:.1f} ms; {UVM_CKPT_STEPS} steps equal "
        "the uninterrupted run's bit for bit")
    del dmp, again
    gc_cuda()


def uvm_phase() -> dict:
    """Phase 19 (see the module docstring). Returns the launches per
    kernel of the phase, read from the counters (set to 0 before it),
    after checking that they equal the sum of its operations'."""
    import tempfile

    from torchrec_tpu_torch.ops.fused_update import EmbOptimType

    t0 = time.perf_counter()
    reset_counts()
    ops = Ops()
    rows, reason = mlperf_rows()
    for optim in (EmbOptimType.ROWWISE_ADAGRAD, EmbOptimType.EXACT_SGD):
        mlperf_dlrm(ops, optim, rows)
    t1 = time.perf_counter()
    # the runs held to each other take deterministic segment sums and
    # scatters: with atomics, duplicate ids' sums round apart, and from the
    # second step a ReLU within rounding of zero flips and moves a row far
    # (measured on one H100: 810 rows of t0 up to 8.1e-3 apart after
    # 10 ROWWISE_ADAGRAD steps, the losses within 1e-6)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for optim in (EmbOptimType.ROWWISE_ADAGRAD,
                          EmbOptimType.EXACT_SGD):
                bench_uvm(ops, optim, tmp)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    launches = {k: v for k, v in counts().items() if v}
    if launches != {k: v for k, v in ops.total.items() if v}:
        raise AssertionError(f"uvm phase: the counters moved {launches}; "
                             f"its operations {ops.total}")
    log(f"uvm phase: {time.perf_counter() - t0:.2f} s (mlperf "
        f"{t1 - t0:.2f} s{', ' + reason if reason else ''}); launches "
        f"{launches} (the counters)")
    return launches


# -- phase 20: the port's examples on the card --------------------------------

# the examples' DLRM (their defaults: D=64, dense 13 -> 512-256-64, over
# 512-512-256-1, ROWWISE_ADAGRAD at lr 1.0, dense SGD at 0.1) over the 26
# Criteo Kaggle tables uncapped: --max_ind_range at the largest table
# leaves every cardinality as published, 33,762,577 rows
EX_MAX_IND = 10_131_227
EX_TSV_LINES = 100_000
EX_DAYS = 3
EX_DAY_BATCHES = 49  # 3 days x 49 x 8,192 = 1,204,224 rows
EX_SYNTH_STEPS = 50
# enough requests and steps that a p99 is not the maximum: 500 requests
# give it five samples above it (a few seconds a route at 2-10 ms each)
EX_REQUESTS = 500
EX_B4R_STEPS = 200
EX_D = 64  # the examples' --embedding_dim default
# phase 20's bound of the card's train step against the plain update on
# the CPU (of each tensor's scale near zero): the duplicate rows' gradient
# sums add in another order
EX_RTOL = 1e-5
EX_SAMPLE = 4096  # untouched rows checked, as many again past 2^31
EX_PAST = 2**31  # the block's element the held step must read beyond


def row_sample(rows: int, D: int, rng) -> np.ndarray:
    """EX_SAMPLE rows of a [rows, D] table drawn from `rng`, and as many
    again past element EX_PAST where the table reaches it: rows a hold
    reads beside those an update touches, so that a write to a wrong row
    (a row offset past 2^31 elements above all) shows."""
    draws = [rng.randint(0, rows, EX_SAMPLE)]
    if EX_PAST // D < rows:
        draws.append(rng.randint(EX_PAST // D, rows, EX_SAMPLE))
    return np.concatenate(draws)


def ex_cards() -> tuple:
    """The Kaggle cardinalities capped at EX_MAX_IND (--max_ind_range)."""
    from torchrec_tpu_torch.datasets.synthetic_criteo import (
        CRITEO_KAGGLE_CARDINALITIES,
    )

    return tuple(min(c, EX_MAX_IND) for c in CRITEO_KAGGLE_CARDINALITIES)


def write_criteo_tsv(path: str, lines: int, seed: int) -> None:
    """A Criteo-format TSV from seeded numpy: a label, 13 ints in
    [-2, 5000) (one in ten empty) and 26 32-bit hex ids (one in twenty
    empty), tab-separated."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, lines).astype(str)[:, None]
    ints = np.where(rng.rand(lines, 13) < 0.1, "",
                    rng.randint(-2, 5000, (lines, 13)).astype(str))
    cats = np.where(rng.rand(lines, 26) < 0.05, "",
                    np.char.mod("%08x", rng.randint(0, 2**32, (lines, 26),
                                                    dtype=np.int64)))
    rows = np.concatenate([labels, ints, cats], 1).tolist()
    with open(path, "w") as f:
        f.write("\n".join("\t".join(r) for r in rows) + "\n")


def example_files(tmp: str) -> dict:
    """Step 1: a 100,000-line TSV parsed by the native parser and its
    plain version (equal arrays, both rates), both preproc CLIs run on
    it, and 1.2 M rows of SyntheticCriteoDataset host batches (the Kaggle
    cardinalities, the ground truth's labels) written as three day_*
    npy triples. Returns the days' directory and the rates."""
    from torchrec_tpu_torch.datasets import criteo
    from torchrec_tpu_torch.datasets.scripts import (
        contiguous_preproc_criteo,
        npy_preproc_criteo,
    )
    from torchrec_tpu_torch.datasets.synthetic_criteo import (
        SyntheticCriteoDataset,
    )

    out = {}
    raw, npy, contig, days = (os.path.join(tmp, d) for d in
                              ("raw", "npy", "contig", "days"))
    for d in (raw, npy, days):
        os.makedirs(d)
    tsv = os.path.join(raw, "day_0")
    t0 = time.perf_counter()
    write_criteo_tsv(tsv, EX_TSV_LINES, SEED + 50)
    t1 = time.perf_counter()
    criteo._native_parser()  # the g++ build, outside the timed parse
    t2 = time.perf_counter()
    native = criteo.parse_criteo_tsv(tsv)
    t3 = time.perf_counter()
    plain = criteo._parse_tsv_numpy(tsv)
    t4 = time.perf_counter()
    for a, b in zip(native, plain):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError("the native parser and its plain version "
                                 "disagree")
    out["parse_lines_per_s"] = {"native": EX_TSV_LINES / (t3 - t2),
                                "numpy": EX_TSV_LINES / (t4 - t3)}
    log(f"examples: wrote a {EX_TSV_LINES}-line Criteo TSV in "
        f"{t1 - t0:.3f} s ({os.path.getsize(tsv)} B); g++ build of the "
        f"parser {t2 - t1:.3f} s; parsed natively in {t3 - t2:.4f} s, by "
        f"its plain version in {t4 - t3:.3f} s, equal arrays; lines/s "
        f"(host clock) {out['parse_lines_per_s']}")
    npy_preproc_criteo.main(["--input_dir", raw, "--output_dir", npy])
    t5 = time.perf_counter()
    contiguous_preproc_criteo.main(["--input_dir", npy, "--output_dir",
                                    contig, "--frequency_threshold", "3"])
    t6 = time.perf_counter()
    ids = np.load(os.path.join(contig, "day_0_sparse_contig_freq.npy"))
    if ids.shape != (EX_TSV_LINES, 26) or ids.min() < 1:
        raise AssertionError(f"contiguous ids {ids.shape} min {ids.min()}")
    log(f"examples: npy_preproc_criteo {t5 - t4:.3f} s, "
        f"contiguous_preproc_criteo {t6 - t5:.3f} s ({ids.max()} the "
        f"largest contiguous id)")
    ds = SyntheticCriteoDataset(batch_size=BENCH_BATCH,
                                cardinalities=ex_cards(),
                                num_batches=EX_DAYS * EX_DAY_BATCHES,
                                manual_seed=SEED + 51)
    it = iter(ds)
    for d in range(EX_DAYS):
        part = [next(it) for _ in range(EX_DAY_BATCHES)]
        np.save(os.path.join(days, f"day_{d}_dense.npy"), np.concatenate(
            [b.dense_features.numpy() for b in part]))
        np.save(os.path.join(days, f"day_{d}_sparse.npy"), np.concatenate(
            [b.sparse_features.ids[:, :, 0].numpy().T for b in part]))
        np.save(os.path.join(days, f"day_{d}_labels.npy"), np.concatenate(
            [b.labels.numpy() for b in part]).astype(np.int32)[:, None])
    log(f"examples: {EX_DAYS} days of {EX_DAY_BATCHES * BENCH_BATCH} "
        f"SyntheticCriteoDataset rows written in "
        f"{time.perf_counter() - t6:.3f} s")
    out["days"] = days
    return out


def loader_rates(days: str) -> dict:
    """The in-memory loader over the days at B=8192: batches/s through the
    C++ stager into pinned tensors (which it must give), and through the
    numpy route, host clock, one pass each in turns (stager, numpy,
    stager, numpy: the first pass also fills the pinned allocator's
    cache)."""
    from torchrec_tpu_torch.datasets import criteo

    paths = [sorted(os.path.join(days, f) for f in os.listdir(days)
                    if f.endswith(f"_{k}.npy"))
             for k in ("dense", "sparse", "labels")]
    pipe = criteo.InMemoryBinaryCriteoIterDataPipe(
        *paths, batch_size=BENCH_BATCH, hashes=ex_cards(),
        pin_memory=DEVICE == "cuda")
    criteo._native_stager()  # the g++ build, outside the timed pass
    rates: dict = {"native": [], "numpy": []}
    native_route = pipe.native_route
    for route in ("native", "numpy", "native", "numpy"):
        pipe.native_route = (native_route if route == "native"
                             else lambda: False)
        n, t0 = 0, time.perf_counter()
        for b in pipe:
            n += 1
            pinned = DEVICE != "cuda" or all(
                t.is_pinned() for t in (b.dense_features, b.labels,
                                        b.sparse_features.ids))
            if not pinned or b.sparse_features.ids.dtype != torch.int32:
                raise AssertionError(f"loader ({route}): batch not pinned "
                                     "int32")
        rates[route].append(n / (time.perf_counter() - t0))
    log(f"examples: the loader's batches/s at B={BENCH_BATCH} (host clock, "
        f"{pipe.num_batches} batches, pinned) {rates}")
    return rates


def hold_example_step(dmp, batch) -> dict:
    """One dlrm_main train step (the DMP's step, as the base pipeline takes
    it) on a loader batch, held against the plain versions by
    hold_train_step: one K1 and one fused K4, EX_SAMPLE seeded untouched
    rows and as many past element 2^31 of the block unchanged. The batch
    must address rows past element 2^31 (tables 23-25 at D=64): their
    slots are counted a feature."""
    from torchrec_tpu_torch.parallel import strategies

    (strat,) = dmp.sharded_ebcs[TRAIN_KEY].strategies
    if not isinstance(strat, strategies.DpEmbeddingSharding):
        raise AssertionError(f"examples: the plan's group is "
                             f"{type(strat).__name__}, not DATA_PARALLEL")
    D = strat.weights.shape[1]
    n_rows = int(strat.row_offsets[-1]) + strat.meta.tables[-1].rows
    first_past = EX_PAST // D  # the first row at element 2^31 or beyond
    sample = torch.from_numpy(row_sample(
        n_rows, D, np.random.RandomState(SEED + 53))).to(DEVICE)
    held = hold_train_step(dmp.make_train_step(),
                           batch.to(DEVICE).batch_args(),
                           expected(K1=1, K4=1), "examples", sample=sample)
    ids = held["ids"]
    past = ids * D >= EX_PAST
    past_by_feature = {f: int(past[f].sum()) for f in range(ids.shape[0])
                       if past[f].any()}
    if not past_by_feature:
        raise AssertionError("examples: the held step read no row past "
                             "element 2^31")
    return {**held["held"],
            "rows_past_2_31": int((held["rows"] >= first_past).sum()),
            "slots_past_2_31_by_feature": past_by_feature}


def hold_train_step(step, batch, per_step: dict, what: str,
                    capture: str = "", sample=None) -> dict:
    """One train step, which must launch `per_step`, held against the
    plain versions: the pooled output of its first lookup against the
    plain pooled lookup over the rows it read (rtol = atol = 1e-6; K1j's
    bags padded to its cap, as its own plain version pads them); the
    rows and momenta its first update touched against apply_fused_update
    on the CPU, run on the step's own ids and row gradients over CPU
    tables holding copies of those rows taken before the step (at their
    own row ids, so stochastic rounding draws the same bits): f32 rows and
    every momentum within EX_RTOL (and EX_RTOL of the tensor's scale near
    zero), half rows within one ulp of the table's dtype (the duplicate
    rows' gradient sums add in another order, and stochastic rounding may
    then take the other neighbour); the rows of `sample` (default
    EX_SAMPLE seeded rows of the table) that it did not touch unchanged.
    With `capture`, that fk wrapper's positional arguments are kept.
    Returns {"held": the numbers, "args": the captured arguments, "ids":
    the lookup's ids, "rows": the rows the update touched}."""
    from torchrec_tpu_torch.ops import fused_update_kernels as fk
    from torchrec_tpu_torch.ops import tbe_lookup as tl
    from torchrec_tpu_torch.ops.fused_update import (
        FusedOptimizerState,
        apply_fused_update,
    )
    from torchrec_tpu_torch.parallel import strategies

    seen: dict = {}
    lookup, update = strategies.pooled_lookup, strategies.apply_fused_update
    jagged = strategies.tbe_lookup_jagged_forward
    rng = np.random.RandomState(SEED + 63)

    def watched_lookup(weights, ids, coeff):
        out = lookup(weights, ids, coeff)
        if "out" not in seen:
            uniq = torch.unique(ids.reshape(-1).long())
            seen.update(ids=ids.cpu(), coeff=coeff.cpu(), l_uniq=uniq.cpu(),
                        l_rows=weights[uniq].cpu(), out=out.cpu())
        return out

    def watched_jagged(weights, ids, offsets, coeff=None, cap=tl.NO_CAP):
        out = jagged(weights, ids, offsets, coeff, cap)
        if "out" not in seen:
            flat, c = tl.jagged_padded(ids, offsets, coeff, cap)
            uniq = torch.unique(flat.reshape(-1).long())
            seen.update(ids=flat.cpu(), coeff=c.cpu(), l_uniq=uniq.cpu(),
                        l_rows=weights[uniq].cpu(), out=out.cpu())
        return out

    def watched_update(weights, opt, ids, grads, valid, lr, **kw):
        if "grads" not in seen:
            uniq = torch.unique(ids[valid].long())
            rows = sample
            if rows is None:
                rows = torch.from_numpy(rng.randint(
                    0, weights.shape[0], EX_SAMPLE)).to(weights.device)
            seen.update(
                W=weights, opt=opt, uniq=uniq, flat=ids.cpu(),
                grads=grads.cpu(), valid=valid.cpu(), lr=lr, kw=kw,
                step=int(opt.step), rows=weights[uniq].cpu(),
                moms={n: getattr(opt, n)[uniq].cpu()
                      for n in ("momentum1", "momentum2")
                      if getattr(opt, n) is not None},
                sample=rows, sample_before=weights[rows].cpu())
        return update(weights, opt, ids, grads, valid, lr, **kw)

    strategies.pooled_lookup = watched_lookup
    strategies.tbe_lookup_jagged_forward = watched_jagged
    strategies.apply_fused_update = watched_update
    try:
        with (capturing(fk, capture, seen) if capture
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            before = counts()
            loss, _ = step(*batch)
            torch.cuda.synchronize()
            after = counts()
    finally:
        strategies.pooled_lookup, strategies.apply_fused_update = (
            lookup, update)
        strategies.tbe_lookup_jagged_forward = jagged
    launched = {k: after[k] - before[k] for k in after}
    if launched != per_step or not math.isfinite(float(loss)):
        raise AssertionError(f"{what}: the held step launched {launched}, "
                             f"loss {float(loss)}")
    if "out" not in seen or "grads" not in seen:
        raise AssertionError(f"{what}: the held step's lookup or update was "
                             f"not seen")

    # the lookup: the plain pooled lookup over the rows it read
    ids = seen["ids"].long()
    Lk = ids.shape[-1]
    slots = torch.searchsorted(seen["l_uniq"], ids).to(torch.int32)
    ref = tl.tbe_lookup_pooled_reference(
        seen["l_rows"], slots.reshape(-1, Lk).contiguous(),
        seen["coeff"].reshape(-1, Lk).contiguous()).reshape(seen["out"].shape)
    torch.testing.assert_close(seen["out"], ref, rtol=1e-6, atol=1e-6)
    pooled_err = (seen["out"] - ref).abs().max().item()

    # the update: the plain apply_fused_update on the CPU
    W, opt, uniq = seen["W"], seen["opt"], seen["uniq"]
    u = uniq.cpu()
    w_ref = torch.zeros(W.shape, dtype=W.dtype)
    w_ref[u] = seen["rows"]
    moms = {}
    for n, rows in seen["moms"].items():
        moms[n] = torch.zeros(getattr(opt, n).shape, dtype=torch.float32)
        moms[n][u] = rows
    apply_fused_update(
        w_ref, FusedOptimizerState(
            momentum1=moms.get("momentum1"), momentum2=moms.get("momentum2"),
            step=torch.tensor(seen["step"], dtype=torch.int32),
            optim=opt.optim),
        seen["flat"], seen["grads"], seen["valid"], seen["lr"], **seen["kw"])
    got, want = W[uniq].cpu(), w_ref[u]
    if W.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=EX_RTOL,
                                   atol=EX_RTOL * want.abs().max().item())
        off_ulp = None
    else:
        ulp = (torch.nextafter(want, torch.full_like(want, math.inf)).float()
               - want.float())
        diff = (got.float() - want.float()).abs()
        if not bool((diff <= ulp).all()):
            raise AssertionError(f"{what}: a touched half row is more than "
                                 f"an ulp from the CPU's update")
        off_ulp = int((got != want).sum())
    mom_err = 0.0
    for n, m in moms.items():
        g_m, w_m = getattr(opt, n)[uniq].cpu(), m[u]
        torch.testing.assert_close(g_m, w_m, rtol=EX_RTOL,
                                   atol=EX_RTOL * w_m.abs().max().item())
        mom_err = max(mom_err, (g_m - w_m).abs().max().item())
    checked = seen["sample"]
    moved = ~torch.isin(checked, uniq)
    if not torch.equal(W[checked][moved].cpu(),
                       seen["sample_before"][moved.cpu()]):
        raise AssertionError(f"{what}: an untouched row moved in the held "
                             f"step")
    out = {"slots": int(seen["flat"].numel()), "rows": int(u.numel()),
           "pooled_max_abs_err": pooled_err,
           "rows_max_abs_err": (got.float() - want.float()).abs().max()
           .item(), "momenta_max_abs_err": mom_err,
           "untouched_checked": int(moved.sum())}
    if off_ulp is not None:
        out["elements_one_ulp_off"] = off_ulp
    nonzero = {k: v for k, v in launched.items() if v}
    log(f"{what}: one step (launched {nonzero}) held against the plain "
        f"versions on the CPU: {out}")
    return {"held": out, "args": seen.get(capture), "ids": ids, "rows": u}


@contextlib.contextmanager
def watch_example_calls(tally: dict):
    """Hold each call the examples make to its launches: a DLRM train
    step one K1 and one fused K4 per sharding group of its EBC, an eval
    call one K1 per group; a BERT4Rec step one routed gather and one fused
    K4 (and one route-only launch where the item table is ROW_WISE), an
    eval call one routed gather; a predict call one Kq. `tally` gets the
    calls by kind and the sum of their launches."""
    from torchrec_tpu_torch.inference.modules import PredictModule
    from torchrec_tpu_torch.parallel.dmp import DistributedModelParallel
    from torchrec_tpu_torch.parallel.sharded_ec import (
        ShardedEmbeddingCollection,
    )
    from torchrec_tpu_torch.parallel.types import ShardingType

    tally.setdefault("calls", {})
    tally.setdefault("launches", {})

    def rule(dmp, kind: str) -> dict:
        (sebc,) = dmp.sharded_ebcs.values()
        if isinstance(sebc, ShardedEmbeddingCollection):
            if kind == "eval":
                return {"K8r": 1}
            routed = dmp.plan.plan[B4R_KEY]["item_embedding"] \
                .sharding_type is ShardingType.ROW_WISE
            return {"K8r": 1, "K4": 1, **({ROUTE: 1} if routed else {})}
        groups = len(sebc.strategies)
        return {"K1": groups} if kind == "eval" else {"K1": groups,
                                                      "K4": groups}

    def checked(call, want: dict, what: str):
        before = counts()
        out = call()
        moved = _moved(counts(), before)
        n = tally["calls"].get(what, 0) + 1
        if moved != want:
            raise AssertionError(f"examples: {what} {n} launched {moved}, "
                                 f"expected {want}")
        tally["calls"][what] = n
        for k, v in want.items():
            tally["launches"][k] = tally["launches"].get(k, 0) + v
        return out

    DMP = DistributedModelParallel
    saved = (DMP._train_step, DMP.make_eval_fn, PredictModule.predict)

    def train_step(self, *args, **kw):
        return checked(lambda: saved[0](self, *args, **kw),
                       rule(self, "step"), "train step")

    def make_eval_fn(self):
        fn, want = saved[1](self), rule(self, "eval")
        return lambda *args: checked(lambda: fn(*args), want, "eval call")

    def predict(self, *args):
        return checked(lambda: saved[2](self, *args), {"Kq": 1},
                       "predict call")

    DMP._train_step, DMP.make_eval_fn, PredictModule.predict = (
        train_step, make_eval_fn, predict)
    try:
        yield tally
    finally:
        DMP._train_step, DMP.make_eval_fn, PredictModule.predict = saved


def hold_package_logits(train_argv, ckpt: str, lasts: dict) -> dict:
    """The int8 package's logits of dlrm_predict's last request on each
    route (`lasts`: route -> (dense, ids, logits)) against the f32
    model's, the trained DMP loaded from its reshardable checkpoint:
    within Q_SLACK x the first-order bound of phase 15 (quant_bounds),
    each example's sum over its pooled elements of |d logit / d pooled|
    times its row's int8 error bound."""
    from torchrec_tpu_torch.examples import dlrm_main
    from torchrec_tpu_torch.sparse import PaddedSparseBatch
    from torchrec_tpu_torch.utils.checkpoint import load_reshardable

    args = dlrm_main.parse_args(train_argv)
    env = dlrm_main.make_env(args)
    dmp = dlrm_main.build_dmp(args, env, dlrm_main.table_rows(args))
    t0 = time.perf_counter()
    load_reshardable(ckpt + ".npz", dmp)
    load_s = time.perf_counter() - t0
    sebc = dmp.sharded_ebcs[TRAIN_KEY]
    per_row = row_error_bound(sebc.unshard_tables(), 8)
    out = {"load_s": load_s}
    for route, (dense, ids, logits) in lasts.items():
        B, F = dense.shape[0], ids.shape[0]
        sb = PaddedSparseBatch(
            ids=torch.from_numpy(ids).to(DEVICE),
            lengths=torch.ones((F, B), dtype=torch.int32, device=DEVICE),
            keys=tuple(f"cat_{i}" for i in range(F)))
        targs = (torch.from_numpy(dense).to(DEVICE), sb,
                 torch.zeros(B, device=DEVICE))
        with torch.no_grad():
            pooled = sebc(sb)
        leaf = pooled.values.detach().clone().requires_grad_(True)
        sebc.injected = dataclasses.replace(pooled, values=leaf)
        try:
            f32 = logits_of(dmp.module(*targs))
            f32.sum().backward()
        finally:
            sebc.injected = None
        g = leaf.grad.reshape(B, F, EX_D).abs().sum(-1)
        rows = torch.from_numpy(ids[:, :, 0].T).to(DEVICE).long()
        eps = torch.stack([per_row[f"t_cat_{i}"][rows[:, i]]
                           for i in range(F)], 1)
        bnd = (g * eps).sum(1)
        d = (logits.reshape(-1).to(DEVICE) - f32.detach()).abs()
        over = (d - Q_SLACK * bnd - 1e-6).max().item()
        if over > 0 or not torch.isfinite(f32).all():
            raise AssertionError(f"examples: the package's logits ({route}) "
                                 f"beyond {Q_SLACK} x their bound by {over}")
        out[route] = {"examples": B, "max_abs": d.max().item(),
                      "bound_max": bnd.max().item(),
                      "ratio_max": (d / bnd).max().item()}
    log(f"examples: the int8 package's logits of each route's last request "
        f"against the f32 model loaded from the checkpoint ({load_s:.3f} s)"
        f": {out}")
    return out


def check_device_generators() -> dict:
    """device_latent_score on the card bit for bit with numpy's
    latent_score (edge ids and 1 M random ones), and the on-card batches
    of RandomRecDataset and SyntheticCriteoDataset in range and shape."""
    from torchrec_tpu_torch.datasets.random import RandomRecDataset, step_seed
    from torchrec_tpu_torch.datasets.synthetic_criteo import (
        CRITEO_KAGGLE_CARDINALITIES,
        SyntheticCriteoDataset,
        device_latent_score,
        latent_score,
    )

    rng = np.random.RandomState(SEED + 52)
    last = np.asarray(CRITEO_KAGGLE_CARDINALITIES) - 1
    ids = np.concatenate([[0, 2**31 - 1, 1, 65535, 65536, -1, -2**31],
                          last, rng.randint(0, 2**31 - 1, 1_000_000)])
    feats = np.concatenate([[0, 25, 25, 3, 25, 7, 25], np.arange(26),
                            rng.randint(0, 26, 1_000_000)])
    want = latent_score(feats, ids).view(np.uint32)
    got = device_latent_score(
        torch.from_numpy(feats.astype(np.int32)).to(DEVICE),
        torch.from_numpy(ids.astype(np.int32)).to(DEVICE)).cpu().numpy()
    if not np.array_equal(got.view(np.uint32), want):
        raise AssertionError("device_latent_score differs from numpy's "
                             f"at {int((got.view(np.uint32) != want).sum())} "
                             "ids")
    cards = np.asarray(ex_cards())
    b = SyntheticCriteoDataset(batch_size=BENCH_BATCH, cardinalities=cards
                               ).device_batch_fn(DEVICE)(step_seed(SEED))
    r = next(iter(RandomRecDataset(
        [f"cat_{i}" for i in range(26)], BENCH_BATCH, hash_sizes=cards,
        ids_per_feature=1, on_device=True, device=DEVICE, num_batches=1)))
    for name, batch in (("SyntheticCriteoDataset", b),
                        ("RandomRecDataset", r)):
        x = batch.sparse_features.ids[:, :, 0]
        ok = (x.shape == (26, BENCH_BATCH) and x.device.type == DEVICE
              and batch.dense_features.shape == (BENCH_BATCH, 13)
              and int(x.min()) >= 0
              and bool((x.max(1).values.cpu().numpy() < cards).all())
              and bool(torch.isfinite(batch.dense_features).all()))
        if not ok:
            raise AssertionError(f"{name}: a card-made batch out of range")
    ctr = b.labels.mean().item()
    if abs(ctr - 0.2562) > 0.03:
        raise AssertionError(f"SyntheticCriteoDataset on the card: CTR {ctr}")
    log(f"examples: device_latent_score equals numpy's bit for bit on "
        f"{ids.size} ids on the card; card-made SyntheticCriteoDataset and "
        f"RandomRecDataset batches in range (CTR {ctr:.4f})")
    return {"ctr": ctr}


def examples_phase() -> dict:
    """Phase 20 (see the module docstring): the port's examples through
    their main(argv). Returns the launches per kernel of the examples'
    runs, read from the counters (set to 0 before them), after checking
    that they equal the sum of every train step's, eval call's and
    predict call's asserted launches."""
    import shutil
    import tempfile

    from torchrec_tpu_torch.examples import (
        bert4rec_main,
        dlrm_main,
        dlrm_predict,
    )

    t_phase = time.perf_counter()
    numbers: dict = {}
    dev = ["--device", DEVICE]
    with tempfile.TemporaryDirectory(prefix="examples_") as tmp:
        log(f"examples: scratch {shutil.disk_usage(tmp)}")
        t = time.perf_counter()
        files = example_files(tmp)
        numbers["parse_lines_per_s"] = files["parse_lines_per_s"]
        numbers["loader_batches_per_s"] = loader_rates(files["days"])
        log(f"examples step 1 (files): {time.perf_counter() - t:.2f} s")

        file_argv = ["--in_memory_binary_criteo_path", files["days"],
                     "--num_embeddings_per_feature",
                     ",".join(map(str, ex_cards())),
                     "--batch_size", str(BENCH_BATCH), *dev]
        # the untrained model (the same seed) on the validation batches
        t = time.perf_counter()
        args = dlrm_main.parse_args(file_argv)
        env = dlrm_main.make_env(args)
        rows = dlrm_main.table_rows(args)
        dmp = dlrm_main.build_dmp(args, env, rows)
        untrained = dlrm_main.validate(
            dmp, dlrm_main.make_loader(args, "val", env, rows), env)
        types = sorted({ps.sharding_type.name
                        for ps in dmp.plan.plan[TRAIN_KEY].values()})
        log(f"examples: the untrained DLRM ({sum(rows)} rows, planned "
            f"{types}) on the validation batches: {untrained} "
            f"({time.perf_counter() - t:.2f} s)")
        t = time.perf_counter()
        numbers["held_step"] = hold_example_step(dmp, next(iter(
            dlrm_main.make_loader(args, "train", env, rows))))
        del dmp
        gc_cuda()
        log(f"examples step 2 (one step held against the plain versions): "
            f"{time.perf_counter() - t:.2f} s")

        tally: dict = {}
        ckpt, pkg = os.path.join(tmp, "ckpt"), os.path.join(tmp, "pkg")
        synth_argv = ["--synthetic_criteo", "--max_ind_range",
                      str(EX_MAX_IND), "--batch_size", str(BENCH_BATCH),
                      "--num_batches", str(EX_SYNTH_STEPS), "--save_dir",
                      ckpt, "--package_dir", pkg, *dev]
        reset_counts()
        with watch_example_calls(tally):
            for pipeline in ("base", "sparse_dist"):
                t = time.perf_counter()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                r = dlrm_main.main([*file_argv, "--train_pipeline",
                                    pipeline])
                peak = torch.cuda.max_memory_allocated()
                if not r["auroc"] > untrained["auroc"]:
                    raise AssertionError(
                        f"dlrm_main ({pipeline}): validation AUROC "
                        f"{r['auroc']} not above the untrained model's "
                        f"{untrained['auroc']}")
                numbers[f"files_{pipeline}"] = {
                    "examples_per_s": r["throughput"], "auroc": r["auroc"],
                    "untrained_auroc": untrained["auroc"],
                    "steps": r["steps"], "groups": r["groups"],
                    "peak_bytes": peak}
                gc_cuda()
                log(f"examples step 2 (dlrm_main from files, {pipeline}): "
                    f"{time.perf_counter() - t:.2f} s; {r}; "
                    f"max_memory_allocated {peak} B")
            t = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            r = dlrm_main.main(synth_argv)
            peak = torch.cuda.max_memory_allocated()
            numbers["synthetic_criteo"] = {
                "examples_per_s": r["throughput"], "auroc": r["auroc"],
                "steps": r["steps"], "peak_bytes": peak,
                "checkpoint_bytes": os.path.getsize(ckpt + ".npz"),
                "package_bytes": os.path.getsize(
                    os.path.join(pkg, "arrays.npz"))}
            gc_cuda()
            log(f"examples steps 3-4 (dlrm_main --synthetic_criteo, "
                f"{EX_SYNTH_STEPS} timed steps, --save_dir, --package_dir):"
                f" {time.perf_counter() - t:.2f} s; {r}; "
                f"{numbers['synthetic_criteo']}")
            served = {}
            for mode in ("direct", "--serve_batching", "--serve_native"):
                t = time.perf_counter()
                served[mode] = dlrm_predict.main(
                    ["--package_dir", pkg, "--batch_size", str(SERVE_BATCH),
                     "--num_requests", str(EX_REQUESTS), *dev,
                     *([] if mode == "direct" else [mode])])
                key = "predict_" + mode.lstrip("-")
                numbers[key] = {k: served[mode][k] for k in (
                    "qps", "predictions_per_sec", "latency")}
                gc_cuda()
                log(f"examples step 4 (dlrm_predict {mode}): "
                    f"{time.perf_counter() - t:.2f} s; {numbers[key]}")
            for mode in ("dmp", "dp"):
                t = time.perf_counter()
                r = bert4rec_main.main(["--synthetic_ml1m", "--num_batches",
                                        str(EX_B4R_STEPS), "--mode", mode,
                                        *dev])
                numbers[f"bert4rec_{mode}"] = {
                    **r, "step_ms": B4R_BATCH / r["throughput"] * 1e3}
                gc_cuda()
                log(f"examples step 5 (bert4rec_main --synthetic_ml1m "
                    f"--mode {mode}): {time.perf_counter() - t:.2f} s; {r}")
        launches = {k: v for k, v in counts().items() if v}
        if launches != {k: v for k, v in tally["launches"].items() if v}:
            raise AssertionError(f"examples: the counters moved {launches}; "
                                 f"the calls asserted {tally}")
        t = time.perf_counter()
        numbers["package_logits"] = hold_package_logits(
            synth_argv, ckpt, {m: r["last"] for m, r in served.items()})
        gc_cuda()
        log(f"examples step 4 (package against the f32 model): "
            f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    check_device_generators()
    log(f"examples step 6 (card-made batches): "
        f"{time.perf_counter() - t:.2f} s")
    log(f"examples phase: {time.perf_counter() - t_phase:.2f} s; calls "
        f"{tally['calls']}; launches {launches} (the counters)")
    log("examples numbers: " + json.dumps(numbers))
    return launches


# -- phase 21: every table width ---------------------------------------------

# the update kernels' widths: 1 and 3 (column-wise shards: COLUMN_WISE asks
# only that a width divide by the world size), 10 (the DeepFM below), 130
# (a masked second chunk), 516, 1030 and 4096 (the fused rowwise kernel's
# wide path); each on a table of WIDTH_ROWS rows and WIDTH_TOKENS tokens
WIDTHS = (1, 3, 10, 130, 516, 1030, 4096)
WIDTH_ROWS, WIDTH_TOKENS = 4096, 3072
# the unaligned views: (D, elements into the storage) — an odd row of a
# D=10 block, and a D=128 table one element in (whole quads, unaligned)
WIDTH_VIEWS = ((10, 10), (128, 1))
# the wide rowwise path timed at a bytes-bound shape
WIDE_D, WIDE_ROWS, WIDE_TOKENS = 1030, 100_000, 65_536
# SimpleDeepFMNN over the 26 Criteo Kaggle tables (33,762,577 rows) at
# embedding size 10: the DeepFM of the open CTR benchmark BARS on
# Criteo_x1 (FuxiCTR's configuration, embedding_dim 10); dense arch
# 13 -> 400 -> 10 and deep width 400, phase 14's
KD_DIM = 10
# (optimizer, fused_params, the tables' DataType, the update's launches
# per group and step); each trained under the planner's plan
KD_ROUTES = (
    ("EXACT_SGD", {}, "FP32", {"K3": 1}),
    ("ROWWISE_ADAGRAD", {}, "FP32", {"K4": 1}),
    ("ROWWISE_ADAGRAD", {"mom_impl": "xla"}, "FP32", {SCALED: 1}),
    ("ROWWISE_ADAGRAD", {"w_impl": "write"}, "FP32", {"K5": 1, "K2": 1}),
    ("ADAGRAD", {}, "FP32", {"K6": 1}),
    ("ADAM", {}, "FP32", {"K7": 1}),
    ("EXACT_SGD", {}, "BF16", {"K3h": 1}),
    ("ROWWISE_ADAGRAD", {}, "BF16", {"K4h": 1}),
)
# the routes trained again under one ROW_WISE plan
KD_ROW_WISE = (0, 1)


def _placed(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of t that starts `offset` elements into its
    storage (0: an aligned copy)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def check_width(fk, D: int, offset: int, rng) -> dict:
    """Every update kernel against its plain version on a [WIDTH_ROWS, D]
    table whose tensors start `offset` elements into their storage, with
    WIDTH_TOKENS tokens (hot rows repeated, 15 % invalid) combined as the
    routes combine them, at weight decay 0.01: K2, K3, K4's scaled RMW, the
    fused K4, K5 on the unfused route, K6 and K7 on f32 tables, K3h and K4h
    on bf16 and fp16 ones under both epilogues, every one bit for bit. The
    rowwise routes against each other: the momentum bit for bit on all
    four, the rows bit for bit between the two row writes of a momentum
    route and within rtol 1e-6 / atol 1e-7 between the two momentum routes
    (lr * inv against -lr / (...), test_k4_routes_agree_on_momentum's
    bound). Returns each kernel's largest difference."""
    from torchrec_tpu_torch.ops import fused_update as fu

    R, T, lr, wd = WIDTH_ROWS, WIDTH_TOKENS, FUSED_LR, 0.01
    dev = torch.device(DEVICE)

    def put(a):
        return _placed(torch.from_numpy(np.ascontiguousarray(a)).to(dev),
                       offset)

    flat = rng.randint(0, R, size=T).astype(np.int32)
    flat[:T // 4] = rng.randint(0, 20, size=T // 4)
    valid = torch.from_numpy(rng.rand(T) > 0.15).to(dev)
    grads = torch.from_numpy(
        (rng.randn(T, D) * 1e-2).astype(np.float32)).to(dev)
    flat = torch.from_numpy(flat).to(dev)
    u_rt, g_rt = fu.run_total_row_grads(flat, grads, valid, R)
    u_dd, g_dd = fu.dedup_row_grads(flat, grads, valid, R)
    g_rt, g_dd = _placed(g_rt, offset), _placed(g_dd, offset)
    W = put((rng.randn(R, D) * 0.1).astype(np.float32))
    M = put(rng.rand(R).astype(np.float32))
    M1 = put((rng.rand(R, D) * 0.01).astype(np.float32))
    M2 = put((rng.rand(R, D) * 0.01).astype(np.float32))
    step = torch.full((), START_STEP + 1, dtype=torch.int32, device=dev)
    errs = {}

    def hold(k, kernel, plain, *state):
        a = [_placed(t, offset) for t in state]
        b = [_placed(t, offset) for t in state]
        kernel(*a)
        plain(*b)
        errs[k] = max(errs.get(k, 0.0), _hold(
            f"{k} at D={D} (offset {offset})", list(zip(a, b))))
        return a, b

    rows = _placed(W[u_rt.clamp(max=R - 1).long()] - lr * g_rt, offset)
    hold("K2", lambda w: fk.scatter_rows_write(w, u_rt, rows),
         lambda w: fk.scatter_rows_write_reference(w, u_rt, rows), W)
    hold("K3", lambda w: fk.fused_update_sgd(w, u_rt, g_rt, lr, wd),
         lambda w: fk.fused_update_sgd_reference(w, u_rt, g_rt, lr, wd), W)
    g_sq = fk.row_mean_sq(g_dd) * (u_dd < R).to(torch.float32)
    _, inv, _ = fk.rowwise_momentum_stream_reference(M.clone(), u_dd, g_sq)
    scale = lr * inv
    hold(SCALED, lambda w: fk.scaled_row_update(w, u_dd, g_dd, scale),
         lambda w: fk.scaled_row_update_reference(w, u_dd, g_dd, scale), W)
    # the rowwise routes, each against the plain default route
    routes = {}
    for stream, w_impl in ((True, "rmw"), (True, "write"), (False, "rmw")):
        k = {(True, "rmw"): "K5", (True, "write"): "K5",
             (False, "rmw"): SCALED}[stream, w_impl]
        a, b = hold(k, lambda w, m: fk.rowwise_adagrad_unfused(
            w, m, u_dd, g_dd, lr, weight_decay=wd, momentum_stream=stream,
            w_impl=w_impl),
            lambda w, m: fk.fused_update_rowwise_adagrad_reference(
                w, m, u_dd, g_dd, lr, weight_decay=wd,
                momentum_stream=stream, w_impl=w_impl), W, M)
        routes[stream, w_impl] = a
    fused, _ = hold("K4", lambda w, m: fk.fused_update_rowwise_adagrad(
        w, m, u_dd, g_dd, lr, weight_decay=wd, momentum_stream=True),
        lambda w, m: fk.fused_update_rowwise_adagrad_reference(
            w, m, u_dd, g_dd, lr, weight_decay=wd, momentum_stream=True),
        W, M)
    for (stream, w_impl), (w, m) in routes.items():
        _hold(f"the rowwise momentum at D={D}, route {stream}/{w_impl}",
              [(m, fused[1])])
        if stream:
            _hold(f"the rowwise rows at D={D}, route {w_impl}",
                  [(w, fused[0])])
        else:
            torch.testing.assert_close(w, fused[0], rtol=1e-6, atol=1e-7)
    hold("K6", lambda w, m: fk.fused_update_adagrad(
        w, m, u_rt, g_rt, lr, weight_decay=wd),
        lambda w, m: fk.fused_update_adagrad_reference(
            w, m, u_rt, g_rt, lr, weight_decay=wd), W, M1)
    hold("K7", lambda w, m1, m2: fk.fused_update_adam(
        w, m1, m2, u_rt, g_rt, lr, step, weight_decay=wd),
        lambda w, m1, m2: fk.fused_update_adam_reference(
            w, m1, m2, u_rt, g_rt, lr, step, weight_decay=wd), W, M1, M2)
    for dtype in (torch.bfloat16, torch.float16):
        Wh = _placed(W.to(dtype), offset)
        for sr, base in ((True, 0), (True, 3 * R), (False, 0)):
            kw = dict(weight_decay=wd, stochastic_rounding=sr, row_base=base)
            hold("K3h", lambda w: fk.fused_update_sgd_half(
                w, u_rt, g_rt, lr, step, **kw),
                lambda w: fk.fused_update_sgd_half_reference(
                    w, u_rt, g_rt, lr, step, **kw), Wh)
            hold("K4h", lambda w, m: fk.fused_update_rowwise_adagrad_half(
                w, m, u_dd, g_dd, lr, step, **kw),
                lambda w, m: fk.fused_update_rowwise_adagrad_half_reference(
                    w, m, u_dd, g_dd, lr, step, **kw), Wh, M)
    return errs


def check_widths(fk) -> dict:
    """check_width at every width of WIDTHS and at the unaligned views of
    WIDTH_VIEWS. Returns per kernel the cases held and the largest
    difference (0: every case bit for bit)."""
    rng = np.random.RandomState(SEED + 60)
    cases = [(D, 0) for D in WIDTHS] + list(WIDTH_VIEWS)
    out: dict = {}
    for D, offset in cases:
        for k, err in check_width(fk, D, offset, rng).items():
            r = out.setdefault(k, {"cases": 0, "max_abs_err": 0.0})
            r["cases"] += 1
            r["max_abs_err"] = max(r["max_abs_err"], err)
    log(f"widths: K2, K3, K4's scaled RMW, the fused K4, K5, K6, K7, K3h and "
        f"K4h (bf16 and fp16, both epilogues) bit for bit with their plain "
        f"versions at D in {WIDTHS} and at the views (D, elements in) "
        f"{WIDTH_VIEWS}; the rowwise routes agree (momentum bit for bit): "
        f"{out}")
    return out


def kd_cards() -> tuple:
    from torchrec_tpu_torch.datasets.synthetic_criteo import (
        CRITEO_KAGGLE_CARDINALITIES,
    )

    return tuple(CRITEO_KAGGLE_CARDINALITIES)


def make_kd_dmp(device: str, train: bool = False, optim=None,
                fused_params=None, data_type: str = "FP32",
                planned: bool = True):
    """The Criteo Kaggle SimpleDeepFMNN at D=KD_DIM (DeepFMTrain when
    `train`) on `device`: fused lr 0.1 (`optim`, default ROWWISE_ADAGRAD,
    with `fused_params`), dense Adam at 1e-3; its tables of `data_type`
    planned by the DMP's planner, or all ROW_WISE."""
    from torchrec_tpu_torch.models import SimpleDeepFMNN
    from torchrec_tpu_torch.modules import (
        EmbeddingBagCollection,
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.modules.embedding_configs import DataType
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )

    tables = [EmbeddingBagConfig(num_embeddings=c, embedding_dim=KD_DIM,
                                 name=f"t{i}", feature_names=[f"f{i}"],
                                 data_type=DataType[data_type])
              for i, c in enumerate(kd_cards())]
    model = SimpleDeepFMNN(
        DENSE_IN, EmbeddingBagCollection(tables, max_feature_length=L,
                                         device="meta"),
        DFM_HIDDEN, DFM_DEEP, device="meta")
    if train:
        model = DeepFMTrain(model)
    plan = None if planned else ShardingPlan({
        DFM_TRAIN_KEY if train else DFM_KEY: {
            t.name: ParameterSharding(ShardingType.ROW_WISE)
            for t in tables}})
    return DistributedModelParallel(
        model, plan=plan, device=device,
        fused_optim=optim or EmbOptimType.ROWWISE_ADAGRAD,
        fused_params={"learning_rate": FUSED_LR, **(fused_params or {})},
        dense_optimizer=lambda p: torch.optim.Adam(p, lr=DFM_DENSE_LR))


def kd_request(rng: np.random.RandomState, batch: int):
    """(dense [B, 13] f32, KeyedJaggedTensor of 26 features x B x 1), each
    feature's ids uniform over its table's rows."""
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    cards = kd_cards()
    ids = np.concatenate([rng.randint(0, c, size=batch)
                          for c in cards]).astype(np.int32)
    kjt = KeyedJaggedTensor.from_lengths(
        [f"f{i}" for i in range(len(cards))], ids,
        np.ones(len(cards) * batch, np.int32))
    dense = rng.randn(batch, DENSE_IN).astype(np.float32)
    return torch.from_numpy(dense), kjt


def _kd_groups(dmp, key: str) -> tuple:
    """(sharding groups, the plan's sharding types)."""
    return (len(dmp.sharded_ebcs[key].strategies),
            sorted({ps.sharding_type.name
                    for ps in dmp.plan.plan[key].values()}))


def kd_serve(data_type: str, planned: bool) -> dict:
    """REQUESTS_PER_BATCH requests at B=8192 and at B=256 through
    make_eval_fn, each launching one lookup per sharding group (kjt_lookups:
    K1j on the planner's DATA_PARALLEL group, K1 or K1h on another) and
    nothing else; probabilities finite in [0, 1]."""
    what = (f"deepfm D={KD_DIM} {data_type} "
            f"({'planned' if planned else 'ROW_WISE'})")
    dmp = make_kd_dmp(DEVICE, data_type=data_type,
                      planned=planned).init(SEED)
    groups, types = _kd_groups(dmp, DFM_KEY)
    lookups = kjt_lookups(dmp, DFM_KEY)
    want = expected(**lookups)
    eval_fn = dmp.make_eval_fn()
    rng = np.random.RandomState(SEED + 61)
    requests = [(b, *kd_request(rng, b))
                for b in [BENCH_BATCH] * REQUESTS_PER_BATCH
                + [SERVE_BATCH] * REQUESTS_PER_BATCH]
    latencies = {BENCH_BATCH: [], SERVE_BATCH: []}
    torch.cuda.synchronize()
    for batch, dense, kjt in requests:
        before = counts()
        t0 = time.perf_counter()
        p = eval_fn(dense.to(DEVICE), kjt.to(DEVICE)).cpu()
        latencies[batch].append((time.perf_counter() - t0) * 1e3)
        after = counts()
        launched = {k: after[k] - before[k] for k in after}
        if launched != want:
            raise AssertionError(f"{what}: a request launched {launched}, "
                                 f"expected {want}")
        if (p.shape != (batch, 1) or not bool(torch.isfinite(p).all())
                or not bool(((p >= 0) & (p <= 1)).all())):
            raise AssertionError(f"{what}: bad probabilities at B={batch}")
    for batch, ms in latencies.items():
        log(f"{what} serve B={batch}: request ms (host clock, H2D + forward "
            f"+ D2H, first includes warm-up) {ms}")
    log(f"{what} serve: plan {types}, {groups} group(s), launches per "
        f"request {({k: v for k, v in want.items() if v})}")
    return {"request_ms": latencies, "plan": types, "lookups": lookups}


def kd_train(route: int, planned: bool = True) -> dict:
    """KD_ROUTES[route]: WARMUP_STEPS + TIMED_STEPS train steps at B=8192,
    each launching one lookup (kjt_lookups) and the route's update once
    per group and nothing else, losses finite; then one step held
    (hold_train_step), whose update kernel's arguments are kept on the
    default routes under the planner's plan."""
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType

    name, params, data_type, update = KD_ROUTES[route]
    what = (f"deepfm D={KD_DIM} {data_type} {name}"
            f"{' ' + str(params) if params else ''} "
            f"({'planned' if planned else 'ROW_WISE'})")
    dmp = make_kd_dmp(DEVICE, train=True, optim=EmbOptimType[name],
                      fused_params=params, data_type=data_type,
                      planned=planned).init(SEED)
    groups, types = _kd_groups(dmp, DFM_TRAIN_KEY)
    lookups = kjt_lookups(dmp, DFM_TRAIN_KEY)
    per_step = expected(**lookups,
                        **{k: v * groups for k, v in update.items()})
    step = dmp.make_train_step()
    rng = np.random.RandomState(SEED + 62)
    batches = []
    for _ in range(WARMUP_STEPS + TIMED_STEPS + 1):
        dense, kjt = kd_request(rng, BENCH_BATCH)
        labels = torch.from_numpy(
            rng.randint(0, 2, size=BENCH_BATCH).astype(np.float32))
        batches.append(to_device((dense, kjt, labels)))
    torch.cuda.synchronize()
    ms, losses = [], []
    for i, batch in enumerate(batches[:-1]):
        before = counts()
        t0 = time.perf_counter()
        loss, _ = step(*batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        after = counts()
        launched = {k: after[k] - before[k] for k in after}
        losses.append(loss.item())
        if launched != per_step or not math.isfinite(losses[-1]):
            raise AssertionError(f"{what} step {i} launched {launched} "
                                 f"(expected {per_step}), loss {losses[-1]}")
    timed = ms[WARMUP_STEPS:]
    median = sorted(timed)[TIMED_STEPS // 2]
    log(f"{what} B={BENCH_BATCH}: plan {types}, {groups} group(s); losses "
        f"{losses}")
    log(f"{what}: warm-up step ms {ms[:WARMUP_STEPS]}; timed step ms (host "
        f"clock, synchronized) {timed}; min {min(timed):.4f} max "
        f"{max(timed):.4f} median {median:.4f}; "
        f"{TIMED_STEPS * BENCH_BATCH / (sum(timed) / 1e3):.1f} examples/s; "
        f"launches per step {({k: v for k, v in per_step.items() if v})}")
    capture = ""
    if planned and not params:
        capture = KERNELS[next(iter(update))][0]
    held = hold_train_step(step, batches[-1], per_step, what, capture)
    return {"ms": timed, "median_ms": median, "held": held["held"],
            "args": held["args"], "steps": len(batches), "lookups": lookups}


def kd_quant_requests(rng: np.random.RandomState) -> list:
    """(batch, dense [B, 13], KeyedJaggedTensor of 26 features x B x 1, ids
    [26, B] numpy): REQUESTS_PER_BATCH at B=8192, then at B=256, each
    feature's ids uniform over its table's rows."""
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    cards = kd_cards()
    out = []
    for b in ([BENCH_BATCH] * REQUESTS_PER_BATCH
              + [SERVE_BATCH] * REQUESTS_PER_BATCH):
        ids = np.stack([rng.randint(0, c, size=b)
                        for c in cards]).astype(np.int32)
        kjt = KeyedJaggedTensor.from_lengths(
            [f"f{i}" for i in range(len(cards))], ids.reshape(-1),
            np.ones(len(cards) * b, np.int32))
        dense = torch.from_numpy(rng.randn(b, DENSE_IN).astype(np.float32))
        out.append((b, dense, kjt, ids))
    return out


def kd_quant_prepare() -> dict:
    """The quantized D=10 DeepFM made ready outside the counted window:
    the f32 model (planned, seeded), the requests of kd_quant_requests,
    its probabilities for each, each example's first-order bound on its
    probability's distance from the f32 model per quantized type (the sum
    over its pooled elements of |d p / d pooled| times the row's error
    bound, row_error_bound) with the pooled values and their bounds, and
    the model quantized by quantize_embeddings and sharded by
    shard_quantized for each type of QUANT_TYPES."""
    from torchrec_tpu_torch.inference import (
        quantize_embeddings,
        shard_quantized,
    )
    from torchrec_tpu_torch.modules.embedding_configs import DataType

    t0 = time.perf_counter()
    dmp = make_kd_dmp(DEVICE).init(SEED)
    sebc = dmp.sharded_ebcs[DFM_KEY]
    requests = kd_quant_requests(np.random.RandomState(SEED + 67))
    tables = sebc.unshard_tables()
    per_row = {name: row_error_bound(tables, bits)
               for name, bits in QUANT_TYPES.items()}
    del tables
    F_ = len(kd_cards())
    f32, bounds = [], {name: [] for name in QUANT_TYPES}
    for batch, dense, kjt, ids in requests:
        dense, kjt = dense.to(DEVICE), kjt.to(DEVICE)
        with torch.no_grad():
            pooled = sebc(kjt)
        leaf = pooled.values.detach().clone().requires_grad_(True)
        sebc.injected = dataclasses.replace(pooled, values=leaf)
        try:
            p = dmp.module(dense, kjt)
            (g,) = torch.autograd.grad(p.sum(), leaf)
        finally:
            sebc.injected = None
        f32.append(p.detach()[:, 0].cpu())
        g = g.reshape(batch, F_, KD_DIM).abs().sum(-1)
        rows = torch.from_numpy(ids.T).to(DEVICE).long()  # [B, 26]
        for name, bnd in per_row.items():
            eps = torch.stack([bnd[f"t{i}"][rows[:, i]]
                               for i in range(F_)], 1)
            bounds[name].append({"p": (g * eps).sum(1).cpu(),
                                 "pooled": pooled.values.detach(),
                                 "eps": eps.repeat_interleave(KD_DIM, 1)})
    del per_row
    sharded = {}
    for name in QUANT_TYPES:
        pm = quantize_embeddings(dmp, DataType[name], DEVICE)
        sharded[name] = shard_quantized(pm)
        del pm
        # the sharded module's pooled values against the f32 ones, element
        # by element
        qebc = sharded[name]._sharded[DFM_KEY]
        for (_, _, kjt, _), bnd in zip(requests, bounds[name]):
            with torch.inference_mode():
                qv = qebc(kjt.to(DEVICE)).values
            over = ((qv - bnd.pop("pooled")).abs()
                    - bnd.pop("eps")).max().item()
            if over > 0:
                raise AssertionError(f"deepfm D={KD_DIM} {name}: pooled "
                                     f"values beyond their bound by "
                                     f"{over:.3e}")
    del dmp, sebc
    gc_cuda()
    log(f"deepfm D={KD_DIM} quantized: f32 probabilities and first-order "
        f"bounds of {len(requests)} requests; int8 and int4 modules "
        f"quantized and sharded, their pooled values within their rows' "
        f"error bounds of the f32 ones; in {time.perf_counter() - t0:.2f} s")
    return {"requests": requests, "f32": f32, "bounds": bounds,
            "sharded": sharded}


def kd_quant_serve(ready: dict) -> dict:
    """The quantized D=10 DeepFM served through shard_quantized: every
    request of `ready` at int8 and at int4, each launching exactly one Kq
    and nothing else (no K1); probabilities finite, of shape [B, 1], each
    within Q_SLACK times its first-order bound of the f32 model's, and the
    sharded module's pooled values within their rows' error bounds of the
    f32 ones (checked in kd_quant_prepare). Returns each type's request ms
    and its largest ratio of distance to bound."""
    out = {}
    for name, spm in ready["sharded"].items():
        ms = {BENCH_BATCH: [], SERVE_BATCH: []}
        ratio = 0.0
        for (batch, dense, kjt, _), ref, bnd in zip(
                ready["requests"], ready["f32"], ready["bounds"][name]):
            before = counts()
            t0 = time.perf_counter()
            p = spm.predict(dense.to(DEVICE), kjt.to(DEVICE)).cpu()
            ms[batch].append((time.perf_counter() - t0) * 1e3)
            after = counts()
            launched = {k: after[k] - before[k] for k in after}
            if launched != expected(Kq=1):
                raise AssertionError(f"deepfm D={KD_DIM} {name} sharded "
                                     f"request launched {launched}")
            if p.shape != (batch, 1) or not bool(torch.isfinite(p).all()):
                raise AssertionError(f"deepfm D={KD_DIM} {name}: bad "
                                     f"output {tuple(p.shape)}")
            d = (p[:, 0] - ref).abs()
            over = (d - Q_SLACK * bnd["p"] - 1e-6).max().item()
            if over > 0:
                raise AssertionError(f"deepfm D={KD_DIM} {name}: outputs "
                                     f"beyond {Q_SLACK} x their bound by "
                                     f"{over:.3e}")
            ratio = max(ratio, (d / bnd["p"].clamp(min=1e-30)).max().item())
        for batch, t in ms.items():
            log(f"deepfm D={KD_DIM} {name} sharded serve B={batch}: request "
                f"ms (host clock, H2D + predict + D2H, first includes "
                f"warm-up) {t}")
        log(f"deepfm D={KD_DIM} {name}: one Kq a request; outputs within "
            f"{Q_SLACK} x their first-order bound of the f32 model's "
            f"(largest ratio {ratio:.4f})")
        out[name] = {"request_ms": ms, "bound_ratio": ratio}
    return out


def kd_kernels(captured) -> dict:
    """Each default route's update kernel held and timed on its held step's
    arguments (`captured`: (kernel, arguments) pairs), at the D=10
    DeepFM's shape: K3 (check_sgd), the fused K4 (check_rowwise, with K5
    and the unfused composition), K6 / K7 (hold_moments), K3h / K4h
    (check_half_update)."""
    from torchrec_tpu_torch.ops import fused_update_kernels as fk

    what = f" the D={KD_DIM} DeepFM"
    out = {}
    for k, args in captured:
        if k == "K3":
            W, uids, g, lr = args
            out.update(report(check_sgd(fk, W, uids, g, lr), what))
        elif k == "K4":
            W, M, uids, g, lr = args
            rw = check_rowwise(fk, W, M, uids, g, lr, what.strip())
            out.update(report(rw, what))
            out["K4"]["unfused_ms"] = rw["K4"]["unfused_ms"]
        elif k in ("K6", "K7"):  # (W, m1[, m2], uids, g, lr[, step])
            n = 2 if k == "K6" else 3
            uids, g, lr = args[n:n + 3]
            step = args[n + 3] if k == "K7" else 0
            out.update(report(hold_moments(fk, k, list(args[:n]), uids, g,
                                           lr, step, what), what))
        else:
            out[k] = check_half_update(fk, k, args, what.strip())
    return out


def time_wide(fk) -> dict:
    """The fused rowwise kernel's wide path at D=WIDE_D on a bytes-bound
    shape (a [WIDE_ROWS, WIDE_D] table, WIDE_TOKENS uniform ids
    deduplicated): the f32 kernel through check_rowwise (bit-exact, timed
    in turns with the unfused composition it replaces there), K4h on a
    bf16 copy and an fp16 one through check_half_update."""
    from torchrec_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 65)
    R, D, T = WIDE_ROWS, WIDE_D, WIDE_TOKENS
    W = torch.randn((R, D), generator=gen, device=DEVICE) * 0.1
    M = torch.rand((R,), generator=gen, device=DEVICE)
    flat = torch.randint(0, R, (T,), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    grads = torch.randn((T, D), generator=gen, device=DEVICE) * 1e-3
    u_dd, g_dd = fu.dedup_row_grads(
        flat, grads, torch.ones(T, dtype=torch.bool, device=DEVICE), R)
    del grads
    what = f" at D={D} (the wide path)"
    rw = check_rowwise(fk, W, M, u_dd, g_dd, FUSED_LR, what.strip())
    k4 = report({"K4": rw["K4"]}, what)["K4"]
    k4["unfused_ms"] = rw["K4"]["unfused_ms"]
    step = torch.full((), START_STEP, dtype=torch.int32, device=DEVICE)
    k4h = check_half_update(fk, "K4h", (W.to(torch.bfloat16), M, u_dd, g_dd,
                                        FUSED_LR, step), what.strip())
    return {"K4": k4, "K4h": k4h}


def kaggle_lookup(D: int, seed: int) -> tuple:
    """A [33,762,577, D] table of the 26 Criteo Kaggle tables drawn on the
    card and one B=8192 batch of their features, one id each, uniform over
    each table's rows: (W, ids [26 * 8192, 1] global, coefficients 1,
    local ids [26, 8192], the tables' first rows)."""
    cards = kd_cards()
    offs = np.concatenate([[0], np.cumsum(cards)[:-1]]).astype(np.int64)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    W = torch.randn((sum(cards), D), generator=gen, device=DEVICE)
    W *= 0.05
    rng = np.random.RandomState(seed)
    local = np.stack([rng.randint(0, c, size=BENCH_BATCH)
                      for c in cards]).astype(np.int32)  # [F, B]
    ids = torch.from_numpy(
        (local + offs[:, None]).reshape(-1, 1).astype(np.int32)).to(DEVICE)
    return W, ids, torch.ones(ids.shape, device=DEVICE), local, offs


def hold_lookups(tl, W, ids, coeff) -> dict:
    """K1 on the f32 table W and K1h on a bf16 copy: bit-exact with their
    plain versions, timed beside F.embedding_bag."""
    import torch.nn.functional as F

    D = W.shape[1]
    out = {}
    for tag, Wt in (("K1", W), ("K1h", W.to(torch.bfloat16))):
        got = tl.tbe_lookup_pooled(Wt, ids, coeff)
        err = _hold(f"{tag} at D={D}",
                    [(got, tl.tbe_lookup_pooled_reference(Wt, ids, coeff))])
        b = bound(Wt, ids, coeff)
        psw = coeff.to(Wt.dtype)
        t = timings(lambda: tl.tbe_lookup_pooled(Wt, ids, coeff),
                    K1_KERNELS, b["ms"],
                    lambda: tl.tbe_lookup_pooled_reference(Wt, ids, coeff),
                    lambda: F.embedding_bag(ids, Wt, mode="sum",
                                            per_sample_weights=psw))
        out[tag] = {"max_abs_err": err, "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
                    "bound_ms": b["ms"], "bound_by": b["by"]}
        log(f"{tag} D={D} NB={ids.shape[0]}: bit-exact with its plain "
            f"version; {t['ms']:.5f} ms on the device (call "
            f"{t['call_ms']:.4f} ms); plain {t['plain_ms']:.4f} ms; "
            f"F.embedding_bag {t['library_ms']:.4f} ms; bound "
            f"{b['ms']:.5f} ms ({b['by']}: {b['bytes']} B with {b['rows']} "
            f"distinct rows); kernel at {100 * b['ms'] / t['ms']:.1f}% of "
            f"the bound")
    return out


def check_lookups_d10(tl) -> dict:
    """K1 and K1h (bf16) at D=KD_DIM on kaggle_lookup's table and batch,
    through hold_lookups (their narrow path). K8, the routed gather and Kq
    are held and timed there in phase 22 (time_lookups)."""
    W, ids, coeff, _, _ = kaggle_lookup(KD_DIM, SEED + 66)
    return hold_lookups(tl, W, ids, coeff)


def sector_bytes(base: int, row_bytes: int, rows: torch.Tensor,
                 word_arrays=()) -> int:
    """The least bytes the distinct rows `rows` of a table at address
    `base` with rows of `row_bytes` bytes take from memory in 32-byte
    sectors, with their words of each 4-byte-per-row array at the
    addresses of `word_arrays` (Kq's scale and shift): every sector a row
    or word touches, once."""
    r = rows.long()
    first = (base + r * row_bytes) // 32
    last = (base + r * row_bytes + row_bytes - 1) // 32
    span = int((last - first).max().item()) + 1 if r.numel() else 0
    parts = [torch.where(first + k <= last, first + k, first)
             for k in range(span)]
    n = int(torch.unique(torch.cat(parts)).numel()) if parts else 0
    for addr in word_arrays:
        n += int(torch.unique((addr + r * 4) // 32).numel())
    return 32 * n


def time_lookups(gr, ql, W, ids, coeff, local, offs) -> dict:
    """K8, the routed gather and Kq (8 and 4 bits) at W's width on
    kaggle_lookup's table and batch (212,992 ids): K8 through check_gather
    (bit-exact, beside index_select); the routed gather on a rank that owns
    every row (ids [26, 8192, 1] local to each table) equal by value to its
    plain version and its route-only mode bit for bit; Kq pooled and
    unpooled bit-exact, timed beside PyTorch's quantized embedding bag
    (library_quant_lookup, held within rtol = atol = 1e-6 of the plain
    version). Each beside its byte bound and its sector bound (every
    32-byte sector a distinct row, and Kq's scale and shift, touch)."""
    from torchrec_tpu_torch.ops.quant import quantize_rowwise

    cards = kd_cards()
    R, D = W.shape
    flat = ids.reshape(-1)
    rows = torch.unique(flat)
    out = {}
    k8 = check_gather(W, flat, f"at D={D}")
    k8["sector_bound_ms"] = (sector_bytes(W.data_ptr(), 4 * D, rows)
                             + flat.numel() * (4 + 4 * D)) \
        / HBM_BYTES_PER_S * 1e3
    out["K8"] = {k: v for k, v in k8.items() if k != "call_ms"}
    F_, B_ = local.shape
    ids3 = torch.from_numpy(local.reshape(F_, B_, 1)).to(DEVICE)
    lengths = torch.ones((F_, B_), dtype=torch.int32, device=DEVICE)
    shard_rows = torch.tensor(cards, dtype=torch.int32, device=DEVICE)
    local_off = torch.from_numpy(offs.astype(np.int32)).to(DEVICE)
    route = (ids3, lengths, shard_rows, local_off, 0)
    got = gr.routed_gather_rows(W, *route)
    err = _hold(f"the routed gather at D={D}",
                [(got, gr.routed_gather_rows_reference(W, *route))])
    loc, own = gr.route_tokens(*route)
    ref_loc, ref_own = gr.route_tokens_reference(*route)
    if not (torch.equal(loc, ref_loc) and torch.equal(own, ref_own)):
        raise AssertionError(f"the route-only mode at D={D} is not "
                             "bit-exact with the plain route")
    b = routed_bound(ids3, lengths, ref_loc, ref_own, D)
    t = timings(lambda: gr.routed_gather_rows(W, *route), ROUTED_KERNELS,
                b["ms"], lambda: gr.routed_gather_rows_reference(W, *route))
    out["K8r"] = {"max_abs_err": err, "ms": t["ms"],
                  "plain_ms": t["plain_ms"], "library_ms": None,
                  "bound_ms": b["ms"], "bound_by": b["by"],
                  "sector_bound_ms": k8["sector_bound_ms"]}
    log(f"K8r D={D}: {F_} x {B_} tokens, equal to its plain version, its "
        f"route-only mode bit-exact; {t['ms']:.5f} ms on the device (call "
        f"{t['call_ms']:.5f} ms); plain {t['plain_ms']:.4f} ms; bound "
        f"{b['ms']:.5f} ms, in sectors {k8['sector_bound_ms']:.5f} ms; "
        f"kernel at {100 * b['ms'] / t['ms']:.1f}% of the bound")
    del got
    for bits in (8, 4):
        q = quantize_rowwise(W, bits)
        args = (q.data, q.scale, q.shift, ids, coeff, bits)
        got = ql.quant_lookup_pooled(*args)
        ref = ql.quant_lookup_pooled_reference(*args)
        rows_got = ql.quant_lookup_rows(*args[:3], flat, bits)
        rows_ref = ql.quant_lookup_rows_reference(*args[:3], flat, bits)
        err = _hold(f"Kq at {bits} bits, D={D}",
                    [(got, ref), (rows_got, rows_ref)])
        del rows_got, rows_ref
        lib = library_quant_lookup(q, ids)
        lib_out = lib()
        torch.testing.assert_close(lib_out, ref, rtol=1e-6, atol=1e-6)
        lib_err = (lib_out - ref).abs().max().item()
        del lib_out, got, ref
        b = quant_bound(bits, D, ids, coeff)
        sectors = sector_bytes(q.data.data_ptr(), D * bits // 8, rows,
                               (q.scale.data_ptr(), q.shift.data_ptr()))
        sector_ms = (sectors + ids.numel() * 8 + ids.shape[0] * D * 4) \
            / HBM_BYTES_PER_S * 1e3
        t = timings(lambda: ql.quant_lookup_pooled(*args), KQ_KERNELS,
                    b["ms"], lambda: ql.quant_lookup_pooled_reference(*args),
                    lib)
        out[f"Kq{bits}"] = {"max_abs_err": err, "ms": t["ms"],
                            "plain_ms": t["plain_ms"],
                            "library_ms": t["library_ms"],
                            "library_max_abs_err": lib_err,
                            "bound_ms": b["ms"], "bound_by": b["by"],
                            "sector_bound_ms": sector_ms}
        log(f"Kq {bits} bits D={D}: bit-exact with its plain version "
            f"(pooled and unpooled); {t['ms']:.5f} ms on the device (call "
            f"{t['call_ms']:.5f} ms); plain {t['plain_ms']:.4f} ms; PyTorch's"
            f" quantized embedding bag {t['library_ms']:.5f} ms (max abs err"
            f" {lib_err:.3e}); bound {b['ms']:.5f} ms ({b['bytes']} B, "
            f"{b['rows']} distinct rows), in sectors {sector_ms:.5f} ms "
            f"({sectors} B of rows, scales and shifts); kernel at "
            f"{100 * b['ms'] / t['ms']:.1f}% of the bound, "
            f"{100 * sector_ms / t['ms']:.1f}% of the sector bound")
        del q, args, lib
        gc_cuda()
    q8, q4 = out.pop("Kq8"), out.pop("Kq4")
    out["Kq"] = {**q8, "max_abs_err": max(q8["max_abs_err"],
                                          q4["max_abs_err"]), "int4": q4}
    return out


def widths_phase() -> dict:
    """Phase 21 (see the module docstring). Returns {"launches": the D=10
    DeepFM path's launches per counter, read from the counters set to 0
    just before it (checked against the sum of every request's and step's
    asserted launches), "results": per kernel, this phase's numbers}."""
    from torchrec_tpu_torch.ops import fused_update_kernels as fk
    from torchrec_tpu_torch.ops import tbe_lookup as tl

    t_phase = time.perf_counter()
    widths = check_widths(fk)
    gc_cuda()
    log(f"widths step 1 (the update kernels at every width): "
        f"{time.perf_counter() - t_phase:.2f} s")

    # the main path: the D=10 DeepFM served and trained, and served
    # quantized (its f32 reference and packages made first), counted from 0
    t = time.perf_counter()
    ready = kd_quant_prepare()
    reset_counts()
    served = {(dt, planned): kd_serve(dt, planned) for dt, planned in (
        ("FP32", True), ("FP32", False), ("BF16", True))}
    gc_cuda()
    trained = {}
    for route, planned in ([(r, True) for r in range(len(KD_ROUTES))]
                           + [(r, False) for r in KD_ROW_WISE]):
        trained[route, planned] = kd_train(route, planned)
        gc_cuda()
    quant = kd_quant_serve(ready)
    launches = {k: v for k, v in counts().items() if v}
    want: dict = {"Kq": len(QUANT_TYPES) * len(ready["requests"])}
    del ready
    gc_cuda()
    for r in served.values():
        for k, v in r["lookups"].items():
            want[k] = want.get(k, 0) + v * 2 * REQUESTS_PER_BATCH
    for (route, _), r in trained.items():
        for k, v in {**r["lookups"], **KD_ROUTES[route][3]}.items():
            want[k] = want.get(k, 0) + v * r["steps"]
    if launches != want:
        raise AssertionError(f"widths: the DeepFM path launched {launches}, "
                             f"its requests and steps {want} (one group "
                             f"each)")
    log(f"widths step 2 (the D={KD_DIM} DeepFM served and trained, and "
        f"served at int8 and int4): {time.perf_counter() - t:.2f} s; "
        f"launches {launches} (the counters)")

    t = time.perf_counter()
    d10 = kd_kernels([(next(iter(KD_ROUTES[r][3])), v.pop("args"))
                      for (r, _), v in trained.items()
                      if v["args"] is not None])
    gc_cuda()
    d10.update(check_lookups_d10(tl))
    gc_cuda()
    wide = time_wide(fk)
    gc_cuda()
    log(f"widths step 3 (the kernels at D={KD_DIM} and the wide path "
        f"timed): {time.perf_counter() - t:.2f} s")
    numbers = {
        "serve_request_ms": {f"{dt} {'planned' if p else 'ROW_WISE'}":
                             r["request_ms"] for (dt, p), r in served.items()},
        "quant_request_ms": {k: v["request_ms"] for k, v in quant.items()},
        "quant_bound_ratio": {k: v["bound_ratio"] for k, v in quant.items()},
        "train_median_ms": {
            f"{KD_ROUTES[r][2]} {KD_ROUTES[r][0]} {KD_ROUTES[r][1] or ''} "
            f"{'planned' if p else 'ROW_WISE'}": v["median_ms"]
            for (r, p), v in trained.items()},
        "held": {f"{KD_ROUTES[r][2]} {KD_ROUTES[r][0]} "
                 f"{KD_ROUTES[r][1] or ''} {'planned' if p else 'ROW_WISE'}":
                 v["held"] for (r, p), v in trained.items()}}
    log("widths numbers: " + json.dumps(numbers))
    log(f"widths phase: {time.perf_counter() - t_phase:.2f} s")
    results = {k: {"widths": v} for k, v in widths.items()}
    for k, v in d10.items():
        results.setdefault(k, {})["d10_shape"] = v
    for k, v in wide.items():
        results.setdefault(k, {})["wide_d1030"] = v
    return {"launches": launches, "results": results}


# -- phase 22: narrow rows ---------------------------------------------------

# every lane group at its ends and inside (G = 1: D 1-4, 2: 5-8, 4: 9-16,
# 8: 17-32, 16: 33-64; ops/lane_groups.py), odd widths and even ones that
# are not whole quads (the row kernel's pairs) at each, and D=128 (a row a
# warp)
NARROW_WIDTHS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 17, 18, 32, 33, 34, 63,
                 64, 128)
# each table aligned, and one element into its storage (no whole quads)
NARROW_OFFSETS = (0, 1)
# [NARROW_ROWS, D] tables; 3,001 bags and tokens leave the last warp
# partial at every lane group
NARROW_ROWS, NARROW_BAGS, NARROW_TOKENS = 4096, 3001, 3001
NARROW_L = 20
# the widths timed: the D=10 DeepFM's (phase 21) and the Kaggle DLRM's
# (phase 20)
NARROW_TIMED = (10, 64)
# the routed gather's tokens [F, B, L] at every width: 3,003, so the last
# warp is partial at every lane group
NARROW_ROUTE_SHAPE = (7, 13, 33)


@contextlib.contextmanager
def slots_a_warp(fk, kernel: str, slots: int):
    """The row kernel of K2, K3 and K4's scaled RMW (`kernel` "row"), the
    fused rowwise kernel of K4 and K4h ("fused") or the moment kernel of K6
    and K7 ("moment") takes `slots` slots a warp while open, with its lanes
    per row unchanged (the wrappers read fk.<kernel>_geometry at each
    call)."""
    name = f"{kernel}_geometry"
    saved = getattr(fk, name)
    setattr(fk, name, lambda D, *rest: (saved(D, *rest)[0], slots))
    try:
        yield
    finally:
        setattr(fk, name, saved)


def slot_counts(D: int, kernel: str = "row") -> list:
    """The slots a warp of `kernel` (slots_a_warp's names) can take at width
    D: the powers of two from its lane groups' count up to 32; past 64
    columns (a warp a row) 32 alone, or 1 to 32 for the fused kernel."""
    from torchrec_tpu_torch.ops.lane_groups import rows_per_warp

    slots = rows_per_warp(D)
    if slots == 1 and kernel != "fused":
        return [32]
    out = []
    while slots <= 32:
        out.append(slots)
        slots *= 2
    return out


def check_narrow_width(tl, fk, D: int, offset: int, rng) -> dict:
    """K1 (f32), K1h (bf16 and fp16), K2, K3, K3h (bf16 and fp16), K4's
    scaled RMW, the fused K4, K4h (bf16 and fp16), K6 and K7 against their
    plain versions on a [NARROW_ROWS, D] table that starts `offset`
    elements into its storage. The lookups over NARROW_BAGS bags at L=1
    (one id, coefficient 1: bit for bit) and at L=NARROW_L (MEAN
    coefficients on even bags, per-sample weights on odd ones, zero-padded
    slots, ids below 0 and past R: within rtol = atol = 1e-6, phase 4's
    tolerance). The row kernels over NARROW_TOKENS tokens (hot rows
    repeated, 15 % invalid) as run totals (K2, K3 at weight decay 0 and
    0.01, K3h on bf16 and fp16 tables under both epilogues, stochastic
    rounding keyed from row 0 and from row 3 R, at 0 and 0.01, K6 and K7
    at both) and dedup output (the scaled RMW, the fused K4 at weight
    decay 0 and 0.01, K4h under both epilogues at 0.01), bit for bit at
    every slot count of slot_counts(D, kernel). Returns each kernel's
    largest difference."""
    from torchrec_tpu_torch.ops import fused_update as fu

    R, NB, T, lr, Lk = NARROW_ROWS, NARROW_BAGS, NARROW_TOKENS, FUSED_LR, \
        NARROW_L
    dev = torch.device(DEVICE)
    W = torch.from_numpy((rng.randn(R, D) * 0.1).astype(np.float32)).to(dev)
    errs: dict = {}

    def note(k, err):
        errs[k] = max(errs.get(k, 0.0), err)

    ids1 = torch.from_numpy(
        rng.randint(0, R, size=(NB, 1)).astype(np.int32)).to(dev)
    c1 = torch.ones((NB, 1), device=dev)
    ids20 = torch.from_numpy(
        rng.randint(-5, R + 100, size=(NB, Lk)).astype(np.int32)).to(dev)
    lengths = torch.from_numpy(rng.randint(0, Lk + 1, size=NB)).to(dev)
    mask = torch.arange(Lk, device=dev)[None, :] < lengths[:, None]
    psw = torch.from_numpy(rng.rand(NB, Lk).astype(np.float32)).to(dev)
    mean = mask / lengths.clamp(min=1)[:, None]
    c20 = torch.where(torch.arange(NB, device=dev)[:, None] % 2 == 0, mean,
                      mask * psw).float().contiguous()
    for k, dtype in (("K1", torch.float32), ("K1h", torch.bfloat16),
                     ("K1h", torch.float16)):
        Wt = _placed(W.to(dtype), offset)
        what = f"{k} ({dtype}) at D={D} (offset {offset})"
        note(k, _hold(f"{what}, L=1", [
            (tl.tbe_lookup_pooled(Wt, ids1, c1),
             tl.tbe_lookup_pooled_reference(Wt, ids1, c1))]))
        got = tl.tbe_lookup_pooled(Wt, ids20, c20)
        ref = tl.tbe_lookup_pooled_reference(Wt, ids20, c20)
        try:
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
        except AssertionError as e:
            raise AssertionError(f"{what}, L={Lk}: {e}") from None
        note(k, (got - ref).abs().max().item())

    flat = rng.randint(0, R, size=T).astype(np.int32)
    flat[:T // 4] = rng.randint(0, 20, size=T // 4)
    valid = torch.from_numpy(rng.rand(T) > 0.15).to(dev)
    grads = torch.from_numpy(
        (rng.randn(T, D) * 1e-2).astype(np.float32)).to(dev)
    flat = torch.from_numpy(flat).to(dev)
    u_rt, g_rt = fu.run_total_row_grads(flat, grads, valid, R)
    u_dd, g_dd = fu.dedup_row_grads(flat, grads, valid, R)
    g_rt, g_dd = _placed(g_rt, offset), _placed(g_dd, offset)
    rows = _placed(W[u_rt.clamp(max=R - 1).long()] - lr * g_rt, offset)
    scale = torch.from_numpy(
        (rng.rand(u_dd.numel()) * -1e-3).astype(np.float32)).to(dev)
    step = torch.full((), START_STEP + 1, dtype=torch.int32, device=dev)
    # the row kernel's cases: (name, kernel, plain, the table they update)
    cases = [
        ("K2", lambda w: fk.scatter_rows_write(w, u_rt, rows),
         lambda w: fk.scatter_rows_write_reference(w, u_rt, rows), W),
        *[("K3", lambda w, wd=wd: fk.fused_update_sgd(w, u_rt, g_rt, lr, wd),
           lambda w, wd=wd: fk.fused_update_sgd_reference(w, u_rt, g_rt, lr,
                                                          wd), W)
          for wd in (0.0, 0.01)],
        (SCALED, lambda w: fk.scaled_row_update(w, u_dd, g_dd, scale),
         lambda w: fk.scaled_row_update_reference(w, u_dd, g_dd, scale), W),
    ]
    # K3h on bf16 and fp16 tables: stochastic rounding from row 0 and from
    # row 3 R, and to nearest, each at weight decay 0 and 0.01
    for dtype in (torch.bfloat16, torch.float16):
        for sr, base in ((True, 0), (True, 3 * R), (False, 0)):
            for wd in (0.0, 0.01):
                kw = dict(weight_decay=wd, stochastic_rounding=sr,
                          row_base=base)
                cases.append((
                    "K3h", lambda w, kw=kw: fk.fused_update_sgd_half(
                        w, u_rt, g_rt, lr, step, **kw),
                    lambda w, kw=kw: fk.fused_update_sgd_half_reference(
                        w, u_rt, g_rt, lr, step, **kw), W.to(dtype)))
    for slots in slot_counts(D):
        for k, kernel, plain, start in cases:
            a, b = _placed(start, offset), _placed(start, offset)
            with slots_a_warp(fk, "row", slots):
                kernel(a)
            plain(b)
            note(k, _hold(f"{k} ({start.dtype}) at D={D} (offset {offset}, "
                          f"{slots} slots a warp)", [(a, b)]))

    # the fused rowwise kernel (K4, K4h) on the dedup output, the moment
    # kernel (K6, K7) on the run totals: (name, kernel, plain, state)
    def put(a):
        return _placed(torch.from_numpy(a.astype(np.float32)).to(dev), offset)

    M, M1, M2 = (put(rng.rand(R)), put(rng.rand(R, D) * 0.01),
                 put(rng.rand(R, D) * 0.01))
    fused = [("K4", lambda w, m, wd=wd: fk.fused_update_rowwise_adagrad(
        w, m, u_dd, g_dd, lr, weight_decay=wd, momentum_stream=True),
        lambda w, m, wd=wd: fk.fused_update_rowwise_adagrad_reference(
            w, m, u_dd, g_dd, lr, weight_decay=wd, momentum_stream=True),
        [W, M]) for wd in (0.0, 0.01)]
    for dtype in (torch.bfloat16, torch.float16):
        Wh = _placed(W.to(dtype), offset)
        for sr, base in ((True, 0), (True, 3 * R), (False, 0)):
            kw = dict(weight_decay=0.01, stochastic_rounding=sr,
                      row_base=base)
            fused.append(("K4h", lambda w, m, kw=kw:
                          fk.fused_update_rowwise_adagrad_half(
                              w, m, u_dd, g_dd, lr, step, **kw),
                          lambda w, m, kw=kw:
                          fk.fused_update_rowwise_adagrad_half_reference(
                              w, m, u_dd, g_dd, lr, step, **kw), [Wh, M]))
    moment = []
    for wd in (0.0, 0.01):
        moment += [
            ("K6", lambda w, m, wd=wd: fk.fused_update_adagrad(
                w, m, u_rt, g_rt, lr, weight_decay=wd),
             lambda w, m, wd=wd: fk.fused_update_adagrad_reference(
                 w, m, u_rt, g_rt, lr, weight_decay=wd), [W, M1]),
            ("K7", lambda w, m1, m2, wd=wd: fk.fused_update_adam(
                w, m1, m2, u_rt, g_rt, lr, step, weight_decay=wd),
             lambda w, m1, m2, wd=wd: fk.fused_update_adam_reference(
                 w, m1, m2, u_rt, g_rt, lr, step, weight_decay=wd),
             [W, M1, M2])]
    for kernel_of, group in (("fused", fused), ("moment", moment)):
        for slots in slot_counts(D, kernel_of):
            for k, kernel, plain, state in group:
                a = [_placed(t, offset) for t in state]
                b = [_placed(t, offset) for t in state]
                with slots_a_warp(fk, kernel_of, slots):
                    kernel(*a)
                plain(*b)
                note(k, _hold(f"{k} at D={D} (offset {offset}, {slots} "
                              f"slots a warp)", list(zip(a, b))))
    return errs


def check_narrow_lookups(gr, ql, D: int, offset: int, rng) -> dict:
    """K8, the routed gather and Kq against their plain versions at width D,
    each table `offset` elements (Kq: bytes) into its storage:
    K8 over NARROW_TOKENS ids of a [NARROW_ROWS, D] table (ids below 0 and
    past R), bit for bit; the routed gather over NARROW_ROUTE_SHAPE tokens
    (three shard sizes and offsets, rank 1, padded tokens, negative ids and
    ids past every shard) equal by value with +0.0 under every masked
    token, its route-only mode bit for bit; Kq, pooled over NARROW_BAGS
    bags at L=NARROW_L (MEAN and per-sample coefficients, zero-padded
    slots, ids below 0 and past R) and unpooled with and without a
    coefficient, bit for bit, at each bit count that packs D (8 every D, 4
    an even D, 2 D % 4 == 0). Returns each kernel's largest difference."""
    from torchrec_tpu_torch.ops.quant import quantize_rowwise

    R, T, NB, Lk = NARROW_ROWS, NARROW_TOKENS, NARROW_BAGS, NARROW_L
    dev = torch.device(DEVICE)
    what = f"at D={D} (offset {offset})"
    w = torch.from_numpy((rng.randn(R, D) * 0.1).astype(np.float32)).to(dev)
    W = _placed(w, offset)
    errs = {}

    ids = torch.from_numpy(
        rng.randint(-5, R + 100, size=T).astype(np.int32)).to(dev)
    errs["K8"] = _hold(f"K8 {what}", [(gr.gather_rows_forward(W, ids),
                                       gr.gather_rows_reference(W, ids))])

    F_, B_, L_ = NARROW_ROUTE_SHAPE
    ids3 = torch.from_numpy(rng.randint(-50, 2 * R, size=(F_, B_, L_)
                                        ).astype(np.int32)).to(dev)
    lengths = torch.from_numpy(rng.randint(0, L_ + 1, size=(F_, B_)
                                           ).astype(np.int32)).to(dev)
    sr = torch.from_numpy(rng.randint(R // 4, R // 2, size=F_
                                      ).astype(np.int32)).to(dev)
    off = torch.from_numpy(rng.randint(0, R // 2, size=F_
                                       ).astype(np.int32)).to(dev)
    route = (ids3, lengths, sr, off, 1)
    got = gr.routed_gather_rows(W, *route)
    local, owned = gr.route_tokens(*route)
    ref_local, ref_owned = gr.route_tokens_reference(*route)
    err = _hold(f"the routed gather {what}",
                [(got, gr.routed_gather_rows_reference(W, *route))])
    masked = got[~ref_owned]
    if bool(torch.signbit(masked).any()) or bool(masked.any()):
        raise AssertionError(f"the routed gather {what}: a masked token "
                             "is not +0.0")
    if not (torch.equal(local, ref_local) and torch.equal(owned, ref_owned)):
        raise AssertionError(f"the route-only mode {what} is not bit-exact "
                             "with the plain route")
    if not 0 < int(ref_owned.sum()) < ref_owned.numel():
        raise AssertionError(f"the routed gather {what}: no token owned, "
                             "or no token masked")
    errs["K8r"] = err

    ids20 = torch.from_numpy(
        rng.randint(-5, R + 100, size=(NB, Lk)).astype(np.int32)).to(dev)
    lens = torch.from_numpy(rng.randint(0, Lk + 1, size=NB)).to(dev)
    mask = torch.arange(Lk, device=dev)[None, :] < lens[:, None]
    psw = torch.from_numpy(rng.rand(NB, Lk).astype(np.float32)).to(dev)
    c20 = torch.where(torch.arange(NB, device=dev)[:, None] % 2 == 0,
                      mask / lens.clamp(min=1)[:, None],
                      mask * psw).float().contiguous()
    flat, cflat = ids20.reshape(-1), c20.reshape(-1)
    errs["Kq"] = 0.0
    for bits in (8, 4, 2):
        if D * bits % 8 or (bits == 2 and D % 4):
            continue
        q = quantize_rowwise(w, bits)
        args = (_placed(q.data, offset), q.scale, q.shift)
        errs["Kq"] = max(errs["Kq"], _hold(f"Kq at {bits} bits {what}", [
            (ql.quant_lookup_pooled(*args, ids20, c20, bits),
             ql.quant_lookup_pooled_reference(*args, ids20, c20, bits)),
            (ql.quant_lookup_rows(*args, flat, bits, cflat),
             ql.quant_lookup_rows_reference(*args, flat, bits, cflat)),
            (ql.quant_lookup_rows(*args, flat, bits),
             ql.quant_lookup_rows_reference(*args, flat, bits))]))
    return errs


def check_narrow(tl, fk, gr, ql) -> dict:
    """check_narrow_width and check_narrow_lookups at every width of
    NARROW_WIDTHS and offset of NARROW_OFFSETS. Returns per kernel the
    largest difference."""
    rng = np.random.RandomState(SEED + 70)
    out: dict = {}
    for D in NARROW_WIDTHS:
        for offset in NARROW_OFFSETS:
            errs = check_narrow_width(tl, fk, D, offset, rng)
            errs.update(check_narrow_lookups(gr, ql, D, offset, rng))
            for k, err in errs.items():
                out[k] = max(out.get(k, 0.0), err)
    log(f"narrow rows: K1 and K1h (bf16, fp16) bit for bit with their plain "
        f"versions at L=1 and within rtol = atol = 1e-6 at L={NARROW_L} "
        f"(MEAN and per-sample coefficients, padded slots, ids out of "
        f"range); K2, K3, K3h (bf16, fp16, both epilogues), the scaled "
        f"RMW, the fused K4, K4h (bf16, fp16, both epilogues), K6 and K7 "
        f"bit for bit at every slot count a warp; K8, Kq (8, 4, 2 bits; "
        f"pooled at L={NARROW_L} and unpooled) and the route-only mode bit "
        f"for bit, the routed gather by value (+0.0 under masked tokens); "
        f"at D in {NARROW_WIDTHS}, offsets {NARROW_OFFSETS}: largest "
        f"differences {out}")
    return out


def check_scaled(fk, W, u_dd, g_dd, scale) -> dict:
    """K4's scaled RMW on clones of a table at one batch's dedup output:
    bit-exact with its plain version, then timed beside index_add_ of the
    pre-scaled rows on the real slots (the multiply outside the timing)."""
    R, D = W.shape
    real = u_dd < R
    n_real = int(real.sum())
    W1, W2 = W.clone(), W.clone()
    fk.scaled_row_update(W1, u_dd, g_dd, scale)
    fk.scaled_row_update_reference(W2, u_dd, g_dd, scale)
    ids_real = u_dd[real].long()
    sg_real = (scale[:, None] * g_dd)[real]
    b = rows_bound(int(u_dd.numel()), n_real, D, rows_moved=3,
                   extra_bytes=n_real * 4)
    return {SCALED: {
        "max_abs_err": _hold(SCALED, [(W1, W2)]), "bound": b,
        **timings(lambda: fk.scaled_row_update(W1, u_dd, g_dd, scale),
                  ROW_KERNEL, b["ms"],
                  lambda: fk.scaled_row_update_reference(W2, u_dd, g_dd,
                                                         scale),
                  lambda: W2.index_add_(0, ids_real, sg_real)),
    }}


def time_narrow(tl, fk, gr, ql, D: int) -> dict:
    """K1, K1h (bf16), K8, the routed gather, Kq (8 and 4 bits;
    time_lookups), K3, K2 and K4's scaled RMW at width D on
    kaggle_lookup's table and batch (212,992 bags; the same ids as one
    update's 212,992 slots, run totals and dedup output, gradients of
    1e-3): each bit-exact with its plain version and timed beside its
    bound, its plain version and its PyTorch call (F.embedding_bag,
    index_select, the quantized embedding bag, index_add_, index_copy_);
    then the fused K4, K4h, K3h, K6 and K7 (time_narrow_updates)."""
    from torchrec_tpu_torch.ops import fused_update as fu

    W, ids, coeff, local, offs = kaggle_lookup(D, SEED + 71)
    R = W.shape[0]
    out = hold_lookups(tl, W, ids, coeff)
    out.update(time_lookups(gr, ql, W, ids, coeff, local, offs))
    gc_cuda()
    flat = ids.reshape(-1)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 72)
    grads = torch.randn((flat.numel(), D), generator=gen, device=DEVICE)
    grads *= 1e-3
    valid = torch.ones(flat.numel(), dtype=torch.bool, device=DEVICE)
    u_rt, g_rt = fu.run_total_row_grads(flat, grads, valid, R)
    u_dd, g_dd = fu.dedup_row_grads(flat, grads, valid, R)
    del grads
    scale = torch.rand(u_dd.numel(), generator=gen, device=DEVICE) * -1e-3
    log(f"narrow D={D}: {flat.numel()} slots, {int((u_rt < R).sum())} "
        f"distinct rows; the row kernel's lanes and slots a warp "
        f"{fk.row_geometry(D)}")
    rows = check_sgd(fk, W, u_rt, g_rt, FUSED_LR)
    rows.update(check_k2(fk, W, u_rt, g_rt, FUSED_LR))
    rows.update(check_scaled(fk, W, u_dd, g_dd, scale))
    out.update(report(rows, f" at D={D} (narrow rows)"))
    del scale, rows
    gc_cuda()
    out.update(time_narrow_updates(fk, W, u_rt, g_rt, u_dd, g_dd, gen))
    return out


def hold_in_place(what: str, state: list, ids: torch.Tensor, kernel,
                  plain) -> float:
    """`kernel` and `plain` each run in place on `state` from the same
    start (the table, too large to clone twice, is state[0]), held bit for
    bit on the rows `ids` they update and on row_sample's seeded rows of
    the table, which the plain version leaves as they were: a kernel that
    writes a row it should not differs there. The rows are saved before
    and put back after each run."""
    R, D = state[0].shape
    sample = torch.from_numpy(row_sample(
        R, D, np.random.RandomState(SEED + 73))).to(ids.device)
    held = torch.cat([ids, sample])
    saved = [t[held] for t in state]
    got = []
    for fn in (kernel, plain):
        fn(*state)
        got.append([t[held] for t in state])
        for t, rows in zip(state, saved):
            t[held] = rows
    err = _hold(what, list(zip(*got)))
    log(f"{what}: bit for bit on its {ids.numel()} rows and "
        f"{sample.numel()} sampled rows ({int((sample * D >= EX_PAST).sum())}"
        f" past element 2^31)")
    return err


def time_narrow_updates(fk, W, u_rt, g_rt, u_dd, g_dd, gen) -> dict:
    """The fused K4 (f32), K4h and K3h (bf16, fp16) and K6 / K7 at width D
    on one batch's dedup output and run totals over W (kaggle_lookup's
    table, updated in place) and momenta drawn from `gen`: each held bit
    for bit with its plain version (K4, K6, K7 at weight decay 0 and 0.01
    through hold_in_place; K4h and K3h under both epilogues through
    check_half_update) and timed beside its bound and plain version; the
    fused K4 also in turns with the unfused composition it replaced
    (fused, unfused, unfused, fused), its yardstick; K3h beside index_add_
    (check_half_update). No single PyTorch call applies the other
    updates, so their library time is null."""
    R, D = W.shape
    lr, what = FUSED_LR, f" at D={D} (narrow rows)"
    step = torch.full((), START_STEP + 1, dtype=torch.int32, device=DEVICE)
    real_dd, real_rt = u_dd < R, u_rt < R
    ids_dd, ids_rt = u_dd[real_dd].long(), u_rt[real_rt].long()
    n_dd, n_rt = int(ids_dd.numel()), int(ids_rt.numel())
    log(f"narrow updates D={D}: {u_dd.numel()} slots, {n_dd} rows; the "
        f"fused kernel's lanes and slots a warp "
        f"{fk.fused_geometry(D, int(u_dd.numel()))}, the moment kernel's "
        f"{fk.moment_geometry(D)}")
    M = torch.rand((R,), generator=gen, device=DEVICE)
    rows = {}

    def fused(w, m, wd=0.0):
        fk.fused_update_rowwise_adagrad(w, m, u_dd, g_dd, lr,
                                        weight_decay=wd, momentum_stream=True)

    def fused_plain(w, m, wd=0.0):
        fk.fused_update_rowwise_adagrad_reference(
            w, m, u_dd, g_dd, lr, weight_decay=wd, momentum_stream=True)

    def unfused():
        fk.rowwise_adagrad_unfused(W, M, u_dd, g_dd, lr)

    err = max(hold_in_place(f"K4{what}, weight decay {wd}", [W, M], ids_dd,
                            lambda w, m, wd=wd: fused(w, m, wd),
                            lambda w, m, wd=wd: fused_plain(w, m, wd))
              for wd in (0.0, 0.01))
    b = rows_bound(int(u_dd.numel()), n_dd, D, rows_moved=3,
                   extra_bytes=2 * n_dd * 4, flops_per_elem=7)
    k4 = {"max_abs_err": err, "bound": b,
          **timings(lambda: fused(W, M), ROWWISE_KERNELS, b["ms"],
                    lambda: fused_plain(W, M))}
    unfused_ms = [device_ms(unfused, bound_ms=b["ms"]) for _ in range(2)]
    fused_ms = [k4["ms"], device_ms(lambda: fused(W, M), ROWWISE_KERNELS,
                                    b["ms"])]
    k4["ms"], k4["unfused_ms"] = sum(fused_ms) / 2, sum(unfused_ms) / 2
    log(f"K4{what}: fused {fused_ms[0]:.5f} / {fused_ms[1]:.5f} ms, "
        f"unfused composition {unfused_ms[0]:.5f} / {unfused_ms[1]:.5f} ms "
        f"(device time, in turns: fused, unfused, unfused, fused)")
    rows["K4"] = k4
    half = check_half_update(fk, "K4h", (W.to(torch.bfloat16), M, u_dd,
                                         g_dd, lr, step), what.strip())
    del M
    gc_cuda()
    k3h = check_half_update(fk, "K3h", (W.to(torch.bfloat16), u_rt, g_rt, lr,
                                        step), what.strip())
    gc_cuda()
    moms = [torch.rand((R, D), generator=gen, device=DEVICE) * 0.01]
    for k in ("K6", "K7"):
        if k == "K7":
            moms.append(torch.rand((R, D), generator=gen, device=DEVICE)
                        * 0.01)

        def kernel(*ts, wd=0.0, k=k):
            if k == "K6":
                fk.fused_update_adagrad(*ts, u_rt, g_rt, lr, weight_decay=wd)
            else:
                fk.fused_update_adam(*ts, u_rt, g_rt, lr, step,
                                     weight_decay=wd)

        def plain(*ts, wd=0.0, k=k):
            if k == "K6":
                fk.fused_update_adagrad_reference(*ts, u_rt, g_rt, lr,
                                                  weight_decay=wd)
            else:
                fk.fused_update_adam_reference(*ts, u_rt, g_rt, lr, step,
                                               weight_decay=wd)

        state = [W, *moms]
        err = max(hold_in_place(f"{k}{what}, weight decay {wd}", state,
                                ids_rt,
                                lambda *ts, wd=wd: kernel(*ts, wd=wd),
                                lambda *ts, wd=wd: plain(*ts, wd=wd))
                  for wd in (0.0, 0.01))
        # read W, the momenta and g, write W and the momenta: 5 or 7 rows
        b = rows_bound(int(u_rt.numel()), n_rt, D,
                       rows_moved=2 * len(state) + 1,
                       flops_per_elem=14 if k == "K7" else 7)
        rows[k] = {"max_abs_err": err, "bound": b,
                   **timings(lambda: kernel(*state), MOMENT_KERNELS,
                             b["ms"], lambda: plain(*state))}
    del moms, state
    gc_cuda()
    out = report(rows, what)
    out["K4"]["unfused_ms"] = k4["unfused_ms"]
    out["K4h"], out["K3h"] = half, k3h
    return out


def narrow_phase() -> dict:
    """Phase 22 (see the module docstring). Returns per kernel (K1, K1h,
    K2, K3, the scaled RMW, K4, K4h, K6, K7, K8, the routed gather and Kq)
    this phase's numbers:
    {"narrow": the largest difference over the widths, "narrow_d10" /
    "narrow_d64": the held and timed kernel}."""
    from torchrec_tpu_torch.ops import fused_update_kernels as fk
    from torchrec_tpu_torch.ops import gather_rows as gr
    from torchrec_tpu_torch.ops import quant_lookup as ql
    from torchrec_tpu_torch.ops import tbe_lookup as tl

    t = time.perf_counter()
    errs = check_narrow(tl, fk, gr, ql)
    gc_cuda()
    log(f"narrow step 1 (every narrow kernel at every lane group): "
        f"{time.perf_counter() - t:.2f} s")
    results = {k: {"narrow": {"max_abs_err": e,
                              "widths": list(NARROW_WIDTHS)}}
               for k, e in errs.items()}
    for D in NARROW_TIMED:
        for k, v in time_narrow(tl, fk, gr, ql, D).items():
            results[k][f"narrow_d{D}"] = v
        gc_cuda()
    log(f"narrow phase: {time.perf_counter() - t:.2f} s")
    return results


# -- phase 23: the DLRM's dot interaction -------------------------------------

# the Criteo Kaggle DLRM's interaction (the benchmark's DLRM cells): B
# examples of n = F + 1 = 27 rows of D = 64; held and timed
DI_SHAPE = (65536, 26, 64)
# held only: bench.py's D = 128, two widths not a multiple of 4 (the
# element access) and the largest n the kernel takes
DI_HELD = ((8192, 26, 128), (4099, 26, 63), (513, 30, 66), (777, 63, 130))
# the kernels' names as the profiler prints them
DI_KERNELS = "dot_interaction_"
DI_COUNTERS = ("dot_interaction", "dot_interaction_bwd")
# cuBLAS's batched GEMM takes 65,535 examples a launch and sums the one
# left over of a 65,536 batch with another kernel, in another order
CUBLAS_BATCH = 65535


def di_counts() -> dict:
    from torchrec_tpu_torch.utils import tracing

    now = tracing.counts()
    return {k: now.get(k, 0) for k in DI_COUNTERS}


def di_moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in di_counts().items()}


def di_bound(B: int, F: int, D: int) -> dict:
    """Least times: forward reads C and writes [B, D + P]; backward reads
    the output's gradient and C and writes dC (f32, each byte once)."""
    n = F + 1
    c_bytes = 4 * B * n * D
    out_bytes = 4 * B * (D + n * (n - 1) // 2)
    fwd, bwd = c_bytes + out_bytes, out_bytes + 2 * c_bytes
    return {"fwd_bytes": fwd, "bwd_bytes": bwd,
            "fwd_bound_ms": fwd / HBM_BYTES_PER_S * 1e3,
            "bwd_bound_ms": bwd / HBM_BYTES_PER_S * 1e3,
            "bound_ms": (fwd + bwd) / HBM_BYTES_PER_S * 1e3}


def di_index_select(dense, sparse):
    """The library yardstick: the same with the triangle taken by
    index_select on the flattened Gram (its backward index_add_)."""
    n = sparse.shape[1] + 1
    combined = torch.cat([dense[:, None, :], sparse], dim=1)
    gram = torch.bmm(combined, combined.transpose(1, 2))
    iu, ju = torch.triu_indices(n, n, offset=1, device=gram.device)
    return torch.cat([dense, gram.flatten(1).index_select(1, iu * n + ju)],
                     dim=1)


def di_inputs(B: int, F: int, D: int, seed: int) -> tuple:
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n = F + 1
    dense = torch.randn(B, D, device=DEVICE, generator=g)
    sparse = torch.randn(B, F, D, device=DEVICE, generator=g)
    grad = torch.randn(B, D + n * (n - 1) // 2, device=DEVICE, generator=g)
    return dense, sparse, grad


def check_interaction(di, B: int, F: int, D: int) -> dict:
    """The kernel against its plain version at one shape: the forward bit
    for bit (but cuBLAS's left-over example) and within D * 2^-24 of the
    float64 products' |a| . |b| scale, the backward within 1e-5 of its
    scale; one launch each way."""
    dense, sparse, grad = di_inputs(B, F, D, SEED + B + F + D)
    before = di_counts()
    out = di.dot_interaction_forward(dense, sparse)
    d_dense, d_sparse = di.dot_interaction_backward(grad, dense, sparse)
    torch.cuda.synchronize()
    if di_moved(before) != {k: 1 for k in DI_COUNTERS}:
        raise AssertionError(f"interaction B={B} F={F} D={D}: launched "
                             f"{di_moved(before)}")
    plain = di.dot_interaction_reference(dense, sparse)
    differ = (out != plain).any(dim=1).nonzero().flatten().tolist()
    exact = di.dot_interaction_reference(dense.double(), sparse.double())
    scale = di.dot_interaction_reference(dense.abs().double(),
                                         sparse.abs().double())
    fwd_err = float(((out.double() - exact).abs()
                     / scale.clamp_min(1e-30)).max())
    want = di.dot_interaction_backward_reference(grad, dense, sparse)
    bwd_err = max(float((g - w).abs().max()) / float(w.abs().max())
                  for g, w in zip((d_dense, d_sparse), want))
    log(f"interaction B={B} F={F} D={D}: forward bit for bit with the "
        f"plain version but examples {differ}, {fwd_err:.3e} of the "
        f"float64 scale (bound {D * 2.0 ** -24:.3e}); backward "
        f"{bwd_err:.3e} of its scale")
    if differ not in ([], [CUBLAS_BATCH]) or fwd_err > D * 2.0 ** -24:
        raise AssertionError(f"interaction forward B={B} F={F} D={D}: "
                             f"examples {differ}, error {fwd_err}")
    if not bwd_err <= 1e-5:
        raise AssertionError(f"interaction backward B={B} F={F} D={D}: "
                             f"{bwd_err}")
    return {"max_abs_err": float((out - plain).abs().max()),
            "differing_examples": differ, "fwd_rel_err": fwd_err,
            "bwd_rel_err": bwd_err}


def time_interaction(di) -> dict:
    """At DI_SHAPE, in turns (kernel, plain version, the composition it
    replaced, the index_select yardstick, then back): forward, backward
    and the two together, each device time beside its bound. The
    composition is the plain forward (cat, Gram bmm, the upper triangle
    gathered, cat) under autograd, whose backward is the gather's sorted
    index_put_ and the bmm's two products."""
    B, F, D = DI_SHAPE
    dense, sparse, grad = di_inputs(B, F, D, SEED + 23)
    d0 = dense.clone().requires_grad_()
    s0 = sparse.clone().requires_grad_()
    graphs = {"composition": di.dot_interaction_reference(d0, s0),
              "index_select": di_index_select(d0, s0)}

    def autograd_bwd(name):
        return lambda: torch.autograd.grad(graphs[name], [d0, s0], grad,
                                           retain_graph=True)

    def both(fwd, bwd):
        return lambda: (fwd(), bwd())

    fwd = {
        "kernel": lambda: di.dot_interaction_forward(dense, sparse),
        "plain": lambda: di.dot_interaction_reference(dense, sparse),
        "composition": lambda: di.dot_interaction_reference(dense, sparse),
        "index_select": lambda: di_index_select(dense, sparse),
    }
    bwd = {
        "kernel": lambda: di.dot_interaction_backward(grad, dense, sparse),
        "plain": lambda: di.dot_interaction_backward_reference(grad, dense,
                                                               sparse),
        "composition": autograd_bwd("composition"),
        "index_select": autograd_bwd("index_select"),
    }
    bnd = di_bound(B, F, D)
    times = {f"{k}_{part}": [] for k in fwd for part in ("fwd", "bwd", "ms")}
    order = list(fwd)
    for turn in (order, order[::-1]):
        for k in turn:
            kernel = DI_KERNELS if k == "kernel" else ""
            times[f"{k}_fwd"].append(device_ms(fwd[k], kernel,
                                               bnd["fwd_bound_ms"]))
            times[f"{k}_bwd"].append(device_ms(bwd[k], kernel,
                                               bnd["bwd_bound_ms"]))
            times[f"{k}_ms"].append(device_ms(both(fwd[k], bwd[k]), kernel,
                                              bnd["bound_ms"]))
    out = {k: sum(v) / len(v) for k, v in times.items()}
    # the kernels' entry as every kernel's: its time, the bound, the plain
    # version's and the library yardstick's
    out.update({"ms": out["kernel_ms"], "library_ms": out["index_select_ms"],
                "turns": times, **bnd,
                "call_ms": cuda_ms(both(fwd["kernel"], bwd["kernel"]), 20),
                "share": bnd["bound_ms"] / out["kernel_ms"]})
    log(f"interaction at B={B} F={F} D={D} (ms, device; in turns "
        f"{times}): kernel forward {out['kernel_fwd']:.5f} (bound "
        f"{bnd['fwd_bound_ms']:.5f}), backward {out['kernel_bwd']:.5f} "
        f"(bound {bnd['bwd_bound_ms']:.5f}), both {out['kernel_ms']:.5f} "
        f"(bound {bnd['bound_ms']:.5f}, {100 * out['share']:.1f} %); plain "
        f"{out['plain_ms']:.5f}, the composition it replaced "
        f"{out['composition_ms']:.5f}, index_select {out['index_select_ms']:.5f}"
        f"; the wrapper calls' stream time {out['call_ms']:.5f}")
    if not out["kernel_ms"] < out["index_select_ms"]:
        raise AssertionError("the interaction kernel is slower than the "
                             "index_select composition")
    return out


def interaction_steps() -> dict:
    """bench.py's DLRM: a train step launches each direction once, a
    request the forward once. Returns the launches counted in each step
    and request."""
    dmp = make_dmp(DEVICE, train=True).init(SEED)
    step, evaluate = dmp.make_train_step(), dmp.make_eval_fn()
    rng = np.random.RandomState(SEED + 23)
    batches = [to_device(make_batch(rng, BENCH_BATCH)) for _ in range(3)]
    step(*batches[0])
    torch.cuda.synchronize()
    launched = {"step": [], "request": []}
    for batch in batches[1:]:
        before = di_counts()
        step(*batch)
        torch.cuda.synchronize()
        launched["step"].append(di_moved(before))
        before = di_counts()
        evaluate(*batch)
        torch.cuda.synchronize()
        launched["request"].append(di_moved(before))
    log(f"interaction launches per DLRM step and request: {launched}")
    want = {"step": {"dot_interaction": 1, "dot_interaction_bwd": 1},
            "request": {"dot_interaction": 1, "dot_interaction_bwd": 0}}
    for kind, moved in launched.items():
        if any(m != want[kind] for m in moved):
            raise AssertionError(f"interaction launches per {kind}: {moved}, "
                                 f"expected {want[kind]}")
    del dmp
    gc_cuda()
    return launched


def interaction_phase() -> dict:
    """Phase 23 (see the module docstring): the interaction's numbers."""
    from torchrec_tpu_torch.ops import dot_interaction as di

    t = time.perf_counter()
    held = {f"B{B}_F{F}_D{D}": check_interaction(di, B, F, D)
            for B, F, D in (DI_SHAPE, *DI_HELD)}
    gc_cuda()
    out = {"max_abs_err": max(h["max_abs_err"] for h in held.values()),
           "held": held, **time_interaction(di)}
    gc_cuda()
    out["launches_on_the_path"] = interaction_steps()
    log(f"interaction phase: {time.perf_counter() - t:.2f} s")
    return out


def interaction_launches(on_path: dict) -> dict:
    """The launches of each counter over the steps and requests of
    bench.py's DLRM that interaction_steps counted."""
    return {k: sum(m[k] for moved in on_path.values() for m in moved)
            for k in DI_COUNTERS}


# -- phase 24: K1j at MLPerf DLRM-DCNv2's lookup ------------------------------

# MLPerf DLRM-DCNv2's ids a feature (recommendation_v2's multi-hot sizes)
DCN_LENGTHS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1,
               12, 100, 27, 10, 3, 1, 1)
DCN_BATCH = 8192  # its per-GPU batch
DCN_CAP, DCN_SHORT_CAP = 100, 17  # no bag cut; bags cut at 17
DCN_ZIPF = 1.05
# one GPU's share of the 8-GPU deployment: each table over 100,000 rows
# split row-wise over the 8 GPUs (ceil(rows / 8) on this one), the
# smaller tables whole
DCN_GPUS, DCN_ROW_WISE_OVER = 8, 100_000
K1J_KERNEL = "tbe_lookup_jagged"  # tbe_lookup_jagged_kernel


def dcn_rows() -> list:
    return [-(-r // DCN_GPUS) if r > DCN_ROW_WISE_OVER else r
            for r in MLPERF_CARDINALITIES]


def dcn_lookup(seed: int) -> tuple:
    """MLPerf DLRM-DCNv2's lookup on one card: (W [R, DIM] f32 drawn
    U(-0.01, 0.01), ids [N] int32 global rows, offsets [26 B + 1] int32),
    bags feature by feature as a KeyedJaggedTensor orders them. Each
    feature's ids are Zipf(DCN_ZIPF) ranks over its table, scattered over
    its rows by a multiplicative hash."""
    from torchrec_tpu_torch.datasets.random import (
        uniform_open,
        zipf_inverse_cdf,
    )

    rows = dcn_rows()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    starts = np.concatenate([[0], np.cumsum(rows)[:-1]])
    values = []
    for r, n, start in zip(rows, DCN_LENGTHS, starts):
        u = uniform_open((DCN_BATCH * n,), gen, torch.device(DEVICE))
        rank = zipf_inverse_cdf(u.double(), torch.tensor(
            float(r), dtype=torch.float64, device=DEVICE), DCN_ZIPF)
        rank = rank.floor().long().clamp(1, r) - 1
        values.append((rank * 2654435761) % r + int(start))
    ids = torch.cat(values).to(torch.int32)
    lengths = torch.tensor(DCN_LENGTHS, dtype=torch.int32,
                           device=DEVICE).repeat_interleave(DCN_BATCH)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=DEVICE),
                         lengths.cumsum(0).to(torch.int32)])
    W = torch.empty((sum(rows), DIM), device=DEVICE).uniform_(
        -0.01, 0.01, generator=gen)
    return W, ids, offsets


def hold_jagged(tl, W, ids, offsets, coeff, cap: int, what: str) -> dict:
    """K1j against K1 on the same bags padded to `cap` (bit for bit) and
    against its plain version (within 2^-20 of each bag's sum of |c| |w|,
    the plain version summing its products in torch's order)."""
    got = tl.tbe_lookup_jagged_forward(W, ids, offsets, coeff, cap)
    flat, c = tl.jagged_padded(ids, offsets, coeff, cap)
    if not torch.equal(got, tl.tbe_lookup_pooled_forward(W, flat, c)):
        raise AssertionError(f"K1j {what}: not bit for bit with K1 on the "
                             f"bags padded to {cap}")
    plain = tl.tbe_lookup_jagged_reference(W, ids, offsets, coeff, cap)
    rows = torch.unique(flat.reshape(-1).long())
    slots = torch.searchsorted(rows, flat.long()).to(torch.int32)
    scale = tl.tbe_lookup_pooled_reference(W[rows].abs(), slots, c.abs())
    err = (got - plain).abs()
    if not bool((err <= 2.0 ** -20 * scale + 1e-30).all()):
        worst = int((err - 2.0 ** -20 * scale).argmax())
        raise AssertionError(f"K1j {what}: element {worst} is "
                             f"{err.reshape(-1)[worst]:.3e} from its plain "
                             f"version, beyond 2^-20 of its scale")
    out = {"bags": int(offsets.shape[0] - 1), "ids": int(ids.numel()),
           "cap": cap, "max_abs_err": err.max().item(),
           "max_rel_to_scale": (err / scale.clamp(min=1e-30)).max().item()}
    log(f"K1j {what}: bit for bit with K1 on the bags padded to {cap}; "
        f"against the plain version {out}")
    return out


def jagged_phase(tl) -> dict:
    """Phase 24 (see the module docstring): K1j held and timed at MLPerf
    DLRM-DCNv2's lookup. Returns K1j's entry of the kernels line."""
    import torch.nn.functional as F

    t0 = time.perf_counter()
    W, ids, offsets = dcn_lookup(SEED + 240)
    NB = offsets.shape[0] - 1
    lengths = offsets[1:] - offsets[:-1]
    bag = torch.repeat_interleave(torch.arange(NB, device=DEVICE),
                                  lengths.long())
    # MEAN over a bag's first DCN_SHORT_CAP ids times a per-sample weight;
    # the ids past the cap carry one too, which the kernel must not read
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 241)
    coeff = ((torch.rand(ids.shape, generator=gen, device=DEVICE) + 0.25)
             / lengths.clamp(min=1, max=DCN_SHORT_CAP).float()[bag])
    held = {"sum": hold_jagged(tl, W, ids, offsets, None, DCN_CAP,
                               "sum, cap 100"),
            "mean_weighted": hold_jagged(tl, W, ids, offsets, coeff,
                                         DCN_SHORT_CAP,
                                         f"mean x weights, cap "
                                         f"{DCN_SHORT_CAP}")}
    del coeff, bag
    gc_cuda()

    flat, c = tl.jagged_padded(ids, offsets, None, DCN_CAP)
    ids_long, offs_long = ids.long(), offsets[:-1].long()
    library = F.embedding_bag(ids_long, W, offs_long, mode="sum")
    library_err = (library - tl.tbe_lookup_jagged_forward(
        W, ids, offsets, None, DCN_CAP)).abs().max().item()
    del library
    b = jagged_bound(W, ids, offsets)
    t = timings(lambda: tl.tbe_lookup_jagged_forward(W, ids, offsets, None,
                                                     DCN_CAP),
                K1J_KERNEL, b["ms"],
                lambda: tl.tbe_lookup_jagged_reference(W, ids, offsets, None,
                                                       DCN_CAP),
                lambda: F.embedding_bag(ids_long, W, offs_long, mode="sum"))
    k1_ms = device_ms(lambda: tl.tbe_lookup_pooled_forward(W, flat, c),
                      K1_KERNELS, b["ms"])
    shape = {"tables_rows": int(W.shape[0]), "dim": int(W.shape[1]),
             "batch": DCN_BATCH, "bags": NB, "ids": int(ids.numel()),
             "distinct_rows": b["rows"], "bytes": b["bytes"],
             "k1_padded_ms": k1_ms, "library_max_abs_err": library_err,
             "held": held}
    log(f"K1j at MLPerf DLRM-DCNv2's lookup ({W.shape[0]} x {W.shape[1]} "
        f"f32, {NB} bags, {ids.numel()} ids, {b['rows']} distinct rows): "
        f"{t['ms']:.5f} ms on the device (call {t['call_ms']:.5f} ms); "
        f"plain {t['plain_ms']:.5f} ms; F.embedding_bag with offsets "
        f"{t['library_ms']:.5f} ms (max abs diff {library_err:.3e}); K1 on "
        f"the bags padded to {DCN_CAP} {k1_ms:.5f} ms; bound "
        f"{b['ms']:.5f} ms ({b['by']}: {b['bytes']} B); kernel at "
        f"{100 * b['ms'] / t['ms']:.1f}% of the bound; phase "
        f"{time.perf_counter() - t0:.2f} s")
    del W, ids, offsets, flat, c, ids_long, offs_long
    gc_cuda()
    return {"max_abs_err": max(h["max_abs_err"] for h in held.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"], "bound_ms": b["ms"],
            "bound_by": b["by"], "mlperf_dcn_shape": shape}


def gc_cuda() -> None:
    """Free what Python no longer holds, so that the next peak counts only
    what is alive."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from torchrec_tpu_torch.ops import dot_interaction as di
    from torchrec_tpu_torch.ops import fused_update_kernels as fk
    from torchrec_tpu_torch.ops import gather_rows as gr
    from torchrec_tpu_torch.ops import quant_lookup as ql
    from torchrec_tpu_torch.ops import tbe_lookup as tl
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType

    card = identify()
    build_kernels([tl.LIBRARY, fk.LIBRARY, gr.LIBRARY, ql.LIBRARY,
                   di.LIBRARY])
    t0 = time.perf_counter()
    dmp = make_dmp(DEVICE).init(SEED)
    torch.cuda.synchronize()
    log(f"DLRM built and initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    served = serve(dmp)
    check_against_cpu(dmp, served["last"])
    results = {"K1": check_kernel(dmp, tl)}
    served_launches = served["launches"]
    del dmp, served

    # each optimizer's training path, its update kernels checked after it
    # on its trained table (one trained DMP on the card at a time)
    trained = {}
    for optim in (EmbOptimType.EXACT_SGD, EmbOptimType.ROWWISE_ADAGRAD,
                  EmbOptimType.ADAGRAD, EmbOptimType.ADAM):
        trained[optim.name] = train(optim)
        dmp = trained[optim.name].pop("dmp")
        if optim is EmbOptimType.ROWWISE_ADAGRAD:
            results.update(check_update_kernels(dmp, fk))
        elif optim is not EmbOptimType.EXACT_SGD:
            results.update(check_moment_kernels(dmp, fk))
        del dmp
    routes = [route_step(*r) for r in ROUTE_STEPS]
    for optim in EmbOptimType:
        if optim is not EmbOptimType.SGD:  # SGD is EXACT_SGD's update
            check_train_against_cpu(optim)

    # the position-weighted DLRM: the DMP's feature-processor branch, K1
    # with learned per-sample weights, K8 in K1's VJP for d_coeff
    pw_served = pw_serve(tl)
    pw_trained = {o.name: pw_train(tl, fk, o) for o in (
        EmbOptimType.EXACT_SGD, EmbOptimType.ROWWISE_ADAGRAD)}
    if not any(t["moved"] > 0 for t in pw_trained.values()):
        raise AssertionError("training moved no position weight")

    # BERT4Rec: serving and training through the sharded EC (K8, K4), K4
    # held at the path's shape, K8 at the path's shape and a bytes-bound
    # one, then the gradients of the unsharded EBC and EC (K1's and K8's
    # autograd Functions)
    seqs = b4r_sequences(np.random.RandomState(SEED + 9))
    b4r_served = b4r_serve(seqs)
    b4r_trained = b4r_train(seqs)
    b4r_dmp = b4r_trained.pop("dmp")
    check_b4r_rowwise(fk, b4r_dmp, b4r_trained["batch_ids"])
    k4h_b4r = check_k4h_b4r(fk, b4r_dmp, b4r_trained["batch_ids"])
    routed = check_routed_gather(b4r_dmp, seqs, b4r_trained["batch"])
    k8 = check_gather_kernel(b4r_dmp, b4r_trained["batch_ids"])
    del b4r_dmp
    results["K8r"] = {k: v for k, v in routed.items() if k != "timed"}
    d_coeff = {k: v for k, v in pw_trained["EXACT_SGD"]["k8"].items()
               if k != "call_ms"}
    results["K8"] = {**{k: v for k, v in k8["ec"].items()
                        if k != "call_ms"},
                     "max_abs_err": max(r["max_abs_err"] for r in
                                        (*k8.values(), d_coeff)),
                     "d_coeff_shape": d_coeff}
    for k, held in (("K1", pw_served["k1"]),
                    ("K3", pw_trained["EXACT_SGD"]["update"]["K3"]),
                    ("K4", pw_trained["ROWWISE_ADAGRAD"]["update"]["K4"])):
        results[k]["position_weighted_shape"] = held
        results[k]["max_abs_err"] = max(results[k]["max_abs_err"],
                                        held["max_abs_err"])
    unsharded_k8 = check_backward()

    # the bf16 DLRM: K1h serving and training, K3h / K4h updating with
    # stochastic rounding
    bf16 = bf16_dlrm(tl, fk)
    results.update(bf16["results"])
    results["K4h"]["bert4rec_shape"] = k4h_b4r
    results["K4h"]["max_abs_err"] = max(results["K4h"]["max_abs_err"],
                                        k4h_b4r["max_abs_err"])

    # SimpleDeepFMNN over bench.py's tables: K1 serving and training, K3 /
    # the fused K4 updating, the warmup schedule and the clipped dense Adam
    dfm = deepfm()

    # bench.py's DLRM trained, quantized to int8 and int4, packaged, loaded
    # and served: Kq per request, directly and through both batching servers
    quant = quant_serving(ql, tl)
    results["Kq"] = quant["Kq"]

    # the flat strategies inside an NCCL group of one rank: the mixed-plan
    # DLRM (K1, K3, K4) and BERT4Rec under DATA_PARALLEL and TABLE_WISE
    # (the routed gather, K4)
    flat = flat_strategies(seqs)

    # the hierarchical strategies, the prefetched step and its pipeline,
    # the position-weighted DLRM and quantized serving inside an NCCL group
    # of one rank (K1, K3, K4, K8, the routed gather, Kq)
    hier = hierarchical(seqs)
    for k, v in hier.items():
        flat[k] = flat.get(k, 0) + v

    # the planner (bench.py's DLRM given no plan), the tower DLRM
    # group-less and inside an NCCL group of one rank, a variable batch
    # and the planned quantized placement (K1, K3, K4, Kq)
    for k, v in planner_towers().items():
        flat[k] = flat.get(k, 0) + v

    # host-resident (UVM) tables: the MLPerf DLRM with its five 40M-row
    # tables in pinned host memory, bench.py's DLRM with 13 of them beside
    # the all-device run, its reshardable checkpoint across plans and the
    # exact resume (K1, K2, K3, K4, K8)
    for k, v in uvm_phase().items():
        flat[k] = flat.get(k, 0) + v

    # the port's examples: the Criteo Kaggle DLRM trained from files and
    # from card-made data, packaged and served, BERT4Rec sharded and
    # data-parallel (K1, K4, the routed gather, Kq)
    for k, v in examples_phase().items():
        flat[k] = flat.get(k, 0) + v

    # every table width: the update kernels at D = 1 to 4096 and on
    # unaligned views, then the Criteo Kaggle DeepFM at D=10 served and
    # trained on every fused route (K1, K2-K7, K1h, K3h, K4h) and served
    # at int8 and int4 (Kq), its kernels and lookups held and timed at
    # D=10, the wide rowwise path at D=1030
    widths = widths_phase()
    for k, v in widths["launches"].items():
        flat[k] = flat.get(k, 0) + v

    # narrow rows: K1, K1h, the row kernel of K2, K3, K3h and the scaled
    # RMW, the fused K4 / K4h, K6 / K7, K8, the routed gather and Kq held at
    # every lane group and timed at D=10 and D=64
    narrow = narrow_phase()
    for part in (widths["results"], narrow):
        for k, v in part.items():
            key = k if k in KERNELS else "K4"  # the scaled RMW's under K4
            into = results[key] if k in KERNELS else results[
                key].setdefault("scaled_rmw", {})
            into.update(v)
            for sub in v.values():
                results[key]["max_abs_err"] = max(
                    results[key]["max_abs_err"], sub["max_abs_err"])

    # the DLRM's dot interaction: held at the paths' shapes, timed at the
    # Criteo Kaggle DLRM's beside what it replaced, launched once a step
    # each way
    interaction = interaction_phase()

    # K1j, the offsets form of K1, held and timed at MLPerf DLRM-DCNv2's
    # lookup
    results["K1j"] = jagged_phase(tl)

    launches = {k: trained[name]["launches"][k]
                for name, ks in STEP_KERNELS.items() for k in ks}
    launches["K4"] += b4r_trained["launches"]["K4"]
    pw_steps = {k: sum(t["launches"][k] for t in pw_trained.values())
                for k in ("K1", "K3", "K4", "K8")}
    launches.update(
        K1=(served_launches + pw_served["launches"] + pw_steps["K1"]
            + dfm["launches"]["K1"] + quant["launches"]["K1"]
            + flat.get("K1", 0)),
        K1j=flat.get("K1j", 0),
        K2=sum(r["K2"] for r in routes) + flat.get("K2", 0),
        K6=launches["K6"] + flat.get("K6", 0),
        K7=launches["K7"] + flat.get("K7", 0),
        K3=(launches["K3"] + pw_steps["K3"] + dfm["launches"]["K3"]
            + quant["launches"]["K3"] + flat.get("K3", 0)),
        Kq=quant["launches"]["Kq"] + flat.get("Kq", 0),
        K4=(launches["K4"] + pw_steps["K4"] + dfm["launches"]["K4"]
            + flat.get("K4", 0)),
        K5=sum(r["K5"] for r in routes) + flat.get("K5", 0),
        K8=unsharded_k8 + pw_steps["K8"] + flat.get("K8", 0),
        K8r=(b4r_served["launches"] + b4r_trained["launches"]["K8r"]
             + flat.get("K8r", 0)),
        **{k: v + flat.get(k, 0) for k, v in bf16["launches"].items()})
    log(f"launches on the paths: K1 serving ({served_launches}), the "
        f"position-weighted DLRM's serving ({pw_served['launches']}) and "
        f"training ({pw_steps['K1']}), K3 EXACT_SGD training of the DLRM "
        f"({trained['EXACT_SGD']['launches']['K3']}) and the "
        f"position-weighted DLRM ({pw_steps['K3']}), K4 ROWWISE_ADAGRAD "
        f"training of the DLRM "
        f"({trained['ROWWISE_ADAGRAD']['launches']['K4']}), the "
        f"position-weighted DLRM ({pw_steps['K4']}) and BERT4Rec "
        f"({b4r_trained['launches']['K4']}), K6 ADAGRAD training, K7 ADAM "
        f"training, K2 the three w_impl=write steps, K5 ROWWISE_ADAGRAD's "
        f"w_impl=write step, K8 the position-weighted DLRM's d_coeff "
        f"({pw_steps['K8']}), the unsharded EBC's backward and EC's "
        f"forward ({unsharded_k8}), the routed gather (K8r) BERT4Rec serving "
        f"({b4r_served['launches']}) and training "
        f"({b4r_trained['launches']['K8r']}); K4's scaled RMW "
        f"{sum(r[SCALED] for r in routes)} in the mom_impl=xla step, the "
        f"routed gather's route-only mode {b4r_trained['launches'][ROUTE]} "
        f"in BERT4Rec's updates, K1h the bf16 DLRM's serving and training, "
        f"K3h its EXACT_SGD and K4h its ROWWISE_ADAGRAD training; K1, K3 and "
        f"K4 also the DeepFM's serving and training ({dfm['launches']}), K1 "
        f"and K3 the quantized phase's training and f32 server, Kq its "
        f"quantized requests and servers ({quant['launches']}); K1, K3, K4 "
        f"and the routed gather also the flat-strategies and hierarchical "
        f"phases, with K8 and Kq the latter's, K1, K1j, K3, K4 and Kq the "
        f"planner phase's, and K1, K1j, K2 (staging), K3, K4 and K8 "
        f"(write-back) the UVM phase's, K1, K4, the routed gather and Kq "
        f"the examples', and K1, K1j, K2-K7, K3h, K4h, the scaled RMW and "
        f"Kq (its int8 and int4 requests) the D={KD_DIM} DeepFM's ({flat}): "
        f"{launches}")
    log(card["smi"])
    log(json.dumps({"kernels": [{
        "name": KERNELS[k][0],
        "route": "cuda",
        "source": KERNELS[k][1],
        "replaces": KERNELS[k][2],
        "launches": launches[k],
        **results[k],
    } for k in sorted(KERNELS)] + [{
        # launched by bench.py's DLRM in the steps and requests that
        # interaction_steps counted
        "name": "dot_interaction",
        "route": "cuda",
        "source": "torchrec_tpu_torch/csrc/dot_interaction.cu",
        "replaces": "no pl.pallas_call: the einsum and triu_indices gather "
                    "of torchrec_tpu/models/dlrm.py:73, left to XLA",
        "launches": interaction_launches(
            interaction["launches_on_the_path"]),
        **interaction,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
