#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, traceback, no result):
  1. device: require CUDA, print the card's name and power limit, TF32 off;
  2. build: compile the CUDA kernels of paddle_tpu_torch/csrc from this checkout,
     print ptxas's registers and spills of each kernel and what the card makes
     of each attention kernel (CTAs an SM, registers, shared bytes, spills);
  3. kernels: hold every kernel against its plain PyTorch version on the card,
     float32 and bfloat16, at the shapes BERT-base serving and training give
     them (backward reductions also run twice and must agree bit for bit; the
     bfloat16 attention forward and gradients, the LayerNorm backward's
     column sums and the bias+GELU backward's dx and dbias element by
     element; the LayerNorm forward and the bias+GELU backward into
     NaN-poisoned memory and also at the seq-2048 rows [16384, .]; the
     cross-entropy forward into NaN-poisoned memory, twice bit for bit, at
     [4096|16384, 30522] with MLM labels and ResNet's [256, 1000]; NMT's
     LayerNorm over 512 and bias+ReLU over 2048, forward and backward, at
     2048 and 2047 rows into NaN-poisoned memory; the row
     kernels' device time split by launch), and
     time kernel, plain version and one PyTorch library call (CUDA events,
     median); the attention forward, dQ and dK/dV kernels also at seq 2048,
     long causal, causal with Lq < Lk and Lq > Lk, dh 128 and rows whose max
     moves late, within 1/8 of a score tensor of extra memory at kv >= 2048;
  4. serve: build BERT-base at full width in bf16, save it, load it through
     AnalysisConfig / create_predictor on cuda:0, eager and graphed predictors
     in turns (eager, graphed, eager, graphed), 3 requests at batch 1, 8 and
     32 each turn, timed as run and fetch; every request launches the
     LayerNorm, bias-act and attention forward kernels exactly 25, 12 and 12
     times (a graphed predictor: its first request at a batch eagerly, its
     second captures them into a CUDA graph, later ones replay it, and a
     profiled replay shows the 25, 12 and 12 kernels); the graphed logits
     equal the eager ones within 5e-2; a batch-32 fetch is staged through
     pinned host memory;
  5. parity: a float32 BERT-base (2 layers) served on the card and on the CPU
     (plain path) must agree to 1e-3 in the logits;
  6. train: bf16 BERT-base at full width (12 layers, unfused attention,
     dropout 0.1) with Adam(1e-4).minimize(loss) trains 6 steps through
     Executor(CUDAPlace(0)).run on one fixed batch of 32 x 128: the loss is
     finite and falls, and every step launches each kernel exactly as often as
     the program has ops for it (LN 25 + 25, bias-act 12 + 12, xent 1 + 1,
     Adam 198); from the second step on the step is a CUDA graph's replay,
     and one more step, profiled, must show exactly those kernels;
  7. train parity: a float32 BERT-base (2 layers, dropout 0) trained 3 Adam
     steps on the card and on the CPU from the same numpy state must agree in
     the losses (1e-3), in every parameter (1e-5, save where the CPU's
     gradient is 0 to rounding: 2*lr*steps + 1e-5) and in the moments (1e-4
     of the largest of their kind);
  8. resnet_serve: bf16 ResNet-50 at full width (224 x 224, 1000 classes,
     space-to-depth stem, fuse_bn_relu) saved for inference and served
     through AnalysisConfig / create_predictor on cuda:0, 3 requests at batch
     1, 32 and 256 (graphed from the second; one more at 256 profiled): every
     request launches the BN epilogue forward exactly 53 times and no other
     kernel;
  9. resnet_parity: a float32 ResNet-50 served on the card and on the CPU
     from the same saved model must agree to 1e-3 in the logits;
 10. resnet_train: bf16 ResNet-50 at full width with Momentum(0.1, 0.9)
     trains 6 steps at batch 256 through Executor(CUDAPlace(0)).run on one
     fixed batch: the loss is finite, falls on the first step and ends below
     where it started, the running statistics move,
     and every step launches the BN epilogue forward and backward 53 times
     each and the cross-entropy forward and backward once, as the program's
     ops say; graphed from the second step (Momentum's velocities and the
     running statistics are copied back inside the graph); one more step
     profiled;
 11. resnet_train_parity: a float32 ResNet-50 (batch 8, lr 0.01) takes 3
     Momentum steps on the CPU; each step also runs on the card from the
     CPU's state before it, and the two must agree in the loss, the running
     statistics, and each velocity and parameter update (resnet_train_parity
     says why per tensor in L2);
 12. train_fused: phase 6 with the fused_attention op (the JAX package's
     benchmark configuration, tools/bench_kit.py:184-187): every step also
     launches the attention forward, dQ and dK/dV kernels 12 times each;
     eager and graphed in turns (eager, graphed, eager, each from the
     startup's seed): warm step, tokens a second, idle share, ATen calls a
     step and peak memory of each; its graphed arm's losses and state are
     kept for phase 75, whose three graphed arms must agree with it bit for
     bit (dropout 0.1);
 13. train_long: the same at seq 2048, batch 8 (16,384 tokens a step), with
     peak memory and sequences and tokens per second;
 14. train_fused_parity: phase 7 with the fused_attention op at batch 32 x 128
     and 1 x 2048 (the CPU arms run on a thread beside the kernels' build
     and phase 3, as phase 55's BERT's);
 15. deepfm_train: DeepFM at full width (26 fields, vocab 200,000, embed 16,
     MLP 400 x 3, float32, tools/donation_audit.py:128-132) at batch 4096
     with is_sparse tables: 6 Adagrad(0.05) steps through
     Executor(CUDAPlace(0)).run on one fixed batch (SelectedRows gradients;
     only the touched rows of the tables and moments change; no kernel), then
     6 steps of the default, densifying Adam (the Adam kernel 10 times a
     step, as the program's ops say); the loss is finite and falls; both plans
     are refused a CUDA graph (SelectedRows gradients) and run eagerly, the
     reason printed; then the
     model is saved and served through create_predictor at batch 1 and 4096,
     as the Executor's test program computes it;
 16. deepfm_train_parity: float32 DeepFM (MLP 64 x 64), 3 Adagrad and 3
     lazy_mode Adam steps from one numpy state on the card twice (bit for
     bit) and on the CPU (losses 1e-5 relative, every persistable 1e-5 of
     its largest magnitude);
 17. nmt_train: Transformer-base NMT at full width (vocab 8000, d 512, 6 + 6
     layers, 8 heads, d_ff 2048, dropout 0.1, label smoothing 0.1,
     Adam(noam_decay(512, 400, 2.0), beta2 0.997, epsilon 1e-9); the JAX
     package's benchmark configuration, tools/bench_kit.py:223-225) trains 6
     steps on its benchmark's ragged batch (32 pairs of LoDTensors, lengths
     20-63, bucket 64) through Executor(CUDAPlace(0)).run, float32 then
     bfloat16, each eager and graphed in turns as phase 12: finite losses,
     the first step (lr 0) leaves every parameter bit for bit unchanged,
     every step launches LN 30 + 30, bias+ReLU 12 + 12 and Adam 256 (no
     xent, no attention kernel: the soft-label loss and the attention are
     composites), the two graphed runs agree bit for bit; one more step of
     each under torch.profiler;
 18. nmt_train_parity: float32 NMT at full width with 2 + 2 layers, dropout
     0, 3 Adam steps on 4 ragged pairs on the card and on the CPU from one
     numpy state (phase 7's tolerances; the step counter and the beta pows
     equal);
 19. nmt_decode: build_beam_decode at full width (batch 32, src_len 64, beam
     4, max_len 64: the encoder once, then a While over the full decoder and
     one beam_search step) with phase 17's float32 weights through
     Executor.run: one decode launches the LN forward 12 + 18 x iterations
     and the bias+ReLU forward 6 + 6 x iterations times, and no backward
     kernel; the plan is refused a CUDA graph (the While reads its condition
     on the host), the reason printed; one more decode under torch.profiler;
 20. nmt_decode_parity: the 2-layer weights of phase 18 decode 4 sentences
     (beam 4, max_len 16) on the card and on the CPU (ids equal, scores
     within 1e-4, the smallest top-k margin printed), also with proj.b[eos]
     lifted so that beams finish at different steps and the loop leaves
     early; on the card the compiled decode gives the host loop's ids;
 21. graph_parity: 3 Adam steps graphed against 3 eager on the card from one
     numpy state, by phase 7's tolerances: float32 BERT-base with 2 layers
     (fused attention, dropout 0, batch 8 x 128) and float32 NMT 2 + 2 (phase
     18's batch); says whether they agree bit for bit; then conv_order:
     tiny MNIST with Momentum, 4 steps in two eager and two graphed arms,
     under cuDNN's default and its deterministic algorithms, each pair's
     largest difference printed (graphed = eager held under deterministic);
 22. executor_depth: bf16 BERT-base at 32 x 128 (fused attention, dropout
     0.1), six batches: steps=4 over the first four equals four graphed runs
     bit for bit (losses and every persistable), pipeline.train_loop with
     max_inflight 2 over the six equals the six runs' losses bit for bit;
 23. remat_parity: BuildStrategy.memory_optimize against none, both graphed,
     3 Adam steps of float32 BERT-base with 2 layers, dropout 0.1, batch 8 x
     128, by phase 7's tolerances, with each arm's peak memory;
 24. train_clipped: phase 12 as BERT fine-tuning runs it, Adam(1e-4) with
     L2Decay(0.01) under set_gradient_clip(GradientClipByGlobalNorm(1.0)),
     the program built with the port's own layers and inferred shapes: the
     clip and decay tail (~200 square + reduce_sum, one sum / sqrt / max /
     div, ~200 elementwise_mul, ~200 scale + sum) takes no kernel, so a
     step's launches stay exactly phase 12's; eager and graphed in turns,
     with phase 12's numbers and the verifier's span and counters;
 25. train_clipped_parity: phase 7 with the clip and decay (fused
     attention), the global norm fetched each step and above 1.0 at some
     step; then the fit-a-line program, 50 SGD steps, card vs CPU within
     1e-5, the loss falling;
 26. checkpoint_resume: phase 24's path with dropout 0: 3 steps,
     io.save_persistables, a fresh Scope, io.load_persistables, 3 steps,
     against 6 steps straight through: losses and every persistable bitwise
     equal, the save's and the load's seconds and bytes printed;
 27. loader_resnet: phase 10's ResNet-50 from a RecordIO file of 8 batches of
     uint8 224 x 224 x 3 images: reader.shuffle(seed=0) -> batch ->
     map_readers (float32 NCHW) -> DataLoader(capacity=4, pinned staging, a
     side stream) -> pipeline.train_loop(max_inflight=2), against the same
     batches as numpy feeds through Executor.run, in turns (numpy, loader,
     numpy, loader): warm step, images/s, executor.dispatch, reader.wait
     (total, share of the wall), reader.bytes_staged and a profiled step's
     idle share each; launches held every step; all arms' losses bitwise
     equal under cuDNN's deterministic algorithms; one 154 MB batch's
     upload pinned against pageable;
 28. dataset_deepfm: phase 15's DeepFM from 4 batches of 4096 slot records
     over two RecordIO files through QueueDataset (one thread) and
     Executor.train_from_dataset, 4 Adagrad steps, against the same batches
     through Executor.run: losses and every persistable bitwise equal, the
     touched rows moved and no other; a second pass from the dataset's
     state after batch 2 yields batches 3-4; examples/s of both;
 29. resilient_resnet: phase 27's model and source under
     resilient_train_loop with CheckpointManager(save_every_steps=4),
     nan_mode skip_step, through bad_batch@2;nan@5;device@8:UNAVAILABLE;
     device@10:RESOURCE_EXHAUSTED;preempt@13, then a resume in a fresh
     Scope and Executor to step 16: one of each in ResilienceStats,
     max_inflight halved, every dispatch's launches held, the persistables
     bitwise equal to a clean run over the surviving batches (cuDNN's
     deterministic algorithms); wall times, checkpoint seconds and bytes;
 30. resilient_bert: phase 12's BERT-base (dropout 0.1) on token ids from a
     RecordIO file through a shuffled, checkpointable reader and, in the
     chaos and resume runs, a DataLoader on the card (three feeds of one
     shape and dtype), resilient_train_loop with preempt@5, then a resume
     to step 10: losses and every persistable, the generator's state
     included, bitwise equal to 10 straight steps fed from numpy; launches
     FUSED_PER_STEP for each eager or captured step; the preemption's
     drain writes the flight recorder's BLACKBOX.p0.json, reason
     "sigterm_drain";
 31. se_resnext_train / se_resnext_serve: SE-ResNeXt-50 (224 x 224, 1000
     classes, float32 as built, Momentum 0.1 / 0.9) trains 6 steps at batch
     64 through Executor(CUDAPlace(0)).run, eager then graphed (train_arm:
     each step's launches held, the monitor read, a profiled step; the
     first step lowers the loss, the lowest is below the first, the running
     statistics move), every step launching the BN epilogue 53 + 53 times
     and the xent 1 + 1, as the program's ops say; then, its batch norms
     calibrated, saved by save_inference_model and served through
     create_predictor at batch 1 and 64 (53 BN epilogue launches a request);
 32. vgg_train / vgg_serve: phase 31 for VGG-16 (Adam): BN epilogue 13 +
     13, xent 1 + 1, Adam 60 a step, 13 a request;
 33. lstm_train: the stacked dynamic LSTM (3 layers, embedding and hidden
     512, vocab 5000, Adam) on 32 ragged sentences of 20-128 tokens (bucket
     128), eager then graphed: xent 1 + 1, Adam 15 a step;
 34. word2vec_train: word2vec at the builder's sizes, batch 256, eager then
     graphed: xent 1 + 1, Adam 5 a step;
 35. vision_parity: card against CPU at reduced size: the conv nets' test-mode
     logits at 64 x 64, batch 2 (1e-3 * max(1, max|logits|)) and 3 steps
     each from the CPU's state at batch 4 by phase 11's rule
     (conv_step_shares); the LSTM (width 128, 8 sentences of 5-32) and
     word2vec: test-mode logits (1e-4 * max(1, max|logits|)) and 3 Adam
     steps by phase 7's rule;
 36. profiled_trace: phase 31's graphed step under
     profiler.profiler(state="All", trace_dir=...): the Chrome trace names
     every kernel of the step's launches and holds the executor's spans;
     the Prometheus page and the summary table are not empty;
 37. train_lamb: phase 12 with Lamb(lamb_weight_decay 0.01, epsilon 1e-6) on
     linear_lr_warmup(polynomial_decay(1e-3, 1000, 0, 1), 2, 0, 1e-3), eager
     and graphed in turns: launches FUSED_PER_STEP with Adam 0, the graphed
     runs bitwise equal, the loss falling; the LAMB tail's kernels and
     device time from a profiled replay against the same step without
     updates (lamb_tail);
 38. resnet_lars: phase 10 with LarsMomentum(0.9, lars_coeff 0.001,
     lars_weight_decay 5e-4) on cosine_decay(0.1, 5, 90), graphed, launches
     RESNET_PER_STEP, phase 10's loss rule;
 39. seq2seq_train: Fluid's benchmark machine_translation (seq2seq with
     attention, a DynamicRNN decoder) at full width (512, vocabularies
     30,000, f32, Adam 1e-3) on 32 ragged pairs of 10-60 tokens (bucket 64),
     eager then graphed: sentences and real target tokens a second, idle
     share, ATen calls, peak memory; Adam launches = the program's 26
     parameters a step;
 40. optim_parity: card vs CPU, f32: seven optimizers 3 steps on an MLP by
     phase 7's rule, dgc / proximal_gd / proximal_adagrad as one-op runs,
     dpsgd's noise moments, BERT 2 layers with LAMB (phase 7), ResNet-50 at
     phase 11's size with LARS (phase 11), EMA and ModelAverage apply /
     restore under a captured graph (bit for bit back), the seven
     learning-rate schedules over 8 runs;
 41. ragged_parity: card vs CPU: the seq2seq at width 64 (3 Adam steps,
     phase 7's rule), a CRF tagger (NLL 1e-4, paths equal), dynamic_gru,
     dynamic_lstmp, lstm, warpctc, a StaticRNN, cond and the arrays; the
     cond and array plans refused a CUDA graph with their reason;
 42. bert_bf16_scores: phase 12 with attention_score_dtype="bfloat16"
     (launches FUSED_BF16_SCORES_PER_STEP: the bf16-score kernels), graphed
     runs bitwise equal; served at batch 32, run_ms; then phase 13 with bf16
     scores (8 x 2048, graphed), its warm step beside phase 13's;
 43-46. ssd_train, ssd_serve, yolov3_train, yolov3_serve: MobileNet-SSD
     (300 x 300, 21 classes, batch 64, RMSProp) and YOLOv3 on DarkNet-53
     (608 x 608, 80 classes, batch 8, Momentum + L2Decay), f32, eager then
     graphed 6 steps (loss falling, no graph refusal, BN-epilogue launches
     as read off the program), served at batch 1 / 64 and 1 / 8 through
     create_predictor with their NMS heads, [N, keep_top_k, 6];
 47. detection_parity: card vs CPU: a tiny SSD, a 2-layer YOLOv3 head, the
     Faster R-CNN second stage and the RetinaNet head (3 Momentum steps
     and their outputs), every one-op case of models/detection_cases.py,
     and the graph refusals of print, py_func and detection_map;
 48. tail_parity: card vs CPU, every one-op case of models/tail_cases.py
     (the ops of misc_ops and tail_ops, phase 47's rule), the random ones on
     the card by their moments, and the graph refusals of chunk_eval and
     merge_selected_rows;
 49. tagger_train: the CRF tagger (build_crf_tagger: 128-wide token
     features, 9 IOB tags) with chunk_eval on its Viterbi path, 6 Adam steps
     on 64 ragged sentences, eager (its plan refused a graph with
     chunk_eval's reason), Adam 3 a step, loss falling and F1 rising;
 50-51. word2vec_nce_train, word2vec_hsigmoid_train: phase 34's word2vec
     (dict 1,000, embedding 32, hidden 64, 4 words, batch 256) with its
     softmax head replaced by nce (5 negatives) and by hsigmoid, eager then
     graphed, Adam 5 a step; the four phases' total seconds printed;
 52. bert_f16_amp: BERT-base at full width in float16 (12 layers, fused
     attention, dropout 0.1, 32 x 128), build_bert(dtype="float16",
     with_optimizer=False) under contrib.mixed_precision.decorate(Adam(1e-4))
     at the decorator's defaults, 6 steps eager then graphed: warm step,
     tokens/s, idle share of a profiled step, peak memory, the loss and the
     loss scale each step; launches exactly FUSED_PER_STEP (the kernels'
     float16 instantiations, Adam on the float32 master weights); the graph
     captured with no refusal; the loss falling;
 53. bert_f16_overflow: the same from a loss scale of 2^32 halved at every
     overflow, graphed, until 3 steps have applied: every skipped step
     leaves every parameter, moment and beta pow bit for bit, every
     applied one moves them, and the scale and the two step counters follow
     update_loss_scaling's state machine exactly; the skipped steps counted;
 54. resnet_f16_amp: ResNet-50 float16 at batch 256 under
     decorate(Momentum(0.1, 0.9)), 6 steps graphed: warm step, images/s,
     peak memory; BN epilogue 53 + 53 and xent 1 + 1 a step; phase 10's
     loss rule over the steps an applied update leads to;
 55. amp_parity: card vs CPU: BERT 1 layer float16 with AMP at 2 x 128
     (dropout 0; the host's float16 matmuls set the size; the CPU arm runs
     on a thread beside the kernels' build and phase 3), 3
     steps, the second forced to overflow through the scope's
     loss_scaling_0 (every state bit for bit on both sides), held by
     AMP_BERT_PARITY; and
     ResNet-50 float16 with AMP at phase 11's batch of 8 and phase 35's
     64 x 64 from a scale of 2^10 (AMP_RESNET_PARITY), 3 steps one at a
     time, each also taken in float32 on the CPU: the card's float16 error
     from the float32 step at most AMP_RESNET_RATIO times the CPU's, and
     that rule refuses a step with half the batch, with half the momentum,
     and a frozen one; the AMP vars exactly equal; phases 52-55's seconds
     printed;
 56. serving_bert: BERT-base bf16 at full width (12 layers, fused
     attention, seq 128; the encoder's hidden states [rows, 128, 768] are
     the served output) loaded into serving.ModelRegistry(CUDAPlace(0))
     under Server(buckets 1-32, workers=2) and warmed: each bucket's plan
     graphed, 2 x 6 x (25, 12, 12) launches (a warm-up and a capture a
     bucket); 4 client threads submit 400 requests of seeded 1-32 rows:
     each response within 5e-2 of a direct eager Predictor.run of it
     alone, no capture, no plan and no wrapper launch under the traffic,
     the ledger balanced with no shed and no error, a profiled replay 25,
     12 and 12 kernels; requests/s, rows/s, p50 / p99, pad and queue-wait
     fractions printed;
 57. serving_admission: max_queue 8, a burst of 64: 56 shed as overload,
     3 deadlines lapse in the queue as timeout while their batch
     proceeds, a 33-row request refused at the door; the ledger and every
     trace's outcome and reason code exact;
 58. serving_publish: the served BERT-base fine-tuned 2 steps (Adam
     PUBLISH_LR) under a CheckpointManager, its committed checkpoint
     published weights-only into phase 56's server while 4 clients keep
     submitting: nothing dropped, each response the old or the new
     version's direct output, every one submitted after the swap the new;
     rollback restores the old outputs; the served model saved with a NaN
     weight, and a copy with a truncated shard, rejected and quarantined
     while the old version serves on; p99 during the publish beside phase
     56's;
 59. serving_budget: BERT-base and ResNet-50 (phase 8's model) under a
     budget that holds either but not both: loading the second evicts
     the first, the executor keeps no plan of it, its weights are freed
     and memory_allocated comes back to within BUDGET_MARGIN_BYTES of the
     survivor alone (an unload too); a load
     with nothing to evict raises hbm_budget; each model's
     plan_model_bytes at 32, ledger bytes and allocator deltas printed;
 60. serving_parity: a float32 BERT (2 layers) served by a Server on the
     card and one on the CPU, the same 12 requests (two shed, one timed
     out): responses within 1e-3, ledgers and trace outcomes equal;
     phases 56-60's seconds printed.
Before the fleet phases the process drops what phases 56-60 held, releases
the allocator's cached blocks and prints torch.cuda.mem_get_info().
 61. fleet_serve: phase 56's BERT-base saved with the first token's hidden
     state [rows, 1, 768] as its output (a slice of the encoder's) and
     served by ServingFleet(n_replicas=2, buckets=(1, 8, 32)) on the card:
     two replica processes, each a Server with its own CUDA context, behind
     the router and its JSON wire; 4 clients send 400 requests of 1-32 rows
     through fleet.infer: each response within 5e-2 of a direct eager run,
     requests == completed with no error, both replicas served, each
     replica's replica_up record shows the LayerNorm, bias-act and
     attention forward launched (a warm-up and a capture a bucket);
     boot-to-healthy seconds, requests/s, rows/s, router p50 / p99,
     completed per replica, the ledger and each replica's largest sampled
     allocated bytes printed beside phase 56's requests/s and p99;
 62. fleet_roll: rolling_publish of the fleet model with phase 58's
     committed checkpoint weights while 4 clients submit: nothing dropped,
     each response the old or the new version's direct eager output (the
     nearer in L2, within 5e-2 and a quarter of their distance), every one
     submitted after the roll the new; both replicas active on it and
     ACTIVE.json naming it; then a roll of phase 58's NaN-weight snapshot
     halts at the first replica (roll_halted, roll_rolled_back), leaves its
     quarantine marker, and no response comes from it;
     tools/serve_trace.py --fleet --check and tools/perf_report.py --check
     router.jsonl --check-roll-convergence pass over the fleet's telemetry;
     the roll's seconds and the p99 during it printed beside phase 61's;
 63. fleet_kill: SIGKILL replica 1 under load: the only errors are
     replica_down, at most its inflight cap; the survivor serves the new
     traffic; replica_dead and replica_restarted appear; the restarted
     replica reaches healthy on the rolled version and its responses meet
     phase 61's rule; fleet.stop() drains both replicas (exit 0, nothing
     shed), requests == completed + errors exactly, and each incarnation
     that drained launched nothing under traffic (its replica_drained
     count is its replica_up count plus a warm for each version it
     staged); the seconds to detect the death and from restart to healthy
     printed; phases 61-63's seconds printed.  The kernels line's path
     serving_fleet sums the replicas' records.
 64. quant_serving: phase 56's bf16 encoder dir loaded into a scope of its
     own on the card and saved by io.save_quantized_inference_model
     (per-tensor post-training int8, served in bf16); a Server of its own
     (phase 56's buckets and workers) loads the bf16 dir and serves 400
     requests of 1-32 rows twice, then the int8 dir is published over it while
     4 clients submit: nothing dropped, each response one version's direct
     eager output by phase 58's rule, one quant_parity event within the
     default FLAGS_serving_quant_atol, precision "int8->bfloat16" after;
     every weight the quant manifest names is bitwise (q * scale / qmax)
     in bf16, computed in numpy from the dir's own files; the int8
     version serves the same 400 requests twice, each within 5e-2 of a
     direct eager run of the int8 dir, launching nothing (the publish's smoke and
     warm launch the LayerNorm, bias-act and attention forward); a copy of
     the int8 dir with its scales times 37 is rejected on the parity rung
     and quarantined while the int8 version serves on bit for bit;
     tools/perf_report.py --check --require-quant-parity passes over the
     publish's telemetry; the quantize-and-save seconds, both dirs' bytes,
     the publish seconds, the versions' bytes and precisions, and each
     version's requests/s and p99 printed;
 65. qat_resnet: the bf16 ResNet-50 training program (Momentum, batch 256)
     instrumented by slim.quant_aware (channel-wise weights, no
     activations: 54 fake-quantize ops) takes 4 steps, graphed from the
     second: finite losses, the BN epilogue 53 + 53 and the cross-entropy
     1 + 1 a step; the step's time printed beside phase 10's plain step;
     then the forward-only program, instrumented the same way, its running
     statistics calibrated on the batch, is deployed by
     save_quantized_inference_model (int8 -> bf16) and create_predictor on
     the card: each fake-quantized weight lies on its per-channel int8 grid,
     each deployed weight within one bf16 ulp of it (the instrumented op
     computes in float32 and the conv casts to bf16; the deploy dequantizes
     into bf16 once), the deployed logits of a 32-image batch within 5e-2 *
     max(1, max|logits|) of the instrumented test-mode forward (phase 8
     holds only finiteness: this is the rule for a deployed ResNet), 53 BN
     epilogue launches a request; phases 64-65's seconds printed.
 66. dygraph_resnet: ResNet-50 in dygraph (dygraph_cases.resnet: Conv2D +
     BatchNorm bottlenecks [3, 4, 6, 3], widths 64-2048, a 7 x 7 stem,
     Pool2D, Linear to 1000 classes), f32, under dygraph.guard() (no place:
     cuda:0), batch 32 at 224 x 224, Momentum 0.9 on a PiecewiseDecay from
     0.1, 6 steps on one batch: warm step (median of steps 3-6), images/s,
     tape entries a step, peak memory, idle share and host ATen calls of a
     profiled step; phase 10's loss rule; no kernel of the port launched;
 67. dygraph_ptb: the medium PTB LSTM language model (2 x BasicLSTMUnit at
     650, vocab 10,000, 35 steps, batch 20, Dropout 0.5, uniform +-0.05),
     GradClipByGlobalNorm(5) written back, SGD on a PiecewiseDecay at 1.0,
     6 steps on one batch of seeded ids: warm step, tokens/s, tape entries,
     peak memory, idle share; finite losses, the last below the first, no
     kernel launched;
 68. dygraph_parity: card against CPU in f32, a guard per evaluation: the
     layer, functional, optimizer (the nine eager rules, Lamb, DGC), clip
     and rnn-cell cases of dygraph_cases (1e-5 of max(1, |CPU|)); ResNet-50
     at 64 x 64, batch 4, 3 steps each from the CPU's state (phase 11's
     rule); the PTB model at width 64, vocab 200, 10 steps, batch 4, 3 steps
     with dropout (phase 7's rule); its state saved on the card and loaded
     on the CPU bit for bit; no kernel launched; phases 66-68's seconds.
 69. host_table_deepfm: phase 15's DeepFM at full width (26 fields, vocab
     200,000, embed 16, MLP 400 x 3, batch 4096, f32) with both tables on
     a supervised pserver child (`python -m paddle_tpu_torch.param_server`,
     the card hidden from it; SGD 0.05, a snapshot every 64 ops), each a
     TieredEmbedding whose hot quarter trains in this process: 32 steps of
     deepfm_feed batches under resilient_train_loop (max_inflight 1), the
     loader pulling the rows, the device step deepfm_net's arithmetic over
     the two pulled blocks with Adam(1e-3) on the 8 MLP parameters (Adam 8
     launches a step, as read off the program, held run by run and on a
     profiled replay), on_logged pushing each table's row gradient, the
     publish hook exporting both tables every 8 steps into a card
     ModelRegistry serving deepfm.build(is_sparse=True)'s test program
     (served predictions within 1e-5 of an Executor run on the exported
     tables); the loss finite and falling; examples/s, the step's wall
     split into lookup (its pull RPCs apart), the Executor and the loop,
     and apply_grad (its push RPCs apart, and a probe: a record the size
     of the V push appended with and without its fsync), cold rows and
     bytes a step, the profiled step's device busy and idle share, the
     pserver child's op count and snapshots as its beat reports them,
     publish seconds and staleness, graphed;
     perf_report --check --max-publish-staleness-steps 16
     --max-host-lag-steps 8 on the metrics stream;
 70. host_table_chaos: phase 69 under kill_pserver@18;rot_row@1 (KVClient
     retries 8 from 0.2 s, no degraded mode): 32 steps, the child
     restarted, the rotted second publish rejected and quarantined with
     the first version serving on, every hot row, cold row and MLP
     parameter bitwise equal to phase 69's; the same gates;
 71. host_table_parity: f32 at DEEPFM_PARITY (MLP 64 x 64), batch 512, 3
     steps, pull after push, over in-process ParameterServers: card against
     CPU (Adam; phase 16's rule) and, on the card, SGD(0.05) everywhere
     against the in-program deepfm.build(is_sparse=True) (losses 1e-5
     relative, tables and parameters 1e-5 of their largest);
 72. chaos_campaign: chaos.run_campaign over train, online and serving at
     seed 20 on the card and on the CPU (no violation, the same specs and
     verdicts, perf_report --check --max-chaos-violations 0 on the card's
     metrics), then the planted defect at seed 8: caught and shrunk to
     <= 2 faults on the CPU, and on the card the whole arm giving the
     same; phases 69-72's seconds.
 73. cost_model: the training programs of phases 10, 12, 13, 15 and 17
     (COST_PROGRAMS), planned by core/resource_plan.py at their phases'
     feed shapes on start_cpu_arms' thread: FLOPs, bytes moved and the
     roofline step on the H100 chip model, the plan's peak beside the
     allocator's peak the phase measured, the measured MFU from the
     phase's own warm step (no step runs again) and roofline / measured
     step; every op type priced by its own rule (coverage 1.0) and each
     MFU in (0, 1];
 74. precheck: phase 13's program at 128 x 2048 through a fresh Executor
     raises ResourceError before anything of the step is allocated (the
     card's total as the limit, analysis.resource_blocked + 1, no miss
     counted, no plan cached, the allocator back where it was, the call's
     peak within the uploaded feeds + 4 KiB), and at 8 x 2048 under
     FLAGS_resource_hbm_limit_mb at half its plan; every plan-cache miss of
     the process was priced (analysis.plan's calls = the misses + the
     refusals, across the monitor's resets); install_check.run_check() on
     the card.
 75. dp_world1: phase 12's program through
     CompiledProgram.with_data_parallel, then with_grad_overlap serial and
     bucketed, at world size 1, 6 steps an arm graphed from the second:
     every loss and persistable bit for bit phase 12's graphed arm's,
     FUSED_PER_STEP a step, each arm's warm step beside phase 12's;
 76. dp_gang_card: a gang of 2 ranks on the one card over gloo
     (launch.run_gang of this script with --dp-rank; the ranks start up
     while phase 75 runs and load the library this process built): bf16
     BERT-base at 32 x 128, 16 rows a rank, 6 steps (parameters equal
     before, losses and every persistable equal across the ranks after,
     FUSED_PER_STEP a step on each rank, the graph refused, the loss
     falling; warm step, tokens a second, the sync's ms and bytes, the
     backend, start-up seconds), f32 BERT 2 layers at 8 x 128 in the three
     modes held by phase 7's rule to a world-size-1 run of the global batch
     (serial and bucketed bit for bit), and a conv + batch-norm net's global
     and rank-meaned statistics.
The card-free CPU arms of phases 7, 11, 14, 18, 25 and 55 and phase 73's
plans run on two threads beside the kernels' build and phase 3
(start_cpu_arms).
Phase 3 holds every kernel in float16 too (fault C6: the kernels refused
float16, which the JAX kernels compute): check_float16_kernels for the row
kernels, the cross-entropy, Adam (its found_inf skip: p, m and v bit for
bit, the launch counted) and the BN epilogue, element by element
(FWD_ROUNDING_RULE for the forwards), with one overflow case a forward
whose +-inf lie where the plain version's do; the attention kernels'
float16 instantiations at ATTENTION_CASES (FWD_F16_RULE, BWD_F16_RULE) and
float16 inputs with bf16 scores (the FFMA kBS twins) at BF16_SCORE_CASES;
each float16 variant timed beside its bfloat16 record under an
at_<shape>_f16 key.
Phase 3 also holds the bf16-score variants of the attention kernels
(check_bf16_score_kernels: forward, dQ, dK/dV, float32 and bfloat16,
element by element, the f32-score kernel's miss of the bf16-score plain
version printed as a ratio; with float32 inputs the f32-score backward
kernels refused by the backward rule, and the backward without the
rounding of dS held apart by its ratio; the bf16-input forward, a
warpgroup kernel of its own, at every path of its plan: dh 16 to 128, one
CTA, clusters of 2 to 8 and a recomputed tail, each case's path printed
and held to the kernel's; the bf16-input dQ and dK/dV, warpgroup kernels
of their own, at every tile edge of theirs; the forward's bound counts QK^T
and PV, what a design does beyond it reported as design_ops_per_qk_dh;
the backward is the composite's full gradient, the row max's cotangent
included: the gradients are held with TIE_RULE added at the tied scores,
the cases include 65 keys and three and twelve tied keys, and each case
prints the worst share the backward without that cotangent takes, which
must exceed the float32 rule at 65 keys; the FFMA kBS variants timed beside
their f32-score twins) and
times the BN
epilogue, the xent and Adam at the family's
float32 shapes (check_vision_kernels) and Adam at the seq2seq's 30,000 x
512 (check_seq2seq_kernels).

Before phase 1 the host's ml_dtypes is required: a numpy fetch of a bf16
value is an ml_dtypes bfloat16 array of the card's bits (ROADMAP C1), and
phase 4 splits the batch-32 fetch into the pinned copy and that view.

The Executor replays each plan as a CUDA graph from its second run, so a
wrapper's launch count moves at the first run (eager) and the second (the
capture) only: each phase holds those counts and reads a replay's launches
off a profiled replay (`hold_run_launches`, `profile_replay`); the kernels
line gives the wrappers' counts, the replays' and their sum by path.  The
executor's monitor is on: phases 4, 6, 8, 10, 12, 13, 15, 17, 24 and 31-34 print
its counters (held, the verifier's runs among them), its dispatch, fetch
and verify spans and memory gauges a run of steps or requests
(`read_monitor`); phases 27-30 also print the reader's and the resilience
layer's spans and counters.

The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}.  Without a CUDA device, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""
import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import weakref

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_TENSOR_FLOPS = 989e12    # dense bf16 tensor-core peak
F32_FLOPS = 67e12             # float32 outside the tensor cores
BATCHES = (1, 8, 32)
# requests at each batch size in a serving turn: the first of a size runs
# eagerly, the second captures its CUDA graph, the rest replay it
REQUESTS = 3
# eager and graphed in turns, on one host: an A/B of the executor's graphs
AB_ARMS = ("eager", "graphed", "eager", "graphed")
# phase 12: its one graphed arm is held bit for bit by phase 75's three
# graphed arms of the same program, which stand for AB_ARMS' second one
FUSED_AB_ARMS = ("eager", "graphed", "eager")
KERNEL_INFO = {
    "ln_residual_fwd": ("paddle_tpu_torch/csrc/ln_residual.cu", "paddle_tpu/ops/pallas_kernels.py:170"),
    "ln_residual_bwd": ("paddle_tpu_torch/csrc/ln_residual.cu", "paddle_tpu/ops/pallas_kernels.py:200"),
    "bias_act_fwd": ("paddle_tpu_torch/csrc/bias_act.cu", "paddle_tpu/ops/pallas_kernels.py:548"),
    "bias_act_bwd": ("paddle_tpu_torch/csrc/bias_act.cu", "paddle_tpu/ops/pallas_kernels.py:565"),
    "softmax_xent_fwd": ("paddle_tpu_torch/csrc/softmax_xent.cu", "paddle_tpu/ops/pallas_kernels.py:444"),
    "softmax_xent_bwd": ("paddle_tpu_torch/csrc/softmax_xent.cu", "paddle_tpu/ops/pallas_kernels.py:462"),
    "adam": ("paddle_tpu_torch/csrc/adam.cu", "paddle_tpu/ops/pallas_kernels.py:368"),
    "attention_fwd": (
        "paddle_tpu_torch/csrc/flash_attention.cu",
        "paddle_tpu/ops/pallas_attention.py:193 (row 10, fused_sdpa forward) and "
        "jax/experimental/pallas/ops/tpu/flash_attention.py:758 (row 12a, stock forward, called "
        "at paddle_tpu/ops/nn_ops.py:637-643)"),
    "attention_bwd_dkv": (
        "paddle_tpu_torch/csrc/flash_attention.cu",
        "paddle_tpu/ops/pallas_attention.py:221 (row 11, _fused_sdpa_bwd: dk, dv) and "
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 (row 12b, stock dK/dV)"),
    "attention_bwd_dq": (
        "paddle_tpu_torch/csrc/flash_attention.cu",
        "paddle_tpu/ops/pallas_attention.py:221 (row 11, _fused_sdpa_bwd: dq) and "
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1456 (row 12c, stock dQ)"),
    "bn_epilogue_fwd": ("paddle_tpu_torch/csrc/bn_epilogue.cu", "paddle_tpu/ops/pallas_kernels.py:271"),
    "bn_epilogue_bwd": ("paddle_tpu_torch/csrc/bn_epilogue.cu", "paddle_tpu/ops/pallas_kernels.py:288"),
    # the bf16-score kernels, the JAX composite's score_dtype="bfloat16"
    # (paddle_tpu/ops/nn_ops.py:680-684), each of bf16 inputs a warpgroup
    # kernel of its own
    "attention_fwd_bf16_scores": (
        "paddle_tpu_torch/csrc/attention_fwd_bs.cu",
        "paddle_tpu/ops/pallas_attention.py:193 (row 10, _fused_sdpa_fwd), bf16-score variant"),
    "attention_bwd_dq_bf16_scores": (
        "paddle_tpu_torch/csrc/attention_bwd_bs.cu",
        "paddle_tpu/ops/pallas_attention.py:221 (row 11, _fused_sdpa_bwd: dq), bf16-score variant"),
    "attention_bwd_dkv_bf16_scores": (
        "paddle_tpu_torch/csrc/attention_bwd_bs.cu",
        "paddle_tpu/ops/pallas_attention.py:221 (row 11, _fused_sdpa_bwd: dk, dv), bf16-score "
        "variant"),
}
NONE = dict.fromkeys(KERNEL_INFO, 0)
# a kernel of paddle_tpu_torch/csrc by its function name, in a profiler trace
PORT_KERNEL = re.compile(
    r"::(ln_residual|bias_act|softmax_xent|adam|attention|epilogue|column_sum)\w*_kernel\b")
# such a kernel's LAUNCHES key (the column sums belong to the LN and bias-act
# backward launches that start them)
KERNEL_OF = re.compile(r"::(\w+?)(?:_f32)?_kernel\b")
# an attention kernel's bf16-score instantiation (template arguments <DH, true>:
# the float32 twins; the bf16-input kernels carry the suffix in their names)
BF16_SCORES_OF = re.compile(r"attention_\w+_kernel<\d+,\s*(?:true|1)>")
KERNEL_KEY = {"ln_residual_fwd": "ln_residual_fwd", "ln_residual_bwd": "ln_residual_bwd",
              "bias_act_fwd": "bias_act_fwd", "bias_act_bwd": "bias_act_bwd",
              "softmax_xent_fwd": "softmax_xent_fwd", "softmax_xent_bwd": "softmax_xent_bwd",
              "adam": "adam", "attention_fwd": "attention_fwd",
              "attention_bwd_dq": "attention_bwd_dq", "attention_bwd_dkv": "attention_bwd_dkv",
              # the bf16-score kernels of bf16 inputs, kernels of their own
              "attention_fwd_bf16_scores": "attention_fwd_bf16_scores",
              "attention_bwd_dq_bf16_scores": "attention_bwd_dq_bf16_scores",
              "attention_bwd_dkv_bf16_scores": "attention_bwd_dkv_bf16_scores",
              "epilogue_fwd": "bn_epilogue_fwd", "epilogue_bwd": "bn_epilogue_bwd"}
# launches per request of BERT-base (12 layers) served with fused attention:
# every LN, every GELU and every attention is a kernel; no backward kernel runs
PER_REQUEST = dict(NONE, ln_residual_fwd=25, bias_act_fwd=12, attention_fwd=12)
# launches per training step of BERT-base (12 layers, unfused attention):
# 1 embedding LN + 2 per layer, 1 GELU per layer, one loss, and one Adam
# update per parameter (4 embedding/LN + 16 per layer + 2 LM head = 198);
# phase 6 derives the same counts from the program and holds both against each other
PER_STEP = dict(NONE, ln_residual_fwd=25, ln_residual_bwd=25, bias_act_fwd=12, bias_act_bwd=12,
                softmax_xent_fwd=1, softmax_xent_bwd=1, adam=198)
# with fused attention each of the 12 layers adds one attention forward and
# one each of its backward kernels (one backward region: the forward runs once)
FUSED_PER_STEP = dict(PER_STEP, attention_fwd=12, attention_bwd_dkv=12, attention_bwd_dq=12)
# phase 42: FUSED_PER_STEP with score_dtype="bfloat16": the bf16-score
# kernels in place of the attention kernels, 12 of each a step (at seq 128
# and, in its long arm, at seq 2048)
FUSED_BF16_SCORES_PER_STEP = dict(PER_STEP, attention_fwd_bf16_scores=12,
                                  attention_bwd_dkv_bf16_scores=12,
                                  attention_bwd_dq_bf16_scores=12)
BF16_SCORES_PER_REQUEST = dict(NONE, ln_residual_fwd=25, bias_act_fwd=12,
                               attention_fwd_bf16_scores=12)
# ResNet-50 has 53 batch_norms (the stem, 3 per bottleneck x 16, 4 shortcuts),
# each the epilogue kernel (33 with fuse_relu); its residual adds are not
# 1-D bias adds, so no bias-act kernel; Momentum has no kernel
RESNET_PER_REQUEST = dict(NONE, bn_epilogue_fwd=53)
RESNET_PER_STEP = dict(NONE, bn_epilogue_fwd=53, bn_epilogue_bwd=53, softmax_xent_fwd=1,
                       softmax_xent_bwd=1)
# DeepFM in the JAX package's full configuration (tools/donation_audit.py:128-132);
# the batch is the port's choice.  DeepFM reaches no row kernel: dense Adam is
# its one kernel, once per adam op that is not lazy over a sparse table (2
# tables, 4 fc weights, 4 fc biases)
DEEPFM = dict(num_fields=26, vocab_size=200000, embed_dim=16, mlp_dims=(400, 400, 400))
DEEPFM_BATCH = 4096
DEEPFM_PER_STEP = dict(NONE, adam=10)
# phase 16: the MLP cut to 64 x 64, so that the CPU's steps take seconds.
# Its float32 steps must be well conditioned for card and CPU to agree to
# 1e-5.  A first Adagrad step from a zero moment is lr * g / (|g| + 1e-6):
# where |g| is near 1e-6, rounding noise in g moves the step, and a one-ulp
# change of the fc weights on the CPU alone moved deepfm_v by 6x the
# tolerance (Adam's first step likewise near its epsilon).  So phase 16
# starts Adagrad's moment at 0.1, which makes its steps proportional to g,
# and gives lazy Adam an epsilon of 1e-6: the same one-ulp change then moves
# no persistable by more than 0.07 of its tolerance.
DEEPFM_PARITY = dict(DEEPFM, mlp_dims=(64, 64))
DEEPFM_PARITY_BATCH = 512
PARITY_LR = {"adagrad": 0.05, "adam": 1e-3}
# Transformer-base NMT in the JAX package's benchmark configuration
# (tools/bench_kit.py:223-225, tools/donation_audit.py:113-116; Adam's betas and
# epsilon at paddle_tpu/models/nmt.py:139-142), on its benchmark's batch: 32
# pairs, lengths uniform in [20, 64) (tools/bench_kit.py:230-240), so the time
# axis buckets to 64
NMT = dict(src_vocab=8000, tgt_vocab=8000, d_model=512, n_layers=6, n_heads=8, d_ff=2048,
           dropout=0.1, label_smooth_eps=0.1, learning_rate=2.0, warmup_steps=400)
NMT_BATCH = 32
NMT_T = 64
# per step: 5 LayerNorms a layer pair (2 encoder, 3 decoder), each with its
# residual folded in, one bias+ReLU a layer, one Adam update per parameter
# (src/tgt embedding, proj w/b, 16 per encoder layer, 26 per decoder layer);
# the soft-label loss and the attention are composites: no xent or attention kernel
NMT_PER_STEP = dict(NONE, ln_residual_fwd=30, ln_residual_bwd=30, bias_act_fwd=12, bias_act_bwd=12,
                    adam=256)
NMT_DECODE = dict(batch_size=NMT_BATCH, src_len=NMT_T, beam_size=4, max_len=64, bos=1, eos=2)
# phase 20: the 2-layer weights of phase 18, a few sentences
NMT_PARITY_DECODE = dict(batch_size=4, src_len=16, beam_size=4, max_len=16, bos=1, eos=2)
# phase 20's second case lifts proj.b[eos] by this, so that beams finish at
# different steps and the While leaves before max_len
NMT_EOS_LIFT = 6.0
# the JAX package's full ResNet-50 training configuration (tools/bench_kit.py:120-131)
RESNET = dict(depth=50, class_dim=1000, stem="space_to_depth", data_format="NCHW")
RESNET_BATCHES = (1, 32, 256)
RESNET_TRAIN_BATCH = 256
RESNET_PARITY_LR = 0.01
TRAIN_STEPS = 6
PARITY_STEPS = 3
FUSED_PARITY = ((128, 32), (2048, 1))  # phase 14's (seq_len, batch)
LR = 1e-4
# BERT fine-tuning as its users run it: weight decay and a global-norm clip
# of 1.0 (phases 24-26)
CLIP_NORM = 1.0
WEIGHT_DECAY = 0.01
# phase 25's fit-a-line program (the verify skill's): SGD steps, card vs CPU
FIT_A_LINE_STEPS = 50
FIT_A_LINE_TOL = 1e-5
# the data pipeline and the resilience layer (phases 27-30): phase 10's
# ResNet-50 from 8 batches of uint8 images in a RecordIO file, shuffled
# through a 512-sample buffer; DeepFM from 4 batches over two files; the
# chaos schedule of phase 29 and the preemption of phase 30
LOADER_BATCHES = 8
LOADER_SHUFFLE = 512
LOADER_CHUNK = 64  # records a RecordIO chunk: 9.6 MB of images
RESILIENT_SPEC = ("bad_batch@2;nan@5;device@8:UNAVAILABLE;device@10:RESOURCE_EXHAUSTED;"
                  "preempt@13")
RESILIENT_DROPPED = (2, 6)  # raw batches: the bad one, and the one step 5's NaN lands in
RESILIENT_STEPS = 16
RESILIENT_EPOCHS = 3  # 24 raw batches, 18 of them needed
BERT_RESUME_SPEC = "preempt@5"
BERT_RESUME_STEPS = 10
# the fluid_benchmark model family (phases 31-36; benchmark/fluid/models/ of
# the reference, paddle_tpu_torch/models/vision.py): SE-ResNeXt-50 and VGG-16
# at 224 x 224 and 1000 classes, float32 as built (no fusion pass, so no
# bias-act kernel), batch 64; the stacked dynamic LSTM at its benchmark's
# width (3 layers, embedding and hidden 512, vocab 5000) on 32 ragged
# sentences of 20-128 tokens (cut from the IMDB reviews' lengths to bucket
# 128); word2vec at the builder's own sizes (dict 1000, embedding 32, hidden
# 64, 3 context words) at batch 256
VISION = {"se_resnext": ("build_se_resnext", dict(class_dim=1000, image_shape=(3, 224, 224),
                                                   learning_rate=0.1)),
          "vgg": ("build_vgg", dict(class_dim=1000, image_shape=(3, 224, 224))),
          "stacked_lstm": ("build_stacked_dynamic_lstm",
                           dict(vocab_size=5000, emb_dim=512, hidden_dim=512, stacked_num=3)),
          "word2vec": ("build_word2vec", {}),
          # phases 50-51: word2vec's softmax head replaced by NCE (5 uniform
          # negatives a row) and by the hierarchical sigmoid
          "word2vec_nce": ("build_word2vec", {"head": "nce", "num_neg_samples": 5}),
          "word2vec_hsigmoid": ("build_word2vec", {"head": "hsigmoid"})}
VISION_BATCH = 64
VISION_SERVE_BATCHES = (1, 64)
LSTM_BATCH, LSTM_MIN_LEN, LSTM_BUCKET = 32, 20, 128
W2V_BATCH = 256
# a step's launches, as launches_of_program reads them off each program: 53
# batch norms over NCHW in SE-ResNeXt-50 (the stem, 3 per block x 16, 4
# shortcuts) and 13 in VGG-16 (its fc's batch norm is 2-D: the composite);
# one hard-label loss each; one Adam update per parameter (VGG-16: 13 conv
# weights and biases, 14 batch-norm scales and biases, 3 fc weights and
# biases; the LSTM: the embedding, 4 per layer, the fc's 2; word2vec: the
# shared embedding and 2 fc's 2); Momentum has no kernel
VISION_PER_STEP = {
    "se_resnext": dict(NONE, bn_epilogue_fwd=53, bn_epilogue_bwd=53, softmax_xent_fwd=1,
                       softmax_xent_bwd=1),
    "vgg": dict(NONE, bn_epilogue_fwd=13, bn_epilogue_bwd=13, softmax_xent_fwd=1,
                softmax_xent_bwd=1, adam=60),
    "stacked_lstm": dict(NONE, softmax_xent_fwd=1, softmax_xent_bwd=1, adam=15),
    "word2vec": dict(NONE, softmax_xent_fwd=1, softmax_xent_bwd=1, adam=5),
    # the embedding, the hidden fc's 2 and the head's weight and bias; no xent
    "word2vec_nce": dict(NONE, adam=5), "word2vec_hsigmoid": dict(NONE, adam=5)}
# phase 49: the tagger's Adam over the emissions fc's weight and bias and the
# CRF transitions; no other kernel (the CRF and its decode are composites)
TAGGER_PER_STEP = dict(NONE, adam=3)
VISION_PER_REQUEST = {"se_resnext": dict(NONE, bn_epilogue_fwd=53),
                      "vgg": dict(NONE, bn_epilogue_fwd=13)}
# phase 35: the conv nets at 64 x 64 (the last stage 2 x 2, not 1 x 1:
# tests/test_torch_resnet.py), the LSTM at width 128 on 8 sentences of 5-32
VISION_PARITY_SIZE = 64
# the path whose count a kernel's `launches` reports: this slice's first
LAUNCH_ORDER = ("bert_f16_amp", "resnet_f16_amp", "bert_f16_overflow", "bert_bf16_scores",
                "ssd_train", "yolov3_train", "ssd_serve", "yolov3_serve",
                "bert_bf16_scores_serve", "bert_bf16_scores_long", "train_lamb", "resnet_lars", "seq2seq_train",
                "se_resnext_train", "vgg_train", "lstm_train", "word2vec_train",
                "word2vec_nce_train", "word2vec_hsigmoid_train", "tagger_train",
                "se_resnext_serve", "vgg_serve", "nmt_train", "nmt_decode", "deepfm_train", "train_fused", "resnet_train", "resnet_serve", "train", "serve",
                "train_long", "loader_resnet", "dataset_deepfm", "resilient_resnet",
                "resilient_bert")
# phases 37-41: the other optimizers and the rest of the ragged path.  LAMB
# as BERT's large-batch recipe (You et al. 2019) on warmup into linear
# decay; LARS as ResNet-50's (You, Gitman and Ginsburg 2017) on a cosine
# schedule over 90 epochs of 5 steps; no Adam kernel runs on either path
LAMB_PER_STEP = dict(FUSED_PER_STEP, adam=0)
LARS_PER_STEP = RESNET_PER_STEP  # Momentum had no kernel either
OPTIMIZER_NAMES = {
    "lamb": "Lamb(lamb_weight_decay 0.01, epsilon 1e-6) on linear_lr_warmup(polynomial_decay("
            "1e-3, 1000, 0.0, 1.0), 2, 0.0, 1e-3)",
    "lars": "LarsMomentum(mu 0.9, lars_coeff 0.001, lars_weight_decay 5e-4) on "
            "cosine_decay(0.1, 5, 90)",
    "lamb_parity": f"Lamb(lr {LR}, lamb_weight_decay 0.01, epsilon 1e-6)",
    "lars_parity": f"LarsMomentum(lr {RESNET_PARITY_LR}, mu 0.9, lars_coeff 0.001, "
                   "lars_weight_decay 5e-4)",
}
# Fluid's benchmark machine_translation (benchmark/fluid/models/
# machine_translation.py, SURVEY.md:610) at its width: embedding, encoder
# and decoder 512, WMT14's 30,000-word vocabularies, Adam 1e-3 (the
# default of benchmark/fluid/fluid_benchmark.py); 32 ragged pairs of 10-60 tokens
# (bucket 64), float32
SEQ2SEQ = dict(src_vocab=30000, tgt_vocab=30000, emb_dim=512, enc_dim=512, dec_dim=512)
SEQ2SEQ_BATCH, SEQ2SEQ_MIN_LEN, SEQ2SEQ_MAX_LEN = 32, 10, 60
SEQ2SEQ_LR = 1e-3
# phase 41: width 64, vocab 200, 4 pairs
SEQ2SEQ_PARITY = dict(src_vocab=200, tgt_vocab=200, emb_dim=64, enc_dim=64, dec_dim=64)
# phase 40: each optimizer 3 steps on an MLP [64] -> 128 -> 128 -> 1 at batch
# 64 (the 128 x 128 weight is the one DGCMomentum would compress); the
# squared-gradient accumulators of RMSProp, Ftrl and DecayedAdagrad start at
# 0.1 on both sides, so that a first step is proportional to g and not
# lr * g / |g| where g is 0 to rounding (tests/test_torch_optimizers.py)
OPTIM_PARITY = {
    "rmsprop": ("RMSProp", (0.01,), {"momentum": 0.5, "centered": True}),
    "adamax": ("Adamax", (0.01,), {}),
    "adadelta": ("Adadelta", (1.0,), {"rho": 0.9}),
    "ftrl": ("Ftrl", (0.05,), {"l1": 0.001, "l2": 0.01}),
    "lamb": ("Lamb", (0.01,), {"lamb_weight_decay": 0.01}),
    "lars_momentum": ("LarsMomentum", (0.1, 0.9), {"lars_coeff": 0.01, "lars_weight_decay": 5e-4}),
    "decayed_adagrad": ("DecayedAdagrad", (0.01,), {}),
}
WARM_START = {"RMSProp": "_mean_square_0", "Ftrl": "_squared_0", "DecayedAdagrad": "_moment_0"}
SCHEDULES = {
    "exponential_decay": ((0.1, 3, 0.5), {"staircase": True}),
    "natural_exp_decay": ((0.1, 4, 0.3), {}),
    "inverse_time_decay": ((0.1, 2, 0.5), {}),
    "polynomial_decay": ((0.1, 4), {"end_learning_rate": 0.0, "cycle": True}),
    "piecewise_decay": (([2, 5, 7], [1.0, 0.5, 0.1, 0.01]), {}),
    "cosine_decay": ((0.1, 2, 5), {}),
    "linear_lr_warmup": ((0.1, 4, 0.0, 0.1), {}),
}
ZERO_GRAD = 1e-6  # phase 7: a gradient within this share of the model's largest is 0 to rounding
# forwards: paddle_tpu/ops/pallas_kernels.py FUSED_KERNELS (and the attention
# tests), save the loss and lse of the cross-entropy, which are float32 on both
# sides whatever the logits' type; gradients: grad_tol below; the cross-entropy
# backward, Adam and the BN epilogue backward element by element (check_within)
TOL = {"float32": {"ln_residual_fwd": 2e-5, "bias_act_fwd": 2e-5, "attention_fwd": 1e-4,
                   "softmax_xent_fwd": 2e-5, "bn_epilogue_fwd": 2e-5},
       "bfloat16": {"ln_residual_fwd": 5e-2, "bias_act_fwd": 5e-2, "softmax_xent_fwd": 2e-5,
                    "bn_epilogue_fwd": 2e-2},
       # float16's forwards are held element by element (FWD_ROUNDING_RULE);
       # the cross-entropy's loss and lse are float32 on both sides
       "float16": {"softmax_xent_fwd": 2e-5}}
# the bfloat16 attention gradients: cuda_attention.BWD_BF16_RULE, element by
# element (sdpa_bwd_bf16_allowed), at most the flat 5e-2 * max|plain| of grad_tol
XENT_BWD_REL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
# Adam: the float32 arithmetic of each output, a few roundings of the terms
# that make it, plus one rounding of a stored bfloat16 value
F32_ERR = 2.0 ** -20
STORED_ULP = {"float32": 0.0, "bfloat16": 2.0 ** -7}


def grad_tol(dtype, ref):
    """Gradients: 1e-4 * (1 + max|ref|) in float32, as tests/test_pallas_kernels.py
    holds the Pallas backward kernels; 5e-2 relative to max|ref| in bfloat16,
    and the same 12.8 steps of float16's, 6.25e-3, in float16."""
    peak = float(ref.float().abs().max())
    return {"float32": 1e-4 * (1.0 + peak), "bfloat16": 5e-2 * peak}.get(dtype, 6.25e-3 * peak)


def emit(obj):
    print(json.dumps(obj), flush=True)


def dname(dtype):
    return str(dtype).split(".")[-1]


def check(kernel, what, dtype, case, got, want, tol):
    """Hold a kernel's output against its plain version's; raise past `tol`."""
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    emit({"check": kernel, "out": what, "dtype": dname(dtype), "case": case,
          "max_abs_err": err, "tol": tol})
    if not err <= tol:
        raise AssertionError(f"{kernel} {what} {case} {dtype}: max |kernel - plain| "
                             f"{err} > {tol}")
    return err


def check_within(kernel, what, dtype, case, got, want, allowed, rule):
    """Hold a kernel's output against its plain version's element by element:
    |got - want| <= allowed (a tensor of want's shape); raise past it."""
    import torch

    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    share = float((diff / allowed).max())
    emit({"check": kernel, "out": what, "dtype": dname(dtype), "case": case,
          "max_abs_err": err, "rule": rule, "worst_share_of_allowed": share})
    if not share <= 1.0:
        raise AssertionError(f"{kernel} {what} {case} {dtype}: |kernel - plain| exceeds "
                             f"{rule} by a factor {share} (max abs {err})")
    return err


def repeatable(kernel, what, a, b):
    """Two runs of a backward reduction on the same inputs agree bit for bit."""
    import torch

    torch.cuda.synchronize()
    same = torch.equal(a, b)
    emit({"repeat": kernel, "out": what, "bitwise_equal": same})
    if not same:
        raise AssertionError(f"{kernel}: {what} differs between two runs on the same inputs")


def epilogue_bwd_allowed(x, mul, g, want):
    """What the BN epilogue backward may differ from its plain version by,
    element by element, given the plain (dx, dmul, dadd) in `want`: dx is one
    product rounded once to x's dtype on both sides, so one rounding of it;
    dmul and dadd are float32 row sums taken in another order, so 1e-5 of the
    sum of the magnitudes of their terms, sum|g*x| and sum|g| over the row.
    A kernel that drops the relu mask or a row misses by orders of magnitude
    (tests/test_torch_resnet.py shows it on the CPU)."""
    w = want[0].float().abs()
    ulp = {"float32": 2.0 ** -23 * w, "bfloat16": 2.0 ** -8 * w}.get(
        dname(x.dtype), 2.0 ** -10 * w + 2.0 ** -24)  # float16: a step, or a subnormal one
    gf = g.float()
    return (ulp + 1e-30,
            1e-5 * (gf * x.float()).abs().sum(-1) + 1e-30,
            1e-5 * gf.abs().sum(-1) + 1e-30)


def time_ms(fn, warmup=10, iters=100):
    """Median device time of one call of `fn`, from a CUDA event pair per call.

    A sleep kernel first backs up the stream, so the host enqueues every call
    before the device reaches it and each pair measures device time only,
    not the host's launch latency.  Inputs stay warm in the 50 MB L2."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of device time at the H100's clocks
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def launch_split(torch, fn, iters=50):
    """Device time of each kernel that one call of `fn` launches, in
    microseconds a call, by kernel name: torch.profiler over `iters` warm
    calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return {e.key[:80]: e.self_device_time_total / iters for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bytes_moved, ops, flops_rate):
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = ops / flops_rate
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def poison(torch, *outputs):
    """Fill the memory the next outputs of these (shape, dtype)s will take
    with NaN: empty the caching allocator, allocate NaN tensors of those
    sizes and free them, so the kernel's `torch.empty` gets them back.  An
    element the kernel fails to write then reads NaN, not a right value
    left there by an earlier call."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for shape, dtype in outputs:
        torch.full(shape, float("nan"), dtype=dtype, device="cuda")


def hold_ln_fwd(torch, ck, x, res, scale, bias, case):
    """One call of ck.fused_ln_residual into NaN-poisoned memory against
    ln_residual_plain at FUSED_KERNELS' tolerance; returns the error."""
    poison(torch, (x.shape, x.dtype))
    got = ck.fused_ln_residual(x, res, scale, bias, 1e-5)
    return check("ln_residual_fwd", "out", x.dtype, case, got,
                 ck.ln_residual_plain(x, res, scale, bias, 1e-5),
                 TOL[dname(x.dtype)]["ln_residual_fwd"])


def hold_bias_act_bwd(torch, ck, x, b, g, act, case):
    """One call of ck.bias_act_bwd into NaN-poisoned memory against
    bias_act_bwd_plain, element by element (dx) and column by column
    (dbias) by ck.bias_act_bwd_allowed, in float32 also within grad_tol;
    dbias bit for bit on a second call.  Returns the largest error."""
    dn = dname(x.dtype)
    poison(torch, (x.shape, x.dtype), ((x.shape[1],), torch.float32))
    got = ck.bias_act_bwd(x, b, g, act)
    want = ck.bias_act_bwd_plain(x, b, g, act)
    errs = []
    for w, a, c, t in zip(("dx", "dbias"), got, want, ck.bias_act_bwd_allowed(x, b, g, act, want)):
        if dn == "float32":
            t = torch.clamp(t, max=grad_tol(dn, c))
        errs.append(check_within("bias_act_bwd", w, x.dtype, case, a, c, t, ck.BIAS_ACT_BWD_RULE))
    repeatable("bias_act_bwd", f"dbias {case} {dn}", got[1], ck.bias_act_bwd(x, b, g, act)[1])
    return max(errs)


def hold_ln_bwd(torch, ck, x, res, scale, g, case, eps=1e-5):
    """One call of ck.ln_residual_bwd into NaN-poisoned memory against
    ln_residual_bwd_plain: dx within grad_tol, dscale and dbias column by
    column (ck.ln_residual_bwd_allowed), in float32 also within grad_tol;
    dscale and dbias bit for bit on a second call.  Returns the largest
    error."""
    dn = dname(x.dtype)
    d = (x.shape[1],)
    poison(torch, (x.shape, x.dtype), (d, torch.float32), (d, torch.float32))
    got = ck.ln_residual_bwd(x, res, scale, g, eps)
    want = ck.ln_residual_bwd_plain(x, res, scale, g, eps)
    errs = [check("ln_residual_bwd", "dx", x.dtype, case, got[0], want[0], grad_tol(dn, want[0]))]
    for w, a, b, t in zip(("dscale", "dbias"), got[1:], want[1:],
                          ck.ln_residual_bwd_allowed(x, res, g, eps)):
        if dn == "float32":
            t = torch.clamp(t, max=grad_tol(dn, b))
        errs.append(check_within("ln_residual_bwd", w, x.dtype, case, a, b, t, ck.LN_BWD_RULE))
    again = ck.ln_residual_bwd(x, res, scale, g, eps)
    repeatable("ln_residual_bwd", f"dscale {case} {dn}", got[1], again[1])
    repeatable("ln_residual_bwd", f"dbias {case} {dn}", got[2], again[2])
    return max(errs)


def hold_bias_act_fwd(torch, ck, x, b, act, case):
    """One call of ck.fused_bias_act into NaN-poisoned memory against
    bias_act_plain at FUSED_KERNELS' tolerance; returns the error."""
    poison(torch, (x.shape, x.dtype))
    return check("bias_act_fwd", "out", x.dtype, case, ck.fused_bias_act(x, b, act),
                 ck.bias_act_plain(x, b, act), TOL[dname(x.dtype)]["bias_act_fwd"])


def hold_xent_fwd(torch, ck, logits, labels, case):
    """One call of ck.softmax_xent_fwd into NaN-poisoned memory against
    softmax_xent_fwd_plain: the loss, and lse (0 on ignored rows), within
    2e-5 (float32 on both sides); a second call bit for bit.  Returns the
    error and the plain lse."""
    rows = logits.shape[0]
    poison(torch, ((rows,), torch.float32), ((rows,), torch.float32))
    loss, lse = ck.softmax_xent_fwd(logits, labels, -100)
    loss_p, lse_p = ck.softmax_xent_fwd_plain(logits, labels, -100)
    want_lse = torch.where(labels != -100, lse_p, torch.zeros_like(lse_p))
    dn = dname(logits.dtype)
    err = max(check("softmax_xent_fwd", "loss", logits.dtype, case, loss, loss_p,
                    TOL[dn]["softmax_xent_fwd"]),
              check("softmax_xent_fwd", "lse (0 where ignored)", logits.dtype, case, lse,
                    want_lse, TOL[dn]["softmax_xent_fwd"]))
    again = ck.softmax_xent_fwd(logits, labels, -100)
    repeatable("softmax_xent_fwd", f"loss {case} {dn}", loss, again[0])
    repeatable("softmax_xent_fwd", f"lse {case} {dn}", lse, again[1])
    return err, lse_p


def check_kernels(torch, ck):
    """Phase 3: every kernel against its plain version; returns the timing record."""
    import torch.nn.functional as F

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)

    def compare(kernel, dtype, case, got, want):
        return check(kernel, "out", dtype, case, got, want, TOL[dname(dtype)][kernel])

    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        # LayerNorm + residual: BERT-base rows (B=32 x 128) of 768, a ragged R, no residual
        # and the seq-2048 training rows (8 x 2048), into NaN-poisoned memory
        for rows, with_res in ((4096, True), (4096, False), (4095, True), (16384, True)):
            x = randn(rows, 768, dtype=dtype)
            res = randn(rows, 768, dtype=dtype) if with_res else None
            scale = randn(768, s=0.2) + 1.0
            bias = randn(768, s=0.1)
            err = hold_ln_fwd(torch, ck, x, res, scale, bias, f"[{rows},768] residual={with_res}")
            if dtype == torch.bfloat16 and rows in (4096, 16384) and with_res:
                w_x, b_x = scale.to(dtype), bias.to(dtype)
                b_ms, b_by = bound(nbytes(x, res, x, scale, bias), 10.0 * x.numel(), F32_FLOPS)
                rec = dict(
                    max_abs_err=err,
                    ms=time_ms(lambda: ck.fused_ln_residual(x, res, scale, bias, 1e-5)),
                    plain_ms=time_ms(lambda: ck.ln_residual_plain(x, res, scale, bias, 1e-5)),
                    library_ms=time_ms(lambda: F.layer_norm(x + res, (768,), w_x, b_x, 1e-5)),
                    library="F.layer_norm(x+res)",
                    bound_ms=b_ms, bound_by=b_by, shape=f"[{rows},768] bf16 + residual")
                if rows == 4096:
                    record["ln_residual_fwd"] = rec
                else:
                    record["ln_residual_fwd"]["at_16384"] = rec
        # bias + activation: the BERT-base FFN rows of 3072
        for act in ("gelu", "relu"):
            x = randn(4096, 3072, dtype=dtype)
            b = randn(3072, s=0.1)
            err = compare("bias_act_fwd", dtype, f"[4096,3072] {act}",
                          ck.fused_bias_act(x, b, act), ck.bias_act_plain(x, b, act))
            if dtype == torch.bfloat16 and act == "gelu":
                b_x = b.to(dtype)
                b_ms, b_by = bound(nbytes(x, x, b), 9.0 * x.numel(), F32_FLOPS)
                record["bias_act_fwd"] = dict(
                    max_abs_err=err,
                    ms=time_ms(lambda: ck.fused_bias_act(x, b, "gelu")),
                    plain_ms=time_ms(lambda: ck.bias_act_plain(x, b, "gelu")),
                    library_ms=time_ms(lambda: F.gelu(x + b_x)),
                    library="F.gelu(x+b)",
                    bound_ms=b_ms, bound_by=b_by, shape="[4096,3072] bf16 gelu")
    for name, rec in record.items():
        emit({"timing": name, **rec})
    return record


# attention cases of phase 3: (B, H, Lq, Lk, dh, bias, causal, inputs)
ATTENTION_CASES = [
    (32, 12, 128, 128, 64, None, False, "normal"),      # BERT-base, seq 128
    (32, 12, 128, 128, 64, "bcast", False, "normal"),
    (32, 12, 128, 128, 64, "per_head", False, "normal"),
    (32, 12, 128, 128, 64, None, True, "normal"),
    (2, 12, 1024, 1024, 64, None, False, "normal"),
    (2, 12, 128, 512, 64, None, True, "normal"),         # causal, Lq < Lk: key offset
    (2, 12, 200, 72, 64, None, True, "normal"),          # causal, Lq > Lk: rows with no key
    (8, 12, 2048, 2048, 64, None, False, "normal"),      # BERT-base, seq 2048
    (1, 12, 4096, 4096, 64, None, True, "normal"),
    (4, 8, 384, 384, 128, "bcast", False, "normal"),     # dh 128
    (4, 12, 512, 512, 64, "bcast", False, "late_bias"),  # the row max moves late
    (4, 12, 512, 512, 64, None, False, "late_keys"),
]
ATTENTION_TIMED = {(32, 128): "seq 128", (8, 2048): "seq 2048"}


def attention_bound(q, k, v, causal, extra_bytes, ops_per_qk):
    """Bound of one attention kernel: its tensors' bytes (each read or written
    once) over HBM, or ops_per_qk * B*H*Lq*Lk*dh operations, halved when
    causal, over the bf16 tensor-core peak."""
    B, H, Lq, dh = q.shape
    ops = ops_per_qk * B * H * Lq * k.shape[2] * dh * (0.5 if causal else 1.0)
    return bound(extra_bytes, ops, BF16_TENSOR_FLOPS)


def check_attention_kernels(torch, ca, cases=ATTENTION_CASES,
                            dtypes=("float32", "bfloat16", "float16")):
    """Phase 3, the attention kernels (forward, dQ, dK/dV): each against its
    plain version on the card, float32, bfloat16 and float16, at ATTENTION_CASES: the
    BERT-base shapes at seq 128 and 2048, every bias mode, causal with Lq < Lk
    and Lq > Lk, long causal, dh 128, and rows whose max moves late (a bias
    that grows along the keys; keys scaled by position), which an online
    softmax that forgets to rescale fails by orders of magnitude.  The
    16-bit forward is held element by element
    (cuda_attention.sdpa_fwd_bf16_allowed: FWD_BF16_RULE, FWD_F16_RULE).  The
    backward is held against sdpa_bwd_plain on the kernel's own output (so
    it is held alone), in 16 bits element by element
    (cuda_attention.sdpa_bwd_bf16_allowed: BWD_BF16_RULE, BWD_F16_RULE), two
    runs must agree bit for bit, and at kv >= 2048 in 16 bits the forward
    plus backward may allocate less than 1/8 of one float32 score tensor
    [B, H, Lq, Lk].  Times the forward, each backward
    kernel and the whole backward at [32,12,128,64] and [8,12,2048,64] bf16
    and float16 (the latter under at_seq_*_f16) against their bounds and
    plain versions, and the forward and the whole backward against
    F.scaled_dot_product_attention in the same dtype (a yardstick only).
    `cases` and `dtypes` narrow the checks, to run one case alone; only the
    full set is timed."""
    import torch.nn.functional as F

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, dtype=torch.float32, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)

    record = {}
    for dtype in (getattr(torch, d) for d in dtypes):
        dn = dname(dtype)
        for B, H, Lq, Lk, dh, bias_kind, causal, inputs in cases:
            q = randn(B, H, Lq, dh, dtype=dtype)
            k = randn(B, H, Lk, dh, dtype=dtype)
            v = randn(B, H, Lk, dh, dtype=dtype)
            do = randn(B, H, Lq, dh, dtype=dtype)
            bias = None
            if bias_kind is not None:
                bias = randn(B, 1 if bias_kind == "bcast" else H, Lq, Lk, s=2.0)
            if inputs == "late_bias":
                bias = torch.linspace(0.0, 12.0, Lk, device=dev).expand(B, 1, Lq, Lk).contiguous()
            elif inputs == "late_keys":
                k = (k.float() * torch.linspace(0.1, 4.0, Lk, device=dev)[:, None]).to(dtype)
            scale = dh ** -0.5
            case = (f"[{B},{H},{Lq},{dh}] x {Lk} bias={bias_kind} causal={causal} "
                    f"inputs={inputs}")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, lse = ca.attention_fwd(q, k, v, bias, causal, scale)
            dq, di = ca.attention_bwd_dq(q, k, v, bias, causal, scale, out, lse, do)
            dk, dv = ca.attention_bwd_dkv(q, k, v, bias, causal, scale, lse, di, do)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            score_bytes = 4 * B * H * Lq * Lk
            emit({"memory": "attention forward + backward", "case": case, "dtype": dn,
                  "peak_extra_bytes": extra, "score_tensor_bytes": score_bytes})
            if dtype != torch.float32 and Lk >= 2048 and not extra < score_bytes / 8:
                raise AssertionError(f"attention {case}: forward + backward allocated {extra} "
                                     f"bytes, not under 1/8 of a score tensor ({score_bytes})")
            again = ca.attention_bwd_dq(q, k, v, bias, causal, scale, out, lse, do)[0]
            repeatable("attention_bwd_dq", f"dq {case} {dn}", dq, again)
            again = ca.attention_bwd_dkv(q, k, v, bias, causal, scale, lse, di, do)
            repeatable("attention_bwd_dkv", f"dk {case} {dn}", dk, again[0])
            repeatable("attention_bwd_dkv", f"dv {case} {dn}", dv, again[1])
            del again
            want = ca.sdpa_plain(q, k, v, bias, causal, scale)
            if dtype == torch.float32:
                err_f = check("attention_fwd", "out", dtype, case, out, want,
                              TOL[dn]["attention_fwd"])
            else:
                err_f = check_within("attention_fwd", "out", dtype, case, out, want,
                                     ca.sdpa_fwd_bf16_allowed(q, k, v, bias, causal, scale, want),
                                     ca.fwd_rule(dtype))
            want = ca.sdpa_bwd_plain(q, k, v, bias, causal, scale, out, do)
            if dtype == torch.float32:
                err_q = check("attention_bwd_dq", "dq", dtype, case, dq, want[0],
                              grad_tol(dn, want[0]))
                err_kv = max(check("attention_bwd_dkv", w, dtype, case, a, b, grad_tol(dn, b))
                             for w, a, b in zip(("dk", "dv"), (dk, dv), want[1:]))
            else:
                allowed = ca.sdpa_bwd_bf16_allowed(q, k, v, bias, causal, scale, out, do, want)
                err_q = check_within("attention_bwd_dq", "dq", dtype, case, dq, want[0],
                                     allowed[0], ca.bwd_rule(dtype))
                err_kv = max(check_within("attention_bwd_dkv", w, dtype, case, a, b, t,
                                          ca.bwd_rule(dtype))
                             for w, a, b, t in zip(("dk", "dv"), (dk, dv), want[1:], allowed[1:]))
                del allowed
            del want
            torch.cuda.empty_cache()
            where = ATTENTION_TIMED.get((B, Lq)) if cases is ATTENTION_CASES else None
            if not (dtype != torch.float32 and where and bias is None and not causal):
                continue
            short = "bf16" if dtype == torch.bfloat16 else "f16"
            slow = dict(warmup=2, iters=10)  # the plain versions and library calls at L = 2048
            ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
            no_lib = "none: no one PyTorch call computes it alone (attention_bwd has the library's)"
            qkv = nbytes(q, k, v)
            args = (q, k, v, None, False, scale)
            timed = {
                "attention_fwd": (lambda: ca.attention_fwd(*args), qkv + nbytes(out, lse), 4.0,
                                  err_f, lambda: ca.sdpa_plain(*args),
                                  lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                                  "F.scaled_dot_product_attention"),
                "attention_bwd_dq": (
                    lambda: ca.attention_bwd_dq(*args, out, lse, do),
                    qkv + nbytes(out, do, lse, dq, di), 6.0, err_q,
                    lambda: ca.sdpa_bwd_dq_plain(*args, out, do), None, no_lib),
                "attention_bwd_dkv": (
                    lambda: ca.attention_bwd_dkv(*args, lse, di, do),
                    qkv + nbytes(do, lse, di, dk, dv), 8.0, err_kv,
                    lambda: ca.sdpa_bwd_dkv_plain(*args, out, do), None, no_lib),
                "attention_bwd": (
                    lambda: ca.attention_bwd(*args, out, lse, do),
                    qkv + nbytes(out, do, lse, dq, dk, dv), 10.0, max(err_q, err_kv),
                    lambda: ca.sdpa_bwd_plain(*args, out, do),
                    lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True),
                    "backward of F.scaled_dot_product_attention"),
            }
            for name, (fn, moved, ops, err, plain, lib_fn, lib) in timed.items():
                b_ms, b_by = attention_bound(q, k, v, False, moved, ops)
                rec = dict(max_abs_err=err, ms=time_ms(fn), plain_ms=time_ms(plain, **slow),
                           library_ms=None if lib_fn is None else time_ms(lib_fn, **slow),
                           library=lib, bound_ms=b_ms, bound_by=b_by,
                           shape=f"[{B},{H},{Lq},{dh}] {short}")
                emit({"timing": name, "at": where, **rec})
                record.setdefault(name, {})[where if short == "bf16" else f"{where} f16"] = rec
            del ql, kl, vl, lib_out
        torch.cuda.empty_cache()
    # the kernels' line reports the seq-128 shape; seq 2048 and float16 ride beside it
    return by_seq_record(record)


def by_seq_record(record):
    """{kernel: {"seq 128": rec, "seq 2048": rec, "seq 128 f16": ...}} as the
    kernels line takes it: the bf16 seq-128 record with the others beside
    it under at_seq_2048, at_seq_128_f16 and at_seq_2048_f16 (a float16
    check alone gives only the latter two)."""
    out = {}
    for name, by_seq in record.items():
        rec = dict(by_seq.get("seq 128", {}))
        for where, key in (("seq 2048", "at_seq_2048"), ("seq 128 f16", "at_seq_128_f16"),
                           ("seq 2048 f16", "at_seq_2048_f16")):
            if where in by_seq:
                rec[key] = by_seq[where]
        out[name] = rec
    return out


# bf16-score cases of phase 3: the BERT-base shapes at seq 128 and 2048,
# causal with Lq < Lk and Lq > Lk, a bias (B, H, Lq, Lk, dh, bias, causal);
# then every path of the bf16-score forward (ca.bf16_score_fwd_plan): dh 16,
# 32 and 128, dh 128 over a cluster of 8 (causal, bias broadcast over heads),
# one key past one CTA's score buffer (513 at dh 64: a cluster of 2, its
# last tile one key), keys past what the largest cluster holds (4196: each
# CTA recomputes a tile; a per-head bias, so that a row leans on few keys
# and float32's flat 1e-4 can see the rounding of its scores, which 4196
# keys of unbiased scores average away), and causal with Lq > Lk over a
# cluster; then the tile edges of the backward (attention_bwd_bs.cu: 64
# rows a CTA, 64-row streamed tiles, dK/dV 32 queries a step at dh 128): one
# row past a CTA's own rows and a streamed tile at dh 64 (65) and dh 128
# (129), causal with Lq <= Lk at dh 128 whose dK/dV CTAs skip their first
# query tiles (four of five at the last keys), causal with Lq > Lk at dh 128
# with a bias (rows with no visible key, the 32-query steps), and one
# ragged tile each way at dh 16; then the row max's cotangent (fault C5):
# 65 keys at dh 16 (the case that showed it), three keys made one, which
# most queries score highest (ties at the row max: dQ's slots), and twelve
# keys made one, 8 apart (more ties in one lane of a quad than dQ's slots
# hold, and more in a row than the float32 dQ's: their second pass), causal
BF16_SCORE_CASES = [
    (32, 12, 128, 128, 64, None, False),
    (8, 12, 2048, 2048, 64, None, False),
    (2, 12, 128, 512, 64, None, True),
    (2, 12, 200, 72, 64, None, True),
    (32, 12, 128, 128, 64, "per_head", False),
    (4, 12, 96, 200, 16, None, False),
    (4, 12, 128, 128, 32, None, False),
    (4, 12, 128, 128, 128, None, False),
    (2, 12, 128, 2048, 128, "bcast", True),
    (2, 12, 128, 513, 64, None, False),
    (1, 4, 128, 4196, 64, "per_head", False),
    (1, 4, 700, 600, 64, None, True),
    (4, 12, 65, 65, 64, None, False),
    (2, 12, 129, 129, 128, None, False),
    (2, 4, 320, 384, 128, None, True),
    (2, 4, 100, 70, 128, "per_head", True),
    (8, 12, 40, 24, 16, None, False),
    (1, 2, 65, 65, 16, None, False),
    (2, 4, 96, 130, 128, "ties", False),
    (1, 4, 70, 100, 64, "many_ties", True),
]
# the keys each kind of forced ties makes one
TIED_KEYS = {"ties": [3, 5, 7], "many_ties": list(range(0, 96, 8))}


def tie_keys(torch, q, k, keys):
    """k with `keys` made one key that most queries score highest: 2.5
    sqrt(dh) times the unit vector of the queries' mean, in k's dtype."""
    u = q.float().mean(2, keepdim=True)
    u = u * (2.5 * q.shape[-1] ** 0.5) / u.norm(dim=-1, keepdim=True)
    k = k.clone()
    k[:, :, keys, :] = u.to(k.dtype)
    return k
# the rule must see the rounding: the f32-score kernel, held to the
# bf16-score plain version, misses it by at least this many times the mean
# absolute difference of the bf16-score kernel
SCORE_MUTANT_RATIO = 2.0


def check_bf16_score_kernels(torch, ca, cases=BF16_SCORE_CASES,
                             dtypes=("float32", "bfloat16", "float16")):
    """Phase 3, the bf16-score variants of the attention kernels (forward, dQ,
    dK/dV; float32, bfloat16 and float16 inputs, the last through the FFMA
    kBS twins instantiated for float16 loads) against their plain versions
    (sdpa_plain and sdpa_bwd_plain with score_bf16) at BF16_SCORE_CASES,
    element by element: float32 at TOL and grad_tol, bfloat16 by
    FWD_BF16_RULE and BWD_BF16_RULE, float16 by FWD_F16_RULE and
    BWD_F16_RULE, each plus SCORE_ROUNDING_RULE (one bf16
    rounding of each score and of s - m on either side), the gradients
    also TIE_RULE at the tied scores (the row max's cotangent: the kernel's
    float32 sum of it against the plain version's); the backward without
    that cotangent's worst share printed (rule_sees_max_cotangent).  The backward is
    held on the kernel's own output, two runs agree bit for bit.  The
    f32-score kernel's output held to the bf16-score plain version must miss
    it by SCORE_MUTANT_RATIO times the bf16-score kernel's mean absolute
    difference (the rule sees the rounding); the ratio is printed.  With
    float32 inputs the backward rule must see both of its roundings too
    (backward_rule_sees_rounding).  Times
    each kernel at [32,12,128,64] and [8,12,2048,64] bf16 beside the
    f32-score kernel at the same shape, in the same process, and the
    float32 inputs' FFMA kBS dQ and dK/dV beside their f32-score twins, and
    the float16 inputs' FFMA kBS kernels beside their f32-score (mma.sync)
    twins under at_seq_*_f16.  Prints the
    path the bf16-score forward takes at each case (bf16_score_fwd_plan), and
    holds that plan to the kernel's own (ptt_attention_fwd_bs_plan)."""
    import ctypes

    from paddle_tpu_torch import _build

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(14)

    def randn(*shape, dtype=torch.float32, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)

    record = {}
    for dtype in (getattr(torch, d) for d in dtypes):
        dn = dname(dtype)
        for B, H, Lq, Lk, dh, bias_kind, causal in cases:
            q, do = randn(B, H, Lq, dh, dtype=dtype), randn(B, H, Lq, dh, dtype=dtype)
            k, v = randn(B, H, Lk, dh, dtype=dtype), randn(B, H, Lk, dh, dtype=dtype)
            bias = None
            if bias_kind in TIED_KEYS:
                k = tie_keys(torch, q, k, TIED_KEYS[bias_kind])
            elif bias_kind is not None:
                bias = randn(B, 1 if bias_kind == "bcast" else H, Lq, Lk, s=2.0)
            scale = dh ** -0.5
            args = (q, k, v, bias, causal, scale)
            case = f"[{B},{H},{Lq},{dh}] x {Lk} bias={bias_kind} causal={causal} bf16 scores"
            plan = ca.bf16_score_fwd_plan(Lk, dh)
            if dtype == torch.bfloat16:
                got = (ctypes.c_int * 4)()
                _build.call("ptt_attention_fwd_bs_plan", Lk, dh, got)
                emit({"bf16_score_fwd_path": case, **plan, "kernel_plan": list(got)})
                if list(got) != [plan[k] for k in ("cluster", "per_cta", "buffered",
                                                   "recomputed")]:
                    raise AssertionError(f"bf16_score_fwd_plan {plan} is not the kernel's "
                                         f"{list(got)} at {case}")
            out, lse = ca.attention_fwd(*args, score_bf16=True)
            dq, di = ca.attention_bwd_dq(*args, out, lse, do, score_bf16=True)
            dk, dv = ca.attention_bwd_dkv(*args, lse, di, do, score_bf16=True)
            again = ca.attention_bwd_dq(*args, out, lse, do, score_bf16=True)[0]
            repeatable("attention_bwd_dq_bf16_scores", f"dq {case} {dn}", dq, again)
            again = ca.attention_bwd_dkv(*args, lse, di, do, score_bf16=True)
            repeatable("attention_bwd_dkv_bf16_scores", f"dk {case} {dn}", dk, again[0])
            repeatable("attention_bwd_dkv_bf16_scores", f"dv {case} {dn}", dv, again[1])
            del again
            want = ca.sdpa_plain(*args, score_bf16=True)
            extra = ca.score_rounding_allowed(*args)
            rule = ca.SCORE_ROUNDING_RULE
            if dtype == torch.float32:
                allowed = TOL[dn]["attention_fwd"] + extra
                rule = f"{TOL[dn]['attention_fwd']} + {rule}"
            else:
                allowed = ca.sdpa_fwd_bf16_allowed(*args, want, score_bf16=True) + extra
                rule = f"{ca.fwd_rule(dtype)} + {rule}"
            err_f = check_within("attention_fwd_bf16_scores", "out", dtype, case, out, want,
                                 allowed, rule)
            # the rule sees the rounding: the f32-score kernel's output misses
            f32_out = ca.attention_fwd(*args)[0]
            if dtype == torch.float32:  # SCORE_ROUNDING_RULE admits no unrounded scores
                share = float(((f32_out - want).abs() / allowed).max())
                emit({"rule_refuses_unrounded_scores": case, "worst_share_of_allowed": share})
                if not share > 1.0:
                    raise AssertionError(f"attention_fwd_bf16_scores {case}: the rule admits "
                                         "the f32-score kernel")
            mad_bs = float((out.float() - want.float()).abs().mean())
            mad_f32 = float((f32_out.float() - want.float()).abs().mean())
            ratio = mad_f32 / max(mad_bs, 1e-30)
            emit({"score_rounding_seen": "attention_fwd_bf16_scores", "case": case, "dtype": dn,
                  "mean_abs_diff_bf16_score_kernel": mad_bs,
                  "mean_abs_diff_f32_score_kernel": mad_f32, "ratio": ratio,
                  "want_at_least": SCORE_MUTANT_RATIO})
            if not ratio >= SCORE_MUTANT_RATIO:
                raise AssertionError(f"attention_fwd_bf16_scores {case} {dn}: the f32-score "
                                     f"kernel misses the bf16-score plain version by only "
                                     f"{ratio}x the bf16-score kernel's mean difference")
            del f32_out, allowed
            want = ca.sdpa_bwd_plain(*args, out, do, score_bf16=True)
            # the kernel's share of each row's max cotangent within TIE_RULE's
            # range; the gradients held with the term of that share
            share_range, ties, ties_any = ca.tie_terms(*args, out, do, di[1])
            hold_tie_shares(case, dn, di[1], *share_range)
            extra = ca.score_rounding_allowed(*args, out, do)
            if dtype == torch.float32:
                base = [grad_tol(dn, w) + e for w, e in zip(want, extra)]
                rule = f"grad_tol + {ca.SCORE_ROUNDING_RULE} + {ca.TIE_RULE}"
            else:
                base = [a + e for a, e in zip(ca.sdpa_bwd_bf16_allowed(
                    *args, out, do, want, score_bf16=True), extra)]
                rule = f"{ca.bwd_rule(dtype)} + {ca.SCORE_ROUNDING_RULE} + {ca.TIE_RULE}"
            allowed = [b + t for b, t in zip(base, ties + (0.0,))]  # dq and dk
            err_q = check_within("attention_bwd_dq_bf16_scores", "dq", dtype, case, dq, want[0],
                                 allowed[0], rule)
            err_kv = max(check_within("attention_bwd_dkv_bf16_scores", w, dtype, case, a, b, t,
                                      rule)
                         for w, a, b, t in zip(("dk", "dv"), (dk, dv), want[1:], allowed[1:]))
            if dtype == torch.float32:
                backward_rule_sees_rounding(torch, ca, args, case, out, do, (dq, dk, dv), want,
                                            allowed)
            rule_sees_max_cotangent(torch, ca, args, case, dn, out, do, want,
                                    [b + t for b, t in zip(base, ties_any)],
                                    must=dtype == torch.float32 and (Lk, dh) == (65, 16))
            del want, allowed, extra, base, ties, ties_any, share_range
            torch.cuda.empty_cache()
            where = ATTENTION_TIMED.get((B, Lq))
            if not (where and bias_kind is None and not causal and cases is BF16_SCORE_CASES):
                continue
            slow = dict(warmup=2, iters=10)
            if dtype == torch.float32:  # the FFMA kBS variants beside their f32-score twins
                a0 = (q, k, v, None, False, scale)
                lse32 = ca.attention_fwd(*a0)[1]
                di32 = ca.attention_bwd_dq(*a0, out, lse32, do)[1]
                for name, fn, f32_fn in (
                        ("attention_bwd_dq_bf16_scores",
                         lambda: ca.attention_bwd_dq(*a0, out, lse, do, score_bf16=True),
                         lambda: ca.attention_bwd_dq(*a0, out, lse32, do)),
                        ("attention_bwd_dkv_bf16_scores",
                         lambda: ca.attention_bwd_dkv(*a0, lse, di, do, score_bf16=True),
                         lambda: ca.attention_bwd_dkv(*a0, lse32, di32, do))):
                    f32_first = time_ms(f32_fn, **slow)
                    ms = time_ms(fn, **slow)
                    f32_ms = (f32_first + time_ms(f32_fn, **slow)) / 2
                    emit({"timing": name, "inputs": "float32: the FFMA kBS variant", "at": where,
                          "ms": ms, "f32_score_kernel_ms": f32_ms,
                          "ratio_to_f32_score_kernel": ms / f32_ms,
                          "shape": f"[{B},{H},{Lq},{dh}] float32"})
                del lse32, di32
                continue
            qkv = nbytes(q, k, v)
            a0 = (q, k, v, None, False, scale)
            lse32 = ca.attention_fwd(*a0)[1]
            di32 = ca.attention_bwd_dq(*a0, out, lse32, do)[1]
            short = "bf16" if dtype == torch.bfloat16 else "f16"
            # the forward's design: QK^T of a recomputed tile runs three times
            # (float16's FFMA twin: QK^T in each of its three passes)
            fwd_ops = (4.0 + 4.0 * plan["recomputed"] / plan["per_cta"] if short == "bf16"
                       else 8.0)
            timed = {
                "attention_fwd_bf16_scores": (
                    lambda: ca.attention_fwd(*a0, score_bf16=True),
                    lambda: ca.attention_fwd(*a0), qkv + nbytes(out, lse), 4.0, fwd_ops, err_f,
                    lambda: ca.sdpa_plain(*a0, score_bf16=True)),
                "attention_bwd_dq_bf16_scores": (
                    lambda: ca.attention_bwd_dq(*a0, out, lse, do, score_bf16=True),
                    lambda: ca.attention_bwd_dq(*a0, out, lse32, do),
                    qkv + nbytes(out, do, lse, dq, di), 6.0, 6.0, err_q,
                    lambda: ca.sdpa_bwd_dq_plain(*a0, out, do, score_bf16=True)),
                "attention_bwd_dkv_bf16_scores": (
                    lambda: ca.attention_bwd_dkv(*a0, lse, di, do, score_bf16=True),
                    lambda: ca.attention_bwd_dkv(*a0, lse32, di32, do),
                    qkv + nbytes(do, lse, di, dk, dv), 8.0, 8.0, err_kv,
                    lambda: ca.sdpa_bwd_dkv_plain(*a0, out, do, score_bf16=True)),
            }
            for name, (fn, f32_fn, moved, ops, design_ops, err, plain) in timed.items():
                # the bound counts the function's work (forward: QK^T and PV,
                # 4 units); what a design does beyond it (the backward's
                # recomputed S and dP, a forward's recomputed tiles) is
                # reported beside it as design_ops_per_qk_dh
                b_ms, b_by = attention_bound(q, k, v, False, moved, ops)
                # float16's FFMA twins run for tens of ms at seq 2048: fewer calls
                kw = {} if short == "bf16" else slow
                f32_first = time_ms(f32_fn, **kw)
                ms = time_ms(fn, **kw)
                f32_ms = (f32_first + time_ms(f32_fn, **kw)) / 2
                rec = dict(max_abs_err=err, ms=ms, f32_score_kernel_ms=f32_ms,
                           ratio_to_f32_score_kernel=ms / f32_ms, share_of_bound=b_ms / ms,
                           plain_ms=time_ms(plain, **slow), library_ms=None,
                           library="none: no PyTorch call rounds the scores to bf16",
                           bound_ms=b_ms, bound_by=b_by, ops_per_qk_dh=ops,
                           design_ops_per_qk_dh=design_ops,
                           shape=f"[{B},{H},{Lq},{dh}] {short}")
                if name == "attention_fwd_bf16_scores" and short == "bf16":
                    rec["path"] = plan
                emit({"timing": name, "at": where, **rec})
                record.setdefault(name, {})[where if short == "bf16" else f"{where} f16"] = rec
        torch.cuda.empty_cache()
    return by_seq_record(record)


def unrounded_ds_grads(torch, ca, args, out, do):
    """(dq, dk, dv) of the bf16-score plain backward with the cast's VJP
    left out: the scores rounded, dS = P (dP - di) scale not rounded to
    bf16.  The mutant the bf16-score backward rule must see."""
    q, k, v, bias, causal, scale = args
    p, _, _, keep = ca._probs_plain(q, k, bias, causal, scale, True)
    dof = do.float()
    ds = p * (torch.matmul(dof, v.float().transpose(-1, -2))
              - (dof * out.float()).sum(-1, keepdim=True)) * scale
    if keep is not None:
        ds = torch.where(keep, ds, torch.zeros_like(ds))
    return (torch.matmul(ds, k.float()),) + ca._dkv(p, ds, q, v, do)


def no_max_cotangent_grads(torch, ca, args, out, do):
    """(dq, dk) of the bf16-score plain backward without the row max's
    cotangent (fault C5 of the port before its repair): dS = bf16(P (dP -
    di)) * scale everywhere.  The mutant the tie term must not admit."""
    q, k, v, bias, causal, scale = args
    p, _, _, keep = ca._probs_plain(q, k, bias, causal, scale, True)
    dof = do.float()
    ds = (p * (torch.matmul(dof, v.float().transpose(-1, -2))
               - (dof * out.float()).sum(-1, keepdim=True))).to(torch.bfloat16).float() * scale
    if keep is not None:
        ds = torch.where(keep, ds, torch.zeros_like(ds))
    ds = ds.to(q.dtype).float()
    return torch.matmul(ds, k.float()), torch.matmul(ds.transpose(-1, -2), q.float())


def hold_tie_shares(case, dn, t, lo, hi, held):
    """Phase 3: the dQ kernel's share t of each row's max cotangent (what it
    writes beside di, [B, H, Lq]) within TIE_RULE's range [lo, hi]
    (ca.tie_share_range) in every `held` row; the rows held and their worst
    share of the range's half width are printed."""
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    off = ((t - mid).abs() - half).clamp_min(0)[held]
    share = float(((t - mid).abs()[held] / (half[held] + 1e-30)).max()) if held.any() else 0.0
    emit({"tie_shares": case, "dtype": dn, "rows_held": int(held.sum()),
          "rows_outside": int((off > 0).sum()), "worst_share_of_half_range": share})
    if (off > 0).any():
        raise AssertionError(f"attention_bwd_dq_bf16_scores {case} {dn}: a row's share t of its "
                             f"max cotangent exceeds TIE_RULE's range in {int((off > 0).sum())} "
                             f"rows (by up to {float(off.max())})")


def rule_sees_max_cotangent(torch, ca, args, case, dn, out, do, want, allowed, must):
    """Phase 3: the worst share of the backward rule (`allowed`: with the
    tie term of any share in TIE_RULE's range, not the kernel's own) that
    the plain backward without the row max's cotangent
    (no_max_cotangent_grads, the port before fault C5's repair) takes in dq
    and dk, printed for each case and dtype; `must` (float32 inputs at 65
    keys): it exceeds the rule."""
    mutant = no_max_cotangent_grads(torch, ca, args, out, do)
    shares = [float(((m - w.float()).abs() / a).max()) for m, w, a in zip(mutant, want, allowed)]
    emit({"rule_sees_max_cotangent": case, "dtype": dn, "no_max_cotangent_dq_worst_share":
          shares[0], "no_max_cotangent_dk_worst_share": shares[1], "must_refuse": must})
    if must and not max(shares) > 1.0:
        raise AssertionError(f"attention bwd bf16 scores {case} {dn}: the rule admits the "
                             f"backward without the row max's cotangent (worst share {shares})")


def backward_rule_sees_rounding(torch, ca, args, case, out, do, got, want, allowed):
    """Phase 3, float32 inputs: the bf16-score backward rule sees both
    roundings.  The f32-score dQ and dK/dV kernels (no rounding of s or of
    dS), held to the bf16-score plain version, must exceed its rule
    (`allowed`) in each of dq, dk and dv.  The plain backward without the
    rounding of dS must miss the plain version by SCORE_MUTANT_RATIO times
    the bf16-score kernels' mean absolute difference in dq and dk; its
    worst share of the rule is printed beside it (at seq 2048 dS is small
    beside grad_tol's 1e-4 floor, and the rule alone may admit it)."""
    out32, lse32 = ca.attention_fwd(*args)
    dq32, di32 = ca.attention_bwd_dq(*args, out32, lse32, do)
    f32_score = (dq32,) + ca.attention_bwd_dkv(*args, lse32, di32, do)
    mutant = unrounded_ds_grads(torch, ca, args, out, do)
    rec = {"rule_refuses_unrounded_backward": case}
    for i, what in enumerate(("dq", "dk", "dv")):
        share = float(((f32_score[i] - want[i]).abs() / allowed[i]).max())
        rec[f"f32_score_kernel_{what}_worst_share"] = share
        if not share > 1.0:
            raise AssertionError(f"attention bwd bf16 scores {case}: the rule admits the "
                                 f"f32-score kernel's {what} (worst share {share})")
        if what == "dv":  # dV = P^T dO holds no dS
            continue
        rec[f"unrounded_ds_{what}_worst_share"] = float(
            ((mutant[i] - want[i]).abs() / allowed[i]).max())
        mad_kernel = float((got[i].float() - want[i].float()).abs().mean())
        mad_mutant = float((mutant[i] - want[i].float()).abs().mean())
        ratio = mad_mutant / max(mad_kernel, 1e-30)
        rec[f"unrounded_ds_{what}_ratio"] = ratio
        if not ratio >= SCORE_MUTANT_RATIO:
            raise AssertionError(f"attention bwd bf16 scores {case}: the plain backward without "
                                 f"the rounding of dS misses the plain version by only {ratio}x "
                                 f"the kernel's mean difference in {what}")
    emit({**rec, "want_at_least": SCORE_MUTANT_RATIO})


def attention_occupancy(_build):
    """Phase 2: what the card makes of each attention kernel (forward, dQ,
    dK/dV; float32, bfloat16 and float16; dh 16-128): CTAs an SM holds,
    registers a thread, dynamic shared bytes a CTA and local (spilled)
    bytes a thread, from cudaOccupancyMaxActiveBlocksPerMultiprocessor and
    cudaFuncGetAttributes."""
    import ctypes

    for which, name in enumerate(("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv")):
        for dtype, code in (("float32", 0), ("bfloat16", 1), ("float16", 2)):
            for dh in (16, 32, 64, 128):
                for bs in (0, 1):
                    out = (ctypes.c_int * 4)()
                    _build.call("ptt_attention_occupancy", which, dh, code, bs, out)
                    emit({"occupancy": name + ("_bf16_scores" if bs else ""), "dtype": dtype,
                          "dh": dh, "ctas_per_sm": out[0], "registers": out[1],
                          "smem_bytes": out[2], "local_bytes": out[3]})


def check_train_kernels(torch, ck):
    """Phase 3, the training slice's kernels: each against its plain version
    on the card, float32 and bfloat16, at BERT-base training shapes (R = 32 x
    128 rows), ragged R for the two row backwards, MLM labels for the loss,
    Adam at the largest parameter and an odd size; the backward reductions
    run twice and must agree bit for bit.  Returns the timing record."""
    import torch.nn.functional as F

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.float32, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)

    record = {}
    eps = 1e-5
    for dtype in (torch.float32, torch.bfloat16):
        dn = dname(dtype)
        # LayerNorm + residual backward: BERT-base rows of 768, ragged R, no residual
        for rows, with_res in ((4096, True), (4095, True), (4096, False)):
            x = randn(rows, 768, dtype=dtype)
            res = randn(rows, 768, dtype=dtype) if with_res else None
            scale = randn(768, s=0.2) + 1.0
            g = randn(rows, 768, dtype=dtype)
            case = f"[{rows},768] residual={with_res}"
            errs = [hold_ln_bwd(torch, ck, x, res, scale, g, case)]
            if dtype == torch.bfloat16 and rows == 4096 and with_res:
                z = (x + res)
                w_x, b_x = scale.to(dtype), randn(768, dtype=dtype, s=0.1)
                _, mean, rstd = torch.ops.aten.native_layer_norm(z, [768], w_x, b_x, eps)
                b_ms, b_by = bound(nbytes(x, res, scale, g, x) + 2 * 768 * 4, 20.0 * x.numel(),
                                   F32_FLOPS)
                split = launch_split(torch, lambda: ck.ln_residual_bwd(x, res, scale, g, eps))
                emit({"launch_split": "ln_residual_bwd", "case": case, "us_per_call": split})
                record["ln_residual_bwd"] = dict(
                    max_abs_err=max(errs), launch_split_us=split,
                    ms=time_ms(lambda: ck.ln_residual_bwd(x, res, scale, g, eps)),
                    plain_ms=time_ms(lambda: ck.ln_residual_bwd_plain(x, res, scale, g, eps)),
                    library_ms=time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                        g, z, [768], mean, rstd, w_x, b_x, [True, True, True])),
                    library="aten.native_layer_norm_backward of F.layer_norm(x+res)",
                    bound_ms=b_ms, bound_by=b_by, shape="[4096,768] bf16 + residual")
        # bias + activation backward: the FFN rows of 3072, ragged R and the
        # seq-2048 training rows (8 x 2048), gelu and relu, into NaN-poisoned
        # memory, held element by element and column by column
        for rows in (4096, 4095, 16384):
            x = randn(rows, 3072, dtype=dtype)
            b = randn(3072, s=0.1)
            g = randn(rows, 3072, dtype=dtype)
            for act in ("gelu", "relu"):
                case = f"[{rows},3072] {act}"
                err = hold_bias_act_bwd(torch, ck, x, b, g, act, case)
                if dtype == torch.bfloat16 and rows in (4096, 16384) and act == "gelu":
                    z = x + b.to(dtype)
                    b_ms, b_by = bound(nbytes(x, b, g, x) + 3072 * 4, 30.0 * x.numel(),
                                       F32_FLOPS)

                    def library():
                        torch.ops.aten.gelu_backward(g, z).sum(0)

                    rec = dict(
                        max_abs_err=err,
                        ms=time_ms(lambda: ck.bias_act_bwd(x, b, g, "gelu")),
                        plain_ms=time_ms(lambda: ck.bias_act_bwd_plain(x, b, g, "gelu")),
                        library_ms=time_ms(library),
                        library="aten.gelu_backward(g, x+b) then .sum(0): two calls, x+b "
                                "precomputed",
                        bound_ms=b_ms, bound_by=b_by, shape=f"[{rows},3072] bf16 gelu")
                    if rows == 4096:
                        split = launch_split(torch, lambda: ck.bias_act_bwd(x, b, g, "gelu"))
                        emit({"launch_split": "bias_act_bwd", "case": case, "us_per_call": split})
                        record["bias_act_bwd"] = dict(rec, launch_split_us=split)
                    else:
                        record["bias_act_bwd"]["at_16384"] = rec
                    del z
            del x, g
            torch.cuda.empty_cache()
        # softmax cross-entropy: the LM head's logits at seq 128 ([4096, V]) and
        # seq 2048 ([16384, V]) with labels at the MLM share (85% ignored, one
        # row labelled 0 and one V-1), and ResNet's [256, 1000], every row
        # labelled; the forward into NaN-poisoned memory and twice bit for bit
        V = 30522
        g = 1.0 + torch.rand(4096, generator=gen, device=dev)

        def xent_bwd_check(case, x, lab, lse_ref):
            # both sides take the same lse, so this holds the backward alone;
            # both compute in float32 and round once to the logits' type
            dx = ck.softmax_xent_bwd(x, lab, lse_ref, g[:x.shape[0]], -100)
            dx_p = ck.softmax_xent_bwd_plain(x, lab, lse_ref, g[:x.shape[0]], -100)
            rel = XENT_BWD_REL[dn]
            return check_within("softmax_xent_bwd", "dlogits", dtype, case, dx, dx_p,
                                rel * dx_p.float().abs() + 1e-12, f"{rel:g}*|plain| + 1e-12")

        for rows, v in ((4096, V), (16384, V), (256, 1000)):
            logits = randn(rows, v, dtype=dtype, s=2.0)
            labels = torch.randint(0, v, (rows,), generator=gen, device=dev)
            if v == V:
                masked = torch.rand(rows, generator=gen, device=dev) < 0.85
                labels = torch.where(masked, torch.full_like(labels, -100), labels)
                labels[0], labels[1], labels[2] = 0, V - 1, -100
            labels = labels.to(torch.int32)
            live = labels != -100
            n_live = int(live.sum())
            case = f"[{rows},{v}] {n_live} rows labelled"
            err_f, lse_p = hold_xent_fwd(torch, ck, logits, labels, case)
            if rows == 4096:
                err_b = xent_bwd_check(case, logits, labels, lse_p)
                # a contiguous view that starts one element off the 16-byte
                # grid: the backward writes its fresh, aligned dx element by
                # element
                off = randn(64 * V + 1, dtype=dtype, s=2.0)[1:].view(64, V)
                off_case = f"[64,{V}] view one element off the 16-byte grid"
                _, off_lse_p = hold_xent_fwd(torch, ck, off, labels[:64], off_case)
                xent_bwd_check(off_case, off, labels[:64], off_lse_p)
            if dtype != torch.bfloat16:
                continue
            row = v * logits.element_size()
            lab64 = labels.long()
            # the data decides the work: only labelled rows are read
            f_ms, f_by = bound(n_live * row + rows * 4 * 3, 5.0 * n_live * v, F32_FLOPS)
            rec = dict(
                max_abs_err=err_f,
                ms=time_ms(lambda: ck.softmax_xent_fwd(logits, labels, -100)),
                plain_ms=time_ms(lambda: ck.softmax_xent_fwd_plain(logits, labels, -100)),
                library_ms=time_ms(lambda: F.cross_entropy(logits, lab64, reduction="none",
                                                           ignore_index=-100)),
                library="F.cross_entropy(reduction='none', ignore_index=-100)",
                bound_ms=f_ms, bound_by=f_by, shape=f"[{rows},{v}] bf16, {n_live} rows labelled")
            if rows == 4096:
                split = launch_split(torch, lambda: ck.softmax_xent_fwd(logits, labels, -100))
                emit({"launch_split": "softmax_xent_fwd", "case": case, "us_per_call": split})
                record["softmax_xent_fwd"] = dict(rec, launch_split_us=split)
                lx = logits.detach().requires_grad_()
                lib_loss = F.cross_entropy(lx, lab64, reduction="none", ignore_index=-100)
                b_ms, b_by = bound(n_live * row + rows * 4 * 3 + rows * row, 4.0 * n_live * v,
                                   F32_FLOPS)
                lse = ck.softmax_xent_fwd(logits, labels, -100)[1]
                record["softmax_xent_bwd"] = dict(
                    max_abs_err=err_b,
                    ms=time_ms(lambda: ck.softmax_xent_bwd(logits, labels, lse, g, -100)),
                    plain_ms=time_ms(lambda: ck.softmax_xent_bwd_plain(logits, labels, lse, g,
                                                                       -100)),
                    library_ms=time_ms(lambda: torch.autograd.grad(lib_loss, lx, g,
                                                                   retain_graph=True)),
                    library="backward of F.cross_entropy(reduction='none', ignore_index=-100)",
                    bound_ms=b_ms, bound_by=b_by, shape=f"[4096,{V}] bf16, {n_live} rows labelled")
                del lx, lib_loss
            else:
                record["softmax_xent_fwd"][f"at_{rows}x{v}"] = rec
        del logits
        torch.cuda.empty_cache()
        # Adam: the token embedding (30522 x 768) and an odd size.  Weights at
        # BERT's init scale, g^2 of v's order, so that one step moves p, m and v
        # each by about 1e3 times the allowance: each output must agree to
        # F32_ERR of the magnitudes of its terms (p: p and the step taken
        # without cancellation; m: b1*m and (1-b1)*g; v: b2*v and (1-b2)*g^2),
        # plus one rounding where it is stored in bfloat16
        for n in (23_440_896, 1_000_003):
            p = randn(n, dtype=dtype, s=0.02)
            g = randn(n, dtype=dtype, s=0.01)
            m = randn(n, s=0.01)
            v = (0.5 + torch.rand(n, generator=gen, device=dev)) * 1e-4
            lr_t = torch.full((1,), 1e-3, device=dev)
            want = ck.adam_plain(p, g, m, v, lr_t, 0.9, 0.999, 1e-8)
            got = ck.fused_adam(p.clone(), g, m.clone(), v.clone(), lr_t, 0.9, 0.999, 1e-8)
            gf = g.float()
            terms_m = 0.9 * m.abs() + 0.1 * gf.abs()
            terms_v = 0.999 * v + 0.001 * gf * gf
            terms_p = p.float().abs() + lr_t * terms_m / (want[2].sqrt() + 1e-8)
            errs = []
            for what, terms, a, c in zip(("p", "m", "v"), (terms_p, terms_m, terms_v), got, want):
                ulp = STORED_ULP[dname(c.dtype)]
                allowed = F32_ERR * terms + ulp * c.float().abs() + 1e-30
                errs.append(check_within("adam", what, dtype, f"n={n}", a, c, allowed,
                                         f"2^-20*|terms| + {ulp:g}*|plain|"))
            if dtype == torch.float32 and n == 23_440_896:
                step = torch.zeros((), device=dev)
                b_ms, b_by = bound(nbytes(p, m, v, g, p, m, v), 10.0 * n, F32_FLOPS)
                record["adam"] = dict(
                    max_abs_err=max(errs),
                    ms=time_ms(lambda: ck.fused_adam(p, g, m, v, lr_t, 0.9, 0.999, 1e-8)),
                    plain_ms=time_ms(lambda: ck.adam_plain(p, g, m, v, lr_t, 0.9, 0.999, 1e-8)),
                    library_ms=time_ms(lambda: torch._fused_adam_(
                        [p], [g], [m], [v], [], [step], lr=1e-3, beta1=0.9, beta2=0.999,
                        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False)),
                    library="torch._fused_adam_ on one tensor",
                    bound_ms=b_ms, bound_by=b_by, shape=f"[{n}] float32")
    for name, rec in record.items():
        emit({"timing": name, **rec})
    return record


def check_nmt_kernels(torch, ck, record):
    """Phase 3, the shapes Transformer-base NMT gives the row kernels: its
    LayerNorms over D = 512 (another warps-per-row and vector path than
    BERT's 768) and its bias+ReLU over W = 2048, at the training step's rows
    (32 x 64 = 2048) and a row count off every tile (2047, as a decode of a
    few sentences gives), float32 and bfloat16, forward and backward, all
    into NaN-poisoned memory.  Adds their times at 2048 rows to `record`
    under at_2048x512_<dtype> and at_2048x2048_relu_<dtype>."""
    import torch.nn.functional as F

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, dtype=torch.float32, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)

    def timed(err, fn, plain, library, library_name, bytes_moved, ops, shape):
        b_ms, b_by = bound(bytes_moved, ops, F32_FLOPS)
        return dict(max_abs_err=err, ms=time_ms(fn), plain_ms=time_ms(plain),
                    library_ms=time_ms(library), library=library_name, bound_ms=b_ms,
                    bound_by=b_by, shape=shape)

    eps = 1e-5
    for dtype in (torch.float32, torch.bfloat16):
        dn = dname(dtype)
        for rows in (2048, 2047):
            x = randn(rows, 512, dtype=dtype)
            res = randn(rows, 512, dtype=dtype)
            scale = randn(512, s=0.2) + 1.0
            bias = randn(512, s=0.1)
            g = randn(rows, 512, dtype=dtype)
            case = f"[{rows},512] residual=True"
            err_f = hold_ln_fwd(torch, ck, x, res, scale, bias, case)
            err_b = hold_ln_bwd(torch, ck, x, res, scale, g, case)
            if rows == 2048:
                w_x, b_x = scale.to(dtype), bias.to(dtype)
                z = x + res
                _, mean, rstd = torch.ops.aten.native_layer_norm(z, [512], w_x, b_x, eps)
                shape = f"[2048,512] {dn} + residual"
                record["ln_residual_fwd"][f"at_2048x512_{dn}"] = timed(
                    err_f, lambda: ck.fused_ln_residual(x, res, scale, bias, eps),
                    lambda: ck.ln_residual_plain(x, res, scale, bias, eps),
                    lambda: F.layer_norm(x + res, (512,), w_x, b_x, eps), "F.layer_norm(x+res)",
                    nbytes(x, res, x, scale, bias), 10.0 * x.numel(), shape)
                record["ln_residual_bwd"][f"at_2048x512_{dn}"] = timed(
                    err_b, lambda: ck.ln_residual_bwd(x, res, scale, g, eps),
                    lambda: ck.ln_residual_bwd_plain(x, res, scale, g, eps),
                    lambda: torch.ops.aten.native_layer_norm_backward(
                        g, z, [512], mean, rstd, w_x, b_x, [True, True, True]),
                    "aten.native_layer_norm_backward of F.layer_norm(x+res)",
                    nbytes(x, res, scale, g, x) + 2 * 512 * 4, 20.0 * x.numel(), shape)
            x = randn(rows, 2048, dtype=dtype)
            b = randn(2048, s=0.1)
            g = randn(rows, 2048, dtype=dtype)
            case = f"[{rows},2048] relu"
            err_f = hold_bias_act_fwd(torch, ck, x, b, "relu", case)
            err_b = hold_bias_act_bwd(torch, ck, x, b, g, "relu", case)
            if rows == 2048:
                b_x = b.to(dtype)
                z = x + b_x
                shape = f"[2048,2048] {dn} relu"
                record["bias_act_fwd"][f"at_2048x2048_relu_{dn}"] = timed(
                    err_f, lambda: ck.fused_bias_act(x, b, "relu"),
                    lambda: ck.bias_act_plain(x, b, "relu"), lambda: F.relu(x + b_x),
                    "F.relu(x+b)", nbytes(x, x, b), 2.0 * x.numel(), shape)
                record["bias_act_bwd"][f"at_2048x2048_relu_{dn}"] = timed(
                    err_b, lambda: ck.bias_act_bwd(x, b, g, "relu"),
                    lambda: ck.bias_act_bwd_plain(x, b, g, "relu"),
                    lambda: torch.ops.aten.threshold_backward(g, z, 0).sum(0),
                    "aten.threshold_backward(g, x+b, 0) then .sum(0): two calls, x+b precomputed",
                    nbytes(x, b, g, x) + 2048 * 4, 3.0 * x.numel(), shape)
    for name in ("ln_residual_fwd", "ln_residual_bwd", "bias_act_fwd", "bias_act_bwd"):
        emit({"timing": name, **{k: v for k, v in record[name].items() if k.startswith("at_2048x")}})


def check_bn_kernels(torch, ck):
    """Phase 3, the ResNet-50 slice's kernels: the BN epilogue forward and
    backward against their plain versions at the stem's rows ([256*64,
    12544]), the last stage's ([256*2048, 49]) and an odd R of 49, float32
    and bfloat16, relu on and off.  The forward at FUSED_KERNELS'
    tolerances, the backward element by element (epilogue_bwd_allowed), its
    row sums bit for bit on a second run.  Returns the timing record."""
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, dtype=torch.float32, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)

    record = {}
    shapes = ((256 * 64, 12544, "stem"), (256 * 2048, 49, "last stage"), (65535, 49, "odd R"))
    for dtype in (torch.float32, torch.bfloat16):
        dn = dname(dtype)
        for rows, w, where in shapes:
            x = randn(rows, w, dtype=dtype)
            g = randn(rows, w, dtype=dtype)
            mul = 0.5 + torch.rand(rows, generator=gen, device=dev)
            add = randn(rows, s=0.5)
            for relu in (True, False):
                case = f"[{rows},{w}] {where} relu={relu}"
                err_f = check("bn_epilogue_fwd", "y", dtype, case, ck._epilogue_fwd(x, mul, add, relu),
                              ck.bn_epilogue_plain(x, mul, add, relu), TOL[dn]["bn_epilogue_fwd"])
                got = ck.bn_epilogue_bwd(x, mul, add, g, relu)
                want = ck.bn_epilogue_bwd_plain(x, mul, add, g, relu)
                allowed = epilogue_bwd_allowed(x, mul, g, want)
                rules = ("one rounding of |plain|", "1e-5*sum|g*x| of the row",
                         "1e-5*sum|g| of the row")
                errs = [check_within("bn_epilogue_bwd", what, dtype, case, a, b, t, rule)
                        for what, a, b, t, rule in zip(("dx", "dmul", "dadd"), got, want, allowed,
                                                       rules)]
                again = ck.bn_epilogue_bwd(x, mul, add, g, relu)
                for what, i in (("dmul", 1), ("dadd", 2)):
                    repeatable("bn_epilogue_bwd", f"{what} {case} {dn}", got[i], again[i])
                del got, want, allowed, again
                if dtype == torch.bfloat16 and where == "stem" and relu:
                    # the library yardsticks take mul/add in x's dtype, so their
                    # outputs are x's dtype too
                    mul_x, add_x = mul.to(dtype)[:, None], add.to(dtype)[:, None]
                    y = ck.bn_epilogue_plain(x, mul, add, True)
                    f_ms, f_by = bound(2 * nbytes(x) + 8 * rows, 3.0 * x.numel(), F32_FLOPS)
                    record["bn_epilogue_fwd"] = dict(
                        max_abs_err=err_f,
                        ms=time_ms(lambda: ck._epilogue_fwd(x, mul, add, True)),
                        plain_ms=time_ms(lambda: ck.bn_epilogue_plain(x, mul, add, True)),
                        library_ms=time_ms(lambda: torch.addcmul(add_x, x, mul_x).relu_()),
                        library="torch.addcmul(add, x, mul).relu_(): two calls",
                        bound_ms=f_ms, bound_by=f_by, shape=f"[{rows},{w}] bf16 relu")

                    def library_bwd():
                        gm = torch.ops.aten.threshold_backward(g, y, 0)
                        gm * mul_x
                        (gm * x).sum(-1, dtype=torch.float32)
                        gm.sum(-1, dtype=torch.float32)

                    b_ms, b_by = bound(3 * nbytes(x) + 16 * rows, 6.0 * x.numel(), F32_FLOPS)
                    record["bn_epilogue_bwd"] = dict(
                        max_abs_err=max(errs),
                        ms=time_ms(lambda: ck.bn_epilogue_bwd(x, mul, add, g, True)),
                        plain_ms=time_ms(lambda: ck.bn_epilogue_bwd_plain(x, mul, add, g, True)),
                        library_ms=time_ms(library_bwd),
                        library="aten.threshold_backward(g, y, 0), then gm*mul, (gm*x).sum(-1) "
                                "and gm.sum(-1): five calls",
                        bound_ms=b_ms, bound_by=b_by, shape=f"[{rows},{w}] bf16 relu")
                    del y
            del x, g
    torch.cuda.empty_cache()
    for name, rec in record.items():
        emit({"timing": name, **rec})
    return record


# float16 overflow: of the elements that are +-inf on one side only, at
# most this share of the infs (and at least 2) may be the largest finite
# value on the other, +-65504: the float32 value lay within its noise of the
# threshold 65520 (one float16 step apart)
OVERFLOW_EDGE_SHARE = 1e-4


def hold_overflow(kernel, what, case, got, want, allowed):
    """A float16 output past 65504 from finite inputs: +-inf where the plain
    version has it, with its signs (never clamped to 65504: AMP's isfinite
    must see it), save at most OVERFLOW_EDGE_SHARE of them, where one side
    is inf and the other +-65504 of the same sign (the threshold's noise);
    the elements finite on both sides within `allowed`."""
    import torch

    torch.cuda.synchronize()
    inf_g, inf_w = torch.isinf(got), torch.isinf(want)
    both = inf_g & inf_w
    same_signs = bool(torch.equal(got[both], want[both]))
    apart = inf_g ^ inf_w
    edge = torch.where(inf_g, want, got)[apart].float()
    sign = torch.where(inf_g, got, want)[apart].float().sign()
    edge_ok = bool(((edge.abs() == 65504.0) & (edge.sign() == sign)).all())
    n_inf, n_apart = int(inf_w.sum()), int(apart.sum())
    fin = torch.isfinite(want) & torch.isfinite(got)
    share = float(((got.float() - want.float()).abs()[fin] / allowed[fin]).max())
    emit({"overflow": kernel, "out": what, "case": case, "infs": n_inf,
          "inf_signs_equal": same_signs, "inf_on_one_side_only": n_apart,
          "those_65504_on_the_other": edge_ok, "finite_worst_share_of_allowed": share})
    if not (n_inf and same_signs and edge_ok
            and n_apart <= max(2, OVERFLOW_EDGE_SHARE * n_inf) and share <= 1.0):
        raise AssertionError(f"{kernel} {what} {case}: float16 overflow differs from the plain "
                             f"version (infs {n_inf}, one side only {n_apart}, share {share})")


def f16_timing(name, fn, plain, library_fn, library, moved, ops, shape, err):
    """One float16 variant's timing record: ms, plain_ms, library_ms (the
    library call in float16), bound (16-bit bytes; `ops` over the float32
    CUDA-core rate, as the row kernels' bfloat16 records)."""
    b_ms, b_by = bound(moved, ops, F32_FLOPS)
    rec = dict(max_abs_err=err, ms=time_ms(fn), plain_ms=time_ms(plain),
               library_ms=None if library_fn is None else time_ms(library_fn), library=library,
               bound_ms=b_ms, bound_by=b_by, shape=shape)
    emit({"timing": name, "dtype": "float16", **rec})
    return rec


def check_float16_kernels(torch, ck, record):
    """Phase 3 in float16 (fault C6: the kernels refused float16, which the
    JAX kernels compute), at the shapes phase 3 holds the other dtypes at:
    the LayerNorm forward (FWD_ROUNDING_RULE, element by element, into
    NaN-poisoned memory) and backward (dx by grad_tol's float16 form, the
    column sums by LN_BWD_RULE, bit for bit twice), bias+GELU/ReLU forward
    and backward (BIAS_ACT_BWD_RULE), the cross-entropy (loss and lse
    float32 within 2e-5, dlogits one float16 step), Adam over a float16
    parameter with float32 moments (2^-20 of the terms plus a float16 step;
    with found_inf set p, m and v bit for bit and the launch counted), the
    BN epilogue (FWD_ROUNDING_RULE; epilogue_bwd_allowed).  Each forward
    also overflows: a float32 scale, bias or multiplier lifts finite float16
    inputs past 65504, and the kernel's +-inf lie where the plain
    version's do.  Times each at the bfloat16 record's shape and adds it
    beside under at_<shape>_f16."""
    import torch.nn.functional as F

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(23)
    h = torch.float16

    def randn(*shape, dtype=h, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)

    eps = 1e-5
    # LayerNorm forward: BERT-base rows, ragged R, no residual, seq 2048's rows
    for rows, with_res in ((4096, True), (4096, False), (4095, True), (16384, True)):
        x = randn(rows, 768)
        res = randn(rows, 768) if with_res else None
        scale = randn(768, dtype=torch.float32, s=0.2) + 1.0
        bias = randn(768, dtype=torch.float32, s=0.1)
        case = f"[{rows},768] residual={with_res}"
        poison(torch, (x.shape, h))
        got = ck.fused_ln_residual(x, res, scale, bias, eps)
        want = ck.ln_residual_plain(x, res, scale, bias, eps)
        err = check_within("ln_residual_fwd", "out", h, case, got, want,
                           ck.ln_residual_fwd_allowed(x, res, scale, bias, want),
                           ck.FWD_ROUNDING_RULE)
        if rows == 4096 and with_res:
            w_x, b_x = scale.to(h), bias.to(h)
            record["ln_residual_fwd"]["at_4096x768_f16"] = f16_timing(
                "ln_residual_fwd", lambda: ck.fused_ln_residual(x, res, scale, bias, eps),
                lambda: ck.ln_residual_plain(x, res, scale, bias, eps),
                lambda: F.layer_norm(x + res, (768,), w_x, b_x, eps), "F.layer_norm(x+res) f16",
                nbytes(x, res, x, scale, bias), 10.0 * x.numel(), "[4096,768] f16 + residual",
                err)
            big = scale * 3e4
            want = ck.ln_residual_plain(x, res, big, bias, eps)
            hold_overflow("ln_residual_fwd", "out", f"{case}, scale x 3e4",
                          ck.fused_ln_residual(x, res, big, bias, eps), want,
                          ck.ln_residual_fwd_allowed(x, res, big, bias, want))
    # LayerNorm backward
    for rows, with_res in ((4096, True), (4095, True), (4096, False)):
        x = randn(rows, 768)
        res = randn(rows, 768) if with_res else None
        scale = randn(768, dtype=torch.float32, s=0.2) + 1.0
        g = randn(rows, 768)
        err = hold_ln_bwd(torch, ck, x, res, scale, g, f"[{rows},768] residual={with_res}")
        if rows == 4096 and with_res:
            z = x + res
            w_x, b_x = scale.to(h), randn(768, s=0.1)
            _, mean, rstd = torch.ops.aten.native_layer_norm(z, [768], w_x, b_x, eps)
            record["ln_residual_bwd"]["at_4096x768_f16"] = f16_timing(
                "ln_residual_bwd", lambda: ck.ln_residual_bwd(x, res, scale, g, eps),
                lambda: ck.ln_residual_bwd_plain(x, res, scale, g, eps),
                lambda: torch.ops.aten.native_layer_norm_backward(
                    g, z, [768], mean, rstd, w_x, b_x, [True, True, True]),
                "aten.native_layer_norm_backward of F.layer_norm(x+res) f16",
                nbytes(x, res, scale, g, x) + 2 * 768 * 4, 20.0 * x.numel(),
                "[4096,768] f16 + residual", err)
    # bias + activation, forward and backward: the FFN rows of 3072
    for rows in (4096, 4095, 16384):
        x = randn(rows, 3072)
        b = randn(3072, dtype=torch.float32, s=0.1)
        g = randn(rows, 3072)
        for act in ("gelu", "relu"):
            case = f"[{rows},3072] {act}"
            poison(torch, (x.shape, h))
            got = ck.fused_bias_act(x, b, act)
            want = ck.bias_act_plain(x, b, act)
            err_f = check_within("bias_act_fwd", "out", h, case, got, want,
                                 ck.bias_act_fwd_allowed(x, b, want), ck.FWD_ROUNDING_RULE)
            err_b = hold_bias_act_bwd(torch, ck, x, b, g, act, case)
            if rows == 4096 and act == "gelu":
                b_x = b.to(h)
                z = x + b_x
                record["bias_act_fwd"]["at_4096x3072_f16"] = f16_timing(
                    "bias_act_fwd", lambda: ck.fused_bias_act(x, b, "gelu"),
                    lambda: ck.bias_act_plain(x, b, "gelu"), lambda: F.gelu(x + b_x),
                    "F.gelu(x+b) f16", nbytes(x, x, b), 9.0 * x.numel(), "[4096,3072] f16 gelu",
                    err_f)
                record["bias_act_bwd"]["at_4096x3072_f16"] = f16_timing(
                    "bias_act_bwd", lambda: ck.bias_act_bwd(x, b, g, "gelu"),
                    lambda: ck.bias_act_bwd_plain(x, b, g, "gelu"),
                    lambda: torch.ops.aten.gelu_backward(g, z).sum(0),
                    "aten.gelu_backward(g, x+b) then .sum(0) f16: two calls",
                    nbytes(x, b, g, x) + 3072 * 4, 30.0 * x.numel(), "[4096,3072] f16 gelu",
                    err_b)
                big = b + 6.5e4
                x1k = x * 1e3  # finite: |x| < 65.5
                want = ck.bias_act_plain(x1k, big, "gelu")
                hold_overflow("bias_act_fwd", "out", f"{case}, x x 1e3, bias + 6.5e4",
                              ck.fused_bias_act(x1k, big, "gelu"), want,
                              ck.bias_act_fwd_allowed(x1k, big, want))
        del x, g
        torch.cuda.empty_cache()
    # softmax cross-entropy: the LM head's [4096, V] at the MLM share and
    # ResNet's [256, 1000]; dlogits one float16 step of the plain one; the
    # backward of a 2^32 loss scale overflows as AMP needs it to
    V = 30522
    for rows, v in ((4096, V), (256, 1000)):
        logits = randn(rows, v, s=2.0)
        labels = torch.randint(0, v, (rows,), generator=gen, device=dev)
        if v == V:
            masked = torch.rand(rows, generator=gen, device=dev) < 0.85
            labels = torch.where(masked, torch.full_like(labels, -100), labels)
            labels[0], labels[1], labels[2] = 0, V - 1, -100
        labels = labels.to(torch.int32)
        n_live = int((labels != -100).sum())
        case = f"[{rows},{v}] {n_live} rows labelled"
        err_f, lse_p = hold_xent_fwd(torch, ck, logits, labels, case)
        g = 1.0 + torch.rand(rows, generator=gen, device=dev)
        dx = ck.softmax_xent_bwd(logits, labels, lse_p, g, -100)
        dx_p = ck.softmax_xent_bwd_plain(logits, labels, lse_p, g, -100)
        err_b = check_within("softmax_xent_bwd", "dlogits", h, case, dx, dx_p,
                             ck.stored_step(h, dx_p) + 1e-12, "one float16 step (stored_step)")
        up = torch.full((rows,), 2.0 ** 32 / rows, device=dev)
        want = ck.softmax_xent_bwd_plain(logits, labels, lse_p, up, -100)
        hold_overflow("softmax_xent_bwd", "dlogits", f"{case}, upstream 2^32 / rows",
                      ck.softmax_xent_bwd(logits, labels, lse_p, up, -100), want,
                      ck.stored_step(h, want) + 1e-12)
        if v == V:
            row = v * logits.element_size()
            lab64 = labels.long()
            record["softmax_xent_fwd"]["at_4096x30522_f16"] = f16_timing(
                "softmax_xent_fwd", lambda: ck.softmax_xent_fwd(logits, labels, -100),
                lambda: ck.softmax_xent_fwd_plain(logits, labels, -100),
                lambda: F.cross_entropy(logits, lab64, reduction="none", ignore_index=-100),
                "F.cross_entropy(reduction='none', ignore_index=-100) f16",
                n_live * row + rows * 4 * 3, 5.0 * n_live * v,
                f"[4096,{V}] f16, {n_live} rows labelled", err_f)
            lx = logits.detach().requires_grad_()
            lib_loss = F.cross_entropy(lx, lab64, reduction="none", ignore_index=-100)
            record["softmax_xent_bwd"]["at_4096x30522_f16"] = f16_timing(
                "softmax_xent_bwd", lambda: ck.softmax_xent_bwd(logits, labels, lse_p, g, -100),
                lambda: ck.softmax_xent_bwd_plain(logits, labels, lse_p, g, -100),
                lambda: torch.autograd.grad(lib_loss, lx, g, retain_graph=True),
                "backward of F.cross_entropy(reduction='none', ignore_index=-100) f16",
                n_live * row + rows * 4 * 3 + rows * row, 4.0 * n_live * v,
                f"[4096,{V}] f16, {n_live} rows labelled", err_b)
            del lx, lib_loss
        del logits
        torch.cuda.empty_cache()
    # Adam: a float16 parameter and gradient with float32 moments, at the
    # token embedding's size and an odd one; the AMP skip flag
    lr_t = torch.full((1,), 1e-3, device=dev)
    for n in (23_440_896, 1_000_003):
        p, g = randn(n, s=0.02), randn(n, s=0.01)
        m = randn(n, dtype=torch.float32, s=0.01)
        v = (0.5 + torch.rand(n, generator=gen, device=dev)) * 1e-4
        want = ck.adam_plain(p, g, m, v, lr_t, 0.9, 0.999, 1e-8)
        got = ck.fused_adam(p.clone(), g, m.clone(), v.clone(), lr_t, 0.9, 0.999, 1e-8)
        gf = g.float()
        terms_m = 0.9 * m.abs() + 0.1 * gf.abs()
        terms = (p.float().abs() + lr_t * terms_m / (want[2].sqrt() + 1e-8), terms_m,
                 0.999 * v + 0.001 * gf * gf)
        errs = [check_within("adam", what, h, f"n={n}", a, c,
                             F32_ERR * t + ck.stored_step(c.dtype, c) + 1e-30,
                             "2^-20*|terms| + one rounding of the stored dtype (stored_step)")
                for what, t, a, c in zip(("p", "m", "v"), terms, got, want)]
        for flag in (True, False):
            pc, mc, vc = p.clone(), m.clone(), v.clone()
            before = ck.LAUNCHES["adam"]
            ck.fused_adam(pc, g, mc, vc, lr_t, 0.9, 0.999, 1e-8,
                          torch.tensor([flag], device=dev))
            torch.cuda.synchronize()
            counted = ck.LAUNCHES["adam"] - before
            held = (torch.equal(pc, p) and torch.equal(mc, m) and torch.equal(vc, v)) if flag \
                else all(torch.equal(a, b) for a, b in zip((pc, mc, vc), got))
            emit({"adam_found_inf": flag, "n": n, "launches": counted,
                  "state_bitwise_unchanged" if flag else "state_bitwise_as_without_flag": held})
            if not (held and counted == 1):
                raise AssertionError(f"adam found_inf={flag} n={n}: state held {held}, "
                                     f"launches {counted}")
        if n == 23_440_896:
            step = torch.zeros((), device=dev)
            p16, g16, m16, v16 = p.clone(), g.clone(), m.to(h), v.to(h)
            record["adam"]["at_23440896_f16"] = f16_timing(
                "adam", lambda: ck.fused_adam(p, g, m, v, lr_t, 0.9, 0.999, 1e-8),
                lambda: ck.adam_plain(p, g, m, v, lr_t, 0.9, 0.999, 1e-8),
                lambda: torch._fused_adam_([p16], [g16], [m16], [v16], [], [step], lr=1e-3,
                                           beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
                                           amsgrad=False, maximize=False),
                "torch._fused_adam_ on one tensor, all float16 (it takes one dtype)",
                nbytes(p, m, v, g, p, m, v), 10.0 * n,
                f"[{n}] float16 p and g, float32 moments", max(errs))
            del p16, g16, m16, v16
        del p, g, m, v, want, got, terms
        torch.cuda.empty_cache()
    # the BN epilogue: the ResNet-50 stem's rows and an odd R of 49
    for rows, w, where in ((256 * 64, 12544, "stem"), (65535, 49, "odd R")):
        x, g = randn(rows, w), randn(rows, w)
        mul = 0.5 + torch.rand(rows, generator=gen, device=dev)
        add = randn(rows, dtype=torch.float32, s=0.5)
        for relu in (True, False):
            case = f"[{rows},{w}] {where} relu={relu}"
            want = ck.bn_epilogue_plain(x, mul, add, relu)
            err_f = check_within("bn_epilogue_fwd", "y", h, case,
                                 ck._epilogue_fwd(x, mul, add, relu), want,
                                 ck.bn_epilogue_fwd_allowed(x, mul, add, want),
                                 ck.FWD_ROUNDING_RULE)
            got = ck.bn_epilogue_bwd(x, mul, add, g, relu)
            want_b = ck.bn_epilogue_bwd_plain(x, mul, add, g, relu)
            errs = [check_within("bn_epilogue_bwd", what, h, case, a, b, t, rule)
                    for what, a, b, t, rule in zip(
                        ("dx", "dmul", "dadd"), got, want_b,
                        epilogue_bwd_allowed(x, mul, g, want_b),
                        ("one float16 step of |plain|", "1e-5*sum|g*x| of the row",
                         "1e-5*sum|g| of the row"))]
            again = ck.bn_epilogue_bwd(x, mul, add, g, relu)
            for what, i in (("dmul", 1), ("dadd", 2)):
                repeatable("bn_epilogue_bwd", f"{what} {case} float16", got[i], again[i])
            del got, want_b, again
            if where == "stem" and relu:
                mul_x, add_x = mul.to(h)[:, None], add.to(h)[:, None]
                y = want

                def library_bwd():
                    gm = torch.ops.aten.threshold_backward(g, y, 0)
                    gm * mul_x
                    (gm * x).sum(-1, dtype=torch.float32)
                    gm.sum(-1, dtype=torch.float32)

                record["bn_epilogue_fwd"][f"at_{rows}x{w}_f16"] = f16_timing(
                    "bn_epilogue_fwd", lambda: ck._epilogue_fwd(x, mul, add, True),
                    lambda: ck.bn_epilogue_plain(x, mul, add, True),
                    lambda: torch.addcmul(add_x, x, mul_x).relu_(),
                    "torch.addcmul(add, x, mul).relu_() f16: two calls",
                    2 * nbytes(x) + 8 * rows, 3.0 * x.numel(), f"[{rows},{w}] f16 relu", err_f)
                record["bn_epilogue_bwd"][f"at_{rows}x{w}_f16"] = f16_timing(
                    "bn_epilogue_bwd", lambda: ck.bn_epilogue_bwd(x, mul, add, g, True),
                    lambda: ck.bn_epilogue_bwd_plain(x, mul, add, g, True), library_bwd,
                    "aten.threshold_backward(g, y, 0), then gm*mul, (gm*x).sum(-1) and "
                    "gm.sum(-1) f16: five calls",
                    3 * nbytes(x) + 16 * rows, 6.0 * x.numel(), f"[{rows},{w}] f16 relu",
                    max(errs))
                big = mul * 4e4
                want = ck.bn_epilogue_plain(x, big, add, False)
                hold_overflow("bn_epilogue_fwd", "y", f"{case}, mul x 4e4",
                              ck._epilogue_fwd(x, big, add, False), want,
                              ck.bn_epilogue_fwd_allowed(x, big, add, want))
                del y
        del x, g
        torch.cuda.empty_cache()


def hold_adam_at(torch, ck, record, gen, n, where):
    """Adam over one float32 parameter of `n` elements against its plain
    version element by element (2^-20 of its terms), timed with its plain
    version and torch._fused_adam_, added to `record` under at_<n>_f32."""
    dev = torch.device("cuda:0")
    f32 = torch.float32
    p = torch.randn(n, generator=gen, device=dev) * 0.02
    g = torch.randn(n, generator=gen, device=dev) * 0.01
    m = torch.randn(n, generator=gen, device=dev) * 0.01
    v = (0.5 + torch.rand(n, generator=gen, device=dev)) * 1e-4
    lr_t = torch.full((1,), 1e-3, device=dev)
    want = ck.adam_plain(p, g, m, v, lr_t, 0.9, 0.999, 1e-8)
    got = ck.fused_adam(p.clone(), g, m.clone(), v.clone(), lr_t, 0.9, 0.999, 1e-8)
    terms_m = 0.9 * m.abs() + 0.1 * g.abs()
    terms_v = 0.999 * v + 0.001 * g * g
    terms_p = p.abs() + lr_t * terms_m / (want[2].sqrt() + 1e-8)
    err = max(check_within("adam", what, f32, f"n={n} ({where})", a, c,
                           F32_ERR * terms + 1e-30, "2^-20*|terms|")
              for what, terms, a, c in zip(("p", "m", "v"), (terms_p, terms_m, terms_v),
                                          got, want))
    step = torch.zeros((), device=dev)
    b_ms, b_by = bound(nbytes(p, m, v, g, p, m, v), 10.0 * n, F32_FLOPS)
    record["adam"][f"at_{n}_f32"] = dict(
        max_abs_err=err, ms=time_ms(lambda: ck.fused_adam(p, g, m, v, lr_t, 0.9, 0.999, 1e-8)),
        plain_ms=time_ms(lambda: ck.adam_plain(p, g, m, v, lr_t, 0.9, 0.999, 1e-8)),
        library_ms=time_ms(lambda: torch._fused_adam_(
            [p], [g], [m], [v], [], [step], lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.0,
            eps=1e-8, amsgrad=False, maximize=False)),
        library="torch._fused_adam_ on one tensor", bound_ms=b_ms, bound_by=b_by,
        shape=f"[{n}] float32 ({where})")
    del p, g, m, v, got, want, terms_m, terms_v, terms_p
    torch.cuda.empty_cache()


def check_vision_kernels(torch, ck, record):
    """Phase 3, the shapes the fluid_benchmark family gives the kernels, in
    float32 as the models are built: the BN epilogue forward and backward at
    SE-ResNeXt-50's first stage ([64*128, 56*56] with relu, the grouped
    conv's output; [64*256, 56*56] without, the block's last batch norm, the
    squeeze-excitation's input) and VGG-16's first block ([64*64, 224*224]
    with relu); the cross-entropy forward and backward at [64, 1000]; Adam at
    VGG-16's largest parameter (25088 x 512).  Each against its plain version
    (the forward at FUSED_KERNELS' tolerances, the backward element by
    element), timed with its plain version and a library call, and added to
    `record` under at_<shape>_f32."""
    import torch.nn.functional as F

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * s

    def timed(err, fn, plain, library, library_name, bytes_moved, ops, shape):
        b_ms, b_by = bound(bytes_moved, ops, F32_FLOPS)
        return dict(max_abs_err=err, ms=time_ms(fn), plain_ms=time_ms(plain),
                    library_ms=time_ms(library), library=library_name, bound_ms=b_ms,
                    bound_by=b_by, shape=shape)

    f32 = torch.float32
    for rows, w, relu, where in ((64 * 128, 3136, True, "se_resnext_stage1"),
                                 (64 * 256, 3136, False, "se_resnext_stage1_out"),
                                 (64 * 64, 50176, True, "vgg_block1")):
        x, g = randn(rows, w), randn(rows, w)
        mul = 0.5 + torch.rand(rows, generator=gen, device=dev)
        add = randn(rows, s=0.5)
        case = f"[{rows},{w}] {where} relu={relu}"
        err_f = check("bn_epilogue_fwd", "y", f32, case, ck._epilogue_fwd(x, mul, add, relu),
                      ck.bn_epilogue_plain(x, mul, add, relu), TOL["float32"]["bn_epilogue_fwd"])
        got = ck.bn_epilogue_bwd(x, mul, add, g, relu)
        want = ck.bn_epilogue_bwd_plain(x, mul, add, g, relu)
        allowed = epilogue_bwd_allowed(x, mul, g, want)
        rules = ("one rounding of |plain|", "1e-5*sum|g*x| of the row", "1e-5*sum|g| of the row")
        err_b = max(check_within("bn_epilogue_bwd", what, f32, case, a, b, t, rule)
                    for what, a, b, t, rule in zip(("dx", "dmul", "dadd"), got, want, allowed,
                                                   rules))
        del got, want, allowed
        mul_x, add_x = mul[:, None], add[:, None]
        y = ck.bn_epilogue_plain(x, mul, add, relu)
        key = f"at_{rows}x{w}_{where}_f32"
        shape = f"[{rows},{w}] f32 relu={relu} ({where})"
        record["bn_epilogue_fwd"][key] = timed(
            err_f, lambda: ck._epilogue_fwd(x, mul, add, relu),
            lambda: ck.bn_epilogue_plain(x, mul, add, relu),
            (lambda: torch.addcmul(add_x, x, mul_x).relu_()) if relu
            else (lambda: torch.addcmul(add_x, x, mul_x)),
            "torch.addcmul(add, x, mul)" + (".relu_(): two calls" if relu else ""),
            2 * nbytes(x) + 8 * rows, 3.0 * x.numel(), shape)

        def library_bwd():
            gm = torch.ops.aten.threshold_backward(g, y, 0) if relu else g
            gm * mul_x
            (gm * x).sum(-1)
            gm.sum(-1)

        record["bn_epilogue_bwd"][key] = timed(
            err_b, lambda: ck.bn_epilogue_bwd(x, mul, add, g, relu),
            lambda: ck.bn_epilogue_bwd_plain(x, mul, add, g, relu), library_bwd,
            ("aten.threshold_backward(g, y, 0), then " if relu else "") +
            "gm*mul, (gm*x).sum(-1) and gm.sum(-1)", 3 * nbytes(x) + 16 * rows,
            6.0 * x.numel(), shape)
        del x, g, y
        torch.cuda.empty_cache()
    # the cross-entropy at the conv nets' [64, 1000], every row labelled
    logits = randn(64, 1000, s=2.0)
    labels = torch.randint(0, 1000, (64,), generator=gen, device=dev)
    err_f, _ = hold_xent_fwd(torch, ck, logits, labels, "[64,1000] f32")
    loss, lse = ck.softmax_xent_fwd(logits, labels, -100)
    gl = 1.0 + torch.rand(64, generator=gen, device=dev)
    dx = ck.softmax_xent_bwd(logits, labels, lse, gl, -100)
    dx_p = ck.softmax_xent_bwd_plain(logits, labels, lse, gl, -100)
    err_b = check_within("softmax_xent_bwd", "dlogits", f32, "[64,1000] f32", dx, dx_p,
                         XENT_BWD_REL["float32"] * dx_p.abs() + 1e-12, "1e-06*|plain| + 1e-12")
    lab64 = labels.long()
    row = 1000 * 4
    record["softmax_xent_fwd"]["at_64x1000_f32"] = timed(
        err_f, lambda: ck.softmax_xent_fwd(logits, labels, -100),
        lambda: ck.softmax_xent_fwd_plain(logits, labels, -100),
        lambda: F.cross_entropy(logits, lab64, reduction="none"),
        "F.cross_entropy(reduction='none')", 64 * row + 64 * 8 + 64 * 8, 4.0 * 64 * 1000,
        "[64,1000] f32")
    lx = logits.detach().requires_grad_()
    lib_loss = F.cross_entropy(lx, lab64, reduction="none")
    record["softmax_xent_bwd"]["at_64x1000_f32"] = timed(
        err_b, lambda: ck.softmax_xent_bwd(logits, labels, lse, gl, -100),
        lambda: ck.softmax_xent_bwd_plain(logits, labels, lse, gl, -100),
        lambda: torch.autograd.grad(lib_loss, lx, gl, retain_graph=True),
        "backward of F.cross_entropy(reduction='none')", 2 * 64 * row + 64 * 16,
        4.0 * 64 * 1000, "[64,1000] f32")
    del lx, lib_loss
    # Adam at VGG-16's fc over the flattened 7 x 7 x 512 features
    hold_adam_at(torch, ck, record, gen, 25088 * 512, "VGG-16 fc")
    for name in ("bn_epilogue_fwd", "bn_epilogue_bwd", "softmax_xent_fwd", "softmax_xent_bwd",
                 "adam"):
        emit({"timing": name, **{k: r for k, r in record[name].items()
                                 if k.startswith("at_") and k.endswith("_f32")}})


def build_bert(fluid, dtype, n_layers, score_dtype=None):
    """Full-width BERT-base, random weights from seed 0, run through the two fusion
    passes; returns (main, startup, logits name)."""
    from paddle_tpu_torch.models import transformer

    with fluid.unique_name.guard():
        main, startup, _, _ = transformer.build_bert(
            vocab_size=30522, seq_len=128, d_model=768, n_layers=n_layers, n_heads=12,
            d_ff=3072, dtype=dtype, use_fused_attention=True, with_optimizer=False,
            attention_score_dtype=score_dtype)
    startup.random_seed = 0
    logits = next(op for op in main.global_block().ops
                  if op.type == "softmax_with_cross_entropy").input("Logits")[0]
    for p in ("fuse_ln_residual", "fuse_bias_act"):
        fluid.passes.apply_pass(main, p, keep=[logits])
    return main, startup, logits


def save_model(fluid, torch, dirname, dtype, n_layers, unit_ln_scale=False, score_dtype=None):
    main, startup, logits = build_bert(fluid, dtype, n_layers, score_dtype)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if unit_ln_scale:
        # LN gains near 1 keep the activations O(1) through the layers, so the
        # parity check below compares numbers of a realistic size
        for p in main.all_parameters():
            if p.name.endswith(("emb_ln.w", ".ln1.w", ".ln2.w")):
                scope.set_var(p.name, torch.ones_like(scope.find_var(p.name)))
    fluid.io.save_inference_model(dirname, ["ids", "pos_ids"], [logits], exe, main, scope)
    return logits


def serve(fluid, torch, ck, tmp, card):
    """Phase 4: bf16 BERT-base through AnalysisConfig / create_predictor on
    cuda:0: an eager and a graphed predictor in turns (AB_ARMS), REQUESTS
    requests at each batch of BATCHES a turn, timed as run (to the
    device's end) and fetch (the host copy); the graphed predictor's
    logits equal the eager one's within the bf16 forward tolerance; a
    batch-32 fetch is staged through pinned host memory."""
    import numpy as np
    from paddle_tpu_torch.core.dtypes import to_numpy
    from paddle_tpu_torch.models.transformer import make_fake_batch

    model_dir = os.path.join(tmp, "bert_base_bf16")
    t0 = time.perf_counter()
    save_model(fluid, torch, model_dir, "bfloat16", 12)
    predictors = {}
    for arm in ("eager", "graphed"):
        config = fluid.inference.AnalysisConfig(model_dir)
        config._graphs = arm == "graphed"
        predictors[arm] = fluid.inference.create_predictor(config)
    emit({"phase": "serve", "model": "bert-base bf16", "setup_s": time.perf_counter() - t0,
          "place": repr(predictors["graphed"].config.place)})
    rng = np.random.RandomState(0)
    feeds = {b: make_fake_batch(b, 128, 30522, rng=rng) for b in BATCHES}
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()  # the main path's count starts here
    runs = {arm: dict.fromkeys(BATCHES, 0) for arm in predictors}
    warm = {arm: {b: [] for b in BATCHES} for arm in predictors}
    eager_logits = {}
    for turn, arm in enumerate(AB_ARMS):
        predictor = predictors[arm]
        fluid.monitor.reset()
        indices = []
        for batch in BATCHES:
            for _ in range(REQUESTS):
                i = runs[arm][batch]
                indices.append(i)
                runs[arm][batch] += 1
                before = dict(ck.LAUNCHES)
                t0 = time.perf_counter()
                (out,) = predictor.run(feeds[batch], return_numpy=False)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                logits = to_numpy(out)
                t2 = time.perf_counter()
                delta = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
                replayed = hold_run_launches(predictor.exe, i, delta, PER_REQUEST,
                                             f"serve {arm} batch {batch}", "serve")
                emit({"request": batch, "arm": arm, "graphed": replayed,
                      "latency_ms": (t2 - t0) * 1e3, "run_ms": (t1 - t0) * 1e3,
                      "fetch_ms": (t2 - t1) * 1e3, "logits_shape": list(logits.shape),
                      "launches": delta, "card": card})
                if logits.shape != (batch * 128, 30522) or not np.isfinite(logits).all():
                    raise AssertionError(f"batch {batch}: logits {logits.shape}, finite="
                                         f"{bool(np.isfinite(logits).all())}")
                if i >= (2 if arm == "graphed" else 1):  # warm: past warm-up and capture
                    warm[arm][batch].append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
                if arm == "eager" and batch not in eager_logits:
                    eager_logits[batch] = logits
                elif arm == "graphed" and i == 2:
                    # bf16 arrays (ml_dtypes) subtract in bf16: widen first
                    diff = float(np.abs(logits.astype(np.float32)
                                        - eager_logits[batch].astype(np.float32)).max())
                    emit({"request": batch, "graphed_vs_eager_max_abs_dlogits": diff,
                          "tol": TOL["bfloat16"]["ln_residual_fwd"]})
                    if not diff <= TOL["bfloat16"]["ln_residual_fwd"]:
                        raise AssertionError(f"batch {batch}: graphed vs eager logits differ "
                                             f"by {diff}")
        read_monitor(f"serve {arm} turn {turn}", monitor_want(indices, arm == "graphed"), card)
    del eager_logits
    launches = dict(ck.LAUNCHES)  # read before the checks and profiled requests below
    emit({"phase": "serve", "card": card, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "reserved_gb": torch.cuda.memory_reserved() / 1e9,
          "warm": {arm: {str(b): {"run_ms": statistics.median(r for r, _ in v),
                                  "fetch_ms": statistics.median(f for _, f in v),
                                  "requests": len(v)} for b, v in per.items()}
                   for arm, per in warm.items()}})
    # the fetch of return_numpy=True goes through pinned host memory
    staged, real_empty = [], torch.empty

    def spy(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        if kwargs.get("pin_memory"):
            staged.append({"shape": list(t.shape), "dtype": str(t.dtype), "pinned": t.is_pinned()})
        return t

    big = BATCHES[-1]
    torch.empty = spy
    try:
        t0 = time.perf_counter()
        (logits,) = predictors["graphed"].run(feeds[big])
        request_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.empty = real_empty
    # where the fetch's time goes: the pinned copy, the view of the bf16
    # copy as an ml_dtypes array (no widening, ROADMAP C1), the whole fetch
    # (host_copies), and beside them a pageable copy; each timed twice, the
    # second kept (the caching host allocator then has the pinned blocks, as
    # a serving loop's fetches find them)
    from paddle_tpu_torch.core.dtypes import _as_numpy, host_copies

    (out,) = predictors["graphed"].run(feeds[big], return_numpy=False)
    split, host = {}, None
    for what in [w for w in ("pinned_copy", "host_view", "host_copies", "pageable_copy")
                 for _ in range(2)]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if what == "pinned_copy":
            host = None  # back to the allocator's cache first
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            torch.cuda.synchronize()
        elif what == "host_view":
            _as_numpy(host)
        elif what == "host_copies":
            host_copies([out])
        else:
            out.cpu()
        split[f"{what}_ms"] = (time.perf_counter() - t0) * 1e3
    bits_kept = bool(np.array_equal(logits.view(np.uint16),
                                     out.view(torch.int16).cpu().numpy().view(np.uint16)))
    emit({"phase": "serve_fetch", "batch": big, "request_ms": request_ms, "staged": staged,
          "bytes": out.numel() * out.element_size(), "numpy_dtype": str(logits.dtype),
          "bits_kept": bits_kept, **split, "card": card})
    if not (len(staged) == 1 and staged[0]["pinned"] and staged[0]["dtype"] == "torch.bfloat16"
            and logits.shape == (big * 128, 30522)):
        raise AssertionError(f"the batch-{big} fetch was not staged through pinned memory: {staged}")
    if not (logits.dtype.name == "bfloat16" and bits_kept):
        raise AssertionError(f"the batch-{big} fetch is {logits.dtype}, bits kept {bits_kept}: "
                             "a bf16 fetch is an ml_dtypes bfloat16 array of the card's bits")
    profile_replay(torch, f"serve graphed request {big}",
                   lambda: predictors["graphed"].run(feeds[big], return_numpy=False), card,
                   PER_REQUEST)
    profile_run(torch, f"serve eager request {big}",
                lambda: predictors["eager"].run(feeds[big], return_numpy=False), card)
    return launches


# idle host time at each end of a profiler session: the profiler keeps only
# the records it places inside its window, and it places a kernel by a
# conversion of the card's clock to the host's, which can be off by
# milliseconds for a whole process (phase 24 once missed one of the step's
# LayerNorm forwards in every session of a process)
PROFILE_MARGIN_S = 0.05
# spin kernels launched at both ends of a profiler session and left out of
# every count: late in a long process the profiler dropped 13 kernel
# records at an end of every session (a graphed SE-ResNeXt-50 request
# showed 1,221 of its 1,234 kernels, one BN epilogue among the lost, three
# times)
PROFILE_PAD_KERNELS = 64
PAD_KERNEL = re.compile(r"\bspin_kernel\b")


def pad_session(torch):
    """PROFILE_PAD_KERNELS spin kernels, at each end of a profiler session,
    so that the records the profiler drops there are theirs."""
    for _ in range(PROFILE_PAD_KERNELS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def profile_run(torch, what, run, card):
    """One more warm run of `run()` under torch.profiler: device time by kernel
    (the ten largest, and every kernel of the port's own) and the device's
    idle share of the run (profiler overhead included).  Returns the port's
    kernels that ran, by LAUNCHES key (a CUDA graph's replay shows each of
    its kernels, so a replayed step's launches are read here), and the
    record."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad_session(torch)
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
        pad_session(torch)
        time.sleep(PROFILE_MARGIN_S)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not PAD_KERNEL.search(e.key)]
    host_ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                and e.key.startswith("aten::")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    top_host = sorted(host_ops, key=lambda e: -e.self_cpu_time_total)[:10]
    # the port's own kernels (csrc/), whatever their rank
    ours = sorted((e for e in kernels if PORT_KERNEL.search(e.key)),
                  key=lambda e: -e.self_device_time_total)
    counts = dict(NONE)
    for e in ours:
        key = KERNEL_KEY.get(KERNEL_OF.search(e.key).group(1))
        if key is not None:
            if BF16_SCORES_OF.search(e.key):
                key += "_bf16_scores"
            counts[key] += e.count
    record = {"profile": what, "run_ms": run_ms, "device_busy_ms": busy_us / 1e3,
              "device_idle_share": 1.0 - busy_us / 1e3 / run_ms, "card": card,
              "kernel_launches": sum(e.count for e in kernels),
              "graph_launches": sum(e.count for e in events if e.key == "cudaGraphLaunch"),
              "host_aten_calls": sum(e.count for e in host_ops),
              "port_kernel_launches": {k: v for k, v in counts.items() if v},
              "top_kernels": [{"name": e.key[:80], "calls": e.count,
                               "device_ms": e.self_device_time_total / 1e3} for e in top],
              "port_kernels": [{"name": e.key[:80], "calls": e.count,
                                "device_ms": e.self_device_time_total / 1e3} for e in ours],
              "top_host_ops": [{"name": e.key, "calls": e.count,
                                "self_cpu_ms": e.self_cpu_time_total / 1e3} for e in top_host]}
    emit(record)
    return counts, record


# each training phase's arm records (train_arm), by phase: phase 42's long
# arm prints its step beside phase 13's
ARM_RECORDS = {}
KEPT = {}  # train(keep=True): phase -> its first graphed arm's program, losses and state
ARMS_BUILD_LOCK = threading.Lock()  # start_cpu_arms: one lane builds programs at a time

# the kernels that replays ran on each path of the kernels line, by path: a
# replay runs no wrapper, so hold_run_launches adds the graph's launches
# (held at its capture, and read off a profiled replay by profile_replay)
# for each run after the capture
REPLAYED = {}


def hold_run_launches(exe, run_index, delta, per_run, what, path=None):
    """Hold the launches the wrappers counted in one run of a plan: an eager
    plan counts `per_run` every run; a graphed one counts them at its first
    run (eager, the warm-up) and its second (the capture, which records one
    step into the graph and then replays it), and none after (replays), and
    its graph must hold exactly `per_run`.  A replay after the capture adds
    `per_run` to REPLAYED[path].  Returns whether the run replayed a
    graph."""
    plan = exe.last_plan
    want = per_run if not plan.graphable or run_index < 2 else NONE
    if delta != want:
        raise AssertionError(f"{what}, run {run_index}: launches {delta} != {want}")
    replayed = plan.graphable and run_index >= 1
    if replayed and not (plan.graphed and plan.captured_launches == per_run):
        raise AssertionError(f"{what}, run {run_index}: no graph holding {per_run} was replayed "
                             f"(graphed {plan.graphed}, captured {plan.captured_launches})")
    if path is not None and replayed and run_index >= 2:
        add_launches(REPLAYED.setdefault(path, dict(NONE)), per_run)
    return replayed


def monitor_want(run_indices, graphed, refused=0):
    """The executor's counters over runs of plans whose indices (each the
    plan's how-many-th run, from 0) are `run_indices`: a cache miss at a
    plan's first run and a hit after, one step record a run; a graphed
    plan captures at its second run and replays from there on; `refused`
    plans built with their graph refused; the verifier runs at each miss."""
    want = {"executor.cache_miss": sum(i == 0 for i in run_indices),
            "executor.cache_hit": sum(i > 0 for i in run_indices),
            "executor.steps": len(run_indices), "executor.graph_refused": refused,
            # the verifier runs once per plan-cache miss (FLAGS_verify_program)
            "analysis.verify_runs": sum(i == 0 for i in run_indices)}
    if graphed:
        want["executor.graph_capture"] = sum(i == 1 for i in run_indices)
        want["executor.graph_replay"] = sum(i > 0 for i in run_indices)
    return {k: v for k, v in want.items() if v}


def read_monitor(what, want, card):
    """The executor layer's metrics (PERF.md section 3) over the runs since
    the monitor's last reset: its counters (the executor's and the
    verifier's runs held equal to `want`, monitor_want; the others, such
    as the verifier's diagnostics, printed); the spans executor.dispatch
    (feeds in, plan found, the step enqueued), executor.fetch (host copies
    and the NaN/Inf guard), executor.build (a miss's plan) and
    analysis.verify (a miss's check_program), with calls, mean, min and
    max ms; each
    run's dispatch ms, in order, from the step records (the first runs of a
    plan, warm-up and capture, dominate the mean); the memory gauges.
    Emitted, then the monitor is reset.  Returns the record."""
    from paddle_tpu_torch import monitor

    mon = monitor.get_monitor()
    counters = {k: v for k, v in mon.counter_values().items() if v}
    spans = {n: {"calls": a["calls"], "mean_ms": a["total_s"] / a["calls"] * 1e3,
                 "min_ms": a["min_s"] * 1e3, "max_ms": a["max_s"] * 1e3}
             for n, a in sorted(mon.span_stats().items())}
    dispatch = [r["t_dispatch_s"] * 1e3 for r in mon.step_records() if r["kind"] == "step"]
    gauges = {n: mon.gauge(n).read() for n in ("memory.device_bytes_in_use",
                                                "memory.device_bytes_reserved",
                                                "memory.device_alloc_retries")}
    record = {"monitor": what, "counters": counters, "spans": spans,
              "dispatch_ms_by_run": dispatch, "gauges": gauges, "card": card}
    emit(record)
    monitor.reset()
    held = {k: v for k, v in counters.items()
            if k.startswith("executor.") or k == "analysis.verify_runs"}
    if held != want:
        raise AssertionError(f"{what}: the executor's monitor counted {held} != {want}")
    return record


def profile_replay(torch, what, run, card, per_run):
    """profile_run of a graph's replay, whose port kernels must equal the
    reckoned launches `per_run`.  The profiler once lost the first ~500
    kernel records of a 3,189-kernel replay (12.6 of its 17.0 ms of kernels
    seen, the forward's uncounted), and in other processes the first 14 or
    the last 13 of every session (PROFILE_MARGIN_S, PROFILE_PAD_KERNELS),
    so a replay whose count differs is profiled again, up to 3 times: the
    graph replays the same kernels every time, so a wrong graph never
    passes.  Returns the passing record."""
    for attempt in range(3):
        counts, record = profile_run(torch, what, run, card)
        emit({"replay_launches": what, "graphed": True, "attempt": attempt, "launches": counts})
        if counts == per_run:
            return record
    raise AssertionError(f"{what}: the profiled graph replay launched {counts} != {per_run}")


def add_launches(total, delta):
    for k, v in delta.items():
        total[k] += v


def parity(fluid, torch, tmp):
    """Phase 5: float32 logits on the card against the CPU plain path."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    model_dir = os.path.join(tmp, "bert_base_f32_2l")
    save_model(fluid, torch, model_dir, "float32", 2, unit_ln_scale=True)
    feed = make_fake_batch(2, 128, 30522, rng=np.random.RandomState(1))
    inf = fluid.inference
    gpu = inf.create_predictor(inf.AnalysisConfig(model_dir)).run(feed)[0]
    cpu = inf.create_predictor(inf.AnalysisConfig(model_dir, fluid.CPUPlace())).run(feed)[0]
    diff = float(np.abs(gpu - cpu).max())
    emit({"phase": "parity", "model": "bert-base f32, 2 layers", "max_abs_dlogits": diff,
          "max_abs_logits": float(np.abs(cpu).max()), "tol": 1e-3})
    if not diff <= 1e-3:
        raise AssertionError(f"card vs CPU logits differ by {diff} > 1e-3")


def build_train(fluid, dtype, n_layers, dropout_prob, seq_len=128, fused=False,
                clip_decay=False, optimizer=None, score_dtype=None, learning_rate=LR):
    """Full-width BERT-base with Adam(LR).minimize(loss), unfused attention or
    the fused_attention op, through the two fusion passes; returns (main,
    startup, loss name).  `clip_decay` builds it as a fine-tuning user does:
    Adam(LR, regularization=L2Decay(WEIGHT_DECAY)) under
    set_gradient_clip(GradientClipByGlobalNorm(CLIP_NORM)), the program's
    shapes inferred by the port's own layers; the global norm's var then
    stays fetchable (global_norm_name).  `optimizer` names one of
    make_optimizer's in place of Adam ("backward_only": the gradients and
    no update).  `learning_rate` is Adam's (default LR)."""
    from paddle_tpu_torch.models import transformer

    with fluid.unique_name.guard():
        main, startup, _, fetches = transformer.build_bert(
            vocab_size=30522, seq_len=seq_len, d_model=768, n_layers=n_layers, n_heads=12,
            d_ff=3072, dtype=dtype, dropout_prob=dropout_prob, learning_rate=learning_rate,
            use_fused_attention=fused, with_optimizer=not (clip_decay or optimizer),
            attention_score_dtype=score_dtype)
        if clip_decay:
            with fluid.program_guard(main, startup):
                fluid.clip.set_gradient_clip(fluid.clip.GradientClipByGlobalNorm(CLIP_NORM))
                fluid.optimizer.Adam(LR, regularization=fluid.regularizer.L2Decay(
                    WEIGHT_DECAY)).minimize(fetches["loss"])
        elif optimizer == "backward_only":
            with fluid.program_guard(main, startup):
                fluid.append_backward(fetches["loss"])
        elif optimizer:
            with fluid.program_guard(main, startup):
                make_optimizer(fluid, optimizer).minimize(fetches["loss"])
    startup.random_seed = 0
    main.random_seed = 0
    loss = fetches["loss"].name
    keep = [loss] + ([global_norm_name(main)] if clip_decay else [])
    for p in ("fuse_ln_residual", "fuse_bias_act"):
        fluid.passes.apply_pass(main, p, keep=keep)
    return main, startup, loss


def global_norm_name(main):
    """The var GradientClipByGlobalNorm's sqrt writes: the gradients' global norm."""
    return next(op for op in main.global_block().ops if op.type == "sqrt").output("Out")[0]


def clip_decay_ops(main):
    """Op counts of the clip and decay tail, between the backward and the updates."""
    ops = [op.type for op in main.global_block().ops]
    tail = ops[ops.index("backward") + 1:]
    return {t: tail.count(t) for t in sorted(set(tail)) if t != "adam"}


def launches_of_program(main, loss):
    """Kernel launches one step of `main` makes, read off its pruned ops: every
    layer_norm takes the LN kernel (nothing reads its Mean/Variance), every
    elementwise_add with fuse_act over a 1-D bias the bias-act kernel, every
    batch_norm over NC + spatial dims the BN epilogue, a hard-label loss the
    xent kernel, every adam op the Adam kernel (save a lazy_mode one over a
    sparse table's SelectedRows gradient), every fused_attention op the
    attention forward; each forward kernel has its backward (attention: the
    dQ and the dK/dV kernel)."""
    from paddle_tpu_torch.core.executor import _prune, _runnable_ops

    block = main.global_block()
    persistable = {v.name for v in main.list_vars() if v.persistable}
    ops = _prune(_runnable_ops(block), [loss], persistable)
    read = {n for op in ops for n in op.input_arg_names}
    lns = [op for op in ops if op.type == "layer_norm"]
    if any(n in read for op in lns for n in op.output("Mean") + op.output("Variance")):
        raise AssertionError("a layer_norm's statistics are read: it would not take the kernel")
    n_ln = len(lns)
    n_act = sum(1 for op in ops if op.type == "elementwise_add" and op.attrs.get("fuse_act")
                and len(block.var(op.input("Y")[0]).shape) == 1)
    n_bn = sum(1 for op in ops if op.type == "batch_norm"
               and len(block.var(op.input("X")[0]).shape) >= 3)
    # a soft-label loss (NMT's label smoothing) takes the composite
    n_xent = sum(1 for op in ops if op.type == "softmax_with_cross_entropy"
                 and not op.attrs.get("soft_label"))
    # a lazy_mode adam op over a SelectedRows gradient updates its rows in plain torch
    sparse = {n for op in ops if op.type == "backward" for n in op.attrs.get("sparse_param_names", [])}
    n_adam = sum(1 for op in ops if op.type == "adam" and not (
        op.attrs.get("lazy_mode") and op.input("Param")[0] in sparse))
    attn = [op for op in ops if op.type == "fused_attention"]
    n_bs = sum(1 for op in attn if op.attrs.get("score_dtype") == "bfloat16")
    n_attn = len(attn) - n_bs
    return dict(NONE, ln_residual_fwd=n_ln, ln_residual_bwd=n_ln, bias_act_fwd=n_act,
                bias_act_bwd=n_act, softmax_xent_fwd=n_xent, softmax_xent_bwd=n_xent,
                adam=n_adam, bn_epilogue_fwd=n_bn, bn_epilogue_bwd=n_bn, attention_fwd=n_attn,
                attention_bwd_dkv=n_attn, attention_bwd_dq=n_attn,
                attention_fwd_bf16_scores=n_bs, attention_bwd_dkv_bf16_scores=n_bs,
                attention_bwd_dq_bf16_scores=n_bs)


def train_arm(fluid, torch, ck, card, phase, arm, main, startup, loss, feed, per_step,
              launches, tokens, check_first_step=None, watch=(), snapshot=None):
    """TRAIN_STEPS steps of `main` on one fixed `feed` through a fresh
    Executor(CUDAPlace(0)) and scope, eager or graphed (`arm`): every loss
    finite, the last below the first, each step's launches held
    (hold_run_launches), added to `launches`, the executor's monitor read
    (read_monitor); then one step profiled (a graphed arm's replay must
    launch exactly `per_step`).  Returns the losses, the scope and the
    arm's record (warm step: the median of steps 3-6, past the warm-up and
    the capture).  The scope's scalar vars named in `watch` are printed
    after each step and kept in the record.  `snapshot(losses, scope)`,
    when given, is called after the TRAIN_STEPS steps, before the profiled
    one."""
    import numpy as np

    exe = fluid.Executor(fluid.CUDAPlace(0), _graphs=arm == "graphed")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if check_first_step is not None:
        check_first_step(scope, None)
    fluid.monitor.reset()
    gc.collect()  # an earlier phase's plans and scopes, freed before the peak is read
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated() / 1e9  # this arm's scope and whatever else lives
    losses, step_ms, watched = [], [], []
    for step in range(TRAIN_STEPS):
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        (out,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.reshape(-1)[0]))
        watched.append({n: float(scope.find_var(n).reshape(-1)[0]) for n in watch})
        delta = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
        add_launches(launches, delta)
        replayed = hold_run_launches(exe, step, delta, per_step, f"{phase} {arm}", phase)
        emit({"phase": phase, "arm": arm, "step": step, "graphed": replayed, "loss": losses[-1],
              "step_ms": step_ms[-1], "launches": delta, "card": card, **watched[-1]})
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"{phase} {arm} step {step}: loss {losses[-1]}")
        if step == 0 and check_first_step is not None:
            check_first_step(scope, step)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if snapshot is not None:
        snapshot(list(losses), scope)
    mon = read_monitor(f"{phase} {arm}", monitor_want(range(TRAIN_STEPS), arm == "graphed"), card)
    step = lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope,  # noqa: E731
                           return_numpy=False)
    if arm == "graphed":
        prof = profile_replay(torch, f"{phase} graphed step", step, card, per_step)
    else:
        _, prof = profile_run(torch, f"{phase} {arm} step", step, card)
    warm = statistics.median(step_ms[2:])
    record = {"phase": phase, "arm": arm, "graphed": arm == "graphed", "losses": losses,
              "warm_step_ms": warm, "steps_per_s": 1e3 / warm,
              **{f"{k}_per_s": v / warm * 1e3 for k, v in tokens.items()},
              "first_step_ms": step_ms[0], "second_step_ms": step_ms[1], "peak_mem_gb": peak,
              "start_mem_gb": start, "peak_above_start_gb": peak - start,
              "warm_dispatch_ms": statistics.median(mon["dispatch_ms_by_run"][2:]),
              "profiled_step_ms": prof["run_ms"], "device_busy_ms": prof["device_busy_ms"],
              "device_idle_share": prof["device_idle_share"],
              "host_aten_calls": prof["host_aten_calls"],
              "graph_refusal": exe.last_plan.graph_refusal, "card": card,
              **({"watched": watched} if watch else {})}
    emit(record)
    return losses, scope, record


def hold_graphed_repeat(phase, runs):
    """Two graphed arms from one seed (dropout included) agree bit for bit in
    every loss and every persistable."""
    import torch

    (l1, s1), (l2, s2) = runs
    names = sorted(s1.local_var_names())
    differ = [n for n in names if n != "__rng_state__" and isinstance(s1.find_var(n), torch.Tensor)
              and not torch.equal(s1.find_var(n), s2.find_var(n))]
    same = l1 == l2 and not differ
    emit({"phase": "graph_repeat", "of": phase, "losses": [l1, l2], "bitwise_equal": same,
          "persistables": len(names), "persistables_that_differ": differ[:8]})
    if not (same and all(map(math.isfinite, l1))):
        raise AssertionError(f"{phase}: two graphed runs from one seed differ: losses {l1} / {l2}, "
                             f"persistables {differ[:8]}")


def train(fluid, torch, ck, card, phase="train", fused=False, seq_len=128, batch=32,
          per_step=PER_STEP, arms=("graphed",), clip_decay=False, optimizer=None,
          score_dtype=None, keep=False):
    """Phases 6, 12, 13 and 24: bf16 BERT-base (12 layers, dropout 0.1, Adam
    lr 1e-4) trains TRAIN_STEPS steps through Executor.run on cuda:0 on one
    fixed batch of `batch` x `seq_len`, with unfused attention (phase 6) or
    the fused_attention op (12: seq 128, batch 32; 13: seq 2048, batch 8;
    24: phase 12 with L2Decay and a global-norm clip, `clip_decay`; 37:
    phase 12 with LAMB on its schedule, `optimizer`; 42: bf16 scores,
    `score_dtype`), once per arm of `arms` (train_arm; each arm's record
    kept in ARM_RECORDS[phase]).  Two graphed arms (the AB_ARMS of phases
    12 and 24) must agree bit for bit.  With `keep`, the first graphed
    arm's program, feed, losses and every persistable after its steps (host
    copies) are kept in KEPT[phase] (phase 75 holds its arms to them).
    Returns the launches counted."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    t0 = time.perf_counter()
    main, startup, loss = build_train(fluid, "bfloat16", 12, 0.1, seq_len, fused, clip_decay,
                                      optimizer, score_dtype)
    derived = launches_of_program(main, loss)
    if derived != per_step:
        raise AssertionError(f"the program's kernel ops {derived} != the reckoned {per_step}")
    feed = make_fake_batch(batch, seq_len, 30522, rng=np.random.RandomState(0))
    attention = "fused attention" if fused else "unfused attention"
    if score_dtype:
        attention += f", {score_dtype} scores"
    tail = (f", L2Decay({WEIGHT_DECAY}), GradientClipByGlobalNorm({CLIP_NORM})"
            if clip_decay else "")
    opt = OPTIMIZER_NAMES.get(optimizer, "Adam lr 1e-4")
    emit({"phase": phase, "model": f"bert-base bf16, {attention}, dropout 0.1, {opt}{tail}",
          "batch": batch, "seq_len": seq_len, "arms": list(arms),
          "ops": len(main.global_block().ops),
          **({"clip_decay_ops": clip_decay_ops(main)} if clip_decay else {}),
          "setup_s": time.perf_counter() - t0})
    launches = dict(NONE)
    ck.reset_launches()  # the main path's count starts here
    graphed = []
    for arm in arms:
        snapshot = None
        if keep and arm == "graphed" and phase not in KEPT:
            def snapshot(losses, scope):
                KEPT[phase] = {"program": (main, startup, loss, feed), "losses": losses,
                               "state": {n: scope.find_var(n).detach().cpu()
                                         for n in scope.local_var_names()
                                         if isinstance(scope.find_var(n), torch.Tensor)}}
        losses, scope, rec = train_arm(fluid, torch, ck, card, phase, arm, main, startup, loss,
                                       feed, per_step, launches,
                                       {"sequences": batch, "tokens": batch * seq_len},
                                       snapshot=snapshot)
        ARM_RECORDS.setdefault(phase, []).append(rec)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{phase} {arm}: the loss did not fall: {losses}")
        if arm == "graphed":
            graphed.append((losses, scope))
        del scope
    if len(graphed) == 2:
        hold_graphed_repeat(phase, graphed)
    return launches


def parity_runs(fluid, main, loss, state, feed, steps=PARITY_STEPS, arms=None, also=(),
                seen=None, reference=True):
    """`steps` runs from the numpy `state` in each arm (place, graphs,
    program): by default the card (`main`, graphed from its second run),
    then the CPU (plain path).  Returns [(losses, scope)] in that order, and
    param -> the elements whose gradient in the last arm (the reference;
    none where `reference` is false) lies within ZERO_GRAD of the model's
    largest at some step.  The scalar vars named in `also` are fetched too,
    seen[arm index] = [[values] a step]."""
    import numpy as np

    arms = arms or ((fluid.CUDAPlace(0), True, main), (fluid.CPUPlace(), True, main))
    params = [p.name for p in main.all_parameters()]
    near_zero = {}
    runs = []
    for i, (place, graphs, program) in enumerate(arms):
        scope = fluid.Scope()
        # a CPU tensor made from an array shares its memory: the steps must
        # not write into `state`, which the other arms start from
        fluid.io.load_numpy_params(scope, state if place.device.type != "cpu" else {
            n: np.array(a, copy=True) for n, a in state.items()}, device=place.device)
        exe = fluid.Executor(place, _graphs=graphs)
        is_reference = reference and i == len(arms) - 1
        losses = []
        for _ in range(steps):
            out = exe.run(program, feed=feed, scope=scope, fetch_list=[loss] + list(also) + (
                [f"{p}@GRAD" for p in params] if is_reference else []))
            losses.append(float(out[0].reshape(-1)[0]))
            if seen is not None:
                seen.setdefault(i, []).append([float(v.reshape(-1)[0])
                                               for v in out[1:1 + len(also)]])
            out = out[:1] + out[1 + len(also):]
            if is_reference:
                peak = max(float(np.abs(g).max()) for g in out[1:])
                for p, g in zip(params, out[1:]):
                    small = np.abs(g) <= ZERO_GRAD * peak
                    near_zero[p] = small | near_zero[p] if p in near_zero else small
        runs.append((losses, scope))
    return runs, near_zero


def hold_parity(record, runs, near_zero, state, lr, steps=PARITY_STEPS):
    """Card against CPU after Adam steps from one state: the losses to 1e-3;
    every parameter to 1e-5, save the elements whose CPU gradient is 0 to
    rounding at some step (`near_zero`): Adam's first step moves a weight by
    lr * g / (|g| + eps), so where g is 0 to rounding the summation order can
    flip the step's sign, and those keep the bound 2*lr*steps + 1e-5 (`lr`
    the largest learning rate of the steps); the moments to 1e-4 of the
    largest of their kind.  Emits `record` with the numbers, then raises
    past a tolerance."""
    import numpy as np

    (gl, gs), (cl, cs) = runs
    dloss = max(abs(a - b) for a, b in zip(gl, cl))
    flip_tol, param_tol = 2 * lr * steps + 1e-5, 1e-5
    worst_p, worst_flip, n_excused = (0.0, ""), 0.0, 0
    for p, small in near_zero.items():
        err = np.abs(gs.to_numpy(p) - cs.to_numpy(p))
        held = err[~small]
        worst_p = max(worst_p, (float(held.max()) if held.size else 0.0, p))
        worst_flip = max(worst_flip, float(err.max()))
        n_excused += int(small.sum())
    moments = {}
    for kind in ("moment1", "moment2"):
        names = [n for n in state if n.endswith(f"_{kind}_0")]
        peak = max(float(np.abs(cs.to_numpy(n)).max()) for n in names)
        worst = max(float(np.abs(gs.to_numpy(n) - cs.to_numpy(n)).max()) for n in names)
        moments[kind] = (worst, 1e-4 * peak)
    emit({**record, "losses_card": gl, "losses_cpu": cl, "max_abs_dloss": dloss,
          "loss_tol": 1e-3, "max_abs_dparam": worst_p[0], "param": worst_p[1],
          "param_tol": param_tol, "elements_with_gradient_0_to_rounding": n_excused,
          "max_abs_dparam_all": worst_flip, "sign_flip_tol": flip_tol,
          "max_abs_dmoment": {k: w for k, (w, _) in moments.items()},
          "moment_tol": {k: t for k, (_, t) in moments.items()}})
    if not dloss <= 1e-3:
        raise AssertionError(f"card vs CPU losses differ by {dloss} > 1e-3")
    if not worst_p[0] <= param_tol:
        raise AssertionError(f"card vs CPU parameter {worst_p[1]} differs by {worst_p[0]} > "
                             f"{param_tol}")
    if not worst_flip <= flip_tol:
        raise AssertionError(f"card vs CPU parameters differ by {worst_flip} > {flip_tol}")
    for kind, (worst, tol) in moments.items():
        if not worst <= tol:
            raise AssertionError(f"card vs CPU {kind} differs by {worst} > {tol}")


def train_parity_setup(fluid, fused=False, seq_len=128, batch=2):
    """Phase 7's or 14's program, numpy state and feed: (main, loss, state, feed)."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    main, startup, loss = build_train(fluid, "float32", 2, 0.0, seq_len, fused)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = {v.name: init.to_numpy(v.name) for v in main.list_vars() if v.persistable}
    for name in state:
        if name.endswith(("emb_ln.w", ".ln1.w", ".ln2.w")):  # LN gains near 1: O(1) activations
            state[name] = np.ones_like(state[name])
    feed = make_fake_batch(batch, seq_len, 30522, rng=np.random.RandomState(1))
    return main, loss, state, feed


def train_parity_cpu(fluid, setup):
    """The CPU arm of train_parity from `setup`: ([(losses, scope)], near_zero)."""
    main, loss, state, feed = setup
    return parity_runs(fluid, main, loss, state, feed, arms=((fluid.CPUPlace(), True, main),))


def train_parity_arm(fluid, fused=False, seq_len=128, batch=2):
    """train_parity_setup and its CPU arm, for start_cpu_arms: (setup, cpu)."""
    with ARMS_BUILD_LOCK:
        setup = train_parity_setup(fluid, fused, seq_len, batch)
    return setup, train_parity_cpu(fluid, setup)


def train_parity(fluid, torch, phase="train_parity", fused=False, seq_len=128, batch=2,
                 setup=None, cpu=None):
    """Phases 7 and 14: float32 BERT-base (2 layers, dropout 0) trains
    PARITY_STEPS Adam(LR) steps on the card and on the CPU (plain path) from
    the same numpy state, held by hold_parity: unfused attention at batch 2 x
    128 (phase 7), the fused_attention op at 32 x 128 and 1 x 2048 (phase 14).
    `setup` is train_parity_setup's and `cpu` train_parity_cpu's, where
    start_cpu_arms ran the CPU arm."""
    setup = setup or train_parity_setup(fluid, fused, seq_len, batch)
    main, loss, state, feed = setup
    (cpu_run,), near_zero = cpu or train_parity_cpu(fluid, setup)
    (card_run,), _ = parity_runs(fluid, main, loss, state, feed, reference=False,
                                 arms=((fluid.CUDAPlace(0), True, main),))
    attention = "fused attention" if fused else "unfused attention"
    hold_parity({"phase": phase, "model": f"bert-base f32, 2 layers, dropout 0, {attention}",
                 "batch": batch, "seq_len": seq_len}, [card_run, cpu_run], near_zero, state, LR)


def build_resnet(fluid, dtype, with_optimizer, learning_rate=0.1, optimizer=None, amp=None,
                 size=224, momentum=0.9):
    """ResNet-50 in the JAX package's full configuration (NCHW, space-to-depth
    stem, 1000 classes, size x size, Momentum 0.9, or make_optimizer's
    `optimizer`; `amp`, a dict of the decorator's settings: Momentum
    (`momentum`) under contrib.mixed_precision.decorate with them, the
    overflow flag fetchable as fetches["found_inf"]), random weights from
    seed 0, through fuse_bn_relu and fuse_bias_act; returns (main, startup,
    fetches)."""
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.models import resnet

    with fluid.unique_name.guard():
        main, startup, _, fetches = resnet.build(
            dtype=dtype, with_optimizer=with_optimizer and not (optimizer or amp),
            learning_rate=learning_rate, momentum=0.9, image_shape=(3, size, size), **RESNET)
        if optimizer or amp:
            with fluid.program_guard(main, startup):
                opt = (decorate(fluid.optimizer.Momentum(learning_rate, momentum), **amp) if amp
                       else make_optimizer(fluid, optimizer))
                opt.minimize(fetches["loss"])
            if amp:
                fetches["found_inf"] = opt._found_inf
    startup.random_seed = 0
    main.random_seed = 0
    keep = [fetches[k].name for k in ("loss", "logits", "found_inf") if k in fetches]
    for p in ("fuse_bn_relu", "fuse_bias_act"):
        fluid.passes.apply_pass(main, p, keep=keep)
    return main, startup, fetches


def images(batch, seed, size=224):
    """A seeded batch of size x size images in [0, 1) and labels of 1000 classes."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {"img": rng.rand(batch, 3, size, size).astype(np.float32),
            "label": rng.randint(0, 1000, (batch, 1)).astype(np.int64)}


def bn_ops(main):
    return [op for op in main.global_block().ops if op.type == "batch_norm"]


def calibrate(fluid, main, exe, scope, feed):
    """Set every batch_norm's running mean and variance to the statistics of
    `feed` (a training-mode forward of `main`), so the served activations keep
    the scale they have in training."""
    bns = bn_ops(main)
    stats = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                    fetch_list=[op.output(s)[0] for op in bns for s in ("SavedMean", "SavedVariance")])
    for op, m, v in zip(bns, stats[0::2], stats[1::2]):
        scope.set_var(op.input("Mean")[0], m.float().clone())
        scope.set_var(op.input("Variance")[0], v.float().clone())


def save_resnet(fluid, place, dirname, dtype, calib_feed):
    main, startup, fetches = build_resnet(fluid, dtype, with_optimizer=False)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    calibrate(fluid, main, exe, scope, calib_feed)
    fluid.io.save_inference_model(dirname, ["img"], [fetches["logits"]], exe, main, scope)


def resnet_serve(fluid, torch, ck, tmp, card):
    """Phase 8: bf16 ResNet-50 through AnalysisConfig / create_predictor on
    cuda:0, served by serve_requests at each batch of RESNET_BATCHES: the
    first request runs eagerly, the second captures a CUDA graph, the rest
    replay it; [batch, 1000] finite logits."""
    model_dir = os.path.join(tmp, "resnet50_bf16")
    t0 = time.perf_counter()
    save_resnet(fluid, fluid.CUDAPlace(0), model_dir, "bfloat16", images(32, 10))
    predictor = fluid.inference.create_predictor(fluid.inference.AnalysisConfig(model_dir))
    emit({"phase": "resnet_serve", "model": "resnet-50 bf16, space-to-depth stem, fuse_bn_relu",
          "setup_s": time.perf_counter() - t0, "place": repr(predictor.config.place)})
    torch.cuda.reset_peak_memory_stats()
    feeds = [(batch, {"img": images(batch, 20 + i)["img"]})
             for i, batch in enumerate(RESNET_BATCHES)]
    launches = serve_requests(fluid, torch, ck, card, "resnet_serve", predictor, feeds,
                              RESNET_PER_REQUEST, check_logits)
    emit({"phase": "resnet_serve", "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "reserved_gb": torch.cuda.memory_reserved() / 1e9, "card": card})
    return launches


def resnet_parity(fluid, torch, tmp):
    """Phase 9: float32 ResNet-50 logits on the card against the CPU plain
    path, from one saved model whose running statistics are the served
    batch's own (a well-conditioned forward)."""
    import numpy as np

    model_dir = os.path.join(tmp, "resnet50_f32")
    feed = images(4, 40)
    save_resnet(fluid, fluid.CPUPlace(), model_dir, "float32", feed)
    inf = fluid.inference
    img = {"img": feed["img"]}
    gpu = inf.create_predictor(inf.AnalysisConfig(model_dir)).run(img)[0]
    cpu = inf.create_predictor(inf.AnalysisConfig(model_dir, fluid.CPUPlace())).run(img)[0]
    diff = float(np.abs(gpu - cpu).max())
    emit({"phase": "resnet_parity", "model": "resnet-50 f32, batch 4", "max_abs_dlogits": diff,
          "max_abs_logits": float(np.abs(cpu).max()), "tol": 1e-3})
    if not diff <= 1e-3:
        raise AssertionError(f"card vs CPU ResNet-50 logits differ by {diff} > 1e-3")


WARM_STEP_MS = {}  # phase -> its warm step (resnet_train), for later phases to print beside


def resnet_train(fluid, torch, ck, card, phase="resnet_train", optimizer=None, amp=False):
    """Phases 10, 38 and 54: bf16 ResNet-50 (Momentum lr 0.1, 0.9, or LARS on
    its cosine schedule, `optimizer`; batch 256), or float16 under
    contrib.mixed_precision.decorate(Momentum(0.1, 0.9)) (`amp`), trains
    TRAIN_STEPS steps through Executor.run on cuda:0 on one fixed batch,
    from the second step on as a CUDA graph (the velocities and batch
    norm's running statistics are new tensors a step, copied back inside
    the graph; under AMP the plan is captured with no refusal, and a step
    whose gradients overflow, read off the fetched flag, leaves the weights
    as they were)."""
    import numpy as np

    t0 = time.perf_counter()
    main, startup, fetches = build_resnet(fluid, "float16" if amp else "bfloat16",
                                          with_optimizer=True, optimizer=optimizer,
                                          amp=AMP_DEFAULTS if amp else None)
    loss = fetches["loss"].name
    extra = [fetches["found_inf"].name] if amp else []
    derived = launches_of_program(main, loss)
    if derived != RESNET_PER_STEP:
        raise AssertionError(f"the program's kernel ops {derived} != the reckoned {RESNET_PER_STEP}")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    # the batch is made once and put on the card: loading data is set-up
    feed = {k: torch.from_numpy(v).cuda() for k, v in images(RESNET_TRAIN_BATCH, 50).items()}
    stats = [op.input(s)[0] for op in bn_ops(main) for s in ("Mean", "Variance")]
    stats0 = {n: scope.find_var(n).clone() for n in stats}
    model = ("resnet-50 f16, space-to-depth stem, fuse_bn_relu, decorate(Momentum lr 0.1 mu "
             "0.9) at the decorator's defaults" if amp else
             "resnet-50 bf16, space-to-depth stem, fuse_bn_relu, "
             + OPTIMIZER_NAMES.get(optimizer, "Momentum lr 0.1 mu 0.9"))
    emit({"phase": phase, "model": model, "batch": RESNET_TRAIN_BATCH,
          "setup_s": time.perf_counter() - t0})
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()  # the main path's count starts here
    fluid.monitor.reset()
    losses, step_ms, skipped = [], [], []
    for step in range(TRAIN_STEPS):
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss] + extra, scope=scope,
                      return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0].reshape(-1)[0]))
        skipped.append(bool(out[1].reshape(-1)[0]) if amp else False)
        delta = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
        replayed = hold_run_launches(exe, step, delta, RESNET_PER_STEP, phase, phase)
        emit({"phase": phase, "resnet_step": step, "graphed": replayed, "loss": losses[-1],
              "step_ms": step_ms[-1], "launches": delta, "card": card,
              **({"skipped": skipped[-1], "loss_scaling": float(
                  scope.find_var("loss_scaling_0").reshape(-1)[0])} if amp else {})})
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"step {step}: loss {losses[-1]}")
    # the first update must lower the loss of the batch it was taken on, and
    # the last loss must be below the first; in between, momentum 0.9 at lr
    # 0.1 overshoots on one fixed batch from random weights (the H100 at batch
    # 256: 7.65, 6.53, 5.92, 5.78, 5.97, 6.15).  Under AMP a skipped step
    # leaves the weights, so the step after it sees the same loss: the rule
    # holds the losses of the steps each applied update leads to
    seen = [losses[0]] + [losses[i] for i in range(1, len(losses)) if not skipped[i - 1]]
    if not (len(seen) >= 3 and seen[1] < seen[0] and seen[-1] < seen[0]):
        raise AssertionError(f"the loss did not fall: {losses} (skipped {skipped})")
    if amp and exe.last_plan.graph_refusal is not None:
        raise AssertionError(f"{phase}: the plan was refused a graph: "
                             f"{exe.last_plan.graph_refusal}")
    # the graph copies the new running statistics (and velocities) into the
    # tensors the scope holds
    still = [n for n in stats if torch.equal(scope.find_var(n), stats0[n])]
    if still:
        raise AssertionError(f"running statistics that did not move: {still[:4]}")
    launches = dict(ck.LAUNCHES)  # read before the profiled step
    read_monitor(phase, monitor_want(range(TRAIN_STEPS), True), card)
    warm = statistics.median(step_ms[2:])
    WARM_STEP_MS[phase] = warm
    PEAK_BYTES[phase] = torch.cuda.max_memory_allocated()
    emit({"phase": phase, "losses": losses, "warm_step_ms": warm,
          "images_per_s": RESNET_TRAIN_BATCH / warm * 1e3, "first_step_ms": step_ms[0],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card,
          **({"skipped_steps": sum(skipped), "graph_refusal": exe.last_plan.graph_refusal}
             if amp else {})})
    # the steps' own fetches: another fetch list is another plan, run eagerly
    profile_replay(torch, f"{phase} step",
                   lambda: exe.run(main, feed=feed, fetch_list=[loss] + extra, scope=scope,
                                   return_numpy=False), card, RESNET_PER_STEP)
    return launches


def resnet_parity_cpu(fluid, optimizer=None):
    """Phase 11's CPU side: its program, and the CPU's PARITY_STEPS
    Momentum steps (LARS with `optimizer`) from its startup, the state
    before each and after the last kept (numpy): (main, loss, names, stats,
    params, feed, states, cpu losses)."""
    with ARMS_BUILD_LOCK:
        main, startup, fetches = build_resnet(fluid, "float32", with_optimizer=True,
                                              learning_rate=RESNET_PARITY_LR, optimizer=optimizer)
    loss = fetches["loss"].name
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu = fluid.Scope()
    cpu_exe.run(startup, scope=cpu)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    stats = {op.input(s)[0] for op in bn_ops(main) for s in ("Mean", "Variance")}
    params = {p.name for p in main.all_parameters() if p.trainable}
    feed = images(8, 60)
    states, losses = [{n: cpu.to_numpy(n).copy() for n in names}], []
    for _ in range(PARITY_STEPS):
        losses.append(float(cpu_exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=cpu)[0].reshape(-1)[0]))
        states.append({n: cpu.to_numpy(n).copy() for n in names})
    return main, loss, names, stats, params, feed, states, losses


def resnet_train_parity(fluid, torch, optimizer=None, cpu=None):
    """Phase 11: float32 ResNet-50 (batch 8, lr RESNET_PARITY_LR) takes
    PARITY_STEPS Momentum steps (phase 40: LARS, `optimizer`) on the CPU
    (resnet_parity_cpu; `cpu`, where start_cpu_arms ran it); the CPU's state
    before each is loaded on the card, which takes the same step.  Batch
    statistics make a
    ResNet-50's gradients at initialization explode with depth, so two
    implementations that round differently agree on single gradient
    elements only to tens of percent (a 1e-6 perturbation of the images moves
    them 3% in the median, tests/test_torch_resnet.py), and their
    trajectories part within steps; hence one step at a time from one
    state.  Each step must agree in the loss (1e-3 * max(1, |loss|)), in the
    running mean and variance (1e-3 of how far the step moved them, per
    tensor), and per tensor in L2 in each velocity and parameter update
    (0.2 of the CPU's; two CPU implementations measured <= 0.05), with the
    velocities' cosine >= 0.99.  A frozen, doubled or sign-flipped update
    scores >= 1; a velocity that lost its momentum ~0.5 or more."""
    import numpy as np

    main, loss, names, stats, params, feed, states, cpu_losses = (
        cpu or resnet_parity_cpu(fluid, optimizer))
    gpu_exe = fluid.Executor(fluid.CUDAPlace(0))
    worst = {"loss": 0.0, "stat": (0.0, ""), "velocity": (0.0, ""), "update": (0.0, "")}
    cosines, losses = [], []
    for step in range(PARITY_STEPS):
        state, after = states[step], states[step + 1]
        gpu = fluid.Scope()
        fluid.io.load_numpy_params(gpu, state, device="cuda:0")
        gl = float(gpu_exe.run(main, feed=feed, fetch_list=[loss], scope=gpu)[0].reshape(-1)[0])
        cl = cpu_losses[step]
        losses.append((gl, cl))
        worst["loss"] = max(worst["loss"], abs(gl - cl) / max(1.0, abs(cl)))
        dot = ng = nc = 0.0
        for n in names:
            got, want, before = gpu.to_numpy(n), after[n], state[n]
            if n in stats:
                moved = float(np.abs(want - before).max())
                share = float(np.abs(got - want).max()) / max(moved, 1e-30)
                worst["stat"] = max(worst["stat"], (share, n))
            elif n.endswith("_velocity_0"):
                share = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
                worst["velocity"] = max(worst["velocity"], (share, n))
                dot += float(np.sum(got.astype(np.float64) * want))
                ng += float(np.sum(got.astype(np.float64) ** 2))
                nc += float(np.sum(want.astype(np.float64) ** 2))
            elif n in params:
                upd = want - before
                share = float(np.linalg.norm(got - want) / max(np.linalg.norm(upd), 1e-30))
                worst["update"] = max(worst["update"], (share, n))
        cosines.append(dot / np.sqrt(ng * nc))
    emit({"phase": "resnet_train_parity", "model": "resnet-50 f32, batch 8, "
          + OPTIMIZER_NAMES.get(optimizer, f"Momentum lr {RESNET_PARITY_LR}"),
          "losses_card_cpu": losses, "worst_loss_share": worst["loss"],
          "worst_stat_share": worst["stat"], "worst_velocity_l2_share": worst["velocity"],
          "worst_update_l2_share": worst["update"], "velocity_cosines": cosines,
          "bounds": {"loss": 1e-3, "stat": 1e-3, "velocity": 0.2, "update": 0.2, "cosine": 0.99}})
    if not (np.isfinite([c for pair in losses for c in pair]).all() and losses[-1][1] != losses[0][1]):
        raise AssertionError(f"the CPU's losses are not finite or did not move: {losses}")
    for what, limit in (("stat", 1e-3), ("velocity", 0.2), ("update", 0.2)):
        if not worst[what][0] <= limit:
            raise AssertionError(f"card vs CPU {what} {worst[what][1]} off by {worst[what][0]} "
                                 f"> {limit}")
    if not worst["loss"] <= 1e-3:
        raise AssertionError(f"card vs CPU losses differ: {losses}")
    if not min(cosines) >= 0.99:
        raise AssertionError(f"card vs CPU velocity cosines {cosines} < 0.99")


def build_deepfm(fluid, config, make_optimizer):
    """DeepFM minimizing its sigmoid cross-entropy with `make_optimizer()`;
    returns (main, startup, loss name, prediction var)."""
    from paddle_tpu_torch.models import deepfm

    with fluid.unique_name.guard():
        main, startup, _, fetches = deepfm.build(with_optimizer=False, **config)
        with fluid.program_guard(main, startup):
            make_optimizer().minimize(fetches["loss"])
    startup.random_seed = 0
    main.random_seed = 0
    return main, startup, fetches["loss"].name, fetches["prediction"]


def deepfm_feed(batch, config, seed):
    """Field ids uniform over the vocabulary (a batch of 4096 x 26 repeats
    rows: the merge sums them) and 30% positive labels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, config["vocab_size"], (batch, config["num_fields"]))
            .astype("int64"), "label": (rng.rand(batch, 1) < 0.3).astype("float32")}


def moved_rows_only(torch, scope, before, touched):
    """Raise unless each tensor in `before` ({name: copy}) changed in the
    rows `touched` and kept every other row bit for bit."""
    for name, old in before.items():
        new = scope.find_var(name)
        still = torch.ones(old.shape[0], dtype=torch.bool, device=old.device)
        still[touched] = False
        if not torch.equal(new[still], old[still]):
            raise AssertionError(f"{name}: an untouched row changed")
        if torch.equal(new[touched], old[touched]):
            raise AssertionError(f"{name}: the touched rows did not move")


def adam_scope_after(fluid, exe, startup, main, trained):
    """A scope with the Adam program's startup state (moments, beta pows,
    learning rate) and the parameters of the `trained` scope."""
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for p in main.all_parameters():
        scope.set_var(p.name, trained.find_var(p.name))
    return scope


def deepfm_steps(fluid, torch, ck, exe, main, loss, scope, feed, per_step, phase, opt, card):
    """TRAIN_STEPS steps of `main` on `feed`, each launching exactly
    `per_step`: its SelectedRows gradients keep the plan off CUDA graphs
    (eager every step, the refusal printed and counted); returns the losses
    and step times."""
    import numpy as np

    fluid.monitor.reset()
    losses, step_ms = [], []
    for step in range(TRAIN_STEPS):
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        (out,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.reshape(-1)[0]))
        delta = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
        emit({"phase": phase, "optimizer": opt, "step": step, "loss": losses[-1],
              "step_ms": step_ms[-1], "launches": delta, "card": card})
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"{opt} step {step}: loss {losses[-1]}")
        if delta != per_step:
            raise AssertionError(f"{opt} step {step}: kernel launches {delta} != {per_step}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{opt}: the loss did not fall: {losses}")
    read_monitor(f"{phase} {opt}", monitor_want(range(TRAIN_STEPS), False, refused=1), card)
    refusal = exe.last_plan.graph_refusal
    emit({"phase": phase, "optimizer": opt, "graphed": exe.last_plan.graphed,
          "graph_refusal": refusal})
    if not refusal or "SelectedRows" not in refusal:
        raise AssertionError(f"{opt}: a SelectedRows plan was not refused a CUDA graph: {refusal}")
    return losses, step_ms


def deepfm_train(fluid, torch, ck, tmp, card):
    """Phase 15: DeepFM at full width (26 fields, vocab 200,000, embed 16, MLP
    400 x 3, float32) on one fixed batch of DEEPFM_BATCH through
    Executor(CUDAPlace(0)).run: 6 Adagrad(0.05) steps with SelectedRows
    table gradients, in which only the touched rows of the tables and of
    Adagrad's moments change and no kernel launches; then 6 steps of the
    default (densifying) Adam(1e-3) from the trained parameters, each
    launching the Adam kernel once per adam op (10); the loss is finite and
    falls in both.  The model is then saved for inference and served through
    create_predictor at batch 1 and 4096, launching no kernel, and must agree
    with the Executor's test-mode program."""
    import numpy as np

    t0 = time.perf_counter()
    ada_main, ada_startup, ada_loss, _ = build_deepfm(
        fluid, DEEPFM, lambda: fluid.optimizer.Adagrad(0.05))
    adam_main, adam_startup, adam_loss, pred = build_deepfm(
        fluid, DEEPFM, lambda: fluid.optimizer.Adam(1e-3))
    for main, loss, want in ((ada_main, ada_loss, NONE), (adam_main, adam_loss, DEEPFM_PER_STEP)):
        derived = launches_of_program(main, loss)
        if derived != want:
            raise AssertionError(f"the program's kernel ops {derived} != the reckoned {want}")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(ada_startup, scope=scope)
    feed = deepfm_feed(DEEPFM_BATCH, DEEPFM, 0)
    touched = torch.unique(torch.as_tensor(feed["feat_ids"]).reshape(-1)).to(
        scope.find_var("deepfm_w").device)
    rows = ["deepfm_w", "deepfm_v", "deepfm_w_moment_0", "deepfm_v_moment_0"]
    before = {n: scope.find_var(n).clone() for n in rows}
    emit({"phase": "deepfm_train", "model": "deepfm f32, 26 fields, vocab 200000, embed 16, "
          "mlp 400x3", "batch": DEEPFM_BATCH, "rows_touched": int(touched.numel()),
          "setup_s": time.perf_counter() - t0})
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()  # the main path's count starts here
    ada_losses, ada_ms = deepfm_steps(fluid, torch, ck, exe, ada_main, ada_loss, scope, feed,
                                      NONE, "deepfm_train", "adagrad", card)
    moved_rows_only(torch, scope, before, touched)
    adam = adam_scope_after(fluid, exe, adam_startup, adam_main, scope)
    adam_losses, adam_ms = deepfm_steps(fluid, torch, ck, exe, adam_main, adam_loss, adam, feed,
                                        DEEPFM_PER_STEP, "deepfm_train", "adam", card)
    launches = dict(ck.LAUNCHES)  # read before the profiled step
    warm = {opt: statistics.median(ms[1:]) for opt, ms in (("adagrad", ada_ms), ("adam", adam_ms))}
    WARM_STEP_MS.update({f"deepfm_train {opt}": ms for opt, ms in warm.items()})
    PEAK_BYTES["deepfm_train"] = torch.cuda.max_memory_allocated()
    emit({"phase": "deepfm_train", "losses": {"adagrad": ada_losses, "adam": adam_losses},
          "warm_step_ms": warm, "examples_per_s": {k: DEEPFM_BATCH / v * 1e3 for k, v in warm.items()},
          "first_step_ms": {"adagrad": ada_ms[0], "adam": adam_ms[0]},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})
    for opt, main, loss, sc in (("adagrad", ada_main, ada_loss, scope),
                                ("adam", adam_main, adam_loss, adam)):
        profile_run(torch, f"deepfm_train {opt} step",
                    lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=sc,
                                    return_numpy=False), card)
    model_dir = os.path.join(tmp, "deepfm")
    fluid.io.save_inference_model(model_dir, ["feat_ids"], [pred], exe, main_program=adam_main,
                                  scope=adam)
    predictor = fluid.inference.create_predictor(fluid.inference.AnalysisConfig(model_dir))
    test = adam_main.clone(for_test=True)
    for batch in (1, DEEPFM_BATCH):
        ids = deepfm_feed(batch, DEEPFM, 1)["feat_ids"]
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        (out,) = predictor.run({"feat_ids": ids})
        latency = (time.perf_counter() - t0) * 1e3
        delta = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
        (want,) = exe.run(test, feed={"feat_ids": ids}, fetch_list=[pred], scope=adam)
        diff = float(np.abs(out - want).max())
        emit({"phase": "deepfm_serve", "request": batch, "latency_ms": latency,
              "max_abs_dpred": diff, "launches": delta, "card": card})
        if out.shape != (batch, 1) or not (np.isfinite(out).all() and (out >= 0).all()
                                           and (out <= 1).all()):
            raise AssertionError(f"batch {batch}: predictions {out.shape} out of [0, 1]")
        if delta != NONE or not diff <= 1e-6:
            raise AssertionError(f"batch {batch}: launches {delta}, |predictor - executor| {diff}")
    return launches


def deepfm_train_parity(fluid, torch, ck):
    """Phase 16: float32 DeepFM (DEEPFM_PARITY: the MLP cut to 64 x 64) at
    batch 512, from one numpy state: 3 Adagrad(0.05) steps from a moment of
    0.1, then 3 lazy_mode Adam(1e-3, epsilon 1e-6) steps from the trained
    parameters (DEEPFM_PARITY says why), twice on the card and once on the
    CPU (plain path).  The card's two runs agree bit
    for bit (the merge of repeated rows adds in a fixed order); card and CPU
    agree in the losses to 1e-5 relative and in every persistable to 1e-5 of
    its largest magnitude, save the elements whose CPU gradient is 0 to
    rounding (ZERO_GRAD of the model's largest) at some step: a first
    Adagrad or Adam step moves them by +-lr with the sign of that noise, so
    they keep 2*(lr_adagrad + lr_adam)*steps + 1e-5.  The card's Adam steps
    launch the kernel for the fc parameters only."""
    import numpy as np

    ada_main, ada_startup, ada_loss, _ = build_deepfm(
        fluid, DEEPFM_PARITY,
        lambda: fluid.optimizer.Adagrad(PARITY_LR["adagrad"], initial_accumulator_value=0.1))
    adam_main, adam_startup, adam_loss, _ = build_deepfm(
        fluid, DEEPFM_PARITY,
        lambda: fluid.optimizer.Adam(PARITY_LR["adam"], epsilon=1e-6, lazy_mode=True))
    adam_launches = launches_of_program(adam_main, adam_loss)
    cpu = fluid.Executor(fluid.CPUPlace())
    states = []
    for main, startup in ((ada_main, ada_startup), (adam_main, adam_startup)):
        init = fluid.Scope()
        cpu.run(startup, scope=init)
        states.append({v.name: init.to_numpy(v.name) for v in main.list_vars() if v.persistable})
    feed = deepfm_feed(DEEPFM_PARITY_BATCH, DEEPFM_PARITY, 2)
    params = [p.name for p in adam_main.all_parameters()]
    near_zero = {}
    runs = []
    for place in (fluid.CUDAPlace(0), fluid.CUDAPlace(0), fluid.CPUPlace()):
        on_cpu = isinstance(place, fluid.CPUPlace)
        exe = fluid.Executor(place)
        scopes = []
        losses = []
        for (main, loss, startup), state in zip(((ada_main, ada_loss, ada_startup),
                                                 (adam_main, adam_loss, adam_startup)), states):
            scope = fluid.Scope()
            fluid.io.load_numpy_params(scope, state, device=place.device)
            for p in main.all_parameters() if scopes else ():
                scope.set_var(p.name, scopes[0].find_var(p.name))
            want = adam_launches if main is adam_main else NONE
            for _ in range(PARITY_STEPS):
                before = dict(ck.LAUNCHES)
                grads = [f"{p}@GRAD" for p in params] if on_cpu else []
                out = exe.run(main, feed=feed, fetch_list=[loss] + grads, scope=scope)
                losses.append(float(out[0].reshape(-1)[0]))
                delta = {k: v - before[k] for k, v in ck.LAUNCHES.items()}
                if not on_cpu and delta != want:
                    raise AssertionError(f"deepfm parity: launches {delta} != {want}")
                if grads:
                    peak = max(float(np.abs(g).max()) for g in out[1:])
                    for p, g in zip(params, out[1:]):
                        small = np.abs(g) <= ZERO_GRAD * peak
                        near_zero[p] = small | near_zero[p] if p in near_zero else small
            scopes.append(scope)
        runs.append((losses, {n: sc.to_numpy(n) for sc, st in zip(scopes, states) for n in st}))
    (g1, s1), (g2, s2), (cl, cs) = runs
    same = g1 == g2 and all(np.array_equal(s1[n], s2[n]) for n in s1)
    dloss = max(abs(a - b) / abs(b) for a, b in zip(g1, cl))
    flip_tol = 2 * (PARITY_LR["adagrad"] + PARITY_LR["adam"]) * PARITY_STEPS + 1e-5
    worst, worst_name, n_excused = 0.0, "", 0
    for name, want in cs.items():
        err = np.abs(s1[name] - want)
        tol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        if name in near_zero:
            n_excused += int(near_zero[name].sum())
            if not float(err.max()) <= tol + flip_tol:
                raise AssertionError(f"deepfm parity: {name} differs by {float(err.max())}")
            err = err[~near_zero[name]]
        share = float(err.max()) / tol if err.size else 0.0
        if share > worst:
            worst, worst_name = share, name
    emit({"phase": "deepfm_train_parity", "model": "deepfm f32, 26 fields, vocab 200000, embed 16, "
          "mlp 64x64", "batch": DEEPFM_PARITY_BATCH,
          "steps": "3 adagrad(0.05, moment from 0.1) + 3 lazy adam(1e-3, epsilon 1e-6)",
          "losses_card": g1, "losses_cpu": cl, "max_rel_dloss": dloss, "loss_tol": 1e-5,
          "worst_share_of_param_tol": worst, "worst": worst_name, "param_tol": "1e-5 * max|cpu|",
          "elements_with_gradient_0_to_rounding": n_excused, "card_runs_bitwise_equal": same,
          "adam_launches_per_step": adam_launches["adam"]})
    if not same:
        raise AssertionError("deepfm parity: two runs on the card differ")
    if not dloss <= 1e-5:
        raise AssertionError(f"deepfm parity: card vs CPU losses differ by {dloss} (relative)")
    if not worst <= 1.0:
        raise AssertionError(f"deepfm parity: {worst_name} exceeds its tolerance {worst}x")


def nmt_batch(fluid):
    """The JAX package's NMT benchmark batch for one step (tools/bench_kit.py
    :230-240): source lengths, source ids, target lengths, target ids and
    label ids in that order from RandomState(0), lengths uniform in [20, 64),
    ids in [1, 8000).  Returns the LoDTensor feed and the lengths."""
    import numpy as np

    rng = np.random.RandomState(0)
    lens, feed = {}, {}
    for name in ("src_word", "trg_word", "lbl_word"):
        side = "src" if name == "src_word" else "tgt"
        if side not in lens:
            lens[side] = rng.randint(20, NMT_T, size=NMT_BATCH)
        ids = rng.randint(1, 8000, size=(NMT_BATCH, NMT_T, 1))
        feed[name] = fluid.LoDTensor([ids[i, :n] for i, n in enumerate(lens[side])])
    return feed, lens


def build_nmt(fluid, dtype, n_layers=6, dropout=0.1):
    """Transformer-base NMT (NMT) with Adam on the noam schedule, random
    weights from seed 0, through the two fusion passes; returns (main,
    startup, loss name)."""
    from paddle_tpu_torch.models import nmt

    with fluid.unique_name.guard():
        main, startup, _, fetches = nmt.build_transformer_nmt(
            **dict(NMT, n_layers=n_layers, dropout=dropout), dtype=dtype)
    startup.random_seed = 0
    main.random_seed = 0
    loss = fetches["loss"].name
    for p in ("fuse_ln_residual", "fuse_bias_act"):
        fluid.passes.apply_pass(main, p, keep=[loss])
    return main, startup, loss


def nmt_train(fluid, torch, ck, card):
    """Phase 17: Transformer-base NMT at full width (NMT) trains TRAIN_STEPS
    steps through Executor(CUDAPlace(0)).run on the benchmark's ragged batch
    (nmt_batch), float32 and then bfloat16, each in AB_ARMS (train_arm):
    every loss is finite, the first step (the noam schedule's lr 0) leaves
    every parameter bit for bit unchanged, every step launches each kernel as
    the program's ops say (NMT_PER_STEP), the two graphed arms agree bit for
    bit.  Records whether the loss of the last step is below that of the
    second (lr, warmup and dropout are the configuration's, not tuned for 6
    steps).  Returns the launches counted and a float32 graphed scope."""
    feed, lens = nmt_batch(fluid)
    real_tokens = int(lens["tgt"].sum())
    launches = dict(NONE)
    f32_scope = None
    ck.reset_launches()  # the main path's count starts here
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        main, startup, loss = build_nmt(fluid, dtype)
        derived = launches_of_program(main, loss)
        if derived != NMT_PER_STEP:
            raise AssertionError(f"the program's kernel ops {derived} != the reckoned {NMT_PER_STEP}")
        params = [p.name for p in main.all_parameters()]
        emit({"phase": "nmt_train", "model": f"transformer-base nmt {dtype}, 6+6 layers, d 512, "
              "vocab 8000, dropout 0.1, label smoothing 0.1, Adam(noam(512, 400, 2.0))",
              "batch": NMT_BATCH, "bucket": NMT_T, "real_target_tokens": real_tokens,
              "parameters": len(params), "arms": list(AB_ARMS),
              "setup_s": time.perf_counter() - t0})
        held = {}

        def lr0_step(scope, step):
            if step is None:
                held.update((p, scope.find_var(p).clone()) for p in params)
                return
            moved = [p for p in params if not torch.equal(scope.find_var(p), held[p])]
            held.clear()
            if moved:
                raise AssertionError(f"nmt {dtype}: the lr-0 first step moved {moved[:4]}")

        graphed = []
        for arm in AB_ARMS:
            losses, scope, record = train_arm(
                fluid, torch, ck, card, "nmt_train", arm, main, startup, loss, feed,
                NMT_PER_STEP, launches,
                {"sentences": NMT_BATCH, "real_target_tokens": real_tokens,
                 "padded_target_tokens": NMT_BATCH * NMT_T}, check_first_step=lr0_step)
            ARM_RECORDS.setdefault(f"nmt_train {dtype}", []).append(record)
            emit({"phase": "nmt_train", "dtype": dtype, "arm": arm,
                  "loss_step6_below_step2": losses[-1] < losses[1]})
            if arm == "graphed":
                graphed.append((losses, scope))
            del scope
        hold_graphed_repeat(f"nmt_train {dtype}", graphed)
        if dtype == "float32":
            f32_scope = graphed[-1][1]
        del graphed
    return launches, f32_scope


def nmt_parity_arm(fluid):
    """Phase 18's program, numpy state (LN gains 1) and feed, and its CPU
    arm, for start_cpu_arms: ((main, loss, state, feed), (cpu run,
    near_zero))."""
    import numpy as np
    from paddle_tpu_torch.models import nmt

    with ARMS_BUILD_LOCK:
        main, startup, loss = build_nmt(fluid, "float32", n_layers=2, dropout=0.0)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = {v.name: init.to_numpy(v.name) for v in main.list_vars() if v.persistable}
    for name in state:
        if name.endswith(".ln.w"):
            state[name] = np.ones_like(state[name])
    feed = nmt.make_fake_nmt_batch([23, 41, 9, 60], [30, 12, 55, 37], 8000, 8000, seed=1)
    (cpu_run,), near_zero = parity_runs(fluid, main, loss, state, feed,
                                        arms=((fluid.CPUPlace(), True, main),))
    return (main, loss, state, feed), (cpu_run, near_zero)


def nmt_train_parity(fluid, torch, arm=None):
    """Phase 18: float32 NMT at full width, 2 + 2 layers, dropout 0, trains
    PARITY_STEPS Adam steps on the noam schedule on 4 ragged pairs, on the
    card and on the CPU from one numpy state (LN gains 1), held by
    hold_parity; the step counter and every beta pow must be equal.  `arm`
    is nmt_parity_arm's, where start_cpu_arms ran it.  Returns the CPU's
    state after the steps."""
    import numpy as np

    (main, loss, state, feed), (cpu_run, near_zero) = arm or nmt_parity_arm(fluid)
    (card_run,), _ = parity_runs(fluid, main, loss, state, feed, reference=False,
                                 arms=((fluid.CUDAPlace(0), True, main),))
    runs = [card_run, cpu_run]
    # the noam lr of the last step, the largest: the counter reads PARITY_STEPS - 1
    n = PARITY_STEPS - 1
    lr = NMT["learning_rate"] * NMT["d_model"] ** -0.5 * min(n ** -0.5,
                                                             n * NMT["warmup_steps"] ** -1.5)
    hold_parity({"phase": "nmt_train_parity", "model": "transformer nmt f32, 2+2 layers, d 512, "
                 "vocab 8000, dropout 0", "batch": 4, "lr_last_step": lr}, runs, near_zero,
                state, lr)
    (_, gs), (_, cs) = runs
    counters = [n for n in state if n == "@LR_DECAY_COUNTER@" or "_pow_acc_" in n]
    unequal = [n for n in counters if not np.array_equal(gs.to_numpy(n), cs.to_numpy(n))]
    if unequal:
        raise AssertionError(f"card vs CPU: {unequal[:4]} differ")
    return {n: cs.to_numpy(n) for n in state}


def build_nmt_decode(fluid, n_layers, config):
    """build_beam_decode at NMT's widths through the two fusion passes (both
    blocks); returns (main, fetch names: ids, scores, the loop counter, the
    beams [b, k, max_len])."""
    from paddle_tpu_torch.models import nmt

    widths = {k: NMT[k] for k in ("src_vocab", "tgt_vocab", "d_model", "n_heads", "d_ff")}
    with fluid.unique_name.guard():
        main, _, _, fetches = nmt.build_beam_decode(n_layers=n_layers, **widths, **config)
    body = main.blocks[1].ops
    step = next(op.output("Out")[0] for op in body if op.type == "increment")
    beams = next(op.input("Seqs")[0] for op in body if op.type == "beam_search")
    names = [fetches["out_ids"].name, fetches["out_scores"].name, step, beams]
    for p in ("fuse_ln_residual", "fuse_bias_act"):
        fluid.passes.apply_pass(main, p, keep=names)
    return main, names


def launches_of_decode(main, fetch_names, iterations):
    """Kernel launches of one decode read off its ops: the LayerNorms and the
    fused bias+ReLU adds of the encoder (block 0, pruned to the fetches) once,
    those of the While's body once an iteration; no backward kernel."""
    from paddle_tpu_torch.core.executor import _prune, _runnable_ops

    def counts(ops):
        ln = sum(1 for op in ops if op.type == "layer_norm" and op.input("Residual"))
        act = sum(1 for op in ops if op.type == "elementwise_add" and op.attrs.get("fuse_act"))
        return ln, act

    ln0, act0 = counts(_prune(_runnable_ops(main.global_block()), fetch_names, set()))
    ln1, act1 = counts(main.blocks[1].ops)
    return dict(NONE, ln_residual_fwd=ln0 + iterations * ln1,
                bias_act_fwd=act0 + iterations * act1)


def decode_feed(src_rows, src_len):
    import numpy as np

    padded = np.zeros((len(src_rows), src_len), "int64")
    for i, r in enumerate(src_rows):
        padded[i, :len(r)] = r[:, 0]
    return {"src_word": padded,
            "src_len_vec": np.array([len(r) for r in src_rows], "int32")}


def nmt_decode(fluid, torch, ck, card, scope):
    """Phase 19: build_beam_decode at NMT's full width (NMT_DECODE: batch 32,
    src_len 64, beam 4, max_len 64) decodes the benchmark batch's sources with
    phase 17's float32 weights through Executor(CUDAPlace(0)).run: the While
    runs on the host, one condition read an iteration.  One decode warms,
    the next is timed and counted: it launches the LayerNorm forward 12 +
    18 x iterations times and the bias+ReLU forward 6 + 6 x iterations (as
    the program's ops say) and no backward kernel; the ids start with bos
    and are valid tokens, the scores finite.  Returns its launches."""
    import numpy as np

    feed_t, _ = nmt_batch(fluid)
    feed = decode_feed(feed_t["src_word"].sequences, NMT_T)
    main, names = build_nmt_decode(fluid, NMT["n_layers"], NMT_DECODE)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(main, feed=feed, fetch_list=names, scope=scope)  # warm
    ck.reset_launches()  # the main path's count starts here
    t0 = time.perf_counter()
    ids, scores, t_end, _ = exe.run(main, feed=feed, fetch_list=names, scope=scope)
    decode_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ck.LAUNCHES)
    iterations = int(t_end[0]) - 1
    derived = launches_of_decode(main, names, iterations)
    want = dict(NONE, ln_residual_fwd=12 + 18 * iterations, bias_act_fwd=6 + 6 * iterations)
    # the best hypothesis of each sentence, bos left out, up to its first eos
    eos = NMT_DECODE["eos"]
    ended = (ids[:, 1:] == eos).cumsum(1)
    out_tokens = int(((ended == 0) | ((ended == 1) & (ids[:, 1:] == eos))).sum())
    emit({"phase": "nmt_decode", "model": "transformer-base nmt f32, 6+6 layers, beam 4, "
          "max_len 64, phase 17's weights", "batch": NMT_BATCH, "src_len": NMT_T,
          "decode_ms": decode_ms, "while_iterations": iterations,
          "ms_per_iteration": decode_ms / iterations, "output_tokens": out_tokens,
          "output_tokens_per_s": out_tokens / decode_ms * 1e3,
          "beam_tokens_per_s": NMT_BATCH * NMT_DECODE["beam_size"] * iterations / decode_ms * 1e3,
          "launches": launches, "graphed": exe.last_plan.graphed,
          "graph_refusal": exe.last_plan.graph_refusal, "card": card})
    if "while op" not in (exe.last_plan.graph_refusal or ""):
        raise AssertionError(f"decode: a while plan was not refused a CUDA graph")
    if not derived == want == launches:
        raise AssertionError(f"decode launches {launches}, program {derived}, reckoned {want}")
    if ids.shape != (NMT_BATCH, NMT_DECODE["max_len"]) or not (ids[:, 0] == 1).all() or not (
            (ids >= 0) & (ids < NMT["tgt_vocab"])).all() or not np.isfinite(scores).all():
        raise AssertionError(f"decode: ids {ids.shape} / scores out of range")
    profile_run(torch, "nmt_decode request",
                lambda: exe.run(main, feed=feed, fetch_list=names, scope=scope), card)
    return launches


def nmt_decode_parity(fluid, torch, state):
    """Phase 20: build_beam_decode with the 2-layer float32 weights of phase
    18 (NMT_PARITY_DECODE: batch 4, src_len 16, beam 4, max_len 16), on the
    card and on the CPU: the ids equal and the scores within 1e-4; the
    smallest top-k margin of the CPU's search (the k-th candidate's score
    less the first rejected one's) is printed, so that a flip is explained.
    The second case lifts proj.b[eos] (NMT_EOS_LIFT): beams finish at
    different steps and the While leaves early.  On the card the compiled
    decode also equals the port's host-loop beam_search_decode."""
    import numpy as np
    from paddle_tpu_torch.models import nmt
    from paddle_tpu_torch.ops import misc_ops

    cfg = NMT_PARITY_DECODE
    rng = np.random.RandomState(5)
    rows = [rng.randint(3, 8000, (n, 1)) for n in rng.randint(4, cfg["src_len"] + 1,
                                                              cfg["batch_size"])]
    feed = decode_feed(rows, cfg["src_len"])
    main, names = build_nmt_decode(fluid, 2, cfg)
    widths = {k: NMT[k] for k in ("src_vocab", "tgt_vocab", "d_model", "n_heads", "d_ff")}
    with fluid.unique_name.guard():
        infer, _, _, ifetch = nmt.build_nmt_infer(n_layers=2, **widths)
    top_k = misc_ops.top_k_lower_index_first
    for lift in (0.0, NMT_EOS_LIFT):
        params = {n: a.copy() for n, a in state.items()}
        params["proj.b"][cfg["eos"]] += lift
        out, margins = [], []

        def top_k_with_margin(x, k):
            vals, idx = top_k(x, k + 1)
            margins.append(float((vals[:, k - 1] - vals[:, k]).min()))
            return vals[:, :k], idx[:, :k]

        for place, on_cpu in ((fluid.CUDAPlace(0), False), (fluid.CPUPlace(), True)):
            scope = fluid.Scope()
            fluid.io.load_numpy_params(scope, params, device=place.device)
            misc_ops.top_k_lower_index_first = top_k_with_margin if on_cpu else top_k
            try:
                exe = fluid.Executor(place)
                out.append(exe.run(main, feed=feed, fetch_list=names, scope=scope))
            finally:
                misc_ops.top_k_lower_index_first = top_k
            if not on_cpu:
                host_ids, _ = nmt.beam_search_decode(
                    exe, infer, ifetch["logits"], scope, rows, bos=cfg["bos"], eos=cfg["eos"],
                    beam_size=cfg["beam_size"], max_len=cfg["max_len"])
        (g_ids, g_scores, g_t, _), (c_ids, c_scores, c_t, c_beams) = out
        dscore = float(np.abs(g_scores - c_scores).max())
        # the step at which each beam emitted its first eos (max_len: never)
        is_eos = c_beams[:, :, 1:] == cfg["eos"]
        finish = np.where(is_eos.any(-1), is_eos.argmax(-1) + 1, cfg["max_len"])
        emit({"phase": "nmt_decode_parity", "eos_lift": lift, "iterations_card": int(g_t[0]) - 1,
              "iterations_cpu": int(c_t[0]) - 1, "ids_equal": bool(np.array_equal(g_ids, c_ids)),
              "host_loop_ids_equal": bool(np.array_equal(g_ids, host_ids)),
              "max_abs_dscore": dscore, "score_tol": 1e-4, "min_top_k_margin": min(margins),
              "finish_steps": sorted(set(finish.reshape(-1).tolist())), "ids_cpu": c_ids.tolist()})
        if not (np.array_equal(g_ids, c_ids) and dscore <= 1e-4 and int(g_t[0]) == int(c_t[0])):
            raise AssertionError(f"decode parity (eos lift {lift}): card vs CPU ids or scores "
                                 f"differ (|dscore| {dscore})")
        if not np.array_equal(g_ids, host_ids):
            raise AssertionError(f"decode parity (eos lift {lift}): compiled vs host-loop ids differ")
        if lift and not (int(c_t[0]) < cfg["max_len"] and len(set(finish.reshape(-1))) > 1):
            raise AssertionError("decode parity: with the lifted eos the beams did not finish at "
                                 f"different steps before max_len: {finish.tolist()}")


def bitwise_equal(runs, state):
    """Whether two runs' losses and every persistable agree bit for bit."""
    import numpy as np

    (l1, s1), (l2, s2) = runs
    return l1 == l2 and all(np.array_equal(s1.to_numpy(n), s2.to_numpy(n)) for n in state)


def graph_parity(fluid, torch):
    """Phase 21: graphed against eager steps on the card from one numpy
    state, held by hold_parity (phase 7's tolerances; the eager arm's
    gradients say which elements are 0 to rounding): float32 BERT-base with
    2 layers, fused attention, dropout 0, batch 8 x 128, and float32 NMT
    with 2 + 2 layers, dropout 0, on phase 18's 4 ragged pairs, PARITY_STEPS
    Adam steps each.  Says whether the two agree bit for bit."""
    import numpy as np
    from paddle_tpu_torch.models import nmt
    from paddle_tpu_torch.models.transformer import make_fake_batch

    cases = []
    main, startup, loss = build_train(fluid, "float32", 2, 0.0, 128, True)
    cases.append(("bert-base f32, 2 layers, fused attention, dropout 0", main, startup, loss,
                  make_fake_batch(8, 128, 30522, rng=np.random.RandomState(1)), LR,
                  ("emb_ln.w", ".ln1.w", ".ln2.w")))
    main, startup, loss = build_nmt(fluid, "float32", n_layers=2, dropout=0.0)
    n = PARITY_STEPS - 1
    nmt_lr = NMT["learning_rate"] * NMT["d_model"] ** -0.5 * min(n ** -0.5,
                                                                 n * NMT["warmup_steps"] ** -1.5)
    cases.append(("transformer nmt f32, 2+2 layers, dropout 0", main, startup, loss,
                  nmt.make_fake_nmt_batch([23, 41, 9, 60], [30, 12, 55, 37], 8000, 8000, seed=1),
                  nmt_lr, (".ln.w",)))
    for model, main, startup, loss, feed, lr, unit_gains in cases:
        init = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
        state = {v.name: init.to_numpy(v.name) for v in main.list_vars() if v.persistable}
        for name in state:
            if name.endswith(unit_gains):  # LN gains near 1: O(1) activations
                state[name] = np.ones_like(state[name])
        card = fluid.CUDAPlace(0)
        runs, near_zero = parity_runs(fluid, main, loss, state, feed,
                                      arms=((card, True, main), (card, False, main)))
        hold_parity({"phase": "graph_parity", "model": model, "arms": "graphed vs eager",
                     "bitwise_equal": bitwise_equal(runs, state)}, runs, near_zero, state, lr)


def conv_order(fluid, torch, card):
    """Phase 21, conv nets: the tiny MNIST (two conv-pools, batch 8) with
    Momentum 0.05, 0.9 takes 4 steps from one numpy state in four arms
    (eager, eager, graphed, graphed), under cuDNN's default algorithms and
    then under its deterministic ones.  Emits the largest difference of any
    persistable (relative to its largest magnitude, at least 1, as the gpu
    test measures it) between the two eager arms, between the two graphed
    arms, and between graphed and eager: whether cuDNN's summation order or
    the capture moves a conv step.  Holds graphed = eager within phase 7's
    1e-5 under the deterministic algorithms only; the default's readings
    are recorded."""
    import numpy as np
    from paddle_tpu_torch.models import mnist

    with fluid.unique_name.guard():
        main, startup, _, fetches = mnist.build(with_optimizer=False)
        with fluid.program_guard(main, startup):
            fluid.optimizer.Momentum(0.05, 0.9).minimize(fetches["loss"])
    main.random_seed = startup.random_seed = 0
    loss = fetches["loss"].name
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = {v.name: init.to_numpy(v.name) for v in main.list_vars() if v.persistable}
    rng = np.random.RandomState(2)
    feeds = [{"img": rng.rand(8, 1, 28, 28).astype("f4"),
              "label": rng.randint(0, 10, (8, 1)).astype("int64")} for _ in range(4)]

    def spread(a, b):
        return max((float(np.abs(a[n] - b[n]).max()) / max(float(np.abs(b[n]).max()), 1.0), n)
                   for n in state)

    readings, saved = {}, torch.backends.cudnn.deterministic
    try:
        for mode in ("default", "deterministic"):
            torch.backends.cudnn.deterministic = mode == "deterministic"
            arms = []
            for graphs in (False, False, True, True):
                scope = fluid.Scope()
                fluid.io.load_numpy_params(scope, state, device="cuda:0")
                exe = fluid.Executor(fluid.CUDAPlace(0), _graphs=graphs)
                for f in feeds:
                    exe.run(main, feed=f, fetch_list=[loss], scope=scope)
                if exe.last_plan.graphed != graphs:
                    raise AssertionError(f"conv_order {mode}: graphed {exe.last_plan.graphed}")
                arms.append({n: scope.to_numpy(n).astype(np.float64) for n in state})
            readings[mode] = {"eager_vs_eager": spread(arms[1], arms[0]),
                              "graphed_vs_graphed": spread(arms[3], arms[2]),
                              "graphed_vs_eager": max(spread(arms[2], arms[0]),
                                                      spread(arms[3], arms[1]))}
    finally:
        torch.backends.cudnn.deterministic = saved
    emit({"phase": "conv_order", "model": "tiny mnist f32, Momentum 0.05 0.9, batch 8",
          "steps": len(feeds), "tol": 1e-5, "card": card,
          **{mode: {pair: {"max_rel_diff": d, "persistable": n} for pair, (d, n) in r.items()}
             for mode, r in readings.items()}})
    worst, name = readings["deterministic"]["graphed_vs_eager"]
    if not worst <= 1e-5:
        raise AssertionError(f"conv_order: graphed vs eager {name} differs by {worst} under "
                             "cuDNN's deterministic algorithms")


def executor_depth(fluid, torch, card):
    """Phase 22: on bf16 BERT-base at 32 x 128 (fused attention, dropout 0.1,
    Adam lr 1e-4), six different batches from one seed: six graphed runs;
    steps=4 over the first four stacked (one upload, one warm-up step, the
    graph replayed three times, one sync) equals the first four runs bit for
    bit in the losses and every persistable; pipeline.train_loop with
    max_inflight 2 over the six equals the six runs' losses bit for bit."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    main, startup, loss = build_train(fluid, "bfloat16", 12, 0.1, 128, True)
    rng = np.random.RandomState(7)
    feeds = [dict(make_fake_batch(32, 128, 30522, rng=rng)) for _ in range(TRAIN_STEPS)]

    def fresh():
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        return exe, scope

    exe, scope = fresh()
    serial, after4 = [], None
    for i, f in enumerate(feeds):
        serial.append(float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0].reshape(-1)[0]))
        if i == 3:
            after4 = {n: scope.find_var(n).clone() for n in scope.local_var_names()
                      if isinstance(scope.find_var(n), torch.Tensor)}
    del exe, scope
    exe, scope = fresh()
    stacked = {k: np.stack([f[k] for f in feeds[:4]]) for k in feeds[0]}
    t0 = time.perf_counter()
    (k_losses,) = exe.run(main, feed=stacked, fetch_list=[loss], scope=scope, steps=4)
    steps4_ms = (time.perf_counter() - t0) * 1e3
    k_losses = [float(v) for v in k_losses.reshape(4)]
    differ = [n for n, t in after4.items() if not torch.equal(scope.find_var(n), t)]
    emit({"phase": "steps", "steps": 4, "losses": k_losses, "serial_losses": serial[:4],
          "graphed": exe.last_plan.graphed, "ms": steps4_ms,
          "persistables_that_differ": differ[:8], "card": card})
    if k_losses != serial[:4] or differ or not exe.last_plan.graphed:
        raise AssertionError(f"steps=4 {k_losses} vs 4 runs {serial[:4]}; differ {differ[:8]}")
    del exe, scope, after4
    exe, scope = fresh()
    stats = fluid.train_loop(exe, main, iter(feeds), [loss], scope=scope, max_inflight=2,
                             log_period=1)
    piped = [float(v[0].reshape(-1)[0]) for _, v in stats.logged]
    emit({"phase": "train_loop", "max_inflight": 2, "steps": stats.steps, "losses": piped,
          "serial_losses": serial, "max_inflight_seen": stats.max_inflight_seen,
          "wall_s": stats.wall_s, "host_blocked_frac": stats.host_blocked_frac,
          "graphed": exe.last_plan.graphed, "card": card})
    if piped != serial or stats.max_inflight_seen != 2 or not all(map(math.isfinite, serial)):
        raise AssertionError(f"train_loop losses {piped} != serial {serial}")


def remat_parity(fluid, torch, card):
    """Phase 23: BuildStrategy.memory_optimize (remat: each backward region's
    forward under torch.utils.checkpoint, its dropout masks repeated from a
    generator synced to the step's start) against no remat, both graphed on
    the card, PARITY_STEPS Adam steps of float32 BERT-base with 2 layers,
    fused attention, dropout 0.1, batch 8 x 128, from one numpy state: held
    by hold_parity, with each arm's peak memory."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    main, startup, loss = build_train(fluid, "float32", 2, 0.1, 128, True)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = {v.name: init.to_numpy(v.name) for v in main.list_vars() if v.persistable}
    feed = make_fake_batch(8, 128, 30522, rng=np.random.RandomState(1))
    strategy = fluid.BuildStrategy()
    strategy.memory_optimize = True
    remat = fluid.CompiledProgram(main, strategy)
    peaks = {}
    runs, near_zero = [], None
    for arm, program in (("remat", remat), ("no remat", main)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got, nz = parity_runs(fluid, main, loss, state, feed,
                              arms=((fluid.CUDAPlace(0), True, program),))
        peaks[arm] = torch.cuda.max_memory_allocated() / 1e9
        runs += got
        near_zero = nz
    hold_parity({"phase": "remat_parity", "model": "bert-base f32, 2 layers, fused attention, "
                 "dropout 0.1", "batch": 8, "peak_mem_gb": peaks,
                 "bitwise_equal": bitwise_equal(runs, state), "card": card},
                runs, near_zero, state, LR)


def clipped_parity_arm(fluid):
    """Phase 25's BERT program, numpy state (LN gains 1), feed and the
    global norm's var, and its CPU arm (with the norm each step), for
    start_cpu_arms: ((main, loss, state, feed, norm), (cpu run, near_zero,
    norms))."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    with ARMS_BUILD_LOCK:
        main, startup, loss = build_train(fluid, "float32", 2, 0.0, 128, True, clip_decay=True)
    norm = global_norm_name(main)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = {v.name: init.to_numpy(v.name) for v in main.list_vars() if v.persistable}
    for name in state:
        if name.endswith(("emb_ln.w", ".ln1.w", ".ln2.w")):  # LN gains near 1: O(1) activations
            state[name] = np.ones_like(state[name])
    feed = make_fake_batch(2, 128, 30522, rng=np.random.RandomState(1))
    seen = {}
    (cpu_run,), near_zero = parity_runs(fluid, main, loss, state, feed, also=[norm], seen=seen,
                                        arms=((fluid.CPUPlace(), True, main),))
    return (main, loss, state, feed, norm), (cpu_run, near_zero, [v[0] for v in seen[0]])


def train_clipped_parity(fluid, torch, card, arm=None):
    """Phase 25: float32 BERT-base (2 layers, fused attention, dropout 0) with
    L2Decay and the global-norm clip, PARITY_STEPS Adam steps on the card and
    on the CPU from one numpy state, held by hold_parity (phase 7's
    tolerances); the gradients' global norm is fetched every step and must
    exceed CLIP_NORM at some step, so that the clip scales.  Then the
    fit-a-line program: FIT_A_LINE_STEPS SGD steps on the card and on the
    CPU from one state, the loss falls and the two agree within
    FIT_A_LINE_TOL of max(1, |loss|) at every step.  `arm` is
    clipped_parity_arm's, where start_cpu_arms ran it."""
    import numpy as np

    (main, loss, state, feed, norm), (cpu_run, near_zero, cpu_norms) = (
        arm or clipped_parity_arm(fluid))
    seen = {}
    (card_run,), _ = parity_runs(fluid, main, loss, state, feed, reference=False, also=[norm],
                                 seen=seen, arms=((fluid.CUDAPlace(0), True, main),))
    runs = [card_run, cpu_run]
    norms = {"card": [v[0] for v in seen[0]], "cpu": cpu_norms}
    hold_parity({"phase": "train_clipped_parity", "model": "bert-base f32, 2 layers, fused "
                 f"attention, dropout 0, L2Decay({WEIGHT_DECAY}), "
                 f"GradientClipByGlobalNorm({CLIP_NORM})", "batch": 2, "seq_len": 128,
                 "global_norm": norms, "clip_norm": CLIP_NORM,
                 "clip_decay_ops": clip_decay_ops(main), "card": card},
                runs, near_zero, state, LR)
    if not max(norms["cpu"]) > CLIP_NORM:
        raise AssertionError(f"the global norm {norms} never exceeds {CLIP_NORM}: the clip "
                             "was not exercised")
    del runs
    with fluid.unique_name.guard():
        line_main, line_startup = fluid.Program(), fluid.Program()
        line_startup.random_seed = 0
        with fluid.program_guard(line_main, line_startup):
            x = fluid.layers.data("x", [13])
            y = fluid.layers.data("y", [1])
            line_loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(x, 1), y))
            fluid.optimizer.SGD(0.05).minimize(line_loss)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(line_startup, scope=init)
    state = {v.name: init.to_numpy(v.name) for v in line_main.list_vars() if v.persistable}
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(FIT_A_LINE_STEPS):
        xv = rng.rand(32, 13).astype("f4")
        feeds.append({"x": xv, "y": xv.sum(1, keepdims=True)})
    losses = {}
    for arm, place in (("card", fluid.CUDAPlace(0)), ("cpu", fluid.CPUPlace())):
        scope = fluid.Scope()
        fluid.io.load_numpy_params(scope, state, device=place.device)
        exe = fluid.Executor(place)
        losses[arm] = [float(exe.run(line_main, feed=f, fetch_list=[line_loss],
                                     scope=scope)[0].reshape(-1)[0]) for f in feeds]
    worst = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(losses["card"], losses["cpu"]))
    emit({"phase": "fit_a_line", "steps": FIT_A_LINE_STEPS, "first_losses": losses["card"][:3],
          "last_losses": losses["card"][-3:], "max_rel_dloss_card_vs_cpu": worst,
          "tol": FIT_A_LINE_TOL, "card": card})
    if not (worst <= FIT_A_LINE_TOL and all(map(math.isfinite, losses["card"]))
            and np.mean(losses["card"][-5:]) < 0.1 * np.mean(losses["card"][:5])):
        raise AssertionError(f"fit-a-line: card vs CPU {worst} (tol {FIT_A_LINE_TOL}), losses "
                             f"{losses['card'][:3]} ... {losses['card'][-3:]}")


def checkpoint_resume(fluid, torch, tmp, card):
    """Phase 26: the card path of phase 24 (bf16 BERT-base 32 x 128, fused
    attention, L2Decay and the global-norm clip) with dropout 0, on
    TRAIN_STEPS different batches from one seed: the first half of them,
    save_persistables, a fresh Scope, load_persistables (onto the card),
    then the second half, against all of them straight through in one
    scope.  The losses and every persistable must be bitwise equal; the
    save's and the load's seconds and bytes are printed."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    main, startup, loss = build_train(fluid, "bfloat16", 12, 0.0, 128, True, clip_decay=True)
    rng = np.random.RandomState(11)
    feeds = [dict(make_fake_batch(32, 128, 30522, rng=rng)) for _ in range(TRAIN_STEPS)]
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    half = TRAIN_STEPS // 2

    def steps(exe, scope, batch):
        return [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0].reshape(-1)[0])
                for f in batch]

    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    straight = steps(exe, scope, feeds)
    want = {n: scope.find_var(n).clone() for n in names}
    del exe, scope
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    resumed = steps(exe, scope, feeds[:half])
    ckpt = os.path.join(tmp, "bert_clipped_ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    saved = fluid.io.save_persistables(exe, ckpt, main, scope)
    save_s = time.perf_counter() - t0
    del scope
    scope = fluid.Scope()
    t0 = time.perf_counter()
    loaded = fluid.io.load_persistables(exe, ckpt, main, scope)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    devices = sorted({str(scope.find_var(n).device) for n in loaded})
    resumed += steps(exe, scope, feeds[half:])
    diffs = {}
    for n in names:
        got = scope.find_var(n)
        if not torch.equal(got, want[n]):
            diffs[n] = float((got.float() - want[n].float()).abs().max())
    largest = max(diffs.items(), key=lambda kv: kv[1]) if diffs else None
    emit({"phase": "checkpoint_resume", "model": "bert-base bf16, fused attention, dropout 0, "
          f"L2Decay({WEIGHT_DECAY}), GradientClipByGlobalNorm({CLIP_NORM})", "batch": 32,
          "seq_len": 128, "steps": [half, TRAIN_STEPS - half], "save_s": save_s, "load_s": load_s,
          "files": len(saved), "bytes": sum(e["bytes"] for e in saved),
          "loaded_to": devices, "losses_straight": straight, "losses_resumed": resumed,
          "bitwise_equal": straight == resumed and not diffs, "persistables": len(names),
          "persistables_that_differ": len(diffs), "largest_difference": largest, "card": card})
    if straight != resumed or diffs or devices != ["cuda:0"]:
        raise AssertionError(f"checkpoint_resume: losses {straight} vs {resumed}, {len(diffs)} "
                             f"persistables differ (largest {largest}), loaded to {devices}")


def write_images(fluid, tmp):
    """Phase 27's data: LOADER_BATCHES x RESNET_TRAIN_BATCH samples, each a
    uint8 224 x 224 x 3 image and an int64 label, written with
    recordio.write_arrays from seeded numpy; returns (path, seconds, bytes)."""
    import numpy as np

    rng = np.random.RandomState(27)
    path = os.path.join(tmp, "images.rio")

    def samples():
        for _ in range(LOADER_BATCHES):
            imgs = rng.randint(0, 256, (RESNET_TRAIN_BATCH, 224, 224, 3), dtype=np.uint8)
            labels = rng.randint(0, 1000, (RESNET_TRAIN_BATCH, 1)).astype(np.int64)
            for img, label in zip(imgs, labels):
                yield img, label

    t0 = time.perf_counter()
    fluid.recordio.write_arrays(path, samples(), max_chunk_records=LOADER_CHUNK)
    return path, time.perf_counter() - t0, os.path.getsize(path)


def normalize_images(batch):
    """A batch of (uint8 HWC image, label) samples as ResNet-50's feeds:
    float32 NCHW in [0, 1] and int64 labels [B, 1]."""
    import numpy as np

    img = np.stack([s[0] for s in batch]).transpose(0, 3, 1, 2).astype(np.float32)
    img *= np.float32(1.0 / 255.0)
    return {"img": np.ascontiguousarray(img), "label": np.stack([s[1] for s in batch])}


def image_reader(fluid, path, epochs=1):
    """reader.shuffle(seed=0) -> batch -> map_readers(normalize_images) over
    the images file, `epochs` passes (reader.chain of the one shuffled
    reader: each pass permutes anew); checkpointable throughout."""
    r = fluid.reader
    shuffled = r.shuffle(fluid.recordio.reader_creator(path), LOADER_SHUFFLE, seed=0)
    if epochs > 1:
        shuffled = r.chain(*([shuffled] * epochs))
    return r.map_readers(normalize_images, r.batch(shuffled, RESNET_TRAIN_BATCH, drop_last=True))


def image_loader(fluid, main, path, epochs=1):
    """DataLoader(capacity=4) on the card over image_reader."""
    block = main.global_block()
    loader = fluid.DataLoader.from_generator([block.var("img"), block.var("label")], capacity=4,
                                             device=fluid.CUDAPlace(0))
    return loader.set_batch_generator(image_reader(fluid, path, epochs))


def counted_dispatch(exe, ck, per_step, what, path):
    """Hold each dispatch of `exe` (Executor.run or run_async) by
    hold_run_launches: its eager step and its capture launch `per_step`, a
    replay none and adds `per_step` to REPLAYED[path].  Returns (the list
    of run indices seen, a function that removes the hold)."""
    seen = []
    run_impl = exe._run_impl

    def counted(*a, **kw):
        before = dict(ck.LAUNCHES)
        out = run_impl(*a, **kw)
        delta = {k: ck.LAUNCHES[k] - before[k] for k in before}
        index = exe.last_plan.runs - 1
        hold_run_launches(exe, index, delta, per_step, what, path)
        seen.append(index)
        return out

    exe._run_impl = counted
    return seen, lambda: exe.__dict__.pop("_run_impl", None)


def upload_ms(torch, arr):
    """Host-to-card copy of one numpy array: (pinned ms, pageable ms, host
    ms of the copy into pinned memory), each the median of 5 CUDA-event
    pairs (the host copy by the host's clock)."""
    src = torch.from_numpy(arr)
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    dev = torch.empty(src.shape, dtype=src.dtype, device="cuda")
    out = {"pinned": [], "pageable": [], "host": []}
    for _ in range(5):
        t0 = time.perf_counter()
        pinned.copy_(src)
        out["host"].append((time.perf_counter() - t0) * 1e3)
        for kind, host in (("pinned", pinned), ("pageable", src)):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            dev.copy_(host, non_blocking=kind == "pinned")
            end.record()
            torch.cuda.synchronize()
            out[kind].append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in out.items()}


def span_total(mon, name):
    stats = mon.span_stats().get(name)
    return (stats["calls"], stats["total_s"]) if stats else (0, 0.0)


def loader_resnet(fluid, torch, ck, tmp, card):
    """Phase 27: phase 10's bf16 ResNet-50 (batch 256, Momentum 0.1 / 0.9)
    fed from a RecordIO file of uint8 images: reader.shuffle(seed=0) ->
    batch -> map_readers (float32 NCHW) -> DataLoader(capacity=4), which
    stages each batch in pinned memory and uploads it on its own stream ->
    pipeline.train_loop(max_inflight=2).  Two arms in turns on one host
    (numpy, loader, numpy, loader): the numpy arm feeds the same batches as
    numpy arrays through Executor.run (the executor uploads them from
    pageable memory).  Each arm: the warm step and images/s, the
    executor.dispatch span, reader.wait (total and share of the wall),
    reader.bytes_staged, a profiled step's idle share; every step's
    launches held (BN epilogue 53 + 53, xent 1 + 1, graphed from the second
    step); all arms' losses bitwise equal (cuDNN's deterministic
    algorithms).  Also the upload of one 154 MB float32 batch, pinned
    against pageable.  Returns the wrappers' launches over the loader
    arms."""

    main, startup, fetches = build_resnet(fluid, "bfloat16", with_optimizer=True)
    loss = fetches["loss"].name
    if launches_of_program(main, loss) != RESNET_PER_STEP:
        raise AssertionError("the program's kernel ops differ from RESNET_PER_STEP")
    path, write_s, nbytes = write_images(fluid, tmp)
    t0 = time.perf_counter()
    batches = list(image_reader(fluid, path)())
    read_s = time.perf_counter() - t0
    up = upload_ms(torch, batches[0]["img"])
    emit({"phase": "loader_resnet", "model": "resnet-50 bf16, Momentum lr 0.1 mu 0.9",
          "batch": RESNET_TRAIN_BATCH, "batches": len(batches), "file_bytes": nbytes,
          "write_s": write_s, "read_and_normalize_s": read_s,
          "batch_mb": batches[0]["img"].nbytes / 1e6, "upload_pinned_ms": up["pinned"],
          "upload_pageable_ms": up["pageable"], "host_copy_to_pinned_ms": up["host"],
          "card": card})
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs, launches = [], dict(NONE)
    try:
        for arm in ("numpy", "loader", "numpy", "loader"):
            gc.collect()
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            exe.run(startup, scope=scope)
            fluid.monitor.reset()
            ck.reset_launches()  # each arm's count starts here; the path's is the loader's
            seen, unhold = counted_dispatch(exe, ck, RESNET_PER_STEP, f"loader_resnet {arm}",
                                            "loader_resnet" if arm == "loader" else None)
            t0 = time.perf_counter()
            if arm == "numpy":
                losses, step_ms = [], []
                for b in batches:
                    t1 = time.perf_counter()
                    (out,) = exe.run(main, feed=b, fetch_list=[loss], scope=scope)
                    losses.append(float(out.reshape(-1)[0]))
                    step_ms.append((time.perf_counter() - t1) * 1e3)
                last = batches[-1]
            else:
                box = {}

                def kept(loader):
                    for b in loader:
                        box["last"] = b
                        yield b

                stats = fluid.train_loop(exe, main, kept(image_loader(fluid, main, path)), [loss],
                                         scope=scope, max_inflight=2, log_period=1)
                losses = [float(v[0].reshape(-1)[0]) for _, v in stats.logged]
                step_ms = [r["t_step_wall_s"] * 1e3 for r in fluid.monitor.step_records()
                           if r.get("kind") == "pipeline_step"]
                last = box["last"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            unhold()
            if arm == "loader":
                add_launches(launches, ck.LAUNCHES)
            mon = fluid.monitor.get_monitor()
            waits, wait_s = span_total(mon, "reader.wait")
            staged = mon.counter("reader.bytes_staged").value
            read = read_monitor(f"loader_resnet {arm}", monitor_want(range(len(batches)), True),
                                card)
            if seen != list(range(len(batches))):
                raise AssertionError(f"loader_resnet {arm}: dispatches {seen}")
            warm = statistics.median(step_ms[2:])
            prof = profile_replay(torch, f"loader_resnet {arm} step",
                                  lambda: exe.run(main, feed=last, fetch_list=[loss], scope=scope,
                                                  return_numpy=False), card, RESNET_PER_STEP)
            rec = {"phase": "loader_resnet", "arm": arm, "losses": losses, "wall_s": wall,
                   "warm_step_ms": warm, "images_per_s": RESNET_TRAIN_BATCH / warm * 1e3,
                   "warm_dispatch_ms": statistics.median(read["dispatch_ms_by_run"][2:]),
                   "dispatch_ms_by_run": read["dispatch_ms_by_run"],
                   "reader_wait_s": wait_s, "reader_waits": waits,
                   "reader_wait_share": wait_s / wall, "reader_bytes_staged": staged,
                   "profiled_step_ms": prof["run_ms"],
                   "device_idle_share": prof["device_idle_share"], "card": card}
            emit(rec)
            runs.append(rec)
            if not all(map(math.isfinite, losses)):
                raise AssertionError(f"loader_resnet {arm}: losses {losses}")
            del exe, scope, last
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = saved
    equal = all(r["losses"] == runs[0]["losses"] for r in runs)
    emit({"phase": "loader_resnet", "bitwise_equal": equal, "arms": [r["arm"] for r in runs]})
    if not equal:
        raise AssertionError(f"loader_resnet: losses differ between arms "
                             f"{[r['losses'] for r in runs]}")
    loader_bytes = [r["reader_bytes_staged"] for r in runs if r["arm"] == "loader"]
    want = sum(b["img"].nbytes + b["label"].nbytes // 2 for b in batches)  # int64 -> int32
    if loader_bytes != [want, want]:
        raise AssertionError(f"reader.bytes_staged {loader_bytes} != {want}")
    return launches


def deepfm_files(fluid, tmp, feeds):
    """The feeds as slot records (26 int64 ids, one float32 label) over two
    RecordIO files, half the batches each."""
    files = []
    half = len(feeds) // 2
    for k in range(2):
        path = os.path.join(tmp, f"deepfm{k}.rio")
        part = feeds[k * half:(k + 1) * half]
        fluid.recordio.write_arrays(path, ((f["feat_ids"][j], f["label"][j]) for f in part
                                           for j in range(DEEPFM_BATCH)), max_chunk_records=1024)
        files.append(path)
    return files


def deepfm_dataset(fluid, files):
    ds = fluid.QueueDataset()
    ds.set_batch_size(DEEPFM_BATCH)
    ds.set_thread(1)  # one worker drains the files in order: checkpointable
    ds.set_filelist(files)
    ds.set_use_var(["feat_ids", "label"])
    return ds


def dataset_deepfm(fluid, torch, ck, tmp, card):
    """Phase 28: DeepFM at phase 15's full width, 4 Adagrad(0.05) steps on 4
    batches of 4096 slot records over two RecordIO files, through
    QueueDataset (one thread) and Executor.train_from_dataset, against the
    same batches fed to Executor.run from the same startup, in turns
    (direct, dataset, direct, dataset: the first arm of a process pays its
    one-time costs): the losses and every persistable (the tables' touched
    rows among them, the others unmoved) bitwise equal in all arms; no
    kernel launches (SelectedRows steps, refused a graph); a second pass
    from the dataset's state after batch 2 yields batches 3 and 4 again.
    The examples/s of each arm.  Returns the wrappers' launches over the
    dataset arms."""
    import numpy as np

    main, startup, loss, _ = build_deepfm(fluid, DEEPFM, lambda: fluid.optimizer.Adagrad(0.05))
    feeds = [deepfm_feed(DEEPFM_BATCH, DEEPFM, 280 + i) for i in range(4)]
    t0 = time.perf_counter()
    files = deepfm_files(fluid, tmp, feeds)
    write_s = time.perf_counter() - t0
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    examples = len(feeds) * DEEPFM_BATCH
    runs, launches, tables = [], dict(NONE), None
    for arm in ("direct", "dataset", "direct", "dataset"):
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        if tables is None:
            tables = {n: scope.find_var(n).clone() for n in ("deepfm_w", "deepfm_v")}
        fluid.monitor.reset()
        ck.reset_launches()  # each arm's path count starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if arm == "direct":
            losses = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0].reshape(-1)[0])
                      for f in feeds]
        else:
            logs = exe.train_from_dataset(main, deepfm_dataset(fluid, files), scope=scope,
                                          fetch_list=[loss], print_period=1)
            losses = [float(d[loss][0]) for _, d in logs]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        delta = dict(ck.LAUNCHES)
        if arm == "dataset":
            add_launches(launches, delta)
        read_monitor(f"dataset_deepfm {arm}", monitor_want(range(len(feeds)), False, refused=1),
                     card)
        runs.append({"arm": arm, "losses": losses, "seconds": seconds,
                     "examples_per_s": examples / seconds, "launches": delta,
                     "state": {n: scope.find_var(n).clone() for n in names}})
        emit({"phase": "dataset_deepfm", "arm": arm, "losses": losses, "seconds": seconds,
              "examples_per_s": examples / seconds, "card": card})
        last = scope
        del exe
    differ = sorted({n for r in runs[1:] for n in names
                     if not torch.equal(r["state"][n], runs[0]["state"][n])})
    same_losses = all(r["losses"] == runs[0]["losses"] for r in runs)
    touched = torch.unique(torch.as_tensor(np.concatenate([f["feat_ids"] for f in feeds]))
                           .reshape(-1)).to(tables["deepfm_w"].device)
    moved_rows_only(torch, last, tables, touched)
    ds = deepfm_dataset(fluid, files)
    it = ds.batches()
    next(it)
    next(it)
    state = ds.state_dict()
    again = deepfm_dataset(fluid, files)
    again.load_state_dict(state)
    rest = list(again.batches())
    resumed = len(rest) == 2 and all(
        np.array_equal(b["feat_ids"], f["feat_ids"]) and np.array_equal(b["label"], f["label"])
        for b, f in zip(rest, feeds[2:]))
    emit({"phase": "dataset_deepfm", "model": "deepfm f32, 26 fields, vocab 200000, embed 16, "
          "mlp 400x3, Adagrad 0.05", "batch": DEEPFM_BATCH, "files": len(files),
          "write_s": write_s, "arms": [r["arm"] for r in runs],
          "examples_per_s": [r["examples_per_s"] for r in runs],
          "bitwise_equal": same_losses and not differ, "persistables": len(names),
          "persistables_that_differ": differ[:8], "rows_touched": int(touched.numel()),
          "state_after_2": state, "resumed_batches_equal": resumed, "launches": launches,
          "card": card})
    if not same_losses or differ or not resumed or any(r["launches"] != NONE for r in runs):
        raise AssertionError(f"dataset_deepfm: losses {[r['losses'] for r in runs]}, "
                             f"{len(differ)} persistables differ, resumed {resumed}, launches "
                             f"{[r['launches'] for r in runs]}")
    return launches


def skipping(it, dropped):
    """The batches of `it` save the raw indices in `dropped`."""
    for i, b in enumerate(it):
        if i not in dropped:
            yield b


def ckpt_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def resilient_resnet(fluid, torch, ck, tmp, card, path):
    """Phase 29: phase 27's model and source (RESILIENT_EPOCHS passes of
    the shuffled images through the DataLoader) under
    resilient_train_loop with a CheckpointManager(save_every_steps=4),
    nan_mode skip_step and max_inflight 2, through RESILIENT_SPEC: a bad
    batch, a NaN planted in a feed on the card, a device error, an
    out-of-memory (halving max_inflight) and a preemption at step 13; then
    a resume from the manager in a fresh Scope and Executor to step 16.
    Held under cuDNN's deterministic algorithms: ResilienceStats counts one
    of each, max_inflight was halved, every dispatch's launches, and the
    final persistables bitwise equal to a clean run over the surviving
    batches.  The wall time of both runs, the checkpoints' save and restore
    seconds and bytes.  Returns the wrappers' launches."""
    main, startup, fetches = build_resnet(fluid, "bfloat16", with_optimizer=True)
    loss = fetches["loss"].name
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    policy = fluid.RetryPolicy(backoff_base_s=0.0)
    root = os.path.join(tmp, "resnet_ckpt")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gc.collect()
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        clean = fluid.resilient_train_loop(
            exe, main, lambda: skipping(image_loader(fluid, main, path, RESILIENT_EPOCHS),
                                        RESILIENT_DROPPED),
            [loss], scope=scope, max_inflight=2, policy=policy, max_steps=RESILIENT_STEPS)
        want = {n: scope.find_var(n).clone() for n in names}
        clean_losses = {s: float(v[0].reshape(-1)[0]) for s, v in clean.logged}
        del exe, scope
        gc.collect()
        ck.reset_launches()  # the main path's count starts here
        fluid.monitor.reset()
        segments = []
        for resume in (False, True):
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            exe.run(startup, scope=scope)
            cm = fluid.CheckpointManager(root, program=main, scope=scope, save_every_steps=4)
            counted_dispatch(exe, ck, RESNET_PER_STEP, f"resilient_resnet resume={resume}",
                             "resilient_resnet")
            stats = fluid.resilient_train_loop(
                exe, main, lambda: image_loader(fluid, main, path, RESILIENT_EPOCHS), [loss],
                scope=scope, injector=None if resume else fluid.FaultInjector(RESILIENT_SPEC),
                nan_mode="skip_step", checkpoint_manager=cm, resume=resume, max_inflight=2,
                policy=policy, max_steps=RESILIENT_STEPS)
            segments.append(stats)
        launches = dict(ck.LAUNCHES)
        mon = fluid.monitor.get_monitor()
        saves, save_s = span_total(mon, "checkpoint.save")
        restores, restore_s = span_total(mon, "checkpoint.restore")
        snaps, snap_s = span_total(mon, "resilience.snapshot")
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = saved
    chaos, resumed = segments
    differ = [n for n in names if not torch.equal(scope.find_var(n), want[n])]
    losses = {s: float(v[0].reshape(-1)[0]) for st in segments for s, v in st.logged}
    ledger = {k: getattr(chaos, k) for k in ("steps", "preempted", "resume_step",
                                             "skipped_batches", "skipped_steps", "retries",
                                             "degraded_inflight", "final_max_inflight")}
    counters = {k: v for k, v in mon.counter_values().items()
                if k.startswith(("resilience.", "faults.", "checkpoint."))}
    emit({"phase": "resilient_resnet", "spec": RESILIENT_SPEC, "ledger": ledger,
          "resumed_steps": resumed.steps, "counters": counters,
          "clean_wall_s": clean.wall_s, "chaos_wall_s": chaos.wall_s,
          "resume_wall_s": resumed.wall_s, "checkpoint_saves": saves,
          "checkpoint_save_s": save_s, "checkpoint_restores": restores,
          "checkpoint_restore_s": restore_s, "checkpoint_bytes_on_disk": ckpt_bytes(root),
          "checkpoint_bytes_each": ckpt_bytes(root) // max(1, len(os.listdir(root))),
          "checkpoints": sorted(os.listdir(root)), "snapshots": snaps, "snapshot_s": snap_s,
          "losses": [losses[s] for s in sorted(losses)],
          "clean_losses": [clean_losses[s] for s in sorted(clean_losses)],
          "bitwise_equal": not differ, "persistables": len(names),
          "persistables_that_differ": differ[:8], "card": card})
    mon.reset()
    if ledger != {"steps": 13, "preempted": True, "resume_step": 13, "skipped_batches": 1,
                  "skipped_steps": 1, "retries": 2, "degraded_inflight": 1,
                  "final_max_inflight": 1} or resumed.steps != RESILIENT_STEPS or differ:
        raise AssertionError(f"resilient_resnet: ledger {ledger}, resumed to {resumed.steps}, "
                             f"{len(differ)} persistables differ from the clean run")
    return launches


def bert_token_reader(fluid, path, keys):
    """Token-id batches from a RecordIO file (one batch a record) through a
    shuffled, checkpointable reader."""
    r = fluid.reader
    return r.map_readers(lambda rec: dict(zip(keys, rec)),
                         r.shuffle(fluid.recordio.reader_creator(path), 4, seed=1))


def resilient_bert(fluid, torch, ck, tmp, card):
    """Phase 30: phase 12's bf16 BERT-base (32 x 128, fused attention,
    dropout 0.1), its token-id batches read from a RecordIO file through a
    shuffled, checkpointable reader: resilient_train_loop with preempt@5
    (the flush carries the generator's state and the reader's), then a
    resume in a fresh Scope and Executor to step 10, both fed through a
    DataLoader(capacity=4) on the card, against 10 straight steps fed the
    reader's numpy batches: the losses and every persistable, the
    generator's state included, bitwise equal, so the loader handed each
    of the three int32 [32, 128] feeds its own ids; each dispatch's
    launches held (FUSED_PER_STEP for the eager step and the capture of
    each executor).  Returns the wrappers' launches."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    main, startup, loss = build_train(fluid, "bfloat16", 12, 0.1, 128, True)
    rng = np.random.RandomState(30)
    batches = [dict(make_fake_batch(32, 128, 30522, rng=rng)) for _ in range(BERT_RESUME_STEPS + 2)]
    keys = sorted(batches[0])
    path = os.path.join(tmp, "bert_tokens.rio")
    fluid.recordio.write_arrays(path, [tuple(b[k] for k in keys) for b in batches])
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    policy = fluid.RetryPolicy(backoff_base_s=0.0)
    root = os.path.join(tmp, "bert_ckpt")

    def factory():
        return bert_token_reader(fluid, path, keys)

    def loader():
        block = main.global_block()
        return fluid.DataLoader.from_generator(
            [block.var(k) for k in keys], capacity=4,
            device=fluid.CUDAPlace(0)).set_batch_generator(factory())

    gc.collect()
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    straight = fluid.resilient_train_loop(exe, main, factory, [loss], scope=scope, max_inflight=2,
                                          policy=policy, max_steps=BERT_RESUME_STEPS)
    want = {n: scope.find_var(n).clone() for n in names}
    want_rng = scope.find_var("__rng_state__").get_state()
    want_losses = [float(v[0].reshape(-1)[0]) for _, v in straight.logged]
    del exe, scope
    gc.collect()
    ck.reset_launches()  # the main path's count starts here
    fluid.monitor.reset()
    blackbox = os.path.join(tmp, "BLACKBOX.p0.json")
    fluid.monitor.arm_flight_recorder(blackbox, 0)  # the preemption's drain dumps it
    segments = []
    for resume in (False, True):
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        cm = fluid.CheckpointManager(root, program=main, scope=scope)
        counted_dispatch(exe, ck, FUSED_PER_STEP, f"resilient_bert resume={resume}",
                         "resilient_bert")
        segments.append(fluid.resilient_train_loop(
            exe, main, loader, [loss], scope=scope,
            injector=None if resume else fluid.FaultInjector(BERT_RESUME_SPEC),
            checkpoint_manager=cm, resume=resume, max_inflight=2, policy=policy,
            max_steps=BERT_RESUME_STEPS))
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    mon = fluid.monitor.get_monitor()
    mon._bb_path = None  # disarmed: the recorder has no other API for it, as in the JAX package
    box = {}
    if os.path.exists(blackbox):
        with open(blackbox) as f:
            box = json.load(f)
    emit({"phase": "resilient_bert", "blackbox": os.path.basename(blackbox),
          "reason": box.get("reason"), "steps_in_ring": len(box.get("steps", ())),
          "events_in_ring": len(box.get("events", ())),
          "resilience_events": [r.get("action") for r in box.get("steps", ())
                                if r.get("kind") == "resilience_event"]})
    if box.get("reason") != "sigterm_drain":
        raise AssertionError(f"resilient_bert: the preemption wrote no black box with the "
                             f"drain's reason (found {box.get('reason')!r})")
    saves, save_s = span_total(mon, "checkpoint.save")
    restores, restore_s = span_total(mon, "checkpoint.restore")
    staged = mon.counter("reader.bytes_staged").value
    batch_bytes = sum(batches[0][k].size * 4 for k in keys)  # int64 -> int32
    chaos, resumed = segments
    losses = [float(v[0].reshape(-1)[0]) for st in segments for _, v in st.logged]
    differ = [n for n in names if not torch.equal(scope.find_var(n), want[n])]
    rng_equal = torch.equal(scope.find_var("__rng_state__").get_state(), want_rng)
    emit({"phase": "resilient_bert", "model": "bert-base bf16, fused attention, dropout 0.1",
          "batch": 32, "seq_len": 128, "spec": BERT_RESUME_SPEC, "preempted": chaos.preempted,
          "resume_step": chaos.resume_step, "resumed_steps": resumed.steps,
          "stream_seeks": mon.counter("resilience.stream_seek").value,
          "losses_straight": want_losses, "losses_resumed": losses,
          "bitwise_equal": losses == want_losses and not differ and rng_equal,
          "generator_state_equal": rng_equal, "persistables": len(names),
          "persistables_that_differ": differ[:8], "straight_wall_s": straight.wall_s,
          "chaos_wall_s": chaos.wall_s, "resume_wall_s": resumed.wall_s,
          "checkpoint_saves": saves, "checkpoint_save_s": save_s,
          "checkpoint_restores": restores, "checkpoint_restore_s": restore_s,
          "checkpoint_bytes_on_disk": ckpt_bytes(root), "reader_bytes_staged": staged,
          "card": card})
    mon.reset()
    if not (chaos.preempted and chaos.resume_step == 5 and resumed.steps == BERT_RESUME_STEPS
            and losses == want_losses and not differ and rng_equal
            and staged >= BERT_RESUME_STEPS * batch_bytes and staged % batch_bytes == 0):
        raise AssertionError(f"resilient_bert: preempted {chaos.preempted} at "
                             f"{chaos.resume_step}, resumed to {resumed.steps}, losses "
                             f"{losses} vs {want_losses}, {len(differ)} persistables differ, "
                             f"generator equal {rng_equal}, {staged} bytes staged")
    return launches


# --- the fluid_benchmark model family (phases 31-36) --------------------------


def build_vision(fluid, model, with_optimizer=True, **overrides):
    """The `model` of paddle_tpu_torch/models/vision.py in its configuration
    (VISION, updated by `overrides`), random weights from seed 0, float32 as
    built (no fusion pass); returns (main, startup, fetches) with the
    logits (the loss's input) among the fetches."""
    from paddle_tpu_torch.models import vision

    fn, config = VISION[model]
    with fluid.unique_name.guard():
        main, startup, _, fetches = getattr(vision, fn)(with_optimizer=with_optimizer,
                                                        **dict(config, **overrides))
    startup.random_seed = main.random_seed = 0
    xent = [op for op in main.global_block().ops if op.type == "softmax_with_cross_entropy"]
    if not xent:  # word2vec's NCE and hierarchical-sigmoid heads have no logits
        return main, startup, dict(fetches)
    return main, startup, dict(fetches, logits=main.global_block().var(xent[0].input("Logits")[0]))


def on_card(torch, feed):
    """The feed's arrays as tensors on the card: loading data is set-up."""
    return {k: torch.from_numpy(v).cuda() for k, v in feed.items()}


def vision_feed(model, batch, seed, size=224, vocab=None, max_len=LSTM_BUCKET, min_len=None):
    """A seeded batch for `model`: images in [0, 1) of `size` and 1000-class
    labels (10 below 224); the LSTM's ragged word ids (lengths uniform in
    [min_len, max_len], padded to max_len, with their `words@LOD`) and
    binary labels; word2vec's context and target ids."""
    import numpy as np

    rng = np.random.RandomState(seed)
    if model in ("se_resnext", "vgg"):
        return {"img": rng.rand(batch, 3, size, size).astype(np.float32),
                "label": rng.randint(0, 1000 if size == 224 else 10, (batch, 1)).astype(np.int64)}
    vocab = vocab or (VISION[model][1].get("vocab_size") or 1000)
    if model == "stacked_lstm":
        lens = rng.randint(min_len or LSTM_MIN_LEN, max_len + 1, batch).astype(np.int32)
        words = np.zeros((batch, max_len, 1), np.int64)
        for i, n in enumerate(lens):
            words[i, :n, 0] = rng.randint(0, vocab, n)
        return {"words": words, "words@LOD": lens,
                "label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}
    feed = {f"w{i}": rng.randint(0, vocab, (batch, 1)).astype(np.int64) for i in range(3)}
    feed["target"] = rng.randint(0, vocab, (batch, 1)).astype(np.int64)
    return feed


def vision_train(fluid, torch, ck, card, model, phase, feed, units):
    """Phases 31-34: `model` trains TRAIN_STEPS steps on one fixed `feed`
    through Executor(CUDAPlace(0)).run, eager then graphed (train_arm: each
    step's launches held, the monitor read, a profiled step); in each arm
    the first step lowers the loss, the lowest loss is below the first and
    the batch norms' running statistics move.  A step's launches are read
    off the program and must equal VISION_PER_STEP.  Returns the launches counted and what phase 36
    profiles."""
    t0 = time.perf_counter()
    main, startup, fetches = build_vision(fluid, model)
    loss = fetches["loss"].name
    per_step = launches_of_program(main, loss)
    if per_step != VISION_PER_STEP[model]:
        raise AssertionError(f"{phase}: the program's kernel ops {per_step} != the reckoned "
                             f"{VISION_PER_STEP[model]}")
    emit({"phase": phase, "model": model, "config": {k: str(v) for k, v in VISION[model][1].items()},
          "units_per_step": units, "ops": len(main.global_block().ops),
          "params": len(main.all_parameters()), "setup_s": time.perf_counter() - t0})
    stats = [op.input(s)[0] for op in bn_ops(main) for s in ("Mean", "Variance")]
    init = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=init)
    launches = dict(NONE)
    ck.reset_launches()  # the main path's count starts here
    for arm in ("eager", "graphed"):
        losses, scope, _ = train_arm(fluid, torch, ck, card, phase, arm, main, startup, loss, feed,
                                     per_step, launches, units)
        # the first update lowers the loss of the batch it was taken on, and
        # the steps reach below the start; the last need not (the H100: the
        # LSTM learns its one fixed batch to 0.003 by step 5, and Adam's
        # next step, of lr per weight whatever the gradient, overshoots to 2.3)
        if not (losses[1] < losses[0] and min(losses) < losses[0]):
            raise AssertionError(f"{phase} {arm}: the loss did not fall: {losses}")
        # as phase 10: the running statistics move, a graph's replays included
        still = [n for n in stats if torch.equal(scope.find_var(n), init.find_var(n))]
        if still:
            raise AssertionError(f"{phase} {arm}: running statistics that did not move: "
                                 f"{still[:4]}")
        del scope
    return launches, (main, startup, loss, feed, per_step)


def serve_requests(fluid, torch, ck, card, phase, predictor, feeds, per_request, check):
    """REQUESTS requests of each (batch, feed) of `feeds` through `predictor`
    (the first eager, the second captures a CUDA graph, the rest replay it):
    each request's launches held to `per_request` (hold_run_launches), its
    run_ms, fetch_ms and samples/s printed beside what `check(batch,
    output)` returns (it raises on a wrong output); the monitor read; one
    more request profiled.  The main path's count starts here; returns the
    launches counted."""
    from paddle_tpu_torch.core.dtypes import to_numpy

    ck.reset_launches()
    fluid.monitor.reset()
    for batch, feed in feeds:
        for r in range(REQUESTS):
            before = dict(ck.LAUNCHES)
            t0 = time.perf_counter()
            (out,) = predictor.run(feed, return_numpy=False)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = to_numpy(out)
            t2 = time.perf_counter()
            delta = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
            replayed = hold_run_launches(predictor.exe, r, delta, per_request,
                                         f"{phase} batch {batch}", phase)
            emit({"request": phase, "batch": batch, "graphed": replayed,
                  "latency_ms": (t2 - t0) * 1e3, "run_ms": (t1 - t0) * 1e3,
                  "fetch_ms": (t2 - t1) * 1e3, "samples_per_s": batch / (t2 - t0),
                  **check(batch, got), "launches": delta, "card": card})
    launches = dict(ck.LAUNCHES)  # read before the profiled request
    read_monitor(phase, monitor_want(list(range(REQUESTS)) * len(feeds), True), card)
    batch, feed = feeds[-1]
    profile_replay(torch, f"{phase} request {batch}",
                   lambda: predictor.run(feed, return_numpy=False), card, per_request)
    return launches


def served_model(fluid, torch, ck, tmp, card, phase, program, inputs, make_batch, calib_batch,
                 batches, per_request, check):
    """A float32 model served as phases 31-32, 44 and 46 serve it:
    `program()` gives (main, startup, output var) without an optimizer;
    the batch norms' running statistics set to make_batch(calib_batch, 70)'s
    (as phase 8); saved by save_inference_model with the feeds `inputs`;
    served through AnalysisConfig / create_predictor on cuda:0 by
    serve_requests at each of `batches` (make_batch(batch, 80 + i)).
    Returns the launches counted."""
    t0 = time.perf_counter()
    main, startup, fetch = program()
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    calibrate(fluid, main, exe, scope, make_batch(calib_batch, 70))
    model_dir = os.path.join(tmp, phase)
    fluid.io.save_inference_model(model_dir, inputs, [fetch], exe, main, scope)
    del exe, scope
    predictor = fluid.inference.create_predictor(fluid.inference.AnalysisConfig(model_dir))
    emit({"phase": phase, "setup_s": time.perf_counter() - t0,
          "place": repr(predictor.config.place)})
    feeds = []
    for i, batch in enumerate(batches):
        full = make_batch(batch, 80 + i)
        feeds.append((batch, {k: full[k] for k in inputs}))
    return serve_requests(fluid, torch, ck, card, phase, predictor, feeds, per_request, check)


def check_logits(batch, logits):
    """serve_requests' check of [batch, 1000] finite logits."""
    import numpy as np

    if logits.shape != (batch, 1000) or not np.isfinite(logits).all():
        raise AssertionError(f"batch {batch}: logits {logits.shape}, finite="
                             f"{bool(np.isfinite(logits).all())}")
    return {"max_abs_logit": float(np.abs(logits).max())}


def vision_serve(fluid, torch, ck, tmp, card, model, phase):
    """Phases 31-32: `model` f32 served by served_model at each of
    VISION_SERVE_BATCHES: every request launches the BN epilogue forward
    once per batch norm over NCHW and no other kernel; [batch, 1000] finite
    logits."""
    def program():
        main, startup, fetches = build_vision(fluid, model, with_optimizer=False)
        return main, startup, fetches["logits"]

    return served_model(fluid, torch, ck, tmp, card, phase, program, ["img"],
                        images, 16, VISION_SERVE_BATCHES,
                        VISION_PER_REQUEST[model], check_logits)


def learning_rate(scope, names):
    """The optimizer's learning rate, as its startup wrote it."""
    return float(next(scope.to_numpy(n) for n in names
                      if n.startswith("learning_rate")).reshape(-1)[0])


def conv_step_shares(cpu_after, card_after, before, stats, params, removed, zero_grad, lr):
    """One step of a conv net on the card against the CPU from one state
    (phase 11's rule, as tests/test_torch_vision.py holds it): the running
    statistics' error as a share of their move; each accumulator's and
    each parameter update's L2 error as a share of the CPU's; elements whose
    gradient is 0 in exact arithmetic (`zero_grad`: the biases a batch norm
    removes, and gradients within ZERO_GRAD of the step's largest) move by
    Adam's +-lr on rounding alone and are held to 2 * lr + 1e-5, a removed
    bias's accumulators to 1e-4 of the largest of their kind.  Returns
    (worst shares by kind, the accumulators' cosine)."""
    import numpy as np

    worst = {"stat": (0.0, ""), "accumulator": (0.0, ""), "update": (0.0, ""),
             "zero_grad_abs": (0.0, "")}
    dot = ng = nc = 0.0
    acc = ("_velocity_0", "_moment1_0", "_moment2_0")
    for n, want in cpu_after.items():
        got, prev = card_after[n], before[n]
        if n in stats:
            moved = float(np.abs(want - prev).max())
            worst["stat"] = max(worst["stat"], (float(np.abs(got - want).max()) / max(moved, 1e-30), n))
        elif n.endswith(acc):
            owner, kind = n[:n.rindex("_", 0, -2)], n[n.rindex("_", 0, -2):]
            if owner in removed:
                peak = max(float(np.abs(v).max()) for m, v in cpu_after.items() if m.endswith(kind))
                share = float(np.abs(got - want).max()) / max(peak, 1e-30)
                worst["zero_grad_abs"] = max(worst["zero_grad_abs"], (share, n))
                continue
            share = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
            worst["accumulator"] = max(worst["accumulator"], (share, n))
            if kind != "_moment2_0":
                dot += float(np.sum(got.astype(np.float64) * want))
                ng += float(np.sum(got.astype(np.float64) ** 2))
                nc += float(np.sum(want.astype(np.float64) ** 2))
        elif n in params:
            keep = ~zero_grad[n]
            flip = float(np.abs(got - want)[~keep].max(initial=0.0))
            if not flip <= 2 * lr + 1e-5:
                raise AssertionError(f"card vs CPU {n}: a 0-gradient element moved {flip} > "
                                     f"2 * lr + 1e-5")
            upd = (want - prev)[keep]
            share = float(np.linalg.norm((got - want)[keep]) / max(np.linalg.norm(upd), 1e-30))
            worst["update"] = max(worst["update"], (share, n))
    return worst, dot / np.sqrt(ng * nc)


def vision_conv_parity(fluid, torch, model):
    """Phase 35, a conv net: its test-mode forward at VISION_PARITY_SIZE,
    batch 2, card against CPU from one startup state (logits within 1e-3 *
    max(1, max|logits|)); then PARITY_STEPS training steps at batch 4,
    dropout 0, each taken on the CPU and on the card from the CPU's state
    before it, held by phase 11's rule (conv_step_shares: loss 1e-3 *
    max(1, |loss|), statistics 1e-3, accumulators and updates 0.2 in L2,
    cosine 0.99)."""
    import numpy as np

    size = VISION_PARITY_SIZE
    kw = dict(class_dim=10, image_shape=(3, size, size))
    cpu_exe, gpu_exe = fluid.Executor(fluid.CPUPlace()), fluid.Executor(fluid.CUDAPlace(0))
    main, startup, fetches = build_vision(fluid, model, with_optimizer=False, **kw)
    test = main.clone(for_test=True)
    cpu = fluid.Scope()
    cpu_exe.run(startup, scope=cpu)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    gpu = fluid.Scope()
    fluid.io.load_numpy_params(gpu, {n: cpu.to_numpy(n) for n in names}, device="cuda:0")
    img = {"img": vision_feed(model, 2, 90, size)["img"]}
    logits = fetches["logits"].name
    want = cpu_exe.run(test, feed=img, fetch_list=[logits], scope=cpu)[0]
    got = gpu_exe.run(test, feed=img, fetch_list=[logits], scope=gpu)[0]
    dlogits, tol = float(np.abs(got - want).max()), 1e-3 * max(1.0, float(np.abs(want).max()))
    emit({"phase": "vision_parity", "model": model, "forward": f"test mode, {size} x {size}, "
          "batch 2", "max_abs_dlogits": dlogits, "max_abs_logits": float(np.abs(want).max()),
          "tol": tol})
    if not dlogits <= tol:
        raise AssertionError(f"{model}: card vs CPU test-mode logits differ by {dlogits} > {tol}")

    main, startup, fetches = build_vision(fluid, model, **kw)
    for op in main.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
    loss = fetches["loss"].name
    ops = main.global_block().ops
    bn_in = {op.input("X")[0] for op in ops if op.type == "batch_norm"}
    removed = {op.input("Y")[0] for op in ops
               if op.type == "elementwise_add" and op.output("Out")[0] in bn_in}
    stats = {op.input(s)[0] for op in ops if op.type == "batch_norm" for s in ("Mean", "Variance")}
    params = [p.name for p in main.all_parameters() if p.trainable]
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    cpu = fluid.Scope()
    cpu_exe.run(startup, scope=cpu)
    lr = learning_rate(cpu, names)
    feed = vision_feed(model, 4, 91, size)
    worst = {"loss": 0.0}
    cosines, losses = [], []
    for step in range(PARITY_STEPS):
        before = {n: cpu.to_numpy(n).copy() for n in names}
        gpu = fluid.Scope()
        fluid.io.load_numpy_params(gpu, before, device="cuda:0")
        gl = float(gpu_exe.run(main, feed=feed, fetch_list=[loss], scope=gpu)[0].reshape(-1)[0])
        out = cpu_exe.run(main, feed=feed, fetch_list=[loss] + [f"{p}@GRAD" for p in params],
                          scope=cpu)
        cl = float(out[0].reshape(-1)[0])
        peak = max(float(np.abs(g).max()) for g in out[1:])
        zero_grad = {p: (np.abs(g) <= ZERO_GRAD * peak) | (p in removed)
                     for p, g in zip(params, out[1:])}
        del out
        losses.append((gl, cl))
        worst["loss"] = max(worst["loss"], abs(gl - cl) / max(1.0, abs(cl)))
        shares, cosine = conv_step_shares({n: cpu.to_numpy(n) for n in names},
                                          {n: gpu.to_numpy(n) for n in names}, before, stats,
                                          set(params), removed, zero_grad, lr)
        for k, v in shares.items():
            worst[k] = max(worst.get(k, (0.0, "")), v)
        cosines.append(cosine)
    emit({"phase": "vision_parity", "model": model, "train": f"{size} x {size}, batch 4, "
          "dropout 0, one step at a time from the CPU's state", "losses_card_cpu": losses,
          **{f"worst_{k}": v for k, v in worst.items()}, "cosines": cosines,
          "removed_biases": len(removed),
          "bounds": {"loss": 1e-3, "stat": 1e-3, "accumulator": 0.2, "update": 0.2,
                     "zero_grad_abs": 1e-4, "cosine": 0.99}})
    if not (np.isfinite([c for pair in losses for c in pair]).all() and losses[-1][1] != losses[0][1]):
        raise AssertionError(f"{model}: the CPU's losses are not finite or did not move: {losses}")
    for what, limit in (("stat", 1e-3), ("accumulator", 0.2), ("update", 0.2),
                        ("zero_grad_abs", 1e-4)):
        if not worst[what][0] <= limit:
            raise AssertionError(f"{model}: card vs CPU {what} {worst[what][1]} off by "
                                 f"{worst[what][0]} > {limit}")
    if not (worst["loss"] <= 1e-3 and min(cosines) >= 0.99):
        raise AssertionError(f"{model}: card vs CPU losses {losses}, cosines {cosines}")


def vision_free_parity(fluid, torch, model, overrides, feed, forward_feed):
    """Phase 35, the LSTM or word2vec: the test-mode forward card against
    CPU (logits within 1e-4 * max(1, max|logits|)), then PARITY_STEPS Adam
    steps from one numpy state by phase 7's rule (hold_parity)."""
    import numpy as np

    main, startup, fetches = build_vision(fluid, model, **overrides)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = {v.name: init.to_numpy(v.name) for v in main.list_vars() if v.persistable}
    test = main.clone(for_test=True)
    logits = fetches["logits"].name
    out = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        fluid.io.load_numpy_params(scope, state, device=place.device)
        out.append(fluid.Executor(place).run(test, feed=forward_feed, fetch_list=[logits],
                                             scope=scope)[0])
    dlogits, tol = float(np.abs(out[0] - out[1]).max()), 1e-4 * max(1.0, float(np.abs(out[1]).max()))
    emit({"phase": "vision_parity", "model": model, "forward": "test mode",
          "max_abs_dlogits": dlogits, "tol": tol})
    if not dlogits <= tol:
        raise AssertionError(f"{model}: card vs CPU test-mode logits differ by {dlogits} > {tol}")
    runs, near_zero = parity_runs(fluid, main, fetches["loss"].name, state, feed)
    lr = learning_rate(init, state)
    hold_parity({"phase": "vision_parity", "model": model,
                 "config": {k: str(v) for k, v in overrides.items()}}, runs, near_zero, state, lr)


def vision_parity(fluid, torch):
    """Phase 35: each model of the family card against CPU at a reduced size."""
    for model in ("se_resnext", "vgg"):
        vision_conv_parity(fluid, torch, model)
    lstm = dict(vocab_size=5000, emb_dim=128, hidden_dim=128, stacked_num=3)
    vision_free_parity(fluid, torch, "stacked_lstm", lstm,
                       vision_feed("stacked_lstm", 8, 92, max_len=32, min_len=5),
                       {k: v for k, v in vision_feed("stacked_lstm", 8, 93, max_len=32,
                                                     min_len=5).items() if k != "label"})
    vision_free_parity(fluid, torch, "word2vec", {}, vision_feed("word2vec", 64, 94),
                       vision_feed("word2vec", 16, 95))


def profiled_trace(fluid, torch, ck, tmp, card, profiled):
    """Phase 36: phase 31's SE-ResNeXt-50 step under
    profiler.profiler(state="All", trace_dir=...): a fresh graphed executor
    takes two steps (eager, capture), the third (a replay) runs under the
    profiler, whose Chrome trace must name every kernel of the step's
    launches (counted by name) and hold the executor's spans; the monitor's
    Prometheus page and the profiler's summary table are printed (their
    sizes) and must not be empty."""
    main, startup, loss, feed, per_step = profiled
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope, return_numpy=False)
    torch.cuda.synchronize()
    fluid.monitor.reset()
    trace_dir = os.path.join(tmp, "trace")
    t0 = time.perf_counter()
    with fluid.profiler.profiler(state="All", profile_path=os.path.join(tmp, "summary.txt"),
                                 trace_dir=trace_dir):
        pad_session(torch)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope, return_numpy=False)
        pad_session(torch)
    wall_s = time.perf_counter() - t0
    with open(os.path.join(trace_dir, fluid.profiler.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    counts = dict(NONE)
    for ev in events:
        if ev.get("cat") == "kernel" and PORT_KERNEL.search(ev.get("name", "")):
            key = KERNEL_KEY.get(KERNEL_OF.search(ev["name"]).group(1))
            if key is not None:
                counts[key] += 1
    spans = sorted({ev["name"] for ev in events if ev.get("pid") == "paddle_tpu_torch.monitor"
                    and ev.get("ph") == "X"})
    prom = fluid.monitor.export_prometheus()
    table = fluid.profiler.summary()
    emit({"phase": "profiled_trace", "model": "se_resnext f32 batch 64, graphed step",
          "trace_events": len(events), "kernel_events": sum(e.get("cat") == "kernel" for e in events),
          "port_kernels_by_name": {k: v for k, v in counts.items() if v}, "per_step": {
              k: v for k, v in per_step.items() if v}, "monitor_spans": spans,
          "prometheus_bytes": len(prom), "summary_rows": len(table.splitlines()) - 1,
          "trace_bytes": os.path.getsize(os.path.join(trace_dir, fluid.profiler.TRACE_FILE)),
          "profiled_wall_s": wall_s, "card": card})
    print(table, flush=True)
    missing = [k for k, v in per_step.items() if v and not counts[k]]
    if missing or "executor.dispatch" not in spans:
        raise AssertionError(f"profiled_trace: kernels {missing} not in the trace, or no "
                             f"executor span in {spans}")
    if "executor_dispatch" not in prom or len(table.splitlines()) < 2:
        raise AssertionError("profiled_trace: an empty Prometheus page or summary table")
    fluid.monitor.reset()


def make_optimizer(fluid, which):
    """The optimizer of phases 37, 38 and 40 (OPTIMIZER_NAMES), built inside
    the caller's program_guard: its schedule's ops join the program."""
    layers = fluid.layers
    if which == "lamb":
        lr = layers.linear_lr_warmup(layers.polynomial_decay(1e-3, decay_steps=1000,
                                                             end_learning_rate=0.0, power=1.0),
                                     warmup_steps=2, start_lr=0.0, end_lr=1e-3)
        return fluid.optimizer.Lamb(lr, lamb_weight_decay=0.01, epsilon=1e-6)
    if which == "lars":
        return fluid.optimizer.LarsMomentum(layers.cosine_decay(0.1, step_each_epoch=5, epochs=90),
                                            momentum=0.9, lars_coeff=0.001,
                                            lars_weight_decay=5e-4)
    if which == "lamb_parity":
        return fluid.optimizer.Lamb(LR, lamb_weight_decay=0.01, epsilon=1e-6)
    if which == "lars_parity":
        return fluid.optimizer.LarsMomentum(RESNET_PARITY_LR, momentum=0.9, lars_coeff=0.001,
                                            lars_weight_decay=5e-4)
    raise ValueError(which)


def lamb_tail(fluid, torch, card):
    """Phase 37's LAMB tail: phase 37's graphed step profiled against the
    same BERT-base step with no update (append_backward alone, one gradient
    fetched so the backward runs); the difference in kernels and device time
    is the tail (198 lamb ops and the schedule's ops)."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    feed = make_fake_batch(32, 128, 30522, rng=np.random.RandomState(0))
    rec = {}
    for which in ("lamb", "backward_only"):
        main, startup, loss = build_train(fluid, "bfloat16", 12, 0.1, 128, True, False, which)
        fetch = [loss] + ([main.all_parameters()[0].name + "@GRAD"]
                          if which == "backward_only" else [])
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        run = lambda: exe.run(main, feed=feed, fetch_list=fetch, scope=scope,  # noqa: E731
                              return_numpy=False)
        for _ in range(3):  # eager, capture, replay
            run()
        if not exe.last_plan.graphed:
            raise AssertionError(f"lamb_tail {which}: not graphed ({exe.last_plan.graph_refusal})")
        _, rec[which] = profile_run(torch, f"train_lamb tail: {which} graphed step", run, card)
        del exe, scope
        gc.collect()
    tail = {"phase": "train_lamb", "lamb_tail_kernels": rec["lamb"]["kernel_launches"]
            - rec["backward_only"]["kernel_launches"],
            "lamb_tail_device_ms": rec["lamb"]["device_busy_ms"]
            - rec["backward_only"]["device_busy_ms"],
            "step_kernels": rec["lamb"]["kernel_launches"],
            "backward_only_kernels": rec["backward_only"]["kernel_launches"],
            "step_device_busy_ms": rec["lamb"]["device_busy_ms"],
            "backward_only_device_busy_ms": rec["backward_only"]["device_busy_ms"], "card": card}
    emit(tail)
    return tail


def build_seq2seq(fluid, src_vocab, tgt_vocab, emb_dim, enc_dim, dec_dim,
                  learning_rate=SEQ2SEQ_LR):
    """benchmark/fluid/models/machine_translation.py of the reference on a
    padded ragged batch (the same function as tests/test_torch_ragged.py's):
    a bidirectional LSTM encoder (fc(tanh) -> dynamic_lstm, no peepholes,
    one reversed), a tanh boot state from the reverse LSTM's first step,
    and a DynamicRNN decoder with Bahdanau attention (fc -> sequence_expand
    -> concat -> fc(1, tanh) -> sequence_softmax -> scale ->
    sequence_pool(sum)) and a hand-written LSTM step (four fc's over [h, x],
    sums) under a softmax fc over the target vocabulary; cross_entropy,
    token-masked mean, Adam.  The lengths companion is set by hand where a
    layer does not carry it, and concat takes axis 2 on padded ragged
    values.  Returns (main, startup, {"loss", "pred"}) under a unique-name
    guard, random weights from seed 0."""
    layers = fluid.layers
    seq = fluid.layers.sequence
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = layers.data("src_word", [1], dtype="int64", lod_level=1)
        tgt = layers.data("trg_word", [1], dtype="int64", lod_level=1)
        lbl = layers.data("lbl_word", [1], dtype="int64", lod_level=1)
        src_lod, tgt_lod = seq._lod_of(src), seq._lod_of(tgt)
        src_emb = seq._set_lod(layers.embedding(src, [src_vocab, emb_dim]), src_lod)

        def encoder_lstm(reverse):
            proj = seq._set_lod(layers.fc(src_emb, enc_dim * 4, num_flatten_dims=2, act="tanh",
                                          bias_attr=False), src_lod)
            return layers.dynamic_lstm(proj, enc_dim * 4, use_peepholes=False,
                                       is_reverse=reverse)[0]

        fwd, rev = encoder_lstm(False), encoder_lstm(True)
        enc_vec = seq._set_lod(layers.concat([fwd, rev], axis=2), src_lod)
        enc_proj = seq._set_lod(layers.fc(enc_vec, dec_dim, num_flatten_dims=2, bias_attr=False),
                                src_lod)
        boot = layers.fc(layers.sequence_first_step(rev), dec_dim, act="tanh", bias_attr=False)
        tgt_emb = seq._set_lod(layers.embedding(tgt, [tgt_vocab, emb_dim]), tgt_lod)
        rnn = layers.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(tgt_emb)
            h_prev = rnn.memory(init=boot)
            c_prev = rnn.memory(shape=[dec_dim], value=0.0)
            state = layers.fc(h_prev, dec_dim, bias_attr=False)
            expanded = layers.sequence_expand(state, enc_proj)
            scores = seq._set_lod(layers.fc(layers.concat([enc_proj, expanded], axis=2), 1,
                                            num_flatten_dims=2, act="tanh", bias_attr=False),
                                  src_lod)
            weights = layers.sequence_softmax(scores)
            context = layers.sequence_pool(
                seq._set_lod(layers.elementwise_mul(enc_vec, weights), src_lod), "sum")
            x = layers.concat([context, word], axis=1)
            f, i, o = (layers.sigmoid(layers.fc([h_prev, x], dec_dim)) for _ in range(3))
            cand = layers.tanh(layers.fc([h_prev, x], dec_dim))
            c = layers.sums([layers.elementwise_mul(f, c_prev), layers.elementwise_mul(i, cand)])
            h = layers.elementwise_mul(o, layers.tanh(c))
            rnn.update_memory(h_prev, h)
            rnn.update_memory(c_prev, c)
            rnn.output(layers.fc(h, tgt_vocab, act="softmax"))
        pred = rnn()
        ce = seq._set_lod(layers.cross_entropy(pred, lbl), tgt_lod)
        ntok = layers.reduce_sum(layers.cast(tgt_lod, "float32"))
        loss = layers.elementwise_div(layers.reduce_sum(layers.sequence_pool(ce, "sum")), ntok)
        fluid.optimizer.Adam(learning_rate).minimize(loss)
    main.random_seed = startup.random_seed = 0
    return main, startup, {"loss": loss, "pred": pred}


def seq2seq_feed(lod_cls, n_pairs, min_len, max_len, src_vocab, tgt_vocab, seed):
    """`n_pairs` ragged pairs, lengths uniform in [min_len, max_len]; the
    labels are the targets shifted by one."""
    import numpy as np

    r = np.random.RandomState(seed)
    src, tgt, lbl = [], [], []
    for _ in range(n_pairs):
        ns, nt = r.randint(min_len, max_len + 1, 2)
        src.append(r.randint(2, src_vocab, (ns, 1)).astype(np.int64))
        t = r.randint(2, tgt_vocab, (nt + 1, 1)).astype(np.int64)
        tgt.append(t[:-1])
        lbl.append(t[1:])
    return {"src_word": lod_cls(src), "trg_word": lod_cls(tgt), "lbl_word": lod_cls(lbl)}


def seq2seq_train(fluid, torch, ck, card):
    """Phase 39: the seq2seq at full width (SEQ2SEQ) trains TRAIN_STEPS Adam
    steps on one fixed batch of 32 ragged pairs, eager then graphed
    (train_arm; a refused plan's reason is in its record): the loss finite
    and falling, Adam's launches a step equal to the program's parameters
    (no other kernel: the tanh / sigmoid fc's and the softmax +
    cross_entropy have none in either package)."""
    t0 = time.perf_counter()
    main, startup, fetches = build_seq2seq(fluid, **SEQ2SEQ)
    loss = fetches["loss"].name
    per_step = launches_of_program(main, loss)
    n_params = len(main.all_parameters())
    if per_step != dict(NONE, adam=n_params):
        raise AssertionError(f"seq2seq: the program's kernel ops {per_step} != Adam x {n_params}")
    feed = seq2seq_feed(fluid.LoDTensor, SEQ2SEQ_BATCH, SEQ2SEQ_MIN_LEN, SEQ2SEQ_MAX_LEN,
                        SEQ2SEQ["src_vocab"], SEQ2SEQ["tgt_vocab"], 140)
    tokens = int(feed["trg_word"].lengths.sum())
    emit({"phase": "seq2seq_train", "model": "machine_translation f32 " + str(SEQ2SEQ),
          "optimizer": f"Adam({SEQ2SEQ_LR})", "pairs": SEQ2SEQ_BATCH,
          "target_tokens": tokens, "source_tokens": int(feed["src_word"].lengths.sum()),
          "ops": len(main.global_block().ops), "body_ops": len(main.blocks[1].ops),
          "params": n_params, "setup_s": time.perf_counter() - t0})
    launches = dict(NONE)
    ck.reset_launches()  # the main path's count starts here
    for arm in ("eager", "graphed"):
        losses, scope, rec = train_arm(fluid, torch, ck, card, "seq2seq_train", arm, main, startup,
                                       loss, feed, per_step, launches,
                                       {"sentences": SEQ2SEQ_BATCH, "target_tokens": tokens})
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"seq2seq_train {arm}: the loss did not fall: {losses}")
        if arm == "graphed" and rec["graph_refusal"]:
            emit({"phase": "seq2seq_train", "graph_refused": rec["graph_refusal"]})
        del scope
    return launches


def hold_state_parity(record, runs, near_zero, state, lr, steps=PARITY_STEPS):
    """Phase 7's rule for any optimizer: losses 1e-3; each parameter 1e-5,
    save elements whose CPU gradient is 0 to rounding at some step
    (2·lr·steps + 1e-5); every other persistable (the accumulators, by the
    suffix after the parameter's name) 1e-4 of the largest of its kind."""
    import numpy as np

    (gl, gs), (cl, cs) = runs
    dloss = max(abs(a - b) for a, b in zip(gl, cl))
    worst_p, worst_flip = (0.0, ""), 0.0
    for p, small in near_zero.items():
        err = np.abs(gs.to_numpy(p).astype(np.float64) - cs.to_numpy(p))
        held = err[~small]
        worst_p = max(worst_p, (float(held.max()) if held.size else 0.0, p))
        worst_flip = max(worst_flip, float(err.max()))
    kinds = {}
    for n in state:
        if n in near_zero:
            continue
        owner = max((p for p in near_zero if n.startswith(p + "_")), key=len, default=None)
        kinds.setdefault(n[len(owner):] if owner else n, []).append(n)
    worst_acc = {}
    for kind, names in kinds.items():
        peak = max(float(np.abs(cs.to_numpy(n)).max()) for n in names)
        worst = max(float(np.abs(gs.to_numpy(n).astype(np.float64) - cs.to_numpy(n)).max())
                    for n in names)
        worst_acc[kind] = (worst, 1e-4 * peak)
    emit({**record, "losses_card": gl, "losses_cpu": cl, "max_abs_dloss": dloss,
          "max_abs_dparam": worst_p[0], "param": worst_p[1], "max_abs_dparam_all": worst_flip,
          "sign_flip_tol": 2 * lr * steps + 1e-5,
          "accumulators": {k: {"max_abs_d": w, "tol": t} for k, (w, t) in worst_acc.items()}})
    if not (dloss <= 1e-3 and worst_p[0] <= 1e-5 and worst_flip <= 2 * lr * steps + 1e-5):
        raise AssertionError(f"{record}: card vs CPU losses {gl} / {cl}, parameter {worst_p}, "
                             f"any element {worst_flip}")
    bad = {k: v for k, v in worst_acc.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"{record}: card vs CPU accumulators {bad}")


def build_mlp(fluid, which=None, extra=None):
    """Phase 40's MLP: x [64] -> fc 128 tanh -> fc 128 tanh -> fc 1, square
    error; `which` an OPTIM_PARITY key (or `extra(fluid, loss)` builds the
    update), random weights from seed 0."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    made = None
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data("x", [64], dtype="float32")
        y = layers.data("y", [1], dtype="float32")
        h = layers.fc(layers.fc(x, 128, act="tanh"), 128, act="tanh")
        loss = layers.mean(layers.square_error_cost(layers.fc(h, 1), y))
        if which is not None:
            cls, args, kw = OPTIM_PARITY[which]
            getattr(fluid.optimizer, cls)(*args, **kw).minimize(loss)
        if extra is not None:
            made = extra(fluid, loss)
    main.random_seed = startup.random_seed = 0
    return main, startup, loss.name, made


def mlp_feed(seed, batch=64):
    import numpy as np

    r = np.random.RandomState(seed)
    x = r.randn(batch, 64).astype(np.float32)
    return {"x": x, "y": np.tanh(x[:, :8].sum(1, keepdims=True)).astype(np.float32)}


def cpu_state(fluid, main, startup):
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return {v.name: scope.to_numpy(v.name).copy() for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def op_parity(fluid, op_type, ins, attrs, state_slots, steps=PARITY_STEPS):
    """One update op run `steps` times on the card (graphed from its second
    run) and on the CPU from the same inputs, each run's `<Slot>Out` fed back
    as the next run's `<Slot>` (persistables written in place); returns the
    largest difference of each slot, relative to the CPU's largest value."""
    import numpy as np

    out = {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        main = fluid.Program()
        block = main.global_block()
        for slot, arr in ins.items():
            block.create_var(slot.lower(), shape=arr.shape, dtype=str(arr.dtype),
                             persistable=True)
        block.append_op(op_type, inputs={k: [k.lower()] for k in ins},
                        outputs={f"{k}Out": [k.lower()] for k in state_slots}, attrs=attrs)
        scope = fluid.Scope()
        fluid.io.load_numpy_params(scope, {k.lower(): v for k, v in ins.items()},
                                   device=place.device)
        exe = fluid.Executor(place)
        for _ in range(steps):
            exe.run(main, scope=scope, fetch_list=[k.lower() for k in state_slots])
        out[place.device.type] = {k: scope.to_numpy(k.lower()).copy() for k in state_slots}
    return {k: float(np.abs(out["cuda"][k] - out["cpu"][k]).max())
            / max(1e-30, float(np.abs(out["cpu"][k]).max())) for k in state_slots}


def averages_under_graph(fluid, torch, card):
    """EMA and ModelAverage: SGD steps with the average's ops, graphed from
    the second run; apply() swaps the average into the tensors the captured
    graph reads (the same objects), an eval plan captured inside it gives
    the CPU's loss over the averaged values; on exit the parameters are
    back bit for bit and the training graph replays on without a
    recapture."""
    import numpy as np

    def ema(fl, loss):
        fl.optimizer.SGD(0.05).minimize(loss)
        e = fl.optimizer.ExponentialMovingAverage(0.9)
        e.update()
        return e

    def model_average(fl, loss):
        fl.optimizer.SGD(0.05).minimize(loss)
        a = fl.optimizer.ModelAverage(max_average_window=3)
        a.update()
        return a

    results = {}
    for name, extra in (("ema", ema), ("model_average", model_average)):
        main, startup, loss, avg = build_mlp(fluid, extra=extra)
        test = main.clone(for_test=True)
        state = cpu_state(fluid, main, startup)
        scopes, exes, losses = {}, {}, {}
        for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
            scope = fluid.Scope()
            fluid.io.load_numpy_params(scope, state, device=place.device)
            exe = fluid.Executor(place)
            for step in range(4):
                exe.run(main, feed=mlp_feed(step), fetch_list=[loss], scope=scope)
            scopes[place.device.type], exes[place.device.type] = scope, exe
        exe, scope = exes["cuda"], scopes["cuda"]
        plan = exe.last_plan
        if not plan.graphed:
            raise AssertionError(f"{name}: the training plan is not graphed: {plan.graph_refusal}")
        graph = plan.graph
        params = [p.name for p in main.all_parameters()]
        tensors = {n: scope.find_var(n) for n in params}
        before = {n: t.clone() for n, t in tensors.items()}
        with avg.apply(exes["cpu"], scopes["cpu"]):
            cpu_eval = float(exes["cpu"].run(test, feed=mlp_feed(9), fetch_list=[loss],
                                             scope=scopes["cpu"])[0].reshape(-1)[0])
        with avg.apply(exe, scope):
            same = all(scope.find_var(n) is tensors[n] for n in params)
            evals = [float(exe.run(test, feed=mlp_feed(9), fetch_list=[loss],
                                   scope=scope)[0].reshape(-1)[0]) for _ in range(3)]
            eval_graphed = exe.last_plan.graphed
            swapped = any(not torch.equal(tensors[n], before[n]) for n in params)
        back = all(scope.find_var(n) is tensors[n] and torch.equal(tensors[n], before[n])
                   for n in params)
        after = float(exe.run(main, feed=mlp_feed(4), fetch_list=[loss], scope=scope)[0]
                      .reshape(-1)[0])
        replayed_on = exe.last_plan.graph is graph
        results[name] = {"same_tensors": same, "swapped": swapped, "eval_graphed": eval_graphed,
                         "eval_losses_card": evals, "eval_loss_cpu": cpu_eval,
                         "restored_bitwise": back, "training_graph_kept": replayed_on,
                         "loss_after": after}
        if not (same and swapped and eval_graphed and back and replayed_on
                and np.isfinite(after) and max(abs(e - cpu_eval) for e in evals)
                <= 1e-5 * max(1.0, abs(cpu_eval))):
            raise AssertionError(f"{name} apply/restore under a graph: {results[name]}")
    emit({"phase": "optim_parity", "averages": results, "card": card})


def optim_parity(fluid, torch, card):
    """Phase 40: card vs CPU, float32.  Each optimizer of OPTIM_PARITY 3
    steps on build_mlp from one CPU-initialized state by phase 7's rule
    (hold_state_parity); DGC's transform, proximal_gd and proximal_adagrad
    as one-op runs fed back 3 times (1e-5 of the CPU's largest; DGC's top-k
    on identical inputs: selections equal); dpsgd by its noise's moments;
    BERT-base 2 layers with LAMB by phase 7's rule; ResNet-50 at phase 11's
    size with LARS by phase 11's; EMA and ModelAverage apply / restore
    under a captured graph; the seven schedules over 8 runs (graphed from
    the second) equal to the CPU's within 1e-6 of their largest."""
    import numpy as np

    t0 = time.perf_counter()
    feed = mlp_feed(0)
    for which, (cls, _, _) in OPTIM_PARITY.items():
        main, startup, loss, _ = build_mlp(fluid, which)
        state = cpu_state(fluid, main, startup)
        warm = WARM_START.get(cls)
        for n in state:
            if warm and n.endswith(warm):
                state[n] = np.full_like(state[n], 0.1)
        runs, near_zero = parity_runs(fluid, main, loss, state, feed)
        lr = OPTIM_PARITY[which][1][0]
        hold_state_parity({"phase": "optim_parity", "optimizer": which, "mlp": "64-128-128-1",
                           "batch": 64}, runs, near_zero, state, lr)
    r = np.random.RandomState(40)
    f32 = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    lr1 = np.array([0.1], np.float32)
    one_op = {
        "dgc": ("dgc", {"Grad": f32(128, 128), "U": f32(128, 128), "V": f32(128, 128),
                        "CurrentStep": np.array([3.0], np.float32)},
                {"m": 0.9, "rampup_begin_step": 1.0, "rampup_step": 4.0,
                 "sparsity": [0.75, 0.9]}, ("U", "V")),
        "proximal_gd": ("proximal_gd", {"Param": f32(64, 128), "Grad": f32(64, 128),
                                        "LearningRate": lr1}, {"l1": 0.05, "l2": 0.1},
                        ("Param",)),
        "proximal_adagrad": ("proximal_adagrad", {"Param": f32(64, 128), "Grad": f32(64, 128),
                                                  "Moment": np.abs(f32(64, 128)) + 0.1,
                                                  "LearningRate": lr1},
                             {"l1": 0.05, "l2": 0.1}, ("Param", "Moment")),
    }
    ops_rec = {}
    for name, (op_type, ins, attrs, slots) in one_op.items():
        ops_rec[name] = op_parity(fluid, op_type, ins, attrs, slots)
        if max(ops_rec[name].values()) > 1e-5:
            raise AssertionError(f"{name} card vs CPU: {ops_rec[name]}")
    # dpsgd: a 0 gradient, so the update is -lr * sigma * clip * z / batch = 0.75 z
    prog = fluid.Program()
    block = prog.global_block()
    for n in ("p", "g", "lr"):
        block.create_var(n, shape=(1,) if n == "lr" else (400, 250), dtype="float32",
                         persistable=True)
    block.append_op("dpsgd", inputs={"Param": ["p"], "Grad": ["g"], "LearningRate": ["lr"]},
                    outputs={"ParamOut": ["p"]}, attrs={"clip": 2.0, "sigma": 1.5,
                                                        "batch_size": 4.0})
    scope = fluid.Scope()
    fluid.io.load_numpy_params(scope, {"p": np.zeros((400, 250), np.float32),
                                       "g": np.zeros((400, 250), np.float32),
                                       "lr": np.ones(1, np.float32)}, device="cuda:0")
    fluid.Executor(fluid.CUDAPlace(0)).run(prog, scope=scope, fetch_list=["p"])
    noise = scope.to_numpy("p")
    ops_rec["dpsgd"] = {"mean": float(noise.mean()), "std": float(noise.std()), "want_std": 0.75}
    if not (abs(noise.mean()) < 0.01 and abs(noise.std() - 0.75) < 0.01):
        raise AssertionError(f"dpsgd noise moments {ops_rec['dpsgd']}")
    emit({"phase": "optim_parity", "one_op_rel_err": ops_rec, "tol": 1e-5})
    # BERT-base 2 layers with LAMB (phase 7), ResNet-50 at phase 11's size with LARS
    main, startup, loss = build_train(fluid, "float32", 2, 0.0, optimizer="lamb_parity")
    state = cpu_state(fluid, main, startup)
    for name in state:
        if name.endswith(("emb_ln.w", ".ln1.w", ".ln2.w")):
            state[name] = np.ones_like(state[name])
    from paddle_tpu_torch.models.transformer import make_fake_batch

    runs, near_zero = parity_runs(fluid, main, loss, state,
                                  make_fake_batch(2, 128, 30522, rng=np.random.RandomState(1)))
    hold_parity({"phase": "optim_parity", "model": "bert-base f32, 2 layers, dropout 0, "
                 + OPTIMIZER_NAMES["lamb_parity"], "batch": 2, "seq_len": 128}, runs, near_zero,
                state, LR)
    resnet_train_parity(fluid, torch, optimizer="lars_parity")
    averages_under_graph(fluid, torch, card)
    values = {}
    for fn, (args, kw) in SCHEDULES.items():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            lr = getattr(fluid.layers, fn)(*args, **kw)
        got = {}
        for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
            exe, scope = fluid.Executor(place), fluid.Scope()
            exe.run(startup, scope=scope)
            got[place.device.type] = [float(exe.run(main, fetch_list=[lr], scope=scope)[0]
                                            .reshape(-1)[0]) for _ in range(8)]
        values[fn] = got
        peak = max(abs(v) for v in got["cpu"])
        if max(abs(a - b) for a, b in zip(got["cuda"], got["cpu"])) > 1e-6 * peak:
            raise AssertionError(f"{fn}: card {got['cuda']} vs CPU {got['cpu']}")
    emit({"phase": "optim_parity", "schedules": values, "seconds": time.perf_counter() - t0,
          "card": card})


def ragged_programs(fluid):
    """Phase 41's small programs (name -> (main, startup, fetch names, feed)),
    each built as a user builds it: a CRF tagger (fc emissions,
    linear_chain_crf, crf_decoding), the recurrences (dynamic_gru reversed,
    dynamic_lstmp, a 2-layer bidirectional lstm), warpctc, a StaticRNN, a
    cond and the tensor arrays."""
    import numpy as np

    layers = fluid.layers
    r = np.random.RandomState(41)
    lens = [5, 2, 7, 4]
    seqs = fluid.LoDTensor([r.randn(n, 6).astype(np.float32) for n in lens])
    tags = fluid.LoDTensor([r.randint(0, 4, (n, 1)).astype(np.int64) for n in lens])
    ctc_lbl = fluid.LoDTensor([r.randint(1, 5, (m, 1)).astype(np.int64) for m in (2, 1, 3, 2)])
    dense = r.randn(4, 5, 3).astype(np.float32)
    out = {}

    def program(name, build, feed):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetches = build()
        main.random_seed = startup.random_seed = 0
        out[name] = (main, startup, [f.name for f in fetches], feed)

    def crf():
        x = layers.data("x", [6], dtype="float32", lod_level=1)
        label = layers.data("label", [1], dtype="int64", lod_level=1)
        emission = layers.fc(x, 4, num_flatten_dims=2)
        layers.sequence._set_lod(emission, layers.sequence._lod_of(x))
        attr = fluid.ParamAttr(name="crfw")
        return [layers.linear_chain_crf(emission, label, param_attr=attr),
                layers.crf_decoding(emission, param_attr=attr)]

    def recurrences():
        x = layers.data("x", [6], dtype="float32", lod_level=1)
        d = layers.data("dense", [5, 3], dtype="float32")
        lod = layers.sequence._lod_of(x)
        gru = layers.dynamic_gru(layers.sequence._set_lod(
            layers.fc(x, 24, num_flatten_dims=2), lod), 8, is_reverse=True)
        proj, cell = layers.dynamic_lstmp(layers.sequence._set_lod(
            layers.fc(x, 32, num_flatten_dims=2), lod), 32, 5)
        init = layers.fill_constant([4, 4, 8], "float32", 0.1)
        seq_out, last_h, last_c = layers.lstm(d, init, init, 5, 8, 2, is_bidirec=True)
        return [gru, proj, cell, seq_out, last_h, last_c]

    def ctc():
        x = layers.data("x", [6], dtype="float32", lod_level=1)
        label = layers.data("ctc_label", [1], dtype="int64", lod_level=1)
        logits = layers.sequence._set_lod(layers.fc(x, 5, num_flatten_dims=2),
                                          layers.sequence._lod_of(x))
        return [layers.warpctc(logits, label, norm_by_times=True)]

    def static_rnn():
        d = layers.data("dense", [5, 3], dtype="float32")
        rnn = layers.StaticRNN()
        with rnn.step():
            step = rnn.step_input(d)
            acc = rnn.memory(shape=[3], value=0.0)
            new = layers.tanh(acc + step)
            rnn.update_memory(acc, new)
            rnn.step_output(new)
        return [rnn()]

    def cond():
        d = layers.data("dense", [5, 3], dtype="float32")
        flag = layers.data("flag", [1], dtype="bool", append_batch_size=False)
        return [layers.cond(flag, lambda: layers.scale(d, 2.0), lambda: layers.exp(d))]

    def arrays():
        d = layers.data("dense", [5, 3], dtype="float32")
        i0 = layers.fill_constant([1], "int64", 0)
        i1 = layers.fill_constant([1], "int64", 1)
        arr = layers.array_write(d, i0)
        layers.array_write(layers.tanh(d), i1, array=arr)
        return [layers.array_length(arr), layers.array_read(arr, i1)]

    program("crf", crf, {"x": seqs, "label": tags})
    program("recurrences", recurrences, {"x": seqs, "dense": dense})
    program("warpctc", ctc, {"x": seqs, "ctc_label": ctc_lbl})
    program("static_rnn", static_rnn, {"dense": dense})
    for flag in (True, False):
        program(f"cond_{flag}", cond, {"dense": dense, "flag": np.array([flag])})
    program("arrays", arrays, {"dense": dense})
    return out


def ragged_parity(fluid, torch, card):
    """Phase 41: card vs CPU.  The seq2seq at width 64, vocab 200, 4 pairs,
    3 Adam steps by phase 7's rule; ragged_programs' forwards from one CPU
    state: the CRF's NLL within 1e-4 and its Viterbi paths equal, the rest
    within 1e-5 * (1 + max|CPU|), integers equal; each run 3 times, and the
    cond and array plans are refused a CUDA graph with their reason and run
    eagerly, while the others replay theirs."""
    import numpy as np

    t0 = time.perf_counter()
    main, startup, fetches = build_seq2seq(fluid, **SEQ2SEQ_PARITY)
    state = cpu_state(fluid, main, startup)
    feed = seq2seq_feed(fluid.LoDTensor, 4, 5, 20, SEQ2SEQ_PARITY["src_vocab"],
                        SEQ2SEQ_PARITY["tgt_vocab"], 141)
    runs, near_zero = parity_runs(fluid, main, fetches["loss"].name, state, feed)
    hold_parity({"phase": "ragged_parity", "model": "seq2seq f32 " + str(SEQ2SEQ_PARITY),
                 "pairs": 4}, runs, near_zero, state, SEQ2SEQ_LR)
    records = {}
    for name, (prog, startup, fetch, pfeed) in ragged_programs(fluid).items():
        state = cpu_state(fluid, prog, startup)
        got = {}
        for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
            scope = fluid.Scope()
            fluid.io.load_numpy_params(scope, state, device=place.device)
            exe = fluid.Executor(place)
            for _ in range(3):
                vals = exe.run(prog, feed=pfeed, fetch_list=fetch, scope=scope)
            got[place.device.type] = (vals, exe.last_plan)
        (card_vals, plan), (cpu_vals, _) = got["cuda"], got["cpu"]
        errs = []
        for k, (a, b) in enumerate(zip(card_vals, cpu_vals)):
            a, b = np.asarray(a), np.asarray(b)
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{name} output {k}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
            if not np.issubdtype(b.dtype, np.floating):
                errs.append(int((a != b).sum()))
                continue
            tol = 1e-4 if name == "crf" else 1e-5 * (1 + float(np.abs(b).max()))
            errs.append(float(np.abs(a.astype(np.float64) - b).max()))
            if not errs[-1] <= tol:
                raise AssertionError(f"{name} output {k}: card vs CPU {errs[-1]} > {tol}")
        if any(e != 0 for e, b in zip(errs, cpu_vals)
               if not np.issubdtype(np.asarray(b).dtype, np.floating)):
            raise AssertionError(f"{name}: integer outputs differ {errs}")
        refused = name.startswith(("cond", "arrays"))
        records[name] = {"max_abs_err": errs, "graphed": plan.graphed,
                         "graph_refusal": plan.graph_refusal}
        if refused != (plan.graph_refusal is not None) or plan.graphed == refused:
            raise AssertionError(f"{name}: graphed {plan.graphed}, refusal {plan.graph_refusal}")
    emit({"phase": "ragged_parity", "programs": records, "seconds": time.perf_counter() - t0,
          "card": card})


def check_seq2seq_kernels(torch, ck, record):
    """Phase 3 at the seq2seq's shapes: its one kernel is Adam, at its
    largest parameters (the 30,000 x 512 embeddings and the 512 x 30,000
    softmax fc, float32)."""
    hold_adam_at(torch, ck, record, torch.Generator(device="cuda:0").manual_seed(5),
                 30000 * 512, "seq2seq embedding / softmax fc")
    emit({"timing": "adam", **{k: r for k, r in record["adam"].items()
                               if k == f"at_{30000 * 512}_f32"}})


# --- the detection family and bf16 attention scores (phases 42-47) ----------

# MobileNet-v1 SSD as PaddlePaddle/models PaddleCV/object_detection/
# mobilenet_ssd.py trains it on Pascal VOC (300 x 300, 21 classes, RMSProp
# 1e-3) and YOLOv3 on DarkNet-53 as PaddleCV/yolov3 trains it on COCO
# (608 x 608, 80 classes, Momentum 1e-3 / 0.9, L2Decay 5e-4), both float32
# and full depth; ground truth synthetic from the seed, 1-20 boxes an image
# padded to 50 (paddle_tpu_torch/models/detection.py)
SSD_BATCH = 64
YOLO_BATCH = 8
SSD_SERVE_BATCHES = (1, 64)
YOLO_SERVE_BATCHES = (1, 8)
# 35 batch norms over NCHW in the SSD (27 in MobileNet-v1, 2 in each of the
# 4 extra blocks), 72 in YOLOv3 (52 in DarkNet-53, 6 in each of the 3
# detection blocks, 2 transitions); RMSProp and Momentum have no kernel
SSD_PER_STEP = dict(NONE, bn_epilogue_fwd=35, bn_epilogue_bwd=35)
YOLO_PER_STEP = dict(NONE, bn_epilogue_fwd=72, bn_epilogue_bwd=72)
SSD_PER_REQUEST = dict(NONE, bn_epilogue_fwd=35)
YOLO_PER_REQUEST = dict(NONE, bn_epilogue_fwd=72)
# phase 47: a trained state after PARITY_STEPS Momentum steps, card against
# CPU, each tensor within this share of max(1, its largest magnitude) (float32,
# TF32 off, cuDNN deterministic: sums in other orders); served detections:
# labels equal, boxes and scores within 1e-5 of max(1, |CPU|)
DETECTION_STATE_TOL = 1e-4
DETECTION_OUT_TOL = 1e-5


def bert_bf16_scores(fluid, torch, ck, tmp, card):
    """Phase 42: bf16 BERT-base 32 x 128 with fused attention and
    attention_score_dtype="bfloat16", dropout 0.1, Adam 1e-4, eager and
    graphed in turns (phase 12's train: launches exactly
    FUSED_BF16_SCORES_PER_STEP, the graphed runs bit for bit, the loss
    falling); then served at batch 32 through create_predictor, REQUESTS
    requests (eager, capture, replay), BF16_SCORES_PER_REQUEST launches a
    request, run_ms printed, one replay profiled (serve_requests); then its
    long arm: the same model at 8 x 2048, graphed (phase 13's train with bf16
    scores, FUSED_BF16_SCORES_PER_STEP a step), its warm step printed beside
    phase 13's f32-score step of the same run.  Returns (training launches,
    serving launches, the long arm's launches)."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    trained = train(fluid, torch, ck, card, "bert_bf16_scores", True, 128, 32,
                    FUSED_BF16_SCORES_PER_STEP, arms=AB_ARMS, score_dtype="bfloat16")
    model_dir = os.path.join(tmp, "bert_base_bf16_scores")
    save_model(fluid, torch, model_dir, "bfloat16", 12, score_dtype="bfloat16")
    predictor = fluid.inference.create_predictor(fluid.inference.AnalysisConfig(model_dir))
    feed = make_fake_batch(32, 128, 30522, rng=np.random.RandomState(42))

    def check(batch, logits):
        if logits.shape != (batch * 128, 30522) or not np.isfinite(
                logits.astype(np.float32)).all():
            raise AssertionError(f"bert_bf16_scores serve: logits {logits.shape}")
        return {}

    served = serve_requests(fluid, torch, ck, card, "bert_bf16_scores_serve", predictor,
                            [(32, feed)], BF16_SCORES_PER_REQUEST, check)
    long_trained = train(fluid, torch, ck, card, "bert_bf16_scores_long", True, 2048, 8,
                         FUSED_BF16_SCORES_PER_STEP, score_dtype="bfloat16")
    bs, f32 = ARM_RECORDS["bert_bf16_scores_long"][-1], ARM_RECORDS["train_long"][-1]
    emit({"phase": "bert_bf16_scores_long", "vs": "train_long (phase 13, f32 scores)",
          "warm_step_ms": bs["warm_step_ms"], "f32_score_warm_step_ms": f32["warm_step_ms"],
          "difference_ms": bs["warm_step_ms"] - f32["warm_step_ms"],
          "device_busy_ms": bs["device_busy_ms"], "f32_score_device_busy_ms": f32["device_busy_ms"],
          "device_idle_share": bs["device_idle_share"],
          "f32_score_device_idle_share": f32["device_idle_share"],
          "launches_per_step": {k: v for k, v in FUSED_BF16_SCORES_PER_STEP.items() if v},
          "card": card})
    return trained, served, long_trained


def detection_program(fluid, model, with_optimizer=True, **overrides):
    """(main, startup, feeds, fetches) of models/detection.py's `model`
    ("ssd" or "yolov3") at its full configuration, `overrides` applied;
    random weights from seed 0."""
    from paddle_tpu_torch.models import detection

    build = {"ssd": detection.build_mobilenet_ssd, "yolov3": detection.build_yolov3}[model]
    with fluid.unique_name.guard():
        main, startup, feeds, fetches = build(with_optimizer=with_optimizer, **overrides)
    main.random_seed = startup.random_seed = 0
    return main, startup, feeds, fetches


def detection_batch(model, batch, seed, **kw):
    from paddle_tpu_torch.models import detection

    import numpy as np

    make = {"ssd": detection.make_ssd_batch, "yolov3": detection.make_yolo_batch}[model]
    return make(batch, rng=np.random.RandomState(seed), **kw)


def detection_train(fluid, torch, ck, card, model):
    """Phases 43 and 45: MobileNet-SSD (batch 64) or YOLOv3 (batch 8) trains
    TRAIN_STEPS steps on one fixed batch through Executor(CUDAPlace(0)).run,
    eager then graphed (train_arm: launches held each step, the monitor
    read, a profiled step); the graphed arm replays from its second step
    with no graph refusal; the loss falls in each arm; a step's BN-epilogue
    launches, read off the program, equal the reckoned count.  Returns the
    launches counted."""
    phase = f"{model}_train"
    batch = SSD_BATCH if model == "ssd" else YOLO_BATCH
    per_want = SSD_PER_STEP if model == "ssd" else YOLO_PER_STEP
    t0 = time.perf_counter()
    main, startup, _, fetches = detection_program(fluid, model)
    loss = fetches["loss"].name
    per_step = launches_of_program(main, loss)
    emit({"phase": phase, "model": model, "batch": batch, "ops": len(main.global_block().ops),
          "params": len(main.all_parameters()), "bn_epilogue_per_step_of_program":
          per_step["bn_epilogue_fwd"], "setup_s": time.perf_counter() - t0})
    if per_step != per_want:
        raise AssertionError(f"{phase}: the program's kernel ops {per_step} != {per_want}")
    feed = on_card(torch, detection_batch(model, batch, 7))
    launches = dict(NONE)
    ck.reset_launches()  # the main path's count starts here
    for arm in ("eager", "graphed"):
        losses, scope, record = train_arm(fluid, torch, ck, card, phase, arm, main, startup, loss,
                                          feed, per_step, launches, {"images": batch})
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{phase} {arm}: the loss did not fall: {losses}")
        if arm == "graphed" and record["graph_refusal"] is not None:
            raise AssertionError(f"{phase}: the graph was refused: {record['graph_refusal']}")
        del scope
    return launches


def detection_serve(fluid, torch, ck, tmp, card, model):
    """Phases 44 and 46: the model served by served_model with its detection
    head (SSD: detection_output, nms_threshold 0.45; YOLOv3: yolo_box +
    multiclass_nms, nms_top_k 1000, keep_top_k 100) at each of its serving
    batches: [N, keep_top_k, 6] finite detections, label -1 or a class; the
    BN epilogue once per batch norm a request, no other kernel."""
    import numpy as np

    keep, classes = (200, 21) if model == "ssd" else (100, 80)

    def program():
        main, startup, _, fetches = detection_program(fluid, model, with_optimizer=False)
        return main, startup, fetches["detections"]

    def check(batch, det):
        labels = det[..., 0]
        if not (det.shape == (batch, keep, 6) and np.isfinite(det).all()
                and np.isin(labels, np.arange(-1, classes)).all()):
            raise AssertionError(f"{model}_serve batch {batch}: detections {det.shape}")
        return {"detections": int((labels >= 0).sum())}

    return served_model(
        fluid, torch, ck, tmp, card, f"{model}_serve", program,
        ["img"] if model == "ssd" else ["img", "im_size"],
        lambda batch, seed: detection_batch(model, batch, seed), 4,
        SSD_SERVE_BATCHES if model == "ssd" else YOLO_SERVE_BATCHES,
        SSD_PER_REQUEST if model == "ssd" else YOLO_PER_REQUEST, check)


def detection_parity(fluid, torch, card):
    """Phase 47, card against CPU, float32 (TF32 off, cuDNN deterministic):
    the four models of models/detection_cases.py (the SSD of
    tests/test_detection_train.py:548, a YOLOv3 head with a second scale,
    the Faster R-CNN second stage of :657 and the RetinaNet head of :595),
    each PARITY_STEPS Momentum steps from one numpy
    state (the card graphed): losses and every persistable within
    DETECTION_STATE_TOL; each one's output (detections, sampled labels):
    labels and ids equal, boxes and scores within DETECTION_OUT_TOL at the
    first run, from that state, and within DETECTION_STATE_TOL at the later
    runs; every one-op case of models/detection_cases.py (the
    28 detection ops and the nn and host ops) within DETECTION_OUT_TOL of
    max(1, |CPU|), index outputs equal; plans holding print, py_func or
    detection_map refused a graph with their reason (executor._HOST_READ),
    counted in executor.graph_refused."""
    import numpy as np
    from paddle_tpu_torch.core.executor import _HOST_READ

    from paddle_tpu_torch.models import detection_cases

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, (build, make_feed) in detection_cases.MODELS.items():
            main, startup = fluid.Program(), fluid.Program()
            with fluid.unique_name.guard(), fluid.program_guard(main, startup):
                loss, (out, *_) = build(fluid)
                # lr 1e-3: the YOLOv3 head's loss of ~100 overshoots at 0.01
                fluid.optimizer.Momentum(1e-3, 0.9).minimize(loss)
            main.random_seed = startup.random_seed = 3
            init = fluid.Scope()
            fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
            names = sorted(v.name for v in main.list_vars() if v.persistable)
            state = {n: init.to_numpy(n).copy() for n in names}
            results = []
            for place, graphs in ((fluid.CUDAPlace(0), True), (fluid.CPUPlace(), False)):
                scope = fluid.Scope()
                fluid.io.load_numpy_params(scope, state, device=place.device)
                exe = fluid.Executor(place, _graphs=graphs)
                rng = np.random.RandomState(0)
                fetched = [exe.run(main, feed=make_feed(rng), fetch_list=[loss, out], scope=scope)
                           for _ in range(PARITY_STEPS)]
                results.append((fetched, {n: scope.to_numpy(n).copy() for n in names},
                                exe.last_plan.graph_refusal))
            (card_f, card_s, refusal), (cpu_f, cpu_s, _) = results
            # the output at the first run, from the one numpy state, within
            # DETECTION_OUT_TOL; the later runs' outputs come from states
            # that part by DETECTION_STATE_TOL, and are held by it
            hold = detection_cases.hold_close
            worst = hold(f"{name} output", cpu_f[0][1], card_f[0][1], DETECTION_OUT_TOL)
            for i, (g, c) in enumerate(zip(card_f, cpu_f)):
                worst = max(worst, hold(f"{name} step {i} loss", c[0], g[0],
                                        DETECTION_STATE_TOL, True))
                if i:
                    worst = max(worst, hold(f"{name} step {i} output", c[1], g[1],
                                            DETECTION_STATE_TOL, True))
            worst_state = max(hold(f"{name} {n}", cpu_s[n], card_s[n], DETECTION_STATE_TOL,
                                   True) for n in names)
            emit({"phase": "detection_parity", "model": name, "steps": PARITY_STEPS,
                  "losses_card": [float(np.asarray(f[0]).reshape(-1)[0]) for f in card_f],
                  "losses_cpu": [float(np.asarray(f[0]).reshape(-1)[0]) for f in cpu_f],
                  "worst_share_of_tol": worst, "worst_state_share_of_tol": worst_state,
                  "tol": DETECTION_STATE_TOL, "card_graph_refusal": refusal, "card": card})
        cases = detection_cases.DETECTION_CASES + detection_cases.NN_CASES
        worst = (0.0, "")
        for cid, op_type, inputs, attrs, slots, *_ in cases:
            outs = []
            for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
                prog, feed, fetch = detection_cases.build_one_op(fluid, op_type, inputs, attrs,
                                                                 slots)
                outs.append(fluid.Executor(place).run(prog, feed=feed, fetch_list=fetch,
                                                      scope=fluid.Scope()))
            for k, (g, w) in enumerate(zip(*outs)):
                worst = max(worst, (hold(f"one-op {cid} out {k}", w, g, DETECTION_OUT_TOL), cid))
        emit({"phase": "detection_parity", "one_op_cases": len(cases),
              "worst_share_of_tol": worst[0], "worst_case": worst[1], "tol": DETECTION_OUT_TOL})
        refused = {}
        from paddle_tpu_torch.ops.control_flow_ops import register_py_func

        def py_func_program():  # py_func's own attrs include out_dtypes: built by hand
            prog = fluid.Program()
            with fluid.program_guard(prog, fluid.Program()):
                block = prog.global_block()
                block.create_var("x", shape=(2, 3), dtype="float32", is_data=True)
                block.create_var("y", shape=(2, 3), dtype="float32")
                block.append_op("py_func", inputs={"X": ["x"]}, outputs={"Out": ["y"]},
                                attrs={"func_id": register_py_func(lambda a: a * 2),
                                       "out_shapes": [[2, 3]], "out_dtypes": ["float32"]})
            return prog, {"x": np.ones((2, 3), np.float32)}, ["y"]

        host_cases = {
            "print": lambda: detection_cases.build_one_op(
                fluid, "print", {"X": np.ones((2, 3), np.float32)},
                {"message": "x: ", "first_n": 1}, ["Out"]),
            "py_func": py_func_program,
            "detection_map": lambda: detection_cases.build_one_op(fluid, *next(
                c[1:] for c in detection_cases.DETECTION_CASES if c[1] == "detection_map"))}
        for op_type, build_program in host_cases.items():
            prog, feed, fetch = build_program()
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            fluid.monitor.reset()
            for _ in range(2):
                exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
            counted = fluid.monitor.get_monitor().counter("executor.graph_refused").value
            refused[op_type] = exe.last_plan.graph_refusal
            if refused[op_type] != _HOST_READ[op_type] or not counted:
                raise AssertionError(f"detection_parity: a plan with {op_type} was not refused a "
                                     f"graph with its reason: {refused[op_type]!r}, {counted}")
        fluid.monitor.reset()
        emit({"phase": "detection_parity", "graph_refusals": refused})
    finally:
        torch.backends.cudnn.deterministic = saved


# phase 49: the CRF tagger at the width of label_semantic_roles' emissions
# (a 128-wide token feature, 4 chunk types in IOB: 9 tags) on 64 ragged
# sentences of 10-40 tokens
TAGGER_CONFIG = dict(feature_dim=128, num_chunk_types=4)
TAGGER_BATCH, TAGGER_LENS = 64, (10, 40)


def tail_parity(fluid, torch, card):
    """Phase 48, card against CPU: every one-op case of
    models/tail_cases.py (the last op files, misc_ops and tail_ops) within
    DETECTION_OUT_TOL of max(1, |CPU|), index outputs equal; the random ops
    on the card by their moments (NCE's three samplers, sampled softmax's
    log-uniform draws, the batch-size-like fillers, sampling_id, random_crop);
    plans holding chunk_eval or merge_selected_rows refused a graph with
    their reason (executor._HOST_READ)."""
    import numpy as np
    from paddle_tpu_torch.core.executor import _HOST_READ

    from paddle_tpu_torch.models import detection_cases, tail_cases

    hold = detection_cases.hold_close
    cases = tail_cases.MISC_CASES + tail_cases.TAIL_CASES
    worst = (0.0, "")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for cid, op_type, inputs, attrs, slots, _ in cases:
            outs = []
            for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
                prog, feed, fetch = detection_cases.build_one_op(fluid, op_type, inputs, attrs,
                                                                 slots)
                outs.append(fluid.Executor(place).run(prog, feed=feed, fetch_list=fetch,
                                                      scope=fluid.Scope()))
            for k, (g, w) in enumerate(zip(*outs)):
                worst = max(worst, (hold(f"one-op {cid} out {k}", w, g, DETECTION_OUT_TOL), cid))
    finally:
        torch.backends.cudnn.deterministic = saved
    emit({"phase": "tail_parity", "one_op_cases": len(cases), "worst_share_of_tol": worst[0],
          "worst_case": worst[1], "tol": DETECTION_OUT_TOL, "card": card})

    def on_card_op(op_type, inputs, attrs, slots, exe=None, scope=None):
        prog, feed, fetch = detection_cases.build_one_op(fluid, op_type, inputs, attrs, slots)
        return [np.asarray(v) for v in (exe or fluid.Executor(fluid.CUDAPlace(0))).run(
            prog, feed=feed, fetch_list=fetch, scope=scope or fluid.Scope())]

    rng = np.random.RandomState(48)
    C, B, S = 8, 2000, 20
    probs = rng.dirichlet(np.ones(C)).astype(np.float32)
    k = np.arange(C)
    log_uniform = np.log((k + 2.0) / (k + 1.0)) / np.log(C + 1.0)
    moments = {}
    for sampler, want in ((0, np.full(C, 1.0 / C)), (1, log_uniform / log_uniform.sum()),
                          (2, probs)):
        inputs = {"Input": rng.randn(B, 4).astype(np.float32),
                  "Label": rng.randint(0, C, (B, 1)).astype(np.int64),
                  "Weight": rng.randn(C, 4).astype(np.float32)}
        if sampler == 2:
            inputs["CustomDistProbs"] = probs
        _, labels = on_card_op("nce", inputs, {"num_total_classes": C, "num_neg_samples": S,
                                               "sampler": sampler,
                                               "out_dtypes": {"SampleLabels": "int64"}},
                               ["Cost", "SampleLabels"])
        freq = np.bincount(labels[:, 1:].reshape(-1), minlength=C) / (B * S)
        se = np.sqrt(want * (1 - want) / (B * S))
        moments[f"nce_sampler_{sampler}_worst_se"] = float((np.abs(freq - want) / se).max())
        if not (np.abs(freq - want) <= 4 * se + 1e-3).all() or not np.array_equal(
                labels[:, 0], inputs["Label"][:, 0]):
            raise AssertionError(f"tail_parity: nce sampler {sampler} draws {freq}, not {want}")
    logits, samples = on_card_op("sample_logits", {
        "Logits": rng.randn(B, C).astype(np.float32),
        "Labels": rng.randint(0, C, (B, 1)).astype(np.int64)}, {"num_samples": S,
                                                                "out_dtypes": {"Samples": "int64"}},
        ["SampledLogits", "Samples"])
    freq = np.bincount(samples[:, 1:].reshape(-1), minlength=C) / (B * S)
    moments["sample_logits_worst_freq_err"] = float(np.abs(freq - log_uniform
                                                           / log_uniform.sum()).max())
    if not (moments["sample_logits_worst_freq_err"] < 0.01
            and (logits[:, 1:][samples[:, 1:] == samples[:, :1]] == -1e20).all()):
        raise AssertionError(f"tail_parity: sample_logits draws {freq}")
    ref = np.zeros((2000, 3), np.float32)
    for op_type, attrs, mean, std in (
            ("uniform_random_batch_size_like", {"min": -1.0, "max": 3.0}, 1.0,
             4.0 / math.sqrt(12.0)),
            ("gaussian_random_batch_size_like", {"mean": 1.0, "std": 2.0}, 1.0, 2.0)):
        (out,) = on_card_op(op_type, {"Input": ref}, dict(attrs, shape=[-1, 250]), ["Out"])
        moments[f"{op_type}_mean_std"] = [float(out.mean()), float(out.std())]
        if out.shape != (2000, 250) or abs(out.mean() - mean) > 0.01 * std or abs(
                out.std() - std) > 0.01 * std:
            raise AssertionError(f"tail_parity: {op_type} {moments[f'{op_type}_mean_std']}")
    (ids,) = on_card_op("sampling_id", {"X": np.tile(np.array([[0.1, 0.6, 0.3]], np.float32),
                                                     (20000, 1))}, {"out_dtype": "int32"}, ["Out"])
    freq = np.bincount(ids.reshape(-1), minlength=3) / 20000
    moments["sampling_id_freq"] = freq.tolist()
    if np.abs(freq - [0.1, 0.6, 0.3]).max() > 0.015:
        raise AssertionError(f"tail_parity: sampling_id draws {freq}")
    x = rng.randn(4, 3, 9, 9).astype(np.float32)
    exe, scope, starts = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope(), set()
    for _ in range(12):
        (out,) = on_card_op("random_crop", {"X": x}, {"shape": [3, 5, 4]}, ["Out"], exe, scope)
        hit = [(i, j) for i in range(5) for j in range(6)
               if np.array_equal(x[:, :, i:i + 5, j:j + 4], out)]
        if len(hit) != 1:
            raise AssertionError(f"tail_parity: random_crop's window is no window of x: {hit}")
        starts.add(hit[0])
    moments["random_crop_offsets_seen"] = len(starts)
    if len(starts) < 4:
        raise AssertionError(f"tail_parity: random_crop took {len(starts)} offsets in 12 runs")
    emit({"phase": "tail_parity", "moments": moments, "card": card})
    refused = {}
    host_cases = {
        "chunk_eval": next(c[1:5] for c in tail_cases.MISC_CASES if c[1] == "chunk_eval"),
        "merge_selected_rows": next(c[1:5] for c in tail_cases.TAIL_CASES
                                    if c[1] == "merge_selected_rows")}
    for op_type, case in host_cases.items():
        prog, feed, fetch = detection_cases.build_one_op(fluid, *case)
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        fluid.monitor.reset()
        for _ in range(2):
            exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        counted = fluid.monitor.get_monitor().counter("executor.graph_refused").value
        refused[op_type] = exe.last_plan.graph_refusal
        if refused[op_type] != _HOST_READ[op_type] or not counted:
            raise AssertionError(f"tail_parity: a plan with {op_type} was not refused a graph "
                                 f"with its reason: {refused[op_type]!r}, {counted}")
    fluid.monitor.reset()
    emit({"phase": "tail_parity", "graph_refusals": refused})


def tagger_batch(fluid, seed):
    """TAGGER_BATCH ragged sentences of TAGGER_LENS tokens, each token's
    feature holding its IOB tag (a 2.0 in the tag's channel), as LoDTensors."""
    import numpy as np

    rng = np.random.RandomState(seed)
    tags = 2 * TAGGER_CONFIG["num_chunk_types"] + 1
    rows, labels = [], []
    for n in rng.randint(TAGGER_LENS[0], TAGGER_LENS[1] + 1, TAGGER_BATCH):
        lab = rng.randint(0, tags, (n, 1)).astype(np.int64)
        row = (rng.randn(n, TAGGER_CONFIG["feature_dim"]) * 0.1).astype(np.float32)
        row[np.arange(n), lab[:, 0]] += 2.0
        rows.append(row)
        labels.append(lab)
    return {"x": fluid.LoDTensor(rows), "label": fluid.LoDTensor(labels)}


def tagger_train(fluid, torch, ck, card):
    """Phase 49: models.vision.build_crf_tagger (fc emissions, the CRF loss,
    Adam, the Viterbi path scored by chunk_eval) trains TRAIN_STEPS steps on
    one batch through Executor(CUDAPlace(0)).run: the plan is refused a
    graph with chunk_eval's reason and runs eagerly, every step launching
    exactly the program's kernels (Adam 3: the fc's weight and bias and the
    transitions); the loss falls and the chunk F1 rises.  Returns the
    launches counted."""
    from paddle_tpu_torch.core.executor import _HOST_READ
    from paddle_tpu_torch.models import vision

    with fluid.unique_name.guard():
        main, startup, _, fetches = vision.build_crf_tagger(**TAGGER_CONFIG)
    startup.random_seed = main.random_seed = 0
    loss = fetches["loss"].name
    per_step = launches_of_program(main, loss)
    if per_step != TAGGER_PER_STEP:
        raise AssertionError(f"tagger_train: the program's kernel ops {per_step} != the reckoned "
                             f"{TAGGER_PER_STEP}")
    feed = tagger_batch(fluid, 49)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.monitor.reset()
    launches = dict(NONE)
    ck.reset_launches()  # the main path's count starts here
    names = [loss] + [fetches[k].name for k in ("f1", "num_infer", "num_label", "num_correct")]
    losses, f1s, step_ms = [], [], []
    for step in range(TRAIN_STEPS):
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=names, scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        delta = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
        add_launches(launches, delta)
        hold_run_launches(exe, step, delta, per_step, "tagger_train")
        losses.append(float(out[0].reshape(-1)[0]))
        f1s.append(float(out[1].reshape(-1)[0]))
        emit({"phase": "tagger_train", "step": step, "loss": losses[-1], "f1": f1s[-1],
              "chunks_infer_label_correct": [int(o.reshape(-1)[0]) for o in out[2:]],
              "step_ms": step_ms[-1], "launches": delta, "card": card})
    read_monitor("tagger_train", monitor_want(range(TRAIN_STEPS), False, refused=1), card)
    refusal = exe.last_plan.graph_refusal
    record = {"phase": "tagger_train", "config": TAGGER_CONFIG, "sentences": TAGGER_BATCH,
              "losses": losses, "f1": f1s, "warm_step_ms": statistics.median(step_ms[2:]),
              "sentences_per_s": TAGGER_BATCH / statistics.median(step_ms[2:]) * 1e3,
              "graphed": exe.last_plan.graphed, "graph_refusal": refusal, "card": card}
    emit(record)
    if refusal != _HOST_READ["chunk_eval"] or exe.last_plan.graphed:
        raise AssertionError(f"tagger_train: the plan was not refused a graph for chunk_eval: "
                             f"{refusal!r}")
    if not (losses[-1] < losses[0] and f1s[-1] > f1s[0]):
        raise AssertionError(f"tagger_train: loss {losses} or F1 {f1s} did not improve")
    return launches


# phases 52-55: float16 with contrib.mixed_precision's dynamic loss scaling.
# The decorator's state, and its defaults (scale 2^15, growth after 1000
# finite steps, halving after 2 overflows)
AMP_VARS = ("loss_scaling_0", "good_steps_0", "bad_steps_0")
AMP_DEFAULTS = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=1000,
                    decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5)
# phase 53: a scale no float16 gradient of the first steps survives (the
# cross-entropy backward's cotangent is 2^32 / 4096 rows = 2^20 times 1 - p,
# past 65504), halved at every overflow, until AMP_APPLIED steps have
# applied (at most AMP_MAX_STEPS steps)
AMP_OVERFLOW = dict(AMP_DEFAULTS, init_loss_scaling=2.0 ** 32, decr_every_n_nan_or_inf=1)
AMP_APPLIED = 3
AMP_MAX_STEPS = 40
# phase 55: the scope's scale before each step (the second overflows, the
# third is set back); BERT at 2 x 128 tokens, two sequences a step: the
# card's host multiplies float16 matrices on its CPU at a few GFLOP/s
# (three steps at 8 x 128 took 298 s on the host of an NVIDIA H100 80GB
# HBM3), so the batch is cut to the least that holds more than one
# sequence, and the encoder to one layer (two before phases 69-72 came)
AMP_PARITY_BATCH = 2
AMP_PARITY_LAYERS = 1
AMP_PARITY_SCALES = {1: 2.0 ** 40, 2: 2.0 ** 15}
# phase 55's BERT rules, float16's forms of phase 7's.  The card (cuBLAS,
# the float16 kernels) and the CPU round each float16 activation once,
# after sums taken in other orders: the two sides' activations part by
# float16 steps (2^-11, 2^13 times float32's 2^-24), compounded over the
# layers.  The losses within 1e-2 * max(1, |loss|); Adam's steps are
# lr-sized whatever the gradient's size, so each parameter within 2 lr per
# applied step + 1e-5, and the update of all parameters within 10% of the
# CPU's in L2 (tests/test_torch_training.py's bfloat16 rule); the moments
# within 5e-2 of the largest of their kind; the beta pows and the AMP vars
# exactly
AMP_BERT_PARITY = {"loss": 1e-2, "update_l2": 0.1, "moment": 5e-2}
# phase 55's ResNet-50.  The CPU's float16 convolution backward is orders of
# magnitude slower than its float32 one (three steps at 224 x 224 took
# minutes), so the parity runs at phase 35's 64 x 64 (the last stage 2 x
# 2), batch 8; the decorator's 2^15 overflows every step there on both
# sides (the weight gradients pass 65504), as it does at 224 x 224, so it
# starts from 2^10, where the steps apply
AMP_RESNET_PARITY = {"size": 64, "scale": 2.0 ** 10}
AMP_RESNET_STEPS = 3  # the controls run from AMP_RESNET_CONTROLS_FROM on (the host's float16 sets the time)
# Batch statistics make ResNet-50's gradients at initialization
# ill-conditioned (phase 11), and float16 rounds each activation 2^13 times
# coarser than float32: float16's step itself, on either side, lies O(1)
# of the step away from float32's at the first steps, the port's CPU as
# much as the card (amp_resnet_parity prints it each step), shrinking as
# the weights leave their initialization.  So each side is held against
# the float32 step from the same state (the same program built in float32,
# on the CPU): for the velocities, the parameter updates and the running
# statistics, each kind summed in L2 over all its tensors, the card's
# float16 error may be at most AMP_RESNET_RATIO times the CPU's float16
# error.  Two float16 implementations that round alike score ~1; the loss
# within 1e-2 * max(1, |loss|) of the CPU's float16 loss, the AMP vars
# exactly.  From step AMP_RESNET_CONTROLS_FROM on, where float16's own
# error has fallen below a third of the update, the phase also takes each
# step on the card with half the batch and with half the momentum, and
# scores a frozen step: the rule must refuse each
AMP_RESNET_RATIO = 1.25
AMP_RESNET_LOSS = 1e-2
AMP_RESNET_CONTROLS_FROM = 2


def build_amp_bert(fluid, n_layers, dropout_prob, seq_len=128, amp=AMP_DEFAULTS):
    """BERT-base at full width (vocab 30522, d 768, 12 heads, d_ff 3072) of
    `n_layers` layers in float16 with fused attention, built by
    build_bert(dtype="float16", with_optimizer=False) and trained by
    contrib.mixed_precision.decorate(Adam(LR), **amp), through the two
    fusion passes; returns (main, startup, loss name, found_inf name)."""
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.models import transformer

    with fluid.unique_name.guard():
        main, startup, _, fetches = transformer.build_bert(
            vocab_size=30522, seq_len=seq_len, d_model=768, n_layers=n_layers, n_heads=12,
            d_ff=3072, dtype="float16", dropout_prob=dropout_prob, use_fused_attention=True,
            with_optimizer=False)
        with fluid.program_guard(main, startup):
            opt = decorate(fluid.optimizer.Adam(LR), **amp)
            opt.minimize(fetches["loss"])
    startup.random_seed = 0
    main.random_seed = 0
    loss, found = fetches["loss"].name, opt._found_inf.name
    for p in ("fuse_ln_residual", "fuse_bias_act"):
        fluid.passes.apply_pass(main, p, keep=[loss, found])
    return main, startup, loss, found


def bert_f16_amp(fluid, torch, ck, card):
    """Phase 52: BERT-base float16 (12 layers, fused attention, dropout 0.1)
    under decorate(Adam(1e-4)) at the decorator's defaults, TRAIN_STEPS
    steps on one batch of 32 x 128, eager then graphed (train_arm: warm
    step, tokens a second, idle share of a profiled step, peak memory, and
    the loss and the scale each step): FUSED_PER_STEP's launches every step
    (the LayerNorms, bias+GELU, attention and the loss's kernels in their
    float16 instantiations, the embedding's LayerNorm before the cast in
    float32, Adam on the float32 master weights), the graph captured with
    no refusal, the loss falling."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    t0 = time.perf_counter()
    main, startup, loss, _ = build_amp_bert(fluid, 12, 0.1)
    derived = launches_of_program(main, loss)
    if derived != FUSED_PER_STEP:
        raise AssertionError(f"the program's kernel ops {derived} != the reckoned {FUSED_PER_STEP}")
    feed = make_fake_batch(32, 128, 30522, rng=np.random.RandomState(0))
    emit({"phase": "bert_f16_amp", "model": "bert-base f16, fused attention, dropout 0.1, "
          "decorate(Adam lr 1e-4) at the decorator's defaults", "batch": 32, "seq_len": 128,
          "ops": len(main.global_block().ops), "setup_s": time.perf_counter() - t0})
    launches = dict(NONE)
    ck.reset_launches()  # the main path's count starts here
    for arm in ("eager", "graphed"):
        losses, scope, rec = train_arm(fluid, torch, ck, card, "bert_f16_amp", arm, main, startup,
                                       loss, feed, FUSED_PER_STEP, launches,
                                       {"sequences": 32, "tokens": 32 * 128}, watch=AMP_VARS)
        ARM_RECORDS.setdefault("bert_f16_amp", []).append(rec)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"bert_f16_amp {arm}: the loss did not fall: {losses}")
        if arm == "graphed" and rec["graph_refusal"] is not None:
            raise AssertionError(f"bert_f16_amp: the plan was refused a graph: "
                                 f"{rec['graph_refusal']}")
        del scope
    return launches


def loss_scaling_after(state, found):
    """update_loss_scaling's state machine (paddle_tpu/ops/optimizer_ops.py)
    on the host: (scale, good, bad) after a step whose overflow flag is
    `found`, under AMP_OVERFLOW's settings."""
    scale, good, bad = state
    good, bad = (0, bad + 1) if found else (good + 1, 0)
    if good >= AMP_OVERFLOW["incr_every_n_steps"]:
        grown = scale * AMP_OVERFLOW["incr_ratio"]
        scale, good = (grown if math.isfinite(grown) else scale), 0
    if bad >= AMP_OVERFLOW["decr_every_n_nan_or_inf"]:
        scale, bad = max(scale * AMP_OVERFLOW["decr_ratio"], 1.0), 0
    return scale, good, bad


def bert_f16_overflow(fluid, torch, ck, card):
    """Phase 53: phase 52's BERT from a loss scale of 2^32, halved at every
    overflow (AMP_OVERFLOW), graphed, until AMP_APPLIED steps have applied.
    Each step's overflow flag is fetched; on a skipped step every parameter,
    moment and beta pow is bit for bit what it was before the step; on an
    applied one some moved; after every step the scale and the two counters
    are update_loss_scaling's state machine's (loss_scaling_after) exactly;
    every run's launches FUSED_PER_STEP (the kernels run whatever the flag).
    Returns the launches."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    main, startup, loss, found = build_amp_bert(fluid, 12, 0.1, amp=AMP_OVERFLOW)
    derived = launches_of_program(main, loss)
    if derived != FUSED_PER_STEP:
        raise AssertionError(f"the program's kernel ops {derived} != the reckoned {FUSED_PER_STEP}")
    feed = make_fake_batch(32, 128, 30522, rng=np.random.RandomState(0))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable and v.name not in AMP_VARS)
    state = (AMP_OVERFLOW["init_loss_scaling"], 0, 0)
    launches = dict(NONE)
    ck.reset_launches()
    skipped = applied = 0
    for step in range(AMP_MAX_STEPS):
        before = {n: scope.find_var(n).clone() for n in names}
        counted = dict(ck.LAUNCHES)
        out = exe.run(main, feed=feed, fetch_list=[loss, found], scope=scope,
                      return_numpy=False)
        torch.cuda.synchronize()
        delta = {k: ck.LAUNCHES[k] - counted[k] for k in ck.LAUNCHES}
        add_launches(launches, delta)
        hold_run_launches(exe, step, delta, FUSED_PER_STEP, "bert_f16_overflow",
                          "bert_f16_overflow")
        flag = bool(out[1].reshape(-1)[0])
        state = loss_scaling_after(state, flag)
        got = (float(scope.find_var("loss_scaling_0").reshape(-1)[0]),
               int(scope.find_var("good_steps_0").reshape(-1)[0]),
               int(scope.find_var("bad_steps_0").reshape(-1)[0]))
        moved = [n for n in names if not torch.equal(scope.find_var(n), before[n])]
        emit({"phase": "bert_f16_overflow", "step": step, "found_inf": flag,
              "loss": float(out[0].reshape(-1)[0]), "loss_scaling": got[0], "good_steps": got[1],
              "bad_steps": got[2], "state_machine": list(state), "persistables_moved": len(moved),
              "card": card})
        if got != state:
            raise AssertionError(f"bert_f16_overflow step {step}: (scale, good, bad) {got} != "
                                 f"update_loss_scaling's {state}")
        if flag and moved:
            raise AssertionError(f"bert_f16_overflow step {step}: a skipped step moved {moved[:4]}")
        if not flag and not moved:
            raise AssertionError(f"bert_f16_overflow step {step}: an applied step moved nothing")
        skipped += flag
        applied += not flag
        del before
        if applied >= AMP_APPLIED:
            break
    emit({"phase": "bert_f16_overflow", "steps": step + 1, "skipped_steps": skipped,
          "applied_steps": applied, "persistables_held": len(names),
          "graph_refusal": exe.last_plan.graph_refusal, "card": card})
    if not (skipped >= 1 and applied >= AMP_APPLIED):
        raise AssertionError(f"bert_f16_overflow: {skipped} skipped, {applied} applied in "
                             f"{AMP_MAX_STEPS} steps")
    if exe.last_plan.graph_refusal is not None:
        raise AssertionError(f"bert_f16_overflow: refused a graph: {exe.last_plan.graph_refusal}")
    return launches


def amp_bert_arm(fluid, arm, place, main, loss, found, names, state, feed):
    """One arm of phase 55's BERT: PARITY_STEPS steps at `place` from the
    numpy `state`, the scope's scale set before a step as AMP_PARITY_SCALES
    says; a skipped step must leave every persistable but the AMP vars bit
    for bit.  Returns (losses, flags, AMP vars a step, final state)."""
    import numpy as np

    scope = fluid.Scope()
    fluid.io.load_numpy_params(scope, state, device=place.device)
    exe = fluid.Executor(place)
    losses, flags, amp_vars = [], [], []
    for step in range(PARITY_STEPS):
        if step in AMP_PARITY_SCALES:  # in place: a captured graph keeps its pointers
            scope.find_var("loss_scaling_0").fill_(AMP_PARITY_SCALES[step])
        before = {n: scope.to_numpy(n).copy() for n in names}
        out = exe.run(main, feed=feed, fetch_list=[loss, found], scope=scope)
        losses.append(float(out[0].reshape(-1)[0]))
        flags.append(bool(out[1].reshape(-1)[0]))
        amp_vars.append({n: scope.to_numpy(n).copy() for n in AMP_VARS})
        if flags[-1]:
            moved = [n for n in names if n not in AMP_VARS
                     and not np.array_equal(scope.to_numpy(n), before[n])]
            if moved:
                raise AssertionError(f"amp_bert_parity {arm} step {step}: the skipped step "
                                     f"moved {moved[:4]}")
    return losses, flags, amp_vars, {n: scope.to_numpy(n).copy() for n in names}


def amp_bert_setup(fluid):
    """Phase 55's BERT program, numpy state (the LayerNorm gains 1, as
    phase 7) and feed: (main, loss, found, names, state, feed)."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    main, startup, loss, found = build_amp_bert(fluid, AMP_PARITY_LAYERS, 0.0)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    state = {n: init.to_numpy(n).copy() for n in names}
    for n in state:
        if n.endswith(("emb_ln.w", ".ln1.w", ".ln2.w")):
            state[n] = np.ones_like(state[n])
    feed = make_fake_batch(AMP_PARITY_BATCH, 128, 30522, rng=np.random.RandomState(1))
    return main, loss, found, names, state, feed


def start_cpu_arms(lanes):
    """Run each lane of `lanes` (a list of (name, fn) jobs) on a thread of
    its own, its jobs in turn, and keep what fn returns under its name.
    The CPU arms of phases 7, 11, 14, 18, 25 and 55 need no kernel and take
    a minute and more on the card's host (its float16 products above all),
    so main() starts them before the kernels' build and joins them after
    phase 3, whose device times CUDA events take behind a backed-up stream.
    Program builds set process-wide defaults, so a job builds only under
    ARMS_BUILD_LOCK.  Returns the handle join_cpu_arms takes."""
    handle = {"results": {}, "seconds": {}, "threads": [], "lanes": lanes}

    def run(jobs):
        for name, fn in jobs:
            t0 = time.perf_counter()
            try:
                handle["results"][name] = fn()
            except BaseException as e:  # raised again by join_cpu_arms
                handle.setdefault("error", e)
                return
            finally:
                handle["seconds"][name] = time.perf_counter() - t0

    for i, jobs in enumerate(lanes):
        t = threading.Thread(target=run, args=(jobs,), name=f"cpu_arms{i}", daemon=True)
        handle["threads"].append(t)
        t.start()
    return handle


def join_cpu_arms(handle):
    """Wait for the threads of start_cpu_arms; raise what a job raised."""
    for t in handle["threads"]:
        t.join()
    if "error" in handle:
        raise handle["error"]
    return handle


def amp_bert_parity(fluid, torch, setup=None, cpu=None):
    """Phase 55, BERT: AMP_PARITY_LAYERS of phase 52's model (dropout 0) at
    AMP_PARITY_BATCH x 128, PARITY_STEPS steps on the card (graphed) and on
    the CPU from one numpy state (`setup`, amp_bert_setup's; `cpu`, the CPU
    arm's amp_bert_arm, where start_cpu_arms ran it); the second step
    overflows on both sides and leaves every other persistable bit for
    bit; the AMP vars and the flags equal exactly, the losses, parameters
    and moments by AMP_BERT_PARITY."""
    import numpy as np

    setup = setup or amp_bert_setup(fluid)
    main, _, _, names, state, _ = setup
    runs = {"card": amp_bert_arm(fluid, "card", fluid.CUDAPlace(0), *setup),
            "cpu": cpu or amp_bert_arm(fluid, "cpu", fluid.CPUPlace(), *setup)}
    (gl, gf, ga, gs), (cl, cf, ca_, cs) = runs["card"], runs["cpu"]
    want_flags = [step in AMP_PARITY_SCALES and AMP_PARITY_SCALES[step] > 2.0 ** 30
                  for step in range(PARITY_STEPS)]
    dloss = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(gl, cl))
    applied = PARITY_STEPS - sum(want_flags)
    flip_tol = 2 * LR * applied + 1e-5
    params = {p.name for p in main.all_parameters()}
    sq_diff = sq_update = worst_flip = 0.0
    for n in params:
        got, want = gs[n].astype(np.float64), cs[n].astype(np.float64)
        worst_flip = max(worst_flip, float(np.abs(got - want).max()))
        sq_diff += float(np.sum((got - want) ** 2))
        sq_update += float(np.sum((want - state[n]) ** 2))
    update_share = math.sqrt(sq_diff / max(sq_update, 1e-30))
    moments = {}
    for kind in ("moment1", "moment2"):
        kn = [n for n in names if n.endswith(f"_{kind}_0")]
        peak = max(float(np.abs(cs[n]).max()) for n in kn)
        moments[kind] = (max(float(np.abs(gs[n] - cs[n]).max()) for n in kn),
                         AMP_BERT_PARITY["moment"] * peak)
    pows = [n for n in names if "beta" in n and "pow" in n]
    emit({"phase": "amp_bert_parity", "model": f"bert-base f16, {AMP_PARITY_LAYERS} layer(s), "
          "fused attention, dropout 0, decorate(Adam lr 1e-4)", "batch": AMP_PARITY_BATCH, "seq_len": 128,
          "losses_card": gl, "losses_cpu": cl, "found_inf_card": gf, "found_inf_cpu": cf,
          "max_rel_dloss": dloss, "max_abs_dparam": worst_flip, "param_tol": flip_tol,
          "update_l2_share": update_share,
          "max_abs_dmoment": {k: w for k, (w, _) in moments.items()},
          "moment_tol": {k: t for k, (_, t) in moments.items()},
          "rules": AMP_BERT_PARITY})
    if not (gf == cf == want_flags):
        raise AssertionError(f"amp_bert_parity: overflow flags card {gf}, cpu {cf}, "
                             f"want {want_flags}")
    for step, (a, b) in enumerate(zip(ga, ca_)):
        for n in AMP_VARS:
            if not (a[n].dtype == b[n].dtype and np.array_equal(a[n], b[n])):
                raise AssertionError(f"amp_bert_parity step {step}: {n} card {a[n]} cpu {b[n]}")
    for n in pows:
        if not np.array_equal(gs[n], cs[n]):
            raise AssertionError(f"amp_bert_parity: {n} card {gs[n]} cpu {cs[n]}")
    if not dloss <= AMP_BERT_PARITY["loss"]:
        raise AssertionError(f"amp_bert_parity: losses card {gl} cpu {cl}")
    if not (worst_flip <= flip_tol and update_share <= AMP_BERT_PARITY["update_l2"]):
        raise AssertionError(f"amp_bert_parity: parameters differ by {worst_flip} (> {flip_tol}?) "
                             f"or the update by {update_share} of the CPU's in L2")
    for kind, (worst, tol) in moments.items():
        if not worst <= tol:
            raise AssertionError(f"amp_bert_parity: {kind} differs by {worst} > {tol}")


def amp_float32_errors(after, truth, before, stats, params):
    """For the velocities, the parameter updates and the running statistics
    of one step: the L2 distance of `after` from the float32 step `truth`
    over all tensors of the kind, as a share of the float32 step's own
    (the velocities, the update truth - before, the statistics' move)."""
    import numpy as np

    sums = {"velocity": [0.0, 0.0], "update": [0.0, 0.0], "stat": [0.0, 0.0]}
    for n, want in truth.items():
        if n in stats:
            kind, base = "stat", want.astype(np.float64) - before[n]
        elif n.endswith("_velocity_0"):
            kind, base = "velocity", want.astype(np.float64)
        elif n in params:
            kind, base = "update", want.astype(np.float64) - before[n]
        else:
            continue
        sums[kind][0] += float(np.sum((after[n].astype(np.float64) - want) ** 2))
        sums[kind][1] += float(np.sum(base ** 2))
    return {k: math.sqrt(d / max(b, 1e-30)) for k, (d, b) in sums.items()}


def amp_resnet_take(fluid, exe, progs, names, key, state, device, batch):
    """One step of phase 55's program `key` from the numpy `state` on
    `device`: (the persistables after it, the loss, the overflow flag)."""
    import numpy as np

    prog, _, fetches = progs[key]
    state = {n: a.astype(np.float32) if key == "float32" and a.dtype == np.float16
             else np.array(a, copy=True) for n, a in state.items()}
    scope = fluid.Scope()
    fluid.io.load_numpy_params(scope, state, device=device)
    out = exe.run(prog, feed=batch, fetch_list=[fetches["loss"].name,
                                                fetches["found_inf"].name], scope=scope)
    return ({n: scope.to_numpy(n).copy() for n in names}, float(out[0].reshape(-1)[0]),
            bool(out[1].reshape(-1)[0]))


def amp_resnet_cpu(fluid):
    """Phase 55's ResNet programs and its CPU side (start_cpu_arms runs it):
    AMP_RESNET_STEPS float16 steps on the CPU, and before each its state and
    the same step in float32 on the CPU.  Returns (progs, names, stats,
    params, feed, [(state, cpu float16 step, cpu float32 step)] a step)."""
    import numpy as np

    size, lr = AMP_RESNET_PARITY["size"], RESNET_PARITY_LR
    amp = dict(AMP_DEFAULTS, init_loss_scaling=AMP_RESNET_PARITY["scale"])
    with ARMS_BUILD_LOCK:
        progs = {key: build_resnet(fluid, dtype, True, lr, amp=amp, size=size, momentum=mu)
                 for key, dtype, mu in (("float16", "float16", 0.9), ("float32", "float32", 0.9),
                                        ("half_momentum", "float16", 0.45))}
    main, startup, fetches = progs["float16"]
    fetch = [fetches["loss"].name, fetches["found_inf"].name]
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu = fluid.Scope()
    cpu_exe.run(startup, scope=cpu)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    stats = {op.input(s)[0] for op in bn_ops(main) for s in ("Mean", "Variance")}
    params = {p.name for p in main.all_parameters() if p.trainable}
    feed = images(8, 60, size)
    steps = []
    for _ in range(AMP_RESNET_STEPS):
        state = {n: cpu.to_numpy(n).copy() for n in names}
        out = cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=cpu)
        host = ({n: cpu.to_numpy(n).copy() for n in names}, float(out[0].reshape(-1)[0]),
                bool(out[1].reshape(-1)[0]))
        truth = amp_resnet_take(fluid, cpu_exe, progs, names, "float32", state, "cpu", feed)
        steps.append((state, host, truth))
    return progs, names, stats, params, feed, steps


def amp_resnet_parity(fluid, torch, cpu=None):
    """Phase 55, ResNet-50: float16 under decorate(Momentum(RESNET_PARITY_LR,
    0.9)) from AMP_RESNET_PARITY's scale at its image size, batch 8,
    AMP_RESNET_STEPS steps on the CPU, each also taken in float32 on the
    CPU from the same state (the program built in float32, the state cast)
    (amp_resnet_cpu; `cpu`, where start_cpu_arms ran it); the CPU's state
    before each step is loaded on the card, which takes the same step.
    Every step applies on all sides, the AMP vars equal exactly, the
    losses within AMP_RESNET_LOSS, and the card's float16 error from the
    float32 step at most AMP_RESNET_RATIO times the CPU's
    (amp_float32_errors); from AMP_RESNET_CONTROLS_FROM on, the card's step
    with half the batch, with momentum 0.45, and a frozen step must each
    break that rule."""
    import numpy as np

    progs, names, stats, params, feed, steps = cpu or amp_resnet_cpu(fluid)
    size, lr = AMP_RESNET_PARITY["size"], RESNET_PARITY_LR
    gpu_exe = fluid.Executor(fluid.CUDAPlace(0))
    half = {k: v[:4] for k, v in feed.items()}

    def take(key, state, batch):
        return amp_resnet_take(fluid, gpu_exe, progs, names, key, state, "cuda:0", batch)

    ratio = AMP_RESNET_RATIO
    worst = {"loss": 0.0, "ratio": (0.0, "", -1)}
    records = []
    for step, (state, host, truth) in enumerate(steps):
        card = take("float16", state, feed)
        if card[2] or host[2] or truth[2]:
            raise AssertionError(f"amp_resnet_parity step {step}: an overflow (card {card[2]}, "
                                 f"cpu {host[2]}, cpu float32 {truth[2]}): nothing to compare")
        for n in AMP_VARS:
            if not np.array_equal(card[0][n], host[0][n]):
                raise AssertionError(f"amp_resnet_parity step {step}: {n} card {card[0][n]} "
                                     f"cpu {host[0][n]}")
        worst["loss"] = max(worst["loss"], abs(card[1] - host[1]) / max(1.0, abs(host[1])))
        err = {"cpu": amp_float32_errors(host[0], truth[0], state, stats, params),
               "card": amp_float32_errors(card[0], truth[0], state, stats, params)}
        if step >= AMP_RESNET_CONTROLS_FROM:
            err["half_batch"] = amp_float32_errors(take("float16", state, half)[0], truth[0],
                                                   state, stats, params)
            err["half_momentum"] = amp_float32_errors(
                take("half_momentum", state, feed)[0], truth[0], state, stats, params)
            err["frozen"] = amp_float32_errors(state, truth[0], state, stats, params)
        ratios = {run: {k: e[k] / max(err["cpu"][k], 1e-30) for k in e}
                  for run, e in err.items() if run != "cpu"}
        for k, r in ratios["card"].items():
            worst["ratio"] = max(worst["ratio"], (r, k, step))
        records.append({"step": step, "losses_card_cpu_cpu_float32": [card[1], host[1], truth[1]],
                        "cpu_float16_error": err["cpu"], "ratio_to_cpu": ratios})
    admitted = [(rec["step"], run) for rec in records for run, r in rec["ratio_to_cpu"].items()
                if run != "card" and max(r.values()) <= ratio]
    emit({"phase": "amp_resnet_parity", "model": f"resnet-50 f16, batch 8, {size} x {size}, "
          f"decorate(Momentum lr {lr}) from scale {AMP_RESNET_PARITY['scale']}", "steps": records,
          "worst_loss_share": worst["loss"], "worst_card_ratio": worst["ratio"],
          "controls_admitted": admitted,
          "rules": {"loss": AMP_RESNET_LOSS, "ratio": ratio,
                    "controls_from": AMP_RESNET_CONTROLS_FROM}})
    losses = [rec["losses_card_cpu_cpu_float32"][1] for rec in records]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"amp_resnet_parity: the CPU's losses are not finite or did not "
                             f"fall: {losses}")
    if not worst["loss"] <= AMP_RESNET_LOSS:
        raise AssertionError(f"amp_resnet_parity: card vs CPU losses differ by {worst['loss']}")
    if not worst["ratio"][0] <= ratio:
        raise AssertionError(f"amp_resnet_parity: the card's float16 {worst['ratio'][1]} error "
                             f"at step {worst['ratio'][2]} is {worst['ratio'][0]} times the "
                             f"CPU's > {ratio}")
    if admitted:
        raise AssertionError(f"amp_resnet_parity: the rule admits the controls {admitted}: it "
                             f"cannot tell them from rounding")


SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_WORKERS = 2
SERVE_CLIENTS = 4
SERVE_REQUESTS = 400
SERVE_TOL = 5e-2  # phase 4's bf16 rule
ADMISSION_QUEUE = 8
ADMISSION_BURST = 64
ADMISSION_DEADLINED = 3  # of the admitted requests, these carry a deadline that lapses queued
PUBLISH_POOL = 16  # distinct requests the clients cycle through in phase 58
PUBLISH_MIN_REQUESTS = 200
# phase 58's fine-tuning rate, 10x LR: two Adam steps at LR moved the
# served hidden states of some requests by only 0.065 at most (on an H100)
PUBLISH_LR = 1e-3
BUDGET_BUCKETS = (1, 8, 32)
# phase 59: after the eviction the allocator's bytes lie within this many of
# what the surviving model held alone, and after an unload within it of
# what was allocated before the load.  The caching allocator hands out
# blocks of 2 MiB and up, and cuBLAS / cuDNN workspaces come and go in such
# blocks (2 MiB and 1.75 MiB seen after the eviction on an H100): 2 MiB and
# one more block.  That the evicted model's plans are gone is checked
# exactly besides (no plan of its scope, its weights unreachable)
BUDGET_MARGIN_BYTES = 4 << 20
SERVING_PARITY_REQUESTS = 12
SERVING_PARITY_QUEUE = 10
SERVING_PARITY_TOL = 1e-3  # phase 5's rule
QUANT_DRIFT = 37.0  # the JAX package's drifted-scales case (tests/test_serving.py:525-546)
QAT_STEPS = 4
QAT_SERVE_BATCH = 32


def save_encoder(fluid, torch, dirname, dtype, n_layers, unit_ln_scale=False, seed=0):
    """BERT-base (build_bert) saved for inference with the encoder's last
    hidden states [batch, 128, 768] as its output (the masked-LM head's
    projection pruned): what a sentence-encoding server returns, and a
    per-row output a serving batch splits back by request.  Returns the
    output's name."""
    main, startup, _ = build_bert(fluid, dtype, n_layers)
    head = next(op for op in main.global_block().ops if "bert.lm_head.w" in op.input_arg_names)
    hidden = next(n for n in head.input_arg_names if n != "bert.lm_head.w")
    startup.random_seed = seed
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if unit_ln_scale:
        for p in main.all_parameters():
            if p.name.endswith(("emb_ln.w", ".ln1.w", ".ln2.w")):
                scope.set_var(p.name, torch.ones_like(scope.find_var(p.name)))
    fluid.io.save_inference_model(dirname, ["ids", "pos_ids"], [hidden], exe, main, scope)
    return hidden


def bert_request(rows, rng):
    from paddle_tpu_torch.models.transformer import make_fake_batch

    full = make_fake_batch(rows, 128, 30522, rng=rng)
    return {"ids": full["ids"], "pos_ids": full["pos_ids"]}


def bucket_plans(registry, version):
    """The executor's cached plans of a version's scope."""
    return [p for k, p in registry.executor._cache.items() if k[4] == version.scope._uuid]


def eager_predictor(fluid, model_dir):
    config = fluid.inference.AnalysisConfig(model_dir)
    config._graphs = False
    return fluid.inference.create_predictor(config)


def max_diff(a, b):
    import numpy as np

    return float(np.abs(np.asarray(a).astype(np.float32) - np.asarray(b).astype(np.float32)).max())


def l2_diff(a, b):
    import numpy as np

    return float(np.linalg.norm(np.asarray(a).astype(np.float32)
                                - np.asarray(b).astype(np.float32)))


def pct(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values), q)) if values else 0.0


def counters_of(fluid, *names):
    return {n: fluid.monitor.counter(n).value for n in names}


def run_clients(srv, model, requests, clients, stop=None, min_each=0):
    """`clients` threads submitting `requests` (a list of feeds) through
    srv.infer, client c taking c, c + clients, ... in turn; with `stop` (an
    Event), each cycles through its share until it is set and it has made
    `min_each` requests.  Returns [(request index, output, t_submit, t_done
    | exception)] in completion order."""
    import threading

    done, lock = [], threading.Lock()

    def client(c):
        mine = list(range(c, len(requests), clients))
        n = 0
        while True:
            i = mine[n % len(mine)]
            t0 = time.perf_counter()
            try:
                (out,) = srv.infer(model, requests[i])
                rec = (i, out, t0, time.perf_counter())
            except Exception as e:  # noqa: BLE001 - held by the caller
                rec = (i, e, t0, time.perf_counter())
            with lock:
                done.append(rec)
            n += 1
            if stop is None:
                if n == len(mine):
                    return
            elif stop.is_set() and n >= min_each:
                return

    # daemon threads: a phase that fails before it sets `stop` must not keep
    # the process alive, its clients appending failures for ever
    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    for t in threads:
        t.start()
    return threads, done


def hold_ledger(what, srv, **want):
    led = srv.ledger()
    if not led["balanced"] or any(led[k] != v for k, v in want.items()):
        raise AssertionError(f"{what}: ledger {led}, want {want} and balanced")
    return led


def serving_bert(fluid, torch, ck, tmp, card):
    """Phase 56: BERT-base bf16 at full width (12 layers, fused attention,
    seq 128; the encoder's hidden states served) loaded into
    serving.ModelRegistry(CUDAPlace(0)) under Server(buckets=SERVE_BUCKETS,
    workers=SERVE_WORKERS) and warmed: each bucket's plan graphed; then
    SERVE_CLIENTS client threads submit SERVE_REQUESTS requests of seeded
    1-32 rows.  Every response equals a direct eager Predictor.run of that
    request alone within SERVE_TOL; executor.graph_capture and
    executor.cache_miss do not move under the traffic; the ledger balances
    with no shed and no error; a profiled replay shows 25 LN, 12 bias-act
    and 12 attention kernels.  Returns (server, model dir, launches,
    traffic record)."""
    import numpy as np

    serving = fluid.serving
    model_dir = os.path.join(tmp, "bert_base_bf16_encoder")
    t0 = time.perf_counter()
    save_encoder(fluid, torch, model_dir, "bfloat16", 12)
    save_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    before_mem = torch.cuda.memory_allocated()
    registry = serving.ModelRegistry(place=fluid.CUDAPlace(0))
    srv = serving.Server(registry, buckets=SERVE_BUCKETS, workers=SERVE_WORKERS)
    ck.reset_launches()  # the main path's count starts here
    t0 = time.perf_counter()
    version = srv.load_model("bert", model_dir, warm=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    captures0 = fluid.monitor.counter("executor.graph_capture").value
    t0 = time.perf_counter()
    registry.warm("bert", srv.buckets)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    plans = bucket_plans(registry, version)
    graphed = sorted(p.graphed for p in plans)
    warm_launches = dict(ck.LAUNCHES)
    want_warm = {k: 2 * len(SERVE_BUCKETS) * v for k, v in PER_REQUEST.items()}
    emit({"phase": "serving_bert", "model": "bert-base bf16 encoder, fused attention",
          "save_s": save_s, "load_s": load_s, "warm_s": warm_s,
          "captures": fluid.monitor.counter("executor.graph_capture").value - captures0,
          "plans": len(plans), "graphed": graphed, "warm_launches": warm_launches,
          "weights_bytes": version.bytes,
          "allocated_delta_gb": (torch.cuda.memory_allocated() - before_mem) / 1e9, "card": card})
    if len(plans) != len(SERVE_BUCKETS) or not all(graphed):
        raise AssertionError(f"serving_bert: after the warm {len(plans)} plans, graphed {graphed}")
    if warm_launches != want_warm:
        raise AssertionError(f"serving_bert: the warm launched {warm_launches} != {want_warm} "
                             "(a warm-up and a capture a bucket)")
    rng = np.random.RandomState(56)
    rows = rng.randint(1, 33, SERVE_REQUESTS)
    requests = [bert_request(int(r), rng) for r in rows]
    before = counters_of(fluid, "executor.graph_capture", "executor.cache_miss")
    t0 = time.perf_counter()
    threads, done = run_clients(srv, "bert", requests, SERVE_CLIENTS)
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    after = counters_of(fluid, "executor.graph_capture", "executor.cache_miss")
    launches = dict(ck.LAUNCHES)
    errors = [r for r in done if isinstance(r[1], BaseException)]
    stats = srv.stats()
    lat = srv.latency_ms()
    client_ms = [(t1 - t0_) * 1e3 for _, _, t0_, t1 in done]
    record = {"phase": "serving_bert", "requests": len(done), "errors": len(errors),
              "wall_s": wall_s, "requests_per_s": len(done) / wall_s,
              "rows_per_s": int(rows.sum()) / wall_s, "p50_ms": lat["p50"], "p99_ms": lat["p99"],
              "client_p50_ms": pct(client_ms, 50), "client_p99_ms": pct(client_ms, 99),
              "batches": stats["batches"], "rows": stats["rows"],
              "pad_fraction": stats["padded_rows"] / (stats["rows"] + stats["padded_rows"]),
              "queue_wait_fraction": srv.queue_wait_frac(),
              "buckets": srv.bucket_attribution(), "counters_before": before,
              "counters_after": after, "launches_in_traffic": {
                  k: launches[k] - warm_launches[k] for k in launches}, "card": card}
    emit(record)
    if errors:
        raise AssertionError(f"serving_bert: {len(errors)} requests failed: {errors[0][1]!r}")
    if after != before:
        raise AssertionError(f"serving_bert: the traffic moved {before} -> {after}")
    if launches != warm_launches:
        raise AssertionError("serving_bert: a wrapper launched under the traffic: the batches "
                             "did not all replay graphs")
    hold_ledger("serving_bert", srv, requests=SERVE_REQUESTS, completed=SERVE_REQUESTS, shed=0,
                errors=0)
    # every batch replayed a graph holding PER_REQUEST
    add_launches(REPLAYED.setdefault("serving_bert", dict(NONE)),
                 {k: v * stats["batches"] for k, v in PER_REQUEST.items()})
    eager = eager_predictor(fluid, model_dir)
    worst = 0.0
    for i, out, _, _ in done:
        want = eager.run(requests[i])[0]
        if out.shape != (rows[i], 128, 768) or not np.isfinite(out.astype(np.float32)).all():
            raise AssertionError(f"serving_bert: request {i} gave {out.shape}")
        worst = max(worst, max_diff(out, want))
    emit({"phase": "serving_bert", "vs_direct_eager_max_abs": worst, "tol": SERVE_TOL,
          "compared": len(done)})
    if not worst <= SERVE_TOL:
        raise AssertionError(f"serving_bert: a response differs from its direct eager run by "
                             f"{worst} > {SERVE_TOL}")
    del eager
    profile_replay(torch, "serving_bert batch of 32 rows",
                   lambda: srv.infer("bert", requests[int(np.argmax(rows))]), card, PER_REQUEST)
    return srv, model_dir, launches, record


def serving_admission(fluid, torch, card, registry):
    """Phase 57: a Server(max_queue=ADMISSION_QUEUE, start=False) over phase
    56's registry takes a burst of ADMISSION_BURST requests: the first
    ADMISSION_QUEUE admitted, every later one shed with
    ServingError(reason="overload"), counted exactly; ADMISSION_DEADLINED
    of the admitted carry a 1 ms deadline that lapses in the queue and end
    as timeout while their batch proceeds; an oversize request (33 rows) is
    refused at the door.  The ledger balances and every outcome's trace is
    closed with its reason code."""
    import numpy as np

    serving = fluid.serving
    fluid.monitor.reset()
    srv = serving.Server(registry, buckets=SERVE_BUCKETS, max_queue=ADMISSION_QUEUE,
                         start=False)
    rng = np.random.RandomState(57)
    futures, shed = [], 0
    t0 = time.perf_counter()
    for i in range(ADMISSION_BURST):
        deadline = 1.0 if i < ADMISSION_DEADLINED else None
        try:
            futures.append(srv.submit("bert", bert_request(int(rng.randint(1, 5)), rng),
                                      deadline_ms=deadline))
        except fluid.errors.ServingError as e:
            if e.reason != "overload":
                raise
            shed += 1
    burst_ms = (time.perf_counter() - t0) * 1e3
    try:
        srv.submit("bert", bert_request(33, rng))
        raise AssertionError("serving_admission: a 33-row request was admitted")
    except fluid.errors.ServingError as e:
        if e.reason != "oversize":
            raise
    time.sleep(0.02)  # the deadlines lapse in the queue
    srv.start()
    outcomes = {"completed": 0, "timeout": 0}
    for f in futures:
        try:
            f.result(timeout=60)
            outcomes["completed"] += 1
        except fluid.errors.ServingError as e:
            if e.reason != "timeout":
                raise
            outcomes["timeout"] += 1
    srv.stop()
    led = hold_ledger("serving_admission", srv, requests=ADMISSION_BURST,
                      shed=ADMISSION_BURST - ADMISSION_QUEUE, timeouts=ADMISSION_DEADLINED,
                      completed=ADMISSION_QUEUE - ADMISSION_DEADLINED, rejected=1, errors=0)
    traces = fluid.monitor.request_traces()
    by = {}
    for t in traces:
        key = f"{t['outcome']}:{t.get('reason')}"
        by[key] = by.get(key, 0) + 1
    want = {"completed:None": ADMISSION_QUEUE - ADMISSION_DEADLINED,
            "timeout:timeout": ADMISSION_DEADLINED,
            "shed:overload": ADMISSION_BURST - ADMISSION_QUEUE, "rejected:oversize": 1}
    emit({"phase": "serving_admission", "burst": ADMISSION_BURST, "max_queue": ADMISSION_QUEUE,
          "shed": shed, "burst_submit_ms": burst_ms, "outcomes": outcomes, "ledger": led,
          "traces": by, "shed_counter": fluid.monitor.counter("serving.shed").value,
          "card": card})
    if shed != ADMISSION_BURST - ADMISSION_QUEUE or by != want:
        raise AssertionError(f"serving_admission: shed {shed}, traces {by} != {want}")
    fluid.monitor.reset()


def train_bert_checkpoint(fluid, torch, root, steps=2):
    """The served BERT-base's training program (build_train: bf16, fused
    attention, dropout 0, Adam(PUBLISH_LR)) from the served model's initial
    weights (seed 0), `steps` steps on seeded batches of 8 x 128 under a
    CheckpointManager at `root`, saved after the last.  Returns the
    manager."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    main, startup, loss = build_train(fluid, "bfloat16", 12, 0.0, 128, True,
                                      learning_rate=PUBLISH_LR)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(58)
    for _ in range(steps):
        exe.run(main, feed=make_fake_batch(8, 128, 30522, rng=rng), fetch_list=[loss],
                scope=scope)
    cm = fluid.CheckpointManager(root, program=main, scope=scope, place=fluid.CUDAPlace(0))
    cm.save(step=steps)
    return cm


def serving_publish(fluid, torch, card, tmp, srv, model_dir, steady_p99):
    """Phase 58: train the served BERT-base 2 steps under a
    CheckpointManager and publish its committed checkpoint weights-only into
    phase 56's server while SERVE_CLIENTS clients keep submitting (a pool
    of PUBLISH_POOL requests): no request dropped, each response the old or
    the new version's direct eager output (the one nearer in L2, within
    SERVE_TOL and within a quarter of their distance), every request
    submitted after the swap the new one's; rollback restores the old
    outputs; the served model saved with one NaN weight, and a copy of it
    with a truncated shard, are each rejected and quarantined while the old
    version serves on.  p99
    during the publish (the staged buckets' captures included) printed
    beside phase 56's steady p99.  Returns the committed checkpoint's and
    the NaN-weight snapshot's directories."""
    import threading

    import numpy as np

    serving = fluid.serving
    t0 = time.perf_counter()
    cm = train_bert_checkpoint(fluid, torch, os.path.join(tmp, "bert_ckpt"))
    train_s = time.perf_counter() - t0
    rng = np.random.RandomState(580)
    pool = [bert_request(int(r), rng) for r in rng.randint(1, 33, PUBLISH_POOL)]
    old = eager_predictor(fluid, model_dir)
    old_out = [old.run(f)[0] for f in pool]
    params = [v.name for v in fluid.io._persistables(old.program)]
    # the served model saved again with one NaN weight
    bad = {"nan_weight": os.path.join(tmp, "bert_nan"),
           "truncated_shard": os.path.join(tmp, "bert_truncated")}
    w = old.scope.find_var("bert.l0.ffn1.w")
    w.view(-1)[0] = float("nan")
    fluid.io.save_inference_model(bad["nan_weight"], old.feed_names, old.fetch_names, old.exe,
                                  old.program, old.scope)
    new = eager_predictor(fluid, model_dir)
    fluid.io.load_sharded(cm.latest(), var_names=params, scope=new.scope,
                          device=torch.device("cuda:0"))
    new_out = [new.run(f)[0] for f in pool]
    # a response is the version it is nearer to in L2, and must lie within
    # SERVE_TOL of it and within a quarter of the versions' distance: the
    # two-step fine-tune moves some requests' outputs by a few bf16 steps
    # only (0.08-0.18 at most), so the max-abs rule alone cannot tell them
    apart = [l2_diff(a, b) for a, b in zip(old_out, new_out)]
    del old, new
    if not min(apart) > 0:
        raise AssertionError("serving_publish: the versions agree on a request")
    led0 = srv.ledger()
    captures0 = fluid.monitor.counter("executor.graph_capture").value
    stop = threading.Event()
    threads, done = run_clients(srv, "bert", pool, SERVE_CLIENTS, stop,
                                PUBLISH_MIN_REQUESTS // SERVE_CLIENTS)
    time.sleep(0.5)
    t_pub0 = time.perf_counter()
    srv.publish("bert", cm)
    t_swap = time.perf_counter()
    checkpoint = cm.latest()
    del cm  # its training scope
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join()
    publish_s = t_swap - t_pub0
    captures = fluid.monitor.counter("executor.graph_capture").value - captures0
    errors = [r for r in done if isinstance(r[1], BaseException)]
    matched = {"old": 0, "new": 0}
    during, worst_near = [], 0.0
    for i, out, ts, td in done:
        if isinstance(out, BaseException):
            continue
        d_old, d_new = l2_diff(out, old_out[i]), l2_diff(out, new_out[i])
        which = "new" if d_new < d_old else "old"
        near = max_diff(out, (new_out if which == "new" else old_out)[i])
        if near > SERVE_TOL or min(d_old, d_new) > apart[i] / 4:
            raise AssertionError(f"serving_publish: request {i} matches neither version "
                                 f"(L2 to old {d_old}, to new {d_new}, apart {apart[i]}; "
                                 f"max abs to the nearer {near})")
        worst_near = max(worst_near, near)
        if ts > t_swap and which != "new":
            raise AssertionError(f"serving_publish: request {i} submitted after the swap "
                                 "got the old version's output")
        matched[which] += 1
        if td >= t_pub0 and ts <= t_swap:
            during.append((td - ts) * 1e3)
    led1 = srv.ledger()
    emit({"phase": "serving_publish", "train_s": train_s, "publish_s": publish_s,
          "captures": captures, "requests": len(done), "errors": len(errors),
          "matched": matched, "versions_apart_l2": [min(apart), max(apart)],
          "versions_apart_max_abs": min(max_diff(a, b) for a, b in zip(old_out, new_out)),
          "response_vs_its_version_max_abs": worst_near,
          "p99_during_publish_ms": pct(during, 99), "requests_during_publish": len(during),
          "steady_p99_ms": steady_p99, "card": card})
    if errors or led1["completed"] - led0["completed"] != len(done) or not led1["balanced"]:
        raise AssertionError(f"serving_publish: {len(errors)} failed, ledger {led0} -> {led1}")
    if matched["old"] == 0 or matched["new"] == 0:
        raise AssertionError(f"serving_publish: the swap was not under load: {matched}")
    srv.rollback("bert")
    back = max(max_diff(srv.infer("bert", f)[0], o) for f, o in zip(pool, old_out))
    emit({"phase": "serving_publish", "after_rollback_vs_old_max_abs": back, "tol": SERVE_TOL})
    if not back <= SERVE_TOL:
        raise AssertionError(f"serving_publish: rollback serves {back} off the old outputs")
    shutil.copytree(model_dir, bad["truncated_shard"])
    victim = max((os.path.join(r, f) for r, _, fs in os.walk(bad["truncated_shard"])
                  for f in fs if not f.endswith(".json")), key=os.path.getsize)
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    rejected = {}
    for what, src in bad.items():
        try:
            srv.publish("bert", src)
            raise AssertionError(f"serving_publish: the {what} checkpoint was published")
        except fluid.errors.ServingError as e:
            if e.reason != "publish_rejected":
                raise
            rejected[what] = str(e)[:200]
        if not os.path.exists(os.path.join(src, serving.QUARANTINE_MARKER)):
            raise AssertionError(f"serving_publish: the {what} checkpoint was not quarantined")
        still = max(max_diff(srv.infer("bert", f)[0], o) for f, o in zip(pool[:4], old_out))
        if not still <= SERVE_TOL:
            raise AssertionError(f"serving_publish: after the {what} rejection the server "
                                 f"serves {still} off the old outputs")
    emit({"phase": "serving_publish", "rejected": rejected, "card": card})
    return {"checkpoint": checkpoint, "nan_weight": bad["nan_weight"]}


def serving_budget(fluid, torch, card, tmp, bert_dir):
    """Phase 59: BERT-base bf16 (phase 56's encoder) and ResNet-50 bf16
    (phase 8's model) under one registry whose budget holds either but not
    both (the larger plan_model_bytes at bucket 32), each warmed at
    BUDGET_BUCKETS.  The model of the larger plan is loaded and unloaded,
    loaded again (its bytes alone measured) and unloaded (the unload must
    give its bytes back); then the other is loaded, and loading the first
    again evicts it: the executor must hold no plan of the evicted scope, a
    weak reference to one of its weights must be dead, and the allocator's
    bytes must come back to within BUDGET_MARGIN_BYTES of what the survivor
    held alone, so the evicted model's weights and graph pools are gone.  A
    load with nothing to evict raises reason="hbm_budget".  For each model:
    plan_model_bytes at 32, the ledger's bytes, the allocator's allocated
    and reserved deltas after load and warm."""
    import numpy as np

    serving = fluid.serving
    resnet_dir = os.path.join(tmp, "resnet50_bf16_budget")
    save_resnet(fluid, fluid.CUDAPlace(0), resnet_dir, "bfloat16", images(32, 10))
    need = {"bert": serving.plan_model_bytes(bert_dir, 32),
            "resnet": serving.plan_model_bytes(resnet_dir, 32)}
    dirs = {"bert": bert_dir, "resnet": resnet_dir}
    small, large = sorted(need, key=need.get)
    budget = need[large]
    registry = serving.ModelRegistry(place=fluid.CUDAPlace(0), hbm_budget_mb=budget / 1e6)
    probe = {"bert": bert_request(3, np.random.RandomState(59)),
             "resnet": {"img": images(3, 59)["img"]}}

    def mem():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    rec = {}
    held = {}  # name -> (scope id, weak reference to one of its weights) of the latest load

    def load(name):
        a0, r0 = mem()
        t0 = time.perf_counter()
        version = registry.load(name, dirs[name], warm_buckets=BUDGET_BUCKETS)
        load_s = time.perf_counter() - t0
        out = version.run(probe[name])[0]
        if not np.isfinite(np.asarray(out).astype(np.float32)).all():
            raise AssertionError(f"serving_budget: {name} served non-finite values")
        a1, r1 = mem()
        rec.setdefault(name, []).append({
            "plan_model_bytes_at_32": need[name], "ledger_bytes": version.bytes,
            "allocated_delta": a1 - a0, "reserved_delta": r1 - r0, "load_warm_s": load_s,
            "plans": len(bucket_plans(registry, version))})
        scope = version.scope
        weight = next(t for t in map(scope.find_var, scope.local_var_names())
                      if isinstance(t, torch.Tensor) and t.is_cuda)
        held[name] = (scope._uuid, weakref.ref(weight))
        del version, scope, weight
        return a0, a1

    first_base, _ = load(large)  # the first load also makes the side stream's workspaces
    registry.unload(large)
    primed, _ = mem()
    base, alone = load(large)
    registry.unload(large)
    after_unload, _ = mem()
    load(small)
    evictions0 = fluid.monitor.counter("serving.evictions").value
    _, with_large = load(large)
    evicted = sorted(set(dirs) - set(registry.models()))
    small_bytes = rec[small][0]["allocated_delta"]
    err = abs(with_large - alone)
    small_uuid, small_ref = held[small]
    small_plans = sum(1 for k in registry.executor._cache if k[4] == small_uuid)
    gc.collect()
    small_weight_alive = small_ref() is not None
    try:
        tiny = serving.ModelRegistry(place=fluid.CUDAPlace(0), hbm_budget_mb=need[small] / 2e6,
                                     executor=registry.executor)
        tiny.load(small, dirs[small], warm_buckets=BUDGET_BUCKETS)
        raise AssertionError("serving_budget: a load past the budget with nothing to evict "
                             "was accepted")
    except fluid.errors.ServingError as e:
        if e.reason != "hbm_budget":
            raise
        refused = str(e)[:200]
    emit({"phase": "serving_budget", "budget_bytes": budget, "order": [large, small, large],
          "models": rec, "allocated": {"first_base": first_base, "after_first_unload": primed,
                                        "base": base, "alone": alone,
                                        "after_unload": after_unload,
                                        "after_eviction": with_large},
          "evicted": evicted, "evictions": fluid.monitor.counter("serving.evictions").value
          - evictions0, "eviction_error_bytes": err, "margin_bytes": BUDGET_MARGIN_BYTES,
          "evicted_plans_left": small_plans, "evicted_weight_alive": small_weight_alive,
          "refused": refused, "card": card})
    if evicted != [small]:
        raise AssertionError(f"serving_budget: evicted {evicted}, want [{small!r}]")
    if small_plans or small_weight_alive:
        raise AssertionError(f"serving_budget: after evicting {small} the executor holds "
                             f"{small_plans} of its plans, its weight alive: {small_weight_alive}")
    if abs(after_unload - base) > BUDGET_MARGIN_BYTES:
        raise AssertionError(f"serving_budget: unloading {large} left {after_unload - base} "
                             f"of its {alone - base} bytes allocated")
    if err > BUDGET_MARGIN_BYTES:
        raise AssertionError(f"serving_budget: after evicting {small} the allocator holds "
                             f"{with_large} bytes, {large} alone held {alone}: {small}'s "
                             f"{small_bytes} bytes were not freed")
    registry.unload(large)


def serving_parity(fluid, torch, card, tmp):
    """Phase 60: a float32 BERT (2 layers; the encoder's hidden states)
    served by a Server on the card and one on the CPU (both
    max_queue=SERVING_PARITY_QUEUE, start=False, one worker), the same
    SERVING_PARITY_REQUESTS requests submitted to each (two shed, one with a
    deadline that lapses in the queue): the responses agree within
    SERVING_PARITY_TOL, the ledgers are equal, and so are the traces'
    outcomes and reason codes."""
    import numpy as np

    serving = fluid.serving
    model_dir = os.path.join(tmp, "bert_f32_2l_encoder")
    save_encoder(fluid, torch, model_dir, "float32", 2, unit_ln_scale=True)
    rng = np.random.RandomState(60)
    requests = [bert_request(int(r), rng) for r in rng.randint(1, 9, SERVING_PARITY_REQUESTS)]
    sides = {}
    for side, place in (("card", fluid.CUDAPlace(0)), ("cpu", fluid.CPUPlace())):
        fluid.monitor.reset()
        srv = serving.Server(serving.ModelRegistry(place=place), buckets=(2, 8, 16),
                             max_queue=SERVING_PARITY_QUEUE, start=False)
        srv.load_model("bert", model_dir)
        futures = []
        for i, feed in enumerate(requests):
            try:
                futures.append((i, srv.submit("bert", feed, deadline_ms=1.0 if i == 1 else None)))
            except fluid.errors.ServingError as e:
                futures.append((i, e))
        time.sleep(0.02)
        srv.start()
        outs = {}
        for i, f in futures:
            try:
                outs[i] = f.result(timeout=120)[0] if not isinstance(f, BaseException) else f.reason
            except fluid.errors.ServingError as e:
                outs[i] = e.reason
        srv.stop()
        sides[side] = {"outs": outs, "ledger": srv.ledger(),
                       "traces": [(t["outcome"], t.get("reason"))
                                  for t in fluid.monitor.request_traces()]}
    card_side, cpu_side = sides["card"], sides["cpu"]
    worst = 0.0
    for i, o in card_side["outs"].items():
        c = cpu_side["outs"][i]
        if isinstance(o, str) or isinstance(c, str):
            if o != c:
                raise AssertionError(f"serving_parity: request {i}: card {o!r}, CPU {c!r}")
            continue
        worst = max(worst, max_diff(o, c))
    emit({"phase": "serving_parity", "model": "bert f32, 2 layers, encoder",
          "max_abs_diff": worst, "tol": SERVING_PARITY_TOL, "ledger": card_side["ledger"],
          "cpu_ledger": cpu_side["ledger"], "traces": sorted(set(card_side["traces"])),
          "card": card})
    if not worst <= SERVING_PARITY_TOL:
        raise AssertionError(f"serving_parity: card vs CPU responses differ by {worst}")
    if card_side["ledger"] != cpu_side["ledger"] or card_side["traces"] != cpu_side["traces"]:
        raise AssertionError(f"serving_parity: ledgers {card_side['ledger']} vs "
                             f"{cpu_side['ledger']}, traces differ")
    if card_side["ledger"]["shed"] != 2 or card_side["ledger"]["timeouts"] != 1:
        raise AssertionError(f"serving_parity: ledger {card_side['ledger']}")



def serving_phases(fluid, torch, ck, tmp, card):
    """Phases 56-60 (the serving runtime), each's seconds printed; returns
    phase 56's launches and what the fleet phases take from 56 and 58: the
    fleet's model (phase 56's weights), the checkpoint and the NaN-weight
    snapshot of phase 58, phase 56's traffic record."""
    serving_t0 = phase_t0 = time.perf_counter()
    srv, bert_dir, launches, steady = serving_bert(fluid, torch, ck, tmp, card)
    steady_p99 = steady["p99_ms"]
    fleet_dir = os.path.join(tmp, "bert_base_bf16_first_token")
    save_fleet_encoder(fluid, fleet_dir, srv.registry.acquire("bert"))
    emit({"phase_seconds": "serving_bert", "s": time.perf_counter() - phase_t0, "card": card})
    phase_t0 = time.perf_counter()
    serving_admission(fluid, torch, card, srv.registry)
    emit({"phase_seconds": "serving_admission", "s": time.perf_counter() - phase_t0,
          "card": card})
    phase_t0 = time.perf_counter()
    snapshots = serving_publish(fluid, torch, card, tmp, srv, bert_dir, steady_p99)
    srv.stop()
    emit({"phase_seconds": "serving_publish", "s": time.perf_counter() - phase_t0,
          "card": card})
    del srv
    phase_t0 = time.perf_counter()
    serving_budget(fluid, torch, card, tmp, bert_dir)
    emit({"phase_seconds": "serving_budget", "s": time.perf_counter() - phase_t0, "card": card})
    phase_t0 = time.perf_counter()
    serving_parity(fluid, torch, card, tmp)
    emit({"phase_seconds": "serving_parity", "s": time.perf_counter() - phase_t0, "card": card})
    emit({"phase_seconds": "phases 56-60", "s": time.perf_counter() - serving_t0, "card": card})
    return launches, dict(snapshots, model_dir=fleet_dir, steady=steady, bert_dir=bert_dir)


FLEET_REPLICAS = 2
FLEET_BUCKETS = (1, 8, 32)
FLEET_CLIENTS = 4
FLEET_REQUESTS = 400
FLEET_BOOT_S = 120.0  # a replica's boot: imports, CUDA context, load, warm
FLEET_SETTLE_S = 30.0
# a replica's launches at a load or a stage: a warm-up and a capture a
# bucket (at a stage the golden smoke is bucket 1's warm-up)
FLEET_WARM = {k: 2 * len(FLEET_BUCKETS) * v for k, v in PER_REQUEST.items()}


def save_fleet_encoder(fluid, dirname, version):
    """Phase 56's served BERT-base (the registry's active version: its
    program and the weights in its scope) saved for the fleet with the
    first token's hidden state, [rows, 1, 768], as its output: a slice of
    the encoder's [rows, 128, 768].  That is the sentence vector a
    sentence-encoding service returns, and it keeps a response on the
    fleet's JSON wire (the JAX package's: lists of numbers) a 128th of
    the hidden states'."""
    program = version.program.clone()
    with fluid.program_guard(program, fluid.Program()):
        hidden = program.global_block().var(version.fetch_names[0])
        first = fluid.layers.slice(hidden, axes=[1], starts=[0], ends=[1])
    fluid.io.save_inference_model(dirname, version.feed_names, [first], None, program,
                                  version.scope)


def fleet_events(fleet, action=None):
    path = os.path.join(fleet.root, "telemetry", "router.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r for r in recs if r.get("kind") == "fleet_event"
            and (action is None or r.get("action") == action)]


def fleet_logs(fleet):
    """The tail of every replica incarnation's standard error."""
    logs = os.path.join(fleet.root, "logs")
    tails = []
    for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else ():
        if name.endswith(".err"):
            with open(os.path.join(logs, name), errors="replace") as f:
                tails.append(f"== {name}\n{f.read()[-3000:]}")
    return "\n".join(tails)


def fleet_wait(fleet, cond, what, timeout):
    """Poll `cond()` until it is truthy (returned); past `timeout` raise
    with the replicas' logs."""
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"fleet: waited {timeout}s for {what}; events "
                                 f"{[e['action'] for e in fleet_events(fleet)]}\n"
                                 + fleet_logs(fleet))
        time.sleep(0.02)


def fleet_listening(fleet, ranks):
    """The ranks alive in the health table with their serving port beaten
    by their current incarnation's process (never a corpse's last beat)."""
    table = fleet.health.poll()
    with fleet._lock:
        pids = {r: fleet._replicas[r]["proc"].pid for r in ranks}
    return [r for r in ranks if table[r]["status"] == "alive"
            and (table[r]["tel"] or {}).get("port")
            and (table[r]["tel"] or {}).get("pid") == pids[r]]


def fleet_records(fleet):
    """Each replica incarnation's telemetry: {incarnation: {"rank", "up",
    "drained" (the launches of its replica_up / replica_drained records,
    None where there is none), "peak_bytes" (the largest
    memory.device_bytes_in_use its snapshots sampled), "counters" (its
    last snapshot's)}}."""
    out = {}
    tel = os.path.join(fleet.root, "telemetry")
    for inc in os.listdir(tel):
        if not inc.startswith("i"):
            continue
        for name in os.listdir(os.path.join(tel, inc)):
            if not (name.startswith("metrics.p") and name.endswith(".jsonl")):
                continue
            rec = {"rank": int(name[len("metrics.p"):-len(".jsonl")]), "up": None,
                   "drained": None, "peak_bytes": 0.0, "counters": {}, "snapshot_ts": 0.0}
            with open(os.path.join(tel, inc, name)) as f:
                for line in f:
                    r = json.loads(line)
                    if r.get("kind") == "serving_event" and r.get("action") in (
                            "replica_up", "replica_drained"):
                        rec["up" if r["action"] == "replica_up" else "drained"] = r["launches"]
                    elif r.get("kind") == "snapshot":
                        used = r["gauges"].get("memory.device_bytes_in_use")
                        if used is not None and used == used:
                            rec["peak_bytes"] = max(rec["peak_bytes"], used)
                        rec["counters"], rec["snapshot_ts"] = r["counters"], r["ts"]
            out[int(inc[1:])] = rec
    return out


def fleet_stages(fleet):
    """{incarnation: versions it staged}: each replica_staged or
    replica_restaged event of a rank goes to that rank's incarnation of the
    moment (fleet_started spawns incarnations 1..n in rank order,
    replica_restarted names the next)."""
    current, staged = {}, {}
    for e in fleet_events(fleet):
        if e["action"] == "fleet_started":
            current = {r: r + 1 for r in range(e["n_replicas"])}
        elif e["action"] == "replica_restarted":
            current[e["rank"]] = e["incarnation"]
        elif e["action"] in ("replica_staged", "replica_restaged"):
            inc = current[e["rank"]]
            staged[inc] = staged.get(inc, 0) + 1
    return staged


def fleet_settled(fleet, since):
    """Every snapshot the fleet's tools read was written after `since`:
    the router's and each live replica's."""
    snaps = []
    path = os.path.join(fleet.root, "telemetry", "router.jsonl")
    with open(path) as f:
        snaps = [json.loads(line)["ts"] for line in f if '"kind": "snapshot"' in line]
    if not snaps or snaps[-1] <= since:
        return False
    with fleet._lock:
        live = {rep["incarnation"] for rep in fleet._replicas.values()}
    recs = fleet_records(fleet)
    return all(recs.get(i, {}).get("snapshot_ts", 0.0) > since for i in live)


def fleet_serve(fluid, card, tmp, model_dir, steady):
    """Phase 61: ServingFleet({"bert": model_dir}, n_replicas=FLEET_REPLICAS,
    buckets=FLEET_BUCKETS) on the card; FLEET_CLIENTS clients send
    FLEET_REQUESTS requests of seeded 1-32 rows through fleet.infer.  Each
    response is held within SERVE_TOL of a direct eager run of the same
    model in this process; requests == completed with no error; both
    replicas served; each replica's replica_up record shows FLEET_WARM.
    Returns the fleet."""
    import numpy as np

    rng = np.random.RandomState(61)
    rows = rng.randint(1, 33, FLEET_REQUESTS)
    requests = [bert_request(int(r), rng) for r in rows]
    eager = eager_predictor(fluid, model_dir)
    want = [eager.run(r)[0] for r in requests]
    del eager
    t0 = time.perf_counter()
    fleet = fluid.serving.ServingFleet({"bert": model_dir}, n_replicas=FLEET_REPLICAS,
                                       root=os.path.join(tmp, "fleet"), buckets=FLEET_BUCKETS)
    healthy_s = {}

    def booted():
        for r in fleet_listening(fleet, range(FLEET_REPLICAS)):
            healthy_s.setdefault(r, time.perf_counter() - t0)
        if fleet_events(fleet, "replica_dead"):
            raise AssertionError("fleet_serve: a replica died booting\n" + fleet_logs(fleet))
        return len(healthy_s) == FLEET_REPLICAS

    try:
        fleet_wait(fleet, booted, "both replicas listening", FLEET_BOOT_S)
        t0 = time.perf_counter()
        threads, done = run_clients(fleet, "bert", requests, FLEET_CLIENTS)
        for t in threads:
            t.join()
        wall_s = time.perf_counter() - t0
        errors = [r for r in done if isinstance(r[1], BaseException)]
        ledger = fleet.stats()
        recs = fleet_records(fleet)
        client_ms = [(t1 - ts) * 1e3 for _, _, ts, t1 in done]
        record = {"phase": "fleet_serve", "replicas": FLEET_REPLICAS, "buckets": FLEET_BUCKETS,
                  "boot_to_healthy_s": healthy_s, "requests": len(done), "errors": len(errors),
                  "wall_s": wall_s, "requests_per_s": len(done) / wall_s,
                  "rows_per_s": int(rows.sum()) / wall_s, "router_p50_ms": pct(client_ms, 50),
                  "router_p99_ms": pct(client_ms, 99),
                  "completed_per_replica": ledger["routed"], "ledger": ledger,
                  "replica_peak_allocated_bytes": {
                      recs[i]["rank"]: recs[i]["peak_bytes"] for i in sorted(recs)},
                  "replica_up_launches": {recs[i]["rank"]: recs[i]["up"] for i in sorted(recs)},
                  "phase56_requests_per_s": steady["requests_per_s"],
                  "phase56_p99_ms": steady["p99_ms"], "card": card}
        emit(record)
        if errors:
            raise AssertionError(f"fleet_serve: {len(errors)} requests failed: {errors[0][1]!r}")
        if not (ledger["requests"] == ledger["completed"] == FLEET_REQUESTS
                and ledger["errors"] == 0):
            raise AssertionError(f"fleet_serve: ledger {ledger}")
        if sorted(r for r, n in ledger["routed"].items() if n > 0) != list(range(FLEET_REPLICAS)):
            raise AssertionError(f"fleet_serve: not every replica served: {ledger['routed']}")
        for inc, rec in recs.items():
            if rec["up"] is None or {k: rec["up"][k] for k in FLEET_WARM} != FLEET_WARM:
                raise AssertionError(f"fleet_serve: replica {rec['rank']} (incarnation {inc}) "
                                     f"booted with launches {rec['up']}, want {FLEET_WARM}")
        worst = 0.0
        for i, out, _, _ in done:
            if out.shape != want[i].shape or out.shape[:2] != (rows[i], 1) or \
                    not np.isfinite(out.astype(np.float32)).all():
                raise AssertionError(f"fleet_serve: request {i} gave {out.shape}")
            worst = max(worst, max_diff(out, want[i]))
        emit({"phase": "fleet_serve", "vs_direct_eager_max_abs": worst, "tol": SERVE_TOL,
              "compared": len(done)})
        if not worst <= SERVE_TOL:
            raise AssertionError(f"fleet_serve: a response differs from its direct eager run "
                                 f"by {worst} > {SERVE_TOL}")
        return fleet, record
    except BaseException:
        fleet.stop()
        raise


def run_tool(*argv, phase="fleet_roll"):
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools", argv[0]), *argv[1:]],
                       capture_output=True, text=True, timeout=120)
    emit({"phase": phase, "tool": " ".join(argv[:2]), "rc": r.returncode,
          "out": r.stdout[-600:]})
    if r.returncode != 0:
        raise AssertionError(f"{phase}: {' '.join(argv)} failed:\n{r.stdout[-3000:]}"
                             f"\n{r.stderr[-3000:]}")


def fleet_roll(fluid, torch, card, tmp, fleet, model_dir, snapshots, steady_p99):
    """Phase 62: the fleet's model with phase 58's committed checkpoint
    weights, saved as a snapshot, rolled by fleet.rolling_publish while
    FLEET_CLIENTS clients cycle through PUBLISH_POOL requests: none dropped,
    each response the old or the new version's direct eager output (phase
    58's rule), every one submitted after the roll the new; both replicas
    active on the new and ACTIVE.json naming it.  Then a roll of phase
    58's NaN-weight snapshot (a copy without its quarantine marker) halts at
    the first replica with roll_halted and roll_rolled_back, leaves the
    marker, and no response comes from it.  The stdlib-only tools then
    check the fleet's telemetry.  Returns (pool, new outputs, new dir)."""
    import threading

    import numpy as np

    rng = np.random.RandomState(620)
    pool = [bert_request(int(r), rng) for r in rng.randint(1, 33, PUBLISH_POOL)]
    old = eager_predictor(fluid, model_dir)
    old_out = [old.run(f)[0] for f in pool]
    params = [v.name for v in fluid.io._persistables(old.program)]
    del old
    new = eager_predictor(fluid, model_dir)
    fluid.io.load_sharded(snapshots["checkpoint"], var_names=params, scope=new.scope,
                          device=torch.device("cuda:0"))
    new_dir = os.path.join(tmp, "bert_base_bf16_first_token_finetuned")
    fluid.io.save_inference_model(new_dir, new.feed_names, new.fetch_names, new.exe, new.program,
                                  new.scope)
    new_out = [new.run(f)[0] for f in pool]
    del new
    apart = [l2_diff(a, b) for a, b in zip(old_out, new_out)]
    if not min(apart) > 0:
        raise AssertionError("fleet_roll: the versions agree on a request")
    bad_dir = os.path.join(tmp, "bert_nan_fleet")
    shutil.copytree(snapshots["nan_weight"], bad_dir,
                    ignore=shutil.ignore_patterns(fluid.serving.QUARANTINE_MARKER))
    led0 = fleet.stats()
    stop = threading.Event()
    threads, done = run_clients(fleet, "bert", pool, FLEET_CLIENTS, stop, 1)
    fleet_wait(fleet, lambda: len(done) >= FLEET_CLIENTS, "traffic before the roll", 60)
    t_roll0 = time.perf_counter()
    fleet.rolling_publish("bert", new_dir)
    t_roll1 = time.perf_counter()
    actives = fleet.active_versions("bert")
    with open(os.path.join(fleet.root, "ACTIVE.json")) as f:
        active_src = json.load(f)["models"]["bert"]["src"]
    try:
        fleet.rolling_publish("bert", bad_dir)
        raise AssertionError("fleet_roll: the NaN-weight snapshot rolled")
    except fluid.errors.ServingError as e:
        if e.reason != "roll_halted" or e.__cause__.reason != "publish_rejected":
            raise
        halted = str(e.__cause__)[:200]
    t_bad1 = time.perf_counter()
    n = len(done)
    fleet_wait(fleet, lambda: len(done) >= n + FLEET_CLIENTS, "traffic after the rolls", 60)
    stop.set()
    for t in threads:
        t.join()
    t_after = time.time()
    errors = [r for r in done if isinstance(r[1], BaseException)]
    matched, during, worst_near = {"old": 0, "new": 0}, [], 0.0
    for i, out, ts, td in done:
        if isinstance(out, BaseException):
            continue
        if not np.isfinite(out.astype(np.float32)).all():
            raise AssertionError(f"fleet_roll: request {i} served non-finite values")
        d_old, d_new = l2_diff(out, old_out[i]), l2_diff(out, new_out[i])
        which = "new" if d_new < d_old else "old"
        near = max_diff(out, (new_out if which == "new" else old_out)[i])
        if near > SERVE_TOL or min(d_old, d_new) > apart[i] / 4:
            raise AssertionError(f"fleet_roll: request {i} matches neither version (L2 to old "
                                 f"{d_old}, to new {d_new}, apart {apart[i]}; max abs to the "
                                 f"nearer {near})")
        worst_near = max(worst_near, near)
        if ts > t_roll1 and which != "new":
            raise AssertionError(f"fleet_roll: request {i} submitted after the roll got the old "
                                 "version's output")
        matched[which] += 1
        if td >= t_roll0 and ts <= t_roll1:
            during.append((td - ts) * 1e3)
    led1 = fleet.stats()
    rolls = {}
    for e in fleet_events(fleet):
        if e["action"].startswith("roll_"):
            rolls.setdefault(e["ctl"], []).append((e["action"], e.get("rank")))
    emit({"phase": "fleet_roll", "roll_s": t_roll1 - t_roll0, "halted_roll_s": t_bad1 - t_roll1,
          "requests": len(done), "errors": len(errors), "matched": matched,
          "versions_apart_l2": [min(apart), max(apart)],
          "response_vs_its_version_max_abs": worst_near,
          "p99_during_roll_ms": pct(during, 99), "requests_during_roll": len(during),
          "steady_p99_ms": steady_p99, "actives": actives, "rolls": list(rolls.values()),
          "halted": halted, "ledger": led1, "card": card})
    if errors or led1["completed"] - led0["completed"] != len(done) or \
            led1["requests"] != led1["completed"] + led1["errors"]:
        raise AssertionError(f"fleet_roll: {len(errors)} failed, ledger {led0} -> {led1}")
    if matched["old"] == 0 or matched["new"] == 0:
        raise AssertionError(f"fleet_roll: the roll was not under load: {matched}")
    if sorted(actives) != list(range(FLEET_REPLICAS)) or \
            any(a["src"] != new_dir for a in actives.values()) or active_src != new_dir:
        raise AssertionError(f"fleet_roll: after the roll {actives}, ACTIVE.json {active_src}")
    want_rolls = [[("roll_started", None), ("roll_converged", None)],
                  [("roll_started", None), ("roll_halted", 0), ("roll_rolled_back", None)]]
    if list(rolls.values()) != want_rolls:
        raise AssertionError(f"fleet_roll: roll events {rolls}")
    if not os.path.exists(os.path.join(bad_dir, fluid.serving.QUARANTINE_MARKER)):
        raise AssertionError("fleet_roll: the NaN-weight snapshot was not quarantined")
    fleet_wait(fleet, lambda: fleet_settled(fleet, t_after), "snapshots after the traffic",
               FLEET_SETTLE_S)
    run_tool("serve_trace.py", "--fleet", "--check", fleet.root)
    run_tool("perf_report.py", "--check", os.path.join(fleet.root, "telemetry", "router.jsonl"),
             "--check-roll-convergence")
    return pool, new_out, new_dir


def fleet_kill(fluid, card, fleet, pool, new_out, new_dir):
    """Phase 63: SIGKILL replica 1 while FLEET_CLIENTS clients submit: the
    only errors are replica_down, at most its inflight cap; requests
    submitted after the kill are served by the survivor; replica_dead and
    replica_restarted appear; the restarted replica reaches healthy on the
    fleet-active (rolled) version and its responses, asked of it directly,
    meet phase 61's rule.  Then fleet.stop() drains: both replicas exit 0,
    their final snapshots count nothing shed, the router's ledger balances
    exactly, and each incarnation that drained launched nothing under
    traffic.  Returns the replicas' launches (each incarnation's last
    record, summed)."""
    import threading

    import numpy as np

    router = fluid.serving.router
    stop = threading.Event()
    threads, done = run_clients(fleet, "bert", pool, FLEET_CLIENTS, stop, 1)
    fleet_wait(fleet, lambda: len(done) >= 2 * FLEET_CLIENTS, "traffic before the kill", 60)
    with fleet._lock:
        victim = fleet._replicas[1]["proc"]
    t_kill = time.time()
    victim.send_signal(signal.SIGKILL)
    dead = fleet_wait(fleet, lambda: fleet_events(fleet, "replica_dead"), "replica_dead", 60)
    restarted = fleet_wait(fleet, lambda: fleet_events(fleet, "replica_restarted"),
                           "replica_restarted", 60)
    routed_at_restart = fleet.stats()["routed"].get(0, 0)
    fleet_wait(fleet, lambda: fleet_listening(fleet, [1]), "the restarted replica listening",
               FLEET_BOOT_S)
    t_healthy = time.time()
    # the survivor served traffic that came after the kill
    fleet_wait(fleet, lambda: fleet.stats()["routed"].get(0, 0) > routed_at_restart,
               "the survivor serving", 60)
    n = len(done)
    fleet_wait(fleet, lambda: len(done) >= n + FLEET_CLIENTS, "traffic after the restart", 60)
    stop.set()
    for t in threads:
        t.join()
    errors = [r[1] for r in done if isinstance(r[1], BaseException)]
    worst = 0.0
    for i, out, _, _ in done:
        if isinstance(out, BaseException):
            continue
        if not np.isfinite(out.astype(np.float32)).all():
            raise AssertionError(f"fleet_kill: request {i} served non-finite values")
        worst = max(worst, max_diff(out, new_out[i]))
    actives = fleet.active_versions("bert")
    port = fleet.health.poll()[1]["tel"]["port"]
    direct = 0.0
    for i, feed in enumerate(pool[:FLEET_CLIENTS]):
        try:
            reply = router.rpc(port, {"op": "infer", "model": "bert",
                                      "feeds": router.encode_feeds(feed)})
        except router.ConnectFailed as e:  # say why: the events, the health table, the logs
            raise AssertionError(
                f"fleet_kill: the restarted replica at :{port} refused a connection ({e}); "
                f"events {fleet_events(fleet)}; health {fleet.health.poll()}\n"
                + fleet_logs(fleet)) from e
        if not reply.get("ok"):
            raise AssertionError(f"fleet_kill: the restarted replica refused: {reply}")
        direct = max(direct, max_diff(router.decode_arrays(reply["outputs"])[0], new_out[i]))
    ledger_live = fleet.stats()
    fleet.stop()
    with fleet._lock:
        exits = {r: rep["proc"].returncode for r, rep in fleet._replicas.items()}
    ledger = fleet.stats()
    recs, stages = fleet_records(fleet), fleet_stages(fleet)
    with fleet._lock:
        last = {rep["incarnation"] for rep in fleet._replicas.values()}
    emit({"phase": "fleet_kill", "seconds_to_detect_death": dead[0]["ts"] - t_kill,
          "seconds_restart_to_healthy": t_healthy - restarted[0]["ts"],
          "errors": [getattr(e, "reason", repr(e)) for e in errors],
          "inflight_cap": fleet.router.inflight_cap, "requests": len(done),
          "vs_new_version_max_abs": worst, "restarted_direct_max_abs": direct,
          "actives": actives, "exit_codes": exits, "ledger_before_stop": ledger_live,
          "ledger": ledger, "stages": stages,
          "replicas": {i: {k: v for k, v in r.items() if k != "counters"}
                       for i, r in sorted(recs.items())},
          "card": card})
    if any(getattr(e, "reason", None) != "replica_down" for e in errors) or \
            len(errors) > fleet.router.inflight_cap:
        raise AssertionError(f"fleet_kill: errors {errors}")
    if (dead[0]["rank"], restarted[0]["rank"]) != (1, 1):
        raise AssertionError(f"fleet_kill: events {dead} {restarted}")
    if not worst <= SERVE_TOL or not direct <= SERVE_TOL:
        raise AssertionError(f"fleet_kill: responses {worst}, the restarted replica's {direct} "
                             f"off the rolled version's direct eager outputs")
    if sorted(actives) != list(range(FLEET_REPLICAS)) or \
            any(a["src"] != new_dir for a in actives.values()):
        raise AssertionError(f"fleet_kill: active versions {actives}")
    if any(code != 0 for code in exits.values()):
        raise AssertionError(f"fleet_kill: the drain's exit codes {exits}\n" + fleet_logs(fleet))
    counts = ("requests", "completed", "errors", "by_reason")
    if ledger["requests"] != ledger["completed"] + ledger["errors"] or \
            ledger["errors"] != len(errors) or \
            any(ledger[k] != ledger_live[k] for k in counts):
        raise AssertionError(f"fleet_kill: ledger {ledger_live} -> {ledger}")
    launches = dict(NONE)
    for inc, rec in recs.items():
        if inc in last:
            c = rec["counters"]
            if rec["drained"] is None or c.get("serving.shed", 0) or c.get("serving.shutdowns", 0):
                raise AssertionError(f"fleet_kill: incarnation {inc} did not drain clean: {rec}")
            want = {k: rec["up"][k] + stages.get(inc, 0) * v for k, v in FLEET_WARM.items()}
            if {k: rec["drained"][k] for k in FLEET_WARM} != want:
                raise AssertionError(f"fleet_kill: incarnation {inc} launched "
                                     f"{rec['drained']} by its drain, want {want}: a wrapper "
                                     "launched under traffic")
        add_launches(launches, rec["drained"] or rec["up"])
    return launches


def fleet_phases(fluid, torch, card, tmp, inputs):
    """Phases 61-63 (the serving fleet), each's seconds printed, after the
    parent drops its cached blocks.  Returns the replicas' launches."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "fleet", "mem_get_info": {"free": free, "total": total},
          "allocated": torch.cuda.memory_allocated(), "reserved": torch.cuda.memory_reserved(),
          "card": card})
    fleet_t0 = phase_t0 = time.perf_counter()
    fleet, record = fleet_serve(fluid, card, tmp, inputs["model_dir"], inputs["steady"])
    try:
        emit({"phase_seconds": "fleet_serve", "s": time.perf_counter() - phase_t0, "card": card})
        phase_t0 = time.perf_counter()
        pool, new_out, new_dir = fleet_roll(fluid, torch, card, tmp, fleet, inputs["model_dir"],
                                            inputs, record["router_p99_ms"])
        emit({"phase_seconds": "fleet_roll", "s": time.perf_counter() - phase_t0, "card": card})
        phase_t0 = time.perf_counter()
        launches = fleet_kill(fluid, card, fleet, pool, new_out, new_dir)
        emit({"phase_seconds": "fleet_kill", "s": time.perf_counter() - phase_t0, "card": card})
    finally:
        fleet.stop()
    emit({"phase_seconds": "phases 61-63", "s": time.perf_counter() - fleet_t0, "card": card})
    return launches


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def serve_round(srv, model, requests, what, card):
    """SERVE_CLIENTS clients send `requests` once through srv.infer; returns
    (record, done) with requests/s, rows/s and client p50 / p99."""
    rows = sum(int(r["ids"].shape[0]) for r in requests)
    t0 = time.perf_counter()
    threads, done = run_clients(srv, model, requests, SERVE_CLIENTS)
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    errors = [r for r in done if isinstance(r[1], BaseException)]
    if errors:
        raise AssertionError(f"{what}: {len(errors)} requests failed: {errors[0][1]!r}")
    client_ms = [(t1 - t0_) * 1e3 for _, _, t0_, t1 in done]
    return {"requests": len(done), "wall_s": wall, "requests_per_s": len(done) / wall,
            "rows_per_s": rows / wall, "client_p50_ms": pct(client_ms, 50),
            "client_p99_ms": pct(client_ms, 99), "card": card}, done


def dequantized_from_files(qdir):
    """Each quantized weight as io.load_vars must give it: (q -> float32) *
    scale / qmax in its record's dtype, computed in numpy from the dir's own
    int8 files and __quant__.json."""
    import ml_dtypes
    import numpy as np

    with open(os.path.join(qdir, "__quant__.json")) as f:
        qman = json.load(f)["weights"]
    out = {}
    for name, rec in qman.items():
        q = np.load(os.path.join(qdir, name.replace("/", "%2F") + ".npy"))
        if q.dtype != np.int8:
            raise AssertionError(f"quant_serving: {name} is stored as {q.dtype}, not int8")
        shp = [1] * q.ndim
        if rec["axis"] is not None:
            shp[rec["axis"]] = -1
        qmax = float(2 ** (rec["bits"] - 1) - 1)
        dtype = ml_dtypes.bfloat16 if rec["dtype"] == "bfloat16" else np.dtype(rec["dtype"])
        out[name] = (q.astype(np.float32) * np.asarray(rec["scale"], np.float32).reshape(shp)
                     / qmax).astype(dtype)
    return out


def quant_serving(fluid, torch, ck, tmp, card, bert_dir):
    """Phase 64 (see the module docstring): BERT-base's int8 weights, served
    in bf16.  Returns the publish's launches (the int8 version's smoke and
    warm)."""
    serving = fluid.serving
    qdir = os.path.join(tmp, "bert_base_int8")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    program, feed_names, fetch_names = fluid.io.load_inference_model(bert_dir, exe, scope=scope)
    t0 = time.perf_counter()
    fluid.io.save_quantized_inference_model(qdir, feed_names, fetch_names, exe, program, scope,
                                            weight_bits=8, serve_dtype="bfloat16")
    quantize_s = time.perf_counter() - t0
    del exe, scope, program
    expect = dequantized_from_files(qdir)
    emit({"phase": "quant_serving", "quantize_and_save_s": quantize_s,
          "float_dir_bytes": dir_bytes(bert_dir), "int8_dir_bytes": dir_bytes(qdir),
          "quantized_weights": len(expect),
          "quantized_elements": int(sum(a.size for a in expect.values())), "card": card})
    registry = serving.ModelRegistry(place=fluid.CUDAPlace(0))
    srv = serving.Server(registry, buckets=SERVE_BUCKETS, workers=SERVE_WORKERS)
    try:
        return quant_serving_on(fluid, torch, ck, tmp, card, srv, bert_dir, qdir, expect)
    finally:
        srv.stop()
        for name in list(registry.models()):
            registry.unload(name)
        del srv, registry
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def quant_serving_on(fluid, torch, ck, tmp, card, srv, bert_dir, qdir, expect):
    """Phase 64 on `srv` (a Server of its own): the bf16 dir loaded and
    served, the int8 dir published under load and served, the drifted copy
    rejected.  Returns the publish's launches."""
    import threading

    import numpy as np

    serving = fluid.serving
    registry = srv.registry
    srv.load_model("bert", bert_dir)
    before = registry.models()["bert"]
    rng = np.random.RandomState(64)
    rows = rng.randint(1, 33, SERVE_REQUESTS)
    requests = [bert_request(int(r), rng) for r in rows]
    # a first round takes the host's first pinned buffers of each size: the
    # bf16 version's second round is the one set beside the int8 version's
    bf16_first, _ = serve_round(srv, "bert", requests, "quant_serving bf16", card)
    bf16_record, _ = serve_round(srv, "bert", requests, "quant_serving bf16", card)
    # the publish under load, each response held to one version's direct
    # eager output (phase 58's rule)
    pool = requests[:PUBLISH_POOL]
    old = eager_predictor(fluid, bert_dir)
    old_out = [old.run(f)[0] for f in pool]
    del old
    new = eager_predictor(fluid, qdir)
    new_out = [new.run(f)[0] for f in pool]
    del new
    apart = [l2_diff(a, b) for a, b in zip(old_out, new_out)]
    if not min(apart) > 0:
        raise AssertionError("quant_serving: the int8 and bf16 versions agree on a request")
    telemetry = os.path.join(tmp, "quant_metrics.jsonl")
    fluid.monitor.reset()
    logger = fluid.monitor.attach_logger(fluid.monitor.MonitorLogger(telemetry))
    led0 = srv.ledger()
    ck.reset_launches()  # the int8 version's count starts here
    stop = threading.Event()
    threads, done = run_clients(srv, "bert", pool, SERVE_CLIENTS, stop,
                                PUBLISH_MIN_REQUESTS // SERVE_CLIENTS)
    time.sleep(0.5)
    t_pub0 = time.perf_counter()
    srv.publish("bert", qdir)
    t_swap = time.perf_counter()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join()
    launches = dict(ck.LAUNCHES)
    want_warm = {k: 2 * len(SERVE_BUCKETS) * v for k, v in PER_REQUEST.items()}
    errors = [r for r in done if isinstance(r[1], BaseException)]
    matched = {"old": 0, "new": 0}
    during = []
    for i, out, ts, td in done:
        if isinstance(out, BaseException):
            continue
        d_old, d_new = l2_diff(out, old_out[i]), l2_diff(out, new_out[i])
        which = "new" if d_new < d_old else "old"
        near = max_diff(out, (new_out if which == "new" else old_out)[i])
        if near > SERVE_TOL or min(d_old, d_new) > apart[i] / 4:
            raise AssertionError(f"quant_serving: request {i} matches neither version (L2 to "
                                 f"bf16 {d_old}, to int8 {d_new}, apart {apart[i]})")
        if ts > t_swap and which != "new":
            raise AssertionError(f"quant_serving: request {i} submitted after the swap got "
                                 "the bf16 version's output")
        matched[which] += 1
        if td >= t_pub0 and ts <= t_swap:
            during.append((td - ts) * 1e3)
    led1 = srv.ledger()
    parity = [r for r in fluid.monitor.step_records() if r.get("kind") == "serving_event"
              and r.get("action") == "quant_parity"]
    after = registry.models()["bert"]
    emit({"phase": "quant_serving", "publish_s": t_swap - t_pub0, "requests": len(done),
          "errors": len(errors), "matched": matched,
          "p99_during_publish_ms": pct(during, 99), "versions_apart_l2": [min(apart), max(apart)],
          "versions_apart_max_abs": max(max_diff(a, b) for a, b in zip(old_out, new_out)),
          "quant_parity": [{k: r.get(k) for k in ("max_abs_diff", "atol")} for r in parity],
          "bytes": [before["bytes"], after["bytes"]],
          "precision": [before["precision"], after["precision"]],
          "publish_launches": launches, "card": card})
    if errors or led1["completed"] - led0["completed"] != len(done) or not led1["balanced"]:
        raise AssertionError(f"quant_serving: {len(errors)} dropped, ledger {led0} -> {led1}")
    if matched["old"] == 0 or matched["new"] == 0:
        raise AssertionError(f"quant_serving: the swap was not under load: {matched}")
    if len(parity) != 1 or not parity[0]["max_abs_diff"] <= parity[0]["atol"] == 5e-2:
        raise AssertionError(f"quant_serving: quant_parity events {parity}")
    if after["precision"] != "int8->bfloat16" or before["precision"] != "float32":
        raise AssertionError(f"quant_serving: precision {before['precision']} -> "
                             f"{after['precision']}")
    if launches != want_warm:
        raise AssertionError(f"quant_serving: the publish launched {launches}, want {want_warm} "
                             "(the smoke and a capture a bucket, a warm-up a bucket past 1)")
    # the served weights, bitwise from the dir's files
    version = registry.acquire("bert")
    for name, want in expect.items():
        got = fluid.core.dtypes.to_numpy(version.scope.find_var(name))
        if got.dtype != want.dtype or got.tobytes() != want.tobytes():
            raise AssertionError(f"quant_serving: served {name} is not its dequantized int8 "
                                 "payload bit for bit")
    del version
    # the int8 version under the same traffic: nothing launched, each
    # response its direct eager run's
    # (two rounds, as the bf16 version had; the second is the one compared)
    counters0 = counters_of(fluid, "executor.graph_capture", "executor.cache_miss")
    int8_first, int8_done = serve_round(srv, "bert", requests, "quant_serving int8", card)
    int8_record, int8_again = serve_round(srv, "bert", requests, "quant_serving int8", card)
    if dict(ck.LAUNCHES) != launches or counters_of(
            fluid, "executor.graph_capture", "executor.cache_miss") != counters0:
        raise AssertionError("quant_serving: the int8 version launched or captured under "
                             "traffic")
    eager = eager_predictor(fluid, qdir)
    worst = 0.0
    first = {i: out for i, out, _, _ in int8_done}
    for i, out, _, _ in int8_done:
        if (out.shape != (requests[i]["ids"].shape[0], 128, 768)
                or not np.isfinite(out.astype(np.float32)).all()):
            raise AssertionError(f"quant_serving: request {i} gave {out.shape}")
        worst = max(worst, max_diff(out, eager.run(requests[i])[0]))
    del eager
    again = max(max_diff(out, first[i]) for i, out, _, _ in int8_again)
    emit({"phase": "quant_serving", "bf16_first_round": bf16_first, "bf16": bf16_record,
          "int8_first_round": int8_first, "int8": int8_record,
          "int8_vs_direct_eager_max_abs": worst, "int8_rounds_max_abs": again,
          "tol": SERVE_TOL, "card": card})
    if not again <= SERVE_TOL:
        raise AssertionError(f"quant_serving: the int8 version's second round differs from its "
                             f"first by {again}")
    if not worst <= SERVE_TOL:
        raise AssertionError(f"quant_serving: an int8 response differs from its direct eager run "
                             f"by {worst} > {SERVE_TOL}")
    logger.write_snapshot()
    fluid.monitor.detach_logger(logger)
    run_tool("perf_report.py", "--check", telemetry, "--require-quant-parity",
             phase="quant_serving")
    # drifted scales: the parity rung rejects and quarantines the snapshot
    drift = os.path.join(tmp, "bert_base_int8_drift")
    shutil.copytree(qdir, drift)
    qpath = os.path.join(drift, "__quant__.json")
    with open(qpath) as f:
        qman = json.load(f)
    for rec in qman["weights"].values():
        rec["scale"] = (np.asarray(rec["scale"], np.float32) * QUANT_DRIFT).tolist()
    with open(qpath, "w") as f:
        json.dump(qman, f)
    probe = pool[:4]
    served = [srv.infer("bert", f)[0] for f in probe]
    try:
        srv.publish("bert", drift)
        raise AssertionError("quant_serving: the drifted int8 dir was published")
    except fluid.errors.ServingError as e:
        if e.reason != "publish_rejected" or "quant parity" not in str(e):
            raise
        rejected = str(e)[:300]
    marker = serving.quarantine_marker(drift)
    still = [srv.infer("bert", f)[0] for f in probe]
    emit({"phase": "quant_serving", "drifted_rejected": rejected,
          "quarantined": marker is not None, "card": card})
    if marker is None or os.path.realpath(drift) not in registry.quarantined:
        raise AssertionError("quant_serving: the drifted int8 dir was not quarantined")
    if not all(np.array_equal(a, b) for a, b in zip(served, still)):
        raise AssertionError("quant_serving: after the rejection the int8 version does not "
                             "serve bit for bit as before")
    return launches


def qat_resnet(fluid, torch, ck, tmp, card):
    """Phase 65 (see the module docstring): ResNet-50 bf16, QAT-trained,
    then deployed int8.  Returns the training steps' launches."""
    import numpy as np
    from paddle_tpu_torch.contrib import slim

    t0 = time.perf_counter()
    main, startup, fetches = build_resnet(fluid, "bfloat16", with_optimizer=True)
    n_fake = slim.quant_aware(main, weight_quantize_type="channel_wise_abs_max",
                              quantize_activations=False)
    loss = fetches["loss"].name
    derived = launches_of_program(main, loss)
    if derived != RESNET_PER_STEP:
        raise AssertionError(f"qat_resnet: the program's kernel ops {derived} != "
                             f"{RESNET_PER_STEP}")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {k: torch.from_numpy(v).cuda() for k, v in images(RESNET_TRAIN_BATCH, 65).items()}
    emit({"phase": "qat_resnet", "model": "resnet-50 bf16, Momentum lr 0.1 mu 0.9, "
          "quant_aware(channel_wise_abs_max, weights only)", "fake_quant_ops": n_fake,
          "batch": RESNET_TRAIN_BATCH, "setup_s": time.perf_counter() - t0, "card": card})
    ck.reset_launches()  # the main path's count starts here
    fluid.monitor.reset()
    losses, step_ms, graphed = [], [], []
    for step in range(QAT_STEPS):
        before = dict(ck.LAUNCHES)
        t1 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(out[0].reshape(-1)[0]))
        delta = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
        graphed.append(hold_run_launches(exe, step, delta, RESNET_PER_STEP, "qat_resnet",
                                         "qat_resnet"))
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"qat_resnet: step {step}: loss {losses[-1]}")
    launches = dict(ck.LAUNCHES)
    plan = exe.last_plan
    warm = statistics.median(step_ms[2:])
    emit({"phase": "qat_resnet", "losses": losses, "step_ms": step_ms, "graphed": graphed,
          "plan_graphed": plan.graphed, "graph_refusal": plan.graph_refusal,
          "warm_step_ms": warm, "images_per_s": RESNET_TRAIN_BATCH / warm * 1e3,
          "phase_10_warm_step_ms": WARM_STEP_MS.get("resnet_train"),
          "card": card})
    # the deployed path: the forward-only program instrumented the same way,
    # its running statistics calibrated on the batch
    fwd, _, ffetch = build_resnet(fluid, "bfloat16", with_optimizer=False)
    slim.quant_aware(fwd, weight_quantize_type="channel_wise_abs_max",
                     quantize_activations=False)
    missing = [p.name for p in fwd.all_parameters() if scope.find_var(p.name) is None]
    if missing:
        raise AssertionError(f"qat_resnet: the forward program's parameters {missing[:3]} are "
                             "not the trained ones")
    calibrate(fluid, fwd, exe, scope, feed)
    logits = ffetch["logits"].name
    wnames = [op.input("X")[0] for op in fwd.global_block().ops
              if op.type == "fake_channel_wise_quantize_abs_max"]
    batch = {"img": images(QAT_SERVE_BATCH, 650)["img"]}
    test = fwd.clone(for_test=True)
    got = exe.run(test, feed=batch, scope=scope,
                  fetch_list=[logits] + [f"{w}@QUANT" for w in wnames]
                  + [f"{w}@QSCALE" for w in wnames])
    ref, fq, sc = got[0], got[1:1 + len(wnames)], got[1 + len(wnames):]
    grid = 0.0
    for w, o, s in zip(wnames, fq, sc):
        axis = 1 if o.ndim == 2 else 0  # mul's Y [in, out], conv filters [O, I, kh, kw]
        shp = [1] * o.ndim
        shp[axis] = -1
        q = o.astype(np.float64) / np.maximum(s.astype(np.float64), 1e-8).reshape(shp) * 127.0
        grid = max(grid, float(np.abs(q - np.round(q)).max()))
    qat_dir = os.path.join(tmp, "resnet50_qat_int8")
    t1 = time.perf_counter()
    fluid.io.save_quantized_inference_model(qat_dir, ["img"], [logits], exe, fwd, scope,
                                            serve_dtype="bfloat16")
    save_s = time.perf_counter() - t1
    predictor = fluid.inference.create_predictor(fluid.inference.AnalysisConfig(qat_dir))
    before = dict(ck.LAUNCHES)
    (served,) = predictor.run(batch)
    request = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
    worst_ulps = 0.0
    for w, o in zip(wnames, fq):
        dep = fluid.core.dtypes.to_numpy(predictor.scope.find_var(w)).astype(np.float64)
        o = o.astype(np.float64)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(o), 2.0 ** -126))) - 7)
        worst_ulps = max(worst_ulps, float((np.abs(dep - o) / ulp).max()))
    gap = max_diff(served, ref)
    bound = SERVE_TOL * max(1.0, float(np.abs(ref).max()))
    emit({"phase": "qat_resnet", "deployed_dir_bytes": dir_bytes(qat_dir), "save_s": save_s,
          "quantized_weights": len(wnames), "grid_residual_max": grid,
          "deployed_vs_fake_quant_max_bf16_ulps": worst_ulps,
          "deployed_max_abs_logits": float(np.abs(served).max()),
          "instrumented_max_abs_logits": float(np.abs(ref).max()),
          "deployed_vs_instrumented_max_abs": gap, "bound": bound,
          "request_launches": request, "card": card})
    if not np.isfinite(served).all() or served.shape != (QAT_SERVE_BATCH, 1000):
        raise AssertionError(f"qat_resnet: deployed logits {served.shape}, finite "
                             f"{np.isfinite(served).all()}")
    if grid > 1e-3:
        raise AssertionError(f"qat_resnet: a fake-quantized weight lies {grid} of a step off "
                             "its per-channel int8 grid")
    if worst_ulps > 1.0:
        raise AssertionError(f"qat_resnet: a deployed weight lies {worst_ulps} bf16 ulps from "
                             "the instrumented program's fake-quantized weight")
    if not gap <= bound:
        raise AssertionError(f"qat_resnet: deployed logits {gap} off the instrumented forward "
                             f"(bound {bound})")
    if request != RESNET_PER_REQUEST:
        raise AssertionError(f"qat_resnet: a request launched {request}, want "
                             f"{RESNET_PER_REQUEST}")
    return launches


def quant_phases(fluid, torch, ck, tmp, card, bert_dir):
    """Phases 64-65, each's seconds printed; returns their launches."""
    quant_t0 = phase_t0 = time.perf_counter()
    served = quant_serving(fluid, torch, ck, tmp, card, bert_dir)
    emit({"phase_seconds": "quant_serving", "s": time.perf_counter() - phase_t0, "card": card})
    phase_t0 = time.perf_counter()
    trained = qat_resnet(fluid, torch, ck, tmp, card)
    emit({"phase_seconds": "qat_resnet", "s": time.perf_counter() - phase_t0, "card": card})
    emit({"phase_seconds": "phases 64-65", "s": time.perf_counter() - quant_t0, "card": card})
    return served, trained


# --- phases 66-68: dygraph --------------------------------------------------

DYGRAPH_RESNET_BATCH = 32
DYGRAPH_RESNET_LR = ([3, 5], [0.1, 0.01, 0.001])  # PiecewiseDecay from 0.1
DYGRAPH_PTB_LR = ([4], [1.0, 0.5])  # PiecewiseDecay at 1.0
DYGRAPH_PTB_CLIP = 5.0
DYGRAPH_RANDOM_DRAWS = ("dropout", "nce", "spectral_norm")  # two forwards: the next draws too
DYGRAPH_PARITY_RESNET = dict(size=64, batch=4, lr=([2], [0.01, 0.005]))
DYGRAPH_PARITY_PTB = dict(hidden=64, vocab=200, num_layers=2, num_steps=10, init_scale=0.05,
                          dropout=0.5)
DYGRAPH_PARITY_BATCH = 4
DYGRAPH_TOL = 1e-5  # one-op rule of phase 47: 1e-5 of max(1, the CPU's largest)


def dygraph_train(fluid, torch, ck, card, phase, model_name, build, units):
    """Phases 66-67: TRAIN_STEPS eager steps of `build()`'s model under
    `dygraph.guard()` (no place: CUDAPlace(0)), the launch counts reset just
    before and read just after; then one profiled step.  The peak memory
    is printed whole and above what was allocated before the model was
    built.  Returns the launches and the losses."""
    import numpy as np
    from paddle_tpu_torch.models import dygraph_cases as cases

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()  # what earlier phases left allocated
    with fluid.dygraph.guard():
        model, forward, opt, clip = build()
        devices = {p.value.device.type for p in model.parameters()}
        if devices != {"cuda"}:
            raise AssertionError(f"{phase}: parameters on {devices}, not the card")
        tape = fluid.dygraph.base._tape()
        emit({"phase": phase, "model": model_name, "setup_s": time.perf_counter() - t0,
              "parameters": sum(p.value.numel() for p in model.parameters()), "card": card})
        ck.reset_launches()  # the main path's count starts here
        losses, step_ms, entries = [], [], []
        for step in range(TRAIN_STEPS):
            t1 = time.perf_counter()
            loss = forward()
            entries.append(len(tape.entries))
            losses.append(cases.train_step(fluid, model, opt, loss, clip))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            emit({"phase": phase, "step": step, "loss": losses[-1], "step_ms": step_ms[-1],
                  "tape_entries": entries[-1], "card": card})
            if not np.isfinite(losses[-1]):
                raise AssertionError(f"{phase} step {step}: loss {losses[-1]}")
        launches = dict(ck.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        _, prof = profile_run(torch, f"{phase} step",
                              lambda: cases.train_step(fluid, model, opt, forward(), clip), card)
    if any(launches.values()):
        raise AssertionError(f"{phase}: the dygraph path launched the port's kernels: "
                             f"{ {k: v for k, v in launches.items() if v} }")
    warm = statistics.median(step_ms[2:])
    emit({"phase": phase, "losses": losses, "warm_step_ms": warm, "first_step_ms": step_ms[0],
          **{f"{k}_per_s": v / warm * 1e3 for k, v in units.items()},
          "tape_entries_per_step": entries[0], "peak_mem_gb": peak / 1e9,
          "peak_above_start_gb": (peak - start) / 1e9,
          "device_idle_share": prof["device_idle_share"],
          "host_aten_calls": prof["host_aten_calls"], "launches": launches, "card": card})
    return launches, losses


def dygraph_resnet(fluid, torch, ck, card):
    """Phase 66: ResNet-50 in dygraph (dygraph_cases.resnet at RESNET50),
    batch 32 at 224 x 224, f32, Momentum 0.9 on a PiecewiseDecay from 0.1,
    6 steps on one fixed batch: phase 10's loss rule, no kernel launched."""
    from paddle_tpu_torch.models import dygraph_cases as cases

    def build():
        model = cases.resnet(fluid, **cases.RESNET50)
        opt = fluid.optimizer.Momentum(fluid.dygraph.PiecewiseDecay(*DYGRAPH_RESNET_LR), 0.9)
        xv, yv = cases.images(DYGRAPH_RESNET_BATCH, 224, cases.RESNET50["class_dim"], 66)
        # the batch goes to the card once: loading data is set-up
        x = fluid.dygraph.to_variable(torch.from_numpy(xv).cuda())
        y = fluid.dygraph.to_variable(torch.from_numpy(yv).cuda())
        return model, lambda: model(x, y), opt, None

    launches, losses = dygraph_train(
        fluid, torch, ck, card, "dygraph_resnet",
        "resnet-50 dygraph f32 (Conv2D + BatchNorm bottlenecks, test_imperative_resnet.py), "
        "Momentum 0.9 on PiecewiseDecay from 0.1", build, {"images": DYGRAPH_RESNET_BATCH})
    if not (losses[1] < losses[0] and losses[-1] < losses[0]):
        raise AssertionError(f"dygraph_resnet: the loss did not fall: {losses}")
    return launches


def dygraph_ptb(fluid, torch, ck, card):
    """Phase 67: the medium PTB LSTM language model in dygraph (2 x
    BasicLSTMUnit at 650, vocab 10,000, 35 steps, batch 20, Dropout 0.5,
    uniform +-0.05), GradClipByGlobalNorm(5) written back, SGD on a
    PiecewiseDecay at 1.0, 6 steps on one batch of seeded ids: finite
    losses, the last below the first, no kernel launched."""
    from paddle_tpu_torch.models import dygraph_cases as cases

    cfg = cases.PTB_MEDIUM

    def build():
        model = cases.ptb(fluid, **cfg)
        opt = fluid.optimizer.SGD(fluid.dygraph.PiecewiseDecay(*DYGRAPH_PTB_LR))
        clip = fluid.dygraph_grad_clip.GradClipByGlobalNorm(DYGRAPH_PTB_CLIP)
        ids, labels = cases.tokens(cases.PTB_BATCH, cfg["num_steps"], cfg["vocab"], 67)
        return model, lambda: model(ids, labels), opt, clip

    launches, losses = dygraph_train(
        fluid, torch, ck, card, "dygraph_ptb",
        "PTB LM medium (Zaremba et al. 2014) dygraph f32, BasicLSTMUnit x 2, clip 5, SGD 1.0",
        build, {"tokens": cases.PTB_BATCH * cfg["num_steps"]})
    if not losses[-1] < losses[0]:
        raise AssertionError(f"dygraph_ptb: the loss did not fall: {losses}")
    return launches


def dygraph_close(worst, kind, name, got, want, tol=DYGRAPH_TOL):
    """Hold one card array against the CPU's within tol * max(1, |CPU|max);
    keeps the worst share a kind."""
    import numpy as np

    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"dygraph_parity {kind} {name}: shape {got.shape} != {want.shape}")
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    share = float(np.abs(got - want).max(initial=0.0)) / scale
    worst[kind] = max(worst.get(kind, (0.0, "")), (share, name))
    if not share <= tol:
        raise AssertionError(f"dygraph_parity {kind} {name}: card vs CPU {share} > {tol} "
                             f"of max(1, |CPU|)")


def dygraph_resnet_parity(fluid, cases, cpu, gpu, record):
    """ResNet-50 (dygraph) at 64 x 64, batch 4: 3 Momentum steps on the CPU;
    before each, the CPU's state (weights, statistics, velocities, the
    schedule's position) is loaded on the card, which takes the same step.
    Phase 11's rule: the loss within 1e-3 * max(1, |loss|), the running
    statistics within 1e-3 of their move, each velocity and update within
    0.2 of the CPU's in L2, the velocities' cosine at least 0.99; the conv
    biases a batch norm removes (gradient 0 in exact arithmetic) within
    1e-5."""
    import numpy as np

    p = DYGRAPH_PARITY_RESNET
    xv, yv = cases.images(p["batch"], p["size"], cases.RESNET50["class_dim"], 68)
    worst = {"loss": 0.0, "stat": (0.0, ""), "velocity": (0.0, ""), "update": (0.0, ""),
             "removed_bias": (0.0, "")}
    cosines = []
    with fluid.dygraph.guard(cpu):
        model = cases.resnet(fluid, **cases.RESNET50)
        opt = fluid.optimizer.Momentum(fluid.dygraph.PiecewiseDecay(*p["lr"]), 0.9)
        for step in range(PARITY_STEPS):
            state, vel = model.state_dict(), cases.velocities(model, opt)
            with fluid.dygraph.guard(gpu):
                g_model = cases.resnet(fluid, **cases.RESNET50)
                g_model.set_dict(state)
                g_opt = fluid.optimizer.Momentum(
                    fluid.dygraph.PiecewiseDecay(*p["lr"], begin=step), 0.9)
                cases.set_velocities(fluid, g_model, g_opt, vel)
                gl = cases.train_step(fluid, g_model, g_opt, g_model(
                    fluid.dygraph.to_variable(xv), fluid.dygraph.to_variable(yv)))
                g_after, g_vel = g_model.state_dict(), cases.velocities(g_model, g_opt)
            cl = cases.train_step(fluid, model, opt, model(
                fluid.dygraph.to_variable(xv), fluid.dygraph.to_variable(yv)))
            c_after, c_vel = model.state_dict(), cases.velocities(model, opt)
            worst["loss"] = max(worst["loss"], abs(gl - cl) / max(1.0, abs(cl)))
            dot = ng = nc = 0.0
            for n, want in c_after.items():
                got, before = g_after[n], state[n]
                if n.endswith(("._mean", "._variance")):
                    moved = float(np.abs(want - before).max())
                    worst["stat"] = max(worst["stat"], (float(np.abs(got - want).max())
                                                        / max(moved, 1e-30), n))
                elif n.endswith(".conv.bias"):
                    worst["removed_bias"] = max(worst["removed_bias"],
                                                (float(np.abs(got - want).max()), n))
                else:
                    upd = np.linalg.norm(want - before)
                    worst["update"] = max(worst["update"], (float(
                        np.linalg.norm(got - want) / max(upd, 1e-30)), n))
                    gv, cv = g_vel[n].astype(np.float64), c_vel[n].astype(np.float64)
                    worst["velocity"] = max(worst["velocity"], (float(
                        np.linalg.norm(gv - cv) / max(np.linalg.norm(cv), 1e-30)), n))
                    dot += float(np.sum(gv * cv))
                    ng += float(np.sum(gv * gv))
                    nc += float(np.sum(cv * cv))
            cosines.append(dot / np.sqrt(ng * nc))
            record.setdefault("resnet_losses_card_cpu", []).append((gl, cl))
    record.update({"resnet_worst": worst, "resnet_velocity_cosines": cosines})
    for what, limit in (("stat", 1e-3), ("velocity", 0.2), ("update", 0.2),
                        ("removed_bias", 1e-5)):
        if not worst[what][0] <= limit:
            raise AssertionError(f"dygraph_parity resnet {what} {worst[what][1]} off by "
                                 f"{worst[what][0]} > {limit}")
    if not worst["loss"] <= 1e-3 or not min(cosines) >= 0.99:
        raise AssertionError(f"dygraph_parity resnet: losses {record['resnet_losses_card_cpu']}"
                             f", cosines {cosines}")


def dygraph_parity(fluid, torch, ck, card, tmp):
    """Phase 68: the dygraph path on the card against the CPU in float32,
    a guard per evaluation: every layer case of dygraph_cases (forward, the
    next draws of the random ones, every parameter's and input's gradient,
    the state after), the 20 functionals, the eager rules and Lamb and DGC
    over 3 steps, the three clips, both rnn cells (DYGRAPH_TOL of max(1,
    the CPU's largest); losses 1e-3); ResNet-50 at 64 x 64 (phase 11's
    rule, dygraph_resnet_parity); the PTB model at width 64, vocab 200, 10
    steps, batch 4, 3 steps with dropout on (numpy's masks: the same on
    both; phase 7's rule: losses 1e-3, parameters DYGRAPH_TOL of max(1,
    |p|)); its state saved on the card and loaded on the CPU bit for bit.
    No kernel is launched."""
    import numpy as np
    from paddle_tpu_torch.models import dygraph_cases as cases

    cpu, gpu = fluid.CPUPlace(), fluid.CUDAPlace(0)
    worst, record = {}, {"phase": "dygraph_parity", "card": card}
    ck.reset_launches()
    for case in sorted(cases.LAYER_CASES):
        twice = case in DYGRAPH_RANDOM_DRAWS
        with fluid.dygraph.guard(cpu):
            c_init, c_outs, c_grads, c_after = cases.layer_run(fluid, case, twice=twice)
        with fluid.dygraph.guard(gpu):
            _, g_outs, g_grads, g_after = cases.layer_run(fluid, case, state=c_init, twice=twice)
        for i, (g, c) in enumerate(zip(g_outs, c_outs)):
            dygraph_close(worst, "layer_out", f"{case}[{i}]", g, c)
        if sorted(g_grads) != sorted(c_grads):
            raise AssertionError(f"dygraph_parity {case}: gradients of {sorted(g_grads)} "
                                 f"!= {sorted(c_grads)}")
        for n in c_grads:
            dygraph_close(worst, "layer_grad", f"{case}.{n}", g_grads[n], c_grads[n])
        for n in c_after:
            dygraph_close(worst, "layer_state", f"{case}.{n}", g_after[n], c_after[n])
    for case in sorted(cases.FUNCTIONAL_CASES):
        with fluid.dygraph.guard(cpu):
            c = cases.functional_run(fluid, case)
        with fluid.dygraph.guard(gpu):
            g = cases.functional_run(fluid, case)
        if g[0] != c[0]:
            raise AssertionError(f"dygraph_parity {case}: dtype {g[0]} != {c[0]}")
        dygraph_close(worst, "functional_out", case, g[1], c[1])
        for i, (gg, cg) in enumerate(zip(g[2], c[2])):
            if (gg is None) != (cg is None):
                raise AssertionError(f"dygraph_parity {case}: gradient {i} None on one side")
            if cg is not None:
                dygraph_close(worst, "functional_grad", f"{case}[{i}]", gg, cg)
    for which in sorted(cases.OPTIMIZERS):
        with fluid.dygraph.guard(cpu):
            c_losses, c_states = cases.train_linear(fluid, cases.OPTIMIZERS[which])
        with fluid.dygraph.guard(gpu):
            g_losses, g_states = cases.train_linear(fluid, cases.OPTIMIZERS[which])
        dygraph_close(worst, "optimizer_loss", which, g_losses, c_losses, tol=1e-3)
        for step, (gs, cs) in enumerate(zip(g_states, c_states)):
            for n in cs:
                dygraph_close(worst, "optimizer_param", f"{which}[{step}].{n}", gs[n], cs[n])
    for which in sorted(cases.CLIPS):
        with fluid.dygraph.guard(cpu):
            c = cases.clip_run(fluid, which)
        with fluid.dygraph.guard(gpu):
            g = cases.clip_run(fluid, which)
        for (_, gg), (_, cg) in zip(g, c):
            if cg is not None:
                dygraph_close(worst, "clip", which, gg, cg)
    for cell in ("lstm", "gru"):
        with fluid.dygraph.guard(cpu):
            c = cases.cell_run(fluid, cell)
        with fluid.dygraph.guard(gpu):
            g = cases.cell_run(fluid, cell, state=c[3])
        for i, (go, co) in enumerate(zip(g[0], c[0])):
            dygraph_close(worst, "cell", f"{cell}.out{i}", go, co)
        for n in c[1]:
            dygraph_close(worst, "cell", f"{cell}.{n}", g[1][n], c[1][n])
        for i, (gg, cg) in enumerate(zip(g[2], c[2])):
            if cg is not None:
                dygraph_close(worst, "cell", f"{cell}.input{i}", gg, cg)
    dygraph_resnet_parity(fluid, cases, cpu, gpu, record)
    runs = {}
    for name, place in (("cpu", cpu), ("card", gpu)):
        with fluid.dygraph.guard(place):
            model = cases.ptb(fluid, **DYGRAPH_PARITY_PTB)
            model(*cases.tokens(DYGRAPH_PARITY_BATCH, DYGRAPH_PARITY_PTB["num_steps"],
                                DYGRAPH_PARITY_PTB["vocab"], 0))  # the cells' weights
            if name == "card":
                model.set_dict(runs["cpu"][0])
            opt = fluid.optimizer.SGD(fluid.dygraph.PiecewiseDecay(*DYGRAPH_PTB_LR))
            clip = fluid.dygraph_grad_clip.GradClipByGlobalNorm(DYGRAPH_PTB_CLIP)
            ids, labels = cases.tokens(DYGRAPH_PARITY_BATCH, DYGRAPH_PARITY_PTB["num_steps"],
                                       DYGRAPH_PARITY_PTB["vocab"], 68)
            model.drop._rng = np.random.RandomState(0)  # both runs draw the same masks
            initial = model.state_dict()
            losses, states = [], []
            for _ in range(PARITY_STEPS):
                losses.append(cases.train_step(fluid, model, opt, model(ids, labels), clip))
                states.append(model.state_dict())
            runs[name] = (initial, losses, states)
            if name == "card":
                ckpt = os.path.join(tmp, "dygraph_ptb")
                fluid.dygraph.save_persistables(model, ckpt)
    dygraph_close(worst, "ptb_loss", "losses", runs["card"][1], runs["cpu"][1], tol=1e-3)
    for step, (gs, cs) in enumerate(zip(runs["card"][2], runs["cpu"][2])):
        for n in cs:
            dygraph_close(worst, "ptb_param", f"[{step}].{n}", gs[n], cs[n])
    loaded = fluid.dygraph.load_persistables(ckpt)
    with fluid.dygraph.guard(cpu):
        model = cases.ptb(fluid, **DYGRAPH_PARITY_PTB)
        model(*cases.tokens(DYGRAPH_PARITY_BATCH, DYGRAPH_PARITY_PTB["num_steps"],
                            DYGRAPH_PARITY_PTB["vocab"], 0))
        model.set_dict(loaded)
        back = model.state_dict()
    card_final = runs["card"][2][-1]
    if list(back) != list(card_final) or not all(
            np.array_equal(back[n], card_final[n]) for n in card_final):
        raise AssertionError("dygraph_parity: the card's checkpoint did not load bit for bit")
    launches = dict(ck.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"dygraph_parity launched the port's kernels: {launches}")
    emit({**record, "ptb_losses_card": runs["card"][1], "ptb_losses_cpu": runs["cpu"][1],
          "worst_share": worst, "tol": DYGRAPH_TOL, "checkpoint_bitwise": True,
          "layer_cases": len(cases.LAYER_CASES), "functional_cases": len(cases.FUNCTIONAL_CASES),
          "optimizer_cases": len(cases.OPTIMIZERS)})
    return launches


def dygraph_phases(fluid, torch, ck, tmp, card):
    """Phases 66-68; their seconds printed.  Returns each path's launches."""
    out = {}
    t0 = time.perf_counter()
    for phase, run in (("dygraph_resnet", lambda: dygraph_resnet(fluid, torch, ck, card)),
                       ("dygraph_ptb", lambda: dygraph_ptb(fluid, torch, ck, card)),
                       ("dygraph_parity", lambda: dygraph_parity(fluid, torch, ck, card, tmp))):
        phase_t0 = time.perf_counter()
        out[phase] = run()
        emit({"phase_seconds": phase, "s": time.perf_counter() - phase_t0, "card": card})
    emit({"phase_seconds": "phases 66-68", "s": time.perf_counter() - t0, "card": card})
    return out


# phases 69-72: the host parameter-server tier and the chaos campaign.  The
# two tables of phase 15's DeepFM live on a supervised pserver child (a
# host process: the card never sees them whole), each a TieredEmbedding
# whose hot quarter trains in this process (bench.py bench_online's split);
# the device program is deepfm_net's arithmetic over the two pulled blocks
HOST_TABLE_STEPS = 32
HOST_TABLE_PUBLISH_EVERY = 8
HOST_TABLE_LR = 0.05  # the tiers' SGD and the pserver's
HOST_TABLE_SNAPSHOT_OPS = 64
HOST_TABLE_PER_STEP = dict(NONE, adam=8)  # the 4 fc layers' weights and biases
# bench.py bench_online's kill, tests/test_compound_faults.py:176's rotted snapshot
HOST_TABLE_SPEC = "kill_pserver@18;rot_row@1"
HOST_TABLE_SERVE_TOL = 1e-5
HOST_TABLE_PARITY_STEPS = 3
FUSED_PARITY = ((128, 32), (2048, 1))  # phase 14's (seq_len, batch)
HOST_TABLE_MAX_STALENESS = 16  # two publish periods
HOST_TABLE_MAX_LAG = 8  # one publish period
CHAOS_SEED, CHAOS_PLANTED_SEED = 20, 8  # tools/chaos_campaign.py's smoke seeds


def host_table_dims(config):
    return {"deepfm_w": 1, "deepfm_v": config["embed_dim"]}


def build_host_deepfm(fluid, config, make_optimizer):
    """deepfm_net's arithmetic (paddle_tpu_torch/models/deepfm.py) over the
    two pulled blocks as feeds, w_emb [B, F, 1] and v_emb [B, F, K], with
    its sigmoid cross-entropy; calc_gradient taps both feeds, and
    `make_optimizer()` updates the MLP's parameters, the only ones the
    program has.  Returns (main, startup, loss, [d w_emb, d v_emb])."""
    layers = fluid.layers
    nf, k = config["num_fields"], config["embed_dim"]
    with fluid.unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            w_emb = layers.data("w_emb", [nf, 1], dtype="float32")
            v_emb = layers.data("v_emb", [nf, k], dtype="float32")
            label = layers.data("label", [1], dtype="float32")
            first_order = layers.reduce_sum(w_emb, dim=[1, 2], keep_dim=False)
            sum_sq = layers.square(layers.reduce_sum(v_emb, dim=[1]))
            sq_sum = layers.reduce_sum(layers.square(v_emb), dim=[1])
            fm = layers.reduce_sum(sum_sq - sq_sum, dim=[1]) * 0.5
            deep = layers.reshape(v_emb, [-1, nf * k])
            for d in config["mlp_dims"]:
                deep = layers.fc(deep, size=d, act="relu")
            logit = layers.reshape(first_order + fm, [-1, 1]) + layers.fc(deep, size=1)
            loss = layers.mean(layers.sigmoid_cross_entropy_with_logits(logit, label))
            grads = fluid.calc_gradient(loss, [w_emb, v_emb])
            make_optimizer().minimize(loss)
    startup.random_seed = main.random_seed = 0
    return main, startup, loss, grads


def host_table_state(fluid, config):
    """The host program's persistables after its startup on the CPU, as
    numpy: every run of phases 69-71 starts its dense state from them."""
    main, startup, _, _ = build_host_deepfm(fluid, config, lambda: fluid.optimizer.Adam(1e-3))
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return {v.name: scope.to_numpy(v.name).copy() for v in main.list_vars() if v.persistable}


def host_tables(fluid, client, config, degraded_ok=False):
    """Both tables as TieredEmbeddings over `client`: the hot quarter here,
    the cold rest created on the pserver; seeded, so every run starts from
    the same tables."""
    from paddle_tpu_torch.parallel import TieredEmbedding

    v = config["vocab_size"]
    return {name: TieredEmbedding(client, name, v, dim, hot_rows=v // 4, lr=HOST_TABLE_LR,
                                  degraded_ok=degraded_ok, seed=seed)
            for seed, (name, dim) in enumerate(host_table_dims(config).items(), 1)}


def host_feed(tables, ids, label):
    return {"w_emb": tables["deepfm_w"].lookup(ids), "v_emb": tables["deepfm_v"].lookup(ids),
            "label": label}


def host_apply(tables, ids, grads):
    import numpy as np

    for (name, t), g in zip(tables.items(), grads):
        t.apply_grad(ids.reshape(-1), np.asarray(g).reshape(-1, t.dim))


def host_table_values(tables):
    """Every row of each table (the hot head here, the cold tail fetched)."""
    return {name: t.export_selected_rows().values.numpy() for name, t in tables.items()}


def serving_deepfm(fluid, config):
    """deepfm.build(is_sparse=True)'s test program: (program, prediction)."""
    from paddle_tpu_torch.models import deepfm

    with fluid.unique_name.guard():
        main, _, _, fetches = deepfm.build(with_optimizer=False, is_sparse=True, **config)
    return main.clone(for_test=True), fetches["prediction"]


def host_table_run(fluid, torch, ck, tmp, card, phase, init, spec=None):
    """Phases 69 and 70: phase 15's DeepFM at full width, batch 4096, its two
    tables on one supervised pserver child (SGD, HOST_TABLE_LR, a snapshot
    every HOST_TABLE_SNAPSHOT_OPS ops), HOST_TABLE_STEPS steps of
    deepfm_feed batches (seeds 0-31) under resilient_train_loop
    (max_inflight 1, log_period 1): the loader pulls the rows, the device
    step runs Adam over the 8 MLP parameters (HOST_TABLE_PER_STEP launches
    a step, held run by run), on_logged pushes each table's row gradient,
    and the publish hook exports both tables every HOST_TABLE_PUBLISH_EVERY
    steps, saves them with io.save_sharded and publishes them into a card
    ModelRegistry serving deepfm.build(is_sparse=True)'s test program, whose
    predictions on a fixed batch must lie within HOST_TABLE_SERVE_TOL of an
    Executor run of that program on the exported tables.  With `spec` the
    run goes through its faults (KVClient retries 8 from 0.2 s, no degraded
    mode): a rejected publish must be quarantined with the last good
    version serving on bit for bit.  The metrics stream passes perf_report's
    staleness and host-lag gates.  Returns (the final state: each table's
    rows and the dense parameters; the wrappers' launches; the record)."""
    import numpy as np

    from paddle_tpu_torch import monitor, serving
    from paddle_tpu_torch.param_server import PS_COMMITTED, KVClient, PServerSupervisor
    from tools.perf_report import publish_staleness_steps

    t0 = time.perf_counter()
    root = os.path.join(tmp, phase)
    os.makedirs(root)
    main, startup, loss, grads = build_host_deepfm(fluid, DEEPFM, lambda: fluid.optimizer.Adam(1e-3))
    derived = launches_of_program(main, loss)
    if derived != HOST_TABLE_PER_STEP:
        raise AssertionError(f"{phase}: the program's kernel ops {derived} != {HOST_TABLE_PER_STEP}")
    dense = [p.name for p in main.all_parameters()]
    serve_prog, pred = serving_deepfm(fluid, DEEPFM)
    serve_names = [v.name for v in fluid.io._persistables(serve_prog)]
    sup = PServerSupervisor(os.path.join(root, "ps"), optimizer="sgd", lr=HOST_TABLE_LR,
                            snapshot_every_ops=HOST_TABLE_SNAPSHOT_OPS).start()
    client = None
    logger = monitor.attach_logger(monitor.MonitorLogger(os.path.join(root, "metrics.jsonl")))
    try:
        sup.wait_ready()
        client = KVClient(sup.endpoint, retries=8, backoff_base_s=0.2)
        rpc = {"pull": [], "push": []}  # ms of each RPC, retries included

        def timed(op, fn):
            def call(*args):
                t = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    rpc[op].append((time.perf_counter() - t) * 1e3)
            return call

        tables = host_tables(fluid, client, DEEPFM)
        client.pull, client.push = timed("pull", client.pull), timed("push", client.push)
        hot_rows = DEEPFM["vocab_size"] // 4
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        fluid.io.load_numpy_params(scope, init, device="cuda:0")
        # the served model's first version: the tables and the MLP at step 0
        first = fluid.Scope()
        for name, rows in host_table_values(tables).items():
            first.set_var(name, rows)
        for n in dense:
            first.set_var(n, init[n])
        d0 = os.path.join(root, "model-0")
        fluid.io.save_inference_model(d0, ["feat_ids"], [pred], fluid.Executor(fluid.CPUPlace()),
                                      serve_prog, first)
        reg = serving.ModelRegistry(place=fluid.CUDAPlace(0))
        reg.load("deepfm", d0)
        probe = {"feat_ids": deepfm_feed(64, DEEPFM, 99)["feat_ids"]}
        served = {"out": np.asarray(reg.acquire("deepfm").run(probe)[0]).copy()}
        serve_exe = fluid.Executor(fluid.CUDAPlace(0))
        injector = fluid.FaultInjector(spec).set_pserver(sup) if spec else None
        setup_s = time.perf_counter() - t0

        batches = [deepfm_feed(DEEPFM_BATCH, DEEPFM, s) for s in range(HOST_TABLE_STEPS)]
        lookup_ms, push_ms, publish_ms, wall_ms, losses, uniq = [], [], {}, [], [], []
        marks = {"t": None, "launches": dict(ck.LAUNCHES)}

        def loader():
            for b in batches:
                t = time.perf_counter()
                feed = host_feed(tables, b["feat_ids"], b["label"])
                lookup_ms.append((time.perf_counter() - t) * 1e3)
                uniq.append(int(np.unique(b["feat_ids"][b["feat_ids"] >= hot_rows]).size))
                yield feed

        def on_logged(step, vals):
            delta = {k: ck.LAUNCHES[k] - marks["launches"][k] for k in ck.LAUNCHES}
            hold_run_launches(exe, step, delta, HOST_TABLE_PER_STEP, f"{phase} step {step}",
                              "host_table_deepfm" if spec is None else None)
            losses.append(float(np.asarray(vals[0]).reshape(-1)[0]))
            t = time.perf_counter()
            host_apply(tables, batches[step]["feat_ids"], vals[1:])
            now = time.perf_counter()
            push_ms.append((now - t) * 1e3)
            if marks["t"] is not None:
                wall_ms.append((now - marks["t"]) * 1e3)
            marks["t"], marks["launches"] = now, dict(ck.LAUNCHES)

        def publish_hook(step):
            t = time.perf_counter()
            d = os.path.join(root, f"snap-{step:06d}")
            pub = fluid.Scope()
            for name, table in tables.items():
                pub.set_var(name, table.export_selected_rows())
            for n in dense:
                pub.set_var(n, scope.to_numpy(n))
            fluid.io.save_sharded(d, serve_names, pub, program=serve_prog, process_index=0)
            if injector is not None:
                injector.on_commit(d)
            try:
                serving.publish(reg, "deepfm", d)
            except fluid.errors.ServingError as e:
                publish_ms[step] = ("rejected", (time.perf_counter() - t) * 1e3, str(e)[:160])
                still = np.asarray(reg.acquire("deepfm").run(probe)[0])
                if serving.quarantine_marker(d) is None or not np.array_equal(still, served["out"]):
                    raise AssertionError(f"{phase}: the rejected snapshot at step {step} was not "
                                         "quarantined, or the last good version stopped serving")
                raise
            publish_ms[step] = ("published", (time.perf_counter() - t) * 1e3)
            out = np.asarray(reg.acquire("deepfm").run(probe)[0]).copy()
            ref = fluid.Scope()
            for name in tables:
                ref.set_var(name, np.asarray(pub.find_var(name)))
            for n in dense:
                ref.set_var(n, pub.find_var(n))
            (want,) = serve_exe.run(serve_prog, feed=probe, fetch_list=[pred], scope=ref)
            diff = float(np.abs(out - want).max())
            emit({"phase": phase, "publish_at": step, "served_vs_executor_max_abs": diff,
                  "tol": HOST_TABLE_SERVE_TOL})
            if not diff <= HOST_TABLE_SERVE_TOL:
                raise AssertionError(f"{phase}: the version published at step {step} serves "
                                     f"{diff} off the Executor")
            served["out"] = out

        ck_before = dict(ck.LAUNCHES)
        if spec is None:
            ck.reset_launches()  # the main path's count starts here
            marks["launches"] = dict(ck.LAUNCHES)
        t_loop = time.perf_counter()
        stats = fluid.resilient_train_loop(
            exe, main, loader, [loss] + list(grads), scope=scope, injector=injector,
            max_inflight=1, log_period=1, on_logged=on_logged, publish_hook=publish_hook,
            publish_period_steps=HOST_TABLE_PUBLISH_EVERY,
            policy=fluid.RetryPolicy(backoff_base_s=0.0))
        loop_s = time.perf_counter() - t_loop
        launches = dict(ck.LAUNCHES) if spec is None else ck_before
        final = host_table_values(tables)
        final.update({n: scope.to_numpy(n).copy() for n in dense})
        # the steps that published: their publish seconds come off their wall
        pub_steps = set(publish_ms)
        warm = [w for s, w in enumerate(wall_ms, 1) if s > 1 and s not in pub_steps]
        lookup_w = statistics.median(lookup_ms[2:])
        push_w = statistics.median(push_ms[2:])
        rows = statistics.mean(uniq)
        # each step pulls and pushes once a table: the RPCs' share of its
        # lookup and apply_grad (the rest is the client's numpy)
        pull_rpc = statistics.median(a + b for a, b in zip(rpc["pull"][4::2], rpc["pull"][5::2]))
        push_rpc = statistics.median(a + b for a, b in zip(rpc["push"][4::2], rpc["push"][5::2]))
        # a probe of the journal's cost: a record the size of the V table's
        # push (ids and rows of the step's cold rows), appended here through
        # io.append_record on the pserver's disk, with and without its fsync
        # (the child's own appends are not timed apart)
        record = b"S" * int(rows * (8 + 4 * DEEPFM["embed_dim"]))
        journal = {}
        for fsync in (True, False):
            path = os.path.join(root, f"journal-probe-{fsync}.log")
            times = []
            for _ in range(5):
                t = time.perf_counter()
                fluid.io.append_record(path, record, fsync=fsync)
                times.append((time.perf_counter() - t) * 1e3)
            journal["fsync" if fsync else "no_fsync"] = statistics.median(times)
        wall_w = statistics.median(warm)
        dims = host_table_dims(DEEPFM)
        time.sleep(3 * sup._beat_interval)  # a beat after the last push
        tel = sup._health.poll()[0].get("tel") or {}
        ops, ps_snapshots = tel.get("ops"), tel.get("snapshots")
        snaps = [d for d in os.listdir(sup.snapshot_dir) if d.startswith("snap-")
                 and os.path.exists(os.path.join(sup.snapshot_dir, d, PS_COMMITTED))]
        logger.write_snapshot()
        with open(logger.path) as f:
            staleness = publish_staleness_steps([json.loads(ln) for ln in f if ln.strip()])
        record = {
            "phase": phase, "model": "deepfm f32, 26 fields, vocab 200000, embed 16, mlp 400x3, "
            "tables on a pserver child (hot quarter in process)", "batch": DEEPFM_BATCH,
            "fault_spec": spec, "steps": stats.steps, "losses": losses, "setup_s": setup_s,
            "loop_s": loop_s, "examples_per_s": DEEPFM_BATCH / wall_w * 1e3,
            "warm_step_ms": wall_w, "split_ms": {
                "lookup": lookup_w, "apply_grad": push_w,
                "executor_and_loop": wall_w - lookup_w - push_w,
                "lookup_pull_rpcs": pull_rpc, "apply_grad_push_rpcs": push_rpc,
                "journal_probe_of_a_v_push": journal, "journal_record_bytes": len(record)},
            "cold_rows_pulled_per_table": rows,
            "wire_bytes_per_step": sum(2 * rows * (8 + 4 * d) for d in dims.values()),
            "card_bytes_per_step": 2 * DEEPFM_BATCH * DEEPFM["num_fields"] * 4 * sum(dims.values()),
            "publishes": {str(s): v for s, v in sorted(publish_ms.items())},
            "publish_failures": stats.publish_failures, "max_publish_staleness_steps": staleness,
            "pserver_ops": ops, "ps_snapshots": ps_snapshots,
            "committed_snapshots_on_disk": sorted(snaps), "pserver_restarts": sup.restarts,
            "ps_retries": monitor.counter("ps.retries").value,
            "graphed": exe.last_plan.graphed, "graph_refusal": exe.last_plan.graph_refusal,
            "card": card}
        emit(record)
        if stats.steps != HOST_TABLE_STEPS or not np.isfinite(losses).all() \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"{phase}: {stats.steps} steps, losses {losses}")
        if ops is None or ops < 2 + 2 * HOST_TABLE_STEPS:
            raise AssertionError(f"{phase}: the pserver applied {ops} ops")
        run_tool("perf_report.py", "--check", logger.path, "--steady-after", "100000",
                 "--max-publish-staleness-steps", str(HOST_TABLE_MAX_STALENESS),
                 "--max-host-lag-steps", str(HOST_TABLE_MAX_LAG), phase=phase)
        if spec is None:
            b = batches[0]

            def step():
                feed = host_feed(tables, b["feat_ids"], b["label"])
                out = exe.run(main, feed=feed, fetch_list=[loss] + list(grads), scope=scope)
                host_apply(tables, b["feat_ids"], out[1:])

            profile_replay(torch, f"{phase} step (pull, device step, push)", step, card,
                           HOST_TABLE_PER_STEP)
        return {"final": final, "launches": launches, "record": record,
                "publishes": publish_ms, "restarts": sup.restarts}
    finally:
        monitor.detach_logger(logger)
        logger.close()
        if client is not None:
            client.close()
        sup.stop()


def host_table_chaos(fluid, torch, ck, tmp, card, init, clean):
    """Phase 70: phase 69's run again under HOST_TABLE_SPEC: the pserver
    child SIGKILLed at step 18's dispatch (KVClient rides the respawn out,
    the journal replays) and the second published snapshot's values shard
    rotted.  All 32 steps run, the supervisor restarted the child, the
    rotted publish was rejected and quarantined while the first version
    served on, and every hot row, every cold row and every MLP parameter is
    bitwise equal to phase 69's: exactly-once pushes and a bit-identical
    recovery at full width."""
    import numpy as np

    run = host_table_run(fluid, torch, ck, tmp, card, "host_table_chaos", init,
                         spec=HOST_TABLE_SPEC)
    outcomes = [v[0] for _, v in sorted(run["publishes"].items())]
    differ = sorted(n for n, a in clean["final"].items()
                    if not np.array_equal(a, run["final"][n]))
    emit({"phase": "host_table_chaos", "publish_outcomes": outcomes,
          "pserver_restarts": run["restarts"], "bitwise_equal_to_host_table_deepfm": not differ,
          "differing": differ, "card": card})
    if run["restarts"] < 1:
        raise AssertionError("host_table_chaos: kill_pserver never restarted the child")
    if outcomes != ["published", "rejected", "published"]:
        raise AssertionError(f"host_table_chaos: publishes {outcomes} != the rotted second "
                             "one alone rejected")
    if differ:
        raise AssertionError(f"host_table_chaos: {differ} differ from the clean run")


def host_table_steps(fluid, exe, main, loss, grads, scope, tables, batches):
    """Pull, device step, push for each batch (pull after the previous
    push: tests/test_param_server.py's order); returns the losses."""
    out = []
    for b in batches:
        vals = exe.run(main, feed=host_feed(tables, b["feat_ids"], b["label"]),
                       fetch_list=[loss] + list(grads), scope=scope)
        out.append(float(vals[0].reshape(-1)[0]))
        host_apply(tables, b["feat_ids"], vals[1:])
    return out


def within_largest(want, got, names, excused=None, flip_tol=0.0):
    """The worst share of 1e-5 * max|want| any of `names` reaches (phase 16's
    rule), the elements in `excused` held to flip_tol + that instead."""
    import numpy as np

    worst, worst_name = 0.0, ""
    for n in names:
        err = np.abs(got[n].astype(np.float64) - want[n])
        tol = 1e-5 * max(float(np.abs(want[n]).max()), 1e-30)
        if excused is not None and n in excused:
            if not float(err.max()) <= tol + flip_tol:
                raise AssertionError(f"{n} differs by {float(err.max())}")
            err = err[~excused[n]]
        share = float(err.max()) / tol if err.size else 0.0
        if share > worst:
            worst, worst_name = share, n
    return worst, worst_name


def host_table_parity(fluid, torch, card):
    """Phase 71, float32 at DEEPFM_PARITY (the MLP cut to 64 x 64), batch
    512, HOST_TABLE_PARITY_STEPS steps, pull after push.  (a) The host-tier
    run with Adam(1e-3) on the card against the same on the CPU, each over
    an in-process ParameterServer made from the same tables: losses within
    1e-5 relative, the MLP parameters and both tables within 1e-5 of their
    largest magnitude (the Adam elements whose CPU gradient is 0 to
    rounding, ZERO_GRAD, move +-lr by its sign: 2*lr*steps + 1e-5).  (b) On
    the card, the host-tier run with SGD(HOST_TABLE_LR) everywhere against
    the in-program deepfm.build(is_sparse=True) with SGD(HOST_TABLE_LR) (its
    tables SelectedRows-updated on the card): the same rule for losses,
    tables and parameters (tests/test_param_server.py:30's contract at
    DeepFM's shape)."""
    import numpy as np

    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.param_server import KVClient, ParameterServer

    batches = [deepfm_feed(DEEPFM_PARITY_BATCH, DEEPFM_PARITY, 40 + s)
               for s in range(HOST_TABLE_PARITY_STEPS)]
    runs = {}
    for arm, place, opt in (("card", fluid.CUDAPlace(0), "adam"), ("cpu", fluid.CPUPlace(), "adam"),
                            ("card_sgd", fluid.CUDAPlace(0), "sgd")):
        make = ((lambda: fluid.optimizer.Adam(1e-3)) if opt == "adam"
                else (lambda: fluid.optimizer.SGD(HOST_TABLE_LR)))
        main, startup, loss, grads = build_host_deepfm(fluid, DEEPFM_PARITY, make)
        state = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=state)
        init = {v.name: state.to_numpy(v.name).copy() for v in main.list_vars() if v.persistable}
        dense = [p.name for p in main.all_parameters()]
        srv = ParameterServer(optimizer="sgd", lr=HOST_TABLE_LR).start()
        client = KVClient(srv.endpoint)
        try:
            tables = host_tables(fluid, client, DEEPFM_PARITY)
            start_tables = host_table_values(tables)
            exe = fluid.Executor(place)
            scope = fluid.Scope()
            fluid.io.load_numpy_params(scope, init, device=place.device)
            near_zero = {}
            if arm == "cpu":  # the Adam elements whose gradient is 0 to rounding
                gnames = [f"{p}@GRAD" for p in dense]
                losses = []
                for b in batches:
                    out = exe.run(main, feed=host_feed(tables, b["feat_ids"], b["label"]),
                                  fetch_list=[loss] + list(grads) + gnames, scope=scope)
                    losses.append(float(out[0].reshape(-1)[0]))
                    host_apply(tables, b["feat_ids"], out[1:3])
                    peak = max(float(np.abs(g).max()) for g in out[3:])
                    for p, g in zip(dense, out[3:]):
                        small = np.abs(g) <= ZERO_GRAD * peak
                        near_zero[p] = small | near_zero[p] if p in near_zero else small
            else:
                losses = host_table_steps(fluid, exe, main, loss, grads, scope, tables, batches)
            final = host_table_values(tables)
            final.update({n: scope.to_numpy(n).copy() for n in dense})
            runs[arm] = {"losses": losses, "final": final, "init": init,
                         "near_zero": near_zero, "start_tables": start_tables}
        finally:
            client.close()
            srv.stop()
    # (b)'s reference: the in-program sparse DeepFM from the same start
    with fluid.unique_name.guard():
        main, startup, _, fetches = deepfm.build(is_sparse=True, opt="sgd",
                                                 learning_rate=HOST_TABLE_LR, **DEEPFM_PARITY)
    start = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=start)
    scope = fluid.Scope()
    init = dict(runs["card_sgd"]["init"])
    init.update(runs["card_sgd"]["start_tables"])
    for v in main.list_vars():
        if v.persistable and v.name not in init:
            init[v.name] = start.to_numpy(v.name)
    fluid.io.load_numpy_params(scope, init, device="cuda:0")
    in_losses = []
    for b in batches:
        (lv,) = exe.run(main, feed=b, fetch_list=[fetches["loss"]], scope=scope)
        in_losses.append(float(lv.reshape(-1)[0]))
    in_final = {n: scope.to_numpy(n).copy() for n in runs["card_sgd"]["final"]}
    a, c, s = runs["card"], runs["cpu"], runs["card_sgd"]
    lr_adam = 1e-3
    flip_tol = 2 * lr_adam * HOST_TABLE_PARITY_STEPS + 1e-5
    worst_a, name_a = within_largest(c["final"], a["final"], list(c["final"]), c["near_zero"],
                                     flip_tol)
    worst_b, name_b = within_largest(in_final, s["final"], list(in_final))
    dloss_a = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], c["losses"]))
    dloss_b = max(abs(x - y) / abs(y) for x, y in zip(s["losses"], in_losses))
    emit({"phase": "host_table_parity", "model": "deepfm f32, 26 fields, vocab 200000, embed 16, "
          "mlp 64x64, tables on an in-process pserver", "batch": DEEPFM_PARITY_BATCH,
          "steps": HOST_TABLE_PARITY_STEPS,
          "card_vs_cpu": {"losses_card": a["losses"], "losses_cpu": c["losses"],
                          "max_rel_dloss": dloss_a, "worst_share_of_tol": worst_a, "worst": name_a,
                          "elements_with_gradient_0_to_rounding":
                              int(sum(m.sum() for m in c["near_zero"].values()))},
          "host_tier_vs_in_program": {"losses_host_tier": s["losses"], "losses_in_program":
                                      in_losses, "max_rel_dloss": dloss_b,
                                      "worst_share_of_tol": worst_b, "worst": name_b},
          "tol": "losses 1e-5 relative, state 1e-5 * max|reference|", "card": card})
    if not (dloss_a <= 1e-5 and worst_a <= 1.0):
        raise AssertionError(f"host_table_parity: card vs CPU losses {dloss_a}, {name_a} "
                             f"{worst_a}x its tolerance")
    if not (dloss_b <= 1e-5 and worst_b <= 1.0):
        raise AssertionError(f"host_table_parity: host tier vs in-program losses {dloss_b}, "
                             f"{name_b} {worst_b}x its tolerance")


def chaos_campaign(fluid, torch, card, tmp):
    """Phase 72: chaos.run_campaign over train, online and serving at the
    smoke's seed, one schedule each, on the card (place=CUDAPlace(0)) and on
    the CPU: no violation, the same specs and verdicts, the card's metrics
    through perf_report --check --max-chaos-violations 0.  Then the planted
    defect (PADDLE_CHAOS_PLANTED_BUG, seed CHAOS_PLANTED_SEED) on the CPU:
    caught by bit_identical_recovery and shrunk to <= 2 faults; on the card
    the whole planted arm too, which must give the CPU's spec and shrunk
    spec."""
    from paddle_tpu_torch import chaos

    root = os.path.join(tmp, "chaos")
    metrics = os.path.join(root, "chaos_metrics.jsonl")
    os.makedirs(root)
    t0 = time.perf_counter()
    on_card = chaos.run_campaign(("train", "online", "serving"), seed=CHAOS_SEED, per_scenario=1,
                                 out_dir=os.path.join(root, "card"), metrics_path=metrics,
                                 place=fluid.CUDAPlace(0))
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = chaos.run_campaign(("train", "online", "serving"), seed=CHAOS_SEED, per_scenario=1,
                                out_dir=os.path.join(root, "cpu"), place=fluid.CPUPlace())
    cpu_s = time.perf_counter() - t0
    verdicts = {k: [(s["scenario"], s["spec"], s["verdict"]) for s in r.schedules]
                for k, r in (("card", on_card), ("cpu", on_cpu))}
    emit({"phase": "chaos_campaign", "seed": CHAOS_SEED, "schedules": verdicts["card"],
          "violations": {"card": len(on_card.violations), "cpu": len(on_cpu.violations)},
          "invariants_checked": on_card.invariants_checked, "card_s": card_s, "cpu_s": cpu_s,
          "card": card})
    if on_card.violations or on_cpu.violations or verdicts["card"] != verdicts["cpu"]:
        raise AssertionError(f"chaos_campaign: card {verdicts['card']} {on_card.violations}, "
                             f"cpu {verdicts['cpu']} {on_cpu.violations}")
    run_tool("perf_report.py", "--check", metrics, "--max-chaos-violations", "0",
             phase="chaos_campaign")
    os.environ[chaos.PLANTED_BUG_ENV] = "1"
    try:
        t0 = time.perf_counter()
        cpu_planted = chaos.run_campaign(("train",), seed=CHAOS_PLANTED_SEED, per_scenario=1,
                                         out_dir=os.path.join(root, "planted-cpu"),
                                         place=fluid.CPUPlace())
        cpu_planted_s = time.perf_counter() - t0
        (want,) = [v for v in cpu_planted.violations if v["invariant"] == "bit_identical_recovery"]
        t0 = time.perf_counter()
        planted = chaos.run_campaign(("train",), seed=CHAOS_PLANTED_SEED, per_scenario=1,
                                     out_dir=os.path.join(root, "planted-card"),
                                     place=fluid.CUDAPlace(0))
        got = [(v["spec"], v.get("shrunk_spec"), v["invariant"]) for v in planted.violations]
        planted_s = time.perf_counter() - t0
    finally:
        os.environ.pop(chaos.PLANTED_BUG_ENV, None)
    emit({"phase": "chaos_campaign", "planted_seed": CHAOS_PLANTED_SEED,
          "caught_by": want["spec"], "shrunk_to": want["shrunk_spec"],
          "probe_runs": want["shrink_runs"], "cpu_planted_s": cpu_planted_s,
          "card_planted": got, "card_planted_s": planted_s, "card": card})
    if len([e for e in want["shrunk_spec"].split(";") if e.strip()]) > 2:
        raise AssertionError(f"chaos_campaign: the shrinker stopped at {want['shrunk_spec']!r}")
    if got != [(want["spec"], want["shrunk_spec"], "bit_identical_recovery")]:
        raise AssertionError(f"chaos_campaign: the card's planted arm gave {got}, the CPU's "
                             f"{want['spec']!r} -> {want['shrunk_spec']!r}")


def host_table_phases(fluid, torch, ck, tmp, card):
    """Phases 69-72; their seconds printed.  Returns phase 69's launches."""
    t0 = time.perf_counter()
    init = host_table_state(fluid, DEEPFM)
    clean = host_table_run(fluid, torch, ck, tmp, card, "host_table_deepfm", init)
    emit({"phase_seconds": "host_table_deepfm", "s": time.perf_counter() - t0, "card": card})
    for phase, run in (("host_table_chaos",
                        lambda: host_table_chaos(fluid, torch, ck, tmp, card, init, clean)),
                       ("host_table_parity", lambda: host_table_parity(fluid, torch, card)),
                       ("chaos_campaign", lambda: chaos_campaign(fluid, torch, card, tmp))):
        phase_t0 = time.perf_counter()
        run()
        emit({"phase_seconds": phase, "s": time.perf_counter() - phase_t0, "card": card})
    emit({"phase_seconds": "phases 69-72", "s": time.perf_counter() - t0, "card": card})
    return clean["launches"]


# the training programs phase 73 prices, each as its phase builds it:
# (name, phase); the name keys its measured step (measured_step)
COST_PROGRAMS = (("resnet_train", 10), ("train_fused", 12), ("train_long", 13),
                 ("deepfm_train adagrad", 15), ("deepfm_train adam", 15),
                 ("nmt_train float32", 17), ("nmt_train bfloat16", 17))
PEAK_BYTES = {}  # phase -> the allocator's peak over its steps (resnet_train, deepfm_train)
PRECHECK_BATCH = 128  # phase 74: phase 13's program at 128 x 2048, past the card's memory
PRECHECK_SLACK = 4096  # bytes the refused call may allocate beyond its uploaded feeds


def cost_programs(fluid):
    """(name, phase, main, feed, fetch names) of the training programs of
    COST_PROGRAMS, built by the functions their phases call, with the feeds
    those phases run (the same shapes: planning needs no values)."""
    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    out = []
    main, _, fetches = build_resnet(fluid, "bfloat16", with_optimizer=True)
    out.append(("resnet_train", 10, main,
                {"img": np.zeros((RESNET_TRAIN_BATCH, 3, 224, 224), np.float32),
                 "label": np.zeros((RESNET_TRAIN_BATCH, 1), np.int64)}, [fetches["loss"].name]))
    for name, phase, seq_len, batch in (("train_fused", 12, 128, 32), ("train_long", 13, 2048, 8)):
        main, _, loss = build_train(fluid, "bfloat16", 12, 0.1, seq_len, True)
        out.append((name, phase, main,
                    make_fake_batch(batch, seq_len, 30522, rng=np.random.RandomState(0)), [loss]))
    for opt, make in (("adagrad", lambda: fluid.optimizer.Adagrad(0.05)),
                      ("adam", lambda: fluid.optimizer.Adam(1e-3))):
        main, _, loss, _ = build_deepfm(fluid, DEEPFM, make)
        out.append((f"deepfm_train {opt}", 15, main, deepfm_feed(DEEPFM_BATCH, DEEPFM, 0), [loss]))
    feed, _ = nmt_batch(fluid)
    for dtype in ("float32", "bfloat16"):
        main, _, loss = build_nmt(fluid, dtype)
        out.append((f"nmt_train {dtype}", 17, main, feed, [loss]))
    return out


def plan_cost_programs(fluid):
    """Build and plan the programs of cost_programs at the feed shapes the
    Executor stages for them (its own feed expansion on the CPU: ragged
    feeds padded to their bucket); card-free, so main() runs it on
    start_cpu_arms' thread.  Returns {name: {phase, main, feed, fetches,
    plan, feed_shapes, plan_s}}."""
    from paddle_tpu_torch.core import resource_plan as rp

    exe = fluid.Executor(fluid.CPUPlace())
    plans = {}
    with ARMS_BUILD_LOCK:
        programs = cost_programs(fluid)
    for name, phase, main, feed, fetches in programs:
        shapes = {n: tuple(t.shape) for n, t in exe._feeds(main.global_block(), feed, 1).items()}
        t0 = time.perf_counter()
        plan = rp.plan_program(main, shapes, fetches)
        plans[name] = {"phase": phase, "main": main, "feed": feed, "fetches": fetches,
                       "plan": plan, "feed_shapes": shapes, "plan_s": time.perf_counter() - t0}
    return plans


def measured_step(name):
    """(warm step ms, the allocator's peak bytes, graphed) of a COST_PROGRAMS
    program as its phase measured them: the median over its graphed arms'
    warm steps (train_arm's records) or the phase's own warm step; DeepFM's
    plans are refused a graph (SelectedRows), so its warm step is eager."""
    recs = [r for r in ARM_RECORDS.get(name, ()) if r["graphed"]]
    if recs:
        return (statistics.median(r["warm_step_ms"] for r in recs),
                max(r["peak_mem_gb"] for r in recs) * 1e9, True)
    phase = name.split(" ")[0]
    return WARM_STEP_MS[name], PEAK_BYTES[phase], phase != "deepfm_train"


def cost_model_phase(fluid, card, plans):
    """Phase 73: the cost model against the card.  For each program of
    COST_PROGRAMS, planned at its phase's feed shapes (plan_cost_programs):
    the FLOPs, bytes moved and roofline step time of the plan, its peak
    beside the allocator's peak the phase measured, the measured MFU
    (flops_total / (warm step s x CHIP_PEAK_FLOPS), from the step the phase
    already timed: no step runs again) and roofline / measured step.  Every
    op type has its cost rule (coverage 1.0, none missing) and the MFU lies
    in (0, 1]; the roofline ratio is printed, not held."""
    from paddle_tpu_torch.core import resource_plan as rp

    rows = {}
    for name, phase in COST_PROGRAMS:
        entry = plans[name]
        plan = entry["plan"]
        warm_ms, peak, graphed = measured_step(name)
        mfu = plan.flops_total / (warm_ms / 1e3 * rp.CHIP_PEAK_FLOPS)
        rec = {"phase": "cost_model", "program": name, "of_phase": phase,
               "feed_shapes": {n: list(s) for n, s in entry["feed_shapes"].items()},
               "flops_total": plan.flops_total, "traffic_bytes_total": plan.traffic_bytes_total,
               "roofline_step_s": plan.roofline_step_s, "predicted_mfu": plan.predicted_mfu,
               "plan_peak_bytes": plan.peak_bytes,
               "plan_persistable_bytes": plan.persistable_bytes,
               "plan_peak_temp_bytes": plan.peak_temp_bytes, "measured_peak_bytes": peak,
               "plan_over_measured_peak": plan.peak_bytes / peak,
               "warm_step_ms": warm_ms, "warm_step_graphed": graphed, "measured_mfu": mfu,
               "roofline_over_measured_step": plan.roofline_step_s / (warm_ms / 1e3),
               "cost_coverage_frac": plan.cost_coverage_frac,
               "cost_missing_types": plan.cost_missing_types, "ops": len(plan.rows),
               "plan_s": entry["plan_s"], "chip_model": {
                   "peak_flops": rp.CHIP_PEAK_FLOPS, "hbm_bytes_per_s": rp.CHIP_HBM_BANDWIDTH},
               "card": card}
        emit(rec)
        rows[name] = rec
        if plan.cost_coverage_frac != 1.0 or plan.cost_missing_types:
            raise AssertionError(f"{name}: op types without a cost rule: "
                                 f"{plan.cost_missing_types}")
        if not 0.0 < mfu <= 1.0:
            raise AssertionError(f"{name}: measured MFU {mfu} outside (0, 1]")
    return rows


def tally_across_resets(mon):
    """The process's totals of the analysis.plan span (calls, seconds) and
    of the executor.cache_miss and analysis.resource_blocked counters: the
    phases reset the monitor, so each reset first adds what it clears to
    the tally.  Returns a function giving the totals so far."""
    keep = ("executor.cache_miss", "analysis.resource_blocked")
    tally = dict.fromkeys(keep + ("plan_spans", "plan_s"), 0)

    def current():
        span = mon.span_stats().get("analysis.plan", {"calls": 0, "total_s": 0.0})
        counters = mon.counter_values()
        return {**{k: counters.get(k, 0) for k in keep},
                "plan_spans": span["calls"], "plan_s": span["total_s"]}

    reset = mon.reset

    def counted_reset():
        for k, v in current().items():
            tally[k] += v
        return reset()

    mon.reset = counted_reset
    return lambda: {k: tally[k] + v for k, v in current().items()}


def refused_run(fluid, torch, exe, main, feed, fetches):
    """Run `main` once, expecting the pre-check's ResourceError; returns
    (the error, allocated bytes before and after, the call's peak above
    before, the bytes of the feeds it uploads: the Executor's own feed
    conversion, run on the CPU)."""
    from paddle_tpu_torch.errors import ResourceError

    staged = fluid.Executor(fluid.CPUPlace())._feeds(main.global_block(), feed, 1)
    uploaded = sum(t.numel() * t.element_size() for t in staged.values())
    del staged
    # the earlier phases' garbage is freed first, and no collection runs
    # inside the call: the allocator's count then moves by the call alone
    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            exe.run(main, feed=feed, fetch_list=fetches, scope=fluid.Scope())
        except ResourceError as e:
            err = e.with_traceback(None)  # its frames hold the uploaded feeds
        else:
            raise AssertionError("the pre-check let a program past its memory limit run")
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    finally:
        gc.enable()
    return err, before, after, torch.cuda.max_memory_allocated() - before, uploaded


def precheck_phase(fluid, torch, card, plans, totals):
    """Phase 74: the pre-check and install_check on the card.  Phase 13's
    program (BERT-base bf16 fused, seq 2048) fed at PRECHECK_BATCH x 2048
    through a fresh Executor raises ResourceError under the card's own
    limit: needed > limit = torch.cuda.mem_get_info()[1],
    analysis.resource_blocked + 1, executor.cache_miss unchanged, no plan
    cached, the allocator back where it was and the call's peak above it at
    most the uploaded feeds + PRECHECK_SLACK.  At phase 13's 8 x 2048 under
    FLAGS_resource_hbm_limit_mb at half its plan it raises too.  Every
    plan-cache miss of this process so far was priced: the analysis.plan
    span's calls equal the misses plus the refused calls.  Then
    install_check.run_check() on the card."""
    import io
    from contextlib import redirect_stdout

    import numpy as np
    from paddle_tpu_torch.models.transformer import make_fake_batch

    entry = plans["train_long"]
    main, fetches = entry["main"], entry["fetches"]
    limit = torch.cuda.mem_get_info()[1]
    big = make_fake_batch(PRECHECK_BATCH, 2048, 30522, rng=np.random.RandomState(0))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t_before = totals()
    t0 = time.perf_counter()
    err, before, after, peak, uploaded = refused_run(fluid, torch, exe, main, big, fetches)
    refused_s = time.perf_counter() - t0
    t_after = totals()
    rec = {"phase": "precheck", "form": "card limit", "batch": PRECHECK_BATCH, "seq_len": 2048,
           "needed_bytes": err.needed_bytes, "limit_bytes": err.limit_bytes,
           "card_total_bytes": limit, "error_phase": err.phase,
           "watermark_ops": err.watermark_ops[:4],
           "resource_blocked": t_after["analysis.resource_blocked"]
           - t_before["analysis.resource_blocked"],
           "cache_miss": t_after["executor.cache_miss"] - t_before["executor.cache_miss"],
           "plans_cached": len(exe._cache), "allocated_before": before,
           "allocated_after": after, "peak_above_before": peak, "uploaded_feed_bytes": uploaded,
           "refused_s": refused_s, "card": card}
    emit(rec)
    if not (err.needed_bytes > err.limit_bytes == limit and err.phase == "build"
            and err.watermark_ops):
        raise AssertionError(f"the card-limit refusal: {rec}")
    if (rec["resource_blocked"], rec["cache_miss"], rec["plans_cached"]) != (1, 0, 0):
        raise AssertionError(f"the refusal moved the counters or cached a plan: {rec}")
    if after != before or peak > uploaded + PRECHECK_SLACK:
        raise AssertionError(f"the refused call allocated: {rec}")
    half_mb = entry["plan"].peak_bytes / 2 / 1e6
    old = fluid.get_flags(["FLAGS_resource_hbm_limit_mb"])
    fluid.set_flags({"FLAGS_resource_hbm_limit_mb": half_mb})
    try:
        err2, before2, after2, peak2, uploaded2 = refused_run(fluid, torch, exe, main,
                                                              entry["feed"], fetches)
    finally:
        fluid.set_flags(old)
    rec2 = {"phase": "precheck", "form": "FLAGS_resource_hbm_limit_mb at half the plan",
            "batch": 8, "seq_len": 2048, "flag_mb": half_mb,
            "needed_bytes": err2.needed_bytes, "limit_bytes": err2.limit_bytes,
            "plan_peak_bytes": entry["plan"].peak_bytes, "plans_cached": len(exe._cache),
            "allocated_before": before2, "allocated_after": after2,
            "peak_above_before": peak2, "uploaded_feed_bytes": uploaded2, "card": card}
    emit(rec2)
    if not (err2.needed_bytes == entry["plan"].peak_bytes
            and err2.limit_bytes == int(half_mb * 1e6) and not exe._cache
            and after2 == before2 and peak2 <= uploaded2 + PRECHECK_SLACK):
        raise AssertionError(f"the flag's refusal: {rec2}")
    out = io.StringIO()
    with redirect_stdout(out):
        fluid.install_check.run_check()
    lines = out.getvalue().splitlines()
    emit({"phase": "install_check", "printed": lines, "card": card})
    if lines[-1:] != ["install check passed."]:
        raise AssertionError(f"install_check.run_check() on the card printed {lines}")
    t = totals()
    rec3 = {"phase": "plan_span", "plan_spans": t["plan_spans"],
            "plan_total_ms": t["plan_s"] * 1e3, "cache_misses": t["executor.cache_miss"],
            "refused": t["analysis.resource_blocked"], "card": card}
    emit(rec3)
    if t["plan_spans"] != t["executor.cache_miss"] + t["analysis.resource_blocked"]:
        raise AssertionError(f"a plan-cache miss was not priced: {rec3}")
    return rec, rec2, rec3


DP_GANG_RANKS = 2
DP_GANG_TIMEOUT_S = 420
DP_PARITY = (128, 8)  # phase 76's f32 parity arm: (seq_len, global batch)


def device_digest(torch, t):
    """Two int64 sums over a tensor's bits on the card, plain and
    position-weighted: equal tensors give equal digests, and a changed
    element changes both but for an adversarial pattern."""
    w = t.detach().contiguous().reshape(-1)
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[w.element_size()]
    w = w.view(width).to(torch.int64)
    pos = torch.arange(w.numel(), device=w.device, dtype=torch.int64) % 65521 + 1
    return [int(w.sum()), int((w * pos).sum())]


def state_digests(torch, scope, names):
    return {n: device_digest(torch, scope.find_var(n)) for n in sorted(names)
            if isinstance(scope.find_var(n), torch.Tensor)}


def dp_world1(fluid, torch, ck, card):
    """Phase 75: phase 12's program (bf16 BERT-base, fused attention, 32 x
    128, dropout 0.1, Adam 1e-4) through CompiledProgram.with_data_parallel,
    then with_grad_overlap(mode="serial") and mode="bucketed", at world size
    1: each arm TRAIN_STEPS steps, graphed from its second run, FUSED_PER_STEP
    launches a step, every loss and every persistable bit for bit phase 12's
    first graphed arm's (same weights, same generator state).  Returns the
    launches counted."""
    kept = KEPT["train_fused"]
    main, startup, loss, feed = kept["program"]
    plain = next(r for r in ARM_RECORDS["train_fused"] if r["arm"] == "graphed")
    launches = dict(NONE)
    for arm in ("with_data_parallel", "serial", "bucketed"):
        compiled = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss)
        if arm != "with_data_parallel":
            compiled = compiled.with_grad_overlap(mode=arm)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        losses, step_ms = [], []
        for step in range(TRAIN_STEPS):
            before = dict(ck.LAUNCHES)
            t0 = time.perf_counter()
            (out,) = exe.run(compiled, feed=feed, fetch_list=[loss], scope=scope,
                             return_numpy=False)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(out.reshape(-1)[0]))
            delta = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
            add_launches(launches, delta)
            hold_run_launches(exe, step, delta, FUSED_PER_STEP, f"dp_world1 {arm}", "dp_world1")
        plan = exe.last_plan
        differ = [n for n, t in kept["state"].items()
                  if not torch.equal(scope.find_var(n).detach().cpu(), t)]
        record = {"phase": "dp_world1", "arm": arm, "losses": losses,
                  "plain_losses": kept["losses"], "graphed": plan.graphed,
                  "gang": plan.gang is not None, "persistables": len(kept["state"]),
                  "persistables_that_differ": differ[:8],
                  "bitwise_equal": losses == kept["losses"] and not differ,
                  "warm_step_ms": statistics.median(step_ms[2:]),
                  "plain_warm_step_ms": plain["warm_step_ms"], "step_ms": step_ms, "card": card}
        emit(record)
        if not (record["bitwise_equal"] and plan.graphed and plan.gang is None):
            raise AssertionError(f"dp_world1 {arm}: not phase 12's plain graphed run: {record}")
        del scope, exe
    KEPT.pop("train_fused")
    return launches


def dp_gang_start(tmp):
    """Start phase 76's gang: launch.run_gang of DP_GANG_RANKS ranks, each
    this script with --dp-rank (dp_rank_main), on a thread of this process.
    The ranks start up (imports, the rendezvous, the kernel library this
    process built), build their programs and their CPU setups, then wait
    for dp_gang_card's go before they use the card, so main() starts them
    before phase 75, whose graphed steps leave the host idle.  Returns the
    handle dp_gang_card and dp_gang_stop take."""
    from paddle_tpu_torch import _build, launch

    lib = _build.lib_path(_build.source_hash())
    if not os.path.exists(lib):
        raise AssertionError(f"dp_gang_card: the kernel library {lib} is not built")
    d = tempfile.mkdtemp(dir=tmp)
    handle = {"dir": d, "go": os.path.join(d, "go"), "t0": time.time()}

    def run():
        handle["result"] = launch.run_gang(
            [sys.executable, os.path.abspath(__file__), "--dp-rank", d], DP_GANG_RANKS,
            max_restarts=0, timeout=DP_GANG_TIMEOUT_S, peer_grace_s=5.0,
            extra_env={"PADDLE_DP_SPAWN_T": repr(handle["t0"]), "PADDLE_DP_GO": handle["go"]})

    handle["thread"] = threading.Thread(target=run, name="dp_gang", daemon=True)
    handle["thread"].start()
    return handle


def dp_gang_signal(handle, word):
    """Tell the waiting ranks to go on ("go") or to exit ("abort")."""
    tmp_go = handle["go"] + ".tmp"
    with open(tmp_go, "w") as f:
        f.write(word)
    os.replace(tmp_go, handle["go"])


def dp_gang_stop(handle):
    """Abort a gang dp_gang_card never ran (main() failed before phase 76):
    the ranks exit, run_gang reaps them."""
    if handle is not None and handle["thread"].is_alive():
        dp_gang_signal(handle, "abort")
        handle["thread"].join(DP_GANG_TIMEOUT_S)


def dp_gang_card(fluid, torch, ck, card, handle):
    """Phase 76: dp_gang_start's gang of DP_GANG_RANKS ranks on the one
    card, over gloo with CUDA tensors, told to go on here (dp_rank_main).
    The ranks load the kernel library this process built (not building it,
    nor taking its lock).  A rank whose checks fail exits non-zero and the
    phase fails.  Here: both ranks' records agree (the parameters before the
    first step, the losses, every persistable after the last, by
    device_digest), and the gang's numbers are printed.  Returns the
    launches both ranks counted."""
    gc.collect()
    torch.cuda.empty_cache()  # this process's cached blocks, for the ranks' allocations
    t0 = time.time()
    dp_gang_signal(handle, "go")
    handle["thread"].join(DP_GANG_TIMEOUT_S)
    res = handle.get("result")
    if res is None:
        raise AssertionError("dp_gang_card: the gang did not finish")
    gang_s = time.time() - t0
    d = handle["dir"]
    for r, (code, out, err) in enumerate(res.workers):
        emit({"phase": "dp_gang_card", "rank": r, "returncode": code,
              "stdout_tail": out[-1500:], "stderr_tail": err[-3000:] if code else err[-300:]})
    if not res.ok:
        raise AssertionError(f"dp_gang_card: the gang failed: exit codes "
                             f"{[w[0] for w in res.workers]}")
    recs = []
    for r in range(DP_GANG_RANKS):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    for key in ("params_before", "losses", "state_after", "parity_losses", "bn"):
        if any(rec[key] != recs[0][key] for rec in recs[1:]):
            raise AssertionError(f"dp_gang_card: the ranks' {key} differ")
    launches = dict(NONE)
    for rec in recs:
        add_launches(launches, rec["launches"])
    full = recs[0]
    emit({"phase": "dp_gang_card", "ranks": DP_GANG_RANKS, "backend": full["backend"],
          "model": "bert-base bf16, fused attention, dropout 0.1, Adam lr 1e-4",
          "global_batch": 32, "seq_len": 128, "rows_a_rank": 32 // DP_GANG_RANKS,
          "losses": full["losses"], "warm_step_ms": [rec["warm_step_ms"] for rec in recs],
          "tokens_per_s": 32 * 128 / max(rec["warm_step_ms"] for rec in recs) * 1e3,
          "sync_ms": [rec["sync_ms"] for rec in recs], "sync_bytes": full["sync_bytes"],
          "graph_refusal": full["graph_refusal"],
          "start_up_s": [rec["start_up_s"] for rec in recs],
          "library_load_s": [rec["library_load_s"] for rec in recs],
          "rank_seconds": [rec["seconds"] for rec in recs],
          "gang_s_from_go": gang_s, "persistables_equal_across_ranks": len(full["state_after"]),
          "card": card})
    return launches


def dp_rank_main(d):
    """One rank of phase 76's gang: bring the gang up (gloo: the ranks share
    the one card), load the kernel library the parent built, then
      * full width: phase 12's bf16 BERT-base, global batch 32 x 128, this
        rank's 16 rows, TRAIN_STEPS steps of with_data_parallel: parameters'
        digests before step 1, finite losses falling, FUSED_PER_STEP
        launches a step, the graph refused with the gang's reason;
      * parity: f32 BERT, 2 layers, fused, DP_PARITY, dropout 0,
        PARITY_STEPS Adam steps in each mode (plain, serial, bucketed), held
        by phase 7's rule (hold_parity) against this process's world-size-1
        run of the global batch; serial and bucketed bit for bit;
      * batch norm: a small f32 conv + batch-norm net, one SGD step: the
        gang's batch statistics and running statistics (plain) within 1e-5
        of max(1, |ref|) of the world-size-1 run on the global batch, and
        (with_grad_overlap) the running statistics the mean of the two
        one-shard runs'.
    Writes rank<r>.json under `d`; any failed check raises (exit non-zero)."""
    spawn_t = float(os.environ["PADDLE_DP_SPAWN_T"])
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.models.transformer import make_fake_batch
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.parallel import distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_distributed()
    rank, world = dist.trainer_id(), dist.num_trainers()
    if not os.path.exists(_build.lib_path(_build.source_hash())):
        raise AssertionError("the kernel library is not built: a rank must not build it")
    t0 = time.perf_counter()
    _build.library()
    rec = {"rank": rank, "world": world, "backend": dist.backend(),
           "library_load_s": time.perf_counter() - t0, "start_up_s": time.time() - spawn_t}
    seconds = rec["seconds"] = {}
    place = fluid.CUDAPlace(0)

    def shard(feed, n):
        per = n // world
        return {k: v[rank * per:(rank + 1) * per] for k, v in feed.items()}

    # the programs and the CPU setups, while the parent's phase 75 runs
    t0 = time.perf_counter()
    main, startup, loss = build_train(fluid, "bfloat16", 12, 0.1, 128, True)
    derived = launches_of_program(main, loss)
    if derived != FUSED_PER_STEP:
        raise AssertionError(f"the program's kernel ops {derived} != the reckoned {FUSED_PER_STEP}")
    feed = shard(make_fake_batch(32, 128, 30522, rng=np.random.RandomState(0)), 32)
    seq, batch = DP_PARITY
    pmain, ploss, state, gfeed = train_parity_setup(fluid, True, seq, batch)
    seconds["programs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    go = os.environ["PADDLE_DP_GO"]
    while not os.path.exists(go):
        if time.perf_counter() - t0 > DP_GANG_TIMEOUT_S:
            raise AssertionError(f"rank {rank}: no go from the parent in {DP_GANG_TIMEOUT_S} s")
        time.sleep(0.05)
    with open(go) as f:
        if f.read() != "go":
            return 3  # the parent failed before phase 76
    seconds["waited_for_go"] = time.perf_counter() - t0

    # full width
    t0 = time.perf_counter()
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.all_parameters()]
    rec["params_before"] = state_digests(torch, scope, params)
    compiled = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss)
    losses, step_ms, sync_ms, launches = [], [], [], dict(NONE)
    for step in range(TRAIN_STEPS):
        before = dict(ck.LAUNCHES)
        t1 = time.perf_counter()
        (out,) = exe.run(compiled, feed=feed, fetch_list=[loss], scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(out.reshape(-1)[0]))
        delta = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
        add_launches(launches, delta)
        hold_run_launches(exe, step, delta, FUSED_PER_STEP, f"dp_gang_card rank {rank}")
        sync_ms.append(exe.last_plan.grad_sync.last_ms)
    plan = exe.last_plan
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"rank {rank}: losses {losses}")
    if plan.graphed or not (plan.graph_refusal or "").startswith("a gang step"):
        raise AssertionError(f"rank {rank}: the gang's plan was not refused its graph: "
                             f"{plan.graph_refusal}")
    persist = [v.name for v in main.list_vars() if v.persistable]
    rec.update(losses=losses, launches=launches, step_ms=step_ms,
               warm_step_ms=statistics.median(step_ms[2:]),
               sync_ms=statistics.median(sync_ms[2:]), sync_bytes=plan.grad_sync.last_bytes,
               graph_refusal=plan.graph_refusal,
               state_after=state_digests(torch, scope, persist))
    del scope, exe, compiled
    gc.collect()
    torch.cuda.empty_cache()
    seconds["full_width"] = time.perf_counter() - t0

    # parity: the gang against one process's world-size-1 run of the global batch
    t0 = time.perf_counter()
    (ref_run,), near_zero = parity_runs(fluid, pmain, ploss, state, gfeed,
                                        arms=((place, True, pmain),))
    runs = {}
    for mode in ("plain", "serial", "bucketed"):
        compiled = fluid.CompiledProgram(pmain).with_data_parallel(loss_name=ploss)
        if mode != "plain":
            compiled = compiled.with_grad_overlap(mode=mode)
        scope = fluid.Scope()
        fluid.io.load_numpy_params(scope, state, device=place.device)
        exe = fluid.Executor(place)
        mode_losses = [float(exe.run(compiled, feed=shard(gfeed, batch), fetch_list=[ploss],
                                     scope=scope)[0].reshape(-1)[0])
                       for _ in range(PARITY_STEPS)]
        runs[mode] = (mode_losses, scope)
        hold_parity({"phase": "dp_gang_card parity", "rank": rank, "mode": mode,
                     "model": "bert-base f32, 2 layers, dropout 0, fused attention",
                     "batch": batch, "seq_len": seq,
                     "card_is": f"the gang ({world} ranks, {mode})",
                     "cpu_is": "one process of the global batch at world size 1, on the card"},
                    [runs[mode], ref_run], near_zero, state, LR)
    (sl, ss), (bl, bs) = runs["serial"], runs["bucketed"]
    differ = [n for n in state if not torch.equal(ss.find_var(n), bs.find_var(n))]
    if sl != bl or differ:
        raise AssertionError(f"rank {rank}: serial and bucketed differ: {sl} / {bl}, {differ[:8]}")
    rec["parity_losses"] = {m: r[0] for m, r in runs.items()}
    del runs, ss, bs, ref_run
    gc.collect()
    seconds["parity"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rec["bn"] = dp_gang_bn(fluid, torch, place, rank, world)
    seconds["bn"] = time.perf_counter() - t0
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    print(json.dumps({"dp_rank": rank, "warm_step_ms": rec["warm_step_ms"],
                      "sync_ms": rec["sync_ms"], "start_up_s": rec["start_up_s"]}), flush=True)
    return 0


def dp_gang_bn(fluid, torch, place, rank, world):
    """Phase 76's batch-norm check (see dp_rank_main); returns the gang's
    statistics as lists."""
    import numpy as np

    with fluid.unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        startup.random_seed = 13
        with fluid.program_guard(main, startup):
            img = fluid.layers.data("img", [3, 8, 8], dtype="float32")
            y = fluid.layers.data("y", [1], dtype="float32")
            c = fluid.layers.batch_norm(fluid.layers.conv2d(img, 4, 3, padding=1))
            loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(c, 1), y))
            fluid.optimizer.SGD(0.1).minimize(loss)
    bn = next(op for op in main.global_block().ops if op.type == "batch_norm")
    saved = [bn.output("SavedMean")[0], bn.output("SavedVariance")[0]]
    running = [bn.output("MeanOut")[0], bn.output("VarianceOut")[0]]
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(16, 3, 8, 8).astype("f4"), "y": rng.rand(16, 1).astype("f4")}
    per = 16 // world
    mine = {k: v[rank * per:(rank + 1) * per] for k, v in feed.items()}

    def step(program, f, fetch):
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        out = exe.run(program, feed=f, fetch_list=fetch, scope=scope)
        return [np.asarray(o) for o in out], [scope.to_numpy(n).copy() for n in running]

    (stats_ref, run_ref) = step(main, feed, saved)
    plain = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    stats_gang, run_gang = step(plain, mine, saved)
    shards = [step(main, {k: v[r * per:(r + 1) * per] for k, v in feed.items()}, [])[1]
              for r in range(world)]
    overlap = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name) \
        .with_grad_overlap(mode="serial")
    _, run_overlap = step(overlap, mine, [])
    checks = [("batch statistics", stats_gang, stats_ref),
              ("running statistics", run_gang, run_ref),
              ("rank-meaned running statistics", run_overlap,
               [np.mean([s[i] for s in shards], axis=0) for i in range(len(running))])]
    worst = {}
    for what, got, want in checks:
        err = max(float(np.abs(g - w).max() / max(1.0, float(np.abs(w).max())))
                  for g, w in zip(got, want))
        worst[what] = err
        if not err <= 1e-5:
            raise AssertionError(f"rank {rank}: {what} off by {err} of max(1, |ref|) > 1e-5")
    emit({"phase": "dp_gang_card bn", "rank": rank, "worst_share_of_max_1_ref": worst,
          "tol": 1e-5})
    return {"stats": [s.tolist() for s in stats_gang], "running": [r.tolist() for r in run_gang],
            "overlap_running": [r.tolist() for r in run_overlap]}


def main():
    run_t0 = time.perf_counter()
    import paddle_tpu_torch as fluid  # outside a checkout of the repository this fails
    import torch
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import cuda_attention as ca, cuda_kernels as ck

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    try:  # a numpy fetch of a bf16 value is an ml_dtypes array (ROADMAP C1)
        import ml_dtypes
        numpy_bf16 = ml_dtypes.__version__
    except ImportError:
        numpy_bf16 = None
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "ml_dtypes": numpy_bf16, "card": card})
    if numpy_bf16 is None:
        raise AssertionError("ml_dtypes does not import on this host: bf16 fetches would raise")

    # the card-free CPU arms of phases 7, 11, 14, 18, 25 and 55 and phase
    # 73's plans, on two threads beside the build and phase 3
    amp_setup = amp_bert_setup(fluid)
    cpu_arms = start_cpu_arms(
        [[("amp_bert", lambda: amp_bert_arm(fluid, "cpu", fluid.CPUPlace(), *amp_setup)),
          ("resnet_train_parity", lambda: resnet_parity_cpu(fluid))],
         [(shape, lambda s=shape: train_parity_arm(fluid, True, *s)) for shape in FUSED_PARITY]
         + [("train_parity", lambda: train_parity_arm(fluid)),
            ("nmt_train_parity", lambda: nmt_parity_arm(fluid)),
            ("train_clipped_parity", lambda: clipped_parity_arm(fluid)),
            ("amp_resnet_parity", lambda: amp_resnet_cpu(fluid)),
            ("cost_plans", lambda: plan_cost_programs(fluid))]])
    info = _build.build()
    emit({"phase": "build", "seconds": info["seconds"]})
    print("\n".join(line for line in info["log"].splitlines()
                    if "Used" in line or "spill" in line or "entry function" in line
                    or "Potential Performance Loss" in line or line.startswith("==")),
          flush=True)
    attention_occupancy(_build)
    mark = [time.perf_counter()]

    def lap(phase):
        """Print the seconds since the last lap as `phase`'s."""
        now = time.perf_counter()
        emit({"phase_seconds": phase, "s": now - mark[0], "card": card})
        mark[0] = now

    timings = check_kernels(torch, ck)
    lap("check_kernels")
    timings.update(check_attention_kernels(torch, ca))
    lap("check_attention_kernels")
    timings.update(check_bf16_score_kernels(torch, ca))
    lap("check_bf16_score_kernels")
    timings.update(check_train_kernels(torch, ck))
    lap("check_train_kernels")
    check_nmt_kernels(torch, ck, timings)
    lap("check_nmt_kernels")
    timings.update(check_bn_kernels(torch, ck))
    lap("check_bn_kernels")
    check_float16_kernels(torch, ck, timings)
    lap("check_float16_kernels")
    check_vision_kernels(torch, ck, timings)
    lap("check_vision_kernels")
    check_seq2seq_kernels(torch, ck, timings)
    lap("check_seq2seq_kernels")
    join_cpu_arms(cpu_arms)
    emit({"phase_seconds": "cpu_arms", "s": sum(cpu_arms["seconds"].values()),
          "by_arm": {str(k): v for k, v in cpu_arms["seconds"].items()},
          "lanes": [[name for name, _ in lane] for lane in cpu_arms["lanes"]],
          "beside": "the build and phase 3", "card": card})
    lap("cpu_arms_wait")
    os.makedirs(os.path.join(ROOT, ".chip_smoke_tmp"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, ".chip_smoke_tmp"))
    fluid.monitor.enable()  # the executor layer's counters and spans (read_monitor)
    totals = tally_across_resets(fluid.monitor.get_monitor())
    gang = None
    try:
        served = serve(fluid, torch, ck, tmp, card)
        lap("serve")
        parity(fluid, torch, tmp)
        lap("parity")
        trained = train(fluid, torch, ck, card)
        lap("train")
        setup, cpu = cpu_arms["results"].pop("train_parity")
        train_parity(fluid, torch, setup=setup, cpu=cpu)
        lap("train_parity")
        resnet_served = resnet_serve(fluid, torch, ck, tmp, card)
        lap("resnet_serve")
        resnet_parity(fluid, torch, tmp)
        lap("resnet_parity")
        resnet_trained = resnet_train(fluid, torch, ck, card)
        lap("resnet_train")
        resnet_train_parity(fluid, torch, cpu=cpu_arms["results"].pop("resnet_train_parity"))
        lap("resnet_train_parity")
        fused_trained = train(fluid, torch, ck, card, "train_fused", True, 128, 32, FUSED_PER_STEP,
                              arms=FUSED_AB_ARMS, keep=True)
        lap("train_fused")
        long_trained = train(fluid, torch, ck, card, "train_long", True, 2048, 8, FUSED_PER_STEP)
        lap("train_long")
        for shape in FUSED_PARITY:
            setup, cpu = cpu_arms["results"].pop(shape)
            train_parity(fluid, torch, "train_fused_parity", True, *shape, setup=setup, cpu=cpu)
        lap("train_fused_parity")
        deepfm_trained = deepfm_train(fluid, torch, ck, tmp, card)
        lap("deepfm_train")
        deepfm_train_parity(fluid, torch, ck)
        lap("deepfm_train_parity")
        nmt_trained, nmt_scope = nmt_train(fluid, torch, ck, card)
        lap("nmt_train")
        nmt_state = nmt_train_parity(fluid, torch, cpu_arms["results"].pop("nmt_train_parity"))
        lap("nmt_train_parity")
        nmt_decoded = nmt_decode(fluid, torch, ck, card, nmt_scope)
        lap("nmt_decode")
        nmt_decode_parity(fluid, torch, nmt_state)
        lap("nmt_decode_parity")
        graph_parity(fluid, torch)
        lap("graph_parity")
        conv_order(fluid, torch, card)
        lap("conv_order")
        executor_depth(fluid, torch, card)
        lap("executor_depth")
        remat_parity(fluid, torch, card)
        lap("remat_parity")
        clipped_trained = train(fluid, torch, ck, card, "train_clipped", True, 128, 32,
                                FUSED_PER_STEP, arms=AB_ARMS, clip_decay=True)
        lap("train_clipped")
        train_clipped_parity(fluid, torch, card, cpu_arms["results"].pop("train_clipped_parity"))
        lap("train_clipped_parity")
        checkpoint_resume(fluid, torch, tmp, card)
        lap("checkpoint_resume")
        loader_trained = loader_resnet(fluid, torch, ck, tmp, card)
        lap("loader_resnet")
        dataset_trained = dataset_deepfm(fluid, torch, ck, tmp, card)
        lap("dataset_deepfm")
        resilient_trained = resilient_resnet(fluid, torch, ck, tmp, card,
                                             os.path.join(tmp, "images.rio"))
        lap("resilient_resnet")
        bert_resumed = resilient_bert(fluid, torch, ck, tmp, card)
        lap("resilient_bert")
        se_trained, profiled = vision_train(fluid, torch, ck, card, "se_resnext",
                                            "se_resnext_train", on_card(torch, images(
                                                VISION_BATCH, 100)), {"images": VISION_BATCH})
        lap("se_resnext_train")
        se_served = vision_serve(fluid, torch, ck, tmp, card, "se_resnext", "se_resnext_serve")
        lap("se_resnext_serve")
        vgg_trained, _ = vision_train(fluid, torch, ck, card, "vgg", "vgg_train", on_card(
            torch, images(VISION_BATCH, 101)), {"images": VISION_BATCH})
        lap("vgg_train")
        vgg_served = vision_serve(fluid, torch, ck, tmp, card, "vgg", "vgg_serve")
        lap("vgg_serve")
        lstm_feed = vision_feed("stacked_lstm", LSTM_BATCH, 102)
        lstm_trained, _ = vision_train(fluid, torch, ck, card, "stacked_lstm", "lstm_train",
                                       lstm_feed, {"sentences": LSTM_BATCH,
                                                   "tokens": int(lstm_feed["words@LOD"].sum())})
        lap("lstm_train")
        w2v_trained, _ = vision_train(fluid, torch, ck, card, "word2vec", "word2vec_train",
                                      vision_feed("word2vec", W2V_BATCH, 103),
                                      {"examples": W2V_BATCH})
        lap("word2vec_train")
        vision_parity(fluid, torch)
        lap("vision_parity")
        profiled_trace(fluid, torch, ck, tmp, card, profiled)
        lap("profiled_trace")
        phase_t0 = time.perf_counter()
        lamb_trained = train(fluid, torch, ck, card, "train_lamb", True, 128, 32, LAMB_PER_STEP,
                             arms=AB_ARMS, optimizer="lamb")
        lamb_tail(fluid, torch, card)
        emit({"phase_seconds": "train_lamb", "s": time.perf_counter() - phase_t0, "card": card})
        phase_t0 = time.perf_counter()
        lars_trained = resnet_train(fluid, torch, ck, card, "resnet_lars", optimizer="lars")
        emit({"phase_seconds": "resnet_lars", "s": time.perf_counter() - phase_t0, "card": card})
        phase_t0 = time.perf_counter()
        seq2seq_trained = seq2seq_train(fluid, torch, ck, card)
        emit({"phase_seconds": "seq2seq_train", "s": time.perf_counter() - phase_t0,
              "card": card})
        phase_t0 = time.perf_counter()
        optim_parity(fluid, torch, card)
        emit({"phase_seconds": "optim_parity", "s": time.perf_counter() - phase_t0, "card": card})
        phase_t0 = time.perf_counter()
        ragged_parity(fluid, torch, card)
        emit({"phase_seconds": "ragged_parity", "s": time.perf_counter() - phase_t0,
              "card": card})
        phase_t0 = time.perf_counter()
        bs_trained, bs_served, bs_long = bert_bf16_scores(fluid, torch, ck, tmp, card)
        emit({"phase_seconds": "bert_bf16_scores", "s": time.perf_counter() - phase_t0,
              "card": card})
        detected = {}
        for model in ("ssd", "yolov3"):
            phase_t0 = time.perf_counter()
            detected[f"{model}_train"] = detection_train(fluid, torch, ck, card, model)
            emit({"phase_seconds": f"{model}_train", "s": time.perf_counter() - phase_t0,
                  "card": card})
            phase_t0 = time.perf_counter()
            detected[f"{model}_serve"] = detection_serve(fluid, torch, ck, tmp, card, model)
            emit({"phase_seconds": f"{model}_serve", "s": time.perf_counter() - phase_t0,
                  "card": card})
        phase_t0 = time.perf_counter()
        detection_parity(fluid, torch, card)
        emit({"phase_seconds": "detection_parity", "s": time.perf_counter() - phase_t0,
              "card": card})
        tail_t0 = phase_t0 = time.perf_counter()
        tail_parity(fluid, torch, card)
        emit({"phase_seconds": "tail_parity", "s": time.perf_counter() - phase_t0, "card": card})
        phase_t0 = time.perf_counter()
        tagged = tagger_train(fluid, torch, ck, card)
        emit({"phase_seconds": "tagger_train", "s": time.perf_counter() - phase_t0, "card": card})
        w2v_heads = {}
        for head in ("nce", "hsigmoid"):
            phase_t0 = time.perf_counter()
            w2v_heads[head], _ = vision_train(fluid, torch, ck, card, f"word2vec_{head}",
                                              f"word2vec_{head}_train",
                                              vision_feed("word2vec", W2V_BATCH, 103),
                                              {"examples": W2V_BATCH})
            emit({"phase_seconds": f"word2vec_{head}_train", "s": time.perf_counter() - phase_t0,
                  "card": card})
        emit({"phase_seconds": "phases 48-51", "s": time.perf_counter() - tail_t0, "card": card})
        amp_t0 = phase_t0 = time.perf_counter()
        amp_trained = bert_f16_amp(fluid, torch, ck, card)
        emit({"phase_seconds": "bert_f16_amp", "s": time.perf_counter() - phase_t0, "card": card})
        phase_t0 = time.perf_counter()
        amp_overflowed = bert_f16_overflow(fluid, torch, ck, card)
        emit({"phase_seconds": "bert_f16_overflow", "s": time.perf_counter() - phase_t0,
              "card": card})
        phase_t0 = time.perf_counter()
        amp_resnet = resnet_train(fluid, torch, ck, card, "resnet_f16_amp", amp=True)
        emit({"phase_seconds": "resnet_f16_amp", "s": time.perf_counter() - phase_t0,
              "card": card})
        phase_t0 = time.perf_counter()
        amp_bert_parity(fluid, torch, amp_setup, cpu_arms["results"].pop("amp_bert"))
        emit({"phase_seconds": "amp_bert_parity", "s": time.perf_counter() - phase_t0,
              "card": card})
        amp_resnet_parity(fluid, torch, cpu_arms["results"].pop("amp_resnet_parity"))
        emit({"phase_seconds": "amp_parity", "s": time.perf_counter() - phase_t0, "card": card})
        emit({"phase_seconds": "phases 52-55", "s": time.perf_counter() - amp_t0, "card": card})
        served_bert, fleet_inputs = serving_phases(fluid, torch, ck, tmp, card)
        fleet_served = fleet_phases(fluid, torch, card, tmp, fleet_inputs)
        quant_served, qat_trained = quant_phases(fluid, torch, ck, tmp, card,
                                                 fleet_inputs["bert_dir"])
        dygraph_ran = dygraph_phases(fluid, torch, ck, tmp, card)
        host_table_trained = host_table_phases(fluid, torch, ck, tmp, card)
        phase_t0 = time.perf_counter()
        plans = cpu_arms["results"].pop("cost_plans")
        cost_model_phase(fluid, card, plans)
        emit({"phase_seconds": "cost_model", "s": time.perf_counter() - phase_t0,
              "plan_s": sum(p["plan_s"] for p in plans.values()), "card": card})
        phase_t0 = time.perf_counter()
        precheck_phase(fluid, torch, card, plans, totals)
        emit({"phase_seconds": "precheck", "s": time.perf_counter() - phase_t0, "card": card})
        phase_t0 = time.perf_counter()
        gang = dp_gang_start(tmp)  # its ranks start up while phase 75 runs
        dp_world1_trained = dp_world1(fluid, torch, ck, card)
        emit({"phase_seconds": "dp_world1", "s": time.perf_counter() - phase_t0, "card": card})
        phase_t0 = time.perf_counter()
        dp_gang_trained = dp_gang_card(fluid, torch, ck, card, gang)
        emit({"phase_seconds": "dp_gang_card", "s": time.perf_counter() - phase_t0, "card": card})
    finally:
        dp_gang_stop(gang)
        shutil.rmtree(tmp, ignore_errors=True)

    # each path must have launched each of its kernels, and every kernel must
    # have run on some path; `launches` is the wrappers' count on the first
    # path of LAUNCH_ORDER that runs the kernel, `launches_by_path` the
    # wrappers' count on each path (eager runs and captures),
    # `replayed_by_path` what the graph replays after each capture ran
    # (REPLAYED), and `ran_by_path` the two together: how often the path ran
    # the kernel
    paths = {"bert_f16_amp": (FUSED_PER_STEP, amp_trained),
             "bert_f16_overflow": (FUSED_PER_STEP, amp_overflowed),
             "resnet_f16_amp": (RESNET_PER_STEP, amp_resnet),
             "bert_bf16_scores": (FUSED_BF16_SCORES_PER_STEP, bs_trained),
             "bert_bf16_scores_serve": (BF16_SCORES_PER_REQUEST, bs_served),
             "bert_bf16_scores_long": (FUSED_BF16_SCORES_PER_STEP, bs_long),
             "ssd_train": (SSD_PER_STEP, detected["ssd_train"]),
             "ssd_serve": (SSD_PER_REQUEST, detected["ssd_serve"]),
             "yolov3_train": (YOLO_PER_STEP, detected["yolov3_train"]),
             "yolov3_serve": (YOLO_PER_REQUEST, detected["yolov3_serve"]),
             "train_lamb": (LAMB_PER_STEP, lamb_trained),
             "resnet_lars": (LARS_PER_STEP, lars_trained),
             "seq2seq_train": (dict(NONE, adam=1), seq2seq_trained),
             "serve": (PER_REQUEST, served), "train": (PER_STEP, trained),
             "resnet_serve": (RESNET_PER_REQUEST, resnet_served),
             "resnet_train": (RESNET_PER_STEP, resnet_trained),
             "train_fused": (FUSED_PER_STEP, fused_trained),
             "train_clipped": (FUSED_PER_STEP, clipped_trained),
             "train_long": (FUSED_PER_STEP, long_trained),
             "deepfm_train": (DEEPFM_PER_STEP, deepfm_trained),
             "nmt_train": (NMT_PER_STEP, nmt_trained),
             "nmt_decode": (dict(NONE, ln_residual_fwd=1, bias_act_fwd=1), nmt_decoded),
             "loader_resnet": (RESNET_PER_STEP, loader_trained),
             "dataset_deepfm": (NONE, dataset_trained),
             "resilient_resnet": (RESNET_PER_STEP, resilient_trained),
             "resilient_bert": (FUSED_PER_STEP, bert_resumed),
             "se_resnext_train": (VISION_PER_STEP["se_resnext"], se_trained),
             "se_resnext_serve": (VISION_PER_REQUEST["se_resnext"], se_served),
             "vgg_train": (VISION_PER_STEP["vgg"], vgg_trained),
             "vgg_serve": (VISION_PER_REQUEST["vgg"], vgg_served),
             "lstm_train": (VISION_PER_STEP["stacked_lstm"], lstm_trained),
             "word2vec_train": (VISION_PER_STEP["word2vec"], w2v_trained),
             "word2vec_nce_train": (VISION_PER_STEP["word2vec_nce"], w2v_heads["nce"]),
             "word2vec_hsigmoid_train": (VISION_PER_STEP["word2vec_hsigmoid"],
                                         w2v_heads["hsigmoid"]),
             "tagger_train": (TAGGER_PER_STEP, tagged),
             "serving_bert": (PER_REQUEST, served_bert),
             "serving_fleet": (PER_REQUEST, fleet_served),
             "quant_serving": (PER_REQUEST, quant_served),
             "qat_resnet": (RESNET_PER_STEP, qat_trained),
             "host_table_deepfm": (HOST_TABLE_PER_STEP, host_table_trained),
             "dp_world1": (FUSED_PER_STEP, dp_world1_trained),
             "dp_gang_card": (FUSED_PER_STEP, dp_gang_trained),
             **{phase: (NONE, ran) for phase, ran in dygraph_ran.items()}}
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        for path, (want, got) in paths.items():
            if want[name] and got[name] == 0:
                raise AssertionError(f"{name} was never launched on the {path} path")
        by_path = {path: got[name] for path, (_, got) in paths.items()}
        replayed = {path: REPLAYED.get(path, NONE)[name] for path in paths}
        if not any(by_path.values()):
            raise AssertionError(f"{name} was launched on no path")
        rec = timings[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": next(by_path[p] for p in LAUNCH_ORDER if by_path[p]),
                        "launches_by_path": by_path, "replayed_by_path": replayed,
                        "ran_by_path": {p: by_path[p] + replayed[p] for p in paths},
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                        "library": rec["library"], "shape": rec["shape"], "card": card,
                        **{k: v for k, v in rec.items()
                           if k.startswith("at_") or k == "launch_split_us"}})
    emit({"phase_seconds": "total", "s": time.perf_counter() - run_t0, "card": card})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2]))
    sys.exit(main())
