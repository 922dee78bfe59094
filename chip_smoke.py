#!/usr/bin/env python3
"""Smoke run of vlp3d_torch on one CUDA card: grounding inference, the
joint train step, the predict path, the trainer behind run.sh, the HTTP
grounding server, Scan2Cap captioning, ScanQA question answering, the
grounding model's options, data parallel, ZeRO-1, tensor, pipeline and
point-axis parallel, the GloVe/LSTM task pipelines (ScanQA with MCAN,
RefNet, CapNet), the remaining variant models (MLCVNet, the DETR
head, the xbert captioner, the cross-modal MLM, positive match, the
legacy InfoNCE with its negatives, ENet's compute_multiview), and the
PointPillars encoder with the rotated BEV IoU / NMS and the multiview
hdf5 read without h5py.

    python3 chip_smoke.py
    python3 chip_smoke.py --ranks 4
    python3 chip_smoke.py --iou-times
    python3 chip_smoke.py --redesign-times SAVE [AGAINST]

Needs one CUDA device (Hopper, sm_90a) and nvcc; imports no JAX and
nothing of the vlp3d package. ``--iou-times`` times only the rotated IoU
and NMS on phase 17's box sets with the vlp3d_torch beside the file (a
copy in another checkout's root times that checkout's kernels);
``--redesign-times`` does the same for the interpolation's backward at
the FP shapes and hard_voxelize on phase 17's clouds, and holds their
outputs against another run's bit for bit. ``--ranks N`` runs instead only the
parallel modes over N cards of the host: N ranks over NCCL under
torch.distributed.run, each building phase 6's model twice from its
seed; the data-parallel step on the global batch of 8 (8 / N rows a
card) against the one-process step on the whole batch, which every rank
runs too (following its ReLU inputs and its max pools' choices, within
FLIP_TOL, and its SA modules' sampled indices: exact on the backbone's,
within INDEX_TIE_TOL of a tie on the vote aggregation's; loss, DP_PROBE
gradients and BatchNorm statistics at phase 6's tolerances, parameters
equal on every rank, PER_STEP launches; SA1 replayed alone with either
run's output gradient, printed: sa1_upstream_witness), then 9 timed
steps each of the one-process step, the data-parallel step at 8 and at
8 x N (8 rows a card), in turns, the slowest rank's medians; then ZeRO-1 over the N ranks, tp 2
x dp N / 2 and tp N, each step against the one-process step recorded
once (as above) with PARALLEL_STEPS timed steps, pp 2 x dp N / 2
against the sequential text layers, the point-sharded SA1 front
over the N ranks (40960 points of each scene a rank; its FPS one launch
of the loop kernel a rank, the candidates exchanged through peer
memory) against the dense ops on the whole clouds, its first call (the
exchange's set-up) and the median of three more timed, the FPS alone
over the N ranks and on one rank, and the loop's step on a 2048-point
slab a rank over the N ranks (2048 centres), beside the same kernel on
that slab alone, whose exchange stays in the card's own memory (their
difference: what the peers' memory adds to a step),
and phase 16's legacy InfoNCE over
gather_negatives (each rank's B / N scenes' sentences against every
scene's proposals) against the mean of the same ranks' losses computed
on one card. Phases of the run without arguments,
each fatal on failure:

1. card, power limit, torch / CUDA / nvcc versions;
2. build every kernel source under vlp3d_torch/csrc (one nvcc each, in
   parallel) and print ptxas register / shared-memory use;
3. build the full-width model (Config() with use_con=False,
   no_caption=True: 132 feature channels, SA 2048/1024/512/256, 256
   proposals, BERT-base text mode over 6 layers) from a seed, with random
   BatchNorm statistics, and run one warm-up forward at B=8, N=40960;
4. hold each kernel against its plain PyTorch version at the shapes the
   main path gives it (FPS x5, ball query x5 with and without counts,
   three-NN with the FP module's interpolation x2, from that forward's
   own tensors), plus zero-padded rows and empty balls; time kernel and
   plain version with CUDA events (the launches queue behind a
   device-side sleep, so a kernel shorter than its wrapper's host time is
   timed on the device). Three-NN besides: at FP1 and FP2 the fused team
   kernel (three-NN, weights, weighted sum; indices equal, dist2 within
   1e-6, weights within 1e-6, output within 1e-5 of
   interpolate_features_plain), three_nn alone, the first, one-thread-a-point
   kernel and every team plan (lanes x points a block, times as
   sweep_ms), timed beside the route the fused kernel replaced (the first
   kernel + weighting + row gather + multiply + sum), the plain version
   and torch.cdist + topk; the edge cases of tests/torch_three_nn_cases.py
   (ties across and inside lanes, an all-zero known row, unknown points
   on known points, m = 3, m below the lanes, ragged n and m, squared
   distances that overflow, C = 3 / 5 / 13 / 256, B = 1 / 3 / 9) through
   every plan, B = 1 / 3 / 9 at the FP2 shape, and refused plans; host us
   of interpolate_features beside the replaced route. The row gather on
   out-of-range indices (-1, -N, N, -N - 1, the int32 extremes): both
   forward kernels, with and without a subtrahend, at the C = 135 and
   C = 3 (strided) cloud and the C = 256 SA2 features, equal to the
   plain version, NaN rows included (the JAX package's rule: [-N, 0)
   wraps, any other index outside [0, N) gives NaN). Ball query
   besides: at every site the warp-a-centre kernel it replaced and every swept plan of the tile
   kernel (threads x blocks a cluster x tile points, times as
   sweep_ms), with and without counts, points_scanned and
   mean_count; the edge cases of tests/torch_bq_cases.py (hits across
   segment boundaries, nsample hits ending at a segment's last point,
   every hit in the last segment, empty and full balls, n < nsample, n =
   33, ragged n and m, points at exactly the radius) through every
   plan, B = 1 / 3 / 9 at the SA1 shape, a 70000-point segment (4-byte
   hit lists), and refused plans; all fatal
   unless the index and count difference is 0. FPS besides: at every site the
   one-block kernel it replaced (time and indices), every other shape
   of the points-in-registers kernel that holds the row (blocks a row x
   points a thread: indices equal, times printed as sweep_ms), us a
   step, and the serial bound for the SMs a row has; then the edge
   cases, each through the wrapper's choice and through forced one-block
   and cluster shapes, fatal unless the index difference is 0: ties
   across blocks (duplicated halves, 7 distinct points), blocks with no
   valid point, an all-zero row, a row with one valid point, N = 40000 /
   1000 / 33, npoint = 1, npoint above the number of valid points, B =
   1 / 3 / 9 / 16, a 65536-point row (cluster) and a 262144-point row
   (one block, global scratch); plans the card must refuse raise and
   leave no error behind; how many clusters the card runs at once; host
   us a call of each wrapper (1000 unsynchronised calls);
5. with every launch count at 0, serve three requests through
   GroundingPredictor (one batch; a list of two; occupancy 3 through
   run_padded), read the counts (FPS 5, ball query 5, three-NN 2, row
   gather 11 per forward, no backward), check the outputs, compare one
   forward against the same forward with the plain ops on the card
   (pred_ref equal, cluster_ref within 1e-4), and trace one request with
   torch.profiler (device time by kernel, device-busy share);
6. the train path: the full-width model with use_con=True from a seed,
   (two nudges: small vote offsets, ~0.7 m boxes, so that every loss is
   live), AdamW with its two learning-rate groups on the cosine schedule, one
   make_batch(istrain=1) batch at B=8, N=40960 on the card. One recorded
   forward + backward gives every call site of the row gather and of the
   interpolation its own tensors (C = 3, 64, 128, 135; the multiview site
   is a sliced view; the folded SA sites pass their centre term as the
   subtrahend). The interpolation's weighted backward at FP1 and FP2,
   under its plan and every plan of INTERP_GRAD_PLANS, against the plain
   weighted backward (fatal above GRAD_RTOL of the absolute sum meeting
   in a row, or unless two launches are equal bit for bit) and against
   the ordered sum of tests/torch_three_nn_cases.py (fatal unless equal
   bit for bit), timed beside its fixed cost (floor_ms), the route
   it replaced (broadcast multiply + the gather's sorted backward) and
   torch.sparse.mm. The row gather:
   the forward kernel is held against torch.gather (fatal unless the
   difference is 0), with the site's subtrahend or a random one against
   gather - sub (fatal unless 0), and the scatter-add backward (the
   sorted kernel where its plan takes the shape, every swept plan of it,
   and the atomic kernel it replaced) against index_add_ (fatal above
   GRAD_RTOL of the absolute sum meeting in a row; the sorted kernel
   also fatal unless two launches are equal bit for bit), also on
   all-equal neighbourhoods, all rows into one source row and on C = 3
   and C = 135 rows with K = 64, with times for kernel, the atomic kernel
   with its zeroed table, plain version, library call and, where a
   subtrahend is fused, the two-op form; host us a call at a K = 1 site
   beside index_select's; the backward on out-of-range indices at the
   SA2 shape, sorted and atomic kernel against the plain backward
   (only indices in [0, N) pass a gradient; -1 alone leaves the table
   zero). Then,
   with every count at 0, train steps on that batch: one at epoch 60
   (OCC/OSC positive, the reference weight switched), 8 at epoch 0, one
   more at epoch 60; the counts of one
   step must be FPS 5, ball query 5, three-NN 2, row gather 11, its
   backward 5, the interpolation's backward 2; every loss finite, the
   vote and objectness losses falling over the repeated steps; the same forward + backward with the plain
   ops on the card compared with the kernels' (loss within 1e-5
   relative, gradients within 1e-4 of their largest entry); step ms,
   peak memory and a torch.profiler trace of one step by kernel name
   (memsets and fill kernels counted);
7. the ScanRefer predict / evaluate path at run.sh's widths
   (--use_multiview --use_normal: 3 + 132 channels; batch 8, 8
   sentences, 40000 points; the use_con model as trained, seeded
   weights): the native loader library must build (no numpy path here);
   the stand-in assets (vlp3d_torch.data.standins) in a temporary
   directory, the model saved there with save_params, and `python -m
   vlp3d_torch.cli.predict` over them started in a process of its own
   (pred.json must parse and hold one record an annotation), which runs
   while this process goes on: make_synthetic_dataset (8 scenes of 50000
   points, 8 annotations each)
   through BatchIterator (4 worker threads) and cli.predict's
   predict_records on the card, with every count at 0 before and the
   counts of one batch after (FPS 5, ball query 5, gather 11, three-NN 2,
   fatal otherwise), one record an annotation; loader ms a batch (host
   clock) and predict ms a batch (wall clock to the records on the
   host); get_eval and final_eval_breakdown over the batch (Acc@0.25 /
   0.5 of random weights); the same batch with the plain ops on the
   card (chosen proposals equal, box corners within 1e-4); and
   cli.ground_eval over the stand-ins;
8. training at run.sh's flags (RUN_SH_TRAIN_FLAGS: 3 + 132 channels,
   40000 points, batch 8, 8 sentences, --use_con --use_diou_loss
   --coslr). `python -m vlp3d_torch.cli.train_3dvlp` with those flags
   plus --synthetic --epoch 2 --workdir <tmp> starts in a process of its
   own once phase 7's timed loader and predict runs are done, and then
   the same command with --epoch 3 --auto_resume (a thread runs the
   two, one after the other, beside the rest of phases 7 and 8; they
   print where their time goes from their logs' timestamps): each must
   exit 0; the first must leave
   model_last.pth, model.pth, log.jsonl, info.json, checkpoint_meta.json
   and TensorBoard event files, every logged loss finite; the second
   must say it continues at epoch 2 and train exactly epoch 2. In this
   process meanwhile: a Solver over 16 synthetic train scenes (two steps
   an epoch) and 3 val scenes (one partial batch) with the BatchNorm
   momentum schedule, seeded weights with phase 6's nudges, 2 epochs with
   every count at 0 first; each step must launch FPS 5, ball query 5,
   three-NN 2, the row gather 11, its backward 5, the interpolation's
   backward 2, and each eval batch one forward's worth; every logged
   number finite, the val
   records hold iou_rate_0.25/0.5, the snapshots and
   checkpoint_meta.json exist; step ms (synchronised), fetch ms, eval ms
   a batch, hbm_peak_mb (these times are taken on a card and host that
   the training CLI's process shares). Once the CLI's processes have
   ended, and with the card to itself, one forward + backward with
   remat=True against the same without it, from the Solver's weights and
   one of its batches and the same generator: loss within STEP_LOSS_RTOL,
   gradients within STEP_GRAD_TOL of the largest entry, BatchNorm
   statistics equal, launches REMAT_STEP (FPS and ball query still 5
   each); both steps' peak memory and ms;
9. with the card to itself, the HTTP server
   (vlp3d_torch.serve.make_server on 127.0.0.1:0) over phase 5's model
   (use_con=False) at serve batch 8: after a warm-up,
   12 concurrent /v1/ground requests with b64 clouds of 40960 x 135
   points and 1-8 queries each, and one xyz-only cloud, with every count
   at 0 first; all must answer 200, the counts must be one forward's
   worth a device batch, the mean occupancy above 1; each answer must
   name the proposal GroundingPredictor picks on that cloud alone, box
   values within BOX_TOL; a malformed body and a bad cloud get 400;
   p50 / p99 request ms and device-batch ms from /stats, and the split
   of a request on the server's threads (decode, resample and tokenise;
   the handler as a whole);
10. captioning at run.sh's widths (3 + 132 channels, 256 proposals, a
   6-layer d=128 decoder, vocab 30522, max_des_len 30). Built while the
   CLI processes run: CaptionPredictor over phase 5's model with seeded
   caption weights; the KV-cached greedy decode of phase 5's first
   batch (2048 captions) against greedy_decode_uncached, and beam width 1
   against greedy up to the first SEP, both by the tie rule (a row may
   differ only where the reference side's top-2 logit margin at the
   first differing step is below TIE_MARGIN; the excused rows are
   counted); the use_con caption model and the caption + MLM model on
   phase 6's batch, each kernel step against the plain-op step by
   check_kernel_step (the kernel run follows the plain run's side of 0
   at every ReLU input, which must lie within FLIP_TOL of 0 where they
   differ; loss within STEP_LOSS_RTOL, every probe's gradient within
   STEP_GRAD_TOL of its largest entry); a server with a ground and a
   caption service, warmed up, and each request's reference from the
   caption predictor alone.
   CLI processes: caption_predict and caption_eval over stand-in assets
   (started with phase 8's; pred.json's boxes 8 x 3 and string
   captions, every metric finite) and train_caption with run.sh's flags
   + --synthetic --epoch 1 --pretrain <phase 8's model.pth> beside the
   --auto_resume run (exit 0, its restored / fresh counts, cap_loss
   finite). With the card to itself, counts at 0 before each: one
   CaptionPredictor call on phase 5's second batch (one forward's
   launches), forward and decode timed apart for greedy and beam width
   3, peak memory, a trace of the greedy decode; 3 train steps of each
   caption model (each step FPS 5, ball query 5, three-NN 2, gather 11,
   its backward 5, the interpolation's backward 2; cap_loss, cap_acc,
   mlm_loss finite), step ms and peak memory; 6 concurrent /v1/caption
   requests (b64 clouds of 40960 x 135) and one /v1/ground: all 200,
   one forward's launches a device batch, captions equal to the
   predictor's alone by the tie rule, boxes within BOX_TOL;
11. question answering at run.sh's widths (3 + 132 channels, 256
   proposals, 8 questions a scene, the config's 8192 answers). Built
   while the CLI processes run: AnswerPredictor over phase 5's model
   with a seeded answer head, its top-10 answers of phase 5's first
   batch against the same forward with the plain ops (logits within
   VQA_SCORE_TOL of the largest; ids equal, or excused by the tie rule:
   the reference's logits of the two ids within TIE_MARGIN); the
   VQA-recipe model (use_con=False, phase 6's nudges) on phase 6's batch
   with seeded multi-hot answer labels and soft scores, the kernel step
   against the plain-op step by check_kernel_step, as phase 10's (12
   probes from SA1 to the answer head); a Solver eval batch over
   synthetic ScanQA scenes of 40000 points (one
   forward's launches; answer_acc_at1 <= answer_acc_at10 reported); a
   server with a ground and an answer service, warmed up, and each
   request's reference from the answer predictor alone. CLI process:
   train_qa with VQA_CLI_FLAGS + --synthetic --epoch 1 --pretrain
   <phase 8's model.pth> beside the --auto_resume run (exit 0, its
   restored / fresh counts, the answer head's 10 entries fresh,
   answer_loss finite, the val EM logged). With the card to itself,
   counts at 0 before each: one AnswerPredictor call on phase 5's
   second batch (one forward's launches; ids in range, best first),
   forward + top-10 timed with the batch on the card, peak memory; 3
   VQA-recipe train steps (Adam with coupled L2, one group, clip 1.0;
   each step FPS 5, ball query 5, three-NN 2, gather 11, its backward
   5, the interpolation's backward 2; answer_loss finite), step ms and
   peak memory; 4 concurrent /v1/answer requests (b64 clouds of 40960 x
   135, 1-7 questions) and one /v1/ground: all 200, one forward's
   launches a device batch, each request's top-10 ids equal to the
   predictor's alone by the tie rule, logits within VQA_SCORE_TOL;
12. the grounding model's options at run.sh's widths. Built while the
   CLI processes run: (a) a use_con model with every option on
   (FLAG_OPTIONS: the vote-weight predictor, the KL head, box masking,
   the reference's multiview read, DistilBERT, the lang-emb scorer, the
   regression head, no language classifier) from a seed with phase 6's
   nudges, on phase 6's batch: its evaluation forward against the
   plain-op forward (indices equal, the rows the reference read gathers
   equal, cluster_ref within CLUSTER_REF_TOL), and one train step
   against the plain-op step by check_kernel_step (both runs draw their
   box masks from one generator seed); (b) compute_dtype="bfloat16":
   phase 5's serving model (pred_ref equal and cluster_ref within
   CLUSTER_REF_TOL of the plain-op forward) and phase 6's step model
   (check_kernel_step), each beside its float32 twin; (c) one synthetic
   epoch each of Solver(reference=False) over a no_reference model and
   Solver(detection=False), launches counted, every logged loss finite.
   CLI process: train_3dvlp with run.sh's flags + --synthetic
   --no_reference --epoch 1 beside phase 8's first run (exit 0, finite
   losses, no reference term logged). With the card to itself, counts
   at 0 before each: the every-option evaluation forward and train step
   (one forward's and one step's launches each; median of 5 ms, peak
   memory), the reference read's (B, C, N) copy of the multiview
   channels timed alone, and the float32 and bfloat16 serving forwards
   and train steps (median of 5, peak memory; cluster_ref difference
   and pred_ref agreement of bfloat16 against float32);
13. data parallel at world size 1. While the CLI processes run:
   vlp3d_torch.parallel.distributed.dist_init with an explicit
   rendezvous of one process on a free 127.0.0.1 port, which must come
   up over NCCL (no gloo on the card; init_process_group and the first
   collective, where NCCL builds its communicator, timed);
   GroundingPredictor over make_mesh(0) (every local card) against the
   one-device predictor on phase 5's first batch and run_padded at
   occupancy 3 (pred_ref equal, cluster_ref within CLUSTER_REF_TOL).
   CLI process: `python -m torch.distributed.run --nproc_per_node 1 -m
   vlp3d_torch.cli.train_3dvlp --synthetic --smoke --epoch 1` beside
   phase 8's first run (exit 0, a group of one over NCCL, finite
   losses). With the card to itself: phase 6's model and batch twice, a
   step through the data-parallel path (make_train_step over a
   BatchShard of the group) against the one-process step from the same
   state and generator seed, the data-parallel run following the
   one-process run's side of 0 at every ReLU input (kinks, as
   check_kernel_step): loss within STEP_LOSS_RTOL, the DP_PROBE gradients
   and every BatchNorm running statistic within STEP_GRAD_TOL of their
   largest entry, the launches of each step PER_STEP; then DP_STEPS
   timed steps of each in turns (medians, peak memory above the resident
   models, every count at 0 before each step); the serve CLI with
   --data_devices 0 answering phase 9's first request with phase 9's
   proposals, and --data_devices 2 exiting with the host's one device;
14. ZeRO-1, tensor, pipeline and point-axis parallel at world size 1
   over NCCL (a group of its own), on phase 6's model and batch, with
   the card to itself: the ZeRO-1 step against phase 13's data-parallel
   step (parameters, gradients and whole moments bit-equal;
   optimizer_state_bytes beside the unsharded optimizer's); the TP step
   at tp 1 (every TP layer split over a model group of one, so every
   collective runs; its state dict in the one-process layout) against
   the one-process step, following its ReLU inputs and max pools, at
   phase 13's tolerances; PARALLEL_STEPS timed steps of the three in
   turns; sa1_order_witness (SA1 alone replayed on the one-process
   step's input and output gradient: its first-layer gradient with its
   own sums in four parts, in float64, and under a 1e-5 change of the
   output gradient; printed, not held); pipeline_text_encoder at S 1, M PIPE_MICROBATCHES against the
   6 sequential BERT-base layers (within PIPE_TOL); with every count at
   0, large_scene_front at B=8 x 40960 points against the dense SA1
   (indices and grouped rows equal; the FPS loop kernel once, the ball
   query and the merge once, three owned gathers) and
   apply_backbone_large_scene against the dense backbone (sa1_inds
   equal, outputs within BACKBONE_TOL); then each point-axis kernel
   against its plain version at SA1's shapes (the FPS loop at W = 1
   against the plain loop and the dense FPS, and its one-launch
   emulation of W = 2 and 4 ranks against the dense FPS, bit for bit,
   one launch a call; its streamed form on slabs of STREAM_NL points,
   past registers, at W = 1 and 2 against the dense FPS; the merge at
   W = 1 and 4 slabs against its plain
   version and the dense ball query; the owned gather at the front's
   three calls and on a second slab) and on the edge cases (ties across
   shards, an all-invalid row, a ball in one shard, across shards,
   empty), timed by cuda_ms, with bounds and host us; and, in a process
   of its own, a W = 2 launch whose peer never writes
   (tests/torch_stall_probe.py), which must trap and exit 3, at limits
   of 0.5 and 4.5 s (their times' difference measures the limit's
   clock);
15. the GloVe/LSTM task pipelines at their trainers' full widths
   (TaskPipelinesPhase; B 8 x N_TASK 40000 points, 132 channels, 256
   proposals): ScanQA with MCAN (train_scanqa's Config, 8864 answers,
   30-token GloVe questions; scene 0 a cloud of one repeated point whose
   proposals are all made non-objects, so that MCAN masks every key of
   the scene), RefNet (8 sentences a scene, LSTM 256) and CapNet
   (vocabulary 3433, 64 captions of 32 sos/eos-wrapped tokens, with
   num_locals -1 and CAPNET_LOCALS). Built while the CLI processes run:
   each evaluation forward against the plain-op forward (sampled indices
   equal; answer_scores / cluster_ref / lang_cap within CLUSTER_REF_TOL
   of max(1, the largest entry); the top-10 answers, the chosen
   proposals and each caption's greedy words equal or excused by the tie
   rule) and each step (the trainer's loss) against the plain-op step by
   check_kernel_step, following the plain run's ReLU inputs, max-pool
   choices and sampled indices. CLI processes, started with phase 8's:
   train_scanqa, train_3djcg_g and train_3djcg_c with --synthetic
   --epoch 1 (TASK_CLIS; the ScanRefer ones at batch 2, so that the 2
   synthetic scenes make one step): exit 0, the val metric printed,
   finite losses logged, best.json and the best and last snapshots. With
   the card to itself, after phase 14, counts at 0 before each: one
   forward's and one step's launches of each model (TASK_FORWARD /
   TASK_STEP: FPS 5, ball query 5, three-NN 2, gather 11, ScanQA's 10,
   its backward 5, the interpolation's 2), then the median ms of
   TASK_STEPS forwards and steps (the trainers' optimizers) and their
   peak memory;
16. the remaining variant models at run.sh's widths (VariantsPhase and
   VariantClis). Built while the CLI processes run: (a) JointNet with
   use_mlcv_net (MLCVNet's CGNL voting; 132 channels, SA
   2048/1024/512/256, 256 proposals, 6 BERT layers): its
   GroundingPredictor on phase 5's first batch against the plain ops
   (pred_ref equal, cluster_ref within CLUSTER_REF_TOL) and, with phase
   6's nudges, its train step on phase 6's batch against the plain-op
   step by check_kernel_step (MLCV_PROBE; following the plain run's
   ReLU inputs, max-pool choices and sampled indices); (b) the MLCVNet
   detector at B=8 x N=40960 (its own grounding batch): the evaluation
   forward (indices equal, outputs within CLUSTER_REF_TOL) and a step of
   the VoteNet detection loss by check_kernel_step (DETECTOR_PROBE);
   phase 5's grounding model on phase 6's batch gives the votes, the
   nudged MLCV model the proposal features and boxes of the rest:
   positive_match against the batch's reference boxes (finite); (c) the
   DETR head
   (DETR_WIDTHS: 256 proposals, 4 layers, d_model 288) over those votes:
   the evaluation forward and a training forward + backward of
   detr_loss against the plain ops (gradients within STEP_GRAD_TOL);
   (d) the xbert captioner (XBERT_WIDTHS: hidden 128, depth 4,
   vocabulary 30522): train logits of phase 6's sentences against the
   same run on the CPU (CLUSTER_REF_TOL of the largest logit; ids by the
   tie rule), the greedy decode of 8 x 256 captions against
   xbert_literal_decode by the tie rule; (e) LangCrossMLM on BERT-base
   text mode, finite logits and loss. CLI processes, started with phase
   8's: train_3dvlp --synthetic --smoke --use_mlcv_net (exit 0, finite
   losses, a snapshot with the CGNL block) and compute_multiview over
   MULTIVIEW's frames (2 scenes x 20 frames of 256 x 328 pixels, ENet
   on 16 and then 4 of them a launch, 50000 points a scene; exit 0, the hdf5 read back: one (50000, 128) float32
   dataset a scene, finite, the points behind the camera zero). With
   the card to itself, counts at 0 before each: one call's launches of
   each path held exactly (mlcv_serve and mlcv_step as PER_FORWARD /
   PER_STEP, the detector's as TASK's ScanQA counts, DETR_FORWARD /
   DETR_STEP, none on the xbert and MLM paths) and the median ms of
   VARIANT_STEPS with the peak memory; then the legacy InfoNCE over
   gather_negatives at world size 1 over NCCL (negatives_check);
17. PointPillars and the multiview hdf5 without h5py (PillarsPhase; its
   two predict processes, PillarClis, run beside phase 8's CLIs): the
   encoder at OpenPCDet's KITTI widths on PILLAR_ROWS seeded rows of
   PILLAR_POINTS points (two LiDAR-like rows of ~10 000 pillars, one
   uniform row past the 16 000-pillar cap, one row 30% out of range with
   a 20 000-point pillar): dynamic_voxelize and hard_voxelize equal to
   their plain versions bit for bit (every output; hard_voxelize also
   between two launches), each timed; with
   every count at 0, the evaluation forward
   against the plain-op forward (PILLAR_CANVAS_TOL of the canvas's
   largest entry) and a training forward + backward against the plain
   ops (canvas, point and parameter gradients and the BatchNorm
   statistics within STEP_GRAD_TOL), the launches of each held to
   PILLAR_FORWARD, the median ms and peak of PILLAR_STEPS forwards and
   steps; then, counts at 0, boxes_iou_bev
   over NMS_BOXES x NMS_BOXES jittered car boxes within IOU_TOL of the
   plain version (its operation count for the bound taken from the
   plain run's clips) and nms_rotated / nms_normal at NMS_THRESHOLDS
   equal to the plain scan over the kernel's own ranked IoU and, away
   from ties (NMS_TIE), over the plain IoU; the same checks (the keep
   masks on the kernel's IoU) on a uniform unclustered set, a crowded
   set (most pairs through the ordered clip), at NMS_RAGGED (no whole
   tile) and NMS at NMS_LARGE boxes (many 64-row scan blocks); the edge
   cases of tests/torch_pillar_cases.py (with the pairs whose clip
   passes 8 vertices: the kernels' 16-slot path), each kernel timed
   beside its plain version and on each set of NMS_BOXES (sets_ms),
   with the share of pairs each of the kernels' screens settles
   (screens); then the loader's batches through
   --multiview_hdf5 (the port's stand-ins) equal to the baked npy's, the
   committed
   h5py-written fixtures read and held to their formula, and the two
   predict processes' pred.json equal. Its traces of a hard_voxelize
   call, an evaluation forward and an NMS call come from a process of
   its own (--pillar-traces): late in a long process torch.profiler
   loses device events; a trace that lacks a hand kernel is reported as
   not measured, and the NMS and hard_voxelize traces' split by CUDA
   function goes into the kernels line (split_ms), with the hard call's
   device operations (at most HARD_DEVICE_OPS, one memset: fatal
   otherwise);
18. print {"kernels": [...]} with every kernel of the main paths (the
   CUDA functions behind each in kernel_functions, each found in its
   source's built library, host_us beside the
   times, the launches of each path, and per_step and per_remat_step
   as counted in phase 8), the whole command's wall time, the
   card's name and power limit, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# fp32 instructions a second outside the tensor cores when none is an FMA
# (the data sheet's 67e12 counts an FMA as two): 128 an SM a clock x 132
# SMs x 1.98 GHz. The distance tests are built without contraction
# (--fmad=false, __fmul_rn / __fadd_rn), and the gathers' subtractions and
# the backward's additions are single instructions too.
FP32_OPS = 33.4e12
SMS = 132
# fp32 instructions a distance test costs: 3 sub, 3 mul, 2 add, 1 min/cmp
OPS_PER_TEST = 9
B, N = 8, 40960
CLUSTER_REF_TOL = 1e-4
INTERP_TOL = 1e-5
DIST_TOL = 1e-6
# kernel step against plain-op step on the card: the forward is the same
# arithmetic on the same indices, the backward differs in the order the
# scatter-add sums colliding rows
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_TOL = 1e-4  # of the gradient tensor's largest entry
TRAIN_STEPS_EPOCH0 = 8
# kernel launches of one forward, and of one train step's backward
PER_FORWARD = {"fps": 5, "ball_query": 5, "three_nn": 2, "group_points": 11,
               "group_points_grad": 0, "three_interpolate_grad": 0,
               "fps_shard_loop": 0, "ball_query_merge": 0, "gather_owned": 0,
               "dynamic_voxelize": 0, "hard_voxelize": 0, "boxes_iou_bev": 0,
               "nms_bev": 0}
PER_STEP = dict(PER_FORWARD, group_points_grad=5, three_interpolate_grad=2)
WEIGHT_TOL = 1e-6  # interpolation weights, kernel against plain
REPO = os.path.dirname(os.path.abspath(__file__))
# Python's bytecode of what this run and its CLI processes import, kept in
# the checkout's build directory: where the interpreter may not write it
# beside the sources, every process would compile torch's sources anew
PYCACHE = os.path.join(REPO, "build", "pycache")
# the predict phase: run.sh's flags, synthetic scenes through the loader
RUN_SH_FLAGS = ["--use_multiview", "--use_normal", "--batch_size", "8",
                "--lang_num_max", "8", "--num_points", "40000",
                "--no_caption", "--use_con", "--num_workers", "4"]
PREDICT_SCENES, PREDICT_POINTS, PREDICT_ANNS = 8, 50000, 8
# (input channels, SA points, proposals, BERT layers, points, sentences)
PREDICT_WIDTHS = (132, (2048, 1024, 512, 256), 256, 6, 40000, 8)
BOX_TOL = 1e-4  # predicted box corners, kernel against plain ops
# the training phase: run.sh's flags exactly (run.sh:9-14)
RUN_SH_TRAIN_FLAGS = ["--use_multiview", "--use_normal", "--batch_size", "8",
                      "--epoch", "200", "--lang_num_max", "8", "--coslr",
                      "--lr", "0.002", "--no_caption", "--lang_num_aug", "0",
                      "--unfreeze", "6", "--debug", "--use_con",
                      "--use_diou_loss"]
# 16 train scenes of 8 sentences: two steps an epoch at batch 8; 3 val
# scenes: one partial batch
SOLVER_TRAIN_SCENES, SOLVER_VAL_SCENES = 16, 3
# a remat step recomputes the SA1-4 neighbourhood gathers and the FP1-2
# interpolations; FPS and ball query stay outside the checkpoints
REMAT_STEP = dict(PER_STEP, group_points=15, three_nn=4)
# the HTTP phase: concurrent requests, and how long the batcher waits to
# fill a device batch
HTTP_REQUESTS = 12
HTTP_MAX_WAIT_MS = 20.0
# the captioning phase: run.sh's widths (decoder layers, d_model, vocab,
# max_des_len, proposals, feature channels)
CAPTION_WIDTHS = (6, 128, 30522, 30, 256, 132)
# caption_predict / caption_eval: run.sh's flags; they decode captions
# whatever --no_caption says
CAPTION_CLI_FLAGS = [f for f in RUN_SH_FLAGS if f != "--no_caption"]
CAPTION_BEAMS = 3
CAPTION_STEPS = 3  # timed caption train steps of each model
CAPTION_HTTP_REQUESTS = 6
SEP = 102
# two decodes agree when their rows are equal, or a row's first differing
# step had a top-2 logit margin below this on the reference side
TIE_MARGIN = 1e-4
# a ReLU input that lands on the other side of 0 in the kernel and the
# plain-op runs must lie within this of 0
FLIP_TOL = 1e-3
# a sampled index that differs between two runs of the same forward on
# inputs that differ within rounding (index_ties) must be this near a
# tie: an FPS pick's running distance within this fraction of the
# step's largest, a ball membership that flipped within this fraction of
# r^2 of the radius
INDEX_TIE_TOL = 1e-3
# the question-answering phase: run.sh's widths and the config's answer
# vocabulary (input channels, proposals, answers, questions a scene)
VQA_WIDTHS = (132, 256, 8192, 8)
VQA_TOPK = 10
VQA_STEPS = 3  # timed VQA-recipe train steps
VQA_HTTP_REQUESTS = 4
VQA_SCORE_TOL = 1e-4  # answer logits, kernel against plain, of the largest
# train_qa's process: run.sh's widths; the synthetic ScanQA set holds 2
# scenes of 4 questions, so a batch of 2 gives one step and one eval batch
VQA_CLI_FLAGS = ["--use_multiview", "--use_normal", "--lang_num_max", "8",
                 "--batch_size", "2"]
# the options phase: every option of the grounding model at once, at
# run.sh's widths (input channels, SA points, proposals, text-encoder
# layers, sentences)
FLAG_OPTIONS = dict(use_distil=True, use_lang_emb=True, use_reg_head=True,
                    use_vote_weight=True, mask_box=True,
                    reference_obj_gather=True, use_kl_loss=True,
                    use_lang_classifier=False)
FLAG_WIDTHS = (132, (2048, 1024, 512, 256), 256, 6, 8)
# gradients held in the every-option step: SA1 to the options' heads
FLAG_PROBE = ["backbone_net.sa1.mlp_module.layer0.conv.weight",
              "backbone_net.fp2.mlp.layer0.conv.weight",
              "proposal.votes_weight_predictor.0.weight",
              "proposal.vote_aggregation.mlp_module.layer0.conv.weight",
              "proposal.proposal.alpha_predictor.weight",
              "relation.obj_embedding.0.weight",
              "relation.features_concat.0.weight",
              "match.lang_emb_cross_attn.attention.fc_q.weight",
              "match.lang_emb_proj.0.weight", "match.reg_head.0.weight",
              "match.match.0.weight", "lang.proj.weight"]
# the bfloat16 step's gradients, kernel against plain run, of each
# tensor's largest entry: a gradient is rounded to bfloat16 where it
# crosses a bfloat16 layer, and one bfloat16 unit is 2^-8 of a value
BF16_STEP_GRAD_TOL = 2.0 ** -6
# phase 13: the gradients held in the data-parallel step, SA1 to the
# language classifier
DP_PROBE = ["backbone_net.sa1.mlp_module.layer0.conv.weight",
            "backbone_net.sa2.mlp_module.layer0.conv.weight",
            "backbone_net.sa3.mlp_module.layer0.conv.weight",
            "backbone_net.sa4.mlp_module.layer0.conv.weight",
            "backbone_net.fp1.mlp.layer0.conv.weight",
            "backbone_net.fp2.mlp.layer0.conv.weight", "vgen.conv3.weight",
            "proposal.vote_aggregation.mlp_module.layer0.conv.weight",
            "proposal.proposal.box_predictor.weight",
            "relation.features_concat.0.weight", "match.match.0.weight",
            "lang.lang_cls.0.weight"]
DP_STEPS = 9  # timed train steps of each path in phase 13
# phase 14 and --ranks N: timed steps of each parallel mode, the
# pipeline's microbatches, the pipelined text layers against the
# sequential ones and the point-sharded backbone against the dense one
# (of the output's largest entry: the same layers on other row blocks,
# cuBLAS may pick other kernels; SA1's split first layer against the
# folded one)
PARALLEL_STEPS = 5
PIPE_MICROBATCHES = 4
PIPE_TOL = 1e-5
BACKBONE_TOL = 1e-4
# the point-axis kernels, launched on phase 14's front end only
SP_KERNELS = ("fps_shard_loop", "ball_query_merge", "gather_owned")
# launches of the point-sharded SA1 front end: the FPS loop (one launch a
# call), the slab's ball query and the merge, three owned gathers (the
# centres, the xyz rows, the feature rows)
SP_FRONT = {"fps_shard_loop": 1, "ball_query": 1, "ball_query_merge": 1,
            "gather_owned": 3}
STALL_LIMIT_S = 0.5  # the stalled-peer probe's spin limit
STALL_SPREAD_S = 4.0  # its second run's limit, this much longer
# a slab past registers (a 16-block cluster's share over 8192 points):
# the FPS loop's streamed form, checked on B 2 rows at 256 centres
STREAM_NL = 140000
BF16_PROBE = ["backbone_net.sa1.mlp_module.layer1.conv.weight",
              "backbone_net.sa2.mlp_module.layer0.conv.weight",
              "backbone_net.fp2.mlp.layer1.conv.weight", "vgen.conv3.weight",
              "proposal.vote_aggregation.mlp_module.layer0.conv.weight",
              "relation.features_concat.0.weight", "match.match.0.weight"]

# phase 15: the GloVe/LSTM task pipelines at their trainers' full widths
# (train_scanqa: Config(DatasetConfig(num_points=40000), ModelConfig());
# train_3djcg_g / _c: 8 sentences a scene), B=8 scenes of N_TASK points,
# GLOVE_T-token questions and descriptions, CAPTION_T-token sos/eos-wrapped
# captions (max_des_len 30 + 2)
N_TASK = 40000
GLOVE_T, CAPTION_T = 30, 32
SCANQA_ANSWERS = 8864  # the ScanQA model's default answer vocabulary
CAPNET_VOCAB, CAPNET_LOCALS = 3433, 10
TASK_STEPS = 5  # timed forwards and steps of each task model
# gradients held in each task model's kernel step, SA1 to its heads
TASK_PROBES = {
    "scanqa": ["detection_backbone.sa1.mlp_module.layer0.conv.weight",
               "detection_backbone.fp2.mlp.layer0.conv.weight",
               "voting_net.conv3.weight",
               "proposal_net.vote_aggregation.mlp_module.layer0.conv.weight",
               "proposal_net.conv3.weight", "lang_net.lstm.weight_ih_l0",
               "lang_net.lstm.weight_hh_l0",
               "fusion_backbone.enc_list.0.mhatt.linear_q.weight",
               "fusion_backbone.dec_list.1.mhatt2.linear_q.weight",
               "attflat_visual.mlp.fc.linear.weight",
               "object_cls.3.weight", "lang_cls.3.weight",
               "answer_cls.3.weight"],
    "refnet": ["backbone_net.sa1.mlp_module.layer0.conv.weight",
               "backbone_net.fp2.mlp.layer0.conv.weight",
               "proposal.vote_aggregation.mlp_module.layer0.conv.weight",
               "relation.features_concat.0.weight", "match.match.0.weight",
               "lang.lstm.weight_ih_l0", "lang.lstm.weight_hh_l0",
               "lang.lang_cls.1.weight", "lang_proj.weight",
               "lang_emb_proj.weight"],
    "capnet": ["backbone_net.sa1.mlp_module.layer0.conv.weight",
               "backbone_net.fp2.mlp.layer0.conv.weight",
               "proposal.vote_aggregation.mlp_module.layer0.conv.weight",
               "relation.features_concat.0.weight",
               "caption.word_proj.weight", "caption.map_previous.weight",
               "caption.obj_fc.weight",
               "caption.dec_att2.attention.fc_q.weight",
               "caption.map_lang.weight", "caption.classifier.weight"],
}
TASK_PROBES["capnet_locals"] = TASK_PROBES["capnet"]
# the output each evaluation forward is held on
TASK_OUTPUT = {"scanqa": "answer_scores", "refnet": "cluster_ref",
               "capnet": "lang_cap"}
# launches of one forward and one step: the ScanQA detector has no
# relation module, so no reference-read gather
TASK_FORWARD = {"scanqa": dict(PER_FORWARD, group_points=10),
                "refnet": PER_FORWARD, "capnet": PER_FORWARD}
TASK_STEP = {"scanqa": dict(PER_STEP, group_points=10),
             "refnet": PER_STEP, "capnet": PER_STEP}
# the trainers as processes: module -> (flags beside --synthetic --epoch 1,
# a train-log loss key, the val metric, the best snapshot). The synthetic
# ScanRefer sets hold 2 scenes (one chunk of 5 sentences each): batch 2
# gives one step; the ScanQA set's 8 questions make one batch of 8
TASK_CLIS = {
    "train_scanqa": ([], "answer_loss", "answer_acc_1", "model"),
    "train_3djcg_g": (["--batch_size", "2"], "ref_loss", "iou_rate_0.5",
                      "ground_model"),
    "train_3djcg_c": (["--batch_size", "2"], "cap_loss", "cap_acc",
                      "caption_model"),
}

# phase 16: the remaining variant models at run.sh's widths. MLCVNet's CGNL
# voting in JointNet (its serving forward and train step) and the
# standalone detector launch what their plain twins do (the detector has
# no relation module: no reference-read gather); the DETR head's vote
# aggregation is one SA module (FPS, ball query, the centre and the
# neighbourhood gathers; the gather's backward in a step)
# (not the CGNL's p and g: the GroupNorm after the block normalises each
# group's att * t over the group, so att's scale cancels and p and g get
# only an eps / att^2 share of a gradient, rounding noise in either run)
MLCV_PROBE = ["backbone_net.sa1.mlp_module.layer0.conv.weight",
              "backbone_net.fp2.mlp.layer0.conv.weight", "vgen.sa1.t.weight",
              "vgen.sa1.z.weight", "vgen.sa1.gn.weight",
              "vgen.conv3.weight",
              "proposal.vote_aggregation.mlp_module.layer0.conv.weight",
              "proposal.proposal.box_predictor.weight",
              "relation.features_concat.0.weight", "match.match.0.weight",
              "lang.lang_cls.0.weight"]
DETECTOR_PROBE = ["backbone_net.sa1.mlp_module.layer0.conv.weight",
                  "backbone_net.fp2.mlp.layer0.conv.weight",
                  "vgen.sa1.t.weight", "vgen.conv3.weight",
                  "pnet.vote_aggregation.mlp_module.layer0.conv.weight",
                  "pnet.cgnl1.t.weight", "pnet.cgnl2.z.weight",
                  "pnet.conv1.weight", "pnet.conv3.weight"]
DETECTOR_FORWARD = dict(PER_FORWARD, group_points=10)
DETECTOR_STEP = dict(PER_STEP, group_points=10)
ZERO_LAUNCHES = {k: 0 for k in PER_FORWARD}
DETR_FORWARD = dict(ZERO_LAUNCHES, fps=1, ball_query=1, group_points=2)
DETR_STEP = dict(DETR_FORWARD, group_points_grad=1)
# the DETR head's reference configuration (proposal_module_detr.py:87-88)
DETR_WIDTHS = dict(num_proposal=256, n_layers=4, d_model=288, heads=8,
                   d_ff=2048)
# the xbert captioner: hidden, depth, vocabulary, decode steps; 32-token
# train captions
XBERT_WIDTHS = dict(hidden_size=128, depth=4, vocab_size=30522, max_len=32)
XBERT_T = 32
VARIANT_STEPS = 3  # timed forwards and steps of each phase-16 path
# compute_multiview's process: scenes x frames of H x W pixels (ENet's
# 328 x 256 input, 41 x 32 feature maps), points a scene, frames a launch
MULTIVIEW = dict(scenes=2, frames=20, h=256, w=328, points=50000)
# the contrastive negatives: B scenes x L sentences against K proposals
# a scene, 128-d embeddings (run.sh's widths)
NEG_WIDTHS = (8, 8, 256, 128)

# phase 17: PointPillars at OpenPCDet's KITTI pointpillar.yaml widths
# (voxel 0.16 x 0.16 x 4 m over [0, 69.12] x [-39.68, 39.68] x [-3, 1],
# 32 points a pillar, 16000 pillars, 64 channels; NMS_PRE_MAXSIZE 4096,
# NMS_THRESH 0.01), B rows of a KITTI frame's point count
PILLAR_VOXEL = (0.16, 0.16, 4.0)
PILLAR_RANGE = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
PILLAR_SLOTS, PILLAR_VOXELS = 32, 16000
PILLAR_ROWS, PILLAR_POINTS = 4, 120000
PILLAR_CHANNELS = 64
# launches of one encoder forward (a step's backward launches none)
PILLAR_FORWARD = dict(ZERO_LAUNCHES, dynamic_voxelize=1, hard_voxelize=1)
# the CUDA functions behind each PointPillars kernel, in launch order;
# hard_voxelize's entry point launches four after the dynamic kernel and
# one memset: HARD_DEVICE_OPS device operations a call
PILLAR_FUNCTIONS = {
    "dynamic_voxelize": ["dynamic_voxelize_kernel"],
    "hard_voxelize": ["voxel_head_count_kernel", "voxel_scan_kernel",
                      "voxel_place_kernel", "voxel_write_kernel"],
    "boxes_iou_bev": ["box_corners_kernel", "iou_tile_kernel"],
    "nms_bev": ["box_corners_kernel", "nms_mask_kernel", "nms_scan_kernel"],
}
HARD_DEVICE_OPS = 6
PILLAR_CANVAS_TOL = 1e-6  # of the canvas's largest entry
PILLAR_STEPS = 5  # timed forwards and steps of the encoder
NMS_BOXES = 4096
# NMS beside the main size: ragged tiles, and many 64-row scan blocks
NMS_RAGGED, NMS_LARGE = (4095, 4097), 20000
# phase 17's predict processes: on the baked npy, and through the hdf5
PILLAR_PREDICTS = ("predict", "predict --multiview_hdf5")
NMS_THRESHOLDS = (0.01, 0.5)
IOU_TOL = 1e-6  # rotated IoU, kernel against plain
NMS_TIE = 1e-5  # a ranked pair this near the threshold may decide apart
# fp32 operations of one box's corners (centre, half sizes, sin, cos,
# four rotated corners), beside the clip's per pair
OPS_CORNERS = 72


_T0 = time.perf_counter()


def child_env() -> dict:
    """The environment of a CLI process: this run's bytecode cache."""
    env = dict(os.environ, PYTHONPYCACHEPREFIX=PYCACHE)
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    return env


def fail(msg: str):
    raise RuntimeError(msg)


def stamp(tag: str, what: str) -> None:
    """Where the run's wall time goes: a line at the end of each step."""
    print(f"[{tag}] {what} done at {time.perf_counter() - _T0:.1f} s")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


_SLEEP_CYCLES_PER_MS = []


def sleep_cycles_per_ms(torch) -> float:
    """Clock cycles of torch.cuda._sleep that take one ms on this card."""
    if not _SLEEP_CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda._sleep(cycles)  # warm
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn over reps launches, by CUDA events. The
    launches queue behind a device-side sleep that lasts until the host
    has enqueued all of them (1.5x the host time the warm-up calls took,
    at most 200 ms), so a kernel shorter than its wrapper's host time is
    timed on the device, not at the host's launch rate."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / max(warmup, 1)
    torch.cuda.synchronize()
    sleep_ms = min(1.5 * host_ms * reps + 0.5, 200.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms(torch)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def index_err(torch, got, want) -> float:
    """Largest absolute difference of two integer tensors of one shape
    (a shape mismatch is infinite)."""
    if got.shape != want.shape:
        return float("inf")
    if got.numel() == 0:
        return 0.0
    return float((got.long() - want.long()).abs().max().item())


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def plain_ops():
    """Route every kernel wrapper to its plain version (for the plain-op
    reference forward and backward on the card); restored on exit."""
    smp = importlib.import_module("vlp3d_torch.ops.sampling")
    bq = importlib.import_module("vlp3d_torch.ops.ball_query")
    itp = importlib.import_module("vlp3d_torch.ops.interpolate")
    grp = importlib.import_module("vlp3d_torch.ops.grouping")
    saved = (smp._fps_cuda, bq._ball_query_cuda, itp._three_nn_cuda,
             itp._interpolate_features_cuda, grp._gather_rows)

    def bq_plain(radius, nsample, xyz, new_xyz, with_count):
        idx, cnt = bq.ball_query_plain(radius, nsample, xyz, new_xyz)
        return idx, (cnt if with_count else None)

    smp._fps_cuda = smp.fps_plain
    bq._ball_query_cuda = bq_plain
    itp._three_nn_cuda = itp.three_nn_plain
    itp._interpolate_features_cuda = itp.interpolate_features_plain
    grp._gather_rows = grp.group_points_plain
    try:
        yield
    finally:
        (smp._fps_cuda, bq._ball_query_cuda, itp._three_nn_cuda,
         itp._interpolate_features_cuda, grp._gather_rows) = saved


def fps_variants(n: int):
    """Every (blocks a row, points a thread) of the points-in-registers
    FPS kernel that holds a row of n points within the threads its
    register budget allows (the limits of vlp3d_torch/csrc/fps.cu),
    leaving out those whose threads would mostly hold padding."""
    smp = importlib.import_module("vlp3d_torch.ops.sampling")
    for blocks in ((8, 16) if n > 4096 else (1, 2, 4)):
        share = -(-n // blocks)
        for points, limit in smp._REGS_THREADS.items():
            threads = 32 * -(-share // (32 * points))
            if threads <= limit and (points == 2 or share > 16 * points):
                yield blocks, points


def check_fps_edges(torch, cloud):
    """Phase 4, FPS where trouble is likely: every case through the
    wrapper's own choice of kernel and, for short rows, again through a
    cluster, indices equal to the plain version's (fatal otherwise)."""
    from vlp3d_torch import ops
    from vlp3d_torch.ops import _kernels
    from vlp3d_torch.ops.sampling import fps_plain

    smp = importlib.import_module("vlp3d_torch.ops.sampling")
    cloud = cloud.contiguous()
    dev = cloud.device
    cases = []

    def case(name, xyz, npoint, plans=(None,)):
        xyz = xyz.contiguous()
        want = fps_plain(xyz, npoint)
        for plan in plans:
            got = (ops.furthest_point_sample(xyz, npoint) if plan is None
                   else smp._fps_cuda(xyz, npoint, plan))
            torch.cuda.synchronize()
            err = index_err(torch, got, want)
            if err != 0:
                fail(f"fps edge case {name} (plan {plan}): indices differ "
                     f"from the plain version by up to {err}")
        cases.append(name)
        return want

    n = cloud.shape[1]
    short = cloud[:, :2048]
    both = (None, (16, 8), (8, 16), (16, 32))
    small = (None, (1, 32), (1, 8), (4, 8), (16, 2))
    # ties across blocks: the second half repeats the first
    dup = cloud.clone()
    dup[:, n // 2:] = dup[:, :n // 2]
    case("duplicated halves, N=40960", dup, 256, both)
    dup = short.clone()
    dup[:, 1024:] = dup[:, :1024]
    case("duplicated halves, N=2048", dup, 256, small)
    few = cloud[:, :7].repeat(1, 6000, 1)[:, :n]
    case("7 distinct points, N=40960", few, 64, both)
    case("7 distinct points, N=1022", few[:, :1022], 64, small)
    # blocks whose whole share is invalid, rows with none or one valid point
    tail = cloud.clone()
    tail[:, n // 4:] = 0.0
    tail[1] = 0.0
    tail[2] = 0.0
    tail[2, 31000] = 1.5
    want = case("zero tail of 3N/4, an all-zero row, a row with one valid "
                "point, N=40960", tail, 128, both)
    if (want[1] != 0).any() or (want[2, 1:] != 31000).any():
        fail("fps edge case: the plain version itself is off")
    tail = short.clone()
    tail[:, 300:] = 0.0
    tail[1] = 0.0
    tail[2] = 0.0
    tail[2, 2047] = 1.5
    case("zero tail, all-zero row, one valid point, N=2048", tail, 128, small)
    # N that no block x thread x point grid divides, npoint at its ends
    case("N=40000", cloud[:, :40000], 128, both)
    case("N=1000", cloud[:, :1000], 128, small)
    case("N=33", cloud[:, :33], 20, (None, (1, 4), (4, 2)))
    case("npoint=1", cloud, 1, both)
    case("npoint=1, N=512", cloud[:, :512], 1, small)
    sparse = cloud[:, :33].clone()
    sparse[:, 10:] = 0.0
    case("npoint 20 > 10 valid points", sparse, 20, (None, (4, 2)))
    # more clusters than the card runs at once must queue
    for b in (1, 3, 9, 16):
        xyz = cloud[torch.arange(b, device=dev) % cloud.shape[0]].clone()
        xyz += torch.arange(b, device=dev)[:, None, None] * 0.01
        case(f"B={b}, N=40960", xyz, 64, both)
        case(f"B={b}, N=1024", xyz[:, :1024], 64, small)
    # rows too long for a cluster: the one-block kernel, global scratch
    big = torch.rand(2, 1 << 18, 3, device=dev) * 6
    if smp._fps_plan(big.shape[1]) is not None:
        fail("a 262144-point row should take the global-scratch kernel")
    case("N=262144 (global scratch)", big, 32)
    case("N=65536 (cluster)", big[:, :1 << 16], 32, (None, "global"))
    # a launch the card refuses raises; nothing else is tried
    for plan in ((32, 8), (1, 3), (1, 2)):
        try:
            smp._fps_cuda(cloud, 8, plan)
        except RuntimeError:
            continue
        fail(f"fps: plan {plan} should have been refused")
    torch.cuda.synchronize()
    ops.furthest_point_sample(cloud, 8)  # the refusals left no error behind
    torch.cuda.synchronize()
    occ = {f"{c}x{p}": _kernels.function("fps", "vlp3d_fps_max_clusters")(
        c, n, p) for c, p in fps_variants(n)}
    print(f"[4] fps: {len(cases)} edge cases equal to plain: "
          + "; ".join(cases))
    print(f"[4] fps: clusters of the N={n} kernel the card runs at once "
          f"(blocks x points a thread: clusters): {json.dumps(occ)}; refused plans "
          "raise")


def load_test_module(name: str):
    """A numpy-only helper module of tests/, loaded by its path (a
    ``tests`` package installed elsewhere may shadow the directory)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ball_query_err(torch, radius, nsample, xyz, ctr, want, plan):
    """Largest index or count difference of the ball query under ``plan``
    (None: the wrapper's choice), with and without counts, against the
    plain version's (idx, count) ``want``."""
    bq = importlib.import_module("vlp3d_torch.ops.ball_query")
    idx, _ = bq._ball_query_cuda(radius, nsample, xyz, ctr, False, plan)
    idx_c, cnt = bq._ball_query_cuda(radius, nsample, xyz, ctr, True, plan)
    torch.cuda.synchronize()
    return max(index_err(torch, idx, want[0]),
               index_err(torch, idx_c, want[0]),
               index_err(torch, cnt, want[1]))


def check_ball_query_site(torch, site, xyz, ctr, radius, nsample):
    """Phase 4, ball query at one main-path site: the wrapper's kernel,
    the warp-a-centre kernel it replaced and every swept tile plan, each
    with and without counts, against the plain version (fatal unless the
    difference is 0); device time of each (sweep_ms: the evidence for
    _ball_query_plan)."""
    from vlp3d_torch import ops

    bq = importlib.import_module("vlp3d_torch.ops.ball_query")
    b, n, _ = xyz.shape
    m = ctr.shape[1]
    want = bq.ball_query_plain(radius, nsample, xyz, ctr)
    plan = bq._ball_query_plan(n, nsample)
    idx = ops.ball_query(radius, nsample, xyz, ctr)
    idx_c, cnt_c = ops.ball_query_with_count(radius, nsample, xyz, ctr)
    torch.cuda.synchronize()
    err = max(index_err(torch, idx, want[0]), index_err(torch, idx_c, want[0]),
              index_err(torch, cnt_c, want[1]))
    if err != 0:
        fail(f"ball query {site}: kernel indices or counts differ from "
             f"the plain version by up to {err}")
    if ball_query_err(torch, radius, nsample, xyz, ctr, want, "warp") != 0:
        fail(f"ball query {site}: the warp-a-centre kernel differs from plain")

    def run(p, with_count=False):
        return lambda: bq._ball_query_cuda(radius, nsample, xyz, ctr,
                                           with_count, p)

    sweep = {}
    for cand in bq.tile_plans(n, nsample):
        if ball_query_err(torch, radius, nsample, xyz, ctr, want, cand) != 0:
            fail(f"ball query {site}: plan {cand} differs from plain")
        sweep["%dx%dx%d" % cand] = cuda_ms(torch, run(cand), 3, warmup=1)
    pidx, pcnt = want
    # the early-exit scan of this data: up to the nsample-th hit
    full = pcnt >= nsample
    scanned = torch.where(full, pidx[..., -1].long() + 1, n).sum().item()
    nbytes = b * n * 12 + b * m * 12 + b * m * nsample * 4
    bms, by = bound_ms(nbytes, scanned * OPS_PER_TEST)
    bcms, _ = bound_ms(nbytes + b * m * 4, b * m * n * OPS_PER_TEST)
    row = dict(
        site=site, shape=[b, n, m, radius, nsample],
        plan=list(plan) if plan else "warp",
        ms=cuda_ms(torch, lambda: ops.ball_query(radius, nsample, xyz, ctr),
                   20),
        with_count_ms=cuda_ms(torch, lambda: ops.ball_query_with_count(
            radius, nsample, xyz, ctr), 20),
        warp_kernel_ms=cuda_ms(torch, run("warp"), 20),
        warp_kernel_with_count_ms=cuda_ms(torch, run("warp", True), 20),
        plain_ms=cuda_ms(torch, lambda: bq.ball_query_plain(
            radius, nsample, xyz, ctr), 2, warmup=1),
        bound_ms=bms, bound_by=by, with_count_bound_ms=bcms,
        points_scanned=scanned, tests_with_count=b * m * n,
        max_abs_err=err, mean_count=pcnt.float().mean().item(),
        filled_share=full.float().mean().item(),
        best_tile_plan=min(sweep, key=sweep.get) if sweep else None,
        sweep_ms=sweep)
    return row


def check_ball_query_edges(torch, cloud):
    """Phase 4, ball query where a row split into segments is likely to go
    wrong (tests/torch_bq_cases.py: hits across segment boundaries,
    exactly nsample hits ending at a segment's last point, every hit in
    the last segment, empty and full balls, n below nsample, n = 33,
    ragged n and m, points at exactly the radius), each through the
    wrapper, the warp-a-centre kernel and every swept tile plan, with and
    without counts; then B = 1 / 3 / 9 at the SA1 shape; then plans the
    card must refuse. Fatal unless every difference is 0."""
    cases = load_test_module("torch_bq_cases")
    BQ_CASES, ball_query_case = cases.BQ_CASES, cases.ball_query_case
    bq = importlib.import_module("vlp3d_torch.ops.ball_query")
    dev = cloud.device
    tried = 0
    for name in BQ_CASES:
        xyz, ctr, radius, nsample = ball_query_case(name)
        xyz = torch.from_numpy(xyz).to(dev)
        ctr = torch.from_numpy(ctr).to(dev)
        want = bq.ball_query_plain(radius, nsample, xyz, ctr)
        for plan in (None, "warp", *bq.tile_plans(xyz.shape[1], nsample)):
            tried += 1
            if ball_query_err(torch, radius, nsample, xyz, ctr, want,
                              plan) != 0:
                fail(f"ball query edge case {name} (plan {plan}): indices "
                     "or counts differ from the plain version")
    n = cloud.shape[1]
    for b in (1, 3, 9):
        xyz = cloud[torch.arange(b, device=dev) % cloud.shape[0]].clone()
        xyz += torch.arange(b, device=dev)[:, None, None] * 0.01
        ctr = xyz[:, ::20][:, :2048].contiguous()
        want = bq.ball_query_plain(0.2, 64, xyz, ctr)
        for plan in (None, (256, 16, 512), (64, 3, 512)):
            tried += 1
            if ball_query_err(torch, 0.2, 64, xyz, ctr, want, plan) != 0:
                fail(f"ball query B={b}, N={n} (plan {plan}) differs")
    # a 70000-point segment: 4-byte hit lists
    xyz = torch.cat([cloud[:2], cloud[:2, :29040] + 7.0], 1).contiguous()
    ctr = xyz[:, ::500].contiguous()
    want = bq.ball_query_plain(0.2, 64, xyz, ctr)
    for plan in ((128, 1, 512), (64, 2, 256)):
        tried += 1
        if ball_query_err(torch, 0.2, 64, xyz, ctr, want, plan) != 0:
            fail(f"ball query N=70000 (plan {plan}) differs")
    xyz, ctr = cloud[:, :4096].contiguous(), cloud[:, :64].contiguous()
    for plan, nsample in (((1024, 1, 512), 200), ((2048, 1, 512), 16),
                          ((64, 17, 512), 16), ((33, 1, 512), 16),
                          ((64, 1, 6), 16)):
        try:
            bq._ball_query_cuda(0.3, nsample, xyz, ctr, False, plan)
        except RuntimeError:
            continue
        fail(f"ball query: plan {plan} should have been refused")
    want = bq.ball_query_plain(0.3, 16, xyz, ctr)
    if ball_query_err(torch, 0.3, 16, xyz, ctr, want, None) != 0:
        fail("ball query after refused plans differs")
    print(f"[4] ball query: {len(BQ_CASES)} edge cases, B = 1 / 3 / 9 and "
          f"a 70000-point segment equal to plain under {tried} (case, kernel "
          "plan) pairs, with and without counts: " + "; ".join(BQ_CASES)
          + "; refused plans raise")


def replaced_route(unknown, known, feats):
    """The interpolation as the FP module ran it before the fused kernel:
    the first three-NN kernel, then the weighting, the row gather into a
    (B, N, 3, C) tensor, a broadcast multiply and a sum."""
    itp = importlib.import_module("vlp3d_torch.ops.interpolate")
    dist2, idx = itp._three_nn_cuda(unknown, known, "serial")
    return itp.three_interpolate(feats, idx, itp.interpolation_weights(dist2))


def three_nn_errs(torch, unknown, known, feats, want, plan):
    """Errors of three_nn alone and of the fused interpolation under
    ``plan`` against the plain versions' (dist2, idx, weight, out)
    ``want``: (index difference, dist2, weight, output). The first kernel
    ("serial") has no interpolation: its weight and output errors are 0."""
    itp = importlib.import_module("vlp3d_torch.ops.interpolate")
    pd, pi, pw, pout = want
    d, i = itp._three_nn_cuda(unknown, known, plan)
    errs = [index_err(torch, i, pi), close_err(torch, d, pd), 0.0, 0.0]
    if plan != "serial":
        out, i, w, d = itp._interpolate_cuda(unknown, known, feats, plan,
                                             with_dist2=True)
        errs = [max(errs[0], index_err(torch, i, pi)),
                max(errs[1], close_err(torch, d, pd)),
                close_err(torch, w, pw), close_err(torch, out, pout)]
    torch.cuda.synchronize()
    return errs


def close_err(torch, got, want) -> float:
    """Largest absolute difference of two float tensors, equal infinities
    counting as 0."""
    same = got == want
    diff = torch.where(same, torch.zeros_like(got), (got - want).abs())
    return float(diff.max().item()) if diff.numel() else 0.0


def three_nn_plain_all(unknown, known, feats):
    """The plain versions' (dist2, idx, weight, out)."""
    itp = importlib.import_module("vlp3d_torch.ops.interpolate")
    pd, pi = itp.three_nn_plain(unknown, known)
    return (pd, pi, itp.interpolation_weights(pd),
            itp.interpolate_features_plain(unknown, known, feats))


def check_three_nn_errs(site, errs):
    ierr, derr, werr, ferr = errs
    if ierr != 0 or derr > DIST_TOL or werr > WEIGHT_TOL or ferr > INTERP_TOL:
        fail(f"three_nn {site}: index difference {ierr}, dist2 err {derr} "
             f"(tolerance {DIST_TOL}), weight err {werr} ({WEIGHT_TOL}), "
             f"output err {ferr} ({INTERP_TOL})")


def check_three_nn_site(torch, site, unknown, known, feats):
    """Phase 4, three-NN and the FP module's interpolation at one
    main-path site: the wrapper's fused kernel, three_nn alone, the first
    kernel and every swept team plan against the plain versions (indices
    equal, dist2 within DIST_TOL, weights within WEIGHT_TOL, output within
    INTERP_TOL; fatal otherwise); device time of each beside the route
    the fused kernel replaced, the plain version and torch.cdist + topk
    (sweep_ms: the evidence for _three_nn_plan)."""
    from vlp3d_torch import ops

    itp = importlib.import_module("vlp3d_torch.ops.interpolate")
    b, n, _ = unknown.shape
    m, c = feats.shape[1:]
    want = three_nn_plain_all(unknown, known, feats)
    errs = three_nn_errs(torch, unknown, known, feats, want, None)
    interp = ops.interpolate_features(unknown, known, feats)
    errs[3] = max(errs[3], close_err(torch, interp, want[3]))
    check_three_nn_errs(site, errs)
    check_three_nn_errs(f"{site} (the first kernel)", three_nn_errs(
        torch, unknown, known, feats, want, "serial"))
    sweep, sweep_nn = {}, {}
    for plan in itp.TEAM_PLANS:
        check_three_nn_errs(f"{site} (plan {plan})", three_nn_errs(
            torch, unknown, known, feats, want, plan))
        key = "%dx%d" % plan
        sweep[key] = cuda_ms(torch, lambda: itp._interpolate_cuda(
            unknown, known, feats, plan), 10, warmup=1)
        sweep_nn[key] = cuda_ms(torch, lambda: itp._three_nn_cuda(
            unknown, known, plan), 10, warmup=1)
    # bytes: coordinates and known rows in, output rows, indices and
    # weights out; operations: the distance tests and 3 mul + 2 add a
    # channel of the weighted sum
    nbytes = b * (n + m) * 12 + b * m * c * 4 + b * n * c * 4 + b * n * 24
    bms, by = bound_ms(nbytes, b * n * m * OPS_PER_TEST + b * n * c * 5)
    nn_bms, nn_by = bound_ms(b * (n + m) * 12 + b * n * 24,
                             b * n * m * OPS_PER_TEST)
    # the same launch with next to no work: what a launch costs whatever
    # its size (launch, staging, the merge's shuffles, one row)
    tiny = (unknown[:1, :32].contiguous(), known[:1, :3].contiguous(),
            feats[:1, :3].contiguous())
    row = dict(
        site=site, shape=[b, n, m, c],
        plan=list(itp._three_nn_plan(b, n, m)),
        ms=cuda_ms(torch, lambda: ops.interpolate_features(
            unknown, known, feats), 50),
        three_nn_ms=cuda_ms(torch, lambda: ops.three_nn(unknown, known), 50),
        serial_kernel_ms=cuda_ms(torch, lambda: itp._three_nn_cuda(
            unknown, known, "serial"), 50),
        route_ms=cuda_ms(torch, lambda: replaced_route(unknown, known, feats),
                         20),
        plain_ms=cuda_ms(torch, lambda: itp.interpolate_features_plain(
            unknown, known, feats), 10),
        library_ms=cuda_ms(torch, lambda: torch.topk(
            torch.cdist(unknown, known), 3, dim=-1, largest=False), 10),
        bound_ms=bms, bound_by=by, three_nn_bound_ms=nn_bms,
        three_nn_bound_by=nn_by, max_abs_err=errs[1],
        weight_max_abs_err=errs[2], interp_max_abs_err=errs[3],
        best_plan=min(sweep, key=sweep.get), sweep_ms=sweep,
        three_nn_sweep_ms=sweep_nn,
        floor_ms=cuda_ms(torch, lambda: itp._interpolate_cuda(*tiny), 50))
    return row


def check_three_nn_edges(torch, sa2_xyz):
    """Phase 4, three-NN and the fused interpolation where the team
    kernel is likely to go wrong (tests/torch_three_nn_cases.py: ties
    across and inside lanes, an all-zero known row, unknown points on
    known points, m = 3, m below the lanes, ragged n and m, squared
    distances that overflow to inf, channel widths of the scalar and the
    float4 path, B = 1 / 3 / 9), each through the wrapper's plan, the first
    kernel and every swept team plan; then B = 1 / 3 / 9 at the FP2
    shape; then plans the kernel must refuse. Fatal unless the indices
    are equal and the rest within its tolerance."""
    cases = load_test_module("torch_three_nn_cases")
    itp = importlib.import_module("vlp3d_torch.ops.interpolate")
    from vlp3d_torch.ops import _kernels

    dev = sa2_xyz.device
    plans = (None, "serial", *itp.TEAM_PLANS)
    tried = 0
    for name in cases.NN_CASES:
        unknown, known, feats = (torch.from_numpy(a).to(dev)
                                 for a in cases.nn_case(name))
        want = three_nn_plain_all(unknown, known, feats)
        for plan in plans:
            tried += 1
            check_three_nn_errs(f"edge case {name} (plan {plan})",
                                three_nn_errs(torch, unknown, known, feats,
                                              want, plan))
    for b in (1, 3, 9):
        unknown = sa2_xyz[torch.arange(b, device=dev) % sa2_xyz.shape[0]]
        unknown = (unknown + torch.arange(b, device=dev)[:, None, None]
                   * 0.01).contiguous()
        known = unknown[:, ::2].contiguous()
        feats = torch.randn(b, known.shape[1], 256, device=dev)
        want = three_nn_plain_all(unknown, known, feats)
        for plan in (None, "serial", (4, 8), (32, 32)):
            tried += 1
            check_three_nn_errs(f"B={b} (plan {plan})", three_nn_errs(
                torch, unknown, known, feats, want, plan))
    # refused plans raise in the wrapper; the C entry point refuses them
    # too, without a launch and without leaving an error behind
    unknown, known = sa2_xyz[:2].contiguous(), sa2_xyz[:2, :64].contiguous()
    for plan in ((3, 32), (8, 3), (32, 64)):
        try:
            itp._three_nn_cuda(unknown, known, plan)
        except ValueError:
            continue
        fail(f"three_nn: plan {plan} should have been refused")
    d = torch.empty(2, unknown.shape[1], 3, device=dev)
    i = torch.empty(2, unknown.shape[1], 3, dtype=torch.int32, device=dev)
    for lanes, threads in ((3, 96), (64, 256), (8, 2048), (8, 48)):
        rc = _kernels.function("three_nn", "vlp3d_three_nn_team")(
            unknown.data_ptr(), known.data_ptr(), None, 2, unknown.shape[1],
            64, 0, lanes, threads, 0, d.data_ptr(), i.data_ptr(), None, None,
            _kernels.stream_ptr(unknown))
        if rc == 0:
            fail(f"three_nn: the kernel took {lanes} lanes x {threads} "
                 "threads")
    feats = torch.randn(2, 64, 8, device=dev)
    check_three_nn_errs("after refused plans", three_nn_errs(
        torch, unknown, known, feats,
        three_nn_plain_all(unknown, known, feats), None))
    print(f"[4] three_nn: {len(cases.NN_CASES)} edge cases and B = 1 / 3 / 9 "
          f"at the FP2 shape equal to plain under {tried} (case, plan) "
          "pairs, three_nn alone and fused: " + "; ".join(cases.NN_CASES)
          + "; refused plans raise")


def check_kernels(torch, config, out):
    """Phase 4: every kernel against its plain version at main-path shapes."""
    from vlp3d_torch import ops
    from vlp3d_torch.ops.ball_query import ball_query_plain
    from vlp3d_torch.ops.host_time import host_us
    from vlp3d_torch.ops.sampling import fps_plain

    smp = importlib.import_module("vlp3d_torch.ops.sampling")
    cfg = config.model
    xyz_in = [out["point_clouds_xyz"], out["sa1_xyz"], out["sa2_xyz"],
              out["sa3_xyz"], out["vote_xyz"]]
    centers = [out["sa1_xyz"], out["sa2_xyz"], out["sa3_xyz"],
               out["sa4_xyz"], out["aggregated_vote_xyz"]]
    # the vote aggregation SA: FPS num_proposal of the votes, r=0.3, k=16
    calls = list(zip(("sa1", "sa2", "sa3", "sa4", "proposal"),
                     tuple(cfg.sa_npoints) + (cfg.num_proposal,),
                     tuple(cfg.sa_radii) + (0.3,),
                     tuple(cfg.sa_nsamples) + (16,)))
    rows = {"fps": [], "ball_query": [], "three_nn": []}

    for (site, npoint, radius, nsample), xyz, ctr in zip(calls, xyz_in,
                                                         centers):
        xyz = xyz.contiguous()
        b, n, _ = xyz.shape
        got = ops.furthest_point_sample(xyz, npoint)
        want = fps_plain(xyz, npoint)
        fps_err = index_err(torch, got, want)
        if fps_err != 0:
            fail(f"fps {site}: kernel indices differ from the plain version "
                 f"by up to {fps_err}")
        k_ms = cuda_ms(torch, lambda: ops.furthest_point_sample(xyz, npoint),
                       10)
        p_ms = cuda_ms(torch, lambda: fps_plain(xyz, npoint), 2, warmup=0)
        # the kernel this one replaced (one 1024-thread block a row,
        # distances in shared memory), timed in the same run
        if index_err(torch, smp._fps_cuda(xyz, npoint, "shared"), want) != 0:
            fail(f"fps {site}: the one-block kernel differs from plain")
        old_ms = cuda_ms(torch, lambda: smp._fps_cuda(xyz, npoint, "shared"),
                         5)
        # every other shape of the points-in-registers kernel that holds
        # this row: each must give the same indices; the wrapper's choice
        # (_fps_plan) is the fastest or within a few percent of it
        plan = smp._fps_plan(n)
        sweep = {}
        for cand in fps_variants(n):
            if index_err(torch, smp._fps_cuda(xyz, npoint, cand), want) != 0:
                fail(f"fps {site}: plan {cand} differs from plain")
            sweep["%dx%d" % cand] = cuda_ms(
                torch, lambda: smp._fps_cuda(xyz, npoint, cand), 3, warmup=1)
        nbytes = b * n * 12 + b * npoint * 4
        nops = (npoint - 1) * b * n * OPS_PER_TEST
        bms, by = bound_ms(nbytes, nops)
        # npoint - 1 dependent steps on the fp32 rate of the SMs one row
        # has: one for the one-block kernels, one a block of a cluster
        serial_1 = (npoint - 1) * n * OPS_PER_TEST / (FP32_OPS / SMS) * 1e3
        rows["fps"].append(dict(
            site=site, shape=[b, n, npoint], plan=list(plan),
            threads=32 * -(-(-(-n // plan[0])) // (32 * plan[1])), ms=k_ms,
            us_per_step=k_ms * 1e3 / (npoint - 1), one_block_kernel_ms=old_ms,
            one_block_us_per_step=old_ms * 1e3 / (npoint - 1),
            plain_ms=p_ms, bound_ms=bms, bound_by=by,
            serial_one_sm_ms=serial_1, serial_ms=serial_1 / plan[0],
            max_abs_err=fps_err, sweep_ms=sweep))

        rows["ball_query"].append(check_ball_query_site(
            torch, site, xyz, ctr.contiguous(), radius, nsample))

    for site, unknown, known, feats in (
        ("fp1", out["sa3_xyz"], out["sa4_xyz"], out["sa4_features"]),
        ("fp2", out["sa2_xyz"], out["sa3_xyz"], out["sa3_features"]),
    ):
        rows["three_nn"].append(check_three_nn_site(
            torch, site, unknown.contiguous(), known.contiguous(),
            feats.contiguous()))

    stamp("4", "main-path sites")
    # edge cases: zero-padded points and an all-zero row, empty balls,
    # and the ball query where a row split into segments may go wrong
    xyz = out["point_clouds_xyz"].clone()
    n, npoint = xyz.shape[1], cfg.sa_npoints[0]
    xyz[0] = 0.0
    xyz[:, -n // 40:] = 0.0
    got = ops.furthest_point_sample(xyz, npoint)
    if not torch.equal(got, fps_plain(xyz, npoint)) or (got[0] != 0).any():
        fail("fps: zero-padded rows differ from the plain version")
    ctr = out["sa1_xyz"].clone()
    empty = ctr.shape[1] // 20
    ctr[:, :empty] = 100.0
    radius, nsample = cfg.sa_radii[0], cfg.sa_nsamples[0]
    idx, cnt = ops.ball_query_with_count(radius, nsample, xyz, ctr)
    pidx, pcnt = ball_query_plain(radius, nsample, xyz, ctr)
    if not (torch.equal(idx, pidx) and torch.equal(cnt, pcnt)
            and (idx[:, :empty] == 0).all()):
        fail("ball query: empty balls differ from the plain version")
    torch.cuda.synchronize()
    print("[4] edge cases equal to plain: zero-padded rows, an all-zero row, "
          "empty balls")
    check_fps_edges(torch, out["point_clouds_xyz"])
    stamp("4", "fps edge cases")
    check_ball_query_edges(torch, out["point_clouds_xyz"])
    stamp("4", "ball query edge cases")
    check_three_nn_edges(torch, out["sa2_xyz"])
    check_gather_bounds(torch, out)
    stamp("4", "three-NN edge cases and gather bounds")

    # host time of one wrapper call, on arguments small enough that the
    # device keeps up with the host
    tiny = out["sa4_xyz"][:1, :64].contiguous()
    ctr = tiny[:, :8].contiguous()
    feats = torch.randn(1, 8, 256, device=tiny.device)
    us = {"fps": host_us(lambda: ops.furthest_point_sample(tiny, 2)),
          "ball_query": host_us(lambda: ops.ball_query(
              0.3, 4, tiny, ctr)),
          "three_nn": host_us(lambda: ops.interpolate_features(
              tiny, ctr, feats)),
          "three_nn alone": host_us(lambda: ops.three_nn(tiny, ctr)),
          "the replaced route": host_us(lambda: replaced_route(
              tiny, ctr, feats))}
    print(f"[4] host us a call on {list(tiny.shape)} (three_nn: "
          f"interpolate_features): {json.dumps(us)}")
    for name, rs in rows.items():
        for r in rs:
            r["host_us"] = us[name]
            if name == "three_nn":
                r["route_host_us"] = us["the replaced route"]
            print(f"[4] {name} {json.dumps(r)}")
    return rows


def bound_indices(torch, b, n, r, device, seed):
    """(b, r) int32 indices into a table of n rows: random rows in range,
    and in every batch row each out-of-range kind (-1, -n, n, -n - 1,
    the int32 extremes, -2, n + 7) at every other slot of the first 16."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.randint(0, n, (b, r), generator=g, dtype=torch.int32)
    kinds = torch.tensor([-1, -n, n, -n - 1, 2 ** 31 - 1, -2 ** 31, -2,
                          n + 7], dtype=torch.int32)
    idx[:, 1:2 * len(kinds):2] = kinds
    return idx.to(device)


def check_gather_bounds(torch, out):
    """Phase 4, the row gather on out-of-range indices (JAX gather_points'
    rule within each batch row: an index in [-N, 0) reads row index + N,
    any other index outside [0, N) gives a NaN row, also after a
    subtrahend): both
    forward kernels, with and without a subtrahend, on tables of the
    main path, against the plain version; fatal unless equal, NaN for
    NaN."""
    grp = importlib.import_module("vlp3d_torch.ops.grouping")
    tables = (("cloud C=135 (stream kernel)", out["point_clouds"]),
              ("cloud xyz C=3 of 135 (stream kernel, strided)",
               out["point_clouds_xyz"]),
              ("sa2 features C=256 (vec kernel)", out["sa2_features"]))
    done = []
    for i, (label, table) in enumerate(tables):
        b, n, c = table.shape
        idx = bound_indices(torch, b, n, 512 * 16, table.device, i).view(
            b, 512, 16)
        sub = torch.randn(b, 512, c, device=table.device)
        for s in (None, sub):
            got = grp._group_points_cuda(table, idx, s)
            want = grp.group_points_plain(table, idx, s)
            torch.cuda.synchronize()
            nan = torch.isnan(want)
            if not (torch.equal(torch.isnan(got), nan) and torch.equal(
                    torch.nan_to_num(got), torch.nan_to_num(want))):
                fail(f"group_points {label}: on out-of-range indices the "
                     "kernel differs from the plain version")
            if not nan.any():
                fail(f"group_points {label}: no NaN row for an index past "
                     "the table")
        done.append(label)
    print(f"[4] row gather on out-of-range indices equal to plain (NaN rows "
          f"included), with and without a subtrahend: {done}")


def profile_call(torch, fn, tag: str, what: str, top: int = 15,
                 expect=()):
    """Trace one call of fn with torch.profiler; print the device time by
    kernel name and the device-busy share of the call's wall time; return
    {"wall_ms", "busy_ms", "events", "memsets", "expect_ms",
    "expect_split"} (the last the device ms of each of ``expect``). A trace that holds no
    device time, or lacks one of the hand kernels ``expect`` (CUDA
    function names) that fn launches, is reported as not measured and
    returns {}: its busy share would leave them out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side events only (kernels, copies): an operator's own entry,
    # or an annotated range such as Optimizer.step, repeats the time of
    # the kernels launched inside it
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and not e.key.startswith("Optimizer.")),
                    key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if busy_ms == 0:
        print(f"[{tag}] profile: the trace holds no device time (not "
              "measured)")
        return {}
    hits = {fn_: [e for e in events if f"{fn_}(" in e.key
                  or f"{fn_}<" in e.key] for fn_ in expect}
    lost = [fn_ for fn_, h in hits.items() if not h]
    if lost:
        print(f"[{tag}] profile of one {what}: not measured, the trace "
              f"lost {len(lost)} of its {len(expect)} hand kernels "
              f"({', '.join(lost)})")
        return {}
    rows = [dict(op=e.key[:90], calls=e.count, device_ms=dev_us(e) / 1e3)
            for e in events[:top] if dev_us(e) > 0]
    # a zeroed table (torch.zeros) is a fill kernel, not a memset
    memsets = sum(e.count for e in events if "memset" in e.key.lower())
    fills = sum(e.count for e in events if "fill" in e.key.lower())
    n_events = sum(e.count for e in events)
    print(f"[{tag}] profile of one {what}: wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.3f} of wall; idle "
          f"share {1 - busy_ms / wall_ms:.3f}), {n_events}"
          f" device kernels and copies, {memsets} of them memsets and "
          f"{fills} fill kernels")
    for name in ("ball_query", "three_nn", "group_points_grad"):
        found = [e for e in events if name in e.key]
        print(f"[{tag}]   {name}*: " + ", ".join(
            f"{e.key[:60]} x{e.count} {dev_us(e) / 1e3:.3f} ms"
            for e in found))
    split = {fn_: sum(dev_us(e) for e in h) / 1e3 for fn_, h in hits.items()}
    expect_ms = sum(split.values())
    if expect:
        print(f"[{tag}]   the {len(expect)} hand kernels: "
              f"{expect_ms:.3f} ms ({json.dumps(split)})")
    for r in rows:
        print(f"[{tag}]   {r['device_ms']:9.3f} ms  x{r['calls']:<5d} "
              f"{r['op']}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "events": n_events,
            "memsets": memsets, "expect_ms": expect_ms,
            "expect_split": split}


def kernel_line(rows, serving, train, predict, solver, http, per_step,
                per_remat_step, paths):
    """The {"kernels": [...]} line. ``rows`` holds the per-call-site checks
    of each kernel; ``serving`` / ``train`` / ``predict`` / ``solver`` /
    ``http`` the launch counts of the five grounding main-path runs,
    ``paths`` those of the captioning, question-answering and option ones
    (``caption_serve``, ``caption_step``, ``caption_http``,
    ``answer_eval``, ``answer_serve``, ``answer_step``, ``answer_http``,
    ``flags_forward``, ``flags_step``, ``float32_forward``,
    ``float32_step``, ``bfloat16_forward``, ``bfloat16_step``,
    ``flags_solver_reference``, ``flags_solver_detection``, ``dp_step``,
    phase 15's ``scanqa_forward`` / ``_step``, ``refnet_*``,
    ``capnet_*`` and ``capnet_locals_*``, and phase 16's ``mlcv_serve``,
    ``mlcv_step``, ``detector_*``, ``detr_*``, ``xbert_*`` and
    ``cross_mlm``);
    ``per_step`` and ``per_remat_step`` those of one Solver step and one
    remat step."""
    sources = {
        "fps": ("vlp3d_torch/csrc/fps.cu", "vlp3d/ops/sampling.py:60"),
        "ball_query": ("vlp3d_torch/csrc/ball_query.cu",
                       "vlp3d/ops/ball_query.py:33"),
        "three_nn": ("vlp3d_torch/csrc/three_nn.cu",
                     "vlp3d/ops/interpolate.py:16"),
        "group_points": ("vlp3d_torch/csrc/grouping.cu",
                         "vlp3d/ops/grouping.py:117"),
        "group_points_grad": ("vlp3d_torch/csrc/grouping.cu",
                              "vlp3d/ops/grouping.py:135"),
        "three_interpolate_grad": ("vlp3d_torch/csrc/grouping.cu",
                                   "vlp3d/ops/interpolate.py:49"),
        "fps_shard_loop": ("vlp3d_torch/csrc/point_parallel.cu",
                           "vlp3d/parallel/point_parallel.py:74"),
        "ball_query_merge": ("vlp3d_torch/csrc/point_parallel.cu",
                             "vlp3d/parallel/point_parallel.py:133"),
        "gather_owned": ("vlp3d_torch/csrc/point_parallel.cu",
                         "vlp3d/parallel/point_parallel.py:208"),
    }
    functions = {
        "fps": ["fps_regs_kernel<P, false>", "fps_regs_kernel<P, true>",
                "fps_kernel"],
        "ball_query": ["ball_query_tile_kernel<L>", "ball_query_kernel"],
        "three_nn": ["three_nn_team_kernel<L, kInterp, V>",
                     "three_nn_kernel"],
        "group_points": ["group_points_vec_kernel",
                         "group_points_stream_kernel"],
        "group_points_grad": ["group_points_grad_sorted_kernel<V>",
                              "group_points_grad_kernel"],
        "three_interpolate_grad": ["three_interpolate_grad_kernel<V, kU>"],
        "fps_shard_loop": ["fps_shard_loop_kernel<P>"],
        "ball_query_merge": ["ball_query_merge_kernel"],
        "gather_owned": ["gather_owned_kernel"],
    }
    kernels = []
    for name, rs in rows.items():
        # one forward's (for the gather's backward: one train step's)
        # calls of this kernel, summed over its call sites
        rs = [r for r in rs if r.get("on_path", True)]
        ops_bound = sum(r["bound_ms"] for r in rs if r["bound_by"] ==
                        "operations")
        bytes_bound = sum(r["bound_ms"] for r in rs if r["bound_by"] ==
                          "bytes")
        lib = [r.get("library_ms") for r in rs]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": (serving[name] + train[name] + predict[name]
                         + solver[name] + http[name]
                         + sum(c[name] for c in paths.values())),
            "launches_serving": serving[name],
            "launches_train": train[name],
            "launches_predict": predict[name],
            "launches_solver": solver[name],
            "launches_http": http[name],
            **{f"launches_{path}": c[name] for path, c in paths.items()},
            "per_step": per_step.get(name, 0),
            "per_remat_step": per_remat_step.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "operations" if ops_bound >= bytes_bound else "bytes",
            "library_ms": None if None in lib else sum(lib),
            "host_us": rs[0]["host_us"],
            "kernel_functions": functions[name],
        })
        if name == "ball_query":
            kernels[-1].update(
                warp_kernel_ms=sum(r["warp_kernel_ms"] for r in rs),
                plans={r["site"]: r["plan"] for r in rs})
        if name == "group_points_grad":
            kernels[-1].update(
                atomic_kernel_ms=sum(r["atomic_kernel_ms"] for r in rs),
                plans={r["site"]: r["plan"] for r in rs})
        if name == "three_nn":
            # ms: the fused forward (three-NN + weights + weighted sum);
            # library_ms: torch.cdist + topk, which computes three-NN only
            kernels[-1].update(
                also_replaces="vlp3d/ops/interpolate.py:62",
                three_nn_only_ms=sum(r["three_nn_ms"] for r in rs),
                three_nn_only_bound_ms=sum(r["three_nn_bound_ms"]
                                           for r in rs),
                serial_kernel_ms=sum(r["serial_kernel_ms"] for r in rs),
                route_ms=sum(r["route_ms"] for r in rs),
                route_host_us=rs[0]["route_host_us"],
                plans={r["site"]: r["plan"] for r in rs})
        if name == "three_interpolate_grad":
            kernels[-1].update(
                route_ms=sum(r["route_ms"] for r in rs),
                plans={r["site"]: r["plan"] for r in rs})
        if name in SP_KERNELS:
            kernels[-1]["sites"] = {r["site"]: {k: v for k, v in r.items()
                                                if k != "site"} for r in rs}
        if name == "fps":
            steps = sum(r["shape"][2] - 1 for r in rs)
            kernels[-1].update(
                serial_ms=sum(r["serial_ms"] for r in rs),
                serial_one_sm_ms=sum(r["serial_one_sm_ms"] for r in rs),
                us_per_step=kernels[-1]["ms"] * 1e3 / steps,
                one_block_kernel_ms=sum(r["one_block_kernel_ms"] for r in rs))
    return {"kernels": kernels}


def record_gather_sites(torch, run):
    """Run ``run()`` with the row gather wrapped so that every call leaves
    its table, its indices and (after a backward) the gradient of its
    output. Returns the list of call sites in call order."""
    grp = importlib.import_module("vlp3d_torch.ops.grouping")
    sites, orig = [], grp._gather_rows

    def recording(points, idx, sub=None):
        out = orig(points, idx, sub)
        site = {"points": points.detach(),
                "idx": idx.to(torch.int32).contiguous(),
                "sub": None if sub is None else sub.detach().contiguous(),
                "grad": None, "differentiable": out.requires_grad}
        if out.requires_grad:
            out.register_hook(
                lambda g, site=site: site.__setitem__("grad", g.detach()))
        sites.append(site)
        return out

    grp._gather_rows = recording
    try:
        run()
    finally:
        grp._gather_rows = orig
    return sites


def record_interp_sites(torch, run):
    """Run ``run()`` with the FP module's interpolation wrapped so that
    every call leaves its coordinates, its known rows and (after a
    backward) the gradient of its output. Returns the calls in order."""
    itp = importlib.import_module("vlp3d_torch.ops.interpolate")
    sites, orig = [], itp._interpolate_features_cuda

    def recording(unknown, known, feats):
        out = orig(unknown, known, feats)
        site = {"unknown": unknown.detach(), "known": known.detach(),
                "feats": feats.detach(), "grad": None}
        if out.requires_grad:
            out.register_hook(
                lambda g, site=site: site.__setitem__("grad", g.detach()))
        sites.append(site)
        return out

    itp._interpolate_features_cuda = recording
    try:
        run()
    finally:
        itp._interpolate_features_cuda = orig
    return sites


def interp_grad_ordered(torch, grad, idx, weight, m):
    """The interpolation's backward in the kernel's exact order (a loop
    over list positions, tests/torch_three_nn_cases.py)."""
    cases = load_test_module("torch_three_nn_cases")
    return cases.interp_grad_ordered(grad, idx, weight, m)


def check_interp_grad_site(torch, label, site, reps=20):
    """The interpolation's weighted backward at one FP site of a train
    step: three_interpolate_grad_kernel under the wrapper's plan and every
    plan of INTERP_GRAD_PLANS against the plain weighted backward (fatal
    above GRAD_RTOL of the absolute sum meeting in a row, or unless two
    launches are equal bit for bit) and, bit for bit, against the ordered
    sum of interp_grad_ordered; times of kernel, plain version, the route
    it replaced (broadcast multiply + the gather's sorted backward) and
    one sparse product (torch.sparse.mm of the transposed weight
    matrix)."""
    grp = importlib.import_module("vlp3d_torch.ops.grouping")
    itp = importlib.import_module("vlp3d_torch.ops.interpolate")
    unknown, known, feats = site["unknown"], site["known"], site["feats"]
    grad = site["grad"].contiguous()
    b, n, c = grad.shape
    m = feats.shape[1]
    _, idx, weight = itp._interpolate_cuda(unknown, known, feats)
    want = itp.three_interpolate_grad_plain(grad, idx, weight, m)
    scale = itp.three_interpolate_grad_plain(grad.abs(), idx, weight.abs(),
                                             m)

    def check(plan):
        got = itp._three_interpolate_grad_cuda(grad, idx, weight, m, plan)
        again = itp._three_interpolate_grad_cuda(grad, idx, weight, m, plan)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = diff.max().item()
        rel = (diff / scale.clamp_min(1e-30)).max().item()
        if not bool((diff <= grp.GRAD_RTOL * scale + 1e-30).all()):
            fail(f"three_interpolate_grad {label} (plan {plan}): kernel "
                 f"differs from the plain backward by {err} ({rel} of the "
                 f"absolute sum in the row; tolerance {grp.GRAD_RTOL})")
        if not torch.equal(got, again):
            fail(f"three_interpolate_grad {label} (plan {plan}): two "
                 "launches differ")
        return err, rel

    plan = itp._interp_grad_plan(b, m, c, 3 * n)
    err, rel = check(None)
    ordered = interp_grad_ordered(torch, grad, idx, weight, m)
    if not torch.equal(itp._three_interpolate_grad_cuda(grad, idx, weight,
                                                        m), ordered):
        fail(f"three_interpolate_grad {label}: kernel differs from the "
             "ordered sum")
    sweep = {}
    for cand in itp.INTERP_GRAD_PLANS:
        check(cand)
        sweep["%dx%d" % cand] = cuda_ms(
            torch, lambda: itp._three_interpolate_grad_cuda(
                grad, idx, weight, m, cand), reps, warmup=1)
    # the transposed (B*m, B*n) weight matrix, three entries a column
    offs = torch.arange(b, device=grad.device)[:, None, None]
    rows_ix = (idx.long() + offs * m).reshape(-1)
    cols_ix = (torch.arange(n, device=grad.device)[None, :, None]
               + offs * n).expand(b, n, 3).reshape(-1)
    wt = torch.sparse_coo_tensor(torch.stack([rows_ix, cols_ix]),
                                 weight.reshape(-1), (b * m, b * n)
                                 ).coalesce().to_sparse_csr()
    g2 = grad.reshape(b * n, c)
    lib_err = (torch.sparse.mm(wt, g2).reshape(b, m, c) - want).abs().max()
    nbytes = grad.numel() * 4 + idx.numel() * 4 + weight.numel() * 4 \
        + b * m * c * 4
    bms, by = bound_ms(nbytes, b * n * 3 * c * 2)
    bwd = dict(
        site=label, shape=[b, n, c, m], plan=list(plan), max_abs_err=err,
        max_rel_err=rel,
        ms=cuda_ms(torch, lambda: itp._three_interpolate_grad_cuda(
            grad, idx, weight, m), reps),
        plain_ms=cuda_ms(torch, lambda: itp.three_interpolate_grad_plain(
            grad, idx, weight, m), reps),
        route_ms=cuda_ms(torch, lambda: grp._group_points_grad_cuda(
            (grad[:, :, None, :] * weight[..., None]).reshape(b, 3 * n, c),
            idx.view(b, 3 * n), m), reps),
        library_ms=cuda_ms(torch, lambda: torch.sparse.mm(wt, g2), reps),
        library_max_abs_err=lib_err.item(),
        # one unknown point's three rows: the kernel's fixed cost (its
        # scan, place and sum passes with next to no work)
        floor_ms=cuda_ms(torch, lambda: itp._three_interpolate_grad_cuda(
            grad[:1, :1].contiguous(), idx[:1, :1].contiguous(),
            weight[:1, :1].contiguous(), m), reps),
        bound_ms=bms, bound_by=by, sweep_ms=sweep, equal_to_ordered=True)
    print(f"[6] three_interpolate_grad {json.dumps(bwd)}")
    return bwd


def check_group_site(torch, label, points, idx, grad, on_path, reps=20,
                     sub=None):
    """One call site of the row gather: the forward kernel against
    torch.gather (exact), with and without a subtrahend, and with ``grad``
    the backward kernel against index_add_; times of kernel, plain
    version and library call. ``sub`` is what the site itself passes; a
    (B, M, K) site without one is also checked against a random one."""
    grp = importlib.import_module("vlp3d_torch.ops.grouping")
    b, n, c = points.shape
    idx2 = idx.reshape(b, -1)
    r = idx2.shape[1]
    got = grp._group_points_cuda(points, idx)
    want = grp.group_points_plain(points, idx)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if err != 0 or got.shape != want.shape:
        fail(f"group_points {label}: kernel differs from torch.gather by {err}")
    if idx.dim() == 3:
        s = sub if sub is not None else torch.randn(
            b, idx.shape[1], c, device=points.device)
        got_s = grp._group_points_cuda(points, idx, s)
        torch.cuda.synchronize()
        sub_err = (got_s - (want - s[:, :, None, :])).abs().max().item()
        if sub_err != 0:
            fail(f"group_points {label}: with a subtrahend the kernel "
                 f"differs from gather - sub by {sub_err}")
        err = max(err, sub_err)
        del got_s, s
    del want
    offs = torch.arange(b, device=idx.device, dtype=torch.int64)[:, None] * n
    flat = (idx2.long() + offs).reshape(-1)
    table = points.contiguous().reshape(b * n, c)
    touched = torch.unique(flat).numel()
    nbytes = touched * c * 4 + idx.numel() * 4 + got.numel() * 4
    if sub is not None:
        nbytes += sub.numel() * 4
    bms, by = bound_ms(nbytes, 0 if sub is None else got.numel())
    shape = [b, n, c, r]
    del got
    fwd = dict(
        site=label, shape=shape, on_path=on_path, max_abs_err=err,
        fused_sub=sub is not None,
        ms=cuda_ms(torch, lambda: grp._group_points_cuda(points, idx, sub),
                   reps),
        plain_ms=cuda_ms(torch, lambda: grp.group_points_plain(
            points, idx, sub), reps),
        library_ms=cuda_ms(torch, lambda: torch.index_select(table, 0, flat),
                           reps),
        bound_ms=bms, bound_by=by, rows_touched=touched)
    if sub is not None:
        # the two-op form this call replaces: gather, then subtract
        fwd["two_op_ms"] = cuda_ms(torch, lambda: grp._group_points_cuda(
            points, idx) - sub[:, :, None, :], reps)
        fwd["library_two_call_ms"] = cuda_ms(
            torch, lambda: torch.index_select(table, 0, flat).view(
                *idx.shape, c) - sub[:, :, None, :], reps)
    print(f"[6] group_points {json.dumps(fwd)}")
    if grad is None:
        return fwd, None
    idx = idx2
    grad = grad.reshape(b, r, c).contiguous()
    want = grp.group_points_grad_plain(grad, idx, n)
    scale = grp.group_points_grad_plain(grad.abs(), idx, n)

    def check(plan):
        """The backward under ``plan`` against index_add_ (fatal above
        GRAD_RTOL of the absolute sum meeting in a row) and, for the
        sorted kernel, against its own second launch (fatal unless equal
        bit for bit); returns (abs err, rel err)."""
        got = grp._group_points_grad_cuda(grad, idx, n, plan)
        again = grp._group_points_grad_cuda(grad, idx, n, plan)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = diff.max().item()
        rel = (diff / scale.clamp_min(1e-30)).max().item()
        if not bool((diff <= grp.GRAD_RTOL * scale + 1e-30).all()):
            fail(f"group_points_grad {label} (plan {plan}): kernel differs "
                 f"from index_add_ by {err} ({rel} of the absolute sum in "
                 f"the row; tolerance {grp.GRAD_RTOL})")
        takes = plan if plan is not None else grp._grad_plan(b, n, c, r)
        if takes not in (None, "atomic") and not torch.equal(got, again):
            fail(f"group_points_grad {label} (plan {plan}): two launches "
                 "of the sorted kernel differ")
        return err, rel

    plan = grp._grad_plan(b, n, c, r)
    err, rel = check(None)
    check("atomic")
    sweep = {}
    cap = grp.SORTED_CAP
    cands = ([(rows, sl, warps, cap) for rows in (16, 32, 64, 128)
              for sl in ((1, 2) if c > 128 else (1,)) for warps in (8, 16, 32)]
             if on_path else [(64, 1, 32, cap), (128, 2, 8, 1000)])
    for cand in cands:
        check(cand)
        sweep["%dx%dx%d" % cand[:3]] = cuda_ms(
            torch, lambda: grp._group_points_grad_cuda(grad, idx, n, cand),
            reps, warmup=1)
    nbytes = grad.numel() * 4 + idx.numel() * 4 + b * n * c * 4
    bms, by = bound_ms(nbytes, grad.numel())
    flat_grad = grad.reshape(b * r, c)
    acc = torch.zeros((b * n, c), device=grad.device)
    bwd = dict(
        site=label, shape=shape, on_path=on_path,
        plan=list(plan) if plan else "atomic", max_abs_err=err,
        max_rel_err=rel,
        ms=cuda_ms(torch, lambda: grp._group_points_grad_cuda(grad, idx, n),
                   reps),
        # the atomic kernel and the zeroed table it needs: two launches
        atomic_kernel_ms=cuda_ms(torch, lambda: grp._group_points_grad_cuda(
            grad, idx, n, "atomic"), reps),
        plain_ms=cuda_ms(torch, lambda: grp.group_points_grad_plain(
            grad, idx, n), reps),
        library_ms=cuda_ms(torch, lambda: acc.zero_().index_add_(
            0, flat, flat_grad), reps),
        bound_ms=bms, bound_by=by,
        max_rows_in_one=int(torch.bincount(flat).max().item()),
        sweep_ms=sweep)
    print(f"[6] group_points_grad {json.dumps(bwd)}")
    return fwd, bwd


def check_grouping(torch, model, config, batch):
    """Phase 6, kernels: the row gather and its backward at every call
    site of one train step, from the step's own tensors."""
    from vlp3d_torch.losses.joint import compute_joint_loss
    from vlp3d_torch.ops.host_time import host_us

    def train_pass():
        out = model(batch, train=True)
        loss, _ = compute_joint_loss(config, out, batch)
        loss.backward()
        model.zero_grad(set_to_none=True)

    names = ["sa1 xyz", "sa1 rows (train: raw 3+C)", "sa2 xyz", "sa2 rows",
             "sa3 xyz", "sa3 rows", "sa4 xyz", "sa4 rows", "proposal xyz",
             "proposal rows", "relation multiview"]
    interp_sites = []
    sites = record_gather_sites(
        torch, lambda: interp_sites.extend(record_interp_sites(
            torch, train_pass)))
    if len(sites) != len(names):
        fail(f"a train forward made {len(sites)} row gathers, expected "
             f"{len(names)}")
    with_grad = [nm for nm, st in zip(names, sites) if st["differentiable"]]
    want_grad = ["sa2 rows", "sa3 rows", "sa4 rows", "proposal xyz",
                 "proposal rows"]
    if with_grad != want_grad:
        fail(f"row gathers with a backward: {with_grad}, expected {want_grad}")
    if len(interp_sites) != 2 or any(st["grad"] is None
                                     for st in interp_sites):
        fail(f"a train step made {len(interp_sites)} interpolations, "
             "expected 2, each with a gradient")
    rows = {"group_points": [], "group_points_grad": [],
            "three_interpolate_grad": [
                check_interp_grad_site(torch, label, st)
                for label, st in zip(("fp1", "fp2"), interp_sites)]}

    def add(label, st, on_path=True, reps=20):
        fwd, bwd = check_group_site(torch, label, st["points"], st["idx"],
                                    st["grad"], on_path, reps,
                                    sub=st.get("sub"))
        rows["group_points"].append(fwd)
        if bwd is not None:
            rows["group_points_grad"].append(bwd)

    for nm, st in zip(names, sites):
        add(nm, st)
    # host time of a call, at a K = 1 site: the wrapper against the one
    # library call that computes the same rows
    grp = importlib.import_module("vlp3d_torch.ops.grouping")
    st = sites[names.index("sa4 xyz")]
    pts, ix = st["points"], st["idx"]
    b, n, c = pts.shape
    table = pts.contiguous().reshape(b * n, c)
    flat = (ix.long() + torch.arange(b, device=ix.device)[:, None] * n
            ).reshape(-1)
    us = {"gather_points": host_us(lambda: grp.gather_points(pts, ix)),
          "index_select": host_us(lambda: torch.index_select(
              table, 0, flat))}
    st = sites[names.index("proposal xyz")]
    g, ix2, n2 = st["grad"].contiguous(), st["idx"], st["points"].shape[1]
    us["group_points_grad"] = host_us(
        lambda: grp._group_points_grad_cuda(g, ix2, n2))
    itp = importlib.import_module("vlp3d_torch.ops.interpolate")
    st = interp_sites[0]
    _, ix3, w3 = itp._interpolate_cuda(st["unknown"], st["known"], st["feats"])
    g3, m3 = st["grad"].contiguous(), st["feats"].shape[1]
    us["three_interpolate_grad"] = host_us(
        lambda: itp._three_interpolate_grad_cuda(g3, ix3, w3, m3))
    print(f"[6] host us a call at K = 1 sites {list(pts.shape)}, "
          f"{list(g.shape)}, and of the interpolation's backward at fp1 "
          f"{list(g3.shape)}: {json.dumps(us)}")
    for r in rows["group_points"]:
        r["host_us"] = us["gather_points"]
    for r in rows["group_points_grad"]:
        r["host_us"] = us["group_points_grad"]
    for r in rows["three_interpolate_grad"]:
        r["host_us"] = us["three_interpolate_grad"]
    del interp_sites, g3, ix3, w3
    sa2 = dict(sites[3])
    check_gather_grad_bounds(torch, sa2)
    sa1_idx = sites[1]["idx"]
    del sites

    # the inference form of SA1 (folded first layer: 64 channels gathered)
    eval_sites = record_gather_sites(torch, lambda: model(batch, train=False,
                                                          is_eval=True))
    add("sa1 rows (inference: folded 64)", eval_sites[1], on_path=False)
    del eval_sites

    # all-equal neighbourhoods (the empty-ball padding): K rows into one,
    # and every row of a batch row into one source row
    sa2["idx"] = sa2["idx"][:, :, :1].expand_as(sa2["idx"]).contiguous()
    add("sa2 rows, all K equal", sa2, on_path=False)
    # (gradient values in quarters, so that every order of the 32768
    # additions gives the same exact sum: float32 rounding over that many
    # same-signed rows alone would exceed GRAD_RTOL)
    sa2["idx"] = torch.full_like(sa2["idx"], 5)
    sa2["grad"] = torch.randint(-8, 9, sa2["grad"].shape,
                                device=sa2["grad"].device).float() / 4
    add("sa2 rows, all rows into row 5", sa2, on_path=False, reps=3)
    # C = 3 with K = 64 and a backward, C = 135 with a backward, and
    # C = 135 with a subtrahend (rows that are no multiple of 16 bytes)
    for label, c, with_sub in (("C=3 K=64", 3, False),
                               ("C=135 K=64", 135, False),
                               ("C=135 K=64 with sub", 135, True)):
        pts = torch.randn(batch["point_clouds"].shape[0], N, c,
                          device=sa1_idx.device)
        st = {"points": pts, "idx": sa1_idx, "grad": None}
        if with_sub:
            st["sub"] = torch.randn(sa1_idx.shape[:2] + (c,),
                                    device=sa1_idx.device)
        else:
            st["grad"] = torch.randn(sa1_idx.shape + (c,),
                                     device=sa1_idx.device)
        add(label, st, on_path=False, reps=5)
        del st, pts
    torch.cuda.synchronize()
    return rows


def check_gather_grad_bounds(torch, site):
    """Phase 6, the gather's backward on out-of-range indices: only
    indices in [0, N) pass a gradient (a negative index is dropped, not
    wrapped). The sorted kernel (with its plan, at a train step's SA2
    shape) and the atomic kernel against the plain backward, within
    GRAD_RTOL of the absolute sum meeting in a row; a gradient through
    -1 alone must leave the table zero."""
    grp = importlib.import_module("vlp3d_torch.ops.grouping")
    b, n, c = site["points"].shape
    grad = site["grad"].reshape(b, -1, c).contiguous()
    idx = bound_indices(torch, b, n, grad.shape[1], grad.device, 7)
    want = grp.group_points_grad_plain(grad, idx, n)
    scale = grp.group_points_grad_plain(grad.abs(), idx, n)
    plans = []
    for plan in (None, "atomic"):
        got = grp._group_points_grad_cuda(grad, idx, n, plan)
        only = grp._group_points_grad_cuda(
            torch.ones(b, 1, c, device=grad.device),
            torch.full((b, 1), -1, dtype=torch.int32, device=grad.device),
            n, plan)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        if not bool((diff <= grp.GRAD_RTOL * scale + 1e-30).all()):
            fail(f"group_points_grad (plan {plan}): on out-of-range indices "
                 f"the kernel differs from the plain backward by "
                 f"{diff.max().item()}")
        if only.any():
            fail(f"group_points_grad (plan {plan}): index -1 passed a "
                 "gradient")
        plans.append(plan or list(grp._grad_plan(b, n, c, grad.shape[1])))
    print(f"[6] gather backward on out-of-range indices equal to plain at "
          f"{[b, n, c, grad.shape[1]]} under plans {plans}; -1 passes no "
          "gradient")


def loss_and_grads(torch, model, config, batch, names, seed, caption=False,
                   loss_fn=None):
    """One train forward + backward with dropout (and the caption / MLM
    token masks) drawn from ``seed``; returns (loss, {name: gradient}) and
    leaves no gradient behind. ``loss_fn(outputs, batch) -> (loss,
    metrics)`` replaces the joint loss (the single-task models)."""
    from vlp3d_torch.losses.joint import compute_joint_loss
    from vlp3d_torch.models.layers import set_dropout_generator

    gen = torch.Generator(device=batch["point_clouds"].device)
    gen.manual_seed(seed)
    set_dropout_generator(model, gen)
    model.mask_generator = gen
    out = model(batch, train=True)
    if loss_fn is not None:
        loss, _ = loss_fn(out, batch)
    else:
        loss, _ = compute_joint_loss(config, out, batch, caption=caption)
    loss.backward()
    grads = {n: model.get_parameter(n).grad.detach().clone() for n in names}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def step_phases(torch, model, config, optimizer, batch, gen, reps: int = 3):
    """One train step taken apart, with a synchronise after each phase:
    host-clock ms of forward, loss, backward and optimizer update (their
    sum exceeds an unsynchronised step, which overlaps host and device)."""
    import numpy as np

    from vlp3d_torch.losses.joint import compute_joint_loss
    from vlp3d_torch.models.layers import set_dropout_generator

    set_dropout_generator(model, gen)
    phases = {"forward": [], "loss": [], "backward": [], "optimizer": []}

    def lap(name, t0):
        torch.cuda.synchronize()
        phases[name].append((time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model(batch, train=True)
        t = lap("forward", t)
        loss, _ = compute_joint_loss(config, out, batch)
        t = lap("loss", t)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        t = lap("backward", t)
        optimizer.step()
        lap("optimizer", t)
        del out, loss
    med = {k: float(np.median(v)) for k, v in phases.items()}
    print(f"[6] one step by phase, synchronised after each (median of "
          f"{reps}): {json.dumps(med)}; sum {sum(med.values()):.3f} ms")


def drive_train(torch, batch_size, num_points, smi):
    """Phase 6; returns (per-call kernel rows, train-path launch counts,
    the host batch)."""
    import numpy as np

    from vlp3d_torch import ops
    from vlp3d_torch.config import Config, ModelConfig
    from vlp3d_torch.data.synthetic import make_batch
    from vlp3d_torch.models import JointNet
    from vlp3d_torch.train import (
        batch_to_device,
        make_optimizer,
        make_train_step,
    )
    from vlp3d_torch.train.schedules import cosine_lr

    config = Config(model=ModelConfig(use_con=True, no_caption=True))
    t0 = time.perf_counter()
    model = JointNet(config)
    device = next(model.parameters()).device
    # two nudges to the seeded weights so that every loss is live from
    # the first step: votes stay near their seeds (half of which lie on
    # objects) and boxes start ~0.7 m wide, so some proposals lie within
    # 0.3 m of a GT center and overlap a referred box by more than 0.25
    with torch.no_grad():
        model.vgen.conv3.weight.mul_(0.05)
        model.vgen.conv3.bias.mul_(0.05)
        model.proposal.proposal.box_predictor.bias.fill_(-1.0)
    optimizer = make_optimizer(
        model, lr_schedule=lambda e, lr0: cosine_lr(e, lr0, 200),
        steps_per_epoch=100)
    train_step = make_train_step(model, config, optimizer)
    n_train = sum(p.numel() for g in optimizer.param_groups
                  for p in g["params"])
    print(f"[6] train model built in {time.perf_counter() - t0:.1f} s: "
          f"{n_train} trained parameters of "
          f"{sum(p.numel() for p in model.parameters())}, groups "
          f"{[(g['name'], len(g['params']), g['base_lr']) for g in optimizer.param_groups]}")
    host = make_batch(config, batch_size=batch_size, num_points=num_points,
                      seed=7, epoch=0, istrain=1)
    batch = batch_to_device(host, device)
    late = dict(batch, epoch=torch.tensor(60, device=device))

    # kernels at the step's call sites
    torch.cuda.reset_peak_memory_stats()
    rows = check_grouping(torch, model, config, batch)
    stamp("6", "gather and interpolation-backward checks")

    # the same forward + backward with the plain ops on the card
    probe = ["backbone_net.sa2.mlp_module.layer0.conv.weight",
             "backbone_net.sa1.mlp_module.layer0.conv.weight",
             "backbone_net.fp2.mlp.layer0.conv.weight",
             "vgen.conv3.weight",
             "proposal.vote_aggregation.mlp_module.layer0.conv.weight",
             "relation.features_concat.0.weight", "match.match.0.weight"]
    loss_k, grads_k = loss_and_grads(torch, model, config, batch, probe, 11)
    with plain_ops():
        t0 = time.perf_counter()
        loss_p, grads_p = loss_and_grads(torch, model, config, batch, probe,
                                         11)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    worst = 0.0
    for n in probe:
        scale = grads_p[n].abs().max().item()
        worst = max(worst, (grads_k[n] - grads_p[n]).abs().max().item()
                    / max(scale, 1e-30))
    print(f"[6] kernel forward+backward against plain ops on the card "
          f"({plain_s * 1e3:.3f} ms): loss {loss_k.item()} vs "
          f"{loss_p.item()} (relative {loss_rel}), largest gradient "
          f"difference {worst} of the tensor's largest entry over "
          f"{len(probe)} tensors")
    if loss_rel > STEP_LOSS_RTOL or worst > STEP_GRAD_TOL:
        fail("the kernel step differs from the plain-op step")
    del grads_k, grads_p
    stamp("6", "kernel against plain-op step")

    # the main path: train steps, with every count at 0 before
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    # one step at epoch 60 first: the seeded objectness head still
    # accepts about half of the proposals, so OCC and OSC see positives
    # (once it has learnt that ~99.5% are background, its argmax mask is
    # empty and both are 0); then the repeated steps at epoch 0, then
    # epoch 60 again
    schedule = [(60, late)] + [(0, batch)] * TRAIN_STEPS_EPOCH0 + [(60, late)]
    history, times = [], []
    for i, (_, b) in enumerate(schedule):
        t0 = time.perf_counter()
        history.append(train_step(b, gen))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            one = dict(ops.launches)
            print(f"[6] launches of one train step: {one}")
            if one != PER_STEP:
                fail(f"launch counts of one step {one} != {PER_STEP}")
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    steps = len(history)
    if launches != {k: v * steps for k, v in PER_STEP.items()}:
        fail(f"launch counts over {steps} steps: {launches}")
    history = [{k: v.item() for k, v in m.items()} for m in history]
    for i, ((epoch, _), m) in enumerate(zip(schedule, history)):
        print(f"[6] step {i} (epoch {epoch}): {times[i] * 1e3:.3f} ms "
              + json.dumps({k: m[k] for k in (
                  "loss", "vote_loss", "objectness_loss", "box_loss",
                  "ref_loss", "diou_loss", "lang_loss", "lang_con_loss",
                  "iou_con_loss", "pos_ratio", "max_iou_rate_0.25")}))
        for k, v in m.items():
            if not np.isfinite(v):
                fail(f"step {i}: non-finite {k}")
    if not (history[0]["lang_con_loss"] > 0 and history[0]["iou_con_loss"] > 0):
        fail("OCC/OSC gave no positive loss at epoch 60")
    # the vote and objectness losses must fall over the repeated steps.
    # The total need not: the box and reference losses come and go with
    # the proposals that land on GT boxes, and the language loss sits
    # behind a dropout of 0.5 on 64 sentences
    early = history[1:1 + TRAIN_STEPS_EPOCH0]
    for key in ("vote_loss", "objectness_loss"):
        series = [m[key] for m in early]
        if not min(series[2:]) < series[0]:
            fail(f"{key} does not fall over {len(series)} steps: {series}")
    if any(m["con_loss"] != 0.0 for m in early):
        fail("the contrast losses are not gated off before epoch 50")
    lrs = {g["name"]: g["lr"] for g in optimizer.param_groups}
    steady = float(np.median(times[1:])) * 1e3
    print(f"[6] train step at B={batch_size}, N={num_points}: first "
          f"{times[0] * 1e3:.3f} ms, median of the next {steps - 1} "
          f"{steady:.3f} ms, {batch_size / steady * 1e3:.3f} scenes/s; peak "
          f"memory {peak / 2**30:.3f} GiB; learning rates {lrs} ({smi})")
    stamp("6", "train steps")
    step_phases(torch, model, config, optimizer, batch, gen)
    profile_call(torch, lambda: train_step(batch, gen), "6", "train step",
                 top=25)
    stamp("6", "train path")
    return rows, launches, host


def _predict_path(torch, smi, model, ds, device, args, config):
    """Phase 7's main path: the loader's time alone, then the loader
    threads + predict_records with the counts at 0, predict alone on the
    loader's batches, and get_eval; returns the launch counts and the
    loader's first batch."""
    import numpy as np

    from vlp3d_torch import ops
    from vlp3d_torch.cli.ground_eval import evaluate
    from vlp3d_torch.cli.predict import predict_records
    from vlp3d_torch.data.dataset import BatchIterator

    cfg, bs = config.model, args.batch_size

    def loader():
        return BatchIterator(ds, bs, drop_last=False,
                             num_workers=args.num_workers)

    t0 = time.perf_counter()
    batches = list(loader())
    loader_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    pc = batches[0]["point_clouds"]
    if pc.shape != (bs, config.dataset.num_points,
                    3 + cfg.input_feature_dim) or pc.dtype != np.float32:
        fail(f"loader batch point_clouds {pc.shape} {pc.dtype}")

    # the main path, counts at 0: loader threads + predict_records
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    records = predict_records(model, loader(), device)
    path_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ops.launches)
    want = {k: v * len(batches) for k, v in PER_FORWARD.items()}
    print(f"[7] launches of the predict path over {len(batches)} batch(es): "
          f"{launches}")
    if launches != want:
        fail(f"predict launch counts {launches} != {want}")
    n_anns = PREDICT_SCENES * PREDICT_ANNS
    if len(records) != n_anns:
        fail(f"{len(records)} records for {n_anns} annotations")
    for r in records:
        if np.asarray(r["bbox"]).shape != (8, 3) or not np.isfinite(
                r["bbox"]).all():
            fail(f"bad record {r}")
    # predict alone on the loader's batch: wall clock to records on the
    # host, cold (first) and steady (median of 5)
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        again = predict_records(model, batches, device)
        times.append((time.perf_counter() - t0) * 1e3 / len(batches))
    meta = [{k: v for k, v in r.items() if k != "bbox"} for r in records]
    if [{k: v for k, v in r.items() if k != "bbox"} for r in again] != meta \
            or max(np.abs(np.subtract(a["bbox"], r["bbox"])).max()
                   for a, r in zip(again, records)) > BOX_TOL:
        fail("predict records differ between two runs")
    result = evaluate(model, batches, device, config.dataset.mean_size_arr())
    print(f"[7] {len(records)} records; loader {loader_ms:.3f} ms a batch "
          f"(host clock, {args.num_workers} worker threads); predict "
          f"{times[0]:.3f} ms a batch first, median {np.median(times[1:]):.3f}"
          f" ms of {len(times) - 1}; loader + predict path {path_ms:.3f} ms; "
          f"Acc@0.25 {result['overall_acc@0.25']} Acc@0.5 "
          f"{result['overall_acc@0.5']} lang_acc {result['lang_acc']} "
          f"(random weights; {smi})")

    stamp("7", "predict path")
    return launches, batches[0]


def drive_predict(torch, smi, after_timing=lambda: None):
    """Phase 7: the ScanRefer predict / evaluate path at run.sh's widths;
    returns its launch counts."""
    import numpy as np

    import argparse

    import tempfile

    from vlp3d_torch import native
    from vlp3d_torch.cli import ground_eval
    from vlp3d_torch.cli.common import add_common_args, config_from_args
    from vlp3d_torch.cli.predict import predict_batch
    from vlp3d_torch.data.standins import write_standin_assets
    from vlp3d_torch.data.synthetic import make_synthetic_dataset
    from vlp3d_torch.geometry.boxes import get_3d_box_batch
    from vlp3d_torch.models import JointNet
    from vlp3d_torch.train.checkpoint import save_params

    # the native loader must build: no quiet numpy path on the card
    t0 = time.perf_counter()
    lib = native.build()
    if not native.native_available():
        fail("the native loader library did not load")
    print(f"[7] native loader {lib.name} ready in "
          f"{time.perf_counter() - t0:.1f} s")
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    argv = list(RUN_SH_FLAGS)
    args = parser.parse_args(argv)
    config = config_from_args(args)
    cfg = config.model
    widths = (cfg.input_feature_dim, tuple(cfg.sa_npoints), cfg.num_proposal,
              cfg.fusion_layer, config.dataset.num_points, cfg.lang_num_max)
    if widths != PREDICT_WIDTHS:
        fail(f"predict config is not run.sh's: {widths}")
    t0 = time.perf_counter()
    model = JointNet(config)
    model.requires_grad_(False)
    device = next(model.parameters()).device
    print(f"[7] use_con model built in {time.perf_counter() - t0:.1f} s "
          f"({argv})")

    # the predict CLI over stand-in assets, with this model's weights saved
    # by save_params, runs in a process of its own from here to the end of
    # the phase; its start-up (imports, CUDA context, model) overlaps the
    # synthetic data and the timed loader and predict runs below
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_standin_assets(tmp)
        run_dir = os.path.join(tmp, "run")
        save_params(run_dir, "model", model.state_dict())
        assets = ["--scanrefer_dir", paths["scanrefer_dir"],
                  "--scannet_data", paths["scannet_data"], "--bert_vocab",
                  os.path.join(paths["bert_dir"], "vocab.txt"),
                  "--model_dir", run_dir]
        pred_path = os.path.join(tmp, "pred.json")
        t_cli = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "vlp3d_torch.cli.predict", *argv, *assets,
             "--out", pred_path], cwd=REPO, env=child_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            t0 = time.perf_counter()
            ds = make_synthetic_dataset(config, n_scenes=PREDICT_SCENES,
                                        n_points=PREDICT_POINTS,
                                        anns_per_scene=PREDICT_ANNS,
                                        split="val")
            print(f"[7] {PREDICT_SCENES} synthetic scenes of "
                  f"{PREDICT_POINTS} points built in "
                  f"{time.perf_counter() - t0:.1f} s")
            launches, batch = _predict_path(torch, smi, model, ds, device,
                                            args, config)
            after_timing()
            # the same batch with the plain ops on the card, then
            # ground_eval in this process (neither is timed)
            got = predict_batch(model, batch, device)
            with plain_ops():
                ref = predict_batch(model, batch, device)
            del model
            boxes = [get_3d_box_batch(r["pred_size"], r["pred_heading"],
                                      r["pred_center"]) for r in (got, ref)]
            box_err = float(np.abs(boxes[0] - boxes[1]).max())
            if not np.array_equal(got["chosen"], ref["chosen"]):
                fail("predict: chosen proposals differ from the plain-op "
                     "forward")
            if box_err > BOX_TOL:
                fail(f"predict: boxes differ from the plain-op forward by "
                     f"{box_err}")
            print(f"[7] plain-op predict on the card: chosen proposals "
                  f"equal, boxes max abs err {box_err} (tolerance {BOX_TOL})")
            # ground_eval drops a partial batch: batch 1 for 3 annotations
            res = ground_eval.main(argv + assets + ["--batch_size", "1"])
            cli_out, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        cli_s = time.perf_counter() - t_cli
        if proc.returncode != 0:
            fail(f"python -m vlp3d_torch.cli.predict exited "
                 f"{proc.returncode}:\n{cli_out[-3000:]}")
        with open(pred_path) as f:
            preds = json.load(f)
        with open(os.path.join(paths["scanrefer_dir"],
                               "ScanRefer_filtered_val.json")) as f:
            anns = json.load(f)
    keys = sorted((r["scene_id"], r["object_id"], r["ann_id"]) for r in preds)
    if keys != sorted((a["scene_id"], int(a["object_id"]), int(a["ann_id"]))
                      for a in anns):
        fail(f"pred.json over the stand-ins: {keys} for {len(anns)} "
             "annotations")
    if res["overall_count"] != len(anns):
        fail(f"ground_eval counted {res['overall_count']} of {len(anns)}")
    print(f"[7] CLIs over stand-in assets ({cli_s:.1f} s from the predict "
          f"CLI's start): pred.json parses with {len(preds)} records, one an "
          f"annotation ({cli_out.strip().splitlines()[-1]}); ground_eval "
          f"Acc@0.25 {res['overall_acc@0.25']} Acc@0.5 "
          f"{res['overall_acc@0.5']} over {res['overall_count']}")
    stamp("7", "CLIs")
    return launches


def _cli(module, argv, result):
    """`python -m <module> <argv>`; returns (exit code, output, seconds).
    The process joins result["procs"] while it runs, for the main thread
    to kill."""
    t0 = time.perf_counter()
    # a session of its own: stop_train_cli kills the process group, which
    # holds torchrun's worker as well
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *argv], cwd=REPO, env=child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    result.setdefault("procs", []).append(proc)
    out, _ = proc.communicate(timeout=600)
    return proc.returncode, out, time.perf_counter() - t0


def _train_cli(argv, workdir, result):
    """`python -m vlp3d_torch.cli.train_3dvlp` with run.sh's flags plus
    ``argv``; returns (exit code, output, seconds)."""
    wall0 = time.time()
    run = _cli("vlp3d_torch.cli.train_3dvlp",
               [*RUN_SH_TRAIN_FLAGS, "--synthetic", "--workdir", workdir,
                *argv], result)
    result.setdefault("started", []).append(wall0)
    result.setdefault("ended", []).append(time.time())
    return run


def _train_caption_cli(pretrain, workdir, result):
    """Phase 10's `python -m vlp3d_torch.cli.train_caption` with run.sh's
    flags (it drops --no_caption) + --synthetic --epoch 1, warm-started
    from phase 8's model.pth."""
    try:
        result["caption_train"] = _cli(
            "vlp3d_torch.cli.train_caption",
            [*RUN_SH_TRAIN_FLAGS, "--synthetic", "--epoch", "1",
             "--workdir", workdir, "--pretrain", pretrain], result)
    except Exception as e:  # noqa: BLE001 — reported by the main thread
        result["error"] = repr(e)


def _train_qa_cli(pretrain, workdir, result):
    """Phase 11's `python -m vlp3d_torch.cli.train_qa` at run.sh's widths
    (VQA_CLI_FLAGS) + --synthetic --epoch 1, warm-started from phase 8's
    model.pth."""
    try:
        result["qa_train"] = _cli(
            "vlp3d_torch.cli.train_qa",
            [*VQA_CLI_FLAGS, "--synthetic", "--epoch", "1", "--workdir",
             workdir, "--pretrain", pretrain], result)
    except Exception as e:  # noqa: BLE001 — reported by the main thread
        result["error"] = repr(e)


def _no_reference_cli(workdir, result):
    """Phase 12's `python -m vlp3d_torch.cli.train_3dvlp` with run.sh's
    flags + --synthetic --no_reference --epoch 1: the detection-only
    stage."""
    try:
        result["no_reference"] = _cli(
            "vlp3d_torch.cli.train_3dvlp",
            [*RUN_SH_TRAIN_FLAGS, "--synthetic", "--no_reference", "--epoch",
             "1", "--workdir", workdir], result)
    except Exception as e:  # noqa: BLE001 — reported by the main thread
        result["error"] = repr(e)


def _torchrun_cli(workdir, result):
    """Phase 13's `python -m torch.distributed.run --nproc_per_node 1 -m
    vlp3d_torch.cli.train_3dvlp --synthetic --smoke --epoch 1`: the
    training CLI's data-parallel path, one rank over NCCL."""
    try:
        result["torchrun"] = _cli(
            "torch.distributed.run",
            ["--nproc_per_node", "1", "--master_addr", "127.0.0.1",
             "--master_port", str(free_port()), "-m",
             "vlp3d_torch.cli.train_3dvlp", "--synthetic", "--smoke",
             "--epoch", "1", "--workdir", workdir], result)
    except Exception as e:  # noqa: BLE001 — reported by the main thread
        result["error"] = repr(e)


def check_torchrun_cli(result, workdir):
    """Phase 13's torchrun process: exit 0 after joining a group of one
    over NCCL, a log with finite losses."""
    import numpy as np

    if "torchrun" not in result:
        fail("the torchrun training CLI did not run")
    rc, out, sec = result["torchrun"]
    if rc != 0 or "distributed init (rank 0/1)" not in out \
            or "over nccl" not in out:
        fail(f"torchrun train_3dvlp exited {rc}:\n{out[-4000:]}")
    with open(os.path.join(workdir, "log.jsonl")) as f:
        records = [json.loads(r) for r in f]
    train = [r for r in records if r["phase"] == "train"]
    if not train or not all(np.isfinite(r["loss"]) for r in train):
        fail(f"torchrun train_3dvlp logged {train}")
    print(f"[13] python -m torch.distributed.run --nproc_per_node 1 -m "
          f"vlp3d_torch.cli.train_3dvlp --synthetic --smoke --epoch 1: exit "
          f"0 in {sec:.1f} s over NCCL, loss "
          f"{[round(r['loss'], 4) for r in train]}")


def train_cli_runs(workdir, result):
    """Phase 8's subprocesses, one after the other (run in a thread
    beside the in-process work): 2 epochs, then --epoch 3 --auto_resume,
    and beside that run phase 10's train_caption and phase 11's train_qa
    from the first run's model.pth; phase 12's --no_reference run and
    phase 13's torchrun run beside the first; leaves {"runs": [(rc,
    output, s), ...], "caption_train": (rc, output, s), "qa_train": (rc,
    output, s), "no_reference": (rc, output, s), "torchrun": (rc, output,
    s)} or {"error": ...} in ``result``."""
    import shutil
    import threading

    detection_only = threading.Thread(target=_no_reference_cli, args=(
        os.path.join(os.path.dirname(workdir), "no_reference"), result),
        daemon=True)
    detection_only.start()
    torchrun = threading.Thread(target=_torchrun_cli, args=(
        os.path.join(os.path.dirname(workdir), "torchrun"), result),
        daemon=True)
    torchrun.start()
    try:
        result["runs"] = [_train_cli(["--epoch", "2"], workdir, result)]
        if result["runs"][0][0] == 0 and not result.get("stop"):
            with open(os.path.join(workdir, "log.jsonl")) as f:
                result["lines_before_resume"] = len(f.readlines())
            result["info_mtime"] = os.path.getmtime(
                os.path.join(workdir, "info.json"))
            root = os.path.dirname(workdir)
            pretrain = os.path.join(root, "pretrain.pth")
            shutil.copyfile(os.path.join(workdir, "model.pth"), pretrain)
            stages = [threading.Thread(target=fn, args=(
                pretrain, os.path.join(root, name), result), daemon=True)
                for fn, name in ((_train_caption_cli, "caption"),
                                 (_train_qa_cli, "qa"))]
            for t in stages:
                t.start()
            result["runs"].append(_train_cli(
                ["--epoch", "3", "--auto_resume"], workdir, result))
            for t in stages:
                t.join()
    except Exception as e:  # noqa: BLE001 — reported by the main thread
        result["error"] = repr(e)
    detection_only.join()
    torchrun.join()


def stop_train_cli(cli, result):
    """End phase 8's subprocess thread: kill every process still
    running."""
    import signal

    result["stop"] = True
    for _ in range(3):  # a run may start while another ends
        for proc in result.get("procs", []):
            if proc.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
        cli.join(timeout=30)


def check_no_reference_cli(result, workdir):
    """Phase 12's --no_reference process: exit 0, every logged loss
    finite, no reference term."""
    import numpy as np

    if "no_reference" not in result:
        fail("the --no_reference training CLI did not run")
    rc, out, sec = result["no_reference"]
    if rc != 0:
        fail(f"train_3dvlp --no_reference exited {rc}:\n{out[-4000:]}")
    with open(os.path.join(workdir, "log.jsonl")) as f:
        records = [json.loads(r) for r in f]
    logged = [r for r in records if r["phase"] in ("train", "val")]
    if not logged or any("ref_loss" in r or not np.isfinite(r["loss"])
                         for r in logged):
        fail(f"train_3dvlp --no_reference logged {logged}")
    print(f"[12] train_3dvlp --synthetic --no_reference --epoch 1: exit 0 "
          f"in {sec:.1f} s, loss "
          f"{[(r['phase'], round(r['loss'], 4)) for r in logged]}")


def check_train_cli(result, workdir):
    """Phase 8's CLI checks, after train_cli_runs has ended."""
    import glob

    import numpy as np

    if "error" in result:
        fail(f"training CLI: {result['error']}")
    for i, (rc, out, sec) in enumerate(result["runs"]):
        print(f"[8] training CLI run {i + 1}: exit {rc} in {sec:.1f} s; "
              f"last line {out.strip().splitlines()[-1][:200]!r}")
        if rc != 0:
            fail(f"training CLI run {i + 1} exited {rc}:\n{out[-4000:]}")
    if len(result["runs"]) != 2:
        fail("the --auto_resume run did not start")
    for name in ("model_last.pth", "model.pth", "log.jsonl", "info.json",
                 "checkpoint_meta.json"):
        if not os.path.exists(os.path.join(workdir, name)):
            fail(f"training CLI left no {name}")
    events = glob.glob(os.path.join(workdir, "tensorboard", "*",
                                    "events.out.tfevents.*"))
    if len(events) < 2:
        fail(f"training CLI left TensorBoard event files {events}")
    with open(os.path.join(workdir, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    first = records[:result["lines_before_resume"]]
    again = records[result["lines_before_resume"]:]
    trained = sorted({r["epoch"] for r in again if r["phase"] == "train"})
    if "continuing at epoch 2" not in result["runs"][1][1] or trained != [2]:
        fail(f"--auto_resume trained epochs {trained}:\n"
             f"{result['runs'][1][1][-2000:]}")
    train = [r for r in first if r["phase"] == "train"]
    for r in train:
        if not np.isfinite(r["loss"]):
            fail(f"training CLI logged a loss of {r['loss']}")
    mem = [r for r in first if r["phase"] == "memory"]
    # where each process's time goes, from its log's timestamps: start to
    # info.json (imports, config, datasets), to each logged record, to
    # its exit
    for i, (recs, t0, t1) in enumerate(zip(
            (first, again), result["started"], result["ended"])):
        marks = [f"{r['phase']}{r.get('epoch', '')} "
                 f"{r['time'] - t0:.1f}" for r in recs]
        print(f"[8] training CLI run {i + 1}, s from its start: "
              + (f"info.json {result['info_mtime'] - t0:.1f}, " if i == 0
                 else "")
              + ", ".join(marks) + f", exit {t1 - t0:.1f}")
    print(f"[8] training CLI: {len(train)} logged steps, loss "
          f"{[round(r['loss'], 4) for r in train]}, iter ms "
          f"{[round(r.get('mean_iter_time', float('nan')) * 1e3, 3) for r in train]}"
          f" (mean over the run's earlier steps, each synchronised), fetch "
          f"ms {[round(r['mean_fetch_time'] * 1e3, 3) for r in train]}, peak "
          f"{[r['hbm_peak_mb'] for r in mem]} MB; the resumed run trained "
          f"epoch {trained} and logged {len(again)} records; "
          f"{len(events)} event files")


def remat_models(torch, config, state):
    """Phase 8's remat step, built while the training CLI runs: the model
    loaded from ``state`` without remat and with it."""
    import dataclasses

    from vlp3d_torch.models import JointNet

    models = {}
    for remat in (False, True):
        cfg = dataclasses.replace(
            config, model=dataclasses.replace(config.model, remat=remat))
        models[remat] = (cfg, JointNet(cfg))
        models[remat][1].load_state_dict(state, strict=True)
    return models


def remat_step(torch, cfg, model, batch):
    """Forward + backward of one train step; returns (loss, gradients,
    BatchNorm buffers, launches, peak bytes above what was resident
    before the step, ms)."""
    from vlp3d_torch import ops
    from vlp3d_torch.losses.joint import compute_joint_loss
    from vlp3d_torch.models.layers import set_dropout_generator

    gen = torch.Generator(device=batch["point_clouds"].device)
    gen.manual_seed(5)
    set_dropout_generator(model, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = model(batch, train=True)
    loss, _ = compute_joint_loss(cfg, out, batch)
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() - resident
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    stats = {n: b for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var",
                            "num_batches_tracked"))}
    return loss.detach(), grads, stats, launches, peak, ms


def check_remat(torch, smi, models, batch):
    """Phase 8, once the training CLI has ended: one remat step against
    the same step without it, checked; then each step again, warm, for
    its time and peak memory; returns those numbers and the launches."""
    runs = {remat: remat_step(torch, cfg, model, batch)
            for remat, (cfg, model) in models.items()}
    (loss_p, grads_p, stats_p, n_p, _, _), \
        (loss_r, grads_r, stats_r, n_r, _, _) = runs[False], runs[True]
    loss_rel = abs(loss_r.item() - loss_p.item()) / abs(loss_p.item())
    worst = max((grads_r[n] - g).abs().max().item()
                / max(g.abs().max().item(), 1e-30)
                for n, g in grads_p.items())
    stats_equal = set(stats_r) == set(stats_p) and all(
        torch.equal(stats_r[n], b) for n, b in stats_p.items())
    for _, model in models.values():
        model.zero_grad(set_to_none=True)
    (peak_p, ms_p), (peak_r, ms_r) = (
        remat_step(torch, cfg, model, batch)[4:]
        for cfg, model in (models[False], models[True]))
    print(f"[8] remat step against the plain step: loss {loss_r.item()} vs "
          f"{loss_p.item()} (relative {loss_rel}), largest gradient "
          f"difference {worst} of the tensor's largest entry over "
          f"{len(grads_p)} tensors, BatchNorm statistics equal "
          f"{stats_equal}; launches {n_r} (plain {n_p}); peak memory "
          f"above the resident models and batch {peak_r / 2**30:.3f} GiB "
          f"vs {peak_p / 2**30:.3f} GiB; forward + backward, each model's "
          f"second step, {ms_r:.3f} ms vs {ms_p:.3f} ms ({smi})")
    if set(grads_r) != set(grads_p) or loss_rel > STEP_LOSS_RTOL \
            or worst > STEP_GRAD_TOL:
        fail("the remat step differs from the plain step")
    if not stats_equal:
        fail("remat moved the BatchNorm statistics differently")
    if n_p != PER_STEP or n_r != REMAT_STEP:
        fail(f"launches of a step: plain {n_p}, remat {n_r} "
             f"(want {PER_STEP}, {REMAT_STEP})")
    stamp("8", "remat step")
    return {"remat_peak_gib": peak_r / 2**30, "plain_peak_gib": peak_p / 2**30,
            "remat_ms": ms_r, "plain_ms": ms_p}, n_r


class TrainCli:
    """Phase 8's training-CLI processes, run one after the other by a
    thread from start() until stop(), in a temporary directory."""

    def __init__(self):
        import tempfile

        self.tmp = tempfile.TemporaryDirectory()
        self.workdir = os.path.join(self.tmp.name, "cli")
        self.result = {}
        self.thread = None

    def start(self):
        import threading

        self.thread = threading.Thread(
            target=train_cli_runs, args=(self.workdir, self.result),
            daemon=True)
        self.thread.start()
        stamp("8", "training CLI started")

    def stop(self):
        if self.thread is not None:
            stop_train_cli(self.thread, self.result)
        self.tmp.cleanup()


def drive_solver(torch, smi, tmp):
    """Phase 8 in this process, beside the training CLI's processes: the
    Solver's two epochs at run.sh's widths; returns (launch counts, the
    counts of one step, (config, weights, batch) for the remat step)."""
    import argparse

    import numpy as np

    from vlp3d_torch import ops
    from vlp3d_torch.cli.common import add_common_args, config_from_args
    from vlp3d_torch.data.dataset import BatchIterator
    from vlp3d_torch.data.synthetic import make_synthetic_dataset
    from vlp3d_torch.train.solver import Solver
    from vlp3d_torch.train.state import batch_to_device

    parser = argparse.ArgumentParser()
    add_common_args(parser)
    args = parser.parse_args(RUN_SH_TRAIN_FLAGS)
    config = config_from_args(args)
    cfg = config.model
    widths = (cfg.input_feature_dim, tuple(cfg.sa_npoints), cfg.num_proposal,
              cfg.fusion_layer, config.dataset.num_points, cfg.lang_num_max)
    if widths != PREDICT_WIDTHS or not (cfg.use_con and config.loss.use_diou_loss
                                        and config.train.lr_schedule == "cosine"):
        fail(f"solver config is not run.sh's: {widths} {config}")
    t0 = time.perf_counter()
    train_ds = make_synthetic_dataset(
        config, n_scenes=SOLVER_TRAIN_SCENES, n_points=PREDICT_POINTS,
        anns_per_scene=cfg.lang_num_max, augment=True, shuffle=True, seed=3)
    val_ds = make_synthetic_dataset(
        config, n_scenes=SOLVER_VAL_SCENES, n_points=PREDICT_POINTS,
        anns_per_scene=cfg.lang_num_max, split="val", seed=4)
    solver = Solver(config, train_ds, val_ds,
                    os.path.join(tmp, "solver"), use_bn_schedule=True,
                    log_every=1, seed=args.seed)
    solver.init_state()
    model = solver.model
    with torch.no_grad():  # phase 6's nudges: every loss live
        model.vgen.conv3.weight.mul_(0.05)
        model.vgen.conv3.bias.mul_(0.05)
        model.proposal.proposal.box_predictor.bias.fill_(-1.0)
    print(f"[8] solver built in {time.perf_counter() - t0:.1f} s: "
          f"{len(train_ds)} train items ({solver.steps_per_epoch} steps an "
          f"epoch), {len(val_ds)} val items at batch "
          f"{config.train.batch_size}")

    per_step, step_ms, eval_s = [], [], []
    train_step, eval_epoch = solver.train_step, solver.eval_epoch

    def counted_step(batch, gen):
        before = dict(ops.launches)
        t = time.perf_counter()
        metrics = train_step(batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append({k: v - before[k] for k, v in ops.launches.items()})
        return metrics

    def timed_eval(epoch):
        t = time.perf_counter()
        res = eval_epoch(epoch)
        eval_s.append(time.perf_counter() - t)
        return res

    solver.train_step, solver.eval_epoch = counted_step, timed_eval
    epochs = 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    best = solver(epochs)
    run_s = time.perf_counter() - t0
    solver.close()
    launches = dict(ops.launches)
    bs = config.train.batch_size
    steps, evals = len(per_step), epochs * -(-len(val_ds) // bs)
    print(f"[8] solver: {epochs} epochs in {run_s:.1f} s, launches {launches}"
          f" over {steps} steps and {evals} eval batches")
    for i, n in enumerate(per_step):
        if n != PER_STEP:
            fail(f"solver step {i}: launches {n} != {PER_STEP}")
    if steps != epochs * solver.steps_per_epoch or launches != {
            k: steps * PER_STEP[k] + evals * PER_FORWARD[k] for k in PER_STEP}:
        fail(f"solver launch counts {launches} over {steps} steps")
    with open(os.path.join(solver.workdir, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["phase"] == "train"]
    val = [r for r in records if r["phase"] == "val"]
    mem = [r for r in records if r["phase"] == "memory"]
    for r in train:
        for k, v in r.items():
            if isinstance(v, float) and not np.isfinite(v):
                fail(f"solver logged {k} = {v}")
    if len(val) != epochs or not all("iou_rate_0.25" in r and "iou_rate_0.5"
                                     in r for r in val):
        fail(f"solver val records {val}")
    for name in ("model_last.pth", "model.pth", "ground_model.pth",
                 "checkpoint_meta.json", "log.txt"):
        if not os.path.exists(os.path.join(solver.workdir, name)):
            fail(f"solver left no {name}")
    print(f"[8] solver steps: ms {[round(x, 3) for x in step_ms]} (host "
          f"clock to a synchronise; measured on a card and host shared with "
          f"the training CLI's process), fetch ms (mean so far) "
          f"{[round(r['mean_fetch_time'] * 1e3, 3) for r in train]}, loss "
          f"{[round(r['loss'], 4) for r in train]}; eval "
          f"{[round(s * 1e3 / (evals // epochs), 3) for s in eval_s]} ms a "
          f"batch; hbm_peak_mb {[r['hbm_peak_mb'] for r in mem]}; val "
          f"iou_rate_0.25 {[r['iou_rate_0.25'] for r in val]}; best epoch "
          f"{best['epoch']} ({smi})")
    stamp("8", "solver")

    # the remat step's inputs: the trained weights and a train batch
    host = next(iter(BatchIterator(train_ds, bs)))
    batch = batch_to_device({k: v for k, v in host.items()
                             if not isinstance(v, list)}, solver.device)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, solver
    torch.cuda.empty_cache()
    return launches, per_step[0], (config, state, batch)


def _post(port, route, body: bytes, timeout=300):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}", data=body,
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class HttpPhase:
    """Phase 9's server over phase 5's model, its requests and each
    one's answer from the predictor alone, made while the training CLI
    runs; drive_http times the requests once the CLI has ended."""

    def __init__(self, torch, config):
        import base64
        import threading

        import numpy as np

        from vlp3d_torch.serve import InferenceService, make_server
        from vlp3d_torch.serving import STREAM_KEYS

        self.config = config
        self.service = InferenceService(config, batch_size=B,
                                        max_wait_ms=HTTP_MAX_WAIT_MS)
        self.server = make_server(self.service)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.service.warmup()
        rng = np.random.default_rng(9)
        words = ["chair", "table", "the", "brown", "by", "window", "bed",
                 "left", "of", "door"]
        self.reqs = []
        for i in range(HTTP_REQUESTS + 1):
            xyz_only = i == HTTP_REQUESTS
            c = 3 if xyz_only else 3 + config.model.input_feature_dim
            pc = rng.uniform(0, 4, (N, c)).astype(np.float32)
            queries = [" ".join(rng.choice(words, 4)) for _ in
                       range(1 if xyz_only else 1 + i % config.model.lang_num_max)]
            cloud = {"b64": base64.b64encode(pc.astype("<f4").tobytes()).decode(),
                     "shape": list(pc.shape)}
            self.reqs.append({"point_cloud": cloud, "queries": queries})
        self.bodies = [json.dumps(r).encode() for r in self.reqs]
        # each request's answer from the predictor on that cloud alone
        self.refs = []
        for req in self.reqs:
            item, n = self.service._make_item(req)
            self.refs.append((n, self.service._pred.run_padded(
                {k: np.asarray(item[k])[None] for k in STREAM_KEYS})))
        stamp("9", "HTTP server started, warmed up and its references "
              "taken")

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.service.close()
        self.thread.join(timeout=30)


def drive_http(torch, smi, phase):
    """Phase 9's timed requests and checks; returns the launch counts of
    its device batches and its latency numbers."""
    import threading
    import urllib.request

    import numpy as np

    from vlp3d_torch import ops

    config, service, reqs, bodies = (phase.config, phase.service,
                                     phase.reqs, phase.bodies)
    port = phase.server.server_address[1]
    try:
        answers = [None] * len(reqs)
        wall = [0.0] * len(reqs)

        def call(i):
            t = time.perf_counter()
            answers[i] = _post(port, "/v1/ground", bodies[i])
            wall[i] = (time.perf_counter() - t) * 1e3

        # where a request's time goes, on the server's threads: the
        # handler (cloud decode, resampling and tokenising, then the
        # batcher's wait and device batch) and, within it, the item
        split = {"item": [], "handle": []}
        make_item, handle = service._make_item, service.handle

        def timed(fn, key):
            def run(req):
                t = time.perf_counter()
                try:
                    return fn(req)
                finally:
                    split[key].append((time.perf_counter() - t) * 1e3)
            return run

        service._make_item = timed(make_item, "item")
        service.handle = timed(handle, "handle")
        torch.cuda.synchronize()
        before = dict(service.stats())
        ops.reset_launches()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(reqs))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        total_s = time.perf_counter() - t0
        launches = dict(ops.launches)
        service._make_item, service.handle = make_item, handle
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=60) as r:
            stats = json.loads(r.read())
        batches = stats["device_batches"] - before["device_batches"]
        sent = stats["requests"] - before["requests"]
        occupancy = sent / max(batches, 1)
        codes = [a[0] if a else None for a in answers]
        print(f"[9] {len(reqs)} concurrent /v1/ground requests ("
              f"{HTTP_REQUESTS} b64 clouds of {N} x "
              f"{3 + config.model.input_feature_dim}, 1-"
              f"{config.model.lang_num_max} queries, and one xyz-only) in "
              f"{total_s * 1e3:.3f} ms: codes {codes}, {batches} device "
              f"batches, occupancy {occupancy:.3f}, launches {launches}")
        if codes != [200] * len(reqs) or sent != len(reqs):
            fail(f"HTTP requests failed: {codes}, {sent} counted")
        if occupancy <= 1.0:
            fail(f"the server did not coalesce: occupancy {occupancy}")
        if launches != {k: batches * v for k, v in PER_FORWARD.items()}:
            fail(f"HTTP launch counts {launches} over {batches} batches")

        # each answer against the predictor on that cloud alone
        worst = 0.0
        for (n, ref), (_, ans) in zip(phase.refs, answers):
            if len(ans["boxes"]) != n:
                fail(f"{len(ans['boxes'])} boxes for {n} queries")
            for q, box in enumerate(ans["boxes"]):
                p = int(ref["pred_ref"][0, q])
                if box["proposal"] != p:
                    fail(f"HTTP chose proposal {box['proposal']}, the "
                         f"predictor {p}")
                for key in ("center", "size"):
                    worst = max(worst, float(np.abs(
                        np.asarray(box[key]) - ref[f"pred_{key}"][0, p]).max()))
                worst = max(worst, abs(box["heading"]
                                       - float(ref["pred_heading"][0, p])))
        if worst > BOX_TOL:
            fail(f"HTTP boxes differ from the predictor's by {worst}")
        code, err = _post(port, "/v1/ground", b"not json")
        code2, _ = _post(port, "/v1/ground", json.dumps(
            {"point_cloud": [[0.0, 1.0]], "queries": ["x"]}).encode())
        if code != 400 or code2 != 400:
            fail(f"a malformed body got {code}, a bad cloud {code2}")
        # the timed window's own entries of the batcher's windows (/stats
        # also holds the warm-up batch, taken while the CLI ran)
        lat = [x * 1e3 for x in list(service._batcher._latencies)[-sent:]]
        bms = [x * 1e3 for x in
               list(service._batcher._batch_times)[-batches:]]
        lat = {"p50": float(np.percentile(lat, 50)),
               "p99": float(np.percentile(lat, 99))}
        print(f"[9] answers name the predictor's proposals, box values "
              f"within {worst} (tolerance {BOX_TOL}); malformed body 400 "
              f"({err['error'][:40]}...); request p50 {lat['p50']:.3f} ms "
              f"p99 {lat['p99']:.3f} ms (submit to result), device batches "
              f"{[round(x, 3) for x in bms]} ms; /stats mean occupancy "
              f"{stats['mean_occupancy']:.3f} (with the warm-up batch), "
              f"hbm_peak_mb {stats.get('hbm_peak_mb')}; client wall p50 "
              f"{np.percentile(wall, 50):.3f} ms p99 "
              f"{np.percentile(wall, 99):.3f} ms ({smi})")
        print(f"[9] split of a request, p50 / max ms (wall clock on the "
              f"server's threads, interpreter-lock waits included): decode,"
              f" resample and tokenise {np.percentile(split['item'], 50):.3f}"
              f" / {max(split['item']):.3f}; handler (that, then the "
              f"batcher's wait and device batch) "
              f"{np.percentile(split['handle'], 50):.3f} / "
              f"{max(split['handle']):.3f}; the client's wall clock above "
              f"adds sending, reading and JSON-decoding the body and the "
              f"answer")
    finally:
        phase.stop()
    stamp("9", "HTTP")
    return launches, {"p50_ms": lat["p50"], "p99_ms": lat["p99"],
                      "batch_ms": bms, "occupancy": occupancy,
                      "item_p50_ms": float(np.percentile(split["item"], 50)),
                      "handle_p50_ms": float(np.percentile(split["handle"],
                                                           50))}


# ---------------------------------------------------------------- phase 10


def first_diff(a, b):
    """The first step at which two id rows differ (None when equal)."""
    idx = (a != b).nonzero()
    return None if idx.numel() == 0 else int(idx[0])


def tie_rule(ref, got, margin, what: str, tag: str) -> int:
    """Rows of ``got`` (N, T) equal ``ref``'s, or are excused: at the first
    place s where row r differs, ``margin(r, s)``, the reference side's
    logit margin there (``top2_margin`` of its logits, or ``ids_margin``),
    is below TIE_MARGIN. Any other difference is fatal; returns the count of
    excused rows."""
    rows = (ref != got).any(dim=1).nonzero().flatten().tolist()
    excused = 0
    for r in rows:
        s = first_diff(ref[r], got[r])
        m = margin(r, s)
        if m >= TIE_MARGIN:
            fail(f"{what}: row {r} differs at place {s} with a logit margin "
                 f"of {m}")
        excused += 1
    print(f"[{tag}] {what}: {ref.shape[0]} rows, {excused} excused by the "
          f"tie rule (logit margin below {TIE_MARGIN} at the first "
          f"differing place), every other row equal")
    return excused


def top2_margin(torch, logits) -> float:
    """The gap between the two largest logits of a (vocab,) row."""
    top2 = torch.topk(logits.float(), 2).values
    return float(top2[0] - top2[1])


def ids_margin(ref_ids, got_ids, ref_scores):
    """``tie_rule``'s margin for top-k id rows: the reference's logits of
    the two ids at the differing place."""
    return lambda r, j: abs(float(ref_scores[r, ref_ids[r, j]]
                                  - ref_scores[r, got_ids[r, j]]))


def cut_at_sep(ys):
    """Each row's ids up to and including its first SEP."""
    out = []
    for row in ys.tolist():
        out.append(row[:row.index(SEP) + 1] if SEP in row else row)
    return out


def relu_input(name: str, mod) -> bool:
    """Whether a ReLU or PReLU reads this module's output: every
    BatchNorm, the relation distance-MLP's two hidden linears, the first
    linear of every feed-forward block (the attention blocks' and the
    caption / MLM decoders') and CapNet's captioner's ``map_previous`` and
    ``obj_fc``."""
    from vlp3d_torch.models.layers import BatchNorm

    parts = name.split(".")
    return isinstance(mod, BatchNorm) or name.endswith(
        (".linear1", ".feed_forward.w_1", "caption.map_previous",
         "caption.obj_fc")) or (
            parts[:2] == ["relation", "self_attn_fc"] and len(parts) == 4
            and parts[3] in ("0", "3"))


@contextlib.contextmanager
def kinks(model, follow=None, take_all=False):
    """While open, record the output of every module ``relu_input`` names,
    call by call ({module: [tensor, ...]}). With ``follow``, such a record
    of another run of the same forward, a unit on the other side of 0 from
    ``follow``'s takes that run's value (its gradient flows straight
    through to this run's), so that both runs take the same branch of
    every ReLU; with ``take_all`` every unit takes it. Yields (the record,
    {module: (units moved, largest |input| of a moved unit on either side,
    or with ``take_all`` the largest change)})."""
    seen, moved, hooks = {}, {}, []

    def hook(mod, args, out, name):
        calls = seen.setdefault(name, [])
        if follow is None:
            calls.append(out.detach().clone())
            return None
        ref = follow[name][len(calls)]
        calls.append(None)
        if take_all:
            change = (ref - out.detach()).to(out.dtype)
            units, near = moved.get(name, (0, 0.0))
            moved[name] = (units + int((change != 0).sum()),
                           max(near, float(change.abs().max())))
            return out + change
        flipped = (out > 0) != (ref > 0)
        if not bool(flipped.any()):
            return None
        units, near = moved.get(name, (0, 0.0))
        moved[name] = (units + int(flipped.sum()), max(
            near, float(out.detach()[flipped].abs().max()),
            float(ref[flipped].abs().max())))
        return out + (ref - out.detach()).masked_fill(~flipped, 0.0)

    for name, mod in model.named_modules():
        if relu_input(name, mod):
            hooks.append(mod.register_forward_hook(
                lambda m, a, o, name=name: hook(m, a, o, name)))
    try:
        yield seen, moved
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def pool_ties(model, follow=None):
    """While open, record which neighbours (dim 2) hold the maximum of
    each SA module's shared-MLP output, the input of its max pool, call
    by call (a mask). With ``follow``, such a record of another run of
    the same forward (in this run's rows), a channel whose set of
    neighbours at the maximum differs from the followed one's takes the
    followed set: those neighbours go up to this run's maximum and any
    other at it goes one float below, so the pool's value stays this
    run's and its gradient is split over the followed neighbours, as
    ``kinks`` does at a ReLU. The set, not only its first neighbour: an
    exact tie between two neighbours, which rounding makes or breaks,
    splits the gradient between two rows. Yields (the record, {module:
    (channels moved, largest gap between this run's maximum and a
    followed neighbour's value)})."""
    import torch

    from vlp3d_torch.models.layers import SAModule

    seen, moved, hooks = {}, {}, []

    def hook(mod, args, out, name):
        calls = seen.setdefault(name, [])
        val = out.detach()
        top = val.amax(dim=2, keepdim=True)
        at_top = val == top
        if follow is None:
            calls.append(at_top)
            return None
        ref = follow[name][len(calls)]
        calls.append(None)
        diff = (at_top != ref).any(dim=2, keepdim=True)
        if not bool(diff.any()):
            return None
        below = torch.nextafter(top, torch.full_like(top, -float("inf")))
        new = torch.where(ref, top, torch.where(at_top, below, val))
        units, near = moved.get(name, (0, 0.0))
        moved[name] = (units + int(diff.sum()), max(near, float(
            (top - val).masked_fill(~(ref & diff), 0.0).max())))
        return out + torch.where(diff, new - val, torch.zeros_like(val))

    for name, mod in model.named_modules():
        if isinstance(mod, SAModule):
            hooks.append(mod.mlp_module.register_forward_hook(
                lambda m, a, o, name=name: hook(m, a, o, name)))
    try:
        yield seen, moved
    finally:
        for h in hooks:
            h.remove()


def fps_tie_gap(torch, xyz, inds):
    """How far FPS picks ``inds`` (B, npoint), made on other coordinates,
    are from ties on ``xyz`` (B, N, 3): the FPS replayed on ``xyz`` (in
    float64) along ``inds``' own history, each pick's running distance
    short of the step's largest over the valid points (|p|^2 > 1e-3), as
    a fraction of the largest; the largest such fraction (0: every pick
    is one the FPS on ``xyz`` would make or tie; inf if a row does not
    start at index 0)."""
    if bool((inds[:, 0] != 0).any()):
        return float("inf")
    b, n, _ = xyz.shape
    x, y, z = xyz.double().unbind(-1)
    valid = (x * x + y * y) + z * z > 1e-3
    temp = torch.full((b, n), 1e10, dtype=torch.float64, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    gap = 0.0
    prev = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for t in range(1, inds.shape[1]):
        dx, dy, dz = (x - x[rows, prev, None], y - y[rows, prev, None],
                      z - z[rows, prev, None])
        torch.minimum(temp, (dx * dx + dy * dy) + dz * dz, out=temp)
        prev = inds[:, t].long()
        top = torch.where(valid, temp, -1.0).max(1).values
        got = torch.where(valid[rows, prev], temp[rows, prev], -1.0)
        short = ((top - got) / top.clamp(min=1e-30)).where(
            valid.any(1), torch.zeros_like(top))
        gap = max(gap, float(short.max()))
    return gap


def ball_tie_gap(torch, xyz, centers, ref_xyz, ref_centers, radius):
    """How far each ball membership that differs between two runs is
    from the radius: d^2 in either run within this fraction of r^2
    (each run's points ``xyz`` / ``ref_xyz`` (B, N, 3) around its centres
    (B, M, 3)); 0 where no membership differs."""
    r2 = radius * radius

    def d2(p, c):
        d = p.double()[:, None] - c.double()[:, :, None]
        return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + (
            d[..., 2] * d[..., 2])

    mine, ref = d2(xyz, centers), d2(ref_xyz, ref_centers)
    flipped = (mine < r2) != (ref < r2)
    if not bool(flipped.any()):
        return 0.0
    return float(torch.maximum((mine - r2).abs(), (ref - r2).abs())
                 [flipped].max()) / r2


# SA modules that read the raw cloud (SA1) or rows gathered from it
# (SA2-SA4): two runs of the same batch give them the same coordinates,
# so their sampled indices must agree exactly
RAW_CLOUD_SA = ("backbone_net.", "detection_backbone.")


@contextlib.contextmanager
def index_ties(model, follow=None):
    """While open, record each SA module's sampled indices (its FPS
    centres and ball-query neighbours) and its input coordinates, call by
    call. With ``follow``, such a record of another run of the same
    forward (in this run's rows), each module takes those indices, its
    centres gathered from this run's points, as ``kinks`` does at a ReLU:
    the vote aggregation samples predicted votes, whose coordinates move
    within rounding between two runs that sum over the batch in another
    order, and an FPS pick or a ball membership within rounding of a tie
    moves a whole neighbourhood. A module whose coordinates equal the
    followed run's bit for bit (and every RAW_CLOUD_SA module, whose
    coordinates must) follows nothing: any index that differs there is a
    fault, gap inf. Elsewhere each followed index is measured against a
    tie on this run's coordinates (fps_tie_gap, ball_tie_gap). Yields
    (the record, {module: (indices that differed from this run's own,
    largest gap)})."""
    import torch

    from vlp3d_torch.models.layers import SAModule
    from vlp3d_torch.ops import (
        ball_query,
        furthest_point_sample,
        gather_points,
    )

    seen, moved, hooked = {}, {}, []

    def sample(mod, name, xyz):
        calls = seen.setdefault(name, [])
        if follow is None:
            inds, new_xyz, idx = type(mod).sample(mod, xyz)
            calls.append((inds, idx, xyz.detach().clone()))
            return inds, new_xyz, idx
        ref_inds, ref_idx, ref_xyz = follow[name][len(calls)]
        calls.append(None)
        # SAModule.sample's launches, once each whichever picks are taken:
        # this run's own ball query around centres gathered outside the
        # counts, then the kernel gather (and its backward) at the picks
        # taken
        inds = furthest_point_sample(xyz, mod.npoint)
        with torch.no_grad():
            own = torch.gather(xyz, 1, inds.long()[..., None].expand(
                -1, -1, xyz.shape[-1]))
        idx = ball_query(mod.radius, mod.nsample, xyz, own)
        n = int((inds != ref_inds).sum()) + int((idx != ref_idx).sum())
        same = xyz.shape == ref_xyz.shape and bool(torch.equal(xyz, ref_xyz))
        if not n and (same or not name.startswith(RAW_CLOUD_SA)):
            return inds, gather_points(xyz, inds), idx
        centers = gather_points(xyz, ref_inds)
        if same or name.startswith(RAW_CLOUD_SA):
            gap = float("inf")
        else:
            gap = max(fps_tie_gap(torch, xyz.detach(), ref_inds),
                      ball_tie_gap(torch, xyz.detach(), centers.detach(),
                                   ref_xyz, torch.gather(
                                       ref_xyz, 1, ref_inds.long()[..., None]
                                       .expand(-1, -1, xyz.shape[-1])),
                                   mod.radius))
        units, near = moved.get(name, (0, 0.0))
        moved[name] = (units + n, max(near, gap))
        return ref_inds, centers, ref_idx

    for name, mod in model.named_modules():
        if isinstance(mod, SAModule):
            mod.sample = (lambda xyz, mod=mod, name=name:
                          sample(mod, name, xyz))
            hooked.append(mod)
    try:
        yield seen, moved
    finally:
        for mod in hooked:
            del mod.sample


def check_kernel_step(torch, tag, model, config, batch, probe, what,
                      caption=False, take_all=False,
                      grad_tol=STEP_GRAD_TOL, loss_fn=None,
                      follow_ties=False):
    """The kernel train step against the plain-op step on one batch, with
    one dropout (and token- and box-mask) draw: the plain-op run first,
    recording every ReLU input, then the kernel run following its side of
    0 (the two forwards differ in the interpolation's order of summation,
    and a unit within rounding of 0 would move the gradient of its whole
    BatchNorm channel and of everything the forward ran before it). A
    moved unit must lie within FLIP_TOL of 0; then the loss is held to
    STEP_LOSS_RTOL and every probe's gradient to ``grad_tol`` of its
    largest entry. With ``take_all`` (bfloat16 point MLPs, where that
    order moves whole bfloat16 units through the batch statistics) the
    kernel run takes the plain run's value at every unit of those
    modules, and the backward alone is compared. ``loss_fn`` replaces the
    joint loss (see loss_and_grads). With ``follow_ties`` the kernel run
    also follows the plain run's max-pool choices (pool_ties: a moved
    channel within FLIP_TOL of its maximum) and sampled indices
    (index_ties: exact on the raw cloud's SA modules, within
    INDEX_TIE_TOL of a tie on the votes'). Returns (loss_rel, worst,
    {module: units moved})."""
    ties = contextlib.ExitStack()
    with ties, plain_ops(), kinks(model) as (pre_p, _):
        if follow_ties:
            pools_p, _ = ties.enter_context(pool_ties(model))
            inds_p, _ = ties.enter_context(index_ties(model))
        loss_p, grads_p = loss_and_grads(torch, model, config, batch,
                                         probe, 11, caption=caption,
                                         loss_fn=loss_fn)
    ties = contextlib.ExitStack()
    with ties, kinks(model, follow=pre_p, take_all=take_all) as (_, moved):
        if follow_ties:
            _, pooled = ties.enter_context(pool_ties(model, follow=pools_p))
            _, resampled = ties.enter_context(
                index_ties(model, follow=inds_p))
        loss_k, grads_k = loss_and_grads(torch, model, config, batch,
                                         probe, 11, caption=caption,
                                         loss_fn=loss_fn)
    del pre_p
    for name, (units, near) in moved.items():
        if near > FLIP_TOL and not take_all:
            fail(f"{what}: {units} ReLU inputs of {name}, up to {near} from "
                 "0, decided differently in the two runs")
    if follow_ties:
        del pools_p, inds_p
        for name, (units, gap) in pooled.items():
            if gap > FLIP_TOL:
                fail(f"{what}: {units} max-pool channels of {name}, up to "
                     f"{gap} below the maximum, chose differently")
        for name, (units, gap) in resampled.items():
            if gap > INDEX_TIE_TOL:
                fail(f"{what}: {units} sampled indices of {name}, {gap} "
                     "from a tie, differ between the two runs")
        print(f"[{tag}] {what}: max-pool channels that followed the plain "
              f"run {({k: v[0] for k, v in pooled.items()})}, sampled "
              f"indices {({k: v for k, v in resampled.items()})}")
    errs = {}
    for n in probe:
        scale = grads_p[n].abs().max().item()
        errs[n] = (grads_k[n] - grads_p[n]).abs().max().item() / max(
            scale, 1e-30)
    worst = max(errs.values())
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    print(f"[{tag}] {what}, kernels against plain ops on the card: loss "
          f"{loss_k.item()} vs {loss_p.item()} (relative {loss_rel}); "
          f"gradient difference of each probe, of its largest entry: "
          f"{errs}; ReLU "
          f"inputs that followed the plain run (module: units, largest "
          f"{'change' if take_all else '|input|'}) {moved}")
    if loss_rel > STEP_LOSS_RTOL or worst > grad_tol:
        fail(f"the {what} differs from the plain-op step")
    return loss_rel, worst, {k: v[0] for k, v in moved.items()}


class CliProcesses:
    """``python -m vlp3d_torch.cli.<module>`` children started together in
    a temporary directory, each timed to its own exit by a thread;
    :meth:`stop` kills any still running."""

    def __init__(self):
        import tempfile

        self.tmp = tempfile.TemporaryDirectory()
        self.procs, self.results, self.threads = {}, {}, []

    def launch(self, module, args, key=None):
        """Start ``module``; its process and result go by ``key`` (the
        module's name unless two processes run one module)."""
        import threading

        key = key or module
        proc = subprocess.Popen(
            [sys.executable, "-m", f"vlp3d_torch.cli.{module}", *args],
            cwd=REPO, env=child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.procs[key] = proc
        self.threads.append(threading.Thread(
            target=self._wait, args=(key, time.perf_counter(), proc),
            daemon=True))
        self.threads[-1].start()

    def _wait(self, module, t0, proc):
        text, _ = proc.communicate(timeout=600)
        self.results[module] = (text, time.perf_counter() - t0)

    def ended(self):
        """{key: (output, s)} once each has exited 0; fails else."""
        for t in self.threads:
            t.join(timeout=600)
        for module, proc in self.procs.items():
            if module not in self.results:
                fail(f"python -m vlp3d_torch.cli.{module} did not end")
            if proc.returncode != 0:
                fail(f"python -m vlp3d_torch.cli.{module} exited "
                     f"{proc.returncode}:\n{self.results[module][0][-3000:]}")
        return {m: self.results[m] for m in self.procs}

    def stop(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self.tmp.cleanup()


class CaptionClis(CliProcesses):
    """Phase 10's caption_predict and caption_eval processes over
    stand-in assets (seeded weights), started beside phase 8."""

    def __init__(self):
        from vlp3d_torch.data.standins import write_standin_assets

        super().__init__()
        self.paths = write_standin_assets(self.tmp.name)
        self.assets = [
            "--scanrefer_dir", self.paths["scanrefer_dir"],
            "--scannet_data", self.paths["scannet_data"], "--bert_vocab",
            os.path.join(self.paths["bert_dir"], "vocab.txt")]
        self.out = {m: os.path.join(self.tmp.name, f"{m}.json")
                    for m in ("caption_predict", "caption_eval")}

    def start(self):
        for module, out in self.out.items():
            self.launch(module, [*CAPTION_CLI_FLAGS, *self.assets, "--out",
                                 out])
        stamp("10", "caption_predict and caption_eval CLIs started")

    def check(self):
        import numpy as np

        for module, (out, sec) in self.ended().items():
            print(f"[10] {module} CLI: exit 0 in {sec:.1f} s; last line "
                  f"{out.strip().splitlines()[-1][:160]!r}")
        with open(self.out["caption_predict"]) as f:
            pred = json.load(f)
        recs = [r for scene in pred.values() for r in scene]
        if not pred or any(
                np.asarray(r["box"]).shape != (8, 3)
                or not isinstance(r["caption"], str)
                or not r["caption"].endswith("[SEP]") for r in recs):
            fail(f"caption pred.json over the stand-ins: {str(pred)[:400]}")
        with open(self.out["caption_eval"]) as f:
            metrics = json.load(f)
        names = {"bleu-1", "bleu-2", "bleu-3", "bleu-4", "cider", "rouge",
                 "meteor"}
        if set(metrics) != names or not all(np.isfinite(v)
                                            for v in metrics.values()):
            fail(f"caption_eval metrics {metrics}")
        print(f"[10] caption pred.json: {len(pred)} scenes, {len(recs)} "
              f"kept proposals, boxes 8 x 3, captions such as "
              f"{recs[0]['caption'][:80]!r}; caption_eval "
              f"{json.dumps(metrics)}")


def check_train_caption(result, workdir):
    """train_caption's process (run beside phase 8's --auto_resume run):
    exit 0, its warm-start counts, the caption loss finite."""
    import numpy as np

    if "caption_train" not in result:
        fail("the train_caption CLI did not run")
    rc, out, sec = result["caption_train"]
    if rc != 0:
        fail(f"python -m vlp3d_torch.cli.train_caption exited {rc}:\n"
             f"{out[-4000:]}")
    line = [ln for ln in out.splitlines() if ln.startswith("warm-started")]
    with open(os.path.join(workdir, "log.jsonl")) as f:
        train = [r for r in map(json.loads, f) if r["phase"] == "train"]
    if not line or " 0 fresh" in line[0] or not train or not all(
            np.isfinite(r["cap_loss"]) and np.isfinite(r["cap_acc"])
            for r in train):
        fail(f"train_caption: {line} {train}")
    print(f"[10] train_caption CLI (--pretrain phase 8's model.pth, "
          f"--synthetic --epoch 1): exit 0 in {sec:.1f} s; {line[0]}; "
          f"cap_loss {[round(r['cap_loss'], 4) for r in train]}")


class CaptionPhase:
    """Phase 10 in this process: the models, the untimed checks (cached
    against uncached decode, beam width 1 against greedy, the kernel
    step against the plain-op step) and the HTTP services, all made while
    the CLI processes run; :meth:`drive` then times the main paths with
    the card to itself."""

    def __init__(self, torch, smi, scenes, ground_state, train_host):
        import dataclasses

        from vlp3d_torch.config import Config, ModelConfig
        from vlp3d_torch.serve import InferenceService, make_server
        from vlp3d_torch.serving import CaptionPredictor

        import threading

        self.smi, self.scenes, self.train_host = smi, scenes, train_host
        t0 = time.perf_counter()
        config = Config(model=ModelConfig(use_con=False, no_caption=False))
        self.config = config
        self.pred = CaptionPredictor(config, batch_size=B)
        # phase 5's model, with seeded caption weights
        self.pred.model.load_state_dict(
            {**self.pred.model.state_dict(), **ground_state}, strict=True)
        cfg = config.model
        dec = self.pred.model.caption.model
        if (dec.n_layers, dec.d_model, dec.vocab_size, cfg.max_des_len,
                cfg.num_proposal, cfg.input_feature_dim) != CAPTION_WIDTHS:
            fail(f"caption model is not run.sh's: {dec} {cfg}")
        print(f"[10] caption model built in {time.perf_counter() - t0:.1f} s"
              f" (phase 5's weights + a seeded {dec.n_layers}-layer "
              f"d={dec.d_model} decoder, vocab {dec.vocab_size})")
        self.check_decodes(torch)
        self.train = {mlm: self.check_step(torch, mlm) for mlm in (False,
                                                                    True)}
        state = self.pred.model.state_dict()
        self.services = {
            task: InferenceService(
                dataclasses.replace(config, dataset=dataclasses.replace(
                    config.dataset, num_points=N)), state, task=task,
                batch_size=B, max_wait_ms=HTTP_MAX_WAIT_MS)
            for task in ("ground", "caption")}
        self.server = make_server(self.services)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        for s in self.services.values():
            s.warmup()
        self.http_refs(torch)
        stamp("10", "caption models, untimed checks and HTTP services")

    # -- (a) untimed: decodes against their oracles ----------------------

    def check_decodes(self, torch):
        from vlp3d_torch.models.caption import (
            beam_decode,
            greedy_decode,
            greedy_decode_uncached,
        )

        pred, cfg = self.pred, self.config.model
        dec = pred.model.caption.model
        out = pred.forward(pred._to_device(self.scenes[0]))
        obj = out["aggregated_vote_features"].reshape(
            B * cfg.num_proposal, 1, -1)
        cached = greedy_decode(dec, obj, cfg.max_des_len)
        plain = greedy_decode_uncached(dec, obj, cfg.max_des_len)

        def plain_logits(rows, s):
            return dec.decode_step(obj[rows], plain[rows], s - 1)

        self.excused = tie_rule(
            plain, cached,
            lambda r, s: top2_margin(torch, plain_logits([r], s)[0]),
            "KV-cached greedy against uncached", "10")

        def cached_logits(rows, s):
            return dec.decode_step(obj[rows], cached[rows], s - 1)

        beam1, _ = beam_decode(dec, obj, cfg.max_des_len, 1)
        a, b = cut_at_sep(cached), cut_at_sep(beam1)
        differ = [r for r in range(len(a)) if a[r] != b[r]]
        for r in differ:  # the tie rule, on the prefix up to SEP
            s = next(i for i, (x, y) in enumerate(zip(a[r], b[r])) if x != y)
            if top2_margin(torch, cached_logits([r], s)[0]) >= TIE_MARGIN:
                fail(f"beam width 1 differs from greedy at row {r}, step {s}")
        self.beam1_excused = len(differ)
        if any(r[0] != 101 for r in a):
            fail("a caption does not start with CLS")
        print(f"[10] beam width 1 against greedy up to the first SEP: "
              f"{len(a)} rows, {len(differ)} excused by the tie rule; "
              f"{sum(SEP in r for r in a)} greedy rows reach SEP")

    # -- (b) untimed: the kernel step against the plain-op step ----------

    def check_step(self, torch, mlm):
        from vlp3d_torch.config import Config, ModelConfig
        from vlp3d_torch.models import JointNet
        from vlp3d_torch.train import (
            batch_to_device,
            make_optimizer,
            make_train_step,
        )
        from vlp3d_torch.train.schedules import cosine_lr

        config = Config(model=ModelConfig(use_con=True, no_caption=False,
                                          use_mlm=mlm))
        model = JointNet(config)
        with torch.no_grad():  # phase 6's nudges
            model.vgen.conv3.weight.mul_(0.05)
            model.vgen.conv3.bias.mul_(0.05)
            model.proposal.proposal.box_predictor.bias.fill_(-1.0)
        batch = batch_to_device(self.train_host, next(
            model.parameters()).device)
        heads = ("caption", "mlm") if mlm else ("caption",)
        probe = ["backbone_net.sa1.mlp_module.layer0.conv.weight",
                 "proposal.vote_aggregation.mlp_module.layer0.conv.weight",
                 "match.match.0.weight"]
        for head in heads:
            probe += [f"{head}.model.generator.proj.weight",
                      f"{head}.model.decoder.norm.a_2",
                      f"{head}.model.decoder.layers.5.feed_forward.w_1.weight",
                      f"{head}.model.decoder.layers.0.self_attn.linears.0."
                      f"weight", f"{head}.model.tgt_embed.0.lut.weight"]
        check_kernel_step(torch, "10", model, config, batch, probe,
                          f"caption{'+MLM' if mlm else ''} step",
                          caption=True)
        optimizer = make_optimizer(
            model, lr_schedule=lambda e, lr0: cosine_lr(e, lr0, 200),
            steps_per_epoch=100)
        step = make_train_step(model, config, optimizer, caption=True)
        step(batch, torch.Generator(device=batch["point_clouds"].device))
        torch.cuda.synchronize()  # the first step's costs, untimed
        return model, step, batch

    # -- (d) untimed: the HTTP requests and their references -------------

    def http_refs(self, torch):
        import base64

        import numpy as np

        from vlp3d_torch.serving import STREAM_KEYS

        rng = np.random.default_rng(10)
        svc = self.services["caption"]
        c = 3 + self.config.model.input_feature_dim
        self.reqs, self.refs = [], []
        for i in range(CAPTION_HTTP_REQUESTS):
            pc = rng.uniform(0, 4, (N, c)).astype(np.float32)
            req = {"point_cloud": {"b64": base64.b64encode(
                pc.astype("<f4").tobytes()).decode(), "shape": list(pc.shape)}}
            if i % 2:
                req["queries"] = ["the brown chair by the window"]
            self.reqs.append(req)
            item, _ = svc._make_item(req)
            dev = svc._pred._to_device({k: np.asarray(item[k])[None]
                                        for k in STREAM_KEYS})
            dev = {k: torch.cat([v] * B) for k, v in dev.items()}
            out = svc._pred.forward(dev)
            got = svc._pred.decode(out)
            self.refs.append((out["aggregated_vote_features"][0],
                              {k: v[0].cpu() for k, v in got.items()}))
        self.ground_req = dict(self.reqs[0], queries=["the chair"])
        self.bodies = [json.dumps(r).encode() for r in self.reqs]

    # -- the timed main paths, with the card to itself -------------------

    def drive(self, torch):
        """(a), (b) and (d) with every count at 0 before each; returns
        ({path: launch counts}, numbers for the results line)."""
        launches, numbers = {}, {}
        try:
            launches["caption_serve"], numbers["serve"] = self.serve(torch)
            launches["caption_step"], numbers["step"] = self.steps(torch)
            launches["caption_http"], numbers["http"] = self.http(torch)
        finally:
            self.stop()
        return launches, numbers

    def serve(self, torch):
        import numpy as np

        from vlp3d_torch import ops

        pred, smi = self.pred, self.smi
        cfg = self.config.model
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # every model of this process is resident: peaks are reported
        # above what was allocated before the work
        resident = torch.cuda.memory_allocated()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = pred([self.scenes[1]])[0]  # the entry point a user calls
        call_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated() - resident
        if launches != PER_FORWARD:
            fail(f"caption serving launches {launches} != {PER_FORWARD}")
        ids = res["caption_ids"]
        if ids.shape != (B, cfg.num_proposal, cfg.max_des_len + 2) or not (
                ids[..., 0] == 101).all():
            fail(f"caption ids {ids.shape}")
        for key in ("pred_center", "pred_size", "objectness_scores",
                    "sem_cls_scores"):
            if not np.isfinite(res[key]).all():
                fail(f"caption serving: non-finite {key}")
        # forward and decode timed apart, greedy and beam width 3 (median
        # of 3, host clock to a synchronise, batch already on the card)
        dev = pred._to_device(self.scenes[2])
        out = pred.forward(dev)
        times, peaks = {}, {}
        for name, beams in (("forward", None), ("greedy", 1),
                            (f"beam{CAPTION_BEAMS}", CAPTION_BEAMS)):
            pred.num_beams = beams or 1
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            times[name] = []
            for _ in range(3):
                t0 = time.perf_counter()
                pred.forward(dev) if beams is None else pred.decode(out)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
            peaks[name] = (torch.cuda.max_memory_allocated()
                           - resident) / 2**30
        pred.num_beams = 1
        med = {k: float(np.median(v)) for k, v in times.items()}
        captions = B * cfg.num_proposal
        print(f"[10] caption serving at B={B}, N={N}: {captions} captions a "
              f"batch, launches a batch {launches}; the whole call "
              f"{call_ms:.3f} ms (host batch to host predictions, peak "
              f"{peak / 2**30:.3f} GiB above the resident models); median "
              f"of 3, ms: forward "
              f"{med['forward']:.3f}, greedy decode {med['greedy']:.3f}, "
              f"beam-{CAPTION_BEAMS} decode {med[f'beam{CAPTION_BEAMS}']:.3f}"
              f"; peak GiB above the resident models and batch "
              f"{json.dumps(peaks)}; excused rows: cached "
              f"{self.excused}, beam-1 {self.beam1_excused} ({smi})")
        profile_call(torch, lambda: pred.decode(out), "10", "greedy decode",
                     top=12)
        stamp("10", "caption serving")
        return launches, {"call_ms": call_ms, "forward_ms": med["forward"],
                          "greedy_ms": med["greedy"],
                          "beam_ms": med[f"beam{CAPTION_BEAMS}"],
                          "peak_gib": peaks, "excused": self.excused}

    def steps(self, torch):
        import numpy as np

        from vlp3d_torch import ops

        total = {k: 0 for k in PER_STEP}
        numbers = {}
        for mlm, (model, step, batch) in self.train.items():
            gen = torch.Generator(device=batch["point_clouds"].device)
            gen.manual_seed(0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            ms, history = [], []
            for _ in range(CAPTION_STEPS):
                ops.reset_launches()
                t0 = time.perf_counter()
                history.append(step(batch, gen))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                one = dict(ops.launches)
                if one != PER_STEP:
                    fail(f"caption step launches {one} != {PER_STEP}")
                total = {k: total[k] + one[k] for k in total}
            peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
            history = [{k: v.item() for k, v in m.items()} for m in history]
            keys = ("cap_loss", "cap_acc") + (("mlm_loss",) if mlm else ())
            for m in history:
                for k, v in m.items():
                    if not np.isfinite(v):
                        fail(f"caption step: non-finite {k}")
                if any(k not in m for k in keys):
                    fail(f"caption step metrics {sorted(m)}")
            name = "caption+mlm" if mlm else "caption"
            numbers[name] = {"ms": ms, "peak_gib": peak}
            print(f"[10] {name} train step at B={B}, N={N}: ms {ms} (host "
                  f"clock to a synchronise), peak {peak:.3f} GiB above the "
                  f"resident models, optimizers and batch; launches "
                  f"a step {one}; "
                  + json.dumps({k: [round(m[k], 5) for m in history]
                                for k in ("loss",) + keys})
                  + f" ({self.smi})")
        self.train.clear()
        torch.cuda.empty_cache()
        stamp("10", "caption train steps")
        return total, numbers

    def http(self, torch):
        import threading
        import urllib.request

        import numpy as np

        from vlp3d_torch import ops

        svc = self.services["caption"]
        port = self.server.server_address[1]
        served = []  # (caption ids, captions) of every answer
        proposals = svc._proposals

        def recording(out):
            props = proposals(out)
            served.append((out["caption_ids"], [p["caption"] for p in props]))
            return props

        svc._proposals = recording
        answers = [None] * len(self.bodies)

        def call(i):
            answers[i] = _post(port, "/v1/caption", self.bodies[i])

        torch.cuda.synchronize()
        ops.reset_launches()
        before = {t: s.stats()["device_batches"]
                  for t, s in self.services.items()}
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(self.bodies))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        ground = _post(port, "/v1/ground", json.dumps(self.ground_req).encode())
        for t in threads:
            t.join(timeout=600)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ops.launches)
        svc._proposals = proposals
        batches = {t: s.stats()["device_batches"] - before[t]
                   for t, s in self.services.items()}
        codes = [a[0] if a else None for a in answers] + [ground[0]]
        print(f"[10] {len(self.bodies)} concurrent /v1/caption requests "
              f"(b64 clouds of {N} x {3 + self.config.model.input_feature_dim}"
              f") and one /v1/ground in {wall_ms:.3f} ms: codes {codes}, "
              f"device batches {batches}, launches {launches}")
        if codes != [200] * len(codes):
            fail(f"caption HTTP requests failed: {codes}")
        n_batches = sum(batches.values())
        if launches != {k: n_batches * v for k, v in PER_FORWARD.items()}:
            fail(f"caption HTTP launches {launches} over {n_batches} batches")
        dec = svc._pred.model.caption.model
        excused, worst = 0, 0.0
        for (code, ans), (feat, ref) in zip(answers, self.refs):
            caps = [p["caption"] for p in ans["proposals"]]
            ids = next(torch.as_tensor(i) for i, c in served if c == caps)
            want = ref["caption_ids"]

            def ref_logits(rows, s, feat=feat, want=want):
                dev = feat.device
                return dec.decode_step(feat[rows][:, None],
                                       want[rows].to(dev), s - 1)

            excused += tie_rule(
                want, ids,
                lambda r, s, f=ref_logits: top2_margin(torch, f([r], s)[0]),
                "an HTTP caption against the predictor alone", "10")
            for k, p in enumerate(ans["proposals"]):
                for key in ("center", "size"):
                    worst = max(worst, float(np.abs(np.asarray(p[key]) -
                                                    ref[f"pred_{key}"][k]
                                                    .numpy()).max()))
        if worst > BOX_TOL:
            fail(f"HTTP caption boxes differ from the predictor's by {worst}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=60) as r:
            stats = json.loads(r.read())
        print(f"[10] HTTP captions equal the predictor's alone ({excused} "
              f"rows excused), boxes within {worst} (tolerance {BOX_TOL}); "
              f"caption device-batch ms {stats['caption']['batch_ms']}, "
              f"request ms {stats['caption']['latency_ms']} ({self.smi})")
        stamp("10", "caption HTTP")
        return launches, {"wall_ms": wall_ms, "batches": batches,
                          "excused": excused}

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        for s in self.services.values():
            s.close()
        self.thread.join(timeout=30)


# ---------------------------------------------------------------- phase 11


def check_train_qa(result, workdir):
    """train_qa's process (run beside phase 8's --auto_resume run): exit
    0, its warm-start counts (the answer head fresh), the answer loss
    finite, the val EM logged, info.json's num_answers."""
    import numpy as np

    if "qa_train" not in result:
        fail("the train_qa CLI did not run")
    rc, out, sec = result["qa_train"]
    if rc != 0:
        fail(f"python -m vlp3d_torch.cli.train_qa exited {rc}:\n"
             f"{out[-4000:]}")
    line = [ln for ln in out.splitlines() if ln.startswith("warm-started")]
    with open(os.path.join(workdir, "log.jsonl")) as f:
        records = [json.loads(r) for r in f]
    with open(os.path.join(workdir, "info.json")) as f:
        info = json.load(f)
    train = [r for r in records if r["phase"] == "train"]
    val = [r for r in records if r["phase"] == "val"]
    if not line or " 10 fresh" not in line[0] or not train or not all(
            np.isfinite(r["answer_loss"]) for r in train) or not val \
            or "answer_acc_at1" not in val[-1] or info["num_answers"] < 1:
        fail(f"train_qa: {line} {train} {val} {info.get('num_answers')}")
    print(f"[11] train_qa CLI (--pretrain phase 8's model.pth, "
          f"{' '.join(VQA_CLI_FLAGS)} --synthetic --epoch 1): exit 0 in "
          f"{sec:.1f} s; {line[0]}; num_answers {info['num_answers']}; "
          f"answer_loss {[round(r['answer_loss'], 4) for r in train]}; val "
          f"EM@1 {val[-1]['answer_acc_at1']}, EM@10 "
          f"{val[-1]['answer_acc_at10']}")


class VqaPhase:
    """Phase 11 in this process: ScanQA at run.sh's widths. The models,
    the untimed checks (the kernel forward's answers and the VQA-recipe
    step against the plain ops, a Solver eval batch) and the HTTP services
    are made while the CLI processes run; :meth:`drive` then times the
    main paths with the card to itself."""

    def __init__(self, torch, smi, scenes, ground_state, train_host):
        import dataclasses
        import threading

        from vlp3d_torch.config import Config, ModelConfig
        from vlp3d_torch.serve import InferenceService, make_server
        from vlp3d_torch.serving import AnswerPredictor

        self.smi, self.scenes = smi, scenes
        t0 = time.perf_counter()
        config = Config(model=ModelConfig(use_con=False, no_caption=True,
                                          use_answer=True))
        self.config = config
        self.pred = AnswerPredictor(config, batch_size=B, topk=VQA_TOPK)
        # phase 5's model, with the seeded answer head
        self.pred.model.load_state_dict(
            {**self.pred.model.state_dict(), **ground_state}, strict=True)
        cfg = config.model
        widths = (cfg.input_feature_dim, cfg.num_proposal, cfg.num_answers,
                  cfg.lang_num_max)
        if widths != VQA_WIDTHS:
            fail(f"answer model is not at run.sh's widths: {widths}")
        print(f"[11] answer model built in {time.perf_counter() - t0:.1f} s"
              f" (phase 5's weights + a seeded answer head over "
              f"{cfg.num_answers} answers)")
        self.check_answers(torch)
        self.step = self.check_step(torch, train_host)
        self.eval_launches, self.eval_result = self.solver_eval(torch)
        state = self.pred.model.state_dict()
        self.services = {
            task: InferenceService(
                dataclasses.replace(config, dataset=dataclasses.replace(
                    config.dataset, num_points=N)), state, task=task,
                batch_size=B, max_wait_ms=HTTP_MAX_WAIT_MS)
            for task in ("ground", "answer")}
        self.server = make_server(self.services)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        for s in self.services.values():
            s.warmup()
        self.http_refs()
        stamp("11", "answer models, untimed checks and HTTP services")

    # -- (a) untimed: the kernel forward's answers against the plain ops -

    def check_answers(self, torch):
        from vlp3d_torch.serving import answer

        pred, l = self.pred, self.config.model.lang_num_max
        dev = pred._to_device(self.scenes[0])
        got = answer(pred.model, dev, VQA_TOPK)
        with plain_ops():
            want = answer(pred.model, dev, VQA_TOPK)
        scores_k = got["answer_scores"].reshape(B * l, -1)
        scores_p = want["answer_scores"].reshape(B * l, -1)
        scale = float(scores_p.abs().max())
        err = float((scores_k - scores_p).abs().max()) / scale
        ids_p = want["answer_top_ids"].reshape(B * l, -1)
        ids_k = got["answer_top_ids"].reshape(B * l, -1)
        self.excused = tie_rule(
            ids_p, ids_k, ids_margin(ids_p, ids_k, scores_p),
            "top-10 answers, kernels against plain ops", "11")
        print(f"[11] answers of {B * l} questions, kernels against plain ops "
              f"on the card: logits within {err} of the largest "
              f"({scale}); top-{VQA_TOPK} ids equal, {self.excused} rows "
              f"excused by the tie rule")
        if err > VQA_SCORE_TOL:
            fail(f"answer logits differ from the plain forward's by {err}")

    # -- (b) untimed: the VQA-recipe step against the plain-op step -----

    def check_step(self, torch, train_host):
        import numpy as np

        from vlp3d_torch.models import JointNet
        from vlp3d_torch.train import (
            batch_to_device,
            make_optimizer,
            make_train_step,
        )
        from vlp3d_torch.train.schedules import step_lr

        config = self.config
        model = JointNet(config)
        with torch.no_grad():  # phase 6's nudges
            model.vgen.conv3.weight.mul_(0.05)
            model.vgen.conv3.bias.mul_(0.05)
            model.proposal.proposal.box_predictor.bias.fill_(-1.0)
        # phase 6's batch with ScanQA labels: a few answers a question,
        # soft scores from the train frequency's steps
        rng = np.random.default_rng(11)
        l, a = config.model.lang_num_max, config.model.num_answers
        cats = np.zeros((B, l, a), np.float32)
        for i in range(B):
            for j in range(l):
                cats[i, j, rng.choice(a, 1 + j % 3, replace=False)] = 1.0
        host = dict(train_host, answer_cats=cats,
                    answer_cat_scores=cats * rng.choice(
                        [0.3, 0.6, 0.9, 1.0], size=cats.shape).astype(
                            np.float32),
                    answer_cat=np.argmax(cats, -1).astype(np.int32))
        batch = batch_to_device(host, next(model.parameters()).device)
        probe = ["backbone_net.sa1.mlp_module.layer0.conv.weight",
                 "backbone_net.fp2.mlp.layer0.conv.weight",
                 "proposal.vote_aggregation.mlp_module.layer0.conv.weight",
                 "relation.features_concat.0.weight",
                 "match.grounding_cross_attn.0.enc_dec_attention.attention."
                 "fc_q.weight", "match.match.0.weight", "lang.proj.weight",
                 "answer.attflat_visual.mlp.fc.linear.weight",
                 "answer.attflat_visual.linear_merge.weight",
                 "answer.answer_cls.0.weight", "answer.answer_cls.3.weight",
                 "answer.answer_cls.3.bias"]
        loss_rel, worst, moved = check_kernel_step(
            torch, "11", model, config, batch, probe, "VQA step")
        optimizer = make_optimizer(
            model, base_lr=5e-4, module_lr=5e-4, weight_decay=1e-5,
            lr_schedule=lambda e, lr0: step_lr(e, lr0, (100, 200), 0.2),
            steps_per_epoch=100, optim_name="adam", single_group=True,
            clip_grad_value=1.0)
        step = make_train_step(model, config, optimizer)
        step(batch, torch.Generator(device=batch["point_clouds"].device))
        torch.cuda.synchronize()  # the first step's costs, untimed
        self.step_numbers = {"loss_rel": loss_rel, "grad_err": worst,
                             "flips": moved}
        return model, step, batch

    # -- (c) untimed: a Solver eval batch --------------------------------

    def solver_eval(self, torch):
        import tempfile

        from vlp3d_torch import ops
        from vlp3d_torch.data.synthetic import synthetic_qa
        from vlp3d_torch.data.tokenizer import HashTokenizer
        from vlp3d_torch.data.vqa_dataset import (
            ScanQADataset,
            build_answer_vocab,
        )
        from vlp3d_torch.train.solver import Solver

        config = self.config
        qa, source = synthetic_qa(config)
        vocab, counter = build_answer_vocab(qa)
        ds = ScanQADataset(
            qa, source, HashTokenizer(), split="val", answer_vocab=vocab,
            answer_counter=counter, num_answers=config.model.num_answers,
            num_points=config.dataset.num_points,
            lang_num_max=config.model.lang_num_max,
            bert_max_len=config.model.bert_seq_len,
            mean_size_arr=config.dataset.mean_size_arr())
        with tempfile.TemporaryDirectory() as tmp:
            solver = Solver(config, ds, ds, tmp, log_every=1)
            solver.init_state()
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            res = solver.eval_epoch(0)
            sec = time.perf_counter() - t0
            launches = dict(ops.launches)
            solver.close()
            del solver
        torch.cuda.empty_cache()
        batches = -(-len(ds) // config.train.batch_size)
        if launches != {k: batches * v for k, v in PER_FORWARD.items()}:
            fail(f"solver eval launches {launches} over {batches} batches")
        if not ("answer_acc_at1" in res and "answer_acc_at10" in res
                and 0 <= res["answer_acc_at1"] <= res["answer_acc_at10"]
                <= 1):
            fail(f"solver eval result {sorted(res)}")
        print(f"[11] Solver eval over {len(ds)} ScanQA items of "
              f"{config.dataset.num_points} points ({batches} partial "
              f"batch): answer_acc_at1 {res['answer_acc_at1']}, "
              f"answer_acc_at10 {res['answer_acc_at10']}, answer_loss "
              f"{res['answer_loss']}, {sec * 1e3:.3f} ms, launches "
              f"{launches} ({self.smi})")
        return launches, {k: res[k] for k in (
            "answer_acc_at1", "answer_acc_at10", "answer_loss")}

    # -- (d) untimed: the HTTP requests and their references -------------

    def http_refs(self):
        import base64

        import numpy as np

        from vlp3d_torch.serving import STREAM_KEYS

        rng = np.random.default_rng(12)
        svc = self.services["answer"]
        c = 3 + self.config.model.input_feature_dim
        words = ["what", "color", "is", "the", "chair", "where", "table",
                 "how", "many", "beds"]
        self.reqs, self.refs = [], []
        for i in range(VQA_HTTP_REQUESTS):
            pc = rng.uniform(0, 4, (N, c)).astype(np.float32)
            req = {"point_cloud": {"b64": base64.b64encode(
                pc.astype("<f4").tobytes()).decode(), "shape": list(pc.shape)},
                "queries": [" ".join(rng.choice(words, 5)) for _ in range(
                    min(1 + 2 * i, self.config.model.lang_num_max))]}
            self.reqs.append(req)
            item, _ = svc._make_item(req)
            ref = svc._pred.run_padded({k: np.asarray(item[k])[None]
                                        for k in STREAM_KEYS})
            self.refs.append({k: v[0] for k, v in ref.items()})
        self.ground_req = dict(self.reqs[0], queries=["the chair"])
        self.bodies = [json.dumps(r).encode() for r in self.reqs]

    # -- the timed main paths, with the card to itself -------------------

    def drive(self, torch):
        """(a), (b) and (d) with every count at 0 before each; returns
        ({path: launch counts}, numbers for the results line)."""
        launches, numbers = {"answer_eval": self.eval_launches}, {
            "eval": self.eval_result, "step_check": self.step_numbers}
        try:
            launches["answer_serve"], numbers["serve"] = self.serve(torch)
            launches["answer_step"], numbers["step"] = self.steps(torch)
            launches["answer_http"], numbers["http"] = self.http(torch)
        finally:
            self.stop()
        return launches, numbers

    def serve(self, torch):
        import numpy as np

        from vlp3d_torch import ops

        pred, cfg = self.pred, self.config.model
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = pred([self.scenes[1]])[0]  # the entry point a user calls
        call_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ops.launches)
        peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        if launches != PER_FORWARD:
            fail(f"answer serving launches {launches} != {PER_FORWARD}")
        ids, top = res["answer_top_ids"], res["answer_top_scores"]
        if ids.shape != (B, cfg.lang_num_max, VQA_TOPK) or ids.min() < 0 \
                or ids.max() >= cfg.num_answers \
                or not np.isfinite(res["answer_scores"]).all() \
                or (np.diff(top, axis=-1) > 0).any():
            fail(f"answer predictions {ids.shape} {ids.min()} {ids.max()}")
        dev = pred._to_device(self.scenes[2])
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.predict(dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        fwd = float(np.median(times))
        print(f"[11] answer serving at B={B}, N={N}: "
              f"{B * cfg.lang_num_max} questions, top-{VQA_TOPK} of "
              f"{cfg.num_answers}; the whole call {call_ms:.3f} ms (host "
              f"batch to host answers, peak {peak:.3f} GiB above the "
              f"resident models), forward + top-{VQA_TOPK} median of 3 "
              f"{fwd:.3f} ms (batch on the card; {times}); launches "
              f"{launches} ({self.smi})")
        stamp("11", "answer serving")
        return launches, {"call_ms": call_ms, "forward_ms": fwd,
                          "peak_gib": peak, "excused": self.excused}

    def steps(self, torch):
        import numpy as np

        from vlp3d_torch import ops

        model, step, batch = self.step
        gen = torch.Generator(device=batch["point_clouds"].device)
        gen.manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        total = {k: 0 for k in PER_STEP}
        ms, history = [], []
        for _ in range(VQA_STEPS):
            ops.reset_launches()
            t0 = time.perf_counter()
            history.append(step(batch, gen))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            one = dict(ops.launches)
            if one != PER_STEP:
                fail(f"VQA step launches {one} != {PER_STEP}")
            total = {k: total[k] + one[k] for k in total}
        peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        history = [{k: v.item() for k, v in m.items()} for m in history]
        for m in history:
            if "answer_loss" not in m or not all(
                    np.isfinite(v) for v in m.values()):
                fail(f"VQA step metrics {m}")
        print(f"[11] VQA-recipe train step (Adam, coupled L2, one group, "
              f"clip 1.0) at B={B}, N={N}: ms {ms} (host clock to a "
              f"synchronise), peak {peak:.3f} GiB above the resident "
              f"models, optimizer and batch; launches a step {one}; "
              + json.dumps({k: [round(m[k], 5) for m in history]
                            for k in ("loss", "answer_loss", "vote_loss")})
              + f" ({self.smi})")
        self.step = None
        torch.cuda.empty_cache()
        stamp("11", "VQA train steps")
        return total, {"ms": ms, "peak_gib": peak}

    def http(self, torch):
        import threading
        import urllib.request

        import numpy as np

        from vlp3d_torch import ops

        svc = self.services["answer"]
        port = self.server.server_address[1]
        answers = [None] * len(self.bodies)

        def call(i):
            answers[i] = _post(port, "/v1/answer", self.bodies[i])

        torch.cuda.synchronize()
        ops.reset_launches()
        before = {t: s.stats()["device_batches"]
                  for t, s in self.services.items()}
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(self.bodies))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        ground = _post(port, "/v1/ground",
                       json.dumps(self.ground_req).encode())
        for t in threads:
            t.join(timeout=600)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ops.launches)
        batches = {t: s.stats()["device_batches"] - before[t]
                   for t, s in self.services.items()}
        codes = [a[0] if a else None for a in answers] + [ground[0]]
        print(f"[11] {len(self.bodies)} concurrent /v1/answer requests "
              f"(b64 clouds of {N} x {3 + self.config.model.input_feature_dim}"
              f", {[len(r['queries']) for r in self.reqs]} questions) and one "
              f"/v1/ground "
              f"in {wall_ms:.3f} ms: codes {codes}, device batches "
              f"{batches}, launches {launches}")
        if codes != [200] * len(codes):
            fail(f"answer HTTP requests failed: {codes}")
        n_batches = sum(batches.values())
        if launches != {k: n_batches * v for k, v in PER_FORWARD.items()}:
            fail(f"answer HTTP launches {launches} over {n_batches} batches")
        excused, worst = 0, 0.0
        for (code, ans), req, ref in zip(answers, self.reqs, self.refs):
            n = len(req["queries"])
            if len(ans["answers"]) != n:
                fail(f"{len(ans['answers'])} answer lists for {n} questions")
            got = torch.as_tensor([[a["answer_id"] for a in q]
                                   for q in ans["answers"]])
            want = torch.as_tensor(ref["answer_top_ids"][:n])
            excused += tie_rule(
                want, got, ids_margin(want, got, torch.as_tensor(
                    ref["answer_scores"][:n])),
                "an HTTP answer against the predictor alone", "11")
            scores = np.asarray([[a["score"] for a in q]
                                 for q in ans["answers"]])
            same = (got == want).all(dim=1).numpy()
            worst = max(worst, float(np.abs(
                scores[same] - ref["answer_top_scores"][:n][same]).max(
                    initial=0.0)))
        scale = float(np.abs(self.refs[0]["answer_scores"]).max())
        if worst > VQA_SCORE_TOL * scale:
            fail(f"HTTP answer logits differ from the predictor's by {worst}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=60) as r:
            stats = json.loads(r.read())
        print(f"[11] HTTP answers equal the predictor's alone ({excused} "
              f"rows excused), logits within {worst}; answer device-batch "
              f"ms {stats['answer']['batch_ms']}, request ms "
              f"{stats['answer']['latency_ms']} ({self.smi})")
        stamp("11", "answer HTTP")
        return launches, {"wall_ms": wall_ms, "batches": batches,
                          "excused": excused,
                          "latency_ms": stats["answer"]["latency_ms"]}

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        for s in self.services.values():
            s.close()
        self.thread.join(timeout=30)


# ---------------------------------------------------------------- phase 12


def nudge(torch, model):
    """Phase 6's nudges to seeded weights (votes stay near their seeds,
    boxes start ~0.7 m wide, so that every loss is live), with the box
    predictor's weights scaled as the vote offsets' are: the seeded
    weights of a model with other modules draw other box weights, and
    unscaled they gave boxes of up to ~740 m, whose relation-attention
    logits of ~1e5 carry float32 rounding (C3's interpolation order) into
    the attention weights."""
    with torch.no_grad():
        model.vgen.conv3.weight.mul_(0.05)
        model.vgen.conv3.bias.mul_(0.05)
        model.proposal.proposal.box_predictor.weight.mul_(0.05)
        model.proposal.proposal.box_predictor.bias.fill_(-1.0)


def median_ms(torch, fn, reps: int = 5):
    """Median host-clock ms of fn() to a synchronise, and the peak memory
    (GiB) above what was allocated before."""
    import numpy as np

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
    return float(np.median(times)), peak


class FlagsPhase:
    """Phase 12 in this process: the grounding model's options at run.sh's
    widths. The models, the untimed checks (kernel against plain ops) and
    the detection-only Solver epochs run while the CLI processes run;
    :meth:`drive` then times the paths with the card to itself."""

    def __init__(self, torch, smi, scenes, ground_state, train_host):
        from vlp3d_torch.config import Config, ModelConfig
        from vlp3d_torch.models import JointNet
        from vlp3d_torch.serving import GroundingPredictor
        from vlp3d_torch.train import batch_to_device

        self.smi, self.scenes = smi, scenes
        t0 = time.perf_counter()
        # (a) every option of the grounding model at once
        self.config = Config(model=ModelConfig(
            use_con=True, no_caption=True, **FLAG_OPTIONS))
        self.model = JointNet(self.config)
        nudge(torch, self.model)
        cfg = self.config.model
        layers = len(self.model.lang.text_encoder.bert.encoder.layer)
        widths = (cfg.input_feature_dim, tuple(cfg.sa_npoints),
                  cfg.num_proposal, layers, cfg.lang_num_max)
        if widths != FLAG_WIDTHS:
            fail(f"option model is not at run.sh's widths: {widths}")
        device = next(self.model.parameters()).device
        self.batch = batch_to_device(train_host, device)
        print(f"[12] option model ({sorted(FLAG_OPTIONS)}) built in "
              f"{time.perf_counter() - t0:.1f} s")
        self.forward_check = self.check_forward(torch)
        self.step_check = check_kernel_step(
            torch, "12", self.model, self.config, self.batch, FLAG_PROBE,
            "every-option step")[:2]
        # (b) compute_dtype="bfloat16": phase 5's serving model, phase 6's
        # step
        t0 = time.perf_counter()
        self.preds = {}
        for dtype in ("float32", "bfloat16"):
            pred = GroundingPredictor(Config(model=ModelConfig(
                use_con=False, no_caption=True, compute_dtype=dtype)),
                ground_state, batch_size=B)
            self.preds[dtype] = pred
        self.train_models = {}
        for dtype in ("float32", "bfloat16"):
            config = Config(model=ModelConfig(use_con=True, no_caption=True,
                                              compute_dtype=dtype))
            model = JointNet(config)
            nudge(torch, model)  # phase 6's weights
            self.train_models[dtype] = (config, model)
        print(f"[12] float32 and bfloat16 serving and train models built in "
              f"{time.perf_counter() - t0:.1f} s")
        self.bf16_check = self.check_bf16(torch)
        # (c) detection-only training, untimed
        self.solvers = self.detection_only(torch)
        stamp("12", "option models, untimed checks and detection-only "
              "solvers")

    # -- (a) untimed: the kernel forward against the plain ops ------------

    def check_forward(self, torch):
        """The evaluation forward with every option: indices equal to the
        plain-op forward's, the reference read's rows too (a pure
        gather), cluster_ref within CLUSTER_REF_TOL."""
        model, rows = self.model, []
        hook = model.relation.obj_embedding[0].register_forward_pre_hook(
            lambda mod, args: rows.append(args[0].detach().clone()) and None)
        try:
            got = model(self.batch)
            with plain_ops():
                want = model(self.batch)
        finally:
            hook.remove()
        idx = {k: index_err(torch, got[k], want[k]) for k in (
            "sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds")}
        gather = float((rows[0] - rows[1]).abs().max())
        err = float((got["cluster_ref"] - want["cluster_ref"]).abs().max())
        print(f"[12] every-option forward, kernels against plain ops on the "
              f"card: index differences {idx}, the reference read's rows "
              f"{tuple(rows[0].shape)} differ by {gather}, cluster_ref max "
              f"abs err {err}")
        if any(idx.values()) or gather != 0.0 or err > CLUSTER_REF_TOL:
            fail("the every-option forward differs from the plain-op one")
        for k in ("vote_weights", "alpha", "pred_center_reg",
                  "pred_size_reg"):
            if not bool(torch.isfinite(got[k]).all()):
                fail(f"non-finite {k}")
        return {"index_err": max(idx.values()), "gather_err": gather,
                "cluster_ref_err": err}

    # -- (b) untimed: bfloat16 against the plain ops -----------------------

    def check_bf16(self, torch):
        """The bfloat16 serving forward against the plain-op forward
        (pred_ref equal, cluster_ref within CLUSTER_REF_TOL), and the
        bfloat16 train step against the plain-op step (check_kernel_step).
        """
        import numpy as np

        pred = self.preds["bfloat16"]
        got = pred([self.scenes[0]])[0]
        with plain_ops():
            want = pred([self.scenes[0]])[0]
        err = float(np.abs(got["cluster_ref"] - want["cluster_ref"]).max())
        same = bool(np.array_equal(got["pred_ref"], want["pred_ref"]))
        print(f"[12] bfloat16 serving forward, kernels against plain ops on "
              f"the card: pred_ref equal {same}, cluster_ref max abs err "
              f"{err}")
        if not same or err > CLUSTER_REF_TOL:
            fail("the bfloat16 forward differs from the plain-op one")
        config, model = self.train_models["bfloat16"]
        loss_rel, worst, moved = check_kernel_step(
            torch, "12", model, config, self.batch, BF16_PROBE,
            "bfloat16 step", take_all=True, grad_tol=BF16_STEP_GRAD_TOL)
        return {"cluster_ref_err": err, "step_loss_rel": loss_rel,
                "step_grad_err": worst, "flips": moved}

    # -- (c) untimed: detection-only training -----------------------------

    def detection_only(self, torch):
        """Solver(reference=False) over a no_reference model and
        Solver(detection=False) over phase 6's, one synthetic epoch each
        at run.sh's widths: every logged loss finite, the launches of each
        step and eval batch counted."""
        import tempfile

        import numpy as np

        from vlp3d_torch import ops
        from vlp3d_torch.config import Config, ModelConfig
        from vlp3d_torch.data.synthetic import make_synthetic_dataset
        from vlp3d_torch.train.solver import Solver

        out = {}
        for name, flags, kw in (
                ("reference", {"no_reference": True}, {"reference": False}),
                ("detection", {}, {"detection": False})):
            config = Config(model=ModelConfig(use_con=True, no_caption=True,
                                              **flags))
            train = make_synthetic_dataset(
                config, n_scenes=B, n_points=PREDICT_POINTS,
                anns_per_scene=config.model.lang_num_max, augment=True,
                shuffle=True, seed=5)
            val = make_synthetic_dataset(
                config, n_scenes=2, n_points=PREDICT_POINTS,
                anns_per_scene=config.model.lang_num_max, split="val",
                seed=6)
            with tempfile.TemporaryDirectory() as tmp:
                solver = Solver(config, train, val, tmp, log_every=1, **kw)
                solver.init_state()
                nudge(torch, solver.model)
                ops.reset_launches()
                t0 = time.perf_counter()
                best = solver(1)
                sec = time.perf_counter() - t0
                launches = dict(ops.launches)
                solver.close()
                with open(os.path.join(tmp, "log.jsonl")) as f:
                    records = [json.loads(r) for r in f]
                del solver
            torch.cuda.empty_cache()
            steps = len(train) // config.train.batch_size
            evals = -(-len(val) // config.train.batch_size)
            want = {k: steps * PER_STEP[k] + evals * PER_FORWARD[k]
                    for k in PER_STEP}
            logged = [r for r in records if r["phase"] in ("train", "val")]
            losses = {r["phase"]: r["loss"] for r in logged}
            if launches != want or len(logged) != steps + 1 or not all(
                    np.isfinite(v) for r in logged for v in r.values()
                    if isinstance(v, float)):
                fail(f"Solver({kw}): launches {launches} (want {want}), "
                     f"records {logged}")
            print(f"[12] Solver({kw}) one epoch ({steps} step, {evals} eval "
                  f"batch) in {sec:.1f} s: loss {losses}, best epoch "
                  f"{best['epoch']}, launches {launches}")
            out[name] = (launches, {"s": sec, "loss": losses})
        return out

    # -- the timed paths, with the card to itself --------------------------

    def drive(self, torch):
        """(a) and (b) timed, with every count at 0 before each; returns
        ({path: launch counts}, numbers for the results line)."""
        import numpy as np

        from vlp3d_torch import ops
        from vlp3d_torch.train import make_optimizer, make_train_step
        from vlp3d_torch.train.schedules import cosine_lr

        launches, numbers = {}, {"forward_check": self.forward_check,
                                 "step_check": self.step_check,
                                 "bf16_check": self.bf16_check}
        for name, (counts, res) in self.solvers.items():
            launches[f"flags_solver_{name}"] = counts
            numbers[f"solver_{name}"] = res

        def counted(path, fn, per, reps=5):
            ops.reset_launches()
            fn()
            torch.cuda.synchronize()
            one = dict(ops.launches)
            if one != per:
                fail(f"{path}: launches {one} != {per}")
            ms, peak = median_ms(torch, fn, reps)
            launches[path] = dict(ops.launches)
            return ms, peak

        def stepper(config, model):
            opt = make_optimizer(
                model, lr_schedule=lambda e, lr0: cosine_lr(e, lr0, 200),
                steps_per_epoch=100)
            step = make_train_step(model, config, opt)
            gen = torch.Generator(device=self.batch["point_clouds"].device)
            gen.manual_seed(0)
            history = []
            return lambda: history.append(step(self.batch, gen)), history

        # (a) every option: forward, step, the reference read's copy
        fwd_ms, fwd_peak = counted(
            "flags_forward", lambda: self.model(self.batch), PER_FORWARD)
        run, history = stepper(self.config, self.model)
        step_ms, step_peak = counted("flags_step", run, PER_STEP)
        for m in history:
            for k in ("loss", "kl_loss", "vote_weight_loss", "diou_loss"):
                if not np.isfinite(m[k].item()):
                    fail(f"every-option step: {k} = {m[k].item()}")
        off, c = self.config.model.multiview_offset, \
            self.config.model.multiview_dim
        obj = self.batch["point_clouds"][..., off:off + c]
        copy_ms = cuda_ms(torch, lambda: obj.transpose(1, 2).contiguous(),
                          reps=20)
        copy_bytes = 2 * obj.numel() * 4
        print(f"[12] every-option model at B={B}, N={N}: evaluation forward "
              f"median {fwd_ms:.3f} ms (peak {fwd_peak:.3f} GiB above the "
              f"resident models), train step median {step_ms:.3f} ms (peak "
              f"{step_peak:.3f} GiB); the reference read's (B, C, N) copy of "
              f"{obj.numel() * 4 / 1e6:.1f} MB {copy_ms:.4f} ms "
              f"({copy_bytes / copy_ms / 1e6:.1f} GB/s read + write; bound "
              f"{bound_ms(copy_bytes, 0)[0]:.4f} ms); "
              f"launches a forward {PER_FORWARD}, a step {PER_STEP}; losses "
              + json.dumps({k: [round(m[k].item(), 5) for m in history]
                            for k in ("loss", "kl_loss", "vote_weight_loss")})
              + f" ({self.smi})")
        numbers["flags"] = {"forward_ms": fwd_ms, "forward_peak_gib":
                            fwd_peak, "step_ms": step_ms, "step_peak_gib":
                            step_peak, "obj_copy_ms": copy_ms,
                            "obj_copy_bound_ms": bound_ms(copy_bytes, 0)[0]}
        self.model = None
        torch.cuda.empty_cache()

        # (b) bfloat16 beside float32, in this run
        res = {}
        outs = {}
        for dtype, pred in self.preds.items():
            dev = pred._to_device(self.scenes[1])
            fwd, fpeak = counted(f"{dtype}_forward",
                                 lambda: pred.predict(dev), PER_FORWARD)
            outs[dtype] = {k: v.cpu().numpy()
                           for k, v in pred.predict(dev).items()}
            config, model = self.train_models[dtype]
            run, history = stepper(config, model)
            stp, speak = counted(f"{dtype}_step", run, PER_STEP)
            res[dtype] = {"forward_ms": fwd, "forward_peak_gib": fpeak,
                          "step_ms": stp, "step_peak_gib": speak,
                          "loss": [m["loss"].item() for m in history]}
            self.train_models[dtype] = None
            torch.cuda.empty_cache()
        diff = float(np.abs(outs["bfloat16"]["cluster_ref"]
                            - outs["float32"]["cluster_ref"]).max())
        agree = float((outs["bfloat16"]["pred_ref"]
                       == outs["float32"]["pred_ref"]).mean())
        print(f"[12] compute_dtype at B={B}, N={N}: "
              + json.dumps(res) + f"; bfloat16 against float32: cluster_ref"
              f" max abs difference {diff}, pred_ref agreement {agree} "
              f"({self.smi})")
        for dtype in res:
            if not np.isfinite(res[dtype]["loss"]).all():
                fail(f"{dtype} step losses {res[dtype]['loss']}")
        numbers["compute_dtype"] = dict(res, cluster_ref_diff=diff,
                                        pred_ref_agreement=agree)
        self.preds = None
        torch.cuda.empty_cache()
        stamp("12", "option and compute-dtype paths")
        return launches, numbers


class TaskClis(CliProcesses):
    """Phase 15's three single-task trainers as processes on the card,
    started beside phase 8's: train_scanqa, train_3djcg_g and
    train_3djcg_c at full width with --synthetic --epoch 1 (TASK_CLIS)."""

    def start(self):
        for module, (flags, _, _, _) in TASK_CLIS.items():
            self.launch(module, [
                "--synthetic", "--epoch", "1", "--num_workers", "2",
                "--output_dir", os.path.join(self.tmp.name, module), *flags])
        stamp("15", "train_scanqa, train_3djcg_g and train_3djcg_c CLIs "
              "started")

    def check(self):
        """Each exits 0, prints its val metric, logs finite losses and
        writes best.json and its best and last snapshots."""
        import glob

        import numpy as np

        numbers = {}
        for module, (text, sec) in self.ended().items():
            flags, loss_key, val_key, snapshot = TASK_CLIS[module]
            runs = glob.glob(os.path.join(self.tmp.name, module, "*"))
            if len(runs) != 1:
                fail(f"{module} left run directories {runs}")
            with open(os.path.join(runs[0], "log.jsonl")) as f:
                records = [json.loads(r) for r in f]
            train = [r for r in records if r["phase"] == "train"]
            val = [r for r in records if r["phase"] == "val"]
            printed = [ln for ln in text.splitlines()
                       if ln.startswith("epoch 0:")]
            if not train or loss_key not in train[0] or not val \
                    or val_key not in val[0] or not printed or not all(
                        np.isfinite(v) for r in records for v in r.values()
                        if isinstance(v, float)):
                fail(f"{module}: train {train}, val {val}, printed "
                     f"{printed}")
            for name in ("best.json", f"{snapshot}.pth", "model_last.pth"):
                if not os.path.exists(os.path.join(runs[0], name)):
                    fail(f"{module} left no {name}")
            print(f"[15] python -m vlp3d_torch.cli.{module} --synthetic "
                  f"--epoch 1 {' '.join(flags)}: exit 0 in {sec:.1f} s; "
                  f"{printed[0]!r}; loss {train[0]['loss']}, {loss_key} "
                  f"{train[0][loss_key]}")
            numbers[module] = {"s": sec, "loss": train[0]["loss"],
                               val_key: val[0][val_key]}
        return numbers


class TaskPipelinesPhase:
    """Phase 15 in this process: ScanQA with MCAN, RefNet and CapNet (with
    num_locals -1 and 10) at their trainers' full widths. The models, the
    evaluation forwards against the plain ops and the kernel steps against
    the plain-op steps (untimed) run while the CLI processes run;
    :meth:`drive` then counts the launches of a forward and a step and
    times them with the card to itself."""

    def __init__(self, torch, smi):
        self.smi = smi
        t0 = time.perf_counter()
        self.cases = {}
        for name in TASK_PROBES:
            self.cases[name] = getattr(self, f"_{name.split('_')[0]}")(
                torch, name)
        stamp("15", f"task models built in {time.perf_counter() - t0:.1f} s")
        self.checks = {}
        for name, case in self.cases.items():
            fwd = self.check_forward(torch, name, case)
            step = check_kernel_step(
                torch, "15", case["model"], case["config"], case["batch"],
                TASK_PROBES[name], f"{name} step", loss_fn=case["loss_fn"],
                follow_ties=True)
            self.checks[name] = {"forward": fwd, "step": {
                "loss_rel": step[0], "grad_err": step[1], "flips": step[2]}}
        stamp("15", "task models' untimed checks")

    # -- the models and batches -------------------------------------------

    def _task_batch(self, torch, config, seed, extra):
        import numpy as np

        from vlp3d_torch.data.synthetic import make_batch
        from vlp3d_torch.train import batch_to_device

        host = make_batch(config, batch_size=B, num_points=N_TASK, seed=seed)
        host.update(extra(np.random.default_rng(seed), host))
        return batch_to_device(host, torch.device("cuda"))

    def _scanqa(self, torch, name):
        import numpy as np

        from vlp3d_torch.cli.train_scanqa import (
            RENAMES,
            build_parser,
            vqa_optimizer,
        )
        from vlp3d_torch.config import Config, DatasetConfig, ModelConfig
        from vlp3d_torch.losses.vqa import compute_vqa_loss
        from vlp3d_torch.models.scanqa import ScanQA

        # train_scanqa's own configuration
        config = Config(dataset=DatasetConfig(num_points=N_TASK),
                        model=ModelConfig())
        answers = SCANQA_ANSWERS
        model = ScanQA(config, answers)
        with torch.no_grad():  # votes near their seeds, small box offsets
            model.voting_net.conv3.weight.mul_(0.05)
            model.voting_net.conv3.bias.mul_(0.05)
            model.proposal_net.conv3.weight[2:5].mul_(0.05)
        b = B

        def extra(rng, host):
            host["point_clouds"][0] = 0.0  # scene 0: every proposal alike
            lens = rng.integers(1, GLOVE_T + 1, b).astype(np.int32)
            lens[:2] = (1, GLOVE_T)
            out = {"lang_feat": rng.normal(size=(b, GLOVE_T, 300)).astype(
                np.float32), "lang_len": lens}
            out.update({dst: host[src][:, 0] for src, dst in RENAMES.items()
                        if src in host})
            cats = np.zeros((b, answers), np.float32)
            for i in range(b):
                cats[i, rng.choice(answers, 1 + i % 3, replace=False)] = 1.0
            out.update(answer_cats=cats, answer_cat_scores=cats * rng.choice(
                [0.3, 0.6, 0.9, 1.0], size=cats.shape).astype(np.float32),
                answer_cat=np.argmax(cats, -1).astype(np.int32))
            return out

        batch = self._task_batch(torch, config, 15, extra)
        # scene 0's proposals (one point repeated) are alike: make them
        # all non-objects and about half of the others' objects, so that
        # MCAN masks every key of scene 0 and some of the others'
        scores = model(batch)["objectness_scores"]
        diff = scores[..., 0] - scores[..., 1]  # > 0: not an object
        if not bool((diff[0] == diff[0, 0]).all()):
            fail(f"scanqa: scene 0's proposals differ: {diff[0]}")
        head = model.proposal_net.conv3
        with torch.no_grad():
            if bool(diff[0, 0] <= diff[1:].median()):
                for t in (head.weight, head.bias):  # swap the two logits
                    t[0:2] = t[0:2].flip(0).clone()
                diff = -diff
            d0 = float(diff[0, 0])
            head.bias[1] += d0 - max(1e-2, 0.05 * abs(d0))
        masks = model(batch)["objectness_masks"]
        if bool(masks[0].any()) or not bool(masks[1:].any()):
            fail(f"scanqa: objectness masks {masks.sum(1).tolist()}")
        mean = torch.as_tensor(config.dataset.mean_size_arr(),
                               device=batch["point_clouds"].device)
        return {"config": config, "model": model, "batch": batch,
                "loss_fn": lambda o, bt: compute_vqa_loss(o, bt, mean),
                "optimizer": lambda: vqa_optimizer(
                    model, build_parser().parse_args([]), 1),
                "objects": masks.sum(1).tolist()}

    def _refnet(self, torch, name):
        import numpy as np

        from vlp3d_torch.cli.train_3djcg_g import adamw_one_group
        from vlp3d_torch.config import Config, DatasetConfig, ModelConfig
        from vlp3d_torch.losses.joint import compute_joint_loss
        from vlp3d_torch.models.refnet import RefNet

        # train_3djcg_g's configuration
        config = Config(dataset=DatasetConfig(num_points=N_TASK),
                        model=ModelConfig(lang_num_max=8, no_caption=True,
                                          use_con=False, use_mlm=False))
        model = RefNet(config)
        nudge(torch, model)
        b, l = B, config.model.lang_num_max

        def extra(rng, host):
            lens = rng.integers(1, GLOVE_T + 1, (b, l)).astype(np.int32)
            lens[0, :2] = (1, GLOVE_T)
            return {"lang_feat": rng.normal(size=(b, l, GLOVE_T, 300))
                    .astype(np.float32), "lang_len": lens}

        batch = self._task_batch(torch, config, 16, extra)
        return {"config": config, "model": model, "batch": batch,
                "loss_fn": lambda o, bt: compute_joint_loss(config, o, bt),
                "optimizer": lambda: adamw_one_group(model, 2e-3, 1e-3)}

    def _capnet(self, torch, name):
        import numpy as np

        from vlp3d_torch.cli.train_3djcg_c import caption_losses
        from vlp3d_torch.cli.train_3djcg_g import adamw_one_group
        from vlp3d_torch.config import Config, DatasetConfig, ModelConfig
        from vlp3d_torch.models.capnet import CapNet

        # train_3djcg_c's configuration
        config = Config(dataset=DatasetConfig(num_points=N_TASK),
                        model=ModelConfig(lang_num_max=8, no_caption=True,
                                          use_con=False, use_mlm=False,
                                          no_reference=True))
        vocab = CAPNET_VOCAB
        locals_ = CAPNET_LOCALS if name.endswith("locals") else -1
        model = CapNet(config, vocab, num_locals=locals_)
        nudge(torch, model)
        b, l, t = B, config.model.lang_num_max, CAPTION_T

        def extra(rng, host):
            ids = rng.integers(4, vocab, (b, l, t))
            lens = rng.integers(3, t + 1, (b, l))
            ids[..., 0] = 2  # sos
            for i in range(b):
                for j in range(l):
                    ids[i, j, lens[i, j] - 1] = 3  # eos
                    ids[i, j, lens[i, j]:] = 0
            return {"lang_feat": rng.normal(size=(b, l, t, 300)).astype(
                np.float32), "lang_ids": ids.astype(np.int64)}

        batch = self._task_batch(torch, config, 17, extra)
        return {"config": config, "model": model, "batch": batch,
                "loss_fn": lambda o, bt: caption_losses(config, o, bt),
                "optimizer": lambda: adamw_one_group(model, 1e-3, 1e-5),
                "num_locals": locals_}

    # -- untimed: the evaluation forward against the plain ops ------------

    def check_forward(self, torch, name, case):
        """The evaluation forward against the plain-op forward: sampled
        indices equal; the task's output within CLUSTER_REF_TOL (of
        max(1, its largest entry)); its ids (top-10 answers, the chosen
        proposal, each caption word) equal or excused by the tie rule."""
        from vlp3d_torch.models.caption import top_k_first

        model, batch = case["model"], case["batch"]
        got = model(batch)
        with plain_ops():
            want = model(batch)
        idx = {k: index_err(torch, got[k], want[k]) for k in (
            "sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds")}
        key = TASK_OUTPUT[name.split("_")[0]]
        scale = max(1.0, float(want[key].abs().max()))
        err = float((got[key] - want[key]).abs().max()) / scale
        if key == "answer_scores":
            k = min(VQA_TOPK, want[key].shape[1])
            ids_p = top_k_first(want[key], k)[1]
            ids_k = top_k_first(got[key], k)[1]
            margin = ids_margin(ids_p, ids_k, want[key])
        elif key == "cluster_ref":
            pick_p = (want[key].reshape(batch["lang_feat"].shape[:2] + (-1,))
                      * want["objectness_masks"][:, None])
            pick_k = (got[key].reshape(pick_p.shape)
                      * got["objectness_masks"][:, None])
            pick_p, pick_k = (p.reshape(-1, p.shape[-1])
                              for p in (pick_p, pick_k))
            ids_p = torch.argmax(pick_p, -1)[:, None]
            ids_k = torch.argmax(pick_k, -1)[:, None]
            margin = ids_margin(ids_p, ids_k, pick_p)
        else:  # lang_cap (N, T - 1, vocab): each caption's greedy words
            ids_p = torch.argmax(want[key], -1)
            ids_k = torch.argmax(got[key], -1)
            margin = (lambda r, j, lg=want[key]:
                      top2_margin(torch, lg[r, j]))
        excused = tie_rule(ids_p, ids_k, margin, f"{name} {key} ids, "
                           "kernels against plain ops", "15")
        print(f"[15] {name} evaluation forward, kernels against plain ops "
              f"on the card: index differences {idx}, {key} "
              f"{tuple(want[key].shape)} within {err} of max(1, its largest"
              f" entry {scale})" + (f"; proposals that are objects a scene "
                                    f"{case['objects']}" if "objects" in
                                    case else ""))
        if any(idx.values()) or err > CLUSTER_REF_TOL:
            fail(f"the {name} forward differs from the plain-op one")
        return {"index_err": max(idx.values()), "err": err,
                "excused": excused}

    # -- the timed paths, with the card to itself -------------------------

    def drive(self, torch):
        """Each model's evaluation forward and train step (its trainer's
        optimizer), every count at 0 before each: one forward's and one
        step's launches held to TASK_FORWARD / TASK_STEP, then the median
        ms of TASK_STEPS and the peak memory above the resident models.
        Returns ({path: launch counts}, numbers)."""
        import numpy as np

        from vlp3d_torch import ops
        from vlp3d_torch.models.layers import set_dropout_generator
        from vlp3d_torch.train.state import backward_and_step

        launches, numbers = {}, {}
        for name, case in self.cases.items():
            model, batch = case["model"], case["batch"]
            kind = name.split("_")[0]
            opt = case["optimizer"]()
            gen = torch.Generator(device=batch["point_clouds"].device)
            gen.manual_seed(0)
            set_dropout_generator(model, gen)
            history = []

            def step():
                loss, m = case["loss_fn"](model(batch, train=True), batch)
                backward_and_step(loss, opt)
                history.append(m["loss"].detach())

            res = {}
            for path, fn, per in (
                    ("forward", lambda: model(batch), TASK_FORWARD[kind]),
                    ("step", step, TASK_STEP[kind])):
                ops.reset_launches()
                fn()
                torch.cuda.synchronize()
                one = dict(ops.launches)
                if one != per:
                    fail(f"{name} {path}: launches {one} != {per}")
                ms, peak = median_ms(torch, fn, TASK_STEPS)
                launches[f"{name}_{path}"] = one
                res[f"{path}_ms"], res[f"{path}_peak_gib"] = ms, peak
            losses = [float(v) for v in history]
            if not np.isfinite(losses).all():
                fail(f"{name} step losses {losses}")
            res["loss"] = losses
            res.update(self.checks[name])
            print(f"[15] {name} at B={B}, N={N_TASK}: evaluation forward "
                  f"median {res['forward_ms']:.3f} ms of {TASK_STEPS} (peak "
                  f"{res['forward_peak_gib']:.3f} GiB above the resident "
                  f"models), train step median {res['step_ms']:.3f} ms "
                  f"(peak {res['step_peak_gib']:.3f} GiB); launches a "
                  f"forward {launches[name + '_forward']}, a step "
                  f"{launches[name + '_step']}; loss "
                  f"{[round(v, 5) for v in losses]} ({self.smi})")
            numbers[name] = res
            self.cases[name] = None
            del model, batch, case, opt
            torch.cuda.empty_cache()
        stamp("15", "task paths")
        return launches, numbers


# ---------------------------------------------------------------- phase 16


def write_multiview_frames(root: str):
    """compute_multiview's inputs (MULTIVIEW) under ``root``: a frames
    folder a scene (uint8 RGB, depth 2 m, camera-to-world poses near the
    identity) and ``<scene>_aligned_vert.npy`` with points on the z = 2
    plane in front of the camera, a tenth of them behind it. Returns
    (frames_dir, scannet_dir, the camera flags: ScanNet's depth-camera
    field of view at 328 x 256)."""
    import numpy as np

    mv = MULTIVIEW
    h, w, n = mv["h"], mv["w"], mv["points"]
    rng = np.random.default_rng(16)
    frames = os.path.join(root, "frames")
    data = os.path.join(root, "scannet")
    os.makedirs(data)
    for s in range(mv["scenes"]):
        scene = f"scene{s:04d}_00"
        sdir = os.path.join(frames, scene)
        for sub in ("color", "depth", "pose"):
            os.makedirs(os.path.join(sdir, sub))
        for f in range(mv["frames"]):
            np.save(os.path.join(sdir, "color", f"{f:04d}.npy"),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            np.save(os.path.join(sdir, "depth", f"{f:04d}.npy"),
                    np.full((h, w), 2.0, np.float32))
            pose = np.eye(4)
            pose[:2, 3] = rng.normal(0.0, 0.05, 2)
            np.savetxt(os.path.join(sdir, "pose", f"{f:04d}.txt"), pose)
        pts = np.concatenate([rng.uniform(-1.2, 1.2, (n, 1)),
                              rng.uniform(-0.9, 0.9, (n, 1)),
                              np.full((n, 1), 2.0)], axis=1)
        pts[: n // 10, 2] = -2.0  # behind the camera: never seen
        np.save(os.path.join(data, f"{scene}_aligned_vert.npy"),
                np.concatenate([pts, rng.uniform(0, 1, (n, 3))],
                               axis=1).astype(np.float32))
    camera = ["--fx", "296", "--fy", "296", "--cx", "163.5", "--cy", "127.5"]
    return frames, data, camera


class VariantClis(CliProcesses):
    """Phase 16's processes, started beside phase 8's: ``train_3dvlp
    --synthetic --smoke --use_mlcv_net`` and ``compute_multiview`` over
    MULTIVIEW's synthetic frames (ENet on the card)."""

    def start(self):
        t0 = time.perf_counter()
        frames, data, camera = write_multiview_frames(self.tmp.name)
        self.frames_s = time.perf_counter() - t0
        self.workdir = os.path.join(self.tmp.name, "mlcv")
        self.out = os.path.join(self.tmp.name, "enet_feats_maxpool.hdf5")
        self.launch("train_3dvlp", [
            "--synthetic", "--smoke", "--use_mlcv_net", "--use_con",
            "--no_caption", "--num_workers", "2", "--workdir", self.workdir])
        self.launch("compute_multiview", [
            "--frames_dir", frames, "--scannet_data", data, "--out",
            self.out, *camera])
        stamp("16", f"multiview frames written in {self.frames_s:.1f} s; "
              "train_3dvlp --use_mlcv_net and compute_multiview CLIs started")

    def check(self):
        """train_3dvlp: exit 0, finite losses logged, a snapshot with the
        CGNL block; compute_multiview: exit 0, one (N, 128) float32
        dataset a scene, finite, the points behind the camera zero and
        most of the others seen."""
        import numpy as np

        from vlp3d_torch.data.hdf5 import read_datasets
        from vlp3d_torch.train import checkpoint

        ended = self.ended()
        with open(os.path.join(self.workdir, "log.jsonl")) as f:
            records = [json.loads(r) for r in f]
        train = [r for r in records if r["phase"] == "train"]
        sd = checkpoint.load_params(self.workdir, "model")
        if not train or not all(np.isfinite(v) for r in records
                                for v in r.values()
                                if isinstance(v, float)) \
                or "vgen.sa1.z.weight" not in sd:
            fail(f"train_3dvlp --use_mlcv_net: train records {train}, "
                 f"snapshot keys with vgen.sa1: "
                 f"{[k for k in sd if k.startswith('vgen.sa1')]}")
        mv = MULTIVIEW
        seen = {}
        written = read_datasets(self.out)
        if len(written) != mv["scenes"]:
            fail(f"compute_multiview wrote {sorted(written)}")
        for scene, arr in sorted(written.items()):
            if arr.shape != (mv["points"], 128) or arr.dtype != np.float32 \
                    or not np.isfinite(arr).all():
                fail(f"compute_multiview {scene}: {arr.shape} {arr.dtype}")
            rows = np.abs(arr).sum(1) > 0
            behind = mv["points"] // 10
            if rows[:behind].any() or rows[behind:].mean() < 0.5:
                fail(f"compute_multiview {scene}: {rows[:behind].sum()} "
                     f"points behind the camera seen, "
                     f"{rows[behind:].mean()} of the others")
            seen[scene] = float(rows.mean())
        numbers = {"train_3dvlp_s": ended["train_3dvlp"][1],
                   "compute_multiview_s": ended["compute_multiview"][1],
                   "frames_written_s": self.frames_s, "seen": seen}
        text = ended["compute_multiview"][0].strip().splitlines()
        print(f"[16] python -m vlp3d_torch.cli.train_3dvlp --synthetic "
              f"--smoke --use_mlcv_net: exit 0 in "
              f"{numbers['train_3dvlp_s']:.1f} s, loss "
              f"{[round(r['loss'], 5) for r in train]}; python -m "
              f"vlp3d_torch.cli.compute_multiview ({mv['scenes']} scenes x "
              f"{mv['frames']} frames of {mv['h']} x {mv['w']}, "
              f"{mv['points']} points a scene): exit 0 in "
              f"{numbers['compute_multiview_s']:.1f} s, {text}; the hdf5 "
              f"read back (vlp3d_torch.data.hdf5): (N, 128) float32 a scene, "
              f"share of points seen {seen}")
        return numbers


def detr_loss(out):
    """A scalar that reads every head of the DETR module's outputs (the
    CPU test's, tests/test_torch_detr_xbert.py)."""
    return ((out["detr_features"] ** 2).mean()
            + (out["pred_center"] ** 2).mean()
            + (out["transformer_weighted_xyz_all"] ** 2).mean()
            + (out["objectness_scores"]
               * out["sem_cls_scores"][..., :2]).mean()
            + (out["size_residuals"] ** 2).mean()
            + (out["heading_scores"] ** 2).mean())


def xbert_literal_decode(torch, model, feats):
    """The JAX package's greedy decode on the port's modules: at each step
    the whole max_len + 2 sequence through the decoder (padding mask
    arange <= i + 1), the LM head at step i + 1. Returns (ids (B * K,
    max_len + 1), the top-2 logit margin of each row at each step)."""
    from vlp3d_torch.models.caption_xbert import CLS_ID

    b, k, h = feats.shape
    n, tmax = b * k, model.max_len + 1
    ext = feats.repeat_interleave(k, dim=0)
    target = feats.reshape(n, 1, h)
    ids = torch.zeros(n, tmax, dtype=torch.long, device=feats.device)
    ids[:, 0] = CLS_ID
    margins = torch.zeros(n, model.max_len, device=feats.device)
    steps = torch.arange(tmax + 1, device=feats.device)
    with torch.no_grad():
        for i in range(model.max_len):
            inputs = torch.cat([target, model.embeddings(ids)], dim=1)
            mask = (steps <= i + 1).float()[None].expand(n, -1)
            x = model.decoder.hidden(inputs, mask, ext)
            logits = model.decoder.cls(x[:, i + 1])
            top2 = torch.topk(logits, 2, dim=-1).values
            margins[:, i] = top2[:, 0] - top2[:, 1]
            ids[:, i + 1] = torch.argmax(logits, dim=-1)
    return ids, margins


def negatives_check(torch, shard, device, reps: int = 0):
    """The legacy InfoNCE over :func:`gather_negatives` on the ranks of
    ``shard`` (NEG_WIDTHS: each rank's B / W scenes' sentences, their
    positive proposals as global indices, against every scene's
    proposals) through make_sharded_contrastive_step, against the mean
    of the same ranks' losses computed in this process on the whole
    arrays: the gathered rows bit-equal, the loss within STEP_LOSS_RTOL,
    the gradients of this rank's rows within STEP_GRAD_TOL of the
    largest entry. With ``reps``, the median host-clock ms of the
    sharded step and its backward (synchronised on a card) is
    ``step_ms``. Returns (numbers, ok)."""
    import numpy as np

    from vlp3d_torch.losses.pretrain import compute_contrastive_loss
    from vlp3d_torch.parallel.collectives import (
        gather_negatives,
        make_sharded_contrastive_step,
    )

    b, l, k, c = NEG_WIDTHS
    rng = np.random.default_rng(16)
    lang = rng.normal(size=(b * l, c)).astype(np.float32)
    props = rng.normal(size=(b * k, c)).astype(np.float32)
    labels = (np.arange(b)[:, None] * k + rng.integers(0, k, (b, l)))
    mask = (rng.uniform(size=(b, l)) > 0.2).astype(np.float32)
    world, rank = shard.world, shard.rank
    sc = b // world  # scenes a rank

    def loss_fn(r):
        lab = torch.from_numpy(labels[r * sc:(r + 1) * sc].reshape(-1)).to(
            device)
        msk = torch.from_numpy(mask[r * sc:(r + 1) * sc]).to(device)

        def fn(a, b_all):
            sim = a @ b_all.T
            return compute_contrastive_loss(sim, sim.T, lab, msk)

        return fn

    rows_a = slice(rank * sc * l, (rank + 1) * sc * l)
    rows_b = slice(rank * sc * k, (rank + 1) * sc * k)
    a = torch.from_numpy(lang[rows_a]).to(device).requires_grad_()
    p = torch.from_numpy(props[rows_b]).to(device).requires_grad_()
    gathered = gather_negatives(p.detach(), shard)
    step = make_sharded_contrastive_step(loss_fn(rank), shard)
    loss = step(a, p)
    loss.backward()
    whole_a = torch.from_numpy(lang).to(device).requires_grad_()
    whole_p = torch.from_numpy(props).to(device).requires_grad_()
    ref = sum(loss_fn(r)(whole_a[r * sc * l:(r + 1) * sc * l], whole_p)
              for r in range(world)) / world
    ref.backward()
    loss, ref = loss.detach(), ref.detach()
    gather_err = float((gathered - whole_p.detach()).abs().max())
    loss_rel = abs(float(loss) - float(ref)) / abs(float(ref))
    grad_err = max(
        float((a.grad - whole_a.grad[rows_a]).abs().max()
              / whole_a.grad.abs().max()),
        float((p.grad - whole_p.grad[rows_b]).abs().max()
              / whole_p.grad.abs().max()))
    ok = (gather_err == 0.0 and loss_rel <= STEP_LOSS_RTOL
          and grad_err <= STEP_GRAD_TOL and bool(torch.isfinite(loss)))
    numbers = {"world": world, "loss": float(loss), "gather_err": gather_err,
               "loss_rel": loss_rel, "grad_err": grad_err}
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        step(a, p).backward()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    if times:
        numbers["step_ms"] = float(np.median(times))
    return numbers, ok


class VariantsPhase:
    """Phase 16 in this process: the remaining variant models at run.sh's
    widths. The models and the untimed checks (kernels against the plain
    ops, the card against the CPU or the literal decode) run while the
    CLI processes run; :meth:`drive` counts the launches of each path and
    times it with the card to itself, then runs the contrastive
    negatives over NCCL."""

    def __init__(self, torch, smi, scenes, ground_state, train_host):
        from vlp3d_torch.config import Config, ModelConfig
        from vlp3d_torch.data.synthetic import make_batch
        from vlp3d_torch.losses.vqa import compute_vqa_loss
        from vlp3d_torch.models import JointNet
        from vlp3d_torch.models.jointnet import init_weights_, ref_gt_boxes
        from vlp3d_torch.models.mlcvnet_detector import MLCVNetDetector
        from vlp3d_torch.models.positive_match import positive_match
        from vlp3d_torch.serving import GroundingPredictor
        from vlp3d_torch.train import batch_to_device

        self.smi, self.scenes = smi, scenes
        self.checks = {}
        t_phase = t0 = time.perf_counter()
        # (a) JointNet with MLCVNet's CGNL voting: serving and training
        self.pred = GroundingPredictor(Config(model=ModelConfig(
            use_con=False, no_caption=True, use_mlcv_net=True)),
            batch_size=B)
        self.config = Config(model=ModelConfig(use_con=True, no_caption=True,
                                               use_mlcv_net=True))
        self.mlcv = JointNet(self.config)
        nudge(torch, self.mlcv)
        cfg = self.config.model
        widths = (cfg.input_feature_dim, tuple(cfg.sa_npoints),
                  cfg.num_proposal,
                  len(self.mlcv.lang.text_encoder.bert.encoder.layer))
        if widths != PREDICT_WIDTHS[:4]:
            fail(f"the MLCV model is not at run.sh's widths: {widths}")
        self.device = next(self.mlcv.parameters()).device
        self.batch = batch_to_device(train_host, self.device)
        self.mean = torch.as_tensor(self.config.dataset.mean_size_arr(),
                                    device=self.device)
        # (b) the standalone detector, on a grounding batch of its own
        self.det_config = Config(model=ModelConfig(use_con=False,
                                                   no_caption=True))
        self.detector = MLCVNetDetector(self.det_config)
        with torch.no_grad():  # votes near their seeds
            self.detector.vgen.conv3.weight.mul_(0.05)
            self.detector.vgen.conv3.bias.mul_(0.05)
        self.det_batch = batch_to_device(make_batch(
            self.det_config, batch_size=B, num_points=N, seed=16),
            self.device)
        self.det_loss = lambda o, bt: compute_vqa_loss(
            o, bt, self.mean, use_reference=False, use_lang_classifier=False,
            use_answer=False)
        print(f"[16] MLCV serving and train models and the detector built "
              f"in {time.perf_counter() - t0:.1f} s")
        self.checks["mlcv_serve"] = self.check_serve(torch)
        self.checks["mlcv_step"] = check_kernel_step(
            torch, "16", self.mlcv, self.config, self.batch, MLCV_PROBE,
            "use_mlcv_net step", follow_ties=True)[:3]
        self.checks["detector_forward"] = self.check_detector(torch)
        self.checks["detector_step"] = check_kernel_step(
            torch, "16", self.detector, self.det_config, self.det_batch,
            DETECTOR_PROBE, "MLCVNet detector step", loss_fn=self.det_loss,
            follow_ties=True)[:3]
        stamp("16", "MLCV models' untimed checks")
        # phase 5's grounding model on phase 6's batch gives the DETR head
        # its votes; the nudged MLCV model (~0.7 m boxes) the proposal
        # features and boxes of the others
        ground = JointNet(Config(model=ModelConfig(use_con=False,
                                                   no_caption=True)))
        ground.load_state_dict(ground_state, strict=True)
        out = ground(self.batch, is_eval=True)
        del ground
        self.votes = (out["vote_xyz"], out["vote_features"])
        out = self.mlcv(self.batch, is_eval=True)
        self.bbox = out["bbox_feature"]
        gt_center, gt_size = ref_gt_boxes(self.batch, self.mean)
        self.match = positive_match(out["pred_center"], out["pred_size"],
                                    gt_center, gt_size)
        del out
        if not all(bool(torch.isfinite(v.float()).all())
                   for v in self.match.values()):
            fail(f"positive_match: {self.match}")
        print(f"[16] positive_match over phase 6's batch: "
              f"{int(self.match['good_bbox_masks'].sum())} of "
              f"{self.match['good_bbox_masks'].numel()} sentences with a "
              f"proposal at IoU >= 0.25, pred_ious "
              f"{float(self.match['pred_ious'])}")
        # (c) the DETR head, (d) the xbert captioner, (e) the cross-modal
        # MLM, seeded
        from vlp3d_torch.models.bert import LangCrossMLM
        from vlp3d_torch.models.caption_xbert import CaptionModuleX
        from vlp3d_torch.models.proposal_detr import DETRProposalModule

        t0 = time.perf_counter()
        self.detr = DETRProposalModule(**DETR_WIDTHS)
        self.xbert = CaptionModuleX(**XBERT_WIDTHS)
        self.cross_mlm = LangCrossMLM()
        for m in (self.detr, self.xbert, self.cross_mlm):
            init_weights_(m, 16)
        print(f"[16] DETR head, xbert captioner and LangCrossMLM (BERT-base "
              f"text mode) built in {time.perf_counter() - t0:.1f} s")
        b, l = self.batch["input_ids"].shape[:2]
        self.labels = self.match["positive_labels"].reshape(b, l)
        self.checks["detr"] = self.check_detr(torch)
        self.checks["xbert"] = self.check_xbert(torch)
        self.checks["cross_mlm"] = self.check_cross_mlm(torch)
        self.untimed_s = time.perf_counter() - t_phase
        stamp("16", f"variant models' untimed checks ({self.untimed_s:.1f} "
              "s)")

    # -- untimed checks ----------------------------------------------------

    def check_serve(self, torch):
        """The MLCV GroundingPredictor on phase 5's first batch against the
        plain ops: pred_ref equal, cluster_ref within CLUSTER_REF_TOL."""
        import numpy as np

        got = self.pred([self.scenes[0]])[0]
        with plain_ops():
            want = self.pred([self.scenes[0]])[0]
        err = float(np.abs(got["cluster_ref"] - want["cluster_ref"]).max())
        same = bool(np.array_equal(got["pred_ref"], want["pred_ref"]))
        print(f"[16] use_mlcv_net serving forward at B={B}, N={N}, kernels "
              f"against plain ops on the card: pred_ref equal {same}, "
              f"cluster_ref max abs err {err}")
        if not same or err > CLUSTER_REF_TOL \
                or not all(np.isfinite(v).all() for v in got.values()):
            fail("the use_mlcv_net serving forward differs from the "
                 "plain-op one")
        return {"cluster_ref_err": err}

    def check_detector(self, torch):
        """The detector's evaluation forward against the plain ops:
        sampled indices equal, boxes and scores within CLUSTER_REF_TOL of
        max(1, the largest entry)."""
        got = self.detector(self.det_batch)
        with plain_ops():
            want = self.detector(self.det_batch)
        idx = {k: index_err(torch, got[k], want[k]) for k in (
            "sa1_inds", "fp2_inds", "aggregated_vote_inds")}
        errs = {k: float((got[k] - want[k]).abs().max())
                / max(1.0, float(want[k].abs().max()))
                for k in ("center", "pred_size", "objectness_scores",
                          "sem_cls_scores", "aggregated_vote_features")}
        print(f"[16] MLCVNet detector forward at B={B}, N={N}, kernels "
              f"against plain ops: index differences {idx}, output "
              f"differences (of max(1, the largest entry)) {errs}")
        if any(idx.values()) or max(errs.values()) > CLUSTER_REF_TOL:
            fail("the detector's forward differs from the plain-op one")
        return {"index_err": max(idx.values()), "err": max(errs.values())}

    def check_detr(self, torch):
        """The DETR head over phase 6's votes, kernels against plain ops:
        the evaluation forward (indices equal, every output within
        CLUSTER_REF_TOL of max(1, its largest entry)) and a training
        forward + backward of detr_loss with one dropout draw (every
        parameter's gradient and the vote features' within STEP_GRAD_TOL
        of its largest entry)."""
        from vlp3d_torch.models.layers import set_dropout_generator

        xyz, feats = self.votes
        got = self.detr(xyz, feats, self.mean)
        with plain_ops():
            want = self.detr(xyz, feats, self.mean)
        idx = index_err(torch, got["aggregated_vote_inds"],
                        want["aggregated_vote_inds"])
        err = max(float((got[k].float() - want[k].float()).abs().max())
                  / max(1.0, float(want[k].float().abs().max()))
                  for k in got)
        grads = {}
        for run in ("plain", "kernel"):
            gen = torch.Generator(device=self.device).manual_seed(16)
            set_dropout_generator(self.detr, gen)
            f = feats.detach().clone().requires_grad_()
            with (plain_ops() if run == "plain" else contextlib.nullcontext()):
                detr_loss(self.detr(xyz, f, self.mean, train=True)).backward()
            grads[run] = {n: p.grad.detach().clone()
                          for n, p in self.detr.named_parameters()}
            grads[run]["vote_features"] = f.grad
            self.detr.zero_grad(set_to_none=True)
        set_dropout_generator(self.detr, None)
        self.detr.eval()
        gerr = {n: float((grads["kernel"][n] - g).abs().max())
                / max(float(g.abs().max()), 1e-30)
                for n, g in grads["plain"].items()}
        worst = max(gerr, key=gerr.get)
        print(f"[16] DETR head over phase 6's votes ({tuple(xyz.shape)}, "
              f"{DETR_WIDTHS}), kernels against plain ops: aggregation index "
              f"difference {idx}, outputs within {err} of max(1, the largest "
              f"entry); training forward + backward: the largest gradient "
              f"difference, of its tensor's largest entry, {gerr[worst]} "
              f"({worst}; vote features {gerr['vote_features']})")
        if idx or err > CLUSTER_REF_TOL or gerr[worst] > STEP_GRAD_TOL:
            fail("the DETR head differs from the plain-op run")
        return {"index_err": idx, "err": err, "grad_err": gerr[worst]}

    def check_xbert(self, torch):
        """The xbert captioner's train logits on phase 6's sentences (the
        first XBERT_T tokens, each sentence's positive proposal as its
        object token) on the card against the same on the CPU (within
        CLUSTER_REF_TOL of the largest logit; the argmax ids equal or
        excused by the tie rule), and the greedy decode of B x K captions
        against xbert_literal_decode by the tie rule."""
        import copy

        ids = self.batch["input_ids"][..., :XBERT_T]
        amask = self.batch["bert_attention_mask"][..., :XBERT_T]
        inputs = (self.bbox, ids, amask, self.labels)
        with torch.no_grad():
            got = self.xbert(*inputs).cpu()
            cpu = copy.deepcopy(self.xbert).cpu()
            t0 = time.perf_counter()
            want = cpu(*(t.cpu() for t in inputs))
            cpu_s = time.perf_counter() - t0
        del cpu
        err = float((got - want).abs().max()) / float(want.abs().max())
        ids_p = torch.argmax(want, -1)
        excused = tie_rule(ids_p, torch.argmax(got, -1),
                           lambda r, j: top2_margin(torch, want[r, j]),
                           "xbert train logits' ids, the card against the "
                           "CPU", "16")
        del got, want
        gen = self.xbert.generate(self.bbox)
        n = gen.shape[0] * gen.shape[1]
        lit, margins = xbert_literal_decode(torch, self.xbert, self.bbox)
        excused_gen = tie_rule(lit, gen.reshape(n, -1),
                               lambda r, s: float(margins[r, s - 1]),
                               f"xbert greedy decode of {n} captions against "
                               "the literal decode", "16")
        print(f"[16] xbert captioner {XBERT_WIDTHS}: train logits "
              f"{tuple(ids.shape)} within {err} of the largest (the CPU run "
              f"{cpu_s:.1f} s), decode ids {tuple(gen.shape)}, "
              f"{len(torch.unique(gen[..., 1:]))} distinct ids")
        if err > CLUSTER_REF_TOL:
            fail("the xbert train logits differ from the CPU run")
        return {"logit_err": err, "excused": excused,
                "decode_excused": excused_gen}

    def check_cross_mlm(self, torch):
        """LangCrossMLM on phase 6's sentences and proposals (BERT-base
        text mode), draws from a seeded generator: finite logits, some
        tokens masked, a finite cross_mlm_loss."""
        from vlp3d_torch.models.bert import cross_mlm_loss

        gen = torch.Generator(device=self.device).manual_seed(16)
        with torch.no_grad():
            logits, tokens, masked = self.cross_mlm(
                self.batch["input_ids"], self.batch["bert_attention_mask"],
                self.bbox, self.labels, generator=gen)
            loss = cross_mlm_loss(logits, tokens, masked)
        print(f"[16] LangCrossMLM: logits {tuple(logits.shape)}, "
              f"{int(masked.sum())} tokens masked, cross_mlm_loss "
              f"{float(loss)}")
        if not bool(torch.isfinite(logits).all()) or not bool(masked.any()) \
                or not bool(torch.isfinite(loss)):
            fail("LangCrossMLM gave non-finite outputs or masked nothing")
        return {"loss": float(loss), "masked": int(masked.sum())}

    # -- the timed paths, with the card to itself -------------------------

    def drive(self, torch):
        """Counts at 0 before each path: one call's launches (held exactly)
        and the median ms of VARIANT_STEPS with the peak memory above the
        resident models; then the contrastive negatives at world size 1
        over NCCL. Returns ({path: launch counts}, numbers)."""
        import numpy as np

        from vlp3d_torch import ops
        from vlp3d_torch.cli.train_3djcg_g import adamw_one_group
        from vlp3d_torch.models.bert import cross_mlm_loss
        from vlp3d_torch.parallel import BatchShard
        from vlp3d_torch.parallel import distributed as du
        from vlp3d_torch.train import make_optimizer, make_train_step
        from vlp3d_torch.train.schedules import cosine_lr
        from vlp3d_torch.train.state import backward_and_step

        t_phase = time.perf_counter()
        mlcv_step = make_train_step(self.mlcv, self.config, make_optimizer(
            self.mlcv, lr_schedule=lambda e, lr0: cosine_lr(e, lr0, 200),
            steps_per_epoch=100))
        det_opt = adamw_one_group(self.detector, 2e-3, 1e-5)
        gen = torch.Generator(device=self.device).manual_seed(0)
        xyz, feats = self.votes
        losses = []

        def det_step():
            loss, m = self.det_loss(self.detector(self.det_batch, train=True),
                                    self.det_batch)
            backward_and_step(loss, det_opt)
            losses.append(m["loss"].detach())

        def detr_step():
            f = feats.detach().clone().requires_grad_()
            detr_loss(self.detr(xyz, f, self.mean, train=True)).backward()
            self.detr.zero_grad(set_to_none=True)

        def mlm():
            with torch.no_grad():
                out = self.cross_mlm(
                    self.batch["input_ids"], self.batch["bert_attention_mask"],
                    self.bbox, self.labels, generator=gen)
                return cross_mlm_loss(*out)

        paths = (
            ("mlcv_serve", lambda: self.pred([self.scenes[1]]), PER_FORWARD),
            ("mlcv_step", lambda: losses.append(mlcv_step(
                self.batch, gen)["loss"]), PER_STEP),
            ("detector_forward", lambda: self.detector(self.det_batch),
             DETECTOR_FORWARD),
            ("detector_step", det_step, DETECTOR_STEP),
            ("detr_forward", lambda: self.detr(xyz, feats, self.mean),
             DETR_FORWARD),
            ("detr_step", detr_step, DETR_STEP),
            ("xbert_train", lambda: self.xbert(
                self.bbox, self.batch["input_ids"][..., :XBERT_T],
                self.batch["bert_attention_mask"][..., :XBERT_T],
                self.labels), ZERO_LAUNCHES),
            ("xbert_generate", lambda: self.xbert.generate(self.bbox),
             ZERO_LAUNCHES),
            ("cross_mlm", mlm, ZERO_LAUNCHES),
        )
        launches, numbers = {}, {}
        for name, fn, per in paths:
            ops.reset_launches()
            fn()
            torch.cuda.synchronize()
            one = dict(ops.launches)
            if one != per:
                fail(f"phase 16 {name}: launches {one} != {per}")
            ms, peak = median_ms(torch, fn, VARIANT_STEPS)
            launches[name] = one
            numbers[name] = {"ms": ms, "peak_gib": peak, "launches": one}
            print(f"[16] {name}: median {ms:.3f} ms of {VARIANT_STEPS}, peak "
                  f"{peak:.3f} GiB above the resident models; launches "
                  f"{ {k: v for k, v in one.items() if v} } ({self.smi})")
        if not np.isfinite([float(v) for v in losses]).all():
            fail(f"phase 16 step losses {losses}")
        # the contrastive negatives at world size 1 over NCCL
        du.dist_init(f"127.0.0.1:{free_port()}", 1, 0, device=self.device)
        try:
            if du.backend() != "nccl":
                fail(f"phase 16's group runs over {du.backend()}, not NCCL")
            neg, ok = negatives_check(torch, BatchShard.of_group(),
                                      self.device, reps=VARIANT_STEPS)
        finally:
            du.dist_close()
        print(f"[16] InfoNCE over gather_negatives at world size 1 over "
              f"NCCL against the one-process loss: {neg}")
        if not ok:
            fail("the sharded contrastive step differs from the "
                 "one-process loss")
        numbers["negatives"] = neg
        numbers["checks"] = self.checks
        numbers["untimed_s"] = self.untimed_s
        numbers["wall_s"] = time.perf_counter() - t_phase
        stamp("16", "variant paths")
        return launches, numbers


def pillar_cloud(seed: int, kind: str, n: int = PILLAR_POINTS):
    """One seeded (n, 4) float32 row of x, y, z, reflectance: "lidar"
    (16 ground rings in a 80-degree field and 15 car-sized boxes of
    points, ~10 000 pillars), "uniform" (over the range: ~92 000 cells,
    the voxel cap bites) or "worst" (30% of the points out of range and
    one pillar of 20 000 points: the slot cap and the ranking's longest
    segment, its first point early enough to be kept)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = np.array(PILLAR_RANGE[:3]), np.array(PILLAR_RANGE[3:])

    def lidar(m):
        ground = m * 3 // 5
        r = (4.0 + 3.6 * rng.integers(0, 16, ground)
             + rng.normal(0, 0.02, ground))
        th = rng.uniform(-0.7, 0.7, ground)
        g = np.stack([r * np.cos(th), r * np.sin(th),
                      -1.73 + rng.normal(0, 0.03, ground)], 1)
        k = 15
        per = (m - ground) // k
        c = np.stack([rng.uniform(6, 62, k), rng.uniform(-30, 30, k),
                      np.full(k, -0.95)], 1)
        yaw = rng.uniform(-np.pi, np.pi, k)
        loc = rng.uniform(-0.5, 0.5, (k, per, 3)) * [3.9, 1.6, 1.55]
        cs, sn = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
        objs = np.stack([c[:, None, 0] + cs * loc[..., 0] - sn * loc[..., 1],
                         c[:, None, 1] + sn * loc[..., 0] + cs * loc[..., 1],
                         c[:, None, 2] + loc[..., 2]], -1).reshape(-1, 3)
        noise = rng.uniform(lo, hi, (m - ground - k * per, 3))
        return np.concatenate([g, objs, noise])

    if kind == "lidar":
        xyz = lidar(n)
    elif kind == "uniform":
        xyz = rng.uniform(lo, hi, (n, 3))
    else:
        out, crowd = n * 3 // 10, 20000
        far = rng.uniform(lo - 20, hi + 20, (out, 3))
        far[:, 0] = np.where(rng.random(out) < 0.5,
                             rng.uniform(-20, -0.01, out),
                             rng.uniform(69.2, 90, out))
        pillar = (np.array([20.0, 5.0, -1.0])
                  + rng.uniform(0.005, 0.155, (crowd, 3)) * [1, 1, 10])
        xyz = np.concatenate([lidar(n - out - crowd), far, pillar])
    xyz = xyz[rng.permutation(n)]
    refl = rng.uniform(0, 1, (n, 1))
    return np.concatenate([xyz, refl], 1).astype(np.float32)


def pillar_boxes(seed: int, n: int = NMS_BOXES):
    """(n, 5) [x1, y1, x2, y2, angle] and (n,) scores: a detector's boxes
    before NMS, 64 proposals jittered around each of n / 64 cars in the
    KITTI range (centre 0.3 m, size 10%, yaw 0.1 rad), a few scores tied."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = n // 64
    car = np.stack([rng.uniform(2, 67, k), rng.uniform(-37, 37, k)], 1)
    size = np.stack([rng.uniform(3.5, 4.5, k), rng.uniform(1.5, 2.0, k)], 1)
    yaw = rng.uniform(-np.pi, np.pi, k)
    pick = rng.integers(0, k, n)
    c = car[pick] + rng.normal(0, 0.3, (n, 2))
    s = size[pick] * rng.uniform(0.9, 1.1, (n, 2))
    a = yaw[pick] + rng.normal(0, 0.1, n)
    boxes = np.concatenate([c - s / 2, c + s / 2, a[:, None]], 1)
    scores = rng.uniform(0, 1, n)
    scores[1::97] = scores[0]
    return boxes.astype(np.float32), scores.astype(np.float32)


def uniform_boxes(seed: int, n: int):
    """(n, 5) boxes and (n,) scores as pillar_boxes gives them, but each
    box a car of its own, uniform over the KITTI range: no clusters."""
    import numpy as np

    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(0, 69.12, n), rng.uniform(-39.68, 39.68, n)], 1)
    s = np.stack([rng.uniform(3.5, 4.5, n), rng.uniform(1.5, 2.0, n)], 1)
    a = rng.uniform(-np.pi, np.pi, n)
    boxes = np.concatenate([c - s / 2, c + s / 2, a[:, None]], 1)
    return boxes.astype(np.float32), rng.uniform(0, 1, n).astype(np.float32)


def crowded_boxes(seed: int, n: int):
    """(n, 5) boxes and (n,) scores: a worst case for the IoU's screens,
    n proposals around 4 cars side by side 1.5 m apart (closer than cars
    park), centre jitter 0.5 m, size 20%, yaw 0.3 rad, so that most pairs
    straddle an edge and reach the ordered clip."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = 4
    yaw0 = rng.uniform(-np.pi, np.pi)
    across = np.array([-np.sin(yaw0), np.cos(yaw0)])
    car = (np.array([rng.uniform(10, 60), rng.uniform(-30, 30)])
           + np.outer((np.arange(k) - (k - 1) / 2) * 1.5, across))
    size = np.stack([rng.uniform(3.5, 4.5, k), rng.uniform(1.5, 2.0, k)], 1)
    yaw = yaw0 + rng.normal(0, 0.05, k)
    pick = rng.integers(0, k, n)
    c = car[pick] + rng.normal(0, 0.5, (n, 2))
    s = size[pick] * rng.uniform(0.8, 1.2, (n, 2))
    a = yaw[pick] + rng.normal(0, 0.3, n)
    boxes = np.concatenate([c - s / 2, c + s / 2, a[:, None]], 1)
    return boxes.astype(np.float32), rng.uniform(0, 1, n).astype(np.float32)


def iou_box_sets() -> dict:
    """Phase 17's sets of NMS_BOXES boxes and scores: clustered proposals
    (pillar_boxes, the main path's), uniform and crowded."""
    return {"pillar": pillar_boxes(16), "uniform": uniform_boxes(17, NMS_BOXES),
            "crowded": crowded_boxes(21, NMS_BOXES)}


def iou_nms_ms(torch, sets: dict) -> dict:
    """Device ms of boxes_iou_bev and of nms_rotated at the first of
    NMS_THRESHOLDS on each set of :func:`iou_box_sets` (host arrays),
    mean of 10 calls, through the public functions of whichever
    vlp3d_torch this process imports."""
    from vlp3d_torch.ops import iou3d

    out = {}
    th = NMS_THRESHOLDS[0]
    for name, (hb, hs) in sets.items():
        b = torch.from_numpy(hb).cuda()
        s = torch.from_numpy(hs).cuda()
        out[name] = {
            "iou": cuda_ms(torch, lambda: iou3d.boxes_iou_bev(b, b), 10),
            "nms": cuda_ms(torch, lambda: iou3d.nms_rotated(b, s, th), 10)}
    return out


def iou_times_main() -> int:
    """``--iou-times``: iou_nms_ms on iou_box_sets with the vlp3d_torch
    beside this file, for a comparison of two checkouts in one run on one
    card (copy this file into the other's root); the last line is the
    numbers."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one",
              file=sys.stderr)
        return 1
    smi = smi_line()
    ms = iou_nms_ms(torch, iou_box_sets())
    print(f"[iou-times] {REPO} ({smi}): {json.dumps(ms)}")
    print(json.dumps({"root": REPO, "device": smi, "ms": ms}))
    return 0


# --redesign-times: the interpolation backward at phase 6's FP shapes (B,
# unknown points, known points, channels)
FP_GRAD_SHAPES = (("FP1", 8, 512, 256, 256), ("FP2", 8, 1024, 512, 256))


def redesign_times_main(save: str, against: str | None) -> int:
    """``--redesign-times SAVE [AGAINST]``: the device ms of the
    interpolation backward at FP_GRAD_SHAPES and of hard_voxelize on
    phase 17's clouds (means of 50 and 20 calls), with the vlp3d_torch
    beside this file, for a comparison of two checkouts in one run on one
    card (copy this file into the other's root). The inputs are made on
    the host from seeds, so both checkouts see the same; the outputs go
    to SAVE (torch.save) and, given AGAINST (another run's SAVE), are
    held against those bit for bit. The last line is the numbers."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one",
              file=sys.stderr)
        return 1
    from vlp3d_torch.ops import interpolate as itp
    from vlp3d_torch.ops import voxelize as vox

    smi = smi_line()
    rng = np.random.default_rng(18)
    ms, outs = {}, {}
    for label, b, n, m, c in FP_GRAD_SHAPES:
        # the known points a subset of the unknown ones, as FPS gives them
        unknown = torch.from_numpy(
            rng.uniform(0, 4, (b, n, 3)).astype(np.float32))
        known = unknown[:, ::n // m][:, :m].contiguous()
        dist2, idx = itp.three_nn_plain(unknown, known)
        weight = itp.interpolation_weights(dist2).cuda()
        idx = idx.cuda()
        grad = torch.from_numpy(
            rng.normal(size=(b, n, c)).astype(np.float32)).cuda()
        outs[label] = itp._three_interpolate_grad_cuda(grad, idx, weight, m)
        ms[label] = cuda_ms(torch, lambda: itp._three_interpolate_grad_cuda(
            grad, idx, weight, m), 50)
    pts = torch.from_numpy(np.stack([
        pillar_cloud(17 + i, kind) for i, kind in
        enumerate(("lidar", "lidar", "uniform", "worst"))])).cuda()
    args = (pts, PILLAR_VOXEL, PILLAR_RANGE, PILLAR_SLOTS, PILLAR_VOXELS)
    outs["hard_voxelize"] = vox._hard_cuda(*args)
    ms["hard_voxelize"] = cuda_ms(torch, lambda: vox._hard_cuda(*args), 20)
    torch.cuda.synchronize()
    host = {k: ([t.cpu() for t in v] if isinstance(v, tuple) else v.cpu())
            for k, v in outs.items()}
    torch.save(host, save)
    equal = None
    if against:
        other = torch.load(against)
        equal = {k: (all(torch.equal(a, b) for a, b in zip(v, other[k]))
                     if isinstance(v, list) else torch.equal(v, other[k]))
                 for k, v in host.items()}
    print(f"[redesign-times] {REPO} ({smi}): {json.dumps(ms)}; equal bit "
          f"for bit to {against}: {json.dumps(equal)}")
    print(json.dumps({"root": REPO, "device": smi, "ms": ms,
                      "equal": equal}))
    return 0


@contextlib.contextmanager
def pillar_plain_ops():
    """Route the voxelization wrappers to their plain versions (the
    plain-op encoder forward and step on the card); restored on exit."""
    vox = importlib.import_module("vlp3d_torch.ops.voxelize")
    saved = vox._hard_cuda, vox._dynamic_cuda
    vox._hard_cuda = vox.hard_voxelize_plain
    vox._dynamic_cuda = vox.dynamic_voxelize_plain
    try:
        yield
    finally:
        vox._hard_cuda, vox._dynamic_cuda = saved


def rel_err(torch, got, want) -> float:
    """Largest absolute difference over the largest entry of want."""
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale


class PillarClis(CliProcesses):
    """Phase 17's predict processes, started beside phase 8's: run.sh's
    flags over the port's stand-ins, once on the baked npy and once on
    the npy without multiview columns plus ``--multiview_hdf5`` (read
    without h5py); seeded weights, so both must predict alike."""

    def start(self):
        from vlp3d_torch.data.standins import write_standin_assets

        paths = write_standin_assets(self.tmp.name)
        hdf5 = os.path.join(paths["multiview_nomv_data"],
                            "enet_feats_maxpool.hdf5")
        common = [*RUN_SH_FLAGS, "--scanrefer_dir", paths["scanrefer_dir"],
                  "--bert_vocab", os.path.join(paths["bert_dir"],
                                               "vocab.txt")]
        self.out = {k: os.path.join(self.tmp.name, f"pred{i}.json")
                    for i, k in enumerate(PILLAR_PREDICTS)}
        baked, mv = PILLAR_PREDICTS
        self.launch("predict", [
            *common, "--scannet_data", paths["scannet_data"], "--out",
            self.out[baked]], key=baked)
        self.launch("predict", [
            *common, "--scannet_data", paths["multiview_nomv_data"],
            "--multiview_hdf5", hdf5, "--out", self.out[mv]], key=mv)
        stamp("17", "predict CLIs (baked npy, --multiview_hdf5) started")

    def check(self):
        """Both exit 0; the hdf5 run's pred.json equals the baked run's
        (boxes within BOX_TOL); returns seconds and the record count."""
        import numpy as np

        ended = self.ended()
        preds = {}
        for key, path in self.out.items():
            with open(path) as f:
                preds[key] = sorted(json.load(f), key=lambda r: (
                    r["scene_id"], r["object_id"], r["ann_id"]))
        base, mv = (preds[k] for k in PILLAR_PREDICTS)
        box_err = 0.0
        if len(base) != len(mv) or not base:
            fail(f"predict --multiview_hdf5: {len(mv)} records, baked "
                 f"{len(base)}")
        for a, b in zip(base, mv):
            if {k: v for k, v in a.items() if k != "bbox"} != \
                    {k: v for k, v in b.items() if k != "bbox"}:
                fail(f"predict --multiview_hdf5 record {b} != baked {a}")
            box_err = max(box_err, float(np.abs(np.asarray(a["bbox"])
                                                - np.asarray(b["bbox"]))
                                         .max()))
        if box_err > BOX_TOL:
            fail(f"predict --multiview_hdf5 boxes differ from the baked "
                 f"run's by {box_err}")
        numbers = {
            "records": len(mv), "box_err": box_err,
            "baked_s": ended[PILLAR_PREDICTS[0]][1],
            "hdf5_s": ended[PILLAR_PREDICTS[1]][1]}
        print(f"[17] python -m vlp3d_torch.cli.predict --multiview_hdf5 "
              f"(stand-ins, no h5py): exit 0 in {numbers['hdf5_s']:.1f} s, "
              f"{len(mv)} records equal to the baked npy run's (boxes max "
              f"abs err {box_err}; that run {numbers['baked_s']:.1f} s)")
        return numbers


class PillarsPhase:
    """Phase 17, with the card to itself: the PointPillars encoder at
    full width (PILLAR_ROWS rows of PILLAR_POINTS points), the rotated BEV
    IoU and NMS at OpenPCDet's post-processing size (NMS_BOXES boxes) and
    the multiview hdf5 read without h5py."""

    def __init__(self, torch, smi):
        self.smi = smi
        self.device = torch.device("cuda")

    def trace(self, torch) -> dict:
        """Trace a hard_voxelize call, an evaluation forward and an NMS
        call; run in a process of its own (``--pillar-traces``): late in a
        long process the profiler loses device events (PERF.md, section
        7)."""
        from vlp3d_torch.ops import iou3d
        from vlp3d_torch.ops import voxelize as vox

        profiles = {}
        model, pts = self._encoder(torch)
        b, n, _ = pts.shape
        voxel = (PILLAR_FUNCTIONS["dynamic_voxelize"]
                 + PILLAR_FUNCTIONS["hard_voxelize"])
        profiles["hard_voxelize"] = profile_call(
            torch, lambda: vox._hard_cuda(pts, PILLAR_VOXEL, PILLAR_RANGE,
                                          PILLAR_SLOTS, PILLAR_VOXELS),
            "17", f"hard_voxelize call (B {b} x {n})", top=12, expect=voxel)
        with torch.no_grad():
            profiles["forward"] = profile_call(
                torch, lambda: model.eval()(pts), "17",
                "PillarEncoder evaluation forward", top=12, expect=voxel)
        host_boxes, host_scores = pillar_boxes(16)
        boxes = torch.from_numpy(host_boxes).to(self.device)
        scores = torch.from_numpy(host_scores).to(self.device)
        profiles["nms_rotated"] = profile_call(
            torch, lambda: iou3d.nms_rotated(boxes, scores,
                                             NMS_THRESHOLDS[0]),
            "17", f"nms_rotated call ({boxes.shape[0]} boxes)", top=6,
            expect=PILLAR_FUNCTIONS["nms_bev"])
        return profiles

    def drive(self, torch, cli_numbers: dict):
        t0 = time.perf_counter()
        self.cli_numbers = cli_numbers
        self.profiles = pillar_traces()
        rows, numbers = {}, {"profiles": self.profiles}
        model, pts = self._encoder(torch)
        rows.update(self._voxel_kernels(torch, pts))
        numbers["encoder"] = self._encoder_checks(torch, model, pts)
        del model, pts
        torch.cuda.empty_cache()
        iou_rows, numbers["nms"] = self._iou_nms(torch)
        rows.update(iou_rows)
        numbers["multiview_hdf5"] = self._hdf5(torch)
        numbers["phase_s"] = time.perf_counter() - t0
        stamp("17", f"PointPillars, IoU / NMS and the hdf5 read in "
              f"{numbers['phase_s']:.1f} s")
        return rows, numbers

    # -- (a) the encoder ---------------------------------------------------

    def _encoder(self, torch):
        import numpy as np

        from vlp3d_torch.models.pointpillars import PillarEncoder

        model = PillarEncoder(out_channel=PILLAR_CHANNELS,
                              device=self.device)
        g = torch.Generator().manual_seed(17)
        c_out, c_in = model.conv.weight.shape[:2]
        sd = {"conv.weight": torch.randn(c_out, c_in, 1, generator=g)
              * (2.0 / c_in) ** 0.5,
              "bn.weight": 1.0 + 0.1 * torch.randn(c_out, generator=g),
              "bn.bias": 0.1 * torch.randn(c_out, generator=g),
              "bn.running_mean": 0.1 * torch.randn(c_out, generator=g),
              "bn.running_var": 1.0 + torch.rand(c_out, generator=g),
              "bn.num_batches_tracked": torch.tensor(0)}
        model.load_state_dict(sd, strict=True)
        host = [pillar_cloud(17 + i, kind) for i, kind in
                enumerate(("lidar", "lidar", "uniform", "worst"))]
        pts = torch.from_numpy(np.stack(host)).to(self.device)
        return model, pts

    def _voxel_kernels(self, torch, pts):
        """Both kernels against their plain versions bit for bit, timed."""
        from vlp3d_torch.ops import voxelize as vox
        from vlp3d_torch.ops.host_time import host_us

        vs, pr = PILLAR_VOXEL, PILLAR_RANGE
        p, v = PILLAR_SLOTS, PILLAR_VOXELS
        got = vox._hard_cuda(pts, vs, pr, p, v)
        again = vox._hard_cuda(pts, vs, pr, p, v)
        want = vox.hard_voxelize_plain(pts, vs, pr, p, v)
        names = ("voxels", "coors", "num_points_per_voxel", "voxel_num",
                 "voxel_mask", "slot")
        for name, a, a2, b in zip(names, got, again, want):
            if a.shape != b.shape or a.dtype != b.dtype \
                    or not torch.equal(a, b):
                fail(f"hard_voxelize kernel {name} differs from the plain "
                     "version")
            if not torch.equal(a, a2):
                fail(f"hard_voxelize kernel {name} differs between two "
                     "launches")
        coords, _ = vox._dynamic_cuda(pts, vs, pr)
        if not torch.equal(coords, vox.dynamic_voxelize_plain(pts, vs,
                                                              pr)[0]):
            fail("dynamic_voxelize kernel differs from the plain version")
        voxel_num = got[3].tolist()
        npts = got[2]
        shape = dict(rows=PILLAR_ROWS, points=PILLAR_POINTS,
                     voxel_num=voxel_num,
                     max_count=int(npts.max()),
                     outside=float((coords[..., 0] < 0).float().mean()))
        if not (5000 <= voxel_num[0] <= 12000 and 5000 <= voxel_num[1]
                <= 12000 and voxel_num[2] == v and int(npts[3].max()) == p):
            fail(f"phase 17's clouds are not the ones described: {shape}")
        b, n, c = pts.shape
        tiny = pts[:1, :64].contiguous()
        rows = {}
        for name, fn, plain, nbytes in (
                ("dynamic_voxelize",
                 lambda: vox._dynamic_cuda(pts, vs, pr),
                 lambda: vox.dynamic_voxelize_plain(pts, vs, pr),
                 4 * b * n * c + 4 * b * n * 3),
                ("hard_voxelize",
                 lambda: vox._hard_cuda(pts, vs, pr, p, v),
                 lambda: vox.hard_voxelize_plain(pts, vs, pr, p, v),
                 4 * b * n * c + 4 * b * v * p * c + 4 * b * v * 3
                 + 4 * b * v + 4 * b + b * v + 4 * b * n)):
            ms = cuda_ms(torch, fn, reps=20)
            plain_ms = cuda_ms(torch, plain, reps=2, warmup=1)
            bound, by = bound_ms(nbytes, 0)
            rows[name] = [{
                "site": "PillarEncoder", "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "max_abs_err": 0.0, "shape": shape}]
            print(f"[17] {name} (B {b} x {n} points, {v} voxels x {p} "
                  f"slots): kernel {ms:.4f} ms, plain {plain_ms:.3f}, bound "
                  f"{bound:.5f} ({by}); equal to the plain version bit for "
                  "bit")
        # the trace of one call (--pillar-traces): time by CUDA function
        # and the device operations (the dynamic kernel, one memset, four
        # kernels)
        trace = self.profiles.get("hard_voxelize", {})
        if trace and (trace["events"] > HARD_DEVICE_OPS
                      or trace["memsets"] != 1):
            fail(f"a hard_voxelize call ran {trace['events']} device "
                 f"operations, {trace['memsets']} of them memsets (expected "
                 f"{HARD_DEVICE_OPS}, one memset)")
        rows["hard_voxelize"][0].update(
            split_ms=trace.get("expect_split", "not measured"),
            device_ops=trace.get("events", "not measured"),
            memsets=trace.get("memsets", "not measured"))
        rows["dynamic_voxelize"][0]["host_us"] = host_us(
            lambda: vox.dynamic_voxelize(tiny, vs, pr))
        rows["hard_voxelize"][0]["host_us"] = host_us(
            lambda: vox.hard_voxelize(tiny, vs, pr, p, v))
        print(f"[17] clouds {shape}; host us dynamic "
              f"{rows['dynamic_voxelize'][0]['host_us']:.1f}, hard "
              f"{rows['hard_voxelize'][0]['host_us']:.1f}")
        return rows

    def _encoder_checks(self, torch, model, pts):
        """The evaluation forward and a training forward + backward
        against the plain ops, the launches of each (the main path, counts
        at 0), the median ms and peak memory."""
        import copy

        from vlp3d_torch.ops import _kernels

        out = {}
        model.eval()
        with torch.no_grad():
            _kernels.reset_launches()
            canvas = model(pts)
            torch.cuda.synchronize()
            out["launches_forward"] = dict(_kernels.launches)
            with pillar_plain_ops():
                ref = model(pts)
        if tuple(canvas.shape) != (PILLAR_ROWS, 496, 432, PILLAR_CHANNELS) \
                or not torch.isfinite(canvas).all():
            fail(f"PillarEncoder canvas {tuple(canvas.shape)}")
        out["canvas_err"] = (0.0 if torch.equal(canvas, ref)
                             else rel_err(torch, canvas, ref))
        if out["canvas_err"] > PILLAR_CANVAS_TOL:
            fail(f"PillarEncoder canvas differs from the plain-op forward "
                 f"by {out['canvas_err']} of its largest entry")
        out["filled_cells"] = [int(x) for x in
                               (canvas.abs().sum(-1) > 0).sum((1, 2))]
        g = torch.randn(canvas.shape, generator=torch.Generator(
            device=self.device).manual_seed(3), device=self.device)

        def step(m, plain=False):
            x = pts.clone().requires_grad_(True)
            with pillar_plain_ops() if plain else contextlib.nullcontext():
                y = m.train()(x)
                (y * g).sum().backward()
            return y.detach(), x.grad, {k: p.grad for k, p in
                                        m.named_parameters()}, m

        kernel_model, plain_model = copy.deepcopy(model), copy.deepcopy(model)
        _kernels.reset_launches()
        y, gx, grads, m_k = step(kernel_model)
        torch.cuda.synchronize()
        out["launches_step"] = dict(_kernels.launches)
        y_p, gx_p, grads_p, m_p = step(plain_model, plain=True)
        errs = {"canvas": rel_err(torch, y, y_p),
                "points": rel_err(torch, gx, gx_p),
                **{k: rel_err(torch, v, grads_p[k]) for k, v in
                   grads.items()},
                "running_mean": rel_err(torch, m_k.bn.running_mean,
                                        m_p.bn.running_mean),
                "running_var": rel_err(torch, m_k.bn.running_var,
                                       m_p.bn.running_var)}
        out["step_errs"] = errs
        if max(errs.values()) > STEP_GRAD_TOL:
            fail(f"PillarEncoder training step against the plain ops: "
                 f"{errs}")
        for path in ("launches_forward", "launches_step"):
            if out[path] != PILLAR_FORWARD:
                fail(f"PillarEncoder {path} {out[path]} != {PILLAR_FORWARD}")
        del kernel_model, plain_model, y, gx, grads, y_p, gx_p, grads_p
        torch.cuda.empty_cache()
        model.eval()
        with torch.no_grad():
            out["forward_ms"], out["forward_peak_gib"] = median_ms(
                torch, lambda: model(pts), PILLAR_STEPS)
        step_model = copy.deepcopy(model)
        out["step_ms"], out["step_peak_gib"] = median_ms(
            torch, lambda: step(step_model), PILLAR_STEPS)
        del step_model
        print(f"[17] PillarEncoder at {PILLAR_ROWS} x {PILLAR_POINTS} points "
              f"(canvas {PILLAR_ROWS} x 496 x 432 x {PILLAR_CHANNELS}, filled "
              f"cells "
              f"{out['filled_cells']}): evaluation canvas "
              f"{'bit-equal to' if out['canvas_err'] == 0 else 'within'} "
              f"the plain-op forward's (err {out['canvas_err']}); training "
              f"step errors {json.dumps(errs)}; launches a forward "
              f"{out['launches_forward']}, a step {out['launches_step']}; "
              f"median of {PILLAR_STEPS}: forward {out['forward_ms']:.3f} ms "
              f"(peak +{out['forward_peak_gib']:.3f} GiB), forward + "
              f"backward {out['step_ms']:.3f} ms (peak "
              f"+{out['step_peak_gib']:.3f} GiB)")
        return out

    # -- (b) IoU and NMS ---------------------------------------------------

    def _iou_nms(self, torch):
        import numpy as np

        from vlp3d_torch.ops import _kernels
        from vlp3d_torch.ops import iou3d
        from vlp3d_torch.ops.host_time import host_us

        dev = self.device
        host_boxes, host_scores = pillar_boxes(16)
        boxes = torch.from_numpy(host_boxes).to(dev)
        scores = torch.from_numpy(host_scores).to(dev)
        n = boxes.shape[0]
        numbers, rows = {}, {}
        # the path: every count at 0, one IoU matrix and each NMS form
        _kernels.reset_launches()
        iou = iou3d.boxes_iou_bev(boxes, boxes)
        keeps = {(form, th): getattr(iou3d, f"nms_{form}")(boxes, scores, th)
                 for form in ("rotated", "normal") for th in NMS_THRESHOLDS}
        torch.cuda.synchronize()
        numbers["launches"] = dict(_kernels.launches)
        want_launches = dict(ZERO_LAUNCHES, boxes_iou_bev=1,
                             nms_bev=len(keeps))
        if numbers["launches"] != want_launches:
            fail(f"IoU / NMS launches {numbers['launches']}")
        # the IoU against its plain version, the plain run counting the
        # clip's operations for the bound, each timed once by events
        ops_count = []
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        iou_plain = iou3d.boxes_iou_bev_plain(boxes, boxes, ops_count)
        end.record()
        torch.cuda.synchronize()
        iou_plain_ms = start.elapsed_time(end)
        pair_ops = (float(sum(int(o) for o in ops_count))
                    + float(OPS_CORNERS) * 2 * n)
        iou_err = float((iou - iou_plain).abs().max())
        if iou_err > IOU_TOL:
            fail(f"boxes_iou_bev {n} x {n}: kernel against plain {iou_err}")
        over = iou3d.boxes_overlap_bev(boxes, boxes[:256])
        over_err = float(((over - iou3d.boxes_overlap_bev_plain(
            boxes, boxes[:256])).abs() / torch.clamp(over.abs(), min=1.0))
            .max())
        if over_err > IOU_TOL:
            fail(f"boxes_overlap_bev: kernel against plain {over_err} "
                 "(relative above 1)")
        nms = self._nms_checks(torch, boxes, scores, keeps, iou_plain)
        # the other sets: the IoU against plain, every keep mask against
        # the plain scan on the kernel's IoU
        full_sets = iou_box_sets()
        sets = {"uniform": full_sets["uniform"],
                "crowded": full_sets["crowded"],
                **{f"n{k}": pillar_boxes(18 + i, k)
                   for i, k in enumerate(NMS_RAGGED)}}
        errs = {"pillar": iou_err}
        for name, (hb, hs) in sets.items():
            b = torch.from_numpy(hb).to(dev)
            s = torch.from_numpy(hs).to(dev)
            errs[name] = float((iou3d.boxes_iou_bev(b, b)
                                - iou3d.boxes_iou_bev_plain(b, b))
                               .abs().max())
            if errs[name] > IOU_TOL:
                fail(f"boxes_iou_bev {name}: kernel against plain "
                     f"{errs[name]}")
            nms[name] = self._nms_checks(torch, b, s)
        hb, hs = pillar_boxes(20, NMS_LARGE)
        large = (torch.from_numpy(hb).to(dev), torch.from_numpy(hs).to(dev))
        nms[f"n{NMS_LARGE}"] = self._nms_checks(torch, *large)
        numbers["nms"], numbers["iou_errors"] = nms, errs
        numbers["edges"] = self._iou_edges(torch)
        # where the kernels settle each set's pairs (the screens' shares)
        cases = load_test_module("torch_pillar_cases")
        screens = {}
        for name, (hb, _) in full_sets.items():
            b = torch.from_numpy(hb).to(dev)
            screens[name] = cases.stage_shares(b, b)
        numbers["screens"] = screens
        # timing: the main set, the other sets of NMS_BOXES, NMS_LARGE
        th = NMS_THRESHOLDS[0]
        sets_ms = iou_nms_ms(torch, full_sets)
        ms, nms_ms = sets_ms["pillar"]["iou"], sets_ms["pillar"]["nms"]
        numbers["sets_ms"] = sets_ms
        numbers[f"nms_{NMS_LARGE}_ms"] = cuda_ms(
            torch, lambda: iou3d.nms_rotated(*large, th), 3)
        start.record()
        iou3d.nms_rotated_plain(boxes, scores, th)
        end.record()
        torch.cuda.synchronize()
        nms_plain_ms = start.elapsed_time(end)
        iou_bound = bound_ms(4 * 5 * 2 * n + 4 * n * n, pair_ops)
        nms_bound = bound_ms(4 * 5 * n + 8 * n + n + 8 * n * (n + 63) // 64,
                             pair_ops * (n - 1) / n)
        tiny = boxes[:4].contiguous()
        rows["boxes_iou_bev"] = [{
            "site": f"{n} x {n} boxes", "ms": ms, "plain_ms": iou_plain_ms,
            "bound_ms": iou_bound[0], "bound_by": iou_bound[1],
            "library_ms": None, "max_abs_err": max(errs.values()),
            "max_abs_err_sets": errs, "overlap_rel_err": over_err,
            "ops_a_pair": pair_ops / n / n, "screens": screens,
            "sets_ms": {k: v["iou"] for k, v in sets_ms.items()},
            "host_us": host_us(lambda: iou3d.boxes_iou_bev(tiny, tiny))}]
        split = self.profiles.get("nms_rotated", {}).get("expect_split")
        rows["nms_bev"] = [{
            "site": f"{n} boxes, thresh {th}", "ms": nms_ms,
            "plain_ms": nms_plain_ms, "bound_ms": nms_bound[0],
            "bound_by": nms_bound[1], "library_ms": None,
            "max_abs_err": 0.0,
            "split_ms": split or "not measured",
            "sets_ms": {k: v["nms"] for k, v in sets_ms.items()},
            f"ms_{NMS_LARGE}": numbers[f"nms_{NMS_LARGE}_ms"],
            "host_us": host_us(lambda: iou3d.nms_rotated(tiny, scores[:4],
                                                         th))}]
        print(f"[17] boxes_iou_bev {n} x {n} ({pair_ops / n / n:.1f} fp32 "
              f"operations a pair): kernel {ms:.4f} ms, plain "
              f"{iou_plain_ms:.2f}, bound {iou_bound[0]:.5f} "
              f"({iou_bound[1]}), max abs err against plain "
              f"{json.dumps(errs)} (overlap, relative above 1: {over_err}); "
              f"nms_rotated at {th}: kernel {nms_ms:.4f} ms (split "
              f"{json.dumps(split)}), plain {nms_plain_ms:.2f}, bound "
              f"{nms_bound[0]:.5f} ({nms_bound[1]}); by set "
              f"{json.dumps(sets_ms)}, pairs by screen {json.dumps(screens)}; "
              f"nms_rotated at {NMS_LARGE} boxes "
              f"{numbers[f'nms_{NMS_LARGE}_ms']:.4f} ms; "
              f"keep masks {json.dumps(nms)}; "
              f"launches {numbers['launches']}; host us "
              f"{rows['boxes_iou_bev'][0]['host_us']:.1f} / "
              f"{rows['nms_bev'][0]['host_us']:.1f}")
        return rows, numbers

    def _nms_checks(self, torch, boxes, scores, keeps=None, iou_plain=None):
        """nms_rotated and nms_normal at NMS_THRESHOLDS (``keeps``: those
        the path run gave) equal to the plain scan on the kernel's own
        ranked IoU; with ``iou_plain`` (the plain IoU of ``boxes``), also
        to the plain scan on the plain IoU unless a ranked pair lies
        within NMS_TIE of the threshold. Returns the counts kept."""
        from vlp3d_torch.ops import iou3d

        n, out = boxes.shape[0], {}
        order = iou3d.rank_boxes(scores)
        for form in ("rotated", "normal"):
            b = boxes.clone()
            if form == "normal":
                b[:, 4] = 0
            ranked = b[order].contiguous()
            own = iou3d.boxes_iou_bev(ranked, ranked)
            plain = None
            if iou_plain is not None:
                plain = (iou_plain[order][:, order] if form == "rotated"
                         else iou3d.boxes_iou_bev_plain(ranked, ranked))
            for th in NMS_THRESHOLDS:
                keep = (keeps[(form, th)] if keeps is not None
                        else getattr(iou3d, f"nms_{form}")(boxes, scores, th))
                alive = iou3d.nms_scan_plain(own, th)
                want = torch.zeros_like(alive)
                want[order] = alive
                if not torch.equal(keep, want):
                    fail(f"nms_{form} {th} ({n} boxes): kernel keep mask "
                         "differs from the plain scan on the kernel's IoU")
                entry = {"kept": int(keep.sum())}
                if plain is not None:
                    eye = torch.eye(n, dtype=torch.bool, device=boxes.device)
                    near = ((plain - th).abs() < NMS_TIE) & ~eye
                    differ = ((own > th) != (plain > th)) & ~eye
                    if (differ & ~near).any():
                        fail(f"nms_{form} {th}: a decision away from the "
                             "threshold differs between kernel and plain IoU")
                    alive_p = iou3d.nms_scan_plain(plain, th)
                    want_p = torch.zeros_like(alive_p)
                    want_p[order] = alive_p
                    if not differ.any() and not torch.equal(keep, want_p):
                        fail(f"nms_{form} {th}: keep mask differs from plain "
                             "NMS on the plain IoU")
                    entry.update(
                        near_pairs=int(near.sum()),
                        differing_decisions=int(differ.sum()),
                        equal_to_plain_nms=bool(torch.equal(keep, want_p)))
                out[f"{form}_{th}"] = entry
            del own, plain
        return out

    def _iou_edges(self, torch):
        """The degenerate boxes of tests/torch_pillar_cases.py (edge_boxes,
        and overflow_boxes, whose clips pass 8 vertices: the kernels'
        16-slot path), tied scores and N = 1, 63, 64, 65: the IoU within
        IOU_TOL of the plain version (relative above 1: a zero union gives
        2e8), NMS equal to the plain scan on the kernel's IoU; the pairs
        past 8 vertices counted by the plain clip on the card."""
        import numpy as np

        from vlp3d_torch.ops import iou3d

        cases = load_test_module("torch_pillar_cases")
        rng = np.random.default_rng(5)
        sets = {"edges": cases.edge_boxes(),
                "overflow": cases.overflow_boxes(),
                **{f"n{n}": cases.bev_boxes(n, n, spread=4.0)
                   for n in (1, 63, 64, 65)}}
        out, past8 = {}, {}
        for name, host in sets.items():
            b = torch.from_numpy(host).to(self.device)
            n = b.shape[0]
            sc = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)
                                  ).to(self.device)
            sc[n // 2:] = sc[0].clone()  # ties
            iou = iou3d.boxes_iou_bev(b, b)
            want = iou3d.boxes_iou_bev_plain(b, b)
            err = float(((iou - want).abs() / torch.clamp(want.abs(),
                                                          min=1.0)).max())
            if err > IOU_TOL:
                fail(f"boxes_iou_bev {name}: {err} from the plain version")
            past8[name] = int((cases.max_clip_counts(b, b) > 8).sum())
            order = iou3d.rank_boxes(sc)
            for form in ("rotated", "normal"):
                r = b.clone()
                if form == "normal":
                    r[:, 4] = 0
                r = r[order].contiguous()
                for th in NMS_THRESHOLDS:
                    keep = getattr(iou3d, f"nms_{form}")(b, sc, th)
                    alive = iou3d.nms_scan_plain(iou3d.boxes_iou_bev(r, r),
                                                 th)
                    want_k = torch.zeros_like(alive)
                    want_k[order] = alive
                    if not torch.equal(keep, want_k):
                        fail(f"nms_{form} {name} {th}: keep mask differs")
            out[name] = err
        print(f"[17] IoU / NMS edge cases (identical, edge-sharing, nested, "
              f"zero-area, angles at multiples of pi / 2, near-coincident "
              f"squares, tied scores, N = 1, 63, 64, 65): IoU errors "
              f"{json.dumps(out)}, keep masks equal; pairs whose clip passes "
              f"8 vertices (the 16-slot path) {json.dumps(past8)}")
        return {"errors": out, "pairs_past_8": past8}

    # -- (c) the multiview hdf5 without h5py --------------------------------

    def _hdf5(self, torch):
        """The loader's batches through --multiview_hdf5 (the port's own
        stand-ins) against the baked npy's, bit for bit; the committed
        h5py-written fixtures held to their formula."""
        import tempfile

        import numpy as np

        from vlp3d_torch.data import dataset as data
        from vlp3d_torch.data.hdf5 import read_datasets
        from vlp3d_torch.data.standins import write_standin_assets
        from vlp3d_torch.data.tokenizer import load_tokenizer

        try:
            import h5py  # noqa: F401
            has_h5py = True
        except ImportError:
            has_h5py = False
        tmp = tempfile.TemporaryDirectory()
        paths = write_standin_assets(tmp.name)
        hdf5 = os.path.join(paths["multiview_nomv_data"],
                            "enet_feats_maxpool.hdf5")
        tsv = os.path.join(tmp.name, "labels.tsv")
        with open(tsv, "w") as f:
            f.write("id\traw_category\tcategory\tcount\tnyu40id\teigen13id"
                    "\tnyuClass\tnyu40class\n2\tchair\tchair\t10\t5\t6\tchair"
                    "\tchair\n3\ttable\ttable\t10\t7\t10\ttable\ttable\n")
        with open(os.path.join(paths["scanrefer_dir"],
                               "ScanRefer_filtered_val.json")) as f:
            anns = json.load(f)
        tok = load_tokenizer(os.path.join(paths["bert_dir"], "vocab.txt"))

        def batches(scene_dir, hdf5):
            import random

            random.seed(3)
            ds = data.ScanReferJointDataset(
                anns, data.DirectorySceneSource(scene_dir,
                                                multiview_hdf5=hdf5),
                tok, split="val", num_points=40000, lang_num_max=2,
                augment=True, shuffle=True,
                raw2label=data.load_raw2label(tsv),
                nyu40id2class=data.build_nyu40id2class(tsv), seed=9)
            return list(data.BatchIterator(ds, 2, epoch=0, drop_last=False,
                                           num_workers=2,
                                           rng=np.random.default_rng(0)))

        baked = batches(paths["scannet_data"], None)
        got = batches(paths["multiview_nomv_data"], hdf5)
        tmp.cleanup()
        if len(got) != len(baked) or not got:
            fail(f"--multiview_hdf5 loader: {len(got)} batches, baked "
                 f"{len(baked)}")
        for w, g in zip(baked, got):
            for k, v in w.items():
                if isinstance(v, list):
                    same = g[k] == v
                else:
                    v, gk = np.asarray(v), np.asarray(g[k])
                    same = gk.dtype == v.dtype and np.array_equal(gk, v)
                if not same:
                    fail(f"--multiview_hdf5 batch {k} differs from the "
                         "baked npy's")
        fx = load_test_module("torch_write_hdf5_fixtures")
        fixtures = {}
        for name in sorted(fx.LAYOUTS):
            t0 = time.perf_counter()
            sets = read_datasets(os.path.join(fx.FIXTURES, name))
            if list(sets) != [fx.fixture_name(i) for i in range(fx.COUNT)] \
                    or not all(np.array_equal(sets[fx.fixture_name(i)],
                                              fx.fixture_value(i))
                               for i in range(fx.COUNT)):
                fail(f"the h5py-written fixture {name} read wrong")
            fixtures[name] = {"datasets": len(sets),
                              "ms": (time.perf_counter() - t0) * 1e3}
        out = {"batches": len(got), "h5py_installed": has_h5py,
               "fixtures": fixtures, "cli": self.cli_numbers}
        print(f"[17] --multiview_hdf5 loader (the port's stand-ins, 40000 "
              f"points): {len(got)} batches equal to the baked npy's bit for "
              f"bit; h5py installed here: {has_h5py}; h5py-written fixtures "
              f"read and held to their formula: {json.dumps(fixtures)}")
        return out


# what the IoU, NMS and hard voxelization rows add to the kernels line:
# the errors of every box set, the pairs' shares by screen, each set's ms
# and NMS_LARGE's, the NMS and hard_voxelize traces' split by CUDA
# function, and the hard_voxelize call's device operations and memsets
PILLAR_ROW_EXTRAS = ("max_abs_err_sets", "overlap_rel_err", "ops_a_pair",
                     "screens", "sets_ms", f"ms_{NMS_LARGE}", "split_ms",
                     "device_ops", "memsets")


def pillar_kernel_rows(rows, numbers):
    """The four PointPillars kernels' entries of the {"kernels": ...}
    line; launches are those of phase 17's main-path runs."""
    sources = {
        "dynamic_voxelize": ("vlp3d_torch/csrc/voxelize.cu",
                             "vlp3d/ops/voxelize.py:26"),
        "hard_voxelize": ("vlp3d_torch/csrc/voxelize.cu",
                          "vlp3d/ops/voxelize.py:38"),
        "boxes_iou_bev": ("vlp3d_torch/csrc/iou3d.cu",
                          "vlp3d/ops/iou3d.py:106"),
        "nms_bev": ("vlp3d_torch/csrc/iou3d.cu", "vlp3d/ops/iou3d.py:116"),
    }
    enc, iou = numbers["encoder"], numbers["nms"]["launches"]
    out = []
    for name, (source, replaces) in sources.items():
        functions = PILLAR_FUNCTIONS[name]
        r = rows[name][0]
        launches = {"pillar_forward": enc["launches_forward"][name],
                    "pillar_step": enc["launches_step"][name],
                    "iou_nms": iou[name]}
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            **{f"launches_{k}": v for k, v in launches.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "host_us": r["host_us"], "kernel_functions": functions,
            "site": r["site"],
            **{k: r[k] for k in PILLAR_ROW_EXTRAS if k in r}})
    return out


def check_kernel_functions(kernels) -> None:
    """Fail unless every CUDA function a row of the kernels line names
    is a kernel of the library built from the row's source: its mangled
    name (``<length><identifier>``, anonymous namespace and template
    arguments aside) is in the library the run loaded."""
    from pathlib import Path

    from vlp3d_torch.ops import _kernels

    for k in kernels:
        data = _kernels.lib_path(Path(k["source"]).stem).read_bytes()
        for fn in k["kernel_functions"]:
            ident = fn.split("<")[0].strip()
            if f"{len(ident)}{ident}".encode() not in data:
                fail(f"kernel {k['name']} names {fn}, which "
                     f"{k['source']}'s library does not hold")
    print(f"[18] the kernel functions of all {len(kernels)} rows found in "
          "their libraries")


def pillar_traces() -> dict:
    """Phase 17's traces (PillarsPhase.trace) from a process of its own,
    which prints them; its last line is their numbers."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--pillar-traces"],
        cwd=REPO, env=child_env(), capture_output=True, text=True,
        timeout=300)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0:
        print(proc.stdout)
        fail(f"the PointPillars trace process exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    print("\n".join(lines[:-1]))
    stamp("17", "PointPillars traces")
    return json.loads(lines[-1])


def free_port() -> int:
    """A free port on 127.0.0.1 for a rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class DataParallelPhase:
    """Phase 13 in this process: the data-parallel path at world size 1
    over NCCL. The process group and the serving check over make_mesh(0)
    run while the CLI processes run; :meth:`drive` builds the two train
    models (so that no other phase's memory holds them), checks the
    data-parallel step against the one-process step, times both and
    drives the servers, with the card to itself."""

    def __init__(self, torch, smi, scenes, ground_state, train_host):
        import torch.distributed as dist

        from vlp3d_torch.parallel import distributed as du

        self.smi, self.train_host = smi, train_host
        # the process group: an explicit rendezvous of one process; NCCL
        # builds its communicator at the first collective
        t0 = time.perf_counter()
        ctx = du.dist_init(f"127.0.0.1:{free_port()}", 1, 0)
        init_ms = (time.perf_counter() - t0) * 1e3
        if dist.get_backend() != "nccl":
            fail(f"the process group runs over {dist.get_backend()}, not "
                 "NCCL")
        t0 = time.perf_counter()
        du.barrier()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        self.numbers = {"init_process_group_ms": init_ms,
                        "first_collective_ms": first_ms}
        print(f"[13] dist_init(world size 1, {ctx}) over NCCL: "
              f"init_process_group {init_ms:.3f} ms, first collective (the "
              f"NCCL communicator) {first_ms:.3f} ms ({smi})")
        self.numbers["serving"] = self.check_serving(torch, scenes,
                                                     ground_state)
        stamp("13", "process group and mesh serving")

    def build(self, torch):
        """Phase 6's model and batch, twice: for the one-process step and
        for the data-parallel path (a BatchShard over the group)."""
        from vlp3d_torch.config import Config, ModelConfig
        from vlp3d_torch.models import JointNet
        from vlp3d_torch.parallel import LOCAL, BatchShard
        from vlp3d_torch.train import (
            batch_to_device,
            make_optimizer,
            make_train_step,
        )
        from vlp3d_torch.train.schedules import cosine_lr

        t0 = time.perf_counter()
        self.config = Config(model=ModelConfig(use_con=True, no_caption=True))
        self.paths = {}
        for name, shard in (("one", LOCAL), ("dp", BatchShard.of_group())):
            model = JointNet(self.config)
            with torch.no_grad():  # phase 6's nudges
                model.vgen.conv3.weight.mul_(0.05)
                model.vgen.conv3.bias.mul_(0.05)
                model.proposal.proposal.box_predictor.bias.fill_(-1.0)
            opt = make_optimizer(
                model, lr_schedule=lambda e, lr0: cosine_lr(e, lr0, 200),
                steps_per_epoch=100)
            self.paths[name] = (model, make_train_step(
                model, self.config, opt, shard=shard))
        device = next(self.paths["one"][0].parameters()).device
        self.batch = batch_to_device(self.train_host, device)
        print(f"[13] the one-process and data-parallel train models built "
              f"in {time.perf_counter() - t0:.1f} s")

    def check_serving(self, torch, scenes, ground_state):
        """GroundingPredictor over make_mesh(0) (every local card: one
        here) against the one-device predictor on phase 5's first batch,
        and run_padded at occupancy 3."""
        import numpy as np

        from vlp3d_torch.config import Config, ModelConfig
        from vlp3d_torch.parallel.mesh import make_mesh
        from vlp3d_torch.serving import GroundingPredictor

        config = Config(model=ModelConfig(use_con=False, no_caption=True))
        mesh = make_mesh(0)
        one = GroundingPredictor(config, ground_state, batch_size=B)
        many = GroundingPredictor(config, ground_state, batch_size=B,
                                  devices=mesh)
        occ = {k: v[:3] for k, v in scenes[0].items()}
        errs, same = [], []
        for got, want in ((many([scenes[0]])[0], one([scenes[0]])[0]),
                          (many.run_padded(occ), one.run_padded(occ))):
            same.append(bool(np.array_equal(got["pred_ref"],
                                            want["pred_ref"])))
            errs.append(float(np.abs(got["cluster_ref"]
                                     - want["cluster_ref"]).max()))
        print(f"[13] GroundingPredictor over make_mesh(0) = {mesh} against "
              f"one device, phase 5's first batch and run_padded at "
              f"occupancy 3: pred_ref equal {same}, cluster_ref max abs err "
              f"{errs}")
        if not all(same) or max(errs) > CLUSTER_REF_TOL:
            fail("the mesh predictor differs from the one-device one")
        del one, many
        torch.cuda.empty_cache()
        return {"devices": [str(d) for d in mesh], "pred_ref_equal": True,
                "cluster_ref_err": max(errs)}

    def check_parity(self, torch):
        """The data-parallel step against the one-process step from the
        same state and generator seed: the one-process run first,
        recording every ReLU input, then the data-parallel run following
        its side of 0 (the global sums add in another order); a moved unit
        within FLIP_TOL of 0, the loss within STEP_LOSS_RTOL, the DP_PROBE
        gradients (the ones the update used) and every BatchNorm running
        statistic within STEP_GRAD_TOL of the tensor's largest entry, and
        the launches of a step equal, PER_STEP each."""
        from vlp3d_torch import ops

        (m1, s1), (m2, s2) = self.paths["one"], self.paths["dp"]
        dev = self.batch["point_clouds"].device
        ops.reset_launches()
        with kinks(m1) as (pre, _):
            r1 = s1(self.batch, torch.Generator(device=dev).manual_seed(0))
        one_launches = dict(ops.launches)
        ops.reset_launches()
        with kinks(m2, follow=pre) as (_, moved):
            r2 = s2(self.batch, torch.Generator(device=dev).manual_seed(0))
        dp_launches = dict(ops.launches)
        del pre
        for name, (units, near) in moved.items():
            if near > FLIP_TOL:
                fail(f"data-parallel step: {units} ReLU inputs of {name}, "
                     f"up to {near} from 0, decided differently")
        loss_rel = abs(r2["loss"].item() - r1["loss"].item()) / abs(
            r1["loss"].item())
        metric_err = max(abs(r2[k].item() - r1[k].item()) for k in r1)
        grads = {}
        for n in DP_PROBE:
            g1, g2 = m1.get_parameter(n).grad, m2.get_parameter(n).grad
            grads[n] = ((g2 - g1).abs().max() / g1.abs().max().clamp(
                min=1e-30)).item()
        bn = 0.0
        b2 = dict(m2.named_buffers())
        for n, v in m1.named_buffers():
            if n.endswith(("running_mean", "running_var")):
                bn = max(bn, ((b2[n] - v).abs().max() / v.abs().max().clamp(
                    min=1e-30)).item())
        worst = max(grads.values())
        print(f"[13] data-parallel step (world size 1, NCCL) against the "
              f"one-process step on phase 6's batch: loss {r2['loss'].item()}"
              f" vs {r1['loss'].item()} (relative {loss_rel}), largest "
              f"metric difference {metric_err}; gradient difference of each "
              f"probe, of its largest entry: {grads}; BatchNorm running "
              f"statistics within {bn} of their largest entry; ReLU inputs "
              f"that followed the one-process run {moved}; launches of a "
              f"step {dp_launches} (one process {one_launches})")
        if loss_rel > STEP_LOSS_RTOL or worst > STEP_GRAD_TOL \
                or bn > STEP_GRAD_TOL:
            fail("the data-parallel step differs from the one-process step")
        if one_launches != PER_STEP or dp_launches != one_launches:
            fail(f"launches of a step: data-parallel {dp_launches}, one "
                 f"process {one_launches}, want {PER_STEP}")
        return {"loss_rel": loss_rel, "grad_err": worst, "bn_err": bn,
                "metric_err": metric_err,
                "relu_followed": {k: v[0] for k, v in moved.items()}}

    def drive(self, torch, http_phase):
        """With the card to itself: the two models, the parity check, then
        DP_STEPS timed steps of each path in turns (one process, data parallel, data parallel, one process, ...)
        after one warm-up each, with every count at 0 before each step;
        peak memory above what is resident; a trace of a step of each;
        then the serve CLI over --data_devices 0 and 2. Returns (the data-parallel steps' launch
        counts, this phase's numbers)."""
        import numpy as np

        from vlp3d_torch import ops
        from vlp3d_torch.parallel import distributed as du

        self.build(torch)
        self.numbers["parity"] = self.check_parity(torch)
        dev = self.batch["point_clouds"].device
        gens = {k: torch.Generator(device=dev).manual_seed(1)
                for k in self.paths}
        times = {k: [] for k in self.paths}
        peaks = {k: 0.0 for k in self.paths}
        launches = {k: {} for k in self.paths}
        for i in range(DP_STEPS + 1):
            for name in (("one", "dp") if i % 2 == 0 else ("dp", "one")):
                _, step = self.paths[name]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                ops.reset_launches()
                t0 = time.perf_counter()
                metrics = step(self.batch, gens[name])
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                for k, v in ops.launches.items():
                    launches[name][k] = launches[name].get(k, 0) + v
                if not np.isfinite(metrics["loss"].item()):
                    fail(f"{name} step {i}: loss {metrics['loss'].item()}")
                if i:
                    times[name].append(dt)
                    peaks[name] = max(peaks[name], (
                        torch.cuda.max_memory_allocated() - resident) / 2**30)
        steps = DP_STEPS + 1
        for name, counts in launches.items():
            if counts != {k: v * steps for k, v in PER_STEP.items()}:
                fail(f"{name} launches over {steps} steps: {counts}")
        med = {k: float(np.median(v)) for k, v in times.items()}
        print(f"[13] train step at B={B}, N={N}, median of {DP_STEPS} in "
              f"turns: data parallel {med['dp']:.3f} ms, one process "
              f"{med['one']:.3f} ms (x{med['dp'] / med['one']:.4f}); peak "
              f"memory above the resident models {peaks['dp']:.3f} GiB "
              f"against {peaks['one']:.3f} GiB; every step "
              f"{ {k: [round(x, 3) for x in v] for k, v in times.items()} } "
              f"({self.smi})")
        self.numbers.update(
            step_ms=med["dp"], one_process_step_ms=med["one"],
            peak_gib=peaks["dp"], one_process_peak_gib=peaks["one"])
        # where the data-parallel step's extra time goes: both traced
        for name, what in (("dp", "data-parallel"), ("one", "one-process")):
            step = self.paths[name][1]
            profile_call(torch, lambda: step(self.batch, gens[name]), "13",
                         f"{what} train step", top=25)
        self.numbers["server"] = self.check_server(torch, http_phase)
        du.dist_close()
        for model, _ in self.paths.values():
            model.zero_grad(set_to_none=True)
        del self.paths, self.batch
        torch.cuda.empty_cache()
        stamp("13", "data parallel")
        return launches["dp"], self.numbers

    def check_server(self, torch, http_phase):
        """build_server with --data_devices 0 answers phase 9's first
        request as phase 9's server did; --data_devices 2 exits, naming
        the one card."""
        import threading

        from vlp3d_torch.cli import serve as serve_cli

        argv = ["--use_multiview", "--use_normal", "--serve_batch_size",
                str(B), "--port", "0", "--no_warmup"]
        args, tasks = serve_cli.parse_args(argv + ["--data_devices", "0"])
        server, services = serve_cli.build_server(args, tasks)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            t0 = time.perf_counter()
            code, ans = _post(server.server_address[1], "/v1/ground",
                              http_phase.bodies[0])
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            server.shutdown()
            server.server_close()
            for svc in services.values():
                svc.close()
            thread.join(timeout=30)
        n, ref = http_phase.refs[0]
        got = [b["proposal"] for b in ans.get("boxes", [])]
        want = [int(ref["pred_ref"][0, q]) for q in range(n)]
        devices = [str(d) for d in services["ground"]._pred.devices]
        print(f"[13] serve CLI --data_devices 0 over {devices}: /v1/ground "
              f"{code} in {ms:.3f} ms, proposals {got}, phase 9's server "
              f"{want}")
        if code != 200 or got != want:
            fail("the --data_devices 0 server answers otherwise than phase "
                 "9's")
        args, tasks = serve_cli.parse_args(argv + ["--data_devices", "2"])
        try:
            serve_cli.build_server(args, tasks)
        except SystemExit as e:
            msg = str(e)
        else:
            fail("--data_devices 2 did not exit")
        print(f"[13] serve CLI --data_devices 2: exits with {msg!r}")
        if "exposes 1 device" not in msg:
            fail(f"--data_devices 2 exited with {msg!r}")
        return {"devices": devices, "request_ms": ms, "proposals_equal": True,
                "data_devices_2": msg}


# ---------------------------------------------------------------- phase 14


def _path_model(torch, config, device, data, *, zero1=False, model=None):
    """Phase 6's model from its seed and nudges with its train step:
    data parallel over ``data`` (a BatchShard), ZeRO-1's optimizer with
    ``zero1``, split over the model group ``model`` (tensor parallel)."""
    from vlp3d_torch.models import JointNet
    from vlp3d_torch.parallel import LOCAL
    from vlp3d_torch.parallel.tensor_parallel import shard_model
    from vlp3d_torch.parallel.zero import ShardedAdam
    from vlp3d_torch.train import make_optimizer, make_train_step
    from vlp3d_torch.train.schedules import cosine_lr

    net = JointNet(config, device=device)
    with torch.no_grad():
        net.vgen.conv3.weight.mul_(0.05)
        net.vgen.conv3.bias.mul_(0.05)
        net.proposal.proposal.box_predictor.bias.fill_(-1.0)
    if model is not None:
        shard_model(net, model)
    opt = make_optimizer(
        net, lr_schedule=lambda e, lr0: cosine_lr(e, lr0, 200),
        steps_per_epoch=100)
    if zero1 or model is not None:
        opt = ShardedAdam(opt, net, data if zero1 else LOCAL)
    return net, opt, make_train_step(net, config, opt, shard=data)


class OneProcessRecord:
    """The one-process step on the global batch, recorded once for every
    mode of a parity check: the loss and metrics, the DP_PROBE gradients,
    the BatchNorm statistics after it, every ReLU input, every max pool's
    choice and every SA module's sampled indices (each mode's step follows
    them in its own rows)."""

    def __init__(self, torch, config, device, full):
        from vlp3d_torch.parallel import LOCAL

        model, _, step = _path_model(torch, config, device, LOCAL)
        with kinks(model) as (pre, _), pool_ties(model) as (pools, _), \
                index_ties(model) as (inds, _):
            self.metrics = step(full, torch.Generator(device=device)
                                .manual_seed(0))
        self.kinks, self.pools, self.indices = pre, pools, inds
        self.grads = {n: model.get_parameter(n).grad.clone() for n in DP_PROBE}
        self.stats = {n: v.clone() for n, v in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}
        del model


def follow_step(torch, ref, step, model, batch, shard, device):
    """One step of a parallel mode from phase 6's seeded state on this
    rank's rows (``shard``'s), following ``ref``'s ReLU inputs and max
    pools in those rows (and in its columns of a column-split layer);
    returns its parity numbers against ``ref`` and the launches of the
    step."""
    from vlp3d_torch import ops
    from vlp3d_torch.parallel.tensor_parallel import (
        ColumnParallelLinear,
        full_tensor,
    )

    def own(name, t):
        """This rank's rows, and its columns of a column-split layer's
        output."""
        t = shard.own(t)
        mod = model.get_submodule(name)
        if isinstance(mod, ColumnParallelLinear):
            n = t.shape[-1] // mod.split.world
            t = t.narrow(-1, mod.split.rank * n, n)
        return t

    follow = {k: [own(k, t) for t in v] for k, v in ref.kinks.items()}
    follow_pools = {k: [shard.own(t) for t in v] for k, v in ref.pools.items()}
    follow_inds = {k: [tuple(shard.own(t) for t in rec) for rec in v]
                   for k, v in ref.indices.items()}
    ops.reset_launches()
    with kinks(model, follow=follow) as (_, moved), \
            pool_ties(model, follow=follow_pools) as (_, pooled), \
            index_ties(model, follow=follow_inds) as (_, resampled):
        got = step(batch, torch.Generator(device=device).manual_seed(0))
    launches = dict(ops.launches)
    del follow, follow_pools, follow_inds
    near = max([v[1] for v in moved.values()]
               + [v[1] for v in pooled.values()], default=0.0)
    r1 = ref.metrics
    grads = {}
    for n in DP_PROBE:
        p = model.get_parameter(n)
        g = full_tensor(p.grad, p)
        grads[n] = ((g - ref.grads[n]).abs().max()
                    / ref.grads[n].abs().max().clamp(min=1e-30)).item()
    bufs = dict(model.named_buffers())
    bn = max(((bufs[n] - v).abs().max() / v.abs().max().clamp(min=1e-30))
             .item() for n, v in ref.stats.items())
    return {
        "loss_rel": abs(got["loss"].item() - r1["loss"].item())
        / abs(r1["loss"].item()),
        "metric_err": max(abs(got[k].item() - r1[k].item()) for k in r1),
        "grad_err": max(grads.values()), "bn_err": bn, "near": near,
        "relu_followed": {k: v[0] for k, v in moved.items()},
        "pool_followed": {k: v[0] for k, v in pooled.items()},
        "indices_followed": {k: v[0] for k, v in resampled.items()},
        "index_gap": max([v[1] for v in resampled.values()], default=0.0),
        "launches": launches}


@contextlib.contextmanager
def sa1_capture(model):
    """While open, keep SA1's first call of a training step: its grouped
    input, the weights it ran with (the step then moves them) and the
    gradient that reaches its output. Yields that dict."""
    sa1 = model.backbone_net.sa1
    kept = {}

    def capture(grouped):
        first = "grouped" not in kept
        if first:
            kept["weights"] = {k: v.detach().clone()
                               for k, v in sa1.state_dict().items()}
            kept["grouped"] = grouped.detach()
        out = type(sa1).group_precomputed(sa1, grouped)
        if first:
            out.register_hook(
                lambda g: kept.setdefault("dout", g.detach().clone()))
        return out

    sa1.group_precomputed = capture
    try:
        yield kept
    finally:
        del sa1.group_precomputed


def sa1_replay(torch, kept, dout, chunks, dtype, follow=None):
    """SA1's shared MLP and max pool (``SAModule.group_precomputed``'s
    arithmetic) on ``sa1_capture``'s grouped input and weights, backward
    from ``dout``, in ``dtype``, with the rows in ``chunks`` parts as
    ranks hold them: each part's BatchNorm sums and weight-gradient sums
    taken apart and added in part order (``chunks`` 1: the one-process
    BatchNorm's means). With ``follow`` (another replay's record) every
    ReLU and the max pool take that replay's decisions, so only the
    arithmetic differs. Returns (the first layer's weight gradient (out,
    in) in float64, the parts' shares added in part order; the record,
    whose "parts" holds each part's share)."""
    import torch.nn.functional as F

    from vlp3d_torch.models.layers import BatchNorm

    wts = kept["weights"]
    parts = list(kept["grouped"].to(dtype).chunk(chunks))
    record = {"relu": [], "pool": None}
    first = []
    for j in range(sum(k.endswith(".conv.weight") for k in wts)):
        pre = f"mlp_module.layer{j}."
        w = wts[pre + "conv.weight"].flatten(1).to(dtype).requires_grad_()
        if j == 0:
            # a leaf a part: each part's share of the gradient, as a
            # rank's before the average
            first = [w.detach().clone().requires_grad_() for _ in parts]
            y = [F.linear(t[..., 3:], v[:, 3:]) + F.linear(t[..., :3],
                                                            v[:, :3])
                 for t, v in zip(parts, first)]
        else:
            y = [F.linear(t, w) for t in parts]
        dims = tuple(range(y[0].dim() - 1))
        if chunks == 1:
            mean, mean_sq = y[0].mean(dims), (y[0] * y[0]).mean(dims)
        else:
            count = sum(t.numel() // t.shape[-1] for t in y)
            sums = torch.stack([y[0].sum(dims), (y[0] * y[0]).sum(dims)])
            for t in y[1:]:
                sums = sums + torch.stack([t.sum(dims), (t * t).sum(dims)])
            mean, mean_sq = sums[0] / count, sums[1] / count
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        mul = torch.rsqrt(var + BatchNorm.eps) * wts[
            pre + "bn.bn.weight"].to(dtype)
        z = [(t - mean) * mul + wts[pre + "bn.bn.bias"].to(dtype)
             for t in y]
        keep = (torch.cat([t.detach() for t in z]) > 0 if follow is None
                else follow["relu"][j])
        record["relu"].append(keep)
        parts = [torch.where(k, t, 0.0)
                 for t, k in zip(z, keep.chunk(chunks))]
    x = torch.cat(parts)
    if follow is None:
        top = x.detach().amax(dim=2, keepdim=True)
        hit = (x.detach() == top).to(dtype)
        record["pool"] = hit / hit.sum(dim=2, keepdim=True)
    pool = record["pool"] if follow is None else follow["pool"]
    (x * pool.to(dtype)).sum(dim=2).backward(dout.to(dtype))
    record["parts"] = [v.grad.double() for v in first]
    total = first[0].grad
    for v in first[1:]:
        total = total + v.grad
    return total.double(), record


def sa1_order_witness(torch, config, device, batch) -> dict:
    """SA1's first-layer weight gradient under other arithmetics of its
    own sums and under a rounding-sized change of the gradient reaching
    it, on one card: the one-process step on ``batch`` is run once under
    ``sa1_capture``, and SA1 alone is replayed on what it kept (every
    ReLU and max-pool decision the first replay's): in float32 with the
    rows in one part, in four parts of two rows (four ranks' order of
    the BatchNorm and weight-gradient sums), in float64, and with every
    entry of the output gradient moved by a seeded relative 1e-5. Each
    difference is of the float64 gradient's largest entry."""
    from vlp3d_torch.parallel import LOCAL

    model, _, step = _path_model(torch, config, device, LOCAL)
    with sa1_capture(model) as kept:
        step(batch, torch.Generator(device=device).manual_seed(0))
    g_step = model.get_parameter(
        "backbone_net.sa1.mlp_module.layer0.conv.weight").grad.flatten(1)
    dout = kept["dout"]
    g1, rec = sa1_replay(torch, kept, dout, 1, torch.float32)
    g4, _ = sa1_replay(torch, kept, dout, 4, torch.float32, rec)
    g64, _ = sa1_replay(torch, kept, dout, 1, torch.float64, rec)
    noise = torch.randn(dout.shape, generator=torch.Generator(
        device=device).manual_seed(5), device=device)
    g_moved, _ = sa1_replay(torch, kept, dout * (1 + 1e-5 * noise), 1,
                            torch.float32, rec)
    scale = g64.abs().max().clamp(min=1e-300)

    def rel(a, b):
        return float((a - b).abs().max() / scale)

    out = {"rows": kept["grouped"].shape[0], "parts": 4,
           "replay_vs_step": rel(g1, g_step.double()),
           "four_parts_vs_one": rel(g4, g1),
           "one_part_vs_float64": rel(g1, g64),
           "four_parts_vs_float64": rel(g4, g64),
           "median_four_parts_vs_one": float(
               (g4 - g1).abs().median() / scale),
           "output_gradient_moved_1e-5": rel(g_moved, g1)}
    del model, step, kept, rec
    return out


def sa1_upstream_witness(torch, shard, kept1, kept2, m1, m2) -> dict:
    """Where the data-parallel step's SA1 first-layer gradient parts from
    the one-process step's: SA1 alone replayed (``sa1_replay``) on the
    one-process run's input and weights with that run's output gradient
    and with the data-parallel run's (every rank's rows in rank order,
    divided by W: each rank's rows carry W times their share, reduce.py's
    convention), in one part, in W parts (the ranks' order) and in
    float64; the entries that differ most; and this rank's gradient
    before the average (``kept2["local"]``, divided by W) against its
    part's share in the W-part replay. Gradient differences are of the
    one-process gradient's largest entry, the output gradients' of the
    one-process one's largest entry. A collective: every rank calls it;
    the per-rank numbers come back in rank order."""
    import torch.distributed as dist

    w = shard.world
    douts = [torch.empty_like(kept2["dout"]) for _ in range(w)]
    dist.all_gather(douts, kept2["dout"].contiguous(), group=shard.group)
    dout_dp = torch.cat(douts) / w
    dout_one = kept1["dout"]
    f32, f64 = torch.float32, torch.float64
    g_one, rec = sa1_replay(torch, kept1, dout_one, 1, f32)
    g_up, _ = sa1_replay(torch, kept1, dout_dp, 1, f32, rec)
    g_up_w, rec_w = sa1_replay(torch, kept1, dout_dp, w, f32, rec)
    g_up64, _ = sa1_replay(torch, kept1, dout_dp, 1, f64, rec)
    g_one64, _ = sa1_replay(torch, kept1, dout_one, 1, f64, rec)
    name = "backbone_net.sa1.mlp_module.layer0.conv.weight"
    g1 = m1.get_parameter(name).grad.flatten(1).double()
    g2 = m2.get_parameter(name).grad.flatten(1).double()
    scale = g1.abs().max().clamp(min=1e-300)

    def rel(a, b):
        return float((a - b).abs().max() / scale)

    top = (g2 - g1).abs().flatten().topk(3).indices.tolist()
    cols = g1.shape[1]
    mine = rel(kept2["local"] / w, rec_w["parts"][shard.rank])
    ranks = [None] * w
    dist.all_gather_object(ranks, mine, group=shard.group)
    return {"output_gradient_diff": float(
                (dout_dp - dout_one).abs().max()
                / dout_one.abs().max().clamp(min=1e-30)),
            "step_dp_vs_one": rel(g2, g1),
            "replay_vs_one": rel(g_one, g1),
            "replay_dp_output_gradient_vs_one": rel(g_up, g1),
            "replay_dp_output_gradient_vs_dp": rel(g_up, g2),
            "replay_dp_output_gradient_parts_vs_dp": rel(g_up_w, g2),
            "replay_float64_dp_vs_one_output_gradient": rel(g_up64, g_one64),
            "step_one_vs_float64": rel(g1, g_one64),
            "step_dp_vs_float64": rel(g2, g_up64),
            "rank_local_vs_replay_part": ranks,
            "largest_differences": [
                {"out": i // cols, "in": i % cols,
                 "one": float(g1.flatten()[i]), "dp": float(g2.flatten()[i]),
                 "float64": float(g_up64.flatten()[i])} for i in top]}


def parity_ok(p: dict, cuda: bool) -> bool:
    return (p["loss_rel"] <= STEP_LOSS_RTOL and p["grad_err"] <= STEP_GRAD_TOL
            and p["bn_err"] <= STEP_GRAD_TOL and p["near"] <= FLIP_TOL
            and p["index_gap"] <= INDEX_TIE_TOL
            and (p["launches"] == PER_STEP or not cuda))


def dense_front(torch, xyz, feats, npoint, radius, nsample):
    """SA1's sampling and grouping on the whole cloud (the dense ops)."""
    from vlp3d_torch import ops

    inds = ops.furthest_point_sample(xyz, npoint)
    new_xyz = ops.gather_points(xyz, inds)
    grouped, _ = ops.query_and_group(radius, nsample, xyz, new_xyz, feats,
                                     normalize_xyz=True)
    return new_xyz, grouped, inds


def front_equal(torch, got, want) -> bool:
    return all(g.shape == w.shape and bool(torch.equal(g, w))
               for g, w in zip(got, want))


def point_edge_clouds(torch, device):
    """tests/torch_point_cases.py's clouds on ``device``: the merge's
    (xyz, centres) and the FPS loop's ties and all-invalid row."""
    cases = load_test_module("torch_point_cases")
    xyz, centers = cases.merge_cases()
    return (torch.from_numpy(xyz).to(device),
            torch.from_numpy(centers).to(device),
            torch.from_numpy(cases.fps_cases()).to(device))


def stalled_peer_probe() -> dict:
    """tests/torch_stall_probe.py in a process of its own: a W = 2 launch
    of the FPS loop whose peer never writes must trap at its limit and
    exit 3 (a trap leaves that process's CUDA context unusable, not this
    one's). Run at STALL_LIMIT_S and STALL_SPREAD_S longer: the
    difference of the two times over STALL_SPREAD_S is the rate of the
    card's clock that counts the limit, the rest of the first time the
    trap's way to the host (which varies by a tenth of a second or more
    from run to run, hence the spread)."""
    out = {}
    limits = (STALL_LIMIT_S, STALL_LIMIT_S + STALL_SPREAD_S)
    for limit in limits:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_stall_probe.py"),
             str(limit)], cwd=REPO,
            env=dict(child_env(), PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=300)
        wall = time.perf_counter() - t0
        said = (run.stdout.strip().splitlines() or [""])[-1]
        print(f"[14] a W=2 FPS loop whose peer never writes, limit {limit} "
              f"s: exit {run.returncode} in {wall:.1f} s of process; {said}")
        if run.returncode != 3 or "trapped after" not in said:
            fail(f"the stalled FPS loop did not trap: {run.stdout[-2000:]} "
                 f"{run.stderr[-2000:]}")
        out[str(limit)] = {"rc": run.returncode, "process_s": wall,
                           "said": said, "trapped_s": float(
                               said.split("trapped after ")[1].split()[0])}
    lo, hi = (out[str(x)]["trapped_s"] for x in limits)
    rate = (hi - lo) / STALL_SPREAD_S
    out["clock_rate"] = rate
    out["delivery_s"] = lo - rate * STALL_LIMIT_S
    print(f"[14] the stall limit's clock: {rate:.4f} s a second of limit "
          f"(the two times {STALL_SPREAD_S} s of limit apart); the trap's "
          f"way to the host {lo - rate * STALL_LIMIT_S:.3f} s")
    return out


def check_point_kernels(torch, xyz, feats, sa1):
    """Phase 14's kernel rows: each point-axis kernel against its plain
    version at SA1's shapes (B x N points, W=1, and 2 and 4 ranks
    emulated in one launch or stacked slabs), the edge cases, CUDA-event
    times behind the device sleep, bounds and host us; the stalled-peer
    probe."""
    from vlp3d_torch import ops
    from vlp3d_torch.ops import _kernels
    from vlp3d_torch.ops.host_time import host_us
    from vlp3d_torch.parallel import point_parallel as pp

    b, n, _ = xyz.shape
    npoint, radius, nsample = sa1.npoint, sa1.radius, sa1.nsample
    rows = {}

    # the FPS loop: W=1 against the plain loop and the dense FPS, one
    # launch a call; 2 and 4 ranks emulated in one launch against the
    # dense FPS, at SA1's shapes and on the edge clouds
    def one_launch(call):
        before = _kernels.launches["fps_shard_loop"]
        got = call()
        torch.cuda.synchronize()
        if _kernels.launches["fps_shard_loop"] - before != 1:
            fail("an fps_sharded / fps_emulated call launched the loop "
                 "kernel other than once")
        return got

    whole = one_launch(lambda: pp.fps_sharded(xyz, npoint))
    plain = pp.fps_sharded_plain(xyz, npoint)
    dense = ops.furthest_point_sample(xyz, npoint)
    err = max(index_err(torch, whole, plain), index_err(torch, whole, dense))
    loop_ms = cuda_ms(torch, lambda: pp.fps_sharded(xyz, npoint), reps=20)
    plain_ms = cuda_ms(torch, lambda: pp.fps_sharded_plain(xyz, npoint),
                       reps=1, warmup=0)
    dense_ms = cuda_ms(torch, lambda: ops.furthest_point_sample(xyz, npoint),
                       reps=20)
    edge_err, emulated = 0.0, {}
    _, _, ties = point_edge_clouds(torch, xyz.device)
    tie_want = ops.furthest_point_sample(ties, 24)
    for w in (2, 4):
        for got in one_launch(lambda: pp.fps_emulated(ties, w, 24)):
            edge_err = max(edge_err, index_err(torch, got, tie_want))
        for got in one_launch(lambda: pp.fps_emulated(xyz, w, npoint)):
            edge_err = max(edge_err, index_err(torch, got, dense))
        emulated[f"w{w}_ms"] = cuda_ms(
            torch, lambda: pp.fps_emulated(xyz, w, npoint), reps=5)
    # the streamed form: slabs past registers at W = 1 and 2 (an
    # all-invalid row and a zero tail in each), against the dense FPS
    if pp.loop_plan(STREAM_NL) != (16, 0):
        fail(f"a slab of {STREAM_NL} points does not take the streamed "
             f"form: {pp.loop_plan(STREAM_NL)}")
    gen = torch.Generator(device=xyz.device).manual_seed(14)
    big = torch.rand((2, 2 * STREAM_NL, 3), generator=gen,
                     device=xyz.device) * 6
    big[0] = 0.0  # an all-invalid row
    big[:, STREAM_NL - 2000:STREAM_NL] = 0.0  # a zero tail in slab 0
    slab0 = big[:, :STREAM_NL].contiguous()
    stream_err = index_err(
        torch, one_launch(lambda: pp.fps_sharded(slab0, 256)),
        ops.furthest_point_sample(slab0, 256))
    big_want = ops.furthest_point_sample(big, 256)
    for got in one_launch(lambda: pp.fps_emulated(big, 2, 256)):
        stream_err = max(stream_err, index_err(torch, got, big_want))
    stream_ms = cuda_ms(torch, lambda: pp.fps_sharded(slab0, 256), reps=3)
    stream_dense_ms = cuda_ms(
        torch, lambda: ops.furthest_point_sample(slab0, 256), reps=3)
    if err != 0 or edge_err != 0 or stream_err != 0 or \
            (tie_want[1] != 0).any():
        fail(f"fps_shard_loop differs from its plain loop or the dense FPS: "
             f"{err}, emulated ranks and edge clouds {edge_err}, slabs past "
             f"registers {stream_err}")
    del big, big_want, slab0
    lb, lby = bound_ms(b * n * 12 + b * npoint * 4,
                       (npoint - 1) * b * n * OPS_PER_TEST)
    # npoint dependent steps, each at least the dense cluster FPS's step
    # at the same row length (fps.cu, timed above in this run)
    serial_ms = dense_ms * npoint / (npoint - 1)
    plan = pp.loop_plan(n)
    small = xyz[:1, :4096].contiguous()
    rows["fps_shard_loop"] = [{
        "site": "SA1", "shape": [b, n, npoint], "plan": list(plan),
        "max_abs_err": err, "edge_err": edge_err, "ms": loop_ms,
        "plain_ms": plain_ms, "bound_ms": lb, "bound_by": lby,
        "library_ms": None, "serial_bound_ms": serial_ms,
        "dense_fps_ms": dense_ms, "us_per_step": loop_ms * 1e3 / (npoint - 1),
        **emulated, "stream": {
            "shape": [2, STREAM_NL, 256], "err": stream_err, "ms": stream_ms,
            "dense_fps_ms": stream_dense_ms},
        "host_us": host_us(lambda: pp.fps_sharded(small, 16))}]
    print(f"[14] fps_shard_loop at SA1 ({b} x {n}, W=1, {plan[0]} blocks a "
          f"cluster, {plan[1]} points a thread): {loop_ms:.3f} ms a call in "
          f"one launch ({loop_ms * 1e3 / (npoint - 1):.3f} us a step; bound "
          f"{lb:.4f} ms, {lby}; serial bound {serial_ms:.3f} ms, the dense "
          f"FPS {dense_ms:.3f} ms), plain loop {plain_ms:.1f} ms; emulated "
          f"W=2 / 4 in one launch {emulated['w2_ms']:.3f} / "
          f"{emulated['w4_ms']:.3f} ms; error {err} (plain loop and dense "
          f"FPS); emulated ranks, ties across shards, an all-invalid row "
          f"{edge_err}; streamed form (2 x {STREAM_NL} a slab, 256 "
          f"centres) {stream_ms:.3f} ms at W=1 (the dense FPS "
          f"{stream_dense_ms:.3f} ms), error {stream_err} at W=1 and 2")
    rows["fps_shard_loop"][0]["stall"] = stalled_peer_probe()

    # merge: W=1 at SA1, W=4 emulated, the edge cases
    new_xyz = ops.gather_points(xyz, whole)
    idx, cnt = ops.ball_query_with_count(radius, nsample, xyz, new_xyz)
    all_idx, all_cnt = idx[None].contiguous(), cnt[None].contiguous()
    got = pp.ball_query_merge(all_idx, all_cnt, n, nsample)
    want = pp.ball_query_merge_plain(all_idx, all_cnt, n, nsample)
    dense_idx = ops.ball_query(radius, nsample, xyz, new_xyz)
    err = max(index_err(torch, got, want), index_err(torch, got, dense_idx))
    merge_ms = cuda_ms(torch, lambda: pp.ball_query_merge(
        all_idx, all_cnt, n, nsample), reps=100)
    merge_plain_ms = cuda_ms(torch, lambda: pp.ball_query_merge_plain(
        all_idx, all_cnt, n, nsample), reps=10)
    w4 = pp.ball_query_emulated(radius, nsample, xyz, new_xyz, 4)
    w4_plain = pp.ball_query_emulated(radius, nsample, xyz, new_xyz, 4,
                                      merge=pp.ball_query_merge_plain)
    err = max(err, index_err(torch, w4, dense_idx),
              index_err(torch, w4_plain, dense_idx))
    nl4 = n // 4
    parts = [ops.ball_query_with_count(
        radius, nsample, xyz[:, i * nl4:(i + 1) * nl4].contiguous(), new_xyz)
        for i in range(4)]
    a4 = torch.stack([p[0] for p in parts])
    c4 = torch.stack([p[1] for p in parts])
    err = max(err, index_err(
        torch, pp.ball_query_merge(a4, c4, nl4, nsample),
        pp.ball_query_merge_plain(a4, c4, nl4, nsample)))
    merge4_ms = cuda_ms(torch, lambda: pp.ball_query_merge(
        a4, c4, nl4, nsample), reps=100)
    exyz, ectr, _ = point_edge_clouds(torch, xyz.device)
    edge_err = 0.0
    for w in (2, 4):
        for ns in (2, 8):
            edge_err = max(edge_err, index_err(
                torch, pp.ball_query_emulated(0.5, ns, exyz, ectr, w),
                ops.ball_query(0.5, ns, exyz, ectr)))
    if err != 0 or edge_err != 0:
        fail(f"ball_query_merge differs from its plain version or the dense "
             f"ball query: {err}, edge cases {edge_err}")
    m = new_xyz.shape[1]
    mb, mby = bound_ms(4 * (b * m * nsample * 2 + b * m), 0)
    rows["ball_query_merge"] = [{
        "site": "SA1", "shape": [1, b, m, nsample], "max_abs_err": err,
        "edge_err": edge_err, "ms": merge_ms, "plain_ms": merge_plain_ms,
        "bound_ms": mb, "bound_by": mby, "library_ms": None,
        "w4_ms": merge4_ms,
        "host_us": host_us(lambda: pp.ball_query_merge(
            all_idx[:, :1, :16], all_cnt[:, :1, :16], n, nsample))}]
    print(f"[14] ball_query_merge at SA1 ({b} x {m} x {nsample}): W=1 "
          f"{merge_ms * 1e3:.3f} us (bound {mb * 1e3:.3f} us, {mby}), plain "
          f"{merge_plain_ms * 1e3:.3f} us, W=4 {merge4_ms * 1e3:.3f} us; "
          f"error {err} (against the dense ball query too); edge cases "
          f"{edge_err}")

    # owned gather: the front's three calls (centres, xyz rows, feature
    # rows); an emulated second slab of two gives zeros off its rows
    sites = [("centres", xyz, whole), ("xyz rows", xyz, dense_idx),
             ("feature rows", feats, dense_idx)]
    gr = []
    for label, table, gidx in sites:
        flat = gidx.reshape(b, -1).contiguous()
        got = pp.gather_owned(table, flat, 0)
        want = pp.gather_owned_plain(table, flat, 0)
        half = table[:, n // 2:].contiguous()
        got2 = pp.gather_owned(half, flat, n // 2)
        want2 = pp.gather_owned_plain(half, flat, n // 2)
        e = max(float((got - want).abs().max()),
                float((got2 - want2).abs().max()),
                float((got - ops.gather_points(table, flat)).abs().max()))
        c = table.shape[-1]
        r = flat.shape[1]
        gb, gby = bound_ms(4 * b * r + 2 * 4 * b * r * c, 0)
        gr.append({
            "site": label, "shape": [b, n, r, c], "max_abs_err": e,
            "ms": cuda_ms(torch, lambda: pp.gather_owned(table, flat, 0),
                          reps=20),
            "plain_ms": cuda_ms(torch, lambda: pp.gather_owned_plain(
                table, flat, 0), reps=5),
            "bound_ms": gb, "bound_by": gby, "library_ms": None})
    us = host_us(lambda: pp.gather_owned(xyz, whole[:, :8].contiguous(), 0))
    for r in gr:
        r["host_us"] = us
        if r["max_abs_err"] != 0:
            fail(f"gather_owned differs from its plain version at "
                 f"{r['site']}: {r['max_abs_err']}")
        print(f"[14] gather_owned {r['site']} {r['shape']}: "
              f"{r['ms'] * 1e3:.3f} us (bound {r['bound_ms'] * 1e3:.3f} us, "
              f"{r['bound_by']}), plain {r['plain_ms'] * 1e3:.3f} us; error "
              f"{r['max_abs_err']} (an emulated second slab included)")
    rows["gather_owned"] = gr
    return rows


class ParallelModesPhase:
    """Phase 14: ZeRO-1, tensor parallel, the pipeline and the point-axis
    front end at world size 1 over NCCL, on phase 6's model and batch,
    with the card to itself (after phase 13, whose group is closed)."""

    def __init__(self, torch, smi, train_host, config=None, device=None):
        from vlp3d_torch.config import Config, ModelConfig

        self.smi, self.train_host = smi, train_host
        self.config = config or Config(model=ModelConfig(use_con=True,
                                                         no_caption=True))
        self.device = device or torch.device("cuda",
                                             torch.cuda.current_device())

    def drive(self, torch):
        import numpy as np

        from vlp3d_torch import ops
        from vlp3d_torch.parallel import BatchShard
        from vlp3d_torch.parallel import distributed as du
        from vlp3d_torch.parallel import point_parallel as pp
        from vlp3d_torch.parallel import tensor_parallel as tpm
        from vlp3d_torch.parallel.pipeline import pipeline_text_encoder
        from vlp3d_torch.parallel.zero import optimizer_state_bytes
        from vlp3d_torch.train import batch_to_device

        device, config = self.device, self.config
        du.dist_init(f"127.0.0.1:{free_port()}", 1, 0, device=device)
        want_backend = "nccl" if device.type == "cuda" else "gloo"
        if du.backend() != want_backend:
            fail(f"phase 14's group runs over {du.backend()}, not "
                 f"{want_backend}")
        numbers = {}
        batch = batch_to_device(self.train_host, device)
        data = BatchShard.of_group()
        grid = tpm.make_grid(1)

        # ZeRO-1 against phase 13's data-parallel step: bit for bit
        paths = {"dp": _path_model(torch, config, device, data),
                 "zero1": _path_model(torch, config, device, data,
                                      zero1=True)}
        steps = {}
        for name, (model, opt, step) in paths.items():
            ops.reset_launches()
            steps[name] = step(batch, torch.Generator(device=device)
                               .manual_seed(0))
            if dict(ops.launches) != PER_STEP:
                fail(f"{name} step launches {dict(ops.launches)}")
        (m_dp, o_dp, _), (m_z, o_z, _) = paths["dp"], paths["zero1"]
        diff = [n for (n, a), (_, c) in zip(m_dp.named_parameters(),
                                           m_z.named_parameters())
                if not torch.equal(a, c)
                or (a.grad is None) != (c.grad is None)
                or (a.grad is not None and not torch.equal(a.grad, c.grad))]
        sd_dp, sd_z = o_dp.state_dict(), o_z.state_dict()
        moments = 0
        for i, st in sd_dp["state"].items():
            for k, v in st.items():
                if torch.is_tensor(v) and v.dim() > 0:
                    moments += 1
                    if not torch.equal(v, sd_z["state"][i][k]):
                        diff.append(f"moment {i}.{k}")
        zbytes = optimizer_state_bytes(o_z, device)
        dbytes = optimizer_state_bytes(o_dp, device)
        print(f"[14] ZeRO-1 step (world size 1, NCCL) against the "
              f"data-parallel step of phase 13 on phase 6's batch: "
              f"parameters, gradients and {moments} whole moments "
              f"{'bit-equal' if not diff else 'differ: ' + str(diff[:5])}; "
              f"optimizer_state_bytes {zbytes} against {dbytes} unsharded; "
              f"loss {steps['zero1']['loss'].item()}")
        if diff:
            fail("the ZeRO-1 step differs from the data-parallel step")
        numbers["zero1"] = {"bit_equal": True, "state_bytes": zbytes,
                            "unsharded_state_bytes": dbytes,
                            "moments": moments}
        del sd_dp, sd_z

        # tensor parallel at tp 1: every collective runs
        ref = OneProcessRecord(torch, config, device, batch)
        before = dict(tpm.calls)
        model_tp, opt_tp, step_tp = _path_model(torch, config, device,
                                                grid.data, model=grid.model)
        tp = follow_step(torch, ref, step_tp, model_tp, batch, grid.data,
                         device)
        sd = model_tp.state_dict()
        calls = {k: tpm.calls[k] - before[k] for k in before}
        keys_ok = set(sd) == set(m_dp.state_dict()) and all(
            sd[k].shape == v.shape for k, v in m_dp.state_dict().items())
        n_split = sum(isinstance(mod, tpm._SplitLinear)
                      for mod in model_tp.modules())
        print(f"[14] TP step at tp 1 ({n_split} split layers) against the "
              f"one-process step: "
              f"{ {k: v for k, v in tp.items() if k != 'launches'} }; "
              f"launches {tp['launches']}; collective calls {calls}; its "
              f"state dict in the one-process layout: {keys_ok}")
        if not parity_ok(tp, True) or min(calls.values()) == 0 or not keys_ok:
            fail("the TP step at tp 1 differs from the one-process step, or "
                 "a collective did not run")
        numbers["tp1"] = {k: v for k, v in tp.items() if k != "launches"}
        numbers["tp1"]["collective_calls"] = calls
        del sd
        paths["tp1"] = (model_tp, opt_tp, step_tp)

        # steps in turns
        gens = {k: torch.Generator(device=device).manual_seed(1)
                for k in paths}
        times = {k: [] for k in paths}
        order = list(paths)
        for i in range(PARALLEL_STEPS + 1):
            for name in (order if i % 2 == 0 else order[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = paths[name][2](batch, gens[name])
                torch.cuda.synchronize()
                if i:
                    times[name].append((time.perf_counter() - t0) * 1e3)
                if not np.isfinite(m["loss"].item()):
                    fail(f"{name} step {i}: loss {m['loss'].item()}")
        med = {k: float(np.median(v)) for k, v in times.items()}
        print(f"[14] train step medians of {PARALLEL_STEPS} in turns on "
              f"phase 6's batch: {med} ms; ZeRO-1 "
              f"x{med['zero1'] / med['dp']:.4f}"
              f" and TP x{med['tp1'] / med['dp']:.4f} of the data-parallel "
              f"step ({self.smi})")
        numbers["step_ms"] = med
        for name in list(paths):
            paths[name][0].zero_grad(set_to_none=True)
        del paths, ref, model_tp, opt_tp, step_tp
        torch.cuda.empty_cache()

        # a witness for the four-card runs' SA1 gradient: how far SA1's
        # own sums, taken in four ranks' order or in float64, move it
        wit = sa1_order_witness(torch, config, device, batch)
        print(f"[14] SA1's first-layer gradient on phase 6's batch, SA1 "
              f"alone on the one-process step's input and output gradient "
              f"(differences of the float64 gradient's largest entry): "
              f"{wit} ({self.smi})")
        numbers["sa1_order_witness"] = wit
        torch.cuda.empty_cache()

        # the pipeline at S 1, M 4 against the sequential text layers
        enc = m_dp.lang.text_encoder.eval()
        b, l, t = batch["input_ids"].shape
        ids = batch["input_ids"].reshape(b * l, t).long()
        mask = batch["bert_attention_mask"].reshape(b * l, t)
        with torch.no_grad():
            seq = enc(ids, mask)
            piped = pipeline_text_encoder(grid.model, enc, ids, mask,
                                          num_microbatches=PIPE_MICROBATCHES)
            perr = float((piped - seq).abs().max() / seq.abs().max())
            seq_ms = median_ms(torch, lambda: enc(ids, mask))[0]
            pipe_ms = median_ms(torch, lambda: pipeline_text_encoder(
                grid.model, enc, ids, mask,
                num_microbatches=PIPE_MICROBATCHES))[0]
        print(f"[14] pipeline_text_encoder at S 1, M {PIPE_MICROBATCHES} over "
              f"{len(enc.bert.encoder.layer)} BERT-base layers, {b * l} "
              f"sentences of {t} tokens: within {perr} of the sequential "
              f"layers' largest entry (PIPE_TOL {PIPE_TOL}); {pipe_ms:.3f} ms "
              f"against {seq_ms:.3f} ms")
        if perr > PIPE_TOL:
            fail("the pipelined text layers differ from the sequential ones")
        numbers["pipeline"] = {"err": perr, "ms": pipe_ms, "seq_ms": seq_ms}
        backbone = m_dp.backbone_net.eval()
        del m_dp, o_dp, m_z, o_z, enc
        torch.cuda.empty_cache()

        # the point-sharded front end and backbone against the dense SA1
        sa1 = backbone.sa1
        pc = batch["point_clouds"]
        xyz, feats = pc[..., :3].contiguous(), pc[..., 3:].contiguous()
        front = pp.large_scene_front(grid.model, sa1.npoint, sa1.radius,
                                     sa1.nsample)
        with torch.no_grad():
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = front(xyz, feats)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            front_launches = dict(ops.launches)
            front_ms = median_ms(torch, lambda: front(xyz, feats))[0]
            t0 = time.perf_counter()
            want = dense_front(torch, xyz, feats, sa1.npoint, sa1.radius,
                               sa1.nsample)
            torch.cuda.synchronize()
            dense_ms = (time.perf_counter() - t0) * 1e3
            same = front_equal(torch, got, want)
            sharded = pp.apply_backbone_large_scene(backbone, pc, grid.model)
            dense = backbone(pc)
            bb_err = max(float((sharded[k] - dense[k]).abs().max()
                               / dense[k].abs().max().clamp(min=1e-30))
                         for k in dense if dense[k].is_floating_point())
            inds_equal = bool(torch.equal(sharded["sa1_inds"],
                                          dense["sa1_inds"]))
        want_launches = dict({k: 0 for k in PER_STEP}, **SP_FRONT)
        print(f"[14] large_scene_front at B={pc.shape[0]} x {pc.shape[1]} "
              f"points (SA1: "
              f"{sa1.npoint} centres, r {sa1.radius}, {sa1.nsample} "
              f"neighbours, {feats.shape[-1]} feature channels), world size "
              f"1: indices and grouped rows equal to the dense SA1's: {same}; "
              f"{front_ms:.3f} ms, median of 5 "
              f"({front_ms * 1e3 / sa1.npoint:.3f} us a centre; the first "
              f"call {first_ms:.3f} ms) against the dense ops' "
              f"{dense_ms:.3f} ms; launches {front_launches}; "
              f"apply_backbone_large_scene against the dense backbone: "
              f"sa1_inds equal {inds_equal}, outputs within {bb_err} of "
              f"their largest entry ({self.smi})")
        kernels_ok = (front_launches == want_launches
                      or device.type == "cpu")  # a CPU rehearsal: no kernels
        if not same or not kernels_ok or not inds_equal \
                or bb_err > BACKBONE_TOL:
            fail("the point-sharded front end or backbone differs from the "
                 "dense one, or launched otherwise")
        numbers["front"] = {"ms": front_ms, "first_ms": first_ms,
                            "dense_ms": dense_ms,
                            "us_per_iteration": front_ms * 1e3 / sa1.npoint,
                            "backbone_err": bb_err}
        rows = check_point_kernels(torch, xyz, feats, sa1)
        du.dist_close()
        del backbone, batch, pc, xyz, feats, got, want, sharded, dense
        torch.cuda.empty_cache()
        stamp("14", "ZeRO-1, tensor, pipeline and point-axis parallel")
        return rows, front_launches, numbers


def rank_modes(torch, config, device, host, full, points, main_rank):
    """``--ranks N`` beyond data parallel, on every rank: ZeRO-1 over the
    N ranks, tp 2 x dp N / 2 and tp N, each step against the one-process
    step on the global batch (recorded once, every rank running it) with
    PARALLEL_STEPS timed steps; pp 2 x dp N / 2 against the sequential
    text layers; the point-sharded front over N ranks, each holding
    ``points`` of every scene, against the dense ops on the whole
    clouds. Returns (every rank's numbers, whether every check passed on
    every rank)."""
    import numpy as np
    import torch.distributed as dist

    from vlp3d_torch import ops
    from vlp3d_torch.data.synthetic import make_batch
    from vlp3d_torch.parallel import LOCAL, BatchShard
    from vlp3d_torch.parallel import distributed as du
    from vlp3d_torch.parallel import point_parallel as pp
    from vlp3d_torch.parallel.pipeline import pipeline_text_encoder
    from vlp3d_torch.parallel.tensor_parallel import make_grid
    from vlp3d_torch.parallel.zero import optimizer_state_bytes
    from vlp3d_torch.train import batch_to_device

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    world = dist.get_world_size()
    ref = OneProcessRecord(torch, config, device, full)
    out, ok = {}, True
    for name, tp, zero1 in (("zero1", 1, True), ("tp2", 2, False),
                            (f"tp{world}", world, False)):
        grid = make_grid(tp) if tp > 1 else None
        data = grid.data if grid else BatchShard.of_group()
        model, opt, step = _path_model(torch, config, device, data,
                                       zero1=zero1,
                                       model=grid.model if grid else None)
        batch = du.shard_host_batch(host, device, shard=data)
        p = follow_step(torch, ref, step, model, batch, data, device)
        p["passed"] = parity_ok(p, cuda)
        ok &= p["passed"]
        state_bytes = optimizer_state_bytes(opt, device)
        gen = torch.Generator(device=device).manual_seed(1)
        times = []
        for i in range(PARALLEL_STEPS + 1):
            du.barrier()
            sync()
            t0 = time.perf_counter()
            step(batch, gen)
            sync()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict({k: v for k, v in p.items() if k != "launches"},
                         step_ms=float(np.median(times)),
                         state_bytes=state_bytes, launches=p["launches"])
        del model, opt, step
        if cuda:
            torch.cuda.empty_cache()

    # the pipeline: pp 2 x dp N / 2 against the sequential text layers
    grid = make_grid(2)
    owner = _path_model(torch, config, device, LOCAL)[0]
    enc = owner.lang.text_encoder.eval()
    b, l, t = full["input_ids"].shape
    ids = full["input_ids"].reshape(b * l, t).long()
    mask = full["bert_attention_mask"].reshape(b * l, t)
    with torch.no_grad():
        seq = enc(ids, mask)
        piped = pipeline_text_encoder(grid.model, enc, ids, mask,
                                      num_microbatches=PIPE_MICROBATCHES,
                                      data=grid.data)
    perr = float((piped - seq).abs().max() / seq.abs().max())
    ok &= perr <= PIPE_TOL
    out["pp2"] = {"err": perr, "stages": 2, "data": grid.data.world}
    del owner, enc

    # the point-sharded front end over the N ranks: its FPS one launch of
    # the loop kernel a rank, the candidates exchanged through peer memory
    point = make_grid(world).model
    sa1 = config.model
    npoint, radius, nsample = (sa1.sa_npoints[0], sa1.sa_radii[0],
                               sa1.sa_nsamples[0])
    scene = batch_to_device(make_batch(config, batch_size=B if cuda else 2,
                                       num_points=points * world, seed=9,
                                       istrain=0), device)["point_clouds"]
    xyz, feats = scene[..., :3].contiguous(), scene[..., 3:].contiguous()
    lo = point.rank * points
    slab, slab_feats = (xyz[:, lo:lo + points].contiguous(),
                        feats[:, lo:lo + points].contiguous())

    def timed(fn, runs):
        """(the outputs of the first run, each run's ms), every rank
        starting each run together."""
        ms, first = [], None
        for _ in range(runs):
            du.barrier()
            sync()
            t0 = time.perf_counter()
            got = fn()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            first = got if first is None else first
        return first, ms

    with torch.no_grad():
        front = pp.large_scene_front(point, npoint, radius, nsample)
        # the first call sets up the group's exchange buffers
        got, front_runs = timed(lambda: front(slab, slab_feats), 4)
        t0 = time.perf_counter()
        want = dense_front(torch, xyz, feats, npoint, radius, nsample)
        sync()
        dense_ms = (time.perf_counter() - t0) * 1e3
        same = front_equal(torch, got, front(slab, slab_feats)) and \
            front_equal(torch, got, want)
        # the FPS alone over the N ranks; the loop's step where the
        # points are few: one row of a slab of `few` points a rank (no
        # fewer than its centres) over the N ranks, and the same kernel on
        # that slab alone, its exchange in the card's own memory
        _, fps_runs = timed(lambda: pp.fps_sharded(slab, npoint, point), 5)
        few = min(2048, points)
        steps = min(npoint, few)
        tiny = xyz[:1, point.rank * few:(point.rank + 1) * few].contiguous()
        tiny_inds, tiny_runs = timed(
            lambda: pp.fps_sharded(tiny, steps, point), 5)
        _, alone_runs = timed(lambda: pp.fps_sharded(tiny, steps), 5)
        # the one-element all-reduce each call of the group starts behind
        token = torch.zeros(1, dtype=torch.int32, device=device)
        _, reduce_runs = timed(lambda: dist.all_reduce(token), 5)
        same &= bool(torch.equal(tiny_inds, ops.furthest_point_sample(
            xyz[:1, :few * world].contiguous(), steps)))
    ok &= same
    med = {k: float(np.median(v)) for k, v in (
        ("front_ms", front_runs[1:]), ("fps_ms", fps_runs[1:]),
        ("tiny_ms", tiny_runs[1:]), ("alone_ms", alone_runs[1:]),
        ("all_reduce_ms", reduce_runs[1:]))}
    out[f"sp{world}"] = dict(
        med, equal=same, points_a_rank=points, first_front_ms=front_runs[0],
        dense_ms=dense_ms, few_points_a_rank=few, few_centres=steps,
        step_us=med["tiny_ms"] * 1e3 / max(steps - 1, 1),
        alone_step_us=med["alone_ms"] * 1e3 / max(steps - 1, 1),
        peer_extra_us_per_step=(
            med["tiny_ms"] - med["alone_ms"]) * 1e3 / max(steps - 1, 1))
    del got, want, scene, xyz, feats, slab, slab_feats
    ok = du.all_processes_agree(ok)
    results = [None] * world
    dist.all_gather_object(results, out)
    if main_rank:
        print(f"[modes] {world} ranks over {du.backend()}: each mode against "
              f"the one-process reference, every rank's numbers: {results}",
              flush=True)
    return results, ok


def drive(torch, config, batch_size, num_points, smi):
    """Phases 3-5; returns (per-call kernel rows, main-path launch counts,
    (the host scenes, the model's weights on the card))."""
    import numpy as np

    from vlp3d_torch import ops
    from vlp3d_torch.data.synthetic import make_batch
    from vlp3d_torch.serving import STREAM_KEYS, GroundingPredictor

    # 3. the model from a seed and one warm-up forward
    t0 = time.perf_counter()
    pred = GroundingPredictor(config, batch_size=batch_size)
    print(f"[3] model built and seeded in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in pred.model.parameters())} parameters)")
    scenes = [make_batch(config, batch_size=batch_size, num_points=num_points, seed=s,
                         istrain=0) for s in range(4)]
    scenes = [{k: s[k] for k in STREAM_KEYS} for s in scenes]
    dev0 = pred._to_device(scenes[0])
    with torch.no_grad():
        warm = pred.model(dev0)
    torch.cuda.synchronize()
    warm["point_clouds_xyz"] = dev0["point_clouds"][..., :3]
    warm["point_clouds"] = dev0["point_clouds"]

    # 4. kernels against their plain versions
    stamp("3", "model and warm-up forward")
    rows = check_kernels(torch, config, warm)
    del warm
    stamp("4", "kernel checks")

    # 5. the main path: three requests, launch counts, plain-op forward
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    timings = []
    t0 = time.perf_counter()
    r1 = pred([scenes[0]])
    timings.append(("call x1", batch_size, time.perf_counter() - t0))
    t0 = time.perf_counter()
    r2 = pred([scenes[1], scenes[2]])
    timings.append(("call x2", 2 * batch_size, time.perf_counter() - t0))
    occ = {k: v[:3] for k, v in scenes[3].items()}
    t0 = time.perf_counter()
    r3 = pred.run_padded(occ)
    timings.append(("run_padded occ3", 3, time.perf_counter() - t0))
    launches = dict(ops.launches)
    forwards = 4
    want = {name: n * forwards for name, n in PER_FORWARD.items()}
    print(f"[5] launches over {forwards} forwards: {launches}")
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    peak = torch.cuda.max_memory_allocated()
    k = config.model.num_proposal
    for res in r1 + r2 + [r3]:
        for key, v in res.items():
            if not np.isfinite(v).all():
                fail(f"non-finite {key}")
        pr = res["pred_ref"]
        if pr.shape != (batch_size, config.model.lang_num_max) or pr.min() < 0 \
                or pr.max() >= k:
            fail(f"pred_ref out of range: {pr.shape} {pr.min()} {pr.max()}")
    if not (r3["pred_ref"][3:] == r3["pred_ref"][0]).all():
        fail("run_padded: padded rows do not repeat row 0")
    for name, scenes_n, sec in timings:
        print(f"[5] request {name}: {sec * 1e3:.3f} ms, "
              f"{scenes_n / sec:.3f} scenes/s ({smi})")
    # steady state: the same single-batch request again
    steady = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred([scenes[0]])
        steady.append(time.perf_counter() - t0)
    steady_ms = float(np.median(steady)) * 1e3
    print(f"[5] steady single-batch request: median {steady_ms:.3f} ms of 5, "
          f"{batch_size / steady_ms * 1e3:.3f} scenes/s; peak memory "
          f"{peak / 2**30:.3f} GiB ({smi})")
    with plain_ops():
        t0 = time.perf_counter()
        rp = pred([scenes[0]])[0]
        plain_s = time.perf_counter() - t0
    err = float(np.abs(rp["cluster_ref"] - r1[0]["cluster_ref"]).max())
    if not np.array_equal(rp["pred_ref"], r1[0]["pred_ref"]):
        fail("pred_ref of the kernel forward differs from the plain forward")
    if err > CLUSTER_REF_TOL:
        fail(f"cluster_ref differs from the plain forward by {err}")
    print(f"[5] plain-op forward on the card: {plain_s * 1e3:.3f} ms; "
          f"pred_ref equal, cluster_ref max abs err {err}")
    profile_call(torch, lambda: pred([scenes[0]]), "5", "request")
    stamp("5", "serving path")
    return rows, launches, (scenes, pred.model.state_dict())


def _dp_models(torch, config, shard, device):
    """Phase 6's model twice from its seed and nudges, with their
    optimizers: the one-process step's and the data-parallel step's."""
    from vlp3d_torch.models import JointNet
    from vlp3d_torch.parallel import LOCAL
    from vlp3d_torch.train import make_optimizer, make_train_step
    from vlp3d_torch.train.schedules import cosine_lr

    out = {}
    for name, sh in (("one", LOCAL), ("dp", shard)):
        model = JointNet(config, device=device)
        with torch.no_grad():
            model.vgen.conv3.weight.mul_(0.05)
            model.vgen.conv3.bias.mul_(0.05)
            model.proposal.proposal.box_predictor.bias.fill_(-1.0)
        opt = make_optimizer(
            model, lr_schedule=lambda e, lr0: cosine_lr(e, lr0, 200),
            steps_per_epoch=100)
        out[name] = (model, make_train_step(model, config, opt, shard=sh))
    return out


def rank_worker(tiny: bool) -> int:
    """One rank of ``--ranks N`` (started by torch.distributed.run): the
    data-parallel step over the N ranks against the one-process step on
    the whole global batch, which every rank also runs on its own card
    from the same seeded state; then the steps timed in turns. Rank 0
    prints. ``tiny``: the tiny configuration over gloo on the CPU (a
    rehearsal of this path without cards)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vlp3d_torch import ops
    from vlp3d_torch.config import Config, ModelConfig
    from vlp3d_torch.data.synthetic import make_batch, tiny_config
    from vlp3d_torch.parallel import BatchShard
    from vlp3d_torch.parallel import distributed as du
    from vlp3d_torch.train import batch_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = du.dist_init(device="cpu" if tiny else None)
    shard = BatchShard.of_group()
    main_rank = shard.rank == 0
    device = (torch.device("cpu") if tiny
              else torch.device("cuda", torch.cuda.current_device()))
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    config = (tiny_config(use_con=True, no_caption=True) if tiny else
              Config(model=ModelConfig(use_con=True, no_caption=True)))
    points = 256 if tiny else N
    paths = _dp_models(torch, config, shard, device)

    def host_batch(rows):
        return make_batch(config, batch_size=rows, num_points=points, seed=7,
                          epoch=0, istrain=1)

    def own(batch):
        return du.shard_host_batch(batch, device)

    # parity: the one-process step on the global batch (run.sh's 8 rows)
    # recording every ReLU input and max-pool choice, then the
    # data-parallel step on this rank's rows following its rows of those
    # records: the ranks sum the BatchNorm statistics in another order,
    # which moves a unit within rounding of 0, or of a tie, to the other
    # side
    host = host_batch(B)
    full = batch_to_device(host, device)
    (m1, s1), (m2, s2) = paths["one"], paths["dp"]
    with kinks(m1) as (pre, _), pool_ties(m1) as (pools, _), \
            index_ties(m1) as (inds, _), sa1_capture(m1) as kept1:
        r1 = s1(full, torch.Generator(device=device).manual_seed(0))
    follow = {k: [shard.own(t) for t in v] for k, v in pre.items()}
    follow_pools = {k: [shard.own(t) for t in v] for k, v in pools.items()}
    follow_inds = {k: [tuple(shard.own(t) for t in rec) for rec in v]
                   for k, v in inds.items()}
    del pre, pools, inds
    ops.reset_launches()
    with kinks(m2, follow=follow) as (_, moved), \
            pool_ties(m2, follow=follow_pools) as (_, pooled), \
            index_ties(m2, follow=follow_inds) as (_, resampled), \
            sa1_capture(m2) as kept2:
        # this rank's SA1 gradient before the average over the ranks
        average = shard.average_gradients
        sa1_w = m2.get_parameter(
            "backbone_net.sa1.mlp_module.layer0.conv.weight")

        def keep_local(params):
            kept2["local"] = sa1_w.grad.detach().flatten(1).double()
            average(params)

        shard.average_gradients = keep_local
        try:
            r2 = s2(own(host), torch.Generator(device=device).manual_seed(0))
        finally:
            del shard.average_gradients
    sync()
    launches = dict(ops.launches)
    del follow, follow_pools, follow_inds
    near = max([v[1] for v in moved.values()]
               + [v[1] for v in pooled.values()], default=0.0)
    loss_rel = abs(r2["loss"].item() - r1["loss"].item()) / abs(
        r1["loss"].item())
    metric_err = max(abs(r2[k].item() - r1[k].item()) for k in r1)
    grads = {n: ((m2.get_parameter(n).grad - m1.get_parameter(n).grad).abs()
                 .max() / m1.get_parameter(n).grad.abs().max().clamp(
                     min=1e-30)).item() for n in DP_PROBE}
    # the typical entry's difference beside the largest one's
    medians = {n: ((m2.get_parameter(n).grad - m1.get_parameter(n).grad)
                   .abs().median() / m1.get_parameter(n).grad.abs().max()
                   .clamp(min=1e-30)).item() for n in DP_PROBE}
    b2 = dict(m2.named_buffers())
    bn = max(((b2[n] - v).abs().max() / v.abs().max().clamp(min=1e-30))
             .item() for n, v in m1.named_buffers()
             if n.endswith(("running_mean", "running_var")))
    index_gap = max([v[1] for v in resampled.values()], default=0.0)
    sa1_witness = sa1_upstream_witness(torch, shard, kept1, kept2, m1, m2)
    del kept1, kept2
    differ = du.check_replicated(m2)
    ok = (loss_rel <= STEP_LOSS_RTOL and max(grads.values()) <= STEP_GRAD_TOL
          and bn <= STEP_GRAD_TOL and near <= FLIP_TOL
          and index_gap <= INDEX_TIE_TOL and not differ
          and (launches == PER_STEP or not cuda))
    ok = du.all_processes_agree(ok)
    if main_rank:
        print(f"[dp] {shard.world} ranks over {du.backend()} ({ctx}): the "
              f"data-parallel step on {B // shard.world} rows a rank against "
              f"the one-process step on the global batch of {B}: loss "
              f"{r2['loss'].item()} vs {r1['loss'].item()} (relative "
              f"{loss_rel}), largest metric difference {metric_err}; "
              f"gradient difference of each probe, of its largest entry: "
              f"{grads} (median entry: {medians}); BatchNorm running "
              f"statistics within {bn}; ReLU "
              f"inputs that followed (module: units, largest |input|) "
              f"{moved}; max-pool choices that followed (module: channels, "
              f"largest gap) {pooled}; sampled indices that followed "
              f"(module: indices, largest gap from a tie) {resampled}; "
              f"SA1 replayed alone (of its first-layer gradient's largest "
              f"entry) {sa1_witness}; parameters differing between "
              f"ranks "
              f"{differ}; "
              f"launches of a step {launches}", flush=True)
    # the other modes run whatever this check gave; the run fails at the
    # end, naming every check that failed
    dp_ok = ok

    # timing in turns: the one-process step at the global batch of 8,
    # the data-parallel step at the same global batch (8 / N rows a card)
    # and at B rows a card (a global batch of N x B)
    gen = {k: torch.Generator(device=device).manual_seed(1)
           for k in ("one", "dp", "dp_wide")}
    batches = {"one": full, "dp": own(host),
               "dp_wide": own(host_batch(B * shard.world))}
    steps = {"one": s1, "dp": s2, "dp_wide": s2}
    times = {k: [] for k in steps}
    for i in range(DP_STEPS + 1):
        order = list(steps) if i % 2 == 0 else list(reversed(steps))
        for name in order:
            du.barrier()
            sync()
            t0 = time.perf_counter()
            m = steps[name](batches[name], gen[name])
            sync()
            if i:
                times[name].append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(m["loss"].item()):
                fail(f"{name} step {i}: loss {m['loss'].item()}")
    med = {k: float(np.median(v)) for k, v in times.items()}
    # the slowest rank's median decides the data-parallel step
    worst = [None] * shard.world
    dist.all_gather_object(worst, med)
    med_max = {k: max(w[k] for w in worst) for k in med}
    if main_rank:
        rows = B // shard.world
        print(f"[dp] train step medians of {DP_STEPS} in turns, slowest "
              f"rank: one process at B={B} {med_max['one']:.3f} ms "
              f"({B / med_max['one'] * 1e3:.3f} scenes/s); data parallel "
              f"at B={B} ({rows} a card) {med_max['dp']:.3f} ms "
              f"(x{med_max['one'] / med_max['dp']:.4f} of one process); at "
              f"B={B * shard.world} ({B} a card) {med_max['dp_wide']:.3f} ms "
              f"({B * shard.world / med_max['dp_wide'] * 1e3:.3f} scenes/s, "
              f"x{B * shard.world / med_max['dp_wide'] * med_max['one'] / B:.4f}"
              f" the one-process throughput); each rank's medians {worst}",
              flush=True)
        print(json.dumps({"data_parallel_ranks": {
            "world": shard.world, "backend": du.backend(),
            "loss_rel": loss_rel, "grad_err": max(grads.values()),
            "bn_err": bn, "relu_followed": {k: v[0] for k, v in
                                            moved.items()},
            "pool_followed": {k: v[0] for k, v in pooled.items()},
            "indices_followed": {k: v[0] for k, v in resampled.items()},
            "index_gap": index_gap, "sa1_witness": sa1_witness,
            "launches_per_step": launches, "step_ms": med_max}}),
            flush=True)
    del paths, batches, steps, m1, m2, s1, s2
    if cuda:
        torch.cuda.empty_cache()
    modes, modes_ok = rank_modes(torch, config, device, host, full, points,
                                 main_rank)
    if main_rank:
        print(json.dumps({"parallel_modes_ranks": modes}), flush=True)
    # phase 16's legacy InfoNCE over gather_negatives on the N ranks
    neg, neg_ok = negatives_check(torch, shard, device, reps=VARIANT_STEPS)
    neg_ok = du.all_processes_agree(neg_ok)
    if main_rank:
        print(json.dumps({"negatives_ranks": neg}), flush=True)
    du.dist_close()
    failed = [what for what, good in (
        ("the data-parallel step differs from the one-process step", dp_ok),
        ("a parallel mode differs from the one-process reference", modes_ok),
        ("the sharded InfoNCE differs from the one-process loss", neg_ok))
        if not good]
    if failed:
        fail("over several ranks, " + "; ".join(failed) + " (on some rank)")
    return 0


def ranks_main(n: int) -> int:
    """``python3 chip_smoke.py --ranks N``: data parallel over N cards of
    this host. Builds the kernels, then runs ``N`` ranks of
    :func:`rank_worker` under torch.distributed.run over NCCL (each
    ``chip_smoke.py --rank-worker``); exits 0 when every rank did. Run
    with no arguments the script needs one card; this mode needs N."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"chip_smoke: --ranks {n} needs {n} CUDA devices",
              file=sys.stderr)
        return 1
    from vlp3d_torch.ops import _kernels

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    _kernels.build(force=True)
    stamp("dp", "build")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         str(n), "--master_addr", "127.0.0.1", "--master_port",
         str(free_port()), os.path.abspath(__file__), "--rank-worker"],
        cwd=REPO, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            import signal

            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    print(out)
    stamp("dp", f"{n} ranks")
    if proc.returncode != 0:
        print(f"chip_smoke: the {n} ranks exited {proc.returncode}",
              file=sys.stderr)
        return 1
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    sys.pycache_prefix, sys.dont_write_bytecode = PYCACHE, False
    if "--rank-worker" in sys.argv[1:]:
        return rank_worker(tiny="--tiny" in sys.argv[1:])
    if "--iou-times" in sys.argv[1:]:
        return iou_times_main()
    if "--redesign-times" in sys.argv[1:]:
        rest = sys.argv[sys.argv.index("--redesign-times") + 1:]
        return redesign_times_main(rest[0], rest[1] if len(rest) > 1
                                   else None)
    if "--pillar-traces" in sys.argv[1:]:
        import torch

        print(json.dumps(PillarsPhase(torch, None).trace(torch)))
        return 0
    if "--ranks" in sys.argv[1:]:
        try:
            return ranks_main(int(sys.argv[sys.argv.index("--ranks") + 1]))
        except ImportError as e:
            print(f"chip_smoke: {e}", file=sys.stderr)
            return 1
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one",
              file=sys.stderr)
        return 1
    try:
        import vlp3d_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the vlp3d_torch package is missing ({e}); run "
              "from the root of the repository", file=sys.stderr)
        return 1

    from vlp3d_torch.config import Config, ModelConfig
    from vlp3d_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card and versions
    smi = smi_line()
    nvcc_v = subprocess.run([_kernels._nvcc(), "--version"],
                            capture_output=True, text=True, check=True,
                            timeout=60).stdout.strip().splitlines()[-1]
    kind = torch.cuda.get_device_name(0)
    print(f"[1] {smi}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc '{nvcc_v}' python {sys.version.split()[0]} device {kind}")

    # 2. build
    t0 = time.perf_counter()
    ptxas = _kernels.build(force=True)
    build_s = time.perf_counter() - t0
    print(f"[2] built {len(ptxas)} kernel libraries in {build_s:.1f} s")
    stamp("2", "build")
    for name, log in ptxas.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry function" in line):
                print(f"[2] {name}: {line.strip()}")

    # 3-5. the full-width model: Config() grounding defaults, B=8, N=40960
    config = Config(model=ModelConfig(use_con=False, no_caption=True))
    rows, serving, (scenes, ground_state) = drive(torch, config, B, N, smi)
    torch.cuda.empty_cache()

    # 6. the joint train step at the same width
    train_rows, train, train_host = drive_train(torch, B, N, smi)
    rows.update(train_rows)
    torch.cuda.empty_cache()

    # 7. the predict / evaluate path through the data loader and the CLIs;
    # phase 8's training-CLI processes and phase 10's caption_predict and
    # caption_eval processes start once phase 7's timing is done
    cli, caption_clis, task_clis = TrainCli(), CaptionClis(), TaskClis()
    variant_clis, pillar_clis = VariantClis(), PillarClis()

    def start_clis():
        cli.start()
        caption_clis.start()
        task_clis.start()
        variant_clis.start()
        pillar_clis.start()

    try:
        predict = drive_predict(torch, smi, after_timing=start_clis)
        torch.cuda.empty_cache()

        # 8. training: the Solver in this process beside the training
        # CLI, whose checks follow; then, with the card and host to
        # itself, the remat step and 9. the HTTP server
        solver, per_step, (solver_config, state, batch) = drive_solver(
            torch, smi, cli.tmp.name)
        # what needs no timing is built while the CLI runs
        remat = remat_models(torch, solver_config, state)
        del state
        http_phase = HttpPhase(torch, config)
        caption = CaptionPhase(torch, smi, scenes, ground_state, train_host)
        vqa = VqaPhase(torch, smi, scenes, ground_state, train_host)
        flags = FlagsPhase(torch, smi, scenes, ground_state, train_host)
        data_parallel = DataParallelPhase(torch, smi, scenes, ground_state,
                                          train_host)
        tasks = TaskPipelinesPhase(torch, smi)
        variants = VariantsPhase(torch, smi, scenes, ground_state,
                                 train_host)
        del ground_state
        t0 = time.perf_counter()
        cli.thread.join(timeout=900)
        if cli.thread.is_alive():
            fail("the training CLI did not end in 900 s")
        print(f"[8] waited {time.perf_counter() - t0:.1f} s for the "
              "training CLI")
        check_train_cli(cli.result, cli.workdir)
        stamp("8", "training CLI")
        check_train_caption(cli.result, os.path.join(cli.tmp.name,
                                                     "caption"))
        check_train_qa(cli.result, os.path.join(cli.tmp.name, "qa"))
        check_no_reference_cli(cli.result, os.path.join(cli.tmp.name,
                                                        "no_reference"))
        check_torchrun_cli(cli.result, os.path.join(cli.tmp.name,
                                                    "torchrun"))
        caption_clis.check()
        stamp("10", "caption CLIs")
        task_cli_numbers = task_clis.check()
        stamp("15", "task CLIs")
        variant_cli_numbers = variant_clis.check()
        stamp("16", "variant CLIs")
        pillar_cli_numbers = pillar_clis.check()
        stamp("17", "predict --multiview_hdf5 CLI")
    finally:
        cli.stop()
        caption_clis.stop()
        task_clis.stop()
        variant_clis.stop()
        pillar_clis.stop()
    remat, per_remat_step = check_remat(torch, smi, remat, batch)
    del batch
    http, latency = drive_http(torch, smi, http_phase)
    # 10. captioning with the card to itself: serving, train steps, HTTP
    captions, caption_numbers = caption.drive(torch)
    # 11. question answering with the card to itself: serving, train
    # steps, HTTP
    answers, vqa_numbers = vqa.drive(torch)
    # 12. the grounding model's options with the card to itself
    options, flag_numbers = flags.drive(torch)
    # 13. data parallel with the card to itself
    dp_step, dp_numbers = data_parallel.drive(torch, http_phase)
    # 14. ZeRO-1, tensor, pipeline and point-axis parallel
    sp_rows, sp_front, mode_numbers = ParallelModesPhase(
        torch, smi, train_host).drive(torch)
    rows.update(sp_rows)
    # 15. the GloVe/LSTM task pipelines with the card to itself
    task_paths, task_numbers = tasks.drive(torch)
    # 16. the remaining variant models with the card to itself
    variant_paths, variant_numbers = variants.drive(torch)
    # 17. PointPillars, the rotated IoU / NMS and the multiview hdf5
    pillar_rows, pillar_numbers = PillarsPhase(torch, smi).drive(
        torch, pillar_cli_numbers)
    paths = {**captions, **answers, **options, "dp_step": dp_step,
             "sp_front": sp_front, **task_paths, **variant_paths}
    task_steps = [p for p in task_paths if p.endswith("_step")]
    task_forwards = [p for p in task_paths if p.endswith("_forward")]
    for name in rows:
        if name in SP_KERNELS:
            if sp_front[name] == 0:
                fail(f"kernel {name} was not launched on phase 14's path")
            continue
        if train[name] == 0 or solver[name] == 0 \
                or paths["caption_step"][name] == 0 \
                or paths["answer_step"][name] == 0 \
                or any(paths[p][name] == 0 for p in (
                    "flags_step", "bfloat16_step", "float32_step",
                    "flags_solver_reference", "flags_solver_detection",
                    "dp_step", *task_steps, "mlcv_step",
                    "detector_step")) \
                or (PER_FORWARD[name] > 0 and (
                    serving[name] == 0 or predict[name] == 0
                    or http[name] == 0 or any(
                        paths[p][name] == 0 for p in (
                            "caption_serve", "caption_http", "answer_eval",
                            "answer_serve", "answer_http", "flags_forward",
                            "bfloat16_forward", "float32_forward",
                            *task_forwards, "mlcv_serve",
                            "detector_forward")))):
            fail(f"kernel {name} was not launched on a main path")

    # 18. results
    line = kernel_line(rows, serving, train, predict, solver, http,
                       per_step, per_remat_step, paths)
    line["kernels"] += pillar_kernel_rows(pillar_rows, pillar_numbers)
    for k in line["kernels"]:
        if k["launches"] == 0:
            fail(f"kernel {k['name']} was not launched on its main path")
    check_kernel_functions(line["kernels"])
    line["remat_step"] = remat
    line["http"] = latency
    line["caption"] = caption_numbers
    line["vqa"] = vqa_numbers
    line["options"] = flag_numbers
    line["data_parallel"] = dp_numbers
    line["parallel_modes"] = mode_numbers
    line["task_pipelines"] = dict(task_numbers, clis=task_cli_numbers)
    line["variants"] = dict(variant_numbers, clis=variant_cli_numbers)
    line["pointpillars"] = pillar_numbers
    line["wall_s"] = time.perf_counter() - _T0
    print(f"[18] the whole command took {line['wall_s']:.1f} s")
    print(json.dumps(line))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
