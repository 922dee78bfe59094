#!/usr/bin/env python3
"""Smoke run of vlp3d_torch on one CUDA card: grounding inference, the
joint train step, the predict path, the trainer behind run.sh, the HTTP
grounding server, Scan2Cap captioning and ScanQA question answering.

    python3 chip_smoke.py

Needs one CUDA device (Hopper, sm_90a) and nvcc; imports no JAX and
nothing of the vlp3d package. Phases, each fatal on failure:

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
   under its plan and every swept plan, against the plain weighted
   backward (fatal above GRAD_RTOL of the absolute sum meeting in a row,
   or unless two launches are equal bit for bit), timed beside the route
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
12. print {"kernels": [...]} with every kernel of the twelve paths (the
   CUDA functions behind each in kernel_functions, host_us beside the
   times, the launches of each path, and per_step and per_remat_step
   as counted in phase 8), the
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
               "group_points_grad": 0, "three_interpolate_grad": 0}
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


def profile_call(torch, fn, tag: str, what: str, top: int = 15):
    """Trace one call of fn with torch.profiler; print the device time by
    kernel name and the device-busy share of the call's wall time."""
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
        return
    rows = [dict(op=e.key[:90], calls=e.count, device_ms=dev_us(e) / 1e3)
            for e in events[:top] if dev_us(e) > 0]
    # a zeroed table (torch.zeros) is a fill kernel, not a memset
    memsets = sum(e.count for e in events if "memset" in e.key.lower())
    fills = sum(e.count for e in events if "fill" in e.key.lower())
    print(f"[{tag}] profile of one {what}: wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.3f} of wall; idle "
          f"share {1 - busy_ms / wall_ms:.3f}), {sum(e.count for e in events)}"
          f" device kernels and copies, {memsets} of them memsets and "
          f"{fills} fill kernels")
    for name in ("ball_query", "three_nn", "group_points_grad"):
        hits = [e for e in events if name in e.key]
        print(f"[{tag}]   {name}*: " + ", ".join(
            f"{e.key[:60]} x{e.count} {dev_us(e) / 1e3:.3f} ms" for e in hits))
    for r in rows:
        print(f"[{tag}]   {r['device_ms']:9.3f} ms  x{r['calls']:<5d} "
              f"{r['op']}")


def kernel_line(rows, serving, train, predict, solver, http, per_step,
                per_remat_step, paths):
    """The {"kernels": [...]} line. ``rows`` holds the per-call-site checks
    of each kernel; ``serving`` / ``train`` / ``predict`` / ``solver`` /
    ``http`` the launch counts of the five grounding main-path runs,
    ``paths`` those of the captioning and question-answering ones
    (``caption_serve``, ``caption_step``, ``caption_http``,
    ``answer_eval``, ``answer_serve``, ``answer_step``, ``answer_http``);
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
    }
    functions = {
        "fps": ["fps_regs_kernel<P, false>", "fps_regs_kernel<P, true>",
                "fps_kernel"],
        "ball_query": ["ball_query_tile_kernel<L>", "ball_query_kernel"],
        "three_nn": ["three_nn_team_kernel<L, kInterp, V>",
                     "three_nn_kernel"],
        "group_points": ["group_points_vec_kernel",
                         "group_points_stream_kernel"],
        "group_points_grad": ["group_points_grad_sorted_kernel<V, false>",
                              "group_points_grad_kernel"],
        "three_interpolate_grad": ["group_points_grad_sorted_kernel<V, true>"],
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
            "per_step": per_step[name],
            "per_remat_step": per_remat_step[name],
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


def check_interp_grad_site(torch, label, site, reps=20):
    """The interpolation's weighted backward at one FP site of a train
    step: the weighted sorted scatter under the wrapper's plan and every
    swept plan against the plain weighted backward (fatal above GRAD_RTOL
    of the absolute sum meeting in a row, or unless two launches are
    equal bit for bit); times of kernel, plain version, the route it
    replaced (broadcast multiply + the gather's sorted backward) and one
    sparse product (torch.sparse.mm of the transposed weight matrix)."""
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
    sweep = {}
    for cand in [(rows, sl, warps, grp.SORTED_CAP)
                 for rows in (16, 32, 64, 128)
                 for sl in ((1, 2) if c > 128 else (1,))
                 for warps in (8, 16, 32)]:
        check(cand)
        sweep["%dx%dx%d" % cand[:3]] = cuda_ms(
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
        # one unknown point's three rows: the four dependent passes
        # (count, scan, place, sum) with next to no work
        floor_ms=cuda_ms(torch, lambda: itp._three_interpolate_grad_cuda(
            grad[:1, :1].contiguous(), idx[:1, :1].contiguous(),
            weight[:1, :1].contiguous(), m), reps),
        bound_ms=bms, bound_by=by, sweep_ms=sweep)
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


def loss_and_grads(torch, model, config, batch, names, seed, caption=False):
    """One train forward + backward with dropout (and the caption / MLM
    token masks) drawn from ``seed``; returns (loss, {name: gradient}) and
    leaves no gradient behind."""
    from vlp3d_torch.losses.joint import compute_joint_loss
    from vlp3d_torch.models.layers import set_dropout_generator

    gen = torch.Generator(device=batch["point_clouds"].device)
    gen.manual_seed(seed)
    set_dropout_generator(model, gen)
    model.mask_generator = gen
    out = model(batch, train=True)
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
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *argv], cwd=REPO, env=child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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


def train_cli_runs(workdir, result):
    """Phase 8's subprocesses, one after the other (run in a thread
    beside the in-process work): 2 epochs, then --epoch 3 --auto_resume,
    and beside that run phase 10's train_caption and phase 11's train_qa
    from the first run's model.pth; leaves {"runs": [(rc, output, s),
    ...], "caption_train": (rc, output, s), "qa_train": (rc, output, s)}
    or {"error": ...} in ``result``."""
    import shutil
    import threading

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


def stop_train_cli(cli, result):
    """End phase 8's subprocess thread: kill every process still
    running."""
    result["stop"] = True
    for _ in range(3):  # a run may start while another ends
        for proc in result.get("procs", []):
            if proc.poll() is None:
                proc.kill()
        cli.join(timeout=30)


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
    BatchNorm, the relation distance-MLP's two hidden linears, and the
    first linear of every feed-forward block (the attention blocks' and
    the caption / MLM decoders')."""
    from vlp3d_torch.models.layers import BatchNorm

    parts = name.split(".")
    return isinstance(mod, BatchNorm) or name.endswith(
        (".linear1", ".feed_forward.w_1")) or (
            parts[:2] == ["relation", "self_attn_fc"] and len(parts) == 4
            and parts[3] in ("0", "3"))


@contextlib.contextmanager
def kinks(model, follow=None):
    """While open, record the output of every module ``relu_input`` names,
    call by call ({module: [tensor, ...]}). With ``follow``, such a record
    of another run of the same forward, a unit on the other side of 0 from
    ``follow``'s takes that run's value (its gradient flows straight
    through to this run's), so that both runs take the same branch of
    every ReLU. Yields (the record, {module: (units moved, largest |input|
    of a moved unit on either side)})."""
    seen, moved, hooks = {}, {}, []

    def hook(mod, args, out, name):
        calls = seen.setdefault(name, [])
        if follow is None:
            calls.append(out.detach().clone())
            return None
        ref = follow[name][len(calls)]
        calls.append(None)
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


def check_kernel_step(torch, tag, model, config, batch, probe, what,
                      caption=False):
    """The kernel train step against the plain-op step on one batch, with
    one dropout (and token-mask) draw: the plain-op run first, recording
    every ReLU input, then the kernel run following its side of 0 (the two
    forwards differ in the interpolation's order of summation, and a unit
    within rounding of 0 would move the gradient of its whole BatchNorm
    channel and of everything the forward ran before it). A moved unit
    must lie within FLIP_TOL of 0; then the loss is held to
    STEP_LOSS_RTOL and every probe's gradient to STEP_GRAD_TOL of its
    largest entry. Returns (loss_rel, worst, {module: units moved})."""
    with plain_ops(), kinks(model) as (pre_p, _):
        loss_p, grads_p = loss_and_grads(torch, model, config, batch,
                                         probe, 11, caption=caption)
    with kinks(model, follow=pre_p) as (_, moved):
        loss_k, grads_k = loss_and_grads(torch, model, config, batch,
                                         probe, 11, caption=caption)
    del pre_p
    for name, (units, near) in moved.items():
        if near > FLIP_TOL:
            fail(f"{what}: {units} ReLU inputs of {name}, up to {near} from "
                 "0, decided differently in the two runs")
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
          f"|input|) {moved}")
    if loss_rel > STEP_LOSS_RTOL or worst > STEP_GRAD_TOL:
        fail(f"the {what} differs from the plain-op step")
    return loss_rel, worst, {k: v[0] for k, v in moved.items()}


class CaptionClis:
    """Phase 10's caption_predict and caption_eval processes over
    stand-in assets (seeded weights), started beside phase 8."""

    def __init__(self):
        import tempfile

        from vlp3d_torch.data.standins import write_standin_assets

        self.tmp = tempfile.TemporaryDirectory()
        self.paths = write_standin_assets(self.tmp.name)
        self.assets = [
            "--scanrefer_dir", self.paths["scanrefer_dir"],
            "--scannet_data", self.paths["scannet_data"], "--bert_vocab",
            os.path.join(self.paths["bert_dir"], "vocab.txt")]
        self.out = {m: os.path.join(self.tmp.name, f"{m}.json")
                    for m in ("caption_predict", "caption_eval")}
        self.procs = {}

    def start(self):
        for module, out in self.out.items():
            self.procs[module] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", f"vlp3d_torch.cli.{module}",
                 *CAPTION_CLI_FLAGS, *self.assets, "--out", out], cwd=REPO,
                env=child_env(), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        stamp("10", "caption_predict and caption_eval CLIs started")

    def check(self):
        import numpy as np

        for module, (t0, proc) in self.procs.items():
            out, _ = proc.communicate(timeout=600)
            sec = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"python -m vlp3d_torch.cli.{module} exited "
                     f"{proc.returncode}:\n{out[-3000:]}")
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

    def stop(self):
        for _, proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self.tmp.cleanup()


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


def main() -> int:
    sys.pycache_prefix, sys.dont_write_bytecode = PYCACHE, False
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
            if "registers" in line or "spill" in line:
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
    cli, caption_clis = TrainCli(), CaptionClis()

    def start_clis():
        cli.start()
        caption_clis.start()

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
        caption_clis.check()
        stamp("10", "caption CLIs")
    finally:
        cli.stop()
        caption_clis.stop()
    remat, per_remat_step = check_remat(torch, smi, remat, batch)
    del batch
    http, latency = drive_http(torch, smi, http_phase)
    # 10. captioning with the card to itself: serving, train steps, HTTP
    captions, caption_numbers = caption.drive(torch)
    # 11. question answering with the card to itself: serving, train
    # steps, HTTP
    answers, vqa_numbers = vqa.drive(torch)
    paths = {**captions, **answers}
    for name in rows:
        if train[name] == 0 or solver[name] == 0 \
                or paths["caption_step"][name] == 0 \
                or paths["answer_step"][name] == 0 \
                or (PER_FORWARD[name] > 0 and (
                    serving[name] == 0 or predict[name] == 0
                    or http[name] == 0 or any(
                        paths[p][name] == 0 for p in (
                            "caption_serve", "caption_http", "answer_eval",
                            "answer_serve", "answer_http")))):
            fail(f"kernel {name} was not launched on a main path")

    # 12. results
    line = kernel_line(rows, serving, train, predict, solver, http,
                       per_step, per_remat_step, paths)
    line["remat_step"] = remat
    line["http"] = latency
    line["caption"] = caption_numbers
    line["vqa"] = vqa_numbers
    print(json.dumps(line))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
