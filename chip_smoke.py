#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``eop_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit, torch's name and
   count);
2. builds every CUDA kernel and host library of the port from
   ``eop_tpu_torch/csrc``, and decodes seeded 720x1280 JPEGs (4:2:0 and
   4:4:4, quality 95) and a PNG written by ``utils/synth.py`` with the host
   decoder (``csrc/image_decode.cpp``): the decoded arrays' sha256 must be
   the digests the CPU tests pin, where cv2 decodes them to the same bytes;
   then times each decode and ``image_size`` on one thread;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path (batch 8) and the training path (batch 32) give
   it (and the JAX package's test cases), with and without the fused scale +
   shift + SiLU epilogue, and times kernel, plain version and the PyTorch
   library calls;
4. serves the 24p-s detector (depth 0.33, width 0.50, 80 classes, 640 px)
   with seeded random weights behind the threaded HTTP front end, answers
   concurrent raw-body requests, then JPEG and PNG bodies, each of which
   must get the answer of the raw body of its decoded pixels, and checks
   every kernel of the path ran; then serves the same 32 frames through
   the event-loop front end (``serving/http_async.py``) from 16 clients on
   persistent connections, whose answers must equal the threaded front
   end's, and two detects and a stats request pipelined in one write,
   answered in order; then serves one batch with a ``relu``
   24p-s, whose 8 early convs launch the kernel without its SiLU epilogue,
   and holds that model on the card against the CPU;
5. times the stages of one serving call on the device;
6. runs one image through the port on the card and on the CPU and compares;
   then serves 24p-s in bf16 (``compute_dtype bfloat16``): one call at batch
   8 with its 8 fused launches and their variants, its detections against
   the fp32 path's, its stages, the card against the CPU, and ``python -m
   eop_tpu_torch.tools.serve -f`` with a bf16 exp file answering HTTP;
7. holds the backward kernels of ``phase_conv`` (data and weight gradient,
   and the data gradients' weight packing) against their plain versions at
   the main-path shapes, at the training step's batch 32 and at batch 8,
   and at ragged ones, checks that the main-path shapes run the tensor-core
   variants and that each gradient is the same bits twice, and times
   them beside the CUDA-core kernels they replaced, the plain versions and
   ``aten::convolution_backward``;
8. trains the 24p-s detector for a few steps through ``Trainer24P`` (batch
   32, 640 px, fp32, seeded weights, one seeded synthetic batch repeated),
   checks the losses and the kernel launches of every step (and, under the
   profiler, which kernels ran), and splits the step's device time into
   forward, loss, backward and optimizer + EMA;
9. takes one training step's loss, assignment and gradients on the card and
   on the CPU from one state and compares; then trains in bf16 as in 8
   (and the card against the CPU), then in bf16 with ``remat`` (16 forward
   launches a step: the recompute's 8 counted apart; a lower peak memory;
   the BatchNorm statistics of one step equal to those without ``remat``);
10. writes a seeded synthetic 24p dataset of 720x1280 baseline JPEG images
    (quality 95, 4:2:0, written with numpy by ``utils/synth.py``, encoded
    in up to 8 processes) and txt labels to a temporary directory;
11. trains 24p-s from those files through the exp file
    ``load_train/yolox_24p_train.py`` and the exp's own loader (spawned
    workers, pinned batches), timing the step and the host's wait for the
    loader beside the repeated-batch step of 8, and checking the launches
    of every step;
12. evaluates the seeded model over the files with ``Evaluator24P`` through
    ``Exp24P.eval`` (batch 8, fused epilogue on every early conv), and an
    oracle whose detections are the labels, on the card, which must score
    AP 1 through the native COCO matcher;
13. runs the two command lines, ``python -m eop_tpu_torch.tools.train_24p
    ... --eval compute_dtype bfloat16`` and ``python -m
    eop_tpu_torch.tools.eval`` on its checkpoint, and checks each prints an
    AP line;
14. drops the training loader with batches in flight a few more times;
15. the bbox family at full width, YOLOX-L (depth 1.0, width 1.0, 80
    classes, 640 px): holds the kernels at YOLOX-L's 12 early-conv shapes
    (batch 8; every one on a tensor-core forward and weight gradient) against
    their plain versions beside cuDNN and the CUDA-core kernels they replaced
    (with 3 and 7); writes a seeded COCO-format
    dataset (64 train and 16 val 720x1280 baseline JPEGs, 1-4 rectangles,
    80 classes; encoded in up to 8 processes); trains YOLOX-L from it with ``python -m
    eop_tpu_torch.tools.train -n yolox-l -b 8`` as a subprocess for a
    mosaic + mixup epoch, the no-aug switch and an epoch with the L1 loss
    (launches 12/12/11/11 every step, L1 0 then positive, EMA evaluation
    and its AP line each epoch); runs bf16 YOLOX-L steps in this process,
    then YOLOX-X steps (batch 8, 640 px) in fp32 and in bf16; the
    last steps of each run under the profiler (one warm-up step, two
    recorded) must show exactly the kernels the launch counters count, by
    name; one YOLOX-L step (B=2, 320 px) on the card, on the CPU and in
    float64 on the CPU (the loss within 1e-3, the same assignment, the
    card's gradients no farther from float64 than twice the CPU's);
    ``python -m
    eop_tpu_torch.tools.eval -n yolox-l`` on the checkpoint (AP line) and a
    label oracle through ``COCOEvaluator`` (AP 1); drops the mosaic loader
    with batches in flight;
16. YOLOX-Nano, YOLOX-Tiny, YOLOv3, YOLOX-M and YOLOX-X: holds the kernels
    at every early-conv shape (batch 8: Nano's 416 px, Tiny's 640 px
    trained and 416 px served, YOLOv3's, M's and X's 640 px, and X's stem at
    800 px, the top of its multiscale range, on ``wgmma_rows`` in N tiles;
    forward with and without the epilogue, weight and data gradient, fp32
    and bf16) against their plain versions beside cuDNN and the CUDA-core
    kernels (with 3 and 7; M and X are held only here); Nano's five small
    1x1 convs on ``small_1x1`` (``csrc/phase_conv_1x1.cu``) both ways,
    timed per call and on the device (CUDA graph replay) beside the routes
    it replaced, forced (``direct``, ``flipped:wgmma_taps``); serves YOLOX-L with
    ``tools.serve -n
    yolox-l --batch 8`` behind the HTTP front end (32 raw frames from 16
    clients, four alone and a JPEG body; ``bbox`` answers against direct
    calls; 12
    fused launches a forward; the stages in fp32 and bf16; the card against
    the CPU) and one YOLOv3 request (10 unfused launches); then the load
    phase: ``python -m eop_tpu_torch.tools.load_test_serving --url`` against
    ``python -m eop_tpu_torch.tools.serve``, a process of its own on the
    card started once a configuration, all at once (1 s steps), for 24p-s
    behind each front end (closed loop at 1, 16 and 64 clients, and
    720x1280 JPEG bodies at 16; on async also open-loop steps at 50 % and 90
    % of its closed-loop throughput at 16) and YOLOX-L behind each (16
    clients), each table on a line of its own; trains each with ``python -m
    eop_tpu_torch.tools.train -n NAME -b 8`` as a subprocess for an epoch,
    the three at once (launches every step as the model gives them),
    evaluates each
    checkpoint with ``tools.eval -n NAME`` (the AP line) and a label oracle
    at Tiny's 416 px (AP 1); one YOLOv3, Nano, Tiny and X step on the card
    against the CPU (YOLOv3 and X also against float64 as YOLOX-L; Nano's
    and Tiny's gradients within 2e-3 of the CPU's);
16b. the feature-map study at full width: YOLOX-L over VGG19, the
    half-width ResNet50 and DenseNet121, each served at batch 8 in fp32
    and bf16 (stages), one image on the card against the CPU (the 6-tuple
    and the detections), four fp32 training steps on batches of the bbox
    dataset's files (step ms, peak memory, DenseNet's dropout kept
    fraction) and ``get_model_info``'s line, with no ``phase_conv`` launch;
    ``python -m eop_tpu_torch.tools.serve -n yolox-l backbone_type resnet``
    answering HTTP; ``python -m eop_tpu_torch.tools.demo_featuremap -n
    yolox-l --backbone resnet --theta-range 30,95,30`` on a synthesized
    fixture in a child where cv2, matplotlib, seaborn and tabulate do not
    import, started first and run beside the rest of 16b (every sweep's
    files, four AP blocks, a finite table); the
    host resizers' times on the loader's and the letterbox's shapes;
16c. PASCAL VOC: a seeded VOCdevkit (VOC2007 and VOC2012 trainval, 16
    375x500 JPEG images each, VOC2007 test, 8), YOLOX-S at full width
    trained from ``exps/example/yolox_voc/yolox_voc_s.py`` with ``-b 8
    --accum 2`` as a subprocess (a mosaic epoch and an L1 epoch, each step
    launching twice one micro-batch's kernels by variant, the last scored
    by VOC mAP), the step alone with accum 1 and 2 on batches held on the
    card, its checkpoint evaluated by ``tools.eval -f`` (20 class APs, the
    forward / NMS split), once more with ``--legacy``; a label
    oracle through ``VOCEvaluator`` (mAP50 = mAP50:95 = 1); ``tools.eval -n
    yolox-s --testdev`` on the bbox dataset's val split as test-dev (the
    json written);
16d. the rest of the 24p family without OpenCV: ``python -m
    eop_tpu_torch.tools.show_24p -n yolox_24p_s -w REF -p DIR test_conf
    1e-5`` in a child where cv2 does not import, REF the seeded 24p-s in
    the reference's ``{"model": state_dict}`` form, DIR 4 seeded 720x1280
    JPEGs of polygon objects: four files written that decode, each
    image's rows equal to ``exp.get_infer_fn``'s in this process and the
    CPU's within the serve phase's tolerance, 8 fused launches an image (1
    ``wgmma_rows``, 7 ``wgmma_taps``, no ``direct``), the read, forward,
    draw and encode ms of each image; ``python -m
    eop_tpu_torch.tools.labels_create_24p`` on the images' json: 51-column
    rows ``COCO24PDataset`` reads, a label or more an image;
16e. the deployment path, its command lines started at once: ``python -m
    eop_tpu_torch.tools.export_serving -n yolox_24p_s --batch 8 --src-hw
    720,1280 --smoke`` (the artifact's MB, the export's seconds), the same
    with ``--int8 --calib`` phase 10's JPEGs (the convs quantized), YOLOX-L
    exported at batch 8, and ``python -m eop_tpu_torch.tools.eval --int8``
    on phase 10's files (its PTQ and AP lines); each 24p-s artifact served
    in this process (``DetectionService.from_artifact``) on 32 seeded
    frames against the live serving function of the same seeded weights
    (fp32, and int8 calibrated here on the same images): masks equal, rows
    bit-equal or within the serve phase's tolerance, saying which; the
    launch counters of one artifact call, counted inside its registered
    operators (fp32: 8 fused, 1 ``wgmma_rows`` and 7 ``wgmma_taps``; int8:
    6 fused and the int8 convs, 2 of them off ``phase_conv``); ``python -m
    eop_tpu_torch.tools.serve --artifact`` for each answering 4 raw requests
    over HTTP as this process's service does; YOLOX-L's artifact answering
    one request (12 launches); the forward at B=8 in int8 beside fp32 and
    bf16 (CUDA events), int8 against fp32 on the decoded outputs (``geo_rel``
    of ``tests/test_quant.py``) and one int8 conv's int32 accumulator on
    the card equal to the CPU's;
16f. data parallelism on the one card: two ranks on ``cuda:0`` (gloo
    over CUDA tensors; NCCL, tried beside them for two ranks on one device,
    refuses: its outcome recorded), started beside YOLOX-L's training
    child, each run three data-parallel steps
    of 24p-s at full width (640 px, B=16 a rank, seeded weights, EMA; fp32,
    then bf16) against one process's B=32 steps from the same state: the
    first fp32 step's loss within 1e-4 and ``num_fg`` equal, the fp32
    gradients within ``train_card_vs_cpu``'s 1e-3 as the whole tree's
    relative L2 distance (each tensor's largest gap and those over 1e-3
    reported: the SPP's max pools turn fp32 rounding into rerouted
    gradients); bf16 within ``train_card_vs_cpu``'s bf16 bounds (the loss
    within 5e-2, ``num_fg`` within a quarter, finite gradients) and its
    gradients' median cosine with the fp32 step no lower than the
    one-process bf16 step's less 0.1 (bf16 gradients are noise-dominated);
    the ranks' parameters, BatchNorm buffers and EMA bit-equal
    after the steps, each rank's step launching what the one-process step
    does by variant (8 / 8 / 7), each rank's step ms (two ranks on one
    card: not a scaling figure); then ``python -m
    eop_tpu_torch.tools.train_24p --multi-host --coordinator
    127.0.0.1:PORT --num-processes 1 --process-id 0`` over NCCL on phase
    10's files, without and with ``--fsdp`` (at once, beside the cli
    phase), each checkpoint
    scored by ``tools.eval`` (an AP line), the per-rank state bytes that
    ``place_state`` logs;
16g. spatial and tensor sharding on the one card: two ranks on ``cuda:0``
    (gloo over CUDA tensors, as 16f), started beside the VOC phase with a
    third process for the one-process side, each run three steps of 24p-s
    at full width (640 px, global B=8, seeded weights, EMA; fp32, then
    bf16) under ``--spatial 2`` (each rank its 320 rows, halo rows
    exchanged around every conv of the stem through dark4, gathered before
    dark5) and under ``--tensor 2`` (each rank half of the qualifying
    convs' output channels), against one process's B=8 steps from the same
    state, with 16f's gates (fp32: loss within 1e-4, ``num_fg`` equal, the
    gradients' relative L2 distance within 1e-3, or within twice the
    distance a change of arithmetic alone gives one process's own step
    where that is larger (at B=8 one ulp on the images moves it 1.05e-3),
    the tensors over 1e-3 listed; bf16: ``train_card_vs_cpu``'s bf16
    bounds and the cosine rule); the ranks' state, gathered whole,
    bit-equal; each rank's
    launches by variant against those predicted from the halo'd and sliced
    shapes (``MP_STEP_VARIANTS``: ``small_1x1`` for dark2's m0.conv1 under
    ``--tensor 2``); every shape the kernels meet checked against the
    plain versions (forward, fused, both gradients, fp32 and bf16); the
    state bytes a rank holds under ``--tensor 2``; a B=8 batch through
    ``get_sharded_infer_fn`` over the space pair and ``get_tp_infer_fn``
    over the model pair against one process's ``get_infer_fn`` (masks
    equal, coordinates within the serve phase's 0.64 px, scores 1e-3);
17. checks that no loader worker died in any of the file phases, and that
    no path launched the CUDA-core ``direct`` forward or the ``cuda_cores``
    weight or data gradient.

``python3 chip_smoke.py --show-24p-child OUT -- ARGS`` is 16d's child:
``tools.show_24p``'s ``main(ARGS)`` without cv2, its rows, times and
launch counts written to OUT.

``python3 chip_smoke.py --dp-child RANK PORT OUT BACKEND`` is one of
16f's ranks; ``--nccl-probe-child RANK PORT`` one of its NCCL probe's.

``python3 chip_smoke.py --mp-child RANK PORT OUT`` is one of 16g's ranks,
``--mp-ref-child OUT`` its one-process side; ``python3 chip_smoke.py
--model-parallel`` runs only 16g.  ``python3 chip_smoke.py --grad-noise``
takes 16g's fp32 gradient distance apart: one process's first B=8 step
against itself under changes of arithmetic alone (again, the images one
ulp up, cuDNN off, the global BatchNorm's sums) and two ranks of data
parallelism, of --tensor 2 with m0.conv1 on ``wgmma_taps`` and of
--spatial 2 without cuDNN (``--grad-noise-child`` is one of its ranks).

``python3 chip_smoke.py --repeat-serve-bbox N`` runs only the serve_bbox
phase, N times in one process, one line a run.  ``python3 chip_smoke.py
--backbones`` runs only 16b (with the bbox dataset it reads).

``python3 chip_smoke.py --compare-steps TREE ...`` times YOLOX-L's bf16 and
YOLOX-X's fp32 and bf16 training steps (batch 8, 640 px) with the port of
each checkout ``TREE`` in turn, each in a process of its own, to compare
two commits on one card (run parent, change, change, parent).

``python3 chip_smoke.py --kernel-accuracy TREE ...`` holds the fp32 hand
kernels of each checkout at YOLOX-L's early convs and YOLOv3's stem (B=2,
320 px) against float64 convolutions beside cuDNN fp32 (mean, largest and
signed error), times the forward and data gradient, and reads the bbox
gradients' float64 referee (YOLOX-L, YOLOv3, YOLOX-X) with the hand
kernels and with cuDNN throughout, ungated, a process a tree (run parent,
change, change, parent).

``python3 chip_smoke.py --probe-worker-exit`` runs only a probe: the
training loader dropped with batches in flight with and without its
workers' exit hook (``data/dataloading.py::WorkerInit``), and the workers
that died in each; without the hook every worker has ``faulthandler`` on
for all its threads, writing to a file of its own, and the native
terminate / SIGABRT handler of ``csrc/terminate_probe.cpp`` (built for the
probe only), which writes the aborting thread's frames with their shared
objects and the worker's threads to a second file; the report carries what
those files hold.

Every phase raises on failure.  Each phase prints one JSON line; the line
before the last holds the kernels, the last line is the result.  Exits
non-zero, printing no result, where there is no card or no ``eop_tpu_torch``.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import torch

# peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12   # CUDA cores, no tensor cores
PEAK_TF32_FLOPS = 495e12  # tensor cores, dense; fp32 accuracy takes 3 products
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
PEAK_BYTES = 3.35e12      # HBM3
BN_EPS = 1e-3
FP32_TOL, BF16_TOL = 1e-4, 1e-2  # max |kernel - plain| / max(1, max |plain|)

# the JAX package's phase_conv cases (tests/test_pallas_conv.py), batch 2:
# (k, stride, padding, H, W, C, Co)
JAX_CASES = [
    (1, 1, 0, 20, 20, 64, 32),
    (3, 1, 1, 16, 24, 32, 32),
    (3, 2, 1, 32, 40, 32, 64),
    (6, 2, 2, 32, 32, 3, 32),
    (3, 2, 1, 16, 16, 64, 128),
]
# the 8 convs of the 24p-s serving path that run phase_conv, at 640 px
MAIN_PATH = [
    ("stem", (6, 2, 2, 640, 640, 3, 32)),
    ("dark2_conv", (3, 2, 1, 320, 320, 32, 64)),
    ("dark2_csp.conv1", (1, 1, 0, 160, 160, 64, 32)),
    ("dark2_csp.conv2", (1, 1, 0, 160, 160, 64, 32)),
    ("dark2_csp.m0.conv1", (1, 1, 0, 160, 160, 32, 32)),
    ("dark2_csp.m0.conv2", (3, 1, 1, 160, 160, 32, 32)),
    ("dark2_csp.conv3", (1, 1, 0, 160, 160, 64, 64)),
    ("dark3_conv", (3, 2, 1, 160, 160, 64, 128)),
]
# the 12 convs of YOLOX-L (depth 1.0, width 1.0) that run phase_conv, at 640
# px: the stem, dark2's down conv, the 9 convs of dark2's CSP layer (n=3)
# and dark3's down conv; with the forward, weight-gradient and data-gradient
# variant each takes (None: no data gradient, the stem's input is the image)
YOLOX_L_PATH = (
    [("l.stem", (6, 2, 2, 640, 640, 3, 64), "wgmma_rows", "wgmma", None),
     ("l.dark2_conv", (3, 2, 1, 320, 320, 64, 128), "wgmma_taps", "wgmma",
      "wgmma_classes")]
    + [(f"l.dark2_csp.{n}", (1, 1, 0, 160, 160, 128, 64), "wgmma_taps",
        "wgmma", "flipped:wgmma_taps") for n in ("conv1", "conv2")]
    + [(f"l.dark2_csp.m{i}.conv{j}", (k, 1, k // 2, 160, 160, 64, 64),
        "wgmma_taps", "wgmma", "flipped:wgmma_taps")
       for i in range(3) for j, k in ((1, 1), (2, 3))]
    + [("l.dark2_csp.conv3", (1, 1, 0, 160, 160, 128, 128), "wgmma_taps",
        "wgmma", "flipped:wgmma_taps"),
       ("l.dark3_conv", (3, 2, 1, 160, 160, 128, 256), "wgmma_taps", "wgmma",
        "wgmma_classes")])
# the variants of each kernel, by kind; a path's launches are counted by
# variant as "kind:variant" (chip_smoke's _launch_counts)
KERNEL_VARIANTS = {"forward": ("wgmma_taps", "wgmma_rows", "small_1x1",
                               "direct"),
                   "wgrad": ("wgmma", "cuda_cores"),
                   "dgrad": ("flipped:wgmma_taps", "wgmma_classes",
                             "small_1x1", "cuda_cores")}


# each path's launches by variant, filled as the paths run (main adds those
# it reads from the launch counts the paths return)
PATH_VARIANTS: dict = {}


def variant_counts(triples) -> dict:
    """Launches by variant of one training step whose convs take the
    (forward, weight-gradient, data-gradient) variants ``triples`` (None: no
    data gradient)."""
    return {f"{kind}:{v}": sum(t[i] == v for t in triples)
            for i, (kind, names) in enumerate(KERNEL_VARIANTS.items())
            for v in names}
SERVE_BATCH = 8
N_REQUESTS, N_CLIENTS = 32, 16
# shapes off the tensor-core predicates, odd sizes, parity classes without
# taps: the backward kernels' ragged cases, batch 3
RAGGED_BACKWARD = [
    (3, 1, 1, 12, 20, 32, 33),
    (3, 2, 1, 16, 12, 48, 64),
    (5, 1, 2, 9, 11, 32, 32),
    (6, 2, 2, 12, 10, 3, 32),
    (1, 2, 0, 8, 6, 16, 24),
    (3, 2, 1, 26, 38, 32, 32),
    (3, 1, 1, 5, 7, 70, 130),
]
TRAIN_BATCH, TRAIN_GTS = 32, 8
TRAIN_WARMUP, TRAIN_TIMED = 2, 6
ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_EXP_FILE = os.path.join(ROOT, "load_train", "yolox_24p_train.py")
# the file dataset: raw fisheye-camera frames as baseline JPEG (quality 95,
# 4:2:0, utils/synth.py's encoder) under .jpg names
# (32 images, not 64: room for 16f, every check kept)
DATASET_IMAGES, DATASET_HW = 32, (720, 1280)
# processes that encode the seeded datasets' JPEGs (the same bytes as one)
WRITERS = min(8, os.cpu_count() or 1)
# the decode phase: one seeded 720x1280 frame (utils/synth.py) as JPEG and
# PNG; sha256 of the encoded JPEGs and of every decoded array, pinned by
# tests/test_torch_image_decode.py, where cv2 decodes them to the same bytes
DECODE_SEED, DECODE_HW, DECODE_ITERS = 5, (720, 1280), 20
DECODE_DIGESTS = {
    "jpeg 4:2:0 q95":
        "83e6264a648867a6ead3a414c3f652e6d3aab4156d776d50963f7d2fc947fe8d",
    "jpeg 4:2:0 q95 file":
        "5c2bd15985e008f72846c7db136838272a774ec4929c14ba47d762fca547591d",
    "jpeg 4:4:4 q95":
        "79de51e852ea7959f354517145b2933ea534c2203fc9d9f96cb1c7d2230290b2",
    "jpeg 4:4:4 q95 file":
        "706c4095bc2e16ebc51b1384e77feb32276291f6fcb049198d0ab905482f6ae7",
    "png":
        "40b2df661d0a695701d26f48ef93bee261e79aba7623313714d7e75af015a24c",
}
# serve: frames also posted as JPEG and as PNG bodies
N_ENCODED = 4
EVAL_BATCH = 8
# launches of one training step: 8 forward convs, 8 weight gradients, 7 data
# gradients (the stem's input is the image and takes none), each data
# gradient's weight packing
STEP_LAUNCHES = {"forward": 8, "wgrad": 8, "dgrad": 7, "pack": 7}
# the tensor-core variant of each main-path gradient (dgrad: stem excluded)
WGRAD_VARIANT = "wgmma"
DGRAD_VARIANTS = {1: "flipped:wgmma_taps", 2: "wgmma_classes"}


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    smoke started (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 10, replays: int = 3) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA graph
    and replayed, so the host's work between launches (the wrappers'
    Python, the tensor maps) is not in the time, as it is in
    :func:`cuda_ms` wherever a call's kernels are shorter than it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * iters)


def conv_inputs(case, batch, dtype, seed):
    k, _, _, h, w, c, co = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((batch, h, w, c), generator=g, device="cuda")
    wgt = torch.randn((k, k, c, co), generator=g, device="cuda")
    return x.to(dtype), (wgt / (k * k * c) ** 0.5).to(dtype)


def sass_summary(_build):
    """What the built libraries hold, from ``cuobjdump -sass``: counts and one
    sample of the tensor-core (HGMMA), TMA (UTMALDG), bulk-copy (UBLKCP) and
    mbarrier (SYNCS) instructions.  The tensor-core libraries must have the
    first two."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(n for n in _build.BUILD_INFO if not _build.is_host(n))

    def dump(name):  # the libraries at once: cuobjdump takes seconds each
        return subprocess.run([tool, "-sass", str(_build._target(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout.splitlines()

    with ThreadPoolExecutor(len(names)) as pool:
        dumps = dict(zip(names, pool.map(dump, names)))
    out = {}
    for name in names:
        sass = dumps[name]
        row = {}
        for op in ("HGMMA", "UTMALDG", "UBLKCP", "SYNCS", "FFMA"):
            hits = [ln for ln in sass if f" {op}" in ln]
            row[op] = len(hits)
            if hits and op != "FFMA":
                row[f"{op}_sample"] = " ".join(hits[0].split("/*")[1].split()[1:])
        out[name] = row
    for lib in ("phase_conv", "phase_conv_backward_tc"):
        if not (out[lib]["HGMMA"] and out[lib]["UTMALDG"]):
            raise AssertionError(f"{lib}: no tensor-core or TMA instructions: "
                                 f"{out[lib]}")
    return out


def epilogue_inputs(co, seed):
    g = torch.Generator(device="cuda").manual_seed(1000 + seed)
    scale = torch.rand(co, generator=g, device="cuda") * 1.5 + 0.5   # 0.5 .. 2
    shift = torch.rand(co, generator=g, device="cuda") * 2.0 - 1.0   # -1 .. 1
    return scale, shift


@contextlib.contextmanager
def small_1x1_on_tensor_cores():
    """Lift ``ops/phase_conv.py::SMALL_1X1`` for the block: the 1x1 convs it
    sends to ``small_1x1`` take ``wgmma_taps``, to time what the rule keeps
    them from (comparisons only)."""
    from eop_tpu_torch.ops import phase_conv as pcm

    keep, pcm.SMALL_1X1 = pcm.SMALL_1X1, 0
    try:
        yield
    finally:
        pcm.SMALL_1X1 = keep


def _small_1x1(case) -> bool:
    from eop_tpu_torch.ops.phase_conv import small_1x1_fits

    k, s, _, _, _, c, co = case
    return small_1x1_fits(k, s, c, co)


def check_phase_conv(cases=None, timed: bool = True):
    """Kernel vs plain version on every shape, fp32 and bf16, with and
    without the fused epilogue; times at the main-path shapes, at the
    serving batch and at the training step's (``timed``).  ``cases``:
    (name, case, batch, expected variant or None); by default the JAX
    package's cases and the 24p-s main path."""
    import torch.nn.functional as F

    from eop_tpu_torch.ops.phase_conv import (
        out_hw,
        phase_conv,
        phase_conv_reference,
    )

    if cases is None:
        cases = ([(f"jax_case_{i}", c, 2, None)
                  for i, c in enumerate(JAX_CASES)]
                 + [(n, c, SERVE_BATCH, None) for n, c in MAIN_PATH]
                 + [(n, c, TRAIN_BATCH, None) for n, c in MAIN_PATH])
    rows, err32, err16 = [], 0.0, 0.0
    for seed, (name, case, batch, expect) in enumerate(cases):
        k, s, p, h, w, c, co = case
        row = {"name": name, "case": list(case), "batch": batch}
        scale, shift = epilogue_inputs(co, seed)
        fused = {"scale": scale, "shift": shift, "act": "silu"}
        for dtype, tol, key in ((torch.float32, FP32_TOL, "fp32"),
                                (torch.bfloat16, BF16_TOL, "bf16")):
            x, wgt = conv_inputs(case, batch, dtype, seed)
            for tag, kwargs in (("", {}), ("_fused", fused)):
                got = phase_conv(x, wgt, s, p, **kwargs)
                want = phase_conv_reference(x, wgt, s, p, **kwargs)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ref = want.float().abs().max().item()
                row[f"max_abs_err_{key}{tag}"] = err
                row[f"scale_{key}{tag}"] = ref
                if not err <= tol * max(1.0, ref):
                    raise AssertionError(
                        f"phase_conv {name} {key}{tag}: max abs err {err} > "
                        f"{tol} x {max(1.0, ref)}")
                if key == "fp32":
                    err32 = max(err32, err)
                else:
                    err16 = max(err16, err)
            row[f"variant_{key}"] = phase_conv.last_variant
            if expect is not None and phase_conv.last_variant != expect:
                raise AssertionError(f"phase_conv {name} {key} ran "
                                     f"{phase_conv.last_variant}, expected "
                                     f"{expect}")
        row["variant"] = row["variant_fp32"]
        del got, want
        if timed and batch in (SERVE_BATCH, TRAIN_BATCH):
            x, wgt = conv_inputs(case, batch, torch.float32, seed)
            x16, wgt16 = x.bfloat16(), wgt.bfloat16()
            x_nchw = x.permute(0, 3, 1, 2)           # channels_last view
            w_oihw = wgt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            # an eval-mode BatchNorm with the same folded scale and shift
            var = torch.ones_like(scale)
            gamma, mean = scale * (1.0 + BN_EPS) ** 0.5, torch.zeros_like(scale)

            def library_fused():
                y = F.conv2d(x_nchw, w_oihw, stride=s, padding=p)
                return F.silu(F.batch_norm(y, mean, var, gamma, shift, False,
                                           0.0, BN_EPS))

            row["ms"] = cuda_ms(lambda: phase_conv(x, wgt, s, p))
            row["ms_fused"] = cuda_ms(lambda: phase_conv(x, wgt, s, p, **fused))
            row["ms_bf16"] = cuda_ms(lambda: phase_conv(x16, wgt16, s, p))
            # the CUDA-core kernel, forced through the private switch no
            # path passes: what the tensor-core variants replaced
            row["direct_ms"] = cuda_ms(
                lambda: phase_conv(x, wgt, s, p, _direct=True))
            row["direct_ms_bf16"] = cuda_ms(
                lambda: phase_conv(x16, wgt16, s, p, _direct=True))
            if _small_1x1(case) or (c == 3 and batch == SERVE_BATCH):
                # the device time alone, without the host's between
                # launches: small_1x1 and the stems, beside direct's
                for key, xx, ww in (("", x, wgt), ("_bf16", x16, wgt16)):
                    row[f"device_ms{key}"] = graph_ms(
                        lambda: phase_conv(xx, ww, s, p))
                    row[f"direct_device_ms{key}"] = graph_ms(
                        lambda: phase_conv(xx, ww, s, p, _direct=True))
            if _small_1x1(case):
                # what the rule keeps this shape from: wgmma_taps
                with small_1x1_on_tensor_cores():
                    row["taps_ms"] = cuda_ms(lambda: phase_conv(x, wgt, s, p))
                    row["taps_ms_bf16"] = cuda_ms(
                        lambda: phase_conv(x16, wgt16, s, p))
                    if phase_conv.last_variant != "wgmma_taps":
                        raise AssertionError(f"{name}: not on wgmma_taps")
            x16_nchw, w16_oihw = x16.permute(0, 3, 1, 2), w_oihw.bfloat16()
            row["library_bf16_ms"] = cuda_ms(
                lambda: F.conv2d(x16_nchw, w16_oihw, stride=s, padding=p))
            row["plain_ms"] = cuda_ms(
                lambda: phase_conv_reference(x, wgt, s, p))
            row["library_ms"] = cuda_ms(
                lambda: F.conv2d(x_nchw, w_oihw, stride=s, padding=p))
            row["library_fused_ms"] = cuda_ms(library_fused)
            ho, wo = out_hw(h, w, k, s, p)
            flops = 2.0 * batch * ho * wo * co * k * k * c
            elems = x.numel() + wgt.numel() + batch * ho * wo * co
            t_bytes = 4.0 * elems / PEAK_BYTES
            t_cores = flops / PEAK_FP32_FLOPS
            # the least the card could take: fp32 on the CUDA cores, or three
            # TF32 products on the tensor cores, whichever is faster
            t_ops = min(t_cores, 3.0 * flops / PEAK_TF32_FLOPS)
            row.update(
                flops=flops, bytes=4.0 * elems,
                bound_cuda_core_ms=1e3 * max(t_cores, t_bytes),
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_bf16_ms=1e3 * max(flops / PEAK_BF16_FLOPS,
                                        2.0 * elems / PEAK_BYTES))
        rows.append(row)
    return rows, err32, err16


def decode_inputs() -> dict:
    """The decode phase's inputs: one seeded 720x1280 frame of the synthetic
    24p recipe, encoded by ``utils/synth.py`` as JPEG (quality 95, 4:2:0 and
    4:4:4) and as PNG."""
    from eop_tpu_torch.utils.synth import (
        encode_jpeg,
        encode_png,
        synthetic_24p_image,
    )

    img, _ = synthetic_24p_image(np.random.RandomState(DECODE_SEED),
                                 DECODE_HW)
    return {"jpeg 4:2:0 q95": encode_jpeg(img, 95, "4:2:0"),
            "jpeg 4:4:4 q95": encode_jpeg(img, 95, "4:4:4"),
            "png": encode_png(img)}


def decode_phase(smi: str) -> dict:
    """The host decoder on the card's host: each input decoded to its pinned
    digest, then the median of ``DECODE_ITERS`` decodes and ``image_size``
    reads on this thread."""
    import hashlib

    from eop_tpu_torch.data.image_io import image_size, imdecode

    report = {"phase": "decode", "card": smi, "height": DECODE_HW[0],
              "width": DECODE_HW[1], "iters": DECODE_ITERS, "threads": 1}
    root = tempfile.mkdtemp(prefix="chip_smoke_decode_")
    try:
        for kind, data in decode_inputs().items():
            img = imdecode(data)
            digests = {kind: hashlib.sha256(img.tobytes()).hexdigest()}
            if kind.startswith("jpeg"):
                digests[f"{kind} file"] = hashlib.sha256(data).hexdigest()
            for key, digest in digests.items():
                if digest != DECODE_DIGESTS[key]:
                    raise AssertionError(f"decode {key}: sha256 {digest}, "
                                         f"pinned {DECODE_DIGESTS[key]}")
            path = os.path.join(root, "000000000001.jpg")
            with open(path, "wb") as f:
                f.write(data)
            times = {"decode": [], "image_size": []}
            for _ in range(DECODE_ITERS):
                t0 = time.perf_counter()
                imdecode(data)
                t1 = time.perf_counter()
                image_size(path)
                times["decode"].append(1e3 * (t1 - t0))
                times["image_size"].append(1e3 * (time.perf_counter() - t1))
            report[kind] = {
                "bytes": len(data), "sha256": digests[kind],
                "decode_ms_median": float(np.median(times["decode"])),
                "decode_ms_min": float(min(times["decode"])),
                "image_size_ms_median": float(np.median(times["image_size"])),
            }
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return report


def serving_exp():
    from eop_tpu_torch.exp import get_exp

    exp = get_exp(exp_name="yolox_24p_s")
    # seeded random weights score near the squared 0.01 prior (1e-4): a low
    # threshold keeps detections flowing so the NMS does real work
    exp.test_conf = 1e-5
    return exp


def serve_bodies() -> list:
    """The 32 seeded raw 640x640 frames both serving phases post."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, (640, 640, 3), np.uint8).tobytes()
            for _ in range(N_REQUESTS)]


def serve_main_path(smi: str, exp, model):
    """The 24p-s server on the card behind the threaded HTTP front end;
    returns its report, the launch counts of this run and each request's
    detections."""
    from eop_tpu_torch.data.coco_classes import COCO_CLASSES
    from eop_tpu_torch.ops.phase_conv import phase_conv
    from eop_tpu_torch.serving.http import make_http_server
    from eop_tpu_torch.serving.service import DetectionService

    _reset_counts()
    t0 = time.perf_counter()
    svc = DetectionService.from_exp(exp, model, SERVE_BATCH, (640, 640),
                                    device="cuda", max_wait_ms=20.0,
                                    class_names=COCO_CLASSES)
    warmup_s = time.perf_counter() - t0
    server = make_http_server(svc, host="127.0.0.1", port=0)
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/detect"
    bodies = serve_bodies()
    codes, lat_ms, answers = ([None] * N_REQUESTS, [0.0] * N_REQUESTS,
                              [None] * N_REQUESTS)

    def post(body, headers):
        req = urllib.request.Request(url, data=body, method="POST",
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def client(j):
        for i in range(j, N_REQUESTS, N_CLIENTS):
            req = urllib.request.Request(url, data=bodies[i], method="POST",
                                         headers={"X-Raw-Shape": "640,640,3"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                codes[i] = r.status
                answers[i] = json.loads(r.read())["detections"]
            lat_ms[i] = (time.perf_counter() - t) * 1e3

    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(j,))
                   for j in range(N_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        wall_s = time.perf_counter() - t0
        batcher = svc.stats()  # before the encoded requests, one at a time
        encoded = encoded_requests(post, bodies[:N_ENCODED])
        torch.cuda.synchronize()
        launches = {"phase_conv": phase_conv.launches, **_variants()}
        stats = svc.stats()
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        srv.join(timeout=30)
    if any(t.is_alive() for t in clients) or codes != [200] * N_REQUESTS:
        raise AssertionError(f"HTTP codes {codes}")
    n_dets = [len(a) for a in answers]
    forwards = stats["device_calls"]  # batches + one warmup per bucket
    report = {
        "phase": "serve", "card": smi, "model": "yolox_24p_s",
        "depth": exp.depth, "width": exp.width,
        "num_classes": exp.num_classes, "test_size": list(exp.test_size),
        "batch": SERVE_BATCH, "requests": N_REQUESTS, "clients": N_CLIENTS,
        "http_200": codes.count(200), "batches": stats["batches"],
        "mean_batch_occupancy": stats["mean_batch_occupancy"],
        "forward_calls": forwards, "bucket_hits": stats["bucket_hits"],
        "valid_detections": sum(n_dets),
        "phase_conv_launches": launches["phase_conv"],
        "request_ms_p50": float(np.percentile(lat_ms, 50)),
        "request_ms_max": float(max(lat_ms)),
        "server_latency_ms_p50": batcher["latency_ms_p50"],
        "server_latency_ms_p99": batcher["latency_ms_p99"],
        "wall_s": wall_s, "warmup_s": warmup_s, **encoded,
    }
    if sum(n_dets) <= 0:
        raise AssertionError("no valid detections: the NMS did no work")
    if launches["phase_conv"] != 8 * forwards:
        raise AssertionError(f"phase_conv launches {launches['phase_conv']} "
                             f"!= 8 x {forwards} forward calls")
    return report, launches, answers


def encoded_requests(post, frames):
    """Each raw 640x640 frame posted as a JPEG (quality 95, 4:2:0) and as a
    PNG body, each followed by the raw body of its decoded pixels, one
    request at a time (both alone in a batch of the same bucket): the two
    answers must be equal.  Returns the status codes and the timings."""
    from eop_tpu_torch.data.image_io import imdecode
    from eop_tpu_torch.utils.synth import encode_jpeg, encode_png

    codes, pairs, ms = {}, 0, {"jpeg": [], "png": []}
    for raw in frames:
        frame = np.frombuffer(raw, np.uint8).reshape(640, 640, 3)
        for kind, body in (("jpeg", encode_jpeg(frame)),
                           ("png", encode_png(frame))):
            t = time.perf_counter()
            code, answer = post(body, {})
            ms[kind].append(1e3 * (time.perf_counter() - t))
            raw_code, raw_answer = post(imdecode(body).tobytes(),
                                        {"X-Raw-Shape": "640,640,3"})
            for c in (code, raw_code):
                codes[str(c)] = codes.get(str(c), 0) + 1
            if code != 200 or raw_code != 200 or (
                    answer["detections"] != raw_answer["detections"]
                    or answer["image_hw"] != [640, 640]):
                raise AssertionError(f"{kind} body: {code} vs raw "
                                     f"{raw_code}, answers differ")
            pairs += 1
    return {"encoded_http_codes": codes, "encoded_pairs_equal": pairs,
            "jpeg_request_ms_median": float(np.median(ms["jpeg"])),
            "png_request_ms_median": float(np.median(ms["png"]))}


def match_polygons(got: list, want: list, tol: float) -> bool:
    """Polygon dicts of one answer against another's: the same count, each
    of ``want`` with an unused one of ``got`` of its class whose center and
    24 radii are all within ``tol`` px."""
    if len(got) != len(want):
        return False
    if not got:
        return True

    def coords(dets):
        return np.array([d["center"] + d["radii"] for d in dets])

    dist = np.abs(coords(want)[:, None] - coords(got)[None]).max(-1)
    dist[np.array([d["class_id"] for d in want])[:, None]
         != np.array([d["class_id"] for d in got])[None]] = np.inf
    free = np.ones(len(got), bool)
    for row in dist:
        hit = int(np.argmin(np.where(free, row, np.inf)))
        if not (free[hit] and row[hit] <= tol):
            return False
        free[hit] = False
    return True


def read_http_answers(sock, n: int) -> list:
    """``n`` HTTP answers from a raw socket, in the order they arrive:
    ``[(status, JSON body, body bytes)]``."""
    buf, out = b"", []
    while len(out) < n:
        end = buf.find(b"\r\n\r\n")
        if end >= 0:
            head = buf[:end].decode("latin1").split("\r\n")
            length = next(int(ln.split(":", 1)[1]) for ln in head[1:]
                          if ln.lower().startswith("content-length:"))
            if len(buf) >= end + 4 + length:
                body = buf[end + 4:end + 4 + length]
                out.append((int(head[0].split()[1]), json.loads(body),
                            len(body)))
                buf = buf[end + 4 + length:]
                continue
        chunk = sock.recv(1 << 20)
        if not chunk:
            raise AssertionError(f"connection closed after {len(out)} of "
                                 f"{n} answers")
        buf += chunk
    return out


def host_split(svc, bodies: list, reps: int = 3) -> dict:
    """One full batch's host wall ms on the serving path, each part alone
    (median of ``reps``): the device call (letterboxed canvases in, rows on
    the host out), the answers' dicts (``_to_dicts``, on the batcher's
    dispatcher thread when served) and their JSON (``json.dumps``, on the
    front end's thread)."""
    canvases = np.stack([np.frombuffer(b, np.uint8).reshape(640, 640, 3)
                         for b in bodies])
    parts = {"device_call": [], "to_dicts": [], "json_dumps": []}
    for _ in range(reps):
        t = time.perf_counter()
        rows, valid = svc._device_call(canvases)
        parts["device_call"].append(time.perf_counter() - t)
        t = time.perf_counter()
        dicts = [svc._to_dicts(rows[i], valid[i], 1.0)
                 for i in range(len(bodies))]
        parts["to_dicts"].append(time.perf_counter() - t)
        t = time.perf_counter()
        for d in dicts:
            json.dumps({"detections": d, "image_hw": [640, 640], "ms": 0.0})
        parts["json_dumps"].append(time.perf_counter() - t)
    return {k: 1e3 * float(np.median(v)) for k, v in parts.items()}


def serve_async(smi: str, exp, model, threaded: list):
    """The 24p-s server on the card behind the event-loop front end
    (``serving/http_async.py``): the same 32 frames as the threaded phase
    from 16 clients over persistent ``http.client`` connections, then two
    detects and a stats request pipelined in one write.  The answers must
    equal the threaded phase's (``threaded``) frame by frame: the same
    count, coordinates within 1e-3 of the image scale (the batcher forms
    other batches).  Returns the report and the launch counts."""
    import http.client
    import socket

    from eop_tpu_torch.data.coco_classes import COCO_CLASSES
    from eop_tpu_torch.ops.phase_conv import phase_conv
    from eop_tpu_torch.serving.http_async import make_async_http_server
    from eop_tpu_torch.serving.service import DetectionService

    _reset_counts()
    svc = DetectionService.from_exp(exp, model, SERVE_BATCH, (640, 640),
                                    device="cuda", max_wait_ms=20.0,
                                    class_names=COCO_CLASSES)
    server = make_async_http_server(svc, host="127.0.0.1", port=0)
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()
    port = server.server_address[1]
    bodies = serve_bodies()
    codes, lat_ms, sizes, answers = ([None] * N_REQUESTS,
                                     [0.0] * N_REQUESTS, [0] * N_REQUESTS,
                                     [None] * N_REQUESTS)
    headers = {"X-Raw-Shape": "640,640,3"}

    def client(j):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            for i in range(j, N_REQUESTS, N_CLIENTS):
                t = time.perf_counter()
                conn.request("POST", "/v1/detect", body=bodies[i],
                             headers=headers)
                r = conn.getresponse()
                data = r.read()
                lat_ms[i] = (time.perf_counter() - t) * 1e3
                codes[i], sizes[i] = r.status, len(data)
                answers[i] = json.loads(data)["detections"]
        finally:
            conn.close()

    def post(body):
        return (f"POST /v1/detect HTTP/1.1\r\nHost: x\r\nX-Raw-Shape: "
                f"640,640,3\r\nContent-Length: {len(body)}\r\n\r\n"
                ).encode() + body

    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(j,))
                   for j in range(N_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        wall_s = time.perf_counter() - t0
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("GET", "/v1/stats")
            stats = json.loads(conn.getresponse().read())
        finally:
            conn.close()
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=300) as sock:
            sock.sendall(post(bodies[0]) + post(bodies[1])
                         + b"GET /v1/stats HTTP/1.1\r\nHost: x\r\n\r\n")
            piped = read_http_answers(sock, 3)
        torch.cuda.synchronize()
        launches = {"phase_conv": phase_conv.launches, **_variants()}
        calls = svc.stats()["device_calls"]
        split = host_split(svc, bodies[:SERVE_BATCH])
    finally:
        server.shutdown()
        svc.close()
        srv.join(timeout=30)
    if any(t.is_alive() for t in clients) or codes != [200] * N_REQUESTS:
        raise AssertionError(f"async HTTP codes {codes}")
    tol = 1e-3 * 640
    unequal = [i for i in range(N_REQUESTS)
               if not match_polygons(answers[i], threaded[i], tol)]
    piped_ok = ([c for c, _, _ in piped] == [200] * 3
                and all("image_hw" in b for _, b, _ in piped[:2])
                and "requests" in piped[2][1]
                and piped[2][1]["requests"] == stats["requests"] + 2
                and all(match_polygons(piped[i][1]["detections"],
                                       threaded[i], tol) for i in range(2)))
    client_p50 = float(np.percentile(lat_ms, 50))
    report = {
        "phase": "serve_async", "card": smi, "model": "yolox_24p_s",
        "frontend": "async", "batch": SERVE_BATCH, "max_wait_ms": 20.0,
        "requests": N_REQUESTS, "clients": N_CLIENTS, "persistent": True,
        "http_200": codes.count(200), "batches": stats["batches"],
        "mean_batch_occupancy": stats["mean_batch_occupancy"],
        "forward_calls": calls, "phase_conv_launches": launches["phase_conv"],
        "request_ms_p50": client_p50, "request_ms_max": float(max(lat_ms)),
        # the batcher's own latency (enqueue to result): the rest of the
        # client's time is HTTP, decode and JSON
        "server_latency_ms_p50": stats["latency_ms_p50"],
        "server_latency_ms_p99": stats["latency_ms_p99"],
        "http_json_ms_p50": client_p50 - stats["latency_ms_p50"],
        "response_bytes_mean": float(np.mean(sizes)),
        "detections_per_response": float(np.mean([len(a) for a in answers])),
        "host_split_b8_ms": split,
        "equal_to_threaded": N_REQUESTS - len(unequal),
        "pipelined_in_order": piped_ok, "wall_s": wall_s,
    }
    if unequal or not piped_ok:
        raise AssertionError(f"async answers differ from the threaded "
                             f"phase's on frames {unequal}: {report}")
    if launches["phase_conv"] != 8 * calls:
        raise AssertionError(f"phase_conv launches {launches['phase_conv']} "
                             f"!= 8 x {calls} forward calls")
    return report, launches


# the load phase's runs of tools/load_test_serving.py: (name, the spawned
# server's arguments, the tool's; the runs of one server configuration
# share one server); open-loop rates are given as fractions
# of the async closed-loop throughput at 16 clients, and taken by two
# generator processes and by one, to see whether one sets the pace
LOAD_SERVE_24P = ["-n", "yolox_24p_s", "--batch", str(SERVE_BATCH),
                  "--max-wait-ms", "20"]
LOAD_SERVE_L = ["-n", "yolox-l", "--batch", str(SERVE_BATCH),
                "--max-wait-ms", "20"]
LOAD_RUNS = (
    ("24p_s_async", LOAD_SERVE_24P + ["--frontend", "async"],
     ["--closed", "1,16,64"]),
    ("24p_s_async_open", LOAD_SERVE_24P + ["--frontend", "async"],
     ["--procs", "2", "--rates", (0.5, 0.9)]),
    ("24p_s_async_open_procs1", LOAD_SERVE_24P + ["--frontend", "async"],
     ["--procs", "1", "--rates", (0.9,)]),
    ("24p_s_async_jpeg", LOAD_SERVE_24P + ["--frontend", "async"],
     ["--jpeg", "--hw", "720,1280", "--closed", "16"]),
    ("24p_s_threaded", LOAD_SERVE_24P + ["--frontend", "threaded"],
     ["--closed", "1,16,64"]),
    ("24p_s_threaded_jpeg", LOAD_SERVE_24P + ["--frontend", "threaded"],
     ["--jpeg", "--hw", "720,1280", "--closed", "16"]),
    ("yolox_l_async", LOAD_SERVE_L + ["--frontend", "async"],
     ["--closed", "16"]),
    ("yolox_l_threaded", LOAD_SERVE_L + ["--frontend", "threaded"],
     ["--closed", "16"]),
)


def _launch_server(serve_args: list, overrides=("test_conf", "1e-5")):
    """Start ``python -m eop_tpu_torch.tools.serve SERVE_ARGS OVERRIDES`` on
    a free port; returns (process, port, its output lines, an event set once
    it listens or ends, the start time).  The pipe is drained meanwhile."""
    port = free_port()
    cmd = [sys.executable, "-m", "eop_tpu_torch.tools.serve", "--port",
           str(port), "--host", "127.0.0.1", *serve_args, *overrides]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, listening = [], threading.Event()

    def drain():  # the pipe must not fill while the server runs
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on"):
                listening.set()
        listening.set()

    threading.Thread(target=drain, daemon=True).start()
    return proc, port, lines, listening, t0


def _await_server(server):
    """(URL, banner, seconds to listen) of a :func:`_launch_server` server,
    once it listens; raises where it ended instead."""
    proc, port, lines, listening, t0 = server
    listening.wait(300)
    banner = next((ln.strip() for ln in lines
                   if ln.startswith("serving on")), "")
    if not banner or proc.poll() is not None:
        raise AssertionError(f"serve {proc.args[3:]} did not start: "
                             f"{''.join(lines)[-3000:]}")
    return f"http://127.0.0.1:{port}", banner, time.perf_counter() - t0


def _stop_server(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)


def load_run(smi: str, name: str, tool_args: list, url: str = "",
             banner: str = "", spawn=None, duration: float = 1.0) -> dict:
    """``python -m eop_tpu_torch.tools.load_test_serving --url URL ...``
    against a server of :func:`_launch_server` (its discarded warm pass,
    then its steps), or, given ``spawn`` (serve arguments), with the tool's
    own ``--spawn``: it starts the server, waits for its health and stops
    it.  Fails where the server does not report ``device=cuda``, or a row
    of at most 16 clients (or an open-loop row) has an error or no
    answer."""
    import shlex

    if spawn is not None:
        url = f"http://127.0.0.1:{free_port()}"
        tool_args = ["--spawn", shlex.join(["--host", "127.0.0.1", *spawn,
                                            "test_conf", "1e-5"]),
                     *tool_args]
    cmd = [sys.executable, "-m", "eop_tpu_torch.tools.load_test_serving",
           "--url", url, "--duration", str(duration), "--health-timeout",
           "300", *tool_args]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    lines = r.stdout.strip().splitlines()
    if spawn is not None:
        banner = next((ln.strip() for ln in lines
                       if ln.startswith("serving on")), "")
    report = {"phase": "load", "run": name, "card": smi, "server": banner,
              "spawned_by_tool": spawn is not None, "args": tool_args,
              "wall_s": time.perf_counter() - t0}
    if r.returncode or "device=cuda" not in banner:
        raise AssertionError(f"load {name}: exit {r.returncode}, {report}: "
                             f"{r.stderr[-3000:]}")
    report["table"] = table = json.loads(lines[-1])
    bad = [row for row in table if row.get("concurrency", 0) <= 16
           and (row["errors"] or not row["ok"])]
    if bad:
        raise AssertionError(f"load {name}: rows with errors or no answer "
                             f"{bad}")
    return report


def load_phase(smi: str) -> list:
    """Every run of ``LOAD_RUNS`` in turn: the first through the tool's own
    ``--spawn``, the others of one server configuration against one
    spawned server (each run its own warm pass and steps; the batch
    occupancy is each step's own); open-loop rates set from the first
    run's throughput at 16 clients.  The spawned servers all start at
    once after the first run, and the runs begin once every one listens:
    no run shares the host with a server starting."""
    (first, first_serve, first_tool), *rest = LOAD_RUNS
    reports = [load_run(smi, first, first_tool, spawn=first_serve)]
    emit(reports[-1])
    groups = {}
    for name, serve_args, tool_args in rest:
        groups.setdefault(tuple(serve_args), []).append((name, tool_args))
    servers = {args: _launch_server(list(args)) for args in groups}
    try:
        listening = {args: _await_server(server)[:2]
                     for args, server in servers.items()}
        for serve_args, runs in groups.items():
            url, banner = listening[serve_args]
            for name, tool_args in runs:
                if isinstance(tool_args[-1], tuple):
                    rps = next(row["throughput_rps"]
                               for row in reports[0]["table"]
                               if row["concurrency"] == 16)
                    tool_args = tool_args[:-1] + [",".join(
                        f"{f * rps:.1f}" for f in tool_args[-1])]
                reports.append(load_run(smi, name, tool_args, url, banner))
                emit(reports[-1])
            _stop_server(servers[serve_args][0])
    finally:
        for server in servers.values():
            _stop_server(server[0])
    return reports


def serve_relu(smi: str):
    """24p-s with ``act relu``: one batch served on the card, counts set to
    0 just before; the 8 early convs launch the kernel without its SiLU
    epilogue; then the model on the card against the CPU."""
    from eop_tpu_torch.ops.phase_conv import phase_conv

    exp = serving_exp()
    exp.act = "relu"
    model = exp.get_model("cuda")
    serve = exp.get_serving_fn(model, (640, 640), "cuda")
    raw = np.random.RandomState(3).randint(0, 256, (SERVE_BATCH, 640, 640, 3),
                                           np.uint8)
    _reset_counts()
    dets = serve(raw)
    valid = int(dets.valid.sum())
    torch.cuda.synchronize()
    launches = {"phase_conv": phase_conv.launches, **_variants()}
    fused = phase_conv.fused_launches
    del model
    report = {"phase": "serve_relu", "card": smi, "act": exp.act,
              "batch": SERVE_BATCH, "phase_conv_launches": launches[
                  "phase_conv"], "phase_conv_fused_launches": fused,
              "valid_detections": valid}
    if launches["phase_conv"] != 8 or fused != 0 or valid == 0:
        raise AssertionError(f"relu model: {report}")
    vs_cpu = card_vs_cpu(exp)
    report.update({f"card_vs_cpu_{k}": v for k, v in vs_cpu.items()
                   if k != "phase"})
    return report, launches


def serving_stages(smi: str, exp, model, iters: int = 10):
    """Device time of each stage of one serving call at the full batch
    (CUDA events, median of ``iters`` after warmup), beside the host's wall
    time of the whole call; the postprocess is the exp's family's."""
    from eop_tpu_torch.data.transforms import letterbox_batch_device
    from eop_tpu_torch.eval.postprocess import (
        postprocess_24p_heads,
        postprocess_bbox_heads,
    )
    from eop_tpu_torch.exp import Exp

    post = (postprocess_bbox_heads if isinstance(exp, Exp)
            else postprocess_24p_heads)

    raw = np.random.RandomState(2).randint(0, 256, (SERVE_BATCH, 640, 640, 3),
                                           np.uint8)
    samples = []
    for i in range(iters + 2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        with torch.inference_mode():
            ev[0].record()
            x = torch.as_tensor(raw).to("cuda")
            imgs, _ = letterbox_batch_device(x.float(), (640, 640),
                                             exp.test_size)
            ev[1].record()
            heads, _ = model(imgs.permute(0, 3, 1, 2))
            ev[2].record()
            dets = post(
                heads, exp.num_classes, conf_thre=exp.test_conf,
                nms_thre=exp.nmsthre, nms_fixpoint_iters=exp._nms_iters())
            ev[3].record()
            dets.rows.cpu()
        wall = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if i >= 2:
            samples.append([ev[0].elapsed_time(ev[1]),
                            ev[1].elapsed_time(ev[2]),
                            ev[2].elapsed_time(ev[3]), wall])
    med = np.median(np.asarray(samples), axis=0)
    # one profiled call: device time by kernel, and the busy share of wall
    serve = exp.get_serving_fn(model, (640, 640), "cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve(raw).rows.cpu()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    calls = {e.key: e.count for e in prof.key_averages()}
    # the forward kernels of the profiled call, by kernel name ("::name<":
    # templates in an anonymous namespace); conv_nhwc_kernel is direct's
    own_kernels = {f: sum(e.count for e in kernels if f"::{f}<" in e.key)
                   for f in ("conv_taps_kernel", "conv_rows_kernel",
                             "conv1x1_small_kernel", "conv_nhwc_kernel")}
    return {"phase": "stages", "card": smi, "batch": SERVE_BATCH,
            "iters": iters, "h2d_letterbox_ms": float(med[0]),
            "forward_ms": float(med[1]), "postprocess_ms": float(med[2]),
            "call_wall_ms": float(med[3]),
            "profiled_call_wall_ms": wall, "profiled_device_busy_ms": busy_ms,
            "own_kernels": own_kernels,
            "batch_norm_calls": calls.get("aten::batch_norm", 0),
            "silu_calls": (calls.get("aten::silu", 0)
                           + calls.get("aten::silu_", 0)),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def enclosing_rects(rows: torch.Tensor) -> torch.Tensor:
    """Detection rows ``[..., 29]`` -> the polygons' enclosing rectangles
    ``[..., 4]`` (the boxes the NMS and COCO-24p AP use)."""
    from eop_tpu_torch.ops.polygon import polygon_points_from_radii

    pts = polygon_points_from_radii(rows[..., :2].float(),
                                    rows[..., 2:26].float())
    return torch.cat([pts.amin(dim=-2), pts.amax(dim=-2)], dim=-1)


def detections_vs(dets, ref, boxes=enclosing_rects) -> dict:
    """Each image's detections against a reference's: the counts, and for
    each detection the best IoU of its box (``boxes`` of its rows: the
    polygon's enclosing rectangle by default) with one of the reference's
    (median, and the share at 0.5 or more; an empty box counts 0)."""
    from eop_tpu_torch.ops.boxes import bboxes_iou

    best = []
    for b in range(dets.rows.shape[0]):
        got = boxes(dets.rows[b][dets.valid[b]])
        want = boxes(ref.rows[b][ref.valid[b]]).to(got.device)
        if len(got) and len(want):
            best += bboxes_iou(got, want).amax(dim=1).cpu().tolist()
    best = np.nan_to_num(np.asarray(best, np.float64))
    return {"count": int(dets.valid.sum()), "count_ref": int(ref.valid.sum()),
            "matched_iou_median": float(np.median(best)) if len(best) else 0.0,
            "matched_iou_ge_0_5": (float(np.mean(best >= 0.5))
                                   if len(best) else 0.0)}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def serve_round(serve_args: list, requests: int = 4, what: str = "serve"):
    """``python -m eop_tpu_torch.tools.serve SERVE_ARGS`` as a user starts
    it (the card, batch 8), a few raw 640x640 requests over HTTP, then the
    server stopped: (seconds to listen, codes, detections an answer, ms a
    request, the server's stats, its last lines)."""
    port = free_port()
    cmd = [sys.executable, "-m", "eop_tpu_torch.tools.serve", *serve_args[:1],
           *serve_args[1:2], "--batch", str(SERVE_BATCH), "--host",
           "127.0.0.1", "--port", str(port), "--max-wait-ms", "20",
           *serve_args[2:]]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        while True:  # the server prints its address once it listens
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"{what} ended: {''.join(lines)}")
            lines.append(line)
            if line.startswith("serving on"):
                break
            if time.perf_counter() - t0 > 300:
                raise AssertionError(f"{what} did not start: {lines}")
        start_s = time.perf_counter() - t0
        url = f"http://127.0.0.1:{port}"
        rng = np.random.RandomState(4)
        codes, n_dets, ms = [], [], []
        for _ in range(requests):
            body = rng.randint(0, 256, (640, 640, 3), np.uint8).tobytes()
            req = urllib.request.Request(
                f"{url}/v1/detect", data=body, method="POST",
                headers={"X-Raw-Shape": "640,640,3"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                codes.append(r.status)
                n_dets.append(len(json.loads(r.read())["detections"]))
            ms.append(1e3 * (time.perf_counter() - t))
        with urllib.request.urlopen(f"{url}/v1/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
    return start_s, codes, n_dets, ms, stats, lines


def serve_exp_file(smi: str, exp_text: str, requests: int = 4) -> dict:
    """``python -m eop_tpu_torch.tools.serve -f <exp file>`` answering a few
    raw requests over HTTP (:func:`serve_round`)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    exp_path = os.path.join(root, "exp_bf16.py")
    with open(exp_path, "w") as f:
        f.write(exp_text)
    try:
        start_s, codes, n_dets, ms, stats, lines = serve_round(
            ["-f", exp_path], requests, "serve -f")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report = {"serve_f_start_s": start_s, "serve_f_http_codes": codes,
              "serve_f_detections": n_dets,
              "serve_f_request_ms_median": float(np.median(ms)),
              "serve_f_device_calls": stats.get("device_calls"),
              "serve_f_banner": [ln.strip() for ln in lines[-2:]]}
    if codes != [200] * requests or min(n_dets) <= 0:
        raise AssertionError(f"serve -f: {report}")
    return report


# a bf16 exp file as users write one (parsed by exp/build.py, not imported)
BF16_EXP_FILE = """from eop_tpu.exp import Exp24P as _Base


class Exp(_Base):
    def __init__(self):
        super().__init__()
        self.depth, self.width = 0.33, 0.50
        self.num_classes = 80
        self.compute_dtype = "bfloat16"
        self.test_conf = 1e-05
"""


def serve_bf16(smi: str, model32):
    """The bf16 24p-s serving call at B=8, 640 px: the early convs' launches
    (counts set to 0 just before one call; all fused, on the tensor-core
    variants), the detections against the fp32 path's on the same frames
    (``model32``, the same seeded weights), the stages' device time, the
    card against the CPU, and ``serve -f`` with a bf16 exp file."""
    import eop_tpu_torch.ops.phase_conv  # noqa: F401  (the module itself)

    pcm = sys.modules["eop_tpu_torch.ops.phase_conv"]
    exp = serving_exp()
    exp.compute_dtype = "bfloat16"
    model = exp.get_model("cuda")
    raw = np.random.RandomState(3).randint(0, 256, (SERVE_BATCH, 640, 640, 3),
                                           np.uint8)
    serve = exp.get_serving_fn(model, (640, 640), "cuda")
    serve(raw)  # the weights' packing and cuDNN's first calls
    launch, variants = pcm._launch_forward, []

    def recording(x, w, *args, **kwargs):
        y, variant = launch(x, w, *args, **kwargs)
        variants.append(f"{variant}:{str(x.dtype).split('.')[-1]}")
        return y, variant

    _reset_counts()
    pcm._launch_forward = recording
    try:
        dets = serve(raw)
        torch.cuda.synchronize()
    finally:
        pcm._launch_forward = launch
    launches = {"phase_conv": pcm.phase_conv.launches, **_variants()}
    fused = pcm.phase_conv.fused_launches
    ref = serving_exp().get_serving_fn(model32, (640, 640), "cuda")(raw)
    report = {"phase": "serve_bf16", "card": smi, "compute_dtype": "bfloat16",
              "batch": SERVE_BATCH, "phase_conv_launches": launches[
                  "phase_conv"], "phase_conv_fused_launches": fused,
              "variants": variants, "head_dtype": str(model.head.dtype),
              **{f"vs_fp32_{k}": v for k, v in detections_vs(dets,
                                                             ref).items()}}
    want_variants = ["wgmma_rows:bfloat16"] + ["wgmma_taps:bfloat16"] * 7
    if (launches["phase_conv"] != 8 or fused != 8
            or variants != want_variants or report["vs_fp32_count"] == 0
            or report["vs_fp32_matched_iou_median"] < 0.5):
        raise AssertionError(f"bf16 serving: {report}")
    stages = serving_stages(smi, exp, model)
    report.update({k: v for k, v in stages.items()
                   if k not in ("phase", "card")})
    del model
    vs_cpu = card_vs_cpu(exp)
    report.update({f"card_vs_cpu_{k}": v for k, v in vs_cpu.items()
                   if k != "phase"})
    report.update(serve_exp_file(smi, BF16_EXP_FILE))
    return report, launches


def remat_bn_check(smi: str) -> dict:
    """One bf16 training step at B=32 from the same seeded state on the same
    batch with and without ``remat``: the BatchNorm running statistics after
    it equal (the recompute updates nothing), ``num_batches_tracked`` 1."""
    from eop_tpu_torch.losses import Loss24PConfig
    from eop_tpu_torch.train.steps import create_train_state, make_train_step_24p

    exp = training_exp()
    exp.compute_dtype = "bfloat16"
    imgs, labels = exp.get_data_loader(TRAIN_BATCH).batch
    stats = {}
    for remat in (False, True):
        exp.remat = remat
        model = exp.get_model("cuda", seed=0)
        state = create_train_state(model, exp.get_optimizer(model,
                                                            TRAIN_BATCH),
                                   use_ema=False, with_dwa=True)
        make_train_step_24p(Loss24PConfig(num_classes=exp.num_classes))(
            state, imgs, labels)
        stats[remat] = {k: v.detach().clone() for k, v in model.named_buffers()}
        del model, state
    worst, tracked = 0.0, set()
    for k, v in stats[False].items():
        if k.endswith("num_batches_tracked"):
            tracked |= {int(v), int(stats[True][k])}
            continue
        scale = v.abs().max().clamp(min=1e-30)
        worst = max(worst, ((stats[True][k] - v).abs().max() / scale).item())
    report = {"bn_buffers": len(stats[False]),
              "bn_running_stats_max_rel_diff": worst,
              "num_batches_tracked": sorted(tracked)}
    if worst > 1e-6 or tracked != {1}:
        raise AssertionError(f"remat changed the BN statistics: {report}")
    return report


def card_vs_cpu(exp):
    """One image through the port on the card (kernels, BN and SiLU fused
    into their epilogue) and on the CPU (plain versions with the same folded
    epilogue), same seeded weights, in the exp's compute dtype: fp32 head
    maps within 1e-3 of their scale and the same count of detections; bf16
    (the two round at other points: tensor cores and cuDNN against oneDNN)
    within 5e-2 and counts within a tenth."""
    from eop_tpu_torch.data.transforms import letterbox_batch_device
    from eop_tpu_torch.eval.postprocess import postprocess_24p_heads

    raw = np.random.RandomState(1).randint(0, 256, (1, 640, 640, 3), np.uint8)
    out = {}
    for dev in ("cuda", "cpu"):
        model = exp.get_model(dev)
        with torch.inference_mode():
            x = torch.from_numpy(raw).to(dev).float()
            imgs, _ = letterbox_batch_device(x, (640, 640), exp.test_size)
            heads, _ = model(imgs.permute(0, 3, 1, 2))
            dets = postprocess_24p_heads(heads, exp.num_classes,
                                         conf_thre=exp.test_conf,
                                         nms_thre=exp.nmsthre)
        out[dev] = ([h.float().cpu() for h in heads], dets.valid.cpu())
    errs = [(g - c).abs().max().item() for g, c in zip(out["cuda"][0],
                                                       out["cpu"][0])]
    scale = max(c.abs().max().item() for c in out["cpu"][0])
    bf16 = exp.compute_dtype == "bfloat16"
    # fp32: TF32 off, ~100 layers deep
    tol = (5e-2 if bf16 else 1e-3) * max(1.0, scale)
    valid = [int(out[d][1].sum()) for d in ("cuda", "cpu")]
    report = {"phase": "card_vs_cpu", "compute_dtype": exp.compute_dtype,
              "head_max_abs_err": max(errs), "head_scale": scale, "tol": tol,
              "valid_cuda": valid[0], "valid_cpu": valid[1]}
    counts_ok = (abs(valid[0] - valid[1]) <= 0.1 * valid[1] if bf16
                 else valid[0] == valid[1])
    if not max(errs) <= tol or not counts_ok or valid[0] == 0:
        raise AssertionError(f"card and CPU disagree: {report}")
    return report


def conv_bound(flops: float, n_bytes: float):
    """(bound ms, what binds): the larger of bytes over the memory rate and
    the operations at fp32 accuracy, on the CUDA cores or as three TF32
    products on the tensor cores, whichever is faster."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = min(flops / PEAK_FP32_FLOPS, 3.0 * flops / PEAK_TF32_FLOPS)
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def check_phase_conv_backward(cases=None, timed: bool = True):
    """dgrad and wgrad against their plain versions on the main-path shapes
    (at the training step's batch 32, which is what the path gives them, and
    at batch 8) and ragged ones, fp32 and bf16; each twice, bit-equal; the
    main-path shapes on their tensor-core variants.  ``cases``: (name, case,
    batch, expected wgrad variant, expected dgrad variant or None), with
    None for both on a ragged case; by default the 24p-s main path and the
    ragged cases.  Times at the main-path
    shapes: the tensor-core kernels, the CUDA-core ones they replaced (forced
    through the wrappers' private ``_cuda_cores``, which nothing on the
    main path passes), the plain versions and ``aten::convolution_backward`` (TF32
    off; measured only); the data gradients' weight packing alone against
    its plain version, bit-equal (the times only where ``timed``)."""
    from eop_tpu_torch.ops.phase_conv import (
        dgrad_class_plan,
        dgrad_variant,
        flip_taps,
        out_hw,
        pack_taps,
        pack_taps_reference,
        phase_conv,
        phase_conv_dgrad,
        phase_conv_dgrad_reference,
        phase_conv_wgrad,
        phase_conv_wgrad_reference,
        wgrad_variant,
    )

    if cases is None:
        cases = ([(n, c, b, WGRAD_VARIANT,
                   None if n == "stem" else DGRAD_VARIANTS[c[1]])
                  for b in (TRAIN_BATCH, SERVE_BATCH) for n, c in MAIN_PATH]
                 + [(f"ragged_{i}", c, 3, None, None)
                    for i, c in enumerate(RAGGED_BACKWARD)])
    rows = []
    worst = {"dgrad": {"fp32": 0.0, "bf16": 0.0},
             "wgrad": {"fp32": 0.0, "bf16": 0.0}}
    for seed, (name, case, batch, want_w, want_d) in enumerate(cases):
        k, s, p, h, w, c, co = case
        ho, wo = out_hw(h, w, k, s, p)
        row = {"name": name, "case": list(case), "batch": batch}
        for dtype, tol, key in ((torch.float32, FP32_TOL, "fp32"),
                                (torch.bfloat16, BF16_TOL, "bf16")):
            x, wgt = conv_inputs(case, batch, dtype, seed)
            g = torch.Generator(device="cuda").manual_seed(500 + seed)
            dy = torch.randn((batch, ho, wo, co), generator=g,
                             device="cuda").to(dtype)
            dw = phase_conv_wgrad(x, dy, k, s, p)
            dw2 = phase_conv_wgrad(x, dy, k, s, p)
            row[f"wgrad_variant_{key}"] = phase_conv.last_wgrad_variant
            dx = phase_conv_dgrad(dy, wgt, x.shape, s, p)
            dx2 = phase_conv_dgrad(dy, wgt, x.shape, s, p)
            row[f"dgrad_variant_{key}"] = phase_conv.last_dgrad_variant
            torch.cuda.synchronize()
            for kind, a, b in (("wgrad", dw, dw2), ("dgrad", dx, dx2)):
                if not torch.equal(a, b):
                    raise AssertionError(f"{kind} {name} {key}: two launches "
                                         f"on one input differ")
            if want_w is not None and (
                    row[f"wgrad_variant_{key}"] != want_w
                    or want_d not in (None, row[f"dgrad_variant_{key}"])):
                raise AssertionError(f"{name} {key}: not on the expected "
                                     f"variants {want_w}, {want_d}: {row}")
            for kind, got, want in (
                    ("wgrad", dw, phase_conv_wgrad_reference(x, dy, k, s, p)),
                    ("dgrad", dx, phase_conv_dgrad_reference(
                        dy, wgt, x.shape, s, p))):
                err = (got.float() - want.float()).abs().max().item()
                ref = want.float().abs().max().item()
                row[f"{kind}_max_abs_err_{key}"] = err
                row[f"{kind}_scale_{key}"] = ref
                if not err <= tol * max(1.0, ref):
                    raise AssertionError(
                        f"{kind} {name} {key}: max abs err {err} > {tol} x "
                        f"{max(1.0, ref)}")
                worst[kind][key] = max(worst[kind][key], err)
        del dw, dw2, dx, dx2, got, want
        if timed and batch in (SERVE_BATCH, TRAIN_BATCH):
            x, wgt = conv_inputs(case, batch, torch.float32, seed)
            g = torch.Generator(device="cuda").manual_seed(500 + seed)
            dy = torch.randn((batch, ho, wo, co), generator=g, device="cuda")
            x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            w_oihw = wgt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)

            def library(mask):
                return torch.ops.aten.convolution_backward(
                    dy_nchw, x_nchw, w_oihw, None, [s, s], [p, p], [1, 1],
                    False, [0, 0], 1, mask)

            flops = 2.0 * batch * ho * wo * co * k * k * c
            row["flops"] = flops
            row["wgrad_variant"] = wgrad_variant(x.shape, co, k, s,
                                                 torch.float32)
            row["wgrad_ms"] = cuda_ms(lambda: phase_conv_wgrad(x, dy, k, s, p))
            row["wgrad_cuda_cores_ms"] = cuda_ms(lambda: phase_conv_wgrad(
                x, dy, k, s, p, _cuda_cores=True))
            row["wgrad_plain_ms"] = cuda_ms(
                lambda: phase_conv_wgrad_reference(x, dy, k, s, p), iters=5,
                warmup=1)
            row["wgrad_library_ms"] = cuda_ms(
                lambda: library([False, True, False]))
            row["wgrad_bytes"] = 4.0 * (x.numel() + dy.numel() + wgt.numel())
            row["wgrad_bound_ms"], row["wgrad_bound_by"] = conv_bound(
                flops, row["wgrad_bytes"])
            # the stem's input is the image: no data gradient on the path
            row["dgrad_on_path"] = want_d is not None
            row["dgrad_variant"] = dgrad_variant(dy.shape, wgt.shape, s, p,
                                                 torch.float32)
            row["dgrad_ms"] = cuda_ms(
                lambda: phase_conv_dgrad(dy, wgt, x.shape, s, p))
            row["dgrad_cuda_cores_ms"] = cuda_ms(lambda: phase_conv_dgrad(
                dy, wgt, x.shape, s, p, _cuda_cores=True))
            # the same without the host's time between launches
            row["dgrad_device_ms"] = graph_ms(
                lambda: phase_conv_dgrad(dy, wgt, x.shape, s, p))
            row["dgrad_cuda_cores_device_ms"] = graph_ms(
                lambda: phase_conv_dgrad(dy, wgt, x.shape, s, p,
                                         _cuda_cores=True))
            row["dgrad_plain_ms"] = cuda_ms(
                lambda: phase_conv_dgrad_reference(dy, wgt, x.shape, s, p),
                iters=5, warmup=1)
            row["dgrad_library_ms"] = cuda_ms(
                lambda: library([True, False, False]))
            row["dgrad_bytes"] = 4.0 * (x.numel() + dy.numel() + wgt.numel())
            row["dgrad_bound_ms"], row["dgrad_bound_by"] = conv_bound(
                flops, row["dgrad_bytes"])
            # the same in bf16, as the bf16 training step launches them
            x16, w16, dy16 = x.bfloat16(), wgt.bfloat16(), dy.bfloat16()
            x16_nchw, dy16_nchw = x16.permute(0, 3, 1, 2), dy16.permute(
                0, 3, 1, 2)
            w16_oihw = w_oihw.bfloat16()

            def library_bf16(mask):
                return torch.ops.aten.convolution_backward(
                    dy16_nchw, x16_nchw, w16_oihw, None, [s, s], [p, p],
                    [1, 1], False, [0, 0], 1, mask)

            bf16_bytes = 2.0 * (x.numel() + dy.numel() + wgt.numel())
            bf16_bound = 1e3 * max(flops / PEAK_BF16_FLOPS,
                                   bf16_bytes / PEAK_BYTES)
            row["wgrad_ms_bf16"] = cuda_ms(
                lambda: phase_conv_wgrad(x16, dy16, k, s, p))
            row["wgrad_cuda_cores_ms_bf16"] = cuda_ms(lambda: phase_conv_wgrad(
                x16, dy16, k, s, p, _cuda_cores=True))
            row["wgrad_library_ms_bf16"] = cuda_ms(
                lambda: library_bf16([False, True, False]))
            row["dgrad_ms_bf16"] = cuda_ms(
                lambda: phase_conv_dgrad(dy16, w16, x.shape, s, p))
            row["dgrad_cuda_cores_ms_bf16"] = cuda_ms(lambda: phase_conv_dgrad(
                dy16, w16, x.shape, s, p, _cuda_cores=True))
            row["dgrad_device_ms_bf16"] = graph_ms(
                lambda: phase_conv_dgrad(dy16, w16, x.shape, s, p))
            row["dgrad_cuda_cores_device_ms_bf16"] = graph_ms(
                lambda: phase_conv_dgrad(dy16, w16, x.shape, s, p,
                                         _cuda_cores=True))
            row["dgrad_library_ms_bf16"] = cuda_ms(
                lambda: library_bf16([True, False, False]))
            if row["dgrad_variant"] == "small_1x1":
                # the stride-1 tensor-core route small_1x1 replaced, forced
                for key, dd, ww in (("", dy, wgt), ("_bf16", dy16, w16)):
                    row[f"dgrad_flipped_ms{key}"] = cuda_ms(
                        lambda: phase_conv_dgrad(dd, ww, x.shape, s, p,
                                                 _flipped=True))
                    row[f"dgrad_flipped_device_ms{key}"] = graph_ms(
                        lambda: phase_conv_dgrad(dd, ww, x.shape, s, p,
                                                 _flipped=True))
            for kind in ("wgrad", "dgrad"):
                row[f"{kind}_bytes_bf16"] = bf16_bytes
                row[f"{kind}_bound_ms_bf16"] = bf16_bound
                row[f"{kind}_bound_by_bf16"] = (
                    "operations" if flops / PEAK_BF16_FLOPS
                    >= bf16_bytes / PEAK_BYTES else "bytes")
            if row["dgrad_on_path"] and row["dgrad_variant"] not in (
                    "cuda_cores", "small_1x1"):
                # the weight packing of this data gradient, alone (the
                # CUDA-core and small_1x1 data gradients read HWIO weights)
                taps = (flip_taps(k) if s == 1 else
                        [ky * k + kx for _, _, ts in dgrad_class_plan(k, p)
                         for ky, kx, _, _ in ts])
                got = pack_taps(wgt, taps)
                want = pack_taps_reference(wgt, taps)
                row["pack_max_abs_err"] = (got - want).abs().max().item()
                if not torch.equal(got, want):
                    raise AssertionError(f"pack_taps {name}: not bit-equal")
                row["pack_ms"] = cuda_ms(lambda: pack_taps(wgt, taps))
                row["pack_device_ms"] = graph_ms(lambda: pack_taps(wgt, taps))
                row["pack_plain_ms"] = cuda_ms(
                    lambda: pack_taps_reference(wgt, taps))
                # read w once, write hi and lo of every packed tap
                row["pack_bytes"] = 4.0 * wgt.numel() * (1 + 2 * len(taps)
                                                         / (k * k))
                row["pack_bound_ms"] = 1e3 * row["pack_bytes"] / PEAK_BYTES
        rows.append(row)
    return rows, worst


def training_exp():
    """24p-s at full width whose loader repeats one seeded synthetic batch
    that already lies on the card."""
    from eop_tpu_torch.exp import Exp24P
    from eop_tpu_torch.utils.synth import synthetic_24p_batch

    class RepeatLoader:
        def __init__(self, batch_size):
            g = torch.Generator(device="cuda").manual_seed(0)
            self.batch = synthetic_24p_batch(g, batch_size, size=640,
                                             ngt=TRAIN_GTS)

        def __len__(self):
            return TRAIN_WARMUP + TRAIN_TIMED

        def __iter__(self):
            while True:
                yield (*self.batch, None, None)

    class SmokeTrainExp(Exp24P):
        def get_data_loader(self, batch_size, is_distributed=False, rank=0,
                            world_size=1):
            self.loader = RepeatLoader(batch_size)
            return self.loader

    exp = SmokeTrainExp()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.50, 80
    exp.seed = 0
    exp.max_epoch, exp.L1_epoch = 1, 0
    exp.ema = True
    exp.print_interval = 10 ** 9  # no host fetch inside the loop
    exp.exp_name = "chip_smoke_train"
    return exp


def _launch_counts():
    """The launch counters, each kernel's also by variant ("kind:variant",
    every variant of :data:`KERNEL_VARIANTS` present)."""
    from eop_tpu_torch.ops.phase_conv import packed_weights, phase_conv

    by_variant = {"forward": phase_conv.variant_launches,
                  "wgrad": phase_conv.wgrad_variant_launches,
                  "dgrad": phase_conv.dgrad_variant_launches}
    return {"forward": phase_conv.launches, "wgrad": phase_conv.wgrad_launches,
            "dgrad": phase_conv.dgrad_launches,
            "pack": phase_conv.pack_launches,
            "weight_packs": packed_weights.packs,
            "dy_copies": phase_conv.dy_copies,
            **{f"{kind}:{v}": by_variant[kind].get(v, 0)
               for kind, names in KERNEL_VARIANTS.items() for v in names}}


def _variants(counts=None) -> dict:
    """The by-variant part of :func:`_launch_counts` (now, or of ``counts``)."""
    return {k: v for k, v in (counts or _launch_counts()).items() if ":" in k}


def _reset_counts():
    from eop_tpu_torch.ops.phase_conv import packed_weights, phase_conv

    phase_conv.launches = phase_conv.wgrad_launches = 0
    phase_conv.dgrad_launches = phase_conv.dy_copies = 0
    phase_conv.pack_launches = phase_conv.fused_launches = 0
    for counts in (phase_conv.variant_launches,
                   phase_conv.wgrad_variant_launches,
                   phase_conv.dgrad_variant_launches):
        counts.clear()
    packed_weights.packs = 0


def run_trainer(exp, want=STEP_LAUNCHES):
    """``Trainer24P(exp, ...).train()`` on the card at batch 32 for
    ``TRAIN_WARMUP + TRAIN_TIMED`` steps, the counts set to 0 just before
    it; checks the steps and the launches of every step against ``want``.
    The forward kernel's launches are also counted by phase of the step:
    in the forward, and in the backward (a ``remat`` step's recompute).
    Returns the state, the trainer, the per-step metrics and the timing
    summary."""
    from eop_tpu_torch.ops.phase_conv import phase_conv
    from eop_tpu_torch.train.trainer_24p import Trainer24P

    events, steps, forwards = [], [], []

    def hook(name, metrics=None):
        if name == "step":
            steps.append((metrics, _launch_counts(), time.perf_counter()))
            return
        forwards.append(phase_conv.launches)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    exp.output_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer = Trainer24P(exp, types.SimpleNamespace(
            batch_size=TRAIN_BATCH, device="cuda"))
        trainer.hook = hook
        t0 = time.perf_counter()
        state = trainer.train()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(exp.output_dir, ignore_errors=True)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()

    n = TRAIN_WARMUP + TRAIN_TIMED
    if len(steps) != n or state.step != n:
        raise AssertionError(f"{len(steps)} steps ran, state.step "
                             f"{state.step}, expected {n}")
    per_step, prev = [], {k: 0 for k in launches}
    for _, counts, _ in steps:
        per_step.append({k: counts[k] - prev[k] for k in counts})
        prev = counts
    for i, d in enumerate(per_step):
        if {k: d[k] for k in want} != want:
            raise AssertionError(f"step {i} launched {d}, expected {want}")
    names = ["start", "forward", "loss", "backward", "optimizer"]
    if [nm for nm, _ in events] != names * n:
        raise AssertionError("unexpected phase marks")
    # forward-kernel launches a step by phase: [start..forward],
    # [loss..backward]
    by_phase = {"in_forward": forwards[-4] - forwards[-5],
                "in_backward": forwards[-2] - forwards[-3]}
    split = []
    for i in range(TRAIN_WARMUP, n):
        ev = [e for _, e in events[5 * i: 5 * i + 5]]
        split.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)]
                     + [ev[0].elapsed_time(ev[4])])
    med = np.median(np.asarray(split), axis=0)
    # the host's clock from one step's end of enqueueing to the next: the
    # device's pace once the launch queue is full, or the host's where it
    # (the loader included) is the slower
    host_ms = [1e3 * (steps[i][2] - steps[i - 1][2])
               for i in range(TRAIN_WARMUP, n)]
    host = [{k: v.float().cpu() for k, v in m.items()} for m, _, _ in steps]
    timing = {
        "steps": n, "warmup_steps": TRAIN_WARMUP,
        "losses": [float(m["total_loss"]) for m in host],
        "num_fg": [float(m["num_fg"]) for m in host],
        "cand_dropped": [int(m["cand_dropped"]) for m in host],
        "step_ms": float(med[4]), "forward_ms": float(med[0]),
        "loss_ms": float(med[1]), "backward_ms": float(med[2]),
        "optimizer_ema_ms": float(med[3]),
        "step_ms_all": [r[4] for r in split],
        "host_step_ms": float(np.median(host_ms)),
        "host_step_ms_all": host_ms,
        "images_per_s": 1e3 * TRAIN_BATCH / float(np.median(host_ms)),
        # over all timed steps: a loader that runs dry on some steps shows
        # here, where the median hides it
        "images_per_s_timed_steps": 1e3 * TRAIN_BATCH * len(host_ms)
        / float(sum(host_ms)),
        "launches_per_step": per_step[-1],
        "forward_launches_per_step_by_phase": by_phase,
        "launches": launches,
        "max_memory_allocated_bytes": peak,
        "wall_s": wall_s,
    }
    return state, trainer, timing


def train_main_path(smi: str, compute_dtype: str = "float32",
                    remat: bool = False):
    """A few steps of ``Trainer24P`` on the card over one batch already on
    the card, in ``compute_dtype`` and with ``remat`` as the exp file would
    set them; returns the report and the launch counts of this run.  A
    ``remat`` step launches the forward kernel again in its backward's
    recompute: 16/8/7/7."""
    from eop_tpu_torch.train.steps import make_train_step_24p
    from eop_tpu_torch.losses import Loss24PConfig

    exp = training_exp()
    exp.compute_dtype, exp.remat = compute_dtype, remat
    want = dict(STEP_LAUNCHES, forward=STEP_LAUNCHES["forward"] * (1 + remat))
    state, _, timing = run_trainer(exp, want)
    if timing["forward_launches_per_step_by_phase"] != {
            "in_forward": 8, "in_backward": 8 if remat else 0}:
        raise AssertionError(f"forward launches by phase: {timing}")
    losses = timing["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")

    # one more step under the profiler: device time by kernel name; the
    # profiler can miss a trace's first kernels, so one warm-up step goes
    # before the recorded one
    step_fn = make_train_step_24p(
        Loss24PConfig(num_classes=exp.num_classes), ema_decay=exp.ema_decay)
    imgs, labels = exp.loader.batch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    traced = []
    with torch.profiler.profile(
            activities=acts, on_trace_ready=traced.append,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1)) as prof:
        for _ in range(2):
            step_fn(state, imgs, labels)
            torch.cuda.synchronize()
            prof.step()
    kernels = [e for e in traced[0].key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]

    def own(fragment):
        hits = [e for e in kernels if fragment in e.key]
        return {"count": sum(e.count for e in hits),
                "ms": sum(e.self_device_time_total for e in hits) / 1e3}

    # "::name<": the port's kernels are templates in an anonymous namespace
    own_kernels = {f: own(f"::{f}<") for f in (
        "conv_taps_kernel", "conv_rows_kernel", "wgrad_tc_kernel",
        "wgrad_tc_reduce_kernel", "dgrad_tc_kernel", "pack_taps_kernel",
        "wgrad_partial_kernel", "wgrad_reduce_kernel", "dgrad_kernel")}
    # 8 forward convs and 5 stride-1 data gradients run the forward's
    # tensor-core kernels, the 8 weight gradients and 2 stride-2 data
    # gradients the backward's, each data gradient packs its weights once;
    # the CUDA-core backward kernels do not run
    # (a remat step's recompute adds 7 + 1 forward launches)
    want = {"conv_taps_kernel": 12 + 7 * remat, "conv_rows_kernel": 1 + remat,
            "wgrad_tc_kernel": 8, "wgrad_tc_reduce_kernel": 8,
            "dgrad_tc_kernel": 2, "pack_taps_kernel": 7,
            "wgrad_partial_kernel": 0, "wgrad_reduce_kernel": 0,
            "dgrad_kernel": 0}
    if {k: v["count"] for k, v in own_kernels.items()} != want:
        raise AssertionError(f"profiled kernels {own_kernels}, expected "
                             f"counts {want}")
    own_ms = sum(v["ms"] for v in own_kernels.values())
    phase = "train" if (compute_dtype, remat) == ("float32", False) else (
        "train_remat" if remat else "train_bf16")
    report = {
        "phase": phase, "card": smi, "model": "yolox_24p_s",
        "compute_dtype": compute_dtype, "remat": remat,
        "depth": exp.depth, "width": exp.width,
        "num_classes": exp.num_classes, "input_size": list(exp.input_size),
        "batch": TRAIN_BATCH, "gts_per_image": TRAIN_GTS, **timing,
        "profiled_device_busy_ms": busy_ms,
        "own_kernels": own_kernels,
        # the hand-written kernels' device time and share of the step
        "own_kernels_ms": own_ms, "own_kernels_share": own_ms / busy_ms,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "ms": e.self_device_time_total / 1e3} for e in top],
    }
    return report, timing["launches"]


def train_card_vs_cpu(compute_dtype: str = "float32"):
    """Forward, assignment, loss and backward of one batch (B = 2, 640 px)
    on the card and on the CPU from the same seeded state.  fp32: the loss
    within 1e-4, the same assignment, every gradient within 1e-3 of its
    largest value.  bf16: the two round at other points (tensor-core convs
    and the fused kernels on the card, oneDNN on the CPU) and the loss is
    discrete, as in tests/test_torch_bf16.py: the loss within 5e-2, the
    foreground count within a quarter, the gradients finite and their
    median cosine reported."""
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.losses import (
        DWAState,
        Loss24PConfig,
        loss_24p,
        simota_assign_24p,
    )
    from eop_tpu_torch.models.yolox import training_outputs
    from eop_tpu_torch.utils.synth import synthetic_24p_batch

    exp = get_exp(exp_name="yolox_24p_s")
    exp.compute_dtype = compute_dtype
    config = Loss24PConfig(num_classes=exp.num_classes)
    imgs, labels = synthetic_24p_batch(torch.Generator().manual_seed(1), 2,
                                       size=640, ngt=TRAIN_GTS)
    t0 = time.perf_counter()
    out = {}
    for dev in ("cuda", "cpu"):
        model = exp.get_model(dev, seed=0).train()
        heads, _ = model(imgs.to(dev).permute(0, 3, 1, 2))
        decoded, origin, grids, strides = training_outputs(heads, reg_dim=26)
        lab = labels.to(dev)
        with torch.no_grad():
            d = decoded.float()
            assign = simota_assign_24p(
                lab[..., 1:], lab[..., 0], lab.sum(dim=2) > 0, d[..., :26],
                d[..., 26], d[..., 27:], grids, strides, config)
        total, _, _ = loss_24p(decoded, origin, lab, grids, strides,
                               DWAState.init(dev), config)
        total.backward()
        out[dev] = (total.item(), assign.fg_mask.cpu(),
                    assign.matched_gt.cpu(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    same = (torch.equal(out["cuda"][1], out["cpu"][1])
            and torch.equal(out["cuda"][2], out["cpu"][2]))
    worst, worst_name, cosines = 0.0, None, []
    for tensor, g in out["cpu"][3].items():
        got = out["cuda"][3][tensor]
        err = ((got - g).abs().max() / g.abs().max().clamp(min=1e-30)).item()
        if err > worst:
            worst, worst_name = err, tensor
        a, b = got.double().flatten(), g.double().flatten()
        if b.norm() > 0:
            cosines.append((a @ b / (a.norm() * b.norm())).item())
    fg = [int(out[d][1].sum()) for d in ("cuda", "cpu")]
    bf16 = compute_dtype == "bfloat16"
    report = {"phase": "train_card_vs_cpu", "compute_dtype": compute_dtype,
              "batch": 2, "loss_cuda": out["cuda"][0],
              "loss_cpu": out["cpu"][0], "loss_rel_err": rel,
              "loss_tol": 5e-2 if bf16 else 1e-4,
              "assignment_equal": same,
              "num_fg": fg[1], "num_fg_cuda": fg[0],
              "grad_tensors": len(out["cpu"][3]),
              "grad_worst_rel_to_max": worst, "grad_worst_tensor": worst_name,
              "grad_tol": None if bf16 else 1e-3,
              "grad_cosine_median": float(np.median(cosines)),
              "grad_cosine_min": min(cosines),
              "wall_s": time.perf_counter() - t0}
    if bf16:
        ok = (rel <= 5e-2 and abs(fg[0] - fg[1]) <= 0.25 * fg[1]
              and all(torch.isfinite(g).all() for g in out["cuda"][3].values()))
    else:
        ok = rel <= 1e-4 and same and worst <= 1e-3
    if not (ok and fg[1] > 0):
        raise AssertionError(f"card and CPU disagree: {report}")
    return report


def write_dataset(root: str):
    """The seeded synthetic 24p dataset the file phases read
    (``utils/synth.write_24p_dataset``: baseline JPEG, quality 95, 4:2:0)."""
    from eop_tpu_torch.utils.synth import write_24p_dataset

    t0 = time.perf_counter()
    img_dir, lab_dir = write_24p_dataset(root, DATASET_IMAGES, DATASET_HW,
                                         fmt="jpeg", workers=WRITERS)
    seconds = time.perf_counter() - t0
    n_bytes = sum(e.stat().st_size for d in (img_dir, lab_dir)
                  for e in os.scandir(d))
    report = {"phase": "dataset", "images": DATASET_IMAGES,
              "height": DATASET_HW[0], "width": DATASET_HW[1],
              "format": "baseline JPEG, quality 95, 4:2:0", "bytes": n_bytes,
              "writers": WRITERS, "seconds": seconds}
    return img_dir, lab_dir, report


class TimedIter:
    """An iterator that records the host's wait for each item."""

    def __init__(self, it, waits):
        self.it, self.waits = it, waits

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = next(self.it)
        self.waits.append(time.perf_counter() - t0)
        return item


class TimedLoader:
    """A loader whose iterator records the host's wait for each batch."""

    def __init__(self, loader):
        self.loader, self.waits = loader, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return TimedIter(iter(self.loader), self.waits)


def train_files(smi: str, img_dir: str, lab_dir: str, repeated: dict):
    """24p-s trained from the files through the exp file and the exp's own
    loader (workers from the file), at the repeated-batch phase's batch and
    steps; returns the report and the launch counts of this run."""
    from eop_tpu_torch.exp import get_exp

    exp = get_exp(TRAIN_EXP_FILE)
    own_loader = exp.get_data_loader

    def timed_loader(*args, **kwargs):
        exp.timed_loader = TimedLoader(own_loader(*args, **kwargs))
        return exp.timed_loader

    exp.get_data_loader = timed_loader
    iters = DATASET_IMAGES // TRAIN_BATCH
    exp.merge(["max_epoch", str(-(-(TRAIN_WARMUP + TRAIN_TIMED) // iters)),
               "L1_epoch", "0", "ema", "True", "seed", "0",
               "data_dir", img_dir, "label_dir", lab_dir,
               "print_interval", str(10 ** 9), "ckpt_interval", "1000",
               "exp_name", "chip_smoke_train_files"])
    state, trainer, timing = run_trainer(exp)
    if not all(np.isfinite(timing["losses"])):
        raise AssertionError(f"losses not finite: {timing['losses']}")
    waits = exp.timed_loader.waits
    wait_ms = [1e3 * t for t in waits[TRAIN_WARMUP:]]
    report = {
        "phase": "train_files", "card": smi, "exp_file":
        "load_train/yolox_24p_train.py", "depth": exp.depth,
        "width": exp.width, "num_classes": exp.num_classes,
        "input_size": list(exp.input_size), "batch": TRAIN_BATCH,
        "data_num_workers": exp.data_num_workers,
        "dataset_images": DATASET_IMAGES, "iters_per_epoch":
        trainer.iters_per_epoch, **timing,
        "data_wait_ms_median": float(np.median(wait_ms)),
        "data_wait_ms_max": float(max(wait_ms)),
        "data_wait_ms_all": wait_ms,
        "first_batch_wait_s": waits[0],
        "repeated_batch_step_ms": repeated["step_ms"],
        "repeated_batch_host_step_ms": repeated["host_step_ms"],
        "loader_cost_ms": timing["host_step_ms"] - repeated["host_step_ms"],
    }
    if exp.data_num_workers != 4 or trainer.iters_per_epoch != iters:
        raise AssertionError(f"exp file not applied: {report}")
    del state
    return report, timing["launches"]


def eval_files(smi: str, img_dir: str, lab_dir: str):
    """``Evaluator24P`` over the files at batch 8 through ``Exp24P.eval``
    with the seeded 24p-s model, then with the label oracle; returns the
    report and the launch counts of the model's run."""
    from eop_tpu_torch.eval import fast_cocoeval
    from eop_tpu_torch.ops.phase_conv import phase_conv
    from eop_tpu_torch.utils.synth import LabelOracle

    exp = serving_exp()
    exp.data_dir, exp.label_dir, exp.data_num_workers = img_dir, lab_dir, 4
    model = exp.get_model("cuda")
    evaluator = exp.get_evaluator(EVAL_BATCH)
    _reset_counts()
    t0 = time.perf_counter()
    ap5095, ap50, summary = exp.eval(model, evaluator)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"phase_conv": phase_conv.launches, **_variants()}
    fused = phase_conv.fused_launches
    tm = evaluator.timings
    forwards = tm["batches"] + 1  # the first batch runs twice
    report = {
        "phase": "eval", "card": smi, "model": "yolox_24p_s",
        "test_size": list(exp.test_size), "batch": EVAL_BATCH,
        "test_conf": exp.test_conf, "data_num_workers": exp.data_num_workers,
        **tm, "wall_s": wall_s, "images_per_s": tm["images"] / wall_s,
        "inference_ms_per_batch": 1e3 * tm["inference_s"] / tm["batches"],
        "data_wait_ms_per_batch": 1e3 * tm["data_wait_s"] / tm["batches"],
        "data_wait_ms_per_batch_after_first": 1e3 * (
            tm["data_wait_s"] - tm["first_batch_wait_s"]) / tm["batches"],
        "images_per_s_after_first_batch": tm["images"] / (
            wall_s - tm["first_batch_wait_s"]),
        "detections_per_image": tm["detections"] / tm["images"],
        "phase_conv_launches": launches["phase_conv"],
        "phase_conv_launches_per_batch": launches["phase_conv"] / forwards,
        "phase_conv_fused_launches": fused,
        "ap50_95": float(ap5095), "ap50": float(ap50),
        "summary": summary.splitlines(),
    }
    if (tm["images"] != DATASET_IMAGES or tm["detections"] == 0
            or launches["phase_conv"] != 8 * forwards
            or fused != launches["phase_conv"]):
        raise AssertionError(f"eval over the files: {report}")

    # the oracle: the labels as detections on the card; no workers, so the
    # oracle and the loader see one dataset
    exp.data_num_workers = 0
    oracle_ev = exp.get_evaluator(EVAL_BATCH)
    fast_cocoeval.match_image.native_calls = 0
    o5095, o50, o_summary = oracle_ev.evaluate(
        LabelOracle(oracle_ev.dataloader.dataset, "cuda"))
    report.update(oracle_ap50_95=float(o5095), oracle_ap50=float(o50),
                  oracle_native_matcher_calls=
                  fast_cocoeval.match_image.native_calls,
                  oracle_cocoeval_s=oracle_ev.timings["cocoeval_s"])
    if not (abs(o50 - 1.0) <= 1e-6 and abs(o5095 - 1.0) <= 1e-6
            and fast_cocoeval.match_image.native_calls > 0):
        raise AssertionError(f"oracle AP is not 1: {o_summary}")
    return report, launches


class FaultLogInit:
    """``worker_init_fn`` of the probe's loaders without the exit hook:
    ``faulthandler`` on for every thread of the worker, writing to a file of
    its own in ``directory``, then the native terminate / SIGABRT handler
    of ``csrc/terminate_probe.cpp``, which names the aborting thread, its
    frames' shared objects and every thread of the worker in a second file
    (``*.native.txt``); then the exp's seed reset."""

    def __init__(self, directory: str):
        self.directory = directory

    def __call__(self, worker_id: int) -> None:
        import ctypes
        import faulthandler

        from eop_tpu_torch import _build
        from eop_tpu_torch.data.dataloading import worker_init_reset_seed

        path = os.path.join(self.directory,
                            f"worker{worker_id}-pid{os.getpid()}")
        # faulthandler keeps the file open until the process ends
        faulthandler.enable(open(path + ".txt", "w"), all_threads=True)
        # installed after faulthandler: it dumps first, then hands the
        # signal on to faulthandler's handler
        install = _build.load("terminate_probe").terminate_probe_install
        install.argtypes, install.restype = [ctypes.c_char_p], ctypes.c_int
        err = install((path + ".native.txt").encode())
        if err:
            raise OSError(err, "terminate_probe_install failed")
        worker_init_reset_seed(worker_id)


def native_dump(text: str) -> dict:
    """One native dump (``csrc/terminate_probe.cpp``): what aborted the
    worker on which thread, the frames' shared objects and symbols, and the
    worker's threads."""
    lines = text.splitlines()

    def section(title):
        i = next((j for j, ln in enumerate(lines) if ln.startswith(title)),
                 None)
        out = []
        for ln in ([] if i is None else lines[i + 1:]):
            if ln.startswith(("-- ", "== ")):
                break
            out.append(ln.strip())
        return out

    return {"aborted": [ln for ln in lines
                        if ln.startswith("== ") and ln != "== end"],
            "objects": section("-- objects")[:24],
            "threads": section("-- threads")}


def fault_dumps(directory: str, lines: int = 40) -> dict:
    """What the workers' files hold: how many faulthandler files are not
    empty, the threads each names and the head of up to four of them; the
    native dumps, each parsed (:func:`native_dump`)."""
    dumps, native = [], []
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            text = f.read()
        if name.endswith(".native.txt"):
            if text.strip():
                native.append({"file": name, **native_dump(text)})
        elif text.strip():
            dumps.append((name, text.splitlines()))
    return {
        "worker_files": sum(not n.endswith(".native.txt")
                            for n in os.listdir(directory)),
        "nonempty": len(dumps),
        "threads": [[ln for ln in body if "hread 0x" in ln]
                    for _, body in dumps],
        "heads": [{"file": name, "lines": body[:lines]}
                  for name, body in dumps[:4]],
        "native_dumps": len(native),
        "native": native[:4],
    }


def drop_loaders(img_dir: str, lab_dir: str, drops: int = 6,
                 exit_hook: bool = True, fault_dir=None) -> dict:
    """The exp file's training loader started and dropped with batches in
    flight, ``drops`` times, as the trainer drops it when training ends.
    Without ``exit_hook``, the same dataset and batches through a plain
    spawned, pinned ``DataLoader`` whose workers go through the
    interpreter's teardown (no ``WorkerInit``); with ``fault_dir`` those
    workers write faulthandler dumps there (``FaultLogInit``)."""
    from eop_tpu_torch.data.dataloading import worker_init_reset_seed
    from eop_tpu_torch.exp import get_exp

    exp = get_exp(TRAIN_EXP_FILE)
    exp.merge(["data_dir", img_dir, "label_dir", lab_dir])
    t0 = time.perf_counter()
    errors = []
    for _ in range(drops):
        loader = exp.get_data_loader(TRAIN_BATCH)
        if not exit_hook:
            loader = torch.utils.data.DataLoader(
                loader.dataset, batch_sampler=loader.batch_sampler,
                num_workers=loader.num_workers, pin_memory=True,
                worker_init_fn=(FaultLogInit(fault_dir) if fault_dir
                                else worker_init_reset_seed),
                multiprocessing_context="spawn")
        try:
            it = iter(loader)
            for _ in range(3):
                next(it)
            del it
        except RuntimeError as e:  # a dead worker seen by the loader
            if exit_hook:
                raise
            errors.append(str(e))
    return {"drops": drops, "data_num_workers": exp.data_num_workers,
            "drop_seconds": time.perf_counter() - t0, "errors": errors}


def run_cli(smi: str, img_dir: str, lab_dir: str):
    """The two command lines as users run them: train 24p-s for one epoch
    (one iteration) in bf16 (``compute_dtype bfloat16``) with an evaluation,
    then evaluate its checkpoint (fp32 weights) in fp32."""
    import re

    out = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    ap_line = re.compile(r"AP50:95\s*=\s*([0-9.]+)\s+AP50\s*=\s*([0-9.]+)")
    report = {"phase": "cli", "card": smi}
    try:
        for name, cmd in (
                ("train_24p", [
                    sys.executable, "-m", "eop_tpu_torch.tools.train_24p",
                    "-f", "load_train/yolox_24p_train.py", "-b",
                    str(TRAIN_BATCH), "--data-dir", img_dir, "--label-dir",
                    lab_dir, "--max-epoch", "1", "--eval", "eval_interval",
                    "1", "compute_dtype", "bfloat16", "output_dir", out]),
                ("eval", None)):
            if cmd is None:
                ckpt_dir = os.path.join(out, "yolox_24p")
                best = os.path.join(ckpt_dir, "best_ckpt.pth")
                ckpt = best if os.path.exists(best) else os.path.join(
                    ckpt_dir, "last_epoch_ckpt.pth")
                report["eval_ckpt"] = os.path.basename(ckpt)
                cmd = [sys.executable, "-m", "eop_tpu_torch.tools.eval",
                       "-f", "load_eval/yolox_24p_eval.py", "-c", ckpt, "-b",
                       str(EVAL_BATCH), "--data-dir", img_dir, "--label-dir",
                       lab_dir]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=600)
            report[f"{name}_wall_s"] = time.perf_counter() - t0
            report[f"{name}_rc"] = r.returncode
            # loader workers that ended abnormally when the loader stopped
            report[f"{name}_worker_aborts"] = r.stderr.count(
                "killed by signal")
            hits = ap_line.findall(r.stdout + r.stderr)
            if r.returncode != 0 or not hits:
                raise AssertionError(
                    f"{name}: rc {r.returncode}, no AP line\n"
                    f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
            report[f"{name}_ap50_95"], report[f"{name}_ap50"] = (
                float(v) for v in hits[-1])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return report

# ---------------------------------------------------------------------------
# 16f: data parallelism on the one card

# two ranks of B=16 against one process of B=32; 3 steps each
DP_WORLD, DP_BATCH, DP_STEPS = 2, 16, 3
DP_SEED, DP_LR, DP_EMA = 7, 1e-3, 0.9998
# launches of one 24p-s training step by variant (the main path's 8 convs)
DP_STEP_VARIANTS = variant_counts(
    [("wgmma_rows", "wgmma", None)]
    + [("wgmma_taps", "wgmma", "wgmma_classes")]
    + [("wgmma_taps", "wgmma", "flipped:wgmma_taps")] * 5
    + [("wgmma_taps", "wgmma", "wgmma_classes")])


def dp_batches():
    """The global batches (CPU generator: the same in every process)."""
    from eop_tpu_torch.utils.synth import synthetic_24p_batch

    g = torch.Generator().manual_seed(DP_SEED)
    return [synthetic_24p_batch(g, DP_WORLD * DP_BATCH, size=640,
                                ngt=TRAIN_GTS) for _ in range(DP_STEPS)]


def dp_steps(compute_dtype: str, group=None) -> dict:
    """``DP_STEPS`` steps of 24p-s (seeded weights, EMA) on the card: with
    a ``group``, this rank's rows of each global batch through the
    data-parallel step (``convert_global_bn``, the loss with the group,
    ``shard_train_step``); without, the whole batch in one process.  The
    first step's metrics and gradients, every step's launches by variant
    and CUDA-event ms, the state after the steps."""
    import torch.distributed as dist

    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.losses import Loss24PConfig
    from eop_tpu_torch.parallel import (
        convert_global_bn,
        shard_batch,
        shard_train_step,
    )
    from eop_tpu_torch.train.steps import create_train_state, make_train_step_24p

    exp = get_exp(exp_name="yolox_24p_s")
    exp.compute_dtype = compute_dtype
    model = exp.get_model("cuda", seed=0).train()
    if group is not None:
        convert_global_bn(model, group)
    rank = dist.get_rank(group) if group is not None else 0
    world = dist.get_world_size(group) if group is not None else 1
    state = create_train_state(
        model, exp.get_optimizer(model, DP_WORLD * DP_BATCH, lr=DP_LR),
        use_ema=True, with_dwa=True)
    step = shard_train_step(make_train_step_24p(
        Loss24PConfig(num_classes=exp.num_classes), ema_decay=DP_EMA,
        group=group), group)
    out = {"rank": rank, "world": world, "steps": []}
    for i, (imgs, labels) in enumerate(dp_batches()):
        imgs, labels = shard_batch((imgs, labels), rank, world)
        imgs, labels = imgs.cuda(), labels.cuda()
        torch.cuda.synchronize()
        _reset_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, m = step(state, imgs, labels)
        ev[1].record()
        torch.cuda.synchronize()
        counts = _launch_counts()
        out["steps"].append({
            "ms": ev[0].elapsed_time(ev[1]),
            "launches": {k: counts[k] for k in ("forward", "wgrad", "dgrad",
                                                "pack")},
            "variants": _variants(counts),
            "metrics": {k: v.float().cpu() for k, v in m.items()}})
        if i == 0:
            out["grads"] = {n: p.grad.float().cpu()
                            for n, p in model.named_parameters()}
    out["state"] = {k: v.cpu() for k, v in model.state_dict().items()}
    out["ema"] = {k: v.cpu() for k, v in {**state.ema_params,
                                           **state.ema_batch_stats}.items()}
    return out


def dp_child(rank: int, port: int, out_path: str, backend: str) -> int:
    """One of 16f's ranks on ``cuda:0``: the process group over
    ``backend``, then :func:`dp_steps` in fp32 and bf16, saved to
    ``out_path``."""
    import datetime

    import torch.distributed as dist

    from eop_tpu_torch.parallel.dist import init_distributed
    from eop_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision(torch.device("cuda"))
    init_distributed("cuda:0", f"127.0.0.1:{port}", DP_WORLD, rank,
                     timeout=datetime.timedelta(seconds=120),
                     backend=backend)
    try:
        t0 = time.perf_counter()
        res = {d: dp_steps(d, dist.group.WORLD)
               for d in ("float32", "bfloat16")}
        res["wall_s"] = time.perf_counter() - t0
        res["backend"] = dist.get_backend()
        torch.save(res, out_path)
    finally:
        dist.destroy_process_group()
    return 0


def nccl_probe_child(rank: int, port: int) -> int:
    """Two ranks on ``cuda:0`` over NCCL: one all_reduce (16f's record of
    whether NCCL takes two ranks on one device)."""
    import datetime

    import torch.distributed as dist

    from eop_tpu_torch.parallel.dist import init_distributed

    init_distributed("cuda:0", f"127.0.0.1:{port}", DP_WORLD, rank,
                     timeout=datetime.timedelta(seconds=30))
    try:
        t = torch.full((4,), float(rank + 1), device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        print(f"NCCL_PROBE_OK {t.tolist()}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def nccl_probe_start() -> tuple:
    """Start the NCCL probe's two children (two ranks on ``cuda:0``)."""
    port = free_port()
    logs = [tempfile.mktemp(prefix=f"chip_smoke_nccl{r}_") for r in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--nccl-probe-child",
         str(r), str(port)], cwd=ROOT, stdout=open(logs[r], "w"),
        stderr=subprocess.STDOUT) for r in (0, 1)]
    return procs, logs


def nccl_two_ranks_one_card(started: tuple) -> dict:
    """Whether NCCL accepted two ranks on one device: the probe's two
    children's exit codes and last lines (a refusal is the expected
    outcome)."""
    procs, logs = started
    out = {}
    for r, p in enumerate(procs):
        try:
            p.wait(timeout=90)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        with open(logs[r]) as f:
            text = f.read()
        os.unlink(logs[r])
        lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
        out[f"rank{r}"] = {"rc": p.returncode,
                           "ok": "NCCL_PROBE_OK" in text,
                           "last": " | ".join(lines[-3:])[-600:]}
    out["accepted"] = all(v["ok"] for v in out.values())
    return out


def dp_ranks_start() -> dict:
    """16f (a), started: the NCCL probe's two children and the two ranks
    (gloo: NCCL refused two ranks on one device, "Duplicate GPU detected",
    in every run), as processes beside whatever runs next."""
    backend, port = "gloo", free_port()
    outs = [tempfile.mktemp(prefix=f"chip_smoke_dp{r}_", suffix=".pt")
            for r in range(DP_WORLD)]
    logs = [o + ".log" for o in outs]
    probe = nccl_probe_start()
    ranks = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-child", str(r),
         str(port), outs[r], backend], cwd=ROOT, stdout=open(logs[r], "w"),
        stderr=subprocess.STDOUT) for r in range(DP_WORLD)]
    return {"t0": time.perf_counter(), "backend": backend, "probe": probe,
            "ranks": ranks, "outs": outs, "logs": logs,
            # every child, for stop_children
            "procs": {f"p{i}": p for i, p in enumerate([*ranks, *probe[0]])}}


def dp_ranks_phase(smi: str, started: dict) -> tuple:
    """16f (a), after :func:`dp_ranks_start`: two ranks on ``cuda:0``
    (gloo over CUDA tensors; NCCL tried beside them for two ranks on one
    device and its outcome recorded) against one process's B=32 step from
    the same state, fp32 then bf16: the first
    fp32 step's loss within 1e-4 and num_fg equal, the fp32 gradients
    within train_card_vs_cpu's 1e-3 as the whole tree's relative L2
    distance, each tensor's largest gap reported with the tensors over
    1e-3; bf16 within train_card_vs_cpu's bf16 bounds, its gradients'
    median cosine with the fp32 step no lower than the one-process bf16
    step's less 0.1 (two draws of bf16 rounding); the ranks' parameters,
    BN buffers and EMA bit-equal after the steps, every rank's step
    launching what the one-process step does, by variant (8 / 8 / 7).  The
    ranks share one card, so their step ms are no scaling figure."""
    t0 = started["t0"]
    report = {"phase": "data_parallel_ranks", "card": smi,
              "world": DP_WORLD, "batch_per_rank": DP_BATCH,
              "steps": DP_STEPS, "backend": started["backend"],
              "note": "two ranks share one H100: step ms are not a scaling "
                      "figure"}
    probe, procs = started["probe"], started["ranks"]
    outs, logs = started["outs"], started["logs"]
    try:
        one = {d: dp_steps(d) for d in ("float32", "bfloat16")}
        for r, p in enumerate(procs):
            p.wait(timeout=300)
            if p.returncode != 0:
                with open(logs[r]) as f:
                    raise AssertionError(f"rank {r}: exit {p.returncode}\n"
                                         f"{f.read()[-3000:]}")
        ranks = [torch.load(o, weights_only=False) for o in outs]
        report["nccl_two_ranks_one_card"] = nccl_two_ranks_one_card(probe)
    finally:
        for p in [*procs, *probe[0]]:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in outs + logs:
            if os.path.exists(f):
                os.unlink(f)
    if ranks[0]["backend"] != started["backend"]:
        raise AssertionError(f"the ranks ran {ranks[0]['backend']}")
    report["rank_wall_s"] = [r["wall_s"] for r in ranks]
    launches = {k: 0 for k in STEP_LAUNCHES}
    variants, failed = {}, []
    fp32_grads = one["float32"]["grads"]
    for dtype in ("float32", "bfloat16"):
        ref = one[dtype]
        m0 = ref["steps"][0]["metrics"]
        loss0, fg0 = float(m0["total_loss"]), float(m0["num_fg"])
        row = {"one_process_step_ms": [s["ms"] for s in ref["steps"]],
               "one_process_launches": ref["steps"][0]["launches"],
               "loss_one_process": loss0, "num_fg_one_process": fg0}
        if dtype == "bfloat16":
            # bf16 gradients are noise-dominated (tests/test_torch_bf16.py):
            # each side is held by its distance from the fp32 step
            row["one_process_cosine_to_fp32"] = grad_distance(
                ref["grads"], fp32_grads)["cosine_median"]
        for r, res in enumerate(ranks):
            mine = res[dtype]
            m = mine["steps"][0]["metrics"]
            rel = abs(float(m["total_loss"]) - loss0) / abs(loss0)
            mrow = row[f"rank{r}"] = {
                "step_ms": [s["ms"] for s in mine["steps"]],
                "loss": float(m["total_loss"]), "loss_rel_err": rel,
                "num_fg": float(m["num_fg"]),
                "grads": grad_distance(mine["grads"], ref["grads"]),
                "launches_per_step": [s["launches"] for s in mine["steps"]]}
            bad = [i for i, s in enumerate(mine["steps"])
                   if s["variants"] != ref["steps"][0]["variants"]
                   or {k: s["variants"][k] for k in DP_STEP_VARIANTS}
                   != DP_STEP_VARIANTS
                   or s["launches"] != STEP_LAUNCHES]
            if bad:
                failed.append(f"{dtype} rank {r}: steps {bad} launched "
                              f"{[mine['steps'][i]['variants'] for i in bad]}")
            for s in mine["steps"]:
                for k in launches:
                    launches[k] += s["launches"][k]
                for k, v in s["variants"].items():
                    variants[k] = variants.get(k, 0) + v
            finite = all(torch.isfinite(g).all()
                         for g in mine["grads"].values())
            if dtype == "float32":
                ok = (rel <= 1e-4 and mrow["num_fg"] == fg0 and finite
                      and mrow["grads"]["rel_l2"] <= 1e-3)
            else:
                # train_card_vs_cpu's bf16 bounds, and a distance from the
                # fp32 step no larger than the one-process bf16 step's
                mrow["cosine_to_fp32"] = grad_distance(
                    mine["grads"], fp32_grads)["cosine_median"]
                ok = (rel <= 5e-2 and abs(mrow["num_fg"] - fg0) <= 0.25 * fg0
                      and finite and mrow["cosine_to_fp32"]
                      >= row["one_process_cosine_to_fp32"] - 0.1)
            if not ok:
                failed.append(f"{dtype} rank {r} against one process")
        a, b = ranks[0][dtype], ranks[1][dtype]
        unequal = [k for part in ("state", "ema") for k, v in a[part].items()
                   if not torch.equal(v, b[part][k])]
        row["ranks_bit_equal"] = not unequal
        if unequal:
            failed.append(f"{dtype}: the ranks differ after {DP_STEPS} "
                          f"steps in {unequal[:5]}")
        report[dtype] = row
    report["phase_s"] = time.perf_counter() - t0
    if failed:
        raise AssertionError(f"16f: {failed}\n{json.dumps(report, default=str)}")
    return report, {**launches, **variants}


def dp_cli_start(img_dir: str, lab_dir: str, root: str) -> dict:
    """16f (b), started: ``tools.train_24p --multi-host --coordinator
    127.0.0.1:PORT --num-processes 1 --process-id 0`` over NCCL, without
    and with ``--fsdp`` (at once, each a port of its own, beside the cli
    phase),
    two epochs of phase 10's files at B=32 (2 steps)."""
    runs = {}
    for name, extra in (("replicated", []), ("fsdp", ["--fsdp"])):
        out = os.path.join(root, name)
        log = os.path.join(root, f"{name}.log")
        runs[name] = (out, log, _child([
            "eop_tpu_torch.tools.train_24p", "-b", str(TRAIN_BATCH),
            "--data-dir", img_dir, "--label-dir", lab_dir,
            "--max-epoch", "2", "--multi-host", "--coordinator",
            f"127.0.0.1:{free_port()}", "--num-processes", "1",
            "--process-id", "0", *extra, "data_num_workers", "2",
            "print_interval", "1", "output_dir", out], log))
    return {"root": root, "runs": runs, "t0": time.perf_counter(),
            "img_dir": img_dir, "lab_dir": lab_dir,
            # every child, for stop_children
            "procs": {name: proc for name, (_, _, proc) in runs.items()}}


def dp_cli_evals(started: dict) -> None:
    """16f (b), once its trainings end: each training's losses and the
    per-rank state bytes ``place_state`` logs, then each checkpoint's
    ``tools.eval`` started (a strict load, an AP line)."""
    import re

    started["report"] = {}
    started["evals"] = {}
    for name, (out, log, proc) in started["runs"].items():
        text = _child_output(proc, log, f"train_24p {name}", 600)
        placed = re.findall(r"place_state: (.*)", text)
        losses = [float(v) for v in re.findall(
            r"iter \d+/\d+ loss ([-0-9.naif]+)", text)]
        if (not placed or "world 1" not in placed[-1] or len(losses) < 2
                or not all(np.isfinite(losses))):
            raise AssertionError(f"{name}: place_state {placed}, losses "
                                 f"{losses}\n{text[-2000:]}")
        started["report"][name] = {"place_state": placed[-1],
                                   "losses": losses}
        ckpt = os.path.join(out, "yolox_24p", "last_epoch_ckpt.pth")
        elog = os.path.join(started["root"], f"{name}_eval.log")
        proc = _child([
            "eop_tpu_torch.tools.eval", "-f", "load_eval/yolox_24p_eval.py",
            "-c", ckpt, "-b", str(EVAL_BATCH), "--data-dir",
            started["img_dir"], "--label-dir", started["lab_dir"],
            "data_num_workers", "2"], elog)
        started["evals"][name] = (elog, proc)
        started["procs"][f"{name}_eval"] = proc


def dp_cli_phase(smi: str, started: dict) -> dict:
    """16f (b), finished: the evaluations' AP lines beside the trainings'
    report (:func:`dp_cli_evals`)."""
    import re

    report = {"phase": "data_parallel_cli", "card": smi, **started["report"]}
    for name, (elog, proc) in started["evals"].items():
        text = _child_output(proc, elog, f"eval {name}", 600)
        hits = re.findall(AP_LINE, text)
        if not hits:
            raise AssertionError(f"eval {name}: no AP line\n{text[-2000:]}")
        report[name]["eval_ap50_95"], report[name]["eval_ap50"] = (
            float(v) for v in hits[-1])
    report["phase_s"] = time.perf_counter() - started["t0"]
    return report


# ---------------------------------------------------------------------------
# 16g: spatial and tensor sharding on the one card

# two ranks of one data row (--spatial 2, then --tensor 2) against one
# process, each at the global batch of 8; 3 steps each
MP_WORLD, MP_BATCH, MP_STEPS = 2, 8, 3
MP_LAYOUTS = {"spatial": {"spatial": 2}, "tensor": {"tensor": 2}}
# launches of one rank's 24p-s step by variant: under --spatial the 8 convs
# take the one-process step's variants on their halo'd heights; under
# --tensor dark2's CSP m0.conv1 (1x1, 32 -> 16 of its 32 channels: C x Co =
# 512) moves to small_1x1, forward and data gradient, whose data gradient
# packs no weights
MP_STEP_VARIANTS = {
    "spatial": DP_STEP_VARIANTS,
    "tensor": variant_counts(
        [("wgmma_rows", "wgmma", None),
         ("wgmma_taps", "wgmma", "wgmma_classes")]
        + [("wgmma_taps", "wgmma", "flipped:wgmma_taps")] * 2
        + [("small_1x1", "wgmma", "small_1x1")]
        + [("wgmma_taps", "wgmma", "flipped:wgmma_taps")] * 2
        + [("wgmma_taps", "wgmma", "wgmma_classes")])}
MP_STEP_LAUNCHES = {"spatial": STEP_LAUNCHES,
                    "tensor": {**STEP_LAUNCHES, "pack": 6}}
# inference against the one-process function (the serve phase's tolerance
# on coordinates; scores 1e-3)
MP_COORD_TOL, MP_SCORE_TOL = 1e-3 * 640, 1e-3
# The fp32 gradients' relative L2 distance from one process: 16f's 1e-3,
# or twice the largest distance one process's own first step takes under
# a change of arithmetic alone (the images one ulp up; cuDNN off), where
# that is larger.  At B=8 the step's loss has near-ties (its assignment,
# the SPP's max pools) that such a change flips: on an H100 the images
# one ulp up moved the gradients 1.05e-3, cuDNN off 3.2e-3, the global
# BatchNorm's arithmetic 7.7e-3, each the one-process step against itself
# (``python3 chip_smoke.py --grad-noise``; PERF.md section 6)
MP_GRAD_TOL, MP_FLOOR_FACTOR = 1e-3, 2.0


def mp_cases() -> list:
    """(name, case, batch) of every shape the main path's 8 convs meet on a
    rank of 16g: under --spatial 2 each on its rank's 320 input rows (at
    640 px) and the halo rows it reads (``parallel.spatial.halo_rows``;
    the edge ranks' zero rows make both ranks' shapes equal), under
    --tensor 2 each on half of its output channels."""
    from eop_tpu_torch.parallel.spatial import halo_rows

    out = []
    for name, (k, s, p, h, w, c, co) in MAIN_PATH:
        above, below = halo_rows(k, s, p)
        out.append((f"spatial.{name}",
                    (k, s, p, h // 2 + above + below, w, c, co), MP_BATCH))
        out.append((f"tensor.{name}", (k, s, p, h, w, c, co // 2), MP_BATCH))
    return out


@contextlib.contextmanager
def recorded_shapes(sink: set):
    """Every ``phase_conv`` call of the model's convs adds its case ``(k,
    stride, padding, H, W, C, Co)``, batch and dtype to ``sink``."""
    from eop_tpu_torch.ops import blocks

    inner = blocks._phase_conv

    def recording(x, w, stride, padding, *args, **kwargs):
        sink.add(((w.shape[0], stride, padding, *x.shape[1:], w.shape[3]),
                  x.shape[0], str(x.dtype)))
        return inner(x, w, stride, padding, *args, **kwargs)

    blocks._phase_conv = recording
    try:
        yield sink
    finally:
        blocks._phase_conv = inner


def mp_batches():
    """The global batches (CPU generator: the same in every process)."""
    from eop_tpu_torch.utils.synth import synthetic_24p_batch

    g = torch.Generator().manual_seed(DP_SEED + 1)
    return [synthetic_24p_batch(g, MP_BATCH, size=640, ngt=TRAIN_GTS)
            for _ in range(MP_STEPS)]


def mp_images():
    """One letterboxed B=8 batch (uint8, 640 px) for 16g's inference."""
    g = torch.Generator().manual_seed(DP_SEED + 2)
    return torch.randint(0, 256, (MP_BATCH, 640, 640, 3), generator=g,
                         dtype=torch.uint8)


def mp_exp(compute_dtype: str = "float32"):
    from eop_tpu_torch.exp import get_exp

    exp = get_exp(exp_name="yolox_24p_s")
    exp.compute_dtype = compute_dtype
    exp.test_conf = 1e-5
    return exp


def mp_steps(compute_dtype: str, layout=None, batches=None,
             steps: int = MP_STEPS) -> dict:
    """``MP_STEPS`` steps of 24p-s (seeded weights, EMA) on the card: with
    a ``layout`` the ranks laid out as it asks (``make_mesh``), the model
    under the mesh (``convert_spatial``, the global BatchNorm,
    ``place_state(tensor=)``), this rank's rows of each global batch
    through ``shard_train_step``; without one, the whole batch in one
    process.  The first step's metrics and gradients (whole), every step's
    launches by variant and CUDA-event ms, the shapes ``phase_conv`` met,
    the state bytes, and the state after the steps (gathered whole)."""
    from eop_tpu_torch.losses import Loss24PConfig
    from eop_tpu_torch.parallel import (
        convert_global_bn,
        convert_spatial,
        make_mesh,
        place_state,
        shard_batch,
        shard_train_step,
        state_bytes,
        whole_tensors,
    )
    from eop_tpu_torch.train.checkpoint import state_to_payload
    from eop_tpu_torch.train.steps import (
        create_train_state,
        make_train_step_24p,
    )

    exp = mp_exp(compute_dtype)
    model = exp.get_model("cuda", seed=0).train()
    # "data": the ranks data-parallel, the layout --grad-noise compares
    mesh = make_mesh(**MP_LAYOUTS.get(layout, {})) if layout else None
    if mesh is not None and mesh.space is not None:
        convert_spatial(model, mesh.space)
    if mesh is not None and (mesh.data or mesh.space) is not None:
        convert_global_bn(model, mesh.data,
                          mesh.data_space if mesh.space else None)
    state = create_train_state(
        model, exp.get_optimizer(model, MP_BATCH, lr=DP_LR), use_ema=True,
        with_dwa=True)
    group = mesh.data if mesh is not None else None
    if mesh is not None:
        state = place_state(state, False, group, mesh.model)
    step = shard_train_step(make_train_step_24p(
        Loss24PConfig(num_classes=exp.num_classes), ema_decay=DP_EMA,
        group=group), group, False, mesh)
    out = {"steps": [], "bytes": state_bytes(state), "shapes": set()}
    for i, (imgs, labels) in enumerate((batches or mp_batches())[:steps]):
        if mesh is not None:
            imgs, labels = shard_batch((imgs, labels), mesh.data_rank,
                                       mesh.data_size, 1, mesh.space_rank,
                                       mesh.spatial)
        imgs, labels = imgs.cuda(), labels.cuda()
        torch.cuda.synchronize()
        _reset_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with recorded_shapes(out["shapes"]):
            ev[0].record()
            state, m = step(state, imgs, labels)
            ev[1].record()
        torch.cuda.synchronize()
        counts = _launch_counts()
        out["steps"].append({
            "ms": ev[0].elapsed_time(ev[1]),
            "launches": {k: counts[k] for k in STEP_LAUNCHES},
            "variants": _variants(counts),
            "metrics": {k: v.float().cpu() for k, v in m.items()}})
        if i == 0:
            grads = {n: p.grad.float() for n, p in model.named_parameters()}
            out["grads"] = {k: v.cpu() for k, v in whole_tensors(
                grads, model).items()}
    payload = state_to_payload(state)
    out["state"] = {k: v.cpu() for k, v in payload["model"].items()}
    out["ema"] = {k: v.cpu() for k, v in {
        **payload["ema_params"], **payload["ema_batch_stats"]}.items()}
    return out


def mp_infer(layout=None) -> dict:
    """16g's inference batch through the seeded 24p-s: with a ``layout``,
    ``get_sharded_infer_fn(mesh=)`` over the space pair or
    ``get_tp_infer_fn`` over the model pair; without, ``get_infer_fn`` in
    one process.  The rows, the masks, the forward launches by variant and
    the shapes ``phase_conv`` met."""
    from eop_tpu_torch.parallel import make_mesh

    exp = mp_exp()
    model = exp.get_model("cuda", seed=0).eval()
    if layout is None:
        fn = exp.get_infer_fn(model, "cuda")
    else:
        mesh = make_mesh(**MP_LAYOUTS[layout])
        fn = (exp.get_sharded_infer_fn(model, "cuda", mesh=mesh)
              if layout == "spatial" else exp.get_tp_infer_fn(model, mesh,
                                                               "cuda"))
    imgs = mp_images()
    fn(imgs)   # the first call builds the packed weights
    shapes = set()
    torch.cuda.synchronize()
    _reset_counts()
    with recorded_shapes(shapes):
        dets = fn(imgs)
        torch.cuda.synchronize()
    counts = _launch_counts()
    return {"rows": dets.rows.cpu(), "valid": dets.valid.cpu(),
            "launches": counts["forward"], "variants": _variants(counts),
            "shapes": shapes}


def mp_child(rank: int, port: int, out_path: str) -> int:
    """One of 16g's ranks on ``cuda:0`` (gloo: NCCL refuses two ranks on
    one device): for each layout, :func:`mp_steps` in fp32 and bf16 and
    :func:`mp_infer`, saved to ``out_path``."""
    import datetime

    import torch.distributed as dist

    from eop_tpu_torch.parallel.dist import init_distributed
    from eop_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision(torch.device("cuda"))
    init_distributed("cuda:0", f"127.0.0.1:{port}", MP_WORLD, rank,
                     timeout=datetime.timedelta(seconds=300),
                     backend="gloo")
    try:
        t0 = time.perf_counter()
        res = {}
        for layout in MP_LAYOUTS:
            for d in ("float32", "bfloat16"):
                res[layout, d] = mp_steps(d, layout)
            res[layout, "infer"] = mp_infer(layout)
        res["wall_s"] = time.perf_counter() - t0
        torch.save(res, out_path)
    finally:
        dist.destroy_process_group()
    return 0


def mp_grad_floor(ref: dict) -> dict:
    """The relative L2 distance of one process's first fp32 step's
    gradients from ``ref``'s under a change of arithmetic alone: the
    images one ulp up, and cuDNN off (its convs on PyTorch's own)."""
    ulp = [(torch.nextafter(i, i + 1), lb) for i, lb in mp_batches()]
    runs = {"images_one_ulp_up": mp_steps("float32", batches=ulp, steps=1)}
    keep = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        runs["cudnn_off"] = mp_steps("float32", steps=1)
    finally:
        torch.backends.cudnn.enabled = keep
    return {k: grad_distance(v["grads"], ref)["rel_l2"]
            for k, v in runs.items()}


def mp_ref_child(out_path: str) -> int:
    """16g's one-process side: the B=8 steps in fp32 and bf16 and the
    inference batch, then every hand-written kernel against its plain
    version at each shape the ranks meet (:func:`mp_cases`, fp32 and bf16,
    forward with and without the epilogue, both gradients), saved to
    ``out_path``."""
    from eop_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision(torch.device("cuda"))
    t0 = time.perf_counter()
    res = {d: mp_steps(d) for d in ("float32", "bfloat16")}
    res["grad_floor"] = mp_grad_floor(res["float32"]["grads"])
    res["infer"] = mp_infer()
    res["steps_s"] = time.perf_counter() - t0
    cases = mp_cases()
    fwd, err32, err16 = check_phase_conv(
        [(n, c, b, None) for n, c, b in cases], timed=False)
    back, worst = check_phase_conv_backward(
        [(n, c, b, WGRAD_VARIANT, None) for n, c, b in cases], timed=False)
    res["checked"] = {"cases": [(c, b) for _, c, b in cases],
                      "forward": fwd, "backward": back,
                      "max_abs_err": {"forward": [err32, err16],
                                      "backward": worst}}
    res["wall_s"] = time.perf_counter() - t0
    torch.save(res, out_path)
    return 0


def mp_start() -> dict:
    """16g, started: its two ranks and its one-process side, as processes
    beside whatever runs next."""
    port = free_port()
    outs = [tempfile.mktemp(prefix=f"chip_smoke_mp{r}_", suffix=".pt")
            for r in range(MP_WORLD + 1)]
    logs = [o + ".log" for o in outs]
    cmds = [[sys.executable, os.path.abspath(__file__), "--mp-child", str(r),
             str(port), outs[r]] for r in range(MP_WORLD)]
    cmds.append([sys.executable, os.path.abspath(__file__), "--mp-ref-child",
                 outs[-1]])
    procs = [subprocess.Popen(c, cwd=ROOT, stdout=open(log, "w"),
                              stderr=subprocess.STDOUT)
             for c, log in zip(cmds, logs)]
    return {"t0": time.perf_counter(), "ranks": procs[:-1], "ref": procs[-1],
            "outs": outs, "logs": logs,
            "procs": {f"p{i}": p for i, p in enumerate(procs)}}


def _rows_vs(got: dict, want: dict) -> dict:
    """Sharded inference against one process's: the masks equal, and the
    valid rows' coordinates and scores' largest gaps."""
    valid = want["valid"]
    same = torch.equal(got["valid"], valid)
    gap = (got["rows"] - want["rows"]).abs()
    ncoord = want["rows"].shape[-1] - 3  # x, y, 24 radii; then the scores
    coords = gap[..., :ncoord][valid].max().item() if valid.any() else 0.0
    scores = gap[..., ncoord:][valid].max().item() if valid.any() else 0.0
    return {"masks_equal": same, "valid_rows": int(valid.sum()),
            "coord_max_abs": coords, "score_max_abs": scores,
            "ok": same and bool(valid.any()) and coords <= MP_COORD_TOL
            and scores <= MP_SCORE_TOL}


def mp_phase(smi: str, started: dict) -> tuple:
    """16g, after :func:`mp_start`: two ranks on ``cuda:0`` over gloo, under
    ``--spatial 2`` then ``--tensor 2``, each against one process's B=8
    steps from the same state, fp32 then bf16 (16f's gates: the first fp32
    step's loss within 1e-4, ``num_fg`` equal, the gradients' relative L2
    distance within 1e-3, or within twice what a change of arithmetic alone
    moves one process's own step (``MP_GRAD_TOL``, ``MP_FLOOR_FACTOR``),
    with the tensors over 1e-3 listed; bf16 within
    ``train_card_vs_cpu``'s bf16 bounds and the cosine rule); the ranks'
    state, gathered whole, bit-equal after the steps; every rank's step
    launching ``MP_STEP_LAUNCHES`` by ``MP_STEP_VARIANTS`` (``small_1x1``
    for dark2's m0.conv1 under --tensor); the shapes the kernels met those
    of :func:`mp_cases`, each checked against the plain versions; the
    state bytes a rank holds; sharded inference (the space pair's rows,
    and ``shard_inference_tp``) within ``MP_COORD_TOL`` / ``MP_SCORE_TOL``
    of one process's, masks equal.  The ranks share one card: their step
    ms are no scaling figure."""
    t0 = started["t0"]
    report = {"phase": "model_parallel_ranks", "card": smi,
              "world": MP_WORLD, "global_batch": MP_BATCH,
              "steps": MP_STEPS, "backend": "gloo",
              "note": "two ranks share one H100: step ms are not a scaling "
                      "figure"}
    procs, outs, logs = started["ranks"] + [started["ref"]], \
        started["outs"], started["logs"]
    try:
        for r, p in enumerate(procs):
            p.wait(timeout=600)
            if p.returncode != 0:
                with open(logs[r]) as f:
                    raise AssertionError(f"16g process {r}: exit "
                                         f"{p.returncode}\n"
                                         f"{f.read()[-3000:]}")
        *ranks, one = [torch.load(o, weights_only=False) for o in outs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in outs + logs:
            if os.path.exists(f):
                os.unlink(f)
    report["rank_wall_s"] = [r["wall_s"] for r in ranks]
    report["one_process_wall_s"] = one["wall_s"]
    grad_tol = max(MP_GRAD_TOL, MP_FLOOR_FACTOR * max(
        one["grad_floor"].values()))
    report["fp32_grad_floor"] = {**one["grad_floor"], "gate": grad_tol}
    checked = {(tuple(c), b) for c, b in one["checked"]["cases"]}
    report["kernels_checked"] = {
        "shapes": len(checked), **one["checked"]["max_abs_err"]}
    launches = {k: 0 for k in STEP_LAUNCHES}
    variants, failed, infer_launches = {}, [], {}
    fp32_grads = one["float32"]["grads"]
    met = set()
    for layout in MP_LAYOUTS:
        for dtype in ("float32", "bfloat16"):
            ref = one[dtype]
            m0 = ref["steps"][0]["metrics"]
            loss0, fg0 = float(m0["total_loss"]), float(m0["num_fg"])
            row = {"one_process_step_ms": [s["ms"] for s in ref["steps"]],
                   "loss_one_process": loss0, "num_fg_one_process": fg0}
            if dtype == "bfloat16":
                row["one_process_cosine_to_fp32"] = grad_distance(
                    ref["grads"], fp32_grads)["cosine_median"]
            for r, res in enumerate(ranks):
                mine = res[layout, dtype]
                met |= {(c, b) for c, b, _ in mine["shapes"]}
                m = mine["steps"][0]["metrics"]
                rel = abs(float(m["total_loss"]) - loss0) / abs(loss0)
                mrow = row[f"rank{r}"] = {
                    "step_ms": [s["ms"] for s in mine["steps"]],
                    "loss": float(m["total_loss"]), "loss_rel_err": rel,
                    "num_fg": float(m["num_fg"]),
                    "grads": grad_distance(mine["grads"], ref["grads"]),
                    "launches_per_step": [s["launches"] for s in
                                          mine["steps"]],
                    "state_bytes": list(mine["bytes"])}
                want = MP_STEP_VARIANTS[layout]
                bad = [i for i, s in enumerate(mine["steps"])
                       if {k: s["variants"][k] for k in want} != want
                       or s["launches"] != MP_STEP_LAUNCHES[layout]]
                if bad:
                    failed.append(
                        f"{layout} {dtype} rank {r}: steps {bad} launched "
                        f"{[mine['steps'][i]['variants'] for i in bad]}")
                for s in mine["steps"]:
                    for k in launches:
                        launches[k] += s["launches"][k]
                    for k, v in s["variants"].items():
                        variants[k] = variants.get(k, 0) + v
                finite = all(torch.isfinite(g).all()
                             for g in mine["grads"].values())
                if dtype == "float32":
                    mrow["rel_l2_within_1e-3"] = (mrow["grads"]["rel_l2"]
                                                  <= MP_GRAD_TOL)
                    ok = (rel <= 1e-4 and mrow["num_fg"] == fg0 and finite
                          and mrow["grads"]["rel_l2"] <= grad_tol)
                else:
                    mrow["cosine_to_fp32"] = grad_distance(
                        mine["grads"], fp32_grads)["cosine_median"]
                    ok = (rel <= 5e-2
                          and abs(mrow["num_fg"] - fg0) <= 0.25 * fg0
                          and finite and mrow["cosine_to_fp32"]
                          >= row["one_process_cosine_to_fp32"] - 0.1)
                if not ok:
                    failed.append(f"{layout} {dtype} rank {r} against one "
                                  "process")
            a, b = ranks[0][layout, dtype], ranks[1][layout, dtype]
            unequal = [k for part in ("state", "ema")
                       for k, v in a[part].items()
                       if not torch.equal(v, b[part][k])]
            row["ranks_bit_equal"] = not unequal
            if unequal:
                failed.append(f"{layout} {dtype}: the ranks differ after "
                              f"{MP_STEPS} steps in {unequal[:5]}")
            report[f"{layout}_{dtype}"] = row
        irow = report[f"{layout}_infer"] = {}
        for r, res in enumerate(ranks):
            got = res[layout, "infer"]
            met |= {(c, b) for c, b, _ in got["shapes"]}
            irow[f"rank{r}"] = {**_rows_vs(got, one["infer"]),
                                "launches": got["launches"]}
            infer_launches[f"rank{r}_{layout}"] = got["variants"]
            if not irow[f"rank{r}"]["ok"] or got["launches"] != 8:
                failed.append(f"{layout} inference rank {r}: {irow}")
    report["tensor_state_bytes"] = ranks[0]["tensor", "float32"]["bytes"]
    report["shapes_met"] = len(met)
    unchecked = met - checked
    if unchecked:
        failed.append(f"kernels not checked at {sorted(unchecked)}")
    serve = {}
    for v in infer_launches.values():
        for k, n in v.items():
            serve[k] = serve.get(k, 0) + n
    off = {k: n for k, n in {**variants, **serve}.items()
           if n and k in ("forward:direct", "wgrad:cuda_cores",
                          "dgrad:cuda_cores")}
    if off:
        failed.append(f"CUDA-core kernels launched: {off}")
    report["phase_s"] = time.perf_counter() - t0
    if failed:
        raise AssertionError(f"16g: {failed}\n"
                             f"{json.dumps(report, default=str)}")
    return report, {**launches, **variants}, serve


@contextlib.contextmanager
def global_bn_arithmetic():
    """Every train-mode BatchNorm through ``global_batch_norm`` without a
    group (the global BatchNorm's sums, E[x^2] - E[x]^2 in fp32), in place
    of cuDNN's."""
    from eop_tpu_torch.ops import blocks
    from eop_tpu_torch.parallel.global_bn import global_batch_norm

    plain = blocks.BatchNorm2d.forward

    def forward(self, x):
        if not self.training:
            return plain(self, x)
        w, b, mean, var = self.vectors()
        y = global_batch_norm(x, w, b, mean, var, self.momentum, self.eps)
        with torch.no_grad():
            self.num_batches_tracked += 1
        return y

    blocks.BatchNorm2d.forward = forward
    try:
        yield
    finally:
        blocks.BatchNorm2d.forward = plain


@contextlib.contextmanager
def cudnn_off():
    keep = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = keep


def grad_noise_child(rank: int, port: int, out_path: str) -> int:
    """One of ``--grad-noise``'s two ranks: the first fp32 step's gradients
    under plain data parallelism (B=4 a rank), under --tensor 2 with dark2's
    m0.conv1 forced back onto ``wgmma_taps``, and under --spatial 2 with
    cuDNN off."""
    import datetime

    import torch.distributed as dist

    from eop_tpu_torch.parallel.dist import init_distributed
    from eop_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision(torch.device("cuda"))
    init_distributed("cuda:0", f"127.0.0.1:{port}", MP_WORLD, rank,
                     timeout=datetime.timedelta(seconds=300),
                     backend="gloo")
    try:
        res = {"data": mp_steps("float32", "data", steps=1)["grads"]}
        with small_1x1_on_tensor_cores():
            res["tensor_taps"] = mp_steps("float32", "tensor",
                                          steps=1)["grads"]
        with cudnn_off():
            res["spatial_cudnn_off"] = mp_steps("float32", "spatial",
                                                steps=1)["grads"]
        torch.save(res, out_path)
    finally:
        dist.destroy_process_group()
    return 0


def grad_noise() -> int:
    """``python3 chip_smoke.py --grad-noise``: where 16g's fp32 gradient
    distance comes from.  The relative L2 distance of 24p-s's first B=8
    fp32 step's gradients (640 px, seeded weights) from one process's: the
    same step again, with the images one ulp up, with cuDNN off, with
    every BatchNorm in the global BatchNorm's arithmetic; two ranks of data
    parallelism, of --tensor 2 with m0.conv1 on ``wgmma_taps``, and of
    --spatial 2 with cuDNN off (against one process with cuDNN off)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from eop_tpu_torch import _build
    from eop_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision(torch.device("cuda"))
    smi = nvidia_smi()
    print(smi, flush=True)
    _build.build_all()
    port = free_port()
    outs = [tempfile.mktemp(prefix=f"chip_smoke_noise{r}_", suffix=".pt")
            for r in range(MP_WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--grad-noise-child", str(r), str(port),
                               outs[r]], cwd=ROOT) for r in range(MP_WORLD)]
    try:
        one = mp_steps("float32", steps=1)["grads"]
        ulp = [(torch.nextafter(i, i + 1), lb) for i, lb in mp_batches()]
        variants = {
            "again": mp_steps("float32", steps=1)["grads"],
            "images_one_ulp_up": mp_steps("float32", batches=ulp,
                                          steps=1)["grads"]}
        with cudnn_off():
            variants["cudnn_off"] = off = mp_steps("float32",
                                                   steps=1)["grads"]
        with global_bn_arithmetic():
            variants["global_bn_arithmetic"] = mp_steps("float32",
                                                        steps=1)["grads"]
        for p in procs:
            if p.wait(timeout=600) != 0:
                raise AssertionError(f"--grad-noise rank: exit {p.returncode}")
        ranks = torch.load(outs[0], weights_only=False)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in outs:
            if os.path.exists(f):
                os.unlink(f)

    def dist_(got, ref):
        d = grad_distance(got, ref)
        return {"rel_l2": d["rel_l2"], "worst_tensor": d["worst_tensor"],
                "worst_rel_to_max": d["worst_rel_to_max"],
                "tensors_over_1e-3": len(d["tensors_over_1e-3"])}

    report = {"phase": "grad_noise", "card": smi, "batch": MP_BATCH,
              **{f"one_process_{k}": dist_(v, one)
                 for k, v in variants.items()},
              "two_ranks_data": dist_(ranks["data"], one),
              "two_ranks_tensor_taps": dist_(ranks["tensor_taps"], one),
              "two_ranks_spatial_cudnn_off_vs_one_cudnn_off": dist_(
                  ranks["spatial_cudnn_off"], off)}
    emit(report)
    return 0


def model_parallel_only() -> int:
    """``python3 chip_smoke.py --model-parallel``: the kernels built, then
    16g alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from eop_tpu_torch import _build
    from eop_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision(torch.device("cuda"))
    smi = nvidia_smi()
    print(smi, flush=True)
    _build.build_all()
    started = mp_start()
    try:
        report, _, _ = mp_phase(smi, started)
    finally:
        stop_children(started)
    emit(report)
    return 0


# ---------------------------------------------------------------------------
# the bbox family: YOLOX-L at full width from COCO files

# (32 training and 8 validation images, not 64 and 16: four steps an
# epoch, every check kept, room for 16f)
BBOX_TRAIN_IMAGES, BBOX_VAL_IMAGES, BBOX_CLASSES = 32, 8, 80
BBOX_BATCH = 8
# launches of one YOLOX-L training step: 12 forward convs, 12 weight
# gradients, 11 data gradients (not the stem's), each packing its weights
BBOX_STEP_LAUNCHES = {"forward": 12, "wgrad": 12, "dgrad": 11, "pack": 11,
                      **variant_counts([r[2:] for r in YOLOX_L_PATH])}
BBOX_WARMUP, BBOX_TIMED = 2, 4
AP_LINE = r"AP50:95\s*=\s*([0-9.]+)\s+AP50\s*=\s*([0-9.]+)"


def yolox_l_cases():
    """The YOLOX-L shapes as check_phase_conv's and
    check_phase_conv_backward's cases, at batch 8 (served and trained)."""
    fwd = [(n, c, BBOX_BATCH, v) for n, c, v, _, _ in YOLOX_L_PATH]
    back = [(n, c, BBOX_BATCH, w, d) for n, c, _, w, d in YOLOX_L_PATH]
    return fwd, back


def write_bbox_dataset(root: str):
    """The seeded COCO-format dataset of the bbox phases
    (``utils/synth.write_coco_dataset``: 720x1280 baseline JPEG, quality 95,
    4:2:0, 1-4 rectangles an image, 80 classes)."""
    from eop_tpu_torch.utils.synth import write_coco_dataset

    t0 = time.perf_counter()
    write_coco_dataset(root, BBOX_TRAIN_IMAGES, BBOX_VAL_IMAGES, DATASET_HW,
                       num_classes=BBOX_CLASSES, seed=0, fmt="jpeg",
                       workers=WRITERS)
    n_bytes = sum(e.stat().st_size for d in ("train2017", "val2017",
                                             "annotations")
                  for e in os.scandir(os.path.join(root, d)))
    return {"phase": "bbox_dataset", "train_images": BBOX_TRAIN_IMAGES,
            "val_images": BBOX_VAL_IMAGES, "num_classes": BBOX_CLASSES,
            "height": DATASET_HW[0], "width": DATASET_HW[1],
            "format": "baseline JPEG, quality 95, 4:2:0", "bytes": n_bytes,
            "writers": WRITERS, "seconds": time.perf_counter() - t0}


def train_bbox_child(out_path: str, argv) -> int:
    """``python3 chip_smoke.py --train-bbox-child OUT -- ARGS``: run
    ``eop_tpu_torch.tools.train``'s ``main(ARGS)`` in this process with a
    hook on its trainer that records, for every step, the kernel launches
    between the step's start and end, CUDA events around it, its metrics
    and the host's wait in ``next(it)``; then write them to OUT as JSON.
    The counts start at 0 with the process."""
    from eop_tpu_torch.ops.phase_conv import phase_conv
    from eop_tpu_torch.tools import train as train_cli
    from eop_tpu_torch.train import trainer as trainer_mod

    steps, waits, marks = [], [], {}

    def hook(name, metrics=None):
        # a step with --accum marks "start" once a micro-batch: it begins at
        # the first
        if name == "start" and not marks.get("in_step"):
            marks["in_step"] = True
            marks["counts"] = _launch_counts()
            marks["event"] = torch.cuda.Event(enable_timing=True)
            marks["event"].record()
        elif name == "step":
            marks["in_step"] = False
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            counts = _launch_counts()
            steps.append((marks["event"], end, {
                k: counts[k] - marks["counts"][k] for k in counts},
                metrics, time.perf_counter()))

    init, before_epoch = trainer_mod.Trainer.__init__, \
        trainer_mod.Trainer.before_epoch

    def patched_init(self, exp, args):
        init(self, exp, args)
        self.hook = hook
        marks["trainer"] = self

    def patched_before_epoch(self):
        before_epoch(self)
        if not isinstance(self._iter, TimedIter):
            self._iter = TimedIter(self._iter, waits)

    trainer_mod.Trainer.__init__ = patched_init
    trainer_mod.Trainer.before_epoch = patched_before_epoch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_cli.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trainer = marks["trainer"]
    report = {
        "wall_s": wall, "iters_per_epoch": trainer.iters_per_epoch,
        "epochs": trainer.max_epoch,
        "step_ms": [a.elapsed_time(b) for a, b, _, _, _ in steps],
        "host_end_s": [t for _, _, _, _, t in steps],
        "launches": [c for _, _, c, _, _ in steps],
        "metrics": [{k: float(v) for k, v in m.items()}
                    for _, _, _, m, _ in steps],
        "data_wait_s": waits,
        "totals": _launch_counts(),
        "fused_launches": phase_conv.fused_launches,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "best_ap50_95": trainer.best_ap,
    }
    with open(out_path, "w") as f:
        json.dump(report, f)
    return 0


def train_bbox(smi: str, data_dir: str, out_dir: str):
    """``python -m eop_tpu_torch.tools.train -n yolox-l -b 8`` over the
    dataset for two epochs of 4 steps, as a subprocess (through
    :func:`train_bbox_child`): one mosaic + mixup epoch, then the no-aug
    switch (``no_aug_epochs 0`` puts it at the start of the second epoch,
    where the reference places it), one epoch with the L1 loss; each epoch
    evaluates the EMA weights.  Checks the exit code, finite losses, L1 zero
    then positive, the launches of every step, the AP line; returns the
    report and the child's launch totals."""
    import re

    record = os.path.join(out_dir, "train_bbox.json")
    cmd = [sys.executable, os.path.abspath(__file__), "--train-bbox-child",
           record, "--", "-n", "yolox-l", "-b", str(BBOX_BATCH),
           "--data-dir", data_dir, "max_epoch", "2", "no_aug_epochs", "0",
           "eval_interval", "1", "data_num_workers", "4", "seed", "0",
           "print_interval", "4", "output_dir", out_dir]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    wall = time.perf_counter() - t0
    log = r.stdout + r.stderr
    aps = re.findall(AP_LINE, log)
    if r.returncode != 0 or not aps:
        raise AssertionError(f"train_bbox: rc {r.returncode}, AP lines "
                             f"{aps}\n{log[-6000:]}")
    with open(record) as f:
        rec = json.load(f)
    iters = rec["iters_per_epoch"]
    n = len(rec["step_ms"])
    l1 = [m["l1_loss"] for m in rec["metrics"]]
    losses = [m["total_loss"] for m in rec["metrics"]]
    bad = [i for i, c in enumerate(rec["launches"])
           if {k: c[k] for k in BBOX_STEP_LAUNCHES} != BBOX_STEP_LAUNCHES]
    host = np.diff(rec["host_end_s"])
    timed = list(range(2, iters)) + list(range(iters + 2, n))
    report = {
        "phase": "train_bbox", "card": smi, "model": "yolox_l",
        "depth": 1.0, "width": 1.0, "num_classes": BBOX_CLASSES,
        "input_size": [640, 640], "batch": BBOX_BATCH,
        "command": " ".join(cmd[4:]), "rc": r.returncode, "wall_s": wall,
        "steps": n, "iters_per_epoch": iters, "losses": losses,
        "l1_losses": l1, "num_fg": [m["num_fg"] for m in rec["metrics"]],
        "launches_per_step": rec["launches"][-1],
        "step_ms_all": rec["step_ms"],
        "step_ms": float(np.median([rec["step_ms"][i] for i in timed])),
        "step_ms_mosaic": float(np.median(rec["step_ms"][2:iters])),
        "step_ms_no_aug": float(np.median(rec["step_ms"][iters + 2:])),
        # the host's clock between step ends, over the timed steps of
        # each epoch (the loader included)
        "images_per_s_timed_steps": BBOX_BATCH * len(timed) / float(
            sum(host[i - 1] for i in timed)),
        "data_wait_ms_all": [1e3 * t for t in rec["data_wait_s"]],
        "data_wait_ms_median": 1e3 * float(np.median(
            [rec["data_wait_s"][i] for i in timed])),
        "first_batch_wait_s": rec["data_wait_s"][0],
        "switch_first_batch_wait_s": rec["data_wait_s"][iters],
        "max_memory_allocated_bytes": rec["max_memory_allocated_bytes"],
        "ap_lines": [[float(a), float(b)] for a, b in aps],
        "eval_forward_launches": rec["totals"]["forward"] - sum(
            c["forward"] for c in rec["launches"]),
        "eval_fused_launches": rec["fused_launches"],
        "worker_aborts": r.stderr.count("killed by signal"),
        "switch_logged": "No mosaic aug now" in log,
    }
    checkpoints = sorted(os.listdir(os.path.join(out_dir, "yolox_l")))
    report["checkpoints"] = checkpoints
    if (n != 2 * iters or bad or not all(np.isfinite(losses))
            or any(v != 0 for v in l1[:iters])
            or not all(v > 0 for v in l1[iters:])
            or len(aps) != 2 or not report["switch_logged"]
            or "last_mosaic_epoch_ckpt.pth" not in checkpoints
            or report["eval_fused_launches"] != report["eval_forward_launches"]
            or report["eval_forward_launches"] <= 0):
        raise AssertionError(f"train_bbox: steps {bad} launched otherwise "
                             f"than {BBOX_STEP_LAUNCHES}, or: {report}")
    return report, rec["totals"], rec["launches"]


def bbox_synthetic_batch(batch: int, size: int, gts: int = 8, seed: int = 0,
                         device="cuda"):
    """Images ``[B, S, S, 3]`` in 0..255 and label rows ``[B, 120, 5]`` (cls,
    cx, cy, w, h) with ``gts`` boxes each, seeded."""
    rng = np.random.RandomState(seed)
    imgs = rng.uniform(0, 255, (batch, size, size, 3)).astype(np.float32)
    labels = np.zeros((batch, 120, 5), np.float32)
    for b in range(batch):
        for g in range(gts):
            w, h = rng.uniform(0.05 * size, 0.4 * size, 2)
            labels[b, g] = (rng.randint(BBOX_CLASSES),
                            rng.uniform(w / 2, size - w / 2),
                            rng.uniform(h / 2, size - h / 2), w, h)
    return (torch.from_numpy(imgs).to(device),
            torch.from_numpy(labels).to(device))


# the kernels of the port's backward and forward as the profiler names them,
# and the launch counters that count each: a kernel's launches in a step are
# the sum of those counters (the CUDA-core ones last: conv1x1_small_kernel
# is small_1x1's, both ways; conv_nhwc_kernel is direct's,
# wgrad_partial_kernel and dgrad_kernel the cuda_cores backward's)
PROFILED_KERNELS = {
    "conv_taps_kernel": ("forward:wgmma_taps", "dgrad:flipped:wgmma_taps"),
    "conv_rows_kernel": ("forward:wgmma_rows",),
    "conv1x1_small_kernel": ("forward:small_1x1", "dgrad:small_1x1"),
    "wgrad_tc_kernel": ("wgrad:wgmma",),
    "dgrad_tc_kernel": ("dgrad:wgmma_classes",),
    "pack_taps_kernel": ("pack",),
    "conv_nhwc_kernel": ("forward:direct",),
    "wgrad_partial_kernel": ("wgrad:cuda_cores",),
    "dgrad_kernel": ("dgrad:cuda_cores",),
}


def train_bbox_steps(smi: str, name: str = "yolox-l",
                     compute_dtype: str = "bfloat16"):
    """Training steps of the bbox exp ``name`` in this process at batch 8,
    640 px, on one seeded batch on the card, in ``compute_dtype``: step ms
    (CUDA events, median of the timed steps), images/s, peak memory, the
    launches of every step by variant (YOLOX-L: ``BBOX_STEP_LAUNCHES``,
    the zoo: :func:`step_launches`).  Then three more steps under the
    profiler, scheduled as one warm-up step and two active ones: the
    kernels of the active steps by name must be exactly what the launch
    counters give (:data:`PROFILED_KERNELS`), none of them a CUDA-core
    kernel.  (``--compare-steps`` times such steps against another
    checkout's.)"""
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.losses import YoloxLossConfig
    from eop_tpu_torch.train.steps import create_train_state, \
        make_train_step_bbox

    want = BBOX_STEP_LAUNCHES if name == "yolox-l" else step_launches(name)
    exp = get_exp(exp_name=name)
    exp.compute_dtype = compute_dtype
    imgs, labels = bbox_synthetic_batch(BBOX_BATCH, 640)
    torch.cuda.empty_cache()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    model = exp.get_model("cuda", seed=0).train()
    state = create_train_state(model, exp.get_optimizer(model, BBOX_BATCH,
                                                        8))
    events, per_step, marks = [], [], {}

    def hook(name_, metrics=None):
        if name_ == "start":
            marks["counts"] = _launch_counts()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        elif name_ == "step":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            c = _launch_counts()
            per_step.append({k: c[k] - marks["counts"][k] for k in want})
            marks["metrics"] = marks.get("metrics", []) + [metrics]

    step = make_train_step_bbox(YoloxLossConfig(num_classes=BBOX_CLASSES),
                                ema_decay=exp.ema_decay, hook=hook)
    for _ in range(BBOX_WARMUP + BBOX_TIMED):
        state, _ = step(state, imgs, labels)
    torch.cuda.synchronize()
    launches = _launch_counts()
    ms = [events[2 * i].elapsed_time(events[2 * i + 1])
          for i in range(BBOX_WARMUP, BBOX_WARMUP + BBOX_TIMED)]
    # the profiler misses kernels of its first moments (the stem's rows
    # launch opens a step: 0 of 1 and 1 of 2 seen without a warm-up step,
    # PERF.md section 7), so a warm-up step runs under it before the two
    # it records
    counted, traced, busy = {}, [], []

    def ready(prof):
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        traced.append({f: sum(e.count for e in kernels if f"::{f}<" in e.key)
                       for f in PROFILED_KERNELS})
        busy.append({f: sum(e.self_device_time_total for e in kernels
                            if f"::{f}<" in e.key) / 2e3
                     for f in PROFILED_KERNELS})

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(
            activities=acts, on_trace_ready=ready,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=2,
                                             repeat=1)) as prof:
        for i in range(3):
            if i == 1:
                counted["before"] = _launch_counts()
            state, _ = step(state, imgs, labels)
            torch.cuda.synchronize()
            prof.step()
    after = _launch_counts()
    expected = {f: sum(after[k] - counted["before"][k] for k in keys)
                for f, keys in PROFILED_KERNELS.items()}
    losses = [float(m["total_loss"]) for m in marks["metrics"]]
    tag = name.replace("-", "_")
    report = {"phase": f"train_{tag}_steps", "card": smi, "model": tag,
              "compute_dtype": compute_dtype, "batch": BBOX_BATCH,
              "input_size": [640, 640], "losses": losses,
              "step_ms": float(np.median(ms)), "step_ms_all": ms,
              "images_per_s": 1e3 * BBOX_BATCH / float(np.median(ms)),
              "launches_per_step": per_step[-1],
              "profiled_step_kernels": traced[0] if traced else None,
              "counted_step_kernels": expected,
              "profiled_steps": 2,
              # device ms of each of the port's kernels a recorded step
              "profiled_kernel_ms": busy[0] if busy else None,
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    cuda_cores = ("conv_nhwc_kernel", "wgrad_partial_kernel", "dgrad_kernel")
    if (any(p != want for p in per_step) or traced != [expected]
            or any(expected[f] for f in cuda_cores)
            or not all(np.isfinite(losses))):
        raise AssertionError(f"train_bbox_steps {name} {compute_dtype}: "
                             f"{report} {per_step}")
    del state, model
    return report, launches


def to_float64(model):
    """The port's module in float64: parameters, buffers and every module's
    compute ``dtype`` (the bbox loss keeps float64 inputs in float64)."""
    model = model.double()
    for m in model.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return model


def grad_distance(grads, ref) -> dict:
    """``grads`` against ``ref`` (name -> tensor): each tensor's largest
    difference relative to its largest value in ``ref``; the worst of them
    and its name, their median, the tensors over 1e-3, the median and least
    cosine, and the whole tree's relative L2 distance."""
    errs, cosines, diff2, norm2 = {}, [], 0.0, 0.0
    for name, g in ref.items():
        got = grads[name].double()
        g = g.double()
        errs[name] = ((got - g).abs().max()
                      / g.abs().max().clamp(min=1e-30)).item()
        diff2 += (got - g).square().sum().item()
        norm2 += g.square().sum().item()
        a, b = got.flatten(), g.flatten()
        if b.norm() > 0:
            cosines.append((a @ b / (a.norm() * b.norm())).item())
    worst = max(errs, key=errs.get)
    return {"worst_rel_to_max": errs[worst], "worst_tensor": worst,
            "median_rel_to_max": float(np.median(list(errs.values()))),
            "tensors_over_1e-3": sorted((n for n in errs if errs[n] > 1e-3),
                                        key=errs.get, reverse=True),
            "rel_l2": (diff2 / max(norm2, 1e-300)) ** 0.5,
            "cosine_median": float(np.median(cosines)),
            "cosine_min": min(cosines)}


# the models whose card step is also held against a float64 CPU step
BBOX_FLOAT64_REFEREE = ("yolox-l", "yolov3", "yolox-x")
# The card's distance from float64 over the fp32 CPU's (each tensor's
# largest difference over its largest value; the median tensor's and the
# worst tensor's), L / YOLOv3 / X, B=2 at 320 px on an H100, the loss in
# float64 too (`chip_smoke.py --kernel-accuracy`, one call):
#   sound kernels (each short run of K summed apart): median 0.65 / 0.72 /
#     0.61, worst 0.63 / 1.03 / 0.76;
#   cuDNN in place of every hand kernel: median 0.86 / 1.16, worst 0.80 /
#     1.36 (X's reading there is no reference: 31 / 115);
#   the faulty kernels (whole K chains in one tensor-core accumulator,
#     which rounds toward zero): median 3.77 / 1.87 / 4.02, worst 2.88 /
#     1.34 / 4.02.
# So the median at most 1.5x the CPU's on all three (sound at most 1.16,
# faulty at least 1.87), and the worst at most 2x on L and X (sound at most
# 0.80, faulty at least 2.88).  YOLOv3's worst is not gated: its worst
# tensors are ill-conditioned (the CPU's own is 0.16 from float64), and
# sound and faulty kernels read alike there (1.03-1.36 against 1.34).
GRAD64_MEDIAN_RATIO = 1.5
GRAD64_WORST_RATIO = 2.0
GRAD64_WORST_GATED = ("yolox-l", "yolox-x")
# card-against-CPU gradient bound for the models held without the referee
# (Nano, Tiny: 8.6e-4 at most in two runs on an H100)
BBOX_GRAD_TOL = 2e-3


def bbox_card_vs_cpu(name: str = "yolox-l", gate: bool = True,
                     kernels: bool = True):
    """One training step's forward, assignment, loss and backward of the
    exp ``name`` (B=2, 320 px) from one seeded state on the card and on the
    CPU: the loss within 1e-3 relative, the same assignment.  For the
    models of :data:`BBOX_FLOAT64_REFEREE` the same step also runs in
    float64 on the CPU, and each fp32 side's gradients are measured
    against it (each tensor's worst difference relative to its largest
    value): the card's median tensor no farther from float64 than
    :data:`GRAD64_MEDIAN_RATIO` times the fp32 CPU's, and for
    :data:`GRAD64_WORST_GATED` its worst tensor no farther than
    :data:`GRAD64_WORST_RATIO` times, i.e. the card-against-CPU difference
    is two fp32 roundings of ill-conditioned tensors, not a fault of the
    card's kernels.  The other models' card gradients are held against the
    CPU's at :data:`BBOX_GRAD_TOL`.  ``gate=False`` reports without
    holding; ``kernels=False`` takes the card's convs off ``phase_conv``
    (cuDNN throughout)."""
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.losses import (
        SimOTAConfig,
        YoloxLossConfig,
        simota_assign,
        yolox_losses,
    )
    from eop_tpu_torch.models.yolox import training_outputs

    exp = get_exp(exp_name=name)
    imgs, labels = bbox_synthetic_batch(2, 320, seed=1, device="cpu")
    cfg = YoloxLossConfig(num_classes=BBOX_CLASSES)
    referee = name in BBOX_FLOAT64_REFEREE
    t0 = time.perf_counter()
    out = {}
    for key, dev, dtype in (("cuda", "cuda", torch.float32),
                            ("cpu", "cpu", torch.float32),
                            ("cpu64", "cpu", torch.float64))[:3 if referee
                                                               else 2]:
        model = exp.get_model(dev, seed=0).train()
        if dtype == torch.float64:
            model = to_float64(model)
        if dev == "cuda" and not kernels:
            for m in model.modules():
                if getattr(m, "phase_conv", False):
                    m.phase_conv = False
        heads, _ = model(imgs.to(dev, dtype).permute(0, 3, 1, 2))
        decoded, origin, grids, strides = training_outputs(heads, reg_dim=4)
        lab = labels.to(dev, dtype)
        with torch.no_grad():
            d = decoded.float()
            assign = simota_assign(lab.float(), d[..., :4], d[..., 4],
                                   d[..., 5:], grids, strides, BBOX_CLASSES,
                                   SimOTAConfig())
        total, _ = yolox_losses(decoded, origin, lab, grids, strides, cfg)
        total.backward()
        out[key] = (total.item(), assign.fg_mask.cpu(),
                    assign.matched_gt.cpu(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
        del model, heads, decoded
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    same = (torch.equal(out["cuda"][1], out["cpu"][1])
            and torch.equal(out["cuda"][2], out["cpu"][2]))
    vs_cpu = grad_distance(out["cuda"][3], out["cpu"][3])
    report = {"phase": "bbox_card_vs_cpu", "model": name, "batch": 2,
              "kernels": kernels,
              "input_size": [320, 320], "loss_cuda": out["cuda"][0],
              "loss_cpu": out["cpu"][0], "loss_rel_err": rel,
              "loss_tol": 1e-3, "assignment_equal": same,
              "num_fg": int(out["cpu"][1].sum()),
              "grad_tensors": len(out["cpu"][3]),
              "grad_worst_rel_to_max": vs_cpu["worst_rel_to_max"],
              "grad_worst_tensor": vs_cpu["worst_tensor"],
              "grad_cosine_median": vs_cpu["cosine_median"],
              "grad_cosine_min": vs_cpu["cosine_min"]}
    if referee:
        ref = out["cpu64"][3]
        card, cpu = (grad_distance(out[k][3], ref) for k in ("cuda", "cpu"))
        # the worst tensor against the card's: the CPU's distance there too
        at = card["worst_tensor"]
        cpu_at = ((out["cpu"][3][at].double() - ref[at]).abs().max()
                  / ref[at].abs().max().clamp(min=1e-30)).item()
        ratios = {k: card[f"{k}_rel_to_max"] / cpu[f"{k}_rel_to_max"]
                  for k in ("worst", "median")}
        report["float64"] = {
            "loss": out["cpu64"][0],
            "assignment_equal": bool(
                torch.equal(out["cpu64"][1], out["cpu"][1])
                and torch.equal(out["cpu64"][2], out["cpu"][2])),
            "cuda": card, "cpu": cpu, "cpu_at_cuda_worst": cpu_at,
            "ratio_worst": ratios["worst"], "ratio_median": ratios["median"],
            "bound_median": GRAD64_MEDIAN_RATIO,
            "bound_worst": (GRAD64_WORST_RATIO if name in GRAD64_WORST_GATED
                            else None)}
        grads_ok = (ratios["median"] <= GRAD64_MEDIAN_RATIO
                    and (name not in GRAD64_WORST_GATED
                         or ratios["worst"] <= GRAD64_WORST_RATIO))
    else:
        grads_ok = vs_cpu["worst_rel_to_max"] <= BBOX_GRAD_TOL
        report["grad_tol"] = BBOX_GRAD_TOL
    report["wall_s"] = time.perf_counter() - t0
    if gate and not (rel <= 1e-3 and same and report["num_fg"] > 0
                     and grads_ok):
        raise AssertionError(f"bbox card and CPU disagree: {report}")
    return report


def eval_bbox(smi: str, data_dir: str, ckpt: str):
    """``python -m eop_tpu_torch.tools.eval -n yolox-l -c CKPT -b 8`` over the
    val images as a subprocess (exit 0, an AP line), then the label oracle
    through ``COCOEvaluator`` on the card (AP 1)."""
    import re

    from eop_tpu_torch.eval import fast_cocoeval
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.utils.synth import LabelOracle

    cmd = [sys.executable, "-m", "eop_tpu_torch.tools.eval", "-n", "yolox-l",
           "-c", ckpt, "-b", str(EVAL_BATCH), "--data-dir", data_dir,
           "--per-class-ap", "test_conf", "1e-5", "data_num_workers", "4"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the command line runs while this process scores the oracle
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        exp = get_exp(exp_name="yolox-l")
        exp.data_dir, exp.num_classes, exp.data_num_workers = (
            data_dir, BBOX_CLASSES, 0)
        evaluator = exp.get_evaluator(EVAL_BATCH)
        fast_cocoeval.match_image.native_calls = 0
        o5095, o50, _ = evaluator.evaluate(
            LabelOracle(evaluator.dataloader.dataset, "cuda"))
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    wall = time.perf_counter() - t0
    aps = re.findall(AP_LINE, stdout)
    if proc.returncode != 0 or not aps:
        raise AssertionError(f"eval_bbox: rc {proc.returncode}\n"
                             f"{stdout[-3000:]}\n{stderr[-3000:]}")
    report = {"phase": "eval_bbox", "card": smi, "command": " ".join(cmd[2:]),
              "rc": proc.returncode, "wall_s": wall,
              "ap50_95": float(aps[-1][0]), "ap50": float(aps[-1][1]),
              "per_class_table": "| class" in stdout,
              "worker_aborts": stderr.count("killed by signal"),
              "oracle_ap50_95": float(o5095), "oracle_ap50": float(o50),
              "oracle_native_matcher_calls":
                  fast_cocoeval.match_image.native_calls,
              "oracle_images": evaluator.timings["images"]}
    if not (abs(o5095 - 1.0) <= 1e-6 and abs(o50 - 1.0) <= 1e-6
            and report["per_class_table"]
            and report["oracle_images"] == BBOX_VAL_IMAGES):
        raise AssertionError(f"eval_bbox: {report}")
    return report


def drop_bbox_loaders(data_dir: str, drops: int = 2) -> dict:
    """YOLOX-L's mosaic train loader started and dropped with batches in
    flight, ``drops`` times, as the trainer drops it."""
    from eop_tpu_torch.exp import get_exp

    exp = get_exp(exp_name="yolox-l")
    exp.data_dir, exp.num_classes = data_dir, BBOX_CLASSES
    t0 = time.perf_counter()
    for _ in range(drops):
        it = iter(exp.get_data_loader(BBOX_BATCH))
        next(it)
        del it
    return {"bbox_drops": drops, "bbox_drop_seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# YOLOX-Nano, YOLOX-Tiny and YOLOv3 (Darknet-53 + YOLOFPN); bbox serving

# the variants that each zoo model's phase_conv convs must take, by conv
# (its path under the backbone): forward, weight gradient and data gradient
# (None: no data gradient, the input is the image).  Every forward and weight
# gradient runs on the tensor cores but Nano's 16- and 32-channel 1x1 convs,
# whose forward and data gradient take the CUDA-core small_1x1
# (ops/phase_conv.py::SMALL_1X1); every other data gradient runs on the
# tensor cores, at stride 1 the forward kernel on the flipped weights, at
# stride 2 the parity classes.  The shapes come from the models themselves
# (:func:`zoo_path`).
_STEM = ("wgmma_rows", "wgmma", None)
_SMALL = ("small_1x1", "wgmma", "small_1x1")
_TAPS = ("wgmma_taps", "wgmma", "flipped:wgmma_taps")
_CLASSES = ("wgmma_taps", "wgmma", "wgmma_classes")


def _csp_darknet(n: int) -> dict:
    """Every early conv of a CSPDarknet whose dark2 CSP layer has ``n``
    bottlenecks (YOLOX-Tiny, -M, -X): the two 3x3/s2 down convs' data
    gradients by parity class, the stride-1 convs' on the flipped
    weights."""
    convs = ["dark2.1.conv1", "dark2.1.conv2", "dark2.1.conv3"] + [
        f"dark2.1.m.{i}.conv{j}" for i in range(n) for j in (1, 2)]
    return {"stem.conv": _STEM, "dark2.0": _CLASSES, "dark3.0": _CLASSES,
            **{c: _TAPS for c in convs}}


ZOO_VARIANTS = {
    "yolox-nano": {
        "stem.conv": _STEM,
        "dark2.0.pconv": _SMALL,
        "dark2.1.conv1": _SMALL,
        "dark2.1.conv2": _SMALL,
        "dark2.1.m.0.conv1": _SMALL,
        "dark2.1.m.0.conv2.pconv": _SMALL,
        "dark2.1.conv3": _TAPS,
        "dark3.0.pconv": _TAPS},
    "yolox-tiny": _csp_darknet(1),
    "yolov3": {
        "stem.0": _STEM,
        "stem.1": _CLASSES,
        "stem.2.layer1": _TAPS,
        "stem.2.layer2": _TAPS,
        "dark2.0": _CLASSES,
        **{f"dark2.{i}.layer{j}": _TAPS for i in (1, 2) for j in (1, 2)},
        "dark3.0": _CLASSES},
    # held at their kernel shapes (zoo_cases); X also takes training steps
    # in this process (train_bbox_steps)
    "yolox-m": _csp_darknet(2),
    "yolox-x": _csp_darknet(4),
}
# the models the smoke trains, evaluates and steps card against CPU
ZOO_NAMES = ("yolox-nano", "yolox-tiny", "yolov3")
# the reference's per-card batch (-b 64 over 8 cards): the zoo trains, and
# serves, at batch 8
ZOO_BATCH = 8
# forward launches of one serving call: YOLOX-L's 12 early convs fused with
# their BN + SiLU; YOLOv3's 10 lrelu convs unfused
YOLOX_L_FORWARD, YOLOV3_FORWARD = 12, len(ZOO_VARIANTS["yolov3"])
# serve_bbox: frames posted one at a time, each answered as a direct call
N_ALONE = 4


def zoo_path() -> list:
    """Every phase_conv conv of the zoo at each size its model runs it, one
    row a conv (so sums are per forward): (tag, conv, (k, stride, padding,
    H, W, C, Co), forward, weight-gradient and data-gradient variant,
    trained).  The shapes are read by hooks from one CPU forward of each
    model at its input size (tag ``nano``, ``tiny``, ``yolov3``; trained)
    and at its test size where that differs (Tiny's 416: ``tiny416``,
    served only; the reference's input_scale typo trains Tiny at 640); the
    variants are :data:`ZOO_VARIANTS`', which must name exactly the convs
    that ran."""
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.ops.blocks import BaseConv

    def record(seen, name):
        def hook(module, args):
            w, s, p = module.conv_args()
            co, c, k, _ = w.shape
            seen.append((name, (k, s, p, *args[0].shape[2:], c, co)))
        return hook

    rows = []
    for name, want in ZOO_VARIANTS.items():
        exp = get_exp(exp_name=name)
        model = exp.get_model("cpu").eval()
        tag = name.removeprefix("yolox-")
        for size in dict.fromkeys((tuple(exp.input_size),
                                   tuple(exp.test_size))):
            seen = []
            hooks = [m.register_forward_pre_hook(record(
                seen, n.removeprefix("backbone.backbone.")))
                for n, m in model.named_modules()
                if isinstance(m, BaseConv) and m.phase_conv]
            with torch.no_grad():
                model(torch.zeros(1, 3, *size))
            for h in hooks:
                h.remove()
            if sorted(n for n, _ in seen) != sorted(want):
                raise AssertionError(f"zoo_path {name}: phase_conv convs "
                                     f"{[n for n, _ in seen]}, variants "
                                     f"for {list(want)}")
            trained = size == tuple(exp.input_size)
            t = tag if trained else f"{tag}{size[0]}"
            rows += [(t, n, shape, *want[n], trained) for n, shape in seen]
    return rows


# YOLOX-X's stem at the top of its multiscale range (15..25 x 32 px): fp32
# takes wgmma_rows in two N tiles of 64 there (ops/phase_conv.py::rows_tile)
X800_STEM = ("x800.stem.conv", (6, 2, 2, 800, 800, 3, 80), "wgmma_rows")


def zoo_cases():
    """check_phase_conv's and check_phase_conv_backward's cases of the
    zoo: every shape forward (served and trained) and X's stem at 800 px,
    those at each model's input size backward (Tiny's 416-px shapes are
    served only)."""
    path = zoo_path()
    fwd = [(f"{m}.{n}", c, ZOO_BATCH, v) for m, n, c, v, _, _, _ in path]
    fwd.append((X800_STEM[0], X800_STEM[1], ZOO_BATCH, X800_STEM[2]))
    back = [(f"{m}.{n}", c, ZOO_BATCH, w, d)
            for m, n, c, _, w, d, trained in path if trained]
    return fwd, back


def step_launches(name: str) -> dict:
    """The kernel launches one training step of zoo model ``name`` makes,
    from :data:`ZOO_VARIANTS`: every phase_conv conv launches its forward
    and weight gradient; every one with a data gradient launches it, and
    packs its weights first on a tensor-core variant (``small_1x1`` and
    ``cuda_cores`` read HWIO weights); and each kind's launches by variant
    ("kind:variant")."""
    rows = list(ZOO_VARIANTS[name].values())
    dgrads = [d for _, _, d in rows if d is not None]
    return {"forward": len(rows), "wgrad": len(rows), "dgrad": len(dgrads),
            "pack": sum(d not in ("cuda_cores", "small_1x1")
                        for d in dgrads),
            **variant_counts(rows)}


def forward_variants(rows, times: int = 1) -> dict:
    """The by-variant launches of ``times`` forwards of the convs ``rows``
    (tuples ending in forward, weight-gradient, data-gradient variant), in
    the "kind:variant" keys of :func:`_launch_counts`: no backward."""
    return {k: times * v if k.startswith("forward:") else 0
            for k, v in variant_counts([r[-3:] for r in rows]).items()}


def match_bboxes(got: list, want: np.ndarray, tol: float = 0.05) -> bool:
    """HTTP ``bbox`` dicts against rows ``[n, 7]`` of a direct call: the
    same count, each row with an unused answer of its class within ``tol``
    px on every side and its score within 1e-4."""
    if len(got) != len(want):
        return False
    free = list(range(len(got)))
    for row in want:
        score = float(row[4] * row[5])
        hit = next((i for i in free if got[i]["class_id"] == int(row[6])
                    and max(abs(a - b) for a, b in zip(got[i]["bbox"],
                                                       row[:4])) <= tol
                    and abs(got[i]["score"] - score) <= 1e-4), None)
        if hit is None:
            return False
        free.remove(hit)
    return True


def box_iou_median(got: list, want: np.ndarray) -> float:
    """The median over HTTP ``bbox`` dicts of each one's best IoU with a
    row of a direct call's ``[n, 7]`` of the same class; 0 where either is
    empty."""
    from eop_tpu_torch.ops.boxes import bboxes_iou

    if not len(got) or not len(want):
        return float(len(got) == len(want))
    a = torch.tensor([d["bbox"] for d in got], dtype=torch.float64)
    b = torch.from_numpy(want[:, :4]).double()
    same = (torch.tensor([d["class_id"] for d in got])[:, None]
            == torch.from_numpy(want[:, 6]).long()[None])
    return float((bboxes_iou(a, b) * same).amax(dim=1).median())


def heads_vs(model, ref_model, raw: np.ndarray, test_size) -> dict:
    """The raw head maps of ``model`` against ``ref_model``'s (another
    device or dtype) on the same uint8 frames, letterboxed to
    ``test_size``: the largest difference and the reference's scale."""
    from eop_tpu_torch.data.transforms import letterbox_batch_device

    maps = []
    for m in (model, ref_model):
        dev = next(m.parameters()).device
        with torch.inference_mode():
            x = torch.from_numpy(raw).to(dev).float()
            imgs, _ = letterbox_batch_device(x, raw.shape[1:3], test_size)
            maps.append([h.float().cpu() for h in m(imgs.permute(0, 3, 1,
                                                                 2))[0]])
    return {"head_max_abs_err": max((a - b).abs().max().item()
                                    for a, b in zip(*maps)),
            "head_scale": max(b.abs().max().item() for b in maps[1])}


def bbox_rows(rows: torch.Tensor) -> torch.Tensor:
    """Detection rows ``[..., 7]`` -> their boxes ``[..., 4]`` (x1 y1 x2
    y2)."""
    return rows[..., :4].float()


def serve_bbox(smi: str):
    """``tools.serve -n yolox-l --batch 8`` as its parser reads it, in this
    process, behind the threaded HTTP front end: 16 clients post 32 raw
    640x640 frames (each answer's ``bbox`` dicts against a direct
    ``get_serving_fn`` call on its frame by IoU: the batcher forms other
    batches), then four frames one at a time (answers equal to a direct
    call on the frame alone) and one JPEG body (equal to its raw twin's);
    12 fused launches a forward (counts set to 0 just before the server
    starts); the stages in
    fp32 and bf16 (the bf16 model's launches, its head maps against fp32's
    within 5e-2 of their scale); the card against the CPU on one frame
    (head maps within 1e-3; detections by IoU, reported); then ``serve -n
    yolov3``: one request, 10 unfused launches.  Returns the report and the
    launches by path."""
    from eop_tpu_torch.data.image_io import imdecode
    from eop_tpu_torch.ops.phase_conv import phase_conv
    from eop_tpu_torch.serving.http import make_http_server
    from eop_tpu_torch.tools import serve as serve_cli
    from eop_tpu_torch.utils.synth import encode_jpeg

    opts = ["--batch", str(SERVE_BATCH), "--max-wait-ms", "20", "test_conf",
            "1e-5"]
    _reset_counts()
    t0 = time.perf_counter()
    svc = serve_cli.build_service(serve_cli.make_parser().parse_args(
        ["-n", "yolox-l"] + opts))
    warmup_s = time.perf_counter() - t0
    server = make_http_server(svc, host="127.0.0.1", port=0)
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/detect"
    rng = np.random.RandomState(7)
    frames = [rng.randint(0, 256, (640, 640, 3), np.uint8)
              for _ in range(N_REQUESTS)]
    answers, lat_ms = [None] * N_REQUESTS, [0.0] * N_REQUESTS

    def post(body, headers):
        req = urllib.request.Request(url, data=body, method="POST",
                                     headers=headers)
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())

    def client(j):
        for i in range(j, N_REQUESTS, N_CLIENTS):
            t = time.perf_counter()
            answers[i] = post(frames[i].tobytes(),
                              {"X-Raw-Shape": "640,640,3"})
            lat_ms[i] = (time.perf_counter() - t) * 1e3

    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(j,))
                   for j in range(N_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        wall_s = time.perf_counter() - t0
        # four frames posted one at a time: each is a batch of its own
        alone = [post(frames[i].tobytes(), {"X-Raw-Shape": "640,640,3"})[1]
                 for i in range(N_ALONE)]
        jpeg = encode_jpeg(frames[0])
        jpeg_code, jpeg_answer = post(jpeg, {})
        _, twin_answer = post(imdecode(jpeg).tobytes(),
                              {"X-Raw-Shape": "640,640,3"})
        torch.cuda.synchronize()
        launches = phase_conv.launches
        fused = phase_conv.fused_launches
        variants = _variants()
        stats = svc.stats()
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        srv.join(timeout=30)
    codes = [a[0] if a else None for a in answers]
    if any(t.is_alive() for t in clients) or codes != [200] * N_REQUESTS:
        raise AssertionError(f"serve_bbox HTTP codes {codes}")
    # the direct call on each frame: alone, as the frames posted alone were
    # served, and in batches of 8 for the concurrent answers, whose batches
    # the batcher formed (another batch size may round otherwise in the
    # last bits, which moves near-equal scores across the 300-row cap)
    exp = serve_cli.load_exp(serve_cli.make_parser().parse_args(
        ["-n", "yolox-l"] + opts))
    model = exp.get_model("cuda")
    serve = exp.get_serving_fn(model, (640, 640), "cuda")

    def rows(out, b):
        return out.rows[b][out.valid[b]].cpu().numpy()

    alone_equal = sum(match_bboxes(a["detections"], rows(serve(f[None]), 0))
                      for a, f in zip(alone, frames))
    direct = []
    for i in range(0, N_REQUESTS, SERVE_BATCH):
        out = serve(np.stack(frames[i:i + SERVE_BATCH]))
        direct += [rows(out, b) for b in range(out.rows.shape[0])]
    iou = [box_iou_median(a[1]["detections"], d)
           for a, d in zip(answers, direct)]
    n_dets = [len(a[1]["detections"]) for a in answers]
    forwards = stats["device_calls"]
    report = {
        "phase": "serve_bbox", "card": smi, "model": "yolox_l",
        "command": "tools.serve -n yolox-l " + " ".join(opts),
        "depth": exp.depth, "width": exp.width,
        "num_classes": exp.num_classes, "test_size": list(exp.test_size),
        "batch": SERVE_BATCH, "requests": N_REQUESTS, "clients": N_CLIENTS,
        "http_200": codes.count(200), "batches": stats["batches"],
        "mean_batch_occupancy": stats["mean_batch_occupancy"],
        "forward_calls": forwards, "valid_detections": sum(n_dets),
        "alone_answers_equal_direct_call": alone_equal,
        "answers_iou_median_vs_direct_min": min(iou),
        "has_bbox_dicts": all("bbox" in d for a in answers
                              for d in a[1]["detections"]),
        "jpeg_code": jpeg_code,
        "jpeg_equals_raw_twin": (jpeg_answer["detections"]
                                 == twin_answer["detections"]),
        "phase_conv_launches": launches, "phase_conv_fused_launches": fused,
        "launches_by_variant": variants,
        "request_ms_p50": float(np.percentile(lat_ms, 50)),
        "request_ms_max": float(max(lat_ms)),
        "wall_s": wall_s, "warmup_s": warmup_s,
    }
    if (sum(n_dets) <= 0 or alone_equal != N_ALONE or min(iou) < 0.99
            or not report["has_bbox_dicts"]
            or jpeg_code != 200 or not report["jpeg_equals_raw_twin"]
            or launches != YOLOX_L_FORWARD * forwards or fused != launches
            or variants != forward_variants(YOLOX_L_PATH, forwards)):
        raise AssertionError(f"serve_bbox: {report}")
    by_path = {"serve_bbox": launches}
    PATH_VARIANTS["serve_bbox"] = variants

    report["stages_fp32"] = serving_stages(smi, exp, model)
    # the card against the CPU on one frame, the same seeded weights: the
    # head maps (1e-3 of their scale); the detections by IoU, reported (at
    # seeded weights every image fills the 300-row cap with near-equal
    # scores, so the last bits reorder its tail)
    raw1 = frames[1][None]
    cpu_model = exp.get_model("cpu")
    report["card_vs_cpu"] = {
        **heads_vs(model, cpu_model, raw1, exp.test_size),
        **detections_vs(serve(raw1), exp.get_serving_fn(
            cpu_model, (640, 640), "cpu")(raw1), bbox_rows)}
    del cpu_model
    # bf16: one call at batch 8 (its launches), its head maps against
    # fp32's (5e-2 of their scale), then its stages
    exp16 = serve_cli.load_exp(serve_cli.make_parser().parse_args(
        ["-n", "yolox-l"] + opts + ["compute_dtype", "bfloat16"]))
    model16 = exp16.get_model("cuda")
    serve16 = exp16.get_serving_fn(model16, (640, 640), "cuda")
    batch8 = np.stack(frames[:SERVE_BATCH])
    serve16(batch8)  # warm
    _reset_counts()
    dets16 = serve16(batch8)
    torch.cuda.synchronize()
    by_path["serve_bbox_bf16"] = phase_conv.launches
    PATH_VARIANTS["serve_bbox_bf16"] = _variants()
    report["bf16"] = {
        "phase_conv_launches": phase_conv.launches,
        "phase_conv_fused_launches": phase_conv.fused_launches,
        "launches_by_variant": PATH_VARIANTS["serve_bbox_bf16"],
        "vs_fp32": {**heads_vs(model16, model, batch8, exp.test_size),
                    **detections_vs(dets16, serve(batch8), bbox_rows)},
        "stages": serving_stages(smi, exp16, model16)}
    del model, model16
    # YOLOv3 served: one request, its lrelu convs unfused
    svc3 = serve_cli.build_service(serve_cli.make_parser().parse_args(
        ["-n", "yolov3", "--batch", "1", "test_conf", "1e-5"]))
    try:
        _reset_counts()
        dets3 = svc3.detect(frames[2])
        torch.cuda.synchronize()
        by_path["serve_yolov3"] = phase_conv.launches
        PATH_VARIANTS["serve_yolov3"] = _variants()
        report["yolov3"] = {"phase_conv_launches": phase_conv.launches,
                            "launches_by_variant":
                                PATH_VARIANTS["serve_yolov3"],
                            "phase_conv_fused_launches":
                                phase_conv.fused_launches,
                            "detections": len(dets3),
                            "has_bbox": all("bbox" in d for d in dets3)}
    finally:
        svc3.close()
    vs_cpu, vs32 = report["card_vs_cpu"], report["bf16"]["vs_fp32"]
    checks = (vs_cpu["head_max_abs_err"] <= 1e-3 * max(1.0, vs_cpu[
        "head_scale"]) and vs_cpu["count"] == vs_cpu["count_ref"] > 0
        and vs32["head_max_abs_err"] <= 5e-2 * max(1.0, vs32["head_scale"])
        and report["bf16"]["phase_conv_launches"] == YOLOX_L_FORWARD
        == report["bf16"]["phase_conv_fused_launches"]
        and PATH_VARIANTS["serve_bbox_bf16"] == forward_variants(YOLOX_L_PATH)
        and PATH_VARIANTS["serve_yolov3"] == forward_variants(
            list(ZOO_VARIANTS["yolov3"].values()))
        and report["stages_fp32"]["own_kernels"]["conv_nhwc_kernel"] == 0
        and report["bf16"]["stages"]["own_kernels"]["conv_nhwc_kernel"] == 0
        and report["yolov3"]["phase_conv_launches"] == YOLOV3_FORWARD
        and report["yolov3"]["phase_conv_fused_launches"] == 0
        and report["yolov3"]["detections"] > 0
        and report["yolov3"]["has_bbox"])
    if not checks:
        raise AssertionError(f"serve_bbox: {report}")
    return report, by_path


def train_zoo(smi: str, data_dir: str, out_dir: str):
    """``python -m eop_tpu_torch.tools.train -n NAME -b 8`` for YOLOX-Nano,
    YOLOX-Tiny and YOLOv3 over the bbox dataset, each as a subprocess
    through :func:`train_bbox_child`: one epoch of 4 steps after the no-aug
    switch (``max_epoch 1 no_aug_epochs 0``: L1 on; the mosaic path is
    train_bbox's), multiscale from each exp's own ``random_size``.  Every
    step's launches must be what :func:`step_launches` computes from the
    model; step ms by CUDA events, peak memory.  Returns the report, the
    launches by path and each run's checkpoint."""
    report, by_path, ckpts = {"phase": "train_zoo", "card": smi}, {}, {}
    runs = {}
    os.makedirs(out_dir, exist_ok=True)
    try:
        for name in ZOO_NAMES:
            # the three run at once: each one's step times and loader waits
            # are measured beside the others' (the checks are per process)
            record = os.path.join(out_dir, f"{name}.json")
            cmd = [sys.executable, os.path.abspath(__file__),
                   "--train-bbox-child", record, "--", "-n", name, "-b",
                   str(ZOO_BATCH), "--data-dir", data_dir, "max_epoch", "1",
                   "no_aug_epochs", "0", "eval_interval", "10",
                   "data_num_workers", "2", "seed", "0", "print_interval",
                   "4", "output_dir", os.path.join(out_dir, name)]
            log = os.path.join(out_dir, f"{name}.log")
            with open(log, "w") as f:
                proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f,
                                        stderr=subprocess.STDOUT)
            runs[name] = (proc, cmd, record, log, time.time())
        for proc, *_ in runs.values():
            proc.wait(timeout=600)
    finally:
        for proc, *_ in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    for name, (proc, cmd, record, log, t0) in runs.items():
        out = os.path.join(out_dir, name)
        with open(log) as f:
            text = f.read()
        if proc.returncode != 0:
            raise AssertionError(f"train_zoo {name}: rc {proc.returncode}\n"
                                 f"{text[-6000:]}")
        wall = os.path.getmtime(record) - t0  # start to the record written
        with open(record) as f:
            rec = json.load(f)
        want = step_launches(name)
        bad = [i for i, c in enumerate(rec["launches"])
               if {k: c[k] for k in want} != want]
        losses = [m["total_loss"] for m in rec["metrics"]]
        ms = rec["step_ms"][2:]
        row = {"command": " ".join(cmd[4:]), "wall_s": wall,
               "steps": len(rec["step_ms"]), "losses": losses,
               "l1_losses": [m["l1_loss"] for m in rec["metrics"]],
               "num_fg": [m["num_fg"] for m in rec["metrics"]],
               "expected_launches": want,
               "launches_per_step": rec["launches"][-1],
               "step_ms_all": rec["step_ms"],
               "step_ms": float(np.median(ms)),
               "images_per_s": 1e3 * ZOO_BATCH / float(np.median(ms)),
               "first_batch_wait_s": rec["data_wait_s"][0],
               "max_memory_allocated_bytes":
                   rec["max_memory_allocated_bytes"],
               "worker_aborts": text.count("killed by signal")}
        report[name] = row
        by_path[f"train_{name}"] = {k: rec["totals"][k] for k in want}
        if (bad or len(losses) != rec["iters_per_epoch"]
                or not all(np.isfinite(losses))
                or not all(v > 0 for v in row["l1_losses"])
                or row["worker_aborts"]):
            raise AssertionError(f"train_zoo {name}: steps {bad} launched "
                                 f"otherwise than {want}, or: {row}")
        ckpts[name] = os.path.join(out, name.replace("-", "_"),
                                   "latest_ckpt.pth")
    return report, by_path, ckpts


# tools.eval's forward / NMS estimate adds 8 forwards on the first batch: an
# untimed and three timed calls of the infer function, and of the
# decode-only one
SPLIT_FORWARDS = 8
SPLIT_LINE = (r"Average forward time(?: per batch)?: ([0-9.]+) ms, Average "
              r"NMS time[^:]*: ([0-9.]+) ms, Average inference time"
              r"(?: per batch)?: ([0-9.]+) ms")


def eval_cli_in_process(argv: list, cwd=None) -> tuple:
    """``tools.eval``'s ``main(argv)`` here, in ``cwd``, the counts set to 0
    just before: (its printed text, AP line, forward / NMS / inference ms,
    the forward launches, fused ones, launches by variant, wall s)."""
    import io
    import re

    from eop_tpu_torch.ops.phase_conv import phase_conv
    from eop_tpu_torch.tools import eval as eval_cli

    _reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.chdir(cwd or ROOT):
        eval_cli.main(argv)
    torch.cuda.synchronize()
    text = buf.getvalue()
    aps = re.findall(AP_LINE, text)
    split = re.findall(SPLIT_LINE, text)
    return (text, [float(v) for v in aps[-1]] if aps else None,
            [float(v) for v in split[-1]] if split else None,
            phase_conv.launches, phase_conv.fused_launches, _variants(),
            time.perf_counter() - t0)


def eval_zoo(smi: str, data_dir: str, ckpts: dict):
    """``tools.eval -n NAME -c CKPT -b 8`` in this process for each zoo
    model (the AP line, the forward / NMS split; its forward launches
    counted from 0 just before, 8 or 10 a forward, fused where the model is
    SiLU), then the label oracle through YOLOX-Tiny's evaluator, at its
    416-px test size (AP 1)."""
    from eop_tpu_torch.eval import fast_cocoeval
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.utils.synth import LabelOracle

    report, by_path = {"phase": "eval_zoo", "card": smi}, {}
    # the evaluator runs its first batch twice (the first call untimed)
    forwards = -(-BBOX_VAL_IMAGES // EVAL_BATCH) + 1 + SPLIT_FORWARDS
    for name, fused in (("yolox-nano", True), ("yolox-tiny", True),
                        ("yolov3", False)):
        per_forward = step_launches(name)["forward"]
        text, ap, split, n, n_fused, variants, wall = eval_cli_in_process(
            ["-n", name, "-c", ckpts[name], "-b", str(EVAL_BATCH),
             "--data-dir", data_dir, "test_conf", "1e-5",
             "data_num_workers", "0"])
        row = {"wall_s": wall, "ap_line": ap, "split_ms": split,
               "phase_conv_launches": n, "phase_conv_fused_launches": n_fused,
               "launches_by_variant": variants}
        report[name] = row
        by_path[f"eval_{name}"] = n
        PATH_VARIANTS[f"eval_{name}"] = variants
        if (ap is None or split is None or n != per_forward * forwards
                or variants != forward_variants(
                    list(ZOO_VARIANTS[name].values()), forwards)
                or n_fused != (n if fused else 0)):
            raise AssertionError(f"eval_zoo {name}: {row}\n{text[-3000:]}")
    exp = get_exp(exp_name="yolox-tiny")
    exp.data_dir, exp.data_num_workers = data_dir, 0
    evaluator = exp.get_evaluator(EVAL_BATCH)
    fast_cocoeval.match_image.native_calls = 0
    o5095, o50, _ = evaluator.evaluate(
        LabelOracle(evaluator.dataloader.dataset, "cuda"))
    report["oracle"] = {"exp": "yolox-tiny", "test_size": list(exp.test_size),
                        "ap50_95": float(o5095), "ap50": float(o50),
                        "native_matcher_calls":
                            fast_cocoeval.match_image.native_calls}
    if not (abs(o5095 - 1.0) <= 1e-6 and abs(o50 - 1.0) <= 1e-6):
        raise AssertionError(f"eval_zoo oracle: {report['oracle']}")
    return report, by_path


# ---------------------------------------------------------------------------
# PASCAL VOC: YOLOX-S (depth 0.33, width 0.50, 20 classes, 640 px) from
# exps/example/yolox_voc/yolox_voc_s.py; its 8 early convs have MAIN_PATH's
# shapes

VOC_EXP_FILE = os.path.join(ROOT, "exps", "example", "yolox_voc",
                            "yolox_voc_s.py")
# (8 trainval images a year, not 16: two steps an epoch, room for 16f)
VOC_TRAINVAL, VOC_TEST, VOC_HW = 8, 8, (375, 500)
VOC_ACCUM = 2
# the (forward, weight-gradient, data-gradient) variants of its 8 convs,
# in MAIN_PATH's order (None: the stem has no data gradient)
VOC_PATH = ([("wgmma_rows", "wgmma", None),
             ("wgmma_taps", "wgmma", "wgmma_classes")]
            + [("wgmma_taps", "wgmma", "flipped:wgmma_taps")] * 5
            + [("wgmma_taps", "wgmma", "wgmma_classes")])
# one micro-batch: 8 forward convs, 8 weight and 7 data gradients, each data
# gradient packing its weights; a step launches VOC_ACCUM times as many
VOC_MICRO_LAUNCHES = {"forward": 8, "wgrad": 8, "dgrad": 7, "pack": 7,
                      **variant_counts(VOC_PATH)}
VOC_STEP_LAUNCHES = {k: VOC_ACCUM * v for k, v in VOC_MICRO_LAUNCHES.items()}
def voc_steps(root: str, timed: int = 4) -> dict:
    """YOLOX-S's training step on two VOC batches of 8 (no mosaic, loaded
    here), 640 px, with accum 1 and 2 in turn from the same seeded model:
    one untimed step, then ``timed`` steps by CUDA events, peak memory, and
    each step's launches by variant checked against one or two
    micro-batches'."""
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.losses import YoloxLossConfig
    from eop_tpu_torch.train.steps import create_train_state, \
        make_train_step_bbox

    exp = get_exp(VOC_EXP_FILE)
    exp.data_dir, exp.data_num_workers, exp.seed = root, 0, 0
    it = iter(exp.get_data_loader(BBOX_BATCH, no_aug=True, seed=0))
    batches = [tuple(torch.as_tensor(t).float().cuda() for t in next(it)[:2])
               for _ in range(2)]
    del it
    out = {}
    for accum in (1, 2):
        want = {k: accum * v for k, v in VOC_MICRO_LAUNCHES.items()}
        model = exp.get_model("cuda", seed=0).train()
        state = create_train_state(model, exp.get_optimizer(
            model, BBOX_BATCH, 4))
        step = make_train_step_bbox(
            YoloxLossConfig(num_classes=exp.num_classes),
            ema_decay=exp.ema_decay, accum_steps=accum)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        for i in range(timed + 1):
            imgs, labels = batches[i % 2]
            _reset_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = step(state, imgs, labels)
            end.record()
            counts = _launch_counts()
            if {k: counts[k] for k in want} != want:
                raise AssertionError(f"voc accum {accum}: step {i} launched "
                                     f"{counts}, expected {want}")
            torch.cuda.synchronize()
            losses.append(float(metrics["total_loss"]))
            if i:
                ms.append(start.elapsed_time(end))
        out[f"accum{accum}"] = {
            "step_ms": float(np.median(ms)), "step_ms_all": ms,
            "losses": losses,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        if not all(np.isfinite(losses)):
            raise AssertionError(f"voc accum {accum}: losses {losses}")
        del model, state, step
        torch.cuda.empty_cache()
    return out


SHOW_IMAGES = 4
SHOW_FORWARD = {"wgmma_rows": 1, "wgmma_taps": 7}  # a 24p-s forward


def show_24p_child(out_path: str, argv) -> int:
    """``python3 chip_smoke.py --show-24p-child OUT -- ARGS``: run
    ``eop_tpu_torch.tools.show_24p``'s ``main(ARGS)`` in this process,
    where cv2 does not import, with the launch counts from 0; write each
    image's rows, file and times, the counts and the wall time to OUT as
    JSON."""
    sys.modules["cv2"] = None
    from eop_tpu_torch.ops.phase_conv import phase_conv
    from eop_tpu_torch.tools import show_24p

    _reset_counts()
    t0 = time.perf_counter()
    evaluator = show_24p.main(list(argv))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    report = {"wall_s": time.perf_counter() - t0,
              "images": [{**r, "rows": r["rows"].tolist()}
                         for r in evaluator.results],
              "counts": _launch_counts(),
              "fused_launches": phase_conv.fused_launches}
    with open(out_path, "w") as f:
        json.dump(report, f)
    return 0


def show_24p_phase(smi: str, root: str):
    """The rest of the 24p family on the card's machine, without OpenCV:

    * ``python -m eop_tpu_torch.tools.show_24p -n yolox_24p_s -w REF -p DIR
      test_conf 1e-5`` in a child (through :func:`show_24p_child`) over 4
      seeded 720x1280 JPEGs (``utils/synth.write_polygon_dataset``), REF the
      seeded 24p-s saved in the reference's ``{"model": state_dict}``
      form: four files written that decode; each image's rows equal to
      ``exp.get_infer_fn``'s in this process on the same
      ``get_data_input`` batch and weights, and the CPU's within the serve
      phase's tolerance (:func:`detections_vs`: the same count, median
      matched IoU 0.5 or more); 8 fused ``phase_conv`` launches an image,
      1 ``wgmma_rows`` and 7 ``wgmma_taps``, none on ``direct``; per image
      the read, forward, draw and encode ms;
    * ``python -m eop_tpu_torch.tools.labels_create_24p`` on the same json
      (its polygon segmentations): rows of 51 columns that
      ``COCO24PDataset`` reads, at least one label an image past the hull
      gate.

    Returns (report, the child's launch counts)."""
    from eop_tpu_torch.data.coco24p import COCO24PDataset
    from eop_tpu_torch.data.image_io import imread
    from eop_tpu_torch.eval.postprocess import Detections
    from eop_tpu_torch.tools.eval import eval_weights
    from eop_tpu_torch.utils.synth import write_polygon_dataset

    t_phase = time.perf_counter()
    img_dir, json_path = write_polygon_dataset(os.path.join(root, "data"),
                                               SHOW_IMAGES, DATASET_HW)
    exp = serving_exp()
    pth = os.path.join(root, "yolox_24p_s_ref.pth")
    torch.save({"model": exp.get_model("cpu").state_dict()}, pth)
    child_out = os.path.join(root, "show_child.json")
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
           "--show-24p-child", child_out, "--", "-n", "yolox_24p_s", "-w",
           pth, "-p", img_dir, "test_conf", str(exp.test_conf),
           "output_dir", os.path.join(root, "show_out")]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    child_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"show_24p child: {r.stdout[-2000:]}\n"
                             f"{r.stderr[-3000:]}")
    with open(child_out) as f:
        child = json.load(f)
    printed = [ln for ln in r.stdout.splitlines() if " detections -> " in ln]

    # the same files through get_infer_fn here, on the card and the CPU
    per_image = []
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = exp.get_model(dev)
        models[dev].load_state_dict(eval_weights(pth), strict=True)
    infers = {dev: exp.get_infer_fn(m, dev) for dev, m in models.items()}
    for img in child["images"]:
        batch, _, raw = exp.get_data_input(os.path.join(img_dir, img["file"]))
        dets = {dev: infer(batch) for dev, infer in infers.items()}
        here = dets["cuda"].rows[0][dets["cuda"].valid[0]].cpu().numpy()
        got = np.asarray(img["rows"], np.float32).reshape(-1, 29)
        written = imread(img["path"])
        per_image.append({
            "file": img["file"], "detections": len(got),
            **{k: img[k] for k in ("read_ms", "forward_ms", "draw_ms",
                                   "encode_ms")},
            "rows_equal_in_process": bool(np.array_equal(got, here)),
            "rows_max_abs_diff_in_process": (
                float(np.abs(got - here).max()) if got.shape == here.shape
                and len(got) else None),
            "written_shape": list(written.shape),
            "written_differs_from_input": bool(
                written.shape == raw.shape and not np.array_equal(written,
                                                                  raw)),
            "vs_cpu": detections_vs(
                Detections(dets["cuda"].rows.cpu(), dets["cuda"].valid.cpu()),
                Detections(dets["cpu"].rows, dets["cpu"].valid))})
    del models, infers
    counts = child["counts"]

    # the label generator on the same json, as a user runs it
    labels_dir = os.path.join(root, "labels")
    t0 = time.perf_counter()
    lr = subprocess.run([sys.executable, "-m",
                         "eop_tpu_torch.tools.labels_create_24p", "--json",
                         json_path, "--images", img_dir, "--out",
                         labels_dir], cwd=ROOT, capture_output=True,
                        text=True, timeout=600)
    labels_s = time.perf_counter() - t0
    dataset = COCO24PDataset(data_dir=img_dir, label_dir=labels_dir,
                             img_size=(640, 640))
    rows = {stem: v.shape for stem, v in dataset.coco24p_dict.items()}
    _, target, hw, _ = dataset[0]
    with open(json_path) as f:
        n_annotations = len(json.load(f)["annotations"])
    report = {
        "phase": "show_24p", "card": smi, "model": "yolox_24p_s",
        "weights": "reference form {'model': state_dict}", "images":
        SHOW_IMAGES, "height": DATASET_HW[0], "width": DATASET_HW[1],
        "test_conf": exp.test_conf, "child_s": child_s,
        "child_wall_s": child["wall_s"], "per_image": per_image,
        "printed_lines": len(printed),
        "phase_conv_launches": counts["forward"],
        "phase_conv_fused_launches": child["fused_launches"],
        "launches_by_variant": _variants(counts),
        "labels": {"exit": lr.returncode, "seconds": labels_s,
                   "annotations": n_annotations,
                   "rows_by_image": {k: list(v) for k, v in rows.items()},
                   "first_target_shape": list(target.shape),
                   "first_hw": list(hw)},
    }
    want = {f"forward:{k}": v * SHOW_IMAGES for k, v in SHOW_FORWARD.items()}
    ok = (len(per_image) == SHOW_IMAGES == len(printed)
          and all(p["rows_equal_in_process"] and p["detections"] > 0
                  and p["written_shape"] == [*DATASET_HW, 3]
                  and p["written_differs_from_input"]
                  and p["vs_cpu"]["count"] == p["vs_cpu"]["count_ref"]
                  and p["vs_cpu"]["matched_iou_median"] >= 0.5
                  for p in per_image)
          and counts["forward"] == child["fused_launches"]
          == 8 * SHOW_IMAGES
          and all(counts[k] == v for k, v in want.items())
          and counts["forward:direct"] == 0
          and lr.returncode == 0 and len(rows) == SHOW_IMAGES
          and all(v[0] >= 1 and v[1] == 51 for v in rows.values()))
    report["phase_s"] = time.perf_counter() - t_phase
    if not ok:
        raise AssertionError(f"show_24p: {report}\n{lr.stderr[-2000:]}")
    return report, counts


# 16e: the deployment path
DEPLOY_SRC_HW = (720, 1280)
DEPLOY_FRAMES = 32
DEPLOY_REQUESTS = 4
# the 24p-s forward's phase_conv launches by variant: all 8 early convs in
# fp32; under int8 at the default gate (64) dark2's CSP conv3 (64 -> 64) and
# dark3's down conv (64 -> 128) are int8 convs instead
DEPLOY_FORWARD = {"wgmma_rows": 1, "wgmma_taps": 7}
DEPLOY_FORWARD_INT8 = {"wgmma_rows": 1, "wgmma_taps": 5}
ARTIFACT_LINE = r"exported \S+: ([0-9.]+) MB in ([0-9.]+) s"
# int8 against fp32 before NMS: tests/test_quant.py's bounds on eop_tpu's
# int8 path (geometry relative to its largest magnitude; sigmoided scores)
INT8_GEO_REL, INT8_SCORE_ATOL = 0.15, 0.05
PTQ_LINE = r"int8 PTQ: (\d+) convs quantized \(min_channels=(\d+)\)"


def _child(cmd: list, log: str):
    """``python -m CMD`` in the repository, its output in the file ``log``."""
    out = open(log, "w")
    try:
        return subprocess.Popen([sys.executable, "-m", *cmd], cwd=ROOT,
                                stdout=out, stderr=subprocess.STDOUT)
    finally:
        out.close()


def _child_output(proc, log: str, what: str, timeout: float = 600) -> str:
    proc.wait(timeout=timeout)
    with open(log) as f:
        text = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}\n{text[-3000:]}")
    return text


def post_raw(url: str, img: np.ndarray) -> list:
    """One raw-body ``POST /v1/detect``: the answer's detections."""
    req = urllib.request.Request(
        f"{url}/v1/detect", data=img.tobytes(), method="POST",
        headers={"X-Raw-Shape": ",".join(map(str, img.shape))})
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            raise AssertionError(f"HTTP {r.status}")
        return json.loads(r.read())["detections"]


def _same_detections(got, want) -> dict:
    """Artifact ``Detections`` against the live serving function's: bit-equal
    rows and masks, or (where cuDNN's choice differs between the two) equal
    masks and rows within the serve phase's tolerance."""
    bit = bool(torch.equal(got.valid, want.valid)
               and torch.equal(got.rows, want.rows))
    v = want.valid
    diff = (float((got.rows[v] - want.rows[v]).abs().max()) if v.any()
            else 0.0)
    scale = max(1.0, float(want.rows[v].abs().max())) if v.any() else 1.0
    return {"bit_equal": bit, "valid_equal": bool(torch.equal(got.valid, v)),
            "rows_max_abs_diff": diff,
            "ok": bit or (bool(torch.equal(got.valid, v))
                          and diff <= FP32_TOL * scale)}


def _counters() -> dict:
    """:func:`_launch_counts` with the fused launches and the int8 convs."""
    from eop_tpu_torch.ops import quant
    from eop_tpu_torch.ops.phase_conv import phase_conv

    return {**_launch_counts(), "fused": phase_conv.fused_launches,
            "int8_conv": quant.int8_conv.calls,
            "int8_off_phase_conv": quant.int8_conv.off_phase_conv}


def _artifact_launches(svc, raw) -> dict:
    """One call of the served artifact: what the registered operators
    counted inside the program (the counters' change over the call)."""
    before = _counters()
    svc._serve_fn(raw)
    torch.cuda.synchronize()
    after = _counters()
    delta = {k: v - before[k] for k, v in after.items()}
    return {"phase_conv": delta["forward"], "fused": delta["fused"],
            "by_variant": {k.split(":")[1]: v for k, v in delta.items()
                           if k.startswith("forward:") and v},
            "int8_conv": delta["int8_conv"],
            "int8_off_phase_conv": delta["int8_off_phase_conv"]}


def _geo_rel(model, qmodel, imgs) -> dict:
    """int8 against fp32 on the decoded head outputs before NMS, as
    ``tests/test_quant.py`` measures: the geometry (centres and radii) by
    its largest error over its largest magnitude (``geo_rel``), the
    sigmoided scores by their largest error."""
    from eop_tpu_torch.models.yolox import inference_outputs

    with torch.inference_mode():
        x = imgs.permute(0, 3, 1, 2)
        ref = inference_outputs(model(x)[0], reg_dim=26).float()
        out = inference_outputs(qmodel(x)[0], reg_dim=26).float()
    geo = (out[..., :26] - ref[..., :26]).abs().max() / ref[..., :26].abs(
        ).max()
    return {"geo_rel": float(geo),
            "score_max_abs_diff": float((out[..., 26:] - ref[..., 26:]).abs(
                ).max())}


def deploy_children(img_dir: str, lab_dir: str, root: str) -> dict:
    """Start 16e's command lines at once, in ``root``: the three exports
    (the seeded weights of ``get_model``, ``test_conf 1e-5`` as in the serve
    phases) and the int8 evaluation of phase 10's files.  Returns their
    artifacts', logs' and processes' dicts (:func:`deploy_phase` reads
    them; :func:`stop_children` ends any still running)."""
    art = {k: os.path.join(root, f"{k}.pt2") for k in ("fp32", "int8", "l")}
    logs = {k: os.path.join(root, f"{k}.log")
            for k in ("fp32", "int8", "l", "eval")}
    base = ["eop_tpu_torch.tools.export_serving", "--batch",
            str(SERVE_BATCH), "--src-hw", ",".join(map(str, DEPLOY_SRC_HW))]
    cmds = {"fp32": [*base, "-n", "yolox_24p_s", "--out", art["fp32"],
                     "--smoke", "test_conf", "1e-5"],
            "int8": [*base, "-n", "yolox_24p_s", "--out", art["int8"],
                     "--int8", "--calib", img_dir, "test_conf", "1e-5"],
            "l": [*base, "-n", "yolox-l", "--out", art["l"], "test_conf",
                  "1e-5"],
            "eval": ["eop_tpu_torch.tools.eval", "-f",
                     "load_eval/yolox_24p_eval.py", "-b", str(EVAL_BATCH),
                     "--data-dir", img_dir, "--label-dir", lab_dir,
                     "--int8"]}
    return {"art": art, "logs": logs, "img_dir": img_dir,
            "procs": {k: _child(cmd, logs[k]) for k, cmd in cmds.items()}}


def stop_children(children) -> None:
    for p in (children or {}).get("procs", {}).values():
        if p.poll() is None:
            p.kill()
            p.wait(timeout=60)


def deploy_phase(smi: str, children: dict):
    """The deployment path (docstring item 16e), after
    :func:`deploy_children`'s command lines.  Returns the report and the
    phase's launch counts (from 0 at its start)."""
    import re

    from eop_tpu_torch.ops import quant
    from eop_tpu_torch.serving.service import DetectionService
    from eop_tpu_torch.utils.serving_export import calibration_batch

    t_phase = time.perf_counter()
    art, logs, procs = children["art"], children["logs"], children["procs"]
    img_dir = children["img_dir"]
    report = {"phase": "deploy", "card": smi, "src_hw": list(DEPLOY_SRC_HW),
              "batch": SERVE_BATCH}
    servers, printed = [], {}
    try:
        _reset_counts()
        for k in ("fp32", "int8", "l"):
            text = _child_output(procs[k], logs[k], f"export_serving {k}")
            mb, export_s = (float(v) for v in
                            re.search(ARTIFACT_LINE, text).groups())
            report[f"export_{k}"] = {
                "mb": os.path.getsize(art[k]) / 1e6, "printed_mb": mb,
                "export_s": export_s}
            printed[k] = text
        if "smoke: rows(8, 300, 29) valid(8, 300)" not in printed["fp32"]:
            raise AssertionError(f"export --smoke: {printed['fp32'][-2000:]}")
        # serve --artifact for fp32 and int8, both started at once, while
        # this process builds the live fp32 and int8 programs
        for k in ("fp32", "int8"):
            servers.append(_launch_server(["--artifact", art[k]], ()))
        exp = serving_exp()
        model = exp.get_model("cuda")
        live = exp.get_serving_fn(model, DEPLOY_SRC_HW, "cuda")
        calib = calibration_batch(img_dir, DEPLOY_SRC_HW, exp.test_size,
                                  device="cuda")
        deploy, scales = exp.quantize_for_inference(model, [calib])
        n_quant = len(quant.quantized_keys(deploy, scales, 64))
        live8 = exp.get_serving_fn(deploy, DEPLOY_SRC_HW, "cuda", scales)
        n, gate = (int(v) for v in
                   re.search(PTQ_LINE, printed["int8"]).groups())
        report["export_int8"]["convs_quantized"] = n
        if (n, gate) != (n_quant, 64):
            raise AssertionError(f"export --int8 quantized {n} convs at "
                                 f"{gate}, this process {n_quant}")
        svc = {k: DetectionService.from_artifact(art[k], device="cuda",
                                                 max_wait_ms=20.0)
               for k in ("fp32", "int8")}
        try:
            # 32 seeded frames through the artifact and the live function
            rng = np.random.RandomState(7)
            frames = rng.randint(0, 256, (DEPLOY_FRAMES, *DEPLOY_SRC_HW, 3),
                                 np.uint8)
            for k, fn in (("fp32", live), ("int8", live8)):
                checks = [_same_detections(
                    svc[k]._serve_fn(frames[i:i + SERVE_BATCH]),
                    fn(frames[i:i + SERVE_BATCH]))
                    for i in range(0, DEPLOY_FRAMES, SERVE_BATCH)]
                report[f"artifact_{k}_vs_live"] = {
                    "batches": len(checks),
                    "bit_equal": all(c["bit_equal"] for c in checks),
                    "valid_equal": all(c["valid_equal"] for c in checks),
                    "rows_max_abs_diff": max(c["rows_max_abs_diff"]
                                             for c in checks)}
                if not all(c["ok"] for c in checks):
                    raise AssertionError(f"{k} artifact vs live: {checks}")
                report[f"artifact_{k}_launches"] = _artifact_launches(
                    svc[k], frames[:SERVE_BATCH])
            report["valid_detections_fp32"] = int(live(frames[:8]).valid.sum())
            # HTTP: each server's answers equal this process's artifact's
            reqs = [np.random.RandomState(4 + i).randint(
                0, 256, (640, 640, 3), np.uint8)
                for i in range(DEPLOY_REQUESTS)]
            for k, server in zip(("fp32", "int8"), servers):
                url, banner, start_s = _await_server(server)
                t = time.perf_counter()
                answers = [post_raw(url, img) for img in reqs]
                http_ms = 1e3 * (time.perf_counter() - t) / len(reqs)
                local = [json.loads(json.dumps(svc[k].detect(img)))
                         for img in reqs]
                report[f"serve_artifact_{k}"] = {
                    "start_s": start_s, "banner": banner,
                    "request_ms_mean": http_ms,
                    "detections": [len(a) for a in answers],
                    "equal_in_process": answers == local}
                if answers != local or min(map(len, answers)) <= 0:
                    raise AssertionError(f"serve --artifact {k}: answers "
                                         "differ from the in-process ones")
        finally:
            for v in svc.values():
                v.close()
            for server in servers:  # idle servers off before the timings
                _stop_server(server[0])
        # YOLOX-L's artifact answering one request
        lsvc = DetectionService.from_artifact(art["l"], device="cuda")
        try:
            before = _counters()["forward"]
            dets = lsvc.detect(reqs[0])
            l_launches = _counters()["forward"] - before
        finally:
            lsvc.close()
        report["artifact_l"] = {"detections": len(dets),
                                "class_names": bool(lsvc.class_names),
                                "phase_conv_launches": l_launches}
        if not dets or "bbox" not in dets[0] or l_launches != 12:
            raise AssertionError(f"YOLOX-L artifact: {report['artifact_l']}")
        # the int8 evaluation's lines
        text = _child_output(procs["eval"], logs["eval"], "eval --int8")
        n, _ = (int(v) for v in re.search(PTQ_LINE, text).groups())
        ap = re.findall(AP_LINE, text)
        report["eval_int8"] = {"convs_quantized": n, "ap50_95": float(
            ap[-1][0]) if ap else None, "ap50": float(ap[-1][1]) if ap
            else None, "worker_aborts": text.count("killed by signal")}
        if not ap or n != n_quant:
            raise AssertionError(f"eval --int8: {text[-3000:]}")
        # int8 on this card, with no child running: forward ms at B=8 beside
        # fp32 and bf16, the decoded outputs against fp32, one int32
        # accumulator against the CPU
        qmodel = quant.quantize_model(deploy, scales)
        exp16 = serving_exp()
        exp16.compute_dtype = "bfloat16"
        model16 = exp16.get_model("cuda")
        x = calib[:SERVE_BATCH].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        with torch.inference_mode():
            report["forward_ms"] = {
                name: cuda_ms(lambda m=m: m(x), iters=10)
                for name, m in (("fp32", deploy), ("int8", qmodel),
                                ("bf16", model16), ("fp32_unfused", model))}
        report["int8_vs_fp32"] = _geo_rel(deploy, qmodel, calib[:SERVE_BATCH])
        conv = qmodel.get_submodule("backbone.backbone.dark3.0.conv")
        seen = []
        h = conv.register_forward_pre_hook(lambda _m, a: seen.append(a[0]))
        with torch.inference_mode():
            qmodel(x)
            acc = conv.accumulate(seen[0])
            cpu = copy.deepcopy(conv).cpu().accumulate(seen[0].cpu())
        h.remove()
        report["int32_accumulator"] = {
            "conv": "backbone.backbone.dark3.0.conv",
            "shape": list(acc.shape),
            "card_equals_cpu": bool(torch.equal(acc.cpu(), cpu))}
        if not report["int32_accumulator"]["card_equals_cpu"]:
            raise AssertionError("int8 accumulator: card != CPU")
        counts = _launch_counts()
    finally:
        for server in servers:
            _stop_server(server[0])
        stop_children(children)
    art_fp32, art_int8 = (report[f"artifact_{k}_launches"]
                          for k in ("fp32", "int8"))
    report["convs_quantized"] = n_quant
    report["phase_s"] = time.perf_counter() - t_phase
    ok = (art_fp32["fused"] == art_fp32["phase_conv"] == 8
          and art_fp32["by_variant"] == DEPLOY_FORWARD
          and art_fp32["int8_conv"] == 0
          and art_int8["fused"] == art_int8["phase_conv"] == 6
          and art_int8["by_variant"] == DEPLOY_FORWARD_INT8
          and art_int8["int8_conv"] == n_quant
          and art_int8["int8_off_phase_conv"] == 2
          and report["valid_detections_fp32"] > 0
          and all(np.isfinite(v) for v in report["forward_ms"].values())
          # tests/test_quant.py's bounds on eop_tpu's int8 path
          and report["int8_vs_fp32"]["geo_rel"] < INT8_GEO_REL
          and report["int8_vs_fp32"]["score_max_abs_diff"] < INT8_SCORE_ATOL)
    if not ok:
        raise AssertionError(f"deploy: {report}")
    return report, counts



def voc_phase(smi: str, root: str, bbox_dir: str):
    """PASCAL VOC on the card (docstring item 16c).  Returns the report,
    the training child's launch totals and {evaluation: (its forward
    launches, by variant)}."""
    import io
    import re

    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.utils.synth import LabelOracle, write_voc_devkit

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    devkit = write_voc_devkit(root, VOC_TRAINVAL, VOC_TEST, VOC_HW, seed=0)
    report = {"phase": "voc", "card": smi, "model": "yolox_voc_s",
              "depth": 0.33, "width": 0.50, "num_classes": 20,
              "input_size": [640, 640], "batch": BBOX_BATCH,
              "accum": VOC_ACCUM, "devkit_s": time.perf_counter() - t0,
              "trainval_images": 2 * VOC_TRAINVAL, "test_images": VOC_TEST,
              "image_hw": list(VOC_HW)}

    # training: a mosaic epoch, the no-aug switch, an L1 epoch scored by
    # VOC mAP on the EMA weights (the switch sets eval_interval 1)
    out_dir = os.path.join(root, "voc_out")
    record = os.path.join(root, "train_voc.json")
    cmd = [sys.executable, os.path.abspath(__file__), "--train-bbox-child",
           record, "--", "-f", VOC_EXP_FILE, "-b", str(BBOX_BATCH),
           "--accum", str(VOC_ACCUM), "--data-dir", root, "max_epoch", "2",
           "no_aug_epochs", "0", "eval_interval", "10", "data_num_workers",
           "2", "seed", "0", "print_interval", "4", "output_dir", out_dir]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    wall = time.perf_counter() - t0
    log = r.stdout + r.stderr
    aps = re.findall(AP_LINE, log)
    if r.returncode != 0 or len(aps) != 1:
        raise AssertionError(f"voc train: rc {r.returncode}, AP lines {aps}"
                             f"\n{log[-6000:]}")
    with open(record) as f:
        rec = json.load(f)
    iters = rec["iters_per_epoch"]
    losses = [m["total_loss"] for m in rec["metrics"]]
    l1 = [m["l1_loss"] for m in rec["metrics"]]
    bad = [i for i, c in enumerate(rec["launches"])
           if {k: c[k] for k in VOC_STEP_LAUNCHES} != VOC_STEP_LAUNCHES]
    ms = rec["step_ms"]
    report["train"] = {
        "command": " ".join(cmd[4:]), "rc": r.returncode, "wall_s": wall,
        "steps": len(ms), "iters_per_epoch": iters, "losses": losses,
        "l1_losses": l1, "num_fg": [m["num_fg"] for m in rec["metrics"]],
        "expected_launches_per_step": VOC_STEP_LAUNCHES,
        "launches_per_step": rec["launches"][-1], "step_ms_all": ms,
        "step_ms_mosaic": float(np.median(ms[1:iters])),
        "step_ms_no_aug": float(np.median(ms[iters + 1:])),
        "first_batch_wait_s": rec["data_wait_s"][0],
        "switch_first_batch_wait_s": rec["data_wait_s"][iters],
        "data_wait_ms_median": 1e3 * float(np.median(rec["data_wait_s"])),
        "max_memory_allocated_bytes": rec["max_memory_allocated_bytes"],
        "ap_lines": [[float(a), float(b)] for a, b in aps],
        "eval_forward_launches": rec["totals"]["forward"] - sum(
            c["forward"] for c in rec["launches"]),
        "eval_fused_launches": rec["fused_launches"],
        "worker_aborts": r.stderr.count("killed by signal")}
    if (len(ms) != 2 * iters or iters != 2 * VOC_TRAINVAL // BBOX_BATCH
            or bad or not all(np.isfinite(losses))
            or any(v != 0 for v in l1[:iters])
            or not all(v > 0 for v in l1[iters:])
            or report["train"]["worker_aborts"]
            or report["train"]["eval_fused_launches"]
            != report["train"]["eval_forward_launches"]
            # one evaluation of the one test batch, which runs it twice
            or report["train"]["eval_forward_launches"]
            != 2 * VOC_MICRO_LAUNCHES["forward"]):
        raise AssertionError(f"voc train: steps {bad} launched otherwise "
                             f"than {VOC_STEP_LAUNCHES}, or: "
                             f"{report['train']}")

    # the step alone with accum 1 and 2 on batches held on the card
    report["steps"] = voc_steps(root)

    # tools.eval -f on the checkpoint: the first batch twice, then the
    # split's forwards (10 of 8 fused launches), the 20 class APs; once
    # more --legacy
    ckpt = os.path.join(out_dir, "yolox_voc_s", "latest_ckpt.pth")
    base = ["-f", VOC_EXP_FILE, "-c", ckpt, "-b", str(EVAL_BATCH),
            "--data-dir", root, "data_num_workers", "0"]
    forwards = -(-VOC_TEST // EVAL_BATCH) + 1 + SPLIT_FORWARDS
    evals = {}
    for name, extra in (("eval_voc", []), ("eval_voc_legacy", ["--legacy"])):
        text, ap, split, n, fused, variants, wall = eval_cli_in_process(
            base[:4] + extra + base[4:])
        evals[name] = (n, variants)
        row = {"wall_s": wall, "ap_line": ap, "split_ms": split,
               "class_ap_lines": text.count("AP for "),
               "phase_conv_launches": n, "fused_launches": fused,
               "launches_by_variant": variants}
        report[name] = row
        if (ap is None or split is None or row["class_ap_lines"] != 20
                or abs(split[0] + split[1] - split[2]) > 0.011
                or n != VOC_MICRO_LAUNCHES["forward"] * forwards or fused != n
                or variants != forward_variants(VOC_PATH, forwards)):
            raise AssertionError(f"voc {name}: {row}\n{text[-3000:]}")

    # the label oracle through VOCEvaluator on the card
    exp = get_exp(VOC_EXP_FILE)
    exp.data_dir, exp.data_num_workers = root, 0
    evaluator = exp.get_evaluator(EVAL_BATCH)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        o5095, o50, _ = evaluator.evaluate(
            LabelOracle(evaluator.dataloader.dataset, "cuda"))
    report["oracle"] = {"map50_95": float(o5095), "map50": float(o50),
                        "images": evaluator.timings["images"],
                        "class_ap_lines": printed.getvalue().count("AP for ")}
    if not (abs(o5095 - 1.0) <= 1e-6 and abs(o50 - 1.0) <= 1e-6
            and report["oracle"]["images"] == VOC_TEST):
        raise AssertionError(f"voc oracle: {report['oracle']}")

    # --testdev: the bbox dataset's val split laid out as test-dev, scored
    # through ./yolox_testdev_2017.json in a directory of its own
    os.symlink("val2017", os.path.join(bbox_dir, "test2017"))
    shutil.copy(os.path.join(bbox_dir, "annotations", "instances_val2017.json"),
                os.path.join(bbox_dir, "annotations",
                             "instances_test2017.json"))
    cwd = os.path.join(root, "testdev")
    os.makedirs(cwd)
    text, ap, split, n, fused, variants, wall = eval_cli_in_process(
        ["-n", "yolox-s", "-b", str(EVAL_BATCH), "--data-dir", bbox_dir,
         "--testdev", "test_conf", "1e-5", "data_num_workers", "0"], cwd)
    evals["eval_testdev"] = (n, variants)
    written = os.path.join(cwd, "yolox_testdev_2017.json")
    with open(written) as f:
        n_results = len(json.load(f))
    forwards = -(-BBOX_VAL_IMAGES // EVAL_BATCH) + 1 + SPLIT_FORWARDS
    report["eval_testdev"] = {"wall_s": wall, "ap_line": ap, "split_ms": split,
                              "json_results": n_results,
                              "phase_conv_launches": n,
                              "fused_launches": fused}
    if (ap is None or split is None or n_results <= 0
            or n != VOC_MICRO_LAUNCHES["forward"] * forwards or fused != n
            or variants != forward_variants(VOC_PATH, forwards)):
        raise AssertionError(f"voc testdev: {report['eval_testdev']}\n"
                             f"{text[-3000:]}")
    report["phase_s"] = time.perf_counter() - t_phase
    return report, rec["totals"], evals


# ---- the feature-map study: YOLOX-L over VGG19, ResNet50, DenseNet121 ----

BACKBONES = ("vgg", "resnet", "densenet")
BACKBONE_STEPS = 4
# demo_featuremap as a child in which the plotting and OpenCV libraries do
# not import (the card's machine has none of them)
DEMO_CHILD = (
    "import sys\n"
    "for name in ('cv2', 'matplotlib', 'seaborn', 'tabulate'):\n"
    "    sys.modules[name] = None\n"
    "from eop_tpu_torch.tools.demo_featuremap import main\n"
    "main(sys.argv[1:])\n")


def file_batches(data_dir: str, n: int) -> list:
    """``n`` batches of 8 from the bbox dataset's files through the exp's
    own loader (no mosaic, loaded in this process), on the card."""
    from eop_tpu_torch.exp import get_exp

    exp = get_exp(exp_name="yolox-l")
    exp.data_dir, exp.data_num_workers, exp.seed = data_dir, 0, 0
    it = iter(exp.get_data_loader(BBOX_BATCH, no_aug=True, seed=0))
    out = []
    for _ in range(n):
        imgs, labels = next(it)[:2]
        out.append((torch.as_tensor(imgs).float().cuda(),
                    torch.as_tensor(labels).float().cuda()))
    return out


def bbox_detections_vs(dets, ref) -> dict:
    """One image's bbox detections against a reference's: the counts, the
    scores in order (largest relative difference), the boxes of each that
    lie within 10,000 px of the image and cover more than a pixel (random
    weights can collapse a box's width or send its height past 1e10), and
    the median best IoU of those with the reference's (None where
    either has none)."""
    from eop_tpu_torch.ops.boxes import bboxes_iou

    got = dets.rows[0][dets.valid[0]].float().cpu()
    want = ref.rows[0][ref.valid[0]].float().cpu()
    gs = (got[:, 4] * got[:, 5]).sort(descending=True).values
    ws = (want[:, 4] * want[:, 5]).sort(descending=True).values
    def proper(rows):
        b = rows[:, :4]
        keep = ((b.abs() < 1e4).all(1)
                & ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) > 1.0))
        return b[keep]

    gf, wf = proper(got), proper(want)
    iou = (bboxes_iou(gf, wf).amax(dim=1).median().item()
           if len(gf) and len(wf) else None)
    return {"count": len(got), "count_ref": len(want),
            "score_max_rel_err": ((gs - ws).abs().max() / ws.abs().max())
            .item() if len(gs) == len(ws) and len(ws) else None,
            "boxes_in_frame": len(gf), "boxes_in_frame_ref": len(wf),
            "matched_iou_median": iou}


def backbone_phase(smi: str, backbone: str, batches: list) -> dict:
    """YOLOX-L at full width over ``backbone``, seeded weights: one serving
    call at B=8, 640 px, in fp32 and bf16 (stages by CUDA events), one image
    on the card against the CPU (the 6-tuple within 1e-3 of each output's
    scale, the detections by IoU), ``BACKBONE_STEPS`` fp32 training steps on
    the files' batches (step ms, peak memory, losses; DenseNet's dropout
    kept fraction), ``get_model_info``'s line.  No path may launch
    ``phase_conv``: these backbones are ``F.conv2d``."""
    from eop_tpu_torch.eval.postprocess import postprocess_bbox_heads
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.losses import YoloxLossConfig
    from eop_tpu_torch.models.densenet import ChannelDropout, step_seed
    from eop_tpu_torch.models.yolox import dropouts
    from eop_tpu_torch.train.steps import create_train_state, \
        make_train_step_bbox
    from eop_tpu_torch.utils.model_utils import get_model_info

    t_phase = time.perf_counter()
    report = {"phase": "backbone", "backbone": backbone, "card": smi,
              "model": "yolox-l", "batch": BBOX_BATCH,
              "input_size": [640, 640]}
    _reset_counts()
    for dtype in ("float32", "bfloat16"):
        exp = get_exp(exp_name="yolox-l")
        exp.backbone_type, exp.compute_dtype = backbone, dtype
        model = exp.get_model("cuda", seed=0)
        torch.cuda.reset_peak_memory_stats()
        st = serving_stages(smi, exp, model, iters=5)
        report[f"serve_{dtype}"] = {
            k: st[k] for k in ("h2d_letterbox_ms", "forward_ms",
                               "postprocess_ms", "call_wall_ms",
                               "profiled_device_busy_ms", "own_kernels",
                               "top_kernels")}
        report[f"serve_{dtype}"]["max_memory_allocated_bytes"] = (
            torch.cuda.max_memory_allocated())
        if dtype == "float32":
            report["model_info"] = get_model_info(model, (640, 640))
            # one image on the card and on the CPU
            raw = torch.from_numpy(np.random.RandomState(7).uniform(
                0, 255, (1, 640, 640, 3)).astype(np.float32))
            outs, dets = {}, {}
            for dev, m in (("cuda", model), ("cpu", exp.get_model("cpu",
                                                                  seed=0))):
                with torch.inference_mode():
                    heads, fpn = m(raw.to(dev).permute(0, 3, 1, 2).contiguous(
                        memory_format=torch.channels_last))
                    dets[dev] = postprocess_bbox_heads(
                        heads, exp.num_classes, conf_thre=1e-6,
                        nms_thre=exp.nmsthre)
                outs[dev] = [t.float().cpu() for t in (*heads, *fpn)]
                del m
            errs = [((g - c).abs().max() / c.abs().max().clamp(min=1.0))
                    .item() for g, c in zip(outs["cuda"], outs["cpu"])]
            report["card_vs_cpu"] = {
                "max_rel_err": max(errs), "tol": 1e-3,
                "taps_channels": [t.shape[1] for t in outs["cpu"][-3:]],
                "detections": bbox_detections_vs(dets["cuda"],
                                                 dets["cpu"])}
        del model
        torch.cuda.empty_cache()
    serve_launches = _launch_counts()["forward"]

    # training steps on the files' batches
    exp = get_exp(exp_name="yolox-l")
    exp.backbone_type = backbone
    torch.cuda.reset_peak_memory_stats()
    model = exp.get_model("cuda", seed=0).train()
    state = create_train_state(model, exp.get_optimizer(
        model, BBOX_BATCH, BACKBONE_STEPS))
    gens = dropouts(model)
    events = []

    def hook(name_, metrics=None):
        if name_ in ("start", "step"):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((ev, metrics))

    step = make_train_step_bbox(YoloxLossConfig(num_classes=exp.num_classes),
                                ema_decay=exp.ema_decay, hook=hook)
    for i, (imgs, labels) in enumerate(batches[:BACKBONE_STEPS]):
        for d in gens:  # as the Trainer seeds them
            d.reseed(step_seed(exp.seed or 0, i))
        state, _ = step(state, imgs, labels)
    torch.cuda.synchronize()
    ms = [events[2 * i][0].elapsed_time(events[2 * i + 1][0])
          for i in range(BACKBONE_STEPS)]
    losses = [float(events[2 * i + 1][1]["total_loss"])
              for i in range(BACKBONE_STEPS)]
    report["train"] = {
        "steps": BACKBONE_STEPS, "step_ms_all": ms,
        "step_ms": float(np.median(ms[1:])), "losses": losses,
        "num_fg": [float(events[2 * i + 1][1]["num_fg"])
                   for i in range(BACKBONE_STEPS)],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    if gens:
        # the steps' masks again, replayed from each step's seed: DenseNet's
        # 58 dense layers draw (B, 32) each, in order
        kept = []
        for i in range(BACKBONE_STEPS):
            replay = ChannelDropout(gens[0].p, step_seed(exp.seed or 0, i))
            kept += [replay.keep_mask((BBOX_BATCH, 32, 1, 1), "cuda")
                     for _ in range(58)]
        kept = torch.cat(kept)
        report["train"]["dropout_kept_fraction"] = kept.float().mean().item()
        report["train"]["dropout_drawn"] = kept.numel()
    counts = _launch_counts()
    report["phase_conv_launches"] = {"serve": serve_launches,
                                     "train": {k: counts[k] for k in (
                                         "forward", "wgrad", "dgrad",
                                         "pack")}}
    del state, model
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    cvc = report["card_vs_cpu"]
    if (serve_launches or any(report["phase_conv_launches"]["train"].values())
            or cvc["max_rel_err"] > 1e-3
            or cvc["taps_channels"] != [256, 512, 1024]
            or not 0 < cvc["detections"]["count"]
            == cvc["detections"]["count_ref"]
            or cvc["detections"]["score_max_rel_err"] > 1e-3
            or (cvc["detections"]["matched_iou_median"] is not None
                and cvc["detections"]["matched_iou_median"] < 0.99)
            or not (np.isfinite(losses).all() and np.isfinite(ms).all())
            or not report["train"]["max_memory_allocated_bytes"] > 0
            or (backbone == "densenet" and not 0.6 < report["train"][
                "dropout_kept_fraction"] < 0.8)):
        raise AssertionError(f"backbone {backbone}: {report}")
    return report


def demo_featuremap_start(root: str) -> dict:
    """``python -m eop_tpu_torch.tools.demo_featuremap -n yolox-l --backbone
    resnet --theta-range 30,95,30`` on a synthesized fixture, started in a
    child in which cv2, matplotlib, seaborn and tabulate do not import
    (beside the study's other phases)."""
    from eop_tpu_torch.utils.synth import write_featuremap_fixture

    fixture = write_featuremap_fixture(os.path.join(root, "fixture"))
    out = os.path.join(root, "demo_out")
    cmd = [sys.executable, "-c", DEMO_CHILD, "-n", "yolox-l", "--backbone",
           "resnet", "--theta-range", "30,95,30", "--json", fixture,
           "--conf", "0.001", "output_dir", out]
    logs = [os.path.join(root, f"demo.{n}") for n in ("out", "err")]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=open(logs[0], "w"),
                            stderr=open(logs[1], "w"))
    return {"out": out, "proc": proc, "logs": logs,
            "t0": time.perf_counter(), "procs": {"demo": proc}}


def demo_featuremap_phase(smi: str, started: dict) -> dict:
    """:func:`demo_featuremap_start`'s child, finished: every sweep's
    images, figures, gt.json and dt.json, four AP blocks, a finite
    activation table."""
    import re

    out, proc = started["out"], started["proc"]
    try:
        proc.wait(timeout=600)
    finally:
        stop_children(started)
    stdout, stderr = (open(f).read() for f in started["logs"])
    r = types.SimpleNamespace(returncode=proc.returncode, stdout=stdout,
                              stderr=stderr)
    wall = time.perf_counter() - started["t0"]
    sweeps = ("none", "theta_30", "theta_60", "theta_90")
    files = {}
    for sweep in sweeps:
        files[sweep] = {
            "new_data": sorted(os.listdir(os.path.join(out, "new_data",
                                                       sweep)))
            if os.path.isdir(os.path.join(out, "new_data", sweep)) else [],
            "vis_res": len(os.listdir(os.path.join(
                out, "yolox_l_resnet", "vis_res", sweep)))
            if os.path.isdir(os.path.join(out, "yolox_l_resnet", "vis_res",
                                          sweep)) else 0,
            "dt_json": os.path.exists(os.path.join(
                out, "yolox_l_resnet", "dt_json", sweep, "dt.json"))}
    text = r.stdout
    blocks = [s for s in sweeps if f"{'*' * 24}{s}{'*' * 24}" in text]
    ap = re.findall(r"Average Precision.*= *(-?[0-9.]+)", text)
    table = text[text.find("===== Feature Map Size"):]
    values = [float(v) for v in re.findall(r"(-?[0-9]+\.[0-9]+|nan)(?= *\|)",
                                           table)]
    finite = int(np.isfinite(values).sum()) if values else 0
    n_dt = {}
    for sweep in sweeps:
        path = os.path.join(out, "yolox_l_resnet", "dt_json", sweep,
                            "dt.json")
        if os.path.exists(path):
            with open(path) as f:
                n_dt[sweep] = len(json.load(f))
    report = {"phase": "demo_featuremap", "card": smi, "backbone": "resnet",
              "model": "yolox-l", "wall_s": wall, "exit": r.returncode,
              "files": files, "ap_blocks": blocks, "ap_lines": len(ap),
              "ap": ap[:12], "detections": n_dt,
              "table_values": len(values), "table_finite": finite,
              "model_summary": next((ln for ln in text.splitlines()
                                     if ln.startswith("Model Summary")), "")}
    ok = (r.returncode == 0 and len(blocks) == 4 and len(ap) == 4 * 6
          and len(values) == 60 and finite > 0
          and all(len(f["new_data"]) == 6 and "gt.json" in f["new_data"]
                  and f["vis_res"] == 10 and f["dt_json"]
                  for f in files.values()))
    if not ok:
        raise AssertionError(f"demo_featuremap: {report}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    return report


def host_resize(smi: str, reps: int = 7) -> dict:
    """The two host resizers on the loader's and the letterbox's shapes
    (median wall ms of ``reps``, one torch thread as in a loader worker):
    ``resize_host`` (torch bilinear, within one level of cv2) and
    ``resize_linear`` (cv2's fixed point, bit for bit; the feature-map
    study's)."""
    from eop_tpu_torch.data.transforms import resize_host, resize_linear

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    report = {"phase": "host_resize", "card": smi, "reps": reps}
    try:
        for src, dst in (((480, 640), (640, 853)), ((720, 1280), (360, 640))):
            img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
            for name, fn in (("resize_host", resize_host),
                             ("resize_linear", resize_linear)):
                ts = []
                for _ in range(reps):
                    t = time.perf_counter()
                    fn(img, dst)
                    ts.append(time.perf_counter() - t)
                report[f"{name}_{src[0]}x{src[1]}_to_{dst[0]}x{dst[1]}_ms"] = (
                    1e3 * float(np.median(ts)))
    finally:
        torch.set_num_threads(threads)
    return report


def backbones_phases(smi: str, data_dir: str, root: str) -> dict:
    """The study's models at full width, then one HTTP round through
    ``serve -n yolox-l backbone_type resnet``, beside them the study
    itself (its child started first): each phase's line emitted, their
    times returned."""
    demo_started = demo_featuremap_start(root)
    try:
        return _backbones_phases(smi, data_dir, demo_started)
    finally:
        stop_children(demo_started)


def _backbones_phases(smi: str, data_dir: str, demo_started: dict) -> dict:
    t0 = time.perf_counter()
    batches = file_batches(data_dir, BACKBONE_STEPS)
    load_s = time.perf_counter() - t0
    times = {"file_batches_s": load_s}
    for backbone in BACKBONES:
        report = backbone_phase(smi, backbone, batches)
        emit(report)
        times[backbone] = report["phase_s"]
    del batches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    start_s, codes, n_dets, ms, stats, lines = serve_round(
        ["-n", "yolox-l", "test_conf", "1e-5", "backbone_type", "resnet"],
        4, "serve -n yolox-l backbone_type resnet")
    http = {"phase": "serve_backbone", "card": smi, "backbone": "resnet",
            "start_s": start_s, "http_codes": codes, "detections": n_dets,
            "request_ms_median": float(np.median(ms)),
            "device_calls": stats.get("device_calls"),
            "banner": [ln.strip() for ln in lines[-2:]],
            "phase_s": time.perf_counter() - t0}
    emit(http)
    if codes != [200] * 4 or min(n_dets) <= 0 or "device=cuda" not in "".join(
            lines):
        raise AssertionError(f"serve_backbone: {http}")
    times["serve_backbone"] = http["phase_s"]
    demo = demo_featuremap_phase(smi, demo_started)
    emit(demo)
    times["demo_featuremap"] = demo["wall_s"]
    emit(host_resize(smi))
    return times


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def probe_worker_exit(drops: int = 8) -> int:
    """``python3 chip_smoke.py --probe-worker-exit``: with a CUDA context in
    this process, drop the training loader with batches in flight ``drops``
    times as the port builds it and ``drops`` times without its workers'
    exit hook, and print the workers that died in each and, for the run
    without the hook, what the workers' faulthandler and native dumps
    hold."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.zeros(1, device="cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    unraisable, default_hook = [], sys.unraisablehook
    sys.unraisablehook = lambda u: unraisable.append(str(u.exc_value))
    root = tempfile.mkdtemp(prefix="chip_smoke_probe_")
    report = {"phase": "probe_worker_exit", "card": smi}
    try:
        from eop_tpu_torch import _build

        # built here once (not installed here): the workers load the file
        _build.load("terminate_probe")
        img_dir, lab_dir, _ = write_dataset(root)
        fault_dir = os.path.join(root, "faulthandler")
        os.makedirs(fault_dir)
        for name, exit_hook in (("exit_hook", True), ("teardown", False)):
            seen = len(unraisable)
            report[name] = drop_loaders(img_dir, lab_dir, drops, exit_hook,
                                        None if exit_hook else fault_dir)
            gc.collect()
            report[name]["workers_died"] = sum(
                "killed by signal" in u or "exited unexpectedly" in u
                for u in unraisable[seen:] + report[name]["errors"])
        time.sleep(5)  # workers still ending write their dumps
        report["teardown"]["faulthandler"] = fault_dumps(fault_dir)
    finally:
        sys.unraisablehook = default_hook
        shutil.rmtree(root, ignore_errors=True)
    emit(report)
    return 0


def repeat_serve_bbox(runs: int) -> int:
    """``python3 chip_smoke.py --repeat-serve-bbox N``: the serve_bbox phase
    N times in one process after the kernels' build, one JSON line a run
    with its result and the launch-debugging settings of the environment
    (``CUDA_LAUNCH_BLOCKING=1`` stops at the launch that fails).  Stops at
    the first failure, printing its traceback: a device-side assert leaves
    the CUDA context unusable."""
    import traceback

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from eop_tpu_torch import _build
    from eop_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision(torch.device("cuda"))
    smi = nvidia_smi()
    print(smi, flush=True)
    _build.build_all()
    env = {k: os.environ.get(k)
           for k in ("CUDA_LAUNCH_BLOCKING", "TORCH_USE_CUDA_DSA")}
    for run in range(runs):
        t0 = time.perf_counter()
        row = {"phase": "repeat_serve_bbox", "card": smi, "run": run,
               "env": env}
        try:
            report, _ = serve_bbox(smi)
        except Exception:  # noqa: BLE001 - reported, then the run stops
            emit({**row, "ok": False, "seconds": time.perf_counter() - t0,
                  "error": traceback.format_exc()[-6000:]})
            return 1
        emit({**row, "ok": True, "seconds": time.perf_counter() - t0,
              "forward_calls": report["forward_calls"],
              "http_200": report["http_200"],
              "alone_answers_equal_direct_call":
                  report["alone_answers_equal_direct_call"]})
    return 0


# the in-process training steps that --compare-steps times in each checkout
COMPARED_STEPS = (("yolox-l", "bfloat16"), ("yolox-x", "float32"),
                  ("yolox-x", "bfloat16"))
COMPARED_WARMUP, COMPARED_TIMED = 3, 8


def steps_child(tree: str, out_path: str) -> int:
    """The steps of :data:`COMPARED_STEPS` (batch 8, 640 px, one seeded
    batch on the card) with the ``eop_tpu_torch`` of the checkout ``tree``:
    each step's ms by CUDA events, and the data gradients' launches by
    variant of the last step; written as JSON to ``out_path``."""
    sys.path.insert(0, os.path.abspath(tree))
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.losses import YoloxLossConfig
    from eop_tpu_torch.ops import phase_conv as pcm
    from eop_tpu_torch.train.steps import create_train_state, \
        make_train_step_bbox
    from eop_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision(torch.device("cuda"))
    imgs, labels = bbox_synthetic_batch(BBOX_BATCH, 640)
    out = {"package": os.path.dirname(pcm.__file__)}
    for name, dtype in COMPARED_STEPS:
        exp = get_exp(exp_name=name)
        exp.compute_dtype = dtype
        torch.cuda.empty_cache()
        model = exp.get_model("cuda", seed=0).train()
        state = create_train_state(model, exp.get_optimizer(model, BBOX_BATCH,
                                                            8))
        events = []

        def hook(name_, metrics=None):
            if name_ in ("start", "step"):
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
                if name_ == "start":
                    events.append(dict(pcm.phase_conv.dgrad_variant_launches))

        step = make_train_step_bbox(YoloxLossConfig(num_classes=BBOX_CLASSES),
                                    ema_decay=exp.ema_decay, hook=hook)
        for _ in range(COMPARED_WARMUP + COMPARED_TIMED):
            state, _ = step(state, imgs, labels)
        torch.cuda.synchronize()
        ms = [events[3 * i].elapsed_time(events[3 * i + 2])
              for i in range(COMPARED_WARMUP, COMPARED_WARMUP + COMPARED_TIMED)]
        last = events[-2]
        out[f"{name}:{dtype}"] = {
            "step_ms": float(np.median(ms)), "step_ms_all": ms,
            "dgrad_launches_by_variant": {
                v: n - last.get(v, 0) for v, n in
                pcm.phase_conv.dgrad_variant_launches.items()
                if n != last.get(v, 0)}}
        del state, model
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def compare_steps(trees) -> int:
    """``python3 chip_smoke.py --compare-steps TREE ...``: the training steps
    of :data:`COMPARED_STEPS` with the port of each checkout ``TREE`` in
    the order given (e.g. parent, change, change, parent), each in a
    process of its own on this card; one JSON line a run, then the medians
    by checkout."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi, flush=True)
    by_tree: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_steps_") as tmp:
        for i, tree in enumerate(trees):
            record = os.path.join(tmp, f"{i}.json")
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--steps-child",
                 os.path.abspath(tree), record], cwd=tree,
                capture_output=True, text=True, timeout=900)
            if r.returncode != 0:
                print(r.stdout[-3000:], r.stderr[-6000:], file=sys.stderr)
                return 1
            with open(record) as f:
                rec = json.load(f)
            emit({"phase": "compare_steps", "card": smi, "run": i,
                  "tree": tree, "wall_s": time.perf_counter() - t0, **rec})
            for key, row in rec.items():
                if key != "package":
                    by_tree.setdefault(tree, {}).setdefault(key, []).extend(
                        row["step_ms_all"])
    emit({"phase": "compare_steps_summary", "card": smi,
          "median_step_ms": {t: {k: float(np.median(v)) for k, v in rows.items()}
                             for t, rows in by_tree.items()}})
    return 0


def kernel_accuracy_child(tree: str, out_path: str) -> int:
    """The fp32 hand kernels of the checkout ``tree`` at YOLOX-L's early
    convs and YOLOv3's stem (B=2, 320 px, seeded) against float64
    convolutions, beside cuDNN fp32: forward, weight and data gradient,
    each error's mean and largest value over the float64 result's largest
    value and its mean signed toward the result's sign (below 0: toward
    zero); the forward's and the data gradient's ms a call.  Then
    :func:`bbox_card_vs_cpu` ungated for each model of
    :data:`BBOX_FLOAT64_REFEREE`, with the hand kernels and with cuDNN
    throughout.  Written as JSON to ``out_path``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch.nn.functional as F

    from eop_tpu_torch import _build
    from eop_tpu_torch.ops import phase_conv as pc
    from eop_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision(torch.device("cuda"))
    _build.build_all()
    back = torch.ops.aten.convolution_backward

    def dist(got, ref):
        err, scale = got.double() - ref, ref.abs().max().item()
        return {"mean": err.abs().mean().item() / scale,
                "max": err.abs().max().item() / scale,
                "bias": (err * ref.sign()).mean().item() / scale}

    rows = []
    # the shapes of tests/test_torch_gpu.py::
    # test_fp32_kernels_match_cudnn_against_float64 (its inputs: the same
    # seed, draws and halved sizes), then YOLOv3's stem
    tested = [(f"test.{k}x{k}s{s}c{c}", (k, s, p, 80, 80, c, co))
              for k, s, p, c, co in ((3, 2, 1, 128, 256), (3, 1, 1, 64, 64),
                                     (1, 1, 0, 128, 128), (6, 2, 2, 3, 64),
                                     (3, 1, 1, 3, 32))]
    cases = [*YOLOX_L_PATH, *tested, ("v3.stem", (3, 1, 1, 640, 640, 3, 32))]
    for name, (k, s, p, h, w, c, co), *_ in cases:
        g = torch.Generator().manual_seed(0)
        x = torch.randn(2, h // 2, w // 2, c, generator=g).cuda()
        wt = (torch.randn(k, k, c, co, generator=g)
              / (k * k * c) ** 0.5).cuda()
        xn, wn = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
        y64 = F.conv2d(xn.double(), wn.double(), stride=s, padding=p)
        dy = torch.randn(y64.shape, generator=g).cuda()
        dyh = dy.permute(0, 2, 3, 1).contiguous()
        args = ([s, s], [p, p], [1, 1], False, [0, 0], 1, [True, True, False])
        dx64, dw64, _ = back(dy.double(), xn.double(), wn.double(), None,
                             *args)
        dx32, dw32, _ = back(dy, xn, wn, None, *args)
        row = {"name": name, "case": [k, s, p, h // 2, w // 2, c, co],
               "forward": dist(pc.phase_conv(x, wt, s, p).permute(0, 3, 1, 2),
                               y64),
               "forward_cudnn": dist(F.conv2d(xn, wn, stride=s, padding=p),
                                     y64),
               "wgrad": dist(pc.phase_conv_wgrad(x, dyh, k, s, p).permute(
                   3, 2, 0, 1), dw64),
               "wgrad_cudnn": dist(dw32, dw64),
               "forward_ms": cuda_ms(lambda: pc.phase_conv(x, wt, s, p))}
        if c % 8 == 0:
            row["dgrad"] = dist(pc.phase_conv_dgrad(
                dyh, wt, tuple(x.shape), s, p).permute(0, 3, 1, 2), dx64)
            row["dgrad_cudnn"] = dist(dx32, dx64)
            row["dgrad_ms"] = cuda_ms(lambda: pc.phase_conv_dgrad(
                dyh, wt, tuple(x.shape), s, p))
        rows.append(row)
    referee = [{k: r[k] for k in ("model", "kernels", "loss_rel_err",
                                  "assignment_equal", "float64")}
               for name in BBOX_FLOAT64_REFEREE for kernels in (True, False)
               for r in [bbox_card_vs_cpu(name, gate=False, kernels=kernels)]]
    with open(out_path, "w") as f:
        json.dump({"package": os.path.dirname(pc.__file__), "rows": rows,
                   "referee": referee}, f)
    return 0


def kernel_accuracy(trees) -> int:
    """``python3 chip_smoke.py --kernel-accuracy TREE ...``: run
    :func:`kernel_accuracy_child` for each checkout in turn (a process
    each; give parent, change, change, parent), one JSON line a tree with
    the card's name and power limit."""
    smi = nvidia_smi()
    for tree in trees:
        fd, out = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--kernel-accuracy-child", tree, out],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr)
            return r.returncode
        with open(out) as f:
            emit({"phase": "kernel_accuracy", "tree": tree, "card": smi,
                  **json.load(f)})
        os.remove(out)
    return 0


def backbones_only() -> int:
    """``python3 chip_smoke.py --backbones``: the bbox dataset written to a
    temporary directory, then :func:`backbones_phases` alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from eop_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision(torch.device("cuda"))
    smi = nvidia_smi()
    print(smi, flush=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_backbones_")
    try:
        emit({**write_bbox_dataset(os.path.join(root, "coco")), "card": smi})
        emit({"phase": "backbones_done", "card": smi, **backbones_phases(
            smi, os.path.join(root, "coco"), os.path.join(root, "fm"))})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from eop_tpu_torch import _build
    from eop_tpu_torch.utils.device import set_fp32_precision

    set_fp32_precision(torch.device("cuda"))
    smi = nvidia_smi()
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit({"phase": "device", "nvidia_smi": smi, **device,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "unix_time_at_t0": time.time() - (time.perf_counter() - T_START)})

    t0 = time.perf_counter()
    info = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": info, "sass": sass_summary(_build)})
    emit(decode_phase(smi))

    shapes, err32, err16 = check_phase_conv()
    for row in shapes:
        emit({"phase": "phase_conv", "card": smi, **row})
    l_fwd_cases, l_back_cases = yolox_l_cases()
    l_shapes, l_err32, l_err16 = check_phase_conv(l_fwd_cases)
    for row in l_shapes:
        emit({"phase": "phase_conv_yolox_l", "card": smi, **row})
    z_fwd_cases, z_back_cases = zoo_cases()
    z_shapes, z_err32, z_err16 = check_phase_conv(z_fwd_cases)
    for row in z_shapes:
        emit({"phase": "phase_conv_zoo", "card": smi, **row})

    exp = serving_exp()
    model = exp.get_model("cuda")
    serve_report, launches, threaded_answers = serve_main_path(smi, exp,
                                                               model)
    emit(serve_report)
    t0 = time.perf_counter()
    async_report, async_launches = serve_async(smi, exp, model,
                                               threaded_answers)
    async_report["phase_s"] = time.perf_counter() - t0
    emit(async_report)
    emit(serving_stages(smi, exp, model))
    emit(card_vs_cpu(exp))
    t0 = time.perf_counter()
    serve16_report, serve16_launches = serve_bf16(smi, model)
    serve16_report["phase_s"] = time.perf_counter() - t0
    emit(serve16_report)
    del model
    relu_report, relu_launches = serve_relu(smi)
    emit(relu_report)
    t0 = time.perf_counter()
    bbox_serve_report, bbox_serve_launches = serve_bbox(smi)
    bbox_serve_report["phase_s"] = time.perf_counter() - t0
    emit(bbox_serve_report)
    # the servers as processes of their own under the load generator
    t0 = time.perf_counter()
    load_phase(smi)
    emit({"phase": "load_done", "card": smi,
          "phase_s": time.perf_counter() - t0})

    back_rows, back_err = check_phase_conv_backward()
    for row in back_rows:
        emit({"phase": "phase_conv_backward", "card": smi, **row})
    l_back_rows, l_back_err = check_phase_conv_backward(l_back_cases)
    for row in l_back_rows:
        emit({"phase": "phase_conv_backward_yolox_l", "card": smi, **row})
    z_back_rows, z_back_err = check_phase_conv_backward(z_back_cases)
    for row in z_back_rows:
        emit({"phase": "phase_conv_backward_zoo", "card": smi, **row})
    train_report, repeat_launches = train_main_path(smi)
    emit(train_report)
    emit(train_card_vs_cpu())
    # the bf16 step, then the same with remat (the exp file's settings)
    t0 = time.perf_counter()
    train16_report, train16_launches = train_main_path(smi, "bfloat16")
    train16_report["card_vs_cpu"] = train_card_vs_cpu("bfloat16")
    train16_report["phase_s"] = time.perf_counter() - t0
    emit(train16_report)
    t0 = time.perf_counter()
    remat_report, remat_launches = train_main_path(smi, "bfloat16", True)
    remat_report.update(remat_bn_check(smi))
    remat_report["phase_s"] = time.perf_counter() - t0
    peaks = [r["max_memory_allocated_bytes"]
             for r in (remat_report, train16_report)]
    remat_report.update(
        bf16_step_ms=train16_report["step_ms"],
        bf16_max_memory_allocated_bytes=peaks[1],
        peak_memory_ratio_to_bf16=peaks[0] / peaks[1])
    emit(remat_report)
    if not peaks[0] < peaks[1]:
        raise AssertionError(f"remat did not lower the peak memory: {peaks}")

    # a loader that finds a dead worker while it stops raises in __del__,
    # which reaches sys.unraisablehook: count those of the file phases
    unraisable, default_hook = [], sys.unraisablehook

    def count_unraisable(u):
        unraisable.append(str(u.exc_value))
        default_hook(u)

    data_root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    sys.unraisablehook = count_unraisable
    deploy_started = dp_cli = dp_ranks = mp_started = None
    try:
        img_dir, lab_dir, data_report = write_dataset(data_root)
        emit({**data_report, "card": smi})
        files_report, files_launches = train_files(smi, img_dir, lab_dir,
                                                   train_report)
        emit(files_report)
        eval_report, eval_launches = eval_files(smi, img_dir, lab_dir)
        emit(eval_report)
        # 16e's command lines run beside the cli phase's (both phases'
        # wall times count the other's processes)
        deploy_started = deploy_children(
            img_dir, lab_dir, tempfile.mkdtemp(dir=data_root))
        # 16f's world-1 command lines run beside the cli phase's too
        dp_cli = dp_cli_start(img_dir, lab_dir,
                              tempfile.mkdtemp(dir=data_root))
        cli_report = run_cli(smi, img_dir, lab_dir)
        emit(cli_report)
        # 16f: the world-1 command lines' evaluations
        dp_cli_evals(dp_cli)
        drops = drop_loaders(img_dir, lab_dir, drops=1)
        # the bbox family: YOLOX-L from COCO files
        bbox_dir = os.path.join(data_root, "coco")
        emit({**write_bbox_dataset(bbox_dir), "card": smi})
        bbox_out = os.path.join(data_root, "bbox_out")
        # 16f's two ranks run beside YOLOX-L's training child; then the
        # one-process reference and the comparison
        dp_ranks = dp_ranks_start()
        bbox_report, bbox_launches, _ = train_bbox(smi, bbox_dir, bbox_out)
        dp_report, dp_launches = dp_ranks_phase(smi, dp_ranks)
        emit(dp_report)
        emit(dp_cli_phase(smi, dp_cli))
        bf16_report, bbox16_launches = train_bbox_steps(smi)
        bbox_report["bf16_step"] = bf16_report
        emit(bbox_report)
        emit(bbox_card_vs_cpu())
        # the feature-map study: YOLOX-L over VGG19, ResNet50, DenseNet121
        # (served, card against CPU, trained from the files), served over
        # HTTP, and demo_featuremap in a child without OpenCV
        emit({"phase": "backbones_done", "card": smi, **backbones_phases(
            smi, bbox_dir, os.path.join(data_root, "featuremap"))})
        # YOLOX-X's steps, whose 13 data gradients all left the CUDA cores
        x_reports, x_launches = {}, {}
        for dtype, path in (("float32", "train_x"),
                            ("bfloat16", "train_x_bf16")):
            t0 = time.perf_counter()
            x_reports[dtype], x_launches[path] = train_bbox_steps(
                smi, "yolox-x", dtype)
            x_reports[dtype]["phase_s"] = time.perf_counter() - t0
            emit(x_reports[dtype])
        emit(eval_bbox(smi, bbox_dir, os.path.join(bbox_out, "yolox_l",
                                                   "latest_ckpt.pth")))
        # YOLOX-Nano, YOLOX-Tiny and YOLOv3 trained, evaluated, and one
        # step of YOLOv3 and of Nano on the card against the CPU
        t0 = time.perf_counter()
        zoo_report, zoo_launches, zoo_ckpts = train_zoo(
            smi, bbox_dir, os.path.join(data_root, "zoo_out"))
        zoo_report["phase_s"] = time.perf_counter() - t0
        emit(zoo_report)
        t0 = time.perf_counter()
        zoo_eval_report, zoo_eval_launches = eval_zoo(smi, bbox_dir,
                                                      zoo_ckpts)
        zoo_eval_report["phase_s"] = time.perf_counter() - t0
        emit(zoo_eval_report)
        # 16g's ranks and its one-process side run beside the VOC,
        # show_24p and deployment phases; then the comparison
        mp_started = mp_start()
        # YOLOX-S on PASCAL VOC: trained with --accum 2, evaluated (also
        # --legacy), the oracle, and --testdev on the bbox dataset
        voc_report, voc_launches, voc_evals = voc_phase(
            smi, os.path.join(data_root, "voc"), bbox_dir)
        emit(voc_report)
        # the rest of the 24p family: show_24p in a child without OpenCV
        # from a reference-form .pth, labels_create_24p
        show_report, show_launches = show_24p_phase(
            smi, os.path.join(data_root, "show_24p"))
        emit(show_report)
        # the deployment path: torch.export artifacts served, int8 PTQ
        deploy_report, deploy_launches = deploy_phase(smi, deploy_started)
        emit(deploy_report)
        mp_report, mp_launches, mp_serve = mp_phase(smi, mp_started)
        emit(mp_report)
        for name in ("yolov3", "yolox-nano", "yolox-tiny", "yolox-x"):
            emit(bbox_card_vs_cpu(name))
        drops.update(drop_bbox_loaders(bbox_dir, drops=1))
        gc.collect()
    finally:
        sys.unraisablehook = default_hook
        stop_children(deploy_started)
        stop_children(dp_cli)
        stop_children(dp_ranks)
        stop_children(mp_started)
        shutil.rmtree(data_root, ignore_errors=True)
    died = [u for u in unraisable if "killed by signal" in u]
    emit({"phase": "loader_shutdown", "card": smi, **drops,
          "workers_died": len(died),
          "cli_workers_died": (cli_report["train_24p_worker_aborts"]
                               + cli_report["eval_worker_aborts"]),
          "bbox_workers_died": bbox_report["worker_aborts"],
          "voc_workers_died": voc_report["train"]["worker_aborts"],
          "zoo_workers_died": sum(zoo_report[n]["worker_aborts"]
                                  for n in ZOO_NAMES),
          "unraisable": unraisable[:5]})
    if died or cli_report["train_24p_worker_aborts"] or (
            cli_report["eval_worker_aborts"]) or bbox_report["worker_aborts"]:
        raise AssertionError(f"loader workers died: {died}")
    # each path's launches, counted from 0 just before it ran: the forward
    # serves (serve; serve_relu without the epilogue) and evaluates (eval) at
    # batch 8 and trains at batch 32
    # (train: one batch repeated; train_files: the file loader)
    # (bf16: serve_bf16, and train_bf16 and train_remat, whose recompute
    # launches the forward again)
    by_path = {"serve": launches["phase_conv"],
               "serve_async": async_launches["phase_conv"],
               "serve_relu": relu_launches["phase_conv"],
               "serve_bf16": serve16_launches["phase_conv"],
               "eval": eval_launches["phase_conv"],
               "train": repeat_launches["forward"],
               "train_files": files_launches["forward"],
               "train_bf16": train16_launches["forward"],
               "train_remat": remat_launches["forward"],
               # 16f: the two ranks' steps on the card (fp32 and bf16)
               "train_dp": dp_launches["forward"],
               # 16g: the two ranks' steps under --spatial 2 and --tensor
               # 2 (fp32 and bf16), and their sharded inference
               "train_mp": mp_launches["forward"],
               "serve_mp": sum(n for k, n in mp_serve.items()
                               if k.startswith("forward:")),
               # YOLOX-L: the training child's total (its steps and the
               # EMA evaluations, which launch the fused forward), and the
               # in-process bf16 steps
               "train_bbox": bbox_launches["forward"],
               "train_bbox_bf16": bbox16_launches["forward"],
               **{k: c["forward"] for k, c in x_launches.items()},
               # the bbox server (YOLOX-L fp32 over HTTP, its bf16 call,
               # one YOLOv3 request), the zoo's evaluations and training
               **bbox_serve_launches, **zoo_eval_launches,
               **{k: c["forward"] for k, c in zoo_launches.items()},
               # YOLOX-S on VOC: the training child's total (steps of two
               # micro-batches and the EMA evaluations), tools.eval's calls
               "train_voc": voc_launches["forward"],
               **{k: n for k, (n, _) in voc_evals.items()},
               # show_24p's child: 24p-s at batch 1 over 4 files
               "show_24p": show_launches["forward"],
               # the deployment phase: 24p-s's fp32 and int8 artifacts and
               # live functions in this process, YOLOX-L's artifact
               "serve_artifact": deploy_launches["forward"]}
    train_paths = {"train": repeat_launches, "train_files": files_launches,
                   "train_bf16": train16_launches,
                   "train_remat": remat_launches,
                   "train_bbox": bbox_launches,
                       "train_bbox_bf16": bbox16_launches, **x_launches,
                   **zoo_launches, "train_voc": voc_launches,
                   # 16f's two ranks (fp32 and bf16 steps, both ranks)
                   "train_dp": dp_launches,
                   # 16g's (spatial and tensor, fp32 and bf16, both ranks)
                   "train_mp": mp_launches}
    train_launches = {k: sum(c[k] for c in train_paths.values())
                      for k in STEP_LAUNCHES}
    # launches by variant on every path: none launches the CUDA-core direct
    # forward or the cuda_cores weight or data gradient
    PATH_VARIANTS.update({
        "serve": _variants(launches), "serve_relu": _variants(relu_launches),
        "serve_async": _variants(async_launches),
        "serve_bf16": _variants(serve16_launches),
        "eval": _variants(eval_launches),
        "show_24p": _variants(show_launches),
        "serve_artifact": _variants(deploy_launches),
        "serve_mp": mp_serve,
        **{k: v for k, (_, v) in voc_evals.items()},
        **{k: _variants(c) for k, c in train_paths.items()}})
    cuda_core_paths = {k: v for k, v in PATH_VARIANTS.items()
                       if v["forward:direct"] or v["wgrad:cuda_cores"]
                       or v["dgrad:cuda_cores"]}
    if cuda_core_paths:
        raise AssertionError(f"CUDA-core forward, weight or data gradient on "
                             f"{cuda_core_paths}")

    def by_variant(kind):
        return {path: {k.split(":", 1)[1]: n for k, n in v.items()
                       if k.startswith(f"{kind}:")}
                for path, v in PATH_VARIANTS.items()}

    # the serving path launches the forward at batch 8, the training step
    # all three kernels at batch 32
    main_rows = [r for r in shapes if "ms" in r and r["batch"] == SERVE_BATCH]
    train_rows = [r for r in shapes if "ms" in r and r["batch"] == TRAIN_BATCH]
    bound = {"operations": 0.0, "bytes": 0.0}
    for r in main_rows:
        bound[r["bound_by"]] += r["bound_ms"]

    def total(key, rows_=main_rows):
        return sum(r[key] for r in rows_)

    pack_rows = [r for r in back_rows if "pack_ms" in r
                 and r["batch"] == TRAIN_BATCH]

    def yolox_l(rows_, keys, **extra):
        """The YOLOX-L shapes at batch 8 summed (12 forward convs, 12 weight
        and 11 data gradients), beside the 24p-s figures."""
        return {"batch": BBOX_BATCH, "shapes": len(rows_),
                **{k: sum(r[k] for r in rows_) for k in keys}, **extra}

    l_pack_rows = [r for r in l_back_rows if "pack_ms" in r]
    z_pack_rows = [r for r in z_back_rows if "pack_ms" in r]

    def zoo(rows_, keys, variant_key=None):
        """The zoo's shapes at batch 8 summed by model (Nano, Tiny at 640
        and at 416, YOLOv3), one row per conv."""
        out = {}
        for m in ("nano", "tiny", "tiny416", "yolov3", "m", "x", "x800"):
            mine = [r for r in rows_ if r["name"].split(".")[0] == m]
            if mine:
                out[m] = {"shapes": len(mine),
                          **{k: sum(r[k] for r in mine) for k in keys}}
                if variant_key:
                    out[m]["variants"] = {r["name"]: r[variant_key]
                                          for r in mine}
        return {"batch": ZOO_BATCH, **out}

    def on_path(kind, batch):
        return [r for r in back_rows if "wgrad_ms" in r and r["batch"] == batch
                and (kind == "wgrad" or r["dgrad_on_path"])]

    def backward_row(kind, source_note):
        rows_, rows_b8 = on_path(kind, TRAIN_BATCH), on_path(kind, SERVE_BATCH)
        by = {"operations": 0.0, "bytes": 0.0}
        for r in rows_:
            by[r[f"{kind}_bound_by"]] += r[f"{kind}_bound_ms"]
        return {
            "name": f"phase_conv_{kind}",
            "route": "cuda",
            "source": "eop_tpu_torch/csrc/phase_conv_backward_tc.cu",
            # JAX differentiates the conv; the Pallas kernel has no VJP
            "replaces": "eop_tpu/ops/pallas/conv_small_c.py:215 (its VJP)",
            "launches": train_launches[kind],
            "launches_by_path": {k: c[kind] for k, c in train_paths.items()},
            "launches_by_variant": {k: v for k, v in by_variant(kind).items()
                                    if k in train_paths},
            "max_abs_err": max(back_err[kind]["fp32"],
                               l_back_err[kind]["fp32"],
                               z_back_err[kind]["fp32"]),
            "max_abs_err_bf16": max(back_err[kind]["bf16"],
                                    l_back_err[kind]["bf16"],
                                    z_back_err[kind]["bf16"]),
            # per training step (B=32, 640 px): the main-path shapes summed
            "batch": TRAIN_BATCH,
            "ms": sum(r[f"{kind}_ms"] for r in rows_),
            "plain_ms": sum(r[f"{kind}_plain_ms"] for r in rows_),
            "bound_ms": sum(r[f"{kind}_bound_ms"] for r in rows_),
            "bound_by": max(by, key=by.get),
            "library_ms": sum(r[f"{kind}_library_ms"] for r in rows_),
            # bf16, as the bf16 step launches them (cuDNN in bf16 beside)
            "ms_bf16": sum(r[f"{kind}_ms_bf16"] for r in rows_),
            "bound_ms_bf16": sum(r[f"{kind}_bound_ms_bf16"] for r in rows_),
            "bound_by_bf16": max(
                ("operations", "bytes"), key=lambda b: sum(
                    r[f"{kind}_bound_ms_bf16"] for r in rows_
                    if r[f"{kind}_bound_by_bf16"] == b)),
            "library_ms_bf16": sum(r[f"{kind}_library_ms_bf16"]
                                   for r in rows_),
            # the same shapes at B=8
            "ms_b8": sum(r[f"{kind}_ms"] for r in rows_b8),
            "plain_ms_b8": sum(r[f"{kind}_plain_ms"] for r in rows_b8),
            "bound_ms_b8": sum(r[f"{kind}_bound_ms"] for r in rows_b8),
            "library_ms_b8": sum(r[f"{kind}_library_ms"] for r in rows_b8),
            # the CUDA-core kernels these replaced, same shapes
            "cuda_cores_ms": sum(r[f"{kind}_cuda_cores_ms"] for r in rows_),
            "cuda_cores_ms_b8": sum(r[f"{kind}_cuda_cores_ms"]
                                    for r in rows_b8),
            "shapes": len(rows_),
            "variants": {r["name"]: r[f"{kind}_variant"] for r in rows_},
            "yolox_l": yolox_l(
                [r for r in l_back_rows
                 if kind == "wgrad" or r["dgrad_on_path"]],
                [f"{kind}_{m}" for m in (
                    "ms", "plain_ms", "bound_ms", "library_ms", "ms_bf16",
                    "bound_ms_bf16", "library_ms_bf16", "cuda_cores_ms",
                    "cuda_cores_ms_bf16")],
                max_abs_err=l_back_err[kind]["fp32"],
                max_abs_err_bf16=l_back_err[kind]["bf16"],
                variants={r["name"]: r[f"{kind}_variant"]
                          for r in l_back_rows
                          if kind == "wgrad" or r["dgrad_on_path"]}),
            "zoo": zoo([r for r in z_back_rows
                        if kind == "wgrad" or r["dgrad_on_path"]],
                       [f"{kind}_{m}" for m in (
                           "ms", "plain_ms", "bound_ms", "library_ms",
                           "ms_bf16", "bound_ms_bf16", "library_ms_bf16",
                           "cuda_cores_ms", "cuda_cores_ms_bf16")]
                       + ([f"dgrad_{m}" for m in (
                           "device_ms", "cuda_cores_device_ms",
                           "device_ms_bf16", "cuda_cores_device_ms_bf16")]
                          if kind == "dgrad" else []),
                       f"{kind}_variant"),
            "note": source_note,
            "card": smi,
        }

    # small_1x1 (csrc/phase_conv_1x1.cu): Nano's five 1x1 convs at B=8, 416
    # px, summed, both ways, beside the routes it replaced (forced)
    small_fwd = [r for r in z_shapes if r["variant"] == "small_1x1"]
    small_back = [r for r in z_back_rows if r["dgrad_variant"] == "small_1x1"]
    small_launches = {path: {"forward": v["forward:small_1x1"],
                             "dgrad": v["dgrad:small_1x1"]}
                      for path, v in PATH_VARIANTS.items()
                      if v["forward:small_1x1"] or v["dgrad:small_1x1"]}
    if not (len(small_fwd) == len(small_back) == 5 and small_launches):
        raise AssertionError(f"small_1x1: {len(small_fwd)} forward and "
                             f"{len(small_back)} data-gradient shapes, "
                             f"launches {small_launches}")
    small_bound = {"operations": 0.0, "bytes": 0.0}
    for r in small_fwd:
        small_bound[r["bound_by"]] += r["bound_ms"]
    small_entry = {
        "name": "phase_conv_small_1x1",
        "route": "cuda",
        "source": "eop_tpu_torch/csrc/phase_conv_1x1.cu",
        "replaces": "eop_tpu/ops/pallas/conv_small_c.py:181",
        "launches": sum(n for v in small_launches.values()
                        for n in v.values()),
        "launches_by_path": small_launches,
        "max_abs_err": max(r[k] for r in small_fwd for k in (
            "max_abs_err_fp32", "max_abs_err_fp32_fused")),
        "max_abs_err_bf16": max(r[k] for r in small_fwd for k in (
            "max_abs_err_bf16", "max_abs_err_bf16_fused")),
        "dgrad_max_abs_err": max(r["dgrad_max_abs_err_fp32"]
                                 for r in small_back),
        "dgrad_max_abs_err_bf16": max(r["dgrad_max_abs_err_bf16"]
                                      for r in small_back),
        "batch": ZOO_BATCH,
        "shapes": {r["name"]: r["case"] for r in small_fwd},
        # the forward, fp32 (per call, CUDA events; device: graph replay)
        **{k: sum(r[k] for r in small_fwd) for k in (
            "ms", "device_ms", "ms_fused", "plain_ms", "bound_ms",
            "library_ms", "library_fused_ms", "direct_ms",
            "direct_device_ms", "taps_ms", "ms_bf16", "device_ms_bf16",
            "bound_bf16_ms", "library_bf16_ms", "direct_ms_bf16",
            "direct_device_ms_bf16", "taps_ms_bf16")},
        "bound_by": max(small_bound, key=small_bound.get),
        # the data gradient: small_1x1 with the weights read transposed,
        # beside the flipped tensor-core route (two launches) it replaced
        "dgrad": {k: sum(r[f"dgrad_{k}"] for r in small_back) for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
            "flipped_ms", "flipped_device_ms", "cuda_cores_ms",
            "ms_bf16", "device_ms_bf16", "bound_ms_bf16",
            "library_ms_bf16", "flipped_ms_bf16",
            "flipped_device_ms_bf16")},
        "card": smi,
    }
    x800 = next(r for r in z_shapes if r["name"] == X800_STEM[0])

    emit({"kernels": [{
        "name": "phase_conv",
        "route": "cuda",
        "source": "eop_tpu_torch/csrc/phase_conv.cu",
        "replaces": "eop_tpu/ops/pallas/conv_small_c.py:181",
        "launches": sum(v for k, v in by_path.items()
                        if k.startswith(("serve", "eval", "show"))),
        "launches_train": train_launches["forward"],
        "launches_by_path": by_path,
        # wgmma_taps and wgmma_rows (phase_conv.cu), direct
        # (phase_conv_direct.cu), on every path
        "launches_by_variant": by_variant("forward"),
        "max_abs_err": max(err32, l_err32, z_err32),
        "max_abs_err_bf16": max(err16, l_err16, z_err16),
        # per forward at B=8, 640 px: the 8 main-path convs summed; "ms" is
        # the conv alone, "ms_fused" with scale, shift and SiLU as served
        "ms": total("ms"),
        "ms_fused": total("ms_fused"),
        "ms_bf16": total("ms_bf16"),
        "direct_ms": total("direct_ms"),
        "direct_ms_bf16": total("direct_ms_bf16"),
        "library_bf16_ms": total("library_bf16_ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": max(bound, key=bound.get),
        "bound_cuda_core_ms": total("bound_cuda_core_ms"),
        "bound_bf16_ms": total("bound_bf16_ms"),
        "library_ms": total("library_ms"),
        "library_fused_ms": total("library_fused_ms"),
        # the same 8 convs as the training step's forward launches them
        # (B=32, no epilogue)
        "ms_b32": total("ms", train_rows),
        "plain_ms_b32": total("plain_ms", train_rows),
        "bound_ms_b32": total("bound_ms", train_rows),
        "library_ms_b32": total("library_ms", train_rows),
        "ms_bf16_b32": total("ms_bf16", train_rows),
        "bound_bf16_ms_b32": total("bound_bf16_ms", train_rows),
        "library_bf16_ms_b32": total("library_bf16_ms", train_rows),
        "variants": {r["name"]: r["variant"] for r in main_rows},
        "yolox_l": yolox_l(
            l_shapes, ("ms", "ms_fused", "ms_bf16", "plain_ms", "bound_ms",
                       "bound_cuda_core_ms", "bound_bf16_ms", "library_ms",
                       "library_bf16_ms", "library_fused_ms", "direct_ms",
                       "direct_ms_bf16"),
            max_abs_err=l_err32, max_abs_err_bf16=l_err16,
            variants={r["name"]: r["variant"] for r in l_shapes},
            variants_bf16={r["name"]: r["variant_bf16"] for r in l_shapes}),
        "zoo": zoo(z_shapes, ("ms", "ms_fused", "ms_bf16", "plain_ms",
                              "bound_ms", "bound_bf16_ms", "library_ms",
                              "library_bf16_ms", "library_fused_ms",
                              "direct_ms", "direct_ms_bf16"),
                   "variant"),
        # YOLOX-X's stem at 800 px: wgmma_rows in N tiles (fp32), beside
        # direct forced
        "x800_stem": {k: x800[k] for k in (
            "variant", "variant_bf16", "ms", "device_ms", "ms_bf16",
            "device_ms_bf16", "direct_ms", "direct_device_ms",
            "direct_ms_bf16", "plain_ms", "bound_ms", "bound_bf16_ms",
            "library_ms", "library_bf16_ms", "max_abs_err_fp32",
            "max_abs_err_bf16")},
        "card": smi,
    }, small_entry, backward_row("dgrad", "stride 2: parity classes on the tensor cores; "
                    "stride 1: phase_conv.cu's wgmma_taps on flipped "
                    "weights; both after one packing launch"),
        backward_row("wgrad", "tensor cores, split-K partial sums + "
                     "ordered reduction"),
        {
            "name": "phase_conv_pack_taps",
            "route": "cuda",
            "source": "eop_tpu_torch/csrc/phase_conv_backward_tc.cu",
            "replaces": "eop_tpu/ops/pallas/conv_small_c.py:215 (its VJP)",
            "launches": train_launches["pack"],
            "launches_by_path": {k: c["pack"] for k, c in train_paths.items()},
            "max_abs_err": max(r["pack_max_abs_err"]
                               for r in pack_rows + l_pack_rows
                               + z_pack_rows),
            # per training step: the 7 data gradients' packings at B=32
            "batch": TRAIN_BATCH,
            "ms": sum(r["pack_ms"] for r in pack_rows),
            "device_ms": sum(r["pack_device_ms"] for r in pack_rows),
            "plain_ms": sum(r["pack_plain_ms"] for r in pack_rows),
            "bound_ms": sum(r["pack_bound_ms"] for r in pack_rows),
            "bound_by": "bytes",
            "library_ms": None,
            "shapes": len(pack_rows),
            "yolox_l": yolox_l(l_pack_rows, ("pack_ms", "pack_device_ms",
                                             "pack_plain_ms",
                                             "pack_bound_ms")),
            "zoo": zoo(z_pack_rows, ("pack_ms", "pack_device_ms",
                                     "pack_plain_ms", "pack_bound_ms")),
            "card": smi,
        },
    ]})
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-bbox-child"]:
        sys.exit(train_bbox_child(sys.argv[2], sys.argv[4:]))
    if sys.argv[1:2] == ["--dp-child"]:
        sys.exit(dp_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                          sys.argv[5]))
    if sys.argv[1:2] == ["--mp-child"]:
        sys.exit(mp_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--mp-ref-child"]:
        sys.exit(mp_ref_child(sys.argv[2]))
    if sys.argv[1:] == ["--model-parallel"]:
        sys.exit(model_parallel_only())
    if sys.argv[1:2] == ["--grad-noise-child"]:
        sys.exit(grad_noise_child(int(sys.argv[2]), int(sys.argv[3]),
                                  sys.argv[4]))
    if sys.argv[1:] == ["--grad-noise"]:
        sys.exit(grad_noise())
    if sys.argv[1:2] == ["--nccl-probe-child"]:
        sys.exit(nccl_probe_child(int(sys.argv[2]), int(sys.argv[3])))
    if sys.argv[1:2] == ["--show-24p-child"]:
        sys.exit(show_24p_child(sys.argv[2], sys.argv[4:]))
    if sys.argv[1:2] == ["--repeat-serve-bbox"]:
        sys.exit(repeat_serve_bbox(int(sys.argv[2])))
    if sys.argv[1:2] == ["--steps-child"]:
        sys.exit(steps_child(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--compare-steps"]:
        sys.exit(compare_steps(sys.argv[2:]))
    if sys.argv[1:2] == ["--kernel-accuracy-child"]:
        sys.exit(kernel_accuracy_child(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--kernel-accuracy"]:
        sys.exit(kernel_accuracy(sys.argv[2:]))
    if sys.argv[1:] == ["--backbones"]:
        sys.exit(backbones_only())
    sys.exit(probe_worker_exit() if sys.argv[1:] == ["--probe-worker-exit"]
             else main())
