#!/usr/bin/env python3
"""Drive the PyTorch port (edgegan_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository; it needs one CUDA card and no
network. It exits non-zero, printing no result, when there is no card or
the package is missing, and on any failed check.

1. Prints the card's name and power limit (nvidia-smi) and builds the
   hand-written kernels from edgegan_torch/csrc (nvcc, sm_90a, one
   process per source); prints the registers and spills per thread of
   K1's and K2's kernels in each variant (lane groups, blocks, ragged
   groups, multi-pass; a spill fails the run).
2. K1 phase: `instance_norm_act` against its plain PyTorch version on the
   card, at the three shapes the generators give it (batch 16 and 64,
   float32 and bfloat16, no activation / relu / lrelu, one constant plane
   in each input), with the stated limits, each in the lane-group
   variant; its time from CUDA events and its device time per call from
   `torch.profiler` (warm and cold L2) beside its byte bound, the plain
   version's time and F.instance_norm + relu's (a yardstick only: not
   the same function). At batch 64 the multi-pass kernel (one block per
   plane, the earlier design) is timed the same way on the same inputs.
3. K2 phase: `instance_norm_act_bwd` the same way against
   `instance_norm_act_bwd_plain`, and the autograd Function's gradient
   (K1 forward, K2 backward) against autograd of the plain forward. Then
   both kernels in all four variants (lane group, block, ragged group,
   multi-pass) at ragged, generator, large and misaligned planes
   (`ops/in_checks.py`): within the limits, the plain versions within
   them of float64, two runs bitwise equal, launch counts per variant as
   planned; planes holding an inf and a NaN give NaN and inf where the
   plain versions do.
4. K5 phase: `prelu_bwd` against `prelu_bwd_plain` at the classifier's 14
   PReLU shapes at batch 64, float32 and bfloat16, leaks 0.2 and 1.5,
   exact zeros in x: dx within K1's limits, dleak within DLEAK_RTOL of the
   sum of |terms| from a float64 sum on the card. Times per call and per
   training step beside the byte bound, the plain version's and the
   backward of F.prelu's (a yardstick: no tie split, and the same
   function only for 0 <= leak <= 1); and the Function's gradients.
5. K3/K4 phases: the registers and spills per thread of K3's and K4's
   kernels in each variant (none may spill), and for each cluster shape
   the clusters that can be resident at once (at least one);
   `mru_gate_blend` and
   `mru_gate_bwd` against their plain versions at the classifier's four
   gate shapes at batch 64, float32 and bfloat16, a flat plane and ties at
   both extrema in each, in the variant `gate_plan` picks (block for unit
   1, lane groups for units 2-4), two runs bitwise equal
   (`ops/gate_checks.py`); the Function's three gradients against autograd
   of the plain chain; device time per call from the profile (warm and
   cold L2) beside the byte bound, and the multi-pass kernel (the earlier
   design) on the same inputs, checked against the new one first; CUDA
   events and the plain versions' times (no single PyTorch call computes
   either). Then both kernels in every variant (lane group, block,
   cluster, multi-pass) at ragged, unit-sized, hires, large and
   misaligned planes, and on planes holding +inf, NaN and -inf (NaN and
   inf where the plain versions give them).
6. Serving phase at full width: the default test configuration (64x128
   pairs, 14 classes, z_dim 100, gf_dim 64) with random weights from
   `bridge.random_jax_params` through the bridge, a `Batcher` on cuda
   behind `make_server` on 127.0.0.1, answering real HTTP requests. K1
   must have been launched 6 times per batch. One float32 batch is held
   against the port's CPU forward, and the time per batch is measured
   and split by `torch.profiler` into device work and device idle time.
7. Training phase at full width: `python -m edgegan_torch.cli.train`'s
   `main` with the default training configuration (batch 64, 14 classes,
   float32, faithful 7-group step) on a synthetic PNG dataset of two
   batches per epoch, for 2 epochs (4 steps, checkpoints 2 and 5) with
   `--summary_frequency 2`, then again for 1 epoch, which must resume at
   counter 5; then a fresh run of 2 steps with `--dtype bfloat16` and
   both classifier switches on (EDGEGAN_PALLAS_PRELU=1,
   EDGEGAN_PALLAS_GATE=1). Every metric must be finite, every optimizer
   group must move, and the kernels must launch K1 21, K2 12 times per
   step, all in the lane-group variant, and K5 42, K3 12, K4 12 times per
   step with the switches on (K3/K4 split across the variants as
   `gate_plan` sends the four gates), 0 with them off (the default); the
   summaries' sample forward adds K1 6 per `extras` call. The first
   run's TensorBoard event file is parsed (`read_events`: TFRecord
   framing, both masked CRC32Cs of every record, the `Event` protos): 11
   scalar tags at every step and the 14 extras tags at counters 2 and 4;
   then one `extras` call at batch 64 is timed (host clock for the whole
   call, CUDA events for its sample forward).
8. Lifecycle phase, this slice's path at full width through the entry
   points, both classifier switches on: `cli.train` with
   `--update_mode fast --reference_metrics True --update_sn True`, 3
   steps in float32 (the cadence save at counter 2 goes through
   `checkpoint.save_async` and is in place when the run returns), then 2
   steps in bfloat16 resumed from that checkpoint (`resumed_at` 2); every
   metric finite, the classifier's `u` in the checkpoint moved from its
   initial value and float32, and per step K1 24, K2 6, K5 28, K3 12, K4
   8 launches. Then `cli.test` from the checkpoint over a test tree of 14
   class directories and two that must be skipped (class id 14, 'misc'),
   at batch 1 and at --test_batch_size 16 (a padded tail): the files
   written, their widths (W + 2 * W/2), no padded row, K1 6 launches per
   forward, and batch 1's first PNG against the port's CPU forward from
   the same checkpoint and noise (within one byte). Then `serve.main`
   with no --weights, from the checkpoint directory, answering a raw
   batch and a PNG (K1 6 launches per batch).
8a. Evaluate phase: `python -m edgegan_torch.cli.evaluate` at full width
   on the training phase's checkpoint 5, over 256 synthetic 64x128 pairs
   (a split 'eval') at --eval_batch 64, with the pinned extractor
   (docs/fid_extractor.npz, the repository's trained classifier) and the
   in-run one, each with EDGEGAN_PALLAS_GATE off and on: one printed JSON
   line with the JAX script's keys and a finite classifier_fid; K1 6
   launches per generator forward, K3 4 per classifier forward with the
   switch on and 0 off; wall time and images per second. Before it the
   native PNG loader is built or reported unavailable (`native_loader:
   built | unavailable (...)`) and, built, its decode of 64 of the PNGs
   is held to the PIL path's pixels bit for bit; after it the pinned
   extractor's features of one batch on the card are held to the port's
   CPU forward (1e-3 of the largest |feature|), and with the gate switch
   on to off (K3's float32 limit).
8b. TF importer: `convert.export_tf_npz` -> `import_tf_npz` of the default
   14-class trees bit-exact, and G2's forward on the card from the
   imported trees bitwise equal to the forward from the originals.
9. One training step at full width and batch 4 on the card against the
   same step on the CPU, from the same weights and random draws; and a
   second card step with both switches on, against the same CPU step.
10. Time per training step at batch 64 (CUDA events and host clock, peak
   memory) in float32 and bfloat16, switches off and on (in turns: off,
   on, on, off), for the faithful step and again for the fast step;
   device time per optimizer group and the `torch.profiler` split for
   each setting, with each kernel's device time per step (not measured
   where the profile recorded fewer of its kernels than were launched);
   the launches per profiled step, by variant, must be as planned
   (`expected_launches`: faithful K1 21, K2 12, K5 42, K3 12, K4 12;
   fast K1 12, K2 6, K5 28, K3 8, K4 8; K5, K3 and K4 with the switches
   on only).
11. Variants phase: the resnet generator, the resnet critics, the convnet
   encoder and batch norm inside G's, D's and E's blocks, each alone at
   full width: one step at batch 4 on the card against the CPU step
   (within 3x the step's own sensitivity, measured on both devices), the
   faithful float32 step at batch 64 timed (CUDA events over 5 steps
   after a warm-up, peak memory) with its K1/K2 launches per variant as
   `expected_launches` plans them. For the convnet encoder, K1 and K2 on
   its six normed blocks' planes at batch 64 (the 1x1 and, in bfloat16,
   2x2 planes in ragged groups) held to their plain versions and timed
   per call beside the multi-pass kernel (the earlier design) and
   F.instance_norm+relu, then 2 CLI steps, a resume and one `cli.test`
   forward from the checkpoint (K1 12 launches).
12. Hires phase: 128x256 pairs (BASELINE config 5) at batch 64, faithful,
   both switches on: 2 CLI steps in float32 on synthetic pairs (launches
   as planned: g_dconv_3's 64x64 planes in K1/K2's block variant, MRU
   unit 1's 128x128 gate in K3/K4's cluster variant), the step timed
   in float32 and bfloat16 with peak memory, and K1/K2 at [64, 64, 64,
   64] (beside the multi-pass kernel and F.instance_norm+relu) and K3/K4
   at [64, 8, 128, 128] held to their plain versions (two runs bitwise
   equal) and timed per call beside their bounds and the multi-pass
   kernel (the earlier design) on the same inputs; K5 at the 9 hires
   PReLU shapes held and timed per call, and summed over a step's 42
   calls.
13. Parallel phase (data parallelism, `edgegan_torch.parallel`) at the
   default configuration: `cli.train` under `torchrun --standalone
   --nproc_per_node 1` (one rank over NCCL) for 3 steps and a resume;
   the batch-64 faithful float32 step, switches off and on, under
   torchrun at 1 rank (NCCL) and at 2 ranks sharing the card over gloo
   (EDGEGAN_RANKS_PER_CARD=2; this script's `--parallel-worker` mode):
   the ranks' parameters bitwise equal, the step held to this process's
   one-process card step within 3x its own sensitivity, K1/K2 (K5, K3,
   K4) launches per rank as planned, its time per step beside the
   one-process step's; `cli.test --test_batch_size 16` at 2 ranks against
   one process (the same files, PNGs within 1 byte); `serve` at 2 ranks
   (max_batch 16, float32): /healthz's world size, a raw request held to
   a one-process Batcher within 1e-3, the time per request of 16 beside
   one process's, and both ranks gone after SIGINT to rank 0.
13a. Quality phase (run last), the toolchain around a run at the
   recipe's width (14 classes, 64x128 pairs, batch 64, float32): a
   genshapes tree staged
   by `data/genshapes.py` (seed 11, 16 train / 4 test pairs a class, cut
   from the recipe's 1006 / 24 for time; Pillow's version and three
   files' hashes printed, not required to equal another machine's);
   `cli.train_extractor` for 30 steps with both classifier switches on,
   then 5 with them off: the loss finite and lower over the last 5 steps
   than over the first 5, launches K5 14, K3 4, K4 4 per step and K3 4
   per held-out forward with the switches, none without; the npz and its
   sidecar written, their features of 64 photos through
   `evaluation.pinned_extractor` on the card within 1e-3 of the largest
   |feature| of the CPU's; the step timed by CUDA events, switches off
   and on in turns. Then `cli.fid_curve` with that npz, the gate switch
   on, over the train phase's retained checkpoints (two random states
   when it did not run), --limit 64: one row per retained step, the last
   point's FID equal to `cli.evaluate`'s at that step within rtol 1e-6,
   K1 6 per generator forward, K3 4 per classifier forward.
14. Prints one JSON line describing every kernel, then
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

`python3 chip_smoke.py --only NAME[,NAME]` runs those phases alone (after
the build) and prints no result.
"""
from __future__ import annotations

import contextlib
import http.client
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

_IMPORTED = time.perf_counter()

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
SERVE_SHAPES = [(256, 8, 8), (128, 16, 16), (64, 32, 32)]  # g_dconv_1..3
ACTS = (None, 'relu', 'lrelu')
K1_OPS_PER_ELEMENT = 8      # sum, sub, square, add, sub, div, act, cast
# sum; sub, square, add; sub, div, act', add, mul-add; sub, div, act',
# sub, div, mul, sub, cast
K2_OPS_PER_ELEMENT = 17
TOL = {'float32': dict(atol=2e-5, rtol=0.0),     # sums in another order
       'bfloat16': dict(atol=2e-2, rtol=2e-2)}   # output rounded to 8 bits
# K2: dx = (g' - mean g')/d - y*mean(g'y)/s divides by d = sqrt(var)+1e-5
# (by 1e-5 on a constant plane, values ~1e5), so float32 gets a relative
# term; bfloat16 rounds dx to 8 bits
K2_TOL = {'float32': dict(atol=1e-4, rtol=1e-4),
          'bfloat16': dict(atol=2e-2, rtol=2e-2)}
# Where |y_pre| < GATE_BAND the sign of y_pre, and with it relu's and
# lrelu's slope, is decided by the rounding of the plane's mean: there the
# kernel and the plain version may each take either slope, so those
# elements are left out of the comparison (and counted).
GATE_BAND = 1e-4
PROFILED_STEPS = 2
# the turns of the switches in the step-time phases
STEP_TURNS = (False, True, True, False)
K1_PER_STEP = 21   # 7 generator forwards (G1 alone for the encoder's input)
K2_PER_STEP = 12   # 2 generator updates x (G1, G2) x 3 DeconvBlocks
# The classifier at batch 64 on the 64x64 photo half, (C, H, W) with the
# number of calls per pass: its 14 PReLUs (the stem's; per MRU unit the
# hidden state's, the merge's and h_conv1's; the last) and its 4 MRU gates
PRELU_SHAPES = [((8, 64, 64), 3), ((128, 64, 64), 1), ((128, 32, 32), 2),
                ((256, 32, 32), 1), ((256, 16, 16), 2), ((512, 16, 16), 1),
                ((512, 8, 8), 2), ((768, 8, 8), 1), ((768, 4, 4), 1)]
GATE_SHAPES = [(8, 64, 64), (128, 32, 32), (256, 16, 16), (512, 8, 8)]
CLASSIFIER_PASSES = 3   # per step: group 4 and both generator updates
K5_PER_STEP = 14 * CLASSIFIER_PASSES
K3_PER_STEP = K4_PER_STEP = 4 * CLASSIFIER_PASSES
# per step of each kind: generator forwards and backwards (K1 and K2 on
# each instance-normed DeconvBlock of the convnet generator), encoder
# forwards and backwards (K1 and K2 on each instance-normed block of the
# convnet encoder; the encoder's update), classifier forwards (K3: 4 each)
# and backwards (K4: 4, K5: 14 each). The faithful step: the critics'
# fakes, two updates of both generators and G1 alone for the encoder's
# input. The fast step runs one generator update and gives the encoder
# the step-start fake; reference_metrics adds a generator forward and the
# generators' losses (one classifier forward) without a gradient;
# update_sn runs no forward. The extractor's step (cli.train_extractor)
# is one classifier forward and backward.
STEP_KINDS = {'faithful': (7, 4, 1, 1, 3, 3),
              'fast': (4, 2, 1, 1, 2, 2),
              'fast, reference_metrics, update_sn': (8, 2, 1, 1, 3, 2),
              # the pinned extractor's trainer: the classifier alone
              'extractor': (0, 0, 0, 0, 1, 1)}
# float32 operations per element: K5 mul, 2 compares, select, fma, mul,
# mul, add; K3 min, max, sub, div, mul, add; K4 min, max, then sub, div,
# mul, mul, sub, 2 mul-adds, add, 2 compares, 2 adds, then mul, div,
# 2 compares, 2 adds
K5_OPS_PER_ELEMENT = 8
K3_OPS_PER_ELEMENT = 6
K4_OPS_PER_ELEMENT = 22
# K5's dleak is a float32 sum of up to 33.5M terms in a fixed tree (about
# 124 terms per thread, then warp, block and partial sums): held to a
# float64 sum within DLEAK_RTOL of the sum of |terms|
DLEAK_RTOL = 1e-5
SWITCHES = ('EDGEGAN_PALLAS_PRELU', 'EDGEGAN_PALLAS_GATE')


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'check failed: {msg}')


# K1's to K4's multi-pass kernels (the earlier design): no plane of a path
# this script drives reaches them, now that blocks hold the hires
# generator's planes, ragged groups the convnet encoder's 1x1 and 2x2
# planes and clusters the hires unit 1's gate
MULTI_PASS = ('instance_norm_act.multi_pass',
              'instance_norm_act_bwd.multi_pass',
              'mru_gate_blend.multi_pass', 'mru_gate_bwd.multi_pass')


def check_launches(label: str, counts, want):
    """`kernels.LAUNCHES` after a driven run (`counts`) as planned
    (`want`), and K1's to K4's multi-pass launches 0 there."""
    check(counts == want, f'{label}: launches {counts}, expected {want}')
    check(all(counts.get(k, 0) == 0 for k in MULTI_PASS),
          f'{label}: multi-pass launches '
          f'{[counts.get(k) for k in MULTI_PASS]}')


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '-i', '0', '--query-gpu=name,'
                          'power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f'nvidia-smi failed: {out.stderr}')
    return out.stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of `fn()` over `iters` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, match: str, inputs, n: int = 30, windows: int = 3):
    """Device time per call, in µs, of the kernels whose names hold
    `match`, from `torch.profiler` over `n` calls of `fn(*inputs[0])`
    (warm: the same tensors every call, in L2 after the first) and over
    `n` calls that rotate through `inputs` (cold: together larger than
    the 50 MB L2). Returns (warm, cold), each None (not measured) where
    no kernel was recorded. CUDA events over back-to-back calls measure
    the wrapper's host time at these sizes instead. The profiler at times
    drops kernel records of a window (seen: 14 and 0 of 30), so up to
    `windows` windows are profiled until n kernels are recorded; the mean
    is over those recorded, and a shortfall is printed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = []
    for rotate in (False, True):
        spans = []
        for _ in range(windows):
            fn(*inputs[0])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(n):
                    fn(*inputs[i % len(inputs) if rotate else 0])
                torch.cuda.synchronize()
            spans += [e.time_range.end - e.time_range.start
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA and match in e.name]
            if len(spans) >= n:
                break
        if len(spans) < n:
            print(f'  profile recorded {len(spans)} {match} kernels in '
                  f'{windows} windows of {n} calls '
                  f'({"cold" if rotate else "warm"})'
                  + ('; mean over those' if spans else ': not measured'))
        out.append(sum(spans) / len(spans) if spans else None)
    return tuple(out)


def _us(v) -> str:
    return 'not measured' if v is None else f'{v:.2f} us'


def _add(a, b):
    """a + b, or None (not measured) where either is None."""
    return None if a is None or b is None else a + b


def _ms(us):
    """µs in ms; None (not measured) stays None."""
    return None if us is None else us / 1e3


def _f4(v) -> str:
    return 'not measured' if v is None else f'{v:.4f}'


def cold_copies(make, nbytes: int):
    """Enough tensor tuples from `make()` to hold over 120 MB together
    (at least 2), so that a rotation through them misses the L2."""
    return [make() for _ in range(max(2, -(-120 * 2 ** 20 // nbytes)))]


def multi_pass(entry, x, *tensors):
    """One launch of K1's or K2's multi-pass kernel (`entry`, variant 0:
    one block per plane, the earlier design) with relu on contiguous
    CUDA `x` and the other tensors of its shape, outputs last. Only for
    timing it beside the variant the plan picks: not counted in
    `LAUNCHES`."""
    from edgegan_torch.ops import kernels
    b, c, h, w = x.shape
    err = entry(x.data_ptr(), *(t.data_ptr() for t in tensors), b * c,
                h * w, kernels._DTYPES[x.dtype], kernels._ACTS['relu'],
                kernels.IN_VARIANTS['multi_pass'], kernels.IN_THREADS, 0,
                kernels._stream(x))
    check(err == 0, f'multi-pass launch failed: CUDA error {err}')
    return tensors[-1]


def k1_bounds_ms(shape, dtype):
    """(bytes, operations) lower bounds of one K1 call: each input element
    read once and each output written once, over the memory rate; its
    float32 arithmetic over the card's float32 rate."""
    import torch
    n = 1
    for d in shape:
        n *= d
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (1e3 * 2 * n * itemsize / HBM_BYTES_PER_S,
            1e3 * K1_OPS_PER_ELEMENT * n / F32_OPS_PER_S)


def in_registers(card: str):
    """Registers and local memory (spill) bytes per thread of K1's and
    K2's kernels as built (cudaFuncGetAttributes, the numbers
    `nvcc -Xptxas -v` prints), relu, in every (variant, lanes, vectors)
    that `instance_norm_plan` can pick: the lane groups, the blocks (up to
    their largest plane, 4096 float32 or 8192 bfloat16 elements), the
    ragged groups (up to 256 elements) and the multi-pass kernel; fails on
    local memory. Returns {'K1 float32 block 256x4': (regs, local
    bytes), ...}."""
    import ctypes

    import torch

    from edgegan_torch.ops import _build, kernels
    lib = _build.library()
    out = (ctypes.c_int * 2)()
    table = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        per_vector = 16 // dtype.itemsize
        reach = kernels.IN_THREADS * kernels.BLOCK_VECTORS * per_vector
        plans = sorted({kernels.instance_norm_plan(hw, dtype, addr)
                        for hw in range(1, reach + per_vector + 1)
                        for addr in (0, dtype.itemsize)})
        for variant, lanes, vectors in plans:
            for bwd, kname in ((0, 'K1'), (1, 'K2')):
                err = lib.edgegan_instance_norm_act_attrs(
                    bwd, kernels._DTYPES[dtype], 1,
                    kernels.IN_VARIANTS[variant], lanes, vectors, out)
                check(err == 0, f'{kname} {variant} attributes: error {err}')
                key = f'{kname} {dname} {variant} {lanes}x{vectors}'
                table[key] = (out[0], out[1])
                print(f'{key}: {out[0]} registers per thread, {out[1]} bytes '
                      f'of local memory (spills) [{card}]')
    spills = {k: v for k, v in table.items() if v[1]}
    check(not spills, f'K1/K2 kernels spill: {spills}')
    return table


def previous_design_us(name, entry, x, *tensors):
    """Device time per call (warm, cold L2), in µs, of K1's or K2's
    multi-pass kernel at x's shape, with relu, after checking its output
    against the planned variant's (lane group, block or ragged group) on
    the same inputs (`tensors`: the inputs after x; the output is made
    here)."""
    import torch

    from edgegan_torch.ops import kernels
    fn = (kernels.instance_norm_act if name == 'instance_norm_act_fwd'
          else kernels.instance_norm_act_bwd)
    got = multi_pass(entry, x, *tensors, torch.empty_like(x))
    want = fn(x, *tensors, 'relu')
    dname = str(x.dtype).split('.')[-1]
    tol = TOL[dname] if name == 'instance_norm_act_fwd' else K2_TOL[dname]
    band = kernels.instance_norm_act_plain(x, None).float().abs() < GATE_BAND
    err, ok, _ = _close(got, want, tol, band)
    check(ok, f'{name} multi-pass differs from the planned variant by '
              f'{err:.3g}')
    return device_us(
        lambda *t: multi_pass(entry, *t), name, cold_copies(
            lambda: (x.clone(),) + tuple(t.clone() for t in tensors)
            + (torch.empty_like(x),),
            (2 + len(tensors)) * x.numel() * x.element_size()))


def kernel_phase(card: str):
    """K1 against its plain version at the serving shapes; returns the
    numbers for the JSON line."""
    import torch
    import torch.nn.functional as F

    from edgegan_torch.ops import _build, kernels
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {'float32': 0.0, 'bfloat16': 0.0}
    per_batch = {}  # (batch, dtype) -> summed ms over the three shapes
    # dtype -> device µs (warm, cold) of the multi-pass kernel at batch 64,
    # summed over the three shapes
    previous = {}
    for batch in (16, 64):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split('.')[-1]
            sums = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                        library_ms=0.0, device_ms=0.0, cold_ms=0.0)
            for c, h, w in SERVE_SHAPES:
                shape = (batch, c, h, w)
                x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5
                     ).to(dtype)
                x[0, 0] = 3.0   # a constant plane: var == 0 exactly
                for act in (None, 'relu', 'lrelu'):
                    y = kernels.instance_norm_act(x, act)
                    ref = kernels.instance_norm_act_plain(x, act)
                    torch.cuda.synchronize()
                    diff = (y.float() - ref.float()).abs()
                    err = diff.max().item()
                    tol = TOL[dname]
                    ok = bool((diff <= tol['atol'] + tol['rtol']
                               * ref.float().abs()).all())
                    print(f'K1 {dname} {list(shape)} act={act}: max abs '
                          f'diff {err:.3g} (limit atol {tol["atol"]} rtol '
                          f'{tol["rtol"]})')
                    check(ok, f'K1 {dname} {shape} {act} differs from plain')
                    check(bool((y[0, 0] == 0).all()),
                          'K1 constant plane is not 0')
                    max_err[dname] = max(max_err[dname], err)
                plan = kernels.instance_norm_plan(h * w, dtype, x.data_ptr())
                check(plan[0] == 'lane_group', f'K1 {shape} {dname}: {plan}')
                ms = cuda_ms(lambda: kernels.instance_norm_act(x, 'relu'),
                             200)
                warm_us, cold_us = device_us(
                    lambda t: kernels.instance_norm_act(t, 'relu'),
                    'instance_norm_act_fwd',
                    cold_copies(lambda: (x.clone(),),
                                2 * x.numel() * x.element_size()))
                plain = cuda_ms(
                    lambda: kernels.instance_norm_act_plain(x, 'relu'), 50)
                lib = cuda_ms(lambda: F.relu(F.instance_norm(x)), 200)
                by_bytes, by_ops = k1_bounds_ms(shape, dtype)
                if batch == 64:
                    mp = previous_design_us(
                        'instance_norm_act_fwd',
                        _build.library().edgegan_instance_norm_act_fwd, x)
                    previous[dname] = tuple(
                        _add(a, b) for a, b in zip(
                            previous.get(dname, (0, 0)), mp))
                    print(f'K1 multi-pass (one block per plane) {dname} '
                          f'{list(shape)} relu: device {_us(mp[0])} warm / '
                          f'{_us(mp[1])} cold L2 (profile) [{card}]')
                print(f'K1 time {dname} {list(shape)} relu, {plan[0]} '
                      f'{plan[1]}x{plan[2]}: {ms:.4f} ms (CUDA events), '
                      f'device {_us(warm_us)} warm / {_us(cold_us)} cold '
                      f'L2 (profile), bound {max(by_bytes, by_ops):.4f} ms '
                      f'(bytes {by_bytes:.4f}, operations {by_ops:.4f}), '
                      f'plain {plain:.4f} ms, F.instance_norm+relu {lib:.4f} '
                      f'ms (not the same function: eps is inside the sqrt) '
                      f'[{card}]')
                for k, v in zip(('ms', 'plain_ms', 'bytes_ms', 'ops_ms',
                                 'library_ms', 'device_ms', 'cold_ms'),
                                (ms, plain, by_bytes, by_ops, lib,
                                 _ms(warm_us), _ms(cold_us))):
                    sums[k] = _add(sums[k], v)
            per_batch[(batch, dname)] = sums
            print(f'K1 per generator (3 launches) at batch {batch} {dname}: '
                  + ', '.join(f'{k} {_f4(v)}' for k, v in sums.items())
                  + f' [{card}]')
    return max_err, per_batch, previous


def _close(got, ref, tol, skip=None):
    """(max abs difference, all within tol, elements skipped) of got
    against ref, leaving out the elements where `skip` is set."""
    import torch
    diff = (got.float() - ref.float()).abs()
    ok = diff <= tol['atol'] + tol['rtol'] * ref.float().abs()
    n_skip = 0
    if skip is not None:
        ok |= skip
        diff = torch.where(skip, torch.zeros_like(diff), diff)
        n_skip = int(skip.sum().item())
    return diff.max().item(), bool(ok.all()), n_skip


def k2_bounds_ms(shape, dtype):
    """(bytes, operations) lower bounds of one K2 call: x and g read once,
    dx written once; its float32 arithmetic over the float32 rate."""
    bytes_ms, _ = k1_bounds_ms(shape, dtype)
    n = 1
    for d in shape:
        n *= d
    return 1.5 * bytes_ms, 1e3 * K2_OPS_PER_ELEMENT * n / F32_OPS_PER_S


def k2_phase(card: str):
    """K2 against its plain version at the training shapes, and the
    autograd Function (K1 forward, K2 backward) against autograd of the
    plain forward; returns the numbers for the JSON line."""
    import torch
    import torch.nn.functional as F

    from edgegan_torch.ops import _build, kernels
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = {'float32': 0.0, 'bfloat16': 0.0}
    per_batch, previous = {}, {}
    for batch in (16, 64):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split('.')[-1]
            tol = K2_TOL[dname]
            sums = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                        yardstick_ms=0.0, device_ms=0.0, cold_ms=0.0)
            for c, h, w in SERVE_SHAPES:
                shape = (batch, c, h, w)
                x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5
                     ).to(dtype)
                x[0, 0] = 3.0   # a constant plane: var == 0 exactly
                g = torch.randn(shape, device=dev, generator=gen).to(dtype)
                y_pre = kernels.instance_norm_act_plain(x, None).float()
                band = y_pre.abs() < GATE_BAND
                for act in ACTS:
                    dx = kernels.instance_norm_act_bwd(x, g, act)
                    ref = kernels.instance_norm_act_bwd_plain(x, g, act)
                    torch.cuda.synchronize()
                    err, ok, n_skip = _close(dx, ref, tol,
                                             band if act else None)
                    print(f'K2 {dname} {list(shape)} act={act}: max abs '
                          f'diff {err:.3g} (limit atol {tol["atol"]} rtol '
                          f'{tol["rtol"]}; {n_skip} elements in the '
                          f'|y_pre| < {GATE_BAND} band left out)')
                    check(ok, f'K2 {dname} {shape} {act} differs from plain')
                    check(bool(torch.isfinite(dx.float()).all()),
                          f'K2 {dname} {shape} {act} not finite')
                    max_err[dname] = max(max_err[dname], err)
                plan = kernels.instance_norm_plan(
                    h * w, dtype, x.data_ptr() | g.data_ptr())
                check(plan[0] == 'lane_group', f'K2 {shape} {dname}: {plan}')
                ms = cuda_ms(lambda: kernels.instance_norm_act_bwd(
                    x, g, 'relu'), 200)
                warm_us, cold_us = device_us(
                    lambda a, b: kernels.instance_norm_act_bwd(a, b, 'relu'),
                    'instance_norm_act_bwd', cold_copies(
                        lambda: (x.clone(), g.clone()),
                        3 * x.numel() * x.element_size()))
                plain = cuda_ms(lambda: kernels.instance_norm_act_bwd_plain(
                    x, g, 'relu'), 50)
                xr = x.detach().requires_grad_(True)
                yr = F.relu(F.instance_norm(xr))
                yard = cuda_ms(lambda: torch.autograd.grad(
                    yr, xr, g, retain_graph=True), 200)
                by_bytes, by_ops = k2_bounds_ms(shape, dtype)
                if batch == 64:
                    mp = previous_design_us(
                        'instance_norm_act_bwd',
                        _build.library().edgegan_instance_norm_act_bwd, x, g)
                    previous[dname] = tuple(
                        _add(a, b) for a, b in zip(
                            previous.get(dname, (0, 0)), mp))
                    print(f'K2 multi-pass (one block per plane) {dname} '
                          f'{list(shape)} relu: device {_us(mp[0])} warm / '
                          f'{_us(mp[1])} cold L2 (profile) [{card}]')
                print(f'K2 time {dname} {list(shape)} relu, {plan[0]} '
                      f'{plan[1]}x{plan[2]}: {ms:.4f} ms (CUDA events), '
                      f'device {_us(warm_us)} warm / {_us(cold_us)} cold '
                      f'L2 (profile), bound {max(by_bytes, by_ops):.4f} ms '
                      f'(bytes {by_bytes:.4f}, operations {by_ops:.4f}), '
                      f'plain {plain:.4f} ms, backward of '
                      f'F.instance_norm+relu {yard:.4f} ms (a yardstick, not '
                      f'the same function: eps is inside the sqrt) [{card}]')
                for k, v in zip(('ms', 'plain_ms', 'bytes_ms', 'ops_ms',
                                 'yardstick_ms', 'device_ms', 'cold_ms'),
                                (ms, plain, by_bytes, by_ops, yard,
                                 _ms(warm_us), _ms(cold_us))):
                    sums[k] = _add(sums[k], v)
            per_batch[(batch, dname)] = sums
            print(f'K2 per generator backward (3 launches) at batch {batch} '
                  f'{dname}: ' + ', '.join(f'{k} {_f4(v)}'
                                           for k, v in sums.items())
                  + f' [{card}]')

    # the Function: K1 forward and K2 backward, one launch each, against
    # autograd of the plain forward
    shape = (64,) + SERVE_SHAPES[2]
    x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5)
    x[0, 0] = 3.0
    x.requires_grad_(True)
    g = torch.randn(shape, device=dev, generator=gen)
    band = kernels.instance_norm_act_plain(x.detach(), None).abs() < GATE_BAND
    before = dict(kernels.LAUNCHES)
    dx, = torch.autograd.grad(kernels.instance_norm_act(x, 'relu'), x, g)
    torch.cuda.synchronize()
    check(kernels.LAUNCHES['instance_norm_act']
          == before['instance_norm_act'] + 1
          and kernels.LAUNCHES['instance_norm_act_bwd']
          == before['instance_norm_act_bwd'] + 1,
          'the Function did not launch K1 and K2 once each')
    ref, = torch.autograd.grad(kernels.instance_norm_act_plain(x, 'relu'),
                               x, g)
    err, ok, n_skip = _close(dx, ref, K2_TOL['float32'], band)
    print(f'Function (K1 forward, K2 backward) float32 {list(shape)} relu: '
          f'gradient vs autograd of the plain forward, max abs diff '
          f'{err:.3g} (limit atol 1e-4 rtol 1e-4; {n_skip} elements in the '
          f'band left out)')
    check(ok, 'the Function gradient differs from autograd of the plain '
              'forward')
    return max_err, per_batch, previous


def in_variants_phase(card: str):
    """K1 and K2 in all four variants against their plain versions, within
    TOL and K2_TOL, by `in_checks.check_kernels`: the plane sizes of
    `in_checks.EDGE_PLANES`, 37 planes with plane 0 constant, float32 and
    bfloat16, three activations; contiguous inputs at a storage offset of
    one element (off 16 bytes), an 8x8 plane (a ragged group) and a 64x64
    one (the multi-pass kernel); and at each plane size, planes holding an
    inf and a NaN held element by element to the plain versions
    (`in_checks.check_nonfinite`). Returns the largest differences."""
    import torch

    from edgegan_torch.ops import in_checks, kernels
    dev = torch.device('cuda')
    max_err = {'K1': 0.0, 'K2': 0.0}
    seen = set()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        for hw in in_checks.EDGE_PLANES:
            x, g = in_checks.edge_inputs(dev, hw, dtype, seed=4)
            xn = in_checks.with_nonfinite(x)
            cases = [(x, g, xn, f'{dname} {list(x.shape)}')]
            if hw in ((8, 8), (64, 64)):
                cases.append((in_checks.shifted(x), in_checks.shifted(g),
                              in_checks.shifted(xn), f'{dname} '
                              f'{list(x.shape)} at a storage offset of 1'))
            for xc, gc, xnc, label in cases:
                want = kernels.instance_norm_plan(
                    hw[0] * hw[1], dtype, xc.data_ptr() | gc.data_ptr())[0]
                seen.add(want)
                e1, e2 = in_checks.check_kernels(
                    xc, gc, TOL[dname], K2_TOL[dname], want, label=label)
                max_err['K1'] = max(max_err['K1'], e1)
                max_err['K2'] = max(max_err['K2'], e2)
                in_checks.check_nonfinite(xnc, gc, TOL[dname],
                                          K2_TOL[dname], want, label=label)
                print(f'{label} ({want}): K1 and K2 within the limits, the '
                      f'plain versions within them of float64, three '
                      f'activations, two runs bitwise equal; with an inf and '
                      f'a NaN plane, NaN and inf where the plain versions '
                      f'give them [{card}]')
    # every variant of K1/K2's plan (the cluster is K3/K4's alone)
    check(seen == set(kernels.IN_VARIANTS) - {'cluster'},
          f'variants reached: {seen}')
    print(f'K1/K2 variants: max abs diff K1 {max_err["K1"]:.3g}, K2 '
          f'{max_err["K2"]:.3g} [{card}]')
    return max_err


@contextlib.contextmanager
def classifier_switches(on: bool, names=SWITCHES):
    """The classifier switches `names` (both by default) set to 1 (on) or
    unset (off, the default), restored afterwards."""
    saved = {k: os.environ.get(k) for k in names}
    for k in names:
        if on:
            os.environ[k] = '1'
        else:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bounds_ms(n: int, itemsize: int, tensors: int, ops_per_element: int):
    """(bytes, operations) lower bounds of a call over `n` elements that
    reads or writes `tensors` tensors of `itemsize` bytes once each and
    does `ops_per_element` float32 operations per element."""
    return (1e3 * tensors * n * itemsize / HBM_BYTES_PER_S,
            1e3 * ops_per_element * n / F32_OPS_PER_S)


def _dleak64(x, g, leak):
    """K5's dleak from a float64 sum on the card, and the sum of the
    terms' magnitudes (its scale)."""
    import torch
    x64, g64 = x.double(), g.double()
    u = leak.double() * x64
    s_u = torch.where(u > x64, 1.0, torch.where(u == x64, 0.5, 0.0))
    terms = g64 * s_u.double() * x64
    return terms.sum().item(), terms.abs().sum().item()


TIME_KEYS = ('ms', 'plain_ms', 'bytes_ms', 'ops_ms', 'yardstick_ms')


def k5_phase(card: str):
    """K5 against its plain version at the classifier's PReLU shapes, and
    the Function's gradients against autograd of the plain forward;
    returns the numbers for the JSON line (times per training step)."""
    import torch
    import torch.nn.functional as F

    from edgegan_torch.ops import kernels
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(5)
    max_err = {'float32': 0.0, 'bfloat16': 0.0}
    dleak_err = 0.0
    per_step = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        tol = TOL[dname]
        sums = dict.fromkeys(TIME_KEYS, 0.0)
        for (c, h, w), calls in PRELU_SHAPES:
            shape = (64, c, h, w)
            x = (torch.randn(shape, device=dev, generator=gen) * 2).to(dtype)
            x[:, :, 0, :] = 0.0   # exact zeros: the tie leak*x == x
            g = torch.randn(shape, device=dev, generator=gen).to(dtype)
            for leak in (0.2, 1.5):
                lk = torch.tensor(leak, device=dev)
                dx, dleak = kernels.prelu_bwd(x, g, lk)
                ref, _ = kernels.prelu_bwd_plain(x, g, lk)
                d64, scale = _dleak64(x, g, lk)
                torch.cuda.synchronize()
                err, ok, _ = _close(dx, ref, tol)
                derr = abs(dleak.item() - d64) / scale
                print(f'K5 {dname} {list(shape)} leak {leak}: dx max abs '
                      f'diff {err:.3g} (limit atol {tol["atol"]} rtol '
                      f'{tol["rtol"]}); dleak {dleak.item():.7g} vs float64 '
                      f'{d64:.7g}, diff {derr:.3g} of sum|terms| (limit '
                      f'{DLEAK_RTOL})')
                check(ok, f'K5 {dname} {shape} leak {leak}: dx differs')
                check(derr <= DLEAK_RTOL, f'K5 {dname} {shape} leak {leak}: '
                      'dleak differs')
                max_err[dname] = max(max_err[dname], err)
                dleak_err = max(dleak_err, derr)
            lk = torch.tensor(0.2, device=dev)
            ms = cuda_ms(lambda: kernels.prelu_bwd(x, g, lk), 50)
            plain = cuda_ms(lambda: kernels.prelu_bwd_plain(x, g, lk), 10)
            xr = x.detach().requires_grad_(True)
            wr = lk.to(dtype).reshape(1).requires_grad_(True)
            yr = F.prelu(xr, wr)
            yard = cuda_ms(lambda: torch.autograd.grad(
                yr, (xr, wr), g, retain_graph=True), 20)
            by_bytes, by_ops = bounds_ms(x.numel(), x.element_size(), 3,
                                         K5_OPS_PER_ELEMENT)
            print(f'K5 time {dname} {list(shape)}: {ms:.4f} ms, bound '
                  f'{max(by_bytes, by_ops):.4f} ms (bytes {by_bytes:.4f}, '
                  f'operations {by_ops:.4f}), plain {plain:.4f} ms, '
                  f'backward of F.prelu {yard:.4f} ms (a yardstick: no tie '
                  f'split) x {calls} calls per pass [{card}]')
            for k, v in zip(TIME_KEYS, (ms, plain, by_bytes, by_ops, yard)):
                sums[k] += calls * v
        per_step[dname] = {k: CLASSIFIER_PASSES * v for k, v in sums.items()}
        print(f'K5 per training step ({K5_PER_STEP} calls) at batch 64 '
              f'{dname}: ' + ', '.join(f'{k} {v:.4f}' for k, v in
                                        per_step[dname].items())
              + f' [{card}]')

    # the Function: plain forward, K5 backward, against autograd of the
    # plain forward
    shape = (64, 128, 32, 32)
    x = torch.randn(shape, device=dev, generator=gen)
    x[:, :, 0, :] = 0.0
    x.requires_grad_(True)
    lk = torch.tensor(0.2, device=dev, requires_grad=True)
    g = torch.randn(shape, device=dev, generator=gen)
    before = kernels.LAUNCHES['prelu_bwd']
    dx, dleak = torch.autograd.grad(kernels.prelu(x, lk), (x, lk), g)
    torch.cuda.synchronize()
    check(kernels.LAUNCHES['prelu_bwd'] == before + 1,
          'the PReLU Function did not launch K5 once')
    ref, rleak = torch.autograd.grad(torch.maximum(lk * x, x), (x, lk), g)
    _, scale = _dleak64(x.detach(), g, lk.detach())
    err, ok, _ = _close(dx, ref, TOL['float32'])
    derr = abs(dleak.item() - rleak.item()) / scale
    print(f'Function (K5 backward) float32 {list(shape)}: dx vs autograd of '
          f'the plain forward max abs diff {err:.3g}, dleak diff {derr:.3g} '
          f'of sum|terms| (limit {2 * DLEAK_RTOL}: two float32 sums)')
    check(ok and derr <= 2 * DLEAK_RTOL, 'the PReLU Function gradient '
          'differs from autograd of the plain forward')
    return max_err, dleak_err, per_step


def _halvings(n: int, times: int):
    """n, ceil(n/2), ... (`times` halvings): the sizes down a chain of
    stride-2 layers."""
    out = [n]
    for _ in range(times):
        out.append(-(-out[-1] // 2))
    return out


def in_planes(config):
    """(generator planes, encoder planes): the (C, H, W) of each plane set
    that K1 (and K2) normalise in one forward of one generator and of the
    encoder of `config`: the convnet generator's three instance-normed
    DeconvBlocks (g_dconv_1..3) and the convnet encoder's six (seven at
    image size 256) instance-normed ConvBlocks; none in the resnet
    variants (their norms take the plain path) or with batch norm. At the
    default 64x128 pairs: G 256x8x8, 128x16x16, 64x32x32; E 128x16x16,
    256x8x8, 512x4x4, 512x2x2, 512x1x1, 512x1x1."""
    h, w = config.output_height, config.output_width // 2
    gen, enc = [], []
    if not config.if_resnet_g and config.G_norm == 'instance':
        hs, ws = _halvings(h, 4), _halvings(w, 4)
        gen = [(512 // 2 ** i, hs[4 - i], ws[4 - i]) for i in range(1, 4)]
    if not config.if_resnet_e and config.E_norm == 'instance':
        filters = [64, 128, 256, 512, 512, 512, 512] + (
            [512] if config.input_height == 256 else [])
        hs, ws = _halvings(h, len(filters)), _halvings(w, len(filters))
        enc = [(n, hs[i + 1], ws[i + 1]) for i, n in enumerate(filters)][1:]
    return gen, enc


def gate_shapes(config):
    """The (C, H, W) of the classifier's four MRU gates on the photo half
    of `config`: unit k's hidden depth at the half's size / 2^(k-1)
    (GATE_SHAPES at the default 64x128 pairs)."""
    h, w = config.output_height, config.output_width // 2
    return [(c, h >> k, w >> k) for k, c in enumerate((8, 128, 256, 512))]


def gate_split(dtype, config):
    """Calls per classifier pass of K3 (and of K4) in each variant: where
    `gate_plan` sends the four gates of `config` in `dtype`."""
    from edgegan_torch.ops import kernels
    counts = dict.fromkeys(kernels.GATE_VARIANTS, 0)
    for _, h, w in gate_shapes(config):
        counts[kernels.gate_plan(h * w, dtype, 0)[0]] += 1
    return counts


def expected_launches(kind: str, dtype, switches: bool, steps: float = 1,
                      config=None, extras: int = 0):
    """`kernels.LAUNCHES` after `steps` training steps of `kind`
    (STEP_KINDS) in `dtype` of `config` (the default configuration when
    None), with `extras` calls of the summaries' sample forward (G1 and
    G2 on a float32 z; the critics on the plain path): K1 and K2 on each
    plane set of `in_planes` in the variant `instance_norm_plan` picks for
    it (lane groups at the default sizes; ragged groups for the encoder's
    1x1 planes and, in bfloat16, its 2x2; blocks for the hires generator's
    64x64), K3's and K4's in the
    variants where `gate_plan` sends the four gates, K5 and K3/K4 only
    with the switches on."""
    import torch

    from edgegan_torch.core.config import Config
    from edgegan_torch.ops import kernels
    config = config or Config().derive('train')
    g_fwd, g_bwd, e_fwd, e_bwd, forwards, backwards = STEP_KINDS[kind]
    gen, enc = in_planes(config)
    on = int(switches)
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for name, per_gen, per_enc in (('instance_norm_act', g_fwd, e_fwd),
                                   ('instance_norm_act_bwd', g_bwd, e_bwd)):
        for planes, calls in ((gen, per_gen), (enc, per_enc)):
            for _, h, w in planes:
                variant = kernels.instance_norm_plan(h * w, dtype, 0)[0]
                want[name] += calls * steps
                want[f'{name}.{variant}'] += calls * steps
    for _, h, w in gen:
        variant = kernels.instance_norm_plan(h * w, torch.float32, 0)[0]
        want['instance_norm_act'] += 2 * extras
        want[f'instance_norm_act.{variant}'] += 2 * extras
    want.update({'prelu_bwd': on * 14 * backwards * steps,
                 'mru_gate_blend': on * 4 * forwards * steps,
                 'mru_gate_bwd': on * 4 * backwards * steps})
    for name, passes in (('mru_gate_blend', forwards),
                         ('mru_gate_bwd', backwards)):
        for variant, calls in gate_split(dtype, config).items():
            want[f'{name}.{variant}'] = on * passes * calls * steps
    return want


def forward_launches(config, dtype, forwards: int = 1):
    """`kernels.LAUNCHES` after `forwards` test or serving forwards
    (encoder, G1 and G2) of `config`: K1 on the encoder's and both
    generators' plane sets of `in_planes`."""
    from edgegan_torch.ops import kernels
    gen, enc = in_planes(config)
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for _, h, w in gen + gen + enc:
        variant = kernels.instance_norm_plan(h * w, dtype, 0)[0]
        want['instance_norm_act'] += forwards
        want[f'instance_norm_act.{variant}'] += forwards
    return want


def gate_registers(card: str):
    """Registers and local memory (spill) bytes per thread of K3's and K4's
    kernels as built, in every (variant, lanes, vectors) that `gate_plan`
    can pick, and for a cluster the clusters of its shape that can be
    resident on the card at once (cudaOccupancyMaxActiveClusters); fails
    on a spill, and on a cluster shape of which none can be resident.
    Returns {'K3 float32 block 256x4': (regs, local bytes, clusters or 0),
    ...}."""
    import ctypes

    import torch

    from edgegan_torch.ops import _build, kernels
    lib = _build.library()
    out = (ctypes.c_int * 3)()
    table = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        per_vector = 16 // dtype.itemsize
        reach = (kernels.CLUSTER_BLOCKS * kernels.IN_THREADS
                 * kernels.BLOCK_VECTORS * per_vector)
        plans = sorted({kernels.gate_plan(hw, dtype, 0)
                        for hw in range(1, reach + per_vector + 1)})
        for variant, lanes, vectors in plans:
            for bwd, kname in ((0, 'K3'), (1, 'K4')):
                err = lib.edgegan_mru_gate_attrs(
                    bwd, kernels._DTYPES[dtype],
                    kernels.GATE_VARIANTS[variant], lanes, vectors, out)
                check(err == 0, f'{kname} {variant} attributes: error {err}')
                key = f'{kname} {dname} {variant} {lanes}x{vectors}'
                table[key] = (out[0], out[1], out[2])
                extra = ''
                if variant == 'cluster':
                    check(out[2] > 0, f'{key}: no cluster can be resident')
                    extra = (f', {out[2]} clusters of {lanes // 256} blocks '
                             f'resident at once '
                             f'({out[2] * lanes // 256} blocks)')
                print(f'{key}: {out[0]} registers per thread, {out[1]} bytes '
                      f'of local memory (spills){extra} [{card}]')
    spills = {k: v for k, v in table.items() if v[1]}
    check(not spills, f'K3/K4 kernels spill: {spills}')
    return table


def gate_previous(fwd: bool, *tensors):
    """One launch of K3's (fwd) or K4's multi-pass kernel (variant 0: one
    block per plane, the earlier design) on contiguous CUDA tensors of one
    shape, outputs last. Only for timing it beside the new design: not
    counted in `LAUNCHES`."""
    from edgegan_torch.ops import _build, kernels
    lib = _build.library()
    entry = lib.edgegan_mru_gate_fwd if fwd else lib.edgegan_mru_gate_bwd
    x = tensors[0]
    b, c, h, w = x.shape
    err = entry(*(t.data_ptr() for t in tensors), b * c, h * w,
                kernels._DTYPES[x.dtype], kernels.GATE_VARIANTS['multi_pass'],
                kernels.IN_THREADS, 0, kernels._stream(x))
    check(err == 0, f'gate multi-pass launch failed: CUDA error {err}')
    return tensors[-1] if fwd else tensors[-2:]


def previous_matches(rg, ht, img, g, dname: str, variant: str):
    """The multi-pass kernels (the earlier design) on the same inputs as
    the planned `variant`, held to it within TOL (K3) and K2_TOL (K4)
    before either is timed."""
    import torch

    from edgegan_torch.ops import kernels
    prev_out = gate_previous(True, rg, ht, img, torch.empty_like(rg))
    prev_grads = gate_previous(False, rg, img, g, torch.empty_like(rg),
                               torch.empty_like(img))
    for what, got, want, tol in (
            ('K3', prev_out, kernels.mru_gate_blend(rg, ht, img),
             TOL[dname]),
            *(('K4', a, b, K2_TOL[dname]) for a, b in zip(
                prev_grads, kernels.mru_gate_bwd(rg, img, g)))):
        err, ok, _ = _close(got, want, tol)
        check(ok, f'{what} {dname} {list(rg.shape)}: multi-pass differs '
                  f'from {variant} by {err:.3g}')


def gate_phase(card: str):
    """K3 and K4 against their plain versions at the classifier's gate
    shapes at batch 64 (`gate_checks.check_gate`: a flat plane and ties at
    both extrema, launches per variant as planned, two runs bitwise
    equal), and the Function's gradients against autograd of the plain
    chain. Times each call with CUDA events and, from the profile, its
    device time (warm and cold L2) beside the byte bound, and the
    multi-pass kernel (the earlier design) on the same inputs, after
    checking it against the new one. Returns the numbers for the JSON line
    (times per training step: 3 classifier passes)."""
    import torch

    from edgegan_torch.ops import gate_checks, kernels
    dev = torch.device('cuda')
    max_err = {'K3': {'float32': 0.0, 'bfloat16': 0.0},
               'K4': {'float32': 0.0, 'bfloat16': 0.0}}
    per_step = {'K3': {}, 'K4': {}}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        keys = TIME_KEYS[:4] + ('device_ms', 'cold_ms', 'previous_ms',
                                'previous_cold_ms')
        sums = {k: dict.fromkeys(keys, 0.0) for k in ('K3', 'K4')}
        for i, (c, h, w) in enumerate(GATE_SHAPES):
            shape = (64, c, h, w)
            rg, ht, img, g = gate_checks.gate_inputs(dev, shape, dtype,
                                                     seed=6 + i)
            plan = kernels.gate_plan(h * w, dtype, rg.data_ptr()
                                     | ht.data_ptr() | img.data_ptr()
                                     | g.data_ptr())
            check(plan[0] == ('block' if h * w == 4096 else 'lane_group'),
                  f'gate {shape} {dname}: {plan}')
            e3, e4 = gate_checks.check_gate(
                rg, ht, img, g, TOL[dname], K2_TOL[dname], plan[0],
                label=f'{dname} {list(shape)}')
            max_err['K3'][dname] = max(max_err['K3'][dname], e3)
            max_err['K4'][dname] = max(max_err['K4'][dname], e4)
            print(f'K3/K4 {dname} {list(shape)} ({plan[0]} {plan[1]}x'
                  f'{plan[2]}): K3 max abs diff {e3:.3g} (limit '
                  f'{TOL[dname]}), K4 {e4:.3g} (limit {K2_TOL[dname]}), '
                  f'two runs bitwise equal')
            previous_matches(rg, ht, img, g, dname, plan[0])
            n, item = rg.numel(), rg.element_size()
            for key, fn, plain_fn, tensors, ops, make, prev, outs in (
                    ('K3', kernels.mru_gate_blend,
                     lambda: kernels.mru_gate_blend_plain(rg, ht, img), 4,
                     K3_OPS_PER_ELEMENT, (rg, ht, img),
                     lambda *t: gate_previous(True, *t), (rg,)),
                    ('K4', kernels.mru_gate_bwd,
                     lambda: kernels.mru_gate_bwd_plain(rg, img, g), 5,
                     K4_OPS_PER_ELEMENT, (rg, img, g),
                     lambda *t: gate_previous(False, *t), (rg, img))):
                match = 'mru_gate_fwd' if key == 'K3' else 'mru_gate_bwd'
                ms = cuda_ms(lambda: fn(*make), 100)
                plain = cuda_ms(plain_fn, 20)
                warm_us, cold_us = device_us(fn, match, cold_copies(
                    lambda: tuple(t.clone() for t in make),
                    tensors * n * item))
                pw_us, pc_us = device_us(prev, match, cold_copies(
                    lambda: tuple(t.clone() for t in make)
                    + tuple(torch.empty_like(t) for t in outs),
                    tensors * n * item))
                by_bytes, by_ops = bounds_ms(n, item, tensors, ops)
                bound = max(by_bytes, by_ops)
                ratio = ('not measured' if cold_us is None
                         else f'{cold_us / 1e3 / bound:.2f}x')
                print(f'{key} time {dname} {list(shape)}, {plan[0]} '
                      f'{plan[1]}x{plan[2]}: device {_us(warm_us)} warm / '
                      f'{_us(cold_us)} cold L2 (profile; {ratio} the '
                      f'bound cold), multi-pass (the earlier design) '
                      f'{_us(pw_us)} / {_us(pc_us)}; bound {bound:.4f} ms '
                      f'(bytes {by_bytes:.4f}, operations {by_ops:.4f}); '
                      f'{ms:.4f} ms (CUDA events), plain {plain:.4f} ms; no '
                      f'single PyTorch call computes it [{card}]')
                for k, v in zip(keys, (ms, plain, by_bytes, by_ops,
                                       _ms(warm_us), _ms(cold_us),
                                       _ms(pw_us), _ms(pc_us))):
                    sums[key][k] = _add(sums[key][k], v)
        for key in ('K3', 'K4'):
            per_step[key][dname] = {
                k: None if v is None else CLASSIFIER_PASSES * v
                for k, v in sums[key].items()}
            print(f'{key} per training step ({K3_PER_STEP} calls) at batch '
                  f'64 {dname}: ' + ', '.join(
                      f'{k} {_f4(v)}' for k, v in per_step[key][dname].items())
                  + f' [{card}]')

    # the Function: K3 forward, K4 backward and dht = g, against autograd
    # of the plain chain
    shape = (64,) + GATE_SHAPES[1]
    ins = [t.requires_grad_(True)
           for t in gate_checks.gate_inputs(dev, shape, torch.float32)[:3]]
    g = torch.randn(shape, device=dev)
    before = dict(kernels.LAUNCHES)
    got = torch.autograd.grad(kernels.mru_gate(*ins), ins, g)
    torch.cuda.synchronize()
    check(kernels.LAUNCHES['mru_gate_blend'] == before['mru_gate_blend'] + 1
          and kernels.LAUNCHES['mru_gate_bwd'] == before['mru_gate_bwd'] + 1,
          'the gate Function did not launch K3 and K4 once each')
    ref = torch.autograd.grad(kernels.mru_gate_blend_plain(*ins), ins, g)
    for name, a, b in zip(('drg', 'dht', 'dimg'), got, ref):
        err, ok, _ = _close(a, b, K2_TOL['float32'])
        print(f'Function (K3 forward, K4 backward) float32 {list(shape)} '
              f'{name} vs autograd of the plain chain: max abs diff '
              f'{err:.3g} (limit atol 1e-4 rtol 1e-4)')
        check(ok, f'the gate Function {name} differs from autograd')
    return max_err, per_step


def gate_variants_phase(card: str):
    """K3 and K4 in every variant against their plain versions, within TOL
    and K2_TOL, by `gate_checks.check_gate`: the plane sizes of
    `gate_checks.GATE_PLANES`, 37 planes (plane 0 flat, plane 1 tied at
    both extrema), float32 and bfloat16; and contiguous inputs at a
    storage offset of one element (off 16 bytes), which must take the
    multi-pass kernels. Then the same planes with +inf, NaN and -inf in
    three of them (`gate_checks.check_gate_nonfinite`), in every variant.
    Returns the largest differences."""
    import torch

    from edgegan_torch.ops import gate_checks, in_checks, kernels
    dev = torch.device('cuda')
    max_err = {'K3': 0.0, 'K4': 0.0}
    seen = set()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        for hw in gate_checks.GATE_PLANES:
            ins = gate_checks.gate_inputs(dev, (1, 37) + hw, dtype, seed=4)
            cases = [(ins, f'{dname} [1, 37, {hw[0]}, {hw[1]}]')]
            if hw == (8, 8):
                cases.append((tuple(in_checks.shifted(t) for t in ins),
                              f'{dname} [1, 37, 8, 8] at a storage offset '
                              f'of 1'))
            for tensors, label in cases:
                addr = 0
                for t in tensors:
                    addr |= t.data_ptr()
                want = kernels.gate_plan(hw[0] * hw[1], dtype, addr)[0]
                seen.add(want)
                e3, e4 = gate_checks.check_gate(
                    *tensors, TOL[dname], K2_TOL[dname], want, label=label)
                max_err['K3'] = max(max_err['K3'], e3)
                max_err['K4'] = max(max_err['K4'], e4)
                gate_checks.check_gate_nonfinite(
                    *tensors, TOL[dname], K2_TOL[dname], want, label=label)
                print(f'{label} ({want}): K3 and K4 within the limits, two '
                      f'runs bitwise equal; with +inf, NaN and -inf planes, '
                      f'NaN and inf where the plain versions give them '
                      f'[{card}]')
    check(seen == set(kernels.GATE_VARIANTS), f'variants reached: {seen}')
    print(f'K3/K4 variants: max abs diff K3 {max_err["K3"]:.3g}, K4 '
          f'{max_err["K4"]:.3g} [{card}]')
    return max_err


def _post(port, path, body):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=600)
    try:
        conn.request('POST', path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def serving_phase(card: str):
    """The port's serving path on cuda; returns the K1 launch count."""
    import numpy as np
    import torch
    from PIL import Image

    from edgegan_torch import bridge
    from edgegan_torch.core.config import Config
    from edgegan_torch.infer import make_test_forward
    from edgegan_torch.ops import kernels
    from edgegan_torch.serve import Batcher, batch_eps, make_server
    from edgegan_torch.train.networks import Networks

    config = Config().derive('test')
    h, w = config.output_height, config.output_width
    params, aux = bridge.random_jax_params(config, seed=0)

    def nets_on(device):
        return bridge.load_jax_params(Networks(config), params,
                                      aux).to(device)

    batcher = Batcher(nets_on('cuda'), config, max_batch=16,
                      device='cuda')
    server = make_server(config, batcher, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    rng = np.random.RandomState(0)
    try:
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        before = batcher._n_dispatched
        t0 = time.perf_counter()
        replies, pngs = [], []
        for _ in range(4):
            buf = io.BytesIO()
            Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
                buf, format='PNG')
            pngs.append(buf.getvalue())

        def png_request(k):
            replies.append((k, *_post(port, f'/generate?class_id={k}',
                                      pngs[k])))

        threads = [threading.Thread(target=png_request, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        raw = rng.uniform(-1, 1, (8, h, w, 3)).astype('<f4')
        status, body = _post(port, '/generate?class_id=0,1,2,3,4,5,6,13'
                             '&raw=1&n=8', raw.tobytes())
        conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
        conn.request('GET', '/healthz')
        health = conn.getresponse()
        stats = json.loads(health.read())
        conn.close()
        wall = time.perf_counter() - t0
        launches = kernels.LAUNCHES['instance_norm_act']
        batches = batcher._n_dispatched - before

        check(len(replies) == 4, f'{len(replies)} of 4 PNG replies')
        for k, st, png in replies:
            check(st == 200, f'PNG request class {k}: HTTP {st}')
            img = np.asarray(Image.open(io.BytesIO(png)))
            check(img.shape == (h, w // 2, 3), f'PNG shape {img.shape}')
        check(status == 200, f'raw n=8 request: HTTP {status}')
        photos = np.frombuffer(body, '<f4').reshape(8, h, w // 2, 3)
        check(bool(np.isfinite(photos).all()) and np.abs(photos).max() <= 1,
              'raw photos not finite in [-1, 1]')
        check(health.status == 200 and stats['ok'], f'healthz {stats}')
        check(launches == 6 * batches and batches > 0,
              f'K1 launched {launches} times for {batches} batches')
        check(kernels.LAUNCHES['instance_norm_act.lane_group'] == launches,
              f'K1 left the lane-group kernels: {kernels.LAUNCHES}')
        check(kernels.LAUNCHES['instance_norm_act_bwd'] == 0,
              'serving launched K2')
        print(f'serving: 4 PNG + 1 raw n=8 + healthz answered 200 in '
              f'{wall:.3f} s (host clock); {batches} batches, K1 launches '
              f'{launches} = 6 per batch, all in lane groups [{card}]')
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()

    # one float32 batch on the card against the port's CPU forward
    x = torch.from_numpy(rng.uniform(-1, 1, (16, h, w // 2, 3)).astype(
        np.float32))
    classes = torch.from_numpy(rng.randint(0, config.num_classes, 16))
    eps = batch_eps(0, 0)
    gpu_nets = nets_on('cuda')
    with torch.inference_mode():
        got = make_test_forward(gpu_nets, config)(x.cuda(), classes.cuda(),
                                                  eps)
        ref = make_test_forward(nets_on('cpu'), config)(x, classes, eps)
    limit = 1e-3  # cuDNN picks other algorithms than the CPU's
    for name, g, r in zip(('edge', 'image'), got, ref):
        check(bool(torch.isfinite(g).all()), f'{name} not finite')
        err = (g.cpu() - r).abs().max().item()
        print(f'float32 batch 16 {name}: card vs CPU max abs diff {err:.3g} '
              f'(limit {limit})')
        check(err <= limit, f'{name} differs from the CPU forward')

    # time per batch: the Batcher's device step (H2D, forward, D2H)
    for max_batch in (16, 64):
        for dtype in ('float32', 'bfloat16'):
            b = Batcher(gpu_nets, config, max_batch=max_batch,
                        transfer_dtype=dtype, device='cuda')
            try:
                imgs, cls = b._stage([(np.zeros((h, w, 3), np.float32), 0,
                                       None)] * max_batch)
                step = iter(range(10 ** 6))
                ms = cuda_ms(lambda: b.step(imgs, cls, next(step)), 20)
                t0 = time.perf_counter()
                for _ in range(5):
                    b.step(imgs, cls, next(step))
                    torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) / 5 * 1e3
                profile_steps(card, f'max_batch {max_batch} {dtype}',
                              lambda: b.step(imgs, cls, next(step)))
            finally:
                b.stop()
            print(f'time per batch at max_batch {max_batch} {dtype}: '
                  f'{ms:.3f} ms (CUDA events, back to back), {host_ms:.3f} '
                  f'ms one at a time (host clock) [{card}]')
    return launches


def write_dataset(root: str, n_images: int, n_classes: int, h: int, w: int,
                  seed: int = 0, split: str = 'train'):
    """<root>/ds/<split>/<class>/*.png: `n_images` random h x w
    sketch|photo pairs, spread over `n_classes` class directories."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)
    for i in range(n_images):
        d = os.path.join(root, 'ds', split, str(i % n_classes))
        os.makedirs(d, exist_ok=True)
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(d, f'{i:04d}.png'))


def train_phase(card: str, tmp: str):
    """The training CLI at full width on cuda: 2 epochs of 2 batches (4
    steps, checkpoints 2 and 5), then 1 epoch resumed at counter 5, both
    float32 with the switches off; then a fresh run of 2 steps in bfloat16
    with both classifier switches on. Returns each run's launch counts."""
    import math

    import numpy as np
    import torch

    from edgegan_torch import bridge
    from edgegan_torch import checkpoint as ckpt
    from edgegan_torch.cli import train as train_cli
    from edgegan_torch.core.config import Config
    from edgegan_torch.ops import kernels
    from edgegan_torch.utils.metrics_io import (read_metrics,
                                                read_resume_markers)

    config = Config().derive('train')
    root = os.path.join(tmp, 'data')
    write_dataset(root, 2 * config.batch_size, config.num_classes,
                  config.output_height, config.output_width)
    out = os.path.join(tmp, 'outputs')
    start, _ = bridge.random_jax_params(config, config.seed, critics=True)
    runs = [  # (label, --name, flags, switches, steps, first counter)
        (SUMMARIES_RUN, 'smoke',
         ['--epoch', '2', '--summary_frequency', str(SUMMARY_FREQUENCY)],
         False, 4, 2),
        ('float32 resumed --epoch 1', 'smoke', ['--epoch', '1'], False, 2,
         6),
        ('bfloat16 --epoch 1, switches on', 'smoke_bf16',
         ['--epoch', '1', '--dtype', 'bfloat16'], True, 2, 2)]
    launches, extras_ms = {}, None
    for label, name, flags, switches, steps, first in runs:
        args = ['--dataroot', root, '--dataset', 'ds', '--outputsroot', out,
                '--name', name, '--save_checkpoint_frequency', '3'] + flags
        ckpt_dir = os.path.join(out, name, 'checkpoints')
        log = os.path.join(out, name, 'logs', 'metrics.jsonl')
        # a resumed run starts from checkpoint 5
        run_start = ckpt.read(ckpt_dir, 5)[0]['params'] if first > 2 else start
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        with classifier_switches(switches):
            state = train_cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        launches[label] = counts
        lines = [m for m in read_metrics(log) if m['step'] >= first]
        if first > 2:
            check(read_resume_markers(log) == [5],
                  f'resumes at {read_resume_markers(log)}, expected [5]')
            check(state.step == 6, f'train state step {state.step} after '
                  'the resume')
        check([m['step'] for m in lines] == list(range(first, first + steps)),
              f'{label}: steps logged: {[m.get("step") for m in lines]}')
        for m in lines:
            vals = {k: v for k, v in m.items() if k not in ('step', 'epoch')}
            check(len(vals) == 11 and all(math.isfinite(v)
                                          for v in vals.values()),
                  f'{label}: metrics at step {m["step"]}: {vals}')
        on = int(switches)
        # the extras run at the counters reached (first .. first + steps
        # - 1) that are multiples of --summary_frequency
        extras = (len([c for c in range(first, first + steps)
                       if c % SUMMARY_FREQUENCY == 0])
                  if label == SUMMARIES_RUN else 0)
        want = expected_launches(
            'faithful', torch.bfloat16 if 'bfloat16' in flags
            else torch.float32, switches, steps, extras=extras)
        check_launches(f'{label} ({steps} steps)', counts, want)
        params, _ = bridge.export_jax_params(state.nets)
        moved = {net: max(float(np.abs(a - b).max()) for a, b in zip(
            _leaves(params[net]), _leaves(run_start[net]))) for net in params}
        check(all(v > 0 for v in moved.values()), f'{label}: a group did '
              f'not move: {moved}')
        print(f'train CLI {label}: {steps} steps of batch '
              f'{config.batch_size} in {wall:.3f} s with start-up (host '
              f'clock); launches {counts} = per step K1 {K1_PER_STEP}, K2 '
              f'{K2_PER_STEP}, K5 {on * K5_PER_STEP}, K3 {on * K3_PER_STEP}, '
              f'K4 {on * K4_PER_STEP}, and K1 6 per summaries extras call '
              f'({extras} calls); largest change per network in this '
              f'run: ' + ', '.join(f'{k} {v:.3g}' for k, v in moved.items())
              + f' [{card}]')
        print('  last metrics: ' + json.dumps(lines[-1]))
        if label == SUMMARIES_RUN:
            check(ckpt.steps(ckpt_dir) == [2, 5],
                  f'checkpoints {ckpt.steps(ckpt_dir)}, expected [2, 5]')
            extras_ms = summaries_check(
                card, os.path.join(out, name, 'logs'), state, config,
                list(range(first, first + steps)), tmp)
    return launches, extras_ms


SUMMARIES_RUN = 'float32 --epoch 2 --summary_frequency 2'
SUMMARY_FREQUENCY = 2
EXTRAS_TAGS = {'z', 'd', 'd_', 'imageD', 'imageDfake', 'edgeD', 'edgeDfake',
               'inputs', 'G1', 'G2', 'resized_inputs_image',
               'resized_G_image', 'resized_inputs_p3_image',
               'resized_G_p3_image'}


def _proto_fields(buf: bytes):
    """{field number: [values]} of one protobuf message: ints for varints,
    bytes for length-delimited fields and fixed64/fixed32 ones."""
    fields, pos = {}, 0

    def varint():
        nonlocal pos
        n = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n

    while pos < len(buf):
        key = varint()
        wire = key & 7
        if wire == 0:
            value = varint()
        elif wire == 2:
            n = varint()
            value, pos = buf[pos:pos + n], pos + n
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise RuntimeError(f'check failed: wire type {wire} in an event')
        fields.setdefault(key >> 3, []).append(value)
    return fields


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 * (c & 1))
        table.append(c)
    return table


def crc32c(data: bytes, table=_crc32c_table()) -> int:
    """CRC-32C, computed here and not by the package's event writer, so
    that the event check does not share the code it checks."""
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotate right by 15, add a constant."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_events(path: str):
    """(file_version, [(step, tag)]) of a TensorBoard event file: each
    TFRecord's length and data CRCs are checked (masked CRC32C, this
    script's own), then its `Event` proto is decoded: file_version (3),
    step (2), summary (5) -> value (1) -> tag (1)."""
    import struct

    check(crc32c(b'123456789') == 0xE3069283,
          'CRC-32C of b"123456789" is its standard check value')
    with open(path, 'rb') as f:
        data = f.read()
    version, values, pos = None, [], 0
    while pos < len(data):
        check(pos + 12 <= len(data), f'{path}: truncated header at {pos}')
        header = data[pos:pos + 8]
        (n,) = struct.unpack('<Q', header)
        check(struct.unpack('<I', data[pos + 8:pos + 12])[0]
              == masked_crc32c(header), f'{path}: length CRC at {pos}')
        payload = data[pos + 12:pos + 12 + n]
        check(len(payload) == n and pos + 16 + n <= len(data),
              f'{path}: truncated record at {pos}')
        check(struct.unpack('<I', data[pos + 12 + n:pos + 16 + n])[0]
              == masked_crc32c(payload), f'{path}: data CRC at {pos}')
        event = _proto_fields(payload)
        if 3 in event:
            version = event[3][0].decode()
        for summary in event.get(5, []):
            for value in _proto_fields(summary).get(1, []):
                values.append((event[2][0],
                               _proto_fields(value)[1][0].decode()))
        pos += 16 + n
    return version, values


def summaries_check(card: str, logdir: str, state, config, steps, tmp: str):
    """The trainer's event file of `steps` (counters) parsed with valid
    CRCs: the 11 scalar tags at every step and the extras' tags at the
    counters that are multiples of SUMMARY_FREQUENCY, nothing else; then
    the cost of one `extras` call at batch 64 on the run's final state:
    the whole call by the host clock (forward, copies to the host, PNG
    encoding, CRCs, write) and its sample forward alone by CUDA events.
    Returns those two times in ms."""
    import glob

    import torch

    from edgegan_torch.summaries import SCALARS, SummaryWriter

    (path,) = glob.glob(os.path.join(logdir, 'events.out.tfevents.*'))
    t0 = time.perf_counter()
    version, values = read_events(path)
    read_s = time.perf_counter() - t0
    check(version == 'brain.Event:2', f'file_version {version!r}')
    for step in steps:
        tags = sorted(t for s, t in values if s == step)
        want = sorted(SCALARS + (sorted(EXTRAS_TAGS)
                                 if step % SUMMARY_FREQUENCY == 0 else []))
        check(tags == want, f'events at step {step}: {tags}, expected '
              f'{want}')
    check({s for s, _ in values} == set(steps),
          f'event steps {sorted({s for s, _ in values})}')
    size = os.path.getsize(path)

    tb = SummaryWriter(os.path.join(tmp, 'extras_cost'), config)
    gen = torch.Generator(device='cuda').manual_seed(9)
    b = config.batch_size
    images = torch.rand(b, config.output_height, config.output_width, 3,
                        generator=gen, device='cuda') * 2 - 1
    classes = torch.randint(0, config.num_classes, (b, 1), generator=gen,
                            device='cuda').float()
    z = torch.cat([torch.randn(b, config.z_dim, generator=gen,
                               device='cuda'), classes], dim=1)
    try:
        tb.extras(0, state, images, classes)  # warm-up
        host = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tb.extras(i + 1, state, images, classes)
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
    finally:
        tb.close()
    forward_ms = cuda_ms(lambda: tb.sample(state.nets, z, images), 5)
    print(f'summaries: {path.rsplit(os.sep, 1)[-1]}, {size} bytes, '
          f'{len(values)} values over steps {steps[0]}-{steps[-1]}, every '
          f'record\'s CRCs valid (read in {read_s:.2f} s); 11 scalars a step, '
          f'the {len(EXTRAS_TAGS)} extras tags at counters '
          f'{[c for c in steps if c % SUMMARY_FREQUENCY == 0]}. extras at '
          f'batch {b}: {min(host):.1f}-{max(host):.1f} ms a call (host clock, '
          f'3 calls: forward, copies, PNG encoding, CRCs, write), its '
          f'sample forward {forward_ms:.2f} ms (CUDA events) [{card}]')
    return {'call_ms_host_clock': host, 'forward_ms_cuda_events': forward_ms}


EVAL_PAIRS = 256
EVAL_BATCH = 64
EVAL_KEYS = ['checkpoint_step', 'extractor', 'extractor_step', 'split',
             'n_images', 'classifier_fid', 'note', 'l1', 'mse', 'psnr_db']
PINNED_NPZ = os.path.join('docs', 'fid_extractor.npz')
FEATURE_TOL = 1e-3   # card vs CPU, of the largest |feature|
GATE = ('EDGEGAN_PALLAS_GATE',)


def evaluate_launches(config, gate: bool, forwards: int,
                      classifier_forwards: int, extractor_config):
    """`kernels.LAUNCHES` after an evaluation of `forwards` test forwards
    of `config` (K1 on both generators' and the encoder's planes) and
    `classifier_forwards` forwards of an extractor built for
    `extractor_config` (K3 on its four MRU gates, with the gate switch
    on), all in float32."""
    import torch
    want = forward_launches(config, torch.float32, forwards)
    want['mru_gate_blend'] = int(gate) * 4 * classifier_forwards
    for variant, calls in gate_split(torch.float32,
                                     extractor_config).items():
        want[f'mru_gate_blend.{variant}'] = (int(gate) * calls
                                             * classifier_forwards)
    return want


def evaluate_phase(card: str, tmp: str):
    """`python -m edgegan_torch.cli.evaluate` at full width on cuda, on the
    train phase's checkpoint 5, over EVAL_PAIRS synthetic 64x128 pairs of
    a split 'eval' at --eval_batch 64, with the pinned extractor
    (docs/fid_extractor.npz) and with the in-run one, each with
    EDGEGAN_PALLAS_GATE off and on: one JSON line of the JAX script's keys
    with a finite classifier_fid, and K1 6 launches per generator forward,
    K3 4 per classifier forward with the switch on, 0 off. Before: the
    native loader built or not, and built, its decode of 64 of the PNGs
    against the PIL path's pixels bit for bit. After: the pinned features
    of one batch on the card against the port's CPU forward (FEATURE_TOL
    of the largest |feature|), and with the switch on against off (K3's
    float32 limit). Returns (launches by run, results by run)."""
    import glob
    import math

    import numpy as np
    import torch

    from edgegan_torch.cli import evaluate as evaluate_cli
    from edgegan_torch.core.config import Config
    from edgegan_torch.data import native_loader
    from edgegan_torch.data.dataset import Dataset
    from edgegan_torch.evaluation import pinned_extractor
    from edgegan_torch.ops import kernels
    from edgegan_torch.utils.images import imread, imresize

    config = Config().derive('test')
    h, w = config.output_height, config.output_width
    root = os.path.join(tmp, 'data')
    write_dataset(root, EVAL_PAIRS, config.num_classes, h, w, seed=5,
                  split='eval')

    if native_loader.get_lib() is None:
        print(f'native_loader: unavailable ({native_loader.build_error})')
    else:
        print('native_loader: built')
        files = sorted(glob.glob(os.path.join(root, 'ds', 'eval', '*',
                                              '*.png')))[:EVAL_BATCH]
        t0 = time.perf_counter()
        got, fail = native_loader.decode_batch(files, h, w)
        decode_s = time.perf_counter() - t0
        check(not fail.any(), f'native decode failed on {fail.sum()} files')
        for img, f in zip(got, files):
            pixels = imresize(imread(f), (h, w))
            want = (pixels.astype(np.float32) / np.float32(127.5)
                    - np.float32(1))
            check(np.array_equal(img, want), f'native decode of {f} differs '
                  'from the PIL path')
        print(f'native_loader: {len(files)} {h}x{w} PNGs decoded in '
              f'{1e3 * decode_s:.1f} ms (host clock), bit for bit the PIL '
              'path\'s pixels over 127.5 minus 1 in float32')

    base = ['--dataroot', root, '--dataset', 'ds', '--outputsroot',
            os.path.join(tmp, 'outputs'), '--name', 'smoke', '--split',
            'eval', '--limit', str(EVAL_PAIRS), '--eval_batch',
            str(EVAL_BATCH)]
    forwards = EVAL_PAIRS // EVAL_BATCH
    with open(PINNED_NPZ + '.json') as f:
        pinned_config = Config(**json.load(f)['config']).derive('train')
    launches, results = {}, {}
    for extractor in ('pinned', 'in-run'):
        for gate in (False, True):
            label = (f'evaluate, {extractor} extractor, gate '
                     f'{"on" if gate else "off"}')
            argv = base + (['--extractor_npz', PINNED_NPZ]
                           if extractor == 'pinned' else [])
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with classifier_switches(gate, GATE), \
                    contextlib.redirect_stdout(buf):
                result = evaluate_cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[label] = counts = dict(kernels.LAUNCHES)
            lines = buf.getvalue().splitlines()
            check(len(lines) == 1 and json.loads(lines[0]) == result,
                  f'{label}: printed {lines}')
            check(list(result) == EVAL_KEYS, f'{label}: keys {list(result)}')
            check(math.isfinite(result['classifier_fid'])
                  and result['n_images'] == EVAL_PAIRS
                  and result['checkpoint_step'] == 5
                  and result['extractor_step'] == (
                      None if extractor == 'pinned' else 5),
                  f'{label}: {result}')
            want = evaluate_launches(
                config, gate, forwards, 2 * forwards,
                pinned_config if extractor == 'pinned' else config)
            check_launches(label, counts, want)
            results[label] = {'wall_s': wall,
                              'images_per_s': EVAL_PAIRS / wall, **result}
            print(f'{label}: {EVAL_PAIRS} pairs at batch {EVAL_BATCH} in '
                  f'{wall:.3f} s with start-up (host clock), '
                  f'{EVAL_PAIRS / wall:.1f} images/s; classifier_fid '
                  f'{result["classifier_fid"]}, l1 {result["l1"]}, psnr '
                  f'{result["psnr_db"]} dB; launches K1 '
                  f'{counts["instance_norm_act"]} ({forwards} generator '
                  f'forwards), K3 {counts["mru_gate_blend"]} '
                  f'({2 * forwards} classifier forwards) [{card}]')

    images = Dataset(root, 'ds', EVAL_BATCH, EVAL_BATCH,
                     dict(input_height=h, input_width=w, output_height=h,
                          output_width=w, crop=False, grayscale=False,
                          z_dim=config.z_dim),
                     config.num_classes, subdir='eval')[0][0]
    photos = images[:, :, w // 2:, :]
    feats = {}
    for gate in (False, True):
        with classifier_switches(gate, GATE):
            feats[gate] = pinned_extractor(PINNED_NPZ, 'cuda')(photos)
    cpu = pinned_extractor(PINNED_NPZ, 'cpu')(photos)
    scale = float(np.abs(cpu).max())
    err_cpu = float(np.abs(feats[False] - cpu).max()) / scale
    err_gate = float(np.abs(feats[True] - feats[False]).max())
    check(err_cpu <= FEATURE_TOL, f'pinned features card vs CPU: '
          f'{err_cpu:.3g} of the largest |feature|')
    check(err_gate <= TOL['float32']['atol'], f'pinned features gate on vs '
          f'off: {err_gate:.3g}')
    print(f'evaluate: pinned features of {EVAL_BATCH} photo halves, card vs '
          f'CPU {err_cpu:.3g} of the largest |feature| ({scale:.4f}; limit '
          f'{FEATURE_TOL}); gate on vs off max abs {err_gate:.3g} (limit '
          f'{TOL["float32"]["atol"]}) [{card}]')
    results['pinned_features'] = {'card_vs_cpu_of_max': err_cpu,
                                  'gate_on_vs_off_max_abs': err_gate}
    return launches, results


QUALITY_PER_CLASS = (16, 4)   # train / test pairs a class (recipe 1006 / 24)
QUALITY_STEPS = {True: 30, False: 5}   # extractor steps, switches on / off
QUALITY_TIMED = 10
QUALITY_LIMIT = 64


def _sha(path: str) -> str:
    import hashlib
    with open(path, 'rb') as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _add_counts(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def quality_phase(card: str, tmp: str):
    """The quality toolchain on cuda at the recipe's width (14 classes,
    64x128 pairs, batch 64, float32): stage a small genshapes tree
    (`data/genshapes.py`, seed 11, QUALITY_PER_CLASS pairs a class; the
    Pillow version and three files' hashes printed), train the pinned
    extractor through `cli.train_extractor` for 30 steps with both
    classifier switches on, then 5 with them off: the loss finite and
    lower at the end than at the start; launches K5 14, K3 4, K4 4 a step
    (and K3 4 per held-out forward) with the switches, none without; the
    npz and its sidecar written and read by `evaluation.pinned_extractor`,
    its features of 64 photos on the card within FEATURE_TOL of the CPU's;
    the step timed by CUDA events, switches off and on in turns. Then
    `cli.fid_curve` with that npz over the train phase's retained
    checkpoints (a ladder of two random states when that phase did not
    run), --limit 64, gate switch on: one row per retained step, one
    point's FID equal to `cli.evaluate`'s on the same step within rtol
    1e-6, K1 6 per generator forward and K3 4 per classifier forward.
    Returns (launches by run, results)."""
    import math

    import numpy as np
    import PIL
    import torch

    from edgegan_torch import bridge
    from edgegan_torch import checkpoint as ckpt
    from edgegan_torch.cli import evaluate as evaluate_cli
    from edgegan_torch.cli import fid_curve
    from edgegan_torch.cli import train_extractor as te
    from edgegan_torch.core.config import Config
    from edgegan_torch.data.dataset import Dataset
    from edgegan_torch.data.genshapes import stage
    from edgegan_torch.evaluation import pinned_extractor
    from edgegan_torch.ops import kernels
    from edgegan_torch.train.networks import Networks
    from edgegan_torch.train.state import create_train_state

    recipe = te.recipe()
    n = recipe.num_classes
    root = os.path.join(tmp, 'genshapes_data')
    per_train, per_test = QUALITY_PER_CLASS
    t0 = time.perf_counter()
    stage(root, seed=te.STAGE_SEED, train_per_class=per_train,
          test_per_class=per_test, num_classes=n)
    stage_s = time.perf_counter() - t0
    files = [os.path.join(root, 'genshapes', *p) for p in (
        ('train', '0', '0000.png'), ('train', '7', '0003.png'),
        ('test', str(n - 1), f'{per_test - 1:04d}.png'))]
    print(f'quality: staged {n} classes x {per_train} train / {per_test} '
          f'test genshapes pairs in {stage_s:.2f} s (the recipe stages '
          f'{te.STAGE_TRAIN} / {te.STAGE_TEST}: cut for time); Pillow '
          f'{PIL.__version__}; sha256[:16] ' + ', '.join(
              f'{os.path.relpath(f, root)} {_sha(f)}' for f in files))

    launches, results = {}, {}
    held_out = 1   # one held-out batch: its pairs are fewer than 64
    for on in (True, False):
        label = f'train_extractor, switches {"on" if on else "off"}'
        steps = QUALITY_STEPS[on]
        npz = os.path.join(tmp, f'extractor_{int(on)}', 'fid_extractor.npz')
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        with classifier_switches(on), contextlib.redirect_stdout(
                io.StringIO()):
            meta, losses = te.train(steps, npz, root, 'cuda')
        wall = time.perf_counter() - t0
        launches[label] = counts = dict(kernels.LAUNCHES)
        want = _add_counts(
            expected_launches('extractor', torch.float32, on, steps, recipe),
            evaluate_launches(recipe, on, 0, held_out, recipe))
        check_launches(label, counts, want)
        check(len(losses) == steps and all(map(math.isfinite, losses)),
              f'{label}: losses {losses}')
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        if on:
            check(last < first, f'{label}: loss {first:.4f} over the first '
                  f'5 steps, {last:.4f} over the last 5')
        with open(npz + '.json') as f:
            check(json.load(f) == meta, f'{label}: sidecar differs')
        results[label] = {'wall_s': wall, 'loss_first5': float(first),
                          'loss_last5': float(last), **meta}
        print(f'{label}: {steps} steps at batch {te.BATCH} in {wall:.3f} s '
              f'with start-up (host clock), loss {first:.4f} -> {last:.4f} '
              f'(mean of the first / last 5), held-out accuracy '
              f'{meta["heldout_accuracy"]}, npz {meta["artifact_bytes"]} '
              f'bytes; launches K5 {counts["prelu_bwd"]}, K3 '
              f'{counts["mru_gate_blend"]}, K4 {counts["mru_gate_bwd"]} '
              f'[{card}]')
    npz = os.path.join(tmp, 'extractor_1', 'fid_extractor.npz')

    dataset = Dataset(root, 'genshapes', te.BATCH, te.BATCH,
                      te.dataset_config(recipe), n)
    images, _z, names = dataset[0]
    photos = images[:, :, recipe.output_width // 2:, :]
    card_feats = pinned_extractor(npz, 'cuda')(photos)
    cpu_feats = pinned_extractor(npz, 'cpu')(photos)
    scale = float(np.abs(cpu_feats).max())
    err = float(np.abs(card_feats - cpu_feats).max()) / scale
    check(card_feats.shape == (te.BATCH, 768) and err <= FEATURE_TOL,
          f'trained extractor features card vs CPU: {err:.3g} of the '
          'largest |feature|')
    results['features_card_vs_cpu_of_max'] = err
    print(f'quality: the trained npz through evaluation.pinned_extractor, '
          f'{te.BATCH} photos: card vs CPU {err:.3g} of the largest '
          f'|feature| ({scale:.4f}; limit {FEATURE_TOL}) [{card}]')

    # the step alone, switches off and on in turns
    device = torch.device('cuda')
    x = torch.from_numpy(images).to(device)
    labels = te.class_labels(names, device)
    classifier = te.initial_classifier(recipe).to(device)
    step_ms = {False: [], True: []}
    for on in STEP_TURNS:
        step = te.make_train_step(classifier, recipe)
        with classifier_switches(on):
            step_ms[on].append(cuda_ms(lambda: step(x, labels),
                                       QUALITY_TIMED))
    results['step_ms'] = {f'switches {"on" if on else "off"}': v
                          for on, v in step_ms.items()}
    print('quality: the extractor step at batch 64, float32, CUDA events '
          f'over {QUALITY_TIMED} steps after 3, in turns off, on, on, off: '
          + ', '.join(f'switches {"on" if on else "off"} '
                      + ' / '.join(f'{v:.3f}' for v in ms) + ' ms'
                      for on, ms in step_ms.items()) + f' [{card}]')

    # the FID-vs-step sweep over a run's retained checkpoints
    config = Config().derive('train')
    out = os.path.join(tmp, 'outputs')
    ckpt_dir = os.path.join(out, 'smoke', 'checkpoints')
    if not ckpt.steps(ckpt_dir):   # the train phase did not run
        for seed, counter in enumerate((2, 5)):
            nets = bridge.load_jax_params(
                Networks(config, critics=True),
                *bridge.random_jax_params(config, seed, critics=True))
            ckpt.save(ckpt_dir, counter, create_train_state(nets.to(device)))
    data = os.path.join(tmp, 'data')
    if not os.path.isdir(os.path.join(data, 'ds', 'eval')):
        write_dataset(data, QUALITY_LIMIT, config.num_classes,
                      config.output_height, config.output_width, seed=5,
                      split='eval')
    retained = ckpt.steps(ckpt_dir)
    flags = ['--dataroot', data, '--dataset', 'ds', '--outputsroot', out,
             '--name', 'smoke', '--limit', str(QUALITY_LIMIT),
             '--eval_batch', str(QUALITY_LIMIT), '--extractor_npz', npz]
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with classifier_switches(True, GATE), contextlib.redirect_stdout(buf):
        summary = fid_curve.main(flags + ['--splits', 'eval', '--outdir',
                                          os.path.join(tmp, 'fidcurve')])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    label = 'fid_curve, trained extractor, gate on'
    launches[label] = counts = dict(kernels.LAUNCHES)
    rows = summary['curve']
    check([r['step'] for r in rows] == retained,
          f'fid_curve rows {[r["step"] for r in rows]}, retained {retained}')
    check(all(math.isfinite(r['eval']['classifier_fid']) for r in rows),
          f'fid_curve: {rows}')
    printed = buf.getvalue().strip().splitlines()
    check([json.loads(line) for line in printed[:len(rows)]] == rows,
          'fid_curve: printed rows differ from fidcurve.json')
    want = evaluate_launches(config, True, len(rows), 2 * len(rows), recipe)
    check_launches(label, counts, want)
    with classifier_switches(True, GATE), contextlib.redirect_stdout(
            io.StringIO()):
        single = evaluate_cli.main(flags + ['--split', 'eval', '--step',
                                            str(retained[-1])])
    point = rows[-1]['eval']['classifier_fid']
    check(math.isclose(point, single['classifier_fid'], rel_tol=1e-6),
          f'fid_curve at step {retained[-1]}: {point}, cli.evaluate '
          f'{single["classifier_fid"]}')
    results['fid_curve'] = {'wall_s': wall, 'rows': rows,
                            'evaluate_at_last_step': single['classifier_fid'],
                            'plot': printed[-2] if len(printed) > len(rows)
                            + 1 else 'written'}
    print(f'{label}: {len(rows)} points x {QUALITY_LIMIT} pairs in '
          f'{wall:.3f} s with start-up (host clock); FIDs '
          + ', '.join(f'{r["step"]}: {r["eval"]["classifier_fid"]}'
                      for r in rows)
          + f'; cli.evaluate at step {retained[-1]} '
          f'{single["classifier_fid"]}; launches K1 '
          f'{counts["instance_norm_act"]}, K3 {counts["mru_gate_blend"]}'
          f'; {printed[-2] if len(printed) > len(rows) + 1 else "plot written"}'
          f' [{card}]')
    return launches, results


def tf_import_phase(card: str, tmp: str):
    """`convert.export_tf_npz` -> `import_tf_npz` of the default 14-class
    trees (every network, random weights) bit-exact, and G2's forward on
    the card at batch 64 from the imported trees bitwise equal to the
    forward from the originals (cuDNN deterministic)."""
    import numpy as np
    import torch

    from edgegan_torch import bridge, convert
    from edgegan_torch.core.config import Config
    from edgegan_torch.train.networks import Networks

    config = Config().derive('train')
    params, aux = bridge.random_jax_params(config, 7, critics=True)
    path = os.path.join(tmp, 'edgegan_tf.npz')
    t0 = time.perf_counter()
    names = convert.export_tf_npz(params, aux, config, path)
    check(names == convert.tf_variable_names(config), 'exported names')
    got = convert.import_tf_npz(path, config)
    wall = time.perf_counter() - t0
    for want_tree, got_tree in zip((params, aux), got):
        want_flat = bridge.flatten_npz(t=want_tree)
        got_flat = bridge.flatten_npz(t=got_tree)
        check(want_flat.keys() == got_flat.keys(), 'imported paths differ')
        for k, v in want_flat.items():
            check(got_flat[k].dtype == v.dtype and np.array_equal(
                got_flat[k], v), f'imported {k} differs')
    gen = torch.Generator(device='cuda').manual_seed(3)
    b = config.batch_size
    z = torch.randn(b, config.z_dim, generator=gen, device='cuda')
    classes = torch.randint(0, config.num_classes, (b,), generator=gen,
                            device='cuda')
    outs = []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for trees in ((params, aux), got):
            nets = bridge.load_jax_params(Networks(config), *trees).cuda()
            with torch.no_grad():
                outs.append(nets.G2(nets.gen_input(z, classes)))
    finally:
        torch.backends.cudnn.deterministic = saved
    check(torch.equal(*outs), 'G2 from the imported trees differs')
    print(f'tf_import: {len(names)} TF variables exported and imported '
          f'bit-exact in {wall:.2f} s (host clock, with the shape check); '
          f'G2 at batch {b} on the card from the imported trees bitwise '
          f'equal to the originals\' [{card}]')


def write_test_tree(root: str, per_class: int, n_classes: int, h: int,
                    w: int, seed: int = 1):
    """<root>/ds/test/<class>/*.png: `per_class` random pairs in each of
    `n_classes` class directories, plus one under the class id
    `n_classes` and one under 'misc', both of which the test CLI must
    skip (quirk Q10); every pair holds the values 0 and 255, so that its
    own range sets the stretch of its saved panel. Returns the relative
    names ('<class>/<file>') of the files that must be written."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)
    classes = [str(c) for c in range(n_classes) for _ in range(per_class)]
    valid = []
    for i, cls in enumerate(classes + [str(n_classes), 'misc']):
        d = os.path.join(root, 'ds', 'test', cls)
        os.makedirs(d, exist_ok=True)
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        img[0, 0], img[0, 1] = 0, 255
        Image.fromarray(img).save(os.path.join(d, f'{i:04d}.png'))
        if i < len(classes):
            valid.append(os.path.join(cls, f'{i:04d}.png'))
    return sorted(valid)


LIFECYCLE = 'fast, reference_metrics, update_sn'


def lifecycle_phase(card: str, tmp: str):
    """This slice's path at full width on cuda, through the entry points:
    `cli.train` with the fast step, `reference_metrics` and `update_sn`
    and both classifier switches, 3 steps in float32 (its cadence save at
    counter 2 asynchronous) and 2 in bfloat16 resumed from that
    checkpoint; `cli.test` from the checkpoint at batch 1 and at
    --test_batch_size 16 (a padded tail); `serve` from the checkpoint
    directory without --weights, answering requests. Each run's launches
    are counted from 0 and checked. Returns them by run."""
    import numpy as np
    import torch
    from PIL import Image

    from edgegan_torch import bridge
    from edgegan_torch import checkpoint as ckpt
    from edgegan_torch import serve
    from edgegan_torch.cli import test as test_cli
    from edgegan_torch.cli import train as train_cli
    from edgegan_torch.core.config import Config
    from edgegan_torch.infer import make_test_forward
    from edgegan_torch.ops import kernels
    from edgegan_torch.train.networks import Networks
    from edgegan_torch.utils.metrics_io import (read_metrics,
                                                read_resume_markers)

    config = Config().derive('train')
    b, h, w = config.batch_size, config.output_height, config.output_width
    root = os.path.join(tmp, 'lifecycle')
    write_dataset(root, 3 * b, config.num_classes, h, w)
    valid = write_test_tree(root, 2, config.num_classes, h, w)
    out = os.path.join(root, 'outputs')
    base = ['--dataroot', root, '--dataset', 'ds', '--outputsroot', out,
            '--name', 'life']
    options = ['--update_mode', 'fast', '--reference_metrics', 'True',
               '--update_sn', 'True', '--save_checkpoint_frequency', '3',
               '--epoch', '1']
    ckpt_dir = os.path.join(out, 'life', 'checkpoints')
    log = os.path.join(out, 'life', 'logs', 'metrics.jsonl')
    _, aux0 = bridge.random_jax_params(config, config.seed, critics=True)
    launches = {}

    def counted(label, fn, *args):
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        result = fn(*args)
        torch.cuda.synchronize()
        launches[label] = dict(kernels.LAUNCHES)
        return result, time.perf_counter() - t0

    # train: 3 float32 steps (async cadence save at counter 2), then 2
    # bfloat16 steps resumed from it (--train_size: 2 batches an epoch)
    async_saves = []
    save_async = ckpt.save_async

    def recorded(*args, **kw):
        async_saves.append(args[1])
        return save_async(*args, **kw)

    ckpt.save_async = recorded
    try:
        for label, flags, dtype, steps in (
                ('lifecycle train float32', [], torch.float32, 3),
                ('lifecycle train bfloat16 resumed',
                 ['--dtype', 'bfloat16', '--train_size', str(2 * b)],
                 torch.bfloat16, 2)):
            with classifier_switches(True):
                state, wall = counted(label, train_cli.main,
                                      base + options + flags)
            want = expected_launches(LIFECYCLE, dtype, True, steps)
            check_launches(label, launches[label], want)
            print(f'{label}: {steps} steps of batch {b} ({LIFECYCLE}, '
                  f'switches on) in {wall:.3f} s with start-up (host clock); '
                  f'launches per step K1 {want["instance_norm_act"] / steps:g}'
                  f', K2 {want["instance_norm_act_bwd"] / steps:g}, K5 '
                  f'{want["prelu_bwd"] / steps:g}, K3 '
                  f'{want["mru_gate_blend"] / steps:g}, K4 '
                  f'{want["mru_gate_bwd"] / steps:g} [{card}]')
    finally:
        ckpt.save_async = save_async
    check(async_saves == [2] and ckpt.steps(ckpt_dir) == [2],
          f'async saves {async_saves}, checkpoints {ckpt.steps(ckpt_dir)}')
    check(os.path.exists(os.path.join(ckpt_dir, 'EdgeGAN-Model-2',
                                      'state.npz')), 'no state.npz')
    check(read_resume_markers(log) == [2],
          f'resume markers {read_resume_markers(log)}')
    rows = read_metrics(log)
    check([r['step'] for r in rows] == [2, 3, 4],
          f'steps logged {[r["step"] for r in rows]}')
    for r in rows:
        vals = {k: v for k, v in r.items() if k not in ('step', 'epoch')}
        check(len(vals) == 11 and all(np.isfinite(v) for v in vals.values()),
              f'metrics at step {r["step"]}: {vals}')
    print('  last metrics: ' + json.dumps(rows[-1]))
    loaded, counter, trees = ckpt.load_raw(ckpt_dir)
    check(loaded and counter == 2, f'load_raw: {loaded} {counter}')
    moved = max(float(np.abs(a - b0).max()) for a, b0 in zip(
        _leaves(trees['aux']['D2']), _leaves(aux0['D2'])))
    dtypes = {a.dtype for a in _leaves(trees['aux']['D2'])}
    check(moved > 0 and dtypes == {np.dtype(np.float32)},
          f'the classifier u: largest change {moved}, dtypes {dtypes}')
    print(f'  checkpoint 2: the classifier u moved by up to {moved:.3g} '
          f'(float32) after 1 step of update_sn')

    # test: batch 1 and batched, from the checkpoint
    half = w // 2
    test_dir = os.path.join(out, 'life', 'test_output', 'ds')
    n_files = len(valid) + 2
    for label, flags, forwards in (
            ('lifecycle test batch 1', [], len(valid)),
            ('lifecycle test --test_batch_size 16',
             ['--test_batch_size', '16'], -(-n_files // 16))):
        shutil.rmtree(test_dir, ignore_errors=True)
        _, wall = counted(label, test_cli.main, base + flags)
        got = sorted(os.path.relpath(os.path.join(d, f), test_dir)
                     for d, _, fs in os.walk(test_dir) for f in fs)
        check(got == valid, f'{label}: wrote {len(got)} files, expected '
              f'{len(valid)}: {sorted(set(got) ^ set(valid))[:4]}')
        shapes = {np.asarray(Image.open(os.path.join(test_dir, f))).shape
                  for f in got}
        check(shapes == {(h, w + 2 * half, 3)}, f'{label}: shapes {shapes}')
        k1 = launches[label]
        check(k1['instance_norm_act'] == k1['instance_norm_act.lane_group']
              == 6 * forwards and k1['instance_norm_act_bwd'] == 0,
              f'{label}: launches {k1} for {forwards} forwards')
        print(f'{label}: {len(valid)} of {n_files} files written (the class '
              f'id {config.num_classes} and "misc" skipped), {forwards} '
              f'forwards, K1 {k1["instance_norm_act"]} launches, all in '
              f'lane groups, in {wall:.3f} s with start-up (host clock) '
              f'[{card}]')
        if not flags:
            # batch 1's first file against the port's forward on the CPU
            # from the same checkpoint, with the CLI's first noise draw
            from edgegan_torch.data.dataset import Dataset
            from edgegan_torch.utils.images import bytescale, inverse_transform
            tcfg = Config().derive('test')
            nets = bridge.load_jax_params(Networks(tcfg), trees['params'],
                                          trees['aux'])
            images, files = Dataset(
                root, 'ds', float('inf'), 1, dict(
                    input_height=h, input_width=w, output_height=h,
                    output_width=w, crop=False, grayscale=False),
                phase='test')[0]
            ids, _ = test_cli.classes_padded(files, tcfg.num_classes)
            eps = torch.randn(2, generator=torch.Generator().manual_seed(
                6666))
            with torch.no_grad():
                edge, image = make_test_forward(nets, tcfg)(
                    torch.from_numpy(images), torch.from_numpy(ids), eps)
            want = bytescale(inverse_transform(test_cli.compose(
                tcfg, images, edge.numpy(), image.numpy())[0]))
            png = np.asarray(Image.open(os.path.join(
                test_dir, test_cli.name_with_class(files[0]))))
            diff = int(np.abs(png.astype(int) - want.astype(int)).max())
            print(f'  {test_cli.name_with_class(files[0])}: card PNG vs the '
                  f'CPU forward, largest byte difference {diff} (limit 1)')
            check(diff <= 1, 'the test CLI output differs from the CPU '
                  'forward')

    # serve: `serve.main` without --weights, from the checkpoint directory
    held, ready, errors = {}, threading.Event(), []
    make_server = serve.make_server

    def capture(cfg, batcher, port, host):
        held.update(server=make_server(cfg, batcher, 0, host),
                    batcher=batcher)
        ready.set()
        return held['server']

    def run():
        try:
            serve.main(['--outputsroot', out, '--name', 'life',
                        '--serve_batch', '16'])
        except BaseException as e:  # reported below
            errors.append(e)
            ready.set()

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    serve.make_server = capture
    thread = threading.Thread(target=run, daemon=True)
    t0 = time.perf_counter()
    thread.start()
    try:
        check(ready.wait(600) and not errors, f'serve.main: {errors}')
        port = held['server'].server_address[1]
        rng = np.random.RandomState(4)
        raw = rng.uniform(-1, 1, (8, h, w, 3)).astype('<f4')
        ids = ','.join(str(i % config.num_classes) for i in range(8))
        status, body = _post(port, f'/generate?class_id={ids}&raw=1&n=8',
                             raw.tobytes())
        with open(os.path.join(root, 'ds', 'test', valid[0]), 'rb') as f:
            png_status, png = _post(port, '/generate?class_id=0', f.read())
    finally:
        serve.make_server = make_server
        if 'server' in held:
            held['server'].shutdown()
        thread.join(120)
    wall = time.perf_counter() - t0
    held['server'].server_close()
    check(not thread.is_alive() and not errors,
          f'serve.main did not return: {errors}')
    launches['lifecycle serve'] = counts = dict(kernels.LAUNCHES)
    batches = held['batcher']._n_dispatched
    check(status == 200 and png_status == 200,
          f'HTTP {status} (raw n=8), {png_status} (PNG)')
    photos = np.frombuffer(body, '<f4').reshape(8, h, half, 3)
    check(bool(np.isfinite(photos).all()) and np.abs(photos).max() <= 1,
          'served photos not finite in [-1, 1]')
    check(np.asarray(Image.open(io.BytesIO(png))).shape == (h, half, 3),
          'PNG reply shape')
    check(counts['instance_norm_act'] == counts[
        'instance_norm_act.lane_group'] == 6 * batches and batches >= 2,
        f'serve: launches {counts} for {batches} batches')
    print(f'lifecycle serve: checkpoint 2 from {ckpt_dir}, warm-up, a raw '
          f'n=8 and a PNG request answered 200 in {wall:.3f} s with '
          f'start-up (host clock); {batches} batches, K1 '
          f'{counts["instance_norm_act"]} launches [{card}]')
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _one_step(config, params, aux, device, images, z, draws):
    """One training step of the port on `device` from the JAX-layout
    weights; returns (metrics, params after the step)."""
    import torch

    from edgegan_torch import bridge
    from edgegan_torch.train.networks import Networks
    from edgegan_torch.train.state import create_train_state
    from edgegan_torch.train.step import Draws, make_train_step

    nets = bridge.load_jax_params(Networks(config, critics=True), params,
                                  aux).to(device)
    state = create_train_state(nets)
    step = make_train_step(nets, config)
    t = {k: torch.from_numpy(v).to(device) for k, v in draws['alpha'].items()}
    d = Draws(alpha=t, eps=torch.tensor(draws['eps'], device=device),
              z=torch.from_numpy(draws['z']).to(device))
    _, metrics = step(state, torch.from_numpy(images).to(device),
                      torch.from_numpy(z).to(device), d)
    out, _ = bridge.export_jax_params(nets)
    return {k: float(v) for k, v in metrics.items()}, out


def _step_case(config, seed: int = 1):
    """One step's inputs for `_one_step` at `config`'s batch: weights
    from `seed`, images, class column and draws from a generator seeded
    2, and a function that moves an array by about one part in 1e6."""
    import numpy as np

    from edgegan_torch import bridge
    params, aux = bridge.random_jax_params(config, seed, critics=True)
    rng = np.random.RandomState(2)
    b, h, w = config.batch_size, config.output_height, config.output_width
    images = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    z = rng.randint(0, config.num_classes, (b, 1)).astype(np.float32)
    draws = dict(alpha={n: rng.rand(b).astype(np.float32)
                        for n in ('D', 'D_patch2', 'D_patch3')},
                 eps=np.float32(rng.randn()),
                 z=rng.randn(b, config.z_dim).astype(np.float32))

    def jitter(a):
        return (a * (1 + 1e-6 * rng.randn(*a.shape))).astype(np.float32)
    return params, aux, images, z, draws, jitter


def _held_to_cpu(label, got, cpu, jittered, params, names=('card', 'cpu')):
    """Prints and checks one card step `got` = (metrics, params) against
    the CPU step `cpu` (or any two steps, printed under `names`): each
    metric within 3x the step's own sensitivity + 1e-4 of max(1,
    |value|), each network's update within 3x it + 1e-3 of its norm. The
    sensitivity is the largest distance of a jittered run from its own
    unjittered run, over `jittered`: ((run, base), ...). Returns whether
    every difference is within its limit."""
    import numpy as np
    a, b = names

    def flat(p, net):
        return np.concatenate([a.ravel() for a in _leaves(p[net])])

    ok = True
    got_m, got_p = got
    cpu_m, cpu_p = cpu
    print(f' {a} step {label}:')
    for k in sorted(cpu_m):
        diff = abs(got_m[k] - cpu_m[k])
        own = max(abs(run[0][k] - base[0][k]) for run, base in jittered)
        limit = 3 * own + 1e-4 * max(1.0, abs(cpu_m[k]))
        ok &= diff <= limit
        print(f'  {k}: {a} {got_m[k]:.6g} {b} {cpu_m[k]:.6g}, diff '
              f'{diff:.3g}, under 1e-6 input jitter {own:.3g}, limit '
              f'{limit:.3g}')
    for net in sorted(cpu_p):
        start = np.concatenate([a.ravel() for a in _leaves(params[net])])
        upd = {a: flat(got_p, net) - start, b: flat(cpu_p, net) - start}
        norm = np.linalg.norm(upd[b])
        diff = np.linalg.norm(upd[a] - upd[b])
        own = max(np.linalg.norm(flat(run[1], net) - flat(base[1], net))
                  for run, base in jittered)
        limit = 3 * own + 1e-3 * norm
        ok &= diff <= limit
        print(f'  {net} update: |{b}| {norm:.4g}, |{a} - {b}| {diff:.3g} '
              f'(max abs {np.abs(upd[a] - upd[b]).max():.3g}), '
              f'jittered run vs its own {own:.3g}, limit {limit:.3g}')
    return ok


def card_vs_cpu_phase(card: str):
    """One full-width step at batch 4 on the card and on the CPU from the
    same weights and draws. The GAN's step amplifies rounding (the gradient
    penalty differentiates the critics' lrelu kinks and instance norms
    twice), so the limit on each difference is set from the CPU's own
    sensitivity, measured in the same run: the CPU step again with the
    images and the latents moved by about one part in 1e6. The card step
    runs twice, with the classifier switches off and on (K5, K3 and K4,
    which must launch 42, 12 and 12 times), each against the same CPU
    step with the switches off."""
    from edgegan_torch.core.config import Config
    from edgegan_torch.ops import kernels

    config = Config(batch_size=4).derive('train')
    params, aux, images, z, draws, jitter = _step_case(config)
    t0 = time.perf_counter()
    with classifier_switches(False):
        card_run = _one_step(config, params, aux, 'cuda', images, z, draws)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    with classifier_switches(True):
        on_run = _one_step(config, params, aux, 'cuda', images, z, draws)
    counts = dict(kernels.LAUNCHES)
    with classifier_switches(False):
        cpu_run = _one_step(config, params, aux, 'cpu', images, z, draws)
        jit_run = _one_step(config, params, aux, 'cpu', jitter(images), z,
                            dict(draws, z=jitter(draws['z'])))
    print(f'card vs CPU: 4 steps in {time.perf_counter() - t0:.1f} s '
          f'[{card}]')
    check((counts['prelu_bwd'], counts['mru_gate_blend'],
           counts['mru_gate_bwd']) == (K5_PER_STEP, K3_PER_STEP,
                                       K4_PER_STEP)
          and all(counts[k] == 0 for k in MULTI_PASS),
          f'the switched card step launched {counts}')
    ok = True
    for label, got in (('with the classifier switches off', card_run),
                       ('with the classifier switches on', on_run)):
        ok &= _held_to_cpu(label, got, cpu_run, [(jit_run, cpu_run)],
                           params)
    check(ok, 'a card step differs from the CPU step beyond the limits')


def step_time_phase(card: str, update_mode: str = 'faithful'):
    """Time per training step (`update_mode` 'faithful' or 'fast') at the
    default batch 64 on a staged batch, in float32 and bfloat16, each with
    the classifier switches off and on in turns (STEP_TURNS: off, on, on,
    off; 5 steps a turn, 10 per setting), then the optimizer-group split
    and the profile of each of the four settings. Returns {(dtype,
    switches): (CUDA-event ms, host ms, peak GiB)} and the profiles' device
    ms per step by kernel (None where the profile recorded fewer of its
    kernels than were launched), keyed the same way."""
    import numpy as np
    import torch

    from edgegan_torch import bridge
    from edgegan_torch.core.config import Config
    from edgegan_torch.ops import kernels
    from edgegan_torch.train.networks import Networks
    from edgegan_torch.train.state import create_train_state
    from edgegan_torch.train.step import make_draws, make_train_step

    rng = np.random.RandomState(3)
    times, profiles = {}, {}
    spans = GROUP_SPANS[update_mode]
    for dtype in ('float32', 'bfloat16'):
        config = Config(dtype=dtype, update_mode=update_mode).derive('train')
        b, h, w = config.batch_size, config.output_height, config.output_width
        nets = bridge.load_jax_params(Networks(config, critics=True),
                                      *bridge.random_jax_params(
                                          config, 0, critics=True)).to('cuda')
        state = create_train_state(nets)
        step = make_train_step(nets, config)
        # the batch as the CLI hands it over: bfloat16 images in bfloat16
        images = torch.from_numpy(rng.uniform(-1, 1, (b, h, w, 3)).astype(
            np.float32)).to('cuda', getattr(torch, dtype))
        z = torch.from_numpy(rng.randint(0, config.num_classes, (b, 1))
                             .astype(np.float32)).cuda()
        gen = torch.Generator(device='cuda').manual_seed(0)
        draws = make_draws(config, b, gen, 'cuda')

        def one():
            step(state, images, z, draws)

        turns = {False: [], True: []}
        for switches in STEP_TURNS:
            with classifier_switches(switches):
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(one, 5, warmup=1)
                t0 = time.perf_counter()
                for _ in range(3):
                    one()
                    torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) / 3 * 1e3
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                turns[switches].append((ms, host_ms, peak))
        for switches, got in turns.items():
            ms, host_ms, peak = (float(np.mean(v)) for v in zip(*got))
            times[(dtype, switches)] = (ms, host_ms, max(v[2] for v in got))
            print(f'time per training step at batch {b} {dtype}, classifier '
                  f'switches {"on" if switches else "off"} ({update_mode}, '
                  f'{len(spans)} updates): {ms:.3f} ms (CUDA events, '
                  f'{len(got)} turns of 5 back to back: '
                  + ', '.join(f'{t[0]:.3f}' for t in got)
                  + f'), {host_ms:.3f} ms one at a time (host clock, '
                  f'{3 * len(got)} steps); peak device memory '
                  f'{times[(dtype, switches)][2]:.2f} GiB [{card}]')
        for switches in (False, True):
            label = (f'{update_mode} {dtype}, switches '
                     f'{"on" if switches else "off"}')
            with classifier_switches(switches):
                print(f'{label}:')
                group_split(card, one, spans)
                for k in kernels.LAUNCHES:
                    kernels.LAUNCHES[k] = 0
                by_name, calls = profile_steps(
                    card, f'training step batch {b} {label}', one,
                    n=PROFILED_STEPS, unit='step')
                launched = {k: v / PROFILED_STEPS
                            for k, v in kernels.LAUNCHES.items()}
            want = expected_launches(update_mode, getattr(torch, dtype),
                                     switches)
            check_launches(f'{label} (per step)', launched, want)
            for name in ('mru_gate_blend', 'mru_gate_bwd'):
                print(f'  {name}: {launched[name]:g} launches per step, by '
                      f'variant ' + str({v: launched[f'{name}.{v}'] for v in
                                         kernels.GATE_VARIANTS})
                      + f' ({label}) [{card}]')
            per_step = {}
            # (profile name, its kernels' names, LAUNCHES key, kernels a
            # launch)
            for kname, parts, key, per_launch in (
                    ('instance_norm_act_fwd', ['instance_norm_act_fwd'],
                     'instance_norm_act', 1),
                    ('instance_norm_act_bwd', ['instance_norm_act_bwd'],
                     'instance_norm_act_bwd', 1),
                    ('prelu_bwd', ['prelu_bwd_kernel', 'sum_partials'],
                     'prelu_bwd', 2),
                    ('mru_gate_fwd', ['mru_gate_fwd'], 'mru_gate_blend', 1),
                    ('mru_gate_bwd', ['mru_gate_bwd'], 'mru_gate_bwd', 1)):
                ms = sum(v for k, v in by_name.items()
                         if any(p in k for p in parts))
                n_calls = sum(v for k, v in calls.items()
                              if any(p in k for p in parts))
                want = per_launch * launched[key]
                if round(n_calls * PROFILED_STEPS) != round(
                        want * PROFILED_STEPS):
                    per_step[kname] = None
                    print(f'  {kname}: device time not measured: the profile '
                          f'recorded {n_calls:g} of its {want:g} kernels per '
                          f'step ({label}) [{card}]')
                    continue
                per_step[kname] = ms
                print(f'  {kname}: {ms:.4f} ms of device time per step in '
                      f'{n_calls:g} kernels, all that were launched '
                      f'(profile, {label}) [{card}]')
            profiles[(dtype, switches)] = per_step
    return times, profiles


# the variants phase: each architecture flag away from its default, alone
# (batch norm in all three networks' blocks at once)
VARIANTS = {'resnet G': dict(if_resnet_g=True),
            'resnet D': dict(if_resnet_d=True),
            'convnet E': dict(if_resnet_e=False),
            'batch norm in G, D and E': dict(G_norm='batch', D_norm='batch',
                                             E_norm='batch')}
HIRES = dict(input_height=128, input_width=256, output_height=128,
             output_width=256)
TIMED_STEPS = 5


def _flags(overrides):
    """CLI flags for Config `overrides` (a False bool as --no<flag>)."""
    out = []
    for k, v in overrides.items():
        out += ([f'--no{k}'] if v is False else [f'--{k}', str(v)])
    return out


def _timed_steps(config, switches: bool, seed: int = 3):
    """`TIMED_STEPS` training steps of `config` at its batch on the card
    after one warm-up step, on a staged batch: (CUDA-event ms per step,
    peak device GiB, `kernels.LAUNCHES` over all TIMED_STEPS + 1 steps)."""
    import numpy as np
    import torch

    from edgegan_torch import bridge
    from edgegan_torch.ops import kernels
    from edgegan_torch.train.networks import Networks
    from edgegan_torch.train.state import create_train_state
    from edgegan_torch.train.step import make_draws, make_train_step

    rng = np.random.RandomState(seed)
    b, h, w = config.batch_size, config.output_height, config.output_width
    nets = bridge.load_jax_params(Networks(config, critics=True),
                                  *bridge.random_jax_params(
                                      config, 0, critics=True)).to('cuda')
    state = create_train_state(nets)
    step = make_train_step(nets, config)
    images = torch.from_numpy(rng.uniform(-1, 1, (b, h, w, 3)).astype(
        np.float32)).to('cuda', getattr(torch, config.dtype))
    z = torch.from_numpy(rng.randint(0, config.num_classes, (b, 1)).astype(
        np.float32)).cuda()
    draws = make_draws(config, b, torch.Generator(device='cuda').manual_seed(
        0), 'cuda')
    with classifier_switches(switches):
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(state, images, z, draws), TIMED_STEPS,
                     warmup=1)
        counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del nets, state, step
    torch.cuda.empty_cache()
    return ms, peak, counts


def _batch64_inputs(shape, dtype, seed: int):
    """x and g of NCHW `shape` on the card in `dtype`, made on the CPU
    from `seed`; plane (0, 0) of x constant (var == 0)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) * 2 + 0.5
    x[0, 0] = 3.0
    g = torch.randn(shape, generator=gen)
    return x.to('cuda', dtype), g.to('cuda', dtype)


def per_call_times(card: str, label: str, key: str, match: str, fn, args,
                   tensors: int, ops_per_element: int, plain, previous=None,
                   outs=()):
    """One kernel's time per call on `args` (the first its output's
    shape): device time from the profile of kernels named `match` (warm
    and cold L2) and CUDA events, beside its bound (`tensors` tensors of
    that shape moved once, `ops_per_element` float32 operations) and the
    plain version's time (`plain()`); with `previous`, the earlier design's
    device time on the same inputs (`previous(*args, *outputs)`, outputs
    shaped as `outs`). Prints and returns them."""
    import torch
    n, size = args[0].numel(), args[0].element_size()
    warm, cold = device_us(fn, match, cold_copies(
        lambda: tuple(t.clone() for t in args), tensors * n * size))
    ms = cuda_ms(lambda: fn(*args), 20)
    plain_ms = cuda_ms(plain, 5, warmup=1)
    by_bytes, by_ops = bounds_ms(n, size, tensors, ops_per_element)
    extra, said = {}, ''
    if previous is not None:
        pw, pc = device_us(previous, match, cold_copies(
            lambda: tuple(t.clone() for t in args)
            + tuple(torch.empty_like(t) for t in outs), tensors * n * size))
        extra = dict(previous_ms=_ms(pw), previous_cold_ms=_ms(pc))
        said = (f', multi-pass (the earlier design) device {_us(pw)} warm / '
                f'{_us(pc)} cold L2')
    print(f'{label}: {key}: device {_us(warm)} warm / {_us(cold)} cold L2 '
          f'(profile), {ms:.4f} ms (CUDA events), bound '
          f'{max(by_bytes, by_ops):.4f} ms (bytes {by_bytes:.4f}, operations '
          f'{by_ops:.4f}), plain {plain_ms:.4f} ms{said}; held to plain, two '
          f'runs bitwise equal [{card}]')
    return dict(ms=ms, device_ms=_ms(warm), cold_ms=_ms(cold),
                bound_ms=max(by_bytes, by_ops),
                bound_by='bytes' if by_bytes >= by_ops else 'operations',
                plain_ms=plain_ms, **extra)


def in_planes_timed(card: str, label: str, shapes):
    """K1 and K2 at batch 64 on each distinct (C, H, W) of `shapes`,
    float32 and bfloat16: held to their plain versions by
    `in_checks.check_kernels` (TOL and K2_TOL, three activations, two runs
    bitwise equal, in the variant `instance_norm_plan` picks, the plain
    versions within the limits of float64), then timed per call with relu:
    device time from the profile (warm and cold L2) and CUDA events,
    beside the bound, the plain version's time, where the plan picks a
    block or a ragged group the multi-pass kernel's device time on the
    same inputs (the earlier design, `previous_design_us`), and F.relu of
    F.instance_norm forward and backward (a yardstick: eps inside the
    sqrt; None at a 1x1 plane, which it refuses). Returns ({'K1', 'K2'}:
    max abs error, {'K1 float32 [64, C, H, W] variant relu': {...ms...},
    ...})."""
    import torch
    import torch.nn.functional as F

    from edgegan_torch.ops import _build, in_checks, kernels
    lib = _build.library()
    err = {'K1': 0.0, 'K2': 0.0}
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        for c, h, w in dict.fromkeys(shapes):
            shape = (64, c, h, w)
            x, g = _batch64_inputs(shape, dtype, 11)
            variant = kernels.instance_norm_plan(
                h * w, dtype, x.data_ptr() | g.data_ptr())[0]
            e1, e2 = in_checks.check_kernels(
                x, g, TOL[dname], K2_TOL[dname], variant,
                label=f'{label} {dname} {list(shape)}')
            err['K1'], err['K2'] = max(err['K1'], e1), max(err['K2'], e2)
            xr = x.detach().requires_grad_(True)
            yr = F.relu(F.instance_norm(xr)) if h * w > 1 else None
            for kname, match, fn, args, tensors, ops, plain, entry, yard in (
                    ('K1', 'instance_norm_act_fwd',
                     lambda t: kernels.instance_norm_act(t, 'relu'), (x,), 2,
                     K1_OPS_PER_ELEMENT,
                     lambda: kernels.instance_norm_act_plain(x, 'relu'),
                     lib.edgegan_instance_norm_act_fwd,
                     lambda: F.relu(F.instance_norm(x))),
                    ('K2', 'instance_norm_act_bwd',
                     lambda t, u: kernels.instance_norm_act_bwd(t, u, 'relu'),
                     (x, g), 3, K2_OPS_PER_ELEMENT,
                     lambda: kernels.instance_norm_act_bwd_plain(x, g,
                                                                 'relu'),
                     lib.edgegan_instance_norm_act_bwd,
                     lambda: torch.autograd.grad(yr, xr, g,
                                                 retain_graph=True))):
                key = f'{kname} {dname} {list(shape)} {variant} relu'
                t = per_call_times(card, label, key, match, fn, args,
                                   tensors, ops, plain)
                t['yardstick_ms'] = (cuda_ms(yard, 20) if yr is not None
                                     else None)
                extra = 'F.instance_norm+relu' + (
                    '' if kname == 'K1' else ' backward') + (
                    ' refuses a 1x1 plane' if yr is None else
                    f' {t["yardstick_ms"]:.4f} ms (CUDA events; a '
                    f'yardstick: eps inside the sqrt)')
                if variant in ('block', 'ragged'):
                    warm, cold = previous_design_us(match, entry, *args)
                    t['previous_ms'], t['previous_cold_ms'] = (_ms(warm),
                                                               _ms(cold))
                    extra = (f'multi-pass (the earlier design) device '
                             f'{_us(warm)} warm / {_us(cold)} cold L2 '
                             f'(profile); ' + extra)
                print(f'{label}: {key}: {extra} [{card}]')
                times[key] = t
    return err, times


def variants_phase(card: str, tmp: str):
    """Each model variant of VARIANTS at full width on the card: one step
    at batch 4 against the port's CPU step from the same weights and
    draws, each within 3x the step's own sensitivity, measured on both
    devices (each step again on inputs moved by one part in 1e6); the
    faithful step at batch 64 in float32 timed over TIMED_STEPS steps
    after a warm-up (CUDA events, peak memory), its K1/K2 launches per
    variant as `expected_launches` plans them. For the convnet encoder
    also: K1 and K2 on its six normed blocks' planes at batch 64 (held and
    timed, `in_planes_timed`; the 1x1 planes in ragged groups),
    and the CLI path: 2 steps (a save at counter 2), a resume that takes
    1 more, and `cli.test` on one test pair from the checkpoint (its K1
    launches for one forward). Returns (launches by run, step times, K1/K2
    per call, max errors)."""
    import math

    import numpy as np
    import torch

    from edgegan_torch import checkpoint as ckpt
    from edgegan_torch.cli import test as test_cli
    from edgegan_torch.cli import train as train_cli
    from edgegan_torch.core.config import Config
    from edgegan_torch.ops import kernels
    from edgegan_torch.utils.metrics_io import (read_metrics,
                                                read_resume_markers)

    launches, steps, ok = {}, {}, True
    for label, overrides in VARIANTS.items():
        small = Config(batch_size=4, **overrides).derive('train')
        params, aux, images, z, draws, jitter = _step_case(small)
        jdraws = dict(draws, z=jitter(draws['z']))
        jimages = jitter(images)
        t0 = time.perf_counter()
        runs = {dev: (_one_step(small, params, aux, dev, images, z, draws),
                      _one_step(small, params, aux, dev, jimages, z, jdraws))
                for dev in ('cuda', 'cpu')}
        print(f'{label}: card vs CPU, 4 steps at batch 4 in '
              f'{time.perf_counter() - t0:.1f} s [{card}]')
        ok &= _held_to_cpu(f'{label} (batch 4)', runs['cuda'][0],
                           runs['cpu'][0], [runs['cpu'][::-1],
                                            runs['cuda'][::-1]], params)

        config = Config(**overrides).derive('train')
        ms, peak, counts = _timed_steps(config, False)
        want = expected_launches('faithful', torch.float32, False,
                                 TIMED_STEPS + 1, config)
        check_launches(f'{label} ({TIMED_STEPS + 1} steps)', counts, want)
        launches[f'variant {label}'] = counts
        steps[label] = dict(ms=ms, peak_gib=peak)
        per_step = {k: v // (TIMED_STEPS + 1) for k, v in counts.items()
                    if v and k.startswith('instance_norm')}
        print(f'{label}: faithful step at batch {config.batch_size} float32 '
              f'{ms:.3f} ms (CUDA events, {TIMED_STEPS} steps after 1), peak '
              f'device memory {peak:.2f} GiB; K1/K2 launches per step '
              f'{per_step} [{card}]')
    check(ok, 'a variant card step differs from the CPU step beyond the '
          'limits')

    # the convnet encoder's planes, and its CLI path
    econfig = Config(if_resnet_e=False).derive('train')
    err, per_call = in_planes_timed(card, 'convnet E planes',
                                    in_planes(econfig)[1])
    b, h, w = econfig.batch_size, econfig.output_height, econfig.output_width
    root = os.path.join(tmp, 'variants')
    write_dataset(root, b, econfig.num_classes, h, w)
    os.makedirs(os.path.join(root, 'ds', 'test', '0'))
    shutil.copy(os.path.join(root, 'ds', 'train', '0', '0000.png'),
                os.path.join(root, 'ds', 'test', '0', 'pair.png'))
    valid = [os.path.join('0', 'pair.png')]
    out = os.path.join(root, 'outputs')
    base = ['--dataroot', root, '--dataset', 'ds', '--outputsroot', out,
            '--name', 'convnet_e'] + _flags(VARIANTS['convnet E'])
    log = os.path.join(out, 'convnet_e', 'logs', 'metrics.jsonl')
    for run, epochs, n in (('convnet E train', 2, 2),
                           ('convnet E resumed', 1, 1)):
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        train_cli.main(base + ['--epoch', str(epochs),
                               '--save_checkpoint_frequency', '3'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[run] = dict(kernels.LAUNCHES)
        want = expected_launches('faithful', torch.float32, False, n,
                                 econfig)
        check_launches(run, launches[run], want)
        print(f'{run}: {n} steps of batch {b} in {wall:.3f} s with start-up '
              f'(host clock) [{card}]')
    rows = read_metrics(log)   # step 3: the resumed run's line
    check(read_resume_markers(log) == [2]
          and [r['step'] for r in rows] == [2, 3]
          and ckpt.steps(os.path.join(out, 'convnet_e', 'checkpoints'))
          == [2], f'convnet E CLI: steps {[r["step"] for r in rows]}, '
          f'resumes {read_resume_markers(log)}')
    check(all(math.isfinite(v) for r in rows for v in r.values()),
          f'convnet E CLI: metrics {rows}')
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    test_cli.main(base)
    launches['convnet E test'] = dict(kernels.LAUNCHES)
    want = forward_launches(Config(if_resnet_e=False).derive('test'),
                            torch.float32)
    check_launches('convnet E test', launches['convnet E test'], want)
    test_dir = os.path.join(out, 'convnet_e', 'test_output', 'ds')
    got = sorted(os.path.relpath(os.path.join(d, f), test_dir)
                 for d, _, fs in os.walk(test_dir) for f in fs)
    check(got == valid, f'convnet E test wrote {got}, expected {valid}')
    print(f'convnet E: cli.test from checkpoint 2 wrote {got}; K1 '
          f'{want["instance_norm_act"]} launches for one forward '
          f'({want["instance_norm_act.ragged"]} in ragged groups: the 1x1 '
          f'planes) [{card}]')
    return launches, steps, per_call, err


def hires_phase(card: str, tmp: str):
    """The hires configuration (HIRES: 128x128 halves, 128x256 pairs;
    BASELINE config 5) at batch 64, faithful, both classifier switches on:
    `cli.train` for 2 steps in float32 on synthetic 128x256 pairs (every
    metric finite, launches as planned: g_dconv_3's 64x64 planes in K1/K2's
    block variant, MRU unit 1's 128x128 gate in K3/K4's cluster
    variant); the step timed in
    float32 and bfloat16 (CUDA events over TIMED_STEPS steps after a
    warm-up, peak memory); K1/K2 on g_dconv_3's [64, 64, 64, 64] and
    K3/K4 on unit 1's [64, 8, 128, 128] held to their plain versions
    (two runs bitwise equal) and timed per call beside their bounds and
    the multi-pass kernel on the same inputs, checked against the planned
    variant first (K1/K2 also beside F.instance_norm+relu).
    Returns (launches by run, step times, per-call times, max errors)."""
    import math

    import torch

    from edgegan_torch.cli import train as train_cli
    from edgegan_torch.core.config import Config
    from edgegan_torch.ops import gate_checks, kernels
    from edgegan_torch.utils.metrics_io import read_metrics

    config = Config(**HIRES).derive('train')
    b, h, w = config.batch_size, config.output_height, config.output_width
    root = os.path.join(tmp, 'hires')
    write_dataset(root, b, config.num_classes, h, w)
    launches = {}
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with classifier_switches(True):
        train_cli.main(['--dataroot', root, '--dataset', 'ds',
                        '--outputsroot', os.path.join(root, 'outputs'),
                        '--name', 'hires', '--epoch', '2']
                       + _flags(HIRES))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches['hires train float32, switches on'] = counts = dict(
        kernels.LAUNCHES)
    want = expected_launches('faithful', torch.float32, True, 2, config)
    check_launches('hires CLI', counts, want)
    rows = read_metrics(os.path.join(root, 'outputs', 'hires', 'logs',
                                     'metrics.jsonl'))
    check([r['step'] for r in rows] == [2, 3] and all(
        math.isfinite(v) for r in rows for v in r.values()),
        f'hires CLI metrics: {rows}')
    print(f'hires CLI: 2 steps of batch {b} at {h}x{w} in {wall:.3f} s with '
          f'start-up (host clock); per step K1 {want["instance_norm_act"] / 2:g}'
          f' ({want["instance_norm_act.block"] / 2:g} block), K2 '
          f'{want["instance_norm_act_bwd"] / 2:g} '
          f'({want["instance_norm_act_bwd.block"] / 2:g} block), '
          f'K5 {want["prelu_bwd"] / 2:g}, K3 {want["mru_gate_blend"] / 2:g} '
          f'({want["mru_gate_blend.cluster"] / 2:g} cluster), K4 '
          f'{want["mru_gate_bwd"] / 2:g} '
          f'({want["mru_gate_bwd.cluster"] / 2:g} cluster) [{card}]')
    print('  last metrics: ' + json.dumps(rows[-1]))

    steps = {}
    for dtype in ('float32', 'bfloat16'):
        dconfig = Config(dtype=dtype, **HIRES).derive('train')
        ms, peak, counts = _timed_steps(dconfig, True)
        want = expected_launches('faithful', getattr(torch, dtype), True,
                                 TIMED_STEPS + 1, dconfig)
        check_launches(f'hires {dtype}', counts, want)
        steps[dtype] = dict(ms=ms, peak_gib=peak)
        print(f'hires faithful step at batch {b} {dtype}, switches on: '
              f'{ms:.3f} ms (CUDA events, {TIMED_STEPS} steps after 1), peak '
              f'device memory {peak:.2f} GiB [{card}]')

    err, per_call = in_planes_timed(card, 'hires g_dconv_3', [(64, 64, 64)])
    gate_err = {'K3': 0.0, 'K4': 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        shape = (64,) + gate_shapes(config)[0]
        rg, ht, img, g = gate_checks.gate_inputs('cuda', shape, dtype, seed=12)
        addr = rg.data_ptr() | ht.data_ptr() | img.data_ptr() | g.data_ptr()
        plan = kernels.gate_plan(shape[2] * shape[3], dtype, addr)
        variant = plan[0]
        check(variant == 'cluster', f'unit 1 at hires: {variant}')
        e3, e4 = gate_checks.check_gate(
            rg, ht, img, g, TOL[dname], K2_TOL[dname], variant,
            label=f'hires unit 1 {dname} {list(shape)}')
        gate_err['K3'] = max(gate_err['K3'], e3)
        gate_err['K4'] = max(gate_err['K4'], e4)
        previous_matches(rg, ht, img, g, dname, variant)
        for kname, match, fn, args, tensors, ops, plain, prev, outs in (
                ('K3', 'mru_gate_fwd', kernels.mru_gate_blend, (rg, ht, img),
                 4, K3_OPS_PER_ELEMENT,
                 lambda: kernels.mru_gate_blend_plain(rg, ht, img),
                 lambda *t: gate_previous(True, *t), (rg,)),
                ('K4', 'mru_gate_bwd', kernels.mru_gate_bwd, (rg, img, g), 5,
                 K4_OPS_PER_ELEMENT,
                 lambda: kernels.mru_gate_bwd_plain(rg, img, g),
                 lambda *t: gate_previous(False, *t), (rg, img))):
            key = (f'{kname} {dname} {list(shape)} {variant} '
                   f'{plan[1] // 256}x{plan[2]}')
            per_call[key] = per_call_times(card, 'hires unit 1', key, match,
                                           fn, args, tensors, ops, plain,
                                           prev, outs)
    gate_err['K5'] = k5_hires(card, per_call)
    return launches, steps, per_call, {**err, **gate_err}


def k5_hires(card: str, per_call: dict) -> float:
    """K5 at the hires classifier's 9 PReLU shapes (PRELU_SHAPES at
    128x128 halves) at batch 64, float32 and bfloat16: dx held to the
    plain version (TOL) and dleak to a float64 sum (DLEAK_RTOL), then
    timed per call (`per_call_times`: the profile's device time of the
    main kernel, `prelu_bwd_kernel`; CUDA events of the whole call, its
    partial-sum kernel included) beside the byte bound, and summed over a
    faithful step's 42 calls. Adds the per-call times to `per_call`;
    returns the largest dx difference."""
    import torch

    from edgegan_torch.ops import kernels
    gen = torch.Generator(device='cuda').manual_seed(13)
    lk = torch.tensor(0.2, device='cuda')
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        step = dict.fromkeys(('device_ms', 'ms', 'bound_ms', 'plain_ms'), 0.0)
        for (c, h, w), calls in PRELU_SHAPES:
            shape = (64, c, 2 * h, 2 * w)
            x = (torch.randn(shape, device='cuda', generator=gen) * 2).to(
                dtype)
            x[:, :, 0, :] = 0.0   # exact zeros: the tie leak*x == x
            g = torch.randn(shape, device='cuda', generator=gen).to(dtype)
            dx, dleak = kernels.prelu_bwd(x, g, lk)
            ref, _ = kernels.prelu_bwd_plain(x, g, lk)
            d64, scale = _dleak64(x, g, lk)
            err, ok, _ = _close(dx, ref, TOL[dname])
            check(ok and abs(dleak.item() - d64) / scale <= DLEAK_RTOL,
                  f'hires K5 {dname} {list(shape)}: dx diff {err:.3g}, '
                  f'dleak diff {abs(dleak.item() - d64) / scale:.3g}')
            dx2, dleak2 = kernels.prelu_bwd(x, g, lk)
            check(torch.equal(dx, dx2) and torch.equal(dleak, dleak2),
                  f'hires K5 {dname} {list(shape)}: two runs differ')
            max_err = max(max_err, err)
            key = f'K5 {dname} {list(shape)}'
            t = per_call[key] = per_call_times(
                card, 'hires K5', key, 'prelu_bwd_kernel',
                lambda a, b: kernels.prelu_bwd(a, b, lk), (x, g), 3,
                K5_OPS_PER_ELEMENT, lambda: kernels.prelu_bwd_plain(x, g, lk))
            for k in step:
                step[k] = (None if step[k] is None or t[k] is None
                           else step[k] + CLASSIFIER_PASSES * calls * t[k])
        per_call[f'K5 {dname} per hires faithful step ({K5_PER_STEP} '
                 'calls)'] = step
        print(f'hires K5 per faithful step ({K5_PER_STEP} calls) {dname}: '
              + ', '.join(f'{k} {_f4(v)}' for k, v in step.items())
              + f' [{card}]')
    return max_err


def host_cost_phase(card: str):
    """Host time to issue one call (no synchronisation) of each kernel's
    wrapper, of its plain version and of one plain PyTorch op, at the
    smallest classifier shapes in bfloat16, where the training step waits
    on the host: the mean of 200 calls after 20."""
    import torch

    from edgegan_torch.ops import kernels
    dev = torch.device('cuda')
    x = torch.randn(64, 768, 4, 4, device=dev).bfloat16()
    g = torch.randn_like(x)
    lk = torch.tensor(0.2, device=dev)
    rg, ht, img = (torch.randn(64, 512, 8, 8, device=dev).bfloat16()
                   for _ in range(3))
    y = torch.randn(64, 256, 8, 8, device=dev).bfloat16()
    calls = {
        'torch.add (one plain op)': lambda: torch.add(x, g),
        'K5 prelu_bwd': lambda: kernels.prelu_bwd(x, g, lk),
        'K5 plain': lambda: kernels.prelu_bwd_plain(x, g, lk),
        'K3 mru_gate_blend': lambda: kernels.mru_gate_blend(rg, ht, img),
        'K3 plain': lambda: kernels.mru_gate_blend_plain(rg, ht, img),
        'K4 mru_gate_bwd': lambda: kernels.mru_gate_bwd(rg, img, ht),
        'K4 plain': lambda: kernels.mru_gate_bwd_plain(rg, img, ht),
        'K1 instance_norm_act': lambda: kernels.instance_norm_act(y, 'relu'),
        'K2 instance_norm_act_bwd':
            lambda: kernels.instance_norm_act_bwd(y, y, 'relu'),
    }
    out = {}
    for name, fn in calls.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        out[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        print(f'host time per call, {name}: {out[name]:.1f} us (host clock, '
              f'issue only) [{card}]')
    return out


# the step's optimizer updates in order; each update ends one span of
# device time, which holds that group's forward and backward
CRITIC_SPANS = ['joint critic D (with the shared fakes)',
                'image critic D_patch2', 'edge critic D_patch3',
                'classifier D2']
GROUP_SPANS = {
    'faithful': CRITIC_SPANS + ['generators, 1st update (G1 slots)',
                                'G2 slots', 'encoder E (with the G1 forward)',
                                'generators, 2nd update (G1 slots)',
                                'G2 slots'],
    'fast': CRITIC_SPANS + ['generators (G1 slots)', 'G2 slots',
                            'encoder E (on the step-start fake)']}


def group_split(card: str, step, spans, n: int = 3):
    """Device time per optimizer group of a training step: a CUDA event is
    recorded after every RMSProp update (one per group and generator, as
    named in `spans`), so the time between two events is one group's
    forward, backward and update. Averaged over `n` back-to-back steps."""
    import torch

    from edgegan_torch.train.state import RMSProp

    marks = []
    update = RMSProp.update

    def marked(self, params, grads, slots):
        update(self, params, grads, slots)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append(event)

    RMSProp.update = marked
    try:
        times = [0.0] * len(spans)
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            marks.clear()
            step()
            torch.cuda.synchronize()
            if len(marks) != len(spans):
                raise RuntimeError(f'{len(marks)} optimizer updates per step')
            for i, event in enumerate(marks):
                times[i] += (marks[i - 1] if i else start).elapsed_time(
                    event) / n
    finally:
        RMSProp.update = update
    total = sum(times)
    print(f'training step by optimizer group (CUDA events, {n} steps): '
          f'{total:.3f} ms [{card}]')
    for name, ms in zip(spans, times):
        print(f'  {100 * ms / total:5.1f}% {ms:8.3f} ms  {name}')


def profile_steps(card: str, label: str, step, n: int = 10,
                  unit: str = 'batch'):
    """Where a step's time goes on the card: `torch.profiler` over `n`
    back-to-back steps; prints the device work per step (kernels and
    copies), its share of the window from the first device event to the
    last (the rest is the device waiting on the host), and the kernels
    that take the most device time. Returns {kernel name: device ms per
    step} and {kernel name: launches per step}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        print(f'profile {label}: not measured (no device events recorded)')
        return {}, {}
    busy, reach, by_name, calls = 0.0, spans[0][0], {}, {}
    for start, end, name in spans:
        busy += max(0.0, end - max(start, reach))  # union of the intervals
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + end - start
        calls[name] = calls.get(name, 0) + 1
    window = reach - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f'profile {label}: {len(spans) / n:.0f} device kernels and copies '
          f'per {unit}, device busy {busy / n / 1e3:.3f} ms per {unit}, '
          f'{100 * busy / window:.1f}% of the {window / n / 1e3:.3f} ms '
          f'window per {unit} [{card}]')
    for name, us in top:
        print(f'  {100 * us / busy:5.1f}% {us / n / 1e3:.4f} ms/{unit} '
              f'{name[:90]}')
    return ({k: v / n / 1e3 for k, v in by_name.items()},
            {k: v / n for k, v in calls.items()})


# ---- data parallelism: torchrun ranks on the one card ----

PARALLEL_RANKS = 2
PARALLEL_TIMED_STEPS = 3
# jittered runs of the one-process step whose largest distance from it is
# the step's own sensitivity: the card's step is not bitwise repeatable
# (on an H100 one jittered run's distance ranged 2.5e-5 to 8.4e-4 for
# the joint critic's update), so one run can understate it; the CPU
# tests take the largest of three jittered JAX runs
PARALLEL_JITTERED = 3
PARALLEL_TIMEOUT_S = 600


def _rank_env(extra=None):
    """This environment for the ranks: the collective timeout, and the
    repository on the import path (the ranks may start elsewhere)."""
    root = os.path.dirname(os.path.abspath(__file__))
    return {**os.environ, 'EDGEGAN_DIST_TIMEOUT': '300',
            'PYTHONPATH': os.pathsep.join(
                [root, os.environ.get('PYTHONPATH', '')]), **(extra or {})}


def _finish(procs, label, timeout=PARALLEL_TIMEOUT_S):
    """Wait for `procs` (each the leader of its own process group); kill
    every group left at the timeout. Returns their outputs; fails unless
    every one exits 0."""
    import signal
    outs = []
    deadline = time.time() + timeout
    try:
        for p in procs:
            left = max(1, deadline - time.time())
            outs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f'{label}: process {r} exited '
              f'{p.returncode}:\n{out[-6000:]}')
    return outs


def torchrun(nproc: int, args, label: str, env=None,
             timeout=PARALLEL_TIMEOUT_S) -> str:
    """`python -m torch.distributed.run --standalone --nproc_per_node
    nproc <args>` to its end; returns its output, fails on a non-zero
    exit."""
    proc = subprocess.Popen(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         f'--nproc_per_node={nproc}', *args], env=_rank_env(env),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    return _finish([proc], label, timeout)[0]


def spawn_ranks(nproc: int, args, env=None):
    """`args` once per rank with torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/PORT on loopback), each in its own process
    group, so that each can be signalled alone."""
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    return [subprocess.Popen(
        args, env=_rank_env({**(env or {}), 'RANK': str(r),
                             'WORLD_SIZE': str(nproc), 'LOCAL_RANK': str(r),
                             'LOCAL_WORLD_SIZE': str(nproc),
                             'MASTER_ADDR': '127.0.0.1',
                             'MASTER_PORT': str(port)}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(nproc)]


def _skip_all_reduce(spent):
    """A gradient all-reduce that does nothing: at one rank it gives the
    same result, so the step's time without its collectives."""
    return lambda tensors: None


def _timed_all_reduce(spent):
    """The gradient all-reduce, synchronised before and after, its wall
    seconds appended to `spent`."""
    import torch

    from edgegan_torch import parallel
    inner = parallel.all_reduce_mean_

    def timed(tensors):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(tensors)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
    return timed


def _time_steps(step, n: int):
    """(CUDA-event ms, host ms) per step of `n` back-to-back `step()`s."""
    import torch

    from edgegan_torch import parallel
    torch.cuda.synchronize()
    parallel.barrier('timed steps')
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, (time.perf_counter() - t0) * 1e3 / n


def dp_step_run(config, case, device, on: bool, timed: int = 0,
                jittered: bool = False, probe=None):
    """One faithful step of `config` from `_step_case`'s weights and
    inputs on this rank's rows (all of them without a process group),
    with the classifier switches `on`: the metrics averaged over the
    ranks, the parameters after it (JAX layout), the launches of that
    step, and with `timed` the ms per step of `timed` more steps on the
    card (CUDA events) and on the host clock; with `probe` (a function of
    a list that makes a stand-in for `parallel.all_reduce_mean_`, such as
    `_skip_all_reduce`) `timed` more steps with the stand-in, and the
    seconds it appended to the list, in ms per step."""
    from unittest import mock

    import numpy as np
    import torch

    from edgegan_torch import bridge, parallel
    from edgegan_torch.ops import kernels
    from edgegan_torch.train.networks import Networks
    from edgegan_torch.train.state import broadcast_state, create_train_state
    from edgegan_torch.train.step import Draws, make_train_step

    params, aux, images, z, draws, jitter = case
    if jittered:
        images, draws = jitter(images), dict(draws, z=jitter(draws['z']))

    def rows(a):
        return parallel.local_rows(torch.from_numpy(np.asarray(a)).to(device))
    with classifier_switches(on):
        nets = bridge.load_jax_params(Networks(config, critics=True), params,
                                      aux).to(device)
        state = broadcast_state(create_train_state(nets))
        step = make_train_step(nets, config)
        d = Draws(alpha={k: rows(v) for k, v in draws['alpha'].items()},
                  eps=torch.tensor(draws['eps'], device=device),
                  z=rows(draws['z']))
        x, zz = rows(images), rows(z)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        _, metrics = step(state, x, zz, d)
        counts = dict(kernels.LAUNCHES)
        names = sorted(metrics)
        packed = torch.stack([metrics[k] for k in names])
        parallel.all_reduce_mean_([packed])
        out = {'metrics': dict(zip(names, packed.tolist())),
               'params': bridge.export_jax_params(nets)[0],
               'launches': counts}
        if timed:
            out['ms'], out['host_ms'] = _time_steps(
                lambda: step(state, x, zz, d), timed)
        if timed and probe is not None:
            spent = []
            with mock.patch.object(parallel, 'all_reduce_mean_',
                                   probe(spent)):
                out['probe_ms'], _ = _time_steps(
                    lambda: step(state, x, zz, d), timed)
            out['probe_spent_ms'] = 1e3 * sum(spent) / timed
    return out


def _digest(params) -> str:
    import hashlib
    h = hashlib.sha256()
    for leaf in _leaves(params):
        h.update(leaf.tobytes())
    return h.hexdigest()


def parallel_worker(directory: str, module: str = None, *argv):
    """One rank of the `parallel` phase (run under torchrun): the batch-64
    faithful float32 step with the switches off and on, each rank on its
    rows; writes rank<r>.json (metrics, launches, times, a digest of the
    parameters, the seconds from this script's import to the group and
    to the end of the first step) and, on rank 0, params_<off|on>.npz.
    Then, in the same group, `module`'s `main(argv)` when given (an entry
    point: one launch fewer to pay for)."""
    import importlib

    import numpy as np

    from edgegan_torch import bridge, parallel
    from edgegan_torch.core.config import Config

    device = parallel.init('cuda')
    try:
        out = {'init_s': time.perf_counter() - _IMPORTED}
        config = Config().derive('train')
        case = _step_case(config)
        rank = parallel.rank()
        probe = (_skip_all_reduce if parallel.world_size() == 1
                 else _timed_all_reduce)
        for on in (False, True):
            run = dp_step_run(config, case, device, on, PARALLEL_TIMED_STEPS,
                              probe=probe)
            key = 'on' if on else 'off'
            out.setdefault('first_step_s', time.perf_counter() - _IMPORTED)
            if rank == 0:
                np.savez(os.path.join(directory, f'params_{key}.npz'),
                         **bridge.flatten_npz(params=run['params']))
            out[key] = {'digest': _digest(run['params']),
                        **{k: run[k] for k in (
                            'metrics', 'launches', 'ms', 'host_ms',
                            'probe_ms', 'probe_spent_ms')}}
        out['world'] = parallel.world_size()
        with open(os.path.join(directory, f'rank{rank}.json'), 'w') as f:
            json.dump(out, f)
        if module:
            importlib.import_module(module).main(list(argv))
    finally:
        parallel.shutdown()


def _healthz(port: int):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=10)
    try:
        conn.request('GET', '/healthz')
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def parallel_phase(card: str, tmp: str):
    """Data parallelism on the card at full width (the default
    configuration: 64x128 pairs, batch 64, 14 classes, gf_dim 64).

    - `cli.train` under `torchrun --standalone --nproc_per_node 1` (NCCL,
      one rank): 3 steps with a cadence save at counter 2, then a resume.
    - The batch-64 faithful float32 step at 1 rank over NCCL and at 2
      ranks sharing the card over gloo (EDGEGAN_RANKS_PER_CARD=2, 32 rows a
      rank), switches off and on: each rank's parameters after the step
      bitwise equal, the 2-rank step held to this process's one-process
      card step within 3x the step's own sensitivity (`_held_to_cpu`: the
      largest distance of PARALLEL_JITTERED runs of the same step on
      inputs moved by 1e-6), K1/K2 (and with the switches K5,
      K3, K4) launches per rank as `expected_launches` plans them; the
      time per step of each beside the one-process step's.
    - `cli.test --test_batch_size 16` from the NCCL run's checkpoint at 2
      ranks against one process: the same files, PNGs within 1 byte.
    - `serve` at 2 ranks, max_batch 16, float32 transfer: /healthz's world
      size, a raw request of 8 held to a one-process Batcher on the same
      weights within 1e-3, and the time per request of 16 beside a
      one-process server's (host clock, HTTP on loopback).
    Returns the launches per rank of the steps under torchrun."""
    import math
    import signal

    import numpy as np
    import torch
    from PIL import Image

    from edgegan_torch import bridge, serve
    from edgegan_torch import checkpoint as ckpt
    from edgegan_torch.cli import test as test_cli
    from edgegan_torch.core.config import Config
    from edgegan_torch.train.networks import Networks
    from edgegan_torch.utils.metrics_io import (read_metrics,
                                                read_resume_markers)

    config = Config().derive('train')
    h, w = config.output_height, config.output_width
    root = os.path.join(tmp, 'parallel_data')
    write_dataset(root, config.batch_size, config.num_classes, h, w, seed=5)
    valid = write_test_tree(root, 2, config.num_classes, h, w, seed=6)
    out = os.path.join(tmp, 'parallel_out')
    base = ['--dataroot', root, '--dataset', 'ds', '--outputsroot', out,
            '--name', 'dp']
    share = {'EDGEGAN_RANKS_PER_CARD': str(PARALLEL_RANKS)}

    # 1. cli.train under torchrun, one rank over NCCL: 3 steps
    train = ['edgegan_torch.cli.train', *base,
             '--save_checkpoint_frequency', '3']
    t0 = time.perf_counter()
    log = torchrun(1, ['-m', *train, '--epoch', '3'],
                   'cli.train under torchrun')
    print(f'cli.train under torchrun --nproc_per_node 1 (NCCL), 3 steps: '
          f'{time.perf_counter() - t0:.3f} s with start-up (host clock) '
          f'[{card}]')
    check(' [*] data parallel: 1 ranks over nccl' in log,
          f'no NCCL group: {log[-3000:]}')
    ckpt_dir = os.path.join(out, 'dp', 'checkpoints')
    check(ckpt.steps(ckpt_dir) == [2], f'checkpoints {ckpt.steps(ckpt_dir)}')

    # 2. the step in this process, at 1 rank over NCCL (then the resume of
    # 1. in the same launch), at 2 ranks over gloo on the one card (then
    # cli.test --test_batch_size 16 in the same launch)
    case = _step_case(config)
    one = {}
    for on in (False, True):
        one[on] = dp_step_run(config, case, 'cuda', on, PARALLEL_TIMED_STEPS)
        one[on]['jittered'] = [
            dp_step_run(config, case, 'cuda', on, jittered=True)
            for _ in range(PARALLEL_JITTERED)]
    test = base + ['--test_batch_size', '16']
    t0 = time.perf_counter()
    test_cli.main(test)
    one_test_s = time.perf_counter() - t0
    out2 = os.path.join(tmp, 'parallel_out2')
    os.makedirs(os.path.join(out2, 'dp'))
    os.symlink(ckpt_dir, os.path.join(out2, 'dp', 'checkpoints'))
    then = {1: [*train, '--epoch', '1'],
            PARALLEL_RANKS: ['edgegan_torch.cli.test'] + [
                out2 if a == out else a for a in test]}
    ranks = {}
    for n in (1, PARALLEL_RANKS):
        d = os.path.join(tmp, f'parallel_step_{n}')
        os.makedirs(d)
        t0 = time.perf_counter()
        log = torchrun(n, [os.path.abspath(__file__), '--parallel-worker', d,
                           *then[n]], f'the step at {n} ranks',
                       share if n > 1 else None)
        wall = time.perf_counter() - t0
        res = []
        for r in range(n):
            with open(os.path.join(d, f'rank{r}.json')) as f:
                res.append(json.load(f))
        ranks[n] = (d, res, wall, log)
        print(f'{n} ranks under torchrun: the group made '
              f'{res[0]["init_s"]:.1f} s and the first step done '
              f'{res[0]["first_step_s"]:.1f} s after the script\'s import on '
              f'rank 0; the launch with its entry point {wall:.1f} s (host '
              f'clock) [{card}]')

    logdir = os.path.join(out, 'dp', 'logs', 'metrics.jsonl')
    rows = read_metrics(logdir)
    check([r['step'] for r in rows] == [2, 3, 4] and
          read_resume_markers(logdir) == [2], f'NCCL run steps {rows}, '
          f'resumes {read_resume_markers(logdir)}')
    check(all(math.isfinite(v) for r in rows for v in r.values()),
          'NCCL run: a metric is not finite')
    print('cli.train under torchrun (NCCL, 1 rank): 3 steps, the cadence '
          'checkpoint 2, then the resume at counter 2, every metric finite')
    launches = {}
    for on in (False, True):
        key = 'on' if on else 'off'
        want = expected_launches('faithful', torch.float32, on)
        base_ms = one[on]
        for n, (d, res, wall, _) in ranks.items():
            check(res[0]['world'] == n, f'{n} ranks: world {res[0]["world"]}')
            check(len({r[key]['digest'] for r in res}) == 1,
                  f'{n} ranks, switches {key}: the parameters differ '
                  'between ranks')
            for r, got in enumerate(res):
                check_launches(f'{n} ranks, rank {r}, switches {key}',
                               got[key]['launches'], want)
                launches[f'parallel step, {n} ranks, rank {r}, switches '
                         f'{key}'] = got[key]['launches']
            with np.load(os.path.join(d, f'params_{key}.npz')) as f:
                params = bridge.unflatten_npz(f)['params']
            ok = _held_to_cpu(
                f'{n} ranks, switches {key}, against one process',
                (res[0][key]['metrics'], params),
                (base_ms['metrics'], base_ms['params']),
                [((j['metrics'], j['params']),
                  (base_ms['metrics'], base_ms['params']))
                 for j in base_ms['jittered']], case[0],
                names=(f'{n} ranks', 'one process'))
            check(ok, f'the {n}-rank step differs from one process beyond '
                  'the limits')
            print(f'faithful float32 step at batch 64, switches {key}: '
                  f'{n} ranks ({"gloo, one card" if n > 1 else "NCCL"}) '
                  + ', '.join(f'rank {r} {g[key]["ms"]:.2f} ms '
                              f'(host {g[key]["host_ms"]:.2f})'
                              for r, g in enumerate(res))
                  + f'; one process {base_ms["ms"]:.2f} ms (host '
                  f'{base_ms["host_ms"]:.2f}); CUDA events over '
                  f'{PARALLEL_TIMED_STEPS} steps after the first; the '
                  'parameters bitwise equal on every rank; launches per '
                  f'rank as planned [{card}]')
            g = res[0][key]
            if n == 1:
                print(f'  1 rank, switches {key}: {g["probe_ms"]:.2f} ms a '
                      f'step with the gradient all-reduces skipped, against '
                      f'{g["ms"]:.2f} with them (CUDA events, the same '
                      f'process, {PARALLEL_TIMED_STEPS} steps each) [{card}]')
            else:
                print(f'  {n} ranks, switches {key}: the 7 gradient '
                      f'all-reduces {g["probe_spent_ms"]:.2f} ms of a '
                      f'{g["probe_ms"]:.2f} ms step on rank 0 (each '
                      f'synchronised before and after, host clock; CUDA '
                      f'events over the step) [{card}]')

    # 3. cli.test at 2 ranks (run in 2.) against one process
    check(' [*] sharding inference over 2 ranks' in ranks[PARALLEL_RANKS][3],
          ranks[PARALLEL_RANKS][3][-3000:])
    trees = [os.path.join(o, 'dp', 'test_output', 'ds') for o in (out, out2)]
    files = [sorted(os.path.relpath(os.path.join(dd, f), t)
                    for dd, _, fs in os.walk(t) for f in fs) for t in trees]
    check(files[0] == files[1] == valid, f'cli.test trees: {len(files[0])} '
          f'and {len(files[1])} files, expected {len(valid)}')
    diff = max(int(np.abs(
        np.asarray(Image.open(os.path.join(trees[0], f)), np.int16)
        - np.asarray(Image.open(os.path.join(trees[1], f)), np.int16)).max())
        for f in valid)
    check(diff <= 1, f'cli.test at 2 ranks: a PNG differs by {diff}')
    print(f'cli.test --test_batch_size 16, {len(valid)} of {len(valid) + 2} '
          f'files: 2 ranks the one-process tree, largest byte difference '
          f'{diff} (limit 1); one process {one_test_s:.3f} s (host clock, '
          f'in this process) [{card}]')

    # 4. serve at 2 ranks against one process
    tcfg = Config().derive('test')
    _, _, trees_ckpt = ckpt.load_raw(ckpt_dir)
    nets = bridge.load_jax_params(Networks(tcfg), trees_ckpt['params'],
                                  trees_ckpt['aux'])
    rng = np.random.RandomState(7)
    raw8 = rng.uniform(-1, 1, (8, h, w, 3)).astype('<f4')
    raw16 = rng.uniform(-1, 1, (16, h, w, 3)).astype('<f4')
    ids8 = ','.join(str(i % tcfg.num_classes) for i in range(8))
    ids16 = ','.join(str(i % tcfg.num_classes) for i in range(16))
    n_timed = 10

    def timed_requests(port):
        t0 = time.perf_counter()
        for _ in range(n_timed):
            status, _ = _post(port, f'/generate?class_id={ids16}&raw=1&n=16',
                              raw16.tobytes())
            check(status == 200, f'HTTP {status}')
        return (time.perf_counter() - t0) * 1e3 / n_timed

    batcher = serve.Batcher(nets, tcfg, max_batch=16, seed=tcfg.seed,
                            transfer_dtype='float32', device='cuda')
    server = serve.make_server(tcfg, batcher, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        warm = batcher.submit(np.zeros((h, w, 3), np.float32), 0)
        check(not isinstance(warm.get(timeout=600), Exception), 'warm-up')
        status, body = _post(port, f'/generate?class_id={ids8}&raw=1&n=8',
                             raw8.tobytes())
        check(status == 200, f'one process: HTTP {status}')
        want = np.frombuffer(body, '<f4').reshape(8, h, w // 2, 3)
        one_ms = timed_requests(port)
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = spawn_ranks(PARALLEL_RANKS, [
        sys.executable, '-m', 'edgegan_torch.serve', '--outputsroot', out,
        '--name', 'dp', '--serve_batch', '16', '--transfer_dtype', 'float32',
        '--port', str(port)], share)
    try:
        health = None
        while health is None and time.perf_counter() - t0 < 300:
            check(all(p.poll() is None for p in procs), 'a serving rank '
                  'exited')
            try:
                health = _healthz(port)
            except OSError:
                time.sleep(0.5)
        ready = time.perf_counter() - t0
        check(health is not None and health['world_size'] == PARALLEL_RANKS,
              f'/healthz: {health}')
        status, body = _post(port, f'/generate?class_id={ids8}&raw=1&n=8',
                             raw8.tobytes())
        check(status == 200, f'2 ranks: HTTP {status}')
        got = np.frombuffer(body, '<f4').reshape(8, h, w // 2, 3)
        two_ms = timed_requests(port)
    finally:
        procs[0].send_signal(signal.SIGINT)
    _finish(procs, 'serve at 2 ranks', 120)
    err = float(np.abs(got - want).max())
    check(err <= 1e-3, f'serve at 2 ranks vs one process: {err}')
    print(f'serve at 2 ranks (gloo, one card): ready in {ready:.2f} s, '
          f'/healthz world_size {health["world_size"]}; a raw request of 8 '
          f'within {err:.3g} of one process (limit 1e-3); {n_timed} raw '
          f'requests of 16: {two_ms:.2f} ms each at 2 ranks, {one_ms:.2f} '
          f'ms in one process (host clock, HTTP on loopback); both ranks '
          f'left after SIGINT to rank 0 [{card}]')
    return launches


def _kernel_entry(name, source, replaces, sums, scale, launches,
                  max_err, work, **extra):
    """One kernel's record for the JSON line: `sums` holds the summed
    per-shape times and bounds of one pass over the shapes it was timed
    at, and `scale` the number of such passes in the work described."""
    return {
        'name': name, 'route': 'cuda', 'source': source,
        'replaces': replaces, 'launches': sum(launches.values()),
        'launches_by_run': launches,
        'max_abs_err': max(max_err.values()),
        'max_abs_err_float32': max_err['float32'],
        'ms': scale * sums['ms'], 'plain_ms': scale * sums['plain_ms'],
        'bound_ms': scale * max(sums['bytes_ms'], sums['ops_ms']),
        'bound_by': ('bytes' if sums['bytes_ms'] >= sums['ops_ms']
                     else 'operations'),
        'library_ms': None, 'work': work, **extra}


def in_extras(kname, sums, previous, results):
    """K1's or K2's extra JSON fields: device time per call from the
    profile, summed over the three generator shapes, per (batch, dtype),
    warm and cold L2, and the same for the multi-pass kernel (the earlier
    design) at batch 64; its registers per thread; its largest difference
    from the plain version across the variants' plane sizes."""
    return {
        'device_ms_per_generator': {
            f'batch {b} {d}': {'warm': v['device_ms'], 'cold': v['cold_ms']}
            for (b, d), v in sums.items()},
        'previous_device_ms': {
            'design': 'multi-pass, one block per plane (variant 0), timed '
                      'in this run; per generator, the three shapes summed',
            **{f'batch 64 {d}': {'warm': _ms(warm), 'cold': _ms(cold)}
               for d, (warm, cold) in previous.items()}},
        'registers_per_thread': {
            k: v[0] for k, v in results['K1/K2 registers'].items()
            if k.startswith(kname)},
        'variants_max_abs_err': results['K1/K2 variants'][kname]}


def gate_extras(kname, steps, results):
    """K3's or K4's extra JSON fields: device time per training step from
    the per-call profile (the four gate shapes x 3 classifier passes),
    warm and cold L2, per dtype, the same for the multi-pass kernel (the
    earlier design) on the same inputs, its registers per thread per
    variant, and its largest difference from the plain version across the
    variants' plane sizes."""
    return {
        'device_ms': {d: {'warm': v['device_ms'], 'cold': v['cold_ms']}
                      for d, v in steps.items()},
        'previous_device_ms': {
            'design': 'multi-pass, one block per plane (variant 0), timed '
                      'in this run on the same inputs; per training step',
            **{d: {'warm': v['previous_ms'], 'cold': v['previous_cold_ms']}
               for d, v in steps.items()}},
        'registers_per_thread': {
            k: v[0] for k, v in results['K3/K4 registers'].items()
            if k.startswith(kname)},
        'resident_clusters': {
            k: v[2] for k, v in results['K3/K4 registers'].items()
            if k.startswith(kname) and ' cluster ' in k},
        'variants_max_abs_err': results['K3/K4 variants'][kname]}


def _step_times(sums):
    return {'ms': sums['ms'], 'plain_ms': sums['plain_ms'],
            'bound_ms': max(sums['bytes_ms'], sums['ops_ms'])}


def main() -> int:
    import torch

    from edgegan_torch.ops import _build

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    card = card_line()
    print(f'card: {card}')
    print(f'torch {torch.__version__} cuda {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    _build.library()
    print(f'kernels built and loaded in {time.perf_counter() - t0:.2f} s '
          f'(nvcc {_build.build_seconds} s) [{card}]')

    results, failed = {}, []
    only = (set(sys.argv[2].split(',')) if sys.argv[1:2] == ['--only']
            else None)

    def phase(name, fn, *args):
        if only is not None and name not in only:
            return
        t = time.perf_counter()
        try:
            results[name] = fn(*args)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        print(f'phase {name}: {"FAILED" if name in failed else "ok"} in '
              f'{time.perf_counter() - t:.1f} s [{card}]', flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        phase('K1/K2 registers', in_registers, card)
        phase('K1', kernel_phase, card)
        phase('K2', k2_phase, card)
        phase('K1/K2 variants', in_variants_phase, card)
        phase('K5', k5_phase, card)
        phase('K3/K4 registers', gate_registers, card)
        phase('K3/K4', gate_phase, card)
        phase('K3/K4 variants', gate_variants_phase, card)
        phase('serve', serving_phase, card)
        phase('train', train_phase, card, tmp)
        phase('lifecycle', lifecycle_phase, card, tmp)
        phase('evaluate', evaluate_phase, card, tmp)
        phase('tf_import', tf_import_phase, card, tmp)
        phase('card_vs_cpu', card_vs_cpu_phase, card)
        phase('step_time', step_time_phase, card)
        phase('step_time fast', step_time_phase, card, 'fast')
        phase('variants', variants_phase, card, tmp)
        phase('hires', hires_phase, card, tmp)
        phase('host_cost', host_cost_phase, card)
        phase('parallel', parallel_phase, card, tmp)
        # last: every earlier phase runs in the process state it ran in
        # before this phase existed
        phase('quality', quality_phase, card, tmp)
    if failed:
        print(f'chip_smoke: failed phases: {", ".join(failed)}',
              file=sys.stderr)
        return 1
    if only is not None:
        print(f'chip_smoke: phases {", ".join(sorted(only))} passed; no '
              'result printed for a partial run')
        return 0

    k1_err, k1_sums, k1_prev = results['K1']
    k2_err, k2_sums, k2_prev = results['K2']
    k5_err, dleak_err, k5_steps = results['K5']
    gate_err, gate_steps = results['K3/K4']
    v_launches, v_steps, v_per_call, v_err = results['variants']
    h_launches, h_steps, h_per_call, h_err = results['hires']
    train_launches, extras_ms = results['train']
    e_launches, e_results = results['evaluate']
    q_launches, q_results = results['quality']
    train_runs = {**train_launches, **results['lifecycle'], **v_launches,
                  **h_launches, **e_launches, **q_launches,
                  **results['parallel']}

    def per_call(kname):
        """K1-K4's per-call times at the planes beyond the default
        configuration's: the convnet encoder's (K1/K2; its 1x1 and 2x2
        planes in ragged groups) and the hires configuration's (K1/K2 in
        blocks, K3/K4 in clusters), beside the multi-pass kernel where
        they left it (K1/K2 also beside F.instance_norm+relu)."""
        return {
            'convnet_encoder_planes': {k: v for k, v in v_per_call.items()
                                       if k.startswith(kname)},
            'hires_planes': {k: v for k, v in h_per_call.items()
                             if k.startswith(kname)},
            'max_abs_err_at_these_planes': max(
                v_err.get(kname, 0.0), h_err[kname])}
    times, prof = results['step_time']
    fast_times, fast_prof = results['step_time fast']

    def by_run(key):
        return {label: counts[key] for label, counts in train_runs.items()}

    def fast_device_ms(kname, switched_only=False):
        """A kernel's device ms per fast step from its profile, by
        setting."""
        return {f'{d}, switches {"on" if on else "off"}': p[kname]
                for (d, on), p in fast_prof.items()
                if on or not switched_only}

    k1_launches = {'serve': results['serve'], **by_run('instance_norm_act')}
    k1 = k1_sums[(16, 'bfloat16')]
    bf16_work = ('one training step: batch 64, bfloat16, both switches on, '
                 '3 classifier passes (group 4 and both generator updates)')
    print(f'card: {card}')
    print(json.dumps({'kernels': [
        # one served batch at max_batch 16 in bfloat16 (the serving
        # default): the three shapes in each of G1 and G2
        _kernel_entry(
            'instance_norm_act', 'edgegan_torch/csrc/instance_norm_act.cu',
            'edgegan_tpu/ops/pallas_kernels.py:153', k1, 2, k1_launches,
            k1_err, 'one served batch: max_batch 16, bfloat16, relu, '
            '[16,256,8,8] + [16,128,16,16] + [16,64,32,32] in G1 and G2',
            yardstick={'call': 'F.relu(F.instance_norm(x)), eps inside the '
                               'sqrt: not the same function',
                       'ms': 2 * k1['library_ms']},
            train_step_ms={d: K1_PER_STEP / 3 * k1_sums[(64, d)]['ms']
                           for d in ('float32', 'bfloat16')},
            train_step_device_ms={
                f'{d}, switches {"on" if on else "off"}': p[
                    'instance_norm_act_fwd'] for (d, on), p in prof.items()},
            fast_step_device_ms=fast_device_ms('instance_norm_act_fwd'),
            train_step_yardstick_ms={
                d: K1_PER_STEP / 3 * k1_sums[(64, d)]['library_ms']
                for d in ('float32', 'bfloat16')},
            **in_extras('K1', k1_sums, k1_prev, results),
            new_planes_per_call=per_call('K1')),
        # one training step at batch 64 in float32: the three shapes in
        # each of 2 generator updates x (G1, G2)
        _kernel_entry(
            'instance_norm_act_bwd', 'edgegan_torch/csrc/instance_norm_act.cu',
            'edgegan_tpu/ops/pallas_kernels.py:167', k2_sums[(64, 'float32')],
            K2_PER_STEP // 3, by_run('instance_norm_act_bwd'), k2_err,
            'one training step: batch 64, float32, relu, 4 calls at each of '
            '[64,256,8,8], [64,128,16,16], [64,64,32,32] (2 generator '
            'updates x G1, G2)',
            yardstick={'call': 'backward of F.relu(F.instance_norm(x)), eps '
                               'inside the sqrt: not the same function',
                       'ms': 4 * k2_sums[(64, 'float32')]['yardstick_ms']},
            train_step_ms={d: K2_PER_STEP / 3 * k2_sums[(64, d)]['ms']
                           for d in ('float32', 'bfloat16')},
            train_step_device_ms={
                f'{d}, switches {"on" if on else "off"}': p[
                    'instance_norm_act_bwd'] for (d, on), p in prof.items()},
            fast_step_device_ms=fast_device_ms('instance_norm_act_bwd'),
            **in_extras('K2', k2_sums, k2_prev, results),
            new_planes_per_call=per_call('K2')),
        _kernel_entry(
            'prelu_bwd', 'edgegan_torch/csrc/prelu_bwd.cu',
            'edgegan_tpu/ops/pallas_kernels.py:247', k5_steps['bfloat16'], 1,
            by_run('prelu_bwd'), k5_err,
            f'{bf16_work}: the 14 PReLU shapes, {K5_PER_STEP} calls',
            yardstick={'call': 'backward of F.prelu(x, w): no tie split, '
                               'and max(leak*x, x) only for 0 <= leak <= 1: '
                               'not the same function',
                       'ms': k5_steps['bfloat16']['yardstick_ms']},
            float32=_step_times(k5_steps['float32']),
            dleak_max_err_of_sum_abs_terms=dleak_err,
            train_step_device_ms={
                d: prof[(d, True)]['prelu_bwd']
                for d in ('float32', 'bfloat16')},
            fast_step_device_ms=fast_device_ms('prelu_bwd', True),
            hires_planes={k: v for k, v in h_per_call.items()
                          if k.startswith('K5')},
            max_abs_err_at_hires_planes=h_err['K5']),
        _kernel_entry(
            'mru_gate_blend', 'edgegan_torch/csrc/mru_gate.cu',
            'edgegan_tpu/ops/pallas_kernels.py:368',
            gate_steps['K3']['bfloat16'], 1, by_run('mru_gate_blend'),
            gate_err['K3'], f'{bf16_work}: the 4 gate shapes, '
            f'{K3_PER_STEP} calls',
            yardstick={'call': None, 'ms': None,
                       'why': 'no single PyTorch call computes it'},
            float32=_step_times(gate_steps['K3']['float32']),
            train_step_device_ms={
                d: prof[(d, True)]['mru_gate_fwd']
                for d in ('float32', 'bfloat16')},
            fast_step_device_ms=fast_device_ms('mru_gate_fwd', True),
            **gate_extras('K3', gate_steps['K3'], results),
            new_planes_per_call=per_call('K3')),
        _kernel_entry(
            'mru_gate_bwd', 'edgegan_torch/csrc/mru_gate.cu',
            'edgegan_tpu/ops/pallas_kernels.py:388',
            gate_steps['K4']['bfloat16'], 1, by_run('mru_gate_bwd'),
            gate_err['K4'], f'{bf16_work}: the 4 gate shapes, '
            f'{K4_PER_STEP} calls',
            yardstick={'call': None, 'ms': None,
                       'why': 'no single PyTorch call computes it'},
            float32=_step_times(gate_steps['K4']['float32']),
            train_step_device_ms={
                d: prof[(d, True)]['mru_gate_bwd']
                for d in ('float32', 'bfloat16')},
            fast_step_device_ms=fast_device_ms('mru_gate_bwd', True),
            **gate_extras('K4', gate_steps['K4'], results),
            new_planes_per_call=per_call('K4')),
    ], 'train_step_ms': {f'{d}, switches {"on" if on else "off"}': t[0]
                         for (d, on), t in times.items()},
        'fast_step_ms': {f'{d}, switches {"on" if on else "off"}': t[0]
                         for (d, on), t in fast_times.items()},
        'variant_step_ms': v_steps, 'hires_step_ms': h_steps,
        'host_us_per_call': results['host_cost'],
        'summaries_extras': extras_ms, 'evaluate': e_results,
        'quality': q_results}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--parallel-worker']:
        parallel_worker(*sys.argv[2:])
    else:
        sys.exit(main())
