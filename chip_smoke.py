#!/usr/bin/env python3
"""Drive the PyTorch port (edgegan_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository; it needs one CUDA card and no
network. It exits non-zero, printing no result, when there is no card or
the package is missing, and on any failed check.

1. Prints the card's name and power limit (nvidia-smi) and builds the
   hand-written kernels from edgegan_torch/csrc (nvcc, sm_90a, one
   process per source); prints the registers and spills per thread of
   K1's and K2's kernels in each variant.
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
   both kernels in both variants (lane group, multi-pass) at ragged,
   generator, large and misaligned planes (`ops/in_checks.py`): within
   the limits, the plain versions within them of float64, two runs
   bitwise equal, launch counts per variant as planned.
4. K5 phase: `prelu_bwd` against `prelu_bwd_plain` at the classifier's 14
   PReLU shapes at batch 64, float32 and bfloat16, leaks 0.2 and 1.5,
   exact zeros in x: dx within K1's limits, dleak within DLEAK_RTOL of the
   sum of |terms| from a float64 sum on the card. Times per call and per
   training step beside the byte bound, the plain version's and the
   backward of F.prelu's (a yardstick: no tie split, and the same
   function only for 0 <= leak <= 1); and the Function's gradients.
5. K3/K4 phases: the registers and spills per thread of K3's and K4's
   kernels in each variant (none may spill); `mru_gate_blend` and
   `mru_gate_bwd` against their plain versions at the classifier's four
   gate shapes at batch 64, float32 and bfloat16, a flat plane and ties at
   both extrema in each, in the variant `gate_plan` picks (block for unit
   1, lane groups for units 2-4), two runs bitwise equal
   (`ops/gate_checks.py`); the Function's three gradients against autograd
   of the plain chain; device time per call from the profile (warm and
   cold L2) beside the byte bound, and the multi-pass kernel (the earlier
   design) on the same inputs, checked against the new one first; CUDA
   events and the plain versions' times (no single PyTorch call computes
   either). Then both kernels in every variant at ragged, unit-sized,
   large and misaligned planes.
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
   batches per epoch, for 2 epochs (4 steps, checkpoints 2 and 5), then
   again for 1 epoch, which must resume at counter 5; then a fresh run of
   2 steps with `--dtype bfloat16` and both classifier switches on
   (EDGEGAN_PALLAS_PRELU=1, EDGEGAN_PALLAS_GATE=1). Every metric must be
   finite, every optimizer group must move, and the kernels must launch
   K1 21, K2 12 times per step, all in the lane-group variant, and K5
   42, K3 12, K4 12 times per step with the switches on (K3/K4 split
   across the variants as `gate_plan` sends the four gates), 0 with them
   off (the default).
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
   2x2 planes in the multi-pass kernel) held to their plain versions and
   timed per call, then 2 CLI steps, a resume and one `cli.test` forward
   from the checkpoint (K1 12 launches).
12. Hires phase: 128x256 pairs (BASELINE config 5) at batch 64, faithful,
   both switches on: 2 CLI steps in float32 on synthetic pairs (launches
   as planned: g_dconv_3's 64x64 planes and MRU unit 1's 128x128 gate in
   the multi-pass kernels), the step timed in float32 and bfloat16 with
   peak memory, and K1/K2 at [64, 64, 64, 64] and K3/K4 at [64, 8, 128,
   128] held to their plain versions (two runs bitwise equal) and timed
   per call beside their bounds.
13. Prints one JSON line describing every kernel, then
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
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
PROFILED_STEPS = 5
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
# update_sn runs no forward.
STEP_KINDS = {'faithful': (7, 4, 1, 1, 3, 3),
              'fast': (4, 2, 1, 1, 2, 2),
              'fast, reference_metrics, update_sn': (8, 2, 1, 1, 3, 2)}
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
    timing it beside the lane groups: not counted in `LAUNCHES`."""
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
    `nvcc -Xptxas -v` prints), relu, in the variant each plane size takes:
    the generators' planes (lane groups) and 65536 elements (multi-pass).
    Returns {'K1 float32 1024 lane_group 32x8': (regs,
    local bytes), ...}."""
    import ctypes

    import torch

    from edgegan_torch.ops import _build, kernels
    lib = _build.library()
    out = (ctypes.c_int * 2)()
    table = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        for hw in [h * w for _, h, w in SERVE_SHAPES] + [65536]:
            variant, lanes, vectors = kernels.instance_norm_plan(hw, dtype, 0)
            for bwd, kname in ((0, 'K1'), (1, 'K2')):
                err = lib.edgegan_instance_norm_act_attrs(
                    bwd, kernels._DTYPES[dtype], 1,
                    kernels.IN_VARIANTS[variant], lanes, vectors, out)
                check(err == 0, f'{kname} {variant} attributes: error {err}')
                key = f'{kname} {dname} {hw} {variant} {lanes}x{vectors}'
                table[key] = (out[0], out[1])
                print(f'{key}: {out[0]} registers per thread, {out[1]} bytes '
                      f'of local memory (spills) [{card}]')
    return table


def previous_design_us(name, entry, x, *tensors):
    """Device time per call (warm, cold L2), in µs, of K1's or K2's
    multi-pass kernel at x's shape, with relu, after checking its output
    against the lane-group kernel's on the same inputs (`tensors`: the
    inputs after x; the output is made here)."""
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
    check(ok, f'{name} multi-pass differs from the lane group by {err:.3g}')
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
    """K1 and K2 in both variants against their plain versions, within TOL
    and K2_TOL, by `in_checks.check_kernels`: the plane sizes of
    `in_checks.EDGE_PLANES`, 37 planes with plane 0 constant, float32 and
    bfloat16, three activations; and a contiguous input at a storage
    offset of one element (off 16 bytes), which must take the multi-pass
    kernels. Returns the largest differences."""
    import torch

    from edgegan_torch.ops import in_checks, kernels
    dev = torch.device('cuda')
    max_err = {'K1': 0.0, 'K2': 0.0}
    seen = set()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        for hw in in_checks.EDGE_PLANES:
            x, g = in_checks.edge_inputs(dev, hw, dtype, seed=4)
            cases = [(x, g, f'{dname} {list(x.shape)}')]
            if hw == (8, 8):
                cases.append((in_checks.shifted(x), in_checks.shifted(g),
                              f'{dname} {list(x.shape)} at a storage '
                              f'offset of 1'))
            for xc, gc, label in cases:
                want = kernels.instance_norm_plan(
                    hw[0] * hw[1], dtype, xc.data_ptr() | gc.data_ptr())[0]
                seen.add(want)
                e1, e2 = in_checks.check_kernels(
                    xc, gc, TOL[dname], K2_TOL[dname], want, label=label)
                max_err['K1'] = max(max_err['K1'], e1)
                max_err['K2'] = max(max_err['K2'], e2)
                print(f'{label} ({want}): K1 and K2 within the limits, the '
                      f'plain versions within them of float64, three '
                      f'activations, two runs bitwise equal [{card}]')
    check(seen == set(kernels.IN_VARIANTS), f'variants reached: {seen}')
    print(f'K1/K2 variants: max abs diff K1 {max_err["K1"]:.3g}, K2 '
          f'{max_err["K2"]:.3g} [{card}]')
    return max_err


@contextlib.contextmanager
def classifier_switches(on: bool):
    """Both classifier switches set to 1 (on) or unset (off, the default),
    restored afterwards."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
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
                      config=None):
    """`kernels.LAUNCHES` after `steps` training steps of `kind`
    (STEP_KINDS) in `dtype` of `config` (the default configuration when
    None): K1 and K2 on each plane set of `in_planes` in the variant
    `instance_norm_plan` picks for it (lane groups at the default sizes;
    multi-pass for ragged planes, such as the encoder's 1x1, and beyond
    1024 float32 / 2048 bfloat16 elements, such as the hires generator's
    64x64), K3's and K4's in the variants where `gate_plan` sends the four
    gates, K5 and K3/K4 only with the switches on."""
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
    can pick; fails on a spill. Returns {'K3 float32 block 256x4': (regs,
    local bytes), ...}."""
    import ctypes

    import torch

    from edgegan_torch.ops import _build, kernels
    lib = _build.library()
    out = (ctypes.c_int * 2)()
    table = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        per_vector = 16 // dtype.itemsize
        reach = kernels.IN_THREADS * kernels.GATE_BLOCK_VECTORS * per_vector
        plans = sorted({kernels.gate_plan(hw, dtype, 0)
                        for hw in range(1, reach + per_vector + 1)})
        for variant, lanes, vectors in plans:
            for bwd, kname in ((0, 'K3'), (1, 'K4')):
                err = lib.edgegan_mru_gate_attrs(
                    bwd, kernels._DTYPES[dtype],
                    kernels.GATE_VARIANTS[variant], lanes, vectors, out)
                check(err == 0, f'{kname} {variant} attributes: error {err}')
                key = f'{kname} {dname} {variant} {lanes}x{vectors}'
                table[key] = (out[0], out[1])
                print(f'{key}: {out[0]} registers per thread, {out[1]} bytes '
                      f'of local memory (spills) [{card}]')
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
            # the earlier design on the same inputs, checked first
            prev_out = gate_previous(True, rg, ht, img, torch.empty_like(rg))
            prev_grads = gate_previous(False, rg, img, g,
                                       torch.empty_like(rg),
                                       torch.empty_like(img))
            for what, got, want, tol in (
                    ('K3', prev_out, kernels.mru_gate_blend(rg, ht, img),
                     TOL[dname]),
                    *(('K4', a, b, K2_TOL[dname]) for a, b in zip(
                        prev_grads, kernels.mru_gate_bwd(rg, img, g)))):
                err, ok, _ = _close(got, want, tol)
                check(ok, f'{what} {dname} {shape}: multi-pass differs from '
                          f'{plan[0]} by {err:.3g}')
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
    multi-pass kernels. Returns the largest differences."""
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
                print(f'{label} ({want}): K3 and K4 within the limits, two '
                      f'runs bitwise equal [{card}]')
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
                  seed: int = 0):
    """<root>/ds/train/<class>/*.png: `n_images` random h x w sketch|photo
    pairs, spread over `n_classes` class directories."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)
    for i in range(n_images):
        d = os.path.join(root, 'ds', 'train', str(i % n_classes))
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
        ('float32 --epoch 2', 'smoke', ['--epoch', '2'], False, 4, 2),
        ('float32 resumed --epoch 1', 'smoke', ['--epoch', '1'], False, 2,
         6),
        ('bfloat16 --epoch 1, switches on', 'smoke_bf16',
         ['--epoch', '1', '--dtype', 'bfloat16'], True, 2, 2)]
    launches = {}
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
        want = expected_launches(
            'faithful', torch.bfloat16 if 'bfloat16' in flags
            else torch.float32, switches, steps)
        check(counts == want, f'{label}: launches {counts} for {steps} '
              f'steps, expected {want}')
        params, _ = bridge.export_jax_params(state.nets)
        moved = {net: max(float(np.abs(a - b).max()) for a, b in zip(
            _leaves(params[net]), _leaves(run_start[net]))) for net in params}
        check(all(v > 0 for v in moved.values()), f'{label}: a group did '
              f'not move: {moved}')
        print(f'train CLI {label}: {steps} steps of batch '
              f'{config.batch_size} in {wall:.3f} s with start-up (host '
              f'clock); launches {counts} = per step K1 {K1_PER_STEP}, K2 '
              f'{K2_PER_STEP}, K5 {on * K5_PER_STEP}, K3 {on * K3_PER_STEP}, '
              f'K4 {on * K4_PER_STEP}; largest change per network in this '
              f'run: ' + ', '.join(f'{k} {v:.3g}' for k, v in moved.items())
              + f' [{card}]')
        print('  last metrics: ' + json.dumps(lines[-1]))
        if label == runs[0][0]:
            check(ckpt.steps(ckpt_dir) == [2, 5],
                  f'checkpoints {ckpt.steps(ckpt_dir)}, expected [2, 5]')
    return launches


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
            check(launches[label] == want, f'{label}: launches '
                  f'{launches[label]}, expected {want}')
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


def _held_to_cpu(label, got, cpu, jittered, params):
    """Prints and checks one card step `got` = (metrics, params) against
    the CPU step `cpu`: each metric within 3x the step's own sensitivity
    + 1e-4 of max(1, |value|), each network's update within 3x it + 1e-3
    of its norm. The sensitivity is the largest distance of a jittered
    run from its own unjittered run, over `jittered`: ((run, base), ...).
    Returns whether every difference is within its limit."""
    import numpy as np

    def flat(p, net):
        return np.concatenate([a.ravel() for a in _leaves(p[net])])

    ok = True
    got_m, got_p = got
    cpu_m, cpu_p = cpu
    print(f' card step {label}:')
    for k in sorted(cpu_m):
        diff = abs(got_m[k] - cpu_m[k])
        own = max(abs(run[0][k] - base[0][k]) for run, base in jittered)
        limit = 3 * own + 1e-4 * max(1.0, abs(cpu_m[k]))
        ok &= diff <= limit
        print(f'  {k}: card {got_m[k]:.6g} cpu {cpu_m[k]:.6g}, diff '
              f'{diff:.3g}, under 1e-6 input jitter {own:.3g}, limit '
              f'{limit:.3g}')
    for net in sorted(cpu_p):
        start = np.concatenate([a.ravel() for a in _leaves(params[net])])
        upd = {'card': flat(got_p, net) - start,
               'cpu': flat(cpu_p, net) - start}
        norm = np.linalg.norm(upd['cpu'])
        diff = np.linalg.norm(upd['card'] - upd['cpu'])
        own = max(np.linalg.norm(flat(run[1], net) - flat(base[1], net))
                  for run, base in jittered)
        limit = 3 * own + 1e-3 * norm
        ok &= diff <= limit
        print(f'  {net} update: |cpu| {norm:.4g}, |card - cpu| {diff:.3g} '
              f'(max abs {np.abs(upd["card"] - upd["cpu"]).max():.3g}), '
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
                                       K4_PER_STEP),
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
    the classifier switches off and on in turns (off, on, on, off, off,
    on: 5 steps a turn, 15 per setting), then the optimizer-group split
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
        for switches in (False, True, True, False, False, True):
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
                  f'{len(spans)} updates): {ms:.3f} ms (CUDA events, 3 turns '
                  f'of 5 back to back: ' + ', '.join(f'{t[0]:.3f}' for t in got)
                  + f'), {host_ms:.3f} ms one at a time (host clock, 9 '
                  f'steps); peak device memory '
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
            check(launched == want, f'{label}: launches per step '
                  f'{launched}, expected {want}')
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
                   tensors: int, ops_per_element: int, plain):
    """One kernel's time per call on `args` (the first its output's
    shape): device time from the profile of kernels named `match` (warm
    and cold L2) and CUDA events, beside its bound (`tensors` tensors of
    that shape moved once, `ops_per_element` float32 operations) and the
    plain version's time (`plain()`). Prints and returns them."""
    n, size = args[0].numel(), args[0].element_size()
    warm, cold = device_us(fn, match, cold_copies(
        lambda: tuple(t.clone() for t in args), tensors * n * size))
    ms = cuda_ms(lambda: fn(*args), 20)
    plain_ms = cuda_ms(plain, 5, warmup=1)
    by_bytes, by_ops = bounds_ms(n, size, tensors, ops_per_element)
    print(f'{label}: {key}: device {_us(warm)} warm / {_us(cold)} cold L2 '
          f'(profile), {ms:.4f} ms (CUDA events), bound '
          f'{max(by_bytes, by_ops):.4f} ms (bytes {by_bytes:.4f}, operations '
          f'{by_ops:.4f}), plain {plain_ms:.4f} ms; held to plain, two runs '
          f'bitwise equal [{card}]')
    return dict(ms=ms, device_ms=_ms(warm), cold_ms=_ms(cold),
                bound_ms=max(by_bytes, by_ops),
                bound_by='bytes' if by_bytes >= by_ops else 'operations',
                plain_ms=plain_ms)


def in_planes_timed(card: str, label: str, shapes):
    """K1 and K2 at batch 64 on each (C, H, W) of `shapes`, float32 and
    bfloat16: held to their plain versions by `in_checks.check_kernels`
    (TOL and K2_TOL, three activations, two runs bitwise equal, in the
    variant `instance_norm_plan` picks, the plain versions within the
    limits of float64), then timed per call with relu: device time from
    the profile (warm and cold L2) and CUDA events, beside the bound and
    the plain version's time. Returns ({'K1', 'K2'}: max abs error,
    {'K1 float32 [64, C, H, W] variant': {...ms...}, ...})."""
    import torch

    from edgegan_torch.ops import in_checks, kernels
    err = {'K1': 0.0, 'K2': 0.0}
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        for c, h, w in shapes:
            shape = (64, c, h, w)
            x, g = _batch64_inputs(shape, dtype, 11)
            variant = kernels.instance_norm_plan(
                h * w, dtype, x.data_ptr() | g.data_ptr())[0]
            e1, e2 = in_checks.check_kernels(
                x, g, TOL[dname], K2_TOL[dname], variant,
                label=f'{label} {dname} {list(shape)}')
            err['K1'], err['K2'] = max(err['K1'], e1), max(err['K2'], e2)
            for kname, match, fn, args, tensors, ops, plain in (
                    ('K1', 'instance_norm_act_fwd',
                     lambda t: kernels.instance_norm_act(t, 'relu'), (x,), 2,
                     K1_OPS_PER_ELEMENT,
                     lambda: kernels.instance_norm_act_plain(x, 'relu')),
                    ('K2', 'instance_norm_act_bwd',
                     lambda t, u: kernels.instance_norm_act_bwd(t, u, 'relu'),
                     (x, g), 3, K2_OPS_PER_ELEMENT,
                     lambda: kernels.instance_norm_act_bwd_plain(x, g,
                                                                 'relu'))):
                key = f'{kname} {dname} {list(shape)} {variant} relu'
                times[key] = per_call_times(card, label, key, match, fn,
                                            args, tensors, ops, plain)
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
    timed, `in_planes_timed`; the 1x1 planes in the multi-pass kernel),
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
        check(counts == want, f'{label}: launches {counts} for '
              f'{TIMED_STEPS + 1} steps, expected {want}')
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
        check(launches[run] == want, f'{run}: launches {launches[run]}, '
              f'expected {want}')
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
    check(launches['convnet E test'] == want, f'convnet E test: launches '
          f'{launches["convnet E test"]}, expected {want}')
    test_dir = os.path.join(out, 'convnet_e', 'test_output', 'ds')
    got = sorted(os.path.relpath(os.path.join(d, f), test_dir)
                 for d, _, fs in os.walk(test_dir) for f in fs)
    check(got == valid, f'convnet E test wrote {got}, expected {valid}')
    print(f'convnet E: cli.test from checkpoint 2 wrote {got}; K1 '
          f'{want["instance_norm_act"]} launches for one forward '
          f'({want["instance_norm_act.multi_pass"]} in the multi-pass '
          f'kernel: the 1x1 planes) [{card}]')
    return launches, steps, per_call, err


def hires_phase(card: str, tmp: str):
    """The hires configuration (HIRES: 128x128 halves, 128x256 pairs;
    BASELINE config 5) at batch 64, faithful, both classifier switches on:
    `cli.train` for 2 steps in float32 on synthetic 128x256 pairs (every
    metric finite, launches as planned: g_dconv_3's 64x64 planes and MRU
    unit 1's 128x128 gate in the multi-pass kernels); the step timed in
    float32 and bfloat16 (CUDA events over TIMED_STEPS steps after a
    warm-up, peak memory); K1/K2 on g_dconv_3's [64, 64, 64, 64] and
    K3/K4 on unit 1's [64, 8, 128, 128] held to their plain versions
    (two runs bitwise equal) and timed per call beside their bounds.
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
    check(counts == want, f'hires CLI: launches {counts}, expected {want}')
    rows = read_metrics(os.path.join(root, 'outputs', 'hires', 'logs',
                                     'metrics.jsonl'))
    check([r['step'] for r in rows] == [2, 3] and all(
        math.isfinite(v) for r in rows for v in r.values()),
        f'hires CLI metrics: {rows}')
    print(f'hires CLI: 2 steps of batch {b} at {h}x{w} in {wall:.3f} s with '
          f'start-up (host clock); per step K1 {want["instance_norm_act"] / 2:g}'
          f' ({want["instance_norm_act.multi_pass"] / 2:g} multi-pass), K2 '
          f'{want["instance_norm_act_bwd"] / 2:g} '
          f'({want["instance_norm_act_bwd.multi_pass"] / 2:g} multi-pass), '
          f'K5 {want["prelu_bwd"] / 2:g}, K3 {want["mru_gate_blend"] / 2:g} '
          f'({want["mru_gate_blend.multi_pass"] / 2:g} multi-pass), K4 '
          f'{want["mru_gate_bwd"] / 2:g} [{card}]')
    print('  last metrics: ' + json.dumps(rows[-1]))

    steps = {}
    for dtype in ('float32', 'bfloat16'):
        dconfig = Config(dtype=dtype, **HIRES).derive('train')
        ms, peak, counts = _timed_steps(dconfig, True)
        want = expected_launches('faithful', getattr(torch, dtype), True,
                                 TIMED_STEPS + 1, dconfig)
        check(counts == want, f'hires {dtype}: launches {counts}, expected '
              f'{want}')
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
        variant = kernels.gate_plan(shape[2] * shape[3], dtype, addr)[0]
        check(variant == 'multi_pass', f'unit 1 at hires: {variant}')
        e3, e4 = gate_checks.check_gate(
            rg, ht, img, g, TOL[dname], K2_TOL[dname], variant,
            label=f'hires unit 1 {dname} {list(shape)}')
        gate_err['K3'] = max(gate_err['K3'], e3)
        gate_err['K4'] = max(gate_err['K4'], e4)
        for kname, match, fn, args, tensors, ops, plain in (
                ('K3', 'mru_gate_fwd', kernels.mru_gate_blend, (rg, ht, img),
                 4, K3_OPS_PER_ELEMENT,
                 lambda: kernels.mru_gate_blend_plain(rg, ht, img)),
                ('K4', 'mru_gate_bwd', kernels.mru_gate_bwd, (rg, img, g), 5,
                 K4_OPS_PER_ELEMENT,
                 lambda: kernels.mru_gate_bwd_plain(rg, img, g))):
            key = f'{kname} {dname} {list(shape)} {variant}'
            per_call[key] = per_call_times(card, 'hires unit 1', key, match,
                                           fn, args, tensors, ops, plain)
    return launches, steps, per_call, {**err, **gate_err}


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


def group_split(card: str, step, spans, n: int = 5):
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

    def phase(name, fn, *args):
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
        phase('card_vs_cpu', card_vs_cpu_phase, card)
        phase('step_time', step_time_phase, card)
        phase('step_time fast', step_time_phase, card, 'fast')
        phase('variants', variants_phase, card, tmp)
        phase('hires', hires_phase, card, tmp)
        phase('host_cost', host_cost_phase, card)
    if failed:
        print(f'chip_smoke: failed phases: {", ".join(failed)}',
              file=sys.stderr)
        return 1

    k1_err, k1_sums, k1_prev = results['K1']
    k2_err, k2_sums, k2_prev = results['K2']
    k5_err, dleak_err, k5_steps = results['K5']
    gate_err, gate_steps = results['K3/K4']
    v_launches, v_steps, v_per_call, v_err = results['variants']
    h_launches, h_steps, h_per_call, h_err = results['hires']
    train_runs = {**results['train'], **results['lifecycle'], **v_launches,
                  **h_launches}

    def per_call(kname):
        """K1-K4's per-call times at this slice's new planes: the convnet
        encoder's (K1/K2) and the hires configuration's multi-pass ones."""
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
            fast_step_device_ms=fast_device_ms('prelu_bwd', True)),
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
        'host_us_per_call': results['host_cost']}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
