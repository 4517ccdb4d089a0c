#!/usr/bin/env python3
"""Drive the PyTorch port (edgegan_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository; it needs one CUDA card and no
network. It exits non-zero, printing no result, when there is no card or
the package is missing, and on any failed check.

1. Prints the card's name and power limit (nvidia-smi) and builds the
   hand-written kernels from edgegan_torch/csrc (nvcc, sm_90a).
2. K1 phase: `instance_norm_act` against its plain PyTorch version on the
   card, at the three shapes the generators give it (batch 16 and 64,
   float32 and bfloat16, no activation / relu / lrelu, one constant plane
   in each input), with the stated limits; its time from CUDA events
   beside its byte bound, the plain version's time and F.instance_norm +
   relu's (a yardstick only: not the same function).
3. K2 phase: `instance_norm_act_bwd` the same way against
   `instance_norm_act_bwd_plain`, and the autograd Function's gradient
   (K1 forward, K2 backward) against autograd of the plain forward.
4. Serving phase at full width: the default test configuration (64x128
   pairs, 14 classes, z_dim 100, gf_dim 64) with random weights from
   `bridge.random_jax_params` through the bridge, a `Batcher` on cuda
   behind `make_server` on 127.0.0.1, answering real HTTP requests. K1
   must have been launched 6 times per batch. One float32 batch is held
   against the port's CPU forward, and the time per batch is measured
   and split by `torch.profiler` into device work and device idle time.
5. Training phase at full width: `python -m edgegan_torch.cli.train`'s
   `main` with the default training configuration (batch 64, 14 classes,
   float32, faithful 7-group step) on a synthetic PNG dataset of two
   batches per epoch, for 2 epochs (4 steps, checkpoints 2 and 5), then
   again for 1 epoch, which must resume at counter 5. Every metric must
   be finite, every optimizer group must move, and K1 and K2 must launch
   21 and 12 times per step.
6. One training step at full width and batch 4 on the card against the
   same step on the CPU, from the same weights and random draws.
7. Time per training step at batch 64 (CUDA events and host clock), its
   device time per optimizer group, and its `torch.profiler` split.
8. Prints one JSON line describing every kernel, then
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
from __future__ import annotations

import http.client
import io
import json
import os
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
K1_PER_STEP = 21   # 7 generator forwards (G1 alone for the encoder's input)
K2_PER_STEP = 12   # 2 generator updates x (G1, G2) x 3 DeconvBlocks


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


def kernel_phase(card: str):
    """K1 against its plain version at the serving shapes; returns the
    numbers for the JSON line."""
    import torch
    import torch.nn.functional as F

    from edgegan_torch.ops import kernels
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {'float32': 0.0, 'bfloat16': 0.0}
    per_batch = {}  # (batch, dtype) -> summed ms over the three shapes
    for batch in (16, 64):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split('.')[-1]
            sums = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                        library_ms=0.0)
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
                ms = cuda_ms(lambda: kernels.instance_norm_act(x, 'relu'),
                             200)
                plain = cuda_ms(
                    lambda: kernels.instance_norm_act_plain(x, 'relu'), 50)
                lib = cuda_ms(lambda: F.relu(F.instance_norm(x)), 200)
                by_bytes, by_ops = k1_bounds_ms(shape, dtype)
                print(f'K1 time {dname} {list(shape)} relu: {ms:.4f} ms, '
                      f'bound {max(by_bytes, by_ops):.4f} ms (bytes '
                      f'{by_bytes:.4f}, operations {by_ops:.4f}), plain '
                      f'{plain:.4f} ms, F.instance_norm+relu {lib:.4f} ms '
                      f'(not the same function: eps is inside the sqrt) '
                      f'[{card}]')
                for k, v in zip(('ms', 'plain_ms', 'bytes_ms', 'ops_ms',
                                 'library_ms'),
                                (ms, plain, by_bytes, by_ops, lib)):
                    sums[k] += v
            per_batch[(batch, dname)] = sums
            print(f'K1 per generator (3 launches) at batch {batch} {dname}: '
                  + ', '.join(f'{k} {v:.4f}' for k, v in sums.items())
                  + f' [{card}]')
    return max_err, per_batch


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

    from edgegan_torch.ops import kernels
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = {'float32': 0.0, 'bfloat16': 0.0}
    per_batch = {}
    for batch in (16, 64):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split('.')[-1]
            tol = K2_TOL[dname]
            sums = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                        yardstick_ms=0.0)
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
                ms = cuda_ms(lambda: kernels.instance_norm_act_bwd(
                    x, g, 'relu'), 200)
                plain = cuda_ms(lambda: kernels.instance_norm_act_bwd_plain(
                    x, g, 'relu'), 50)
                xr = x.detach().requires_grad_(True)
                yr = F.relu(F.instance_norm(xr))
                yard = cuda_ms(lambda: torch.autograd.grad(
                    yr, xr, g, retain_graph=True), 200)
                by_bytes, by_ops = k2_bounds_ms(shape, dtype)
                print(f'K2 time {dname} {list(shape)} relu: {ms:.4f} ms, '
                      f'bound {max(by_bytes, by_ops):.4f} ms (bytes '
                      f'{by_bytes:.4f}, operations {by_ops:.4f}), plain '
                      f'{plain:.4f} ms, backward of F.instance_norm+relu '
                      f'{yard:.4f} ms (a yardstick, not the same function: '
                      f'eps is inside the sqrt) [{card}]')
                for k, v in zip(('ms', 'plain_ms', 'bytes_ms', 'ops_ms',
                                 'yardstick_ms'),
                                (ms, plain, by_bytes, by_ops, yard)):
                    sums[k] += v
            per_batch[(batch, dname)] = sums
            print(f'K2 per generator backward (3 launches) at batch {batch} '
                  f'{dname}: ' + ', '.join(f'{k} {v:.4f}'
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
    return max_err, per_batch


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
        check(kernels.LAUNCHES['instance_norm_act_bwd'] == 0,
              'serving launched K2')
        print(f'serving: 4 PNG + 1 raw n=8 + healthz answered 200 in '
              f'{wall:.3f} s (host clock); {batches} batches, K1 launches '
              f'{launches} = 6 per batch [{card}]')
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


def _read_metrics(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def train_phase(card: str, tmp: str):
    """The training CLI at full width on cuda: 2 epochs of 2 batches (4
    steps, checkpoints 2 and 5), then 1 epoch resumed at counter 5.
    Returns the K1 and K2 launch counts of the two runs."""
    import math

    import numpy as np
    import torch

    from edgegan_torch import bridge
    from edgegan_torch import checkpoint as ckpt
    from edgegan_torch.cli import train as train_cli
    from edgegan_torch.core.config import Config
    from edgegan_torch.ops import kernels

    config = Config().derive('train')
    root = os.path.join(tmp, 'data')
    write_dataset(root, 2 * config.batch_size, config.num_classes,
                  config.output_height, config.output_width)
    out = os.path.join(tmp, 'outputs')
    args = ['--dataroot', root, '--dataset', 'ds', '--outputsroot', out,
            '--name', 'smoke', '--save_checkpoint_frequency', '3']
    ckpt_dir = os.path.join(out, 'smoke', 'checkpoints')
    log = os.path.join(out, 'smoke', 'logs', 'metrics.jsonl')
    start, _ = bridge.random_jax_params(config, config.seed, critics=True)
    launches = []
    for epochs, steps, first in ((2, 4, 2), (1, 2, 6)):
        n_lines = len(_read_metrics(log)) if os.path.exists(log) else 0
        if first > 2:   # the resumed run starts from checkpoint 5
            start = ckpt.read(ckpt_dir, 5)[0]['params']
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        state = train_cli.main(args + ['--epoch', str(epochs)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        launches.append(counts)
        lines = _read_metrics(log)[n_lines:]
        if first > 2:
            check(lines and lines[0] == {'resumed_at': 5},
                  f'no resume at counter 5: {lines[:1]}')
            lines = lines[1:]
        check([m['step'] for m in lines] == list(range(first, first + steps)),
              f'steps logged: {[m.get("step") for m in lines]}')
        for m in lines:
            vals = {k: v for k, v in m.items() if k not in ('step', 'epoch')}
            check(len(vals) == 11 and all(math.isfinite(v)
                                          for v in vals.values()),
                  f'metrics at step {m["step"]}: {vals}')
        check(counts['instance_norm_act'] == K1_PER_STEP * steps
              and counts['instance_norm_act_bwd'] == K2_PER_STEP * steps,
              f'launches {counts} for {steps} steps')
        params, _ = bridge.export_jax_params(state.nets)
        moved = {net: max(float(np.abs(a - b).max()) for a, b in zip(
            _leaves(params[net]), _leaves(start[net]))) for net in params}
        check(all(v > 0 for v in moved.values()), f'a group did not move: '
              f'{moved}')
        print(f'train CLI --epoch {epochs}: {steps} steps of batch '
              f'{config.batch_size} in {wall:.3f} s with start-up (host '
              f'clock); K1 {counts["instance_norm_act"]} and K2 '
              f'{counts["instance_norm_act_bwd"]} launches = '
              f'{K1_PER_STEP} and {K2_PER_STEP} per step; largest change '
              f'per network in this run: '
              + ', '.join(f'{k} {v:.3g}' for k, v in moved.items())
              + f' [{card}]')
        print('  last metrics: ' + json.dumps(lines[-1]))
        if first == 2:
            check(ckpt.steps(ckpt_dir) == [2, 5],
                  f'checkpoints {ckpt.steps(ckpt_dir)}, expected [2, 5]')
    check(state.step == 6, f'train state step {state.step} after the resume')
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


def card_vs_cpu_phase(card: str):
    """One full-width step at batch 4 on the card and on the CPU from the
    same weights and draws. The GAN's step amplifies rounding (the gradient
    penalty differentiates the critics' lrelu kinks and instance norms
    twice), so the limit on each difference is set from the CPU's own
    sensitivity, measured in the same run: the CPU step again with the
    images and the latents moved by about one part in 1e6."""
    import numpy as np

    from edgegan_torch import bridge
    from edgegan_torch.core.config import Config

    config = Config(batch_size=4).derive('train')
    params, aux = bridge.random_jax_params(config, 1, critics=True)
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
    t0 = time.perf_counter()
    card_m, card_p = _one_step(config, params, aux, 'cuda', images, z, draws)
    cpu_m, cpu_p = _one_step(config, params, aux, 'cpu', images, z, draws)
    jit_m, jit_p = _one_step(config, params, aux, 'cpu', jitter(images), z,
                             dict(draws, z=jitter(draws['z'])))
    print(f'card vs CPU: 3 steps in {time.perf_counter() - t0:.1f} s '
          f'[{card}]')
    ok = True
    for k in sorted(cpu_m):
        diff, own = abs(card_m[k] - cpu_m[k]), abs(jit_m[k] - cpu_m[k])
        limit = 3 * own + 1e-4 * max(1.0, abs(cpu_m[k]))
        ok &= diff <= limit
        print(f'  {k}: card {card_m[k]:.6g} cpu {cpu_m[k]:.6g}, diff '
              f'{diff:.3g}, CPU under 1e-6 input jitter {own:.3g}, limit '
              f'{limit:.3g}')
    for net in sorted(cpu_p):
        start = np.concatenate([a.ravel() for a in _leaves(params[net])])
        upd = {name: np.concatenate([a.ravel() for a in _leaves(p[net])])
               - start for name, p in (('card', card_p), ('cpu', cpu_p),
                                       ('jit', jit_p))}
        norm = np.linalg.norm(upd['cpu'])
        diff = np.linalg.norm(upd['card'] - upd['cpu'])
        own = np.linalg.norm(upd['jit'] - upd['cpu'])
        limit = 3 * own + 1e-3 * norm
        ok &= diff <= limit
        print(f'  {net} update: |cpu| {norm:.4g}, |card - cpu| {diff:.3g} '
              f'(max abs {np.abs(upd["card"] - upd["cpu"]).max():.3g}), '
              f'|cpu jittered - cpu| {own:.3g}, limit {limit:.3g}')
    check(ok, 'the card step differs from the CPU step beyond the limits')


def step_time_phase(card: str):
    """Time per training step at the default batch 64 in float32 on a
    staged batch; returns K1's and K2's device time per step from the
    profile."""
    import numpy as np
    import torch

    from edgegan_torch import bridge
    from edgegan_torch.core.config import Config
    from edgegan_torch.train.networks import Networks
    from edgegan_torch.train.state import create_train_state
    from edgegan_torch.train.step import make_draws, make_train_step

    config = Config().derive('train')
    b, h, w = config.batch_size, config.output_height, config.output_width
    nets = bridge.load_jax_params(Networks(config, critics=True),
                                  *bridge.random_jax_params(
                                      config, 0, critics=True)).to('cuda')
    state = create_train_state(nets)
    step = make_train_step(nets, config)
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.uniform(-1, 1, (b, h, w, 3)).astype(
        np.float32)).cuda()
    z = torch.from_numpy(rng.randint(0, config.num_classes, (b, 1)).astype(
        np.float32)).cuda()
    gen = torch.Generator(device='cuda').manual_seed(0)
    draws = make_draws(config, b, gen, 'cuda')

    def one():
        step(state, images, z, draws)

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(one, 10, warmup=2)
    t0 = time.perf_counter()
    for _ in range(5):
        one()
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'time per training step at batch {b} float32 (faithful, 7 '
          f'groups): {ms:.3f} ms (CUDA events, 10 back to back), '
          f'{host_ms:.3f} ms one at a time (host clock); peak device memory '
          f'{peak:.2f} GiB [{card}]')
    group_split(card, one)
    by_name = profile_steps(card, f'training step batch {b} float32', one,
                            n=5, unit='step')
    per_step = {}
    for kname in ('instance_norm_act_fwd', 'instance_norm_act_bwd'):
        per_step[kname] = sum(v for k, v in by_name.items()
                              if kname in k)
        print(f'  {kname}: {per_step[kname]:.4f} ms of device time per '
              f'step (profile) [{card}]')
    return ms, per_step


# the step's optimizer updates in order; each update ends one span of
# device time, which holds that group's forward and backward
GROUP_SPANS = ['joint critic D (with the shared fakes)', 'image critic D_patch2',
               'edge critic D_patch3', 'classifier D2',
               'generators, 1st update (G1 slots)', 'G2 slots',
               'encoder E (with the G1 forward)',
               'generators, 2nd update (G1 slots)', 'G2 slots']


def group_split(card: str, step, n: int = 5):
    """Device time per optimizer group of a training step: a CUDA event is
    recorded after every RMSProp update (one per group and generator), so
    the time between two events is one group's forward, backward and
    update. Averaged over `n` back-to-back steps."""
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
        spans = [0.0] * len(GROUP_SPANS)
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            marks.clear()
            step()
            torch.cuda.synchronize()
            if len(marks) != len(GROUP_SPANS):
                raise RuntimeError(f'{len(marks)} optimizer updates per step')
            for i, event in enumerate(marks):
                spans[i] += (marks[i - 1] if i else start).elapsed_time(
                    event) / n
    finally:
        RMSProp.update = update
    total = sum(spans)
    print(f'training step by optimizer group (CUDA events, {n} steps): '
          f'{total:.3f} ms [{card}]')
    for name, ms in zip(GROUP_SPANS, spans):
        print(f'  {100 * ms / total:5.1f}% {ms:8.3f} ms  {name}')


def profile_steps(card: str, label: str, step, n: int = 10,
                  unit: str = 'batch'):
    """Where a step's time goes on the card: `torch.profiler` over `n`
    back-to-back steps; prints the device work per step (kernels and
    copies), its share of the window from the first device event to the
    last (the rest is the device waiting on the host), and the kernels
    that take the most device time. Returns {kernel name: device ms per
    step}."""
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
        return {}
    busy, reach, by_name = 0.0, spans[0][0], {}
    for start, end, name in spans:
        busy += max(0.0, end - max(start, reach))  # union of the intervals
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + end - start
    window = reach - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f'profile {label}: {len(spans) / n:.0f} device kernels and copies '
          f'per {unit}, device busy {busy / n / 1e3:.3f} ms per {unit}, '
          f'{100 * busy / window:.1f}% of the {window / n / 1e3:.3f} ms '
          f'window per {unit} [{card}]')
    for name, us in top:
        print(f'  {100 * us / busy:5.1f}% {us / n / 1e3:.4f} ms/{unit} '
              f'{name[:90]}')
    return {k: v / n / 1e3 for k, v in by_name.items()}


def _kernel_entry(name, source, replaces, sums, scale, launches,
                  max_err, work, **extra):
    """One kernel's record for the JSON line: `sums` holds the summed
    per-shape times and bounds of one pass over the three shapes, and
    `scale` the number of such passes in the work described."""
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
        phase('K1', kernel_phase, card)
        phase('K2', k2_phase, card)
        phase('serve', serving_phase, card)
        phase('train', train_phase, card, tmp)
        phase('card_vs_cpu', card_vs_cpu_phase, card)
        phase('step_time', step_time_phase, card)
    if failed:
        print(f'chip_smoke: failed phases: {", ".join(failed)}',
              file=sys.stderr)
        return 1

    k1_err, k1_sums = results['K1']
    k2_err, k2_sums = results['K2']
    train_runs = results['train']
    step_ms, prof = results['step_time']
    k1_launches = {'serve': results['serve'],
                   'train --epoch 2': train_runs[0]['instance_norm_act'],
                   'train resume --epoch 1':
                       train_runs[1]['instance_norm_act']}
    k2_launches = {'train --epoch 2': train_runs[0]['instance_norm_act_bwd'],
                   'train resume --epoch 1':
                       train_runs[1]['instance_norm_act_bwd']}
    k1 = k1_sums[(16, 'bfloat16')]
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
            train_step_ms=K1_PER_STEP / 3 * k1_sums[(64, 'float32')]['ms'],
            train_step_device_ms=prof.get('instance_norm_act_fwd')),
        # one training step at batch 64 in float32: the three shapes in
        # each of 2 generator updates x (G1, G2)
        _kernel_entry(
            'instance_norm_act_bwd', 'edgegan_torch/csrc/instance_norm_act.cu',
            'edgegan_tpu/ops/pallas_kernels.py:167', k2_sums[(64, 'float32')],
            K2_PER_STEP // 3, k2_launches, k2_err,
            'one training step: batch 64, float32, relu, 4 calls at each of '
            '[64,256,8,8], [64,128,16,16], [64,64,32,32] (2 generator '
            'updates x G1, G2)',
            yardstick={'call': 'backward of F.relu(F.instance_norm(x)), eps '
                               'inside the sqrt: not the same function',
                       'ms': 4 * k2_sums[(64, 'float32')]['yardstick_ms']},
            train_step_device_ms=prof.get('instance_norm_act_bwd')),
    ], 'train_step_ms': step_ms}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
