#!/usr/bin/env python3
"""Drive the PyTorch port (edgegan_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository; it needs one CUDA card and no
network. It exits non-zero, printing no result, when there is no card or
the package is missing, and on any failed check.

1. Prints the card's name and power limit (nvidia-smi) and builds the
   hand-written kernels from edgegan_torch/csrc (nvcc, sm_90a).
2. Kernel phase: K1 `instance_norm_act` against its plain PyTorch version
   on the card, at the three shapes the generators give it in serving
   (batch 16 and 64, float32 and bfloat16, no activation / relu / lrelu,
   one constant plane in each input), with the stated limits; its time
   from CUDA events beside its byte bound, the plain version's time and
   F.instance_norm + relu's (a yardstick only: not the same function).
3. Serving phase at full width: the default test configuration (64x128
   pairs, 14 classes, z_dim 100, gf_dim 64) with random weights from
   `bridge.random_jax_params` through the bridge, a `Batcher` on cuda
   behind `make_server` on 127.0.0.1, answering real HTTP requests. K1
   must have been launched 6 times per batch. One float32 batch is held
   against the port's CPU forward, and the time per batch is measured
   and split by `torch.profiler` into device work and device idle time.
4. Prints one JSON line describing every kernel, then
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
from __future__ import annotations

import http.client
import io
import json
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
SERVE_SHAPES = [(256, 8, 8), (128, 16, 16), (64, 32, 32)]  # g_dconv_1..3
K1_OPS_PER_ELEMENT = 8      # sum, sub, square, add, sub, div, act, cast
TOL = {'float32': dict(atol=2e-5, rtol=0.0),     # sums in another order
       'bfloat16': dict(atol=2e-2, rtol=2e-2)}   # output rounded to 8 bits


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
        kernels.LAUNCHES['instance_norm_act'] = 0
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


def profile_steps(card: str, label: str, step, n: int = 10):
    """Where a served batch's time goes on the card: `torch.profiler`
    over `n` back-to-back steps; prints the device work per batch (kernels
    and copies), its share of the window from the first device event to
    the last (the rest is the device waiting on the host), and the kernels
    that take the most device time."""
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
        return
    busy, reach, by_name = 0.0, spans[0][0], {}
    for start, end, name in spans:
        busy += max(0.0, end - max(start, reach))  # union of the intervals
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + end - start
    window = reach - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f'profile {label}: {len(spans) / n:.0f} device kernels and copies '
          f'per batch, device busy {busy / n / 1e3:.3f} ms per batch, '
          f'{100 * busy / window:.1f}% of the {window / n / 1e3:.3f} ms '
          f'window per batch [{card}]')
    for name, us in top:
        print(f'  {100 * us / busy:5.1f}% {us / n / 1e3:.4f} ms/batch '
              f'{name[:90]}')


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
          f'(nvcc {_build.build_seconds} s)')

    max_err, per_batch = kernel_phase(card)
    launches = serving_phase(card)

    # one served batch at max_batch 16 in bfloat16 (the serving default):
    # 3 shapes in each of G1 and G2
    k = per_batch[(16, 'bfloat16')]
    print(f'card: {card}')
    print(json.dumps({'kernels': [{
        'name': 'instance_norm_act',
        'route': 'cuda',
        'source': 'edgegan_torch/csrc/instance_norm_act.cu',
        'replaces': 'edgegan_tpu/ops/pallas_kernels.py:153',
        'launches': launches,
        'max_abs_err': max(max_err.values()),
        'max_abs_err_float32': max_err['float32'],
        'ms': 2 * k['ms'],
        'plain_ms': 2 * k['plain_ms'],
        'bound_ms': 2 * max(k['bytes_ms'], k['ops_ms']),
        'bound_by': 'bytes' if k['bytes_ms'] >= k['ops_ms'] else 'operations',
        'library_ms': None,
        'yardstick': {'call': 'F.relu(F.instance_norm(x)), eps inside the '
                              'sqrt: not the same function',
                      'ms': 2 * k['library_ms']},
        'work': 'one served batch: max_batch 16, bfloat16, relu, '
                '[16,256,8,8] + [16,128,16,16] + [16,64,32,32] in G1 and G2',
    }]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
