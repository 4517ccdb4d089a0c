"""Inference serving: HTTP + dynamic batching, on a CUDA device.

The same contract as the JAX package's serve.py:

  request -> bounded queue -> dispatch thread (collects up to `max_batch`
  or `max_wait_ms`, pads to a FIXED batch size, stages only the left
  half, launches the forward on a CUDA stream and records an event,
  without waiting) -> up to `depth` batches in flight -> sync thread
  waits on each batch's event, then fans the results back out.

The device computes batch N while the host collects batch N+1.

Data parallelism: under `torchrun --nproc_per_node N` rank 0 runs the HTTP
front end and the batching; each padded batch goes to every rank by
broadcast, each rank computes its rows (the batch-norm statistics over
the whole batch, `parallel.synced_batch_stats`), and rank 0 collects the
photos by one all-reduce of the zero-filled batch into which each rank
writes its rows, then copies them to the host. `--serve_batch` must
divide by N; `/healthz` reports the world size; the other ranks follow
rank 0 (`Batcher.follow`) and leave when it stops. While no request
comes, rank 0 sends an idle beat every IDLE_BEAT_S seconds, so that the
followers' wait stays within the collective timeout.

Endpoints:
  POST /generate?class_id=N   body: PNG/JPEG sketch pair (any size;
                              resized to the model's input). Returns a
                              PNG of the generated photo (the G2 half).
  POST /generate?raw=1        body: raw float32 [H,W,3] pair in [-1,1];
                              returns the raw float32 photo.
  POST /generate?raw=1&n=K    body: raw float32 [K,H,W,3]; returns the
                              stacked [K,h,w,3] photos. class_id may be
                              a comma-separated list of K ids.
  GET  /healthz               liveness (both pipeline threads) + stats;
                              503 when the pipeline is dead.

Usage:
  python -m edgegan_torch.serve --name <run> --port 8000 \
      --serve_batch 16 [--device cpu]
serves G1, G2 and E of the newest readable checkpoint under the run's
`checkpoint_dir` (`<outputsroot>/<name>/checkpoints`, as the trainer
writes it); `--weights weights.npz` (`bridge.save_npz`) serves those
weights instead.
"""
from __future__ import annotations

import collections
import io
import json
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from . import parallel
from .core.config import Config
from .infer import make_test_forward
from .train.networks import Networks

_XFER = {'bfloat16': torch.bfloat16, 'float32': torch.float32,
         'uint8': torch.uint8}
# what rank 0 broadcasts to the other ranks before each batch
_RUN, _IDLE, _STOP = 0, 1, 2
IDLE_BEAT_S = 10.0


class Overloaded(RuntimeError):
    """Submit queue is at capacity (or the batcher is draining): the
    request is shed immediately. Maps to HTTP 503 + Retry-After."""


def batch_eps(seed: int, step: int) -> torch.Tensor:
    """The two scalar encoder eps of batch `step`: a CPU generator seeded
    from (seed, step), the counterpart of `fold_in(PRNGKey(seed), step)`.
    Drawn on the host, so the CPU and the CUDA paths get the same eps."""
    g = torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, step]).generate_state(
            1, np.uint64)[0] >> np.uint64(1)))
    return torch.randn(2, generator=g)


class Batcher:
    """Collects requests into fixed-size padded batches and keeps up to
    `depth` batches in flight on the device.

    `nets` are the port's networks with weights loaded; the Batcher moves
    them to `device` and, for `transfer_dtype='bfloat16'`, makes one
    bfloat16 copy at start-up, so that images, weights and K1 all run in
    bfloat16 (the JAX package casts each weight per op: the same values).
    'float32' and 'uint8' compute in float32; uint8 moves exactly the
    bytes of the 8-bit PNG contract: the dequantise and the per-image
    contrast stretch run on the device.

    A failing forward delivers the exception to every waiting request
    instead of killing the pipeline.

    At two or more ranks, rank 0's Batcher runs the pipeline and the other
    ranks' Batchers run `follow()`; `max_batch` must divide by the world
    size.
    """

    def __init__(self, nets: Networks, config: Config,
                 max_batch: int = 16, max_wait_ms: float = 5.0,
                 seed: int = 0, depth: int = 2,
                 transfer_dtype: str = 'bfloat16',
                 max_queue: Optional[int] = None, device: str = 'cuda'):
        if transfer_dtype not in _XFER:
            raise ValueError(f'transfer_dtype {transfer_dtype!r}')
        self.world = parallel.world_size()
        if max_batch % self.world:
            raise ValueError(f'max_batch {max_batch} does not divide over '
                             f'{self.world} ranks')
        self.device = torch.device(device)
        self.input_hw = (config.output_height, config.output_width)
        self.num_classes = config.num_classes
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.depth = max(1, depth)
        self.seed = seed
        self._uint8 = transfer_dtype == 'uint8'
        self._xfer_dtype = _XFER[transfer_dtype]
        compute = (torch.bfloat16 if transfer_dtype == 'bfloat16'
                   else torch.float32)
        nets = nets.to(self.device)
        if compute != torch.float32:
            nets = nets.cast(compute)
        self.compute_dtype = compute
        self.forward = make_test_forward(nets, config)
        self._cuda = self.device.type == 'cuda'
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)
        self._n_dispatched = 0
        self.max_queue = (max_queue if max_queue is not None
                          else max(64, 8 * max_batch))
        self.queue: 'queue.Queue' = queue.Queue()
        self._inflight: 'queue.Queue' = queue.Queue(maxsize=self.depth)
        self._submit_lock = threading.Lock()
        self._draining = threading.Event()
        self.n_batches = 0
        self.n_requests = 0
        self.n_errors = 0
        self.n_shed = 0
        self._n_submitted = 0
        self._n_done = 0
        self._count_lock = threading.Lock()
        self.batch_occupancy: 'collections.deque' = collections.deque(
            maxlen=512)
        self._stop = threading.Event()
        self._last_beat = time.perf_counter()
        self.thread = threading.Thread(target=self._dispatch_loop,
                                       daemon=True)
        self.sync_thread = threading.Thread(target=self._sync_loop,
                                            daemon=True)
        if parallel.is_process_zero():
            self.thread.start()
            self.sync_thread.start()

    # ---------- the device step ----------

    def step(self, images: torch.Tensor, classes: torch.Tensor,
             step_idx: int) -> torch.Tensor:
        """One padded batch on the device, on the current stream: host
        NHWC images in the transfer dtype -> photos on the host (a
        pinned buffer on CUDA, filled asynchronously)."""
        x = images.to(self.device, non_blocking=True)
        cls = classes.to(self.device, non_blocking=True)
        if self.world > 1:
            self._send(_RUN, step_idx)
            parallel.broadcast_([x, cls])
        out = self._rows(x, cls, step_idx)
        if not self._cuda:
            return out
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        return host

    def _rows(self, x, cls, step_idx: int) -> torch.Tensor:
        """The photos of the padded batch `x` on the device, in the
        transfer dtype: at two or more ranks this rank computes its rows
        and every rank gets the whole batch's."""
        x, cls = parallel.local_rows(x), parallel.local_rows(cls)
        if self._uint8:
            # symmetric map: 128 -> exactly 0.0, so padding rows equal
            # the float path's zero padding (pad rows leak into every
            # row through the Q14 batch norm)
            x = (x.float() - 128.0) / 127.5
        with torch.inference_mode(), parallel.synced_batch_stats():
            _, photo = self.forward(x.to(self.compute_dtype), cls,
                                    batch_eps(self.seed, step_idx))
        if self._uint8:
            p = photo.float()
            cmin = p.amin(dim=(1, 2, 3), keepdim=True)
            cmax = p.amax(dim=(1, 2, 3), keepdim=True)
            cscale = torch.where(cmax == cmin, torch.ones_like(cmax),
                                 cmax - cmin)
            photo = ((p - cmin) * (255.0 / cscale) + 0.4999).clamp(0, 255)
        if self.world > 1:
            photo = self._gather(photo)
        return photo.to(self._xfer_dtype)

    def _gather(self, photo):
        """The whole batch's photos on every rank: each rank writes its
        rows into a zero-filled batch, and the ranks' batches are summed
        (exactly: every other rank adds zeros)."""
        rows = photo.shape[0]
        with torch.inference_mode():
            full = torch.zeros((rows * self.world, *photo.shape[1:]),
                               dtype=torch.float32, device=self.device)
            full[parallel.rank() * rows:][:rows] = photo.float()
            parallel.all_reduce_sum_([full])
        return full

    # ---------- the ranks other than 0 ----------

    def _send(self, command: int, step_idx: int = 0):
        """Rank 0: tell the other ranks what comes next."""
        header = torch.tensor([command, step_idx], device=self.device)
        parallel.broadcast_([header])
        self._last_beat = time.perf_counter()

    def follow(self):
        """A rank other than 0: compute its rows of every batch that rank
        0 sends, until rank 0 stops."""
        h, w = self.input_hw
        while True:
            header = torch.zeros(2, dtype=torch.int64, device=self.device)
            parallel.broadcast_([header])
            command, step_idx = header.tolist()
            if command == _STOP:
                return
            if command == _IDLE:
                continue
            x = torch.empty((self.max_batch, h, w // 2, 3),
                            dtype=self._xfer_dtype, device=self.device)
            cls = torch.empty((self.max_batch,), dtype=torch.int64,
                              device=self.device)
            parallel.broadcast_([x, cls])
            self._rows(x, cls, step_idx)

    # ---------- request intake ----------

    def submit(self, image: np.ndarray, class_id: int) -> 'queue.Queue':
        """image: [H, W, 3] pair OR [H, W/2, 3] left half, in [-1, 1]
        (only the left half is read). Returns a queue delivering the
        generated [h, w/2, 3] photo, or an Exception if the forward
        failed. Raises Overloaded when the submit queue is full."""
        return self.submit_many([(image, class_id)])[0]

    def submit_many(self, items) -> list:
        """Atomically enqueue a list of (image, class_id): a bulk request
        is shed whole. Raises Overloaded at capacity or while draining."""
        outs = [queue.Queue(maxsize=1) for _ in items]
        with self._submit_lock:
            if self._draining.is_set():
                self.n_shed += len(items)
                raise Overloaded('server is draining')
            if self.queue.qsize() + len(items) > self.max_queue:
                self.n_shed += len(items)
                raise Overloaded(f'queue full ({self.max_queue} pending)')
            for (image, class_id), out in zip(items, outs):
                self.queue.put((image, class_id, out))
            with self._count_lock:
                self._n_submitted += len(items)
        return outs

    def _fail(self, batch, exc):
        self.n_errors += 1
        with self._count_lock:
            self._n_done += len(batch)
        for _, _, out in batch:
            out.put(exc)

    def _collect(self):
        try:
            first = self.queue.get(timeout=0.1)
        except queue.Empty:
            return None
        batch = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _stage(self, batch):
        """Fixed-shape padded host batch of left halves, in the transfer
        dtype. Padding rows are 0 (128 in uint8 mode, which dequantises
        to 0): the generator's first norm is train-mode BATCH norm (Q14),
        so pad-row values leak into every row."""
        h, w = self.input_hw
        half_w = w // 2
        n = len(batch)
        lefts = np.stack([img[:h, :half_w] for img, _, _ in batch])
        images = np.empty((self.max_batch, h, half_w, 3),
                          np.uint8 if self._uint8 else np.float32)
        if self._uint8:
            images[:n] = np.clip(np.round(lefts * 127.5 + 128.0), 0, 255)
            images[n:] = 128
        else:
            images[:n] = lefts
            images[n:] = 0
        classes = np.zeros((self.max_batch,), np.int64)
        classes[:n] = [cid for _, cid, _ in batch]
        host = torch.from_numpy(images).to(self._xfer_dtype)
        if self._cuda:
            host = host.pin_memory()
        return host, torch.from_numpy(classes)

    def _dispatch_loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            if batch is None:
                if (self.world > 1 and time.perf_counter() - self._last_beat
                        > IDLE_BEAT_S):
                    self._send(_IDLE)
                continue
            try:
                images, classes = self._stage(batch)
                event = None
                if self._cuda:
                    with torch.cuda.stream(self._stream):
                        out = self.step(images, classes, self._n_dispatched)
                        event = torch.cuda.Event()
                        event.record(self._stream)
                else:
                    out = self.step(images, classes, self._n_dispatched)
                self._n_dispatched += 1
            except Exception as e:  # immediate failure: answer, go on
                traceback.print_exc()
                self._fail(batch, e)
                continue
            self._inflight.put((batch, out, event))  # backpressure

    def _sync_loop(self):
        while not self._stop.is_set():
            try:
                batch, out, event = self._inflight.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                if event is not None:
                    event.synchronize()
                arr = (out.numpy() if self._uint8
                       else out.float().numpy())
                for i, (_, _, q) in enumerate(batch):
                    q.put(arr[i])
                with self._count_lock:
                    self._n_done += len(batch)
            except Exception as e:  # deferred device-side failure
                self._fail(batch, e)
            finally:
                self.n_batches += 1
                self.n_requests += len(batch)
                self.batch_occupancy.append(len(batch))

    # ---------- lifecycle ----------

    def healthy(self) -> bool:
        return self.thread.is_alive() and self.sync_thread.is_alive()

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop accepting new work and wait until every accepted request
        has been answered. True if drained within the timeout."""
        self._draining.set()
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._count_lock:
                if self._n_done >= self._n_submitted:
                    return True
            time.sleep(0.02)
        return False

    def stop(self, drain: bool = False, timeout: float = 30.0):
        """Shut the pipeline down; drain=True first answers every
        accepted request."""
        if drain:
            self.drain(timeout)
        self._stop.set()
        self.thread.join(timeout=5)
        self.sync_thread.join(timeout=5)
        if self.world > 1 and parallel.is_process_zero():
            self._send(_STOP)

    def stats(self):
        occ = list(self.batch_occupancy)[-100:]
        return {
            'requests': self.n_requests,
            'batches': self.n_batches,
            'errors': self.n_errors,
            'shed': self.n_shed,
            'queue_depth': self.queue.qsize(),
            'max_queue': self.max_queue,
            'draining': self._draining.is_set(),
            'mean_recent_occupancy': (float(np.mean(occ)) if occ else 0.0),
            'max_batch': self.max_batch,
            'depth': self.depth,
            'device': str(self.device),
            'world_size': self.world,
        }


def _decode_request(body: bytes, input_hw) -> np.ndarray:
    """PNG/JPEG bytes -> [-1,1] pair-layout array via the training
    transform (bytescale quirk included)."""
    from PIL import Image
    from .utils.images import transform
    h, w = input_hw
    img = np.asarray(Image.open(io.BytesIO(body)).convert('RGB'),
                     np.float64)
    return transform(img, h, w, h, w, crop=False).astype(np.float32)


def _encode_png(image: np.ndarray) -> bytes:
    from PIL import Image
    from .utils.images import bytescale, inverse_transform
    if image.dtype == np.uint8:  # uint8 transfer mode: already stretched
        data = image
    else:
        data = bytescale(inverse_transform(np.asarray(image, np.float64)))
    buf = io.BytesIO()
    Image.fromarray(data).save(buf, format='PNG')
    return buf.getvalue()


def make_server(config: Config, batcher: Batcher, port: int = 8000,
                host: str = '127.0.0.1') -> ThreadingHTTPServer:
    input_hw = (config.output_height, config.output_width)

    class Server(ThreadingHTTPServer):
        # the stdlib default listen backlog of 5 drops connections under
        # concurrent load
        request_queue_size = 128

    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'  # keep-alive; Content-Length is set

        def log_message(self, *args):
            pass

        def _reply(self, status, ctype, body, headers=()):
            self.send_response(status)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if not self.path.startswith('/healthz'):
                self.send_error(404)
                return
            ok = batcher.healthy()
            body = json.dumps({'ok': ok, **batcher.stats()}).encode()
            self._reply(200 if ok else 503, 'application/json', body)

        def _parse(self):
            class_ids, raw, n = [0], False, 1
            if '?' in self.path:
                for kv in self.path.split('?', 1)[1].split('&'):
                    k, _, v = kv.partition('=')
                    if k == 'class_id':
                        class_ids = [int(c) for c in v.split(',')]
                    elif k == 'raw':
                        raw = v not in ('', '0', 'false')
                    elif k == 'n':
                        n = int(v)
            if not 1 <= n <= 4096:
                raise ValueError(f'n {n} out of range')
            if n > 1 and not raw:
                raise ValueError('n>1 requires raw=1')
            if len(class_ids) == 1:
                class_ids = class_ids * n
            if len(class_ids) != n:
                raise ValueError(f'{len(class_ids)} class_ids for n={n}')
            for cid in class_ids:
                if not 0 <= cid < (batcher.num_classes or 1):
                    raise ValueError(f'class_id {cid} out of range')
            body = self.rfile.read(int(self.headers.get('Content-Length',
                                                        0)))
            if raw:
                h, w = input_hw
                images = np.frombuffer(body, '<f4')
                if images.size != n * h * w * 3:
                    raise ValueError(f'raw body must be {n}x{h}x{w}x3 '
                                     'float32')
                images = images.reshape(n, h, w, 3)
            else:
                images = _decode_request(body, input_hw)[None]
            return images, class_ids, raw

        def do_POST(self):
            if not self.path.startswith('/generate'):
                self.send_error(404)
                return
            try:
                images, class_ids, raw = self._parse()
            except Exception as e:  # bad request
                self.send_error(400, str(e))
                return
            try:
                outs = batcher.submit_many(list(zip(images, class_ids)))
            except Overloaded as e:
                self._reply(503, 'text/plain', f'overloaded: {e}'.encode(),
                            [('Retry-After', '1')])
                return
            photos = []
            for out in outs:
                try:
                    photo = out.get(timeout=60)
                except queue.Empty:
                    self.send_error(503, 'inference timed out')
                    return
                if isinstance(photo, Exception):
                    self.send_error(503, f'inference failed: {photo!r}')
                    return
                photos.append(photo)
            if raw:
                stacked = np.stack(photos)
                body = (stacked.tobytes() if stacked.dtype == np.uint8
                        else np.ascontiguousarray(stacked, '<f4').tobytes())
                self._reply(200, 'application/octet-stream', body)
            else:
                self._reply(200, 'image/png', _encode_png(photos[0]))

    return Server((host, port), Handler)


def main(argv=None):
    import argparse

    from .core.config import add_config_args, config_from_args

    parser = argparse.ArgumentParser('edgegan_torch.serve')
    add_config_args(parser, 'test')
    parser.add_argument('--weights', type=str, default=None,
                        help='npz of the G1/G2/E trees (bridge.save_npz), '
                             'served instead of the newest checkpoint')
    parser.add_argument('--device', type=str, default='cuda',
                        choices=['cuda', 'cpu'],
                        help="'cuda' runs on cuda:<gpu> (under a launcher "
                             'cuda:<LOCAL_RANK>)')
    parser.add_argument('--port', type=int, default=8000)
    parser.add_argument('--host', type=str, default='127.0.0.1')
    parser.add_argument('--serve_batch', type=int, default=16)
    parser.add_argument('--max_wait_ms', type=float, default=5.0)
    parser.add_argument('--serve_depth', type=int, default=2,
                        help='device batches kept in flight')
    parser.add_argument('--max_queue', type=int, default=0,
                        help='submit-queue bound before load shedding '
                             '(503 + Retry-After); 0 = 8 full batches')
    parser.add_argument('--transfer_dtype', type=str, default='bfloat16',
                        choices=list(_XFER),
                        help='host<->device dtype; bfloat16 also computes '
                             'in bfloat16, the others in float32')
    args = parser.parse_args(argv)
    config = config_from_args(args).derive('test')
    device = parallel.init(args.device, config.gpu, config.data_parallel)
    try:
        _serve(args, config, device)
    finally:
        parallel.shutdown()


def _serve(args, config, device):
    from . import checkpoint as ckpt
    from .bridge import load_jax_params, load_npz

    p0 = parallel.is_process_zero()
    nets = Networks(config)
    if args.weights:
        params, aux = load_npz(args.weights)
        if p0:
            print(f' [*] serving weights {args.weights}')
    else:
        # rank 0 picks the entry, every rank reads that one
        loaded, counter, trees = (ckpt.load_raw(config.checkpoint_dir)
                                  if p0 else (False, 0, None))
        counter = parallel.broadcast_object(counter if loaded else None)
        if counter is None:
            raise SystemExit(f'no checkpoint under {config.checkpoint_dir}')
        if trees is None:
            _, _, trees = ckpt.load_raw(config.checkpoint_dir, counter)
        params, aux = trees['params'], trees['aux']
        if p0:
            print(f' [*] serving checkpoint step {counter}')
    load_jax_params(nets, params, aux)
    batcher = Batcher(nets, config, max_batch=args.serve_batch,
                      max_wait_ms=args.max_wait_ms, seed=config.seed,
                      depth=args.serve_depth,
                      transfer_dtype=args.transfer_dtype,
                      max_queue=args.max_queue or None, device=str(device))
    if not p0:
        batcher.follow()
        return
    # build the kernels and warm cuDNN before accepting traffic
    warm = batcher.submit(np.zeros((config.output_height,
                                    config.output_width, 3), np.float32), 0)
    res = warm.get(timeout=600)
    if isinstance(res, Exception):
        raise SystemExit(f'warm-up batch failed: {res!r}')
    print(f' [*] ready; listening on {args.host}:{args.port}')
    server = make_server(config, batcher, args.port, args.host)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        print(' [*] draining...')
        batcher.stop(drain=True)


if __name__ == '__main__':
    main()
