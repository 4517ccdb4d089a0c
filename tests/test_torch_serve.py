"""The port's serving path (edgegan_torch.serve) on the CPU: Batcher and
HTTP server round trips, uint8 mode, shedding and drain, and a served
batch against the port forward on the same padded batch and eps."""
import http.client
import io
import json
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from edgegan_torch import bridge
from edgegan_torch.core.config import Config
from edgegan_torch.infer import make_test_forward
from edgegan_torch.serve import Batcher, Overloaded, batch_eps, make_server
from edgegan_torch.train.networks import Networks
from test_torch_variants import few_threads  # noqa: F401

H, W = 32, 64
CFG = Config(num_classes=3, z_dim=8, output_height=H, output_width=W,
             input_height=H, input_width=W).derive('test')


def _nets():
    params, aux = bridge.random_jax_params(CFG, seed=0, gf_dim=8)
    return bridge.load_jax_params(Networks(CFG, gf_dim=8), params, aux)


def _batcher(transfer_dtype='float32', **kw):
    kw.setdefault('max_batch', 4)
    kw.setdefault('max_wait_ms', 30.0)
    return Batcher(_nets(), CFG, device='cpu',
                   transfer_dtype=transfer_dtype, **kw)


@pytest.fixture(scope='module')
def served():
    batcher = _batcher()
    server = make_server(CFG, batcher, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield batcher, server.server_address[1]
    server.shutdown()
    server.server_close()
    batcher.stop()


def _conn(port):
    return http.client.HTTPConnection('127.0.0.1', port, timeout=120)


def test_served_batch_equals_forward_on_padded_batch():
    """A batch of 1 through the Batcher is the forward on the zero-padded
    batch with the batch's eps (Q14: pad rows enter the batch norm)."""
    b = _batcher(max_wait_ms=1.0)
    try:
        img = np.random.RandomState(0).uniform(-1, 1, (H, W, 3)).astype(
            np.float32)
        out = b.submit(img, 2).get(timeout=120)
    finally:
        b.stop()
    padded = np.zeros((4, H, W // 2, 3), np.float32)
    padded[0] = img[:, :W // 2]
    fwd = make_test_forward(_nets(), CFG)
    with torch.inference_mode():
        _, photo = fwd(torch.from_numpy(padded), torch.tensor([2, 0, 0, 0]),
                       eps=batch_eps(0, 0))
    assert out.shape == (H, W // 2, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, photo[0].numpy(), atol=1e-6)
    assert torch.equal(batch_eps(0, 0), batch_eps(0, 0))
    assert not torch.equal(batch_eps(0, 0), batch_eps(0, 1))


def test_http_png_and_health(served):
    batcher, port = served
    arr = (np.random.RandomState(1).rand(H, W, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='PNG')
    conn = _conn(port)
    conn.request('POST', '/generate?class_id=2', body=buf.getvalue())
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader('Content-Type') == 'image/png'
    out = Image.open(io.BytesIO(resp.read()))
    assert out.size == (W // 2, H)
    conn.request('GET', '/healthz')
    health = conn.getresponse()
    assert health.status == 200
    stats = json.loads(health.read())
    assert stats['ok'] and stats['requests'] >= 1
    assert stats['device'] == 'cpu'


def test_http_raw_and_raw_batch(served):
    _, port = served
    n = 3
    imgs = np.random.RandomState(4).uniform(-1, 1, (n, H, W, 3)).astype(
        '<f4')
    imgs[2] = imgs[1]
    conn = _conn(port)
    conn.request('POST', '/generate?class_id=1&raw=1', body=imgs[0].tobytes())
    resp = conn.getresponse()
    assert resp.status == 200
    one = np.frombuffer(resp.read(), '<f4').reshape(H, W // 2, 3)
    assert np.isfinite(one).all() and np.abs(one).max() <= 1.0
    conn.request('POST', f'/generate?class_id=0,2,2&raw=1&n={n}',
                 body=imgs.tobytes())
    resp = conn.getresponse()
    assert resp.status == 200
    out = np.frombuffer(resp.read(), '<f4').reshape(n, H, W // 2, 3)
    assert np.isfinite(out).all() and np.abs(out).max() <= 1.0
    # identical (image, class) slots of one batch agree; others differ
    np.testing.assert_allclose(out[1], out[2], atol=1e-6)
    assert np.abs(out[0] - out[1]).max() > 1e-3


@pytest.mark.parametrize('path,body', [
    ('/generate?raw=1&n=3', b'\x00' * 12),     # size mismatch
    ('/generate?raw=1&n=0', b''),              # n out of range
    ('/generate?n=2', b''),                    # n>1 needs raw
    ('/generate?class_id=0,1&raw=1&n=3', b''),  # id count
    ('/generate?class_id=99', b'notanimage'),  # class out of range
])
def test_http_bad_requests(served, path, body):
    _, port = served
    conn = _conn(port)
    conn.request('POST', path, body=body)
    assert conn.getresponse().status == 400
    conn = _conn(port)
    conn.request('POST', '/nope', body=b'')
    assert conn.getresponse().status == 404


def test_uint8_mode_matches_png_path():
    """uint8 transfer moves the PNG payload: the on-device stretch equals
    the host encoder applied to the float32 output, up to the input's
    8-bit quantisation."""
    from edgegan_torch.utils.images import bytescale, inverse_transform
    img = np.random.RandomState(7).uniform(-1, 1, (H, W, 3)).astype(
        np.float32)
    outs = {}
    for dtype in ('float32', 'uint8'):
        b = _batcher(dtype, max_wait_ms=1.0)
        try:
            outs[dtype] = b.submit(img, 1).get(timeout=120)
        finally:
            b.stop()
    host_u8 = bytescale(inverse_transform(outs['float32'].astype(
        np.float64)))
    dev_u8 = outs['uint8']
    assert dev_u8.dtype == np.uint8 and dev_u8.shape == host_u8.shape
    diff = np.abs(dev_u8.astype(int) - host_u8.astype(int))
    assert np.mean(diff) < 2.0 and np.max(diff) <= 16


def test_bfloat16_mode_serves():
    b = _batcher('bfloat16', max_wait_ms=1.0)
    try:
        assert b.compute_dtype == torch.bfloat16
        img = np.random.RandomState(8).uniform(-1, 1, (H, W, 3)).astype(
            np.float32)
        out = b.submit(img, 0).get(timeout=120)
    finally:
        b.stop()
    assert out.dtype == np.float32 and out.shape == (H, W // 2, 3)
    assert np.isfinite(out).all() and np.abs(out).max() <= 1.0


def _gated_batcher(max_batch=2, depth=1, max_queue=4):
    """A Batcher whose device step blocks until `gate` opens, so that the
    submit queue fills deterministically."""
    gate = threading.Event()
    b = _batcher(max_batch=max_batch, max_wait_ms=1.0, depth=depth,
                 max_queue=max_queue)

    def gated_step(images, classes, step_idx):
        assert gate.wait(timeout=120), 'gate never opened'
        return torch.zeros(images.shape[0], H, W // 2, 3)

    b.step = gated_step
    return b, gate


def test_overload_sheds_immediately_and_recovers():
    b, gate = _gated_batcher()
    img = np.zeros((H, W, 3), np.float32)
    try:
        accepted, shed = [], 0
        t0 = time.time()
        for _ in range(20):
            try:
                accepted.append(b.submit(img, 0))
            except Overloaded:
                shed += 1
        assert shed > 0, 'queue bound never triggered'
        assert time.time() - t0 < 5.0
        assert len(accepted) <= 4 + 2 * 2 + 2, len(accepted)
        assert b.stats()['shed'] == shed
        gate.set()
        for out in accepted:
            assert isinstance(out.get(timeout=60), np.ndarray)
        assert b.healthy()
        assert isinstance(b.submit(img, 1).get(timeout=60), np.ndarray)
    finally:
        gate.set()
        b.stop()


def test_failing_step_answers_and_pipeline_survives():
    b = _batcher(max_wait_ms=1.0)
    real_step, calls = b.step, []

    def flaky(images, classes, step_idx):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError('injected device failure')
        return real_step(images, classes, step_idx)

    b.step = flaky
    img = np.zeros((H, W, 3), np.float32)
    try:
        assert isinstance(b.submit(img, 0).get(timeout=60), RuntimeError)
        assert b.healthy()
        assert isinstance(b.submit(img, 0).get(timeout=120), np.ndarray)
        assert b.stats()['errors'] == 1
    finally:
        b.stop()


def test_drain_then_stop():
    b, gate = _gated_batcher(max_batch=2, depth=1, max_queue=8)
    img = np.zeros((H, W, 3), np.float32)
    outs = [b.submit(img, 0) for _ in range(3)]
    stopper = threading.Thread(target=lambda: b.stop(drain=True,
                                                     timeout=60))
    stopper.start()
    time.sleep(0.3)
    with pytest.raises(Overloaded, match='draining'):
        b.submit(img, 0)
    gate.set()
    stopper.join(timeout=120)
    assert not stopper.is_alive()
    for out in outs:
        assert isinstance(out.get_nowait(), np.ndarray)
    assert not b.thread.is_alive() and not b.sync_thread.is_alive()
