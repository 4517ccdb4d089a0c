"""The port's TensorBoard summaries (`edgegan_torch/summaries.py`)
against the JAX package's writer (flax's `tf.summary` events), on the
CPU at the tiny configuration of tests/test_summaries.py.

- The port writes its event files by hand (TFRecord framing, masked
  CRC32C, hand-encoded `Event` protos): every record's CRCs are checked
  against tensorboard's own CRC32C, and `EventAccumulator` reads them.
- From the same weights (through the bridge) and the same batch: the tag
  set equals the JAX writer's, scalars are bit-equal, each histogram's
  min, max and total count are within 2e-4 of JAX's, each image grid has
  JAX's shape and its decoded pixels are within one level; once with a
  host-drawn z and once with the device-z feed (a class column only,
  latents drawn from default_rng(step) by both writers).
- The bucket rule is tf.summary.histogram's (flax's output for random,
  single-value and empty inputs).
- `edgegan_torch.summaries` and `cli.train` import with tensorboard,
  tensorflow and protobuf blocked; `cli.train --summary_frequency 1`
  writes the 11 scalars and the extras at every step.
"""
import glob
import io
import os
import struct
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator)
from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import (
    masked_crc32c)
from tensorboard.util import tensor_util

from edgegan_tpu.core.config import Config as JConfig
from edgegan_tpu.summaries import SummaryWriter as JSummaryWriter
from edgegan_tpu.train import Networks as JNetworks
from edgegan_torch import bridge
from edgegan_torch import summaries
from edgegan_torch.cli import train as train_cli
from edgegan_torch.core.config import Config
from edgegan_torch.train.networks import Networks
from edgegan_torch.train.state import create_train_state
from test_torch_test_cli import SIZE_FLAGS, _write_tree
from test_torch_variants import few_threads  # noqa: F401

TINY = dict(batch_size=4, num_classes=3, z_dim=8, output_height=32,
            output_width=64, input_height=32, input_width=64,
            image_dis_size=32, edge_dis_size=32)
HIST_ATOL = 2e-4
REF_TAGS = ({'joint_dis_dloss', 'joint_dis_gloss', 'image_dis_dloss',
             'image_dis_gloss', 'edge_dis_dloss', 'edge_dis_gloss',
             'edge_gloss', 'image_gloss', 'zl_loss', 'loss_g_ac',
             'loss_d_ac'}
            | {'z', 'd', 'd_', 'imageD', 'imageDfake', 'edgeD', 'edgeDfake'}
            | {'inputs', 'G1', 'G2', 'resized_inputs_image',
               'resized_G_image', 'resized_inputs_p3_image',
               'resized_G_p3_image'})
FEEDS = ('host z', 'device z')
STEP = 3


def _records(path):
    """The payloads of a TFRecord file, each CRC checked with
    tensorboard's masked CRC32C."""
    out = []
    with open(path, 'rb') as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack('<Q', header)
        (crc_len,) = struct.unpack('<I', data[pos + 8:pos + 12])
        assert crc_len == masked_crc32c(header)
        payload = data[pos + 12:pos + 12 + n]
        (crc_data,) = struct.unpack('<I', data[pos + 12 + n:pos + 16 + n])
        assert crc_data == masked_crc32c(payload)
        out.append(payload)
        pos += 16 + n
    return out


def _read(logdir):
    """tag -> [(step, numpy value)] of every tensor event in `logdir`."""
    acc = EventAccumulator(logdir, size_guidance={'tensors': 0})
    acc.Reload()
    return {tag: [(e.step, tensor_util.make_ndarray(e.tensor_proto))
                  for e in acc.Tensors(tag)]
            for tag in acc.Tags()['tensors']}


def _batch(feed):
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (4, 32, 64, 3)).astype(np.float32)
    classes = np.array([[0], [2], [1], [2]], np.float32)
    if feed == 'device z':
        return images, classes
    z = rng.standard_normal((4, 8)).astype(np.float32)
    return images, np.concatenate([z, classes], axis=1)


@pytest.fixture(scope='module')
def written(tmp_path_factory):
    """{feed: (JAX event dir, port event dir)}: scalars and one extras
    call from both writers, same weights and batch."""
    params, aux = bridge.random_jax_params(
        Config(**TINY).derive('train'), 3, critics=True)
    jcfg = JConfig(**TINY).derive('train')
    jstate = types.SimpleNamespace(params=params, aux=aux)
    cfg = Config(**TINY).derive('train')
    nets = bridge.load_jax_params(Networks(cfg, critics=True), params, aux)
    state = create_train_state(nets)
    metrics = {k: float(v) for k, v in zip(
        summaries.SCALARS, np.random.RandomState(1).standard_normal(11))}
    out = {}
    jtb_nets = JNetworks(jcfg)
    for feed in FEEDS:
        images, z = _batch(feed)
        jdir = str(tmp_path_factory.mktemp('jax'))
        pdir = str(tmp_path_factory.mktemp('port'))
        jtb = JSummaryWriter(jdir, jtb_nets, jcfg)
        jtb.scalars(STEP, metrics)
        jtb.extras(STEP, jstate, images, z)
        jtb.close()
        tb = summaries.SummaryWriter(pdir, cfg)
        tb.scalars(STEP, metrics)
        tb.extras(STEP, state, torch.from_numpy(images), torch.from_numpy(z))
        tb.close()
        out[feed] = (jdir, pdir)
    return out


def test_event_records_have_valid_crcs(written):
    _, pdir = written['host z']
    (path,) = glob.glob(os.path.join(pdir, 'events.out.tfevents.*'))
    records = _records(path)
    # the file_version record first, then 11 scalars, 7 histograms and 7
    # image grids
    assert b'brain.Event:2' in records[0]
    assert len(records) == 1 + 11 + 7 + 7
    assert set(_read(pdir)) == REF_TAGS


@pytest.mark.parametrize('feed', FEEDS)
def test_extras_match_jax(written, feed):
    jdir, pdir = written[feed]
    jax_ev, port_ev = _read(jdir), _read(pdir)
    assert set(port_ev) == set(jax_ev)
    assert REF_TAGS <= set(port_ev)
    for tag, events in jax_ev.items():
        ((jstep, want),) = events
        ((step, got),) = port_ev[tag]
        assert step == jstep == STEP
        if tag in summaries.SCALARS:
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=tag)
        elif want.dtype == np.float64:  # a histogram, [30, 3]
            assert got.shape == want.shape == (30, 3)
            np.testing.assert_allclose(
                [got[0, 0], got[-1, 1]], [want[0, 0], want[-1, 1]],
                rtol=0, atol=HIST_ATOL, err_msg=tag)
            assert got[:, 2].sum() == want[:, 2].sum(), tag
        else:  # an image: [width, height, png]
            assert list(got[:2]) == list(want[:2]), tag
            a = np.asarray(Image.open(io.BytesIO(got[2])), np.int32)
            b = np.asarray(Image.open(io.BytesIO(want[2])), np.int32)
            assert a.shape == b.shape, tag
            assert np.abs(a - b).max() <= 1, tag


def test_histogram_buckets_follow_tf(tmp_path):
    from flax.metrics import tensorboard as flax_tb
    values = {'random': np.random.RandomState(4).standard_normal(1000),
              'single': np.full(7, 0.25), 'empty': np.zeros(0)}
    writer = flax_tb.SummaryWriter(str(tmp_path))
    for i, (tag, v) in enumerate(values.items()):
        writer.histogram(tag, v, i)
    writer.close()
    for tag, events in _read(str(tmp_path)).items():
        ((_, want),) = events
        got = summaries.histogram_buckets(values[tag])
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-12,
                                   atol=0, err_msg=tag)
        np.testing.assert_array_equal(got[:, 2], want[:, 2], err_msg=tag)


def test_imports_without_tensorboard_or_protobuf():
    code = ('import sys\n'
            'for m in ("tensorboard", "tensorflow", "google.protobuf"):\n'
            '    sys.modules[m] = None\n'
            'import edgegan_torch.summaries, edgegan_torch.cli.train\n'
            'assert not any(m.split(".")[0] in ("tensorboard", "tensorflow")'
            ' or m.startswith("google.protobuf") for m in sys.modules if '
            'sys.modules[m] is not None)\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, '-c', code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_train_cli_writes_events(tmp_path):
    """Two steps with --summary_frequency 1: the 11 scalars at each step
    (counters 2 and 3) and the extras at each counter reached (2 and
    3)."""
    data = str(tmp_path / 'data')
    _write_tree(data, phase='train',
                tree=(('0', 3), ('1', 3), ('2', 2)), seed=2)
    out = str(tmp_path / 'out')
    train_cli.main(['--device', 'cpu', '--dataroot', data, '--dataset',
                    'ds', '--outputsroot', out, '--name', 'tb',
                    '--batch_size', '4', '--image_dis_size', '32',
                    '--edge_dis_size', '32', '--epoch', '1',
                    '--summary_frequency', '1', '--save_checkpoint_frequency',
                    '100'] + SIZE_FLAGS)
    events = _read(os.path.join(out, 'tb', 'logs'))
    assert set(events) == REF_TAGS
    for tag, evs in events.items():
        assert [s for s, _ in evs] == [2, 3], tag
