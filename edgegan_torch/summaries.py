"""TensorBoard summaries of a training run (the JAX package's
summaries.py:1-136; reference models/edgegan.py:344-411).

`SummaryWriter(logdir, config)` writes what the JAX writer writes, as
TensorBoard-2 tensor events (flax's writer calls tf.summary.scalar /
histogram / image):
- `scalars(step, metrics)`: the 11 losses of `SCALARS`, every step,
  float32 scalars under the `scalars` plugin;
- `extras(step, state, images, z)`: one sample forward on the step's
  batch (G1/G2, the joint critic on the real and the fake pairs, the
  patch critics on the bicubic-resized real and fake halves when they
  are on), written as histograms of z and of every critic's sigmoid
  output (`histograms` plugin: tf.summary.histogram's 30 equal-width
  buckets as [30, 3] float64 (left, right, count)) and as image grids of
  the first 8 rows (`images` plugin: the [width, height, PNG] string
  tensor).

The event file is written here without tensorboard, tensorflow or
protobuf, none of which the port depends on: TFRecord framing (length,
masked CRC32C of the length, the record, masked CRC32C of the record)
around hand-encoded `Event` protos, the first of which holds
`file_version: "brain.Event:2"`. TensorBoard's `EventAccumulator` lists
every tag under 'tensors'.

Under data parallelism rank 0 alone writes: the trainer opens the writer
there, and `extras` runs its sample forward on rank 0's rows of the batch
(the JAX writer's `_local_batch`, l.84-94, 119-130), with no collective.
"""
from __future__ import annotations

import io
import itertools
import os
import socket
import struct
import time
from typing import Dict

import numpy as np
import torch
from PIL import Image

from .ops.resize import resize
from .utils.images import inverse_transform

SCALARS = ['joint_dis_dloss', 'joint_dis_gloss',
           'image_dis_dloss', 'image_dis_gloss',
           'edge_dis_dloss', 'edge_dis_gloss',
           'loss_d_ac', 'edge_gloss', 'image_gloss', 'loss_g_ac', 'zl_loss']
HISTOGRAM_BUCKETS = 30   # tf.summary.histogram's default
GRID_IMAGES = 8

# tensorflow/core/framework/types.proto and summary.proto enum values
_DT_FLOAT, _DT_DOUBLE, _DT_STRING = 1, 2, 7
_SCALAR, _TENSOR, _BLOB_SEQUENCE = 1, 2, 3
_FILE_IDS = itertools.count()  # tells apart the files a process opens


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), reflected, table-driven."""
    c = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotate right by 15, add a constant."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: uint64 length, masked CRC of the length, the data,
    masked CRC of the data (all little-endian)."""
    length = struct.pack('<Q', len(data))
    return (length + struct.pack('<I', masked_crc32c(length)) + data
            + struct.pack('<I', masked_crc32c(data)))


# protobuf wire format: a key is (field number << 3 | wire type)
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _int_field(field: int, n: int) -> bytes:
    return _varint(field << 3) + _varint(n)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(data)) + data


def _tensor(dtype: int, shape, content: bytes = b'', strings=()) -> bytes:
    """A TensorProto: dtype (1), tensor_shape (2) of dims (2: size 1),
    tensor_content (4) or string_val (8, repeated)."""
    dims = b''.join(_bytes_field(2, _int_field(1, d)) for d in shape)
    out = _int_field(1, dtype) + _bytes_field(2, dims)
    if content:
        out += _bytes_field(4, content)
    return out + b''.join(_bytes_field(8, s) for s in strings)


def _value(tag: str, tensor: bytes, plugin: str, data_class: int) -> bytes:
    """A Summary.Value: tag (1), tensor (8), metadata (9: plugin_data (1:
    plugin_name 1), data_class (4))."""
    metadata = (_bytes_field(1, _bytes_field(1, plugin.encode()))
                + _int_field(4, data_class))
    return (_bytes_field(1, tag.encode()) + _bytes_field(8, tensor)
            + _bytes_field(9, metadata))


def _event(step=None, summary_value: bytes = None,
           file_version: str = None) -> bytes:
    """An Event: wall_time (1, double), step (2), file_version (3),
    summary (5: value 1)."""
    out = _varint(1 << 3 | 1) + struct.pack('<d', time.time())
    if step is not None:
        out += _int_field(2, int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if summary_value is not None:
        out += _bytes_field(5, _bytes_field(1, summary_value))
    return out


def histogram_buckets(values, bucket_count: int = HISTOGRAM_BUCKETS
                      ) -> np.ndarray:
    """tf.summary.histogram's buckets, [k, 3] float64 (left edge, right
    edge, count): k equal-width buckets from min to max, the last one
    closed; a single value fills the last of k buckets whose edges are
    that value; no values give k rows of zeros."""
    data = np.asarray(values, np.float64).reshape(-1)
    if data.size == 0:
        return np.zeros((bucket_count, 3))
    lo, hi = data.min(), data.max()
    counts = np.zeros(bucket_count)
    if hi == lo:
        edges = np.full(bucket_count, hi)
        counts[-1] = data.size
        return np.stack([edges, edges, counts], axis=1)
    width = (hi - lo) / bucket_count
    idx = np.minimum(np.floor((data - lo) / width).astype(np.int64),
                     bucket_count - 1)
    counts = np.bincount(idx, minlength=bucket_count).astype(np.float64)
    edges = np.linspace(lo, hi, bucket_count + 1)
    edges[-1] = hi
    return np.stack([edges[:-1], edges[1:], counts], axis=1)


def png_of(image: np.ndarray) -> bytes:
    """An [h, w, 3] float image in [0, 1] as PNG bytes, quantised as
    tf.image.convert_image_dtype(..., uint8, saturate=True) does."""
    pixels = np.clip(np.asarray(image, np.float32) * np.float32(255.5),
                     0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format='PNG')
    return buf.getvalue()


class EventWriter:
    """Appends TensorBoard-2 tensor events to one new event file in
    `logdir`."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, f'events.out.tfevents.{int(time.time())}.'
                    f'{socket.gethostname()}.{os.getpid()}.'
                    f'{next(_FILE_IDS)}.v2')
        self._file = open(self.path, 'wb')
        self._file.write(tfrecord(_event(file_version='brain.Event:2')))
        self._file.flush()

    def _write(self, step, value: bytes):
        self._file.write(tfrecord(_event(step, value)))

    def scalar(self, tag: str, value: float, step: int):
        content = struct.pack('<f', float(value))
        self._write(step, _value(tag, _tensor(_DT_FLOAT, (), content),
                                 'scalars', _SCALAR))

    def histogram(self, tag: str, values, step: int):
        buckets = histogram_buckets(values)
        content = buckets.astype('<f8').tobytes()
        self._write(step, _value(
            tag, _tensor(_DT_DOUBLE, buckets.shape, content), 'histograms',
            _TENSOR))

    def image(self, tag: str, image: np.ndarray, step: int):
        """One [h, w, 3] image in [0, 1]."""
        h, w = image.shape[:2]
        strings = (str(w).encode(), str(h).encode(), png_of(image))
        self._write(step, _value(tag, _tensor(_DT_STRING, (3,),
                                              strings=strings),
                                 'images', _BLOB_SEQUENCE))

    def flush(self):
        self._file.flush()

    def close(self):
        if not self._file.closed:
            self._file.close()


class SummaryWriter:
    def __init__(self, logdir: str, config):
        self.writer = EventWriter(logdir)
        self.config = config

    @torch.no_grad()
    def sample(self, nets, z: torch.Tensor, images: torch.Tensor):
        """The sample forward (the JAX writer's `_sample_fn`): z [B, z_dim
        (+1 class column)], NHWC images -> ({name: NHWC image batch},
        {name: critic sigmoid output}) as torch tensors."""
        cfg = self.config
        half_w = int(cfg.output_width / 2)
        x = images.permute(0, 3, 1, 2)
        edge_real = x[..., :half_w]
        image_real = x[..., half_w:cfg.output_width]
        z_in = nets.gen_input(z[:, :cfg.z_dim], z[:, -1])
        edge_out, image_out = nets.generate(z_in)
        imgs = {'G1': edge_out, 'G2': image_out}
        hists = {'d': nets.discriminate('D', x)[0],
                 'd_': nets.discriminate(
                     'D', torch.cat([edge_out, image_out], dim=3))[0]}
        for on, size, critic, real, fake, names in (
                (cfg.use_image_discriminator, cfg.image_dis_size,
                 'D_patch2', image_real, image_out,
                 ('resized_inputs_image', 'resized_G_image', 'imageD',
                  'imageDfake')),
                (cfg.use_edge_discriminator, cfg.edge_dis_size,
                 'D_patch3', edge_real, edge_out,
                 ('resized_inputs_p3_image', 'resized_G_p3_image', 'edgeD',
                  'edgeDfake'))):
            if on:
                real = resize(real, (size, size))
                fake = resize(fake, (size, size))
                imgs[names[0]], imgs[names[1]] = real, fake
                hists[names[2]] = nets.discriminate(critic, real)[0]
                hists[names[3]] = nets.discriminate(critic, fake)[0]
        return {k: v.permute(0, 2, 3, 1) for k, v in imgs.items()}, hists

    def scalars(self, step: int, metrics: Dict[str, float]):
        for k in SCALARS:
            if k in metrics:
                self.writer.scalar(k, float(metrics[k]), step)
        self.writer.flush()

    def extras(self, step: int, state, images, z):
        """Histograms and image grids from one sample forward of
        `state.nets` on the step's batch: `images` NHWC [B, H, W, 3],
        `z` the step's latent feed (this rank's rows under data
        parallelism; the batch norm takes their statistics alone, outside
        `parallel.synced_batch_stats`). With the device-z feed (a class
        column only) the latents are drawn from np.random.default_rng(
        step), as the JAX writer draws them."""
        z = torch.as_tensor(z).float().cpu().numpy()
        if z.shape[-1] < self.config.z_dim:
            noise = np.random.default_rng(step).standard_normal(
                (z.shape[0], self.config.z_dim)).astype(np.float32)
            z = np.concatenate([noise, z], axis=1)
        images = torch.as_tensor(images)
        imgs, hists = self.sample(
            state.nets, torch.from_numpy(z).to(images.device), images)
        self.writer.histogram('z', z, step)
        for name, arr in hists.items():
            self.writer.histogram(name, arr.float().cpu().numpy(), step)
        self.writer.image('inputs', _grid(images.float().cpu().numpy()), step)
        for name, arr in imgs.items():
            self.writer.image(name, _grid(arr.float().cpu().numpy()), step)
        self.writer.flush()

    def close(self):
        self.writer.close()


def _grid(batch: np.ndarray, max_images: int = GRID_IMAGES) -> np.ndarray:
    """[-1, 1] NHWC batch -> one [0, 1] image row of its first rows."""
    batch = np.asarray(batch[:max_images], np.float32)
    row = np.concatenate(list(batch), axis=1)
    return np.clip(inverse_transform(row), 0.0, 1.0)
