"""Inference entry point: `python -m edgegan_torch.cli.test` (the JAX
package's cli/test.py).

Flag-compatible with the JAX test CLI and the reference's
`python -m edgegan.test` (every `Config` field is a flag), plus
`--device` (default `cuda`: the card `cuda:<gpu>`; `cpu` runs the plain
versions of the kernels). It restores G1, G2 and E from the newest
readable checkpoint under `checkpoint_dir` (`checkpoint.load_raw`, so the
critics' sizes at training do not matter) and writes one PNG per test
image under `test_output_dir/<dataset>/`, in the image's class directory:

- batch 1, as the reference (test.py:89); `--test_batch_size N` runs N
  images a batch, pads the last batch (its `Dataset.PAD` rows are
  computed and never written), writes the PNGs on a thread pool and
  prints the images per second;
- the class id is the parent directory's name; a file whose id does not
  parse or is not below `num_classes` is skipped (quirk Q10);
- `output_combination`: 'full' (the input pair, then G1's and G2's
  halves), 'inputL_outputR' or 'outputR'; 'outputL_inputR' crashes in
  the reference (quirk Q7) and is rejected;
- the encoder's noise comes from a CPU `torch.Generator` seeded 6666 (the
  reference's TF seed, test.py:15), two scalars a batch (quirk Q15),
  drawn for every batch, so that a batch's noise depends on its index
  only.

Data parallelism: under `torchrun --nproc_per_node N` with
`--test_batch_size` divisible by N (and `--data_parallel`, the default),
each rank decodes, computes and writes its rows of every batch, with the
batch-norm statistics over the whole batch (`parallel.synced_batch_stats`),
so the output tree is a one-process run's. Otherwise (batch-1 parity mode
among them) rank 0 runs the whole test set alone and the other ranks
leave. Rank 0 prints.

The outputs of a batch are pulled to the host after the next batch's
forward has been queued, so the card computes while the host writes.
With `--dtype bfloat16` the batched mode computes in bfloat16, as the
JAX CLI does; batch 1 computes in float32.
"""
from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import checkpoint as ckpt
from .. import parallel
from ..bridge import load_jax_params
from ..core.config import add_config_args, config_from_args
from ..data.dataset import Dataset
from ..data.loader import PrefetchLoader
from ..infer import make_test_forward
from ..train.networks import Networks
from ..utils.images import makedirs, save_images


def pathsplit(path):
    return os.path.normpath(path).split(os.sep)


def name_with_class(filename):
    """The file's path below the `test` directory: '<class>/<file>'."""
    splited = pathsplit(filename)
    return os.path.join(*splited[splited.index('test') + 1:])


def classes_of(filenames, num_classes):
    """(class ids of the valid files, mask of the valid files): a file is
    valid when its parent directory's name parses as an id below
    `num_classes` (models/edgegan.py:556-570, quirk Q10)."""
    result, mask = [], []
    for path in filenames:
        try:
            classid = int(pathsplit(path)[-2])
        except (ValueError, IndexError):
            mask.append(False)
            continue
        if classid >= num_classes:
            mask.append(False)
            continue
        result.append(classid)
        mask.append(True)
    return result, np.array(mask, dtype=bool)


def classes_padded(filenames, num_classes):
    """Like `classes_of`, but one id per file (0 for a masked file), so
    that every batch keeps its size; masked rows are computed and
    dropped."""
    _, mask = classes_of(filenames, num_classes)
    ids = [int(pathsplit(path)[-2]) if ok else 0
           for path, ok in zip(filenames, mask)]
    return np.array(ids, np.int32), mask


def compose(config, images, edge, image):
    """The saved panels of a batch: NHWC numpy [-1, 1] input pairs and the
    generated halves -> the `output_combination` rows."""
    half_w = int(config.output_width / 2)
    if config.output_combination == 'inputL_outputR':
        return np.append(images[:, :, :half_w, :], image, axis=2)
    if config.output_combination == 'outputR':
        return image
    return np.append(np.append(images, edge, axis=2), image, axis=2)


def main(argv=None):
    np.random.seed(2333)  # reference test.py:14
    parser = argparse.ArgumentParser('edgegan_torch.cli.test')
    add_config_args(parser, 'test')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (the card cuda:<gpu>, under a launcher '
                             'cuda:<LOCAL_RANK>) or cpu')
    args = parser.parse_args(argv)
    config = config_from_args(args).derive('test')
    if config.output_combination == 'outputL_inputR':
        # quirk Q7: this mode crashes in the reference (undefined inputR,
        # models/edgegan.py:613-614)
        raise SystemExit(
            "output_combination 'outputL_inputR' is broken in the "
            'reference (undefined inputR, models/edgegan.py:613-614)')
    device = parallel.init(args.device, config.gpu, config.data_parallel)
    try:
        if parallel.world_size() > 1 and not (
                config.test_batch_size
                and config.test_batch_size % parallel.world_size() == 0):
            # rank 0 alone: leave the group first, so that no collective
            # waits for the ranks that leave
            alone = parallel.is_process_zero()
            parallel.shutdown()
            if not alone:
                return
        _test(config, device)
    finally:
        parallel.shutdown()


def _test(config, device):
    p0 = parallel.is_process_zero()
    world = parallel.world_size()
    if world > 1 and p0:
        print(f' [*] sharding inference over {world} ranks')
    makedirs(os.path.join(config.test_output_dir, config.dataset))
    batch = config.test_batch_size or 1
    dataset = Dataset(
        config.dataroot, config.dataset, config.train_size, batch,
        dict(input_height=config.input_height, input_width=config.input_width,
             output_height=config.output_height,
             output_width=config.output_width, crop=config.crop,
             grayscale=False),
        phase='test', pad_tail=bool(config.test_batch_size),
        shard=(parallel.rank(), world))

    # rank 0 picks the entry and every rank reads that one, even if a
    # trainer finishes a newer one meanwhile
    loaded, step, trees = (ckpt.load_raw(config.checkpoint_dir) if p0
                           else (False, 0, None))
    step = parallel.broadcast_object(step if loaded else None)
    if step is None:
        print(' [!] Load failed...')
        return
    if trees is None:
        _, _, trees = ckpt.load_raw(config.checkpoint_dir, step)
    nets = load_jax_params(Networks(config), trees['params'], trees['aux'])
    if p0:
        print(' [*] Load SUCCESS')
    compute = (torch.bfloat16 if config.test_batch_size
               and config.dtype == 'bfloat16' else torch.float32)
    nets = nets.to(device)
    if compute != torch.float32:
        nets = nets.cast(compute)
    forward = make_test_forward(nets, config)
    generator = torch.Generator().manual_seed(6666)

    def save_batch(images, filenames, mask, edge, image):
        """Pull a queued forward's outputs and write its valid rows."""
        edge = edge.float().cpu().numpy()[mask]
        image = image.float().cpu().numpy()[mask]
        results = compose(config, images[mask], edge, image)
        names = [f for f, ok in zip(filenames, mask) if ok]
        for fname, img in zip(names, results):
            out_path = os.path.join(config.test_output_dir, config.dataset,
                                    name_with_class(fname))
            makedirs(os.path.dirname(out_path))
            if save_pool is not None:
                save_futures.append(save_pool.submit(
                    save_images, img[np.newaxis], [1, 1], out_path))
            else:
                save_images(img[np.newaxis], [1, 1], out_path)

    loader = PrefetchLoader(dataset, prefetch=config.prefetch,
                            pin=device.type == 'cuda')
    # batched mode writes the PNGs on a pool (PIL's compression releases
    # the GIL); batch 1 keeps the reference's serial writes
    save_pool = (ThreadPoolExecutor(max_workers=8)
                 if config.test_batch_size else None)
    save_futures = []
    pending = None
    n_done = 0
    t0 = time.perf_counter()
    def valid(filenames):
        """(class ids, mask of the rows to write) of `filenames`."""
        not_pad = np.array([f != Dataset.PAD for f in filenames], bool)
        if not config.multiclasses:
            return np.zeros(len(filenames), np.int32), not_pad
        classes, mask = classes_padded(filenames, config.num_classes)
        return classes, mask & not_pad

    try:
        with torch.no_grad(), parallel.synced_batch_stats():
            for idx, (images, filenames) in enumerate(loader):
                eps = torch.randn(2, generator=generator)
                # the whole batch's rows decide, alike on every rank
                n_valid = int(valid(dataset.batch_files(idx)[1])[1].sum())
                if not n_valid:
                    continue
                classes, mask = valid(filenames)
                x = images.to(device, non_blocking=True).to(compute)
                edge, image = forward(
                    x, torch.from_numpy(classes).to(device), eps)
                if pending is not None:
                    save_batch(*pending)
                pending = (images.numpy(), filenames, mask, edge, image)
                n_done += n_valid
                if p0:
                    print('Test: [%4d/%4d]' % (idx, len(dataset)))
            if pending is not None:
                save_batch(*pending)
        for fut in save_futures:
            fut.result()  # surface any write failure
    finally:
        loader.close()
        if save_pool is not None:
            save_pool.shutdown(wait=True)
    parallel.barrier('test outputs written')
    if p0 and config.test_batch_size and n_done:
        dt = time.perf_counter() - t0
        print(f' [*] {n_done} images in {dt:.2f}s = '
              f'{n_done / dt:.1f} img/s (batched pipelined mode)')


if __name__ == '__main__':
    main()
