"""Quality evaluation of a trained checkpoint: `python -m
edgegan_torch.cli.evaluate` (the JAX package's scripts/evaluate.py).

Restores G1, G2 and E (and the classifier D2 for the in-run extractor)
from a checkpoint under `checkpoint_dir` (`checkpoint.load_raw`), runs
the test graph, encoder -> G1/G2 (`infer.make_test_forward`), over a
split laid out like the train split (class directories of sketch|photo
pairs, `--split`), and prints ONE JSON line, with the JAX script's keys:
- `classifier_fid`: the Frechet distance between the real photo halves'
  and the generated photos' classifier features (`evaluation.py`), from
  the pinned extractor (`--extractor_npz`, comparable across runs) or
  the run's own classifier (at `--extractor_step`, default the evaluated
  checkpoint; comparable within a run only). Not comparable to published
  InceptionV3 FID.
- `l1`, `mse`, `psnr_db` between the real and the generated photos of the
  same sketches.

Flags: every `Config` field, `--split`, `--limit`, `--eval_batch`,
`--step`, `--extractor_step`, `--extractor_npz`, and `--device` (default
`cuda`; `cpu` runs the plain versions of the kernels). The forward and
the extractor run in float32.

The encoder's noise: JAX draws it from `fold_in(PRNGKey(6666), idx)`,
which torch cannot replay; here batch `idx` takes its two scalars from a
CPU `torch.Generator` seeded from (6666, idx), so a batch's noise depends
on its index only.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..bridge import load_classifier, load_jax_params
from ..core.config import add_config_args, config_from_args
from ..data.dataset import Dataset
from ..evaluation import (classifier_extractor, compute_fid,
                          pinned_extractor, reconstruction_metrics)
from ..infer import make_test_forward
from ..models.classifier import Classifier
from ..train.networks import Networks

EPS_SEED = 6666  # the reference's TF seed at test time (test.py:15)


def parse_args(argv=None):
    parser = argparse.ArgumentParser('edgegan_torch.cli.evaluate')
    add_config_args(parser, 'test')
    parser.add_argument('--split', default='train',
                        help='any split directory under dataroot/dataset/ '
                             'laid out like the train split (class dirs of '
                             'sketch|photo pairs)')
    parser.add_argument('--limit', type=int, default=512,
                        help='max images to evaluate')
    parser.add_argument('--eval_batch', type=int, default=32)
    parser.add_argument('--step', type=int, default=None,
                        help='evaluate this retained checkpoint step '
                             'instead of the newest')
    parser.add_argument('--extractor_step', type=int, default=None,
                        help='take the in-run classifier from this '
                             'checkpoint step (default: the evaluated one)')
    parser.add_argument('--extractor_npz', default=None,
                        help='the pinned cross-run extractor '
                             '(docs/fid_extractor.npz); overrides '
                             '--extractor_step')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (the card cuda:<gpu>) or cpu')
    return parser.parse_args(argv)


def eps_for(idx: int) -> torch.Tensor:
    """The encoder's two noise scalars of batch `idx`."""
    seed = int(np.random.SeedSequence([EPS_SEED, idx]).generate_state(
        1, np.uint64)[0])
    return torch.randn(2, generator=torch.Generator().manual_seed(seed))


def _restore(checkpoint_dir: str, step: Optional[int]):
    loaded, counter, raw = ckpt.load_raw(checkpoint_dir, step=step)
    if not loaded:
        raise SystemExit(f'no checkpoint under {checkpoint_dir}'
                         + (f' at step {step}' if step is not None else ''))
    return counter, raw


def setup(args):
    """(config, device) of parsed `args`; refuses a single-class
    configuration, and `cuda` without a card."""
    config = config_from_args(args).derive('test')
    if not config.multiclasses:
        raise SystemExit('classifier-FID needs a multiclass checkpoint '
                         '(the classifier only exists there)')
    device = torch.device(config.device(args.device))
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit('no CUDA device (pass --device cpu to evaluate '
                             'on the CPU)')
        torch.cuda.set_device(device)
    return config, device


def make_extractor(args, config, device, counter: Optional[int] = None,
                   raw=None):
    """The feature extractor that `args` ask for: the pinned one
    (`--extractor_npz`), or the classifier of the checkpoint at
    `--extractor_step` (default: `counter`, whose trees `raw` are)."""
    if args.extractor_npz:
        return pinned_extractor(args.extractor_npz, device)
    step = args.extractor_step if args.extractor_step is not None else counter
    if raw is None or step != counter:
        _, raw = _restore(config.checkpoint_dir, step)
    classifier = load_classifier(Classifier(config.num_classes),
                                 raw['params']['D2'], raw['aux']['D2'])
    return classifier_extractor(classifier, device)


def evaluate(argv=None, extractor=None):
    """-> (the result dict that `main` prints, the real photo halves, the
    generated photos), both NHWC float32 numpy in [-1, 1]. `extractor`,
    when given, is the one that `make_extractor` gives for `argv`, made
    once by a caller that evaluates several checkpoints."""
    args = parse_args(argv)
    config, device = setup(args)

    counter, raw = _restore(config.checkpoint_dir, args.step)
    nets = load_jax_params(Networks(config), raw['params'], raw['aux'])
    if extractor is None:
        extractor = make_extractor(args, config, device, counter, raw)

    b = args.eval_batch
    dataset = Dataset(
        config.dataroot, config.dataset, args.limit, b,
        dict(input_height=config.input_height, input_width=config.input_width,
             output_height=config.output_height,
             output_width=config.output_width, crop=config.crop,
             grayscale=False, z_dim=config.z_dim),
        config.num_classes, subdir=args.split)
    forward = make_test_forward(nets.to(device), config)
    half_w = int(config.output_width / 2)
    reals, fakes = [], []
    with torch.no_grad():
        for idx in range(len(dataset)):
            images, _z, files = dataset[idx]
            classes = torch.tensor(
                [int(os.path.basename(os.path.dirname(f))) for f in files],
                device=device)
            _, image = forward(torch.from_numpy(images).to(device), classes,
                               eps_for(idx))
            reals.append(images[:, :, half_w:config.output_width, :])
            fakes.append(image.float().cpu().numpy())
    reals = np.concatenate(reals)
    fakes = np.concatenate(fakes)

    fid_like = compute_fid(reals, fakes, extractor, batch_size=b)
    recon = reconstruction_metrics(reals, fakes)
    result = {
        'checkpoint_step': counter,
        'extractor': (args.extractor_npz if args.extractor_npz
                      else 'in-run classifier'),
        'extractor_step': (None if args.extractor_npz
                           else args.extractor_step
                           if args.extractor_step is not None else counter),
        'split': args.split,
        'n_images': int(len(fakes)),
        'classifier_fid': round(float(fid_like), 4),
        'note': 'classifier-feature FID: relative tracking only, not '
                'comparable to published InceptionV3 FID',
        **{k: round(v, 6) for k, v in recon.items()},
    }
    return result, reals, fakes


def main(argv=None):
    result, _, _ = evaluate(argv)
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
