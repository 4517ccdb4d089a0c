"""Train the pinned classifier-FID extractor: `python -m
edgegan_torch.cli.train_extractor [steps] [out_npz] [dataroot]
[--device cuda|cpu]` (the JAX package's scripts/train_fid_extractor.py).

The extractor is the model's AC-GAN classifier (D2, `models/
classifier.py`: the MRU pyramid, 768-d features) trained alone as a
plain classifier: the focal AC-GAN loss on the real photo halves
(`losses.get_acgan_loss_focal`), Adam 2e-4 (`train.state.Adam`, optax's
arithmetic), float32, no GAN in the loop. Every evaluation that passes
`--extractor_npz` scores in its one feature space, so numbers compare
across runs (`cli.evaluate`, `cli.fid_curve`).

The recipe: `Config(num_classes=14, seed=1234).derive('train')`, batch
64, 1500 steps, the 14-class genshapes set (`data/genshapes.py`, staged
under `<dataroot>/genshapes` with seed 11, 1006 train and 24 test pairs
a class, when missing). The initial weights are the port's seeded
initialiser's (`bridge.random_jax_params(config, 1234)`'s D2): JAX's
threefry draws cannot be replayed, so a run matches the recipe, not
JAX's bytes. The spectral-norm vectors `u` are never advanced, so the
npz's `aux` is the initial one, as in JAX.

Defaults: 1500 steps, `fid_extractor.npz` in the working directory (the
repository's pinned one, docs/fid_extractor.npz, is never overwritten by
default), `<tmp>/edgegan_refscale_data_1006`. `--device cuda` (the
default) needs a card and exits non-zero without one; `cpu` runs the
plain versions of the kernels. With EDGEGAN_PALLAS_PRELU=1 and
EDGEGAN_PALLAS_GATE=1 a step launches K5 14 times, K3 and K4 4 times
each (off by default, as the recipe runs).

Outputs, in the JAX script's layout: `<out_npz>` (flat `params/...` and
`aux/...` keys in the JAX tree layout, float32 stored as float16,
`np.savez_compressed`) and `<out_npz>.json` (the JAX script's keys); a
`step i/N loss ... acc ...` line every 200 steps and one JSON line at the
end. The held-out accuracy is the mean over batches of the `test` split
(the last partial batch dropped, as JAX does; a split of fewer than 64
pairs is taken as one batch, where the JAX script refuses it).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import bridge
from ..core.config import Config
from ..data.dataset import Dataset
from ..data.genshapes import stage
from ..infer import exact_f32
from ..losses import get_acgan_loss_focal
from ..models.classifier import Classifier
from ..train.state import Adam

SEED = 1234
NUM_CLASSES = 14
BATCH = 64
LEARNING_RATE = 2e-4
STAGE_SEED, STAGE_TRAIN, STAGE_TEST = 11, 1006, 24
PRINT_EVERY = 200


def recipe() -> Config:
    return Config(num_classes=NUM_CLASSES, seed=SEED).derive('train')


def parse_args(argv=None):
    parser = argparse.ArgumentParser('edgegan_torch.cli.train_extractor')
    parser.add_argument('steps', nargs='?', type=int, default=1500)
    parser.add_argument('out_npz', nargs='?', default='fid_extractor.npz')
    parser.add_argument('dataroot', nargs='?', default=os.path.join(
        tempfile.gettempdir(), 'edgegan_refscale_data_1006'))
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (the card cuda:<gpu>) or cpu')
    return parser.parse_args(argv)


def initial_classifier(config: Config) -> Classifier:
    """D2 with the port's seeded initial weights for `config`."""
    params, aux = bridge.random_jax_params(config, config.seed,
                                           critics=True)
    return bridge.load_classifier(Classifier(config.num_classes),
                                  params['D2'], aux['D2'])


def photo_halves(images: torch.Tensor, config: Config) -> torch.Tensor:
    """NHWC pairs -> the NCHW photo halves the classifier sees."""
    half_w = config.output_width // 2
    return images[:, :, half_w:config.output_width, :].permute(0, 3, 1, 2)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def make_train_step(classifier: Classifier, config: Config,
                    learning_rate: float = LEARNING_RATE
                    ) -> Callable[[torch.Tensor, torch.Tensor], tuple]:
    """step(images NHWC float32, labels int) -> (loss, accuracy), 0-d
    tensors of the batch before the update: one focal-loss gradient of
    the classifier and one Adam update, in place. The patch head
    (`disc_head`) gets a zero gradient, as in JAX, and so never moves."""
    params = list(classifier.parameters())
    opt = Adam(learning_rate)
    state = opt.init(params)
    n = config.num_classes

    def step(images, labels):
        _, _, logits = classifier(photo_halves(images, config))
        _, loss = get_acgan_loss_focal(logits, labels, logits, labels, n)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        opt.update(params, grads, state)
        return loss.detach(), accuracy(logits.detach(), labels)

    return step


def dataset_config(config: Config):
    """The dataset's image settings for `config`."""
    return dict(input_height=config.input_height,
                input_width=config.input_width,
                output_height=config.output_height,
                output_width=config.output_width, crop=False,
                grayscale=False, z_dim=config.z_dim)


def class_labels(files, device) -> torch.Tensor:
    """The class ids of `files`: their parent directories' names."""
    return torch.tensor([int(os.path.basename(os.path.dirname(f)))
                         for f in files], device=device)


@torch.no_grad()
def heldout_accuracy(classifier: Classifier, config: Config, dataroot: str,
                     device, batch: int = BATCH) -> float:
    """The mean over batches of the test split's accuracy."""
    n_test = len(Dataset(dataroot, 'genshapes', float('inf'), 1,
                         dataset_config(config), config.num_classes,
                         subdir='test').data)
    test = Dataset(dataroot, 'genshapes', float('inf'), min(batch, n_test),
                   dataset_config(config), config.num_classes,
                   subdir='test')
    accs = []
    for idx in range(len(test)):
        images, _z, files = test[idx]
        _, _, logits = classifier(photo_halves(
            torch.from_numpy(images).to(device), config))
        accs.append(float(accuracy(logits, class_labels(files, device))))
    return float(np.mean(accs))


def save(classifier: Classifier, out_npz: str):
    """The classifier's trees as the JAX script writes them: flat
    `params/...`, `aux/...` keys, float32 stored as float16, compressed."""
    params, aux = bridge.export_classifier(classifier)
    flat = bridge.flatten_npz(params=params, aux=aux)
    flat = {k: v.astype(np.float16) if v.dtype == np.float32 else v
            for k, v in flat.items()}
    os.makedirs(os.path.dirname(out_npz) or '.', exist_ok=True)
    np.savez_compressed(out_npz, **flat)


def train(steps: int, out_npz: str, dataroot: str, device: str = 'cuda',
          config: Optional[Config] = None, batch: int = BATCH):
    """Train the extractor of `config` (default the recipe) for `steps`
    steps at `batch`, write `out_npz` and its sidecar; returns (the
    sidecar's contents, every step's loss)."""
    config = config or recipe()
    device = torch.device(config.device(device))
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit('train_extractor: no CUDA device (pass '
                             '--device cpu to train on the CPU)')
        torch.cuda.set_device(device)
    exact_f32()
    if not os.path.exists(os.path.join(dataroot, 'genshapes')):
        t0 = time.time()
        stage(dataroot, seed=STAGE_SEED, train_per_class=STAGE_TRAIN,
              test_per_class=STAGE_TEST, num_classes=config.num_classes)
        print(f'staged dataset in {time.time() - t0:.0f}s', flush=True)

    classifier = initial_classifier(config).to(device)
    step = make_train_step(classifier, config)
    dataset = Dataset(dataroot, 'genshapes', float('inf'), batch,
                      dataset_config(config), config.num_classes,
                      cache=True, seed=config.seed, host_z=False)
    t0 = time.time()
    done = 0
    losses = []   # on the device, read once at the end
    while done < steps:
        dataset.shuffle()
        for idx in range(len(dataset)):
            images, _z, files = dataset[idx]
            loss, acc = step(torch.from_numpy(images).to(device),
                             class_labels(files, device))
            losses.append(loss)
            done += 1
            if done % PRINT_EVERY == 0:
                print(f'step {done}/{steps} loss {float(loss):.4f} '
                      f'acc {float(acc):.3f}', flush=True)
            if done >= steps:
                break
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    train_wall = time.time() - t0

    heldout = heldout_accuracy(classifier, config, dataroot, device, batch)
    save(classifier, out_npz)
    per_class = len(dataset.data) // config.num_classes
    meta = {
        'seed': config.seed,
        'steps': steps,
        'optimizer': 'adam(2e-4)',
        'loss': 'focal CE (ld1=1.0, gamma=2.0) on real photo halves',
        'dataset': f'procedural {config.num_classes}-class genshapes '
                   f'(stage seed {STAGE_SEED}, {per_class} train/class)',
        'config': {'num_classes': config.num_classes,
                   'input_height': config.input_height,
                   'input_width': config.input_width,
                   'output_height': config.output_height,
                   'output_width': config.output_width},
        'heldout_accuracy': round(heldout, 4),
        'train_wall_s': round(train_wall, 1),
        'artifact_bytes': os.path.getsize(out_npz),
        'feature_dim': 768,
        'note': 'pinned cross-run classifier-FID extractor; pass '
                '--extractor_npz to edgegan_torch.cli.evaluate / '
                'edgegan_torch.cli.fid_curve',
    }
    with open(out_npz + '.json', 'w') as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(meta), flush=True)
    return meta, torch.stack(losses).tolist() if losses else []


def main(argv=None):
    args = parse_args(argv)
    return train(args.steps, args.out_npz, args.dataroot, args.device)[0]


if __name__ == '__main__':
    main()
