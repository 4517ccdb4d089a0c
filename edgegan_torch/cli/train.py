"""Training entry point: `python -m edgegan_torch.cli.train` (the JAX
package's cli/train.py:29-353).

Flag-compatible with the JAX trainer (every `Config` field is a flag),
plus `--device` (default `cuda`: the card `cuda:<gpu>`; `cpu` runs the
plain versions of the kernels). One process, one device. `--dtype
bfloat16` trains in mixed precision (see `train/step.py`); the classifier's
kernels K5 and K3/K4 run when EDGEGAN_PALLAS_PRELU=1 and
EDGEGAN_PALLAS_GATE=1 are set (`ops/kernels.py`), off by default.

- Resumes from the newest finite checkpoint and counts on from its
  counter; the epoch loop restarts at 0, as the JAX trainer's does.
- Saves at `counter % save_checkpoint_frequency == 2` (quirk Q9), and on
  SIGTERM/SIGINT after the current step.
- Prints the reference's stdout line (with the 2x d-loss quirk Q11) and
  appends every step's metrics to `<logdir>/metrics.jsonl`, with a
  `{"resumed_at": counter}` line on each resume.
- The step's metrics are packed into one tensor and pulled to the host
  one step behind, so the pull does not wait for the step just queued.
- `--nan_policy`: 'warn' (report once per streak), 'halt' (save under
  `-halt` and exit 1), 'ignore'.
- `--profile_steps N` traces N steps from counter 2 with `torch.profiler`
  into `<logdir>/profile`.

The TensorBoard summaries (`summaries.py`) are not ported: this trainer
writes none yet.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import signal
import time

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..core.config import add_config_args, config_from_args
from ..data.dataset import Dataset
from ..data.loader import PrefetchLoader
from ..train.networks import Networks
from ..train.state import create_train_state
from ..train.step import COMPUTE_DTYPES, make_draws, make_train_step
from ..bridge import random_jax_params, load_jax_params


def main(argv=None):
    parser = argparse.ArgumentParser('edgegan_torch.cli.train')
    add_config_args(parser, 'train')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (the card cuda:<gpu>) or cpu')
    args = parser.parse_args(argv)
    config = config_from_args(args).derive('train')
    device = torch.device(config.device(args.device))
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    config.save()
    os.makedirs(config.checkpoint_dir, exist_ok=True)
    os.makedirs(config.logdir, exist_ok=True)

    dataset = Dataset(
        config.dataroot, config.dataset, config.train_size,
        config.batch_size,
        dict(input_height=config.input_height, input_width=config.input_width,
             output_height=config.output_height,
             output_width=config.output_width, crop=config.crop,
             grayscale=False, z_dim=config.z_dim),
        config.num_classes, cache=config.cache_data, seed=config.seed,
        host_z=config.host_z)

    # reference-initialised weights from --seed, then the newest checkpoint
    nets = Networks(config, critics=True)
    load_jax_params(nets, *random_jax_params(config, config.seed,
                                             critics=True))
    nets.to(device)
    state = create_train_state(nets)
    counter = 1
    loaded, ckpt_counter, _ = ckpt.load(config.checkpoint_dir, state)
    if loaded:
        counter = ckpt_counter
        print(' [*] Load SUCCESS')
    else:
        print(' [!] Load failed...')
    n_params = sum(p.numel() for p in nets.parameters())
    print(f'networks {", ".join(nets.names)}: {n_params:,} parameters on '
          f'{device}')

    train_step = make_train_step(nets, config)
    # the step's random numbers (critics' blend weights, encoder eps,
    # device z) come from a stream keyed by (seed, rng_salt, counter), as
    # the JAX trainer's fold_in(step_stream, counter): a resumed run takes
    # the draws an uninterrupted one would, and a new --rng_salt a fresh
    # stream
    generator = torch.Generator(device=device)

    metrics_log = open(os.path.join(config.logdir, 'metrics.jsonl'), 'a')
    if loaded:
        metrics_log.write(json.dumps({'resumed_at': counter}) + '\n')
        metrics_log.flush()

    stop_requested = []

    def _request_stop(signum, frame):
        stop_requested.append(signum)

    previous = {sig: signal.signal(sig, _request_stop)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    # bfloat16 training casts the images on the host before the copy
    loader = PrefetchLoader(
        dataset, prefetch=config.prefetch, pin=device.type == 'cuda',
        image_dtype=COMPUTE_DTYPES[config.dtype])
    profiler = None
    nan_streak = False
    halted = []
    start_time = time.time()
    metric_names = []

    def process_metrics(step_counter, epoch, idx, packed):
        nonlocal nan_streak
        metrics = dict(zip(metric_names, packed.tolist()))
        d_err = sum(metrics.get(k, 0.0) for k in (
            'joint_dis_dloss', 'image_dis_dloss', 'edge_dis_dloss'))
        g_err = metrics.get('edge_gloss', 0.0) + metrics.get('image_gloss',
                                                             0.0)
        print('Epoch: [%2d/%2d] [%4d/%4d] time: %4.4f, '
              'joint_dis_dloss: %.8f, joint_dis_gloss: %.8f'
              % (epoch, config.epoch, idx, len(dataset),
                 time.time() - start_time, 2 * d_err, g_err))
        metrics_log.write(json.dumps(
            {'step': step_counter, 'epoch': epoch, **metrics}) + '\n')
        metrics_log.flush()
        bad = sorted(k for k, v in metrics.items() if not math.isfinite(v))
        if bad and config.nan_policy != 'ignore':
            if not nan_streak:
                print(f' [!] non-finite losses at step {step_counter}: '
                      f'{",".join(bad)}')
            nan_streak = True
            if config.nan_policy == 'halt':
                halted.append(step_counter)
        else:
            nan_streak = False

    pending = None  # (counter, epoch, idx, packed metrics) of the last step
    try:
        for epoch in range(config.epoch):
            if stop_requested or halted:
                break
            dataset.shuffle()
            for idx, (images, z, _files) in enumerate(loader):
                if config.profile_steps and counter == 2 and profiler is None:
                    profiler = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU] + (
                        [torch.profiler.ProfilerActivity.CUDA]
                        if device.type == 'cuda' else []))
                    profiler.start()
                    profile_end = counter + config.profile_steps
                images = images.to(device, non_blocking=True)
                z = z.to(device, non_blocking=True)
                generator.manual_seed(step_seed(config, counter))
                draws = make_draws(config, images.shape[0], generator, device)
                state, metrics = train_step(state, images, z, draws)
                if not metric_names:
                    metric_names.extend(sorted(metrics))
                packed = torch.stack([metrics[k].float()
                                      for k in metric_names])
                counter += 1
                if pending is not None:
                    process_metrics(*pending)
                pending = (counter, epoch, idx, packed)
                if halted:
                    break
                if profiler is not None and counter >= profile_end:
                    _stop_profile(profiler, config.logdir, device)
                    profiler = None
                if counter % config.save_checkpoint_frequency == 2:
                    print(' [*] Saving checkpoints...')
                    ckpt.save(config.checkpoint_dir, counter, state,
                              keep=config.keep_checkpoint_max)
                if stop_requested:
                    break
        if pending is not None and not halted:
            process_metrics(*pending)  # the last step's metrics
        if halted:
            print(' [!] nan_policy=halt: saving checkpoint and exiting')
            ckpt.save_halt(config.checkpoint_dir, counter, state)
            raise SystemExit(1)
        if stop_requested:
            print(f' [*] Caught signal {stop_requested[0]}: saving '
                  f'checkpoint at counter {counter} and exiting')
            ckpt.save(config.checkpoint_dir, counter, state,
                      keep=config.keep_checkpoint_max)
    finally:
        if profiler is not None:
            _stop_profile(profiler, config.logdir, device)
        loader.close()
        metrics_log.close()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return state


def step_seed(config, counter: int) -> int:
    """The seed of step `counter`'s draws."""
    return int(np.random.SeedSequence(
        [config.seed, config.rng_salt, counter]).generate_state(
            1, np.uint64)[0])


def _stop_profile(profiler, logdir: str, device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(os.path.join(logdir, 'profile'), exist_ok=True)
    path = os.path.join(logdir, 'profile', 'trace.json')
    profiler.export_chrome_trace(path)
    print(f' [*] Profile written to {path}')


if __name__ == '__main__':
    main()
