"""Quality trajectory: classifier-FID against the training step, `python
-m edgegan_torch.cli.fid_curve` (the JAX package's scripts/fid_curve.py).

Evaluates the retained checkpoints of a run (`cli.evaluate.evaluate`
with `--step` over the checkpoint ladder) on each split of `--splits`
and writes the curve:

    python -m edgegan_torch.cli.fid_curve --name gqrun --outputsroot out \\
        --dataroot data --dataset genshapes --num_classes 4 \\
        [--outdir docs] [--limit 256] [--splits train,test] [--device cpu]

Its own flags are the JAX script's: `--outdir --limit --eval_batch
--splits --extractor_step --extractor_npz --exclude_extractor_point
--max_points`; every other flag (the configuration's, `--device`) goes to
`cli.evaluate`, so the sweep runs on `cuda` unless `--device cpu`.

The extractor is the same for every point, so that all of them lie in
one feature space: the pinned one (`--extractor_npz`, external to the
run: every retained step is a point), or the run's own classifier at
`--extractor_step` (default the last retained step), whose own step is
left out of the curve unless `--exclude_extractor_point false` (a
generator scored by the classifier it was trained against looks better
than it is). `--max_points` (default 24, 0 = all) subsamples the ladder
evenly, the first and last steps always kept. The extractor is loaded
once for the sweep.

Prints one JSON row per point, writes `<outdir>/fidcurve.json` (the JAX
script's keys) and `<outdir>/fidcurve.png` (needs matplotlib; without
it, a line says the plot was not written), then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

from .. import checkpoint as ckpt
from . import evaluate as evaluate_cli

METRICS = ('classifier_fid', 'l1', 'mse', 'psnr_db')


def _flag_bool(s: str) -> bool:
    return s.lower() in ('1', 'true', 'yes')


def parse_args(argv=None):
    parser = argparse.ArgumentParser('edgegan_torch.cli.fid_curve',
                                     add_help=False)
    parser.add_argument('--outdir', default='docs')
    parser.add_argument('--limit', type=int, default=256)
    parser.add_argument('--eval_batch', type=int, default=32)
    parser.add_argument('--splits', default='train,test')
    parser.add_argument('--extractor_step', type=int, default=None,
                        help='checkpoint whose classifier scores the whole '
                             'sweep (default: the last retained step)')
    parser.add_argument('--extractor_npz', default=None,
                        help='the pinned cross-run extractor: every '
                             'retained step is a point, and curves compare '
                             'across runs')
    parser.add_argument('--exclude_extractor_point', type=_flag_bool,
                        default=True,
                        help="leave the extractor checkpoint's own step out "
                             'of the curve (default on)')
    parser.add_argument('--max_points', type=int, default=24,
                        help='subsample the ladder evenly to at most N '
                             'points, the first and last retained steps '
                             'kept; 0 = every retained checkpoint')
    return parser.parse_known_args(argv)


def ladder(steps: List[int], extractor_npz: Optional[str],
           extractor_step: Optional[int], exclude_extractor_point: bool,
           max_points: int):
    """(the extractor's step or None when pinned, the steps to sweep)."""
    if extractor_npz:
        extractor_step, sweep = None, list(steps)
    else:
        if extractor_step is None:
            extractor_step = steps[-1]
        sweep = [s for s in steps
                 if not (exclude_extractor_point and s == extractor_step)]
    if max_points and len(sweep) > max_points:
        idx = np.unique(np.linspace(0, len(sweep) - 1,
                                    max_points).round().astype(int))
        sweep = [sweep[i] for i in idx]
    return extractor_step, sweep


def plot(rows, splits, outdir: str, space: str) -> Optional[str]:
    """Write `<outdir>/fidcurve.png`; the path, or None without
    matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, (ax_fid, ax_l1) = plt.subplots(1, 2, figsize=(11, 4))
    xs = [r['step'] for r in rows]
    for split in splits:
        ax_fid.plot(xs, [r[split]['classifier_fid'] for r in rows],
                    marker='o', label=split)
        ax_l1.plot(xs, [r[split]['l1'] for r in rows], marker='o',
                   label=split)
    ax_fid.set_yscale('log')
    ax_fid.set_xlabel('training step')
    ax_fid.set_ylabel('classifier-FID (log)')
    ax_fid.legend()
    ax_l1.set_xlabel('training step')
    ax_l1.set_ylabel('L1 (real vs generated photo)')
    ax_l1.legend()
    fig.suptitle(f'EdgeGAN quality trajectory (classifier-feature FID in '
                 f'the {space} space; relative tracking, not InceptionV3 '
                 f'FID)')
    fig.tight_layout()
    path = os.path.join(outdir, 'fidcurve.png')
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def main(argv=None):
    args, passthrough = parse_args(argv)
    run = argparse.ArgumentParser(add_help=False)
    run.add_argument('--name', required=True)
    run.add_argument('--outputsroot', default='outputs')
    known, _ = run.parse_known_args(passthrough)
    ckpt_dir = os.path.join(known.outputsroot, known.name, 'checkpoints')

    steps = ckpt.steps(ckpt_dir)
    if not steps:
        raise SystemExit(f'no checkpoints under {ckpt_dir}')
    extractor_step, sweep = ladder(steps, args.extractor_npz,
                                   args.extractor_step,
                                   args.exclude_extractor_point,
                                   args.max_points)
    extractor_flags = (['--extractor_npz', args.extractor_npz]
                       if args.extractor_npz
                       else ['--extractor_step', str(extractor_step)])
    common = passthrough + extractor_flags + [
        '--limit', str(args.limit), '--eval_batch', str(args.eval_batch)]
    eargs = evaluate_cli.parse_args(common)
    config, device = evaluate_cli.setup(eargs)
    extractor = evaluate_cli.make_extractor(eargs, config, device)

    splits = args.splits.split(',')
    rows = []
    for step in sweep:
        row = {'step': step}
        for split in splits:
            result, _, _ = evaluate_cli.evaluate(
                common + ['--split', split, '--step', str(step)], extractor)
            row[split] = {k: result[k] for k in METRICS}
        rows.append(row)
        print(json.dumps(row), flush=True)

    os.makedirs(args.outdir, exist_ok=True)
    summary = {'checkpoint_dir': ckpt_dir, 'n_checkpoints': len(steps),
               'extractor_step': extractor_step,
               'extractor_npz': args.extractor_npz,
               'extractor_point_excluded': args.exclude_extractor_point,
               'limit': args.limit, 'curve': rows}
    out = os.path.join(args.outdir, 'fidcurve.json')
    with open(out, 'w') as f:
        json.dump(summary, f, indent=2)
    space = (f'pinned {os.path.basename(args.extractor_npz)}'
             if args.extractor_npz else f'step-{extractor_step} classifier')
    if plot(rows, splits, args.outdir, space) is None:
        print(f'fid_curve: matplotlib is not installed, so '
              f'{os.path.join(args.outdir, "fidcurve.png")} was not written '
              f'({out} was)', flush=True)
    print(json.dumps({'n_checkpoints': len(steps), 'out': out}))
    return summary


if __name__ == '__main__':
    main()
