"""Configuration dataclass for the PyTorch port.

A copy of the JAX package's `Config`, so that both packages take the
same flags (the reference flag sets, train.py:13-75 and test.py:17-67,
plus the rebuild's additions). The port imports nothing of the JAX
package, so it keeps its own copy. Flags that only the JAX trainer reads
are kept for flag parity. `gpu` picks the CUDA device (`cuda:<gpu>`).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass
class Config:
    # shared flags (train.py:13-75 / test.py:17-67)
    gpu: str = '0'                       # CUDA device index: cuda:<gpu>
    name: str = 'edgegan'
    outputsroot: str = 'outputs'
    epoch: int = 100
    learning_rate: float = 2e-4
    train_size: float = float('inf')
    batch_size: int = 64
    input_height: int = 64
    input_width: Optional[int] = 128
    output_height: int = 64
    output_width: Optional[int] = 128
    dataset: str = 'class14'
    input_fname_pattern: str = '*png'
    checkpoint_dir: Optional[str] = None
    logdir: Optional[str] = None
    dataroot: str = './data'
    save_checkpoint_frequency: int = 500
    crop: bool = False

    stage1_zl_loss: float = 10.0
    multiclasses: bool = True
    num_classes: Optional[int] = 14
    SPECTRAL_NORM_UPDATE_OPS: str = 'spectral_norm_update_ops'

    if_resnet_e: bool = True
    if_resnet_g: bool = False
    if_resnet_d: bool = False
    lambda_gp: float = 10.0

    E_norm: str = 'instance'
    G_norm: str = 'instance'
    D_norm: str = 'instance'

    use_image_discriminator: bool = True
    image_dis_size: int = 128
    use_edge_discriminator: bool = True
    edge_dis_size: int = 128
    joint_dweight: float = 1.0
    image_dweight: float = 1.0
    edge_dweight: float = 1.0
    z_dim: int = 100

    # test-only flags (test.py:45-54)
    test_output_dir: Optional[str] = None
    output_combination: str = 'full'
    type: str = 'gpwgan'
    optim: str = 'rmsprop'
    model: str = 'old'

    # rebuild additions (no reference counterpart)
    seed: int = 0                 # seed for params/noise
    dtype: str = 'float32'        # compute dtype: float32 | bfloat16
    update_mode: str = 'faithful'
    update_sn: bool = False       # False reproduces quirk Q3 (frozen u)
    data_parallel: bool = True
    prefetch: int = 2
    profile_steps: int = 0
    cache_data: bool = True
    summary_frequency: int = 100
    reference_metrics: bool = False
    keep_checkpoint_max: int = 5
    test_batch_size: int = 0
    nan_policy: str = 'warn'
    rng_salt: int = 0
    host_z: bool = False

    def derive(self, phase: str = 'train') -> 'Config':
        """Reference update_flags (train.py:85-98, test.py:85-97)."""
        cfg = dataclasses.replace(self)
        if cfg.input_width is None:
            cfg.input_width = cfg.input_height
        if cfg.output_width is None:
            cfg.output_width = cfg.output_height
        if phase == 'train' and not cfg.multiclasses:
            cfg.num_classes = None
        if phase == 'test':
            cfg.batch_size = 1  # test.py:89 forces batch 1
        path = os.path.join(cfg.outputsroot, cfg.name)
        cfg.checkpoint_dir = os.path.join(path, 'checkpoints')
        cfg.logdir = os.path.join(path, 'logs')
        cfg.test_output_dir = os.path.join(path, 'test_output')
        return cfg

    def save(self):
        """Write <outputsroot>/<name>/flags.json (reference train.py:100-107)."""
        path = os.path.join(self.outputsroot, self.name)
        os.makedirs(path, exist_ok=True)
        d = {k: (str(v) if v == float('inf') else v)
             for k, v in dataclasses.asdict(self).items()}
        with open(os.path.join(path, 'flags.json'), 'w') as f:
            json.dump(d, f, indent=4)

    def device(self, kind: str = 'cuda') -> str:
        """The torch device for `kind` ('cuda' or 'cpu'): `cuda:<gpu>`."""
        if kind == 'cpu':
            return 'cpu'
        if kind != 'cuda':
            raise ValueError(f'unknown device kind {kind!r}')
        return f'cuda:{self.gpu}'


def add_config_args(parser, phase: str = 'train'):
    """Attach every Config field as a --flag (argparse front-end)."""
    for field in dataclasses.fields(Config):
        name = f'--{field.name}'
        default = field.default
        if field.type in ('bool', bool) or isinstance(default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in
                                ('1', 'true', 'yes'), default=default)
            parser.add_argument(f'--no{field.name}', dest=field.name,
                                action='store_false')
        elif isinstance(default, int):
            parser.add_argument(name, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=str, default=default)
    return parser


def config_from_args(args) -> Config:
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(args).items() if k in names})
