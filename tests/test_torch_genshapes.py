"""The port's procedural genshapes dataset (`edgegan_torch/data/
genshapes.py`) against the JAX package's (`scripts/genquality_run.py`
`stage`), on the CPU: the same seed gives the same files, byte for byte,
at the default 64x64 photos and at 128x128, and the module's photo size
stays a parameter (staging at another size leaves the default as it
was)."""
import os
import sys

import numpy as np
import pytest
from PIL import Image

from edgegan_torch.data import genshapes
from test_torch_variants import few_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES, TRAIN, TEST = 3, 2, 1


def _jax_stage():
    sys.path.insert(0, os.path.join(ROOT, 'scripts'))
    try:
        import genquality_run
    finally:
        sys.path.pop(0)
    return genquality_run.stage


def _files(root):
    """Relative path -> bytes of every file under `root`."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, 'rb') as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize('seed', [7, 11])
@pytest.mark.parametrize('hw', [None, (128, 128)])
def test_stage_matches_jax_bytes(tmp_path, seed, hw):
    want_counts = _jax_stage()(str(tmp_path / 'jax'), seed, TRAIN, TEST,
                               CLASSES, hw=hw)
    got_counts = genshapes.stage(str(tmp_path / 'port'), seed, TRAIN, TEST,
                                 CLASSES, hw=hw)
    assert got_counts == want_counts == (TRAIN * CLASSES, TEST * CLASSES)
    want, got = _files(tmp_path / 'jax'), _files(tmp_path / 'port')
    assert sorted(got) == sorted(want)
    assert len(got) == (TRAIN + TEST) * CLASSES
    for name in want:
        assert got[name] == want[name], name
    h, w = hw or (64, 64)
    pair = np.asarray(Image.open(tmp_path / 'port' / 'genshapes' / 'train'
                                 / '0' / '0000.png'))
    assert pair.shape == (h, 2 * w, 3)


def test_every_class_and_size_is_a_parameter(tmp_path):
    """All 14 classes draw; staging at 128x128 first does not move the
    next default-size staging (the size is no module state)."""
    genshapes.stage(str(tmp_path / 'big'), 3, 1, 0, 14, hw=(128, 128))
    genshapes.stage(str(tmp_path / 'a'), 3, 1, 0, 14)
    _jax_stage()(str(tmp_path / 'b'), 3, 1, 0, 14)
    assert genshapes.HW == (64, 64)
    a, b = _files(tmp_path / 'a'), _files(tmp_path / 'b')
    assert len(a) == 14 and a == b
