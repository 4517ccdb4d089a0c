"""K3 and K4 (`kernels.mru_gate_blend`, `kernels.mru_gate_bwd`) on the card
against their plain versions, in each variant: the inputs that reach the
variants and one check of both kernels on them. The card tests
(tests/test_torch_classifier_kernels.py) and chip_smoke.py's gate phase
both run these.
"""
from __future__ import annotations

import torch

from . import kernels
from .in_checks import _require, _within, with_nonfinite

# Plane sizes (H, W) that reach every variant: 1, 9 and 63 elements (not
# whole 16-byte vectors: multi-pass), MRU units 4 to 1 (64, 256 and 1024
# elements in lane groups, 4096 in a block), 1536 (a block in float32, a
# lane group in bfloat16), 16384 (the hires unit 1: a cluster of 4 blocks
# in float32, 2 in bfloat16), 32768 (a cluster of 8 blocks in float32)
# and 65536 (beyond a cluster in float32: multi-pass; 8 blocks in
# bfloat16).
GATE_PLANES = [(1, 1), (3, 3), (7, 9), (8, 8), (16, 16), (32, 32), (24, 64),
               (64, 64), (128, 128), (128, 256), (256, 256)]


def gate_inputs(device, shape, dtype, seed: int = 0):
    """(rg, ht, img, g) of NCHW `shape` in `dtype` on `device`, made on the
    CPU from `seed`. Plane 0 of rg is flat (max == min); plane 1, where it
    has 4 elements or more, has two elements tied at its minimum and two
    at its maximum."""
    gen = torch.Generator().manual_seed(seed)
    rg, ht, img, g = (torch.randn(shape, generator=gen) for _ in range(4))
    planes = rg.view(-1, shape[2] * shape[3])
    planes[0] = 1.5
    if planes.shape[0] > 1 and planes.shape[1] >= 4:
        p = planes[1]
        lo, hi = p.min().item(), p.max().item()
        p[0] = p[-1] = lo
        p[1] = p[-2] = hi
    return tuple(t.to(device, dtype) for t in (rg, ht, img, g))


def with_nonfinite_gate(rg):
    """A copy of `rg` (4 planes or more) in which plane (0, 1) holds +inf
    at its first element and plane (0, 2) a NaN at its last
    (`in_checks.with_nonfinite`), and plane (0, 3) -inf at its middle."""
    out = with_nonfinite(rg)
    p = out[0, 3].view(-1)
    p[p.numel() // 2] = float('-inf')
    return out


def _bits(t):
    """`t`'s bits as integers, so that NaNs compare equal to themselves."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def check_gate_nonfinite(rg, ht, img, g, tol, bwd_tol, variant: str,
                         label: str = ''):
    """K3 and K4 on CUDA tensors whose rg holds +inf, NaN and -inf planes
    (`with_nonfinite_gate`), each run twice, against their plain versions
    element by element: NaN where the plain version gives NaN, the same
    inf where it gives an inf, and within `tol` (K3) and `bwd_tol` (K4)
    elsewhere, the other planes included. Raises AssertionError unless
    both launched twice in `variant`, the two runs are bitwise equal, the
    plain K3 gives a NaN on each of the three planes (so the check sees
    them) and the plain K4's drg none on the NaN plane (the Pallas
    kernel's drg: its tie shares never reach an element there)."""
    rg = with_nonfinite_gate(rg)
    before = dict(kernels.LAUNCHES)
    outs = [kernels.mru_gate_blend(rg, ht, img) for _ in range(2)]
    grads = [kernels.mru_gate_bwd(rg, img, g) for _ in range(2)]
    torch.cuda.synchronize()
    what = f'{label} (+inf, NaN and -inf planes)'
    for name in ('mru_gate_blend', 'mru_gate_bwd'):
        key = f'{name}.{variant}'
        _require(kernels.LAUNCHES[key] == before[key] + 2,
                 f'{what}: {name} not launched twice as {variant}')
    _require(torch.equal(_bits(outs[0]), _bits(outs[1]))
             and all(torch.equal(_bits(a), _bits(b))
                     for a, b in zip(*grads)),
             f'{what}: two runs differ')
    ref = kernels.mru_gate_blend_plain(rg, ht, img)
    _require(all(bool(ref[0, p].float().isnan().any()) for p in (1, 2, 3)),
             f'{what}: K3 plain gives no NaN on a nonfinite plane')
    e, ok = _within(outs[0], ref, tol, equal_nan=True)
    _require(ok, f'{what}: K3 differs from plain by {e:.3g}')
    refs = kernels.mru_gate_bwd_plain(rg, img, g)
    _require(not bool(refs[0][0, 2].float().isnan().any()),
             f'{what}: K4 plain gives NaN on the NaN plane')
    for name, got, want in zip(('drg', 'dimg'), grads[0], refs):
        e, ok = _within(got, want, bwd_tol, equal_nan=True)
        _require(ok, f'{what}: K4 {name} differs from plain by {e:.3g}')


def check_gate(rg, ht, img, g, tol, bwd_tol, variant: str,
               bwd_variant: str | None = None, label: str = ''):
    """K3 and K4 on CUDA tensors of one shape, each run twice. Raises
    AssertionError unless:
      - K3 launched twice in `variant`, K4 twice in `bwd_variant` (default
        `variant`), as the per-variant and total counts in
        `kernels.LAUNCHES` show;
      - the two runs are bitwise equal;
      - K3's output is within `tol`, and K4's drg and dimg within
        `bwd_tol`, of the plain versions, and finite.
    Returns the largest differences of K3 and K4 from their plain
    versions."""
    bwd_variant = bwd_variant or variant
    before = dict(kernels.LAUNCHES)
    outs = [kernels.mru_gate_blend(rg, ht, img) for _ in range(2)]
    grads = [kernels.mru_gate_bwd(rg, img, g) for _ in range(2)]
    torch.cuda.synchronize()
    for name, want in (('mru_gate_blend', variant),
                       ('mru_gate_bwd', bwd_variant)):
        key = f'{name}.{want}'
        _require(kernels.LAUNCHES[key] == before[key] + 2
                 and kernels.LAUNCHES[name] == before[name] + 2,
                 f'{label}: {name} not launched twice as {want}')
    _require(torch.equal(outs[0], outs[1])
             and all(torch.equal(a, b) for a, b in zip(*grads)),
             f'{label}: two runs differ')
    e3, ok = _within(outs[0], kernels.mru_gate_blend_plain(rg, ht, img), tol)
    _require(ok and bool(torch.isfinite(outs[0].float()).all()),
             f'{label}: K3 differs from plain by {e3:.3g}')
    e4 = 0.0
    for what, got, ref in zip(('drg', 'dimg'), grads[0],
                              kernels.mru_gate_bwd_plain(rg, img, g)):
        e, ok = _within(got, ref, bwd_tol)
        _require(ok and bool(torch.isfinite(got.float()).all()),
                 f'{label}: K4 {what} differs from plain by {e:.3g}')
        e4 = max(e4, e)
    return e3, e4
