"""K1 and K2 (`kernels.instance_norm_act`, `kernels.instance_norm_act_bwd`)
on the card against their plain versions, in each variant: the inputs
that reach the variants and one check of both kernels on them. The card
tests (tests/test_torch_kernels.py) and chip_smoke.py's variants phase
both run these.
"""
from __future__ import annotations

import torch

from . import kernels

ACTS = (None, 'relu', 'lrelu')
# Where |y_pre| < GATE_BAND the sign of y_pre, and with it relu's and
# lrelu's slope, is decided by the rounding of the plane's mean: there the
# kernel and the plain version may each take either slope, so K2 leaves
# those elements out of the comparison.
GATE_BAND = 1e-4
# Plane sizes (H, W) that reach every variant: 1, 9 and 63 elements (not
# whole 16-byte vectors: ragged), 4 (a lane group in float32, ragged in
# bfloat16), the generators' 64, 256 and 1024 (lane groups), 2048 (a block
# in float32, a lane group in bfloat16), 4096 (a block), 8192 (beyond a
# block in float32: multi-pass; a block in bfloat16) and 65536 (beyond a
# block: multi-pass).
EDGE_PLANES = [(1, 1), (2, 2), (3, 3), (7, 9), (8, 8), (16, 16), (32, 32),
               (32, 64), (64, 64), (64, 128), (256, 256)]


def edge_inputs(device, hw, dtype, planes: int = 37, seed: int = 0):
    """x and g of shape (1, planes, *hw) in `dtype` on `device`, made on
    the CPU from `seed`. 37 planes is a count no lane group divides, so
    the last block is part-filled; plane 0 of x is constant (var == 0)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((1, planes) + tuple(hw), generator=gen) * 2 + 0.5
    x[0, 0] = 3.0
    g = torch.randn(x.shape, generator=gen)
    return x.to(device, dtype), g.to(device, dtype)


def with_nonfinite(x):
    """A copy of `x` (3 planes or more) in which plane (0, 1) holds an inf
    at its first element and plane (0, 2) a NaN at its last."""
    out = x.clone()
    out[0, 1].view(-1)[0] = float('inf')
    out[0, 2].view(-1)[-1] = float('nan')
    return out


def shifted(t):
    """A contiguous copy of `t` at a storage offset of one element, so
    that its base address lies off a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    _require(out.is_contiguous() and out.data_ptr() % 16 != 0,
             'the shifted copy is not off 16 bytes')
    return out


def _require(cond, msg: str):
    if not cond:
        raise AssertionError(msg)


def _within(got, ref, tol, skip=None, equal_nan: bool = False):
    """(max |got - ref| outside `skip`, all within atol + rtol |ref| there).
    With `equal_nan`, an element that is NaN in both, or the same inf in
    both, counts as equal (difference 0)."""
    diff = (got.float() - ref.float()).abs()
    ok = diff <= tol['atol'] + tol['rtol'] * ref.float().abs()
    if equal_nan:
        same = (got.float() == ref.float()) | (got.float().isnan()
                                               & ref.float().isnan())
        ok |= same
        diff = torch.where(same, torch.zeros_like(diff), diff)
    if skip is not None:
        ok |= skip
        diff = torch.where(skip, torch.zeros_like(diff), diff)
    return diff.max().item(), bool(ok.all())


def check_kernels(x, g, tol, bwd_tol, variant: str,
                  bwd_variant: str | None = None, label: str = ''):
    """K1 and K2 on CUDA tensors (x, g) of shape (B, C, H, W), each run
    twice with each activation. Raises AssertionError unless:
      - K1 launched twice in `variant`, K2 twice in `bwd_variant` (default
        `variant`), as the per-variant and total counts in
        `kernels.LAUNCHES` show;
      - the two runs are bitwise equal;
      - K1 is within `tol` and K2 within `bwd_tol` of its plain version,
        K2 leaving out the elements whose |y_pre| < GATE_BAND when there
        is an activation; where plane (0, 0) is constant, K1 gives 0
        there;
      - each plain version is within the same limits of its float64
        computation. On a constant plane dx is (g' - mean g')/1e-5, and
        mean g' summed in float32 may differ by float32 eps x max|g|, so
        there K2's plain version gets that over 1e-5 as its atol.
    Returns the largest differences of K1 and K2 from their plain
    versions."""
    bwd_variant = bwd_variant or variant
    x64, g64 = x.double(), g.double()
    const = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if bool((x[0, 0] == x[0, 0].flatten()[0]).all()):
        const[0, 0] = True
    spread = torch.finfo(torch.float32).eps * g.float().abs().max().item() \
        / kernels.EPS
    band = kernels.instance_norm_act_plain(x, None).float().abs() < GATE_BAND
    err1 = err2 = 0.0
    for act in ACTS:
        what = f'{label} act={act}'
        before = dict(kernels.LAUNCHES)
        ys = [kernels.instance_norm_act(x, act) for _ in range(2)]
        dxs = [kernels.instance_norm_act_bwd(x, g, act) for _ in range(2)]
        torch.cuda.synchronize()
        for name, want in (('instance_norm_act', variant),
                           ('instance_norm_act_bwd', bwd_variant)):
            key = f'{name}.{want}'
            _require(kernels.LAUNCHES[key] == before[key] + 2
                     and kernels.LAUNCHES[name] == before[name] + 2,
                     f'{what}: {name} not launched twice as {want}')
        _require(torch.equal(ys[0], ys[1]) and torch.equal(dxs[0], dxs[1]),
                 f'{what}: two runs differ')
        skip = band if act else None

        y_ref = kernels.instance_norm_act_plain(x, act)
        e1, ok = _within(ys[0], y_ref, tol)
        _require(ok, f'{what}: K1 differs from plain by {e1:.3g}')
        _require(not bool(const.any()) or bool((ys[0][0, 0] == 0).all()),
                 f'{what}: K1 is not 0 on the constant plane')
        dx_ref = kernels.instance_norm_act_bwd_plain(x, g, act)
        e2, ok = _within(dxs[0], dx_ref, bwd_tol, skip)
        _require(ok and bool(torch.isfinite(dxs[0].float()).all()),
                 f'{what}: K2 differs from plain by {e2:.3g}')
        err1, err2 = max(err1, e1), max(err2, e2)

        e, ok = _within(y_ref, kernels.instance_norm_act_plain(x64, act), tol)
        _require(ok, f'{what}: K1 plain differs from float64 by {e:.3g}')
        dx64 = kernels.instance_norm_act_bwd_plain(x64, g64, act)
        off = const if skip is None else const | skip
        e, ok = _within(dx_ref, dx64, bwd_tol, off)
        _require(ok, f'{what}: K2 plain differs from float64 by {e:.3g}')
        if bool(const.any()):
            e, ok = _within(dx_ref, dx64, dict(
                bwd_tol, atol=max(bwd_tol['atol'], spread)), ~const)
            _require(ok, f'{what}: K2 plain differs from float64 on the '
                     f'constant plane by {e:.3g}')
    return err1, err2


def check_nonfinite(x, g, tol, bwd_tol, variant: str, label: str = ''):
    """K1 and K2 on CUDA tensors (x, g) whose planes hold an inf and a NaN
    (`with_nonfinite`), once with each activation, against their plain
    versions element by element: NaN where the plain version gives NaN,
    the same inf where it gives an inf, and within `tol` (K1) and
    `bwd_tol` (K2, leaving out the |y_pre| < GATE_BAND band with an
    activation) elsewhere, the other planes included. Raises
    AssertionError unless both launched in `variant`, and unless the
    plain versions give a NaN in both planes (so the check sees one)."""
    band = kernels.instance_norm_act_plain(x, None).float().abs() < GATE_BAND
    for act in ACTS:
        what = f'{label} act={act} (inf and NaN planes)'
        before = dict(kernels.LAUNCHES)
        y = kernels.instance_norm_act(x, act)
        dx = kernels.instance_norm_act_bwd(x, g, act)
        torch.cuda.synchronize()
        for name in ('instance_norm_act', 'instance_norm_act_bwd'):
            key = f'{name}.{variant}'
            _require(kernels.LAUNCHES[key] == before[key] + 1,
                     f'{what}: {name} not launched as {variant}')
        for kname, got, ref, lim, skip in (
                ('K1', y, kernels.instance_norm_act_plain(x, act), tol,
                 None),
                ('K2', dx, kernels.instance_norm_act_bwd_plain(x, g, act),
                 bwd_tol, band if act else None)):
            _require(bool(ref[0, 1].float().isnan().any())
                     and bool(ref[0, 2].float().isnan().any()),
                     f'{what}: {kname} plain gives no NaN there')
            e, ok = _within(got, ref, lim, skip, equal_nan=True)
            _require(ok, f'{what}: {kname} differs from plain by {e:.3g}')
