"""Hand-written CUDA kernels of the port, each beside its plain version.

K1, `instance_norm_act`: fused instance norm + activation, forward.
  - Replaces the Pallas TPU kernel edgegan_tpu/ops/pallas_kernels.py:
    105-114 (`_fwd_kernel`) and 152-160 (`instance_norm_act`).
  - Bound on an H100: bytes, 2*B*C*H*W*itemsize over 3.35 TB/s. At the
    serving shapes (at most 2 MB a call) launch latency, not bandwidth,
    sets its time.
K2, `instance_norm_act_bwd`: K1's first-order VJP from x alone.
  - Replaces `_bwd_kernel` (l.117-135), launched by `_in_bwd` (l.167-172).
  - Bound: bytes, 3*B*C*H*W*itemsize (reads x and g, writes dx).
K5, `prelu_bwd`: the classifier's PReLU backward, dx and the scalar dleak
  in one pass (csrc/prelu_bwd.cu).
  - Replaces `_prelu_bwd_kernel` (l.196-209), launched by `_prelu_bwd`
    (l.247-274).
  - Bound: bytes, 3*n*itemsize (reads x and g, writes dx).
K3, `mru_gate_blend`, and K4, `mru_gate_bwd`: the MRU unit's min-max gate
  and blend, forward and backward (csrc/mru_gate.cu).
  - Replace `_gate_fwd_kernel` (l.308-314, `mru_gate_blend` l.367-381) and
    `_gate_bwd_kernel` (l.317-343, `_gate_bwd` l.388-403).
  - Bounds: bytes, 4*n*itemsize (K3) and 5*n*itemsize (K4).

K1 and K2 (csrc/instance_norm_act.cu) normalise each contiguous NCHW
(batch, channel) plane with float32 statistics, in the generators' three
DeconvBlocks (and the convnet encoder's blocks): K1 6 times per served
batch and 21 times per training step, K2 12 times per training step.
The plane is read from device memory once and held in registers, and the
sums are taken from there, in one of three variants that
`instance_norm_plan` picks from the plane's size and the tensors'
alignment:
  - 'lane_group': 4 to 32 threads per plane, several planes per block,
    sums by warp shuffles, up to 1024 float32 or 2048 bfloat16 elements.
    Every plane of the default configurations (64, 256 and 1024
    elements) takes it.
  - 'block': the whole block on one plane, 2 or 4 16-byte vectors a
    thread, up to 4096 float32 or 8192 bfloat16 elements: the hires
    generator's 64x64 planes.
  - 'ragged': 1 to 32 threads per plane holding single elements at any
    alignment, for planes that do not split into 16-byte vectors (a plane
    size or a base address that is not a multiple of 16 bytes) of up to
    256 elements: the convnet encoder's 1x1 planes (and 2x2 in bfloat16).
A fourth, 'multi_pass', one block walking the plane once per sum (the
earlier design), takes what none of them holds: aligned planes beyond a
block and ragged or misaligned planes beyond 256 elements. The bound is
bytes, and one read of each input is what it allows.
K3 and K4 (csrc/mru_gate.cu) hold each plane of the MRU gate the same way
(`gate_plan`): lane groups for MRU units 2 to 4, and for unit 1's 4096
elements the block variant; they build no ragged variant. K5, K3 and K4
run in the classifier, and only when their switches are on
(`prelu_enabled`, `gate_enabled`): 42, 12 and 12 times per training step
(three classifier passes, each through 14 PReLUs and 4 MRU gates).

Each kernel pair is one `torch.autograd.Function` with a first-order
backward, as the JAX package's custom VJPs are: `instance_norm_act` saves
only x (`_in_fwd`, l.163-164), `prelu` saves x and the leak, and
`mru_gate` saves only (rg, img) (`_gate_fwd`, l.384-385). The critics,
which WGAN-GP differentiates twice, never call them.

A wrapper takes the plain version only for a tensor on the CPU. A CUDA
tensor launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from . import activations
from .norms import nan_guards_enabled

EPS = 1e-5
_ACTS = {None: 0, 'relu': 1, 'lrelu': 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# K3's and K4's variants (mru_gate.cu) and their numbers there
GATE_VARIANTS = {'multi_pass': 0, 'lane_group': 1, 'block': 2}
# K1's and K2's (instance_norm_act.cu): those and the ragged lane group
IN_VARIANTS = {**GATE_VARIANTS, 'ragged': 3}
IN_THREADS = 256      # threads a block, in every variant but K3/K4's
                      # multi-pass kernel (32 to 256 by the plane's size)
IN_MAX_VECTORS = 8    # 16-byte vectors a lane-group thread holds, at most
BLOCK_VECTORS = 4     # and a thread of the block variant (K1-K4)
RAGGED_ELEMENTS = 8   # elements a thread of a ragged group holds, at most
RAGGED_REACH = 32 * RAGGED_ELEMENTS  # the largest ragged plane
# Launches per kernel, counted where the kernel is launched and nowhere
# else, and per variant ('instance_norm_act.lane_group', ...). Callers
# reset an entry to 0 to count one run.
LAUNCHES = {'instance_norm_act': 0, 'instance_norm_act_bwd': 0,
            'prelu_bwd': 0, 'mru_gate_blend': 0, 'mru_gate_bwd': 0,
            **{f'{k}.{v}': 0 for k in ('instance_norm_act',
                                       'instance_norm_act_bwd')
               for v in IN_VARIANTS},
            **{f'{k}.{v}': 0 for k in ('mru_gate_blend', 'mru_gate_bwd')
               for v in GATE_VARIANTS}}
# K5's scratch: one float32 partial of dleak per block, and so the cap on
# its grid (8 blocks on each of the H100's 132 SMs)
PRELU_PARTIALS = 1056


def _switch(name: str) -> bool:
    env = os.environ.get(name)
    return env is not None and env not in ('0', 'false', '')


def prelu_enabled() -> bool:
    """The PReLU backward goes to K5 when EDGEGAN_PALLAS_PRELU is set (to
    anything but 0, false or empty), as `pallas_kernels.prelu_enabled`
    (l.67-73) reads it; off by default, and off under EDGEGAN_NAN_GUARDS=0
    because the kernels implement the guarded numerics (l.40-50). Read at
    call time.

    The TPU kernel also asks `prelu_eligible` (l.221-229: whole 128-lane
    rows, a VMEM limit). That rule does not carry over: K5 takes every
    contiguous NCHW float32 or bfloat16 tensor, the 8-channel stem's
    included."""
    return nan_guards_enabled() and _switch('EDGEGAN_PALLAS_PRELU')


def gate_enabled() -> bool:
    """The MRU gate goes to K3/K4 when EDGEGAN_PALLAS_GATE is set; off by
    default and under EDGEGAN_NAN_GUARDS=0, like `prelu_enabled`. The TPU
    rule `gate_eligible` (l.352-364: channels a multiple of 128, a VMEM
    limit) does not carry over: K3/K4 take every contiguous NCHW float32
    or bfloat16 gate, MRU unit 1's 8-channel one included."""
    return nan_guards_enabled() and _switch('EDGEGAN_PALLAS_GATE')


def _check_act(activation: Optional[str]) -> int:
    if activation not in _ACTS:
        raise ValueError(f'unknown activation {activation!r}')
    return _ACTS[activation]


def _wide(x):
    """x in float32, or in float64 when it is float64 (the tests check the
    formulas in float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _plane_mean(t):
    """Mean over each (b, c) plane as sum / n, a true division, as the TPU
    kernels (pallas_kernels.py:108) and K1/K2 divide. On CUDA torch's mean,
    and a division by a Python number, multiply by 1/n instead: that
    leaves a constant plane of 63 elements a variance of ~1e-14, not 0,
    and its output -0.023, not 0. On the CPU all three are bitwise the
    same."""
    s = t.sum(dim=(2, 3), keepdim=True)
    return s / torch.full_like(s, t.shape[2] * t.shape[3])


def _stats(x):
    """float32 (centred x, s, d) per plane: s = sqrt(var) (1 where
    var == 0), d = s + 1e-5 (1e-5 where var == 0)."""
    x32 = _wide(x)
    xc = x32 - _plane_mean(x32)
    var = _plane_mean(xc * xc)
    nondeg = var > 0
    s = torch.sqrt(torch.where(nondeg, var, torch.ones_like(var)))
    return xc, s, torch.where(nondeg, s + EPS, torch.full_like(var, EPS))


def instance_norm_act_plain(x, activation: Optional[str] = None):
    """K1's function in plain torch: per (b, c) plane of NCHW `x`, f32
    mean and population variance, `act((x-mean)/(sqrt(var)+1e-5))` with
    denominator 1e-5 where var == 0; output in the input dtype. lrelu is
    written as `where(y > 0, y, 0.2y)`: the values of `max(y, 0.2y)`,
    with the derivative K2 takes at y == 0 (that of y < 0)."""
    _check_act(activation)
    xc, _, d = _stats(x)
    y = xc / d
    if activation == 'relu':
        y = torch.relu(y)
    elif activation == 'lrelu':
        y = torch.where(y > 0, y, 0.2 * y)
    return y.to(x.dtype)


def instance_norm_act_bwd_plain(x, g, activation: Optional[str] = None):
    """K2's function in plain torch: dx of K1 at x for the cotangent g,
    `(g' - mean g')/d - y_pre * mean(g' * y_pre)/s` per plane, with
    g' = act'(y_pre) * g; dx in x's dtype."""
    _check_act(activation)
    xc, s, d = _stats(x)
    y = xc / d
    g32 = _wide(g)
    if activation == 'relu':
        g32 = torch.where(y > 0, g32, torch.zeros_like(g32))
    elif activation == 'lrelu':
        g32 = torch.where(y > 0, g32, 0.2 * g32)
    return ((g32 - _plane_mean(g32)) / d
            - y * _plane_mean(g32 * y) / s).to(x.dtype)


def _check_cuda(x, name: str):
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {x.device}')
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f'{name} takes a contiguous NCHW tensor, got '
                         f'shape {tuple(x.shape)} strides {x.stride()}')
    if x.dtype not in _DTYPES:
        raise ValueError(f'{name}: unsupported dtype {x.dtype}')


def _check_like(name: str, **tensors):
    """Each tensor a contiguous NCHW CUDA tensor of a kernel's dtype, and
    all of the first one's shape, dtype and device."""
    (first, ref), *rest = tensors.items()
    _check_cuda(ref, name)
    for key, t in rest:
        _check_cuda(t, name)
        if t.shape != ref.shape or t.dtype != ref.dtype or \
                t.device != ref.device:
            raise ValueError(f'{name}: {key} {tuple(t.shape)} {t.dtype} '
                             f'{t.device} does not match {first} '
                             f'{tuple(ref.shape)} {ref.dtype} {ref.device}')


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {err}')


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def plane_plan(hw: int, dtype: torch.dtype, data_ptr: int,
               ragged_reach: int = 0):
    """(variant, lanes, vectors) of a per-plane kernel (K1-K4) for planes
    of `hw` elements of `dtype` at `data_ptr` (the tensors' addresses
    OR-ed together, so that one misaligned pointer shows): `lanes` threads
    own one plane, each holding `vectors` 16-byte vectors of it.

    - 'lane_group' while a plane fits 32 threads x 8 vectors (1024 float32
      or 2048 bfloat16 elements): one vector a thread and as few lanes as
      hold the plane (at least 4), or 32 lanes and as few vectors.
    - 'block' (lanes 256) beyond that while the plane fits 256 threads x
      BLOCK_VECTORS vectors (4096 float32 or 8192 bfloat16 elements), as
      few vectors as hold it.
    - Where the plane does not split into whole 16-byte vectors from a
      16-byte boundary (`hw` not a multiple of 16 / itemsize, or
      `data_ptr` not a multiple of 16): 'ragged' up to `ragged_reach`
      elements (0: K3/K4, which build no such variant), as few lanes as
      hold the plane at up to RAGGED_ELEMENTS elements each (1 lane for a
      1x1 plane) and as few elements (`vectors`) a lane.
    - 'multi_pass' (lanes 256, vectors 0) for every other plane."""
    per_vector = 16 // dtype.itemsize
    nvec, ragged = divmod(hw, per_vector)
    if ragged or data_ptr % 16:
        if hw <= ragged_reach:
            lanes = _pow2_at_least(-(-hw // RAGGED_ELEMENTS))
            return 'ragged', lanes, _pow2_at_least(-(-hw // lanes))
        return 'multi_pass', IN_THREADS, 0
    if nvec <= 32:
        return 'lane_group', max(4, _pow2_at_least(nvec)), 1
    if nvec <= 32 * IN_MAX_VECTORS:
        return 'lane_group', 32, _pow2_at_least(-(-nvec // 32))
    if nvec <= IN_THREADS * BLOCK_VECTORS:
        return 'block', IN_THREADS, _pow2_at_least(-(-nvec // IN_THREADS))
    return 'multi_pass', IN_THREADS, 0


def instance_norm_plan(hw: int, dtype: torch.dtype, data_ptr: int):
    """K1's and K2's (variant, lanes, vectors): `plane_plan` with ragged
    groups for ragged or misaligned planes of up to RAGGED_REACH
    elements."""
    return plane_plan(hw, dtype, data_ptr, RAGGED_REACH)


def gate_plan(hw: int, dtype: torch.dtype, data_ptr: int):
    """K3's and K4's (variant, lanes, vectors): `plane_plan` without the
    ragged variant."""
    return plane_plan(hw, dtype, data_ptr)


def _launch_planes(name: str, entry, plan, x, *tensors, act=()):
    """Launches a per-plane kernel (`entry`: K1, K2, K3 or K4) on
    contiguous NCHW `x` and the other tensors of its shape (outputs last),
    in the variant that `plan` picks, `act` (K1/K2's activation) after the
    dtype; raises if the library refuses it. Both sources number the
    variants they share alike, so IN_VARIANTS numbers K3/K4's too."""
    b, c, h, w = x.shape
    addr = 0
    for t in (x,) + tensors:
        addr |= t.data_ptr()
    variant, lanes, vectors = plan(h * w, x.dtype, addr)
    with torch.cuda.device(x.device):
        err = entry(x.data_ptr(), *(t.data_ptr() for t in tensors), b * c,
                    h * w, _DTYPES[x.dtype], *act, IN_VARIANTS[variant],
                    lanes, vectors, _stream(x))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    LAUNCHES[f'{name}.{variant}'] += 1


def _forward(x, activation: Optional[str]):
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    act = _check_act(activation)
    if x.device.type == 'cpu':
        return instance_norm_act_plain(x, activation)
    _check_cuda(x, 'instance_norm_act')
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    from ._build import library
    _launch_planes('instance_norm_act',
                   library().edgegan_instance_norm_act_fwd,
                   instance_norm_plan, x, y, act=(act,))
    return y


def instance_norm_act_bwd(x, g, activation: Optional[str] = None):
    """K2: dx of `instance_norm_act(x, activation)` for the cotangent g.

    CPU tensors take `instance_norm_act_bwd_plain`. CUDA tensors must be
    contiguous 4-D float32 or bfloat16, g of x's shape, dtype and device;
    anything else raises."""
    act = _check_act(activation)
    if x.device.type == 'cpu' and g.device.type == 'cpu':
        return instance_norm_act_bwd_plain(x, g, activation)
    _check_like('instance_norm_act_bwd', x=x, g=g)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    from ._build import library
    _launch_planes('instance_norm_act_bwd',
                   library().edgegan_instance_norm_act_bwd,
                   instance_norm_plan, x, g, dx, act=(act,))
    return dx


class _InstanceNormAct(torch.autograd.Function):
    """K1 forward, K2 backward; saves only x (pallas_kernels.py:163-172)."""

    @staticmethod
    def forward(ctx, x, activation):
        ctx.activation = activation
        ctx.save_for_backward(x)
        return _forward(x, activation)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return instance_norm_act_bwd(x, g.contiguous(), ctx.activation), None


def instance_norm_act(x, activation: Optional[str] = None):
    """Fused instance norm + activation of NCHW `x` (K1, backward K2).

    CPU tensors take the plain versions, forward and backward. CUDA
    tensors must be contiguous 4-D float32 or bfloat16; anything else
    raises. The backward is first-order only."""
    _check_act(activation)
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'instance_norm_act: unsupported device {x.device}')
    return _InstanceNormAct.apply(x, activation)


# ---------------------------------------------------------------------------
# K5: PReLU backward (the classifier's 14 PReLUs)
# ---------------------------------------------------------------------------


def prelu_bwd_plain(x, g, leak):
    """K5's function in plain torch: (dx, dleak) of `max(leak*x, x)` for
    the cotangent g, in float32 with the float32 leak (float64 stays
    float64): s_u = 1 where leak*x > x, 0.5 at a tie, else 0;
    dx = g*(s_u*leak + 1 - s_u) in x's dtype; dleak = sum(g*s_u*x), a 0-d
    tensor in leak's dtype. In bfloat16, s_u is decided on
    f32(leak)*f32(x), as the TPU kernel does (pallas_kernels.py:197-202),
    not on the forward's bf16(leak)*x."""
    x32, g32 = _wide(x), _wide(g)
    lk = leak.to(x32.dtype)
    u = lk * x32
    s_u = torch.where(u > x32, 1.0, torch.where(u == x32, 0.5, 0.0)).to(
        x32.dtype)
    dx = (g32 * (s_u * lk + (1.0 - s_u))).to(x.dtype)
    dleak = (g32 * s_u * x32).sum()
    return dx, dleak.to(leak.dtype).reshape(leak.shape)


def prelu_bwd(x, g, leak):
    """K5: (dx, dleak) of `prelu(x, leak)` for the cotangent g.

    CPU tensors take `prelu_bwd_plain`. On the card x and g must be
    contiguous 4-D float32 or bfloat16 of one shape, dtype and device, and
    leak a one-element float32 tensor there; anything else raises. dleak
    is summed in a fixed order: the same on every run."""
    if x.device.type == 'cpu' and g.device.type == 'cpu':
        return prelu_bwd_plain(x, g, leak)
    _check_like('prelu_bwd', x=x, g=g)
    if leak.numel() != 1 or leak.dtype != torch.float32 or \
            leak.device != x.device:
        raise ValueError(f'prelu_bwd: leak must be one float32 element on '
                         f'{x.device}, got {tuple(leak.shape)} {leak.dtype} '
                         f'{leak.device}')
    dx, dleak = torch.empty_like(x), torch.empty_like(leak)
    if x.numel() == 0:
        return dx, dleak.zero_()
    partials = torch.empty(PRELU_PARTIALS, dtype=torch.float32,
                           device=x.device)
    from ._build import library
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.edgegan_prelu_bwd(
            x.data_ptr(), g.data_ptr(), leak.data_ptr(), dx.data_ptr(),
            dleak.data_ptr(), partials.data_ptr(), x.numel(),
            PRELU_PARTIALS, _DTYPES[x.dtype], _stream(x))
    _raise_on(err, 'prelu_bwd')
    LAUNCHES['prelu_bwd'] += 1
    return dx, dleak


class _PReLU(torch.autograd.Function):
    """Plain forward `max(leak.to(x.dtype)*x, x)` (pallas_kernels.py:240),
    K5 backward; saves x and the leak (`_prelu_fwd`, l.243-244)."""

    @staticmethod
    def forward(ctx, x, leak):
        ctx.save_for_backward(x, leak)
        return activations.prelu(x, leak.to(x.dtype))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, leak = ctx.saved_tensors
        return prelu_bwd(x, g.contiguous(), leak)


def prelu(x, leak):
    """PReLU with the float32 scalar `leak`, forward plain, backward K5
    (first-order only). `x` is made contiguous first."""
    return _PReLU.apply(x.contiguous(), leak)


# ---------------------------------------------------------------------------
# K3 and K4: the MRU unit's min-max gate and blend
# ---------------------------------------------------------------------------


def _gate_stats(rg32):
    """Per plane: min, max, r = max - min, r > 0, and den (r, or 1 where
    the plane is flat)."""
    mn = rg32.amin(dim=(2, 3), keepdim=True)
    mx = rg32.amax(dim=(2, 3), keepdim=True)
    r = mx - mn
    pos = r > 0
    return mn, mx, r, pos, torch.where(pos, r, torch.ones_like(r))


def mru_gate_blend_plain(rg, ht, img):
    """K3's function in plain torch: `ht + (rg - min)/den * img` per
    (b, c) plane of NCHW tensors, den = max - min, or 1 where max == min;
    float32 math, output in rg's dtype."""
    rg32 = _wide(rg)
    mn, _, _, _, den = _gate_stats(rg32)
    return (_wide(ht) + (rg32 - mn) / den * _wide(img)).to(rg.dtype)


def mru_gate_bwd_plain(rg, img, g):
    """K4's function in plain torch: (drg, dimg) of K3 for the cotangent g
    (dht is g itself). dimg = g*rgn; drg = drgn/den plus, on the elements
    tied at the minimum and the maximum, an even share of
    dmn = sum(drgn*(rg - max))/r^2 and dmx = -sum(drgn*rgn)/den, with a
    flat plane sending -sum(drgn) to its minimum
    (pallas_kernels.py:317-343). float32 math, outputs in the inputs'
    dtypes."""
    rg32, img32, g32 = _wide(rg), _wide(img), _wide(g)
    mn, mx, r, pos, den = _gate_stats(rg32)
    rgn = (rg32 - mn) / den
    drgn = g32 * img32
    dims = (2, 3)
    r2 = torch.where(pos, r * r, torch.ones_like(r))
    d_min = torch.where(pos, (drgn * (rg32 - mx)).sum(dims, keepdim=True)
                        / r2, -drgn.sum(dims, keepdim=True))
    d_max = torch.where(pos, -(drgn * rgn).sum(dims, keepdim=True) / den,
                        torch.zeros_like(r))
    is_min, is_max = (rg32 == mn).to(rg32.dtype), (rg32 == mx).to(rg32.dtype)
    n_min = is_min.sum(dims, keepdim=True)
    n_max = is_max.sum(dims, keepdim=True)
    drg = drgn / den + is_min * (d_min / n_min) + is_max * (d_max / n_max)
    return drg.to(rg.dtype), (g32 * rgn).to(img.dtype)


def mru_gate_blend(rg, ht, img):
    """K3: `ht + minmax_normalize(rg) * img` per plane.

    CPU tensors take `mru_gate_blend_plain`. On the card rg, ht and img
    must be contiguous 4-D float32 or bfloat16 of one shape, dtype and
    device; anything else raises."""
    if all(t.device.type == 'cpu' for t in (rg, ht, img)):
        return mru_gate_blend_plain(rg, ht, img)
    _check_like('mru_gate_blend', rg=rg, ht=ht, img=img)
    out = torch.empty_like(rg)
    if rg.numel() == 0:
        return out
    from ._build import library
    _launch_planes('mru_gate_blend', library().edgegan_mru_gate_fwd,
                   gate_plan, rg, ht, img, out)
    return out


def mru_gate_bwd(rg, img, g):
    """K4: (drg, dimg) of `mru_gate_blend` for the cotangent g.

    CPU tensors take `mru_gate_bwd_plain`. On the card rg, img and g must
    be contiguous 4-D float32 or bfloat16 of one shape, dtype and device;
    anything else raises."""
    if all(t.device.type == 'cpu' for t in (rg, img, g)):
        return mru_gate_bwd_plain(rg, img, g)
    _check_like('mru_gate_bwd', rg=rg, img=img, g=g)
    drg, dimg = torch.empty_like(rg), torch.empty_like(img)
    if rg.numel() == 0:
        return drg, dimg
    from ._build import library
    _launch_planes('mru_gate_bwd', library().edgegan_mru_gate_bwd,
                   gate_plan, rg, img, g, drg, dimg)
    return drg, dimg


class _MRUGate(torch.autograd.Function):
    """K3 forward, K4 backward; saves only (rg, img) and returns dht = g
    without a kernel (pallas_kernels.py:384-403)."""

    @staticmethod
    def forward(ctx, rg, ht, img):
        ctx.save_for_backward(rg, img)
        return mru_gate_blend(rg, ht, img)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        rg, img = ctx.saved_tensors
        g = g.contiguous()
        drg, dimg = mru_gate_bwd(rg, img, g)
        return drg, g, dimg


def mru_gate(rg, ht, img):
    """The MRU gate and blend of NCHW `rg`, `ht`, `img` (K3, backward K4;
    first-order only). The inputs are made contiguous first."""
    return _MRUGate.apply(rg.contiguous(), ht.contiguous(), img.contiguous())
