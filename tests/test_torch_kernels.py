"""K1 (`instance_norm_act`) and K2 (`instance_norm_act_bwd`): the port's
plain versions against the Pallas kernels in interpret mode (K2 through
`jax.vjp` of the custom VJP), the autograd Function that joins them, the
CPU/CUDA dispatch of the wrappers, and the port's independence of JAX.

Tests marked `cuda` need the card; they skip without one and run on it
with `python -m pytest --noconftest -m cuda tests/test_torch_kernels.py`.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from edgegan_torch.ops import in_checks, kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTS = [None, 'relu', 'lrelu']


def _x(shape=(2, 8, 4, 6), seed=0):
    """NHWC numpy input, with one constant plane (var == 0)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 2
    x[1, :, :, 3] = 0.5
    return x


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


# (act, plane H x W): the 8x4 planes of `_x`, and the sizes the kernels'
# variants split on: 1, 9 and 63 elements (not whole 16-byte vectors: the
# ragged groups) and 4096 (beyond a lane group: a block)
IN_CASES = [pytest.param(act, hw, id=str(act) if hw == (8, 4)
                         else f'{act}-{hw[0]}x{hw[1]}')
            for hw in [(8, 4), (1, 1), (3, 3), (7, 9), (64, 64)]
            for act in ACTS]


@pytest.mark.parametrize('act,hw', IN_CASES)
def test_plain_matches_pallas_interpret(act, hw):
    jnp = pytest.importorskip('jax.numpy')
    from edgegan_tpu.ops import pallas_kernels as pk
    x = _x((2,) + hw + (6,))
    ref = np.asarray(pk.instance_norm_act(jnp.asarray(x), act, True))
    got = kernels.instance_norm_act_plain(
        torch.from_numpy(x).permute(0, 3, 1, 2), act)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5)


@pytest.mark.parametrize('act', ACTS)
def test_plain_matches_pallas_interpret_on_nonfinite_planes(act):
    """On planes holding an inf or a NaN (`in_checks.with_nonfinite`, at
    1x1 and 8x4), K1's and K2's plain versions give what the Pallas
    kernels give in interpret mode, element by element: NaN, the same
    inf, or a value within 1e-5 (the other planes). The card checks hold
    each kernel variant to these plain versions on such planes."""
    jax = pytest.importorskip('jax')
    jnp = jax.numpy
    from edgegan_tpu.ops import pallas_kernels as pk
    for hw in [(1, 1), (8, 4)]:
        x = torch.from_numpy(_x((2,) + hw + (6,))).permute(0, 3, 1, 2)
        x = in_checks.with_nonfinite(x.contiguous())
        g = torch.from_numpy(np.random.RandomState(1).randn(
            *x.shape).astype(np.float32))
        xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
        ref, vjp = jax.vjp(lambda t: pk.instance_norm_act(t, act, True), xj)
        dref, = vjp(jnp.asarray(g.permute(0, 2, 3, 1).numpy()))
        for got, want in (
                (kernels.instance_norm_act_plain(x, act), ref),
                (kernels.instance_norm_act_bwd_plain(x, g, act), dref)):
            want = torch.from_numpy(np.array(want)).permute(0, 3, 1, 2)
            assert bool(want[0, 1].isnan().any())
            assert bool(want[0, 2].isnan().all())
            err, ok = in_checks._within(got, want, dict(atol=1e-5,
                                                        rtol=1e-6),
                                        equal_nan=True)
            assert ok, (hw, act, err)


def test_cpu_wrapper_is_plain_and_uncounted():
    x = torch.from_numpy(_x()).permute(0, 3, 1, 2)
    before = kernels.LAUNCHES['instance_norm_act']
    for act in ACTS:
        assert torch.equal(kernels.instance_norm_act(x, act),
                           kernels.instance_norm_act_plain(x, act))
    bf = x.to(torch.bfloat16)
    out = kernels.instance_norm_act(bf, 'relu')
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, kernels.instance_norm_act_plain(bf, 'relu'))
    assert kernels.LAUNCHES['instance_norm_act'] == before
    with pytest.raises(ValueError):
        kernels.instance_norm_act(x, 'tanh')


@pytest.mark.parametrize('act,hw', IN_CASES)
def test_bwd_plain_matches_pallas_vjp(act, hw):
    """K2's plain version against `jax.vjp` of the Pallas custom VJP in
    interpret mode (its `_bwd_kernel`), constant plane included."""
    jax = pytest.importorskip('jax')
    jnp = jax.numpy
    from edgegan_tpu.ops import pallas_kernels as pk
    x = _x((2,) + hw + (6,))
    g = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda t: pk.instance_norm_act(t, act, True),
                     jnp.asarray(x))
    ref, = vjp(jnp.asarray(g))
    got = kernels.instance_norm_act_bwd_plain(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(g).permute(0, 3, 1, 2), act)
    got, ref = got.permute(0, 2, 3, 1).numpy(), np.asarray(ref)
    if hw == (8, 4):
        # atol 1e-5 on the normal planes; on the constant plane dx is
        # (g' - mean g')/1e-5, values up to ~1e5 whose float32 spacing is
        # ~1e-2, so there the limit is relative (measured 3.9e-7)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-6)
        return
    # the normal planes as above. On the constant plane (x[1, ..., 3]),
    # mean g' summed in another order may differ by about float32 eps x
    # max|g'|, and dx divides that by 1e-5: where g' lies near its mean,
    # that is the whole of dx (measured 9.3e-4 on values of ~36, against
    # the 0.04 allowed here)
    const = np.zeros(x.shape, bool)
    const[1, :, :, 3] = True
    np.testing.assert_allclose(got[~const], ref[~const], atol=1e-5,
                               rtol=1e-6)
    spread = np.finfo(np.float32).eps * np.abs(g).max() / 1e-5
    np.testing.assert_allclose(got[const], ref[const], atol=spread,
                               rtol=1e-6)


@pytest.mark.parametrize('act', ACTS)
def test_bwd_plain_is_autograd_of_plain_forward(act):
    """K2's formula is the derivative of K1's plain version, constant
    plane included (both take the activation's slope at 0 from below)."""
    x = torch.from_numpy(_x()).permute(0, 3, 1, 2).double()
    x.requires_grad_(True)
    g = torch.from_numpy(np.random.RandomState(2).randn(
        *x.shape)).double()
    ref, = torch.autograd.grad(kernels.instance_norm_act_plain(x, act), x, g)
    got = kernels.instance_norm_act_bwd_plain(x.detach(), g, act)
    torch.testing.assert_close(got, ref, atol=1e-9, rtol=1e-9)


def _mean_formula(x, g, activation):
    """K1's and K2's plain versions as written with torch's `mean`: the
    plane means that `kernels._plane_mean` now takes as sum / n."""
    x32, g32 = x.float(), g.float()
    xc = x32 - x32.mean(dim=(2, 3), keepdim=True)
    var = (xc * xc).mean(dim=(2, 3), keepdim=True)
    nondeg = var > 0
    s = torch.sqrt(torch.where(nondeg, var, torch.ones_like(var)))
    d = torch.where(nondeg, s + kernels.EPS, torch.full_like(var, kernels.EPS))
    y = xc / d
    if activation == 'relu':
        out = torch.relu(y)
        g32 = torch.where(y > 0, g32, torch.zeros_like(g32))
    elif activation == 'lrelu':
        out = torch.where(y > 0, y, 0.2 * y)
        g32 = torch.where(y > 0, g32, 0.2 * g32)
    else:
        out = y
    dx = ((g32 - g32.mean(dim=(2, 3), keepdim=True)) / d
          - y * (g32 * y).mean(dim=(2, 3), keepdim=True) / s)
    return out.to(x.dtype), dx.to(x.dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('act', ACTS)
def test_plain_is_bitwise_the_mean_formula_on_cpu(dtype, act):
    """On the CPU, dividing the plane sums by n gives bitwise what torch's
    mean gives, at the generators' planes and at a constant 7x9 one."""
    gen = torch.Generator().manual_seed(7)
    for c, h, w in [(256, 8, 8), (128, 16, 16), (64, 32, 32), (3, 7, 9)]:
        x = (torch.randn(2, c, h, w, generator=gen) * 2 + 0.5).to(dtype)
        x[0, 0] = 3.0
        g = torch.randn(x.shape, generator=gen).to(dtype)
        y, dx = _mean_formula(x, g, act)
        assert torch.equal(kernels.instance_norm_act_plain(x, act), y)
        assert torch.equal(kernels.instance_norm_act_bwd_plain(x, g, act), dx)


def test_function_on_cpu_is_plain_forward_and_backward():
    """On the CPU the autograd Function runs both plain versions: its
    value and gradient equal autograd of `instance_norm_act_plain`, it is
    first-order only, and no launch is counted."""
    before = dict(kernels.LAUNCHES)
    x = torch.from_numpy(_x()).permute(0, 3, 1, 2).requires_grad_(True)
    g = torch.from_numpy(np.random.RandomState(3).randn(*x.shape)).float()
    for act in ACTS:
        y = kernels.instance_norm_act(x, act)
        dx, = torch.autograd.grad(y, x, g)
        ref = kernels.instance_norm_act_plain(x, act)
        dref, = torch.autograd.grad(ref, x, g)
        assert torch.equal(y, ref)
        torch.testing.assert_close(dx, dref, atol=1e-5, rtol=1e-5)
    y = kernels.instance_norm_act(x, 'relu')
    dx, = torch.autograd.grad(y, x, g.requires_grad_(True), create_graph=True)
    with pytest.raises(RuntimeError, match='once_differentiable'):
        dx.sum().backward()
    assert kernels.LAUNCHES == before


def test_non_cpu_wrapper_refuses_before_launch():
    """Off the CPU the wrappers never take the plain versions: a device
    they have no kernel for raises, whether or not the tensor requires
    grad (meta tensors stand in for a device here), and nothing is
    counted as launched."""
    before = dict(kernels.LAUNCHES)
    x = torch.empty(2, 3, 4, 4, device='meta', requires_grad=True)
    for t in (x, x.detach()):
        with pytest.raises(ValueError, match='device'):
            kernels.instance_norm_act(t, 'relu')
    with pytest.raises(ValueError, match='device'):
        kernels.instance_norm_act_bwd(x.detach(), torch.empty_like(x),
                                      'relu')
    assert kernels.LAUNCHES == before


GEN_PLANES = [(256, 8, 8), (128, 16, 16), (64, 32, 32)]  # g_dconv_1..3
DTYPES = [torch.float32, torch.bfloat16]


def _built_variants():
    """The (variant, lanes, vectors) that csrc/instance_norm_act.cu builds
    kernels for: its EDGEGAN_LANE_GROUP_SHAPES (7), EDGEGAN_BLOCK_SHAPES
    (2) and EDGEGAN_RAGGED_SHAPES (9) lists and the multi-pass kernel."""
    with open(os.path.join(ROOT, 'edgegan_torch', 'csrc',
                           'instance_norm_act.cu')) as f:
        src = f.read()
    built = {('multi_pass', 256, 0)}
    for variant, macro, count in (('lane_group', 'LANE_GROUP', 7),
                                  ('block', 'BLOCK', 2),
                                  ('ragged', 'RAGGED', 9)):
        shapes = src[src.index(f'#define EDGEGAN_{macro}_SHAPES'):]
        shapes = shapes[:re.search(r'\)\n(?!  )', shapes).end()]
        found = {(variant, int(g), int(n))
                 for g, n in re.findall(r'X\((\d+), (\d+)\)', shapes)}
        assert len(found) == count, found
        built |= found
    return built


@pytest.mark.parametrize('batch', [16, 64])
@pytest.mark.parametrize('dtype', DTYPES)
def test_plan_puts_generator_planes_in_lane_groups(batch, dtype):
    """Every instance norm of the generators, served (batch 16) or trained
    (batch 64), in either dtype, takes the register-resident lane-group
    kernels: one plane to 4-32 threads, 1-8 vectors each."""
    want = {torch.float32: [(16, 1), (32, 2), (32, 8)],
            torch.bfloat16: [(8, 1), (32, 1), (32, 4)]}[dtype]
    for (c, h, w), shape in zip(GEN_PLANES, want):
        x = torch.empty(batch, c, h, w, dtype=dtype)
        assert kernels.instance_norm_plan(h * w, dtype, x.data_ptr()) == (
            'lane_group',) + shape


@pytest.mark.parametrize('dtype', DTYPES)
def test_plan_sends_large_planes_to_multi_pass(dtype):
    """Beyond 32 threads x 8 vectors (1024 float32 or 2048 bfloat16
    elements) a plane goes to one block of 256 threads holding 2 or 4
    vectors each (up to 4096 float32 or 8192 bfloat16 elements); beyond
    that it is walked in passes: 65536 elements."""
    per_vector = 16 // dtype.itemsize
    assert kernels.instance_norm_plan(256 * per_vector, dtype, 0) == (
        'lane_group', 32, 8)
    for hw, vectors in ((256 * per_vector + per_vector, 2),
                        (512 * per_vector, 2),
                        (512 * per_vector + per_vector, 4),
                        (1024 * per_vector, 4)):
        assert kernels.instance_norm_plan(hw, dtype, 0) == (
            'block', 256, vectors), hw
    for hw in (1024 * per_vector + per_vector, 65536):
        assert kernels.instance_norm_plan(hw, dtype, 0) == (
            'multi_pass', 256, 0)
    # beyond 256 elements a ragged or misaligned plane is walked in passes
    assert kernels.instance_norm_plan(257, dtype, 0) == ('multi_pass', 256,
                                                         0)
    assert kernels.instance_norm_plan(4096, dtype, 4) == ('multi_pass', 256,
                                                          0)


@pytest.mark.parametrize('dtype', DTYPES)
def test_plan_sends_ragged_planes_to_ragged_groups(dtype):
    """A plane that does not split into whole 16-byte vectors from a
    16-byte boundary, of up to 256 elements, goes to a ragged group: as
    few lanes as hold it at up to 8 elements a lane (1 lane for 1 to 8
    elements) and as few elements a lane, whether its size or its base is
    off (8x8 at a storage offset of one element)."""
    itemsize = dtype.itemsize
    for hw, plan in ((1, (1, 1)), (2, (1, 2)), (3, (1, 4)), (7, (1, 8)),
                     (9, (2, 8)), (17, (4, 8)), (63, (8, 8)),
                     (65, (16, 8)), (255, (32, 8))):
        if hw % (16 // itemsize):
            assert kernels.instance_norm_plan(hw, dtype, 0) == (
                'ragged',) + plan, hw
        assert kernels.instance_norm_plan(hw, dtype, 4096 + itemsize) == (
            'ragged',) + plan, hw
    assert kernels.instance_norm_plan(64, dtype, 4096 + itemsize) == (
        'ragged', 8, 8)
    assert kernels.instance_norm_plan(256, dtype, 4096 + itemsize) == (
        'ragged', 32, 8)


def test_plan_routes_the_hires_and_convnet_encoder_planes():
    """The hires generator's g_dconv_3 [64,64,64,64] takes the block
    variant in both dtypes; the convnet encoder's [64,512,1,1] planes a
    ragged group of one lane in both, and its [64,512,2,2] one in
    bfloat16 (8 bytes a plane) and a lane group of 4 in float32 (16
    bytes); the default generators' and the convnet encoder's other planes
    stay in the lane groups that held them before the block and ragged
    variants existed."""
    def plan(shape, dtype):
        x = torch.empty(shape, dtype=dtype)
        return kernels.instance_norm_plan(shape[2] * shape[3], dtype,
                                          x.data_ptr())
    f32, bf16 = torch.float32, torch.bfloat16
    assert plan((64, 64, 64, 64), f32) == ('block', 256, 4)
    assert plan((64, 64, 64, 64), bf16) == ('block', 256, 2)
    for dtype in DTYPES:
        assert plan((64, 512, 1, 1), dtype) == ('ragged', 1, 1)
    assert plan((64, 512, 2, 2), bf16) == ('ragged', 1, 4)
    assert plan((64, 512, 2, 2), f32) == ('lane_group', 4, 1)
    want = {f32: [(16, 1), (32, 2), (32, 8), (4, 1)],
            bf16: [(8, 1), (32, 1), (32, 4), (4, 1)]}
    for dtype in DTYPES:
        for (c, h, w), shape in zip(GEN_PLANES + [(512, 4, 4)],
                                    want[dtype]):
            assert plan((64, c, h, w), dtype) == ('lane_group',) + shape


def test_plan_is_built_holds_the_plane_and_never_vectorises_ragged():
    """For every plane size up to twice the block's reach (8192 float32,
    16384 bfloat16 elements) and every misalignment: the plan names a
    kernel the source builds; a vector variant is picked only for whole
    16-byte vectors from a 16-byte boundary, a lane group up to 32 x 8
    vectors and a block up to 256 x 4, each holding the plane in at most
    twice the room it needs (or in the smallest group); a ragged group
    takes every other plane of up to 256 elements, in at most twice the
    room it needs (or in one element); every other plane takes the
    multi-pass kernel."""
    built = _built_variants()
    reached = set()
    for dtype in DTYPES:
        per_vector = 16 // dtype.itemsize
        for hw in range(1, 2 * 256 * 4 * per_vector + 2):
            nvec, ragged = divmod(hw, per_vector)
            for offset in (0, 2, 4, 8, 16, 48):
                plan = kernels.instance_norm_plan(hw, dtype, 4096 + offset)
                assert plan in built, (hw, dtype, offset, plan)
                reached.add(plan)
                variant, lanes, vectors = plan
                room = lanes * vectors
                if ragged or offset % 16:
                    if hw <= 256:
                        assert variant == 'ragged', (hw, dtype, offset)
                        assert hw <= room, (hw, dtype, plan)
                        assert 2 * hw > room or room == 1, (hw, dtype, plan)
                    else:
                        assert variant == 'multi_pass', (hw, dtype, offset)
                    continue
                if nvec <= 32 * 8:
                    assert variant == 'lane_group', (hw, dtype, plan)
                elif nvec <= 256 * 4:
                    assert variant == 'block', (hw, dtype, plan)
                else:
                    assert variant == 'multi_pass', (hw, dtype, plan)
                    continue
                assert nvec <= room, (hw, dtype, plan)
                assert 2 * nvec > room or room == 4, (hw, dtype, plan)
    assert reached == built


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('act', ACTS)
def test_kernel_matches_plain_on_card(cuda, dtype, act):
    x = torch.from_numpy(_x((16, 32, 32, 64))).permute(0, 3, 1, 2)
    x = x.contiguous().to(cuda, dtype)
    before = kernels.LAUNCHES['instance_norm_act']
    got = kernels.instance_norm_act(x, act)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['instance_norm_act'] == before + 1
    ref = kernels.instance_norm_act_plain(x, act)
    tol = (dict(atol=2e-5, rtol=0) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.cuda
def test_kernel_refuses_on_card(cuda):
    """On the card the wrappers launch or raise: a strided or float16
    input and a cotangent that does not match x are refused."""
    x = torch.randn(2, 3, 4, 4, device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        kernels.instance_norm_act(x.transpose(2, 3), 'relu')
    with pytest.raises(ValueError, match='dtype'):
        kernels.instance_norm_act(x.half(), 'relu')
    with pytest.raises(ValueError, match='does not match'):
        kernels.instance_norm_act_bwd(x, x[:1].contiguous(), 'relu')
    with pytest.raises(ValueError, match='contiguous'):
        kernels.instance_norm_act_bwd(x, x.transpose(2, 3), 'relu')


def _gated_close(got, ref, x, act, **tol):
    """assert_close, leaving out the elements whose y_pre lies within 1e-4
    of 0 when there is an activation: there the rounding of the plane's
    mean decides relu's or lrelu's slope, differently in the kernel and in
    the plain version."""
    if act is not None:
        band = kernels.instance_norm_act_plain(x.detach(), None).float()
        keep = band.abs() >= 1e-4
        got, ref = got.float()[keep], ref.float()[keep]
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('act', ACTS)
def test_bwd_kernel_matches_plain_on_card(cuda, dtype, act):
    x = torch.from_numpy(_x((16, 32, 32, 64))).permute(0, 3, 1, 2)
    x = x.contiguous().to(cuda, dtype)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    g = g.to(cuda, dtype)
    before = kernels.LAUNCHES['instance_norm_act_bwd']
    got = kernels.instance_norm_act_bwd(x, g, act)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['instance_norm_act_bwd'] == before + 1
    ref = kernels.instance_norm_act_bwd_plain(x, g, act)
    # dx divides by d = sqrt(var) + 1e-5, and by 1e-5 on the constant plane
    tol = (dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    _gated_close(got, ref, x, act, **tol)


@pytest.mark.cuda
def test_function_gradient_on_card(cuda):
    """The Function's backward (K2) against autograd of the plain forward,
    with both kernels counted once."""
    x = torch.from_numpy(_x((4, 16, 16, 32))).permute(0, 3, 1, 2)
    x = x.contiguous().to(cuda).requires_grad_(True)
    g = torch.randn(x.shape, device=cuda)
    before = dict(kernels.LAUNCHES)
    dx, = torch.autograd.grad(kernels.instance_norm_act(x, 'relu'), x, g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['instance_norm_act'] == before[
        'instance_norm_act'] + 1
    assert kernels.LAUNCHES['instance_norm_act_bwd'] == before[
        'instance_norm_act_bwd'] + 1
    ref, = torch.autograd.grad(kernels.instance_norm_act_plain(x, 'relu'),
                               x, g)
    _gated_close(dx, ref, x, 'relu', atol=1e-4, rtol=1e-4)


K1_TOL = {torch.float32: dict(atol=2e-5, rtol=0),
          torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# dx divides by d = sqrt(var) + 1e-5, and by 1e-5 on the constant plane
K2_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
          torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


# The variant each plane of in_checks.EDGE_PLANES takes at a 16-byte
# aligned base, float32 and bfloat16
EDGE_VARIANT = {(1, 1): ('ragged', 'ragged'), (2, 2): ('lane_group', 'ragged'),
                (3, 3): ('ragged', 'ragged'), (7, 9): ('ragged', 'ragged'),
                (8, 8): ('lane_group', 'lane_group'),
                (16, 16): ('lane_group', 'lane_group'),
                (32, 32): ('lane_group', 'lane_group'),
                (32, 64): ('block', 'lane_group'),
                (64, 64): ('block', 'block'),
                (64, 128): ('multi_pass', 'block'),
                (256, 256): ('multi_pass', 'multi_pass')}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('hw', in_checks.EDGE_PLANES,
                         ids=lambda hw: f'{hw[0]}x{hw[1]}')
def test_variants_match_plain_on_card(cuda, dtype, hw):
    """Each variant, where the plan sends this plane size, dtype and
    (aligned) address, against the plain versions (and those against
    float64), with the per-variant launch counts and two runs bitwise
    equal; then on the same planes holding an inf and a NaN, element by
    element against the plain versions."""
    x, g = in_checks.edge_inputs(cuda, hw, dtype)
    assert (x.data_ptr() | g.data_ptr()) % 16 == 0
    variant, _, _ = kernels.instance_norm_plan(
        hw[0] * hw[1], dtype, x.data_ptr() | g.data_ptr())
    assert variant == EDGE_VARIANT[hw][DTYPES.index(dtype)]
    in_checks.check_kernels(x, g, K1_TOL[dtype], K2_TOL[dtype], variant)
    in_checks.check_nonfinite(in_checks.with_nonfinite(x), g, K1_TOL[dtype],
                              K2_TOL[dtype], variant)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_misaligned_input_takes_multi_pass_on_card(cuda, dtype):
    """A contiguous view at a storage offset of one element starts off a
    16-byte boundary: K1 and K2 take a ragged group for an 8x8 plane and
    the multi-pass kernel for a 64x64 one (beyond the ragged groups'
    256 elements), and give what the aligned variants (lane group, block)
    give on the same values, within the limits. A misaligned g alone sends
    K2 there too."""
    tols = K1_TOL[dtype], K2_TOL[dtype]
    for hw, aligned, off in (((8, 8), 'lane_group', 'ragged'),
                             ((64, 64), 'block', 'multi_pass')):
        x, g = in_checks.edge_inputs(cuda, hw, dtype)
        xs, gs = in_checks.shifted(x), in_checks.shifted(g)
        in_checks.check_kernels(xs, gs, *tols, off)
        in_checks.check_kernels(x, gs, *tols, aligned, bwd_variant=off)
        for act in ACTS:
            torch.testing.assert_close(
                kernels.instance_norm_act(xs, act).float(),
                kernels.instance_norm_act(x, act).float(), **K1_TOL[dtype])


@pytest.mark.cuda
def test_library_refuses_impossible_variant_on_card(cuda):
    """The C entry points launch a variant only where it is built and
    holds the plane: 16 lanes x 1 vector hold a 64-element float32 plane;
    4 x 1 do not, 12 lanes are not built, and a base off 16 bytes is
    refused (cudaErrorInvalidValue, 1), as are multi-pass with vectors, a
    block off 16 bytes or of 8 vectors (not built), a ragged group of 1
    lane x 8 elements (room for 8 of the 64), one of 3 lanes (not built)
    and a variant 4. A ragged group of 8 x 8 holds the plane at any
    base."""
    from edgegan_torch.ops._build import library
    lib = library()
    x = torch.randn(1, 4, 8, 8, device=cuda)
    y = torch.empty_like(x)
    s = torch.cuda.current_stream().cuda_stream

    def fwd(x_ptr, variant, lanes, vectors):
        return lib.edgegan_instance_norm_act_fwd(
            x_ptr, y.data_ptr(), 4, 64, 0, 1, variant, lanes, vectors, s)

    assert fwd(x.data_ptr(), 1, 16, 1) == 0
    assert fwd(x.data_ptr(), 1, 4, 1) == 1
    assert fwd(x.data_ptr(), 1, 12, 1) == 1
    assert fwd(x.data_ptr() + 4, 1, 16, 1) == 1
    assert fwd(x.data_ptr(), 0, 256, 1) == 1
    assert fwd(x.data_ptr(), 2, 256, 2) == 0
    assert fwd(x.data_ptr() + 4, 2, 256, 2) == 1
    assert fwd(x.data_ptr(), 2, 256, 8) == 1
    off = torch.randn(4 * 64 + 1, device=cuda)   # 4 planes from element 1
    assert fwd(off.data_ptr() + 4, 3, 8, 8) == 0
    assert fwd(x.data_ptr(), 3, 1, 8) == 1
    assert fwd(x.data_ptr(), 3, 3, 8) == 1
    assert fwd(x.data_ptr(), 4, 256, 2) == 1
    # a lane group holds a plane smaller than its room, too
    assert lib.edgegan_instance_norm_act_bwd(
        x.data_ptr(), x.data_ptr(), y.data_ptr(), 4, 64, 0, 0, 1, 32, 8,
        s) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(y, kernels.instance_norm_act_bwd_plain(x, x),
                               **K2_TOL[torch.float32])


def test_port_imports_no_jax():
    """Every module of edgegan_torch, the training, test and serving
    paths' named first, and chip_smoke.py, import without JAX or the JAX
    package (checked in a fresh interpreter)."""
    code = (
        'import importlib, pkgutil, runpy, sys\n'
        'import edgegan_torch\n'
        "for name in ('cli.train', 'train.step', 'checkpoint', "
        "'data.dataset', 'data.loader', 'losses', 'cli.test', 'serve', "
        "'utils.metrics_io', 'utils.images', 'parallel'):\n"
        "    importlib.import_module('edgegan_torch.' + name)\n"
        'for m in pkgutil.walk_packages(edgegan_torch.__path__, '
        "'edgegan_torch.'):\n"
        '    importlib.import_module(m.name)\n'
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'edgegan_tpu', "
        "'edgegan'))\n"
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
