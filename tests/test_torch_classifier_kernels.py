"""K5 (`prelu_bwd`) and K3/K4 (`mru_gate_blend`, `mru_gate_bwd`), the
classifier's kernels: the port's plain versions and autograd Functions
against the Pallas kernels in interpret mode (through `jax.vjp` of their
custom VJPs), the switches that turn them on, and the full classifier with
both switches on against the JAX classifier's default path.

Tests marked `cuda` need the card; they skip without one and run on it
with `python -m pytest --noconftest -m cuda
tests/test_torch_classifier_kernels.py`. JAX is imported inside the tests
that compare with it, so that these run where it is not installed.
"""
import os
import re

import numpy as np
import pytest
import torch

from edgegan_torch import losses as L
from edgegan_torch.ops import gate_checks, in_checks, kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAKS = [0.2, 1.5]
SWITCHES = ('EDGEGAN_PALLAS_PRELU', 'EDGEGAN_PALLAS_GATE')
DTYPES = [torch.float32, torch.bfloat16]
# The classifier's four MRU gates, (C, H, W): units 1 to 4
GATE_SHAPES = [(8, 64, 64), (128, 32, 32), (256, 16, 16), (512, 8, 8)]
# (variant, lanes, vectors) in csrc/mru_gate.cu's EDGEGAN_GATE_SHAPES
GATE_SHAPES_BUILT = 12


def _nchw_t(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _prelu_x(shape=(2, 8, 8, 16), seed=0):
    """NHWC input with exact zeros: the tie leak*x == x."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    x[0, 0, :, 0] = 0.0
    return x


def _gate_inputs(shape=(2, 4, 6, 8), seed=4):
    """NHWC (rg, ht, img, g): one flat plane of rg, and, where a plane has
    4 elements or more, two ties in another: at its minimum and at its
    maximum (test_pallas.py:68-79)."""
    rng = np.random.RandomState(seed)
    rg, ht, img, g = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    rg[0, :, :, 0] = 1.5
    if shape[1] * shape[2] >= 4:
        lo, hi = rg[1, :, :, 1].min(), rg[1, :, :, 1].max()
        rg[1, 0, 0, 1] = rg[1, -1, -1, 1] = lo
        rg[1, 0, -1, 1] = rg[1, -1, 0, 1] = hi
    return rg, ht, img, g


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('leak', LEAKS)
def test_prelu_bwd_matches_pallas_vjp(leak):
    """`prelu_bwd_plain`, and the autograd Function on the CPU, against
    `jax.vjp` of `pallas_kernels.prelu` in interpret mode: dx within
    1e-6 and dleak within 1e-5 (test_pallas.py:158-163), ties at x == 0
    included; a leak above 1 flips which side is the maximum."""
    jax = pytest.importorskip('jax')
    jnp = jax.numpy
    from edgegan_tpu.ops import pallas_kernels as pk
    x = _prelu_x()
    g = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda t, a: pk.prelu(t, a, True), jnp.asarray(x),
                       jnp.float32(leak))
    jdx, jdleak = vjp(jnp.asarray(g))
    lk = torch.tensor(leak, dtype=torch.float32)
    dx, dleak = kernels.prelu_bwd_plain(_nchw_t(x), _nchw_t(g), lk)
    np.testing.assert_allclose(_nhwc(dx), np.asarray(jdx), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(dleak.item(), float(jdleak), atol=1e-5,
                               rtol=1e-5)
    assert dleak.dtype == torch.float32 and dleak.shape == ()

    xt = _nchw_t(x).requires_grad_(True)
    lt = lk.clone().requires_grad_(True)
    y = kernels.prelu(xt, lt)
    np.testing.assert_array_equal(_nhwc(y.detach()), np.asarray(out))
    fdx, fdleak = torch.autograd.grad(y, (xt, lt), _nchw_t(g))
    assert torch.equal(fdx, dx) and torch.equal(fdleak, dleak)


@pytest.mark.parametrize('hw', [(6, 8), (1, 1), (3, 3), (7, 9), (8, 8),
                                (32, 32), (64, 64), (128, 128)],
                         ids=lambda hw: f'{hw[0]}x{hw[1]}')
def test_gate_matches_pallas_vjp(hw):
    """`mru_gate_blend_plain` and `mru_gate_bwd_plain`, and the Function
    on the CPU, against `pallas_kernels.mru_gate_blend` in interpret mode
    and `jax.vjp` of it: forward within 1e-6, the three gradients within
    1e-5 (test_pallas.py:82,91), with a flat plane and ties at both
    extrema of another, at planes of 48 elements and of 1, 9, 63, 64-4096
    (MRU units 4 to 1) and 16384 (the hires unit 1, a cluster's plane on
    the card). The Function returns dht = g."""
    jax = pytest.importorskip('jax')
    jnp = jax.numpy
    from edgegan_tpu.ops import pallas_kernels as pk
    rg, ht, img, g = _gate_inputs((2,) + hw + (8 if hw == (6, 8) else 4,))
    out, vjp = jax.vjp(lambda a, b, c: pk.mru_gate_blend(a, b, c, True),
                       *(jnp.asarray(t) for t in (rg, ht, img)))
    jdrg, jdht, jdimg = vjp(jnp.asarray(g))
    t = [_nchw_t(a) for a in (rg, ht, img, g)]
    got = kernels.mru_gate_blend_plain(*t[:3])
    np.testing.assert_allclose(_nhwc(got), np.asarray(out), atol=1e-6,
                               rtol=1e-6)
    drg, dimg = kernels.mru_gate_bwd_plain(t[0], t[2], t[3])
    for mine, ref in ((drg, jdrg), (dimg, jdimg)):
        np.testing.assert_allclose(_nhwc(mine), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)

    ins = [a.clone().requires_grad_(True) for a in t[:3]]
    y = kernels.mru_gate(*ins)
    assert torch.equal(y.detach(), got)
    grads = torch.autograd.grad(y, ins, t[3])
    for mine, ref in zip(grads, (jdrg, jdht, jdimg)):
        np.testing.assert_allclose(_nhwc(mine), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)
    assert torch.equal(grads[1], t[3])


def test_gate_bwd_plain_is_autograd_of_plain_chain():
    """K4's formula is the derivative of the MRU block's plain chain
    (`amin`/`amax`, the flat-plane guard, divide, blend) in float64: the
    even split of tied extrema and a flat plane's -sum(drgn) included."""
    rg, ht, img, g = (_nchw_t(a).double() for a in _gate_inputs(seed=5))
    ins = [a.clone().requires_grad_(True) for a in (rg, ht, img)]
    mn = ins[0].amin(dim=(2, 3), keepdim=True)
    rng = ins[0].amax(dim=(2, 3), keepdim=True) - mn
    rng = torch.where(rng > 0, rng, torch.ones_like(rng))
    ref = torch.autograd.grad(ins[1] + (ins[0] - mn) / rng * ins[2], ins, g)
    drg, dimg = kernels.mru_gate_bwd_plain(rg, img, g)
    torch.testing.assert_close(drg, ref[0], atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(dimg, ref[2], atol=1e-12, rtol=1e-12)


def test_switches(monkeypatch):
    """Off by default; on when set (not to 0, false or empty); off under
    EDGEGAN_NAN_GUARDS=0 whatever they say. Read at call time."""
    for name in SWITCHES + ('EDGEGAN_NAN_GUARDS',):
        monkeypatch.delenv(name, raising=False)
    assert not kernels.prelu_enabled() and not kernels.gate_enabled()
    for value in ('0', 'false', ''):
        monkeypatch.setenv('EDGEGAN_PALLAS_PRELU', value)
        assert not kernels.prelu_enabled()
    monkeypatch.setenv('EDGEGAN_PALLAS_PRELU', '1')
    assert kernels.prelu_enabled() and not kernels.gate_enabled()
    monkeypatch.setenv('EDGEGAN_PALLAS_GATE', '1')
    assert kernels.gate_enabled()
    monkeypatch.setenv('EDGEGAN_NAN_GUARDS', '0')
    assert not kernels.prelu_enabled() and not kernels.gate_enabled()


def test_cpu_wrappers_are_plain_and_uncounted():
    """On the CPU the wrappers are their plain versions, in float32 and
    bfloat16, and count no launch; off the CPU they never take the plain
    versions (meta tensors stand in for a device here)."""
    before = dict(kernels.LAUNCHES)
    x = _nchw_t(_prelu_x())
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    lk = torch.tensor(0.2)
    for dt in (torch.float32, torch.bfloat16):
        got = kernels.prelu_bwd(x.to(dt), g.to(dt), lk)
        ref = kernels.prelu_bwd_plain(x.to(dt), g.to(dt), lk)
        assert got[0].dtype == dt and got[1].dtype == torch.float32
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        rg, ht, img, gg = (_nchw_t(a).to(dt) for a in _gate_inputs())
        assert torch.equal(kernels.mru_gate_blend(rg, ht, img),
                           kernels.mru_gate_blend_plain(rg, ht, img))
        assert all(torch.equal(a, b) for a, b in zip(
            kernels.mru_gate_bwd(rg, img, gg),
            kernels.mru_gate_bwd_plain(rg, img, gg)))
    assert kernels.LAUNCHES == before
    m = torch.empty(2, 3, 4, 4, device='meta')
    with pytest.raises(ValueError, match='device'):
        kernels.prelu_bwd(m, m, torch.empty((), device='meta'))
    with pytest.raises(ValueError, match='device'):
        kernels.mru_gate_blend(m, m, m)
    with pytest.raises(ValueError, match='device'):
        kernels.mru_gate_bwd(m, m, m)
    assert kernels.LAUNCHES == before


def _gate_built():
    """The (variant, lanes, vectors) that csrc/mru_gate.cu builds kernels
    for: its EDGEGAN_GATE_SHAPES list and the multi-pass kernel."""
    with open(os.path.join(ROOT, 'edgegan_torch', 'csrc',
                           'mru_gate.cu')) as f:
        src = f.read()
    shapes = src[src.index('#define EDGEGAN_GATE_SHAPES'):]
    shapes = shapes[:shapes.index('\n\n')]
    names = {'kLaneGroup': 'lane_group', 'kBlock': 'block',
             'kCluster': 'cluster'}
    built = {(names[v], int(g), int(n)) for v, g, n in
             re.findall(r'X\((\w+), (\d+), (\d+)\)', shapes)}
    assert len(built) == GATE_SHAPES_BUILT, built
    return built | {('multi_pass', 256, 0)}


def test_gate_plan_is_built_holds_the_plane_and_never_vectorises_ragged():
    """For every plane size up to twice a cluster's reach, and every
    misalignment of 2 to 14 bytes (beyond twice a block's reach, those of
    2 and 16 bytes): the gate plan names a kernel the source builds; a
    register-resident variant is picked only for whole 16-byte vectors
    from a 16-byte boundary, a lane group up to 32 x 8 vectors, a block
    beyond that up to 256 x 4, and a cluster beyond that up to 8 blocks x
    256 x 4, each holding the plane in at most twice the room it needs
    (or in the smallest group); the cluster by the rule `plane_plan`
    states: 4 vectors a thread and the fewest blocks (a power of two, 2 to
    8) that hold the plane so; every other plane takes the multi-pass
    kernel."""
    built = _gate_built()
    reached = set()
    for dtype in DTYPES:
        per_vector = 16 // dtype.itemsize
        block_reach = 256 * 4 * per_vector
        for hw in range(1, 2 * 8 * block_reach + 2):
            nvec, ragged = divmod(hw, per_vector)
            offsets = ((0, 2, 4, 6, 8, 10, 12, 14, 16, 48)
                       if hw <= 2 * block_reach else (0, 2, 16))
            for offset in offsets:
                plan = kernels.gate_plan(hw, dtype, 4096 + offset)
                assert plan in built, (hw, dtype, offset, plan)
                reached.add(plan)
                variant, lanes, vectors = plan
                if ragged or offset % 16:
                    assert variant == 'multi_pass', (hw, dtype, offset)
                    continue
                room = lanes * vectors
                if nvec <= 32 * 8:
                    assert variant == 'lane_group', (hw, dtype, plan)
                elif nvec <= 256 * 4:
                    assert variant == 'block', (hw, dtype, plan)
                elif nvec <= 8 * 256 * 4:
                    blocks = 1 << (-(-nvec // (256 * 4)) - 1).bit_length()
                    assert plan == ('cluster', blocks * 256, 4), (hw, dtype,
                                                                  plan)
                    assert 2 <= blocks <= 8, (hw, dtype, plan)
                else:
                    assert variant == 'multi_pass', (hw, dtype, plan)
                    continue
                assert nvec <= room, (hw, dtype, plan)
                assert 2 * nvec > room or room == 4, (hw, dtype, plan)
    assert reached == built


@pytest.mark.parametrize('dtype', DTYPES)
def test_gate_plan_puts_mru_planes_in_registers(dtype):
    """At every batch, MRU units 2 to 4 take lane groups and unit 1's
    4096-element planes the block variant; K1/K2's plan sends those to
    its own block variant, in the same shape."""
    want = {torch.float32: [('block', 256, 4), ('lane_group', 32, 8),
                            ('lane_group', 32, 2), ('lane_group', 16, 1)],
            torch.bfloat16: [('block', 256, 2), ('lane_group', 32, 4),
                             ('lane_group', 32, 1), ('lane_group', 8, 1)]}
    for batch in (4, 64):
        for (c, h, w), plan in zip(GATE_SHAPES, want[dtype]):
            x = torch.empty(batch, c, h, w, dtype=dtype)
            assert kernels.gate_plan(h * w, dtype, x.data_ptr()) == plan
    assert kernels.instance_norm_plan(4096, dtype, 0) == want[dtype][0]


@pytest.fixture(scope='module')
def pair():
    pytest.importorskip('jax')
    from test_torch_critics import Pair
    return Pair(seed=3)


def test_classifier_with_switches_matches_jax(pair, monkeypatch):
    """The classifier with both switches on (its Functions run their plain
    versions on the CPU) against the JAX classifier's default path: the
    outputs within 3e-4 (test_torch_critics.py::test_classifier_matches_
    jax) and the focal loss's gradients with respect to every classifier
    weight within 1e-3 relative (::test_classifier_loss_gradient_matches_
    jax), and with respect to the input within 1e-3 relative in norm. The
    input gradient's largest entry differs by 1.3e-3 of the largest,
    switches on or off: one input of unit 2's h_conv1 PReLU lies 1.6e-8
    from the kink, where float32 rounding picks the slope (the port's
    float64 classifier agrees with JAX to 1e-6). So each entry is held
    instead to the port's own default path, within 1e-6. A spy sees every
    PReLU backward go to K5 (14) and every MRU gate to K3 and K4 (4
    each)."""
    import jax
    import jax.numpy as jnp
    from edgegan_tpu import losses as JL
    from test_torch_critics import _assert_grads_close, _nchw
    x = np.random.RandomState(6).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    labels = np.array([1, 2])
    lab = torch.from_numpy(labels)

    def port_loss():
        xt = _nchw(x).requires_grad_(True)
        out = pair.nets.classify(xt)
        return xt, out, L.get_acgan_loss_focal(out[2], lab, out[2], lab,
                                               3)[1]

    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    xt, _, tv = port_loss()
    default_dx, = torch.autograd.grad(tv, xt)
    for name in SWITCHES:
        monkeypatch.setenv(name, '1')
    calls = []
    for name in ('prelu_bwd', 'mru_gate_blend', 'mru_gate_bwd'):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))

    def jloss(c_params, xin):
        p = {**pair.params, 'D2': c_params}
        disc, prob, logits = pair.jnets.classify(p, pair.aux, xin)
        loss = JL.get_acgan_loss_focal(logits, jnp.asarray(labels), logits,
                                       jnp.asarray(labels), 3)[1]
        return loss, (disc, prob, logits)

    (jv, jout), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(pair.params['D2'],
                                              jnp.asarray(x))
    xt, (disc, prob, logits), tv = port_loss()
    assert calls == ['mru_gate_blend'] * 4
    np.testing.assert_allclose(_nhwc(disc.detach()), np.asarray(jout[0]),
                               atol=3e-4)
    for got, ref in zip((prob, logits), jout[1:]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   atol=3e-4)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    named = list(pair.nets.D2.named_parameters())
    tgrads = torch.autograd.grad(tv, [p for _, p in named] + [xt],
                                 allow_unused=True)
    assert sorted(calls) == sorted(['mru_gate_blend'] * 4
                                   + ['mru_gate_bwd'] * 4
                                   + ['prelu_bwd'] * 14)
    from edgegan_torch import bridge
    paths = bridge.param_paths(pair.nets)
    port = {}
    for (n, p), gr in zip(named, tgrads[:-1]):
        path, kind = paths[f'D2.{n}']
        gr = torch.zeros_like(p) if gr is None else gr
        port[path[1:]] = bridge.to_jax_layout(gr, kind, path[-1])
    _assert_grads_close(jgrads, port, 1e-3)
    jdx, dx = np.asarray(jdx), _nhwc(tgrads[-1])
    assert np.linalg.norm(dx - jdx) <= 1e-3 * np.linalg.norm(jdx)
    torch.testing.assert_close(tgrads[-1], default_dx, atol=1e-6 * float(
        default_dx.abs().max()), rtol=0)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('leak', LEAKS)
def test_prelu_kernel_matches_plain_on_card(cuda, dtype, leak):
    """dx within K1's limits, dleak within 1e-5 of the sum of |terms|
    from a float64 sum, the same dleak on a second run, one launch each;
    an odd size and an offset view take the scalar path."""
    x = _nchw_t(_prelu_x((4, 16, 16, 64))).to(cuda, dtype)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    g = g.to(cuda, dtype)
    lk = torch.tensor(leak, device=cuda)
    tol = (dict(atol=2e-5, rtol=0) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    for xs, gs in ((x, g), (x[:, :, :, 1:].contiguous(),
                            g[:, :, :, 1:].contiguous()),
                   (x.flatten()[1:].view(1, 1, 1, -1),
                    g.flatten()[1:].view(1, 1, 1, -1))):
        before = kernels.LAUNCHES['prelu_bwd']
        dx, dleak = kernels.prelu_bwd(xs, gs, lk)
        dleak2 = kernels.prelu_bwd(xs, gs, lk)[1]
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['prelu_bwd'] == before + 2
        ref, _ = kernels.prelu_bwd_plain(xs, gs, lk)
        torch.testing.assert_close(dx.float(), ref.float(), **tol)
        x64, g64 = xs.double(), gs.double()
        u = lk.double() * x64
        terms = g64 * torch.where(u > x64, 1.0, torch.where(
            u == x64, 0.5, 0.0)).double() * x64
        assert abs(dleak.item() - terms.sum().item()) <= \
            1e-5 * terms.abs().sum().item()
        assert torch.equal(dleak, dleak2)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(2, 8, 64, 64), (4, 64, 8, 8),
                                   (2, 3, 5, 7)])
def test_gate_kernels_match_plain_on_card(cuda, dtype, shape):
    """K3 and K4 against their plain versions, a flat plane and a tie
    included, one launch each; float32 within 1e-5 (K3 rounds as its
    plain version does), bfloat16 within one rounding."""
    rng = np.random.RandomState(7)
    rg, ht, img, g = (torch.from_numpy(rng.randn(*shape).astype(
        np.float32)).to(cuda, dtype) for _ in range(4))
    rg[0, 0] = 1.5
    rg[1, 1, 0, 0] = rg[1, 1].max()
    rg[1, 1, -1, -1] = rg[1, 1].max()
    before = dict(kernels.LAUNCHES)
    out = kernels.mru_gate_blend(rg, ht, img)
    drg, dimg = kernels.mru_gate_bwd(rg, img, g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['mru_gate_blend'] == before['mru_gate_blend'] + 1
    assert kernels.LAUNCHES['mru_gate_bwd'] == before['mru_gate_bwd'] + 1
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    torch.testing.assert_close(out.float(), kernels.mru_gate_blend_plain(
        rg, ht, img).float(), **tol)
    for got, ref in zip((drg, dimg), kernels.mru_gate_bwd_plain(rg, img, g)):
        torch.testing.assert_close(got.float(), ref.float(), **tol)


GATE_TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# K4 sums over the plane; bfloat16 rounds drg and dimg to 8 bits
GATE_BWD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
                torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# where the gate plan sends each plane size of gate_checks.GATE_PLANES
GATE_VARIANT = {(1, 1): 'multi_pass', (3, 3): 'multi_pass',
                (7, 9): 'multi_pass', (8, 8): 'lane_group',
                (16, 16): 'lane_group', (32, 32): 'lane_group',
                (24, 64): 'block', (64, 64): 'block',
                (128, 128): 'cluster', (128, 256): 'cluster',
                (256, 256): 'multi_pass'}


def _planned_variant(hw, dtype, ins):
    """The variant the gate plan picks for `ins`, checked against
    GATE_VARIANT (where bfloat16 differs: 1536 elements in a lane group,
    65536 in a cluster)."""
    addr = 0
    for t in ins:
        addr |= t.data_ptr()
    variant = kernels.gate_plan(hw[0] * hw[1], dtype, addr)[0]
    want = GATE_VARIANT[hw]
    if dtype == torch.bfloat16 and hw == (24, 64):
        want = 'lane_group'   # 192 vectors: 32 lanes x 8
    if dtype == torch.bfloat16 and hw == (256, 256):
        want = 'cluster'      # 8192 vectors: 8 blocks x 256 x 4
    assert variant == want
    return variant


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('hw', gate_checks.GATE_PLANES,
                         ids=lambda hw: f'{hw[0]}x{hw[1]}')
def test_gate_variants_match_plain_on_card(cuda, dtype, hw):
    """Each variant, where the gate plan sends this plane size (ragged,
    MRU units 4 to 1, the hires unit 1, between and beyond): K3 and K4
    against their plain versions on 37 planes, one flat and one tied at
    both extrema, with the per-variant launch counts and two runs bitwise
    equal."""
    ins = gate_checks.gate_inputs(cuda, (1, 37) + hw, dtype)
    variant = _planned_variant(hw, dtype, ins)
    gate_checks.check_gate(*ins, GATE_TOL[dtype], GATE_BWD_TOL[dtype],
                           variant)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('hw', gate_checks.GATE_PLANES,
                         ids=lambda hw: f'{hw[0]}x{hw[1]}')
def test_gate_variants_on_nonfinite_planes_on_card(cuda, dtype, hw):
    """Each variant on planes holding +inf, NaN and -inf: K3 and K4 give
    NaN where their plain versions do (the min and max of a NaN plane are
    NaN, as jnp.min's), the same infs, and agree within the limits
    elsewhere; two runs bitwise equal."""
    ins = gate_checks.gate_inputs(cuda, (1, 37) + hw, dtype)
    variant = _planned_variant(hw, dtype, ins)
    gate_checks.check_gate_nonfinite(*ins, GATE_TOL[dtype],
                                     GATE_BWD_TOL[dtype], variant)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_gate_misaligned_input_takes_multi_pass_on_card(cuda, dtype):
    """Contiguous views at a storage offset of one element start off a
    16-byte boundary: K3 and K4 take the multi-pass kernel and give what
    the lane-group kernels give on the same values, within the limits. A
    misaligned g alone sends K4 there too."""
    ins = gate_checks.gate_inputs(cuda, (1, 37, 8, 8), dtype)
    shifted = [in_checks.shifted(t) for t in ins]
    tols = GATE_TOL[dtype], GATE_BWD_TOL[dtype]
    gate_checks.check_gate(*shifted, *tols, 'multi_pass')
    gate_checks.check_gate(*ins[:3], shifted[3], *tols, 'lane_group',
                           bwd_variant='multi_pass')
    torch.testing.assert_close(
        kernels.mru_gate_blend(*shifted[:3]).float(),
        kernels.mru_gate_blend(*ins[:3]).float(), **tols[0])
    for a, b in zip(kernels.mru_gate_bwd(shifted[0], shifted[2], shifted[3]),
                    kernels.mru_gate_bwd(ins[0], ins[2], ins[3])):
        torch.testing.assert_close(a.float(), b.float(), **tols[1])


@pytest.mark.cuda
def test_gate_library_refuses_impossible_variant_on_card(cuda):
    """The C entry points launch a variant only where it is built and
    holds the plane: 16 lanes x 1 vector hold a 64-element float32 plane,
    and so does a block of 2 vectors, and a cluster of 2 blocks x 4; 4 x
    1 do not, 12 lanes and a block of 128 lanes are not built, a base off
    16 bytes is refused (cudaErrorInvalidValue, 1), as are multi-pass
    with vectors, a variant 3, which is not built, a cluster of 3 blocks
    and one of 16, and a plane beyond the named cluster (16384 float32
    elements to 2 blocks x 4 vectors)."""
    from edgegan_torch.ops._build import library
    lib = library()
    rg, ht, img, g = gate_checks.gate_inputs(cuda, (1, 4, 8, 8),
                                             torch.float32)
    out = torch.empty_like(rg)
    s = torch.cuda.current_stream().cuda_stream

    def fwd(rg_ptr, variant, lanes, vectors):
        out.zero_()
        return lib.edgegan_mru_gate_fwd(rg_ptr, ht.data_ptr(),
                                        img.data_ptr(), out.data_ptr(), 4,
                                        64, 0, variant, lanes, vectors, s)

    ref = kernels.mru_gate_blend_plain(rg, ht, img)
    for variant, lanes, vectors in ((1, 16, 1), (2, 256, 2), (4, 512, 4)):
        assert fwd(rg.data_ptr(), variant, lanes, vectors) == 0
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, **GATE_TOL[torch.float32])
    assert fwd(rg.data_ptr(), 1, 4, 1) == 1
    assert fwd(rg.data_ptr(), 1, 12, 1) == 1
    assert fwd(rg.data_ptr(), 2, 128, 2) == 1
    assert fwd(rg.data_ptr() + 4, 1, 16, 1) == 1
    assert fwd(rg.data_ptr(), 0, 256, 1) == 1
    assert fwd(rg.data_ptr(), 3, 256, 2) == 1
    assert fwd(rg.data_ptr(), 4, 768, 4) == 1
    assert fwd(rg.data_ptr(), 4, 4096, 4) == 1
    big = gate_checks.gate_inputs(cuda, (1, 2, 128, 128), torch.float32)
    big_out = torch.empty_like(big[0])
    assert lib.edgegan_mru_gate_fwd(
        big[0].data_ptr(), big[1].data_ptr(), big[2].data_ptr(),
        big_out.data_ptr(), 2, 128 * 128, 0, 4, 512, 4, s) == 1
    # a lane group holds a plane smaller than its room, too
    drg, dimg = torch.empty_like(rg), torch.empty_like(rg)
    assert lib.edgegan_mru_gate_bwd(
        rg.data_ptr(), img.data_ptr(), g.data_ptr(), drg.data_ptr(),
        dimg.data_ptr(), 4, 64, 0, 1, 32, 8, s) == 0
    torch.cuda.synchronize()
    for got, want in zip((drg, dimg), kernels.mru_gate_bwd_plain(rg, img, g)):
        torch.testing.assert_close(got, want, **GATE_BWD_TOL[torch.float32])


@pytest.mark.cuda
def test_functions_on_card(cuda):
    """The Functions' gradients (K5; K3 and K4) against autograd of the
    plain chains, on the card in float32."""
    x = _nchw_t(_prelu_x((2, 8, 8, 32))).to(cuda).requires_grad_(True)
    lk = torch.tensor(0.2, device=cuda, requires_grad=True)
    g = torch.randn(x.shape, device=cuda)
    got = torch.autograd.grad(kernels.prelu(x, lk), (x, lk), g)
    ref = torch.autograd.grad(torch.maximum(lk * x, x), (x, lk), g)
    torch.testing.assert_close(got[0], ref[0], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(got[1], ref[1], atol=1e-3, rtol=1e-4)
    ins = [_nchw_t(a).to(cuda).requires_grad_(True)
           for a in _gate_inputs((2, 8, 8, 16))[:3]]
    g = torch.randn(ins[0].shape, device=cuda)
    got = torch.autograd.grad(kernels.mru_gate(*ins), ins, g)
    ref = torch.autograd.grad(kernels.mru_gate_blend_plain(*ins), ins, g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_classifier_kernels_refuse_on_card(cuda):
    """On the card the wrappers launch or raise: strided, float16 or
    mismatched inputs, and a leak that is not one float32 element."""
    x = torch.randn(2, 3, 4, 4, device=cuda)
    lk = torch.tensor(0.2, device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        kernels.prelu_bwd(x.transpose(2, 3), x, lk)
    with pytest.raises(ValueError, match='dtype'):
        kernels.prelu_bwd(x.half(), x.half(), lk)
    with pytest.raises(ValueError, match='leak'):
        kernels.prelu_bwd(x, x, lk.double())
    with pytest.raises(ValueError, match='does not match'):
        kernels.mru_gate_blend(x, x[:1].contiguous(), x)
    with pytest.raises(ValueError, match='does not match'):
        kernels.mru_gate_bwd(x, x, x.bfloat16())
