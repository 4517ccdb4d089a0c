"""K3/K4 (`mru_gate_blend`, `mru_gate_bwd`) on gate planes that hold NaN,
+inf or -inf, against the Pallas kernel in interpret mode and `jax.vjp`
of it, and the plans' split between K1/K2's variants and K3/K4's thread-
block clusters. The clusters themselves run only on the card
(tests/test_torch_classifier_kernels.py, `chip_smoke.py`).
"""
import numpy as np
import pytest
import torch

from edgegan_torch.ops import kernels
from test_torch_variants import few_threads  # noqa: F401

# NHWC (batch, H, W, channels) of the inputs; plane (0, 0) is the one made
# nonfinite, plane (1, 1) is flat, the others are clean
SHAPE = (2, 8, 8, 3)


def _nchw_t(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _assert_same(mine, ref, what):
    """NaN at the same elements, the same infs, and the rest within
    1e-5."""
    mine, ref = np.asarray(mine), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(mine), np.isnan(ref),
                                  err_msg=f'{what}: NaN positions')
    keep = ~np.isnan(ref)
    np.testing.assert_allclose(mine[keep], ref[keep], atol=1e-5, rtol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize('value', [float('nan'), float('inf'),
                                   float('-inf')],
                         ids=['nan', '+inf', '-inf'])
def test_gate_matches_pallas_on_nonfinite_planes(value):
    """`mru_gate_blend_plain`, `mru_gate_bwd_plain` and the Function on
    the CPU against `pallas_kernels.mru_gate_blend` in interpret mode and
    `jax.vjp` of it, with one element of plane (0, 0) NaN, +inf or -inf
    beside a flat plane and clean ones: NaN at the same elements, and the
    rest within 1e-5 (test_pallas.py:91). XLA adds the tie shares by
    selection, so JAX's drg has NaN on 0 elements of the NaN plane and 2
    of an inf plane (its minimum and its maximum); a share multiplied by a
    0/1 mask would put NaN on the whole plane."""
    jax = pytest.importorskip('jax')
    jnp = jax.numpy
    from edgegan_tpu.ops import pallas_kernels as pk
    rng = np.random.RandomState(0)
    rg, ht, img, g = (rng.randn(*SHAPE).astype(np.float32) for _ in range(4))
    rg[0, 3, 5, 0] = value
    rg[1, :, :, 1] = 0.75
    out, vjp = jax.vjp(lambda a, b, c: pk.mru_gate_blend(a, b, c, True),
                       *(jnp.asarray(t) for t in (rg, ht, img)))
    jdrg, jdht, jdimg = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    assert np.isnan(np.asarray(out)[0, :, :, 0]).any()
    assert np.isnan(jdrg[0, :, :, 0]).sum() == (0 if np.isnan(value) else 2)
    assert np.isfinite(np.delete(jdrg, 0, axis=3)).all()

    t = [_nchw_t(a) for a in (rg, ht, img, g)]
    _assert_same(_nhwc(kernels.mru_gate_blend_plain(*t[:3])), out, 'K3')
    drg, dimg = kernels.mru_gate_bwd_plain(t[0], t[2], t[3])
    _assert_same(_nhwc(drg), jdrg, 'K4 drg')
    _assert_same(_nhwc(dimg), jdimg, 'K4 dimg')

    ins = [a.clone().requires_grad_(True) for a in t[:3]]
    y = kernels.mru_gate(*ins)
    _assert_same(_nhwc(y.detach()), out, 'Function forward')
    for mine, ref, what in zip(torch.autograd.grad(y, ins, t[3]),
                               (jdrg, jdht, jdimg), ('drg', 'dht', 'dimg')):
        _assert_same(_nhwc(mine), ref, f'Function {what}')


def test_instance_norm_plan_never_clusters():
    """K1/K2's plan never names the cluster variant, which only K3/K4
    build: aligned planes beyond a block take the multi-pass kernel at
    every size up to twice a cluster's reach, where K3/K4's plan takes a
    cluster."""
    for dtype in (torch.float32, torch.bfloat16):
        per_vector = 16 // dtype.itemsize
        block = kernels.IN_THREADS * kernels.BLOCK_VECTORS * per_vector
        reach = kernels.CLUSTER_BLOCKS * block
        for hw in range(1, 2 * reach + 1, 7):
            for addr in (0, 2, 16):
                assert kernels.instance_norm_plan(hw, dtype, addr)[0] != \
                    'cluster', (hw, dtype, addr)
        for hw in (block + per_vector, 16384, reach):
            assert kernels.instance_norm_plan(hw, dtype, 0)[0] == \
                'multi_pass'
            assert kernels.gate_plan(hw, dtype, 0)[0] == 'cluster'
