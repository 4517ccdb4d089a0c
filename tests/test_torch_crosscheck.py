"""Cross-validate conv/deconv semantics against torch (CPU) — an
implementation independent of both TF and our JAX code.

tf.nn.conv2d_transpose(SAME, stride 2, k 5) with filter [k,k,out,in]
equals torch.nn.functional.conv_transpose2d with padding=2,
output_padding=1 (for even input sizes) and weight [in,out,k,k]
(torch's transposed-conv weight layout, spatially unflipped — both
frameworks define transposed conv as the adjoint of correlation).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from edgegan_tpu.ops import conv2d, deconv2d  # noqa: E402
from test_torch_variants import few_threads  # noqa: F401,E402


def test_conv2d_same_matches_torch():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    w = rng.randn(4, 4, 3, 16).astype(np.float32)  # HWIO
    ours = np.asarray(conv2d(jnp.asarray(x), jnp.asarray(w), stride=2))
    # torch: NCHW, OIHW weights; SAME pad for k=4,s=2,in=8: pad_total=2
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1))
    xt = torch.nn.functional.pad(xt, (1, 1, 1, 1))
    got = torch.nn.functional.conv2d(xt, wt, stride=2)
    theirs = got.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ours, theirs, atol=1e-4)


def test_deconv2d_matches_torch_conv_transpose():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 4, 6).astype(np.float32)
    w = rng.randn(5, 5, 10, 6).astype(np.float32)  # [k,k,out,in] TF layout
    ours = np.asarray(deconv2d(jnp.asarray(x), jnp.asarray(w), (8, 8),
                               stride=2))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    # torch conv_transpose2d weight: [in, out, k, k]
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1))
    # TF SAME for the forward conv (in 8, k 5, s 2) pads (lo 1, hi 2) —
    # asymmetric. Build the full (uncropped) transposed output in torch
    # and crop [lo : lo+8] to match TF's gradient placement.
    full = torch.nn.functional.conv_transpose2d(xt, wt, stride=2)  # 11x11
    got = full[:, :, 1:9, 1:9]
    theirs = got.numpy().transpose(0, 2, 3, 1)
    assert theirs.shape == ours.shape == (2, 8, 8, 10)
    np.testing.assert_allclose(ours, theirs, atol=1e-4)


# ---------------------------------------------------------------------------
# Full-network cross-checks: rebuild G/D/E forward passes in torch from
# the SAME weights and match outputs. Catches architecture drift
# (block order, padding placement, norm semantics, flatten order) that
# per-op tests can't see. Reference architectures: generator.py:35-74,
# discriminator.py:58-81, encoder.py:21-84.
# ---------------------------------------------------------------------------
import torch.nn.functional as F  # noqa: E402


def _nchw(x_nhwc):
    return torch.from_numpy(np.array(x_nhwc)).permute(0, 3, 1, 2)


def _t(x):
    """numpy -> torch with a defensive copy (jax buffers are read-only)."""
    return torch.from_numpy(np.array(x, np.float32))


def _nhwc(x_nchw):
    return x_nchw.permute(0, 2, 3, 1)


def t_conv_same(x, w_hwio, stride, bias=None):
    """tf.nn.conv2d SAME via explicit (possibly asymmetric) padding."""
    w = _t(w_hwio).permute(3, 2, 0, 1)
    k = w.shape[-1]
    pads = []
    for in_size in (x.shape[3], x.shape[2]):  # F.pad order: W then H
        out = -(-in_size // stride)
        total = max((out - 1) * stride + k - in_size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads)
    return F.conv2d(x, w, bias=bias, stride=stride)


def t_conv_reflect(x, w_hwio, bias=None):
    """k x k stride-1 REFLECT conv (reference conv.py:23-26)."""
    w = _t(w_hwio).permute(3, 2, 0, 1)
    p = (w.shape[-1] - 1) // 2
    if p:
        x = F.pad(x, (p, p, p, p), mode='reflect')
    return F.conv2d(x, w, bias=bias, stride=1)


def t_deconv(x, w_kkoi, out_hw, stride):
    """tf.nn.conv2d_transpose SAME: full transposed conv, then crop by
    the forward conv's pad_lo."""
    w = _t(w_kkoi).permute(3, 2, 0, 1)  # in,out,k,k
    k = w.shape[-1]
    full = F.conv_transpose2d(x, w, stride=stride)
    crops = []
    for o in out_hw:
        i = -(-o // stride)
        total = max((i - 1) * stride + k - o, 0)
        crops.append(total // 2)
    return full[:, :, crops[0]:crops[0] + out_hw[0],
                crops[1]:crops[1] + out_hw[1]]


def t_inorm(x, eps=1e-5):
    """(x-mean)/(sqrt(var)+eps), biased var over H,W — eps OUTSIDE (Q1)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) / (torch.sqrt(var) + eps)


def t_bnorm(x, gamma, beta, eps=1e-5):
    """train-mode batch norm over (N,H,W), biased var, eps inside."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, unbiased=False)
    g = _t(gamma).view(1, -1, 1, 1)
    b = _t(beta).view(1, -1, 1, 1)
    return (x - mean) / torch.sqrt(var + eps) * g + b


def t_lrelu(x):
    return torch.maximum(x, 0.2 * x)


def test_full_generator_matches_torch():
    import jax
    from edgegan_tpu.models import Generator
    gen = Generator(output_height=64, output_width=64)  # full-size branch
    z = np.random.RandomState(0).randn(2, 114).astype(np.float32)
    variables = gen.init(jax.random.PRNGKey(0), jnp.asarray(z))
    ours = np.asarray(gen.apply(variables, jnp.asarray(z)))
    p = jax.tree.map(np.asarray, variables['params'])

    x = torch.from_numpy(z @ p['g_lin_0']['Matrix'] + p['g_lin_0']['bias'])
    x = _nchw(x.reshape(2, 4, 4, 512).numpy())  # NHWC reshape, then NCHW
    x = t_bnorm(x, p['g_norm_0_gamma'], p['g_norm_0_beta'])
    x = torch.relu(x)
    for i, hw in zip(range(1, 5), [(8, 8), (16, 16), (32, 32), (64, 64)]):
        blk = p[f'g_dconv_{i}']['deconv2d']
        x = t_deconv(x, blk['w'], hw, 2)
        x = x + _t(blk['b']).view(1, -1, 1, 1)
        if i < 4:
            x = torch.relu(t_inorm(x))
    theirs = _nhwc(torch.tanh(x)).numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-4)


def test_full_discriminator_matches_torch():
    import jax
    from edgegan_tpu.models import Discriminator
    dis = Discriminator()
    img = np.random.RandomState(1).randn(2, 64, 128, 3).astype(
        np.float32).clip(-1, 1)
    variables = dis.init(jax.random.PRNGKey(1), jnp.asarray(img))
    _, ours_logits = dis.apply(variables, jnp.asarray(img))
    p = jax.tree.map(np.asarray, variables['params'])

    x = _nchw(img)
    for name, use_norm in [('d_conv_0', False), ('d_conv_1', True),
                           ('d_conv_3', True), ('d_conv_4', True)]:
        x = t_conv_same(x, p[name]['conv2d']['w'], 2)
        if use_norm:
            x = t_inorm(x)
        x = t_lrelu(x)
    flat = _nhwc(x).reshape(2, -1).numpy()  # NHWC flatten order
    theirs = flat @ p['d_linear_5']['Matrix'] + p['d_linear_5']['bias']
    np.testing.assert_allclose(np.asarray(ours_logits), theirs, atol=2e-4)


def test_full_encoder_matches_torch():
    import jax
    from edgegan_tpu.models import Encoder
    enc = Encoder(latent_dim=100, image_size=64)
    img = np.random.RandomState(2).randn(2, 64, 64, 3).astype(
        np.float32).clip(-1, 1)
    variables = enc.init({'params': jax.random.PRNGKey(2),
                          'noise': jax.random.PRNGKey(3)}, jnp.asarray(img))
    _, ours_mu, ours_ls = enc.apply(variables, jnp.asarray(img),
                                    rngs={'noise': jax.random.PRNGKey(4)})
    p = jax.tree.map(np.asarray, variables['params'])

    stem = p['e_resnet_64_0']['conv2d']
    x = t_conv_same(_nchw(img), stem['w'], 2,
                    bias=_t(stem['b']))
    x = torch.relu(x)
    for i, n in enumerate([128, 256, 512, 512]):
        blk = p[f'e_resnet_{n}_{i + 1}']
        h = t_conv_reflect(x, blk['res1']['w'],
                           bias=_t(blk['res1']['b']))
        h = torch.relu(t_inorm(h))
        h = t_conv_reflect(h, blk['res2']['w'],
                           bias=_t(blk['res2']['b']))
        h = t_inorm(h)
        sc = t_conv_reflect(x, blk['shortcut']['w'],
                            bias=_t(blk['shortcut']['b']))
        x = torch.relu(sc + h)
        x = F.avg_pool2d(x, 2, 2)  # even sizes: TF-SAME == plain 2x2
    x = torch.relu(x)
    x = x.mean(dim=(2, 3), keepdim=True)  # 8x8 SAME pool on 2x2, counts
    #                                       exclude padding -> plain mean
    flat = _nhwc(x).reshape(2, -1).numpy()
    mu = flat @ p['FC8_mu']['w'] + p['FC8_mu']['b']
    ls = flat @ p['FC8_sigma']['w'] + p['FC8_sigma']['b']
    np.testing.assert_allclose(np.asarray(ours_mu), mu, atol=2e-4)
    np.testing.assert_allclose(np.asarray(ours_ls), ls, atol=2e-4)


def _sn_weight(w_hwio, u):
    """spectral_normed_weight in numpy (reference normalization.py:38-70):
    one power iteration from the stored u, W reshaped to [-1, out]."""
    w = np.asarray(w_hwio, np.float32)
    u = np.asarray(u, np.float32)
    w_mat = w.reshape(-1, w.shape[-1])

    def l2n(v):
        return v / (np.sum(v * v) ** 0.5 + 1e-12)

    v = l2n(u @ w_mat.T)
    u2 = l2n(v @ w_mat)
    sigma = (v @ w_mat @ u2.T)[0, 0]
    return w / sigma


def t_prelu(x, leak):
    leak = float(np.asarray(leak))
    return torch.maximum(leak * x, x)


def test_full_classifier_matches_torch():
    """MRU classifier forward rebuilt in torch — in the reference's NCHW
    layout — from the same weights (reference classifier.py:12-115,
    conv.py:133-243). Also proves the NHWC re-layout is math-identical
    to the reference's NCHW."""
    import jax
    from edgegan_tpu.models import Classifier
    cls = Classifier(num_classes=14)
    img = np.random.RandomState(3).randn(2, 64, 64, 3).astype(
        np.float32).clip(-1, 1)
    variables = cls.init(jax.random.PRNGKey(3), jnp.asarray(img))
    _, ours_sig, ours_logits = cls.apply(variables, jnp.asarray(img))
    p = jax.tree.map(np.asarray, variables['params'])
    us = jax.tree.map(np.asarray, variables['spectral'])

    def snconv(x, params, u, stride=1, bias=True):
        w = _sn_weight(params['weights'], u['u'])
        b = _t(params['biases']) if bias else None
        return t_conv_same(x, w, stride, bias=b)

    # 6-level mean-pool pyramid (x_list[-1] = full res)
    x = _nchw(img)
    x_list = [x]
    for _ in range(5):
        x_list.append(F.avg_pool2d(x_list[-1], 2, 2))
    x_list = x_list[::-1]

    ht = snconv(x_list[-1], p['h0'], us['h0'])
    ht = t_prelu(ht, p['h0']['prelu']['param'])
    for unit, depth in enumerate([128, 256, 512, 768], start=1):
        bp = p[f'mru_conv_unit_{unit}']
        bu = us[f'mru_conv_unit_{unit}']
        inp = x_list[-unit]
        full_inp = torch.cat(
            [t_prelu(ht, bp['norm_activation_in_prelu']['param']), inp],
            dim=1)
        rg = snconv(full_inp, bp['update_gate'], bu['update_gate'])
        rg = t_lrelu(rg)
        rg_min = rg.amin(dim=(2, 3), keepdim=True)
        rg_max = rg.amax(dim=(2, 3), keepdim=True)
        rg = (rg - rg_min) / (rg_max - rg_min)
        img_new = snconv(inp, bp['img_conv'], bu['img_conv'])
        ht_plus = ht + rg * img_new
        h = t_prelu(ht_plus, bp['norm_activation_merge_1_prelu']['param'])
        h = snconv(h, bp['h_conv1'], bu['h_conv1'])
        h = t_prelu(h, bp['h_conv1']['prelu']['param'])
        h = snconv(h, bp['h_conv2'], bu['h_conv2'])
        sc = snconv(ht, bp['shortcut'], bu['shortcut'])
        ht = F.avg_pool2d(sc + h, 2, 2)  # stride 2 = trailing mean-pool
    ht = t_prelu(ht, p['mru_conv_unit_last_prelu']['param'])

    feat = ht.mean(dim=(2, 3)).numpy()
    w_fc = _sn_weight(p['class_head']['weights'], us['class_head']['u'])
    logits = feat @ w_fc + p['class_head']['biases']
    np.testing.assert_allclose(np.asarray(ours_logits), logits, atol=3e-4)
    np.testing.assert_allclose(np.asarray(ours_sig),
                               1.0 / (1.0 + np.exp(-logits)), atol=1e-5)


def test_deconv2d_stride1_1x1_matches_torch():
    # the deresidual2 shortcut case: k=1, s=1 SAME
    rng = np.random.RandomState(2)
    x = rng.randn(1, 6, 6, 4).astype(np.float32)
    w = rng.randn(1, 1, 8, 4).astype(np.float32)
    ours = np.asarray(deconv2d(jnp.asarray(x), jnp.asarray(w), (6, 6),
                               stride=1))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1))
    got = torch.nn.functional.conv_transpose2d(xt, wt, stride=1, padding=0)
    theirs = got.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
