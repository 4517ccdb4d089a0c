"""TF-checkpoint importer: a TF-named npz -> the JAX-layout (params,
aux) trees that `bridge.load_jax_params` takes (the JAX package's
convert.py:1-351, in numpy: the port imports nothing of the JAX package).

The released EdgeGAN checkpoint is a TF1 Saver checkpoint (reference
README.md:69-75). The importer reads an `.npz` of {tf_variable_name:
array}, which `npz_from_tf_hint` makes where TensorFlow is installed.
The name mapping follows the reference's variable scopes (cited per
rule). Layouts transfer 1:1 into the JAX layouts: TF conv kernels are
HWIO, TF deconv kernels [k, k, out, in], dense matrices [in, out]; the
only reshape is conv2d2's (1, C, 1, 1) NCHW bias -> (C,). The bridge then
permutes them into the port's modules.

Spectral-norm `u` vectors are imported: the reference never updates them
(quirk Q3), so output parity needs the checkpoint's values.

    params, aux = import_tf_npz('edgegan_tf.npz', Config().derive('train'))
    nets = bridge.load_jax_params(Networks(config, critics=True), params,
                                  aux)
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .bridge import _get, _set, random_jax_params

npz_from_tf_hint = """
# Run where TF 1.x is available:
import numpy as np, tensorflow as tf
reader = tf.train.load_checkpoint('outputs/edgegan/checkpoints')
names = [n for n, _ in tf.train.list_variables('outputs/edgegan/checkpoints')
         if 'RMSProp' not in n]
np.savez('edgegan_tf.npz', **{n: reader.get_tensor(n) for n in names})
"""


def _gen_rules(scope: str):
    """Generator scope (reference generator.py:35-74, conv.py:39-58,
    linear.py:10-31, normalization.py:19-25)."""
    return [
        # linear projection
        ((scope, 'g_lin_0', 'Matrix'), f'{scope}/g_lin_0/Matrix', None),
        ((scope, 'g_lin_0', 'bias'), f'{scope}/g_lin_0/bias', None),
        # first-norm batch norm (the nn.norm(h0, norm) quirk). nn.norm
        # opens 'batch_norm' (normalization.py:20) and contrib's
        # batch_norm opens its own 'BatchNorm' sub-scope, so TF dumps
        # contain '<G>/batch_norm/BatchNorm/<var>'.
        ((scope, 'g_norm_0_gamma'),
         f'{scope}/batch_norm/BatchNorm/gamma', None),
        ((scope, 'g_norm_0_beta'),
         f'{scope}/batch_norm/BatchNorm/beta', None),
    ] + [
        ((scope, f'g_dconv_{i}', 'deconv2d', ours),
         f'{scope}/g_dconv_{i}/deconv2d/{theirs}', None)
        for i in range(1, 5) for ours, theirs in [('w', 'w'), ('b', 'b')]
    ]


def _gen_stats_rules(scope: str):
    return [
        ((scope, 'g_norm_0_mean'),
         f'{scope}/batch_norm/BatchNorm/moving_mean', None),
        ((scope, 'g_norm_0_var'),
         f'{scope}/batch_norm/BatchNorm/moving_variance', None),
    ]


def _dis_rules(scope: str):
    """Discriminator convnet scope (reference discriminator.py:58-81)."""
    rules = []
    for block in ['d_conv_0', 'd_conv_1', 'd_conv_3', 'd_conv_4']:
        rules.append(((scope, block, 'conv2d', 'w'),
                      f'{scope}/{block}/conv2d/w', None))
    rules += [
        ((scope, 'd_linear_5', 'Matrix'), f'{scope}/d_linear_5/Matrix', None),
        ((scope, 'd_linear_5', 'bias'), f'{scope}/d_linear_5/bias', None),
    ]
    return rules


def _enc_rules(scope: str = 'E'):
    """Resnet encoder scope (reference encoder.py:54-84, conv.py:70-85)."""
    rules = [
        ((scope, 'e_resnet_64_0', 'conv2d', 'w'),
         f'{scope}/e_resnet_64_0/conv2d/w', None),
        ((scope, 'e_resnet_64_0', 'conv2d', 'b'),
         f'{scope}/e_resnet_64_0/conv2d/b', None),
    ]
    for i, n in enumerate([128, 256, 512, 512]):
        block = f'e_resnet_{n}_{i + 1}'
        for sub in ['res1', 'res2', 'shortcut']:
            for v in ['w', 'b']:
                rules.append(((scope, block, sub, v),
                              f'{scope}/{block}/{sub}/conv2d/{v}', None))
    for head in ['FC8_mu', 'FC8_sigma']:
        rules += [((scope, head, 'w'), f'{scope}/{head}/w', None),
                  ((scope, head, 'b'), f'{scope}/{head}/b', None)]
    return rules


def _squeeze_bias(x):
    return x.reshape(-1)  # (1, C, 1, 1) -> (C,)


def _cls_rules(scope: str = 'D2'):
    """Classifier scope (reference classifier.py:12-115, conv.py:133-357).

    TF default-name allocation inside the 'D2' scope: the 7x7 stem takes
    'Conv' (classifier.py:50), the disc head takes 'Conv_1'
    (classifier.py:107); inside each mru_conv_unit_t_<u>_layer_0 scope
    the default-named convs are img_new='Conv', h_new='Conv_1'/'Conv_2',
    shortcut='Conv_3' (creation order, conv.py:201-234).

    Checked line by line against the reference's scope construction;
    every rule below derives from a cited site:
      - conv2d2 opens `tf.variable_scope(scope, 'Conv', ...)`
        (conv.py:267) with vars 'weights' [k,k,in,out] HWIO (:271) and
        'biases' (1,C,1,1) (:282); TF uniquifies default names per
        parent scope, so creation order pins Conv/Conv_1/Conv_2/Conv_3.
      - unit scopes are 'mru_conv_unit_t_%d_layer_0' with unit_num
        1..4 (conv.py:325, classifier.py:74-101); num_blocks=1
        (classifier.py:15) so no initial_hidden_state vars exist.
      - update_gate has an explicit scope (conv.py:198) with bias init
        0.5 (conv.py:140); its activation is hardwired lrelu (no vars).
      - prelu creates 'prelu/param' under the calling scope
        (activation.py:23-27): inside conv2d2's 'Conv*' scope for
        stem/h_conv1, inside 'norm_activation_in' /
        'norm_activation_merge_1' for the block's norm_activ calls
        (conv.py:184-187,210), and under 'mru_conv_unit_last_norm' for
        the unit-4 last_unit prelu (conv.py:353-355).
      - spectral 'u' lives next to its weight: scope = W.name dir,
        shape [1, out] (normalization.py:42-44).
      - fully_connected default scope 'fully_connected', weights
        [in,out], biases [out] (linear.py:47-64).
    Still pending: a value-level check against a real TF npz dump (no
    TensorFlow dump of the released checkpoint is in the repository;
    see npz_from_tf_hint).
    """
    rules = []

    def conv(ours_prefix, tf_prefix):
        rules.append((ours_prefix + ('weights',), f'{tf_prefix}/weights',
                      None))
        rules.append((ours_prefix + ('biases',), f'{tf_prefix}/biases',
                      _squeeze_bias))

    conv((scope, 'h0'), f'{scope}/Conv')
    rules.append(((scope, 'h0', 'prelu', 'param'),
                  f'{scope}/Conv/prelu/param', None))
    for unit in range(1, 5):
        ours_u = (scope, f'mru_conv_unit_{unit}')
        tf_u = f'{scope}/mru_conv_unit_t_{unit}_layer_0'
        rules.append((ours_u + ('norm_activation_in_prelu', 'param'),
                      f'{tf_u}/norm_activation_in/prelu/param', None))
        conv(ours_u + ('update_gate',), f'{tf_u}/update_gate')
        conv(ours_u + ('img_conv',), f'{tf_u}/Conv')
        rules.append((ours_u + ('norm_activation_merge_1_prelu', 'param'),
                      f'{tf_u}/norm_activation_merge_1/prelu/param', None))
        conv(ours_u + ('h_conv1',), f'{tf_u}/Conv_1')
        rules.append((ours_u + ('h_conv1', 'prelu', 'param'),
                      f'{tf_u}/Conv_1/prelu/param', None))
        conv(ours_u + ('h_conv2',), f'{tf_u}/Conv_2')
        conv(ours_u + ('shortcut',), f'{tf_u}/Conv_3')
    rules.append(((scope, 'mru_conv_unit_last_prelu', 'param'),
                  f'{scope}/mru_conv_unit_last_norm/prelu/param', None))
    conv((scope, 'disc_head'), f'{scope}/Conv_1')
    rules.append(((scope, 'class_head', 'weights'),
                  f'{scope}/fully_connected/weights', None))
    rules.append(((scope, 'class_head', 'biases'),
                  f'{scope}/fully_connected/biases', None))
    return rules


def _cls_spectral_rules(scope: str = 'D2'):
    """Spectral `u` vectors live next to their weights (reference
    normalization.py:42-44: scope = W.name dir)."""
    rules = [((scope, 'h0', 'u'), f'{scope}/Conv/u', None)]
    for unit in range(1, 5):
        ours_u = (scope, f'mru_conv_unit_{unit}')
        tf_u = f'{scope}/mru_conv_unit_t_{unit}_layer_0'
        for ours, theirs in [('update_gate', 'update_gate'),
                             ('img_conv', 'Conv'), ('h_conv1', 'Conv_1'),
                             ('h_conv2', 'Conv_2'), ('shortcut', 'Conv_3')]:
            rules.append((ours_u + (ours, 'u'), f'{tf_u}/{theirs}/u', None))
    rules.append(((scope, 'disc_head', 'u'), f'{scope}/Conv_1/u', None))
    rules.append(((scope, 'class_head', 'u'),
                  f'{scope}/fully_connected/u', None))
    return rules


class UnsupportedArchitecture(ValueError):
    """The TF name mapping covers only the reference's default
    architecture (convnet G/D, resnet E — reference train.py:48-50)."""


def _check_architecture(config):
    deviations = []
    if getattr(config, 'if_resnet_g', False):
        deviations.append('if_resnet_g=True (resnet generator)')
    if getattr(config, 'if_resnet_d', False):
        deviations.append('if_resnet_d=True (resnet discriminator)')
    if not getattr(config, 'if_resnet_e', True):
        deviations.append('if_resnet_e=False (convnet encoder)')
    if deviations:
        raise UnsupportedArchitecture(
            'TF checkpoint mapping supports only the default architecture '
            '(convnet G/D, resnet E); config deviates: '
            + ', '.join(deviations))


def param_rules(config) -> Tuple[list, list]:
    """(param rules, aux rules) for the default (convnet G/D, resnet E)
    architecture. Raises UnsupportedArchitecture for resnet-G/D or
    convnet-E configs, which would otherwise generate wrong-named rules
    and surface as a confusing KeyError downstream."""
    _check_architecture(config)
    params = (_gen_rules('G1') + _gen_rules('G2')
              + _dis_rules('D') + _enc_rules('E'))
    aux = _gen_stats_rules('G1') + _gen_stats_rules('G2')
    if config.use_image_discriminator:
        params += _dis_rules('D_patch2')
    if config.use_edge_discriminator:
        params += _dis_rules('D_patch3')
    if config.multiclasses:
        params += _cls_rules('D2')
        aux += _cls_spectral_rules('D2')
    return params, aux


def import_tf_npz(npz_path: str, config) -> Tuple[Dict, Dict]:
    """Build (params, aux) trees from a TF-variable npz dump.

    aux is keyed per network with the flax collection layout:
    {'G1': {'batch_stats': {...}}, 'D2': {'spectral': {...}}, ...}.
    Raises KeyError listing any missing TF variables, and ValueError if
    the imported trees don't match a freshly-initialised model's
    structure/shapes — catching
    wrong-size-config imports at import time instead of at first use.
    """
    p_rules, a_rules = param_rules(config)  # arch check before file IO
    with np.load(npz_path) as npz:
        data = {k: npz[k] for k in npz.files}
    missing = [tf for _, tf, _ in p_rules + a_rules if tf not in data]
    if missing:
        raise KeyError(f'npz missing {len(missing)} variables, e.g. '
                       f'{missing[:5]}')
    params: Dict = {}
    for ours, theirs, fix in p_rules:
        arr = np.asarray(data[theirs], np.float32)
        _set(params, ours, fix(arr) if fix else arr)
    # every network gets an aux entry, empty when it has no extra
    # collections (as `bridge.random_jax_params` gives them)
    aux: Dict = {name: {} for name in params}
    for ours, theirs, fix in a_rules:
        arr = np.asarray(data[theirs], np.float32)
        collection = 'spectral' if ours[-1] == 'u' else 'batch_stats'
        _set(aux, (ours[0], collection) + ours[1:],
             fix(arr) if fix else arr)
    problems = check_against(params, aux, config)
    if problems:
        lines = [f'  {"/".join(p)}: {msg}' for p, msg in problems[:10]]
        raise ValueError(
            f'imported npz does not match the configured model '
            f'({len(problems)} mismatches):\n' + '\n'.join(lines))
    return params, aux


def _unsqueeze_bias(x):
    return x.reshape(1, -1, 1, 1)  # (C,) -> TF conv2d2's NCHW bias


_INVERSE_FIX = {_squeeze_bias: _unsqueeze_bias}


def export_tf_npz(params, aux, config, npz_path: str):
    """Inverse of import_tf_npz: our (params, aux) trees -> a TF-named
    npz (the exact variable-name/layout set a real TF checkpoint dump
    contains, minus optimizer slots).

    Exists so that the name mapping can be round-tripped mechanically
    (export -> import -> bit-compare) and so that a model trained by the
    port can be handed back to the reference implementation. Returns the
    sorted TF variable-name list.
    """
    p_rules, a_rules = param_rules(config)
    out = {}
    for ours, theirs, fix in p_rules:
        arr = np.asarray(_get(params, ours), np.float32)
        inv = _INVERSE_FIX.get(fix)
        out[theirs] = inv(arr) if inv else arr
    for ours, theirs, fix in a_rules:
        collection = 'spectral' if ours[-1] == 'u' else 'batch_stats'
        arr = np.asarray(
            _get(aux, (ours[0], collection) + ours[1:]), np.float32)
        inv = _INVERSE_FIX.get(fix)
        out[theirs] = inv(arr) if inv else arr
    np.savez(npz_path, **out)
    return sorted(out)


def tf_variable_names(config) -> list:
    """Every TF variable name the mapping expects, sorted — diffable in
    seconds against `tf.train.list_variables` of the real checkpoint
    (fixture: tests/fixtures/tf_variable_names_14class.txt)."""
    p_rules, a_rules = param_rules(config)
    return sorted(tf for _, tf, _ in p_rules + a_rules)


def check_against(params_tree, aux_tree, config):
    """Compare imported trees against the port's reference-initialised
    ones for `config` (`bridge.random_jax_params` with the critics);
    returns a list of (path, problem) mismatches (empty = compatible)."""
    ref_params, ref_aux = random_jax_params(config, critics=True)
    problems = []

    def walk(ref, got, path):
        if hasattr(ref, 'items'):
            for k in ref:
                if not hasattr(got, 'items') or k not in got:
                    problems.append((path + (k,), 'missing'))
                else:
                    walk(ref[k], got[k], path + (k,))
            if hasattr(got, 'items'):
                for k in got:
                    if k not in ref:
                        problems.append((path + (k,), 'unexpected'))
        else:
            if tuple(np.shape(ref)) != tuple(np.shape(got)):
                problems.append((path, f'shape {np.shape(got)} != '
                                       f'{np.shape(ref)}'))

    walk(ref_params, params_tree, ())
    walk(ref_aux, aux_tree, ())
    return problems
