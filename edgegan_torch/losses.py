"""Loss functions (reference nn/functional.py; the JAX package's
losses.py:48-131). Every reduction is a global mean in float32.

The float32 boundary is a plain `.float()`: its backward already casts
the cotangent back to the network's dtype, which is what the JAX package
needs a custom VJP for.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops.norms import nan_guards_enabled


def discriminator_ganloss(fake_out, real_out):
    """WGAN critic loss `mean(fake - real)` (functional.py:32-33)."""
    return torch.mean(fake_out.float() - real_out.float())


def generator_ganloss(fake_out):
    """`mean(-fake)` (functional.py:36-37)."""
    return torch.mean(-fake_out.float())


def l1loss(output, target, weight):
    """`weight * mean(|output - target|)` (functional.py:40-41)."""
    return weight * torch.mean(torch.abs(output.float() - target.float()))


def _sparse_ce(logits, labels):
    """Per-row cross entropy of integer `labels`."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0]


def get_acgan_loss_focal(real_logits, real_label, fake_logits, condition,
                         num_classes, ld1=1.0, ld2=0.5, ld_focal=2.0):
    """Focal AC-GAN losses (functional.py:5-16), in the reference's order
    (loss_ac_g, loss_ac_d):
    loss_ac_d = ld1 * mean((1 - p_true)^gamma * CE(real_logits, label)),
    loss_ac_g = ld2 * mean(CE(fake_logits, condition))."""
    p = F.softmax(real_logits.float(), dim=-1)
    onehot = F.one_hot(real_label.long(), num_classes).to(p.dtype)
    pt = torch.sum(p * onehot, dim=-1)
    loss_ac_d = ld1 * torch.mean(
        (1.0 - pt) ** ld_focal * _sparse_ce(real_logits, real_label))
    loss_ac_g = ld2 * torch.mean(_sparse_ce(fake_logits, condition))
    return loss_ac_g, loss_ac_d


def random_blend(a, b, alpha):
    """`b + alpha * (a - b)` with one alpha per sample (`alpha` [B], drawn
    by the caller; models/edgegan.py:32-35)."""
    return b + alpha.to(a.dtype).view(-1, *([1] * (a.dim() - 1))) * (a - b)


def gradient_penalty(d_apply, synthesized, real, alpha, weight,
                     create_graph: bool = True):
    """WGAN-GP on a random blend (models/edgegan.py:38-42,
    functional.py:26-29).

    Quirk Q4: the reference passes the critic's (sigmoid(D), D) tuple to
    tf.gradients, so the penalty differentiates sum(sigmoid(D)) + sum(D)
    with respect to the blend, which is a constant here: the train step
    hands in detached fakes, as JAX computes them outside every
    `value_and_grad` (train/step.py:153-162). For a training loss the
    gradient keeps its graph (`create_graph`) so that the penalty's own
    gradient reaches the critic's weights; the critic's ops are all
    plain, twice differentiable. A penalty that is only reported
    (`reference_metrics`) passes create_graph=False and keeps no graph.
    At a zero gradient norm the sqrt is guarded (its backward would be inf
    there) unless EDGEGAN_NAN_GUARDS=0.
    """
    interpolated = random_blend(synthesized, real, alpha).detach()
    interpolated.requires_grad_(True)
    sig, logit = d_apply(interpolated)
    grads, = torch.autograd.grad(sig.sum() + logit.sum(), interpolated,
                                 create_graph=create_graph)
    sumsq = torch.sum(torch.square(grads.float()), dim=(1, 2, 3))
    if nan_guards_enabled():
        positive = sumsq > 0
        grad_l2 = torch.sqrt(torch.where(positive, sumsq,
                                         torch.ones_like(sumsq)))
        grad_l2 = torch.where(positive, grad_l2, torch.zeros_like(grad_l2))
    else:  # reference-exact (functional.py:26-29)
        grad_l2 = torch.sqrt(sumsq)
    return weight * torch.mean((grad_l2 - 1.0) ** 2)
