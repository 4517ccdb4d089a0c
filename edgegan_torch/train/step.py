"""The fused training step (the JAX package's train/step.py:38-296).

`make_train_step(nets, config)` returns `train_step(state, images, z,
draws)`, which runs the reference's seven optimizer groups in order, each
on the parameters the earlier groups left (`update_mode='faithful'`):

  1-3. the joint, image and edge critics: WGAN loss + gradient penalty,
  4.   the classifier on the real photo half (focal cross entropy),
  5.   both generators (their losses against the updated critics),
  6.   the encoder (z reconstruction of the new edge generator's output),
  7.   both generators again, with the same RMSProp slots (quirk Q5).

`update_mode='fast'` (JAX l.248-260) runs groups 1-4 the same way, then
one generator update, then the encoder on the step-start `edge_fake` (the
fake the critics saw), and no group 7: cheaper, not dynamics-identical.

Every group takes its gradient with `torch.autograd.grad` with respect to
its own parameters only, so no other group's gradient is built or kept.
The fakes the critics see are made once, without a graph, before group 1,
as JAX makes them outside every `value_and_grad`; so the penalty's second
derivative never reaches the generators, whose kernels (K1/K2) are
first-order only.

Options (JAX l.214-221, 264-285):
- `update_sn`: after the classifier's update, every spectral-norm `u` of
  the classifier takes one power iteration against its new weights
  (`models/layers.advance_spectral_norms`); off, `u` stays frozen (Q3).
- `reference_metrics`: after all groups, the critics' losses (WGAN +
  penalty, each with a fresh blend `draws.alpha_eval`, on the resized
  real halves of the step's start) and the generators' losses are
  evaluated again on the post-step weights, from one fresh generator
  forward, as the reference logs them; `loss_d_ac` and `zl_loss` are
  not, as in JAX. The penalty takes the critic's input gradient without
  a graph, and nothing here builds a parameter gradient.

The step's random numbers come in `draws` (see `Draws`): one blend weight
per sample for each critic's penalty, the encoder's scalar eps, and with
`host_z=False` the latent z. The CLI draws them from a `torch.Generator`
on the device; the tests hand in the JAX step's own draws.

Data parallelism (`parallel`, at two or more ranks): each rank passes its
rows of the global batch; `make_draws` draws the global batch's random
numbers from the step's generator, seeded alike on every rank, and keeps
this rank's rows (the JAX step's sharding-invariant draw, l.127-140);
every group's gradients are averaged over the ranks before its update
(one flat all-reduce per group, K5's `dleak` in the classifier's); the
losses stay local means, and the batch-norm statistics span the ranks
(`parallel.synced_batch_stats`, entered for the whole step), so the mean
of the ranks' gradients is the gradient of the global mean. Every rank
applies the same update, and the parameters stay equal bit for bit; the
spectral norms' `u` follows from them. The metrics returned are this
rank's; the trainer averages them over the ranks.

`dtype='bfloat16'` is mixed precision as in the JAX step (step.py:42-48,
143-146): the images and the generators' input are cast to bfloat16 after
the class column is read, and every layer casts its float32 weight to its
input's dtype, so the networks run in bfloat16, while the master weights,
the RMSProp slots, the spectral-norm vectors, the losses (`.float()` at
the loss boundary) and the metrics stay float32, and so do the labels and
the encoder's L1 target.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from .. import losses as L
from .. import parallel
from ..core.config import Config
from ..infer import exact_f32
from ..models.layers import advance_spectral_norms
from ..ops.resize import resize
from .networks import Networks
from .state import GROUPS, RMSProp, TrainState, group_params

COMPUTE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}

# critic -> (optimizer group, metric of its loss)
CRITICS = {'D': ('d', 'joint_dis_dloss'),
           'D_patch2': ('d_patch2', 'image_dis_dloss'),
           'D_patch3': ('d_patch3', 'edge_dis_dloss')}


@dataclasses.dataclass
class Draws:
    """One step's random numbers. `alpha`: critic name -> [B] blend
    weights in [0, 1); `eps`: the encoder's 0-d noise (quirk Q2); `z`:
    [B, z_dim] standard normal latents, or None when the batch carries
    them (`host_z`); `alpha_eval`: the `reference_metrics` penalties'
    blend weights, keyed as `alpha` (JAX's fold_in(rng, 16 + i))."""
    alpha: Dict[str, torch.Tensor]
    eps: torch.Tensor
    z: Optional[torch.Tensor] = None
    alpha_eval: Optional[Dict[str, torch.Tensor]] = None


def make_draws(config: Config, batch: int, generator: torch.Generator,
               device) -> Draws:
    """Draw one step's `Draws` for a global batch of `batch` rows from
    `generator` (on `device`), and keep this rank's rows (all of them at
    world size 1); `eps` is one scalar for the whole batch. In bfloat16
    the blend weights are multiples of 2^-7 in [0, 1), the values
    `jax.random.uniform` draws in bfloat16 (losses.py:102), so that no
    float32 draw rounds up to 1. The `reference_metrics` blend weights are
    drawn last, so that the other draws do not depend on the option."""
    def blends():
        if config.dtype == 'bfloat16':
            return {name: torch.randint(0, 2 ** 7, (batch,),
                                        generator=generator,
                                        device=device) / 2.0 ** 7
                    for name in CRITICS}
        return {name: torch.rand(batch, generator=generator, device=device)
                for name in CRITICS}

    alpha = blends()
    eps = torch.randn((), generator=generator, device=device)
    z = (None if config.host_z else
         torch.randn(batch, config.z_dim, generator=generator,
                     device=device))
    alpha_eval = blends() if config.reference_metrics else None

    def rows(d):
        return d and {k: parallel.local_rows(v) for k, v in d.items()}
    return Draws(alpha=rows(alpha), eps=eps,
                 z=None if z is None else parallel.local_rows(z),
                 alpha_eval=rows(alpha_eval))


def make_train_step(nets: Networks, config: Config):
    if config.update_mode not in ('faithful', 'fast'):
        raise ValueError(f'update_mode {config.update_mode!r}: faithful or '
                         'fast')
    compute_dtype = COMPUTE_DTYPES[config.dtype]
    exact_f32()
    opt = RMSProp(config.learning_rate)
    z_dim = config.z_dim
    half_w = int(config.output_width / 2)
    image_size = (config.image_dis_size,) * 2
    edge_size = (config.edge_dis_size,) * 2
    groups = {g: group_params(nets, g) for g, net in GROUPS.items()
              if hasattr(nets, net)}

    def update(state: TrainState, names: List[str], loss):
        """Gradient of `loss` for the parameters of groups `names`, then
        one RMSProp update of each group. A parameter the loss does not
        reach (the classifier's unused `disc_head`) gets a zero
        gradient, as in JAX: its slot decays and its value stays."""
        params = [p for g in names for p in groups[g][1]]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        parallel.all_reduce_mean_(grads)
        for g in names:
            qual, ps = groups[g]
            opt.update(ps, grads[:len(ps)],
                       [state.slots[g][n] for n in qual])
            grads = grads[len(ps):]

    def critic_loss(name, fake, real, alpha, create_graph=True):
        def d(x):
            return nets.discriminate(name, x)
        _, real_logit = d(real)
        _, fake_logit = d(fake)
        loss = L.discriminator_ganloss(fake_logit, real_logit)
        return loss + L.gradient_penalty(d, fake, real, alpha,
                                         config.lambda_gp, create_graph)

    def g_losses(z_in, labels):
        """edge_gloss(G1) + image_gloss(G2) (models/edgegan.py:314-332),
        arranged so that ONE backward gives each generator exactly the
        reference's gradient: the joint critic sees each generator's half
        with the other half detached (the JAX step's stop_gradient
        pairing, step.py:61-102)."""
        edge_f, image_f = nets.generate(z_in)
        joint_edge = torch.cat([edge_f, image_f.detach()], dim=3)
        joint_image = torch.cat([edge_f.detach(), image_f], dim=3)
        _, fake_joint_e = nets.discriminate('D', joint_edge)
        _, fake_joint_i = nets.discriminate('D', joint_image)
        sub = {'joint_dis_gloss': L.generator_ganloss(fake_joint_e)}
        edge_gloss = config.joint_dweight * sub['joint_dis_gloss']
        image_gloss = config.joint_dweight * L.generator_ganloss(fake_joint_i)
        if config.use_edge_discriminator:
            _, fake_edge = nets.discriminate('D_patch3',
                                             resize(edge_f, edge_size))
            sub['edge_dis_gloss'] = L.generator_ganloss(fake_edge)
            edge_gloss = edge_gloss + config.edge_dweight * sub[
                'edge_dis_gloss']
        if config.use_image_discriminator:
            _, fake_image = nets.discriminate('D_patch2',
                                              resize(image_f, image_size))
            sub['image_dis_gloss'] = L.generator_ganloss(fake_image)
            image_gloss = image_gloss + config.image_dweight * sub[
                'image_dis_gloss']
        loss_g_ac = torch.zeros((), device=z_in.device)
        if config.multiclasses:
            _, _, fake_logits = nets.classify(image_f)
            loss_g_ac = 0.5 * torch.mean(L._sparse_ce(fake_logits, labels))
            image_gloss = image_gloss + loss_g_ac
        return edge_gloss + image_gloss, dict(
            edge_gloss=edge_gloss, image_gloss=image_gloss,
            loss_g_ac=loss_g_ac, **sub)

    def update_generators(state, z_in, labels, metrics):
        """One g_optim run (both generators, models/edgegan.py:117-124):
        one shared forward, one backward."""
        loss, parts = g_losses(z_in, labels)
        update(state, ['g1', 'g2'], loss)
        metrics.update(parts)

    def train_step(state: TrainState, images, z, draws: Draws):
        """images: NHWC [B, H, W, 3] in [-1, 1] (float32, or already
        bfloat16); z: the batch's [B, z_dim (+1)] latents and class column
        (`host_z`), or its [B, 1] class column (device z, the latents in
        `draws.z`); B is this rank's rows. Updates `state` in place and
        returns it with the step's 11 metrics (0-d float32 tensors)."""
        with parallel.synced_batch_stats():
            return step(state, images, z, draws)

    def step(state, images, z, draws):
        metrics = {}
        z = z.float()
        if not config.host_z:
            z = torch.cat([draws.z.float(), z], dim=1)
        labels = z[:, -1].long() if config.multiclasses else None
        z_lat = z[:, :z_dim] if config.multiclasses else z   # f32 target
        x = images.to(compute_dtype).permute(0, 3, 1, 2)
        edge_real = x[:, :, :, :half_w]
        image_real = x[:, :, :, half_w:config.output_width]
        z_in = nets.gen_input(z_lat.to(compute_dtype), labels)

        # the critics' fakes, one generator forward without a graph (G
        # does not change before group 5)
        with torch.no_grad():
            edge_fake, image_fake = nets.generate(z_in)
        joint_fake = torch.cat([edge_fake, image_fake], dim=3)

        # groups 1-3: the critics (WGAN + GP)
        pairs = {'D': (joint_fake, x)}
        if config.use_image_discriminator:
            pairs['D_patch2'] = (resize(image_fake, image_size),
                                 resize(image_real, image_size))
        if config.use_edge_discriminator:
            pairs['D_patch3'] = (resize(edge_fake, edge_size),
                                 resize(edge_real, edge_size))
        for name, (fake, real) in pairs.items():
            group, metric = CRITICS[name]
            loss_d = critic_loss(name, fake, real, draws.alpha[name])
            update(state, [group], loss_d)
            metrics[metric] = loss_d

        # group 4: the classifier on the real photo half (focal CE)
        if config.multiclasses:
            _, _, real_logits = nets.classify(image_real)
            _, loss_d_ac = L.get_acgan_loss_focal(
                real_logits, labels, real_logits, labels, config.num_classes)
            update(state, ['d2'], loss_d_ac)
            metrics['loss_d_ac'] = loss_d_ac

            if config.update_sn:
                advance_spectral_norms(nets.D2)

        # group 5 (fast: the only generator update)
        update_generators(state, z_in, labels, metrics)

        # group 6: the encoder. Faithful: on the new edge generator's output
        # (G1 only: the JAX step's compiler drops the unused G2 branch);
        # fast: on the step-start fake the critics saw.
        if config.update_mode == 'faithful':
            with torch.no_grad():
                encoder_input = nets.G1(z_in)
        else:
            encoder_input = edge_fake
        z_recon, _, _ = nets.encode(encoder_input, draws.eps)
        zl_loss = L.l1loss(z_lat, z_recon, config.stage1_zl_loss)
        update(state, ['e'], zl_loss)
        metrics['zl_loss'] = zl_loss

        if config.update_mode == 'faithful':
            # group 7: the generators again, same slots
            update_generators(state, z_in, labels, metrics)

        if config.reference_metrics:
            # every reported loss but loss_d_ac and zl_loss again, on the
            # post-step weights (models/edgegan.py:464-486)
            with torch.no_grad():
                edge_f, image_f = nets.generate(z_in)
            evals = {'D': (torch.cat([edge_f, image_f], dim=3), x)}
            if config.use_image_discriminator:
                evals['D_patch2'] = (resize(image_f, image_size),
                                     pairs['D_patch2'][1])
            if config.use_edge_discriminator:
                evals['D_patch3'] = (resize(edge_f, edge_size),
                                     pairs['D_patch3'][1])
            for name, (fake, real) in evals.items():
                metrics[CRITICS[name][1]] = critic_loss(
                    name, fake, real, draws.alpha_eval[name],
                    create_graph=False).detach()
            with torch.no_grad():
                metrics.update(g_losses(z_in, labels)[1])

        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step
