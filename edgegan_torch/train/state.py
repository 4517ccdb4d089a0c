"""Train state: the seven optimizer groups and TF1 RMSProp (the JAX
package's train/state.py:22-65).

The reference registers seven sequential RMSProp groups
(models/edgegan.py:109-124): d (joint critic), d_patch2 (image critic),
d_patch3 (edge critic), d2 (classifier), g_u (both generators), e
(encoder) and g_b (both generators again, reusing the same slots), so
there is one slot set per generator, `g1` and `g2`, used by both
generator updates.

TF1 RMSProp (decay 0.9, no momentum, epsilon 1e-10): the mean-square slot
starts at ONES, and epsilon sits INSIDE the square root:
    nu <- 0.9 nu + 0.1 g^2
    p  <- p - lr * g / sqrt(nu + 1e-10)
`torch.optim.RMSprop` (alpha 0.99, eps outside the sqrt, zero slots) is
not this, so it is written out here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from .. import parallel
from .networks import Networks

# optimizer group -> the network it updates, in the reference's order
GROUPS = {'d': 'D', 'd_patch2': 'D_patch2', 'd_patch3': 'D_patch3',
          'd2': 'D2', 'g1': 'G1', 'g2': 'G2', 'e': 'E'}


def group_params(nets: Networks, group: str
                 ) -> Tuple[List[str], List[torch.nn.Parameter]]:
    """(qualified names, parameters) of one group's network, in the
    order of `named_parameters` ('G1.g_lin_0.Matrix', ...)."""
    net = GROUPS[group]
    named = list(getattr(nets, net).named_parameters())
    return [f'{net}.{n}' for n, _ in named], [p for _, p in named]


@dataclasses.dataclass
class TrainState:
    """The port's counterpart of the JAX TrainState: the networks (their
    parameters and buffers), one RMSProp slot per parameter keyed by
    group and qualified name, and the step count."""
    nets: Networks
    slots: Dict[str, Dict[str, torch.Tensor]]
    step: int = 0


def create_train_state(nets: Networks) -> TrainState:
    """Slots of ones (TF1's initial mean square) for every group whose
    network `nets` holds."""
    slots = {}
    for group, net in GROUPS.items():
        if hasattr(nets, net):
            names, params = group_params(nets, group)
            slots[group] = {n: torch.ones_like(p, memory_format=torch.
                                               contiguous_format)
                            for n, p in zip(names, params)}
    return TrainState(nets=nets, slots=slots)


def broadcast_state(state: TrainState) -> TrainState:
    """Rank 0's state on every rank, in place: parameters, buffers (the
    spectral-norm vectors, the moving statistics), RMSProp slots and the
    step count, so that the ranks start bitwise equal after init or
    restore. A no-op without a process group."""
    if parallel.initialized():
        tensors = ([p.data for p in state.nets.parameters()]
                   + list(state.nets.buffers())
                   + [t for slots in state.slots.values()
                      for t in slots.values()])
        parallel.broadcast_(tensors)
        state.step = parallel.broadcast_object(state.step)
    return state


class RMSProp:
    """TF1 RMSProp on lists of tensors, in place.

    JAX's update is functional; here parameters and slots are updated in
    place under `torch.no_grad()`, which is safe because every group's
    backward has finished before its update, and no graph that saved
    these parameters is used afterwards. The multi-tensor `_foreach` ops
    make one launch per op for the whole group on the card."""

    def __init__(self, learning_rate: float, decay: float = 0.9,
                 eps: float = 1e-10):
        self.lr, self.decay, self.eps = learning_rate, decay, eps

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               slots: List[torch.Tensor]):
        torch._foreach_mul_(slots, self.decay)
        torch._foreach_addcmul_(slots, grads, grads, value=1.0 - self.decay)
        denom = torch._foreach_add(slots, self.eps)
        torch._foreach_sqrt_(denom)
        torch._foreach_addcdiv_(params, grads, denom, value=-self.lr)
