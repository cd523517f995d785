"""Fixture: state-class contract violations."""
from dataclasses import dataclass

import torch


# a state class of the port (analysis/pytree_rules.py, STATE_CLASSES)
@dataclass
class PSState:  # VIOLATION: state-frozen
    clock: torch.Tensor
    base: torch.Tensor


def advance(state: PSState):
    state.clock = state.clock + 1  # VIOLATION: state-mutation
    return state

