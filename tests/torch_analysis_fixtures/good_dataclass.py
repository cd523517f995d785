"""Fixture: clean state-class usage -- no findings."""
import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PSState:
    clock: torch.Tensor
    base: torch.Tensor


def advance(state: PSState):
    return dataclasses.replace(state, clock=state.clock + 1)


@dataclass
class PlainConfig:
    # not a state class: plain mutable dataclasses are fine
    name: str = "x"


def rename(cfg: PlainConfig):
    cfg.name = "y"
    return cfg
