"""Random state of the port: one ``torch.Generator`` per device.

Counterpart of ``mxnet_tpu/random.py``'s ``seed`` and of the state the
initializers draw from. The JAX package splits one threefry key; the port
keeps a generator for each device it has drawn on, all seeded from one
seed (0 until :func:`seed` is called), so that a model built twice from
one seed on one device gets the same values. The streams differ between
devices (mt19937 on the CPU, Philox on CUDA) and from the JAX package's:
tests compare initializers by their distributions, and carry values
between the packages through ``convert.py``. The samplers of
``mxnet_tpu.random`` (``uniform``, ``normal``, ...) are not ported yet.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

import torch

from .context import resolve_device

__all__ = ["seed", "generator"]


class _State(threading.local):
    def __init__(self):
        self.seed = 0
        self.gens: Dict[torch.device, torch.Generator] = {}


_STATE = _State()


def seed(seed_state: int) -> None:
    """Seed the generator of every device: those drawn on already and
    those drawn on later."""
    _STATE.seed = int(seed_state)
    for gen in _STATE.gens.values():
        gen.manual_seed(_STATE.seed)


def generator(device: Union[str, torch.device] = "cuda") -> torch.Generator:
    """The generator that draws on ``device`` (made at first use)."""
    dev = resolve_device(device)
    gen = _STATE.gens.get(dev)
    if gen is None:
        gen = _STATE.gens[dev] = torch.Generator(device=dev)
        gen.manual_seed(_STATE.seed)
    return gen
