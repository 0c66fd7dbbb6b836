"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: ``Initializer`` with its
dispatch on the parameter's name (``...weight``, ``...bias``, ``...gamma``,
``...beta``, ``...running_mean``, ``...running_var``), ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Xavier``, ``MSRAPrelu``, the
registry by name (:func:`create`, which also reads :meth:`Initializer.dumps`'
JSON) and :class:`InitDesc`, the name with the attributes a Module passes:
an ``__init__`` attribute (a variable's own initializer) wins over the
suffix. An initializer fills a tensor (or an NDArray's) in place,
drawing from :func:`mxnet_tpu_torch.random.generator` of the tensor's
device: values are drawn in fp32 and cast to the tensor's dtype, as the
JAX package draws and casts. Orthogonal, Bilinear, LSTMBias, Mixed and
Load are not ported yet.
"""
from __future__ import annotations

import json
import math
from typing import Dict

import torch

from . import random as _random
from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "MSRAPrelu", "register", "create"]

_REGISTRY: Dict[str, type] = {}


def register(name: str):
    """Register an initializer class under ``name``."""
    def wrap(klass):
        _REGISTRY[name] = klass
        return klass
    return wrap


def _fill(arr: torch.Tensor, value) -> None:
    with torch.no_grad():
        arr.copy_(value)


def _uniform(arr: torch.Tensor, scale: float) -> torch.Tensor:
    out = torch.empty(arr.shape, dtype=torch.float32, device=arr.device)
    return out.uniform_(-scale, scale,
                        generator=_random.generator(arr.device))


def _normal(arr: torch.Tensor, sigma: float) -> torch.Tensor:
    return sigma * torch.randn(arr.shape, dtype=torch.float32,
                               device=arr.device,
                               generator=_random.generator(arr.device))


class InitDesc(str):
    """A parameter's name with its attributes (``attrs``), as a Module
    describes the arrays it initializes."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    """Fills a tensor by the suffix of its parameter's name; subclasses
    give ``_init_weight`` (the rule for weights, and for any name no
    suffix matches). An :class:`InitDesc` with an ``__init__`` attribute
    is filled by that initializer's ``_init_weight`` instead."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name: str, arr) -> None:
        arr = getattr(arr, "_data", arr)  # an NDArray's tensor
        init_attr = name.attrs.get("__init__", "") \
            if isinstance(name, InitDesc) else ""
        if init_attr:
            create(init_attr)._init_weight(str(name), arr)
            return
        name = str(name).lower()
        if name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(name, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(name, arr)
        else:
            self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_bias(self, name, arr):
        _fill(arr, 0.0)

    def _init_gamma(self, name, arr):
        _fill(arr, 1.0)

    def _init_beta(self, name, arr):
        _fill(arr, 0.0)

    def _init_zero(self, name, arr):
        _fill(arr, 0.0)

    def _init_one(self, name, arr):
        _fill(arr, 1.0)

    def dumps(self) -> str:
        """``'["<name>", {kwargs}]'``, the form a variable's ``__init__``
        attribute holds."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])


@register("zeros")
class Zero(Initializer):
    def _init_weight(self, name, arr):
        _fill(arr, 0.0)


@register("ones")
class One(Initializer):
    def _init_weight(self, name, arr):
        _fill(arr, 1.0)


@register("constant")
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        _fill(arr, torch.as_tensor(self.value, dtype=torch.float32)
              .expand(arr.shape))


@register("uniform")
class Uniform(Initializer):
    """U(-scale, scale); the Gluon default, scale 0.07."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        _fill(arr, _uniform(arr, self.scale))


@register("normal")
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        _fill(arr, _normal(arr, self.sigma))


@register("xavier")
class Xavier(Initializer):
    """Gaussian or uniform with scale ``sqrt(magnitude / factor)``, the
    factor the average, input or output fan; a fan counts the receptive
    field (every axis past the second) of a convolution's weight."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        if rnd_type not in ("uniform", "gaussian"):
            raise MXNetError(f"Xavier: unknown rnd_type {rnd_type!r}")
        if factor_type not in ("avg", "in", "out"):
            raise MXNetError(f"Xavier: unknown factor_type {factor_type!r}")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def scale(self, shape) -> float:
        """The scale for a weight of ``shape``."""
        hw_scale = 1.0
        if len(shape) < 2:
            fan_in = fan_out = shape[0] if len(shape) else 1
        else:
            if len(shape) > 2:
                hw_scale = float(math.prod(shape[2:]))
            fan_in = shape[1] * hw_scale
            fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, name, arr):
        s = self.scale(tuple(arr.shape))
        _fill(arr, _uniform(arr, s) if self.rnd_type == "uniform"
              else _normal(arr, s))


@register("msraprelu")
class MSRAPrelu(Xavier):
    """He et al.'s initialization for PReLU of slope ``slope``: Gaussian
    Xavier with magnitude ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


def create(name, **kwargs) -> Initializer:
    """An initializer by registered name (an instance is returned as
    is)."""
    if isinstance(name, Initializer):
        return name
    if str(name).startswith("["):
        loaded = json.loads(name)
        return create(loaded[0], **(loaded[1] if len(loaded) > 1 else {}))
    try:
        klass = _REGISTRY[str(name).lower()]
    except KeyError:
        raise MXNetError(f"unknown initializer {name!r} (known: "
                         f"{sorted(_REGISTRY)})") from None
    return klass(**kwargs)
