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
JAX package draws and casts. ``Orthogonal`` (an orthonormal basis of a
random matrix, by SVD), ``Bilinear`` (an upsampling kernel), ``LSTMBias``
(the forget gate's bias), ``Mixed`` (by name pattern) and ``Load`` (from
a ``.params`` file or a dict) complete the JAX package's set.
"""
from __future__ import annotations

import json
import math
import re
from typing import Dict

import torch

from . import random as _random
from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear",
           "LSTMBias", "Mixed", "Load", "register", "create"]

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


@register("orthogonal")
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor (U or V of an SVD) of a
    random ``(shape[0], prod(shape[1:]))`` matrix, uniform in [-1, 1] or
    normal (``rand_type``)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout, nin = arr.shape[0], math.prod(arr.shape[1:])
        gen = _random.generator(arr.device)
        if self.rand_type == "uniform":
            tmp = torch.empty((nout, nin), device=arr.device).uniform_(
                -1.0, 1.0, generator=gen)
        else:
            tmp = torch.randn((nout, nin), device=arr.device, generator=gen)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        _fill(arr, self.scale * q.reshape(arr.shape))


@register("bilinear")
class Bilinear(Initializer):
    """The bilinear-interpolation kernel of a transposed convolution that
    upsamples by ``ceil(kernel / 2)``."""

    def _init_weight(self, name, arr):
        shape = tuple(arr.shape)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = torch.arange(shape[3], dtype=torch.float32)
        y = torch.arange(shape[2], dtype=torch.float32)
        k = (1 - torch.abs(y[:, None] / f - c)) * \
            (1 - torch.abs(x[None, :] / f - c))
        _fill(arr, k.expand(shape).to(arr.device))


@register("lstmbias")
class LSTMBias(Initializer):
    """Zeros, except ``forget_bias`` on the forget gate's quarter (the
    second) of an LSTM's stacked bias."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(arr.shape, dtype=torch.float32)
        n = arr.shape[0] // 4
        b[n:2 * n] = self.forget_bias
        _fill(arr, b.to(arr.device))


@register("mixed")
class Mixed(Initializer):
    """The initializer of the first of ``patterns`` (regular expressions,
    ``re.match``) that a parameter's name matches; no match raises."""

    def __init__(self, patterns, initializers):
        super().__init__()
        self.map = list(zip([re.compile(p) for p in patterns],
                            [create(i) for i in initializers]))

    def __call__(self, name, arr):
        for pat, init in self.map:
            if pat.match(str(name)):
                init(name, arr)
                return
        raise ValueError(f"parameter {name} did not match any pattern")


class Load(Initializer):
    """Values by name from a ``.params`` file (or a ``{name: array}``
    dict; ``arg:``/``aux:`` prefixes dropped), ``default_init`` for a name
    it lacks; a shape that differs raises."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        if isinstance(param, str):
            from .ndarray import serialization
            param = serialization.load(param, device="cpu")
        self.param = {}
        for name, arr in dict(param).items():
            if name.startswith(("arg:", "aux:")):
                name = name[4:]
            self.param[name] = torch.as_tensor(getattr(arr, "_data", arr))
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        arr = getattr(arr, "_data", arr)
        key = str(name)
        if key in self.param:
            src = self.param[key]
            if tuple(arr.shape) != tuple(src.shape):
                raise MXNetError(f"Parameter {key}: shape mismatch "
                                 f"({tuple(arr.shape)} vs "
                                 f"{tuple(src.shape)})")
            _fill(arr, src.to(device=arr.device, dtype=arr.dtype))
        elif self.default_init is None:
            raise MXNetError(f"Cannot Initialize {key}: not found in loaded "
                             "params and no default_init")
        else:
            create(self.default_init)(name, arr)


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
