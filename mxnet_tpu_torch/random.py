"""Random state of the port: one ``torch.Generator`` per device.

Counterpart of ``mxnet_tpu/random.py``'s ``seed`` and of the state the
initializers draw from. The JAX package splits one threefry key; the port
keeps a generator for each device it has drawn on, all seeded from one
seed (0 until :func:`seed` is called), so that a model built twice from
one seed on one device gets the same values. The streams differ between
devices (mt19937 on the CPU, Philox on CUDA) and from the JAX package's:
tests compare initializers by their distributions, and carry values
between the packages through ``convert.py``.

The samplers of ``mx.random`` / ``nd.random`` (``uniform``, ``normal``,
``randn``, ``gamma``, ``exponential``, ``poisson``, ``negative_binomial``,
``generalized_negative_binomial``, ``randint``, ``multinomial``,
``shuffle``, ``bernoulli``) return NDArrays on ``ctx`` (default: the
current context), drawn from that device's generator.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

import torch

from .context import as_device, resolve_device

__all__ = ["seed", "generator", "uniform", "normal", "randn", "gamma",
           "exponential", "poisson", "negative_binomial",
           "generalized_negative_binomial", "randint", "multinomial",
           "shuffle", "bernoulli"]


class _State(threading.local):
    def __init__(self):
        self.seed = 0
        self.gens: Dict[torch.device, torch.Generator] = {}


_STATE = _State()


def seed(seed_state: int, ctx=None) -> None:
    """Seed the generator of every device: those drawn on already and
    those drawn on later (``ctx`` is accepted for MXNet's signature)."""
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


# -- samplers (mx.random / nd.random) -------------------------------------------

def _draw(opname, ctx, out=None, **params):
    """The registered sampler ``opname`` on ``ctx``'s device, as an
    NDArray (written into ``out`` where given)."""
    from .ndarray.ndarray import _wrap
    from .ops.registry import call_op, get_op
    dev = as_device(ctx)
    res = call_op(get_op(opname).fn, False, ctx=dev,
                  _generator=generator(dev), **params)
    if out is None:
        return _wrap(res)
    out._assign(res, False)
    return out


def uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", ctx=None,
            out=None, **kw):
    """Uniform samples in [low, high)."""
    return _draw("_random_uniform", ctx, out, low=low, high=high,
                 shape=shape, dtype=dtype)


def normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None,
           out=None, **kw):
    """Normal(loc, scale) samples."""
    return _draw("_random_normal", ctx, out, loc=loc, scale=scale,
                 shape=shape, dtype=dtype)


randn = normal


def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", ctx=None,
          out=None, **kw):
    """Gamma(alpha) * beta samples."""
    return _draw("_random_gamma", ctx, out, alpha=alpha, beta=beta,
                 shape=shape, dtype=dtype)


def exponential(scale=1.0, shape=(1,), dtype="float32", ctx=None, out=None,
                **kw):
    """Exponential samples of mean ``scale``."""
    return _draw("_random_exponential", ctx, out, lam=1.0 / scale,
                 shape=shape, dtype=dtype)


def poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None, out=None,
            **kw):
    """Poisson(lam) samples."""
    return _draw("_random_poisson", ctx, out, lam=lam, shape=shape,
                 dtype=dtype)


def negative_binomial(k=1, p=0.5, shape=(1,), dtype="float32", ctx=None,
                      **kw):
    """NegativeBinomial(k, p) samples."""
    return _draw("_random_negative_binomial", ctx, k=k, p=p, shape=shape,
                 dtype=dtype)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,),
                                  dtype="float32", ctx=None, **kw):
    """Generalized negative binomial (mu, alpha) samples."""
    return _draw("_random_generalized_negative_binomial", ctx, mu=mu,
                 alpha=alpha, shape=shape, dtype=dtype)


def randint(low, high, shape=(1,), dtype="int32", ctx=None, out=None, **kw):
    """Integers in [low, high)."""
    return _draw("_random_randint", ctx, out, low=low, high=high,
                 shape=shape, dtype=dtype)


def bernoulli(prob=0.5, shape=(1,), dtype="float32", ctx=None, **kw):
    """1 with probability ``prob``, else 0."""
    from .ndarray.ndarray import _wrap
    from .ops.tensor import _torch_dtype
    dev = as_device(ctx)
    shp = (shape,) if isinstance(shape, int) else tuple(shape)
    u = torch.rand(shp, generator=generator(dev), device=dev)
    return _wrap((u < prob).to(_torch_dtype(dtype)))


def multinomial(data, shape=None, get_prob=False, dtype="int32", **kw):
    """Categorical draws from the probability rows of ``data``: one per
    row when ``shape`` is None, else ``shape`` per row (and, with
    ``get_prob``, their log-probabilities)."""
    from .ndarray.ndarray import _op, _unwrap
    from .ops.random_ops import _sample_multinomial
    x = _unwrap(data)
    res = _op(_sample_multinomial, [x], False,
              shape=() if shape is None else shape, get_prob=get_prob,
              dtype=dtype, _generator=generator(x.device))
    return res


def shuffle(data, **kw):
    """The rows of ``data`` in a random order."""
    from .ndarray.ndarray import _op, _unwrap
    from .ops.random_ops import _shuffle
    x = _unwrap(data)
    return _op(_shuffle, [x], False, _generator=generator(x.device))
