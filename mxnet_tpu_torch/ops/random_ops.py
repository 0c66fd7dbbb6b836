"""Random sampling ops on the port's per-device generators.

Counterpart of ``mxnet_tpu/ops/random_ops.py``: the ``_random_<dist>``
samplers (scalar parameters), their ``_like`` forms, the row-wise
``_sample_<dist>`` samplers (output shape ``params.shape + shape``),
``_sample_multinomial``, ``_sample_unique_zipfian``, ``_shuffle`` and the
``_random_pdf_<dist>`` densities. A sampler draws from the
``torch.Generator`` of its device (:func:`mxnet_tpu_torch.random.generator`,
seeded by ``mx.random.seed``), which the nd layer passes as
``_generator``. The streams are torch's (mt19937 on the CPU, Philox on
CUDA), not the JAX package's threefry, so samples match it in
distribution and not value by value; a seed reproduces them.
"""
from __future__ import annotations

import math

import torch

from .registry import register_op

__all__ = []


def _shape(shape):
    if shape is None:
        return ()
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _dt(dtype, default="float32"):
    from ..ndarray.ndarray import as_torch_dtype
    return as_torch_dtype(dtype or default)


def _uniform(shape, g, dtype=torch.float32):
    return torch.rand(shape, generator=g, device=g.device, dtype=dtype)


def _gamma(alpha, g):
    """Gamma(alpha) draws, one per element of the float tensor ``alpha``."""
    return torch._standard_gamma(alpha, generator=g)


def _gamma_poisson(r, p, shape, g):
    """NegativeBinomial(r, p) draws through the gamma-Poisson mixture."""
    lam = _gamma(r.expand(shape).contiguous(), g) * (1.0 - p) / p
    return torch.poisson(lam, generator=g)


def _full(v, shape, g):
    return torch.full(shape, float(v), device=g.device)


# -- _random_*: scalar parameters ---------------------------------------------

@register_op("_random_uniform", differentiable=False, needs_rng=True,
             aliases=["random_uniform"])
def _random_uniform(low=0.0, high=1.0, shape=(1,), dtype="float32",
                    ctx=None, _generator=None):
    """Uniform samples in [low, high)."""
    u = _uniform(_shape(shape), _generator)
    return (low + u * (high - low)).to(_dt(dtype))


@register_op("_random_normal", differentiable=False, needs_rng=True,
             aliases=["random_normal"])
def _random_normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32",
                   ctx=None, _generator=None):
    """Normal(loc, scale) samples."""
    z = torch.randn(_shape(shape), generator=_generator,
                    device=_generator.device)
    return (loc + scale * z).to(_dt(dtype))


@register_op("_random_gamma", differentiable=False, needs_rng=True,
             aliases=["random_gamma"])
def _random_gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32",
                  ctx=None, _generator=None):
    """Gamma(alpha) * beta samples (shape / scale)."""
    return (beta * _gamma(_full(alpha, _shape(shape), _generator),
                          _generator)).to(_dt(dtype))


@register_op("_random_exponential", differentiable=False, needs_rng=True,
             aliases=["random_exponential"])
def _random_exponential(lam=1.0, shape=(1,), dtype="float32", ctx=None,
                        _generator=None):
    """Exponential samples of rate ``lam``."""
    e = torch.empty(_shape(shape), device=_generator.device).exponential_(
        1.0, generator=_generator)
    return (e / lam).to(_dt(dtype))


@register_op("_random_poisson", differentiable=False, needs_rng=True,
             aliases=["random_poisson"])
def _random_poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None,
                    _generator=None):
    """Poisson(lam) samples."""
    return torch.poisson(_full(lam, _shape(shape), _generator),
                         generator=_generator).to(_dt(dtype))


@register_op("_random_negative_binomial", differentiable=False,
             needs_rng=True, aliases=["random_negative_binomial"])
def _random_negative_binomial(k=1, p=0.5, shape=(1,), dtype="float32",
                              ctx=None, _generator=None):
    """NegativeBinomial(k, p) samples (gamma-Poisson mixture)."""
    shp = _shape(shape)
    return _gamma_poisson(_full(k, shp, _generator), p, shp,
                          _generator).to(_dt(dtype))


@register_op("_random_generalized_negative_binomial", differentiable=False,
             needs_rng=True, aliases=["random_generalized_negative_binomial"])
def _random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,),
                                          dtype="float32", ctx=None,
                                          _generator=None):
    """Generalized negative binomial (mu, alpha) samples."""
    shp = _shape(shape)
    r = 1.0 / alpha
    return _gamma_poisson(_full(r, shp, _generator), r / (r + mu), shp,
                          _generator).to(_dt(dtype))


@register_op("_random_randint", differentiable=False, needs_rng=True,
             aliases=["random_randint"])
def _random_randint(low=0, high=1, shape=(1,), dtype="int32", ctx=None,
                    _generator=None):
    """Integers in [low, high)."""
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=_generator, device=_generator.device,
                         dtype=_dt(dtype, "int32"))


# -- _like forms: shaped and typed like the input -----------------------------

@register_op("_random_uniform_like", differentiable=False, needs_rng=True)
def _random_uniform_like(data, low=0.0, high=1.0, _generator=None):
    """Uniform samples shaped and typed like the input."""
    return _random_uniform(low, high, tuple(data.shape),
                           _generator=_generator).to(data.dtype)


@register_op("_random_normal_like", differentiable=False, needs_rng=True)
def _random_normal_like(data, loc=0.0, scale=1.0, _generator=None):
    """Normal samples shaped and typed like the input."""
    return _random_normal(loc, scale, tuple(data.shape),
                          _generator=_generator).to(data.dtype)


@register_op("_random_gamma_like", differentiable=False, needs_rng=True)
def _random_gamma_like(data, alpha=1.0, beta=1.0, _generator=None):
    """Gamma samples shaped and typed like the input."""
    return _random_gamma(alpha, beta, tuple(data.shape),
                         _generator=_generator).to(data.dtype)


@register_op("_random_exponential_like", differentiable=False,
             needs_rng=True)
def _random_exponential_like(data, lam=1.0, _generator=None):
    """Exponential samples shaped and typed like the input."""
    return _random_exponential(lam, tuple(data.shape),
                               _generator=_generator).to(data.dtype)


@register_op("_random_poisson_like", differentiable=False, needs_rng=True)
def _random_poisson_like(data, lam=1.0, _generator=None):
    """Poisson samples shaped and typed like the input."""
    return _random_poisson(lam, tuple(data.shape),
                           _generator=_generator).to(data.dtype)


@register_op("_random_negative_binomial_like", differentiable=False,
             needs_rng=True)
def _random_negative_binomial_like(data, k=1, p=0.5, _generator=None):
    """Negative binomial samples shaped and typed like the input."""
    return _random_negative_binomial(k, p, tuple(data.shape),
                                     _generator=_generator).to(data.dtype)


@register_op("_random_generalized_negative_binomial_like",
             differentiable=False, needs_rng=True)
def _random_generalized_negative_binomial_like(data, mu=1.0, alpha=1.0,
                                               _generator=None):
    """Generalized negative binomial samples shaped and typed like the
    input."""
    return _random_generalized_negative_binomial(
        mu, alpha, tuple(data.shape), _generator=_generator).to(data.dtype)


# -- _sample_*: per-row parameters --------------------------------------------

def _rows(param, shape):
    """``param`` broadcast over the trailing sample axes, as float."""
    extra = len(_shape(shape))
    p = param.float()
    return p.reshape(tuple(p.shape) + (1,) * extra) if extra else p


def _row_shape(param, shape):
    return tuple(param.shape) + _shape(shape)


@register_op("_sample_uniform", differentiable=False, needs_rng=True,
             aliases=["sample_uniform"])
def _sample_uniform(low, high, shape=(), dtype="float32", _generator=None):
    """Uniform[low_i, high_i) draws of shape ``params.shape + shape``."""
    u = _uniform(_row_shape(low, shape), _generator)
    lo = _rows(low, shape)
    return (lo + u * (_rows(high, shape) - lo)).to(_dt(dtype))


@register_op("_sample_normal", differentiable=False, needs_rng=True,
             aliases=["sample_normal"])
def _sample_normal(mu, sigma, shape=(), dtype="float32", _generator=None):
    """Normal(mu_i, sigma_i) draws."""
    z = torch.randn(_row_shape(mu, shape), generator=_generator,
                    device=_generator.device)
    return (_rows(mu, shape) + z * _rows(sigma, shape)).to(_dt(dtype))


@register_op("_sample_gamma", differentiable=False, needs_rng=True,
             aliases=["sample_gamma"])
def _sample_gamma(alpha, beta, shape=(), dtype="float32", _generator=None):
    """Gamma(alpha_i) * beta_i draws."""
    a = _rows(alpha, shape).expand(_row_shape(alpha, shape)).contiguous()
    return (_gamma(a, _generator) * _rows(beta, shape)).to(_dt(dtype))


@register_op("_sample_exponential", differentiable=False, needs_rng=True,
             aliases=["sample_exponential"])
def _sample_exponential(lam, shape=(), dtype="float32", _generator=None):
    """Exponential draws of rate lam_i."""
    e = torch.empty(_row_shape(lam, shape), device=_generator.device
                    ).exponential_(1.0, generator=_generator)
    return (e / _rows(lam, shape)).to(_dt(dtype))


@register_op("_sample_poisson", differentiable=False, needs_rng=True,
             aliases=["sample_poisson"])
def _sample_poisson(lam, shape=(), dtype="float32", _generator=None):
    """Poisson(lam_i) draws."""
    rate = _rows(lam, shape).expand(_row_shape(lam, shape)).contiguous()
    return torch.poisson(rate, generator=_generator).to(_dt(dtype))


@register_op("_sample_negative_binomial", differentiable=False,
             needs_rng=True, aliases=["sample_negative_binomial"])
def _sample_negative_binomial(k, p, shape=(), dtype="float32",
                              _generator=None):
    """NegativeBinomial(k_i, p_i) draws."""
    return _gamma_poisson(_rows(k, shape), _rows(p, shape),
                          _row_shape(k, shape), _generator).to(_dt(dtype))


@register_op("_sample_generalized_negative_binomial", differentiable=False,
             needs_rng=True, aliases=["sample_generalized_negative_binomial"])
def _sample_generalized_negative_binomial(mu, alpha, shape=(),
                                          dtype="float32", _generator=None):
    """Generalized negative binomial (mu_i, alpha_i) draws."""
    r = 1.0 / _rows(alpha, shape)
    p = r / (r + _rows(mu, shape))
    return _gamma_poisson(r, p, _row_shape(mu, shape),
                          _generator).to(_dt(dtype))


@register_op("_sample_multinomial", differentiable=False, needs_rng=True,
             aliases=["sample_multinomial"])
def _sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                        _generator=None):
    """``shape`` categorical draws per row of probabilities ``data``
    (and, with ``get_prob``, their log-probabilities)."""
    k = data.shape[-1]
    rows = data.reshape(-1, k).float().clamp(min=1e-20)
    n = math.prod(_shape(shape)) or 1
    flat = torch.multinomial(rows, n, replacement=True, generator=_generator)
    out_shape = tuple(data.shape[:-1]) + _shape(shape)
    samp = flat.reshape(out_shape).to(_dt(dtype, "int32"))
    if get_prob:
        lp = torch.gather(torch.log_softmax(torch.log(rows), -1), 1, flat)
        return samp, lp.reshape(out_shape)
    return samp


@register_op("_sample_unique_zipfian", n_out=2, differentiable=False,
             needs_rng=True, aliases=["sample_unique_zipfian"])
def _sample_unique_zipfian(range_max=1, shape=(1,), _generator=None):
    """Log-uniform (Zipfian) candidates in [0, range_max) and the draw
    count, as the JAX package's fixed draw gives them."""
    shp = _shape(shape)
    u = _uniform(shp, _generator)
    samples = torch.exp(u * math.log(float(range_max) + 1.0)) - 1.0
    samples = samples.to(torch.int32).clamp(0, range_max - 1)
    tries = torch.full((), shp[-1] if shp else 1, dtype=torch.int32,
                       device=_generator.device)
    return samples, tries


@register_op("_shuffle", differentiable=False, needs_rng=True,
             aliases=["shuffle"])
def _shuffle(data, _generator=None):
    """The rows of ``data`` in a random order."""
    perm = torch.randperm(data.shape[0], generator=_generator,
                          device=_generator.device)
    return data[perm.to(data.device)]


# -- _random_pdf_*: densities, differentiable ---------------------------------

def _pdf_param(sample, param):
    extra = sample.dim() - param.dim()
    return param.reshape(tuple(param.shape) + (1,) * extra) \
        if extra > 0 else param


def _maybe_exp(logpdf, is_log):
    return logpdf if is_log else torch.exp(logpdf)


@register_op("_random_pdf_uniform")
def _random_pdf_uniform(sample, low, high, is_log=False):
    """Uniform[low, high) density at ``sample``."""
    low, high = _pdf_param(sample, low), _pdf_param(sample, high)
    inside = (sample >= low) & (sample <= high)
    logpdf = torch.where(inside, -torch.log(high - low),
                         torch.full((), float("-inf"), device=sample.device))
    return _maybe_exp(logpdf, is_log)


@register_op("_random_pdf_normal")
def _random_pdf_normal(sample, mu, sigma, is_log=False):
    """Normal(mu, sigma) density at ``sample``."""
    mu, sigma = _pdf_param(sample, mu), _pdf_param(sample, sigma)
    z = (sample - mu) / sigma
    logpdf = -0.5 * z * z - torch.log(sigma) - 0.5 * math.log(2 * math.pi)
    return _maybe_exp(logpdf, is_log)


@register_op("_random_pdf_gamma")
def _random_pdf_gamma(sample, alpha, beta, is_log=False):
    """Gamma(alpha, scale beta) density at ``sample``."""
    alpha, beta = _pdf_param(sample, alpha), _pdf_param(sample, beta)
    logpdf = (alpha * -torch.log(beta) + (alpha - 1) * torch.log(sample)
              - sample / beta - torch.lgamma(alpha))
    return _maybe_exp(logpdf, is_log)


@register_op("_random_pdf_exponential")
def _random_pdf_exponential(sample, lam, is_log=False):
    """Exponential(rate lam) density at ``sample``."""
    lam = _pdf_param(sample, lam)
    return _maybe_exp(torch.log(lam) - lam * sample, is_log)


@register_op("_random_pdf_poisson")
def _random_pdf_poisson(sample, lam, is_log=False):
    """Poisson(lam) mass at ``sample``."""
    lam = _pdf_param(sample, lam)
    logpdf = sample * torch.log(lam) - lam - torch.lgamma(sample + 1.0)
    return _maybe_exp(logpdf, is_log)


def _nb_logpdf(sample, r, p):
    return (torch.lgamma(sample + r) - torch.lgamma(sample + 1.0)
            - torch.lgamma(r) + r * torch.log(p) + sample * torch.log1p(-p))


@register_op("_random_pdf_negative_binomial")
def _random_pdf_negative_binomial(sample, k, p, is_log=False):
    """NegativeBinomial(k, p) mass at ``sample``."""
    return _maybe_exp(_nb_logpdf(sample, _pdf_param(sample, k),
                                 _pdf_param(sample, p)), is_log)


@register_op("_random_pdf_generalized_negative_binomial")
def _random_pdf_generalized_negative_binomial(sample, mu, alpha,
                                              is_log=False):
    """Generalized negative binomial (mu, alpha) mass at ``sample``."""
    mu, alpha = _pdf_param(sample, mu), _pdf_param(sample, alpha)
    r = 1.0 / alpha
    return _maybe_exp(_nb_logpdf(sample, r, r / (r + mu)), is_log)


@register_op("_random_pdf_dirichlet")
def _random_pdf_dirichlet(sample, alpha, is_log=False):
    """Dirichlet(alpha) density at the simplex rows of ``sample``."""
    a = alpha
    while a.dim() < sample.dim():
        a = a.unsqueeze(-2)
    logpdf = (torch.sum((a - 1.0) * torch.log(sample), -1)
              + torch.lgamma(torch.sum(a, -1))
              - torch.sum(torch.lgamma(a), -1))
    return _maybe_exp(logpdf, is_log)
