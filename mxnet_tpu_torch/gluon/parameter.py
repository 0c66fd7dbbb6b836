"""Parameters of a model under the JAX package's names.

The port keeps no Parameter class of its own: a parameter is a
``torch.nn.Parameter``, ``requires_grad=False`` stands in for
``grad_req="null"`` (BatchNorm's running statistics, and its gamma/beta
where ``scale``/``center`` is off), and shapes are known when a layer is
built (no deferred initialization). A parameter may carry the attributes
the JAX package's ``Parameter`` has: ``_mx_init`` (its own initializer,
which ``Block.initialize`` prefers to the one it is given),
``lr_mult`` and ``wd_mult``, and ``stype``/``grad_stype`` (stored, as the
JAX package's ``Parameter`` stores them: its gradient buffer is dense
whatever they say, ``mxnet_tpu/gluon/parameter.py:101-103``). :func:`collect_params` names them as the JAX
package's ``_collect_params_with_prefix()`` does, so that a Trainer, a
checkpoint or a test addresses them in one naming on both sides.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Optional

import torch
from torch import nn

from .. import initializer as init_mod

__all__ = ["collect_params", "JAX_NAMES", "make_param"]

# a normalization layer's parameters (LayerNorm, BatchNorm): the port's
# (PyTorch's) name -> the JAX package's; a layer class that uses them says
# so in its ``_JAX_NAMES``
JAX_NAMES = {"weight": "gamma", "bias": "beta"}


# the JAX package's default initializer: Uniform(0.07)
_INIT_SCALE = 0.07


def make_param(name, shape, device, dtype, init=None, requires_grad=True,
               stype="default", grad_stype="default") -> nn.Parameter:
    """A parameter of ``shape`` that remembers its own initializer ``init``
    (a registered name, an ``Initializer``, or None for the one
    ``Block.initialize`` is given) and holds its construction-time values:
    ``init``'s for a parameter named ``name`` in the JAX naming, or
    U(-0.07, 0.07) from torch's global generator."""
    p = nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                     requires_grad=requires_grad)
    p._mx_init = init
    p.stype, p.grad_stype = stype, grad_stype
    with torch.no_grad():
        if init is None:
            nn.init.uniform_(p, -_INIT_SCALE, _INIT_SCALE)
        else:
            init_mod.create(init)(name, p.data)
    return p


def collect_params(module: nn.Module, select: Optional[str] = None
                   ) -> Dict[str, nn.Parameter]:
    """``{JAX package name: parameter}`` of ``module``, in module order
    (``layers.0.attn.qkv.weight``, ``ln_f.gamma``,
    ``features.1.running_mean``, ...). ``select`` keeps the names a regular
    expression matches from their start (``re.match``), as the JAX
    package's ``collect_params(select)`` does on its own names: a pattern
    such as ``".*gamma|.*beta|.*bias"`` selects alike in both."""
    pattern = re.compile(select) if select else None
    out: "OrderedDict[str, nn.Parameter]" = OrderedDict()
    for mod_name, mod in module.named_modules():
        renames = getattr(mod, "_JAX_NAMES", None) or {}
        for p_name, p in mod.named_parameters(recurse=False):
            p_name = renames.get(p_name, p_name)
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if pattern is None or pattern.match(name):
                out[name] = p
    return out
