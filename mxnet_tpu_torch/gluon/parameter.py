"""Parameters of a model under the JAX package's names.

The port keeps no Parameter class of its own: a parameter is a
``torch.nn.Parameter``, ``requires_grad=False`` stands in for
``grad_req="null"``, and shapes are known when a layer is built (no
deferred initialization). :func:`collect_params` names them as the JAX
package's ``_collect_params_with_prefix()`` does, so that a Trainer, a
checkpoint or a test addresses them in one naming on both sides.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

from torch import nn

from .nn.basic_layers import LayerNorm

__all__ = ["collect_params", "JAX_NAMES"]

# LayerNorm's parameters: the port's (PyTorch's) name -> the JAX package's
JAX_NAMES = {"weight": "gamma", "bias": "beta"}


def collect_params(module: nn.Module) -> Dict[str, nn.Parameter]:
    """``{JAX package name: parameter}`` of ``module``, in module order
    (``layers.0.attn.qkv.weight``, ``ln_f.gamma``, ...)."""
    out: "OrderedDict[str, nn.Parameter]" = OrderedDict()
    for mod_name, mod in module.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, LayerNorm):
                p_name = JAX_NAMES[p_name]
            out[f"{mod_name}.{p_name}" if mod_name else p_name] = p
    return out
