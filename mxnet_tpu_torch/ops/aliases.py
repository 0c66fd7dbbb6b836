"""Other names of ported ops: the legacy operator names (``_Plus``,
``_MulScalar``, ...), the numpy-style ``_npi_``/``_npx_`` names and the
samplers' short names, each an alias of the op it names in the JAX
package, and the three legacy scalar ops that have no other name.

Counterpart of ``mxnet_tpu/ops/legacy_aliases.py`` and of the aliases
``mxnet_tpu/ops/numpy_ops.py`` gives ported ops.
"""
from __future__ import annotations

import torch

from .registry import _OPS, register_op

__all__ = []


register_op("_hypot_scalar", doc="Elementwise hypot(data, scalar) in the "
            "data dtype.")(
    lambda data, scalar=0.0: torch.hypot(
        data, torch.tensor(float(scalar), dtype=data.dtype,
                           device=data.device)))
for _lname, _lfn in (("and", torch.logical_and), ("or", torch.logical_or),
                     ("xor", torch.logical_xor)):
    register_op(f"_logical_{_lname}_scalar", differentiable=False,
                doc=f"Elementwise logical {_lname} against a scalar; 0/1 "
                    f"in the data dtype.")(
        (lambda f: lambda data, scalar=0.0: f(
            data, torch.tensor(scalar, device=data.device)).to(data.dtype))(
            _lfn))
for _new, _old in (("_HypotScalar", "_hypot_scalar"),
                   ("_LogicalAndScalar", "_logical_and_scalar"),
                   ("_LogicalOrScalar", "_logical_or_scalar"),
                   ("_LogicalXorScalar", "_logical_xor_scalar")):
    _OPS[_new] = _OPS[_old]

# alias -> the ported op it names
ALIASES = {
    "CuDNNBatchNorm": "BatchNorm",
    "MakeLoss": "make_loss",
    "_CrossDeviceCopy": "_copy",
    "_Div": "elemwise_div",
    "_DivScalar": "_div_scalar",
    "_Equal": "broadcast_equal",
    "_EqualScalar": "_equal_scalar",
    "_Greater": "broadcast_greater",
    "_GreaterEqualScalar": "_greater_equal_scalar",
    "_GreaterScalar": "_greater_scalar",
    "_Greater_Equal": "broadcast_greater_equal",
    "_Hypot": "elemwise_hypot",
    "_Lesser": "broadcast_lesser",
    "_LesserEqualScalar": "_lesser_equal_scalar",
    "_LesserScalar": "_lesser_scalar",
    "_Lesser_Equal": "broadcast_lesser_equal",
    "_Logical_And": "broadcast_logical_and",
    "_Logical_Or": "broadcast_logical_or",
    "_Logical_Xor": "broadcast_logical_xor",
    "_Maximum": "elemwise_maximum",
    "_MaximumScalar": "_maximum_scalar",
    "_Minimum": "elemwise_minimum",
    "_MinimumScalar": "_minimum_scalar",
    "_Minus": "elemwise_sub",
    "_MinusScalar": "_minus_scalar",
    "_Mod": "elemwise_mod",
    "_ModScalar": "_mod_scalar",
    "_Mul": "elemwise_mul",
    "_MulScalar": "_mul_scalar",
    "_NotEqualScalar": "_not_equal_scalar",
    "_Not_Equal": "broadcast_not_equal",
    "_PlusScalar": "_plus_scalar",
    "_Power": "elemwise_power",
    "_PowerScalar": "_power_scalar",
    "_RDivScalar": "_rdiv_scalar",
    "_RMinusScalar": "_rminus_scalar",
    "_RModScalar": "_rmod_scalar",
    "_RPowerScalar": "_rpower_scalar",
    "_equal": "broadcast_equal",
    "_greater": "broadcast_greater",
    "_greater_equal": "broadcast_greater_equal",
    "_lesser": "broadcast_lesser",
    "_lesser_equal": "broadcast_lesser_equal",
    "_logical_and": "broadcast_logical_and",
    "_logical_or": "broadcast_logical_or",
    "_logical_xor": "broadcast_logical_xor",
    "_minus": "elemwise_sub",
    "_not_equal": "broadcast_not_equal",
    "_npi_absolute": "abs",
    "_npi_add": "broadcast_add",
    "_npi_arccos": "arccos",
    "_npi_arccosh": "arccosh",
    "_npi_arcsin": "arcsin",
    "_npi_arcsinh": "arcsinh",
    "_npi_arctan": "arctan",
    "_npi_arctanh": "arctanh",
    "_npi_cbrt": "cbrt",
    "_npi_ceil": "ceil",
    "_npi_cos": "cos",
    "_npi_cosh": "cosh",
    "_npi_degrees": "degrees",
    "_npi_exp": "exp",
    "_npi_expm1": "expm1",
    "_npi_fix": "fix",
    "_npi_floor": "floor",
    "_npi_log10": "log10",
    "_npi_log1p": "log1p",
    "_npi_log2": "log2",
    "_npi_mod": "broadcast_mod",
    "_npi_multiply": "broadcast_mul",
    "_npi_negative": "negative",
    "_npi_power": "broadcast_power",
    "_npi_radians": "radians",
    "_npi_reciprocal": "reciprocal",
    "_npi_rint": "rint",
    "_npi_sign": "sign",
    "_npi_sin": "sin",
    "_npi_sinh": "sinh",
    "_npi_sqrt": "sqrt",
    "_npi_square": "square",
    "_npi_subtract": "broadcast_sub",
    "_npi_tan": "tan",
    "_npi_tanh": "tanh",
    "_npi_trunc": "trunc",
    "_npx_activation": "Activation",
    "_npx_batch_dot": "batch_dot",
    "_npx_batch_flatten": "Flatten",
    "_npx_batch_norm": "BatchNorm",
    "_npx_cast": "cast",
    "_npx_convolution": "Convolution",
    "_npx_deconvolution": "Deconvolution",
    "_npx_dropout": "Dropout",
    "_npx_embedding": "Embedding",
    "_npx_fully_connected": "FullyConnected",
    "_npx_gamma": "gamma",
    "_npx_layer_norm": "LayerNorm",
    "_npx_leaky_relu": "LeakyReLU",
    "_npx_log_softmax": "log_softmax",
    "_npx_one_hot": "one_hot",
    "_npx_pick": "pick",
    "_npx_pooling": "Pooling",
    "_npx_relu": "relu",
    "_npx_reshape_like": "reshape_like",
    "_npx_roi_pooling": "ROIPooling",
    "_npx_sequence_mask": "SequenceMask",
    "_npx_sigmoid": "sigmoid",
    "_npx_slice": "slice",
    "_npx_smooth_l1": "smooth_l1",
    "_npx_softmax": "softmax",
    "_npx_topk": "topk",
    "_plus": "elemwise_add",
    "_scatter_elemwise_div": "elemwise_div",
    "_scatter_minus_scalar": "_minus_scalar",
    "_scatter_plus_scalar": "_plus_scalar",
    "_sg_mkldnn_conv": "Convolution",
    "_sg_mkldnn_fully_connected": "FullyConnected",
    "broadcast_minus": "broadcast_sub",
    "broadcast_plus": "broadcast_add",
    "choose_element_0index": "pick",
    "crop": "Crop",
    "exponential": "_random_exponential",
    "generalized_negative_binomial": "_random_generalized_negative_binomial",
    "negative_binomial": "_random_negative_binomial",
    "normal": "_random_normal",
    "poisson": "_random_poisson",
    "ravel_multi_index": "_ravel_multi_index",
    "uniform": "_random_uniform",
    "unravel_index": "_unravel_index",
}
for _new, _old in ALIASES.items():
    _OPS.setdefault(_new, _OPS[_old])
