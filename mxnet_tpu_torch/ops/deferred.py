"""Registered stubs: every op of the JAX package's registry that the
port has not ported yet raises ``NotImplementedError`` naming the ROADMAP
item it waits for, so that a missing op never surfaces as an
``AttributeError`` (``nd.linalg_gemm``, ...).
"""
from __future__ import annotations

from .registry import stub_op

__all__ = ["WAITING"]

# what each group waits for -> its op names
WAITING = {
    ("the detection and graph-sampling ops wait with contrib/ (ROADMAP "
     "Queue A item 9)"): (
        "DeformablePSROIPooling",
        "MultiBoxDetection", "MultiBoxPrior", "MultiBoxTarget",
        "MultiProposal", "PSROIPooling", "Proposal", "RROIAlign",
        "_contrib_DeformablePSROIPooling",
        "_contrib_MultiBoxDetection", "_contrib_MultiBoxPrior",
        "_contrib_MultiBoxTarget", "_contrib_MultiProposal",
        "_contrib_PSROIPooling", "_contrib_Proposal", "_contrib_RROIAlign",
        "_contrib_bipartite_matching", "_contrib_box_iou", "_contrib_box_nms",
        "_contrib_box_non_maximum_suppression", "_contrib_count_sketch",
        "_contrib_dgl_adjacency",
        "_contrib_dgl_csr_neighbor_non_uniform_sample",
        "_contrib_dgl_csr_neighbor_uniform_sample",
        "_contrib_dgl_graph_compact", "_contrib_dgl_subgraph",
        "_contrib_edge_id", "_contrib_fft", "_contrib_getnnz",
        "_contrib_gradientmultiplier", "_contrib_hawkesll", "_contrib_ifft",
        "_contrib_index_array", "_contrib_index_copy", "_contrib_quadratic",
        "_npx_multibox_detection", "_npx_multibox_prior",
        "_npx_multibox_target", "bipartite_matching", "box_iou", "box_nms",
        "quadratic",),
    ("the deferred half of the mx.nd slice (ROADMAP Queue A item 1)"): (
        "Custom", "_NDArray", "_Native", "_TensorRT",
        "_contrib_calibrate_entropy", "_contrib_dequantize",
        "_contrib_quantize", "_contrib_quantize_v2", "_contrib_quantized_act",
        "_contrib_quantized_batch_norm", "_contrib_quantized_concat",
        "_contrib_quantized_conv", "_contrib_quantized_elemwise_add",
        "_contrib_quantized_flatten", "_contrib_quantized_fully_connected",
        "_contrib_quantized_pooling", "_contrib_requantize", "_linalg_det",
        "_linalg_extractdiag", "_linalg_extracttrian", "_linalg_gelqf",
        "_linalg_gemm", "_linalg_gemm2", "_linalg_inverse",
        "_linalg_makediag", "_linalg_maketrian", "_linalg_potrf",
        "_linalg_potri", "_linalg_slogdet", "_linalg_sumlogdiag",
        "_linalg_syevd", "_linalg_syrk", "_linalg_trmm", "_linalg_trsm",
        "linalg_det", "linalg_extractdiag",
        "linalg_extracttrian", "linalg_gelqf", "linalg_gemm", "linalg_gemm2",
        "linalg_inverse", "linalg_makediag", "linalg_maketrian",
        "linalg_potrf", "linalg_potri", "linalg_slogdet", "linalg_sumlogdiag",
        "linalg_syevd", "linalg_syrk", "linalg_trmm", "linalg_trsm",),
    ("the graph optimizer's ops wait with the graph optimizer (ROADMAP "
     "Queue A item 5)"): (
        "_fused_group", "_nhwc_conv", "_nhwc_pool", "_subgraph_xla",),
    ("the MoE ops wait with distribution (ROADMAP Queue A item 6)"): (
        "_moe_ffn", "_moe_load_balance_loss",),
    ("numpy/ and its ops wait with the edges (ROADMAP Queue A item 9)"): (
        "_np__random_shuffle", "_np_broadcast_to", "_np_copy",
        "_np_dot", "_np_max", "_np_mean", "_np_min", "_np_ones_like",
        "_np_prod", "_np_repeat", "_np_reshape", "_np_squeeze", "_np_sum",
        "_np_transpose", "_np_zeros_like", "_npi_abs", "_npi_add_scalar",
        "_npi_arange", "_npi_argmax", "_npi_clip", "_npi_concat",
        "_npi_concatenate", "_npi_equal", "_npi_equal_scalar",
        "_npi_expand_dims", "_npi_full", "_npi_gather_nd", "_npi_greater",
        "_npi_greater_equal", "_npi_greater_equal_scalar",
        "_npi_greater_scalar", "_npi_less", "_npi_less_equal",
        "_npi_less_equal_scalar", "_npi_less_scalar", "_npi_linspace",
        "_npi_log", "_npi_logical_not", "_npi_max", "_npi_maximum",
        "_npi_maximum_scalar", "_npi_mean", "_npi_min", "_npi_minimum",
        "_npi_minimum_scalar", "_npi_mod_scalar", "_npi_multinomial",
        "_npi_multiply_scalar", "_npi_normal", "_npi_not_equal",
        "_npi_not_equal_scalar", "_npi_ones", "_npi_power_scalar",
        "_npi_prod", "_npi_randint", "_npi_random_normal",
        "_npi_random_randint", "_npi_random_uniform", "_npi_reshape",
        "_npi_rmod_scalar", "_npi_rpower_scalar",
        "_npi_rsubtract_scalar", "_npi_rtrue_divide_scalar", "_npi_slice",
        "_npi_split", "_npi_stack", "_npi_std", "_npi_subtract_scalar",
        "_npi_sum", "_npi_swapaxes", "_npi_tensordot",
        "_npi_tensordot_int_axes", "_npi_tile", "_npi_true_divide",
        "_npi_true_divide_scalar", "_npi_uniform", "_npi_var", "_npi_zeros",
        ),
}
for _waits, _names in WAITING.items():
    for _name in _names:
        stub_op(_name, _waits)
