"""The port's sparsity programming model (paper §3): layouts, lossless
conversions, dispatch and sparse operators, sparsifiers, the
SparsityBuilder with its intermediate and gradient plans, and the n:m:g
conversion, under the reference's names (``repro/core/__init__.py``)."""

from repro_torch.core.layouts import (
    CooTensor,
    CsrTensor,
    DenseTensor,
    FixedMaskTensor,
    GroupedNMTensor,
    NMTensor,
    SparsityLayout,
    all_layouts,
    nm_patterns,
    register_layout,
)
from repro_torch.core.sparsifiers import (
    BlockwiseFractionSparsifier,
    GroupedNMSparsifier,
    KeepAll,
    NMSparsifier,
    RandomFractionSparsifier,
    SameFormatSparsifier,
    ScalarFractionSparsifier,
    ScalarThresholdSparsifier,
    Sparsifier,
    apply_sparsifier,
    register_sparsifier_implementation,
)
from repro_torch.core.convert import as_layout, convert, lossless_targets
from repro_torch.core.dispatch import (
    OutFormat,
    SparseFallbackWarning,
    dispatch,
    register_op_impl,
    register_patched_op,
    sparse_op_table,
    sparsified_op,
)
from repro_torch.core import ops  # registers the built-in implementations
from repro_torch.core.ops import add, gelu, linear, matmul, relu
from repro_torch.core.builder import (
    SparsityBuilder,
    SparsityPlan,
    flatten_with_names,
    tag,
    trace_intermediates,
)
from repro_torch.core.autograd import (
    dense_grad_of,
    masked_grad,
    sparsify_grads,
    straight_through,
)
from repro_torch.core.nmg import (
    dense_to_grouped_nm,
    energy,
    grouped_nm_mask,
    grouped_nm_to_dense,
    nm_mask,
    unstructured_mask,
)
