"""The ``sten``-style user API (paper §3) in one namespace, as the
reference's ``repro.sten``.

>>> from repro_torch import sten
>>> w = sten.dense_to_grouped_nm(W, n=1, m=4, g=16, sparse_dim=0)
>>> y = sten.linear(x, w)                       # the n:m:g kernels
>>> sb = sten.SparsityBuilder()
>>> sb.set_weight("*mlp.wi", sten.GroupedNMSparsifier(1, 4, 16))
>>> sparse_params, apply = sb.get_sparse_model(params, model_apply)
"""

from repro_torch.core import *  # noqa: F401,F403
from repro_torch.core import (  # noqa: F401  (explicit re-exports)
    SparsityBuilder,
    register_layout,
    register_op_impl,
    register_sparsifier_implementation,
    sparsified_op,
)


def torch_tensor_to_csr(sparsifier, x):
    """Paper §3.1 spelling: sparsify a dense tensor to CSR."""
    from repro_torch.core.layouts import CsrTensor
    from repro_torch.core.sparsifiers import apply_sparsifier

    return apply_sparsifier(sparsifier, x, CsrTensor)
