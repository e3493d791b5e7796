"""SparsityBuilder, weight rules only (port of ``repro/core/builder.py``).

Params are nested dicts; a leaf's name is its ``a.b.c``-joined key path
and rules match it with fnmatch globs, as in the reference.  A rule's
output format defaults to ``FixedMaskTensor`` (masked training), as in
the reference, except for a ``GroupedNMSparsifier``, whose masked-dense
form is not ported: it defaults to ``GroupedNMTensor``.  Intermediate
sparsity plans (``tag``) are not ported: the reference's ``tag`` is the
identity when no plan is active, so the port's model has no tag sites.
"""

from __future__ import annotations

import dataclasses
import fnmatch

import torch

from repro_torch.core.layouts import FixedMaskTensor, GroupedNMTensor
from repro_torch.core.sparsifiers import GroupedNMSparsifier, \
    apply_sparsifier

__all__ = ["SparsityBuilder", "path_name"]


def path_name(path) -> str:
    """Join a key path into an 'a.b.c' name."""
    return ".".join(str(p) for p in path)


@dataclasses.dataclass
class WeightRule:
    pattern: str
    initial_sparsifier: object
    out_format: type


class SparsityBuilder:
    """Paper §3.4 API, weight half: mark weights sparse, then convert a
    params tree."""

    def __init__(self):
        self._weights: list = []

    def set_weight(self, name: str, initial_sparsifier, out_format=None):
        if out_format is None:
            out_format = GroupedNMTensor if isinstance(
                initial_sparsifier, GroupedNMSparsifier) else FixedMaskTensor
        self._weights.append(WeightRule(name, initial_sparsifier, out_format))
        return self

    def _rule_for(self, name: str):
        for r in self._weights:
            if fnmatch.fnmatch(name, r.pattern):
                return r
        return None

    def sparsify_params(self, params):
        """Replace matching leaves by sparse layouts.  A scan-stacked
        [L, K, N] leaf is sparsified per layer (the paper's local pruning)
        and re-stacked on a leading [L] axis.  (A later GMP recompute of a
        magnitude-pruned leaf is global across its layers, as in the
        reference: ``unstructured_mask`` flattens the whole leaf.)"""

        def visit(tree, path):
            if isinstance(tree, dict):
                return {k: visit(v, path + (k,)) for k, v in tree.items()}
            rule = self._rule_for(path_name(path))
            if rule is None or not isinstance(tree, torch.Tensor):
                return tree
            if tree.ndim == 3:
                return _STACK[rule.out_format]([
                    apply_sparsifier(rule.initial_sparsifier, tree[i],
                                     rule.out_format)
                    for i in range(tree.shape[0])
                ])
            return apply_sparsifier(rule.initial_sparsifier, tree,
                                    rule.out_format)

        return visit(params, ())


_STACK = {GroupedNMTensor: GroupedNMTensor.stack,
          FixedMaskTensor: FixedMaskTensor.stack}
