"""Training-side optimisation (port of ``repro/optim``): AdamW over
params trees with ``FixedMaskTensor`` leaves, GMP schedules, and the
sparse-aware update (re-sparsification after each step)."""

from repro_torch.optim.gmp import GMPSchedule, gmp_sparsity
from repro_torch.optim.optimizers import AdamWConfig, adamw_init, \
    adamw_update, clip_by_global_norm
from repro_torch.optim.sparse_update import resparsify_params, \
    resparsify_params_, sparse_aware_update

__all__ = ["GMPSchedule", "gmp_sparsity", "AdamWConfig", "adamw_init",
           "adamw_update", "clip_by_global_norm", "resparsify_params",
           "resparsify_params_",
           "sparse_aware_update"]
