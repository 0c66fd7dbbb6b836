"""Optimizer kernels of the port."""
from .kernels import (LAUNCHES, capacity,  # noqa: F401
                      mp_sgd_mom_update_kernel,
                      mp_sgd_mom_update_multi_kernel,
                      mp_sgd_mom_update_multi_ref, mp_sgd_mom_update_ref)

__all__ = ["mp_sgd_mom_update_kernel", "mp_sgd_mom_update_ref",
           "mp_sgd_mom_update_multi_kernel", "mp_sgd_mom_update_multi_ref",
           "capacity", "LAUNCHES"]
