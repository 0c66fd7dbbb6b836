"""Optimizer kernels of the port."""
from .kernels import (LAUNCHES, mp_sgd_mom_update_kernel,  # noqa: F401
                      mp_sgd_mom_update_ref)

__all__ = ["mp_sgd_mom_update_kernel", "mp_sgd_mom_update_ref", "LAUNCHES"]
