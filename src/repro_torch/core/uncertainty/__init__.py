"""Uncertainty helpers (counterpart of ``repro.core.uncertainty``).

Only the scoring helpers the default simulation needs are ported; the
conformal calibration modules are still to port."""
from repro_torch.core.uncertainty.scoring import (bucket_pow2,
                                                  gaussian_quantile_scale,
                                                  sigma_from_var,
                                                  sigma_from_var_np)

__all__ = ["sigma_from_var", "sigma_from_var_np", "bucket_pow2",
           "gaussian_quantile_scale"]
