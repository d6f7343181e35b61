"""Uncertainty calibration and risk-aware safeguards (counterpart of
``repro.core.uncertainty``): proper scoring metrics and the shared
variance -> sigma clamp (``scoring``), online split-conformal
calibration of the safeguard's band (``conformal``), the adaptive
target-quantile controller (``adaptive``) and the engines' calibration
loop (``online``)."""
from repro_torch.core.uncertainty.adaptive import QuantileController
from repro_torch.core.uncertainty.conformal import (CalibrationConfig,
                                                    ConformalForecaster,
                                                    ScoreBuffer, conformal_scale,
                                                    conformal_scale_ring)
from repro_torch.core.uncertainty.online import (CalibState, OnlineCalibrator,
                                                 calib_group_report, calib_init,
                                                 calib_observe, calib_observe_groups,
                                                 calib_report,
                                                 calib_scales_begin)
from repro_torch.core.uncertainty.scoring import (bucket_pow2, crps_empirical,
                                                  crps_gaussian, empirical_coverage,
                                                  gaussian_quantile_scale, pinball_loss,
                                                  sigma_from_var, sigma_from_var_np)

__all__ = [
    "sigma_from_var", "sigma_from_var_np", "bucket_pow2",
    "gaussian_quantile_scale", "empirical_coverage",
    "pinball_loss", "crps_gaussian", "crps_empirical",
    "CalibrationConfig", "conformal_scale", "conformal_scale_ring",
    "ScoreBuffer", "ConformalForecaster", "QuantileController",
    "OnlineCalibrator", "CalibState", "calib_init", "calib_observe",
    "calib_observe_groups", "calib_scales_begin", "calib_report", "calib_group_report",
]
