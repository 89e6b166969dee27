"""Evaluation of the port (numpy): metrics, reports, calibration fits,
PCM forensics and loop-match images."""
from omniswarm_torch.eval.calibration import (  # noqa: F401
    UWBCalibration,
    apply_uwb_calibrations,
    fit_uwb_calibration,
    loop_error_stats,
    odometry_covariance_per_meter,
    uwb_pair_calibrations,
)
from omniswarm_torch.eval.metrics import (  # noqa: F401
    align_first_pose,
    align_yaw_translation,
    ate_pos,
    mean_relative_ate,
    relative_ate,
    rmse,
    yaw_rmse,
)
