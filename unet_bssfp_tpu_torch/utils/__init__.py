from unet_bssfp_tpu_torch.utils.debug import check_finite_fn, enable_nan_checks
from unet_bssfp_tpu_torch.utils.profiling import span, trace
from unet_bssfp_tpu_torch.utils.watchdog import WatchdogResult, run_with_watchdog

__all__ = [
    "span", "trace", "enable_nan_checks", "check_finite_fn",
    "run_with_watchdog", "WatchdogResult",
]
