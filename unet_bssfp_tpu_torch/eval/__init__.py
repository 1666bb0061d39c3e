"""Volume inference, the test loop and checkpoint-driven evaluation, and the
prediction post-processing chain."""

from unet_bssfp_tpu_torch.eval.evaluate import (
    calc_diff_maps,
    calc_error_table,
    calc_scalar_maps,
    eval_dwi_tensors,
    eval_model,
    gen_predictions,
    invert_dwi_tensor_norm_files,
)
from unet_bssfp_tpu_torch.eval.inference import predict_volume, run_test

__all__ = [
    "predict_volume",
    "run_test",
    "eval_model",
    "gen_predictions",
    "eval_dwi_tensors",
    "calc_scalar_maps",
    "calc_diff_maps",
    "calc_error_table",
    "invert_dwi_tensor_norm_files",
]
