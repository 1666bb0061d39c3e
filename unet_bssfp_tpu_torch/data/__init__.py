"""Volume I/O, BIDS discovery, preprocessing, augmentation, patch sampling
and the batch streams (the JAX package's ``data`` exports)."""

from unet_bssfp_tpu_torch.data.bids import BIDSIndex, parse_entities
from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule, SampleSpec
from unet_bssfp_tpu_torch.data.queue import PrefetchIterator
from unet_bssfp_tpu_torch.data.sampler import (
    GridAggregator,
    extract_patches,
    grid_patch_starts,
    uniform_patch_starts,
)
from unet_bssfp_tpu_torch.data.transforms import crop_or_pad, rescale_intensity, znormalize

__all__ = [
    "BIDSIndex",
    "parse_entities",
    "DoveDataModule",
    "SampleSpec",
    "crop_or_pad",
    "rescale_intensity",
    "znormalize",
    "uniform_patch_starts",
    "extract_patches",
    "grid_patch_starts",
    "GridAggregator",
    "PrefetchIterator",
]
