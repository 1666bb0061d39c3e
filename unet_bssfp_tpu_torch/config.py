"""Typed configuration: the JAX package's dataclasses, same defaults and JSON
keys, so one config file drives both packages.

Knobs that only shape the TPU program (``folded``, ``wpack_mid``,
``disc_folded``, ``process_split``, ``rng_impl``) are read and ignored here.
``packed`` and ``use_pallas`` keep their meaning: ``packed`` routes the
generator's two full-resolution stages through the packed conv kernel
(``ops.kernels.conv3d``), ``use_pallas`` routes InstanceNorm+LeakyReLU
through the fused norm kernel (``ops.kernels.norm_act``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

MODALITIES = ("dwi-tensor", "pc-bssfp", "bssfp", "t1w")

# Channel counts per modality: pc-bSSFP 24ch, DT 6ch, T1w repeated to 6ch.
MODALITY_CHANNELS = {
    "dwi-tensor": 6,
    "pc-bssfp": 24,
    "bssfp": 24,
    "t1w": 6,
}

# Modalities sharing an input-head parameter subtree.
HEAD_GROUPS = {
    "dwi-tensor": "head6",
    "t1w": "head6",
    "pc-bssfp": "head24",
    "bssfp": "head24",
}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    data_dir: str = ""
    derivatives: str = "derivatives/preproc-dove"
    batch_size: int = 8
    test_split: float = 0.1
    val_split: float = 0.1
    num_workers: int = 8
    max_queue_len: int = 16
    samples_per_vol: int = 8
    patch_size: int = 64
    seed: int = 42
    # CropOrPad target.
    volume_shape: Tuple[int, int, int] = (96, 128, 128)
    desc_dwi: str = "normtensor"
    desc_pc_bssfp: str = "normflatbet"
    desc_bssfp: str = "nfbnopc"
    desc_t1w: str = "normrepeat"
    augment_prob: float = 0.1
    # Whole (96,128,128) volumes instead of 64³ patches; also the default
    # inference mode of a model trained that way.
    whole_volume: bool = False
    cache_volumes: bool = False
    # In a process group (parallel.distributed) each process loads only its
    # stride-slice of the sample lists and batch_size is per process. No
    # effect with one process.
    process_split: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    features: Tuple[int, ...] = (32, 64, 128, 256, 512, 32)
    dropout: float = 0.05
    unet_in_channels: int = 24
    out_channels: int = 6
    unet_negative_slope: float = 0.1
    disc_negative_slope: float = 0.2
    disc_features: Tuple[int, ...] = (32, 64, 128, 256, 512)
    # "bfloat16" or "float32" (parity with the reference's fp32 training).
    compute_dtype: str = "bfloat16"
    multistage_features: Optional[Tuple[int, ...]] = None
    # Fused InstanceNorm+LeakyReLU kernel in the generator.
    use_pallas: bool = False
    remat: bool = False
    folded: Optional[bool] = None  # TPU layout; ignored
    # Packed conv kernel for the two full-resolution stages; None = auto
    # (on iff the device is CUDA, ``train.state.auto_packed``).
    packed: Optional[bool] = None
    wpack_mid: bool = False  # TPU layout; ignored
    disc_folded: Optional[bool] = None  # TPU layout; ignored
    # The generator's backbone: "basic_unet" (``features``) or "swin_unetr"
    # (SwinUNETR, MONAI v1, at ``swin_feature_size`` and MONAI's BTCV depths,
    # heads, window, patch and MLP ratio; the port's alone: the JAX package
    # reads and ignores these keys).
    backbone: str = "basic_unet"
    swin_feature_size: int = 48


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    perceptual_factor: float = 1e3
    recon_factor: float = 1e2
    max_epochs: int = 50
    early_stop_monitor: str = "val_gen_loss_recon"
    early_stop_patience: int = 10
    checkpoint_monitor: str = "val_loss"
    checkpoint_top_k: int = 10
    checkpoint_dir: str = "logs/checkpoints"
    log_dir: str = "logs"
    seed: int = 42
    finetune_lr: float = 1e-5
    # Axes of the mesh a caller builds with ``parallel.mesh.make_mesh``:
    # ("data",) or ("data", "space"). Serving takes a mesh today
    # (``make_predict_fn(gen, mesh)``, ``predict --mesh``); the train step
    # does not yet.
    mesh_axes: Tuple[str, ...] = ("data",)
    wandb_project: Optional[str] = None
    with_perceptual: Optional[bool] = None
    reuse_fake: bool = False
    rng_impl: str = "rbg"  # JAX PRNG choice; ignored
    medicalnet_weights: Optional[str] = None
    perceptual_chunk: Optional[int] = None
    perceptual_dtype: Optional[str] = None
    log_clean_val: bool = False


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    pred_dir: str = "preds"
    rescale_args_dwi: str = "rescale_args_dwi.txt"
    out_csv: str = "relative_errors.csv"
    roi_names: Tuple[str, ...] = ("CSF", "GM", "WM")


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)

        def _mk(cls, d):
            fields = {f.name for f in dataclasses.fields(cls)}
            kw = {k: v for k, v in d.items() if k in fields}
            for k, v in kw.items():
                if isinstance(v, list):
                    kw[k] = tuple(v)
            return cls(**kw)

        return Config(
            data=_mk(DataConfig, raw.get("data", {})),
            model=_mk(ModelConfig, raw.get("model", {})),
            train=_mk(TrainConfig, raw.get("train", {})),
            eval=_mk(EvalConfig, raw.get("eval", {})),
        )
