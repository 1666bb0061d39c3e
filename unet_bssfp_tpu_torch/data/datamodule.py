"""DoveDataModule: BIDS discovery, the subject split, pairing and the batch
streams (counterpart of ``unet_bssfp_tpu/data/datamodule.py``, the
reference's ``DoveDataModule``, ``src/data_module.py:9-202``), with the
same knobs: batch 8, patch 64, 8 samples a volume, 8 workers, seed 42,
splits 80/10/10.

- :meth:`DoveDataModule.prepare_data` walks the BIDS
  ``derivatives/preproc-dove`` scope, splits by subject
  (:func:`~unet_bssfp_tpu_torch.data.bids.subject_split`, the JAX package's
  draw) and pairs each subject's files across sessions: every DT file ×
  every bSSFP index (reference ``src/data_module.py:108-117``).
- :meth:`train_batches` / :meth:`val_batches` load volumes on host threads
  (the native NIfTI codec releases the GIL), crop-or-pad them to (96, 128,
  128) on the host, move them to the device (through pinned buffers,
  :func:`stage`), augment them there
  (``data.augment``, the pristine target kept as ``dwi-tensor_orig``), cut
  64³ patches and stream channels-last batches.
- :meth:`test_volumes` gives preprocessed whole volumes for stitched
  inference (reference ``src/data_module.py:148-150``).

In a process group (``parallel.distributed``) with ``process_split`` each
process keeps only its stride-slice ``samples[rank::world]`` of the three
identically ordered lists, as the JAX package's module does, and
``batch_size`` is per process. Each stream first compares its batch plan
(full batches and the last one's size) across the processes, so that a
process that would take another number of steps raises on every process
instead of leaving the others waiting on a collective.

Streams take a seed (or a ``torch.Generator`` to draw one from) where the
JAX package takes a key. The sample order comes from the seed; each
sample's augmentation and patch corners from generators derived from
(seed, the sample's index in the whole list, whichever process holds it),
never from the order in which threads reach them, so
a stream repeats bit for bit, prefetched or not. With prefetch on a CUDA
device, a background thread builds the batches on its own CUDA stream; the
consumer's stream waits on an event recorded after each batch and the
batch's memory is marked as used by the consumer's stream
(``record_stream``), so the caching allocator does not hand it back to the
builder while the consumer still reads it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from unet_bssfp_tpu_torch.config import DataConfig
from unet_bssfp_tpu_torch.data.augment import augment_subject
from unet_bssfp_tpu_torch.data.bids import BIDSIndex, subject_split
from unet_bssfp_tpu_torch.data.nifti import load_volume
from unet_bssfp_tpu_torch.data.queue import PrefetchIterator, parallel_map
from unet_bssfp_tpu_torch.data.sampler import extract_patches, uniform_patch_starts
from unet_bssfp_tpu_torch.data.transforms import crop_or_pad
from unet_bssfp_tpu_torch.parallel import distributed
from unet_bssfp_tpu_torch.train.state import resolve_device

ALL_KEYS = ("dwi-tensor", "pc-bssfp", "bssfp", "t1w")
PREFETCH = 2  # batches the background thread stays ahead

Seed = Union[int, torch.Generator]
Device = Union[str, torch.device, None]


@dataclasses.dataclass(frozen=True)
class SampleSpec:
    """One paired training sample: file path per modality key."""

    subject: str
    paths: Dict[str, str]

    def path(self, key: str) -> str:
        return self.paths[key]


def sample_generator(seed: int, index: int, stream: int) -> torch.Generator:
    """A CPU generator for sample ``index`` of a stream seeded ``seed``:
    ``stream`` 0 draws its augmentation, 1 its patch corners."""
    state = np.random.SeedSequence([seed, index, stream]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed((int(state[0]) << 31) ^ int(state[1]))


def _as_seed(seed: Seed) -> int:
    if isinstance(seed, torch.Generator):
        return int(torch.randint(0, 2 ** 62, (), generator=seed))
    return int(seed)


class DoveDataModule:
    def __init__(self, data_dir: str, config: Optional[DataConfig] = None, **kw):
        if config is None:
            config = DataConfig(data_dir=data_dir, **kw)
        else:
            config = dataclasses.replace(config, data_dir=data_dir, **kw)
        self.config = config
        self.name = "DOVE Dataset"
        self.description = (
            "Dataset of 3D and 4D MRI images of the brain acquired with"
            " different sequences and modalities including MP2RAGE, BOLD,"
            " DWI, and bSSFP.")
        self.index: Optional[BIDSIndex] = None
        self.train_samples: List[SampleSpec] = []
        self.val_samples: List[SampleSpec] = []
        self.test_samples: List[SampleSpec] = []
        self._volume_cache: Dict[str, np.ndarray] = {}
        self._stride = (0, 1)  # (this process's slice, the slices' count)

    # -- discovery ---------------------------------------------------------

    def prepare_data(self) -> None:
        """Index the tree, split the subjects and pair their files; under
        ``DataConfig.process_split`` in a process group, keep this
        process's stride-slice of each list."""
        cfg = self.config
        if not os.path.isdir(cfg.data_dir):
            raise FileNotFoundError(f"BIDS dataset root does not exist: {cfg.data_dir!r}")
        self.index = BIDSIndex(cfg.data_dir)
        deriv = os.path.join(cfg.data_dir, cfg.derivatives)
        if os.path.isdir(deriv):
            self.index.add_derivatives(deriv)
        scope = os.path.basename(cfg.derivatives.rstrip("/"))
        train_subs, val_subs, test_subs = subject_split(
            self.index.get_subjects(), cfg.val_split, cfg.test_split, cfg.seed)

        def build(subs: Sequence[str]) -> List[SampleSpec]:
            out = []
            for sub in subs:
                dwi = self.index.get(scope=scope, subject=sub, suffix="dwi", desc=cfg.desc_dwi)
                pc = self.index.get(scope=scope, subject=sub, suffix="bssfp",
                                    desc=cfg.desc_pc_bssfp)
                one = self.index.get(scope=scope, subject=sub, suffix="bssfp",
                                     desc=cfg.desc_bssfp)
                t1w = self.index.get(scope=scope, subject=sub, suffix="T1w", desc=cfg.desc_t1w)
                if not t1w:
                    continue
                # cross-session pairing: every DT × every bSSFP index
                for dwi_f in dwi:
                    for i in range(min(len(pc), len(one))):
                        out.append(SampleSpec(subject=sub, paths={
                            "dwi-tensor": dwi_f, "pc-bssfp": pc[i], "bssfp": one[i],
                            "t1w": t1w[0]}))
            return out

        self.train_samples = build(train_subs)
        self.val_samples = build(val_subs)
        self.test_samples = build(test_subs)
        if cfg.process_split and distributed.process_count() > 1:
            pid, pn = distributed.process_index(), distributed.process_count()
            self._stride = (pid, pn)
            self.train_samples = self.train_samples[pid::pn]
            self.val_samples = self.val_samples[pid::pn]
            self.test_samples = self.test_samples[pid::pn]
        if not (self.train_samples or self.val_samples or self.test_samples):
            raise ValueError(
                f"no paired samples found under {cfg.data_dir!r} (derivatives scope "
                f"{scope!r}; desc tags {cfg.desc_dwi}/{cfg.desc_pc_bssfp}/"
                f"{cfg.desc_bssfp}/{cfg.desc_t1w})")

    def print_info(self) -> None:
        """Dataset stats (reference ``src/data_module.py:48-60``)."""
        if self.index is None:
            self.prepare_data()
        total = len(self.train_samples) + len(self.val_samples) + len(self.test_samples)
        print("=" * 30)
        print("Dataset name:        ", self.name)
        print("Dataset description: ", self.description)
        print("Number of samples:   ", total)
        print("=" * 30)

    def setup(self, stage: Optional[str] = None) -> None:
        if self.index is None:
            self.prepare_data()

    # -- loading -----------------------------------------------------------

    def load_subject(self, spec: SampleSpec,
                     keys: Sequence[str] = ALL_KEYS) -> Dict[str, np.ndarray]:
        """Load and crop-or-pad one sample's volumes on host threads. With
        ``cache_volumes`` the preprocessed array is kept per path."""
        cfg = self.config

        def load_one(key):
            path = spec.path(key)
            if cfg.cache_volumes and path in self._volume_cache:
                return key, self._volume_cache[path]
            data, _ = load_volume(path)
            out = crop_or_pad(torch.from_numpy(data), cfg.volume_shape).numpy()
            if cfg.cache_volumes:
                self._volume_cache[path] = out
            return key, out

        return dict(parallel_map(load_one, keys, cfg.num_workers))

    # -- batch streams -----------------------------------------------------

    def _subject_patches(self, spec: SampleSpec, seed: int, index: int,
                         keys: Sequence[str], augment: bool,
                         device: torch.device) -> Dict[str, torch.Tensor]:
        cfg = self.config
        subject = stage(self.load_subject(spec, keys), device)
        if augment:
            subject = augment_subject(sample_generator(seed, index, 0), subject,
                                      prob=cfg.augment_prob)
        elif "dwi-tensor" in subject:
            subject["dwi-tensor_orig"] = subject["dwi-tensor"]
        if cfg.whole_volume:
            return {k: v[None] for k, v in subject.items()}
        starts = uniform_patch_starts(sample_generator(seed, index, 1), cfg.volume_shape,
                                      cfg.patch_size, cfg.samples_per_vol)
        return {k: extract_patches(v, starts, cfg.patch_size) for k, v in subject.items()}

    def _batches(self, samples: List[SampleSpec], seed: int, keys: Sequence[str],
                 augment: bool, batch_divisor: int,
                 device: torch.device) -> Iterator[Dict[str, torch.Tensor]]:
        cfg = self.config
        order = torch.randperm(len(samples), generator=torch.Generator().manual_seed(seed))
        pid, pn = self._stride
        buffers: Dict[str, torch.Tensor] = {}
        for i in order.tolist():
            # a sample's draws follow its index in the whole list, so every
            # sample is augmented and cut as one process would do it
            patches = self._subject_patches(samples[i], seed, i * pn + pid, keys, augment,
                                            device)
            for k, v in patches.items():
                buffers[k] = torch.cat([buffers[k], v]) if k in buffers else v
            while buffers[keys[0]].shape[0] >= cfg.batch_size:
                yield {k: v[:cfg.batch_size] for k, v in buffers.items()}
                buffers = {k: v[cfg.batch_size:] for k, v in buffers.items()}
        # The final partial batch (torch DataLoader drop_last=False), at its
        # true size; under a mesh dim 0 must divide the device count, so it
        # is rounded down to a multiple of ``batch_divisor``, padded up by
        # repetition only where it would vanish.
        n = buffers[keys[0]].shape[0] if buffers else 0
        if n > 0 and batch_divisor > 1:
            keep = (n // batch_divisor) * batch_divisor
            if keep == 0:
                reps = -(-batch_divisor // n)
                buffers = {k: v.repeat((reps,) + (1,) * (v.ndim - 1))[:batch_divisor]
                           for k, v in buffers.items()}
                n = batch_divisor
            else:
                buffers = {k: v[:keep] for k, v in buffers.items()}
                n = keep
        if n > 0:
            yield buffers

    def batch_plan(self, n_samples: int, batch_divisor: int = 1) -> Tuple[int, int]:
        """``(full batches, the last batch's size or 0)`` of a stream over
        ``n_samples`` samples, as :meth:`_batches` cuts it."""
        cfg = self.config
        total = n_samples * (1 if cfg.whole_volume else cfg.samples_per_vol)
        full, rest = divmod(total, cfg.batch_size)
        if rest and batch_divisor > 1:
            rest = max(rest // batch_divisor * batch_divisor, batch_divisor)
        return full, rest

    def _patch_stream(self, samples: List[SampleSpec], seed: Seed, keys: Sequence[str],
                      augment: bool, batch_divisor: int = 1, device: Device = None,
                      prefetch: bool = True, what: str = "batches"
                      ) -> Iterator[Dict[str, torch.Tensor]]:
        distributed.check_same(f"{what} (full batches, last batch)",
                               self.batch_plan(len(samples), batch_divisor))
        dev = resolve_device(device)
        batches = self._batches(samples, _as_seed(seed), tuple(keys), augment,
                                batch_divisor, dev)
        if not prefetch:
            return batches
        if dev.type != "cuda":
            return PrefetchIterator(batches, size=PREFETCH)
        return _side_stream_prefetch(batches, dev)

    def train_batches(self, seed: Seed, keys: Sequence[str] = ALL_KEYS,
                      batch_divisor: int = 1, device: Device = None,
                      prefetch: bool = True) -> Iterator[Dict[str, torch.Tensor]]:
        """Augmented training batches ``{key: (B, p, p, p, C)}`` (plus
        ``dwi-tensor_orig``) on ``device`` (default ``cuda``)."""
        return self._patch_stream(self.train_samples, seed, keys, True, batch_divisor,
                                  device, prefetch, "train batches")

    def val_batches(self, seed: Seed, keys: Sequence[str] = ALL_KEYS,
                    batch_divisor: int = 1, augment: bool = True, device: Device = None,
                    prefetch: bool = True) -> Iterator[Dict[str, torch.Tensor]]:
        """Validation batches. The reference augments val too
        (``src/data_module.py:146-147``), the default; ``augment=False``
        serves the clean-val measurement."""
        return self._patch_stream(self.val_samples, seed, keys, augment, batch_divisor,
                                  device, prefetch, "val batches")

    def test_volumes(self, keys: Sequence[str] = ALL_KEYS, device: Device = None
                     ) -> Iterator[Tuple[SampleSpec, Dict[str, torch.Tensor]]]:
        """Preprocess-only whole volumes on ``device`` (reference
        ``src/data_module.py:148-150``)."""
        dev = resolve_device(device)
        for spec in self.test_samples:
            vols = self.load_subject(spec, keys)
            yield spec, {k: torch.from_numpy(v).to(dev) for k, v in vols.items()}

    def steps_per_epoch(self, split: str = "train") -> int:
        cfg = self.config
        n = len(getattr(self, f"{split}_samples"))
        per_vol = 1 if cfg.whole_volume else cfg.samples_per_vol
        return (n * per_vol) // cfg.batch_size


def stage(arrays: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """The loaded volumes on ``device``. To a CUDA device they go through
    pinned host buffers, copied without blocking on the calling thread's
    current stream: a copy from pageable memory stalls the training step's
    kernel launches on the other thread while CUDA stages it
    (``scripts/torch_port_data_step.py``)."""
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in arrays.items()}


def _side_stream_prefetch(batches: Iterator[Dict[str, torch.Tensor]],
                          device: torch.device) -> Iterator[Dict[str, torch.Tensor]]:
    """``batches`` built ahead in a background thread on a CUDA stream of
    its own; each reaches the consumer after its stream waits on the event
    recorded behind the batch, with the batch's memory recorded as in use
    on the consumer's stream."""
    stream = torch.cuda.Stream(device)

    def produce():
        with torch.cuda.device(device), torch.cuda.stream(stream):
            for batch in batches:
                done = torch.cuda.Event()
                done.record(stream)
                yield batch, done

    for batch, done in PrefetchIterator(produce(), size=PREFETCH):
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in batch.values():
            t.record_stream(consumer)
        yield batch
