"""The port's training data path (``unet_bssfp_tpu_torch.data``) against the
JAX package's on the CPU: BIDS discovery and the subject split (exact),
the data module's sample lists and patches (exact: loads, crops and slices
do no arithmetic), the batch stream's sizes, partial batches, whole-volume
mode, the volume cache and prefetch, and the preprocessing transforms (to
1e-5 of the largest |value|). The streams' patch corners and order come
from ``torch.Generator``s where JAX draws them from keys, so the port's
patches are held to JAX's ``extract_patches`` at the port's own corners."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.data import bids as jbids
from unet_bssfp_tpu.data import datamodule as jdm
from unet_bssfp_tpu.data import sampler as jsampler
from unet_bssfp_tpu.data import synthetic as jsynthetic
from unet_bssfp_tpu.data import transforms as jtransforms
from unet_bssfp_tpu_torch.data import bids, queue, sampler, transforms
from unet_bssfp_tpu_torch.data.datamodule import (
    ALL_KEYS,
    DoveDataModule,
    SampleSpec,
    sample_generator,
)
from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids

KEYS = ("pc-bssfp", "dwi-tensor")
SMALL = dict(batch_size=4, samples_per_vol=4, patch_size=8, volume_shape=(16, 16, 16),
             num_workers=2)


@pytest.fixture(scope="module")
def bids_root(tmp_path_factory):
    """The 3-subject × 2-session tree of ``tests/test_data.py``, written by
    the port."""
    root = tmp_path_factory.mktemp("bids")
    return make_synthetic_bids(str(root), subjects=("01", "02", "03"),
                               sessions=("1", "2"), volume_shape=(16, 16, 16))


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bids_jax")
    return jsynthetic.make_synthetic_bids(str(root), subjects=("01", "02", "03"),
                                          sessions=("1", "2"), volume_shape=(16, 16, 16))


def _spec_rel(specs, root):
    return [(s.subject, {k: os.path.relpath(v, root) for k, v in s.paths.items()})
            for s in specs]


# -- BIDS --------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "/x/sub-01/ses-2/dwi/sub-01_ses-2_desc-normtensor_dwi.nii.gz",
    "sub-7_ses-1_desc-probseg_T1w.nii",
    "sub-02_run-3_bold.json",
    "sub-03_desc-x_acq-y.tsv",
    "notbids.txt",
])
def test_parse_entities_matches_jax(name):
    assert bids.parse_entities(name) == jbids.parse_entities(name)


def test_index_queries_match_jax(bids_root):
    ours, ref = bids.BIDSIndex(bids_root), jbids.BIDSIndex(bids_root)
    for idx in (ours, ref):
        idx.add_derivatives(f"{bids_root}/derivatives/preproc-dove")
    assert ours.get_subjects() == ref.get_subjects() == ["01", "02", "03"]
    queries = [dict(), dict(scope="preproc-dove", subject="01", suffix="dwi", desc="normtensor"),
               dict(suffix="T1w"), dict(extension=".nii.gz"), dict(extension=".nii"),
               dict(subject="02", extension="_bssfp.nii.gz"), dict(scope="raw")]
    for q in queries:
        assert ours.get(**q) == ref.get(**q), q
    assert len(ours.get(scope="preproc-dove", subject="01", suffix="dwi",
                        desc="normtensor")) == 2


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 10, 20, 37])
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_subject_split_equals_jax(n, seed):
    subs = [f"{i:02d}" for i in range(n)]
    for val, test in ((0.1, 0.1), (0.25, 0.25), (0.34, 0.33), (0.0, 0.5)):
        got = bids.subject_split(subs, val, test, seed)
        assert got == tuple(jbids.subject_split(subs, val, test, seed))
        assert sorted(got[0] + got[1] + got[2]) == subs


# -- data module: sample lists, steps, patches ------------------------------

def test_prepare_data_sample_lists_equal_jax(bids_root):
    ours = DoveDataModule(bids_root, **SMALL)
    ref = jdm.DoveDataModule(bids_root, **SMALL)
    ours.prepare_data()
    ref.prepare_data()
    assert len(ours.train_samples + ours.val_samples + ours.test_samples) == 12
    for split in ("train", "val", "test"):
        a = getattr(ours, f"{split}_samples")
        b = getattr(ref, f"{split}_samples")
        assert [(s.subject, s.paths) for s in a] == [(s.subject, s.paths) for s in b]
        assert ours.steps_per_epoch(split) == ref.steps_per_epoch(split)
    whole = DoveDataModule(bids_root, **SMALL, whole_volume=True)
    whole.prepare_data()
    assert whole.steps_per_epoch("train") == len(whole.train_samples) // 4


def test_prepare_data_lists_match_on_jax_written_tree(bids_root, jax_root):
    """Both packages' synthetic writers give the same tree: the port's data
    module pairs JAX's tree as it pairs its own."""
    ours, theirs = DoveDataModule(bids_root, **SMALL), DoveDataModule(jax_root, **SMALL)
    ours.prepare_data()
    theirs.prepare_data()
    for split in ("train", "val", "test"):
        assert (_spec_rel(getattr(ours, f"{split}_samples"), bids_root)
                == _spec_rel(getattr(theirs, f"{split}_samples"), jax_root))


def test_prepare_data_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        DoveDataModule(str(tmp_path / "missing")).prepare_data()
    (tmp_path / "empty" / "sub-01").mkdir(parents=True)
    with pytest.raises(ValueError, match="no paired samples"):
        DoveDataModule(str(tmp_path / "empty")).prepare_data()


def test_load_subject_and_extract_patches_equal_jax(bids_root):
    """Loads and crop-or-pad to a larger and a smaller target, and patches
    at the same corners: bit-equal to the JAX package's."""
    for shape in ((16, 16, 16), (18, 12, 20)):
        ours = DoveDataModule(bids_root, **dict(SMALL, volume_shape=shape))
        ref = jdm.DoveDataModule(bids_root, **dict(SMALL, volume_shape=shape))
        ours.prepare_data()
        ref.prepare_data()
        a = ours.load_subject(ours.train_samples[0], ALL_KEYS)
        b = ref.load_subject(ref.train_samples[0], ALL_KEYS)
        for k in ALL_KEYS:
            assert a[k].shape == shape + (a[k].shape[-1],)
            np.testing.assert_array_equal(a[k], b[k])
        starts = sampler.uniform_patch_starts(torch.Generator().manual_seed(3), shape, 8, 6)
        got = sampler.extract_patches(torch.from_numpy(a["pc-bssfp"]), starts, 8).numpy()
        want = np.asarray(jsampler.extract_patches(jnp.asarray(b["pc-bssfp"]),
                                                   jnp.asarray(starts), 8))
        np.testing.assert_array_equal(got, want)


def test_uniform_patch_starts_range_and_draw():
    g = torch.Generator().manual_seed(0)
    starts = sampler.uniform_patch_starts(g, (16, 20, 24), 8, 4000)
    assert starts.shape == (4000, 3) and starts.dtype == np.int32
    for ax, dim in enumerate((16, 20, 24)):
        assert starts[:, ax].min() == 0 and starts[:, ax].max() == dim - 8
    # floor(U · (dim − p + 1)) on the generator's f32 draws
    u = torch.rand((5, 3), generator=torch.Generator().manual_seed(1))
    want = torch.floor(u * torch.tensor([9.0, 13.0, 17.0])).to(torch.int32).numpy()
    got = sampler.uniform_patch_starts(torch.Generator().manual_seed(1), (16, 20, 24), 8, 5)
    np.testing.assert_array_equal(got, want)


def _expected_val_patches(dm_jax, samples, seed):
    """The port's clean val stream rebuilt from JAX pieces: the port's order
    and corners, JAX's loads and ``extract_patches``."""
    cfg = dm_jax.config
    order = torch.randperm(len(samples), generator=torch.Generator().manual_seed(seed)).tolist()
    out = {k: [] for k in KEYS + ("dwi-tensor_orig",)}
    for i in order:
        vols = dm_jax.load_subject(samples[i], KEYS)
        starts = jnp.asarray(sampler.uniform_patch_starts(
            sample_generator(seed, i, 1), cfg.volume_shape, cfg.patch_size,
            cfg.samples_per_vol))
        for k in KEYS:
            out[k].append(np.asarray(jsampler.extract_patches(jnp.asarray(vols[k]), starts,
                                                              cfg.patch_size)))
        out["dwi-tensor_orig"].append(out["dwi-tensor"][-1])
    return {k: np.concatenate(v) for k, v in out.items()}


@pytest.mark.parametrize("prefetch", [True, False])
def test_val_batches_clean_equal_jax_patches(bids_root, prefetch):
    cfg = dict(SMALL, val_split=0.34, test_split=0.0, samples_per_vol=3)
    ours, ref = DoveDataModule(bids_root, **cfg), jdm.DoveDataModule(bids_root, **cfg)
    ours.prepare_data()
    ref.prepare_data()
    assert len(ours.val_samples) == 4
    batches = list(ours.val_batches(5, keys=KEYS, augment=False, device="cpu",
                                    prefetch=prefetch))
    # 4 samples × 3 patches = 12: three full batches of 4
    assert [b["pc-bssfp"].shape[0] for b in batches] == [4, 4, 4]
    want = _expected_val_patches(ref, ref.val_samples, 5)
    for k in KEYS + ("dwi-tensor_orig",):
        got = torch.cat([b[k] for b in batches]).numpy()
        np.testing.assert_array_equal(got, want[k])


def test_train_batches_shapes_and_original_target(bids_root):
    dm = DoveDataModule(bids_root, **dict(SMALL, augment_prob=0.0))
    dm.prepare_data()
    batches = list(dm.train_batches(0, keys=KEYS, device="cpu"))
    n = len(dm.train_samples) * 4
    assert [b["pc-bssfp"].shape[0] for b in batches] == [4] * (n // 4) + (
        [n % 4] if n % 4 else [])
    b = batches[0]
    assert b["pc-bssfp"].shape == (4, 8, 8, 8, 24)
    assert b["dwi-tensor"].shape == b["dwi-tensor_orig"].shape == (4, 8, 8, 8, 6)
    # p = 0: nothing is augmented, the kept target is the target
    assert all(torch.equal(b["dwi-tensor"], b["dwi-tensor_orig"]) for b in batches)
    aug = DoveDataModule(bids_root, **dict(SMALL, augment_prob=1.0))
    aug.prepare_data()
    ab = list(aug.train_batches(0, keys=KEYS, device="cpu"))
    # the same corners with augmentation on: the kept target is the clean patch
    for x, y in zip(batches, ab):
        assert torch.equal(x["dwi-tensor_orig"], y["dwi-tensor_orig"])
        assert not torch.allclose(y["dwi-tensor"], y["dwi-tensor_orig"])
        assert torch.isfinite(y["pc-bssfp"]).all()


def test_streams_repeat_with_prefetch_on_and_off(bids_root):
    dm = DoveDataModule(bids_root, **dict(SMALL, augment_prob=0.5))
    dm.prepare_data()
    runs = [list(dm.train_batches(11, keys=KEYS, device="cpu", prefetch=p))
            for p in (True, False, True)]
    for other in runs[1:]:
        assert len(other) == len(runs[0])
        for a, b in zip(runs[0], other):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)
    # a generator in place of a seed draws the seed from it
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    a = next(iter(dm.train_batches(g1, keys=KEYS, device="cpu")))
    b = next(iter(dm.train_batches(g2, keys=KEYS, device="cpu")))
    assert torch.equal(a["pc-bssfp"], b["pc-bssfp"])
    c = next(iter(dm.train_batches(12, keys=KEYS, device="cpu")))
    assert not torch.equal(runs[0][0]["pc-bssfp"], c["pc-bssfp"])


def test_whole_volume_mode(bids_root):
    dm = DoveDataModule(bids_root, **dict(SMALL, batch_size=2, whole_volume=True))
    dm.prepare_data()
    batches = list(dm.train_batches(0, keys=KEYS, device="cpu"))
    assert batches[0]["pc-bssfp"].shape == (2, 16, 16, 16, 24)
    assert batches[0]["dwi-tensor_orig"].shape == (2, 16, 16, 16, 6)
    assert sum(b["pc-bssfp"].shape[0] for b in batches) == len(dm.train_samples)


@pytest.mark.parametrize("split", ["train", "val"])
def test_partial_batch_respects_divisor(bids_root, split):
    """As ``tests/test_data.py::test_partial_batch_respects_divisor``: the
    last partial batch rounds down to a multiple of ``batch_divisor``, padded
    up by repetition where it would vanish."""
    dm = DoveDataModule(bids_root, batch_size=4, samples_per_vol=1, patch_size=8,
                        volume_shape=(16, 16, 16), num_workers=1, test_split=0.34,
                        val_split=0.33)
    dm.prepare_data()
    stream = getattr(dm, f"{split}_batches")(0, keys=("dwi-tensor",), batch_divisor=4,
                                             device="cpu")
    sizes = [b["dwi-tensor"].shape[0] for b in stream]
    assert sizes and all(s % 4 == 0 and s > 0 for s in sizes)
    # the same sizes as the JAX package's stream
    ref = jdm.DoveDataModule(bids_root, batch_size=4, samples_per_vol=1, patch_size=8,
                             volume_shape=(16, 16, 16), num_workers=1, test_split=0.34,
                             val_split=0.33)
    ref.prepare_data()
    jstream = getattr(ref, f"{split}_batches")(jax.random.PRNGKey(0), keys=("dwi-tensor",),
                                               batch_divisor=4)
    assert sizes == [b["dwi-tensor"].shape[0] for b in jstream]


@pytest.mark.parametrize("n,divisor,want", [(5, 4, [4]), (3, 4, [4]), (2, 3, [3]), (7, 2, [6]),
                                            (1, 1, [1])])
def test_partial_batch_rounding_rule(tmp_path, n, divisor, want):
    """The remainder rule on a stream of n single-patch samples, batch 8:
    rounded down to a multiple of the divisor, or repeated up to it."""
    dm = DoveDataModule(str(tmp_path), batch_size=8, samples_per_vol=1, patch_size=2,
                        volume_shape=(2, 2, 2), num_workers=1)
    rows = [np.full((2, 2, 2, 1), i, np.float32) for i in range(n)]
    dm.load_subject = lambda spec, keys: {"t1w": rows[int(spec.subject)]}
    specs = [SampleSpec(subject=str(i), paths={}) for i in range(n)]
    batches = list(dm._patch_stream(specs, 0, ("t1w",), False, divisor, "cpu", False))
    assert [b["t1w"].shape[0] for b in batches] == want
    values = batches[-1]["t1w"][:, 0, 0, 0, 0].tolist()
    assert set(values) <= set(range(n))


def test_volume_cache(bids_root):
    dm = DoveDataModule(bids_root, volume_shape=(16, 16, 16), num_workers=1,
                        cache_volumes=True)
    dm.prepare_data()
    spec = dm.train_samples[0]
    v1 = dm.load_subject(spec, keys=("dwi-tensor",))
    assert dm._volume_cache
    v2 = dm.load_subject(spec, keys=("dwi-tensor",))
    assert v2["dwi-tensor"] is v1["dwi-tensor"]
    off = DoveDataModule(bids_root, volume_shape=(16, 16, 16), num_workers=1)
    off.prepare_data()
    off.load_subject(spec, keys=("dwi-tensor",))
    assert not off._volume_cache


def test_test_volumes_and_print_info(bids_root, capsys):
    dm = DoveDataModule(bids_root, **SMALL)
    dm.print_info()
    assert "Number of samples:    12" in capsys.readouterr().out
    vols = list(dm.test_volumes(keys=KEYS, device="cpu"))
    assert len(vols) == len(dm.test_samples)
    for spec, v in vols:
        assert v["pc-bssfp"].shape == (16, 16, 16, 24) and v["pc-bssfp"].device.type == "cpu"


def test_streams_default_to_cuda(bids_root, monkeypatch):
    """Every stream defaults to the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dm = DoveDataModule(bids_root, **SMALL)
    dm.prepare_data()
    for make in (lambda: dm.train_batches(0), lambda: dm.val_batches(0),
                 lambda: next(dm.test_volumes())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# -- queue -------------------------------------------------------------------

def test_prefetch_iterator_passes_items_and_raises_in_the_consumer():
    assert list(queue.PrefetchIterator(iter(range(7)), size=2)) == list(range(7))

    def broken():
        yield 1
        yield 2
        raise KeyError("bad volume")

    it = queue.PrefetchIterator(broken(), size=1)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="bad volume"):
        next(it)
    with pytest.raises(KeyError):  # asked again, the same error
        next(it)
    done = queue.PrefetchIterator(iter(()))
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(done)


def test_parallel_map_orders_and_raises():
    items = list(range(20))
    assert queue.parallel_map(lambda x: x * x, items, 4) == [x * x for x in items]
    assert sorted(queue.parallel_map(lambda x: x * x, items, 4, ordered=False)) == [
        x * x for x in items]
    assert queue.parallel_map(lambda x: -x, items, 1, ordered=False) == [-x for x in items]

    def fail(x):
        if x == 3:
            raise ValueError("three")
        return x

    for ordered in (True, False):
        with pytest.raises(ValueError, match="three"):
            queue.parallel_map(fail, items, 4, ordered=ordered)


# -- transforms --------------------------------------------------------------

def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("shape", [(16, 16, 16, 1), (12, 15, 17, 3)])
def test_rescale_and_znormalize_match_jax(shape):
    rng = np.random.default_rng(1)
    c = shape[-1]
    v = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    lo = rng.standard_normal(c).astype(np.float32)
    hi = lo + rng.random(c).astype(np.float32)
    hi[0] = lo[0]  # equal bounds: shifted only
    _close(transforms.rescale_intensity(torch.from_numpy(v), torch.from_numpy(lo),
                                        torch.from_numpy(hi)),
           jtransforms.rescale_intensity(jnp.asarray(v), jnp.asarray(lo), jnp.asarray(hi)))
    _close(transforms.znormalize(torch.from_numpy(v)), jtransforms.znormalize(jnp.asarray(v)))


@pytest.mark.parametrize("src,dst", [
    ((12, 15, 17), (16, 16, 16)),   # grow
    ((16, 16, 16), (12, 15, 17)),   # shrink: JAX antialiases
    ((16, 16, 16), (5, 9, 31)),     # shrink hard on two axes, grow on one
    ((7, 8, 9), (7, 20, 3)),        # one axis kept
])
@pytest.mark.parametrize("c", [1, 6])
def test_resample_trilinear_matches_jax(src, dst, c):
    v = np.random.default_rng(2).standard_normal(src + (c,)).astype(np.float32)
    got = transforms.resample_trilinear(torch.from_numpy(v), dst)
    want = jtransforms.resample_trilinear(jnp.asarray(v), dst)
    _close(got, want)


def test_resample_trilinear_antialiases_where_interpolate_does_not():
    """Shrinking 16 → 5, JAX's triangle is widened by 16/5: the port follows
    it, ``F.interpolate`` (no antialiasing) lands elsewhere."""
    v = np.random.default_rng(3).standard_normal((16, 16, 16, 2)).astype(np.float32)
    want = np.asarray(jtransforms.resample_trilinear(jnp.asarray(v), (5, 5, 5)))
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(v).permute(3, 0, 1, 2)[None], size=(5, 5, 5), mode="trilinear",
        align_corners=False)[0].permute(1, 2, 3, 0).numpy()
    assert np.abs(plain - want).max() > 1e-2
    _close(transforms.resample_trilinear(torch.from_numpy(v), (5, 5, 5)), want)


def test_crop_or_pad_matches_jax():
    v = np.random.default_rng(4).random((13, 16, 9, 2)).astype(np.float32)
    for target in ((16, 16, 16), (8, 11, 9), (13, 20, 4)):
        np.testing.assert_array_equal(
            transforms.crop_or_pad(torch.from_numpy(v), target).numpy(),
            np.asarray(jtransforms.crop_or_pad(jnp.asarray(v), target)))


def test_data_package_exports_the_jax_names():
    import unet_bssfp_tpu.data as jdata
    import unet_bssfp_tpu_torch.data as tdata

    assert sorted(tdata.__all__) == sorted(jdata.__all__)
    for name in tdata.__all__:
        assert hasattr(tdata, name)


def test_sample_generators_are_independent_of_thread_order():
    """A sample's generators depend on (seed, index, stream) alone: drawn in
    any order, they give the same numbers, and no two give the same."""
    keys = [(i, s) for i in range(4) for s in (0, 1)]
    first = {k: torch.rand(3, generator=sample_generator(9, *k)) for k in keys}
    again = {k: torch.rand(3, generator=sample_generator(9, *k)) for k in reversed(keys)}
    assert all(torch.equal(first[k], again[k]) for k in keys)
    assert len({tuple(v.tolist()) for v in first.values()}) == len(keys)


def test_data_config_field_names_match_jax():
    from unet_bssfp_tpu.config import DataConfig as JDataConfig
    from unet_bssfp_tpu_torch.config import DataConfig

    assert [f.name for f in dataclasses.fields(DataConfig)] == [
        f.name for f in dataclasses.fields(JDataConfig)]
