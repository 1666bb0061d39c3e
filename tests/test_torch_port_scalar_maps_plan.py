"""K8's launch plan (``ops/kernels/scalar_maps.py:scalar_maps_plan``)
without a card: every voxel given to exactly one (block, thread), one voxel
a thread, for V that is and is not a multiple of the block; and the bound
the eval chain's files and table are held to, card against CPU. The kernel
is held to its plain version on the card in ``test_torch_port_gpu.py``."""

import importlib

import pytest
import torch

# the module (the package exports its function under the same name)
sm = importlib.import_module("unet_bssfp_tpu_torch.ops.kernels.scalar_maps")


@pytest.mark.parametrize("nvox", [
    1, 2, 7, 31, 32, 33, 64, 127, 128, 129, 255, 256, 257, 383, 384, 385, 511, 512,
    513, 1000, 1001, 4096, 5 * 7 * 3, 97 * 33 * 3, 12 * 15 * 17, 96 * 128 * 128,
    96 * 128 * 128 + 3])
def test_scalar_maps_plan_gives_every_voxel_once(nvox):
    blocks = sm.scalar_maps_plan(nvox)
    idx = sm.plan_voxels(blocks)
    assert idx.shape == (blocks, sm.THREADS)
    stored = idx[idx < nvox]
    assert torch.equal(torch.bincount(stored, minlength=nvox), torch.ones(nvox, dtype=torch.long))
    # no block is wholly past the end: the grid is the least that covers V
    assert int(idx[-1].min()) < nvox
    # each warp reads one coalesced run of 32 voxels
    runs = idx.reshape(blocks, sm.THREADS // 32, 32)
    assert bool((runs.diff(dim=-1) == 1).all())


def test_scalar_maps_plan_default_and_refused_counts():
    assert sm.scalar_maps_plan(1000) == -(-1000 // sm.THREADS)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            sm.scalar_maps_plan(bad)


def test_scalar_maps_cpu_takes_the_plain_version():
    d6 = torch.randn(4, 5, 6)
    sm.scalar_maps.launches = 0
    assert all(torch.equal(a, b) for a, b in zip(sm.scalar_maps(d6), sm.scalar_maps_plain(d6)))
    assert sm.scalar_maps.launches == 0


def test_eval_chain_bound_holds_two_map_implementations(tmp_path, monkeypatch):
    """The bound the card's eval chain is held to against the CPU's now that
    K8 contracts a·b + c (``chain_bounds``, ``compare_chain_files``,
    ``table_cell_bounds``), rehearsed on the CPU with a second f32
    implementation of the maps: the plain version in f64, rounded once. Its
    files stay within their bounds and its table within the cells' bounds,
    which the 4-ulp bound of bit-equal maps alone does not cover."""
    import os
    import shutil
    from pathlib import Path

    import numpy as np

    from unet_bssfp_tpu_torch.data.nifti import load_volume, save_volume
    from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids
    from unet_bssfp_tpu_torch.eval import evaluate
    from unet_bssfp_tpu_torch.ops import scalar_maps_check as chk
    from unet_bssfp_tpu_torch.ops.scalar_maps import ScalarMaps, load_rescale_args

    bids = make_synthetic_bids(str(tmp_path / "bids"), subjects=("01", "02"),
                               sessions=("1",), volume_shape=(12, 16, 20))
    pred_dir = tmp_path / "ref" / "pc-bssfp"
    pred_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, sub in enumerate(("01", "02")):
        tgt, aff = load_volume(f"{bids}/derivatives/preproc-dove/sub-{sub}/ses-1/dwi/"
                               f"sub-{sub}_ses-1_desc-normtensor_dwi.nii.gz")
        pred = np.clip(tgt + 0.1 * rng.standard_normal(tgt.shape), 0, 1).astype(np.float32)
        save_volume(str(pred_dir / f"pred-{i}_mod-pc-bssfp_sub-{sub}_ses-1.nii.gz"), pred, aff)
        save_volume(str(pred_dir / f"target-{i}_mod-pc-bssfp_sub-{sub}_ses-1.nii.gz"), tgt, aff)
    shutil.copytree(tmp_path / "ref", tmp_path / "got")
    rescale = str(Path(__file__).resolve().parents[1] / "constants" / "rescale_args_dwi.txt")
    rows = {}
    for run in ("ref", "got"):
        if run == "got":
            monkeypatch.setattr(evaluate, "compute_scalar_maps", lambda d6: ScalarMaps(
                *(m.float() for m in sm.scalar_maps_plain(d6.double()))))
        evaluate.eval_dwi_tensors(str(tmp_path / run / "pc-bssfp"), rescale, 2, "cpu")
        rows[run] = evaluate.calc_error_table(str(tmp_path / run), bids, num_workers=2,
                                              device="cpu")
    files = {run: {fn: load_volume(os.path.join(tmp_path, run, "pc-bssfp", fn))[0]
                   for fn in sorted(os.listdir(tmp_path / run / "pc-bssfp"))}
             for run in ("ref", "got")}
    bounds = chk.chain_bounds(files["ref"], load_rescale_args(rescale))
    res = chk.compare_chain_files(files["got"], files["ref"], bounds)
    assert res["ok"], res["failures"]
    assert max(res["left_out"].values()) <= 0.05 * 12 * 16 * 20
    masks, probsegs = evaluate._load_masks(bids, ("01", "02"), "derivatives/preproc-dove",
                                           torch.device("cpu"))
    cells = chk.table_cell_bounds(rows["ref"], files["got"], files["ref"], bounds, masks,
                                  probsegs)
    assert chk.compare_error_tables(rows["got"], rows["ref"], cells) == []
    assert chk.compare_error_tables(rows["got"], rows["ref"]) != []
