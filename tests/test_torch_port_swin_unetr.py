"""The SwinUNETR backbone (``models/swin_unetr.py``) on the CPU against the
plain reference (``portbench/reference/swin_unetr.py``, MONAI v1's
equations, no JAX), at a size that holds every case of the BTCV setting:
2 crops of 32³, 24 → 6, feature size 12, heads (3, 6, 12, 24), window 7.
Stage 1 (16³) is padded to 21³ and shifted by 3, stage 2 (8³) padded to
14³ and shifted, stage 3 (4³) clamped to a 4³ window without a shift (its
bias index sliced ``[:64, :64]``), stage 4 (2³) to 2³; patch merging
repeats two of its eight slices.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch
import torch.nn.functional as F

from portbench import check, inputs
from portbench.drivers import swin_gan_train as drv
from portbench.reference import swin_unetr as R
from unet_bssfp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.models.generator import Generator
from unet_bssfp_tpu_torch.models.swin_unetr import (
    MASKED,
    SwinBlock,
    shift_mask,
    stage_window,
)
from unet_bssfp_tpu_torch.train.checkpoint import CheckpointManager, load_checkpoint
from unet_bssfp_tpu_torch.train.state import build_models, create_gan_state
from unet_bssfp_tpu_torch.train.steps import make_predict_fn

torch.set_num_threads(2)

SWIN = {"feature_size": 12, "depths": [2, 2, 2, 2], "num_heads": [3, 6, 12, 24],
        "window_size": 7, "patch_size": 2, "mlp_ratio": 4.0}
CFG = {"model": "swin_gan", "modality": "pc-bssfp", "in_channels": 24, "out_channels": 6,
       "unet_in_channels": 24, "swin": SWIN, "dropout": 0.0, "disc_negative_slope": 0.2,
       "disc_features": [4, 8, 8, 8], "compute_dtype": "float32", "packed": None,
       "train": {"lr": 1e-3, "weight_decay": 0.01, "b1": 0.9, "b2": 0.999,
                 "recon_factor": 100.0, "with_perceptual": False, "reuse_fake": False}}
TRAFFIC = {"kind": "swin_gan_train", "batch": 2, "patch": 32, "pool_batches": 3,
           "row_log_scale": 1.0, "checked_steps": 3, "trace_items": 1}


def _mcfg(packed=False, **kw) -> ModelConfig:
    return dataclasses.replace(drv.model_config(dict(CFG, packed=packed)), **kw)


def _random_weights(seed: int, dtype=torch.float32):
    """Every leaf drawn (``inputs.weights(style="random")``), the linear
    weights and bias tables N(0, 0.02²) as the driver draws them."""
    shapes = R.swin_gan_shapes(CFG)[0]
    w = inputs.weights(shapes, seed, "gen", "cpu", "random")
    w.update({k: v for k, v in drv.weights(CFG, seed, "cpu")[0].items()
              if drv.is_table(k, shapes[k])})
    return {k: v.to(dtype) for k, v in w.items()}


def test_the_stages_take_every_case():
    dims = [16, 8, 4, 2]
    got = [stage_window((s,) * 3, 7, True) for s in dims]
    assert got == [((7,) * 3, (3,) * 3), ((7,) * 3, (3,) * 3), ((4,) * 3, (0,) * 3),
                   ((2,) * 3, (0,) * 3)]


def test_shapes_are_the_programs():
    gen, disc = build_models("pc-bssfp", _mcfg(), "cpu")
    want = R.swin_gan_shapes(CFG)
    got = tuple({k: tuple(v.shape) for k, v in m.state_dict().items()} for m in (gen, disc))
    assert got == want
    assert gen.swin_unetr.swin.layers3.blocks[0].attn.relative_position_bias_table.shape == (
        13 ** 3, 12)


# f64: the program and the reference are the same equations, computed in
# other orders (SDPA against the softmax written out, gathers against roll
# and partition, LayerNorm's kernel against its moments written out): 1e-10
# of the output's largest magnitude. f32: the same orders at 2^-24, over
# some 60 layers: 1e-4.
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("train_mode", [False, True])
def test_generator_forward(dtype, packed, train_mode):
    gen = Generator("pc-bssfp", 24, 6, packed=packed, backbone="swin_unetr",
                    swin=dict(feature_size=12)).to(dtype)
    w = _random_weights(3, dtype)
    gen.load_state_dict(w)
    gen.train(train_mode)
    x = torch.randn(2, 32, 32, 32, 24, generator=torch.Generator().manual_seed(5), dtype=dtype)
    with torch.no_grad():
        got, want = gen(x), R.generator(w, x, CFG, train_mode)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert float((got - want).abs().max() / want.abs().max()) <= tol


def test_gan_step_matches_the_reference():
    """Three GAN steps through ``make_train_step`` (the driver's set-up, f32
    on the CPU) against the reference's ``gan_steps`` from the same weights
    and batches: the losses, each leaf's gradient norm at step 1 and each
    leaf's change after step 3. Losses: f32 orders, 1e-4 relative. Gradient
    norms: 1e-3 of the larger of the leaf's and the median leaf's norm.
    Changes: AdamW's first steps move an element by about ±lr whatever its
    gradient's size, so an element whose gradient is rounding noise moves
    as the rounding falls; 0.02 of the larger of the leaf's change and the
    median leaf's."""
    c = drv.setup(CFG, TRAFFIC, 20260101, "cpu")
    prog = c.record
    del c
    ref = drv.reference(CFG, TRAFFIC, 20260101, "cpu")
    gaps = check.training_gaps(prog, ref)
    assert gaps["loss_gap"] <= 1e-4 and gaps["grad_gap"] <= 1e-3, gaps
    assert gaps["change_gap"] <= 0.02, (gaps, check.worst_leaves(prog, ref))
    assert len(ref.grad1) == len(prog.grad1) == len(prog.delta)


def _windows_by_hand(x, dims, ws, sh):
    """MONAI's partition of a padded, rolled (1, D, H, W, 1) tensor into
    windows, element by element: window (a, b, c) holds the rolled grid's
    (a·ws0 + i, b·ws1 + j, c·ws2 + k), token (i, j, k) row-major."""
    rolled = torch.roll(x, shifts=tuple(-s for s in sh), dims=(1, 2, 3))
    out = []
    for a in range(dims[0] // ws[0]):
        for b in range(dims[1] // ws[1]):
            for c in range(dims[2] // ws[2]):
                for i in range(ws[0]):
                    for j in range(ws[1]):
                        for k in range(ws[2]):
                            out.append(float(rolled[0, a * ws[0] + i, b * ws[1] + j,
                                                    c * ws[2] + k, 0]))
    return torch.tensor(out)


def test_window_mask_and_padded_tokens_follow_the_equations():
    """A 1-channel grid of 5 × 9 × 16 tokens, each holding 1 + its flat
    index: d (5) takes a window of 5 and no shift, h (9) and w (16) windows
    of 7, padded to 14 and 21, shifted by 3. The block's gathers put every
    token, and a zero for every padding token, where MONAI's roll and
    partition put them, and take them back exactly; the mask is −100
    between two tokens of a window whose shift regions (three an axis on
    the padded grid: [0, P − 7), [P − 7, P − 3), [P − 3, P)) differ, and 0
    elsewhere, padding tokens included."""
    dims = (5, 9, 16)
    ws, sh = stage_window(dims, 7, True)
    assert ws == (5, 7, 7) and sh == (0, 3, 3)
    pdims = (5, 14, 21)
    x = (torch.arange(5 * 9 * 16, dtype=torch.float64) + 1).view(1, 5, 9, 16, 1)
    xp = F.pad(x, (0, 0, 0, 21 - 16, 0, 14 - 9, 0, 0))
    blk = SwinBlock(1, 1, 7, True, 4.0)
    fwd, rev = blk._indices(dims, ws, sh, torch.device("cpu"))
    windowed = xp.reshape(1, -1, 1).index_select(1, fwd)
    assert torch.equal(windowed.flatten(), _windows_by_hand(xp, pdims, ws, sh).double())
    assert torch.equal(windowed.index_select(1, rev).view(1, 5, 9, 16, 1), x)
    assert int((windowed == 0).sum()) == 5 * 14 * 21 - 5 * 9 * 16  # the padding, zeros

    def region(p, n, w, s):
        return 0 if p < n - w else (1 if p < n - s else 2)

    labels = torch.tensor([[[(region(d, 5, 5, 0), region(h, 14, 7, 3), region(w, 21, 7, 3))
                             for w in range(21)] for h in range(14)] for d in range(5)])
    want = []
    for b in range(2):
        for c in range(3):
            lab = [tuple(labels[i, b * 7 + j, c * 7 + k].tolist())
                   for i in range(5) for j in range(7) for k in range(7)]
            want.append([[0.0 if p == q else MASKED for q in lab] for p in lab])
    want = torch.tensor(want)
    assert torch.equal(shift_mask(pdims, ws, sh), want)
    assert torch.equal(R.compute_mask(pdims, ws, sh, "cpu"), want)
    # window 1 (d 0, h 0..6, w 7..13 of the rolled grid): its token 6 is the
    # padding token w 16 (h 3), in region 0 with the real tokens 0..5 beside
    # it (token 5: h 3, w 15, 1 + 3·16 + 15): it attends to them unmasked,
    # and they to it
    n = 5 * 7 * 7
    assert windowed[0, n + 6, 0] == 0 and windowed[0, n + 5, 0] == 64
    assert want[1, 6, 5] == 0.0 and want[1, 5, 6] == 0.0


def test_state_dict_round_trips_through_a_checkpoint(tmp_path):
    """A GAN state with the Swin backbone saved by the checkpoint manager and
    loaded into a state drawn from another seed: every weight, buffer and
    AdamW entry equal, the forward bit for bit."""
    mcfg, tcfg = _mcfg(), TrainConfig()
    src = create_gan_state(1, "pc-bssfp", mcfg, tcfg, "cpu")
    table = src.gen.swin_unetr.swin.layers1.blocks[1].attn.relative_position_bias_table
    assert float(table.detach().std()) > 0.01  # the init draws it, N(0, 0.02²)
    manager = CheckpointManager(str(tmp_path / "ck"), config_json=Config(model=mcfg).to_json())
    manager.save(0, src, {"val_loss": 1.0})
    dst = create_gan_state(2, "pc-bssfp", mcfg, tcfg, "cpu")
    load_checkpoint(str(tmp_path / "ck" / "0"), dst)
    for a, b in ((src.gen, dst.gen), (src.disc, dst.disc)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    saved = json.loads((tmp_path / "ck" / "config.json").read_text())["model"]
    assert saved["backbone"] == "swin_unetr" and saved["swin_feature_size"] == 12
    x = torch.randn(1, 32, 32, 32, 24)
    src.gen.eval()
    dst.gen.eval()
    with torch.no_grad():
        assert torch.equal(src.gen(x), dst.gen(x))


def test_predict_fn_serves_a_64_patch():
    """``make_predict_fn`` on a 64³ patch with the Swin backbone at the small
    widths (stage 1 32³ padded to 35³, stage 3 8³ padded to 14³, stage 4
    4³ clamped): the eval-mode forward, under ``inference_mode``."""
    gen, _ = build_models("pc-bssfp", _mcfg(), "cpu")
    gen.load_state_dict(_random_weights(4))
    predict = make_predict_fn(gen)
    x = torch.randn(1, 64, 64, 64, 24, generator=torch.Generator().manual_seed(6))
    y = predict(x)
    assert y.shape == (1, 64, 64, 64, 6) and torch.isfinite(y).all()
    w = {k: v for k, v in gen.state_dict().items()}
    torch.testing.assert_close(y, R.generator(w, x, CFG, False), rtol=0, atol=1e-4 * float(
        y.abs().max()))


def test_sides_off_the_grid_are_refused():
    gen = Generator("pc-bssfp", 24, 6, backbone="swin_unetr", swin=dict(feature_size=12))
    with pytest.raises(ValueError, match="multiple of 32"):
        gen(torch.randn(1, 48, 32, 32, 24))
    with pytest.raises(ValueError, match="basic_unet"):
        Generator("pc-bssfp", backbone="swin_unetr", remat=True)
    with pytest.raises(ValueError, match="unknown backbone"):
        Generator("pc-bssfp", backbone="swin")


def test_train_cli_takes_the_backbone_from_config(tmp_path):
    """The train CLI's ``--config`` with ``model.backbone`` "swin_unetr":
    one epoch on a synthetic tree of 32³ volumes, 32³ patches, on the CPU;
    the best checkpoint's generator holds the Swin backbone's leaves."""
    from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids
    from unet_bssfp_tpu_torch.train.__main__ import main as train_main
    from unet_bssfp_tpu_torch.train.checkpoint import generator_state_dict

    vol = (32, 32, 32)
    bids = make_synthetic_bids(str(tmp_path / "bids"), volume_shape=vol, seed=3)
    cfg = Config(
        data=DataConfig(batch_size=2, patch_size=32, samples_per_vol=1, volume_shape=vol,
                        val_split=0.2, test_split=0.2, num_workers=1, cache_volumes=True),
        model=_mcfg(disc_features=(4, 8, 8)),
        train=TrainConfig(log_dir=str(tmp_path / "logs"), checkpoint_dir=str(tmp_path / "ck"),
                          checkpoint_top_k=1, with_perceptual=False))
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    train_main([bids, "--modalities", "pc-bssfp", "--config", str(path), "--max-epochs", "1",
                "--device", "cpu"])
    runs = list((tmp_path / "ck").iterdir())
    assert len(runs) == 1
    step = next(p for p in runs[0].iterdir() if p.is_dir())
    sd = generator_state_dict(str(step))
    assert {k: tuple(v.shape) for k, v in sd.items()} == R.swin_gan_shapes(CFG)[0]
