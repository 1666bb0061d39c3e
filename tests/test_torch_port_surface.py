"""The port's public surface (``model.py``, ``data_module.py`` and the two
helpers) against the JAX package's ``src/`` wrappers on the CPU:
``bSSFPToDWITensorModel``'s forward and one GAN step's losses on carried
weights, ``unpack_batch``, a ``load_from_checkpoint`` round trip;
``MultiInputUNetModel``'s TRANSFER graft against JAX's ``transfer_params``,
its frozen backbone and its FINE_TUNE lr; ``PerceptualL1Loss`` on carried
random MedicalNet weights; ``check_input_shape``; ``print_data_samples``;
``build_trainer_args`` and ``run_concurrently``. Features 8/8/16/16/32/8,
disc 8/8/16, f32, 16³ patches."""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from src import eval as jax_src_eval  # noqa: E402
from src import model as jax_src_model  # noqa: E402
from src import train as jax_src_train  # noqa: E402
from unet_bssfp_tpu.config import Config as JaxConfig  # noqa: E402
from unet_bssfp_tpu.models import medicalnet as jmn  # noqa: E402
from unet_bssfp_tpu.models.multi_input_unet import MultiInputUNet as JaxMultiInputUNet  # noqa: E402
from unet_bssfp_tpu.train.multistage import transfer_params as jax_transfer_params  # noqa: E402
from unet_bssfp_tpu.train.state import GANTrainState as JaxGANTrainState  # noqa: E402
from unet_bssfp_tpu.train.state import make_optimizer as jax_make_optimizer  # noqa: E402
from unet_bssfp_tpu_torch import weights  # noqa: E402
from unet_bssfp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig  # noqa: E402
from unet_bssfp_tpu_torch.data_module import make_synthetic_bids, print_data_samples  # noqa: E402
from unet_bssfp_tpu_torch.eval import run_concurrently  # noqa: E402
from unet_bssfp_tpu_torch.model import (  # noqa: E402
    MultiInputUNetModel,
    PerceptualL1Loss,
    bSSFPToDWITensorModel,
    check_input_shape,
)
from unet_bssfp_tpu_torch.models import medicalnet as mn  # noqa: E402
from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState  # noqa: E402
from unet_bssfp_tpu_torch.train import build_trainer_args  # noqa: E402
from unet_bssfp_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from test_torch_port_models import random_variables  # noqa: E402

torch.set_num_threads(1)

MOD = "pc-bssfp"
PATCH = 16
FEATURES = (8, 8, 16, 16, 32, 8)
DISC = (8, 8, 16)
# tests/test_torch_port_models.py's model tolerance (f32, another
# summation order in every conv)
TOL = dict(rtol=2e-4, atol=2e-5)
# lr 3e-5 and each loss within 1e-3·max(|ref|, 1): the GAN step's bound
# (tests/test_torch_parity.py:364-371, 425-430; at 1e-3 early AdamW moves
# near-zero gradients' weights by ±2·lr on a rounding's sign)
LR = 3e-5


@pytest.fixture(autouse=True)
def _keep_prng_impl():
    """The JAX package's create_gan_state switches JAX's default PRNG
    implementation for the process; put it back for the next test."""
    impl = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", impl)


def _config(**model):
    kw = dict(features=FEATURES, disc_features=DISC, compute_dtype="float32", dropout=0.0)
    kw.update(model)
    return Config(data=DataConfig(patch_size=PATCH, volume_shape=(PATCH,) * 3),
                  model=ModelConfig(**kw), train=TrainConfig())


def _batch(seed, n=2, cin=24):
    rng = np.random.default_rng(seed)
    return (rng.random((n, PATCH, PATCH, PATCH, cin), dtype=np.float32),
            rng.random((n, PATCH, PATCH, PATCH, 6), dtype=np.float32))


@pytest.fixture(scope="module")
def gan():
    """JAX's ``bSSFPToDWITensorModel`` holding seeded values on its models'
    variable trees (``jax.eval_shape`` of their inits: an eager Flax init of
    the generator compiles for most of a minute here) and the port's wrapper
    holding the same weights."""
    cfg = _config()
    jcfg = JaxConfig.from_json(cfg.to_json())
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, folded=False))
    jm = jax_src_model.bSSFPToDWITensorModel(MOD, lr=LR, config=jcfg, with_perceptual=False)
    x, y = _batch(0, n=1)
    zeros = lambda tree: jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), tree)  # noqa: E731
    key = jax.random.PRNGKey(3)
    gv = random_variables(zeros(jax.eval_shape(
        functools.partial(jm.gen.init, train=False), key, x)), 6)
    dv = random_variables(zeros(jax.eval_shape(
        functools.partial(jm.discr.init, train=False), key, x, y)), 7)
    opt = jax_make_optimizer(jm.config.train)
    jm.state = JaxGANTrainState(
        step=jnp.zeros((), jnp.int32), rng=key,
        gen_params=gv["params"], gen_batch_stats=gv["batch_stats"],
        disc_params=dv["params"], disc_batch_stats=dv["batch_stats"],
        gen_opt_state=opt.init(gv["params"]), disc_opt_state=opt.init(dv["params"]))
    pm = bSSFPToDWITensorModel(MOD, lr=LR, config=cfg, with_perceptual=False, device="cpu")
    pm.init(0)
    weights.state_from_flax(pm.gen, pm.discr, {
        k: jax.tree.map(np.asarray, getattr(jm.state, k))
        for k in ("gen_params", "gen_batch_stats", "disc_params", "disc_batch_stats")})
    return dict(cfg=cfg, jm=jm, pm=pm)


def test_gan_wrapper_forward_then_step_match_jax(gan):
    """The eval-mode forward, one GAN step's losses, then the forward again
    (the step left the generator in train mode; ``forward`` is eval mode)."""
    jm, pm = gan["jm"], gan["pm"]
    assert pm.config.train.lr == jm.config.train.lr == LR
    assert pm.recon_criterion is None and jm.recon_criterion is None
    x, y = _batch(1)
    np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.forward(jnp.asarray(x))), **TOL)
    jm.state, ref = jm.train_step(jm.state, jnp.asarray(x), jnp.asarray(y))
    got = pm.train_step(pm.state, torch.from_numpy(x), torch.from_numpy(y))
    assert got.keys() == ref.keys()
    for k in ref:
        r = float(ref[k])
        assert float(got[k]) == pytest.approx(r, abs=1e-3 * max(abs(r), 1.0)), k
    assert pm.state.step == int(jm.state.step) == 1
    x2, _ = _batch(2)
    out = pm.forward(torch.from_numpy(x2))
    assert not pm.gen.training
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.forward(jnp.asarray(x2))),
                               rtol=0, atol=1e-3 * max(float(out.abs().max()), 1.0))
    metrics, y_hat = pm.eval_step(pm.state, torch.from_numpy(x), torch.from_numpy(y))
    assert "val_metric_PSNR" in metrics and y_hat.shape == (2, PATCH, PATCH, PATCH, 6)


def test_gan_wrapper_unpack_batch_as_jax(gan):
    batch = {MOD: np.zeros(1), "dwi-tensor": np.ones(1), "dwi-tensor_orig": np.full(1, 2.0)}
    for test in (False, True):
        got = gan["pm"].unpack_batch(batch, test=test)
        ref = gan["jm"].unpack_batch(batch, test=test)
        assert all(a is b for a, b in zip(got, ref))
    assert gan["pm"].unpack_batch(batch)[1] is batch["dwi-tensor_orig"]


def test_gan_wrapper_load_from_checkpoint_round_trip(gan, tmp_path):
    pm, cfg = gan["pm"], gan["cfg"]
    mgr = ckpt.CheckpointManager(str(tmp_path / f"{MOD}-run"), top_k=1,
                                 config_json=cfg.to_json())
    mgr.save(0, pm.state, {"val_loss": 1.0})
    back = bSSFPToDWITensorModel.load_from_checkpoint(
        mgr.best_path(), MOD, lr=LR, config=cfg, with_perceptual=False, device="cpu")
    assert back.state.step == pm.state.step
    for a, b in ((back.gen, pm.gen), (back.discr, pm.discr)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    for a, b in ((back.state.gen_opt, pm.state.gen_opt), (back.state.disc_opt, pm.state.disc_opt)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    x, _ = _batch(3)
    assert torch.equal(back(torch.from_numpy(x)), pm(torch.from_numpy(x)))


def test_wrappers_need_a_card_unless_the_cpu_is_asked_for():
    """No fallback: without ``device`` the wrappers run on ``cuda``; on a
    machine without one they raise."""
    if torch.cuda.is_available():
        assert MultiInputUNetModel(config=_config()).device.type == "cuda"
        return
    for make in (lambda: MultiInputUNetModel(config=_config()),
                 lambda: bSSFPToDWITensorModel(MOD, config=_config()),
                 lambda: PerceptualL1Loss()):
        with pytest.raises(RuntimeError, match="CUDA was asked for"):
            make()


# ---- MultiInputUNetModel ---------------------------------------------------

def _to_flax(sd, template):
    """A port ``state_dict`` as the Flax ``params`` tree of ``template``'s
    structure (the inverse of ``weights.from_flax``; checked by converting
    back)."""
    leaf = {"kernel": "weight", "scale": "weight"}

    def one(path, t):
        keys = tuple(p.key for p in path)
        a = sd[".".join(keys[:-1] + (leaf.get(keys[-1], keys[-1]),))].numpy()
        if keys[-1] == "kernel":
            if keys[-2] == "upsample":
                return np.ascontiguousarray(np.transpose(a, (2, 3, 4, 0, 1))[::-1, ::-1, ::-1])
            return np.ascontiguousarray(np.transpose(a, (2, 3, 4, 1, 0)))
        return a

    out = jax.tree_util.tree_map_with_path(one, template)
    back = weights.from_flax(out)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    return out


def _jax_param_shapes(modality):
    net = JaxMultiInputUNet(modality=modality, features=FEATURES, dropout=0.0,
                            dtype=jnp.float32, use_fused=False, packed=False)
    x = jnp.zeros((1, PATCH, PATCH, PATCH, 6 if modality == "dwi-tensor" else 24))
    shapes = jax.eval_shape(functools.partial(net.init, train=False), jax.random.PRNGKey(0), x)
    return net, jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes["params"])


class _ShapeInit:
    """A JAX net whose ``init`` gives zeros of its real ``init``'s shapes
    (traced by ``jax.eval_shape``, not compiled)."""

    def __init__(self, net):
        self.net, self.modality = net, net.modality

    def init(self, rngs, x, train=False):
        shapes = jax.eval_shape(functools.partial(self.net.init, train=train), rngs, x)
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)


def test_multistage_wrapper_stages_as_jax():
    """PRETRAIN step → TRANSFER to pc-bssfp: the graft equals JAX's
    ``transfer_params`` on the trained weights (the backbone taken, the
    head fresh), the TRANSFER step leaves the backbone bit for bit and moves
    the head → FINE_TUNE at ``finetune_lr`` moves everything. The
    eval-mode ``__call__`` repeats bit for bit under dropout."""
    cfg = _config(multistage_features=FEATURES, dropout=0.05)
    m = MultiInputUNetModel(config=cfg, device="cpu")
    assert m.state_enum == TrainingState.PRETRAIN and m.modality == "dwi-tensor"
    x6, y = _batch(4, cin=6)
    metrics = m.step(torch.from_numpy(x6), torch.from_numpy(y))
    assert set(metrics) == {"train_loss", "train_loss_L1", "train_loss_SSIM"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    pre = {k: v.clone() for k, v in m.params.items()}
    assert not all(torch.equal(pre[k], v) for k, v in
                   weights.init_state_dict(m.net, cfg.train.seed).items())

    jnet_pre, tmpl_pre = _jax_param_shapes("dwi-tensor")
    jpre = _to_flax(pre, tmpl_pre)
    jnet, _ = _jax_param_shapes(MOD)
    jout = weights.from_flax(jax_transfer_params(jpre, _ShapeInit(jnet), jax.random.PRNGKey(1),
                                                 PATCH))
    m.change_training_state(TrainingState.TRANSFER, MOD)
    assert m.modality == MOD and m.net.modality == MOD
    got = m.params
    assert got.keys() == jout.keys()
    grafted = {k for k in jout if k in pre and torch.equal(jout[k], pre[k])}
    assert grafted == {k for k in got if k in pre and torch.equal(got[k], pre[k])}
    assert grafted == {k for k in got if k.startswith("unet.")}
    assert all(k.startswith("head_head24") for k in set(got) - grafted)

    x24, y = _batch(5)
    before = {k: v.clone() for k, v in m.params.items()}
    m.step(torch.from_numpy(x24), torch.from_numpy(y))
    after = m.params
    assert all(torch.equal(after[k], before[k]) for k in after if k.startswith("unet."))
    assert not all(torch.equal(after[k], before[k]) for k in after if k.startswith("head"))
    opt = m.sup_state.opt
    assert [g["lr"] for g in opt.param_groups] == [cfg.train.lr]
    assert {id(p) for g in opt.param_groups for p in g["params"]} == {
        id(p) for n, p in m.net.named_parameters() if n.startswith("head")}

    m.change_training_state(TrainingState.FINE_TUNE, MOD)
    kept = {k: v.clone() for k, v in m.params.items()}
    assert all(torch.equal(kept[k], after[k]) for k in kept)
    assert [g["lr"] for g in m.sup_state.opt.param_groups] == [cfg.train.finetune_lr]
    m.step(torch.from_numpy(x24), torch.from_numpy(y))
    assert not all(torch.equal(m.params[k], kept[k]) for k in kept if k.startswith("unet."))

    x = torch.from_numpy(x24)
    assert torch.equal(m(x), m(x)) and not m.net.training


# ---- the rest of the surface ------------------------------------------------

@pytest.fixture(scope="module")
def medicalnet():
    """Seeded values on the JAX MedicalNet's variable tree (``jax.eval_shape``
    of its init: an eager init compiles for most of half a minute), and the
    port's net holding them."""
    shapes = jax.eval_shape(functools.partial(jmn.MedicalNetResNet10().init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)))
    variables = random_variables(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes), 9)
    port = mn.init_medicalnet(seed=1)
    port.load_state_dict(weights.medicalnet_from_flax(jax.tree.map(np.asarray, variables)))
    return variables, port


def test_perceptual_l1_loss_matches_jax(medicalnet):
    variables, port = medicalnet
    rng = np.random.default_rng(8)
    a, b = (rng.standard_normal((2, PATCH, PATCH, PATCH, 3)).astype(np.float32)
            for _ in range(2))
    ref = jax_src_model.PerceptualL1Loss(1e3, variables=variables)(jnp.asarray(a),
                                                                   jnp.asarray(b))
    loss = PerceptualL1Loss(1e3, net=port)
    assert loss.get_perceptual_model() is port
    with torch.no_grad():
        got = loss(torch.from_numpy(a), torch.from_numpy(b))
    assert list(got) == list(ref) == ["L1", "Perceptual"]
    assert float(got["L1"]) == pytest.approx(float(ref["L1"]), rel=1e-6)
    # tests/test_torch_port_medicalnet.py's bound on the distance
    assert float(got["Perceptual"]) == pytest.approx(float(ref["Perceptual"]), rel=1e-4)
    own = PerceptualL1Loss(device="cpu")
    assert isinstance(own.net, mn.MedicalNetResNet10) and not own.net.training


@pytest.mark.parametrize("shape", [(96, 128, 128), (16, 16, 16), (32, 48, 64, 24),
                                   (96, 128, 120), (15, 16, 16), (16, 8, 16)])
def test_check_input_shape_as_jax(shape):
    errors = []
    for fn in (jax_src_model.check_input_shape, check_input_shape):
        try:
            fn(shape)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]


def test_print_data_samples_writes_its_png(tmp_path, capsys):
    root = make_synthetic_bids(str(tmp_path / "bids"), subjects=("01", "02", "03", "04"),
                               sessions=("1",), volume_shape=(16, 16, 16))
    out = print_data_samples(root, str(tmp_path / "augmentation.png"), device="cpu")
    assert out == str(tmp_path / "augmentation.png")
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    printed = capsys.readouterr().out
    assert "Number of samples:    4" in printed
    assert "'pc-bssfp'" in printed and "'dwi-tensor_orig'" in printed
    assert "(8, 64, 64, 64, 24) (8, 64, 64, 64, 6)" in printed


def test_build_trainer_args_and_run_concurrently_as_jax():
    cfg = _config()
    got = build_trainer_args(True, MOD, cfg)
    ref = jax_src_train.build_trainer_args(True, MOD, JaxConfig.from_json(cfg.to_json()))
    assert got.keys() == ref.keys() and got["config"] is cfg
    assert (got["modality"], got["debug"]) == (ref["modality"], ref["debug"])
    assert build_trainer_args(False, "t1w")["config"] == Config()
    items = list(range(23))
    for n in (1, 4):
        assert run_concurrently(lambda i: i * i, items, n) == \
            jax_src_eval.run_concurrently(lambda i: i * i, items, n) == [i * i for i in items]
