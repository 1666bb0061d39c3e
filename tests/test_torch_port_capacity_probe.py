"""The exact-capacity probe (``scripts/torch_port_capacity_probe.py``)
against the JAX package on the CPU: its forward with the linked fixture's
own ``W`` and ``b`` is the fixture's generating map
(``unet_bssfp_tpu/data/synthetic.py::_linked_map``), and one of its Adam
steps is ``optax.adam``'s on the JAX probe's loss
(``scripts/capacity_probe.py``); a smoke run writes its record."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unet_bssfp_tpu.data.synthetic import _linked_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_port_capacity_probe as probe  # noqa: E402


def _fixture_params(tag):
    """``_linked_map``'s ``W`` and ``b`` for ``tag``, drawn as it draws them."""
    rng = np.random.default_rng(987650 + tag)
    w = rng.standard_normal((24, 6)).astype(np.float32) / np.sqrt(24)
    b = 0.1 * rng.standard_normal((6,)).astype(np.float32)
    return w.astype(np.float32), b


@pytest.mark.parametrize("tag", [0, 10])
def test_probe_forward_is_the_fixtures_generating_map(tag):
    x = np.random.default_rng(tag).random((2, 5, 6, 7, 24), dtype=np.float32)
    w, b = _fixture_params(tag)
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    got = probe.apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _linked_map(x, 6, tag), rtol=0, atol=1e-6)


def test_one_adam_step_matches_optax():
    """One step at lr 3e-3 from the same start on the same batch: the L1
    loss and the updated ``w`` and ``b`` against optax's Adam on the JAX
    probe's function (``Precision.HIGHEST``)."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 4, 4, 4, 24), dtype=np.float32)
    y = rng.random((2, 4, 4, 4, 6), dtype=np.float32)
    params = probe.init_params(42, "cpu")
    start = {k: v.detach().numpy().copy() for k, v in params.items()}
    opt = probe.make_optimizer(params, 3e-3)
    loss = probe.train_step(params, opt, torch.from_numpy(x), torch.from_numpy(y))

    def apply(p, xx):
        z = jnp.tanh(jax.lax.dot_general(xx - 0.5, 2.0 * p["w"], (((4,), (0,)), ((), ())),
                                         precision=jax.lax.Precision.HIGHEST) + p["b"])
        return (z + 1.0) * 0.5

    jopt = optax.adam(3e-3)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    jloss, grads = jax.value_and_grad(lambda p: jnp.mean(jnp.abs(apply(p, x) - y)))(jp)
    updates, _ = jopt.update(grads, jopt.init(jp), jp)
    jp = optax.apply_updates(jp, updates)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=1e-7, err_msg=k)
        assert not np.allclose(params[k].detach().numpy(), start[k])


def test_smoke_run_writes_one_capacity_probe_record(tmp_path, monkeypatch):
    """One epoch on the smoke fixture on the CPU: one ``capacity_probe``
    record with the given revision, appended to the named file."""
    monkeypatch.setenv("CONVBENCH_DATA", str(tmp_path / "fixture"))
    monkeypatch.setenv(probe.quality_record.GIT_REV_ENV, "abc1234")
    record = tmp_path / "record.json"
    record.write_text("[]\n")
    args = probe.parser().parse_args([
        "--smoke", "--epochs", "1", "--samples-per-vol", "4", "--device", "cpu",
        "--workdir", str(tmp_path / "work"), "--record", str(record)])
    entry = probe.run(args)
    saved = json.loads(record.read_text())
    assert saved == [entry]
    assert entry["kind"] == "capacity_probe" and entry["git"] == "abc1234"
    assert entry["device"] == "cpu" and entry["probe_epochs"] == 1
    assert np.isfinite(entry["val_psnr_last"]) and entry["val_psnr_best"] == entry["val_psnr_last"]


def test_records_name_the_revision_the_caller_gives(monkeypatch):
    """``$UNET_BSSFP_GIT_REV`` before git: a ``git archive`` copy has no
    ``.git`` to ask."""
    qr = probe.quality_record
    monkeypatch.setenv(qr.GIT_REV_ENV, "feed123")
    assert qr.git_rev() == "feed123"
    monkeypatch.delenv(qr.GIT_REV_ENV)
    assert qr.git_rev() not in ("", "feed123")
