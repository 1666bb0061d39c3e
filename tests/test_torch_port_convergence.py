"""The ``CANONICAL_CPU`` convergence regime through the port
(``scripts/torch_port_convergence.py``): its config is the JAX package's
(``scripts/convergence_bench.py``'s smoke branch), its initial weights file
is the JAX package's ``PRNGKey(42)`` draw, and (slow) the port's run lands
in the band 6.487 ± 1.0 dB on the CPU."""

import json
import os
import sys

import jax
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts import convergence_bench  # noqa: E402
from scripts import torch_port_convergence as conv  # noqa: E402


@pytest.fixture(autouse=True)
def _keep_prng_impl():
    """The JAX package's Trainer and create_gan_state switch JAX's default
    PRNG implementation for the process; put it back for the next test."""
    impl = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", impl)


class _Captured(Exception):
    pass


def test_config_is_the_jax_regimes(tmp_path, monkeypatch):
    """``convergence_bench.run``'s own config for CANONICAL_CPU (captured
    where it builds its Trainer) equals the port's but for paths."""
    import unet_bssfp_tpu.train.loop as jax_loop

    seen = {}

    def capture(config, modality, **kw):
        seen.update(config=config, modality=modality)
        raise _Captured

    monkeypatch.setenv("CONVBENCH_DATA", str(tmp_path / "data"))
    monkeypatch.setattr(jax_loop, "Trainer", capture)
    c = convergence_bench.CANONICAL_CPU
    with pytest.raises(_Captured):
        convergence_bench.run(c["epochs"], c["smoke"], c["full_objective"], c["linked"],
                              c["samples_per_vol"])
    ref = json.loads(seen["config"].to_json())
    got = json.loads(conv.port_config(str(tmp_path), 42).to_json())
    for cfg in (ref, got):
        cfg["data"].pop("data_dir")
        cfg["train"].pop("log_dir")
        cfg["train"].pop("checkpoint_dir")
    assert got == ref and seen["modality"] == "pc-bssfp"
    assert c["smoke"] and c["linked"] and not c["full_objective"]


def test_init_file_is_the_jax_draw(tmp_path):
    path = conv.write_init(str(tmp_path / "init.pt"))
    ref = torch.load(path, weights_only=True)
    got = torch.load(conv.INIT_FILE, weights_only=True)
    assert got.keys() == ref.keys() == {"gen", "disc"}
    for m in ref:
        assert got[m].keys() == ref[m].keys()
        assert all(torch.equal(got[m][k], ref[m][k]) for k in ref[m]), m


@pytest.mark.slow
def test_canonical_cpu_in_band_on_the_port(tmp_path):
    """The regime through the port's Trainer on the CPU, from the JAX
    package's initial draw, lands in the band (both directions)."""
    rec = conv.run_port("cpu", seed=42, root=str(tmp_path))
    lo, hi = conv.band()
    assert rec["epochs"] == convergence_bench.CANONICAL_CPU["epochs"]
    assert rec["train_L1_last"] < rec["train_L1_first"]
    assert lo <= rec["val_psnr_last"] <= hi, rec
