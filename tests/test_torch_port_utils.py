"""The port's logging and utilities against the JAX package's, on the CPU:
``EarlyStopping`` on the same metric sequences, ``MetricLogger``'s CSV byte
for byte on the same step values, the FLOP count exactly, the watchdog's
stall-kill and resume cases (``tests/test_watchdog.py:39-104``) on the
port's copy, and the profiling and debug helpers."""

import os
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.train import logging as jax_logging
from unet_bssfp_tpu.utils import flops as jax_flops
from unet_bssfp_tpu_torch.train import logging as tlog
from unet_bssfp_tpu_torch.utils import debug, flops, profiling
from unet_bssfp_tpu_torch.utils.watchdog import WatchdogResult, newest_mtime, run_with_watchdog

QUIET = lambda *a: None  # noqa: E731

SEQUENCES = [
    [5.0, 4.0, 4.0, 4.0, 3.0, 3.5, 3.5, 3.5, 3.5],
    [1.0, 1.0, 1.0, 1.0],
    [3.0, 2.0, 1.0, 0.5],
    [None, 2.0, None, 2.0, 2.5, 1.0, 1.0, 1.0],
    [float("nan"), 1.0, 2.0, 3.0],
]


@pytest.mark.parametrize("patience", [1, 2, 3])
@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("seq", range(len(SEQUENCES)))
def test_early_stopping_stops_where_jax_does(seq, mode, patience):
    ref = jax_logging.EarlyStopping("val_gen_loss_recon", patience=patience, mode=mode)
    got = tlog.EarlyStopping("val_gen_loss_recon", patience=patience, mode=mode)
    for epoch, v in enumerate(SEQUENCES[seq]):
        row = {} if v is None else {"val_gen_loss_recon": v}
        stop = ref.update(row)
        assert got.update(row) == stop, epoch
        assert (got.best, got.count) == (ref.best, ref.count) or np.isnan(got.best)
        if stop:
            break


def _step_values(rng, n_steps, keys):
    return [{k: np.float32(rng.standard_normal() * 10.0 ** rng.integers(-3, 3))
             for k in keys} for _ in range(n_steps)]


def test_logger_csv_is_the_jax_loggers_byte_for_byte(tmp_path):
    """Three epochs of f32 step values, as 0-d tensors to the port's logger
    and as 0-d arrays to the JAX package's; a key missing in one epoch and
    new in another; ``extra`` columns; and ``write_table``."""
    rng = np.random.default_rng(5)
    ref = jax_logging.MetricLogger(str(tmp_path / "jax"))
    got = tlog.MetricLogger(str(tmp_path / "port"))
    epochs = [
        _step_values(rng, 3, ("train_gen_loss", "train_discr_loss")) +
        _step_values(rng, 2, ("val_loss", "val_metric_PSNR")),
        _step_values(rng, 4, ("train_gen_loss", "train_discr_loss")),
        _step_values(rng, 2, ("train_gen_loss", "train_discr_loss", "val_clean_loss")),
    ]
    for epoch, steps in enumerate(epochs):
        for values in steps:
            ref.log_step({k: jnp.asarray(v) for k, v in values.items()})
            got.log_step({k: torch.tensor(v) for k, v in values.items()})
        extra = {"epoch_seconds": 1.25 + epoch}
        assert got.end_epoch(epoch, extra=extra) == ref.end_epoch(epoch, extra=extra)
    read = lambda d: (tmp_path / d / "metrics.csv").read_bytes()  # noqa: E731
    assert read("port") == read("jax") and read("port").count(b"\n") == 4
    row = {"test_metric_PSNR": np.float32(12.5), "test_metric_L1": 0.25}
    assert (open(got.write_table("test_metrics.csv", row), "rb").read()
            == open(ref.write_table("test_metrics.csv", row), "rb").read())
    assert not got.wandb_enabled
    got.log_artifact(str(tmp_path), "x")  # no W&B: a no-op
    got.finish()


def test_logger_copies_the_epoch_once(tmp_path, monkeypatch):
    """The step values stay tensors until ``end_epoch``, which copies them
    to the host in one transfer per device."""
    logger = tlog.MetricLogger(str(tmp_path))
    copies = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: copies.append(1) or real(t))
    for i in range(5):
        logger.log_step({"a": torch.tensor(float(i)), "b": torch.tensor(2.0 * i)})
    assert copies == []
    assert logger.end_epoch(0) == {"a": 2.0, "b": 4.0}
    assert len(copies) == 1


def test_log_step_touches_heartbeat(tmp_path):
    logger = tlog.MetricLogger(str(tmp_path / "run"))
    hb = tmp_path / "run" / "heartbeat"
    assert not hb.exists()
    logger.log_step({"train_gen_loss": torch.tensor(1.0)})
    first = hb.stat().st_mtime
    logger.log_step({"train_gen_loss": torch.tensor(1.0)})
    assert hb.stat().st_mtime == first  # within the throttle window
    logger._heartbeat_last -= tlog.HEARTBEAT_INTERVAL_S
    os.utime(hb, (first - 100, first - 100))
    logger.log_step({"train_gen_loss": torch.tensor(1.0)})
    assert hb.stat().st_mtime > first - 100
    assert newest_mtime([str(tmp_path / "run")]) >= hb.stat().st_mtime


@pytest.mark.parametrize("kw", [
    {}, dict(batch=4, patch=16), dict(reuse_fake=True),
    dict(batch=2, patch=32, in_ch=6, out_ch=6, with_perceptual=True)])
def test_flops_equal_the_jax_count(kw):
    assert flops.gan_step_flops(**kw) == jax_flops.gan_step_flops(**kw)
    assert flops.generator_fwd_flops(32, 24, 6, 24, (8, 16, 16, 32, 32, 8)) == \
        jax_flops.generator_fwd_flops(32, 24, 6, 24, (8, 16, 16, 32, 32, 8))
    assert flops.discriminator_fwd_flops(32, 24, 6, (8, 16, 32)) == \
        jax_flops.discriminator_fwd_flops(32, 24, 6, (8, 16, 32))
    assert flops.medicalnet_fwd_flops(32) == jax_flops.medicalnet_fwd_flops(32)


def test_flops_peak_table_has_the_h100_only():
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.peak_flops("TPU v5 lite") is None
    assert all(not k.startswith("TPU") for k in flops.GPU_BF16_PEAK)


# ---- the watchdog's cases (tests/test_watchdog.py:39-104) -----------------

def _child(tmp_path, body: str) -> list:
    script = tmp_path / "child.sh"
    script.write_text(textwrap.dedent(f"""\
        d={str(tmp_path)!r}
        cnt=$d/attempts
        if [ -f "$cnt" ]; then n=$(($(cat "$cnt")+1)); else n=1; fi
        printf %s $n > "$cnt"
        hb=$d/heartbeat
        {body}
    """))
    return ["/bin/sh", str(script)]


def test_newest_mtime_walks_dirs(tmp_path):
    assert newest_mtime([str(tmp_path / "missing")]) is None
    sub = tmp_path / "a" / "b"
    sub.mkdir(parents=True)
    f = sub / "metrics.csv"
    f.write_text("epoch\n")
    past = time.time() - 1000
    for p in (f, sub, sub.parent, tmp_path):
        os.utime(p, (past, past))
    got = newest_mtime([str(tmp_path)])
    assert got is not None and abs(got - past) < 5
    f.write_text("epoch\n0\n")
    assert newest_mtime([str(tmp_path)]) > past + 500


def test_stall_kill_and_resume(tmp_path):
    cmd = _child(tmp_path, """
        printf %s $n > "$hb"
        if [ $n -eq 1 ]; then sleep 600; fi
        exit 0
    """)
    res = run_with_watchdog(cmd, [str(tmp_path / "heartbeat")], stall_seconds=4.0,
                            max_restarts=2, poll_seconds=0.3, grace_seconds=1.0, log=QUIET)
    assert isinstance(res, WatchdogResult)
    assert (res.exit_code, res.restarts) == (0, 1)
    assert (tmp_path / "attempts").read_text() == "2"


def test_crash_propagates_without_restart(tmp_path):
    cmd = _child(tmp_path, """
        printf %s $n > "$hb"
        exit 7
    """)
    res = run_with_watchdog(cmd, [str(tmp_path / "heartbeat")], stall_seconds=30,
                            max_restarts=3, poll_seconds=0.1, log=QUIET)
    assert (res.exit_code, res.restarts) == (7, 0)
    assert (tmp_path / "attempts").read_text() == "1"


def test_restart_budget_exhausted(tmp_path):
    cmd = _child(tmp_path, """
        sleep 600
    """)
    res = run_with_watchdog(cmd, [str(tmp_path / "heartbeat")], stall_seconds=4.0,
                            max_restarts=1, poll_seconds=0.3, grace_seconds=1.0, log=QUIET)
    assert res.exit_code != 0 and res.restarts == 1 and res.stalled
    assert (tmp_path / "attempts").read_text() == "2"


# ---- profiling and debug ----------------------------------------------------

def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    assert prof is not None
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")


def test_check_finite_fn_names_the_bad_leaves():
    fn = debug.check_finite_fn(lambda x: {"a": x, "b": (x * 0, torch.log(x)),
                                          "n": torch.tensor([1, 2])})
    err, out = fn(torch.tensor([1.0, 2.0]))
    assert err is None and torch.equal(out["a"], torch.tensor([1.0, 2.0]))
    err, _ = fn(torch.tensor([0.0, -1.0]))
    assert isinstance(err, FloatingPointError)
    assert "out['b'][1]" in str(err) and "out['a']" not in str(err)


def test_enable_nan_checks_raises_in_the_backward():
    x = torch.tensor([-1.0], requires_grad=True)
    with debug.enable_nan_checks():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()
