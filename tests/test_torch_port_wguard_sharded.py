"""The ``wguard`` layout (``UNET_BSSFP_WGUARD=1``) in the sharded training
step, against the JAX package on the CPU: one guarded packed GAN step on
(data, space) meshes (1, 2) and (2, 2) of CPU positions against the JAX
package's guarded packed step on the same meshes of its CPU devices and on
its 8-device data mesh, by ``test_torch_port_sharded_step.py``'s check. The
batch is 8 × 32 × 16 × 16, so g = 8 (row width 24); dropout is 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import ModelConfig as JaxModelConfig
from unet_bssfp_tpu.config import TrainConfig as JaxTrainConfig
from unet_bssfp_tpu.parallel.mesh import make_mesh as jax_make_mesh, shard_batch as jax_shard
from unet_bssfp_tpu.train.state import build_models as jax_build_models
from unet_bssfp_tpu.train.steps import make_train_step as jax_make_train_step
from unet_bssfp_tpu_torch.config import TrainConfig
from unet_bssfp_tpu_torch.models.packed_layers import guard_cols
from unet_bssfp_tpu_torch.parallel.mesh import make_mesh
from unet_bssfp_tpu_torch.train.steps import make_train_step
from test_torch_port_sharded_step import (
    DISC_FEATURES,
    FEATURES,
    LR,
    SHAPE,
    _batch,
    _check_against_jax,
    _jax_state,
    _port_state,
)

torch.set_num_threads(1)

WGUARD = "UNET_BSSFP_WGUARD"
MESH_SHAPES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def jax_guarded():
    """The JAX package's guarded packed models, initial state and its step
    on each mesh (the packed conv shard_mapped, d halos exchanged) and on
    its 8-device data mesh: the metrics and BatchNorm statistics after it.
    Every trace happens here, with the variable set."""
    assert len(jax.devices()) == 8, "conftest must provision 8 CPU devices"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(WGUARD, "1")
        jcfg = JaxModelConfig(features=FEATURES, disc_features=DISC_FEATURES,
                              compute_dtype="float32", dropout=0.0, folded=False, packed=True)
        jtcfg = JaxTrainConfig(lr=LR)
        jgen, jdisc = jax_build_models("pc-bssfp", jcfg)
        jstate = _jax_state(jgen, jdisc, jtcfg, 11)
        x, y = _batch()

        def run(n, axes, shape):
            jmesh = jax_make_mesh(n, axes=axes, shape=shape)
            step = jax_make_train_step(jgen, jdisc, jtcfg, mesh=jmesh, donate=False)
            batch = jax_shard(jmesh, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
            new, metrics = step(jstate, batch["x"], batch["y"])
            return ({k: float(v) for k, v in metrics.items()},
                    {k: jax.tree.map(np.asarray, getattr(new, k))
                     for k in ("gen_batch_stats", "disc_batch_stats")})

        steps = {shape: run(shape[0] * shape[1], ("data", "space"), shape)
                 for shape in MESH_SHAPES}
        steps[(8,)] = run(8, ("data",), (8,))
    return jstate, steps


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_sharded_train_step_with_guards_matches_jax(monkeypatch, jax_guarded, mesh_shape):
    """One GAN step on the mesh, whole batches given (the step shards them),
    both packages guarded: the metrics against JAX's step on the same mesh,
    the BatchNorm statistics against it and its step on (8,)."""
    monkeypatch.setenv(WGUARD, "1")
    assert guard_cols(*SHAPE[2:]) == 8
    jstate, steps = jax_guarded
    mesh = make_mesh(["cpu"] * (mesh_shape[0] * mesh_shape[1]), ("data", "space"), mesh_shape)
    state = _port_state(jstate, mesh, packed=True)
    assert state.gen.unet.packed
    step = make_train_step(state.gen, state.disc, TrainConfig(lr=LR), mesh=mesh)
    x, y = _batch()
    got = step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert state.step == 1
    _check_against_jax(state, got, steps[mesh_shape], steps[(8,)])
