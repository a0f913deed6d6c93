"""Data-parallel training of the port against the JAX package's sharded
step on the CPU: two gloo ranks through ``train_rank`` against
``make_train_step`` on a mesh of two of the eight CPU devices that
``tests/conftest.py`` sets, the global batch sharded over its ``data``
axis by ``shard_batch`` (the JAX trainer's path, root ``train.py:82,
:116``), from the same weights on the same global batch
(``tests/torch_port_ddp_setup.py`` says what the data, the runs and the
criteria are).

The loss statistics within 1e-4 relative; the weights after the Adam step
by ``check_adam_step`` (the gradients' signs where they are float32 noise
differ between any two float32 runs); the BatchNorm running statistics
within 1e-4 x max(1, max|value|), ``test_torch_port_train_step.py``'s
tolerance against flax (its update carries 0.1 x the batch variance, which
flax takes as E[x^2] - E[x]^2 in float32); ``s_det`` and ``s_id`` within
1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np

from deft_tpu.cli import parse_config as jax_parse_config
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.dla import DLA_PLANS
from deft_tpu.parallel.mesh import make_mesh, shard_batch
from deft_tpu.train.torch_convert import TorchConverter
from deft_tpu.train.trainer import (create_train_state, make_optimizer,
                                    make_train_step)
from deft_tpu_torch.convert import from_jax_variables
from torch_port_ddp_setup import (ARGV, WORLD,  # noqa: F401
                                  check_adam_step, check_losses, data,
                                  few_threads, global_batch, gloo_run,
                                  one_process)

STEPS_PER_EPOCH = 1


def test_gloo_step_matches_jax_sharded_step(data, gloo_run, one_process):
    ranks, _ = gloo_run
    _, init, grads, trainer = one_process
    jcfg, _ = jax_parse_config(ARGV)
    params, stats = TorchConverter(jcfg.dataset).convert_dla34(
        {k: v.numpy() for k, v in init.items()}, jcfg.heads, jcfg.dla_node,
        DLA_PLANS["34"][0])
    model = jax_create_model(jcfg.arch, jcfg)
    mesh = make_mesh(devices=jax.devices()[:WORLD])
    assert mesh.shape["data"] == WORLD
    tx = make_optimizer(jcfg, STEPS_PER_EPOCH)
    state = create_train_state(model, jcfg, params, stats, STEPS_PER_EPOCH)
    batch = shard_batch({k: jnp.asarray(v)
                         for k, v in global_batch(data).items()}, mesh)
    new, want = make_train_step(model, jcfg, tx, mesh)(state, batch)
    check_losses(ranks[0]["stats"]["first"], want)
    jsd = from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, new.params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, new.batch_stats)},
        jcfg)
    jsd = {k: v.numpy() for k, v in jsd.items()}
    got = {k: v.numpy() for k, v in ranks[0]["state_dict"].items()
           if not k.endswith("num_batches_tracked")}
    check_adam_step(got, jsd, grads, dict(trainer.model.named_parameters()),
                    trainer.cfg.lr, 1e-4)
    assert abs(ranks[0]["s_det"] - float(new.s_det)) <= 1e-7
    assert abs(ranks[0]["s_id"] - float(new.s_id)) <= 1e-7
