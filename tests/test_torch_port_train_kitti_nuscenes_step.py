"""One Adam step of the nuScenes recipe's train line through the port
against the JAX package's, on the CPU: ``tracking,ddd`` with the 3-D heads
at ``--dla_node conv``, float32, 64x128, batch 2, held to
``test_torch_port_train_step.py``'s criteria
(``test_torch_port_train_kitti_nuscenes.py::adam_step_check``, whose
docstring states them; apart from KITTI's step so that each file's JAX
compile runs on its own test worker).
"""

from __future__ import annotations

from test_torch_port_train_kitti_nuscenes import (  # noqa: F401
    adam_step_check, data, few_threads)


def test_one_adam_step_matches_jax_nuscenes(data):  # noqa: F811
    adam_step_check(data, "nuscenes")
