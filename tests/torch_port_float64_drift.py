"""How far each package's float32 training step drifts from a float64 one,
at an arch of ``--arch`` (default ``dla_60``), on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_port_float64_drift.py [dla_34]

One batch of the JAX loader (``test_torch_port_archs_train.py``'s flags
and data), the port's seeded weights in both packages.  The port's step
runs again in float64: its model, batch and uncertainty weights cast, and
for this run alone the float32 casts of train-mode BatchNorm, the AFE's
embeddings and the heads' outputs taken out.  Prints the losses of the
port at float32 and float64 and of the JAX step at float32, and the share
of parameters whose float32 gradient sign (port) or first Adam step
direction (JAX) disagrees with the float64 gradient's sign.  Not a test:
it explains ``test_torch_port_archs_train.py``'s bounds.
"""

from __future__ import annotations

import random
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from test_torch_port_archs_train import DLA60, STEPS_PER_EPOCH  # noqa: E402
from torch_port_recipes import mot_dataset  # noqa: E402

from deft_tpu.cli import parse_config as jax_parse_config  # noqa: E402
from deft_tpu.data.datasets import get_dataset as jax_get_dataset  # noqa: E402
from deft_tpu.data.loader import DataLoader as JaxLoader  # noqa: E402
from deft_tpu.models import create_model as jax_create_model  # noqa: E402
from deft_tpu.models.dla import DLA_PLANS  # noqa: E402
from deft_tpu.train.torch_convert import TorchConverter  # noqa: E402
from deft_tpu.train.trainer import (create_train_state,  # noqa: E402
                                    make_optimizer, make_train_step)
from deft_tpu_torch.cli import parse_config  # noqa: E402
from deft_tpu_torch.convert import from_jax_variables  # noqa: E402
from deft_tpu_torch.models import afe, deft, layers  # noqa: E402
from deft_tpu_torch.models.factory import create_model  # noqa: E402
from deft_tpu_torch.train.trainer import (Trainer, to_device,  # noqa: E402
                                          training_keys)


def float64_forward_patches():
    """Keep float64 through the three places that cast to float32."""
    layers.BatchNorm2d.forward = lambda self, x: (
        layers.train_batch_norm(x, self) if self.training
        else torch.nn.BatchNorm2d.forward(self, x))
    extract = afe.AFE.extract
    afe.AFE.extract = lambda self, f, c: extract(self, f, c).to(f[0].dtype)

    def forward(self, image):
        y, maps = self.trunk(image)
        return ({h: getattr(self, h)(y).to(self.compute_dtype).permute(
            0, 2, 3, 1) for h in self.heads}, maps)

    deft.DEFTNet.forward = forward


def main(arch: str = "dla_60"):
    torch.set_num_threads(4)
    argv = [a for a in DLA60 if a not in ("--arch", "dla_60")] + [
        "--arch", arch]
    data = mot_dataset(Path(tempfile.mkdtemp()), frames=8, size=(384, 256))
    jcfg, _ = jax_parse_config(argv)
    pcfg, _ = parse_config(argv)
    np.random.seed(0)
    random.seed(0)
    batch = next(iter(JaxLoader(jax_get_dataset("mot")(
        jcfg, "train", data_dir=str(data)), jcfg.batch_size, num_workers=1,
        seed=0)))
    batch = {k: batch[k] for k in training_keys(batch, jcfg)}

    trainer = Trainer(create_model(pcfg.arch, pcfg, "cpu"), pcfg,
                      STEPS_PER_EPOCH)
    init = {k: v.detach().clone().numpy()
            for k, v in trainer.model.state_dict().items()}
    params, stats = TorchConverter(jcfg.dataset).convert_dla34(
        init, jcfg.heads, jcfg.dla_node,
        DLA_PLANS[jcfg.arch.split("_")[1]][0])
    model = jax_create_model(jcfg.arch, jcfg)
    tx = make_optimizer(jcfg, STEPS_PER_EPOCH)
    state = create_train_state(model, jcfg, params, stats, STEPS_PER_EPOCH)
    new, want = make_train_step(model, jcfg, tx)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    jsd = from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, new.params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, new.batch_stats)},
        jcfg)

    b32 = to_device(batch, list(batch), "cpu")
    trainer.model.train()
    total, st32 = trainer.loss_and_stats(b32)
    total.backward()
    g32 = {n: p.grad.numpy().copy()
           for n, p in trainer.model.named_parameters() if p.grad is not None}

    float64_forward_patches()
    m64 = create_model(pcfg.arch, pcfg, "cpu")
    m64.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    m64 = m64.double().train()
    m64.compute_dtype = torch.float64
    t64 = Trainer(m64, pcfg, STEPS_PER_EPOCH)
    t64.s_det = torch.nn.Parameter(torch.ones((), dtype=torch.float64))
    t64.s_id = torch.nn.Parameter(torch.ones((), dtype=torch.float64))
    b64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in b32.items()}
    total64, st64 = t64.loss_and_stats(b64)
    total64.backward()
    g64 = {n: p.grad.numpy() for n, p in m64.named_parameters()
           if p.grad is not None}

    for key in ("hm", "wh", "reg", "tracking", "ltrb_amodal", "matching"):
        f64 = float(st64[key])
        print(f"{key}: port float32 {float(st32[key])!r} float64 {f64!r} "
              f"JAX float32 {float(want[key])!r}; relative to float64 port "
              f"{abs(float(st32[key]) - f64) / abs(f64):.3g}, JAX "
              f"{abs(float(want[key]) - f64) / abs(f64):.3g}")
    top = max(np.abs(g).max() for g in g64.values())
    port_flips = jax_flips = count = 0
    for name, g in g64.items():
        if np.abs(g).max() <= 1e-6 * top:
            continue                # no gradient but rounding
        sign = np.sign(g)
        port_flips += int((np.sign(g32[name]) != sign).sum())
        # Adam's first step moves a weight by about -lr x sign(g)
        jax_flips += int((-np.sign(jsd[name].numpy() - init[name])
                          != sign).sum())
        count += g.size
    print(f"{arch}: signs against float64's gradient: port float32 "
          f"{port_flips / count:.4f}, JAX float32 step {jax_flips / count:.4f}"
          f" of {count} parameters")


if __name__ == "__main__":
    main(*sys.argv[1:])
