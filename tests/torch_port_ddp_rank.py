"""One rank of the port's data-parallel training for the CPU tests
(``test_torch_port_ddp*.py``): ``deft_tpu_torch.train.run.train_rank`` in
a gloo group, started by ``torch.multiprocessing.spawn``.  It imports no
JAX, so each rank starts fast."""

import torch


def run_rank(rank: int, world: int, argv, init_method: str, out_dir: str):
    """``train_rank(rank, world, "gloo", argv)`` on two intra-op threads;
    the rank's statistics and its model's and uncertainty weights' final
    state go to ``out_dir/rank<rank>.pt``."""
    from deft_tpu_torch.train.run import train_rank

    torch.set_num_threads(2)
    stats = {}
    trainer = train_rank(rank, world, "gloo", argv, stats,
                         init_method=init_method)
    torch.save({"stats": stats,
                "state_dict": trainer.model.state_dict(),
                "s_det": trainer.s_det.item(), "s_id": trainer.s_id.item()},
               f"{out_dir}/rank{rank}.pt")
