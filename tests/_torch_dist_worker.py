"""Worker of tests/test_torch_shard.py: one process of a gloo group on the
CPU, driving the port's ``parallel.shard`` on inputs that the test wrote.

Usage: _torch_dist_worker.py <job> <init> <world> <rank> <in.npz> <out.npz>

``job``:
  * ``trace``: ``trace_rays_sharded`` of the given packed field over
    ``make_mesh``; writes the four result fields;
  * ``train``: two ``make_train_step`` steps, then one with
    ``accum_steps=2`` from the same field, and one at ``lr_far`` towards
    ``target_far``; writes the fields and losses;
  * ``multihost``: ``init_distributed(coordinator_address=<init>, ...)``,
    ``make_host_mesh`` and one train step over its "rays" axis; writes the
    loss and the mesh's shape.

``init`` is a ``file://`` store for ``trace`` and ``train`` (the group is
started with ``torch.distributed.init_process_group``) and a
``host:port`` coordinator for ``multihost``.  Imports nothing of jax.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist


def main():
    job, init, world, rank, inp, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), *sys.argv[5:7]
    torch.set_num_threads(1)

    from volumeraytracer_tpu_torch.parallel import shard

    data = {k: torch.from_numpy(v) for k, v in np.load(inp).items()}
    if job == "multihost":
        info = shard.init_distributed(coordinator_address=init, num_processes=world, process_id=rank, device="cpu")
        if info != {"process_index": rank, "process_count": world, "local_devices": 1, "global_devices": world}:
            raise SystemExit(f"init_distributed returned {info}")
        mesh = shard.make_host_mesh(("rays", "bricks"), device="cpu")
    else:
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        mesh = shard.make_mesh(device="cpu")

    results = {}
    if job == "trace":
        res = shard.trace_rays_sharded(
            mesh, data["packed"], data["pos"], data["dirs"], int(data["budget"]),
            bend_scale=float(data["bend"]), step_scale=float(data["step"]), chunk_steps=int(data["chunk"]),
        )
        results = {k: getattr(res, k) for k in ("end_position", "end_direction", "end_iteration", "remaining_light")}
    else:
        kw = dict(budget=int(data["budget"]), chunk_steps=int(data["chunk"]), lr=float(data["lr"]))
        args = (data["pos"], data["dirs"], data["target"])
        step = shard.make_train_step(mesh, **kw)
        f1, loss0 = step(data["ior"], *args)
        results = {"f1": f1, "loss0": loss0, "mesh_shape": torch.tensor(tuple(mesh.shape))}
        if job == "train":
            f2, loss1 = step(f1, *args)
            f1a, loss0a = shard.make_train_step(mesh, accum_steps=2, **kw)(data["ior"], *args)
            kw["lr"] = float(data["lr_far"])
            f_far, loss_far = shard.make_train_step(mesh, **kw)(data["ior"], *args[:2], data["target_far"])
            results.update(f2=f2, loss1=loss1, f1a=f1a, loss0a=loss0a, f_far=f_far, loss_far=loss_far,
                           ior_untouched=torch.tensor(data["ior"].grad is None))
    np.savez(out, **{k: v.numpy() for k, v in results.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
