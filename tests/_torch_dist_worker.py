"""Worker of tests/test_torch_shard.py and tests/test_torch_bricks.py: one
process of a gloo group on the CPU, driving the port's ``parallel.shard``
and ``parallel.bricks`` on inputs that the test wrote.

Usage: _torch_dist_worker.py <job> <init> <world> <rank> <in.npz> <out.npz>

``job``:
  * ``trace``: ``trace_rays_sharded`` of the given packed field over
    ``make_mesh``; writes the four result fields;
  * ``train``: two ``make_train_step`` steps, then one with
    ``accum_steps=2`` from the same field, and one at ``lr_far`` towards
    ``target_far``; writes the fields and losses;
  * ``multihost``: ``init_distributed(coordinator_address=<init>, ...)``,
    ``make_host_mesh`` and one train step over its "rays" axis; writes the
    loss and the mesh's shape;
  * ``bricks_fwd``: ``trace_rays_bricked`` over all ranks as bricks, and
    ``trace_rays_bricked2d`` on ``make_mesh2d`` at each (rays, bricks)
    shape of ``shapes2d``; writes each result's fields;
  * ``bricks_host``: one ``make_brick_train_step`` step at lr 1 over all
    ranks as bricks on the plain route, then on S1 and S2 compiled for the
    host (tests/test_torch_slab_kernel.py's library, loaded from the path
    whose UTF-8 bytes are ``host_lib``, the card's stream calls stubbed), whose march is
    ``bricks._SlabMarch``; writes both updates and losses, the windows and
    the kernels' launches and d slabs zeroed;
  * ``bricks_train``: ``init_distributed(coordinator_address=<init>,
    ...)``, then for each ray case ("near", "cross") one step at lr 1 of
    ``make_brick_train_step`` over all ranks as bricks and of
    ``make_brick_train_step2d`` on ``make_mesh2d(2, 2)``, and two descent
    steps of the first; then tests/test_multihost.py's step on
    ``make_host_mesh``; writes the slabs and losses.

``init`` is a ``file://`` store for ``trace``, ``train``, ``bricks_fwd``
and ``bricks_host`` (the group is started with
``torch.distributed.init_process_group``) and a ``host:port`` coordinator
for ``multihost`` and ``bricks_train``.  Imports nothing of jax.
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
    if job.startswith("bricks"):
        results = bricks_job(job, init, world, rank, data)
        np.savez(out, **{k: v.numpy() for k, v in results.items()})
        dist.destroy_process_group()
        return
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


def bricks_job(job, init, world, rank, data):
    """The ``bricks_*`` jobs (see the module doc); returns their results."""
    from volumeraytracer_tpu_torch.parallel import bricks, shard

    fields = ("end_position", "end_direction", "end_iteration")
    out = {}
    if job == "bricks_fwd":
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        kw = dict(bend_scale=float(data["bend"]), step_scale=float(data["step"]), k_steps=int(data["k_steps"]))
        res = bricks.trace_rays_bricked(shard.make_mesh(axis="bricks", device="cpu"), data["packed"], data["pos"],
                                        data["dirs"], int(data["budget"]), **kw)
        out.update({f"1d_{f}": getattr(res, f) for f in fields})
        for n_r, n_b in data["shapes2d"].tolist():
            res = bricks.trace_rays_bricked2d(bricks.make_mesh2d(n_r, n_b, device="cpu"), data["packed"],
                                              data["pos2d"], data["dirs2d"], int(data["budget"]), **kw)
            out.update({f"{n_r}x{n_b}_{f}": getattr(res, f) for f in fields})
        return out
    if job == "bricks_host":
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        return bricks_host(world, data)

    info = shard.init_distributed(coordinator_address=init, num_processes=world, process_id=rank, device="cpu")
    out["info"] = torch.tensor([info["process_index"], info["process_count"], info["global_devices"]])
    ior, x_packed = data["ior"], data["ior"].shape[0] - 2
    kw = dict(budget=int(data["budget"]), invscale=float(data["invscale"]), k_steps=int(data["k_steps"]))
    mesh = shard.make_mesh(axis="bricks", device="cpu")
    mesh2 = bricks.make_mesh2d(2, 2, device="cpu")
    out["slab"] = slab = bricks.shard_slabs(mesh, bricks.build_ior_slabs(ior, world)[0])
    out["slab2d"] = slab2 = bricks.shard_slabs(mesh2, bricks.build_ior_slabs(ior, 2)[0])
    d_kw = dict(kw, budget=int(data["d_budget"]), lr=float(data["d_lr"]))
    for case in ("near", "cross"):
        rays = tuple(data[f"{case}_{k}"] for k in ("pos", "dirs", "target"))
        out[f"{case}_new"], out[f"{case}_loss"] = bricks.make_brick_train_step(mesh, x_packed, lr=1.0, **kw)(
            slab, *rays)
        out[f"{case}_new2d"], out[f"{case}_loss2d"] = bricks.make_brick_train_step2d(
            mesh2, x_packed, rays[0].shape[0], lr=1.0, **kw)(slab2, *rays)
        step = bricks.make_brick_train_step(mesh, x_packed, **d_kw)
        rays = tuple(data[f"d_{case}_{k}"] for k in ("pos", "dirs", "target"))
        s1, out[f"d_{case}_loss0"] = step(slab, *rays)
        out[f"d_{case}_s2"], out[f"d_{case}_loss1"] = step(s1, *rays)

    # tests/test_multihost.py's step, on make_host_mesh's (nodes, processes a node)
    host = shard.make_host_mesh(("rays", "bricks"), device="cpu")
    mh = bricks.shard_slabs(host, bricks.build_ior_slabs(data["mh_ior"], host.size(1))[0])
    new, out["mh_loss"] = bricks.make_brick_train_step2d(
        host, data["mh_ior"].shape[0] - 2, data["mh_pos"].shape[0], budget=32, invscale=2.0, k_steps=8, lr=1e-3)(
        mh, data["mh_pos"], data["mh_dirs"], data["mh_target"])
    out["mh_shape"] = torch.tensor(tuple(host.shape))
    out["mh_same_shape"] = torch.tensor(new.shape == mh.shape)
    return out


def bricks_host(world, data):
    """The ``bricks_host`` job on a started group (see the module doc)."""
    import contextlib
    import ctypes
    import types

    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import march_slab as ms
    from volumeraytracer_tpu_torch.parallel import bricks, shard

    mesh = shard.make_mesh(axis="bricks", device="cpu")
    ior = data["ior"]
    slab = bricks.shard_slabs(mesh, bricks.build_ior_slabs(ior, world)[0])
    kw = dict(budget=int(data["budget"]), invscale=float(data["invscale"]), k_steps=int(data["k_steps"]), lr=1.0)
    rays = (data["pos"], data["dirs"], data["target"])
    windows = [0]
    combine = bricks._combine_window

    def counted(*args):
        windows[0] += 1
        return combine(*args)

    bricks._combine_window = counted
    out = {}
    new, out["plain_loss"] = bricks.make_brick_train_step(mesh, ior.shape[0] - 2, **kw)(slab, *rays)
    out["plain_g"] = slab - new
    lib = ctypes.CDLL(bytes(data["host_lib"].numpy()).decode())
    for name in ("vrt_march_slab_fwd", "vrt_march_slab_bwd", "vrt_march_slab_stash"):
        getattr(lib, name).argtypes, getattr(lib, name).restype = _build._SIGNATURES[name], ctypes.c_int
    _build._lib = lib
    ms._require_cuda = lambda name, slab: None
    ms.use_kernels = lambda device, dim: dim == 3
    torch.cuda.device = lambda d: contextlib.nullcontext()
    torch.cuda.current_stream = lambda: types.SimpleNamespace(cuda_stream=None)
    _build.launches.clear()
    ms.zeroed.clear()
    windows[0] = 0
    new, out["kernel_loss"] = bricks.make_brick_train_step(mesh, ior.shape[0] - 2, **kw)(slab, *rays)
    out["kernel_g"] = slab - new
    out["windows"] = torch.tensor(windows[0])
    out["launches"] = torch.tensor([_build.launches["march_slab_fwd"], _build.launches["march_slab_bwd"],
                                    ms.zeroed["d_slab"]])
    return out


if __name__ == "__main__":
    main()
