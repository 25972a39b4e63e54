"""Port parity: data parallelism over torch.distributed
(volumeraytracer_tpu_torch.parallel.shard) against the JAX package's
shard_map versions on conftest's 8 virtual CPU devices.

The port runs one process a device, so its groups here are gloo groups of
worker processes on the CPU (tests/_torch_dist_worker.py, started by
``_run_group`` with a file:// rendezvous in the test's temporary directory,
one thread each), which read the seeded inputs from an .npz and write their
results to another.  The multi-host mirror goes through
``init_distributed``'s tcp:// rendezvous on a free port.  On the CPU every
shard runs the plain march; the kernel path across several cards is not
verified here (the GPU machine has one card: chip_smoke.py phase 19 runs it
at world size 1 over NCCL and with two processes sharing the card over
gloo).
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch.distributed as dist

from volumeraytracer_tpu.ops.fields import build_packed_field as jax_build_packed_field
from volumeraytracer_tpu.parallel import make_mesh as jax_make_mesh
from volumeraytracer_tpu.parallel import make_train_step as jax_make_train_step
from volumeraytracer_tpu.parallel import trace_rays_sharded as jax_trace_rays_sharded
from volumeraytracer_tpu.parallel.shard import endpoint_render as jax_endpoint_render
from volumeraytracer_tpu_torch.ops.fields import build_packed_field
from volumeraytracer_tpu_torch.ops.march import march_float
from volumeraytracer_tpu_torch.parallel import shard

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).parent / "_torch_dist_worker.py"
FIELDS = ("end_position", "end_direction", "end_iteration", "remaining_light")
INV = 2.0
BEND = INV / 65536.0
STEP = INV * (float(0x42000000) / 65536.0 / 65536.0)
TRACE_BUDGET, TRACE_CHUNK = 2000, 128
TRAIN = dict(budget=128, chunk=32, lr=1e-4)


def _ramp_scene(n=64):
    """tests/test_sharding.py's scene: an x ramp of ior 1 → 2 between flat ends."""
    ior = np.ones((n, 8, 8), np.float32)
    for i in range(4, n - 4):
        ior[i] = 1.0 + (i - 4) / (n - 8)
    ior[n - 4:] = 2.0
    return ior


def _rays(n_rays, seed):
    rng = np.random.default_rng(seed)
    pos = np.stack([np.full(n_rays, 1.5), rng.uniform(2.0, 5.0, n_rays), rng.uniform(2.0, 5.0, n_rays)],
                   axis=-1).astype(np.float32)
    dirs = np.tile(np.array([[16.0, 0.0, 0.0]], np.float32), (n_rays, 1))
    return pos, dirs


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_group(job, world, inputs, tmp_path, init=None, timeout=240):
    """Run ``world`` workers of ``job`` on ``inputs`` and return each
    rank's results; a worker that fails or a group that outlives
    ``timeout`` seconds kills every worker and fails with the stderr."""
    np.savez(tmp_path / "in.npz", **inputs)
    init = init or f"file://{tmp_path}/store"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("PYTHONSTARTUP", None)
    procs, logs = [], []
    for rank in range(world):
        log = open(tmp_path / f"stderr{rank}.txt", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), job, init, str(world), str(rank), str(tmp_path / "in.npz"),
             str(tmp_path / f"out{rank}.npz")],
            stdout=log, stderr=subprocess.STDOUT, env=env,
        ))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    errors = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            errors.append(f"rank {rank} exited {p.returncode}:\n{text[-3000:]}")
    assert not errors, f"{job} group of {world} failed or timed out after {timeout} s:\n" + "\n".join(errors)
    return [dict(np.load(tmp_path / f"out{rank}.npz")) for rank in range(world)]


# ---------------------------------------------------------------------------
# trace_rays_sharded
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trace_case():
    """The inputs of tests/test_sharding.py::test_sharded_matches_single
    (37 rays: every world size pads), JAX's sharded trace over the 8 virtual
    devices and the port's single-process plain march."""
    packed = np.asarray(jax_build_packed_field(jnp.asarray(_ramp_scene())))
    pos, dirs = _rays(37, seed=0)
    ref = jax_trace_rays_sharded(jax_make_mesh(), jnp.asarray(packed), jnp.asarray(pos), jnp.asarray(dirs),
                                 TRACE_BUDGET, bend_scale=BEND, step_scale=STEP, chunk_steps=TRACE_CHUNK)
    single = march_float(torch.from_numpy(packed), None, torch.from_numpy(pos), torch.from_numpy(dirs),
                         TRACE_BUDGET, bend_scale=BEND, step_scale=STEP, chunk_steps=TRACE_CHUNK)
    inputs = dict(packed=packed, pos=pos, dirs=dirs, budget=TRACE_BUDGET, chunk=TRACE_CHUNK, bend=BEND, step=STEP)
    return inputs, {k: np.asarray(getattr(ref, k)) for k in FIELDS}, {k: getattr(single, k).numpy() for k in FIELDS}


@pytest.mark.parametrize("world", [2, 3])
def test_trace_rays_sharded_matches_jax_and_single(trace_case, world, tmp_path):
    """Each rank marches its rows of the padded batch and the gather gives
    every rank the whole result: against JAX's sharded trace at the march
    tests' tolerance (positions within 1e-5, iterations and light exact),
    and equal bit for bit to the port's single plain march (each ray's
    steps do not depend on the batch it marches in)."""
    inputs, ref, single = trace_case
    outs = _run_group("trace", world, inputs, tmp_path)
    for rank, got in enumerate(outs):
        assert got["end_position"].shape == (37, 3), rank
        np.testing.assert_array_equal(got["end_iteration"], ref["end_iteration"].astype(np.int64))
        np.testing.assert_array_equal(got["remaining_light"], ref["remaining_light"].astype(np.int64))
        np.testing.assert_allclose(got["end_position"], ref["end_position"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["end_direction"], ref["end_direction"], rtol=1e-6, atol=1e-6)
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], single[k], err_msg=f"rank {rank}: {k} vs the single march")
    assert (single["end_iteration"] > 100).all()


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------


def _train_inputs():
    """tests/test_sharding.py::test_sharded_train_step_runs_and_descends's
    inputs (the 32-voxel ramp, 16 rays, targets from a 1% brighter field,
    lr 1e-4), and a far target, JAX's endpoints + (2, 0, 0) (as
    chip_smoke.py's phase 19a aims its steps), with lr 1e-2.

    The far target is what the port is held to JAX's loss and update by.
    The near target's residuals are small, so its loss moves relatively
    far more than the endpoints it is made of, which agree with JAX's only
    to the march's tolerance: rtol 1e-5 cannot hold between the packages
    there (``test_train_step_near_target_loss_within_march_tolerance``
    holds it to the bound that tolerance implies).  And at lr 1e-4 its
    update is a few ulps of the field, too coarse for (ior − new)/lr to
    show its gradient to 1e-3."""
    ior = _ramp_scene(32)
    pos, dirs = _rays(16, seed=1)
    ends = {}
    for name, f in (("target", jnp.asarray(ior) * 1.01), ("ends", jnp.asarray(ior))):
        ends[name] = np.asarray(jax_endpoint_render(f, jnp.asarray(pos), jnp.asarray(dirs), TRAIN["budget"], INV,
                                                    TRAIN["chunk"])[0])
    return dict(ior=ior, pos=pos, dirs=dirs, target=ends["target"],
                target_far=ends["ends"] + np.array([2.0, 0.0, 0.0], np.float32), lr_far=1e-2, **TRAIN)


@pytest.fixture(scope="module")
def train_case(tmp_path_factory):
    """The port's two-rank train steps, and JAX's first step towards each
    target on the same inputs, on a mesh of one device: there it is
    ``jax.grad`` of the loss and SGD.  (With the installed jax 0.9.0, JAX's
    step on a mesh of k devices moves the field by k times that gradient:
    shard_map's transpose already sums the replicated field's cotangent
    over the axis, and the step's psum sums it again; its loss is right.)"""
    inputs = _train_inputs()
    ref = {}
    for name, target, lr in (("near", "target", TRAIN["lr"]), ("far", "target_far", inputs["lr_far"])):
        step = jax_make_train_step(jax_make_mesh(jax.devices()[:1]), budget=TRAIN["budget"],
                                   chunk_steps=TRAIN["chunk"], lr=lr)
        f1, loss0 = step(*(jnp.asarray(inputs[k]) for k in ("ior", "pos", "dirs", target)))
        ref[name] = {"f1": np.asarray(f1), "loss0": float(loss0)}
    outs = _run_group("train", 2, inputs, tmp_path_factory.mktemp("train"))
    return inputs, ref, outs


def test_train_step_matches_jax(train_case):
    """Towards the far target: the loss within rtol 1e-5 of JAX's, the
    update (ior − new)/lr within 1e-3 of JAX's largest."""
    inputs, ref, outs = train_case
    got = outs[0]
    np.testing.assert_allclose(float(got["loss_far"]), ref["far"]["loss0"], rtol=1e-5)
    g_ref = (inputs["ior"] - ref["far"]["f1"]) / inputs["lr_far"]
    g = (inputs["ior"] - got["f_far"]) / inputs["lr_far"]
    scale = np.abs(g_ref).max()
    assert scale > 0
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=1e-3 * scale)


def test_jax_reference_step_scales_with_mesh_size(train_case):
    """Why the JAX reference above runs on one device: the JAX package's
    step moves the field by k times the gradient on a mesh of k devices
    (ROADMAP queue 3 item 6), while its loss is right.  This records the
    reference's behaviour, not the port's."""
    inputs, ref, _ = train_case
    lr = inputs["lr_far"]
    step = jax_make_train_step(jax_make_mesh(), budget=TRAIN["budget"], chunk_steps=TRAIN["chunk"], lr=lr)
    f8, loss8 = step(*(jnp.asarray(inputs[k]) for k in ("ior", "pos", "dirs", "target_far")))
    g1 = (inputs["ior"] - ref["far"]["f1"]) / lr
    g8 = (inputs["ior"] - np.asarray(f8)) / lr
    assert len(jax.devices()) == 8
    np.testing.assert_allclose(g8, 8 * g1, rtol=0, atol=1e-3 * 8 * np.abs(g1).max())
    np.testing.assert_allclose(float(loss8), ref["far"]["loss0"], rtol=1e-6)


def test_train_step_near_target_loss_within_march_tolerance(train_case):
    """Towards the near target: the loss within what endpoints at the march
    tests' 1e-5 of JAX's allow, Σ (2·|r|·δ + δ²) / count over JAX's
    residuals r, with δ = 1e-5."""
    inputs, ref, outs = train_case
    ends = np.asarray(jax_endpoint_render(jnp.asarray(inputs["ior"]), jnp.asarray(inputs["pos"]),
                                          jnp.asarray(inputs["dirs"]), TRAIN["budget"], INV, TRAIN["chunk"])[0])
    r = np.abs(ends.astype(np.float64) - inputs["target"])
    delta = 1e-5
    bound = (2.0 * r * delta + delta * delta).sum() / len(r)
    assert abs(float(outs[0]["loss0"]) - ref["near"]["loss0"]) <= bound


def test_train_step_descends(train_case):
    _, _, outs = train_case
    loss0, loss1 = float(outs[0]["loss0"]), float(outs[0]["loss1"])
    assert np.isfinite(loss0) and np.isfinite(loss1)
    assert loss1 < loss0


def test_train_step_accumulation_equals_one_step(train_case):
    """Two micro-batches a rank, one all_reduce a step: the same loss and
    field (tests/test_sharding.py:97-103)."""
    _, _, outs = train_case
    got = outs[0]
    np.testing.assert_allclose(float(got["loss0a"]), float(got["loss0"]), rtol=1e-6)
    np.testing.assert_allclose(got["f1a"], got["f1"], rtol=1e-6, atol=1e-7)


def test_train_step_ranks_equal(train_case):
    """Every output equal on both ranks bit for bit; the caller's field got
    no gradient."""
    _, _, outs = train_case
    assert set(outs[0]) == set(outs[1])
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    assert bool(outs[0]["ior_untouched"])


def test_multihost_mirror(tmp_path):
    """tests/test_multihost.py's shape: two processes through
    init_distributed's tcp:// rendezvous, make_host_mesh (2, 1), one train
    step over its "rays" axis with the same finite loss on both ranks."""
    inputs = _train_inputs()
    outs = _run_group("multihost", 2, inputs, tmp_path, init=f"127.0.0.1:{_free_port()}")
    for got in outs:
        assert tuple(got["mesh_shape"]) == (2, 1)
    assert outs[0]["loss0"] == outs[1]["loss0"] and np.isfinite(outs[0]["loss0"]) and outs[0]["loss0"] > 0
    np.testing.assert_array_equal(outs[0]["f1"], outs[1]["f1"])


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


@pytest.fixture
def single_group():
    """``make_mesh`` with no process group: it starts a world-size-1 group,
    which the test's end destroys."""
    assert not dist.is_initialized()
    mesh = shard.make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_init_distributed_without_arguments_reports():
    assert not dist.is_initialized()
    info = shard.init_distributed()
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1, "global_devices": 1}
    assert not dist.is_initialized()


def test_make_mesh_starts_a_single_group(single_group):
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert tuple(single_group.shape) == (1,) and single_group.mesh_dim_names == ("rays",)
    # a second init_distributed is a no-op, whatever it is asked
    info = shard.init_distributed(coordinator_address=f"127.0.0.1:{_free_port()}", num_processes=2, process_id=0,
                                  device="cpu")
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1, "global_devices": 1}
    host = shard.make_host_mesh(device="cpu")
    assert tuple(host.shape) == (1, 1) and host.mesh_dim_names == ("rays", "bricks")


def test_train_step_world_size_one_equals_endpoint_render_sgd(single_group):
    """At world size 1 the step is endpoint_render + backward + SGD, bit for
    bit, with the loss over the global count."""
    inputs = {k: torch.from_numpy(np.asarray(v)) for k, v in _train_inputs().items()}
    ior, pos, dirs, target = inputs["ior"], inputs["pos"], inputs["dirs"], inputs["target"]
    new, loss = shard.make_train_step(single_group, budget=TRAIN["budget"], chunk_steps=TRAIN["chunk"],
                                      lr=TRAIN["lr"])(ior, pos, dirs, target)
    field = ior.clone().requires_grad_()
    end_pos, _ = shard.endpoint_render(field, pos, dirs, TRAIN["budget"], INV, TRAIN["chunk"])
    ref_loss = ((end_pos - target) ** 2).sum() / pos.shape[0]
    ref_loss.backward()
    assert loss.ndim == 0 and not loss.requires_grad and not new.requires_grad
    assert torch.equal(loss, ref_loss.detach())
    assert torch.equal(new, ior - TRAIN["lr"] * field.grad)
    assert ior.grad is None


def test_trace_rays_sharded_world_size_one_equals_march_float(single_group):
    packed = build_packed_field(torch.from_numpy(_ramp_scene()))
    pos, dirs = (torch.from_numpy(a) for a in _rays(9, seed=2))
    got = shard.trace_rays_sharded(single_group, packed, pos, dirs, 300, bend_scale=BEND, step_scale=STEP,
                                   chunk_steps=64)
    ref = march_float(packed, None, pos, dirs, 300, bend_scale=BEND, step_scale=STEP, chunk_steps=64)
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    assert got.path is None and got.end_iteration.dtype == torch.int64


def test_replicate_and_shard_batch_single(single_group):
    x = torch.arange(12.0).reshape(6, 2)
    rep = shard.replicate(single_group, x)
    assert torch.equal(rep, x) and rep.data_ptr() != x.data_ptr()
    assert torch.equal(shard.shard_batch(single_group, x), x)
    assert [shard.pad_rays(n, 8) for n in (37, 40, 1)] == [5, 5, 1]


class _TwoRankMesh:
    """Rank 0 of a two-rank "rays" axis, as far as the step's checks see
    it: they raise before any collective."""

    mesh_dim_names = ("rays",)

    def get_coordinate(self):
        return [0]

    def get_group(self, axis):
        return None

    def size(self, dim):
        return 2


@pytest.mark.parametrize("n_rays, accum, match", [(15, 1, "split evenly"), (16, 3, "accum_steps")])
def test_train_step_rejects_uneven_batches(n_rays, accum, match):
    step = shard.make_train_step(_TwoRankMesh(), budget=8, accum_steps=accum)
    pos, dirs = (torch.from_numpy(a) for a in _rays(n_rays, seed=0))
    with pytest.raises(ValueError, match=match):
        step(torch.from_numpy(_ramp_scene(16)), pos, dirs, pos)
    with pytest.raises(ValueError, match="split evenly"):
        shard.shard_batch(_TwoRankMesh(), pos[:15])
