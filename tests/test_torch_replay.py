"""Port parity: capture and replay — the port's instance files
(``utils/serialization.py``), ``Options.write_instance`` and the replay CLI
``vrt-replay-torch`` (``cli.py``) — against the JAX package's on the CPU:
each package reads and replays what the other writes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import volumeraytracer_tpu as vrt
from volumeraytracer_tpu import cli as jax_cli
from volumeraytracer_tpu.utils import serialization as jax_ser
import volumeraytracer_tpu_torch as vtt
from volumeraytracer_tpu_torch import cli
from volumeraytracer_tpu_torch.utils import serialization as ser

from test_torch_fixed import _assert_fixed_close


def _instance(mod, n_rays=12, seed=4):
    """A 12³ lens with an absorber, and a batch of 16.16 rays entering at
    x = 1.5, as ``mod``'s instance DTOs."""
    n = 12
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    ior = (1.0 + 0.4 * np.exp(-3.0 * (x * x + y * y + z * z))).astype(np.float32)
    tr = np.full((n, n, n), 0xFF000000, np.uint32)
    rng = np.random.default_rng(seed)
    pos = np.stack([np.full(n_rays, 0x18000), rng.integers(0x20000, 0x90000, n_rays),
                    rng.integers(0x20000, 0x90000, n_rays)], axis=-1).astype(np.uint32)
    dirs = np.concatenate([np.full((n_rays, 1), 8.0), rng.uniform(-1.0, 1.0, (n_rays, 2))], -1).astype(np.float32)
    return mod.RaytraceInstance(
        mod.RaySceneInstance((n, n, n), ior, tr),
        mod.RayInstance(pos, dirs, np.array([2.0, 2.0, 2.0], np.float32), minimum_brightness=0x40000000,
                        iterations=300, trace_path=False, normalize_length=True),
    )


def _fields(inst):
    """An instance of either package as comparable plain values."""
    s, r = inst.scene, inst.rays
    arrays = (s.ior, s.translucency, r.start_position, r.start_direction, r.invscale)
    return (tuple(s.bounds), tuple((a.dtype.str, a.shape, a.tobytes()) for a in map(np.asarray, arrays)),
            r.minimum_brightness, r.iterations, r.trace_path, r.normalize_length)


@pytest.mark.parametrize("suffix", [".npz", ".vrt"])
def test_round_trip(tmp_path, suffix):
    inst = _instance(vtt)
    path = tmp_path / f"inst{suffix}"
    (ser.save_instance_binary if suffix == ".vrt" else ser.save_instance)(path, inst)
    back = (ser.load_instance_binary if suffix == ".vrt" else ser.load_instance)(path)
    assert isinstance(back, vtt.RaytraceInstance) and back == inst and _fields(back) == _fields(inst)
    ser.save_scene_instance(tmp_path / "scene.npz", inst.scene)
    ser.save_ray_instance(tmp_path / "rays.npz", inst.rays)
    assert ser.load_scene_instance(tmp_path / "scene.npz") == inst.scene
    assert ser.load_ray_instance(tmp_path / "rays.npz") == inst.rays
    assert ser.loads_binary(ser.dumps_binary(inst)) == inst


def test_bad_files_raise(tmp_path):
    with pytest.raises(ValueError, match="magic"):
        ser.loads_binary(b"NOTVRT00" + bytes(32))
    with pytest.raises(ValueError, match="corrupt"):
        ser.loads_binary(ser.dumps_binary(_instance(vtt))[:9])
    ser.save_scene_instance(tmp_path / "scene.npz", _instance(vtt).scene)
    with pytest.raises(ValueError, match="raytrace_instance"):
        ser.load_instance(tmp_path / "scene.npz")


@pytest.mark.parametrize("kind", ["npz", "vrt", "scene_and_rays"])
def test_files_cross_between_packages(tmp_path, kind):
    """Each package reads what the other writes as the same instance, and
    the binary codec's bytes are the same."""
    for writer, reader, mod_w, mod_r in ((jax_ser, ser, vrt, vtt), (ser, jax_ser, vtt, vrt)):
        inst = _instance(mod_w)
        if kind == "npz":
            writer.save_instance(tmp_path / "x.npz", inst)
            back = reader.load_instance(tmp_path / "x.npz")
        elif kind == "vrt":
            writer.save_instance_binary(tmp_path / "x.vrt", inst)
            back = reader.load_instance_binary(tmp_path / "x.vrt")
        else:
            writer.save_scene_instance(tmp_path / "s.npz", inst.scene)
            writer.save_ray_instance(tmp_path / "r.npz", inst.rays)
            back = mod_r.RaytraceInstance(reader.load_scene_instance(tmp_path / "s.npz"),
                                          reader.load_ray_instance(tmp_path / "r.npz"))
        assert isinstance(back, mod_r.RaytraceInstance)
        assert _fields(back) == _fields(inst) == _fields(_instance(mod_r))
    assert ser.dumps_binary(_instance(vtt)) == jax_ser.dumps_binary(_instance(vrt))


@pytest.mark.parametrize("mode", ["fixed", "float"])
@pytest.mark.parametrize("suffix", [".npz", ".vrt"])
def test_write_instance_matches_jax(tmp_path, mode, suffix):
    """The port's dump of a CPU trace is the JAX package's dump of the same
    inputs: the same arrays with the same dtypes (16.16 positions uint32,
    the port's int64 tensors included), and byte for byte in .vrt."""
    inst = _instance(vtt)
    scene_np, rays = inst.scene, inst.rays
    pos = rays.start_position if mode == "fixed" else (rays.start_position / 65536.0).astype(np.float32)
    kw = dict(invscale=rays.invscale, iterations=rays.iterations, minimum_brightness=rays.minimum_brightness,
              mode=mode)
    ours, theirs = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    scene = vtt.RaytraceScene(scene_np.ior, scene_np.translucency, vtt.Options(write_instance=str(ours)),
                              device="cpu")
    # the port holds 16.16 positions as int64 tensors: the dump writes uint32
    got_pos = torch.from_numpy(pos.astype(np.int64)) if mode == "fixed" else torch.from_numpy(pos)
    scene.trace_rays(got_pos, torch.from_numpy(rays.start_direction), **kw)
    vrt.RaytraceScene(scene_np.ior, scene_np.translucency, vrt.Options(write_instance=str(theirs))).trace_rays(
        pos, rays.start_direction, **kw)
    load_port = ser.load_instance_binary if suffix == ".vrt" else ser.load_instance
    load_jax = jax_ser.load_instance_binary if suffix == ".vrt" else jax_ser.load_instance
    assert _fields(load_port(ours)) == _fields(load_jax(theirs))
    assert load_port(ours).rays.start_position.dtype == (np.uint32 if mode == "fixed" else np.float32)
    if suffix == ".vrt":
        assert ours.read_bytes() == theirs.read_bytes()


def test_write_instance_default_path(tmp_path, monkeypatch):
    """write_instance=True dumps debug_raytrace_instance.npz into the
    working directory, for a scene without translucency (all 0xFFFFFFFF),
    before the trace, which then runs."""
    monkeypatch.chdir(tmp_path)
    ior = np.linspace(1.0, 2.0, 6 * 6 * 6, dtype=np.float32).reshape(6, 6, 6)
    scene = vtt.RaytraceScene(ior, options=vtt.Options(write_instance=True), device="cpu")
    res = scene.trace_rays([[0x20000, 0x20000, 0x20000]], [[16.0, 0.0, 0.0]], invscale=[2.0] * 3, iterations=50)
    inst = ser.load_instance(tmp_path / "debug_raytrace_instance.npz")
    assert [p.name for p in tmp_path.iterdir()] == ["debug_raytrace_instance.npz"]
    assert inst.scene.bounds == (6, 6, 6) and (inst.scene.translucency == 0xFFFFFFFF).all()
    assert inst.rays.start_position.dtype == np.uint32 and inst.rays.iterations == 50
    replay = vtt.trace_rays_instance(inst.scene, inst.rays, device="cpu")
    assert torch.equal(replay.end_position, res.end_position)


def test_write_instance_off_keeps_no_translucency(tmp_path, monkeypatch):
    """A scene built without write_instance holds no copy of the raw
    translucency; turning the option on afterwards raises instead of
    dumping an all-0xFFFFFFFF translucency, and writes no file."""
    monkeypatch.chdir(tmp_path)
    inst = _instance(vtt)
    scene = vtt.RaytraceScene(inst.scene.ior, inst.scene.translucency, device="cpu")
    assert scene._translucency_raw is None
    scene.options.write_instance = True
    with pytest.raises(ValueError, match="write_instance"):
        scene.trace_rays(inst.rays.start_position, inst.rays.start_direction, invscale=inst.rays.invscale,
                         iterations=20)
    assert list(tmp_path.iterdir()) == []


def _replay(monkeypatch, argv):
    """Run ``cli.main(argv)`` and return (its exit code, the trace result
    it computed)."""
    seen = []

    def capture(*args, **kw):
        seen.append(vtt.trace_rays_instance(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(cli, "trace_rays_instance", capture)
    rc = cli.main(argv)
    assert len(seen) == 1
    return rc, seen[0]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("suffix", [".npz", ".vrt"])
def test_cli_replays_like_trace_rays_instance(tmp_path, monkeypatch, capsys, writer, suffix):
    """vrt-replay-torch on a dump of either package: the end state of the
    direct trace_rays_instance bit for bit, and JAX's replay of the same
    file at tests/test_torch_fixed.py's tolerances; --bench prints the
    reference's throughput line."""
    path = tmp_path / f"inst{suffix}"
    mod_ser = ser if writer == "port" else jax_ser
    inst = _instance(vtt if writer == "port" else vrt)
    (mod_ser.save_instance_binary if suffix == ".vrt" else mod_ser.save_instance)(path, inst)
    rc, got = _replay(monkeypatch, [str(path), "--device", "cpu", "--bench"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].startswith("Rays per time = ") and out[0].endswith(" [R/s]")
    float(out[0].split("=")[1].split("[")[0])
    port_inst = cli._load(str(path))
    direct = vtt.trace_rays_instance(port_inst.scene, port_inst.rays, device="cpu")
    for f in ("end_position", "end_direction", "end_iteration", "remaining_light"):
        assert torch.equal(getattr(got, f), getattr(direct, f)), f
    jax_inst = jax_cli._load(str(path))
    ref = vrt.trace_rays_instance(jax_inst.scene, jax_inst.rays)
    _assert_fixed_close(got, ref)
    assert (got.end_iteration < 300).any()


def test_cli_scene_and_ray_files_float_mode(tmp_path, monkeypatch, capsys):
    """The two-file form in float mode, against trace_rays_instance."""
    inst = _instance(vtt)
    inst.rays.start_position = (inst.rays.start_position / 65536.0).astype(np.float32)
    ser.save_scene_instance(tmp_path / "scene.npz", inst.scene)
    ser.save_ray_instance(tmp_path / "rays.npz", inst.rays)
    rc, got = _replay(monkeypatch, [str(tmp_path / "scene.npz"), str(tmp_path / "rays.npz"), "--mode", "float",
                                    "--device", "cpu", "--loglevel", "-1"])
    assert rc == 0 and capsys.readouterr().out.startswith(f"traced {len(inst.rays.start_position)} rays in ")
    direct = vtt.trace_rays_instance(inst.scene, inst.rays, mode="float", device="cpu")
    assert torch.equal(got.end_position, direct.end_position)
    assert torch.equal(got.end_iteration, direct.end_iteration)


def test_cli_needs_a_card_unless_asked_for_the_cpu():
    """No fallback: --device cuda (the default) raises where there is no
    card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([])


def test_builtin_instance_matches_jax():
    """The built-in 100³ ramp is the JAX CLI's."""
    assert _fields(cli._builtin_instance()) == _fields(jax_cli._builtin_instance())


def test_trace_log_at_negative_loglevel(caplog):
    """Options.loglevel < 0 logs each trace as the JAX scene does
    (scene.py:181-186), through the port's logger."""
    ior = np.linspace(1.0, 2.0, 6 * 6 * 6, dtype=np.float32).reshape(6, 6, 6)
    scene = vtt.RaytraceScene(ior, options=vtt.Options(loglevel=-1), device="cpu")
    with caplog.at_level("INFO", logger="volumeraytracer_tpu_torch"):
        scene.trace_rays([[2.0, 2.0, 2.0], [3.0, 2.5, 2.0]], [[16.0, 0.0, 0.0]] * 2, invscale=[2.0] * 3,
                         iterations=20, mode="float")
    assert "trace_rays: 2 rays, mode=float kernel=auto budget=20" in caplog.text
