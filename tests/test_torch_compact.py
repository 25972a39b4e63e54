"""Port parity: scattered-ray compaction (``march_lines_compact``) and the
line march's pause and resume (``march_lines(max_steps=, init_state=)``)
on the CPU, where each phase is the plain march, against the JAX package's
compaction driver (interpret mode), its XLA march and the port's own single
march, at the cases of tests/test_lines.py:208-303."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from volumeraytracer_tpu.kernels.line_table import build_line_table as jax_build_line_table
from volumeraytracer_tpu.kernels.march_lines import march_lines_compact as jax_march_lines_compact
from volumeraytracer_tpu.ops import march as jax_march
from volumeraytracer_tpu.ops.fields import build_packed_field as jax_build_packed_field
from probes.toolkit import build_scattered_rays
from volumeraytracer_tpu_torch.kernels import _build
from volumeraytracer_tpu_torch.kernels.march_lines import march_lines, march_lines_compact
from volumeraytracer_tpu_torch.ops.fields import build_packed_field, cropped_translucency

INV = 2.0
BEND = INV / 65536.0
STEP = INV * (float(0x42000000) / 65536.0 / 65536.0)
KW = dict(bend_scale=BEND, step_scale=STEP)
FIELDS = ("end_position", "end_direction", "end_iteration", "remaining_light")
REPO = Path(__file__).resolve().parents[1]


def _lens(n=40):
    """tests/test_lines.py's lens, 1 + 0.4·exp(−3r²) on [−1, 1]³."""
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return 1.0 + 0.4 * np.exp(-3.0 * (x * x + y * y + z * z)).astype(np.float32)


def _scattered(seed, n_rays):
    """tests/test_lines.py's scattered rays: positions and directions all
    over the 40³ volume."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(3.0, 34.0, (n_rays, 3)).astype(np.float32)
    dirs = rng.normal(0.0, 8.0, (n_rays, 3)).astype(np.float32) + np.float32(1e-3)
    return pos, dirs


def _scene(absorb):
    """(packed, cropped translucency or None, minimum brightness) of the
    lens, with an absorber that takes 1/200 of the full light a step and a
    minimum brightness of one half when ``absorb``."""
    ior = torch.from_numpy(_lens())
    if not absorb:
        return build_packed_field(ior), None, 0
    tr = torch.full(tuple(ior.shape), 0xFFFFFFFF - int(0xFFFFFFFF / 200), dtype=torch.int64)
    return build_packed_field(ior, tr), cropped_translucency(tr), int(0.5 * 0xFFFFFFFF)


def _assert_equal(got, ref, fields=FIELDS):
    for f in fields:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f"{f}: max diff {(a.double() - b.double()).abs().max()}"


def _check_jax_tolerance(got, ref):
    """tests/test_torch_march.py's tolerances against the JAX line kernel:
    iterations exact, positions within 1e-4, directions within 1e-6."""
    np.testing.assert_array_equal(got.end_iteration.numpy(), np.asarray(ref.end_iteration).astype(np.int64))
    np.testing.assert_allclose(got.end_position.numpy(), np.asarray(ref.end_position), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.end_direction.numpy(), np.asarray(ref.end_direction), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def jax_compact():
    """JAX's compaction driver in interpret mode on tests/test_lines.py:
    271-303's scene (40³ lens, 48 scattered rays of seed 13, budget 150),
    computed once (~20 s)."""
    pos, dirs = _scattered(13, 48)
    packed = jax_build_packed_field(jnp.asarray(_lens()))
    table, nb = jax_build_line_table(packed, None)
    res = jax_march_lines_compact(
        packed, jnp.asarray(pos), jnp.asarray(dirs), 150, k_steps=8, phase_windows=5, max_phases=8000,
        interpret=True, table=table, nb=nb, **KW,
    )
    return pos, dirs, res


def test_compact_matches_jax_compaction(jax_compact):
    pos, dirs, ref = jax_compact
    packed, _, _ = _scene(False)
    _build.launches.clear()
    got = march_lines_compact(packed, torch.from_numpy(pos), torch.from_numpy(dirs), 150, phase_steps=5, **KW)
    _check_jax_tolerance(got, ref)
    np.testing.assert_array_equal(got.remaining_light.numpy(), np.asarray(ref.remaining_light).astype(np.int64))
    assert got.windows_used is None and got.path is None
    assert (got.end_iteration < 150).any() and (got.end_iteration == 150).any()
    # on CPU tensors every phase is the plain march: no kernel launched
    assert not _build.launches


@pytest.mark.parametrize("absorb", [False, True], ids=["plain", "absorb_minb"])
@pytest.mark.parametrize("phase_steps", [1, 5, 37, 150, None])
def test_compact_equals_single_march(phase_steps, absorb):
    """Phases of any length, carrying the plain march's own state, end
    where one march ends, bit for bit, light included (None: the default,
    one phase of the whole budget)."""
    packed, trc, minb = _scene(absorb)
    pos, dirs = (torch.from_numpy(a) for a in _scattered(13, 48))
    kw = dict(translucency=trc, minimum_brightness=minb, **KW)
    ref = march_lines(packed, pos, dirs, 150, **kw)
    got = march_lines_compact(packed, pos, dirs, 150, phase_steps=phase_steps, **kw)
    _assert_equal(got, ref)
    if absorb:
        # rays stop dark after ~100 steps, others leave the volume earlier
        dark = ref.remaining_light < minb
        assert bool(dark.any()) and bool((~dark & (ref.end_iteration < 100)).any())


def test_compact_few_phases_reports_alive_rays():
    """With fewer phases than the march needs, the rays still alive report
    end_iteration = budget (end_remaining = 0) and their state after the
    phases' steps, as JAX's driver does: the port's march paused after the
    same number of steps."""
    packed, _, _ = _scene(False)
    pos, dirs = (torch.from_numpy(a) for a in _scattered(13, 48))
    got = march_lines_compact(packed, pos, dirs, 150, phase_steps=5, max_phases=3, **KW)
    paused, state = march_lines(packed, pos, dirs, 150, max_steps=15, return_state=True, **KW)
    _assert_equal(got, paused)
    single = march_lines(packed, pos, dirs, 150, **KW)
    cut = (state["alive"] != 0) & (single.end_iteration < 150)
    assert bool(cut.any()) and bool((got.end_iteration[cut] == 150).all())


def _resume(packed, trc, pos, dirs, budget, max_steps):
    """A march paused after ``max_steps`` steps and resumed from its
    returned state: (second leg's result, first leg's state, second leg's
    state)."""
    kw = dict(translucency=trc, **KW)
    r1, s1 = march_lines(packed, pos, dirs, budget, max_steps=max_steps, return_state=True, **kw)
    r2, s2 = march_lines(packed, r1.end_position, r1.end_direction, budget, init_state=s1, return_state=True, **kw)
    return r2, s1, s2


@pytest.mark.parametrize("absorb", [False, True], ids=["plain", "absorb"])
@pytest.mark.parametrize("max_steps", [6, 60])
def test_pause_resume_equals_single_march(max_steps, absorb):
    """tests/test_lines.py:208-268: a march paused by the step cap and
    resumed from its returned state ends where the single march ends, and
    the executed steps of the two legs add up.  With translucency the
    resume reads the brightness back from its float fraction, so the light
    may differ in its last bits: within 2e-2 relative (the port's bound for
    the kernels' absorption), iterations exact."""
    packed, trc, _ = _scene(absorb)
    pos, dirs = (torch.from_numpy(a) for a in _scattered(9, 40))
    budget = 200
    _build.launches.clear()
    ref, s_ref = march_lines(packed, pos, dirs, budget, translucency=trc, return_state=True, **KW)
    got, s1, s2 = _resume(packed, trc, pos, dirs, budget, max_steps)
    assert not _build.launches
    assert int(s1["alive"].sum()) > 0
    _assert_equal(got, ref, FIELDS[:3])
    if absorb:
        np.testing.assert_allclose(got.remaining_light.numpy(), ref.remaining_light.numpy(), rtol=2e-2)
    else:
        _assert_equal(got, ref, FIELDS[3:])
    ex1 = (budget - 1) - s1["remaining"].to(torch.int64)
    ex2 = s1["remaining"].to(torch.int64) - s2["remaining"].to(torch.int64)
    torch.testing.assert_close(ex1 + ex2, (budget - 1) - s_ref["remaining"].to(torch.int64), rtol=0, atol=0)


@pytest.mark.parametrize("max_steps", [6, 60])
def test_pause_resume_matches_jax_xla_march(max_steps):
    """The resumed march against the JAX package's XLA march, the spec its
    kernel tests hold to, at tests/test_torch_march.py's tolerances."""
    pos, dirs = _scattered(9, 40)
    ref = jax_march.march_float(jax_build_packed_field(jnp.asarray(_lens())), None, jnp.asarray(pos),
                                jnp.asarray(dirs), 200, chunk_steps=64, **KW)
    packed, _, _ = _scene(False)
    got, _, _ = _resume(packed, None, torch.from_numpy(pos), torch.from_numpy(dirs), 200, max_steps)
    _check_jax_tolerance(got, ref)


@pytest.mark.parametrize("kw", [dict(max_steps=6), dict(init_state="paused")], ids=["max_steps", "init_state"])
def test_record_path_with_pause_raises(kw):
    """JAX's compaction records no path: record_path with a cap or a
    resumed state raises."""
    packed, _, _ = _scene(False)
    pos, dirs = (torch.from_numpy(a) for a in _scattered(9, 8))
    if kw.get("init_state") == "paused":
        _, state = march_lines(packed, pos, dirs, 50, max_steps=3, return_state=True, **KW)
        kw = dict(init_state=state)
    with pytest.raises(ValueError, match="record_path"):
        march_lines(packed, pos, dirs, 50, record_path=True, **kw, **KW)


def test_compact_rejects_bad_phase_steps():
    packed, _, _ = _scene(False)
    pos, dirs = (torch.from_numpy(a) for a in _scattered(9, 4))
    with pytest.raises(ValueError, match="phase_steps"):
        march_lines_compact(packed, pos, dirs, 50, phase_steps=0, **KW)


def test_scattered_rays_match_bench():
    """The toolkit's copy of bench.py's scattered workload draws the same
    numbers (bench.py is loaded by path, not run)."""
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    ref_pos, ref_dirs = bench.build_scattered_rays(n_rays=4096)
    pos, dirs = build_scattered_rays(n_rays=4096)
    assert pos.dtype == dirs.dtype == np.float32 and pos.shape == dirs.shape == (4096, 3)
    np.testing.assert_array_equal(pos, np.asarray(ref_pos))
    np.testing.assert_array_equal(dirs, np.asarray(ref_dirs))
    assert pos.min() >= 4.0 and pos.max() <= 252.0
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=-1), 16.0, rtol=1e-5)
