"""The probes' host-side parts on the CPU: the point table's two ray orders
against numpy lexsorts, the readers of cuobjdump's SASS listing and of
ptxas' report on small listings of the same form, the K4 sweep's
variants of the fold's source, and the render probe's count of R2's
atomics under its three flush schemes."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from volumeraytracer_tpu_torch.kernels import march_pallas as mp
from volumeraytracer_tpu_torch.probes import probe_k4k6 as probe

SASS = """
        Function : _ZN12_GLOBAL__N_122line_table_fold_kernelEPKfP6float4iiiiii
        /*0000*/                   MOV R1, c[0x0][0x28] ;                 /* 0x000fe40000000f00 */
        /*0010*/                   LDGSTS.E.BYPASS.128 [R2], desc[UR4][R4.64] ;     /* 0x0 */
        /*0020*/                   LDGDEPBAR ;                 /* 0x0 */
        /*0030*/                   DEPBAR.LE SB0, 0x1 ;                 /* 0x0 */
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;                 /* 0x0 */
        /*0050*/                   LDS R4, [R3] ;                 /* 0x0 */
        /*0060*/                   STG.E.128 desc[UR4][R6.64], R8 ;                 /* 0x0 */
        /*0070*/               @P0 BRA 0x10 ;                 /* 0x0 */
        /*0080*/                   EXIT ;                 /* 0x0 */
        Function : _ZN12_GLOBAL__N_123march_points_bwd_kernelEPKfPfiii
        /*0000*/                   MOV R1, c[0x0][0x28] ;                 /* 0x0 */
        /*0010*/                   FADD R2, R2, R3 ;                 /* 0x0 */
        /*0020*/                   ISETP.NE.AND.EX P0, PT, R4, R5, PT, P1 ;                 /* 0x0 */
        /*0030*/              @!P0 BRA 0x70 ;                 /* 0x0 */
        /*0040*/                   REDG.E.ADD.F32.FTZ.RN.STRONG.GPU desc[UR4][R2.64], R6 ;   /* 0x0 */
        /*0050*/                   LDG.E.CONSTANT R6, desc[UR4][R2.64] ;                 /* 0x0 */
        /*0060*/                   LDG.E.CONSTANT R7, desc[UR4][R2.64+0x4] ;                 /* 0x0 */
        /*0070*/                   FMUL R2, R2, R3 ;                 /* 0x0 */
        /*0080*/               @P2 BRA 0x10 ;                 /* 0x0 */
        /*0090*/                   EXIT ;                 /* 0x0 */
        Function : _ZN12_GLOBAL__N_113unrelated_kernelEv
        /*0000*/                   EXIT ;                 /* 0x0 */
"""

PTXAS = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122line_table_fold_kernelEPKfP6float4iiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122line_table_fold_kernelEPKfP6float4iiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123march_points_bwd_kernelEPKfPfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123march_points_bwd_kernelEPKfPfiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 96 registers, 1024 bytes smem, 480 bytes cmem[0]
"""


def test_point_orders_against_numpy():
    """The brick-only order is sort_point_rays'; the cell order sorts by
    point brick, then by cell in (x, y, z) order; invalid rays go last in
    input order, ties keep their input order."""
    shape = (31, 21, 17, 4)
    nb = mp.brick_grid(shape)
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1.5, np.array(shape[:3]) + 0.5, (300, 3)).astype(np.float32)
    pos[-30:] = pos[:30]
    valid = rng.random(len(pos)) < 0.8
    brick_order, cell_order = probe.point_orders(torch.from_numpy(pos), nb, torch.from_numpy(valid))
    assert torch.equal(brick_order, mp.sort_point_rays(torch.from_numpy(pos), nb, torch.from_numpy(valid))[0])
    size = np.array([mp.BX, mp.BY, mp.BZ])
    cell = np.minimum(np.maximum(np.floor(pos).astype(np.int64), 0), np.array(nb) * size - 1)
    b, local = cell // size, cell % size
    brick = (b[:, 0] * nb[1] + b[:, 1]) * nb[2] + b[:, 2]
    keys = np.stack([~valid, np.where(valid, brick, 0), *(np.where(valid, local[:, k], 0) for k in range(3))])
    np.testing.assert_array_equal(cell_order.numpy(), np.lexsort(keys[::-1]))


def test_sass_readers():
    """Functions by kernel, opcode families, loops and the replay's
    cell-change block (its loads and Hopper's REDG atomics)."""
    funcs = probe.sass_functions(SASS)
    assert set(funcs) == {"line_table_fold", "march_points_bwd"}
    fold = funcs["line_table_fold"]
    assert probe.opcode_counts(fold) == {"total": 9, "LDGSTS": 1, "STG": 1, "LDS": 1, "BAR": 1, "LDGDEPBAR": 1,
                                         "DEPBAR": 1}
    assert probe.sass_loops(fold) == [{"head": "0x10", "total": 7, "LDGSTS": 1, "STG": 1, "LDS": 1, "BAR": 1,
                                       "LDGDEPBAR": 1, "DEPBAR": 1}]
    assert probe.cell_change_block(funcs["march_points_bwd"]) == {
        "loop": 8, "cell_change_block": 3, "same_cell_step": 5, "block_loads": 2, "block_atomics": 1}


def test_ptxas_reader():
    assert probe.ptxas_by_kernel(PTXAS) == {
        "line_table_fold": {"spill_stores": 0, "spill_loads": 0, "registers": 48, "smem_bytes": 0},
        "march_points_bwd": {"spill_stores": 4, "spill_loads": 4, "registers": 96, "smem_bytes": 1024},
    }


def test_ptxas_reader_tells_the_recording_k2_from_k2():
    """K2's two instantiations are two entries of ptxas' report: the
    recording K2's name also holds K2's, and takes its own."""
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{len(k)}{k}EPKfiiifff' for 'sm_90a'\n"
        f"ptxas info    : Function properties for _ZN12_GLOBAL__N_1{len(k)}{k}EPKfiiifff\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, 600 bytes cmem[0]\n"
        for k, regs in (("march_lines_fwd_kernel", 80), ("march_lines_fwd_path_kernel", 88))
    )
    assert probe.ptxas_by_kernel(log) == {
        "march_lines_fwd": {"spill_stores": 0, "spill_loads": 0, "registers": 80, "smem_bytes": 0},
        "march_lines_fwd_path": {"spill_stores": 0, "spill_loads": 0, "registers": 88, "smem_bytes": 0},
    }
    assert {"march_lines_fwd", "march_lines_fwd_path"} <= set(probe.KERNELS)


def test_k4_sweep_variant_source():
    """The K4 sweep's variants change the fold's ring depth and blocks an SM
    and nothing else, and export its occupancy; the first variant is the
    source's own."""
    from pathlib import Path

    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.probes import sweep_k4

    src = (Path(_build.__file__).parent / "csrc" / "line_table_fold.cu").read_text()
    own = tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) for name in ("NSTAGE", "MIN_BLOCKS"))
    assert sweep_k4.VARIANTS[0] == own
    v = sweep_k4.variant_source(src, 4, 1)
    assert "constexpr int NSTAGE = 4;" in v and "constexpr int MIN_BLOCKS = 1;" in v
    assert v.endswith(sweep_k4.EXPORT) and sweep_k4.OCCUPANCY + "}  // namespace" in v
    assert sweep_k4.variant_source(src, *own) == src.rsplit("}  // namespace", 1)[0] + sweep_k4.OCCUPANCY \
        + "}  // namespace" + src.rsplit("}  // namespace", 1)[1] + sweep_k4.EXPORT
    with pytest.raises(ValueError, match="NSTAGE"):
        sweep_k4.variant_source(src.replace("constexpr int NSTAGE", "constexpr int RING"), 2, 2)


def test_fwd_probe_variant_sources():
    """probe_fwd's variants of march_lines_fwd.cu: the pinned reload changes
    the capped K2's corner-table address and nothing else, the staging
    sweep sets PK and NBUF, and a source without them raises."""
    from pathlib import Path

    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.probes import probe_fwd

    src = (Path(_build.__file__).parent / "csrc" / "march_lines_fwd.cu").read_text()
    pinned = probe_fwd.pinned_source(src)
    changed = [(a, b) for a, b in zip(src.splitlines(), pinned.splitlines()) if a != b]
    assert len(changed) == 1 and changed[0][0].strip() == probe_fwd.PINS[0][0]
    line_only = src.replace(probe_fwd.PINS[0][0], "")
    assert probe_fwd.pinned_source(line_only) == line_only.replace(*probe_fwd.PINS[1])
    v = probe_fwd.pk_source(src, 24, 2)
    assert "constexpr int PK = 24;" in v and "constexpr int NBUF = 2;" in v
    with pytest.raises(ValueError, match="NBUF"):
        probe_fwd.pk_source(src.replace("constexpr int NBUF", "constexpr int NBUFS"), 8, 1)
    with pytest.raises(ValueError, match="reload"):
        probe_fwd.pinned_source(line_only.replace(probe_fwd.PINS[1][0], ""))


F1_SASS = """
        Function : _ZN12_GLOBAL__N_118march_fixed_kernelEPK6float4iiiPKxPKfiiijS4_S6_PxPfS7_S7_S7_ijijfffj
        /*0000*/                   MOV R1, c[0x0][0x28] ;                 /* 0x0 */
        /*0010*/                   SHF.R.U32.HI R4, RZ, 0x10, R2 ;                 /* 0x0 */
        /*0020*/                   ISETP.GE.U32.AND P0, PT, R4, R5, PT ;                 /* 0x0 */
        /*0030*/               @P0 BRA 0x130 ;                 /* 0x0 */
        /*0040*/                   IMAD R6, R4, R7, R8 ;                 /* 0x0 */
        /*0050*/                   ISETP.NE.AND P1, PT, R6, R9, PT ;                 /* 0x0 */
        /*0060*/              @!P1 BRA 0xa0 ;                 /* 0x0 */
        /*0070*/                   LDG.E.128.CONSTANT R12, desc[UR4][R10.64] ;                 /* 0x0 */
        /*0080*/                   LDG.E.128.CONSTANT R16, desc[UR4][R10.64+0x10] ;                 /* 0x0 */
        /*0090*/                   MOV R9, R6 ;                 /* 0x0 */
        /*00a0*/                   I2F.U32 R20, R21 ;                 /* 0x0 */
        /*00b0*/                   FMUL R20, R20, 1.52587890625e-05 ;                 /* 0x0 */
        /*00c0*/                   FADD R22, -R20, 1 ;                 /* 0x0 */
        /*00d0*/                   F2I.S64 R24, R22 ;                 /* 0x0 */
        /*00e0*/                   IADD3 R2, R2, R24, RZ ;                 /* 0x0 */
        /*00f0*/                   BRA 0x10 ;                 /* 0x0 */
        /*0100*/               @P2 LDG.E.128.CONSTANT R12, desc[UR4][R10.64] ;                 /* 0x0 */
        /*0110*/                   FMUL R2, R2, R3 ;                 /* 0x0 */
        /*0120*/               @P3 BRA 0x100 ;                 /* 0x0 */
        /*0130*/                   EXIT ;                 /* 0x0 */
"""


def test_fixed_probe_loop_reader():
    """probe_fixed's SASS reader on F1's step loop: the loop from the
    backward branch's target, the reload block that the forward branch over
    the most loads skips, the rest as the same-cell step with its opcode
    families; a loop whose loads are predicated keeps them in its step."""
    from volumeraytracer_tpu_torch.probes import probe_fixed

    funcs = probe.sass_functions(F1_SASS)
    assert set(funcs) == {"march_fixed"}
    loops = probe_fixed.loop_steps(funcs["march_fixed"])
    assert loops == [
        {"head": "0x100", "loop": 3, "reload_block": 0, "step": 3, "block_loads": 0,
         "step_ops": {"LDG": 1, "FMUL": 1, "BRA": 1}},
        {"head": "0x10", "loop": 15, "reload_block": 3, "step": 12, "block_loads": 2,
         "step_ops": {"ISETP": 2, "BRA": 3, "SHF": 1, "IMAD": 1, "I2F": 1, "FMUL": 1, "FADD": 1, "F2I": 1,
                      "IADD3": 1}},
    ]


def test_fixed_probe_variant_sources():
    """probe_fixed's variants of march_fixed.cu: the staging sweep sets PK
    and NBUF (probe_fwd's pk_source on F1's source) and the contracted build
    swaps -fmad=false for -fmad=true and nothing else; every PK it sweeps
    is even, so that each run is whole 16-byte units."""
    from pathlib import Path

    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.kernels import march_fixed as kf
    from volumeraytracer_tpu_torch.probes import probe_fixed, probe_fwd

    src = (Path(_build.__file__).parent / "csrc" / "march_fixed.cu").read_text()
    for pk, nbuf in probe_fixed.PK_SWEEP:
        v = probe_fwd.pk_source(src, pk, nbuf)
        assert f"constexpr int PK = {pk};" in v and f"constexpr int NBUF = {nbuf};" in v
        assert pk % 2 == 0
    flags = probe_fixed.fmad_flags(_build.NVCC_FLAGS)
    assert "-fmad=true" in flags and "-fmad=false" not in flags
    assert [f for f in flags if f != "-fmad=true"] == [f for f in _build.NVCC_FLAGS if f != "-fmad=false"]
    with pytest.raises(ValueError, match="fmad"):
        probe_fixed.fmad_flags(flags)


def test_ptxas_reader_tells_the_f1_instantiations_apart():
    """F1's four instantiations (recording or not, 32- or 64-bit cell
    indices) are four entries of ptxas' report, each under its own name."""
    names = ("march_fixed_kernel", "march_fixed_path_kernel", "march_fixed_wide_kernel", "march_fixed_path_wide_kernel")
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{len(k)}{k}EPK6float4iii' for 'sm_90a'\n"
        f"ptxas info    : Function properties for _ZN12_GLOBAL__N_1{len(k)}{k}EPK6float4iii\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {40 + r} registers, 600 bytes cmem[0]\n"
        for r, k in enumerate(names)
    )
    got = probe.ptxas_by_kernel(log)
    assert {k: v["registers"] for k, v in got.items()} == {
        "march_fixed": 40, "march_fixed_path": 41, "march_fixed_wide": 42, "march_fixed_path_wide": 43}
    assert set(got) <= set(probe.KERNELS)


def test_render_probe_atomic_counts():
    """probe_render's count of R2's global atomics under the three flush
    schemes, on 128 rays that step together through the cells (s, 0, 0) of
    an 8 × 4 × 4 grid for 4 steps: a thread's caches flush 4 cells a ray,
    8 atomics each; a warp groups its 32 rays' flushes of one cell at one
    step; the block's box of one window holds the 5 × 2 × 2 points of the
    4 cells' corners.  A shuffled order leaves the box's count as it is."""
    from volumeraytracer_tpu_torch.probes import probe_render

    steps = torch.full((128,), 4, dtype=torch.int64)
    cells = (torch.arange(4)[:, None] * 16).expand(4, 128).clone()
    for order in (torch.arange(128), torch.randperm(128, generator=torch.Generator().manual_seed(1))):
        counts = probe_render.atomic_counts(torch, cells, (8, 4, 4), steps, order)
        assert counts == {"thread": 8 * 4 * 128, "warp": 8 * 4 * 4, "box": 20, "box_windows": 1,
                          "box_windows_over_cap": 0, "flushes": 4 * 128}
    # a ray that stops after 2 steps flushes its 2 cells only
    steps[0] = 2
    assert probe_render.atomic_counts(torch, cells, (8, 4, 4), steps, torch.arange(128))["thread"] == 8 * (4 * 127 + 2)


def test_render_probe_ptxas_reader():
    """probe_render's ptxas reader keeps each instantiation of R1 and R2
    apart."""
    from volumeraytracer_tpu_torch.probes import probe_render

    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117render_{k}_kernelI{args}EEvPKf' for 'sm_90a'\n"
        f"ptxas info    : Function properties for _ZN12_GLOBAL__N_117render_{k}_kernelI{args}EEvPKf\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers, 176 bytes smem, 600 bytes cmem[0]\n"
        for k, args, regs, spill in (("fwd", "Li3ELb1ELb1E", 108, 0), ("bwd", "Lb1ELb1ELb1E", 165, 0),
                                     ("bwd", "Lb0ELb0ELb0E", 96, 8)))
    assert probe_render.ptxas_instances(log) == {
        "render_fwd<Li3ELb1ELb1E>": {"spill_stores": 0, "spill_loads": 0, "registers": 108, "smem_bytes": 176},
        "render_bwd<Lb1ELb1ELb1E>": {"spill_stores": 0, "spill_loads": 0, "registers": 165, "smem_bytes": 176},
        "render_bwd<Lb0ELb0ELb0E>": {"spill_stores": 8, "spill_loads": 0, "registers": 96, "smem_bytes": 176}}


def test_render_probe_variant_sources():
    """Each of probe_render's variants finds its text in today's R1 or R2
    source once and changes it; R1's nested-loop variant holds F1's form."""
    from volumeraytracer_tpu_torch.kernels import _build
    from volumeraytracer_tpu_torch.probes import probe_render

    for name, src, fn_name, edits, _ in probe_render.VARIANTS:
        text = (_build._HERE / "csrc" / src).read_text()
        new = probe_render.variant_source(text, edits)
        assert new != text and fn_name in text, name
    r1 = (_build._HERE / "csrc" / "render_fwd.cu").read_text()
    nested = probe_render.variant_source(r1, [(None, probe_render.NESTED_R1_LOOP)])
    assert "stopped = true" in nested and "stopped = true" not in r1
    with pytest.raises(ValueError, match="variant text"):
        probe_render.variant_source(r1, [("no such text", "")])
