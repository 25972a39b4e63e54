"""The card toolkit (``probes/toolkit.py``) and the probes' host-side parts
on the CPU: the bench's inputs against bench.py, the digest, the readers of
cuobjdump's SASS listing and of ptxas' report on small listings of the same
form, the source edits, the runner that times two checkouts in turns (over
fake children and fake checkouts), the probes' variants of the sources and
the render probe's count of R2's atomics under its three flush schemes."""

import importlib.util
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from probes import probe_fixed, probe_fwd, probe_render, toolkit
from volumeraytracer_tpu_torch.kernels import _build

REPO = Path(__file__).resolve().parents[1]

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

#: P1's and P2's listing, and another kernel's
PACK_SASS = """
        Function : _ZN12_GLOBAL__N_121pack_field_fwd_kernelEPKfS1_P6float4iiiiiif
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDGSTS.E [R2], desc[UR4][R4.64] ;
        /*0020*/                   LDS R3, [R2] ;
        /*0030*/                   FADD R3, R3, R3 ;
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0050*/               @P0 BRA 0x10 ;
        /*0060*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_121pack_field_bwd_kernelEPKfPK6float4Pfiiiii
        /*0000*/                   FMUL R2, R2, R3 ;
        /*0010*/                   STG.E desc[UR4][R4.64], R2 ;
        /*0020*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_122line_table_fold_kernelEPKfP6float4iiiiii
        /*0000*/                   EXIT ;
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


def _ptxas_log(entries) -> str:
    """ptxas' report of kernels [(mangled name, registers, spill stores,
    line after the registers)]."""
    return "".join(
        f"ptxas info    : Compiling entry function '{k}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {k}\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {regs} registers{tail}, 600 bytes cmem[0]\n"
        for k, regs, spill, tail in entries)


def _entry(registers, spill_stores=0, smem_bytes=0, stack_frame=0):
    return {"stack_frame": stack_frame, "spill_stores": spill_stores, "spill_loads": 0, "registers": registers,
            "smem_bytes": smem_bytes}


PTXAS_CASES = {
    # two kernels, spills and shared memory
    "kernels": (PTXAS, False, {"line_table_fold": _entry(48),
                               "march_points_bwd": {"stack_frame": 8, "spill_stores": 4, "spill_loads": 4,
                                                    "registers": 96, "smem_bytes": 1024}}),
    # the recording K2's name also holds K2's, and takes its own
    "recording_k2": (_ptxas_log((f"_ZN12_GLOBAL__N_1{len(k)}{k}EPKfiiifff", r, 0, "")
                                for k, r in (("march_lines_fwd_kernel", 80), ("march_lines_fwd_path_kernel", 88))),
                     False, {"march_lines_fwd": _entry(80), "march_lines_fwd_path": _entry(88)}),
    # F1's four instantiations (recording or not, 32- or 64-bit cell
    # indices), each under its own name
    "f1_instantiations": (_ptxas_log(
        (f"_ZN12_GLOBAL__N_1{len(k)}{k}EPK6float4iii", 40 + r, 0, "") for r, k in enumerate(
            ("march_fixed_kernel", "march_fixed_path_kernel", "march_fixed_wide_kernel", "march_fixed_path_wide_kernel"))),
        False, {"march_fixed": _entry(40), "march_fixed_path": _entry(41), "march_fixed_wide": _entry(42),
                "march_fixed_path_wide": _entry(43)}),
    # R1's instantiations read as one kernel with the most registers and
    # spills among them, so that phase 2 of chip_smoke.py sees a spill in
    # any of them
    "largest_of_an_instantiation_set": (_ptxas_log(
        (f"_ZN12_GLOBAL__N_117render_fwd_kernelILi{nc}ELb1EEEvPK6float4", 60 + 4 * nc, 8 if nc == 2 else 0, "")
        for nc in range(5)), False, {"render_fwd": _entry(76, spill_stores=8)}),
    # with instances, each instantiation of R1 and R2 is its own entry
    "instances": (_ptxas_log(
        (f"_ZN12_GLOBAL__N_117render_{k}_kernelI{args}EEvPKf", regs, spill, ", used 1 barriers, 176 bytes smem")
        for k, args, regs, spill in (("fwd", "Li3ELb1ELb1E", 108, 0), ("bwd", "Lb1ELb1ELb1E", 165, 0),
                                     ("bwd", "Lb0ELb0ELb0E", 96, 8))),
        True, {"render_fwd<Li3ELb1ELb1E>": _entry(108, smem_bytes=176),
               "render_bwd<Lb1ELb1ELb1E>": _entry(165, smem_bytes=176),
               "render_bwd<Lb0ELb0ELb0E>": _entry(96, spill_stores=8, smem_bytes=176)}),
}


@pytest.mark.parametrize("case", list(PTXAS_CASES))
def test_ptxas_reader(case):
    log, instances, want = PTXAS_CASES[case]
    got = toolkit.ptxas(log, instances=instances)
    assert got == want
    assert {k.split("<")[0] for k in got} <= set(toolkit.KERNELS)


SASS_CASES = {
    # functions by kernel, opcode families, loops and the replay's
    # cell-change block (its loads and Hopper's REDG atomics); a kernel not
    # in KERNELS left out
    "kernels": (SASS, {
        "line_table_fold": {
            "all": {"total": 9, "MOV": 1, "LDGSTS": 1, "LDGDEPBAR": 1, "DEPBAR": 1, "BAR": 1, "LDS": 1, "STG": 1,
                    "BRA": 1, "EXIT": 1},
            "loops": [{"head": "0x10", "total": 7, "LDGSTS": 1, "LDGDEPBAR": 1, "DEPBAR": 1, "BAR": 1, "LDS": 1,
                       "STG": 1, "BRA": 1}],
            "cell_change": {"loop": 7, "cell_change_block": 0, "same_cell_step": 7, "block_loads": 0,
                            "block_atomics": 0}},
        "march_points_bwd": {
            "all": {"total": 10, "MOV": 1, "FADD": 1, "ISETP": 1, "BRA": 2, "REDG": 1, "LDG": 2, "FMUL": 1,
                    "EXIT": 1},
            "loops": [{"head": "0x10", "total": 8, "FADD": 1, "ISETP": 1, "BRA": 2, "REDG": 1, "LDG": 2, "FMUL": 1}],
            "cell_change": {"loop": 8, "cell_change_block": 3, "same_cell_step": 5, "block_loads": 2,
                            "block_atomics": 1}}}),
    # P1's and P2's instructions by family, all and in each loop
    "pack_field": (PACK_SASS, {
        "pack_field_fwd": {
            "all": {"total": 7, "MOV": 1, "LDGSTS": 1, "LDS": 1, "FADD": 1, "BAR": 1, "BRA": 1, "EXIT": 1},
            "loops": [{"head": "0x10", "total": 5, "LDGSTS": 1, "LDS": 1, "FADD": 1, "BAR": 1, "BRA": 1}],
            "cell_change": {"loop": 5, "cell_change_block": 0, "same_cell_step": 5, "block_loads": 0,
                            "block_atomics": 0}},
        "pack_field_bwd": {"all": {"total": 3, "FMUL": 1, "STG": 1, "EXIT": 1}, "loops": [], "cell_change": {}},
        "line_table_fold": {"all": {"total": 1, "EXIT": 1}, "loops": [], "cell_change": {}}}),
}


@pytest.mark.parametrize("case", list(SASS_CASES))
def test_sass_readers(case):
    sass, want = SASS_CASES[case]
    got = {k: {"all": toolkit.opcode_counts(ins), "loops": toolkit.sass_loops(ins),
               "cell_change": toolkit.cell_change_block(ins)} for k, ins in toolkit.sass_functions(sass).items()}
    assert got == want
    # by mangled name, every function
    assert list(toolkit.sass_functions(sass, mangled=True)) == re.findall(r"Function : (\S+)", sass)


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
    """The toolkit's loop reader on F1's step loop: the loop from the
    backward branch's target, the reload block that the forward branch over
    the most loads skips, the rest as the same-cell step with its opcode
    families; a loop whose loads are predicated keeps them in its step."""
    funcs = toolkit.sass_functions(F1_SASS)
    assert set(funcs) == {"march_fixed"}
    loops = toolkit.loop_steps(funcs["march_fixed"])
    assert loops == [
        {"head": "0x100", "loop": 3, "reload_block": 0, "step": 3, "block_loads": 0,
         "step_ops": {"LDG": 1, "FMUL": 1, "BRA": 1}},
        {"head": "0x10", "loop": 15, "reload_block": 3, "step": 12, "block_loads": 2,
         "step_ops": {"ISETP": 2, "BRA": 3, "SHF": 1, "IMAD": 1, "I2F": 1, "FMUL": 1, "FADD": 1, "F2I": 1,
                      "IADD3": 1}},
    ]


def test_edits_of_a_source():
    """``toolkit.edit`` makes each edit where its text or pattern matches
    once and raises otherwise; ``toolkit.constants`` sets ``constexpr int``
    values, backslashes in a replacement kept as they are."""
    src = "constexpr int PK = 16;\nconstexpr int NBUF = 2;\nx = a;\n"
    got = toolkit.edit(src, [*toolkit.constants(PK=24, NBUF=1), ("x = a;", r"x = '\n';")])
    assert got == "constexpr int PK = 24;\nconstexpr int NBUF = 1;\nx = '\\n';\n"
    with pytest.raises(ValueError, match="found 0 times"):
        toolkit.edit(src, toolkit.constants(RING=2))
    with pytest.raises(ValueError, match="found 2 times"):
        toolkit.edit(src + "x = a;\n", [("x = a;", "")])


def test_fwd_probe_variant_sources():
    """probe_fwd's variants of march_lines_fwd.cu: the pinned reload changes
    the capped K2's corner-table address and nothing else, the staging
    sweep sets PK and NBUF, and a source without them raises."""
    src = (_build._HERE / "csrc" / "march_lines_fwd.cu").read_text()
    pinned = toolkit.edit(src, [probe_fwd.pin(src)])
    changed = [(a, b) for a, b in zip(src.splitlines(), pinned.splitlines()) if a != b]
    assert len(changed) == 1 and changed[0][0].strip() == probe_fwd.PINS[0][0]
    line_only = src.replace(probe_fwd.PINS[0][0], "")
    assert probe_fwd.pin(line_only) == probe_fwd.PINS[1]
    v = toolkit.edit(src, toolkit.constants(PK=24, NBUF=2))
    assert "constexpr int PK = 24;" in v and "constexpr int NBUF = 2;" in v
    with pytest.raises(ValueError, match="NBUF"):
        toolkit.edit(src.replace("constexpr int NBUF", "constexpr int NBUFS"), toolkit.constants(PK=8, NBUF=1))
    with pytest.raises(ValueError, match="reload"):
        probe_fwd.pin(line_only.replace(probe_fwd.PINS[1][0], ""))


def test_fixed_probe_variant_sources():
    """probe_fixed's variants of march_fixed.cu: the staging sweep sets PK
    and NBUF and the contracted build swaps -fmad=false for -fmad=true and
    nothing else; every PK it sweeps is even, so that each run is whole
    16-byte units."""
    src = (_build._HERE / "csrc" / "march_fixed.cu").read_text()
    for pk, nbuf in probe_fixed.PK_SWEEP:
        v = toolkit.edit(src, toolkit.constants(PK=pk, NBUF=nbuf))
        assert f"constexpr int PK = {pk};" in v and f"constexpr int NBUF = {nbuf};" in v
        assert pk % 2 == 0
    flags = probe_fixed.fmad_flags(_build.NVCC_FLAGS)
    assert "-fmad=true" in flags and "-fmad=false" not in flags
    assert [f for f in flags if f != "-fmad=true"] == [f for f in _build.NVCC_FLAGS if f != "-fmad=false"]
    with pytest.raises(ValueError, match="fmad"):
        probe_fixed.fmad_flags(flags)


def test_render_probe_atomic_counts():
    """probe_render's count of R2's global atomics under the three flush
    schemes, on 128 rays that step together through the cells (s, 0, 0) of
    an 8 × 4 × 4 grid for 4 steps: a thread's caches flush 4 cells a ray,
    8 atomics each; a warp groups its 32 rays' flushes of one cell at one
    step; the block's box of one window holds the 5 × 2 × 2 points of the
    4 cells' corners.  A shuffled order leaves the box's count as it is."""
    steps = torch.full((128,), 4, dtype=torch.int64)
    cells = (torch.arange(4)[:, None] * 16).expand(4, 128).clone()
    for order in (torch.arange(128), torch.randperm(128, generator=torch.Generator().manual_seed(1))):
        counts = probe_render.atomic_counts(torch, cells, (8, 4, 4), steps, order)
        assert counts == {"thread": 8 * 4 * 128, "warp": 8 * 4 * 4, "box": 20, "box_windows": 1,
                          "box_windows_over_cap": 0, "flushes": 4 * 128}
    # a ray that stops after 2 steps flushes its 2 cells only
    steps[0] = 2
    assert probe_render.atomic_counts(torch, cells, (8, 4, 4), steps, torch.arange(128))["thread"] == 8 * (4 * 127 + 2)


def test_render_probe_variant_sources():
    """Each of probe_render's variants finds its text in today's R1 or R2
    source once and changes it; R1's nested-loop variant holds F1's form."""
    for name, src, fn_name, edits, _ in probe_render.VARIANTS:
        text = (_build._HERE / "csrc" / src).read_text()
        new = toolkit.edit(text, probe_render.variant_edits(text, edits))
        assert new != text and fn_name in text, name
    r1 = (_build._HERE / "csrc" / "render_fwd.cu").read_text()
    nested = toolkit.edit(r1, probe_render.variant_edits(r1, [(None, probe_render.NESTED_R1_LOOP)]))
    assert "stopped = true" in nested and "stopped = true" not in r1
    with pytest.raises(ValueError, match="variant text"):
        toolkit.edit(r1, probe_render.variant_edits(r1, [("no such text", "")]))


# --- the digest and the bench's inputs ---------------------------------------

_BITS = torch.arange(16, dtype=torch.float32).reshape(4, 4)


def _flipped(t):
    out = t.clone()
    out.view(torch.int32)[1, 2] ^= 1
    return out


@pytest.mark.parametrize("other, equal", [
    (_BITS.clone(), True),                  # the same bits in another tensor
    (_flipped(_BITS), False),               # one bit flipped
    (_BITS.view(torch.int32), False),       # the same bytes at another dtype
    (_BITS.reshape(16), False),             # ... and at another shape
    (_BITS.t().contiguous().t(), True),     # the same values in another layout
], ids=["equal", "bit", "dtype", "shape", "layout"])
def test_digest(other, equal):
    assert (toolkit.digest(_BITS) == toolkit.digest(other)) is equal
    assert len(toolkit.digest(_BITS)) == 16


def _bench():
    """bench.py, loaded by path (not run)."""
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


def test_lens_field_is_bench_field():
    np.testing.assert_array_equal(toolkit.lens_field(40), np.asarray(_bench().build_field(40)))
    assert toolkit.lens_field(8).dtype == np.float32


def test_bench_rays_are_bench_bundle():
    bench = _bench()
    for n_rays, grid in ((131072, 256), (1024, 64)):
        pos, dirs = toolkit.bench_rays(n_rays, grid)
        ref_pos, ref_dirs = bench.build_rays(n_rays, grid)
        np.testing.assert_array_equal(pos, np.asarray(ref_pos))
        np.testing.assert_array_equal(dirs, np.asarray(ref_dirs))


def test_scales_are_the_jax_packages():
    """The toolkit's float scales at invscale 2, as bench.py makes them from
    the JAX package's fixed-point constants."""
    from volumeraytracer_tpu.types import FIX_ONE, STEP_CONST

    assert toolkit.BEND == toolkit.INV / float(FIX_ONE)
    assert toolkit.STEP == toolkit.INV * (STEP_CONST / float(FIX_ONE) / float(FIX_ONE))


# --- two checkouts in turns ------------------------------------------------

#: a probe's child: the toolkit of this checkout, then the program of its
#: root; appends what it was given to the log and prints what it imported
FAKE_PROBE = """
import json
import os
import sys

from probes import toolkit

args = sys.argv[1:]
root = args[args.index("--child") + 1]
with open(os.environ["FAKE_PROBE_LOG"], "a") as log:
    log.write(json.dumps([root, args]) + "\\n")
program = toolkit.program(root)
if getattr(program, "FAIL", False):
    print("the fake program fails")
    sys.exit(3)
import probes.toolkit
print("a line before the results")
print(json.dumps({"digest": program.DIGEST, "program": program.__file__, "toolkit": probes.toolkit.__file__}))
"""


def _checkout(path: Path, body: str) -> Path:
    """A fake checkout: a stub program, and a toolkit that must not be
    imported."""
    (path / "volumeraytracer_tpu_torch").mkdir(parents=True)
    (path / "volumeraytracer_tpu_torch" / "__init__.py").write_text(body)
    (path / "probes").mkdir()
    (path / "probes" / "__init__.py").write_text("")
    (path / "probes" / "toolkit.py").write_text("raise ImportError('the toolkit of a checkout under test')\n")
    return path


@pytest.fixture
def fakes(tmp_path, monkeypatch):
    """The fake probe on PYTHONPATH, its log, a card line, and a maker of
    fake checkouts."""
    (tmp_path / "mods").mkdir()
    (tmp_path / "mods" / "fake_probe.py").write_text(FAKE_PROBE)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(filter(None, (str(tmp_path / "mods"),
                                                                   os.environ.get("PYTHONPATH")))))
    monkeypatch.setenv("FAKE_PROBE_LOG", str(tmp_path / "log.jsonl"))
    monkeypatch.setattr(toolkit, "card", lambda query="": "a test card")

    def log():
        return [json.loads(line) for line in (tmp_path / "log.jsonl").read_text().splitlines()]

    def checkout(name, body='DIGEST = "same"\n'):
        return _checkout(tmp_path.resolve() / name, body)

    return log, checkout


def test_in_turns_runs_parent_change_change_parent(fakes, capsys, tmp_path):
    log, checkout = fakes
    parent, change = checkout("parent"), checkout("change")
    out = tmp_path / "out" / "runs.json"
    line, runs = toolkit.in_turns("fake_probe", parent, change=change, flags=("--all",), first=("--first",),
                                  parent_first=("--parent-first",), digests=("digest",), out=out)
    assert line == "a test card"
    assert [r["label"] for r in runs] == ["parent", "change", "change", "parent"]
    assert [Path(r["root"]) for r in runs] == [parent, change, change, parent]
    assert [(Path(root), a[2:]) for root, a in log()] == [
        (parent, ["--all", "--parent-first"]), (change, ["--all", "--first"]), (change, ["--all"]),
        (parent, ["--all"])]
    assert json.loads(out.read_text()) == {"card": "a test card", "runs": runs}
    shown = capsys.readouterr().out.splitlines()
    assert shown[0] == "a test card" and [s.split(":")[0] for s in shown[1:]] == [r["label"] for r in runs]


def test_in_turns_without_a_parent_runs_children_of_the_change(fakes):
    log, checkout = fakes
    change = checkout("change")
    _, runs = toolkit.in_turns("fake_probe", change=change, first=("--first",), children=3)
    assert [r["label"] for r in runs] == ["change"] * 3
    assert [a[2:] for _, a in log()] == [["--first"], [], []]


def test_in_turns_refuses_a_digest_that_differs(fakes):
    _, checkout = fakes
    parent, change = checkout("parent"), checkout("change", 'DIGEST = "other"\n')
    with pytest.raises(SystemExit, match="fake_probe: digest differs between the versions or runs"):
        toolkit.in_turns("fake_probe", parent, change=change, digests=("digest",))
    # a key left out of the digests is not compared
    _, runs = toolkit.in_turns("fake_probe", parent, change=change)
    assert [r["digest"] for r in runs] == ["same", "other", "other", "same"]


def test_in_turns_reports_a_child_that_fails(fakes):
    log, checkout = fakes
    parent, change = checkout("parent"), checkout("change", 'DIGEST = "same"\nFAIL = True\n')
    with pytest.raises(SystemExit, match=r"(?s)the change child .* failed \(3\).*the fake program fails"):
        toolkit.in_turns("fake_probe", parent, change=change)
    assert [Path(root) for root, _ in log()] == [parent, change]
    with pytest.raises(SystemExit, match="must name a checkout"):
        toolkit.in_turns("fake_probe", parent / "volumeraytracer_tpu_torch", change=change)


def test_child_takes_its_program_from_its_root_and_its_tools_from_this_checkout(fakes):
    """A child's ``volumeraytracer_tpu_torch`` is its root's; its toolkit,
    imported before and after ``program``, is this checkout's, though the
    root holds one of its own."""
    _, checkout = fakes
    parent, change = checkout("parent"), checkout("change")
    _, runs = toolkit.in_turns("fake_probe", parent, change=change)
    for r in runs:
        assert Path(r["program"]).resolve().is_relative_to(Path(r["root"]))
        assert Path(r["toolkit"]).resolve() == Path(toolkit.__file__).resolve()
    assert "volumeraytracer_tpu_torch" in sys.modules  # this process's program is not the fakes'
    with pytest.raises(RuntimeError, match="imported before"):
        toolkit.program(parent)
