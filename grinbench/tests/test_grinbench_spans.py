"""The span readers (``grinbench/span_readers.py``) on a Chrome trace made
by hand around one ``grinbench.slice``: each reading worked out by hand,
and every per-layer reader of ``BENCHMARK.json`` and ``Slice.breakdown()``
reading the same from the trace with and without the program's spans."""

import json

import pytest

from conftest import ROOT
from grinbench import harness, span_readers, trace_reader

# the slice: 1000-2000 µs on the trace's clock (host_s = 1 ms); thread 1 is
# the program's, thread 2 the autograd engine's backward thread
T0, HOST_S = 1000.0, 1e-3
KERNEL = "void (anonymous namespace)::march_lines_fwd_kernel<false, false>(float const*, int)"
PORT = ("line_table_build_kernel", "march_lines_bwd_kernel", "line_table_fold_kernel", "pack_field_fwd_kernel",
        "pack_field_bwd_kernel", "render_fwd_kernel", "render_bwd_kernel")


def _x(cat, name, ts, dur, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if args:
        e["args"] = args
    return e


def _events(spans: bool, port: bool = False) -> list:
    """Host operations, runtime calls and device work, with the program's
    ``vrt.*`` spans (host and device annotations) when ``spans``, and with
    ``port`` the rest of the port's kernels late in the slice."""
    ev = [
        _x("user_annotation", trace_reader.SLICE, T0, 1000.0),
        _x("cpu_op", "aten::mul", 1010.0, 30.0),
        _x("cuda_runtime", "cudaLaunchKernel", 1020.0, 5.0, correlation=8),
        _x("kernel", "elementwise_kernel", 1050.0, 30.0, tid=20, correlation=8),
        _x("cpu_op", "aten::_local_scalar_dense", 1240.0, 60.0),
        _x("cuda_runtime", "cudaStreamSynchronize", 1260.0, 25.0),
        _x("cuda_runtime", "cudaLaunchKernel", 1400.0, 5.0, correlation=7),
        _x("kernel", KERNEL, 1450.0, 250.0, tid=20, correlation=7),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1710.0, 5.0, tid=20),
        _x("cuda_runtime", "cudaStreamSynchronize", 1900.0, 40.0),
        _x("cpu_op", "aten::select", 1880.0, 90.0),
    ]
    if port:
        ev += [_x("kernel", name, 1720.0 + 15 * k, 10.0, tid=20) for k, name in enumerate(PORT)]
    if spans:
        ev += [
            _x("user_annotation", "vrt.entry.train_step", 1100.0, 700.0),
            _x("user_annotation", "vrt.driver.sort", 1200.0, 100.0),
            _x("user_annotation", "vrt.sync.brick_cell", 1250.0, 40.0),
            _x("user_annotation", "vrt.kernel.march_lines_fwd", 1390.0, 30.0),
            _x("user_annotation", "vrt.driver.replay", 1600.0, 110.0, tid=2),
            _x("gpu_user_annotation", "vrt.kernel.march_lines_fwd", 1450.0, 250.0, tid=20),
        ]
    return ev


def _write(tmp_path, spans: bool, port: bool = False) -> str:
    path = tmp_path / f"trace_{int(spans)}.json"
    path.write_text(json.dumps({"traceEvents": _events(spans, port)}))
    return str(path)


@pytest.fixture
def sp(tmp_path):
    return span_readers.load(_write(tmp_path, True), HOST_S)


def test_collect(sp):
    """Gaps 1000-1050, 1080-1450, 1700-1710 and 1715-2000; one wait in the
    step and one after it; two kernels in the slice, the port's launched at
    1400 on thread 1."""
    assert (sp.t0, sp.t1) == (T0, 2000.0)
    assert sp.gaps == [(1000.0, 1050.0), (1080.0, 1450.0), (1700.0, 1710.0), (1715.0, 2000.0)]
    assert [s.name for s in sp.entries()] == ["vrt.entry.train_step"]
    assert [t for _, t, _ in sp.syncs] == [1260.0, 1900.0]
    assert sorted(sp.kernels) == sorted([(KERNEL, (1400.0, 1)), ("elementwise_kernel", (1020.0, 1))])


def test_metrics_by_hand(sp):
    # idle in the step 1100-1800: 1100-1450 and 1700-1710, 1715-1800
    assert span_readers.program_idle_share(sp) == pytest.approx(100.0 * (350 + 10 + 85) / 700)
    assert span_readers.host_syncs(sp, 1) == 1.0
    assert span_readers.host_syncs(sp, 2) == 0.5
    assert span_readers.launches(sp, 2) == 1.0
    assert span_readers.span_ms(sp, "vrt.driver.sort", 1) == pytest.approx(0.1)
    assert span_readers.span_ms(sp, "vrt.entry.camera_rays", 1) is None


def test_breakdowns_by_hand(sp):
    idle = span_readers.idle_by_span(sp, 1)
    # the replay on the backward thread holds 1700-1710 and 1715-1800 is the step's
    expect = {"vrt.entry.train_step": (100 + 90 + 30 + 85) * 1e-3, span_readers.NO_SPAN: (50 + 20 + 200) * 1e-3,
              "vrt.driver.sort": 0.06, "vrt.sync.brick_cell": 0.04, "vrt.kernel.march_lines_fwd": 0.03,
              "vrt.driver.replay": 0.01, "outside entry": (50 + 20 + 200) * 1e-3}
    assert idle == pytest.approx(expect)
    assert span_readers.syncs_by_site(sp, 1) == {"vrt.sync.brick_cell": 1.0}
    assert span_readers.kernels_by_span(sp, 2) == {"vrt.kernel.march_lines_fwd": 0.5, span_readers.NO_SPAN: 0.5}
    assert span_readers.port_kernel_launches(sp) == {"march_lines_fwd_kernel": [1, 1]}
    # a launch on the backward thread, which holds no span then, goes to the step's span
    sp.kernels.append(("indexing_backward_kernel", (1550.0, 2)))
    assert span_readers.kernels_by_span(sp, 1)["vrt.entry.train_step"] == 1.0


def test_unnamed_wait_and_mislabelled_launch(tmp_path):
    """A wait outside every ``vrt.sync.*`` span is reported with the span
    it lies in; a port kernel launched outside its own kernel span is not
    counted as matched."""
    ev = [e for e in _events(True) if e["name"] != "vrt.sync.brick_cell"]
    for e in ev:
        if e["name"] == "vrt.kernel.march_lines_fwd" and e["cat"] == "user_annotation":
            e["name"] = "vrt.kernel.render_fwd"
    sp = span_readers.collect(ev, T0, 2000.0)
    assert span_readers.syncs_by_site(sp, 1) == {
        f"{span_readers.NO_SITE} cudaStreamSynchronize in vrt.driver.sort": 1.0}
    assert span_readers.port_kernel_launches(sp) == {"march_lines_fwd_kernel": [0, 1]}


def test_no_program_spans_read_nothing(tmp_path):
    """A trace of a program without spans: every metric is None, and the
    idle is all outside the program's units."""
    sp = span_readers.load(_write(tmp_path, False), HOST_S)
    assert sp.spans == [] and sp.entries() == []
    assert span_readers.program_idle_share(sp) is None
    assert span_readers.host_syncs(sp, 1) is None and span_readers.launches(sp, 1) is None
    assert span_readers.idle_by_span(sp, 1)["outside entry"] == pytest.approx(0.715)


BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORK = {"rays": 1024, "steps": 10**6, "line_bricks": 40, "packed_shape": (254, 254, 254), "channels": 3}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_existing_readers_unmoved_by_spans(metric, tmp_path):
    """Each per-layer reader of the benchmark, and the slice's breakdown,
    read the same with the program's spans in the trace as without."""
    got = []
    for spans in (False, True):
        sl = trace_reader.read(_write(tmp_path, spans, port=True), HOST_S)
        run = harness.TracedRun(sl, 2, WORK)
        got.append((dict(vars(sl)), sl.breakdown(), harness.layer_reader(ROOT, metric)(run)))
    assert got[0] == got[1] and got[0][2] is not None
