"""Run one cell traced, as ``grinbench/run.py --trace 1`` runs it, and report
what the program's spans show of the profiled slice.

    python3 grinbench/span_report.py --workload <cell> --seed <n> --seconds <s> [--out DIR]

Prints run.py's result line, then one line of JSON: the slice's units and
unit time, the span readers' metrics (``span_readers``: the device's idle
inside the program's units, the waits and the kernels a unit, the host ms
of the camera's rays), the idle a unit by the innermost span around it,
the waits a unit by ``vrt.sync.*`` site, the kernels a unit by the
innermost span around their launch, and each of the port's kernels with
the launches of it inside its own ``vrt.kernel.*`` span.  With ``--out``
the slice's Chrome trace (gzip) and the report are written there too.
The run itself is run.py's: this script only keeps the trace that the
window reads, and counts the slice's units.
"""

import argparse
import gzip
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import run  # noqa: E402  (grinbench/run.py, beside this file)
from grinbench import span_readers, trace_reader, window  # noqa: E402


def report(sp: span_readers.Spans, units: int) -> dict:
    return {
        "units": units,
        "unit_ms": (sp.t1 - sp.t0) / units * 1e-3,
        "program_idle_share": span_readers.program_idle_share(sp),
        "host_syncs": span_readers.host_syncs(sp, units),
        "launches": span_readers.launches(sp, units),
        "camera_rays_ms": span_readers.span_ms(sp, "vrt.entry.camera_rays", units),
        "idle_ms_by_span": span_readers.idle_by_span(sp, units),
        "syncs_by_site": span_readers.syncs_by_site(sp, units),
        "kernels_by_span": span_readers.kernels_by_span(sp, units),
        "port_kernels": span_readers.port_kernel_launches(sp),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the slice's trace and the report")
    ap.add_argument("--workload", required=True)
    args, rest = ap.parse_known_args(argv)
    out = Path(args.out) if args.out else None
    seen = {}
    read, shut = trace_reader.read, window.Window._shut

    def keep(path, host_s):
        seen["spans"] = span_readers.load(path, host_s)
        if out is not None:
            out.mkdir(parents=True, exist_ok=True)
            with open(path, "rb") as src, gzip.open(out / f"{args.workload}.trace.json.gz", "wb") as dst:
                shutil.copyfileobj(src, dst)
        return read(path, host_s)

    def shut_and_count(self):
        shut(self)
        seen["units"] = self.slice_count

    trace_reader.read, window.Window._shut = keep, shut_and_count
    rc = run.main(["--workload", args.workload, *rest, "--trace", "1"])
    if rc != 0 or "spans" not in seen:
        return rc or 1
    rep = dict(cell=args.workload, **report(seen["spans"], seen["units"]))
    if out is not None:
        (out / f"{args.workload}.spans.json").write_text(json.dumps(rep, indent=1))
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
