#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python -m portbench.run`` alike), from the root of a checkout.  The run
loads the cell's files by name (``spec.py``), makes its inputs from the
seed on the card, warms up the cell's shapes, measures for ``--seconds``,
checks what the timed path produced against the plain reference
(``portbench/reference``), and prints one JSON line as the last line of
its standard output: the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics (from a profiled slice of the window) with
``--trace 1``.  Each number the check compares is printed beside its
limit on standard error and under the line's last key, ``"check"``.

It exits 1 with no result without a CUDA device, or with fewer than the
cell's chips, and 2 if the process holds JAX or the JAX package when the
window has closed.
"""
import time

_T0 = time.time()  # set-up is timed from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

#: top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "myldpccppapi_tpu")
#: build and kernel caches, at fixed paths inside the checkout
CACHES = {"CUDA_CACHE_PATH": "cuda", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


def set_caches(root: pathlib.Path = _ROOT) -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(root / ".portbench_cache" / sub)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def run_cell(cell, seed: int, seconds: float, trace: bool, t0: float,
             device="cuda", **driver_kw) -> dict:
    """Drive ``cell`` once and assemble its result (everything but the look
    for a chip, which :func:`main` makes)."""
    from portbench import roofline
    from portbench.spec import metric_reader

    out = cell.driver().run(cell, seed, seconds, trace, t0, device=device, **driver_kw)
    check = {k: {"value": v, "limit": lim} for k, (v, lim) in out["check"].items()}
    if str(device).startswith("cuda"):
        import torch

        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    dev = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": all(c["value"] <= c["limit"] for c in check.values()),
            "attempted": out["attempted"], "failed": out["failed"]}
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    else:
        tr = out["trace"]
        ctx = dict(out["ctx"], trace=tr, peaks=roofline.peaks_of(kind))
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.here)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_ns / 1e9
        dev["window_s"] = tr.window_ns / 1e9
        line["breakdown"] = tr.breakdown()
    line["metrics"] = metrics
    line["device"] = dev
    line["checked_calls"] = out.get("checked_calls")
    if out.get("reference"):
        line["reference"] = out["reference"]
    line["check"] = check
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative whole number")
    set_caches()
    from portbench.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), _T0)
    held = forbidden_modules()
    if held:
        print(f"portbench: the process holds {held} after the window", file=sys.stderr)
        return 2
    line["device"]["power_limit"] = _power_limit()
    for name, c in line["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
