"""Run one cell of ``BENCHMARK.json`` once.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); the mix's ``driver`` names the module
``drivers/<driver>.py`` that sets the program up, drives the measured
window and compares what it produced with what was sent.  Each metric
other than ``setup_s`` is a reader ``metrics/<name>.py`` over the run's
records.  Nothing here names a cell, a mix or a metric, so a later
change adds them as files and entries.

Order of a run: set-up (inputs made on the device from the seed, the
program built and warmed on the cell's shapes), the window, the check
that no JAX module was loaded, the answers still due, the peak device
memory, the program's state freed, the comparison, the metrics.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "webaudio_modem_tpu"})


class RunError(RuntimeError):
    """A run that prints no result: the caller exits non-zero."""


def set_cache_dirs(checkout: Path = CHECKOUT) -> None:
    """Fixed build and kernel cache directories inside the checkout (the
    program's nvcc outputs already go to ``build/kernels`` there)."""
    os.environ["TRITON_CACHE_DIR"] = str(checkout / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(checkout / "build"
                                             / "torch_extensions")


def load_spec(root: Path = CHECKOUT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise RunError(f"no {kind} file {path.relative_to(CHECKOUT)}")
    return json.loads(path.read_text())


def find_cell(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise RunError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced.  A metric without ``workloads`` belongs to
    every cell (per-layer: every cell that reports what it moves)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def load_reader(name: str):
    """``metrics/<name>.py`` as a module with ``read(rec)``."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no reader {path.relative_to(CHECKOUT)}")
    mod_name = "wam_bench.metrics." + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    if not (ROOT / "drivers" / f"{name}.py").is_file():
        raise RunError(f"no driver wam_bench/drivers/{name}.py")
    return importlib.import_module(f"wam_bench.drivers.{name}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def check_device(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is False: this cell "
                       "runs on the card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, "
                       f"torch.cuda.device_count() is "
                       f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t0: float, device=None, overrides: Optional[dict] = None,
             fault: Optional[str] = None, control: Optional[str] = None,
             spec: Optional[dict] = None) -> dict:
    """One run; returns the result object.  ``device`` None: the card
    (refused without one).  ``overrides`` ({"config": {...}, "mix":
    {...}}), ``fault`` and ``control`` serve the tests and the control
    runs."""
    import torch

    from wam_bench.trace import NoTracer, Tracer

    spec = spec or load_spec()
    cell = find_cell(spec, workload)
    config = load_json("configs", cell["config"])
    mix = load_json("traffic", cell["traffic"])
    for part, d in (overrides or {}).items():
        {"config": config, "mix": mix}[part].update(d)
    on_card = device is None
    device = (check_device(int(cell["chips"])) if on_card
              else torch.device(device))
    tracer = (Tracer(CHECKOUT / "build" / "wam_bench" / "trace.json")
              if trace and on_card else NoTracer())
    drv = load_driver(mix["driver"]).Driver(
        cell=workload, config=config, mix=mix, seed=seed,
        device=device, tracer=tracer, fault=fault,
        control=control)
    drv.setup()
    setup_s = time.perf_counter() - t0
    drv.window(float(seconds))
    tracer.stop()
    bad = forbidden_modules()
    if bad:
        raise RunError("JAX or the JAX package is loaded: "
                       + ", ".join(bad))
    drv.finish()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    drv.release()
    checks = drv.check()
    rec = drv.rec
    rec["trace"] = tracer.result
    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = load_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else device.type),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks),
              "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]),
              "metrics": metrics, "device": dev}
    if tracer.result is not None:
        kernels = sorted(tracer.result["kernels"].items(),
                         key=lambda kv: -kv[1][1])
        for name, (n, secs) in kernels[:12]:
            print(f"traced kernel: {n} x {secs:.6f} s {name}",
                  file=sys.stderr)
        dev["busy_s"] = tracer.result["busy_s"]
        dev["window_s"] = tracer.result["window_s"]
        result["breakdown"] = {"device_ops": tracer.result["device_ops"],
                               "idle_gaps": tracer.result["idle_gaps"]}
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}
    return result


def main(argv=None, t0: Optional[float] = None) -> int:
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(prog="python -m wam_bench.run",
                                description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None,
                   help="run the cell's control in the program's place "
                        "(its driver's CONTROLS); its result reads "
                        "correct false")
    p.add_argument("--fault", default=None,
                   help="plant one of the driver's FAULTS in the timed path")
    args = p.parse_args(argv)
    set_cache_dirs()
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t0=t0, fault=args.fault,
                          control=args.control)
    except RunError as exc:
        print(f"wam_bench: {exc}", file=sys.stderr)
        return 2
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
