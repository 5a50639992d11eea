#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it starts on.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up (imports, the CUDA context, the
kernels, the cell's inputs and solvers, warm-up) runs first; then the
cell's loop runs for ``--seconds``; then the reference judges a sample
of the window's answers.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end standard error.

``--control screening`` runs the cell's control instead of the program
as configured: its solves at the program's low-fidelity screening
tolerances, certification off.  It has to come out not correct.
"""
import os
import sys
import time

# load from one process with few threads, and one hash order in every run:
# the process starts again once with these set before anything imports
STEADY = {"PYTHONHASHSEED": "0", "OMP_NUM_THREADS": "2",
          "MKL_NUM_THREADS": "2", "OPENBLAS_NUM_THREADS": "2"}
if __name__ == "__main__" and any(os.environ.get(k) != v
                                  for k, v in STEADY.items()):
    os.environ.setdefault("BENCHMARK_T_START", repr(time.time()))
    os.environ.update(STEADY)
    os.execv(sys.executable, [sys.executable] + sys.argv)
T_START = float(os.environ.pop("BENCHMARK_T_START", time.time()))

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


class Run:
    """What a driver needs of this run, and what it hands back."""

    def __init__(self, args, device, t_start, control=None):
        self.args, self.device, self.t_start = args, device, t_start
        self.trace, self.control = bool(args.trace), control
        self.data: dict = {}
        self.memory_peak = 0

    def start_window(self) -> dict:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.data.update(t_window=t, setup_s=time.time() - self.t_start)
        return self.data

    def close_window(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
            self.memory_peak = int(torch.cuda.max_memory_reserved(self.device))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("screening",), default=None)
    return ap.parse_args(argv)


def main(argv=None, device=None, root: Path = ROOT) -> int:
    """``device`` None: the first CUDA device, which must exist.  Tests
    pass the CPU to drive a run without a card."""
    from benchmark import core
    args = parse(argv)
    cache_env(root)
    cell = core.resolve(core.load_spec(root), args.workload, root)
    if device is None:
        import torch
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                  " visible", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    import torch
    torch.set_num_threads(int(STEADY["OMP_NUM_THREADS"]))
    device = torch.device(device)
    rec = Run(args, device, T_START, args.control)
    out = core.driver(cell.traffic["kind"]).run(cell, rec)
    found = core.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    data = out["data"]
    metrics = core.read_metrics(cell.per_layer if args.trace
                                else cell.end_to_end, data, root)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": rec.memory_peak}
    breakdown = None
    tr = data.get("trace")
    if args.trace and tr:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        breakdown = {"device_ops": tr["device_ops"],
                     "idle_gaps": tr["idle_gaps"]}
    checks = core.judge_limits(out["numbers"], cell.limits)
    correct = core.within(checks) and out["failed"] == 0
    print(json.dumps({"notes": out.get("notes", {}),
                      "device": dev}), file=sys.stderr)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(core.result_line(correct, out["attempted"], out["failed"], metrics,
                           dev, checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
