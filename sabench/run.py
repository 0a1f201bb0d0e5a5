"""Run one cell of `BENCHMARK.json` once and print one JSON line.

    python -m sabench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in `setup_s`, from the start of the process): imports,
the kernel libraries the program launches (built with nvcc where the
checkout has no build yet, and timed on their own as `kernels_s` in the
result's `setup_parts`), the configuration's text made on the device from
the seed, and the mix's own set-up (warm-up builds). Then, with
`--trace 0`, units of the mix back to back for `--seconds` (the window),
read by the cell's end-to-end metrics; with `--trace 1`, one unit with
the host's waits counted and `trace_units` units under the profiler, read
by the cell's per-layer metrics. Once the window has closed and the peak
memory is read, the program's state is dropped and the plain reference
judges every output of the window. The result is the last line of
standard output; the numbers compared, each beside its limit, are the
last lines of standard error and the last key of the result.

Exits non-zero with no result where there is no CUDA card (or fewer than
the cell asks for), where the program cannot be imported, where BENCHMARK.json
or a file it names is missing, and where jax, jaxlib, flax or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from sabench import spec, trace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "stringsearch_tpu")


@dataclasses.dataclass
class Context:
    """What a mix's job gets: the inputs, the program and the device."""

    text: torch.Tensor
    config: dict
    traffic: dict
    seed: int
    program: object
    device: torch.device

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Window:
    """The timed window, as the end-to-end metrics read it."""

    kind: str
    units: list  # (start, end, work) on the host clock, in seconds
    start: float
    end: float
    peak_bytes: int
    setup_s: float

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def work(self) -> int:
        return sum(w for _, _, w in self.units)


def host_times() -> tuple[float, float]:
    """(this process's CPU seconds, the host's steal seconds so far), for
    the log: how much of a window the host ran us, and took from us."""
    steal = 0.0
    try:
        with open("/proc/stat") as f:
            steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    t = os.times()
    return t.user + t.system, steal


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules of jax, its kin or the JAX package, by top-level
    name compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} &
                  set(FORBIDDEN))


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak}


def _peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def timed_window(job, program, seconds: float, setup_s: float,
                 dev) -> Window:
    """Units back to back until `seconds` have passed."""
    units = []
    launches = program.sort_launches()
    cpu0, steal0 = host_times()
    t0 = time.perf_counter()
    while True:
        units.append(job.unit())
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    cpu1, steal1 = host_times()
    launches = program.sort_launches() - launches
    walls = sorted(b - a for a, b, _ in units)
    say(f"window: {len(units)} units in {t1 - t0:.3f} s; unit walls "
        f"min {walls[0]:.4f}, median {walls[len(walls) // 2]:.4f}, "
        f"max {walls[-1]:.4f} s; first five "
        f"{[round(b - a, 4) for a, b, _ in units[:5]]}; "
        f"{launches / len(units):.2f} sorts a unit; process CPU "
        f"{cpu1 - cpu0:.3f} s, host steal {steal1 - steal0:.3f} s")
    return Window(job.kind, units, t0, t1, _peak(dev), setup_s)


def traced_window(job, program, units: int, dev) -> trace.Trace:
    """One unit with the program's host waits counted, then `units` units
    under the profiler with the engine's calls logged."""
    if dev.type == "cuda":
        _, syncs = trace.count_syncs(job.unit)
    else:
        job.unit()
        syncs = []
    say(f"host waits of one unit: {len(syncs)} at {syncs}")
    with trace.CallLog() as log:
        launches = program.sort_launches()
        _, prof = trace.profiled(lambda: [job.unit() for _ in range(units)])
        launches = program.sort_launches() - launches
    return trace.read_profile(prof, kind=job.kind, units=units,
                              calls=log.calls, syncs=[len(syncs)],
                              sort_launches=launches)


def run_workload(workload: str, seed: int, seconds: float, trace_on: bool,
                 root: str = ROOT, device: str = "cuda", program=None,
                 config_overrides: dict | None = None,
                 traffic_overrides: dict | None = None,
                 start: float | None = None) -> dict:
    """One run of a cell; returns the result object. `program` defaults
    to stringsearch_torch (`sabench.program.Program`); the overrides
    change keys of the configuration or the mix (tests run cells at small
    sizes on the CPU with them)."""
    start = time.perf_counter() if start is None else start
    cell = spec.load_cell(root, workload)
    cell.config.update(config_overrides or {})
    cell.traffic.update(traffic_overrides or {})
    dev = torch.device(device)
    if program is None:
        from sabench.program import Program

        program = Program()
    t_kernels = time.perf_counter()
    if dev.type == "cuda":
        program.load_kernels()
    t_text = time.perf_counter()
    text = cell.generator.make(cell.config, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # the generator's blocks, for the program
    t_job = time.perf_counter()
    ctx = Context(text, cell.config, cell.traffic, seed, program, dev)
    job = cell.kind.Job(ctx)
    setup_peak = _peak(dev)
    t_end = time.perf_counter()
    setup_s = t_end - start
    parts = {"imports_s": t_kernels - start, "kernels_s": t_text - t_kernels,
             "text_s": t_job - t_text, "job_s": t_end - t_job}
    say(f"{workload}: set-up {setup_s:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"), text {text.numel()} B")
    _reset_peak(dev)

    result_metrics, breakdown, device_extra = {}, None, {}
    if not trace_on:
        window = timed_window(job, program, seconds, setup_s, dev)
        for m in cell.end_to_end:
            value = m.reader.read(window)
            if value is None:
                raise spec.SpecError(f"metric {m.name} has no reading in "
                                     f"{workload}")
            result_metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        tr = traced_window(job, program, int(cell.traffic["trace_units"]),
                           dev)
        for m in cell.per_layer:
            value = m.reader.read(tr)
            if value is not None:
                result_metrics[m.name] = {"value": value, "unit": m.unit}
        breakdown = tr.breakdown()
        device_extra = {"busy_s": tr.busy_us() * 1e-6,
                        "window_s": tr.window_us * 1e-6}
    peak = max(setup_peak, _peak(dev))

    job.release()
    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    attempted, failed, checks = job.judge()
    say(f"judged {attempted} outputs in {time.perf_counter() - t_judge:.3f} s")
    correct = (attempted > 0 and failed == 0
               and all(v <= lim for v, lim in checks.values()))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": result_metrics,
              "device": {**device_info(dev, peak), **device_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_parts"] = parts
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m sabench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        bench = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
        chips = {w["name"]: w.get("chips", 1)
                 for w in bench.get("workloads", [])}.get(args.workload)
        if chips is None:
            raise spec.SpecError(f"no workload {args.workload!r}")
        if not torch.cuda.is_available() or (
                torch.cuda.device_count() < chips):
            say(f"error: {args.workload} needs {chips} CUDA card(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                " visible")
            return 3
        import stringsearch_torch  # noqa: F401  (fails where it is absent)
        result = run_workload(args.workload, args.seed, args.seconds,
                              bool(args.trace), start=START)
    except (spec.SpecError, ImportError) as e:
        say(f"error: {e}")
        return 2
    bad = forbidden_modules()
    if bad:
        say(f"error: loaded in this process: {', '.join(bad)}")
        return 4
    for name, c in result["checks"].items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
