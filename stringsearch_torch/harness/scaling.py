"""Scaling harness — sharded build throughput against shard count.

Counterpart of stringsearch_tpu/harness/scaling.py, for both distributed
build modes:

  * `--mode partitioned` — independent per-shard SAs (parallel/mesh.py),
    no communication: the embarrassingly parallel upper bound;
  * `--mode global` (default) — the exact global SA
    (parallel/global_sa.py), whose distributed sorts are where scaling is
    at risk.

Both time a fixed-size input at 1, 2, 4, ... shards, with throughput in
B/s and efficiency = (bps_k / bps_1) / k. `measure` takes a device list
that may repeat a device: `[cuda] * 8` gives the rows of one card, where
the k shards of a row run one after another on the same device. Such a
row measures correctness, launch counts and the cost of the layer on one
card; it is not a scaling result, and every table says so.

The comm model (parallel/comm_model.py) prints the exact bytes each shard
sends in the global build and its rounds. With `--link-gbps` it also
projects the wire time and the efficiency bound
compute / (compute + comm), compute being t(1 shard) / k; there is no
default rate.

    python -m stringsearch_torch.harness.scaling 16m --shards 8
    python -m stringsearch_torch.harness.scaling 1m --device cpu --shards 4
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from stringsearch_torch.utils.sizes import format_throughput, parse_size


def _sync(devices) -> None:
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def measure(size: int, reps: int = 3, devices=None,
            mode: str = "global") -> list:
    """Rows (k, seconds, bytes/s, comm report or None, distinct devices)
    for k = 1, 2, 4, ... up to len(devices) shards, each the best of
    `reps` builds after a warm-up one. `devices` defaults to every
    visible CUDA device; it may repeat a device."""
    from stringsearch_torch.harness.corpus import enwik_like
    from stringsearch_torch.parallel.global_sa import GlobalSuffixArray
    from stringsearch_torch.parallel.mesh import (
        _visible_cuda_devices,
        build_sharded,
        make_mesh,
    )

    devs = [torch.device(d) for d in devices] if devices is not None \
        else _visible_cuda_devices()
    text = enwik_like(size)
    last_report = {}

    def one_partitioned(mesh):
        build_sharded(text, mesh)
        _sync(mesh.part_devices)

    def one_global(mesh):
        g = GlobalSuffixArray(text, mesh)  # the build runs in the constructor
        _sync(mesh.part_devices)
        # keep only the plain-int report, not the shards' buffers
        last_report["report"] = g.comm_report()

    one = one_global if mode == "global" else one_partitioned
    rows = []
    k = 1
    while k <= len(devs):
        mesh = make_mesh(k, batch_axis=1, devices=devs)
        one(mesh)  # warm-up (builds the kernels on a fresh tree)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            one(mesh)
            times.append(time.perf_counter() - t0)
        dt = min(times)
        report = last_report.get("report") if mode == "global" else None
        rows.append((k, dt, size / dt, report,
                     len(set(mesh.part_devices))))
        k *= 2
    return rows


def main(argv=None) -> int:
    from stringsearch_torch.harness.cli import platform_devices, resolve_device

    ap = argparse.ArgumentParser(prog="stringsearch-torch-scaling")
    ap.add_argument("size", nargs="?", default="4m",
                    help="input size (k/m/g)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, choices=[None, "cpu", "cuda"],
                    help="default: cuda, and an error without a GPU")
    ap.add_argument("--shards", type=int, default=None,
                    help="largest shard count: the devices repeated round "
                         "robin (default: one shard per visible device)")
    ap.add_argument("--link-gbps", type=float, default=None,
                    help="per-device link rate in GB/s for the comm model's "
                         "projection; none is assumed")
    ap.add_argument("--mode", default="global",
                    choices=["global", "partitioned"],
                    help="global = exact global SA; partitioned = "
                         "independent per-shard SAs (upper bound)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device is None:
        return 2
    visible = platform_devices(device)
    shards = args.shards or len(visible)
    devices = [visible[i % len(visible)] for i in range(shards)]
    name = ("cpu" if device == "cpu" else
            torch.cuda.get_device_name(devices[0]))

    size = parse_size(args.size)
    rows = measure(size, args.reps, devices=devices, mode=args.mode)
    base = rows[0][2]
    print(f"mode: {args.mode}; device: {name}")
    print(f"{'Shards':>6}  {'Devices':>7}  {'Time':>9}  {'Throughput':>14}  "
          f"{'Efficiency':>10}")
    for k, dt, bps, _rep, ndev in rows:
        eff = bps / (base * k)
        shared = (f"  ({k} shards share {ndev} device"
                  f"{'s' if ndev > 1 else ''}: not a scaling result)"
                  if k > ndev else "")
        print(f"{k:>6}  {ndev:>7}  {dt:>8.3f}s  {format_throughput(bps):>14}"
              f"  {eff:>9.1%}{shared}")
    if args.mode == "global":
        t1 = rows[0][1]
        rate = args.link_gbps
        head = "\ncomm model (bytes each shard sends"
        print(head + (f"; projected at {rate:g} GB/s):" if rate else "):"))
        cols = f"{'Shards':>6}  {'Rounds':>6}  {'MB sent':>9}"
        if rate:
            cols += f"  {'Wire time':>9}  {'Proj. eff.':>10}"
        print(cols)
        for k, _dt, _bps, rep, _ndev in rows:
            if rep is None or k == 1:
                continue
            line = (f"{k:>6}  {rep.rounds:>6}  "
                    f"{rep.total_bytes / 1e6:>8.1f}M")
            if rate:
                comm = rep.projected_comm_seconds(rate)
                eff = rep.projected_efficiency(t1 / k, rate)
                line += f"  {comm:>8.4f}s  {eff:>9.1%}"
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
