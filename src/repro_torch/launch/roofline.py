"""Roofline analysis over dry-run results, with NVIDIA H100 constants.

Reads dryrun_results.json and prints, per (arch x shape x mesh):
  compute   = FLOPs_per_device / peak_FLOPs          (989 TF/s dense bf16)
  memory    = HBM_bytes_per_device / HBM_bw          (3.35 TB/s HBM3)
              [min, max]: max = every eager op's operand and output
              bytes, min = products and collectives only (the
              perfect-elementwise-fusion bound)
  collective= collective_bytes_per_device / link_bw  (50 GB/s per GPU:
              one 400 Gb/s NDR InfiniBand port; a 16-wide 'model' axis
              spans two 8-GPU NVLink nodes, so the slowest hop of its
              collectives is the network, and the data axes cross nodes
              too)
plus the dominant term, MODEL_FLOPS/counted FLOPs, and a one-line lever.

Usage: python -m repro_torch.launch.roofline [--json dryrun_results.json]
           [--mesh single|multi|both] [--md]
(--mesh both prints one markdown row per cell with both meshes' terms.)
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

PEAK_FLOPS = 989e12          # bf16 dense / GPU (NVIDIA H100 SXM data sheet)
HBM_BW = 3.35e12             # bytes/s / GPU, HBM3 (NVIDIA H100 SXM data sheet)
LINK_BW = 50e9               # bytes/s / GPU: 400 Gb/s NDR InfiniBand, one
                             # ConnectX-7 port per GPU (NVIDIA H100 SXM /
                             # DGX H100 data sheets)

CHIPS = {"single": 256, "multi": 512}


def terms(rec: dict) -> dict | None:
    a = rec.get("analysis")
    if not a or rec.get("status") != "ok":
        return None
    n_chips = CHIPS[rec["mesh"]]
    compute = a["flops"] / PEAK_FLOPS
    mem_max = a["hbm_bytes"] / HBM_BW
    mem_min = a["hbm_bytes_min"] / HBM_BW
    coll = a["collective_bytes"] / LINK_BW
    model_flops_dev = rec["model_flops"] / n_chips
    # dominant: use mem_min (optimistic) so "memory-bound" calls are robust
    dom = max(("compute", compute), ("memory", mem_min),
              ("collective", coll), key=lambda kv: kv[1])[0]
    useful = model_flops_dev / max(a["flops"], 1)
    # roofline fraction: useful work time / dominant bottleneck time
    ideal_t = model_flops_dev / PEAK_FLOPS
    bound_t = max(compute, mem_min, coll)
    return {
        "compute_s": compute, "mem_min_s": mem_min, "mem_max_s": mem_max,
        "coll_s": coll, "dominant": dom,
        "model_flops": rec["model_flops"],
        "useful_ratio": useful,
        "roofline_frac": ideal_t / max(bound_t, 1e-12),
        "peak_gib": (rec.get("memory", {}).get("peak_estimate_bytes") or 0)
        / 2 ** 30,
        "lower_s": rec.get("lower_s"), "compile_s": rec.get("compile_s"),
    }


LEVERS = {
    "compute": "cut redundant FLOPs (remat policy, causal-block skipping, "
               "MoE capacity factor)",
    "memory": "fuse/widen arithmetic intensity (bigger microbatch, fused "
              "attention blocks, bf16 stores)",
    "collective": "re-shard to cut resharding collectives (CP<->TP choice, "
                  "ZeRO-3 gather scheduling, bf16 grad reduce)",
}


def _md_cells(t) -> str:
    return (f" {t['compute_s']:.3f} | [{t['mem_min_s']:.3f},"
            f" {t['mem_max_s']:.3f}] | {t['coll_s']:.3f} | {t['dominant']}"
            f" | {t['useful_ratio']:.2f} | {t['roofline_frac']:.2f} |"
            f" {t['peak_gib']:.1f} |")


def _failed(rec) -> str:
    """A failed cell's reason, short enough for a table cell."""
    return ("FAILED: " + str(rec.get("error", "no record"))
            .splitlines()[0][:90].replace("|", "/"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="dryrun_results.json")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)
    results = json.loads(Path(args.json).read_text())

    if args.mesh == "both":          # one markdown row per cell, two meshes
        cells = sorted({(r.get("arch"), r.get("shape"))
                        for r in results.values()})
        cols = ("compute s | mem s [min,max] | coll s | dominant | MF/FLOPs"
                " | roofline frac | peak GiB")
        print(f"| arch | shape | single: {cols} | multi: {cols} |")
        print("|---" * 16 + "|")
        for arch, shape in cells:
            row = f"| {arch} | {shape} |"
            for mk in ("single", "multi"):
                rec = results.get(f"{arch}|{shape}|{mk}", {})
                t = terms(rec)
                row += _md_cells(t) if t else (" " + _failed(rec)
                                               + " |" * 7)
            print(row)
        return

    rows = []
    for key, rec in sorted(results.items()):
        if rec.get("mesh") != args.mesh:
            continue
        rows.append((rec.get("arch"), rec.get("shape"), terms(rec), rec))

    if args.md:
        print("| arch | shape | compute s | mem s [min,max] | coll s |"
              " dominant | MF/FLOPs | roofline frac | peak GiB |")
        print("|---|---|---|---|---|---|---|---|---|")
    else:
        print(f"{'arch':28s} {'shape':12s} {'compute':>9s} "
              f"{'mem[min,max]':>19s} {'coll':>8s} {'dom':>10s} "
              f"{'MF/FL':>7s} {'roof%':>6s} {'GiB/dev':>8s}")
    for arch, shape, t, rec in rows:
        if t is None:
            if args.md:
                print(f"| {arch} | {shape} | {_failed(rec)} |"
                      + " |" * 6)
            else:
                print(f"{arch:28s} {shape:12s}  {_failed(rec)}")
            continue
        if args.md:
            print(f"| {arch} | {shape} |" + _md_cells(t))
        else:
            print(f"{arch:28s} {shape:12s} {t['compute_s']:9.4f} "
                  f"[{t['mem_min_s']:8.4f},{t['mem_max_s']:8.4f}] "
                  f"{t['coll_s']:8.4f} {t['dominant']:>10s} "
                  f"{t['useful_ratio']:7.2f} {100*t['roofline_frac']:5.1f}% "
                  f"{t['peak_gib']:8.2f}")
    print()
    for dom, lever in LEVERS.items():
        print(f"lever[{dom}]: {lever}")


if __name__ == "__main__":
    main()
