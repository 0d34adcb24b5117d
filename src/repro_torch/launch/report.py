"""Render the dry-run's three tables from its jsonl records
(``python -m repro_torch.launch.report [report_dir]``): the dry-run
matrix, the roofline terms and the collective breakdown, as the
reference's report lays them out."""

from __future__ import annotations

import json
from pathlib import Path


def load(path):
    rows = {}
    if not Path(path).exists():
        return rows
    for line in open(path):
        r = json.loads(line)
        rows[(r["arch"], r["shape"])] = r  # last write wins
    return rows


def fmt_bytes(b):
    return f"{b/2**30:.2f}" if b else "-"


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 0.1:
        return f"{x:.3f}"
    if x >= 1e-4:
        return f"{x*1e3:.2f}m"
    return f"{x*1e6:.1f}u"


def render(report_dir="reports"):
    one = load(Path(report_dir) / "dryrun_1pod.jsonl")
    two = load(Path(report_dir) / "dryrun_2pod.jsonl")
    lines = []
    lines.append("### Dry-run matrix (status | args GiB/dev | temp GiB/dev; 1-pod 16x16 / 2-pod 2x16x16)\n")
    lines.append("| arch | shape | 1pod | 2pod | args/dev | temp/dev (1pod) |")
    lines.append("|---|---|---|---|---|---|")
    for key in sorted(one):
        a, s = key
        r1, r2 = one[key], two.get(key, {})
        st1, st2 = r1["status"], r2.get("status", "-")
        if st1 == "skipped":
            lines.append(f"| {a} | {s} | skip | skip | - | - ({r1['reason'][:40]}...) |")
            continue
        lines.append(
            f"| {a} | {s} | {st1} | {st2} | "
            f"{fmt_bytes(r1.get('argument_bytes'))} | {fmt_bytes(r1.get('bytes_per_device'))} |"
        )
    lines.append("")
    lines.append("### Roofline terms (single-pod 256 chips, per device; seconds)\n")
    lines.append("Analytic terms at H100 SXM constants (launch/analytic.py); the "
                 "last column is the dry-run's count of one device's collective "
                 "bytes (fake tensors, one rank).\n")
    lines.append("| arch | shape | compute | memory | collective | dominant | roofline frac (compute/bound) | coll bytes/dev |")
    lines.append("|---|---|---|---|---|---|---|---|")
    from repro_torch.launch.analytic import analytic_terms

    for key in sorted(one):
        r = one[key]
        if r["status"] != "ok":
            continue
        try:
            an = analytic_terms(key[0], key[1], 256)
        except Exception:
            continue
        t = an["terms"]
        hlo_coll = r["roofline"]["collective_bytes_total"]
        lines.append(
            f"| {key[0]} | {key[1]} | {fmt_s(t['compute_s'])} | {fmt_s(t['memory_s'])} | "
            f"{fmt_s(t['collective_s'])} | **{an['dominant']}** | "
            f"{an['roofline_fraction']:.2f} | {hlo_coll/2**20:.0f}M |"
        )
    lines.append("")
    lines.append("### Collective breakdown (1-pod, one device's result bytes by kind)\n")
    lines.append("| arch | shape | all-reduce | all-gather | reduce-scatter | all-to-all | permute |")
    lines.append("|---|---|---|---|---|---|---|")
    for key in sorted(one):
        r = one[key]
        if r["status"] != "ok":
            continue
        cb = r["roofline"]["collective_breakdown"]
        g = lambda k: f"{cb.get(k,0)/2**20:.0f}M" if cb.get(k) else "-"
        lines.append(
            f"| {key[0]} | {key[1]} | {g('all-reduce')} | {g('all-gather')} | "
            f"{g('reduce-scatter')} | {g('all-to-all')} | {g('collective-permute')} |"
        )
    return "\n".join(lines)


if __name__ == "__main__":
    import sys

    print(render(*sys.argv[1:2]))
