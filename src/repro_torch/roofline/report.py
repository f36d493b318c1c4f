"""The dry-run / roofline tables from JSON records (port of
``repro/roofline/report.py``): the same strings for the same records.

    PYTHONPATH=src python -m repro_torch.roofline.report --dryrun build/chip_smoke_roofline

A file holds a list of records. ``chip_smoke.py`` phase 20 writes one
record per program it measured on the card (``terms.card_record``, mesh
``h100x1``) under ``build/chip_smoke_roofline/``. The roofline table and the
bottleneck census read the records of that mesh; handed the reference's
``mesh="16x16"``, they print the reference's strings.
"""
from __future__ import annotations

import argparse
import glob
import json

from repro_torch.roofline.terms import MESH


def load_records(dryrun_dir: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(f"{dryrun_dir}/*.json")):
        recs.extend(json.load(open(path)))
    return recs


def _fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def roofline_table(recs: list[dict], mesh: str = MESH) -> str:
    """Roofline table of one mesh, one row per (arch, shape, plan)."""
    lines = [
        "| arch | shape | plan | compute s | memory s | collective s | dominant | useful | peak GiB/chip |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r.get("plan", ""))):
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | SKIP | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r.get('plan')} | FAIL | | | | | |")
            continue
        t = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['plan']} | {t['compute_s']:.2e} | "
            f"{t['memory_s']:.2e} | {t['collective_s']:.2e} | **{t['dominant']}** | "
            f"{t['useful_flops_ratio']:.2f} | {r['memory']['peak_per_chip_gib']} |"
        )
    return "\n".join(lines)


def dryrun_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | plan | mesh | compile s | args GiB | temp GiB | collective GiB (loop-corrected / flat) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"], r.get("plan", ""))):
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | {r['mesh']} | SKIP | | | {r['reason']} |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r.get('plan')} | {r['mesh']} | FAIL | | | {r['error'][:80]} |")
            continue
        m = r["memory"]
        c = r["collectives"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['plan']} | {r['mesh']} | {r['compile_s']} | "
            f"{_fmt_bytes(m['argument_bytes'])} | {_fmt_bytes(m['temp_bytes'])} | "
            f"{_fmt_bytes(c['total'])} / {_fmt_bytes(c.get('flat_total', 0))} |"
        )
    return "\n".join(lines)


def summarize_bottlenecks(recs: list[dict], mesh: str = MESH) -> str:
    ok = [r for r in recs if r["status"] == "ok" and r["mesh"] == mesh]
    by_dom: dict[str, int] = {}
    worst = []
    for r in ok:
        t = r["roofline"]
        by_dom[t["dominant"]] = by_dom.get(t["dominant"], 0) + 1
        dom_s = max(t["compute_s"], t["memory_s"], t["collective_s"])
        frac = t["compute_s"] / dom_s if dom_s else 0.0
        worst.append((frac, f"{r['arch']}/{r['shape']}/{r['plan']}", t["dominant"]))
    worst.sort()
    lines = [f"Dominant-term census (single pod): {by_dom}", "",
             "Worst roofline fraction (compute_s / dominant_s — lower = further from compute-bound):"]
    for frac, name, dom in worst[:8]:
        lines.append(f"  {frac:8.4f}  {name}  (bound by {dom})")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="build/chip_smoke_roofline")
    ap.add_argument("--what", default="all", choices=["all", "roofline", "dryrun", "summary"])
    args = ap.parse_args()
    recs = load_records(args.dryrun)
    if args.what in ("all", "summary"):
        print(summarize_bottlenecks(recs))
        print()
    if args.what in ("all", "roofline"):
        print(f"### Roofline (one card, {MESH})\n")
        print(roofline_table(recs))
        print()
    if args.what in ("all", "dryrun"):
        print("### Records\n")
        print(dryrun_table(recs))


if __name__ == "__main__":
    main()
