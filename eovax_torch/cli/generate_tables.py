"""Benchmark/metric table generators (reference: generate_benchmark_table.py,
generate_combined_results.py, generate_table_sr.py).

A copy of ``eovax/cli/generate_tables.py`` (host code, no device). Consumes
the JSON result files it is given (a benchmark's timings, the SR eval's
metrics, per-modality tokenizer metrics) and renders text or LaTeX tables,
with speed/memory columns relative to a chosen baseline entry
(generate_benchmark_table.py:49-60).

Usage:
    python -m eovax_torch.cli.generate_tables results/*.json [--format latex] \
        [--baseline pixel]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def _cell(row: dict, c: str) -> str:
    """Missing cells render '-' in both width computation and output."""
    return "-" if row[c] is None else str(row[c])


def load_results(patterns: list[str]) -> list[dict]:
    results = []
    for pattern in patterns:
        for path in sorted(glob.glob(pattern)):
            with open(path) as f:
                data = json.load(f)
            data.setdefault("name", os.path.splitext(os.path.basename(path))[0])
            results.append(data)
    return results


def benchmark_table(results: list[dict], baseline: str | None = None,
                    fmt: str = "text") -> str:
    base = next((r for r in results if r.get("name") == baseline), None)

    rows = []
    for r in results:
        t = r.get("timing_ms", {})
        mem = (r.get("memory_gb") or {}).get("peak_memory")
        row = {
            "name": r.get("name", "?"),
            "encode": t.get("encode"),
            "sr": t.get("sr_forward"),
            "decode": t.get("decode"),
            "total": t.get("total"),
            "imgs/s": r.get("throughput_imgs_per_sec"),
            "mem GB": mem,
            "params M": round((r.get("parameters", {}).get("total") or 0) / 1e6, 1),
        }
        if base is not None and base.get("timing_ms", {}).get("total"):
            row["speedup"] = round(
                base["timing_ms"]["total"] / t["total"], 2
            ) if t.get("total") else None
            base_mem = (base.get("memory_gb") or {}).get("peak_memory")
            row["rel mem"] = (
                round(mem / base_mem, 2) if mem and base_mem else None
            )
        rows.append(row)

    cols = list(rows[0].keys())
    if fmt == "latex":
        lines = [
            "\\begin{tabular}{" + "l" + "r" * (len(cols) - 1) + "}",
            "\\toprule",
            " & ".join(cols) + " \\\\",
            "\\midrule",
        ]
        for row in rows:
            lines.append(
                " & ".join("-" if row[c] is None else str(row[c]) for c in cols)
                + " \\\\"
            )
        lines += ["\\bottomrule", "\\end{tabular}"]
        return "\n".join(lines)

    widths = {c: max(len(c), *(len(_cell(r, c)) for r in rows)) for c in cols}
    lines = ["  ".join(c.ljust(widths[c]) for c in cols)]
    lines.append("  ".join("-" * widths[c] for c in cols))
    for row in rows:
        lines.append("  ".join(_cell(row, c).ljust(widths[c]) for c in cols))
    return "\n".join(lines)


def sr_metrics_table(results: list[dict], fmt: str = "text") -> str:
    """RMSE/PSNR/SSIM/SAM table (generate_table_sr.py)."""
    cols = ["name", "rmse", "psnr", "ssim", "sam"]
    rows = [
        {c: (r.get(c) if c != "name" else r.get("name", "?")) for c in cols}
        for r in results
    ]
    if fmt == "latex":
        lines = ["\\begin{tabular}{lrrrr}", "\\toprule",
                 " & ".join(cols) + " \\\\", "\\midrule"]
        for row in rows:
            lines.append(" & ".join(str(row[c]) for c in cols) + " \\\\")
        lines += ["\\bottomrule", "\\end{tabular}"]
        return "\n".join(lines)
    widths = {c: max(len(c), *(len(str(r[c])) for r in rows)) for c in cols}
    lines = ["  ".join(c.ljust(widths[c]) for c in cols)]
    for row in rows:
        lines.append("  ".join(str(row[c]).ljust(widths[c]) for c in cols))
    return "\n".join(lines)


def combine_modality_results(results_dir: str, modalities: list[str] | None = None) -> dict:
    """Merge per-modality tokenizer metrics (``metrics_{MOD}.json``, each
    mapping model → metrics) into model → modality → metrics
    (generate_combined_results.py:6-40)."""
    modalities = modalities or ["S2L2A", "S2L1C", "S1RTC", "S2RGB"]
    per_mod: dict[str, dict] = {}
    for mod in modalities:
        path = os.path.join(results_dir, f"metrics_{mod}.json")
        if os.path.exists(path):
            with open(path) as f:
                per_mod[mod] = json.load(f)
        else:
            print(f"Warning: {path} not found, skipping {mod}")
    combined: dict[str, dict] = {}
    for mod, model_results in per_mod.items():
        for model, metrics in model_results.items():
            combined.setdefault(model, {})[mod] = metrics
    return {m: combined[m] for m in sorted(combined)}


def combined_table(combined: dict, fmt: str = "text") -> str:
    """Model × modality metric grid (generate_combined_results.py:42-249:
    one column group per modality, mse/mae cells)."""
    modalities = sorted({m for md in combined.values() for m in md})
    metric_keys: list[str] = []
    for md in combined.values():
        for metrics in md.values():
            for k in metrics:
                if k not in metric_keys:
                    metric_keys.append(k)
    cols = ["model"] + [f"{mod}:{k}" for mod in modalities for k in metric_keys]
    rows = []
    for model, md in combined.items():
        row = {"model": model}
        for mod in modalities:
            for k in metric_keys:
                v = (md.get(mod) or {}).get(k)
                row[f"{mod}:{k}"] = round(v, 5) if isinstance(v, float) else v
        rows.append(row)
    if fmt == "latex":
        lines = ["\\begin{tabular}{" + "l" + "r" * (len(cols) - 1) + "}",
                 "\\toprule", " & ".join(cols) + " \\\\", "\\midrule"]
        for row in rows:
            lines.append(
                " & ".join("-" if row[c] is None else str(row[c]) for c in cols)
                + " \\\\"
            )
        lines += ["\\bottomrule", "\\end{tabular}"]
        return "\n".join(lines)
    widths = {c: max(len(c), *(len(_cell(r, c)) for r in rows)) for c in cols}
    lines = ["  ".join(c.ljust(widths[c]) for c in cols)]
    lines.append("  ".join("-" * widths[c] for c in cols))
    for row in rows:
        lines.append("  ".join(_cell(row, c).ljust(widths[c]) for c in cols))
    return "\n".join(lines)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Render result tables")
    parser.add_argument("patterns", nargs="+",
                        help="result-json globs, or a results dir for --kind combined")
    parser.add_argument("--format", choices=["text", "latex"], default="text")
    parser.add_argument("--baseline", default=None)
    parser.add_argument("--kind", choices=["benchmark", "sr", "combined"],
                        default="benchmark")
    args = parser.parse_args(argv)

    if args.kind == "combined":
        results_dir = args.patterns[0]
        combined = combine_modality_results(results_dir)
        if not combined:
            raise SystemExit("No metrics_{MODALITY}.json files found")
        out = os.path.join(results_dir, "combined_results.json")
        with open(out, "w") as f:
            json.dump(combined, f, indent=4)
        print(combined_table(combined, args.format))
        print(f"\nWrote {out}")
        return

    results = load_results(args.patterns)
    if not results:
        raise SystemExit("No result files matched")
    if args.kind == "benchmark":
        print(benchmark_table(results, args.baseline, args.format))
    else:
        print(sr_metrics_table(results, args.format))


if __name__ == "__main__":
    main()
