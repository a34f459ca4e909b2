"""Plot the DM-search S/N curve from a ``*dm_trials.jsonl`` record (port
of ``srtb_tpu/tools/plot_dm_curve.py``; ``srtb-torch-plot-dm-curve``).

Peak S/N per DM trial, per segment: the curve peaks at the pulse's
dispersion measure and falls off to the sides.  With matplotlib the plot
goes to ``OUT.png`` (default ``TRIALS.jsonl.png``), as the reference
draws it; without matplotlib each segment's curve is printed, one line a
trial with a bar proportional to its S/N.

Usage: srtb-torch-plot-dm-curve TRIALS.jsonl [OUT.png]
"""

from __future__ import annotations

import json
import sys

BAR_WIDTH = 40


def read_records(trials_path: str) -> list:
    records = []
    with open(trials_path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    if not records:
        raise SystemExit(f"no trial records in {trials_path}")
    return records


def curve_lines(records: list) -> list[str]:
    """The printed curve: per segment a heading with its best trial, then
    one line a trial."""
    lines = []
    for rec in records:
        lines.append(f"segment {rec['segment']}: best dm {rec['best_dm']} "
                     f"(S/N {rec['best_snr']:.1f})")
        top = max(max(rec["peak_snr"]), 1e-30)
        for dm, snr in zip(rec["dm_list"], rec["peak_snr"]):
            bar = "#" * max(0, round(BAR_WIDTH * snr / top))
            mark = " <- best" if dm == rec["best_dm"] else ""
            lines.append(f"  dm {dm:>10} S/N {snr:8.2f} {bar}{mark}")
    return lines


def plot(trials_path: str, out_path: str | None = None) -> str:
    """The reference's plot of the record to ``out_path`` (returned);
    raises ImportError without matplotlib."""
    records = read_records(trials_path)
    out_path = out_path or trials_path + ".png"

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 5.5))
    for rec in records:
        ax.plot(rec["dm_list"], rec["peak_snr"], marker="o",
                label=f"segment {rec['segment']}")
        ax.axvline(rec["best_dm"], color="0.7", lw=0.8, zorder=0)
    ax.set_xlabel("trial DM (pc cm$^{-3}$)")
    ax.set_ylabel("peak S/N")
    best = max(records, key=lambda r: r["best_snr"])
    ax.set_title(f"DM search: best {best['best_dm']} "
                 f"(S/N {best['best_snr']:.1f})")
    ax.legend(loc="best", fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    try:
        print(plot(argv[0], argv[1] if len(argv) > 1 else None))
    except ImportError:
        print("\n".join(curve_lines(read_records(argv[0]))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
