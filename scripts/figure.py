#!/usr/bin/env python
"""Render a results grid (figure.dat) as a stacked-bar PNG.

Counterpart of the reference's gnuplot column-stacked histogram
(scripts/figure.plot): one bar per configuration, stacked by phase
(partition / build / probe), durations in ms.

Colors are the first three slots of the validated categorical palette from
the dataviz reference instance (adjacent-pair CVD ΔE >= 8, normal-vision
ΔE >= 15 in light mode): blue #2a78d6, orange #eb6834, aqua #1baf7a.
Phase identity is encoded by legend + fixed hue order; totals are
direct-labeled; grid/axes are recessive.

Usage: python scripts/figure.py results/h100/figure.dat out.png ["Title"]
"""

from __future__ import annotations

import sys


def main() -> int:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dat, out = sys.argv[1], sys.argv[2]
    title = sys.argv[3] if len(sys.argv) > 3 else "Join phase durations"

    with open(dat) as f:
        lines = [ln.split() for ln in f.read().strip().splitlines()]
    configs = lines[0][1:]
    phases = {row[0]: [float(v) for v in row[1:]] for row in lines[1:]}

    # fixed phase -> hue assignment (categorical slots 1-3, validated order)
    series = [
        ("partition", "#2a78d6"),
        ("build", "#eb6834"),
        ("probe", "#1baf7a"),
    ]

    fig, ax = plt.subplots(figsize=(1.6 + 1.1 * len(configs), 4.2), dpi=150)
    x = range(len(configs))
    bottom = [0.0] * len(configs)
    for name, color in series:
        vals = phases[name]
        ax.bar(
            x,
            vals,
            bottom=bottom,
            width=0.55,
            color=color,
            edgecolor="white",
            linewidth=2,  # 2px surface gap between stacked segments
            label=name,
        )
        bottom = [b + v for b, v in zip(bottom, vals)]

    for i, total in enumerate(bottom):  # selective direct labels: totals only
        ax.annotate(
            f"{total:,.0f}",
            (i, total),
            textcoords="offset points",
            xytext=(0, 4),
            ha="center",
            fontsize=9,
            color="#3a3a38",
        )

    ax.set_xticks(list(x), configs, rotation=30, ha="right", fontsize=9)
    ax.set_ylabel("Duration (ms)", fontsize=10, color="#3a3a38")
    ax.set_title(title, fontsize=11, color="#1a1a19")
    ax.spines[["top", "right"]].set_visible(False)
    ax.spines[["left", "bottom"]].set_color("#c3c2b7")
    ax.tick_params(colors="#3a3a38")
    ax.yaxis.grid(True, color="#e8e7df", linewidth=0.8)
    ax.set_axisbelow(True)
    ax.legend(frameon=False, fontsize=9, loc="upper left")
    fig.tight_layout()
    fig.savefig(out)
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
