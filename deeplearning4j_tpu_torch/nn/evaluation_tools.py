"""Evaluation chart rendering — the port of
``deeplearning4j_tpu/nn/evaluation_tools.py``, host numpy over the port's
``nn/evaluation.ROC``, ``ROCBinary`` and ``ROCMultiClass``.

(ref: deeplearning4j-core/.../evaluation/EvaluationTools.java —
exportRocChartsToHtmlFile: ROC + precision/recall charts via the
ui-components library; here self-contained SVG, zero assets.)  The HTML
is the JAX package's, character for character, for the same curves."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _svg_line_chart(series: Sequence[Tuple[str, np.ndarray, np.ndarray]],
                    title: str, w: int = 420, h: int = 340) -> str:
    colors = ["#E45756", "#4C78A8", "#54A24B", "#F58518", "#72B7B2",
              "#B279A2"]
    pad = 40
    parts = [f'<svg viewBox="0 0 {w} {h}" width="{w}" height="{h}" '
             'xmlns="http://www.w3.org/2000/svg">',
             f'<text x="{w / 2}" y="16" text-anchor="middle" '
             f'font-size="14">{title}</text>',
             f'<rect x="{pad}" y="{pad}" width="{w - 2 * pad}" '
             f'height="{h - 2 * pad}" fill="none" stroke="#999"/>']
    # unit axes (ROC space is [0,1]²)
    px = lambda x: pad + x * (w - 2 * pad)       # noqa: E731
    py = lambda y: h - pad - y * (h - 2 * pad)   # noqa: E731
    for t in (0.0, 0.25, 0.5, 0.75, 1.0):
        parts.append(f'<text x="{px(t):.0f}" y="{h - pad + 14}" '
                     f'font-size="9" text-anchor="middle">{t:g}</text>')
        parts.append(f'<text x="{pad - 6}" y="{py(t) + 3:.0f}" '
                     f'font-size="9" text-anchor="end">{t:g}</text>')
    parts.append(f'<line x1="{px(0)}" y1="{py(0)}" x2="{px(1)}" y2="{py(1)}" '
                 'stroke="#ccc" stroke-dasharray="4"/>')
    for i, (label, xs, ys) in enumerate(series):
        color = colors[i % len(colors)]
        d = " ".join(f"{'M' if j == 0 else 'L'}{px(float(x)):.1f},"
                     f"{py(float(y)):.1f}" for j, (x, y) in enumerate(zip(xs, ys)))
        parts.append(f'<path d="{d}" fill="none" stroke="{color}" '
                     'stroke-width="1.6"/>')
        parts.append(f'<text x="{w - pad - 4}" y="{pad + 14 + 13 * i}" '
                     f'font-size="10" text-anchor="end" fill="{color}">'
                     f'{label}</text>')
    parts.append("</svg>")
    return "".join(parts)


def roc_chart_html(roc, class_names: Optional[List[str]] = None) -> str:
    """ROC curve(s) → standalone HTML fragment.  Accepts ROC, ROCBinary,
    or ROCMultiClass (ref: EvaluationTools.rocChartToHtml overloads)."""
    series = []
    if hasattr(roc, "per_class"):        # ROCMultiClass
        for c, r in sorted(roc.per_class.items()):
            fpr, tpr, _ = r.roc_curve()
            name = class_names[c] if class_names else f"class {c}"
            series.append((f"{name} (AUC {r.auc():.3f})", fpr, tpr))
    elif hasattr(roc, "per_output"):     # ROCBinary
        for c, r in sorted(roc.per_output.items()):
            fpr, tpr, _ = r.roc_curve()
            name = class_names[c] if class_names else f"output {c}"
            series.append((f"{name} (AUC {r.auc():.3f})", fpr, tpr))
    else:                                # plain binary ROC
        fpr, tpr, _ = roc.roc_curve()
        series.append((f"AUC {roc.auc():.3f}", fpr, tpr))
    return _svg_line_chart(series, "ROC: TPR vs FPR")


def export_roc_charts_to_html_file(roc, path: str,
                                   class_names: Optional[List[str]] = None
                                   ) -> None:
    """(ref: EvaluationTools.exportRocChartsToHtmlFile)"""
    body = roc_chart_html(roc, class_names)
    with open(path, "w") as f:
        f.write("<!DOCTYPE html><html><head><meta charset=\"utf-8\">"
                "<title>ROC</title></head><body>" + body + "</body></html>")
