"""Campaign persistence: JSON round-tripping of
:class:`~polar_tpu_torch.ber.CampaignResult`, in the same format as
``polar_tpu.campaign_io`` (either package loads the other's files) and
with an atomic rewrite for checkpoint/resume, and the waterfall plot.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from pathlib import Path

from .ber import CampaignResult, SnrPoint


def result_to_dict(result: CampaignResult) -> dict:
    return {
        "code_n": result.code_n,
        "code_k": result.code_k,
        "systematic": result.systematic,
        "seed": result.seed,
        "qef_snr_db": None if math.isinf(result.qef_snr_db) else result.qef_snr_db,
        "peak_mbps": result.peak_mbps,
        "points": [dataclasses.asdict(p) for p in result.points],
    }


def result_from_dict(d: dict) -> CampaignResult:
    r = CampaignResult(
        code_n=d["code_n"], code_k=d["code_k"], systematic=d["systematic"],
        qef_snr_db=math.inf if d.get("qef_snr_db") is None else d["qef_snr_db"],
        peak_mbps=d.get("peak_mbps", 0.0),
        seed=d.get("seed"),
    )
    r.points = [SnrPoint(**p) for p in d.get("points", [])]
    return r


def save_result(result: CampaignResult, path) -> None:
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(result_to_dict(result), indent=1))
    os.replace(tmp, path)


def load_result(path) -> CampaignResult | None:
    path = Path(path)
    if not path.exists():
        return None
    return result_from_dict(json.loads(path.read_text()))


def plot_waterfall(results, path, *, x_axis: str = "ebn0_db",
                   title: str | None = None) -> None:
    """Render a BER waterfall plot (the reference's ``ber_log.png``,
    ``polar_tpu/campaign_io.py:64``); matplotlib is imported here only.

    ``results``: iterable of CampaignResult (one curve each).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    for r in results:
        xs = [getattr(p, x_axis) for p in r.points if p.ber > 0]
        ys = [p.ber for p in r.points if p.ber > 0]
        label = f"Polar({r.code_n},{r.code_k}){' sys' if r.systematic else ''}"
        ax.semilogy(xs, ys, marker="o", markersize=3, linewidth=1, label=label)
    ax.set_xlabel("Eb/N0 (dB)" if x_axis == "ebn0_db" else "Es/N0 (dB)")
    ax.set_ylabel("bit error rate")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
