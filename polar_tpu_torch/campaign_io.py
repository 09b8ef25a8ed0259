"""Campaign persistence: JSON round-tripping of
:class:`~polar_tpu_torch.ber.CampaignResult`, in the same format as
``polar_tpu.campaign_io`` (either package loads the other's files) and
with an atomic rewrite for checkpoint/resume.
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
