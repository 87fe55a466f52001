"""The card's published peaks (`peaks.json`)."""
from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "peaks.json")) as _f:
    PEAKS = json.load(_f)

BF16_FLOPS = float(PEAKS["bf16_flops_per_s"])
HBM_BYTES = float(PEAKS["hbm_bytes_per_s"])
