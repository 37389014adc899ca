"""The arithmetic of the metrics: tails, rates, roofline shares and the
spread that sets a bound."""

from __future__ import annotations

import json
import statistics
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parent


def p95(values: Sequence[float]) -> Optional[float]:
    """The 95th percentile of every value (numpy's linear interpolation),
    None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def rate(amounts: Iterable[float], window_s: float) -> Optional[float]:
    """Sum of ``amounts`` over the whole window's seconds."""
    if window_s <= 0:
        return None
    return float(sum(amounts)) / window_s


def peaks() -> dict:
    """The card's published peaks (``peaks.json``)."""
    return json.loads((ROOT / "peaks.json").read_text())


def kernel_table(name: str) -> dict:
    """``kernels/<name>.json``: the kernel's name pattern and its frozen
    byte and operation counts per shape."""
    return json.loads((ROOT / "kernels" / f"{name}.json").read_text())


def bound_s(shape: dict, peak: dict) -> float:
    """The least time a shape could take: the larger of its bytes over the
    memory bandwidth and its f32 operations over the f32 peak."""
    return max(shape["bytes"] / peak["hbm_bytes_per_s"],
               shape["ops"] / peak["f32_ops_per_s"])


def roofline_pct(launches: Dict[str, int], table: dict, kernel_s: float,
                 peak: dict) -> Optional[float]:
    """Share (%) of the bound that the launched shapes' kernels reached:
    the sum of each launch's bound over the kernels' measured time.
    None where nothing was launched or timed."""
    if not launches or kernel_s <= 0:
        return None
    need = sum(n * bound_s(table["shapes"][key], peak)
               for key, n in launches.items())
    return 100.0 * need / kernel_s


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def kernel_roofline(kernel: str, rec: dict) -> Optional[float]:
    """``<kernel>_roofline`` of a traced run: the kernel's launches in the
    traced window (``rec["launches"][kernel]``, by shape) against its
    device time in the trace (kernels whose name matches the table's
    ``match``).  None where the kernel did not run there, or where the
    trace counts other launches than the run made (the match is wrong)."""
    from wam_bench.trace import kernel_seconds

    launches = rec.get("launches", {}).get(kernel)
    trace = rec.get("trace")
    if not launches or not trace:
        return None
    table = kernel_table(kernel)
    n, secs = kernel_seconds(trace, table["match"])
    if n != sum(launches.values()):
        return None
    return roofline_pct(launches, table, secs, peaks())
