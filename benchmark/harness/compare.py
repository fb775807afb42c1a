"""The numbers that decide `correct`, each a gap between the program's
reading and the reference's, and the verdict against the cell's limits."""
from __future__ import annotations

import statistics
import sys
from typing import Dict, Iterable, List, Optional, Tuple

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared
STILL_LEAF_SHARE = 1e-3


def relative_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float], keep: Optional[Iterable[str]] = None
                   ) -> Tuple[float, str]:
    """max over leaves of |got - want| / max(want, the median leaf's want),
    and the leaf that gives it."""
    names = list(keep if keep is not None else want)
    med = statistics.median(want[k] for k in names)
    gaps = [(abs(got[k] - want[k]) / max(want[k], med, 1e-30), k) for k in names]
    return max(gaps)


def median_leaf_gap(got: Dict[str, float], want: Dict[str, float], keep: Optional[Iterable[str]] = None
                    ) -> float:
    """The median over leaves of |got - want| / max(want, the median leaf's
    want): steady from seed to seed where the worst leaf is not."""
    names = list(keep if keep is not None else want)
    med = statistics.median(want[k] for k in names)
    return statistics.median(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in names)


def moving_leaves(ref_first_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_first_grad.values())
    return [k for k, g in ref_first_grad.items() if g >= STILL_LEAF_SHARE * med]


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(all readings within their limits, {name: {value, limit}}); a
    reading that is missing or not finite fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name, float("nan"))
        table[name] = {"value": v, "limit": limit}
        ok = ok and (v == v) and v <= limit
    return ok, table


def print_table(table: Dict[str, Dict[str, float]]) -> None:
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
