"""Shared report-rendering helpers for ragged row sets.

Sweep and advisor reports both emit "one flat record per point" csv, and
both can be *ragged*: a sweep point's ``U_*`` columns depend on its unit
set, and an advisor candidate's ``param_*`` columns depend on which
transforms it composes.  ``csv.DictWriter`` with fieldnames from the
first row raises ``ValueError`` on the first later-only column, so every
csv path must build its header as the union across ALL rows — this
module is that one rule, shared so the renderers can never drift apart.
"""

from __future__ import annotations

import csv
import io
from typing import Sequence


def union_fieldnames(rows: Sequence[dict]) -> list[str]:
    """Header union across ragged rows, in first-appearance order."""
    fieldnames: list[str] = []
    for row in rows:
        for k in row:
            if k not in fieldnames:
                fieldnames.append(k)
    return fieldnames


def rows_to_csv(rows: Sequence[dict]) -> str:
    """Render ragged dict rows as csv text (missing cells left empty).

    The union header means a row set where later rows introduce new
    columns (heterogeneous sweeps, advisor candidates with different
    transform parameters) round-trips through ``csv.DictReader`` with
    ``""`` in the holes instead of raising at write time.  Empty input
    renders as the empty string (no header to invent).
    """
    rows = list(rows)
    if not rows:
        return ""
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=union_fieldnames(rows), restval="")
    w.writeheader()
    w.writerows(rows)
    return buf.getvalue()
