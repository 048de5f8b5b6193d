"""CSV output in the reference's schemas, with the standard library only.

The reference writes its result tables with ``DataFrame.to_csv``: a
leading unnamed index column, then the named columns.  ``write_rows``
writes the same layout from a list of dicts.
"""

from __future__ import annotations

import csv


def write_rows(path: str, rows: list[dict]) -> None:
    """Write ``rows`` (dicts with the same keys, in column order) to
    ``path`` with a leading 0-based index column."""
    columns = list(rows[0]) if rows else []
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow([""] + columns)
        for i, row in enumerate(rows):
            w.writerow([i] + [row[c] for c in columns])
