"""Column statistics, behind `nvstrings.get_info`.

Port of `custrings_tpu/utils/stats.py` (NVStrings::compute_statistics,
NVStrings.cu:631, StringsStatistics.h:20-40): totals, average, largest,
smallest and 95th-percentile byte lengths, memory, the count of unique
rows, the whitespace, digit, alpha, upper- and lower-case char counts and
the char histogram.  The chars come from the column's char index
(`layout.char_map` / `codepoints`: K3, and K4c for a non-ASCII column),
their classes from the port's flag table, the unique rows from
`unique.unique_strings` (K1b); the char counts and the histogram are
reduced on the device and only the per-row lengths reach the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..column import StringColumn
from ..ops import layout
from ..ops.unique import unique_strings
from ..unicode.tables import FLAG_ALPHA, FLAG_DIGIT, FLAG_LOWER, FLAG_SPACE, FLAG_UPPER, device_tables


def compute_statistics(col: StringColumn) -> dict:
    lens = col.lengths().cpu().numpy()
    valid = col.validity.cpu().numpy()
    nch = layout.char_counts(col).cpu().numpy()
    total_chars = int(layout.char_map(col).cs0[-1])
    cps = layout.codepoints(col)[:total_chars].to(torch.int64)
    flags, _ = device_tables(col.device)
    f = flags[cps.clamp(0, flags.shape[0] - 1)]
    counts = {name: int(((f & bit) > 0).sum()) for name, bit in (
        ("whitespace_count", FLAG_SPACE), ("digits_count", FLAG_DIGIT), ("alpha_count", FLAG_ALPHA),
        ("uppercase_count", FLAG_UPPER), ("lowercase_count", FLAG_LOWER))}
    hist_vals, hist_counts = torch.unique(cps, return_counts=True)
    vl = lens[valid]
    return {
        "total_strings": int(col.size),
        "null_strings": int((~valid).sum()),
        "empty_strings": int(((lens == 0) & valid).sum()),
        "unique_strings": int(unique_strings(col).size),
        "total_bytes": int(vl.sum()),
        "total_chars": int(nch[valid].sum()),
        "avg_bytes": float(vl.mean()) if len(vl) else 0.0,
        "max_bytes": int(vl.max()) if len(vl) else 0,
        "min_bytes": int(vl.min()) if len(vl) else 0,
        "pct95_bytes": float(np.percentile(vl, 95)) if len(vl) else 0.0,
        "device_memory": col.memsize(),
        **counts,
        "char_histogram": dict(zip(hist_vals.cpu().tolist(), hist_counts.cpu().tolist())),
    }
