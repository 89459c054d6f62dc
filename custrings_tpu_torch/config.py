"""Capacity bucketing for byte buffers.

Port of `custrings_tpu/config.py` (`Config.bucket_bits`, `min_bucket`,
`bucket_bytes`; the JAX defaults, as constants).  Byte
buffers are padded to a geometric series of capacities, as in the JAX
package, so the two packages allocate the same column shapes and the
parity tests compare like with like.
"""

from __future__ import annotations

#: significand bits kept by the capacity series: 3 bits -> <= 12.5% padding
BUCKET_BITS = 3
#: minimum capacity of any byte buffer
MIN_BUCKET = 128


def bucket_bytes(n: int) -> int:
    """Round byte-count n up to a bucketed capacity (geometric series)."""
    n = int(n)
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    step = 1 << max((n - 1).bit_length() - BUCKET_BITS, 0)
    return -(-n // step) * step
