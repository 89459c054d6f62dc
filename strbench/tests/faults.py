"""Faults planted in the port underneath the timed path, to see the
harness's `correct` come out false: a step that returns its input
unchanged, half of the rows left out, the exchange between cards left
out, an answer altered where it is produced."""

from __future__ import annotations

import torch


def _half_rows(fn):
    """fn over the first half of the column's rows, the rest False."""
    from custrings_tpu_torch.ops import array

    def run(col, *a, **k):
        half = array.gather(col, torch.arange(col.size // 2, device=col.device))
        out = torch.zeros(col.size, dtype=torch.bool, device=col.device)
        out[: half.size] = fn(half, *a, **k)
        return out
    return run


def _flip_first(fn):
    def run(*a, **k):
        out = fn(*a, **k).clone()
        out[0] = ~out[0]
        return out
    return run


def plant(name: str):
    """Plant the named fault (or none for "none")."""
    from custrings_tpu_torch import category
    from custrings_tpu_torch.ops import modify, unique
    from custrings_tpu_torch.parallel import dist as pdist
    from custrings_tpu_torch.regex import ops as rops
    from custrings_tpu_torch.text import token

    if name == "none":
        return
    if name == "replace_unchanged":
        modify.replace_literal = lambda col, pat, repl, n=-1: col
    elif name == "filter_half":
        rops.contains_re = _half_rows(rops.contains_re)
    elif name == "filter_altered":
        rops.contains_re = _flip_first(rops.contains_re)
    elif name == "encode_altered":
        orig = category.from_strings

        def altered(*cols):
            cat = orig(*cols)
            values = cat.values.clone()
            values[-1] = (values[-1] + 1) % max(cat.keys_size, 2)
            return category.Category(cat.keys, values, cat.sorted_keys)
        category.from_strings = altered
    elif name == "tokenize_half":
        from custrings_tpu_torch.ops import array

        orig = token.tokenize

        def half(col, delimiter=None):
            return orig(array.gather(col, torch.arange(col.size // 2, device=col.device)), delimiter)
        token.tokenize = half
    elif name == "tokenize_altered":
        orig = token.tokenize

        def altered(col, delimiter=None):
            toks = orig(col, delimiter)
            toks.data[0] ^= 1
            return toks
        token.tokenize = altered
    elif name == "no_exchange":
        def local(col, group, S, me):
            keys, values = unique.dictionary_encode(col)
            return values, keys.size
        pdist._encode_merge = local
    elif name == "sharded_half":
        orig = pdist.distributed_categorize

        def half(data, offsets, validity, alive, mesh, axis="data"):
            alive = alive.clone()
            alive[alive.shape[0] // 2:] = False
            return orig(data, offsets, validity, alive, mesh, axis)
        pdist.distributed_categorize = half
    elif name == "sharded_altered":
        orig = pdist.distributed_categorize

        def altered(*a, **k):
            values, n = orig(*a, **k)
            values = values.clone()
            values[0] += 1
            return values, n
        pdist.distributed_categorize = altered
    else:
        raise ValueError(f"no fault {name!r}")
