"""nvtext facade over the port's text ops.

Port of `custrings_tpu/nvtext.py` (the reference python/nvtext.py): the
same twelve functions with the same arguments and return shapes.  A
function given nvstrings works on their device; given Python strings it
puts them on the card ("cuda"), as `nvstrings.to_device` does.  `devptr`
may be a numpy array or a torch tensor, which is filled and returned.
"""

from __future__ import annotations

import numpy as np
import torch

from . import column as _col
from .nvstrings import nvstrings
from .text import distance as _dist
from .text import ngram as _ngram
from .text import token as _tok


def _device(strs):
    return strs._col.device if isinstance(strs, nvstrings) else "cuda"


def _c(strs, device):
    if isinstance(strs, nvstrings):
        return strs._col
    if isinstance(strs, str):
        # a bare string is a one-row column (replace_tokens takes a scalar
        # repl), not an iterable of chars
        strs = [strs]
    return _col.from_host_strings(strs, device)


def _out(res: torch.Tensor, devptr):
    """res as a (nested) list, or written into devptr and returned."""
    if isinstance(devptr, torch.Tensor):
        devptr.view(-1)[: res.numel()] = res.reshape(-1).to(devptr.device, devptr.dtype)
        return devptr
    out = res.cpu().numpy()
    if isinstance(devptr, np.ndarray):
        devptr.reshape(-1)[: out.size] = out.ravel()
        return devptr
    return out.tolist()


def tokenize(strs, delimiter=None):
    dev = _device(strs)
    if isinstance(delimiter, nvstrings):
        return nvstrings(_tok.tokenize_strings(_c(strs, dev), delimiter._col))
    return nvstrings(_tok.tokenize(_c(strs, dev), delimiter))


def unique_tokens(strs, delimiter=" "):
    return nvstrings(_tok.unique_tokens(_c(strs, _device(strs)), delimiter))


def token_count(strs, delimiter=" ", devptr=0):
    return _out(_tok.token_count(_c(strs, _device(strs)), delimiter), devptr)


def contains_strings(strs, tgts, devptr=0):
    dev = _device(strs)
    return _out(_tok.contains_strings(_c(strs, dev), _c(tgts, dev)), devptr)


def strings_counts(strs, tgts, devptr=0):
    dev = _device(strs)
    return _out(_tok.strings_counts(_c(strs, dev), _c(tgts, dev)), devptr)


def tokens_counts(strs, tgts, delimiter=" ", devptr=0):
    dev = _device(strs)
    return _out(_tok.tokens_counts(_c(strs, dev), _c(tgts, dev), delimiter), devptr)


def replace_tokens(strs, tgts, repls, delimiter=None):
    dev = _device(strs)
    return nvstrings(_tok.replace_tokens(_c(strs, dev), _c(tgts, dev), _c(repls, dev), delimiter))


def normalize_spaces(strs):
    return nvstrings(_tok.normalize_spaces(_c(strs, _device(strs))))


def edit_distance(strs, tgt, algo=0, devptr=0):
    """Levenshtein distance of each row to the string `tgt`, or to the
    same row of the strings `tgt` (`algo` is the reference's and unused)."""
    dev = _device(strs)
    if isinstance(tgt, str):
        out = _dist.edit_distance_scalar(_c(strs, dev), tgt)
    else:
        out = _dist.edit_distance_pairwise(_c(strs, dev), _c(tgt, dev))
    return _out(out, devptr)


def ngrams(tokens, N=2, sep="_"):
    return nvstrings(_ngram.create_ngrams(_c(tokens, _device(tokens)), N, sep))


def scatter_count(strs, counts):
    if isinstance(counts, (list, tuple)):
        counts = [0 if c is None else c for c in counts]  # None counts mean 0
    return nvstrings(_tok.scatter_count(_c(strs, _device(strs)), counts))


def porter_stemmer_measure(strs, vowels="aeiou", y_char="y", devptr=0):
    return _out(_dist.porter_stemmer_measure(_c(strs, _device(strs)), vowels, y_char), devptr)
