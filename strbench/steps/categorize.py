"""A dictionary encode: `category.from_strings`, the nvcategory core
(sorted unique keys and each row's key index); reports the key count."""

from __future__ import annotations

from custrings_tpu_torch import category

from . import host_column


def run(x, params):
    return category.from_strings(x)


def host(out):
    return host_column(out.keys), out.values.cpu().numpy()


def scalar(out):
    return out.keys_size
