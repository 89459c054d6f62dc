"""Port parity: ingest, egress and the column helpers of custrings_tpu_torch
against custrings_tpu on the same host strings (CPU tensors)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from custrings_tpu import column as jcol
from custrings_tpu.ops import array as jarray
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch.ops import array as tarray

STRS = [
    "hello world",
    None,
    "",
    "🎉 four-byte emoji 🎉",
    "tschüß",
    "embedded\x00nul",
    "日本語のテキスト",
    None,
    "x" * 300,
    "",
]


def _same_column(t: tcol.StringColumn, j: jcol.StringColumn):
    """Offsets, validity and the bytes inside the offsets are equal."""
    offs = np.asarray(j.offsets)
    np.testing.assert_array_equal(t.offsets.numpy(), offs)
    np.testing.assert_array_equal(t.validity.numpy(), np.asarray(j.validity))
    total = int(offs[-1])
    np.testing.assert_array_equal(t.data.numpy()[:total], np.asarray(j.data)[:total])


@pytest.mark.parametrize(
    "strs", [STRS, [], [None], [""], ["a\x00"] * 3], ids=["mixed", "empty", "null", "blank", "nul"]
)
def test_ingest_egress_parity(strs):
    t = tcol.from_host_strings(strs, "cpu")
    j = jcol.from_host_strings(strs)
    _same_column(t, j)
    assert t.capacity == j.capacity
    assert tcol.to_host_strings(t) == jcol.to_host_strings(j) == list(strs)
    assert tcol.null_count(t) == jcol.null_count(j)
    assert tcol.null_count(t, True) == jcol.null_count(j, True)
    for a, b in zip(tcol.to_offsets_np(t), jcol.to_offsets_np(j)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_from_numpy_round_trips_a_jax_column():
    j = jcol.from_host_strings(STRS)
    t = tcol.from_numpy(np.asarray(j.data), np.asarray(j.offsets), np.asarray(j.validity), "cpu")
    _same_column(t, j)
    assert t.capacity == j.capacity
    assert tcol.to_host_strings(t) == STRS


def test_from_offsets_parity():
    data, offs, nbuf = jcol.to_offsets_np(jcol.from_host_strings(STRS))
    t = tcol.from_offsets_np(data, offs, len(STRS), nbuf, device="cpu")
    _same_column(t, jcol.from_offsets_np(data, offs, len(STRS), nbuf))


def test_cuda_device_is_never_silently_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the error path needs a CPU-only torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcol.from_host_strings(["a"], "cuda")


@pytest.mark.parametrize("n", [1, 5, 300])
def test_cumsum0_and_row_ids_parity(n):
    rng = np.random.default_rng(n)
    sizes = rng.integers(0, 9, n).astype(np.int32)
    np.testing.assert_array_equal(
        tcol.cumsum0(torch.from_numpy(sizes)).numpy(), np.asarray(jcol.cumsum0(jnp.asarray(sizes)))
    )
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    cap = int(offs[-1]) + 17
    np.testing.assert_array_equal(
        tcol.row_ids_from_offsets(torch.from_numpy(offs), cap).numpy(),
        np.asarray(jcol.row_ids_from_offsets(jnp.asarray(offs), cap)),
    )


def test_gather_parity():
    j = jcol.from_host_strings(STRS)
    t = tcol.from_host_strings(STRS, "cpu")
    idx = [9, 0, 3, 1, 3, -1, 6]
    _same_column(tarray.gather(t, idx), jarray.gather(j, idx))
    with pytest.raises(IndexError):
        tarray.gather(t, [len(STRS)])


def test_port_and_chip_smoke_import_no_jax():
    """The port and chip_smoke.py load neither JAX nor custrings_tpu."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (  # only modules this import loads count (a site hook may preload some)
        "import importlib, pkgutil, sys\n"
        "pre = set(sys.modules)\n"
        "import custrings_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'custrings_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "new = set(sys.modules) - pre\n"
        "bad = [k for k in new if k.split('.')[0] in ('jax', 'jaxlib', 'custrings_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr


def test_native_source_lies_inside_the_port():
    """The host helper builds from the port's own copy of fastcolumn.c,
    never from a file of the JAX package, and that copy still works."""
    import os

    from custrings_tpu_torch import native

    pkg = os.path.dirname(os.path.abspath(native.__file__))
    src = os.path.abspath(native.SRC)
    assert os.path.commonpath([src, pkg]) == pkg, src
    assert os.path.isfile(src)
    with open(src, "rb") as f, open(os.path.join(os.path.dirname(jcol.__file__), "native", "fastcolumn.c"), "rb") as g:
        assert b"PyInit_fastcolumn" in f.read() and b"PyInit_fastcolumn" in g.read()
    if native.load() is not None:
        assert native.load().unflatten(*native.load().flatten(["ab", None, ""])[:3], 3) == ["ab", None, ""]
