"""custrings_tpu_torch — the PyTorch + CUDA port of custrings_tpu.

Strings live as Arrow-style torch tensors (bytes + offsets + validity) on
one device.  Plain tensor work is PyTorch; every kernel the JAX package
wrote in Pallas for the TPU is a CUDA kernel written by hand for Hopper
(`csrc/*.cu`), built with nvcc at first use on a CUDA tensor.  CPU tensors
take each kernel's plain PyTorch version.  This package imports neither
JAX nor `custrings_tpu`.

Public modules:
    custrings_tpu_torch.nvstrings   vectorized string ops
    custrings_tpu_torch.nvcategory  string and numeric dictionary encoding
    custrings_tpu_torch.nvtext      token-level utilities
    custrings_tpu_torch.utils       CSV ingest, column statistics, spans

Spans (`utils.tracing`): every public op of the op modules (wrapped at
import, below), the steps inside the regex filter, the tokenizer and the
encode, each hand-written kernel's launch (`kernel.<name>`), the
collectives of `parallel` and the ingest open a named span.  Spans are on
while `tracing.enabled()` is active or the torch profiler runs; off, a
span site costs two flag reads.  They never synchronize the device: their
own times are host times, and device time per span comes from the
profiler's device events inside each span's interval.
"""

from .column import StringColumn  # noqa: F401

__version__ = "0.1.0"


def _instrument():
    """Wrap the public ops of the op modules with utils.tracing.traced, as
    custrings_tpu does, so that each op is a span."""
    import importlib

    from .utils import tracing

    for modname, prefix in [
        ("ops.array", "array"),
        ("ops.attrs", "attrs"),
        ("ops.case", "case"),
        ("ops.combine", "combine"),
        ("ops.convert", "convert"),
        ("ops.datetime_k", "datetime"),
        ("ops.find", "find"),
        ("ops.modify", "modify"),
        ("ops.pad", "pad"),
        ("ops.split", "split"),
        ("ops.strip", "strip"),
        ("ops.substr", "substr"),
        ("ops.unique", "unique"),
        ("ops.urlencode", "urlencode"),
        ("regex.ops", "regex"),
        ("text.token", "text"),
        ("text.distance", "text"),
        ("text.ngram", "text"),
    ]:
        mod = importlib.import_module(f".{modname}", __name__)
        tracing.instrument_module(mod, prefix)


_instrument()
