"""The benchmark of custrings_tpu_torch: `python3 strbench/run.py --help`."""
