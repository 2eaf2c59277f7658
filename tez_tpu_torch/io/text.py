"""Text root input: the stock line-record instance of the format SPI.

Reference parity: tez-mapreduce MRInput.java:87 (splits -> records) +
MRInputAMSplitGenerator.java:61 + TezSplitGrouper.java:43.  The generic
machinery (FileSplit, split computation/grouping, the format-driven input +
initializer) lives in tez_tpu_torch.io.formats; this module keeps the historical
``tez_tpu_torch.io.text:TextInput`` / ``TextSplitGenerator`` descriptor names as
thin text-format bindings (the format defaults to "text" when the payload
names none).

The port's copy of tez_tpu.io.text.
"""
from __future__ import annotations

from tez_tpu_torch.io.formats import (FileSplit, MRInput,  # noqa: F401 — re-
                                      MRSplitGenerator,    # exported names
                                      _LineReader, compute_splits,
                                      group_splits)


class TextSplitGenerator(MRSplitGenerator):
    """AM-side initializer: payload {"paths": [...], "desired_splits": N or
    -1 (use vertex parallelism or one wave of slots)}."""


class TextInput(MRInput):
    """Task-side root input: reads the splits delivered by the initializer
    (or directly from payload {"static_splits": [...]})."""
