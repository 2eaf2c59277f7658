"""User code of the MapReduce examples: map, reduce and format classes that
``io/mapreduce.py`` jobs name as "module:callable" strings.

They live in a module of the package so that runner processes (which import
a job's functions by name) can import them without a test's imports.

- WordCount: ``wc_map_long`` (a VarLong 1 per word) with ``wc_reduce`` (the
  total as text); ``count_pass_reduce``, ``fold_first_letter_reduce`` and
  ``total_reduce`` chain three reduce stages (map -> word totals -> first
  letters -> letter totals); ``ident_map`` is a map-only job's mapper.
- Fixed-width records: ``fixed_map`` / ``fixed_reduce`` sum an 8-byte
  big-endian count by the key's first two bytes.
- TeraSort: ``identity_map`` and ``identity_reduce`` over
  ``TeraInputFormat``, fixed-width records of a 10-byte key and a 90-byte
  value (the record of Hadoop's TeraGen / TeraSort examples), so a job conf
  that names the format as ``mapreduce.job.inputformat.class`` needs no
  format parameters.

Run one with ``io.mapreduce.simple_mr_dag`` (or ``mr_job_to_dag``) through
``TezClient(device=...)``, e.g.::

    dag = simple_mr_dag("terasort", [path], out,
                        map_fn="tez_tpu_torch.examples.mr_jobs:identity_map",
                        reduce_fn="tez_tpu_torch.examples.mr_jobs:"
                                  "identity_reduce",
                        num_mappers=4, num_reducers=4, input_format="fixed",
                        format_params={"key_bytes": 10, "value_bytes": 90})
"""
from __future__ import annotations

import struct
from typing import Any, Iterable, Iterator, Tuple

from tez_tpu_torch.io.formats import FixedWidthKVFormat
from tez_tpu_torch.ops.serde import VarLongSerde

#: TeraGen / TeraSort's record: a 10-byte key and a 90-byte value
TERA_KEY_BYTES = 10
TERA_VALUE_BYTES = 90

_LONG = VarLongSerde()
_ONE = _LONG.to_bytes(1)


def wc_map_long(offset: Any, line: bytes) -> Iterator[Tuple[bytes, bytes]]:
    for word in line.split():
        yield word, _ONE


def wc_reduce(word: bytes, values: Iterable[bytes]
              ) -> Iterator[Tuple[bytes, bytes]]:
    yield word, str(sum(_LONG.from_bytes(v) for v in values)).encode()


def count_pass_reduce(word: bytes, values: Iterable[bytes]
                      ) -> Iterator[Tuple[bytes, bytes]]:
    """(word, ones...) -> (word, total), still VarLong for the next stage."""
    yield word, _LONG.to_bytes(sum(_LONG.from_bytes(v) for v in values))


def fold_first_letter_reduce(word: bytes, values: Iterable[bytes]
                             ) -> Iterator[Tuple[bytes, bytes]]:
    yield word[:1], _LONG.to_bytes(sum(_LONG.from_bytes(v) for v in values))


def total_reduce(letter: bytes, values: Iterable[bytes]
                 ) -> Iterator[Tuple[bytes, bytes]]:
    yield letter, str(sum(_LONG.from_bytes(v) for v in values)).encode()


def ident_map(offset: Any, line: bytes) -> Iterator[Tuple[bytes, bytes]]:
    for word in line.split():
        yield word, b"1"


def fixed_map(key: bytes, value: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """key: an 8-byte id, value: an 8-byte big-endian count."""
    (count,) = struct.unpack(">q", value)
    yield key[:2], str(count).encode()


def fixed_reduce(bucket: bytes, values: Iterable[bytes]
                 ) -> Iterator[Tuple[bytes, bytes]]:
    yield bucket, str(sum(int(v) for v in values)).encode()


def identity_map(key: Any, value: Any) -> Iterator[Tuple[Any, Any]]:
    yield key, value


def identity_reduce(key: Any, values: Iterable[Any]
                    ) -> Iterator[Tuple[Any, Any]]:
    for value in values:
        yield key, value


class TeraInputFormat(FixedWidthKVFormat):
    """FixedWidthKVFormat at TeraSort's record unless the job's format
    parameters name other widths."""

    def __init__(self, params=None):
        super().__init__(dict({"key_bytes": TERA_KEY_BYTES,
                               "value_bytes": TERA_VALUE_BYTES},
                              **(params or {})))
