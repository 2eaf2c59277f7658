"""Custom key ordering, comparator as normalizer: the port's copy of
tez_tpu.library.comparators.

Reference parity: tez-runtime-library pluggable raw comparators
(`tez.runtime.key.comparator.class`).  A compare(a, b) callback cannot
vectorize, so the SPI is the normalized-key form: a comparator maps each
key to bytes whose natural byte order is the desired order (ties broken
shorter first).  Keys with equal normalized forms fall into one group at
the consumer (comparator-equality grouping, like a case-insensitive
RawComparator).

The hash partitioner keeps using the original key bytes: comparators
change order, not placement (reference semantics; override the
partitioner too if comparator-equal keys must colocate).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

_REVERSE_TABLE = bytes(255 - i for i in range(256))


class KeyComparator:
    """SPI: define sort order by normalization (raw-comparator analog)."""

    def normalize(self, key: bytes) -> bytes:
        raise NotImplementedError


class CaseInsensitiveKeyComparator(KeyComparator):
    """ASCII case-insensitive ordering; 'Foo' and 'foo' form one group."""

    def normalize(self, key: bytes) -> bytes:
        return key.lower()


class ReverseByteKeyComparator(KeyComparator):
    """Descending byte order (complemented bytes); among keys where one is a
    prefix of the other the shorter still sorts first."""

    def normalize(self, key: bytes) -> bytes:
        return key.translate(_REVERSE_TABLE)


def load_comparator(ctx_or_get: Any) -> Optional[Callable[[bytes], bytes]]:
    """Resolve tez.runtime.key.comparator.class into a normalize callable
    (None when unset: the sort runs on raw key bytes)."""
    from tez_tpu_torch.library.util import conf_get
    name = conf_get(ctx_or_get, "tez.runtime.key.comparator.class", "")
    if not name:
        return None
    from tez_tpu_torch.common.payload import resolve_class
    return resolve_class(name)().normalize
