"""KeyValueDB — the ordered-KV interface (ref: src/kv/KeyValueDB.h).

The reference mediates every BlueStore metadata access through this
surface so the backing engine (RocksDB over BlueFS) is swappable; the
same shape is kept here so TinStore programs TinDB through an
interface, not an implementation:

* PREFIXED KEY SPACES. Every key lives under a short string prefix
  (the rocksdb column-family-by-convention trick: the stored key is
  `prefix + NUL + key`). Prefixes must not contain NUL; keys are raw
  bytes and may.  Because NUL sorts before every other byte, all keys
  of one prefix are contiguous in the total order.
* TRANSACTION BATCHES. Mutations accumulate in a `KVTransaction` and
  apply atomically at `submit_transaction` — wholly applied or wholly
  absent after a crash, exactly the WriteBatch contract BlueStore's
  _kv_sync_thread relies on.
* ORDERED ITERATORS. `iterate(prefix, start, end)` yields (key,
  value) in ascending key order, bounded to the prefix (and
  optionally to [start, end) inside it) — the get_iterator/
  lower_bound/upper_bound machinery collapsed into one generator
  shape, which is what every listing/omap scan in this codebase
  actually does with it.
* SNAPSHOTS. `snapshot()` returns a frozen point-in-time read view
  (get + iterate) that later writes and compactions cannot disturb.
"""

from __future__ import annotations

from collections.abc import Iterator


def combine_key(prefix: str, key: bytes) -> bytes:
    """`prefix + NUL + key` (the KeyValueDB combine convention)."""
    p = prefix.encode("utf-8")
    if b"\x00" in p:
        raise ValueError(f"prefix {prefix!r} contains NUL")
    return p + b"\x00" + bytes(key)


def split_key(full: bytes) -> tuple[str, bytes]:
    """Inverse of combine_key (split at the FIRST NUL)."""
    p, _, k = full.partition(b"\x00")
    return p.decode("utf-8"), k


def _successor(b: bytes) -> bytes:
    """Smallest byte string greater than every string prefixed by `b`
    (strip trailing 0xff, bump the last byte — the standard exclusive
    upper bound for a prefix scan). All-0xff has no successor; that
    degenerate bound is represented as b"" and treated as +inf by
    callers (no real prefix here is all-0xff)."""
    b = b.rstrip(b"\xff")
    if not b:
        return b""
    return b[:-1] + bytes([b[-1] + 1])


def prefix_range(prefix: str, key_prefix: bytes = b"") -> tuple[bytes, bytes]:
    """[lo, hi) full-key bounds covering every key of `prefix` that
    starts with `key_prefix`."""
    lo = combine_key(prefix, key_prefix)
    return lo, _successor(lo)


class KVTransaction:
    """Ordered mutation batch (the KeyValueDB::Transaction role).
    Ops apply in insertion order at submit; range deletes cover the
    state visible at their position in the batch."""

    __slots__ = ("ops",)

    def __init__(self):
        self.ops: list[tuple] = []

    def set(self, prefix: str, key: bytes, value: bytes) -> "KVTransaction":
        self.ops.append(("set", combine_key(prefix, key), bytes(value)))
        return self

    def rmkey(self, prefix: str, key: bytes) -> "KVTransaction":
        self.ops.append(("rm", combine_key(prefix, key)))
        return self

    def rm_range_keys(self, prefix: str, start: bytes,
                      end: bytes) -> "KVTransaction":
        """Delete every key of `prefix` in [start, end) (ref:
        KeyValueDB::Transaction::rm_range_keys)."""
        self.ops.append(("rm_range", combine_key(prefix, start),
                         combine_key(prefix, end)))
        return self

    def rmkeys_by_prefix(self, prefix: str,
                         key_prefix: bytes = b"") -> "KVTransaction":
        """Delete every key of `prefix` starting with `key_prefix`
        (ref: KeyValueDB::Transaction::rmkeys_by_prefix)."""
        lo, hi = prefix_range(prefix, key_prefix)
        self.ops.append(("rm_range", lo, hi))
        return self

    def __len__(self) -> int:
        return len(self.ops)


class KeyValueDB:
    """Interface contract; TinDB is the bundled implementation."""

    def get(self, prefix: str, key: bytes) -> bytes | None:
        raise NotImplementedError

    def transaction(self) -> KVTransaction:
        return KVTransaction()

    def submit_transaction(self, txn: KVTransaction) -> None:
        raise NotImplementedError

    def iterate(self, prefix: str, start: bytes | None = None,
                end: bytes | None = None) -> Iterator[tuple[bytes, bytes]]:
        """Yield (key, value) ascending, bounded to `prefix` and to
        [start, end) within it (None = unbounded on that side)."""
        raise NotImplementedError

    def snapshot(self):
        raise NotImplementedError
