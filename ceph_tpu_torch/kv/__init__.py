"""kv — the ordered-KV metadata plane (the RocksDB/BlueFS role).

`KeyValueDB` is the interface surface (ref: src/kv/KeyValueDB.h — the
abstraction BlueStore programs RocksDB through: prefixed key spaces,
atomic transaction batches, ordered prefix-bounded iterators,
snapshots). `TinDB` is the bundled LSM-lite implementation: in-memory
memtable over a crc32c-sealed WAL, sorted immutable segments with
index blocks, leveled compaction, and SIGKILL-real remount replay.
"""

from .interface import KeyValueDB, KVTransaction, combine_key, split_key  # noqa: F401
from .tindb import TinDB, TinDBCorruption, host_crc32c  # noqa: F401
