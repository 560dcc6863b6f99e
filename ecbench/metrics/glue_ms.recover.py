"""glue_ms.recover, read in the recover cells: what
`ecbench.readers.glue_ms` works out."""

from ecbench.readers import glue_ms as read  # noqa: F401
