"""glue_ms.write, read in the write cells: what
`ecbench.readers.glue_ms` works out."""

from ecbench.readers import glue_ms as read  # noqa: F401
