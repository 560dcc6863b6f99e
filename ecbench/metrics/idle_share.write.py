"""idle_share.write, read in the write cells: what
`ecbench.readers.idle_share` works out."""

from ecbench.readers import idle_share as read  # noqa: F401
