"""idle_share.recover, read in the recover cells: what
`ecbench.readers.idle_share` works out."""

from ecbench.readers import idle_share as read  # noqa: F401
