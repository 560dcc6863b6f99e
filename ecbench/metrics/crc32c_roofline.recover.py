"""crc32c_roofline.recover, read in the recover cells: what
`ecbench.readers.crc32c_roofline` works out."""

from ecbench.readers import crc32c_roofline as read  # noqa: F401
