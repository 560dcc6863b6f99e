"""crc32c_roofline.write, read in the write cells: what
`ecbench.readers.crc32c_roofline` works out."""

from ecbench.readers import crc32c_roofline as read  # noqa: F401
