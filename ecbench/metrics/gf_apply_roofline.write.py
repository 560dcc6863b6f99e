"""gf_apply_roofline.write, read in the write cells: what
`ecbench.readers.gf_apply_roofline` works out."""

from ecbench.readers import gf_apply_roofline as read  # noqa: F401
