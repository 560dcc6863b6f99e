"""gf_apply_roofline.recover, read in the recover cells: what
`ecbench.readers.gf_apply_roofline` works out."""

from ecbench.readers import gf_apply_roofline as read  # noqa: F401
