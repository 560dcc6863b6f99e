"""fold_roofline.recover, read in the recover cells: the fold's share of
its HBM roofline, %: the fold spans' `bytes_in` + `bytes_out` (B*H*rl
read, B*rl written) at 3.35 TB/s over the device time of the entries
launched inside them, from the port-span window (`ecbench.portspans`)."""

from ecbench.portspans import fold_roofline as read  # noqa: F401
