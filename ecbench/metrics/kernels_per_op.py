"""kernels_per_op: device entries an op (kernels, sets, copies)
launched inside one of the port's spans, from the port-span window
(`ecbench.portspans`)."""

from ecbench.portspans import kernels_per_op as read  # noqa: F401
