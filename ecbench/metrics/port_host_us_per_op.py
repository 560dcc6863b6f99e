"""port_host_us_per_op: host microseconds an op inside the port's
outermost spans (the program or coder entry, and for Clay writes the
CRC launch beside it), with the span capture on, from the port-span
window (`ecbench.portspans`)."""

from ecbench.portspans import port_host_us_per_op as read  # noqa: F401
