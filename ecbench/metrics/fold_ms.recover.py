"""fold_ms.recover, read in the recover cells: device ms an op of the
entries launched inside the recovery program's fold span
(`ecbackend.recover_program.fold`), from the port-span window
(`ecbench.portspans`)."""

from ecbench.portspans import fold_ms as read  # noqa: F401
