"""Chaos engineering for the wire tier: the seeded Thrasher (the
teuthology OSDThrasher role) and its invariant checkers."""

from .thrasher import (KNOBS, InvariantViolation, Thrasher,  # noqa: F401
                       load_factor, repro_command)
