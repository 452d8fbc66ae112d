"""Errors raised by the port's coprocessor tier."""


class NotInSlice(Exception):
    """The request needs a path that is not ported yet.

    Raised where the reference leaves the device path for its host
    interpreter (`reason` is the reference's own gate reason, e.g.
    "group-overflow") and where the reference takes a device path the
    port does not have yet (joins, TopN, the sorted-run hc body)."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason
