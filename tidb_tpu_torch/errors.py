"""Errors raised by the port's coprocessor tier."""


class NotInSlice(Exception):
    """The request needs a part of the reference that is not ported.

    Raised only for a registry builtin (`fx:` op) in an expression the
    host evaluates: the reference's registry belongs to its SQL tier, and
    pushdown never sends one to the coprocessor."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason
