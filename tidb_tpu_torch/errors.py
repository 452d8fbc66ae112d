"""Errors raised by the port where the reference would go on."""


class NotInSlice(Exception):
    """The statement or request needs a part of the reference that is not
    ported. `reason` names it: a statement kind the read-only Session does
    not run ("InsertStmt", "BeginStmt", ...), "writes", "registry builtin"
    (an `fx:` op: the reference's function registry), "partitioned table",
    "PARTITION BY", "EXPLAIN ANALYZE", "FOR UPDATE", "INTO OUTFILE",
    "session variables and functions"."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason
