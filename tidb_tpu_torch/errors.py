"""Errors raised by the port where the reference would go on."""


class NotInSlice(Exception):
    """The statement or request needs a part of the reference that is not
    ported. `reason` names it: a statement kind the Session does not run
    ("CreateIndexStmt", "AlterTableStmt", "LoadDataStmt", ...), a session
    function of an unported plane by its name ("NOW", "NEXTVAL",
    "GET_LOCK", ...), "registry builtin" (an `fx:` op: the reference's
    function registry), "partitioned table", "PARTITION BY",
    "EXPLAIN ANALYZE", "INTO OUTFILE"."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason
