"""Errors raised by the port where the reference would go on."""


class NotInSlice(Exception):
    """The statement or request needs a part of the reference that is not
    ported. `reason` names it: a statement kind the Session does not run
    (its class name), a SHOW kind ("SHOW PROCESSLIST", ...), an
    information_schema table of an unported plane by its name
    ("tidb_top_sql", ...), "metrics_schema"."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason
