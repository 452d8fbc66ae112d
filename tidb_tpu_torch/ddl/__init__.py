"""Online DDL: the job queue and its state machine (`ddl.py`)."""

from .ddl import DDL, DDLError, DDLJob  # noqa: F401
