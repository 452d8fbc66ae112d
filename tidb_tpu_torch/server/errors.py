"""MySQL error-code mapping for the wire protocol.

Counterpart of the reference's errno package (reference: errno/errcode.go
+ errname.go; terror infrastructure in util/dbterror). Clients branch on
these codes (duplicate-key retry loops look for 1062, ORMs probe 1146,
migration tools parse 1064), so the generic 1105 catch-all breaks them.

Engine errors are CodedError subclasses carrying (errno, sqlstate) FROM
THE RAISE SITE (`tidb_tpu_torch/errno.py`, the terror pattern of
util/dbterror/terror.go); the wire layer reads the attributes via
errno.error_of(). The regex classifier below remains ONLY as a net for
foreign exceptions (KeyError/ValueError from library code) and is no
longer the source of truth — rewording a message cannot change a code
anymore.
"""

from __future__ import annotations

import re

ER_DBACCESS_DENIED = 1044
ER_ACCESS_DENIED = 1045
ER_NO_DB = 1046
ER_BAD_DB = 1049
ER_TABLE_EXISTS = 1050
ER_BAD_TABLE = 1051
ER_BAD_FIELD = 1054
ER_DUP_FIELDNAME = 1060
ER_DUP_KEYNAME = 1061
ER_DUP_ENTRY = 1062
ER_PARSE_ERROR = 1064
ER_UNKNOWN_ERROR = 1105
ER_BAD_NULL = 1048
ER_DB_CREATE_EXISTS = 1007
ER_DB_DROP_EXISTS = 1008
ER_NO_SUCH_TABLE = 1146
ER_WRONG_VALUE_COUNT = 1136
ER_UNKNOWN_SYSTEM_VARIABLE = 1193
ER_VAR_READONLY = 1238
ER_LOCK_WAIT_TIMEOUT = 1205
ER_LOCK_DEADLOCK = 1213
ER_TABLEACCESS_DENIED = 1142
ER_SPECIFIC_ACCESS_DENIED = 1227
# TiDB-specific (reference: errno/errcode.go TiDB range)
ER_WRITE_CONFLICT = 9007
ER_SCHEMA_CHANGED = 8028
ER_QUERY_MEM_EXCEEDED = 8175
WARN_DATA_TRUNCATED = 1265
ER_INVALID_JSON_TEXT = 3140

_RULES: list[tuple[re.Pattern, int, str]] = [
    (re.compile(r"^Duplicate entry"), ER_DUP_ENTRY, "23000"),
    (re.compile(r"^Duplicate key name"), ER_DUP_KEYNAME, "42000"),
    (re.compile(r"^Duplicate column"), ER_DUP_FIELDNAME, "42S21"),
    (re.compile(r"^parse error"), ER_PARSE_ERROR, "42000"),
    (re.compile(r"unknown table"), ER_NO_SUCH_TABLE, "42S02"),
    (re.compile(r"^table exists"), ER_TABLE_EXISTS, "42S01"),
    (re.compile(r"unknown database"), ER_BAD_DB, "42000"),
    (re.compile(r"^database exists"), ER_DB_CREATE_EXISTS, "HY000"),
    (re.compile(r"unknown column"), ER_BAD_FIELD, "42S22"),
    (re.compile(r"cannot be null"), ER_BAD_NULL, "23000"),
    (re.compile(r"column count doesn't match"), ER_WRONG_VALUE_COUNT,
     "21S01"),
    (re.compile(r"^Unknown system variable"), ER_UNKNOWN_SYSTEM_VARIABLE,
     "HY000"),
    (re.compile(r"is a read only variable"), ER_VAR_READONLY, "HY000"),
    # privilege-escalation denials carry their own code; must match before
    # the generic login-failure rule (clients treat 1045 as bad creds)
    (re.compile(r"you need .* privilege"), ER_SPECIFIC_ACCESS_DENIED,
     "42000"),
    (re.compile(r"^Access denied"), ER_ACCESS_DENIED, "28000"),
    (re.compile(r"command denied"), ER_TABLEACCESS_DENIED, "42000"),
    (re.compile(r"^Information schema is changed"), ER_SCHEMA_CHANGED,
     "HY000"),
    (re.compile(r"write conflict"), ER_WRITE_CONFLICT, "HY000"),
    (re.compile(r"^Out Of Memory Quota"), ER_QUERY_MEM_EXCEEDED, "HY000"),
    (re.compile(r"^Data truncated"), WARN_DATA_TRUNCATED, "01000"),
    (re.compile(r"^Invalid JSON text"), ER_INVALID_JSON_TEXT, "22032"),
    (re.compile(r"[Dd]eadlock"), ER_LOCK_DEADLOCK, "40001"),
    (re.compile(r"[Ll]ock wait timeout"), ER_LOCK_WAIT_TIMEOUT, "HY000"),
]


def classify(message: str) -> tuple[int, str]:
    """(errno, sqlstate) for an engine error message."""
    for rx, code, state in _RULES:
        if rx.search(message):
            return code, state
    return ER_UNKNOWN_ERROR, "HY000"
