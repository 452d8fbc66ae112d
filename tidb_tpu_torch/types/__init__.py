from .field_type import (
    TypeKind,
    FieldType,
    bigint_type,
    double_type,
    decimal_type,
    date_type,
    datetime_type,
    varchar_type,
    boolean_type,
)
from .value import (
    Decimal,
    Date,
    DateTime,
    encode_date,
    decode_date,
    encode_datetime,
    decode_datetime,
)

__all__ = [
    "TypeKind",
    "FieldType",
    "bigint_type",
    "double_type",
    "decimal_type",
    "date_type",
    "datetime_type",
    "varchar_type",
    "boolean_type",
    "Decimal",
    "Date",
    "DateTime",
    "encode_date",
    "decode_date",
    "encode_datetime",
    "decode_datetime",
]
