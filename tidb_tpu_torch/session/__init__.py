from .session import Session, ResultSet, SQLError

__all__ = ["Session", "ResultSet", "SQLError"]
