from .lexer import Lexer, Token, TokenKind, LexError
from .parser import Parser, ParseError, parse_sql

__all__ = [
    "Lexer",
    "Token",
    "TokenKind",
    "LexError",
    "Parser",
    "ParseError",
    "parse_sql",
]
