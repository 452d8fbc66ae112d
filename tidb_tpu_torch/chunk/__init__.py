from .column import Column, Dictionary
from .chunk import Chunk

__all__ = ["Column", "Dictionary", "Chunk"]
