"""A Chunk: an ordered batch of equal-length Columns.

Counterpart of reference util/chunk/chunk.go:32. Operators stream chunks of
bounded row count (reference uses 1024; we default to a TPU-tile-friendly
size at the coprocessor layer — see copr) and results are rendered back to
host scalars only at the edge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Sequence

import numpy as np

from .column import Column


@dataclass
class Chunk:
    columns: list[Column]

    def __post_init__(self) -> None:
        if self.columns:
            n = len(self.columns[0])
            if not all(len(c) == n for c in self.columns):
                raise ValueError("ragged chunk: column lengths differ")

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def num_cols(self) -> int:
        return len(self.columns)

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns)

    def column(self, i: int) -> Column:
        return self.columns[i]

    def row(self, i: int) -> tuple[Any, ...]:
        return tuple(c.value_at(i) for c in self.columns)

    def iter_rows(self) -> Iterator[tuple[Any, ...]]:
        for i in range(self.num_rows):
            yield self.row(i)

    def to_pylist(self) -> list[tuple[Any, ...]]:
        return list(self.iter_rows())

    def take(self, indices: np.ndarray) -> "Chunk":
        return Chunk([c.take(indices) for c in self.columns])

    def slice(self, start: int, stop: int) -> "Chunk":
        idx = np.arange(start, stop)
        return self.take(idx)

    @staticmethod
    def concat(chunks: Sequence["Chunk"]) -> "Chunk":
        assert chunks
        if len(chunks) == 1:
            return chunks[0]
        ncols = chunks[0].num_cols
        if not all(ch.num_cols == ncols for ch in chunks):
            raise ValueError("Chunk.concat: column count mismatch")
        cols = []
        for ci in range(ncols):
            parts = [ch.columns[ci] for ch in chunks]
            first = parts[0]
            # single pass: remap foreign string dictionaries into the first
            # part's dictionary, then one concatenate over all parts
            datas = []
            for p in parts:
                if (
                    first.ftype.is_string
                    and first.dictionary is not None
                    and p.dictionary is not None
                    and p.dictionary is not first.dictionary
                ):
                    datas.append(first._remapped_data(p))
                else:
                    datas.append(p.data)
            data = np.concatenate(datas)
            if all(p.valid is None for p in parts):
                valid = None
            else:
                valid = np.concatenate([p.validity for p in parts])
            cols.append(Column(first.ftype, data, valid, first.dictionary))
        return Chunk(cols)
