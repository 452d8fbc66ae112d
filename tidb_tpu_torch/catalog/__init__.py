"""Table and column metadata (the subset the coprocessor reads)."""
