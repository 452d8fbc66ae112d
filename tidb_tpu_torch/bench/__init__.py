"""TPC-H data generation and hand-built coprocessor requests."""
