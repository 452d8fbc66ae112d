"""Catalog: schemas, tables, columns, indexes and id allocation."""
