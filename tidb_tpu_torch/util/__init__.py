"""Host-side utility belt (reference: util/ — memory quota, spill, tracing)."""
