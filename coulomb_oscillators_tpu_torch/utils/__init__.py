"""Utilities: snapshot I/O, timing harness."""
