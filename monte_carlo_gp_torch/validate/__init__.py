"""Validation against the native C++ reference-semantics oracle."""
