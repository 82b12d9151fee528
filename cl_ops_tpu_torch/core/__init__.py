"""Core: dtype registry, op registries, errors."""
