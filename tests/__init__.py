"""Test suite (a regular package, so ``tests.oracle`` cannot be shadowed by
another installed ``tests`` package)."""
