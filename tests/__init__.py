"""Test suite of the package (a regular package, so ``tests.conftest`` resolves
here even where another distribution installs a top-level ``tests``)."""
