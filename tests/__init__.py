"""The receiver's test suite (a package, so that `tests.scenario` resolves
to this directory ahead of any other `tests` on the path)."""
