"""Runtime analysis tooling: the lock/park sanitizer."""
