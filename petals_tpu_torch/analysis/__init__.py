"""Runtime analysis: the lock-order and await-under-lock sanitizer."""
