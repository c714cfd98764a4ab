"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain versions."""

import threading

_launches_lock = threading.Lock()


def count_launch(fn) -> None:
    """Add one to the kernel wrapper ``fn``'s ``launches`` counter. Thread-ranks
    and the serving loops' worker threads launch concurrently, and ``+=``
    alone can lose a count."""
    with _launches_lock:
        fn.launches += 1
