from . import potentials, profiling  # noqa: F401

__all__ = ["potentials", "profiling"]
