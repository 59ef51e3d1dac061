from . import potentials  # noqa: F401

__all__ = ["potentials"]
