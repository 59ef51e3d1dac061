from . import potentials  # noqa: F401
