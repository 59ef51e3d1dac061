from .sharded import pooled_moments, sample_from_skeleton_batch  # noqa: F401
