from .pipeline import SyntheticLMDataset  # noqa: F401
