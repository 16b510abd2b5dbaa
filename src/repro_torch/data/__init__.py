from .pipeline import DataState, SyntheticLMPipeline

__all__ = ["DataState", "SyntheticLMPipeline"]
