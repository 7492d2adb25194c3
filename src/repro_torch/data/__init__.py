"""Token data sources and the fixed-length batcher (numpy only)."""
from repro_torch.data.pipeline import Batcher, BinTokenSource, SyntheticSource

__all__ = ["Batcher", "BinTokenSource", "SyntheticSource"]
