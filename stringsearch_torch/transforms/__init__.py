"""Text transforms built on suffix arrays (BWT family)."""

from stringsearch_torch.transforms.bwt import bwt, bwt_from_sa, divbwt, unbwt

__all__ = ["bwt", "bwt_from_sa", "divbwt", "unbwt"]
